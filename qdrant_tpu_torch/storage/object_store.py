"""S3-compatible object store client + snapshot storage backends.

Reference: lib/collection/src/common/snapshots_manager.rs
(SnapshotStorage{LocalFileSystemConfig,S3Config} → SnapshotStorageLocalFS /
SnapshotStorageCloud over object_store) and the io_bridge_object_store
backends. Stdlib-only: AWS Signature V4 over urllib (no boto3 in-image);
works against S3-compatible endpoints (AWS, MinIO, GCS interop).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import Any, Dict, List, Optional


class ObjectStoreError(Exception):
    status_code = 500


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


class S3Client:
    """Minimal SigV4 S3 client: put/get/delete/list."""

    def __init__(
        self,
        bucket: str,
        region: Optional[str] = None,
        access_key: Optional[str] = None,
        secret_key: Optional[str] = None,
        endpoint_url: Optional[str] = None,
        timeout: float = 60.0,
    ):
        self.bucket = bucket
        self.region = region or "us-east-1"
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        self.secret_key = secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        self.endpoint = (
            endpoint_url.rstrip("/")
            if endpoint_url
            else f"https://s3.{self.region}.amazonaws.com"
        )
        self.timeout = timeout
        parsed = urllib.parse.urlparse(self.endpoint)
        self.host = parsed.netloc

    # -- SigV4 (AWS Signature Version 4, service "s3") --------------------

    def _sign(
        self, method: str, path: str, query: Dict[str, str], payload_hash: str
    ) -> Dict[str, str]:
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        canonical_query = "&".join(
            f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(v, safe='')}"
            for k, v in sorted(query.items())
        )
        headers = {
            "host": self.host,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amz_date,
        }
        signed_headers = ";".join(sorted(headers))
        canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
        canonical_request = "\n".join(
            [
                method,
                urllib.parse.quote(path),
                canonical_query,
                canonical_headers,
                signed_headers,
                payload_hash,
            ]
        )
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        string_to_sign = "\n".join(
            [
                "AWS4-HMAC-SHA256",
                amz_date,
                scope,
                _sha256(canonical_request.encode()),
            ]
        )
        k = _hmac(("AWS4" + self.secret_key).encode(), datestamp)
        k = _hmac(k, self.region)
        k = _hmac(k, "s3")
        k = _hmac(k, "aws4_request")
        signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
        return {
            "x-amz-date": amz_date,
            "x-amz-content-sha256": payload_hash,
            "Authorization": (
                f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
                f"SignedHeaders={signed_headers}, Signature={signature}"
            ),
        }

    def _request(
        self,
        method: str,
        key: str = "",
        query: Optional[Dict[str, str]] = None,
        body: bytes = b"",
        extra_headers: Optional[Dict[str, str]] = None,
    ) -> bytes:
        query = query or {}
        path = f"/{self.bucket}" + (f"/{key}" if key else "")
        payload_hash = _sha256(body)
        headers = self._sign(method, path, query, payload_hash)
        if extra_headers:
            headers = {**headers, **extra_headers}
        # must match the canonical-request encoding (quote, not quote_plus):
        # keys/prefixes with spaces or '+' otherwise break the signature
        qs = "&".join(
            f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(v, safe='')}"
            for k, v in sorted(query.items())
        )
        url = f"{self.endpoint}{urllib.parse.quote(path)}" + (f"?{qs}" if qs else "")
        req = urllib.request.Request(
            url, method=method, data=body if body else None, headers=headers
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:300]
            raise ObjectStoreError(f"S3 {method} {key!r} failed: {e.code} {detail}")
        except OSError as e:
            raise ObjectStoreError(f"S3 endpoint unreachable: {e}")

    # -- object operations --------------------------------------------------

    def put_object(self, key: str, data: bytes) -> None:
        self._request("PUT", key, body=data)

    def get_object(self, key: str) -> bytes:
        return self._request("GET", key)

    def get_object_range(self, key: str, offset: int = 0, length: int = -1) -> bytes:
        """Ranged GET (Range is not part of the SigV4 signed headers, so it
        rides on top of the normal signature)."""
        if offset == 0 and length < 0:
            return self.get_object(key)
        end = "" if length < 0 else str(offset + length - 1)
        return self._request(
            "GET", key, extra_headers={"Range": f"bytes={offset}-{end}"}
        )

    def delete_object(self, key: str) -> None:
        self._request("DELETE", key)

    def list_objects(self, prefix: str = "") -> List[Dict[str, Any]]:
        data = self._request("GET", "", {"list-type": "2", "prefix": prefix})
        root = ET.fromstring(data)
        ns = ""
        if root.tag.startswith("{"):
            ns = root.tag[: root.tag.index("}") + 1]
        out = []
        for item in root.iter(f"{ns}Contents"):
            out.append(
                {
                    "key": item.findtext(f"{ns}Key"),
                    "size": int(item.findtext(f"{ns}Size") or 0),
                    "last_modified": item.findtext(f"{ns}LastModified"),
                }
            )
        return out


class S3SnapshotStorage:
    """Snapshot backend mirroring local snapshot files into a bucket
    (reference: SnapshotStorageCloud). Keys are `<scope>/<filename>`."""

    def __init__(self, config: Dict[str, Any]):
        self.client = S3Client(
            bucket=config["bucket"],
            region=config.get("region"),
            access_key=config.get("access_key"),
            secret_key=config.get("secret_key"),
            endpoint_url=config.get("endpoint_url"),
        )

    def store(self, scope: str, filename: str, local_path: str) -> None:
        with open(local_path, "rb") as f:
            self.client.put_object(f"{scope}/{filename}", f.read())

    def retrieve(self, scope: str, filename: str) -> bytes:
        return self.client.get_object(f"{scope}/{filename}")

    def delete(self, scope: str, filename: str) -> None:
        self.client.delete_object(f"{scope}/{filename}")

    def list(self, scope: str) -> List[Dict[str, Any]]:
        out = []
        for obj in self.client.list_objects(prefix=f"{scope}/"):
            out.append(
                {
                    "name": obj["key"].split("/", 1)[1],
                    "size": obj["size"],
                    "creation_time": obj["last_modified"],
                }
            )
        return out
