"""RemoteReplica: shard operations against another peer over HTTP.

Reference: lib/collection/src/shards/remote_shard.rs (RemoteShard implements
the same ShardOperation trait as LocalShard — location transparency) and the
PointsInternal gRPC service. Here the internal plane rides the REST server's
/internal/... routes (see api/rest.py); the wire payloads are the engine's
op dicts + JSON filters, so any peer can replicate any other.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Any, Dict, Optional

import numpy as np

from ..types import SparseVector
from .replica_set import ShardOperations


class RemoteError(ConnectionError):
    pass


class RemoteReplica(ShardOperations):
    def __init__(
        self,
        base_url: str,
        collection: str,
        shard_id: int,
        timeout: float = 30.0,
        api_key: Optional[str] = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.collection = collection
        self.shard_id = shard_id
        self.timeout = timeout
        self.api_key = api_key

    def _call(self, path: str, body: dict, timeout: Optional[float] = None) -> Any:
        url = (
            f"{self.base_url}/internal/collections/{self.collection}"
            f"/shards/{self.shard_id}/{path}"
        )
        req = urllib.request.Request(
            url, data=json.dumps(body).encode(), method="POST"
        )
        req.add_header("Content-Type", "application/json")
        if self.api_key:
            req.add_header("api-key", self.api_key)
        try:
            with urllib.request.urlopen(
                req, timeout=timeout or self.timeout
            ) as resp:
                out = json.loads(resp.read())
        except (urllib.error.URLError, OSError) as e:
            raise RemoteError(f"peer {self.base_url} unreachable: {e}") from e
        if out.get("status") != "ok":
            raise RemoteError(f"peer error: {out.get('status')}")
        return out.get("result")

    # -- ShardOperations ------------------------------------------------

    def forward_update(self, op: dict) -> dict:
        """Hand the whole write to this peer: it leases its own clock and
        fans out from there (leader execution for medium/strong ordering,
        reference: update.rs forward_update)."""
        return self._call("update_forward", {"op": op})

    def update_with_clock(self, op: dict, clock_tag: Optional[dict]) -> dict:
        # short timeout: a dead replica must fail fast so the fan-out can
        # mark it disabled instead of stalling the write (reference keeps
        # per-update deadlines well under the transfer/read timeouts)
        return self._call(
            "update",
            {"operation": op, "clock_tag": clock_tag},
            timeout=min(self.timeout, 5.0),
        )

    def search_dense(self, name, queries, k, flt=None, params=None):
        from ..collection.query import QueryRequest  # for params dict shape

        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        body = {
            "using": name,
            "queries": q.tolist(),
            "k": k,
            "filter": _filter_to_dict(flt),
        }
        result = self._call("search", body)
        return [
            [(s, _decode_id(pid), v) for s, pid, v in per_query]
            for per_query in result
        ]

    def search_sparse(self, name, queries, k, flt=None):
        body = {
            "using": name,
            "sparse_queries": [q.to_dict() for q in queries],
            "k": k,
            "filter": _filter_to_dict(flt),
        }
        result = self._call("search", body)
        return [
            [(s, _decode_id(pid), v) for s, pid, v in per_query]
            for per_query in result
        ]

    def search_multi(self, name, query, k, flt=None):
        body = {
            "using": name,
            "multi_query": np.asarray(query, dtype=np.float32).tolist(),
            "k": k,
            "filter": _filter_to_dict(flt),
        }
        result = self._call("search", body)
        return [(s, _decode_id(pid), v) for s, pid, v in result]

    def get_records(self, ids):
        """Materialized point records (payload + vectors + version) for the
        remote-read path — the internal analogue of PointsInternal/Get."""
        result = self._call(
            "records",
            {"ids": [p if isinstance(p, int) else str(p) for p in ids]},
        )
        return [
            {
                "id": _decode_id(r["id"]),
                "payload": r.get("payload"),
                "vectors": r.get("vectors") or {},
                "version": int(r.get("version", 0)),
            }
            for r in result["records"]
        ]

    def count(self, flt):
        return self._call("count", {"filter": _filter_to_dict(flt)})["count"]

    def scroll_ids(self, limit, offset_id=None, flt=None):
        result = self._call(
            "scroll",
            {"limit": limit, "offset": offset_id, "filter": _filter_to_dict(flt)},
        )
        return [_decode_id(p) for p in result["ids"]]

    def recover_from_snapshot(self, data: bytes) -> None:
        url = (
            f"{self.base_url}/internal/collections/{self.collection}"
            f"/shards/{self.shard_id}/snapshot/recover"
        )
        req = urllib.request.Request(url, data=data, method="POST")
        req.add_header("Content-Type", "application/octet-stream")
        if self.api_key:
            req.add_header("api-key", self.api_key)
        try:
            with urllib.request.urlopen(req, timeout=max(self.timeout, 120)) as resp:
                out = json.loads(resp.read())
        except (urllib.error.URLError, OSError) as e:
            raise RemoteError(f"peer {self.base_url} unreachable: {e}") from e
        if out.get("status") != "ok":
            raise RemoteError(f"peer error: {out.get('status')}")


class RemoteShardHandle:
    """Read/write routing for a shard this peer does NOT hold: an ordered
    list of (peer_id, RemoteReplica) over the peers that do, with failover
    (reference: collection reads through RemoteShard with replica fallback,
    execute_read_operation.rs)."""

    def __init__(self, replicas):
        self.replicas = list(replicas)  # [(peer_id, RemoteReplica)]

    def _try(self, op, *args, **kwargs):
        last: Optional[Exception] = None
        for _pid, replica in self.replicas:
            try:
                return getattr(replica, op)(*args, **kwargs)
            except RemoteError as e:
                last = e
        raise last or RemoteError("shard has no remote replicas")

    def forward_update(self, op: dict) -> dict:
        return self._try("forward_update", op)

    def search_dense(self, name, queries, k, flt=None, params=None):
        return self._try("search_dense", name, queries, k, flt, params)

    def search_sparse(self, name, queries, k, flt=None):
        return self._try("search_sparse", name, queries, k, flt)

    def search_multi(self, name, query, k, flt=None):
        return self._try("search_multi", name, query, k, flt)

    def get_records(self, ids):
        return self._try("get_records", ids)

    def count(self, flt):
        return self._try("count", flt)

    def scroll_ids(self, limit, offset_id=None, flt=None):
        return self._try("scroll_ids", limit, offset_id, flt)


def _decode_id(pid):
    return pid if isinstance(pid, int) else str(pid)


def _filter_to_dict(flt) -> Optional[dict]:
    """Serialize a Filter tree back to the REST dict form for the wire."""
    if flt is None:
        return None
    from ..types import (
        FieldCondition,
        Filter,
        HasIdCondition,
        HasVectorCondition,
        IsEmptyCondition,
        IsNullCondition,
        MatchAny,
        MatchExcept,
        MatchPhrase,
        MatchText,
        MatchValue,
        NestedCondition,
    )
    import dataclasses

    def cond(c):
        if isinstance(c, Filter):
            return flt_dict(c)
        if isinstance(c, HasIdCondition):
            return {"has_id": list(c.has_id)}
        if isinstance(c, HasVectorCondition):
            return {"has_vector": c.has_vector}
        if isinstance(c, IsEmptyCondition):
            return {"is_empty": {"key": c.is_empty_key}}
        if isinstance(c, IsNullCondition):
            return {"is_null": {"key": c.is_null_key}}
        if isinstance(c, NestedCondition):
            return {"nested": {"key": c.key, "filter": flt_dict(c.filter)}}
        if isinstance(c, FieldCondition):
            out: Dict[str, Any] = {"key": c.key}
            m = c.match
            if isinstance(m, MatchValue):
                out["match"] = {"value": m.value}
            elif isinstance(m, MatchAny):
                out["match"] = {"any": m.any}
            elif isinstance(m, MatchExcept):
                out["match"] = {"except": m.except_}
            elif isinstance(m, MatchText):
                out["match"] = {"text": m.text}
            elif isinstance(m, MatchPhrase):
                out["match"] = {"phrase": m.phrase}
            for attr in ("range", "values_count"):
                v = getattr(c, attr)
                if v is not None:
                    out[attr] = {
                        k: x for k, x in dataclasses.asdict(v).items() if x is not None
                    }
            if c.datetime_range is not None:
                out["datetime_range"] = {
                    k: x
                    for k, x in dataclasses.asdict(c.datetime_range).items()
                    if x is not None
                }
            if c.geo_bounding_box is not None:
                bb = c.geo_bounding_box
                out["geo_bounding_box"] = {
                    "top_left": {"lon": bb.top_left[0], "lat": bb.top_left[1]},
                    "bottom_right": {
                        "lon": bb.bottom_right[0],
                        "lat": bb.bottom_right[1],
                    },
                }
            if c.geo_radius is not None:
                gr = c.geo_radius
                out["geo_radius"] = {
                    "center": {"lon": gr.center[0], "lat": gr.center[1]},
                    "radius": gr.radius,
                }
            if c.is_empty is not None:
                out["is_empty"] = c.is_empty
            if c.is_null is not None:
                out["is_null"] = c.is_null
            return out
        raise ValueError(f"cannot serialize condition {c!r}")

    def flt_dict(f: Filter) -> dict:
        out: Dict[str, Any] = {}
        if f.must:
            out["must"] = [cond(c) for c in f.must]
        if f.should:
            out["should"] = [cond(c) for c in f.should]
        if f.must_not:
            out["must_not"] = [cond(c) for c in f.must_not]
        if f.min_should:
            out["min_should"] = {
                "conditions": [cond(c) for c in f.min_should[0]],
                "min_count": f.min_should[1],
            }
        return out

    return flt_dict(flt)
