"""Remote-model inference client: server-side embedding of Document /
Image / InferenceObject inputs via an HTTP inference service.

Reference: src/common/inference/service.rs (InferenceRequest{inputs,
inference, token} → InferenceResponse{embeddings}), inference_input.rs
(InferenceInput{data, data_type: text|image|object, model, options}),
config.rs (InferenceConfig{address, timeout, token}). BM25 documents embed
locally (utils/bm25.py) and never reach the remote service, matching
bm25_inference.rs.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from typing import Any, Dict, List, Optional


class InferenceError(Exception):
    status_code = 400


class InferenceService:
    """Client for the remote embedding service. `infer` sends a batch of
    inputs and returns one vector per input, preserving order."""

    def __init__(
        self,
        address: Optional[str] = None,
        token: Optional[str] = None,
        timeout: float = 10.0,
    ):
        self.address = address.rstrip("/") if address else None
        self.token = token
        self.timeout = timeout

    @property
    def enabled(self) -> bool:
        return bool(self.address)

    def infer(
        self, inputs: List[Dict[str, Any]], inference: str = "update"
    ) -> List[Any]:
        """inputs: [{"data", "data_type", "model", "options"}];
        inference: "update" (ingest) or "search" (query)."""
        if not self.enabled:
            raise InferenceError(
                "inference service is not configured — set service.inference.address "
                "to embed Document/Image/InferenceObject inputs with a remote model"
            )
        body = {"inputs": inputs, "inference": inference}
        if self.token:
            body["token"] = self.token
        req = urllib.request.Request(
            self.address,
            method="POST",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                out = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:200]
            raise InferenceError(
                f"inference service returned {e.code}: {detail}"
            ) from e
        except OSError as e:
            raise InferenceError(f"inference service unreachable: {e}") from e
        embeddings = out.get("embeddings")
        if not isinstance(embeddings, list) or len(embeddings) != len(inputs):
            raise InferenceError(
                "inference service returned a malformed response "
                f"({len(embeddings) if isinstance(embeddings, list) else 'no'} "
                f"embeddings for {len(inputs)} inputs)"
            )
        return embeddings


_GLOBAL = InferenceService()
_LOCK = threading.Lock()


def configure(address: Optional[str], token: Optional[str] = None, timeout: float = 10.0) -> None:
    global _GLOBAL
    with _LOCK:
        _GLOBAL = InferenceService(address, token, timeout)


def get() -> InferenceService:
    return _GLOBAL


def embed_value(v: Dict[str, Any], inference: str = "update") -> Any:
    """Embed a single Document/Image/InferenceObject dict → vector.
    BM25-model documents embed locally; everything else goes remote."""
    if "text" in v:
        model = (v.get("model") or "").lower()
        if model in ("", "bm25", "qdrant/bm25"):
            from .bm25 import Bm25

            bm = Bm25(**(v.get("options") or {}))
            return (
                bm.embed_query(v["text"])
                if inference == "search"
                else bm.embed_document(v["text"])
            )
        data, data_type = v["text"], "text"
    elif "image" in v:
        data, data_type = v["image"], "image"
    elif "object" in v:
        data, data_type = v["object"], "object"
    else:
        raise InferenceError(f"not an inference input: {sorted(v)}")
    return get().infer(
        [
            {
                "data": data,
                "data_type": data_type,
                "model": v.get("model") or "",
                "options": v.get("options"),
            }
        ],
        inference,
    )[0]
