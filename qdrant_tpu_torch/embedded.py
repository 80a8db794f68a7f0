"""Embedded (in-process) engine API — the `lib/edge` analogue.

Reference: lib/edge/ (qdrant-edge: an embedded single-node engine reusing
the segment/shard layers without the server stack, exposed to Python via
PyO3). Here the same layers ARE Python, so the embedded product is a thin
façade over TableOfContent + QueryExecutor, mirroring qdrant-client's
local mode interface.

    from qdrant_tpu_torch.embedded import QdrantTpu
    db = QdrantTpu("./storage")          # or QdrantTpu() for in-memory tmp
    db.create_collection("docs", vectors={"size": 128, "distance": "Cosine"})
    db.upsert("docs", points=[{"id": 1, "vector": [...], "payload": {...}}])
    hits = db.query("docs", query=[...], limit=5, with_payload=True)
"""

from __future__ import annotations

import tempfile
from typing import Any, Dict, List, Optional

from .api.toc import TableOfContent
from .collection.query import QueryExecutor, QueryRequest
from .types import PayloadIndexParams, normalize_point_id, parse_filter


class QdrantTpu:
    def __init__(self, path: Optional[str] = None):
        self._tmp = None
        if path is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="qdrant_tpu_")
            path = self._tmp.name
        self.toc = TableOfContent(path)

    # -- collections -----------------------------------------------------

    def create_collection(self, name: str, **spec) -> bool:
        return self.toc.create_collection(name, spec)

    def delete_collection(self, name: str) -> bool:
        return self.toc.delete_collection(name)

    def list_collections(self) -> List[str]:
        return self.toc.list_collections()

    def collection_info(self, name: str) -> Dict[str, Any]:
        return self.toc.get_collection(name).info()

    # -- points ----------------------------------------------------------

    def upsert(self, collection: str, points: List[Dict[str, Any]], wait: bool = True):
        coll = self.toc.get_collection(collection)
        norm = []
        for p in points:
            vec = p.get("vector", p.get("vectors"))
            if isinstance(vec, dict) and "indices" not in vec and not isinstance(vec.get("text"), str):
                vectors = vec
            else:
                vectors = {"": vec}
            norm.append(
                {"id": p["id"], "vectors": vectors, "payload": p.get("payload")}
            )
        return coll.upsert(norm, wait=wait)

    def delete(self, collection: str, ids: Optional[List] = None, filter: Optional[dict] = None):
        coll = self.toc.get_collection(collection)
        op: Dict[str, Any] = {"type": "delete"}
        if ids is not None:
            op["ids"] = ids
        else:
            op["filter"] = filter
        return coll.update_op(op)

    def set_payload(self, collection: str, payload: dict, ids: Optional[List] = None, filter: Optional[dict] = None):
        coll = self.toc.get_collection(collection)
        op: Dict[str, Any] = {"type": "set_payload", "payload": payload, "key": None}
        if ids is not None:
            op["ids"] = ids
        else:
            op["filter"] = filter
        return coll.update_op(op)

    def retrieve(self, collection: str, ids: List, with_payload=True, with_vectors=False):
        coll = self.toc.get_collection(collection)
        from .collection.query import _select_payload, _select_vectors

        out = []
        for pid in ids:
            pid = normalize_point_id(pid)
            payload, vectors = coll.get_payload_and_vectors(pid)
            if payload is None and vectors is None:
                continue
            rec: Dict[str, Any] = {"id": pid}
            p = _select_payload(payload, with_payload)
            if p is not None:
                rec["payload"] = p
            v = _select_vectors(vectors, with_vectors)
            if v is not None:
                rec["vector"] = v
            out.append(rec)
        return out

    def count(self, collection: str, filter: Optional[dict] = None) -> int:
        return self.toc.get_collection(collection).count(parse_filter(filter))

    def scroll(self, collection: str, limit: int = 10, offset=None, filter=None):
        coll = self.toc.get_collection(collection)
        ids = coll.scroll_ids(limit, offset, parse_filter(filter))
        return self.retrieve(collection, ids)

    # -- search ----------------------------------------------------------

    def query(self, collection: str, **request) -> List[Dict[str, Any]]:
        """Universal query (same dict schema as POST /points/query)."""
        coll = self.toc.get_collection(collection)
        return QueryExecutor(coll, self.toc).query(QueryRequest(request))

    def search(self, collection: str, vector, limit: int = 10, **kw):
        return self.query(collection, query=vector, limit=limit, **kw)

    def create_payload_index(self, collection: str, field: str, schema="keyword"):
        coll = self.toc.get_collection(collection)
        return coll.create_payload_index(field, PayloadIndexParams.from_dict(schema))

    # -- lifecycle -------------------------------------------------------

    def snapshot(self, collection: str, directory: str) -> str:
        return self.toc.get_collection(collection).create_snapshot(directory)

    def close(self) -> None:
        self.toc.close()
        if self._tmp is not None:
            self._tmp.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
