"""REST API server (qdrant-compatible surface).

Reference: src/actix/ (route table src/actix/mod.rs:100-175 and the 22
handler modules under src/actix/api/). Implemented on the stdlib threading
HTTP server — the host shell is IO-light; all heavy work happens in the
device kernels behind the collection layer.

Response envelope matches the reference: {"result": ..., "status": "ok",
"time": seconds} / {"status": {"error": msg}, "time": seconds}.
"""

from __future__ import annotations

import json
import re
import threading
import time
import traceback
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..collection.collection import CollectionError, NotFoundError
from ..api.auth import AuthError, Authenticator
from ..collection.query import QueryError, QueryExecutor, QueryRequest
from ..storage.segment import SearchParams
from ..types import PayloadIndexParams, StrictModeError, normalize_point_id, parse_filter
from ..utils.quota import QuotaExceededError
from ..api.issues import ISSUES
from ..api.metrics import METRICS
from .toc import TableOfContent
from ..utils.hw_counter import measure
from ..utils.inference import InferenceError

VERSION = "1.19.0-tpu"


class ApiError(Exception):
    def __init__(self, message: str, status_code: int = 400):
        super().__init__(message)
        self.status_code = status_code


# ---------------------------------------------------------------------------
# handlers (each: (toc, match, body, query_params) → result)
# ---------------------------------------------------------------------------


def _is_inference_input(vec: dict) -> bool:
    """Document/Image/InferenceObject vs a named-vector map (reference:
    VectorStruct untagged variants — a string `text`/`image` field or an
    `object` field marks an inference input, api/src/rest/schema.rs)."""
    return (
        isinstance(vec.get("text"), str)
        or isinstance(vec.get("image"), str)
        or ("object" in vec and not isinstance(vec.get("object"), (list, tuple)))
    )


def _points_from_upsert(body: dict) -> List[dict]:
    if "points" in body and body["points"] is not None:
        out = []
        for p in body["points"]:
            vec = p.get("vector")
            vectors = p.get("vectors")
            if vectors is None:
                if (
                    isinstance(vec, dict)
                    and "indices" not in vec
                    and not _is_inference_input(vec)
                ):
                    vectors = vec  # named map
                elif vec is None:
                    vectors = {}
                else:
                    vectors = {"": vec}
            out.append(
                {
                    "id": p["id"],
                    "vectors": vectors,
                    "payload": p.get("payload"),
                    "shard_key": p.get("shard_key"),
                }
            )
        return out
    if "batch" in body and body["batch"] is not None:
        batch = body["batch"]
        ids = batch["ids"]
        vecs = batch.get("vectors")
        payloads = batch.get("payloads") or [None] * len(ids)
        out = []
        for i, pid in enumerate(ids):
            if isinstance(vecs, dict):
                vectors = {k: v[i] for k, v in vecs.items()}
            else:
                vectors = {"": vecs[i]}
            out.append({"id": pid, "vectors": vectors, "payload": payloads[i]})
        return out
    raise ApiError("expected `points` or `batch`")


def _selector(body: dict) -> dict:
    """points/filter selector shared by payload & delete ops."""
    out: Dict[str, Any] = {}
    if body.get("points") is not None:
        out["ids"] = body["points"]
    elif body.get("filter") is not None:
        out["filter"] = body["filter"]
    else:
        raise ApiError("expected `points` or `filter` selector")
    return out


def h_root(toc, m, body, q):
    return {"title": "qdrant - vector search engine (TPU-native)", "version": VERSION}


def h_list_collections(toc, m, body, q):
    return {"collections": [{"name": n} for n in toc.list_collections()]}


def h_get_collection(toc, m, body, q):
    return toc.get_collection(m["name"]).info()


def h_collection_exists(toc, m, body, q):
    return {"exists": toc.has_collection(m["name"])}


def _meta_submit(toc, op):
    """Route a metadata op through consensus when clustered (reference:
    Dispatcher.with_consensus), direct otherwise."""
    node = getattr(toc, "cluster_node", None)
    if node is None:
        return None
    from ..cluster.raft import NotLeader

    try:
        node.dispatcher.submit(op)
        return True
    except NotLeader as e:
        raise ApiError(f"not the consensus leader; leader is peer {e.leader_id}", 503)


def h_create_collection(toc, m, body, q):
    body = body or {}
    op = {"type": "create_collection", "name": m["name"], "spec": body}
    node = getattr(toc, "cluster_node", None)
    shard_number = int(body.get("shard_number", 1))
    replication = int(body.get("replication_factor", 1))
    if (
        node is not None
        and body.get("sharding_method") != "custom"
        and (shard_number > 1 or replication > 1)
    ):
        # consensus-driven shard placement: the proposer pins each shard to
        # specific peers and the committed op carries the proposal
        # (reference: collection_meta_ops.rs:488-511). Single-shard rf=1
        # collections keep the legacy everywhere-local layout (and remain
        # reshardable — placement+resharding integration is pending).
        op["placement"] = node.propose_placement(shard_number, replication)
    if _meta_submit(toc, op):
        return True
    return toc.create_collection(m["name"], body)


def h_update_collection(toc, m, body, q):
    return toc.update_collection(m["name"], body or {})


def h_delete_collection(toc, m, body, q):
    if _meta_submit(toc, {"type": "delete_collection", "name": m["name"]}):
        return True
    return toc.delete_collection(m["name"])


def h_update_aliases(toc, m, body, q):
    actions = (body or {}).get("actions", [])
    # validate BEFORE consensus submission: apply-time failures inside the
    # state machine are logged, not surfaced to this client
    for action in actions:
        if "create_alias" in action:
            cname = action["create_alias"].get("collection_name")
            if not toc.has_collection(cname or ""):
                raise NotFoundError(f"Collection `{cname}` doesn't exist!")
        elif "rename_alias" in action:
            old = action["rename_alias"].get("old_alias_name")
            if old not in toc.aliases:
                raise NotFoundError(f"Alias `{old}` doesn't exist!")
        elif "delete_alias" not in action:
            raise ApiError(f"unknown alias action: {action}")
    # aliases are cluster metadata: committed through consensus so every
    # peer resolves them identically (reference: CollectionMetaOperations::
    # ChangeAliases, collection_meta_ops.rs:488-511)
    if _meta_submit(toc, {"type": "update_aliases", "actions": actions}):
        return True
    return toc.update_aliases(actions)


def h_collection_aliases(toc, m, body, q):
    return {"aliases": toc.collection_aliases(m["name"])}


def h_all_aliases(toc, m, body, q):
    return {"aliases": toc.all_aliases()}


def h_create_vector_name(toc, m, body, q):
    """PUT /collections/{name}/vectors/{vname} — add a named vector to a
    live collection (reference: vector_name_api.rs)."""
    from ..types import VectorParams

    vp = VectorParams.from_dict(body or {})
    return toc.get_collection(m["name"]).create_vector_name(m["vname"], vp)


def h_delete_vector_name(toc, m, body, q):
    return toc.get_collection(m["name"]).delete_vector_name(m["vname"])


def h_create_index(toc, m, body, q):
    body = body or {}
    field = body.get("field_name")
    if not field:
        raise ApiError("field_name required")
    schema = body.get("field_schema", "keyword")
    coll = toc.get_collection(m["name"])
    coll.create_payload_index(field, PayloadIndexParams.from_dict(schema))
    return {"status": "acknowledged"}


def h_delete_index(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    coll.delete_payload_index(m["field"])
    return {"status": "acknowledged"}


def h_upsert_points(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    points = _points_from_upsert(body or {})
    res = coll.upsert(
        points,
        shard_key=(body or {}).get("shard_key"),
        ordering=(q.get("ordering") or "weak"),
    )
    return res


def h_delete_points(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    op = {"type": "delete", **_selector(body or {})}
    return coll.update_op(
        op,
        shard_key=(body or {}).get("shard_key"),
        ordering=(q.get("ordering") or "weak"),
    )


def h_update_vectors(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    pts = []
    for p in (body or {}).get("points", []):
        vec = p.get("vector")
        vectors = (
            vec
            if isinstance(vec, dict)
            and "indices" not in vec
            and not _is_inference_input(vec)
            else {"": vec}
        )
        pts.append({"id": p["id"], "vectors": vectors})
    return coll.update_op({"type": "update_vectors", "points": pts})


def h_delete_vectors(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    names = (body or {}).get("vector") or []
    op = {"type": "delete_vectors", "names": names, **_selector(body or {})}
    return coll.update_op(op)


def h_set_payload(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    op = {
        "type": "set_payload",
        "payload": (body or {}).get("payload") or {},
        "key": (body or {}).get("key"),
        **_selector(body or {}),
    }
    return coll.update_op(op)


def h_overwrite_payload(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    op = {
        "type": "overwrite_payload",
        "payload": (body or {}).get("payload") or {},
        **_selector(body or {}),
    }
    return coll.update_op(op)


def h_delete_payload(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    op = {
        "type": "delete_payload",
        "keys": (body or {}).get("keys") or [],
        **_selector(body or {}),
    }
    return coll.update_op(op)


def h_clear_payload(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    op = {"type": "clear_payload", **_selector(body or {})}
    return coll.update_op(op)


def h_batch_update(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    results = []
    for op_spec in (body or {}).get("operations", []):
        if "upsert" in op_spec:
            results.append(coll.upsert(_points_from_upsert(op_spec["upsert"])))
        elif "delete" in op_spec:
            results.append(
                coll.update_op({"type": "delete", **_selector(op_spec["delete"])})
            )
        elif "set_payload" in op_spec:
            s = op_spec["set_payload"]
            results.append(
                coll.update_op(
                    {
                        "type": "set_payload",
                        "payload": s.get("payload") or {},
                        "key": s.get("key"),
                        **_selector(s),
                    }
                )
            )
        elif "overwrite_payload" in op_spec:
            s = op_spec["overwrite_payload"]
            results.append(
                coll.update_op(
                    {
                        "type": "overwrite_payload",
                        "payload": s.get("payload") or {},
                        **_selector(s),
                    }
                )
            )
        elif "delete_payload" in op_spec:
            s = op_spec["delete_payload"]
            results.append(
                coll.update_op(
                    {"type": "delete_payload", "keys": s.get("keys") or [], **_selector(s)}
                )
            )
        elif "clear_payload" in op_spec:
            s = op_spec["clear_payload"]
            results.append(coll.update_op({"type": "clear_payload", **_selector(s)}))
        elif "update_vectors" in op_spec:
            s = op_spec["update_vectors"]
            pts = []
            for p in s.get("points", []):
                vec = p.get("vector")
                vectors = (
                    vec if isinstance(vec, dict) and "indices" not in vec else {"": vec}
                )
                pts.append({"id": p["id"], "vectors": vectors})
            results.append(coll.update_op({"type": "update_vectors", "points": pts}))
        elif "delete_vectors" in op_spec:
            s = op_spec["delete_vectors"]
            results.append(
                coll.update_op(
                    {
                        "type": "delete_vectors",
                        "names": s.get("vector") or [],
                        **_selector(s),
                    }
                )
            )
        else:
            raise ApiError(f"unknown batch operation {list(op_spec.keys())}")
    return results


def _hydrate_records(coll, ids, with_payload, with_vector):
    from ..collection.query import _select_payload, _select_vectors

    out = []
    for pid in ids:
        payload, vectors = coll.get_payload_and_vectors(pid)
        if payload is None and vectors is None:
            continue
        rec: Dict[str, Any] = {"id": pid}
        p = _select_payload(payload, with_payload)
        if p is not None:
            rec["payload"] = p
        v = _select_vectors(vectors, with_vector)
        if v is not None:
            rec["vector"] = v
        out.append(rec)
    return out


def h_get_point(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    pid = m["id"]
    try:
        pid = int(pid)
    except ValueError:
        pass
    pid = normalize_point_id(pid)
    recs = _hydrate_records(coll, [pid], True, True)
    if not recs:
        raise ApiError(f"Point with id {pid} does not exists!", 404)
    return recs[0]


def h_retrieve_points(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    body = body or {}
    ids = [normalize_point_id(p) for p in body.get("ids", [])]
    return _hydrate_records(
        coll, ids, body.get("with_payload", True), body.get("with_vector", False)
    )


def h_scroll(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    body = body or {}
    limit = int(body.get("limit", 10))
    flt = parse_filter(body.get("filter"))
    offset = body.get("offset")
    if offset is not None:
        offset = normalize_point_id(offset)
    order_by = body.get("order_by")
    if order_by:
        ex = QueryExecutor(coll, toc)
        req = QueryRequest(
            {
                "query": {"order_by": order_by},
                "filter": body.get("filter"),
                "limit": limit,
                "with_payload": body.get("with_payload", True),
                "with_vector": body.get("with_vector", False),
                "shard_key": body.get("shard_key"),
            }
        )
        points = ex.query(req)
        for p in points:
            p.pop("score", None)
            p.pop("version", None)
        return {"points": points, "next_page_offset": None}
    ids = coll.scroll_ids(limit + 1, offset, flt, shard_key=body.get("shard_key"))
    next_offset = None
    if len(ids) > limit:
        next_offset = ids[limit]
        ids = ids[:limit]
    points = _hydrate_records(
        coll, ids, body.get("with_payload", True), body.get("with_vector", False)
    )
    return {"points": points, "next_page_offset": next_offset}


def h_count(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    body = body or {}
    return {"count": coll.count(parse_filter(body.get("filter")), body.get("shard_key"))}


def h_facet(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    body = body or {}
    key = body.get("key")
    if not key:
        raise ApiError("key required")
    hits = coll.facet(
        key,
        int(body.get("limit", 10)),
        parse_filter(body.get("filter")),
        body.get("shard_key"),
    )
    return {"hits": [{"value": v, "count": c} for v, c in hits]}


def _legacy_search_to_query(body: dict) -> dict:
    """Map legacy /points/search body → universal query request."""
    body = dict(body or {})
    vec = body.pop("vector", None)
    using = ""
    query: Any = vec
    if isinstance(vec, dict):
        if "name" in vec:
            using = vec["name"]
            query = vec.get("vector")
        elif "indices" in vec:
            query = vec
    d = {
        "query": query if query is not None else None,
        "using": using,
        "filter": body.get("filter"),
        "params": body.get("params"),
        "limit": body.get("limit", 10),
        "offset": body.get("offset", 0),
        "with_payload": body.get("with_payload", False),
        "with_vector": body.get("with_vector", False),
        "score_threshold": body.get("score_threshold"),
        "shard_key": body.get("shard_key"),
    }
    return d


def h_search(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    ex = QueryExecutor(coll, toc)
    return ex.query(QueryRequest(_legacy_search_to_query(body)))


def _check_batchsize(coll, n):
    sm = coll.strict_mode_config
    if sm.enabled and sm.search_max_batchsize and n > sm.search_max_batchsize:
        from ..types import StrictModeError

        raise StrictModeError(
            f"batch of {n} searches exceeds strict mode search_max_batchsize "
            f"{sm.search_max_batchsize}"
        )


def _run_batch(fn, items, max_workers: int = 64):
    """Run a batch request's sub-queries CONCURRENTLY so the collection's
    micro-batcher coalesces them into padded device batches (sequential
    execution would issue one tiny device call per sub-query). Order
    preserved; first exception propagates."""
    if len(items) <= 1:
        return [fn(it) for it in items]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=min(len(items), max_workers)) as tp:
        return list(tp.map(fn, items))


def h_search_batch(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    _check_batchsize(coll, len((body or {}).get("searches", [])))
    ex = QueryExecutor(coll, toc)
    return _run_batch(
        lambda sub: ex.query(QueryRequest(_legacy_search_to_query(sub))),
        (body or {}).get("searches", []),
    )


def _legacy_recommend_to_query(body: dict) -> dict:
    body = dict(body or {})
    using = body.get("using") or ""
    return {
        "query": {
            "recommend": {
                "positive": body.get("positive") or [],
                "negative": body.get("negative") or [],
                "strategy": body.get("strategy", "average_vector"),
            }
        },
        "using": using,
        "filter": body.get("filter"),
        "params": body.get("params"),
        "limit": body.get("limit", 10),
        "offset": body.get("offset", 0),
        "with_payload": body.get("with_payload", False),
        "with_vector": body.get("with_vector", False),
        "score_threshold": body.get("score_threshold"),
        "lookup_from": body.get("lookup_from"),
        "shard_key": body.get("shard_key"),
    }


def h_recommend(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    ex = QueryExecutor(coll, toc)
    return ex.query(QueryRequest(_legacy_recommend_to_query(body)))


def h_recommend_batch(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    _check_batchsize(coll, len((body or {}).get("searches", [])))
    ex = QueryExecutor(coll, toc)
    return _run_batch(
        lambda sub: ex.query(QueryRequest(_legacy_recommend_to_query(sub))),
        (body or {}).get("searches", []),
    )


def h_discover(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    body = dict(body or {})
    spec: Dict[str, Any] = {}
    if body.get("target") is not None:
        spec = {
            "discover": {"target": body["target"], "context": body.get("context") or []}
        }
    else:
        spec = {"context": body.get("context") or []}
    ex = QueryExecutor(coll, toc)
    return ex.query(
        QueryRequest(
            {
                "query": spec,
                "using": body.get("using") or "",
                "filter": body.get("filter"),
                "params": body.get("params"),
                "limit": body.get("limit", 10),
                "offset": body.get("offset", 0),
                "with_payload": body.get("with_payload", False),
                "with_vector": body.get("with_vector", False),
                "shard_key": body.get("shard_key"),
            }
        )
    )


def h_discover_batch(toc, m, body, q):
    out = []
    for sub in (body or {}).get("searches", []):
        out.append(h_discover(toc, m, sub, q))
    return out


def h_query(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    ex = QueryExecutor(coll, toc)
    return {"points": ex.query(QueryRequest(body or {}))}


def h_query_batch(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    _check_batchsize(coll, len((body or {}).get("searches", [])))
    ex = QueryExecutor(coll, toc)
    return _run_batch(
        lambda sub: {"points": ex.query(QueryRequest(sub))},
        (body or {}).get("searches", []),
    )


def h_query_groups(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    ex = QueryExecutor(coll, toc)
    return {"groups": ex.query_groups(QueryRequest(body or {}))}


def h_search_groups(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    body = dict(body or {})
    d = _legacy_search_to_query(body)
    d["group_by"] = body.get("group_by")
    d["group_size"] = body.get("group_size", 3)
    d["with_lookup"] = body.get("with_lookup")
    ex = QueryExecutor(coll, toc)
    return {"groups": ex.query_groups(QueryRequest(d))}


def h_recommend_groups(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    body = dict(body or {})
    d = _legacy_recommend_to_query(body)
    d["group_by"] = body.get("group_by")
    d["group_size"] = body.get("group_size", 3)
    d["with_lookup"] = body.get("with_lookup")
    ex = QueryExecutor(coll, toc)
    return {"groups": ex.query_groups(QueryRequest(d))}


def _matrix_common(toc, m, body):
    coll = toc.get_collection(m["name"])
    body = body or {}
    sample = int(body.get("sample", 10))
    limit = int(body.get("limit", 3))
    using = body.get("using") or ""
    flt = parse_filter(body.get("filter"))
    ids = coll.scroll_ids(sample, flt=flt)
    vecs = []
    kept = []
    for pid in ids:
        v = coll.get_point_vector(pid, using)
        if v is not None and not isinstance(v, dict):
            vecs.append(np.asarray(v, dtype=np.float32))
            kept.append(pid)
    if not kept:
        return [], np.zeros((0, 0)), limit
    from ..collection.query import score_np

    vp = coll.params.vectors[using]
    arr = np.stack(vecs)
    scores = np.stack([score_np(v, arr, vp.distance) for v in vecs])
    np.fill_diagonal(scores, -np.inf)
    return kept, scores, limit


def h_matrix_pairs(toc, m, body, q):
    ids, scores, limit = _matrix_common(toc, m, body)
    pairs = []
    for i, pid in enumerate(ids):
        order = np.argsort(-scores[i])[:limit]
        for j in order:
            if np.isfinite(scores[i][j]):
                pairs.append({"a": pid, "b": ids[int(j)], "score": float(scores[i][j])})
    return {"pairs": pairs}


def h_matrix_offsets(toc, m, body, q):
    ids, scores, limit = _matrix_common(toc, m, body)
    rows, cols, vals = [], [], []
    for i in range(len(ids)):
        order = np.argsort(-scores[i])[:limit]
        for j in order:
            if np.isfinite(scores[i][j]):
                rows.append(i)
                cols.append(int(j))
                vals.append(float(scores[i][j]))
    return {
        "offsets_row": rows,
        "offsets_col": cols,
        "scores": vals,
        "ids": ids,
    }


def h_create_snapshot(toc, m, body, q):
    return toc.create_snapshot(m["name"])


def h_create_full_snapshot(toc, m, body, q):
    return toc.create_full_snapshot()


def h_list_full_snapshots(toc, m, body, q):
    return toc.list_full_snapshots()


class _FileResponse:
    def __init__(self, path):
        self.path = path


class _ContentResponse:
    """Raw bytes with an explicit content type (dashboard/static files)."""

    def __init__(self, content: bytes, content_type: str, status: int = 200):
        self.content = content
        self.content_type = content_type
        self.status = status


def h_dashboard(toc, m, body, q):
    """Web UI (reference: src/actix/web_ui.rs `/dashboard` static scope).
    Serves `service.static_content_dir` when present; built-in single-file
    dashboard otherwise (deliberate divergence — the reference's UI ships
    as a separate artifact)."""
    from ..api.webui import dashboard_content

    if not getattr(toc, "static_content_enabled", True):
        raise NotFoundError("static content disabled")
    content, mime = dashboard_content(
        getattr(toc, "static_content_dir", None), m.get("rest") or ""
    )
    if not mime:
        raise NotFoundError("no such file")
    return _ContentResponse(content, mime)


def h_list_snapshots(toc, m, body, q):
    return toc.list_snapshots(m["name"])


def h_delete_snapshot(toc, m, body, q):
    return toc.delete_snapshot(m["name"], m["snap"])


def h_recover_snapshot(toc, m, body, q):
    location = (body or {}).get("location")
    if not location:
        raise ApiError("location required")
    if location.startswith("file://"):
        location = location[len("file://") :]
    return toc.recover_snapshot(
        m["name"], location, checksum=(body or {}).get("checksum")
    )


def h_get_quotas(toc, m, body, q):
    """GET /quotas — config + this node's utilization, plus every
    reachable peer's in cluster mode (reference: quota_api.rs — a peer
    that does not answer is left out rather than failing the request;
    the struggling nodes are exactly the ones likely to time out)."""
    status = toc.quota.status()
    node = getattr(toc, "cluster_node", None)
    if node is not None:
        peers = {}
        for pid, url in dict(node.transport.peer_urls).items():
            if pid == node.peer_id:
                peers[str(pid)] = toc.quota.peer_usage()
                continue
            try:
                req = urllib.request.Request(
                    url.rstrip("/") + "/quotas?local=true", method="GET"
                )
                if node.transport.api_key:
                    req.add_header("api-key", node.transport.api_key)
                with urllib.request.urlopen(req, timeout=2) as resp:
                    peers[str(pid)] = json.loads(resp.read())["result"][
                        "peer_usage"
                    ]
            except Exception:
                continue  # unreachable peers are simply absent
        status["peers"] = peers
    if q.get("local"):
        status["peer_usage"] = toc.quota.peer_usage()
    return status


def h_put_quotas(toc, m, body, q):
    """PUT /quotas — update the cluster-wide quota config (consensus-
    replicated in cluster mode; persisted to quota.json)."""
    cfg = body or {}
    try:
        # validate locally first: apply-time consensus failures are silent
        toc.quota.update_config(cfg)
    except ValueError as e:
        raise ApiError(str(e))
    if _meta_submit(toc, {"type": "set_quota", "config": cfg}):
        return toc.quota.status()
    return toc.quota.status()


def h_cluster_bootstrap(toc, m, body, q):
    """A new peer announces itself: commit add_peer through consensus and
    return the current membership so the joiner can start its node
    (reference: src/main.rs --bootstrap flow over the internal p2p API)."""
    node = getattr(toc, "cluster_node", None)
    if node is None:
        raise ApiError("cluster mode is not enabled on this peer", 400)
    body = body or {}
    peer_id = int(body["peer_id"])
    url = body["url"]
    peers = dict(node.transport.peer_urls)
    peers[node.peer_id] = body.get("this_peer_url") or peers.get(node.peer_id, "")
    node.dispatcher.submit({"type": "add_peer", "peer_id": peer_id, "url": url})
    return {
        "peers": {str(k): v for k, v in node.transport.peer_urls.items() if k != peer_id},
        "this_peer_id": node.peer_id,
    }


def h_internal_update_forward(toc, m, body, q):
    """Leader execution of a forwarded write: lease OUR clock and fan out
    (reference: update.rs forwarded updates for medium/strong ordering)."""
    coll = toc.get_collection(m["name"])
    sid = int(m["sid"])
    op = (body or {}).get("op") or {}
    rs = coll.replica_sets.get(sid)
    if rs is not None:
        return rs.update(op)
    shard = coll.shards.get(sid)
    if shard is None:
        raise ApiError(f"shard {sid} not found", 404)
    return shard.update(op)


def h_raft_message(toc, m, body, q):
    node = getattr(toc, "cluster_node", None)
    if node is None:
        raise ApiError("cluster mode disabled", 404)
    node.receive(body or {})
    return True


def h_slow_requests(toc, m, body, q):
    """Slowest requests per request type (reference:
    profiling/slow_requests_log.rs; exposed in requests telemetry)."""
    return {"slow_requests": toc.slow_log.entries()}


def h_clear_slow_requests(toc, m, body, q):
    toc.slow_log.clear()
    return True


def h_audit_log(toc, m, body, q):
    """Recent audit events, newest first (reference: src/common/audit.rs)."""
    limit = int(q.get("limit", 100))
    return {"entries": toc.audit_log.read(limit)}


def h_raft_propose(toc, m, body, q):
    """Peer-forwarded consensus proposal (reference: followers forward meta
    ops to the leader over the internal plane)."""
    node = getattr(toc, "cluster_node", None)
    if node is None:
        raise ApiError("cluster mode disabled", 404)
    from ..cluster.raft import NotLeader

    try:
        node.dispatcher.submit(body or {})
    except NotLeader as e:
        raise ApiError(f"not the consensus leader; leader is peer {e.leader_id}", 503)
    return True


def h_cluster(toc, m, body, q):
    node = getattr(toc, "cluster_node", None)
    if node is not None:
        return node.cluster_info()
    return {
        "status": "disabled",
        "peer_id": 0,
        "peers": {},
        "raft_info": {
            "term": 0,
            "commit": 0,
            "pending_operations": 0,
            "leader": None,
            "role": None,
            "is_voter": True,
        },
    }


def h_collection_cluster_update(toc, m, body, q):
    """Collection cluster operations (reference: cluster_api.rs
    update_collection_cluster + cluster_ops.rs: move_shard,
    replicate_shard, drop_replica, abort_transfer, start_resharding)."""
    coll = toc.get_collection(m["name"])
    body = body or {}
    node = getattr(toc, "cluster_node", None)

    def _shard_op(spec, required):
        sid = spec.get("shard_id")
        if sid is None or int(sid) not in coll.all_shard_ids():
            raise ApiError(f"shard {sid} not found", 404)
        for f in required:
            if spec.get(f) is None:
                raise ApiError(f"missing field {f}")
        return int(sid)

    if "move_shard" in body:
        spec = body["move_shard"] or {}
        sid = _shard_op(spec, ("from_peer_id", "to_peer_id"))
        frm, to = int(spec["from_peer_id"]), int(spec["to_peer_id"])
        placed = coll.placement.get(sid) or []
        if frm not in placed:
            raise ApiError(f"peer {frm} does not hold shard {sid}")
        if to in placed:
            raise ApiError(f"peer {to} already holds shard {sid}")
        op = {"type": "move_replica", "name": coll.name, "shard_id": sid,
              "from_peer": frm, "to_peer": to}
        if _meta_submit(toc, op) is None:
            raise ApiError("cluster mode disabled", 400)
        return True
    if "replicate_shard" in body:
        spec = body["replicate_shard"] or {}
        sid = _shard_op(spec, ("to_peer_id",))
        to = int(spec["to_peer_id"])
        if to in (coll.placement.get(sid) or []):
            raise ApiError(f"peer {to} already holds shard {sid}")
        op = {"type": "replicate_replica", "name": coll.name,
              "shard_id": sid, "to_peer": to}
        if _meta_submit(toc, op) is None:
            raise ApiError("cluster mode disabled", 400)
        return True
    if "drop_replica" in body:
        spec = body["drop_replica"] or {}
        sid = _shard_op(spec, ("peer_id",))
        peer = int(spec["peer_id"])
        placed = coll.placement.get(sid) or []
        if peer not in placed:
            raise ApiError(f"peer {peer} does not hold shard {sid}")
        if len(placed) <= 1:
            raise ApiError(
                f"peer {peer} holds the only replica of shard {sid}; "
                "replicate it elsewhere first"
            )
        op = {"type": "drop_replica", "name": coll.name, "shard_id": sid,
              "peer_id": peer}
        if _meta_submit(toc, op) is None:
            raise ApiError("cluster mode disabled", 400)
        return True
    if "abort_transfer" in body:
        spec = body["abort_transfer"] or {}
        sid = _shard_op(spec, ("to_peer_id",))
        if node is None:
            raise ApiError("cluster mode disabled", 400)
        return node.abort_transfer(coll.name, sid, int(spec["to_peer_id"]))
    if "start_resharding" in body:
        spec = body["start_resharding"] or {}
        direction = spec.get("direction", "up")
        cur = len(coll.all_shard_ids())
        new_n = cur + 1 if direction == "up" else cur - 1
        if new_n < 1:
            raise ApiError("cannot scale below one shard")
        op = {
            "type": "reshard_collection",
            "name": coll.name,
            "new_shard_number": new_n,
        }
        if _meta_submit(toc, op) is None:
            coll.reshard(new_n)
        return True
    if "drop_resharding" in body:
        return True  # resharding here is synchronous; nothing to abort
    raise ApiError(f"unsupported cluster operation: {sorted(body)}")


def h_collection_cluster(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    node = getattr(toc, "cluster_node", None)
    local = []
    for sid, shard in coll.shards.items():
        local.append(
            {
                "shard_id": sid,
                "points_count": shard.point_count(),
                "state": "Active",
            }
        )
    remote = []
    for sid in sorted(coll.remote_shards):
        for peer_id in coll.placement.get(sid, []):
            if node is not None and peer_id == node.peer_id:
                continue
            remote.append(
                {"shard_id": sid, "peer_id": peer_id, "state": "Active"}
            )
    transfers = []
    if node is not None:
        for (cname, sid, to), rec in list(node.active_transfers.items()):
            if cname != coll.name:
                continue
            transfers.append(
                {
                    "shard_id": sid,
                    "from": rec["from"],
                    "to": rec["to"],
                    "method": rec["method"],
                    "sync": False,
                }
            )
    return {
        "peer_id": node.peer_id if node is not None else 0,
        "shard_count": len(coll.all_shard_ids()),
        "local_shards": local,
        "remote_shards": remote,
        "shard_transfers": transfers,
    }


def h_create_shard_key(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    body = body or {}
    coll.create_shard_key(body.get("shard_key"), int(body.get("shards_number", 1)))
    return True


def h_delete_shard_key(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    coll.delete_shard_key((body or {}).get("shard_key"))
    return True


def _local_replica(toc, name: str, shard_id: int):
    """Per-shard LocalReplica cache (clock maps live with the shard)."""
    coll = toc.get_collection(name)
    shard = coll.shards.get(shard_id)
    if shard is None:
        raise ApiError(f"shard {shard_id} not found", 404)
    cache = getattr(coll, "_local_replicas", None)
    if cache is None:
        cache = {}
        coll._local_replicas = cache
    cached = cache.get(shard_id)
    if cached is None or cached.shard is not shard:
        # identity check: a dropped-then-recreated shard (transfer abort
        # cleanup + fresh replicate) must not resolve to the closed object
        from ..cluster.replica_set import LocalReplica

        cached = cache[shard_id] = LocalReplica(shard)
    return cached


def h_internal_storage_read(toc, m, body, q):
    """Ranged read of a storage file for peers (reference: StorageRead
    gRPC service, storage_read_service.proto:17-21 — disaggregated-storage
    reads; here on the HTTP internal plane like the rest of cluster/)."""
    from ..storage.io_tier import IoTierError, read_local

    body = body or {}
    rel = body.get("path") or ""
    try:
        content = read_local(
            toc.storage_path,
            rel,
            int(body.get("offset") or 0),
            int(body.get("length", -1)),
        )
    except IoTierError as e:
        raise ApiError(str(e), 404)
    return _ContentResponse(content, "application/octet-stream")


def h_internal_update(toc, m, body, q):
    """Internal shard-plane update (reference: PointsInternal gRPC)."""
    body = body or {}
    replica = _local_replica(toc, m["name"], int(m["sid"]))
    return replica.update_with_clock(body.get("operation") or {}, body.get("clock_tag"))


def h_internal_records(toc, m, body, q):
    """Materialized point records for the remote-read path (the internal
    analogue of PointsInternal/Get in the reference)."""
    coll = toc.get_collection(m["name"])
    shard = coll.shards.get(int(m["sid"]))
    if shard is None:
        raise ApiError(f"shard {m['sid']} not found", 404)
    out = []
    for pid in (body or {}).get("ids", []):
        pid = normalize_point_id(pid)
        seg = shard._find_point(pid)
        if seg is None:
            continue
        internal = seg.id_tracker.internal_id(pid)
        out.append(
            {
                "id": pid if isinstance(pid, int) else str(pid),
                "payload": seg.get_payload(pid),
                "vectors": _jsonable_vectors(seg.get_vectors(pid)),
                "version": seg.id_tracker.version(internal),
            }
        )
    return {"records": out}


def _jsonable_vectors(vectors):
    if not vectors:
        return {}
    out = {}
    for name, v in vectors.items():
        if hasattr(v, "tolist"):
            out[name] = v.tolist()
        elif hasattr(v, "to_dict"):
            out[name] = v.to_dict()
        else:
            out[name] = v
    return out


def h_internal_search(toc, m, body, q):
    body = body or {}
    replica = _local_replica(toc, m["name"], int(m["sid"]))
    flt = parse_filter(body.get("filter"))
    if body.get("sparse_queries") is not None:
        from ..types import SparseVector

        queries = [SparseVector.from_dict(d) for d in body["sparse_queries"]]
        return replica.search_sparse(body.get("using") or "", queries, int(body.get("k", 10)), flt)
    if body.get("multi_query") is not None:
        return replica.shard.search_multi(
            body.get("using") or "",
            np.asarray(body["multi_query"], dtype=np.float32),
            int(body.get("k", 10)),
            flt,
        )
    queries = np.asarray(body.get("queries") or [], dtype=np.float32)
    return replica.search_dense(
        body.get("using") or "",
        queries,
        int(body.get("k", 10)),
        flt,
        SearchParams.from_dict(body.get("params")),
    )


def h_create_shard_snapshot(toc, m, body, q):
    """Public shard snapshot create (reference:
    src/actix/api/snapshot_api.rs::create_shard_snapshot)."""
    return toc.create_shard_snapshot(m["name"], int(m["sid"]))


def h_list_shard_snapshots(toc, m, body, q):
    return toc.list_shard_snapshots(m["name"], int(m["sid"]))


def h_delete_shard_snapshot(toc, m, body, q):
    return toc.delete_shard_snapshot(m["name"], int(m["sid"]), m["snap"])


def h_download_shard_snapshot(toc, m, body, q):
    return _FileResponse(toc.shard_snapshot_file(m["name"], int(m["sid"]), m["snap"]))


def h_recover_shard_snapshot(toc, m, body, q):
    """PUT .../shards/{sid}/snapshots/recover {location, checksum?}
    (reference: snapshot_api.rs::recover_shard_snapshot)."""
    body = body or {}
    location = body.get("location")
    if not location:
        raise ApiError("missing snapshot location")
    try:
        return toc.recover_shard_snapshot(
            m["name"], int(m["sid"]), location, checksum=body.get("checksum")
        )
    except ValueError as e:
        raise ApiError(str(e), 400)


def h_upload_shard_snapshot(toc, m, body, q):
    """POST .../shards/{sid}/snapshots/upload with the raw snapshot bytes
    as the body (reference: snapshot_api.rs::upload_shard_snapshot)."""
    if not isinstance(body, (bytes, bytearray)):
        raise ApiError("expected binary snapshot body")
    if q.get("checksum"):
        import hashlib

        digest = hashlib.sha256(bytes(body)).hexdigest()
        if digest != q["checksum"].lower():
            raise ApiError(
                f"snapshot checksum mismatch: expected {q['checksum']}, got {digest}"
            )
    return toc.restore_shard_snapshot_bytes(m["name"], int(m["sid"]), bytes(body))


def h_internal_snapshot(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    shard = coll.shards.get(int(m["sid"]))
    if shard is None:
        raise ApiError(f"shard {m['sid']} not found", 404)
    import base64

    return {"snapshot_b64": base64.b64encode(shard.create_snapshot_bytes()).decode()}


def h_internal_snapshot_recover(toc, m, body, q):
    coll = toc.get_collection(m["name"])
    shard = coll.shards.get(int(m["sid"]))
    if shard is None:
        raise ApiError(f"shard {m['sid']} not found", 404)
    if not isinstance(body, (bytes, bytearray)):
        raise ApiError("expected binary snapshot body")
    shard.restore_snapshot_bytes(bytes(body))
    # drop any cached replica wrapper (clock map resets with the snapshot)
    cache = getattr(coll, "_local_replicas", None)
    if cache is not None:
        cache.pop(int(m["sid"]), None)
    return True


def h_internal_count(toc, m, body, q):
    body = body or {}
    replica = _local_replica(toc, m["name"], int(m["sid"]))
    return {"count": replica.count(parse_filter(body.get("filter")))}


def h_internal_scroll(toc, m, body, q):
    body = body or {}
    replica = _local_replica(toc, m["name"], int(m["sid"]))
    offset = body.get("offset")
    if offset is not None:
        offset = normalize_point_id(offset)
    ids = replica.scroll_ids(
        int(body.get("limit", 10)), offset, parse_filter(body.get("filter"))
    )
    return {"ids": ids}


def h_healthz(toc, m, body, q):
    return "healthz check passed"


def h_get_issues(toc, m, body, q):
    return {"issues": ISSUES.list()}


def h_clear_issues(toc, m, body, q):
    ISSUES.clear()
    return True


def h_get_locks(toc, m, body, q):
    return dict(getattr(toc, "locks", {"write": False, "error_message": None}))


def h_set_locks(toc, m, body, q):
    prev = dict(getattr(toc, "locks", {"write": False, "error_message": None}))
    body = body or {}
    toc.locks = {
        "write": bool(body.get("write", False)),
        "error_message": body.get("error_message"),
    }
    return prev


def h_openapi(toc, m, body, q):
    """Generated OpenAPI 3 spec for this server (reference:
    src/schema_generator.rs → openapi.json)."""
    from .openapi import build_spec

    return build_spec(version="1.15.1-tpu")


def h_readyz(toc, m, body, q):
    """Readiness: in cluster mode, ready only once consensus has a known
    leader and this peer has applied up to the commit index (reference:
    src/common/health.rs:16-45); trivial pass single-node."""
    node = getattr(toc, "cluster_node", None)
    if node is not None:
        raft = node.raft
        if raft.leader_id is None or raft.last_applied < raft.commit_index:
            raise ApiError("not ready: consensus catching up", 503)
    return "all shards are ready"


def h_telemetry(toc, m, body, q):
    """Telemetry at detail levels 0-4, optionally anonymized (reference:
    src/common/telemetry.rs prepare_data + anonymize.rs; REST params
    src/actix/api/service_api.rs:34-70)."""
    from ..utils.telemetry import anonymize_telemetry, build_telemetry

    detail = int(q.get("details_level", 2))
    data = build_telemetry(toc, level=detail)
    if str(q.get("anonymize", "")).lower() in ("true", "1"):
        data = anonymize_telemetry(data)
    return data


def h_get_debugger(toc, m, body, q):
    """Debug/watchdog config (reference: src/actix/api/debug_api.rs
    /debugger + the service_debug deadlock checker, src/main.rs:331-366)."""
    from ..utils.debug import WATCHDOG

    return WATCHDOG.config()


def h_patch_debugger(toc, m, body, q):
    from ..utils.debug import WATCHDOG

    return WATCHDOG.configure(body or {})


def h_consistency_check(toc, m, body, q):
    """Read-back data-consistency check (reference: the
    data-consistency-check feature's local_shard verify)."""
    from ..utils.debug import check_shard_consistency

    coll = toc.get_collection(m["name"])
    out = {}
    for sid, shard in sorted(coll.shards.items()):
        out[str(sid)] = check_shard_consistency(shard)
    return {
        "consistent": all(v["consistent"] for v in out.values()),
        "shards": out,
    }


def h_get_logger(toc, m, body, q):
    """Runtime logging configuration (reference: src/tracing/config.rs
    reloadable filters — exposed as an endpoint instead of file-watch)."""
    from ..utils.telemetry import logger_config

    return logger_config()


def h_set_logger(toc, m, body, q):
    from ..utils.telemetry import set_logger_config

    try:
        return set_logger_config(body or {})
    except ValueError as e:
        raise ApiError(str(e), 400)


def h_metrics(toc, m, body, q):
    extra = {"collections_total": len(toc.list_collections())}
    total = 0
    per_collection = []
    for name in toc.list_collections():
        info = toc.get_collection(name).info()
        total += info["points_count"]
        per_collection.append((name, info))
    extra["points_total"] = total
    text = METRICS.render_prometheus(extra=extra)
    # per-collection gauges (reference: per_collection_metrics_test.sh)
    lines = [text, "# TYPE collection_points_total gauge"]
    for name, info in per_collection:
        lines.append(
            f'collection_points_total{{collection="{name}"}} {info["points_count"]}'
        )
        lines.append(
            f'collection_segments_total{{collection="{name}"}} {info["segments_count"]}'
        )
    return "\n".join(lines) + "\n"


ROUTES: List[Tuple[str, re.Pattern, Callable]] = [
    ("GET", re.compile(r"^/$"), h_root),
    ("GET", re.compile(r"^/healthz$"), h_healthz),
    ("GET", re.compile(r"^/livez$"), h_healthz),
    ("GET", re.compile(r"^/readyz$"), h_readyz),
    ("GET", re.compile(r"^/telemetry$"), h_telemetry),
    ("GET", re.compile(r"^/dashboard$"), h_dashboard),
    ("GET", re.compile(r"^/dashboard/(?P<rest>.*)$"), h_dashboard),
    ("GET", re.compile(r"^/openapi.json$"), h_openapi),
    ("GET", re.compile(r"^/metrics$"), h_metrics),
    ("GET", re.compile(r"^/cluster$"), h_cluster),
    ("GET", re.compile(r"^/quotas$"), h_get_quotas),
    ("PUT", re.compile(r"^/quotas$"), h_put_quotas),
    ("POST", re.compile(r"^/cluster/raft/message$"), h_raft_message),
    ("POST", re.compile(r"^/cluster/raft/propose$"), h_raft_propose),
    ("POST", re.compile(r"^/cluster/bootstrap$"), h_cluster_bootstrap),
    ("GET", re.compile(r"^/debugger$"), h_get_debugger),
    ("PATCH", re.compile(r"^/debugger$"), h_patch_debugger),
    (
        "GET",
        re.compile(r"^/collections/(?P<name>[^/]+)/consistency$"),
        h_consistency_check,
    ),
    ("GET", re.compile(r"^/logger$"), h_get_logger),
    ("POST", re.compile(r"^/logger$"), h_set_logger),
    ("PATCH", re.compile(r"^/logger$"), h_set_logger),
    ("GET", re.compile(r"^/slow_requests$"), h_slow_requests),
    ("DELETE", re.compile(r"^/slow_requests$"), h_clear_slow_requests),
    ("GET", re.compile(r"^/audit$"), h_audit_log),
    ("GET", re.compile(r"^/issues$"), h_get_issues),
    ("DELETE", re.compile(r"^/issues$"), h_clear_issues),
    ("GET", re.compile(r"^/locks$"), h_get_locks),
    ("POST", re.compile(r"^/locks$"), h_set_locks),
    (
        "POST",
        re.compile(
            r"^/internal/collections/(?P<name>[^/]+)/shards/(?P<sid>\d+)/update_forward$"
        ),
        h_internal_update_forward,
    ),
    (
        "POST",
        re.compile(r"^/internal/storage/read$"),
        h_internal_storage_read,
    ),
    (
        "POST",
        re.compile(r"^/internal/collections/(?P<name>[^/]+)/shards/(?P<sid>\d+)/update$"),
        h_internal_update,
    ),
    (
        "POST",
        re.compile(r"^/internal/collections/(?P<name>[^/]+)/shards/(?P<sid>\d+)/search$"),
        h_internal_search,
    ),
    (
        "POST",
        re.compile(r"^/internal/collections/(?P<name>[^/]+)/shards/(?P<sid>\d+)/count$"),
        h_internal_count,
    ),
    (
        "POST",
        re.compile(
            r"^/internal/collections/(?P<name>[^/]+)/shards/(?P<sid>\d+)/snapshot$"
        ),
        h_internal_snapshot,
    ),
    (
        "POST",
        re.compile(
            r"^/internal/collections/(?P<name>[^/]+)/shards/(?P<sid>\d+)/snapshot/recover$"
        ),
        h_internal_snapshot_recover,
    ),
    (
        "POST",
        re.compile(r"^/internal/collections/(?P<name>[^/]+)/shards/(?P<sid>\d+)/scroll$"),
        h_internal_scroll,
    ),
    (
        "POST",
        re.compile(r"^/internal/collections/(?P<name>[^/]+)/shards/(?P<sid>\d+)/records$"),
        h_internal_records,
    ),
    ("GET", re.compile(r"^/aliases$"), h_all_aliases),
    ("POST", re.compile(r"^/collections/aliases$"), h_update_aliases),
    ("GET", re.compile(r"^/collections$"), h_list_collections),
    ("GET", re.compile(r"^/collections/(?P<name>[^/]+)$"), h_get_collection),
    ("PUT", re.compile(r"^/collections/(?P<name>[^/]+)$"), h_create_collection),
    ("PATCH", re.compile(r"^/collections/(?P<name>[^/]+)$"), h_update_collection),
    ("DELETE", re.compile(r"^/collections/(?P<name>[^/]+)$"), h_delete_collection),
    ("GET", re.compile(r"^/collections/(?P<name>[^/]+)/exists$"), h_collection_exists),
    ("GET", re.compile(r"^/collections/(?P<name>[^/]+)/aliases$"), h_collection_aliases),
    ("GET", re.compile(r"^/collections/(?P<name>[^/]+)/cluster$"), h_collection_cluster),
    (
        "POST",
        re.compile(r"^/collections/(?P<name>[^/]+)/cluster$"),
        h_collection_cluster_update,
    ),
    ("PUT", re.compile(r"^/collections/(?P<name>[^/]+)/shards$"), h_create_shard_key),
    ("POST", re.compile(r"^/collections/(?P<name>[^/]+)/shards/delete$"), h_delete_shard_key),
    ("PUT", re.compile(r"^/collections/(?P<name>[^/]+)/index$"), h_create_index),
    (
        "PUT",
        re.compile(r"^/collections/(?P<name>[^/]+)/vectors/(?P<vname>[^/]+)$"),
        h_create_vector_name,
    ),
    (
        "DELETE",
        re.compile(r"^/collections/(?P<name>[^/]+)/vectors/(?P<vname>[^/]+)$"),
        h_delete_vector_name,
    ),
    (
        "DELETE",
        re.compile(r"^/collections/(?P<name>[^/]+)/index/(?P<field>[^/]+)$"),
        h_delete_index,
    ),
    ("PUT", re.compile(r"^/collections/(?P<name>[^/]+)/points$"), h_upsert_points),
    ("POST", re.compile(r"^/collections/(?P<name>[^/]+)/points$"), h_retrieve_points),
    ("POST", re.compile(r"^/collections/(?P<name>[^/]+)/points/delete$"), h_delete_points),
    ("PUT", re.compile(r"^/collections/(?P<name>[^/]+)/points/vectors$"), h_update_vectors),
    (
        "POST",
        re.compile(r"^/collections/(?P<name>[^/]+)/points/vectors/delete$"),
        h_delete_vectors,
    ),
    ("POST", re.compile(r"^/collections/(?P<name>[^/]+)/points/payload$"), h_set_payload),
    ("PUT", re.compile(r"^/collections/(?P<name>[^/]+)/points/payload$"), h_overwrite_payload),
    (
        "POST",
        re.compile(r"^/collections/(?P<name>[^/]+)/points/payload/delete$"),
        h_delete_payload,
    ),
    (
        "POST",
        re.compile(r"^/collections/(?P<name>[^/]+)/points/payload/clear$"),
        h_clear_payload,
    ),
    ("POST", re.compile(r"^/collections/(?P<name>[^/]+)/points/batch$"), h_batch_update),
    ("POST", re.compile(r"^/collections/(?P<name>[^/]+)/points/scroll$"), h_scroll),
    ("POST", re.compile(r"^/collections/(?P<name>[^/]+)/points/count$"), h_count),
    ("POST", re.compile(r"^/collections/(?P<name>[^/]+)/points/facet$"), h_facet),
    # canonical reference path (src/actix/api/facet_api.rs:18)
    ("POST", re.compile(r"^/collections/(?P<name>[^/]+)/facet$"), h_facet),
    ("POST", re.compile(r"^/collections/(?P<name>[^/]+)/points/search$"), h_search),
    (
        "POST",
        re.compile(r"^/collections/(?P<name>[^/]+)/points/search/batch$"),
        h_search_batch,
    ),
    (
        "POST",
        re.compile(r"^/collections/(?P<name>[^/]+)/points/search/groups$"),
        h_search_groups,
    ),
    (
        "POST",
        re.compile(r"^/collections/(?P<name>[^/]+)/points/search/matrix/pairs$"),
        h_matrix_pairs,
    ),
    (
        "POST",
        re.compile(r"^/collections/(?P<name>[^/]+)/points/search/matrix/offsets$"),
        h_matrix_offsets,
    ),
    ("POST", re.compile(r"^/collections/(?P<name>[^/]+)/points/recommend$"), h_recommend),
    (
        "POST",
        re.compile(r"^/collections/(?P<name>[^/]+)/points/recommend/batch$"),
        h_recommend_batch,
    ),
    (
        "POST",
        re.compile(r"^/collections/(?P<name>[^/]+)/points/recommend/groups$"),
        h_recommend_groups,
    ),
    ("POST", re.compile(r"^/collections/(?P<name>[^/]+)/points/discover$"), h_discover),
    (
        "POST",
        re.compile(r"^/collections/(?P<name>[^/]+)/points/discover/batch$"),
        h_discover_batch,
    ),
    ("POST", re.compile(r"^/collections/(?P<name>[^/]+)/points/query$"), h_query),
    (
        "POST",
        re.compile(r"^/collections/(?P<name>[^/]+)/points/query/batch$"),
        h_query_batch,
    ),
    (
        "POST",
        re.compile(r"^/collections/(?P<name>[^/]+)/points/query/groups$"),
        h_query_groups,
    ),
    ("POST", re.compile(r"^/collections/(?P<name>[^/]+)/snapshots$"), h_create_snapshot),
    ("GET", re.compile(r"^/collections/(?P<name>[^/]+)/snapshots$"), h_list_snapshots),
    (
        "DELETE",
        re.compile(r"^/collections/(?P<name>[^/]+)/snapshots/(?P<snap>[^/]+)$"),
        h_delete_snapshot,
    ),
    (
        "PUT",
        re.compile(r"^/collections/(?P<name>[^/]+)/snapshots/recover$"),
        h_recover_snapshot,
    ),
    (
        "POST",
        re.compile(r"^/collections/(?P<name>[^/]+)/shards/(?P<sid>\d+)/snapshots$"),
        h_create_shard_snapshot,
    ),
    (
        "GET",
        re.compile(r"^/collections/(?P<name>[^/]+)/shards/(?P<sid>\d+)/snapshots$"),
        h_list_shard_snapshots,
    ),
    (
        "PUT",
        re.compile(
            r"^/collections/(?P<name>[^/]+)/shards/(?P<sid>\d+)/snapshots/recover$"
        ),
        h_recover_shard_snapshot,
    ),
    (
        "POST",
        re.compile(
            r"^/collections/(?P<name>[^/]+)/shards/(?P<sid>\d+)/snapshots/upload$"
        ),
        h_upload_shard_snapshot,
    ),
    (
        "DELETE",
        re.compile(
            r"^/collections/(?P<name>[^/]+)/shards/(?P<sid>\d+)/snapshots/(?P<snap>[^/]+)$"
        ),
        h_delete_shard_snapshot,
    ),
    (
        "GET",
        re.compile(
            r"^/collections/(?P<name>[^/]+)/shards/(?P<sid>\d+)/snapshots/(?P<snap>[^/]+)$"
        ),
        h_download_shard_snapshot,
    ),
    ("POST", re.compile(r"^/snapshots$"), h_create_full_snapshot),
    ("GET", re.compile(r"^/snapshots$"), h_list_full_snapshots),
    (
        "GET",
        re.compile(r"^/collections/(?P<name>[^/]+)/snapshots/(?P<snap>[^/]+)$"),
        lambda toc, m, body, q: _FileResponse(toc.snapshot_file(m["name"], m["snap"])),
    ),
    ("GET", re.compile(r"^/collections/(?P<name>[^/]+)/points/(?P<id>[^/]+)$"), h_get_point),
]


# access level per handler: "read" (default), "write" (collection-scoped
# mutation), "manage" (global/meta operations). Reference: rbac/ops_checks.rs.
# point-adding / index-building handlers gated by the node resource quota
# (deletes are exempt — they free the resource the quota protects)
QUOTA_ENFORCED = None  # filled below, after all handlers exist

ACCESS_LEVELS = {
    h_cluster_bootstrap: "manage",
    h_put_quotas: "manage",
    h_create_collection: "manage",
    h_collection_cluster_update: "manage",
    h_update_collection: "manage",
    h_delete_collection: "manage",
    h_update_aliases: "manage",
    h_create_shard_key: "manage",
    h_delete_shard_key: "manage",
    h_recover_snapshot: "manage",
    h_create_index: "write",
    h_delete_index: "write",
    h_create_vector_name: "write",
    h_delete_vector_name: "write",
    h_upsert_points: "write",
    h_delete_points: "write",
    h_update_vectors: "write",
    h_delete_vectors: "write",
    h_set_payload: "write",
    h_overwrite_payload: "write",
    h_delete_payload: "write",
    h_clear_payload: "write",
    h_batch_update: "write",
    h_create_snapshot: "write",
    h_delete_snapshot: "write",
    h_create_shard_snapshot: "write",
    h_delete_shard_snapshot: "write",
    h_recover_shard_snapshot: "manage",
    h_upload_shard_snapshot: "manage",
    h_create_full_snapshot: "manage",
    h_set_locks: "manage",
    # Internal peer-to-peer plane: the reference exposes these only on a
    # separate p2p gRPC API. Here they share the HTTP port, so they require
    # full (manage) credentials — a read-only key or collection-scoped JWT
    # must not be able to inject raft messages or internal shard ops.
    h_raft_message: "manage",
    h_raft_propose: "manage",
    h_audit_log: "manage",
    h_slow_requests: "manage",
    h_clear_slow_requests: "manage",
    h_set_logger: "manage",
    h_get_debugger: "manage",
    h_patch_debugger: "manage",
    h_internal_update: "manage",
    h_internal_update_forward: "manage",
    h_internal_snapshot_recover: "manage",
    h_internal_snapshot: "manage",
    # internal reads: manage-level auth, but not subject to the write lock
    h_internal_search: "internal-read",
    h_internal_count: "internal-read",
    h_internal_scroll: "internal-read",
    h_internal_records: "internal-read",
    h_internal_storage_read: "internal-read",
}

QUOTA_ENFORCED = {
    h_upsert_points,
    h_update_vectors,
    h_set_payload,
    h_overwrite_payload,
    h_batch_update,
    h_create_index,
    h_internal_update,
    h_internal_update_forward,
}


class _Handler(BaseHTTPRequestHandler):
    toc: TableOfContent = None  # injected
    authenticator = None  # injected (api.auth.Authenticator)
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet
        pass

    def _dispatch(self, method: str) -> None:
        started = time.monotonic()
        parsed = urllib.parse.urlparse(self.path)
        path = parsed.path.rstrip("/") or "/"
        qparams = dict(urllib.parse.parse_qsl(parsed.query))
        body = None
        length = int(self.headers.get("Content-Length") or 0)
        if length:
            raw = self.rfile.read(length)
            ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
            if raw and ctype == "application/octet-stream":
                body = raw  # binary payload (snapshot upload)
            elif raw:
                try:
                    body = json.loads(raw)
                except json.JSONDecodeError as e:
                    self._reply(400, {"status": {"error": f"bad json: {e}"}, "time": 0.0})
                    return
        for route_method, pattern, handler in ROUTES:
            if route_method != method:
                continue
            m = pattern.match(path)
            if not m:
                continue
            try:
                groups = m.groupdict()
                if self.authenticator is not None and self.authenticator.enabled:
                    if path not in ("/healthz", "/livez", "/readyz"):
                        access = self.authenticator.authenticate(self.headers)
                        level = ACCESS_LEVELS.get(handler, "read")
                        if level in ("manage", "internal-read"):
                            access.check_manage()
                        elif "name" in groups:
                            access.check_collection(
                                self.toc.resolve_name(groups["name"]),
                                write=(level == "write"),
                            )
                        elif level == "write" and not access.write:
                            raise AuthError("write access denied")
                if ACCESS_LEVELS.get(handler) in ("write", "manage") and handler not in (
                    h_set_locks,
                ):
                    locks = getattr(self.toc, "locks", None)
                    if locks and locks.get("write"):
                        raise ApiError(
                            locks.get("error_message") or "Write operations are forbidden",
                            403,
                        )
                if handler in QUOTA_ENFORCED:
                    # node resource quota: refuse resource-consuming updates
                    # while memory/disk sits over an enforced limit
                    # (reference: quota checks in the update path)
                    self.toc.quota.check_write()
                with measure() as acc:
                    result = handler(self.toc, groups, body, qparams)
                elapsed = time.monotonic() - started
                METRICS.observe(method, pattern.pattern, 200, elapsed)
                self._observe(handler, groups, path, body, elapsed, method)
                if isinstance(result, _FileResponse):
                    self._reply_file(200, result.path)
                elif isinstance(result, _ContentResponse):
                    self._reply_content(result)
                elif path == "/metrics":
                    self._reply_text(200, result)
                else:
                    envelope = {"result": result, "status": "ok", "time": elapsed}
                    if acc.cpu or acc.payload_io_read:
                        envelope["usage"] = {"hardware": acc.to_dict()}
                    self._reply(200, envelope)
            except AuthError as e:
                elapsed = time.monotonic() - started
                METRICS.observe(method, pattern.pattern, 401, elapsed)
                audit = getattr(self.toc, "audit_log", None)
                if audit is not None:
                    audit.record(
                        api=path,
                        result="denied",
                        method=handler.__name__,
                        auth_type=self._auth_type(),
                        remote=self.client_address[0],
                        collection=groups.get("name"),
                        error=str(e),
                    )
                self._reply(401, {"status": {"error": str(e)}, "time": elapsed})
            except (ApiError, CollectionError, NotFoundError, QueryError, StrictModeError, InferenceError, QuotaExceededError, ValueError) as e:
                status = getattr(e, "status_code", 400)
                elapsed = time.monotonic() - started
                METRICS.observe(method, pattern.pattern, status, elapsed)
                self._reply(
                    status, {"status": {"error": str(e)}, "time": elapsed}
                )
            except Exception as e:  # internal error
                elapsed = time.monotonic() - started
                METRICS.observe(method, pattern.pattern, 500, elapsed)
                traceback.print_exc()
                self._reply(
                    500,
                    {
                        "status": {"error": f"internal error: {e}"},
                        "time": elapsed,
                    },
                )
            return
        self._reply(404, {"status": {"error": "not found"}, "time": 0.0})

    def _auth_type(self) -> str:
        auth = self.headers.get("Authorization") or ""
        if auth.startswith("Bearer ") and auth.count(".") >= 2:
            return "jwt"
        if self.headers.get("api-key") or auth.startswith("Bearer "):
            return "api_key"
        return "none"

    def _observe(self, handler, groups, path, body, elapsed, method) -> None:
        """Post-success observability: slow-request profiling for data-plane
        calls + audit events for write/manage operations."""
        slow = getattr(self.toc, "slow_log", None)
        if slow is not None and method == "POST":
            slow.observe(
                handler.__name__,
                groups.get("name", ""),
                elapsed,
                body if not isinstance(body, (bytes, bytearray)) else None,
            )
        level = ACCESS_LEVELS.get(handler)
        if level in ("write", "manage") and not path.startswith(
            ("/internal/", "/cluster/raft/")
        ):
            audit = getattr(self.toc, "audit_log", None)
            if audit is not None:
                audit.record(
                    api=path,
                    result="ok",
                    method=handler.__name__,
                    auth_type=self._auth_type(),
                    remote=self.client_address[0],
                    collection=groups.get("name"),
                )

    def _reply(self, code: int, payload: dict) -> None:
        data = json.dumps(payload, default=_json_default).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _reply_file(self, code: int, filepath) -> None:
        import os as _os

        size = _os.path.getsize(filepath)
        self.send_response(code)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(size))
        self.end_headers()
        with open(filepath, "rb") as f:
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                self.wfile.write(chunk)

    def _reply_content(self, result: "_ContentResponse") -> None:
        self.send_response(result.status)
        self.send_header("Content-Type", result.content_type)
        self.send_header("Content-Length", str(len(result.content)))
        # reference parity: the dashboard scope pins X-Frame-Options DENY
        self.send_header("X-Frame-Options", "DENY")
        self.end_headers()
        self.wfile.write(result.content)

    def _reply_text(self, code: int, text: str) -> None:
        data = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_PUT(self):
        self._dispatch("PUT")

    def do_PATCH(self):
        self._dispatch("PATCH")

    def do_DELETE(self):
        self._dispatch("DELETE")


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not serializable: {type(o)}")


class RestServer:
    def __init__(
        self,
        toc: TableOfContent,
        host: str = "127.0.0.1",
        port: int = 6333,
        api_key: Optional[str] = None,
        read_only_api_key: Optional[str] = None,
        static_content_dir: Optional[str] = "./static",
        enable_static_content: bool = True,
    ):
        # dashboard config rides on the toc (handlers only receive it)
        toc.static_content_dir = static_content_dir
        toc.static_content_enabled = enable_static_content
        handler = type(
            "BoundHandler",
            (_Handler,),
            {
                "toc": toc,
                "authenticator": Authenticator(api_key, read_only_api_key),
            },
        )
        class _Server(ThreadingHTTPServer):
            # stdlib default backlog is 5: a burst of concurrent clients
            # (each urllib call = one fresh connection) overflows the
            # accept queue and the kernel RESETs the excess
            request_queue_size = 256
            daemon_threads = True

        self.httpd = _Server((host, port), handler)
        self.port = self.httpd.server_address[1]
        self.toc = toc
        self._thread: Optional[threading.Thread] = None

    def start_background(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        # close the listening socket too — otherwise the kernel keeps
        # accepting connections into the backlog and peers see 30 s stalls
        # instead of connection-refused when this node dies
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
