"""gRPC API server — wire-compatible subset of the reference's services.

Reference: src/tonic/ (service registration mod.rs:138-338) with protos from
lib/api/src/grpc/proto/. ~45 wire-compatible methods are registered (full
method paths match the reference so stock qdrant gRPC clients interoperate):

  * qdrant.Qdrant: HealthCheck
  * qdrant.Collections: Get, List, Create, Update, Delete, CollectionExists,
    UpdateAliases, ListAliases, ListCollectionAliases
  * qdrant.Points: Upsert, Delete, Get, Search(+Batch), Query(+Batch, full
    universal query), Recommend, Scroll, Count, SetPayload,
    OverwritePayload, DeletePayload, ClearPayload, UpdateVectors,
    DeleteVectors, Create/DeleteFieldIndex
  * qdrant.Snapshots: Create, List, Delete (+ shard-level)

Built on grpc generic handlers + the runtime-descriptor schema
(grpc_schema.py) — no protoc codegen needed. The authoritative method list
is the registration table at the bottom of this file.
"""

from __future__ import annotations

import time
from concurrent import futures
from typing import Any, Dict, Optional

import grpc
import numpy as np

from ..collection.query import QueryExecutor, QueryRequest
from ..types import normalize_point_id
from .grpc_schema import MESSAGES
from .rest import VERSION
from .toc import TableOfContent

M = MESSAGES


# ---------------------------------------------------------------------------
# proto ↔ engine converters
# ---------------------------------------------------------------------------


def point_id_to_py(pid) -> Any:
    return pid.num if pid.WhichOneof("point_id_options") == "num" else pid.uuid


def py_to_point_id(value):
    if isinstance(value, int):
        return M["PointId"](num=value)
    return M["PointId"](uuid=str(value))


def shard_key_to_py(request) -> Any:
    """ShardKeySelector → REST-style shard_key value (scalar or list).

    Reference: points.proto:155-159 — repeated ShardKey (keyword | number).
    Returns None when the request carries no selector, so callers can pass
    the result straight through as the optional `shard_key` argument.
    """
    if not request.HasField("shard_key_selector"):
        return None
    sel = request.shard_key_selector
    keys = [
        k.keyword if k.WhichOneof("key") == "keyword" else k.number
        for k in sel.shard_keys
    ]
    if not keys and sel.HasField("fallback"):
        # fallback-only selectors route writes during resharding in the
        # reference; this deployment has no separate fallback routing plane,
        # so treat the fallback key as the selector rather than silently
        # dropping it (points.proto ShardKeySelector.fallback)
        fb = sel.fallback
        kind = fb.WhichOneof("key")
        if kind is not None:
            keys = [fb.keyword if kind == "keyword" else fb.number]
    if not keys:
        return None
    return keys[0] if len(keys) == 1 else keys


def with_lookup_to_py(request) -> Any:
    """WithLookup → REST-style with_lookup dict (points.proto:576-583)."""
    if not request.HasField("with_lookup"):
        return None
    wl = request.with_lookup
    return {
        "collection": wl.collection,
        "with_payload": (
            with_payload_to_py(wl.with_payload)
            if wl.HasField("with_payload")
            else True
        ),
        "with_vectors": (
            with_vectors_to_py(wl.with_vectors)
            if wl.HasField("with_vectors")
            else False
        ),
    }


def value_to_py(v) -> Any:
    kind = v.WhichOneof("kind")
    if kind == "null_value" or kind is None:
        return None
    if kind == "struct_value":
        return {k: value_to_py(x) for k, x in v.struct_value.fields.items()}
    if kind == "list_value":
        return [value_to_py(x) for x in v.list_value.values]
    return getattr(v, kind)


def py_to_value(x):
    v = M["Value"]()
    if x is None:
        v.null_value = 0
    elif isinstance(x, bool):
        v.bool_value = x
    elif isinstance(x, int):
        v.integer_value = x
    elif isinstance(x, float):
        v.double_value = x
    elif isinstance(x, str):
        v.string_value = x
    elif isinstance(x, dict):
        for k, e in x.items():
            v.struct_value.fields[k].CopyFrom(py_to_value(e))
        if not x:
            v.struct_value.SetInParent()
    elif isinstance(x, (list, tuple)):
        for e in x:
            v.list_value.values.append(py_to_value(e))
        if not x:
            v.list_value.SetInParent()
    else:
        v.string_value = str(x)
    return v


def match_to_dict(m) -> Optional[dict]:
    kind = m.WhichOneof("match_value")
    if kind is None:
        return None
    if kind in ("keyword", "integer", "boolean"):
        return {"value": getattr(m, kind)}
    if kind == "text":
        return {"text": m.text}
    if kind == "phrase":
        return {"phrase": m.phrase}
    if kind == "keywords":
        return {"any": list(m.keywords.strings)}
    if kind == "integers":
        return {"any": list(m.integers.integers)}
    if kind == "except_integers":
        return {"except": list(m.except_integers.integers)}
    if kind == "except_keywords":
        return {"except": list(m.except_keywords.strings)}
    return None


def _range_to_dict(r) -> dict:
    out = {}
    for k in ("lt", "gt", "gte", "lte"):
        if r.HasField(k):
            out[k] = getattr(r, k)
    return out


def condition_to_dict(c) -> Optional[dict]:
    kind = c.WhichOneof("condition_one_of")
    if kind == "field":
        f = c.field
        out: Dict[str, Any] = {"key": f.key}
        if f.HasField("match"):
            out["match"] = match_to_dict(f.match)
        if f.HasField("range"):
            out["range"] = _range_to_dict(f.range)
        if f.HasField("geo_bounding_box"):
            bb = f.geo_bounding_box
            out["geo_bounding_box"] = {
                "top_left": {"lon": bb.top_left.lon, "lat": bb.top_left.lat},
                "bottom_right": {
                    "lon": bb.bottom_right.lon,
                    "lat": bb.bottom_right.lat,
                },
            }
        if f.HasField("geo_radius"):
            gr = f.geo_radius
            out["geo_radius"] = {
                "center": {"lon": gr.center.lon, "lat": gr.center.lat},
                "radius": gr.radius,
            }
        if f.HasField("geo_polygon"):
            gp = f.geo_polygon
            out["geo_polygon"] = {
                "exterior": {
                    "points": [{"lon": p.lon, "lat": p.lat} for p in gp.exterior.points]
                },
                "interiors": [
                    {"points": [{"lon": p.lon, "lat": p.lat} for p in ring.points]}
                    for ring in gp.interiors
                ],
            }
        if f.HasField("values_count"):
            out["values_count"] = _range_to_dict(f.values_count)
        if f.HasField("datetime_range"):
            dr = {}
            for k in ("lt", "gt", "gte", "lte"):
                if f.datetime_range.HasField(k):
                    ts = getattr(f.datetime_range, k)
                    import datetime as _dt

                    dr[k] = _dt.datetime.fromtimestamp(
                        ts.seconds + ts.nanos / 1e9, tz=_dt.timezone.utc
                    ).isoformat()
            out["datetime_range"] = dr
        if f.HasField("is_empty"):
            out["is_empty"] = f.is_empty
        if f.HasField("is_null"):
            out["is_null"] = f.is_null
        return out
    if kind == "is_empty":
        return {"is_empty": {"key": c.is_empty.key}}
    if kind == "is_null":
        return {"is_null": {"key": c.is_null.key}}
    if kind == "has_id":
        return {"has_id": [point_id_to_py(p) for p in c.has_id.has_id]}
    if kind == "has_vector":
        return {"has_vector": c.has_vector.has_vector}
    if kind == "filter":
        return filter_to_dict(c.filter)
    if kind == "nested":
        return {
            "nested": {"key": c.nested.key, "filter": filter_to_dict(c.nested.filter)}
        }
    return None


def filter_to_dict(f) -> Optional[dict]:
    out: Dict[str, Any] = {}
    if f.must:
        out["must"] = [condition_to_dict(c) for c in f.must]
    if f.should:
        out["should"] = [condition_to_dict(c) for c in f.should]
    if f.must_not:
        out["must_not"] = [condition_to_dict(c) for c in f.must_not]
    if f.HasField("min_should"):
        out["min_should"] = {
            "conditions": [condition_to_dict(c) for c in f.min_should.conditions],
            "min_count": f.min_should.min_count,
        }
    return out or None


def vector_to_py(v) -> Any:
    kind = v.WhichOneof("vector")
    if kind == "dense":
        return list(v.dense.data)
    if kind == "sparse":
        return {"indices": list(v.sparse.indices), "values": list(v.sparse.values)}
    if kind == "multi_dense":
        return [list(d.data) for d in v.multi_dense.vectors]
    # legacy flat form
    if v.HasField("indices"):
        return {"indices": list(v.indices.data), "values": list(v.data)}
    return list(v.data)


def vectors_to_py(vs) -> Dict[str, Any]:
    kind = vs.WhichOneof("vectors_options")
    if kind == "vector":
        return {"": vector_to_py(vs.vector)}
    if kind == "vectors":
        return {name: vector_to_py(v) for name, v in vs.vectors.vectors.items()}
    return {}


def py_to_vector_output(v):
    out = M["VectorOutput"]()
    if isinstance(v, dict) and "indices" in v:
        out.sparse.values.extend(float(x) for x in v["values"])
        out.sparse.indices.extend(int(x) for x in v["indices"])
    elif v and isinstance(v[0], (list, tuple)):
        for row in v:
            out.multi_dense.vectors.add().data.extend(float(x) for x in row)
    else:
        out.dense.data.extend(float(x) for x in v)
    return out


def py_to_vectors_output(vectors: Dict[str, Any]):
    out = M["VectorsOutput"]()
    if list(vectors.keys()) == [""]:
        out.vector.CopyFrom(py_to_vector_output(vectors[""]))
    else:
        for name, v in vectors.items():
            out.vectors.vectors[name].CopyFrom(py_to_vector_output(v))
    return out


def with_payload_to_py(sel) -> Any:
    kind = sel.WhichOneof("selector_options")
    if kind is None:
        return True
    if kind == "enable":
        return sel.enable
    if kind == "include":
        return {"include": list(sel.include.fields)}
    return {"exclude": list(sel.exclude.fields)}


def with_vectors_to_py(sel) -> Any:
    kind = sel.WhichOneof("selector_options")
    if kind is None:
        return False
    if kind == "enable":
        return sel.enable
    return list(sel.include.names)


# ---------------------------------------------------------------------------
# service implementations
# ---------------------------------------------------------------------------


class _Services:
    def __init__(self, toc: TableOfContent):
        self.toc = toc

    # -- qdrant.Qdrant --

    def HealthCheck(self, request, context):
        return M["HealthCheckReply"](
            title="qdrant - vector search engine (TPU-native)", version=VERSION
        )

    # -- qdrant.Collections --

    def CollectionsGet(self, request, context):
        info = self.toc.get_collection(request.collection_name).info()
        result = M["CollectionInfo"](
            status=1,
            segments_count=info["segments_count"],
            points_count=info["points_count"],
            indexed_vectors_count=info["indexed_vectors_count"],
        )
        return M["GetCollectionInfoResponse"](result=result, time=0.0)

    def CollectionsList(self, request, context):
        resp = M["ListCollectionsResponse"](time=0.0)
        for name in self.toc.list_collections():
            resp.collections.add(name=name)
        return resp

    def CollectionsCreate(self, request, context):
        spec: Dict[str, Any] = {}
        if request.HasField("vectors_config"):
            vc = request.vectors_config
            kind = vc.WhichOneof("config")
            dist = {1: "Cosine", 2: "Euclid", 3: "Dot", 4: "Manhattan"}
            if kind == "params":
                spec["vectors"] = {
                    "size": vc.params.size,
                    "distance": dist.get(vc.params.distance, "Cosine"),
                }
            elif kind == "params_map":
                spec["vectors"] = {
                    name: {"size": p.size, "distance": dist.get(p.distance, "Cosine")}
                    for name, p in vc.params_map.map.items()
                }
        if request.HasField("shard_number"):
            spec["shard_number"] = request.shard_number
        if request.HasField("sharding_method") and request.sharding_method == 1:
            spec["sharding_method"] = "custom"
        ok = self.toc.create_collection(request.collection_name, spec)
        return M["CollectionOperationResponse"](result=bool(ok), time=0.0)

    @staticmethod
    def _shard_key_value(sk):
        kind = sk.WhichOneof("key")
        if kind is None:
            # an unset oneof would otherwise read number == 0 and silently
            # create/delete shard key 0 (reference validates the variant)
            raise ValueError("shard_key must set either keyword or number")
        return sk.keyword if kind == "keyword" else sk.number

    def CollectionsCreateShardKey(self, request, context):
        """Reference: collections_service.proto:36 CreateShardKey."""
        coll = self.toc.get_collection(request.collection_name)
        req = request.request
        if req.HasField("replication_factor") and req.replication_factor > 1:
            raise ValueError(
                "replication_factor on CreateShardKey is not supported by "
                "this deployment; create the collection with the desired "
                "replication_factor instead"
            )
        coll.create_shard_key(
            self._shard_key_value(req.shard_key),
            req.shards_number if req.HasField("shards_number") else 1,
        )
        return M["CreateShardKeyResponse"](result=True, time=0.0)

    def CollectionsDeleteShardKey(self, request, context):
        """Reference: collections_service.proto:38 DeleteShardKey."""
        coll = self.toc.get_collection(request.collection_name)
        coll.delete_shard_key(self._shard_key_value(request.request.shard_key))
        return M["DeleteShardKeyResponse"](result=True, time=0.0)

    def CollectionsUpdate(self, request, context):
        spec: Dict[str, Any] = {}
        if request.HasField("optimizers_config"):
            oc = request.optimizers_config
            d = {}
            for f in ("deleted_threshold", "vacuum_min_vector_number",
                      "default_segment_number", "indexing_threshold",
                      "flush_interval_sec"):
                if oc.HasField(f):
                    d[f] = getattr(oc, f)
            spec["optimizers_config"] = d
        if request.HasField("hnsw_config"):
            hc = request.hnsw_config
            d = {}
            for f in ("m", "ef_construct", "full_scan_threshold", "payload_m"):
                if hc.HasField(f):
                    d[f] = getattr(hc, f)
            spec["hnsw_config"] = d
        ok = self.toc.update_collection(request.collection_name, spec)
        return M["CollectionOperationResponse"](result=ok, time=0.0)

    def CollectionsDelete(self, request, context):
        ok = self.toc.delete_collection(request.collection_name)
        return M["CollectionOperationResponse"](result=bool(ok), time=0.0)

    def CollectionsExists(self, request, context):
        return M["CollectionExistsResponse"](
            result=M["CollectionExists"](
                exists=self.toc.has_collection(request.collection_name)
            ),
            time=0.0,
        )

    def CollectionsUpdateAliases(self, request, context):
        actions = []
        for op in request.actions:
            kind = op.WhichOneof("action")
            if kind == "create_alias":
                actions.append(
                    {
                        "create_alias": {
                            "collection_name": op.create_alias.collection_name,
                            "alias_name": op.create_alias.alias_name,
                        }
                    }
                )
            elif kind == "rename_alias":
                actions.append(
                    {
                        "rename_alias": {
                            "old_alias_name": op.rename_alias.old_alias_name,
                            "new_alias_name": op.rename_alias.new_alias_name,
                        }
                    }
                )
            elif kind == "delete_alias":
                actions.append(
                    {"delete_alias": {"alias_name": op.delete_alias.alias_name}}
                )
        ok = self.toc.update_aliases(actions)
        return M["CollectionOperationResponse"](result=bool(ok), time=0.0)

    def CollectionsListAliases(self, request, context):
        resp = M["ListAliasesResponse"](time=0.0)
        for a in self.toc.all_aliases():
            resp.aliases.add(
                alias_name=a["alias_name"], collection_name=a["collection_name"]
            )
        return resp

    def CollectionsListCollectionAliases(self, request, context):
        resp = M["ListAliasesResponse"](time=0.0)
        for a in self.toc.collection_aliases(request.collection_name):
            resp.aliases.add(
                alias_name=a["alias_name"], collection_name=a["collection_name"]
            )
        return resp

    def PointsCreateFieldIndex(self, request, context):
        from ..types import PayloadIndexParams

        coll = self.toc.get_collection(request.collection_name)
        types = {
            0: "keyword", 1: "integer", 2: "float", 3: "geo",
            4: "text", 5: "bool", 6: "datetime", 7: "uuid",
        }
        schema = types.get(
            request.field_type if request.HasField("field_type") else 0, "keyword"
        )
        coll.create_payload_index(
            request.field_name, PayloadIndexParams.from_dict(schema)
        )
        return M["PointsOperationResponse"](
            result=M["UpdateResult"](operation_id=0, status=2), time=0.0
        )

    def PointsDeleteFieldIndex(self, request, context):
        coll = self.toc.get_collection(request.collection_name)
        coll.delete_payload_index(request.field_name)
        return M["PointsOperationResponse"](
            result=M["UpdateResult"](operation_id=0, status=2), time=0.0
        )

    # -- qdrant.Points --

    def PointsUpsert(self, request, context):
        coll = self.toc.get_collection(request.collection_name)
        points = []
        for p in request.points:
            vectors = vectors_to_py(p.vectors) if p.HasField("vectors") else {}
            payload = (
                {k: value_to_py(v) for k, v in p.payload.items()} if p.payload else None
            )
            points.append(
                {"id": point_id_to_py(p.id), "vectors": vectors, "payload": payload}
            )
        res = coll.upsert(points, shard_key=shard_key_to_py(request))
        return M["PointsOperationResponse"](
            result=M["UpdateResult"](
                operation_id=res.get("operation_id", 0), status=2
            ),
            time=0.0,
        )

    def PointsDelete(self, request, context):
        coll = self.toc.get_collection(request.collection_name)
        sel = request.points
        kind = sel.WhichOneof("points_selector_one_of")
        op: Dict[str, Any] = {"type": "delete"}
        if kind == "points":
            op["ids"] = [point_id_to_py(p) for p in sel.points.ids]
        elif kind == "filter":
            op["filter"] = filter_to_dict(sel.filter)
        res = coll.update_op(op, shard_key=shard_key_to_py(request))
        return M["PointsOperationResponse"](
            result=M["UpdateResult"](
                operation_id=res.get("operation_id", 0), status=2
            ),
            time=0.0,
        )

    def PointsUpdateVectors(self, request, context):
        coll = self.toc.get_collection(request.collection_name)
        pts = []
        for pv in request.points:
            pts.append(
                {"id": point_id_to_py(pv.id), "vectors": vectors_to_py(pv.vectors)}
            )
        res = coll.update_op(
            {"type": "update_vectors", "points": pts},
            shard_key=shard_key_to_py(request),
        )
        return self._op_response(res)

    def PointsDeleteVectors(self, request, context):
        coll = self.toc.get_collection(request.collection_name)
        op = {
            "type": "delete_vectors",
            "names": list(request.vectors.names),
            **self._selector_to_op(request.points_selector),
        }
        return self._op_response(
            coll.update_op(op, shard_key=shard_key_to_py(request))
        )

    def PointsGet(self, request, context):
        coll = self.toc.get_collection(request.collection_name)
        with_payload = with_payload_to_py(request.with_payload)
        with_vectors = (
            with_vectors_to_py(request.with_vectors)
            if request.HasField("with_vectors")
            else False
        )
        from ..collection.query import _select_payload, _select_vectors

        resp = M["GetResponse"](time=0.0)
        for pid_msg in request.ids:
            pid = normalize_point_id(point_id_to_py(pid_msg))
            payload, vectors = coll.get_payload_and_vectors(pid)
            if payload is None and vectors is None:
                continue
            rp = resp.result.add(id=py_to_point_id(pid))
            p = _select_payload(payload, with_payload)
            if p:
                for k, v in p.items():
                    rp.payload[k].CopyFrom(py_to_value(v))
            if with_vectors and vectors:
                sel = (
                    {k: v for k, v in vectors.items() if k in with_vectors}
                    if isinstance(with_vectors, list)
                    else vectors
                )
                rp.vectors.CopyFrom(py_to_vectors_output(sel))
        return resp

    def PointsSearch(self, request, context):
        coll = self.toc.get_collection(request.collection_name)
        ex = QueryExecutor(coll, self.toc)
        d = {
            "query": list(request.vector),
            "using": request.vector_name if request.HasField("vector_name") else "",
            "filter": filter_to_dict(request.filter),
            "limit": request.limit or 10,
            "offset": request.offset if request.HasField("offset") else 0,
            "with_payload": with_payload_to_py(request.with_payload),
            "with_vector": (
                with_vectors_to_py(request.with_vectors)
                if request.HasField("with_vectors")
                else False
            ),
            "score_threshold": (
                request.score_threshold
                if request.HasField("score_threshold")
                else None
            ),
            "shard_key": shard_key_to_py(request),
        }
        if request.HasField("params"):
            p = request.params
            params: Dict[str, Any] = {}
            if p.HasField("hnsw_ef"):
                params["hnsw_ef"] = p.hnsw_ef
            if p.HasField("exact"):
                params["exact"] = p.exact
            if p.HasField("quantization"):
                q = p.quantization
                params["quantization"] = {
                    "ignore": q.ignore if q.HasField("ignore") else False,
                    "rescore": q.rescore if q.HasField("rescore") else True,
                    "oversampling": (
                        q.oversampling if q.HasField("oversampling") else None
                    ),
                }
            d["params"] = params
        hits = ex.query(QueryRequest(d))
        resp = M["SearchResponse"](time=0.0)
        for h in hits:
            sp = resp.result.add(
                id=py_to_point_id(h["id"]),
                score=float(h["score"]),
                version=h.get("version", 0),
            )
            for k, v in (h.get("payload") or {}).items():
                sp.payload[k].CopyFrom(py_to_value(v))
            if h.get("vector") is not None:
                vec = h["vector"]
                sp.vectors.CopyFrom(
                    py_to_vectors_output(vec if isinstance(vec, dict) and "indices" not in vec else {"": vec})
                )
        return resp

    def PointsScroll(self, request, context):
        coll = self.toc.get_collection(request.collection_name)
        from ..types import parse_filter

        limit = request.limit if request.HasField("limit") else 10
        offset = (
            normalize_point_id(point_id_to_py(request.offset))
            if request.HasField("offset")
            else None
        )
        flt = parse_filter(filter_to_dict(request.filter))
        ids = coll.scroll_ids(
            limit + 1, offset, flt, shard_key=shard_key_to_py(request)
        )
        next_offset = ids[limit] if len(ids) > limit else None
        ids = ids[:limit]
        with_payload = with_payload_to_py(request.with_payload)
        with_vectors = (
            with_vectors_to_py(request.with_vectors)
            if request.HasField("with_vectors")
            else False
        )
        from ..collection.query import _select_payload

        resp = M["ScrollResponse"](time=0.0)
        if next_offset is not None:
            resp.next_page_offset.CopyFrom(py_to_point_id(next_offset))
        for pid in ids:
            payload, vectors = coll.get_payload_and_vectors(pid)
            rp = resp.result.add(id=py_to_point_id(pid))
            p = _select_payload(payload, with_payload)
            if p:
                for k, v in p.items():
                    rp.payload[k].CopyFrom(py_to_value(v))
            if with_vectors and vectors:
                sel = (
                    {k: v for k, v in vectors.items() if k in with_vectors}
                    if isinstance(with_vectors, list)
                    else vectors
                )
                rp.vectors.CopyFrom(py_to_vectors_output(sel))
        return resp

    def _selector_to_op(self, sel) -> Dict[str, Any]:
        kind = sel.WhichOneof("points_selector_one_of")
        if kind == "points":
            return {"ids": [point_id_to_py(p) for p in sel.points.ids]}
        if kind == "filter":
            return {"filter": filter_to_dict(sel.filter)}
        return {"filter": None}

    def _op_response(self, res) -> Any:
        return M["PointsOperationResponse"](
            result=M["UpdateResult"](
                operation_id=res.get("operation_id", 0), status=2
            ),
            time=0.0,
        )

    def PointsSetPayload(self, request, context):
        coll = self.toc.get_collection(request.collection_name)
        op = {
            "type": "set_payload",
            "payload": {k: value_to_py(v) for k, v in request.payload.items()},
            "key": request.key if request.HasField("key") else None,
            **self._selector_to_op(request.points_selector),
        }
        return self._op_response(
            coll.update_op(op, shard_key=shard_key_to_py(request))
        )

    def PointsOverwritePayload(self, request, context):
        coll = self.toc.get_collection(request.collection_name)
        op = {
            "type": "overwrite_payload",
            "payload": {k: value_to_py(v) for k, v in request.payload.items()},
            **self._selector_to_op(request.points_selector),
        }
        return self._op_response(
            coll.update_op(op, shard_key=shard_key_to_py(request))
        )

    def PointsDeletePayload(self, request, context):
        coll = self.toc.get_collection(request.collection_name)
        op = {
            "type": "delete_payload",
            "keys": list(request.keys),
            **self._selector_to_op(request.points_selector),
        }
        return self._op_response(
            coll.update_op(op, shard_key=shard_key_to_py(request))
        )

    def PointsClearPayload(self, request, context):
        coll = self.toc.get_collection(request.collection_name)
        op = {"type": "clear_payload", **self._selector_to_op(request.points)}
        return self._op_response(
            coll.update_op(op, shard_key=shard_key_to_py(request))
        )

    def _vector_input_to_py(self, vi):
        kind = vi.WhichOneof("variant")
        if kind == "id":
            return point_id_to_py(vi.id)
        if kind == "dense":
            return list(vi.dense.data)
        if kind == "sparse":
            return {"indices": list(vi.sparse.indices), "values": list(vi.sparse.values)}
        if kind == "multi_dense":
            return [list(d.data) for d in vi.multi_dense.vectors]
        return None

    def _query_to_dict(self, q):
        kind = q.WhichOneof("variant")
        if kind == "nearest":
            return {"nearest": self._vector_input_to_py(q.nearest)}
        if kind == "recommend":
            strat = {0: "average_vector", 1: "best_score", 2: "best_score"}
            return {
                "recommend": {
                    "positive": [self._vector_input_to_py(v) for v in q.recommend.positive],
                    "negative": [self._vector_input_to_py(v) for v in q.recommend.negative],
                    "strategy": strat.get(
                        q.recommend.strategy if q.recommend.HasField("strategy") else 0,
                        "average_vector",
                    ),
                }
            }
        if kind == "discover":
            return {
                "discover": {
                    "target": self._vector_input_to_py(q.discover.target),
                    "context": [
                        {
                            "positive": self._vector_input_to_py(p.positive),
                            "negative": self._vector_input_to_py(p.negative),
                        }
                        for p in q.discover.context.pairs
                    ],
                }
            }
        if kind == "context":
            return {
                "context": [
                    {
                        "positive": self._vector_input_to_py(p.positive),
                        "negative": self._vector_input_to_py(p.negative),
                    }
                    for p in q.context.pairs
                ]
            }
        if kind == "order_by":
            return {
                "order_by": {
                    "key": q.order_by.key,
                    "direction": "desc"
                    if q.order_by.HasField("direction") and q.order_by.direction == 1
                    else "asc",
                }
            }
        if kind == "fusion":
            return {"fusion": "dbsf" if q.fusion == 1 else "rrf"}
        if kind == "sample":
            return {"sample": "random"}
        return None

    def _prefetch_to_dict(self, pf) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        if pf.prefetch:
            d["prefetch"] = [self._prefetch_to_dict(p) for p in pf.prefetch]
        if pf.HasField("query"):
            d["query"] = self._query_to_dict(pf.query)
        if pf.HasField("using"):
            d["using"] = pf.using
        if pf.HasField("filter"):
            d["filter"] = filter_to_dict(pf.filter)
        if pf.HasField("limit"):
            d["limit"] = pf.limit
        if pf.HasField("score_threshold"):
            d["score_threshold"] = pf.score_threshold
        return d

    def PointsQuery(self, request, context):
        coll = self.toc.get_collection(request.collection_name)
        ex = QueryExecutor(coll, self.toc)
        d: Dict[str, Any] = {
            "using": request.using if request.HasField("using") else "",
            "filter": filter_to_dict(request.filter)
            if request.HasField("filter")
            else None,
            "limit": request.limit if request.HasField("limit") else 10,
            "offset": request.offset if request.HasField("offset") else 0,
            "with_payload": with_payload_to_py(request.with_payload)
            if request.HasField("with_payload")
            else False,
            "with_vector": with_vectors_to_py(request.with_vectors)
            if request.HasField("with_vectors")
            else False,
            "score_threshold": request.score_threshold
            if request.HasField("score_threshold")
            else None,
            "shard_key": shard_key_to_py(request),
        }
        if request.prefetch:
            d["prefetch"] = [self._prefetch_to_dict(p) for p in request.prefetch]
        if request.HasField("query"):
            d["query"] = self._query_to_dict(request.query)
        hits = ex.query(QueryRequest(d))
        resp = M["QueryResponse"](time=0.0)
        for h in hits:
            sp = resp.result.add(
                id=py_to_point_id(h["id"]),
                score=float(h["score"]),
                version=h.get("version", 0),
            )
            for k, v in (h.get("payload") or {}).items():
                sp.payload[k].CopyFrom(py_to_value(v))
        return resp

    def PointsRecommend(self, request, context):
        coll = self.toc.get_collection(request.collection_name)
        ex = QueryExecutor(coll, self.toc)
        strat = {0: "average_vector", 1: "best_score", 2: "best_score"}
        positives = [point_id_to_py(p) for p in request.positive] + [
            vector_to_py(v) for v in request.positive_vectors
        ]
        negatives = [point_id_to_py(p) for p in request.negative] + [
            vector_to_py(v) for v in request.negative_vectors
        ]
        d = {
            "query": {
                "recommend": {
                    "positive": positives,
                    "negative": negatives,
                    "strategy": strat.get(
                        request.strategy if request.HasField("strategy") else 0,
                        "average_vector",
                    ),
                }
            },
            "using": request.using if request.HasField("using") else "",
            "filter": filter_to_dict(request.filter),
            "limit": request.limit or 10,
            "offset": request.offset if request.HasField("offset") else 0,
            "with_payload": with_payload_to_py(request.with_payload),
            "score_threshold": (
                request.score_threshold
                if request.HasField("score_threshold")
                else None
            ),
            "shard_key": shard_key_to_py(request),
        }
        hits = ex.query(QueryRequest(d))
        resp = M["RecommendResponse"](time=0.0)
        for h in hits:
            sp = resp.result.add(
                id=py_to_point_id(h["id"]),
                score=float(h["score"]),
                version=h.get("version", 0),
            )
            for k, v in (h.get("payload") or {}).items():
                sp.payload[k].CopyFrom(py_to_value(v))
        return resp

    def PointsSearchBatch(self, request, context):
        resp = M["SearchBatchResponse"](time=0.0)
        for sub in request.search_points:
            if not sub.collection_name:
                sub.collection_name = request.collection_name
            single = self.PointsSearch(sub, context)
            batch = resp.result.add()
            batch.result.extend(single.result)
        return resp

    def PointsQueryBatch(self, request, context):
        resp = M["QueryBatchResponse"](time=0.0)
        for sub in request.query_points:
            if not sub.collection_name:
                sub.collection_name = request.collection_name
            single = self.PointsQuery(sub, context)
            batch = resp.result.add()
            batch.result.extend(single.result)
        return resp

    # -- discover / batch recommend (reference: points_service.proto:65-111) --

    def _example_to_py(self, ex):
        if ex.HasField("id"):
            return point_id_to_py(ex.id)
        return vector_to_py(ex.vector)

    def _fill_scored(self, container, hits):
        for h in hits:
            sp = container.add(
                id=py_to_point_id(h["id"]),
                score=float(h.get("score", 0.0)),
                version=h.get("version", 0),
            )
            for k, v in (h.get("payload") or {}).items():
                sp.payload[k].CopyFrom(py_to_value(v))

    def _discover_body(self, request) -> Dict[str, Any]:
        body: Dict[str, Any] = {
            "context": [
                {
                    "positive": self._example_to_py(p.positive),
                    "negative": self._example_to_py(p.negative),
                }
                for p in request.context
            ],
            "limit": request.limit or 10,
            "offset": request.offset if request.HasField("offset") else 0,
            "using": request.using if request.HasField("using") else "",
            "filter": filter_to_dict(request.filter),
            "with_payload": with_payload_to_py(request.with_payload),
            "shard_key": shard_key_to_py(request),
        }
        if request.HasField("target") and request.target.HasField("single"):
            body["target"] = self._example_to_py(request.target.single)
        return body

    def PointsDiscover(self, request, context):
        from .rest import h_discover

        hits = h_discover(
            self.toc, {"name": request.collection_name}, self._discover_body(request), {}
        )
        resp = M["DiscoverResponse"](time=0.0)
        self._fill_scored(resp.result, hits)
        return resp

    def PointsDiscoverBatch(self, request, context):
        resp = M["DiscoverBatchResponse"](time=0.0)
        for sub in request.discover_points:
            if not sub.collection_name:
                sub.collection_name = request.collection_name
            single = self.PointsDiscover(sub, context)
            resp.result.add().result.extend(single.result)
        return resp

    def PointsRecommendBatch(self, request, context):
        resp = M["RecommendBatchResponse"](time=0.0)
        for sub in request.recommend_points:
            if not sub.collection_name:
                sub.collection_name = request.collection_name
            single = self.PointsRecommend(sub, context)
            resp.result.add().result.extend(single.result)
        return resp

    # -- groups (reference: points_service.proto:56-58, 79-81, 128-130) --

    def _fill_groups(self, resp, groups):
        res = resp.result
        for g in groups:
            pg = res.groups.add()
            gid = g.get("id")
            if isinstance(gid, bool):
                pg.id.string_value = str(gid).lower()
            elif isinstance(gid, int):
                if gid >= 0:
                    pg.id.unsigned_value = gid
                else:
                    pg.id.integer_value = gid
            else:
                pg.id.string_value = str(gid)
            self._fill_scored(pg.hits, g.get("hits") or [])
            lk = g.get("lookup")
            if lk is not None:
                pg.lookup.id.CopyFrom(py_to_point_id(lk["id"]))
                for k, v in (lk.get("payload") or {}).items():
                    pg.lookup.payload[k].CopyFrom(py_to_value(v))
                if lk.get("vector") is not None:
                    vec = lk["vector"]
                    pg.lookup.vectors.CopyFrom(
                        py_to_vectors_output(
                            vec
                            if isinstance(vec, dict) and "indices" not in vec
                            else {"": vec}
                        )
                    )
        return resp

    def PointsSearchGroups(self, request, context):
        from .rest import h_search_groups

        body = {
            "vector": (
                {"name": request.vector_name, "vector": list(request.vector)}
                if request.HasField("vector_name")
                else list(request.vector)
            ),
            "filter": filter_to_dict(request.filter),
            "limit": request.limit or 3,
            "group_by": request.group_by,
            "group_size": request.group_size or 3,
            "with_payload": with_payload_to_py(request.with_payload),
            "score_threshold": (
                request.score_threshold
                if request.HasField("score_threshold")
                else None
            ),
            "with_lookup": with_lookup_to_py(request),
            "shard_key": shard_key_to_py(request),
        }
        out = h_search_groups(self.toc, {"name": request.collection_name}, body, {})
        return self._fill_groups(M["SearchGroupsResponse"](time=0.0), out["groups"])

    def PointsRecommendGroups(self, request, context):
        from .rest import h_recommend_groups

        body = {
            "positive": [point_id_to_py(p) for p in request.positive]
            + [vector_to_py(v) for v in request.positive_vectors],
            "negative": [point_id_to_py(p) for p in request.negative]
            + [vector_to_py(v) for v in request.negative_vectors],
            "filter": filter_to_dict(request.filter),
            "limit": request.limit or 3,
            "using": request.using if request.HasField("using") else "",
            "group_by": request.group_by,
            "group_size": request.group_size or 3,
            "with_payload": with_payload_to_py(request.with_payload),
            "with_lookup": with_lookup_to_py(request),
            "shard_key": shard_key_to_py(request),
        }
        out = h_recommend_groups(self.toc, {"name": request.collection_name}, body, {})
        return self._fill_groups(M["RecommendGroupsResponse"](time=0.0), out["groups"])

    def PointsQueryGroups(self, request, context):
        from ..collection.query import QueryExecutor, QueryRequest

        coll = self.toc.get_collection(request.collection_name)
        d: Dict[str, Any] = {
            "using": request.using if request.HasField("using") else "",
            "filter": filter_to_dict(request.filter)
            if request.HasField("filter")
            else None,
            "limit": request.limit if request.HasField("limit") else 3,
            "group_by": request.group_by,
            "group_size": request.group_size if request.HasField("group_size") else 3,
            "with_payload": with_payload_to_py(request.with_payload)
            if request.HasField("with_payload")
            else False,
            "with_lookup": with_lookup_to_py(request),
            "shard_key": shard_key_to_py(request),
        }
        if request.HasField("lookup_from"):
            lf = request.lookup_from
            d["lookup_from"] = {
                "collection": lf.collection_name,
                "vector": lf.vector_name if lf.HasField("vector_name") else None,
            }
        if request.prefetch:
            d["prefetch"] = [self._prefetch_to_dict(p) for p in request.prefetch]
        if request.HasField("query"):
            d["query"] = self._query_to_dict(request.query)
        groups = QueryExecutor(coll, self.toc).query_groups(QueryRequest(d))
        return self._fill_groups(M["QueryGroupsResponse"](time=0.0), groups)

    # -- facets + distance matrix (reference: points_service.proto:132-138) --

    def PointsFacet(self, request, context):
        from .rest import h_facet

        body = {
            "key": request.key,
            "limit": request.limit if request.HasField("limit") else 10,
            "filter": filter_to_dict(request.filter)
            if request.HasField("filter")
            else None,
        }
        body["shard_key"] = shard_key_to_py(request)
        out = h_facet(self.toc, {"name": request.collection_name}, body, {})
        resp = M["FacetResponse"](time=0.0)
        for hit in out["hits"]:
            fh = resp.hits.add(count=hit["count"])
            val = hit["value"]
            if isinstance(val, bool):
                fh.value.bool_value = val
            elif isinstance(val, int):
                fh.value.integer_value = val
            else:
                fh.value.string_value = str(val)
        return resp

    def _matrix_body(self, request) -> Dict[str, Any]:
        return {
            "sample": request.sample if request.HasField("sample") else 10,
            "limit": request.limit if request.HasField("limit") else 3,
            "using": request.using if request.HasField("using") else "",
            "filter": filter_to_dict(request.filter)
            if request.HasField("filter")
            else None,
            "shard_key": shard_key_to_py(request),
        }

    def PointsSearchMatrixPairs(self, request, context):
        from .rest import h_matrix_pairs

        out = h_matrix_pairs(
            self.toc, {"name": request.collection_name}, self._matrix_body(request), {}
        )
        resp = M["SearchMatrixPairsResponse"](time=0.0)
        for pair in out["pairs"]:
            resp.result.pairs.add(
                a=py_to_point_id(pair["a"]),
                b=py_to_point_id(pair["b"]),
                score=pair["score"],
            )
        return resp

    def PointsSearchMatrixOffsets(self, request, context):
        from .rest import h_matrix_offsets

        out = h_matrix_offsets(
            self.toc, {"name": request.collection_name}, self._matrix_body(request), {}
        )
        resp = M["SearchMatrixOffsetsResponse"](time=0.0)
        resp.result.offsets_row.extend(out["offsets_row"])
        resp.result.offsets_col.extend(out["offsets_col"])
        resp.result.scores.extend(out["scores"])
        for pid in out["ids"]:
            resp.result.ids.add().CopyFrom(py_to_point_id(pid))
        return resp

    # -- batch update (reference: points_service.proto:116) --

    def PointsUpdateBatch(self, request, context):
        resp = M["UpdateBatchResponse"](time=0.0)
        coll_name = request.collection_name
        for op in request.operations:
            which = op.WhichOneof("operation")
            sub_resp = None
            if which == "upsert":
                req = M["UpsertPoints"](collection_name=coll_name)
                req.points.extend(op.upsert.points)
                sub_resp = self.PointsUpsert(req, context)
            elif which in ("delete_deprecated", "delete_points"):
                sel = op.delete_deprecated if which == "delete_deprecated" else op.delete_points.points
                req = M["DeletePoints"](collection_name=coll_name)
                req.points.CopyFrom(sel)
                sub_resp = self.PointsDelete(req, context)
            elif which in ("set_payload", "overwrite_payload"):
                sub = getattr(op, which)
                req = M["SetPayloadPoints"](collection_name=coll_name)
                for k, v in sub.payload.items():
                    req.payload[k].CopyFrom(v)
                if sub.HasField("points_selector"):
                    req.points_selector.CopyFrom(sub.points_selector)
                sub_resp = (
                    self.PointsSetPayload(req, context)
                    if which == "set_payload"
                    else self.PointsOverwritePayload(req, context)
                )
            elif which == "delete_payload":
                req = M["DeletePayloadPoints"](collection_name=coll_name)
                req.keys.extend(op.delete_payload.keys)
                if op.delete_payload.HasField("points_selector"):
                    req.points_selector.CopyFrom(op.delete_payload.points_selector)
                sub_resp = self.PointsDeletePayload(req, context)
            elif which in ("clear_payload", "clear_payload_deprecated"):
                sel = (
                    op.clear_payload.points
                    if which == "clear_payload"
                    else op.clear_payload_deprecated
                )
                req = M["ClearPayloadPoints"](collection_name=coll_name)
                req.points.CopyFrom(sel)
                sub_resp = self.PointsClearPayload(req, context)
            elif which == "update_vectors":
                req = M["UpdatePointVectors"](collection_name=coll_name)
                req.points.extend(op.update_vectors.points)
                sub_resp = self.PointsUpdateVectors(req, context)
            elif which == "delete_vectors":
                req = M["DeletePointVectors"](collection_name=coll_name)
                req.points_selector.CopyFrom(op.delete_vectors.points_selector)
                req.vectors.CopyFrom(op.delete_vectors.vectors)
                sub_resp = self.PointsDeleteVectors(req, context)
            if sub_resp is not None:
                resp.result.add().CopyFrom(sub_resp.result)
        return resp

    def PointsCount(self, request, context):
        coll = self.toc.get_collection(request.collection_name)
        from ..types import parse_filter

        count = coll.count(
            parse_filter(filter_to_dict(request.filter)),
            shard_key=shard_key_to_py(request),
        )
        return M["CountResponse"](result=M["CountResult"](count=count), time=0.0)


class _SnapshotServices:
    def __init__(self, toc: TableOfContent):
        self.toc = toc

    def _describe(self, d: dict):
        return M["SnapshotDescription"](name=d["name"], size=d["size"])

    def Create(self, request, context):
        d = self.toc.create_snapshot(request.collection_name)
        return M["CreateSnapshotResponse"](
            snapshot_description=self._describe(d), time=0.0
        )

    def List(self, request, context):
        resp = M["ListSnapshotsResponse"](time=0.0)
        for d in self.toc.list_snapshots(request.collection_name):
            resp.snapshot_descriptions.append(self._describe(d))
        return resp

    def Delete(self, request, context):
        self.toc.delete_snapshot(request.collection_name, request.snapshot_name)
        return M["DeleteSnapshotResponse"](time=0.0)

    def CreateFull(self, request, context):
        d = self.toc.create_full_snapshot()
        return M["CreateSnapshotResponse"](
            snapshot_description=self._describe(d), time=0.0
        )

    def ListFull(self, request, context):
        resp = M["ListSnapshotsResponse"](time=0.0)
        for d in self.toc.list_full_snapshots():
            resp.snapshot_descriptions.append(self._describe(d))
        return resp


class _ShardSnapshotServices:
    """qdrant.ShardSnapshots (reference: src/tonic/mod.rs:138-338,
    lib/api .../shard_snapshots_service.proto)."""

    def __init__(self, toc: TableOfContent):
        self.toc = toc

    def _describe(self, d: dict):
        return M["SnapshotDescription"](name=d["name"], size=d["size"])

    def Create(self, request, context):
        d = self.toc.create_shard_snapshot(
            request.collection_name, request.shard_id
        )
        return M["CreateSnapshotResponse"](
            snapshot_description=self._describe(d), time=0.0
        )

    def List(self, request, context):
        resp = M["ListSnapshotsResponse"](time=0.0)
        for d in self.toc.list_shard_snapshots(
            request.collection_name, request.shard_id
        ):
            resp.snapshot_descriptions.append(self._describe(d))
        return resp

    def Delete(self, request, context):
        self.toc.delete_shard_snapshot(
            request.collection_name, request.shard_id, request.snapshot_name
        )
        return M["DeleteSnapshotResponse"](time=0.0)

    def Recover(self, request, context):
        loc = request.snapshot_location
        location = loc.url or loc.path
        self.toc.recover_shard_snapshot(
            request.collection_name,
            request.shard_id,
            location,
            checksum=request.checksum or None,
        )
        return M["RecoverSnapshotResponse"](time=0.0)


# access level per RPC ("read" default): mirrors ACCESS_LEVELS in rest.py
# and the reference's tonic RBAC checks (lib/storage/src/rbac/ops_checks.rs).
GRPC_ACCESS_LEVELS = {
    "Create": "manage",
    "Delete": "manage",  # Collections.Delete; Points.Delete overridden below
    "Update": "manage",
    "UpdateAliases": "manage",
    "CreateShardKey": "manage",
    "DeleteShardKey": "manage",
    "CreateFull": "manage",
    "ListFull": "manage",
}
GRPC_POINTS_ACCESS = {
    "Upsert": "write",
    "Delete": "write",
    "UpdateVectors": "write",
    "DeleteVectors": "write",
    "SetPayload": "write",
    "OverwritePayload": "write",
    "DeletePayload": "write",
    "ClearPayload": "write",
    "UpdateBatch": "write",
    "CreateFieldIndex": "write",
    "DeleteFieldIndex": "write",
}
GRPC_SNAPSHOT_ACCESS = {
    "Create": "write",
    "Delete": "write",
    "CreateFull": "manage",
    "ListFull": "manage",
}


GRPC_SHARD_SNAPSHOT_ACCESS = {
    "Create": "write",
    "Delete": "write",
    "Recover": "manage",
}


def _method_access_level(service_name: str, method: str) -> str:
    if service_name == "qdrant.Points":
        return GRPC_POINTS_ACCESS.get(method, "read")
    if service_name == "qdrant.Snapshots":
        return GRPC_SNAPSHOT_ACCESS.get(method, "read")
    if service_name == "qdrant.ShardSnapshots":
        return GRPC_SHARD_SNAPSHOT_ACCESS.get(method, "read")
    if service_name == "qdrant.Collections":
        return GRPC_ACCESS_LEVELS.get(method, "read")
    return "read"


def _wrap(fn, req_cls, toc=None, authenticator=None, level="read"):
    def handler(request, context):
        if authenticator is not None and authenticator.enabled:
            from .auth import AuthError

            meta = {k: v for k, v in (context.invocation_metadata() or [])}
            headers = {
                "api-key": meta.get("api-key"),
                "Authorization": meta.get("authorization"),
            }
            try:
                access = authenticator.authenticate(headers)
            except AuthError as e:
                context.abort(grpc.StatusCode.UNAUTHENTICATED, str(e))
            try:
                if level == "manage":
                    access.check_manage()
                else:
                    cname = getattr(request, "collection_name", "") or None
                    if cname is not None and toc is not None:
                        access.check_collection(
                            toc.resolve_name(cname), write=(level == "write")
                        )
                    elif level == "write" and not access.write:
                        raise AuthError("write access denied")
            except AuthError as e:
                context.abort(grpc.StatusCode.PERMISSION_DENIED, str(e))
        try:
            return fn(request, context)
        except Exception as e:  # engine errors → gRPC status
            from ..collection.collection import NotFoundError

            code = (
                grpc.StatusCode.NOT_FOUND
                if isinstance(e, NotFoundError)
                else grpc.StatusCode.INVALID_ARGUMENT
            )
            context.abort(code, str(e))

    return grpc.unary_unary_rpc_method_handler(
        handler,
        request_deserializer=req_cls.FromString,
        response_serializer=lambda msg: msg.SerializeToString(),
    )


class _AuthInterceptor(grpc.ServerInterceptor):
    """api-key metadata check (reference: gRPC api-key interceptor in
    src/tonic). JWTs ride the same header, validated by api/auth.py."""

    def __init__(self, api_key: Optional[str], read_only_api_key: Optional[str]):
        from .auth import Authenticator

        self.auth = Authenticator(api_key, read_only_api_key)

        def deny(request, context):
            context.abort(grpc.StatusCode.UNAUTHENTICATED, "Invalid API key")

        self._deny = grpc.unary_unary_rpc_method_handler(deny)

    def intercept_service(self, continuation, handler_call_details):
        if not self.auth.enabled:
            return continuation(handler_call_details)
        meta = {k: v for k, v in (handler_call_details.invocation_metadata or [])}
        headers = {
            "api-key": meta.get("api-key"),
            "Authorization": meta.get("authorization"),
        }
        from .auth import AuthError

        try:
            self.auth.authenticate(headers)
        except AuthError:
            return self._deny
        return continuation(handler_call_details)


def make_server(
    toc: TableOfContent,
    host: str = "127.0.0.1",
    port: int = 6334,
    max_workers: int = 8,
    api_key: Optional[str] = None,
    read_only_api_key: Optional[str] = None,
):
    svc = _Services(toc)
    snap = _SnapshotServices(toc)
    shard_snap = _ShardSnapshotServices(toc)
    services = {
        "qdrant.Snapshots": {
            "Create": (snap.Create, M["CreateSnapshotRequest"]),
            "List": (snap.List, M["ListSnapshotsRequest"]),
            "Delete": (snap.Delete, M["DeleteSnapshotRequest"]),
            "CreateFull": (snap.CreateFull, M["CreateFullSnapshotRequest"]),
            "ListFull": (snap.ListFull, M["ListFullSnapshotsRequest"]),
        },
        "qdrant.ShardSnapshots": {
            "Create": (shard_snap.Create, M["CreateShardSnapshotRequest"]),
            "List": (shard_snap.List, M["ListShardSnapshotsRequest"]),
            "Delete": (shard_snap.Delete, M["DeleteShardSnapshotRequest"]),
            "Recover": (shard_snap.Recover, M["RecoverShardSnapshotRequest"]),
        },
        "qdrant.Qdrant": {
            "HealthCheck": (svc.HealthCheck, M["HealthCheckRequest"]),
        },
        "qdrant.Collections": {
            "Get": (svc.CollectionsGet, M["GetCollectionInfoRequest"]),
            "List": (svc.CollectionsList, M["ListCollectionsRequest"]),
            "Create": (svc.CollectionsCreate, M["CreateCollection"]),
            "Delete": (svc.CollectionsDelete, M["DeleteCollection"]),
            "CollectionExists": (svc.CollectionsExists, M["CollectionExistsRequest"]),
            "Update": (svc.CollectionsUpdate, M["UpdateCollection"]),
            "UpdateAliases": (svc.CollectionsUpdateAliases, M["ChangeAliases"]),
            "CreateShardKey": (
                svc.CollectionsCreateShardKey,
                M["CreateShardKeyRequest"],
            ),
            "DeleteShardKey": (
                svc.CollectionsDeleteShardKey,
                M["DeleteShardKeyRequest"],
            ),
            "ListAliases": (svc.CollectionsListAliases, M["ListAliasesRequest"]),
            "ListCollectionAliases": (
                svc.CollectionsListCollectionAliases,
                M["ListCollectionAliasesRequest"],
            ),
        },
        "qdrant.Points": {
            "Upsert": (svc.PointsUpsert, M["UpsertPoints"]),
            "Delete": (svc.PointsDelete, M["DeletePoints"]),
            "UpdateVectors": (svc.PointsUpdateVectors, M["UpdatePointVectors"]),
            "DeleteVectors": (svc.PointsDeleteVectors, M["DeletePointVectors"]),
            "Get": (svc.PointsGet, M["GetPoints"]),
            "Search": (svc.PointsSearch, M["SearchPoints"]),
            "Count": (svc.PointsCount, M["CountPoints"]),
            "Scroll": (svc.PointsScroll, M["ScrollPoints"]),
            "Query": (svc.PointsQuery, M["QueryPoints"]),
            "SearchBatch": (svc.PointsSearchBatch, M["SearchBatchPoints"]),
            "Recommend": (svc.PointsRecommend, M["RecommendPoints"]),
            "CreateFieldIndex": (svc.PointsCreateFieldIndex, M["CreateFieldIndexCollection"]),
            "DeleteFieldIndex": (svc.PointsDeleteFieldIndex, M["DeleteFieldIndexCollection"]),
            "QueryBatch": (svc.PointsQueryBatch, M["QueryBatchPoints"]),
            "SetPayload": (svc.PointsSetPayload, M["SetPayloadPoints"]),
            "OverwritePayload": (svc.PointsOverwritePayload, M["SetPayloadPoints"]),
            "DeletePayload": (svc.PointsDeletePayload, M["DeletePayloadPoints"]),
            "ClearPayload": (svc.PointsClearPayload, M["ClearPayloadPoints"]),
            "Discover": (svc.PointsDiscover, M["DiscoverPoints"]),
            "DiscoverBatch": (svc.PointsDiscoverBatch, M["DiscoverBatchPoints"]),
            "RecommendBatch": (svc.PointsRecommendBatch, M["RecommendBatchPoints"]),
            "SearchGroups": (svc.PointsSearchGroups, M["SearchPointGroups"]),
            "RecommendGroups": (svc.PointsRecommendGroups, M["RecommendPointGroups"]),
            "QueryGroups": (svc.PointsQueryGroups, M["QueryPointGroups"]),
            "Facet": (svc.PointsFacet, M["FacetCounts"]),
            "SearchMatrixPairs": (svc.PointsSearchMatrixPairs, M["SearchMatrixPoints"]),
            "SearchMatrixOffsets": (
                svc.PointsSearchMatrixOffsets,
                M["SearchMatrixPoints"],
            ),
            "UpdateBatch": (svc.PointsUpdateBatch, M["UpdateBatchPoints"]),
        },
    }
    interceptors = []
    authenticator = None
    if api_key or read_only_api_key:
        from .auth import Authenticator

        interceptors.append(_AuthInterceptor(api_key, read_only_api_key))
        authenticator = Authenticator(api_key, read_only_api_key)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        interceptors=interceptors,
    )
    for service_name, methods in services.items():
        handlers = {
            name: _wrap(
                fn,
                req_cls,
                toc=toc,
                authenticator=authenticator,
                level=_method_access_level(service_name, name),
            )
            for name, (fn, req_cls) in methods.items()
        }
        server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(service_name, handlers),)
        )
    bound = server.add_insecure_port(f"{host}:{port}")
    return server, bound
