"""Universal Query API planner + executor.

Reference: lib/shard/src/query/planned_query.rs:17 (prefetch tree flattened
into leaf searches + recursive merge), lib/collection/src/collection/query.rs
(fusion RRF/DBSF, MMR rescore, recommend/discover/context scorers in
lib/segment/src/vector_storage/query/).

Execution model: prefetches run first (recursively); the root query either
fuses prefetch rankings (rrf/dbsf), rescores the candidate union against a
vector query, applies a formula, or orders by a payload field. Multi-target
queries (recommend best_score, discover, context) gather oversampled
candidates per target on-device, then aggregate exactly on host.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..storage.segment import SearchParams
from ..types import (
    Distance,
    Filter,
    HasIdCondition,
    PointId,
    SparseVector,
    normalize_point_id,
    parse_filter,
    DEFAULT_VECTOR_NAME,
)
from ..utils import json_path

RRF_K = 60  # reference's rrf constant
CONTEXT_ZONE_SCALE = 1e6  # discover: rank context-zone count above target score


class QueryError(Exception):
    status_code = 400


# ---------------------------------------------------------------------------
# numpy scoring helpers (small candidate sets — host math is exact & cheap)
# ---------------------------------------------------------------------------


def score_np(query: np.ndarray, vectors: np.ndarray, distance: Distance) -> np.ndarray:
    q = np.asarray(query, dtype=np.float32)
    v = np.asarray(vectors, dtype=np.float32)
    if distance is Distance.COSINE:
        qn = q / max(np.linalg.norm(q), 1e-12)
        vn = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
        return vn @ qn
    if distance is Distance.DOT:
        return v @ q
    if distance is Distance.EUCLID:
        return -((v - q[None, :]) ** 2).sum(axis=1)
    return -np.abs(v - q[None, :]).sum(axis=1)


def sparse_score_np(query: SparseVector, vec: SparseVector) -> float:
    qmap = dict(zip(query.indices, query.values))
    return float(sum(w * qmap.get(d, 0.0) for d, w in zip(vec.indices, vec.values)))


# ---------------------------------------------------------------------------
# query request model
# ---------------------------------------------------------------------------


class QueryRequest:
    def __init__(self, d: Dict[str, Any], default_limit: int = 10):
        self.prefetch = [QueryRequest(p) for p in _as_list(d.get("prefetch"))]
        self.query = d.get("query")
        self.using = d.get("using") or DEFAULT_VECTOR_NAME
        self.filter = parse_filter(d.get("filter"))
        self.params = SearchParams.from_dict(d.get("params"))
        self.score_threshold = d.get("score_threshold")
        self.limit = int(d.get("limit", default_limit))
        self.offset = int(d.get("offset", 0))
        self.with_payload = d.get("with_payload", False)
        self.with_vector = d.get("with_vector", False)
        self.lookup_from = d.get("lookup_from")
        self.group_by = d.get("group_by")
        self.group_size = int(d.get("group_size", 3))
        self.shard_key = d.get("shard_key")
        # group-by lookup join (reference: WithLookup, points.proto:576-583 —
        # fetch the record whose id equals the group id from another
        # collection); a bare string is shorthand for {"collection": name}
        wl = d.get("with_lookup")
        self.with_lookup = {"collection": wl} if isinstance(wl, str) else wl


def _as_list(x) -> List[Any]:
    if x is None:
        return []
    return x if isinstance(x, list) else [x]


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------


class QueryExecutor:
    def __init__(self, collection, toc=None):
        self.collection = collection
        self.toc = toc  # for lookup_from other collections

    # -- vector resolution ---------------------------------------------------

    def _lookup_collection(self, req: QueryRequest):
        if req.lookup_from and self.toc is not None:
            name = (
                req.lookup_from.get("collection")
                if isinstance(req.lookup_from, dict)
                else req.lookup_from
            )
            return self.toc.get_collection(name)
        return self.collection

    def _resolve_vector(self, ref: Any, using: str, req: QueryRequest) -> Any:
        """A query element: literal vector (dense/sparse/multi), a Document
        ({"text": ...} → server-side BM25 embedding), or a point id."""
        if isinstance(ref, dict) and "indices" in ref:
            return SparseVector.from_dict(ref)
        if isinstance(ref, dict) and (
            "text" in ref or "image" in ref or "object" in ref
        ):
            from ..utils.inference import embed_value

            out = embed_value(ref, inference="search")
            if isinstance(out, list):
                return np.asarray(out, dtype=np.float32)
            return out
        if isinstance(ref, SparseVector):
            return ref
        if isinstance(ref, list):
            return np.asarray(ref, dtype=np.float32)
        # point id reference
        pid = normalize_point_id(ref)
        lookup_using = using
        if req.lookup_from and isinstance(req.lookup_from, dict):
            lookup_using = req.lookup_from.get("vector", using)
        coll = self._lookup_collection(req)
        vec = coll.get_point_vector(pid, lookup_using)
        if vec is None:
            raise QueryError(f"point {ref!r} has no vector {lookup_using!r}")
        if isinstance(vec, dict) and "indices" in vec:
            return SparseVector.from_dict(vec)
        return np.asarray(vec, dtype=np.float32)

    @staticmethod
    def _ids_from_ref(ref: Any) -> List[PointId]:
        """Point-id from a SINGLE vector reference position (scalar = id;
        a list is a vector literal, a dict is a sparse vector — no ids)."""
        if isinstance(ref, bool) or not isinstance(ref, (int, str)):
            return []
        try:
            return [normalize_point_id(ref)]
        except ValueError:
            return []

    @classmethod
    def _ids_from_ref_list(cls, refs: Any) -> List[PointId]:
        """Ids from a LIST of references (recommend positive/negative):
        scalar elements are ids; list/dict elements are vector literals."""
        out: List[PointId] = []
        for r in _as_list(refs):
            out.extend(cls._ids_from_ref(r))
        return out

    def _exclude_ids(self, query_dict: Any) -> List[PointId]:
        """Point-id references used in the query are excluded from results
        (reference recommend semantics). Only reference POSITIONS are
        inspected — numeric components of vector literals are never ids."""
        out: List[PointId] = []
        q = query_dict
        out.extend(self._ids_from_ref(q))
        if isinstance(q, dict):
            if "nearest" in q:
                out.extend(self._ids_from_ref(q["nearest"]))
            if "target" in q:
                out.extend(self._ids_from_ref(q["target"]))
            for key in ("positive", "negative"):
                if key in q:
                    out.extend(self._ids_from_ref_list(q[key]))
            for pair in _as_list(q.get("context")):
                if isinstance(pair, dict):
                    out.extend(self._ids_from_ref(pair.get("positive")))
                    out.extend(self._ids_from_ref(pair.get("negative")))
            for key in ("recommend", "discover"):
                if isinstance(q.get(key), dict):
                    out.extend(self._exclude_ids(q[key]))
        return out

    # -- main entry ----------------------------------------------------------

    def query(self, req: QueryRequest) -> List[Dict[str, Any]]:
        items = self._execute(req, req.limit + req.offset)
        items = items[req.offset :]
        return self._hydrate(items, req)

    def query_groups(self, req: QueryRequest) -> List[Dict[str, Any]]:
        """Grouped query (reference: group_by with per-group top hits)."""
        if not req.group_by:
            raise QueryError("group_by required")
        raw = self._execute(req, max((req.limit * req.group_size) * 4, 128))
        groups: Dict[Any, List[Tuple[float, PointId]]] = {}
        order: List[Any] = []
        for score, pid in raw:
            payload, _ = self.collection.get_payload_and_vectors(pid)
            values = json_path.get_leaf_values(payload or {}, req.group_by)
            for gid in values:
                if not isinstance(gid, (str, int, bool)):
                    continue
                if gid not in groups:
                    groups[gid] = []
                    order.append(gid)
                if len(groups[gid]) < req.group_size:
                    groups[gid].append((score, pid))
        out = []
        for gid in order[: req.limit]:
            hits = self._hydrate(groups[gid], req)
            entry = {"id": gid, "hits": hits}
            lookup = self._group_lookup(gid, req)
            if lookup is not None:
                entry["lookup"] = lookup
            out.append(entry)
        return out

    def _group_lookup(self, gid, req: QueryRequest) -> Optional[Dict[str, Any]]:
        """WithLookup join: the group id doubles as a point id in another
        collection; return its selected payload/vectors (reference:
        lib/collection/src/grouping/group_by.rs lookup step)."""
        if not req.with_lookup or self.toc is None:
            return None
        name = req.with_lookup.get("collection")
        if not name:
            return None
        # unknown lookup collection must surface to the client (reference
        # errors on a bad with_lookup name); only a missing point — a group
        # id with no record in the lookup collection — yields a group
        # without lookup data
        coll = self.toc.get_collection(self.toc.resolve_name(name))
        try:
            pid = normalize_point_id(gid)
        except (ValueError, TypeError):
            return None
        try:
            payload, vectors = coll.get_payload_and_vectors(pid)
        except KeyError:
            return None
        if payload is None and vectors is None:
            return None
        entry: Dict[str, Any] = {"id": gid}
        p = _select_payload(payload, req.with_lookup.get("with_payload", True))
        if p is not None:
            entry["payload"] = p
        v = _select_vectors(vectors, req.with_lookup.get("with_vectors", False))
        if v is not None:
            entry["vector"] = v
        return entry

    # -- recursive execution --------------------------------------------------

    def _execute(self, req: QueryRequest, limit: int) -> List[Tuple[float, PointId]]:
        if req.prefetch:
            sources = [self._execute(p, max(p.limit, 1)) for p in req.prefetch]
            return self._merge_root(req, sources, limit)
        return self._leaf(req, limit)

    def _merge_root(
        self,
        req: QueryRequest,
        sources: List[List[Tuple[float, PointId]]],
        limit: int,
    ) -> List[Tuple[float, PointId]]:
        q = req.query
        if isinstance(q, dict) and "fusion" in q:
            mode = q["fusion"]
            if mode == "rrf":
                return _rrf(sources, limit)
            if mode == "dbsf":
                return _dbsf(sources, limit)
            raise QueryError(f"unknown fusion {mode!r}")
        if isinstance(q, dict) and ("formula" in q or "expression" in q):
            expr = q.get("formula", q.get("expression"))
            defaults = q.get("defaults") or {}
            return self.formula_rescore(expr, defaults, sources, req, limit)
        # candidate union, rescored by the root query
        candidates: List[PointId] = []
        seen = set()
        for src in sources:
            for _, pid in src:
                if pid not in seen:
                    seen.add(pid)
                    candidates.append(pid)
        if not candidates:
            return []
        if q is None:
            # no root query: keep best source score per point
            best: Dict[PointId, float] = {}
            for src in sources:
                for s, pid in src:
                    if pid not in best or s > best[pid]:
                        best[pid] = s
            items = sorted(best.items(), key=lambda t: -t[1])
            return [(s, p) for p, s in items][:limit]
        id_filter = Filter(must=[HasIdCondition(candidates)])
        merged = Filter.merge(req.filter, id_filter)
        sub = _clone_with_filter(req, merged)
        return self._leaf(sub, limit, candidate_pool=len(candidates))

    # -- leaf queries ---------------------------------------------------------

    def _leaf(
        self, req: QueryRequest, limit: int, candidate_pool: Optional[int] = None
    ) -> List[Tuple[float, PointId]]:
        check = getattr(self.collection, "check_strict_query", None)
        if check is not None:
            check(limit, req.params.hnsw_ef, req.params.exact, req.filter)
        self._report_unindexed(req.filter)
        q = req.query
        if q is None:
            # scroll-by-id order, no scores
            ids = self.collection.scroll_ids(limit, flt=req.filter, shard_key=req.shard_key)
            return [(0.0, pid) for pid in ids]
        if isinstance(q, dict):
            if "order_by" in q:
                return self._order_by(q["order_by"], req, limit)
            if "sample" in q:
                return self._sample(req, limit)
            if "formula" in q or "expression" in q:
                return self._formula(q, req, limit)
            if "fusion" in q:
                raise QueryError("fusion requires prefetch")
            if "recommend" in q:
                return self._recommend(q["recommend"], req, limit)
            if "discover" in q:
                return self._discover(q["discover"], req, limit)
            if "context" in q:
                return self._context(q["context"], req, limit)
            if "nearest" in q:
                nearest = q["nearest"]
                mmr = q.get("mmr")
                if mmr is not None:
                    return self._mmr(nearest, mmr, req, limit)
                return self._nearest(nearest, req, limit)
            if "indices" in q or "text" in q or "image" in q or "object" in q:
                return self._nearest(q, req, limit)
            raise QueryError(f"unknown query {list(q.keys())}")
        # plain vector / id / multivector
        return self._nearest(q, req, limit)

    def _nearest(
        self, ref: Any, req: QueryRequest, limit: int
    ) -> List[Tuple[float, PointId]]:
        vec = self._resolve_vector(ref, req.using, req)
        exclude = set(self._exclude_ids(ref))
        fetch = limit + len(exclude)
        if isinstance(vec, SparseVector):
            res = self.collection.search_sparse(
                req.using, [vec], fetch, req.filter, shard_key=req.shard_key
            )[0]
        elif isinstance(vec, np.ndarray) and vec.ndim == 2:
            res = self.collection.search_multi(
                req.using, vec, fetch, req.filter, shard_key=req.shard_key
            )
        else:
            res = self.collection.search_dense(
                req.using, vec[None, :], fetch, req.filter, req.params,
                shard_key=req.shard_key,
            )[0]
        out = [(s, pid) for s, pid, _ in res if pid not in exclude]
        out = _apply_threshold(out, req.score_threshold, self._distance(req.using))
        return out[:limit]

    def _report_unindexed(self, flt: Optional[Filter]) -> None:
        """Filtered query over an unindexed field → issues dashboard
        (reference: problems/unindexed_field.rs)."""
        if flt is None:
            return
        from ..api.issues import ISSUES
        from ..types import FieldCondition

        indexed = getattr(self.collection, "_indexed_fields", lambda: set())()

        def walk(f: Filter):
            for c in list(f.must) + list(f.should) + list(f.must_not) + (
                f.min_should[0] if f.min_should else []
            ):
                if isinstance(c, Filter):
                    walk(c)
                elif isinstance(c, FieldCondition) and c.key not in indexed:
                    ISSUES.unindexed_field(self.collection.name, c.key)

        walk(flt)

    def _distance(self, using: str) -> Distance:
        vp = self.collection.params.vectors.get(using)
        return vp.distance if vp else Distance.COSINE

    # recommend (reference: vector_storage/query/reco_query.rs)
    def _recommend(
        self, spec: Dict[str, Any], req: QueryRequest, limit: int
    ) -> List[Tuple[float, PointId]]:
        positives = [
            self._resolve_vector(r, req.using, req) for r in _as_list(spec.get("positive"))
        ]
        negatives = [
            self._resolve_vector(r, req.using, req) for r in _as_list(spec.get("negative"))
        ]
        if not positives and not negatives:
            raise QueryError("recommend requires at least one example")
        strategy = spec.get("strategy", "average_vector")
        exclude = set(
            self._ids_from_ref_list(spec.get("positive"))
            + self._ids_from_ref_list(spec.get("negative"))
        )
        if isinstance(positives[0] if positives else negatives[0], SparseVector):
            return self._recommend_sparse(positives, negatives, req, limit, exclude, strategy)

        if strategy == "average_vector":
            if not positives:
                raise QueryError("average_vector recommend requires positives")
            avg_pos = np.mean(np.stack(positives), axis=0)
            if negatives:
                avg_neg = np.mean(np.stack(negatives), axis=0)
                query = avg_pos + (avg_pos - avg_neg)
            else:
                query = avg_pos
            res = self.collection.search_dense(
                req.using, query[None, :], limit + len(exclude), req.filter, req.params,
                shard_key=req.shard_key,
            )[0]
            out = [(s, pid) for s, pid, _ in res if pid not in exclude]
            return _apply_threshold(out, req.score_threshold, self._distance(req.using))[:limit]

        # best_score: oversampled candidates per example, exact aggregation
        targets = positives + negatives
        cand = self._gather_candidates(targets, req, (limit + len(exclude)) * 2)
        dist = self._distance(req.using)
        scored = []
        for pid in cand:
            if pid in exclude:
                continue
            vec = self.collection.get_point_vector(pid, req.using)
            if vec is None:
                continue
            v = np.asarray(vec, dtype=np.float32)
            best_pos = max((_pair_score(p, v, dist) for p in positives), default=-math.inf)
            best_neg = max((_pair_score(n, v, dist) for n in negatives), default=-math.inf)
            if best_pos > best_neg:
                score = best_pos
            else:
                score = -(best_neg * best_neg)
            scored.append((score, pid))
        scored.sort(key=lambda t: -t[0])
        return _apply_threshold(scored, req.score_threshold, dist)[:limit]

    def _recommend_sparse(
        self, positives, negatives, req, limit, exclude, strategy
    ) -> List[Tuple[float, PointId]]:
        cand: List[PointId] = []
        seen = set()
        for target in positives + negatives:
            res = self.collection.search_sparse(
                req.using, [target], limit * 2, req.filter, shard_key=req.shard_key
            )[0]
            for _, pid, _ in res:
                if pid not in seen:
                    seen.add(pid)
                    cand.append(pid)
        scored = []
        for pid in cand:
            if pid in exclude:
                continue
            vec = self.collection.get_point_vector(pid, req.using)
            if vec is None:
                continue
            sv = SparseVector.from_dict(vec) if isinstance(vec, dict) else vec
            best_pos = max(
                (sparse_score_np(p, sv) for p in positives), default=-math.inf
            )
            best_neg = max(
                (sparse_score_np(n, sv) for n in negatives), default=-math.inf
            )
            score = best_pos if best_pos > best_neg else -(best_neg * best_neg)
            scored.append((score, pid))
        scored.sort(key=lambda t: -t[0])
        return scored[:limit]

    def _gather_candidates(
        self, targets: List[Any], req: QueryRequest, per_target: int
    ) -> List[PointId]:
        cand: List[PointId] = []
        seen = set()
        dense_targets = [t for t in targets if isinstance(t, np.ndarray)]
        if dense_targets:
            qs = np.stack(dense_targets)
            res = self.collection.search_dense(
                req.using, qs, per_target, req.filter, req.params, shard_key=req.shard_key
            )
            for items in res:
                for _, pid, _ in items:
                    if pid not in seen:
                        seen.add(pid)
                        cand.append(pid)
        return cand

    # discover / context (reference: discovery_query.rs / context_query.rs)
    def _parse_pairs(self, pairs_spec, req) -> List[Tuple[np.ndarray, np.ndarray]]:
        pairs = []
        for pair in _as_list(pairs_spec):
            pos = self._resolve_vector(pair["positive"], req.using, req)
            neg = self._resolve_vector(pair["negative"], req.using, req)
            pairs.append((pos, neg))
        return pairs

    def _discover(
        self, spec: Dict[str, Any], req: QueryRequest, limit: int
    ) -> List[Tuple[float, PointId]]:
        target = self._resolve_vector(spec["target"], req.using, req)
        pairs = self._parse_pairs(spec.get("context"), req)
        exclude = set(self._exclude_ids(spec))
        dist = self._distance(req.using)
        targets = [target] + [p for pair in pairs for p in pair]
        cand = self._gather_candidates(targets, req, (limit + len(exclude)) * 2)
        scored = []
        for pid in cand:
            if pid in exclude:
                continue
            vec = self.collection.get_point_vector(pid, req.using)
            if vec is None:
                continue
            v = np.asarray(vec, dtype=np.float32)
            zone = sum(
                1 for pos, neg in pairs
                if _pair_score(pos, v, dist) > _pair_score(neg, v, dist)
            )
            t_score = _pair_score(target, v, dist)
            # rank primarily by satisfied context pairs, then by target sim
            scored.append((zone * CONTEXT_ZONE_SCALE + _sigmoid(t_score), pid))
        scored.sort(key=lambda t: -t[0])
        return scored[:limit]

    def _context(
        self, spec: Any, req: QueryRequest, limit: int
    ) -> List[Tuple[float, PointId]]:
        pairs = self._parse_pairs(spec, req)
        exclude = set(self._exclude_ids(spec))
        dist = self._distance(req.using)
        targets = [p for pair in pairs for p in pair]
        cand = self._gather_candidates(targets, req, (limit + len(exclude)) * 2)
        scored = []
        for pid in cand:
            if pid in exclude:
                continue
            vec = self.collection.get_point_vector(pid, req.using)
            if vec is None:
                continue
            v = np.asarray(vec, dtype=np.float32)
            # each pair contributes min(0, pos_sim - neg_sim)
            score = sum(
                min(0.0, _pair_score(pos, v, dist) - _pair_score(neg, v, dist))
                for pos, neg in pairs
            )
            scored.append((score, pid))
        scored.sort(key=lambda t: -t[0])
        return scored[:limit]

    # mmr (reference: collection/query.rs mmr rescore)
    def _mmr(
        self, nearest: Any, mmr_spec: Dict[str, Any], req: QueryRequest, limit: int
    ) -> List[Tuple[float, PointId]]:
        diversity = float(mmr_spec.get("diversity", 0.5))
        cand_limit = int(mmr_spec.get("candidates_limit", max(limit * 4, 32)))
        base = self._nearest(nearest, req, cand_limit)
        if not base:
            return []
        dist = self._distance(req.using)
        vecs = {}
        for _, pid in base:
            v = self.collection.get_point_vector(pid, req.using)
            if v is not None and not isinstance(v, dict):
                vecs[pid] = np.asarray(v, dtype=np.float32)
        items = [(s, p) for s, p in base if p in vecs]
        selected: List[Tuple[float, PointId]] = []
        while items and len(selected) < limit:
            best_idx, best_val = 0, -math.inf
            for i, (rel, pid) in enumerate(items):
                if selected:
                    max_sim = max(
                        _pair_score(vecs[pid], vecs[sp], dist) for _, sp in selected
                    )
                else:
                    max_sim = 0.0
                val = (1.0 - diversity) * rel - diversity * max_sim
                if val > best_val:
                    best_idx, best_val = i, val
            selected.append(items.pop(best_idx))
        return selected

    # order_by (reference: order_by scroll)
    def _order_by(
        self, spec: Any, req: QueryRequest, limit: int
    ) -> List[Tuple[float, PointId]]:
        if isinstance(spec, str):
            spec = {"key": spec}
        key = spec["key"]
        direction = spec.get("direction", "asc")
        start_from = spec.get("start_from")
        rows: List[Tuple[float, PointId]] = []
        for shard in self.collection._shards_for_read(req.shard_key):
            for seg in shard.segments:
                mask = seg.filter_mask(req.filter)
                alive = seg.alive_mask()
                for off, payload in seg.payload_storage.iter_items():
                    if off >= len(alive) or not alive[off]:
                        continue
                    if mask is not None and (off >= len(mask) or not mask[off]):
                        continue
                    ext = seg.id_tracker.external_id(off)
                    if ext is None:
                        continue
                    for v in json_path.get_leaf_values(payload, key):
                        num = _as_number(v)
                        if num is not None:
                            rows.append((num, ext))
                            break
        reverse = direction == "desc"
        rows.sort(key=lambda t: (t[0], str(t[1])), reverse=reverse)
        if start_from is not None:
            sf = _as_number(start_from)
            if sf is not None:
                rows = [
                    r for r in rows if (r[0] >= sf if not reverse else r[0] <= sf)
                ]
        return rows[:limit]

    def _sample(self, req: QueryRequest, limit: int) -> List[Tuple[float, PointId]]:
        ids = self.collection.scroll_ids(
            10**9, flt=req.filter, shard_key=req.shard_key
        )
        rng = random.Random()
        if len(ids) > limit:
            ids = rng.sample(ids, limit)
        return [(0.0, pid) for pid in ids]

    # formula rescoring (reference: formula queries in query API)
    def _formula(
        self, spec: Dict[str, Any], req: QueryRequest, limit: int
    ) -> List[Tuple[float, PointId]]:
        raise QueryError("formula queries require prefetch results")

    def formula_rescore(
        self,
        expr: Any,
        defaults: Dict[str, Any],
        sources: List[List[Tuple[float, PointId]]],
        req: QueryRequest,
        limit: int,
    ) -> List[Tuple[float, PointId]]:
        from ..collection.formula import evaluate_formula

        # point → per-source scores
        per_point: Dict[PointId, Dict[int, float]] = {}
        for i, src in enumerate(sources):
            for s, pid in src:
                per_point.setdefault(pid, {})[i] = s
        scored = []
        for pid, score_map in per_point.items():
            payload, _ = self.collection.get_payload_and_vectors(pid)
            val = evaluate_formula(expr, score_map, payload or {}, defaults)
            scored.append((val, pid))
        scored.sort(key=lambda t: -t[0])
        return scored[:limit]

    # -- hydration ------------------------------------------------------------

    def _hydrate(
        self, items: List[Tuple[float, PointId]], req: QueryRequest
    ) -> List[Dict[str, Any]]:
        out = []
        dist = self._distance(req.using)
        from ..utils import hw_counter

        hw_counter.add(payload_reads=len(items))
        for score, pid in items:
            payload, vectors = self.collection.get_payload_and_vectors(pid)
            entry: Dict[str, Any] = {
                "id": pid,
                "version": getattr(self.collection, "point_version", lambda _: 0)(pid),
                "score": _user_score(score, dist),
            }
            p = _select_payload(payload, req.with_payload)
            if p is not None:
                entry["payload"] = p
            v = _select_vectors(vectors, req.with_vector)
            if v is not None:
                entry["vector"] = v
            out.append(entry)
        return out


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _clone_with_filter(req: QueryRequest, flt: Optional[Filter]) -> QueryRequest:
    sub = QueryRequest.__new__(QueryRequest)
    sub.__dict__.update(req.__dict__)
    sub.prefetch = []
    sub.filter = flt
    return sub


def _pair_score(a: np.ndarray, b: np.ndarray, distance: Distance) -> float:
    return float(score_np(a, b[None, :], distance)[0])


def _sigmoid(x: float) -> float:
    try:
        return 1.0 / (1.0 + math.exp(-x))
    except OverflowError:
        return 0.0 if x < 0 else 1.0


def _rrf(sources: List[List[Tuple[float, PointId]]], limit: int):
    scores: Dict[PointId, float] = {}
    for src in sources:
        for rank, (_, pid) in enumerate(src):
            scores[pid] = scores.get(pid, 0.0) + 1.0 / (RRF_K + rank + 1)
    items = sorted(scores.items(), key=lambda t: -t[1])
    return [(s, p) for p, s in items][:limit]


def _dbsf(sources: List[List[Tuple[float, PointId]]], limit: int):
    """Distribution-based score fusion: per-source z-normalize, then sum."""
    scores: Dict[PointId, float] = {}
    for src in sources:
        if not src:
            continue
        vals = np.asarray([s for s, _ in src], dtype=np.float64)
        mean, std = vals.mean(), vals.std()
        std = std if std > 1e-12 else 1.0
        for s, pid in src:
            scores[pid] = scores.get(pid, 0.0) + (s - mean) / std
    items = sorted(scores.items(), key=lambda t: -t[1])
    return [(s, p) for p, s in items][:limit]


def _apply_threshold(
    items: List[Tuple[float, PointId]],
    threshold: Optional[float],
    distance: Distance,
) -> List[Tuple[float, PointId]]:
    if threshold is None:
        return items
    out = []
    for s, pid in items:
        user = _user_score(s, distance)
        if distance.larger_is_better:
            if user >= threshold:
                out.append((s, pid))
        else:
            if user <= threshold:
                out.append((s, pid))
    return out


def _user_score(score: float, distance: Distance) -> float:
    if not math.isfinite(score):
        return score
    return distance.postprocess(score)


def _as_number(v: Any) -> Optional[float]:
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        from ..index.payload_index import parse_datetime

        ts = parse_datetime(v)
        return float(ts) if ts is not None else None
    return None


def _select_payload(payload: Optional[dict], with_payload: Any) -> Optional[dict]:
    if with_payload is False or with_payload is None:
        return None
    if payload is None:
        return {}
    if with_payload is True:
        return payload
    if isinstance(with_payload, list):
        with_payload = {"include": with_payload}
    if isinstance(with_payload, dict):
        if "include" in with_payload:
            out: Dict[str, Any] = {}
            for key in with_payload["include"]:
                vals = json_path.get_values(payload, key)
                if vals:
                    json_path.set_value(out, key, vals[0])
            return out
        if "exclude" in with_payload:
            import copy

            out = copy.deepcopy(payload)
            for key in with_payload["exclude"]:
                json_path.delete_path(out, key)
            return out
    return payload


def _select_vectors(vectors: Optional[dict], with_vector: Any) -> Optional[Any]:
    if with_vector is False or with_vector is None or vectors is None:
        return None
    if with_vector is True:
        selected = vectors
    elif isinstance(with_vector, list):
        selected = {k: v for k, v in vectors.items() if k in with_vector}
    else:
        return None
    if list(selected.keys()) == [DEFAULT_VECTOR_NAME]:
        return selected[DEFAULT_VECTOR_NAME]
    return selected
