"""Payload field indexes + filter→bitmask compilation.

Reference: lib/segment/src/index/field_index/ (51,528 LoC: numeric histograms,
map index, geo hash cells, full-text inverted index) and
index/struct_payload_index/. The TPU re-design: all field indexes live
host-side; a `Filter` tree compiles to a dense boolean mask over segment
offsets which is shipped to HBM and fused into scoring / beam search
(mask = -inf before top-k). Because all postings are RAM-resident,
"cardinality estimation" (reference: query_estimator.rs) is exact here —
the mask's popcount drives the plain-scan vs graph dispatch.
"""

from __future__ import annotations

import datetime as _dt
import math
import re
import uuid as _uuid
from typing import Any, Callable, Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from ..storage.payload import PayloadStorage
from ..types import (
    Condition,
    DatetimeRange,
    FieldCondition,
    Filter,
    GeoBoundingBox,
    GeoPolygon,
    GeoRadius,
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
    PayloadIndexParams,
    PayloadSchemaType,
    Range,
    ValuesCount,
)
from ..utils import json_path

EARTH_RADIUS_M = 6371000.0


def parse_datetime(s: Any) -> Optional[int]:
    """RFC3339 → microseconds since epoch (UTC)."""
    if isinstance(s, (int, float)):
        return int(s * 1_000_000) if isinstance(s, float) else int(s)
    if not isinstance(s, str):
        return None
    txt = s.strip().replace("Z", "+00:00")
    try:
        dt = _dt.datetime.fromisoformat(txt)
    except ValueError:
        try:
            dt = _dt.datetime.strptime(txt, "%Y-%m-%d %H:%M:%S")
        except ValueError:
            return None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    return int(dt.timestamp() * 1_000_000)


# ---------------------------------------------------------------------------
# Tokenizers (reference: lib/segment/src/index/field_index/full_text_index/tokenizers/)
# ---------------------------------------------------------------------------

_WORD_RE = re.compile(r"[^\W_]+", re.UNICODE)


def tokenize(text: str, params: PayloadIndexParams) -> List[str]:
    if params.tokenizer == "whitespace":
        tokens = text.split()
    elif params.tokenizer == "multilingual":
        # word segmentation for alphabetic scripts, char bigrams for CJK
        # runs (reference: tokenizers/multilingual.rs + japanese.rs)
        from ..utils.text import segment_multilingual

        tokens = segment_multilingual(text)
    elif params.tokenizer in ("word", "prefix"):
        tokens = _WORD_RE.findall(text)
    else:
        tokens = _WORD_RE.findall(text)
    if params.lowercase:
        tokens = [t.lower() for t in tokens]
    if getattr(params, "ascii_folding", False):
        from ..utils.text import fold_to_ascii

        tokens = [fold_to_ascii(t) for t in tokens]
    if params.stopwords:
        from ..utils.text import STOPWORDS

        stop = STOPWORDS.get(str(params.stopwords).lower(), frozenset())
        tokens = [t for t in tokens if t not in stop]
    if params.stemmer:
        from ..utils.text import porter_stem

        tokens = [porter_stem(t) for t in tokens]
    if params.min_token_len:
        tokens = [t for t in tokens if len(t) >= params.min_token_len]
    if params.max_token_len:
        tokens = [t for t in tokens if len(t) <= params.max_token_len]
    return tokens


def prefix_expand(token: str, max_len: int = 15, min_len: int = 1) -> List[str]:
    return [token[:i] for i in range(min_len, min(len(token), max_len) + 1)]


# ---------------------------------------------------------------------------
# Field indexes
# ---------------------------------------------------------------------------


class FieldIndexBase:
    """One indexed payload field. Subclasses maintain postings keyed by value."""

    def __init__(self, params: PayloadIndexParams):
        self.params = params
        self.points_count = 0  # points with at least one value
        self._values_per_point: Dict[int, int] = {}

    def add_point(self, offset: int, values: List[Any]) -> None:
        accepted = self._add_values(offset, values)
        if accepted > 0:
            if offset not in self._values_per_point:
                self.points_count += 1
            self._values_per_point[offset] = (
                self._values_per_point.get(offset, 0) + accepted
            )

    def remove_point(self, offset: int) -> None:
        self._remove_values(offset)
        if offset in self._values_per_point:
            del self._values_per_point[offset]
            self.points_count -= 1

    def values_count(self, offset: int) -> int:
        return self._values_per_point.get(offset, 0)

    def _add_values(self, offset: int, values: List[Any]) -> int:
        raise NotImplementedError

    def _remove_values(self, offset: int) -> None:
        raise NotImplementedError

    def payload_blocks(self, threshold: int) -> Iterable[Tuple[Any, Set[int]]]:
        """(value, offsets) groups with ≥ threshold points — used for
        filterable-HNSW per-block subgraphs (reference: hnsw/build.rs:529)."""
        return []


class MapIndex(FieldIndexBase):
    """keyword / integer-lookup / bool / uuid postings (reference map_index/)."""

    def __init__(self, params: PayloadIndexParams, normalize: Callable[[Any], Any]):
        super().__init__(params)
        self._normalize = normalize
        self.postings: Dict[Any, Set[int]] = {}
        self._point_values: Dict[int, List[Any]] = {}

    def _add_values(self, offset: int, values: List[Any]) -> int:
        added = 0
        for raw in values:
            v = self._normalize(raw)
            if v is None:
                continue
            self.postings.setdefault(v, set()).add(offset)
            self._point_values.setdefault(offset, []).append(v)
            added += 1
        return added

    def _remove_values(self, offset: int) -> None:
        for v in self._point_values.pop(offset, []):
            s = self.postings.get(v)
            if s is not None:
                s.discard(offset)
                if not s:
                    del self.postings[v]

    def match_offsets(self, values: Iterable[Any]) -> Set[int]:
        out: Set[int] = set()
        for raw in values:
            v = self._normalize(raw)
            if v is not None:
                out |= self.postings.get(v, set())
        return out

    def all_offsets(self) -> Set[int]:
        return set(self._point_values.keys())

    def payload_blocks(self, threshold: int) -> Iterable[Tuple[Any, Set[int]]]:
        for value, offs in self.postings.items():
            if len(offs) >= threshold:
                yield value, offs


class NumericIndex(FieldIndexBase):
    """float / integer-range / datetime ranges.

    Reference: numeric_index/ + histogram.rs. Values stored as (value, offset)
    pairs; a lazily rebuilt sorted array answers range queries via
    searchsorted — exact, replacing the reference's histogram estimation.
    """

    def __init__(self, params: PayloadIndexParams, to_number: Callable[[Any], Optional[float]]):
        super().__init__(params)
        self._to_number = to_number
        self._point_values: Dict[int, List[float]] = {}
        self._sorted_values: Optional[np.ndarray] = None
        self._sorted_offsets: Optional[np.ndarray] = None

    def _add_values(self, offset: int, values: List[Any]) -> int:
        added = 0
        for raw in values:
            num = self._to_number(raw)
            if num is None:
                continue
            self._point_values.setdefault(offset, []).append(float(num))
            added += 1
        if added:
            self._sorted_values = None
        return added

    def _remove_values(self, offset: int) -> None:
        if self._point_values.pop(offset, None) is not None:
            self._sorted_values = None

    def _rebuild(self) -> None:
        pairs = [
            (v, off) for off, vals in self._point_values.items() for v in vals
        ]
        if pairs:
            arr = np.asarray(pairs, dtype=np.float64)
            order = np.argsort(arr[:, 0], kind="stable")
            self._sorted_values = arr[order, 0]
            self._sorted_offsets = arr[order, 1].astype(np.int64)
        else:
            self._sorted_values = np.zeros((0,), dtype=np.float64)
            self._sorted_offsets = np.zeros((0,), dtype=np.int64)

    def range_offsets(
        self,
        gt: Optional[float],
        gte: Optional[float],
        lt: Optional[float],
        lte: Optional[float],
    ) -> Set[int]:
        if self._sorted_values is None:
            self._rebuild()
        lo = 0
        hi = len(self._sorted_values)
        if gt is not None:
            lo = max(lo, int(np.searchsorted(self._sorted_values, gt, side="right")))
        if gte is not None:
            lo = max(lo, int(np.searchsorted(self._sorted_values, gte, side="left")))
        if lt is not None:
            hi = min(hi, int(np.searchsorted(self._sorted_values, lt, side="left")))
        if lte is not None:
            hi = min(hi, int(np.searchsorted(self._sorted_values, lte, side="right")))
        if lo >= hi:
            return set()
        return set(self._sorted_offsets[lo:hi].tolist())

    def all_offsets(self) -> Set[int]:
        return set(self._point_values.keys())

    def range_count(
        self,
        gt: Optional[float] = None,
        gte: Optional[float] = None,
        lt: Optional[float] = None,
        lte: Optional[float] = None,
    ) -> int:
        """O(log n) range cardinality straight off the sorted array — the
        role the reference's equi-depth histogram plays
        (numeric_index/histogram.rs), except exact: keeping values fully
        sorted (cheap on rebuild, and rebuilds batch) makes the estimate
        free, so no histogram error bars are needed. Counts value entries;
        multi-valued points can count more than once (same bias the
        reference's histogram has)."""
        if self._sorted_values is None:
            self._rebuild()
        lo = 0
        hi = len(self._sorted_values)
        if gt is not None:
            lo = max(lo, int(np.searchsorted(self._sorted_values, gt, side="right")))
        if gte is not None:
            lo = max(lo, int(np.searchsorted(self._sorted_values, gte, side="left")))
        if lt is not None:
            hi = min(hi, int(np.searchsorted(self._sorted_values, lt, side="left")))
        if lte is not None:
            hi = min(hi, int(np.searchsorted(self._sorted_values, lte, side="right")))
        return max(hi - lo, 0)


class GeoIndex(FieldIndexBase):
    """Geo points per offset; conditions evaluated vectorized with numpy.

    Reference: geo_index/ uses geohash cell posting lists for cardinality
    estimation; with RAM-resident arrays we evaluate exactly instead.
    """

    def __init__(self, params: PayloadIndexParams):
        super().__init__(params)
        self._point_values: Dict[int, List[Tuple[float, float]]] = {}
        self._arr: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None

    @staticmethod
    def _parse_geo(raw: Any) -> Optional[Tuple[float, float]]:
        if isinstance(raw, dict) and "lon" in raw and "lat" in raw:
            try:
                return float(raw["lon"]), float(raw["lat"])
            except (TypeError, ValueError):
                return None
        return None

    def _add_values(self, offset: int, values: List[Any]) -> int:
        added = 0
        for raw in values:
            pt = self._parse_geo(raw)
            if pt is None:
                continue
            self._point_values.setdefault(offset, []).append(pt)
            added += 1
        if added:
            self._arr = None
        return added

    def _remove_values(self, offset: int) -> None:
        if self._point_values.pop(offset, None) is not None:
            self._arr = None

    def _arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._arr is None:
            offs, lons, lats = [], [], []
            for off, pts in self._point_values.items():
                for lon, lat in pts:
                    offs.append(off)
                    lons.append(lon)
                    lats.append(lat)
            self._arr = (
                np.asarray(offs, dtype=np.int64),
                np.asarray(lons, dtype=np.float64),
                np.asarray(lats, dtype=np.float64),
            )
        return self._arr

    def bounding_box_offsets(self, bb: GeoBoundingBox) -> Set[int]:
        offs, lons, lats = self._arrays()
        tl_lon, tl_lat = bb.top_left
        br_lon, br_lat = bb.bottom_right
        lat_ok = (lats <= tl_lat) & (lats >= br_lat)
        if tl_lon <= br_lon:
            lon_ok = (lons >= tl_lon) & (lons <= br_lon)
        else:  # antimeridian crossing
            lon_ok = (lons >= tl_lon) | (lons <= br_lon)
        return set(offs[lat_ok & lon_ok].tolist())

    def radius_offsets(self, gr: GeoRadius) -> Set[int]:
        offs, lons, lats = self._arrays()
        c_lon, c_lat = gr.center
        lat1 = np.radians(lats)
        lat2 = math.radians(c_lat)
        dlat = lat1 - lat2
        dlon = np.radians(lons - c_lon)
        a = np.sin(dlat / 2) ** 2 + np.cos(lat1) * math.cos(lat2) * np.sin(dlon / 2) ** 2
        dist = 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0, 1)))
        return set(offs[dist <= gr.radius].tolist())

    def polygon_offsets(self, gp: GeoPolygon) -> Set[int]:
        offs, lons, lats = self._arrays()
        inside = _points_in_ring(lons, lats, gp.exterior)
        for ring in gp.interiors:
            inside &= ~_points_in_ring(lons, lats, ring)
        return set(offs[inside].tolist())

    def all_offsets(self) -> Set[int]:
        return set(self._point_values.keys())


def _points_in_ring(
    lons: np.ndarray, lats: np.ndarray, ring: List[Tuple[float, float]]
) -> np.ndarray:
    """Vectorized even-odd point-in-polygon."""
    inside = np.zeros(lons.shape, dtype=bool)
    n = len(ring)
    if n < 3:
        return inside
    pts = ring[:-1] if ring[0] == ring[-1] else ring
    n = len(pts)
    for i in range(n):
        x1, y1 = pts[i]
        x2, y2 = pts[(i + 1) % n]
        cond = (lats < y1) != (lats < y2)
        with np.errstate(divide="ignore", invalid="ignore"):
            x_cross = x1 + (lats - y1) / (y2 - y1) * (x2 - x1)
        inside ^= cond & (lons < x_cross)
    return inside


class FullTextIndex(FieldIndexBase):
    """Inverted text index with positions for phrase matching.

    Reference: full_text_index/ (20,130 LoC). Token → postings set; per-doc
    token position lists support MatchPhrase.
    """

    def __init__(self, params: PayloadIndexParams):
        super().__init__(params)
        self.postings: Dict[str, Set[int]] = {}
        self._doc_tokens: Dict[int, List[str]] = {}

    def _index_tokens(self, text: str) -> List[str]:
        return tokenize(text, self.params)

    def _add_values(self, offset: int, values: List[Any]) -> int:
        added = 0
        for raw in values:
            if not isinstance(raw, str):
                continue
            tokens = self._index_tokens(raw)
            doc = self._doc_tokens.setdefault(offset, [])
            doc.extend(tokens)
            for tok in tokens:
                self.postings.setdefault(tok, set()).add(offset)
                if self.params.tokenizer == "prefix":
                    for p in prefix_expand(tok):
                        self.postings.setdefault(p, set()).add(offset)
            added += 1
        return added

    def _remove_values(self, offset: int) -> None:
        tokens = self._doc_tokens.pop(offset, None)
        if not tokens:
            return
        for tok in set(tokens):
            keys = [tok]
            if self.params.tokenizer == "prefix":
                keys.extend(prefix_expand(tok))
            for k in keys:
                s = self.postings.get(k)
                if s is not None:
                    s.discard(offset)
                    if not s:
                        del self.postings[k]

    def text_match_offsets(self, query: str) -> Set[int]:
        tokens = tokenize(query, self.params)
        if not tokens:
            return set(self._doc_tokens.keys())
        result: Optional[Set[int]] = None
        for tok in tokens:
            s = self.postings.get(tok, set())
            result = set(s) if result is None else (result & s)
            if not result:
                return set()
        return result or set()

    def phrase_match_offsets(self, phrase: str) -> Set[int]:
        tokens = tokenize(phrase, self.params)
        if not tokens:
            return set(self._doc_tokens.keys())
        candidates = self.text_match_offsets(phrase)
        out: Set[int] = set()
        for off in candidates:
            doc = self._doc_tokens.get(off, [])
            n, m = len(doc), len(tokens)
            for i in range(n - m + 1):
                if doc[i : i + m] == tokens:
                    out.add(off)
                    break
        return out

    def all_offsets(self) -> Set[int]:
        return set(self._doc_tokens.keys())


def _normalize_keyword(v: Any) -> Optional[str]:
    return v if isinstance(v, str) else None


def _normalize_int(v: Any) -> Optional[int]:
    if isinstance(v, bool):
        return None
    return v if isinstance(v, int) else None


def _normalize_bool(v: Any) -> Optional[bool]:
    return v if isinstance(v, bool) else None


def _normalize_uuid(v: Any) -> Optional[str]:
    if isinstance(v, str):
        try:
            return str(_uuid.UUID(v))
        except ValueError:
            return None
    return None


def _to_float(v: Any) -> Optional[float]:
    if isinstance(v, bool):
        return None
    if isinstance(v, (int, float)):
        return float(v)
    return None


class FieldIndexes:
    """All indexes for one payload field (a MapIndex and/or NumericIndex etc.)."""

    def __init__(self, params: PayloadIndexParams):
        self.params = params
        t = params.type
        self.map_index: Optional[MapIndex] = None
        self.numeric_index: Optional[NumericIndex] = None
        self.geo_index: Optional[GeoIndex] = None
        self.text_index: Optional[FullTextIndex] = None
        if t is PayloadSchemaType.KEYWORD:
            self.map_index = MapIndex(params, _normalize_keyword)
        elif t is PayloadSchemaType.INTEGER:
            if params.lookup:
                self.map_index = MapIndex(params, _normalize_int)
            if params.range:
                self.numeric_index = NumericIndex(params, _to_float)
        elif t is PayloadSchemaType.FLOAT:
            self.numeric_index = NumericIndex(params, _to_float)
        elif t is PayloadSchemaType.BOOL:
            self.map_index = MapIndex(params, _normalize_bool)
        elif t is PayloadSchemaType.DATETIME:
            self.numeric_index = NumericIndex(params, parse_datetime)
        elif t is PayloadSchemaType.UUID:
            self.map_index = MapIndex(params, _normalize_uuid)
        elif t is PayloadSchemaType.GEO:
            self.geo_index = GeoIndex(params)
        elif t is PayloadSchemaType.TEXT:
            self.text_index = FullTextIndex(params)

    def sub_indexes(self) -> List[FieldIndexBase]:
        return [
            i
            for i in (self.map_index, self.numeric_index, self.geo_index, self.text_index)
            if i is not None
        ]

    def memory_usage_bytes(self):
        from ..utils.memsize import merge, sizeof_shallow

        return merge(*(sizeof_shallow(i) for i in self.sub_indexes()))

    def add_point(self, offset: int, values: List[Any]) -> None:
        for idx in self.sub_indexes():
            idx.add_point(offset, values)

    def remove_point(self, offset: int) -> None:
        for idx in self.sub_indexes():
            idx.remove_point(offset)

    def points_count(self) -> int:
        subs = self.sub_indexes()
        return max((i.points_count for i in subs), default=0)


# ---------------------------------------------------------------------------
# Struct payload index: filter evaluation → mask
# ---------------------------------------------------------------------------


class StructPayloadIndex:
    """Per-segment filter compiler (reference: struct_payload_index/mod.rs:62).

    Produces dense boolean masks over internal offsets. Indexed fields answer
    from postings; unindexed conditions fall back to scanning the payload
    storage (the reference does the same via plain payload checks).
    """

    def __init__(
        self,
        payload_storage: PayloadStorage,
        id_tracker,
        has_vector_fn: Optional[Callable[[str, int], bool]] = None,
    ):
        self.payload = payload_storage
        self.id_tracker = id_tracker
        self.has_vector_fn = has_vector_fn
        self.field_indexes: Dict[str, FieldIndexes] = {}

    def memory_usage_bytes(self):
        from ..utils.memsize import merge, sizeof

        return merge(*(sizeof(fi) for fi in self.field_indexes.values()))

    # -- schema management --------------------------------------------------

    def set_indexed(self, field: str, params: PayloadIndexParams) -> None:
        fi = FieldIndexes(params)
        # index existing points
        for off, payload in self.payload.iter_items():
            values = json_path.get_values(payload, field)
            if values:
                fi.add_point(off, _flatten_values(values))
        self.field_indexes[field] = fi

    def drop_index(self, field: str) -> None:
        self.field_indexes.pop(field, None)

    def indexed_fields(self) -> Dict[str, PayloadIndexParams]:
        return {k: v.params for k, v in self.field_indexes.items()}

    # -- point lifecycle ----------------------------------------------------

    def add_point(self, offset: int, payload: Dict[str, Any]) -> None:
        for field, fi in self.field_indexes.items():
            values = json_path.get_values(payload, field)
            if values:
                fi.add_point(offset, _flatten_values(values))

    def remove_point(self, offset: int) -> None:
        for fi in self.field_indexes.values():
            fi.remove_point(offset)

    def update_point(self, offset: int, payload: Dict[str, Any]) -> None:
        self.remove_point(offset)
        self.add_point(offset, payload)

    # -- filter evaluation --------------------------------------------------

    def filter_mask(self, flt: Optional[Filter], n: int) -> Optional[np.ndarray]:
        """Compile a filter to a bool mask of length n (None = match all)."""
        if flt is None or flt.is_empty():
            return None
        return self._eval_filter(flt, n)

    def cardinality(self, flt: Optional[Filter], n: int) -> int:
        mask = self.filter_mask(flt, n)
        if mask is None:
            return n
        return int(mask.sum())

    def estimate_cardinality(self, flt: Optional[Filter], n: int) -> int:
        """Approximate matching-point count WITHOUT materializing offset
        masks (reference: CardinalityEstimation — must takes the min,
        should sums, must_not scales by the independence assumption).
        Numeric ranges come from the sorted array in O(log n); keyword
        matches from posting sizes. Unindexed conditions estimate n."""
        if flt is None:
            return n
        return min(self._est_filter(flt, n), n)

    def _est_filter(self, f: Filter, n: int) -> int:
        est = n
        for c in f.must:
            est = min(est, self._est_cond(c, n))
        if f.should:
            est = min(est, sum(self._est_cond(c, n) for c in f.should))
        if f.min_should:
            conds, _k = f.min_should
            est = min(est, sum(self._est_cond(c, n) for c in conds))
        for c in f.must_not:
            excl = self._est_cond(c, n)
            est = int(est * max(0.0, 1.0 - excl / max(n, 1)))
        return est

    def _est_cond(self, c, n: int) -> int:
        if isinstance(c, Filter):
            return self._est_filter(c, n)
        if isinstance(c, HasIdCondition):
            return len(c.has_id)
        if not isinstance(c, FieldCondition):
            return n
        fi = self.field_indexes.get(c.key)
        if fi is None:
            return n
        if c.match is not None and fi.map_index is not None:
            values = getattr(c.match, "any", None)
            if values is None:
                values = [getattr(c.match, "value", None)]
            total = 0
            for v in values:
                norm = fi.map_index._normalize(v)
                total += len(fi.map_index.postings.get(norm, ()))
            return total
        if c.range is not None and fi.numeric_index is not None:
            r = c.range
            conv = fi.numeric_index._to_number  # matches the field type
            return fi.numeric_index.range_count(
                gt=conv(r.gt) if r.gt is not None else None,
                gte=conv(r.gte) if r.gte is not None else None,
                lt=conv(r.lt) if r.lt is not None else None,
                lte=conv(r.lte) if r.lte is not None else None,
            )
        return n

    def _eval_filter(self, flt: Filter, n: int) -> np.ndarray:
        mask = np.ones(n, dtype=bool)
        for cond in flt.must:
            mask &= self._eval_condition(cond, n)
        if flt.should:
            any_mask = np.zeros(n, dtype=bool)
            for cond in flt.should:
                any_mask |= self._eval_condition(cond, n)
            mask &= any_mask
        if flt.min_should:
            conds, min_count = flt.min_should
            counts = np.zeros(n, dtype=np.int32)
            for cond in conds:
                counts += self._eval_condition(cond, n).astype(np.int32)
            mask &= counts >= min_count
        for cond in flt.must_not:
            mask &= ~self._eval_condition(cond, n)
        return mask

    def _offsets_to_mask(self, offsets: Iterable[int], n: int) -> np.ndarray:
        mask = np.zeros(n, dtype=bool)
        arr = np.fromiter((o for o in offsets if o < n), dtype=np.int64)
        if arr.size:
            mask[arr] = True
        return mask

    def _eval_condition(self, cond: Condition, n: int) -> np.ndarray:
        if isinstance(cond, Filter):
            return self._eval_filter(cond, n)
        if isinstance(cond, HasIdCondition):
            offs = []
            for pid in cond.has_id:
                internal = self.id_tracker.internal_id(pid)
                if internal is not None:
                    offs.append(internal)
            return self._offsets_to_mask(offs, n)
        if isinstance(cond, HasVectorCondition):
            mask = np.zeros(n, dtype=bool)
            if self.has_vector_fn is not None:
                for off in range(n):
                    mask[off] = self.has_vector_fn(cond.has_vector, off)
            return mask
        if isinstance(cond, IsEmptyCondition):
            return self._is_empty_mask(cond.is_empty_key, n)
        if isinstance(cond, IsNullCondition):
            return self._is_null_mask(cond.is_null_key, n)
        if isinstance(cond, NestedCondition):
            return self._eval_nested(cond, n)
        if isinstance(cond, FieldCondition):
            return self._eval_field_condition(cond, n)
        raise ValueError(f"unsupported condition: {cond!r}")

    def _is_empty_mask(self, key: str, n: int) -> np.ndarray:
        mask = np.ones(n, dtype=bool)
        for off, payload in self.payload.iter_items():
            if off >= n:
                continue
            values = json_path.get_leaf_values(payload, key)
            if any(v is not None for v in values):
                mask[off] = False
        return mask

    def _is_null_mask(self, key: str, n: int) -> np.ndarray:
        mask = np.zeros(n, dtype=bool)
        for off, payload in self.payload.iter_items():
            if off >= n:
                continue
            values = json_path.get_values(payload, key)
            flat = _flatten_values(values)
            if values and any(v is None for v in flat):
                mask[off] = True
        return mask

    def _eval_nested(self, cond: NestedCondition, n: int) -> np.ndarray:
        """Nested object filter: at least one array element satisfies the
        nested filter (reference: nested filter semantics)."""
        mask = np.zeros(n, dtype=bool)
        for off, payload in self.payload.iter_items():
            if off >= n:
                continue
            elements = json_path.get_values(payload, cond.key)
            flat: List[Any] = []
            for e in elements:
                if isinstance(e, list):
                    flat.extend(x for x in e if isinstance(x, dict))
                elif isinstance(e, dict):
                    flat.append(e)
            for element in flat:
                if self._matches_payload_filter(cond.filter, element):
                    mask[off] = True
                    break
        return mask

    def _matches_payload_filter(self, flt: Filter, payload: Dict[str, Any]) -> bool:
        for cond in flt.must:
            if not self._matches_payload_condition(cond, payload):
                return False
        if flt.should and not any(
            self._matches_payload_condition(c, payload) for c in flt.should
        ):
            return False
        if flt.min_should:
            conds, min_count = flt.min_should
            if sum(self._matches_payload_condition(c, payload) for c in conds) < min_count:
                return False
        for cond in flt.must_not:
            if self._matches_payload_condition(cond, payload):
                return False
        return True

    def _matches_payload_condition(self, cond: Condition, payload: Dict[str, Any]) -> bool:
        if isinstance(cond, Filter):
            return self._matches_payload_filter(cond, payload)
        if isinstance(cond, FieldCondition):
            values = json_path.get_leaf_values(payload, cond.key)
            return _field_condition_matches_values(cond, values, payload)
        if isinstance(cond, IsEmptyCondition):
            return not any(
                v is not None
                for v in json_path.get_leaf_values(payload, cond.is_empty_key)
            )
        if isinstance(cond, IsNullCondition):
            values = json_path.get_values(payload, cond.is_null_key)
            return bool(values) and any(v is None for v in _flatten_values(values))
        if isinstance(cond, NestedCondition):
            elements = json_path.get_values(payload, cond.key)
            flat = []
            for e in elements:
                if isinstance(e, list):
                    flat.extend(x for x in e if isinstance(x, dict))
                elif isinstance(e, dict):
                    flat.append(e)
            return any(self._matches_payload_filter(cond.filter, el) for el in flat)
        return False

    def _eval_field_condition(self, cond: FieldCondition, n: int) -> np.ndarray:
        fi = self.field_indexes.get(cond.key)
        result = self._eval_field_condition_indexed(cond, fi, n)
        if result is not None:
            return result
        # fallback: payload scan
        mask = np.zeros(n, dtype=bool)
        if isinstance(cond.match, MatchExcept):
            mask[:] = True  # except matches missing fields too
        for off, payload in self.payload.iter_items():
            if off >= n:
                continue
            values = json_path.get_leaf_values(payload, cond.key)
            mask[off] = _field_condition_matches_values(cond, values, payload)
        return mask

    def _eval_field_condition_indexed(
        self, cond: FieldCondition, fi: Optional[FieldIndexes], n: int
    ) -> Optional[np.ndarray]:
        if fi is None:
            return None
        m = cond.match
        if m is not None:
            if isinstance(m, MatchValue) and fi.map_index is not None:
                return self._offsets_to_mask(fi.map_index.match_offsets([m.value]), n)
            if isinstance(m, MatchAny) and fi.map_index is not None:
                return self._offsets_to_mask(fi.map_index.match_offsets(m.any), n)
            if isinstance(m, MatchExcept) and fi.map_index is not None:
                matched = fi.map_index.match_offsets(m.except_)
                mask = np.ones(n, dtype=bool)
                for off in matched:
                    if off < n:
                        mask[off] = False
                return mask
            if isinstance(m, MatchText) and fi.text_index is not None:
                return self._offsets_to_mask(fi.text_index.text_match_offsets(m.text), n)
            if isinstance(m, MatchPhrase) and fi.text_index is not None:
                return self._offsets_to_mask(
                    fi.text_index.phrase_match_offsets(m.phrase), n
                )
            if (
                isinstance(m, (MatchValue, MatchAny, MatchExcept))
                and fi.text_index is not None
            ):
                # exact text match on a text index: all tokens as phrase
                vals = (
                    [m.value]
                    if isinstance(m, MatchValue)
                    else (m.any if isinstance(m, MatchAny) else m.except_)
                )
                offs: Set[int] = set()
                for v in vals:
                    if isinstance(v, str):
                        offs |= fi.text_index.phrase_match_offsets(v)
                if isinstance(m, MatchExcept):
                    mask = np.ones(n, dtype=bool)
                    for off in offs:
                        if off < n:
                            mask[off] = False
                    return mask
                return self._offsets_to_mask(offs, n)
            return None
        if cond.range is not None and fi.numeric_index is not None:
            r = cond.range
            return self._offsets_to_mask(
                fi.numeric_index.range_offsets(r.gt, r.gte, r.lt, r.lte), n
            )
        if cond.datetime_range is not None and fi.numeric_index is not None:
            r = cond.datetime_range
            return self._offsets_to_mask(
                fi.numeric_index.range_offsets(
                    parse_datetime(r.gt) if r.gt else None,
                    parse_datetime(r.gte) if r.gte else None,
                    parse_datetime(r.lt) if r.lt else None,
                    parse_datetime(r.lte) if r.lte else None,
                ),
                n,
            )
        if cond.geo_bounding_box is not None and fi.geo_index is not None:
            return self._offsets_to_mask(
                fi.geo_index.bounding_box_offsets(cond.geo_bounding_box), n
            )
        if cond.geo_radius is not None and fi.geo_index is not None:
            return self._offsets_to_mask(fi.geo_index.radius_offsets(cond.geo_radius), n)
        if cond.geo_polygon is not None and fi.geo_index is not None:
            return self._offsets_to_mask(
                fi.geo_index.polygon_offsets(cond.geo_polygon), n
            )
        if cond.values_count is not None:
            vc = cond.values_count
            sub = fi.sub_indexes()
            if sub:
                mask = np.zeros(n, dtype=bool)
                for off in range(n):
                    c = max(s.values_count(off) for s in sub)
                    mask[off] = _check_values_count(vc, c)
                return mask
        if cond.is_empty is not None or cond.is_null is not None:
            return None  # handled via payload scan fallback
        return None

    # -- payload blocks for filterable HNSW ---------------------------------

    def payload_blocks(self, threshold: int) -> List[Tuple[str, Any, np.ndarray]]:
        """(field, value, offsets-array) for all big-enough keyword blocks
        (reference: for_each_payload_block, hnsw/build.rs:529)."""
        out = []
        for field, fi in self.field_indexes.items():
            for sub in fi.sub_indexes():
                for value, offs in sub.payload_blocks(threshold):
                    out.append(
                        (field, value, np.fromiter(offs, dtype=np.int32, count=len(offs)))
                    )
        return out


def _flatten_values(values: List[Any]) -> List[Any]:
    out: List[Any] = []
    for v in values:
        if isinstance(v, list):
            out.extend(v)
        else:
            out.append(v)
    return out


def _check_values_count(vc: ValuesCount, count: int) -> bool:
    if vc.lt is not None and not (count < vc.lt):
        return False
    if vc.lte is not None and not (count <= vc.lte):
        return False
    if vc.gt is not None and not (count > vc.gt):
        return False
    if vc.gte is not None and not (count >= vc.gte):
        return False
    return True


def _field_condition_matches_values(
    cond: FieldCondition, values: List[Any], payload: Dict[str, Any]
) -> bool:
    m = cond.match
    if m is not None:
        if isinstance(m, MatchValue):
            return m.value in values
        if isinstance(m, MatchAny):
            return any(v in m.any for v in values)
        if isinstance(m, MatchExcept):
            return not any(v in m.except_ for v in values)
        if isinstance(m, MatchText):
            params = PayloadIndexParams(type=PayloadSchemaType.TEXT)
            q = set(tokenize(m.text, params))
            for v in values:
                if isinstance(v, str) and q.issubset(set(tokenize(v, params))):
                    return True
            return False
        if isinstance(m, MatchPhrase):
            params = PayloadIndexParams(type=PayloadSchemaType.TEXT)
            toks = tokenize(m.phrase, params)
            for v in values:
                if not isinstance(v, str):
                    continue
                doc = tokenize(v, params)
                for i in range(len(doc) - len(toks) + 1):
                    if doc[i : i + len(toks)] == toks:
                        return True
            return False
    if cond.range is not None:
        r = cond.range
        for v in values:
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            ok = True
            if r.gt is not None and not v > r.gt:
                ok = False
            if r.gte is not None and not v >= r.gte:
                ok = False
            if r.lt is not None and not v < r.lt:
                ok = False
            if r.lte is not None and not v <= r.lte:
                ok = False
            if ok:
                return True
        return False
    if cond.datetime_range is not None:
        r = cond.datetime_range
        gt = parse_datetime(r.gt) if r.gt else None
        gte = parse_datetime(r.gte) if r.gte else None
        lt = parse_datetime(r.lt) if r.lt else None
        lte = parse_datetime(r.lte) if r.lte else None
        for v in values:
            ts = parse_datetime(v)
            if ts is None:
                continue
            ok = True
            if gt is not None and not ts > gt:
                ok = False
            if gte is not None and not ts >= gte:
                ok = False
            if lt is not None and not ts < lt:
                ok = False
            if lte is not None and not ts <= lte:
                ok = False
            if ok:
                return True
        return False
    if cond.geo_bounding_box or cond.geo_radius or cond.geo_polygon:
        raw_values = json_path.get_values(payload, cond.key)
        geo_pts = []
        for v in _flatten_values(raw_values):
            pt = GeoIndex._parse_geo(v)
            if pt:
                geo_pts.append(pt)
        if not geo_pts:
            return False
        lons = np.asarray([p[0] for p in geo_pts])
        lats = np.asarray([p[1] for p in geo_pts])
        if cond.geo_bounding_box:
            bb = cond.geo_bounding_box
            tl_lon, tl_lat = bb.top_left
            br_lon, br_lat = bb.bottom_right
            lat_ok = (lats <= tl_lat) & (lats >= br_lat)
            if tl_lon <= br_lon:
                lon_ok = (lons >= tl_lon) & (lons <= br_lon)
            else:
                lon_ok = (lons >= tl_lon) | (lons <= br_lon)
            return bool(np.any(lat_ok & lon_ok))
        if cond.geo_radius:
            gr = cond.geo_radius
            lat1 = np.radians(lats)
            lat2 = math.radians(gr.center[1])
            dlat = lat1 - lat2
            dlon = np.radians(lons - gr.center[0])
            a = (
                np.sin(dlat / 2) ** 2
                + np.cos(lat1) * math.cos(lat2) * np.sin(dlon / 2) ** 2
            )
            dist = 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0, 1)))
            return bool(np.any(dist <= gr.radius))
        if cond.geo_polygon:
            gp = cond.geo_polygon
            inside = _points_in_ring(lons, lats, gp.exterior)
            for ring in gp.interiors:
                inside &= ~_points_in_ring(lons, lats, ring)
            return bool(np.any(inside))
    if cond.values_count is not None:
        return _check_values_count(cond.values_count, len(values))
    if cond.is_empty is not None:
        empty = not any(v is not None for v in values)
        return empty == cond.is_empty
    if cond.is_null is not None:
        has_null = any(v is None for v in values)
        return has_null == cond.is_null
    return False
