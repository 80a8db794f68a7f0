"""Core domain types for the TPU-native vector search engine.

Mirrors the *capabilities* of the reference engine's core type system
(reference: lib/segment/src/types.rs) — distances, index/storage configs,
filters and conditions — redesigned for a batched, fixed-shape TPU execution
model rather than translated from the Rust structures.

Conventions:
  * External point ids ("PointId") are u64 ints or UUID strings.
  * Internal offsets ("offset") are dense int32, assigned per segment.
  * All configs are plain dataclasses serializable to/from JSON dicts.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import uuid as _uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

PointId = Union[int, str]

# ---------------------------------------------------------------------------
# Distances (reference: lib/segment/src/types.rs:313 `Distance`)
# ---------------------------------------------------------------------------


class Distance(str, enum.Enum):
    COSINE = "Cosine"
    EUCLID = "Euclid"
    DOT = "Dot"
    MANHATTAN = "Manhattan"

    @property
    def larger_is_better(self) -> bool:
        # Cosine/Dot: similarity (higher better). Euclid/Manhattan: distance
        # (lower better) — internally we always work with "scores" where
        # larger is better, negating distances on the way in/out.
        return self in (Distance.COSINE, Distance.DOT)

    def postprocess(self, score: float) -> float:
        """Convert internal score (larger-is-better) to user-facing score."""
        if self is Distance.EUCLID:
            # internal score = -squared_euclid; user-facing = sqrt distance
            return math.sqrt(max(-score, 0.0))
        if self is Distance.MANHATTAN:
            return -score
        return score


class Datatype(str, enum.Enum):
    """On-device scoring dtype (reference VectorStorageDatatype, types.rs:2039)."""

    FLOAT32 = "float32"
    BFLOAT16 = "bfloat16"
    FLOAT16 = "float16"
    UINT8 = "uint8"


class MultiVectorComparator(str, enum.Enum):
    MAX_SIM = "max_sim"


# ---------------------------------------------------------------------------
# Index & quantization configs (types.rs:783-1323)
# ---------------------------------------------------------------------------


@dataclass
class HnswConfig:
    # Default graph degree 20, NOT the reference's 16 (hnsw_config.rs):
    # the TPU batched beam converges before its iteration budget, so at
    # ef=128 its candidate coverage is capped by graph density alone —
    # measured at 1M clustered: m=16 → 0.948 recall@10, m=20 → 0.958,
    # m=24 → 0.995 (ARCHITECTURE.md, round-4 study). The CPU reference's
    # sequential beam keeps expanding until ef candidates converge, so it
    # tolerates the sparser graph. Users can still set m=16 explicitly.
    m: int = 20
    ef_construct: int = 128
    full_scan_threshold: int = 10_000
    max_indexing_threads: int = 0
    on_disk: bool = False
    payload_m: Optional[int] = None  # per-payload-block subgraph degree

    @property
    def m0(self) -> int:
        return self.m * 2

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Optional[dict]) -> "HnswConfig":
        d = d or {}
        return HnswConfig(**{k: v for k, v in d.items() if k in {f.name for f in dataclasses.fields(HnswConfig)}})


@dataclass
class ScalarQuantizationConfig:
    type: str = "int8"
    quantile: Optional[float] = 0.99
    always_ram: bool = True

    kind: str = field(default="scalar", init=False)


@dataclass
class ProductQuantizationConfig:
    compression: str = "x16"  # x4|x8|x16|x32|x64 — compression ratio vs f32
    always_ram: bool = True

    kind: str = field(default="product", init=False)


@dataclass
class BinaryQuantizationConfig:
    always_ram: bool = True
    encoding: str = "one_bit"  # one_bit | one_and_half_bits | two_bits

    kind: str = field(default="binary", init=False)


@dataclass
class TurboQuantizationConfig:
    """TurboQuant: random-rotation + low-bit Lloyd-Max quantization
    (reference: types.rs:1081-1115 TurboQuantBitSize/TurboQuantization)."""

    bits: str = "bits4"  # bits1 | bits1_5 | bits2 | bits4
    always_ram: bool = True

    kind: str = field(default="turbo", init=False)


QuantizationConfig = Union[
    ScalarQuantizationConfig,
    ProductQuantizationConfig,
    BinaryQuantizationConfig,
    TurboQuantizationConfig,
]


def quantization_config_from_dict(d: Optional[dict]) -> Optional[QuantizationConfig]:
    if not d:
        return None
    if "scalar" in d:
        s = d["scalar"]
        return ScalarQuantizationConfig(
            type=s.get("type", "int8"),
            quantile=s.get("quantile", 0.99),
            always_ram=s.get("always_ram", True),
        )
    if "product" in d:
        p = d["product"]
        return ProductQuantizationConfig(
            compression=p.get("compression", "x16"),
            always_ram=p.get("always_ram", True),
        )
    if "binary" in d:
        b = d["binary"]
        return BinaryQuantizationConfig(
            always_ram=b.get("always_ram", True),
            encoding=b.get("encoding", "one_bit"),
        )
    if "turbo" in d:
        t = d["turbo"]
        return TurboQuantizationConfig(
            bits=t.get("bits", "bits4"),
            always_ram=t.get("always_ram", True),
        )
    raise ValueError(f"unknown quantization config: {d}")


def quantization_config_to_dict(q: Optional[QuantizationConfig]) -> Optional[dict]:
    if q is None:
        return None
    d = {k: v for k, v in dataclasses.asdict(q).items() if k != "kind"}
    return {q.kind: d}


@dataclass
class VectorParams:
    """Per-named-vector config (reference VectorParams, lib/api rest schema)."""

    size: int
    distance: Distance = Distance.COSINE
    datatype: Datatype = Datatype.FLOAT32
    hnsw_config: Optional[HnswConfig] = None
    quantization_config: Optional[QuantizationConfig] = None
    multivector_config: Optional[MultiVectorComparator] = None
    on_disk: bool = False

    def to_dict(self) -> dict:
        return {
            "size": self.size,
            "distance": self.distance.value,
            "datatype": self.datatype.value,
            "hnsw_config": self.hnsw_config.to_dict() if self.hnsw_config else None,
            "quantization_config": quantization_config_to_dict(self.quantization_config),
            "multivector_config": (
                {"comparator": self.multivector_config.value}
                if self.multivector_config
                else None
            ),
            "on_disk": self.on_disk,
        }

    @staticmethod
    def from_dict(d: dict) -> "VectorParams":
        mv = d.get("multivector_config")
        return VectorParams(
            size=int(d["size"]),
            distance=Distance(d.get("distance", "Cosine")),
            datatype=Datatype(d.get("datatype", "float32")),
            hnsw_config=HnswConfig.from_dict(d["hnsw_config"]) if d.get("hnsw_config") else None,
            quantization_config=quantization_config_from_dict(d.get("quantization_config")),
            multivector_config=MultiVectorComparator(mv["comparator"]) if mv else None,
            on_disk=bool(d.get("on_disk", False)),
        )


class SparseIndexType(str, enum.Enum):
    MUTABLE_RAM = "mutable_ram"
    IMMUTABLE_RAM = "immutable_ram"
    MMAP = "mmap"


@dataclass
class SparseVectorParams:
    """Config of a named sparse vector (reference SparseVectorParams)."""

    on_disk: bool = False
    modifier: Optional[str] = None  # None | "idf"
    datatype: Datatype = Datatype.FLOAT32

    def to_dict(self) -> dict:
        return {
            "on_disk": self.on_disk,
            "modifier": self.modifier,
            "datatype": self.datatype.value,
        }

    @staticmethod
    def from_dict(d: dict) -> "SparseVectorParams":
        return SparseVectorParams(
            on_disk=bool(d.get("on_disk", False)),
            modifier=d.get("modifier"),
            datatype=Datatype(d.get("datatype", "float32")),
        )


DEFAULT_VECTOR_NAME = ""  # unnamed default vector, as in the reference


# ---------------------------------------------------------------------------
# Vectors on the wire
# ---------------------------------------------------------------------------

DenseVector = List[float]
MultiVector = List[List[float]]


@dataclass
class SparseVector:
    indices: List[int]
    values: List[float]

    def __post_init__(self):
        if len(self.indices) != len(self.values):
            raise ValueError("sparse vector indices/values length mismatch")

    def to_dict(self) -> dict:
        return {"indices": list(self.indices), "values": list(self.values)}

    @staticmethod
    def from_dict(d: dict) -> "SparseVector":
        return SparseVector(indices=list(d["indices"]), values=list(d["values"]))

    def sorted(self) -> "SparseVector":
        order = sorted(range(len(self.indices)), key=lambda i: self.indices[i])
        return SparseVector(
            [self.indices[i] for i in order], [self.values[i] for i in order]
        )


VectorInput = Union[DenseVector, MultiVector, SparseVector]


@dataclass
class PointStruct:
    id: PointId
    vector: Union[VectorInput, Dict[str, VectorInput]]
    payload: Optional[Dict[str, Any]] = None


def normalize_point_id(pid: Any) -> PointId:
    """Validate and normalize an external point id (u64 or UUID string)."""
    if isinstance(pid, bool):
        raise ValueError(f"invalid point id: {pid!r}")
    if isinstance(pid, int):
        if pid < 0 or pid >= 2**64:
            raise ValueError(f"point id out of u64 range: {pid}")
        return pid
    if isinstance(pid, str):
        try:
            return str(_uuid.UUID(pid))
        except ValueError:
            raise ValueError(f"point id string must be a UUID: {pid!r}")
    raise ValueError(f"invalid point id: {pid!r}")


# ---------------------------------------------------------------------------
# Filters (reference: types.rs:3964 Filter / Condition tower)
# ---------------------------------------------------------------------------


@dataclass
class MatchValue:
    value: Any  # keyword / int / bool


@dataclass
class MatchAny:
    any: List[Any]


@dataclass
class MatchExcept:
    except_: List[Any]


@dataclass
class MatchText:
    text: str


@dataclass
class MatchPhrase:
    phrase: str


Match = Union[MatchValue, MatchAny, MatchExcept, MatchText, MatchPhrase]


@dataclass
class Range:
    lt: Optional[float] = None
    gt: Optional[float] = None
    gte: Optional[float] = None
    lte: Optional[float] = None


@dataclass
class DatetimeRange:
    lt: Optional[str] = None
    gt: Optional[str] = None
    gte: Optional[str] = None
    lte: Optional[str] = None


@dataclass
class GeoBoundingBox:
    top_left: Tuple[float, float]  # (lon, lat)
    bottom_right: Tuple[float, float]


@dataclass
class GeoRadius:
    center: Tuple[float, float]  # (lon, lat)
    radius: float  # meters


@dataclass
class GeoPolygon:
    exterior: List[Tuple[float, float]]
    interiors: List[List[Tuple[float, float]]] = field(default_factory=list)


@dataclass
class ValuesCount:
    lt: Optional[int] = None
    gt: Optional[int] = None
    gte: Optional[int] = None
    lte: Optional[int] = None


@dataclass
class FieldCondition:
    key: str
    match: Optional[Match] = None
    range: Optional[Range] = None
    datetime_range: Optional[DatetimeRange] = None
    geo_bounding_box: Optional[GeoBoundingBox] = None
    geo_radius: Optional[GeoRadius] = None
    geo_polygon: Optional[GeoPolygon] = None
    values_count: Optional[ValuesCount] = None
    is_empty: Optional[bool] = None
    is_null: Optional[bool] = None


@dataclass
class HasIdCondition:
    has_id: List[PointId]


@dataclass
class HasVectorCondition:
    has_vector: str


@dataclass
class IsEmptyCondition:
    is_empty_key: str


@dataclass
class IsNullCondition:
    is_null_key: str


@dataclass
class NestedCondition:
    key: str
    filter: "Filter"


Condition = Union[
    FieldCondition,
    HasIdCondition,
    HasVectorCondition,
    IsEmptyCondition,
    IsNullCondition,
    NestedCondition,
    "Filter",
]


@dataclass
class Filter:
    must: List[Condition] = field(default_factory=list)
    should: List[Condition] = field(default_factory=list)
    must_not: List[Condition] = field(default_factory=list)
    min_should: Optional[Tuple[List[Condition], int]] = None  # (conditions, min_count)

    def is_empty(self) -> bool:
        return not (self.must or self.should or self.must_not or self.min_should)

    @staticmethod
    def merge(a: Optional["Filter"], b: Optional["Filter"]) -> Optional["Filter"]:
        if a is None:
            return b
        if b is None:
            return a
        return Filter(must=[a, b])


def _parse_match(d: dict) -> Match:
    if "value" in d:
        return MatchValue(d["value"])
    if "any" in d:
        return MatchAny(list(d["any"]))
    if "except" in d:
        return MatchExcept(list(d["except"]))
    if "text" in d:
        return MatchText(d["text"])
    if "phrase" in d:
        return MatchPhrase(d["phrase"])
    raise ValueError(f"unknown match: {d}")


def _parse_condition(d: dict) -> Condition:
    if not isinstance(d, dict):
        raise ValueError(f"invalid condition: {d!r}")
    if "has_id" in d:
        return HasIdCondition([normalize_point_id(p) for p in d["has_id"]])
    if "has_vector" in d:
        return HasVectorCondition(d["has_vector"])
    if "is_empty" in d and isinstance(d["is_empty"], dict):
        return IsEmptyCondition(d["is_empty"]["key"])
    if "is_null" in d and isinstance(d["is_null"], dict):
        return IsNullCondition(d["is_null"]["key"])
    if "nested" in d:
        n = d["nested"]
        return NestedCondition(key=n["key"], filter=parse_filter(n["filter"]))
    if "key" in d:
        geo_bb = d.get("geo_bounding_box")
        geo_r = d.get("geo_radius")
        geo_p = d.get("geo_polygon")
        rng = d.get("range")
        dt_rng = d.get("datetime_range")
        # Heuristic matching the reference: a `range` over RFC3339 strings is a
        # datetime range.
        if rng and any(isinstance(v, str) for v in rng.values()):
            dt_rng, rng = rng, None
        return FieldCondition(
            key=d["key"],
            match=_parse_match(d["match"]) if d.get("match") is not None else None,
            range=Range(**rng) if rng else None,
            datetime_range=DatetimeRange(**dt_rng) if dt_rng else None,
            geo_bounding_box=GeoBoundingBox(
                top_left=(geo_bb["top_left"]["lon"], geo_bb["top_left"]["lat"]),
                bottom_right=(
                    geo_bb["bottom_right"]["lon"],
                    geo_bb["bottom_right"]["lat"],
                ),
            )
            if geo_bb
            else None,
            geo_radius=GeoRadius(
                center=(geo_r["center"]["lon"], geo_r["center"]["lat"]),
                radius=geo_r["radius"],
            )
            if geo_r
            else None,
            geo_polygon=GeoPolygon(
                exterior=[(p["lon"], p["lat"]) for p in geo_p["exterior"]["points"]],
                interiors=[
                    [(p["lon"], p["lat"]) for p in ring["points"]]
                    for ring in geo_p.get("interiors", [])
                ],
            )
            if geo_p
            else None,
            values_count=ValuesCount(**d["values_count"]) if d.get("values_count") else None,
            is_empty=d.get("is_empty") if isinstance(d.get("is_empty"), bool) else None,
            is_null=d.get("is_null") if isinstance(d.get("is_null"), bool) else None,
        )
    if any(k in d for k in ("must", "should", "must_not", "min_should")):
        return parse_filter(d)
    raise ValueError(f"unknown condition: {d}")


def parse_filter(d: Optional[dict]) -> Optional[Filter]:
    """Parse a REST-style filter dict into a Filter tree."""
    if d is None:
        return None
    if not isinstance(d, dict):
        raise ValueError(f"invalid filter: {d!r}")

    def _lst(x):
        if x is None:
            return []
        if isinstance(x, dict):
            return [_parse_condition(x)]
        return [_parse_condition(c) for c in x]

    min_should = None
    if d.get("min_should"):
        ms = d["min_should"]
        min_should = (_lst(ms.get("conditions")), int(ms.get("min_count", 1)))
    return Filter(
        must=_lst(d.get("must")),
        should=_lst(d.get("should")),
        must_not=_lst(d.get("must_not")),
        min_should=min_should,
    )


# ---------------------------------------------------------------------------
# Payload field schema (reference PayloadFieldSchema)
# ---------------------------------------------------------------------------


class PayloadSchemaType(str, enum.Enum):
    KEYWORD = "keyword"
    INTEGER = "integer"
    FLOAT = "float"
    GEO = "geo"
    TEXT = "text"
    BOOL = "bool"
    DATETIME = "datetime"
    UUID = "uuid"


@dataclass
class PayloadIndexParams:
    """Extended index params (tokenizer options for text, etc.)."""

    type: PayloadSchemaType = PayloadSchemaType.KEYWORD
    tokenizer: str = "word"  # word | whitespace | prefix | multilingual
    min_token_len: Optional[int] = None
    max_token_len: Optional[int] = None
    lowercase: bool = True
    # fold accented latin to ASCII, e.g. "ação" → "acao"
    # (reference: data_types/index.rs:281 + tokenizers/ascii_folding.rs)
    ascii_folding: bool = False
    stopwords: Optional[str] = None  # language name or None
    stemmer: Optional[str] = None
    on_disk: bool = False
    is_tenant: bool = False
    is_principal: bool = False
    range: bool = True  # integer index: support range queries
    lookup: bool = True  # integer index: support match queries

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["type"] = self.type.value
        return d

    @staticmethod
    def from_dict(d: Union[str, dict]) -> "PayloadIndexParams":
        if isinstance(d, str):
            return PayloadIndexParams(type=PayloadSchemaType(d))
        fields = {f.name for f in dataclasses.fields(PayloadIndexParams)}
        kw = {k: v for k, v in d.items() if k in fields}
        kw["type"] = PayloadSchemaType(d.get("type", "keyword"))
        return PayloadIndexParams(**kw)


# ---------------------------------------------------------------------------
# Search results
# ---------------------------------------------------------------------------


@dataclass
class ScoredPoint:
    id: PointId
    score: float
    version: int = 0
    payload: Optional[Dict[str, Any]] = None
    vector: Optional[Any] = None
    shard_key: Optional[Any] = None
    order_value: Optional[float] = None

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {"id": self.id, "version": self.version, "score": self.score}
        if self.payload is not None:
            d["payload"] = self.payload
        if self.vector is not None:
            d["vector"] = self.vector
        if self.shard_key is not None:
            d["shard_key"] = self.shard_key
        if self.order_value is not None:
            d["order_value"] = self.order_value
        return d


@dataclass
class Record:
    id: PointId
    payload: Optional[Dict[str, Any]] = None
    vector: Optional[Any] = None
    shard_key: Optional[Any] = None

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {"id": self.id}
        if self.payload is not None:
            d["payload"] = self.payload
        if self.vector is not None:
            d["vector"] = self.vector
        if self.shard_key is not None:
            d["shard_key"] = self.shard_key
        return d


# ---------------------------------------------------------------------------
# Collection-level config
# ---------------------------------------------------------------------------


@dataclass
class OptimizersConfig:
    deleted_threshold: float = 0.2
    vacuum_min_vector_number: int = 1000
    default_segment_number: int = 0
    max_segment_size: Optional[int] = None
    indexing_threshold: int = 20_000
    flush_interval_sec: int = 5
    max_optimization_threads: Optional[int] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Optional[dict]) -> "OptimizersConfig":
        d = d or {}
        fields = {f.name for f in dataclasses.fields(OptimizersConfig)}
        return OptimizersConfig(**{k: v for k, v in d.items() if k in fields})


@dataclass
class WalConfig:
    wal_capacity_mb: int = 32
    wal_segments_ahead: int = 0
    # fsync the WAL before acknowledging a write as completed — acknowledged
    # writes survive power loss, not just process crash. Disable for bulk
    # ingest where throughput beats durability.
    wal_sync: bool = True

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Optional[dict]) -> "WalConfig":
        d = d or {}
        fields = {f.name for f in dataclasses.fields(WalConfig)}
        return WalConfig(**{k: v for k, v in d.items() if k in fields})


@dataclass
class StrictModeConfig:
    """Per-collection request limits (reference: types.rs:1323
    StrictModeConfig). Only checks relevant to this engine are enforced."""

    enabled: bool = False
    max_query_limit: Optional[int] = None
    max_timeout: Optional[int] = None
    unindexed_filtering_retrieve: Optional[bool] = None
    unindexed_filtering_update: Optional[bool] = None
    search_max_hnsw_ef: Optional[int] = None
    search_allow_exact: Optional[bool] = None
    search_max_oversampling: Optional[float] = None
    upsert_max_batchsize: Optional[int] = None
    max_points_count: Optional[int] = None
    filter_max_conditions: Optional[int] = None
    condition_max_size: Optional[int] = None
    search_max_batchsize: Optional[int] = None
    # ops per minute per replica (reference: types.rs:1371-1380)
    read_rate_limit: Optional[int] = None
    write_rate_limit: Optional[int] = None
    max_collection_vector_size_bytes: Optional[int] = None
    max_collection_payload_size_bytes: Optional[int] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Optional[dict]) -> "StrictModeConfig":
        d = d or {}
        fields = {f.name for f in dataclasses.fields(StrictModeConfig)}
        return StrictModeConfig(**{k: v for k, v in d.items() if k in fields})


class StrictModeError(Exception):
    status_code = 400


class RateLimitError(StrictModeError):
    status_code = 429


@dataclass
class CollectionParams:
    vectors: Dict[str, VectorParams] = field(default_factory=dict)
    sparse_vectors: Dict[str, SparseVectorParams] = field(default_factory=dict)
    shard_number: int = 1
    sharding_method: Optional[str] = None  # None(auto) | "custom"
    replication_factor: int = 1
    write_consistency_factor: int = 1
    on_disk_payload: bool = False

    def to_dict(self) -> dict:
        return {
            "vectors": {k: v.to_dict() for k, v in self.vectors.items()},
            "sparse_vectors": {k: v.to_dict() for k, v in self.sparse_vectors.items()},
            "shard_number": self.shard_number,
            "sharding_method": self.sharding_method,
            "replication_factor": self.replication_factor,
            "write_consistency_factor": self.write_consistency_factor,
            "on_disk_payload": self.on_disk_payload,
        }

    @staticmethod
    def from_dict(d: dict) -> "CollectionParams":
        return CollectionParams(
            vectors={k: VectorParams.from_dict(v) for k, v in (d.get("vectors") or {}).items()},
            sparse_vectors={
                k: SparseVectorParams.from_dict(v)
                for k, v in (d.get("sparse_vectors") or {}).items()
            },
            shard_number=int(d.get("shard_number", 1)),
            sharding_method=d.get("sharding_method"),
            replication_factor=int(d.get("replication_factor", 1)),
            write_consistency_factor=int(d.get("write_consistency_factor", 1)),
            on_disk_payload=bool(d.get("on_disk_payload", False)),
        )


def parse_vectors_config(d: Any) -> Dict[str, VectorParams]:
    """REST `vectors` field: either a single anonymous config or a name->config map."""
    if d is None:
        return {}
    if "size" in d and isinstance(d.get("size"), int):
        return {DEFAULT_VECTOR_NAME: VectorParams.from_dict(d)}
    return {name: VectorParams.from_dict(cfg) for name, cfg in d.items()}
