"""qdrant-compatible gRPC message schema, built from runtime descriptors.

The image has no `grpc_python_plugin` and a protoc/runtime version mismatch,
so instead of generated *_pb2 modules we construct FileDescriptorProtos at
runtime (protobuf's dynamic message factory). Field numbers and message
shapes follow the reference wire contract (lib/api/src/grpc/proto/
{qdrant_common,json_with_int,points,points_service,collections,
collections_service,health_check}.proto) for the implemented subset —
hand-derived from the API spec, not generated.

Exposes `MESSAGES`: dict full_name → message class.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

from google.protobuf import descriptor_pb2, descriptor_pool, message_factory, timestamp_pb2

F = descriptor_pb2.FieldDescriptorProto

_TYPES = {
    "double": F.TYPE_DOUBLE,
    "float": F.TYPE_FLOAT,
    "int64": F.TYPE_INT64,
    "uint64": F.TYPE_UINT64,
    "int32": F.TYPE_INT32,
    "uint32": F.TYPE_UINT32,
    "bool": F.TYPE_BOOL,
    "string": F.TYPE_STRING,
    "bytes": F.TYPE_BYTES,
}

PKG = "qdrant"


class _Builder:
    def __init__(self, file_name: str):
        self.file = descriptor_pb2.FileDescriptorProto()
        self.file.name = file_name
        self.file.package = PKG
        self.file.syntax = "proto3"
        self.file.dependency.append("google/protobuf/timestamp.proto")

    def enum(self, name: str, values: List[Tuple[str, int]]):
        e = self.file.enum_type.add()
        e.name = name
        for vname, num in values:
            v = e.value.add()
            v.name = vname
            v.number = num

    def message(
        self,
        name: str,
        fields: List[tuple],
        oneofs: Optional[Dict[str, List[str]]] = None,
    ):
        """fields: (name, number, type, label) where type is a scalar name,
        "msg:Name", "enum:Name", or "map:KeyType,ValueType"; label in
        {"optional", "repeated", "proto3opt"}."""
        m = self.file.message_type.add()
        m.name = name
        oneof_index: Dict[str, int] = {}
        for oname in (oneofs or {}):
            oneof_index[oname] = len(m.oneof_decl)
            m.oneof_decl.add().name = oname
        field_oneof = {
            fname: oname for oname, fnames in (oneofs or {}).items() for fname in fnames
        }
        for fname, number, ftype, label in fields:
            fld = m.field.add()
            fld.name = fname
            fld.number = number
            if ftype.startswith("map:"):
                ktype, vtype = ftype[4:].split(",")
                entry = m.nested_type.add()
                entry.name = _camel(fname) + "Entry"
                entry.options.map_entry = True
                k = entry.field.add()
                k.name = "key"
                k.number = 1
                k.type = _TYPES[ktype]
                k.label = F.LABEL_OPTIONAL
                v = entry.field.add()
                v.name = "value"
                v.number = 2
                v.label = F.LABEL_OPTIONAL
                if vtype in _TYPES:
                    v.type = _TYPES[vtype]
                else:
                    v.type = F.TYPE_MESSAGE
                    v.type_name = f".{PKG}.{vtype}"
                fld.type = F.TYPE_MESSAGE
                fld.type_name = f".{PKG}.{name}.{entry.name}"
                fld.label = F.LABEL_REPEATED
                continue
            if ftype.startswith("wkt:"):
                fld.type = F.TYPE_MESSAGE
                fld.type_name = f".google.protobuf.{ftype[4:]}"
            elif ftype.startswith("msg:"):
                fld.type = F.TYPE_MESSAGE
                fld.type_name = f".{PKG}.{ftype[4:]}"
            elif ftype.startswith("enum:"):
                fld.type = F.TYPE_ENUM
                fld.type_name = f".{PKG}.{ftype[5:]}"
            else:
                fld.type = _TYPES[ftype]
            fld.label = F.LABEL_REPEATED if label == "repeated" else F.LABEL_OPTIONAL
            if fname in field_oneof:
                fld.oneof_index = oneof_index[field_oneof[fname]]
            elif label == "proto3opt":
                # proto3 optional = synthetic oneof
                idx = len(m.oneof_decl)
                m.oneof_decl.add().name = f"_{fname}"
                fld.oneof_index = idx
                fld.proto3_optional = True


def _camel(s: str) -> str:
    return "".join(p.capitalize() for p in s.split("_"))


def _build_pool():
    b = _Builder("qdrant_tpu_dynamic.proto")

    # ---- enums ----
    b.enum("NullValue", [("NULL_VALUE", 0)])
    b.enum(
        "Distance",
        [
            ("UnknownDistance", 0),
            ("Cosine", 1),
            ("Euclid", 2),
            ("Dot", 3),
            ("Manhattan", 4),
        ],
    )
    b.enum(
        "UpdateStatus",
        [
            ("UnknownUpdateStatus", 0),
            ("Acknowledged", 1),
            ("Completed", 2),
            ("ClockRejected", 3),
        ],
    )
    b.enum("ShardingMethod", [("Auto", 0), ("Custom", 1)])
    b.enum(
        "CollectionStatus",
        [
            ("UnknownCollectionStatus", 0),
            ("Green", 1),
            ("Yellow", 2),
            ("Red", 3),
            ("Grey", 4),
        ],
    )

    # ---- json values (json_with_int.proto) ----
    b.message("Struct", [("fields", 1, "map:string,Value", "repeated")])
    b.message(
        "Value",
        [
            ("null_value", 1, "enum:NullValue", "optional"),
            ("double_value", 2, "double", "optional"),
            ("integer_value", 3, "int64", "optional"),
            ("string_value", 4, "string", "optional"),
            ("bool_value", 5, "bool", "optional"),
            ("struct_value", 6, "msg:Struct", "optional"),
            ("list_value", 7, "msg:ListValue", "optional"),
        ],
        oneofs={
            "kind": [
                "null_value",
                "double_value",
                "integer_value",
                "string_value",
                "bool_value",
                "struct_value",
                "list_value",
            ]
        },
    )
    b.message("ListValue", [("values", 1, "msg:Value", "repeated")])

    # ---- common (qdrant_common.proto) ----
    b.message(
        "PointId",
        [("num", 1, "uint64", "optional"), ("uuid", 2, "string", "optional")],
        oneofs={"point_id_options": ["num", "uuid"]},
    )
    b.message("GeoPoint", [("lon", 1, "double", "optional"), ("lat", 2, "double", "optional")])
    b.message(
        "Filter",
        [
            ("should", 1, "msg:Condition", "repeated"),
            ("must", 2, "msg:Condition", "repeated"),
            ("must_not", 3, "msg:Condition", "repeated"),
            ("min_should", 4, "msg:MinShould", "proto3opt"),
        ],
    )
    b.message(
        "MinShould",
        [("conditions", 1, "msg:Condition", "repeated"), ("min_count", 2, "uint64", "optional")],
    )
    b.message(
        "Condition",
        [
            ("field", 1, "msg:FieldCondition", "optional"),
            ("is_empty", 2, "msg:IsEmptyCondition", "optional"),
            ("has_id", 3, "msg:HasIdCondition", "optional"),
            ("filter", 4, "msg:Filter", "optional"),
            ("is_null", 5, "msg:IsNullCondition", "optional"),
            ("nested", 6, "msg:NestedCondition", "optional"),
            ("has_vector", 7, "msg:HasVectorCondition", "optional"),
        ],
        oneofs={
            "condition_one_of": [
                "field",
                "is_empty",
                "has_id",
                "filter",
                "is_null",
                "nested",
                "has_vector",
            ]
        },
    )
    b.message("IsEmptyCondition", [("key", 1, "string", "optional")])
    b.message("IsNullCondition", [("key", 1, "string", "optional")])
    b.message("HasIdCondition", [("has_id", 1, "msg:PointId", "repeated")])
    b.message("HasVectorCondition", [("has_vector", 1, "string", "optional")])
    b.message(
        "NestedCondition",
        [("key", 1, "string", "optional"), ("filter", 2, "msg:Filter", "optional")],
    )
    b.message(
        "DatetimeRange",
        [
            ("lt", 1, "wkt:Timestamp", "proto3opt"),
            ("gt", 2, "wkt:Timestamp", "proto3opt"),
            ("gte", 3, "wkt:Timestamp", "proto3opt"),
            ("lte", 4, "wkt:Timestamp", "proto3opt"),
        ],
    )
    b.message(
        "FieldCondition",
        [
            ("key", 1, "string", "optional"),
            ("match", 2, "msg:Match", "optional"),
            ("range", 3, "msg:Range", "optional"),
            ("geo_bounding_box", 4, "msg:GeoBoundingBox", "optional"),
            ("geo_radius", 5, "msg:GeoRadius", "optional"),
            ("values_count", 6, "msg:ValuesCount", "optional"),
            ("geo_polygon", 7, "msg:GeoPolygon", "optional"),
            ("datetime_range", 8, "msg:DatetimeRange", "optional"),
            ("is_empty", 9, "bool", "proto3opt"),
            ("is_null", 10, "bool", "proto3opt"),
        ],
    )
    b.message(
        "Match",
        [
            ("keyword", 1, "string", "optional"),
            ("integer", 2, "int64", "optional"),
            ("boolean", 3, "bool", "optional"),
            ("text", 4, "string", "optional"),
            ("keywords", 5, "msg:RepeatedStrings", "optional"),
            ("integers", 6, "msg:RepeatedIntegers", "optional"),
            ("except_integers", 7, "msg:RepeatedIntegers", "optional"),
            ("except_keywords", 8, "msg:RepeatedStrings", "optional"),
            ("phrase", 9, "string", "optional"),
        ],
        oneofs={
            "match_value": [
                "keyword",
                "integer",
                "boolean",
                "text",
                "keywords",
                "integers",
                "except_integers",
                "except_keywords",
                "phrase",
            ]
        },
    )
    b.message("RepeatedStrings", [("strings", 1, "string", "repeated")])
    b.message("RepeatedIntegers", [("integers", 1, "int64", "repeated")])
    b.message(
        "Range",
        [
            ("lt", 1, "double", "proto3opt"),
            ("gt", 2, "double", "proto3opt"),
            ("gte", 3, "double", "proto3opt"),
            ("lte", 4, "double", "proto3opt"),
        ],
    )
    b.message(
        "GeoBoundingBox",
        [("top_left", 1, "msg:GeoPoint", "optional"), ("bottom_right", 2, "msg:GeoPoint", "optional")],
    )
    b.message(
        "GeoRadius",
        [("center", 1, "msg:GeoPoint", "optional"), ("radius", 2, "float", "optional")],
    )
    b.message("GeoLineString", [("points", 1, "msg:GeoPoint", "repeated")])
    b.message(
        "GeoPolygon",
        [
            ("exterior", 1, "msg:GeoLineString", "optional"),
            ("interiors", 2, "msg:GeoLineString", "repeated"),
        ],
    )
    b.message(
        "ValuesCount",
        [
            ("lt", 1, "uint64", "proto3opt"),
            ("gt", 2, "uint64", "proto3opt"),
            ("gte", 3, "uint64", "proto3opt"),
            ("lte", 4, "uint64", "proto3opt"),
        ],
    )

    # ---- vectors (points.proto) ----
    b.message("DenseVector", [("data", 1, "float", "repeated")])
    b.message(
        "SparseVector",
        [("values", 1, "float", "repeated"), ("indices", 2, "uint32", "repeated")],
    )
    b.message("MultiDenseVector", [("vectors", 1, "msg:DenseVector", "repeated")])
    b.message("SparseIndices", [("data", 1, "uint32", "repeated")])
    for out in ("Vector", "VectorOutput"):
        b.message(
            out,
            [
                ("data", 1, "float", "repeated"),
                ("indices", 2, "msg:SparseIndices", "proto3opt"),
                ("vectors_count", 3, "uint32", "proto3opt"),
                ("dense", 101, "msg:DenseVector", "optional"),
                ("sparse", 102, "msg:SparseVector", "optional"),
                ("multi_dense", 103, "msg:MultiDenseVector", "optional"),
            ],
            oneofs={"vector": ["dense", "sparse", "multi_dense"]},
        )
    b.message("NamedVectors", [("vectors", 1, "map:string,Vector", "repeated")])
    b.message(
        "NamedVectorsOutput", [("vectors", 1, "map:string,VectorOutput", "repeated")]
    )
    b.message(
        "Vectors",
        [("vector", 1, "msg:Vector", "optional"), ("vectors", 2, "msg:NamedVectors", "optional")],
        oneofs={"vectors_options": ["vector", "vectors"]},
    )
    b.message(
        "VectorsOutput",
        [
            ("vector", 1, "msg:VectorOutput", "optional"),
            ("vectors", 2, "msg:NamedVectorsOutput", "optional"),
        ],
        oneofs={"vectors_options": ["vector", "vectors"]},
    )

    # ---- point structures ----
    b.message(
        "PointStruct",
        [
            ("id", 1, "msg:PointId", "optional"),
            ("payload", 3, "map:string,Value", "repeated"),
            ("vectors", 4, "msg:Vectors", "proto3opt"),
        ],
    )
    b.message("PointsIdsList", [("ids", 1, "msg:PointId", "repeated")])
    b.message(
        "PointsSelector",
        [
            ("points", 1, "msg:PointsIdsList", "optional"),
            ("filter", 2, "msg:Filter", "optional"),
        ],
        oneofs={"points_selector_one_of": ["points", "filter"]},
    )
    b.message("PayloadIncludeSelector", [("fields", 1, "string", "repeated")])
    b.message("PayloadExcludeSelector", [("fields", 1, "string", "repeated")])
    b.message(
        "WithPayloadSelector",
        [
            ("enable", 1, "bool", "optional"),
            ("include", 2, "msg:PayloadIncludeSelector", "optional"),
            ("exclude", 3, "msg:PayloadExcludeSelector", "optional"),
        ],
        oneofs={"selector_options": ["enable", "include", "exclude"]},
    )
    b.message("VectorsSelector", [("names", 1, "string", "repeated")])
    b.message(
        "WithVectorsSelector",
        [
            ("enable", 1, "bool", "optional"),
            ("include", 2, "msg:VectorsSelector", "optional"),
        ],
        oneofs={"selector_options": ["enable", "include"]},
    )
    b.message(
        "QuantizationSearchParams",
        [
            ("ignore", 1, "bool", "proto3opt"),
            ("rescore", 2, "bool", "proto3opt"),
            ("oversampling", 3, "double", "proto3opt"),
        ],
    )
    b.message(
        "SearchParams",
        [
            ("hnsw_ef", 1, "uint64", "proto3opt"),
            ("exact", 2, "bool", "proto3opt"),
            ("quantization", 3, "msg:QuantizationSearchParams", "proto3opt"),
            ("indexed_only", 4, "bool", "proto3opt"),
        ],
    )

    # shard routing (reference: points.proto:155-159, collections.proto:1013-1020)
    b.message(
        "ShardKey",
        [("keyword", 1, "string", "optional"), ("number", 2, "uint64", "optional")],
        oneofs={"key": ["keyword", "number"]},
    )
    b.message(
        "ShardKeySelector",
        [
            ("shard_keys", 1, "msg:ShardKey", "repeated"),
            ("fallback", 2, "msg:ShardKey", "optional"),
        ],
    )

    # ---- requests / responses ----
    b.message(
        "UpsertPoints",
        [
            ("collection_name", 1, "string", "optional"),
            ("wait", 2, "bool", "proto3opt"),
            ("points", 3, "msg:PointStruct", "repeated"),
            ("shard_key_selector", 5, "msg:ShardKeySelector", "optional"),
        ],
    )
    b.message(
        "DeletePoints",
        [
            ("collection_name", 1, "string", "optional"),
            ("wait", 2, "bool", "proto3opt"),
            ("points", 3, "msg:PointsSelector", "optional"),
            ("shard_key_selector", 5, "msg:ShardKeySelector", "optional"),
        ],
    )
    b.message(
        "PointVectors",
        [("id", 1, "msg:PointId", "optional"), ("vectors", 2, "msg:Vectors", "optional")],
    )
    b.message(
        "UpdatePointVectors",
        [
            ("collection_name", 1, "string", "optional"),
            ("wait", 2, "bool", "proto3opt"),
            ("points", 3, "msg:PointVectors", "repeated"),
            ("shard_key_selector", 5, "msg:ShardKeySelector", "optional"),
        ],
    )
    b.message(
        "DeletePointVectors",
        [
            ("collection_name", 1, "string", "optional"),
            ("wait", 2, "bool", "proto3opt"),
            ("points_selector", 3, "msg:PointsSelector", "optional"),
            ("vectors", 4, "msg:VectorsSelector", "optional"),
            ("shard_key_selector", 6, "msg:ShardKeySelector", "optional"),
        ],
    )
    b.message(
        "GetPoints",
        [
            ("collection_name", 1, "string", "optional"),
            ("ids", 2, "msg:PointId", "repeated"),
            ("with_payload", 4, "msg:WithPayloadSelector", "optional"),
            ("with_vectors", 5, "msg:WithVectorsSelector", "proto3opt"),
            ("shard_key_selector", 7, "msg:ShardKeySelector", "optional"),
        ],
    )
    b.message(
        "SearchPoints",
        [
            ("collection_name", 1, "string", "optional"),
            ("vector", 2, "float", "repeated"),
            ("filter", 3, "msg:Filter", "optional"),
            ("limit", 4, "uint64", "optional"),
            ("with_payload", 6, "msg:WithPayloadSelector", "optional"),
            ("params", 7, "msg:SearchParams", "optional"),
            ("score_threshold", 8, "float", "proto3opt"),
            ("offset", 9, "uint64", "proto3opt"),
            ("vector_name", 10, "string", "proto3opt"),
            ("with_vectors", 11, "msg:WithVectorsSelector", "proto3opt"),
            ("shard_key_selector", 14, "msg:ShardKeySelector", "optional"),
        ],
    )
    b.message(
        "ScrollPoints",
        [
            ("collection_name", 1, "string", "optional"),
            ("filter", 2, "msg:Filter", "optional"),
            ("offset", 3, "msg:PointId", "proto3opt"),
            ("limit", 4, "uint32", "proto3opt"),
            ("with_payload", 6, "msg:WithPayloadSelector", "optional"),
            ("with_vectors", 7, "msg:WithVectorsSelector", "proto3opt"),
            ("shard_key_selector", 9, "msg:ShardKeySelector", "optional"),
        ],
    )
    b.message(
        "ScrollResponse",
        [
            ("next_page_offset", 1, "msg:PointId", "proto3opt"),
            ("result", 2, "msg:RetrievedPoint", "repeated"),
            ("time", 3, "double", "optional"),
        ],
    )
    b.message(
        "SetPayloadPoints",
        [
            ("collection_name", 1, "string", "optional"),
            ("wait", 2, "bool", "proto3opt"),
            ("payload", 3, "map:string,Value", "repeated"),
            ("points_selector", 5, "msg:PointsSelector", "proto3opt"),
            ("key", 8, "string", "proto3opt"),
            ("shard_key_selector", 7, "msg:ShardKeySelector", "optional"),
        ],
    )
    b.message(
        "DeletePayloadPoints",
        [
            ("collection_name", 1, "string", "optional"),
            ("wait", 2, "bool", "proto3opt"),
            ("keys", 3, "string", "repeated"),
            ("points_selector", 5, "msg:PointsSelector", "proto3opt"),
            ("shard_key_selector", 7, "msg:ShardKeySelector", "optional"),
        ],
    )
    b.message(
        "ClearPayloadPoints",
        [
            ("collection_name", 1, "string", "optional"),
            ("wait", 2, "bool", "proto3opt"),
            ("points", 3, "msg:PointsSelector", "optional"),
            ("shard_key_selector", 5, "msg:ShardKeySelector", "optional"),
        ],
    )
    b.message(
        "CountPoints",
        [
            ("collection_name", 1, "string", "optional"),
            ("filter", 2, "msg:Filter", "optional"),
            ("exact", 3, "bool", "proto3opt"),
            ("shard_key_selector", 5, "msg:ShardKeySelector", "optional"),
        ],
    )
    b.message(
        "UpdateResult",
        [
            ("operation_id", 1, "uint64", "proto3opt"),
            ("status", 2, "enum:UpdateStatus", "optional"),
        ],
    )
    b.message(
        "PointsOperationResponse",
        [("result", 1, "msg:UpdateResult", "optional"), ("time", 2, "double", "optional")],
    )
    b.message(
        "ScoredPoint",
        [
            ("id", 1, "msg:PointId", "optional"),
            ("payload", 2, "map:string,Value", "repeated"),
            ("score", 3, "float", "optional"),
            ("version", 5, "uint64", "optional"),
            ("vectors", 6, "msg:VectorsOutput", "proto3opt"),
        ],
    )
    b.message(
        "SearchResponse",
        [("result", 1, "msg:ScoredPoint", "repeated"), ("time", 2, "double", "optional")],
    )
    b.message(
        "RetrievedPoint",
        [
            ("id", 1, "msg:PointId", "optional"),
            ("payload", 2, "map:string,Value", "repeated"),
            ("vectors", 4, "msg:VectorsOutput", "proto3opt"),
        ],
    )
    b.message(
        "GetResponse",
        [("result", 1, "msg:RetrievedPoint", "repeated"), ("time", 2, "double", "optional")],
    )
    b.message("CountResult", [("count", 1, "uint64", "optional")])
    b.message(
        "CountResponse",
        [("result", 1, "msg:CountResult", "optional"), ("time", 2, "double", "optional")],
    )

    # ---- universal query API (points.proto Query family subset) ----
    b.enum("Fusion", [("RRF", 0), ("DBSF", 1)])
    b.enum("Sample", [("Random", 0)])
    b.enum(
        "RecommendStrategy",
        [("AverageVector", 0), ("BestScore", 1), ("SumScores", 2)],
    )
    b.message(
        "VectorInput",
        [
            ("id", 1, "msg:PointId", "optional"),
            ("dense", 2, "msg:DenseVector", "optional"),
            ("sparse", 3, "msg:SparseVector", "optional"),
            ("multi_dense", 4, "msg:MultiDenseVector", "optional"),
        ],
        oneofs={"variant": ["id", "dense", "sparse", "multi_dense"]},
    )
    b.message(
        "RecommendInput",
        [
            ("positive", 1, "msg:VectorInput", "repeated"),
            ("negative", 2, "msg:VectorInput", "repeated"),
            ("strategy", 3, "enum:RecommendStrategy", "proto3opt"),
        ],
    )
    b.message(
        "ContextInputPair",
        [
            ("positive", 1, "msg:VectorInput", "optional"),
            ("negative", 2, "msg:VectorInput", "optional"),
        ],
    )
    b.message("ContextInput", [("pairs", 1, "msg:ContextInputPair", "repeated")])
    b.message(
        "DiscoverInput",
        [
            ("target", 1, "msg:VectorInput", "optional"),
            ("context", 2, "msg:ContextInput", "optional"),
        ],
    )
    b.message(
        "OrderBy",
        [
            ("key", 1, "string", "optional"),
            ("direction", 2, "enum:Direction", "proto3opt"),
        ],
    )
    b.enum("Direction", [("Asc", 0), ("Desc", 1)])
    b.message(
        "Query",
        [
            ("nearest", 1, "msg:VectorInput", "optional"),
            ("recommend", 2, "msg:RecommendInput", "optional"),
            ("discover", 3, "msg:DiscoverInput", "optional"),
            ("context", 4, "msg:ContextInput", "optional"),
            ("order_by", 5, "msg:OrderBy", "optional"),
            ("fusion", 6, "enum:Fusion", "optional"),
            ("sample", 7, "enum:Sample", "optional"),
        ],
        oneofs={
            "variant": [
                "nearest",
                "recommend",
                "discover",
                "context",
                "order_by",
                "fusion",
                "sample",
            ]
        },
    )
    b.message(
        "PrefetchQuery",
        [
            ("prefetch", 1, "msg:PrefetchQuery", "repeated"),
            ("query", 2, "msg:Query", "proto3opt"),
            ("using", 3, "string", "proto3opt"),
            ("filter", 4, "msg:Filter", "proto3opt"),
            ("params", 5, "msg:SearchParams", "proto3opt"),
            ("score_threshold", 6, "float", "proto3opt"),
            ("limit", 7, "uint64", "proto3opt"),
        ],
    )
    b.message(
        "QueryPoints",
        [
            ("collection_name", 1, "string", "optional"),
            ("prefetch", 2, "msg:PrefetchQuery", "repeated"),
            ("query", 3, "msg:Query", "proto3opt"),
            ("using", 4, "string", "proto3opt"),
            ("filter", 5, "msg:Filter", "proto3opt"),
            ("params", 6, "msg:SearchParams", "proto3opt"),
            ("score_threshold", 7, "float", "proto3opt"),
            ("limit", 8, "uint64", "proto3opt"),
            ("offset", 9, "uint64", "proto3opt"),
            ("with_vectors", 10, "msg:WithVectorsSelector", "proto3opt"),
            ("with_payload", 11, "msg:WithPayloadSelector", "proto3opt"),
            ("shard_key_selector", 13, "msg:ShardKeySelector", "optional"),
        ],
    )
    b.message(
        "QueryResponse",
        [("result", 1, "msg:ScoredPoint", "repeated"), ("time", 2, "double", "optional")],
    )
    b.message("BatchResult", [("result", 1, "msg:ScoredPoint", "repeated")])
    b.message(
        "RecommendPoints",
        [
            ("collection_name", 1, "string", "optional"),
            ("positive", 2, "msg:PointId", "repeated"),
            ("negative", 3, "msg:PointId", "repeated"),
            ("filter", 4, "msg:Filter", "optional"),
            ("limit", 5, "uint64", "optional"),
            ("with_payload", 7, "msg:WithPayloadSelector", "optional"),
            ("params", 8, "msg:SearchParams", "optional"),
            ("score_threshold", 9, "float", "proto3opt"),
            ("offset", 10, "uint64", "proto3opt"),
            ("using", 11, "string", "proto3opt"),
            ("with_vectors", 12, "msg:WithVectorsSelector", "proto3opt"),
            ("strategy", 16, "enum:RecommendStrategy", "proto3opt"),
            ("positive_vectors", 17, "msg:Vector", "repeated"),
            ("negative_vectors", 18, "msg:Vector", "repeated"),
            ("shard_key_selector", 20, "msg:ShardKeySelector", "optional"),
        ],
    )
    b.message(
        "RecommendResponse",
        [("result", 1, "msg:ScoredPoint", "repeated"), ("time", 2, "double", "optional")],
    )
    b.message(
        "SearchBatchPoints",
        [
            ("collection_name", 1, "string", "optional"),
            ("search_points", 2, "msg:SearchPoints", "repeated"),
        ],
    )
    b.message(
        "SearchBatchResponse",
        [("result", 1, "msg:BatchResult", "repeated"), ("time", 2, "double", "optional")],
    )
    b.message(
        "QueryBatchPoints",
        [
            ("collection_name", 1, "string", "optional"),
            ("query_points", 2, "msg:QueryPoints", "repeated"),
        ],
    )
    b.message(
        "QueryBatchResponse",
        [("result", 1, "msg:BatchResult", "repeated"), ("time", 2, "double", "optional")],
    )

    # ---- discover / recommend-batch (points.proto:733-847) ----
    b.message(
        "VectorExample",
        [("id", 1, "msg:PointId", "optional"), ("vector", 2, "msg:Vector", "optional")],
        oneofs={"example": ["id", "vector"]},
    )
    b.message(
        "TargetVector",
        [("single", 1, "msg:VectorExample", "optional")],
        oneofs={"target": ["single"]},
    )
    b.message(
        "ContextExamplePair",
        [
            ("positive", 1, "msg:VectorExample", "optional"),
            ("negative", 2, "msg:VectorExample", "optional"),
        ],
    )
    b.message(
        "LookupLocation",
        [
            ("collection_name", 1, "string", "optional"),
            ("vector_name", 2, "string", "proto3opt"),
            ("shard_key_selector", 3, "msg:ShardKeySelector", "optional"),
        ],
    )
    b.message(
        "DiscoverPoints",
        [
            ("collection_name", 1, "string", "optional"),
            ("target", 2, "msg:TargetVector", "optional"),
            ("context", 3, "msg:ContextExamplePair", "repeated"),
            ("filter", 4, "msg:Filter", "optional"),
            ("limit", 5, "uint64", "optional"),
            ("with_payload", 6, "msg:WithPayloadSelector", "optional"),
            ("params", 7, "msg:SearchParams", "optional"),
            ("offset", 8, "uint64", "proto3opt"),
            ("using", 9, "string", "proto3opt"),
            ("with_vectors", 10, "msg:WithVectorsSelector", "proto3opt"),
            ("lookup_from", 11, "msg:LookupLocation", "proto3opt"),
            ("shard_key_selector", 14, "msg:ShardKeySelector", "optional"),
        ],
    )
    b.message(
        "DiscoverResponse",
        [("result", 1, "msg:ScoredPoint", "repeated"), ("time", 2, "double", "optional")],
    )
    b.message(
        "DiscoverBatchPoints",
        [
            ("collection_name", 1, "string", "optional"),
            ("discover_points", 2, "msg:DiscoverPoints", "repeated"),
        ],
    )
    b.message(
        "DiscoverBatchResponse",
        [("result", 1, "msg:BatchResult", "repeated"), ("time", 2, "double", "optional")],
    )
    b.message(
        "RecommendBatchPoints",
        [
            ("collection_name", 1, "string", "optional"),
            ("recommend_points", 2, "msg:RecommendPoints", "repeated"),
        ],
    )
    b.message(
        "RecommendBatchResponse",
        [("result", 1, "msg:BatchResult", "repeated"), ("time", 2, "double", "optional")],
    )

    # ---- groups (points.proto:576-612, 743-787, 1155-1196, 1425-1448) ----
    b.message(
        "WithLookup",
        [
            ("collection", 1, "string", "optional"),
            ("with_payload", 2, "msg:WithPayloadSelector", "proto3opt"),
            ("with_vectors", 3, "msg:WithVectorsSelector", "proto3opt"),
        ],
    )
    b.message(
        "SearchPointGroups",
        [
            ("collection_name", 1, "string", "optional"),
            ("vector", 2, "float", "repeated"),
            ("filter", 3, "msg:Filter", "optional"),
            ("limit", 4, "uint32", "optional"),
            ("with_payload", 5, "msg:WithPayloadSelector", "optional"),
            ("params", 6, "msg:SearchParams", "optional"),
            ("score_threshold", 7, "float", "proto3opt"),
            ("vector_name", 8, "string", "proto3opt"),
            ("with_vectors", 9, "msg:WithVectorsSelector", "proto3opt"),
            ("group_by", 10, "string", "optional"),
            ("group_size", 11, "uint32", "optional"),
            ("with_lookup", 13, "msg:WithLookup", "proto3opt"),
            ("shard_key_selector", 15, "msg:ShardKeySelector", "optional"),
        ],
    )
    b.message(
        "RecommendPointGroups",
        [
            ("collection_name", 1, "string", "optional"),
            ("positive", 2, "msg:PointId", "repeated"),
            ("negative", 3, "msg:PointId", "repeated"),
            ("filter", 4, "msg:Filter", "optional"),
            ("limit", 5, "uint32", "optional"),
            ("with_payload", 6, "msg:WithPayloadSelector", "optional"),
            ("params", 7, "msg:SearchParams", "optional"),
            ("score_threshold", 8, "float", "proto3opt"),
            ("using", 9, "string", "proto3opt"),
            ("with_vectors", 10, "msg:WithVectorsSelector", "proto3opt"),
            ("lookup_from", 11, "msg:LookupLocation", "proto3opt"),
            ("group_by", 12, "string", "optional"),
            ("group_size", 13, "uint32", "optional"),
            ("with_lookup", 15, "msg:WithLookup", "proto3opt"),
            ("strategy", 17, "enum:RecommendStrategy", "proto3opt"),
            ("positive_vectors", 18, "msg:Vector", "repeated"),
            ("negative_vectors", 19, "msg:Vector", "repeated"),
            ("shard_key_selector", 21, "msg:ShardKeySelector", "optional"),
        ],
    )
    b.message(
        "QueryPointGroups",
        [
            ("collection_name", 1, "string", "optional"),
            ("prefetch", 2, "msg:PrefetchQuery", "repeated"),
            ("query", 3, "msg:Query", "proto3opt"),
            ("using", 4, "string", "proto3opt"),
            ("filter", 5, "msg:Filter", "proto3opt"),
            ("params", 6, "msg:SearchParams", "proto3opt"),
            ("score_threshold", 7, "float", "proto3opt"),
            ("with_payload", 8, "msg:WithPayloadSelector", "optional"),
            ("with_vectors", 9, "msg:WithVectorsSelector", "proto3opt"),
            ("lookup_from", 10, "msg:LookupLocation", "proto3opt"),
            ("limit", 11, "uint64", "proto3opt"),
            ("group_size", 12, "uint64", "proto3opt"),
            ("group_by", 13, "string", "optional"),
            ("with_lookup", 15, "msg:WithLookup", "proto3opt"),
            ("shard_key_selector", 17, "msg:ShardKeySelector", "optional"),
        ],
    )
    b.message(
        "GroupId",
        [
            ("unsigned_value", 1, "uint64", "optional"),
            ("integer_value", 2, "int64", "optional"),
            ("string_value", 3, "string", "optional"),
        ],
        oneofs={"kind": ["unsigned_value", "integer_value", "string_value"]},
    )
    b.message(
        "PointGroup",
        [
            ("id", 1, "msg:GroupId", "optional"),
            ("hits", 2, "msg:ScoredPoint", "repeated"),
            ("lookup", 3, "msg:RetrievedPoint", "optional"),
        ],
    )
    b.message("GroupsResult", [("groups", 1, "msg:PointGroup", "repeated")])
    for n in ("SearchGroupsResponse", "RecommendGroupsResponse", "QueryGroupsResponse"):
        b.message(
            n,
            [
                ("result", 1, "msg:GroupsResult", "optional"),
                ("time", 2, "double", "optional"),
            ],
        )

    # ---- facets (points.proto:1197-1232) ----
    b.message(
        "FacetCounts",
        [
            ("collection_name", 1, "string", "optional"),
            ("key", 2, "string", "optional"),
            ("filter", 3, "msg:Filter", "proto3opt"),
            ("limit", 4, "uint64", "proto3opt"),
            ("exact", 5, "bool", "proto3opt"),
            ("shard_key_selector", 8, "msg:ShardKeySelector", "optional"),
        ],
    )
    b.message(
        "FacetValue",
        [
            ("string_value", 1, "string", "optional"),
            ("integer_value", 2, "int64", "optional"),
            ("bool_value", 3, "bool", "optional"),
        ],
        oneofs={"variant": ["string_value", "integer_value", "bool_value"]},
    )
    b.message(
        "FacetHit",
        [("value", 1, "msg:FacetValue", "optional"), ("count", 2, "uint64", "optional")],
    )
    b.message(
        "FacetResponse",
        [("hits", 1, "msg:FacetHit", "repeated"), ("time", 2, "double", "optional")],
    )

    # ---- distance matrix (points.proto:1234-1276) ----
    b.message(
        "SearchMatrixPoints",
        [
            ("collection_name", 1, "string", "optional"),
            ("filter", 2, "msg:Filter", "proto3opt"),
            ("sample", 3, "uint64", "proto3opt"),
            ("limit", 4, "uint64", "proto3opt"),
            ("using", 5, "string", "proto3opt"),
            ("shard_key_selector", 8, "msg:ShardKeySelector", "optional"),
        ],
    )
    b.message(
        "SearchMatrixPair",
        [
            ("a", 1, "msg:PointId", "optional"),
            ("b", 2, "msg:PointId", "optional"),
            ("score", 3, "float", "optional"),
        ],
    )
    b.message("SearchMatrixPairs", [("pairs", 1, "msg:SearchMatrixPair", "repeated")])
    b.message(
        "SearchMatrixOffsets",
        [
            ("offsets_row", 1, "uint64", "repeated"),
            ("offsets_col", 2, "uint64", "repeated"),
            ("scores", 3, "float", "repeated"),
            ("ids", 4, "msg:PointId", "repeated"),
        ],
    )
    b.message(
        "SearchMatrixPairsResponse",
        [
            ("result", 1, "msg:SearchMatrixPairs", "optional"),
            ("time", 2, "double", "optional"),
        ],
    )
    b.message(
        "SearchMatrixOffsetsResponse",
        [
            ("result", 1, "msg:SearchMatrixOffsets", "optional"),
            ("time", 2, "double", "optional"),
        ],
    )

    # ---- batch update (points.proto:1278-1366; nested operation messages
    # are modeled as top-level types — wire format is identical) ----
    b.message(
        "PointStructList",
        [("points", 1, "msg:PointStruct", "repeated")],
    )
    b.message(
        "SetPayloadOp",
        [
            ("payload", 1, "map:string,Value", "repeated"),
            ("points_selector", 2, "msg:PointsSelector", "proto3opt"),
            ("key", 4, "string", "proto3opt"),
        ],
    )
    b.message(
        "DeletePayloadOp",
        [
            ("keys", 1, "string", "repeated"),
            ("points_selector", 2, "msg:PointsSelector", "proto3opt"),
        ],
    )
    b.message("UpdateVectorsOp", [("points", 1, "msg:PointVectors", "repeated")])
    b.message(
        "DeleteVectorsOp",
        [
            ("points_selector", 1, "msg:PointsSelector", "optional"),
            ("vectors", 2, "msg:VectorsSelector", "optional"),
        ],
    )
    b.message("DeletePointsOp", [("points", 1, "msg:PointsSelector", "optional")])
    b.message("ClearPayloadOp", [("points", 1, "msg:PointsSelector", "optional")])
    b.message(
        "PointsUpdateOperation",
        [
            ("upsert", 1, "msg:PointStructList", "optional"),
            ("delete_deprecated", 2, "msg:PointsSelector", "optional"),
            ("set_payload", 3, "msg:SetPayloadOp", "optional"),
            ("overwrite_payload", 4, "msg:SetPayloadOp", "optional"),
            ("delete_payload", 5, "msg:DeletePayloadOp", "optional"),
            ("clear_payload_deprecated", 6, "msg:PointsSelector", "optional"),
            ("update_vectors", 7, "msg:UpdateVectorsOp", "optional"),
            ("delete_vectors", 8, "msg:DeleteVectorsOp", "optional"),
            ("delete_points", 9, "msg:DeletePointsOp", "optional"),
            ("clear_payload", 10, "msg:ClearPayloadOp", "optional"),
        ],
        oneofs={
            "operation": [
                "upsert", "delete_deprecated", "set_payload", "overwrite_payload",
                "delete_payload", "clear_payload_deprecated", "update_vectors",
                "delete_vectors", "delete_points", "clear_payload",
            ]
        },
    )
    b.message(
        "UpdateBatchPoints",
        [
            ("collection_name", 1, "string", "optional"),
            ("wait", 2, "bool", "proto3opt"),
            ("operations", 3, "msg:PointsUpdateOperation", "repeated"),
        ],
    )
    b.message(
        "UpdateBatchResponse",
        [("result", 1, "msg:UpdateResult", "repeated"), ("time", 2, "double", "optional")],
    )

    # ---- collection update diffs (collections.proto:229-331, 575-596) ----
    b.message(
        "HnswConfigDiff",
        [
            ("m", 1, "uint64", "proto3opt"),
            ("ef_construct", 2, "uint64", "proto3opt"),
            ("full_scan_threshold", 3, "uint64", "proto3opt"),
            ("payload_m", 6, "uint64", "proto3opt"),
        ],
    )
    b.message(
        "OptimizersConfigDiff",
        [
            ("deleted_threshold", 1, "double", "proto3opt"),
            ("vacuum_min_vector_number", 2, "uint64", "proto3opt"),
            ("default_segment_number", 3, "uint64", "proto3opt"),
            ("indexing_threshold", 6, "uint64", "proto3opt"),
            ("flush_interval_sec", 7, "uint64", "proto3opt"),
        ],
    )
    b.message(
        "UpdateCollection",
        [
            ("collection_name", 1, "string", "optional"),
            ("optimizers_config", 2, "msg:OptimizersConfigDiff", "proto3opt"),
            ("hnsw_config", 5, "msg:HnswConfigDiff", "proto3opt"),
        ],
    )

    # ---- collections (collections.proto subset) ----
    b.message("GetCollectionInfoRequest", [("collection_name", 1, "string", "optional")])
    b.message("CollectionExistsRequest", [("collection_name", 1, "string", "optional")])
    b.message("CollectionExists", [("exists", 1, "bool", "optional")])
    b.message(
        "CollectionExistsResponse",
        [("result", 1, "msg:CollectionExists", "optional"), ("time", 2, "double", "optional")],
    )
    b.message("ListCollectionsRequest", [])
    b.message("CollectionDescription", [("name", 1, "string", "optional")])
    b.message(
        "ListCollectionsResponse",
        [
            ("collections", 1, "msg:CollectionDescription", "repeated"),
            ("time", 2, "double", "optional"),
        ],
    )
    b.message(
        "CollectionInfo",
        [
            ("status", 1, "enum:CollectionStatus", "optional"),
            ("segments_count", 4, "uint64", "optional"),
            ("points_count", 9, "uint64", "proto3opt"),
            ("indexed_vectors_count", 10, "uint64", "proto3opt"),
        ],
    )
    b.message(
        "GetCollectionInfoResponse",
        [("result", 1, "msg:CollectionInfo", "optional"), ("time", 2, "double", "optional")],
    )
    b.message(
        "VectorParams",
        [
            ("size", 1, "uint64", "optional"),
            ("distance", 2, "enum:Distance", "optional"),
        ],
    )
    b.message("VectorParamsMap", [("map", 1, "map:string,VectorParams", "repeated")])
    b.message(
        "VectorsConfig",
        [
            ("params", 1, "msg:VectorParams", "optional"),
            ("params_map", 2, "msg:VectorParamsMap", "optional"),
        ],
        oneofs={"config": ["params", "params_map"]},
    )
    b.message(
        "CreateCollection",
        [
            ("collection_name", 1, "string", "optional"),
            ("shard_number", 7, "uint32", "proto3opt"),
            ("vectors_config", 10, "msg:VectorsConfig", "proto3opt"),
            ("replication_factor", 11, "uint32", "proto3opt"),
            ("sharding_method", 15, "enum:ShardingMethod", "proto3opt"),
        ],
    )
    # custom shard keys (reference: collections.proto:1147-1224)
    b.message(
        "CreateShardKey",
        [
            ("shard_key", 1, "msg:ShardKey", "optional"),
            ("shards_number", 2, "uint32", "proto3opt"),
            ("replication_factor", 3, "uint32", "proto3opt"),
        ],
    )
    b.message(
        "CreateShardKeyRequest",
        [
            ("collection_name", 1, "string", "optional"),
            ("request", 2, "msg:CreateShardKey", "optional"),
            ("timeout", 3, "uint64", "proto3opt"),
        ],
    )
    b.message(
        "DeleteShardKey",
        [("shard_key", 1, "msg:ShardKey", "optional")],
    )
    b.message(
        "DeleteShardKeyRequest",
        [
            ("collection_name", 1, "string", "optional"),
            ("request", 2, "msg:DeleteShardKey", "optional"),
            ("timeout", 3, "uint64", "proto3opt"),
        ],
    )
    b.message(
        "CreateShardKeyResponse",
        [("result", 1, "bool", "optional"), ("time", 2, "double", "optional")],
    )
    b.message(
        "DeleteShardKeyResponse",
        [("result", 1, "bool", "optional"), ("time", 2, "double", "optional")],
    )
    b.message("DeleteCollection", [("collection_name", 1, "string", "optional")])
    b.message(
        "CollectionOperationResponse",
        [("result", 1, "bool", "optional"), ("time", 2, "double", "optional")],
    )

    # ---- aliases + field index management ----
    b.message(
        "CreateAlias",
        [("collection_name", 1, "string", "optional"), ("alias_name", 2, "string", "optional")],
    )
    b.message(
        "RenameAlias",
        [
            ("old_alias_name", 1, "string", "optional"),
            ("new_alias_name", 2, "string", "optional"),
        ],
    )
    b.message("DeleteAlias", [("alias_name", 1, "string", "optional")])
    b.message(
        "AliasOperations",
        [
            ("create_alias", 1, "msg:CreateAlias", "optional"),
            ("rename_alias", 2, "msg:RenameAlias", "optional"),
            ("delete_alias", 3, "msg:DeleteAlias", "optional"),
        ],
        oneofs={"action": ["create_alias", "rename_alias", "delete_alias"]},
    )
    b.message("ChangeAliases", [("actions", 1, "msg:AliasOperations", "repeated")])
    b.message("ListAliasesRequest", [])
    b.message(
        "ListCollectionAliasesRequest", [("collection_name", 1, "string", "optional")]
    )
    b.message(
        "AliasDescription",
        [("alias_name", 1, "string", "optional"), ("collection_name", 2, "string", "optional")],
    )
    b.message(
        "ListAliasesResponse",
        [("aliases", 1, "msg:AliasDescription", "repeated"), ("time", 2, "double", "optional")],
    )
    b.enum(
        "FieldType",
        [
            ("FieldTypeKeyword", 0),
            ("FieldTypeInteger", 1),
            ("FieldTypeFloat", 2),
            ("FieldTypeGeo", 3),
            ("FieldTypeText", 4),
            ("FieldTypeBool", 5),
            ("FieldTypeDatetime", 6),
            ("FieldTypeUuid", 7),
        ],
    )
    b.message(
        "CreateFieldIndexCollection",
        [
            ("collection_name", 1, "string", "optional"),
            ("wait", 2, "bool", "proto3opt"),
            ("field_name", 3, "string", "optional"),
            ("field_type", 4, "enum:FieldType", "proto3opt"),
        ],
    )
    b.message(
        "DeleteFieldIndexCollection",
        [
            ("collection_name", 1, "string", "optional"),
            ("wait", 2, "bool", "proto3opt"),
            ("field_name", 3, "string", "optional"),
        ],
    )

    # ---- snapshots (snapshots_service.proto) ----
    b.message("CreateSnapshotRequest", [("collection_name", 1, "string", "optional")])
    b.message("ListSnapshotsRequest", [("collection_name", 1, "string", "optional")])
    b.message(
        "DeleteSnapshotRequest",
        [
            ("collection_name", 1, "string", "optional"),
            ("snapshot_name", 2, "string", "optional"),
        ],
    )
    b.message("CreateFullSnapshotRequest", [])
    b.message("ListFullSnapshotsRequest", [])
    b.message(
        "DeleteFullSnapshotRequest", [("snapshot_name", 1, "string", "optional")]
    )
    b.message(
        "SnapshotDescription",
        [
            ("name", 1, "string", "optional"),
            ("creation_time", 2, "wkt:Timestamp", "optional"),
            ("size", 3, "int64", "optional"),
            ("checksum", 4, "string", "proto3opt"),
        ],
    )
    b.message(
        "CreateSnapshotResponse",
        [
            ("snapshot_description", 1, "msg:SnapshotDescription", "optional"),
            ("time", 2, "double", "optional"),
        ],
    )
    b.message(
        "ListSnapshotsResponse",
        [
            ("snapshot_descriptions", 1, "msg:SnapshotDescription", "repeated"),
            ("time", 2, "double", "optional"),
        ],
    )
    b.message("DeleteSnapshotResponse", [("time", 1, "double", "optional")])

    # ---- shard snapshots (shard_snapshots_service.proto) ----
    b.message(
        "CreateShardSnapshotRequest",
        [
            ("collection_name", 1, "string", "optional"),
            ("shard_id", 2, "uint32", "optional"),
        ],
    )
    b.message(
        "ListShardSnapshotsRequest",
        [
            ("collection_name", 1, "string", "optional"),
            ("shard_id", 2, "uint32", "optional"),
        ],
    )
    b.message(
        "DeleteShardSnapshotRequest",
        [
            ("collection_name", 1, "string", "optional"),
            ("shard_id", 2, "uint32", "optional"),
            ("snapshot_name", 3, "string", "optional"),
        ],
    )
    b.message(
        "ShardSnapshotLocation",
        [
            ("url", 1, "string", "optional"),
            ("path", 2, "string", "optional"),
        ],
        oneofs={"location": ["url", "path"]},
    )
    b.message(
        "RecoverShardSnapshotRequest",
        [
            ("collection_name", 1, "string", "optional"),
            ("shard_id", 2, "uint32", "optional"),
            ("snapshot_location", 3, "msg:ShardSnapshotLocation", "optional"),
            ("snapshot_priority", 4, "int32", "optional"),
            ("checksum", 5, "string", "proto3opt"),
            ("api_key", 6, "string", "proto3opt"),
        ],
    )
    b.message("RecoverSnapshotResponse", [("time", 1, "double", "optional")])

    # ---- health (health_check.proto / qdrant.proto) ----
    b.message("HealthCheckRequest", [])
    b.message(
        "HealthCheckReply",
        [
            ("title", 1, "string", "optional"),
            ("version", 2, "string", "optional"),
            ("commit", 3, "string", "proto3opt"),
        ],
    )

    pool = descriptor_pool.DescriptorPool()
    ts = descriptor_pb2.FileDescriptorProto()
    timestamp_pb2.DESCRIPTOR.CopyToProto(ts)
    pool.Add(ts)
    pool.Add(b.file)
    return pool


_POOL = _build_pool()

_MESSAGE_NAMES = [
    "Struct", "Value", "ListValue", "PointId", "GeoPoint", "Filter", "MinShould",
    "Condition", "IsEmptyCondition", "IsNullCondition", "HasIdCondition",
    "HasVectorCondition", "NestedCondition", "FieldCondition", "Match",
    "RepeatedStrings", "RepeatedIntegers", "Range", "DatetimeRange",
    "GeoBoundingBox", "GeoRadius",
    "GeoLineString", "GeoPolygon", "ValuesCount", "DenseVector", "SparseVector",
    "MultiDenseVector", "SparseIndices", "Vector", "VectorOutput", "NamedVectors",
    "NamedVectorsOutput", "Vectors", "VectorsOutput", "PointStruct", "PointsIdsList",
    "PointsSelector", "PayloadIncludeSelector", "PayloadExcludeSelector",
    "WithPayloadSelector", "VectorsSelector", "WithVectorsSelector",
    "QuantizationSearchParams", "SearchParams", "ShardKey", "ShardKeySelector",
    "UpsertPoints", "DeletePoints",
    "GetPoints", "SearchPoints", "CountPoints", "ScrollPoints", "ScrollResponse",
    "SetPayloadPoints", "DeletePayloadPoints", "ClearPayloadPoints", "UpdateResult",
    "PointsOperationResponse", "ScoredPoint", "SearchResponse", "RetrievedPoint",
    "GetResponse", "CountResult", "CountResponse", "GetCollectionInfoRequest",
    "CollectionExistsRequest", "CollectionExists", "CollectionExistsResponse",
    "ListCollectionsRequest", "CollectionDescription", "ListCollectionsResponse",
    "VectorInput", "RecommendInput", "ContextInputPair", "ContextInput",
    "DiscoverInput", "OrderBy", "Query", "PrefetchQuery", "QueryPoints",
    "QueryResponse", "BatchResult", "SearchBatchPoints", "SearchBatchResponse",
    "RecommendPoints", "RecommendResponse", "CreateAlias", "RenameAlias",
    "DeleteAlias", "AliasOperations", "ChangeAliases", "ListAliasesRequest",
    "ListCollectionAliasesRequest", "AliasDescription", "ListAliasesResponse",
    "CreateFieldIndexCollection", "DeleteFieldIndexCollection",
    "PointVectors", "UpdatePointVectors", "DeletePointVectors",
    "CreateSnapshotRequest", "ListSnapshotsRequest", "DeleteSnapshotRequest",
    "CreateFullSnapshotRequest", "ListFullSnapshotsRequest",
    "DeleteFullSnapshotRequest", "SnapshotDescription",
    "CreateSnapshotResponse", "ListSnapshotsResponse", "DeleteSnapshotResponse",
    "CreateShardSnapshotRequest", "ListShardSnapshotsRequest",
    "DeleteShardSnapshotRequest", "ShardSnapshotLocation",
    "RecoverShardSnapshotRequest", "RecoverSnapshotResponse",
    "QueryBatchPoints", "QueryBatchResponse",
    "CollectionInfo", "GetCollectionInfoResponse", "VectorParams", "VectorParamsMap",
    "VectorsConfig", "CreateCollection", "DeleteCollection",
    "CreateShardKey", "CreateShardKeyRequest", "CreateShardKeyResponse",
    "DeleteShardKey", "DeleteShardKeyRequest", "DeleteShardKeyResponse",
    "CollectionOperationResponse", "HealthCheckRequest", "HealthCheckReply",
    "VectorExample", "TargetVector", "ContextExamplePair", "LookupLocation",
    "DiscoverPoints", "DiscoverResponse", "DiscoverBatchPoints",
    "DiscoverBatchResponse", "RecommendBatchPoints", "RecommendBatchResponse",
    "WithLookup", "SearchPointGroups", "RecommendPointGroups",
    "QueryPointGroups", "GroupId", "PointGroup", "GroupsResult",
    "SearchGroupsResponse", "RecommendGroupsResponse", "QueryGroupsResponse",
    "FacetCounts", "FacetValue", "FacetHit", "FacetResponse",
    "SearchMatrixPoints", "SearchMatrixPair", "SearchMatrixPairs",
    "SearchMatrixOffsets", "SearchMatrixPairsResponse",
    "SearchMatrixOffsetsResponse", "PointStructList", "SetPayloadOp",
    "DeletePayloadOp", "UpdateVectorsOp", "DeleteVectorsOp", "DeletePointsOp",
    "ClearPayloadOp", "PointsUpdateOperation", "UpdateBatchPoints",
    "UpdateBatchResponse", "HnswConfigDiff", "OptimizersConfigDiff",
    "UpdateCollection",
]

MESSAGES: Dict[str, type] = {
    name: message_factory.GetMessageClass(
        _POOL.FindMessageTypeByName(f"{PKG}.{name}")
    )
    for name in _MESSAGE_NAMES
}
