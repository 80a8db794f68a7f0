"""OpenAPI 3 schema generated from the live route table.

Reference: src/schema_generator.rs (standalone generator producing the
published openapi.json). Here the spec is derived at runtime from
rest.ROUTES — every registered route appears, with path parameters
extracted from the route regex and request/response shells typed from the
engine's dataclasses where a schema is registered below. Served at
GET /openapi.json.
"""

from __future__ import annotations

import re
from typing import Any, Dict

# request-body schemas for the core endpoints (subset typed fully; every
# other route gets a generic JSON body)
_VECTOR = {"oneOf": [
    {"type": "array", "items": {"type": "number"}},
    {"type": "array", "items": {"type": "array", "items": {"type": "number"}}},
    {"type": "object", "additionalProperties": True},
]}
_FILTER = {"type": "object", "properties": {
    "must": {"type": "array", "items": {"type": "object"}},
    "should": {"type": "array", "items": {"type": "object"}},
    "must_not": {"type": "array", "items": {"type": "object"}},
    "min_should": {"type": "object"},
}}
_SCHEMAS: Dict[str, Dict[str, Any]] = {
    "CreateCollection": {"type": "object", "properties": {
        "vectors": {"type": "object"},
        "sparse_vectors": {"type": "object"},
        "shard_number": {"type": "integer"},
        "replication_factor": {"type": "integer"},
        "on_disk_payload": {"type": "boolean"},
        "hnsw_config": {"type": "object"},
        "optimizers_config": {"type": "object"},
        "wal_config": {"type": "object"},
        "quantization_config": {"type": "object"},
        "strict_mode_config": {"type": "object"},
        "sharding_method": {"type": "string", "enum": ["auto", "custom"]},
    }},
    "UpsertPoints": {"type": "object", "properties": {
        "points": {"type": "array", "items": {"type": "object", "properties": {
            "id": {"oneOf": [{"type": "integer"}, {"type": "string"}]},
            "vector": _VECTOR,
            "payload": {"type": "object"},
        }, "required": ["id"]}},
        "shard_key": {},
    }, "required": ["points"]},
    "SearchRequest": {"type": "object", "properties": {
        "vector": _VECTOR,
        "limit": {"type": "integer", "default": 10},
        "offset": {"type": "integer"},
        "filter": _FILTER,
        "params": {"type": "object"},
        "with_payload": {},
        "with_vector": {},
        "score_threshold": {"type": "number"},
    }, "required": ["vector", "limit"]},
    "QueryRequest": {"type": "object", "properties": {
        "query": {},
        "prefetch": {"type": "array", "items": {"type": "object"}},
        "using": {"type": "string"},
        "filter": _FILTER,
        "limit": {"type": "integer", "default": 10},
        "offset": {"type": "integer"},
        "with_payload": {},
        "with_vector": {},
        "score_threshold": {"type": "number"},
        "lookup_from": {"type": "object"},
        "group_by": {"type": "string"},
        "group_size": {"type": "integer"},
    }},
    "ScrollRequest": {"type": "object", "properties": {
        "offset": {},
        "limit": {"type": "integer", "default": 10},
        "filter": _FILTER,
        "with_payload": {},
        "with_vector": {},
        "order_by": {},
    }},
    "SetPayload": {"type": "object", "properties": {
        "payload": {"type": "object"},
        "points": {"type": "array"},
        "filter": _FILTER,
        "key": {"type": "string"},
    }, "required": ["payload"]},
}

_BODY_SCHEMA_BY_SUFFIX = [
    (r"/collections/[^/]+$", "PUT", "CreateCollection"),
    (r"/points$", "PUT", "UpsertPoints"),
    (r"/points/search$", "POST", "SearchRequest"),
    (r"/points/query$", "POST", "QueryRequest"),
    (r"/points/scroll$", "POST", "ScrollRequest"),
    (r"/points/payload$", "POST", "SetPayload"),
]

_ENVELOPE = {"type": "object", "properties": {
    "result": {},
    "status": {"oneOf": [{"type": "string"}, {"type": "object"}]},
    "time": {"type": "number"},
    "usage": {"type": "object"},
}}


def _template_of(pattern: re.Pattern) -> str:
    """Route regex → OpenAPI path template ('/collections/{name}/points')."""
    raw = pattern.pattern.lstrip("^").rstrip("$")
    return re.sub(r"\(\?P<([a-zA-Z_]+)>[^)]*\)", r"{\1}", raw)


def _tag_of(path: str) -> str:
    if path.startswith("/collections") and "/points" in path:
        return "points"
    if path.startswith("/collections") and "snapshots" in path:
        return "snapshots"
    if path.startswith("/collections"):
        return "collections"
    if path.startswith("/cluster") or path.startswith("/internal"):
        return "cluster"
    return "service"


def build_spec(version: str = "dev") -> Dict[str, Any]:
    from .rest import ROUTES

    paths: Dict[str, Dict[str, Any]] = {}
    for method, pattern, handler in ROUTES:
        template = _template_of(pattern)
        op: Dict[str, Any] = {
            "tags": [_tag_of(template)],
            "summary": (handler.__doc__ or handler.__name__.replace("h_", "").replace("_", " ")).strip().split("\n")[0],
            "operationId": f"{method.lower()}_{handler.__name__.replace('h_', '')}_{template.count('{')}",
            "responses": {
                "200": {
                    "description": "operation result envelope",
                    "content": {"application/json": {"schema": _ENVELOPE}},
                },
                "4XX": {"description": "error envelope"},
            },
        }
        params = [
            {
                "name": name,
                "in": "path",
                "required": True,
                "schema": {"type": "string"},
            }
            for name in re.findall(r"\{([a-zA-Z_]+)\}", template)
        ]
        if params:
            op["parameters"] = params
        if method in ("POST", "PUT", "PATCH"):
            schema: Dict[str, Any] = {"type": "object"}
            for suffix, m, name in _BODY_SCHEMA_BY_SUFFIX:
                if m == method and re.search(suffix, template):
                    schema = {"$ref": f"#/components/schemas/{name}"}
                    break
            op["requestBody"] = {
                "content": {"application/json": {"schema": schema}}
            }
        paths.setdefault(template, {})[method.lower()] = op

    return {
        "openapi": "3.0.3",
        "info": {
            "title": "qdrant-tpu API",
            "description": "TPU-native vector search engine; qdrant-compatible API surface.",
            "version": version,
        },
        "paths": paths,
        "components": {"schemas": dict(_SCHEMAS)},
    }
