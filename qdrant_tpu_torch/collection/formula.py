"""Formula (score-boosting) expression evaluator.

Reference: the Query API's formula rescoring (lib/collection query formula
expressions): arithmetic over $score variables, payload fields, geo distance,
decay functions, and filter conditions evaluated as 0/1.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

from ..index.payload_index import (
    EARTH_RADIUS_M,
    _field_condition_matches_values,
    parse_datetime,
)
from ..types import FieldCondition
from ..utils import json_path


class FormulaError(ValueError):
    pass


def evaluate_formula(
    expr: Any,
    scores: Dict[int, float],  # prefetch index → score for this point
    payload: Dict[str, Any],
    defaults: Optional[Dict[str, Any]] = None,
) -> float:
    defaults = defaults or {}

    def ev(e: Any) -> float:
        if isinstance(e, bool):
            return 1.0 if e else 0.0
        if isinstance(e, (int, float)):
            return float(e)
        if isinstance(e, str):
            return _variable(e, scores, payload, defaults)
        if isinstance(e, dict):
            if "mult" in e:
                out = 1.0
                for sub in e["mult"]:
                    out *= ev(sub)
                return out
            if "sum" in e:
                return sum(ev(sub) for sub in e["sum"])
            if "div" in e:
                spec = e["div"]
                left = ev(spec["left"])
                right = ev(spec["right"])
                if right == 0:
                    if "by_zero_default" in spec:
                        return float(spec["by_zero_default"])
                    raise FormulaError("division by zero")
                return left / right
            if "neg" in e:
                return -ev(e["neg"])
            if "abs" in e:
                return abs(ev(e["abs"]))
            if "sqrt" in e:
                v = ev(e["sqrt"])
                return math.sqrt(v) if v >= 0 else float("nan")
            if "pow" in e:
                return math.pow(ev(e["pow"]["base"]), ev(e["pow"]["exponent"]))
            if "exp" in e:
                return math.exp(ev(e["exp"]))
            if "log10" in e:
                v = ev(e["log10"])
                return math.log10(v) if v > 0 else float("-inf")
            if "ln" in e:
                v = ev(e["ln"])
                return math.log(v) if v > 0 else float("-inf")
            if "datetime" in e:
                ts = parse_datetime(e["datetime"])
                if ts is None:
                    raise FormulaError(f"bad datetime {e['datetime']!r}")
                return float(ts)
            if "datetime_key" in e:
                vals = json_path.get_leaf_values(payload, e["datetime_key"])
                for v in vals:
                    ts = parse_datetime(v)
                    if ts is not None:
                        return float(ts)
                return _default_for(e["datetime_key"], defaults)
            if "geo_distance" in e:
                spec = e["geo_distance"]
                origin = spec["origin"]
                vals = json_path.get_leaf_values(payload, spec["to"])
                vals = json_path.get_values(payload, spec["to"]) or vals
                for v in vals:
                    if isinstance(v, dict) and "lon" in v and "lat" in v:
                        return _haversine(
                            origin["lon"], origin["lat"], v["lon"], v["lat"]
                        )
                return _default_for(spec["to"], defaults)
            for decay, fn in (
                ("exp_decay", _exp_decay),
                ("gauss_decay", _gauss_decay),
                ("lin_decay", _lin_decay),
            ):
                if decay in e:
                    spec = e[decay]
                    x = ev(spec["x"])
                    target = ev(spec.get("target", 0.0))
                    midpoint = float(spec.get("midpoint", 0.5))
                    scale = float(spec.get("scale", 1.0))
                    return fn(x, target, midpoint, scale)
            # otherwise: a filter condition → 0/1
            return 1.0 if _condition_matches(e, payload) else 0.0
        raise FormulaError(f"bad expression: {e!r}")

    return ev(expr)


def _variable(
    name: str,
    scores: Dict[int, float],
    payload: Dict[str, Any],
    defaults: Dict[str, Any],
) -> float:
    if name == "$score":
        if 0 in scores:
            return scores[0]
        return float(defaults.get("$score", 0.0))
    if name.startswith("$score["):
        idx = int(name[7:-1])
        if idx in scores:
            return scores[idx]
        d = defaults.get("$score")
        if isinstance(d, list) and idx < len(d):
            return float(d[idx])
        return float(defaults.get(name, 0.0))
    vals = json_path.get_leaf_values(payload, name)
    for v in vals:
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
    return _default_for(name, defaults)


def _default_for(name: str, defaults: Dict[str, Any]) -> float:
    if name in defaults:
        v = defaults[name]
        if isinstance(v, (int, float)):
            return float(v)
        ts = parse_datetime(v)
        if ts is not None:
            return float(ts)
    raise FormulaError(f"missing value for variable {name!r} and no default")


def _condition_matches(cond_dict: Dict[str, Any], payload: Dict[str, Any]) -> bool:
    from ..types import _parse_condition, Filter as _Filter

    cond = _parse_condition(cond_dict)
    if isinstance(cond, FieldCondition):
        values = json_path.get_leaf_values(payload, cond.key)
        return _field_condition_matches_values(cond, values, payload)
    if isinstance(cond, _Filter):
        from ..index.payload_index import StructPayloadIndex
        from ..storage.payload import PayloadStorage

        ps = PayloadStorage()
        ps.overwrite(0, payload)
        idx = StructPayloadIndex(ps, _DummyTracker())
        mask = idx.filter_mask(cond, 1)
        return bool(mask is None or mask[0])
    raise FormulaError(f"unsupported condition in formula: {cond_dict!r}")


class _DummyTracker:
    def internal_id(self, _):
        return None


def _haversine(lon1, lat1, lon2, lat2) -> float:
    p1, p2 = math.radians(lat1), math.radians(lat2)
    dlat = p2 - p1
    dlon = math.radians(lon2 - lon1)
    a = math.sin(dlat / 2) ** 2 + math.cos(p1) * math.cos(p2) * math.sin(dlon / 2) ** 2
    return 2 * EARTH_RADIUS_M * math.asin(min(1.0, math.sqrt(a)))


def _exp_decay(x, target, midpoint, scale) -> float:
    lam = math.log(midpoint) / scale
    return math.exp(lam * abs(x - target))


def _gauss_decay(x, target, midpoint, scale) -> float:
    lam = math.log(midpoint) / (scale * scale)
    d = x - target
    return math.exp(lam * d * d)


def _lin_decay(x, target, midpoint, scale) -> float:
    slope = (1.0 - midpoint) / scale
    return max(0.0, 1.0 - slope * abs(x - target))
