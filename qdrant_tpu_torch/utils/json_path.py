"""JSON path addressing for payloads: `a.b[0].c`, `a[].b`, `a.b`.

Reference: lib/segment/src/json_path/ (1,479 LoC). Semantics: a path yields
the *list of values* found at that address; arrays encountered without an
explicit index are flattened (any-match semantics for conditions).
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

_COMPONENT_RE = re.compile(r"^(?P<key>[^\[\]]+)?(?P<indexes>(\[\d*\])*)$")


class JsonPathError(ValueError):
    pass


def parse_path(path: str) -> List[Tuple[str, List[Optional[int]]]]:
    """Parse into [(key, [array_indexes...])]; index None = wildcard `[]`."""
    if not path:
        raise JsonPathError("empty path")
    out = []
    for raw in path.split("."):
        m = _COMPONENT_RE.match(raw)
        if not m or (m.group("key") is None and not m.group("indexes")):
            raise JsonPathError(f"bad path component: {raw!r}")
        key = m.group("key")
        idxs: List[Optional[int]] = []
        for part in re.findall(r"\[(\d*)\]", m.group("indexes") or ""):
            idxs.append(int(part) if part else None)
        out.append((key or "", idxs))
    return out


def _descend(values: List[Any], key: str, idxs: List[Optional[int]]) -> List[Any]:
    step: List[Any] = []
    for v in values:
        # auto-flatten arrays of objects when addressing by key
        if key:
            candidates = v if isinstance(v, list) else [v]
            nxt = [c[key] for c in candidates if isinstance(c, dict) and key in c]
        else:
            nxt = [v]
        for idx in idxs:
            flat: List[Any] = []
            for item in nxt:
                if isinstance(item, list):
                    if idx is None:
                        flat.extend(item)
                    elif -len(item) <= idx < len(item):
                        flat.append(item[idx])
            nxt = flat
        step.extend(nxt)
    return step


def get_values(payload: Any, path: str) -> List[Any]:
    """All values at `path` inside `payload` (possibly empty)."""
    values: List[Any] = [payload]
    for key, idxs in parse_path(path):
        values = _descend(values, key, idxs)
        if not values:
            return []
    return values


def get_leaf_values(payload: Any, path: str) -> List[Any]:
    """Like get_values but flattens terminal arrays of scalars (match semantics)."""
    out: List[Any] = []
    for v in get_values(payload, path):
        if isinstance(v, list):
            out.extend(x for x in v if not isinstance(x, (list, dict)))
        else:
            out.append(v)
    return out


def set_value(payload: dict, path: str, value: Any) -> None:
    """Set `value` at `path`, creating intermediate objects (set_payload key=)."""
    comps = parse_path(path)
    cur = payload
    for i, (key, idxs) in enumerate(comps):
        last = i == len(comps) - 1
        if idxs:
            # array addressing in set: only descend existing arrays
            target = cur.get(key) if isinstance(cur, dict) else None
            if not isinstance(target, list):
                if last and not idxs:
                    break
                return  # cannot create through array indexes
            for j, idx in enumerate(idxs):
                terminal = last and j == len(idxs) - 1
                if idx is None:
                    return  # wildcard set unsupported
                if not (-len(target) <= idx < len(target)):
                    return
                if terminal:
                    target[idx] = value
                    return
                target = target[idx]
                if not isinstance(target, (dict, list)):
                    return
            cur = target
        else:
            if last:
                cur[key] = value
            else:
                nxt = cur.get(key)
                if not isinstance(nxt, dict):
                    nxt = {}
                    cur[key] = nxt
                cur = nxt


def delete_path(payload: dict, path: str) -> bool:
    """Delete the value at `path`; returns True if something was removed."""
    comps = parse_path(path)
    cur: Any = payload
    for key, idxs in comps[:-1]:
        if not isinstance(cur, dict) or key not in cur:
            return False
        cur = cur[key]
        for idx in idxs:
            if idx is None or not isinstance(cur, list) or not (
                -len(cur) <= idx < len(cur)
            ):
                return False
            cur = cur[idx]
    key, idxs = comps[-1]
    if idxs:
        if not isinstance(cur, dict) or key not in cur:
            return False
        arr = cur[key]
        if not isinstance(arr, list):
            return False
        idx = idxs[-1]
        if idx is None or not (-len(arr) <= idx < len(arr)):
            return False
        arr.pop(idx)
        return True
    if isinstance(cur, dict) and key in cur:
        del cur[key]
        return True
    return False
