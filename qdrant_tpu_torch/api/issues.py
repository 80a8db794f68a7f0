"""Issues subsystem: engine-detected problems surfaced over the API.

Reference: lib/common/issues (pub-sub issue dashboard) +
lib/collection/src/problems/unindexed_field.rs (slow filtered query on an
unindexed payload field → "create an index" suggestion), wired at
src/issues_setup.rs:9-20. Exposed via GET/DELETE /issues.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List


class IssuesRegistry:
    def __init__(self):
        self._issues: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()

    def submit(self, code: str, description: str, solution: Any = None) -> None:
        with self._lock:
            if code not in self._issues:
                self._issues[code] = {
                    "id": code,
                    "description": description,
                    "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                    "solution": solution,
                }

    def unindexed_field(self, collection: str, field: str) -> None:
        """Filtered query hit an unindexed payload field (reference:
        problems/unindexed_field.rs)."""
        self.submit(
            f"UNINDEXED_FIELD/{collection}/{field}",
            f"Collection '{collection}' is slow to filter by field '{field}', "
            "because the field is not indexed",
            solution={
                "immediate": {
                    "method": "PUT",
                    "uri": f"/collections/{collection}/index",
                    "body": {"field_name": field, "field_schema": "keyword"},
                }
            },
        )

    def list(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._issues.values())

    def clear(self) -> None:
        with self._lock:
            self._issues.clear()


ISSUES = IssuesRegistry()
