"""Runtime feature flags.

Reference: lib/common/common/src/flags.rs — a process-global FeatureFlags
struct initialized once from config (plus an `all` switch that turns every
experimental flag on). The flags here gate this engine's own experimental
paths; each still honors its QDRANT_TPU_* env override for ad-hoc runs.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class FeatureFlags:
    # turn every experimental flag on (flags.rs `all`)
    all: bool = False
    # fused Pallas scan+rescore kernel instead of the XLA scan+rescore
    # program. Default ON: one compiled program (scan in VMEM + exact f32
    # rescore) measures 29 ms vs the XLA path's 45 ms per 2,048-query batch
    # at 1M x 128 pipelined depth-8 (v5e; the XLA formulation is HBM-bound
    # on its [B, blk] f32 score block round-trip)
    pallas_scan: bool = True
    # chunk EVERY sparse posting through the SpMV (exact scores, slower)
    sparse_exact_search: bool = False
    # coalesce concurrent single-query searches into one device batch
    micro_batching: bool = True
    # fully device-resident HNSW construction
    hnsw_device_build: bool = True

    def resolve(self) -> "FeatureFlags":
        if not self.all:
            return self
        return dataclasses.replace(
            self, pallas_scan=True, sparse_exact_search=True
        )

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "FeatureFlags":
        d = d or {}
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: bool(v) for k, v in d.items() if k in fields})

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_FLAGS: Optional[FeatureFlags] = None


def init_feature_flags(d: Optional[dict]) -> None:
    """Initialize once from the settings cascade (later calls no-op, like
    the reference's OnceLock)."""
    global _FLAGS
    if _FLAGS is None:
        _FLAGS = FeatureFlags.from_dict(d).resolve()


def feature_flags() -> FeatureFlags:
    global _FLAGS
    if _FLAGS is None:
        _FLAGS = FeatureFlags().resolve()
    return _FLAGS


def flag_env(name: str, env_var: str) -> bool:
    """A flag's effective value: the env var wins when set, else the flag."""
    env = os.environ.get(env_var)
    if env is not None:
        return env not in ("0", "false", "False")
    return bool(getattr(feature_flags(), name))
