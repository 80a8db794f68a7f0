"""Gaussian-mixture rows and queries, made on the device from the seed.

The SIFT-like form is `bench.py::make_dataset` (copied by `chip_smoke.py`
as `_clustered`): centres uniform in [low, high), each row a centre plus
`spread` times a standard normal, clipped. The unit form stands for text
embeddings: unit centres, each row a centre plus `spread` times a normal of
norm about 1, then normalised. Queries are drawn the same way around the same
centres. A few large calls on one `torch.Generator`, in row chunks of a fixed
size, so the same seed on the same card gives the same rows.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

CHUNK = 1 << 18  # rows per call: fixed, so the random stream does not depend on memory


def _draw(gen, centres, n, d, p, device) -> np.ndarray:
    out = np.empty((n, d), dtype=np.float32)
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        pick = torch.randint(0, centres.shape[0], (m,), generator=gen, device=device)
        noise = torch.randn((m, d), generator=gen, device=device)
        if p.get("unit_centres"):
            noise /= float(np.sqrt(d))
        rows = centres[pick] + float(p["spread"]) * noise
        if "clip" in p:
            rows.clamp_(float(p["clip"][0]), float(p["clip"][1]))
        if p.get("normalise"):
            rows /= rows.norm(dim=1, keepdim=True).clamp_min(1e-12)
        out[lo : lo + m] = rows.cpu().numpy()
    return out


def generate(p: dict, n: int, d: int, n_queries: int, seed: int,
             device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """→ (rows [n, d], queries [n_queries, d]) float32 on the host."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    c = int(p["centres"])
    if p.get("unit_centres"):
        centres = torch.randn((c, d), generator=gen, device=device)
        centres /= centres.norm(dim=1, keepdim=True)
    else:
        lo, hi = float(p["centre_low"]), float(p["centre_high"])
        centres = lo + (hi - lo) * torch.rand((c, d), generator=gen, device=device)
    rows = _draw(gen, centres, n, d, p, device)
    queries = _draw(gen, centres, n_queries, d, p, device)
    return rows, queries
