"""The benchmark of the PyTorch / CUDA port (`qdrant_tpu_torch`).

One run serves one cell of `BENCHMARK.json` (a configuration under a traffic
mix) through the port's REST server on the card, measures its end-to-end
metrics with tracing off (`--trace 0`) or its per-layer metrics with the
profiler on (`--trace 1`), and judges every answer against a plain torch
reference (`portbench/reference/`) that shares no code with the port:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or metric is a file
found by its name: `configs/<config>.json`, `traffic/<mix>.json`,
`metrics/<metric>.py`, `data/<generator>.py`, `reference/<reference>.py`.
Nothing here imports jax, jaxlib, flax or the JAX package `qdrant_tpu`.
"""
