"""qdrant-tpu-torch: the PyTorch / CUDA port of the qdrant-tpu engine.

A second package beside `qdrant_tpu` (the JAX reference). It mirrors that
package's module layout, imports torch and never jax, and imports nothing of
`qdrant_tpu`: the modules it shares with the reference unchanged (types,
settings, WAL, id tracker, payload storage and index, hash ring, auth,
metrics, most of utils, the native WAL / Gridstore sources) are copies kept
at the same relative paths, held equal to their originals by
tests/test_torch_guards.py.

Ported so far, on one CUDA device through REST:
  * exact dense search — the dense branch of Segment, PlainIndex, ScanIndex
    and the fused scan kernel's bf16 mode (csrc/fused_scan.cu);
  * quantized search — SQ, BQ, PQ and TQ encoders and scorers
    (ops/quantization.py); a sealed in-RAM SQ segment of 65,536 rows or
    more scans its int8 codes with the fused scan kernel's int8 mode and
    rescores the oversampled winners in f32;
plus the collection / shard / query / REST shell above them.
"""
