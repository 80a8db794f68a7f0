"""Port parity for quantized search: qdrant_tpu_torch/ops/quantization.py and
the quantized branch of qdrant_tpu_torch/storage/segment.py against the JAX
package on the same numpy inputs (CPU).

* Encoders: SQ, BQ, PQ and TQ codes, scales and codebooks are bit-equal, and
  each package loads the other's `sq.npz` / `bq.npz` / `pq.npz` / `tq.npz`.
* Scorers, with their tolerances:
  - SQ: bit-equal (the integer dot is exact in both, and every float step
    rounds the same way: 2·x is exact, so no contraction can change it);
  - BQ and PQ: f32 sums of D (BQ) or S (PQ) terms in another order, within
    n · 2⁻²³ · Σ|terms|;
  - TQ: bf16 × bf16 products are exact in f32, so only the summation order
    differs: within D · 2⁻²³ · Σ|q_i · l_i| · scale_v (twice that plus the
    ‖q‖² sum's own bound for euclid).
* Segments: the same sealed SQ segment of 65,536 × 32 (euclid, with
  deletions) in both packages, the JAX one on its TPU path with the Pallas
  kernel interpreted, answers searches with rescore on and off, with
  `ignore` and with `exact`, filtered and unfiltered: equal ids, scores
  within 1e-4 relative. Below 65,536 rows every quantization type is
  compared the same way. A JAX-written SQ segment directory loads in the
  port and answers the same searches.
* One REST round trip on the port: an SQ collection is ingested, sealed by
  the optimizer, searched, reopened from disk and searched again.
"""

import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qdrant_tpu.ops.pallas_scan as pallas_scan
from qdrant_tpu.ops import quantization as jq
from qdrant_tpu.storage.segment import SearchParams as JaxSearchParams
from qdrant_tpu.storage.segment import Segment as JaxSegment
from qdrant_tpu.types import CollectionParams as JaxCollectionParams
from qdrant_tpu.types import parse_filter as jax_parse_filter
from qdrant_tpu_torch.api.rest import RestServer
from qdrant_tpu_torch.api.toc import TableOfContent
from qdrant_tpu_torch.convert import quantized_from_jax
from qdrant_tpu_torch.ops import fused_scan as fs
from qdrant_tpu_torch.ops import quantization as tq
from qdrant_tpu_torch.storage.segment import SearchParams, Segment
from qdrant_tpu_torch.types import CollectionParams, Distance, parse_filter
from qdrant_tpu_torch.device import force_cpu

force_cpu()  # the port on the CPU, with the kernels' plain versions


@pytest.fixture(autouse=True)
def tiny_graphs(monkeypatch):
    """Every seal of a resident vector builds its HNSW graph; these tests hold
    the quantized paths, never search a graph, and seal up to 65,536 rows,
    whose host-orchestrated build takes minutes on the CPU (the JAX side of
    `_segments` skips its build for that reason). Seal with the graph over
    the first 64 rows: real, loadable files."""
    from qdrant_tpu_torch.index.hnsw import HnswIndex

    real = HnswIndex.build

    def build(self, *args, **kwargs):
        ids = np.arange(len(self.store), dtype=np.int32) if self.subset is None else self.subset
        self.subset = ids[:64]
        return real(self, *args, **kwargs)

    monkeypatch.setattr(HnswIndex, "build", build)

EPS = 2.0 ** -23
DISTANCES = ["Dot", "Cosine", "Euclid", "Manhattan"]
ENCODINGS = {
    "sq": lambda x: ("ScalarQuantized", (x, 0.99)),
    "bq": lambda x: ("BinaryQuantized", (x,)),
    "pq": lambda x: ("ProductQuantized", (x, "x16")),
    "tq4": lambda x: ("TurboQuantized", (x, 4)),
    "tq2": lambda x: ("TurboQuantized", (x, 2)),
    "tq1_5": lambda x: ("TurboQuantized", (x, 1.5)),
    "tq1": lambda x: ("TurboQuantized", (x, 1)),
}
FIELDS = {
    "ScalarQuantized": ("codes", "scale", "norms_sq"),
    "BinaryQuantized": ("signs",),
    "ProductQuantized": ("codes", "codebooks"),
    "TurboQuantized": ("codes", "scales", "rotation_seed", "bits", "norms_sq", "dim"),
}
FILES = {"ScalarQuantized": "sq.npz", "BinaryQuantized": "bq.npz",
         "ProductQuantized": "pq.npz", "TurboQuantized": "tq.npz"}


def _assert_same_encoding(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in FIELDS[type(a).__name__]:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
        assert np.asarray(getattr(a, f)).dtype == np.asarray(getattr(b, f)).dtype


@pytest.mark.parametrize("kind", list(ENCODINGS))
def test_encoders_bit_equal_and_files_cross(kind, tmp_path):
    x = np.random.default_rng(40).standard_normal((700, 24)).astype(np.float32)
    cls_name, args = ENCODINGS[kind](x)
    ref = getattr(jq, cls_name).encode(*args)
    got = getattr(tq, cls_name).encode(*args)
    _assert_same_encoding(got, ref)
    assert isinstance(quantized_from_jax(ref), getattr(tq, cls_name))
    _assert_same_encoding(quantized_from_jax(ref), ref)
    ref.save(str(tmp_path / "jax"))
    got.save(str(tmp_path / "port"))
    assert (tmp_path / "jax" / FILES[cls_name]).exists()
    _assert_same_encoding(getattr(tq, cls_name).load(str(tmp_path / "jax")), ref)
    _assert_same_encoding(getattr(jq, cls_name).load(str(tmp_path / "port")), ref)


def _scoring_inputs(seed, b=5, n=400, d=40):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    mask = rng.random(n) > 0.25
    return x, q, mask


def _check_masked(got, ref, mask, tol):
    np.testing.assert_array_equal(np.isneginf(got), np.broadcast_to(~mask, got.shape))
    err = np.abs(got[:, mask] - ref[:, mask])
    assert np.all(err <= np.broadcast_to(tol, got.shape)[:, mask]), float(err.max())


@pytest.mark.parametrize("distance", DISTANCES)
def test_score_sq_matches_jax(distance):
    x, q, mask = _scoring_inputs(41)
    sq = tq.ScalarQuantized.encode(x)
    qc = sq.encode_queries(q)
    qn = (q * q).sum(1).astype(np.float32)
    ref = np.asarray(jq.score_sq(
        jnp.asarray(qc), jnp.asarray(qn), jnp.asarray(sq.codes), jnp.asarray(sq.norms_sq),
        jnp.float32(sq.scale), distance, jnp.asarray(mask)))
    got = tq.score_sq(
        torch.from_numpy(qc), torch.from_numpy(qn), torch.from_numpy(sq.codes),
        torch.from_numpy(sq.norms_sq), sq.scale, distance, torch.from_numpy(mask)).numpy()
    _check_masked(got, ref, mask, 0.0)


@pytest.mark.parametrize("distance", DISTANCES)
def test_score_bq_matches_jax(distance):
    x, q, mask = _scoring_inputs(42)
    bq = tq.BinaryQuantized.encode(x)
    ref = np.asarray(jq.score_bq(jnp.asarray(q), jnp.asarray(bq.signs), distance,
                                 jnp.asarray(mask)))
    got = tq.score_bq(torch.from_numpy(q), torch.from_numpy(bq.signs), distance,
                      torch.from_numpy(mask)).numpy()
    tol = x.shape[1] * EPS * np.abs(q).sum(1, keepdims=True)
    _check_masked(got, ref, mask, tol)


@pytest.mark.parametrize("bits", [4, 2, 1.5, 1])
@pytest.mark.parametrize("distance", DISTANCES)
def test_score_tq_matches_jax(distance, bits):
    x, q, mask = _scoring_inputs(43)
    t = tq.TurboQuantized.encode(x, bits=bits)
    q_rot = t.rotate_queries(q)
    recon, scales, norms = t.device()
    j_recon, j_scales, j_norms = jq.TurboQuantized.encode(x, bits=bits).device()
    ref = np.asarray(jq.score_tq(jnp.asarray(q_rot), j_recon, j_scales, j_norms, distance,
                                 jnp.asarray(mask)))
    got = tq.score_tq(torch.from_numpy(q_rot), recon, scales, norms, distance,
                      torch.from_numpy(mask)).numpy()
    d_pad = q_rot.shape[1]
    q_bf = q_rot.astype(jnp.bfloat16).astype(np.float32)
    terms = np.abs(q_bf) @ np.abs(recon.float().numpy()).T * t.scales[None, :]
    tol = d_pad * EPS * terms
    if distance in ("Euclid", "Manhattan"):
        tol = 2 * tol + d_pad * EPS * (q_rot * q_rot).sum(1, keepdims=True)
    tol = tol + 4 * np.spacing(np.abs(ref).astype(np.float32))
    _check_masked(got, ref, mask, tol)


@pytest.mark.parametrize("distance", DISTANCES)
def test_score_pq_matches_jax(distance):
    x, q, mask = _scoring_inputs(44, n=300, d=16)
    pq = tq.ProductQuantized.encode(x, "x16")
    lut = pq.query_lut(q, Distance(distance))
    ref = np.asarray(jq.score_pq(jnp.asarray(lut), jnp.asarray(pq.codes.astype(np.int32)),
                                 jnp.asarray(mask)))
    got = tq.score_pq(torch.from_numpy(lut), pq.device(), torch.from_numpy(mask)).numpy()
    s = lut.shape[1]
    terms = np.stack([np.abs(lut[bi][np.arange(s), pq.codes]).sum(1) for bi in range(len(q))])
    _check_masked(got, ref, mask, s * EPS * terms)


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_tpu_path(monkeypatch):
    """The JAX engine on its TPU path, its Pallas kernel interpreted, and a
    record of which fused-scan mode each engine ran."""
    calls = {"jax": [], "port": []}
    monkeypatch.setenv("QDRANT_TPU_MESH", "0")
    monkeypatch.setattr(pallas_scan, "is_tpu_backend", lambda: True)
    for name in ("pallas_scan_rescore", "pallas_scan_topk"):
        orig = getattr(pallas_scan, name)

        def patched(*a, _orig=orig, **kw):
            if kw:  # an engine's call; pallas_scan_rescore calls topk positionally
                calls["jax"].append(kw.get("int8_mode", False))
                kw["interpret"] = True
            return _orig(*a, **kw)

        monkeypatch.setattr(pallas_scan, name, patched)
    orig_surv = fs.fused_scan_survivors

    def port_survivors(queries, vectors, *a, **kw):
        calls["port"].append(vectors.dtype == torch.int8)
        return orig_surv(queries, vectors, *a, **kw)

    monkeypatch.setattr(fs, "fused_scan_survivors", port_survivors)
    return calls


def _params(cls, d, distance, quant):
    return cls.from_dict({"vectors": {"": {"size": d, "distance": distance,
                                           "quantization_config": quant}}})


def _segments(x, distance, quant, deleted=(), payload=None):
    """The same sealed quantized segment in both packages → (jax, port).
    The JAX side skips its HNSW build by assigning the encoding directly."""
    n, d = x.shape
    js = JaxSegment(_params(JaxCollectionParams, d, distance, quant))
    ps = Segment(_params(CollectionParams, d, distance, quant))
    for seg in (js, ps):
        seg.bulk_ingest(1, list(range(n)), {"": x}, payload)
        for i in deleted:
            seg.delete_point(2, int(i))
    ps.build_indexes()
    kind = next(iter(quant))
    qc = ps.params.vectors[""].quantization_config
    if kind == "scalar":
        js.quantized[""] = jq.ScalarQuantized.encode(js.dense[""].host_array, qc.quantile)
    elif kind == "binary":
        js.quantized[""] = jq.BinaryQuantized.encode(js.dense[""].host_array)
    elif kind == "product":
        js.quantized[""] = jq.ProductQuantized.encode(js.dense[""].host_array, qc.compression)
    else:
        bits = {"bits1": 1, "bits1_5": 1.5, "bits2": 2, "bits4": 4}[qc.bits]
        js.quantized[""] = jq.TurboQuantized.encode(js.dense[""].host_array, bits=bits)
    js.appendable = False
    _assert_same_encoding(ps.quantized[""], js.quantized[""])
    return js, ps


def _same_results(a, b, rtol=1e-4):
    (sa, ia), (sb, ib) = a, b
    np.testing.assert_array_equal(ia, ib)
    fin = ib >= 0
    np.testing.assert_array_equal(np.isfinite(sa), fin)
    assert np.all(np.abs(sa[fin] - sb[fin]) <= rtol * np.maximum(1.0, np.abs(sb[fin])))


MODES = {
    "rescore": {},
    "codes_only": {"quantization": {"rescore": False}},
    "ignore": {"quantization": {"ignore": True}},
    "exact": {"exact": True},
}
SQ = {"scalar": {"type": "int8", "quantile": 0.99, "always_ram": True}}


@pytest.fixture(scope="module")
def big_sq():
    rng = np.random.default_rng(45)
    n, d = 65536, 32
    x = rng.standard_normal((n, d)).astype(np.float32)
    payload = [{"g": str(i % 5)} for i in range(n)]
    deleted = np.arange(0, n, 9)
    q = rng.standard_normal((6, d)).astype(np.float32)
    return x, payload, deleted, q


def test_sq_segment_kernel_path_matches_jax(big_sq, jax_tpu_path):
    x, payload, deleted, q = big_sq
    js, ps = _segments(x, "Euclid", SQ, deleted, payload)
    spec = {"must": [{"key": "g", "match": {"value": "2"}}]}
    for mode, pd in MODES.items():
        for filtered in (False, True):
            jf = jax_parse_filter(spec) if filtered else None
            pf = parse_filter(spec) if filtered else None
            jax_tpu_path["jax"].clear()
            jax_tpu_path["port"].clear()
            ref = js.search_dense("", q, 10, jf, JaxSearchParams.from_dict(pd))
            got = ps.search_dense("", q, 10, pf, SearchParams.from_dict(pd))
            _same_results(got, ref)
            quantized = mode in ("rescore", "codes_only")
            assert jax_tpu_path["jax"] == [quantized], mode  # int8_mode flag
            assert jax_tpu_path["port"] == [quantized], mode  # int8 vectors
            ids = got[1][got[1] >= 0]
            assert not np.isin(ids, deleted).any()
            if filtered:
                assert all(payload[i]["g"] == "2" for i in ids)


def test_jax_written_sq_segment_loads_in_port(big_sq, jax_tpu_path, tmp_path):
    x, payload, deleted, q = big_sq
    js, _ = _segments(x[:, :16].copy(), "Cosine", SQ, deleted[:50])
    js.save(str(tmp_path / "seg"))
    meta = json.load(open(tmp_path / "seg" / "segment.json"))
    assert meta["quantized"] == {"": "ScalarQuantized"}
    ps = Segment.load(str(tmp_path / "seg"))
    _assert_same_encoding(ps.quantized[""], js.quantized[""])
    qq = q[:, :16]
    for pd in (MODES["rescore"], MODES["codes_only"]):
        _same_results(ps.search_dense("", qq, 10, None, SearchParams.from_dict(pd)),
                      js.search_dense("", qq, 10, None, JaxSearchParams.from_dict(pd)))
    # and the port writes what the JAX package reads
    ps.save(str(tmp_path / "again"))
    back = JaxSegment.load(str(tmp_path / "again"))
    _assert_same_encoding(back.quantized[""], js.quantized[""])


@pytest.mark.parametrize(
    "quant",
    [
        SQ,
        {"binary": {"always_ram": True}},
        {"product": {"compression": "x16", "always_ram": True}},
        {"turbo": {"bits": "bits4", "always_ram": True}},
    ],
    ids=["sq", "bq", "pq", "tq"],
)
@pytest.mark.parametrize("distance", ["Euclid", "Dot"])
def test_small_quantized_segment_matches_jax(quant, distance, jax_tpu_path):
    rng = np.random.default_rng(46)
    x = rng.standard_normal((3000, 32)).astype(np.float32)
    q = rng.standard_normal((4, 32)).astype(np.float32)
    js, ps = _segments(x, distance, quant, deleted=range(0, 3000, 7))
    for mode in ("rescore", "codes_only"):
        pd = MODES[mode]
        if mode == "codes_only" and "scalar" in quant and distance == "Dot":
            continue  # integer code scores tie; top-k may order ties differently
        _same_results(ps.search_dense("", q, 8, None, SearchParams.from_dict(pd)),
                      js.search_dense("", q, 8, None, JaxSearchParams.from_dict(pd)))
    assert jax_tpu_path["port"] == []  # below the kernel's row count


def test_seal_uploads_codes_not_the_bf16_block():
    """A quantized vector's seal uploads its int8 codes in the kernel's layout
    and no bf16 scan block (3 GB of dead device memory at 1M x 1536); an
    unquantized vector beside it still gets its bf16 block."""
    n = 65536
    x = np.random.default_rng(49).standard_normal((n, 8)).astype(np.float32)
    seg = Segment(CollectionParams.from_dict({"vectors": {
        "q": {"size": 8, "distance": "Dot", "quantization_config": SQ},
        "plain": {"size": 8, "distance": "Dot"},
    }}))
    seg.bulk_ingest(1, list(range(n)), {"q": x, "plain": x})
    seg.build_indexes()
    assert seg.dense["q"]._scan is None
    codes, norms, n_pad = seg.quantized["q"]._kernel_dev
    assert codes.dtype == torch.int8 and tuple(codes.shape) == (n_pad, 128) == (n, 128)
    assert seg.quantized["q"]._dev is None
    assert "plain" not in seg.quantized and seg.dense["plain"]._scan is not None


def test_quantized_memory_in_telemetry():
    x = np.random.default_rng(47).standard_normal((2000, 24)).astype(np.float32)
    seg = Segment(_params(CollectionParams, 24, "Dot", SQ))
    seg.bulk_ingest(1, list(range(2000)), {"": x})
    seg.build_indexes()
    mem = seg.memory_usage_bytes()
    part = mem["breakdown"]["quantized"]
    assert part["host_bytes"] >= x.size  # int8 codes + norms on the host
    assert part["device_bytes"] == x.size + 4 * len(x)  # codes + norms uploaded


# ---------------------------------------------------------------------------
# REST round trip on the port
# ---------------------------------------------------------------------------


def _call(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=300) as resp:
        out = json.loads(resp.read())
    assert out["status"] == "ok", out
    return out["result"]


def test_rest_sq_collection_round_trip(tmp_path, jax_tpu_path):
    rng = np.random.default_rng(48)
    n, d = 65536, 16
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((3, d)).astype(np.float32)
    answers = []
    for restart in (False, True):
        toc = TableOfContent(str(tmp_path))
        srv = RestServer(toc, port=0)
        srv.start_background()
        try:
            if not restart:
                _call(srv.port, "PUT", "/collections/sq", {
                    "vectors": {"size": d, "distance": "Cosine", "quantization_config": SQ},
                })
                toc.get_collection("sq").bulk_ingest(list(range(n)), {"": x})
                toc.optimize_all()
            segs = toc.get_collection("sq").shards[0].segments
            assert any(len(s) == n and "" in s.quantized and not s.appendable for s in segs)
            jax_tpu_path["port"].clear()
            answers.append([
                _call(srv.port, "POST", "/collections/sq/points/search",
                      {"vector": v.tolist(), "limit": 5, "params": pd})
                for v in q for pd in (MODES["rescore"], MODES["codes_only"])
            ])
            assert jax_tpu_path["port"] and all(jax_tpu_path["port"])  # int8 mode
        finally:
            srv.shutdown()
            toc.close()
    assert answers[0] == answers[1]
    # `rescore: false` reached the segment: codes-only scores are not the f32 ones
    rescored, codes_only = answers[0][::2], answers[0][1::2]
    assert [h["score"] for r in rescored for h in r] != [h["score"] for r in codes_only for h in r]
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    for v, hits in zip(q, answers[0][::2]):  # rescored: exact cosine scores
        vn = v / np.linalg.norm(v)
        truth = np.argsort(-(xn @ vn))[:5]
        assert [h["id"] for h in hits] == truth.tolist()
        np.testing.assert_allclose([h["score"] for h in hits], (xn @ vn)[truth], rtol=1e-5)
