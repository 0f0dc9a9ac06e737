"""The host side of the kernels on the wgmma/TMA vocab core on the CPU
(``csrc/kdss_vocab_sm90.cuh``: K11 and K9 in ``csrc/fused_loca_ce.cu``, the
fused CE forward and backward K5 and K6 in ``csrc/fused_ce.cu``, the
temperature-KL forward and backward K7 and K8 in ``csrc/fused_kl.cu``): the
plan that ``ops/vocab_core.py`` states in Python, held to the kernel sources
and to what TMA and the kernels take.

* ``VOCAB_TILE``, ``SWEEP_ROWS``, ``SWEEP_CONSUMERS`` and ``VOCAB_STAGES``
  are the source's constants, and both kernels' shared memory (the sweep's
  resident h rows beside its ring) fits a block of the H100;
* ``vocab_plan`` at the KD path's shape (N = 3072, V = 151936, D = 896 on
  132 SMs) and at ragged ones: row blocks, vocab tiles, splits that are
  never empty, the forward's partials, the backward's bf16 ds and dh's
  split and partials, the products' grids; ``fwd_scratch`` (K5's, K7's,
  K11's and K9's partials, planes x two per vocab split x N) and
  ``bwd_scratch`` allocate exactly the plan's scratch;
* ``vocab_maps``: dims innermost first, 16-byte row strides, 128-byte box
  rows, and the refusal of a vocabulary that is not a multiple of 4 where
  the sweep reads the teacher (tmat read in 8-byte pairs; K6 reads none)
  or of ds rows that are not 16-byte aligned (the wrappers' own refusal of
  such a V on the card is in ``test_torch_fused_loca_cuda.py`` and
  ``test_torch_fused_kl_cuda.py``);
* the sources: K5's, K6's, K7's and K8's entries run on the core (K6 and
  K8 a ds sweep, then ``ds_products``; K5 and K7 a statistics sweep, then
  a combine; K5 and K6 load no teacher tile), each in a namespace of its
  own; no source includes the deleted mma.sync tiling
  ``csrc/kdss_vocab.cuh`` or issues an ``mma.sync``, and ``kdss_mma.cuh``
  no longer defines its product or fragment loads;
* ``scripts/profile_torch_kd_step.py`` files each kernel of K5-K8 and K11,
  and a parent's mma.sync K5 and K7, under its own group;
* ``lse_gold_fwd`` (K5), ``lse_gold_bwd`` (K6), ``kl_fwd`` (K7) and
  ``kl_bwd`` (K8) refuse, with ValueError and before any launch, what the
  kernels cannot take (checked on ``meta`` tensors, which are not on the
  CPU and so take the kernels' route; K7's and K8's refusal of a V that is
  no multiple of 4 comes after the device check and is held on the card,
  ``test_torch_fused_kl_cuda.py``)."""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    fused_ce as fc,
    fused_kl as fkl,
    vocab_core as vc,
)

CSRC = Path(vc.__file__).resolve().parent.parent / "csrc"
PROFILE = Path(__file__).resolve().parent.parent / "scripts" / "profile_torch_kd_step.py"
SMEM_PER_BLOCK = 232448  # the H100's shared memory a block can take (227 KB)
D = 896


def _constants():
    text = (CSRC / "kdss_vocab_sm90.cuh").read_text()
    tile = re.search(r"constexpr int BM = (\d+), BN = (\d+), BK = (\d+), CONSUMERS = (\d+);", text)
    stages = re.search(r"constexpr int SWEEP_STAGES = (\d+), GEMM_STAGES = (\d+);", text)
    rows = re.search(r"constexpr int SWEEP_BM = (\d+);", text)
    assert tile and stages and rows
    return tuple(map(int, tile.groups())), tuple(map(int, stages.groups())), int(rows[1])


def test_vocab_core_is_the_kernel_source():
    (bm, bn, bk, consumers), stages, sweep_rows = _constants()
    assert vc.VOCAB_TILE == (bm, bn, bk)
    assert vc.VOCAB_STAGES == stages
    assert vc.SWEEP_ROWS == sweep_rows == 64  # one m64 wgmma row block
    assert vc.SWEEP_CONSUMERS == consumers and bm == 64 * consumers
    assert bk * 2 == 128  # a box row is one 128-byte swizzle row
    assert D % bk == 0


def test_shared_memory_fits_a_block():
    (bm, bn, bk, consumers), (sweep_stages, gemm_stages), sweep_rows = _constants()
    sweep = 1024 + sweep_rows * D * 2 + sweep_stages * bn * bk * 2 + (1 + 2 * sweep_stages) * 8
    gemm = 1024 + gemm_stages * (bm + bn) * bk * 2 + 2 * gemm_stages * 8
    assert sweep <= SMEM_PER_BLOCK and gemm <= SMEM_PER_BLOCK, (sweep, gemm)


def test_plan_at_the_kd_path_shape():
    p = vc.vocab_plan(3072, 151936, D, 132)
    assert (p["row_blocks"], p["vocab_tiles"]) == (48, 1187)
    assert p["nsplit"] == 11 and p["row_blocks"] * p["nsplit"] == 4 * 132  # four full waves
    assert p["part"] == (7, 22, 3072)  # a partial per consumer warpgroup
    assert p["ds"] == (3072, 151936) and p["ld_ds"] == 151936
    assert p["dh_split"] == 7 and p["dh_part"] == (7, 3072, D)
    assert p["dh_grid"] == (7, 24, 7) and p["dw_grid"] == (7, 1187, 1)


@pytest.mark.parametrize("n,v", [(3072, 151936), (3000, 151936), (200, 1000), (130, 2048), (1, 8), (257, 1004)])
@pytest.mark.parametrize("sms", [132, 114])
def test_plan_splits_are_never_empty(n, v, sms):
    p = vc.vocab_plan(n, v, D, sms)
    bm, bn, bk = vc.VOCAB_TILE
    assert p["row_blocks"] == -(-n // vc.SWEEP_ROWS) and p["vocab_tiles"] == -(-v // bn)
    for units, split in ((p["vocab_tiles"], p["nsplit"]), (-(-v // bk), p["dh_split"])):
        per = -(-units // split)  # the kernels' units a split
        assert 1 <= split <= units and (split - 1) * per < units
    assert p["ld_ds"] % 8 == 0 and v <= p["ld_ds"] < v + 8
    assert p["part"] == (7, 2 * p["nsplit"], n) and p["dh_part"] == (p["dh_split"], n, D)


@pytest.mark.parametrize("n,v", [(3072, 151936), (3000, 151936), (200, 1000), (130, 2044)])
def test_maps(n, v):
    ld = vc.vocab_plan(n, v, D, 132)["ld_ds"]
    m = vc.vocab_maps(n, v, D, ld)
    bm, bn, bk = vc.VOCAB_TILE
    assert m["h"] == dict(dims=(D, n), strides=(2 * D,), box=(bk, vc.SWEEP_ROWS), zero_fill=0)
    assert m["w"] == dict(dims=(D, v), strides=(2 * D,), box=(bk, bn), zero_fill=0)
    assert m["ds_k"]["dims"] == (v, n) and m["ds_k"]["strides"] == (2 * ld,) and m["ds_k"]["box"] == (64, bm)
    assert m["ds_k"]["zero_fill"] == -(-v // 64) * 64 - v  # dh's last k step reads zeros past V
    assert m["ds_m"]["box"] == (64, bk) and m["w_n"]["box"] == (64, bk) and m["h_n"]["box"] == (64, bk)
    for x in m.values():
        assert all(s % 16 == 0 for s in x["strides"]) and x["box"][1] <= 256


@pytest.mark.parametrize("v,ld", [(1001, 1008), (1002, 1008), (151937, 151944), (1000, 1004), (1000, 992)])
def test_what_the_kernels_cannot_take_is_refused(v, ld):
    with pytest.raises(ValueError, match="multiple of"):
        vc.vocab_maps(64, v, D, ld)


@pytest.mark.parametrize("n", [3072, 3000, 300])
def test_plan_at_the_ce_and_kl_backward_shapes(n):
    """K6 and K8 at the training and phase-1 paths' N = 3072 rows over the
    151936-row tied head (and at ragged N) take K11's plan: a ds sweep of
    ``nsplit`` vocab splits, the bf16 ds [N, 151936] (0.93 GB at N = 3072),
    dh's split partials; their maps take V = 151936 with or without a
    teacher."""
    v = 151936
    p = vc.vocab_plan(n, v, D, 132)
    assert p["row_blocks"] == -(-n // 64) and p["vocab_tiles"] == 1187
    assert p["ds"] == (n, v) and p["dh_part"] == (p["dh_split"], n, D)
    assert p["dh_grid"] == (7, -(-n // 128), p["dh_split"]) and p["dw_grid"] == (7, 1187, 1)
    if n == 3072:
        assert (p["nsplit"], p["dh_split"]) == (11, 7)
        assert n * p["ld_ds"] * 2 == 933_494_784  # the bf16 ds
    for teacher in (True, False):
        assert vc.vocab_maps(n, v, D, p["ld_ds"], teacher=teacher)["ds_k"]["dims"] == (v, n)


@pytest.mark.parametrize("v", [1001, 1002, 151937])
def test_a_sweep_without_teacher_takes_any_vocabulary(v):
    """K6 reads no teacher: V needs no multiple of 4, only ds rows padded to
    8 columns; with a teacher (K8, K11, K9) the same V is refused."""
    ld = vc.vocab_plan(64, v, D, 132)["ld_ds"]
    m = vc.vocab_maps(64, v, D, ld, teacher=False)
    assert m["ds_k"]["dims"] == (v, 64) and m["ds_k"]["strides"] == (2 * ld,)
    with pytest.raises(ValueError, match="multiple of 4"):
        vc.vocab_maps(64, v, D, ld)


class _Props:
    multi_processor_count = 132


@pytest.mark.parametrize("n,v", [(3072, 151936), (300, 1001)])
def test_bwd_scratch_is_the_plan(monkeypatch, n, v):
    monkeypatch.setattr(vc.torch.cuda, "get_device_properties", lambda device: _Props())
    hs = torch.empty(n, D, dtype=torch.bfloat16, device="meta")
    ws = torch.empty(v, D, dtype=torch.bfloat16, device="meta")
    ds, part, nsplit = vc.bwd_scratch(hs, ws)
    p = vc.vocab_plan(n, v, D, 132)
    assert ds.shape == p["ds"] and ds.dtype == torch.bfloat16
    assert part.shape == p["dh_part"] and part.dtype == torch.float32 and nsplit == p["nsplit"]


@pytest.mark.parametrize("n,v", [(3072, 151936), (3000, 151936), (300, 1001), (130, 2052), (1, 8)])
@pytest.mark.parametrize("planes", [2, 6, 7])
def test_fwd_scratch_is_the_plan(monkeypatch, n, v, planes):
    """A forward's partials: ``planes`` (K5 2, K7 6, K11 and K9 7) x one per
    consumer warpgroup of every vocab split x N, the splits never empty."""
    monkeypatch.setattr(vc.torch.cuda, "get_device_properties", lambda device: _Props())
    hs = torch.empty(n, D, dtype=torch.bfloat16, device="meta")
    ws = torch.empty(v, D, dtype=torch.bfloat16, device="meta")
    part = vc.fwd_scratch(hs, ws, planes)
    p = vc.vocab_plan(n, v, D, 132)
    assert part.shape == (planes, vc.SWEEP_CONSUMERS * p["nsplit"], n) and part.dtype == torch.float32
    assert part.shape[1:] == p["part"][1:]
    per = -(-p["vocab_tiles"] // p["nsplit"])
    assert (p["nsplit"] - 1) * per < p["vocab_tiles"]
    if (n, v) == (3072, 151936):
        assert part.shape == (planes, 22, 3072)


def _body(text, signature):
    """The brace-balanced body that follows ``signature`` in ``text``."""
    i = text.index("{", text.index(signature))
    depth = 0
    for j in range(i, len(text)):
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[i:j + 1]
    raise AssertionError(f"unbalanced body after {signature}")


@pytest.mark.parametrize("src,entry,ns", [("fused_ce.cu", "int kdss_ce_bwd(", "kdss_ce90"),
                                          ("fused_kl.cu", "int kdss_kl_bwd(", "kdss_kl90"),
                                          ("fused_ce.cu", "int kdss_ce_fwd(", "kdss_ce_fwd90"),
                                          ("fused_kl.cu", "int kdss_kl_fwd(", "kdss_kl_fwd90")])
def test_ce_and_kl_backwards_run_on_the_vocab_core(src, entry, ns):
    """Each entry of K5-K8 runs a sweep of its own namespace's epilogue
    policy on the core: the backwards (K6, K8) a ds sweep, then the core's
    products; the forwards (K5, K7) a sweep that keeps per-row statistics,
    then a combine.  The CE kernels (K5, K6) load no teacher tile."""
    text = (CSRC / src).read_text()
    assert '#include "kdss_vocab_sm90.cuh"' in text
    fn = "fwd" if "_fwd(" in entry else "bwd"
    assert f"{ns}::{fn}<896>(" in _body(text, entry)
    space = _body(text, f"namespace {ns} {{")
    policies = re.findall(r"struct (\w+Epi) \{", space)
    assert len(policies) == 1, policies
    body, epi = _body(space, f"cudaError_t {fn}("), _body(space, f"struct {policies[0]}")
    assert "kdss_vocab90_host::sweep<DM>(" in body and "fast_exp2" in epi
    if fn == "bwd":
        assert "kdss_vocab90_host::ds_products<DM, DsEpi>(" in body and "pack_bf16" in epi
    else:
        assert "_combine<<<" in body and "quad_sum" in epi and "ds" not in re.findall(r"\w+", epi)
    assert ("TEACHER = false" in epi) == (src == "fused_ce.cu")  # K5 and K6 load no teacher tile
    assert "launch_bwd" not in text and "Rows" not in text


def test_no_source_runs_the_mma_sync_tiling():
    """``csrc/kdss_vocab.cuh`` (the mma.sync tiling of K5 and K7) is gone:
    no source includes it or issues an ``mma.sync``, and ``kdss_mma.cuh``
    no longer defines the product or its fragment loads."""
    assert not (CSRC / "kdss_vocab.cuh").exists()
    for src in CSRC.glob("*.cu*"):
        body = src.read_text()
        assert '#include "kdss_vocab.cuh"' not in body, src.name
        assert '"mma.sync' not in body, src.name
        assert "CERows" not in body and "KLRows" not in body, src.name
    helpers = (CSRC / "kdss_mma.cuh").read_text()
    for gone in ("mma16816", "load_a", "load_b_rows", "ld32"):
        assert not re.search(rf"\b{gone}\(", helpers), gone
    for kept in ("FULL", "LOG2E", "LN2", "pack_bf16"):
        assert kept in helpers


def _profile_groups():
    spec = importlib.util.spec_from_file_location("profile_torch_kd_step", PROFILE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.group_of


@pytest.mark.parametrize("name,group", [
    ("kdss_vocab90::sweep_kernel<896, kdss_ce_fwd90::LseGoldEpi>", "fused CE forward (K5)"),
    ("kdss_ce_fwd90::ce_fwd_combine", "fused CE forward (K5)"),
    ("kdss_ce::ce_fwd_kernel<896>", "fused CE forward (K5)"),
    ("kdss_vocab90::sweep_kernel<896, kdss_kl_fwd90::StatsEpi>", "temperature KL forward (K7)"),
    ("kdss_kl_fwd90::kl_fwd_combine", "temperature KL forward (K7)"),
    ("kdss_kl::kl_fwd_kernel<896>", "temperature KL forward (K7)"),
    ("kdss_vocab90::sweep_kernel<896, kdss_ce90::DsEpi>", "fused CE backward (K6)"),
    ("kdss_vocab90::gemm_kernel<true, false, kdss_kl90::DsEpi>", "temperature KL backward (K8)"),
    ("kdss_vocab90::sweep_kernel<896, kdss_loca_ce::StatsEpi<true> >", "LoCa + CE (K11), LoCa (K9)"),
    ("kdss_loca_ce::loca_stats_combine<false>", "LoCa + CE (K11), LoCa (K9)"),
])
def test_profile_groups_tell_the_vocab_kernels_apart(name, group):
    assert _profile_groups()(name) == group


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _ce_args(n=64, v=1000, d=D):
    return [_meta(n, d), _meta(v, d), _meta(n, dtype=torch.int32), *(_meta(n, dtype=torch.float32) for _ in range(3))]


def _kl_args(n=64, v=1000, d=D):
    return [_meta(n, d), _meta(v, d), _meta(n, v, dtype=torch.float32),
            *(_meta(n, dtype=torch.float32) for _ in range(3))]


@pytest.mark.parametrize("case,at,bad,match", [
    ("model dim", None, dict(d=128), "model dim"),
    ("h dtype", 0, _meta(64, D, dtype=torch.float32), "bfloat16"),
    ("w shape", 1, _meta(1000, 128), "need h"),
    ("labels dtype", 2, _meta(64, dtype=torch.int64), "int32"),
    ("lse rows", 3, _meta(10, dtype=torch.float32), r"lse must be \[N\]"),
    ("g_gold rows", 5, _meta(65, dtype=torch.float32), r"g_gold must be \[N\]"),
    ("not on the card", None, {}, "CUDA tensors"),
])
def test_lse_gold_bwd_refuses_what_k6_cannot_take(case, at, bad, match):
    args = _ce_args(**bad) if at is None else _ce_args()
    if at is not None:
        args[at] = bad
    with pytest.raises(ValueError, match=match):
        fc.lse_gold_bwd(*args)


@pytest.mark.parametrize("case,at,bad,match", [
    ("model dim", None, dict(d=128), "model dim"),
    ("h dtype", 0, _meta(64, D, dtype=torch.float32), "bfloat16"),
    ("w not contiguous", 1, _meta(D, 1000).T, "contiguous"),
    ("labels dtype", 2, _meta(64, dtype=torch.int64), "int32"),
    ("labels rows", 2, _meta(65, dtype=torch.int32), "int32"),
    ("not on the card", None, {}, "CUDA tensors"),
])
def test_lse_gold_fwd_refuses_what_k5_cannot_take(case, at, bad, match):
    args = (_ce_args(**bad) if at is None else _ce_args())[:3]
    if at is not None:
        args[at] = bad
    with pytest.raises(ValueError, match=match):
        fc.lse_gold_fwd(*args)


@pytest.mark.parametrize("case,at,bad,match", [
    ("model dim", None, dict(d=128), "model dim"),
    ("hs dtype", 0, _meta(64, D, dtype=torch.float32), "bfloat16"),
    ("ws shape", 1, _meta(1000, 128), "need hs"),
    ("tmat dtype", 2, _meta(64, 1000), "tmat"),
    ("tmat shape", 2, _meta(64, 1004, dtype=torch.float32), "tmat"),
    ("not on the card", None, {}, "CUDA tensors"),
])
def test_kl_fwd_refuses_what_k7_cannot_take(case, at, bad, match):
    args = (_kl_args(**bad) if at is None else _kl_args())[:3]
    if at is not None:
        args[at] = bad
    with pytest.raises(ValueError, match=match):
        fkl.kl_fwd(*args, inv_t=0.5)


@pytest.mark.parametrize("case,at,bad,match", [
    ("model dim", None, dict(d=128), "model dim"),
    ("lse_s dtype", 3, _meta(64, dtype=torch.float64), "lse_s"),
    ("hs dtype", 0, _meta(64, D, dtype=torch.float32), "bfloat16"),
    ("tmat dtype", 2, _meta(64, 1000), "tmat"),
    ("tmat shape", 2, _meta(64, 1004, dtype=torch.float32), "tmat"),
    ("lse_t rows", 4, _meta(10, dtype=torch.float32), "lse_t"),
    ("g rows", 5, _meta(10, dtype=torch.float32), r"g must be \[N\]"),
    ("not on the card", None, {}, "CUDA tensors"),
])
def test_kl_bwd_refuses_what_k8_cannot_take(case, at, bad, match):
    args = _kl_args(**bad) if at is None else _kl_args()
    if at is not None:
        args[at] = bad
    with pytest.raises(ValueError, match=match):
        fkl.kl_bwd(*args, inv_t=0.5)
