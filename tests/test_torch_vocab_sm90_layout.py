"""The host side of K11 and K9 on the wgmma/TMA vocab core on the CPU
(``csrc/kdss_vocab_sm90.cuh``, ``csrc/fused_loca_ce.cu``): the plan that
``ops/fused_loca.py`` states in Python, held to the kernel sources and to
what TMA and the kernels take.

* ``VOCAB_TILE``, ``SWEEP_ROWS``, ``SWEEP_CONSUMERS`` and ``VOCAB_STAGES``
  are the source's constants, and both kernels' shared memory (the sweep's
  resident h rows beside its ring) fits a block of the H100;
* ``vocab_plan`` at the KD path's shape (N = 3072, V = 151936, D = 896 on
  132 SMs) and at ragged ones: row blocks, vocab tiles, splits that are
  never empty, the forward's partials, the backward's bf16 ds and dh's
  split and partials, the products' grids;
* ``vocab_maps``: dims innermost first, 16-byte row strides, 128-byte box
  rows, and the refusal of a vocabulary that is not a multiple of 4 (tmat
  read in 8-byte pairs) or of ds rows that are not 16-byte aligned (the
  wrappers' own refusal of such a V on the card is in
  ``test_torch_fused_loca_cuda.py``)."""

import re
from pathlib import Path

import pytest

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    fused_loca as fl,
)

CSRC = Path(fl.__file__).resolve().parent.parent / "csrc"
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
    assert fl.VOCAB_TILE == (bm, bn, bk)
    assert fl.VOCAB_STAGES == stages
    assert fl.SWEEP_ROWS == sweep_rows == 64  # one m64 wgmma row block
    assert fl.SWEEP_CONSUMERS == consumers and bm == 64 * consumers
    assert bk * 2 == 128  # a box row is one 128-byte swizzle row
    assert D % bk == 0


def test_shared_memory_fits_a_block():
    (bm, bn, bk, consumers), (sweep_stages, gemm_stages), sweep_rows = _constants()
    sweep = 1024 + sweep_rows * D * 2 + sweep_stages * bn * bk * 2 + (1 + 2 * sweep_stages) * 8
    gemm = 1024 + gemm_stages * (bm + bn) * bk * 2 + 2 * gemm_stages * 8
    assert sweep <= SMEM_PER_BLOCK and gemm <= SMEM_PER_BLOCK, (sweep, gemm)


def test_plan_at_the_kd_path_shape():
    p = fl.vocab_plan(3072, 151936, D, 132)
    assert (p["row_blocks"], p["vocab_tiles"]) == (48, 1187)
    assert p["nsplit"] == 11 and p["row_blocks"] * p["nsplit"] == 4 * 132  # four full waves
    assert p["part"] == (7, 22, 3072)  # a partial per consumer warpgroup
    assert p["ds"] == (3072, 151936) and p["ld_ds"] == 151936
    assert p["dh_split"] == 7 and p["dh_part"] == (7, 3072, D)
    assert p["dh_grid"] == (7, 24, 7) and p["dw_grid"] == (7, 1187, 1)


@pytest.mark.parametrize("n,v", [(3072, 151936), (3000, 151936), (200, 1000), (130, 2048), (1, 8), (257, 1004)])
@pytest.mark.parametrize("sms", [132, 114])
def test_plan_splits_are_never_empty(n, v, sms):
    p = fl.vocab_plan(n, v, D, sms)
    bm, bn, bk = fl.VOCAB_TILE
    assert p["row_blocks"] == -(-n // fl.SWEEP_ROWS) and p["vocab_tiles"] == -(-v // bn)
    for units, split in ((p["vocab_tiles"], p["nsplit"]), (-(-v // bk), p["dh_split"])):
        per = -(-units // split)  # the kernels' units a split
        assert 1 <= split <= units and (split - 1) * per < units
    assert p["ld_ds"] % 8 == 0 and v <= p["ld_ds"] < v + 8
    assert p["part"] == (7, 2 * p["nsplit"], n) and p["dh_part"] == (p["dh_split"], n, D)


@pytest.mark.parametrize("n,v", [(3072, 151936), (3000, 151936), (200, 1000), (130, 2044)])
def test_maps(n, v):
    ld = fl.vocab_plan(n, v, D, 132)["ld_ds"]
    m = fl.vocab_maps(n, v, D, ld)
    bm, bn, bk = fl.VOCAB_TILE
    assert m["h"] == dict(dims=(D, n), strides=(2 * D,), box=(bk, fl.SWEEP_ROWS), zero_fill=0)
    assert m["w"] == dict(dims=(D, v), strides=(2 * D,), box=(bk, bn), zero_fill=0)
    assert m["ds_k"]["dims"] == (v, n) and m["ds_k"]["strides"] == (2 * ld,) and m["ds_k"]["box"] == (64, bm)
    assert m["ds_k"]["zero_fill"] == -(-v // 64) * 64 - v  # dh's last k step reads zeros past V
    assert m["ds_m"]["box"] == (64, bk) and m["w_n"]["box"] == (64, bk) and m["h_n"]["box"] == (64, bk)
    for x in m.values():
        assert all(s % 16 == 0 for s in x["strides"]) and x["box"][1] <= 256


@pytest.mark.parametrize("v,ld", [(1001, 1008), (1002, 1008), (151937, 151944), (1000, 1004), (1000, 992)])
def test_what_the_kernels_cannot_take_is_refused(v, ld):
    with pytest.raises(ValueError, match="multiple of"):
        fl.vocab_maps(64, v, D, ld)
