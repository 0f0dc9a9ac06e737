"""The host side of the port's wgmma/TMA kernels on the CPU: the blocks, tensor
maps and refusals that the wrappers state in Python, held to the kernel
sources and to what TMA and the kernels take.

* K3 (``csrc/flash_gqa_sm90.cuh``): ``flash_attention.GQA_SHAPES`` is the
  source's ``Shape<D>``; ``tma_head_map`` at the main paths' BSHD shapes,
  d = 64 and 128 (dims innermost first, byte strides that are multiples of
  16, a 128-byte box row, one box a row at d = 64 and two at d = 128); its
  refusals, and the wrapper's of batches and heads past 65535; the
  persistent kernel's tile count.
* K12 (``csrc/int8_mm.cu``): ``int8.GEMM_SHAPES``, ``GEMM_BK`` and
  ``DECODE_ROWS`` are the source's; ``tma_map`` of the K-major int8
  operands at K = 896, 3584, 4304 and 18944 (TMA zero-fills the last box of
  SigLIP's K = 4304); which shape runs at which N; and ``kernel_args``'s
  refusals, which come before its device check."""

import re
from pathlib import Path

import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    flash_attention as fa,
    int8,
)

CSRC = Path(fa.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("d", [64, 128])
def test_gqa_shapes_are_the_kernel_sources(d):
    text = (CSRC / "flash_gqa_sm90.cuh").read_text()
    m = re.search(rf"struct Shape<{d}> {{\n  static constexpr int WGS = (\d+), BK = (\d+), STAGES = (\d+);", text)
    assert m is not None
    assert tuple(map(int, m.groups())) == fa.GQA_SHAPES[d]


# (shape, rows of a box): q and k at the student's prefill (a 3104-slot
# cache) and at the teacher's, as K3 maps them
MAIN_MAPS = [
    ((1, 3072, 14, 64), 64 * fa.GQA_SHAPES[64][0]),
    ((1, 3104, 2, 64), fa.GQA_SHAPES[64][1]),
    ((1, 3072, 28, 128), 64 * fa.GQA_SHAPES[128][0]),
    ((1, 3072, 4, 128), fa.GQA_SHAPES[128][1]),
    ((8, 700, 14, 64), 64 * fa.GQA_SHAPES[64][0]),  # the evaluator's B = 8
]


@pytest.mark.parametrize("shape,rows", MAIN_MAPS)
def test_tma_head_map_at_the_main_shapes(shape, rows):
    b, s, h, d = shape
    m = fa.tma_head_map(shape, rows)
    assert m["dims"] == (d, h, s, b)
    assert m["strides"] == (2 * d, 2 * d * h, 2 * d * h * s)
    assert all(x % 16 == 0 for x in m["strides"])
    assert m["box"] == (64, 1, rows, 1) and rows <= fa.TMA_MAX_BOX
    assert m["box"][0] * 2 == fa.TMA_SWIZZLE_BYTES  # a box row is one 128-byte swizzle row
    assert m["boxes"] == d // 64 and m["box_bytes"] == 128 * rows


@pytest.mark.parametrize("shape,rows,match", [
    ((1, 64, 2, 60), 64, "16-byte"),        # a 120-byte row stride
    ((1, 64, 2, 64), 257, "box"),
    ((1, 64, 2, 64), 0, "box"),
    ((1, 2**32, 1, 64), 64, "2\\^32"),
])
def test_tma_head_map_refusals(shape, rows, match):
    with pytest.raises(ValueError, match=match):
        fa.tma_head_map(shape, rows)


def test_kernel_args_refuse_batches_and_heads_past_65535():
    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    with pytest.raises(ValueError, match="65535"):
        fa.kernel_args(meta(65536, 4, 2, 64), meta(65536, 4, 2, 64), meta(65536, 4, 2, 64), None)
    with pytest.raises(ValueError, match="65535"):
        fa.kernel_args(meta(1, 4, 65536 * 2, 64), meta(1, 4, 2, 64), meta(1, 4, 2, 64), None)
    assert fa.kernel_args(meta(2, 300, 14, 64), meta(2, 310, 2, 64), meta(2, 310, 2, 64), None) is None


def test_gqa_tiles():
    # the student's prefill: 16 tiles of 192 rows x 14 heads; the teacher's: 24 of 128 x 28
    assert fa.gqa_tiles(1, 3072, 14, 64) == 16 * 14
    assert fa.gqa_tiles(1, 3072, 28, 128) == 24 * 28
    assert fa.gqa_tiles(2, 200, 4, 64) == 2 * 4 * 2  # a ragged last tile
    assert fa.gqa_tiles(8, 1, 7, 128) == 8 * 7


def test_int8_shapes_are_the_kernel_source():
    text = (CSRC / "int8_mm.cu").read_text()
    assert int(re.search(r"constexpr int BK = (\d+);", text)[1]) == int8.GEMM_BK
    assert int(re.search(r"constexpr int DECODE_ROWS = (\d+);", text)[1]) == int8.DECODE_ROWS
    for name, key in (("GemmXla", "xla"), ("GemmKBlock", "k_block"), ("GemmDecode", "decode")):
        wgs, bn, _, swap = re.search(rf"using {name} = Gemm<(\d+), (\d+), (\d+), (true|false), ", text).groups()
        assert int8.GEMM_SHAPES[key] == (swap == "true", 64 * int(wgs), int(bn))


@pytest.mark.parametrize("k,boxes,zero_fill", [(896, 7, 0), (3584, 28, 0), (4304, 34, 48), (18944, 148, 0)])
@pytest.mark.parametrize("rows,box_rows", [(3072, 128), (4864, 64), (1, 8)])
def test_int8_tma_map_k_major(k, boxes, zero_fill, rows, box_rows):
    m = int8.tma_map(rows, k, box_rows)
    assert m["dims"] == (k, rows) and m["strides"] == (k,) and k % 16 == 0
    assert m["box"] == (int8.GEMM_BK, box_rows) and int8.GEMM_BK == 128  # one 128-byte swizzle row
    assert m["boxes"] == boxes and m["zero_fill"] == zero_fill


def test_int8_tma_map_refusals():
    with pytest.raises(ValueError, match="16-byte"):
        int8.tma_map(64, 904, 128)
    with pytest.raises(ValueError, match="box"):
        int8.tma_map(64, 896, 512)


@pytest.mark.parametrize("n,k,k_block,want", [
    (1, 896, None, (True, 64, 8)),          # a decode row: W is A, the x rows B at n = 8
    (8, 896, 128, (True, 64, 8)),           # the evaluator's B = 8 decode
    (9, 896, None, (False, 128, 256)),
    (3072, 3584, None, (False, 128, 256)),  # the teacher's prefill, XLA form
    (3072, 3584, 512, (False, 128, 128)),   # K12's form: B = 128 W rows beside the f32 sum
    (3072, 512, 512, (False, 128, 256)),    # one K block is the XLA form's product
])
def test_int8_gemm_shape(n, k, k_block, want):
    assert int8.gemm_shape(n, k, k_block) == want


def _int8_operands(n=16, k=256, m=64, **bad):
    x = torch.zeros(n, k, dtype=torch.bfloat16)
    wq = torch.zeros(m, k, dtype=torch.int8)
    ws = torch.ones(m, dtype=torch.float32)
    return dict(dict(x2=x, wq=wq, ws=ws, out_dtype=torch.bfloat16, k_block=None), **bad)


@pytest.mark.parametrize("bad,match", [
    (dict(k_block=64), "k_block"),
    (dict(k_block=384 + 96), "k_block"),
    (dict(x2=torch.zeros(16, 256)), "bfloat16"),
    (dict(x2=torch.zeros(16, 88, dtype=torch.bfloat16), wq=torch.zeros(64, 88, dtype=torch.int8)), "multiple"),
    (dict(wq=torch.zeros(60, 256, dtype=torch.int8), ws=torch.ones(60)), "multiple"),
    (dict(wq=torch.zeros(256, 64, dtype=torch.int8).T), "contiguous"),
    (dict(ws=torch.ones(63)), "ws must be"),
    (dict(out_dtype=torch.float16), "out_dtype"),
    ({}, "CUDA"),  # a shape K12 takes, on the CPU
])
def test_int8_kernel_args_refusals(bad, match):
    with pytest.raises(ValueError, match=match):
        int8.kernel_args(**_int8_operands(**bad))
