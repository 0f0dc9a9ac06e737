"""The port's int8 kernels on the card against their plain PyTorch versions:
the w8a8 GEMM (K12, ``csrc/int8_mm.cu``, s8 wgmma fed by TMA) in the XLA
form and in its K-block form, at ragged K, M and N, at N = 1 (a decode
step) and at a K that the K block does not divide, and bit for bit at the
main paths' shapes (``chip_smoke.py``'s INT8_CASES) in both forms, where a
dropped weight scale breaks the bits; the int8-head teacher logits (K10,
``csrc/tmat_int8.cu``) over one and several vocab tiles, an odd vocab that
ends in a partial tile, one row, a row count one past whole tiles, a D the
64-column k step does not divide, and hidden states given as an offset
strided view, with two launches bit-identical; ``QLinear`` on the card; and
that the wrappers refuse what the kernels do not take; the four kernels
of K12's split form (row absmax, quantize with a given amax, the int32
GEMM, the scale epilogue) bit for bit against their plain versions at the
7B teacher's tensor = 2 local shapes and ragged ones, and the split form
with no group bit-equal to the fused K12.  Needs a CUDA device; skips
without one.

Run on the card (the tests' conftest imports jax, which the card's machine
may lack):
    python -m pytest --noconftest -m cuda tests/test_torch_int8_cuda.py

Tolerances, as in ``chip_smoke.py``: max abs error <= 2e-2 x max(1, max
|plain|) and relative Frobenius error <= 1e-2.  K12 and its plain version do
the same integer sums and the same f32 epilogue, so they differ at most by
an output rounding; K10 and its plain version differ by f32 summation order.
The tests show that these bounds fail K12 fed weight scales of 1 in half
the columns, K12 that scales every row by the first row's amax, and K10 fed
scales of 1 (a kernel that drops ws)."""

import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models.qwen2 import (
    QLinear,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import (
    _build,
    fused_loca as fl,
    int8,
)

pytestmark = pytest.mark.cuda
TOL = 2e-2
FRO_TOL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built for sm_90a)")
    return torch.device("cuda", 0)


def _close(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    fro = ((got - want).norm() / want.norm()).item()
    return err <= TOL * max(1.0, want.abs().max().item()) and fro <= FRO_TOL, (err, fro)


def _operands(dev, n, k, m, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(n, k, generator=g, device=dev) * 3).to(torch.bfloat16)
    if n > 2:
        x[1] = 0  # the 1e-6 amax floor
    wq, ws = int8.absmax_quantize_weight(torch.randn(m, k, generator=g, device=dev) * 0.05)
    return x, wq, ws


@pytest.mark.parametrize("n,k,m,k_block,out_dtype", [
    (300, 1024, 264, None, torch.float32),     # ragged N and M, the XLA form
    (300, 1024, 264, 512, torch.float32),      # K12's form, two K blocks
    (129, 4304, 1152, None, torch.bfloat16),   # SigLIP fc2's ragged K, a partial last K step
    (129, 4304, 1152, 128, torch.bfloat16),    # a K block that does not divide K
    (7, 896, 4864, None, torch.bfloat16),      # the student's gate_proj at a few rows
    (1, 896, 4864, None, torch.bfloat16),      # one decode row
    (1, 896, 4864, 128, torch.float32),
], ids=["xla", "kblock", "ragged_k", "ragged_kblock", "few_rows", "decode", "decode_kblock"])
def test_int8_matmul_matches_plain(dev, n, k, m, k_block, out_dtype):
    x, wq, ws = _operands(dev, n, k, m)
    int8.reset_launch_counts()
    got = int8.int8_matmul(x, wq, ws, out_dtype, k_block=k_block)
    torch.cuda.synchronize()
    assert int8.int8_matmul.launches == 1
    assert got.shape == (n, m) and got.dtype == out_dtype
    ok, errs = _close(got, int8.int8_matmul_ref(x, wq, ws, out_dtype, k_block=k_block))
    assert ok, errs


# The main paths' shapes (chip_smoke.py's INT8_CASES): (rows N, K, M).
INT8_SHAPES = [
    (3072, 3584, 18944),   # teacher gate_proj
    (3072, 18944, 3584),   # teacher down_proj
    (7290, 4304, 1152),    # SigLIP fc2: K not a multiple of 32 (a zero-filled last box), a masked last M tile
    (1, 896, 4864),        # student decode gate_proj: A and B swapped
]


@pytest.mark.parametrize("n,k,m", INT8_SHAPES, ids=["gate_proj", "down_proj", "siglip_fc2", "decode"])
@pytest.mark.parametrize("form", ["xla", "k_block"])
def test_int8_matmul_is_bit_equal_to_plain(dev, n, k, m, form):
    """The s32 sums are exact and the f32 epilogue is the plain version's, so
    K12 equals it bit for bit; a kernel that drops the weight scales does not."""
    g = torch.Generator(device=dev).manual_seed(k)
    x = torch.randn(n, k, generator=g, device=dev).to(torch.bfloat16)
    wq, ws = int8.absmax_quantize_weight(torch.randn(m, k, generator=g, device=dev) * 0.02)
    kb = None if form == "xla" else int8.pick_block(k)
    got = int8.int8_matmul(x, wq, ws, k_block=kb)
    torch.cuda.synchronize()
    want = int8.int8_matmul_ref(x, wq, ws, k_block=kb)
    assert torch.equal(got, want)
    assert not torch.equal(int8.int8_matmul(x, wq, torch.ones_like(ws), k_block=kb), want)


def test_int8_matmul_forms_differ_past_one_k_block(dev):
    x, wq, ws = _operands(dev, 64, 2048, 256, seed=1)
    xla = int8.int8_matmul(x, wq, ws, torch.float32)
    kb = int8.int8_matmul(x, wq, ws, torch.float32, k_block=int8.pick_block(2048))
    one = int8.int8_matmul(x[:, :512].contiguous(), wq[:, :512].contiguous(), ws, torch.float32)
    one_kb = int8.int8_matmul(x[:, :512].contiguous(), wq[:, :512].contiguous(), ws, torch.float32, k_block=512)
    assert not torch.equal(xla, kb)
    assert _close(one_kb, one)[0]  # a single K block: the two forms agree


def test_int8_bounds_see_faults(dev):
    """Weight scales of 1 in half the columns, and every row scaled by the
    first row's amax, fail the bounds the kernel is held by."""
    x, wq, ws = _operands(dev, 256, 1024, 512, seed=2)
    want = int8.int8_matmul_ref(x, wq, ws, torch.float32)
    bad_ws = ws.clone()
    bad_ws[::2] = 1.0
    assert not _close(int8.int8_matmul(x, wq, bad_ws, torch.float32), want)[0]
    xq = torch.empty(256, 1024, dtype=torch.int8, device=dev)
    xs = torch.empty(256, 1, dtype=torch.float32, device=dev)
    _build.int8_quantize(x, xq, xs, 1024, xla_form=True)
    out = torch.empty(256, 512, dtype=torch.float32, device=dev)
    _build.int8_gemm(xq, xs[:1].expand(256, 1).contiguous(), wq, ws, out, 1024)
    assert not _close(out, want)[0]
    _build.int8_gemm(xq, xs, wq, ws, out, 1024)
    assert _close(out, want)[0]


def test_qlinear_on_the_card_matches_plain(dev):
    lin = torch.nn.Linear(1152, 4304, device=dev, dtype=torch.bfloat16)
    q = QLinear.from_linear(lin)
    x = torch.randn(2, 50, 1152, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        got = q(x)
    want = int8.int8_matmul_ref(x, q.weight_q, q.weight_scale, torch.bfloat16) + q.bias
    assert got.shape == (2, 50, 4304)
    ok, errs = _close(got, want)
    assert ok, errs


def test_int8_matmul_refuses_what_the_kernel_does_not_take(dev):
    x, wq, ws = _operands(dev, 16, 96, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        int8.int8_matmul(x.float(), wq, ws)
    with pytest.raises(ValueError, match="multiple"):
        int8.int8_matmul(x[:, :88].contiguous(), wq[:, :88].contiguous(), ws)
    with pytest.raises(ValueError, match="k_block"):
        int8.int8_matmul(x, wq, ws, k_block=96)
    with pytest.raises(ValueError, match="no backward"):
        int8.int8_matmul(x.float().requires_grad_(True), wq, ws)


# K12's split form at the 7B teacher's t = 2 local shapes (rows N, K, M):
# gate_proj column-wise, down_proj row-wise; then a ragged N and M, a
# partial last K box, and decode rows (A and B swapped).
SPLIT_SHAPES = [(3072, 3584, 9472), (3072, 9472, 3584), (300, 1040, 264), (5, 896, 4864), (1, 2368, 3584)]


@pytest.mark.parametrize("n,k,m", SPLIT_SHAPES, ids=["gate_t2", "down_t2", "ragged", "few_rows", "decode"])
def test_split_pieces_are_bit_equal_to_plain(dev, n, k, m):
    """Each kernel of the split form bit for bit against its plain version
    (one launch each), and with no group the split form against the fused
    K12; a scale epilogue fed ws of 1 breaks the bits."""
    g = torch.Generator(device=dev).manual_seed(n + k)
    x = torch.randn(n, k, generator=g, device=dev).to(torch.bfloat16)
    wq, ws = int8.absmax_quantize_weight(torch.randn(m, k, generator=g, device=dev) * 0.02)
    int8.reset_launch_counts()
    amax = int8.int8_row_absmax(x)
    xq, xs = int8.int8_quantize_rows(x, amax * 0.5)  # a given amax: a clip the rows do not compute
    acc = int8.int8_gemm_s32(xq, wq)
    outs = [int8.int8_scale_epilogue(acc, xs, ws, dt) for dt in (torch.bfloat16, torch.float32)]
    torch.cuda.synchronize()
    assert (int8.int8_row_absmax.launches, int8.int8_quantize_rows.launches, int8.int8_gemm_s32.launches,
            int8.int8_scale_epilogue.launches, int8.int8_matmul.launches) == (1, 1, 1, 2, 0)
    assert torch.equal(amax, int8.row_absmax_ref(x))
    want_q = int8.quantize_rows_ref(x, amax * 0.5)
    assert torch.equal(xq, want_q[0]) and torch.equal(xs, want_q[1])
    assert torch.equal(acc, int8.gemm_s32_ref(xq, wq))
    for out, dt in zip(outs, (torch.bfloat16, torch.float32)):
        assert out.dtype == dt and torch.equal(out, int8.scale_epilogue_ref(acc, xs, ws, dt))
    assert not torch.equal(int8.int8_scale_epilogue(acc, xs, torch.ones_like(ws)), outs[0])
    assert torch.equal(int8.int8_matmul_rowwise(x, wq, ws, None), int8.int8_matmul(x, wq, ws))


def test_split_pieces_refuse_what_the_kernels_do_not_take(dev):
    x, wq, ws = _operands(dev, 16, 96, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        int8.int8_row_absmax(x.float())
    with pytest.raises(ValueError, match="multiple"):
        int8.int8_row_absmax(x[:, :88].contiguous())
    with pytest.raises(ValueError, match="amax"):
        int8.int8_quantize_rows(x, torch.ones(15, device=dev))
    with pytest.raises(ValueError, match="multiple"):
        int8.int8_gemm_s32(torch.zeros(16, 96, dtype=torch.int8, device=dev), wq[:60].contiguous())
    with pytest.raises(ValueError, match="int32"):
        int8.int8_scale_epilogue(torch.zeros(16, 64, device=dev), torch.ones(16, device=dev), ws)
    with pytest.raises(ValueError, match="no backward"):
        int8.int8_matmul_rowwise(x.float().requires_grad_(True), wq, ws)


@pytest.mark.parametrize("n,vt,vocab,d", [
    (200, 136, 128, 256),      # one vocab tile, ragged rows
    (257, 1040, 1000, 3584),   # several vocab tiles, a ragged last one, the teacher's width
    (3, 640, 640, 96),         # a few rows, D not a multiple of the 64-column k step (zero-padded)
    (64, 300, 133, 256),       # an odd vocab ending in a partial 128-row wgmma tile
    (1, 640, 640, 256),        # one row
    (513, 260, 256, 512),      # two 256-row tiles plus one row
], ids=["one_tile", "several_tiles", "few_rows", "partial_vocab_tile", "one_row", "row_tiles_plus_one"])
def test_k10_matches_plain(dev, n, vt, vocab, d):
    g = torch.Generator(device=dev).manual_seed(n)
    ht = torch.randn(n, d, generator=g, device=dev).to(torch.bfloat16)
    wq, ws = int8.absmax_quantize_weight(torch.randn(vt, d, generator=g, device=dev) * 0.05)
    fl.reset_launch_counts()
    got = fl.materialize_teacher_logits_int8(ht, wq, ws, 1.25, vocab)
    torch.cuda.synchronize()
    assert fl.materialize_teacher_logits_int8.launches == 1
    assert got.shape == (n, vocab) and got.dtype == torch.float32
    ok, errs = _close(got, fl.materialize_teacher_logits_int8_ref(ht, wq, ws, 1.25, vocab))
    assert ok, errs


def _k10_case(dev, n=300, vt=700, d=512, seed=7):
    g = torch.Generator(device=dev).manual_seed(seed)
    ht = torch.randn(n, d, generator=g, device=dev).to(torch.bfloat16)
    wq, ws = int8.absmax_quantize_weight(torch.randn(vt, d, generator=g, device=dev) * 0.05)
    return ht, wq, ws


def test_k10_takes_an_offset_view_of_the_hidden_states(dev):
    """ht as a strided view at an offset (not 16-byte aligned): the wrapper
    copies it into K10's layout (ops/fused_loca.py::k10_hidden_layout)."""
    ht, wq, ws = _k10_case(dev)
    buf = torch.zeros(ht.shape[0] + 1, ht.shape[1] + 3, dtype=torch.bfloat16, device=dev)
    buf[1:, 3:] = ht
    view = buf[1:, 3:]
    assert view.data_ptr() % 16 and not view.is_contiguous()
    got = fl.materialize_teacher_logits_int8(view, wq, ws, 1.25, 600)
    ok, errs = _close(got, fl.materialize_teacher_logits_int8_ref(ht, wq, ws, 1.25, 600))
    assert ok, errs


def test_k10_is_deterministic_and_sees_a_dropped_scale(dev):
    """Two launches are bit-identical, and the bounds fail K10 fed scales of 1
    (a kernel that drops ws)."""
    ht, wq, ws = _k10_case(dev)
    first = fl.materialize_teacher_logits_int8(ht, wq, ws, 1.25, 600)
    second = fl.materialize_teacher_logits_int8(ht, wq, ws, 1.25, 600)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    want = fl.materialize_teacher_logits_int8_ref(ht, wq, ws, 1.25, 600)
    assert _close(first, want)[0]
    assert not _close(fl.materialize_teacher_logits_int8(ht, wq, torch.ones_like(ws), 1.25, 600), want)[0]
