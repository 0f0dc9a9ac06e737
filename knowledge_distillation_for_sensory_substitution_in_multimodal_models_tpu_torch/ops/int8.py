"""Int8 (w8a8) projections for the frozen KD teacher and int8 serving (port
of the JAX package's ``ops/int8.py``).

Scheme, as in the JAX package (symmetric w8a8):

* weights: per-output-channel absmax int8 (:func:`absmax_quantize_weight`),
  quantized once; a torch weight is [out, in], so its scale is one per row,
  and ``weight_q`` is the transpose of the JAX ``kernel_q`` [in, out];
* activations: per-row dynamic absmax int8, quantized on the fly;
* an exact int32 product, rescaled in f32, out in the model dtype.

:func:`int8_matmul` computes the two activation forms of the JAX package
through one kernel, K12 (``csrc/int8_mm.cu``: a quantize pass, then an s8
wgmma GEMM fed by TMA, whose shapes :func:`gemm_shape` and maps
:func:`tma_map` state), chosen by ``k_block``:

* ``k_block=None``: one absmax per row over the whole of K, the JAX
  ``int8_matmul_xla``.  It is what ``int8_matmul(impl="auto")`` resolves to,
  so what every JAX CLI computes, and it is the form ``QLinear`` uses;
* ``k_block=pick_block(K)``: one absmax per row per K block, the numerics
  of the JAX Pallas kernel ``int8_matmul_pallas`` (``KDSS_INT8_IMPL=pallas``
  there).  The two agree exactly only when K <= the block.

On a CUDA tensor the wrapper launches K12 or raises; on a CPU tensor it runs
the plain version :func:`int8_matmul_ref`, which computes both forms with the
same arithmetic (the integer products summed exactly in float64).  K12 has
no backward (the JAX package defines none): inputs must not require grad.

The split form, for a projection whose K is split over a tensor-parallel
group (a row-wise ``QLinear``, ``parallel/sharding.py``):
:func:`int8_matmul_rowwise` runs the XLA form in four launches of K12's
source, with two all-reduces between them.  The JAX form has global
semantics under GSPMD (the absmax over all of K, an int32 dot, the scales
after), and so does this: each rank writes the local ``max |x|`` of its K
columns (:func:`int8_row_absmax`), the group takes their MAX, each rank
quantizes its columns with that global amax (:func:`int8_quantize_rows`,
the 1e-6 clamp applied to the global value), multiplies them into raw int32
partial sums (:func:`int8_gemm_s32`), the group SUMs the int32 partials
(exact: |acc| <= K * 127^2 <= 18944 * 16129 < 2^31 at every width of the
repo), and each rank applies the scales (:func:`int8_scale_epilogue`,
``(float(acc) * (amax / 127)) * ws``).  So the sharded product equals the
one-device product bit for bit, and with no group it equals
:func:`int8_matmul`'s.  Each piece has its plain version (``*_ref``).

:func:`quantize_model_int8` is the counterpart of the JAX
``quantize_lm_params_int8``: it replaces a model's ``nn.Linear`` projections
(and optionally its token embedding and untied head) by their int8 modules
in place, one module at a time, so a bf16 model is never held twice.

Counters: ``int8_matmul.launches``, one per call that launches K12 (its
quantize and GEMM kernels together), and one on each piece of the split
form (``int8_row_absmax.launches``, ``int8_quantize_rows.launches``,
``int8_gemm_s32.launches``, ``int8_scale_epilogue.launches``), one per
kernel launch.  CPU calls never count.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

# Modules whose weight becomes (weight_q, weight_scale); they match the
# QLinear call sites of models/qwen2.py and models/siglip.py.
QUANTIZED_PROJ_NAMES = frozenset(
    {"q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"}
)
# SigLIP encoder projections; the patch conv, norms and position embedding
# stay bf16.
QUANTIZED_VISION_NAMES = frozenset({"q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"})

# K12's K-block preference (the JAX ``_INT8_BK``).
K_BLOCK = 512
# The GEMM kernel (csrc/int8_mm.cu): K bytes a TMA box and a pipeline stage
# (one 128-byte swizzle row), the N at and below which A and B swap (decode),
# and its three shapes, (swapped, A rows a tile, B rows a tile): the XLA form
# and K12's form at N > DECODE_ROWS, and decode.
GEMM_BK = 128
DECODE_ROWS = 8
GEMM_SHAPES = {"xla": (False, 128, 256), "k_block": (False, 128, 128), "decode": (True, 64, 8)}


def gemm_shape(n: int, k: int, k_block: Optional[int]) -> Tuple[bool, int, int]:
    """The GEMM shape that K12 runs for N rows of x: (A and B swapped, A
    rows, B rows) of a tile.  Swapped, A is the weight and B the x rows."""
    if n <= DECODE_ROWS:
        return GEMM_SHAPES["decode"]
    return GEMM_SHAPES["xla" if k_block is None or k_block >= k else "k_block"]


def tma_map(rows: int, k: int, box_rows: int) -> dict:
    """The tensor map K12 loads an int8 [rows, K] operand through
    (``int8_map`` in ``csrc/int8_mm.cu``): dims {K, rows}, the row stride in
    bytes, boxes of ``GEMM_BK`` K bytes x ``box_rows`` rows with the 128-byte
    swizzle; the boxes a row takes and the bytes TMA zero-fills past K in
    the last one.  Raises ValueError for a map TMA cannot encode."""
    if k % 16:
        raise ValueError(f"TMA needs a 16-byte row stride: K={k}")
    if not 0 < box_rows <= 256 or not 0 < rows < 2**32:
        raise ValueError(f"a TMA box of {box_rows} rows over {rows} rows")
    boxes = -(-k // GEMM_BK)
    return dict(dims=(k, rows), strides=(k,), box=(GEMM_BK, box_rows), boxes=boxes,
                zero_fill=boxes * GEMM_BK - k)


def pick_block(dim: int, pref: int = K_BLOCK) -> int:
    """Largest power-of-two block <= pref that divides dim (>= 128): the JAX
    ``_pick_block``, K12's K block (512 at the 7B widths, 128 at 896 and
    1152)."""
    b = pref
    while b > 128 and dim % b:
        b //= 2
    return b


def _div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c as an IEEE division (PyTorch turns division by a Python scalar
    into a product with its reciprocal on CUDA, and ``c / tensor`` into one
    everywhere)."""
    return a / torch.full_like(a, c)


def absmax_quantize_weight(w: torch.Tensor, clip: float = 127.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """[out, in] float -> (int8 [out, in], f32 per-row scale [out]);
    ``dequant = wq * scale[:, None]``, symmetric, so zero maps to zero."""
    wf = w.float()
    scale = _div(wf.abs().amax(dim=1), clip).clamp_min(1e-8)
    wq = torch.round(wf / scale[:, None]).clamp_(-clip, clip).to(torch.int8)
    return wq, scale


def quantize_embedding_int8(emb: torch.Tensor, clip: float = 127.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """[V, D] embedding -> (int8 [V, D], f32 [V, 1] per-row scale): a lookup
    gathers one row and its one scale."""
    eq, scale = absmax_quantize_weight(emb, clip)
    return eq, scale[:, None]


def int8_matmul_ref(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                    out_dtype: torch.dtype = torch.bfloat16, k_block: Optional[int] = None) -> torch.Tensor:
    """Plain version of K12: x [..., K] @ dequant(wq [M, K])^T -> [..., M].

    Per K block of x's rows (the whole of K for ``k_block=None``): amax =
    max(|x|, 1e-6), xq = clip(round(x * (127 / amax)), -127, 127) (half to
    even, as ``jnp.round``), acc = xq . wq summed exactly (float64) and
    rounded once to f32.  ``k_block=None``: y = (acc * (amax / 127)) * ws;
    else y = (sum over blocks of acc * (amax * (1/127))) * ws.  Then cast."""
    k = x.shape[-1]
    xf = x.float()
    wd = wq.double()
    kb = k if k_block is None else k_block
    y = None
    for k0 in range(0, k, kb):
        xb = xf[..., k0:k0 + kb]
        amax = xb.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
        xq = torch.round(xb * (torch.full_like(amax, 127.0) / amax)).clamp_(-127, 127)
        acc = (xq.double() @ wd[:, k0:k0 + kb].T).float()
        if k_block is None:
            y = acc * _div(amax, 127.0)
        else:
            term = acc * (amax * (1.0 / 127.0))
            y = term if y is None else y + term
    return (y * ws).to(out_dtype)


def kernel_args(x2: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, out_dtype, k_block) -> None:
    """Check what K12 takes; raise ValueError on anything else.  The shape
    checks come first and need no card, so the CPU tests reach them."""
    if x2.dtype != torch.bfloat16:
        raise ValueError(f"x must be bfloat16, got {x2.dtype}")
    k = x2.shape[1]
    if wq.dtype != torch.int8 or wq.ndim != 2 or wq.shape[1] != k or not wq.is_contiguous():
        raise ValueError(f"wq must be contiguous int8 [M, {k}], got {wq.dtype} {tuple(wq.shape)}")
    m = wq.shape[0]
    if ws.dtype != torch.float32 or ws.shape != (m,) or not ws.is_contiguous():
        raise ValueError(f"ws must be contiguous float32 [{m}], got {ws.dtype} {tuple(ws.shape)}")
    for t in (wq, ws):
        if t.device != x2.device:
            raise ValueError(f"operands on {t.device} and {x2.device}")
    if k % 16 or m % 8:
        raise ValueError(f"K12 takes K a multiple of 16 and M of 8, got K={k}, M={m}")
    if k_block is not None and (k_block <= 0 or k_block % GEMM_BK):
        raise ValueError(f"k_block must be a positive multiple of {GEMM_BK} or None, got {k_block}")
    swapped, a_rows, b_rows = gemm_shape(x2.shape[0], k, k_block)
    tma_map(m if swapped else x2.shape[0], k, a_rows)
    tma_map(x2.shape[0] if swapped else m, k, b_rows)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    if x2.device.type != "cuda":
        raise ValueError(f"K12 runs on CUDA tensors, got {x2.device}")


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                out_dtype: torch.dtype = torch.bfloat16, k_block: Optional[int] = None) -> torch.Tensor:
    """x [..., K] @ dequant(wq [M, K])^T with per-row dynamic activation
    quantization -> [..., M] in ``out_dtype``: K12 on CUDA, the plain
    version on the CPU (see the module docstring for ``k_block``)."""
    if x.requires_grad or wq.requires_grad or ws.requires_grad:
        raise ValueError("int8_matmul has no backward: its inputs must not require grad")
    if x.device.type == "cpu":
        return int8_matmul_ref(x, wq, ws, out_dtype, k_block)
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k).contiguous()
    kernel_args(x2, wq, ws, out_dtype, k_block)
    from . import _build

    n, m, dev = x2.shape[0], wq.shape[0], x2.device
    kb = k if k_block is None else k_block
    xq = torch.empty(n, k, dtype=torch.int8, device=dev)
    xs = torch.empty(n, -(-k // kb), dtype=torch.float32, device=dev)
    out = torch.empty(n, m, dtype=out_dtype, device=dev)
    _build.int8_quantize(x2, xq, xs, kb, xla_form=k_block is None)
    _build.int8_gemm(xq, xs, wq, ws, out, kb)
    int8_matmul.launches += 1
    return out.reshape(*lead, m)


# ------------------------------------------------------------ the split form


def row_absmax_ref(x2: torch.Tensor) -> torch.Tensor:
    """Plain version of the row-absmax pass: max |x| of each row of x2 [N,
    K] in f32 [N], unclamped."""
    return x2.float().abs().amax(dim=-1)


def quantize_rows_ref(x2: torch.Tensor, amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the quantize pass with a given row amax (f32 [N]):
    a = max(amax, 1e-6), xq = clip(round(x * (127 / a)), -127, 127) int8
    [N, K] (half to even) and the row scale xs = a / 127, f32 [N]."""
    a = amax.float().clamp_min(1e-6)[:, None]
    xq = torch.round(x2.float() * (torch.full_like(a, 127.0) / a)).clamp_(-127, 127).to(torch.int8)
    return xq, _div(a, 127.0)[:, 0]


def gemm_s32_ref(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Plain version of the int32 GEMM: xq [N, K] . wq [M, K]^T summed
    exactly (float64, exact below 2^53), as int32 [N, M]."""
    return (xq.double() @ wq.double().T).to(torch.int32)


def scale_epilogue_ref(acc: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor,
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of the scale epilogue: y = (float(acc) * xs) * ws in
    f32 (the JAX order), cast to ``out_dtype``."""
    return ((acc.float() * xs[:, None]) * ws).to(out_dtype)


def _split_args(x2: torch.Tensor) -> None:
    if x2.dtype != torch.bfloat16 or x2.ndim != 2 or not x2.is_contiguous():
        raise ValueError(f"x must be contiguous bfloat16 [N, K], got {x2.dtype} {tuple(x2.shape)}")
    if x2.shape[1] % 16:
        raise ValueError(f"K12 takes K a multiple of 16, got K={x2.shape[1]}")
    if x2.device.type != "cuda":
        raise ValueError(f"K12 runs on CUDA tensors, got {x2.device}")


def int8_row_absmax(x2: torch.Tensor) -> torch.Tensor:
    """max |x| of each row of bf16 x2 [N, K], f32 [N], unclamped: the
    row-absmax pass of K12 on CUDA, :func:`row_absmax_ref` on the CPU."""
    if x2.device.type == "cpu":
        return row_absmax_ref(x2)
    _split_args(x2)
    from . import _build

    amax = torch.empty(x2.shape[0], dtype=torch.float32, device=x2.device)
    _build.int8_absmax(x2, amax)
    int8_row_absmax.launches += 1
    return amax


def int8_quantize_rows(x2: torch.Tensor, amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xq int8 [N, K], xs f32 [N]) of bf16 x2 [N, K] quantized with the
    given row amax f32 [N] (clamped to 1e-6 here): K12's quantize pass on
    CUDA, :func:`quantize_rows_ref` on the CPU."""
    if x2.device.type == "cpu":
        return quantize_rows_ref(x2, amax)
    _split_args(x2)
    if amax.dtype != torch.float32 or amax.shape != (x2.shape[0],) or not amax.is_contiguous():
        raise ValueError(f"amax must be contiguous float32 [{x2.shape[0]}], got {amax.dtype} {tuple(amax.shape)}")
    from . import _build

    n, k, dev = x2.shape[0], x2.shape[1], x2.device
    xq = torch.empty(n, k, dtype=torch.int8, device=dev)
    xs = torch.empty(n, dtype=torch.float32, device=dev)
    _build.int8_quantize_given(x2, amax, xq, xs)
    int8_quantize_rows.launches += 1
    return xq, xs


def int8_gemm_s32(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The raw int32 sums xq [N, K] . wq [M, K]^T, int32 [N, M]: K12's GEMM
    with its epilogue skipped on CUDA, :func:`gemm_s32_ref` on the CPU."""
    if xq.device.type == "cpu":
        return gemm_s32_ref(xq, wq)
    n, k = xq.shape
    if xq.dtype != torch.int8 or not xq.is_contiguous():
        raise ValueError(f"xq must be contiguous int8 [N, K], got {xq.dtype} {tuple(xq.shape)}")
    if wq.dtype != torch.int8 or wq.ndim != 2 or wq.shape[1] != k or not wq.is_contiguous():
        raise ValueError(f"wq must be contiguous int8 [M, {k}], got {wq.dtype} {tuple(wq.shape)}")
    m = wq.shape[0]
    if k % 16 or m % 8:
        raise ValueError(f"K12 takes K a multiple of 16 and M of 8, got K={k}, M={m}")
    if wq.device != xq.device or xq.device.type != "cuda":
        raise ValueError(f"K12 runs on CUDA tensors, got {xq.device} and {wq.device}")
    swapped, a_rows, b_rows = gemm_shape(n, k, None)
    tma_map(m if swapped else n, k, a_rows)
    tma_map(n if swapped else m, k, b_rows)
    from . import _build

    acc = torch.empty(n, m, dtype=torch.int32, device=xq.device)
    _build.int8_gemm_s32(xq, wq, acc)
    int8_gemm_s32.launches += 1
    return acc


def int8_scale_epilogue(acc: torch.Tensor, xs: torch.Tensor, ws: torch.Tensor,
                        out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y = (float(acc) * xs) * ws from int32 acc [N, M], the row scales xs
    f32 [N] and the channel scales ws f32 [M], in ``out_dtype``: K12's scale
    epilogue on CUDA, :func:`scale_epilogue_ref` on the CPU."""
    if acc.device.type == "cpu":
        return scale_epilogue_ref(acc, xs, ws, out_dtype)
    n, m = acc.shape
    if acc.dtype != torch.int32 or not acc.is_contiguous() or m % 8:
        raise ValueError(f"acc must be contiguous int32 [N, M], M a multiple of 8, got {acc.dtype} "
                         f"{tuple(acc.shape)}")
    for name, t, size in (("xs", xs, n), ("ws", ws, m)):
        if t.dtype != torch.float32 or t.shape != (size,) or not t.is_contiguous() or t.device != acc.device:
            raise ValueError(f"{name} must be contiguous float32 [{size}] on {acc.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    from . import _build

    out = torch.empty(n, m, dtype=out_dtype, device=acc.device)
    _build.int8_epilogue(acc, xs, ws, out)
    int8_scale_epilogue.launches += 1
    return out


def int8_matmul_rowwise(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, group=None,
                        out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The split form (see the module docstring): x [..., K_local] @
    dequant(wq [M, K_local])^T summed over the ranks of ``group`` (their K
    shards), each rank's product quantized with the group's row absmax ->
    [..., M] in ``out_dtype``, equal on every rank.  ``ws`` f32 [M] is
    whole.  ``group`` None (or a group of one) makes no collective and
    equals :func:`int8_matmul` bit for bit.  Local amax -> all_reduce(MAX)
    -> quantize -> int32 GEMM -> all_reduce(SUM) on the int32 sums ->
    epilogue; the plain pieces on the CPU."""
    if x.requires_grad or wq.requires_grad or ws.requires_grad:
        raise ValueError("int8_matmul_rowwise has no backward: its inputs must not require grad")
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k).contiguous()
    if x2.device.type != "cpu":
        kernel_args(x2, wq, ws, out_dtype, None)
    split = group is not None and dist.get_world_size(group) > 1
    amax = int8_row_absmax(x2)
    if split:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    xq, xs = int8_quantize_rows(x2, amax)
    acc = int8_gemm_s32(xq, wq)
    if split:
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    return int8_scale_epilogue(acc, xs, ws, out_dtype).reshape(*lead, wq.shape[0])


def reset_launch_counts() -> None:
    int8_matmul.launches = 0
    for fn in (int8_row_absmax, int8_quantize_rows, int8_gemm_s32, int8_scale_epilogue):
        fn.launches = 0


reset_launch_counts()


@torch.no_grad()
def quantize_model_int8(model, include_vision: bool = False, include_embed_head: bool = False):
    """Quantize a ``LlavaOnevision`` (or a bare ``Qwen2LM``) in place and
    return it: the decoder-block projections (``QUANTIZED_PROJ_NAMES``)
    become ``QLinear``; ``include_vision`` also the SigLIP encoder
    projections (``QUANTIZED_VISION_NAMES``); ``include_embed_head`` the
    token embedding (``QEmbedding``, per-row scales) and the untied head (a
    ``QLinear`` whose ``weight_q`` is the vocab-major [Vt, Dt] int8 head with
    per-row scales, which the KD step hands to K10).  Norms, the patch conv
    and the projector stay as they are.  Each module is replaced as soon as
    it is quantized, so its float weight is freed before the next one."""
    from ..models.qwen2 import QEmbedding, QLinear

    def swap(root, names):
        for parent in list(root.modules()):
            for name, child in list(parent.named_children()):
                if name in names and isinstance(child, torch.nn.Linear):
                    setattr(parent, name, QLinear.from_linear(child))

    lm = getattr(model, "language_model", model)
    swap(lm.layers, QUANTIZED_PROJ_NAMES)
    if include_vision and hasattr(model, "vision_tower"):
        swap(model.vision_tower.layers, QUANTIZED_VISION_NAMES)
    if include_embed_head:
        if lm.cfg.tie_word_embeddings:
            raise ValueError("a tied head must stay float: quantize it with include_embed_head=False")
        lm.embed_tokens = QEmbedding.from_embedding(lm.embed_tokens)
        lm.lm_head = QLinear.from_linear(lm.lm_head)
    return model
