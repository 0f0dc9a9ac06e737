"""The host plan of the Hopper vocab core (``csrc/kdss_vocab_sm90.cuh``):
the grids, scratch and tensor maps of the kernels that run on it, K11 and
K9 (``fused_loca``), the fused CE forward and backward K5 and K6
(``fused_ce``) and the temperature-KL forward and backward K7 and K8
(``fused_kl``).

A forward on the core is one sweep (two for K11 and K9) whose consumer
warpgroups each write per-row partials, then a combine in a fixed order.
A backward is one sweep that writes the bf16 d_logits ds [N, V] once, then
the products dh = ds w (split over the vocab, f32 partials summed in split
order) and dW = ds^T h.  :func:`vocab_plan` states the grids and scratch,
:func:`vocab_maps` the tensor maps, and :func:`fwd_scratch` and
:func:`bwd_scratch` allocate a forward's and a backward's scratch on the
card.
"""

from __future__ import annotations

import torch

# The products' tile (rows a block, two consumer warpgroups of 64; columns;
# the k step), the sweep's rows a block (one consumer warpgroup's, its h
# kept in shared memory) and its consumer warpgroups, each writing its own
# forward partials; the ring stages of the sweep and of the products.
VOCAB_TILE = (128, 128, 64)
SWEEP_ROWS = 64
SWEEP_CONSUMERS = 2
VOCAB_STAGES = (7, 5)
# The grids aim at this many waves of blocks (the sweep) and at least this
# many blocks an SM (dh's split over the vocab).
SWEEP_WAVES = 4
DH_BLOCKS_PER_SM = 8
# Planes of K11's and K9's forward partials (the kernels' pass-1 planes).
LOCA_PARTS = 7


def _even_split(units: int, want: int) -> int:
    """``want`` splits of ``units`` (clamped to [1, units]), cut back so that
    none is empty: the kernels give split s units [s * per, (s + 1) * per)."""
    per = -(-units // max(1, min(want, units)))
    return -(-units // per)


def vocab_plan(n: int, v: int, d: int, sms: int) -> dict:
    """The grids and scratch of the core's kernels at N = ``n``, V = ``v``,
    D = ``d`` on a card of ``sms`` SMs: the sweeps' row blocks and vocab
    tiles, their vocab splits (``nsplit``, about SWEEP_WAVES waves of
    blocks), K11's and K9's forward partials [LOCA_PARTS, SWEEP_CONSUMERS *
    nsplit, N], a backward's bf16 ds [N, ld_ds] (rows padded to 8 columns,
    16 bytes), dh's split over the vocab k steps and its f32 partials, and
    the products' grids (d tiles, row or vocab tiles, splits)."""
    bm, bn, bk = VOCAB_TILE
    row_blocks, vocab_tiles = -(-n // SWEEP_ROWS), -(-v // bn)
    nsplit = _even_split(vocab_tiles, -(-SWEEP_WAVES * sms // row_blocks))
    d_tiles, ksteps, gemm_rows = -(-d // bn), -(-v // bk), -(-n // bm)
    dh_split = _even_split(ksteps, -(-DH_BLOCKS_PER_SM * sms // (gemm_rows * d_tiles)))
    ld_ds = -(-v // 8) * 8
    return dict(row_blocks=row_blocks, vocab_tiles=vocab_tiles, nsplit=nsplit,
                part=(LOCA_PARTS, SWEEP_CONSUMERS * nsplit, n), ds=(n, ld_ds), ld_ds=ld_ds, dh_split=dh_split,
                dh_part=(dh_split, n, d), dh_grid=(d_tiles, gemm_rows, dh_split),
                dw_grid=(d_tiles, -(-v // bm), 1))


def _map(rows: int, cols: int, ld: int, box_rows: int) -> dict:
    """``bf16_map`` of ``csrc/kdss_vocab_sm90.cuh``: a row-major bf16 [rows,
    cols] tensor of row stride ``ld`` in boxes of 64 columns x ``box_rows``."""
    if (ld * 2) % 16 or not 0 < box_rows <= 256:
        raise ValueError(f"TMA cannot map [{rows}, {cols}] (row stride {ld * 2} bytes) in boxes of 64 x {box_rows}")
    return dict(dims=(cols, rows), strides=(ld * 2,), box=(64, box_rows), zero_fill=-(-cols // 64) * 64 - cols)


def vocab_maps(n: int, v: int, d: int, ld_ds: int, teacher: bool = True) -> dict:
    """The tensor maps of ``csrc/kdss_vocab_sm90.cuh`` (dims innermost first,
    the row stride in bytes, the box in elements, 128-byte swizzle; TMA
    zero-fills ``zero_fill`` columns of the last box): the sweeps' h (a block's
    rows, K-major) and head (K-major, 128-row boxes); dh's ds (K-major) and
    head (N-major); dW's ds (read M-major) and h (N-major).  A sweep that
    reads the teacher (``teacher``: K11, K9, K8; not K6) reads tmat [N, V]
    f32 in 8-byte pairs, and every ds row must start 16-byte aligned.
    Raises ValueError for what the kernels cannot take (V % 4 != 0 with a
    teacher, ld_ds % 8 != 0)."""
    bm, bn, bk = VOCAB_TILE
    if (teacher and v % 4) or ld_ds % 8 or ld_ds < v:
        raise ValueError(f"the kernels take V a multiple of 4 (with a teacher) and ds rows of a multiple "
                         f"of 8 >= V: V={v}, ld_ds={ld_ds}")
    return dict(
        h=_map(n, d, d, SWEEP_ROWS), w=_map(v, d, d, bn),
        ds_k=_map(n, v, ld_ds, bm), w_n=_map(v, d, d, bk),
        ds_m=_map(n, v, ld_ds, bk), h_n=_map(n, d, d, bk))


def plan_for(hs, ws) -> dict:
    """:func:`vocab_plan` for hidden states ``hs`` [N, D] and a head ``ws``
    [V, D] on their card."""
    sms = torch.cuda.get_device_properties(hs.device).multi_processor_count
    return vocab_plan(hs.shape[0], ws.shape[0], hs.shape[1], sms)


def fwd_scratch(hs, ws, planes: int):
    """A forward's partials, f32 [planes, SWEEP_CONSUMERS * nsplit, N]: a
    plane of each statistic the loss's epilogue writes, for every vocab
    split and consumer warpgroup of the sweep and every row."""
    _, parts, n = plan_for(hs, ws)["part"]
    return torch.empty(planes, parts, n, dtype=torch.float32, device=hs.device)


def bwd_scratch(hs, ws):
    """A backward's scratch: (bf16 ds [N, ld_ds], dh's f32 partials, the ds
    sweep's vocab splits)."""
    plan = plan_for(hs, ws)
    return (torch.empty(plan["ds"], dtype=torch.bfloat16, device=hs.device),
            torch.empty(plan["dh_part"], dtype=torch.float32, device=hs.device), plan["nsplit"])
