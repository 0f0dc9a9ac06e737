"""Least time of one launch of the port's kernels, from its shapes.

Copied from ``chip_smoke.py`` (``bound``, ``nbytes``, ``attended_pairs``
and the operation counts of its ``[kernel]`` phase), so that a change to the
program cannot move the yardstick: the operations over the bf16 peak or the
bytes over the memory rate, whichever is larger, each input byte read once
and each output byte written once.  The flash backward counts the recompute
of the scores (10 products of a pair against the forward's 4) and a vocab
kernel's backward the recompute of the logits (6 N D V against 2 N D V), as
the kernels' own algorithms need them: neither forward hands the [N, V] or
[S, S] matrices on.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from .peaks import BF16_FLOPS, HBM_BYTES_PER_S

BF16, F32, I32, BOOL = 2, 4, 4, 1


def bound(flops: float, nbytes: float, peak: float = BF16_FLOPS) -> Tuple[float, str]:
    """(least time in ms, what bounds it)."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attended_pairs(sq: int, valid_keys: Sequence[int], causal: bool) -> int:
    """(query, key) pairs that attend, summed over the batch, per head: each
    entry of ``valid_keys`` is a sample whose first ``n`` keys are valid
    (right padding) and which has ``sq`` query rows; a causal query ``i``
    attends to keys ``<= i``."""
    total = 0
    for n in valid_keys:
        n = int(n)
        if not causal:
            total += sq * n
        else:
            m = min(sq, n)
            total += m * (m + 1) // 2 + (sq - m) * n
    return total


Samples = Sequence[Tuple[int, int, int]]


def _flash_parts(samples: Samples, hq: int, hkv: int, d: int, causal: bool):
    """(pairs, q elements, kv elements, kv slots) over ``samples``, each
    (query rows, kv slots, valid keys)."""
    pairs = sum(attended_pairs(sq, [n], causal) for sq, _, n in samples)
    q = sum(sq for sq, _, _ in samples) * hq * d
    slots = sum(skv for _, skv, _ in samples)
    return pairs, q, slots * hkv * d, slots


def flash_fwd(samples: Samples, hq: int, hkv: int, d: int, causal: bool, masked: bool,
              lse: bool = False) -> Tuple[float, float]:
    """(operations, bytes) of the flash forward (K1, K3): q, k, v and the
    kv mask read, out (and the f32 lse) written."""
    pairs, q, kv, slots = _flash_parts(samples, hq, hkv, d, causal)
    nbytes = (2 * q + 2 * kv) * BF16 + (slots * BOOL if masked else 0)
    nbytes += q // d * F32 if lse else 0
    return 4.0 * pairs * hq * d, float(nbytes)


def flash_bwd(samples: Samples, hq: int, hkv: int, d: int, causal: bool, masked: bool) -> Tuple[float, float]:
    """(operations, bytes) of the flash backward (K2, K4): q, k, v, dout,
    lse, delta and the mask read, dq, dk, dv written."""
    pairs, q, kv, slots = _flash_parts(samples, hq, hkv, d, causal)
    nbytes = (2 * q + 2 * kv) * BF16 + 2 * (q // d) * F32 + (q + 2 * kv) * BF16
    nbytes += slots * BOOL if masked else 0
    return 10.0 * pairs * hq * d, float(nbytes)


def ce_fwd(n: int, d: int, v: int) -> Tuple[float, float]:
    """K5: h, the head and the labels read; lse and gold written."""
    return 2.0 * n * d * v, float((n * d + v * d) * BF16 + n * I32 + 2 * n * F32)


def ce_bwd(n: int, d: int, v: int) -> Tuple[float, float]:
    """K6: h, the head, labels, lse and two cotangents read; dh, dW written."""
    return 6.0 * n * d * v, float(2 * (n * d + v * d) * BF16 + n * I32 + 3 * n * F32)


def kl_fwd(n: int, d: int, v: int) -> Tuple[float, float]:
    """K7: h, the head and the f32 teacher logits read; kl, lse_s, lse_t written."""
    return 2.0 * n * d * v, float((n * d + v * d) * BF16 + n * v * F32 + 3 * n * F32)


def kl_bwd(n: int, d: int, v: int, need_dw: bool = True) -> Tuple[float, float]:
    """K8: with dW as K6 plus the teacher logits; dh alone (a frozen head)
    4 N D V, dh written and the head read once."""
    if need_dw:
        return 6.0 * n * d * v, float(2 * (n * d + v * d) * BF16 + n * v * F32 + 3 * n * F32)
    return 4.0 * n * d * v, float((2 * n * d + v * d) * BF16 + n * v * F32 + 3 * n * F32)


def loca_ce_fwd(n: int, d: int, v: int) -> Tuple[float, float]:
    """K11 forward: h, the head, the teacher logits and both label rows
    read; kl, ce and the six row statistics written."""
    return 2.0 * n * d * v, float((n * d + v * d) * BF16 + n * v * F32 + 2 * n * I32 + 8 * n * F32)


def loca_ce_bwd(n: int, d: int, v: int) -> Tuple[float, float]:
    """K11 backward: h, the head, the teacher logits, both label rows, the
    row statistics and two cotangents read; dh, dW written."""
    return 6.0 * n * d * v, float(2 * (n * d + v * d) * BF16 + n * v * F32 + 2 * n * I32 + 8 * n * F32)
