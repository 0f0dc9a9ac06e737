"""The work arithmetic (``portbench/counts``) against hand-worked counts and
against PERF.md's table of kernels, whose Bound column ``chip_smoke.py``
computed at the main paths' shapes."""

import json
from pathlib import Path

import pytest

from portbench.counts import kernels as k
from portbench.counts import roofline, step
from portbench.counts.peaks import BF16_FLOPS, HBM_BYTES_PER_S

ROOT = Path(__file__).resolve().parents[2]


def ms(fb):
    return k.bound(*fb)[0]


def test_bound_is_the_larger_of_operations_and_bytes():
    assert k.bound(989e9, 0) == (pytest.approx(1.0), "operations")
    assert k.bound(0, 3.35e9) == (pytest.approx(1.0), "bytes")
    assert k.bound(989e9, 2 * 3.35e9)[1] == "bytes"


def test_attended_pairs_by_hand():
    # 4 queries over 3 valid keys, causal: 1 + 2 + 3 + 3
    assert k.attended_pairs(4, [3], causal=True) == 9
    assert k.attended_pairs(4, [3], causal=False) == 12
    assert k.attended_pairs(2, [5, 1], causal=True) == (1 + 2) + (1 + 1)


def test_flash_forward_by_hand():
    # one sample, 2 queries, 2 keys, 1 head of d 4, non-causal, unmasked, no lse
    flops, nbytes = k.flash_fwd([(2, 2, 2)], 1, 1, 4, causal=False, masked=False)
    assert flops == 4 * 4 * 1 * 4
    assert nbytes == 4 * (2 * 4) * 2  # q, k, v, out: 2 rows x 4, bf16


@pytest.mark.parametrize("name, fb, table_ms", [
    ("K1", k.flash_fwd([(729, 729, 729)] * 10, 16, 16, 72, False, False), 0.0248),
    ("K2", k.flash_bwd([(729, 729, 729)] * 10, 16, 16, 72, False, False), 0.0619),
    ("K3 d64", k.flash_fwd([(3072, 3104, 2936)], 14, 2, 64, True, True), 0.0171),
    ("K3 d128", k.flash_fwd([(3072, 3072, 2936)], 28, 4, 128, True, True), 0.0683),
    ("K4", k.flash_bwd([(3072, 3072, 2936)], 14, 2, 64, True, True), 0.0427),
    ("K5", k.ce_fwd(3072, 896, 151936), 0.8457),
    ("K6", k.ce_bwd(3072, 896, 151936), 2.5371),
    ("K7", k.kl_fwd(3072, 896, 151936), 0.8457),
    ("K8", k.kl_bwd(3072, 896, 151936), 2.5371),
    ("K8 dh", k.kl_bwd(3072, 896, 151936, need_dw=False), 1.6914),
    ("K11 fwd", k.loca_ce_fwd(3072, 896, 151936), 0.8457),
    ("K11 bwd", k.loca_ce_bwd(3072, 896, 151936), 2.5371),
])
def test_bounds_match_perf_md_table(name, fb, table_ms):
    assert ms(fb) == pytest.approx(table_ms, abs=5e-5), name


def test_vocab_kernels_bytes_by_hand():
    n, d, v = 8, 4, 16
    assert k.ce_fwd(n, d, v) == (2 * n * d * v, (n * d + v * d) * 2 + n * 4 + 2 * n * 4)
    assert k.loca_ce_fwd(n, d, v)[1] == (n * d + v * d) * 2 + n * v * 4 + 2 * n * 4 + 8 * n * 4


TINY = {"vision_config": {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 1,
                          "num_attention_heads": 2, "image_size": 4, "patch_size": 2},
        "text_config": {"model_type": "qwen2", "hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 1,
                        "num_attention_heads": 2, "num_key_value_heads": 1, "vocab_size": 10}}


def test_step_flops_by_hand():
    # vision, one tile: T = 4 tokens, D 4, I 8: patch 2*4*12*4 = 384, linear
    # 2*4*4*16 + 2*2*4*4*8 = 1024, attention 4*4*4*4 = 256; projector
    # 2*4*(16 + 16) = 256.  LM, 3 real tokens of a bucket of 5 (baseline: 3
    # rows, head rows 2): per token 2*4*(2*2 + 2*1*2) + 2*2*2*4 + 6*4*8 = 288,
    # pairs 1+2+3 = 6, attention 4*6*2*2 = 96; head 2*2*4*10 = 160.
    cfg = {"student": TINY, "teacher": None}
    base = {"objective": "baseline", "phase": 0}
    got = step.sample_flops(cfg, base, 5, step.Sample(tiles=1, tokens=3))
    assert got == {"student_vision": 2 * 384 + 3 * 1024 + 3 * 256, "student_projector": 3 * 256,
                   "student_lm": 3 * (3 * 288 + 96), "student_head": 3 * 160}
    # phase 1 reads all 5 rows; the LM frozen: linear x2, attention x3, head x2
    cfg_kd = {"student": TINY, "teacher": TINY}
    got = step.sample_flops(cfg_kd, {"objective": "double_trouble", "phase": 1}, 5, step.Sample(1, 3))
    pairs = 1 + 2 + 3 + 3 + 3
    lm_lin, lm_att, head = 5 * 288, 4 * pairs * 2 * 2, 2 * 5 * 4 * 10
    assert got["student_lm"] == 2 * lm_lin + 3 * lm_att and got["student_head"] == 2 * head
    assert got["teacher_lm"] == lm_lin + lm_att and got["teacher_head"] == head
    assert got["teacher_vision"] == 384 + 1024 + 256


def test_kd_sample_needs_about_69_tflop():
    cfg = json.loads((ROOT / "portbench/configs/llava-ov-0.5b-depth-kd-7b.json").read_text())
    job = json.loads((ROOT / "portbench/traffic/phase3-b2x32.json").read_text())
    total = sum(step.sample_flops(cfg, job, 3072, step.Sample(5, 2936)).values())
    assert 60e12 < total < 75e12


def test_roofline_needs_the_counted_launches():
    cfg = json.loads((ROOT / "portbench/configs/llava-ov-0.5b-depth.json").read_text())
    job = json.loads((ROOT / "portbench/traffic/baseline-b4x16.json").read_text())
    mb = [[step.Sample(5, 2936)] * 4] * 2
    ok = {"ce_fwd": 2, "ce_bwd": 2}
    least = roofline.least_ms(cfg, job, 3072, mb, "ce", ok)
    n = 4 * 2935
    assert least == pytest.approx(2 * (ms(k.ce_fwd(n, 896, 151936)) + ms(k.ce_bwd(n, 896, 151936))))
    assert roofline.least_ms(cfg, job, 3072, mb, "ce", {"ce_fwd": 1, "ce_bwd": 2}) is None
    assert roofline.least_ms(cfg, job, 3072, mb, "loca_ce", ok) is None
    assert roofline.share_pct(least, 2 * least) == pytest.approx(50.0)
    assert roofline.share_pct(None, 1.0) is None


def test_peaks_are_the_data_sheet_s():
    assert (BF16_FLOPS, HBM_BYTES_PER_S) == (989e12, 3.35e12)
