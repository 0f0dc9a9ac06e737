"""The port's int8 path (``ops/int8.py``, ``QLinear`` / ``QEmbedding``, the
plain K10 and the KD step with an int8 teacher) on the CPU against the JAX
package's, on the same numpy inputs and weights.

* Quantization is bit-exact: ``absmax_quantize_weight`` (int8 values and
  scales, the port's weight being the transpose of the JAX kernel),
  ``quantize_embedding_int8``, ``quantize_model_int8`` against
  ``quantize_lm_params_int8`` through ``params_from_flax`` (and back through
  ``flax_from_state_dict``), ``QEmbedding`` against ``QEmbed``.
* The plain ``int8_matmul`` (f32 out): the XLA form against
  ``int8_matmul_xla``, K12's K-block form against the Pallas
  ``int8_matmul_pallas`` in interpret mode; ``QLinear`` with a bias against
  ``QDense``: atol 1e-5 x max |out| (the same integer sums, the same f32
  epilogue; only f32 summation order differs).
* The plain K10 against ``_materialize_t_int8`` in interpret mode and
  ``_materialize_t`` with the int8 head (a ragged row count, which the TPU
  grid would drop): rtol 1e-5.
* Tiny int8 models against Flax at f32: relative Frobenius error <= 1e-3 of
  hidden states, vision features and logits.  Different f32 operation
  order between the frameworks can flip the rounding of single quantized
  activations, each an error of about amax / 127 x |w| in one output: at
  these inputs the worst case reads 9.8e-4, while other seeds of the same
  tiny teacher read up to 1.2e-2.  So every projection of the tiny teacher
  is also held to ``QDense`` on the same inputs, where the two agree bit
  for bit.
* The KD step with the tiny int8 teacher (``int8_full``, and ``int8_full``
  with the int8 embedding and vocab-major head) against JAX
  ``make_loss_fn`` (``ce_impl="chunked"``), phases 3 and 1: loss and terms
  rtol 1e-4, every student gradient leaf atol 1e-5 / rtol 1e-3."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.configs import (
    TrainConfig,
    kd_loss_config_for,
    llava_onevision_tiny,
    llava_onevision_tiny_teacher,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.models import (
    LlavaOnevision as FlaxLlava,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.models.qwen2 import (
    QDense,
    QEmbed,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.ops import int8 as jint8
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.ops.fused_loca import (
    _materialize_t,
    _materialize_t_int8,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.train import (
    KDModels as JaxKDModels,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.train.step import (
    dense_teacher_head as jax_dense_teacher_head,
    make_loss_fn as jax_make_loss_fn,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.utils.synthetic import (
    synthetic_kd_batch,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch import (
    configs as pcfg,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models import (
    LlavaOnevision,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models.convert import (
    flax_from_state_dict,
    params_from_flax,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models.qwen2 import (
    QEmbedding,
    QLinear,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops import int8
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops.fused_loca import (
    K10_PERM,
    k10_hidden_layout,
    materialize_teacher_logits_int8,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train import (
    KDModels,
    make_loss_fn,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train.step import (
    dense_teacher_head,
    teacher_head,
)

SCFG, TCFG = llava_onevision_tiny(), llava_onevision_tiny_teacher()
PSCFG, PTCFG = pcfg.llava_onevision_tiny(), pcfg.llava_onevision_tiny_teacher()
KEYS = ("pack_idx", "pack_weight", "pack_valid", "tile_valid")
QUANTS = [(False, False), (True, False), (False, True), (True, True)]
QUANT_IDS = ["lm", "lm+vision", "lm+embed_head", "lm+vision+embed_head"]


def _t(x):
    return torch.from_numpy(np.array(x, order="C"))


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


def _rel_fro(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _weights(rng, k, m, std=0.05):
    """A float [in, out] JAX kernel with a zero output channel (the 1e-8
    scale floor) and its quantization, both sides' layouts."""
    w = (rng.standard_normal((k, m)) * std).astype(np.float32)
    w[:, 3] = 0.0
    wq, ws = jint8.absmax_quantize_weight(jnp.asarray(w))
    return w, np.asarray(wq), np.asarray(ws)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absmax_quantize_weight_is_bit_exact(dtype):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((96, 80)) * 0.05).astype(np.float32)  # JAX [in, out]
    w[:, 5] = 0.0
    want_q, want_s = jint8.absmax_quantize_weight(jnp.asarray(w).astype(dtype))
    got_q, got_s = int8.absmax_quantize_weight(torch.from_numpy(w.T.copy()).to(getattr(torch, dtype)))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q).T)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_quantize_embedding_int8_is_bit_exact():
    emb = (np.random.default_rng(1).standard_normal((300, 48)) * 0.02).astype(np.float32)
    want_q, want_s = jint8.quantize_embedding_int8(jnp.asarray(emb))
    got_q, got_s = int8.quantize_embedding_int8(torch.from_numpy(emb))
    assert got_s.shape == (300, 1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def _init(model, key, micro, prefix):
    return jax.jit(model.init)(
        key, input_ids=micro[f"{prefix}_input_ids"],
        attention_mask=micro[f"{prefix}_attention_mask"],
        pixel_values=micro[f"{prefix}_pixel_values"], **{k: micro[k] for k in KEYS},
    )["params"]


@pytest.fixture(scope="module")
def setup():
    micros = [synthetic_kd_batch(SCFG, batch_size=2, seq_len=96, seed=s) for s in (3, 4)]
    batch = {k: np.stack([m[k] for m in micros]) for k in micros[0]}
    micro = {k: jnp.asarray(v[0]) for k, v in batch.items()}
    sparams = _init(FlaxLlava(SCFG), jax.random.PRNGKey(0), micro, "student")
    tparams = _init(FlaxLlava(TCFG), jax.random.PRNGKey(1), micro, "teacher")
    return sparams, tparams, batch


def _quantized_tree(params, include_vision, include_embed_head):
    return jint8.quantize_lm_params_int8(params, include_vision=include_vision,
                                         include_embed_head=include_embed_head)


def _modes(include_vision, include_embed_head):
    return dict(lm_quant="int8", vision_quant="int8" if include_vision else "none",
                embed_quant="int8" if include_embed_head else "none")


@pytest.mark.parametrize("include_vision,include_embed_head", QUANTS, ids=QUANT_IDS)
def test_quantize_model_int8_matches_quantize_lm_params_int8(setup, include_vision, include_embed_head):
    tparams = setup[1]
    jq = _quantized_tree(tparams, include_vision, include_embed_head)
    want = params_from_flax(jq, PTCFG)
    model = LlavaOnevision(PTCFG)
    model.load_state_dict(params_from_flax(tparams, PTCFG))
    int8.quantize_model_int8(model, include_vision, include_embed_head)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    n_q = sum(isinstance(m, QLinear) for m in model.modules())
    per_layer = (7 * TCFG.text.num_hidden_layers + 6 * TCFG.vision.num_hidden_layers * include_vision)
    assert n_q == per_layer + include_embed_head
    assert isinstance(model.language_model.embed_tokens, QEmbedding) == include_embed_head
    # a model built with the quant modes takes the converted tree as it is,
    # and the tree comes back leaf for leaf (the head's int8 not transposed)
    LlavaOnevision(PTCFG, **_modes(include_vision, include_embed_head)).load_state_dict(want)
    back = jax.tree_util.tree_flatten_with_path(flax_from_state_dict(got))[0]
    ref = dict((jax.tree_util.keystr(p), v) for p, v in jax.tree_util.tree_flatten_with_path(jq)[0])
    assert len(back) == len(ref)
    for p, v in back:
        w = np.asarray(ref[jax.tree_util.keystr(p)])
        assert v.dtype == (np.int8 if w.dtype == np.int8 else np.float32), jax.tree_util.keystr(p)
        np.testing.assert_array_equal(v, w.astype(v.dtype), err_msg=jax.tree_util.keystr(p))


def test_tied_head_is_not_quantized():
    model = LlavaOnevision(PSCFG)
    with pytest.raises(ValueError, match="tied"):
        int8.quantize_model_int8(model, include_embed_head=True)
    with pytest.raises(ValueError, match="tied"):
        LlavaOnevision(PSCFG, embed_quant="int8")


def test_qembedding_matches_qembed():
    rng = np.random.default_rng(2)
    emb = (rng.standard_normal((120, 48)) * 0.02).astype(np.float32)
    ids = rng.integers(0, 120, size=(3, 17))
    eq, es = jint8.quantize_embedding_int8(jnp.asarray(emb))
    want = QEmbed(120, 48, dtype=jnp.float32).apply(
        {"params": {"embedding_q": eq, "embedding_scale": es}}, jnp.asarray(ids))
    q = QEmbedding.from_embedding(torch.nn.Embedding.from_pretrained(torch.from_numpy(emb)))
    got = q(torch.from_numpy(ids))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [96, 1024])
def test_plain_int8_matmul_matches_the_xla_form(k):
    rng = np.random.default_rng(k)
    x = (rng.standard_normal((2, 40, k)) * 3).astype(np.float32)
    x[0, 1] = 0.0  # the 1e-6 amax floor
    _, wq, ws = _weights(rng, k, 48)
    want = jint8.int8_matmul_xla(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws), jnp.float32)
    got = int8.int8_matmul(torch.from_numpy(x), _t(wq.T), _t(ws), torch.float32)
    assert got.shape == (2, 40, 48) and got.dtype == torch.float32
    _rel_close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("n,k", [(256, 1024), (300, 512)], ids=["two_k_blocks", "ragged_rows"])
def test_plain_int8_matmul_k_block_matches_the_pallas_kernel(n, k):
    rng = np.random.default_rng(n + k)
    x = (rng.standard_normal((n, k)) * 3).astype(np.float32)
    _, wq, ws = _weights(rng, k, 256)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = jint8.int8_matmul_pallas(xb, jnp.asarray(wq), jnp.asarray(ws), jnp.float32)
    kb = int8.pick_block(k)
    assert kb == jint8._pick_block(k, 512) == 512
    got = int8.int8_matmul(torch.from_numpy(x).to(torch.bfloat16), _t(wq.T), _t(ws), torch.float32,
                           k_block=kb)
    _rel_close(got.numpy(), want, 1e-5)
    if k > kb:  # two K blocks: no longer the XLA form's numbers
        xla = int8.int8_matmul(torch.from_numpy(x).to(torch.bfloat16), _t(wq.T), _t(ws), torch.float32)
        assert not torch.allclose(got, xla, rtol=0, atol=1e-5 * got.abs().max().item())


def test_qlinear_with_bias_matches_qdense():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 9, 64)) * 2).astype(np.float32)
    _, wq, ws = _weights(rng, 64, 40)
    b = rng.standard_normal(40).astype(np.float32)
    want = QDense(40, use_bias=True, dtype=jnp.float32).apply(
        {"params": {"kernel_q": jnp.asarray(wq), "kernel_scale": jnp.asarray(ws), "bias": jnp.asarray(b)}},
        jnp.asarray(x))
    q = QLinear(64, 40, bias=True)
    q.load_state_dict({"weight_q": _t(wq.T), "weight_scale": _t(ws), "bias": _t(b)})
    with torch.no_grad():
        got = q(torch.from_numpy(x))
    _rel_close(got.numpy(), want, 1e-5)
    with pytest.raises(ValueError, match="no backward"):
        q(torch.from_numpy(x).requires_grad_(True))


def _tmat_case(n, rng):
    """ht [n, 128] f32, an int8 head [1024, 128] vocab-major (two of the TPU
    kernel's 512-column vocab blocks) with per-row scales, vocab 1000."""
    ht = rng.standard_normal((n, 128)).astype(np.float32)
    _, wq, ws = _weights(rng, 128, 1024)
    return ht, np.ascontiguousarray(wq.T), ws, 1.0 / 0.8, 1000


@pytest.mark.parametrize("n", [256, 512])
def test_plain_k10_matches_the_pallas_kernel(n):
    ht, wq_vd, ws, inv_t, vocab = _tmat_case(n, np.random.default_rng(n))
    with pltpu.force_tpu_interpret_mode():
        want = _materialize_t_int8(jnp.asarray(ht), (jnp.asarray(wq_vd), jnp.asarray(ws).reshape(1, -1)),
                                   inv_t, jnp.float32)
    got = materialize_teacher_logits_int8(torch.from_numpy(ht), _t(wq_vd), _t(ws), inv_t, vocab)
    assert got.shape == (n, vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :vocab], rtol=1e-5, atol=1e-6)


def test_plain_k10_keeps_a_ragged_row_count():
    """300 rows: the TPU grid (n // 256 row blocks) would drop the last 44;
    the XLA product keeps them, and so does the port."""
    ht, wq_vd, ws, inv_t, vocab = _tmat_case(300, np.random.default_rng(3))
    want = _materialize_t(jnp.asarray(ht), (jnp.asarray(wq_vd), jnp.asarray(ws).reshape(1, -1)), inv_t)
    got = materialize_teacher_logits_int8(torch.from_numpy(ht), _t(wq_vd), _t(ws), inv_t, vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :vocab], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="vocab"):
        materialize_teacher_logits_int8(torch.from_numpy(ht), _t(wq_vd), _t(ws), inv_t, 1025)


def _k10_register_a(wq_vd):
    """The int8 head [V, D] as K10's wgmma products see it, zero-padded to
    whole 64-column k steps: the kernel's thread (gi, ti) reads the 16 bytes
    at 16 ti of its row in each k step and gives bytes 4c, 4c+1 to k16
    product c as its A columns 2ti, 2ti+1 and bytes 4c+2, 4c+3 as columns
    2ti+8, 2ti+9 (wgmma's register-A layout, csrc/kdss_sm90.cuh)."""
    v, d = wq_vd.shape
    dp = -(-d // 64) * 64
    stored = np.zeros((v, dp), np.float64)
    stored[:, :d] = wq_vd
    seen = np.zeros_like(stored)
    for b in range(dp // 64):
        for c in range(4):
            for ti in range(4):
                for m, col in enumerate((2 * ti, 2 * ti + 1, 2 * ti + 8, 2 * ti + 9)):
                    seen[:, 64 * b + 16 * c + col] = stored[:, 64 * b + 16 * ti + 4 * c + m]
    return seen


def test_k10_perm_is_a_permutation_of_a_k_step():
    assert sorted(K10_PERM) == list(range(64))


@pytest.mark.parametrize("d", [128, 96], ids=["whole_steps", "padded"])
def test_k10_layout_meets_the_kernels_fragments(d):
    """K10's dot, the permuted hidden states against the head as the
    kernel's register fragments hold it, then the scale and 1/T, is the JAX
    ``_materialize_t`` with the int8 head: at a D of whole 64-column steps
    and at one that the layout zero-pads."""
    rng = np.random.default_rng(d)
    ht = rng.standard_normal((37, d)).astype(np.float32)
    _, wq, ws = _weights(rng, d, 200)
    wq_vd, ws = np.ascontiguousarray(np.asarray(wq).T), np.asarray(ws, np.float32).reshape(-1)
    hp = k10_hidden_layout(torch.from_numpy(ht))
    assert hp.shape == (37, -(-d // 64) * 64) and hp.is_contiguous()
    dot = (hp.double() @ torch.from_numpy(_k10_register_a(wq_vd)).T).float()
    got = dot * torch.from_numpy(ws) * 1.25
    want = _materialize_t(jnp.asarray(ht), (jnp.asarray(wq_vd), jnp.asarray(ws).reshape(1, -1)), 1.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the identity order would not do: K10_PERM is what makes the dot right
    wrong = (torch.nn.functional.pad(torch.from_numpy(ht), (0, hp.shape[1] - d)).double()
             @ torch.from_numpy(_k10_register_a(wq_vd)).T).float() * torch.from_numpy(ws) * 1.25
    assert not np.allclose(wrong.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)


def test_k10_layout_copies_a_strided_or_offset_view():
    base = torch.arange(7 * 300, dtype=torch.float32).reshape(7, 300).to(torch.bfloat16)
    view = base[1:, 3:131]  # an offset, non-contiguous view
    got = k10_hidden_layout(view)
    assert got.is_contiguous() and got.data_ptr() != base.data_ptr()
    assert torch.equal(got, k10_hidden_layout(view.contiguous()))
    assert torch.equal(got.float().sort(dim=1).values, view.float().sort(dim=1).values)  # a permutation


MODEL_CASES = [
    ("student", (True, False), True),   # int8_full serving: logits through the tied float head
    ("teacher", (False, False), True),  # --teacher_quant int8
    ("teacher", (True, True), False),   # the bench teacher: int8_full + embedding + head
]
MODEL_IDS = ["student_int8_full", "teacher_int8", "teacher_int8_full_embed_head"]


@pytest.mark.parametrize("who,quant,logits", MODEL_CASES, ids=MODEL_IDS)
def test_tiny_int8_model_matches_flax(setup, who, quant, logits):
    sparams, tparams, batch = setup
    cfg, pc, params = (SCFG, PSCFG, sparams) if who == "student" else (TCFG, PTCFG, tparams)
    jq = _quantized_tree(params, *quant)
    micro = {k: v[0] for k, v in batch.items()}
    stream = {k: micro[f"{who}_{k}"] for k in ("input_ids", "attention_mask", "pixel_values")}
    stream.update({k: micro[k] for k in KEYS})
    want_logits, want_vis, _, want_h = FlaxLlava(cfg, **_modes(*quant)).apply(
        {"params": jq}, **{k: jnp.asarray(v) for k, v in stream.items()}, return_hidden=True,
        compute_logits=logits)
    model = LlavaOnevision(pc, attn_impl="xla", **_modes(*quant))
    model.load_state_dict(params_from_flax(jq, pc))
    with torch.no_grad():
        got_logits, got_vis, _, got_h = model.eval()(**{k: _t(v) for k, v in stream.items()},
                                                     return_hidden=True, compute_logits=logits)
    pairs = [(got_h, want_h), (got_vis, want_vis)] + ([(got_logits, want_logits)] if logits else [])
    for got, want in pairs:
        assert _rel_fro(got.numpy(), want) <= 1e-3


KD_MODES = [("double_trouble", 3), ("double_trouble", 1)]
TEACHERS = [False, True]  # int8_full; int8_full + the int8 embedding and head


def _kd_cases():
    return [(m, p, e) for m, p in KD_MODES for e in TEACHERS]


KD_IDS = [f"phase{p}-{'int8_full_embed_head' if e else 'int8_full'}" for _, p, e in _kd_cases()]


@pytest.fixture(scope="module")
def jax_int8_kd(setup):
    sparams, tparams, batch = setup
    micro = {k: jnp.asarray(v[0]) for k, v in batch.items()}
    out = {}
    for mode, phase, embed in _kd_cases():
        teacher = FlaxLlava(TCFG, **_modes(True, embed))
        cfg = TrainConfig(kd_mode=mode, phase=phase, loss=kd_loss_config_for(mode), ce_impl="chunked",
                          loss_chunk_size=32)
        loss_fn = jax_make_loss_fn(JaxKDModels(FlaxLlava(SCFG), teacher), cfg)
        (_, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            sparams, _quantized_tree(tparams, True, embed), micro)
        out[mode, phase, embed] = ({k: float(v) for k, v in metrics.items()}, grads)
    return out


def _port_kd(setup, mode, phase, embed):
    sparams, tparams, batch = setup
    student = LlavaOnevision(PSCFG, attn_impl="xla")
    student.load_state_dict(params_from_flax(sparams, PSCFG))
    teacher = LlavaOnevision(PTCFG, attn_impl="xla")
    teacher.load_state_dict(params_from_flax(tparams, PTCFG))
    int8.quantize_model_int8(teacher.requires_grad_(False).eval(), include_vision=True,
                             include_embed_head=embed)
    assert isinstance(teacher_head(teacher), tuple) == embed
    cfg = pcfg.TrainConfig(kd_mode=mode, phase=phase, loss=pcfg.kd_loss_config_for(mode))
    micro = {k: torch.from_numpy(np.ascontiguousarray(v[0])) for k, v in batch.items()}
    loss, metrics = make_loss_fn(KDModels(student.train(), teacher), cfg)(micro)
    return student, loss, metrics


@pytest.mark.parametrize("mode,phase,embed", _kd_cases(), ids=KD_IDS)
def test_int8_teacher_kd_loss_matches_jax(setup, jax_int8_kd, mode, phase, embed):
    _, loss, metrics = _port_kd(setup, mode, phase, embed)
    want = jax_int8_kd[mode, phase, embed][0]
    assert set(metrics) == set(want)
    for k in want:
        np.testing.assert_allclose(metrics[k].item(), want[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("mode,phase,embed", _kd_cases(), ids=KD_IDS)
def test_int8_teacher_kd_gradients_match_jax(setup, jax_int8_kd, mode, phase, embed):
    student, loss, _ = _port_kd(setup, mode, phase, embed)
    names, leaves = zip(*student.named_parameters())
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(torch.autograd.grad(loss, leaves, allow_unused=True), leaves)]
    got = dict((jax.tree_util.keystr(k), v) for k, v in
               jax.tree_util.tree_flatten_with_path(flax_from_state_dict(dict(zip(names, grads))))[0])
    want = jax.tree_util.tree_flatten_with_path(jax_int8_kd[mode, phase, embed][1])[0]
    assert len(got) == len(want)
    for path, w in want:
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(got[key], np.asarray(w), atol=1e-5, rtol=1e-3, err_msg=key)


def test_dense_teacher_head_matches_jax(setup):
    jq = _quantized_tree(setup[1], False, True)
    head = jq["language_model"]["lm_head"]
    want = jax_dense_teacher_head((head["kernel_q"], head["kernel_scale"]), jnp.float32)  # [Dt, Vt]
    teacher = LlavaOnevision(PTCFG, embed_quant="int8", lm_quant="int8")
    teacher.load_state_dict(params_from_flax(jq, PTCFG))
    got = dense_teacher_head(teacher_head(teacher), torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).T)


def test_every_int8_projection_matches_qdense_on_the_same_inputs(setup):
    """The tiny teacher (int8_full + embedding and head): each QLinear's
    output on the input the port's forward gave it equals QDense's on the
    same input, bit for bit."""
    sparams, tparams, batch = setup
    jq = _quantized_tree(tparams, True, True)
    model = LlavaOnevision(PTCFG, attn_impl="xla", **_modes(True, True))
    model.load_state_dict(params_from_flax(jq, PTCFG))
    seen = []
    for mod in model.modules():
        if isinstance(mod, QLinear):
            mod.register_forward_hook(lambda m, inp, out: seen.append((m, inp[0], out)))
    micro = {k: v[0] for k, v in batch.items()}
    with torch.no_grad():
        model.eval()(input_ids=_t(micro["teacher_input_ids"]),
                     attention_mask=_t(micro["teacher_attention_mask"]),
                     pixel_values=_t(micro["teacher_pixel_values"]), **{k: _t(micro[k]) for k in KEYS},
                     compute_logits=False)
    assert len(seen) == 7 * TCFG.text.num_hidden_layers + 6 * TCFG.vision.num_hidden_layers
    for mod, x, y in seen:
        params = {"kernel_q": jnp.asarray(mod.weight_q.numpy().T), "kernel_scale": jnp.asarray(mod.weight_scale.numpy())}
        if mod.bias is not None:
            params["bias"] = jnp.asarray(mod.bias.numpy())
        want = QDense(mod.out_features, use_bias=mod.bias is not None, dtype=jnp.float32).apply(
            {"params": params}, jnp.asarray(x.numpy()))
        np.testing.assert_array_equal(y.numpy(), np.asarray(want))
