"""The port's Panesar VGG16+LSTM baseline (``models/panesar.py``,
``cli/panesar_baseline.py``) against the JAX package's, on the CPU:

* logits equal to the Flax ``PanesarVQAModel`` on the same weights for each
  of the five fusion modes (the reference's widths: embed 300, LSTM 512,
  VGG16, 4096-wide FCs; ``img_size`` 32, B=2, 16 question tokens; atol
  1e-4): a Flax tree drawn with numpy from a seed over the shapes of
  ``jax.eval_shape(model.init)``, carried across by
  ``models/convert.py::panesar_params_from_flax``;
* one Adadelta step with dropout off (the CLI's ``train_step``, its masked
  CE over a batch with a pad row) equal to ``optax.adadelta`` leaf by leaf
  (rtol 1e-5, atol 1e-7) and the loss before it (rtol 1e-6);
* ``build_vocabs`` (the JSON files byte for byte), ``load_vocabs`` and
  ``encode_batch`` equal to the JAX functions on the synthetic tree;
* dropout: fresh masks every call from the generator, the same masks from
  the same seed (the JAX step reuses ``PRNGKey(0)``'s masks every step);
* train -> eval through the CLI on the tiny synthetic tree (img 32), the
  Optuna search through the stub of JAX ``tests/test_panesar_optuna.py``,
  and the refusal of a multi-rank launch;
* (``slow``, as JAX ``tests/test_panesar.py``) the torchvision-layout
  overlay at 224: a torchvision-layout VGG16 encoder's state dict through
  ``convert_vgg16_state_dict`` gives that encoder's features, and the JAX
  converter's Flax encoder's."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.cli import (
    panesar_baseline as jax_cli,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.data.dataset import (
    SUNRGBDVQADataset as JaxDataset,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.models import panesar as jax_panesar
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
    common,
    panesar_baseline as cli,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.data.dataset import (
    SUNRGBDVQADataset,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models import panesar
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models.convert import (
    panesar_params_from_flax,
)
from tests.test_panesar_optuna import _optuna_stub

VOCAB, CLASSES, SEQ, IMG = 50, 20, 16, 32


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """Beside the suite's other workers: four threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _inputs(seed=1, b=2, img=IMG):
    r = np.random.default_rng(seed)
    rgb, depth = (r.normal(size=(b, img, img, 3)).astype(np.float32) for _ in range(2))
    return rgb, depth, r.integers(1, VOCAB, size=(b, SEQ)).astype(np.int32)


def _flax_params(fusion, seed=0):
    """The Flax model and a tree of seeded numpy draws over its shapes:
    kernels N(0, 1 / fan_in), biases and embeddings N(0, 0.1^2)."""
    model = jax_panesar.PanesarVQAModel(vocab_size=VOCAB, num_classes=CLASSES, fusion_method=fusion)
    rgb, depth, q = _inputs()
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), rgb, depth, q)["params"]
    r = np.random.default_rng(seed)

    def draw(s):
        scale = 1 / np.sqrt(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 0.1
        return (r.normal(size=s.shape) * scale).astype(np.float32)

    return model, jax.tree.map(draw, shapes)


def _port_model(fusion, sd):
    model = panesar.PanesarVQAModel(VOCAB, CLASSES, fusion_method=fusion, img_size=IMG)
    model.load_state_dict(sd, strict=True)
    return model


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("fusion", panesar.FUSIONS)
def test_logits_equal_flax(fusion):
    jmodel, params = _flax_params(fusion)
    rgb, depth, q = _inputs()
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, rgb, depth, q))
    model = _port_model(fusion, panesar_params_from_flax(params)).eval()
    with torch.no_grad():
        got = model(_nchw(rgb), _nchw(depth), torch.from_numpy(q).long()).numpy()
    assert got.shape == (2, CLASSES)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_adadelta_step_equals_optax():
    fusion = "conv1d"
    jmodel, params = _flax_params(fusion, seed=3)
    rgb, depth, q = _inputs(seed=4, b=3)
    ys = np.array([1, 7, 7], np.int32)
    valid = np.array([True, True, False])  # a pad row of a tail batch
    tx = optax.adadelta(1.0)

    @jax.jit
    def step(p):
        def loss_fn(p):
            logits = jmodel.apply({"params": p}, rgb, depth, q)
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, ys)
            return (ce * valid).sum() / jnp.maximum(valid.sum(), 1)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, optax.apply_updates(p, updates)

    want_loss, want = step(params)
    before = panesar_params_from_flax(params)
    model = _port_model(fusion, before)
    opt = cli.make_optimizer(model, 1.0)
    loss = cli.train_step(model, opt, cli.to_tensors((rgb, depth, q, ys, valid), "cpu"), deterministic=True)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    got = model.state_dict()
    want = panesar_params_from_flax(jax.tree.map(np.asarray, want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-5, atol=1e-7, err_msg=k)
    assert not torch.equal(got["mlp.weight"], before["mlp.weight"])
    assert not torch.equal(got["img_enc_rgb.fc1.weight"], before["img_enc_rgb.fc1.weight"])
    # the input-side LSTM biases stay zero: the Flax cell has none
    assert all(not got[k].any() for k in got if k.endswith("bias_ih_l0"))


def test_dropout_draws_fresh_masks_from_the_generator():
    x = torch.ones(4, 4096)
    g = torch.Generator().manual_seed(7)
    a, b = panesar.dropout(x, 0.5, g), panesar.dropout(x, 0.5, g)
    assert not torch.equal(a, b)
    assert set(a.unique().tolist()) <= {0.0, 2.0} and 0.45 < (a > 0).float().mean().item() < 0.55
    assert torch.equal(a, panesar.dropout(x, 0.5, torch.Generator().manual_seed(7)))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return common.ensure_synthetic_dataset(str(tmp_path_factory.mktemp("sunrgbd")))


def test_vocabs_and_encode_batch_equal_jax(tree, tmp_path):
    got_q, got_a = cli.build_vocabs(SUNRGBDVQADataset(tree, "train_dataset.csv"), str(tmp_path / "port"))
    want_q, want_a = jax_cli.build_vocabs(JaxDataset(tree, "train_dataset.csv"), str(tmp_path / "jax"))
    assert (got_q, got_a) == (want_q, want_a) and len(got_a) == 6
    for name in ("question_vocab.json", "answer_vocab.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert cli.load_vocabs(str(tmp_path / "port")) == jax_cli.load_vocabs(str(tmp_path / "jax"))
    assert cli._tokenize_q("What's the 2nd CHAIR?") == jax_cli._tokenize_q("What's the 2nd CHAIR?")
    answers = dict(got_a)
    answers.pop("red")  # an answer outside the vocabulary: its row is not valid
    ds, jds = SUNRGBDVQADataset(tree, "val_dataset.csv"), JaxDataset(tree, "val_dataset.csv")
    got = cli.encode_batch(ds, [0, 5, 3], got_q, answers, img_size=IMG)
    want = jax_cli.encode_batch(jds, [0, 5, 3], want_q, answers, img_size=IMG)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert list(got[4]) == [True, False, True]


def _argv(mode, tree, tmp_path, *flags):
    return [mode, "--synthetic_data", "--cpu", "--root_data_dir", tree, "--img_size", str(IMG), "--max_items", "6",
            "--batch_size", "4", "--vocab_dir", str(tmp_path / "vocab"), "--ckpt", str(tmp_path / "ck" / "panesar.pt"),
            *flags]


def test_cli_trains_then_evaluates(tree, tmp_path, capsys):
    rec = cli.main(_argv("train", tree, tmp_path, "--epochs", "2", "--early_stop_patience", "5"))
    out = capsys.readouterr().out
    assert "epoch 0 train_loss" in out and "epoch 1 train_loss" in out and "panesar training complete" in out
    # 6 rows at batch 4: a full batch and a padded one, each epoch
    assert rec["steps"] == 4 and len(rec["val_losses"]) == 2 and np.isfinite(rec["train_losses"]).all()
    assert rec["best_val"] == min(rec["val_losses"])
    assert (tmp_path / "ck" / "panesar.pt").is_file()
    assert json.loads((tmp_path / "vocab" / "answer_vocab.json").read_text())
    res = cli.main(_argv("eval", tree, tmp_path))
    assert f"panesar eval accuracy: {res['accuracy']:.4f} ({res['correct']}/{res['total']})" in capsys.readouterr().out
    assert res["total"] == 6
    with pytest.raises(SystemExit, match="no such checkpoint"):
        cli.main(_argv("eval", tree, tmp_path)[:-1] + [str(tmp_path / "missing.pt")])
    with pytest.raises(SystemExit, match="one process"):
        cli.main(_argv("train", tree, tmp_path, "--distributed"))


def test_optuna_lr_search_with_the_stub(tree, tmp_path, capsys, monkeypatch):
    mod, exceptions = _optuna_stub()
    monkeypatch.setitem(sys.modules, "optuna", mod)
    monkeypatch.setitem(sys.modules, "optuna.exceptions", exceptions)
    cli.main(_argv("train", tree, tmp_path, "--epochs", "1", "--optuna_trials", "2", "--max_items", "3",
                   "--batch_size", "3"))
    out = capsys.readouterr().out
    assert "Starting Bayesian Optimization with 2 trials" in out
    assert "optuna best lr:" in out
    assert "panesar training complete" in out
    assert (tmp_path / "ck" / "panesar.pt").exists()


@pytest.mark.slow
def test_torchvision_layout_overlay_at_224():
    from tests.test_panesar import _torch_vgg16_encoder

    torch.manual_seed(0)
    enc = _torch_vgg16_encoder().eval()
    x = np.random.default_rng(0).normal(size=(1, 224, 224, 3)).astype(np.float32)
    with torch.no_grad():
        want = enc(_nchw(x)).numpy()
    sd = {k: v.clone() for k, v in enc.state_dict().items()}
    port = panesar.ImageEncoder(224)
    assert port.fc1.in_features == 25088
    port.load_state_dict(panesar.convert_vgg16_state_dict(sd, port.state_dict()), strict=True)
    with torch.no_grad():
        got = port.eval()(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    jmodel = jax_panesar.ImageEncoder()
    params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x)["params"]
    params = jax_panesar.convert_vgg16_state_dict(sd, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), params))
    np.testing.assert_allclose(got, np.asarray(jmodel.apply({"params": params}, x)), atol=2e-3, rtol=1e-3)
    # the overlay carries every ImageEncoder weight: nothing of the seeded init is left
    assert sorted(panesar.convert_vgg16_state_dict(sd, {})) == sorted(port.state_dict())


def test_image_encoder_fc1_width_follows_img_size():
    assert panesar.ImageEncoder(32).fc1.in_features == 512
    assert panesar.ImageEncoder(64).fc1.in_features == 2048
    with pytest.raises(ValueError, match="Unknown fusion"):
        panesar.PanesarVQAModel(VOCAB, fusion_method="concat")
    assert os.path.basename(cli.build_parser().parse_args(["eval"]).ckpt) == "panesar"
