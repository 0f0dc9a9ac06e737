"""The port's own host layer against the JAX package's originals, and the
port's freedom from the JAX package.

* The copied modules give what the originals give: every config preset and
  the loss/train configs field by field; the synthetic SUNRGBD and DAQUAR
  trees file by file; the DAQUAR reader's rows bit for bit; the collator's
  batch array by array; ``synthetic_kd_batch``;
  ``digits_to_words``; the HF key mapping on a tiny HF state dict.
* The copied evaluation modules (``eval/metrics.py``, ``eval/results.py``)
  are the originals but for their docstrings (``ast``), and score the same.
* No ``.py`` of the port, nor ``chip_smoke.py`` or the port's scripts
  (``scripts/*torch*.py``), imports the JAX package, ``kdss``, jax, flax,
  optax or orbax (an ``ast`` guard), and a fresh process that imports every
  port module and those scripts has none of them loaded."""

import ast
import dataclasses
import glob
import os
import pkgutil
import subprocess
import sys
import types

import numpy as np
import pytest

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu import configs as jcfg
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.cli import (
    common as jcommon,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.data.collate import (
    OneVisionCollator as JaxCollator,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.data.dataset import (
    DAQUARVQADataset as JaxDAQUAR,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.models.convert import (
    convert_hf_state_dict as jax_convert_hf,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.utils.numwords import (
    digits_to_words as jax_digits_to_words,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.utils.synthetic import (
    synthetic_kd_batch as jax_synthetic_kd_batch,
)
import knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch as port
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch import configs as pcfg
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
    common as pcommon,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.data.collate import (
    OneVisionCollator,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.data.dataset import (
    DAQUARVQADataset,
    SUNRGBDVQADataset,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models.convert import (
    convert_hf_state_dict,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.utils.numwords import (
    digits_to_words,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.utils.synthetic import (
    synthetic_kd_batch,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = port.__name__
PORT_DIR = os.path.dirname(port.__file__)
FORBIDDEN = ("knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu",
             "kdss", "jax", "jaxlib", "flax", "optax", "orbax")
PRESETS = ("llava_onevision_0_5b", "llava_onevision_7b", "llava_onevision_tiny",
           "llava_onevision_tiny_teacher")


@pytest.mark.parametrize("preset", PRESETS)
def test_config_presets_equal_the_originals(preset):
    got, want = getattr(pcfg, preset)(), getattr(jcfg, preset)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.max_image_tokens == want.max_image_tokens
    assert got.vision.head_dim == want.vision.head_dim


@pytest.mark.parametrize("kd_mode", ["baseline", "logit_based", "feature_based", "double_trouble"])
def test_train_and_loss_configs_equal_the_originals(kd_mode):
    assert dataclasses.asdict(pcfg.kd_loss_config_for(kd_mode)) == \
        dataclasses.asdict(jcfg.kd_loss_config_for(kd_mode))
    assert dataclasses.asdict(pcfg.TrainConfig(kd_mode=kd_mode)) == \
        dataclasses.asdict(jcfg.TrainConfig(kd_mode=kd_mode))


def test_synthetic_tree_equals_the_original(tmp_path):
    pcommon.ensure_synthetic_dataset(str(tmp_path / "port"))
    jcommon.ensure_synthetic_dataset(str(tmp_path / "jax"))
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 3 + 2 * 12
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


def test_synthetic_daquar_tree_equals_the_original(tmp_path):
    pcommon.ensure_synthetic_daquar(str(tmp_path / "port"))
    jcommon.ensure_synthetic_daquar(str(tmp_path / "jax"))
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 3 + 2 * 8
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


@pytest.mark.parametrize("subset", [None, 0.5, 0.1])
def test_daquar_reader_equals_the_original(tmp_path, subset):
    """Every row: question, answer, RGB array, Prewitt depth array and index
    bit for bit; ``subset_percentage`` head-slices without a floor (0.1 of 8
    rows is none)."""
    root = jcommon.ensure_synthetic_daquar(str(tmp_path))
    got, want = DAQUARVQADataset(root, "val_dataset.csv", subset), JaxDAQUAR(root, "val_dataset.csv", subset)
    assert len(got) == len(want) == (8 if subset is None else int(8 * subset))
    for i in range(len(want)):
        assert got.image_paths(i) == want.image_paths(i)
        for a, b in zip(got[i], want[i]):
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


@pytest.mark.parametrize("mask_prompt_labels", [False, True])
def test_collated_batch_equals_the_original(tmp_path, mask_prompt_labels):
    root = pcommon.ensure_synthetic_dataset(str(tmp_path))
    args = types.SimpleNamespace(tokenizer_path=None, synthetic_data=True, tiny_model=False,
                                 real_model=False)
    ds = SUNRGBDVQADataset(root, "train_dataset.csv", None)
    samples = [ds[i] for i in range(4)]
    kw = dict(buckets=(256,), mask_prompt_labels=mask_prompt_labels)
    scfg, jscfg = pcommon.model_configs(args)[0], jcommon.model_configs(args)[0]
    got = OneVisionCollator(scfg, pcommon.make_tokenizer(args, scfg), **kw)(samples)
    want = JaxCollator(jscfg, jcommon.make_tokenizer(args, jscfg), **kw)(samples)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("preset,seq_len,accum", [
    ("llava_onevision_tiny", 96, None), ("llava_onevision_tiny", 128, 2),
    ("llava_onevision_0_5b", 3072, None),
])
def test_synthetic_kd_batch_equals_the_original(preset, seq_len, accum):
    kw = dict(seq_len=seq_len, seed=3, **({} if accum is None else {"accum": accum}))
    if preset == "llava_onevision_0_5b":
        kw["orig_sizes"] = [(530, 730)]
    got = synthetic_kd_batch(getattr(pcfg, preset)(), 1, **kw)
    want = jax_synthetic_kd_batch(getattr(jcfg, preset)(), 1, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_digits_to_words_equals_the_original():
    texts = ["0", "7", "13", "40", "101", "999", "there are 3 chairs and 12 lamps",
             "room 205", "no digits here", "1000", "2.5"]
    for t in texts:
        assert digits_to_words(t) == jax_digits_to_words(t), t


def _tiny_hf_state_dict():
    """An HF LLaVA-OneVision state dict of the tiny teacher's shapes (untied
    head), keys in the new-style scheme, with a legacy-scheme key mixed in."""
    cfg = pcfg.llava_onevision_tiny_teacher()
    rng = np.random.default_rng(0)
    v, t = cfg.vision, cfg.text
    sd = {}

    def put(name, *shape):
        sd[name] = rng.normal(size=shape).astype(np.float32)

    vt = "model.vision_tower.vision_model"
    put(f"{vt}.embeddings.patch_embedding.weight", v.hidden_size, 3, v.patch_size, v.patch_size)
    put(f"{vt}.embeddings.patch_embedding.bias", v.hidden_size)
    put(f"{vt}.embeddings.position_embedding.weight", v.tokens_per_patch, v.hidden_size)
    for i in range(v.num_hidden_layers):
        lp = f"{vt}.encoder.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            put(f"{lp}.{ln}.weight", v.hidden_size)
            put(f"{lp}.{ln}.bias", v.hidden_size)
        for pr in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(f"{lp}.self_attn.{pr}.weight", v.hidden_size, v.hidden_size)
            put(f"{lp}.self_attn.{pr}.bias", v.hidden_size)
        put(f"{lp}.mlp.fc1.weight", v.intermediate_size, v.hidden_size)
        put(f"{lp}.mlp.fc1.bias", v.intermediate_size)
        put(f"{lp}.mlp.fc2.weight", v.hidden_size, v.intermediate_size)
        put(f"{lp}.mlp.fc2.bias", v.hidden_size)
    put(f"{vt}.post_layernorm.weight", v.hidden_size)
    put(f"{vt}.post_layernorm.bias", v.hidden_size)
    put("model.multi_modal_projector.linear_1.weight", t.hidden_size, v.hidden_size)
    put("model.multi_modal_projector.linear_1.bias", t.hidden_size)
    put("model.multi_modal_projector.linear_2.weight", t.hidden_size, t.hidden_size)
    put("model.multi_modal_projector.linear_2.bias", t.hidden_size)
    put("model.image_newline", t.hidden_size)
    put("model.language_model.embed_tokens.weight", t.vocab_size, t.hidden_size)
    q, kv = t.num_attention_heads * t.head_dim, t.num_key_value_heads * t.head_dim
    for i in range(t.num_hidden_layers):
        lp = f"model.language_model.layers.{i}"
        put(f"{lp}.input_layernorm.weight", t.hidden_size)
        put(f"{lp}.post_attention_layernorm.weight", t.hidden_size)
        for pr, out in (("q_proj", q), ("k_proj", kv), ("v_proj", kv)):
            put(f"{lp}.self_attn.{pr}.weight", out, t.hidden_size)
            put(f"{lp}.self_attn.{pr}.bias", out)
        put(f"{lp}.self_attn.o_proj.weight", t.hidden_size, q)
        put(f"{lp}.mlp.gate_proj.weight", t.intermediate_size, t.hidden_size)
        put(f"{lp}.mlp.up_proj.weight", t.intermediate_size, t.hidden_size)
        put(f"{lp}.mlp.down_proj.weight", t.hidden_size, t.intermediate_size)
        put(f"{lp}.self_attn.rotary_emb.inv_freq", t.head_dim // 2)
    put("model.language_model.norm.weight", t.hidden_size)
    put("language_model.lm_head.weight", t.vocab_size, t.hidden_size)  # legacy scheme
    return cfg, sd


def test_hf_key_mapping_equals_the_original():
    cfg, sd = _tiny_hf_state_dict()
    got = convert_hf_state_dict(dict(sd), cfg)
    want = jax_convert_hf(dict(sd), jcfg.llava_onevision_tiny_teacher())
    flat = lambda tree, p="": {f"{p}{k}": v for k0, v0 in tree.items()  # noqa: E731
                               for k, v in (flat(v0, f"{k0}.").items() if isinstance(v0, dict)
                                            else [(k0, v0)])}
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want) and "language_model.lm_head.kernel" in want
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="unconverted"):
        convert_hf_state_dict({**sd, "extra.weight": np.zeros(1)}, cfg)


PORT_SCRIPTS = sorted(glob.glob(os.path.join(REPO, "scripts", "*torch*.py")))


def _strip_docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)) and node.body and \
                isinstance(node.body[0], ast.Expr) and isinstance(node.body[0].value, ast.Constant) and \
                isinstance(node.body[0].value.value, str):
            node.body = node.body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("module", ["metrics", "results"])
def test_eval_copies_are_the_originals_but_for_docstrings(module):
    paths = [os.path.join(REPO, pkg, "eval", f"{module}.py") for pkg in (jcfg.__name__.rsplit(".", 1)[0], PKG)]
    got, want = (_strip_docstrings(ast.parse(open(p).read())) for p in paths)
    assert got == want


def test_eval_metrics_score_as_the_originals(tmp_path):
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.eval import (
        metrics as jm,
        results as jr,
    )
    from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.eval import (
        metrics as pm,
        results as pr,
    )

    import pandas as pd

    preds = ["chairs", "a table", "two", "yes", "red lamp", "", "boxes", "beds"]
    refs = ["chair", "table", "2", "no", "red", "sofa", "box", "bed"]
    df = pd.DataFrame({"Question_Id": range(8), "Questions": ["q"] * 8,
                       "Question_Type": ["Object", "Object", "Count", "Yes/No", "Color", "Object", "Object",
                                         "Object"], "Answers": refs, "Model_Answer": preds})
    for mod in (jm, pm):
        mod.force_backend("hashed")
    for fn in ("simple_accuracy_metric", "neural_similarity_metric", "compute_bert_stats"):
        assert getattr(pm, fn)(preds, refs) == getattr(jm, fn)(preds, refs), fn
    assert pm.per_category_metrics(df) == jm.per_category_metrics(df)
    assert pm.summarize_predictions(df) == jm.summarize_predictions(df)
    df.to_csv(tmp_path / "p.csv", index=False)
    assert pr.summarize_file(str(tmp_path / "p.csv")) == jr.summarize_file(str(tmp_path / "p.csv"))
    for mod in (jm, pm):
        mod.force_backend("auto")


def _port_sources():
    for d, _, files in os.walk(PORT_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield from PORT_SCRIPTS


def _forbidden(name) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call) and node.args
                  and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
                  and getattr(node.func, "attr", getattr(node.func, "id", "")) in
                  ("__import__", "import_module")):
                names = [node.args[0].value]
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def test_importing_every_port_module_loads_no_jax():
    """A fresh process (this one has jax loaded by tests/conftest.py)."""
    modules = sorted(m.name for m in pkgutil.walk_packages([PORT_DIR], PKG + "."))
    assert {f"{PKG}.ops.fused_loca", f"{PKG}.ops.fused_kl", f"{PKG}.ops.int8", f"{PKG}.cli.train_online_kd",
            f"{PKG}.losses.chunked", f"{PKG}.data.dataset", f"{PKG}.cli.train", f"{PKG}.ops.flash_phase_ablation",
            f"{PKG}.eval.metrics", f"{PKG}.eval.results", f"{PKG}.cli.evaluate_onevision",
            f"{PKG}.cli.get_all_results", f"{PKG}.cli.create_dataset", f"{PKG}.cli.dataset_statistics",
            f"{PKG}.cli.convert_weights", f"{PKG}.eval.runner", f"{PKG}.eval.statistics", f"{PKG}.utils.spelling",
            *(f"{PKG}.data.creation.{m}" for m in ("geometry", "prominent", "postprocess", "questions", "merge",
                                                   "extract", "color_backend"))} <= set(modules)
    assert os.path.join(REPO, "scripts", "torch_flash_phase_ablation.py") in PORT_SCRIPTS
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"for i, path in enumerate({PORT_SCRIPTS!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'port_script_{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"
