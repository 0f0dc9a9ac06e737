"""The evaluator's sharded generation on gloo ranks spawned on the CPU (the
JAX ``tests/test_sharding.py::test_sharded_generation_matches_single_device``
and ``::test_sharded_int8_generation_matches_single_device``): the tiny
model (the JAX test's init, carried across by ``params_from_flax``),
``synthetic_kd_batch(cfg, 2, 96)`` at the JAX tests' seeds (11 bf16, 12
int8_full), 6 greedy tokens, no repetition penalty, no n-gram ban, eos -1.

At meshes (1,1,2), (1,2,2), (1,1,4) and (2,1,1) the model is sharded by
``parallel.shard_params`` and every rank generates the whole batch under
the mesh: its tokens equal one process's and the JAX single-device tokens,
bit for bit.  At tensor = 2 the tiny config's 2 kv heads split to 1 a
rank; the caches hold a rank's kv heads.  A cache sized from the config
(the sizing before local widths) holds 2 there, into which the write
broadcasts the one local head: the tokens agree, at twice the cache, only
because each local q head then reads a copy of its own group's head.  On a
4 q / 4 kv variant of the tiny config at tensor = 2 (2 local kv heads) the
config-sized write fails, and the local sizing gives one process's tokens.
Tensor = 4 keeps the tiny attention whole (2 % 4 != 0) and splits the MLP.  int8_full stays replicated (``QLinear`` models are not sharded)
and gives the same tokens.  Then the evaluator CLI with ``--distributed
--cpu --mesh 1,1,2`` on two ranks: its CSV (written by rank 0) equals the
one-process CLI's, both ranks return the same rows, and every LM
parameter is a DTensor at each batch's generate call.  Each world size is
spawned once (module-scoped)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.configs import (
    llava_onevision_tiny,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.eval import decode as jax_decode
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.models import (
    LlavaOnevision as FlaxLlava,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.ops.int8 import (
    quantize_lm_params_int8,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.utils.synthetic import (
    synthetic_kd_batch,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch import configs as pcfg
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli import (
    common,
    evaluate_onevision,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.eval.decode import (
    GenerateConfig,
    Generator,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models.convert import (
    params_from_flax,
)
from torch_dist_workers import generate_worker, spawn, tiny_served_model

CFG = llava_onevision_tiny()
N_NEW = 6
SEEDS = {"none": (11, 0), "int8_full": (12, 1)}  # (batch seed, init key) of the JAX tests
MESHES = [(1, 1, 2), (1, 2, 2), (1, 1, 4), (2, 1, 1)]
CASES = [(mesh, quant) for quant in SEEDS for mesh in MESHES]
IDS = ["{}-{}".format("x".join(map(str, m)), "bf16" if q == "none" else q) for m, q in CASES]
# the sizing fault: tensor = 2 on the tiny config and on a 4 q / 4 kv variant
CACHE_CASES = [((1, 1, 2), "none"), ((1, 2, 2), "none"), ((1, 1, 4), "none"), ((2, 1, 1), "none"),
               ((1, 1, 2), "kv4")]
CLI_MESH = "1,1,2"
KEYS = ("student_input_ids", "student_attention_mask", "student_pixel_values",
        "pack_idx", "pack_weight", "pack_valid", "tile_valid")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The ranks run one thread each; so does this file's own process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Per quant: the JAX params (quantized for int8_full) and batch, the
    port state dict of the float params, the numpy batch; and a synthetic
    tree for the CLI runs."""
    out = {}
    for quant, (seed, key) in SEEDS.items():
        batch = synthetic_kd_batch(CFG, 2, 96, seed=seed)
        jb = {k: jnp.asarray(batch[k]) for k in KEYS}
        params = FlaxLlava(CFG).init(
            jax.random.PRNGKey(key), input_ids=jb["student_input_ids"],
            attention_mask=jb["student_attention_mask"], pixel_values=jb["student_pixel_values"],
            **{k: jb[k] for k in KEYS[3:]})["params"]
        sd = params_from_flax(params, pcfg.llava_onevision_tiny())
        if quant != "none":
            params = quantize_lm_params_int8(params, include_vision=True)
        out[quant] = (params, jb, sd, {k: np.asarray(batch[k]) for k in KEYS})
    root = common.ensure_synthetic_dataset(str(tmp_path_factory.mktemp("sunrgbd")))
    return out, root


def _gcfg(cls):
    return cls(max_new_tokens=N_NEW, repetition_penalty=1.0, no_repeat_ngram_size=0, eos_token_id=-1)


@pytest.fixture(scope="module")
def jax_tokens(setup):
    out = {}
    for quant, (params, jb, _, _) in setup[0].items():
        model = FlaxLlava(CFG) if quant == "none" else FlaxLlava(CFG, lm_quant="int8", vision_quant="int8")
        gen = jax_decode.Generator(model, CFG, _gcfg(jax_decode.GenerateConfig))
        out[quant] = np.asarray(gen.generate(params, jb)["tokens"])
    return out


@pytest.fixture(scope="module")
def one_process(setup):
    out = {}
    for quant, (_, _, sd, batch) in setup[0].items():
        model = tiny_served_model(sd, quant)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        out[quant] = Generator(model.cfg, _gcfg(GenerateConfig)).generate(model, tb)["tokens"]
        if quant == "none":
            kv4 = tiny_served_model(None, "kv4")
            out["kv4"] = Generator(kv4.cfg, _gcfg(GenerateConfig)).generate(kv4, tb)["tokens"]
    return out


def _cli_argv(root, preds, *flags):
    return ["--tiny_model", "--cpu", "--root_data_dir", root, "--predictions_dir", str(preds), "--max_new_tokens",
            "4", "--eval_batch_size", "5", "--metric_backend", "hashed", *flags]


@pytest.fixture(scope="module")
def sharded(setup, tmp_path_factory):
    data, root = setup
    sds = {q: d[2] for q, d in data.items()}
    batches = {q: d[3] for q, d in data.items()}
    batches["kv4"] = batches["none"]
    preds = tmp_path_factory.mktemp("preds_mesh")
    out = {}
    for world in (2, 4):
        # --synthetic_data with the shared --root_data_dir: rank 0 rewrites the tree, the other waits
        argv = _cli_argv(root, preds, "--distributed", "--mesh", CLI_MESH, "--synthetic_data") if world == 2 else None
        ranks = spawn(generate_worker, world, CASES + CACHE_CASES[-1:], sds, batches, N_NEW, argv)
        for case in CASES + CACHE_CASES[-1:]:
            if case in ranks[0]:
                for r in ranks[1:]:
                    torch.testing.assert_close(r[case][0], ranks[0][case][0], rtol=0, atol=0)
                out[case] = ranks[0][case]
        if argv is not None:
            out["cli"] = [r["cli"] for r in ranks]
            out["cli_sharded"] = [r["cli_sharded"] for r in ranks]
    assert set(CASES + CACHE_CASES) <= set(out)
    return out, preds


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_tokens_equal_one_process_and_jax(sharded, one_process, jax_tokens, case):
    mesh, quant = case
    tokens, all_dtensor, _ = sharded[0][case]
    np.testing.assert_array_equal(tokens.numpy(), one_process[quant].numpy())
    np.testing.assert_array_equal(tokens.numpy(), jax_tokens[quant])
    # bf16 models shard (every LM parameter a DTensor); int8 models stay replicated
    assert all_dtensor == (quant == "none")


@pytest.mark.parametrize("case", CACHE_CASES, ids=["{}-{}".format("x".join(map(str, m)), "bf16" if q == "none" else q)
                                                   for m, q in CACHE_CASES])
def test_config_sized_cache_fails_where_tensor_splits_the_kv_heads(sharded, one_process, case):
    mesh, which = case
    tokens, _, old = sharded[0][case]
    torch.testing.assert_close(tokens, one_process[which], rtol=0, atol=0)
    if which == "kv4":
        # a rank's 2 of 4 kv heads do not fit a cache of 4: the write fails
        assert isinstance(old, str) and "must match" in old, old
    else:
        # at tensor = 2 the tiny config's 1 local kv head goes into a cache of 2: the write broadcasts it into both
        # cache heads, each local q head reads a copy of its own group's head, and the tokens agree at twice the
        # memory; at tensor 1 and 4 the attention is whole
        assert torch.equal(old, one_process[which]), old


def test_distributed_cli_csv_equals_one_process(sharded, setup, tmp_path):
    out, preds = sharded
    ref = evaluate_onevision.main(_cli_argv(setup[1], tmp_path / "p1"))
    rank0, rank1 = out["cli"]
    name = evaluate_onevision.predictions_file(evaluate_onevision.build_parser().parse_args([]))
    with open(os.path.join(preds, name), "rb") as f, open(ref["path"], "rb") as g:
        assert f.read() == g.read()
    assert [r["tokens"] for r in rank0] == [r["tokens"] for r in rank1] == [r["tokens"] for r in ref["rows"]]
    assert sorted(os.listdir(preds)) == [name, "summary"]
    # the model stays sharded between batches (the root resharded after each generate): 12 rows at B=5
    assert out["cli_sharded"] == [[True] * 3] * 2
