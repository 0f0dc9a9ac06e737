"""The row-sharded fused losses (``ops/fused_spmd.py``) on gloo ranks
spawned on the CPU, where each wrapper runs its loss's plain versions.

Each rank holds its (data, fsdp) share of the rows (uneven where the rank
count does not divide them, as the step's rows never are but the wrappers
allow) and, over ``tensor``, the same rows, which the wrapper splits once
more where the tensor size divides them.  For each of the four wrappers,
at 2 and 4 ranks, with rows that divide and rows that do not, and with the
teacher's logits from a float and from an int8 head:

* every rank's loss equals the one-process fused loss (rtol 1e-5);
* each rank's dh equals the one-process dh of its rows (atol 1e-6 /
  rtol 1e-4): the gradient of the global loss, counted once;
* the dW of the (data, fsdp) ranks, summed, equals the one-process dW;
* the one-process loss equals the JAX ``ops/fused_spmd.py`` wrapper's on
  its 8-device host mesh (``local_impl="xla"``) on the same numbers, the
  teacher entering the JAX wrapper as its hidden states and head
  (rtol 1e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.ops import fused_spmd as jfs
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu.parallel import (
    MeshConfig as JaxMeshConfig,
    make_mesh as jax_make_mesh,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.ops.fused_loca import (
    materialize_teacher_logits_int8_ref,
)
from torch_dist_workers import dp_rows, spawn, spmd_loss, spmd_worker

D, DT, V, VT, T = 16, 24, 40, 48, 0.8
LOSSES = ("ce", "kl", "loca", "loca_ce")
# (mesh, rows): 24 divides every mesh; 30 splits unevenly over 4 (data,
# fsdp) ranks and its 15 rows a rank do not divide tensor = 2; 26 does
# not divide tensor = 4.
MESH_ROWS = [((1, 2, 1), 24), ((1, 1, 2), 24), ((1, 1, 2), 15), ((2, 2, 1), 30), ((1, 2, 2), 24),
             ((1, 2, 2), 30), ((1, 1, 4), 24), ((1, 1, 4), 26)]
CASES = [(mesh, name, n, int8) for mesh, n in MESH_ROWS for name in LOSSES
         for int8 in ((False, True) if name != "ce" else (False,))]
IDS = ["{}-n{}-{}{}".format("x".join(map(str, m)), n, name, "-int8" if q else "") for m, name, n, q in CASES]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Beside the suite's other workers (and the ranks this file spawns,
    one thread each) a full intra-op thread pool oversubscribes the cores,
    so this file runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n, int8, seed):
    rng = np.random.default_rng(seed)
    hs = rng.normal(size=(n, D)).astype(np.float32)
    ht = rng.normal(size=(n, DT)).astype(np.float32)
    ws = (rng.normal(size=(V, D)) * 0.05).astype(np.float32)  # the student head, [V, D]
    labels = rng.integers(0, V, size=n).astype(np.int64)
    labels[:5] = -100
    ce_labels = rng.integers(0, V, size=n).astype(np.int64)
    ce_labels[-6:] = -100
    if int8:
        wq = rng.integers(-127, 128, size=(VT, DT)).astype(np.int8)  # vocab-major int8 head
        wsc = (rng.uniform(0.5, 1.5, size=VT) / 127 * 0.05).astype(np.float32)
        tmat = materialize_teacher_logits_int8_ref(torch.from_numpy(ht), torch.from_numpy(wq),
                                                   torch.from_numpy(wsc), 1.0 / T, V).numpy()
        wt = (jnp.asarray(wq), jnp.asarray(wsc))
    else:
        wt_np = (rng.normal(size=(DT, VT)) * 0.05).astype(np.float32)
        tmat = (ht.astype(np.float64) @ wt_np[:, :V].astype(np.float64) / T).astype(np.float32)
        wt = jnp.asarray(wt_np)
    data = dict(h=hs, w=ws, tmat=tmat, labels=labels, ce_labels=ce_labels)
    return data, (jnp.asarray(ht), wt)


_DATA = {}


def _case_data(n, int8, name):
    """One data set per (rows, head), shared by every mesh and the JAX check."""
    key = (n, int8)
    if key not in _DATA:
        _DATA[key] = _data(n, int8, seed=n + 100 * int8)
    return _DATA[key]


@pytest.fixture(scope="module")
def cases():
    return [(mesh, name, *_case_data(n, int8, name)) for mesh, name, n, int8 in CASES]


@pytest.fixture(scope="module")
def ranks(cases):
    args = [(mesh, name, data) for mesh, name, data, _ in cases]
    out = {}
    for world in (2, 4):
        for r in spawn(spmd_worker, world, args):
            for i, res in r.items():
                out.setdefault(i, []).append(res)
    assert sorted(out) == list(range(len(CASES)))
    return out


def _one_process(name, data):
    h = torch.from_numpy(data["h"]).requires_grad_(True)
    w = torch.from_numpy(data["w"]).requires_grad_(True)
    loss = spmd_loss(name, h, w, *(torch.from_numpy(data[k]) for k in ("tmat", "labels", "ce_labels")))
    loss.backward()
    return loss.item(), h.grad, w.grad


def _jax_loss(name, data, teacher):
    ht, wt = teacher
    hs, ws = jnp.asarray(data["h"]), jnp.asarray(data["w"].T)  # the JAX wrappers take [D, V]
    lab, lab_ce = jnp.asarray(data["labels"], jnp.int32), jnp.asarray(data["ce_labels"], jnp.int32)
    kw = dict(local_impl="xla")
    with jax.set_mesh(jax_make_mesh(JaxMeshConfig(1, 2, 4))):
        if name == "ce":
            return float(jfs.fused_ce_loss_spmd(hs, ws, lab_ce, **kw))
        if name == "kl":
            return float(jfs.fused_kl_loss_spmd(hs, ws, ht, wt, temperature=T, **kw))
        if name == "loca":
            return float(jfs.fused_loca_loss_spmd(hs, ws, ht, wt, lab, temperature=T, alpha=0.8, **kw))
        loca, ce = jfs.fused_loca_ce_loss_spmd(hs, ws, ht, wt, lab, lab_ce, temperature=T, alpha=0.8, **kw)
        return float(0.8 * loca + ce)


@pytest.mark.parametrize("index", range(len(CASES)), ids=IDS)
def test_spmd_wrapper_matches_one_process(cases, ranks, index):
    mesh, name, data, _ = cases[index]
    want_loss, want_dh, want_dw = _one_process(name, data)
    n = data["h"].shape[0]
    dp = mesh[0] * mesh[1]
    dw = {}
    for loss, dp_index, t_index, dh, w_grad in ranks[index]:
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        np.testing.assert_allclose(dh.numpy(), want_dh[dp_rows(n, dp, dp_index)].numpy(), atol=1e-6, rtol=1e-4)
        if t_index == 0:
            dw[dp_index] = w_grad
    assert sorted(dw) == list(range(dp))
    np.testing.assert_allclose(sum(dw.values()).numpy(), want_dw.numpy(), atol=1e-6, rtol=1e-4)


# On the JAX (1, 2, 4) mesh 26 rows shard over fsdp alone and 24 over all
# eight devices.
JAX_CASES = [(name, 26, int8) for name in LOSSES for int8 in ((False, True) if name != "ce" else (False,))]
JAX_CASES += [("ce", 24, False), ("loca_ce", 24, False)]


@pytest.mark.parametrize("name,n,int8", JAX_CASES,
                         ids=[f"n{n}-{name}{'-int8' if q else ''}" for name, n, q in JAX_CASES])
def test_spmd_wrapper_matches_jax(name, n, int8):
    data, teacher = _case_data(n, int8, name)
    np.testing.assert_allclose(_jax_loss(name, data, teacher), _one_process(name, data)[0], rtol=1e-5)
