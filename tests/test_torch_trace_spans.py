"""The port's spans (``utils/trace.py``) inside the train step, on the CPU:

* with no profiler recording, a span calls neither ``record_function`` nor
  ``torch.cuda.synchronize``; while one records, it opens ``kdss.<name>``
  and, with CUDA initialised, drains the card when it opens and closes;
  the profiler's flag it reads is set exactly while a profiler records;
* under a CPU ``torch.profiler``, a tiny KD phase-3 step and a tiny
  baseline step carry the ranges of ``train/step.py``'s table, nested and
  counted as it says, and every operator of the step but the micro-batch
  views lies inside a phase's range;
* the step's loss and every float32 master are bit-equal with the spans
  on and off."""

import collections

import pytest
import torch

from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch import configs as pcfg
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.models import (
    LlavaOnevision,
    init_weights,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.train import (
    KDModels,
    TrainState,
    make_optimizer,
    make_train_step,
)
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.utils import trace
from knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.utils.synthetic import (
    synthetic_kd_batch,
)

ACCUM = 2
LR = 1e-3
MODES = {"kd3": ("double_trouble", 3), "baseline": ("baseline", 0)}
PHASES = ("student.forward", "teacher.forward", "loss", "backward", "accumulate", "optimizer", "tile_layout")
# the operators a step runs outside every phase: the views of ``_micro``
VIEWS = {"aten::select", "aten::as_strided"}


def _step(kind):
    """(state, step, batch): fresh tiny models from fixed seeds."""
    mode, phase = MODES[kind]
    student = init_weights(LlavaOnevision(pcfg.llava_onevision_tiny(), attn_impl="xla"), 0).train()
    teacher = None
    if mode != "baseline":
        teacher = init_weights(LlavaOnevision(pcfg.llava_onevision_tiny_teacher(), attn_impl="xla"), 1)
        teacher = teacher.requires_grad_(False).eval()
    cfg = pcfg.TrainConfig(kd_mode=mode, phase=phase, loss=pcfg.kd_loss_config_for(mode), ce_impl="fused",
                           learning_rate=LR, cosine_t_max=0)
    state = TrainState(student, make_optimizer(student, LR, kd_mode=mode, phase=phase))
    batch = synthetic_kd_batch(pcfg.llava_onevision_tiny(), batch_size=2, seq_len=96, accum=ACCUM, seed=3)
    return state, make_train_step(KDModels(student, teacher), cfg), {k: torch.from_numpy(v) for k, v in batch.items()}


def _profiled(kind):
    """(loss, masters, events): one step under a CPU profiler, its events as
    (name, start ns, end ns) sorted by start, the outer of two equal first."""
    state, step, batch = _step(kind)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        state, metrics = step(state, None, batch)
    events = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()), key=lambda e: (e[1], -e[2]))
    return metrics["loss"], state.optimizer.masters, events


def _parent(e, ranges):
    """The innermost range of ``ranges`` that holds ``e``, other than itself."""
    holders = [r for r in ranges if r is not e and r[1] <= e[1] and e[2] <= r[2]]
    return min(holders, key=lambda r: r[2] - r[1])[0] if holders else None


class _Spy:
    def __init__(self, inner=None):
        self.calls, self.inner = [], inner

    def __call__(self, *args):
        self.calls.append(args)
        return self.inner(*args) if self.inner else None


@pytest.fixture
def spies(monkeypatch):
    """``record_function`` and ``torch.cuda.synchronize`` counted, CUDA
    reported initialised (so that a recording span would drain)."""
    rf, sync = _Spy(torch.profiler.record_function), _Spy()
    monkeypatch.setattr(torch.profiler, "record_function", rf)
    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    return rf, sync


def test_a_span_is_one_check_without_a_profiler(spies):
    rf, sync = spies
    with trace.span("x"):
        pass
    state, step, batch = _step("kd3")
    step(state, None, batch)
    assert rf.calls == [] and sync.calls == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("x"):
            assert rf.calls == [("kdss.x",)] and len(sync.calls) == 1
    assert len(sync.calls) == 2


def test_the_profiler_flag_a_span_reads():
    """``span`` learns that a profiler records from this flag alone: it has to
    follow both ways of recording, or every range would silently vanish."""
    flag = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa: E731
    assert flag() is False
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert flag() is True
    assert flag() is False
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        assert flag() is True
    finally:
        prof.stop()
    assert flag() is False


@pytest.mark.parametrize("kind", sorted(MODES))
def test_the_step_carries_the_phases_ranges(kind):
    _, _, events = _profiled(kind)
    ranges = [e for e in events if e[0].startswith(trace.PREFIX)]
    counts = collections.Counter(e[0] for e in ranges)
    kd = kind != "baseline"
    want = {"kdss.step": 1, "kdss.optimizer": 1, "kdss.tile_layout": 1, "kdss.vision": ACCUM * (2 if kd else 1),
            **{f"kdss.{p}": ACCUM for p in PHASES[:5] if kd or p != "teacher.forward"},
            "kdss.accumulate": ACCUM + 1}  # one a micro-batch, and the mean over A
    assert counts == want
    parents = {e[0]: set() for e in ranges}
    for e in ranges:
        parents[e[0]].add(_parent(e, ranges))
    assert parents["kdss.step"] == {None}
    for p in PHASES:
        if f"kdss.{p}" in parents:
            assert parents[f"kdss.{p}"] == {"kdss.step"}, p
    assert parents["kdss.vision"] == ({"kdss.student.forward", "kdss.teacher.forward"} if kd
                                      else {"kdss.student.forward"})
    step = next(e for e in ranges if e[0] == "kdss.step")
    leaves = [e for e in ranges if e is not step]
    outside = {e[0] for e in events if not e[0].startswith(trace.PREFIX) and step[1] <= e[1] <= step[2]
               and not any(r[1] <= e[1] <= r[2] for r in leaves)}
    assert outside <= VIEWS, outside


@pytest.mark.parametrize("kind", sorted(MODES))
def test_spans_change_no_bit(kind):
    state, step, batch = _step(kind)
    state, metrics = step(state, None, batch)
    loss, masters, events = _profiled(kind)
    assert any(e[0] == "kdss.step" for e in events)
    assert torch.equal(metrics["loss"], loss)
    assert masters.keys() == state.optimizer.masters.keys()
    for n, m in state.optimizer.masters.items():
        assert torch.equal(m, masters[n]), n
