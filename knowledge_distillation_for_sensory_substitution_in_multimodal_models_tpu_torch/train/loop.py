"""The training loop: epochs of accumulated steps, validation epochs,
checkpoints and TensorBoard scalars (port of the JAX package's
``train/loop.py``).

Scalar names match the reference's Lightning logs (``train_loss``,
``val_loss``).  A SIGTERM snapshots the state at the next step boundary
(``preempt-step=N.ckpt``); the val loss is summed on the device and read
back once per val epoch.  With ``profile_dir``, steps 2-4 are traced by
``torch.profiler`` (the host and, for a model on CUDA, the card) into
``<profile_dir>/trace_steps2-4.json``, the steps the JAX loop traces.  The
trace carries the step's ``kdss.*`` ranges (``train/step.py`` lists them);
on the card each range's boundaries synchronise the device, so the traced
steps run slower than the others (``utils/trace.py``).

Under an active mesh (``parallel/mesh.py::use_mesh``) every rank runs the
loop: ``shard_batch_fn`` takes each rank's rows of the host batch (the JAX
loop's argument of the same name), the step's metrics are already global
(``train/step.py``), a SIGTERM on any rank stops every rank at the same
step, the checkpoint is gathered whole to rank 0
(``checkpoint.py::gather_full_state``), and rank 0 alone prints, writes
TensorBoard scalars, traces and writes checkpoints.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from ..configs import TrainConfig
from ..parallel.mesh import active_mesh, is_rank0
from .checkpoint import CheckpointManager, gather_full_state
from .step import KDModels, TrainState, make_eval_step, make_train_step


class TBWriter:
    """tensorboardX writer, no-op if unavailable."""

    def __init__(self, logdir: Optional[str], run_name: str):
        self._w = None
        if logdir:
            try:
                from tensorboardX import SummaryWriter

                self._w = SummaryWriter(f"{logdir}/{run_name}")
            except Exception:
                pass

    def scalar(self, tag: str, value: float, step: int):
        if self._w is not None:
            self._w.add_scalar(tag, value, step)

    def close(self):
        if self._w is not None:
            self._w.close()


def checkpoint_state(state: TrainState) -> Optional[dict]:
    """What a checkpoint holds; under a mesh the whole state gathered to
    rank 0 (every rank calls; the others get None)."""
    if active_mesh() is not None:
        return gather_full_state(state, state.compute_dtype)
    return {"params": state.model.state_dict(), "opt_state": state.optimizer.state_dict(),
            "step": state.step}


def _any_rank(flag: bool) -> bool:
    """``flag`` or'd over every rank (one small all-reduce under a mesh)."""
    mesh = active_mesh()
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], device=mesh.device_type)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _rank0_decides(value: bool) -> bool:
    """Rank 0's ``value`` on every rank (a broadcast under a mesh)."""
    if active_mesh() is None:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def load_checkpoint_state(state: TrainState, saved: dict) -> TrainState:
    state.model.load_state_dict(saved["params"])
    state.optimizer.load_state_dict(saved["opt_state"])
    state.step = int(saved["step"])
    return state


PROFILE_STEPS = (2, 4)  # first and last traced step, as the JAX loop's


def _start_profile(model: torch.nn.Module):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if next(model.parameters()).device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, model: torch.nn.Module, profile_dir: str) -> str:
    if next(model.parameters()).device.type == "cuda":
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_steps{PROFILE_STEPS[0]}-{PROFILE_STEPS[1]}.json")
    prof.export_chrome_trace(path)
    print(f"profile: wrote {path}", flush=True)
    return path


def run_training(
    models: KDModels,
    cfg: TrainConfig,
    state: TrainState,
    teacher_params: Any,
    train_loader,
    val_loader,
    *,
    put: Callable,
    ckpt_dir: Optional[str] = None,
    tb_logdir: Optional[str] = None,
    run_name: str = "run",
    log_every: int = 10,
    profile_dir: Optional[str] = None,
    shard_batch_fn: Optional[Callable] = None,
) -> TrainState:
    """Epoch loop; returns the final state.  ``put(numpy_batch) -> tensors``
    moves a host batch to the model's device; ``shard_batch_fn`` (under a
    mesh) first takes this rank's rows of it."""
    train_step = make_train_step(models, cfg)
    eval_step = make_eval_step(models, cfg)
    rank0 = is_rank0()
    tb = TBWriter(tb_logdir if rank0 else None, run_name)
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    profile_dir = profile_dir if rank0 else None
    if shard_batch_fn is not None:
        put_host = put

        def put(b):
            return put_host(shard_batch_fn(b))

    preempted = {"flag": False}
    prof = None

    def _on_term(signum, frame):
        preempted["flag"] = True

    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_term)
    except ValueError:  # not the main thread
        prev_handler = None

    try:
        for epoch in range(cfg.max_epochs):
            t_epoch = time.time()
            n_samples = 0
            for batch in train_loader:
                batch.pop("question_id", None)
                a, b = batch["student_input_ids"].shape[:2]
                step_i = state.step
                if profile_dir and step_i == PROFILE_STEPS[0]:
                    prof = _start_profile(state.model)
                state, metrics = train_step(state, teacher_params, put(batch))
                if prof is not None and step_i == PROFILE_STEPS[1]:
                    _stop_profile(prof, state.model, profile_dir)
                    prof = None
                n_samples += a * b
                if step_i % log_every == 0 and rank0:
                    loss = float(metrics["loss"])
                    tb.scalar("train_loss", loss, step_i)
                    for k, v in metrics.items():
                        if k != "loss":
                            tb.scalar(f"train/{k}", float(v), step_i)
                    rate = n_samples / max(time.time() - t_epoch, 1e-9)
                    print(f"epoch {epoch} step {step_i} loss {loss:.4f} ({rate:.2f} samples/s)",
                          flush=True)
                if _any_rank(preempted["flag"]):
                    if ckpt is not None:
                        saved = checkpoint_state(state)
                        if rank0:
                            path = ckpt.save_preempt(state.step, saved)
                            print(f"preempted: saved {path}", flush=True)
                    return state

            # ---- validation epoch: sum on the device, read back once ----
            val_sum, val_n = None, 0
            for batch in val_loader:
                batch.pop("question_id", None)
                db = put(batch)
                for a_i in range(batch["student_input_ids"].shape[0]):
                    m = eval_step(state, teacher_params, {k: v[a_i] for k, v in db.items()})
                    val_sum = m["loss"] if val_sum is None else val_sum + m["loss"]
                    val_n += 1
            val_loss = float(val_sum) / val_n if val_n else float("nan")
            tb.scalar("val_loss", val_loss, state.step)
            if rank0:
                print(f"epoch {epoch} val_loss {val_loss:.4f}", flush=True)

            if ckpt is not None and val_loss == val_loss and _rank0_decides(
                    rank0 and ckpt.improves(val_loss)):
                full = checkpoint_state(state)
                if rank0:
                    saved = ckpt.save(epoch, val_loss, full)
                    print(f"saved checkpoint {saved}", flush=True)
        return state
    finally:
        if prof is not None:  # fewer steps than the traced window
            _stop_profile(prof, state.model, profile_dir)
        tb.close()
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)


def to_device(batch: dict, device: torch.device) -> dict:
    """numpy host batch -> tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
