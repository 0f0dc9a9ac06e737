"""Panesar VGG16+LSTM baseline trainer and evaluator (port of the JAX
package's ``cli/panesar_baseline.py``; the reference's
`further_scripts/Panesar_Recreation/panesar_model_baseline_{train,eval}.py`).

As in the JAX CLI:

* it trains on the local SUNRGBD CSVs (the reference pulls an HF-hub
  dataset, `panesar_model_baseline_train.py:214-216`): same columns, same
  QA task;
* Adadelta (``torch.optim.Adadelta``: rho 0.9, eps 1e-6, those of
  ``optax.adadelta``), cross-entropy masked by each row's validity (an
  answer outside the vocabulary, or a pad row of a tail batch), the
  validation loss after every epoch, early stopping after
  ``--early_stop_patience`` epochs without a gain of 1e-4 (`:203-341`);
* ``--optuna_trials N``: the Bayesian lr search with the reference's
  semantics (log-uniform lr in [1e-4, 2.0], per-epoch report and prune,
  minimize the validation loss); optuna is imported only then, and its
  absence is an ImportError, not a skip;
* the question and answer vocabularies are frozen to JSON under
  ``--vocab_dir`` (`panesar_model_baseline_eval.py:44-108`).

Port differences: the best model is saved with ``torch.save`` to the file
``--ckpt`` (``{"params": state_dict}``; the JAX CLI writes an Orbax
directory there) and ``eval`` restores it; seeded weights come from torch's
default initialisation (the reference's modules; no ImageNet weights are
in the repo, ``models/panesar.py::convert_vgg16_state_dict`` overlays a
local torchvision state dict); dropout draws fresh masks every step from a
``torch.Generator`` seeded by ``--seed`` (the JAX step draws every step's
masks from ``PRNGKey(0)``).  Float32 on ``cuda:0`` (TF32 off), unless
``--cpu``.  The JAX flag set (``common.add_jax_flag_set``): the trainers'
eight host flags are parsed and not read, as in the JAX CLI;
``--distributed`` and a ``--mesh`` over more than one rank are refused.

Smoke on the CPU:
  python -m knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli.panesar_baseline \\
      train --synthetic_data --cpu --epochs 1 --max_items 6 --img_size 32
  python -m knowledge_distillation_for_sensory_substitution_in_multimodal_models_tpu_torch.cli.panesar_baseline \\
      eval --synthetic_data --cpu --max_items 6 --img_size 32
"""

from __future__ import annotations

import argparse
import json
import os
import re
import tempfile
import time

import numpy as np

from . import common

IMG_SIZE = 224


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=["train", "eval"])
    p.add_argument("--root_data_dir", type=str, default=None)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1.0)  # Adadelta default
    p.add_argument("--fusion", type=str, default="conv1d",
                   choices=["hadamard", "addition", "maxpool", "conv1d", "fusion_at_start"])
    p.add_argument("--early_stop_patience", type=int, default=3)
    p.add_argument("--vocab_dir", type=str, default="panesar_vocab")
    p.add_argument("--ckpt", type=str, default="checkpoints/panesar",
                   help="the best model's file (torch.save)")
    p.add_argument("--max_items", type=int, default=None)
    p.add_argument("--img_size", type=int, default=IMG_SIZE,
                   help="input resolution (fc1 takes 512 * (img_size // 32) ** 2 features; torchvision "
                        "classifier weights only line up at 224; smaller sizes are for offline tests)")
    p.add_argument("--optuna_trials", type=int, default=0, help="Bayesian lr search when optuna is installed")
    common.add_jax_flag_set(p, mesh_note=common.ONE_PROCESS)
    return p


def _tokenize_q(q: str):
    return re.findall(r"[a-z0-9']+", str(q).lower())


def build_vocabs(ds, vocab_dir: str):
    """Frozen question-word and answer-class vocabularies -> JSON."""
    qwords, answers = {"<pad>": 0, "<unk>": 1}, {}
    for i in range(len(ds)):
        q, a = ds.df.iloc[i, 1], str(ds.df.iloc[i, 2]).strip().lower()
        for w in _tokenize_q(q):
            qwords.setdefault(w, len(qwords))
        answers.setdefault(a, len(answers))
    os.makedirs(vocab_dir, exist_ok=True)
    json.dump(qwords, open(os.path.join(vocab_dir, "question_vocab.json"), "w"))
    json.dump(answers, open(os.path.join(vocab_dir, "answer_vocab.json"), "w"))
    return qwords, answers


def load_vocabs(vocab_dir: str):
    qwords = json.load(open(os.path.join(vocab_dir, "question_vocab.json")))
    answers = json.load(open(os.path.join(vocab_dir, "answer_vocab.json")))
    return qwords, answers


def encode_batch(ds, idxs, qwords, answers, seq_len=16, img_size=IMG_SIZE):
    from PIL import Image

    b = len(idxs)
    rgb = np.zeros((b, img_size, img_size, 3), np.float32)
    depth = np.zeros((b, img_size, img_size, 3), np.float32)
    qids = np.zeros((b, seq_len), np.int32)
    ys = np.zeros((b,), np.int32)
    valid = np.ones((b,), bool)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    for j, i in enumerate(idxs):
        q, a, rgb_np, depth3, _ = ds[i]
        for arr, out in ((rgb_np, rgb), (depth3, depth)):
            im = Image.fromarray(arr).resize((img_size, img_size), Image.BILINEAR)
            out[j] = (np.asarray(im, np.float32) / 255.0 - mean) / std
        toks = _tokenize_q(q)[:seq_len]
        qids[j, : len(toks)] = [qwords.get(w, 1) for w in toks]
        key = str(a).strip().lower()
        if key in answers:
            ys[j] = answers[key]
        else:
            valid[j] = False
    return rgb, depth, qids, ys, valid


def to_tensors(arrays, device):
    """``encode_batch``'s arrays -> tensors on ``device``: images NHWC ->
    NCHW float32, question ids and labels int64, validity float32."""
    import torch

    rgb, depth, qids, ys, valid = arrays
    img = [torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().to(device) for a in (rgb, depth)]
    return (*img, torch.from_numpy(qids).long().to(device), torch.from_numpy(ys).long().to(device),
            torch.from_numpy(valid.astype(np.float32)).to(device))


def masked_ce(logits, ys, valid):
    """Mean cross-entropy over the valid rows (sum over none is 0)."""
    import torch.nn.functional as F

    ce = F.cross_entropy(logits, ys, reduction="none")
    return (ce * valid).sum() / valid.sum().clamp_min(1.0)


def make_optimizer(model, lr: float):
    """``torch.optim.Adadelta`` over the trainable parameters, with the
    rho and eps of ``optax.adadelta``."""
    import torch

    return torch.optim.Adadelta([p for p in model.parameters() if p.requires_grad], lr=lr, rho=0.9, eps=1e-6)


def train_step(model, optimizer, batch, generator=None, deterministic: bool = False):
    """One Adadelta step on ``batch`` (``to_tensors``' tuple), the model in
    training mode: dropout with masks from ``generator`` unless
    ``deterministic``; returns the loss (a tensor on the device, not read
    back)."""
    rgb, depth, qids, ys, valid = batch
    model.train()  # cuDNN's LSTM backward needs training mode
    optimizer.zero_grad(set_to_none=True)
    loss = masked_ce(model(rgb, depth, qids, deterministic=deterministic, generator=generator), ys, valid)
    loss.backward()
    optimizer.step()
    return loss.detach()


def build_model(args, qwords, answers, seed: int, device):
    """The seeded model (built on the CPU from ``seed``, so that it is the
    same on every device, then moved)."""
    import torch

    from ..models.panesar import PanesarVQAModel

    torch.manual_seed(seed)
    model = PanesarVQAModel(vocab_size=max(len(qwords), 2), num_classes=max(len(answers), 2),
                            fusion_method=args.fusion, img_size=args.img_size)
    return model.to(device)


def main(argv=None) -> dict:
    """``train``: returns the final run's per-step train losses and
    per-epoch validation losses, the best validation loss, the steps, and
    their wall: ``train_s``, the epochs' training loops (synchronised at
    each epoch's end), of which ``host_s`` encoding batches (the steps run
    on the device meanwhile, so the two do not split the wall).  ``eval``: the accuracy, its counts and the
    wall of the loop (``eval_s``)."""
    args = build_parser().parse_args(argv)
    common.refuse_mesh(args, "cli/panesar_baseline.py")
    common.load_env()
    device = common.setup_device(args)

    import torch

    from ..data.dataset import SUNRGBDVQADataset

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    root = args.root_data_dir or os.environ.get("ROOT_DATA_DIR")
    if args.synthetic_data:
        root = common.ensure_synthetic_dataset(root or tempfile.mkdtemp(prefix="kdss_synth_"))
    if not root:
        raise SystemExit("set ROOT_DATA_DIR or pass --root_data_dir / --synthetic_data")
    train_ds = SUNRGBDVQADataset(root, "train_dataset.csv")
    val_ds = SUNRGBDVQADataset(root, "val_dataset.csv")
    n_train = min(len(train_ds), args.max_items or len(train_ds))
    n_val = min(len(val_ds), args.max_items or len(val_ds))

    if args.mode == "train":
        qwords, answers = build_vocabs(train_ds, args.vocab_dir)
    else:
        qwords, answers = load_vocabs(args.vocab_dir)
    ckpt_path = os.path.abspath(args.ckpt)

    def encode(ds, idxs):
        return encode_batch(ds, idxs, qwords, answers, img_size=args.img_size)

    if args.mode == "eval":
        if not os.path.isfile(ckpt_path):
            raise SystemExit(f"--ckpt {ckpt_path}: no such checkpoint file")
        model = build_model(args, qwords, answers, args.seed, device)
        model.load_state_dict(torch.load(ckpt_path, map_location=device, weights_only=True)["params"])
        model.eval()
        correct = total = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            for start in range(0, n_val, args.batch_size):
                idxs = range(start, min(start + args.batch_size, n_val))
                rgb, depth, qids, ys, valid = to_tensors(encode(val_ds, idxs), device)
                pred = model(rgb, depth, qids).argmax(-1)
                correct += int(((pred == ys) & (valid > 0)).sum())
                total += int(valid.sum())
        eval_s = time.perf_counter() - t0
        acc = correct / max(total, 1)
        print(f"panesar eval accuracy: {acc:.4f} ({correct}/{total})")
        return dict(accuracy=acc, correct=correct, total=total, rows=n_val, eval_s=eval_s)

    # ---- train (Adadelta + early stopping; optional Optuna lr search,
    # reference `panesar_model_baseline_train.py:203-341`) ----
    def padded_batches(n, order=None):
        """Batches of --batch_size row indices, a ragged tail padded by
        repeating its last row; yields (indices, pad rows)."""
        for start in range(0, n, args.batch_size):
            idxs = list(order[start:start + args.batch_size] if order is not None
                        else range(start, min(start + args.batch_size, n)))
            pad = args.batch_size - len(idxs)
            yield idxs + [idxs[-1]] * pad, pad

    def batch_of(ds, idxs, pad):
        arrays = encode(ds, idxs)
        if pad:
            arrays[4][len(idxs) - pad:] = False  # the pad rows count for nothing
        return to_tensors(arrays, device)

    def run_training(lr, epochs, seed=0, save_to=None, trial=None):
        """One Adadelta training run from the weights of ``seed``, dropout
        masks from a generator of ``seed``; returns the best validation
        loss and the run's record.  ``trial``: an optuna trial, reported to
        and asked to prune after every epoch (`:307-311`)."""
        model = build_model(args, qwords, answers, seed, device)
        optimizer = make_optimizer(model, lr)
        gen = torch.Generator(device=device).manual_seed(seed)
        rec = dict(train_losses=[], val_losses=[], steps=0, host_s=0.0, train_s=0.0)
        best_val, patience = float("inf"), 0
        for epoch in range(epochs):
            order = np.random.default_rng(epoch).permutation(n_train)
            losses = []
            t_epoch = time.perf_counter()
            for idxs, pad in padded_batches(n_train, order):
                t0 = time.perf_counter()
                batch = batch_of(train_ds, idxs, pad)
                rec["host_s"] += time.perf_counter() - t0
                losses.append(train_step(model, optimizer, batch, gen))
            sync()
            rec["train_s"] += time.perf_counter() - t_epoch
            rec["steps"] += len(losses)
            rec["train_losses"] += [x.item() for x in losses]
            model.eval()
            num = torch.zeros((), device=device)
            den = torch.zeros((), device=device)
            with torch.no_grad():
                for idxs, pad in padded_batches(n_val):
                    rgb, depth, qids, ys, valid = batch_of(val_ds, idxs, pad)
                    ce = torch.nn.functional.cross_entropy(model(rgb, depth, qids), ys, reduction="none")
                    num += (ce * valid).sum()
                    den += valid.sum()
            val_loss = num.item() / max(den.item(), 1.0)
            rec["val_losses"].append(val_loss)
            print(f"epoch {epoch} train_loss {rec['train_losses'][-1]:.4f} val_loss {val_loss:.4f}")
            if trial is not None:
                import optuna

                trial.report(val_loss, epoch)
                if trial.should_prune():
                    raise optuna.exceptions.TrialPruned()
            if val_loss < best_val - 1e-4:
                best_val, patience = val_loss, 0
                if save_to is not None:
                    os.makedirs(os.path.dirname(save_to) or ".", exist_ok=True)
                    torch.save({"params": model.state_dict()}, save_to)
            else:
                patience += 1
                if patience >= args.early_stop_patience:
                    print("early stopping")
                    break
        return best_val, rec

    lr = args.lr
    if args.optuna_trials > 0:
        # Bayesian lr search, reference semantics: log-uniform lr in
        # [1e-4, 2.0] (`panesar_model_baseline_train.py:238`), objective =
        # best CrossEntropy val loss, direction=minimize (`:325-327`).
        import optuna

        def objective(trial):
            lr_t = trial.suggest_float("lr", 1e-4, 2.0, log=True)
            return run_training(lr_t, epochs=args.epochs, seed=trial.number, trial=trial)[0]

        study = optuna.create_study(direction="minimize")
        print(f"Starting Bayesian Optimization with {args.optuna_trials} trials... Target: CrossEntropy Val Loss")
        study.optimize(objective, n_trials=args.optuna_trials)
        lr = study.best_params["lr"]
        print(f"optuna best lr: {lr:.6g} (best val loss {study.best_value:.4f})")

    best, rec = run_training(lr, args.epochs, seed=args.seed, save_to=ckpt_path)
    print(f"panesar training complete (best val loss {best:.4f})")
    return dict(rec, best_val=best, lr=lr)


if __name__ == "__main__":
    main()
