"""SUNRGBD toolbox extraction (`dataset/dataset_creation/extract_data.py:45-155`).

The port's copy of the JAX package's ``data/creation/extract.py``, which
imports no jax (``tests/test_torch_creation.py`` holds it to the original).

Parses ``SUNRGBDMeta.mat`` / ``allsplit.mat`` / ``SUNRGBD2Dseg.mat`` and
writes the four path-list files (``all_rgb.txt``, ``all_depth.txt``,
``all_segmentation_labels.txt``, ``annotations.txt``) plus per-image
``label/label.npy`` segmentation arrays.  Additionally provides the
train/val/test split of those lists by ``allsplit.mat`` membership, which
the reference's per-split generators consume from
``splits_output_paths/<split>/``.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np


def extract_sunrgbd_lists(
    toolbox_dir: str,
    output_path: str,
    write_labels: bool = True,
) -> Dict[str, List[str]]:
    """Toolbox .mat files -> path lists (and label.npy files).

    Returns dict with keys rgb/depth/label/annotation (all repo-relative
    ``SUNRGBD/...`` paths, as the reference writes them).
    """
    import h5py
    import scipy.io

    meta_path = os.path.join(toolbox_dir, "Metadata/SUNRGBDMeta.mat")
    seg_path = os.path.join(toolbox_dir, "Metadata/SUNRGBD2Dseg.mat")

    meta = scipy.io.loadmat(meta_path, squeeze_me=True, struct_as_record=False)[
        "SUNRGBDMeta"
    ]
    seg_file = h5py.File(seg_path, mode="r", libver="latest") if write_labels else None
    seglabel = seg_file["SUNRGBD2Dseg"]["seglabel"] if seg_file is not None else None

    rgb, depth, label, annotation = [], [], [], []
    for i, m in enumerate(np.atleast_1d(meta)):
        meta_dir = "/".join(m.rgbpath.split("/")[:-2])
        real_dir = meta_dir.split("/n/fs/sun3d/data/SUNRGBD/")[1]
        rgb.append(os.path.join("SUNRGBD", real_dir, "image", m.rgbname))
        depth.append(os.path.join("SUNRGBD", real_dir, "depth_bfx", m.depthname))
        label_rel = os.path.join(real_dir, "label/label.npy")
        label.append(os.path.join("SUNRGBD", label_rel))
        annotation.append(
            os.path.join("SUNRGBD", real_dir, "annotation", "index.json")
        )
        if write_labels:
            label_full = os.path.join(output_path, "SUNRGBD", label_rel)
            if not os.path.exists(label_full):
                os.makedirs(os.path.dirname(label_full), exist_ok=True)
                arr = np.array(
                    seg_file[seglabel[i][0]][:].transpose(1, 0)
                ).astype(np.uint8)
                np.save(label_full, arr)

    lists = {"rgb": rgb, "depth": depth, "label": label, "annotation": annotation}
    names = {
        "rgb": "all_rgb.txt",
        "depth": "all_depth.txt",
        "label": "all_segmentation_labels.txt",
        "annotation": "annotations.txt",
    }
    os.makedirs(output_path, exist_ok=True)
    for key, fname in names.items():
        with open(os.path.join(output_path, fname), "w") as f:
            f.write("\n".join(lists[key]))
    if seg_file is not None:
        seg_file.close()
    return lists


def split_lists(
    toolbox_dir: str,
    lists: Dict[str, List[str]],
    output_path: str,
    val_fraction: float = 0.1,
    seed: int = 42,
) -> None:
    """Write ``splits_output_paths/{train,validation,test}/*.txt`` using
    ``allsplit.mat`` train/test membership (val carved from train)."""
    import scipy.io

    split = scipy.io.loadmat(
        os.path.join(toolbox_dir, "traintestSUNRGBD/allsplit.mat"),
        squeeze_me=True, struct_as_record=False,
    )
    train_dirs = {
        d.split("/n/fs/sun3d/data/SUNRGBD/")[1].rstrip("/")
        for d in np.atleast_1d(split["alltrain"])
    }

    def real_dir(rgb_path: str) -> str:
        # SUNRGBD/<real_dir>/image/<name>
        parts = rgb_path.split("/")
        return "/".join(parts[1:-2])

    idx_train, idx_test = [], []
    for i, p in enumerate(lists["rgb"]):
        (idx_train if real_dir(p) in train_dirs else idx_test).append(i)

    rng = np.random.default_rng(seed)
    idx_train = np.asarray(idx_train)
    rng.shuffle(idx_train)
    n_val = int(len(idx_train) * val_fraction)
    idx_val, idx_train = idx_train[:n_val], idx_train[n_val:]

    names = {
        "rgb": "all_rgb.txt",
        "depth": "all_depth.txt",
        "label": "all_segmentation_labels.txt",
        "annotation": "annotations.txt",
    }
    for split_name, idxs in (
        ("train", idx_train), ("validation", idx_val), ("test", idx_test)
    ):
        d = os.path.join(output_path, "splits_output_paths", split_name)
        os.makedirs(d, exist_ok=True)
        for key, fname in names.items():
            with open(os.path.join(d, fname), "w") as f:
                f.write("\n".join(lists[key][i] for i in idxs))
