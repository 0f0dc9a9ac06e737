"""SUNRGBD and DAQUAR VQA row readers (jax-free counterparts of the JAX
package's ``data/dataset.py::SUNRGBDVQADataset`` and ``DAQUARVQADataset``,
whose module imports the jax depth module).

SUNRGBD: CSV at ``<root>/SUNRGBD/csv_data/<name>`` with columns
[Question_Id, Questions, Answers, Image_Path, Depth_Path, ...] addressed
positionally; image paths are joined under ``<root>/SUNRGBD`` with the
duplicated "SUNRGBD" segment stripped.  DAQUAR (NYU-Depth): CSV at
``<root>/<name>``, images at ``<root>/images/<stem>.png`` and
``<root>/depth/<stem>_depth.png``.  The depth stream goes through the numpy
encoders of ``data/depth.py``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from .depth import depth_to_3ch_numpy, depth_to_gray3_numpy

DEPTH_ENCODINGS = ("prewitt", "gray3", "prewitt_imagenet")


def remove_duplicate_sunrgbd_segment(path: str, substring: str = "SUNRGBD") -> str:
    """Strip the first occurrence of the segment."""
    index = path.find(substring)
    if index != -1:
        path = path[:index] + path[index + len(substring):]
    return path


class SUNRGBDVQADataset:
    """Map-style dataset yielding (question, answer, rgb_np, depth3_np, idx)."""

    def __init__(
        self,
        root_data_dir: str,
        csv_file_name: str,
        subset_percentage: Optional[float] = None,
        depth_encoding: str = "prewitt",
    ):
        import pandas as pd

        if depth_encoding not in DEPTH_ENCODINGS:
            raise ValueError(f"depth_encoding must be one of {DEPTH_ENCODINGS}")
        self.df = pd.read_csv(os.path.join(root_data_dir, "SUNRGBD/csv_data", csv_file_name))
        if subset_percentage is not None:
            # head-slice, floored at one row
            self.df = self.df.iloc[: max(1, int(len(self.df) * subset_percentage))]
        self.dataset_directory = os.path.join(root_data_dir, "SUNRGBD")
        self.depth_encoding = depth_encoding

    def __len__(self) -> int:
        return len(self.df)

    def image_paths(self, idx: int) -> Tuple[str, str]:
        rgb = os.path.join(self.dataset_directory, self.df.iloc[idx, 3])
        depth = os.path.join(self.dataset_directory, self.df.iloc[idx, 4])
        return (
            remove_duplicate_sunrgbd_segment(rgb).replace("\\", "/"),
            remove_duplicate_sunrgbd_segment(depth).replace("\\", "/"),
        )

    def __getitem__(self, idx: int):
        from PIL import Image

        rgb_path, depth_path = self.image_paths(idx)
        rgb = np.array(Image.open(rgb_path).convert("RGB"))
        depth_raw = np.array(Image.open(depth_path))
        if self.depth_encoding == "gray3":
            depth3 = depth_to_gray3_numpy(depth_raw)
        else:
            depth3 = depth_to_3ch_numpy(
                depth_raw, imagenet_bake=self.depth_encoding == "prewitt_imagenet"
            )
        return str(self.df.iloc[idx, 1]), str(self.df.iloc[idx, 2]), rgb, depth3, idx


class DAQUARVQADataset(SUNRGBDVQADataset):
    """DAQUAR (NYU-Depth) variant: the CSV at the root, the path scheme
    ``images/<name>.png`` + ``depth/<name>_depth.png`` and the Prewitt depth
    encoding; ``subset_percentage`` head-slices without a floor."""

    def __init__(
        self,
        root_data_dir: str,
        csv_file_name: str,
        subset_percentage: Optional[float] = None,
    ):
        import pandas as pd

        self.df = pd.read_csv(os.path.join(root_data_dir, csv_file_name))
        if subset_percentage is not None:
            self.df = self.df.iloc[: int(len(self.df) * subset_percentage)]
        self.dataset_directory = root_data_dir
        self.depth_encoding = "prewitt"

    def image_paths(self, idx: int) -> Tuple[str, str]:
        stem = os.path.splitext(os.path.basename(str(self.df.iloc[idx, 3])))[0]
        return (
            os.path.join(self.dataset_directory, "images", f"{stem}.png"),
            os.path.join(self.dataset_directory, "depth", f"{stem}_depth.png"),
        )
