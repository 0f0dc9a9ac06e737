"""Dataset-creation layer (reference L0, `dataset/dataset_creation/`):
SUNRGBD toolbox extraction, the prominent-object heuristic, six question
generators, answer post-processing, and merge/balance — all pure
numpy/pandas (no shapely/inflect/num2words/textblob dependencies).

The port's copy of the JAX package's ``data/creation/__init__.py``, which
imports no jax (``tests/test_torch_creation.py`` holds it to the original)."""

from .geometry import centroid, polygon_area
from .prominent import (
    filter_unwanted_objects,
    find_most_prominent_object,
    find_object_index,
    find_object_polygon,
    get_object_name_list,
)
from .postprocess import process_answers_column, process_text_only

__all__ = [
    "centroid",
    "polygon_area",
    "filter_unwanted_objects",
    "find_most_prominent_object",
    "find_object_index",
    "find_object_polygon",
    "get_object_name_list",
    "process_answers_column",
    "process_text_only",
]
