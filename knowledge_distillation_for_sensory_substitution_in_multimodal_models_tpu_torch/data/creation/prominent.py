"""The prominent-object heuristic — the core of every question generator.

The port's copy of the JAX package's ``data/creation/prominent.py``, which
imports no jax (``tests/test_torch_creation.py`` holds it to the original).

Behavior parity with `dataset/utils.py:120-195` (duplicated at
`dataset/dataset_creation/utils.py`): filter wall/floor/ceiling variants,
rank remaining polygons by area, dominance when the largest is > ws=1.3 x
the second; otherwise break ties by combined (area rank + depth rank).
"""

from __future__ import annotations

from typing import List, Optional

from .geometry import average_depth, polygon_area

UNWANTED_NAMES = ["wall", "wal", "floor", "flor", "floro", "ceiling"]


def get_name(obj) -> str:
    """`dataset/utils.py:210-217`."""
    if isinstance(obj, dict):
        return obj.get("name", "Key not found")
    if isinstance(obj, list):
        return "Cannot access key in a list"
    return "Unsupported type"


def get_object_name_list(data: dict) -> List[str]:
    """Names of objects referenced by frame-0 polygons."""
    names = []
    for poly in data["frames"][0]["polygon"]:
        idx = poly["object"]
        if 0 <= idx < len(data["objects"]):
            obj = data["objects"][idx]
            if isinstance(obj, dict) and "name" in obj:
                names.append(obj["name"])
    return names


def filter_unwanted_objects(data: dict) -> dict:
    """`dataset/utils.py:95-119`: drop wall/floor/ceiling objects and their
    polygons (indices preserved via removal list)."""
    objects_to_remove = []
    for idx, obj in enumerate(data["objects"]):
        if isinstance(obj, dict) and "name" in obj and any(
            u in obj["name"].lower() for u in UNWANTED_NAMES
        ):
            objects_to_remove.append(idx)
    for frame in data["frames"]:
        frame["polygon"] = [
            p for p in frame["polygon"] if p["object"] not in objects_to_remove
        ]
    data["objects"] = [
        o for i, o in enumerate(data["objects"]) if i not in objects_to_remove
    ]
    return data


def find_most_prominent_object(data: dict, ws: float = 1.3) -> Optional[str]:
    """`dataset/utils.py:120-195`; returns the object *name* or None."""
    unwanted_indices = set()
    for idx, obj in enumerate(data["objects"]):
        if isinstance(obj, dict) and "name" in obj:
            if any(u in obj["name"].lower() for u in UNWANTED_NAMES):
                unwanted_indices.add(idx)

    object_info = []
    for poly in data["frames"][0]["polygon"]:
        obj_idx = poly["object"]
        if obj_idx in unwanted_indices:
            continue
        points = [(x, y) for x, y in zip(poly["x"], poly["y"])]
        area = polygon_area(points)
        depth = average_depth(poly) if "XYZ" in poly else float("inf")
        object_info.append((obj_idx, area, depth))

    if not object_info:
        return None

    object_info.sort(key=lambda t: t[1], reverse=True)
    if len(object_info) == 1 or object_info[0][1] > ws * object_info[1][1]:
        best_idx = object_info[0][0]
    else:
        size_rank = {
            t[0]: i + 1
            for i, t in enumerate(sorted(object_info, key=lambda t: t[1], reverse=True))
        }
        depth_rank = {
            t[0]: i + 1
            for i, t in enumerate(sorted(object_info, key=lambda t: t[2]))
        }
        combined = {
            obj_id: size_rank[obj_id] + depth_rank[obj_id]
            for obj_id, _, _ in object_info
        }
        best_idx = min(combined, key=combined.get)

    obj = data["objects"][best_idx]
    if isinstance(obj, dict) and "name" in obj:
        return obj["name"]
    return "Unknown"


def find_object_index(annotation_data: dict, most_prominent_object: str) -> int:
    """`dataset/utils.py:198-208`."""
    for i, obj in enumerate(annotation_data["objects"]):
        if get_name(obj) == most_prominent_object:
            return i
    return -1


def find_object_polygon(annotation_data: dict, most_prominent_object_index: int):
    """`dataset/utils.py:219-226`."""
    for polygon in annotation_data["frames"][0]["polygon"]:
        if polygon["object"] == most_prominent_object_index:
            return polygon
    return None
