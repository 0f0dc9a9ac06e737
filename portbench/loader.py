"""Modules the harness loads by file path, so that a test can point it at
another directory: the per-layer metrics (``metrics/<name>.py``) and, by
the ``model_type`` of a configuration's ``text_config`` (the key of the
published HF ``config.json``), each language model's two files,
``archs/<model_type>.py`` and ``reference/lm/<model_type>.py``."""

from __future__ import annotations

import functools
import importlib.util
import re
from pathlib import Path

_MODEL_TYPE = re.compile(r"[A-Za-z0-9_]+\Z")


def model_file(directory: Path, tc: dict) -> Path:
    """The file of ``tc``'s language model in ``directory``.  Stops the run
    where ``tc`` names no model_type or the file is not there."""
    name = tc.get("model_type")
    if not isinstance(name, str) or not _MODEL_TYPE.match(name):
        raise SystemExit(f"a text_config must name its language model by a model_type of letters, digits "
                         f"and _; it has {name!r}")
    return _file(directory, name)


@functools.lru_cache(maxsize=None)
def _file(directory: Path, name: str) -> Path:
    # cached: the operations of every sample of a window are counted through here
    path = directory / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no file for the language model {name!r}: {path}")
    return path


@functools.lru_cache(maxsize=None)
def load(path: Path):
    """The module of the file at ``path``, loaded once."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def modules(directory: Path):
    """(name, module) of every file in ``directory`` whose name does not
    start with ``_``, by name."""
    return [(p.stem, load(p)) for p in sorted(directory.glob("*.py")) if not p.name.startswith("_")]
