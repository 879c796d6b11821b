"""Dataset plugin layer (port of ``theanet_tpu/data/__init__.py``).

A data module exposes ``training_x, training_y, testing_x, testing_y``,
loaded by name: a top-level ``data.<name>`` package relative to the working
directory first (the reference's layout, train.py:119), then the built-in
``theanet_tpu_torch.data.<name>`` modules. The built-ins are copies of the
JAX package's numpy generators, so the same name gives the same arrays.
"""

from __future__ import annotations

import importlib

__all__ = ["load_dataset"]


def load_dataset(name: str):
    try:
        return importlib.import_module("data." + name)
    except ModuleNotFoundError as e:
        # fall back only when the user module itself is absent; an import
        # error raised inside an existing data/<name>.py must surface
        if e.name not in ("data", "data." + name):
            raise
        return importlib.import_module("theanet_tpu_torch.data." + name)
