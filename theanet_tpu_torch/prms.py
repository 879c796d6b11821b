"""Config ingestion: .prms files (Python-literal dicts) and .pkl checkpoints.

Bit-compatible with the reference's config layer (train.py:79-84): a .prms
file is a Python literal dict ``{"layers": [...], "training_params": {...}}``
parsed with ast.literal_eval (tuples and comments allowed, no schema); a .pkl
is a pickled checkpoint carrying ``allwts`` too — the config doubles as the
checkpoint and resume format (SURVEY.md §5.6).
"""

from __future__ import annotations

import ast
import pickle

import numpy as np

from .tracing import span

__all__ = ["load_params", "save_checkpoint", "fixdim"]


def load_params(path: str):
    """Load a .prms or .pkl params file.

    Returns (layers, training_params, allwts_or_None).
    """
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            params = pickle.load(f)
    else:
        with open(path, "r") as f:
            params = ast.literal_eval(f.read())

    layers = params["layers"]
    tr_prms = params["training_params"]
    allwts = params.get("allwts", None)

    # Seed default (train.py:93-95)
    if "SEED" not in tr_prms or tr_prms["SEED"] is None:
        tr_prms["SEED"] = int(np.random.randint(0, int(1e6)))

    # Normalize layer specs to (name, dict) with mutable dicts
    layers = [[name, dict(args)] for name, args in layers]
    return layers, tr_prms, allwts


def save_checkpoint(path: str, net_params: dict):
    """Pickle the {layers, training_params, allwts} dict (neuralnet.py:298-301,
    train.py:195-200). The output is loadable by the reference's
    print_pkl_info.py unmodified."""
    with span("checkpoint.write"), open(path, "wb") as f:
        pickle.dump(net_params, f, -1)


def fixdim(arr):
    """Reshape image data to (N, maps, side, side) (reference train.py:22-34)."""
    if arr.ndim == 2:
        side = int(arr.shape[-1] ** 0.5)
        assert side**2 == arr.shape[-1], "Need a perfect square"
        return arr.reshape((arr.shape[0], 1, side, side))
    if arr.ndim == 3:
        return np.expand_dims(arr, axis=1)
    if arr.ndim == 4:
        return arr
    raise ValueError("Image data arrays must have 2,3 or 4 dimensions only")
