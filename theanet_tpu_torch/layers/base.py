"""Layer base class (port of ``theanet_tpu/layers/base.py``).

A layer is build-time metadata (shapes, activation names, regularization,
initial weights as numpy arrays) plus ``apply(wts, x, *, train, generator)``
on tensors. ``train`` selects the train or eval branch (the reference's
TestVersion twin graph, neuralnet.py:93,200); ``generator`` is the
``torch.Generator`` that stochastic layers draw from in train mode.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["Layer", "DEFAULT_REG"]

# reference per-layer regularization defaults (convpool.py:80-84,
# hidden.py:39-43)
DEFAULT_REG = {"L1": 0, "L2": 0, "momentum": 0.95, "rate": 1, "maxnorm": 0}


class Layer:
    """Base layer.

    params_init : list[np.ndarray] — initial/current weights in the
        reference's ``allwts`` order.
    reg : dict or None — per-layer optimizer settings; None means the
        layer's params never update and add no weight cost.
    """

    reg: Optional[dict] = None
    params_init: List[np.ndarray]
    n_out: int
    representation: str = ""

    def __init__(self):
        self.params_init = []

    def apply(self, wts, x, *, train: bool, generator=None):
        raise NotImplementedError

    def get_wts(self):
        return [np.asarray(p) for p in self.params_init]

    def make_reg(self, reg):
        full = dict(DEFAULT_REG)
        full.update(dict(reg) if reg else {})
        return full

    def __str__(self):
        return self.representation
