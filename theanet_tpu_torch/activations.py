"""Activation registry: string -> callable on tensors.

Port of ``theanet_tpu/activations.py`` (reference theanet/layer/layer.py:
11-54): sigmoid, softplus, softmax, linear, scaled_tanh (1.7*tanh(2x/3)),
relu, tanh, and the hundred leaky relus ``relu00`` .. ``relu99`` whose
negative slope is i/100.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["activation_by_name", "ACTIVATIONS"]


def _leaky_relu(slope: float):
    # The JAX package's python-float slope takes x's dtype (weak typing), so
    # under bf16 it multiplies by the slope rounded to bf16: do the same.
    slopes = {torch.bfloat16: float(torch.tensor(slope).to(torch.bfloat16))}

    def fn(x):
        return (torch.clamp(x, min=0.0)
                + torch.clamp(x, max=0.0) * slopes.get(x.dtype, slope))

    fn.__name__ = f"relu{int(round(slope * 100)):02d}"
    return fn


def _scaled_tanh(x):
    return 1.7 * torch.tanh(2.0 * x / 3.0)


def _softmax(x):
    # row-wise over the trailing axis, like the reference's (batch, classes)
    return torch.softmax(x, dim=-1)


ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "softmax": _softmax,
    "Softmax": _softmax,
    "linear": lambda x: x,
    "scaled_tanh": _scaled_tanh,
    "relu": lambda x: torch.clamp(x, min=0.0),
    "tanh": torch.tanh,
}
for _i in range(100):
    ACTIVATIONS[f"relu{_i:02d}"] = _leaky_relu(_i / 100.0)


def activation_by_name(name: str):
    """Resolve an activation by name; NotImplementedError for unknown names
    (the reference's contract, theanet/layer/layer.py:41-54)."""
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise NotImplementedError("Unknown Activation Specified: " + name)
