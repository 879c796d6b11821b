"""Dense and dropout layers: HiddenLayer, DropOutLayer (port of
``theanet_tpu/layers/dense.py``; reference hidden.py, dropout.py).

Dropout is SCALE-AT-TEST: training multiplies by a Bernoulli(1-p) mask and
evaluation multiplies by (1-p) (dropout.py:28-31). ``F.dropout`` is inverted
dropout and would change both the trajectory and the checkpoints' meaning.
"""

from __future__ import annotations

import torch

from ..activations import activation_by_name
from ..inits import consume_stream_seed, init_wb
from .base import Layer

__all__ = ["HiddenLayer", "DropOutLayer", "drop_output"]


def drop_output(output, pdrop, generator):
    """Bernoulli(1-p) mask multiply (reference dropout.py:9-13). The
    uniforms are f32 whatever the compute dtype, so a step keeps the same
    units in f32 and in bf16."""
    u = torch.rand(output.shape, generator=generator, device=output.device,
                   dtype=torch.float32)
    return output * (u >= pdrop).to(output.dtype)


class HiddenLayer(Layer):
    """Dense layer act(x W + b) with optional dropout (hidden.py:11-55).
    The input is flattened to (batch, -1)."""

    def __init__(self, wts, rand_gen=None, n_in=None, n_out=None, pdrop=0,
                 actvn="relu01", reg=()):
        super().__init__()
        assert wts is not None or rand_gen is not None
        fan_in_out = None if (n_in is None or n_out is None) else n_in + n_out
        w, b = init_wb(wts, rand_gen, (n_in, n_out), (n_out,), fan_in_out,
                       fan_in_out, actvn)
        self.params_init = [w, b]
        self.n_in, self.n_out = int(w.shape[0]), int(w.shape[1])
        self.actvn = actvn
        self.pdrop = pdrop
        # drop_output seeds its RandomStreams from the shared numpy stream
        # (dropout.py:10-11): consume the same draw for init parity
        self.stream_seed = consume_stream_seed(rand_gen) if pdrop else 0
        self.reg = self.make_reg(reg)
        self.representation = (
            "Hidden In:{:3d} Out:{:3d} Act:{} Drop%:{}"
            "\n\t  L1:{L1} L2:{L2} Momentum:{momentum} Max Norm:{maxnorm} "
            "Rate:{rate}".format(self.n_in, self.n_out, actvn, pdrop,
                                 **self.reg))

    def linear(self, wts, x):
        w, b = wts
        return x.reshape(x.shape[0], -1) @ w + b

    def apply(self, wts, x, *, train, generator=None):
        out = activation_by_name(self.actvn)(self.linear(wts, x))
        if self.pdrop:
            if train:
                out = drop_output(out, self.pdrop, generator)
            else:
                out = out * (1.0 - self.pdrop)
        return out


class DropOutLayer(Layer):
    """Standalone dropout (dropout.py:15-31). No params and no num_maps, so
    the net builder skips it when propagating conv shapes."""

    def __init__(self, rand_gen=None, n_in=None, pdrop=0):
        super().__init__()
        self.pdrop = pdrop
        self.n_in = self.n_out = n_in
        self.stream_seed = consume_stream_seed(rand_gen) if pdrop else 0
        self.representation = "Drop:{:.0%} Out:{:3d}".format(pdrop, n_in)

    def apply(self, wts, x, *, train, generator=None):
        if not self.pdrop:
            return x
        if train:
            return drop_output(x, self.pdrop, generator)
        return x * (1.0 - self.pdrop)
