"""Auxiliary-input layers: LocationInfo, AuxConcatLayer, SoftAuxLayer (port
of ``theanet_tpu/layers/aux.py``; reference theanet/layer/auxiliary.py).

The auxiliary input is a (batch, 2, 2) tensor. In train mode LocationInfo
mixes its two rows with a random per-sample convex combination, in eval
mode it takes their mean (auxiliary.py:24-31); then it pushes the 2-vector
through a 2-layer MLP (relu50, then relu01). The aux tensor stays f32 under
COMPUTE_DTYPE: a product of it with bf16 weights runs in f32, as JAX's
type promotion does.
"""

from __future__ import annotations

import torch

from ..activations import activation_by_name
from ..inits import consume_stream_seed, init_wb
from .base import Layer
from .dense import HiddenLayer
from .out import OutputMixin

__all__ = ["LocationInfo", "AuxConcatLayer", "SoftAuxLayer"]


def _dot(a, w):
    """a @ w in the wider of the two dtypes (JAX's promotion; torch's
    matmul refuses mixed dtypes)."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


class LocationInfo:
    """Aux-input encoder (auxiliary.py:14-57): convex row mix (train) or
    row mean (eval), times ``boost``, then 2 -> n_aux_hid (relu50) ->
    n_aux_out (relu01)."""

    def __init__(self, wts, rand_gen=None, n_aux=(5, 9), boost=1):
        # draw order (auxiliary.py:24-54): the RandomStreams seed, then the
        # loc1 weights, then the loc2 weights
        self.stream_seed = consume_stream_seed(rand_gen)
        n_aux_hid, n_aux_out = n_aux
        self.n_aux = tuple(n_aux)
        self.boost = boost
        w1, b1 = init_wb(None if wts is None else wts[:2], rand_gen,
                         (2, n_aux_hid), n_aux_hid, n_aux_hid + 2,
                         n_aux_hid + 2, "relu50")
        w2, b2 = init_wb(None if wts is None else wts[2:4], rand_gen,
                         (n_aux_hid, n_aux_out), n_aux_out,
                         n_aux_out + n_aux_hid, n_aux_out + n_aux_hid,
                         "relu01")
        self.params_init = [w1, b1, w2, b2]
        self.n_out = n_aux_out

    def apply(self, wts, aux, *, train, generator=None, u=None):
        """The encoder's (B, n_aux_out) output. In train mode the mix's
        (B, 1) uniforms ``u`` are drawn from ``generator`` unless given
        (the tests feed the JAX package's draw)."""
        w1, b1, w2, b2 = wts
        if train:
            if u is None:
                u = torch.rand((aux.shape[0], 1), generator=generator,
                               device=aux.device, dtype=torch.float32)
            x2 = aux[:, 0, :] * u + aux[:, 1, :] * (1 - u)
        else:
            x2 = torch.mean(aux, dim=1)
        x2 = x2 * self.boost
        hidden = activation_by_name("relu50")(_dot(x2, w1) + b1)
        return activation_by_name("relu01")(_dot(hidden, w2) + b2)


_AUX_TYPES = {"LocationInfo": LocationInfo}


class AuxConcatLayer(Layer):
    """[features || aux-encoder output] (auxiliary.py:63-99). The reference
    gives this layer no ``reg`` dict, so its encoder is frozen at init: no
    update, no momentum, no weight cost (layer.py:70-76,109-117)."""

    def __init__(self, wts, rand_gen, n_in, n_aux, aux_type, boost=1):
        super().__init__()
        self.aux_info = _AUX_TYPES[aux_type](wts, rand_gen, n_aux=n_aux,
                                             boost=boost)
        self.params_init = self.aux_info.params_init
        self.n_aux = tuple(n_aux)
        self.n_in = n_in
        self.n_out = n_aux[-1] + n_in
        self.aux_type = aux_type
        self.boost = boost
        self.takes_aux = True
        self.representation = "AuxConcat In:{:3d} Aux:{} Out:{:3d} ".format(
            n_in, n_aux, self.n_out)

    def apply(self, wts, x, *, train, generator=None, aux=None, u=None):
        x = x.reshape(x.shape[0], -1)
        aux_out = self.aux_info.apply(wts, aux, train=train,
                                      generator=generator, u=u)
        # the concat keeps the features' dtype under COMPUTE_DTYPE
        # (theanet_tpu/layers/aux.py:89-93)
        return torch.cat([x, aux_out.to(x.dtype)], dim=1)


class SoftAuxLayer(HiddenLayer, OutputMixin):
    """Softmax head with additive aux logits, softmax(hidden + cross_b +
    aux_out @ cross_w) (auxiliary.py:102-160). Weights pack as wts[0:2]
    the hidden, wts[2:6] the encoder, wts[6:8] the cross weights."""

    def __init__(self, wts, rand_gen, n_in, n_out, n_aux, aux_type, reg=(),
                 loss="nll", boost=1):
        HiddenLayer.__init__(self, None if wts is None else wts[:2],
                             rand_gen, n_in, n_out, actvn="linear", reg=reg,
                             pdrop=0)
        self.aux_info = _AUX_TYPES[aux_type](
            None if wts is None else wts[2:6], rand_gen, n_aux=n_aux,
            boost=boost)
        n_aux_out = n_aux[1]
        cross_w, cross_b = init_wb(
            None if wts is None else wts[6:8], rand_gen, (n_aux_out, n_out),
            n_out, n_aux_out + n_out, n_aux_out + n_out, "softmax")
        self.params_init = [*self.params_init, *self.aux_info.params_init,
                            cross_w, cross_b]
        self.n_aux = tuple(n_aux)
        self.aux_type = aux_type
        self.boost = boost
        self.loss = loss
        self.kind = "SOFTMAX"
        self.takes_aux = True
        self.representation = (
            "SoftAux In:{:3d} Aux:{} Out:{:3d}"
            "\n\t  L1:{L1} L2:{L2} Momentum:{momentum} Max Norm:{maxnorm} "
            "Rate:{rate}".format(n_in, n_aux, n_out, **self.reg))

    def apply_head(self, wts, x, *, train, generator=None, aux=None, u=None):
        hidden_out = self.linear(wts[0:2], x)
        aux_out = self.aux_info.apply(wts[2:6], aux, train=train,
                                      generator=generator, u=u)
        logits = (hidden_out + wts[7] + _dot(aux_out, wts[6])).to(
            torch.float32)
        probs = torch.softmax(logits, dim=-1)
        logprob = torch.log_softmax(logits, dim=-1)
        return {"output": probs, "probs": probs, "logprob": logprob,
                "features": logprob, "y_preds": torch.argmax(probs, dim=1)}
