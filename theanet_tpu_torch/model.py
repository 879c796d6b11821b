"""NeuralNet: dict spec -> layer stack -> train/eval functions on tensors.

Port of ``theanet_tpu/model.py`` (reference theanet/neuralnet.py:59-333).
The spec format and the builder's plumbing rules are the same: num_maps /
out_sz propagate past DropOut layers, dense layers flatten their input, the
first layer's img_sz arrives at run time. Parameters are lists of per-layer
tensor lists in the reference ``allwts`` order and layout, so a checkpoint
of either package loads in the other (``params_from_allwts``).
"""

from __future__ import annotations

from functools import reduce
from operator import mul
from typing import List

import numpy as np
import torch

from . import layers as layer_mod
from .layers import (AuxConcatLayer, CenteredOutLayer, ColorLayer,
                     ConvLayer, DropOutLayer, ElasticLayer, ExpLossLayer,
                     HiddenLayer, HingeLayer, InputLayer, MeanLayer,
                     OutputMixin, PoolLayer, SoftAuxLayer, SoftmaxLayer)
from .optim import apply_updates, init_momentum, learning_rate, weight_cost
from .tracing import span

__all__ = ["NeuralNet", "get_layers_info", "get_wts_info",
           "get_training_params_info", "params_from_allwts"]


def get_layers_info(layers):
    """Spec pretty-printer, line for line the reference's (neuralnet.py:
    20-27)."""
    lines = []
    for name, kwargs in layers:
        lines.append(f"\n{name} : ")
        lines.extend(f"\n\t{key} : \t{val}" for key, val in kwargs.items())
    return "".join(lines)


def _wt_lines(layer_idx, ww, detailed):
    yield f"\nLayer {layer_idx}:"
    for w in ww:
        n_ww = reduce(mul, w.shape, 1)
        line = f"\n\t {w.shape} {w.dtype} ❲{n_ww}❳"
        if detailed:
            line += f" ❲{w.min():.2e}, {w.mean():.2e}, {w.max():.2e}❳"
        yield line


def get_wts_info(wts, detailed=False):
    """Weight-table pretty-printer (neuralnet.py:30-43)."""
    n_wts = sum(reduce(mul, w.shape, 1) for ww in wts for w in ww)
    body = "".join(line for l, ww in enumerate(wts)
                   for line in _wt_lines(l, ww, detailed))
    return body + f"\n\nTotal Number of Weights : {n_wts:,}"


def get_training_params_info(training_params):
    """Sorted key/value dump (neuralnet.py:46-51)."""
    lines = [f"\n\t{key} : \t{training_params[key]}"
             for key in sorted(training_params)]
    return "Training Parameters:" + "".join(lines)


def params_from_allwts(allwts, device):
    """Reference-layout numpy weights (either package's ``allwts``, e.g. the
    JAX NeuralNet's) -> the port's parameter lists of f32 tensors on
    ``device``. The layouts are the same, so this is a copy."""
    return [[torch.as_tensor(np.asarray(w, np.float32), device=device)
             for w in lw] for lw in allwts]


_INPUT_TYPES = (InputLayer, ElasticLayer, ColorLayer)
_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_DENSE_TYPES = (AuxConcatLayer, HiddenLayer, SoftmaxLayer, SoftAuxLayer,
                HingeLayer, ExpLossLayer)


class NeuralNet:
    """Builds the layer stack from the spec (reference neuralnet.py:59-111).

    With ``allwts=None`` a numpy RandomState(SEED) draws the initial
    weights in the reference's order (bit-identical to the JAX package);
    with ``allwts`` the weights are restored and nothing is drawn."""

    def __init__(self, layers, training_params, allwts=None):
        self.rand_gen = (np.random.RandomState(training_params["SEED"])
                         if allwts is None else None)
        self.tr_prms = training_params
        self.layers = layers
        self.batch_sz = training_params["BATCH_SZ"]
        self.net_layers: List[layer_mod.Layer] = []

        input_layer_type = getattr(layer_mod, layers[0][0], None)
        if input_layer_type not in _INPUT_TYPES:
            raise NotImplementedError(
                "first layer {!r}: the first layer must be an InputLayer, "
                "ElasticLayer or ColorLayer".format(layers[0][0]))
        self.net_layers.append(
            input_layer_type(rand_gen=self.rand_gen, **layers[0][1]))
        for i in range(1, len(layers)):
            self._append_layer(i, allwts[i] if allwts else None)
        # the one layer that reads the aux input (neuralnet.py:100-105)
        self.aux_layer_idx = None
        for i, lyr in enumerate(self.net_layers):
            if isinstance(lyr, (AuxConcatLayer, SoftAuxLayer)):
                if self.aux_layer_idx is not None:
                    raise ValueError("Multiple Aux Inputs")
                self.aux_layer_idx = i

        head = self.net_layers[-1]
        assert isinstance(head, OutputMixin), "Last layer must be an output head"
        self.head = head
        if "CUR_EPOCH" not in training_params:
            training_params["CUR_EPOCH"] = 0
        if training_params.get("REMAT"):
            raise NotImplementedError(
                "training_params REMAT is not ported yet (ROADMAP.md queue 1)")
        # COMPUTE_DTYPE (model.py:162-167): 'bfloat16' runs the network body
        # in bf16 with f32 masters, momenta, updates and head math
        cd = training_params.get("COMPUTE_DTYPE")
        if cd and cd not in _COMPUTE_DTYPES:
            raise NotImplementedError(
                f"COMPUTE_DTYPE {cd!r}: the port takes "
                f"{sorted(_COMPUTE_DTYPES)}")
        self.compute_dtype = _COMPUTE_DTYPES[cd] if cd else None
        self.fused_tail, self._fused_slope = False, 0.0
        # the tail runs only in f32 (model.py:182-184)
        if (training_params.get("FUSED_TAIL")
                and self.compute_dtype in (None, torch.float32)):
            self._gate_fused_tail()
        self.allwts0 = [lyr.get_wts() for lyr in self.net_layers]

    def _gate_fused_tail(self):
        """FUSED_TAIL (model.py:173-197): the last HiddenLayer and the
        Softmax head run as one ``ops.fused_mlp`` function when the hidden
        activation is in the leaky-relu family (relu -> slope 0, linear ->
        1, reluNN -> NN/100); silently off when the pattern differs or the
        compute dtype is not f32. The port raises on REMAT, the gate's other
        condition."""
        hid = self.net_layers[-2] if len(self.net_layers) >= 2 else None
        if not (type(hid) is HiddenLayer and type(self.head) is SoftmaxLayer):
            return
        a = hid.actvn
        if a == "relu":
            slope = 0.0
        elif a == "linear":
            slope = 1.0
        elif a.startswith("relu") and a[4:].isdigit():
            slope = int(a[4:]) / 100.0
        else:
            return
        self.fused_tail, self._fused_slope = True, slope

    def _append_layer(self, i, wts):
        """The layer-construction ladder of theanet_tpu/model.py:216-286."""
        layer_type, layer_args = self.layers[i]
        layer_args = dict(layer_args)
        prev = self.net_layers[i - 1]
        cls = getattr(layer_mod, layer_type, None)

        if cls in (ElasticLayer, ColorLayer, ConvLayer, PoolLayer,
                   MeanLayer):
            # DropOut has no num_maps: shape info comes from the layer
            # before it (neuralnet.py:123-130)
            use = (self.net_layers[i - 2] if isinstance(prev, DropOutLayer)
                   else prev)
            num_prev_maps, prev_out_sz = use.num_maps, use.out_sz

        if cls in (ElasticLayer, ColorLayer):
            layer_args.pop("num_maps", None)
            layer_args.pop("img_sz", None)
            # the reference del-mutates the stored spec (neuralnet.py:133-136)
            self.layers[i][1].pop("num_maps", None)
            self.layers[i][1].pop("img_sz", None)
            curr = cls(num_maps=num_prev_maps, img_sz=prev_out_sz,
                       rand_gen=self.rand_gen, **layer_args)
        elif cls is ConvLayer:
            curr = ConvLayer(wts, self.rand_gen, self.batch_sz,
                             num_prev_maps, prev_out_sz, **layer_args)
        elif cls in (PoolLayer, MeanLayer):
            curr = cls(num_maps=num_prev_maps, in_sz=prev_out_sz,
                       **layer_args)
        elif cls is DropOutLayer:
            curr = DropOutLayer(self.rand_gen, prev.n_out, **layer_args)
        elif cls in _DENSE_TYPES:
            curr = cls(wts, self.rand_gen, prev.n_out, **layer_args)
        elif cls is CenteredOutLayer:
            # centers travel with the weights: [w, b, centers], or the
            # reference's unpack index 3 (neuralnet.py:184-187)
            centers = None
            if wts:
                if len(wts) < 3:
                    raise ValueError(
                        "CenteredOutLayer checkpoint entry has no centers "
                        "(got {} tensors, need [w, b, centers])".format(
                            len(wts)))
                centers = wts[3] if len(wts) >= 4 else wts[2]
                wts = wts[:2]
            curr = CenteredOutLayer(wts, centers, self.rand_gen, prev.n_out,
                                    **layer_args)
        else:
            raise NotImplementedError(f"Unknown Layer Type {layer_type!r}")
        self.net_layers.append(curr)

    # -- compute --------------------------------------------------------------

    def _cast_compute(self, params, x):
        """Params and inputs in the compute dtype (model.py:290-299), for
        forward and predict alike, so both run the same network body."""
        if self.compute_dtype is None:
            return params, x
        cd = self.compute_dtype
        return [[p.to(cd) for p in lp] for lp in params], x.to(cd)

    def _fused_tail_head(self, params, out, train, generator):
        """The dense tail (last hidden + Softmax head) as one
        ``fused_hidden_softmax`` call (model.py:301-323); returns the
        SoftmaxLayer's head-state dict. In train mode with dropout the
        (B, n_hid) dropout words are drawn from ``generator`` here."""
        from .ops.fused_mlp import FusedTailSpec, fused_hidden_softmax

        hid = self.net_layers[-2]
        (w1, b1), (w2, b2) = params[-2], params[-1]
        spec = FusedTailSpec(slope=self._fused_slope,
                             pdrop=float(hid.pdrop), train=train)
        x2 = out.reshape(out.shape[0], -1)
        words = None
        if train and spec.pdrop:
            words = torch.randint(-2**31, 2**31, (x2.shape[0], hid.n_out),
                                  dtype=torch.int32, generator=generator,
                                  device=x2.device)
        logprob = fused_hidden_softmax(x2, w1, b1, w2, b2, words, spec)
        probs = torch.exp(logprob)
        return {"output": probs, "probs": probs, "logprob": logprob,
                "features": logprob, "y_preds": torch.argmax(logprob, dim=1)}

    def takes_aux(self):
        """Whether a layer reads the (batch, 2, 2) aux input."""
        return self.aux_layer_idx is not None

    def _aux_kw(self, i, aux):
        return {"aux": aux} if i == self.aux_layer_idx else {}

    def forward(self, params, x, *, train, generator=None, aux=None):
        """Run the stack; returns the head-state dict. Layers draw from
        ``generator`` in layer order (model.py:325-349); the aux layer
        reads ``aux``."""
        params, out = self._cast_compute(params, x)
        n_body = len(self.net_layers) - (2 if self.fused_tail else 0)
        for i, lyr in enumerate(self.net_layers):
            if i == n_body:
                return self._fused_tail_head(params, out, train, generator)
            if lyr is self.head:
                return lyr.apply_head(params[i], out, train=train,
                                      generator=generator,
                                      **self._aux_kw(i, aux))
            out = lyr.apply(params[i], out, train=train, generator=generator,
                            **self._aux_kw(i, aux))
        raise AssertionError("unreachable: head not applied")

    def cost(self, params, x, y, *, generator=None, aux=None):
        """Head loss + every layer's weight cost (neuralnet.py:208-210)."""
        hs = self.forward(params, x, train=True, generator=generator,
                          aux=aux)
        return self.head.cost(hs, y) + weight_cost(self.net_layers,
                                                   params), hs

    def train_step(self, params, moms, x, y, *, lr, generator=None,
                   aux=None):
        """One SGD step by autograd. Returns (params, moms, cost, features,
        logprob), the reference training fn's observables (neuralnet.py:
        236-241). The input lists are not modified."""
        leaves = [[p.detach().requires_grad_(True) for p in lp]
                  for lp in params]
        cost, hs = self.cost(leaves, x, y, generator=generator, aux=aux)
        flat = [p for lp in leaves for p in lp]
        grads_flat = torch.autograd.grad(cost, flat, allow_unused=True)
        it = iter(grads_flat)
        grads = [[next(it) for _ in lp] for lp in leaves]
        grads = [[torch.zeros_like(p) if g is None else g
                  for p, g in zip(lp, lg)] for lp, lg in zip(params, grads)]
        with torch.no_grad():
            new_p, new_m = apply_updates(self.net_layers, params, moms,
                                         grads, lr)
        return (new_p, new_m, cost.detach(), hs["features"].detach(),
                hs["logprob"].detach())

    @torch.no_grad()
    def eval_step(self, params, x, y, *, aux=None, preds_feats=False):
        """(error rate, second statistic) of the head (outlayers.py:69-80),
        with (features, y_preds) appended under ``preds_feats``."""
        hs = self.forward(params, x, train=False, aux=aux)
        stats = self.head.sym_and_oth_err_rate(hs, y)
        if preds_feats:
            return stats + self.head.features_and_predictions(hs)
        return stats

    @torch.no_grad()
    def predict(self, params, x, *, aux=None, get_output_of_layers=()):
        """(features, y_preds, *layer outputs) on raw inputs (reference
        get_data_test_model, neuralnet.py:282-296). Without layer outputs it
        runs the eval forward, FUSED_TAIL included, as eval_step does
        (model.py:385-395)."""
        if not get_output_of_layers:
            hs = self.forward(params, x, train=False, aux=aux)
            return hs["features"], hs["y_preds"]
        params, out = self._cast_compute(params, x)
        outs, hs = [], None
        for i, lyr in enumerate(self.net_layers):
            if lyr is self.head:
                hs = lyr.apply_head(params[i], out, train=False,
                                    **self._aux_kw(i, aux))
                out = hs["output"]
            else:
                out = lyr.apply(params[i], out, train=False,
                                **self._aux_kw(i, aux))
            outs.append(out)
        return tuple([hs["features"], hs["y_preds"]]
                     + [outs[i] for i in get_output_of_layers])

    # -- state and schedule -------------------------------------------------

    def init_params(self, device):
        """Fresh (params, momentum) lists on ``device``."""
        params = params_from_allwts(self.allwts0, device)
        return params, init_momentum(self.net_layers, params)

    def get_init_params(self):
        """The checkpoint dict, in the reference's structure
        (neuralnet.py:298-301)."""
        return {
            "layers": self.layers,
            "training_params": self.tr_prms,
            "allwts": [lyr.get_wts() for lyr in self.net_layers],
        }

    def snapshot_params(self, params):
        """Copy current params (tensors) back into the layers as numpy, so
        get_wts() and get_init_params() reflect training progress. Only the
        trainable tensors write back: a frozen-centers CenteredOut entry
        carries its constant centers after them (as get_wts does). Returns
        the number of tensors copied."""
        n = 0
        with span("net.snapshot_params"):
            for lyr, lp in zip(self.net_layers, params):
                lyr.params_init = [p.detach().cpu().numpy().copy()
                                   for p in lp[:len(lyr.params_init)]]
                n += len(lyr.params_init)
        return n

    def get_rate(self):
        return learning_rate(self.tr_prms)

    def inc_epoch_set_rate(self):
        self.tr_prms["CUR_EPOCH"] += 1

    def get_epoch(self):
        return self.tr_prms["CUR_EPOCH"]

    def __str__(self):
        return "\nLayers\n\t" + "\n\t".join(str(l) for l in self.net_layers)

    def get_wts_info(self, detailed=False):
        return get_wts_info([l.get_wts() for l in self.net_layers], detailed)
