"""Output heads: SoftmaxLayer (port of ``theanet_tpu/layers/out.py``;
reference theanet/layer/outlayers.py).

``apply_head`` returns a head-state dict (output, probs, logprob, features,
y_preds) that ``cost`` and ``sym_and_oth_err_rate`` read, as in the JAX
package. This slice ports the Softmax head with the 'nll' loss; the other
heads and losses are queued in ROADMAP.md.
"""

from __future__ import annotations

import torch

from .dense import HiddenLayer

__all__ = ["OutputMixin", "SoftmaxLayer"]


def _true_class(mat, y):
    return mat[torch.arange(y.shape[0], device=mat.device), y.long()]


class OutputMixin:
    """Loss dispatch and eval statistics over a head-state dict."""

    loss: str = "nll"
    kind: str = "SOFTMAX"

    def cost(self, hs, y):
        if self.loss == "nll":
            return -torch.mean(_true_class(hs["logprob"], y))
        raise NotImplementedError(
            "loss {!r} is not ported yet (ROADMAP.md queue 1, heads and "
            "losses)".format(self.loss))

    def features_and_predictions(self, hs):
        """(features, y_preds), reference outlayers.py:66-67."""
        return hs["features"], hs["y_preds"]

    def sym_and_oth_err_rate(self, hs, y):
        """(error rate, mean true-class probability), outlayers.py:69-80."""
        sym_err_rate = torch.mean((hs["y_preds"] != y).to(torch.float32))
        return sym_err_rate, torch.mean(_true_class(hs["probs"], y))


class SoftmaxLayer(HiddenLayer, OutputMixin):
    """Softmax head (outlayers.py:83-102), loss 'nll' as log-softmax (what
    Theano's stabilisation rewrites log(softmax) into)."""

    def __init__(self, wts, rand_gen=None, n_in=None, n_out=None, reg=(),
                 loss="nll"):
        HiddenLayer.__init__(self, wts, rand_gen, n_in, n_out,
                             actvn="Softmax", reg=reg, pdrop=0)
        self.kind = "SOFTMAX"
        self.loss = loss
        self.representation = (
            "Softmax In:{:3d} Out:{:3d} Loss:{}"
            "\n\t  L1:{L1} L2:{L2} Momentum:{momentum} Max Norm:{maxnorm} "
            "Rate:{rate}".format(self.n_in, self.n_out, loss, **self.reg))

    def apply_head(self, wts, x, *, train, generator=None):
        z = self.linear(wts, x)
        probs = torch.softmax(z, dim=-1)
        logprob = torch.log_softmax(z, dim=-1)
        return {
            "output": probs,
            "probs": probs,
            "logprob": logprob,
            "features": logprob,
            "y_preds": torch.argmax(probs, dim=1),
        }

    def apply(self, wts, x, *, train, generator=None):
        return self.apply_head(wts, x, train=train)["output"]
