"""Output heads: Softmax, ExpLoss, Hinge and CenteredOut (LOGIT / RBF)
(port of ``theanet_tpu/layers/out.py``; reference
theanet/layer/outlayers.py).

``apply_head`` returns a head-state dict (output, probs, logprob, features,
y_preds, and bitprob for LOGIT) that ``cost`` and ``sym_and_oth_err_rate``
read, as in the JAX package. ``cost`` takes every loss of the JAX package's
dispatch: 'nll', 'nllsq', truncated 'nll<NN>', 'hinge', 'hinge_max' and
'exp'.
"""

from __future__ import annotations

import numpy as np
import torch

from .dense import HiddenLayer

__all__ = ["OutputMixin", "SoftmaxLayer", "ExpLossLayer", "HingeLayer",
           "CenteredOutLayer"]


def _true_class(mat, y):
    return mat[torch.arange(y.shape[0], device=mat.device), y.long()]


class OutputMixin:
    """Loss dispatch and eval statistics over a head-state dict."""

    loss: str = "nll"
    kind: str = "SOFTMAX"

    def cost(self, hs, y):
        """The head's loss (outlayers.py:12-64, theanet_tpu/layers/out.py:
        46-97)."""
        loss = self.loss
        if loss == "nll":
            return -torch.mean(_true_class(hs["logprob"], y))
        if loss == "nllsq":
            # squared log-likelihood, NOT negated (outlayers.py:41-42)
            return torch.mean(_true_class(hs["logprob"], y) ** 2)
        if loss.startswith("nll"):
            # truncated NLL: 'nllNN' clamps the per-sample NLL at
            # -log(NN/100) (outlayers.py:19-27,44-48); an unparseable
            # suffix falls back to plain NLL. The notices print once per
            # head, as the JAX package's do.
            try:
                threshold = float(np.clip(int(loss[-2:]) / 100, 0, 1))
            except ValueError:
                if not getattr(self, "_nll_noticed", False):
                    print("Did not understand {}, using plain NLL".format(
                        loss))
                    print("Using threshold: ", 1.0)
                    self._nll_noticed = True
                return -torch.mean(_true_class(hs["logprob"], y))
            if not getattr(self, "_nll_noticed", False):
                print("Using threshold: ", threshold)
                self._nll_noticed = True
            return torch.mean(torch.clamp(
                np.log(threshold) - _true_class(hs["logprob"], y), min=0.0))
        if loss == "hinge":
            # mean over the whole (batch, classes) matrix, the true class
            # included with its constant 1 (outlayers.py:62-64)
            out = hs["output"]
            return torch.mean(torch.clamp(
                out + 1.0 - _true_class(out, y)[:, None], min=0.0))
        if loss == "hinge_max":
            # per-sample hinge against the best wrong class (the reference's
            # scan variant, outlayers.py:53-60)
            out = hs["output"]
            true = _true_class(out, y)
            is_true = torch.nn.functional.one_hot(y.long(),
                                                  out.shape[1]).bool()
            masked = torch.where(is_true, torch.full_like(out, -np.inf), out)
            return torch.mean(torch.clamp(
                1.0 + masked.amax(dim=1) - true, min=0.0))
        if loss == "exp":
            return torch.mean(torch.exp(-_true_class(hs["output"], y)))
        raise NotImplementedError("Loss : " + str(loss))

    def features_and_predictions(self, hs):
        """(features, y_preds), reference outlayers.py:66-67."""
        return hs["features"], hs["y_preds"]

    def sym_and_oth_err_rate(self, hs, y):
        """(error rate, second statistic), outlayers.py:69-80: the mean
        true-class probability, or for LOGIT heads the share of true-class
        bits below one half."""
        sym_err_rate = torch.mean((hs["y_preds"] != y).to(torch.float32))
        if self.kind == "LOGIT":
            return sym_err_rate, torch.mean(
                (_true_class(hs["bitprob"], y) < 0.5).to(torch.float32))
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
        z = self.linear(wts, x).to(torch.float32)  # head math stays f32
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


class ExpLossLayer(HiddenLayer, OutputMixin):
    """Exponential-loss head (outlayers.py:105-126): the linear output
    centred per row, loss mean(exp(-score_true))."""

    def __init__(self, wts, rand_gen=None, n_in=None, n_out=None, reg=()):
        HiddenLayer.__init__(self, wts, rand_gen, n_in, n_out,
                             actvn="linear", reg=reg, pdrop=0)
        self.kind = "ExpLoss"
        self.loss = "exp"
        self.representation = (
            "ExpLoss In:{:3d} Out:{:3d} Loss:{}"
            "\n\t  L1:{L1} L2:{L2} Momentum:{momentum} Max Norm:{maxnorm} "
            "Rate:{rate}".format(self.n_in, self.n_out, self.loss,
                                 **self.reg))

    def apply_head(self, wts, x, *, train, generator=None):
        raw = self.linear(wts, x).to(torch.float32)
        centered = raw - torch.mean(raw, dim=1, keepdim=True)
        return {
            "output": centered,
            "probs": torch.softmax(centered, dim=-1),
            "logprob": torch.log_softmax(centered, dim=-1),
            "features": centered,
            # the argmax of the raw output is the centred one's
            "y_preds": torch.argmax(raw, dim=1),
        }


class HingeLayer(HiddenLayer, OutputMixin):
    """Multiclass hinge (SVM) head (outlayers.py:129-147). ``probs`` is the
    raw score matrix, so the 'P(MLE)' statistic is the mean true-class
    score, as in the reference."""

    def __init__(self, wts, rand_gen=None, n_in=None, n_out=None, reg=()):
        HiddenLayer.__init__(self, wts, rand_gen, n_in, n_out,
                             actvn="linear", reg=reg, pdrop=0)
        self.kind = "Hinge"
        self.loss = "hinge"
        self.representation = (
            "SVM In:{:3d} Out:{:3d} Loss:{}"
            "\n\t  L1:{L1} L2:{L2} Momentum:{momentum} Max Norm:{maxnorm} "
            "Rate:{rate}".format(self.n_in, self.n_out, self.loss,
                                 **self.reg))

    def apply_head(self, wts, x, *, train, generator=None):
        out = self.linear(wts, x).to(torch.float32)
        return {"output": out, "probs": out, "logprob": out,
                "features": out, "y_preds": torch.argmax(out, dim=1)}


_CENTERED_ACTIVS = {"LOGIT": "sigmoid", "RBF": "scaled_tanh"}


class CenteredOutLayer(HiddenLayer, OutputMixin):
    """Feature layer + class centers (outlayers.py:153-224).

    LOGIT: sigmoid features squeezed into [eps, 1-eps] (eps .001), binary
    centers ~ Binomial(.5), per-bit probability c*v + (1-c)(1-v), log prob
    the sum of bit log-probs. RBF: scaled_tanh features, uniform centers,
    squared distances plus a constant junk_dist column, probs =
    softmax(-dists) over n_classes+1 outputs. ``get_wts`` returns
    [w, b, centers]; only learned centers (RBF) are trained."""

    def __init__(self, wts, centers, rand_gen=None, n_in=None,
                 n_features=None, n_classes=None, kind="LOGIT",
                 learn_centers=False, junk_dist=np.inf, reg=(), loss="nll"):
        assert kind in _CENTERED_ACTIVS
        assert n_in or wts
        assert n_features or wts or centers is not None
        assert n_classes or centers is not None
        assert kind == "RBF" or not learn_centers
        HiddenLayer.__init__(self, wts, rand_gen, n_in, n_out=n_features,
                             actvn=_CENTERED_ACTIVS[kind], pdrop=0, reg=reg)
        n_features = self.n_out
        if centers is None:   # drawn after the weights (outlayers.py)
            if kind == "LOGIT":
                centers = rand_gen.binomial(n=1, p=0.5,
                                            size=(n_classes, n_features))
            else:
                centers = rand_gen.uniform(low=0, high=1,
                                           size=(n_classes, n_features))
        centers = np.asarray(centers, dtype=np.float32)
        self.n_classes = int(centers.shape[0])
        self.learn_centers = learn_centers
        self.centers_init = centers
        if learn_centers:
            self.params_init = [*self.params_init, centers]
        self.kind = kind
        self.junk_dist = junk_dist
        self.loss = loss
        self.representation = (
            "CenteredOut Kind:{} In:{:3d} Hidden:{:3d} Out:{:3d} "
            "learn_centers:{} junk_dist:{}".format(
                kind, self.n_in, n_features, self.n_classes, learn_centers,
                junk_dist))

    def get_wts(self):
        wts = [np.asarray(p) for p in self.params_init]
        return wts if self.learn_centers else wts + [
            np.asarray(self.centers_init)]

    def apply_head(self, wts, x, *, train, generator=None):
        feats = HiddenLayer.apply(self, wts[:2], x, train=train).to(
            torch.float32)  # head math stays f32
        centers = (wts[2].to(torch.float32) if self.learn_centers
                   else torch.as_tensor(self.centers_init,
                                        device=feats.device))
        c = centers[None, :, :]       # (1, nC, nF)
        v = feats[:, None, :]         # (B, 1, nF)
        hs = {"output": feats, "features": feats}
        if self.kind == "LOGIT":
            eps = 0.001
            v = v * (1 - 2 * eps) + eps
            bitprob = c * v + (1 - c) * (1 - v)
            logprob = torch.sum(torch.log(bitprob), dim=2)
            hs.update(bitprob=bitprob, logprob=logprob,
                      probs=torch.exp(logprob),
                      y_preds=torch.argmax(logprob, dim=1))
        else:
            dists = torch.sum((v - c) ** 2, dim=2)           # (B, nC)
            junk = torch.full((dists.shape[0], 1), float(self.junk_dist),
                              dtype=dists.dtype, device=dists.device)
            dists = torch.cat([dists, junk], dim=1)
            probs = torch.softmax(-dists, dim=-1)            # (B, nC+1)
            hs.update(logprob=torch.log_softmax(-dists, dim=-1), probs=probs,
                      y_preds=torch.argmax(probs, dim=1))
        return hs
