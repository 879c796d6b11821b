"""Per-layer momentum SGD with L1/L2 weight cost and max-norm projection
(port of ``theanet_tpu/optim.py``; reference theanet/layer/layer.py:70-117).

  * accumulator  a <- m*a + (1-m)*g          (layer.py:82-84)
  * parameter    p <- p - rate*lr*a_OLD      (layer.py:86)

Theano applies its update dict from OLD values, so the parameter step uses
the previous accumulator and the first step moves only the accumulator.
Max-norm per ndim with the reference's 1e-7 guards; layers whose reg is None
or whose rate is 0 are frozen; the weight cost charges every trainable
tensor, biases included. Frozen extras after a layer's trainable tensors
(a CenteredOut head's constant centers) are neither charged nor updated.
Momentum is not checkpointed (resume restarts it at zero), as in the
reference.
"""

from __future__ import annotations

import torch

__all__ = ["init_momentum", "weight_cost", "apply_updates", "learning_rate"]


def _is_active(layer):
    return layer.reg is not None and layer.reg["rate"]


def init_momentum(layers, params):
    """Zero accumulators shaped like params; empty for frozen layers."""
    return [
        [torch.zeros_like(p) for p in lp] if _is_active(lyr) else []
        for lyr, lp in zip(layers, params)
    ]


def weight_cost(layers, params):
    """Sum of per-layer L1/L2 costs (layer.py:109-117)."""
    cost = 0.0
    for lyr, lp in zip(layers, params):
        if lyr.reg is None or not lp:
            continue
        lp = lp[:len(lyr.params_init)]
        l1, l2 = lyr.reg["L1"], lyr.reg["L2"]
        if l1:
            cost = cost + l1 * sum(torch.sum(torch.abs(p)) for p in lp)
        if l2:
            cost = cost + l2 * sum(torch.sum(p * p) for p in lp)
    return cost


def _maxnorm_project(p, maxnorm):
    if p.ndim == 1:
        return torch.clamp(p, -maxnorm, maxnorm)
    if p.ndim == 2:
        norms = torch.sqrt(torch.sum(p * p, dim=0))
        desired = torch.clamp(norms, 0, maxnorm)
        return p * ((1e-7 + desired) / (1e-7 + norms))
    if p.ndim == 4:
        norms = torch.sqrt(torch.sum(p * p, dim=(1, 2, 3)))
        desired = torch.clamp(norms, 0, maxnorm)
        return p * ((1e-7 + desired) / (1e-7 + norms))[:, None, None, None]
    return p


def apply_updates(layers, params, moms, grads, lr):
    """One SGD step. Returns new (params, moms) lists; inputs are unchanged."""
    new_params, new_moms = [], []
    for lyr, lp, lm, lg in zip(layers, params, moms, grads):
        if not _is_active(lyr) or not lp:
            new_params.append(list(lp))
            new_moms.append(list(lm))
            continue
        m, rate, maxnorm = (lyr.reg["momentum"], lyr.reg["rate"],
                            lyr.reg["maxnorm"])
        n_train = len(lyr.params_init)
        ps, as_ = [], []
        for p, a, g in zip(lp[:n_train], lm, lg):
            a_new = m * a + (1.0 - m) * g
            p_new = p - rate * lr * a  # OLD accumulator: see module docstring
            if maxnorm:
                p_new = _maxnorm_project(p_new, maxnorm)
            ps.append(p_new)
            as_.append(a_new)
        new_params.append(ps + list(lp[n_train:]))
        new_moms.append(as_ + list(lm[n_train:]))
    return new_params, new_moms


def learning_rate(training_params):
    """INIT / (1 + CUR_EPOCH / EPOCHS_TO_HALF_RATE) (neuralnet.py:303-307)."""
    return training_params["INIT_LEARNING_RATE"] / (
        1 + training_params["CUR_EPOCH"]
        / training_params["EPOCHS_TO_HALF_RATE"]
    )
