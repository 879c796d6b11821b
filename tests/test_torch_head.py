"""The fused heads' plain twins against the JAX package's heads.

The CUDA heads (``k_head_*`` in csrc/megastep.cu, ``k_head_loss`` and
``k_head_reduce`` in csrc/megastep_deep.cu) run only on a card, where
chip_smoke.py holds them to the twins below. Here, on the CPU:

  * the twins' head functions (``megastep.softmax_nll``,
    ``megastep.centered_nll``, ``megastep_deep.head_loss`` for nll, nllsq,
    nll90, hinge and exp) against the JAX package's per-layer heads
    (SoftmaxLayer, HingeLayer, ExpLossLayer, CenteredOutLayer LOGIT and
    RBF) on the same numpy scores: each head gets an identity linear map,
    so its scores are the given ones, and ``jax.grad`` of its cost gives
    dL/dscores (and dL/dcenters). At mnist_cnn's 10 classes and at wide
    heads (457, 1453 and 1500 classes, batches 4 to 20, at most 64
    features), each output within 1e-5 of the larger of 1 and its largest
    value, the bound of the twin tests;
  * the fused Trainers of both packages (the port's twin, the JAX fused
    kernel in interpret mode) at wide heads in all three families: epoch
    costs within 2e-5 and final weights within 1e-4, the bounds of
    tests/test_torch_tiled.py;
  * the edge cases: a dropped hidden unit whose pre-activation is inf
    gives a NaN cost in both packages (0 * inf); a label outside [0, NC)
    is refused by the port's Trainer and twins (the CUDA kernels give a NaN
    cost, held on the card by chip_smoke.py phases 2 and 6), where the JAX
    package's fused kernel counts it with a zero one-hot row;
  * the route: phase 23's five configurations and every params/*.prms
    take the same fused family as before the head redesign, with no
    decline reason.
"""

import math
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from theanet_tpu.layers import (CenteredOutLayer, ExpLossLayer, HingeLayer,
                                SoftmaxLayer)
from theanet_tpu.model import NeuralNet as JaxNet
from theanet_tpu.trainer import Trainer as JaxTrainer

import chip_smoke
from theanet_tpu_torch.data import load_dataset
from theanet_tpu_torch.model import NeuralNet as TorchNet
from theanet_tpu_torch.ops import megastep
from theanet_tpu_torch.ops import megastep_deep as deep
from theanet_tpu_torch.prms import fixdim, load_params
from theanet_tpu_torch.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
# (batch, classes): mnist_cnn's head and the wide heads of phase 23
SOFTMAX_SHAPES = [(20, 10), (16, 457), (20, 1453), (4, 1500)]


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


def _scores(batch, n, seed, scale=3.0):
    rng = np.random.RandomState(seed)
    z = (scale * rng.randn(batch, n)).astype(np.float32)
    y = rng.randint(0, n, batch).astype(np.int32)
    return z, y


def _identity(layer_cls, n, **kw):
    """A JAX per-layer head whose linear map is the identity: its scores
    are its input."""
    wts = [np.eye(n, dtype=np.float32), np.zeros(n, np.float32)]
    return layer_cls(wts, **kw)


def _jax_head(head, z, y, extra=()):
    """(cost, dL/dz, dL/d extra, head state) of a JAX per-layer head at
    scores ``z``."""
    wts = [jnp.eye(z.shape[1], dtype=jnp.float32),
           jnp.zeros(z.shape[1], jnp.float32)]

    def cost(zz, *ex):
        hs = head.apply_head(wts + list(ex), zz, key=None, train=True)
        return head.cost(hs, jnp.asarray(y))

    args = (jnp.asarray(z),) + tuple(jnp.asarray(e) for e in extra)
    c, grads = jax.value_and_grad(cost, argnums=tuple(range(len(args))))(
        *args)
    hs = head.apply_head(wts + [jnp.asarray(e) for e in extra],
                         jnp.asarray(z), key=None, train=True)
    return float(c), np.asarray(grads[0]), [np.asarray(g) for g in
                                            grads[1:]], hs


def _true(mat, y):
    return np.asarray(mat)[np.arange(len(y)), y]


# ------------------------------------------------------- softmax heads

@pytest.mark.parametrize("batch,nc", SOFTMAX_SHAPES)
def test_flagship_softmax_nll_matches_jax_head(batch, nc):
    """megastep.softmax_nll (the flagship twin's head) against the JAX
    SoftmaxLayer: mean NLL, the smallest true-class log-prob, dL/dz4."""
    z, y = _scores(batch, nc, seed=nc)
    cost, minf, dz4 = megastep.softmax_nll(torch.tensor(z),
                                           torch.tensor(y), batch)
    jc, jdz, _, hs = _jax_head(_identity(SoftmaxLayer, nc), z, y)
    _close(float(cost), jc)
    _close(float(minf), _true(hs["logprob"], y).min())
    _close(dz4.numpy(), jdz)


LOSSES = {   # the deep twin's loss tag: (JAX head class, its loss, thresh)
    "nll": (SoftmaxLayer, "nll", 0.0),
    "nllsq": (SoftmaxLayer, "nllsq", 0.0),
    "nllT": (SoftmaxLayer, "nll90", math.log(0.9)),
    "hinge": (HingeLayer, None, 0.0),
    "exp": (ExpLossLayer, None, 0.0),
}


@pytest.mark.parametrize("batch,nc", [(20, 10), (16, 457), (4, 1500)])
@pytest.mark.parametrize("loss", sorted(LOSSES))
def test_deep_head_loss_matches_jax_head(loss, batch, nc):
    """megastep_deep.head_loss (the deep and flat twins' softmax-kind
    heads) against the JAX head of the same loss: the cost, the watchdog
    value (the true-class log-prob, or the raw or row-centred true-class
    score for hinge and exp) and dL/dz4."""
    cls, jloss, thresh = LOSSES[loss]
    z, y = _scores(batch, nc, seed=7 * nc + len(loss))
    spec = types.SimpleNamespace(loss=loss, log_thresh=thresh)
    cost, minf, dz4 = deep.head_loss(spec, torch.tensor(z), torch.tensor(y),
                                     batch)
    head = _identity(cls, nc, **({"loss": jloss} if jloss else {}))
    jc, jdz, _, hs = _jax_head(head, z, y)
    want_minf = _true(hs["output"] if loss in ("hinge", "exp")
                      else hs["logprob"], y).min()
    _close(float(cost), jc)
    _close(float(minf), want_minf)
    _close(dz4.numpy(), jdz)


# ------------------------------------------------------ centered heads

CENTERED = [   # kind, learn centers, batch, features, classes
    ("LOGIT", False, 20, 24, 10), ("LOGIT", False, 8, 64, 1453),
    ("RBF", True, 20, 32, 10), ("RBF", False, 8, 32, 457),
    ("RBF", True, 4, 64, 1500),
]


@pytest.mark.parametrize("kind,learn,batch,nf,nc", CENTERED)
def test_centered_nll_matches_jax_head(kind, learn, batch, nf, nc):
    """megastep.centered_nll (LOGIT, and RBF by the expansion ||v||^2 -
    2 v.c + ||c||^2 with the junk column) against the JAX CenteredOutLayer
    (RBF by the squared difference): the cost, the watchdog feature,
    dL/dz4 and, for learned centers, dL/dcenters."""
    rng = np.random.RandomState(nc + nf)
    z = (1.5 * rng.randn(batch, nf)).astype(np.float32)
    y = rng.randint(0, nc, batch).astype(np.int32)
    if kind == "LOGIT":
        centers = rng.binomial(1, 0.5, (nc, nf)).astype(np.float32)
    else:
        centers = rng.uniform(0, 1, (nc, nf)).astype(np.float32)
    junk = 40.0
    spec = types.SimpleNamespace(head=kind.lower(), n_classes=nc,
                                 junk_dist=junk, learn_centers=learn)
    cost, minf, dz4, dcen = megastep.centered_nll(
        spec, torch.tensor(z), torch.tensor(y), torch.tensor(centers))
    wts = [np.eye(nf, dtype=np.float32), np.zeros(nf, np.float32)]
    head = CenteredOutLayer(wts, centers, kind=kind, learn_centers=learn,
                            junk_dist=junk)
    jc, jdz, jextra, hs = _jax_head(head, z, y,
                                    extra=(centers,) if learn else ())
    feats = np.asarray(hs["features"])
    _close(float(cost), jc)
    _close(float(minf), _true(feats, np.minimum(y, nf - 1)).min())
    _close(dz4.numpy(), jdz)
    if learn:
        _close(dcen.numpy(), jextra[0])
    else:
        assert dcen is None


# ------------------------------------------- fused trainers, wide heads

def _mnist(n_out, img=12):
    return [["InputLayer", {"img_sz": img}],
            ["ConvLayer", {"num_maps": 2, "filter_sz": 3, "stride": 1,
                           "actvn": "relu05"}],
            ["PoolLayer", {"pool_sz": 2}],
            ["ConvLayer", {"num_maps": 3, "filter_sz": 3, "stride": 1,
                           "actvn": "relu10"}],
            ["PoolLayer", {"pool_sz": 2}],
            ["HiddenLayer", {"n_out": 16, "pdrop": 0.5,
                             "reg": {"L2": 1e-3, "maxnorm": 0.9}}],
            ["SoftmaxLayer", {"n_out": n_out}]]


def _flat(n_out, img=8):
    return [["InputLayer", {"img_sz": img}],
            ["HiddenLayer", {"n_out": 24, "pdrop": 0.5}],
            ["SoftmaxLayer", {"n_out": n_out}]]


def _three_level(n_out, img=17):
    conv = lambda m, f: ["ConvLayer", {"num_maps": m, "filter_sz": f,
                                       "stride": 1, "actvn": "relu05"}]
    return [["InputLayer", {"img_sz": img}], conv(2, 3),
            ["PoolLayer", {"pool_sz": 2}], conv(3, 3),
            ["PoolLayer", {"pool_sz": 2}], conv(3, 2),
            ["HiddenLayer", {"n_out": 12, "pdrop": 0.5}],
            ["SoftmaxLayer", {"n_out": n_out}]]


def _tr(batch, **kw):
    return {"SEED": 5, "BATCH_SZ": batch, "NUM_EPOCHS": 2,
            "EPOCHS_TO_TEST": 1, "TEST_SAMP_SZ": batch,
            "INIT_LEARNING_RATE": 0.1, "EPOCHS_TO_HALF_RATE": 2,
            "MEGAFUSED": True, **kw}


WIDE_TRAINERS = {   # layers, batch, steps, the port's epoch function
    "flagship-b4-457": (_mnist(457), 4, 2, "megastep_epoch"),
    "flagship-b20-1453": (_mnist(1453), 20, 1, "megastep_epoch"),
    "flat-b8-457": (_flat(457), 8, 2, "mlp_epoch"),
    "three-level-b4-1500": (_three_level(1500), 4, 2, "deep_epoch"),
}


@pytest.mark.parametrize("name", sorted(WIDE_TRAINERS))
def test_wide_head_fused_trainer_matches_jax(name):
    """Both packages' fused Trainers at a wide head (the JAX package's
    fused kernel in interpret mode, the port's twin), the same data and
    initial weights; the noise words differ between the packages, so
    dropout is held off by drawing pdrop 0 and the augmentation is the
    identity: two epochs, costs and minf within 2e-5, final weights within
    1e-4."""
    layers, batch, nb, fn = WIDE_TRAINERS[name]
    layers = [[n, {k: (0.0 if k == "pdrop" else v) for k, v in a.items()}]
              for n, a in layers]
    n_out = layers[-1][1]["n_out"]
    img = layers[0][1]["img_sz"]
    rng = np.random.RandomState(len(name))
    x = rng.rand(nb * batch, 1, img, img).astype(np.float32)
    y = rng.randint(0, n_out, nb * batch).astype(np.int32)
    jt = JaxTrainer(JaxNet([[n, dict(a)] for n, a in layers], _tr(batch)),
                    x, y, x, y)
    tt = Trainer(TorchNet([[n, dict(a)] for n, a in layers], _tr(batch)),
                 x, y, x, y, device="cpu")
    assert jt._mega is not None
    assert tt._mega_plan.epoch_fn.__name__ == fn
    for _ in range(2):
        _, jc, jmin = jt.run_epoch()
        _, tc, tmin = tt.run_epoch()
        np.testing.assert_allclose(tc, jc, rtol=0, atol=2e-5)
        np.testing.assert_allclose(tmin, jmin, rtol=0, atol=2e-5)
        jt.net.inc_epoch_set_rate()
        tt.net.inc_epoch_set_rate()
    for lj, lt in zip(jt.checkpoint_dict()["allwts"],
                      tt.checkpoint_dict()["allwts"]):
        for a, b in zip(lj, lt):
            np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-4)


# ------------------------------------------------------------ edge cases

def test_dropped_unit_with_inf_preactivation_gives_nan_in_both():
    """A hidden bias of inf makes that unit's pre-activation inf for every
    sample; where dropout drops it, 0 * inf is NaN (no rescale, no select),
    so the step's cost is NaN in the JAX fused kernel and in the port's
    twin."""
    layers = _mnist(10)
    rng = np.random.RandomState(0)
    x = rng.rand(8, 1, 12, 12).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.int32)
    costs = []
    for net_cls, trainer in ((JaxNet, JaxTrainer), (TorchNet, Trainer)):
        net = net_cls([[n, dict(a)] for n, a in layers], _tr(8))
        allwts = [[np.array(w) for w in lw] for lw in net.allwts0]
        allwts[5][1][:] = np.inf   # the hidden layer's bias
        net = net_cls([[n, dict(a)] for n, a in layers], _tr(8), allwts)
        kw = {"device": "cpu"} if trainer is Trainer else {}
        t = trainer(net, x, y, x, y, **kw)
        assert t._mega is not None
        costs.append(np.asarray(t.run_epoch()[1]))
    for c in costs:
        assert np.isnan(c).all(), c


def test_label_outside_the_classes():
    """The port refuses a label outside [0, NC): its Trainer before any
    kernel runs, its twins' one-hot on the CPU. The JAX package's fused
    kernel counts such a label with a zero one-hot row (a finite cost);
    the port's CUDA kernels give a NaN cost (chip_smoke.py)."""
    layers = _mnist(10)
    rng = np.random.RandomState(1)
    x = rng.rand(8, 1, 12, 12).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.int32)
    y[3] = 10
    with pytest.raises(ValueError, match=r"labels must lie in \[0, 10\)"):
        Trainer(TorchNet([[n, dict(a)] for n, a in layers], _tr(8)), x, y,
                x, y, device="cpu")
    with pytest.raises(RuntimeError):
        megastep.softmax_nll(torch.zeros(8, 10), torch.tensor(y), 8)
    jt = JaxTrainer(JaxNet([[n, dict(a)] for n, a in layers], _tr(8)), x, y,
                    x, y)
    assert jt._mega is not None
    assert np.isfinite(np.asarray(jt.run_epoch()[1])).all()


# ----------------------------------------------------------------- route

PHASE23 = {"mnist_b3000": "megastep_epoch", "mnist_b128_457": "megastep_epoch",
           "mnist_b20_1453": "megastep_epoch", "flat_b128_457": "mlp_epoch",
           "three_level_b20_1500": "deep_epoch"}
PRMS = {   # params/<name>.prms: (its dataset, the family it fuses in)
    "mnist_cnn": ("synth_hard", "megastep_epoch"),
    "galaxy_rbf": ("synth3", "deep_epoch"),
    "logit_centered": ("synth", "deep_epoch"),
    "synth_quick": ("synth", "deep_epoch"),
    "flat_mlp": ("synth_hard", "mlp_epoch"),
    "synth_aux": ("synth_aux", "deep_epoch"),
    "gtsrb_mcdnn": ("signs48", "deep_epoch"),
}


@pytest.mark.parametrize("name", sorted(PHASE23))
def test_phase23_configs_keep_their_family(name):
    layers, tr = chip_smoke.head_config(name)
    net = TorchNet(layers, tr)
    plan = megastep.fused_plan(net)
    assert megastep.fused_decline_reason(net) is None
    assert plan.epoch_fn.__name__ == PHASE23[name]
    assert plan.spec.batch == chip_smoke.HEAD_SHAPES[name][0]


@pytest.mark.parametrize("name", sorted(PRMS))
def test_shipped_prms_keep_their_family(name):
    data_name, fn = PRMS[name]
    layers, tr, _ = load_params(os.path.join(REPO, "params", name + ".prms"))
    data = load_dataset(data_name)
    # signs48 declares its shape (its arrays, 1.4 GB, are drawn on access)
    shape = ((1, data.CHANNELS, data.IMG_SZ, data.IMG_SZ)
             if hasattr(data, "IMG_SZ") else fixdim(data.training_x).shape)
    layers[0][1]["img_sz"] = shape[-1]
    if "num_maps" not in layers[0][1] and shape[1] != 1:
        layers[0][1]["num_maps"] = shape[1]
    net = TorchNet(layers, tr)
    aux = hasattr(data, "training_aux")
    assert megastep.fused_decline_reason(net, aux) is None
    assert megastep.fused_plan(net, aux_data=aux).epoch_fn.__name__ == fn
