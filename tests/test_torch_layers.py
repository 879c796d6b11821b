"""The port's per-layer path against the JAX package's, on the CPU.

Same spec and SEED (so the same initial weights), same numpy batches: the
autograd train_step trajectory with L1/L2/max-norm and old-accumulator
momentum matches theanet_tpu's NeuralNet.train_step, and the eval forward
matches. The pool's gradient reaches every tied maximum.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from theanet_tpu.model import NeuralNet as JaxNet

from theanet_tpu_torch.layers.conv import maxpool
from theanet_tpu_torch.model import NeuralNet as TorchNet

B, IMG, NC = 4, 12, 4
REG1 = {"L1": 0.0, "L2": 1e-3, "momentum": 0.95, "rate": 1.0, "maxnorm": 0.9}
REG2 = {"L1": 0.0, "L2": 0.0, "momentum": 0.95, "rate": 1.0, "maxnorm": 0.0}
REGH = {"L1": 1e-4, "L2": 0.0, "momentum": 0.9, "rate": 1.0, "maxnorm": 0.7}
REGO = {"L1": 0.0, "L2": 0.0, "momentum": 0.95, "rate": 0.5, "maxnorm": 0.8}


def _layers(first=("InputLayer", {"img_sz": IMG}), pdrop=0):
    return [
        [first[0], dict(first[1])],
        ["ConvLayer", {"num_maps": 2, "filter_sz": 3, "stride": 1,
                       "mode": "valid", "actvn": "relu05", "reg": REG1}],
        ["PoolLayer", {"pool_sz": 2}],
        ["ConvLayer", {"num_maps": 3, "filter_sz": 3, "stride": 1,
                       "mode": "valid", "actvn": "relu10", "reg": REG2}],
        ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": 16, "pdrop": pdrop, "actvn": "relu01",
                         "reg": REGH}],
        ["SoftmaxLayer", {"n_out": NC, "reg": REGO}],
    ]


def _tr():
    return {"SEED": 99, "BATCH_SZ": B, "NUM_EPOCHS": 2, "EPOCHS_TO_TEST": 1,
            "TEST_SAMP_SZ": B, "INIT_LEARNING_RATE": 0.1,
            "EPOCHS_TO_HALF_RATE": 2}


def _data(nb, seed=7):
    rng = np.random.RandomState(seed)
    x = rng.rand(nb, B, 1, IMG, IMG).astype(np.float32)
    y = rng.randint(0, NC, (nb, B)).astype(np.int32)
    return x, y


def test_per_layer_trajectory_matches_jax():
    nb, n_epochs = 3, 2
    xs, ys = _data(nb)
    jnet, tnet = JaxNet(_layers(), _tr()), TorchNet(_layers(), _tr())
    jp, jm = jnet.init_params()
    tp, tm = tnet.init_params("cpu")
    jc, tc = [], []
    for _ in range(n_epochs):
        lr = jnet.get_rate()
        assert lr == tnet.get_rate()
        for i in range(nb):
            jp, jm, cost, _, _ = jnet.train_step(
                jp, jm, jnp.asarray(xs[i]), jnp.asarray(ys[i]),
                key=jnet.base_key, lr=lr)
            jc.append(float(cost))
            tp, tm, cost, _, _ = tnet.train_step(
                tp, tm, torch.tensor(xs[i]), torch.tensor(ys[i]), lr=lr)
            tc.append(float(cost))
        jnet.inc_epoch_set_rate()
        tnet.inc_epoch_set_rate()
    np.testing.assert_allclose(tc, jc, rtol=0, atol=2e-5)
    for lj, lt in zip(jp, tp):
        for a, b in zip(lj, lt):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=5e-5)
    for lj, lt in zip(jm, tm):
        for a, b in zip(lj, lt):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=5e-5)


def test_eval_forward_matches_jax():
    """Eval mode: an ElasticLayer only inverts, dropout scales by 1-p."""
    first = ("ElasticLayer", {"img_sz": IMG, "translation": 2, "zoom": 1.1,
                              "magnitude": 8, "sigma": 3, "pflip": 0.03,
                              "angle": 5, "invert_image": True,
                              "nearest": True})
    jnet = JaxNet(_layers(first, pdrop=0.5), _tr())
    tnet = TorchNet(_layers(first, pdrop=0.5), _tr())
    xs, ys = _data(1, seed=3)
    jp, _ = jnet.init_params()
    tp, _ = tnet.init_params("cpu")
    j_err, j_p, j_f, j_y = jnet.eval_step(jp, jnp.asarray(xs[0]),
                                          jnp.asarray(ys[0]), preds_feats=True)
    t_err, t_p, t_f, t_y = tnet.eval_step(tp, torch.tensor(xs[0]),
                                          torch.tensor(ys[0]),
                                          preds_feats=True)
    np.testing.assert_allclose(t_f.numpy(), np.asarray(j_f), atol=2e-6)
    np.testing.assert_array_equal(t_y.numpy(), np.asarray(j_y))
    assert abs(float(t_err) - float(j_err)) < 1e-7
    assert abs(float(t_p) - float(j_p)) < 1e-6
    jf, jy = jnet.predict(jp, jnp.asarray(xs[0]))
    tf, ty = tnet.predict(tp, torch.tensor(xs[0]))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=2e-6)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def test_active_augmentation_does_not_train_per_layer():
    """An active ElasticLayer once raised on the per-layer path; now it
    trains there, drawing its warp from the step's generator: the same
    generator seed gives the same step, another seed another warp."""
    first = ("ElasticLayer", {"img_sz": IMG, "translation": 1})
    net = TorchNet(_layers(first), _tr())
    p, m = net.init_params("cpu")
    xs, ys = _data(1)

    def step(seed):
        gen = torch.Generator().manual_seed(seed)
        return net.train_step(p, m, torch.tensor(xs[0]), torch.tensor(ys[0]),
                              lr=0.1, generator=gen)

    a, b, c = step(1), step(1), step(2)
    assert np.isfinite(float(a[2]))
    assert float(a[2]) == float(b[2])
    assert float(a[2]) != float(c[2])
    assert any(not torch.equal(u, v) for u, v in zip(a[1][1], c[1][1]))


def test_conv_is_true_convolution():
    """ConvLayer flips the filter (Theano conv2d), unlike F.conv2d."""
    net = TorchNet(_layers(), _tr())
    conv = net.net_layers[1]
    w = torch.zeros(2, 1, 3, 3)
    w[0, 0, 0, 0] = 1.0   # top-left tap of the stored filter
    x = torch.arange(36.0).reshape(1, 1, 6, 6)
    out = conv.apply([w, torch.zeros(2)], x, train=False)
    # true convolution: output (0,0) reads the bottom-right input of its patch
    assert float(out[0, 0, 0, 0]) == float(x[0, 0, 2, 2])
    assert float(F.conv2d(x, w)[0, 0, 0, 0]) == float(x[0, 0, 0, 0])


@pytest.mark.parametrize("ignore_border", [False, True])
def test_pool_gradient_reaches_every_tied_maximum(ignore_border):
    x = torch.ones(1, 1, 5, 5, requires_grad=True)
    y = maxpool(x, 2, ignore_border)
    assert y.shape[-1] == (2 if ignore_border else 3)
    y.sum().backward()
    g = x.grad[0, 0]
    full = 4 if ignore_border else 5
    # every element of a window of ones is a tied maximum
    assert torch.equal(g[:full, :full], torch.ones(full, full))
    if ignore_border:   # the dropped tail gets no gradient
        assert float(g[4].abs().sum() + g[:, 4].abs().sum()) == 0.0
    # F.max_pool2d sends the window's gradient to one element only
    x2 = torch.ones(1, 1, 2, 2, requires_grad=True)
    F.max_pool2d(x2, 2).sum().backward()
    assert float(x2.grad.sum()) == 1.0


def test_pool_gradient_skips_non_maxima():
    x = torch.tensor([[[[1.0, 3.0], [3.0, 2.0]]]], requires_grad=True)
    maxpool(x, 2, False).sum().backward()
    assert x.grad.tolist() == [[[[0.0, 1.0], [1.0, 0.0]]]]


@pytest.mark.parametrize("kind", ["LOGIT", "RBF"])
def test_centered_out_eval_matches_jax(kind):
    """CenteredOut eval: features, predictions, the error rate and the
    second statistic (mean true-class probability; for LOGIT the share of
    true-class bits below one half)."""
    layers = _layers()[:-1] + [["CenteredOutLayer", {
        "n_features": 6, "n_classes": NC, "kind": kind,
        "learn_centers": kind == "RBF",
        "junk_dist": 3.0 if kind == "RBF" else np.inf, "reg": REGO}]]
    jnet = JaxNet([list(l) for l in layers], _tr())
    tnet = TorchNet([list(l) for l in layers], _tr())
    xs, ys = _data(1, seed=5)
    jp, _ = jnet.init_params()
    tp, _ = tnet.init_params("cpu")
    j_err, j_p, j_f, j_y = jnet.eval_step(jp, jnp.asarray(xs[0]),
                                          jnp.asarray(ys[0]), preds_feats=True)
    t_err, t_p, t_f, t_y = tnet.eval_step(tp, torch.tensor(xs[0]),
                                          torch.tensor(ys[0]),
                                          preds_feats=True)
    np.testing.assert_allclose(t_f.numpy(), np.asarray(j_f), atol=2e-6)
    np.testing.assert_array_equal(t_y.numpy(), np.asarray(j_y))
    assert abs(float(t_err) - float(j_err)) < 1e-7
    assert abs(float(t_p) - float(j_p)) < 1e-6
    tf, ty = tnet.predict(tp, torch.tensor(xs[0]))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(j_y))


def test_color_layer_eval_is_identity_and_trains_only_fused():
    active = ("ColorLayer", {"img_sz": IMG, "num_maps": 1, "balance": 1.3,
                             "gamma": 1.2})
    tnet = TorchNet(_layers(active), _tr())
    jnet = JaxNet(_layers(active), _tr())
    xs, ys = _data(1, seed=6)
    x = torch.tensor(xs[0])
    assert torch.equal(tnet.net_layers[0].apply([], x, train=False), x)
    tp, tm = tnet.init_params("cpu")
    jp, _ = jnet.init_params()
    t_err, t_p = tnet.eval_step(tp, x, torch.tensor(ys[0]))
    j_err, j_p = jnet.eval_step(jp, jnp.asarray(xs[0]), jnp.asarray(ys[0]))
    assert abs(float(t_p) - float(j_p)) < 1e-6
    # an active ColorLayer now trains per layer too, from the step's
    # generator (tests/test_torch_elastic.py holds its transform to JAX's)
    gen = torch.Generator().manual_seed(3)
    cost = tnet.train_step(tp, tm, x, torch.tensor(ys[0]), lr=0.1,
                           generator=gen)[2]
    assert np.isfinite(float(cost))
    # an identity ColorLayer (balance = gamma = 1) trains per layer
    ident = ("ColorLayer", {"img_sz": IMG, "num_maps": 1})
    tnet, jnet = TorchNet(_layers(ident), _tr()), JaxNet(_layers(ident), _tr())
    tp, tm = tnet.init_params("cpu")
    jp, jm = jnet.init_params()
    cost_t = tnet.train_step(tp, tm, x, torch.tensor(ys[0]), lr=0.1)[2]
    cost_j = jnet.train_step(jp, jm, jnp.asarray(xs[0]), jnp.asarray(ys[0]),
                             key=jnet.base_key, lr=0.1)[2]
    assert abs(float(cost_t) - float(cost_j)) < 2e-5
