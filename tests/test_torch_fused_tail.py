"""The port's FUSED_TAIL path against the JAX package's, on the CPU.

The tail's plain forward and backward against ``fused_mlp.py``'s Pallas
kernels in interpret mode, with the JAX dropout mask handed to the port as
words (0 drops, 0xFFFFFF keeps); the autograd function against
``jax.grad`` of the JAX custom_vjp; the FUSED_TAIL gate; and a small
Elastic -> Conv -> Pool -> Hidden -> Softmax net whose per-layer epochs
track the JAX Trainer's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from theanet_tpu.model import NeuralNet as JaxNet
from theanet_tpu.ops import fused_mlp as jfm
from theanet_tpu.ops.megastep import fused_decline_reason as jax_reason
from theanet_tpu.trainer import Trainer as JaxTrainer

from theanet_tpu_torch.model import NeuralNet as TorchNet
from theanet_tpu_torch.ops import fused_mlp as tfm
from theanet_tpu_torch.ops import megastep
from theanet_tpu_torch.trainer import Trainer

SHAPES = {"small": (6, 24, 16, 5), "mnist_cnn": (20, 720, 500, 10)}
SLOPES = (0.01, 0.0, 1.0)


def _inputs(shape, seed=0):
    B, K, NH, O = shape
    rng = np.random.RandomState(seed)
    x = rng.rand(B, K).astype(np.float32)
    w1 = (rng.randn(K, NH) / np.sqrt(K)).astype(np.float32)
    b1 = (0.1 * rng.randn(NH)).astype(np.float32)
    w2 = (rng.randn(NH, O) / np.sqrt(NH)).astype(np.float32)
    b2 = (0.1 * rng.randn(O)).astype(np.float32)
    y = rng.randint(0, O, B)
    return x, w1, b1, w2, b2, y


def _jax_fwd(args, slope, pdrop, train, seed):
    spec = jfm.FusedTailSpec(slope=slope, pdrop=pdrop, train=train)
    logp, h, mask = jfm._fwd_impl(*map(jnp.asarray, args), spec,
                                  jnp.float32(seed))
    return spec, np.asarray(logp), np.asarray(h), np.asarray(mask)


def _words(mask):
    """The JAX keep mask as the port's dropout words."""
    return torch.tensor(np.where(mask > 0, 0xFFFFFF, 0).astype(np.int32))


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("slope", SLOPES)
@pytest.mark.parametrize("pdrop,train", [(0.0, True), (0.5, True),
                                         (0.5, False), (0.0, False)])
def test_tail_forward_and_backward_match_jax(shape, slope, pdrop, train):
    x, w1, b1, w2, b2, y = _inputs(SHAPES[shape])
    jspec, logp, h, mask = _jax_fwd((x, w1, b1, w2, b2), slope, pdrop, train,
                                    seed=123)
    if pdrop and train:
        assert 0 < mask.mean() < 1
    spec = tfm.FusedTailSpec(slope=slope, pdrop=pdrop, train=train)
    t_logp, t_h, t_mask = tfm.tail_forward_reference(
        _t(x), _t(w1), _t(b1), _t(w2), _t(b2), _words(mask), spec)
    np.testing.assert_allclose(t_logp.numpy(), logp, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_h.numpy(), h, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t_mask.numpy(), mask)

    g = np.zeros(logp.shape, np.float32)
    g[np.arange(len(y)), y] = -1.0 / len(y)
    g += 0.01 * np.random.RandomState(1).randn(*g.shape).astype(np.float32)
    res = tuple(map(jnp.asarray, (x, w1, w2, h, mask, logp)))
    want = jfm._fused_bwd(jspec, res, jnp.asarray(g))[:5]
    got = tfm.tail_backward_reference(*map(_t, (x, w1, w2, h, mask, logp, g)),
                                      spec)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape),
                                   atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("slope", SLOPES)
@pytest.mark.parametrize("pdrop", [0.0, 0.5])
def test_autograd_function_matches_jax_grad(slope, pdrop):
    """fused_hidden_softmax under torch autograd against jax.grad through
    the JAX custom_vjp, on the NLL of the labels."""
    x, w1, b1, w2, b2, y = _inputs(SHAPES["small"], seed=3)
    seed = 77
    _, _, _, mask = _jax_fwd((x, w1, b1, w2, b2), slope, pdrop, True, seed)
    jspec = jfm.FusedTailSpec(slope=slope, pdrop=pdrop, train=True)

    def loss(args):
        logp = jfm.fused_hidden_softmax(*args, jnp.float32(seed), jspec)
        return -jnp.mean(logp[jnp.arange(len(y)), y])

    jargs = tuple(map(jnp.asarray, (x, w1, b1, w2, b2)))
    j_loss, j_grads = jax.value_and_grad(loss)(jargs)
    targs = [_t(a).requires_grad_(True) for a in (x, w1, b1, w2, b2)]
    spec = tfm.FusedTailSpec(slope=slope, pdrop=pdrop, train=True)
    logp = tfm.fused_hidden_softmax(*targs, _words(mask), spec)
    t_loss = -logp[torch.arange(len(y)), torch.tensor(y)].mean()
    t_loss.backward()
    assert abs(float(t_loss.detach()) - float(j_loss)) < 1e-5
    for t, j in zip(targs, j_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=0)


def test_tail_wrappers_refuse_other_devices():
    spec = tfm.FusedTailSpec(0.01, 0.0, False)
    m = [torch.empty(s, device="meta") for s in
         ((2, 3), (3, 4), (4,), (4, 5), (5,))]
    with pytest.raises(ValueError, match="no kernel"):
        tfm.tail_forward(*m, None, spec)
    with pytest.raises(ValueError, match="no kernel"):
        tfm.tail_backward(m[0], m[1], m[3], *[torch.empty(
            s, device="meta") for s in ((2, 4), (2, 4), (2, 5), (2, 5))],
            spec)


def _spec(actvn="relu10", pdrop=0.5, head=None, dropout_layer=False,
          first=("InputLayer", {"img_sz": 12})):
    layers = [[first[0], dict(first[1])],
              ["ConvLayer", {"num_maps": 2, "filter_sz": 3, "stride": 1}],
              ["PoolLayer", {"pool_sz": 2}],
              ["HiddenLayer", {"n_out": 16, "pdrop": pdrop, "actvn": actvn}]]
    if dropout_layer:
        layers.append(["DropOutLayer", {"pdrop": 0.5}])
    layers.append(head or ["SoftmaxLayer", {"n_out": 4}])
    return layers


def _tr(**kw):
    d = {"SEED": 7, "BATCH_SZ": 4, "NUM_EPOCHS": 2, "EPOCHS_TO_TEST": 1,
         "TEST_SAMP_SZ": 8, "INIT_LEARNING_RATE": 0.1,
         "EPOCHS_TO_HALF_RATE": 1}
    d.update(kw)
    return d


@pytest.mark.parametrize("case", [
    dict(), dict(actvn="relu"), dict(actvn="linear"), dict(actvn="relu05"),
    dict(actvn="sigmoid"), dict(actvn="tanh"), dict(dropout_layer=True),
    dict(head=["CenteredOutLayer", {"n_features": 6, "n_classes": 4,
                                    "kind": "LOGIT"}]),
])
def test_fused_tail_gate_matches_jax(case):
    """The gate's cases (test_fused_mlp.py:96-110, without the heads and
    dtypes the port does not have): on for a leaky-relu-family Hidden
    straight before a Softmax head, silently off otherwise; the slope is
    the JAX package's, and no fused family takes a gated net."""
    jnet = JaxNet(_spec(**case), _tr(FUSED_TAIL=True))
    tnet = TorchNet(_spec(**case), _tr(FUSED_TAIL=True))
    assert tnet.fused_tail == jnet.fused_tail
    assert tnet._fused_slope == jnet._fused_slope
    assert not TorchNet(_spec(**case), _tr()).fused_tail
    if tnet.fused_tail:
        assert megastep.fused_plan(tnet) is None
        assert megastep.fused_decline_reason(tnet) == jax_reason(jnet)


def test_fused_tail_keeps_raising_on_compute_dtype():
    """bf16 is ported: FUSED_TAIL turns itself off under it, as in the JAX
    package (model.py:182-184); a compute dtype the port does not take
    still raises."""
    prms = _tr(FUSED_TAIL=True, COMPUTE_DTYPE="bfloat16")
    assert not TorchNet(_spec(), dict(prms)).fused_tail
    assert not JaxNet(_spec(), dict(prms)).fused_tail
    with pytest.raises(NotImplementedError, match="COMPUTE_DTYPE"):
        TorchNet(_spec(), _tr(FUSED_TAIL=True, COMPUTE_DTYPE="float16"))


def _data(n, img=12, nc=4, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 1, img, img).astype(np.float32),
            rng.randint(0, nc, n).astype(np.int32))


def test_slice_epochs_match_the_jax_trainer(capsys):
    """Elastic (identity warp, invert) -> Conv -> Pool -> Hidden -> Softmax
    with FUSED_TAIL and pdrop 0: the port's per-layer epochs (the tail's
    autograd function) against the JAX Trainer's (its Pallas tail in
    interpret mode), as test_fused_mlp.py:139-158 holds the JAX package's
    two tails to each other; eval and predict through the tail too."""
    first = ("ElasticLayer", {"img_sz": 12, "invert_image": True,
                              "method": "pallas"})
    spec = _spec(actvn="relu01", pdrop=0, first=first)
    (xtr, ytr), (xte, yte) = _data(40), _data(16, seed=1)
    jnet = JaxNet([list(l) for l in spec], _tr(FUSED_TAIL=True))
    tnet = TorchNet([list(l) for l in spec], _tr(FUSED_TAIL=True))
    assert jnet.fused_tail and tnet.fused_tail
    jt = JaxTrainer(jnet, xtr, ytr, xte, yte)
    tt = Trainer(tnet, xtr, ytr, xte, yte, device="cpu")
    assert tt._mega is None
    assert megastep.FUSED_TAIL_REASON in capsys.readouterr().err
    for _ in range(2):
        np.testing.assert_allclose(tt.run_epoch()[0], jt.run_epoch()[0],
                                   rtol=1e-4)
        np.testing.assert_allclose(tt.evaluate_full("test"),
                                   jt.evaluate_full("test"), atol=1e-4)
        jnet.inc_epoch_set_rate()
        tnet.inc_epoch_set_rate()
    j_feat, j_pred = jt.predict(xte)
    t_feat, t_pred = tt.predict(xte)
    np.testing.assert_array_equal(t_pred, np.asarray(j_pred))
    np.testing.assert_allclose(t_feat, np.asarray(j_feat), atol=1e-4)


@pytest.mark.parametrize("nearest", [True, False])
def test_slice_with_a_warp_trains_the_same_through_each_method(nearest):
    """With an active warp, pflip and dropout the port's draws are its own,
    so its methods are held to each other: 'pallas' (the kernel's plain
    version here) and 'gather' read the same draws from each step's
    generator and give the same epoch; the tail's dropout words follow."""
    first = ("ElasticLayer", {"img_sz": 12, "translation": 1, "zoom": 1.1,
                              "magnitude": 4, "sigma": 2, "pflip": 0.05,
                              "angle": 5, "invert_image": True,
                              "nearest": nearest})
    (xtr, ytr), (xte, yte) = _data(24), _data(8, seed=1)
    costs = []
    for method in ("pallas", "gather"):
        f = (first[0], dict(first[1], method=method))
        net = TorchNet(_spec(first=f), _tr(FUSED_TAIL=True))
        tr = Trainer(net, xtr, ytr, xte, yte, device="cpu")
        costs.append(tr.run_epochs(2)[1])
    np.testing.assert_allclose(costs[0], costs[1], rtol=1e-5)
    assert np.all(np.isfinite(costs[0]))


def test_trainer_turns_tf32_off():
    """PyTorch runs cuDNN convolutions in TF32 by default; the Trainer, the
    port's training entry point, sets f32 for convolutions and matmuls."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        (xtr, ytr), (xte, yte) = _data(8), _data(8, seed=1)
        Trainer(TorchNet(_spec(), _tr()), xtr, ytr, xte, yte, device="cpu")
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
