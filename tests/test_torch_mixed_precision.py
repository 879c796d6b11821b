"""COMPUTE_DTYPE='bfloat16' in the port, on the CPU: the counterparts of
tests/test_mixed_precision.py, and the same network body as the JAX
package's under bf16.

bf16 runs the network body (convs, dense products, activations) in bf16
with f32 masters, momenta, updates and head math; predict runs eval's body;
Elastic and Color resample and jitter in f32 on bf16 inputs; a dropout
mask does not depend on the compute dtype.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from theanet_tpu.model import NeuralNet as JaxNet

from theanet_tpu_torch.data import synth
from theanet_tpu_torch.layers import ColorLayer
from theanet_tpu_torch.layers.dense import drop_output
from theanet_tpu_torch.layers.input import color_jitter, draw_color
from theanet_tpu_torch.model import NeuralNet
from theanet_tpu_torch.ops.elastic import ElasticConfig, elastic_augment
from theanet_tpu_torch.prms import fixdim
from theanet_tpu_torch.trainer import Trainer

TRAIN_X, TEST_X = fixdim(synth.training_x), fixdim(synth.testing_x)
TRAIN_Y, TEST_Y = synth.training_y, synth.testing_y


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one intra-op thread: the suite runs several workers at
    once, and PyTorch's CPU thread pools contending for the same cores slow
    these many-small-op tests by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def spec():
    """test_mixed_precision.py's net."""
    return [
        ["ElasticLayer", {"img_sz": 28, "translation": 1, "zoom": 1.05,
                          "magnitude": 8, "sigma": 4, "pflip": 0.01,
                          "angle": 3}],
        ["ConvLayer", {"num_maps": 4, "filter_sz": 3, "stride": 1,
                       "actvn": "relu10"}],
        ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": 64, "pdrop": 0.5}],
        ["SoftmaxLayer", {"n_out": 10}],
    ]


def prms(**kw):
    d = {"SEED": 7, "BATCH_SZ": 20, "NUM_EPOCHS": 1, "EPOCHS_TO_TEST": 1,
         "TEST_SAMP_SZ": 200, "INIT_LEARNING_RATE": 0.1,
         "EPOCHS_TO_HALF_RATE": 1, "MEGAFUSED": False}
    d.update(kw)
    return d


def trainer(n_train, n_test, **kw):
    net = NeuralNet(spec(), prms(**kw))
    return net, Trainer(net, TRAIN_X[:n_train], TRAIN_Y[:n_train],
                        TEST_X[:n_test], TEST_Y[:n_test], device="cpu")


def _all_f32(tree):
    return all(p.dtype == torch.float32 for lp in tree for p in lp)


def test_bf16_keeps_f32_masters_and_learns():
    net, tr = trainer(2000, 400, COMPUTE_DTYPE="bfloat16")
    assert net.compute_dtype == torch.bfloat16
    assert _all_f32(tr.params) and _all_f32(tr.moms)
    errs = []
    for _ in range(4):
        tr.run_epoch()
        errs.append(tr.evaluate_full("test")[0])
        net.inc_epoch_set_rate()
    assert errs[-1] < 15.0, errs
    assert _all_f32(tr.params) and _all_f32(tr.moms)


def test_bf16_forward_produces_f32_head():
    net = NeuralNet(spec(), prms(COMPUTE_DTYPE="bfloat16"))
    params, _ = net.init_params("cpu")
    x = torch.tensor(np.random.RandomState(0).rand(4, 1, 28, 28),
                     dtype=torch.float32)
    hs = net.forward(params, x, train=True,
                     generator=torch.Generator().manual_seed(0))
    assert hs["probs"].dtype == hs["logprob"].dtype == torch.float32
    np.testing.assert_allclose(hs["probs"].sum(dim=1).numpy(), 1.0,
                               rtol=1e-3)


def test_bf16_close_to_f32_on_first_epoch():
    costs = {}
    for cd in (None, "bfloat16"):
        _, tr = trainer(400, 200, **({"COMPUTE_DTYPE": cd} if cd else {}))
        costs[cd] = tr.run_epoch()[0]
    assert abs(costs[None] - costs["bfloat16"]) / costs[None] < 0.05, costs


def test_predict_runs_same_body_as_eval_under_bf16():
    _, tr = trainer(400, 200, COMPUTE_DTYPE="bfloat16")
    _, preds = tr.predict(TEST_X[:200])
    err_pred = (preds != TEST_Y[:200]).mean() * 100
    err_eval, _ = tr.evaluate_full("test")
    np.testing.assert_allclose(err_pred, err_eval, atol=1e-6)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_eval_forward_matches_jax(cd):
    """Eval mode (the ElasticLayer passes, dropout scales): the same
    initial weights and images give the JAX package's probabilities. The
    bf16 bodies round at the same points (1.4e-7 relative measured), so
    bf16 is held to one bf16 ulp, room for one straddled rounding."""
    tnet = NeuralNet(spec(), prms(COMPUTE_DTYPE=cd))
    jnet = JaxNet(spec(), prms(COMPUTE_DTYPE=cd))
    x = TEST_X[:40]
    jp, _ = jnet.init_params()
    tp, _ = tnet.init_params("cpu")
    ref = jnet.forward(jp, jnp.asarray(x), key=jax.random.PRNGKey(0),
                       train=False)["probs"]
    got = tnet.forward(tp, torch.tensor(x), train=False)["probs"]
    tol = (dict(rtol=2.0 ** -8, atol=0) if cd == "bfloat16" else
           dict(rtol=1e-5, atol=1e-5))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)


@pytest.mark.parametrize("method", ["gather", "matmul", "pallas"])
def test_bf16_through_every_resample_method(method):
    """bf16 inputs resample in f32: the bf16 output is the f32 output of
    the same draws rounded, whichever method."""
    cfg = ElasticConfig(img_sz=16, translation=2, zoom=1.1, magnitude=10,
                        sigma=3, pflip=0.02, angle=5)
    x = torch.tensor(np.random.RandomState(0).rand(4, 1, 16, 16),
                     dtype=torch.float32).to(torch.bfloat16)
    outs = {}
    for dt in (torch.bfloat16, torch.float32):
        outs[dt] = elastic_augment(x.to(dt), cfg, train=True, method=method,
                                   generator=torch.Generator().manual_seed(3))
        assert bool(torch.isfinite(outs[dt]).all())
    np.testing.assert_allclose(outs[torch.bfloat16].float().numpy(),
                               outs[torch.float32].numpy(), atol=2e-2)


def test_bf16_gather_and_matmul_agree():
    cfg = ElasticConfig(img_sz=16, translation=2, zoom=1.1, magnitude=10,
                        sigma=3, pflip=0.02, angle=5)
    x = torch.tensor(np.random.RandomState(0).rand(4, 1, 16, 16),
                     dtype=torch.bfloat16)
    outs = [elastic_augment(x, cfg, train=True, method=m,
                            generator=torch.Generator().manual_seed(3))
            for m in ("gather", "matmul")]
    np.testing.assert_allclose(outs[0].float().numpy(),
                               outs[1].float().numpy(), atol=2e-2)


def test_bf16_color_jitter_follows_f32():
    layer = ColorLayer(img_sz=8, num_maps=3,
                       rand_gen=np.random.RandomState(0), balance=1.3,
                       gamma=1.4)
    x = torch.tensor(np.random.RandomState(1).rand(4, 3, 8, 8),
                     dtype=torch.float32)
    u = draw_color(torch.Generator().manual_seed(2), 4, 3, "cpu")
    got = color_jitter(x.to(torch.bfloat16), u, layer.balance, layer.gamma,
                       layer.maxval)
    ref = color_jitter(x, u, layer.balance, layer.gamma, layer.maxval)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=2e-2)


def test_dropout_mask_does_not_depend_on_the_dtype():
    ones = torch.ones(20, 64)
    keep = {dt: drop_output(ones.to(dt), 0.5,
                            torch.Generator().manual_seed(4)) != 0
            for dt in (torch.float32, torch.bfloat16)}
    assert torch.equal(keep[torch.float32], keep[torch.bfloat16])
    assert 0.3 < float(keep[torch.float32].float().mean()) < 0.7


def test_bf16_cnn_with_all_aug_trains():
    _, tr = trainer(200, 100, COMPUTE_DTYPE="bfloat16")
    total, costs, _ = tr.run_epoch()
    assert np.isfinite(total) and np.isfinite(costs).all()


@pytest.mark.parametrize("cd,fused", [(None, True), ("float32", True),
                                      ("bfloat16", False)])
def test_fused_tail_is_off_under_bf16(cd, fused):
    kw = {"FUSED_TAIL": True}
    if cd:
        kw["COMPUTE_DTYPE"] = cd
    assert NeuralNet(spec(), prms(**kw)).fused_tail == fused


@pytest.mark.parametrize("key,value", [("COMPUTE_DTYPE", "float16"),
                                       ("REMAT", True)])
def test_what_the_port_does_not_take_raises(key, value):
    with pytest.raises(NotImplementedError, match=key):
        NeuralNet(spec(), prms(**{key: value}))


def test_bf16_flagship_net_fuses_and_trains_in_f32():
    """bf16 is no disqualifier for the fused families (as in the JAX
    package); they compute the net in f32, so a fused epoch of the bf16 net
    gives the f32 net's costs to the bit."""
    layers = [["InputLayer", {"img_sz": 12}],
              ["ConvLayer", {"num_maps": 2, "filter_sz": 3, "stride": 1,
                             "actvn": "relu05"}],
              ["PoolLayer", {"pool_sz": 2}],
              ["ConvLayer", {"num_maps": 3, "filter_sz": 3, "stride": 1,
                             "actvn": "relu10"}],
              ["PoolLayer", {"pool_sz": 2}],
              ["HiddenLayer", {"n_out": 16, "pdrop": 0.5}],
              ["SoftmaxLayer", {"n_out": 4}]]
    rng = np.random.RandomState(0)
    x = rng.rand(40, 1, 12, 12).astype(np.float32)
    y = rng.randint(0, 4, 40).astype(np.int32)
    costs = {}
    for cd in ("float32", "bfloat16"):
        net = NeuralNet([[n, dict(a)] for n, a in layers],
                        prms(BATCH_SZ=4, COMPUTE_DTYPE=cd, MEGAFUSED="auto"))
        tr = Trainer(net, x, y, x[:8], y[:8], device="cpu")
        assert tr._mega is not None
        costs[cd] = tr.run_epoch()[1]
    np.testing.assert_array_equal(costs["bfloat16"], costs["float32"])
