"""The port's deep family in every conv geometry the JAX package fuses.

'same' convs, stride-1 'full' convs whose pool washes out the reference's
in+F+1 booking, strided valid convs where the stride divides in-F+1, and a
MeanLayer tail. Each case builds one layer list in both packages at the
same SEED, checks that the port's matcher builds the JAX package's
DeepSpec, and runs the same numpy data and 32-bit noise words through
``theanet_tpu.ops.megastep_deep.make_deep_epoch_fn(..., interpret=True)``
and the port's ``deep_epoch`` (its plain PyTorch twin on CPU tensors). The
geometries are those of ``tests/test_fused_modes.py``; the CUDA kernel runs
only on a card, where ``chip_smoke.py`` phase 21 holds it to this twin.

An even 'same' filter reads the taps of the port's per-layer path (a full
conv cropped at (F-1)//2); the JAX package's kernel reads them one row and
one column lower than its own per-layer path does, so for even filters the
twin is held to the JAX package's per-layer step and to the port's own
per-layer path instead.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from theanet_tpu.model import NeuralNet as JaxNet
from theanet_tpu.ops import megastep as jm
from theanet_tpu.ops import megastep_deep as jd
from theanet_tpu.ops import megastep_dp as jdp
from theanet_tpu.trainer import Trainer as JaxTrainer

from theanet_tpu_torch.model import NeuralNet as TorchNet
from theanet_tpu_torch.ops import megastep as tm
from theanet_tpu_torch.ops import megastep_deep as td
from theanet_tpu_torch.ops import megastep_dp as tdp
from theanet_tpu_torch.trainer import Trainer

B, NH, NC = 4, 10, 4
ELASTIC = {"translation": 2, "zoom": 1.1, "magnitude": 8, "sigma": 3,
           "pflip": 0.03, "angle": 5, "invert_image": True, "nearest": False}

# name: (img, [(maps, filter, stride, mode, pool or None)], MeanLayer,
# ElasticLayer in front); the first eight are tests/test_fused_modes.py's
# CASES
CASES = {
    "same-stack": (10, [(3, 3, 1, "same", 2), (4, 3, 1, "same", 2)],
                   False, False),
    "stride2": (14, [(3, 3, 2, "valid", 2)], False, False),
    "stride2-nopool": (14, [(3, 3, 2, "valid", None), (4, 2, 1, "valid", 2)],
                       False, False),
    "pool-gt-filter": (13, [(3, 3, 1, "valid", 5)], False, False),
    "same-then-stride": (12, [(2, 3, 1, "same", 2), (3, 3, 2, "valid", 2)],
                         False, False),
    "full-l0": (11, [(3, 3, 1, "full", 3)], False, False),
    "full-l1": (12, [(2, 3, 1, "valid", 2), (3, 2, 1, "full", 4)],
                False, False),
    "full-full": (13, [(2, 3, 1, "full", 6), (3, 3, 1, "full", 4)],
                  False, False),
    # MeanLayer tails after a 'same' stack and after a valid stack whose
    # last level has no pool
    "mean-after-same": (10, [(3, 3, 1, "same", 2), (4, 3, 1, "same", 2)],
                        True, False),
    "mean-after-valid": (12, [(2, 3, 1, "valid", 2), (5, 3, 1, "valid", None)],
                         True, False),
    # the geometry under the warp, pflip and invert of the elastic layer
    "elastic-same-stride": (16, [(3, 3, 1, "same", 2), (4, 3, 2, "valid", 2)],
                            False, True),
    "elastic-full-mean": (11, [(3, 3, 1, "full", 3), (4, 3, 1, "same", None)],
                          True, True),
}
# even 'same' filters: F 4 pads 2 before and 1 after, F 2 pads 1 before
EVEN = (10, [(3, 4, 1, "same", 2), (4, 2, 1, "same", 2)], False, False)


def _layers(img, cfgs, mean=False, elastic=False, pdrop=0.5):
    layers = [["ElasticLayer", dict(img_sz=img, **ELASTIC)] if elastic
              else ["InputLayer", {"img_sz": img}]]
    for maps, f, stride, mode, pool in cfgs:
        layers.append(["ConvLayer", {
            "num_maps": maps, "filter_sz": f, "stride": stride, "mode": mode,
            "actvn": "relu07", "reg": {"L2": 1e-3, "maxnorm": 0.8}}])
        if pool is not None:
            layers.append(["PoolLayer", {"pool_sz": pool,
                                         "ignore_border": False}])
    if mean:
        layers.append(["MeanLayer", {}])
    layers += [["HiddenLayer", {"n_out": NH, "pdrop": pdrop,
                                "actvn": "relu02", "reg": {"L1": 1e-4}}],
               ["SoftmaxLayer", {"n_out": NC, "reg": {}}]]
    return layers


def _nets(layers, seed=23):
    tr = {"SEED": seed, "BATCH_SZ": B, "NUM_EPOCHS": 1, "EPOCHS_TO_TEST": 1,
          "TEST_SAMP_SZ": B, "INIT_LEARNING_RATE": 0.15,
          "EPOCHS_TO_HALF_RATE": 2}
    return (JaxNet([[n, dict(a)] for n, a in layers], dict(tr)),
            TorchNet([[n, dict(a)] for n, a in layers], dict(tr)))


def _specs(layers):
    jnet, tnet = _nets(layers)
    js, ts = jd.deep_spec_from_net(jnet), td.deep_spec_from_net(tnet)
    assert js is not None, jm.fused_decline_reason(jnet)
    assert ts is not None, td.deep_decline_reason(tnet)
    return jnet, tnet, js, ts


def _assert_same_spec(js, ts):
    for f in td.DeepSpec._fields:
        a, b = getattr(js, f), getattr(ts, f)
        assert a == b or tuple(a) == tuple(b), (f, a, b)
    assert ts.sides == js.sides and ts.n_flat == js.n_flat, (
        ts.sides, js.sides, ts.n_flat, js.n_flat)


def _weights(jnet, tnet, ts):
    idx = td.deep_layer_idx(tnet)
    assert idx == jd.deep_layer_idx(jnet)
    aw = [[np.asarray(w, np.float32) for w in jnet.allwts0[i]] for i in idx]
    for lj, lt in zip(aw, [tnet.allwts0[i] for i in idx]):
        for a, b in zip(lj, lt):
            np.testing.assert_array_equal(a, b)
    return aw


def _bits(nb, ts, seed):
    """One epoch of noise words from numpy: uint32 for JAX, int32 views for
    the port."""
    rng = np.random.RandomState(seed)
    shapes = [(nb, 1, 8), (nb, tm.fb_lanes(ts), ts.hw),
              (nb, ts.in_ch * B, ts.hw), (nb, B, tm.db_lanes(ts))]
    u = [rng.randint(0, 2**32, s, dtype=np.uint64).astype(np.uint32)
         for s in shapes]
    return u, tuple(torch.tensor(b.view(np.int32)) for b in u)


def _data(nb, img, seed=5):
    rng = np.random.RandomState(seed)
    return (rng.rand(nb, B, img * img).astype(np.float32),
            rng.randint(0, NC, (nb, B)).astype(np.int32))


def _twin_epoch(ts, aw, x, y, bits):
    tp = td.kernel_layout_deep([[torch.tensor(w) for w in lw] for lw in aw],
                               ts)
    assert [tuple(t.shape) for t in tp] == [tuple(s) for s in
                                            td.deep_kernel_shapes(ts)]
    tmo = [torch.zeros_like(t) for t in tp]
    return td.deep_epoch(tp, tmo, torch.tensor(x), torch.tensor(y), bits,
                         0.15, ts)


@pytest.mark.parametrize("case", sorted(CASES) + ["same-even-filter"])
def test_matcher_builds_the_jax_spec(case):
    """The port's matcher takes each geometry into the deep family with the
    JAX package's DeepSpec: modes, strides, mean_tail, sides, n_flat."""
    img, cfgs, mean, elastic = EVEN if case == "same-even-filter" else \
        CASES[case]
    jnet, tnet, js, ts = _specs(_layers(img, cfgs, mean, elastic))
    _assert_same_spec(js, ts)
    assert ts.modes == tuple(c[3] for c in cfgs)
    assert ts.conv_strides == tuple(c[2] for c in cfgs)
    assert ts.mean_tail == mean
    if mean:
        assert ts.n_flat == cfgs[-1][0]
    plan = tm.fused_plan(tnet)
    assert plan is not None and plan.epoch_fn is td.deep_epoch
    assert tm.fused_decline_reason(tnet) is None
    # the levels' conv and pooled sides are the layers' own bookkeeping
    # (a 'full' conv books in+F+1 against the real in+F-1)
    convs = [lyr for lyr in tnet.net_layers if type(lyr).__name__ ==
             "ConvLayer"]
    for conv, (_, _, _, c, _) in zip(convs, ts.levels):
        assert conv.out_sz == c + (2 if conv.mode == "full" else 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_follows_the_jax_kernel(case):
    """3 steps of one epoch on the same data and noise words: costs to rtol
    1e-5, minf and every state tensor to 1e-5."""
    img, cfgs, mean, elastic = CASES[case]
    jnet, tnet, js, ts = _specs(_layers(img, cfgs, mean, elastic))
    aw = _weights(jnet, tnet, ts)
    nb = 3
    x, y = _data(nb, img)
    ub, tb = _bits(nb, ts, 2)
    fn = jd.make_deep_epoch_fn(js, nb, interpret=True)
    kp = [jnp.asarray(t) for t in jd.kernel_layout_deep(aw, js)]
    km = [jnp.zeros_like(t) for t in kp]
    kp, km, jcm = fn(kp, km, jnp.asarray(x), jnp.asarray(y[..., None]),
                     tuple(jnp.asarray(b) for b in ub), 0.15)
    tp, tmo, tcm = _twin_epoch(ts, aw, x, y, tb)
    jcm = np.asarray(jcm)
    np.testing.assert_allclose(tcm.numpy()[:, 0], jcm[:, 0], rtol=1e-5)
    np.testing.assert_allclose(tcm.numpy()[:, 1], jcm[:, 1], rtol=0,
                               atol=1e-5)
    for a, b in zip(list(kp) + list(km), tp + tmo):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)
    moved = max(float(np.abs(b.numpy() - a).max()) for a, b in
                zip(jd.kernel_layout_deep(aw, js), tp))
    assert moved > 1e-3   # the steps trained


def test_even_same_filter_follows_the_per_layer_paths():
    """An even 'same' filter: the twin follows the JAX package's per-layer
    step (lax.conv on the full padding, centre-cropped) over 3 steps, at
    the tolerance of the JAX package's own fused-against-per-layer tests
    (costs 3e-5, weights 1e-4; identity augmentation, no dropout)."""
    img, cfgs, _, _ = EVEN
    jnet, tnet, js, ts = _specs(_layers(img, cfgs, pdrop=0.0))
    _assert_same_spec(js, ts)
    aw = _weights(jnet, tnet, ts)
    nb = 3
    x, y = _data(nb, img, seed=7)
    params, moms = jnet.init_params()
    costs = []
    for s in range(nb):
        params, moms, cost, _, _ = jnet.train_step(
            params, moms, jnp.asarray(x[s].reshape(B, 1, img, img)),
            jnp.asarray(y[s]), key=jnet.base_key, lr=0.15)
        costs.append(float(cost))
    _, tb = _bits(nb, ts, 2)
    tp, _, tcm = _twin_epoch(ts, aw, x, y, tb)
    np.testing.assert_allclose(tcm.numpy()[:, 0], costs, rtol=0, atol=3e-5)
    got = td.framework_layout_deep(tp, ts)
    want = [params[i] for i in td.deep_layer_idx(tnet)]
    for lw, lg in zip(want, got):
        for w, g in zip(lw, lg):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-4)


def test_even_same_filter_follows_the_port_per_layer_trainer():
    """The port's fused Trainer (the twin) against its per-layer Trainer
    (autograd through F.conv2d and the centre crop) on an even 'same'
    filter, 2 epochs of 3 steps at identity augmentation, no dropout."""
    img, cfgs, _, _ = EVEN
    layers = _layers(img, cfgs, pdrop=0.0)
    rng = np.random.RandomState(4)
    x = rng.rand(3 * B, 1, img, img).astype(np.float32)
    y = rng.randint(0, NC, 3 * B).astype(np.int32)
    out = []
    for mode in ("auto", False):
        tr = {"SEED": 3, "BATCH_SZ": B, "MEGAFUSED": mode,
              "INIT_LEARNING_RATE": 0.1, "EPOCHS_TO_HALF_RATE": 1}
        t = Trainer(TorchNet([[n, dict(a)] for n, a in layers], tr), x, y, x,
                    y, device="cpu")
        assert (t._mega is not None) == (mode == "auto")
        _, costs, _ = t.run_epochs(2)
        out.append((costs, t.checkpoint_dict()["allwts"]))
    (fc, fw), (pc, pw) = out
    np.testing.assert_allclose(fc, pc, rtol=0, atol=2e-5)
    for la, lb in zip(fw, pw):
        for a, b in zip(la, lb):
            np.testing.assert_allclose(a, b, rtol=0, atol=5e-5)


@pytest.mark.parametrize("case", ["same-then-stride", "mean-after-same",
                                  "full-l1"])
def test_grad_step_matches_jax_step_kernel(case):
    """One data-parallel step's gradient at a shard of 2 (the plain
    gradient step, which CPU tensors run) against the JAX package's
    make_dp_step_fn(interpret=True), within the twin tolerance (2e-5)."""
    img, cfgs, mean, _ = CASES[case]
    jnet, tnet, js, ts = _specs(_layers(img, cfgs, mean, True))
    aw = _weights(jnet, tnet, ts)
    # the data-parallel paths take the geometry, as the JAX package's does
    assert tdp.dp_decline_reason(ts, 2) is None
    assert jdp.dp_supported(js, 2, False)
    b_loc = 2
    jl, tl = jdp.local_spec(js, b_loc), tdp.local_spec(ts, b_loc)
    rng = np.random.RandomState(6)
    x = rng.rand(b_loc, tl.hw).astype(np.float32)
    y = rng.randint(0, NC, b_loc).astype(np.int32)
    shapes = [(1, 8), (tm.fb_lanes(tl), tl.hw), (b_loc, tl.hw),
              (b_loc, tm.db_lanes(tl))]
    words = [rng.randint(0, 2**32, s, dtype=np.uint64).astype(np.uint32)
             for s in shapes]
    step = jdp.make_dp_step_fn(jl, interpret=True)
    jg, jcost, jminf = step(jnp.asarray(x[None]),
                            jnp.asarray(y[None, :, None]),
                            *(jnp.asarray(w[None]) for w in words),
                            [jnp.asarray(t)
                             for t in jd.kernel_layout_deep(aw, jl)])
    tp = td.kernel_layout_deep([[torch.tensor(w) for w in lw] for lw in aw],
                               tl)
    grads = torch.empty(sum(int(t.numel()) for t in tp))
    cm = torch.empty(2)
    tw = [torch.tensor(w.view(np.int32)) for w in words]
    tdp.grad_step(tl, tdp.constants(tl, "cpu"), torch.tensor(x),
                  torch.tensor(y), (tw[0][0], tw[1], tw[2], tw[3]), tp,
                  grads, cm)
    np.testing.assert_allclose(cm.numpy(), [float(jcost), float(jminf)],
                               rtol=0, atol=2e-5)
    assert len(jg) == len(tp)
    for g, t in zip(jg, tm.split_grads(grads, [tuple(t.shape) for t in tp])):
        np.testing.assert_allclose(t.numpy(), np.asarray(g), rtol=0,
                                   atol=2e-5)
    assert float(grads.abs().max()) > 1e-3


# nets both packages keep per layer, and the word their reasons name
DECLINES = {
    # pool 2 cannot wash a booking gap of 2: ceil(14/2) != ceil(16/2)
    "full-unwashed": ((12, [(3, 3, 1, "full", 2)]), "wash"),
    # no pool: the identity pool washes nothing
    "full-no-pool": ((12, [(3, 3, 1, "full", None)]), "wash"),
    "full-strided": ((12, [(3, 3, 2, "full", 3)]), "stride"),
    # 14 - 4 + 1 = 11 is odd
    "stride-not-dividing": ((14, [(3, 4, 2, "valid", 2)]), "divide"),
}


@pytest.mark.parametrize("case", sorted(DECLINES))
def test_geometry_declines_by_name_in_both_packages(case):
    (img, cfgs), word = DECLINES[case]
    jnet, tnet = _nets(_layers(img, cfgs))
    assert jd.deep_spec_from_net(jnet) is None
    assert jm.fused_plan(jnet) is None
    assert word in jm.fused_decline_reason(jnet)
    assert td.deep_spec_from_net(tnet) is None
    assert tm.fused_plan(tnet) is None
    got = tm.fused_decline_reason(tnet)
    assert word in got and "ConvLayer" in got, got
    assert got == td.deep_decline_reason(tnet)


def test_mnist_same_trainer_follows_the_jax_trainer():
    """mnist_cnn's pattern with both convs 'same' at small width (img 12,
    conv 2 -> 3 maps, hidden 16): the port's Trainer routes it to the deep
    family and follows the JAX package's Trainer (its fused kernel in
    interpret mode) over 2 epochs of 3 steps, identity augmentation and no
    dropout, so the two runs are one function."""
    layers = [["InputLayer", {"img_sz": 12}],
              ["ConvLayer", {"num_maps": 2, "filter_sz": 3, "stride": 1,
                             "mode": "same", "actvn": "relu10"}],
              ["PoolLayer", {"pool_sz": 2}],
              ["ConvLayer", {"num_maps": 3, "filter_sz": 3, "stride": 1,
                             "mode": "same", "actvn": "relu05"}],
              ["PoolLayer", {"pool_sz": 2}],
              ["HiddenLayer", {"n_out": 16, "pdrop": 0.0}],
              ["SoftmaxLayer", {"n_out": NC}]]
    tr = {"SEED": 9876, "BATCH_SZ": B, "INIT_LEARNING_RATE": 0.1,
          "EPOCHS_TO_HALF_RATE": 1}
    rng = np.random.RandomState(8)
    xtr = rng.rand(3 * B, 1, 12, 12).astype(np.float32)
    ytr = rng.randint(0, NC, 3 * B).astype(np.int32)
    xte = rng.rand(2 * B, 1, 12, 12).astype(np.float32)
    yte = rng.randint(0, NC, 2 * B).astype(np.int32)
    jnet = JaxNet([[n, dict(a)] for n, a in layers], dict(tr))
    tnet = TorchNet([[n, dict(a)] for n, a in layers], dict(tr))
    jt = JaxTrainer(jnet, xtr, ytr, xte, yte)
    tt = Trainer(tnet, xtr, ytr, xte, yte, device="cpu")
    assert tt._mega is not None and tt._mega_plan.epoch_fn is td.deep_epoch
    assert tt._mega_spec.modes == ("same", "same")
    for _ in range(2):
        np.testing.assert_allclose(tt.run_epoch()[0], jt.run_epoch()[0],
                                   rtol=1e-5)
        jnet.inc_epoch_set_rate()
        tnet.inc_epoch_set_rate()
    np.testing.assert_allclose(tt.evaluate_full("test"),
                               jt.evaluate_full("test"), atol=1e-4)
