"""The port's fused-epoch twin against the JAX package's Pallas kernel.

numpy makes the data and the 32-bit noise words from a seed and hands the
same values to ``theanet_tpu.ops.megastep.make_epoch_fn(..., interpret=True)``
and to ``theanet_tpu_torch.ops.megastep.megastep_epoch`` (which runs its
plain PyTorch twin for CPU tensors). The CUDA kernel itself runs only on a
card; ``chip_smoke.py`` holds it to this twin there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from theanet_tpu.model import NeuralNet as JaxNet
from theanet_tpu.ops import megastep as jm

from theanet_tpu_torch.model import NeuralNet as TorchNet
from theanet_tpu_torch.ops import megastep as tm
from theanet_tpu_torch.trainer import Trainer

B, IMG, FILT, M1, M2, NH, NC = 4, 12, 3, 2, 3, 16, 4
REGS = [dict(L1=0.0, L2=1e-3, momentum=0.95, rate=1.0, maxnorm=0.9),
        dict(L1=0.0, L2=0.0, momentum=0.95, rate=1.0, maxnorm=0.0),
        dict(L1=1e-4, L2=0.0, momentum=0.9, rate=1.0, maxnorm=0.7),
        dict(L1=0.0, L2=0.0, momentum=0.95, rate=0.5, maxnorm=0.8)]
FULL_AUG = dict(translation=2, zoom=1.1, magnitude=8, sigma=3, pflip=0.03,
                angle=5, invert=True)


def _specs(**kw):
    base = dict(batch=B, img=IMG, filt1=FILT, filt2=FILT, maps1=M1, maps2=M2,
                n_hid=NH, n_out=NC, slope1=0.05, slope2=0.10, slope_h=0.01,
                pdrop=0.0, translation=0, zoom=1, magnitude=0, sigma=1,
                pflip=0.0, angle=0, invert=False, nearest=False)
    base.update(kw)
    js = jm.MegaSpec(reg1=jm.LayerReg(**REGS[0]), reg2=jm.LayerReg(**REGS[1]),
                     reg_h=jm.LayerReg(**REGS[2]), reg_o=jm.LayerReg(**REGS[3]),
                     **base)
    ts = tm.MegaSpec(reg1=tm.LayerReg(**REGS[0]), reg2=tm.LayerReg(**REGS[1]),
                     reg_h=tm.LayerReg(**REGS[2]), reg_o=tm.LayerReg(**REGS[3]),
                     **base)
    return js, ts


def _weights(ts, seed=0):
    rng = np.random.RandomState(seed)
    F1, F2 = ts.filt1, ts.filt2
    return [[rng.randn(ts.maps1, ts.in_ch, F1, F1).astype(np.float32) * .5,
             rng.randn(ts.maps1).astype(np.float32) * .1],
            [rng.randn(ts.maps2, ts.maps1, F2, F2).astype(np.float32) * .3,
             rng.randn(ts.maps2).astype(np.float32) * .1],
            [rng.randn(ts.n_flat, NH).astype(np.float32) * .2,
             rng.randn(NH).astype(np.float32) * .1],
            [rng.randn(NH, NC).astype(np.float32) * .3,
             rng.randn(NC).astype(np.float32) * .1]]


def _bits(nb, ts, seed):
    """One epoch of noise words from numpy, as (uint32 for JAX, int32 views
    in the port's shapes)."""
    rng = np.random.RandomState(seed)
    shapes = [(nb, 1, 8), (nb, 4, ts.hw), (nb, ts.in_ch * B, ts.hw),
              (nb, B, NH)]
    u = [rng.randint(0, 2**32, s, dtype=np.uint64).astype(np.uint32)
         for s in shapes]
    return u, tuple(torch.tensor(b.view(np.int32)) for b in u)


def _run_both(js, ts, nb, n_epochs, seed=1):
    rng = np.random.RandomState(seed)
    C0, HW = ts.in_ch, ts.hw
    x = rng.rand(nb, B, C0, HW).astype(np.float32)   # natural (n, C, H, W)
    y = rng.randint(0, NC, (nb, B)).astype(np.int32)
    x_rows = np.ascontiguousarray(x.transpose(0, 2, 1, 3)).reshape(
        nb, C0 * B, HW)                              # the port's c*B + b rows
    aw = _weights(ts, seed)
    fn = jm.make_epoch_fn(js, nb, interpret=True)
    kp = [jnp.asarray(t) for t in jm.params_to_kernel(aw, js)]
    km = [jnp.zeros_like(t) for t in kp]
    tp = tm.kernel_layout([[torch.tensor(w) for w in l] for l in aw], ts)
    tmo = [torch.zeros_like(t) for t in tp]
    jc, tc = [], []
    for e in range(n_epochs):
        ub, tb = _bits(nb, ts, seed * 100 + e)
        lr = 0.1 / (1 + e)
        kp, km, cm = fn(kp, km, jnp.asarray(x), jnp.asarray(y[..., None]),
                        tuple(jnp.asarray(b) for b in ub), lr)
        jc.append(np.asarray(cm))
        tp, tmo, tcm = tm.megastep_epoch(tp, tmo, torch.tensor(x_rows),
                                         torch.tensor(y), tb, lr, ts)
        tc.append(tcm.numpy())
    return (np.concatenate(jc), np.concatenate(tc), (kp, km), (tp, tmo))


def _assert_state(jstate, tstate, atol):
    for a, b in zip(jstate[0] + jstate[1], tstate[0] + tstate[1]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=atol)


def test_layout_roundtrip_matches_jax():
    js, ts = _specs()
    aw = _weights(ts)
    want = jm.params_to_kernel(aw, js)
    got = tm.kernel_layout([[torch.tensor(w) for w in l] for l in aw], ts)
    assert [tuple(t.shape) for t in got] == tm.kernel_shapes(ts)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), a)
    back = tm.framework_layout(got, ts)
    for lw, lb in zip(aw, back):
        for a, b in zip(lw, lb):
            np.testing.assert_array_equal(b.numpy(), a)


def test_identity_aug_twin_matches_jax_kernel():
    """2 epochs x 3 steps, identity augmentation, L1/L2/max-norm — the
    tolerances of tests/test_megastep.py's framework-vs-kernel gate."""
    js, ts = _specs()
    jc, tc, js_, ts_ = _run_both(js, ts, nb=3, n_epochs=2)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=2e-5)
    _assert_state(js_, ts_, 5e-5)


@pytest.mark.parametrize("nearest", [True, False])
def test_full_aug_dropout_twin_matches_jax_kernel(nearest):
    """Every augmentation stage plus pdrop .5 driven by the same words.
    Measured agreement is ~1e-6 in cost; 2e-5 holds with margin."""
    js, ts = _specs(nearest=nearest, pdrop=0.5, **FULL_AUG)
    jc, tc, js_, ts_ = _run_both(js, ts, nb=3, n_epochs=1, seed=2)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=2e-5)
    _assert_state(js_, ts_, 5e-5)


# the options the flagship kernel takes beyond mnist_cnn's own config
SPEC_VARIANTS = {
    "smooth-acts-bilinear": dict(act1="tanh", act2="sigmoid",
                                 act_h="scaled_tanh", pdrop=0.5, **FULL_AUG),
    "softplus-ignore-border": dict(img=13, act_h="softplus", ib1=True,
                                   ib2=True, nearest=True, **FULL_AUG),
    "3-channel-nearest": dict(img=10, in_ch=3, nearest=True, pdrop=0.5,
                              **FULL_AUG),
    "filt5-pool3": dict(img=15, filt1=5, pool1=3, maps1=3, maps2=5),
}


@pytest.mark.parametrize("variant", sorted(SPEC_VARIANTS))
def test_spec_variants_twin_matches_jax_kernel(variant):
    """Activation kinds, ignore_border pools, several input channels and
    other filter/pool sizes: one epoch of 3 steps against the JAX kernel."""
    js, ts = _specs(**SPEC_VARIANTS[variant])
    jc, tc, js_, ts_ = _run_both(js, ts, nb=3, n_epochs=1, seed=3)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=2e-5)
    _assert_state(js_, ts_, 5e-5)


def test_warp_matches_jax_replica_formulas():
    """The twin's warp field against the documented formulas in float64
    (the replica of tests/test_megastep.py)."""
    from tests.test_megastep import _warp_replica

    js, ts = _specs(**FULL_AUG)
    ub, tb = _bits(1, ts, 5)
    gh, gw = tm.smoothing_factors(ts, "cpu")
    ty, tx = tm.warp_field(ts, tb[0][0, 0], tb[1][0], gh, gw)
    rty, rtx = _warp_replica(js, ub[0][0, 0], ub[1][0].T)
    np.testing.assert_allclose(ty.numpy(), rty, atol=1e-4)
    np.testing.assert_allclose(tx.numpy(), rtx, atol=1e-4)


def test_noise_bits_shapes_and_determinism():
    _, ts = _specs(pdrop=0.5)
    a = tm.epoch_noise_bits(5, 2, ts, 3, "cpu")
    b = tm.epoch_noise_bits(5, 2, ts, 3, "cpu")
    c = tm.epoch_noise_bits(5, 3, ts, 3, "cpu")
    assert [tuple(t.shape) for t in a] == [(3, 1, 8), (3, 4, IMG * IMG),
                                          (3, B, IMG * IMG), (3, B, NH)]
    assert all(t.dtype == torch.int32 for t in a)
    assert all(torch.equal(s, t) for s, t in zip(a, b))
    assert not torch.equal(a[3], c[3])
    u = (a[2] & 0xFFFFFF).double() / (1 << 24)     # uniform low 24 bits
    assert 0.45 < float(u.mean()) < 0.55


def test_wrapper_rejects_devices_without_a_kernel():
    js, ts = _specs()
    tp = tm.kernel_layout([[torch.tensor(w) for w in l]
                           for l in _weights(ts)], ts)
    x = torch.zeros((1, B, IMG * IMG), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tm.megastep_epoch(tp, tp, x, x, (x, x, x, x), 0.1, ts)


def _flag_layers(first="InputLayer", maps1=M1, conv_mode="valid"):
    return [[first, {"img_sz": IMG}],
            ["ConvLayer", {"num_maps": maps1, "filter_sz": 3, "stride": 1,
                           "mode": conv_mode, "actvn": "relu10"}],
            ["PoolLayer", {"pool_sz": 2}],
            ["ConvLayer", {"num_maps": M2, "filter_sz": 3, "stride": 1,
                           "actvn": "relu05"}],
            ["PoolLayer", {"pool_sz": 2}],
            ["HiddenLayer", {"n_out": NH, "pdrop": 0.5}],
            ["SoftmaxLayer", {"n_out": NC}]]


def test_matcher_builds_the_jax_spec():
    tr = {"SEED": 3, "BATCH_SZ": B}
    jspec = jm.spec_from_net(JaxNet(_flag_layers("ElasticLayer"), dict(tr)))
    tspec = tm.spec_from_net(TorchNet(_flag_layers("ElasticLayer"), dict(tr)))
    for f in tm.MegaSpec._fields:
        want = getattr(jspec, f)
        got = getattr(tspec, f)
        assert tuple(got) == tuple(want) if f.startswith("reg") else \
            got == want, f


def test_megafused_true_raises_with_reason():
    tr = {"SEED": 3, "BATCH_SZ": B, "MEGAFUSED": True, "CUR_EPOCH": 0,
          "INIT_LEARNING_RATE": 0.1, "EPOCHS_TO_HALF_RATE": 1}
    # a 'full' conv whose pool 2 cannot wash the reference's in+F+1
    # booking: no family takes it
    net = TorchNet(_flag_layers(conv_mode="full"), tr)
    x = np.zeros((2 * B, 1, IMG, IMG), np.float32)
    y = np.zeros(2 * B, np.int32)
    with pytest.raises(ValueError, match="mode='full'.*wash"):
        Trainer(net, x, y, x, y, device="cpu")
    tr["MEGAFUSED"] = "auto"
    assert Trainer(net, x, y, x, y, device="cpu")._mega is None
    fused = Trainer(TorchNet(_flag_layers(), dict(tr)), x, y, x, y,
                    device="cpu")
    assert fused._mega is not None


def test_fused_trainer_matches_per_layer_at_identity():
    """MEGAFUSED auto (the twin on the CPU) and MEGAFUSED False (autograd)
    train the same trajectory at identity augmentation, pdrop 0."""
    rng = np.random.RandomState(4)
    x = rng.rand(3 * B, 1, IMG, IMG).astype(np.float32)
    y = rng.randint(0, NC, 3 * B).astype(np.int32)
    layers = _flag_layers()
    layers[5][1]["pdrop"] = 0
    out = []
    for mode in ("auto", False):
        tr = {"SEED": 3, "BATCH_SZ": B, "MEGAFUSED": mode,
              "INIT_LEARNING_RATE": 0.1, "EPOCHS_TO_HALF_RATE": 1}
        t = Trainer(TorchNet([list(l) for l in layers], tr), x, y, x, y,
                    device="cpu")
        assert (t._mega is not None) == (mode == "auto")
        totals, costs, _ = t.run_epochs(2)
        out.append((costs, t.checkpoint_dict()["allwts"]))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=0, atol=2e-5)
    for la, lb in zip(out[0][1], out[1][1]):
        for a, b in zip(la, lb):
            np.testing.assert_allclose(a, b, rtol=0, atol=5e-5)


def test_snapshot_restore_replays_the_fused_trajectory():
    rng = np.random.RandomState(5)
    x = rng.rand(2 * B, 1, IMG, IMG).astype(np.float32)
    y = rng.randint(0, NC, 2 * B).astype(np.int32)
    tr = {"SEED": 3, "BATCH_SZ": B, "INIT_LEARNING_RATE": 0.1,
          "EPOCHS_TO_HALF_RATE": 1}
    t = Trainer(TorchNet(_flag_layers("ElasticLayer"), tr), x, y, x, y,
                device="cpu")
    snap = t.snapshot_state()
    first = t.run_epochs(2)[1]
    t.restore_state(snap)
    again = t.run_epochs(2)[1]
    np.testing.assert_array_equal(first, again)


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setenv("THEANET_TORCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from theanet_tpu_torch.device import default_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()
    tr = {"SEED": 3, "BATCH_SZ": B, "INIT_LEARNING_RATE": 0.1,
          "EPOCHS_TO_HALF_RATE": 1}
    x = np.zeros((2 * B, 1, IMG, IMG), np.float32)
    y = np.zeros(2 * B, np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TorchNet(_flag_layers(), tr), x, y, x, y)


def test_twin_flips_take_the_kink_from_the_other_side():
    """megastep_epoch_reference's ``flips`` (chip_smoke.py's resolution of
    a hidden pre-activation that sum orders round to either side of the
    leaky kink): with one pre-activation moved onto 0, the flipped unit
    gives the step of that pre-activation 1e-3 across 0 (within 1e-4: the
    shift itself moves the momenta ~1e-5), the unflipped twin a step 1e-3
    or more away; an all-False mask changes no bit."""
    _, ts = _specs()
    p = tm.kernel_layout([[torch.tensor(w) for w in l]
                          for l in _weights(ts)], ts)
    m = [torch.zeros_like(t) for t in p]
    rng = np.random.RandomState(7)
    x = torch.tensor(rng.rand(1, B, ts.hw).astype(np.float32))
    y = torch.tensor(rng.randint(0, NC, (1, B)).astype(np.int32))
    bits = _bits(1, ts, 7)[1]
    gh, gw = tm.smoothing_factors(ts, torch.device("cpu"))

    def z3_of(params):
        return tm.forward_to_hidden(ts, x[0], bits[0][0, 0], bits[1][0],
                                    bits[2][0], params, gh, gw)[-1]

    b, j, delta = 1, 0, 1e-3
    p[5][0, j] -= z3_of(p)[b, j]
    z3 = z3_of(p)
    assert abs(float(z3[b, j])) < 1e-6
    others = torch.cat([z3[:b, j], z3[b + 1:, j]])
    assert float(others.abs().min()) > 10 * delta
    across = [t.clone() for t in p]
    across[5][0, j] += -delta if z3[b, j] > 0 else delta
    mask = torch.zeros((1, B, NH), dtype=torch.bool)
    mask[0, b, j] = True

    def moms(params, flips=None):
        return tm.megastep_epoch_reference(params, m, x, y, bits, 0.1, ts,
                                           flips=flips)[1]

    want = moms(across)
    d_flip = max(float((u - v).abs().max())
                 for u, v in zip(moms(p, mask), want))
    d_plain = max(float((u - v).abs().max()) for u, v in zip(moms(p), want))
    assert d_flip < 1e-4 and d_plain > 1e-3, (d_flip, d_plain)
    for u, v in zip(moms(p, torch.zeros_like(mask)), moms(p)):
        assert torch.equal(u, v)
