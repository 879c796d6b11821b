"""The port's 3x3 conv (``ops/conv3x3.py``) against the JAX package's, on
the CPU.

The plain forward and backward against ``conv_pallas.py``'s Pallas kernels
in interpret mode, f32 and bf16, at the shapes of test_conv_pallas.py and
at the wide model's conv2 widths; ``eligible`` against the JAX predicate;
the routed ConvLayer against its own ``F.conv2d`` path and against the JAX
routed layer; the wrapper's device and shape rules; and one train_step of a
narrow copy of bench.py's wide model with THEANET_PALLAS_CONV=1 in both
packages.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from theanet_tpu.layers import ConvLayer as JaxConvLayer
from theanet_tpu.model import NeuralNet as JaxNet
from theanet_tpu.ops import conv_pallas as jcp

from theanet_tpu_torch.layers import ConvLayer
from theanet_tpu_torch.model import NeuralNet as TorchNet
from theanet_tpu_torch.ops import conv3x3 as tcv

import chip_smoke

# (B, C, H, M): test_conv_pallas.py's forward shapes, its B = 6 and VJP
# shapes, and the wide model's conv2 widths (64 -> 128 maps at 27x27)
SHAPES = [(4, 16, 9, 8), (2, 32, 12, 16), (8, 8, 27, 8), (6, 16, 9, 8),
          (4, 16, 11, 8), (2, 64, 27, 128)]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# f32: the two packages sum in other orders (1e-5 forward, 1e-4 for the
# VJP's longer sums); bf16: both round one f32 sum to bf16, at most an ulp
# apart (test_conv_pallas.py:70-71)
FWD_TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
           "bf16": dict(rtol=2e-2, atol=2e-2)}
VJP_TOL = {"f32": dict(rtol=1e-4, atol=1e-4),
           "bf16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one intra-op thread: the suite runs several workers at
    once, and PyTorch's CPU thread pools contending for the same cores slow
    these many-small-op tests by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(B, C, H, M, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, C, H, H).astype(np.float32)
    w = (rng.randn(M, C, 3, 3) * 0.2).astype(np.float32)
    dz = rng.randn(B, M, H - 2, H - 2).astype(np.float32)
    return x, w, dz


def _both(a, dt):
    """numpy f32 -> (torch, jax) arrays of one dtype (both round to
    nearest even, so the bf16 values are the same)."""
    return torch.tensor(a).to(DTYPES[dt][0]), jnp.asarray(a, DTYPES[dt][1])


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax_kernel(shape, dt):
    x, w, _ = _data(*shape)
    (tx, jx), (tw, jw) = _both(x, dt), _both(w, dt)
    got = tcv.conv3x3_forward_reference(tx, tw)
    assert got.dtype == DTYPES[dt][0]
    assert tuple(got.shape) == (shape[0], shape[3], shape[2] - 2,
                                shape[2] - 2)
    np.testing.assert_allclose(_np(got), _np(jcp.conv3x3_valid(jx, jw)),
                               **FWD_TOL[dt])


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_vjp_matches_jax_kernel(shape, dt):
    x, w, dz = _data(*shape, seed=3)
    (tx, jx), (tw, jw), (tdz, jdz) = _both(x, dt), _both(w, dt), _both(dz, dt)
    dx, dw = tcv.conv3x3_backward_reference(tx, tw, tdz)
    _, vjp = jax.vjp(jcp.conv3x3_valid, jx, jw)
    jdx, jdw = vjp(jdz)
    assert dx.dtype == dw.dtype == DTYPES[dt][0]
    np.testing.assert_allclose(_np(dx), _np(jdx), **VJP_TOL[dt])
    np.testing.assert_allclose(_np(dw), _np(jdw), **VJP_TOL[dt])


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_autograd_matches_conv2d(shape):
    """conv3x3_valid on the CPU: the value and both gradients of F.conv2d
    (a correlation) in f32."""
    x, w, dz = _data(*shape, seed=5)
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    rx = torch.tensor(x, requires_grad=True)
    rw = torch.tensor(w, requires_grad=True)
    out = tcv.conv3x3_valid(tx, tw)
    ref = F.conv2d(rx, rw)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    out.backward(torch.tensor(dz))
    ref.backward(torch.tensor(dz))
    np.testing.assert_allclose(tx.grad.numpy(), rx.grad.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), rw.grad.numpy(), rtol=1e-4,
                               atol=1e-4)


ELIGIBLE_CASES = [
    ((256, 64, 27, 27), (128, 64, 3, 3), "valid", 1),
    ((256, 1, 56, 56), (64, 1, 3, 3), "valid", 1),     # C < 16
    ((256, 64, 27, 27), (128, 64, 3, 3), "full", 1),
    ((256, 64, 27, 27), (128, 64, 3, 3), "valid", 2),
    ((256, 64, 27, 27), (128, 64, 5, 5), "valid", 1),
    ((4, 24, 9, 9), (8, 24, 3, 3), "valid", 1),
    ((4, 20, 9, 9), (8, 20, 3, 3), "valid", 1),        # C % 8
    ((4, 16, 9, 9), (12, 16, 3, 3), "valid", 1),       # M % 8
    ((4, 16, 9, 8), (8, 16, 3, 3), "valid", 1),        # not square
    ((4, 16, 2, 2), (8, 16, 3, 3), "valid", 1),        # H < 3
]


@pytest.mark.parametrize("case", ELIGIBLE_CASES)
def test_eligible_is_the_jax_predicate(case):
    assert tcv.eligible(*case) == jcp.eligible(*case)


def _conv_layer(C=16, H=11, M=8, actvn="relu10"):
    rng = np.random.RandomState(2)
    args = (None, rng, 4, C, H)
    kw = dict(num_maps=M, filter_sz=3, stride=1, actvn=actvn)
    jl = JaxConvLayer(*args, **kw)
    tl = ConvLayer(None, np.random.RandomState(2), 4, C, H, **kw)
    x = np.random.RandomState(4).rand(4, C, H, H).astype(np.float32)
    return jl, tl, x


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_convlayer_routed_matches_unrouted(monkeypatch, dt):
    """The port's ConvLayer with THEANET_PALLAS_CONV=1 against its own
    F.conv2d path: the filter flip, the bias and the activation
    (test_conv_pallas.py:85-101)."""
    _, tl, x = _conv_layer()
    cd = DTYPES[dt][0]
    wts = [torch.tensor(p).to(cd) for p in tl.params_init]
    tx = torch.tensor(x).to(cd)
    monkeypatch.setenv("THEANET_PALLAS_CONV", "0")
    ref = tl.apply(wts, tx, train=True)
    monkeypatch.setenv("THEANET_PALLAS_CONV", "1")
    got = tl.apply(wts, tx, train=True)
    assert got.dtype == cd
    np.testing.assert_allclose(_np(got), _np(ref), **FWD_TOL[dt])


def test_convlayer_routed_matches_jax_routed(monkeypatch):
    jl, tl, x = _conv_layer(C=16, H=9, M=16, actvn="relu05")
    monkeypatch.setenv("THEANET_PALLAS_CONV", "1")
    ref = jl.apply([jnp.asarray(p) for p in jl.params_init], jnp.asarray(x),
                   key=jax.random.PRNGKey(0), train=True)
    got = tl.apply([torch.tensor(p) for p in tl.params_init],
                   torch.tensor(x), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_convlayer_ineligible_stays_on_conv2d(monkeypatch):
    """C < 16 keeps F.conv2d under the switch: no kernel wrapper runs."""
    from theanet_tpu_torch.ops import conv3x3

    _, tl, x = _conv_layer(C=8, H=9, M=8)
    wts = [torch.tensor(p) for p in tl.params_init]
    calls = []
    monkeypatch.setattr(conv3x3, "conv3x3_forward",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("THEANET_PALLAS_CONV", "1")
    tl.apply(wts, torch.tensor(x), train=True)
    assert calls == []


def test_wrappers_run_plain_on_cpu_and_count_nothing():
    x, w, dz = (torch.tensor(a) for a in _data(2, 16, 9, 8))
    n = (tcv.conv3x3_forward.launches, tcv.conv3x3_backward.launches)
    assert torch.equal(tcv.conv3x3_forward(x, w),
                       tcv.conv3x3_forward_reference(x, w))
    got = tcv.conv3x3_backward(x, w, dz)
    ref = tcv.conv3x3_backward_reference(x, w, dz)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert (tcv.conv3x3_forward.launches,
            tcv.conv3x3_backward.launches) == n


@pytest.mark.parametrize("bad", ["w_shape", "dtype", "mixed", "dz_shape",
                                 "not_square", "int"])
def test_wrappers_raise_on_what_the_kernel_does_not_take(bad):
    x, w, dz = (torch.tensor(a) for a in _data(2, 16, 9, 8))
    if bad == "w_shape":
        w = w[:, :, :2, :2]
    elif bad == "dtype":
        x, w, dz = x.double(), w.double(), dz.double()
    elif bad == "mixed":
        w = w.to(torch.bfloat16)
    elif bad == "dz_shape":
        dz = dz[:, :, 1:]
    elif bad == "not_square":
        x = x[:, :, :, 1:]
    else:
        x, w, dz = x.int(), w.int(), dz.int()
    with pytest.raises(ValueError):
        tcv.conv3x3_backward(x, w, dz)
    if bad != "dz_shape":
        with pytest.raises(ValueError):
            tcv.conv3x3_forward(x, w)


def test_wrappers_raise_on_a_device_without_a_kernel():
    x, w, dz = (torch.tensor(a).to("meta") for a in _data(2, 16, 9, 8))
    with pytest.raises(ValueError, match="no kernel"):
        tcv.conv3x3_forward(x, w)
    with pytest.raises(ValueError, match="no kernel"):
        tcv.conv3x3_backward(x, w, dz)


# a narrow copy of bench.py's wide model (wide_model_row): conv2 is 16 ->
# 16 maps, which the kernel takes, pdrop 0 so no draw enters
NARROW_B = 8
# Relative L2 bounds, per tensor, on a step's move and momenta against the
# JAX package's. f32: the two sum in other orders (3e-6 measured). bf16:
# both bodies round at the same points, so the forward and the cost agree
# to f32 rounding, but JAX's bf16 backward on the CPU sits 3-6% from the
# f32 gradient where the port's sits under 1% (measured at the hidden
# layer), and the two differ by up to 6%. A zero, sign-flipped or
# misrouted gradient is off by 1 or more.
STEP_REL = {None: 1e-4, "bfloat16": 0.1}


def narrow_wide_spec(dtype):
    layers, tr = chip_smoke.wide_spec(dtype, img=16, batch=NARROW_B,
                                      maps=(16, 16), n_hid=32, n_out=10,
                                      pdrop=0)
    tr["MEGAFUSED"] = False
    return layers, tr


def narrow_wide_data():
    rng = np.random.RandomState(0)
    x = rng.rand(NARROW_B, 1, 16, 16).astype(np.float32)
    y = rng.randint(0, 10, NARROW_B).astype(np.int32)
    return x, y


def _rel_l2(got, ref):
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_narrow_wide_train_step_matches_jax(monkeypatch, dtype):
    """Two steps in both packages (the first moves only the momenta): the
    costs, then each tensor's move and momentum."""
    monkeypatch.setenv("THEANET_PALLAS_CONV", "1")
    x, y = narrow_wide_data()
    jnet = JaxNet(*narrow_wide_spec(dtype))
    tnet = TorchNet(*narrow_wide_spec(dtype))
    jp0, jm = jnet.init_params()
    tp0, tm = tnet.init_params("cpu")
    calls = []
    real = tcv.conv3x3_backward
    monkeypatch.setattr(tcv, "conv3x3_backward",
                        lambda *a: calls.append(1) or real(*a))
    jp, tp = jp0, tp0
    for _ in range(2):
        jp, jm, jc, _, _ = jnet.train_step(jp, jm, jnp.asarray(x),
                                           jnp.asarray(y),
                                           key=jnet.base_key, lr=0.05)
        tp, tm, tc, _, _ = tnet.train_step(tp, tm, torch.tensor(x),
                                           torch.tensor(y), lr=0.05)
        np.testing.assert_allclose(float(tc), float(jc), rtol=1e-5)
    assert calls == [1, 1], "conv2 did not go through ops.conv3x3"
    for lj0, lj, lt, lmj, lmt in zip(jp0, jp, tp, jm, tm):
        for a0, a, b, ma, mb in zip(lj0, lj, lt, lmj, lmt):
            assert b.dtype == mb.dtype == torch.float32
            if b.numel() == 0:
                continue
            a0 = np.asarray(a0)
            move_j = np.asarray(a) - a0
            assert np.abs(move_j).max() > 0
            assert _rel_l2(b.numpy() - a0, move_j) <= STEP_REL[dtype]
            assert _rel_l2(mb.numpy(), np.asarray(ma)) <= STEP_REL[dtype]


def test_narrow_wide_bf16_step_routed_matches_unrouted(monkeypatch):
    """The port's bf16 step with conv2 on ops.conv3x3 against the same step
    on F.conv2d: both round the conv once from an f32 sum, so only rounding
    straddles tell them apart (2e-3 relative L2 measured on the momenta,
    6.4e-5 on the cost)."""
    x, y = narrow_wide_data()
    out = {}
    for on in ("1", "0"):
        monkeypatch.setenv("THEANET_PALLAS_CONV", on)
        net = TorchNet(*narrow_wide_spec("bfloat16"))
        p, m = net.init_params("cpu")
        for _ in range(2):
            p, m, c, _, _ = net.train_step(p, m, torch.tensor(x),
                                           torch.tensor(y), lr=0.05)
        out[on] = (m, float(c))
    assert abs(out["1"][1] - out["0"][1]) <= 2e-4
    for la, lb in zip(out["1"][0], out["0"][0]):
        for a, b in zip(la, lb):
            if b.numel():
                assert _rel_l2(a.numpy(), b.numpy()) <= 1e-2
