"""The port's deep fused-epoch family against the JAX package's.

Each case builds one layer list in both packages at the same SEED (so the
same initial weights), checks that the port's matcher builds the JAX
package's DeepSpec, and runs the same numpy data and 32-bit noise words
through ``theanet_tpu.ops.megastep_deep.make_deep_epoch_fn(...,
interpret=True)`` and the port's ``deep_epoch`` (its plain PyTorch twin on
CPU tensors). Random pixels keep exact pool ties away, so the two sums'
orders cannot split a tie. The CUDA kernel runs only on a card;
``chip_smoke.py`` holds it to this twin there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from theanet_tpu.model import NeuralNet as JaxNet
from theanet_tpu.ops import megastep as jm
from theanet_tpu.ops import megastep_deep as jd

from theanet_tpu_torch.model import NeuralNet as TorchNet
from theanet_tpu_torch.ops import megastep as tm
from theanet_tpu_torch.ops import megastep_deep as td
from theanet_tpu_torch.ops import megastep_mlp as tmlp
from theanet_tpu_torch.trainer import Trainer

B = 4
R1 = {"L1": 1e-4, "L2": 1e-3, "momentum": 0.9, "rate": 1.0, "maxnorm": 0.9}
R2 = {"L1": 0.0, "L2": 1e-3, "momentum": 0.95, "rate": 0.5, "maxnorm": 0.7}
ELASTIC = {"translation": 2, "zoom": 1.1, "magnitude": 8, "sigma": 3,
           "pflip": 0.03, "angle": 5, "invert_image": True, "nearest": False}


def _conv(maps, filt, actvn="relu10", reg=R1, **kw):
    return ["ConvLayer", {"num_maps": maps, "filter_sz": filt, "stride": 1,
                          "actvn": actvn, "reg": reg, **kw}]


CASES = {
    "one-level-softmax": [
        ["ElasticLayer", dict(img_sz=12, **ELASTIC)],
        _conv(2, 3, "relu05"), ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": 16, "pdrop": 0.5, "reg": R2}],
        ["SoftmaxLayer", {"n_out": 4, "reg": R1}]],
    "two-levels-color-dropout-rbf-learned": [
        ["ColorLayer", {"img_sz": 14, "num_maps": 3, "balance": 1.2,
                        "gamma": 1.2}],
        ["ElasticLayer", dict(ELASTIC, invert_image=False)],
        _conv(2, 3), ["PoolLayer", {"pool_sz": 2}],
        _conv(3, 3, "relu05", R2), ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": 16, "pdrop": 0.5, "reg": R1}],
        ["DropOutLayer", {"pdrop": 0.25}],
        ["CenteredOutLayer", {"n_features": 8, "n_classes": 4, "kind": "RBF",
                              "learn_centers": True, "junk_dist": 50.0,
                              "reg": R1}]],
    "logit-5x5": [
        ["InputLayer", {"img_sz": 13}],
        _conv(3, 5, "tanh"), ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": 16, "pdrop": 0.25, "reg": R2}],
        ["CenteredOutLayer", {"n_features": 8, "n_classes": 4,
                              "kind": "LOGIT", "reg": R1}]],
    # 17 -> 15 (no pool) -> 13 -> ignore_border pool 2 -> 6 -> 5 -> ceil
    # pool 2 -> 3
    "three-levels-identity-and-ignore-border-pools": [
        ["ElasticLayer", dict(img_sz=17, **ELASTIC)],
        _conv(3, 3, "relu05"), _conv(4, 3, "sigmoid", R2),
        ["PoolLayer", {"pool_sz": 2, "ignore_border": True}],
        _conv(3, 2), ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": 12, "pdrop": 0.5, "reg": R2}],
        ["SoftmaxLayer", {"n_out": 4, "reg": R1}]],
    "flat-pre-hidden": [
        ["ElasticLayer", dict(img_sz=10, **dict(ELASTIC, nearest=True))],
        ["HiddenLayer", {"n_out": 12, "pdrop": 0.25, "actvn": "softplus",
                         "reg": R1}],
        ["DropOutLayer", {"pdrop": 0.5}],
        ["HiddenLayer", {"n_out": 10, "pdrop": 0.5, "reg": R2}],
        ["SoftmaxLayer", {"n_out": 4, "reg": R1}]],
    # synth_aux's pattern: a SoftAux head on the conv features
    "softaux": [
        ["ElasticLayer", dict(img_sz=12, **ELASTIC)],
        _conv(3, 3), ["PoolLayer", {"pool_sz": 2}],
        ["SoftAuxLayer", {"n_out": 4, "n_aux": (5, 9), "boost": 1.5,
                          "aux_type": "LocationInfo", "reg": R1}]],
    # AuxConcat -> pre-hidden with dropout (lanes from 1) -> hidden -> nll
    "auxconcat-softmax": [
        ["ElasticLayer", dict(img_sz=12, **ELASTIC)],
        _conv(2, 3, "relu05"), ["PoolLayer", {"pool_sz": 2}],
        ["AuxConcatLayer", {"n_aux": (4, 6), "aux_type": "LocationInfo",
                            "boost": 2}],
        ["HiddenLayer", {"n_out": 12, "pdrop": 0.5, "reg": R2}],
        ["HiddenLayer", {"n_out": 10, "pdrop": 0.25, "reg": R1}],
        ["SoftmaxLayer", {"n_out": 4, "reg": R1}]],
    "hinge": [
        ["ElasticLayer", dict(img_sz=12, **ELASTIC)],
        _conv(2, 3), ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": 16, "pdrop": 0.5, "reg": R2}],
        ["HingeLayer", {"n_out": 4, "reg": R1}]],
    "exploss": [
        ["ElasticLayer", dict(img_sz=12, **ELASTIC)],
        _conv(2, 3, "tanh"), ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": 16, "pdrop": 0.5, "reg": R2}],
        ["ExpLossLayer", {"n_out": 4, "reg": R1}]],
    "nllsq": [
        ["ElasticLayer", dict(img_sz=12, **ELASTIC)],
        _conv(2, 3), ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": 16, "pdrop": 0.5, "reg": R2}],
        ["SoftmaxLayer", {"n_out": 4, "loss": "nllsq", "reg": R1}]],
    "nll90": [
        ["ElasticLayer", dict(img_sz=12, **ELASTIC)],
        _conv(2, 3), ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": 16, "pdrop": 0.5, "reg": R2}],
        ["SoftmaxLayer", {"n_out": 4, "loss": "nll90", "reg": R1}]],
    "flat-hinge": [
        ["ElasticLayer", dict(img_sz=10, **dict(ELASTIC, nearest=True))],
        ["HiddenLayer", {"n_out": 12, "pdrop": 0.5, "reg": R2}],
        ["HingeLayer", {"n_out": 4, "reg": R1}]],
    # the GTSRB column (params/gtsrb_mcdnn.prms) at maps 4/6/8 and hidden
    # 16: an affine-only warp of an RGB input with no ColorLayer, 7x7 then
    # 4x4 valid convs, three pooled levels, no regularisation; 34 -> 28 ->
    # 14 -> 11 -> 6 -> 3 -> 2
    "gtsrb-column": [
        ["ElasticLayer", {"img_sz": 34, "num_maps": 3, "translation": 4.8,
                          "zoom": 1.1, "magnitude": 0, "pflip": 0,
                          "angle": 5, "nearest": True,
                          "invert_image": False}],
        ["ConvLayer", {"num_maps": 4, "filter_sz": 7, "stride": 1,
                       "actvn": "relu01"}],
        ["PoolLayer", {"pool_sz": 2}],
        ["ConvLayer", {"num_maps": 6, "filter_sz": 4, "stride": 1,
                       "actvn": "relu01"}],
        ["PoolLayer", {"pool_sz": 2}],
        ["ConvLayer", {"num_maps": 8, "filter_sz": 4, "stride": 1,
                       "actvn": "relu01"}],
        ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": 16, "actvn": "relu01", "pdrop": 0}],
        ["SoftmaxLayer", {"n_out": 43, "loss": "nll"}]],
}


def _nets(layers, seed=5):
    tr = {"SEED": seed, "BATCH_SZ": B}
    return (JaxNet([[n, dict(a)] for n, a in layers], dict(tr)),
            TorchNet([[n, dict(a)] for n, a in layers], dict(tr)))


def _assert_same_spec(js, ts):
    for f in td.DeepSpec._fields:
        a, b = getattr(js, f), getattr(ts, f)
        assert a == b or tuple(a) == tuple(b), (f, a, b)


def _aux_rows(nb, seed):
    """(nb, B, 4) aux rows (the (B, 2, 2) inputs flattened), two readings
    that differ, so the convex mix's draw matters."""
    return np.random.RandomState(seed).randn(nb, B, 4).astype(np.float32)


def _bits(nb, ts, seed):
    """One epoch of noise words from numpy: uint32 for JAX, int32 views for
    the port, in the port's shapes (which are the JAX package's)."""
    rng = np.random.RandomState(seed)
    shapes = [(nb, 1, 8), (nb, tm.fb_lanes(ts), ts.hw),
              (nb, ts.in_ch * B, ts.hw), (nb, B, tm.db_lanes(ts))]
    u = [rng.randint(0, 2**32, s, dtype=np.uint64).astype(np.uint32)
         for s in shapes]
    return u, tuple(torch.tensor(b.view(np.int32)) for b in u)


@pytest.mark.parametrize("case", sorted(CASES))
def test_deep_twin_matches_jax_kernel(case):
    """3 steps of one epoch: cost and minf to 2e-5, every state tensor to
    1e-5."""
    jnet, tnet = _nets(CASES[case])
    js, ts = jd.deep_spec_from_net(jnet), td.deep_spec_from_net(tnet)
    assert js is not None and ts is not None
    _assert_same_spec(js, ts)
    plan = tm.fused_plan(tnet)
    assert plan.epoch_fn is td.deep_epoch
    idx = td.deep_layer_idx(tnet)
    assert idx == jd.deep_layer_idx(jnet) == plan.layer_idx
    aw = [[np.asarray(w, np.float32) for w in jnet.allwts0[i]] for i in idx]
    for lj, lt in zip(aw, [tnet.allwts0[i] for i in idx]):
        for a, b in zip(lj, lt):
            np.testing.assert_array_equal(a, b)

    nb, C0, HW = 3, ts.in_ch, ts.hw
    rng = np.random.RandomState(1)
    x = rng.rand(nb, B, C0, HW).astype(np.float32)
    y = rng.randint(0, ts.n_classes, (nb, B)).astype(np.int32)
    x_rows = np.ascontiguousarray(x.transpose(0, 2, 1, 3)).reshape(
        nb, C0 * B, HW)
    ub, tb = _bits(nb, ts, 2)

    aux = _aux_rows(nb, 6) if ts.has_aux else None

    fn = jd.make_deep_epoch_fn(js, nb, interpret=True)
    kp = [jnp.asarray(t) for t in jd.kernel_layout_deep(aw, js)]
    km = [jnp.zeros_like(t) for t in kp]
    kp, km, jcm = fn(kp, km, jnp.asarray(x.reshape(nb, B, C0 * HW)),
                     jnp.asarray(y[..., None]),
                     tuple(jnp.asarray(b) for b in ub), 0.1,
                     aux_steps=None if aux is None else jnp.asarray(aux))
    tp = td.kernel_layout_deep([[torch.tensor(w) for w in lw] for lw in aw],
                               ts)
    assert [tuple(t.shape) for t in tp] == [tuple(s) for s in
                                            td.deep_kernel_shapes(ts)]
    tmo = [torch.zeros_like(t) for t in tp]
    tp, tmo, tcm = td.deep_epoch(
        tp, tmo, torch.tensor(x_rows), torch.tensor(y), tb, 0.1, ts,
        aux_steps=None if aux is None else torch.tensor(aux))
    np.testing.assert_allclose(tcm.numpy(), np.asarray(jcm), rtol=0,
                               atol=2e-5)
    assert len(tp) == len(kp)
    for a, b in zip(list(kp) + list(km), tp + tmo):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)
    moved = max(float(np.abs(b.numpy() - a).max()) for a, b in
                zip(jd.kernel_layout_deep(aw, js), tp))
    assert moved > 1e-3   # the steps trained


def test_layouts_roundtrip_and_match_jax():
    for case in ("two-levels-color-dropout-rbf-learned", "logit-5x5",
                 "flat-pre-hidden"):
        jnet, tnet = _nets(CASES[case])
        js, ts = jd.deep_spec_from_net(jnet), td.deep_spec_from_net(tnet)
        idx = td.deep_layer_idx(tnet)
        aw = [[np.asarray(w, np.float32) for w in tnet.allwts0[i]]
              for i in idx]
        want = jd.kernel_layout_deep(aw, js)
        got = td.kernel_layout_deep([[torch.tensor(w) for w in lw]
                                     for lw in aw], ts)
        assert len(got) == len(want) == len(td.deep_reg_kinds(ts))
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert td.deep_reg_kinds(ts) == [
            (td.LayerReg(*r), k) for r, k in jd.deep_reg_kinds(js)]
        back = td.framework_layout_deep(got, ts)
        for lw, lb in zip(aw, back):
            # a frozen-centers head keeps its centers out of the state
            for a, b in zip(lw, lb):
                np.testing.assert_array_equal(b.numpy(), a)


def test_noise_words_follow_the_spec():
    """fb carries 8 rows when a ColorLayer draws, db the final hidden's
    width plus every pre-hidden's (the JAX package's db_lanes)."""
    for case, fb_rows in (("two-levels-color-dropout-rbf-learned", 8),
                          ("flat-pre-hidden", 4)):
        jnet, tnet = _nets(CASES[case])
        ts = td.deep_spec_from_net(tnet)
        assert tm.db_lanes(ts) == jm.db_lanes(jd.deep_spec_from_net(jnet))
        ub, fb, pb, db = tm.epoch_noise_bits(3, 1, ts, 2, "cpu")
        assert tuple(fb.shape) == (2, fb_rows, ts.hw)
        assert tuple(pb.shape) == (2, ts.in_ch * B, ts.hw)
        assert tuple(db.shape) == (2, B, tm.db_lanes(ts))
    assert tm.db_lanes(td.deep_spec_from_net(
        _nets(CASES["flat-pre-hidden"])[1])) == 12 + 10


def test_flagship_noise_words_unchanged():
    """The generalised epoch_noise_bits draws the flagship's words exactly
    as before: ub, fb with 4 rows, pb, db with n_hid lanes, in that order
    from one generator seeded by (seed, epoch)."""
    tnet = TorchNet(
        [["ElasticLayer", dict(img_sz=12, **ELASTIC)], _conv(2, 3),
         ["PoolLayer", {"pool_sz": 2}], _conv(3, 3),
         ["PoolLayer", {"pool_sz": 2}], ["HiddenLayer", {"n_out": 16}],
         ["SoftmaxLayer", {"n_out": 4}]], {"SEED": 1, "BATCH_SZ": B})
    spec = tm.spec_from_net(tnet)
    assert tm.fused_plan(tnet).epoch_fn is tm.megastep_epoch
    got = tm.epoch_noise_bits(7, 3, spec, 2, "cpu")
    state = np.random.SeedSequence([7, 3]).generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(state))
    for t, shape in zip(got, [(2, 1, 8), (2, 4, 144), (2, B, 144),
                              (2, B, 16)]):
        want = torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                             generator=gen)
        assert torch.equal(t, want)


# ---------------------------------------------------------------- routing

def _family(plan):
    return None if plan is None else type(plan.spec).__name__


@pytest.mark.parametrize("layers", [
    CASES["one-level-softmax"],
    # the flagship pattern, with and without an identity ColorLayer
    [["InputLayer", {"img_sz": 12}], _conv(2, 3),
     ["PoolLayer", {"pool_sz": 2}], _conv(3, 3),
     ["PoolLayer", {"pool_sz": 2}], ["HiddenLayer", {"n_out": 8}],
     ["SoftmaxLayer", {"n_out": 4}]],
    [["ColorLayer", {"img_sz": 12, "num_maps": 1}], _conv(2, 3),
     ["PoolLayer", {"pool_sz": 2}], _conv(3, 3),
     ["PoolLayer", {"pool_sz": 2}], ["HiddenLayer", {"n_out": 8}],
     ["SoftmaxLayer", {"n_out": 4}]],
    # the bare flat MLP, and flat nets the MLP family declines
    [["ElasticLayer", dict(img_sz=8, **ELASTIC)],
     ["HiddenLayer", {"n_out": 8}], ["SoftmaxLayer", {"n_out": 3}]],
    [["InputLayer", {"img_sz": 8}], ["HiddenLayer", {"n_out": 8}],
     ["CenteredOutLayer", {"n_features": 4, "n_classes": 3}]],
    CASES["flat-pre-hidden"],
], ids=["deep-1-level", "flagship", "identity-color-flagship", "flat-mlp",
        "flat-centered", "flat-pre-hidden"])
def test_fused_plan_picks_the_jax_family(layers):
    jnet, tnet = _nets(layers)
    assert _family(tm.fused_plan(tnet)) == _family(jm.fused_plan(jnet))
    assert tm.fused_decline_reason(tnet) is None


def _base_net(**conv_kw):
    return TorchNet(
        [["InputLayer", {"img_sz": 12}], _conv(2, 3, **conv_kw),
         ["PoolLayer", {"pool_sz": 2}], ["HiddenLayer", {"n_out": 8}],
         ["SoftmaxLayer", {"n_out": 4}]], {"SEED": 1, "BATCH_SZ": B})


def _with(net, at, layer, replace=False):
    net.net_layers[at:at + int(replace)] = [layer]
    return net


def _mean_net():
    return TorchNet(
        [["InputLayer", {"img_sz": 12}], _conv(2, 3),
         ["PoolLayer", {"pool_sz": 2}], ["MeanLayer", {}],
         ["HiddenLayer", {"n_out": 8}], ["SoftmaxLayer", {"n_out": 4}]],
        {"SEED": 1, "BATCH_SZ": B})


@pytest.mark.parametrize("make,reason", [
    (lambda: _base_net(mode="same"), None),
    (lambda: _base_net(mode="full"), "does not wash"),
    (lambda: _base_net(stride=2), None),
    (_mean_net, None),
    (lambda: _with(_base_net(), 4, _base_net().net_layers[1]),
     "outside the fused grammar"),
], ids=["same", "full", "strided", "mean", "grammar"])
def test_decline_reason_names_the_feature(make, reason):
    """'same', stride 2 (12 - 3 + 1 = 10 divides) and a MeanLayer fuse in
    the deep family; 'full' at img 12 with Pool 2 declines, naming the
    wash (ceil(14/2) != ceil(16/2)), as a layer pattern outside the
    grammar declines, naming it."""
    net = make()
    got = tm.fused_decline_reason(net)
    if reason is None:
        plan = tm.fused_plan(net)
        assert plan is not None and plan.epoch_fn is td.deep_epoch, got
        assert got is None
        return
    assert tm.fused_plan(net) is None
    assert reason in got, got


def _base_layers(head=("SoftmaxLayer", {"n_out": 4})):
    return [["InputLayer", {"img_sz": 12}], _conv(2, 3),
            ["PoolLayer", {"pool_sz": 2}], ["HiddenLayer", {"n_out": 8}],
            [head[0], dict(head[1])]]


def _flat_layers(loss):
    return [["InputLayer", {"img_sz": 8}], ["HiddenLayer", {"n_out": 8}],
            ["SoftmaxLayer", {"n_out": 4, "loss": loss}]]


# the heads and aux layers that the port's deep family declined until it
# took the JAX family's head and aux grammar
NOW_FUSE = {
    "auxconcat": (_base_layers()[:3]
                  + [["AuxConcatLayer", {"n_aux": (5, 9),
                                         "aux_type": "LocationInfo"}]]
                  + _base_layers()[3:]),
    "softaux": (_base_layers()[:3]
                + [["SoftAuxLayer", {"n_out": 4, "n_aux": (5, 9),
                                     "aux_type": "LocationInfo"}]]),
    "hinge": _base_layers(("HingeLayer", {"n_out": 4})),
    "exploss": _base_layers(("ExpLossLayer", {"n_out": 4})),
    "nllsq": _flat_layers("nllsq"),
    "nllT": _flat_layers("nll80"),
}


@pytest.mark.parametrize("name", sorted(NOW_FUSE))
def test_heads_and_aux_layers_now_fuse_as_in_jax(name):
    """Each fuses in the deep family, as in the JAX package, and the port's
    spec is the JAX package's field for field."""
    jnet, tnet = _nets(NOW_FUSE[name])
    plan = tm.fused_plan(tnet)
    assert plan is not None and plan.epoch_fn is td.deep_epoch
    assert tm.fused_decline_reason(tnet) is None
    assert _family(jm.fused_plan(jnet)) == "DeepSpec"
    _assert_same_spec(jd.deep_spec_from_net(jnet), plan.spec)
    assert tm.db_lanes(plan.spec) == jm.db_lanes(jd.deep_spec_from_net(jnet))


# ------------------------------------------------------- the fused trainer

def _identity_trajectories(layers, n_classes):
    """Costs and checkpoints of MEGAFUSED auto (the twin) and False
    (autograd) over 2 epochs: identity augmentation and pdrop 0 make the
    two paths one function."""
    rng = np.random.RandomState(4)
    img = layers[0][1]["img_sz"]
    x = rng.rand(3 * B, 1, img, img).astype(np.float32)
    y = rng.randint(0, n_classes, 3 * B).astype(np.int32)
    out = []
    for mode in ("auto", False):
        tr = {"SEED": 3, "BATCH_SZ": B, "MEGAFUSED": mode,
              "INIT_LEARNING_RATE": 0.1, "EPOCHS_TO_HALF_RATE": 1}
        t = Trainer(TorchNet([[n, dict(a)] for n, a in layers], tr), x, y, x,
                    y, device="cpu")
        assert (t._mega is not None) == (mode == "auto")
        _, costs, minf = t.run_epochs(2)
        out.append((costs, minf, t.checkpoint_dict()["allwts"]))
    return out


@pytest.mark.parametrize("head", ["LOGIT", "RBF"])
def test_fused_trainer_matches_per_layer_at_identity(head):
    """The hand-derived backward of the deep twin (conv level without a
    pool, CenteredOut head with 3 features for 5 classes) against the
    per-layer path's autograd."""
    layers = [["InputLayer", {"img_sz": 9}], _conv(2, 3, "relu05"),
              _conv(2, 2, "tanh", R2), ["PoolLayer", {"pool_sz": 3}],
              ["HiddenLayer", {"n_out": 10, "reg": R2}],
              ["CenteredOutLayer", {"n_features": 3, "n_classes": 5,
                                    "kind": head,
                                    "learn_centers": head == "RBF",
                                    "junk_dist": 5.0, "reg": R1}]]
    (fc, fm, fw), (pc, pm, pw) = _identity_trajectories(layers, 5)
    np.testing.assert_allclose(fc, pc, rtol=0, atol=2e-5)
    np.testing.assert_allclose(fm, pm, rtol=0, atol=2e-5)
    for la, lb in zip(fw, pw):
        assert len(la) == len(lb)
        for a, b in zip(la, lb):
            np.testing.assert_allclose(a, b, rtol=0, atol=5e-5)


def test_centered_labels_index_classes_not_features():
    """A CenteredOut head with fewer features than classes takes every
    class label, rejects labels past n_classes, and its per-layer
    watchdog reads the true-class feature with y clamped to the feature
    width, as the JAX fused head does."""
    layers = [["InputLayer", {"img_sz": 6}], ["HiddenLayer", {"n_out": 6}],
              ["CenteredOutLayer", {"n_features": 3, "n_classes": 5}]]
    x = np.random.RandomState(0).rand(2 * B, 1, 6, 6).astype(np.float32)
    y = np.array([0, 4, 3, 1, 4, 2, 4, 0], np.int32)
    for mode in ("auto", False):
        tr = {"SEED": 3, "BATCH_SZ": B, "MEGAFUSED": mode,
              "INIT_LEARNING_RATE": 0.1, "EPOCHS_TO_HALF_RATE": 1}
        t = Trainer(TorchNet([[n, dict(a)] for n, a in layers], tr), x, y, x,
                    y, device="cpu")
        total, costs, minf = t.run_epoch()
        assert np.isfinite(total) and np.all(np.isfinite(minf))
        with pytest.raises(ValueError, match=r"\[0, 5\)"):
            Trainer(TorchNet([[n, dict(a)] for n, a in layers], tr), x,
                    np.full_like(y, 5), x, y, device="cpu")


def test_wrappers_reject_devices_without_a_kernel():
    jnet, tnet = _nets(CASES["logit-5x5"])
    ts = td.deep_spec_from_net(tnet)
    x = torch.zeros((1, B, ts.hw), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        td.deep_epoch([], [], x, x, (x, x, x, x), 0.1, ts)
    mspec = tmlp.mlp_spec_from_net(_nets(
        [["InputLayer", {"img_sz": 8}], ["HiddenLayer", {"n_out": 8}],
         ["SoftmaxLayer", {"n_out": 3}]])[1])
    with pytest.raises(ValueError, match="no kernel"):
        tmlp.mlp_epoch([], [], x, x, (x, x, x, x), 0.1, mspec)
