"""The port's flat-MLP fused-epoch family against the JAX package's.

One layer list built in both packages at the same SEED; the port's matcher
must build the JAX package's MlpSpec, and the same numpy data and 32-bit
noise words go through ``theanet_tpu.ops.megastep_mlp.make_mlp_epoch_fn(...,
interpret=True)`` and the port's ``mlp_epoch`` (its plain twin on CPU
tensors: the deep twin at a zero-level spec). ``chip_smoke.py`` holds the
CUDA kernel to the twin on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from theanet_tpu.model import NeuralNet as JaxNet
from theanet_tpu.ops import megastep_mlp as jmlp

from theanet_tpu_torch.model import NeuralNet as TorchNet
from theanet_tpu_torch.ops import megastep as tm
from theanet_tpu_torch.ops import megastep_deep as td
from theanet_tpu_torch.ops import megastep_mlp as tmlp
from theanet_tpu_torch.trainer import Trainer

B = 4
R1 = {"L1": 0.0, "L2": 1e-3, "momentum": 0.95, "rate": 1.0, "maxnorm": 0.0}
R2 = {"L1": 1e-4, "L2": 0.0, "momentum": 0.9, "rate": 0.5, "maxnorm": 0.8}
AUG = {"translation": 2, "zoom": 1.1, "magnitude": 8, "sigma": 3,
       "pflip": 0.03, "angle": 5, "invert_image": True}

CASES = {
    # flat_mlp's own options: nearest, invert, pdrop .5, L2 on the hidden
    "nearest-invert-l2": (1, [
        ["ElasticLayer", dict(img_sz=12, nearest=True, **AUG)],
        ["HiddenLayer", {"n_out": 24, "pdrop": 0.5, "actvn": "relu10",
                         "reg": R1}],
        ["SoftmaxLayer", {"n_out": 5, "reg": R2}]]),
    "3-channel-bilinear-maxnorm": (3, [
        ["ElasticLayer", dict(img_sz=10, num_maps=3, nearest=False, **AUG)],
        ["HiddenLayer", {"n_out": 16, "pdrop": 0.25, "actvn": "tanh",
                         "reg": R2}],
        ["SoftmaxLayer", {"n_out": 4, "reg": R1}]]),
    "plain-input": (1, [
        ["InputLayer", {"img_sz": 9}],
        ["HiddenLayer", {"n_out": 12, "reg": R2}],
        ["SoftmaxLayer", {"n_out": 3, "reg": R1}]]),
}


def _nets(layers, seed=7):
    tr = {"SEED": seed, "BATCH_SZ": B}
    return (JaxNet([[n, dict(a)] for n, a in layers], dict(tr)),
            TorchNet([[n, dict(a)] for n, a in layers], dict(tr)))


def _specs(case):
    jnet, tnet = _nets(CASES[case][1])
    js, ts = jmlp.mlp_spec_from_net(jnet), tmlp.mlp_spec_from_net(tnet)
    assert js is not None and ts is not None
    for f in tmlp.MlpSpec._fields:
        a, b = getattr(js, f), getattr(ts, f)
        assert a == b or tuple(a) == tuple(b), (f, a, b)
    return jnet, tnet, js, ts


@pytest.mark.parametrize("case", sorted(CASES))
def test_mlp_twin_matches_jax_kernel(case):
    """3 steps: cost and minf to 2e-5, every state tensor to 1e-5."""
    jnet, tnet, js, ts = _specs(case)
    plan = tm.fused_plan(tnet)
    assert plan.epoch_fn is tmlp.mlp_epoch
    assert plan.layer_idx == tmlp.MLP_LAYER_IDX
    aw = [[np.asarray(w, np.float32) for w in jnet.allwts0[i]]
          for i in tmlp.MLP_LAYER_IDX]

    nb, C0, HW = 3, ts.in_ch, ts.hw
    rng = np.random.RandomState(3)
    x = rng.rand(nb, B, C0, HW).astype(np.float32)
    y = rng.randint(0, ts.n_out, (nb, B)).astype(np.int32)
    x_rows = np.ascontiguousarray(x.transpose(0, 2, 1, 3)).reshape(
        nb, C0 * B, HW)
    shapes = [(nb, 1, 8), (nb, tm.fb_lanes(ts), HW), (nb, C0 * B, HW),
              (nb, B, tm.db_lanes(ts))]
    u = [rng.randint(0, 2**32, s, dtype=np.uint64).astype(np.uint32)
         for s in shapes]

    fn = jmlp.make_mlp_epoch_fn(js, nb, interpret=True)
    kp = [jnp.asarray(t) for t in jmlp.kernel_layout_mlp(aw, js)]
    km = [jnp.zeros_like(t) for t in kp]
    kp, km, jcm = fn(kp, km, jnp.asarray(x.reshape(nb, B, C0 * HW)),
                     jnp.asarray(y[..., None]),
                     tuple(jnp.asarray(b) for b in u), 0.1)
    tp = tmlp.kernel_layout_mlp([[torch.tensor(w) for w in lw] for lw in aw],
                                ts)
    assert [tuple(t.shape) for t in tp] == tmlp.mlp_kernel_shapes(ts)
    tmo = [torch.zeros_like(t) for t in tp]
    tp, tmo, tcm = tmlp.mlp_epoch(
        tp, tmo, torch.tensor(x_rows), torch.tensor(y),
        tuple(torch.tensor(b.view(np.int32)) for b in u), 0.1, ts)
    np.testing.assert_allclose(tcm.numpy(), np.asarray(jcm), rtol=0,
                               atol=2e-5)
    for a, b in zip(list(kp) + list(km), tp + tmo):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)
    assert float((tp[0] - torch.tensor(aw[0][0])).abs().max()) > 1e-4


def test_layouts_roundtrip_and_match_jax():
    jnet, tnet, js, ts = _specs("3-channel-bilinear-maxnorm")
    aw = [[np.asarray(w, np.float32) for w in tnet.allwts0[i]]
          for i in tmlp.MLP_LAYER_IDX]
    got = tmlp.kernel_layout_mlp([[torch.tensor(w) for w in lw]
                                  for lw in aw], ts)
    for a, b in zip(jmlp.kernel_layout_mlp(aw, js), got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for lw, lb in zip(aw, tmlp.framework_layout_mlp(got, ts)):
        for a, b in zip(lw, lb):
            np.testing.assert_array_equal(b.numpy(), a)


def test_as_deep_is_the_same_function():
    """The MLP family runs the deep family's code at a zero-level spec;
    that spec computes the same layouts and noise shapes."""
    _, _, _, ts = _specs("nearest-invert-l2")
    ds = tmlp.as_deep(ts)
    assert ds.n_levels == 0 and ds.n_flat == ts.n_flat
    assert td.deep_kernel_shapes(ds) == tmlp.mlp_kernel_shapes(ts)
    assert (tm.fb_lanes(ds), tm.db_lanes(ds)) == (4, ts.n_hid)
    for f in ("batch", "img", "n_hid", "n_out", "slope_h", "act_h", "pdrop",
              "nearest", "invert", "pflip", "reg_h", "reg_o", "in_ch"):
        assert getattr(ds, f) == getattr(ts, f), f


def test_fused_trainer_matches_per_layer_at_identity():
    """MEGAFUSED auto (the flat-MLP twin) and False (autograd) train the
    same trajectory at identity augmentation and pdrop 0."""
    layers = CASES["plain-input"][1]
    rng = np.random.RandomState(4)
    x = rng.rand(3 * B, 1, 9, 9).astype(np.float32)
    y = rng.randint(0, 3, 3 * B).astype(np.int32)
    out = []
    for mode in ("auto", False):
        tr = {"SEED": 3, "BATCH_SZ": B, "MEGAFUSED": mode,
              "INIT_LEARNING_RATE": 0.1, "EPOCHS_TO_HALF_RATE": 1}
        t = Trainer(TorchNet([[n, dict(a)] for n, a in layers], tr), x, y, x,
                    y, device="cpu")
        assert (t._mega is not None) == (mode == "auto")
        if t._mega is not None:
            assert t._mega_plan.epoch_fn is tmlp.mlp_epoch
        _, costs, minf = t.run_epochs(2)
        out.append((costs, minf, t.checkpoint_dict()["allwts"]))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=0, atol=2e-5)
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=0, atol=2e-5)
    for la, lb in zip(out[0][2], out[1][2]):
        for a, b in zip(la, lb):
            np.testing.assert_allclose(a, b, rtol=0, atol=5e-5)


def test_mlp_matcher_declines_what_jax_declines():
    """Two hiddens, a CenteredOut head, a non-nll loss or a frozen layer
    leave the MLP family (the deep family or the per-layer path takes
    them), as in the JAX package."""
    base = CASES["plain-input"][1]
    variants = [
        base[:2] + [["HiddenLayer", {"n_out": 6}]] + base[2:],
        base[:2] + [["CenteredOutLayer", {"n_features": 4,
                                          "n_classes": 3}]],
        base[:2] + [["SoftmaxLayer", {"n_out": 3, "loss": "nllsq"}]],
        [base[0], ["HiddenLayer", {"n_out": 12, "reg": dict(R2, rate=0)}],
         base[2]],
    ]
    for layers in variants:
        jnet, tnet = _nets(layers)
        assert jmlp.mlp_spec_from_net(jnet) is None
        assert tmlp.mlp_spec_from_net(tnet) is None
