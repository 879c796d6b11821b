"""Reference batches the JAX package tiles, computed whole in the port.

The JAX flagship kernel runs a BATCH_SZ above 32 as n_tiles tiles: it sums
the tile gradients (each already divided by BATCH_SZ), counts the weight
cost on tile 0 only, shares one warp across the reference batch and updates
once, on the last tile. That is one step of the whole reference batch, and
the port's flagship (its CPU twin here) runs it so, at B = BATCH_SZ. Both
are fed the same data and words; only the sum order differs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from theanet_tpu.model import NeuralNet as JaxNet
from theanet_tpu.ops import megastep as jm
from theanet_tpu.trainer import Trainer as JaxTrainer

from theanet_tpu_torch.model import NeuralNet as TorchNet
from theanet_tpu_torch.ops import megastep as tm
from theanet_tpu_torch.trainer import Trainer

IMG = 12


def _layers(pdrop=0.0):
    """tests/test_megastep_tiled.py's net, identity augmentation."""
    return [
        ["InputLayer", {"img_sz": IMG}],
        ["ConvLayer", {"num_maps": 2, "filter_sz": 3, "stride": 1,
                       "actvn": "relu05", "reg": {"L2": 1e-3,
                                                  "maxnorm": 0.9}}],
        ["PoolLayer", {"pool_sz": 2}],
        ["ConvLayer", {"num_maps": 3, "filter_sz": 3, "stride": 1,
                       "actvn": "relu10"}],
        ["PoolLayer", {"pool_sz": 2}],
        ["HiddenLayer", {"n_out": 16, "pdrop": pdrop, "actvn": "relu01",
                         "reg": {"L1": 1e-4, "maxnorm": 0.7}}],
        ["SoftmaxLayer", {"n_out": 4}],
    ]


def _tr(batch):
    return {"SEED": 11, "BATCH_SZ": batch, "NUM_EPOCHS": 3,
            "EPOCHS_TO_TEST": 1, "TEST_SAMP_SZ": batch,
            "INIT_LEARNING_RATE": 0.1, "EPOCHS_TO_HALF_RATE": 2,
            "MEGAFUSED": True}


@pytest.mark.parametrize("batch,nb", [(64, 2), (48, 3)])
def test_fused_trainer_follows_jax_tiled_trainer(batch, nb):
    """The port's fused Trainer (one step of the whole batch) against the
    JAX package's tiled fused Trainer (2 tiles of 32; 3 tiles of 16),
    three epochs: costs of shape (nb,) within atol 5e-5 and the final
    weights within 1e-4, the bounds tests/test_megastep_tiled.py holds the
    tiled kernel to against the per-layer path."""
    rng = np.random.RandomState(3)
    x = rng.rand(nb * batch, 1, IMG, IMG).astype(np.float32)
    y = rng.randint(0, 4, nb * batch).astype(np.int32)
    jt = JaxTrainer(JaxNet(_layers(), _tr(batch)), x, y, x, y)
    assert jt._mega is not None and jt._mega_spec.n_tiles > 1
    tt = Trainer(TorchNet(_layers(), _tr(batch)), x, y, x, y, device="cpu")
    assert tt._mega_plan.epoch_fn is tm.megastep_epoch
    assert tt._mega_spec.batch == batch
    for _ in range(3):
        _, jc, jmin = jt.run_epoch()
        _, tc, tmin = tt.run_epoch()
        assert tc.shape == jc.shape == (nb,)
        np.testing.assert_allclose(tc, jc, rtol=0, atol=5e-5)
        np.testing.assert_allclose(tmin, jmin, rtol=0, atol=5e-5)
        jt.net.inc_epoch_set_rate()
        tt.net.inc_epoch_set_rate()
    for lj, lt in zip(jt.checkpoint_dict()["allwts"],
                      tt.checkpoint_dict()["allwts"]):
        for a, b in zip(lj, lt):
            np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-4)


def _regs(mod):
    return [mod.LayerReg(L1=0.0, L2=1e-3, momentum=0.95, rate=1.0,
                         maxnorm=0.9),
            mod.LayerReg(L1=0.0, L2=0.0, momentum=0.95, rate=1.0,
                         maxnorm=0.0),
            mod.LayerReg(L1=1e-4, L2=0.0, momentum=0.9, rate=1.0,
                         maxnorm=0.7),
            mod.LayerReg(L1=0.0, L2=0.0, momentum=0.95, rate=0.5,
                         maxnorm=0.8)]


@pytest.mark.parametrize("in_ch", [1, 3])
def test_twin_follows_jax_tiled_kernel(in_ch):
    """megastep_epoch_reference at B 64 against make_epoch_fn of the JAX
    tiled spec (2 tiles of 32, interpret mode), with elastic augmentation
    and dropout on, one epoch of 3 reference batches. JAX draws the pflip
    and dropout words per tile: tile t of batch n holds rows c*32 + b
    (pflip) and b (dropout) of step n*2 + t, which the port reads at rows
    c*64 + t*32 + b and t*32 + b of batch n. The tolerances are those of
    the untiled twin test (tests/test_torch_megastep.py): costs 2e-5,
    state 5e-5."""
    B, bt, nt, nb = 64, 32, 2, 3
    base = dict(img=IMG, filt1=3, filt2=3, maps1=2, maps2=3, n_hid=16,
                n_out=4, slope1=0.05, slope2=0.10, slope_h=0.01, pdrop=0.5,
                translation=2, zoom=1.1, magnitude=8, sigma=3, pflip=0.03,
                angle=5, invert=True, nearest=True, in_ch=in_ch)
    js = jm.MegaSpec(batch=bt, n_tiles=nt, loss_div=B, **base,
                     **dict(zip(("reg1", "reg2", "reg_h", "reg_o"),
                                _regs(jm))))
    ts = tm.MegaSpec(batch=B, **base, **dict(zip(("reg1", "reg2", "reg_h",
                                                  "reg_o"), _regs(tm))))
    rng = np.random.RandomState(5)
    hw = ts.hw
    x = rng.rand(nb * B, in_ch, IMG, IMG).astype(np.float32)
    y = rng.randint(0, 4, nb * B).astype(np.int32)
    words = [rng.randint(0, 2 ** 32, s, dtype=np.uint64).astype(np.uint32)
             for s in ((nb, 1, 8), (nb, 4, hw), (nb * nt, in_ch * bt, hw),
                       (nb * nt, bt, 16))]
    ub, fb, pb, db = (w.view(np.int32) for w in words)
    pb_t = (pb.reshape(nb, nt, in_ch, bt, hw).transpose(0, 2, 1, 3, 4)
            .reshape(nb, in_ch * B, hw))
    db_t = db.reshape(nb, B, 16)
    aw = [[rng.randn(2, in_ch, 3, 3).astype(np.float32) * .5,
           rng.randn(2).astype(np.float32) * .1],
          [rng.randn(3, 2, 3, 3).astype(np.float32) * .3,
           rng.randn(3).astype(np.float32) * .1],
          [rng.randn(ts.n_flat, 16).astype(np.float32) * .2,
           rng.randn(16).astype(np.float32) * .1],
          [rng.randn(16, 4).astype(np.float32) * .3,
           rng.randn(4).astype(np.float32) * .1]]

    fn = jm.make_epoch_fn(js, nb, interpret=True)
    jp = [jnp.asarray(t) for t in jm.params_to_kernel(aw, js)]
    jp, jmo, jcm = fn(jp, [jnp.zeros_like(t) for t in jp], jnp.asarray(x),
                      jnp.asarray(y[:, None]),
                      tuple(jnp.asarray(w) for w in words), 0.1)
    tp = tm.kernel_layout([[torch.tensor(w) for w in lw] for lw in aw], ts)
    x_rows = np.ascontiguousarray(
        x.reshape(nb, B, in_ch, hw).transpose(0, 2, 1, 3)).reshape(
            nb, in_ch * B, hw)
    bits = tuple(torch.tensor(np.ascontiguousarray(w))
                 for w in (ub, fb, pb_t, db_t))
    tp, tmo, tcm = tm.megastep_epoch_reference(
        tp, [torch.zeros_like(t) for t in tp], torch.tensor(x_rows),
        torch.tensor(y.reshape(nb, B)), bits, 0.1, ts)
    assert tcm.shape == (nb, 2)
    np.testing.assert_allclose(tcm.numpy(), np.asarray(jcm), rtol=0,
                               atol=2e-5)
    for a, b in zip(jp + jmo, tp + tmo):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=5e-5)
