"""The port's losses, heads and aux-input layers against the JAX package's.

Both packages build the same layer list at the same SEED (so the same
initial weights, drawn in the same order), and the same numpy inputs go
through ``theanet_tpu.layers`` and ``theanet_tpu_torch.layers``:

  * every loss of ``OutputMixin.cost`` (nll, nllsq, truncated nll<NN> with
    its notices and its unparseable-suffix fallback, hinge, hinge_max,
    exp), and the ExpLoss and Hinge heads, to 1e-6;
  * MeanLayer, LocationInfo, AuxConcatLayer and SoftAuxLayer: eval mode to
    1e-6, train mode with the JAX package's own convex-mix draw fed to the
    port;
  * 12 per-layer training steps of the SoftAux, Hinge, ExpLoss, nllsq and
    nll90 heads through both packages' ``train_step`` (costs to 2e-5 of
    the larger of 1 and the cost, state to 2e-5);
  * params/synth_aux.prms end to end on the CPU: its dataset, its CLI run
    (fused through the deep twin, and per layer), the fused Trainer
    against the per-layer one, its checkpoint in both packages;
  * the CLI's ExpLoss divergence watchdog.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from theanet_tpu.data import synth_aux as jax_synth_aux
from theanet_tpu.model import NeuralNet as JaxNet
from theanet_tpu.ops import megastep as jm
from theanet_tpu.trainer import Trainer as JaxTrainer

from theanet_tpu_torch import train
from theanet_tpu_torch.data import load_dataset
from theanet_tpu_torch.data import synth_aux as torch_synth_aux
from theanet_tpu_torch.model import NeuralNet as TorchNet
from theanet_tpu_torch.model import params_from_allwts
from theanet_tpu_torch.ops import megastep
from theanet_tpu_torch.ops import megastep_deep as deep
from theanet_tpu_torch.prms import load_params
from theanet_tpu_torch.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, IMG, N_HID = 8, 4, 12
HID_REG = {"L1": 1e-4, "momentum": 0.9, "rate": 1, "maxnorm": 0.7, "L2": 0}
HEAD_REG = {"L2": 1e-3, "momentum": 0.95, "rate": 0.5, "maxnorm": 0.8,
            "L1": 0}


def _tr(seed=4242, **kw):
    return {"SEED": seed, "BATCH_SZ": B, "NUM_EPOCHS": 3, "EPOCHS_TO_TEST": 1,
            "TEST_SAMP_SZ": B, "INIT_LEARNING_RATE": 0.1,
            "EPOCHS_TO_HALF_RATE": 2, **kw}


def _nets(layers, **kw):
    """The same layer list in both packages; the initial weights must be
    bit-equal (the same draws in the same order)."""
    jnet = JaxNet([[n, dict(a)] for n, a in layers], _tr(**kw))
    tnet = TorchNet([[n, dict(a)] for n, a in layers], _tr(**kw))
    assert len(jnet.allwts0) == len(tnet.allwts0)
    for lj, lt in zip(jnet.allwts0, tnet.allwts0):
        assert len(lj) == len(lt)
        for a, b in zip(lj, lt):
            np.testing.assert_array_equal(np.asarray(a), b)
    return jnet, tnet


def _params(tnet):
    return params_from_allwts(tnet.allwts0, "cpu")


def _dense(head):
    return [["InputLayer", {"img_sz": IMG}],
            ["HiddenLayer", {"n_out": N_HID, "actvn": "relu10",
                             "reg": HID_REG}], head]


def _xy(n_out, seed=99, steps=None):
    rng = np.random.RandomState(seed)
    shape = (B,) if steps is None else (steps, B)
    x = rng.rand(*shape, 1, IMG, IMG).astype(np.float32)
    y = rng.randint(0, n_out, shape).astype(np.int32)
    return x, y


def _aux(seed=5, steps=None, same_rows=False):
    rng = np.random.RandomState(seed)
    shape = (B,) if steps is None else (steps, B)
    a = rng.randn(*shape, 2, 2).astype(np.float32)
    if same_rows:   # the convex mix is then the row, whatever its draw
        a[..., 1, :] = a[..., 0, :]
    return a


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


# ------------------------------------------------------- losses and heads

LOSS_CASES = {
    "softmax-nll": ("SoftmaxLayer", "nll"),
    "softmax-nllsq": ("SoftmaxLayer", "nllsq"),
    "softmax-nll90": ("SoftmaxLayer", "nll90"),
    "softmax-nll00": ("SoftmaxLayer", "nll00"),
    "softmax-unparseable": ("SoftmaxLayer", "nllab"),
    "softmax-hinge": ("SoftmaxLayer", "hinge"),
    "softmax-hinge_max": ("SoftmaxLayer", "hinge_max"),
    "softmax-exp": ("SoftmaxLayer", "exp"),
    "hinge-head": ("HingeLayer", None),
    "exploss-head": ("ExpLossLayer", None),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_head_state_match_jax(case, capsys):
    """The head state of a forward and every loss of the dispatch, with the
    truncated NLL's one-time notices printed as the JAX package prints
    them."""
    head_type, loss = LOSS_CASES[case]
    args = {"n_out": 5, "reg": HEAD_REG}
    if loss:
        args["loss"] = loss
    jnet, tnet = _nets(_dense([head_type, args]))
    x, y = _xy(5)
    jp, _ = jnet.init_params()
    hs_j = jnet.forward(jp, jnp.asarray(x), key=jnet.base_key, train=True)
    hs_t = tnet.forward(_params(tnet), torch.tensor(x), train=True)
    for k in ("output", "probs", "logprob", "features", "y_preds"):
        _close(hs_t[k].numpy(), hs_j[k])
    capsys.readouterr()
    for _ in range(2):   # the notices print once
        cj = jnet.head.cost(hs_j, jnp.asarray(y))
    printed_j = capsys.readouterr().out
    for _ in range(2):
        ct = tnet.head.cost(hs_t, torch.tensor(y))
    assert capsys.readouterr().out == printed_j
    _close(float(ct), float(cj))
    stats_t = tnet.head.sym_and_oth_err_rate(hs_t, torch.tensor(y))
    stats_j = jnet.head.sym_and_oth_err_rate(hs_j, jnp.asarray(y))
    for a, b in zip(stats_t, stats_j):
        _close(float(a), float(b))


def test_unknown_loss_raises_in_both():
    jnet, tnet = _nets(_dense(["SoftmaxLayer", {"n_out": 3,
                                                "loss": "huber"}]))
    x, y = _xy(3)
    jp, _ = jnet.init_params()
    hs_j = jnet.forward(jp, jnp.asarray(x), key=jnet.base_key, train=False)
    with pytest.raises(NotImplementedError, match="huber"):
        jnet.head.cost(hs_j, jnp.asarray(y))
    hs = tnet.forward(_params(tnet), torch.tensor(x), train=False)
    with pytest.raises(NotImplementedError, match="huber"):
        tnet.head.cost(hs, torch.tensor(y))


def test_mean_layer_matches_jax():
    layers = [["InputLayer", {"img_sz": 7}],
              ["ConvLayer", {"num_maps": 3, "filter_sz": 3, "stride": 1}],
              ["MeanLayer", {}],
              ["SoftmaxLayer", {"n_out": 4}]]
    jnet, tnet = _nets(layers)
    assert tnet.net_layers[2].n_out == 3 and tnet.net_layers[2].out_sz == 1
    x = np.random.RandomState(2).rand(B, 1, 7, 7).astype(np.float32)
    jp, _ = jnet.init_params()
    _, _, jmean = jnet.predict(jp, jnp.asarray(x), get_output_of_layers=(2,))
    _, _, tmean = tnet.predict(_params(tnet), torch.tensor(x),
                               get_output_of_layers=(2,))
    assert tuple(tmean.shape) == (B, 3)
    _close(tmean.numpy(), jmean)
    # a MeanLayer straight into the head: no Hidden layer, so outside the
    # fused grammar in both packages
    assert jm.fused_plan(jnet) is None and megastep.fused_plan(tnet) is None
    assert "outside the fused grammar" in megastep.fused_decline_reason(tnet)


# -------------------------------------------------------------- aux layers

AUX_NETS = {
    "auxconcat": [["InputLayer", {"img_sz": 6}],
                  ["ConvLayer", {"num_maps": 2, "filter_sz": 3,
                                 "stride": 1}],
                  ["PoolLayer", {"pool_sz": 2}],
                  ["AuxConcatLayer", {"n_aux": (5, 9), "boost": 2,
                                      "aux_type": "LocationInfo"}],
                  ["HiddenLayer", {"n_out": 6}],
                  ["SoftmaxLayer", {"n_out": 4}]],
    "softaux": [["InputLayer", {"img_sz": 6}],
                ["ConvLayer", {"num_maps": 2, "filter_sz": 3, "stride": 1}],
                ["PoolLayer", {"pool_sz": 2}],
                ["SoftAuxLayer", {"n_out": 4, "n_aux": (4, 7), "boost": 1.5,
                                  "aux_type": "LocationInfo"}]],
}


def _jax_mix_u(lyr, key, softaux):
    """The JAX package's convex-mix uniforms of LocationInfo under ``key``
    (layers/aux.py:50-54; SoftAux folds 1 in first, :150)."""
    if softaux:
        key = jax.random.fold_in(key, 1)
    key = jax.random.fold_in(key, lyr.aux_info.stream_seed)
    return np.asarray(jax.random.uniform(key, (B, 1)))


@pytest.mark.parametrize("name", sorted(AUX_NETS))
def test_aux_layer_matches_jax(name):
    """Draw order and packing (bit-equal initial weights: 4 encoder tensors
    for AuxConcat, 8 for SoftAux), the aux layer's output in eval mode, and
    in train mode fed the JAX package's draw; the whole net's eval
    forward."""
    jnet, tnet = _nets(AUX_NETS[name])
    i = tnet.aux_layer_idx
    assert i == jnet.aux_layer_idx == 3 and tnet.takes_aux()
    assert len(tnet.allwts0[i]) == (8 if name == "softaux" else 4)
    lyr_j, lyr_t = jnet.net_layers[i], tnet.net_layers[i]
    rng = np.random.RandomState(3)
    feats = rng.rand(B, 2, 2, 2).astype(np.float32)
    aux = _aux()
    wj = [jnp.asarray(w) for w in jnet.allwts0[i]]
    wt = [torch.tensor(np.asarray(w)) for w in tnet.allwts0[i]]
    key = jax.random.PRNGKey(8)
    for train_mode in (False, True):
        u = (torch.tensor(_jax_mix_u(lyr_j, key, name == "softaux"))
             if train_mode else None)
        if name == "softaux":
            got = lyr_t.apply_head(wt, torch.tensor(feats), train=train_mode,
                                   aux=torch.tensor(aux), u=u)["logprob"]
            want = lyr_j.apply_head(wj, jnp.asarray(feats), key=key,
                                    train=train_mode,
                                    aux=jnp.asarray(aux))["logprob"]
        else:
            got = lyr_t.apply(wt, torch.tensor(feats), train=train_mode,
                              aux=torch.tensor(aux), u=u)
            want = lyr_j.apply(wj, jnp.asarray(feats), key=key,
                               train=train_mode, aux=jnp.asarray(aux))
        _close(got.numpy(), want)
    x, y = _xy(4)
    x = np.random.RandomState(4).rand(B, 1, 6, 6).astype(np.float32)
    jp, _ = jnet.init_params()
    fj, pj = jnet.predict(jp, jnp.asarray(x), aux=jnp.asarray(aux))
    ft, pt = tnet.predict(_params(tnet), torch.tensor(x),
                          aux=torch.tensor(aux))
    _close(ft.numpy(), fj)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


def test_aux_concat_keeps_the_features_dtype_under_bf16():
    """The f32 aux tensor does not promote the concat (aux.py:89-93); the
    bf16 net's eval forward follows the JAX package's."""
    jnet, tnet = _nets(AUX_NETS["auxconcat"], COMPUTE_DTYPE="bfloat16")
    lyr = tnet.net_layers[3]
    wt = [torch.tensor(np.asarray(w)).to(torch.bfloat16)
          for w in tnet.allwts0[3]]
    out = lyr.apply(wt, torch.rand(B, 2, 2, 2, dtype=torch.bfloat16),
                    train=False, aux=torch.tensor(_aux()))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (B, 17)
    x = np.random.RandomState(4).rand(B, 1, 6, 6).astype(np.float32)
    jp, _ = jnet.init_params()
    fj, _ = jnet.predict(jp, jnp.asarray(x), aux=jnp.asarray(_aux()))
    ft, _ = tnet.predict(_params(tnet), torch.tensor(x),
                         aux=torch.tensor(_aux()))
    _close(ft.float().numpy(), np.asarray(fj, np.float32), atol=2e-2)


# ------------------------------------------------ per-layer trajectories

TRAJECTORIES = {
    "softaux": ["SoftAuxLayer", {"n_out": 4, "n_aux": (5, 9),
                                 "aux_type": "LocationInfo",
                                 "reg": HEAD_REG}],
    "hinge": ["HingeLayer", {"n_out": 4, "reg": HEAD_REG}],
    "exploss": ["ExpLossLayer", {"n_out": 4, "reg": HEAD_REG}],
    "nllsq": ["SoftmaxLayer", {"n_out": 4, "loss": "nllsq",
                               "reg": HEAD_REG}],
    "nll90": ["SoftmaxLayer", {"n_out": 4, "loss": "nll90",
                               "reg": HEAD_REG}],
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_per_layer_trajectory_matches_jax(name):
    """Input -> Hidden(relu10) -> head, 12 steps over 3 epochs with an
    annealed rate and max-norms that bite, through both train_steps (as
    tests/test_head_oracles.py:339-471). SoftAux gets aux inputs whose two
    rows are equal, so the two packages' mix draws cannot differ."""
    jnet, tnet = _nets(_dense(TRAJECTORIES[name]))
    steps = 4
    xs, ys = _xy(4, steps=steps)
    aux = _aux(steps=steps, same_rows=True) if name == "softaux" else None
    jp, jm = jnet.init_params()
    tp, tm_ = tnet.init_params("cpu")
    for _ in range(3):
        lr = jnet.get_rate()
        assert lr == tnet.get_rate()
        for i in range(steps):
            ja = None if aux is None else jnp.asarray(aux[i])
            ta = None if aux is None else torch.tensor(aux[i])
            jp, jm, jc, _, _ = jnet.train_step(
                jp, jm, jnp.asarray(xs[i]), jnp.asarray(ys[i]),
                key=jnet.base_key, lr=lr, aux=ja)
            tp, tm_, tc, _, _ = tnet.train_step(
                tp, tm_, torch.tensor(xs[i]), torch.tensor(ys[i]), lr=lr,
                generator=torch.Generator().manual_seed(i), aux=ta)
            assert abs(float(tc) - float(jc)) <= 2e-5 * max(1.0,
                                                            abs(float(jc)))
        jnet.inc_epoch_set_rate()
        tnet.inc_epoch_set_rate()
    for lj, lt in zip(list(jp) + list(jm), tp + tm_):
        for a, b in zip(lj, lt):
            _close(b.numpy(), a, atol=2e-5)


# ------------------------------------------------- params/synth_aux.prms

def test_synth_aux_arrays_are_bit_equal():
    for attr in ("training_x", "training_y", "training_aux", "testing_x",
                 "testing_y", "testing_aux"):
        a, b = getattr(torch_synth_aux, attr), getattr(jax_synth_aux, attr)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert torch_synth_aux.training_aux.shape == (6000, 2, 2)
    assert load_dataset("synth_aux") is torch_synth_aux


def _synth_aux_prms(tmp_path, **tr):
    text = open(os.path.join(REPO, "params", "synth_aux.prms")).read()
    text = text.replace("'NUM_EPOCHS':          3,",
                        "'NUM_EPOCHS':          1,")
    for k, v in tr.items():
        text = text.replace("'SEED':", f"'{k}': {v!r}, 'SEED':")
    path = tmp_path / "synth_aux.prms"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("mode", ["auto", False])
def test_cli_trains_synth_aux(mode, tmp_path, monkeypatch, capsys):
    """params/synth_aux.prms cut to 1 epoch: under MEGAFUSED 'auto' the deep
    family's twin trains it (one epoch call), under False the per-layer
    path; both print the epoch table and keep one checkpoint."""
    monkeypatch.setenv("THEANET_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    prms = (_synth_aux_prms(tmp_path) if mode == "auto"
            else _synth_aux_prms(tmp_path, MEGAFUSED=False))
    trainer = train.main(["train", "synth_aux", prms])
    out = capsys.readouterr().out
    assert "Epoch   Cost  Tr_Error Tr_P(MLE)    Te_Error Te_P(MLE)" in out
    rows = [l.split() for l in out.splitlines() if l[:3].strip().isdigit()]
    assert [int(r[0]) for r in rows] == [0, 1]
    assert all(np.isfinite(float(r[1])) for r in rows)
    assert float(rows[-1][4].rstrip("%")) < 50.0   # it learned
    if mode == "auto":
        assert trainer._mega_plan.epoch_fn is deep.deep_epoch
        assert trainer._mega_spec.head == "softaux"
    else:
        assert trainer._mega is None
    pkls = [p for p in os.listdir(".") if p.endswith(".pkl")]
    assert len(pkls) == 1
    _, _, allwts = load_params(pkls[0])
    assert [len(lw) for lw in allwts] == [0, 2, 0, 8]


@pytest.mark.parametrize("name", sorted(AUX_NETS))
def test_fused_trainer_matches_per_layer_at_identity(name):
    """The hand-derived backward of the deep twin's aux heads against the
    per-layer path's autograd over 2 epochs: identity augmentation, no
    dropout and aux inputs with equal rows make the two paths one
    function."""
    rng = np.random.RandomState(4)
    x = rng.rand(3 * B, 1, 6, 6).astype(np.float32)
    y = rng.randint(0, 4, 3 * B).astype(np.int32)
    aux = _aux(steps=3, same_rows=True).reshape(3 * B, 2, 2)
    out = []
    for mode in ("auto", False):
        net = TorchNet([[n, dict(a)] for n, a in AUX_NETS[name]],
                       _tr(seed=3, MEGAFUSED=mode))
        t = Trainer(net, x, y, x, y, device="cpu", train_aux=aux,
                    test_aux=aux)
        assert (t._mega is not None) == (mode == "auto")
        _, costs, minf = t.run_epochs(2)
        out.append((costs, minf, t.checkpoint_dict()["allwts"],
                    t.evaluate_full("test")))
    (fc, fm, fw, fe), (pc, pm, pw, pe) = out
    _close(fc, pc, atol=2e-5)
    _close(fm, pm, atol=2e-5)
    for la, lb in zip(fw, pw):
        assert len(la) == len(lb)
        for a, b in zip(la, lb):
            _close(a, b, atol=5e-5)
    _close(fe, pe, atol=1e-9)


def test_aux_net_without_aux_data_declines_by_name():
    x = np.random.RandomState(0).rand(2 * B, 1, 6, 6).astype(np.float32)
    y = np.zeros(2 * B, np.int32)
    net = TorchNet(AUX_NETS["softaux"], _tr(MEGAFUSED=True))
    with pytest.raises(ValueError, match="need aux data"):
        Trainer(net, x, y, x, y, device="cpu")
    # a net without an aux layer drops the aux arrays it is given
    plain = TorchNet(_dense(["SoftmaxLayer", {"n_out": 4}]), _tr())
    t = Trainer(plain, x[:, :, :4, :4], y, x[:, :, :4, :4], y, device="cpu",
                train_aux=_aux(steps=2).reshape(-1, 2, 2))
    assert t.d_train_aux is None


def test_softaux_checkpoint_round_trips_from_jax():
    """The JAX package's 8-tensor SoftAux and 4-tensor AuxConcat entries
    load into the port (model.py params_from_allwts and NeuralNet's
    allwts), which predicts what the JAX net predicts and writes the same
    checkpoint entries back."""
    for name in ("softaux", "auxconcat"):
        jnet = JaxNet([[n, dict(a)] for n, a in AUX_NETS[name]], _tr())
        jp, _ = jnet.init_params()
        allwts = [[np.asarray(w) for w in lw] for lw in
                  jnet.get_init_params()["allwts"]]
        tnet = TorchNet([[n, dict(a)] for n, a in AUX_NETS[name]],
                        _tr(seed=99), allwts=allwts)
        for lj, lt in zip(allwts, tnet.get_init_params()["allwts"]):
            assert len(lj) == len(lt)
            for a, b in zip(lj, lt):
                np.testing.assert_array_equal(a, b)
        x = np.random.RandomState(4).rand(B, 1, 6, 6).astype(np.float32)
        aux = _aux()
        fj, _ = jnet.predict(jp, jnp.asarray(x), aux=jnp.asarray(aux))
        ft, _ = tnet.predict(params_from_allwts(allwts, "cpu"),
                             torch.tensor(x), aux=torch.tensor(aux))
        _close(ft.numpy(), fj)


def test_cli_exp_head_divergence_watchdog(tmp_path, monkeypatch, capsys):
    """An ExpLoss head whose smallest true-class score of an epoch falls
    below -6 gets the reference's dump (train.py:214-226), inside a chunk
    of epochs too: the chunk replays to the failing epoch, dumps, and
    trains on. The scores are lowered by a stand-in run_epochs."""
    import sys
    import types

    rng = np.random.RandomState(0)
    mod = types.ModuleType("data.torch_heads_tiny")
    mod.training_x = rng.rand(2 * B, IMG * IMG).astype(np.float32)
    mod.training_y = rng.randint(0, 4, 2 * B).astype(np.int32)
    mod.testing_x, mod.testing_y = mod.training_x, mod.training_y
    monkeypatch.setitem(sys.modules, "data.torch_heads_tiny", mod)
    monkeypatch.setenv("THEANET_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "exp.prms").write_text(repr({
        "layers": [["InputLayer", {}], ["HiddenLayer", {"n_out": 6}],
                   ["ExpLossLayer", {"n_out": 4}]],
        "training_params": _tr(NUM_EPOCHS=3, EPOCHS_TO_TEST=2)}))
    run_epochs, calls = Trainer.run_epochs, []

    def lowered(self, k):
        totals, costs, minf = run_epochs(self, k)
        calls.append(k)
        if len(calls) == 2:   # epochs 1-2: epoch 1 diverges
            minf[0, 1] = -7.0
        return totals, costs, minf

    monkeypatch.setattr(Trainer, "run_epochs", lowered)
    train.main(["train", "torch_heads_tiny", "exp.prms"])
    out = capsys.readouterr().out
    assert "Epoch:1 Iteration:1" in out
    assert "min true-class feature: -7.0" in out
    # the chunk, the replay to epoch 1, the chunk again
    assert calls == [1, 2, 1, 2]


@pytest.mark.parametrize("name", sorted(AUX_NETS))
def test_positional_trainer_and_predict_match_jax(name, capsys):
    """Both packages' Trainer built by position with the aux rows (net,
    train_x, train_y, test_x, test_y, train_aux, test_aux), then
    ``predict(x, aux)`` by position: the same features and predictions,
    and the same serving-shape notice (BATCH_SZ is not 1), printed on the
    first call only."""
    jnet, tnet = _nets(AUX_NETS[name], MEGAFUSED=False)
    rng = np.random.RandomState(6)
    x = rng.rand(2 * B, 1, 6, 6).astype(np.float32)
    y = rng.randint(0, 4, 2 * B).astype(np.int32)
    aux = _aux(steps=2).reshape(-1, 2, 2)
    jt = JaxTrainer(jnet, x, y, x, y, aux, aux)
    tt = Trainer(tnet, x, y, x, y, aux, aux, device="cpu")
    assert tt.d_train_aux is not None and tt.d_test_aux is not None
    capsys.readouterr()
    fj, pj = jt.predict(x[:B], aux[:B])
    printed_j = capsys.readouterr().out
    ft, pt = tt.predict(x[:B], aux[:B])
    printed_t = capsys.readouterr().out
    assert "BATCH SIZE IS NOT 1" in printed_j
    assert printed_t == printed_j
    _close(ft, fj)
    np.testing.assert_array_equal(pt, np.asarray(pj))
    tt.predict(x[:B], aux[:B])
    assert capsys.readouterr().out == ""
