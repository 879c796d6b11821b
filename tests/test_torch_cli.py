"""The port's CLI on the CPU: a fresh run and a resume of a flagship-pattern
net (so the fused path runs, through its twin), galaxy-shaped and LOGIT nets
through the deep family, and checkpoints that either package loads."""

import os
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from theanet_tpu.model import NeuralNet as JaxNet
from theanet_tpu.prms import load_params as jax_load_params
from theanet_tpu.prms import save_checkpoint as jax_save_checkpoint

from theanet_tpu_torch import tracing, train
from theanet_tpu_torch.model import NeuralNet as TorchNet
from theanet_tpu_torch.ops import megastep, megastep_deep
from theanet_tpu_torch.prms import load_params
from theanet_tpu_torch.trainer import Trainer

IMG, NC = 12, 4

PRMS = """{
"layers": [
    ('ElasticLayer', {'translation': 2, 'zoom': 1.1, 'magnitude': 8,
                      'sigma': 3, 'pflip': 0.03, 'angle': 5,
                      'nearest': True, 'invert_image': True}),
    ('ConvLayer', {'num_maps': 2, 'filter_sz': 3, 'stride': 1,
                   'actvn': "relu10"}),
    ('PoolLayer', {'pool_sz': 2}),
    ('ConvLayer', {'num_maps': 3, 'filter_sz': 3, 'stride': 1,
                   'actvn': "relu05"}),
    ('PoolLayer', {'pool_sz': 2}),
    ('HiddenLayer', {'n_out': 16, 'pdrop': .5}),
    ('SoftmaxLayer', {'n_out': 4}),
],
"training_params": {'BATCH_SZ': 4, 'NUM_EPOCHS': 2, 'EPOCHS_TO_TEST': 1,
                    'TEST_SAMP_SZ': 8, 'INIT_LEARNING_RATE': .1,
                    'EPOCHS_TO_HALF_RATE': 1, 'SEED': 17},
}
"""


@pytest.fixture
def tiny_data(monkeypatch, tmp_path):
    rng = np.random.RandomState(0)
    mod = types.ModuleType("data.torch_cli_tiny")
    mod.training_x = rng.rand(16, IMG * IMG).astype(np.float32)
    mod.training_y = rng.randint(0, NC, 16).astype(np.int32)
    mod.testing_x = rng.rand(8, IMG * IMG).astype(np.float32)
    mod.testing_y = rng.randint(0, NC, 8).astype(np.int32)
    monkeypatch.setitem(sys.modules, "data.torch_cli_tiny", mod)
    monkeypatch.setenv("THEANET_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "tiny.prms").write_text(PRMS)
    return mod


def _pkls():
    return sorted(p for p in os.listdir(".") if p.endswith(".pkl"))


def test_cli_fresh_run_and_resume(tiny_data, capsys):
    launches = megastep.megastep_epoch.launches
    trainer = train.main(["train", "torch_cli_tiny", "tiny.prms"])
    assert trainer._mega is not None   # the fused path trained
    out = capsys.readouterr().out
    assert "Epoch   Cost  Tr_Error Tr_P(MLE)    Te_Error Te_P(MLE)" in out
    assert "Device : cpu" in out
    rows = [l for l in out.splitlines() if l[:3].strip().isdigit()]
    assert [int(r.split()[0]) for r in rows] == [0, 1, 2]
    assert len(_pkls()) == 1   # keep-one checkpoint
    # on the CPU the wrapper ran the twin: no kernel launch was counted
    assert megastep.megastep_epoch.launches == launches

    _, tr, allwts = load_params(_pkls()[0])
    assert tr["CUR_EPOCH"] == 2 and len(allwts) == 7
    resumed = train.main(["train", "torch_cli_tiny", _pkls()[0]])
    out = capsys.readouterr().out
    rows = [l for l in out.splitlines() if l[:3].strip().isdigit()]
    assert [int(r.split()[0]) for r in rows] == [2, 3, 4]
    assert resumed.net.get_epoch() == 4
    assert len(_pkls()) == 2   # the resume keeps its own one


def test_port_checkpoint_predicts_the_same_in_jax(tiny_data):
    trainer = train.main(["train", "torch_cli_tiny", "tiny.prms"])
    layers, tr, allwts = jax_load_params(_pkls()[0])
    jnet = JaxNet(layers, tr, allwts)
    x = tiny_data.testing_x.reshape(-1, 1, IMG, IMG)
    jp, _ = jnet.init_params()
    j_feat, j_pred = jnet.predict(jp, jnp.asarray(x))
    t_feat, t_pred = trainer.predict(x)
    np.testing.assert_array_equal(t_pred, np.asarray(j_pred))
    np.testing.assert_allclose(t_feat, np.asarray(j_feat), atol=1e-5)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    layers = [["InputLayer", {"img_sz": 8}],
              ["ConvLayer", {"num_maps": 2, "filter_sz": 3, "stride": 1,
                             "actvn": "relu"}],
              ["PoolLayer", {"pool_sz": 2}],
              ["HiddenLayer", {"n_out": 5}],
              ["SoftmaxLayer", {"n_out": 3}]]
    tr = {"SEED": 5, "BATCH_SZ": 2}
    jnet = JaxNet([list(l) for l in layers], dict(tr))
    path = str(tmp_path / "jax.pkl")
    jax_save_checkpoint(path, jnet.get_init_params())
    tl, ttr, tw = load_params(path)
    tnet = TorchNet(tl, ttr, tw)
    x = np.random.RandomState(1).rand(4, 1, 8, 8).astype(np.float32)
    jp, _ = jnet.init_params()
    tp, _ = tnet.init_params("cpu")
    np.testing.assert_array_equal(
        tnet.predict(tp, torch.tensor(x))[1].numpy(),
        np.asarray(jnet.predict(jp, jnp.asarray(x))[1]))


GALAXY_PRMS = """{
"layers": [
    ('ColorLayer', {'balance': 1.2, 'gamma': 1.2, 'maxval': 1}),
    ('ElasticLayer', {'translation': 2, 'zoom': 1.1, 'magnitude': 8,
                      'sigma': 3, 'pflip': 0.0, 'angle': 5,
                      'nearest': False, 'invert_image': False}),
    ('ConvLayer', {'num_maps': 2, 'filter_sz': 3, 'stride': 1,
                   'actvn': "relu10"}),
    ('PoolLayer', {'pool_sz': 2}),
    ('HiddenLayer', {'n_out': 12, 'pdrop': .5}),
    ('DropOutLayer', {'pdrop': .25}),
    ('CenteredOutLayer', {'n_features': 6, 'n_classes': 4, 'kind': 'RBF',
                          'learn_centers': True, 'junk_dist': 50.0}),
],
"training_params": {'BATCH_SZ': 4, 'NUM_EPOCHS': 2, 'EPOCHS_TO_TEST': 1,
                    'TEST_SAMP_SZ': 8, 'INIT_LEARNING_RATE': .05,
                    'EPOCHS_TO_HALF_RATE': 2, 'SEED': 23},
}
"""


@pytest.fixture
def tiny_rgb(monkeypatch, tmp_path):
    rng = np.random.RandomState(1)
    mod = types.ModuleType("data.torch_cli_rgb")
    mod.training_x = rng.rand(16, 3, IMG, IMG).astype(np.float32)
    mod.training_y = rng.randint(0, NC, 16).astype(np.int32)
    mod.testing_x = rng.rand(8, 3, IMG, IMG).astype(np.float32)
    mod.testing_y = rng.randint(0, NC, 8).astype(np.int32)
    monkeypatch.setitem(sys.modules, "data.torch_cli_rgb", mod)
    monkeypatch.setenv("THEANET_TORCH_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "galaxy.prms").write_text(GALAXY_PRMS)
    (tmp_path / "logit.prms").write_text(
        GALAXY_PRMS.replace("'kind': 'RBF'", "'kind': 'LOGIT'")
        .replace("'learn_centers': True, 'junk_dist': 50.0", ""))
    return mod


def test_cli_galaxy_shaped_net_checkpoint_loads_in_jax(tiny_rgb, capsys):
    """Color -> Elastic -> Conv -> Pool -> Hidden -> DropOut -> CenteredOut
    RBF (learned centers) trains through the deep family's twin; the JAX
    NeuralNet loads its checkpoint, centers included, and predicts the
    same."""
    trainer = train.main(["train", "torch_cli_rgb", "galaxy.prms"])
    assert trainer._mega_plan.epoch_fn is megastep_deep.deep_epoch
    out = capsys.readouterr().out
    rows = [l for l in out.splitlines() if l[:3].strip().isdigit()]
    assert [int(r.split()[0]) for r in rows] == [0, 1, 2]
    layers, tr, allwts = jax_load_params(_pkls()[0])
    assert len(allwts[-1]) == 3          # [w, b, centers]
    jnet = JaxNet(layers, tr, allwts)
    np.testing.assert_array_equal(
        np.asarray(jnet.net_layers[-1].params_init[2]),
        trainer.params[-1][2].numpy())
    jp, _ = jnet.init_params()
    j_feat, j_pred = jnet.predict(jp, jnp.asarray(tiny_rgb.testing_x))
    t_feat, t_pred = trainer.predict(tiny_rgb.testing_x)
    np.testing.assert_array_equal(t_pred, np.asarray(j_pred))
    np.testing.assert_allclose(t_feat, np.asarray(j_feat), atol=1e-5)


def test_cli_logit_head_reports_bit_error(tiny_rgb, capsys):
    trainer = train.main(["train", "torch_cli_rgb", "logit.prms"])
    assert trainer._mega_plan.epoch_fn is megastep_deep.deep_epoch
    out = capsys.readouterr().out
    assert "Epoch   Cost  Tr_Error Tr_BitErr    Te_Error Te_BitErr" in out
    # frozen LOGIT centers ride in the checkpoint after w and b
    _, _, allwts = load_params(_pkls()[0])
    assert len(allwts[-1]) == 3
    assert set(np.unique(allwts[-1][2])) <= {0.0, 1.0}


SLICE_PRMS = PRMS.replace("'invert_image': True}",
                          "'invert_image': True, 'method': 'pallas'}").replace(
    "'SEED': 17}", "'SEED': 17, 'FUSED_TAIL': True}")


def test_cli_fused_tail_slice_trains_per_layer_and_resumes(tiny_data, capsys):
    """The per-layer slice: an active ElasticLayer with 'method': 'pallas'
    and FUSED_TAIL. No fused family takes it, the decline reason is
    printed, every epoch trains per layer (the kernels' plain versions on
    the CPU: no launch is counted), the checkpoint resumes and the JAX
    package predicts the same from it."""
    from theanet_tpu_torch.ops import elastic_resample, fused_mlp

    with open("slice.prms", "w") as f:
        f.write(SLICE_PRMS)
    counts = (elastic_resample.elastic_resample.launches,
              fused_mlp.tail_forward.launches,
              fused_mlp.tail_backward.launches)
    trainer = train.main(["train", "torch_cli_tiny", "slice.prms"])
    assert trainer._mega is None and trainer.net.fused_tail
    cap = capsys.readouterr()
    assert megastep.FUSED_TAIL_REASON in cap.err
    rows = [l for l in cap.out.splitlines() if l[:3].strip().isdigit()]
    assert [int(r.split()[0]) for r in rows] == [0, 1, 2]
    assert all(np.isfinite(float(r.split()[1])) for r in rows)
    assert len(_pkls()) == 1
    assert counts == (elastic_resample.elastic_resample.launches,
                      fused_mlp.tail_forward.launches,
                      fused_mlp.tail_backward.launches)

    layers, tr, allwts = jax_load_params(_pkls()[0])
    assert tr["FUSED_TAIL"] and layers[0][1]["method"] == "pallas"
    jnet = JaxNet(layers, tr, allwts)
    assert jnet.fused_tail
    x = tiny_data.testing_x.reshape(-1, 1, IMG, IMG)
    jp, _ = jnet.init_params()
    j_feat, j_pred = jnet.predict(jp, jnp.asarray(x))
    t_feat, t_pred = trainer.predict(x)
    np.testing.assert_array_equal(t_pred, np.asarray(j_pred))
    np.testing.assert_allclose(t_feat, np.asarray(j_feat), atol=1e-5)

    resumed = train.main(["train", "torch_cli_tiny", _pkls()[0]])
    rows = [l for l in capsys.readouterr().out.splitlines()
            if l[:3].strip().isdigit()]
    assert [int(r.split()[0]) for r in rows] == [2, 3, 4]
    assert resumed.net.get_epoch() == 4


@pytest.mark.parametrize("var,value", [("THEANET_STEPWISE", "1")])
def test_unported_cli_switches_raise(var, value, tiny_data, monkeypatch):
    """The JAX CLI's THEANET_STEPWISE=1 is not ported: the port's CLI stops
    and names the switch instead of training without it."""
    monkeypatch.setenv(var, value)
    with pytest.raises(NotImplementedError, match=var):
        train.main(["train", "torch_cli_tiny", "tiny.prms"])


def test_profile_dir_writes_a_trace_with_the_spans(tiny_data, monkeypatch,
                                                   tmp_path, capsys):
    """THEANET_PROFILE_DIR: a Chrome trace of the round that trains epoch 1
    and its test boundary, holding the port's spans; the spans are off
    again after it."""
    monkeypatch.setenv("THEANET_PROFILE_DIR", str(tmp_path / "trace"))
    train.main(["train", "torch_cli_tiny", "tiny.prms"])
    files = list((tmp_path / "trace").glob("*.json"))
    assert [f.name for f in files] == ["tiny_000017_epoch1.json"]
    text = files[0].read_text()
    for name in ("trainer.run_epochs", "trainer.evaluate",
                 "checkpoint.write", "cli.test_boundary"):
        assert f'"theanet.{name}"' in text, name
    err = capsys.readouterr().err
    assert "profiler trace written to " + str(files[0]) in err
    # the round's spans by self time, and its reads: the cost row, two an
    # eval window, the checkpoint's 8 tensors
    table = err.split("span self times of the profiled round")[1]
    for name in ("trainer.run_epochs", "trainer.evaluate",
                 "net.snapshot_params", "checkpoint.write",
                 "cli.test_boundary"):
        assert "\n  " + name + " " in table, name
    assert "\n  trainer.evaluate            2 " in table
    assert "host reads in the profiled round: 13\n" in err
    # the CPU runs the twin: no tiled input- or weight-gradient launch
    assert "tiled input-gradient launches in the profiled round: 0\n" in err
    assert "tiled weight-gradient launches in the profiled round: 0\n" in err
    assert not tracing.RECORDER.on and tracing.take() == []


def test_profile_dir_stops_when_the_round_raises(tiny_data, monkeypatch,
                                                 tmp_path):
    """A profiled round that raises leaves the profiler and the spans off
    and writes no trace."""
    monkeypatch.setenv("THEANET_PROFILE_DIR", str(tmp_path / "trace"))
    save = Trainer.save_checkpoint
    saves = []

    def save_then_fail(self, path):
        saves.append(path)
        if len(saves) == 2:         # epoch 1's boundary
            raise OSError("disk full")
        return save(self, path)

    monkeypatch.setattr(Trainer, "save_checkpoint", save_then_fail)
    with pytest.raises(OSError, match="disk full"):
        train.main(["train", "torch_cli_tiny", "tiny.prms"])
    assert len(saves) == 2
    assert not torch._C._autograd._profiler_enabled()
    assert not tracing.RECORDER.on and tracing.take() == []
    assert not (tmp_path / "trace").exists()
