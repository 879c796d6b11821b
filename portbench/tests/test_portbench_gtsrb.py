"""The gtsrb_mcdnn configuration in the benchmark: its frozen generator
against the port's, the benchmark's reading of its net (``netdesc``), its
counts, and its noise words and initial weights against the port's, on
the CPU."""

import numpy as np
import pytest
import torch

from portbench import cells, counts, harness, noise, reference
from portbench.data import signs48 as pb_signs48
from portbench.netdesc import net_from_layers

CELL = "gtsrb_mcdnn.fused.b20"


def _net(batch=20):
    cfg = cells.config("gtsrb_mcdnn")
    return cfg, net_from_layers(cells.layers(cfg), batch, 48, 3)


@pytest.mark.parametrize("seed", [1234, 2 ** 31 + 5])
def test_signs48_matches_the_port(seed):
    from theanet_tpu_torch.data import signs48

    want = signs48.make_dataset(n_train=70, n_test=25, img_sz=48, seed=seed)
    got = pb_signs48.make(70, 25, 48, seed)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_netdesc_reads_the_config():
    cfg, net = _net()
    assert cells.cell(CELL)["config"] == cfg["name"] == "gtsrb_mcdnn"
    assert [(lv.cin, lv.maps, lv.filt, lv.pool, lv.side_in, lv.side_conv,
             lv.side_pool, lv.slope) for lv in net.levels] == [
        (3, 100, 7, 2, 48, 42, 21, 0.01), (100, 150, 4, 2, 21, 18, 9, 0.01),
        (150, 250, 4, 2, 9, 6, 3, 0.01)]
    assert (net.n_flat, net.n_hid, net.hid_slope, net.pdrop, net.n_out) == (
        2250, 300, 0.01, 0.0, 43)
    assert net.warp_active and net.elastic["nearest"]
    assert (net.elastic["translation"], net.elastic["angle"],
            net.elastic["zoom"], net.elastic["magnitude"],
            net.elastic["pflip"], net.elastic["invert"]) == (
        4.8, 5.0, 1.1, 0.0, 0.0, False)


def test_counts_of_the_column():
    """704.8 MFLOP a training image (14.096 GFLOP a step at batch 20) and
    1,543,443 state floats, 4.2 times mnist_cnn's 366,290."""
    _, net = _net()
    assert counts.state_elements(net) == 1543443
    assert round(counts.step_flops(net) / 1e9, 3) == 14.096
    assert round(counts.step_flops(net) / 20 / 1e6, 1) == 704.8
    mn = cells.config("mnist_cnn")
    mnist = net_from_layers(cells.layers(mn), 20, 28, 1)
    assert counts.state_elements(mnist) == 366290


def _port(batch, seed):
    """The port's net and Trainer of the configuration at ``batch`` on a
    small signs48 set, on the CPU, as the harness builds them."""
    cfg = dict(cells.config("gtsrb_mcdnn"), train_images=2 * batch,
               test_images=batch)
    cell = {"config": "gtsrb_mcdnn",
            "training_params": {"BATCH_SZ": batch, "MEGAFUSED": True,
                                "TEST_SAMP_SZ": batch}}
    data = harness.make_data(cfg, seed)
    net, trainer, tr = harness.build_trainer(cfg, cell, seed, data, "cpu")
    desc = net_from_layers(cells.layers(cfg), batch, 48, 3)
    return cfg, net, trainer, tr, desc


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_noise_words_match_the_port(seed):
    from theanet_tpu_torch.ops import megastep

    _, _, trainer, tr, desc = _port(4, seed)
    spec = trainer._mega_spec
    for epoch in (0, 7):
        want = megastep.epoch_noise_bits(tr["SEED"], epoch, spec, 2, "cpu")
        got = noise.epoch_noise_bits(tr["SEED"], epoch, desc, 2, "cpu")
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_initial_weights_match_the_port():
    cfg, _, trainer, tr, desc = _port(4, 2 ** 31 + 777)
    want = reference.to_leaves(trainer.params, desc, "cpu")
    got = reference.to_leaves(
        reference.init_framework(cells.layers(cfg), desc, tr["SEED"]), desc,
        "cpu")
    assert len(want) == len(got) == len(desc.state_shapes())
    for a, b, shape in zip(want, got, desc.state_shapes()):
        assert tuple(a.shape) == shape and torch.equal(a, b)


def _unchanged(fn):
    def epoch(kparams, kmoms, x, y, bits, lr, spec, **kw):
        _, _, cm = fn(kparams, kmoms, x, y, bits, lr, spec, **kw)
        return ([t.clone() for t in kparams], [t.clone() for t in kmoms], cm)
    return epoch


def _half_batch(fn):
    def epoch(kparams, kmoms, x, y, bits, lr, spec, **kw):
        B, h = spec.batch, spec.batch // 2
        x = x.reshape(x.shape[0], -1, B, x.shape[-1]).clone()
        x[:, :, h:2 * h] = x[:, :, :h]
        y = y.clone()
        y[:, h:2 * h] = y[:, :h]
        return fn(kparams, kmoms, x.reshape(x.shape[0], -1, x.shape[-1])
                  .contiguous(), y, bits, lr, spec, **kw)
    return epoch


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_deep_epoch_faults_make_correct_false(fault, small, monkeypatch):
    """The cell trains through the deep family, so its epoch faults are
    planted in ``megastep_deep.deep_epoch`` (test_portbench_control.py
    plants them in the flagship's ``megastep_epoch``, which this cell never
    calls)."""
    from theanet_tpu_torch.ops import megastep_deep as deep

    wrap = {"unchanged": _unchanged, "half_batch": _half_batch}[fault]
    monkeypatch.setattr(deep, "deep_epoch", wrap(deep.deep_epoch))
    assert harness.run(CELL, 2 ** 31 + 17, 0.3, False,
                       device="cpu")["correct"] is False
