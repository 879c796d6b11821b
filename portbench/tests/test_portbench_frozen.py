"""The benchmark's frozen copies against the port's originals, byte for
byte at small sizes: the data generators, the noise words, the initial
weights, the training step (the port's plain twin runs the fused epoch on
the CPU) and the eval forward."""

import numpy as np
import pytest
import torch

from portbench import cells, compare, harness, noise, reference
from portbench.data import synth_hard as pb_synth_hard
from portbench.netdesc import net_from_layers


@pytest.mark.parametrize("seed", [1234, 2 ** 31 + 5])
def test_synth_hard_matches_the_port(seed):
    from theanet_tpu_torch.data import synth_hard

    want = synth_hard.make_dataset(n_train=40, n_test=15, seed=seed)
    got = pb_synth_hard.make(40, 15, 28, seed)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _port(config, batch, seed):
    """The port's net, plan and Trainer of ``config`` at ``batch`` on a
    small data set, on the CPU."""
    cfg = cells.config(config)
    cell = {"config": config,
            "training_params": {"BATCH_SZ": batch, "MEGAFUSED": True,
                                "TEST_SAMP_SZ": 2 * batch}}
    cfg = dict(cfg, train_images=3 * batch, test_images=2 * batch)
    data = harness.make_data(cfg, seed)
    net, trainer, tr = harness.build_trainer(cfg, cell, seed, data, "cpu")
    desc = net_from_layers(cells.layers(cfg), batch, 28, data[0].shape[1])
    return cfg, data, net, trainer, tr, desc


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_noise_words_match_the_port(seed):
    from theanet_tpu_torch.ops import megastep

    _, _, net, trainer, tr, desc = _port("mnist_cnn", 4, seed)
    spec = trainer._mega_spec
    for epoch in (0, 5):
        want = megastep.epoch_noise_bits(tr["SEED"], epoch, spec, 3, "cpu")
        got = noise.epoch_noise_bits(tr["SEED"], epoch, desc, 3, "cpu")
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_initial_weights_match_the_port():
    cfg, _, net, trainer, tr, desc = _port("mnist_cnn", 4, 777)
    want = reference.to_leaves(trainer.params, desc, "cpu")
    got = reference.to_leaves(
        reference.init_framework(cells.layers(cfg), desc, tr["SEED"]), desc,
        "cpu")
    assert len(want) == len(got) == len(desc.state_shapes())
    for a, b, shape in zip(want, got, desc.state_shapes()):
        assert tuple(a.shape) == shape and torch.equal(a, b)


def test_reference_epoch_matches_the_port_twin():
    """On the CPU the Trainer's fused epoch runs the port's plain twin; the
    benchmark's frozen reference gives the same bits."""
    cfg, data, net, trainer, tr, desc = _port("mnist_cnn", 4, 4242)
    x, y = data[0], data[1]
    _, costs, _ = trainer.run_epochs(1)
    trainer.evaluate("test", [0, 1])          # syncs the frame layout
    ref = compare.first_epoch(desc, cells.layers(cfg), tr, tr["SEED"],
                              compare.step_rows(desc, x, y, "cpu"))
    assert np.array_equal(costs[0], ref["costs"])
    for a, b in zip(reference.to_leaves(trainer.params, desc, "cpu"),
                    ref["state"]):
        assert torch.equal(a, b)
    for a, b in zip(reference.to_leaves(trainer.moms, desc, "cpu"),
                    ref["moms"]):
        assert torch.equal(a, b)


def test_eval_forward_matches_the_port():
    cfg, data, net, trainer, tr, desc = _port("mnist_cnn", 4, 31)
    trainer.run_epochs(1)
    for which, (xs, ys) in (("test", data[2:4]), ("train", data[0:2])):
        err, p = trainer.evaluate(which, [0, 1])
        leaves = reference.to_leaves(trainer.params, desc, "cpu")
        xw, yw = compare.eval_window(desc, torch.as_tensor(xs),
                                     torch.as_tensor(ys), [0, 1], "cpu")
        r_err, r_p, wrong = reference.eval_stats(desc, leaves, xw, yw)
        assert (err, p) == (r_err, r_p)
        assert round(err * 8 / 100) == wrong


def test_reference_follows_a_later_epoch_of_the_port_twin():
    """From the port's state and momenta after epoch 0, the reference's
    epoch 1 (its rate and noise words by its own count) gives the port's
    epoch 1, bit for bit."""
    cfg, data, net, trainer, tr, desc = _port("mnist_cnn", 4, 5150)
    trainer.run_epochs(1)
    trainer.evaluate("test", [0, 1])
    start = reference.to_leaves(trainer.params, desc, "cpu")
    moms = reference.to_leaves(trainer.moms, desc, "cpu")
    _, costs, _ = trainer.run_epochs(1)
    trainer.evaluate("test", [0, 1])
    ref = compare.follow(desc, tr, tr["SEED"], 1, start, moms,
                         compare.step_rows(desc, data[0], data[1], "cpu"))
    assert np.array_equal(costs[0], ref["costs"])
    for a, b in zip(reference.to_leaves(trainer.params, desc, "cpu"),
                    ref["state"]):
        assert torch.equal(a, b)
