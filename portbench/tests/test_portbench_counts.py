"""The FLOP and byte counts against hand counts."""

import pytest

from portbench import cells, counts, harness
from portbench.netdesc import net_from_layers


def net_of(config, batch):
    cfg = cells.config(config)
    return net_from_layers(cells.layers(cfg), batch, 28,
                           cfg["data"]["channels"])


def test_mnist_cnn_step_flops():
    net = net_of("mnist_cnn", 20)
    assert net.n_flat == 20 * 6 * 6
    conv1 = 20 * 4 * (3 * 26) ** 2 * 1 * 2 * 2         # forward + dw
    conv2 = 20 * 20 * (3 * 11) ** 2 * 4 * 2 * 3        # + dx
    dense = (720 * 500 + 500 * 10) * 20 * 2 * 3
    state = 36 + 4 + 720 + 20 + 720 * 500 + 500 + 500 * 10 + 10
    assert state == 366290 == counts.state_elements(net)
    assert counts.step_flops(net) == conv1 + conv2 + dense + 10 * state
    assert counts.step_flops(net) == 59864180


def test_epoch_bytes_and_bound_mnist():
    net = net_of("mnist_cnn", 20)
    per_step = 20 * 784 + 20 + 8 + 4 * 784 + 20 * 784 + 20 * 500 + 2
    assert counts.epoch_bytes(net, 600) == 4 * (600 * per_step
                                                + 4 * 366290)
    peaks = cells.peaks("NVIDIA H100 80GB HBM3")
    b = counts.bound_s(counts.epoch_bytes(net, 600),
                       600 * counts.step_flops(net), peaks)
    assert b == pytest.approx(600 * 59864180 / 67e12)   # operations bound
    assert b == pytest.approx(0.536e-3, rel=1e-3)


def test_wgrad_stage_mnist():
    net = net_of("mnist_cnn", 20)
    n_bytes, flops = counts.wgrad_step(net)
    o1, o2 = 20 * 4 * 26 ** 2, 20 * 20 * 11 ** 2
    assert flops == 2 * o1 * 9 + o1 + 2 * o2 * 36 + o2
    assert n_bytes == 4 * (o1 + 20 * 784 + 4 * 10) + 4 * (
        o2 + 20 * 4 * 13 ** 2 + 20 * 37)
    peaks = cells.peaks("NVIDIA H100 80GB HBM3")
    assert counts.bound_s(n_bytes, flops, peaks) == pytest.approx(
        0.158e-6, rel=1e-2)                                # bytes bound


def test_b256_counts_scale_with_batch():
    a, b = net_of("mnist_cnn", 20), net_of("mnist_cnn", 256)
    s = 10 * counts.state_elements(a)
    assert (counts.step_flops(b) - s) * 20 == (counts.step_flops(a) - s) * 256


def test_cell_batch_reaches_the_counts():
    cfg = cells.config("mnist_cnn")
    tr = harness.training_params(cfg, cells.cell("mnist_cnn.fused.b256"), 1)
    assert tr["BATCH_SZ"] == 256
