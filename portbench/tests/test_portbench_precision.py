"""The reference computes in float32 by itself: it turns the library's
TF32 off around every call, whatever the process set, and restores the
process's settings after."""

import pytest
import torch

from portbench import cells, compare, noise, reference
from portbench.netdesc import net_from_layers


def set_tf32(on):
    """Turn the library's TF32 on or off for float32 products and
    convolutions, by the switches this torch has."""
    for o, k, off in reference._tf32_switches():
        setattr(o, k, ("tf32" if isinstance(off, str) else True)
                if on else off)


@pytest.fixture
def tf32_on():
    switches = reference._tf32_switches()
    old = [getattr(o, k) for o, k, _ in switches]
    set_tf32(True)
    yield
    for (o, k, _), v in zip(switches, old):
        setattr(o, k, v)


def small_case(device, batch=4, seed=11):
    cfg = cells.config("mnist_cnn")
    layers = cells.layers(cfg)
    net = net_from_layers(layers, batch, 28, 1)
    leaves = reference.to_leaves(reference.init_framework(layers, net, seed),
                                 net, device)
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((2 * batch, 1, 28, 28), generator=g)
    y = torch.randint(0, 10, (2 * batch,), generator=g)
    return net, leaves, x.to(device), y.to(device)


def reference_outputs(device):
    net, leaves, x, y = small_case(device)
    rows = compare.step_rows(net, x.cpu().numpy(), y.cpu().numpy(), device)
    bits = noise.epoch_noise_bits(5, 0, net, rows[0].shape[0], device)
    moms = [torch.zeros_like(t) for t in leaves]
    state, _, costs, _ = reference.train_epoch(net, leaves, moms, *rows, bits,
                                               0.1)
    return reference.eval_stats(net, leaves, x, y), costs, state


def test_reference_turns_tf32_off_inside_and_restores_it(tf32_on,
                                                         monkeypatch):
    seen = []
    real_conv = reference.F.conv2d

    def conv2d(*a, **kw):
        seen.append(reference.tf32_off())
        return real_conv(*a, **kw)

    monkeypatch.setattr(reference.F, "conv2d", conv2d)
    assert not reference.tf32_off()
    stats, costs, state = reference_outputs("cpu")
    assert seen and all(seen)
    assert not reference.tf32_off()            # the process's TF32 back on
    set_tf32(False)
    again = reference_outputs("cpu")
    assert again[0] == stats and torch.equal(again[1], costs)
    assert all(torch.equal(a, b) for a, b in zip(again[2], state))


def test_exact_f32_restores_the_settings_after_an_error(tf32_on):
    with pytest.raises(RuntimeError):
        with reference.exact_f32():
            assert reference.tf32_off()
            raise RuntimeError("inside")
    assert not reference.tf32_off()


@pytest.mark.card
def test_reference_ignores_the_process_tf32_on_the_card(tf32_on):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    g = torch.Generator(device="cuda").manual_seed(3)
    a = torch.randn((256, 256), device="cuda", generator=g)
    with reference.exact_f32():
        exact = a @ a
    assert not torch.equal(a @ a, exact)       # the process's TF32 bites
    stats, costs, state = reference_outputs("cuda")
    set_tf32(False)
    again = reference_outputs("cuda")
    assert again[0] == stats and torch.equal(again[1], costs)
    assert all(torch.equal(p, q) for p, q in zip(again[2], state))
