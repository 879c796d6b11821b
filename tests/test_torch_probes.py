"""The probes' plain versions against the JAX package's Pallas probes.

``theanet_tpu_torch/tools/floor_probe.py`` and ``conv_layout_probe.py`` hold
the plain PyTorch version of each probe kernel of ``csrc/probes.cu`` (which
runs only on a card; ``chip_smoke.py`` phase 24 holds it to these). Here the
plain versions are held to the JAX tools' ``make_probe``, ``make_section``
and ``make_relay`` in interpret mode, on the same inputs, at a few steps.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from theanet_tpu_torch.tools import conv_layout_probe as clp
from theanet_tpu_torch.tools import floor_probe as fp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import conv_layout_probe as jclp  # noqa: E402  (the JAX tool)
import floor_probe as jfp  # noqa: E402

N_STEPS = 8


def _jax_dtype(shape, kind):
    """The JAX tool's types: y int32, the other words uint32."""
    if kind == fp.F32:
        return np.float32
    return np.int32 if shape == (20, 1) else np.uint32


@pytest.mark.parametrize("grid_u", [1, 2])
@pytest.mark.parametrize("out", ["vmem", "smem"])
@pytest.mark.parametrize("name", sorted(fp.VARIANTS))
def test_floor_plain_matches_jax_probe(name, out, grid_u):
    """Each step's row: rtol 1e-6 (the plain version sums each block
    exactly and rounds once; the JAX kernel sums in f32)."""
    ins = fp.variant_inputs(name, N_STEPS, "cpu")
    sd = [(s, _jax_dtype(s, k)) for s, k in fp.VARIANTS[name]]
    run = jfp.make_probe(sd, N_STEPS, out_mode=out, steps_per_iter=grid_u)
    want = np.asarray(run(*[jnp.asarray(t.numpy().astype(dt))
                            for t, (_, dt) in zip(ins, sd)]))[:N_STEPS]
    got = fp.floor_probe(ins, fp.OUT_WIDTH[out], grid_u)
    assert got.shape == want.shape == (N_STEPS, fp.OUT_WIDTH[out])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_section_plain_matches_jax_striped_probe():
    """The striped variant's function on its own inputs (RandomState(7)):
    rtol 5e-6 (6.0e-7 measured at 16 steps): the f32 products and sums of
    the conv and its gradients run in another order than the TPU kernel's
    matmuls."""
    run, arrs = jclp.make_section("striped", N_STEPS)
    want = np.asarray(run(*arrs))[:N_STEPS, 0]
    x, w2, b2 = clp.section_inputs(N_STEPS, "cpu")
    np.testing.assert_array_equal(x.numpy(), np.asarray(arrs[0]))
    np.testing.assert_array_equal(w2.numpy(), np.asarray(arrs[-2]))
    got = clp.conv_section(x, w2, b2)
    assert got.shape == (N_STEPS, 2)
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got[:, 0].numpy(), want, rtol=5e-6)


def test_section_input_gradient_check_is_whole():
    """The second column is the sum of the whole input gradient dpp, each
    (m1, b) plane; the section's input planes are equal across (m1, b), so
    each b's planes sum alike."""
    x, w2, b2 = clp.section_inputs(2, "cpu")
    total = clp.section_reference(x, w2, b2)[:, 1]
    assert np.all(np.isfinite(total.numpy())) and float(total.abs().max()) > 0


@pytest.mark.parametrize("G,g", [(5, 4), (10, 2)])
def test_relay_plain_matches_jax_probe(G, g):
    run, arrs = jclp.make_relay(N_STEPS, G, g)
    want = np.asarray(run(*arrs))[:N_STEPS, 0]
    x = clp.relay_inputs(N_STEPS, "cpu")
    np.testing.assert_array_equal(x.numpy(), np.asarray(arrs[0]))
    got = clp.relay_probe(x, G, g)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_probe_wrappers_refuse_a_device_without_a_kernel():
    x = torch.zeros((2, 8, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        clp.conv_section(x, x, x)
    with pytest.raises(ValueError, match="no kernel"):
        clp.relay_probe(torch.zeros((2, 20, 784), device="meta"), 5, 4)
    with pytest.raises(ValueError, match="no kernel"):
        fp.floor_probe([torch.zeros((2, 8, 128), device="meta")], 2)


@pytest.mark.parametrize("tool,args", [
    (fp, ["--variants", "mirror,tiny", "--grid-u", "2", "--out", "smem"]),
    (clp, ["--variants", "block,relay5x4"]),
])
def test_probe_tools_run_on_the_cpu(tool, args, capsys):
    tool.main(["--batches", "4", "--device", "cpu"] + args)
    out = capsys.readouterr().out
    assert "device cpu" in out and "plain version" in out


def test_conv_tool_names_the_tpu_layouts():
    with pytest.raises(SystemExit, match="TPU lane-slot layouts"):
        clp.main(["--batches", "2", "--device", "cpu", "--variants",
                  "grouped5x4"])
