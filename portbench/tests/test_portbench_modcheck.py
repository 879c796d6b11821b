"""The import check compares whole top-level names."""

import subprocess
import sys

from portbench import modcheck


def test_port_passes_jax_package_fails():
    assert modcheck.forbidden_modules(["theanet_tpu_torch",
                                       "theanet_tpu_torch.ops.megastep",
                                       "torch", "numpy"]) == []
    assert modcheck.forbidden_modules(["theanet_tpu",
                                       "theanet_tpu.ops"]) == ["theanet_tpu"]
    assert modcheck.forbidden_modules(["jax.numpy", "jaxlib.xla_client",
                                       "flax.linen"]) == ["flax", "jax",
                                                          "jaxlib"]
    assert modcheck.forbidden_modules(["jaxtyping", "flaxen",
                                       "theanet_tpu_tools"]) == []


def test_a_run_loads_no_jax():
    """The harness's modules, the port's Trainer path and the reference
    load neither JAX nor the JAX package."""
    code = ("import sys\n"
            "from portbench import harness, calibrate, reference\n"
            "from theanet_tpu_torch.trainer import Trainer\n"
            "from theanet_tpu_torch.ops import megastep, megastep_deep\n"
            "from portbench import modcheck\n"
            "print(modcheck.forbidden_modules(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=str(__import__("pathlib").Path(
                             __file__).resolve().parents[2]))
    assert out.stdout.strip() == "[]"
