"""Build and bind the hand-written CUDA kernels.

``csrc/megastep.cu`` is compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

into a shared library with a plain C interface, loaded with ``ctypes``. No
``--use_fast_math``: the twin's log/sqrt/cos/sin/exp and floor(t+.5) must
round the same way. The library lands in ``theanet_tpu_torch/_build/``
(listed in .gitignore), named by a hash of the source, so an edited source
rebuilds and an unchanged one is built once per checkout. Nothing here runs
at import time: the CPU tests import every module on a machine without
nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["build", "megastep_launch"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "megastep.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# activation kinds in the order of megastep.cu's ACT_* codes
ACT_KINDS = ("leaky", "tanh", "scaled_tanh", "sigmoid", "softplus")

_lib = None
build_log = ""   # compiler output of the build this process ran, if any


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built from source at first use")


def build(verbose=False):
    """Compile (if needed) and load the kernel library; returns the ctypes
    handle. ``verbose`` adds ``-Xptxas -v`` and keeps its report in
    ``build_log``."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    src = SOURCE.read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"megastep_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = ([_nvcc()] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
               + ["-o", tmp, str(SOURCE)])
        res = subprocess.run(cmd, capture_output=True, text=True)
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError("nvcc failed building %s:\n%s"
                               % (SOURCE.name, build_log))
        os.replace(tmp, so)   # atomic: concurrent builders cannot collide
    lib = ctypes.CDLL(str(so))
    ip, fp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
    lib.megastep_workspace_floats.argtypes = [ip, fp]
    lib.megastep_workspace_floats.restype = ctypes.c_longlong
    lib.megastep_error_string.argtypes = [ctypes.c_int]
    lib.megastep_error_string.restype = ctypes.c_char_p
    lib.megastep_epoch.argtypes = [ip, fp, ctypes.POINTER(ctypes.c_void_p),
                                   ctypes.c_int, ctypes.c_float,
                                   ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p]
    lib.megastep_epoch.restype = ctypes.c_int
    _lib = lib
    return lib


def _spec_arrays(spec):
    """The kernel's integer and float spec tables (order fixed by the
    enums at the top of megastep.cu)."""
    ints = [spec.batch, spec.in_ch, spec.img, spec.filt1, spec.filt2,
            spec.maps1, spec.maps2, spec.n_hid, spec.n_out, spec.pool1,
            spec.pool2, int(spec.ib1), int(spec.ib2),
            ACT_KINDS.index(spec.act1), ACT_KINDS.index(spec.act2),
            ACT_KINDS.index(spec.act_h), int(spec.invert), int(spec.nearest),
            int(bool(spec.translation)), int(bool(spec.magnitude)),
            int(spec.zoom != 1), int(bool(spec.angle)),
            int(bool(spec.pflip)), int(bool(spec.pdrop))]
    floats = [spec.slope1, spec.slope2, spec.slope_h, spec.pdrop,
              spec.translation, math.log(spec.zoom), spec.magnitude,
              spec.pflip, spec.angle * math.pi / 180.0,
              spec.img - 1 - 0.001]
    for r in (spec.reg1, spec.reg2, spec.reg_h, spec.reg_o):
        floats += [r.L1, 2.0 * r.L2, r.L2, r.momentum, 1.0 - r.momentum,
                   r.rate, r.maxnorm]
    return ((ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * len(floats))(*floats))


def megastep_launch(spec, x, y, bits, gh, gw, params, moms, cm, lr):
    """One epoch of the CUDA kernel on the current stream: ``params`` and
    ``moms`` (8 each) are updated in place, ``cm`` (n_steps, 2) written.
    The caller has checked devices, dtypes, shapes and contiguity."""
    lib = build()
    ispec, fspec = _spec_arrays(spec)
    ws = torch.empty(lib.megastep_workspace_floats(ispec, fspec),
                     dtype=torch.float32, device=x.device)
    tensors = [x, y, *bits, gh, gw, *params, *moms, cm]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.megastep_epoch(ispec, fspec, ptrs, x.shape[0], lr,
                            ws.data_ptr(), x.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError("megastep CUDA kernel failed: %s"
                           % lib.megastep_error_string(rc).decode())
