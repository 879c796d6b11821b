"""Build and bind the hand-written CUDA kernels.

Each library of ``LIBRARIES`` (one ``csrc/*.cu`` source; the fused-epoch
ones include ``csrc/stages.cuh`` and ``csrc/ring.cuh``) is compiled at first
use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

into a shared library with a plain C interface, loaded with ``ctypes``. All
sources build at once, one nvcc process each. No ``--use_fast_math``: the
twins' log/sqrt/cos/sin/exp and floor(t+.5) must round the same way. The
libraries land in ``theanet_tpu_torch/_build/`` (listed in .gitignore),
named by a hash of the sources, so an edited source rebuilds and an
unchanged one is built once per checkout. Nothing here runs at import
time: the CPU tests import every module on a machine without nvcc.
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

__all__ = ["build", "megastep_launch", "deep_launch",
           "megastep_ring_launch", "deep_ring_launch", "ring_alloc",
           "ring_open", "ring_close", "ring_free", "ring_events_alloc",
           "ring_events_open", "ring_events_free", "ring_exchange_launch",
           "megastep_grad_launch", "deep_grad_launch",
           "megastep_update_launch", "deep_update_launch",
           "elastic_resample_launch", "fused_mlp_forward_launch",
           "fused_mlp_backward_launch", "conv3x3_forward_launch",
           "conv3x3_backward_launch", "floor_probe_launch",
           "conv_section_launch", "relay_probe_launch"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
# csrc/<name>.cu each
LIBRARIES = ("megastep", "megastep_deep", "elastic_resample", "fused_mlp",
             "conv3x3", "probes")
HEADERS = ("stages.cuh", "ring.cuh")
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# activation kinds in the order of stages.cuh's ACT_* codes
ACT_KINDS = ("leaky", "tanh", "scaled_tanh", "sigmoid", "softplus")
# head kinds, softmax-kind losses and max-norm kinds in the order of
# megastep_deep.cu's codes
HEAD_KINDS = ("softmax", "logit", "rbf", "softaux")
LOSS_KINDS = ("nll", "nllsq", "nllT", "hinge", "exp")
NORM_KINDS = ("rows", "cols", "bias")

_libs = {}
build_log = {}   # compiler output of the builds this process ran, by name


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built from source at first use")


def _so_path(name, flags):
    h = hashlib.sha1(" ".join(flags).encode())
    for f in (name + ".cu",) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(verbose=False):
    """Compile (where needed, all sources at once) and load every kernel
    library; returns {name: ctypes handle}. ``verbose`` adds ``-Xptxas -v``
    and keeps its report in ``build_log``."""
    if len(_libs) == len(LIBRARIES):
        return _libs
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    jobs = []
    for name in LIBRARIES:
        so = _so_path(name, NVCC_FLAGS)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc()] + flags + ["-o", tmp, str(CSRC / (name + ".cu"))]
            jobs.append((name, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    failed = []
    for name, so, tmp, proc in jobs:
        build_log[name] = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(name)
        else:
            os.replace(tmp, so)   # atomic: concurrent builds cannot collide
    if failed:
        raise RuntimeError("nvcc failed building %s:\n%s" % (
            ", ".join(failed), "\n".join(build_log[n] for n in failed)))
    for name in LIBRARIES:
        _libs[name] = _bind(name, ctypes.CDLL(str(_so_path(name,
                                                          NVCC_FLAGS))))
    return _libs


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entry points of the per-layer kernels: argument types, in order
ENTRY_POINTS = {
    "elastic_resample": {
        "elastic_resample": [_P] * 5 + [_I] * 5 + [_F, _I, _P]},
    "fused_mlp": {
        "fused_mlp_forward": [_P] * 9 + [_I] * 4 + [_F] * 3 + [_I] * 2 + [_P],
        "fused_mlp_backward": [_P] * 14 + [_I] * 4 + [_F] * 2 + [_I] * 2
                              + [_P]},
    "conv3x3": {
        "conv3x3_forward": [_P] * 3 + [_I] * 6 + [_P],
        "conv3x3_backward": [_P] * 6 + [_I] * 7 + [_P]},
    "probes": {
        "floor_probe": [_P] * 4 + [_I] * 4 + [_P, _I, _P, _I, _P],
        "conv_section": [_P] * 3 + [_I] * 3 + [_P] * 3 + [_I, _P],
        "relay_probe": [_P] + [_I] * 4 + [_P, _P, _I, _P]},
}


def _bind(name, lib):
    if name in ENTRY_POINTS:
        for fn, argtypes in ENTRY_POINTS[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        err = getattr(lib, name + "_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        if name == "probes":
            lib.conv_section_scratch_floats.argtypes = []
            lib.conv_section_scratch_floats.restype = ctypes.c_longlong
        return lib
    ip, fp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
    prefix = "megastep" if name == "megastep" else "deep"
    ws = getattr(lib, prefix + "_workspace_floats")
    ws.argtypes = [ip, fp]
    ws.restype = ctypes.c_longlong
    err = getattr(lib, prefix + "_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    epoch = getattr(lib, prefix + "_epoch")
    epoch.argtypes = [ip, fp, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                      ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p]
    epoch.restype = ctypes.c_int
    # the data-parallel step's two entries (one step, no n_steps)
    grad = getattr(lib, prefix + "_grad_step")
    grad.argtypes = [ip, fp, ctypes.POINTER(ctypes.c_void_p),
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    grad.restype = ctypes.c_int
    update = getattr(lib, prefix + "_update")
    update.argtypes = [ip, fp, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    update.restype = ctypes.c_int
    # the whole-epoch data-parallel entry and the exchange of csrc/ring.cuh
    ring = getattr(lib, prefix + "_ring_epoch")
    ll = ctypes.POINTER(ctypes.c_longlong)
    ring.argtypes = epoch.argtypes[:6] + [ll, ll] + epoch.argtypes[6:]
    ring.restype = ctypes.c_int
    for fn, argtypes in (
            ("ring_alloc", [ctypes.c_longlong, ctypes.c_int,
                            ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p]),
            ("ring_open", [ctypes.c_char_p, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_void_p)]),
            ("ring_close", [ctypes.c_void_p, ctypes.c_int]),
            ("ring_free", [ctypes.c_void_p, ctypes.c_int]),
            ("ring_events_alloc", [ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_void_p),
                                   ctypes.c_char_p]),
            ("ring_events_open", [ctypes.c_char_p, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_void_p)]),
            ("ring_events_free", [ctypes.POINTER(ctypes.c_void_p),
                                  ctypes.c_int]),
            ("ring_exchange", [ll, ctypes.c_longlong,
                               ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_void_p, ll,
                               ctypes.c_int, ctypes.c_void_p])):
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.ring_buffer_bytes.argtypes = [ctypes.c_longlong]
    lib.ring_buffer_bytes.restype = ctypes.c_longlong
    return lib


def _arrays(ints, floats):
    return ((ctypes.c_int * len(ints))(*ints),
            (ctypes.c_float * len(floats))(*floats))


def _warp_flags(spec):
    return [int(bool(spec.translation)), int(bool(spec.magnitude)),
            int(spec.zoom != 1), int(bool(spec.angle))]


def _warp_floats(spec):
    return [spec.translation, math.log(spec.zoom), spec.magnitude,
            spec.pflip, spec.angle * math.pi / 180.0, spec.img - 1 - 0.001]


def _reg_floats(r):
    return [r.L1, 2.0 * r.L2, r.L2, r.momentum, 1.0 - r.momentum, r.rate,
            r.maxnorm]


def _spec_arrays(spec):
    """The flagship kernel's integer and float spec tables (order fixed by
    the enums at the top of megastep.cu)."""
    ints = [spec.batch, spec.in_ch, spec.img, spec.filt1, spec.filt2,
            spec.maps1, spec.maps2, spec.n_hid, spec.n_out, spec.pool1,
            spec.pool2, int(spec.ib1), int(spec.ib2),
            ACT_KINDS.index(spec.act1), ACT_KINDS.index(spec.act2),
            ACT_KINDS.index(spec.act_h), int(spec.invert), int(spec.nearest),
            *_warp_flags(spec), int(bool(spec.pflip)), int(bool(spec.pdrop))]
    floats = [spec.slope1, spec.slope2, spec.slope_h, spec.pdrop]
    floats += _warp_floats(spec)
    for r in (spec.reg1, spec.reg2, spec.reg_h, spec.reg_o):
        floats += _reg_floats(r)
    return _arrays(ints, floats)


def _deep_arrays(spec):
    """The deep kernel's integer and float tables (order fixed by the enums
    at the top of megastep_deep.cu): a header, one entry per conv level
    (its geometry from ``DeepSpec.levels``: input side, conv side, pooled
    side, pad, conv stride), per pre-hidden layer and per state tensor."""
    from .megastep import db_lanes, fb_lanes
    from .megastep_deep import deep_kernel_shapes, deep_reg_kinds

    shapes, kinds = deep_kernel_shapes(spec), deep_reg_kinds(spec)
    nah, nao = spec.n_aux or spec.aux_concat or (0, 0)
    ints = [spec.batch, spec.in_ch, spec.img, spec.n_levels,
            len(spec.pre_hidden), spec.n_hid, spec.n_out, spec.n_classes,
            HEAD_KINDS.index(spec.head), ACT_KINDS.index(spec.act_h),
            int(spec.color), int(spec.invert), int(spec.nearest),
            *_warp_flags(spec), int(spec.learn_centers), fb_lanes(spec),
            db_lanes(spec), len(shapes), LOSS_KINDS.index(spec.loss), nah,
            nao, int(bool(spec.aux_concat)), int(spec.mean_tail)]
    floats = [spec.slope_h, spec.pdrop, spec.translation, math.log(spec.zoom),
              spec.magnitude, spec.pflip, spec.angle * math.pi / 180.0,
              spec.img - 1 - 0.001, math.log(spec.balance),
              math.log(spec.gamma), spec.maxval, 1.0 / spec.maxval,
              spec.junk_dist, spec.boost, spec.log_thresh]
    cin = spec.in_ch
    for k, (side, pad, cs, c, po) in enumerate(spec.levels):
        ints += [cin, spec.maps[k], spec.filts[k], side, c, po,
                 spec.pools[k], int(spec.ibs[k]),
                 ACT_KINDS.index(spec.acts[k]), pad, cs]
        floats.append(spec.slopes[k])
        cin = spec.maps[k]
    for width, act, slope, pd in spec.pre_hidden:
        ints += [width, ACT_KINDS.index(act)]
        floats += [slope, pd]
    for (rows, cols), (reg, kind) in zip(shapes, kinds):
        ints += [rows * cols, NORM_KINDS.index(kind), rows, cols]
        floats += _reg_floats(reg)
    return _arrays(ints, floats)


def _workspace(prefix, lib, ispec, fspec, dev):
    n_ws = getattr(lib, prefix + "_workspace_floats")(ispec, fspec)
    if n_ws < 0:
        raise ValueError(f"{prefix} CUDA kernel: the spec's tables are out "
                         "of the kernel's range")
    return torch.empty(n_ws, dtype=torch.float32, device=dev)


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(
        *[0 if t is None else t.data_ptr() for t in tensors])


def _entry(prefix, lib, entry, *args, dev):
    """Call ``<prefix>_<entry>`` with ``args``, then the device and the
    current stream; raise on a nonzero return."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib, f"{prefix}_{entry}")(*args, dev.index or 0, stream)
    if rc != 0:
        raise RuntimeError("%s CUDA kernel failed: %s" % (
            f"{prefix}_{entry}",
            getattr(lib, prefix + "_error_string")(rc).decode()))


def _run(prefix, lib, ispec, fspec, tensors, n_steps, lr, dev, ring=None):
    """An epoch entry: ``<prefix>_epoch``, or with a ring table
    ``<prefix>_ring_epoch``, which returns the number of exchange kernels
    it launched."""
    ws = _workspace(prefix, lib, ispec, fspec, dev)
    if ring is None:
        _entry(prefix, lib, "epoch", ispec, fspec, _ptrs(tensors), n_steps,
               lr, ws.data_ptr(), dev=dev)
        return 0
    launched = ctypes.c_longlong(0)
    _entry(prefix, lib, "ring_epoch", ispec, fspec, _ptrs(tensors),
           n_steps, lr, ws.data_ptr(), ring, ctypes.byref(launched),
           dev=dev)
    return launched.value


def megastep_launch(spec, x, y, bits, gh, gw, params, moms, cm, lr):
    """One epoch of the flagship CUDA kernel on the current stream:
    ``params`` and ``moms`` (8 each) are updated in place, ``cm`` (n_steps,
    2) written. The caller has checked devices, dtypes, shapes and
    contiguity."""
    ispec, fspec = _spec_arrays(spec)
    _run("megastep", build()["megastep"], ispec, fspec,
         [x, y, *bits, gh, gw, *params, *moms, cm], x.shape[0], lr,
         x.device)


def deep_launch(spec, x, y, bits, consts, aux, params, moms, cm, lr):
    """One epoch of the deep CUDA kernel (a DeepSpec; the flat-MLP family
    passes its zero-level one) on the current stream, as megastep_launch;
    ``consts`` are deep_step_constants (gh, gw, the frozen CenteredOut
    centers, the frozen AuxConcat encoder; None where the net has none),
    ``aux`` the (n_steps, B, 4) aux rows or None."""
    ispec, fspec = _deep_arrays(spec)
    _run("deep", build()["megastep_deep"], ispec, fspec,
         [x, y, *bits, *consts, aux, *params, *moms, cm], x.shape[0], lr,
         x.device)


def megastep_ring_launch(spec, x, y, bits, gh, gw, params, moms, cm, lr,
                         ring):
    """One data-parallel rank's epoch by the flagship library
    (``megastep_ring_epoch``): as megastep_launch on the rank's shard, with
    ``ring`` the ring table (ops/megastep_ring.py ring_table). Returns the
    number of exchange kernels launched."""
    ispec, fspec = _spec_arrays(spec)
    return _run("megastep", build()["megastep"], ispec, fspec,
         [x, y, *bits, gh, gw, *params, *moms, cm], x.shape[0], lr,
         x.device, ring)


def deep_ring_launch(spec, x, y, bits, consts, aux, params, moms, cm, lr,
                     ring):
    """As megastep_ring_launch for a DeepSpec (``deep_ring_epoch``), with
    deep_launch's ``consts`` and ``aux``."""
    ispec, fspec = _deep_arrays(spec)
    return _run("deep", build()["megastep_deep"], ispec, fspec,
         [x, y, *bits, *consts, aux, *params, *moms, cm], x.shape[0], lr,
         x.device, ring)


# The exchange buffers of csrc/ring.cuh. ``lib_name`` is the family's
# library (each holds the exchange); pointers are Python ints.
_PREFIX = {"megastep": "megastep", "megastep_deep": "deep"}


def _ring_check(lib_name, rc, what):
    if rc != 0:
        lib = build()[lib_name]
        raise RuntimeError("%s failed: %s" % (
            what, getattr(lib, _PREFIX[lib_name] + "_error_string")(
                rc).decode()))


def ring_alloc(lib_name, n_grads, dev):
    """Allocate (cudaMalloc) and zero this rank's exchange buffer for
    ``n_grads`` gradient floats on ``dev``: (pointer, 64-byte IPC
    handle)."""
    lib = build()[lib_name]
    ptr, handle = ctypes.c_void_p(), ctypes.create_string_buffer(64)
    _ring_check(lib_name, lib.ring_alloc(lib.ring_buffer_bytes(n_grads),
                                         dev.index or 0, ctypes.byref(ptr),
                                         handle), "ring_alloc")
    return ptr.value, handle.raw


def ring_open(lib_name, handle, dev):
    """Map another rank's exchange buffer from its IPC handle: its
    pointer in this process."""
    ptr = ctypes.c_void_p()
    _ring_check(lib_name, build()[lib_name].ring_open(
        handle, dev.index or 0, ctypes.byref(ptr)),
        "ring_open (cudaIpcOpenMemHandle)")
    return ptr.value


def ring_close(lib_name, ptr, dev):
    """Unmap a buffer that ring_open mapped."""
    _ring_check(lib_name, build()[lib_name].ring_close(ptr, dev.index or 0),
                "ring_close")


def ring_free(lib_name, ptr, dev):
    """Free this rank's buffer (after every other rank unmapped it)."""
    _ring_check(lib_name, build()[lib_name].ring_free(ptr, dev.index or 0),
                "ring_free")


def ring_events_alloc(lib_name, dev):
    """This rank's 4 interprocess events (the ring's waits): (their
    pointers, their IPC handles, 4 x 64 bytes)."""
    ev, handles = (ctypes.c_void_p * 4)(), ctypes.create_string_buffer(256)
    _ring_check(lib_name, build()[lib_name].ring_events_alloc(
        dev.index or 0, ev, handles), "ring_events_alloc")
    return list(ev), handles.raw


def ring_events_open(lib_name, handles, dev):
    """Another rank's 4 events from their IPC handles: their pointers."""
    ev = (ctypes.c_void_p * 4)()
    _ring_check(lib_name, build()[lib_name].ring_events_open(
        handles, dev.index or 0, ev), "ring_events_open "
        "(cudaIpcOpenEventHandle)")
    return list(ev)


def ring_events_free(lib_name, ev, dev):
    """Destroy 4 events that ring_events_alloc or ring_events_open made."""
    _ring_check(lib_name, build()[lib_name].ring_events_free(
        (ctypes.c_void_p * 4)(*ev), dev.index or 0), "ring_events_free")


def ring_buffer_bytes(lib_name, n_grads):
    """Bytes of one rank's exchange buffer (csrc/ring.cuh)."""
    return build()[lib_name].ring_buffer_bytes(n_grads)


def ring_exchange_launch(lib_name, ring, n_grads, step, phase, out, cm):
    """One phase (1-3) of one step's exchange outside an epoch
    (``ring_exchange``) on the current stream: phase 3 writes the reduced
    gradient to ``out`` and (cost, minf) to ``cm``. Returns the number of
    exchange kernels launched."""
    dev = out.device
    launched = ctypes.c_longlong(0)
    rc = build()[lib_name].ring_exchange(
        ring, n_grads, step, phase, out.data_ptr(), cm.data_ptr(),
        ctypes.byref(launched), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    _ring_check(lib_name, rc, "ring_exchange")
    return launched.value


def megastep_grad_launch(spec, x, y, words, gh, gw, params, grads, cm):
    """One data-parallel step's gradient by the flagship CUDA library
    (``megastep_grad_step``) on the current stream: ``grads`` (the flat
    buffer of the 8 state tensors) and ``cm`` (2,) are written, ``params``
    read. The caller has checked devices, dtypes, shapes and contiguity."""
    ispec, fspec = _spec_arrays(spec)
    lib = build()["megastep"]
    ws = _workspace("megastep", lib, ispec, fspec, x.device)
    _entry("megastep", lib, "grad_step", ispec, fspec,
           _ptrs([x, y, *words, gh, gw, *params, grads, cm]), ws.data_ptr(),
           dev=x.device)


def megastep_update_launch(spec, params, moms, grads, lr):
    """The flagship update after the gradient all-reduce
    (``megastep_update``): ``params`` and ``moms`` in place from the flat
    ``grads``."""
    ispec, fspec = _spec_arrays(spec)
    _entry("megastep", build()["megastep"], "update", ispec, fspec,
           _ptrs([*params, *moms, grads]), lr, dev=grads.device)


def deep_grad_launch(spec, x, y, words, consts, aux, params, grads, cm):
    """As megastep_grad_launch for a DeepSpec (``deep_grad_step``), with
    deep_launch's ``consts`` and the step's (B, 4) ``aux`` rows or None."""
    ispec, fspec = _deep_arrays(spec)
    lib = build()["megastep_deep"]
    ws = _workspace("deep", lib, ispec, fspec, x.device)
    _entry("deep", lib, "grad_step", ispec, fspec,
           _ptrs([x, y, *words, *consts, aux, *params, grads, cm]),
           ws.data_ptr(), dev=x.device)


def deep_update_launch(spec, params, moms, grads, lr):
    """As megastep_update_launch for a DeepSpec (``deep_update``)."""
    ispec, fspec = _deep_arrays(spec)
    _entry("deep", build()["megastep_deep"], "update", ispec, fspec,
           _ptrs([*params, *moms, grads]), lr, dev=grads.device)


def _call(lib_name, fn, *args):
    """Call a per-layer kernel's C entry point with ``args`` (tensors pass
    their data pointer, None a null pointer), then its device and the
    current stream; raise on a nonzero return."""
    lib = build()[lib_name]
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = getattr(lib, fn)(*conv, dev.index or 0,
                          torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("%s CUDA kernel failed: %s" % (
            fn, getattr(lib, lib_name + "_error_string")(rc).decode()))


def elastic_resample_launch(x, ty, tx, words, out, nearest, pflip, invert):
    """One launch of csrc/elastic_resample.cu: ``out`` (x's shape) from x
    (B, C, H, W) at the warp (ty, tx); ``words`` None for no flip. The
    caller has checked devices, dtypes, shapes and contiguity."""
    b, c, h, w = x.shape
    _call("elastic_resample", "elastic_resample", x, ty, tx, words, out,
          b * c, h, w, int(nearest), int(invert), pflip)


def fused_mlp_forward_launch(x, w1, b1, w2, b2, words, logp, h, mask, slope,
                             pdrop, keep, drop):
    """The tail forward of csrc/fused_mlp.cu (2 launches); ``drop`` is 0
    (none), 1 (train mask from ``words``) or 2 (eval scale ``keep``)."""
    _call("fused_mlp", "fused_mlp_forward", x, w1, b1, w2, b2, words, logp,
          h, mask, x.shape[0], x.shape[1], w1.shape[1], w2.shape[1], slope,
          pdrop, keep, drop)


def fused_mlp_backward_launch(x, w1, w2, h, mask, logp, g, dx, dw1, db1, dw2,
                              db2, dz2, dz1, slope, keep, drop):
    """The tail backward of csrc/fused_mlp.cu (4 launches); dz2 and dz1
    are scratch."""
    _call("fused_mlp", "fused_mlp_backward", x, w1, w2, h, mask, logp, g, dx,
          dw1, db1, dw2, db2, dz2, dz1, x.shape[0], x.shape[1], w1.shape[1],
          w2.shape[1], slope, keep, drop)


def _conv3x3_dims(x, w):
    b, c, h, _ = x.shape
    return b, c, h, w.shape[0]


def conv3x3_forward_launch(x, w, out):
    """The forward of csrc/conv3x3.cu (1 launch) on the current stream, in
    x's dtype: ``out`` (B, M, H-2, H-2)."""
    _call("conv3x3", "conv3x3_forward", x, w, out, *_conv3x3_dims(x, w),
          int(x.dtype == torch.bfloat16))


def conv3x3_backward_launch(x, w, dz, dx, dw, part):
    """The backward of csrc/conv3x3.cu (3 launches) on the current stream,
    in x's dtype: ``dx`` and ``dw`` from ``dz``; ``part`` is its f32
    scratch of one (M, 9C) slab per batch slice."""
    _call("conv3x3", "conv3x3_backward", x, w, dz, dx, dw, part,
          *_conv3x3_dims(x, w), part.shape[0],
          int(x.dtype == torch.bfloat16))


def floor_probe_launch(inputs, out, U, per_launch):
    """csrc/probes.cu ``floor_probe`` over the (n_steps, ...) ``inputs``
    (f32, or int32 words) into ``out`` (n_steps, W); returns the number of
    kernel launches (1, or n_steps / U with ``per_launch``)."""
    n = len(inputs)
    ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in inputs])
    elems = (ctypes.c_longlong * n)(*[t[0].numel() for t in inputs])
    cols = (ctypes.c_int * n)(*[t.shape[-1] for t in inputs])
    isint = (ctypes.c_int * n)(*[int(t.dtype == torch.int32)
                                 for t in inputs])
    launched = ctypes.c_longlong(0)
    _call("probes", "floor_probe", ptrs, elems, cols, isint, n,
          out.shape[0], U, out.shape[1], out, int(per_launch),
          ctypes.byref(launched))
    return launched.value


def conv_section_launch(x, w, b2, out, variant, per_launch):
    """csrc/probes.cu ``conv_section`` over the (n_steps, 8, 128) blocks
    ``x``: ``out`` (n_steps, 2); ``variant`` 0 a block a step, 1 a thread
    per output. Returns the number of kernel launches."""
    scratch = None
    if variant == 1:
        n = build()["probes"].conv_section_scratch_floats()
        scratch = torch.empty(n, dtype=torch.float32, device=x.device)
    launched = ctypes.c_longlong(0)
    _call("probes", "conv_section", x, w, b2, x.shape[0], variant,
          int(per_launch), out, scratch, ctypes.byref(launched))
    return launched.value


def relay_probe_launch(x, G, g, out, per_launch):
    """csrc/probes.cu ``relay_probe`` over the (n_steps, 20, 784) batches
    ``x``: ``out`` (n_steps,). Returns the number of kernel launches."""
    launched = ctypes.c_longlong(0)
    _call("probes", "relay_probe", x, x.shape[0], G, g, int(per_launch),
          out, ctypes.byref(launched))
    return launched.value
