"""Whole-epoch data-parallel fused training: one C call an epoch a rank,
with the gradient exchange inside the epoch.

Port of ``theanet_tpu/ops/megastep_ring.py``. The per-step data-parallel
path (``ops/megastep_dp.py``) makes three calls from Python a step (the
gradient kernel, an ``all_reduce``, the update kernel), and at one rank on
an H100 the device idles around them. Here each rank runs its whole epoch
in one C call (``megastep_ring_epoch`` in csrc/megastep.cu,
``deep_ring_epoch`` in csrc/megastep_deep.cu): a step is the epoch kernels'
own ``grad_stages`` on the rank's shard, the exchange of csrc/ring.cuh, and
their ``update_stages`` on the reduced gradient. At one rank there is no
exchange and the call is the single-device epoch kernel, to the bit.

The exchange (csrc/ring.cuh) is written by hand: every rank's gradient slot
lives in a buffer allocated in C and mapped by the other ranks through CUDA
IPC, and the ranks meet at monotonic step counters in those buffers: a rank
waits on the host for its peers' step, then through their IPC events, so no
kernel spins while the ranks share a card. Its sums follow the JAX ring's
orders exactly, so every rank holds the same bits (``exchange_reference``
is the plain version):

  * gather mode (n = 2, or ``THEANET_RING_RS=0``): the canonical sum
    g0 + g1 + ... + g(n-1), then times (float32)(1/n);
  * reduce-scatter mode (n >= 3, or ``THEANET_RING_RS=1`` at n > 1): the
    state is cut into ``owner_groups`` (the JAX package's ``_owner_groups``)
    and owner c's chunks sum in the hop order ((g(c+1) + g(c+2)) + ...) +
    g(c); every rank takes the owner's sum and multiplies by 1/n;
  * the per-step cost is (c0 + ... + c(n-1)) * (1/n), minf the minimum.

The JAX package's ``_RING_MB`` (24 MB of the TPU's VMEM for the ring
buffers) has no counterpart: the buffers live in device memory, two
gradient sets and two owned sets a rank (5.9 MB at mnist_cnn).

On CPU tensors there is no peer memory: under ``THEANET_DP_RING=1`` the
epoch runs the plain exchange, one ``dist.all_gather`` of the flat
gradients a step, so that the tests can drive real gloo ranks; under
``'auto'`` the Trainer keeps the per-step path there, as the JAX package
keeps its per-step path off the TPU.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .megastep import MegaSpec, check_epoch_inputs, smoothing_factors
from .megastep_deep import check_aux, deep_step_constants
from .megastep_dp import (constants, dp_decline_reason, dp_shard_words,
                          family, grad_step, grad_step_reference,
                          local_spec, update, update_reference)

__all__ = ["use_rs", "ring_mode", "owner_groups", "flat_chunks",
           "ring_decline_reason", "ring_table",
           "exchange_reference",
           "buffer_views", "ring_exchange", "ring_epoch_reference",
           "megastep_ring_epoch", "deep_ring_epoch", "RingBuffers",
           "make_ring_epoch_fn"]

# the kernel's tables (csrc/ring.cuh RING_MAX_RANKS, RING_MAX_CHUNKS)
MAX_RANKS = 8
MAX_CHUNKS = 64
# a rank's exchange buffer in floats (csrc/ring.cuh): a header (two u64
# step counters, an error word), two (cost, minf) slots, two gradient
# slots, two owned slots
RING_HEADER, RING_STATS = 64, 64
# a ring wait that outlasts this raises (a dead or stalled peer), in seconds
WAIT_LIMIT_S = 60.0
RING_MODES = ("auto", "0", "1")


def ring_mode():
    """``THEANET_DP_RING``: 'auto' (the ring where it takes the net, on a
    card), '1' (the ring or an error) or '0' (the per-step path)."""
    mode = os.environ.get("THEANET_DP_RING", "auto")
    if mode not in RING_MODES:
        raise ValueError(f"THEANET_DP_RING must be one of {RING_MODES} "
                         f"(got {mode!r})")
    return mode


def use_rs(n_data):
    """The exchange mode (the JAX package's ``_use_rs``), from
    ``THEANET_RING_RS`` (auto|0|1): reduce-scatter + all-gather for n_data
    >= 3; at n_data == 2 the two move the same bytes and the gather stays;
    '1' forces reduce-scatter at n_data > 1, '0' forbids it."""
    env = os.environ.get("THEANET_RING_RS", "auto")
    if env == "0":
        return False
    if env == "1":
        return n_data > 1
    return n_data >= 3


def owner_groups(kshapes, n_data):
    """Static owner -> chunk partition of the state for the reduce-scatter
    (the JAX package's ``_owner_groups``, the same algorithm): chunks are
    (tensor, row0, rows) row slices; a tensor larger than its fair share of
    the set is cut into n_data 8-aligned row bands, then the chunks are
    greedily size-balanced over the owners, largest first."""
    total = sum(int(np.prod(s)) for s in kshapes)
    fair = -(-total // n_data)
    chunks = []
    for t, s in enumerate(kshapes):
        rows = s[0]
        if int(np.prod(s)) > fair and rows >= 2 * 8:
            band = max(8, (-(-rows // n_data) + 7) // 8 * 8)
            r0 = 0
            while r0 < rows:
                rb = min(band, rows - r0)
                chunks.append((t, r0, rb))
                r0 += rb
        else:
            chunks.append((t, 0, rows))
    order = sorted(range(len(chunks)),
                   key=lambda i: -chunks[i][2] * int(np.prod(
                       kshapes[chunks[i][0]][1:], dtype=np.int64)))
    groups = [[] for _ in range(n_data)]
    loads = [0] * n_data
    for i in order:
        t, _r0, rb = chunks[i]
        c = min(range(n_data), key=lambda d: loads[d])
        groups[c].append(chunks[i])
        loads[c] += rb * int(np.prod(kshapes[t][1:], dtype=np.int64))
    return tuple(tuple(g) for g in groups)


def flat_chunks(kshapes, groups):
    """``owner_groups`` as (start, length, owner) ranges of the flat
    gradient buffer (the state tensors back to back in layout order)."""
    offs = np.cumsum([0] + [int(np.prod(s)) for s in kshapes])
    return [(int(offs[t]) + r0 * int(np.prod(kshapes[t][1:])),
             rb * int(np.prod(kshapes[t][1:])), c)
            for c, g in enumerate(groups) for t, r0, rb in g]


def _chunks(spec, n_data, rs):
    """The reduce-scatter chunks of the local ``spec`` on n_data ranks, or
    None in gather mode (``rs`` false)."""
    if not rs:
        return None
    shapes = family(spec).shapes(spec)
    return flat_chunks(shapes, owner_groups(shapes, n_data))


def ring_decline_reason(spec, n_data, mesh, mode=None):
    """Why the ring cannot take the global ``spec`` on ``mesh`` (the JAX
    package's ``ring_supported``, with the reason named), or None. It needs
    what the per-step path needs (``dp_decline_reason`` at the local
    batch), at most MAX_RANKS ranks and MAX_CHUNKS reduce-scatter chunks
    (the kernel's tables), and peer memory: on the CPU only the plain
    exchange under THEANET_DP_RING=1; on CUDA the ranks must share one
    host (``mesh.hosts``; CUDA IPC and the shared host counters do not
    cross hosts) and their cards (card rank % device_count, as make_mesh
    places them) must be one card or peers. The JAX package's VMEM budget for its ring buffers (``_RING_MB``) has
    no counterpart: the buffers live in device memory. Static facts only:
    nothing is built, mapped or launched."""
    why = dp_decline_reason(spec, n_data)
    if why:
        return why
    if n_data > MAX_RANKS:
        return (f"{n_data} ranks: the ring's exchange takes at most "
                f"{MAX_RANKS}")
    chunks = _chunks(local_spec(spec, spec.batch // n_data), n_data,
                     use_rs(n_data))
    if chunks is not None and len(chunks) > MAX_CHUNKS:
        return (f"{len(chunks)} reduce-scatter chunks, above the "
                f"{MAX_CHUNKS} of the exchange's table")
    mode = ring_mode() if mode is None else mode
    if mesh.device.type == "cpu":
        if mode != "1":
            return ("the CPU has no peer-mapped memory for the ring's "
                    "exchange (its plain version runs there only under "
                    "THEANET_DP_RING=1)")
        return None
    if mesh.device.type != "cuda":
        return f"no ring kernel for {mesh.device}"
    hosts = sorted(set(mesh.hosts))
    if len(hosts) > 1:
        return (f"the ranks span {len(hosts)} hosts ({', '.join(hosts)}): "
                "the ring maps its peers' memory through CUDA IPC, which "
                "needs one host")
    n_cards = torch.cuda.device_count()
    cards = sorted({r % n_cards for r in range(n_data)})
    for a in cards:
        for b in cards:
            if a != b and not torch.cuda.can_device_access_peer(a, b):
                return (f"cards {a} and {b} cannot map each other's memory "
                        "(cudaDeviceCanAccessPeer)")
    return None


def ring_table(n, rank, rs, step0, bases, chunks, wait_s=WAIT_LIMIT_S,
               events=None, host=0):
    """The ring table the C entries read (csrc/ring.cuh ``ring_parse``): n,
    rank, rs, the global step before the call, the wait limit in ns, the
    chunk count, ``host`` the address of the ranks' shared host counters,
    MAX_RANKS buffer pointers, 4 MAX_RANKS event pointers (``events``, the
    ranks' 4 each), (start, length, owner) a chunk. At n > 1 the pointers,
    the events and ``host`` must be given."""
    chunks = chunks or []
    vals = [n, rank, int(rs), step0, int(wait_s * 1e9), len(chunks), host]
    vals += list(bases) + [0] * (MAX_RANKS - len(bases))
    flat = [e for ev in (events or []) for e in ev]
    vals += flat + [0] * (4 * MAX_RANKS - len(flat))
    for c in chunks:
        vals += list(c)
    return (ctypes.c_longlong * len(vals))(*vals)


# ------------------------------------------------------------ the exchange

@torch.no_grad()
def exchange_reference(grad_sets, cms, rs, chunks=None):
    """The plain version of one step's exchange, on any device, in the
    kernel's orders: ``grad_sets`` the n ranks' flat gradients, ``cms``
    their (cost, minf) (2,), ``rs`` the mode, ``chunks`` the
    reduce-scatter's ``flat_chunks``. Returns (reduced flat gradient,
    (2,) reduced cost and minf)."""
    n = len(grad_sets)
    inv = torch.tensor(1.0 / n, dtype=torch.float32)
    if rs:
        out = torch.empty_like(grad_sets[0])
        for start, length, c in chunks:
            sl = slice(start, start + length)
            s = grad_sets[(c + 1) % n][sl] + grad_sets[(c + 2) % n][sl]
            for h in range(3, n + 1):
                s = s + grad_sets[(c + h) % n][sl]
            out[sl] = s * inv.to(s.device)
    else:
        s = grad_sets[0].clone()
        for g in grad_sets[1:]:
            s = s + g
        out = s * inv.to(s.device)
    cost, minf = cms[0][0].clone(), cms[0][1].clone()
    for cm in cms[1:]:
        cost = cost + cm[0]
        minf = torch.minimum(minf, cm[1])
    return out, torch.stack([cost * inv.to(cost.device), minf])


def buffer_views(buf, n_grads, step):
    """The (stats (2,), gradient slot (n_grads,)) of global step ``step``
    in a rank's exchange buffer ``buf`` (a float32 tensor of
    ring_buffer_bytes / 4 elements): what the in-process emulation of n
    ranks fills before it calls ring_exchange."""
    par = step & 1
    g0 = RING_HEADER + RING_STATS + par * n_grads
    return (buf[RING_HEADER + 2 * par:RING_HEADER + 2 * par + 2],
            buf[g0:g0 + n_grads])


def ring_exchange(lib_name, table, n_grads, step, phase, out, cm):
    """One phase of one step's exchange outside an epoch (csrc/ring.cuh
    ``ring_exchange``): 1 publishes the rank's gradient slot, 2 (reduce-
    scatter) sums its chunks, 3 writes the reduced gradient into ``out``
    and (cost, minf) into ``cm``. Counts the exchange kernels that the call
    launched in ``ring_exchange.launches``. CUDA tensors only: the exchange
    reads device memory through the table's pointers."""
    if out.device.type != "cuda":
        raise ValueError(f"ring_exchange: no kernel for {out.device}")
    from . import _build

    ring_exchange.launches += _build.ring_exchange_launch(
        lib_name, table, n_grads, step, phase, out, cm)


# every exchange kernel of csrc/ring.cuh that C launched: a ring epoch's (its
# wrapper adds the count the C loop returns) and ring_exchange's
ring_exchange.launches = 0


# ------------------------------------------------------ the epoch, emulated

@torch.no_grad()
def ring_epoch_reference(spec, n, shards, kparams, kmoms, bits, lr, rs,
                         plain=True, aux_shards=None):
    """n ranks of a ring epoch emulated in one process: each step every
    rank's gradient step on its shard (``shards[r]`` = dp_shard_data of
    rank r, ``aux_shards[r]`` its dp_shard_aux for a net with an aux layer,
    ``bits`` the GLOBAL epoch's words), ``exchange_reference``, the
    update. ``spec`` is the global spec. Returns (kparams, kmoms, cost_minf
    (nb, 2)) as new tensors: what every real rank must hold. With ``plain``
    the steps are ``grad_step_reference`` and ``update_reference`` (the CPU
    tests hold this to the JAX package's ring); else the counted wrappers
    ``grad_step`` and ``update``, which on CUDA tensors launch the
    kernels' own gradient and update stages, so that real ranks on a card
    equal the emulation to the bit (the plain exchange adds and multiplies
    in the exchange kernel's order)."""
    step_fn, update_fn = ((grad_step_reference, update_reference) if plain
                          else (grad_step, update))
    loc = local_spec(spec, spec.batch // n)
    dev = shards[0][0].device
    consts = constants(loc, dev)
    words = [dp_shard_words(spec, n, r, bits) for r in range(n)]
    chunks = _chunks(loc, n, rs)
    params = [t.clone() for t in kparams]
    moms = [t.clone() for t in kmoms]
    n_grads = sum(t.numel() for t in params)
    nb = shards[0][0].shape[0]
    g = [torch.empty(n_grads, dtype=torch.float32, device=dev)
         for _ in range(n)]
    cmr = [torch.empty(2, dtype=torch.float32, device=dev) for _ in range(n)]
    cm = torch.empty((nb, 2), dtype=torch.float32, device=dev)
    for s in range(nb):
        for r in range(n):
            ub, fb, pb, db = words[r]
            step_fn(loc, consts, shards[r][0][s], shards[r][1][s],
                    (ub[s, 0], fb[s], pb[s], db[s]), params, g[r], cmr[r],
                    None if aux_shards is None else aux_shards[r][s])
        if n > 1:
            red, cm[s] = exchange_reference(g, cmr, rs, chunks)
        else:
            red, cm[s] = g[0], cmr[0]
        update_fn(loc, params, moms, red, lr)
    return params, moms, cm


# ------------------------------------------------------------- the kernels

def _launch_ring(name, kparams, kmoms, x, y, bits, lr, spec, table,
                 aux=None):
    """Check the inputs and run one ring epoch of the family's library on
    the current stream; returns (kparams, kmoms, cost_minf) as new
    tensors, and the number of exchange kernels the epoch launched."""
    from . import _build

    check_epoch_inputs(name, kparams, kmoms, x, y, bits, spec,
                       family(spec).shapes(spec))
    if not isinstance(spec, MegaSpec):
        check_aux(name, spec, aux, (x.shape[0],))
    dev = x.device
    params = [t.clone() for t in kparams]   # updated in place by the kernel
    moms = [t.clone() for t in kmoms]
    cm = torch.empty((x.shape[0], 2), dtype=torch.float32, device=dev)
    gh, gw = smoothing_factors(spec, dev)
    if isinstance(spec, MegaSpec):
        n_ex = _build.megastep_ring_launch(spec, x, y, bits, gh, gw, params,
                                           moms, cm, float(lr), table)
    else:
        n_ex = _build.deep_ring_launch(spec, x, y, bits,
                                       deep_step_constants(spec, dev), aux,
                                       params, moms, cm, float(lr), table)
    return (params, moms, cm), n_ex


def megastep_ring_epoch(kparams, kmoms, x, y, bits, lr, spec, table):
    """One rank's ring epoch at the flagship (``spec`` the local spec, ``x``
    ``y`` and ``bits`` the rank's shard) by ``megastep_ring_epoch`` of
    csrc/megastep.cu, one C call; counts it in
    ``megastep_ring_epoch.launches`` and the exchange kernels the C loop
    launched in ``ring_exchange.launches``. CUDA tensors only."""
    out, n_ex = _launch_ring("megastep_ring_epoch", kparams, kmoms, x, y,
                             bits, lr, spec, table)
    megastep_ring_epoch.launches += 1
    ring_exchange.launches += n_ex
    return out


megastep_ring_epoch.launches = 0


def deep_ring_epoch(kparams, kmoms, x, y, bits, lr, spec, table,
                    aux_steps=None):
    """As megastep_ring_epoch for a DeepSpec, by ``deep_ring_epoch`` of
    csrc/megastep_deep.cu, with the rank's (nb, b_loc, 4) ``aux_steps`` of
    a net with an aux layer; counted in ``deep_ring_epoch.launches``."""
    out, n_ex = _launch_ring("deep_ring_epoch", kparams, kmoms, x, y, bits,
                             lr, spec, table, aux_steps)
    deep_ring_epoch.launches += 1
    ring_exchange.launches += n_ex
    return out


deep_ring_epoch.launches = 0


class RingBuffers:
    """This rank's exchange buffer (cudaMalloc in csrc/ring.cuh) and the
    other ranks', mapped through CUDA IPC; every rank's 4 IPC events; and
    the ranks' shared host counters, a zeroed page of a file in the
    temporary directory that every rank maps (removed once mapped). The handles are swapped once with
    ``dist.all_gather_object``. ``step`` is the global step count the
    counters have reached. ``close`` unmaps and frees it all after every
    rank has stopped reading."""

    def __init__(self, lib_name, n_grads, mesh):
        from . import _build

        self.lib_name, self.mesh, self.step = lib_name, mesh, 0
        dev, group, rank = mesh.device, mesh.group, mesh.rank
        torch.cuda.set_device(dev)
        self.own, handle = _build.ring_alloc(lib_name, n_grads, dev)
        own_events, ev_handle = _build.ring_events_alloc(lib_name, dev)
        path = None
        if rank == 0:
            fd, path = tempfile.mkstemp(prefix="theanet_ring_")
            os.ftruncate(fd, mmap.PAGESIZE)
            os.close(fd)
        gathered = [None] * mesh.n_data
        dist.all_gather_object(gathered, (handle, ev_handle, path),
                               group=group)
        handles, ev_handles, paths = zip(*gathered)
        self.events = [own_events if r == rank else
                       _build.ring_events_open(lib_name, h, dev)
                       for r, h in enumerate(ev_handles)]
        with open(paths[0], "r+b") as f:
            self._page = mmap.mmap(f.fileno(), mmap.PAGESIZE)
        self._counters = ctypes.c_char.from_buffer(self._page)
        self.host = ctypes.addressof(self._counters)
        self.mapped = {r: _build.ring_open(lib_name, h, dev)
                       for r, h in enumerate(handles) if r != rank}
        self.bases = [self.mapped.get(r, self.own)
                      for r in range(mesh.n_data)]
        dist.barrier(group=group)
        if rank == 0:
            os.unlink(path)   # every rank has it mapped

    def table(self, rs, chunks):
        """The ring table of the next epoch."""
        return ring_table(self.mesh.n_data, self.mesh.rank, rs, self.step,
                          self.bases, chunks, events=self.events,
                          host=self.host)

    def close(self):
        from . import _build

        if self.own is None:
            return
        dev = self.mesh.device
        torch.cuda.synchronize(dev)
        dist.barrier(group=self.mesh.group)   # every rank stopped reading
        for ptr in self.mapped.values():
            _build.ring_close(self.lib_name, ptr, dev)
        for ev in self.events:
            _build.ring_events_free(self.lib_name, ev, dev)
        del self._counters
        self._page.close()
        dist.barrier(group=self.mesh.group)   # every mapping is closed
        _build.ring_free(self.lib_name, self.own, dev)
        self.own, self.mapped, self.events = None, {}, None


def make_ring_epoch_fn(spec, n_batches, mesh):
    """The ring epoch function of a global flagship or deep ``spec`` on
    ``mesh``, with make_dp_epoch_fn's contract: ``epoch(kparams, kmoms,
    x_shard, y_shard, bits, lr, aux_steps=None)`` -> (kparams, kmoms,
    cost_minf (nb, 2)),
    ``bits`` the GLOBAL epoch's words; ``.n_data``, ``.local_spec``,
    ``.ring`` (True) and ``.close()``, which frees the exchange buffers
    (every rank calls it). On a card each epoch is one C call a rank
    (``megastep_ring_epoch`` / ``deep_ring_epoch``), after one host
    ``dist.barrier``; the buffers are set up at the first epoch. On CPU
    tensors each step runs the plain gradient, one ``dist.all_gather`` of
    the flat gradients and costs, ``exchange_reference`` and the plain
    update."""
    n = mesh.n_data
    loc = local_spec(spec, spec.batch // n)
    shapes = family(loc).shapes(loc)
    n_grads = sum(r * c for r, c in shapes)
    rs = use_rs(n)
    chunks = _chunks(loc, n, rs)
    lib_name = "megastep" if isinstance(loc, MegaSpec) else "megastep_deep"
    kernel = (megastep_ring_epoch if isinstance(loc, MegaSpec)
              else deep_ring_epoch)
    state = {"ring": None}

    def cuda_epoch(kparams, kmoms, x, y, words, lr, aux):
        # only a deep net with an aux layer has aux rows
        aux_kw = {} if aux is None else {"aux_steps": aux}
        if n == 1:
            table = ring_table(1, 0, False, 0, [], None)
            return kernel(kparams, kmoms, x, y, words, lr, loc, table,
                          **aux_kw)
        if state["ring"] is None:
            state["ring"] = RingBuffers(lib_name, n_grads, mesh)
        ring = state["ring"]
        dist.barrier(group=mesh.group)
        table = ring.table(rs, chunks)
        out = kernel(kparams, kmoms, x, y, words, lr, loc, table, **aux_kw)
        ring.step += x.shape[0]
        return out

    def cpu_epoch(kparams, kmoms, x, y, words, lr, aux):
        ub, fb, pb, db = words
        params = [t.clone() for t in kparams]   # updated in place
        moms = [t.clone() for t in kmoms]
        consts = constants(loc, x.device)
        buf = torch.empty(n_grads + 2, dtype=torch.float32)
        every = [torch.empty_like(buf) for _ in range(n)]
        cm = torch.empty((n_batches, 2), dtype=torch.float32)
        for s in range(n_batches):
            grad_step(loc, consts, x[s], y[s], (ub[s, 0], fb[s], pb[s],
                                                db[s]), params,
                      buf[:n_grads], buf[n_grads:],
                      None if aux is None else aux[s])
            if n > 1:
                dist.all_gather(every, buf, group=mesh.group)
                red, cm[s] = exchange_reference(
                    [e[:n_grads] for e in every], [e[n_grads:] for e in every],
                    rs, chunks)
            else:
                red, cm[s] = buf[:n_grads], buf[n_grads:]
            update(loc, params, moms, red, lr)
        return params, moms, cm

    def epoch(kparams, kmoms, x_shard, y_shard, bits, lr, aux_steps=None):
        words = dp_shard_words(spec, n, mesh.rank, bits)
        run = cuda_epoch if x_shard.device.type == "cuda" else cpu_epoch
        return run(kparams, kmoms, x_shard, y_shard, words, lr, aux_steps)

    def close():
        if state["ring"] is not None:
            state["ring"].close()
            state["ring"] = None

    epoch.n_data = n
    epoch.local_spec = loc
    epoch.ring = True
    epoch.close = close
    return epoch
