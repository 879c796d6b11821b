"""Trainer: device-resident dataset + fused or per-layer epochs.

Port of ``theanet_tpu/trainer.py``. The whole dataset is uploaded to the
device once (the reference's theano.shared + givens, train.py:126-129).
Batches are the reference's fixed sequential batches.

Two training paths:

  * fused (``MEGAFUSED``, default ``"auto"``): when the net matches a fused
    family (``ops.megastep.fused_plan``: the 2-conv flagship, the flat MLP
    or the deep family), an epoch is ONE call of the plan's epoch function
    (its CUDA kernel on a card, its plain twin on the CPU), with the noise
    words drawn for the plan's spec. A family takes a net whose grammar it
    holds by the route rule: the JAX package's byte model admits it
    (``ops/route.py``) or its head fits a block's shared memory; a
    reference batch the JAX package runs as tiles is one step of the whole
    batch here. Training state stays in the kernel layout between epochs
    and is synced to the framework layout on eval, checkpoint and
    ``sync_net``. ``MEGAFUSED=True`` raises with the decline reason when
    the net cannot fuse; ``False`` never fuses. The JAX Trainer's 'auto'
    also keeps tiled specs above BATCH_SZ 128 on its scanned path, a
    crossover measured on the TPU (theanet_tpu/trainer.py:338-357); the
    port fuses them (chip_smoke.py phase 23 times one such batch fused and
    per layer).
  * per-layer: autograd ``NeuralNet.train_step`` per batch, for nets the
    matchers decline (with ``MEGAFUSED='auto'`` the Trainer names the
    reason on stderr). Each step draws from its own generator
    (``step_generator``), with one host sync per epoch. A ``FUSED_TAIL``
    net always trains here: its ElasticLayer runs ``ops.elastic`` (the
    ``elastic_resample`` kernel with ``'method': 'pallas'``) and its dense
    tail ``ops.fused_mlp``.

Under a data-parallel ``mesh`` (``parallel.make_mesh``; one process per
rank) every rank trains the fused family's step on its shard of each batch
and the ranks average gradients once a step; the flat-MLP family is skipped
(flat nets take the deep family's zero-level kernel) and FUSED_TAIL is
turned off, as in the JAX package. ``THEANET_DP_RING`` picks the path, as in
the JAX Trainer: under 'auto' (the default) the whole-epoch ring
(``ops/megastep_ring.py``: one C call an epoch a rank, the exchange inside
it) wherever ``ring_decline_reason`` passes, else the per-step path
(``ops/megastep_dp.py``: a gradient launch, an ``all_reduce`` and an update
launch a step), naming the reason on stderr; '1' the ring or an error; '0'
the per-step path. The port has no per-layer data-parallel path yet: a mesh
net that the fused path declines raises with the reason. Every rank holds
the whole replicated state, so evaluation and ``sync_net`` read it locally;
only rank 0 writes a checkpoint (``save_checkpoint``); ``close`` frees the
ring's exchange buffers (every rank calls it).

A net with an aux layer (AuxConcat, SoftAux) reads the (n, 2, 2)
``train_aux`` / ``test_aux`` rows beside the images: the per-layer step and
the eval window slice them by the samples' indices, a fused epoch takes
them as (nb, B, 4) step blocks (a rank's share under a mesh), and without
them the fused families decline the net by name (the JAX package's
trainer.py:364-371).

Evaluation always runs the per-layer forward in eval mode. On a card the
Trainer turns TF32 off for cuDNN convolutions and matmuls, so training
runs in f32 like the JAX package and the CPU.
"""

from __future__ import annotations

import functools
import sys
from typing import Optional

import numpy as np
import torch

from .device import default_device
from .model import NeuralNet
from .prms import save_checkpoint

__all__ = ["Trainer", "get_test_indices", "step_generator"]


def get_test_indices(tot_samps, batch_sz, bth_samps):
    """Rotating-window eval batch-id generator (reference train.py:170-176)."""
    n_bths_each = int(bth_samps / batch_sz)
    n_bths_all = int(tot_samps / batch_sz)
    cur = 0
    while True:
        yield [i % n_bths_all for i in range(cur, cur + n_bths_each)]
        cur = (cur + n_bths_each) % n_bths_all


def step_generator(seed, step, device):
    """The torch.Generator of one per-layer training step, seeded by (SEED,
    step). The forward draws from it in layer order: an active ColorLayer's
    (3, B, maps) uniforms; an active ElasticLayer's 7 affine uniforms, its
    (2, H, W) normals (when it has an elastic field) and its (B, C, H, W)
    flip words (when pflip); each dropout's mask, where a FUSED_TAIL tail
    draws (B, n_hid) words; a LocationInfo's (B, 1) convex-mix uniforms."""
    state = np.random.SeedSequence([int(seed), 1 << 30, int(step)])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state.generate_state(1, np.uint64)[0]))
    return gen


class Trainer:
    def __init__(self, net: NeuralNet, train_x, train_y, test_x, test_y,
                 device=None, mesh=None, train_aux=None, test_aux=None):
        """``mesh``: a data-parallel ``parallel.Mesh``, whose device then
        holds this rank's tensors; else ``device`` (default
        ``THEANET_TORCH_DEVICE``). ``train_aux``, ``test_aux``: the (n, 2, 2)
        aux inputs of a net with an aux layer (dropped for other nets, as
        the reference's train.py:131-135 does)."""
        self.net = net
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None
                       else default_device() if device is None
                       else torch.device(device))
        self.batch_sz = bsz = net.batch_sz
        self.n_train_batches = nb = train_x.shape[0] // bsz
        self.n_test_batches = test_x.shape[0] // bsz
        # a CenteredOut head's width is its feature count; labels index
        # its classes
        n_cls = getattr(net.head, "n_classes", net.head.n_out)
        for name, y in (("train", train_y), ("test", test_y)):
            y = np.asarray(y)
            if y.size and (y.min() < 0 or y.max() >= n_cls):
                raise ValueError(f"{name} labels must lie in [0, {n_cls})")

        dev = self.device
        # PyTorch runs cuDNN convolutions in TF32 by default; the reference
        # and the CPU compute in f32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.d_train_x = torch.as_tensor(np.asarray(train_x, np.float32),
                                         device=dev)
        self.d_train_y = torch.as_tensor(np.asarray(train_y, np.int32),
                                         device=dev)
        self.d_test_x = torch.as_tensor(np.asarray(test_x, np.float32),
                                        device=dev)
        self.d_test_y = torch.as_tensor(np.asarray(test_y, np.int32),
                                        device=dev)
        if not net.takes_aux():
            train_aux = test_aux = None
        self.d_train_aux, self.d_test_aux = (
            None if a is None else torch.as_tensor(
                np.asarray(a, np.float32).reshape(-1, 2, 2), device=dev)
            for a in (train_aux, test_aux))
        self.params, self.moms = net.init_params(dev)
        if net.tr_prms.get("SHUFFLE", False):
            raise NotImplementedError(
                "SHUFFLE is not ported yet (ROADMAP.md queue 1)")

        self._mega = None
        mode = net.tr_prms.get("MEGAFUSED", "auto")
        if not (mode is True or mode is False or mode == "auto"):
            raise ValueError("MEGAFUSED must be True, False, or 'auto' "
                             f"(got {mode!r})")
        if mesh is not None:
            self._check_mesh(mesh, nb, train_x.shape[0])
        if mode is False:
            if mesh is not None:
                raise NotImplementedError(
                    "MEGAFUSED=False under a mesh: the port has no "
                    "per-layer data-parallel path yet (ROADMAP.md)")
            return
        from .ops import megastep

        plan = reason = None
        if nb < 1:
            reason = "empty training set"
        elif train_x.shape[2] != train_x.shape[3]:
            reason = "non-square input images"
        else:
            aux_data = self.d_train_aux is not None
            plan = megastep.fused_plan(net, for_mesh=mesh is not None,
                                       aux_data=aux_data)
            if plan is None:
                reason = megastep.fused_decline_reason(net, aux_data)
            elif train_x.shape[1] != plan.spec.in_ch:
                plan, reason = None, (
                    f"training data has {train_x.shape[1]} channels but the "
                    f"net expects {plan.spec.in_ch}")
        if plan is not None and mesh is not None:
            plan, reason = self._dp_gate(plan, mesh)
        if plan is None:
            if mode is True:
                raise ValueError("MEGAFUSED=True, but this configuration "
                                 "cannot use the fused epoch kernel: "
                                 + reason)
            if mesh is not None:
                raise NotImplementedError(
                    "the fused data-parallel path declines this net ("
                    + reason + "), and the port has no per-layer "
                    "data-parallel path yet (ROADMAP.md)")
            print("theanet_tpu_torch: MEGAFUSED=auto — training on the "
                  "per-layer path: " + reason, file=sys.stderr)
            return
        from .ops import megastep_dp, megastep_ring

        spec = plan.spec
        self._mega, self._mega_plan, self._mega_spec = megastep, plan, spec
        # channel-major step rows (c*B + b, HW) of this rank's samples of
        # every step (all of them without a mesh), arranged once
        n, rank = (1, 0) if mesh is None else (mesh.n_data, mesh.rank)
        self._mega_x, self._mega_y = megastep_dp.dp_shard_data(
            spec, n, rank, self.d_train_x, self.d_train_y)
        self._mega_aux = megastep_dp.dp_shard_aux(spec, n, rank,
                                                  self.d_train_aux)
        # (kparams, kmoms, x, y, bits, lr) -> (kparams, kmoms, cost_minf)
        if mesh is None:
            self._mega_epoch = functools.partial(plan.epoch_fn, spec=spec)
        else:
            maker = (megastep_ring.make_ring_epoch_fn
                     if self._use_ring(spec, mesh)
                     else megastep_dp.make_dp_epoch_fn)
            self._mega_epoch = maker(spec, nb, mesh)
        self._kp = self._km = None
        self._state_src = "frame"   # which layout holds the truth

    # -- data-parallel mesh ------------------------------------------------

    def _check_mesh(self, mesh, nb, n_train):
        """The JAX Trainer's mesh checks (trainer.py:78-123): FUSED_TAIL off,
        the batch divides across the data ranks, at least one batch."""
        if self.net.fused_tail:
            # the tail kernel is a single-device autograd function; the
            # fused data-parallel path trains the same network
            self.net.fused_tail = False
            print("theanet_tpu_torch: FUSED_TAIL is single-chip only; "
                  "disabled under the device mesh (the fused data-parallel "
                  "path runs the same network).", file=sys.stderr)
        n_data = mesh.shape["data"]
        if self.batch_sz % n_data:
            raise ValueError(
                f"BATCH_SZ={self.batch_sz} does not divide across the mesh "
                f"'data' axis ({n_data} devices); choose a batch size that "
                "is a multiple of the data-parallel degree.")
        if nb < 1:
            raise ValueError(f"training set ({n_train} samples) is smaller "
                             f"than one batch (BATCH_SZ={self.batch_sz})")

    def _dp_gate(self, plan, mesh):
        """(plan, None) when the fused data-parallel path takes ``plan`` on
        ``mesh``, else (None, reason): the family's data-parallel gate
        (megastep_dp.dp_decline_reason), under any MEGAFUSED. The JAX
        Trainer's 'auto' also declines shards above 32 samples a rank
        (theanet_tpu/trainer.py:328-336): that is a measured TPU crossover
        between its fused data-parallel path and its scanned GSPMD path.
        The port has no second path to cross over to (no per-layer
        data-parallel path), so it fuses every shard the gate takes."""
        from .ops import megastep_dp

        n_data, bsz = mesh.shape["data"], self.batch_sz
        why = megastep_dp.dp_decline_reason(plan.spec, n_data)
        if why:
            return None, (f"the per-rank batch shard (BATCH_SZ {bsz} over "
                          f"{n_data} data ranks) fails the fused "
                          f"data-parallel gate: {why}")
        return plan, None

    def _use_ring(self, spec, mesh):
        """Whether the whole-epoch ring trains ``spec`` on ``mesh``, from
        THEANET_DP_RING (theanet_tpu/trainer.py:425-446) and
        ring_decline_reason's static facts: 'auto' takes it where it
        passes and otherwise names the reason on stderr; '1' raises with
        the reason; '0' never takes it."""
        from .ops import megastep_ring

        mode = megastep_ring.ring_mode()
        if mode == "0":
            return False
        why = megastep_ring.ring_decline_reason(spec, mesh.n_data, mesh,
                                                mode)
        if why is None:
            return True
        if mode == "1":
            raise ValueError("THEANET_DP_RING=1, but the whole-epoch ring "
                             "cannot train this net: " + why)
        print("theanet_tpu_torch: THEANET_DP_RING=auto — training on the "
              "per-step data-parallel path: " + why, file=sys.stderr)
        return False

    # -- fused-path state ------------------------------------------------

    def _to_kernel(self, tree):
        return self._mega_plan.kernel_layout(
            [tree[i] for i in self._mega_plan.layer_idx], self._mega_spec)

    def _from_kernel(self, kt, template):
        """Kernel-layout state -> the framework lists of ``template``; a
        layer's tensors outside the state (frozen CenteredOut centers) stay
        as they are."""
        out = [list(lp) for lp in template]
        for i, lw in zip(self._mega_plan.layer_idx,
                         self._mega_plan.framework_layout(kt,
                                                          self._mega_spec)):
            out[i] = list(lw) + out[i][len(lw):]
        return out

    def _mega_sync_frame(self):
        """Bring kernel-layout state back to self.params/moms; the kernel
        copy stays valid ('both')."""
        if self._mega is None:
            return
        if self._state_src == "mega":
            self.params = self._from_kernel(self._kp, self.params)
            self.moms = self._from_kernel(self._km, self.moms)
            self._state_src = "both"

    def _mega_dispatch_epoch(self, lr):
        """One fused epoch, no host sync; returns the (nb, 2) cost/minf
        tensor on the device."""
        if self._state_src == "frame":
            self._kp = self._to_kernel(self.params)
            self._km = self._to_kernel(self.moms)
        spec = self._mega_spec
        # under a mesh every rank draws the global epoch's words and its
        # epoch function takes its share
        bits = self._mega.epoch_noise_bits(
            self.net.tr_prms["SEED"], self.net.get_epoch(), spec,
            self.n_train_batches, self.device)
        # only an aux net's epoch function takes its aux rows
        aux = ({"aux_steps": self._mega_aux}
               if getattr(spec, "has_aux", False) else {})
        self._kp, self._km, cm = self._mega_epoch(
            self._kp, self._km, self._mega_x, self._mega_y, bits, lr, **aux)
        self._state_src = "mega"
        return cm

    # -- per-layer path ----------------------------------------------------

    def _train_batch(self, ibatch, step, lr):
        bsz = self.batch_sz
        rows = slice(ibatch * bsz, (ibatch + 1) * bsz)
        x, y = self.d_train_x[rows], self.d_train_y[rows]
        aux = None if self.d_train_aux is None else self.d_train_aux[rows]
        gen = step_generator(self.net.tr_prms["SEED"], step, self.device)
        self.params, self.moms, cost, feats, _ = self.net.train_step(
            self.params, self.moms, x, y, lr=lr, generator=gen, aux=aux)
        # y clamped to the feature width, as the JAX fused heads do
        # (megastep.py:1618-1624): a CenteredOut head may have more classes
        # than features
        yc = torch.clamp(y.long(), max=feats.shape[1] - 1)
        true_f = feats[torch.arange(bsz, device=self.device), yc]
        return cost, true_f.min()

    # -- public API --------------------------------------------------------

    def run_epoch(self, lr: Optional[float] = None):
        """Train one epoch. Returns (total cost, per-batch costs, per-batch
        min true-class feature), the last two as numpy."""
        lr = self.net.get_rate() if lr is None else lr
        if self._mega is not None:
            cm = self._mega_dispatch_epoch(lr).cpu().numpy()
            return float(cm[:, 0].sum()), cm[:, 0], cm[:, 1]
        nb, epoch = self.n_train_batches, self.net.get_epoch()
        costs, minf = [], []
        for ib in range(nb):
            c, m = self._train_batch(ib, epoch * nb + ib, lr)
            costs.append(c)
            minf.append(m)
        costs = torch.stack(costs).cpu().numpy()  # one host sync per epoch
        return float(costs.sum()), costs, torch.stack(minf).cpu().numpy()

    def run_epochs(self, k: int):
        """Train ``k`` consecutive epochs, advancing the epoch counter (and
        so the LR schedule) after each. Returns (totals (k,), costs (k, nb),
        min_true_f (k, nb)) as numpy."""
        if self._mega is None:
            outs = []
            for _ in range(k):
                outs.append(self.run_epoch()[1:])
                self.net.inc_epoch_set_rate()
            costs = np.stack([c for c, _ in outs])
            return costs.sum(axis=1), costs, np.stack([m for _, m in outs])
        cms = []
        for _ in range(k):
            cms.append(self._mega_dispatch_epoch(self.net.get_rate()))
            self.net.inc_epoch_set_rate()
        all_cm = torch.stack(cms).cpu().numpy()   # one host sync
        return all_cm[:, :, 0].sum(axis=1), all_cm[:, :, 0], all_cm[:, :, 1]

    def predict(self, x, get_output_of_layers=(), aux=None):
        """(features, y_preds, *layer outputs) as numpy, on raw inputs (and
        the (n, 2, 2) ``aux`` of a net with an aux layer)."""
        self._mega_sync_frame()
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        if aux is not None:
            aux = torch.as_tensor(np.asarray(aux, np.float32),
                                  device=self.device)
        out = self.net.predict(self.params, x, aux=aux,
                               get_output_of_layers=get_output_of_layers)
        return tuple(o.cpu().numpy() for o in out)

    def evaluate(self, which: str, batch_ids, preds_feats: bool = False):
        """(err%, second_stat%) over a window of whole batches, scaled like
        the reference's test_wrapper (train.py:155-161); with preds_feats
        the window's features and predictions are appended."""
        self._mega_sync_frame()
        if len(batch_ids) == 0:
            raise ValueError(
                "empty eval window: TEST_SAMP_SZ smaller than BATCH_SZ "
                "yields zero whole batches per rotating window; raise "
                "TEST_SAMP_SZ to at least one batch")
        bsz = self.batch_sz
        idx = torch.as_tensor(
            np.concatenate([np.arange(b * bsz, (b + 1) * bsz)
                            for b in batch_ids]), device=self.device)
        xs, ys, auxs = ((self.d_test_x, self.d_test_y, self.d_test_aux)
                        if which == "test" else
                        (self.d_train_x, self.d_train_y, self.d_train_aux))
        out = self.net.eval_step(self.params, xs[idx], ys[idx],
                                 aux=None if auxs is None else auxs[idx],
                                 preds_feats=preds_feats)
        stats = (100.0 * float(out[0]), 100.0 * float(out[1]))
        if preds_feats:
            return stats + (out[2].cpu().numpy(), out[3].cpu().numpy())
        return stats

    def evaluate_full(self, which: str):
        n = self.n_test_batches if which == "test" else self.n_train_batches
        return self.evaluate(which, list(range(n)))

    def checkpoint_dict(self):
        self.sync_net()
        return self.net.get_init_params()

    def save_checkpoint(self, path):
        """Pickle checkpoint_dict() to ``path``. Under a mesh every rank
        holds the same state and only rank 0 writes. Returns whether this
        process wrote."""
        if self.mesh is not None and self.mesh.rank != 0:
            return False
        save_checkpoint(path, self.checkpoint_dict())
        return True

    def close(self):
        """Free what the Trainer holds outside PyTorch: the ring's exchange
        buffers under a mesh (a collective: every rank calls it)."""
        close = getattr(getattr(self, "_mega_epoch", None), "close", None)
        if close is not None:
            close()

    def sync_net(self):
        """Write the current device params back into the net's layers, so
        get_wts_info() and get_init_params() reflect training."""
        self._mega_sync_frame()
        self.net.snapshot_params(self.params)

    def snapshot_state(self):
        """Device-side copy of the training state (in whichever layout holds
        the truth) plus the epoch counter, for restore_state."""
        if self._mega is not None and self._state_src in ("mega", "both"):
            st = ("mega", [t.clone() for t in self._kp],
                  [t.clone() for t in self._km])
        else:
            st = ("frame", [[p.clone() for p in lp] for lp in self.params],
                  [[m.clone() for m in lm] for lm in self.moms])
        return st, self.net.get_epoch()

    def restore_state(self, snap):
        """Rewind to a snapshot_state() point. The LR schedule and all
        per-epoch randomness derive from the epoch counter, so training
        from here reproduces the trajectory."""
        (kind, p, m), epoch = snap
        if kind == "mega":
            self._kp = [t.clone() for t in p]
            self._km = [t.clone() for t in m]
            self._state_src = "mega"
        else:
            self.params = [[t.clone() for t in lp] for lp in p]
            self.moms = [[t.clone() for t in lm] for lm in m]
            if self._mega is not None:
                self._state_src = "frame"
        self.net.tr_prms["CUR_EPOCH"] = epoch
