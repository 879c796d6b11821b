"""Data-parallel fused training: the fused families' step on a mesh.

Port of ``theanet_tpu/ops/megastep_dp.py``. A whole-epoch kernel keeps one
device's state between its steps, so it cannot meet the other ranks inside
an epoch. This path runs the same step as the epoch kernels in two parts:

  * every rank runs one step's augmentation, forward and hand-derived
    backward on its shard of the step's batch (``megastep_grad_step`` /
    ``deep_grad_step``, the port of ``_kernel_grad``: the epoch kernel's own
    stages in csrc/megastep.cu and csrc/megastep_deep.cu), which writes the
    data gradients into one flat buffer;
  * one ``all_reduce`` (sum) of that buffer, divided by the rank count;
  * the old-accumulator momentum update with L1/L2 and max-norm
    (``megastep_update`` / ``deep_update``) after the reduction, so the
    replicated parameters stay bit-identical on every rank.

The flagship (MegaSpec) and the deep family (DeepSpec: conv stacks of any
depth, the Color prefix, every head the port takes, and flat nets at zero
conv levels) run here. ``fused_plan(net, for_mesh=True)`` skips the flat-MLP
family, so flat nets match as zero-level DeepSpecs, as in the JAX package.

Augmentation under data parallelism is the single-device kernel's, word for
word. Every rank draws the GLOBAL epoch's words (``epoch_noise_bits`` at the
global spec, from the run's SEED) and takes its share
(``dp_shard_words``): the warp words are replicated (one warp per global
batch), the per-sample pflip, dropout and color words follow the samples.
So N ranks follow the single-device trajectory up to the order of the
gradient sum. A net with an aux layer shares its aux rows as its samples
(``dp_shard_aux``). Each shard's gradient is d(mean over its samples)/dw;
their mean over ranks is the global batch's, and the weight cost, equal on
every rank, passes through unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from .megastep import (MegaSpec, kernel_shapes, launch_limit_reason,
                       megastep_grad_step,
                       megastep_grad_step_reference, megastep_update,
                       megastep_update_reference, step_constants)
from .megastep_deep import (DeepSpec, deep_grad_step,
                            deep_grad_step_reference, deep_kernel_shapes,
                            deep_step_constants,
                            deep_update, deep_update_reference)

__all__ = ["local_spec", "dp_decline_reason", "dp_shard_data",
           "dp_shard_aux", "dp_shard_words", "Family", "family",
           "constants", "grad_step",
           "grad_step_reference", "update", "update_reference",
           "make_dp_epoch_fn"]


def local_spec(spec, b_loc):
    """The per-rank spec at shard batch ``b_loc``. The port's specs carry no
    lane-group or tile fields, so there is nothing to re-pick (the JAX
    package's ``regroup``) and no tiled global batch to re-pose
    (``_untiled_global``): the batch is the only field that changes."""
    return spec._replace(batch=b_loc)


def dp_decline_reason(spec, n_data):
    """Why the fused data-parallel path cannot take ``spec`` (the global
    spec) on an ``n_data``-rank mesh, or None (the JAX package's
    ``dp_supported``, with the reason named). The global batch must divide
    across the ranks, and the kernels must take the local spec at launch
    (the warp stage's and the gradient stages' shared memory,
    ``launch_limit_reason``; the head's stages take any shard). The global spec has
    passed its family's route rule, and the JAX package re-poses a tiled
    spec untiled on its mesh paths (``_untiled_global``), so nothing is
    tiled here either. The limits are checked on the CPU as on a card, so
    a net takes the same route on both."""
    if not isinstance(spec, (MegaSpec, DeepSpec)):
        return (f"{type(spec).__name__} has no data-parallel kernel (the "
                "flagship and deep families have one)")
    if spec.batch % n_data:
        return (f"BATCH_SZ {spec.batch} does not divide across the "
                f"{n_data} data ranks")
    return launch_limit_reason(local_spec(spec, spec.batch // n_data))


def dp_shard_data(spec, n_data, rank, x, y):
    """Rank ``rank``'s share of the training set: ``x`` (n, C0, H, W) (any
    layout of n * C0 * HW values, image-major) and ``y`` (n,) ->
    channel-major step rows (nb, C0*b_loc, HW) and labels (nb, b_loc) of
    samples [rank*b_loc, (rank+1)*b_loc) of every step's global batch (the
    JAX package's ``_dp_arrange``, one rank's block)."""
    B, C0, HW = spec.batch, spec.in_ch, spec.hw
    b_loc = B // n_data
    nb = x.shape[0] // B
    xs = (x[:nb * B].reshape(nb, n_data, b_loc, C0, HW)[:, rank]
          .transpose(1, 2).reshape(nb, C0 * b_loc, HW).contiguous())
    ys = y[:nb * B].reshape(nb, n_data, b_loc)[:, rank].contiguous()
    return xs, ys


def dp_shard_aux(spec, n_data, rank, aux):
    """Rank ``rank``'s share of the aux inputs ``aux`` (n, 2, 2) of a net
    with an aux layer, as dp_shard_data shares the samples: (nb, b_loc, 4)
    (the JAX package's ``dp_epoch_arrange`` aux rows,
    megastep_dp.py:267-290, one rank's block); None for other nets or
    without aux."""
    if aux is None or not getattr(spec, "has_aux", False):
        return None
    B = spec.batch
    b_loc = B // n_data
    nb = aux.shape[0] // B
    return (aux[:nb * B].reshape(nb, n_data, b_loc, 4)[:, rank]
            .contiguous())


def dp_shard_words(spec, n_data, rank, bits):
    """Rank ``rank``'s share of one epoch's GLOBAL noise words (``bits`` from
    epoch_noise_bits at the global spec), so that every kernel row reads the
    draw the single-device kernel's row of the same sample reads
    (``theanet_tpu/ops/megastep_dp.py:267-330``):

      ub, fb rows 0-3   replicated: one warp per global batch
      pb                global row c*B + rank*b_loc + b -> local c*b_loc + b
      db                the shard's samples
      fb rows 4-6       (Color) global column c*B + rank*b_loc + b -> local
                        column c*b_loc + b; the other columns as they are
    """
    ub, fb, pb, db = bits
    nb = ub.shape[0]
    B, C0, HW = spec.batch, spec.in_ch, spec.hw
    b_loc = B // n_data
    pb = (pb.reshape(nb, C0, n_data, b_loc, HW)[:, :, rank]
          .reshape(nb, C0 * b_loc, HW).contiguous())
    db = db.reshape(nb, n_data, b_loc, -1)[:, rank].contiguous()
    if getattr(spec, "color", False):
        cb = C0 * b_loc
        col = (fb[:, 4:7, :C0 * B].reshape(nb, 3, C0, n_data, b_loc)
               [:, :, :, rank].reshape(nb, 3, cb))
        fb = fb.clone()
        fb[:, 4:7, :cb] = col
    return ub, fb, pb, db


class Family(NamedTuple):
    """A fused family's data-parallel functions."""
    grad_step: object            # counted kernel wrapper
    grad_step_reference: object  # its plain version
    update: object               # counted kernel wrapper
    update_reference: object     # its plain version
    constants: object            # (spec, device) -> the step's constants
    shapes: object               # spec -> the state's shapes


FLAGSHIP = Family(megastep_grad_step, megastep_grad_step_reference,
                  megastep_update, megastep_update_reference, step_constants,
                  kernel_shapes)
DEEP = Family(deep_grad_step, deep_grad_step_reference, deep_update,
              deep_update_reference, deep_step_constants,
              deep_kernel_shapes)


def family(spec):
    """The Family of a flagship (MegaSpec) or deep (DeepSpec) spec."""
    return FLAGSHIP if isinstance(spec, MegaSpec) else DEEP


def constants(spec, device):
    """The constant tensors the family's step reads (its smoothing factors,
    the deep family's frozen centers), made once for many steps."""
    return family(spec).constants(spec, device)


def _aux_kw(aux):
    """The aux keyword of a deep step (the flagship takes none)."""
    return {} if aux is None else {"aux": aux}


def grad_step(spec, consts, x, y, words, params, grads, cm, aux=None):
    """One step's gradient on a rank's shard: the family's kernel wrapper
    (the plain version on CPU tensors). ``spec`` is the local spec,
    ``consts`` its ``constants``; ``x`` (C0*b_loc, HW), ``y`` (b_loc,),
    ``words`` one step's (ub (8,), fb, pb, db), ``aux`` the step's
    (b_loc, 4) aux rows of a net with an aux layer; writes the flat
    ``grads`` and ``cm`` = (cost, minf)."""
    family(spec).grad_step(spec, consts, x, y, words, params, grads, cm,
                           **_aux_kw(aux))


def grad_step_reference(spec, consts, x, y, words, params, grads, cm,
                        aux=None):
    """The plain version of grad_step on any device."""
    family(spec).grad_step_reference(spec, consts, x, y, words, params,
                                     grads, cm, **_aux_kw(aux))


def update(spec, params, moms, grads, lr):
    """The update after the all-reduce, in place: the family's kernel
    wrapper (the plain version on CPU tensors)."""
    family(spec).update(spec, params, moms, grads, lr)


def update_reference(spec, params, moms, grads, lr):
    """The plain version of update on any device."""
    family(spec).update_reference(spec, params, moms, grads, lr)


def make_dp_epoch_fn(spec, n_batches, mesh):
    """The data-parallel epoch function of a global flagship or deep
    ``spec`` on ``mesh``: ``epoch(kparams, kmoms, x_shard, y_shard, bits,
    lr, aux_steps=None)`` with the single-device epoch's contract and
    return, (kparams, kmoms, cost_minf (nb, 2)) as new tensors.
    ``x_shard``, ``y_shard`` are the rank's dp_shard_data, ``aux_steps``
    its dp_shard_aux; ``bits`` the GLOBAL epoch's words. A step is
    one gradient launch, one all_reduce of the flat gradient buffer (sum,
    then / n) and one update launch; the cost (sum / n) and minf (min) are
    reduced once per epoch, over all its steps."""
    n = mesh.n_data
    loc = local_spec(spec, spec.batch // n)
    shapes = family(loc).shapes(loc)
    n_grads = sum(r * c for r, c in shapes)

    def epoch(kparams, kmoms, x_shard, y_shard, bits, lr, aux_steps=None):
        dev = x_shard.device
        ub, fb, pb, db = dp_shard_words(spec, n, mesh.rank, bits)
        params = [t.clone() for t in kparams]   # updated in place
        moms = [t.clone() for t in kmoms]
        consts = constants(loc, dev)
        grads = torch.empty(n_grads, dtype=torch.float32, device=dev)
        cm = torch.empty((n_batches, 2), dtype=torch.float32, device=dev)
        for s in range(n_batches):
            grad_step(loc, consts, x_shard[s], y_shard[s],
                      (ub[s, 0], fb[s], pb[s], db[s]), params, grads, cm[s],
                      None if aux_steps is None else aux_steps[s])
            dist.all_reduce(grads, group=mesh.group)
            grads.div_(n)
            update(loc, params, moms, grads, lr)
        cost = cm[:, 0].contiguous()
        minf = cm[:, 1].contiguous()
        dist.all_reduce(cost, group=mesh.group)
        dist.all_reduce(minf, op=dist.ReduceOp.MIN, group=mesh.group)
        return params, moms, torch.stack([cost / n, minf], dim=1)

    epoch.n_data = n
    epoch.local_spec = loc
    return epoch
