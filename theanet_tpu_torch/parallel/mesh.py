"""The data-parallel device mesh over ``torch.distributed``.

Port of ``theanet_tpu/parallel/mesh.py`` for its "data" axis. Where the JAX
package lays one process's devices out in a ``jax.sharding.Mesh``, the port
runs one process per rank: each rank holds the whole replicated training
state on its own device and trains on its shard of every step's batch, and
the gradients meet in one ``all_reduce`` of the rank's process group a step
(``ops/megastep_dp.py``). The group is the caller's: initialise it first
(``torch.distributed.init_process_group``, or ``parallel.launch``). NCCL
needs a card per rank; gloo reduces CUDA tensors too, so two gloo ranks can
share one card, and it runs on the CPU.

The "model" (tensor-parallel) axis is not ported yet: ``n_model > 1``
raises, naming ROADMAP.md.
"""

from __future__ import annotations

import socket
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..device import default_device

__all__ = ["Mesh", "make_mesh"]


class Mesh(NamedTuple):
    """A data-parallel mesh: ``shape`` as the JAX package's
    (``{"data": n, "model": 1}``), the process group, this process's rank in
    it, the device its tensors live on and every rank's host name, in rank
    order (empty when not known)."""
    shape: dict
    group: object
    rank: int
    device: torch.device
    hosts: tuple = ()

    @property
    def n_data(self):
        return self.shape["data"]


def make_mesh(n_data=None, n_model=1, group=None):
    """The ("data", "model") mesh of this process's rank in ``group`` (the
    default group when None). ``n_data`` defaults to the group's size and
    must equal it; fails fast with a named error when the group cannot fill
    the mesh (as ``theanet_tpu/parallel/mesh.py:47-53``). The device is
    ``THEANET_TORCH_DEVICE``'s type; on CUDA, card ``rank % device_count``,
    which becomes the current card. The ranks' host names are gathered once
    (``dist.all_gather_object``), so that the ring can tell a mesh on one
    host from one across hosts."""
    if n_model != 1:
        if n_model < 1:
            raise ValueError(f"mesh axes must be positive, got model="
                             f"{n_model}")
        raise NotImplementedError(
            f"a {n_model}-way 'model' (tensor-parallel) axis: the port has "
            "data parallelism only; tensor parallelism is queued in "
            "ROADMAP.md")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process group "
            "(torch.distributed.init_process_group, or run the ranks through "
            "theanet_tpu_torch.parallel.launch)")
    group = dist.group.WORLD if group is None else group
    world = dist.get_world_size(group)
    if n_data is None:
        n_data = world
    if n_data < 1:
        raise ValueError(f"mesh axes must be positive, got data={n_data} "
                         f"model={n_model}")
    if n_data != world:
        raise ValueError(
            f"mesh ({n_data} data x {n_model} model = {n_data * n_model} "
            f"ranks) does not match the {world} ranks of the process group; "
            f"start {n_data} ranks or shrink the mesh")
    dev = default_device()
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        if dist.get_backend(group) == "nccl" and world > n_cards:
            raise ValueError(
                f"{world} NCCL ranks need {world} cards, and this host has "
                f"{n_cards}: NCCL refuses two ranks on one card (gloo can "
                "share one)")
        dev = torch.device("cuda", dist.get_rank(group) % n_cards)
        torch.cuda.set_device(dev)   # where NCCL's object gather lands
    hosts = [None] * world
    dist.all_gather_object(hosts, socket.gethostname(), group=group)
    return Mesh({"data": n_data, "model": 1}, group, dist.get_rank(group),
                dev, tuple(hosts))
