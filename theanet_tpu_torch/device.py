"""The port's one device setting.

``THEANET_TORCH_DEVICE`` names the device every tensor of a run lives on
(default ``cuda``). Asking for CUDA where there is no card raises: a run
never carries on on the CPU in its place. The CPU tests set it to ``cpu``.
"""

from __future__ import annotations

import os

import torch

__all__ = ["default_device"]


def default_device() -> torch.device:
    dev = torch.device(os.environ.get("THEANET_TORCH_DEVICE", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "THEANET_TORCH_DEVICE asks for cuda, but torch sees no CUDA "
            "device; set THEANET_TORCH_DEVICE=cpu to run on the CPU")
    return dev
