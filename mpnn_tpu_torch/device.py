"""The device rule of the port's entry points: `cuda` unless the caller
asks for the CPU, and an error — never a silent CPU run — when there is no
card."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`cuda` unless the caller asks for the CPU. Raises when a CUDA
    device is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def require_on(module: torch.nn.Module, device: torch.device) -> None:
    """Raise unless every parameter and buffer of `module` lies on
    `device` (`cuda` without an index matches any card)."""
    for t in list(module.parameters()) + list(module.buffers()):
        d = t.device
        if d.type != device.type or (device.index is not None
                                     and d.index != device.index):
            raise ValueError(f"the module is on {d}, the run on {device}: "
                             "load or move it to the run's device")
