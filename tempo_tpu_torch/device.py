"""Device resolution for the port.

Counterpart of the reference's ``utils/jaxenv.py`` and
``search/engine.py:cpu_pinned``. The reference pins kernels to JAX's CPU
backend when asked and quietly degrades to the default device when it
cannot; the port does neither. A caller names the device explicitly
(``"cuda"``, ``"cuda:1"``, ``"cpu"``); the default is ``"cuda"``, and
asking for CUDA on a machine without a usable card raises instead of
running on the CPU.
"""

from __future__ import annotations

import torch


class DeviceUnavailable(RuntimeError):
    """CUDA was asked for (explicitly or by default) and there is none."""


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch.device to run on: ``cuda`` unless the caller passes one.

    Raises DeviceUnavailable when the resolved device is CUDA and
    ``torch.cuda.is_available()`` is false. A CPU device is returned only
    when the caller asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "CUDA device requested but torch.cuda.is_available() is "
                "false; pass device='cpu' to run the plain CPU path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
