"""Device resolution for the port's entry points.

Every entry point takes `device=` and defaults to "cuda". A CUDA request on
a machine without a GPU raises: the port never carries on silently on the
CPU. The CPU runs only when the caller asks for it with `device="cpu"`,
and then every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "to_device"]


def resolve_device(device="cuda") -> torch.device:
    """`device` (str or torch.device) -> torch.device, raising when CUDA is
    asked for and absent. Only "cuda" and "cpu" devices are accepted."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but no CUDA device is "
            f"available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def to_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    """Numpy array or tensor -> tensor on `device` (optionally cast).
    The move is explicit: nothing is placed by default."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return x.to(device=device, dtype=dtype)
