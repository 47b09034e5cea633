"""Device grids of the port: counterpart of `repro.launch.mesh`.

A function, never a module-level constant, so importing this module
touches no device. `make_production_mesh` (the TPU pod's 16 x 16 layout)
waits for the tooling slice (ROADMAP.md queue A 4).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import DeviceGrid

__all__ = ["make_local_mesh"]


def make_local_mesh(device="cuda") -> DeviceGrid:
    """Every local card as an (n_cards, 1) ("data", "model") grid; a
    device that names one card (`"cuda:1"`) or the CPU (`"cpu"`) as a
    (1, 1) grid of it. Raises when a card is asked for and absent."""
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return DeviceGrid((dev,), (1, 1))
    count = torch.cuda.device_count()
    return DeviceGrid(tuple(torch.device("cuda", i) for i in range(count)),
                      (count, 1))
