"""Device grids of the port: counterpart of `repro.launch.mesh`.

Functions, never module-level constants, so importing this module touches
no device.
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import DeviceGrid

__all__ = ["make_production_mesh", "make_local_mesh"]


def make_production_mesh(*, multi_pod: bool = False,
                         devices=None) -> DeviceGrid:
    """The reference's production layout: a (16, 16) ("data", "model")
    grid of 256 cells, or with `multi_pod` (2, 16, 16) ("pod", "data",
    "model"), 512 cells (the pod axis splits the 32 data rows into two
    pods: `DeviceGrid.pods`). With no `devices` every cell is
    `torch.device("meta")`, the placeholder grid of the dry run
    (`launch/dryrun.py`). A given list must fill every cell, one device a
    cell, row-major; otherwise this raises rather than share a card."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    cells = math.prod(shape)
    if devices is None:
        devices = (torch.device("meta"),) * cells
    devices = tuple(devices)
    if len(devices) != cells:
        raise ValueError(
            f"the production grid {'x'.join(map(str, shape))} needs "
            f"{cells} devices, one a cell; got {len(devices)}")
    if len(set(devices)) != cells and torch.device("meta") not in devices:
        raise ValueError("the production grid takes one distinct device a "
                         "cell; a device listed twice would share a card")
    return DeviceGrid(devices, (cells // shape[-1], shape[-1]),
                      pods=2 if multi_pod else 1)


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
