"""Seeded inputs of every cell: the training set and the test stream.

Features are Gaussian blobs drawn on the device by a `torch.Generator`:
one centre a class, a share `label_noise` of the train labels moved to
another class, as the port's own card checks draw them. Each draw has
its own stream, derived from `--seed` and a stream number, so the train
set and test batch i are the same whichever order they are drawn in,
and the reference can draw test batch i again. Every seed draws the same
sizes, so seeds differ in the points' values only.

A mix is a data file (`portbench/traffic/<name>.json`); this module is
the one generator that reads them.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent

TRAIN_STREAM = 1
TEST_STREAM0 = 1 << 20          # test batch i draws from stream TEST_STREAM0 + i


def load_mix(name: str, folder: Path = HERE) -> dict:
    """The traffic mix `name` from `<folder>/<name>.json`."""
    path = folder / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} at {path}")
    return json.loads(path.read_text())


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for (seed, stream): splitmix64 of both."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(stream) + 1) % (1 << 64)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % (1 << 64)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % (1 << 64)
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def _gen(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


class Blobs:
    """The cell's feature distribution: `classes` centres of scale
    `center_scale` in `d` dimensions, points at `cluster_std` around
    them, drawn on `device` from `seed`."""

    def __init__(self, cfg: dict, seed: int, device):
        self.d = int(cfg["d"])
        self.classes = int(cfg["classes"])
        self.std = float(cfg["cluster_std"])
        self.label_noise = float(cfg["label_noise"])
        self.seed = int(seed)
        self.device = torch.device(device)
        gen = _gen(seed, 0, self.device)
        self.centers = float(cfg["center_scale"]) * torch.randn(
            (self.classes, self.d), generator=gen, device=self.device)

    def _points(self, rows: int, gen: torch.Generator):
        y = torch.randint(0, self.classes, (rows,), generator=gen,
                          device=self.device, dtype=torch.int32)
        x = torch.randn((rows, self.d), generator=gen, device=self.device)
        x.mul_(self.std)
        for r0 in range(0, rows, 1 << 18):  # no (rows, d) temporary
            x[r0:r0 + (1 << 18)].add_(self.centers[y[r0:r0 + (1 << 18)]
                                                   .long()])
        return x, y

    def train(self, n: int):
        """(n, d) f32 train features and (n,) int32 labels, a share
        `label_noise` of them moved to another class."""
        gen = _gen(self.seed, TRAIN_STREAM, self.device)
        x, y = self._points(n, gen)
        if self.label_noise > 0.0 and self.classes > 1:
            flip = torch.rand((n,), generator=gen,
                              device=self.device) < self.label_noise
            shift = torch.randint(1, self.classes, (n,), generator=gen,
                                  device=self.device, dtype=torch.int32)
            y = torch.where(flip, (y + shift) % self.classes, y)
        return x, y

    def test_batch(self, i: int, rows: int):
        """Test batch `i` of `rows` points (clean labels)."""
        return self._points(rows, _gen(self.seed, TEST_STREAM0 + i,
                                       self.device))
