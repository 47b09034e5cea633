"""Traffic mixes, and the seeded streams every kind draws its inputs from.

A mix is a data file (`portbench/traffic/<name>.json`) of parameters;
the configuration's kind (`portbench/kinds/<kind>.py`) is the generator
that reads it. Each draw has its own stream, derived from `--seed` and a
stream number, so a kind can draw the same input again, in any order,
for the reference.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


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


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A `torch.Generator` on `device` seeded for (seed, stream)."""
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))
