"""Synthetic datasets of the port (seeded through numpy, bit-identical to
the JAX package's)."""

from repro_torch.data.synthetic import (
    flip_labels,
    make_circles,
    make_gaussian_blobs,
    make_moons,
)

__all__ = ["make_circles", "make_moons", "make_gaussian_blobs", "flip_labels"]
