"""Synthetic datasets of the port: the point data seeded through numpy,
bit-identical to the JAX package's; token batches from a
`torch.Generator`."""

from repro_torch.data.synthetic import (
    flip_labels,
    make_circles,
    make_gaussian_blobs,
    make_moons,
    make_token_batch,
)

__all__ = ["make_circles", "make_moons", "make_gaussian_blobs", "flip_labels",
           "make_token_batch"]
