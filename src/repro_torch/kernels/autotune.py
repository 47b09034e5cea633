"""Cache-miss heuristics that resolve fill="auto" and distance="auto".

Counterpart of the fallback half of `repro.kernels.autotune`: on a CUDA
device "auto" resolves to the port's kernels ("cuda" fill and rect fill,
"cuda" distance); on the CPU to the chunked fills and the plain distance.
There is no tuning cache yet: every "auto" takes the heuristic.
"""

from __future__ import annotations

__all__ = ["default_fill", "best_fill", "default_rect_fill",
           "best_rect_fill", "best_distance"]


def default_fill(backend: str) -> tuple[str, dict]:
    """Backend heuristic: the CUDA kernel on "cuda", the chunked fill
    (chunk=1) elsewhere."""
    if backend == "cuda":
        return "cuda", {}
    return "chunked", {"chunk": 1}


def best_fill(n: int, t: int, *, backend: str) -> tuple[str, dict]:
    """The fill for an (n, n) accumulator fed (t, n) batches on `backend`.
    `n` and `t` key the tuning cache a later slice adds; the heuristic
    does not read them."""
    import repro_torch.kernels.ops  # noqa: F401  (registers "cuda")

    return default_fill(backend)


# the sharded engine's row-block fill takes the same heuristic: the CUDA
# rect kernel on "cuda", the chunked rect scan (chunk=1) elsewhere
default_rect_fill = default_fill


def best_rect_fill(*, backend: str) -> tuple[str, dict]:
    """The rect fill for a row block on `backend`. The shape arguments
    join when the tuning cache does."""
    import repro_torch.kernels.ops  # noqa: F401  (registers "cuda")

    return default_fill(backend)


def best_distance(t: int, n: int, d: int, *, backend: str
                  ) -> tuple[str, dict]:
    """The distance implementation for (t, d) x (n, d) on `backend`: the
    CUDA kernel on "cuda", the plain expansion elsewhere."""
    return ("cuda", {}) if backend == "cuda" else ("plain", {})
