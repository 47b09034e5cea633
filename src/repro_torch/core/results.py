"""`ValuationResult`: the artifact every valuation method returns.

Counterpart of `repro.core.results`, holding torch tensors:

  * `phi`   -- (n, n) interaction matrix, diagonal = main terms, or None;
  * `point_values` -- (n,) per-point values, or None;
  * `meta`  -- JSON-able provenance dict (method, k, mode, engine, fill,
               distance, n/t/d, elapsed_s, backend, ...).

`save()`/`load()` use the JAX package's format, `<path>.npz` (arrays) plus
`<path>.json` (metadata), so either package loads the other's files.
Loaded arrays are CPU tensors.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.core import analysis

__all__ = ["ValuationResult"]


def _jsonable(obj):
    """Best-effort JSON coercion for metadata values."""
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return str(obj)


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _labels(labels) -> torch.Tensor:
    if isinstance(labels, torch.Tensor):
        return labels
    return torch.as_tensor(np.asarray(labels))


@dataclass(frozen=True)
class ValuationResult:
    """Output artifact of one valuation run (see module docstring)."""

    method: str
    phi: Optional[torch.Tensor] = None            # (n, n), diag = main terms
    point_values: Optional[torch.Tensor] = None   # (n,)
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.phi is None and self.point_values is None:
            raise ValueError("ValuationResult needs phi and/or point_values")

    @property
    def n(self) -> int:
        """Number of valued train points (rows of phi / point_values)."""
        a = self.phi if self.phi is not None else self.point_values
        return int(a.shape[0])

    def values(self) -> torch.Tensor:
        """(n,) per-point values: the stored ones, or for interaction
        results the order-2 Shapley-Taylor aggregate
        phi_ii + 1/2 sum_{j!=i} phi_ij."""
        if self.point_values is not None:
            return self.point_values
        d = torch.diag(self.phi)
        return d + 0.5 * (self.phi.sum(1) - d)

    def interaction_matrix(self) -> torch.Tensor:
        """(n, n) pair-interaction matrix; raises for per-point results."""
        if self.phi is None:
            raise ValueError(
                f"method {self.method!r} produced per-point values only -- "
                "no interaction matrix (use an interaction method: sti/sii)"
            )
        return self.phi

    def restrict(self, indices) -> "ValuationResult":
        """Sub-result over the given train-point rows (stable order): `phi`
        keeps the `indices x indices` block and `point_values` the
        `indices` entries, on the result's device; `meta` gains
        ``restricted_from`` (the original n) and the new ``n``. The block
        is gathered 4096 rows at a time, so no (m, n) intermediate is
        held beside it (16 GiB at n = 65536)."""
        idx = torch.as_tensor(np.asarray(indices, np.int64))
        phi = pv = None
        if self.phi is not None:
            i = idx.to(self.phi.device)
            m = int(i.shape[0])
            phi = self.phi.new_empty((m, m))
            for r0 in range(0, m, 4096):
                phi[r0:r0 + 4096] = self.phi[i[r0:r0 + 4096]][:, i]
        if self.point_values is not None:
            pv = self.point_values[idx.to(self.point_values.device)]
        return self.replace(
            phi=phi, point_values=pv,
            meta={**self.meta, "restricted_from": self.n,
                  "n": int(idx.shape[0])},
        )

    def efficiency_gap(self, test_accuracy) -> torch.Tensor:
        """|value mass - v(N)| (float64): the STI efficiency axiom for
        interaction results, Shapley efficiency for per-point results."""
        if self.phi is not None:
            return analysis.efficiency_gap(self.phi, test_accuracy)
        return torch.abs(
            torch.sum(self.point_values, dtype=torch.float64) - test_accuracy
        )

    def mislabel_scores(self, labels, num_classes: int) -> torch.Tensor:
        """Per-train-point mislabel suspicion, higher = more suspect."""
        if self.phi is not None:
            return analysis.mislabel_scores(self.phi, _labels(labels),
                                            num_classes)
        return -self.point_values

    def class_block_summary(self, labels, num_classes: int):
        """Mean interaction per (class, class) block of phi."""
        return analysis.class_block_summary(
            self.interaction_matrix(), _labels(labels), num_classes
        )

    def keep_order(self) -> torch.Tensor:
        """Indices ordered most-valuable first (summarization use case)."""
        return analysis.summarize_keep_order(self.values())

    def summary(self) -> dict:
        """Compact JSON-able digest: provenance + value statistics, with
        `engine`, `resolved_fill` and `streamed` always present."""
        v = _numpy(self.values())
        out = {
            "method": self.method,
            "n": self.n,
            "has_interactions": self.phi is not None,
            "values_min": float(v.min()),
            "values_mean": float(v.mean()),
            "values_max": float(v.max()),
        }
        if self.phi is not None:
            p = _numpy(self.phi)
            off = p[~np.eye(p.shape[0], dtype=bool)]
            out["interaction_off_diag_mean"] = float(off.mean())
            out["main_term_mean"] = float(np.diag(p).mean())
        out.update(_jsonable(self.meta))
        out.setdefault("engine", None)
        out.setdefault("resolved_fill", out.get("fill"))
        out.setdefault("streamed", False)
        return out

    def save(self, path) -> Path:
        """Write `<path>.npz` (arrays) + `<path>.json` (metadata); returns
        the npz path. `path` may include or omit the .npz suffix."""
        base = Path(path)
        if base.suffix == ".npz":
            base = base.with_suffix("")
        arrays = {}
        if self.phi is not None:
            arrays["phi"] = _numpy(self.phi)
        if self.point_values is not None:
            arrays["point_values"] = _numpy(self.point_values)
        npz = base.with_suffix(".npz")
        npz.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(npz, **arrays)
        base.with_suffix(".json").write_text(
            json.dumps(
                {"method": self.method, "arrays": sorted(arrays),
                 "meta": _jsonable(self.meta)},
                indent=1,
            )
        )
        return npz

    @classmethod
    def load(cls, path) -> "ValuationResult":
        """Rebuild a saved result (either package's files) from its
        `<path>.npz` + `<path>.json` pair, as CPU tensors."""
        base = Path(path)
        if base.suffix == ".npz":
            base = base.with_suffix("")
        head = json.loads(base.with_suffix(".json").read_text())
        with np.load(base.with_suffix(".npz")) as z:
            arrays = {k: torch.from_numpy(z[k].copy()) for k in z.files}
        return cls(
            method=head["method"],
            phi=arrays.get("phi"),
            point_values=arrays.get("point_values"),
            meta=head.get("meta", {}),
        )

    def replace(self, **kw) -> "ValuationResult":
        """Functional update: a copy with the given fields replaced."""
        return dataclasses.replace(self, **kw)

    def with_meta(self, **updates) -> "ValuationResult":
        """A copy with `updates` merged into `meta` (the original is
        unchanged)."""
        return self.replace(meta={**self.meta, **updates})
