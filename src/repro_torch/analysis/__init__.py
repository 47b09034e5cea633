"""reprolint for the port: PyTorch-aware static analysis of
`src/repro_torch`, the counterpart of `repro.analysis`.

Two layers guard the invariants the port's O(t n^2) step rests on:

  * **Layer 1 — AST lint** (`repro_torch.analysis.lint` +
    `repro_torch.analysis.rules`): the reference's rules wherever their
    hazard exists in eager PyTorch (R202 cached-factory keys, R403 launch
    dimensions, R601/R602 import-time compute and device probes, R701
    request-path host syncs), each with its stable code, a fix-it message,
    inline suppression (`# reprolint: disable=R601`) and the checked-in
    baseline (`reprolint_baseline.txt`).
  * **Layer 2 — contract checker** (`repro_torch.analysis.contracts`):
    runs every entry of the LIVE fill / rect-fill / accumulate-fill /
    update-kernel / method registries on tiny real tensors on `device=`
    (a ctypes kernel has no abstract form) and checks shapes, dtypes,
    in-place updates, device copies, dispatch sequences across padded
    batch sizes, the ENGINES table and the megakernel's one launch a step.

CLI front door: ``python -m repro_torch.launch.lint --strict``.
"""

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.baseline import load_baseline, write_baseline
from repro_torch.analysis.lint import lint_source, lint_file, lint_tree

__all__ = [
    "Finding",
    "load_baseline",
    "write_baseline",
    "lint_source",
    "lint_file",
    "lint_tree",
]
