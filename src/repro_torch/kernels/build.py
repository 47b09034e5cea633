"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. On first use, `nvcc` builds
every source into its own shared library for `sm_90a`, all of them at once,
one process each, and the library is loaded with `ctypes`. Libraries land
in `src/repro_torch/_build/` (listed in .gitignore) under a name that
carries a hash of the source, of the `csrc/*.cuh` headers it includes and
of the flags, so a changed source or header is rebuilt and an unchanged
one is reused. Importing this module builds nothing: the
first wrapper that launches a kernel triggers the build, and a missing
`nvcc` or a failed build raises -- there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "SOURCES", "build_all", "library", "sass"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# every kernel source of the port; build_all compiles them in parallel
SOURCES = ("distance", "sti_fill", "sti_megakernel", "flash_attention",
           "rank_sort", "selective_scan", "point_update")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of repro_torch are built from csrc/ at first use"
        )
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen: set) -> bytes:
    """The bytes of `path` followed by those of every local header it
    includes ("..." includes next to it), each file once."""
    if path in seen:
        return b""
    seen.add(path)
    src = path.read_bytes()
    return src + b"".join(_sources(path.parent / inc.decode(), seen)
                          for inc in _INCLUDE.findall(src))


def _target(name: str) -> Path:
    src = _sources(CSRC / f"{name}.cu", set())
    digest = hashlib.sha1(src + " ".join(_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Build every named source that has no up-to-date library, one `nvcc`
    process per source, all started together. Returns {name: ptxas
    report} for the sources built by this call; raises on any failure."""
    todo = [nm for nm in names if not _target(nm).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for nm in todo:
        tmp = _target(nm).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(CSRC / f"{nm}.cu")]
        procs[nm] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for nm, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[nm] = out
        if proc.returncode != 0:
            failed.append(f"{nm}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, _target(nm))  # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of `csrc/<name>.cu`, building every
    source on the first call."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib


def sass(name: str) -> dict[str, str]:
    """The SASS of the built library of `csrc/<name>.cu` (building every
    source first), by `cuobjdump -sass` from the toolkit beside `nvcc`:
    {mangled kernel name: its instructions}."""
    library(name)
    tool = Path(_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(_target(name))],
                          capture_output=True, text=True, check=True).stdout
    kernels = {}
    for part in text.split("Function : ")[1:]:
        head, _, body = part.partition("\n")
        kernels[head.strip()] = body
    return kernels
