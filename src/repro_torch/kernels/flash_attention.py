"""Flash-attention forward kernel: the CUDA counterpart of
`repro.kernels.flash_attention.flash_attention_pallas`.

`flash_attention_cuda(q, k, v, causal=, window=)` takes (b, h, s, d)
queries and (b, h, sk, d) keys and values -- K/V heads already repeated to
match Q's -- and returns softmax(q k^T / sqrt(d) + mask) v in q's type,
with f32 logits, running max, denominator and accumulator. On CUDA
tensors it launches a kernel of `csrc/flash_attention.cu`, chosen by dtype
alone: bf16 runs on the tensor cores (`wgmma`, K/V by TMA, P split into
bf16 hi + lo for P.V), f32 on the CUDA cores. On CPU tensors it takes
`flash_attention_plain`, the function of `ref.flash_attention_ref`. The
kernels are forward only, as the reference's Pallas kernel is: inputs that
require grad raise on the card, and the model's training path
differentiates the plain blockwise attention (`models.attention`), as the
reference's does.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import library
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.launch.hlo_analysis import KERNELS, flash_cost

__all__ = ["flash_attention_plain", "flash_attention_cuda"]

_DTYPES = {torch.float32: "flash_attention_f32",
           torch.bfloat16: "flash_attention_bf16"}
MAX_HEAD_DIM = 256
# the bf16 kernel's C function returns these besides CUDA error codes
_BF16_ERRORS = {-1: "cuTensorMapEncodeTiled is not reachable through the "
                    "CUDA runtime",
                -2: "a TMA tensor map was refused"}

# The plain version is the oracle itself: f32 logits, the -1e30 mask, a
# softmax and the f32 product with v, rounded once to q's type.
flash_attention_plain = flash_attention_ref


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window) -> None:
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"need q (b, h, s, d) and k, v (b, h, sk, d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch, heads or head dim")
    if not 0 < q.shape[3] <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[3]} is outside (0, "
                         f"{MAX_HEAD_DIM}]")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_cuda takes three float32 or three "
                        f"bfloat16 tensors, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    # a grid's y extent is at most 65535: b*h for the f32 kernel (64-query
    # tiles on x), the 128-query tiles for the bf16 one (b*h on x)
    if q.dtype == torch.float32 and q.shape[0] * q.shape[1] > 65535:
        raise ValueError(f"batch x heads = {q.shape[0] * q.shape[1]} "
                         f"exceeds 65535")
    if q.dtype == torch.bfloat16 and -(-q.shape[2] // 128) > 65535:
        raise ValueError(f"{q.shape[2]} queries exceed 65535 tiles of 128")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda needs contiguous inputs")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention_cuda is forward only, as the reference's "
            "kernel is: training differentiates the blockwise attention "
            "of models.attention (ROADMAP.md queue A 3.1)")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None
                         ) -> torch.Tensor:
    """(b, h, s, d) x (b, h, sk, d) x2 -> (b, h, s, d) in q's type.

    Key j is visible to query i when j <= i (causal) and j > i - window
    (window). CPU tensors take `flash_attention_plain`; CUDA tensors launch
    the kernel (or raise). Meta tensors in the dry run
    (`KERNELS.counting()`) give a meta result and add the kernel's cost
    to `hlo_analysis.KERNELS`.
    `flash_attention_cuda.launches` counts kernel launches."""
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    _check(q, k, v, window)
    b, h, s, d = q.shape
    sk = k.shape[2]
    if q.numel() == 0 or sk == 0:
        return torch.zeros_like(q)
    if q.device.type == "meta" and KERNELS.active:
        KERNELS.add("flash_attention", flash_cost(
            b, h, s, sk, d, causal, window, q.element_size()))
        return torch.empty_like(q)
    scale = 1.0 / math.sqrt(d)
    dk = d
    if q.dtype == torch.bfloat16 and d % 8:
        # TMA needs 16-byte row strides: zero-pad the head dim (zero columns
        # add nothing to the logits) and slice the output after
        dk = d + (-d) % 8
        q, k, v = (F.pad(x, (0, dk - d)) for x in (q, k, v))
    if q.dtype == torch.bfloat16:
        # TMA reads from 16-byte aligned addresses: a view that starts
        # inside its storage is copied to a fresh (aligned) allocation
        q, k, v = (x.clone() if x.data_ptr() % 16 else x for x in (q, k, v))
    out = torch.empty_like(q)
    fn = getattr(library("flash_attention"), _DTYPES[q.dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b * h, s, sk, dk, scale, int(causal), window or 0,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"flash attention kernel launch failed: "
            f"{_BF16_ERRORS.get(rc, f'CUDA error {rc}')}")
    flash_attention_cuda.launches += 1
    return out if dk == d else out[..., :d].contiguous()


flash_attention_cuda.launches = 0
