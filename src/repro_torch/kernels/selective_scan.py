"""Mamba-1's fused selective scan: `csrc/selective_scan.cu` on the card,
the sequential recurrence on the CPU.

`selective_scan_cuda(x, z, dt, A, B, C, D, h0=None, lengths=None)` takes
the conv's output x and the gate z, (b, s, di) in f32 or bf16 (z may be a
view with a row stride of its own, as the gate half of in_proj's output
is), dt_proj's
output with its bias (before the softplus) in the same type, A = -exp(A_log)
(di, ds) f32, B and C (b, s, ds) (after their norms, read in f32), D (di,)
and optionally the state to start from, h0 (b, di, ds) f32, and each row's
length (b,). It returns y = (C h + D x) silu(z) in x's type and the final
state (b, di, ds) f32. Each thread carries one channel's state in f32
registers through the sequence, so no (b, s, di, ds) tensor is made; a row
stops at its length (y = 0 past it, the state as it was there).

On CPU tensors it runs `selective_scan_plain`, the recurrence position by
position in f32 (the tests' oracle). `models/ssm.py` calls the kernel for
every s > 1 on the card that autograd does not record, and keeps its
chunked scan for the CPU and for training: the kernel has no backward.
The kernel takes d_state 16, every Mamba config's.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import library

__all__ = ["selective_scan_cuda", "selective_scan_plain", "STATE_DIM"]

STATE_DIM = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def selective_scan_plain(x, z, dt, A, B, C, D, h0=None, lengths=None):
    """The recurrence one position at a time, in f32: the oracle of the
    kernel, with its conventions (softplus of dt, y = 0 past a row's
    length, the final state at the length)."""
    b, s, di = x.shape
    xf, zf = x.to(torch.float32), z.to(torch.float32)
    delta = F.softplus(dt.to(torch.float32))
    Bf, Cf = B.to(torch.float32), C.to(torch.float32)
    h = (torch.zeros((b, di, A.shape[1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.to(torch.float32))
    lens = (torch.full((b,), s, device=x.device) if lengths is None
            else lengths.to(x.device).clamp(0, s))
    ys = torch.zeros((b, s, di), dtype=torch.float32, device=x.device)
    for t in range(s):
        live = (t < lens)[:, None, None]
        dA = torch.exp(delta[:, t, :, None] * A)
        h_new = dA * h + (delta[:, t] * xf[:, t])[:, :, None] * Bf[:, t,
                                                                   None, :]
        h = torch.where(live, h_new, h)
        y = (h * Cf[:, t, None, :]).sum(-1) + D.to(torch.float32) * xf[:, t]
        ys[:, t] = torch.where(live[:, :, 0], y * F.silu(zf[:, t]), 0.0)
    return ys.to(x.dtype), h


def selective_scan_cuda(x, z, dt, A, B, C, D, h0=None, lengths=None):
    """(y (b, s, di) in x's type, h (b, di, ds) f32): the kernel on CUDA
    tensors (or raises), `selective_scan_plain` on CPU tensors.
    `selective_scan_cuda.launches` counts kernel launches."""
    if x.device.type == "cpu":
        return selective_scan_plain(x, z, dt, A, B, C, D, h0, lengths)
    b, s, di = x.shape
    ds = A.shape[1]
    if x.dtype not in _DTYPES or not (x.dtype == z.dtype == dt.dtype):
        raise TypeError(f"x, z, dt must share float32 or bfloat16, got "
                        f"{x.dtype}, {z.dtype}, {dt.dtype}")
    if ds != STATE_DIM:
        raise ValueError(f"d_state {ds}: the kernel takes {STATE_DIM}")
    if (z.shape != x.shape or dt.shape != x.shape or A.shape != (di, ds)
            or B.shape != (b, s, ds) or C.shape != B.shape
            or D.shape != (di,)
            or (h0 is not None and h0.shape != (b, di, ds))
            or (lengths is not None and tuple(lengths.shape) != (b,))):
        raise ValueError(f"z {tuple(z.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}, D {tuple(D.shape)} do not fit "
                         f"x {tuple(x.shape)}")
    if any(t is not None and t.device != x.device
           for t in (z, dt, A, B, C, D, h0)):
        raise ValueError("the scan's tensors must share x's device")
    x, dt = x.contiguous(), dt.contiguous()
    if z.stride(2) != 1 or (b > 1 and z.stride(0) != s * z.stride(1)):
        z = z.contiguous()
    A, B, C, D = (t.to(torch.float32).contiguous() for t in (A, B, C, D))
    h0 = None if h0 is None else h0.to(torch.float32).contiguous()
    lens = order = None
    if lengths is not None:
        lens = lengths.to(x.device, torch.int32).contiguous()
        # the longest rows' blocks start first
        order = torch.argsort(lens, descending=True, stable=True).to(
            torch.int32)
    y = torch.empty_like(x)
    h = torch.empty((b, di, ds), dtype=torch.float32, device=x.device)
    fn = library("selective_scan").selective_scan
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 12 + [
        ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        rc = fn(_DTYPES[x.dtype], ptr(x), ptr(z), ptr(dt), ptr(A),
                ptr(B), ptr(C), ptr(D), ptr(h0), ptr(lens), ptr(order),
                ptr(y), ptr(h), b, s, di, z.stride(1),
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"selective scan kernel launch failed: CUDA "
                           f"error {rc}")
    selective_scan_cuda.launches += 1
    return y, h


selective_scan_cuda.launches = 0
