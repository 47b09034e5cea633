"""The port's flash-attention kernel (`repro_torch.kernels.flash_attention`)
against the JAX package.

On the CPU: `flash_attention_plain` is held against
`repro.kernels.ref.flash_attention_ref` and against
`flash_attention_pallas` in interpret mode at the parameters of
tests/test_kernels.py (2e-5 for f32, 5e-2 for bf16, the JAX tests'
tolerances), and the wrapper's dispatch and argument checks are exercised
on meta tensors. The numerical design of the bf16 kernel (64-key tiles,
f32 logits from bf16 operands, P split into bf16 hi + lo for P.V, the
output rounded once) is emulated tile by tile in plain torch and held
against the plain version at the card's tolerance (one bf16 ulp + 2e-5,
element by element) and against the Pallas kernel at JAX's bf16 tolerance.
On a CUDA card (tests marked `cuda`, each under a time limit, so that a
barrier hang fails instead of stalling): the kernels are held against the
plain version, at the bf16 kernel's edges too, and the bf16 kernel's SASS
is checked for `HGMMA` (wgmma) and `UTMALDG` (TMA loads). Run those with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_flash_attention.py -q

The Pallas kernel does not mask its padded keys when `causal=False`
(ROADMAP.md queue C, fault 1: it pads K/V up to the key block and its
mask removes padded keys only through the causal test), so ragged
non-causal and window-only shapes are held against the oracle alone.
"""

import faulthandler
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    flash_attention_plain,
)

# (b, h, s, d, causal, window) of tests/test_kernels.py
KERNEL_CASES = [
    (1, 2, 64, 16, True, None),
    (2, 1, 128, 32, True, None),
    (1, 2, 96, 16, True, 32),
    (1, 1, 64, 16, False, None),
]
# ragged lengths (not a multiple of the key block), causal: Pallas pads
# K/V, and the causal test removes the padded keys
RAGGED_CAUSAL = [
    (1, 1, 200, 16, True, None),
    (1, 2, 200, 64, True, 48),
]
# ragged non-causal and window-only: the oracle alone (fault 1)
RAGGED_OPEN = [
    (1, 1, 200, 16, False, None),
    (1, 2, 200, 64, False, 48),
]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's oracle and Pallas kernel (skips without JAX)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention_pallas

    return types.SimpleNamespace(jnp=jnp, ref=jref,
                                 pallas=flash_attention_pallas)


# seconds a `cuda` test may take: past it the process ends with a
# traceback (a hung kernel blocks in C, where no Python timeout reaches)
CUDA_TEST_LIMIT_S = 300


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    faulthandler.dump_traceback_later(CUDA_TEST_LIMIT_S, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


def _qkv(b, h, s, d, seed, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    return (rng.normal(size=(b, h, s, d)).astype(np.float32),
            rng.normal(size=(b, h, sk, d)).astype(np.float32),
            rng.normal(size=(b, h, sk, d)).astype(np.float32))


def _plain(q, k, v, dtype=torch.float32, **kw):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return flash_attention_plain(*t, **kw).float().numpy()


# ------------------------------------------------------------ CPU parity
@pytest.mark.parametrize("b,h,s,d,causal,window",
                         KERNEL_CASES + RAGGED_CAUSAL)
def test_plain_matches_jax_ref_and_pallas(jx, b, h, s, d, causal, window):
    q, k, v = _qkv(b, h, s, d, s + d)
    got = _plain(q, k, v, causal=causal, window=window)
    jq, jk, jv = (jx.jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(jx.ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                                 window=window))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    pal = np.asarray(jx.pallas(jq, jk, jv, causal=causal, window=window,
                               block_q=32, block_k=32, interpret=True))
    np.testing.assert_allclose(got, pal, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,h,s,d,causal,window", RAGGED_OPEN)
def test_plain_ragged_open_masks_match_jax_ref(jx, b, h, s, d, causal,
                                               window):
    """Non-causal and window-only on a ragged length: against the oracle
    only, since the Pallas kernel attends to its padded keys there."""
    q, k, v = _qkv(b, h, s, d, 3 * s + d)
    got = _plain(q, k, v, causal=causal, window=window)
    want = np.asarray(jx.ref.flash_attention_ref(
        *(jx.jnp.asarray(a) for a in (q, k, v)), causal=causal,
        window=window))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_plain_cross_lengths_match_jax_ref(jx):
    """s != sk (the oracle's index masks): causal and not."""
    q, k, v = _qkv(1, 2, 50, 32, 11, sk=130)
    for causal in (True, False):
        got = _plain(q, k, v, causal=causal)
        want = np.asarray(jx.ref.flash_attention_ref(
            *(jx.jnp.asarray(a) for a in (q, k, v)), causal=causal))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_plain_bf16_matches_jax_ref_and_pallas(jx):
    """tests/test_kernels.py's bf16 case at its tolerance, 5e-2."""
    q, k, v = _qkv(1, 2, 64, 32, 7)
    got = _plain(q, k, v, dtype=torch.bfloat16, causal=True)
    jq, jk, jv = (jx.jnp.asarray(a).astype(jx.jnp.bfloat16)
                  for a in (q, k, v))
    want = np.asarray(jx.ref.flash_attention_ref(jq, jk, jv, causal=True),
                      np.float32)
    pal = np.asarray(jx.pallas(jq, jk, jv, causal=True, block_q=32,
                               block_k=32, interpret=True), np.float32)
    np.testing.assert_allclose(got, want, atol=5e-2)
    np.testing.assert_allclose(got, pal, atol=5e-2)


def test_ops_flash_attention_runs_plain_on_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 40, 16, 5))
    before = flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, causal=True, window=8)
    assert torch.equal(got, flash_attention_plain(q, k, v, causal=True,
                                                  window=8))
    assert flash_attention_cuda.launches == before


def test_non_cpu_tensors_go_to_the_kernel_or_raise():
    """A tensor off the CPU never takes the plain version: here (no nvcc,
    meta tensors) the wrapper reaches the kernel's build and raises."""
    m = torch.device("meta")
    q = torch.empty(1, 2, 8, 16, device=m)
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.flash_attention(q, q, q)


@pytest.mark.parametrize("case,exc", [
    ("dtype", TypeError), ("contiguous", ValueError),
    ("grad", NotImplementedError), ("window", ValueError),
    ("head_dim", ValueError), ("heads", ValueError),
    ("f32_grid_y", ValueError), ("bf16_grid_y", ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(case, exc):
    m = torch.device("meta")
    q = torch.empty(1, 2, 8, 16, device=m)
    k = v = q
    kw = {}
    if case == "dtype":
        q = q.half()
    elif case == "contiguous":
        q = torch.empty(1, 8, 2, 16, device=m).transpose(1, 2)
    elif case == "grad":
        q = q.clone().requires_grad_()
    elif case == "window":
        kw["window"] = 0
    elif case == "head_dim":
        q = k = v = torch.empty(1, 2, 8, 320, device=m)
    elif case == "f32_grid_y":  # b*h on the f32 grid's y
        q = k = v = torch.empty(2, 32768, 8, 16, device=m)
    elif case == "bf16_grid_y":  # 128-query tiles on the bf16 grid's y
        q = k = v = torch.empty(1, 1, 128 * 65535 + 1, 16, device=m,
                                dtype=torch.bfloat16)
    else:
        k = v = torch.empty(1, 1, 8, 16, device=m)
    with pytest.raises(exc):
        flash_attention_cuda(q, k, v, **kw)


@pytest.mark.parametrize("b,h,s", [(2, 32768, 8), (1, 1, 128 * 65535)])
def test_wrapper_takes_what_the_bf16_grid_takes(b, h, s):
    """b*h lies on the bf16 grid's x extent, so above 65535 it passes the
    checks, as do 65535 tiles of 128 queries: here (meta tensors, no nvcc)
    the call reaches the kernel's build and raises there."""
    q = torch.empty(b, h, s, 16, device="meta", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="nvcc"):
        flash_attention_cuda(q, q, q)


# ------------------------------------ the bf16 kernel's numerical design
def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _assert_within_one_ulp(got: torch.Tensor, want: torch.Tensor) -> None:
    """The card's bf16 check: both round an f32 function once, so they may
    differ by one bf16 ulp of the larger magnitude, plus 2e-5 for the f32
    values' own difference before rounding (it matters only where the ulp
    is below it); element by element."""
    g, w = got.float(), want.float()
    tol = _bf16_ulp(torch.maximum(g.abs(), w.abs())) + 2e-5
    # written as not-within, so that a NaN on either side fails
    bad = ~((g - w).abs() <= tol)
    assert not bool(bad.any()), (
        f"{int(bad.sum())} of {bad.numel()} elements over one ulp + 2e-5; "
        f"max abs err {float((g - w).abs().max())}")


def _emulate_bf16_kernel(q, k, v, *, causal=True, window=None, scale=None,
                         block_k=64):
    """The bf16 kernel's arithmetic in plain torch, in its tile order:
    over 64-key tiles, f32 logits from bf16 operands (the products are
    exact in f32) in log2 units (scale * log2(e) folded in), a running max
    and denominator, p = 2^(x - m) with results below 2^-126 flushed to 0
    (the kernel's `ex2.approx.ftz`; exact exp2 stands in for the
    approximation), P in f32 for the denominator and split into bf16 hi +
    lo for P.V (two products into one f32 accumulator), and
    acc / max(l, 1e-30) rounded once to bf16. Rows are independent, so the
    kernel's 64-row warpgroup tiles need no loop here, and skipping a tile
    that masks all of a row's keys changes nothing (it scales by 2^0 and
    adds 0)."""
    s, sk, d = q.shape[-2], k.shape[-2], q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    scale2 = scale * 1.4426950408889634

    def ex2_ftz(x):
        y = torch.exp2(x)
        return torch.where(y < 2.0 ** -126, 0.0, y)

    qf, kf, vf = (x.to(torch.bfloat16).float() for x in (q, k, v))
    qi = torch.arange(s)[:, None]
    m = torch.full(q.shape[:-1], -1e30)
    l = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape)
    for k0 in range(0, sk, block_k):
        kt, vt = kf[..., k0:k0 + block_k, :], vf[..., k0:k0 + block_k, :]
        ki = k0 + torch.arange(kt.shape[-2])[None, :]
        vis = torch.ones((s, kt.shape[-2]), dtype=torch.bool)
        if causal:
            vis &= ki <= qi
        if window is not None:
            vis &= ki > qi - window
        sc = torch.where(vis, torch.einsum("bhqd,bhkd->bhqk", qf, kt)
                         * scale2, torch.tensor(-1e30))
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = ex2_ftz(m - m_new)
        p = torch.where(vis, ex2_ftz(sc - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        acc = acc * alpha[..., None] + hi @ vt + lo @ vt
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(torch.bfloat16)


# (b, h, s, sk, d, causal, window): chip_smoke.py's held cases at small
# size, cross lengths both ways, the head dims of the configs (64, 96,
# 128) and whisper's encoder and cross lengths. No row here is left without a visible key (the kernel gives such a
# row 0, the oracle the mean of v).
DESIGN_CASES = [
    (1, 2, 64, 64, 16, True, None),
    (2, 1, 128, 128, 32, True, None),
    (1, 2, 96, 96, 16, True, 32),
    (1, 1, 64, 64, 16, False, None),
    (1, 2, 200, 200, 64, True, None),
    (1, 2, 200, 200, 64, False, None),
    (1, 2, 200, 200, 64, False, 48),
    (1, 2, 200, 200, 64, True, 48),
    (1, 2, 256, 256, 128, True, None),
    (1, 2, 130, 130, 96, True, 40),
    (1, 2, 50, 130, 32, True, None),
    (1, 2, 130, 50, 64, False, None),
    (1, 2, 130, 50, 96, True, None),
    # whisper: the encoder's 1500 frames (non-causal, ragged last key tile
    # of 28) and the decoder's 448 positions against them (cross)
    (1, 2, 1500, 1500, 64, False, None),
    (1, 2, 448, 1500, 64, False, None),
]


def _qkv_bf16(b, h, s, sk, d, seed):
    return [torch.from_numpy(a).to(torch.bfloat16)
            for a in _qkv(b, h, s, d, seed, sk)]


@pytest.mark.parametrize("b,h,s,sk,d,causal,window", DESIGN_CASES)
def test_bf16_design_matches_plain_within_one_ulp(b, h, s, sk, d, causal,
                                                  window):
    q, k, v = _qkv_bf16(b, h, s, sk, d, 7 * s + sk + d)
    got = _emulate_bf16_kernel(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    _assert_within_one_ulp(got, want)


# causal, or a length that is a multiple of the Pallas key block: where
# the Pallas kernel masks every padded key (fault 1)
PALLAS_CASES = [c for c in DESIGN_CASES
                if c[2] == c[3] and (c[5] or c[2] % 32 == 0)]


@pytest.mark.parametrize("b,h,s,sk,d,causal,window", PALLAS_CASES)
def test_bf16_design_matches_pallas(jx, b, h, s, sk, d, causal, window):
    """Against the TPU kernel in interpret mode at JAX's bf16 tolerance
    (tests/test_kernels.py, atol 5e-2)."""
    q, k, v = _qkv_bf16(b, h, s, sk, d, 7 * s + sk + d)
    got = _emulate_bf16_kernel(q, k, v, causal=causal, window=window)
    jq, jk, jv = (jx.jnp.asarray(x.float().numpy()).astype(jx.jnp.bfloat16)
                  for x in (q, k, v))
    pal = np.asarray(jx.pallas(jq, jk, jv, causal=causal, window=window,
                               block_q=32, block_k=32, interpret=True),
                     np.float32)
    np.testing.assert_allclose(got.float().numpy(), pal, atol=5e-2)


@pytest.mark.parametrize("d", [20, 100])
def test_bf16_design_padded_head_dim(d):
    """The wrapper's path for d % 8 != 0: the head dim zero-padded to a
    multiple of 8, the scale of the true d, the output sliced."""
    q, k, v = _qkv_bf16(1, 2, 150, 150, d, d)
    dp = d + (-d) % 8
    pad = [torch.nn.functional.pad(x, (0, dp - d)) for x in (q, k, v)]
    got = _emulate_bf16_kernel(*pad, causal=True, window=70,
                               scale=1.0 / math.sqrt(d))[..., :d]
    want = flash_attention_plain(q, k, v, causal=True, window=70)
    _assert_within_one_ulp(got, want)


# ---------------------------------------------------------- on the card


def _hold(cuda, b, h, s, d, causal, window, dtype, sk=None):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in _qkv(b, h, s, d, 5 * s + d, sk))
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    assert flash_attention_cuda.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        # the same f32 function, sums in another order: the JAX tolerance
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        _assert_within_one_ulp(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,s,d,causal,window",
                         KERNEL_CASES + RAGGED_CAUSAL + RAGGED_OPEN + [
                             (1, 2, 200, 64, True, None),
                             (1, 2, 200, 64, False, None),
                             (1, 16, 2048, 128, True, None),
                             (1, 3, 130, 96, True, 40),
                             (2, 2, 70, 256, False, None),
                         ])
def test_cuda_kernel_matches_plain(cuda, b, h, s, d, causal, window, dtype):
    _hold(cuda, b, h, s, d, causal, window, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_kernel_cross_lengths(cuda, causal):
    _hold(cuda, 1, 2, 50, 32, causal, None, torch.float32, sk=130)


@pytest.mark.cuda
def test_cuda_kernel_rejects_grad(cuda):
    q = torch.randn(1, 2, 16, 16, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward only"):
        flash_attention_cuda(q, q.detach(), q.detach())


# the bf16 kernel's edges: lengths around its 64-row and 64-key tiles,
# s != sk both ways, every head dim it instantiates (64-column boxes:
# d <= 64, 128, 192, 256), d % 8 != 0 through the padding path, b*h above
# the 132 SMs, windows that cross a key tile's edge
EDGE_LENGTHS = [(1, 1), (63, 63), (65, 65), (200, 200), (2049, 2049),
                (1, 200), (200, 1), (63, 2049), (2049, 63), (65, 200),
                (200, 65)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,sk", EDGE_LENGTHS)
def test_cuda_bf16_lengths(cuda, s, sk, causal):
    _hold(cuda, 1, 2, s, 128, causal, None, torch.bfloat16, sk=sk)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 24, 32, 48, 64, 72, 96, 120, 128, 136,
                               160, 192, 200, 256, 20, 100, 250])
def test_cuda_bf16_head_dims(cuda, d):
    _hold(cuda, 1, 2, 300, d, True, None, torch.bfloat16)
    _hold(cuda, 1, 2, 130, d, False, 70, torch.bfloat16, sk=200)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 63, 64, 65, 100])
def test_cuda_bf16_windows(cuda, window):
    _hold(cuda, 1, 2, 300, 128, True, window, torch.bfloat16)
    _hold(cuda, 1, 2, 300, 64, False, window, torch.bfloat16)


@pytest.mark.cuda
def test_cuda_bf16_many_heads(cuda):
    _hold(cuda, 2, 80, 256, 64, True, None, torch.bfloat16)


@pytest.mark.cuda
def test_cuda_bf16_takes_misaligned_inputs(cuda):
    """TMA reads from 16-byte aligned addresses: a contiguous view two
    bytes into its storage is copied, launched, and held like any input."""
    flat = torch.from_numpy(np.random.default_rng(3).normal(
        size=1 + 3 * 2 * 200 * 64).astype(np.float32)).to(cuda, torch.bfloat16)
    q, k, v = (flat[1 + i * 2 * 200 * 64:1 + (i + 1) * 2 * 200 * 64]
               .view(1, 2, 200, 64) for i in range(3))
    assert q.data_ptr() % 16
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v, causal=True)
    assert flash_attention_cuda.launches == before + 1
    _assert_within_one_ulp(got, flash_attention_plain(q, k, v, causal=True))


@pytest.mark.cuda
def test_cuda_bf16_kernel_runs_on_wgmma_and_tma(cuda):
    """The bf16 kernel's SASS holds HGMMA (wgmma) and UTMALDG (TMA loads);
    the f32 kernel's holds neither."""
    kernels = build.sass("flash_attention")
    bf16 = {n: t for n, t in kernels.items()
            if "flash_attention_wgmma_kernel" in n}
    f32 = {n: t for n, t in kernels.items() if "flash_attention_kernel" in n}
    assert len(bf16) == 4 and len(f32) == 4, sorted(kernels)
    for name, text in bf16.items():
        assert "HGMMA" in text and "UTMALDG" in text, name
    for name, text in f32.items():
        assert "HGMMA" not in text and "UTMALDG" not in text, name
