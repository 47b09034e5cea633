"""The port's flash-attention kernel (`repro_torch.kernels.flash_attention`)
against the JAX package.

On the CPU: `flash_attention_plain` is held against
`repro.kernels.ref.flash_attention_ref` and against
`flash_attention_pallas` in interpret mode at the parameters of
tests/test_kernels.py (2e-5 for f32, 5e-2 for bf16, the JAX tests'
tolerances), and the wrapper's dispatch and argument checks are exercised
on meta tensors. On a CUDA card (tests marked `cuda`): the kernel is held
against the plain version. Run those with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_flash_attention.py -q

The Pallas kernel does not mask its padded keys when `causal=False`
(ROADMAP.md queue C, fault 1: it pads K/V up to the key block and its
mask removes padded keys only through the causal test), so ragged
non-causal and window-only shapes are held against the oracle alone.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    return torch.device("cuda")


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
    else:
        k = v = torch.empty(1, 1, 8, 16, device=m)
    with pytest.raises(exc):
        flash_attention_cuda(q, k, v, **kw)


# ---------------------------------------------------------- on the card
def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


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
        # both round the same f32 function once: one bf16 ulp of the
        # larger magnitude, plus 2e-5 for the f32 values' own difference
        # before rounding (it matters only where the ulp is below it)
        g, w = got.float(), want.float()
        tol = _bf16_ulp(torch.maximum(g.abs(), w.abs())) + 2e-5
        assert bool(((g - w).abs() <= tol).all()), float((g - w).abs().max())


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
