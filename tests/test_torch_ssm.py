"""The port's SSM mixers (`repro_torch.models.ssm`: Mamba, mLSTM, sLSTM)
against the JAX package's (`repro.models.ssm`), on the CPU in f32, at the
reference tests' reduced width (d_model 64, 4 heads, chunks of 8).

Parameters are the reference's own init (`init_params` under a JAX key)
carried over as numpy; inputs are drawn with numpy. Forward passes from
no state and from a given state, and decode steps, agree within 1e-5 of
the largest |value|: the Mamba scan is a log-depth scan here and an
associative scan there, and the chunked sums run in another order.
Gradients agree within 1e-5 of each leaf's largest |value|.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as S

TOL = 1e-5
KINDS = ("mamba", "mlstm", "slstm")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs.base import init_params
    from repro.models import ssm as JS

    kw = dict(name="ssm", family="ssm", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=100,
              mlstm_chunk=8, mamba_chunk=8, dt_rank=8)
    jcfg = JModelConfig(**kw, dtype=jnp.float32)
    cfg = ModelConfig(**kw, dtype=torch.float32)
    params = {}
    for i, kind in enumerate(KINDS):
        jp = init_params(getattr(JS, f"{kind}_desc")(jcfg),
                         jax.random.key(i))
        params[kind] = ({k: np.asarray(v) for k, v in jp.items()}, jp)
    return types.SimpleNamespace(jax=jax, jnp=jnp, S=JS, jcfg=jcfg, cfg=cfg,
                                 params=params)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def _states_close(got, want):
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(got, want):
        _close(g, w)


def _jfn(jx, kind, name):
    """The JAX function `{kind}_{name}` jitted with the config bound."""
    fn = getattr(jx.S, f"{kind}_{name}")
    return jx.jax.jit(lambda p, x, *st: fn(p, x, jx.jcfg, *st))


def _tp(jx, kind):
    return {k: torch.from_numpy(v.copy()) for k, v in
            jx.params[kind][0].items()}


def _tstate(kind, state):
    cls = {"mamba": S.MambaState, "mlstm": S.MLSTMState,
           "slstm": S.SLSTMState}[kind]
    return cls(*(torch.from_numpy(np.array(a, copy=True)) for a in state))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("s", [20, 8, 1])
def test_forward_from_no_state_matches_jax(jx, kind, s):
    """s = 20: chunks 8, 8 and a ragged 4 (mLSTM pads it with a log input
    gate of -1e30); s = 8: one whole chunk; s = 1: one position."""
    x = np.random.default_rng(s).normal(size=(2, s, 64)).astype(np.float32)
    jy, jst = _jfn(jx, kind, "forward")(jx.params[kind][1],
                                        jx.jnp.asarray(x))
    y, st = getattr(S, f"{kind}_forward")(_tp(jx, kind), torch.from_numpy(x),
                                          jx.cfg)
    _close(y, jy)
    _states_close(st, jst)
    assert all(bool(torch.isfinite(a).all()) for a in st)


@pytest.mark.parametrize("kind", KINDS)
def test_forward_from_a_state_and_decode_match_jax(jx, kind):
    """A 13-token forward, a 7-token forward from its state, then three
    decode steps, each from the JAX side's state carried over."""
    rng = np.random.default_rng(1)
    fwd = f"{kind}_forward"
    step = f"{kind}_decode_step"
    jp, tp = jx.params[kind][1], _tp(jx, kind)
    x = rng.normal(size=(2, 13, 64)).astype(np.float32)
    jfwd, jstep = _jfn(jx, kind, "forward"), _jfn(jx, kind, "decode_step")
    _, jst = jfwd(jp, jx.jnp.asarray(x))
    x2 = rng.normal(size=(2, 7, 64)).astype(np.float32)
    jy, jst2 = jfwd(jp, jx.jnp.asarray(x2), jst)
    y, st2 = getattr(S, fwd)(tp, torch.from_numpy(x2), jx.cfg,
                             _tstate(kind, jst))
    _close(y, jy)
    _states_close(st2, jst2)
    for _ in range(3):
        x1 = rng.normal(size=(2, 1, 64)).astype(np.float32)
        jy, jnext = jstep(jp, jx.jnp.asarray(x1), jst2)
        y, st = getattr(S, step)(tp, torch.from_numpy(x1), jx.cfg,
                                 _tstate(kind, jst2))
        _close(y, jy)
        _states_close(st, jnext)
        jst2 = jnext


@pytest.mark.parametrize("kind", KINDS)
def test_decode_from_the_initial_state_matches_jax(jx, kind):
    """Decode from `*_init_state` (mLSTM: m = -1e30, whose exp(-1e30 - m)
    terms must come out 0, never inf or NaN; sLSTM: h in bf16, promoted
    against the f32 input as JAX promotes it)."""
    x1 = np.random.default_rng(2).normal(size=(2, 1, 64)).astype(np.float32)
    jinit = getattr(jx.S, f"{kind}_init_state")(jx.jcfg, 2)
    init = getattr(S, f"{kind}_init_state")(jx.cfg, 2)
    for a, b in zip(init, jinit):
        assert np.array_equal(a.float().numpy(),
                              np.asarray(b.astype(jx.jnp.float32)))
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
    jy, jst = _jfn(jx, kind, "decode_step")(jx.params[kind][1],
                                            jx.jnp.asarray(x1), jinit)
    y, st = getattr(S, f"{kind}_decode_step")(_tp(jx, kind),
                                              torch.from_numpy(x1), jx.cfg,
                                              init)
    _close(y, jy)
    _states_close(st, jst)
    assert all(bool(torch.isfinite(a).all()) for a in st)


def test_mamba_chunk_scan_is_the_recurrence():
    """The log-depth chunk scan against h_t = dA_t h_{t-1} + dBx_t taken
    one position at a time, ragged lengths included."""
    rng = np.random.default_rng(3)
    for c in (1, 5, 8, 13):
        dA = torch.from_numpy(rng.uniform(0.2, 1.0, (2, c, 6, 4)))
        dBx = torch.from_numpy(rng.normal(size=(2, c, 6, 4)))
        h = torch.from_numpy(rng.normal(size=(2, 6, 4)))
        got = S._scan_chunk(h, dA, dBx)
        for t in range(c):
            h = dA[:, t] * h + dBx[:, t]
            torch.testing.assert_close(got[:, t], h, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", KINDS)
def test_mixer_gradients_match_jax(jx, kind):
    """d/d(x, params) of sum(y * r) over a 20-token forward (ragged last
    chunk) within 1e-5 of each leaf's largest |value|."""
    jax, jnp = jx.jax, jx.jnp
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 20, 64)).astype(np.float32)
    r = rng.normal(size=(2, 20, 64)).astype(np.float32)
    jfwd = getattr(jx.S, f"{kind}_forward")

    def jloss(args):
        xx, pp = args
        return jnp.sum(jfwd(pp, xx, jx.jcfg)[0] * jnp.asarray(r))

    jg = jax.jit(jax.grad(jloss))((jnp.asarray(x), jx.params[kind][1]))
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = {k: v.requires_grad_(True) for k, v in _tp(jx, kind).items()}
    y, _ = getattr(S, f"{kind}_forward")(tp, tx, jx.cfg)
    torch.sum(y * torch.from_numpy(r)).backward()
    _close(tx.grad, jg[0])
    for k in sorted(tp):
        _close(tp[k].grad, jg[1][k])
