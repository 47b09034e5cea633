"""The port's MoE FFN (`repro_torch.models.moe`) against the JAX package's
(`repro.models.moe.apply_moe`, one device), on the CPU.

Routing is held for equality: a flipped expert choice or a different drop
changes a token's output by O(1). The inputs x and the router weights lie
on a dyadic grid (multiples of 1/16, |value| <= 1), so every f32 router
logit is exact on both sides and the probabilities tie exactly where the
logits do; the expert weights lie on the same grid, so the bf16 case
starts from exact values. XLA on the CPU cannot run the reference's bf16
expert products (a bf16 x bf16 -> f32 dot), so the bf16 case runs them
as what they compute: the bf16 operands widened to f32 (a product of two
bf16 values is exact in f32) and summed in f32. The routing of both sides is compared directly
(expert indices, queue positions, keep mask, buffer rows) through
`moe.route`, the helper `apply_moe` itself calls, against the reference's
routing lines run in JAX. Outputs and the aux loss agree within 1e-6 of
the largest |value| in f32 (sums in another order), gradients within
1e-5. In bf16 the routing (f32) is equal and the aux within 1e-6, but the
outputs only within BF16_TOL = 2e-2 of the largest |value|: XLA rounds
its bf16 SiLU (`x * sigmoid(x)`, each rounded, its sigmoid its own
approximation) unlike torch's, so 31-44 % of the SiLU outputs differ by
a bf16 ulp (2^-8 relative), and the expert products of 128 terms carry
that into the output (measured 2.9e-3 of 0.3 here).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as MOE

TOL = 1e-6
BF16_TOL = 2e-2
GRAD_TOL = 1e-5
D, E, F = 64, 4, 128


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models import moe as JMOE

    return types.SimpleNamespace(jax=jax, jnp=jnp, Config=JModelConfig,
                                 moe=JMOE)


def _cfgs(jx, dtype="float32", **kw):
    base = dict(name="moe", family="moe", num_layers=1, d_model=D,
                num_heads=4, num_kv_heads=2, d_ff=F, vocab_size=64,
                num_experts=E, experts_per_token=2, moe_group_size=16)
    base.update(kw)
    return (jx.Config(**base, dtype=getattr(jx.jnp, dtype)),
            ModelConfig(**base, dtype=getattr(torch, dtype)))


def _grid(rng, shape, span=16):
    """Multiples of 1/16 in [-span/16, span/16]: exact in f32 and bf16."""
    return (rng.integers(-span, span + 1, shape) / 16.0).astype(np.float32)


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"router": _grid(rng, (D, E)),
            "w1": _grid(rng, (E, D, F), 2), "w2": _grid(rng, (E, F, D), 2),
            "w3": _grid(rng, (E, D, F), 2)}


def _jax_routing(jx, xg, router, cfg):
    """The reference's routing lines (`repro/models/moe.py:97-110`)."""
    jnp, jax = jx.jnp, jx.jax
    n_grp, gs, _ = xg.shape
    e, topk = cfg.num_experts, cfg.experts_per_token
    logits = xg.astype(jnp.float32) @ router.astype(jnp.float32)
    probs = jax.nn.softmax(logits, -1)
    gate_vals, gate_idx = jax.lax.top_k(probs, topk)
    gate_vals = gate_vals / jnp.maximum(
        jnp.sum(gate_vals, -1, keepdims=True), 1e-9)
    cap = int(gs * topk * cfg.capacity_factor / e) + 1
    flat_idx = gate_idx.reshape(n_grp, gs * topk)
    sel = jax.nn.one_hot(flat_idx, e, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(sel, axis=1) - 1) * sel, axis=-1)
    slot = jnp.clip(flat_idx * cap + jnp.clip(pos, 0, cap - 1), 0,
                    e * cap - 1)
    return dict(gate_idx=gate_idx, gate_vals=gate_vals, pos=pos,
                keep=pos < cap, slot=slot, cap=cap)


def _grouped(x, cfg):
    b, s, d = x.shape
    gs = min(cfg.moe_group_size, b * s)
    n_grp = -(-(b * s) // gs)
    t = np.zeros((n_grp * gs, d), np.float32)
    t[:b * s] = x.reshape(-1, d)
    return t.reshape(n_grp, gs, d)


CASES = {
    # capacity 8 * gs * k / E + 1 > every queue: nothing drops
    "no_drops": dict(kw=dict(capacity_factor=8.0), shape=(2, 16)),
    "drops": dict(kw=dict(capacity_factor=1.25), shape=(2, 16)),
    # 2 * 11 tokens in groups of 16: the last group padded by 10 zero rows
    "padded_group": dict(kw=dict(capacity_factor=1.25), shape=(2, 11)),
    # a third of the rows all zero: uniform probabilities, exact ties
    "zero_rows": dict(kw=dict(capacity_factor=1.25), shape=(2, 12),
                      zero_rows=True),
    "bf16": dict(kw=dict(capacity_factor=1.25), shape=(2, 16),
                 dtype="bfloat16"),
}


def _inputs(case, seed):
    c = CASES[case]
    rng = np.random.default_rng(seed)
    x = _grid(rng, (*c["shape"], D))
    if c.get("zero_rows"):
        x[:, ::3] = 0.0
    return x


@pytest.mark.parametrize("case", sorted(CASES))
def test_routing_is_equal_to_jax(jx, case):
    jcfg, cfg = _cfgs(jx, CASES[case].get("dtype", "float32"),
                      **CASES[case]["kw"])
    x = _inputs(case, 1)
    p = _params(2)
    xg = _grouped(x, cfg)
    want = _jax_routing(jx, jx.jnp.asarray(xg), jx.jnp.asarray(p["router"]),
                        jcfg)
    got = MOE.route(torch.from_numpy(xg), torch.from_numpy(p["router"]), cfg)
    assert got.cap == want["cap"] == MOE.capacity(cfg, xg.shape[1])
    for key in ("gate_idx", "pos", "keep", "slot"):
        assert np.array_equal(getattr(got, key).numpy(),
                              np.asarray(want[key])), key
    np.testing.assert_allclose(got.gate_vals.numpy(),
                               np.asarray(want["gate_vals"]), rtol=0,
                               atol=1e-7)
    keep = got.keep.numpy()
    if case == "no_drops":
        assert keep.all()
    elif case != "bf16":
        assert not keep.all(), "the case is meant to drop choices"
    if case == "zero_rows":
        # zero rows tie across all experts: the two lowest indices win
        zero = (xg == 0).all(-1)
        assert np.array_equal(got.gate_idx.numpy()[zero],
                              np.tile([0, 1], (int(zero.sum()), 1)))


def _f32_einsum(jnp, einsum):
    """jnp.einsum with bf16 operands and an f32 result taken as f32
    products of the widened operands."""
    def run(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) for o in ops]
        return einsum(spec, *ops, preferred_element_type=
                      preferred_element_type, **kw)
    return run


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_moe_matches_jax(jx, case, monkeypatch):
    dtype = CASES[case].get("dtype", "float32")
    if dtype == "bfloat16":
        monkeypatch.setattr(jx.jnp, "einsum",
                            _f32_einsum(jx.jnp, jx.jnp.einsum))
    jcfg, cfg = _cfgs(jx, dtype, **CASES[case]["kw"])
    x = _inputs(case, 3)
    p = _params(4)
    jdt = getattr(jx.jnp, dtype)
    jout, jaux = jx.jax.jit(lambda pp, xx: jx.moe.apply_moe(pp, xx, jcfg))(
        {k: jx.jnp.asarray(v) for k, v in p.items()},
        jx.jnp.asarray(x).astype(jdt))
    out, aux = MOE.apply_moe({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x).to(cfg.dtype), cfg)
    assert out.dtype == cfg.dtype and aux.dtype == torch.float32
    want = np.asarray(jout.astype(jx.jnp.float32))
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    np.testing.assert_allclose(out.float().numpy(), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=TOL)


def test_decode_pool_capacity_is_the_references(jx):
    """A decode step routes the whole slot pool as one group: capacity
    int(slots * k * cf / E) + 1 (ROADMAP.md queue C 1.5)."""
    for slots, e, cf, want in ((4, 8, 1.25, 2), (4, 16, 1.25, 1),
                               (2, 4, 0.5, 1)):
        jcfg, cfg = _cfgs(jx, num_experts=e, capacity_factor=cf)
        assert MOE.capacity(cfg, min(cfg.moe_group_size, slots)) == want


@pytest.mark.parametrize("case", ["no_drops", "drops", "padded_group"])
def test_apply_moe_gradients_match_jax(jx, case):
    """d/d(x, params) of sum(out * r) + aux within 1e-5 of each leaf's
    max |value| (`jax.grad` against torch.autograd)."""
    jnp, jax = jx.jnp, jx.jax
    jcfg, cfg = _cfgs(jx, **CASES[case]["kw"])
    x = _inputs(case, 5)
    p = _params(6)
    r = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)

    def jloss(args):
        xx, pp = args
        out, aux = jx.moe.apply_moe(pp, xx, jcfg)
        return jnp.sum(out * jnp.asarray(r)) + aux

    jg = jax.grad(jloss)((jnp.asarray(x),
                          {k: jnp.asarray(v) for k, v in p.items()}))
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    out, aux = MOE.apply_moe(tp, tx, cfg)
    (torch.sum(out * torch.from_numpy(r)) + aux).backward()
    for got, want in [(tx.grad, jg[0])] + [(tp[k].grad, jg[1][k])
                                            for k in sorted(p)]:
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=GRAD_TOL * max(float(np.abs(want).max()), 1e-30))
