"""The port's LM substrate (`repro_torch.models`, `configs`) against the
JAX package (`repro.models`), on the CPU in f32.

The JAX parameters are carried over with `models.params.params_from_jax`,
so both packages run the same weights on the same numpy tokens. Layers
agree within 1e-5, and attention, the forward passes, the caches and the
pooled features within 1e-4, of the largest |value| compared (or of 1):
the port's prefill runs the flash-attention function (on the CPU its plain
version, one softmax over all keys) where the JAX model sums KV blocks
with a running max, and the f32 sums are taken in another order.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig, tree_leaves, tree_map
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.launch.train import reduced_config
from repro_torch.models import attention as A
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import params_from_jax, params_to_numpy

TOL = 1e-4
LAYER_TOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    """The JAX package's LM modules (skips without JAX)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import base as jbase
    from repro.configs import registry as jregistry
    from repro.launch.train import reduced_config as jreduced
    from repro.models import attention as jA
    from repro.models import build_model as jbuild
    from repro.models import layers as jL

    return types.SimpleNamespace(jax=jax, jnp=jnp, base=jbase, A=jA, L=jL,
                                 build=jbuild, registry=jregistry,
                                 reduced=jreduced)


def _pair(jx, **kw):
    """The same small config in both packages (f32)."""
    base = dict(name="tiny", family="dense", num_layers=2, d_model=32,
                num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=120,
                head_dim=8, tp_pad_heads=1, vocab_pad=32)
    base.update(kw)
    return (jx.base.ModelConfig(**base, dtype=jx.jnp.float32),
            ModelConfig(**base, dtype=torch.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL):
    """Within `tol` of the larger of 1 and the largest |value| compared:
    the rounding of an f32 sum scales with its terms, not its result."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


# ------------------------------------------------------- parameters, configs
def test_params_round_trip_is_exact(jx):
    jcfg, cfg = _pair(jx, qkv_bias=True, qk_norm=True)
    jparams = jx.build(jcfg).init(jx.jax.random.key(0))
    host = jx.jax.tree.map(np.asarray, jparams)
    params = params_from_jax(host, device="cpu")
    # same paths: the port's own description has the JAX tree's leaves
    desc = build_model(cfg).desc()
    assert [pd.shape for pd in tree_leaves(desc, is_leaf=lambda x: hasattr(
        x, "axes"))] == [a.shape for a in jx.jax.tree.leaves(host)]
    back = params_to_numpy(params)
    assert jx.jax.tree.structure(back) == jx.jax.tree.structure(host)
    for a, b in zip(jx.jax.tree.leaves(back), jx.jax.tree.leaves(host)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert params["groups"]["blocks"][0]["mixer"]["wq"].shape == (2, 32, 32)


@pytest.mark.parametrize("name", ["internvl2-2b", "whisper-small"])
def test_get_config_raises_for_non_dense_archs(name):
    """The audio and VLM archs, the last families ported, are configs
    like any other now; only an unknown name raises."""
    cfg = registry.get_config(name)
    assert registry.ARCHS[name] is cfg
    assert cfg.family == {"internvl2-2b": "vlm",
                          "whisper-small": "audio"}[name]
    assert not hasattr(registry, "NOT_PORTED")
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config(name + "-large")


def test_dense_configs_match_the_jax_package(jx):
    for name, cfg in registry.ARCHS.items():
        jcfg = jx.registry.get_config(name)
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "d_ff", "vocab_size", "hd", "padded_heads", "padded_vocab",
                  "qk_norm", "qkv_bias", "rope_theta", "sliding_window"):
            assert getattr(cfg, f) == getattr(jcfg, f), (name, f)
        assert build_model(cfg).num_params() == \
            jx.build(jcfg).num_params(), name
    assert set(registry.ARCHS) == set(jx.registry.ARCHS)


@pytest.mark.parametrize("name", ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b",
                                  "xlstm-1.3b", "jamba-v0.1-52b"])
def test_family_configs_match_the_jax_package(jx, name):
    """The MoE, SSM and hybrid configs: every field of the port's config
    equal to JAX's (dtype by name), the derived sizes and num_params."""
    import dataclasses

    cfg, jcfg = registry.get_config(name), jx.registry.get_config(name)
    for f in dataclasses.fields(cfg):
        got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name == "dtype":
            got, want = str(got).split(".")[-1], want.__name__
        assert got == want, (name, f.name)
    for prop in ("hd", "padded_heads", "padded_vocab", "d_inner", "dt_rank_",
                 "num_groups"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), (name, prop)
    assert build_model(cfg).num_params() == jx.build(jcfg).num_params()
    assert registry.ARCHS[name] is cfg


def test_layer_schedule_raises_for_other_families():
    """Every family of the reference has a schedule; an unknown family
    raises ValueError, as the reference's does."""
    for family in ("audio", "vlm"):
        sched = T.layer_schedule(
            registry.ARCHS["qwen3-1.7b"].replace(family=family))
        assert [e.cross for e in sched] == [family == "audio"]
    cfg = registry.ARCHS["qwen3-1.7b"].replace(family="diffusion")
    with pytest.raises(ValueError, match="diffusion"):
        T.layer_schedule(cfg)


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_jax(jx, kind):
    jcfg, cfg = _pair(jx, norm_kind=kind)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    p = {"scale": rng.normal(size=32).astype(np.float32),
         "bias": rng.normal(size=32).astype(np.float32)}
    want = jx.L.apply_norm({k: jx.jnp.asarray(v) for k, v in p.items()},
                           jx.jnp.asarray(x), jcfg)
    got = L.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), cfg)
    _close(got, want, LAYER_TOL)


def test_rope_matches_jax(jx):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    want = jx.L.rope(jx.jnp.asarray(x), jx.jnp.asarray(pos), 1e6)
    _close(L.rope(_t(x), _t(pos), 1e6), want, LAYER_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_jax(jx, act):
    jcfg, cfg = _pair(jx, act=act)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    p = {w: (rng.normal(size=s) / 6).astype(np.float32) for w, s in
         (("w1", (32, 64)), ("w2", (64, 32)), ("w3", (32, 64)))}
    want = jx.L.apply_mlp({k: jx.jnp.asarray(v) for k, v in p.items()},
                          jx.jnp.asarray(x), jcfg)
    _close(L.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), cfg), want,
           LAYER_TOL)


@pytest.mark.parametrize("tie,f32", [(False, True), (True, True),
                                     (False, False)])
def test_padded_vocab_logits_match_jax(jx, tie, f32):
    jcfg, cfg = _pair(jx, tie_embeddings=tie, logits_f32=f32)
    assert cfg.padded_vocab == 128 and cfg.vocab_size == 120
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    p = {"tok": rng.normal(size=(128, 32)).astype(np.float32),
         "out": rng.normal(size=(32, 128)).astype(np.float32)}
    want = jx.L.logits_from_hidden(
        {k: jx.jnp.asarray(v) for k, v in p.items()}, jx.jnp.asarray(x),
        jcfg)
    got = L.logits_from_hidden({k: _t(v) for k, v in p.items()}, _t(x), cfg)
    assert bool((got[..., 120:] == -1e30).all())
    _close(got, want, LAYER_TOL)


def test_cross_entropy_matches_jax(jx):
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(2, 6, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jx.L.cross_entropy(jx.jnp.asarray(logits),
                                  jx.jnp.asarray(labels),
                                  None if m is None else jx.jnp.asarray(m))
        got = L.cross_entropy(_t(logits), _t(labels),
                              None if m is None else _t(m))
        _close(got, want, LAYER_TOL)


# --------------------------------------------------------------- attention
ATTN_CASES = {
    "gqa_qknorm": dict(qk_norm=True, rope_theta=1e6),
    "qkv_bias": dict(qkv_bias=True),
    "padded_heads": dict(num_heads=3, tp_pad_heads=4),
    "window": dict(sliding_window=5),
}


def _attn_params(jx, jcfg, seed):
    """attn_desc leaves drawn with numpy, biases and norms non-trivial."""
    rng = np.random.default_rng(seed)
    desc = jx.A.attn_desc(jcfg)
    host = {k: (rng.normal(size=pd.shape) / 4 + (pd.init == "ones")
                ).astype(np.float32) for k, pd in desc.items()}
    if jcfg.padded_heads != jcfg.num_heads:  # padded heads: zero wo rows
        host["wo"][jcfg.num_heads * jcfg.hd:] = 0.0
    return ({k: jx.jnp.asarray(v) for k, v in host.items()},
            {k: _t(v) for k, v in host.items()})


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_prefill_attention_and_cache_match_jax(jx, case):
    jcfg, cfg = _pair(jx, **ATTN_CASES[case])
    jp, tp = _attn_params(jx, jcfg, 6)
    x = np.random.default_rng(7).normal(size=(2, 11, 32)).astype(np.float32)
    window = cfg.sliding_window
    jy, jc = jx.A.attention(jp, jx.jnp.asarray(x), jcfg, window=window,
                            kv_block=4, return_cache=True)
    before = flash_attention_cuda.launches
    y, c = A.attention(tp, _t(x), cfg, window=window, kv_block=4,
                       return_cache=True)
    assert flash_attention_cuda.launches == before  # CPU: the plain version
    _close(y, jy)
    _close(c.k, jc.k)
    _close(c.v, jc.v)
    assert np.array_equal(c.pos.numpy(), np.asarray(jc.pos))
    # explicit positions take the plain blockwise path, as in JAX
    pos = np.broadcast_to(np.arange(11, dtype=np.int32) + 3, (2, 11))
    jy2 = jx.A.attention(jp, jx.jnp.asarray(x), jcfg, window=window,
                         kv_block=4, positions=jx.jnp.asarray(pos))
    _close(A.attention(tp, _t(x), cfg, window=window, kv_block=4,
                       positions=_t(pos.copy())), jy2)


def test_cross_attention_matches_jax(jx):
    """Cross-attention (encoder k/v, no rope, no causal mask) takes the
    plain blockwise path in prefill and reads a never-written cache in
    decode, as in JAX."""
    jcfg, cfg = _pair(jx, **ATTN_CASES["gqa_qknorm"])
    jp, tp = _attn_params(jx, jcfg, 11)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    enc = rng.normal(size=(2, 7, 32)).astype(np.float32)
    jy, jc = jx.A.attention(jp, jx.jnp.asarray(x), jcfg, kv_block=4,
                            xattn_kv=jx.jnp.asarray(enc), use_rope=False,
                            return_cache=True)
    before = flash_attention_cuda.launches
    y, c = A.attention(tp, _t(x), cfg, kv_block=4, xattn_kv=_t(enc),
                       use_rope=False, return_cache=True)
    assert flash_attention_cuda.launches == before
    _close(y, jy)
    _close(c.k, jc.k)
    x1 = rng.normal(size=(2, 1, 32)).astype(np.float32)
    jy1, _ = jx.A.decode_attention(jp, jx.jnp.asarray(x1), jcfg, jc, 3,
                                   use_rope=False, xattn=True)
    k0 = c.k.clone()
    y1, c1 = A.decode_attention(tp, _t(x1), cfg, c, 3, use_rope=False,
                                xattn=True)
    _close(y1, jy1)
    assert torch.equal(c1.k, k0)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("ring", [False, True])
def test_decode_attention_matches_jax(jx, case, ring):
    """Three decode steps after a 6-token prefill into a 9-slot cache, or
    (ring) into a ring buffer of S == window == 4 slots."""
    kw = dict(ATTN_CASES[case])
    if ring:
        kw["sliding_window"] = 4
    jcfg, cfg = _pair(jx, **kw)
    jp, tp = _attn_params(jx, jcfg, 8)
    rng = np.random.default_rng(9)
    window = cfg.sliding_window
    S = 4 if ring else 9
    kvh, hd = cfg.num_kv_heads, cfg.hd
    k0 = rng.normal(size=(2, kvh, S, hd)).astype(np.float32)
    v0 = rng.normal(size=(2, kvh, S, hd)).astype(np.float32)
    pos0 = np.full((2, S), 2**30, np.int32)
    for p in range(6 - min(S, 6), 6):  # the last S positions, ring slots
        pos0[:, p % S] = p
    jc = jx.A.KVCache(*(jx.jnp.asarray(a) for a in (k0, v0, pos0)))
    tc = A.KVCache(*(_t(a.copy()) for a in (k0, v0, pos0)))
    for index in (6, 7, 8):
        x = rng.normal(size=(2, 1, 32)).astype(np.float32)
        jy, jc = jx.A.decode_attention(jp, jx.jnp.asarray(x), jcfg, jc,
                                       index, window=window)
        y, tc = A.decode_attention(tp, _t(x), cfg, tc, index, window=window)
        _close(y, jy)
        _close(tc.k, jc.k)
        assert np.array_equal(tc.pos.numpy(), np.asarray(jc.pos))


# ------------------------------------------------------------ whole model
@pytest.fixture(scope="module", params=["qwen3-1.7b", "smollm-360m"])
def lm(request, jx):
    """reduced_config of the arch at 2 layers, f32, the JAX params carried
    over, and numpy tokens."""
    name = request.param
    jcfg = jx.reduced(jx.registry.get_config(name)).replace(num_layers=2)
    cfg = reduced_config(registry.get_config(name)).replace(num_layers=2)
    jmodel = jx.build(jcfg)
    jparams = jmodel.init(jx.jax.random.key(0))
    params = params_from_jax(jx.jax.tree.map(np.asarray, jparams),
                             device="cpu")
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size,
                                              (2, 13)).astype(np.int32)
    return types.SimpleNamespace(jcfg=jcfg, cfg=cfg, jmodel=jmodel,
                                 jparams=jparams, model=build_model(cfg),
                                 params=params, toks=toks)


def test_forward_train_and_embed_match_jax(jx, lm):
    jt = jx.jnp.asarray(lm.toks)
    jl, jh, _, _ = lm.jmodel._fwd(lm.jparams, {"tokens": jt}, "train")
    tt = _t(lm.toks)
    with torch.no_grad():
        logits, hidden, caches, _ = lm.model._fwd(lm.params, {"tokens": tt},
                                                  "train")
        emb = lm.model.embed(lm.params, {"tokens": tt})
    assert caches is None
    _close(logits, jl)
    _close(hidden, jh)
    _close(emb, lm.jmodel.embed(lm.jparams, {"tokens": jt}))


def test_prefill_and_decode_match_jax(jx, lm):
    s = 12
    jt = jx.jnp.asarray(lm.toks)
    jlast, jcaches = lm.jmodel.prefill(lm.jparams, {"tokens": jt[:, :s]})
    with torch.no_grad():
        last, caches = lm.model.prefill(lm.params,
                                        {"tokens": _t(lm.toks[:, :s])})
    _close(last, jlast)
    assert caches[0]["kv"].k.shape == (2, 2, 4, s, 64)
    _close(caches[0]["kv"].k, jcaches[0]["kv"].k)
    _close(caches[0]["kv"].v, jcaches[0]["kv"].v)
    # one decode step at position s into caches grown by 8 slots
    jgrown = [{"kv": jx.A.KVCache(
        jx.jnp.pad(c["kv"].k, [(0, 0)] * 3 + [(0, 8), (0, 0)]),
        jx.jnp.pad(c["kv"].v, [(0, 0)] * 3 + [(0, 8), (0, 0)]),
        jx.jnp.pad(c["kv"].pos, [(0, 0), (0, 0), (0, 8)],
                   constant_values=2**30))} for c in jcaches]
    tgrown = lm.model.init_caches(2, s + 8, device="cpu")
    for pool, one in zip(tgrown, caches):
        pool["kv"].k[..., :s, :] = one["kv"].k
        pool["kv"].v[..., :s, :] = one["kv"].v
        pool["kv"].pos[..., :s] = one["kv"].pos
    jdec, jc2 = lm.jmodel.decode_step(lm.jparams, {
        "tokens": jt[:, s:s + 1], "caches": jgrown,
        "index": jx.jnp.asarray(s, jx.jnp.int32)})
    with torch.no_grad():
        dec, c2 = lm.model.decode_step(lm.params, {
            "tokens": _t(lm.toks[:, s:s + 1]), "caches": tgrown,
            "index": s})
    assert c2 is tgrown  # written in place
    _close(dec, jdec)
    _close(c2[0]["kv"].k, jc2[0]["kv"].k)
    assert np.array_equal(c2[0]["kv"].pos.numpy(),
                          np.asarray(jc2[0]["kv"].pos))


def test_port_prefill_decode_consistency(lm):
    """logits(decode at position s | prefill of s tokens) equal the last
    logits of a forward over s + 1 tokens (tests/test_models_smoke.py's
    check, at its tolerance 2e-3)."""
    s = 12
    toks = _t(lm.toks)
    with torch.no_grad():
        full, _, _, _ = lm.model._fwd(lm.params, {"tokens": toks}, "train")
        _, caches = lm.model.prefill(lm.params, {"tokens": toks[:, :s]})
        pool = lm.model.init_caches(2, s + 8, device="cpu")
        for p_, one in zip(pool, caches):
            p_["kv"].k[..., :s, :] = one["kv"].k
            p_["kv"].v[..., :s, :] = one["kv"].v
            p_["kv"].pos[..., :s] = one["kv"].pos
        dec, _ = lm.model.decode_step(lm.params, {
            "tokens": toks[:, s:s + 1], "caches": pool, "index": s})
    torch.testing.assert_close(dec[:, 0], full[:, -1], rtol=2e-3, atol=2e-3)
    assert torch.equal(dec[:, 0].argmax(-1), full[:, -1].argmax(-1))


# ---------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 5])
def test_cuda_forward_runs_the_kernel_and_matches_cpu(cuda, window):
    """The same f32 params on the card and on the CPU: train and prefill
    run the flash kernel once a layer on the card, and agree with the CPU
    forward (the plain version) within TOL of the largest |value|."""
    cfg = ModelConfig(name="tiny", family="dense", num_layers=3,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=96,
                      vocab_size=200, head_dim=16, tp_pad_heads=1,
                      vocab_pad=64, qk_norm=True, sliding_window=window,
                      dtype=torch.float32)
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    cpu_params = model.init(gen, device="cpu")
    gpu_params = tree_map(lambda t: t.to(cuda), cpu_params)
    toks = torch.randint(0, cfg.vocab_size, (2, 150), generator=gen)
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        want, _, _, _ = model._fwd(cpu_params, {"tokens": toks}, "train")
        before = flash_attention_cuda.launches
        got, _, _, _ = model._fwd(gpu_params, {"tokens": toks.to(cuda)},
                                  "train")
        last, caches = model.prefill(gpu_params,
                                     {"tokens": toks.to(cuda)})
        torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 2 * cfg.num_layers
    nv = cfg.vocab_size
    _close(got[..., :nv].cpu(), want[..., :nv].numpy())
    _close(last[..., :nv].cpu(), want[:, -1:, :nv].numpy())
    assert caches[0]["kv"].k.is_cuda
