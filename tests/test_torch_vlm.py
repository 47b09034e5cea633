"""The port's VLM family (patch embeddings prepended to the tokens,
`configs.internvl2_2b`) against the JAX package, on the CPU in f32, at
the reduced shapes of tests/test_models_smoke.py (d_model 64, 2 layers,
4 patches).

The parameters are JAX's (`Model.init` under key 0) carried over with
`params_from_jax`, every normally drawn leaf at 1/16 (TAME, ROADMAP.md
queue C 1.6). Train, prefill and decode logits agree within 1e-4 of the
largest |value|, the loss (on the text segment only) and every gradient
leaf within 1e-5, and the serving engines token for token on text-only
prompts.
"""

import dataclasses
import faulthandler
import types

import numpy as np
import pytest
import torch

from test_torch_families import (
    CUDA_TEST_LIMIT_S, GRAD_TOL, PROMPTS, _close, _grow, _serve, init_kinds,
    reduced_kw, tamed)

from repro_torch.configs import registry
from repro_torch.configs.base import PD, tree_leaves, tree_map
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import reduced_config
from repro_torch.models import build_model
from repro_torch.models.params import (
    caches_from_jax, params_from_jax, params_to_numpy)
from repro_torch.serving.engine import Engine, ServeConfig

NAME = "internvl2-2b"
VLM = dict(num_patches=4, max_seq_len=256)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import registry as jregistry
    from repro.models import build_model as jbuild
    from repro.serving.engine import Engine as JEngine
    from repro.serving.engine import ServeConfig as JServeConfig

    return types.SimpleNamespace(jax=jax, jnp=jnp, registry=jregistry,
                                 build=jbuild, Engine=JEngine,
                                 ServeConfig=JServeConfig)


@pytest.fixture(scope="module")
def vl(jx):
    """The reduced internvl2 in both packages on JAX's tamed parameters."""
    jcfg = jx.registry.get_config(NAME)
    cfg = registry.get_config(NAME)
    jcfg = jcfg.replace(**reduced_kw(jcfg, **VLM), dtype=jx.jnp.float32)
    cfg = cfg.replace(**reduced_kw(cfg, **VLM), dtype=torch.float32)
    jmodel, model = jx.build(jcfg), build_model(cfg)
    host = tamed(jx.jax.tree.map(np.asarray,
                                 jmodel.init(jx.jax.random.key(0))),
                 init_kinds(model))
    return types.SimpleNamespace(
        jcfg=jcfg, cfg=cfg, jmodel=jmodel, model=model, host=host,
        jparams=jx.jax.tree.map(jx.jnp.asarray, host),
        params=params_from_jax(host, device="cpu"))


def _patches(seed, cfg, b=2):
    return np.random.default_rng(seed).normal(
        size=(b, cfg.num_patches, cfg.d_model)).astype(np.float32)


def _tokens(seed, b=2, s=13, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _batches(jx, **arrays):
    return ({k: jx.jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


# ------------------------------------------------------------ config, params
def test_config_and_num_params_match_the_jax_package(jx):
    cfg, jcfg = registry.get_config(NAME), jx.registry.get_config(NAME)
    for f in dataclasses.fields(cfg):
        got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name == "dtype":
            got, want = str(got).split(".")[-1], want.__name__
        assert got == want, f.name
    assert cfg.num_patches == 256
    assert build_model(cfg).num_params() == jx.build(jcfg).num_params()


def test_params_round_trip_is_exact(jx, vl):
    assert [pd.shape for pd in tree_leaves(
        vl.model.desc(), is_leaf=lambda x: isinstance(x, PD))] == \
        [a.shape for a in jx.jax.tree.leaves(vl.host)]
    assert vl.model.num_params() == vl.jmodel.num_params()
    back = params_to_numpy(vl.params)
    assert jx.jax.tree.structure(back) == jx.jax.tree.structure(vl.host)
    for a, b in zip(jx.jax.tree.leaves(back), jx.jax.tree.leaves(vl.host)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ------------------------------------------------------------------ forward
def test_train_logits_match_jax(jx, vl):
    """Logits over the patch and text positions (p + s rows)."""
    jb, tb = _batches(jx, tokens=_tokens(1), patch_embeds=_patches(1,
                                                                   vl.cfg))
    jl, jh, _, _ = jx.jax.jit(lambda p, b: vl.jmodel._fwd(
        p, b, "train"))(vl.jparams, jb)
    with torch.no_grad():
        logits, hidden, caches, aux = vl.model._fwd(vl.params, tb, "train")
    assert logits.shape[1] == vl.cfg.num_patches + 13 and caches is None
    _close(logits, jl)
    _close(hidden, jh)


def test_loss_on_the_text_and_grads_match_jax(jx, vl):
    toks = _tokens(2, s=18)
    jb, tb = _batches(jx, tokens=toks[:, :-1], labels=toks[:, 1:],
                      patch_embeds=_patches(2, vl.cfg))
    (jloss, _), jgrads = jx.jax.jit(jx.jax.value_and_grad(
        vl.jmodel.loss_fn, has_aux=True))(vl.jparams, jb)
    params = params_from_jax(vl.host, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = vl.model.loss_fn(params, tb)
    grads = torch.autograd.grad(loss, leaves)
    _close(loss.detach(), jloss, GRAD_TOL)
    want = jx.jax.tree.leaves(jgrads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        _close(g, w, GRAD_TOL)
    # the loss reads the text rows only: the cross entropy of the logits
    # past the patches
    from repro_torch.models import layers as L
    with torch.no_grad():
        logits = vl.model._fwd(vl.params, tb, "train")[0]
        ce = L.cross_entropy(logits[:, vl.cfg.num_patches:], tb["labels"])
    torch.testing.assert_close(metrics["ce"].detach(), ce)


def test_embed_matches_jax(jx, vl):
    """The features pool over the patch positions too (the reference's
    mean over the whole hidden state)."""
    jb, tb = _batches(jx, tokens=_tokens(3, b=3, s=8),
                      patch_embeds=_patches(3, vl.cfg, b=3))
    want = jx.jax.jit(vl.jmodel.embed)(vl.jparams, jb)
    with torch.no_grad():
        got = vl.model.embed(vl.params, tb)
        hidden = vl.model._fwd(vl.params, tb, "train")[1]
    assert got.shape == (3, vl.cfg.d_model)
    _close(got, want)
    torch.testing.assert_close(got, hidden.mean(1))


def test_prefill_and_decode_match_jax(jx, vl):
    """Prefill of 4 patches + 12 tokens, then 4 decode steps at index
    16..19 from JAX's caches carried over."""
    s, p = 12, vl.cfg.num_patches
    toks = _tokens(4, s=s + 4)
    jb, tb = _batches(jx, tokens=toks[:, :s], patch_embeds=_patches(4,
                                                                    vl.cfg))
    jlast, jcaches = jx.jax.jit(vl.jmodel.prefill)(vl.jparams, jb)
    with torch.no_grad():
        last, caches = vl.model.prefill(vl.params, tb)
    _close(last, jlast)
    assert caches[0]["kv"].k.shape[3] == p + s
    for got, want in zip(tree_leaves(caches), jx.jax.tree.leaves(jcaches)):
        if want.dtype == np.int32:
            assert np.array_equal(got.numpy(), np.asarray(want))
        else:
            _close(got, want)
    jc = _grow(jx, jcaches, p + s)
    tc = caches_from_jax(jx.jax.tree.map(np.asarray, jc), device="cpu")
    jdec = jx.jax.jit(vl.jmodel.decode_step)
    for t in range(4):
        step = toks[:, s + t:s + t + 1]
        jl, jc = jdec(vl.jparams, {"tokens": jx.jnp.asarray(step),
                                   "caches": jc,
                                   "index": jx.jnp.asarray(p + s + t,
                                                           jx.jnp.int32)})
        with torch.no_grad():
            tl, tc = vl.model.decode_step(vl.params, {
                "tokens": torch.from_numpy(step), "caches": tc,
                "index": p + s + t})
        _close(tl, jl)
    for got, want in zip(tree_leaves(tc), jx.jax.tree.leaves(jc)):
        if want.dtype == np.int32:
            assert np.array_equal(got.numpy(), np.asarray(want))
        else:
            _close(got, want)


def test_prefill_decode_consistency_in_both_packages(jx, vl):
    """tests/test_models_smoke.py's check in both packages: decode at
    position p + s after a prefill of p patches and s tokens gives the
    last logits of a forward over p + s + 1; the two agree too."""
    s, p = 12, vl.cfg.num_patches
    toks = _tokens(5, s=s + 1)
    pe = _patches(5, vl.cfg)
    jnp, jax = jx.jnp, jx.jax
    jfull = jax.jit(lambda pr, b: vl.jmodel._fwd(pr, b, "train"))(
        vl.jparams, {"tokens": jnp.asarray(toks),
                     "patch_embeds": jnp.asarray(pe)})[0]
    _, jc = jax.jit(vl.jmodel.prefill)(vl.jparams, {
        "tokens": jnp.asarray(toks[:, :s]), "patch_embeds": jnp.asarray(pe)})
    jdec = jax.jit(vl.jmodel.decode_step)(vl.jparams, {
        "tokens": jnp.asarray(toks[:, s:]), "caches": _grow(jx, jc, p + s),
        "index": jnp.asarray(p + s, jnp.int32)})[0]
    np.testing.assert_allclose(np.asarray(jdec[:, 0]),
                               np.asarray(jfull[:, -1]), rtol=2e-3,
                               atol=2e-3)
    pt = torch.from_numpy(pe)
    with torch.no_grad():
        full = vl.model._fwd(vl.params, {"tokens": torch.from_numpy(toks),
                                         "patch_embeds": pt}, "train")[0]
        _, caches = vl.model.prefill(vl.params, {
            "tokens": torch.from_numpy(toks[:, :s]), "patch_embeds": pt})
        pool = vl.model.init_caches(2, p + s + 8, device="cpu")
        for pc, one in zip(pool, caches):
            pc["kv"].k[..., :p + s, :] = one["kv"].k
            pc["kv"].v[..., :p + s, :] = one["kv"].v
            pc["kv"].pos[..., :p + s] = one["kv"].pos
        dec, _ = vl.model.decode_step(vl.params, {
            "tokens": torch.from_numpy(toks[:, s:]), "caches": pool,
            "index": p + s})
    torch.testing.assert_close(dec[:, 0], full[:, -1], rtol=2e-3, atol=2e-3)
    _close(dec, jdec)


# ------------------------------------------------------------------ serving
def test_engine_matches_the_jax_engine_on_text_prompts(jx, vl):
    """Neither Engine takes patch embeddings: both serve text-only
    prompts (queue C 1), token for token (2 slots, 3 requests, greedy)."""
    _, want = _serve(jx.Engine, jx.ServeConfig, vl.jcfg, vl.jparams)
    _, got = _serve(Engine, ServeConfig, vl.cfg, vl.params)
    assert got == want
    assert [len(r) for r in got] == [20 - len(p) for p in PROMPTS]


def test_train_launcher_runs_two_reduced_steps(capsys):
    """Two finite steps of the reduced config through the launcher's
    synthetic batches, on two CPU threads (the suite runs test files side
    by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        hist = train_main(["--arch", NAME, "--reduced", "--device", "cpu",
                           "--steps", "2", "--batch", "1", "--seq", "16"])[2]
    finally:
        torch.set_num_threads(threads)
    assert "arch=internvl2-2b" in capsys.readouterr().out
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert reduced_config(registry.get_config(NAME)).num_patches == 16


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    faulthandler.dump_traceback_later(CUDA_TEST_LIMIT_S, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


@pytest.mark.cuda
def test_cuda_prefix_prefill_runs_the_kernel_and_matches_cpu(cuda):
    """A prefill of 16 patches + 100 tokens on the card at reduced_config
    (2 layers): one causal flash launch per layer over all 116 positions,
    the last logits and the caches within 1e-4 of the CPU's (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(registry.get_config(NAME)).replace(num_layers=2)
    model = build_model(cfg)
    cpu = tamed(model.init(torch.Generator().manual_seed(0), device="cpu"),
                init_kinds(model))
    gpu = tree_map(lambda t: t.to(cuda), cpu)
    toks = torch.from_numpy(_tokens(6, s=100, vocab=cfg.vocab_size))
    pe = torch.from_numpy(_patches(6, cfg))
    with torch.no_grad():
        want, wc = model.prefill(cpu, {"tokens": toks, "patch_embeds": pe})
        before = flash_attention_cuda.launches
        got, gc = model.prefill(gpu, {"tokens": toks.to(cuda),
                                      "patch_embeds": pe.to(cuda)})
        torch.cuda.synchronize()
    assert flash_attention_cuda.launches - before == cfg.num_layers
    assert gc[0]["kv"].k.shape[3] == cfg.num_patches + 100
    nv = cfg.vocab_size
    _close(got[..., :nv].cpu(), want[..., :nv].numpy())
    for a, b in zip(tree_leaves(gc), tree_leaves(wc)):
        if b.dtype == torch.int32:
            assert torch.equal(a.cpu(), b)
        else:
            _close(a.cpu(), b.numpy())
