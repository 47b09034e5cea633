"""The port's audio family (`repro_torch.models.whisper`, the cross
sub-block of `models.transformer`, `configs.whisper_small`) against the
JAX package, on the CPU in f32, at the reduced shapes of
tests/test_models_smoke.py (d_model 64, 2 + 2 layers, 24 frames).

The parameters are JAX's (`Model.init` under key 0) carried over with
`params_from_jax`, every normally drawn leaf at 1/16 (TAME; the
reference's stacked init scale, ROADMAP.md queue C 1.6). The encoder
output and the train, prefill and decode logits agree within 1e-4 of the
largest |value|, the loss and every gradient leaf within 1e-5. The
port's encoder and cross-attention run the flash-attention function (on
the CPU its plain version, one softmax over all keys) where the JAX
model sums key blocks with a running max.
"""

import dataclasses
import faulthandler
import types

import numpy as np
import pytest
import torch

from test_torch_families import (
    CUDA_TEST_LIMIT_S, GRAD_TOL, _close, _grow, init_kinds, reduced_kw, tamed)

from repro_torch.configs import registry
from repro_torch.configs.base import PD, tree_leaves, tree_map
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import reduced_config
from repro_torch.models import build_model
from repro_torch.models import whisper as W
from repro_torch.models.params import (
    caches_from_jax, params_from_jax, params_to_numpy)
from repro_torch.serving.engine import Engine, ServeConfig

NAME = "whisper-small"
ENC = dict(encoder_layers=2, encoder_seq=24, max_seq_len=256)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import registry as jregistry
    from repro.models import build_model as jbuild
    from repro.models import whisper as jW
    from repro.serving.engine import Engine as JEngine
    from repro.serving.engine import ServeConfig as JServeConfig

    return types.SimpleNamespace(jax=jax, jnp=jnp, registry=jregistry,
                                 build=jbuild, W=jW, Engine=JEngine,
                                 ServeConfig=JServeConfig)


@pytest.fixture(scope="module")
def wh(jx):
    """The reduced whisper in both packages on JAX's tamed parameters."""
    jcfg = jx.registry.get_config(NAME)
    cfg = registry.get_config(NAME)
    jcfg = jcfg.replace(**reduced_kw(jcfg, **ENC), dtype=jx.jnp.float32)
    cfg = cfg.replace(**reduced_kw(cfg, **ENC), dtype=torch.float32)
    jmodel, model = jx.build(jcfg), build_model(cfg)
    host = tamed(jx.jax.tree.map(np.asarray,
                                 jmodel.init(jx.jax.random.key(0))),
                 init_kinds(model))
    return types.SimpleNamespace(
        jcfg=jcfg, cfg=cfg, jmodel=jmodel, model=model, host=host,
        jparams=jx.jax.tree.map(jx.jnp.asarray, host),
        params=params_from_jax(host, device="cpu"))


def _frames(seed, cfg, b=2):
    return np.random.default_rng(seed).normal(
        size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


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
    assert (cfg.encoder_layers, cfg.encoder_seq) == (12, 1500)
    assert build_model(cfg).num_params() == jx.build(jcfg).num_params()


def test_params_round_trip_is_exact(jx, wh):
    """`params_from_jax` carries the whole enc-dec tree (enc_pos, the
    stacked enc_groups, enc_ln_f, the decoder with its cross sub-blocks
    and pos_emb) and `params_to_numpy` brings it back bit for bit."""
    assert [pd.shape for pd in tree_leaves(
        wh.model.desc(), is_leaf=lambda x: isinstance(x, PD))] == \
        [a.shape for a in jx.jax.tree.leaves(wh.host)]
    assert wh.model.num_params() == wh.jmodel.num_params()
    back = params_to_numpy(wh.params)
    assert jx.jax.tree.structure(back) == jx.jax.tree.structure(wh.host)
    for a, b in zip(jx.jax.tree.leaves(back), jx.jax.tree.leaves(wh.host)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    blk = wh.params["decoder"]["groups"]["blocks"][0]
    assert set(blk) == {"ln1", "mixer", "ln_x", "xattn", "ln2", "ffn"}
    assert wh.params["decoder"]["pos_emb"].shape == (32768, 64)
    assert wh.params["enc_groups"]["attn"]["wq"].shape[0] == 2


# ------------------------------------------------------------------ forward
def test_encode_matches_jax(jx, wh):
    fr = _frames(1, wh.cfg)
    want = jx.jax.jit(lambda p, f: jx.W.encode(p, wh.jcfg, f))(
        wh.jparams, jx.jnp.asarray(fr))
    with torch.no_grad():
        got = W.encode(wh.params, wh.cfg, torch.from_numpy(fr))
    _close(got, want)


def test_encode_names_missing_frames_in_both_packages(jx, wh):
    with pytest.raises(ValueError, match="frames"):
        W.encode(wh.params, wh.cfg, None)
    with pytest.raises((AttributeError, TypeError)):
        jx.W.encode(wh.jparams, wh.jcfg, None)


def test_train_logits_match_jax(jx, wh):
    jb, tb = _batches(jx, tokens=_tokens(2), frames=_frames(2, wh.cfg))
    jl, jh, _, jaux = jx.jax.jit(lambda p, b: wh.jmodel._fwd(
        p, b, "train"))(wh.jparams, jb)
    with torch.no_grad():
        logits, hidden, caches, aux = wh.model._fwd(wh.params, tb, "train")
    assert caches is None and float(aux) == 0.0
    _close(logits, jl)
    _close(hidden, jh)


def test_loss_and_grads_match_jax(jx, wh):
    toks = _tokens(3, s=18)
    jb, tb = _batches(jx, tokens=toks[:, :-1], labels=toks[:, 1:],
                      frames=_frames(3, wh.cfg))
    (jloss, _), jgrads = jx.jax.jit(jx.jax.value_and_grad(
        wh.jmodel.loss_fn, has_aux=True))(wh.jparams, jb)
    params = params_from_jax(wh.host, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = wh.model.loss_fn(params, tb)
    grads = torch.autograd.grad(loss, leaves)
    _close(loss.detach(), jloss, GRAD_TOL)
    want = jx.jax.tree.leaves(jgrads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        _close(g, w, GRAD_TOL)


def test_embed_matches_jax(jx, wh):
    """The audio features are the f32 mean of the encoder output."""
    jb, tb = _batches(jx, tokens=_tokens(4, b=3, s=8),
                      frames=_frames(4, wh.cfg, b=3))
    want = jx.jax.jit(wh.jmodel.embed)(wh.jparams, jb)
    with torch.no_grad():
        got = wh.model.embed(wh.params, tb)
    assert got.shape == (3, wh.cfg.d_model) and got.dtype == torch.float32
    _close(got, want)


def test_prefill_and_decode_match_jax(jx, wh):
    """Prefill of 12 tokens (last logits, the self and cross caches), then
    4 decode steps: the port decodes from JAX's caches carried over with
    `caches_from_jax` (its xkv caches included) and never writes xkv."""
    s = 12
    toks = _tokens(5, s=s + 4)
    fr = _frames(5, wh.cfg)
    jb, tb = _batches(jx, tokens=toks[:, :s], frames=fr)
    jlast, jcaches = jx.jax.jit(wh.jmodel.prefill)(wh.jparams, jb)
    with torch.no_grad():
        last, caches = wh.model.prefill(wh.params, tb)
    _close(last, jlast)
    assert [sorted(c) for c in caches] == [["kv", "xkv"]]
    assert caches[0]["xkv"].k.shape == (2, 2, 2, wh.cfg.encoder_seq, 16)
    for got, want in zip(tree_leaves(caches), jx.jax.tree.leaves(jcaches)):
        if want.dtype == np.int32:
            assert np.array_equal(got.numpy(), np.asarray(want))
        else:
            _close(got, want)
    jc = _grow(jx, jcaches, s)
    tc = caches_from_jax(jx.jax.tree.map(np.asarray, jc), device="cpu")
    xkv = [t.clone() for t in tc[0]["xkv"]]
    jdec = jx.jax.jit(wh.jmodel.decode_step)
    for t in range(4):
        step = toks[:, s + t:s + t + 1]
        jl, jc = jdec(wh.jparams, {"tokens": jx.jnp.asarray(step),
                                   "caches": jc,
                                   "index": jx.jnp.asarray(s + t,
                                                           jx.jnp.int32)})
        with torch.no_grad():
            tl, tc = wh.model.decode_step(wh.params, {
                "tokens": torch.from_numpy(step), "caches": tc,
                "index": s + t})
        _close(tl, jl)
    assert all(torch.equal(a, b) for a, b in zip(tc[0]["xkv"], xkv))
    for got, want in zip(tree_leaves(tc), jx.jax.tree.leaves(jc)):
        if want.dtype == np.int32:
            assert np.array_equal(got.numpy(), np.asarray(want))
        else:
            _close(got, want)


def _consistency(fwd, prefill, decode, toks, s):
    """tests/test_models_smoke.py's check: (decode logits at position s
    after a prefill of s tokens, the last logits of a forward over s+1)."""
    full = fwd(toks)
    caches = prefill(toks[:, :s])
    return decode(toks[:, s:s + 1], caches, s), full[:, -1]


def test_prefill_decode_consistency_in_both_packages(jx, wh):
    s = 12
    toks = _tokens(6, s=s + 1)
    fr = _frames(6, wh.cfg)
    jnp = jx.jnp

    def jdecode(t, caches, index):
        return jx.jax.jit(wh.jmodel.decode_step)(wh.jparams, {
            "tokens": jnp.asarray(t), "caches": _grow(jx, caches, s),
            "index": jnp.asarray(index, jnp.int32)})[0][:, 0]

    jdec, jfull = _consistency(
        lambda t: wh.jmodel._fwd(wh.jparams, {
            "tokens": jnp.asarray(t), "frames": jnp.asarray(fr)},
            "train")[0],
        lambda t: wh.jmodel.prefill(wh.jparams, {
            "tokens": jnp.asarray(t), "frames": jnp.asarray(fr)})[1],
        jdecode, toks, s)
    np.testing.assert_allclose(np.asarray(jdec), np.asarray(jfull),
                               rtol=2e-3, atol=2e-3)

    def tdecode(t, caches, index):
        pool = wh.model.init_caches(2, s + 8, device="cpu")
        for pc, one in zip(pool, caches):
            pc["kv"].k[..., :s, :] = one["kv"].k
            pc["kv"].v[..., :s, :] = one["kv"].v
            pc["kv"].pos[..., :s] = one["kv"].pos
            assert torch.equal(pc["xkv"].pos, one["xkv"].pos)
            pc["xkv"] = one["xkv"]
        return wh.model.decode_step(wh.params, {
            "tokens": torch.from_numpy(t), "caches": pool,
            "index": index})[0][:, 0]

    ft = torch.from_numpy(fr)
    with torch.no_grad():
        tdec, tfull = _consistency(
            lambda t: wh.model._fwd(wh.params, {
                "tokens": torch.from_numpy(t), "frames": ft}, "train")[0],
            lambda t: wh.model.prefill(wh.params, {
                "tokens": torch.from_numpy(t), "frames": ft})[1],
            tdecode, toks, s)
    torch.testing.assert_close(tdec, tfull, rtol=2e-3, atol=2e-3)
    _close(tdec, jdec)


def test_decoder_self_attention_takes_rope_and_learned_positions(wh):
    """The reference's quirk, reproduced: the decoder's self-attention
    rotates q and k (rope) on top of the learned `pos_emb` added to the
    embeddings. Zeroing pos_emb changes the logits; so does moving the
    positions the rotation reads with pos_emb held fixed."""
    toks = torch.from_numpy(_tokens(7))
    fr = torch.from_numpy(_frames(7, wh.cfg))
    batch = {"tokens": toks, "frames": fr}
    with torch.no_grad():
        base = wh.model._fwd(wh.params, batch, "train")[0]
        no_pos = dict(wh.params, decoder=dict(
            wh.params["decoder"],
            pos_emb=torch.zeros_like(wh.params["decoder"]["pos_emb"])))
        assert not torch.allclose(
            wh.model._fwd(no_pos, batch, "train")[0], base)
        cfg = wh.cfg.replace(rope_theta=1e9)
        assert not torch.allclose(
            build_model(cfg)._fwd(wh.params, batch, "train")[0], base)


# ------------------------------------------------------------------ serving
def test_engine_cannot_serve_audio_in_either_package(jx, wh):
    """The reference's Engine prefills tokens only, so whisper's encoder
    gets no frames and fails (queue C 1); the port's fails there too,
    naming the frames."""
    jeng = jx.Engine(wh.jcfg, jx.ServeConfig(max_slots=2, max_len=20,
                                             eos_id=-1), wh.jparams)
    jeng.submit(np.asarray([5, 17, 42]))
    with pytest.raises((AttributeError, TypeError)):
        jeng.run()
    eng = Engine(wh.cfg, ServeConfig(max_slots=2, max_len=20, eos_id=-1),
                 wh.params)
    assert eng.caches[0]["xkv"].k.shape[3] == wh.cfg.encoder_seq
    eng.submit(np.asarray([5, 17, 42]))
    with pytest.raises(ValueError, match="frames"):
        eng.run()


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
    assert "arch=whisper-small" in capsys.readouterr().out
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    cfg = reduced_config(registry.get_config(NAME))
    assert (cfg.encoder_layers, cfg.encoder_seq) == (4, 128)


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    faulthandler.dump_traceback_later(CUDA_TEST_LIMIT_S, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


def _card_and_cpu(dev):
    cfg = reduced_config(registry.get_config(NAME)).replace(
        num_layers=2, encoder_layers=2, encoder_seq=150)
    model = build_model(cfg)
    cpu = tamed(model.init(torch.Generator().manual_seed(0), device="cpu"),
                init_kinds(model))
    return cfg, model, cpu, tree_map(lambda t: t.to(dev), cpu)


@pytest.mark.cuda
def test_cuda_encoder_and_cross_attention_run_the_kernel(cuda):
    """A prefill on the card launches the flash kernel once per encoder
    layer (non-causal, s = sk = 150), once per decoder self-attention
    (causal) and once per cross sub-block (s = 40 against sk = 150), and
    matches the CPU within 1e-4 (TF32 off). Decode launches none."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, model, cpu, gpu = _card_and_cpu(cuda)
    toks = torch.from_numpy(_tokens(8, b=2, s=40, vocab=cfg.vocab_size))
    fr = torch.from_numpy(_frames(8, cfg))
    with torch.no_grad():
        want, wc = model.prefill(cpu, {"tokens": toks, "frames": fr})
        before = flash_attention_cuda.launches
        got, gc = model.prefill(gpu, {"tokens": toks.to(cuda),
                                      "frames": fr.to(cuda)})
        torch.cuda.synchronize()
        assert flash_attention_cuda.launches - before == \
            cfg.encoder_layers + 2 * cfg.num_layers
        nv = cfg.vocab_size
        _close(got[..., :nv].cpu(), want[..., :nv].numpy())
        for a, b in zip(tree_leaves(gc), tree_leaves(wc)):
            if b.dtype == torch.int32:
                assert torch.equal(a.cpu(), b)
            else:
                _close(a.cpu(), b.numpy())
        pool = model.init_caches(2, 48, device=cuda)
        for pc, one in zip(pool, gc):
            pc["kv"].k[..., :40, :] = one["kv"].k
            pc["kv"].v[..., :40, :] = one["kv"].v
            pc["kv"].pos[..., :40] = one["kv"].pos
            pc["xkv"] = one["xkv"]
        before = flash_attention_cuda.launches
        model.decode_step(gpu, {"tokens": toks[:, :1].to(cuda),
                                "caches": pool, "index": 40})
        assert flash_attention_cuda.launches == before


@pytest.mark.cuda
def test_cuda_gradients_take_the_blockwise_path(cuda):
    """Training differentiates the blockwise attention: a loss with grad
    on launches no flash kernel, encoder and cross-attention included."""
    cfg, model, _, gpu = _card_and_cpu(cuda)
    toks = torch.from_numpy(_tokens(9, b=1, s=33, vocab=cfg.vocab_size))
    batch = {"tokens": toks[:, :-1].to(cuda), "labels": toks[:, 1:].to(cuda),
             "frames": torch.from_numpy(_frames(9, cfg, b=1)).to(cuda)}
    leaves = tree_leaves(gpu)
    for p in leaves:
        p.requires_grad_(True)
    before = flash_attention_cuda.launches
    loss, _ = model.loss_fn(gpu, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert flash_attention_cuda.launches == before
    assert all(bool(torch.isfinite(g).all()) for g in grads)
