"""The port's LM training path (`Model.loss_fn`, `training/optimizer.py`,
`training/compression.py`, `data/pipeline.py`, `training/trainer.py`,
`launch/train.py`) and the API leftovers (`pooled_embeddings`,
`k_invariance_correlation`, `make_token_batch`) against the JAX package,
on the CPU in f32.

The JAX parameters and optimizer state are carried over
(`models.params.params_from_jax`, `opt_state_from_jax`) and token batches
are drawn once with numpy, so both packages see the same inputs. The loss
and its gradients agree within 1e-5 of the largest |value| of each leaf
(the f32 sums run in another order), one AdamW update given the same
gradients within 1e-6, a 6-step training run's losses within 1e-4. AdamW
amplifies last-bit gradient differences where a gradient is near zero,
so parity is held on those pieces, not on parameters after many steps.

The reference `Trainer` fails under jax 0.9 on its explicit mesh axes
(ROADMAP.md queue C 1.3), so the JAX side here is the unsharded
`jax.value_and_grad(Model.loss_fn)` with `adamw_update`.
"""

import faulthandler
import functools
import os
import pickle
import subprocess
import sys
import textwrap
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs import registry as jregistry
    from repro.core.analysis import k_invariance_correlation as jkcorr
    from repro.launch.train import reduced_config as jreduced
    from repro.models import build_model as jbuild
    from repro.models.transformer import pooled_embeddings as jpooled
    from repro.training import compression as jcomp
    from repro.training import optimizer as jopt
except ImportError:  # a card's host without JAX: only the cuda tests run
    jax = None

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry
from repro_torch.configs.base import (
    ModelConfig, tree_leaves, tree_map, tree_unflatten)
from repro_torch.core.analysis import k_invariance_correlation
from repro_torch.data import make_token_batch
from repro_torch.data.pipeline import ShardedPrefetchLoader, host_slice
from repro_torch.distributed.grid_step import zero_moments
from repro_torch.distributed.sharding import (
    DeviceGrid, ShardGroup, Sharded, is_spec, rules_for)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.launch import train as tlaunch
from repro_torch.launch.train import reduced_config
from repro_torch.models import build_model
from repro_torch.models.params import (
    opt_state_from_jax, params_from_jax, params_to_numpy)
from repro_torch.models.transformer import pooled_embeddings
from repro_torch.training import compression as tcomp
from repro_torch.training import optimizer as topt
from repro_torch.training.trainer import Trainer, TrainerConfig

CUDA_TEST_LIMIT_S = 300  # a hung kernel fails its test instead of the run
REPO = Path(__file__).resolve().parents[1]

# the SMALL config of tests/test_substrate.py, in both packages
_SMALL = dict(name="tiny", family="dense", num_layers=2, d_model=32,
              num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128,
              head_dim=8, tp_pad_heads=4, vocab_pad=32)
JSMALL = None if jax is None else JModelConfig(
    **_SMALL, dtype=jnp.float32, mlstm_chunk=8, mamba_chunk=8)
SMALL = ModelConfig(**_SMALL, dtype=torch.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaf_close(got, want, rel):
    """Every leaf within `rel` of its largest |value| (or of 1e-30)."""
    got_l, want_l = tree_leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(
            g, w, rtol=0, atol=rel * max(float(np.abs(w).max()), 1e-30))


@functools.lru_cache(maxsize=None)
def _jvg():
    """jit(value_and_grad(loss_fn)) of JAX's SMALL model, compiled once."""
    return jax.jit(jax.value_and_grad(jbuild(JSMALL).loss_fn, has_aux=True))


@functools.lru_cache(maxsize=None)
def _jupdate(cfg):
    """jit(adamw_update) for one AdamWConfig, compiled once."""
    return jax.jit(functools.partial(jopt.adamw_update, cfg))


def _tokens(seed, b=4, s=16, vocab=128):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.fixture(scope="module")
def small():
    """JAX's SMALL model and params, the port's carried over."""
    jmodel = jbuild(JSMALL)
    jparams = jmodel.init(jax.random.key(0))
    return types.SimpleNamespace(
        jmodel=jmodel, jparams=jparams, model=build_model(SMALL),
        params=lambda: params_from_jax(_np(jparams), device="cpu"))


def _port_loss_and_grads(model, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = model.loss_fn(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss, metrics, tree_map(lambda _: next(it), params)


# ------------------------------------------------------ loss and gradients
@pytest.mark.parametrize("remat", ["block", "none", "full", "dots"])
def test_loss_and_grads_match_jax(small, remat):
    """loss_fn and its gradients against jax.value_and_grad(loss_fn), for
    every remat (recompute changes no value); no flash launch (a call that
    needs a gradient takes the blockwise path)."""
    batch = _tokens(1)
    (jloss, jm), jgrads = _jvg()(small.jparams,
                                 jax.tree.map(jnp.asarray, batch))
    before = flash_attention_cuda.launches
    model = build_model(SMALL.replace(remat=remat))
    loss, m, grads = _port_loss_and_grads(model, small.params(), batch)
    assert flash_attention_cuda.launches == before
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), rtol=1e-5)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    _leaf_close(grads, jgrads, 1e-5)


def test_remat_recomputes_in_backward_only_and_rejects_unknown():
    """An unknown remat kind raises where remat applies (train mode, grad
    on); without grad it is not consulted. (Every known kind gives JAX's
    gradients: test_loss_and_grads_match_jax.)"""
    model = build_model(SMALL.replace(remat="bogus"))
    params = params_from_jax(_np(jbuild(JSMALL).init(jax.random.key(1))),
                             device="cpu")
    batch = _tokens(2)
    with pytest.raises(ValueError, match="remat"):
        _port_loss_and_grads(model, params, batch)
    with torch.no_grad():   # no grad: remat is not consulted
        loss, _ = model.loss_fn(params, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    assert np.isfinite(float(loss))


def test_unbind_gives_one_gradient_per_stacked_leaf(small):
    """The stacked group weights get one gradient tensor each, of the
    stacked shape, with every group's slice filled."""
    _, _, grads = _port_loss_and_grads(small.model, small.params(),
                                       _tokens(3))
    wq = grads["groups"]["blocks"][0]["mixer"]["wq"]
    assert wq.shape == (2, 32, 32)
    assert all(bool(wq[g].abs().sum() > 0) for g in range(2))


# -------------------------------------------------------------- optimizer
def test_adamw_update_given_jax_grads_matches(small):
    """Two JAX updates give a state with non-trivial moments; the third
    update, from the same params, state and gradients, in both packages:
    params, mu, nu within 1e-6 of max |ref| of each leaf, count, lr and
    grad_norm alike. Weight decay only on >= 2-D leaves, clipping on."""
    cfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                           clip_norm=0.5)
    jparams, jstate = small.jparams, jopt.adamw_init(small.jparams)
    for seed in (4, 5):
        _, g = _jvg()(jparams, jax.tree.map(jnp.asarray, _tokens(seed)))
        jparams, jstate, _ = _jupdate(cfg)(g, jstate, jparams)
    _, jgrads = _jvg()(jparams, jax.tree.map(jnp.asarray, _tokens(6)))
    params = params_from_jax(_np(jparams), device="cpu")
    state = opt_state_from_jax(_np(jstate), device="cpu")
    grads = params_from_jax(_np(jgrads), device="cpu")
    nparams, nstate, om = topt.adamw_update(
        topt.AdamWConfig(**vars(cfg)), grads, state, params)
    want_p, want_s, want_m = _jupdate(cfg)(jgrads, jstate, jparams)
    assert nparams is params
    _leaf_close(nparams, want_p, 1e-6)
    _leaf_close(nstate.mu, want_s.mu, 1e-6)
    _leaf_close(nstate.nu, want_s.nu, 1e-6)
    assert int(nstate.count) == int(want_s.count) == 3
    np.testing.assert_allclose(float(om["lr"]), float(want_m["lr"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(om["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=1e-6)


def test_cosine_schedule_matches_jax():
    cfg = jopt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                           min_lr_frac=0.1)
    ours = topt.cosine_schedule(topt.AdamWConfig(**vars(cfg)))
    theirs = jopt.cosine_schedule(cfg)
    for step in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        np.testing.assert_allclose(
            float(ours(torch.tensor(step, dtype=torch.int32))),
            float(theirs(jnp.asarray(step))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("max_norm", [1.0, 1e9])
def test_clipping_matches_jax(max_norm):
    rng = np.random.default_rng(7)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32) * 10,
            "b": [rng.normal(size=5).astype(np.float32)]}
    # the port scales in place: hand it copies
    got, gnorm = topt.clip_by_global_norm(
        tree_map(lambda a: torch.from_numpy(a.copy()), tree), max_norm)
    want, wnorm = jopt.clip_by_global_norm(
        jax.tree.map(jnp.asarray, tree), max_norm)
    np.testing.assert_allclose(float(gnorm), float(wnorm), rtol=1e-6)
    _leaf_close(got, want, 1e-6)
    np.testing.assert_allclose(
        float(topt.global_norm(got)), min(max_norm, float(wnorm)),
        rtol=1e-5)


def test_adamw_converges_on_a_quadratic():
    """The reference's own optimizer test, on the port."""
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = topt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                           total_steps=200, clip_norm=100.0)
    state = topt.adamw_init(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = topt.adamw_update(opt, grads, state, params)
    assert float(params["w"].abs().max()) < 0.05


# ------------------------------------------------------------ compression
def test_topk_error_feedback_matches_jax():
    """Tie-free input: the same sparse gradients and error state, step
    after step."""
    rng = np.random.default_rng(8)
    g = {"w": rng.permutation(200).astype(np.float32).reshape(10, 20) / 7,
         "b": rng.permutation(30).astype(np.float32) / 3}
    err_t = tcomp.init_error(tree_map(torch.from_numpy, g))
    err_j = jcomp.init_error(jax.tree.map(jnp.asarray, g))
    for _ in range(4):
        st, err_t = tcomp.topk_error_feedback(tree_map(torch.from_numpy, g),
                                              err_t, frac=0.05)
        sj, err_j = jcomp.topk_error_feedback(jax.tree.map(jnp.asarray, g),
                                              err_j, frac=0.05)
        _leaf_close(st, sj, 1e-7)
        _leaf_close(err_t, err_j, 1e-7)
    sent, _ = tcomp.compress_grads(tree_map(torch.from_numpy, g), err_t,
                                   "topk_ef", frac=0.05)
    assert int((sent["w"] != 0).sum()) == 10
    same, _ = tcomp.compress_grads(g, None, "none")
    assert same is g
    with pytest.raises(ValueError):
        tcomp.compress_grads(g, None, "int4")


def test_int8_quantization_and_pod_sum():
    """The quantization error is under 1.5 scales (the reference's test);
    the pod sum of two identical trees with a shared generator is within
    a scale of their sum, the same tree on every pod; noise or a generator
    is required."""
    x = torch.randn(1024, generator=torch.Generator().manual_seed(0))
    noise = torch.rand(1024, generator=torch.Generator().manual_seed(1)) - .5
    q, scale = tcomp.quantize_int8(x, noise)
    assert q.dtype == torch.int8
    assert float((q.float() * scale - x).abs().max()) < float(scale) * 1.5
    group = ShardGroup(("cpu",) * 3)
    trees = [{"w": x.clone()} for _ in range(3)]
    out = tcomp.int8_allreduce_pod(trees, group,
                                   generator=torch.Generator().manual_seed(2))
    assert len(out) == 3 and all(o["w"] is out[0]["w"] for o in out)
    assert float((out[0]["w"] - x).abs().max()) < float(scale) * 1.5
    with pytest.raises(ValueError, match="noise"):
        tcomp.int8_allreduce_pod(trees, group)
    with pytest.raises(ValueError, match="pods"):
        tcomp.int8_allreduce_pod(trees[:2], group, noise=[{}, {}])


# --------------------------------------------------------- data pipeline
def test_make_token_batch_contract():
    toks, labels = make_token_batch(torch.Generator().manual_seed(0), 3, 9,
                                    50)
    assert toks.shape == labels.shape == (3, 9)
    assert toks.dtype == labels.dtype == torch.int32
    assert torch.equal(toks[:, 1:], labels[:, :-1])
    assert int(toks.min()) >= 0 and int(toks.max()) < 50
    again, _ = make_token_batch(torch.Generator().manual_seed(0), 3, 9, 50)
    assert torch.equal(toks, again)


def test_prefetch_loader_order_errors_and_close():
    def batch_fn(step):
        if step == 5:
            raise KeyError("no batch 5")
        return {"tokens": np.full((2, 3), step, np.int32)}

    loader = ShardedPrefetchLoader(batch_fn, "cpu", start_step=2)
    for want in (2, 3, 4):
        step, batch = next(loader)
        assert step == want and int(batch["tokens"][0, 0]) == want
        assert isinstance(batch["tokens"], torch.Tensor)
    with pytest.raises(KeyError):
        next(loader)
    loader.close()
    assert not loader._thread.is_alive()
    slow = ShardedPrefetchLoader(lambda s: {"x": torch.zeros(1)}, "cpu")
    slow.close()
    assert not slow._thread.is_alive()
    assert host_slice(np.arange(8), 1, 4).tolist() == [2, 3]
    with pytest.raises(ValueError, match="split"):
        host_slice(np.arange(6), 0, 4)


# ---------------------------------------------------------------- trainer
def _batch_fn(step):
    return _tokens(100 + step)


def _jax_loop(cfg, jparams, steps, start=0, jstate=None):
    jstate = jstate if jstate is not None else jopt.adamw_init(jparams)
    losses = []
    for s in range(start, steps):
        (loss, _), grads = _jvg()(jparams,
                                  jax.tree.map(jnp.asarray, _batch_fn(s)))
        jparams, jstate, _ = _jupdate(cfg)(grads, jstate, jparams)
        losses.append(float(loss))
    return jparams, jstate, losses


def _tcfg(tmp_path, **kw):
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=6)
    return TrainerConfig(steps=kw.pop("steps", 6), log_every=1,
                         ckpt_every=3, ckpt_dir=str(tmp_path),
                         opt=topt.AdamWConfig(**opt), **kw)


def test_trainer_losses_match_an_unsharded_jax_loop(small, tmp_path):
    """6 Trainer steps (prefetch, guard, async checkpoints at 3 and 6)
    against value_and_grad + adamw_update in JAX: every loss within
    1e-4."""
    tr = Trainer(SMALL, _tcfg(tmp_path), device="cpu")
    _, _, hist = tr.fit(small.params(), topt.adamw_init(small.params()),
                        _batch_fn)
    _, _, want = _jax_loop(jopt.AdamWConfig(lr=1e-3, warmup_steps=2,
                                            total_steps=6),
                           small.jparams, 6)
    assert [h["step"] for h in hist] == list(range(6))
    np.testing.assert_allclose([h["loss"] for h in hist], want, rtol=0,
                               atol=1e-4)
    assert Checkpointer(tmp_path).all_steps() == [3, 6]


def test_trainer_grad_accumulation_matches_one_batch(small, tmp_path):
    """grad_accum=2 over a batch of 4: the loss is the mean of the two
    micro-batch losses, and the update lands within 1e-5 of one batch's
    (the loss is a mean over tokens, so both give the same gradient)."""
    one = Trainer(SMALL, _tcfg(tmp_path / "a", steps=1), device="cpu")
    two = Trainer(SMALL, _tcfg(tmp_path / "b", steps=1, grad_accum=2),
                  device="cpu")
    p1, _, h1 = one.fit(small.params(), topt.adamw_init(small.params()),
                        _batch_fn)
    p2, _, h2 = two.fit(small.params(), topt.adamw_init(small.params()),
                        _batch_fn)
    np.testing.assert_allclose(h2[0]["loss"], h1[0]["loss"], rtol=1e-6)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def test_trainer_end_to_end_with_restart(small, tmp_path):
    """The reference test's drill: 6 steps with ckpt_every=3, then a fresh
    Trainer from another seed restores step 6 with every leaf
    bit-identical to the run that wrote it."""
    tcfg = _tcfg(tmp_path)
    tr = Trainer(SMALL, tcfg, device="cpu")
    params, opt_state = tr.init_state(0)
    params, opt_state, hist = tr.fit(params, opt_state, _batch_fn)
    assert len(hist) == 6 and np.isfinite(hist[-1]["loss"])
    tr2 = Trainer(SMALL, tcfg, device="cpu")
    p2, o2 = tr2.init_state(1)
    p2, o2, start = tr2.maybe_restore(p2, o2)
    assert start == 6 and int(o2.count) == 6
    for a, b in zip(tree_leaves((p2, o2)), tree_leaves((params, opt_state))):
        assert torch.equal(a, b)


def _one_clean_step(small, tmp_path):
    tr = Trainer(SMALL, _tcfg(tmp_path / "clean", steps=1), device="cpu")
    params, opt_state, _ = tr.fit(small.params(),
                                  topt.adamw_init(small.params()), _batch_fn)
    return params, opt_state


def test_trainer_retries_only_the_gradient_phase(small, tmp_path):
    """A fault in the loss on the first attempt is retried, and the step
    ends exactly where one clean step does: the same parameters and
    moments, count 1 (the update ran once)."""
    want_p, want_o = _one_clean_step(small, tmp_path)
    tr = Trainer(SMALL, _tcfg(tmp_path / "flaky", steps=1), device="cpu")
    calls = []

    def flaky(params, batch):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected fault in the loss")
        return small.model.loss_fn(params, batch)

    tr.model = types.SimpleNamespace(loss_fn=flaky)
    params, opt_state, _ = tr.fit(small.params(),
                                  topt.adamw_init(small.params()), _batch_fn)
    assert len(calls) == 2 and int(opt_state.count) == 1
    for a, b in zip(tree_leaves((params, opt_state)),
                    tree_leaves((want_p, want_o))):
        assert torch.equal(a, b)


def test_trainer_never_reruns_the_in_place_update(small, tmp_path,
                                                  monkeypatch):
    """A fault inside the update, or an overrun of the step once the update
    has run, raises instead of retrying: a retry would apply the update a
    second time to parameters and moments it already changed."""
    import repro_torch.training.trainer as trainer_mod

    real = trainer_mod.adamw_update
    calls = []

    def faulty(*args):
        calls.append(1)
        raise RuntimeError("injected fault in the update")

    monkeypatch.setattr(trainer_mod, "adamw_update", faulty)
    tr = Trainer(SMALL, _tcfg(tmp_path / "a", steps=1), device="cpu")
    with pytest.raises(RuntimeError, match="failed part way"):
        tr.fit(small.params(), topt.adamw_init(small.params()), _batch_fn)
    assert len(calls) == 1

    clock = {"skew": 0.0}

    def slow(*args):
        calls.append(1)
        clock["skew"] += 100.0      # the update "takes" 100 s
        return real(*args)

    monkeypatch.setattr(trainer_mod, "adamw_update", slow)
    monkeypatch.setattr(trainer_mod, "time", types.SimpleNamespace(
        time=lambda: time.time() + clock["skew"]))
    tr = Trainer(SMALL, _tcfg(tmp_path / "b", steps=1, step_deadline_s=50.0),
                 device="cpu")
    params = small.params()
    state = topt.adamw_init(params)
    with pytest.raises(RuntimeError, match="overran its deadline"):
        tr.fit(params, state, _batch_fn)
    assert len(calls) == 2
    want_p, want_o = _one_clean_step(small, tmp_path)
    for a, b in zip(tree_leaves((params, state.mu, state.nu)),
                    tree_leaves((want_p, want_o.mu, want_o.nu))):
        assert torch.equal(a, b)     # updated in place once, not twice


def test_checkpoints_cross_packages_both_ways(small, tmp_path):
    """A JAX-written (params, AdamState) checkpoint at step 3 resumes in
    the port's Trainer at its step, and steps 3-5 track the JAX loop's
    within 1e-4; the port's checkpoint at 6 restores in JAX bit for
    bit."""
    cfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    jparams, jstate, want = _jax_loop(cfg, small.jparams, 3)
    JCheckpointer(tmp_path).save(3, (jparams, jstate))
    tr = Trainer(SMALL, _tcfg(tmp_path), device="cpu")
    params, opt_state = tr.init_state(7)
    params, opt_state, start = tr.maybe_restore(params, opt_state)
    assert start == 3
    for a, b in zip(tree_leaves((params, opt_state)),
                    jax.tree.leaves((jparams, jstate))):
        assert np.array_equal(a.numpy(), np.asarray(b))
    params, opt_state, hist = tr.fit(params, opt_state, _batch_fn,
                                     start_step=start)
    _, _, more = _jax_loop(cfg, jparams, 6, start=3, jstate=jstate)
    np.testing.assert_allclose([h["loss"] for h in hist], more, rtol=0,
                               atol=1e-4)
    back, step = JCheckpointer(tmp_path).restore((jparams, jstate))
    assert step == 6
    for a, b in zip(jax.tree.leaves(back), tree_leaves((params, opt_state))):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_opt_state_round_trip_from_jax(small):
    jstate = jopt.adamw_init(small.jparams)
    state = opt_state_from_jax(_np(jstate), device="cpu")
    assert isinstance(state, topt.AdamState)
    assert state.count.dtype == torch.int32 and state.count.ndim == 0
    for a, b in zip(tree_leaves(state), jax.tree.leaves(jstate)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert [a.shape for a in tree_leaves(params_to_numpy(state.mu))] == \
        [a.shape for a in jax.tree.leaves(jstate.mu)]


def test_trainer_and_launcher_need_a_card_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(SMALL, TrainerConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedPrefetchLoader(_batch_fn)


def test_train_launcher_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--device", "cpu", "--arch", "qwen3-1.7b", "--reduced",
            "--steps", "2", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    _, _, hist = tlaunch.main(argv)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    _, _, more = tlaunch.main(argv[:6] + ["3"] + argv[7:])
    out = capsys.readouterr().out
    assert "[restore] resumed from step 2" in out and "device=cpu" in out
    assert [h["step"] for h in more] == [2]


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b",
                                  "xlstm-1.3b", "jamba-v0.1-52b"])
def test_train_launcher_runs_each_family_on_the_cpu(arch, capsys):
    """The MoE, SSM and hybrid archs at their reduced config: two finite
    steps (the MoE aux loss inside them), the line naming the device. On
    two CPU threads: the suite runs test files side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        _, _, hist = tlaunch.main(["--device", "cpu", "--arch", arch,
                                   "--reduced", "--steps", "2", "--batch",
                                   "1", "--seq", "8"])
    finally:
        torch.set_num_threads(threads)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    out = capsys.readouterr().out
    assert f"arch={arch} " in out and "device=cpu" in out


# ------------------------------------------------------- API leftovers
def test_pooled_embeddings_match_jax():
    """reduced qwen3-1.7b at 2 layers, f32: within 1e-4 of max |value|."""
    jcfg = jreduced(jregistry.get_config("qwen3-1.7b")).replace(num_layers=2)
    cfg = reduced_config(registry.get_config("qwen3-1.7b")).replace(
        num_layers=2)
    jparams = jbuild(jcfg).init(jax.random.key(0))
    params = params_from_jax(_np(jparams), device="cpu")
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                             (3, 11)).astype(np.int32)
    want = np.asarray(jpooled(jparams, jcfg, jnp.asarray(toks)))
    with torch.no_grad():
        got = pooled_embeddings(params, cfg, torch.from_numpy(toks))
    assert got.shape == (3, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


def test_k_invariance_correlation_matches_jax():
    rng = np.random.default_rng(12)
    a = rng.normal(size=(40, 40)).astype(np.float32)
    b = (a + 0.3 * rng.normal(size=(40, 40))).astype(np.float32)
    got = k_invariance_correlation(torch.from_numpy(a), torch.from_numpy(b))
    want = jkcorr(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)
    assert float(k_invariance_correlation(torch.from_numpy(a),
                                          torch.from_numpy(a))) == \
        pytest.approx(1.0, abs=1e-6)


# ---------------------------------------------------------- on the card
# ------------------------------------------------- the Trainer on a grid
# the tiny MoE of tests/test_distributed.py at capacity factor 0.5 (tokens
# drop) and a group size that the batch's rows do not align with
MOE_SMALL = ModelConfig(**dict(_SMALL, family="moe"), num_experts=4,
                        capacity_factor=0.5, moe_group_size=48,
                        dtype=torch.float32)


def _grid(shape, device="cpu"):
    return DeviceGrid((device,) * (shape[0] * shape[1]), shape)


def _run(cfg, tmp_path, batch_fn=_batch_fn, strategy=None, **kw):
    tr = Trainer(cfg, _tcfg(tmp_path, steps=3, strategy=strategy), **kw)
    params, opt_state = tr.init_state(0)
    return tr, tr.fit(params, opt_state, batch_fn)


@pytest.mark.parametrize("strategy", ["tp_dp", "fsdp"])
@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (8, 1), (1, 1)])
@pytest.mark.parametrize("cfg", [SMALL, MOE_SMALL], ids=["dense", "moe"])
def test_grid_trainer_matches_the_single_device_trainer(cfg, shape,
                                                        strategy, tmp_path):
    """`Trainer(mesh=grid)` stores params and moments as blocks of
    tree_named(param_spec(rules_for(strategy))) and splits the batch of 4
    over the data rows that divide it (else runs it whole): 3 steps'
    losses and the first grad norm within 1e-5 (relative) of the single-device
    Trainer's, the MoE with drops included (its groups and aux loss those
    of the whole batch, as GSPMD keeps them); the later grad norms and the
    final params within 1e-4 (AdamW amplifies last-bit differences of the
    block-wise sums, as above)."""
    _, (p1, _, h1) = _run(cfg, tmp_path / "one", device="cpu")
    tr, (p2, o2, h2) = _run(cfg, tmp_path / "grid", mesh=_grid(shape),
                            strategy=strategy)
    np.testing.assert_allclose([h["loss"] for h in h2],
                               [h["loss"] for h in h1], rtol=1e-5)
    np.testing.assert_allclose(h2[0]["grad_norm"], h1[0]["grad_norm"],
                               rtol=1e-5)
    np.testing.assert_allclose([h["grad_norm"] for h in h2],
                               [h["grad_norm"] for h in h1], rtol=1e-4)
    assert all(isinstance(s, Sharded) for s in tree_leaves(p2))
    want = tr.model.param_spec(rules_for(cfg, strategy, _grid(shape)))
    assert [s.placement.spec for s in tree_leaves(p2)] == \
        tree_leaves(want, is_leaf=is_spec)
    for a, b in zip(tree_leaves(p2), tree_leaves(p1)):
        np.testing.assert_allclose(a.gather().numpy(), b.numpy(), rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
    assert int(o2.count) == 3


# the reference's Trainer on Auto meshes of 8 host devices (its Explicit
# default fails under jax 0.9, ROADMAP.md queue C 1.3), in one subprocess:
# JAX fixes its device count at first use
_JAX_TRAINERS = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh
from repro.configs.base import ModelConfig
from repro.models import build_model
from repro.training.optimizer import AdamWConfig, adamw_init
from repro.training.trainer import Trainer, TrainerConfig

configs, runs, batches, path = pickle.loads(bytes.fromhex(sys.argv[1]))
leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
out = {}
for name, kw in configs.items():
    cfg = ModelConfig(**kw, dtype=jnp.float32)
    host = jax.tree.map(np.asarray, build_model(cfg).init(jax.random.key(0)))
    out[name, "params"] = leaves(host)
    for shape, strategy, rows in runs[name]:
        mesh = Mesh(np.asarray(jax.devices()).reshape(shape),
                    ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        tr = Trainer(cfg, TrainerConfig(
            steps=3, log_every=1, strategy=strategy, opt=AdamWConfig(
                lr=1e-3, warmup_steps=2, total_steps=6)), mesh)
        params, _, hist = tr.fit(
            jax.device_put(host, tr.psharding),
            jax.device_put(adamw_init(host), tr._osharding),
            lambda s: {k: v[:rows] for k, v in batches[s].items()})
        out[name, shape, strategy, rows] = (
            leaves(params), [(h["loss"], h["grad_norm"]) for h in hist])
with open(path, "wb") as f:
    pickle.dump(out, f)
"""
JAX_GRIDS = [(4, 2), (2, 4), (8, 1)]
_MOE_KW = dict(_SMALL, family="moe", num_experts=4, capacity_factor=0.5,
               moe_group_size=48)


@pytest.fixture(scope="module")
def jax_trainers(tmp_path_factory):
    """The reference Trainer's 3 steps of `_batch_fn` from JAX's init
    (key 0): for the dense and MoE configs on every grid of JAX_GRIDS
    under both strategies, and for the MoE on (4, 2) with a batch of 3
    rows (replicated, `_maybe_replicate_batch`)."""
    path = tmp_path_factory.mktemp("jax_trainers") / "out.pkl"
    runs = [(shape, strategy, 4) for shape in JAX_GRIDS
            for strategy in ("tp_dp", "fsdp")]
    arg = pickle.dumps((
        {"dense": _SMALL, "moe": _MOE_KW},
        {"dense": runs, "moe": runs + [((4, 2), None, 3)]},
        [_batch_fn(s) for s in range(3)], str(path))).hex()
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_TRAINERS),
                        arg], env=env, cwd=REPO, capture_output=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr.decode()[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _own_grid(shape):
    """A grid whose cells name distinct (CPU) devices: a block replicated
    over "data" is one tensor per data row, read by that row."""
    n = shape[0] * shape[1]
    return DeviceGrid(tuple(torch.device("cpu", i) for i in range(n)),
                      shape)


def _run_from(cfg, leaves, tmp_path, batch_fn=_batch_fn, strategy=None,
              mesh=None):
    """3 Trainer steps from JAX's params `leaves`, on `mesh` or on the
    CPU -> (params, history)."""
    tr = Trainer(cfg, _tcfg(tmp_path, steps=3, strategy=strategy),
                 **({"device": "cpu"} if mesh is None else {"mesh": mesh}))
    like = tr.model.init(torch.Generator().manual_seed(0), device="cpu")
    params = tree_unflatten(like, [torch.from_numpy(a.copy())
                                   for a in leaves])
    if mesh is None:
        opt_state = topt.adamw_init(params)
    else:
        params = tree_map(lambda pl, p: pl.place(p), tr.psharding, params)
        opt_state = zero_moments(params, tr.device)
    params, _, hist = tr.fit(params, opt_state, batch_fn)
    return params, hist


def _hold_trainer(params, hist, want):
    """3 steps' losses and the first grad norm within 1e-5 (relative), the
    later grad norms and every final param leaf within 1e-4 (AdamW
    amplifies last-bit differences of the gradients' sums, as above)."""
    want_p, want_h = want
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h[0] for h in want_h], rtol=1e-5)
    np.testing.assert_allclose(hist[0]["grad_norm"], want_h[0][1],
                               rtol=1e-5)
    np.testing.assert_allclose([h["grad_norm"] for h in hist],
                               [h[1] for h in want_h], rtol=1e-4)
    for a, b in zip(tree_leaves(params), want_p, strict=True):
        a = a.gather() if isinstance(a, Sharded) else a
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-4 * float(np.abs(b).max()))


@pytest.mark.parametrize("devices", ["shared", "own"])
@pytest.mark.parametrize("strategy", ["tp_dp", "fsdp"])
@pytest.mark.parametrize("shape", JAX_GRIDS)
@pytest.mark.parametrize("cfg", [SMALL, MOE_SMALL], ids=["dense", "moe"])
def test_grid_trainer_matches_the_reference_trainer(
        jax_trainers, cfg, shape, strategy, devices, tmp_path):
    """`Trainer(mesh=grid)` against the reference's `Trainer(cfg, tcfg,
    mesh)` on the same mesh shape, strategy, params and batches (`_hold_
    trainer`), the MoE with drops included: its groups and aux loss those
    of the whole batch, as GSPMD keeps them. On a grid of distinct
    devices every replica of a range is its own block, updated alike."""
    name = "moe" if cfg.num_experts else "dense"
    grid = _grid(shape) if devices == "shared" else _own_grid(shape)
    params, hist = _run_from(cfg, jax_trainers[name, "params"], tmp_path,
                             strategy=strategy, mesh=grid)
    _hold_trainer(params, hist, jax_trainers[name, shape, strategy, 4])
    for s in tree_leaves(params):
        for held in s.replicas():
            assert all(torch.equal(b, held[0]) for b in held)


def test_grid_trainer_replicates_a_batch_that_does_not_divide(
        jax_trainers, tmp_path):
    """A batch of 3 rows on a (4, 2) grid runs whole on data row 0 (the
    reference's _maybe_replicate_batch): the reference Trainer's run on
    the same mesh, and the single device's losses."""
    fn = lambda s: {k: v[:3] for k, v in _batch_fn(s).items()}  # noqa
    leaves = jax_trainers["moe", "params"]
    _, h1 = _run_from(MOE_SMALL, leaves, tmp_path / "one", batch_fn=fn)
    params, h2 = _run_from(MOE_SMALL, leaves, tmp_path / "grid",
                           batch_fn=fn, mesh=_grid((4, 2)))
    _hold_trainer(params, h2, jax_trainers["moe", (4, 2), None, 3])
    np.testing.assert_allclose([h["loss"] for h in h2],
                               [h["loss"] for h in h1], rtol=1e-5)


def test_grid_trainer_restores_across_grid_shapes_and_packages(small,
                                                               tmp_path):
    """A checkpoint written by the (2, 2) Trainer (fsdp) holds the
    reference's leaves: it restores onto (1, 1) and (4, 1) grids bit for
    bit, in JAX's Checkpointer bit for bit, and a JAX-written checkpoint
    restores onto a (2, 4) grid at its step."""
    tr, (params, opt_state, _) = _run(SMALL, tmp_path / "run",
                                      mesh=_grid((2, 2)), strategy="fsdp")
    whole = [s.gather() if isinstance(s, Sharded) else s
             for s in tree_leaves((params, opt_state))]
    for shape in ((1, 1), (4, 1)):
        tr2 = Trainer(SMALL, _tcfg(tmp_path / "run", strategy="fsdp"),
                      mesh=_grid(shape))
        p2, o2, start = tr2.maybe_restore(*tr2.init_state(1))
        assert start == 3
        got = tree_leaves((p2, o2))
        assert all(isinstance(s, Sharded) and s.placement.grid.shape ==
                   shape for s in got[:-1])
        for a, b in zip(got, whole):
            a = a.gather() if isinstance(a, Sharded) else a
            assert torch.equal(a, b)
    jstate = jopt.adamw_init(small.jparams)
    back, step = JCheckpointer(tmp_path / "run").restore(
        (small.jparams, jstate))
    assert step == 3
    for a, b in zip(jax.tree.leaves(back), whole):
        assert np.array_equal(np.asarray(a), b.numpy())
    jparams, jstate, _ = _jax_loop(jopt.AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=6), small.jparams, 2)
    JCheckpointer(tmp_path / "jax").save(2, (jparams, jstate))
    tr3 = Trainer(SMALL, _tcfg(tmp_path / "jax"), mesh=_grid((2, 4)))
    p3, o3, start = tr3.maybe_restore(*tr3.init_state(5))
    assert start == 2
    for a, b in zip(tree_leaves((p3, o3)), jax.tree.leaves((jparams,
                                                             jstate))):
        a = a.gather() if isinstance(a, Sharded) else a
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_grid_trainer_and_lm_cell_need_a_card_unless_the_grid_is_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: a cuda grid is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _grid((2, 2), "cuda")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    faulthandler.dump_traceback_later(CUDA_TEST_LIMIT_S, exit=True)
    yield torch.device("cuda")
    faulthandler.cancel_dump_traceback_later()


# the CPU side of test_cuda_loss_and_grads_match_the_cpu, run in a child
_CPU_GRADS = """
import os, sys, time
import numpy as np, torch
from repro_torch.configs import registry
from repro_torch.configs.base import tree_leaves
from repro_torch.launch.train import reduced_config
from repro_torch.models import build_model

cfg = reduced_config(registry.get_config("qwen3-1.7b")).replace(num_layers=2)
model = build_model(cfg)
params = model.init(torch.Generator().manual_seed(0), device="cpu")
toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, 65))
batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
         "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}
leaves = tree_leaves(params)
for p in leaves:
    p.requires_grad_(True)
loss, _ = model.loss_fn(params, batch)
grads = torch.autograd.grad(loss, leaves)
host = {}
try:
    for line in open("/proc/cpuinfo"):
        k, _, v = line.partition(":")
        if k.strip() in ("vendor_id", "model name"):
            host.setdefault(k.strip(), v.strip())
except OSError:
    pass
torch.save({"loss": float(loss.detach()), "grads": list(grads),
            "host": dict(host, cores=os.cpu_count(),
                         threads=torch.get_num_threads(),
                         capability=torch.backends.cpu.get_cpu_capability(),
                         MKL_CBWR=os.environ.get("MKL_CBWR"))},
           sys.argv[1])
"""


def _cpu_loss_and_grads_in_a_child(path):
    """(loss, gradient leaves, host) of the CPU side, computed in a process
    of its own with MKL in its reproducible mode (`MKL_CBWR=AVX2`): by
    default MKL picks one of two f32 paths per process, one ~1.85e-4 of
    its max off the card in a gradient (chip_smoke.py [14a],
    grad_reference_probe.py)."""
    env = dict(os.environ, MKL_CBWR="AVX2", PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", _CPU_GRADS, str(path)], env=env,
                   cwd=REPO, check=True, timeout=CUDA_TEST_LIMIT_S)
    ref = torch.load(path)
    return ref["loss"], ref["grads"], ref["host"]


@pytest.mark.cuda
def test_cuda_loss_and_grads_match_the_cpu(cuda, tmp_path):
    """[14]'s card-vs-CPU check at small size: reduced qwen3-1.7b at 2
    layers, f32, TF32 off: the loss within 1e-4 relative and every
    gradient leaf within 1e-4 of its max |value|; no flash launch. The CPU
    side runs in a child process under `MKL_CBWR=AVX2`, its host logged."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced_config(registry.get_config("qwen3-1.7b")).replace(
        num_layers=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, 65))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    loss, grads, host = _cpu_loss_and_grads_in_a_child(tmp_path / "cpu.pt")
    print(f"CPU side: {host}")
    gparams = tree_map(lambda t: t.detach().to(cuda), params)
    before = flash_attention_cuda.launches
    leaves = tree_leaves(gparams)
    for p in leaves:
        p.requires_grad_(True)
    gloss, _ = model.loss_fn(gparams, {k: torch.from_numpy(v).to(cuda)
                                       for k, v in batch.items()})
    ggrads = torch.autograd.grad(gloss, leaves)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before
    np.testing.assert_allclose(float(gloss), loss, rtol=1e-4)
    assert len(ggrads) == len(grads)
    for g, c in zip(ggrads, grads):
        torch.testing.assert_close(g.cpu(), c, rtol=0,
                                   atol=1e-4 * float(c.abs().max()) + 1e-30)


@pytest.mark.cuda
def test_cuda_trainer_steps_and_restart(cuda, tmp_path):
    """[14] at small size on the card: bf16 activations, f32 params and
    AdamW, remat "block"; 4 steps on one fixed batch with warmup 1 are
    finite and the last loss is below the first; a fresh Trainer restores
    step 4 bit-identical."""
    cfg = reduced_config(registry.get_config("qwen3-1.7b")).replace(
        num_layers=2, dtype=torch.bfloat16)
    tcfg = TrainerConfig(steps=4, log_every=1, ckpt_every=2,
                         ckpt_dir=str(tmp_path),
                         opt=topt.AdamWConfig(lr=1e-3, warmup_steps=1,
                                              total_steps=4))
    fixed = _tokens(14, b=2, s=128, vocab=cfg.vocab_size)
    tr = Trainer(cfg, tcfg, device=cuda)
    params, opt_state = tr.init_state(0)
    params, opt_state, hist = tr.fit(params, opt_state, lambda s: fixed)
    losses = [h["loss"] for h in hist]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(np.isfinite(h["grad_norm"]) for h in hist)
    tr2 = Trainer(cfg, tcfg, device=cuda)
    p2, o2, start = tr2.maybe_restore(*tr2.init_state(1))
    assert start == 4
    for a, b in zip(tree_leaves((p2, o2)), tree_leaves((params, opt_state))):
        assert a.is_cuda and torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_grid_lm_cell_train_step_matches_the_cpu(cuda):
    """lm_cell's train step (fsdp, so the shmap MoE) on a (2, 2) grid of
    the card against the same cell on a (2, 2) grid of the CPU, tiny MoE
    with drops, f32, TF32 off: the loss and every updated leaf within 1e-4
    of max."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.launch.specs import lm_cell

    torch.backends.cuda.matmul.allow_tf32 = False
    params = build_model(MOE_SMALL).init(torch.Generator().manual_seed(0),
                                         device="cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in _tokens(3, b=8).items()}
    out = {}
    for dev in ("cpu", cuda):
        grid = _grid((2, 2), dev)
        step, _, in_sh, _ = lm_cell(MOE_SMALL, ShapeSpec("t", 16, 8, "train"),
                                    grid, strategy="fsdp")
        p = tree_map(torch.clone, params)
        out[str(dev)[:4]] = step(*place_tree(grid, in_sh, (
            p, topt.adamw_init(p), batch)))
    np.testing.assert_allclose(float(out["cuda"][2]["loss"]),
                               float(out["cpu"][2]["loss"]), rtol=1e-4)
    for a, b in zip(tree_leaves(out["cuda"][0]), tree_leaves(out["cpu"][0])):
        b = b.gather()
        torch.testing.assert_close(a.gather().cpu(), b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.cuda
def test_cuda_decode_combines_seq_blocks_as_one_cache(cuda):
    """decode_attention over a KV cache split into 4 seq blocks on the
    card: the new k/v land in the block holding the slot, and the
    combined output equals attention over the whole cache within 1e-5 of
    max, at every index up to 63 (empty blocks included)."""
    from repro_torch.models.attention import KVCache, decode_attention

    cfg = reduced_config(registry.get_config("qwen3-1.7b")).replace(
        num_layers=1)
    model = build_model(cfg)
    p = tree_map(lambda t: t[0].to(cuda), model.init(
        torch.Generator().manual_seed(0), device="cpu")["groups"][
            "blocks"][0]["mixer"])
    whole = model.init_caches(2, 64, device=cuda)[0]["kv"]
    whole = KVCache(*(t[0] for t in whole))
    blocks = [KVCache(*(t[..., i * 16:(i + 1) * 16, :] if t.ndim == 4
                        else t[:, i * 16:(i + 1) * 16]
                        for t in (c.clone() for c in whole)))
              for i in range(4)]
    gen = torch.Generator(device=cuda).manual_seed(1)
    for index in range(64):
        x = torch.randn((2, 1, cfg.d_model), generator=gen, device=cuda)
        y1, _ = decode_attention(p, x, cfg, whole, index)
        y2, _ = decode_attention(p, x, cfg, blocks, index)
        torch.testing.assert_close(y2, y1, rtol=0,
                                   atol=1e-5 * float(y1.abs().max()))
    for i, b in enumerate(blocks):
        assert torch.equal(b.k, whole.k[:, :, i * 16:(i + 1) * 16])
