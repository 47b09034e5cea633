"""The port's serving engine (`repro_torch.serving.engine`) and serve
launcher against the JAX package, on the CPU.

Both engines run the same parameters (the JAX ones carried over with
`params_from_jax`) on the tiny config of tests/test_substrate.py, greedy,
and must give the same tokens, token for token: one request, five
requests through three slots, and the mixed-length pool in which the JAX
engine decodes every slot at the pool's largest position (ROADMAP.md
queue C, fault 2) -- the port reproduces that fault. `jax.random` and
`torch.Generator` draw different numbers, so temperature sampling is held
to its range and to its determinism under a seed.
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.models.params import params_from_jax
from repro_torch.serving.engine import Engine, ServeConfig

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(name="tiny", family="dense", num_layers=2, d_model=32,
             num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128,
             head_dim=8, tp_pad_heads=4, vocab_pad=32)
TSMALL = ModelConfig(**SMALL, dtype=torch.float32)
PROMPT = [5, 17, 42]
ALONE = [16, 67, 36, 39, 24, 16]        # PROMPT served alone
BESIDE_9 = [16, 67, 36, 6, 122, 88]     # beside a 9-token prompt (fault 2)


@pytest.fixture(scope="module")
def jx():
    """The JAX engine on SMALL with key-0 params, and the port's copy of
    those params (skips without JAX)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models import build_model as jbuild
    from repro.serving.engine import Engine as JEngine
    from repro.serving.engine import ServeConfig as JServeConfig

    jcfg = JModelConfig(**SMALL, dtype=jnp.float32)
    jparams = jbuild(jcfg).init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return types.SimpleNamespace(jax=jax, jnp=jnp, jcfg=jcfg, jbuild=jbuild,
                                 jparams=jparams, params=params,
                                 Engine=JEngine, ServeConfig=JServeConfig)


def _serve(engine_cls, scfg_cls, cfg, params, prompts, slots, max_len,
           **kw):
    eng = engine_cls(cfg, scfg_cls(max_slots=slots, max_len=max_len,
                                   eos_id=-1, **kw), params)
    rids = [eng.submit(np.asarray(p)) for p in prompts]
    results = eng.run()
    return [results[r] for r in rids]


def _both(jx, prompts, slots, max_len):
    want = _serve(jx.Engine, jx.ServeConfig, jx.jcfg, jx.jparams, prompts,
                  slots, max_len)
    got = _serve(Engine, ServeConfig, TSMALL, jx.params, prompts, slots,
                 max_len)
    return got, want


def test_one_request_matches_jax_and_greedy_rollout(jx):
    """tests/test_substrate.py::test_serving_matches_greedy_reference."""
    steps = 6
    got, want = _both(jx, [PROMPT], 2, len(PROMPT) + steps + 1)
    assert got == want
    assert got[0][:steps] == ALONE
    toks = list(PROMPT)
    model = build_model(TSMALL)
    with torch.no_grad():
        for _ in range(steps):
            logits, _, _, _ = model._fwd(
                jx.params, {"tokens": torch.tensor([toks])}, "train")
            toks.append(int(torch.argmax(logits[0, -1])))
    assert got[0][:steps] == toks[len(PROMPT):]


def test_five_requests_through_three_slots_match_jax(jx):
    """tests/test_substrate.py::test_serving_engine_batched_requests."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, size=5) for _ in range(5)]
    got, want = _both(jx, prompts, 3, 24)
    assert got == want
    assert all(len(r) > 0 and all(0 <= t < 128 for t in r) for r in got)


def test_mixed_length_pool_reproduces_the_shared_index(jx):
    """Beside a 9-token prompt in a 2-slot pool, PROMPT decodes at the
    9-token slot's positions: both packages give BESIDE_9, not ALONE."""
    got, want = _both(jx, [PROMPT, list(range(1, 10))], 2, 16)
    assert got == want
    assert got[0][:6] == BESIDE_9 != ALONE


def test_temperature_sampling_is_seeded_and_in_range(jx):
    prompts = [[3, 4, 5], [9, 8, 7, 6]]
    runs = [_serve(Engine, ServeConfig, TSMALL, jx.params, prompts, 2, 12,
                   temperature=0.8, seed=seed) for seed in (1, 1, 2)]
    assert runs[0] == runs[1]
    for run in runs:
        assert all(0 <= t < TSMALL.vocab_size for r in run for t in r)
        assert [len(r) for r in run] == [12 - 1 - 3 + 1, 12 - 1 - 4 + 1]


def test_engine_rejects_prompts_that_do_not_fit(jx):
    eng = Engine(TSMALL, ServeConfig(max_slots=1, max_len=8), jx.params)
    for bad in ([], list(range(9)), [[1, 2]]):
        with pytest.raises(ValueError):
            eng.submit(bad)


def _serve_cli(*args, threads=None):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    if threads:  # fewer CPU threads: the suite runs test files side by side
        env["OMP_NUM_THREADS"] = str(threads)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args], env=env,
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_serve_launcher_runs_on_cpu():
    p = _serve_cli("--device", "cpu", "--reduced", "--requests", "4")
    assert p.returncode == 0, p.stdout + p.stderr
    assert "on cpu" in p.stdout and "served 4 requests" in p.stdout
    assert "host-CPU" not in p.stdout


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b",
                                  "xlstm-1.3b", "jamba-v0.1-52b"])
def test_serve_launcher_runs_each_family_on_cpu(arch):
    """The MoE, SSM and hybrid archs at their reduced config."""
    p = _serve_cli("--device", "cpu", "--reduced", "--arch", arch,
                   "--requests", "2", "--max-len", "20", threads=2)
    assert p.returncode == 0, p.stdout + p.stderr
    assert f"serving {arch}" in p.stdout and " on cpu," in p.stdout
    assert "served 2 requests" in p.stdout and "tok/s on cpu)" in p.stdout


def test_serve_launcher_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    p = _serve_cli("--reduced", "--requests", "1")
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr


# ---------------------------------------------------------- on the card
@pytest.mark.cuda
def test_cuda_engine_prefills_through_the_kernel():
    """The engine on the card: one flash-attention launch a layer for each
    prefill and none for decode, and the CPU engine's greedy tokens on the
    same f32 params."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    from repro_torch.configs.base import tree_map
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    gen = torch.Generator()
    gen.manual_seed(0)
    params = build_model(TSMALL).init(gen, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, size=n) for n in (5, 9, 3)]
    want = _serve(Engine, ServeConfig, TSMALL, params, prompts, 2, 24)
    torch.backends.cuda.matmul.allow_tf32 = False
    before = flash_attention_cuda.launches
    got = _serve(Engine, ServeConfig, TSMALL,
                 tree_map(lambda t: t.cuda(), params), prompts, 2, 24)
    assert flash_attention_cuda.launches == before + 2 * len(prompts)
    assert got == want
