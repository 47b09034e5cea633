"""`launch/specs.py::lm_cell` of the port for the hybrid (Jamba), audio
(Whisper) and VLM (InternVL2) families on a (4, 2) grid of the CPU,
against the reference's `lm_cell` on an Auto mesh of 8 host devices: the
grid paths these families add (the per-row encoder and its cross caches,
the patch rows and the text-only loss, the Mamba states gathered per row
and laid out again after a decode step, the shard_map MoE inside a
hybrid group).

The JAX side runs in one subprocess, as in tests/test_torch_lm_cell.py,
and hands back its inputs and outputs. Configs: each arch at the reduced
shapes of tests/test_torch_families.py (Jamba one group of 8 layers, its
MoE at capacity factor 0.5 so that tokens drop), f32, the stacked weights
at 1/16 of JAX's init (ROADMAP.md queue C 1.6), the router left as
drawn. Train (each arch's default strategy): the loss and the metrics
within 1e-5, every updated parameter within 1e-5 of max plus 1e-4 of the
step's learning rate (a leaf that starts at zero, a LayerNorm bias, is
+-lr g / (|g| + eps) after one AdamW step: where |g| is near eps the
update moves by lr / eps times the gradient's last-bit noise, 7.6e-5 of
lr measured on whisper's); prefill's last logits and
caches, and 3 decode steps' logits and the caches at global_batch 8 and
1, within 1e-5. Each case runs on a grid of one device ("shared": cells
share their blocks) and on a grid whose cells name 8 distinct CPU devices
("own": every replica its own block).
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from test_torch_families import reduced_kw  # noqa: E402
from test_torch_lm_cell import DEVICES, _close  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    ShapeSpec, tree_leaves, tree_unflatten)
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch.specs import lm_cell  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training.optimizer import adamw_init  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SHAPE = (4, 2)
SEQ, BATCH, DEC_LEN = 16, 8, 16
ARCHS = {"jamba": "jamba-v0.1-52b", "whisper": "whisper-small",
         "internvl": "internvl2-2b"}
OVER = {"jamba": dict(num_layers=8, capacity_factor=0.5, moe_group_size=48),
        "whisper": dict(encoder_layers=2, encoder_seq=24, max_seq_len=256),
        "internvl": dict(num_patches=4, max_seq_len=256)}


def _kw(name):
    return reduced_kw(registry.get_config(ARCHS[name]), **OVER[name])


_SUBPROCESS = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs.base import ShapeSpec
from repro.configs.registry import get_config
from repro.launch.specs import lm_cell
from repro.models import build_model
from repro.training.optimizer import adamw_init

archs, kws, shape, seq, batch, dec_len = pickle.loads(
    bytes.fromhex(sys.argv[1]))
mesh = Mesh(np.asarray(jax.devices()).reshape(shape), ("data", "model"),
            axis_types=(AxisType.Auto,) * 2)
named = lambda tree: jax.tree.map(
    lambda s: NamedSharding(mesh, s) if s is not None else None,
    tree, is_leaf=lambda x: isinstance(x, P) or x is None)
leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]

def small(path, a):
    keys = [str(getattr(p, "key", "")) for p in path]
    return a / 16 if a.ndim >= 3 and "router" not in keys else a

def run(cfg, shp, args):
    step, _, in_sh, out_sh = lm_cell(cfg, shp, mesh)
    f = jax.jit(step, in_shardings=named(in_sh),
                out_shardings=named(out_sh))
    with compat.set_mesh(mesh):
        return f(*jax.device_put(args, named(in_sh)))

out = {}
for name, arch in archs.items():
    cfg = get_config(arch).replace(**kws[name], dtype=jnp.float32)
    rng = np.random.default_rng(0)
    text = seq - cfg.num_patches
    toks = rng.integers(0, cfg.vocab_size, (batch, text + 1)).astype(
        np.int32)
    dec = rng.integers(0, cfg.vocab_size, (batch, 3)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patch_embeds"] = rng.normal(
            size=(batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        extra["frames"] = rng.normal(
            size=(batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    params = jax.tree_util.tree_map_with_path(
        small, build_model(cfg).init(jax.random.key(0)))
    out[name, "inputs"] = (leaves(params), toks, dec, extra)
    train = dict(extra, tokens=toks[:, :-1], labels=toks[:, 1:])
    p2, _, m = run(cfg, ShapeSpec("t", seq, batch, "train"),
                   (params, adamw_init(params), train))
    out[name, "train"] = (leaves(p2), {k: float(v) for k, v in m.items()})
    lg, caches = run(cfg, ShapeSpec("p", seq, batch, "prefill"),
                     (params, dict(extra, tokens=toks[:, :-1])))
    out[name, "prefill"] = (np.asarray(lg), leaves(caches))
    for b in (batch, 1):
        caches = build_model(cfg).init_caches(b, dec_len)
        logits = []
        for i in range(3):
            lg, caches = run(cfg, ShapeSpec("d", dec_len, b, "decode"),
                             (params, {"tokens": dec[:b, i:i + 1],
                                       "caches": caches,
                                       "index": jnp.int32(i)}))
            logits.append(np.asarray(lg))
        out[name, "decode", b] = (logits, leaves(caches))
sys.stdout.buffer.write(pickle.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    """The JAX side's inputs and outputs (one 8-device subprocess)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    kws = {name: _kw(name) for name in ARCHS}
    arg = pickle.dumps((ARCHS, kws, SHAPE, SEQ, BATCH, DEC_LEN)).hex()
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(_SUBPROCESS),
                        arg], env=env, cwd=REPO, capture_output=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr.decode()[-4000:]
    return pickle.loads(p.stdout)


def _cfg(name):
    return registry.get_config(ARCHS[name]).replace(**_kw(name),
                                                    dtype=torch.float32)


def _inputs(ref, name):
    leaves, toks, dec, extra = ref[name, "inputs"]
    like = build_model(_cfg(name)).init(torch.Generator().manual_seed(0),
                                        device="cpu")
    params = tree_unflatten(like, [torch.from_numpy(a.copy())
                                   for a in leaves])
    extra = {k: torch.from_numpy(v) for k, v in extra.items()}
    return (params, torch.from_numpy(toks).long(),
            torch.from_numpy(dec).long(), extra)


@pytest.mark.parametrize("devices", list(DEVICES))
@pytest.mark.parametrize("name", list(ARCHS))
def test_family_train_step_matches_jax(ref, name, devices):
    grid = DEVICES[devices](SHAPE)
    step, _, in_sh, _ = lm_cell(_cfg(name), ShapeSpec(
        "t", SEQ, BATCH, "train"), grid)
    params, toks, _, extra = _inputs(ref, name)
    batch = dict(extra, tokens=toks[:, :-1], labels=toks[:, 1:])
    p2, _, metrics = step(*SH.place_tree(grid, in_sh, (
        params, adamw_init(params), batch)))
    want_p, want_m = ref[name, "train"]
    assert set(metrics) == set(want_m)
    for k, v in want_m.items():
        _close(float(metrics[k]), v)
    for got, want in zip(tree_leaves(p2), want_p, strict=True):
        err = float(np.abs(got.gather().numpy() - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()) + \
            1e-4 * want_m["lr"], err


@pytest.mark.parametrize("devices", list(DEVICES))
@pytest.mark.parametrize("name", list(ARCHS))
def test_family_prefill_matches_jax(ref, name, devices):
    grid = DEVICES[devices](SHAPE)
    step, _, in_sh, _ = lm_cell(_cfg(name), ShapeSpec(
        "p", SEQ, BATCH, "prefill"), grid)
    params, toks, _, extra = _inputs(ref, name)
    logits, caches = step(*SH.place_tree(grid, in_sh, (
        params, dict(extra, tokens=toks[:, :-1]))))
    want_l, want_c = ref[name, "prefill"]
    _close(logits.numpy(), want_l)
    for got, want in zip(tree_leaves(caches), want_c, strict=True):
        _close(got.numpy(), want)


@pytest.mark.parametrize("devices", list(DEVICES))
@pytest.mark.parametrize("batch", [BATCH, 1])
@pytest.mark.parametrize("name", list(ARCHS))
def test_family_decode_matches_jax(ref, name, batch, devices):
    """3 decode steps from empty caches laid out by cache_pytree_spec:
    each step's logits and the final caches (gathered) within 1e-5 of
    JAX's, SSM states laid out again after every step."""
    grid = DEVICES[devices](SHAPE)
    cfg = _cfg(name)
    step, _, in_sh, _ = lm_cell(cfg, ShapeSpec("d", DEC_LEN, batch,
                                               "decode"), grid)
    params, _, dec, _ = _inputs(ref, name)
    params = SH.place_tree(grid, in_sh[0], params)
    caches = SH.place_tree(grid, in_sh[1]["caches"], build_model(
        cfg).init_caches(batch, DEC_LEN, device="cpu"))
    want_l, want_c = ref[name, "decode", batch]
    for i in range(3):
        logits, caches = step(params, {"tokens": dec[:batch, i:i + 1],
                                       "caches": caches,
                                       "index": torch.tensor(i)})
        _close(logits.numpy(), want_l[i])
    got = tree_leaves(caches)
    assert all(isinstance(s, SH.Sharded) for s in got)
    for g, want in zip(got, want_c, strict=True):
        _close(g.gather().numpy(), want)
