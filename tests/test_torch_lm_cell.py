"""`launch/specs.py::lm_cell` of the port on (4, 2) and (2, 4) grids of the
CPU against the reference's `lm_cell` on Auto meshes of 8 host devices,
and the lowering behaviours (`fsdp_constrain`, `shmap_axes`) it sets.

The JAX side runs in one subprocess (JAX fixes its device count at first
use; the reference's Explicit default mesh fails under jax 0.9, ROADMAP.md
queue C 1.3) and hands back its inputs and outputs; the port runs the
same cells in process, on grids of one device (cells share their
blocks) and of 8 distinct CPU devices (every replica its own block, read
by its own data row). Configs: the tiny dense and MoE configs of
tests/test_distributed.py, f32, the MoE at capacity factor 0.5 so that
tokens drop; their stacked weights at 1/16 of JAX's init (ROADMAP.md
queue C 1.6), the router left as drawn. Train (tp_dp and fsdp): the
loss, the metrics and every updated parameter within 1e-5 of max;
prefill's last logits and caches, and 3 decode steps' logits and the
caches at global_batch 8 and 1 (the KV seq dim over model, and over data
+ model), within 1e-5.
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

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch.configs.base import (  # noqa: E402
    ModelConfig, ShapeSpec, tree_leaves, tree_unflatten)
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch.specs import lm_cell  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training.optimizer import adamw_init  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
GRIDS = [(4, 2), (2, 4)]
_BASE = dict(name="tiny", num_layers=2, d_model=32, num_heads=4,
             num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=128,
             tp_pad_heads=2, vocab_pad=32)
CONFIGS = {"dense": dict(_BASE, family="dense"),
           "moe": dict(_BASE, family="moe", num_experts=4,
                       capacity_factor=0.5, moe_group_size=48)}
SEQ, BATCH, DEC_LEN = 16, 8, 16

_SUBPROCESS = r"""
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec as P
from repro import compat
from repro.configs.base import ModelConfig, ShapeSpec
from repro.launch.specs import lm_cell
from repro.models import build_model
from repro.training.optimizer import adamw_init

configs, seq, batch, dec_len = pickle.loads(bytes.fromhex(sys.argv[1]))
out = {}
rng = np.random.default_rng(0)
toks = rng.integers(0, 128, (batch, seq + 1)).astype(np.int32)
dec = rng.integers(0, 128, (batch, 3)).astype(np.int32)
out["toks"], out["dec"] = toks, dec

def small(path, a):
    keys = [str(getattr(p, "key", "")) for p in path]
    return a / 16 if a.ndim >= 3 and "router" not in keys else a

leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
for name, kw in configs.items():
    cfg = ModelConfig(**kw, dtype=jnp.float32)
    params = jax.tree_util.tree_map_with_path(
        small, build_model(cfg).init(jax.random.key(0)))
    out[name, "params"] = leaves(params)
    for shape in ((4, 2), (2, 4)):
        mesh = Mesh(np.asarray(jax.devices()).reshape(shape),
                    ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        named = lambda tree: jax.tree.map(
            lambda s: NamedSharding(mesh, s) if s is not None else None,
            tree, is_leaf=lambda x: isinstance(x, P) or x is None)

        jitted = {}

        def run(shp, strategy, args):
            key = (shp, strategy)
            if key not in jitted:
                step, _, in_sh, out_sh = lm_cell(cfg, shp, mesh,
                                                 strategy=strategy)
                jitted[key] = (jax.jit(step, in_shardings=named(in_sh),
                                       out_shardings=named(out_sh)),
                               named(in_sh))
            f, in_named = jitted[key]
            with compat.set_mesh(mesh):
                return f(*jax.device_put(args, in_named))

        train = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        for strategy in ("tp_dp", "fsdp"):
            p2, _, m = run(ShapeSpec("t", seq, batch, "train"), strategy,
                           (params, adamw_init(params), train))
            out[name, shape, "train", strategy] = (
                leaves(p2), {k: float(v) for k, v in m.items()})
        lg, caches = run(ShapeSpec("p", seq, batch, "prefill"), None,
                         (params, {"tokens": toks[:, :-1]}))
        out[name, shape, "prefill"] = (np.asarray(lg), leaves(caches))
        for b in (batch, 1):
            caches = build_model(cfg).init_caches(b, dec_len)
            logits = []
            for i in range(3):
                lg, caches = run(
                    ShapeSpec("d", dec_len, b, "decode"), None,
                    (params, {"tokens": dec[:b, i:i + 1], "caches": caches,
                              "index": jnp.int32(i)}))
                logits.append(np.asarray(lg))
            out[name, shape, "decode", b] = (logits, leaves(caches))
sys.stdout.buffer.write(pickle.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    """The JAX side's inputs and outputs (one 8-device subprocess)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    arg = pickle.dumps((CONFIGS, SEQ, BATCH, DEC_LEN)).hex()
    p = subprocess.run([sys.executable, "-c", textwrap.dedent(_SUBPROCESS),
                        arg], env=env, cwd=REPO, capture_output=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr.decode()[-4000:]
    return pickle.loads(p.stdout)


def _cfg(name, **kw):
    return ModelConfig(**CONFIGS[name], dtype=torch.float32, **kw)


def _params(ref, name):
    model = build_model(_cfg(name))
    like = model.init(torch.Generator().manual_seed(0), device="cpu")
    return tree_unflatten(like, [torch.from_numpy(a.copy())
                                 for a in ref[name, "params"]])


def _grid(shape):
    return SH.DeviceGrid(("cpu",) * (shape[0] * shape[1]), shape)


def _own_grid(shape):
    """A grid whose cells name distinct (CPU) devices: a block replicated
    over "data" is one tensor per data row, read by that row."""
    n = shape[0] * shape[1]
    return SH.DeviceGrid(tuple(torch.device("cpu", i) for i in range(n)),
                         shape)


DEVICES = {"shared": _grid, "own": _own_grid}


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want,
                                                              np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)
    return err


def _whole(x):
    return x.gather() if isinstance(x, SH.Sharded) else x


@pytest.mark.parametrize("devices", list(DEVICES))
@pytest.mark.parametrize("strategy", ["tp_dp", "fsdp"])
@pytest.mark.parametrize("shape", GRIDS)
@pytest.mark.parametrize("name", ["dense", "moe"])
def test_train_step_matches_jax(ref, name, shape, strategy, devices):
    """One train step (grad, AdamW) on blocks: the loss, ce, aux,
    grad_norm and lr, and every updated parameter leaf within 1e-5 of
    max of JAX's; blocks come back in the in layout, updated in place,
    every replica of a range equal to the others bit for bit."""
    grid = DEVICES[devices](shape)
    step, args, in_sh, out_sh = lm_cell(_cfg(name), ShapeSpec(
        "t", SEQ, BATCH, "train"), grid, strategy=strategy)
    params = _params(ref, name)
    toks = torch.from_numpy(ref["toks"]).long()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    placed = SH.place_tree(grid, in_sh, (params, adamw_init(params), batch))
    before = [id(b) for s in tree_leaves(placed[0]) for b in s.tensors()]
    p2, o2, metrics = step(*placed)
    assert [id(b) for s in tree_leaves(p2) for b in s.tensors()] == before
    want_p, want_m = ref[name, shape, "train", strategy]
    assert set(metrics) == set(want_m)
    for k, v in want_m.items():
        _close(float(metrics[k]), v)
    for got, want in zip(tree_leaves(p2), want_p):
        _close(got.gather().numpy(), want)
        for held in got.replicas():
            assert all(torch.equal(b, held[0]) for b in held)
    assert int(_whole(o2.count)) == 1
    if devices == "own":
        assert any(len(held) > 1 for s in tree_leaves(p2)
                   for held in s.replicas())


@pytest.mark.parametrize("devices", list(DEVICES))
@pytest.mark.parametrize("shape", GRIDS)
@pytest.mark.parametrize("name", ["dense", "moe"])
def test_prefill_matches_jax(ref, name, shape, devices):
    grid = DEVICES[devices](shape)
    step, args, in_sh, out_sh = lm_cell(_cfg(name), ShapeSpec(
        "p", SEQ, BATCH, "prefill"), grid)
    assert out_sh is None
    toks = torch.from_numpy(ref["toks"]).long()
    placed = SH.place_tree(grid, in_sh, (_params(ref, name),
                                         {"tokens": toks[:, :-1]}))
    logits, caches = step(*placed)
    want_l, want_c = ref[name, shape, "prefill"]
    _close(logits.numpy(), want_l)
    leaves = tree_leaves(caches)
    assert len(leaves) == len(want_c)
    for got, want in zip(leaves, want_c):
        _close(got.numpy(), want)


@pytest.mark.parametrize("devices", list(DEVICES))
@pytest.mark.parametrize("batch", [BATCH, 1])
@pytest.mark.parametrize("shape", GRIDS)
@pytest.mark.parametrize("name", ["dense", "moe"])
def test_decode_matches_jax(ref, name, shape, batch, devices):
    """3 decode steps from empty seq-sharded caches: each step's logits
    and the final caches (gathered) within 1e-5 of JAX's; the KV blocks
    are written in place, never gathered."""
    grid = DEVICES[devices](shape)
    cfg = _cfg(name)
    step, args, in_sh, out_sh = lm_cell(cfg, ShapeSpec(
        "d", DEC_LEN, batch, "decode"), grid)
    kv_spec = in_sh[1]["caches"][0]["kv"].k
    assert kv_spec[3] == ("model" if batch == BATCH else ("data", "model"))
    params = SH.place_tree(grid, in_sh[0], _params(ref, name))
    caches = SH.place_tree(grid, in_sh[1]["caches"], build_model(
        cfg).init_caches(batch, DEC_LEN, device="cpu"))
    kv_ids = [id(b) for b in caches[0]["kv"].k.tensors()]
    dec = torch.from_numpy(ref["dec"]).long()
    want_l, want_c = ref[name, shape, "decode", batch]
    for i in range(3):
        logits, caches = step(params, {"tokens": dec[:batch, i:i + 1],
                                       "caches": caches,
                                       "index": torch.tensor(i)})
        _close(logits.numpy(), want_l[i])
    assert [id(b) for b in caches[0]["kv"].k.tensors()] == kv_ids
    for got, want in zip(tree_leaves(caches), want_c):
        _close(got.gather().numpy(), want)


def test_tp_dp_and_fsdp_losses_agree(ref):
    """In f32 the fsdp cast is the identity: both strategies' losses
    within 1e-5 (relative), on both grids, as the reference's
    test_fsdp_constrain_equivalence holds JAX's."""
    for name in ("dense", "moe"):
        for shape in GRIDS:
            a = ref[name, shape, "train", "tp_dp"][1]["loss"]
            b = ref[name, shape, "train", "fsdp"][1]["loss"]
            assert abs(a - b) <= 1e-5 * abs(a)


def test_shmap_moe_drops_per_shard(ref):
    """lm_cell's MoE (`shmap_axes`) routes each data shard's tokens alone:
    its loss differs from the single-device loss of the same params and
    batch, while matching JAX's lm_cell (test_train_step_matches_jax);
    on a (4, 2) grid's data shards `apply_moe` drops other choices than
    on the whole batch, and gives another output."""
    cfg = _cfg("moe")
    model = build_model(cfg)
    params = _params(ref, "moe")
    toks = torch.from_numpy(ref["toks"]).long()
    loss, _ = model.loss_fn(params, {"tokens": toks[:, :-1],
                                     "labels": toks[:, 1:]})
    sharded = ref["moe", (4, 2), "train", "tp_dp"][1]["loss"]
    assert abs(float(loss) - sharded) > 1e-4 * abs(sharded)
    x = torch.randn((8, 12, 32), generator=torch.Generator().manual_seed(1))
    p = {k: v[0] for k, v in params["groups"]["blocks"][0]["ffn"].items()}
    kept = []
    kept_cb = []
    orig = MOE.route

    def spy(xg, router, c):
        r = orig(xg, router, c)
        kept_cb.append(r.keep)
        return r

    MOE.route = spy
    try:
        whole, _ = MOE.apply_moe(p, x, cfg)
        kept.append(torch.cat([k.reshape(-1) for k in kept_cb]))
        kept_cb.clear()
        shard_cfg = cfg.replace(shmap_axes=(("data",), "model"))
        parts = torch.cat([MOE.apply_moe(p, xl, shard_cfg, 2)[0]
                           for xl in x.chunk(4)])
        kept.append(torch.cat([k.reshape(-1) for k in kept_cb]))
    finally:
        MOE.route = orig
    assert not bool(kept[0].all()) and not bool(kept[1].all())
    assert kept[0].shape != kept[1].shape or not torch.equal(kept[0],
                                                              kept[1])
    assert float((whole - parts).abs().max()) > 1e-3


def test_fsdp_constrain_rounds_the_router_as_jax_does():
    """Under `fsdp_constrain` a bf16 config's router is cast to bf16
    before use, as in the reference (ROADMAP.md queue C 1.10): three
    router columns 1 + 2^-12, 1 + 2^-10 and 1 + 2^-11 round to one bf16
    value, so the top-2 experts of a token on that row are {1, 2} in f32
    and {0, 1} (ties to the lower index) in bf16. The port's forward
    routes as JAX's `_moe_math` does with the cast router, and its MoE
    output equals JAX's within bf16 rounding."""
    kw = dict(CONFIGS["moe"], num_layers=1, capacity_factor=8.0)
    cfg = ModelConfig(**kw, dtype=torch.bfloat16)
    jcfg = JModelConfig(**kw, dtype=jnp.bfloat16)
    rng = np.random.default_rng(3)
    router = (rng.normal(size=(32, 4)) * 0.02).astype(np.float32)
    router[5, :3] = [1 + 2**-12, 1 + 2**-10, 1 + 2**-11]
    router[5, 3] = -1.0
    x = np.zeros((1, 4, 32), np.float32)
    x[0, :, 5] = 2.0          # every token on the tied row
    x[0, 1:, 7] = [0.5, 1.0, 1.5]
    ffn = {"router": router}
    for k, shp in (("w1", (4, 32, 64)), ("w3", (4, 32, 64)),
                   ("w2", (4, 64, 32))):
        ffn[k] = torch.from_numpy((rng.normal(size=shp) * 0.1).astype(
            np.float32)).to(torch.bfloat16).float().numpy()
    tp = {k: torch.from_numpy(v) for k, v in ffn.items()}
    xt = torch.from_numpy(x).to(torch.bfloat16)
    seen = []
    orig = MOE.route

    def spy(xg, r, c):
        out = orig(xg, r, c)
        seen.append(out.gate_idx[0].sort(-1).values)
        return out

    MOE.route = spy
    try:
        use = T._fsdp_use(cfg.replace(fsdp_constrain=True))
        got, _ = MOE.apply_moe({k: use(v) for k, v in tp.items()}, xt, cfg)
        plain, _ = MOE.apply_moe(tp, xt, cfg)
    finally:
        MOE.route = orig
    assert seen[0][0].tolist() == [0, 1] and seen[1][0].tolist() == [1, 2]
    # XLA on the CPU cannot run a bf16 x bf16 -> f32 dot, so JAX's side
    # runs the f32 config on the bf16 values (x and the experts are exact
    # in bf16; the router is f32 or its bf16 rounding): the routing reads
    # the same f32 logits as the bf16 config's
    jcfg = jcfg.replace(dtype=jnp.float32)
    math = jax.jit(lambda p, x: jmoe._moe_math(p, x, jcfg)[0])
    b16 = lambda v: jnp.asarray(v).astype(jnp.bfloat16).astype(  # noqa
        jnp.float32)
    jx = b16(x)
    want = np.asarray(math({k: b16(v) for k, v in ffn.items()}, jx))
    want_plain = np.asarray(math(dict({k: b16(v) for k, v in ffn.items()},
                                      router=jnp.asarray(router)), jx))
    got, plain = got.float().numpy(), plain.float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    assert np.abs(plain - want_plain).max() <= 2e-2 * np.abs(want).max()
    assert np.abs(got - plain).max() > 0.1 * np.abs(want).max()


@pytest.mark.parametrize("fsdp", [False, True])
def test_forward_casts_group_weights_only_under_fsdp_constrain(fsdp):
    """`forward` under `fsdp_constrain` hands each block its >= 2-D f32
    weights in `cfg.dtype` (the router among them) and keeps 1-D ones
    (norm scales) in f32; without it the router stays f32."""
    cfg = ModelConfig(**dict(CONFIGS["moe"], num_layers=1),
                      dtype=torch.bfloat16, fsdp_constrain=fsdp)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    seen, norms, orig, norm = [], [], MOE.route, T.L.apply_norm

    def spy(xg, r, c):
        seen.append(r.dtype)
        return orig(xg, r, c)

    def norm_spy(p, x, c):
        norms.append(p["scale"].dtype)
        return norm(p, x, c)

    MOE.route, T.L.apply_norm = spy, norm_spy
    try:
        model.loss_fn(params, {"tokens": torch.zeros((1, 8), dtype=torch.long),
                               "labels": torch.zeros((1, 8),
                                                     dtype=torch.long)})
    finally:
        MOE.route, T.L.apply_norm = orig, norm
    assert seen == [torch.bfloat16 if fsdp else torch.float32]
    assert set(norms) == {torch.float32}


def test_grad_accum_matches_one_batch(ref):
    """lm_cell train with grad_accum=2 (dense; each micro-batch of 4 split
    over the 4 data rows): the loss is the micro-batches' mean and the
    update lands within 1e-5 of max of grad_accum=1's; metrics hold only
    loss, grad_norm and lr, as the reference's."""
    grid = _grid((4, 2))
    toks = torch.from_numpy(ref["toks"]).long()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for accum in (1, 2):
        step, _, in_sh, _ = lm_cell(_cfg("dense"), ShapeSpec(
            "t", SEQ, BATCH, "train"), grid, grad_accum=accum)
        params = _params(ref, "dense")
        out[accum] = step(*SH.place_tree(grid, in_sh, (
            params, adamw_init(params), batch)))
    assert set(out[2][2]) == {"loss", "grad_norm", "lr"}
    _close(float(out[2][2]["loss"]), float(out[1][2]["loss"]))
    for a, b in zip(tree_leaves(out[2][0]), tree_leaves(out[1][0])):
        _close(a.gather().numpy(), b.gather().numpy())


def test_decode_without_seq_sharded_caches_agrees(ref):
    """`cache_seq_shard=False` keeps each KV cache whole over the seq dim
    (batch over data): 3 decode steps' logits equal the seq-sharded
    cell's within 1e-5."""
    grid = _grid((4, 2))
    cfg = _cfg("dense")
    dec = torch.from_numpy(ref["dec"]).long()
    logits = {}
    for seq_shard in (True, False):
        step, _, in_sh, _ = lm_cell(cfg, ShapeSpec("d", DEC_LEN, BATCH,
                                                   "decode"), grid,
                                    cache_seq_shard=seq_shard)
        assert in_sh[1]["caches"][0]["kv"].k[3] == (
            "model" if seq_shard else None)
        params = SH.place_tree(grid, in_sh[0], _params(ref, "dense"))
        caches = SH.place_tree(grid, in_sh[1]["caches"], build_model(
            cfg).init_caches(BATCH, DEC_LEN, device="cpu"))
        logits[seq_shard] = []
        for i in range(3):
            lg, caches = step(params, {"tokens": dec[:, i:i + 1],
                                       "caches": caches,
                                       "index": torch.tensor(i)})
            logits[seq_shard].append(lg)
    for a, b in zip(logits[False], logits[True]):
        _close(a.numpy(), b.numpy())
