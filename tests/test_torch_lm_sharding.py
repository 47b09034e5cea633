"""The LM half of the port's `distributed/sharding.py` against the JAX
package's, on the CPU.

The spec functions (`rules_for`, `strategy_for`, `batch_spec`,
`param_spec` under the rules, `cache_pytree_spec`) are held equal to
`tuple(PartitionSpec)` of the reference's for all ten archs, both
strategies and the (4, 2), (2, 4) and (8, 1) grids, on JAX's abstract
meshes (no device needed). The placements' index ranges are held equal to
`NamedSharding.devices_indices_map` on Auto meshes of 8 host devices, in
one subprocess (JAX fixes its device count at first use), and the round
trip place -> gather is bit for bit.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import tree_leaves  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCHS = sorted(registry.ARCHS)
GRIDS = [(4, 2), (2, 4), (8, 1)]


def _mesh(shape):
    return AbstractMesh(shape, ("data", "model"))


def _grid(shape):
    return SH.DeviceGrid(("cpu",) * (shape[0] * shape[1]), shape)


def _jspecs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


def test_is_every_arch_in_both_registries():
    assert ARCHS == sorted(jregistry.ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("strategy", ["tp_dp", "fsdp"])
def test_rules_and_strategy_match_jax(arch, strategy):
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    rules = SH.rules_for(cfg, strategy, _grid((4, 2)))
    assert rules == JSH.rules_for(jcfg, strategy, _mesh((4, 2)))
    if strategy == "fsdp":
        assert rules["embed"] == ("data",)
    assert SH.strategy_for(cfg) == JSH.strategy_for(jcfg)


@pytest.mark.parametrize("shape", GRIDS)
@pytest.mark.parametrize("strategy", ["tp_dp", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, strategy, shape):
    """`param_spec(rules_for(...))` leaf for leaf: tuple(P) of JAX's."""
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    got = build_model(cfg).param_spec(SH.rules_for(cfg, strategy,
                                                   _grid(shape)))
    want = jbuild(jcfg).param_spec(JSH.rules_for(jcfg, strategy,
                                                 _mesh(shape)))
    assert tree_leaves(got, is_leaf=SH.is_spec) == _jspecs(want)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_jax(arch, kind):
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    for shape in GRIDS:
        got = SH.batch_spec(cfg, kind, _grid(shape))
        want = JSH.batch_spec(jcfg, kind, _mesh(shape))
        assert got == {k: tuple(v) for k, v in want.items()}, shape


@pytest.mark.parametrize("shape", GRIDS)
@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_jax(arch, kind, shape):
    """`cache_pytree_spec` of each family's caches at global_batch 1 and
    8 (seq-sharded and not): leaf for leaf tuple(P) of JAX's."""
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    model, jmodel = build_model(cfg), jbuild(jcfg)
    for batch in (1, 8):
        caches = model.init_caches(batch, 64, device="meta")
        jcaches = jax.eval_shape(functools.partial(jmodel.init_caches,
                                                   batch, 64))
        for seq_shard in (True, False):
            got = SH.cache_pytree_spec(cfg, caches, kind, _grid(shape), 64,
                                       cache_seq_shard=seq_shard)
            want = JSH.cache_pytree_spec(jcfg, jcaches, kind, _mesh(shape),
                                         64, cache_seq_shard=seq_shard)
            assert tree_leaves(got, is_leaf=SH.is_spec) == _jspecs(want), \
                (batch, seq_shard)
            assert len(tree_leaves(got, is_leaf=SH.is_spec)) == \
                len(tree_leaves(caches))


# ------------------------------------------------- placements against JAX
_CASES = [((8, 8), ("data", "model")), ((6, 8), (None, "data")),
          ((16, 4), (("data", "model"), None)), ((8, 2), ("model",)),
          ((2, 8, 16), (None, "data", "model")), ((3, 16), (None, "model")),
          ((2, 8, 4, 16, 2), (None, None, None, ("data", "model"), None)),
          ((2, 8, 4, 16, 2), (None, "data", None, "model", None)),
          ((), ()), ((5,), (None,)), ((8, 8), (("model", "data"), None))]

_SUBPROCESS = r"""
import json, sys
import numpy as np, jax
from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec as P

cases = json.loads(sys.argv[1])
out = {}
for shape in ((4, 2), (2, 4), (8, 1)):
    mesh = Mesh(np.asarray(jax.devices()).reshape(shape), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)
    for n, (dims, spec) in enumerate(cases):
        spec = [tuple(e) if isinstance(e, list) else e for e in spec]
        idx = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(dims))
        out[f"{shape}-{n}"] = [
            [[s.start, s.stop] for s in idx[mesh.devices[i, j]]]
            for i in range(shape[0]) for j in range(shape[1])]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_index_maps():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_SUBPROCESS),
         json.dumps(_CASES)], env=env, cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("shape", GRIDS)
@pytest.mark.parametrize("case", range(len(_CASES)))
def test_placement_indices_match_devices_indices_map(jax_index_maps,
                                                     case, shape):
    """Each cell's index ranges equal `devices_indices_map` at the mesh
    position of the cell; place -> gather is bit for bit, and the blocks
    are the tensor's slices, each on its cell's device."""
    dims, spec = _CASES[case]
    pl = SH.named(_grid(shape), spec)
    got = pl.indices(dims)
    want = jax_index_maps[f"{shape}-{case}"]
    cells = [(i, j) for i in range(shape[0]) for j in range(shape[1])]
    assert [[[s.start, s.stop] for s in got[c]] for c in cells] == want
    x = torch.randn(dims, generator=torch.Generator().manual_seed(case))
    placed = pl.place(x)
    assert torch.equal(placed.gather(), x)
    for c in cells:
        assert torch.equal(placed.block(*c), x[got[c]])


def test_replicated_blocks_are_shared_on_one_device():
    """Cells with one device and one index range share a block: a (2, 2)
    grid of one device holds a replicated weight once, a model-split one
    twice, a fully split one four times; `map` keeps the sharing."""
    grid = _grid((2, 2))
    x = torch.arange(16.0).reshape(4, 4)
    for spec, distinct in (((), 1), ((None, "model"), 2),
                           (("data", "model"), 4)):
        s = SH.named(grid, spec).place(x)
        assert len(s.tensors()) == distinct
        assert len(s.map(torch.zeros_like).tensors()) == distinct
        assert torch.equal(s.gather(), x)


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_each_row_reads_its_own_replica(shape):
    """On a grid of distinct devices a weight replicated over "data" is
    one block per data row (`replicas`); `ranges(device, row)` picks, per
    range, the block on `device`, else one of row `row`, else the range's
    first, and `gather` reads those blocks, whatever the row."""
    n = shape[0] * shape[1]
    grid = SH.DeviceGrid(tuple(torch.device("cpu", i) for i in range(n)),
                         shape)
    x = torch.arange(32.0).reshape(4, 8)
    s = SH.named(grid, (None, "model")).place(x)
    assert [len(held) for held in s.replicas()] == [shape[0]] * shape[1]
    for r in range(shape[0]):
        got = s.ranges(grid.device(r, 0), r)
        assert all(blk is s.block(r, j) for j, (_, blk) in enumerate(got))
        assert torch.equal(s.gather(grid.device(r, 0), row=r), x)
    split = SH.named(grid, ("data", None)).place(x)
    assert [len(held) for held in split.replicas()] == [shape[1]] * shape[0]
    got = split.ranges(grid.device(0, 0), 0)
    assert all(blk is split.block(i, 0) for i, (_, blk) in enumerate(got))


def test_uneven_split_raises_as_jax_does():
    with pytest.raises(ValueError, match="does not divide"):
        SH.named(_grid((4, 2)), ("data",)).indices((6, 2))


def test_tree_named_binds_every_spec():
    cfg = registry.get_config("qwen3-1.7b")
    grid = _grid((4, 2))
    spec = build_model(cfg).param_spec(SH.rules_for(cfg, "fsdp", grid))
    placed = SH.tree_named(grid, spec)
    leaves = tree_leaves(placed)
    assert all(isinstance(p, SH.Placement) for p in leaves)
    assert [p.spec for p in leaves] == tree_leaves(spec, is_leaf=SH.is_spec)
