"""The port's shape grid and parameter-description tools against the JAX
package: `configs.shapes`, `configs.registry.TRAIN_RECIPES`,
`configs.base.{ShapeSpec, abstract_params, spec_tree, DEFAULT_RULES,
FSDP_RULES}` and `Model.{abstract, param_spec}`, for every architecture
at its full size (nothing is allocated: the port's abstract tree lives on
the meta device, JAX's is ShapeDtypeStructs).
"""

import dataclasses
import types

import pytest
import torch

from repro_torch.configs import base, registry, shapes
from repro_torch.configs.base import tree_leaves
from repro_torch.models import build_model

ARCH_NAMES = sorted(registry.ARCHS)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from jax.sharding import PartitionSpec

    from repro.configs import base as jbase
    from repro.configs import registry as jregistry
    from repro.configs import shapes as jshapes
    from repro.models import build_model as jbuild

    return types.SimpleNamespace(jax=jax, P=PartitionSpec, base=jbase,
                                 registry=jregistry, shapes=jshapes,
                                 build=jbuild)


def _spec(s):
    return (s.name, s.seq_len, s.global_batch, s.kind)


def test_shape_grid_matches_the_jax_package(jx):
    assert [f.name for f in dataclasses.fields(base.ShapeSpec)] == \
        [f.name for f in dataclasses.fields(jx.base.ShapeSpec)]
    assert [_spec(s) for s in shapes.ALL_SHAPES] == \
        [_spec(s) for s in jx.shapes.ALL_SHAPES]
    assert {k: _spec(v) for k, v in shapes.SHAPES.items()} == \
        {k: _spec(v) for k, v in jx.shapes.SHAPES.items()}
    assert shapes.LONG_CAPABLE == jx.shapes.LONG_CAPABLE
    for name in (*ARCH_NAMES, "unknown-arch"):
        assert [_spec(s) for s in shapes.shapes_for(name)] == \
            [_spec(s) for s in jx.shapes.shapes_for(name)], name
    assert all(isinstance(s, base.ShapeSpec) for s in shapes.ALL_SHAPES)


def test_train_recipes_match_the_jax_package(jx):
    assert registry.TRAIN_RECIPES == jx.registry.TRAIN_RECIPES
    assert set(registry.TRAIN_RECIPES) == set(registry.ARCHS)


def test_new_config_fields_default_as_the_jax_package(jx):
    port = {f.name: f.default for f in dataclasses.fields(base.ModelConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(
        jx.base.ModelConfig)}
    for name in ("encoder_layers", "encoder_seq", "num_patches",
                 "max_seq_len", "scan_unroll", "fsdp_constrain",
                 "shmap_axes"):
        assert port[name] == ref[name], name
    # every field of the reference, the lowering fields included
    assert set(ref) == set(port)


def test_rule_tables_match_the_jax_package(jx):
    assert base.DEFAULT_RULES == jx.base.DEFAULT_RULES
    assert base.FSDP_RULES == jx.base.FSDP_RULES
    assert base.FSDP_RULES["embed"] == "data"


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_abstract_params_match_the_jax_package(jx, name):
    """Shapes and dtype leaf for leaf, on the meta device (no storage)."""
    model = build_model(registry.get_config(name))
    jmodel = jx.build(jx.registry.get_config(name))
    for dtype, jdtype in ((torch.float32, "float32"),
                          (torch.bfloat16, "bfloat16")):
        got = tree_leaves(model.abstract(dtype))
        want = jx.jax.tree.leaves(jmodel.abstract(getattr(jx.jax.numpy,
                                                          jdtype)))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.device.type == "meta" and g.dtype == dtype
            assert tuple(g.shape) == tuple(w.shape) and str(w.dtype) == jdtype
    assert sum(t.numel() for t in tree_leaves(model.abstract())) == \
        model.num_params()


def _spec_leaves(tree):
    return tree_leaves(tree, is_leaf=lambda x: isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x))


@pytest.mark.parametrize("rules", ["DEFAULT_RULES", "FSDP_RULES"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_spec_tree_matches_the_jax_partition_specs(jx, name, rules):
    """`param_spec` leaf for leaf equal to tuple(P) of the reference's."""
    model = build_model(registry.get_config(name))
    jmodel = jx.build(jx.registry.get_config(name))
    got = _spec_leaves(model.param_spec(getattr(base, rules)))
    want = jx.jax.tree.leaves(jmodel.param_spec(getattr(jx.base, rules)),
                              is_leaf=lambda x: isinstance(x, jx.P))
    assert len(got) == len(want) == len(tree_leaves(model.abstract()))
    assert got == [tuple(p) for p in want]
    for g, t in zip(got, tree_leaves(model.abstract())):
        assert len(g) == t.ndim


def test_spec_tree_of_a_bare_description():
    desc = {"w": base.PD((4, 8), ("embed", "mlp")),
            "b": [base.PD((8,), ("mlp",)), base.PD((2, 3), (None, "vocab"))]}
    assert base.spec_tree(desc) == {"b": [("model",), (None, "model")],
                                    "w": (None, "model")}
    assert base.spec_tree(desc, base.FSDP_RULES)["w"] == ("data", "model")
    meta = base.abstract_params(desc, torch.bfloat16)
    assert meta["w"].shape == (4, 8) and meta["w"].is_meta
