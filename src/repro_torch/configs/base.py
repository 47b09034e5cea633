"""Model schema and parameter descriptions of the port's LM substrate
(counterpart of `repro.configs.base`).

Params are described by `PD` trees (shape, logical axes, init); `init_params`
materializes one from an explicit `torch.Generator`, `abstract_params`
describes one on the meta device (no allocation), and `spec_tree` maps the
logical axes onto mesh-axis names through a rule table (`DEFAULT_RULES`,
`FSDP_RULES`). The specs lay parameters over a `DeviceGrid`
(`distributed.sharding.tree_named`): `launch/specs.py::lm_cell` and the
grid `Trainer` read them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.device import resolve_device

__all__ = ["ModelConfig", "PortConfig", "ShapeSpec", "PD", "init_params",
           "spec_tree", "abstract_params", "DEFAULT_RULES", "FSDP_RULES",
           "pad_to",
           "tree_leaves", "tree_map", "tree_unflatten", "spec_entry"]


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    """The fields of `repro.configs.base.ModelConfig`, with `dtype` a
    torch dtype. Of the lowering fields, `fsdp_constrain` casts each
    group's >= 2-D f32 weights to `dtype` at use (the reference casts
    before its FSDP gather) and `shmap_axes` runs the MoE blocks per data
    shard and per model shard of the expert hidden dim (`models.moe`);
    `scan_unroll` is accepted and changes nothing: the reference unrolls
    its layer scan for XLA's cost analysis, and the port runs a Python
    loop over the groups either way."""
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # MoE
    num_experts: int = 0
    experts_per_token: int = 2
    moe_d_ff: int = 0              # 0 -> d_ff
    moe_period: int = 1            # MoE every `period` layers (jamba: 2)
    capacity_factor: float = 1.25
    moe_group_size: int = 2048
    # attention variants
    sliding_window: Optional[int] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    group_size: int = 1            # layers per stacked group
    # layer mixing (hybrid / ssm families)
    attn_layer_in_group: tuple = ()  # indices within group that are attention
    ssm_kind: Optional[str] = None  # "mamba" | "mlstm"
    slstm_layer_in_group: tuple = ()  # xlstm: indices that are sLSTM
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0               # 0 -> d_model // 16
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0           # stub frontend positions (frames)
    # vlm
    num_patches: int = 0
    norm_eps: float = 1e-5
    norm_kind: str = "rmsnorm"     # rmsnorm | layernorm
    act: str = "silu"              # silu (swiglu) | gelu (plain mlp)
    tie_embeddings: bool = False
    max_seq_len: int = 524288
    dtype: Any = torch.bfloat16
    tp_pad_heads: int = 16         # pad head count to a multiple of this
    vocab_pad: int = 256
    mlstm_chunk: int = 256
    mamba_chunk: int = 512
    kv_block: int = 1024           # KV block of the plain blockwise path
    logits_f32: bool = True        # False: bf16 vocab matmul, f32 accum
    # accepted for the reference's configs; no effect (see the docstring)
    scan_unroll: bool = False
    # cast each group's >= 2-D f32 weights to `dtype` at use, as the
    # reference does before its FSDP all-gather (lm_cell sets it for fsdp)
    fsdp_constrain: bool = False
    # MoE blocks per (data axes, model axis) shard, e.g. (("data",),
    # "model"): tokens routed per data shard, the expert hidden dim split
    # over the model shards (lm_cell sets it for MoE configs)
    shmap_axes: tuple = ()
    # recompute in the backward pass, per layer group, in train mode with
    # grad on: none | block | full (save nothing) | dots (save the
    # projections' matmul outputs)
    remat: str = "block"

    # the port's own switches, fields of `PortConfig` only; here they
    # read as the JAX package's semantics
    rope = True
    ssm_dbc_norm = False
    moe_dropless = False
    moe_renorm = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_heads(self) -> int:
        """Q heads padded to a multiple of `tp_pad_heads`; padded heads
        have zero rows in wo, so the math is exact."""
        return pad_to(self.num_heads, self.tp_pad_heads)

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, self.vocab_pad)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)

    @property
    def num_groups(self) -> int:
        if self.num_layers % self.group_size:
            raise ValueError(f"{self.num_layers} layers are not a multiple "
                             f"of the group size {self.group_size}")
        return self.num_layers // self.group_size

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class PortConfig(ModelConfig):
    """A `ModelConfig` with the switches of architectures that the JAX
    package does not have. `ModelConfig` keeps the reference's schema
    field for field, and reads each switch below at its default, which is
    the reference's semantics:

      * `rope`: rotary embedding on self-attention's q and k (Jamba's
        attention has no positional encoding, arXiv:2403.19887 §2);
      * `ssm_dbc_norm`: RMSNorm (weights, `norm_eps`) on the Mamba mixer's
        dt, B and C after `x_proj` (HF `JambaMambaMixer`'s dt/b/c
        layernorms);
      * `moe_dropless`: the MoE FFN routes real tokens only, with no
        capacity (`models.moe.apply_moe_dropless`);
      * `moe_renorm`: the top-k gates divided by their sum (Mixtral);
        HF `JambaSparseMoeBlock` keeps the softmax weights as they are.
    """
    rope: bool = True
    ssm_dbc_norm: bool = False
    moe_dropless: bool = False
    moe_renorm: bool = True


@dataclass(frozen=True)
class ShapeSpec:
    """One (input-shape) cell of the shape grid (`configs.shapes`)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


@dataclass(frozen=True)
class PD:
    """One parameter: shape, logical axis names, init kind and scale
    (0 -> 1/sqrt(shape[0]), or 0.02 for "embed")."""
    shape: tuple
    axes: tuple
    init: str = "normal"   # normal | zeros | ones | embed
    scale: float = 0.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_leaves(tree, is_leaf=None) -> list:
    """Leaves of a nest of dicts, lists and tuples, in JAX's order (dict
    keys sorted), so that a leaf's index matches `jax.tree.leaves`."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t, is_leaf)]
    return [tree]


def tree_map(fn, tree, *rest, is_leaf=None):
    """`fn` over the leaves of `tree` (and the matching leaves of `rest`),
    in `tree_leaves` order, keeping its dicts, lists, tuples and
    NamedTuples."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, t in enumerate(tree)]
        if hasattr(tree, "_fields"):  # NamedTuple
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """`like`'s structure over `leaves`, taken in `tree_leaves` order (the
    inverse of `tree_leaves`)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def _is_pd(x) -> bool:
    return isinstance(x, PD)


def _leaf_init(pd: PD, generator: torch.Generator, dtype, device):
    if pd.init == "zeros":
        return torch.zeros(pd.shape, dtype=dtype, device=device)
    if pd.init == "ones":
        return torch.ones(pd.shape, dtype=dtype, device=device)
    scale = pd.scale or (1.0 / max(pd.shape[0], 1) ** 0.5)
    if pd.init == "embed":
        scale = pd.scale or 0.02
    x = torch.randn(pd.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return x.mul_(scale).to(device=device, dtype=dtype)


def init_params(desc, generator: torch.Generator, dtype=torch.float32,
                device="cuda"):
    """Materialize a PD tree with the scales of the JAX package's
    `_leaf_init`. Normal leaves are drawn from `generator` (on its own
    device) in JAX's leaf order; the values differ from `jax.random`'s,
    so tests carry JAX's parameters over with `models.params`."""
    dev = resolve_device(device)
    return tree_map(lambda pd: _leaf_init(pd, generator, dtype, dev), desc,
                    is_leaf=_is_pd)


def abstract_params(desc, dtype=torch.float32):
    """The PD tree as tensors on the meta device: each leaf's shape and
    `dtype`, no storage (the counterpart of the reference's
    `jax.ShapeDtypeStruct` tree)."""
    return tree_map(lambda pd: torch.empty(pd.shape, dtype=dtype,
                                           device="meta"),
                    desc, is_leaf=_is_pd)


# Logical-axis -> mesh-axis rule tables (the reference's). None =
# replicated.
DEFAULT_RULES = {
    None: None,
    "embed": None,          # d_model
    "heads": "model",
    "kv": None,             # kv heads replicated (GQA, kv << tp)
    "mlp": "model",
    "vocab": "model",
    "expert": None,         # expert count dim (E small) -- TP inside expert
    "expert_mlp": "model",
    "inner": "model",       # ssm/mlstm inner dim
    "layers": None,         # stacked group dim
    "stage": None,
    "dv": "model",          # mlstm value dim
    "conv": None,
    "state": None,
}

# FSDP variant: the d_model dim of big weights sharded over the data axis
FSDP_RULES = dict(DEFAULT_RULES, embed="data")


def spec_entry(axes):
    """One dimension's mesh axes as `PartitionSpec` holds them: a tuple of
    one name becomes the name, an empty tuple None."""
    if isinstance(axes, (tuple, list)):
        axes = tuple(axes)
        return None if not axes else axes[0] if len(axes) == 1 else axes
    return axes


def spec_tree(desc, rules=DEFAULT_RULES):
    """For each PD leaf, a tuple of one mesh-axis name (or None, or a
    tuple of names) per dimension: what `tuple(PartitionSpec(...))`
    holds in the reference."""
    return tree_map(
        lambda pd: tuple(spec_entry(rules.get(a, None)) for a in pd.axes),
        desc, is_leaf=_is_pd)
