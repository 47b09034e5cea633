"""AI21-Jamba2-Mini in the port (`configs/jamba2_mini.py`, a `PortConfig`)
against the plain reference (`portbench/reference/jamba.py`: float32,
one review at a time, the sequential scan), on the CPU at a tiny size with
seeded weights; the fused scan and the whole period at published widths
on the card (marked `cuda`).

Tolerances. In f32 the port and the reference do the same arithmetic in
another order (blocked products, the chunked scan's log-depth sums, the
flash attention's running max), so each review's feature agrees within
F32_TOL = 2e-6 of its norm (measured 3.6e-7 to 4.5e-7). That is tight
enough that every planted fault below moves at least one review by more
(eps 1e-5 for 1e-6 moves the least). In bf16 the port rounds every
activation to 8 bits of mantissa, through 8 layers: the median review
within BF16_MEDIAN = 3e-2 of its norm (measured 1.1e-2), every review
within BF16_MAX = 1.5e-1 (measured up to 6.4e-2: a routing choice that
flips near a tie moves a short review by O(1) of one token's share).
"""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch import ValuationSession, tracing
from repro_torch.configs.registry import get_config
from repro_torch.kernels.selective_scan import (
    selective_scan_cuda, selective_scan_plain)
from repro_torch.models import build_model
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as S
from repro_torch.models.params import params_from_flat


def _load_reference():
    """The benchmark's plain reference (`portbench/reference/jamba.py`,
    torch and math alone), loaded by its path."""
    path = (Path(__file__).resolve().parents[1] / "portbench" / "reference"
            / "jamba.py")
    spec = importlib.util.spec_from_file_location("_jamba2_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


R = _load_reference()

F32_TOL = 2e-6
BF16_MEDIAN = 3e-2
BF16_MAX = 1.5e-1
SEED = 2_147_483_659
SIZES = dict(d_model=64, layers=8, heads=4, kv_heads=2, head_dim=16,
             d_ff=96, vocab=512, experts=4, top_k=2, d_state=16, d_conv=4,
             expand=2, dt_rank=8, eps=1e-6, attn_offset=4, attn_period=8,
             expert_offset=1, expert_period=2, head=True)
LENGTHS = (5, 17, 30, 1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one thread for this module: the tiny model is thousands of
    small ops, which threads on cores shared by a parallel test run slow
    many times over."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tiny(dtype=torch.float32, **kw):
    return get_config("jamba2-mini").replace(
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=512, num_experts=4, dt_rank=8, dtype=dtype,
        **kw)


@pytest.fixture(scope="module")
def weights():
    return R.draw_weights(SIZES, SEED, "cpu")


@pytest.fixture(scope="module")
def reviews():
    gen = torch.Generator().manual_seed(7)
    return [torch.randint(0, SIZES["vocab"], (n,), generator=gen)
            for n in LENGTHS]


@pytest.fixture(scope="module")
def ref(weights, reviews):
    return torch.stack([R.embed(weights, SIZES, t) for t in reviews])


def padded(reviews, extra=3):
    """(B, L) ids right-padded with -1 and their lengths."""
    tok = torch.full((len(reviews), max(map(len, reviews)) + extra), -1)
    for r, t in enumerate(reviews):
        tok[r, :len(t)] = t
    return tok, (tok >= 0).sum(1)


def port_embed(cfg, weights, reviews, extra=3, lengths=True):
    params = params_from_flat(cfg, {k: v.to(cfg.dtype)
                                    for k, v in weights.items()})
    tok, lens = padded(reviews, extra)
    batch = ({"tokens": tok, "lengths": lens} if lengths
             else {"tokens": tok.clamp_min(0)})
    return build_model(cfg).embed(params, batch)


def gaps(got, want):
    return ((got - want).norm(dim=1) / want.norm(dim=1)).tolist()


def bf16_close(got, want) -> bool:
    g = sorted(gaps(got, want))
    return g[(len(g) - 1) // 2] < BF16_MEDIAN and g[-1] < BF16_MAX


def test_the_config_is_the_published_one():
    c = get_config("jamba2-mini")
    assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.hd,
            c.d_ff, c.vocab_size) == (32, 4096, 32, 8, 128, 14336, 65536)
    assert (c.num_experts, c.experts_per_token, c.moe_period) == (16, 2, 2)
    assert (c.group_size, c.attn_layer_in_group, c.ssm_state_dim,
            c.ssm_conv_dim, c.d_inner, c.dt_rank_) == (8, (4,), 16, 4,
                                                       8192, 256)
    assert c.norm_eps == 1e-6 and not c.tie_embeddings
    assert (c.rope, c.ssm_dbc_norm, c.moe_dropless, c.moe_renorm) == \
        (False, True, True, False)
    assert get_config("jamba-v0.1-52b").rope  # the JAX package's semantics


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_embed_matches_the_reference(weights, reviews, ref, dtype):
    got = port_embed(tiny(dtype), weights, reviews)
    assert got.dtype == torch.float32 and got.shape == (4, 64)
    if dtype == torch.float32:
        assert max(gaps(got, ref)) < F32_TOL
    else:
        assert bf16_close(got, ref), gaps(got, ref)


def test_prefill_matches_the_reference(weights, reviews):
    cfg = tiny()
    params = params_from_flat(cfg, dict(weights))
    for t in reviews[:2]:
        logits, _ = build_model(cfg).prefill(params, {"tokens": t[None]})
        want = R.last_logits(weights, SIZES, t)
        got = logits[0, 0, :SIZES["vocab"]]
        assert float((got - want).norm() / want.norm()) < F32_TOL


FAULTS = {
    "rope_on": dict(rope=True),
    "norms_off": dict(ssm_dbc_norm=False),
    "eps_1e-5": dict(norm_eps=1e-5),
    "gates_renormalised": dict(moe_renorm=True),
    "capacity_drops": dict(moe_dropless=False, capacity_factor=1.25,
                           moe_group_size=16),
}


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["pooled_over_padding"])
def test_each_mechanism_planted_wrong_fails(weights, reviews, ref, fault):
    if fault == "pooled_over_padding":
        got = port_embed(tiny(), weights, reviews, lengths=False)
    else:
        got = port_embed(tiny(**FAULTS[fault]), weights, reviews)
    assert max(gaps(got, ref)) > 5 * F32_TOL, fault


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_right_padding_leaves_real_rows_bit_equal(weights, reviews, dtype):
    cfg = tiny(dtype)
    a = port_embed(cfg, weights, reviews, extra=1)
    b = port_embed(cfg, weights, reviews, extra=40)
    assert torch.equal(a, b)


def test_dropless_moe_equals_a_per_token_loop():
    cfg = tiny()
    gen = torch.Generator().manual_seed(3)
    p = {"router": torch.randn(64, 4, generator=gen) / 8,
         "w1": torch.randn(4, 64, 96, generator=gen) / 8,
         "w3": torch.randn(4, 64, 96, generator=gen) / 8,
         "w2": torch.randn(4, 96, 64, generator=gen) / 10}
    x = torch.randn(3, 11, 64, generator=gen)
    mask = torch.arange(11)[None, :] < torch.tensor([11, 4, 0])[:, None]
    out, aux = MOE.apply_moe_dropless(p, x, cfg, mask)
    want = torch.zeros_like(x)
    for b in range(3):
        for s in range(11):
            if not mask[b, s]:
                continue
            probs = torch.softmax(x[b, s] @ p["router"], -1)
            gates, idx = torch.topk(probs, 2)
            for g, e in zip(gates, idx):
                h = torch.nn.functional.silu(x[b, s] @ p["w1"][e]) * (
                    x[b, s] @ p["w3"][e])
                want[b, s] += g * (h @ p["w2"][e])
    assert float((out - want).abs().max()) < 1e-6 * float(want.abs().max())
    assert torch.equal(out[~mask], torch.zeros_like(out[~mask]))
    assert math.isfinite(float(aux))


def test_counters_count_only_while_the_profiler_records(weights, reviews):
    cfg = tiny()
    tracing.counters()
    port_embed(cfg, weights, reviews)
    assert tracing.counters() == {}
    tok, lens = padded(reviews)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        port_embed(cfg, weights, reviews)
    got = tracing.counters()
    assert got["lm.tokens"] == sum(LENGTHS)
    assert got["lm.positions"] == tok.numel()
    # 4 MoE layers, 2 choices per real token
    assert len(got["lm.routed"]) == 4 and sum(got["lm.routed"]) == \
        4 * 2 * sum(LENGTHS)
    assert tracing.counters() == {}


def test_a_session_embeds_test_batches_only(weights, reviews):
    """`embed_train=False`: train features given embedded, each test
    batch of padded ids through `embed_fn`; the same values as a session
    fed the features."""
    cfg = tiny()
    params = params_from_flat(cfg, dict(weights))
    model = build_model(cfg)

    def embed_fn(ids):
        return model.embed(params, {"tokens": ids,
                                    "lengths": (ids >= 0).sum(1)})

    gen = torch.Generator().manual_seed(5)
    xt, yt = torch.randn(50, 64, generator=gen), torch.randint(0, 3, (50,))
    tok, _ = padded(reviews)
    yb = torch.tensor([0, 1, 2, 1])
    a = ValuationSession(xt, yt, k=3, mode="knn_shapley", test_batch=4,
                         embed_fn=embed_fn, embed_train=False, device="cpu")
    a.update(tok, yb)
    b = ValuationSession(xt, yt, k=3, mode="knn_shapley", test_batch=4,
                         device="cpu")
    b.update(embed_fn(tok), yb)
    assert torch.equal(a.finalize().point_values, b.finalize().point_values)


def test_every_mamba_parameter_gets_a_gradient():
    """The Mamba mixer with the dt/B/C norms under autograd (the chunked
    scan, which training takes on every device): every parameter and the
    input get a finite gradient that is not all zero."""
    from repro_torch.configs.base import init_params, tree_leaves

    cfg = tiny()
    params = init_params(S.mamba_desc(cfg), torch.Generator().manual_seed(3),
                         device="cpu")
    leaves = tree_leaves(params)
    x = torch.randn((2, 9, cfg.d_model),
                    generator=torch.Generator().manual_seed(4))
    for t in leaves + [x]:
        t.requires_grad_(True)
    y, _ = S.mamba_forward(params, x, cfg)
    grads = torch.autograd.grad((y * y).sum(), leaves + [x])
    assert "dt_norm" in params and len(grads) == len(leaves) + 1
    for g in grads:
        assert bool(torch.isfinite(g).all()) and bool(g.any())


@pytest.mark.parametrize("with_state", [False, True])
def test_the_scan_oracle_is_the_chunked_scan(with_state):
    """`selective_scan_plain` (the kernel's oracle) against the mixer's
    chunked scan on the CPU, full length; and stopped at a row's length,
    its state there and zeros past it."""
    cfg = tiny().replace(mamba_chunk=8)
    gen = torch.Generator().manual_seed(11)
    b, s, di, ds = 2, 21, 128, 16
    x, z, dt = (torch.randn(b, s, di, generator=gen) for _ in range(3))
    A = -torch.exp(torch.randn(di, ds, generator=gen) / 4)
    B, C = torch.randn(b, s, ds, generator=gen), torch.randn(b, s, ds,
                                                             generator=gen)
    D = torch.randn(di, generator=gen)
    h0 = torch.randn(b, di, ds, generator=gen) if with_state else None
    y, h = selective_scan_plain(x, z, dt, A, B, C, D, h0)
    dtf = torch.nn.functional.softplus(dt)
    hc = torch.zeros(b, di, ds) if h0 is None else h0
    ys = []
    for c0 in range(0, s, cfg.mamba_chunk):
        sl = slice(c0, c0 + cfg.mamba_chunk)
        h_all = S._scan_chunk(hc, torch.exp(dtf[:, sl, :, None] * A),
                              (dtf * x)[:, sl, :, None] * B[:, sl, None, :])
        hc = h_all[:, -1]
        ys.append((h_all * C[:, sl, None, :]).sum(-1))
    want = (torch.cat(ys, 1) + x * D) * torch.nn.functional.silu(z)
    assert torch.allclose(y, want, atol=1e-4, rtol=1e-4)
    assert torch.allclose(h, hc, atol=1e-4, rtol=1e-4)
    lens = torch.tensor([9, 21])
    y2, h2 = selective_scan_plain(x, z, dt, A, B, C, D, h0, lens)
    y9, h9 = selective_scan_plain(x[:1, :9], z[:1, :9], dt[:1, :9], A,
                                  B[:1, :9], C[:1, :9], D,
                                  None if h0 is None else h0[:1])
    assert torch.equal(y2[0, :9], y9[0]) and torch.equal(h2[0], h9[0])
    assert torch.equal(y2[0, 9:], torch.zeros_like(y2[0, 9:]))
    assert torch.equal(y2[1], y[1]) and torch.equal(h2[1], h[1])


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("length", [1, 17, 512, 1536])
def test_the_fused_scan_matches_the_chunked_scan_and_the_recurrence(
        cuda, length):
    """d_inner 8192, bf16 x, z and dt, f32 state: the kernel against the
    recurrence on the same inputs (f32, within 2e-3 of the largest |y|:
    y is written in bf16) and against the chunked path (s > 1); with a
    second row stopped at half its length."""
    gen = torch.Generator(device=cuda).manual_seed(length)
    b, di, ds = 2, 8192, 16
    # x and z the halves of one (b, s, 2 di) tensor, as in_proj gives them
    x, z = torch.randn(b, length, 2 * di, generator=gen, device=cuda).to(
        torch.bfloat16).chunk(2, dim=-1)
    dt = (torch.randn(b, length, di, generator=gen, device=cuda) - 3).to(
        torch.bfloat16)
    A = -torch.arange(1, ds + 1, device=cuda, dtype=torch.float32).expand(
        di, ds).contiguous()
    B, C = (torch.randn(b, length, ds, generator=gen, device=cuda)
            for _ in range(2))
    D = torch.ones(di, device=cuda)
    lens = torch.tensor([length, max(1, length // 2)], device=cuda)
    before = selective_scan_cuda.launches
    y, h = selective_scan_cuda(x, z, dt, A, B, C, D, None, lens)
    torch.cuda.synchronize()
    assert selective_scan_cuda.launches == before + 1
    yw, hw = selective_scan_plain(x, z, dt, A, B, C, D, None, lens)
    top = float(yw.float().abs().max())
    assert float((y.float() - yw.float()).abs().max()) <= 2e-3 * top
    assert float((h - hw).abs().max()) <= 1e-4 * float(hw.abs().max())
    if length > 1:
        # the chunked path alone (the CPU's), on the card's tensors
        chunk = 512
        dtf = torch.nn.functional.softplus(dt).float()
        st = torch.zeros(b, di, ds, device=cuda)
        ys = []
        for c0 in range(0, length, chunk):
            sl = slice(c0, c0 + chunk)
            h_all = S._scan_chunk(
                st, torch.exp(dtf[:, sl, :, None] * A),
                (dtf * x.float())[:, sl, :, None] * B[:, sl, None, :])
            st = h_all[:, -1]
            ys.append((h_all * C[:, sl, None, :]).sum(-1))
        yc = ((torch.cat(ys, 1) + x.float() * D)
              * torch.nn.functional.silu(z.float()))
        yk, _ = selective_scan_cuda(x, z, dt, A, B, C, D)
        assert float((yk.float() - yc).abs().max()) <= 2e-2 * float(
            yc.abs().max())


@pytest.mark.cuda
def test_the_period_on_the_card_matches_the_reference(cuda):
    """One period at published widths (8 layers, d 4096, 16 experts of
    14336), bf16 weights drawn on the card, 2 short reviews: the port's
    `Model.embed` (bf16, the fused scan under `lm.scan`) against the f32
    reference, within BF16_MEDIAN and BF16_MAX; 7 scan launches; no
    (b, s, 8192, 16) tensor (the embed's peak over the weights stays
    under one such f32 tensor)."""
    sizes = dict(SIZES, d_model=4096, heads=32, kv_heads=8, head_dim=128,
                 d_ff=14336, vocab=65536, experts=16, dt_rank=256,
                 head=False)
    w = R.draw_weights(sizes, SEED, cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    reviews = [torch.randint(0, 65536, (n,), generator=gen, device=cuda)
               for n in (40, 23)]
    want = torch.stack([R.embed(w, sizes, t) for t in reviews])
    cfg = get_config("jamba2-mini").replace(num_layers=8)
    params = params_from_flat(cfg, w)
    tok, lens = padded([t.cpu() for t in reviews])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = selective_scan_cuda.launches
    got = build_model(cfg).embed(params, {"tokens": tok.to(cuda),
                                          "lengths": lens.to(cuda)})
    torch.cuda.synchronize()
    assert selective_scan_cuda.launches == before + 7
    assert torch.cuda.max_memory_allocated() - base < 2 * 43 * 8192 * 16 * 4
    assert bf16_close(got, want), gaps(got, want)


@pytest.mark.cuda
def test_a_jamba_trainer_step_on_the_card_matches_the_cpu(cuda):
    """One group of reduced jamba-v0.1 (Mamba, attention and the MoE, f32,
    its stacked matrices at the fan-in scale), a 1 x 32 batch: the
    `Trainer`'s loss and every gradient leaf on the card against the
    CPU's. The fused scan has no backward, so training on the card runs
    the chunked scan (no launch) and every Mamba parameter gets its
    gradient; then a whole `Trainer.step` on the card. Tolerances: f32 on
    both sides, the same products summed in other orders through 8
    layers: the loss within 1e-5 of itself, each leaf within 1e-3 of its
    largest entry (a parameter cut off from the loss would not reach
    this line: `torch.autograd.grad` raises)."""
    from repro_torch.configs.base import PD, tree_leaves, tree_map
    from repro_torch.launch.train import reduced_config, synthetic_batch
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = reduced_config(get_config("jamba-v0.1-52b")).replace(num_layers=8)
    tcfg = TrainerConfig(steps=1)
    host = Trainer(cfg, tcfg, device="cpu")
    params, _ = host.init_state(0)
    for p, pd in zip(tree_leaves(params), tree_leaves(
            host.model.desc(), is_leaf=lambda x: isinstance(x, PD))):
        if (pd.init == "normal" and not pd.scale and pd.axes[0] == "layers"
                and len(pd.shape) >= 3):
            p.mul_((pd.shape[0] / pd.shape[-2]) ** 0.5)
    batch = synthetic_batch(cfg, 0, 1, 32)
    loss_cpu, _, grads_cpu = host._gradients(params, batch)

    card = Trainer(cfg, tcfg, device=cuda)
    on_card = tree_map(lambda t: t.to(cuda), params)
    batch_card = {k: v.to(cuda) for k, v in batch.items()}
    before = selective_scan_cuda.launches
    loss, _, grads = card._gradients(on_card, batch_card)
    torch.cuda.synchronize()
    assert selective_scan_cuda.launches == before
    assert abs(float(loss) - float(loss_cpu)) <= 1e-5 * abs(float(loss_cpu))
    assert len(grads) == len(grads_cpu)
    for g, w in zip(grads, grads_cpu):
        assert float((g.cpu() - w).abs().max()) <= 1e-3 * float(
            w.abs().max())
    _, opt_state = card.init_state(0)
    _, _, metrics = card.step(on_card, opt_state, batch_card)
    assert math.isfinite(float(metrics["loss"]))
