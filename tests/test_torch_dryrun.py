"""The port's dry run (`launch/{mesh,hlo_analysis,dryrun}.py`) on the CPU.

`model_flops` / `sti_model_flops` equal the reference's for every arch x
shape; the production grids' specs equal the reference's on
`jax.sharding.AbstractMesh`es of the same shape (no device needed); one
reduced-depth meta cell of each kind returns a record with the
reference's keys; each kernel wrapper's meta path (inside
`KERNELS.counting()`, the dry run's block) returns the kernel's shape and
adds exactly the `hlo_analysis` formulas, while CPU tensors, meta tensors
outside that block (and, in the tests marked `cuda`, card tensors) take
today's paths; and
`chip_smoke.py`'s bounds, now computed by `hlo_analysis`, are PERF.md's.
JAX is imported inside the reference tests only, so the `cuda` tests run
on the card's machine, which has no JAX:
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_dryrun.py -q
"""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import spec_tree, tree_leaves
from repro_torch.configs.shapes import SHAPES, shapes_for
from repro_torch.distributed import sharding as SH
from repro_torch.kernels.distance import distance_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.sti_fill import (
    sti_fill_acc_cuda, sti_fill_acc_rect_cuda)
from repro_torch.kernels.sti_megakernel import (
    point_megakernel_cuda, sti_megakernel_cuda)
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model

REPO = Path(__file__).resolve().parents[1]
ARCHS = sorted(registry.ARCHS)
META = torch.device("meta")
REF_KEYS = {"arch", "shape", "mesh", "chips", "strategy", "grad_accum",
            "remat", "tag", "compile_s", "memory_analysis", "collectives",
            "roofline"}
MEM_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    return torch.device("cuda")


def _jax():
    return pytest.importorskip("jax")


# ------------------------------------------------------- model FLOPs
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(arch):
    _jax()
    from repro.configs import registry as jregistry
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro.launch import hlo_analysis as JHA

    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    for shape in shapes_for(arch):
        assert HA.model_flops(cfg, shape) == JHA.model_flops(
            jcfg, JSHAPES[shape.name]), shape.name


def test_sti_model_flops_equal_the_reference():
    _jax()
    from repro.configs.registry import PAPER_WORKLOAD as JPAPER
    from repro.launch import hlo_analysis as JHA

    got = HA.sti_model_flops(registry.PAPER_WORKLOAD)
    assert got == JHA.sti_model_flops(JPAPER) == 2 * 4096 * 65536 * 768 + \
        3 * 4096 * 65536 ** 2


def test_roofline_fields_and_hw_keys_are_the_reference():
    _jax()
    import dataclasses

    from repro.launch import hlo_analysis as JHA

    assert [f.name for f in dataclasses.fields(HA.RooflineTerms)] == \
        [f.name for f in dataclasses.fields(JHA.RooflineTerms)]
    assert set(HA.HW) == set(JHA.HW)


# -------------------------------------------------- production grids
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("strategy", ["tp_dp", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_production_grid_specs_equal_the_reference(arch, strategy,
                                                   multi_pod):
    jax = _jax()
    from jax.sharding import AbstractMesh, PartitionSpec as P

    from repro.configs import registry as jregistry
    from repro.configs.base import spec_tree as jspec_tree
    from repro.distributed import sharding as JSH
    from repro.models import build_model as jbuild

    grid = make_production_mesh(multi_pod=multi_pod)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = AbstractMesh(shape, names)
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    assert SH.data_axes(grid) == JSH.data_axes(mesh)
    rules = SH.rules_for(cfg, strategy, grid)
    assert rules == JSH.rules_for(jcfg, strategy, mesh)
    for kind in ("train", "prefill", "decode"):
        assert SH.batch_spec(cfg, kind, grid) == {
            k: tuple(v) for k, v in JSH.batch_spec(jcfg, kind, mesh).items()}
    got = spec_tree(build_model(cfg).desc(), rules)
    want = jspec_tree(jbuild(jcfg).desc(), JSH.rules_for(jcfg, strategy,
                                                         mesh))
    assert tree_leaves(got, is_leaf=SH.is_spec) == [
        tuple(s) for s in jax.tree.leaves(
            want, is_leaf=lambda x: isinstance(x, P))]


def test_make_production_mesh_layouts():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.axis_sizes == {"data": 16, "model": 16}
    assert multi.axis_sizes == {"pod": 2, "data": 16, "model": 16}
    assert single.axis_names == ("data", "model")
    assert multi.axis_names == ("pod", "data", "model")
    assert set(single.devices) == set(multi.devices) == {META}
    assert multi.shape == (32, 16) and SH.data_size(multi) == 32
    # the data axes number the rows in order; "data" alone is replicated
    # over the pods, as a NamedSharding of the 3-D mesh reads
    rows = SH.named(multi, (("pod", "data"), None)).indices((64, 4))
    assert [rows[(i, 0)][0] for i in range(32)] == [
        slice(2 * i, 2 * i + 2) for i in range(32)]
    data = SH.named(multi, ("data", None)).indices((64, 4))
    assert data[(3, 5)][0] == data[(19, 0)][0] == slice(12, 16)
    devs = [torch.device("cpu", i) for i in range(256)]
    assert make_production_mesh(devices=devs).devices == tuple(devs)
    with pytest.raises(ValueError, match="needs 256 devices"):
        make_production_mesh(devices=devs[:4])
    with pytest.raises(ValueError, match="share a card"):
        make_production_mesh(devices=devs[:255] + devs[:1])


def test_placement_rejects_an_axis_the_grid_lacks():
    grid = SH.DeviceGrid(("cpu",) * 4, (2, 2))
    with pytest.raises(ValueError, match="names axis 'pod'"):
        SH.named(grid, (("pod", "data"), None))
    with pytest.raises(ValueError, match="twice"):
        SH.named(grid, ("data", "data"))
    cfg = registry.get_config("smollm-360m").replace(num_layers=1)
    model = build_model(cfg)
    bad_rules = dict(SH.rules_for(cfg, "tp_dp", grid), embed=("pod",))
    with pytest.raises(ValueError, match="lacks"):
        SH.place_tree(grid, model.param_spec(bad_rules), model.abstract())


def test_train_production_mesh_needs_256_devices():
    from repro_torch.launch.train import main

    with pytest.raises(ValueError, match="needs 256 devices"):
        main(["--device", "cpu", "--production-mesh", "--reduced",
              "--steps", "1"])


# --------------------------------------------------- meta cells
def _small_grid():
    return SH.DeviceGrid((META,) * 4, (2, 2))


@pytest.mark.parametrize("arch,shape", [
    ("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "prefill_32k"),
    ("qwen3-1.7b", "decode_32k"), ("sti-knn-paper", "valuation_step")])
def test_meta_cell_records_the_reference_keys(arch, shape, tmp_path):
    over = None if arch == "sti-knn-paper" else {"num_layers": 1}
    rec = run_cell(arch, shape, grid=_small_grid(), cfg_overrides=over,
                   out_dir=str(tmp_path), verbose=False)
    assert REF_KEYS <= set(rec)
    assert set(rec["memory_analysis"]) == MEM_KEYS
    assert set(rec["roofline"]) == {
        "flops_per_chip", "bytes_per_chip", "coll_bytes_per_chip",
        "t_compute", "t_memory", "t_collective", "bottleneck",
        "peak_memory_per_chip", "model_flops", "useful_ratio"}
    assert rec["mesh"] == "2x2" and rec["chips"] == 4
    assert rec["roofline"]["flops_per_chip"] > 0
    assert rec["collectives"]["total"] == sum(
        v for k, v in rec["collectives"].items() if k != "total")
    assert list(tmp_path.glob(f"{arch}__{shape}__2-2.json"))
    mem = rec["memory_analysis"]
    if shape == "train_4k":
        # params and both moments come back updated in place
        assert 0 < mem["alias_bytes"] <= mem["argument_bytes"]
        assert rec["collectives"]["all-reduce"] > 0
    if shape == "prefill_32k":
        assert rec["kernel_calls"] == {"flash_attention": 2}   # 1 a row
        assert mem["alias_bytes"] == 0
    if shape == "decode_32k":
        assert rec["collectives"]["collective-permute"] > 0
        assert mem["alias_bytes"] > 0      # the KV caches, in place
    if arch == "sti-knn-paper":
        n = registry.PAPER_WORKLOAD.n_train
        assert rec["kernel_calls"] == {"distance": 4, "rank_sort": 4,
                                       "sti_fill_acc_rect": 4}
        # psum over data: row 1's (n/2, n) partial into cell (0, j), and
        # its (n,) diagonal into cell (0, 0)
        want = n // 2 * n * 4 + n * 4
        assert rec["collectives"] == {"all-reduce": want, "total": want}


def test_argument_bytes_are_the_placed_blocks():
    """The fullest cell's argument bytes equal the bytes of the blocks
    placed for it (a (2, 2) grid of the CPU, real tensors)."""
    from repro_torch.launch import specs as SPEC
    from repro_torch.launch.dryrun import cell_memory

    cfg = registry.get_config("qwen3-1.7b").replace(
        num_layers=1, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256)
    shape = SHAPES["train_4k"].__class__("t", seq_len=8, global_batch=2,
                                         kind="train")
    grid = SH.DeviceGrid(("cpu",) * 4, (2, 2))
    _, args, in_specs, _ = SPEC.lm_cell(cfg, shape, grid, strategy="fsdp")
    real = [torch.zeros(a.shape, dtype=a.dtype)
            for a in tree_leaves(args)]
    it = iter(real)
    from repro_torch.configs.base import tree_map

    placed = SH.place_tree(grid, in_specs, tree_map(lambda a: next(it),
                                                    args))
    cell, mem = cell_memory(grid, placed, ())
    blocks = sum(s.block(*cell).numel() * s.block(*cell).element_size()
                 for s in tree_leaves(placed, is_leaf=lambda v: isinstance(
                     v, SH.Sharded)))
    assert mem["argument_bytes"] == blocks


MIB = 1 << 20


def _chain(x, w):
    """A step whose peak is known by hand: x (1 MiB f32) is updated in
    place and read through a view (no allocation), then two 1 MiB
    temporaries are live at once, then one and a 4-byte sum."""
    x.mul_(2.0)
    a = x.view(-1) + 1.0
    b = a * w.view(-1)
    del a
    return b.sum()


def _tanh_chain(x):
    """Ten tanh ops on a 1 MiB leaf under autograd, then backward. The
    ten outputs are saved for backward (10 MiB) with the 4-byte sum and
    its 4-byte seed gradient; the peak comes at the second step back:
    the first gradient (1 MiB) is live while the second (1 MiB) is made,
    and the last output is still held by `y`: 12 MiB + 8 bytes."""
    x = x.detach().requires_grad_(True)
    y = x
    for _ in range(10):
        y = torch.tanh(y)
    y.sum().backward()
    return x.grad


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("case,want", [("chain", 2 * MIB),
                                       ("tanh", 12 * MIB + 8)])
def test_count_step_peak_is_known_by_hand(case, want, device):
    """The dry run's peak of live bytes is exact for steps whose peak is
    counted by hand, on meta and on real CPU tensors alike; an argument
    updated in place or read through a view is not counted."""
    from repro_torch.launch.dryrun import count_step

    x = torch.zeros(MIB // 4, device=device)
    if case == "chain":
        step, args = _chain, (x, torch.ones(MIB // 4, device=device))
    else:
        step, args = _tanh_chain, (x,)
    _, count = count_step(step, args)
    assert count["peak_bytes"] == want


def _cpu_profiler_peak(step, args) -> int:
    """The CPU allocator's peak above what was allocated before `step`,
    from torch.profiler's memory events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        out = step(*args)
        del out
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "[memory]"), key=lambda e: e.start_ns())
    live = peak = 0
    for e in events:
        live += e.nbytes()
        peak = max(peak, live)
    return peak


@pytest.mark.parametrize("strategy", ["fsdp", "tp_dp"])
def test_meta_temp_bytes_track_the_cpu_allocator(strategy):
    """A reduced qwen3 train cell on a (2, 2) grid: the meta count's
    temp_bytes x cells_busy lies within chip_smoke.py [22d]'s bound of the
    CPU allocator's peak over the same step on placed zeros."""
    from repro_torch.configs.base import ShapeSpec, tree_map
    from repro_torch.launch import specs as SPEC

    over = dict(num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
                head_dim=64, d_ff=512, vocab_size=1024)
    shape = ShapeSpec("t", 64, 2, "train")
    rec = run_cell("qwen3-1.7b", shape, strategy=strategy,
                   grid=_small_grid(), cfg_overrides=over, verbose=False)
    cfg = registry.get_config("qwen3-1.7b").replace(**over)
    grid = SH.DeviceGrid(("cpu",) * 4, (2, 2))
    step, args, in_specs, _ = SPEC.lm_cell(cfg, shape, grid,
                                           strategy=strategy)
    placed = tree_map(lambda pl, a: pl.place(torch.zeros(
        a.shape, dtype=a.dtype)), SH.tree_named(grid, in_specs), args)
    peak = _cpu_profiler_peak(step, placed)
    meta = rec["memory_analysis"]["temp_bytes"] * rec["cells_busy"]
    lo, hi = _chip_smoke().TEMP_BYTES_BOUND
    assert lo <= meta / peak <= hi, (meta, peak)


# ------------------------------------------- the wrappers' meta path
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _wrapper_calls():
    t, n, d, nr = 8, 64, 12, 32
    ranks = _meta(t, n, dtype=torch.int64)
    return [
        ("distance", lambda: distance_cuda(_meta(t, d), _meta(n, d)),
         HA.distance_cost(t, n, d, 4), (t, n)),
        ("sti_fill_acc", lambda: sti_fill_acc_cuda(_meta(n, n), _meta(t, n),
                                                   ranks),
         HA.fill_cost(t, n), (n, n)),
        ("sti_fill_acc_rect", lambda: sti_fill_acc_rect_cuda(
            _meta(nr, n), _meta(t, n), ranks[:, :nr], ranks),
         HA.rect_fill_cost(t, nr, n), (nr, n)),
        ("sti_megakernel", lambda: sti_megakernel_cuda(
            _meta(n, n), _meta(n), _meta(t, d), _meta(t, dtype=torch.int32),
            _meta(t), _meta(n, d), _meta(n, dtype=torch.int32), k=3)[0],
         HA.sti_megakernel_cost(t, n, d), (n, n)),
        ("point_megakernel", lambda: point_megakernel_cuda(
            _meta(n), _meta(t, d), _meta(t, dtype=torch.int32), _meta(t),
            _meta(n, d), _meta(n, dtype=torch.int32), method="knn_shapley",
            k=3), HA.point_megakernel_cost(t, n, d), (n,)),
        ("flash_attention", lambda: flash_attention_cuda(
            *(_meta(2, 4, 16, 8, dtype=torch.bfloat16) for _ in range(3)),
            causal=True, window=4),
         HA.flash_cost(2, 4, 16, 16, 8, True, 4, 2), (2, 4, 16, 8)),
    ]


def _launches():
    return [distance_cuda.launches, sti_fill_acc_cuda.launches,
            sti_fill_acc_rect_cuda.launches, sti_megakernel_cuda.launches,
            point_megakernel_cuda.launches, flash_attention_cuda.launches]


@pytest.mark.parametrize("case", range(6))
def test_wrapper_meta_path_adds_the_formula(case):
    name, call, cost, shape = _wrapper_calls()[case]
    launches = _launches()
    with HA.KERNELS.counting():
        out = call()
    assert out.device == META and tuple(out.shape) == shape
    assert HA.KERNELS.calls == {name: 1}
    assert (HA.KERNELS.ops, HA.KERNELS.bytes) == (cost.ops, cost.bytes)
    assert _launches() == launches and not HA.KERNELS.active


@pytest.mark.parametrize("case", range(6))
def test_wrapper_meta_outside_the_dry_run_takes_the_kernel_path(case):
    """Outside `KERNELS.counting()` a meta tensor is a tensor off the
    CPU: it goes to the kernel, whose build raises here (no nvcc)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernels build")
    _, call, _, _ = _wrapper_calls()[case]
    with HA.KERNELS.counting():
        pass
    with pytest.raises(RuntimeError, match="nvcc"):
        call()
    assert HA.KERNELS.calls == {}


def test_wrappers_take_todays_cpu_path():
    from repro_torch.kernels.distance import distance_plain
    from repro_torch.kernels.sti_fill import (
        sti_fill_acc_plain, sti_fill_acc_rect_plain)

    gen = torch.Generator().manual_seed(0)
    xt, xn = torch.randn(5, 7, generator=gen), torch.randn(9, 7, generator=gen)
    g = torch.randn(5, 9, generator=gen)
    ranks = torch.argsort(torch.rand(5, 9, generator=gen), dim=1)
    launches = _launches()
    HA.KERNELS.reset()
    assert torch.equal(distance_cuda(xt, xn), distance_plain(xt, xn))
    assert torch.equal(sti_fill_acc_cuda(torch.zeros(9, 9), g, ranks),
                       sti_fill_acc_plain(torch.zeros(9, 9), g, ranks))
    assert torch.equal(
        sti_fill_acc_rect_cuda(torch.zeros(4, 9), g, ranks[:, 2:6], ranks),
        sti_fill_acc_rect_plain(torch.zeros(4, 9), g, ranks[:, 2:6], ranks))
    q = torch.randn(1, 2, 6, 4, generator=gen)
    assert flash_attention_cuda(q, q, q).shape == q.shape
    assert HA.KERNELS.calls == {} and _launches() == launches


@pytest.mark.cuda
def test_wrappers_take_todays_card_path(cuda):
    from repro_torch.kernels.distance import distance_plain

    xt = torch.randint(-8, 9, (33, 20), device=cuda).float()
    xn = torch.randint(-8, 9, (65, 20), device=cuda).float()
    HA.KERNELS.reset()
    before = distance_cuda.launches
    assert torch.equal(distance_cuda(xt, xn), distance_plain(xt, xn))
    assert distance_cuda.launches == before + 1
    assert HA.KERNELS.calls == {}


# --------------------------------------------- chip_smoke's bounds
def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_bounds_are_perf_md_s():
    """PERF.md section 6's bounds, through chip_smoke.py's helpers (now
    `hlo_analysis`): the printed values must not move."""
    cs = _chip_smoke()
    t, n, d = 256, 65536, 768
    cases = [
        (cs.distance_bound_ms(t, n, d, 4), 4, 0.0804, "bytes"),
        (cs.fill_bound_ms(t, n), 2, 49.36, "operations"),
        (cs.rect_fill_bound_ms(t, n // 4, n), 2, 21.54, "operations"),
        (cs.sti_megakernel_bound_ms(t, n, d), 2, 49.36, "operations"),
        (cs.point_megakernel_bound_ms(t, n, d), 4, 0.0606, "bytes"),
        (cs.flash_bound_ms(1, 16, 2048, 2048, 128, True, None, 2), 4,
         0.0174, "operations"),
        (cs.flash_bound_ms(1, 32, 8192, 8192, 128, True, 4096, 2), 4,
         0.4169, None),
        (cs.flash_bound_ms(4, 16, 1500, 1500, 64, False, None, 2), 4,
         0.0373, "operations"),
        (cs.flash_bound_ms(4, 16, 448, 1500, 64, False, None, 2), 4,
         0.0111, "operations"),
    ]
    for (ms, by), digits, want, want_by in cases:
        assert round(ms, digits) == want
        assert want_by is None or by == want_by
    assert math.isclose(cs.distance_ops_ms(t, n, d, 4),
                        1e3 * 2.0 * t * n * d / 495e12)
    assert cs.visible_pairs(4, 4, True, None) == 10
