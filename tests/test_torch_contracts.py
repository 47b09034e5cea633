"""The port's reprolint, layer 2: the contract checker is clean on the live
registries, and each code C101-C601 fires on a deliberately broken entry
that the test registers and then removes. On a CUDA card (the test marked
`cuda`, skipped elsewhere) the whole checker runs the hand-written kernels:
    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_contracts.py -q
"""

import contextlib
import itertools

import pytest
import torch

import repro_torch  # noqa: F401 - registers the "cuda" fills
from repro_torch.analysis import contracts as C
from repro_torch.core import methods as M
from repro_torch.core import sti_knn as SK
from repro_torch.kernels import stream_kernels as SKN

N = 64
_names = (f"broken_{i}" for i in itertools.count())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    return torch.device("cuda")


def _codes(findings, where=""):
    return {f.code for f in findings if where in f.path}


@contextlib.contextmanager
def _registered(table: dict, register, fn):
    """A fill entry under a fresh name for the length of the block."""
    name = next(_names)
    register(name, fn)
    try:
        yield name
    finally:
        table.pop(name)


@contextlib.contextmanager
def _point_method(update, engines=("streamed",)):
    """A point method whose update is `update(state, u, axis)`, registered
    (with an ENGINES entry when `engines`) for the length of the block,
    under a fresh name: the step factories cache by name."""
    name = next(_names)

    def factory(method, k, opts, fill, fill_static, axis):
        def contrib(d2, order, match, mask):
            return match * mask[:, None]

        return SKN.UpdateKernel(method, SKN.POINT_STATE, False, None, contrib,
                                lambda state, u, g, ranks, mask:
                                update(state, u, axis))

    SKN.register_update_kernel(name, SKN.POINT_STATE, factory)
    if engines:
        M.ENGINES[name] = engines
    try:
        yield name
    finally:
        SKN._KERNEL_FACTORIES.pop(name)
        M.ENGINES.pop(name, None)


def _in_place(state, u, axis):
    if axis is None:
        state[0].add_(u.sum(0))
        return state
    for v, ui in zip(state[0], u):
        v.add_(ui.sum(0))
    return state


def test_checker_clean_on_live_registries():
    assert C.check_contracts(device="cpu") == []


def test_checker_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        C.check_fill_registries()


def test_c101_fires_on_a_wrong_dtype_fill():
    fn = lambda g, ranks: torch.zeros((N, N), dtype=torch.float64)  # noqa
    with _registered(SK._FILL_FNS, SK.register_fill_fn, fn) as name:
        got = C.check_fill_registries(device="cpu")
    assert _codes(got, f"fill/{name}") == {"C101"}
    assert "float64" in [f for f in got if name in f.path][0].message
    assert _codes(C.check_fill_registries(device="cpu")) == set()


@pytest.mark.parametrize("bad", ["copy", "untouched", "raises"])
def test_c102_fires_on_an_acc_fill_that_does_not_update_in_place(bad):
    fns = {
        "copy": lambda acc, g, r: acc + SK._FILL_FNS["xla"](g, r),
        "untouched": lambda acc, g, r: acc,
        "raises": lambda acc, g, r: acc.add_(g),
    }
    with _registered(SK._ACC_FILL_FNS, SK.register_acc_fill_fn,
                     fns[bad]) as name:
        got = C.check_fill_registries(device="cpu")
    assert _codes(got, f"acc_fill/{name}") == {"C102"}
    assert len(C.check_fill_registries(device="cpu")) == 0


def test_c103_fires_on_a_rect_fill_of_the_square_shape():
    fn = lambda g, rr, rc: torch.zeros((rc.shape[1], rc.shape[1]))  # noqa
    with _registered(SK._RECT_FILL_FNS, SK.register_rect_fill_fn,
                     fn) as name:
        got = C.check_fill_registries(device="cpu")
    assert _codes(got, f"rect_fill/{name}") == {"C103"}
    assert f"({N}, {N})" in [f for f in got if name in f.path][0].message


def test_c201_fires_on_a_step_that_reshapes_its_state():
    def shrink(state, u, axis):
        if axis is None:
            return (state[0][:-1],)
        return ([v[:-1] for v in state[0]],)

    with _point_method(shrink) as name:
        got = C.check_step_contracts(device="cpu")
    assert _codes(got, name) == {"C201"}
    assert {f.path for f in got} == {f"registry://step/{name}",
                                     f"registry://sharded_step/{name}"}


def test_c301_fires_on_an_out_of_place_update():
    def copy(state, u, axis):
        if axis is None:
            return (state[0] + u.sum(0),)
        return ([v + ui.sum(0) for v, ui in zip(state[0], u)],)

    with _point_method(copy) as name:
        got = C.check_step_ops(device="cpu")
    assert _codes(got, name) == {"C301"}
    msgs = " ".join(f.message for f in got)
    assert "from the state" in msgs and "data_ptr" in msgs


def test_c302_fires_on_a_copy_between_devices():
    def hop(state, u, axis):
        for ui in ([u] if axis is None else u):
            ui.to("meta")   # a transfer whose result is dropped
        return _in_place(state, u, axis)

    with _point_method(hop) as name:
        got = C.check_step_ops(device="cpu")
    # the single-device step only: the sharded one moves blocks by design
    assert {(f.code, f.path) for f in got} == {
        ("C302", f"registry://step/{name}")}


def test_c401_fires_on_a_step_that_branches_on_the_real_batch():
    def ragged(state, u, axis):
        parts = [u] if axis is None else u
        blocks = [state[0]] if axis is None else state[0]
        for v, ui in zip(blocks, parts):
            real = int((ui.sum(1) > 0).sum())
            v[:real].add_(ui.sum(0)[:real])
        return state

    with _point_method(ragged) as name:
        got = C.check_retrace_sentinel(device="cpu")
    assert _codes(got, name) == {"C401"}
    assert len([f for f in got if name in f.path]) == 2


def test_c501_fires_on_an_orphan_kernel_and_a_ghost_engine():
    with _point_method(_in_place, engines=None) as name:
        got = C.check_engine_table()
    assert {(f.code, f.path) for f in got} == {
        ("C501", f"registry://engines/{name}")}
    M.ENGINES["ghost"] = ("fused",)
    try:
        got = C.check_engine_table()
    finally:
        M.ENGINES.pop("ghost")
    assert {(f.code, f.path) for f in got} == {
        ("C501", "registry://engines/ghost")}


def test_c601_fires_on_a_megakernel_that_also_runs_the_distance(
        monkeypatch):
    from repro_torch.kernels import distance as D
    from repro_torch.kernels import sti_megakernel as MK

    plain = MK.point_megakernel_plain

    def also_distance(vec, xb, yb, mask, x_train, y_train, **kw):
        D.distance_cuda(xb, x_train)
        return plain(vec, xb, yb, mask, x_train, y_train, **kw)

    monkeypatch.setattr(MK, "point_megakernel_plain", also_distance)
    got = C.check_megakernel_contract(device="cpu")
    points = [m for m in SKN.stream_methods()
              if SKN.accumulator_spec(m).kind == "point"]
    assert {f.path for f in got} == {
        f"registry://{v}/{m}" for m in points
        for v in ("megakernel", "sharded_megakernel")}
    assert _codes(got) == {"C601"}
    assert "'distance': 1" in got[0].message


def test_c601_fires_on_a_method_the_megakernel_lacks():
    with _point_method(_in_place) as name:
        got = C.check_megakernel_contract(device="cpu")
    assert _codes(got, name) == {"C601"}


def test_entry_calls_count_plain_calls_only_under_the_checker():
    before = C.entry_calls()
    g, ranks = torch.randn(4, 16), torch.argsort(torch.rand(4, 16), dim=1)
    SK._ACC_FILL_FNS["cuda"](torch.zeros(16, 16), g, ranks)
    assert C.entry_calls() == before
    with C._entries():
        SK._ACC_FILL_FNS["cuda"](torch.zeros(16, 16), g, ranks)
    after = C.entry_calls()
    assert after["sti_fill_acc"] == before["sti_fill_acc"] + 1
    from repro_torch.kernels import sti_fill

    assert sti_fill.sti_fill_acc_plain.__name__ == "sti_fill_acc_plain"
    assert not hasattr(sti_fill.sti_fill_acc_plain, "__wrapped__")


@pytest.mark.cuda
def test_checker_clean_on_the_card(cuda):
    """The whole checker on the card: the fills, the three-stage steps and
    the megakernels launch the hand-written kernels at n = 64."""
    before = C.entry_calls()
    assert C.check_contracts(device="cuda") == []
    after = C.entry_calls()
    for name in C.ENTRIES:
        assert after[name] > before[name], name
