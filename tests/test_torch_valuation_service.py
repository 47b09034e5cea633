"""The port's online valuation service and its incremental-mutation
pipeline against the JAX package (CPU).

The contracts of tests/test_valuation_service.py, on the port
(`device="cpu"`, N = 48, capacity 56, d = 4, k = 5, test batch 8): query
parity with the offline engine, coalescing, shedding and expiry with an
injected clock, malformed requests, `remove_points` BIT-exact against the
full recompute of `cache_policy="off"` for sti, knn_shapley and wknn, zero
rank calls once the caches are warm, add parity within 2e-5 and the new
ids, version bumps, two-client interleavings, exactly-once resume, and the
8-shard chaos drill in process on `devices=["cpu"] * 8`.

Against the JAX package: `compact_order`, `make_rank_step` and
`make_refold_step` on integer features (orders and ranks bit-equal,
refolded states within 1e-6 of max |ref|), and one request script served
by both packages' services (statuses, ids, n_live and version equal;
values within 1e-6 of max |ref|, 1e-5 for wknn). The launchers are smoked
with `--device cpu`.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.methods import get_method
from repro_torch.distributed.fault_injection import Fault, FaultInjector
from repro_torch.kernels.stream_kernels import (
    SENTINEL_COORD,
    SENTINEL_LABEL,
    compact_order,
)
from repro_torch.kernels.sti_pipeline import (
    make_rank_step,
    make_refold_step,
    prepare_refold_step,
)
from repro_torch.serving.valuation_service import (
    AdmissionController,
    Request,
    ValuationService,
)

REPO = Path(__file__).resolve().parents[1]
N, T, D, K, TB = 48, 32, 4, 5, 8
CAP = 56
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's service and refold pipeline (skips where JAX is
    absent)."""
    pytest.importorskip("jax")
    import types

    import jax.numpy as jnp

    from repro.kernels import stream_kernels as jsk
    from repro.kernels import sti_pipeline as jpipe
    from repro.serving.valuation_service import (
        ValuationService as JService)

    return types.SimpleNamespace(jnp=jnp, sk=jsk, pipe=jpipe,
                                 Service=JService)


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, D)).astype(np.float32)
    y = rng.integers(0, 3, N).astype(np.int32)
    xt = rng.normal(size=(T, D)).astype(np.float32)
    yt = rng.integers(0, 3, T).astype(np.int32)
    return x, y, xt, yt


def _service(x, y, **kw):
    kw.setdefault("method", "knn_shapley")
    kw.setdefault("k", K)
    kw.setdefault("capacity", CAP)
    kw.setdefault("test_batch", TB)
    kw.setdefault("seed", 1)
    kw.setdefault("device", "cpu")
    return ValuationService(x, y, **kw)


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ------------------------------------------------------------ request API
def test_query_parity_with_offline_engine():
    x, y, xt, yt = _problem()
    svc = _service(x, y, method="sti")
    r = svc.value_query(xt, yt)
    assert r.ok and r.payload["t_seen"] == T
    gv = svc.get_values()
    offline = get_method("sti")(x, y, xt, yt, k=K, **CPU)
    np.testing.assert_allclose(gv.payload["values"],
                               _np(offline.values()), atol=1e-5)
    np.testing.assert_allclose(gv.payload["phi"], _np(offline.phi),
                               atol=1e-5)
    svc.close()


def test_coalescing_folds_queries_into_shared_chunks():
    x, y, xt, yt = _problem()
    svc = _service(x, y)
    rids = [svc.submit("value_query", x=xt[i:i + 4], y=yt[i:i + 4])
            for i in range(0, 16, 4)]
    resps = svc.drain()
    assert [r.status for r in resps] == ["ok"] * 4
    assert all(svc.poll(rid).payload["coalesced_with"] == 3 for rid in rids)
    # 16 points coalesced into 2 chunks of test_batch=8, not 4 folds of 4
    assert svc.health()["requests"]["coalesced"] == 3
    assert len(svc._log) == 2 and svc.t_seen == 16
    svc.close()


def test_admission_shedding_and_deadline_expiry():
    x, y, xt, yt = _problem()
    svc = _service(x, y, queue_limit=2)
    rids = [svc.submit("value_query", x=xt[:2], y=yt[:2]) for _ in range(4)]
    assert [svc.poll(r).status for r in rids[2:]] == ["shed", "shed"]
    assert svc.poll(rids[0]) is None          # still queued, not answered
    svc.drain()
    assert all(svc.poll(r).ok for r in rids[:2])
    # a request whose deadline passed in the queue answers "expired"
    rid = svc.submit("value_query", x=xt[:2], y=yt[:2], deadline_s=-1.0)
    svc.drain()
    assert svc.poll(rid).status == "expired"
    h = svc.health()
    assert h["admission"]["shed"] == 2 and h["admission"]["expired"] == 1
    assert h["status"] == "ok"
    svc.close()


def test_expiry_follows_an_injected_clock():
    x, y, xt, yt = _problem()
    now = {"t": 100.0}
    svc = _service(x, y, default_deadline_s=5.0, clock=lambda: now["t"])
    late = svc.submit("value_query", x=xt[:2], y=yt[:2])
    fresh = svc.submit("value_query", x=xt[2:4], y=yt[2:4],
                       deadline_s=60.0)
    now["t"] = 106.0                          # past the 5 s default only
    svc.drain()
    assert svc.poll(late).status == "expired"
    assert svc.poll(fresh).ok and svc.t_seen == 2
    assert svc.poll(late).latency_s == pytest.approx(6.0)
    svc.close()


def test_admission_controller_fifo_and_bounds():
    ac = AdmissionController(queue_limit=2, clock=lambda: 0.0)

    def req(rid):
        return Request(rid=rid, kind="get_values", payload={},
                       arrived_s=0.0, expires_s=float("inf"))

    assert ac.offer(req(0)) and ac.offer(req(1)) and not ac.offer(req(2))
    assert ac.stats == {"admitted": 2, "shed": 1, "expired": 0}
    assert ac.depth == 2
    assert ac.peek().rid == 0 and ac.take().rid == 0
    assert ac.take().rid == 1 and ac.take() is None


def test_malformed_requests():
    x, y, xt, yt = _problem()
    svc = _service(x, y)
    with pytest.raises(ValueError):
        svc.submit("value_query", x=xt[:4, :2], y=yt[:4])  # wrong dim
    with pytest.raises(ValueError):
        svc.submit("bogus_kind")
    assert svc.get_values().status == "rejected"       # nothing folded yet
    assert svc.remove_points([10 ** 6]).status == "rejected"
    assert svc.add_points(np.zeros((CAP, D), np.float32),
                          np.zeros(CAP, np.int32)).status == "rejected"
    with pytest.raises(ValueError, match="capacity"):
        _service(x, y, capacity=N - 1)
    with pytest.raises(ValueError, match="cache_policy"):
        _service(x, y, cache_policy="sometimes")
    svc.close()


def test_service_defaults_to_cuda():
    x, y, _, _ = _problem()
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ValuationService(x, y, capacity=CAP, test_batch=TB)


# ------------------------------------------------------- incremental state
@pytest.mark.parametrize("method", ["sti", "knn_shapley", "wknn"])
def test_remove_points_matches_full_recompute_exactly(method):
    """Incremental remove (cached ranks + masked refold) is BIT-IDENTICAL
    to the full recompute the cache_policy="off" service performs against
    the mutated train set."""
    x, y, xt, yt = _problem()
    gone = [3, 17, 44]
    svc = _service(x, y, method=method)            # lazy rank caches
    ref = _service(x, y, method=method, cache_policy="off")
    for s in (svc, ref):
        s.value_query(xt, yt)
        assert s.remove_points(gone).ok
    a, b = svc.get_values().payload, ref.get_values().payload
    assert a["ids"] == b["ids"]
    np.testing.assert_array_equal(a["values"], b["values"])
    if method == "sti":
        np.testing.assert_array_equal(a["phi"], b["phi"])
    # the rebased state itself is the service's own full recompute
    state, t = svc._refold_all(use_caches=False)
    for got, want in zip(svc._session.inner._state, state):
        assert torch.equal(got, want)
    keep = np.array([i for i in range(N) if i not in gone])
    offline = get_method(method)(x[keep], y[keep], xt, yt, k=K, **CPU)
    np.testing.assert_allclose(a["values"], _np(offline.values()),
                               atol=1e-5)
    svc.close()
    ref.close()


def test_remove_skips_rank_recomputation_once_caches_are_warm():
    x, y, xt, yt = _problem()
    svc = _service(x, y)
    svc.value_query(xt, yt)
    calls = {"n": 0}
    inner_rank = svc._rank

    def counting_rank(*a):
        calls["n"] += 1
        return inner_rank(*a)

    svc._rank = counting_rank
    assert svc.remove_points([1, 2]).ok
    assert calls["n"] == len(svc._log)     # cache fill, once per batch
    calls["n"] = 0
    assert svc.remove_points([5]).ok       # caches warm: refold only
    assert calls["n"] == 0
    svc.close()


@pytest.mark.parametrize("method", ["knn_shapley", "sti"])
def test_add_points_incremental_parity_and_ids(method):
    x, y, xt, yt = _problem()
    svc = _service(x, y, method=method)
    ref = _service(x, y, method=method, cache_policy="off")
    for s in (svc, ref):
        s.value_query(xt[:16], yt[:16])
        r = s.add_points(xt[:3], yt[:3])
        assert r.ok and r.payload["ids"] == [N, N + 1, N + 2]
        s.value_query(xt[16:], yt[16:])
    a = svc.get_values().payload["values"]
    b = ref.get_values().payload["values"]
    # the new columns come from the column distance, the full recompute's
    # from the whole matrix: near-exact, not bit-exact
    np.testing.assert_allclose(a, b, atol=2e-5)
    svc.close()
    ref.close()


def test_eager_and_bounded_caches_agree_with_lazy():
    x, y, xt, yt = _problem()
    vals = {}
    for policy, bound in (("lazy", None), ("eager", None), ("eager", 1)):
        svc = _service(x, y, cache_policy=policy, max_cached_batches=bound)
        svc.value_query(xt, yt)
        if policy == "eager":
            cached = [rec.d2 is not None for rec in svc._log]
            assert cached == ([True] * len(cached) if bound is None else
                              [False] * (len(cached) - 1) + [True])
        assert svc.remove_points([0, 9]).ok
        vals[(policy, bound)] = svc.get_values().payload["values"]
        svc.close()
    for v in vals.values():
        np.testing.assert_array_equal(v, vals[("lazy", None)])


def test_mutations_bump_version_and_invalidate_results_cache():
    x, y, xt, yt = _problem()
    svc = _service(x, y)
    svc.value_query(xt, yt)
    g1 = svc.get_values()
    g2 = svc.get_values()
    assert not g1.payload["cached"] and g2.payload["cached"]
    assert svc.remove_points([0]).payload["version"] == 1
    g3 = svc.get_values()
    assert not g3.payload["cached"]        # mutation invalidated the cache
    assert g3.payload["version"] == 1 and g3.payload["n_live"] == N - 1
    assert 0 not in g3.payload["ids"]
    # slot reuse: the freed slot is recycled with a FRESH id, never id 0
    r = svc.add_points(xt[:1], yt[:1])
    assert r.payload["ids"] == [N]
    assert svc.get_values().payload["version"] == 2
    assert svc.version == 2 and svc.n_live == N
    svc.close()


# ------------------------------------------------- concurrency semantics
def test_two_client_interleavings_agree():
    x, y, xt, yt = _problem()
    a = [(xt[i:i + 4], yt[i:i + 4]) for i in range(0, 16, 4)]
    b = [(xt[i:i + 4], yt[i:i + 4]) for i in range(16, 32, 4)]

    def run(order):
        svc = _service(x, y)
        for xb, yb in order:
            assert svc.value_query(xb, yb).ok
        vals = svc.get_values().payload["values"]
        svc.close()
        return vals

    interleaved = run([v for pair in zip(a, b) for v in pair])
    sequential = run(a + b)
    np.testing.assert_allclose(interleaved, sequential, atol=1e-5)


def test_kill_and_resume_is_exactly_once(tmp_path):
    x, y, xt, yt = _problem()
    chunks = [(xt[i:i + TB], yt[i:i + TB]) for i in range(0, T, TB)]
    ckpt = tmp_path / "svc"

    svc1 = _service(x, y, ckpt_dir=str(ckpt), ckpt_every=1)
    for xb, yb in chunks[:3]:
        assert svc1.value_query(xb, yb).ok
    svc1._session._ckpt.wait()   # flush in-flight write, then "kill"
    del svc1

    svc2 = _service(x, y, ckpt_dir=str(ckpt), ckpt_every=1, resume=True)
    assert svc2.t_seen == 3 * TB          # restored, not recomputed
    for xb, yb in chunks:                 # client replays from the START
        assert svc2.value_query(xb, yb).ok
    h = svc2.health()
    assert h["resilience"]["replayed_skipped"] == 3   # exactly-once
    assert svc2.t_seen == T

    svc3 = _service(x, y)                 # uninterrupted reference
    for xb, yb in chunks:
        assert svc3.value_query(xb, yb).ok
    np.testing.assert_array_equal(svc2.get_values().payload["values"],
                                  svc3.get_values().payload["values"])
    svc2.close()
    svc3.close()


def test_chaos_drill_8_shards_availability_and_drift():
    """An 8-shard service (["cpu"] * 8, in process) under injected device
    loss past every retry budget, NaN poisoning and checkpoint corruption
    answers every admitted request, reports ``degraded`` health, and
    finalizes within 1e-5 of the offline fused engine on the final
    (mutated) train set."""
    rng = np.random.default_rng(0)
    n, t, d, k, tb = 64, 32, 4, 5, 8
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.int32)
    xt = rng.normal(size=(t, d)).astype(np.float32)
    yt = rng.integers(0, 2, t).astype(np.int32)
    inj = FaultInjector([
        Fault(kind="device", at_seq=1, times=99),  # beyond any budget
        Fault(kind="nan", at_seq=2, seed=0),
        Fault(kind="ckpt_corrupt", at_seq=2, seed=0),
    ])
    svc = ValuationService(
        x, y, method="sti", k=k, capacity=72, test_batch=tb,
        devices=["cpu"] * 8, ckpt_every=2, max_retries=1, min_shards=4,
        seed=0, injector=inj)
    assert svc._session.shards == 8
    statuses = []
    for s in range(0, t, tb):
        if s == 16:
            statuses.append(svc.remove_points([0, 1]).status)
        half = tb // 2
        rids = [svc.submit("value_query", x=xt[s:s + half],
                           y=yt[s:s + half]),
                svc.submit("value_query", x=xt[s + half:s + tb],
                           y=yt[s + half:s + tb])]
        svc.drain()
        statuses += [svc.poll(r).status for r in rids]
    gv = svc.get_values()
    statuses.append(gv.status)
    assert all(st == "ok" for st in statuses), statuses
    h = svc.health()
    assert h["status"] == "degraded", h
    assert h["resilience"]["degradations"][0] == {"from": 8, "to": 6}
    assert h["requests"]["full_recoveries"] >= 1
    assert inj.fired("device") and inj.fired("ckpt_corrupt")
    keep = np.array([i for i in range(n) if i not in (0, 1)])
    off = get_method("sti")(x[keep], y[keep], xt, yt, k=k, **CPU)
    drift = float(np.max(np.abs(_np(off.values()) - gv.payload["values"])))
    assert drift <= 1e-5, drift
    svc.close()


# ------------------------------------------- refold pipeline vs the JAX one
def _int_problem(seed, n=CAP, t=TB, d=D):
    """Integer features (every distance exact in f32) and a liveness mask;
    `x_pre` is the train set before the dead slots were removed, `x` after
    (dead slots at the sentinel)."""
    rng = np.random.default_rng(seed)
    x_pre = rng.integers(-4, 5, (n, d)).astype(np.float32)
    y_pre = rng.integers(0, 3, n).astype(np.int32)
    xt = rng.integers(-4, 5, (t, d)).astype(np.float32)
    yt = rng.integers(0, 3, t).astype(np.int32)
    keep = (rng.random(n) > 0.3).astype(np.float32)
    x, y = x_pre.copy(), y_pre.copy()
    x[keep == 0] = SENTINEL_COORD
    y[keep == 0] = SENTINEL_LABEL
    return x_pre, x, y, xt, yt, keep


@pytest.mark.parametrize("seed", range(3))
def test_compact_order_and_rank_step_match_reference(jx, seed):
    x_pre, x, y, xt, yt, keep = _int_problem(seed)
    rank, jrank = make_rank_step("plain"), jx.pipe.make_rank_step("xla")
    for train in (x_pre, x):
        jd2, jorder = jrank(jx.jnp.asarray(xt), jx.jnp.asarray(train))
        d2, order = rank(torch.from_numpy(xt), torch.from_numpy(train))
        assert order.dtype == torch.int32
        np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
        np.testing.assert_array_equal(d2.numpy(), np.asarray(jd2))
    # compact the order cached BEFORE the removal against keep
    cached = rank(torch.from_numpy(xt), torch.from_numpy(x_pre))[1]
    jnew, jranks = jx.sk.compact_order(
        jrank(jx.jnp.asarray(xt), jx.jnp.asarray(x_pre))[1],
        jx.jnp.asarray(keep))
    new, ranks = compact_order(cached, torch.from_numpy(keep))
    assert new.dtype == cached.dtype
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(jranks))
    # its live prefix is the fresh ranking of the mutated train set's
    fresh = rank(torch.from_numpy(xt), torch.from_numpy(x))[1]
    n_live = int(keep.sum())
    assert torch.equal(new[:, :n_live], fresh[:, :n_live])
    assert torch.equal(torch.sort(new[:, n_live:], dim=1).values,
                       torch.sort(fresh[:, n_live:], dim=1).values)


@pytest.mark.parametrize("method,opts", [
    ("sti", None), ("sii", None), ("knn_shapley", None),
    ("wknn", {"weights": "rbf"}), ("loo", None)])
def test_refold_step_matches_reference(jx, method, opts):
    _, x, y, xt, yt, keep = _int_problem(11)
    mask = np.ones(TB, np.float32)
    mask[-2:] = 0.0
    jrefold, jrank, _, jspec = jx.pipe.prepare_refold_step(
        method, CAP, D, K, test_batch=TB, fill="xla", distance="xla",
        method_opts=opts)
    refold, rank, resolved, spec = prepare_refold_step(
        method, CAP, D, K, test_batch=TB, fill="xla", distance="plain",
        method_opts=opts, **CPU)
    assert resolved["distance"] == "plain"
    jstate = tuple(jx.jnp.zeros(s, jx.jnp.float32)
                   for s in jspec.shapes(CAP))
    state = spec.init(CAP, "cpu")
    for rep in range(2):  # two folds of the same cached batch
        jd2, jorder = jrank(jx.jnp.asarray(xt), jx.jnp.asarray(x))
        jstate = jrefold(jstate, jd2, jorder, jx.jnp.asarray(yt),
                         jx.jnp.asarray(mask), jx.jnp.asarray(y),
                         jx.jnp.asarray(keep))
        d2, order = rank(torch.from_numpy(xt), torch.from_numpy(x))
        state = refold(state, d2, order, torch.from_numpy(yt),
                       torch.from_numpy(mask), torch.from_numpy(y),
                       torch.from_numpy(keep))
    for got, want in zip(state, jstate):
        want = np.asarray(want)
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got.numpy() - want).max() <= 1e-6 * scale
    # the step is cached per static configuration, as the JAX one is
    statics = tuple(sorted((opts or {}).items()))
    if spec.kind == "point":
        assert make_refold_step(method, K, statics) is refold


# ---------------------------------------------- services across packages
def _script(svc):
    """One request script; returns what both packages must agree on."""
    x, y, xt, yt = _problem(3)
    out = []
    rids = [svc.submit("value_query", x=xt[i:i + 6], y=yt[i:i + 6])
            for i in range(0, 18, 6)]
    svc.drain()
    out += [(svc.poll(r).status, svc.poll(r).payload["t_seen"])
            for r in rids]
    r = svc.add_points(xt[18:21], yt[18:21])
    out.append((r.status, r.payload["ids"], r.payload["n_live"],
                r.payload["version"]))
    r = svc.remove_points([2, 30, N + 1])
    out.append((r.status, r.payload["n_live"], r.payload["version"]))
    out.append((svc.remove_points([2]).status,))           # already gone
    out.append((svc.value_query(xt[21:], yt[21:]).status,))
    gv = svc.get_values()
    out.append((gv.status, gv.payload["ids"], gv.payload["n_live"],
                gv.payload["version"], gv.payload["t_seen"]))
    h = svc.health()
    out.append((h["status"], h["n_live"], h["version"], h["t_seen"]))
    return out, np.asarray(gv.payload["values"]), gv.payload.get("phi")


@pytest.mark.parametrize("method,tol", [("sti", 1e-6), ("knn_shapley", 1e-6),
                                        ("wknn", 1e-5)])
def test_request_script_matches_the_jax_service(jx, method, tol):
    x, y, _, _ = _problem(3)
    kw = dict(method=method, k=K, capacity=CAP, test_batch=TB, seed=1)
    jsvc = jx.Service(x, y, **kw)
    svc = ValuationService(x, y, **kw, **CPU)
    jout, jvals, jphi = _script(jsvc)
    out, vals, phi = _script(svc)
    assert out == jout
    assert np.abs(vals - jvals).max() <= tol * np.abs(jvals).max()
    if method == "sti":
        jphi = np.asarray(jphi)
        assert np.abs(phi - jphi).max() <= tol * np.abs(jphi).max()
    jsvc.close()
    svc.close()


def test_service_resumes_a_jax_written_directory(jx, tmp_path):
    """A stream checkpointed by the JAX service resumes in the port's: the
    replayed chunks are skipped, and the values land within 1e-6 of max
    |ref| of the uninterrupted JAX run."""
    x, y, xt, yt = _problem()
    chunks = [(xt[i:i + TB], yt[i:i + TB]) for i in range(0, T, TB)]
    kw = dict(method="sti", k=K, capacity=CAP, test_batch=TB, seed=1)
    jsvc = jx.Service(x, y, ckpt_dir=str(tmp_path), ckpt_every=1, **kw)
    for xb, yb in chunks[:2]:
        assert jsvc.value_query(xb, yb).ok
    jsvc._session._ckpt.wait()            # then "kill": only disk remains
    del jsvc
    ref = jx.Service(x, y, **kw)
    for xb, yb in chunks:
        assert ref.value_query(xb, yb).ok
    want = np.asarray(ref.get_values().payload["values"])
    svc = ValuationService(x, y, ckpt_dir=str(tmp_path), ckpt_every=1,
                           resume=True, **kw, **CPU)
    assert svc.t_seen == 2 * TB
    for xb, yb in chunks:
        assert svc.value_query(xb, yb).ok
    assert svc.health()["resilience"]["replayed_skipped"] == 2
    got = svc.get_values().payload["values"]
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    svc.close()
    ref.close()


# --------------------------------------------------------------- launchers
def _launch(*args, ok=True):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    p = subprocess.run([sys.executable, "-m", *args], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    if not ok:
        return p
    assert p.returncode == 0, f"stdout:\n{p.stdout}\nstderr:\n{p.stderr}"
    return p.stdout


@pytest.mark.parametrize("args", [
    ("repro_torch.launch.valuation_serve",),
    ("repro_torch.launch.valuate", "--resilient", "--n", "16", "--t", "8")])
def test_launchers_default_to_cuda(args):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = _launch(*args, ok=False)
    assert p.returncode != 0 and "no CUDA device" in p.stderr


def test_valuation_serve_launcher_cpu_chaos():
    out = _launch("repro_torch.launch.valuation_serve", "--device", "cpu",
                  "--mutate", "--chaos", "--check")
    assert "health: degraded" in out and "(OK)" in out
    assert "device=cpu" in out


def test_valuate_launcher_resilient_resumes(tmp_path):
    args = ("repro_torch.launch.valuate", "--device", "cpu", "--resilient",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--n", "64",
            "--t", "32", "--test-batch", "8")
    first = _launch(*args)
    assert "resilience: checkpoints=[2, 4]" in first
    again = _launch(*args)
    assert "resuming from" in again and "replayed_skipped=4" in again
    gap = [ln for ln in first.splitlines() if "efficiency gap" in ln]
    assert gap and gap == [ln for ln in again.splitlines()
                           if "efficiency gap" in ln]


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["sti", "knn_shapley", "wknn"])
def test_cuda_remove_bit_exact_through_the_kernels(cuda, method):
    """On the card the remove is bit-exact against the "off" service's full
    recompute; with warm caches it launches no distance kernel, and an
    interaction refold runs the CUDA fill once a logged batch."""
    from repro_torch.kernels.distance import distance_cuda
    from repro_torch.kernels.sti_fill import sti_fill_acc_cuda

    x, y, xt, yt = _problem()
    svc = _service(x, y, method=method, device=cuda)
    ref = _service(x, y, method=method, cache_policy="off", device=cuda)
    for s in (svc, ref):
        s.value_query(xt, yt)
        assert s.remove_points([3, 17]).ok
    distance_cuda.launches = sti_fill_acc_cuda.launches = 0
    for s in (svc, ref):
        assert s.remove_points([44]).ok
    # the "off" service ranks every logged batch anew, the cached one not
    assert distance_cuda.launches == len(ref._log)
    assert sti_fill_acc_cuda.launches == (2 * len(svc._log)
                                          if method == "sti" else 0)
    a, b = svc.get_values().payload, ref.get_values().payload
    np.testing.assert_array_equal(a["values"], b["values"])
    keep = np.array([i for i in range(N) if i not in (3, 17, 44)])
    offline = get_method(method)(x[keep], y[keep], xt, yt, k=K, **CPU)
    np.testing.assert_allclose(a["values"], _np(offline.values()),
                               atol=1e-5)
    svc.close()
    ref.close()


@pytest.mark.cuda
def test_cuda_sentinel_slots_rank_last_in_index_order(cuda):
    """A full-width row of the distance kernel against a train set with
    sentinel slots: finite, every sentinel distance past SENTINEL_D2, the
    sentinel slots last and in index order."""
    rng = np.random.default_rng(0)
    n, d = 8192, 768
    x = rng.normal(size=(n, d)).astype(np.float32)
    dead = np.sort(rng.choice(n, 300, replace=False))
    x[dead] = SENTINEL_COORD
    xt = rng.normal(size=(16, d)).astype(np.float32)
    d2, order = make_rank_step("cuda")(torch.from_numpy(xt).to(cuda),
                                       torch.from_numpy(x).to(cuda))
    assert bool(torch.isfinite(d2).all())
    assert bool((d2[:, dead] >= 1e20).all())
    live = np.setdiff1d(np.arange(n), dead)
    assert bool((d2[:, live] < 1e20).all())
    tail = order[:, -dead.shape[0]:].cpu().numpy()
    np.testing.assert_array_equal(tail, np.broadcast_to(dead, tail.shape))
