"""The port's resilient runtime against the JAX package (CPU).

`repro_torch.distributed.fault_injection`, `...fault_tolerance`,
`repro_torch.checkpoint.checkpointer` and `repro_torch.core.resilient`
are held against their `repro` counterparts on the same numpy inputs
(N = 48, d = 4, k = 5, test batch 8):

  * the fault hooks fire the same events, and `poison_state` /
    `corrupt_checkpoint_leaf` pick the same array, element, file and byte
    for a seed (the port poisons a copy: the live tensor stays clean);
  * StepGuard's backoff delays, HealthLog's straggler flags and
    `degrade_plan` are equal to the reference's;
  * for the same tree both checkpointers write the same file names, keys,
    shapes, dtypes, sha256 values and bytes, and each restores the
    other's directory;
  * an async checkpoint holds the bits of the step it was taken at, while
    the next fold writes the live state in place;
  * the drills of tests/test_resilience.py (kill/resume, transient
    failure, replay skip and gap, NaN rollback and its budget, corrupted
    checkpoint fallback, deadline overrun, sharded degradation on
    ["cpu"] * 4 and restore onto fewer devices) finalize BIT-identical to
    an uninterrupted port session, and within 1e-6 of max |ref| of the
    JAX package's result on the same batches;
  * a stream checkpointed by either package's resilient session resumes
    in the other and lands within 1e-6 of max |ref| of JAX's
    uninterrupted result.
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.checkpointer import (
    Checkpointer,
    CheckpointCorruptionError,
)
from repro_torch.core.resilient import ResilientValuationSession
from repro_torch.core.session import ValuationSession
from repro_torch.distributed.fault_injection import (
    Fault,
    FaultInjector,
    corrupt_checkpoint_leaf,
)
from repro_torch.distributed.fault_tolerance import (
    HealthLog,
    StepGuard,
    block_until_ready,
    degrade_plan,
)

N, T, D, K, TB = 48, 32, 4, 5, 8
CPU = dict(device="cpu")
CPU4 = ["cpu"] * 4


@pytest.fixture(scope="module")
def jx():
    """The JAX package's resilient runtime (skips where JAX is absent)."""
    pytest.importorskip("jax")
    import types

    import jax.numpy as jnp

    from repro.checkpoint import checkpointer as jck
    from repro.core.resilient import ResilientValuationSession as JRes
    from repro.core.session import ValuationSession as JSession
    from repro.distributed import fault_injection as jfi
    from repro.distributed import fault_tolerance as jft

    return types.SimpleNamespace(jnp=jnp, ck=jck, Res=JRes,
                                 Session=JSession, fi=jfi, ft=jft)


def _problem():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, D)).astype(np.float32)
    y = rng.integers(0, 2, N).astype(np.int32)
    xt = rng.normal(size=(T, D)).astype(np.float32)
    yt = rng.integers(0, 2, T).astype(np.int32)
    batches = [(xt[i:i + TB], yt[i:i + TB]) for i in range(0, T, TB)]
    return x, y, batches


def _arr(result) -> np.ndarray:
    a = result.phi if result.phi is not None else result.point_values
    return np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a)


_BASE: dict = {}


def _baseline(mode: str) -> np.ndarray:
    """The uninterrupted port session's result (cached per mode)."""
    if mode not in _BASE:
        x, y, batches = _problem()
        sess = ValuationSession(x, y, k=K, mode=mode, test_batch=TB, **CPU)
        for xb, yb in batches:
            sess.update(xb, yb)
        _BASE[mode] = _arr(sess.finalize())
    return _BASE[mode]


def _jax_result(jx, mode: str) -> np.ndarray:
    """The JAX package's session over the same batches."""
    key = ("jax", mode)
    if key not in _BASE:
        x, y, batches = _problem()
        sess = jx.Session(x, y, k=K, mode=mode, test_batch=TB)
        for xb, yb in batches:
            sess.update(xb, yb)
        _BASE[key] = _arr(sess.finalize())
    return _BASE[key]


def _assert_parity(result, mode: str, jx=None):
    """Bit-identical to the uninterrupted port run; within 1e-6 of max
    |ref| of JAX's result on the same batches when `jx` is given."""
    got = _arr(result)
    np.testing.assert_array_equal(got, _baseline(mode))
    if jx is not None:
        ref = _jax_result(jx, mode)
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


# ------------------------------------------------------- fault injection
def test_fault_hooks_fire_the_reference_events(jx):
    sleeps = {"port": [], "jax": []}

    def drive(mod, key):
        inj = mod.FaultInjector(
            [mod.Fault("device", at_seq=1, times=2),
             mod.Fault("deadline", at_seq=2, times=1, delay_s=0.5),
             mod.Fault("device", at_seq=3, times=1)],
            sleep_fn=sleeps[key].append)
        raised = []
        for seq in (0, 1, 1, 1, 2, 2, 3, 3):
            try:
                inj.before_step(seq)
                raised.append(None)
            except mod.InjectedDeviceFailure as e:
                raised.append(str(e))
        return inj.events, raised

    import repro_torch.distributed.fault_injection as tfi

    assert drive(tfi, "port") == drive(jx.fi, "jax")
    assert sleeps["port"] == sleeps["jax"] == [0.5]


def test_fault_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("meteor", at_seq=0)


@pytest.mark.parametrize("seed", range(6))
def test_poison_state_picks_the_reference_element_in_a_copy(jx, seed):
    rng = np.random.default_rng(100 + seed)
    acc = rng.normal(size=(6, 6)).astype(np.float32)
    diag = rng.normal(size=(6,)).astype(np.float32)
    jinj = jx.fi.FaultInjector([jx.fi.Fault("nan", at_seq=2, seed=seed)])
    jout = jinj.poison_state(2, (jx.jnp.asarray(acc), jx.jnp.asarray(diag)))
    live = (torch.from_numpy(acc.copy()), torch.from_numpy(diag.copy()))
    inj = FaultInjector([Fault("nan", at_seq=2, seed=seed)])
    assert inj.poison_state(1, live) is live       # not armed at seq 1
    out = inj.poison_state(2, live)
    assert inj.events == jinj.events
    for got, want in zip(out, jout):
        np.testing.assert_array_equal(np.isnan(got.numpy()),
                                      np.isnan(np.asarray(want)))
    # the live tensors were not written; the fault fires once
    np.testing.assert_array_equal(live[0].numpy(), acc)
    np.testing.assert_array_equal(live[1].numpy(), diag)
    assert inj.poison_state(2, live) is live
    # a sharded state (lists of row blocks) poisons the same global element
    blocks = (list(torch.from_numpy(acc.copy()).split(2)),
              list(torch.from_numpy(diag.copy()).split(2)))
    sharded = FaultInjector([Fault("nan", at_seq=2, seed=seed)])
    out_b = sharded.poison_state(2, blocks)
    assert sharded.events == jinj.events
    for got, want in zip(out_b, jout):
        np.testing.assert_array_equal(np.isnan(torch.cat(got).numpy()),
                                      np.isnan(np.asarray(want)))
    assert not any(bool(torch.isnan(b).any()) for arr in blocks for b in arr)


@pytest.mark.parametrize("seed", range(4))
def test_corrupt_checkpoint_leaf_flips_the_reference_byte(jx, tmp_path, seed):
    tree = {"a": np.arange(64, dtype=np.float32),
            "b": {"c": np.ones((5, 3)), "d": np.int64(7)}}
    Checkpointer(tmp_path / "port").save(1, tree)
    jx.ck.Checkpointer(tmp_path / "jax").save(1, tree)
    info = corrupt_checkpoint_leaf(tmp_path / "port", step=1, seed=seed)
    jinfo = jx.fi.corrupt_checkpoint_leaf(tmp_path / "jax", step=1,
                                          seed=seed)
    assert info == jinfo
    for f in sorted((tmp_path / "jax" / "step_00000001").iterdir()):
        assert (tmp_path / "port" / "step_00000001" / f.name
                ).read_bytes() == f.read_bytes()
    assert not Checkpointer(tmp_path / "port").verify_step(1)
    # step=None picks the newest step directory, as in the reference
    assert corrupt_checkpoint_leaf(tmp_path / "port", seed=seed)["file"] \
        == info["file"]


# ------------------------------------------------------ fault tolerance
@pytest.mark.parametrize("seed", [0, 7, 8])
def test_stepguard_backoff_matches_reference(jx, seed):
    kw = dict(backoff_s=0.1, backoff_factor=2.0, jitter_frac=0.25,
              backoff_max_s=1.0, seed=seed)
    port, ref = StepGuard(**kw), jx.ft.StepGuard(**kw)
    assert [port.backoff_delay(a) for a in range(1, 7)] == \
        [ref.backoff_delay(a) for a in range(1, 7)]
    assert StepGuard(max_retries=2).backoff_delay(1) == 0.0


def test_stepguard_retries_sleeps_and_exhausts():
    sleeps: list[float] = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 4:
            raise RuntimeError("boom")
        return (torch.zeros(2), [torch.ones(1)], {"a": np.zeros(1)})

    retries = []
    g = StepGuard(max_retries=3, backoff_s=0.1, seed=7,
                  sleep_fn=sleeps.append,
                  on_retry=lambda a, e: retries.append(a))
    out, dt = g.run(flaky)
    assert calls["n"] == 4 and len(sleeps) == 3 and retries == [0, 1, 2]
    assert sleeps[0] < sleeps[1] < sleeps[2] and dt >= 0.0
    with pytest.raises(RuntimeError, match="failed after 1 retries"):
        StepGuard(max_retries=1).run(
            lambda: (_ for _ in ()).throw(ValueError("dead")))
    # a deadline overrun is a failed attempt too
    with pytest.raises(RuntimeError, match="deadline exceeded"):
        StepGuard(max_retries=0, deadline_s=-1.0).run(lambda: 1)
    block_until_ready({"x": [torch.zeros(1), (1, "a")]})  # CPU: no-op


def test_healthlog_matches_reference(jx):
    rng = np.random.default_rng(3)
    times = list(rng.uniform(0.9, 1.1, 40))
    for i in (9, 10, 25, 39):
        times[i] = 50.0
    port = HealthLog(window=16, k_sigma=3.0, min_history=8)
    ref = jx.ft.HealthLog(window=16, k_sigma=3.0, min_history=8)
    assert [port.record(t) for t in times] == [ref.record(t) for t in times]
    assert port.summary() == ref.summary()
    assert port.straggler_steps and len(port.times) == 16


def test_degrade_plan_matches_reference_on_a_grid(jx):
    for n in (1, 7, 12, 48, 56, 64, 65536):
        for cur in range(1, 10):
            for floor in range(0, 6):
                assert degrade_plan(n, cur, floor) == \
                    jx.ft.degrade_plan(n, cur, floor), (n, cur, floor)


# ---------------------------------------------------------- checkpointer
def _tree():
    rng = np.random.default_rng(5)
    return {
        "config": np.asarray('{"mode": "sti"}'),
        "scalars": {"seq": np.int64(3), "t": np.int64(24)},
        "state": {"acc": rng.normal(size=(6, 6)).astype(np.float32),
                  "diag": rng.normal(size=(6,)).astype(np.float32)},
        "extra": [np.arange(4, dtype=np.int32), None,
                  (np.ones(2, np.float64),)],
    }


def test_checkpoint_layout_is_the_reference_byte_for_byte(jx, tmp_path):
    tree = _tree()
    Checkpointer(tmp_path / "port").save(3, tree)
    jx.ck.Checkpointer(tmp_path / "jax").save(3, tree)
    pdir, jdir = tmp_path / "port" / "step_00000003", \
        tmp_path / "jax" / "step_00000003"
    assert sorted(p.name for p in pdir.iterdir()) == \
        sorted(p.name for p in jdir.iterdir())
    # MANIFEST.json included: keys, file names, shapes, dtypes, sha256
    for f in jdir.iterdir():
        assert (pdir / f.name).read_bytes() == f.read_bytes(), f.name
    # a tensor leaf writes what its numpy value writes
    tt = dict(tree, state={k: torch.from_numpy(v.copy())
                           for k, v in tree["state"].items()})
    Checkpointer(tmp_path / "torch").save(3, tt)
    for f in jdir.iterdir():
        assert (tmp_path / "torch" / "step_00000003" / f.name
                ).read_bytes() == f.read_bytes(), f.name


def test_checkpoint_directories_restore_across_packages(jx, tmp_path):
    tree = _tree()
    Checkpointer(tmp_path / "port").save(2, tree)
    jx.ck.Checkpointer(tmp_path / "jax").save(2, tree)
    like = _tree()
    for src in ("port", "jax"):
        got, step = Checkpointer(tmp_path / src).restore(like)
        jgot, jstep = jx.ck.Checkpointer(tmp_path / src).restore(like)
        assert step == jstep == 2
        for (a, b, c) in zip(
                [got["state"]["acc"], got["extra"][0], got["scalars"]["t"],
                 got["extra"][2][0], got["config"]],
                [np.asarray(jgot["state"]["acc"]), np.asarray(
                    jgot["extra"][0]), np.asarray(jgot["scalars"]["t"]),
                 np.asarray(jgot["extra"][2][0]), np.asarray(
                     jgot["config"])],
                [tree["state"]["acc"], tree["extra"][0],
                 tree["scalars"]["t"], tree["extra"][2][0],
                 tree["config"]]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert got["extra"][1] is None
    # onto a device: numeric leaves come back as owned tensors
    got, _ = Checkpointer(tmp_path / "jax").restore(like, devices="cpu")
    assert isinstance(got["state"]["acc"], torch.Tensor)
    assert isinstance(got["config"], np.ndarray)


def test_checkpointer_sha256_fallback_and_explicit_corruption(tmp_path):
    ck = Checkpointer(tmp_path, keep=5)
    tree = {"a": np.arange(32, dtype=np.float32), "b": np.ones((4, 4))}
    ck.save(1, tree)
    ck.save(2, {"a": tree["a"] * 2, "b": tree["b"] * 2})
    assert ck.verify_step(1) and ck.verify_step(2)
    corrupt_checkpoint_leaf(tmp_path, step=2, seed=0)
    assert not ck.verify_step(2)
    assert ck.latest_step() == 2                 # done=true, but corrupt
    assert ck.latest_verified_step() == 1        # checksum walk skips it
    restored, step = ck.restore(tree)            # falls back, no garbage
    assert step == 1
    np.testing.assert_array_equal(restored["a"], tree["a"])
    with pytest.raises(CheckpointCorruptionError):
        ck.restore(tree, step=2)


def test_checkpointer_prune_keeps_the_last_verified_step(tmp_path):
    ck = Checkpointer(tmp_path, keep=5)
    for s in (1, 2, 3):
        ck.save(s, {"a": np.full((8,), float(s), np.float32)})
    corrupt_checkpoint_leaf(tmp_path, step=3, seed=0)
    # keep 1: step 3 survives but does not verify, so step 2 stays too
    assert ck.prune(keep_last=1) == [1]
    assert ck.all_steps() == [2, 3]
    assert ck.restore({"a": np.float32(0)})[1] == 2


def test_checkpointer_async_save_checksummed(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save_async(3, {"w": torch.full((8,), 7.0)})
    ck.wait()
    assert ck.verify_step(3)
    got, _ = ck.restore({"w": np.float32(0)})
    np.testing.assert_array_equal(got["w"], np.full((8,), 7.0, np.float32))


def _held_writes(ck: Checkpointer) -> threading.Event:
    """Hold every write thread of `ck` until the returned event is set."""
    release = threading.Event()
    write = ck._write

    def held(step, leaves):
        assert release.wait(timeout=60)
        write(step, leaves)

    ck._write = held
    return release


def test_async_snapshot_owns_its_bits(tmp_path):
    """The write thread is held while the live CPU tensor changes in place:
    the checkpoint must hold the bits it was taken with."""
    ck = Checkpointer(tmp_path)
    release = _held_writes(ck)
    live = torch.arange(16, dtype=torch.float32)
    ck.save_async(1, {"acc": live})
    live.add_(100.0)                      # the next fold, in place
    release.set()
    ck.wait()
    got, _ = ck.restore({"acc": np.float32(0)})
    np.testing.assert_array_equal(got["acc"],
                                  np.arange(16, dtype=np.float32))


def test_async_checkpoint_holds_its_step_while_the_next_fold_runs(tmp_path):
    x, y, batches = _problem()
    sess = ResilientValuationSession(
        x, y, ckpt_dir=tmp_path, mode="sti", k=K, test_batch=TB,
        ckpt_every=2, async_checkpoint=True, **CPU)
    release = _held_writes(sess._ckpt)
    for xb, yb in batches[:3]:            # checkpoint at 2 is held while
        sess.update(xb, yb)               # batch 3 folds into acc in place
    thread = sess._ckpt._thread
    assert thread is not None and thread.is_alive()
    release.set()
    sess._ckpt.wait()
    two = ValuationSession(x, y, k=K, mode="sti", test_batch=TB, **CPU)
    for xb, yb in batches[:2]:
        two.update(xb, yb)
    got, step = sess._ckpt.restore(sess._tree_like())
    assert step == 2 and int(got["scalars"]["t"]) == 2 * TB
    for name, want in zip(("acc", "diag"), two._state):
        np.testing.assert_array_equal(got["state"][name], want.numpy())


# ----------------------------------------------------------------- drills
DRILL_MODES = ["sti", "knn_shapley"]


@pytest.mark.parametrize("mode", DRILL_MODES + ["wknn"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kill_resume_bit_identical(jx, tmp_path, mode, seed):
    x, y, batches = _problem()
    kill_at = int(np.random.default_rng(seed).integers(len(batches)))
    inj = FaultInjector([Fault("device", at_seq=kill_at, times=10)])
    sess = ResilientValuationSession(
        x, y, ckpt_dir=tmp_path, mode=mode, k=K, test_batch=TB,
        ckpt_every=1, max_retries=2, backoff_s=0.0, injector=inj, **CPU)
    with pytest.raises(RuntimeError):
        for xb, yb in batches:
            sess.update(xb, yb)
    assert len(inj.fired("device")) == 3  # 1 attempt + 2 retries
    sess._ckpt.wait()
    try:
        resumed = ResilientValuationSession.restore(tmp_path, x, y, **CPU)
        assert resumed.batches_folded == kill_at
    except FileNotFoundError:
        assert kill_at == 0  # killed before the first checkpoint
        resumed = ResilientValuationSession(
            x, y, ckpt_dir=tmp_path, mode=mode, k=K, test_batch=TB,
            ckpt_every=1, **CPU)
    for xb, yb in batches:  # replay the WHOLE stream: exactly-once fold
        resumed.update(xb, yb)
    result = resumed.finalize()
    _assert_parity(result, mode, jx)
    assert result.meta["resilience"]["replayed_skipped"] == kill_at


@pytest.mark.parametrize("mode", DRILL_MODES)
def test_transient_device_failure_retries_in_place(jx, tmp_path, mode):
    x, y, batches = _problem()
    inj = FaultInjector([Fault("device", at_seq=1, times=1)])
    sess = ResilientValuationSession(
        x, y, ckpt_dir=tmp_path, mode=mode, k=K, test_batch=TB,
        ckpt_every=2, backoff_s=0.0, injector=inj, **CPU)
    for xb, yb in batches:
        sess.update(xb, yb)
    result = sess.finalize()
    _assert_parity(result, mode, jx)
    assert result.meta["resilience"]["retries"] == 1
    assert result.meta["resilient"] is True


@pytest.mark.parametrize("mode", DRILL_MODES)
def test_replay_skip_counting(jx, tmp_path, mode):
    x, y, batches = _problem()
    sess = ResilientValuationSession(
        x, y, ckpt_dir=tmp_path, mode=mode, k=K, test_batch=TB,
        ckpt_every=1, **CPU)
    for xb, yb in batches[:3]:
        sess.update(xb, yb)
    sess.checkpoint()
    sess._ckpt.wait()
    resumed = ResilientValuationSession.restore(tmp_path, x, y, **CPU)
    assert resumed.batches_folded == 3
    for xb, yb in batches:
        resumed.update(xb, yb)
    result = resumed.finalize()
    assert result.meta["resilience"]["replayed_skipped"] == 3
    _assert_parity(result, mode, jx)


def test_out_of_order_replay_gap_raises(tmp_path):
    x, y, batches = _problem()
    sess = ResilientValuationSession(
        x, y, ckpt_dir=tmp_path, mode="sti", k=K, test_batch=TB, **CPU)
    sess.update(*batches[0])
    sess._arrived = 5  # the caller lost batches 1..4
    with pytest.raises(RuntimeError, match="batch gap"):
        sess.update(*batches[1])


def test_replay_buffer_owns_its_batches(tmp_path):
    """A caller that reuses its batch buffer after update() must not change
    what a rollback refolds."""
    x, y, batches = _problem()
    inj = FaultInjector([Fault("nan", at_seq=2, seed=0)])
    sess = ResilientValuationSession(
        x, y, ckpt_dir=tmp_path, mode="sti", k=K, test_batch=TB,
        ckpt_every=2, injector=inj, **CPU)
    buf_x, buf_y = np.empty((TB, D), np.float32), np.empty(TB, np.int32)
    for xb, yb in batches:
        buf_x[:], buf_y[:] = xb, yb
        sess.update(buf_x, buf_y)
        buf_x[:] = 1e6                    # the caller reuses its buffer
    result = sess.finalize()
    assert result.meta["resilience"]["rollbacks"] == 1
    _assert_parity(result, "sti")


@pytest.mark.parametrize("mode", DRILL_MODES)
@pytest.mark.parametrize("seed", [0, 1])
def test_nan_poison_rolls_back_bit_identical(jx, tmp_path, mode, seed):
    x, y, batches = _problem()
    poison_at = 1 + int(
        np.random.default_rng(seed).integers(len(batches) - 1))
    inj = FaultInjector([Fault("nan", at_seq=poison_at, seed=seed)])
    sess = ResilientValuationSession(
        x, y, ckpt_dir=tmp_path, mode=mode, k=K, test_batch=TB,
        ckpt_every=1, injector=inj, **CPU)
    for xb, yb in batches:
        sess.update(xb, yb)
    result = sess.finalize()
    _assert_parity(result, mode, jx)
    res = result.meta["resilience"]
    assert res["nan_detected"] == 1 and res["rollbacks"] == 1


@pytest.mark.parametrize("mode", DRILL_MODES)
def test_persistent_nan_exhausts_rollback_budget(tmp_path, mode):
    x, y, batches = _problem()
    inj = FaultInjector([Fault("nan", at_seq=1, times=100)])
    sess = ResilientValuationSession(
        x, y, ckpt_dir=tmp_path, mode=mode, k=K, test_batch=TB,
        ckpt_every=1, max_rollbacks=2, injector=inj, **CPU)
    sess.update(*batches[0])
    with pytest.raises(RuntimeError, match="non-finite state persists"):
        sess.update(*batches[1])


def test_nan_without_checkpoints_raises(tmp_path):
    x, y, batches = _problem()
    inj = FaultInjector([Fault("nan", at_seq=0)])
    sess = ResilientValuationSession(
        x, y, ckpt_dir=tmp_path, mode="sti", k=K, test_batch=TB,
        ckpt_every=0, injector=inj, **CPU)
    with pytest.raises(RuntimeError, match="no checkpointing"):
        sess.update(*batches[0])


@pytest.mark.parametrize("mode", DRILL_MODES)
def test_corrupted_checkpoint_restore_falls_back_bit_identical(
        jx, tmp_path, mode):
    x, y, batches = _problem()
    inj = FaultInjector([Fault("ckpt_corrupt", at_seq=3)])
    sess = ResilientValuationSession(
        x, y, ckpt_dir=tmp_path, mode=mode, k=K, test_batch=TB,
        ckpt_every=1, injector=inj, async_checkpoint=False, **CPU)
    for xb, yb in batches[:3]:
        sess.update(xb, yb)
    assert inj.fired("ckpt_corrupt")
    resumed = ResilientValuationSession.restore(tmp_path, x, y, **CPU)
    assert resumed.batches_folded == 2
    for xb, yb in batches:
        resumed.update(xb, yb)
    _assert_parity(resumed.finalize(), mode, jx)


@pytest.mark.parametrize("mode", DRILL_MODES)
def test_deadline_overrun_retries_and_flags(jx, tmp_path, mode):
    x, y, batches = _problem()
    inj = FaultInjector([Fault("deadline", at_seq=1, times=1, delay_s=0.4)])
    sess = ResilientValuationSession(
        x, y, ckpt_dir=tmp_path, mode=mode, k=K, test_batch=TB,
        ckpt_every=2, deadline_s=0.25, backoff_s=0.0, injector=inj, **CPU)
    for xb, yb in batches:
        sess.update(xb, yb)
    result = sess.finalize()
    _assert_parity(result, mode, jx)
    assert result.meta["resilience"]["retries"] >= 1


@pytest.mark.parametrize("mode", ["sti", "knn_shapley"])
def test_sharded_degradation_and_fewer_device_restore(jx, tmp_path, mode):
    """Repeated sharded-step failure degrades ["cpu"] * 4 to the first 3
    entries of the list, the dense checkpoint carrying the state; a fresh
    restore onto ["cpu"] * 2 replays to the same values."""
    x, y, batches = _problem()
    kill_at = int(np.random.default_rng(3).integers(1, len(batches)))
    inj = FaultInjector([Fault("device", at_seq=kill_at, times=4)])
    s = ResilientValuationSession(
        x, y, ckpt_dir=tmp_path, mode=mode, k=K, test_batch=TB,
        ckpt_every=1, devices=CPU4, injector=inj, max_retries=2,
        backoff_s=0.0)
    assert s.shards == 4
    for xb, yb in batches:
        s.update(xb, yb)
    r = s.finalize()
    res = r.meta["resilience"]
    assert res["degradations"][0] == {"from": 4, "to": 3}
    assert res["shards"] == 3 and s.inner.group.size == 3
    want = _baseline(mode)
    scale = np.abs(want).max()
    assert np.abs(_arr(r) - want).max() <= 1e-6 * scale
    ref = _jax_result(jx, mode)
    assert np.abs(_arr(r) - ref).max() <= 1e-6 * np.abs(ref).max()

    s2 = ResilientValuationSession.restore(
        tmp_path, x, y, step=2, devices=["cpu"] * 2)
    assert s2.shards == 2 and s2.batches_folded == 2
    for xb, yb in batches:
        s2.update(xb, yb)
    r2 = s2.finalize()
    assert np.abs(_arr(r2) - want).max() <= 1e-6 * scale
    assert r2.meta["resilience"]["replayed_skipped"] == 2


def test_sharded_floor_dies_then_restores_single_device(tmp_path):
    x, y, batches = _problem()
    inj = FaultInjector([Fault("device", at_seq=2, times=10)])
    s = ResilientValuationSession(
        x, y, ckpt_dir=tmp_path, mode="knn_shapley", k=K, test_batch=TB,
        ckpt_every=1, devices=CPU4, injector=inj, max_retries=1,
        backoff_s=0.0, min_shards=2)
    with pytest.raises(RuntimeError):
        for xb, yb in batches:
            s.update(xb, yb)
    # min_shards=2 blocks full degradation: 4 -> 3 -> 2 then dies
    assert s.shards == 2
    s2 = ResilientValuationSession.restore(
        tmp_path, x, y, sharded=False, shards=None, **CPU)
    assert s2.shards == 1
    for xb, yb in batches:
        s2.update(xb, yb)
    want = _baseline("knn_shapley")
    assert np.abs(_arr(s2.finalize()) - want).max() <= \
        1e-6 * np.abs(want).max()


def test_resilient_clean_run_bit_identical_and_cheap(jx, tmp_path):
    x, y, batches = _problem()
    sess = ResilientValuationSession(
        x, y, ckpt_dir=tmp_path, mode="wknn", k=K, test_batch=TB,
        ckpt_every=2, method_opts={"weights": "rbf"}, **CPU)
    for xb, yb in batches:
        sess.update(xb, yb)
    result = sess.finalize()
    _assert_parity(result, "wknn", jx)
    res = result.meta["resilience"]
    assert res["retries"] == 0 and res["rollbacks"] == 0
    assert res["checkpoint_steps"] == [2, 4]
    assert res["health"]["steps"] == len(batches)


def test_resilient_session_defaults_to_cuda(tmp_path):
    x, y, _ = _problem()
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResilientValuationSession(x, y, ckpt_dir=tmp_path, mode="sti")
    Checkpointer(tmp_path).save(1, {"a": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResilientValuationSession.restore(tmp_path, x, y)


def test_rebase_installs_an_owned_copy(tmp_path):
    x, y, batches = _problem()
    sess = ResilientValuationSession(
        x, y, ckpt_dir=tmp_path, mode="knn_shapley", k=K, test_batch=TB,
        ckpt_every=1, **CPU)
    sess.update(*batches[0])
    new = torch.arange(N, dtype=torch.float32)
    sess.rebase((new,), t=TB, seq=1)
    new.add_(1000.0)                      # the caller keeps writing
    np.testing.assert_array_equal(sess.inner._state[0].numpy(),
                                  np.arange(N, dtype=np.float32))
    got, step = sess._ckpt.restore(sess._tree_like())
    assert step == 1
    np.testing.assert_array_equal(got["state"]["vec"],
                                  np.arange(N, dtype=np.float32))


# ------------------------------------------------------ across packages
@pytest.mark.parametrize("mode", DRILL_MODES)
def test_cross_package_resume_both_ways(jx, tmp_path, mode):
    """A stream checkpointed after batch 2 by one package's resilient
    session is finished by the other's; both land within 1e-6 of max |ref|
    of JAX's uninterrupted result."""
    x, y, batches = _problem()
    ref = _jax_result(jx, mode)
    tol = 1e-6 * np.abs(ref).max()

    jsess = jx.Res(x, y, ckpt_dir=tmp_path / "j", mode=mode, k=K,
                   test_batch=TB, ckpt_every=2)
    for xb, yb in batches[:2]:
        jsess.update(xb, yb)
    jsess._ckpt.wait()
    port = ResilientValuationSession.restore(tmp_path / "j", x, y, **CPU)
    assert port.batches_folded == 2 and port.t_seen == 2 * TB
    for xb, yb in batches:
        port.update(xb, yb)
    got = port.finalize()
    assert got.meta["resilience"]["replayed_skipped"] == 2
    assert np.abs(_arr(got) - ref).max() <= tol

    psess = ResilientValuationSession(
        x, y, ckpt_dir=tmp_path / "p", mode=mode, k=K, test_batch=TB,
        ckpt_every=2, distance="plain", **CPU)
    for xb, yb in batches[:2]:
        psess.update(xb, yb)
    psess._ckpt.wait()
    jres = jx.Res.restore(tmp_path / "p", x, y)
    assert jres.batches_folded == 2
    assert jres._session_opts["distance"] == "xla"
    for xb, yb in batches:
        jres.update(xb, yb)
    assert np.abs(_arr(jres.finalize()) - ref).max() <= tol


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", DRILL_MODES)
def test_cuda_kill_rollback_resume_bit_identical(cuda, tmp_path, mode):
    """On the card: a NaN at seq 1 rolled back, a kill at seq 3, a restore
    and a replay finalize bit-identical to a bare card session, whose
    folds run the CUDA distance (and fill) kernels; the result is within
    1e-6 of max |ref| of the CPU's."""
    from repro_torch.kernels.distance import distance_cuda
    from repro_torch.kernels.sti_fill import sti_fill_acc_cuda

    x, y, batches = _problem()
    inj = FaultInjector([Fault("nan", at_seq=1, seed=1),
                         Fault("device", at_seq=3, times=10)])
    sess = ResilientValuationSession(
        x, y, ckpt_dir=tmp_path, mode=mode, k=K, test_batch=TB,
        ckpt_every=1, max_retries=1, backoff_s=0.0, injector=inj,
        device=cuda)
    with pytest.raises(RuntimeError):
        for xb, yb in batches:
            sess.update(xb, yb)
    sess._ckpt.wait()
    assert sess.resilience_summary()["rollbacks"] == 1
    resumed = ResilientValuationSession.restore(tmp_path, x, y, device=cuda)
    assert resumed.batches_folded == 3
    for xb, yb in batches:
        resumed.update(xb, yb)
    got = _arr(resumed.finalize())
    distance_cuda.launches = sti_fill_acc_cuda.launches = 0
    bare = ValuationSession(x, y, k=K, mode=mode, test_batch=TB,
                            device=cuda)
    for xb, yb in batches:
        bare.update(xb, yb)
    want = _arr(bare.finalize())
    assert distance_cuda.launches == len(batches)
    assert sti_fill_acc_cuda.launches == (len(batches) if mode == "sti"
                                          else 0)
    np.testing.assert_array_equal(got, want)
    ref = _baseline(mode)
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.cuda
def test_cuda_stepguard_waits_for_the_card(cuda):
    big = torch.randn((2048, 2048), device=cuda)
    out, dt = StepGuard().run(lambda: {"m": [big @ big]})
    assert dt > 0.0 and out["m"][0].is_cuda
    block_until_ready((out, [big]))


def test_a_dropped_session_frees_its_state_without_the_cycle_collector(
        tmp_path):
    """No reference cycle holds a session: `del` frees its (n, n) state at
    once (16 GiB on a card at n = 65536)."""
    import gc
    import weakref

    x, y, batches = _problem()
    gc.disable()
    try:
        inj = FaultInjector([Fault("device", at_seq=1, times=1)])
        sess = ResilientValuationSession(
            x, y, ckpt_dir=tmp_path, mode="sti", k=K, test_batch=TB,
            ckpt_every=1, backoff_s=0.0, injector=inj, **CPU)
        for xb, yb in batches[:2]:
            sess.update(xb, yb)
        assert sess.resilience_summary()["retries"] == 1
        sess._ckpt.wait()
        acc = weakref.ref(sess.inner._state[0])
        del sess
        assert acc() is None
        from repro_torch.serving.valuation_service import ValuationService

        svc = ValuationService(x, y, method="sti", capacity=N + 8,
                               test_batch=TB, **CPU)
        svc.value_query(batches[0][0], batches[0][1])
        acc = weakref.ref(svc._session.inner._state[0])
        svc.close()
        del svc
        assert acc() is None
    finally:
        gc.enable()
