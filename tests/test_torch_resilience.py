"""The PyTorch port's training guardian against the JAX package's: the
numeric guard (loss scaling, skip-step), the rollback ring, the checkpoint
fallback, the watchdog, the guard-disabled path and the guard's telemetry,
mirroring tests/test_resilience.py on the port's ShardedTrainer (a gluon
Dense(4) with L2Loss on the CPU).

The host automaton (NumericGuard) is held to the JAX package's exactly: the
same event sequences give the same scales and streaks. The device side
(``ShardedTrainer.step_guarded``) is held to the port's own plain step: a
guarded step at scale 1 equals ``step`` bit for bit when finite, and a
non-finite step leaves every parameter and optimizer slot bitwise as it
was. Not mirrored: the ZeRO-1 cases and the multi-process chaos drill
(``test_chaos_nan_hang_sigterm_resume``), which wait for the mesh slice
(ROADMAP Queue 1 item 12), and the hung dataloader worker, whose loader is
not ported (Queue 1 item 13).
"""

import json
import math
import os
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu import resilience as jres
from incubator_mxnet_tpu_torch import gluon, telemetry
from incubator_mxnet_tpu_torch.parallel import ShardedTrainer
from incubator_mxnet_tpu_torch.resilience import (GuardedTrainer,
                                                  NumericGuard, RollbackRing,
                                                  TrainingDivergedError,
                                                  Watchdog)
from incubator_mxnet_tpu_torch.resilience import watchdog as wd_mod
from incubator_mxnet_tpu_torch.utils.checkpoint import CheckpointManager


@pytest.fixture(autouse=True)
def _no_stray_watchdog():
    yield
    w = wd_mod.current()
    if w is not None:
        w.stop()


@pytest.fixture(autouse=True)
def _gluon_names_unchanged():
    """The gluon Dense blocks built here advance the port's per-alias name
    counters (global to the process) and not the JAX package's; restored
    after each test, so a later test in the same process that compares the
    two packages' names sees both counters where it would."""
    from incubator_mxnet_tpu_torch.gluon.block import _BlockScope
    saved = dict(_BlockScope._counters)
    yield
    _BlockScope._counters.clear()
    _BlockScope._counters.update(saved)


def _net(seed=0):
    net = gluon.nn.Dense(4)
    net.initialize(ctx=mx.cpu())
    torch.manual_seed(seed)
    net(torch.from_numpy(np.random.RandomState(0).rand(8, 4)
                         .astype(np.float32)))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(seed)
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    return net


def _make_trainer(optimizer="adam", net=None, **kw):
    return ShardedTrainer(net if net is not None else _net(),
                          gluon.loss.L2Loss(), optimizer=optimizer,
                          device="cpu", **kw)


def _batch(seed=0, bad=False):
    rng = np.random.RandomState(seed)
    x = rng.rand(8, 4).astype(np.float32)
    y = rng.rand(8, 4).astype(np.float32)
    if bad:
        x = np.full_like(x, np.nan)
    return x, y


def _params(tr):
    return {n: v.detach().clone() for n, v in tr.param_values.items()}


def _state(tr):
    return {k: v.clone() for k, v in tr.state_dict().items() if k != "step"}


# --------------------------------------------------------------- guard unit
def test_numeric_guard_scale_automaton():
    g = NumericGuard(init_scale=1024.0, growth_factor=2.0,
                     backoff_factor=0.5, growth_interval=3,
                     min_scale=1.0, max_scale=4096.0)
    for _ in range(2):
        g.on_good_step()
    assert g.scale == 1024.0
    g.on_good_step()
    assert g.scale == 2048.0
    g.on_bad_step()
    assert g.scale == 1024.0 and g.good_streak == 0
    for _ in range(20):
        g.on_bad_step()
    assert g.scale == 1.0
    g2 = NumericGuard(init_scale=4096.0, growth_interval=1,
                      max_scale=4096.0)
    g2.on_good_step()
    assert g2.scale == 4096.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numeric_guard_follows_the_jax_automaton(seed):
    """The same random sequence of good and bad steps through both
    packages' guards gives the same scale and streak after every event."""
    kw = dict(init_scale=2.0 ** 10, growth_factor=2.0, backoff_factor=0.5,
              growth_interval=3, min_scale=1.0, max_scale=2.0 ** 12)
    port, ref = NumericGuard(**kw), jres.NumericGuard(**kw)
    rs = np.random.RandomState(seed)
    for good in rs.rand(200) < 0.7:
        for g in (port, ref):
            g.on_good_step() if good else g.on_bad_step()
        assert (port.scale, port.good_streak) == (ref.scale, ref.good_streak)


def test_numeric_guard_env_defaults(monkeypatch):
    monkeypatch.setenv("MXTPU_GUARD_INIT_SCALE", "256")
    monkeypatch.setenv("MXTPU_GUARD_GROWTH_INTERVAL", "7")
    g = NumericGuard()
    assert g.scale == 256.0 and g.growth_interval == 7
    assert (g.scale, g.growth_interval) == (jres.NumericGuard().scale,
                                            jres.NumericGuard()
                                            .growth_interval)
    monkeypatch.setenv("MXTPU_GUARD_INIT_SCALE", "nope")
    with pytest.raises(ValueError, match="MXTPU_GUARD_INIT_SCALE"):
        NumericGuard()


# ------------------------------------------------------------ guarded steps
def test_nan_batch_skips_update_and_backs_off():
    tr = _make_trainer()
    guardian = GuardedTrainer(
        tr, guard=NumericGuard(init_scale=1024.0),
        ring=RollbackRing(depth=2, interval=1000),
        skip_budget=10, rollback_after=100, enabled=True)
    data, label = _batch(0)
    guardian.step(data, label)
    before = _state(tr)
    bad_data, _ = _batch(0, bad=True)
    loss = guardian.step(bad_data, label)
    assert guardian.skipped_steps == 1
    assert not math.isfinite(float(loss))
    assert guardian.loss_scale == 512.0
    after = _state(tr)
    for n in before:                   # parameters and Adam's m and v
        assert torch.equal(before[n], after[n]), n
    guardian.step(data, label)
    assert any(not torch.equal(after["param/" + n], p)
               for n, p in _params(tr).items())


def test_loss_scale_overflow_backs_off_until_finite():
    tr = _make_trainer()
    guardian = GuardedTrainer(
        tr, guard=NumericGuard(init_scale=2.0 ** 120, growth_interval=4,
                               max_scale=2.0 ** 127),
        ring=RollbackRing(depth=1, interval=10_000),
        skip_budget=50, rollback_after=100, enabled=True)
    rng = np.random.RandomState(1)
    data = rng.rand(8, 4).astype(np.float32)
    label = (rng.rand(8, 4) * 100.0).astype(np.float32)
    bad = good = 0
    for _ in range(20):
        before = guardian.skipped_steps
        guardian.step(data, label)
        if guardian.skipped_steps > before:
            bad += 1
        else:
            good += 1
            break
    assert bad >= 1 and good == 1
    assert guardian.loss_scale < 2.0 ** 120
    g2 = GuardedTrainer(tr, guard=NumericGuard(init_scale=64.0,
                                               growth_interval=2),
                        ring=RollbackRing(depth=1, interval=10_000),
                        enabled=True)
    for _ in range(2):
        g2.step(data, label)
    assert g2.loss_scale == 128.0


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_guarded_step_matches_plain_step_when_finite(optimizer):
    """Guard on (scale 1.0) equals step() bit for bit: the select keeps the
    update. Two nets from one seed, as the port's trainers hold their
    block's tensors."""
    hp = {"learning_rate": 0.05, "momentum": 0.9}
    tr_a = _make_trainer(optimizer, optimizer_params=hp)
    tr_b = _make_trainer(optimizer, optimizer_params=hp)
    data, label = _batch(2)
    for _ in range(2):
        la = tr_a.step(data, label, key=7)
        lb, bad, gnorm = tr_b.step_guarded(data, label, loss_scale=1.0,
                                           key=7)
        assert not bad and math.isfinite(gnorm)
        assert torch.equal(la, lb)
    sa, sb = _state(tr_a), _state(tr_b)
    for n in sa:
        assert torch.equal(sa[n], sb[n]), n


def test_guarded_step_reports_the_fp32_gradient_norm():
    tr = _make_trainer()
    data, label = _batch(3)
    _, bad, gnorm = tr.step_guarded(data, label, loss_scale=256.0)
    grads = [p.grad for p in tr._block.parameters()]
    want = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
    assert not bad and abs(gnorm - want) <= 1e-5 * want
    bad_data, _ = _batch(3, bad=True)
    _, bad, gnorm = tr.step_guarded(bad_data, label)
    assert bad and not math.isfinite(gnorm)


def test_guarded_step_under_bf16_compute_keeps_a_skipped_step_bitwise():
    """compute_dtype bf16 and param_dtype bf16: an infinite loss scale
    skips the step on the device, every tensor of the state unchanged."""
    for kw in ({"compute_dtype": "bfloat16"}, {"param_dtype": "bfloat16"}):
        tr = _make_trainer(**kw)
        data, label = _batch(4)
        tr.step_guarded(data, label, loss_scale=8.0)
        before = _state(tr)
        _, bad, _ = tr.step_guarded(data, label, loss_scale=math.inf)
        assert bad
        after = _state(tr)
        for n in before:
            assert torch.equal(before[n], after[n]), (kw, n)


# ---------------------------------------------------------------- rollback
def test_rollback_ring_rewinds_to_last_good():
    tr = _make_trainer()
    ring = RollbackRing(depth=2, interval=1)
    guardian = GuardedTrainer(tr, ring=ring, skip_budget=20,
                              rollback_after=2, enabled=True)
    data, label = _batch(5)
    for _ in range(3):
        guardian.step(data, label)
    good = _state(tr)
    good_step = tr._step_count
    snap_steps = ring.steps()
    assert snap_steps and snap_steps[-1] == good_step
    bad_data, _ = _batch(5, bad=True)
    guardian.step(bad_data, label)
    assert guardian.rollbacks == 0
    guardian.step(bad_data, label)
    assert guardian.rollbacks == 1
    assert tr._step_count == good_step
    now = _state(tr)
    for n in good:
        assert torch.equal(good[n], now[n]), n
    guardian.step(data, label)
    assert tr._step_count == good_step + 1


def test_rollback_falls_back_to_checkpoint_when_ring_dry(tmp_path):
    tr = _make_trainer()
    guardian = GuardedTrainer(
        tr, checkpoint_manager=CheckpointManager(str(tmp_path),
                                                 async_save=False),
        ring=RollbackRing(depth=1, interval=10_000),
        skip_budget=50, rollback_after=1, enabled=True)
    data, label = _batch(6)
    guardian.step(data, label)
    guardian.save_checkpoint()
    ckpt_step = tr._step_count
    saved = _state(tr)
    guardian.step(data, label)
    bad_data, _ = _batch(6, bad=True)
    guardian.step(bad_data, label)     # rollback 1: the construction snap
    assert guardian.rollbacks == 1
    guardian.step(bad_data, label)     # rollback 2: ring dry -> checkpoint
    assert guardian.rollbacks == 2
    assert tr._step_count == ckpt_step
    now = _state(tr)
    for n in saved:
        assert torch.equal(saved[n], now[n]), n
    meta = json.load(open(os.path.join(
        tmp_path, "ckpt-%08d" % ckpt_step, "meta.json")))
    assert meta["guardian"]["enabled"] is True
    guardian.step(data, label)
    assert guardian.skipped_steps == 2


def test_diverged_when_no_rollback_source():
    tr = _make_trainer()
    guardian = GuardedTrainer(tr, ring=RollbackRing(depth=1, interval=1000),
                              skip_budget=50, rollback_after=1, enabled=True)
    data, label = _batch(7)
    guardian.step(data, label)
    bad_data, _ = _batch(7, bad=True)
    guardian.step(bad_data, label)
    with pytest.raises(TrainingDivergedError, match="no checkpoint_manager"):
        guardian.step(bad_data, label)


def test_skip_budget_exhaustion_raises():
    tr = _make_trainer()
    guardian = GuardedTrainer(tr, ring=RollbackRing(depth=2, interval=1),
                              skip_budget=3, rollback_after=100,
                              enabled=True)
    data, label = _batch(8)
    guardian.step(data, label)
    bad_data, _ = _batch(8, bad=True)
    for _ in range(3):
        guardian.step(bad_data, label)
    with pytest.raises(TrainingDivergedError, match="skip budget"):
        guardian.step(bad_data, label)


def test_device_snapshot_restores_more_than_once():
    """A snapshot outlives the steps after it: snapshot, step, restore,
    step, restore again."""
    tr = _make_trainer()
    data, label = _batch(9)
    tr.step(data, label)
    snap = tr.device_snapshot()
    ref = _state(tr)
    tr.step(data, label)
    tr.restore_device_snapshot(snap)
    for n, v in _state(tr).items():
        assert torch.equal(ref[n], v), n
    tr.step(data, label)
    tr.restore_device_snapshot(snap)
    for n, v in _state(tr).items():
        assert torch.equal(ref[n], v), n
    assert tr._step_count == snap["step"]


# ---------------------------------------------------------------- watchdog
def test_watchdog_fires_on_expired_phase(tmp_path):
    dump = str(tmp_path / "wd.txt")
    wd = Watchdog(poll=0.05, dump_path=dump, install=False)
    try:
        with wd.phase("step", timeout=0.1):
            time.sleep(0.4)
        assert wd.fired and wd.fired[0][0] == "step"
        text = open(dump).read()
        assert "MXTPU WATCHDOG" in text
        assert "test_watchdog_fires_on_expired_phase" in text
        assert "mxtpu-watchdog" in text
    finally:
        wd.stop()


def test_watchdog_phase_completes_without_firing():
    wd = Watchdog(poll=0.02, install=False)
    try:
        for _ in range(3):
            with wd.phase("step", timeout=5.0):
                time.sleep(0.01)
        time.sleep(0.1)
        assert wd.fired == []
        assert wd._entries == {}
    finally:
        wd.stop()


def test_watchdog_fires_once_per_phase_entry():
    wd = Watchdog(poll=0.02, install=False)
    try:
        with wd.phase("rpc", timeout=0.05):
            time.sleep(0.3)
        assert len(wd.fired) == 1
    finally:
        wd.stop()


def test_watchdog_env_configuration(monkeypatch):
    monkeypatch.setenv("MXTPU_WATCHDOG_STEP_TIMEOUT", "123")
    monkeypatch.setenv("MXTPU_WATCHDOG_BATCH_TIMEOUT", "45")
    wd = Watchdog(install=False)
    try:
        assert wd._timeouts["step"] == 123.0
        assert wd._timeouts["batch_wait"] == 45.0
        assert wd._timeouts["rpc"] == 300.0
    finally:
        wd.stop()


def test_watchdog_install_current():
    assert wd_mod.current() is None
    wd = Watchdog(install=True)
    try:
        assert wd_mod.current() is wd
    finally:
        wd.stop()
    assert wd_mod.current() is None


def test_format_thread_stacks_lists_this_frame():
    text = wd_mod.format_thread_stacks()
    assert "test_format_thread_stacks_lists_this_frame" in text


def test_guardian_step_runs_inside_watchdog_phase():
    tr = _make_trainer()
    wd = Watchdog(step_timeout=0.0, poll=0.01, install=False)
    try:
        guardian = GuardedTrainer(tr, ring=RollbackRing(depth=1,
                                                        interval=1000),
                                  watchdog=wd, skip_budget=5,
                                  rollback_after=100, enabled=True)
        data, label = _batch(10)
        deadline = time.time() + 2.0
        while not wd.fired and time.time() < deadline:
            guardian.step(data, label)
        assert any(ph == "step" for ph, _, _ in wd.fired)
        assert "watchdog_fired" in guardian.stats()
    finally:
        wd.stop()


# ----------------------------------------------------------- guard disabled
def test_guard_disabled_step_overhead(monkeypatch):
    class StubTrainer:
        def step(self, data, label, key=None):
            return 0.0

    monkeypatch.setenv("MXTPU_GUARD", "0")
    guardian = GuardedTrainer(StubTrainer())
    assert guardian._enabled is False
    assert guardian._guard is None
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        guardian.step(None, None)
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 5e-6


def test_guard_disabled_uses_plain_step_path():
    calls = []

    class StubTrainer:
        def step(self, data, label, key=None):
            calls.append("plain")
            return 1.5

        def step_guarded(self, *a, **kw):
            raise AssertionError("guarded path used while disabled")

    guardian = GuardedTrainer(StubTrainer(), enabled=False)
    assert guardian.step("d", "l") == 1.5
    assert calls == ["plain"]
    assert guardian.stats()["enabled"] is False


# --------------------------------------------------------------- telemetry
def test_guard_telemetry_instruments():
    from incubator_mxnet_tpu_torch.telemetry import catalog as cat
    telemetry.enable()
    try:
        base_skip = cat.guard_skipped_steps.value()
        base_roll = cat.guard_rollbacks.value(source="ring")
        base_snap = cat.rollback_snapshots.value()
        base_steps = cat.trainer_steps.value(zero="off", pipeline="off")
        tr = _make_trainer()
        guardian = GuardedTrainer(
            tr, guard=NumericGuard(init_scale=64.0),
            ring=RollbackRing(depth=2, interval=1),
            skip_budget=20, rollback_after=2, enabled=True)
        data, label = _batch(11)
        guardian.step(data, label)
        bad_data, _ = _batch(11, bad=True)
        guardian.step(bad_data, label)
        guardian.step(bad_data, label)
        assert cat.guard_skipped_steps.value() - base_skip == 2
        assert cat.guard_rollbacks.value(source="ring") - base_roll == 1
        assert cat.rollback_snapshots.value() - base_snap >= 2
        assert cat.guard_loss_scale.value() == guardian.loss_scale
        assert cat.trainer_steps.value(zero="off", pipeline="off") \
            - base_steps == 3
    finally:
        telemetry.disable()
