"""utils/timer.py and the training engine's timers and TensorBoard
events: the port against the JAX package, on the CPU.

1. START/STOP, ELAPSED, REGISTRY: the JAX package's interval contract
   (``tests/unit/test_timer.py``) holds on the port's timers, under the
   same injected clocks; a registry-backed timer observes each completed
   interval into ``timer_seconds{timer=...}``.
2. THE TRAINING ENGINE: ``wall_clock_breakdown`` and ``memory_breakdown``
   change no loss, bit for bit; the port's engine times the JAX engine's
   phases under the JAX names (plus ``backward_inner``, the autograd
   call alone: the JAX engine's backward folds gradients a fused
   program already computed, so it has no such call); its registry
   carries the JAX engine's gauges.
3. TENSORBOARD: where ``torch.utils.tensorboard`` imports, the engine
   writes event files under ``<output_path>/<job_name>``; where it does
   not, it warns once and trains on.

No test here asserts a wall-clock bound.
"""

import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models.gpt2 import GPT2Config as JConfig
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JModel
from deepspeed_tpu.parallel import mesh as mesh_lib
from deepspeed_tpu.utils import timer as jtimer
from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.telemetry import MetricsRegistry
from deepspeed_tpu_torch.utils import timer as ttimer
from deepspeed_tpu_torch.utils.timer import (SynchronizedWallClockTimer,
                                             ThroughputTimer, _Interval)

torch.set_num_threads(1)

SEQ = 32


def _fake_clock(monkeypatch, start=0.0):
    clock = [start]
    fake = type("T", (), {"time": staticmethod(lambda: clock[0])})
    for mod in (jtimer, ttimer):
        monkeypatch.setattr(mod, "time", fake)
    return clock


# ------------------------------------------------------------- intervals


def test_start_stop_guards():
    t = _Interval("t")
    with pytest.raises(RuntimeError):
        t.stop()
    t.start()
    with pytest.raises(RuntimeError):
        t.start()
    t.stop()
    with pytest.raises(RuntimeError):
        t.stop()


def test_stop_accumulates_and_reset_replaces(monkeypatch):
    clock = _fake_clock(monkeypatch, 100.0)
    got = []
    for mod in (jtimer, ttimer):
        t = mod._Interval("t")
        t.start()
        clock[0] += 2.0
        t.stop()
        t.start()
        clock[0] += 3.0
        t.stop()
        acc = t.elapsed(reset=False)
        t.start()
        clock[0] += 1.0
        t.stop(reset=True)
        got.append((acc, t.elapsed(reset=False)))
    assert got[1] == got[0]
    assert got[1][0] == pytest.approx(5.0) and got[1][1] == pytest.approx(1.0)


def test_elapsed_peek_does_not_stop_running_interval(monkeypatch):
    clock = _fake_clock(monkeypatch)
    t = _Interval("t")
    t.start()
    clock[0] = 2.0
    assert t.elapsed(reset=False) == pytest.approx(2.0)
    clock[0] = 5.0
    assert t.elapsed(reset=False) == pytest.approx(5.0)
    t.stop()
    assert t.elapsed(reset=False) == pytest.approx(5.0)


def test_elapsed_reset_restarts_running_window(monkeypatch):
    clock = _fake_clock(monkeypatch)
    t = _Interval("t")
    t.start()
    clock[0] = 3.0
    assert t.elapsed(reset=True) == pytest.approx(3.0)
    clock[0] = 4.0
    assert t.elapsed(reset=False) == pytest.approx(1.0)
    t.stop()
    assert t.elapsed(reset=False) == pytest.approx(1.0)
    t.start()
    t.reset()
    assert t.elapsed(reset=False) == 0.0
    t.start()  # reset cleared the running flag
    t.stop()


def test_named_timers_create_on_demand_and_log(caplog):
    timers = SynchronizedWallClockTimer()
    timers("a").start()
    timers("a").stop()
    assert timers("a") is timers.timers["a"]
    logger = logging.getLogger("DeepSpeedTPUTorch")
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger="DeepSpeedTPUTorch"):
            timers.log(["a", "missing"], normalizer=2.0,
                       memory_breakdown=True)
    finally:
        logger.removeHandler(caplog.handler)
    assert "time (ms) | a: " in caplog.text and "missing" not in caplog.text
    # No CUDA in this process: the memory field says so.
    assert "MA n/a" in caplog.text
    with pytest.raises(ValueError):
        timers.log(["a"], normalizer=0.0)


def test_registry_backed_timer_observes_completed_intervals(monkeypatch):
    clock = _fake_clock(monkeypatch)
    texts = []
    from deepspeed_tpu.telemetry import MetricsRegistry as JRegistry
    from deepspeed_tpu.telemetry import prometheus_text as jtext
    from deepspeed_tpu_torch.telemetry import prometheus_text as ttext
    for mod, reg_cls, text in ((jtimer, JRegistry, jtext),
                               (ttimer, MetricsRegistry, ttext)):
        reg = reg_cls(engine="test")
        timers = mod.SynchronizedWallClockTimer(registry=reg)
        for i in range(3):
            timers("fwd").start()
            clock[0] += 0.25 * (i + 1)
            timers("fwd").stop()
        timers("bwd").start()
        clock[0] += 1.0
        timers("bwd").stop()
        h = reg.histogram("timer_seconds", timer="fwd")
        assert h.count == 3
        assert h.labels == {"engine": "test", "timer": "fwd"}
        assert reg.histogram("timer_seconds", timer="bwd").count == 1
        texts.append(text(reg))
    assert texts[1] == texts[0]


def test_throughput_timer_warmup_and_average(monkeypatch):
    clock = _fake_clock(monkeypatch, 100.0)
    reg = MetricsRegistry()
    tp = ThroughputTimer(batch_size=4, num_workers=2, start_step=2,
                         steps_per_output=100, registry=reg)
    assert reg.gauge("samples_per_sec").value == 0.0  # -inf clamped
    for _ in range(2):
        tp.start()
        tp.stop()
    assert tp.avg_samples_per_sec() == float("-inf")
    for _ in range(3):
        tp.start()
        clock[0] += 0.5
        tp.stop()
    assert tp.avg_samples_per_sec() == pytest.approx(16.0)
    assert reg.gauge("samples_per_sec").value == pytest.approx(16.0)


def test_throughput_timer_synchronizes_at_timing_start_and_reports(
        monkeypatch):
    """The port's timer drains the device queue when timing begins and
    at each report, not at every step (its docstring): of 9 steps at
    steps_per_output 3 (2 of warm-up), the first timed start and the
    closes of steps 3, 6 and 9 synchronize."""
    clock = _fake_clock(monkeypatch, 100.0)
    syncs = []
    monkeypatch.setattr(ttimer, "_device_synchronize",
                        lambda: syncs.append(clock[0]))
    logged = []
    tp = ThroughputTimer(batch_size=2, num_workers=1, start_step=2,
                         steps_per_output=3, logging_fn=logged.append)
    for _ in range(9):
        tp.start()
        clock[0] += 0.25
        tp.stop()
    assert syncs == [100.5, 100.75, 101.5, 102.25]
    assert len(logged) == 3
    assert tp.avg_samples_per_sec() == pytest.approx(8.0)


# ------------------------------------------------------ training engine

_PARAMS = {}


def _params():
    if not _PARAMS:
        ids = np.random.RandomState(0).randint(0, 1024, size=(2, SEQ))
        _PARAMS["p"] = jax.tree_util.tree_map(np.asarray, JModel(
            JConfig.tiny(dtype=jnp.float32)).init(
                jax.random.PRNGKey(0), jnp.asarray(ids))["params"])
    return _PARAMS["p"]


def _config(**extra):
    cfg = {"train_batch_size": 4, "steps_per_print": 1,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}}
    cfg.update(extra)
    return cfg


def _port(**extra):
    return tds.initialize(
        model=GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.float32),
                              device="cpu", seed=None),
        model_parameters=_params(), config_params=_config(**extra),
        device="cpu")[0]


def _steps(engine, n=3):
    losses = []
    for i in range(n):
        ids = np.random.RandomState(10 + i).randint(0, 1024, size=(4, SEQ))
        loss = engine(ids, ids)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss.detach() if isinstance(loss, torch.Tensor)
                            else loss))
    return losses


BREAKDOWN = {"wall_clock_breakdown": True, "memory_breakdown": True}


def test_breakdown_changes_no_loss_and_times_the_jax_phases():
    off = _port()
    on = _port(**BREAKDOWN)
    assert _steps(on) == _steps(off)  # bit for bit
    assert off.timers.timers == {}
    mesh = mesh_lib.build_mesh(num_dp=1, devices=jax.devices()[:1])
    jeng = jds.initialize(
        model=JModel(JConfig.tiny(dtype=jnp.float32)),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, _params()),
        config_params=_config(**BREAKDOWN), mesh=mesh)[0]
    jl = _steps(jeng)
    np.testing.assert_allclose(_steps(_port(**BREAKDOWN)), jl, rtol=1e-5)
    port_names, jax_names = set(on.timers.timers), set(jeng.timers.timers)
    assert port_names - jax_names == {"backward_inner"}
    assert jax_names <= port_names
    snap = on.telemetry.snapshot()
    for name in port_names:
        assert snap["timer_seconds{timer=" + name + "}"]["count"] == 3
    # The JAX engine's gauges, read at scrape time.
    jsnap = jeng.telemetry.snapshot()
    for key in ("global_steps", "global_samples", "skipped_steps", "lr",
                "samples_per_sec"):
        assert key in jsnap and key in snap, key
    assert snap["global_steps"] == 3 and snap["global_samples"] == 12
    assert snap["lr"] == pytest.approx(1e-2)
    assert snap["samples_per_sec"] > 0  # one step past the two warm-up


def test_dropped_training_engine_is_freed_without_the_cycle_collector():
    import gc
    import weakref

    eng = _port(**BREAKDOWN)
    _steps(eng, 1)
    assert eng.telemetry.snapshot()["global_steps"] == 1
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_summary_writer_writes_event_files(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    eng = _port(tensorboard={"enabled": True, "output_path": str(tmp_path),
                             "job_name": "gpt2"})
    assert eng._tensorboard_log_dir() == str(tmp_path / "gpt2")
    _steps(eng, 2)
    writer = eng.get_summary_writer()
    writer.flush()
    events = list((tmp_path / "gpt2").glob("events.out.tfevents.*"))
    assert events and events[0].stat().st_size > 0


def test_summary_writer_degrades_once_without_tensorboard(tmp_path,
                                                          monkeypatch,
                                                          caplog):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    eng = _port(tensorboard={"enabled": True, "output_path": str(tmp_path),
                             "job_name": "gpt2"})
    logger = logging.getLogger("DeepSpeedTPUTorch")
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger="DeepSpeedTPUTorch"):
            losses = _steps(eng, 3)
    finally:
        logger.removeHandler(caplog.handler)
    assert all(np.isfinite(losses))
    assert caplog.text.count("tensorboard scalars disabled") == 1
    assert not (tmp_path / "gpt2").exists()
    with pytest.raises(RuntimeError, match="tensorboard is unavailable"):
        eng.get_summary_writer()
