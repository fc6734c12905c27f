"""Wall-clock and throughput timers.

Counterpart of ``deepspeed_tpu/utils/timer.py``, with the same names
and signatures. ``SynchronizedWallClockTimer``
brackets each interval with a device synchronization, so an interval
covers the device work queued inside it: ``torch.cuda.synchronize()``
once CUDA is initialized in the process, nothing before (a CPU run has
no queue to drain). A synchronization inside a CUDA graph capture
raises, so a timer starts and stops outside every capture.
``ThroughputTimer`` synchronizes less often than the JAX package's (see
its docstring).
"""

import time

import torch

from deepspeed_tpu_torch.utils.logging import logger


def _device_synchronize():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Interval:
    """One named accumulating interval. start()/stop() bracket device
    work (synchronized on both edges); elapsed() reads the accumulated
    seconds without disturbing a running interval.

    ``histogram`` (optional) is a telemetry sink with an ``observe(v)``
    method: every completed start/stop interval is observed into it, so
    a registry-backed timer gets p50/p99 per phase."""

    __slots__ = ("name", "_acc", "_t0", "histogram", "_sync")

    def __init__(self, name, histogram=None, sync=None):
        self.name = name
        self._acc = 0.0
        self._t0 = None  # None <=> not running
        self.histogram = histogram
        self._sync = sync or _device_synchronize

    def start(self):
        if self._t0 is not None:
            raise RuntimeError("timer {!r} already started".format(self.name))
        self._sync()
        self._t0 = time.time()

    def stop(self, reset=False):
        if self._t0 is None:
            raise RuntimeError("timer {!r} not started".format(self.name))
        self._sync()
        dt = time.time() - self._t0
        self._acc = dt if reset else self._acc + dt
        self._t0 = None
        if self.histogram is not None:
            self.histogram.observe(dt)

    def reset(self):
        self._acc = 0.0
        self._t0 = None

    def elapsed(self, reset=True):
        """Read accumulated seconds (including the in-flight portion of
        a RUNNING interval) WITHOUT stopping it: a pure peek, with no
        device synchronization. ``reset=True`` zeroes the accumulator
        and restarts the running window at now (the windowed-snapshot
        semantics ``metrics(reset=True)`` builds on)."""
        now = time.time()
        out = self._acc
        if self._t0 is not None:
            out += now - self._t0
        if reset:
            self._acc = 0.0
            if self._t0 is not None:
                self._t0 = now
        return out


class SynchronizedWallClockTimer:
    """Dict of named ``_Interval``s; ``timers(name)`` creates on demand.

    ``registry`` (optional): a telemetry MetricsRegistry. Each named
    interval then observes its completed durations into the registry's
    ``timer_seconds`` histogram labeled ``timer=<timer name>``, which is
    how the training and serving phase timers reach Prometheus and
    TensorBoard. ``sync`` (optional): what an interval's edges wait on
    instead of the whole device (a serving engine passes its own
    stream's ``synchronize``, so one replica's timer neither waits for
    nor disturbs another replica's work on the same card)."""

    Timer = _Interval

    def __init__(self, registry=None, sync=None):
        self.timers = {}
        self.registry = registry
        self._sync = sync

    def __call__(self, name):
        t = self.timers.get(name)
        if t is None:
            hist = None
            if self.registry is not None:
                hist = self.registry.histogram("timer_seconds", timer=name)
            t = self.timers[name] = _Interval(name, histogram=hist,
                                              sync=self._sync)
        return t

    @staticmethod
    def memory_usage():
        """The caching allocator's current and peak allocated bytes
        (``torch.cuda.memory_stats``), or ``MA n/a`` before CUDA is
        initialized."""
        if not torch.cuda.is_initialized():
            return "MA n/a"
        stats = torch.cuda.memory_stats()
        gib = 1024.0 ** 3
        return "MA {:.2f} GB  Max_MA {:.2f} GB".format(
            stats.get("allocated_bytes.all.current", 0) / gib,
            stats.get("allocated_bytes.all.peak", 0) / gib)

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=False):
        """One log line of per-name elapsed ms / ``normalizer``."""
        if normalizer <= 0.0:
            raise ValueError("normalizer must be positive")
        parts = ["{}: {:.2f}".format(
            n, self.timers[n].elapsed(reset=reset) * 1000.0 / normalizer)
            for n in names if n in self.timers]
        line = " | ".join(["time (ms)"] + parts)
        if memory_breakdown:
            line += " | " + self.memory_usage()
        logger.info(line)


class ThroughputTimer:
    """Samples/sec every ``steps_per_output`` steps. The first
    ``start_step`` steps are warm-up (first kernel builds, cuBLAS
    set-up) and are excluded from the average.

    Unlike the JAX package's timer (and the reference's), it does not
    synchronize the device at every step's edges: an eager step enqueues
    thousands of kernels, and draining the queue twice per step cost
    GPT-2 medium some 5% and BERT-large some 10% of their step on an H100
    (PERF.md). It synchronizes once when timing begins (the warm-up's
    queued work stays out) and at the close of each step that ends a
    ``steps_per_output`` window, so each window's total holds its device
    work; between reports the average may lag the device by the work
    still queued, at most about a step."""

    def __init__(self, batch_size, num_workers, start_step=2,
                 steps_per_output=50, monitor_memory=False,
                 logging_fn=None, registry=None):
        self.batch_size = batch_size or 1
        self.num_workers = num_workers
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or logger.info
        # A live samples/sec gauge when a registry is given (read at
        # scrape time, -inf clamped to 0).
        if registry is not None:
            registry.gauge("samples_per_sec").set_fn(
                lambda: max(self.avg_samples_per_sec(), 0.0))
        self.epoch_count = 0
        self.local_step_count = 0
        self.total_step_count = 0
        self.total_elapsed_time = 0.0
        self._running_since = None

    def update_epoch_count(self):
        self.epoch_count += 1
        self.local_step_count = 0

    def start(self):
        if self.total_step_count >= self.start_step:
            if self.total_step_count == self.start_step:
                _device_synchronize()  # the first timed step
            self._running_since = time.time()
        else:
            self._running_since = 0.0  # warm-up step: counted, not timed

    def stop(self, report_speed=True):
        if self._running_since is None:
            return
        timed = self._running_since > 0.0
        self.total_step_count += 1
        self.local_step_count += 1
        window_end = self.local_step_count % self.steps_per_output == 0
        if timed:
            if window_end:
                _device_synchronize()
            self.total_elapsed_time += time.time() - self._running_since
        self._running_since = None
        if timed and report_speed and window_end:
            self.logging("{}/{}, SamplesPerSec={}".format(
                self.epoch_count, self.local_step_count,
                self.avg_samples_per_sec()))

    def avg_samples_per_sec(self):
        timed_steps = self.total_step_count - self.start_step
        if timed_steps <= 0 or self.total_elapsed_time <= 0:
            return float("-inf")
        per_step = self.total_elapsed_time / timed_steps
        return self.batch_size * self.num_workers / per_step
