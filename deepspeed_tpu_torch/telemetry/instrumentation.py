"""Device instrumentation: recompile detection + profiler hooks.

Counterpart of ``deepspeed_tpu/telemetry/instrumentation.py``, with the
same names:

- ``RecompileDetector``: turns the ``compile_count`` contract into a
  RUNTIME gauge. Watches a set of program caches (anything exposing
  ``_cache_size()``; the serving engine's cache holds one captured CUDA
  graph per program key), exposes the live total as a registry gauge,
  and after ``mark_warm()`` counts every further cache miss as a
  RECOMPILE (counter + one warning log per event, naming the program
  that grew).

- ``annotate(name)``: ``torch.profiler.record_function(name)`` together
  with an NVTX range (``torch.cuda.nvtx.range_push/pop`` once CUDA is
  initialized), so the named scopes (mixed step, harvest) show in a
  ``profile_window`` capture and in Nsight alike. Host-side only: it
  wraps the launch of device work.

- ``profile_window()``: a ``DS_TPU_PROFILE_DIR``-gated
  ``torch.profiler.profile`` capture (CPU activity, plus CUDA where a
  GPU is present) exported as a Chrome trace beneath that directory.
  When the variable is unset (the default), it is a no-op context. One
  capture at a time per process: a window nested in another, opened
  beside another thread's, or opened while any other torch profiler
  runs is a no-op rather than an error mid-serve.
"""

import contextlib
import os
import threading
import time

import torch

from deepspeed_tpu_torch.utils.logging import logger

PROFILE_DIR_ENV = "DS_TPU_PROFILE_DIR"


class RecompileDetector(object):
    """Live compile-count gauge + post-warmup recompile counter over a
    set of program caches.

    ``registry`` is a MetricsRegistry (or NullRegistry); ``watch(label,
    program)`` registers any object with a ``_cache_size()`` (the
    serving engine's program cache: one captured program per key);
    ``observe()`` re-reads every cache and updates the gauges — call it
    at step boundaries (cheap: one int read per program).
    ``mark_warm()`` freezes the expected total; any growth past it
    increments the ``recompiles`` counter and logs a warning naming the
    offender. ``describe`` is an optional ``label -> str`` hook that
    lets the warning name the exact program (the serving engine names
    the key met after warm-up)."""

    def __init__(self, registry, describe=None, **labels):
        self._describe = describe
        self._programs = {}
        self._last = {}
        self._warm_total = None
        self.gauge = registry.gauge("compile_count", **labels)
        self.recompiles = registry.counter("recompiles", **labels)
        # The gauge reads the watched caches, not the detector: no cycle
        # holds a dropped engine's programs (CUDA graphs) alive.
        programs = self._programs
        self.gauge.set_fn(
            lambda: sum(p._cache_size() for p in programs.values()))

    def watch(self, label, program):
        if not hasattr(program, "_cache_size"):
            raise TypeError(
                "RecompileDetector.watch({!r}): object has no _cache_size()"
                " — pass the program cache itself".format(label))
        self._programs[label] = program
        self._last[label] = 0
        return program

    def total(self):
        return sum(p._cache_size() for p in self._programs.values())

    @property
    def warm(self):
        return self._warm_total is not None

    def mark_warm(self):
        """Freeze the expected compile total at its current value: every
        later growth is a recompile. Re-observing first so compiles that
        already happened are not misread as post-warmup."""
        self.observe()
        self._warm_total = self.total()
        return self._warm_total

    def observe(self):
        """Re-read every watched cache; returns the number of NEW
        post-warmup compiles seen by this call (0 during warmup)."""
        new_after_warm = 0
        for label, prog in self._programs.items():
            size = prog._cache_size()
            grew = size - self._last[label]
            if grew > 0:
                self._last[label] = size
                if self._warm_total is not None:
                    new_after_warm += grew
                    self.recompiles.inc(grew)
                    got = (self._describe(label)
                           if self._describe is not None else None)
                    ident = " [{}]".format(got) if got else ""
                    logger.warning(
                        "telemetry: program %r recompiled (%d new "
                        "compilation%s, total compile_count=%d) after "
                        "warmup — a program key was met for the first "
                        "time%s", label, grew,
                        "" if grew == 1 else "s", self.total(), ident)
        return new_after_warm


class _Annotation(object):
    """``record_function`` scope plus an NVTX range (module docstring).
    The scope is opened only while a torch profiler records (it is what
    reads it); the NVTX range costs little and is always pushed once
    CUDA is initialized, for a profiler outside the process."""

    __slots__ = ("name", "_scope", "_nvtx")

    def __init__(self, name):
        self.name = name
        self._scope = None
        self._nvtx = False

    def __enter__(self):
        if torch.autograd.profiler._is_profiler_enabled:
            self._scope = torch.profiler.record_function(self.name)
            self._scope.__enter__()
        self._nvtx = torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        if self._scope is not None:
            self._scope.__exit__(*exc)
        return False


def annotate(name):
    """A ``torch.profiler.record_function(name)`` scope with an NVTX
    range of the same name. Host-side scoping only: wrap the LAUNCH of
    device work (a replayed graph's kernels run after the scope
    closes; their device spans carry their own names)."""
    return _Annotation(name)


_profile_lock = threading.Lock()


@contextlib.contextmanager
def profile_window(subdir=None):
    """Profiler capture window gated on ``DS_TPU_PROFILE_DIR``.

    Unset env (the default): pure no-op. Set: the body runs under
    ``torch.profiler.profile`` and its Chrome trace is written beneath
    the directory (plus ``subdir`` when given) as ``trace.<ms>.json``;
    the context yields the directory. A second window while one is
    active (nested, in another thread, or any torch profiler already
    running) yields None instead of raising: profiling must never take
    the serving loop down."""
    base = os.environ.get(PROFILE_DIR_ENV)
    if not base or torch.autograd.profiler._is_profiler_enabled or \
            not _profile_lock.acquire(blocking=False):
        yield None
        return
    try:
        path = os.path.join(base, subdir) if subdir else base
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        # Setup failures (an unwritable directory) degrade to a no-op
        # window; a failure INSIDE the body propagates untouched.
        try:
            os.makedirs(path, exist_ok=True)
        except OSError as e:
            logger.warning("telemetry: profiler capture under %s failed "
                           "(%s); continuing without it", path, e)
            yield None
            return
        with torch.profiler.profile(activities=acts) as prof:
            yield path
            # The kernels the body queued land inside the window.
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(
            path, "trace.{}.json".format(int(time.time() * 1e3))))
    finally:
        _profile_lock.release()
