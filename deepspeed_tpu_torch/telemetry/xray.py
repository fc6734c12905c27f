"""Perf x-ray: the per-program cost and memory observatory.

Counterpart of ``deepspeed_tpu/telemetry/xray.py``. The serving engine
holds a handful of step programs, one per key, each captured as a CUDA
graph on the card (``inference/engine.py``); this module records what each
costs. The JAX module reads XLA's ``cost_analysis`` of a compiled program;
PyTorch has no compiler cost model for an eager program, so the port
MEASURES one run instead:

- flops from ``torch.utils.flop_counter.FlopCounterMode`` (matrix
  products, attention; elementwise work is not counted);
- bytes from ``_ByteMode``, a dispatch mode that adds every operator's
  input and output tensor bytes once (views move nothing; an indexed
  in-place write counts the values it writes, not the whole plane);
- the decode kernels K3-K6 are ctypes launches on raw pointers, invisible
  to both modes: their wrappers add the flops and bytes of the formula
  behind PERF.md's bound column (``decode_attention.costing``: 4*D flops
  per visible key per query row; q and out, each cached key up to its
  row's frontier and the frontiers read once, plus a block table), from
  the frontiers of that run. The training kernels (K1/K2, K7, K8-K11)
  charge the two modes with their plain versions' operators, run on meta
  tensors of the same shapes (``kernels/costing.py``), so a training
  step's record counts the same flops and bytes on the card as on the
  CPU;
- the graph pool's bytes after the program's capture (the shared pool of
  the engine's graphs; 0 on the CPU, which captures nothing).

A record is made on a key's EAGER FIRST RUN (``ProgramRegistry.measure``),
never inside a capture: the dispatch modes and the kernels' formula read
back the frontiers (a host sync) and add host time to that one run only.
Replays pay ``stash`` (a signature compare) and ``note`` (two int adds).
A stashed program that was never measured (``observe`` on a plain
function) is measured in ``materialize`` by running it on meta tensors
of the stashed shapes, which moves no data.

Three pieces, as in the JAX module:

- ``ProgramRegistry``: records keyed on (label, signature); a new
  signature under a label after warm-up is a program-identity change that
  ``RecompileDetector`` warnings and the autopsy name through
  ``identity()`` / ``recompile_dicts()`` (capped at RECOMPILE_EVENT_CAP,
  the overflow counted). Roofline gauges ``xray_mfu`` / ``xray_mbu`` /
  ``xray_roofline_ratio`` divide a record's flops and bytes by its sampled
  step time against ``PLATFORM_PEAKS``; the CPU has no row, so it gets
  cost facts and no utilization (a fabricated MFU is worse than none).
- ``due()`` / ``sample_step()``: 1 in ``sample_every`` steps waits for the
  step's stream (the one sanctioned synchronization) to split the host's
  launch time from the device's; the measured total is the roofline's
  denominator.
- ``HBMLedger`` reconciles predicted device bytes (weights, KV pool, graph
  pool) with ``torch.cuda.memory_stats``, and ``cost_model_gate`` compares
  two ``perf_xray`` sections so the regression gate flags cost deltas.
"""

import contextlib
import hashlib
import threading
import time
from itertools import chain as _chain

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import FlopCounterMode

from deepspeed_tpu_torch.ops.transformer.kernels import (costing,
                                                        decode_attention)
from deepspeed_tpu_torch.utils.logging import logger

# Version stamp of the ``perf_xray`` section. Bump on any field rename or
# removal; the gate refuses to compare across versions.
SCHEMA_VERSION = 1

# Bound on retained recompile events; overflow counts in
# ``recompile_events_dropped``.
RECOMPILE_EVENT_CAP = 64

# Per-platform peaks for the roofline gauges, by torch device type. A
# platform mapped to None (or missing) gets cost facts only. The cuda row
# is the H100 SXM's dense bf16 tensor-core peak and HBM3 rate, the numbers
# PERF.md's bound column uses; override per deployment with
# ProgramRegistry(peaks=...).
PLATFORM_PEAKS = {
    "cuda": {
        "flops_per_s": 989e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 SXM datasheet (dense bf16, HBM3)",
    },
    "cpu": None,
}

# Operators whose first argument is written at indices: their bytes are
# the values written (read and written once), not the whole destination.
_INDEXED_WRITES = frozenset(
    name for name in ("index_put_", "index_put", "_index_put_impl_",
                      "index_copy_", "index_copy", "scatter_", "scatter",
                      "index_add_", "index_add"))

_DTYPE_STRS = {}


def _sig_leaf(leaf):
    if isinstance(leaf, torch.Tensor):
        s = _DTYPE_STRS.get(leaf.dtype)
        if s is None:
            s = _DTYPE_STRS[leaf.dtype] = str(leaf.dtype).replace(
                "torch.", "")
        return (tuple(leaf.shape), s)
    return ("static", type(leaf).__name__, repr(leaf)[:80])


def _signature(args, kwargs):
    """Structural signature of a call: (shape, dtype) per tensor leaf,
    (type, repr) per other leaf. No device touch."""
    return tuple(map(_sig_leaf, tree_leaves((args, kwargs))))


def _abstractify(tree):
    """Every tensor leaf as a meta tensor of its shape and dtype: a stash
    keeps shapes, never buffers."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
        return x
    return tree_map(conv, tree)


def _shapes_of(sig):
    """Human form of a signature: ``float32[1,16]``, ``static:<type>=<repr>``
    (the engine's program key and pool layout are static leaves)."""
    out = []
    for entry in sig:
        if entry[0] == "static":
            out.append("static:{}={}".format(entry[1], entry[2]))
        else:
            shape, dtype = entry
            out.append("{}[{}]".format(dtype, ",".join(str(d)
                                                       for d in shape)))
    return out


def _fingerprint(label, sig):
    return hashlib.sha256(repr((label, sig)).encode()).hexdigest()[:16]


def _nbytes(t):
    return t.numel() * t.element_size()


class _ByteMode(TorchDispatchMode):
    """Adds each operator's tensor bytes: inputs read once, outputs
    written once. A view moves nothing; an indexed write (``index_put_``
    and its kin) reads and writes its values, not the destination."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if getattr(func, "is_view", False):
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if name in _INDEXED_WRITES:
            self.bytes += 2 * sum(_nbytes(t) for t in ins[1:])
            return out
        self.bytes += sum(_nbytes(t) for t in ins)
        self.bytes += sum(_nbytes(t) for t in tree_leaves(out)
                          if isinstance(t, torch.Tensor))
        return out


class CostWindow(object):
    """The cost modes over a span of work that may begin in one call and
    end in another (the flops profiler's forward-to-backward window):
    ``__enter__`` opens them, ``__exit__`` closes them and fills ``cost``
    ({"flops", "bytes_accessed", "kernel_flops", "kernel_bytes"}: the torch
    operators' flops and bytes, the training kernels' plain versions among
    them, plus the decode kernels' formula) and ``modules`` (flops by
    module path, as ``FlopCounterMode``'s hierarchy names them: the root
    module's class name, then attribute names; every flop counts in each
    enclosing module and in ``Global``). Windows nest."""

    def __init__(self):
        self.cost = None
        self.modules = None
        self._stack = None
        self._counter = None
        self._bytes = None
        self._kernels = None

    def __enter__(self):
        stack = contextlib.ExitStack()
        self._counter = stack.enter_context(FlopCounterMode(display=False))
        self._bytes = stack.enter_context(_ByteMode())
        stack.enter_context(costing.costing())
        self._kernels = stack.enter_context(decode_attention.costing())
        self._stack = stack
        return self

    def __exit__(self, *exc):
        stack, self._stack = self._stack, None
        stack.close()
        kernels = self._kernels
        flops = float(self._counter.get_total_flops()) + kernels["flops"]
        self.cost = {"flops": flops,
                     "bytes_accessed": float(self._bytes.bytes) +
                     kernels["bytes"],
                     "kernel_flops": float(kernels["flops"]),
                     "kernel_bytes": float(kernels["bytes"])}
        self.modules = {name: float(sum(ops.values())) for name, ops in
                        self._counter.get_flop_counts().items()}
        return False


def measure_cost(run):
    """Run ``run()`` once under the cost modes (``CostWindow``); returns
    (its result, the window's ``cost``)."""
    with CostWindow() as window:
        out = run()
    return out, window.cost


class _Stash(object):
    """One (label, signature): abstract args, and the record once measured
    (``measured``) and materialized (``record``). ``calls``/``tokens``
    accumulate ``note`` for the steps this signature was active;
    ``step_s`` is its sampled step time (EWMA)."""

    __slots__ = ("label", "sig", "program", "args", "kwargs", "measured",
                 "record", "calls", "tokens", "step_s", "pool_bytes")

    def __init__(self, label, sig, program, args, kwargs):
        self.label = label
        self.sig = sig
        self.program = program
        self.args = args
        self.kwargs = kwargs
        self.measured = None
        self.record = None
        self.calls = 0
        self.tokens = 0
        self.step_s = None
        self.pool_bytes = 0


def _public_event(ev):
    return {k: v for k, v in ev.items() if not k.startswith("_")}


class ProgramRegistry(object):
    """The observatory. ``registry``: a MetricsRegistry (None: private,
    unpublished); ``platform``: a torch device type (``cuda``/``cpu``;
    None: ``cuda`` when CUDA is available); ``peaks`` overrides the
    PLATFORM_PEAKS row; ``sample_every``: the 1-in-N step sampling
    period (0 disables)."""

    def __init__(self, registry=None, platform=None, peaks=None,
                 sample_every=64):
        self._registry = registry
        self._platform = platform
        self._peaks_override = peaks
        self._sample_every = int(sample_every)
        self._lock = threading.Lock()
        self._programs = {}      # label -> [stash, ...] (insertion order)
        self._sig_index = {}     # label -> {sig: stash}
        self._active_sig = {}    # label -> signature tuple
        self._active = {}        # label -> active stash
        self._prev_active = {}   # label -> previously active stash
        self._active_parts = {}  # label -> per-arg parts (fast path)
        self._sig_memo = {}      # label -> [(arg, parts) | None, ...]
        self._pending = {}       # label -> [calls, tokens] pre-stash
        self._decomp = {}        # label -> [n, host_sum, wait_sum]
        self._gauged = set()
        self._tick = 0
        self.recompile_events = []
        self.recompile_events_dropped = 0

    # ------------------------------------------------------- hot path

    def seen(self, label):
        return label in self._active_sig

    def _arg_parts(self, label, args):
        """Per-argument signature parts, memoized on argument identity
        (``is``: each memo slot holds the object it signed)."""
        memo = self._sig_memo.get(label)
        if memo is None or len(memo) != len(args):
            memo = self._sig_memo[label] = [None] * len(args)
        parts = [None] * len(args)
        for i, a in enumerate(args):
            m = memo[i]
            if m is not None and m[0] is a:
                parts[i] = m[1]
            else:
                p = tuple(map(_sig_leaf, tree_leaves(a)))
                memo[i] = (a, p)
                parts[i] = p
        return tuple(parts)

    def stash(self, label, program, *args, track_change=False, **kwargs):
        """Capture one call's program identity. Returns True when the
        label's ACTIVE signature changed (first stash included). A
        signature seen before under the label only flips the active
        pointer; a genuinely new one is appended, and with
        ``track_change`` (the engine passes ``detector.warm``) logs a
        recompile event. ``track_change`` is a reserved keyword-only
        option, never forwarded to the program."""
        parts = None
        if not kwargs:
            parts = self._arg_parts(label, args)
            if self._active_parts.get(label) == parts:
                return False
            sig = tuple(_chain.from_iterable(parts))
        else:
            sig = _signature(args, kwargs)
        if self._active_sig.get(label) == sig:
            if parts is not None:
                self._active_parts[label] = parts
            return False
        with self._lock:
            by_sig = self._sig_index.setdefault(label, {})
            old = self._active.get(label)
            stash = by_sig.get(sig)
            is_new = stash is None
            if is_new:
                a_args, a_kwargs = _abstractify((args, kwargs))
                stash = _Stash(label, sig, program, a_args, a_kwargs)
                pend = self._pending.pop(label, None)
                if pend is not None:
                    stash.calls, stash.tokens = pend
                by_sig[sig] = stash
                self._programs.setdefault(label, []).append(stash)
            self._active_sig[label] = sig
            self._active[label] = stash
            if old is not None and old is not stash:
                self._prev_active[label] = old
            if parts is not None:
                self._active_parts[label] = parts
            else:
                self._active_parts.pop(label, None)
            if is_new and old is not None and track_change:
                if len(self.recompile_events) >= RECOMPILE_EVENT_CAP:
                    self.recompile_events_dropped += 1
                else:
                    self.recompile_events.append({
                        "program": label,
                        "old_fingerprint": _fingerprint(label, old.sig),
                        "new_fingerprint": _fingerprint(label, sig),
                        "old_shapes": _shapes_of(old.sig),
                        "new_shapes": _shapes_of(sig),
                        "_old": old,
                        "_new": stash,
                    })
        return True

    def measure(self, label, run):
        """Run the label's ACTIVE program once, eagerly, under the cost
        modes (``measure_cost``) and keep the measurement on its stash;
        returns ``run()``'s result. The engine calls this on a key's eager
        first run, never inside a capture. A stash measured before is run
        plainly."""
        stash = self._active.get(label)
        if stash is None or stash.measured is not None:
            return run()
        out, cost = measure_cost(run)
        stash.measured = cost
        stash.record = None
        return out

    def set_pool_bytes(self, label, nbytes):
        """The graph pool's bytes after the active program's capture."""
        stash = self._active.get(label)
        if stash is not None:
            stash.pool_bytes = int(nbytes)
            if stash.record is not None:
                stash.record["graph_pool_bytes"] = stash.pool_bytes
                stash.record["peak_hbm_bytes"] = stash.pool_bytes

    def note(self, label, tokens=0):
        """Per-step accounting against the label's ACTIVE signature: one
        call, ``tokens`` emitted (the per-token denominators). Notes
        before any stash fold into the label's first stash."""
        stash = self._active.get(label)
        if stash is not None:
            stash.calls += 1
            stash.tokens += tokens
            return
        p = self._pending.get(label)
        if p is None:
            p = self._pending.setdefault(label, [0, 0])
        p[0] += 1
        p[1] += tokens

    def due(self):
        """Deterministic 1-in-N sampler: call once per step; True on every
        Nth tick (never the first, which includes the capture)."""
        if self._sample_every <= 0:
            return False
        self._tick += 1
        return self._tick % self._sample_every == 0

    def sample_step(self, label, wait, dispatch_s):
        """THE SANCTIONED SYNC: ``wait()`` blocks until the sampled step's
        work is done (the engine's stream, or nothing on the CPU); the
        dispatch time plus the wait is the step time the roofline divides
        by (an EWMA per signature)."""
        t0 = time.perf_counter()
        wait()
        wait_s = time.perf_counter() - t0
        step_s = dispatch_s + wait_s
        stash = self._active.get(label)
        if stash is not None:
            stash.step_s = (step_s if stash.step_s is None
                            else 0.8 * stash.step_s + 0.2 * step_s)
        d = self._decomp.setdefault(label, [0, 0.0, 0.0])
        d[0] += 1
        d[1] += dispatch_s
        d[2] += wait_s
        if self._registry is not None:
            self._registry.histogram(
                "xray_host_dispatch_seconds",
                program=label).observe(dispatch_s)
            self._registry.histogram(
                "xray_device_wait_seconds", program=label).observe(wait_s)
        return step_s

    # ------------------------------------------------------ cold path

    def platform(self):
        if self._platform is None:
            self._platform = "cuda" if torch.cuda.is_available() else "cpu"
        return self._platform

    def peaks(self):
        """The peaks row for this platform, or None: no utilization."""
        if self._peaks_override is not None:
            return self._peaks_override
        return PLATFORM_PEAKS.get(self.platform())

    def _analyze(self, stash):
        """The stash's cost: its measurement, or a run of its program on
        meta tensors of the stashed shapes under the cost modes (no data
        moves; a program that cannot run on meta tensors records its
        shapes only, with the error)."""
        out = {"fingerprint": _fingerprint(stash.label, stash.sig),
               "flops": 0.0, "bytes_accessed": 0.0, "kernel_flops": 0.0,
               "kernel_bytes": 0.0, "graph_pool_bytes": stash.pool_bytes,
               "peak_hbm_bytes": stash.pool_bytes, "error": None}
        cost = stash.measured
        if cost is None and stash.program is not None:
            try:
                _, cost = measure_cost(lambda: stash.program(
                    *stash.args, **stash.kwargs))
            except Exception as e:  # the JAX analysis' own fallback
                out["error"] = "{}: {}".format(type(e).__name__, e)
                logger.warning(
                    "telemetry: xray analysis of %r failed (%s); recording "
                    "shapes only", stash.label, out["error"])
            else:
                stash.measured = cost
        if cost is not None:
            out.update(cost)
        return out

    def materialize(self):
        """Fill every stash's record and publish the per-program gauges.
        Export paths call this; step paths never do."""
        with self._lock:
            pending = [s for chain in self._programs.values()
                       for s in chain if s.record is None]
        for stash in pending:
            stash.record = dict(
                self._analyze(stash),
                program=stash.label,
                platform=self.platform(),
                input_shapes=_shapes_of(stash.sig),
            )
        for label in list(self._programs):
            self._publish(label)

    def _active_record(self, label):
        stash = self._active.get(label)
        if stash is not None and stash.record is not None:
            return stash.record
        for stash in reversed(self._programs.get(label, [])):
            if stash.record is not None:
                return stash.record
        return None

    def _utilization(self, stash, peaks):
        """(mfu, mbu) of a materialized stash, or (None, None) without a
        peaks row or a sampled step."""
        rec = stash.record
        if not peaks or rec is None or not stash.step_s:
            return None, None
        return (rec["flops"] / (stash.step_s * peaks["flops_per_s"]),
                rec["bytes_accessed"] /
                (stash.step_s * peaks["hbm_bytes_per_s"]))

    def _publish(self, label):
        """The per-program gauge family (idempotent). Gauges read the
        records through set_fn, so a scrape never measures anything.
        MFU/MBU appear only with a peaks row."""
        if self._registry is None or label in self._gauged:
            return
        if self._active_record(label) is None:
            return
        self._gauged.add(label)
        plat = self.platform()
        reg = self._registry

        def rec_field(field, label=label):
            rec = self._active_record(label)
            return float(rec[field]) if rec else 0.0

        reg.gauge("xray_flops", program=label, platform=plat).set_fn(
            lambda: rec_field("flops"))
        reg.gauge("xray_bytes_accessed", program=label,
                  platform=plat).set_fn(lambda: rec_field("bytes_accessed"))
        reg.gauge("xray_peak_hbm_bytes", program=label,
                  platform=plat).set_fn(lambda: rec_field("peak_hbm_bytes"))
        peaks = self.peaks()
        if not peaks:
            return

        def util(i, label=label, peaks=peaks):
            stash = self._active.get(label)
            if stash is None:
                return 0.0
            v = self._utilization(stash, peaks)[i]
            return v or 0.0

        def ratio(label=label, peaks=peaks):
            b = rec_field("bytes_accessed", label)
            balance = peaks["flops_per_s"] / peaks["hbm_bytes_per_s"]
            return (rec_field("flops", label) / b) / balance if b else 0.0

        reg.gauge("xray_mfu", program=label, platform=plat).set_fn(
            lambda: util(0))
        reg.gauge("xray_mbu", program=label, platform=plat).set_fn(
            lambda: util(1))
        reg.gauge("xray_roofline_ratio", program=label,
                  platform=plat).set_fn(ratio)

    def observe(self, label, program, *args, tokens=0, **kwargs):
        """Stash + materialize + count, returning the record (the flops
        profiler's synchronous mode; the program runs on meta tensors).
        ``tokens`` is a reserved keyword-only option."""
        self.stash(label, program, *args, **kwargs)
        self.materialize()
        self.note(label, tokens)
        return self._active_record(label)

    def identity(self, label):
        """One-line program identity for RecompileDetector warnings:
        fingerprint + shapes, old -> new when the signature changed."""
        cur = self._active.get(label)
        if cur is None:
            return None
        cur_s = "fingerprint {} shapes ({})".format(
            _fingerprint(label, cur.sig), ", ".join(_shapes_of(cur.sig)))
        old = self._prev_active.get(label)
        if old is None:
            return cur_s
        return "fingerprint {} shapes ({}) -> {}".format(
            _fingerprint(label, old.sig), ", ".join(_shapes_of(old.sig)),
            cur_s)

    def recompile_dicts(self):
        """Recompile events without their internal references."""
        return [_public_event(ev) for ev in self.recompile_events]

    def record_count(self):
        """Number of (label, signature) records (never materializes)."""
        with self._lock:
            return sum(len(c) for c in self._programs.values())

    def max_temp_bytes(self):
        """Largest graph-pool size across the programs (0 on the CPU)."""
        best = 0
        for chain in self._programs.values():
            for stash in chain:
                best = max(best, stash.pool_bytes)
        return best

    def to_json(self):
        """The schema-versioned ``perf_xray`` section."""
        self.materialize()
        peaks = self.peaks()
        programs = []
        flops_total = bytes_total = 0.0
        tokens_total = calls_total = 0
        for label in sorted(self._programs):
            active = self._active.get(label)
            for stash in self._programs[label]:
                entry = dict(stash.record or {
                    "program": label,
                    "input_shapes": _shapes_of(stash.sig),
                })
                entry["superseded"] = stash is not active
                entry["calls"] = stash.calls
                entry["tokens"] = stash.tokens
                entry["sampled_step_seconds"] = stash.step_s
                mfu, mbu = self._utilization(stash, peaks)
                entry["mfu"], entry["mbu"] = mfu, mbu
                programs.append(entry)
                if stash.record is not None:
                    flops_total += (stash.record["flops"]
                                    * max(stash.calls, 1))
                    bytes_total += (stash.record["bytes_accessed"]
                                    * max(stash.calls, 1))
                tokens_total += stash.tokens
                calls_total += stash.calls
        return {
            "schema_version": SCHEMA_VERSION,
            "platform": self.platform(),
            "peaks": dict(peaks) if peaks else None,
            "programs": programs,
            "totals": {
                "calls": calls_total,
                "tokens": tokens_total,
                "flops_total": flops_total,
                "bytes_total": bytes_total,
                "flops_per_token": (flops_total / tokens_total
                                    if tokens_total else None),
                "bytes_per_token": (bytes_total / tokens_total
                                    if tokens_total else None),
            },
            "recompiles": [_public_event(ev)
                           for ev in self.recompile_events],
            "recompiles_dropped": self.recompile_events_dropped,
            "decomposition": {
                label: {"samples": d[0], "host_dispatch_s": d[1],
                        "device_wait_s": d[2]}
                for label, d in sorted(self._decomp.items())
            },
        }


class HBMLedger(object):
    """Predicted-vs-live device memory. Components (weights, KV pool,
    graph pool) are ints or zero-argument callables summed at read time;
    live truth is the caching allocator's ``allocated_bytes`` on
    ``device`` (None on the CPU: the ledger then only predicts). The
    capacity is the configured budget, else the card's total memory, read
    once here: no gauge makes a CUDA call (a scrape may run during a
    capture). Publishes ``hbm_predicted_bytes`` and ``hbm_pressure``
    always, ``hbm_live_bytes`` / ``hbm_headroom_bytes`` only where they
    are meaningful."""

    def __init__(self, registry=None, capacity_bytes=None, device=None):
        self._components = {}
        self._registry = registry
        self._gauged = False
        self._device = None
        if device is not None and torch.device(device).type == "cuda":
            self._device = torch.device(device)
        self._capacity = capacity_bytes
        if not self._capacity and self._device is not None:
            self._capacity = int(torch.cuda.mem_get_info(self._device)[1])

    def set_component(self, name, bytes_or_fn):
        self._components[name] = bytes_or_fn
        self._ensure_gauges()

    def _read(self, v):
        return int(v() if callable(v) else v)

    def components(self):
        return {k: self._read(v) for k, v in self._components.items()}

    def predicted(self):
        return sum(self.components().values())

    def live(self):
        """Bytes the caching allocator holds allocated on the device, or
        None on the CPU."""
        if self._device is None:
            return None
        stats = torch.cuda.memory_stats(self._device)
        return int(stats.get("allocated_bytes.all.current", 0))

    def capacity(self):
        return int(self._capacity) if self._capacity else None

    def headroom(self):
        cap = self.capacity()
        if cap is None:
            return None
        return cap - max(self.live() or 0, self.predicted())

    def pressure(self):
        """0..1 fill fraction (0 when the capacity is unknown)."""
        cap = self.capacity()
        if not cap:
            return 0.0
        return max(self.live() or 0, self.predicted()) / cap

    def _ensure_gauges(self):
        if self._registry is None or self._gauged:
            return
        self._gauged = True
        self._registry.gauge("hbm_predicted_bytes").set_fn(
            lambda: float(self.predicted()))
        self._registry.gauge("hbm_pressure").set_fn(self.pressure)
        if self.live() is not None:
            self._registry.gauge("hbm_live_bytes").set_fn(
                lambda: float(self.live() or 0))
        if self.capacity() is not None:
            self._registry.gauge("hbm_headroom_bytes").set_fn(
                lambda: float(self.headroom() or 0))

    def to_json(self):
        return {
            "components": self.components(),
            "predicted_bytes": self.predicted(),
            "live_bytes": self.live(),
            "capacity_bytes": self.capacity(),
            "headroom_bytes": self.headroom(),
            "pressure": round(self.pressure(), 6),
        }


# --------------------------------------------------------- report gate

_GATE_METRICS = ("flops", "bytes_accessed", "peak_hbm_bytes")


def _active_by_label(section):
    out = {}
    for entry in section.get("programs", ()):
        if not entry.get("superseded"):
            out[entry.get("program")] = entry
    return out


def cost_model_gate(baseline, candidate, rel_tol=0.25):
    """Compare two ``perf_xray`` sections program by program (the JAX
    gate): an increase beyond ``rel_tol`` in flops, bytes accessed or
    peak device bytes (per program, or per token in the totals) flags; a
    decrease lands in ``improved``. A platform or schema mismatch
    caveats instead of comparing."""
    out = {"pass": True, "flagged": [], "improved": [], "caveats": [],
           "programs": {}, "totals": {}}
    if not baseline or not candidate:
        out["caveats"].append("perf_xray missing on one side; "
                              "nothing compared")
        return out
    if baseline.get("schema_version") != candidate.get("schema_version"):
        out["caveats"].append(
            "schema_version mismatch ({} vs {}); nothing compared"
            .format(baseline.get("schema_version"),
                    candidate.get("schema_version")))
        return out
    if baseline.get("platform") != candidate.get("platform"):
        out["caveats"].append(
            "platform mismatch ({} vs {}): cost-model deltas may "
            "reflect backend lowering, not code".format(
                baseline.get("platform"), candidate.get("platform")))
    base_p = _active_by_label(baseline)
    cand_p = _active_by_label(candidate)
    for label in sorted(set(base_p) | set(cand_p)):
        if label not in base_p or label not in cand_p:
            out["caveats"].append(
                "program {!r} only in {}".format(
                    label,
                    "baseline" if label in base_p else "candidate"))
            continue
        b, c = base_p[label], cand_p[label]
        row = {}
        for metric in _GATE_METRICS:
            bv = float(b.get(metric) or 0.0)
            cv = float(c.get(metric) or 0.0)
            rel = (cv - bv) / bv if bv else (1.0 if cv else 0.0)
            row[metric] = {"baseline": bv, "candidate": cv,
                           "rel_delta": round(rel, 6)}
            if rel > rel_tol:
                out["flagged"].append(
                    "{}.{}: {:+.1%} ({:.3g} -> {:.3g})".format(
                        label, metric, rel, bv, cv))
                out["pass"] = False
            elif rel < -rel_tol:
                out["improved"].append(
                    "{}.{}: {:+.1%}".format(label, metric, rel))
        if (b.get("fingerprint") and c.get("fingerprint")
                and b["fingerprint"] != c["fingerprint"]):
            row["fingerprint_changed"] = True
        out["programs"][label] = row
    for metric in ("flops_per_token", "bytes_per_token"):
        bv = (baseline.get("totals") or {}).get(metric)
        cv = (candidate.get("totals") or {}).get(metric)
        if bv is None or cv is None:
            continue
        rel = (cv - bv) / bv if bv else (1.0 if cv else 0.0)
        out["totals"][metric] = {"baseline": bv, "candidate": cv,
                                 "rel_delta": round(rel, 6)}
        if rel > rel_tol:
            out["flagged"].append(
                "totals.{}: {:+.1%} ({:.3g} -> {:.3g})".format(
                    metric, rel, bv, cv))
            out["pass"] = False
        elif rel < -rel_tol:
            out["improved"].append(
                "totals.{}: {:+.1%}".format(metric, rel))
    return out


def _self_check():
    """``python -m deepspeed_tpu_torch.telemetry.xray``: peak table
    sanity, determinism of fingerprints and costs on a tiny program, the
    schema's shape, and the gate's A/A and a synthetic 2x delta. Exit 0
    on success."""
    import copy

    failures = []
    for plat, row in PLATFORM_PEAKS.items():
        if row is None:
            continue
        if not (row.get("flops_per_s", 0) > 0
                and row.get("hbm_bytes_per_s", 0) > 0):
            failures.append("peaks[{}] not positive: {}".format(plat, row))

    def fn(a, b):
        return torch.tanh(a @ b).sum()

    x, y = torch.ones(8, 16), torch.ones(16, 4)
    r1 = ProgramRegistry().observe("probe", fn, x, y, tokens=1)
    r2 = ProgramRegistry().observe("probe", fn, x, y, tokens=1)
    if r1["fingerprint"] != r2["fingerprint"]:
        failures.append("fingerprint not deterministic")
    if r1["flops"] <= 0 or r1["flops"] != r2["flops"]:
        failures.append("flops not deterministic/positive: {} vs {}"
                        .format(r1["flops"], r2["flops"]))
    xr = ProgramRegistry()
    xr.observe("probe", fn, x, y, tokens=4)
    section = xr.to_json()
    for key in ("schema_version", "platform", "programs", "totals",
                "recompiles", "decomposition"):
        if key not in section:
            failures.append("perf_xray section missing {!r}".format(key))
    aa = cost_model_gate(section, section)
    if not aa["pass"] or aa["flagged"]:
        failures.append("A/A gate did not pass clean: {}".format(aa))
    doubled = copy.deepcopy(section)
    for entry in doubled["programs"]:
        entry["bytes_accessed"] *= 2
    doubled["totals"]["bytes_per_token"] = (
        section["totals"]["bytes_per_token"] * 2)
    ab = cost_model_gate(section, doubled)
    if ab["pass"] or not any("bytes" in f for f in ab["flagged"]):
        failures.append("2x bytes delta not flagged: {}".format(ab))
    ledger = HBMLedger(capacity_bytes=1000)
    ledger.set_component("a", 600)
    ledger.set_component("b", lambda: 100)
    if ledger.predicted() != 700 or ledger.headroom() != 300 \
            or abs(ledger.pressure() - 0.7) > 1e-9:
        failures.append("ledger arithmetic wrong: {}".format(
            ledger.to_json()))
    if failures:
        for f in failures:
            print("xray self-check FAIL: {}".format(f))
        return 1
    print("xray self-check OK: peaks table sane, fingerprints/cost "
          "deterministic, schema v{}, gate A/A clean + 2x delta flagged"
          .format(SCHEMA_VERSION))
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(_self_check())
