"""Per-shape choice of a kernel's run-time variant, measured on the card.

Counterpart of ``deepspeed_tpu/ops/autotuner.py`` (the reference's analogue
is its GEMM algorithm sweeps at layer construction). The JAX package tunes
Pallas tile sizes. The port's kernels fix their tiles at compile time; what
a call site chooses at run time is a variant: the flash backward's mode,
K2a (fused: one launch, dq by atomics) or K2b (split: two launches), in the
``flash_attention`` family (``ops/transformer/kernels/attention.py``).

The selection order per (platform, kernel, signature) key, as in JAX:

1. the in-process memo;
2. the bundled table ``ops/autotune_table.json``, rows measured on the card
   and keyed by platform (``cuda::<torch.cuda.get_device_name()>``);
3. the user cache ``$XDG_CACHE_HOME/deepspeed_tpu_torch/autotune.json``
   (default ``~/.cache``), written by online sweeps;
4. with ``DS_TPU_AUTOTUNE=1``, an online sweep: each candidate runs once to
   warm up, then ``repeats`` times between CUDA events; the fastest
   (minimum) wins and is written to the user cache. Otherwise the caller's
   default. ``DS_TPU_AUTOTUNE=force`` sweeps even where a table has the
   key.

A sweep runs only where it can: on a CUDA platform, with more than one
candidate, in a single process (ranks of a job read the bundled table
only, so every rank makes the same choice), and never while the current
stream is capturing a CUDA graph (``torch.cuda.is_current_stream_capturing``):
a capture can only look the table up. A failed candidate is not skipped:
its error is raised.
"""

import json
import os
import time

import torch

_MEMO = {}
_BUNDLED = None
_USER = None
_PLATFORMS = {}

_BUNDLED_PATH = os.path.join(os.path.dirname(__file__), "autotune_table.json")

# The candidates of each known family: a table row must choose among them.
KERNEL_CHOICES = {
    "flash_attention": ("fused", "split"),
}


def _user_cache_path():
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "deepspeed_tpu_torch", "autotune.json")


def _load(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _tables():
    global _BUNDLED, _USER
    if _BUNDLED is None:
        _BUNDLED = _load(_BUNDLED_PATH)
    if _USER is None:
        _USER = _load(_user_cache_path())
    return _BUNDLED, _USER


def online_enabled():
    return os.environ.get("DS_TPU_AUTOTUNE", "0") not in ("0", "", "false")


def force_enabled():
    """``DS_TPU_AUTOTUNE=force``: sweep even for keys a table has (to
    refresh rows after a kernel changes); winners still go to the user
    cache."""
    return os.environ.get("DS_TPU_AUTOTUNE", "") == "force"


def platform(device=None):
    """``cuda::<device name>`` for a CUDA device (default: the current one
    when CUDA is available), else ``cpu``."""
    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    name = _PLATFORMS.get(index)
    if name is None:
        name = _PLATFORMS[index] = "cuda::" + torch.cuda.get_device_name(
            index)
    return name


def table_key(kernel, signature, device=None):
    """The full table key for (platform, kernel, signature): the one place
    the key's format lives."""
    return "{}::{}::{}".format(platform(device), kernel, signature)


def _split_key(key):
    """(platform, kernel, signature); the platform may hold ``::``."""
    parts = key.rsplit("::", 2)
    return parts if len(parts) == 3 and all(parts) else None


def validate_table(table, source="autotune table"):
    """Schema-check a table (the bundled file or a user cache): each key
    parses as ``platform::kernel::signature`` with non-empty parts, each
    entry is an object with a non-empty ``choice`` (a list, or one value);
    a known family's choices are among ``KERNEL_CHOICES``, another's are
    non-empty strings or positive ints. Raises ValueError naming the
    offending key; returns the number of entries."""
    if not isinstance(table, dict):
        raise ValueError("{}: expected a JSON object at top level, got "
                         "{}".format(source, type(table).__name__))
    for key, entry in table.items():
        parts = _split_key(key)
        if parts is None:
            raise ValueError(
                "{}: key {!r} does not parse as "
                "platform::kernel::signature".format(source, key))
        kernel = parts[1]
        if not isinstance(entry, dict) or "choice" not in entry:
            raise ValueError(
                "{}: entry for {!r} must be an object with a 'choice' "
                "list".format(source, key))
        choice = entry["choice"]
        values = choice if isinstance(choice, list) else [choice]
        if not values:
            raise ValueError(
                "{}: entry for {!r} has an empty choice".format(source, key))
        allowed = KERNEL_CHOICES.get(kernel)
        for value in values:
            if allowed is not None:
                if value not in allowed:
                    raise ValueError(
                        "{}: entry for {!r} chooses {!r}, not one of {}'s "
                        "{}".format(source, key, value, kernel, allowed))
            elif isinstance(value, bool) or not (
                    (isinstance(value, int) and value > 0) or
                    (isinstance(value, str) and value)):
                raise ValueError(
                    "{}: entry for {!r} has a choice {!r} that is neither a "
                    "positive int nor a non-empty string".format(
                        source, key, value))
    return len(table)


def _multiprocess():
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def capturing():
    """True while the current CUDA stream is capturing a graph."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _time_candidate(run, repeats):
    """The fastest of ``repeats`` runs after one warm-up: CUDA events on
    the current stream on the card (seconds), the host clock elsewhere."""
    run()
    best = float("inf")
    if torch.cuda.is_available():
        stream = torch.cuda.current_stream()
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            run()
            end.record(stream)
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best


def autotune(kernel, signature, candidates, make_run, default, repeats=3,
             device=None):
    """The chosen candidate for (kernel, signature) on ``device``'s
    platform (module docstring).

    Args:
      kernel: the family, e.g. "flash_attention".
      signature: the shape signature, e.g. "b8_h16_tq1024_tkv1024_d64_
        bfloat16_c1".
      candidates: the JSON-able candidates (empty: table lookup only).
      make_run: candidate -> a zero-argument callable running the kernel
        once (called only by a sweep).
      default: the answer where no table has the key and no sweep runs.
    """
    plat = platform(device)
    key = "{}::{}::{}".format(plat, kernel, signature)
    if key in _MEMO:
        return _MEMO[key]
    multiproc = _multiprocess()
    bundled, user = _tables()
    tables = (bundled,) if multiproc else (user, bundled)
    capture = capturing()
    can_sweep = (plat.startswith("cuda") and len(candidates) > 1 and
                 not multiproc and not capture)
    if not (force_enabled() and can_sweep):
        for table in tables:
            if key in table:
                chosen = table[key]["choice"]
                _MEMO[key] = chosen
                return chosen
    if not (online_enabled() and can_sweep):
        if not online_enabled() and not capture:
            # Tuning off: the answer can never change. With tuning on (or
            # during a capture) a later eager call may still sweep.
            _MEMO[key] = default
        return default

    results = [(_time_candidate(make_run(cand), repeats), cand)
               for cand in candidates]
    best_dt, best = min(results, key=lambda r: r[0])
    _MEMO[key] = best
    path = _user_cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    user = _load(path)
    user[key] = {"choice": best, "seconds": best_dt,
                 "candidates_timed": len(results),
                 "timings": {c if isinstance(c, str) else json.dumps(c): dt
                             for dt, c in results}}
    tmp = "{}.tmp.{}".format(path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(user, f, indent=1, sort_keys=True)
    os.replace(tmp, path)  # atomic: a concurrent writer cannot corrupt it
    global _USER
    _USER = user
    return best
