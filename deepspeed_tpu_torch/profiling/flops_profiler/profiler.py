"""Flops profiler: a model's flops, bytes, parameters and duration, and
their breakdown by module.

Counterpart of ``deepspeed_tpu/profiling/flops_profiler/profiler.py``
(reference ``deepspeed/profiling/flops_profiler/profiler.py``), with its
API: ``start_profile`` / ``stop_profile`` / ``end_profile``, ``observe``,
``set_example_batch``, ``get_total_flops`` / ``duration`` / ``params`` /
``steps``, ``print_model_profile``, ``print_model_aggregated_profile`` and
``get_model_profile``.

The JAX profiler reads XLA's cost analysis of the compiled program. The
port measures instead, as a client of the perf x-ray
(``telemetry/xray.py``):

- ``observe(fn, *args)`` hands the program to a ``ProgramRegistry``
  (the training engine's own, or a private one), which runs it once on
  meta tensors of the arguments' shapes under the cost modes and keeps one
  record per (program, signature): two programs under one name keep two
  records;
- ``window()`` is a ``CostWindow`` over real work: the engine opens one at
  the forward of each profiled step and closes it after that step's
  backward, so a step counts its forward and backward as the JAX profiler's
  fused program does. The training kernels charge their plain versions
  inside it (``ops/transformer/kernels/costing.py``): the counts are the
  same on the card as on the CPU;
- the per-module breakdown, flax's ``tabulate`` in JAX, is
  ``FlopCounterMode``'s module hierarchy over the windows: each row is a
  module path with its flops, its parameters and its share of the total.

Flops are the matrix products' (``FlopCounterMode``: 2 per multiply-add);
bytes are each operator's tensor bytes, read and written once.
"""

import time

import torch

from deepspeed_tpu_torch.telemetry.xray import CostWindow, ProgramRegistry


def number_to_string(num, units=None, precision=2):
    if units is None:
        if num >= 1e12:
            return "{:.{}f} T".format(num / 1e12, precision)
        if num >= 1e9:
            return "{:.{}f} G".format(num / 1e9, precision)
        if num >= 1e6:
            return "{:.{}f} M".format(num / 1e6, precision)
        if num >= 1e3:
            return "{:.{}f} K".format(num / 1e3, precision)
        return "{:.{}f}".format(num, precision)
    return "{:.{}f} {}".format(num, precision, units)


flops_to_string = number_to_string
params_to_string = number_to_string
macs_to_string = number_to_string


def duration_to_string(duration, precision=2):
    if duration > 1:
        return "{:.{}f} s".format(duration, precision)
    if duration * 1e3 > 1:
        return "{:.{}f} ms".format(duration * 1e3, precision)
    return "{:.{}f} us".format(duration * 1e6, precision)


class _Window(CostWindow):
    """A ``CostWindow`` that adds its counts to the profiler on exit."""

    def __init__(self, profiler):
        super().__init__()
        self._profiler = profiler

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self._profiler._add(self.cost, self.modules)
        return False


class FlopsProfiler(object):
    """Profiles an ``nn.Module`` and the programs run on it.

    ``xray`` is an optional shared ``ProgramRegistry``: the training engine
    passes its own, so observed programs land in the records its
    ``perf_xray()`` exports; standalone use gets a private, unpublished
    one."""

    def __init__(self, model=None, xray=None):
        self.model = model
        self.started = False
        self._xray = xray
        self._labels = {}        # id(fn) -> (fn, label); fn ref pins id
        self._used_labels = set()
        self.reset_profile()

    # ----------------------------------------------------------- lifecycle
    def reset_profile(self):
        self._total_flops = 0.0
        self._total_bytes = 0.0
        self._observed = 0
        self._modules = {}
        self._start_time = None
        self._duration = 0.0
        self._example_args = None
        self._example_kwargs = None

    def start_profile(self, ignore_list=None):
        self.reset_profile()
        self.started = True
        self._start_time = time.perf_counter()

    def stop_profile(self):
        if self._start_time is not None:
            self._duration = time.perf_counter() - self._start_time
        self.started = False

    def end_profile(self):
        self.reset_profile()

    # ------------------------------------------------------------ observers
    def _label_for(self, fn):
        """A registry label unique per program object: two programs that
        share a ``__name__`` (two lambdas) keep two records. The function
        is held in the map, so its id stays its own while it is there."""
        key = id(fn)
        entry = self._labels.get(key)
        if entry is not None:
            return entry[1]
        base = getattr(fn, "__name__", None) or "program"
        label, n = base, len(self._labels)
        while label in self._used_labels:
            label = "{}#{}".format(base, n)
            n += 1
        self._used_labels.add(label)
        self._labels[key] = (fn, label)
        return label

    def _add(self, cost, modules=None):
        self._total_flops += cost["flops"]
        self._total_bytes += cost["bytes_accessed"]
        self._observed += 1
        for name, flops in (modules or {}).items():
            self._modules[name] = self._modules.get(name, 0.0) + flops

    def observe(self, fn, *args, **kwargs):
        """Add the cost of one call of ``fn(*args, **kwargs)``, measured by
        the x-ray registry on meta tensors of the arguments' shapes (one
        measurement per program and signature; a program that cannot run
        on meta tensors records its shapes only, with the error, and adds
        nothing). Returns the record."""
        if self._xray is None:
            self._xray = ProgramRegistry()
        record = self._xray.observe(self._label_for(fn), fn, *args,
                                    **kwargs)
        self._add(record)
        return record

    def window(self):
        """A ``CostWindow`` whose counts, flops by module included, are
        added to the profile when it closes."""
        return _Window(self)

    def set_example_batch(self, *args, **kwargs):
        """Remember example inputs (``get_model_profile`` runs them)."""
        self._example_args = args
        self._example_kwargs = kwargs

    # -------------------------------------------------------------- totals
    def get_total_flops(self, as_string=False):
        f = self._total_flops
        return flops_to_string(f) if as_string else f

    def get_total_bytes(self):
        return self._total_bytes

    def get_total_duration(self, as_string=False):
        d = self._duration
        return duration_to_string(d) if as_string else d

    def get_total_params(self, as_string=False):
        n = 0
        if isinstance(self.model, torch.nn.Module):
            n = sum(p.numel() for p in self.model.parameters())
        return params_to_string(n) if as_string else n

    def get_total_steps(self):
        return self._observed

    # ------------------------------------------------------------- reports
    def _module_params(self):
        """Parameters by module path as ``FlopCounterMode`` names them."""
        if not isinstance(self.model, torch.nn.Module):
            return {}
        root = type(self.model).__name__
        out = {}
        for name, mod in self.model.named_modules():
            path = root + ("." + name if name else "")
            out[path] = sum(p.numel() for p in mod.parameters())
        return out

    def _module_rows(self):
        """(path, flops, depth) of every module the windows saw
        (``Global``, the modes' outside, left out), in the model's module
        order (``named_modules``), then any other in the order it ran."""
        order = {n: i for i, n in enumerate(self._module_params())}
        rows = [(n, f, n.count(".")) for n, f in self._modules.items()
                if n != "Global"]
        return sorted(rows, key=lambda r: order.get(r[0], len(order)))

    def module_breakdown(self, module_depth=1):
        """Rows (module path, flops, parameters or None): each module at
        depth ``module_depth`` below the root (-1: the deepest depth seen),
        in the model's module order, and a row ``(outside them)`` with the
        profile's other flops, so the rows' flops sum to the total that
        ``FlopCounterMode`` counted (the decode kernels' formula has no
        module). A module's flops are all the flops run inside it,
        backward included (``FlopCounterMode``'s hierarchy)."""
        rows = self._module_rows()
        if not rows:
            return []
        if module_depth in (-1, None):
            module_depth = max(d for _, _, d in rows)
        params = self._module_params()
        out = [(n, f, params.get(n)) for n, f, d in rows
               if d == module_depth]
        rest = self._modules.get("Global", 0.0) - sum(f for _, f, _ in out)
        if rest:
            out.append(("(outside them)", rest, None))
        return out

    def print_model_profile(self, profile_step=1, module_depth=-1,
                            top_modules=3, detailed=True, output_file=None):
        total = self._total_flops
        lines = [
            "-------------------------- DeepSpeed Flops Profiler "
            "--------------------------",
            "Profile step: {}".format(profile_step),
            "Observed programs: {}".format(self._observed),
            "Total measured flops (matrix products, forward and backward): "
            "{}".format(self.get_total_flops(as_string=True)),
            "Total bytes accessed: {}".format(
                number_to_string(self._total_bytes, units="B")),
            "Number of parameters: {}".format(
                self.get_total_params(as_string=True)),
            "Profile duration: {}".format(
                self.get_total_duration(as_string=True)),
        ]
        rows = [(n, f, d) for n, f, d in self._module_rows()
                if module_depth in (-1, None) or d <= module_depth]
        if detailed and rows:
            params = self._module_params()
            lines.append("{:<60} {:>10} {:>12} {:>8}".format(
                "module (flops inside it, backward included)", "params",
                "flops", "share"))
            for name, flops, d in rows:
                n = params.get(name)
                lines.append("{:<60} {:>10} {:>12} {:>7.2f}%".format(
                    "  " * d + name.rsplit(".", 1)[-1],
                    "-" if n is None else params_to_string(n),
                    flops_to_string(flops),
                    100.0 * flops / total if total else 0.0))
        top = self.print_model_aggregated_profile(module_depth, top_modules,
                                                  echo=False)
        if top:
            lines.append(top)
        out = "\n".join(lines)
        if output_file:
            with open(output_file, "w") as f:
                f.write(out)
        else:
            print(out)
        return out

    def print_model_aggregated_profile(self, module_depth=-1, top_modules=3,
                                       echo=True):
        """The ``top_modules`` modules with the most flops at each depth
        down to ``module_depth`` (-1: every depth)."""
        mods = {n: f for n, f in self._modules.items() if n != "Global"}
        if not mods:
            return None
        deepest = max(n.count(".") for n in mods)
        if module_depth not in (-1, None):
            deepest = min(deepest, module_depth)
        lines = ["Top {} modules in flops at each depth:".format(
            top_modules)]
        for d in range(deepest + 1):
            at = sorted(((f, n) for n, f in mods.items()
                         if n.count(".") == d), reverse=True)[:top_modules]
            lines.append("depth {}: {}".format(d, ", ".join(
                "{} {}".format(n, flops_to_string(f)) for f, n in at)))
        out = "\n".join(lines)
        if echo:
            print(out)
        return out


def get_model_profile(model,
                      args=(),
                      kwargs=None,
                      print_profile=True,
                      detailed=True,
                      module_depth=-1,
                      top_modules=3,
                      warm_up=1,
                      as_string=True,
                      output_file=None,
                      ignore_modules=None):
    """(flops, params) of one forward of ``model(*args, **kwargs)`` (no
    gradients), after ``warm_up`` plain forwards; prints the profile with
    ``print_profile``."""
    kwargs = kwargs or {}
    prof = FlopsProfiler(model)
    prof.start_profile()
    prof.set_example_batch(*args, **kwargs)
    with torch.no_grad():
        for _ in range(max(warm_up, 0)):
            model(*args, **kwargs)
        with prof.window():
            model(*args, **kwargs)
    prof.stop_profile()
    flops = prof.get_total_flops(as_string=as_string)
    params = prof.get_total_params(as_string=as_string)
    if print_profile:
        prof.print_model_profile(module_depth=module_depth,
                                 top_modules=top_modules,
                                 detailed=detailed, output_file=output_file)
    prof.end_profile()
    return flops, params
