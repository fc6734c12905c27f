"""The port's environment report: ``python -m deepspeed_tpu_torch.env_report``.

Counterpart of ``deepspeed_tpu/env_report.py`` (reference
``deepspeed/env_report.py``, ``ds_report``): the versions of torch, CUDA
and ``nvcc``, whether CUTLASS's headers are found, the device's name and
power limit, each ``.cu`` library and host C++ op with its sources and
whether it is built or can be built into ``build/``, the kernel-choice
switches, and the autotune tables' rows for this platform. Without a GPU it
says so and exits 0. It reports; it builds and launches nothing.
"""

import json
import os
import shutil
import subprocess
import sys

import torch

GREEN = "\033[92m"
RED = "\033[91m"
YELLOW = "\033[93m"
END = "\033[0m"
WARNING = YELLOW + "[WARNING]" + END
FAIL = RED + "[NO]" + END
OKAY = GREEN + "[OKAY]" + END

CUTLASS_INCLUDE = ("/usr/local/cutlass/include",)


def _run(cmd, timeout=30):
    """A command's stripped standard output, or None when it cannot run."""
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() if r.returncode == 0 else None


def _line(name, value, width=26):
    print(name + " " + "." * max(width - len(name), 1) + " " + str(value))


def nvcc_version():
    """The ``release ...`` line of ``nvcc --version``, or None."""
    from deepspeed_tpu_torch.op_builder.builder import nvcc_path
    try:
        path = nvcc_path()
    except RuntimeError:
        return None
    out = _run([path, "--version"])
    if not out:
        return None
    for line in out.splitlines():
        if "release" in line:
            return line.strip()
    return out.splitlines()[-1]


def cutlass_path():
    """The first CUTLASS include directory that holds ``cutlass/cutlass.h``
    (``$CUTLASS_PATH/include`` first), or None."""
    roots = []
    if os.environ.get("CUTLASS_PATH"):
        roots.append(os.path.join(os.environ["CUTLASS_PATH"], "include"))
    roots += list(CUTLASS_INCLUDE)
    for root in roots:
        if os.path.isfile(os.path.join(root, "cutlass", "cutlass.h")):
            return root
    return None


def device_report():
    """(name, power limit) from ``nvidia-smi``, or None without a GPU."""
    if not torch.cuda.is_available():
        return None
    smi = shutil.which("nvidia-smi")
    limit = None
    if smi:
        limit = _run([smi, "--query-gpu=name,power.limit",
                      "--format=csv,noheader"])
    return torch.cuda.get_device_name(0), limit


def version_report():
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.version import version
    print("DeepSpeed-TPU (PyTorch port) general environment info:")
    _line("install path", deepspeed_tpu_torch.__path__)
    _line("version", version)
    _line("torch version", torch.__version__)
    _line("torch CUDA version", torch.version.cuda)
    _line("nvcc", nvcc_version() or "not found")
    _line("CUTLASS headers", cutlass_path() or "not found")
    dev = device_report()
    if dev is None:
        _line("GPU", "none: torch.cuda.is_available() is False (the "
              "kernels run only on a CUDA device)")
    else:
        _line("GPU", dev[0])
        _line("name, power limit", dev[1] or "nvidia-smi unavailable")
        _line("device count", torch.cuda.device_count())
    return dev


def op_report():
    """One row per CUDA library and host op: (name, kind, sources, built,
    buildable)."""
    from deepspeed_tpu_torch.op_builder import builder
    rows = []
    print("-" * 64)
    print("DeepSpeed-TPU (PyTorch port) ops report")
    print("-" * 64)
    nvcc = shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc")
    for name in builder.sources():
        src, lib, _ = builder._paths(name)
        rows.append((name, "cuda", [os.path.relpath(src, builder._PKG)],
                     os.path.exists(lib), bool(nvcc)))
    gxx = shutil.which("g++") is not None
    for name in sorted(builder._HOST_BINDINGS):
        src, lib = builder._host_paths(name)
        rows.append((name, "host c++", [os.path.relpath(src, builder._PKG)],
                     os.path.exists(lib), gxx))
    for name, kind, srcs, built, buildable in rows:
        status = OKAY if built else (WARNING + " buildable" if buildable
                                     else FAIL)
        _line("{} [{}]".format(name, kind), "{} {}".format(
            status, ", ".join(srcs)), width=30)
    print("build directory: {}".format(builder.BUILD_ROOT))
    return rows


def tuning_report():
    """The kernel-choice switches and this platform's autotune rows."""
    from deepspeed_tpu_torch.ops import autotuner
    print("kernel tuning:")
    _line("flash backward path", os.environ.get("DS_TPU_FLASH_BWD", "auto"))
    _line("online autotune", os.environ.get("DS_TPU_AUTOTUNE", "0"))
    plat = autotuner.platform()
    _line("autotune platform", plat)
    rows = {}
    for source, path in (("bundled", autotuner._BUNDLED_PATH),
                         ("user cache", autotuner._user_cache_path())):
        table = autotuner._load(path)
        mine = {k: v for k, v in table.items()
                if k.startswith(plat + "::")}
        _line("{} table".format(source), "{} rows, {} for this platform "
              "({})".format(len(table), len(mine), path))
        for key, entry in sorted(mine.items()):
            print("  {} -> {}".format(key[len(plat) + 2:],
                                      json.dumps(entry["choice"])))
        rows[source] = mine
    return rows


def main():
    version_report()
    op_report()
    tuning_report()
    return 0


def cli_main():
    sys.exit(main())


if __name__ == "__main__":
    cli_main()
