"""Kernel build: ``nvcc`` over ``deepspeed_tpu_torch/csrc/*.cu``, loaded with
ctypes.

Counterpart of ``deepspeed_tpu/op_builder/builder.py``. Each CUDA source is
compiled on its own into a shared library with a plain C interface (no
PyTorch headers, so a build takes seconds, not minutes)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o lib<name>.so csrc/<name>.cu

into ``build/deepspeed_tpu_torch/<hash>/`` at the root of the checkout, where
``<hash>`` covers the source and the flags, so an edited source builds anew
and an unchanged one loads at once. ``build_all`` builds every source, all
``nvcc`` runs started together. Nothing builds at import: the first
``load`` builds.
The compiler's ``-Xptxas=-v`` report (registers, shared memory, spills) is
kept beside each library as ``<name>.log``.
"""

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build",
                          "deepspeed_tpu_torch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED = {}
# Guards _LOADED: serving replicas on their own threads may meet a kernel
# first at the same moment, and each library must be built and loaded
# once.
_LOAD_LOCK = threading.Lock()


def sources():
    """Names (without ``.cu``) of every CUDA source in ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def nvcc_path():
    """The ``nvcc`` to build with: on PATH, else the toolkit's default
    location. Raises RuntimeError when there is none."""
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def _paths(name):
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    return src, os.path.join(out_dir, "lib{}.so".format(name)), \
        os.path.join(out_dir, "{}.log".format(name))


def _build(name):
    """Compile ``csrc/<name>.cu`` unless its library exists. Returns
    (library path, seconds spent compiling: 0.0 when it was built)."""
    src, lib, log = _paths(name)
    if os.path.exists(lib):
        return lib, 0.0
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib))
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path()] + list(NVCC_FLAGS) + ["-o", tmp, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    with open(log, "w") as f:
        f.write(proc.stdout)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("nvcc failed for {}.cu (exit {}):\n{}".format(
            name, proc.returncode, proc.stdout))
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, time.perf_counter() - t0


def build_all():
    """Build every source in ``csrc/`` that is not built yet, one ``nvcc``
    per source, all at once. Returns {name: seconds} for the sources this
    call compiled; raises the first build's error."""
    names = sources()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build, names))
    return {name: seconds for name, (_, seconds) in zip(names, built)
            if seconds}


def build_log(name):
    """The compiler's report for ``name`` (empty before it was built)."""
    log = _paths(name)[2]
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def load(name):
    """The ctypes library built from ``csrc/<name>.cu``, building it first
    when needed. Cached for the life of the process; safe to call from
    several threads at once (one build, one load)."""
    lib = _LOADED.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                lib = _LOADED[name] = ctypes.CDLL(_build(name)[0])
    return lib
