"""Kernel and host-op build: ``nvcc`` over ``deepspeed_tpu_torch/csrc/*.cu``
and ``g++`` over ``deepspeed_tpu_torch/csrc/host/*.cpp``, loaded with ctypes.

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

The host route builds the ZeRO-Offload tier's C++ ops (``cpu_adam``,
``cpu_lamb``, ``flatten_unflatten``) and the block-sparse layout lowering
(``lut``) from the port's own copies under ``csrc/host/``, with the JAX
package's flags::

    g++ -O3 -std=c++17 -shared -fPIC -fopenmp -march=native -Wall \
        csrc/host/<name>.cpp -o lib<name>.so

into the same hashed directory, at first use (``load_host``), with each
op's ``argtypes``/``restype`` bound as the JAX builder binds them. A failed
build raises: there is no fallback to a Python loop.
"""

import concurrent.futures
import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build",
                          "deepspeed_tpu_torch")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

HOST_CSRC = os.path.join(CSRC, "host")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp",
             "-march=native", "-Wall")

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


# ------------------------------------------------------------ host route

_c_float_p = ctypes.POINTER(ctypes.c_float)
_c_u16_p = ctypes.POINTER(ctypes.c_uint16)
_c_long_p = ctypes.POINTER(ctypes.c_long)


def _bind_cpu_adam(lib):
    scalar = [ctypes.c_long, ctypes.c_float, ctypes.c_float, ctypes.c_float,
              ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
              ctypes.c_long]
    lib.ds_adam_step.argtypes = scalar + [_c_float_p] * 4
    lib.ds_adam_step.restype = None
    lib.ds_adam_step_copy_bf16.argtypes = scalar + [_c_float_p] * 4 + \
        [_c_u16_p]
    lib.ds_adam_step_copy_bf16.restype = None
    lib.ds_l2_norm_sq.argtypes = [ctypes.c_long, _c_float_p]
    lib.ds_l2_norm_sq.restype = ctypes.c_double
    lib.ds_scale.argtypes = [ctypes.c_long, ctypes.c_float, _c_float_p]
    lib.ds_scale.restype = None


def _bind_cpu_lamb(lib):
    lib.ds_lamb_step.argtypes = [
        ctypes.c_long, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_long] + [_c_float_p] * 5 + [_c_u16_p]
    lib.ds_lamb_step.restype = ctypes.c_float
    lib.ds_lamb_norms.argtypes = [
        ctypes.c_long, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_long] + [_c_float_p] * 5 + \
        [ctypes.POINTER(ctypes.c_double)]
    lib.ds_lamb_norms.restype = None
    lib.ds_lamb_ratio.argtypes = [ctypes.c_double, ctypes.c_double,
                                  ctypes.c_float, ctypes.c_float]
    lib.ds_lamb_ratio.restype = ctypes.c_float
    lib.ds_lamb_apply.argtypes = [ctypes.c_float, ctypes.c_float,
                                  ctypes.c_long, _c_float_p, _c_float_p,
                                  _c_u16_p]
    lib.ds_lamb_apply.restype = None


def _bind_flatten_unflatten(lib):
    pp = ctypes.POINTER(_c_float_p)
    for fn in (lib.ds_flatten, lib.ds_unflatten):
        fn.argtypes = [pp, _c_long_p, ctypes.c_int, _c_float_p]
        fn.restype = None


def _bind_lut(lib):
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.ds_lut_max_degree.argtypes = [ctypes.c_long] * 3 + [i32p,
                                                            ctypes.c_int]
    lib.ds_lut_max_degree.restype = ctypes.c_long
    lib.ds_build_lut.argtypes = [ctypes.c_long] * 3 + [
        i32p, ctypes.c_int, ctypes.c_long, i32p]
    lib.ds_build_lut.restype = None


_HOST_BINDINGS = {"cpu_adam": _bind_cpu_adam, "cpu_lamb": _bind_cpu_lamb,
                  "flatten_unflatten": _bind_flatten_unflatten,
                  "lut": _bind_lut}


def host_sources():
    """Absolute paths of every C++ source the host route compiles: the
    port's own copies under ``csrc/host/``."""
    return [os.path.join(HOST_CSRC, name + ".cpp")
            for name in sorted(_HOST_BINDINGS)]


def gxx_path():
    """The ``g++`` to build with. Raises RuntimeError when there is none."""
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the host ops (cpu_adam, cpu_lamb, "
                           "flatten_unflatten, lut) build only where a C++ "
                           "compiler is installed")
    return path


def host_cpu_identity():
    """What ``-march=native`` compiles for: the machine, and the CPU's
    model name and feature flags from ``/proc/cpuinfo`` where it exists. A
    library built on one host must not load on another with other
    instructions."""
    ident = [platform.machine()]
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor's block is enough
                if line.split(":", 1)[0].strip() in ("model name", "flags",
                                                     "Features"):
                    ident.append(line.strip())
    return "\n".join(ident)


def _host_paths(name):
    src = os.path.join(HOST_CSRC, name + ".cpp")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(host_cpu_identity().encode())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    return src, os.path.join(out_dir, "lib{}.so".format(name))


def _build_host(name):
    """Compile ``csrc/host/<name>.cpp`` unless its library exists; returns
    the library's path. Raises RuntimeError with the compiler's output when
    g++ fails."""
    src, lib = _host_paths(name)
    if os.path.exists(lib):
        return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib))
    os.close(fd)
    proc = subprocess.run([gxx_path()] + list(GXX_FLAGS) + [src, "-o", tmp],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError("g++ failed for host/{}.cpp (exit {}):\n{}".format(
            name, proc.returncode, proc.stdout))
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def load_host(name):
    """The ctypes library built from ``csrc/host/<name>.cpp`` with its
    functions' ``argtypes``/``restype`` bound, building it first when
    needed. Cached for the life of the process; thread-safe as ``load``."""
    key = "host/" + name
    lib = _LOADED.get(key)
    if lib is None:
        if name not in _HOST_BINDINGS:
            raise ValueError("unknown host op {!r} ({})".format(
                name, ", ".join(sorted(_HOST_BINDINGS))))
        with _LOAD_LOCK:
            lib = _LOADED.get(key)
            if lib is None:
                lib = ctypes.CDLL(_build_host(name))
                _HOST_BINDINGS[name](lib)
                _LOADED[key] = lib
    return lib


def float_ptr(t):
    """C ``float*`` to a contiguous fp32 CPU tensor's data."""
    _check_host(t, (torch.float32,))
    return ctypes.cast(t.data_ptr(), _c_float_p)


def u16_ptr(t):
    """C ``uint16_t*`` to a contiguous 16-bit CPU tensor's data (the bf16
    bits), or NULL for None."""
    if t is None:
        return _c_u16_p()
    _check_host(t, (torch.bfloat16, torch.int16, torch.uint16))
    return ctypes.cast(t.data_ptr(), _c_u16_p)


def _check_host(t, dtypes):
    if t.device.type != "cpu" or t.dtype not in dtypes or \
            not t.is_contiguous():
        raise ValueError("host op: expected a contiguous CPU tensor of {}, "
                         "got {} {} on {}".format(
                             "/".join(str(d) for d in dtypes), t.dtype,
                             "contiguous" if t.is_contiguous() else "strided",
                             t.device))


def flatten_into(lib, dst, tensors):
    """Pack contiguous fp32 CPU ``tensors`` back to back into ``dst`` with
    one OpenMP ``ds_flatten`` call."""
    n = len(tensors)
    if sum(t.numel() for t in tensors) > dst.numel():
        raise ValueError("flatten_into: {} elements do not fit {}".format(
            sum(t.numel() for t in tensors), dst.numel()))
    srcs = (_c_float_p * n)(*[float_ptr(t) for t in tensors])
    sizes = (ctypes.c_long * n)(*[t.numel() for t in tensors])
    lib.ds_flatten(srcs, sizes, n, float_ptr(dst))


def unflatten_into(lib, dsts, src):
    """Scatter ``src`` back into contiguous fp32 CPU ``dsts`` spans."""
    n = len(dsts)
    if sum(t.numel() for t in dsts) > src.numel():
        raise ValueError("unflatten_into: {} elements exceed {}".format(
            sum(t.numel() for t in dsts), src.numel()))
    ptrs = (_c_float_p * n)(*[float_ptr(t) for t in dsts])
    sizes = (ctypes.c_long * n)(*[t.numel() for t in dsts])
    lib.ds_unflatten(ptrs, sizes, n, float_ptr(src))
