"""deepspeed_tpu packaging (reference setup.py surface).

The reference pre-builds CUDA extensions at install time when DS_BUILD_OPS=1
(per-op DS_BUILD_* env flags) and writes git_version_info_installed.py. Here
the native tier is host-only C++ compiled by the OpBuilder JIT on first use;
DS_BUILD_OPS=1 triggers the same builds ahead of time so first import pays
no compile latency.

Build a wheel: python setup.py bdist_wheel
"""

import os
import subprocess

from setuptools import find_packages, setup


def build_ops_eagerly():
    from deepspeed_tpu.op_builder import ALL_OPS
    for name, builder_cls in ALL_OPS.items():
        flag = os.environ.get("DS_BUILD_{}".format(name.upper()),
                              os.environ.get("DS_BUILD_OPS", "0"))
        if flag == "1":
            builder = builder_cls()
            if builder.sources() and builder.is_compatible():
                print("pre-building op:", name)
                builder.load()


def git_info():
    def run(cmd):
        try:
            return subprocess.check_output(cmd, shell=True,
                                           text=True).strip()
        except Exception:
            return "unknown"
    return run("git rev-parse --short HEAD"), \
        run("git rev-parse --abbrev-ref HEAD")


if any(k.startswith("DS_BUILD_") and v == "1"
       for k, v in os.environ.items()):
    try:
        build_ops_eagerly()
    except Exception as e:  # keep installs working without a toolchain
        print("warning: eager op build failed:", e)

# Single source of truth for the version: the fallback literal in
# deepspeed_tpu/version.py (NOT the installed stamp this script generates).
import re

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "deepspeed_tpu", "version.py")) as f:
    match = re.search(r'^\s*version = "([^"]+)"\s*$', f.read(), re.M)
if match is None:
    raise RuntimeError("could not parse version from deepspeed_tpu/version.py")
version = match.group(1)
git_hash, git_branch = git_info()

# Mirror the reference's install-time version stamp
# (setup.py writes git_version_info_installed.py); removed afterward so an
# in-repo dev checkout never reports a stale stamp.
stamp = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "deepspeed_tpu", "git_version_info_installed.py")
try:
    with open(stamp, "w") as f:
        f.write('version = "{}"\ngit_hash = "{}"\ngit_branch = "{}"\n'.format(
            version, git_hash, git_branch))
except OSError:
    pass

try:
    setup(
        name="deepspeed_tpu",
        version=version,
        description="TPU-native large-model training framework with the "
        "DeepSpeed capability surface (JAX/XLA/pjit/Pallas)",
        packages=find_packages(include=["deepspeed_tpu", "deepspeed_tpu.*",
                                        "deepspeed_tpu_torch",
                                        "deepspeed_tpu_torch.*"]),
        include_package_data=True,
        # Explicit one-level globs: recursive '**' needs setuptools>=62.3.
        package_data={"deepspeed_tpu": ["csrc/*/*.cpp", "csrc/*/*.h",
                                        "csrc/*.cpp", "csrc/*.h"],
                      "deepspeed_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                              "csrc/host/*.cpp"]},
        install_requires=["jax", "flax", "numpy"],
        extras_require={"dev": ["pytest"]},
        scripts=["bin/deepspeed", "bin/ds_report", "bin/ds_elastic"],
        # The PyTorch port's runner (one process per GPU).
        entry_points={"console_scripts": [
            "deepspeed-torch=deepspeed_tpu_torch.launcher.runner:main"]},
        python_requires=">=3.9",
    )
finally:
    if os.path.exists(stamp):
        os.unlink(stamp)
