"""Port parity for the host Adam op (``ops/adam/cpu_adam.py`` over the port's
own ``csrc/host/cpu_adam.cpp``) and the host build route, on the CPU.

The port's op and the JAX package's ``DeepSpeedCPUAdam`` are the same C++
arithmetic built by ``g++`` with the same flags: on the same numpy inputs
their parameters, moments and fused bf16 copies must be equal bit for bit.
The op's plain torch version (``adam_step_reference``) agrees within two
fp32 ulps of each element (the compiled loop may contract FMAs).
"""

import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.op_builder import UtilsBuilder
from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JCPUAdam
from deepspeed_tpu_torch.op_builder import builder
from deepspeed_tpu_torch.ops.adam.cpu_adam import (DeepSpeedCPUAdam,
                                                   adam_step_reference)

torch.set_num_threads(1)


def _inputs(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32),
            np.zeros(n, np.float32), np.zeros(n, np.float32))


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def test_host_ops_build_from_the_ports_own_sources():
    srcs = builder.host_sources()
    assert [os.path.basename(s) for s in srcs] == [
        "cpu_adam.cpp", "cpu_lamb.cpp", "flatten_unflatten.cpp", "lut.cpp"]
    for name in ("cpu_adam", "cpu_lamb", "flatten_unflatten", "lut"):
        lib = builder.load_host(name)
        assert builder.load_host(name) is lib  # cached
    lib = builder.load_host("cpu_adam")
    assert hasattr(lib, "ds_adam_step") and \
        hasattr(lib, "ds_adam_step_copy_bf16")
    assert builder.GXX_FLAGS == ("-O3", "-std=c++17", "-shared", "-fPIC",
                                 "-fopenmp", "-march=native", "-Wall")


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No fallback: a missing g++ or a source that does not compile
    raises."""
    monkeypatch.setattr(builder.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        builder.gxx_path()
    monkeypatch.undo()
    bad = tmp_path / "host"
    bad.mkdir()
    (bad / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(builder, "HOST_CSRC", str(bad))
    monkeypatch.setattr(builder, "BUILD_ROOT", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        builder._build_host("broken")
    with pytest.raises(ValueError, match="unknown host op"):
        builder.load_host("broken")


def test_host_build_dir_depends_on_the_cpu(monkeypatch):
    """-march=native ties a library to its host's CPU: another CPU (other
    flags) builds into another directory, so a library built on one host
    is never loaded on another."""
    ident = builder.host_cpu_identity()
    assert ident.startswith(builder.platform.machine())
    here = builder._host_paths("cpu_adam")
    assert builder._host_paths("cpu_adam") == here
    monkeypatch.setattr(builder, "host_cpu_identity",
                        lambda: ident + " avx512f")
    there = builder._host_paths("cpu_adam")
    assert there[0] == here[0] and there[1] != here[1]


@pytest.mark.parametrize("n", [64, 1000, 4099])
@pytest.mark.parametrize("adamw", [True, False])
def test_cpu_adam_equals_jax_bit_for_bit(n, adamw):
    p, g, m, v = _inputs(n, n)
    jopt = JCPUAdam(lr=1e-2, weight_decay=0.01, adamw_mode=adamw)
    assert jopt.ds_opt_adam is not None  # the JAX op built (no fallback)
    topt = DeepSpeedCPUAdam(lr=1e-2, weight_decay=0.01, adamw_mode=adamw)
    jp, jm, jv = p.copy(), m.copy(), v.copy()
    tp, tm, tv = _t(p, m, v)
    rp, rm, rv = _t(p, m, v)
    for step in range(1, 4):
        jopt.step_flat(jp, g, jm, jv, step=step)
        topt.step_flat(tp, torch.from_numpy(g), tm, tv, step=step)
        adam_step_reference(rp, torch.from_numpy(g), rm, rv, step, 1e-2,
                            weight_decay=0.01, adamw_mode=adamw)
    for got, want in ((tp, jp), (tm, jm), (tv, jv)):
        np.testing.assert_array_equal(got.numpy(), want)
    for got, want in ((rp, tp), (rm, tm), (rv, tv)):
        torch.testing.assert_close(got, want, rtol=2.0 ** -22, atol=1e-7)


def test_cpu_adam_fused_bf16_copy_equals_jax():
    p, g, m, v = _inputs(256, 0)
    jout = np.zeros(256, np.uint16)
    JCPUAdam(lr=1e-2).step_flat(p, g, m, v, step=1, bf16_out=jout)
    tp, tg, tm, tv = _t(*_inputs(256, 0))
    tout = torch.zeros(256, dtype=torch.bfloat16)
    DeepSpeedCPUAdam(lr=1e-2).step_flat(tp, tg, tm, tv, step=1,
                                        bf16_out=tout)
    np.testing.assert_array_equal(tout.view(torch.int16).numpy()
                                  .view(np.uint16), jout)
    np.testing.assert_array_equal(tp.numpy(), p)
    # the copy is bf16(p), round to nearest even
    assert torch.equal(tout, tp.to(torch.bfloat16))


def test_cpu_adam_norm_and_scale():
    opt, jopt = DeepSpeedCPUAdam(), JCPUAdam()
    x = np.arange(8, dtype=np.float32)
    assert opt.l2_norm(torch.from_numpy(x)) == jopt.l2_norm(x)
    assert abs(opt.l2_norm(torch.from_numpy(x)) - np.linalg.norm(x)) < 1e-4
    t = torch.from_numpy(x.copy())
    opt.scale_(t, 0.5)
    jopt.scale_(x, 0.5)
    np.testing.assert_array_equal(t.numpy(), x)
    with pytest.raises(ValueError, match="contiguous CPU tensor"):
        opt.scale_(torch.zeros(4, 2)[:, 0], 2.0)


def test_cpu_adam_torch_style_step_matches_step_flat():
    """step() over tensors with .grad, and the fused copy into bf16
    tensors, equals step_flat on the same buffers."""
    p, g, m, v = _inputs(96, 3)
    params = [torch.from_numpy(p[:60].copy()).view(6, 10),
              torch.from_numpy(p[60:].copy())]
    params[0].grad = torch.from_numpy(g[:60].copy()).view(6, 10)
    params[1].grad = torch.from_numpy(g[60:].copy())
    out = [torch.zeros(6, 10, dtype=torch.bfloat16),
           torch.zeros(36, dtype=torch.bfloat16)]
    opt = DeepSpeedCPUAdam(model_params=params, lr=1e-2)
    for _ in range(2):
        opt.step(fp16_param_groups=[out])
    flat = DeepSpeedCPUAdam(lr=1e-2)
    tp, tg, tm, tv = _t(p, g, m, v)
    for step in (1, 2):
        for sl in (slice(0, 60), slice(60, 96)):
            flat.step_flat(tp[sl], tg[sl], tm[sl], tv[sl], step=step)
    assert torch.equal(torch.cat([x.reshape(-1) for x in params]), tp)
    assert torch.equal(torch.cat([x.reshape(-1) for x in out]),
                       tp.to(torch.bfloat16))


def test_flatten_unflatten_equal_the_jax_op():
    lib = builder.load_host("flatten_unflatten")
    rng = np.random.RandomState(1)
    arrays = [rng.randn(s).astype(np.float32) for s in (3, 7, 16)]
    jflat = np.empty(26, np.float32)
    UtilsBuilder.flatten_into(UtilsBuilder().load(), jflat, arrays)
    flat = torch.empty(26)
    builder.flatten_into(lib, flat, [torch.from_numpy(a) for a in arrays])
    np.testing.assert_array_equal(flat.numpy(), jflat)
    outs = [torch.zeros(a.size) for a in arrays]
    builder.unflatten_into(lib, outs, flat)
    for o, a in zip(outs, arrays):
        np.testing.assert_array_equal(o.numpy(), a)
    with pytest.raises(ValueError, match="do not fit"):
        builder.flatten_into(lib, torch.empty(10), [torch.zeros(11)])
