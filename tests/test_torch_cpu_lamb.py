"""Port parity for the LAMB ops: the host op (``ops/lamb/cpu_lamb.py`` over
the port's own ``csrc/host/cpu_lamb.cpp``) against the JAX package's
``DeepSpeedCPULamb`` bit for bit (the same C++ built with the same
flags), per-tensor trust ratios over segments included; the device
``FusedLamb`` against the JAX ``lamb_update`` within 1e-6 relative to each
tensor's max-abs; the op's plain torch version within two fp32 ulps; and
the offload engine's LAMB against the device LAMB engine.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as tds
from deepspeed_tpu.ops.lamb.cpu_lamb import DeepSpeedCPULamb as JCPULamb
from deepspeed_tpu.ops.lamb.fused_lamb import init_lamb_state, lamb_update
from deepspeed_tpu_torch.models.simple import SimpleModel
from deepspeed_tpu_torch.ops.lamb import fused_lamb
from deepspeed_tpu_torch.ops.lamb.cpu_lamb import (DeepSpeedCPULamb,
                                                   lamb_step_reference)
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb

torch.set_num_threads(1)


def _inputs(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n).astype(np.float32),
            (0.1 * rng.randn(n)).astype(np.float32),
            np.zeros(n, np.float32), np.zeros(n, np.float32))


@pytest.mark.parametrize("n", [64, 1000, 4099])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_cpu_lamb_equals_jax_bit_for_bit(n, wd):
    p, g, m, v = _inputs(n, n)
    jopt = JCPULamb(lr=1e-2, weight_decay=wd)
    assert jopt.ds_opt_lamb is not None  # the JAX op built (no fallback)
    topt = DeepSpeedCPULamb(lr=1e-2, weight_decay=wd)
    jp, jm, jv = p.copy(), m.copy(), v.copy()
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    rp, rm, rv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    for step in (1, 2, 3):
        jopt.step_flat(jp, g, jm, jv, step=step, lr=1e-2)
        topt.step_flat(tp, torch.from_numpy(g), tm, tv, step=step, lr=1e-2)
        ratio = lamb_step_reference(rp, torch.from_numpy(g), rm, rv, step,
                                    1e-2, weight_decay=wd)
        assert topt.get_lamb_coeffs() == jopt.get_lamb_coeffs()
        assert ratio == pytest.approx(topt.get_lamb_coeffs()[0], rel=1e-6)
    for got, want in ((tp, jp), (tm, jm), (tv, jv)):
        np.testing.assert_array_equal(got.numpy(), want)
    torch.testing.assert_close(rp, tp, rtol=2.0 ** -22, atol=1e-7)


def test_cpu_lamb_segments_and_fused_bf16_copy_equal_jax():
    rng = np.random.RandomState(7)
    n, segs = 2048, [(0, 1536), (1536, 512)]
    p = rng.randn(n).astype(np.float32)
    g = (0.1 * rng.randn(n)).astype(np.float32)
    jp, jm, jv = p.copy(), np.zeros(n, np.float32), np.zeros(n, np.float32)
    jout = np.zeros(n, np.uint16)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (jp, jm, jv))
    tout = torch.zeros(n, dtype=torch.bfloat16)
    jopt = JCPULamb(lr=3e-3, weight_decay=0.05)
    topt = DeepSpeedCPULamb(lr=3e-3, weight_decay=0.05)
    for step in (1, 2, 3):
        jopt.step_flat(jp, g, jm, jv, step=step, bf16_out=jout,
                       segments=segs)
        topt.step_flat(tp, torch.from_numpy(g), tm, tv, step=step,
                       bf16_out=tout, segments=segs)
    assert len(topt.get_lamb_coeffs()) == 2
    assert topt.get_lamb_coeffs() == jopt.get_lamb_coeffs()
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(
        tout.view(torch.int16).numpy().view(np.uint16), jout)
    with pytest.raises(ValueError, match="outside"):
        topt.step_flat(tp, torch.from_numpy(g), tm, tv, step=4,
                       segments=[(2000, 100)])


def test_fused_lamb_matches_jax_lamb_update():
    rng = np.random.RandomState(0)
    shapes = [(16, 8), (8,), (3, 5)]
    p = [rng.randn(*s).astype(np.float32) for s in shapes]
    g = [(0.1 * rng.randn(*s)).astype(np.float32) for s in shapes]
    p[1][:] = 0.0  # a zero weight norm: ratio 1
    jparams = {str(i): jnp.asarray(x) for i, x in enumerate(p)}
    jgrads = {str(i): jnp.asarray(x) for i, x in enumerate(g)}
    jstate = init_lamb_state(jparams)
    tp = [torch.from_numpy(x.copy()) for x in p]
    tstate = fused_lamb.init_lamb_state(tp)
    for _ in range(3):
        jparams, jstate = lamb_update(jparams, jgrads, jstate, lr=1e-2,
                                      weight_decay=0.01)
        fused_lamb.lamb_update(tp, [torch.from_numpy(x) for x in g], tstate,
                               lr=1e-2, weight_decay=0.01)
    assert tstate["step"] == int(jstate["step"]) == 3
    for i, t in enumerate(tp):
        want = np.asarray(jparams[str(i)])
        scale = np.abs(want).max()
        np.testing.assert_allclose(t.numpy(), want, rtol=0,
                                   atol=1e-6 * scale)
        np.testing.assert_allclose(tstate["exp_avg"][i].numpy(),
                                   np.asarray(jstate["exp_avg"][str(i)]),
                                   rtol=0, atol=1e-6 * np.abs(
                                       np.asarray(jstate["exp_avg"][str(i)])
                                   ).max())


def test_lamb_offload_engine_tracks_the_device_lamb_engine(caplog):
    """Lamb + cpu_offload trains with the host op; its trajectory tracks
    the device FusedLamb engine (the JAX test's bound); a device-only key
    is ignored with a warning."""
    rng = np.random.RandomState(3)
    x = rng.randn(8, 16).astype(np.float32)
    y = rng.randint(0, 16, size=(8,))

    def run(offload):
        cfg = {"train_batch_size": 8,
               "optimizer": {"type": "Lamb", "params": {
                   "lr": 1e-2, "weight_decay": 0.01,
                   "max_grad_norm": 0.0}}}
        if offload:
            cfg["bf16"] = {"enabled": True}
            cfg["zero_optimization"] = {"stage": 2, "cpu_offload": True}
        engine = tds.initialize(model=SimpleModel(16, device="cpu"),
                                config_params=cfg, device="cpu")[0]
        assert isinstance(engine.optimizer,
                          DeepSpeedCPULamb if offload else FusedLamb)
        losses = []
        for _ in range(5):
            loss = engine(x, y)
            engine.backward(loss)
            engine.step()
            losses.append(float(loss.detach()))
        return losses

    with caplog.at_level("WARNING"):
        host = run(True)
    assert "max_grad_norm" in caplog.text
    device = run(False)
    assert host[-1] < host[0]
    np.testing.assert_allclose(host, device, rtol=0.05, atol=0.02)
