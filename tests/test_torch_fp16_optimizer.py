"""Port parity for the standalone fp16 optimizer wrappers
(``runtime/fp16/fused_optimizer.py``, ``unfused_optimizer.py``): the eight
cases of the JAX package's ``test_fp16_optimizer.py``, each also run
through the JAX wrapper on the same numpy inputs, the parameters within
1e-6 relative to their max-abs and the scaler state equal.
"""

import jax.numpy as jnp
import numpy as np
import torch

from deepspeed_tpu.ops.adam.fused_adam import FusedAdam as JFusedAdam
from deepspeed_tpu.ops.lamb.fused_lamb import FusedLamb as JFusedLamb
from deepspeed_tpu.runtime.fp16.fused_optimizer import \
    FP16_Optimizer as JFP16_Optimizer
from deepspeed_tpu.runtime.fp16.unfused_optimizer import \
    FP16_UnfusedOptimizer as JFP16_UnfusedOptimizer
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb
from deepspeed_tpu_torch.runtime.fp16 import (FP16_Optimizer,
                                              FP16_UnfusedOptimizer)

torch.set_num_threads(1)

ARGS = {"init_scale": 2 ** 8, "scale_window": 2, "delayed_shift": 1}


def _w(seed=0, n=8):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


def _setup(adam=True, **kw):
    """(port params, opt, state), (JAX params, opt, state)."""
    w = _w()
    if adam:
        topt = FP16_Optimizer(FusedAdam(lr=1e-2), dynamic_loss_scale=True,
                              dynamic_loss_args=dict(ARGS), **kw)
        jopt = JFP16_Optimizer(JFusedAdam(lr=1e-2), dynamic_loss_scale=True,
                               dynamic_loss_args=dict(ARGS), **kw)
    else:
        topt = FP16_UnfusedOptimizer(FusedLamb(lr=1e-2),
                                     dynamic_loss_scale=True,
                                     dynamic_loss_args=dict(ARGS), **kw)
        jopt = JFP16_UnfusedOptimizer(JFusedLamb(lr=1e-2),
                                      dynamic_loss_scale=True,
                                      dynamic_loss_args=dict(ARGS), **kw)
    tparams = [torch.from_numpy(w.copy())]
    jparams = {"w": jnp.asarray(w)}
    return ((tparams, topt, topt.init_state(tparams)),
            (jparams, jopt, jopt.init_state(jparams)))


def _close(t, j):
    want = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def _scaler(opt):
    return {k: v for k, v in vars(opt.loss_scaler).items()}


def test_normal_step_unscales_grads():
    (tp, topt, ts), (jp, jopt, js) = _setup()
    scale = topt.cur_scale
    grads = [torch.ones(8) * scale]  # pre-scaled gradients of 1.0
    tp2, _, overflow = topt.step(tp, grads, ts)
    assert not overflow
    ref = [torch.from_numpy(_w())]
    inner = FusedAdam(lr=1e-2)
    inner.update(ref, [torch.ones(8)], inner.init_state(ref))
    torch.testing.assert_close(tp2[0], ref[0], rtol=1e-6, atol=0)
    jp2, _, _ = jopt.step(jp, {"w": jnp.ones(8) * scale}, js)
    _close(tp2[0], jp2["w"])
    assert torch.equal(grads[0], torch.ones(8) * scale)  # left unchanged


def test_overflow_skips_and_reduces_scale():
    (tp, topt, ts), (jp, jopt, js) = _setup()
    scale0 = topt.cur_scale
    before = tp[0].clone()
    tp2, ts2, overflow = topt.step(tp, [torch.full((8,), float("inf"))], ts)
    jopt.step(jp, {"w": jnp.full((8,), jnp.inf)}, js)
    assert overflow and topt.skipped_steps == 1
    assert topt.cur_scale == scale0 / 2
    assert torch.equal(tp2[0], before)
    assert torch.equal(ts2["exp_avg"][0], torch.zeros(8))
    assert _scaler(topt) == _scaler(jopt)


def test_scale_window_growth():
    (tp, topt, ts), (jp, jopt, js) = _setup()
    scale0 = topt.cur_scale
    for _ in range(2):  # scale_window = 2 clean steps
        tp, ts, _ = topt.step(tp, [torch.ones(8)], ts)
        jp, js, _ = jopt.step(jp, {"w": jnp.ones(8)}, js)
    assert topt.cur_scale == scale0 * 2 == jopt.cur_scale
    _close(tp[0], jp["w"])


def test_backward_scales_loss():
    (_, topt, _), (_, jopt, _) = _setup()
    loss = torch.tensor(2.0)
    assert float(topt.backward(loss)) == 2.0 * topt.cur_scale == \
        float(jopt.backward(jnp.float32(2.0)))


def test_clip_grad():
    (tp, topt, ts), (jp, jopt, js) = _setup(clip_grad=0.1)
    big = np.ones(8, np.float32) * topt.cur_scale * 100
    tp2, _, overflow = topt.step(tp, [torch.from_numpy(big)], ts)
    jp2, _, _ = jopt.step(jp, {"w": jnp.asarray(big)}, js)
    assert not overflow  # big but finite
    _close(tp2[0], jp2["w"])


def test_state_dict_roundtrip():
    (tp, topt, ts), (jp, jopt, js) = _setup()
    topt.step(tp, [torch.full((8,), float("inf"))], ts)
    jopt.step(jp, {"w": jnp.full((8,), jnp.inf)}, js)
    sd = topt.state_dict()
    assert sd["skipped_steps"] == 1 and sd["overflow"]
    assert sd == jopt.state_dict()
    (_, opt2, _), _ = _setup()
    opt2.load_state_dict(sd)
    assert opt2.skipped_steps == 1
    assert opt2.cur_scale == topt.cur_scale
    assert opt2.loss_scaler.cur_iter == topt.loss_scaler.cur_iter


def test_unfused_lamb_step():
    w = _w(1)
    tp = [torch.from_numpy(w.copy())]
    topt = FP16_UnfusedOptimizer(FusedLamb(lr=1e-2), static_loss_scale=4.0)
    jopt = JFP16_UnfusedOptimizer(JFusedLamb(lr=1e-2), static_loss_scale=4.0)
    tp2, _, overflow = topt.step_fused_lamb(tp, [torch.ones(8) * 4.0],
                                            topt.init_state(tp))
    jparams = {"w": jnp.asarray(w)}
    jp2, _, _ = jopt.step_fused_lamb(jparams, {"w": jnp.ones(8) * 4.0},
                                     jopt.init_state(jparams))
    assert not overflow
    assert not np.allclose(tp2[0].numpy(), w)
    _close(tp2[0], jp2["w"])


def test_unfused_lamb_max_grad_norm_clips():
    """max_grad_norm folds the global norm into the unscale: the step
    equals one on pre-normalized gradients, and step() routes FusedLamb
    through the LAMB path; all as the JAX wrapper."""
    rng = np.random.RandomState(3)
    w = rng.randn(16).astype(np.float32)
    big = rng.randn(16).astype(np.float32) * 100.0
    norm = float(np.linalg.norm(big))

    def run(cls, inner, params, grads):
        opt = cls(inner, static_loss_scale=1.0)
        return opt.step_fused_lamb(params, grads, opt.init_state(params))[0]

    p_clip = run(FP16_UnfusedOptimizer, FusedLamb(lr=1e-2, max_grad_norm=1.0),
                 [torch.from_numpy(w.copy())], [torch.from_numpy(big)])
    p_ref = run(FP16_UnfusedOptimizer, FusedLamb(lr=1e-2),
                [torch.from_numpy(w.copy())], [torch.from_numpy(big / norm)])
    torch.testing.assert_close(p_clip[0], p_ref[0], rtol=1e-5, atol=0)
    j_clip = run(JFP16_UnfusedOptimizer,
                 JFusedLamb(lr=1e-2, max_grad_norm=1.0),
                 {"w": jnp.asarray(w)}, {"w": jnp.asarray(big)})
    _close(p_clip[0], j_clip["w"])
    opt2 = FP16_UnfusedOptimizer(FusedLamb(lr=1e-2, max_grad_norm=1.0),
                                 static_loss_scale=1.0)
    tp = [torch.from_numpy(w.copy())]
    p_step = opt2.step(tp, [torch.from_numpy(big)], opt2.init_state(tp))[0]
    torch.testing.assert_close(p_step[0], p_clip[0], rtol=1e-6, atol=0)
