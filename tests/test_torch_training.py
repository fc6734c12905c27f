"""Port parity for the training path: GPT-2's training forward, AdamW,
clipping, the LR schedules, loss scaling, the engine and its checkpoints,
against the JAX package on the CPU, in fp32.

One tiny GPT-2 is initialised in flax and carried into the port
(``params_from_jax`` or ``model_parameters``). Inputs come from numpy
seeds. Tolerances: 1e-5 relative to each tensor's max-abs for gradients,
1e-5 relative for losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models.gpt2 import GPT2Config as JConfig
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JModel
from deepspeed_tpu.models import simple as jsimple
from deepspeed_tpu.ops.adam import fused_adam as jadam
from deepspeed_tpu.parallel import mesh as mesh_lib
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime import utils as jutils
from deepspeed_tpu.runtime.fp16 import loss_scaler as jscaler
from deepspeed_tpu_torch.models import (GPT2Config, GPT2LMHeadModel,
                                        params_from_jax)
from deepspeed_tpu_torch.models import simple as tsimple
from deepspeed_tpu_torch.ops.adam import fused_adam as tadam
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime import utils as tutils
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as tscaler

torch.set_num_threads(1)

TOL = 1e-5
SEQ = 32


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * scale,
                               rtol=0)


def _batch(n, seed):
    return np.random.RandomState(seed).randint(0, 1024, size=(n, SEQ))


_PARAMS = {}


def _jax_params():
    """Fresh device arrays each call: the JAX engine donates its
    parameter buffers."""
    if not _PARAMS:
        jcfg = JConfig.tiny(dtype=jnp.float32)
        _PARAMS["p"] = _tree(JModel(jcfg).init(
            jax.random.PRNGKey(0), jnp.asarray(_batch(2, 0)))["params"])
    return jax.tree_util.tree_map(jnp.asarray, _PARAMS["p"])


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + key + "."))
        else:
            out[prefix + key] = np.asarray(val)
    return out


@pytest.mark.parametrize("flash", [True, False])
def test_gpt2_loss_and_every_grad_match_jax(flash):
    params = _jax_params()
    jmodel = JModel(JConfig.tiny(dtype=jnp.float32,
                                 use_flash_attention=flash))
    ids = _batch(2, 1)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, jnp.asarray(ids),
                               labels=jnp.asarray(ids)))(params)
    model = params_from_jax(_tree(params), GPT2Config.tiny(
        dtype=torch.float32, use_flash_attention=flash), device="cpu")
    model.requires_grad_(True)
    t_ids = torch.from_numpy(ids)
    loss = model(t_ids, labels=t_ids)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=TOL)
    want = _flat(_tree(jgrads))
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name])


def test_gpt2_logits_without_labels_match_jax():
    params = _jax_params()
    ids = _batch(2, 2)
    want = JModel(JConfig.tiny(dtype=jnp.float32)).apply(
        {"params": params}, jnp.asarray(ids))
    model = params_from_jax(_tree(params), GPT2Config.tiny(
        dtype=torch.float32), device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (2, SEQ, 1024)
    _close(got.numpy(), want)


def test_gpt2_remat_and_sequence_parallel_switches():
    cfg = GPT2Config.tiny(dtype=torch.float32, dropout=0.1)
    ids = torch.from_numpy(_batch(2, 3))
    model = GPT2LMHeadModel(cfg, device="cpu").requires_grad_(True)
    remat = GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.float32, dropout=0.1,
                                            remat=True), device="cpu")
    remat.load_state_dict(model.state_dict())
    remat.requires_grad_(True)
    for m in (model, remat):
        g = torch.Generator().manual_seed(5)
        m(ids, labels=ids, deterministic=False, generator=g).backward()
    for (name, a), b in zip(model.named_parameters(), remat.parameters()):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-6,
                                   msg=name)
    # A sequence-shardable model without a seq line runs serially (the JAX
    # model outside shard_map): the same loss as the plain model.
    sharded = GPT2LMHeadModel(GPT2Config.tiny(
        dtype=torch.float32, sequence_parallel_axis="seq"), device="cpu")
    sharded.load_state_dict(model.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(sharded(ids, labels=ids),
                                   model(ids, labels=ids), rtol=0, atol=0)
    with pytest.raises(ValueError, match="sequence_parallel_axis"):
        model.set_sequence_parallel(object())


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_adam_update_one_step_matches_jax(adam_w_mode):
    rng = np.random.RandomState(0)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    p, g, m, v = ([rng.randn(*s).astype(np.float32) for s in shapes]
                  for _ in range(4))
    v = [np.abs(x) for x in v]
    kw = dict(lr=1e-2, beta1=0.8, beta2=0.95, eps=1e-6, weight_decay=0.1,
              adam_w_mode=adam_w_mode)
    state = {"step": jnp.asarray(3, jnp.int32),
             "exp_avg": [jnp.asarray(x) for x in m],
             "exp_avg_sq": [jnp.asarray(x) for x in v]}
    jp, js = jadam.adam_update([jnp.asarray(x) for x in p],
                               [jnp.asarray(x) for x in g], state, **kw)
    tp = [torch.from_numpy(x.copy()) for x in p]
    ts = {"step": 3, "exp_avg": [torch.from_numpy(x.copy()) for x in m],
          "exp_avg_sq": [torch.from_numpy(x.copy()) for x in v]}
    tadam.adam_update(tp, [torch.from_numpy(x) for x in g], ts, **kw)
    assert ts["step"] == int(js["step"]) == 4
    for got, want in zip(tp + ts["exp_avg"] + ts["exp_avg_sq"],
                         list(jp) + list(js["exp_avg"])
                         + list(js["exp_avg_sq"])):
        _close(got.numpy(), want)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_grad_norm_matches_jax(max_norm):
    rng = np.random.RandomState(1)
    grads = [rng.randn(*s).astype(np.float32) for s in [(6, 3), (4,)]]
    jclipped, jnorm = jutils.clip_grad_norm_([jnp.asarray(x) for x in grads],
                                             max_norm)
    tg = [torch.from_numpy(x.copy()) for x in grads]
    tnorm = tutils.clip_grad_norm_(tg, max_norm)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=TOL)
    np.testing.assert_allclose(float(tutils.global_norm(tg)),
                               float(jutils.global_norm(jclipped)), rtol=TOL)
    for got, want in zip(tg, jclipped):
        _close(got.numpy(), want)
    tg[1][2] = float("inf")
    assert bool(tutils.has_overflow(tg))
    assert not bool(tutils.has_overflow(tg[:1]))


class _Groups:
    def __init__(self):
        self.param_groups = [{"lr": 0.5, "betas": (0.9, 0.999)}]


@pytest.mark.parametrize("name,params", [
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-3,
                     "lr_range_test_step_size": 3,
                     "lr_range_test_step_rate": 2.0,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_min_lr": 1e-3, "cycle_max_lr": 1e-2,
                  "cycle_first_step_size": 5, "decay_lr_rate": 0.1,
                  "decay_step_size": 2, "cycle_momentum": True}),
    ("WarmupLR", {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-2,
                  "warmup_num_steps": 7}),
    ("WarmupDecayLR", {"total_num_steps": 15, "warmup_min_lr": 0.0,
                       "warmup_max_lr": 1e-2, "warmup_num_steps": 4})])
def test_lr_schedules_match_jax_over_20_steps(name, params):
    jopt, topt = _Groups(), _Groups()
    jsched = getattr(jlr, name)(jopt, **params)
    tsched = getattr(tlr, name)(topt, **params)
    for _ in range(20):
        jsched.step()
        tsched.step()
        assert topt.param_groups == jopt.param_groups
    assert tsched.state_dict() == jsched.state_dict()


OVERFLOWS = [False, True, False, True, True, False, False, False, False,
             True, False, False, False, False, False, True]


def test_dynamic_loss_scaler_sequence_matches_jax():
    kw = dict(init_scale=2 ** 16, scale_window=3, min_scale=1,
              delayed_shift=2)
    js, ts = jscaler.DynamicLossScaler(**kw), tscaler.DynamicLossScaler(**kw)
    for overflow in OVERFLOWS:
        js.update_scale(overflow)
        ts.update_scale(overflow)
        assert ts.__dict__ == js.__dict__
    args = {"INITIAL_LOSS_SCALE": 2 ** 8, "SCALE_WINDOW": 5,
            "DELAYED_SHIFT": 1, "MIN_LOSS_SCALE": 2}
    assert tscaler.CreateLossScaler(True, 1.0, args).__dict__ == \
        jscaler.CreateLossScaler(True, 1.0, args).__dict__
    assert tscaler.CreateLossScaler(False, 4.0, None).loss_scale == 4.0


class _Scaled(torch.nn.Module):
    """GPT-2 whose loss is multiplied by an input factor: inf injects an
    overflow into every gradient."""

    def __init__(self):
        super().__init__()
        self.gpt = GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.float16),
                                   device="cpu")

    def forward(self, ids, factor):
        return self.gpt(ids, labels=ids) * factor


def test_engine_fp16_skips_and_rescales_like_the_jax_scaler():
    fp16 = {"enabled": True, "initial_scale_power": 10,
            "loss_scale_window": 3, "hysteresis": 2, "min_loss_scale": 1}
    engine, _, _, _ = tds.initialize(model=_Scaled(), config_params={
        "train_batch_size": 2, "fp16": fp16,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}},
        device="cpu")
    ref = jscaler.DynamicLossScaler(init_scale=2 ** 10, scale_window=3,
                                    delayed_shift=2, min_scale=1)
    ids = torch.from_numpy(_batch(2, 4))
    skipped = 0
    for overflow in OVERFLOWS[:10]:
        assert engine.loss_scaler.loss_scale == ref.loss_scale
        factor = torch.tensor(float("inf") if overflow else 1.0)
        engine.train_batch((ids, factor))
        ref.update_scale(overflow)
        skipped += overflow
        assert engine.skipped_steps == skipped
    assert engine.global_steps == 10


def _config(**extra):
    cfg = {"train_batch_size": 8, "gradient_accumulation_steps": 2,
           "steps_per_print": 100,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-2, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_min_lr": 1e-3,
                                    "warmup_max_lr": 1e-2,
                                    "warmup_num_steps": 3}},
           "gradient_clipping": 1.0}
    cfg.update(extra)
    return cfg


def _jax_engine(params):
    mesh = mesh_lib.build_mesh(num_dp=1, devices=jax.devices()[:1])
    engine, _, _, _ = jds.initialize(
        model=JModel(JConfig.tiny(dtype=jnp.float32)),
        model_parameters=params, config_params=_config(), mesh=mesh)
    return engine


def _port_engine(params):
    engine, _, _, _ = tds.initialize(
        model=GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.float32),
                              device="cpu", seed=None),
        model_parameters=_tree(params), config_params=_config(),
        device="cpu")
    return engine


def _micro(engine, seed):
    ids = _batch(4, seed)
    loss = engine(ids, ids)
    engine.backward(loss)
    engine.step()
    return float(loss.detach() if isinstance(loss, torch.Tensor) else loss)


def test_engine_five_step_loss_trace_matches_jax():
    """AdamW with weight decay, WarmupLR, gradient_clipping 1.0, gas 2:
    five optimizer steps, ten micro-batches."""
    params = _jax_params()
    jeng, teng = _jax_engine(params), _port_engine(params)
    jl = [_micro(jeng, i % 2) for i in range(10)]
    tl = [_micro(teng, i % 2) for i in range(10)]
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert jl[-1] < jl[0]
    assert teng.global_steps == jeng.global_steps == 5
    assert teng.get_lr() == pytest.approx(jeng.get_lr(), rel=1e-12)


def test_train_batch_equals_forward_backward_step():
    params = _jax_params()
    cfg_one = _config(gradient_accumulation_steps=1, train_batch_size=4)
    a, b = (tds.initialize(
        model=GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.float32),
                              device="cpu", seed=None),
        model_parameters=_tree(params), config_params=cfg_one,
        device="cpu")[0] for _ in range(2))
    for i in range(3):
        ids = _batch(4, 20 + i)
        la = a.train_batch((ids, ids))
        lb = _micro(b, 20 + i)
        assert float(la) == lb
    for p, q in zip(a.module.parameters(), b.module.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_loads_across_packages(tmp_path, direction):
    """Two steps in one package, save; a fresh engine of the other package
    loads it; the next step's loss matches the saver's own next step."""
    params = _jax_params()
    src, dst = (_jax_engine(params), _port_engine(params))
    if direction == "port_to_jax":
        src, dst = dst, src
    for i in range(4):
        _micro(src, i)
    src.save_checkpoint(str(tmp_path), tag="step2")
    assert (tmp_path / "latest").read_text() == "step2"
    assert (tmp_path / "step2" / "mp_rank_00_model_states.pt").exists()
    path, client = dst.load_checkpoint(str(tmp_path))
    assert path is not None and client == {}
    assert dst.global_steps == src.global_steps == 2
    assert dst.get_lr() == pytest.approx(src.get_lr(), rel=1e-12)
    want = [_micro(src, i) for i in range(4, 6)]
    got = [_micro(dst, i) for i in range(4, 6)]
    np.testing.assert_allclose(got, want, rtol=TOL)


@pytest.mark.parametrize("name", ["SimpleModel", "LinearStack",
                                  "PLD_SimpleModel", "DenseRelu",
                                  "DenseOut"])
def test_simple_models_forward_and_grads_match_jax(name):
    """The runtime tests' models: the same flax weights (through the
    engine's loader, ``load_flax_tree``) and numpy inputs give the JAX
    module's output, and the loss models' gradients, within TOL."""
    rng = np.random.RandomState(7)
    x = rng.randn(4, 8).astype(np.float32)
    y = rng.randint(0, 8, size=(4,))
    jmod, tmod, args, kwargs = {
        "SimpleModel": (jsimple.SimpleModel(hidden_dim=8),
                        tsimple.SimpleModel(8, device="cpu"), (x, y), {}),
        "LinearStack": (jsimple.LinearStack(8, 6, 8, 2),
                        tsimple.LinearStack(8, 6, 8, 2, device="cpu"),
                        (x, y), {}),
        "PLD_SimpleModel": (jsimple.PLD_SimpleModel(hidden_dim=8),
                            tsimple.PLD_SimpleModel(8, device="cpu"),
                            (x, y), {"progressive_layer_drop": True,
                                     "pld_theta": 0.5}),
        "DenseRelu": (jsimple.DenseRelu(6), tsimple.DenseRelu(
            6, in_features=8, device="cpu"), (x,), {}),
        "DenseOut": (jsimple.DenseOut(5), tsimple.DenseOut(
            5, in_features=8, device="cpu"), (x,), {}),
    }[name]
    params = _tree(jmod.init(jax.random.PRNGKey(1), *args, **kwargs)[
        "params"])
    tutils.load_flax_tree(tmod, params)
    tmod.requires_grad_(True)
    want = jmod.apply({"params": params}, *args, **kwargs)
    got = tmod(*(torch.from_numpy(np.asarray(a)) for a in args), **kwargs)
    _close(got.detach().numpy(), want)
    if want.ndim:
        return
    jgrads = jax.grad(lambda p: jmod.apply({"params": p}, *args,
                                           **kwargs))(params)
    got.backward()
    flat = _flat(_tree(jgrads))
    assert set(flat) == {n for n, _ in tmod.named_parameters()}
    for n, p in tmod.named_parameters():
        _close(p.grad.numpy(), flat[n])
    assert tsimple.ce_loss(torch.from_numpy(x), torch.from_numpy(y)).item() \
        == pytest.approx(float(jsimple.ce_loss(jnp.asarray(x),
                                               jnp.asarray(y))), rel=TOL)
