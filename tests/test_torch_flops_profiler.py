"""The port's flops profiler, on the CPU, against the analytic matrix flops
and the JAX package's profiler.

The JAX profiler's tests, ported: ``get_model_profile``, ``observe``'s
accumulation, two programs under one name kept apart, the engine's
``flops_profiler`` block and the printed profile. The port measures
(``FlopCounterMode``), so its counts are held to the analytic matrix-product
flops exactly: a two-layer MLP, ``x @ x``, SimpleModel's training step
(forward and the weight gradient) and a tiny GPT-2's forward. Parameter
counts equal the JAX profiler's. The module breakdown sums to the total.
On the card the training kernels charge their plain versions' operators
(``kernels/costing.py``); here each charge, run on meta tensors, is held
to the count of the plain version on CPU tensors, flops and bytes exactly.
"""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models.simple import SimpleModel as JSimpleModel
from deepspeed_tpu.profiling.flops_profiler import (
    get_model_profile as jget_model_profile)
from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.models.simple import SimpleModel
from deepspeed_tpu_torch.profiling.flops_profiler import (FlopsProfiler,
                                                          get_model_profile)
from deepspeed_tpu_torch.telemetry.xray import CostWindow

torch.set_num_threads(1)


class MLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(32, 64)
        self.fc2 = nn.Linear(64, 10)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def test_get_model_profile_dense():
    class JMLP(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Dense(10)(fnn.relu(fnn.Dense(64)(x)))

    x = np.ones((4, 32), np.float32)
    flops, params = get_model_profile(MLP(), args=(torch.from_numpy(x),),
                                      as_string=False, print_profile=False)
    _, jparams = jget_model_profile(JMLP(), args=(jnp.asarray(x),),
                                    as_string=False, print_profile=False)
    assert params == jparams == 32 * 64 + 64 + 64 * 10 + 10
    assert flops == 2 * 4 * (32 * 64 + 64 * 10)


def test_profiler_observe_accumulates():
    prof = FlopsProfiler()
    prof.start_profile()

    def f(x):
        return x @ x

    x = torch.ones(64, 64)
    prof.observe(f, x)
    prof.observe(f, x)
    assert prof.get_total_steps() == 2
    assert prof.get_total_flops() == 2 * 2 * 64 ** 3
    prof.stop_profile()
    assert prof.get_total_duration() > 0
    s = prof.get_total_flops(as_string=True)
    assert s == "1.05 M"
    prof.end_profile()
    assert prof.get_total_flops() == 0 and prof.get_total_steps() == 0


def test_distinct_programs_with_same_name_keep_distinct_records():
    """Two programs named '<lambda>' with same-shaped inputs keep two
    records, each with its own flops."""
    prof = FlopsProfiler()
    prof.start_profile()
    f1 = lambda a: a @ a  # noqa: E731
    f2 = lambda a: torch.tanh(a @ a) @ a  # noqa: E731
    x = torch.ones(32, 32)
    prof.observe(f1, x)
    assert prof.get_total_flops() == 2 * 32 ** 3
    prof.observe(f2, x)
    assert prof.get_total_steps() == 2
    assert prof.get_total_flops() == 3 * 2 * 32 ** 3
    assert prof._xray.record_count() == 2
    recs = prof._xray.to_json()["programs"]
    assert len({r["fingerprint"] for r in recs}) == 2


def _engine_config(start, end):
    return {"train_batch_size": 8,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "flops_profiler": {"enabled": True, "start_step": start,
                               "end_step": end, "top_modules": 2}}


def test_engine_profiler_hook(capsys):
    """The block starts the profiler at the forward of step ``start_step``
    and stops it after step ``end_step``: steps 1 and 2 of 4, each its
    forward and weight gradient (2 * 8 * 8 * 8 flops each), as in the JAX
    engine, whose profiler also ends stopped."""
    engine, _, _, _ = tds.initialize(
        model=SimpleModel(hidden_dim=8, device="cpu"), device="cpu",
        config_params=_engine_config(1, 2))
    jengine, _, _, _ = jds.initialize(model=JSimpleModel(hidden_dim=8),
                                      config_params=_engine_config(1, 2))
    rng = np.random.RandomState(0)
    x = rng.randn(8, 8).astype(np.float32)
    y = rng.randint(0, 8, size=(8,))
    started = []
    for _ in range(4):
        for eng in (engine, jengine):
            loss = eng(x, y)
            eng.backward(loss)
            eng.step()
        started.append(engine.flops_profiler is not None and
                       engine.flops_profiler.started)
    assert started == [False, True, False, False]
    assert not engine.flops_profiler.started
    assert not jengine.flops_profiler.started
    prof = engine.flops_profile
    assert prof["steps"] == 2
    assert prof["flops"] == 2 * (2 * 2 * 8 * 8 * 8)
    assert prof["params"] == 8 * 8 + 8
    assert "DeepSpeed Flops Profiler" in capsys.readouterr().out
    assert engine.flops_profiler.get_total_flops() == 0  # ended


def test_print_model_profile_contains_table():
    model = SimpleModel(hidden_dim=8, device="cpu")
    prof = FlopsProfiler(model)
    prof.start_profile()
    x, y = torch.ones(4, 8), torch.zeros(4, dtype=torch.long)
    prof.set_example_batch(x, y)
    with prof.window():
        model(x, y)
    out = prof.print_model_profile()
    assert "DeepSpeed Flops Profiler" in out
    assert "SimpleModel" in out and "SimpleModel.linear" in out
    assert prof.module_breakdown() == [("SimpleModel.linear", 2 * 4 * 64,
                                        72)]
    assert prof.module_breakdown(0) == [("SimpleModel", 2 * 4 * 64, 72)]


def test_gpt2_forward_flops_are_the_analytic_count_and_sum_by_module():
    cfg = GPT2Config.tiny(dtype=torch.float32)
    model = GPT2LMHeadModel(cfg, device="cpu")
    B, T, C, L, V = 2, 16, cfg.n_embd, cfg.n_layer, cfg.vocab_size
    ids = torch.zeros(B, T, dtype=torch.long)
    prof = FlopsProfiler(model)
    prof.start_profile()
    with prof.window():
        with torch.no_grad():
            model(ids)
    want = L * (24 * B * T * C * C + 4 * B * T * T * C) + 2 * B * T * C * V
    assert prof.get_total_flops() == want
    for depth in (-1, 0, 1, 2):
        rows = prof.module_breakdown(depth)
        assert sum(f for _, f, _ in rows) == want, depth
        assert all(f >= 0 for _, f, _ in rows)
    blocks = [f for n, f, _ in prof.module_breakdown(1) if ".h_" in n]
    assert blocks == [want / L - 2 * B * T * C * V / L] * L
    assert prof.get_total_params() == cfg.num_params()
    flops, params = get_model_profile(model, args=(ids,), as_string=False,
                                      print_profile=False, warm_up=0)
    assert (flops, params) == (want, cfg.num_params())


def test_gpt2_train_step_breakdown_sums_to_the_total():
    """A profiled training step of a tiny GPT-2 through the engine: its
    module rows sum to its total, which includes the backward."""
    cfg = GPT2Config.tiny(dtype=torch.float32)
    engine, _, _, _ = tds.initialize(
        model=GPT2LMHeadModel(cfg, device="cpu"), device="cpu",
        config_params=dict(_engine_config(0, 0), train_batch_size=2))
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, size=(2, 16))
    engine.train_batch((ids, ids))
    prof = engine.flops_profile
    B, T, C, L = 2, 16, cfg.n_embd, cfg.n_layer
    forward_blocks = L * (24 * B * T * C * C + 4 * B * T * T * C)
    assert prof["steps"] == 1 and prof["flops"] > 3 * forward_blocks
    assert sum(f for _, f, _ in prof["modules"]) == prof["flops"]


# The plain version of each kernel, the arguments it takes at a small
# shape, and the wrapper module whose charge is checked.
def _charge_cases():
    from deepspeed_tpu_torch.ops.sparse_attention import (
        FixedSparsityConfig, kernels as sk)
    from deepspeed_tpu_torch.ops.transformer.kernels import (
        attention, dropout, gelu, layer_norm, softmax)
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    q, k, v, do = (r(2, 4, 64, 16) for _ in range(4))
    lse, delta = r(2, 4, 64, 1), r(2, 4, 64, 1)
    mask = torch.zeros(2, 64)
    lowered = sk.lower(FixedSparsityConfig(num_heads=4, block=16)
                       .make_layout(64), 16)
    x, res, bias = r(8, 32), r(8, 32), r(32)
    return [
        ("K1", attention.mha_reference, (q, k, v, mask, True, 0.25),
         {"return_lse": True}),
        ("K2", attention.flash_bwd_reference,
         (q, k, v, mask, lse, delta, do, True, 0.25), {}),
        ("K7a", sk.sparse_fwd_reference, (q, k, v, lowered, 0.25, False,
                                          mask), {}),
        ("K7b", sk.sparse_bwd_reference, (q, k, v, lowered, lse, delta, do,
                                          0.25, False, mask), {}),
        ("K8", layer_norm.ln_fwd_reference, (x, bias, bias, bias, res), {}),
        ("K9", softmax.attn_softmax_reference, (r(2, 4, 8, 8), mask[:, :8],
                                                0.5, True), {}),
        ("K10a", dropout.dropout_reference, (x, 0.1, 7, bias, res), {}),
        ("K10b", dropout.dropout_bwd_reference, (x, 0.1, 7), {}),
        ("K11", gelu.bias_gelu_reference, (x, bias), {}),
    ]


@pytest.mark.parametrize("case", range(9))
def test_costing_charges_what_the_plain_versions_count(case):
    from deepspeed_tpu_torch.ops.transformer.kernels import costing
    name, plain, args, kwargs = _charge_cases()[case]
    with CostWindow() as on_cpu:
        plain(*args, **kwargs)
    with CostWindow() as charged:
        costing.charge(plain, *args, **kwargs)
    assert charged.cost == on_cpu.cost, name
    assert on_cpu.cost["bytes_accessed"] > 0
    with CostWindow() as hidden:
        with costing.hidden():
            plain(*args, **kwargs)
    assert hidden.cost["flops"] == hidden.cost["bytes_accessed"] == 0
    assert not costing.active()
    costing.charge(plain, *args, **kwargs)  # outside a window: nothing
