"""Port parity: MoE experts over a mesh's 'model' axis.

- Serving: the MoE adapter over dp 2 x mp 2 gloo ranks on the CPU (the
  port's launcher, ``tests/torch_dist_worker.py``) gives the JAX
  engine's greedy tokens (JAX ``test_moe_expert_parallel_two_axis_mesh``)
  with E/mp experts a rank, and every expert on each rank under
  ``expert_parallel=False`` (JAX
  ``test_moe_no_expert_parallel_flag_replicates_experts``); the
  ``moe_*`` gauges are one process's on every rank.
- The expert stacks' shards (JAX ``test_expert_params_shard_over_model_axis``
  at mp 4 x dp 2): each model rank holds E/4 experts, the router whole.
- The experts' rule wins over the Megatron rules (JAX
  ``test_expert_rule_wins_over_megatron_rules``).
"""

import pytest
import torch

from deepspeed_tpu.inference import InferenceEngine as JEngine
from deepspeed_tpu.parallel import mesh as jmesh
from tests.test_torch_adapters import ENGINE, MOE, adapter_of, ids_of
from tests.test_torch_moe import _layer
from tests.torch_dist_worker import start_ranks, wait_ranks

from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.parallel import mesh as tmesh
from deepspeed_tpu_torch.parallel.tensor_parallel import (TPContext,
                                                          apply_rules)

torch.set_num_threads(1)

MAX_NEW = 6


def _prompts():
    return [ids_of(MOE["vocab_size"], n, seed=n)[0] for n in (5, 8, 6)]


def _gauges(snap):
    return {k: v for k, v in snap.items() if "moe" in k}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_mesh")
    _, (ja, jp, tree), _ = adapter_of("moe")
    proc = start_ranks(4, [{
        "name": "serve", "kind": "serve", "mp": 2, "params": tree,
        "prompts": _prompts(), "max_new": MAX_NEW,
        "cases": [{"name": "ep", "config": ENGINE, "moe": MOE},
                  {"name": "no_ep", "moe": MOE,
                   "config": dict(ENGINE, expert_parallel=False)}]}],
        str(root / "w4"))
    jeng = JEngine(None, jp, config=dict(ENGINE, use_flash_decode=False),
                   adapter=ja)
    reqs = [jeng.submit(p, max_new_tokens=MAX_NEW) for p in _prompts()]
    jeng.run()
    want = [list(map(int, r.tokens)) for r in reqs]
    one = InferenceEngine(None, tree, config=ENGINE, device="cpu",
                          adapter=adapter_of("moe")[0][0])
    for p in _prompts():
        one.submit(p, max_new_tokens=MAX_NEW)
    one.run()
    return {"want": want, "one": _gauges(one.telemetry.snapshot()),
            "ranks": [r["serve"] for r in wait_ranks(proc, timeout=240)]}


@pytest.mark.parametrize("case", ["ep", "no_ep"])
def test_moe_over_dp2_mp2_equals_the_jax_engine(runs, case):
    for r in runs["ranks"]:
        got = r[case]
        assert got["raised"] is None
        assert got["tokens"] == runs["want"], (case, r["mp_rank"],
                                               r["dp_rank"])


@pytest.mark.parametrize("case,experts", [("ep", 2), ("no_ep", 4)])
def test_experts_a_rank(runs, case, experts):
    """E/mp experts a rank with expert parallelism, all E without; the
    attention's heads split either way (one of two a rank)."""
    for r in runs["ranks"]:
        got = r[case]
        assert got["expert_shape"] == (experts, MOE["n_embd"],
                                       4 * MOE["n_embd"])
        assert got["k_shape"][2] == MOE["n_head"] // 2


@pytest.mark.parametrize("case", ["ep", "no_ep"])
def test_moe_gauges_are_whole_model_counts(runs, case):
    """Routing is replicated, so each rank's ``moe_expert_load``, routed
    and dropped counts are one process's."""
    for r in runs["ranks"]:
        assert r[case]["moe"] == runs["one"]


@pytest.mark.parametrize("rank", range(4))
def test_expert_params_shard_over_model_axis(rank):
    """mp 4 (x dp 2): each model rank holds num_experts / 4 experts'
    stacks, split (computed by the layer), the router whole."""
    layer = _layer(num_experts=8)
    full = {n: p.detach().clone() for n, p in layer.named_parameters()}
    layout = apply_rules(layer, TPContext(None, 4, rank))
    assert layer.tp is not None and layer.tp.rank == rank
    for i, (name, p) in enumerate(layer.named_parameters()):
        if ".experts." in "." + name:
            assert layout.kinds[i] == "split"
            assert p.shape[0] == full[name].shape[0] // 4
            torch.testing.assert_close(p, full[name][2 * rank:2 * rank + 2],
                                       rtol=0, atol=0)
        else:
            assert tuple(p.shape) == tuple(full[name].shape)


def test_expert_rule_wins_over_megatron_rules():
    """A stacked expert whose inner path matches a Megatron rule (the
    expert is the model's own mlp) shards its leading expert axis: first
    match wins."""
    assert tmesh._tp_dim("experts/mlp/c_fc/kernel", (8, 16, 64),
                         tmesh.DEFAULT_TP_RULES, 4) == 0
    assert tmesh._tp_dim("h_0/mlp/c_fc/kernel", (16, 64),
                         tmesh.DEFAULT_TP_RULES, 4) == 1
    # The JAX rule table is the port's.
    assert tmesh.DEFAULT_TP_RULES == tuple(jmesh.DEFAULT_TP_RULES)
