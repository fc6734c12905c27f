"""Mixture-of-Experts layer.

Counterpart of ``deepspeed_tpu/moe/layer.py`` (the DeepSpeed-MoE user
surface: construct with an expert factory, call on [B, T, C] hidden
states, get ``(output, l_aux, exp_counts)``):

- the experts are ONE stacked parameter set with a leading
  ``[num_experts]`` axis (``torch.func.stack_module_state``), run by
  ``torch.vmap`` over ``functional_call`` of one expert module, so an
  optimizer or a checkpoint sees one tensor per weight;
- routing is fixed-shape capacity-based dense arithmetic
  (``sharded_moe``): no host sync, no data-dependent shape.

Expert parallelism (the experts' axis sharded over a mesh's 'model' axis)
is ROADMAP Queue 1 item 16: on one card every expert lives on the card.
"""

import copy

import torch
import torch.nn as nn
from torch.func import functional_call, stack_module_state

from deepspeed_tpu_torch.moe.sharded_moe import top1gating, top2gating


class Experts(nn.Module):
    """``num_experts`` stacked copies of the module ``expert()`` builds:
    every parameter gets a leading expert axis. ``forward(x)`` takes [E,
    cap, C], one row of tokens per expert."""

    def __init__(self, expert, num_experts):
        super().__init__()
        mods = [expert() for _ in range(num_experts)]
        params, buffers = stack_module_state(mods)
        self.num_experts = int(num_experts)
        self._names = sorted(params)
        # ParameterDict keys cannot hold dots.
        self.stacked = nn.ParameterDict({
            name.replace(".", "__"): nn.Parameter(params[name])
            for name in self._names})
        self._buffers_stacked = buffers
        # The stateless template functional_call runs (its own tensors
        # are never read).
        self._template = [copy.deepcopy(mods[0]).to("meta")]

    def stacked_params(self):
        """{dotted name: [E, ...] tensor}, the expert module's names."""
        return {name: self.stacked[name.replace(".", "__")]
                for name in self._names}

    def forward(self, x):
        template = self._template[0]

        def one(params, buffers, xi):
            return functional_call(template, (params, buffers), (xi,))

        return torch.vmap(one)(self.stacked_params(), self._buffers_stacked,
                               x)


class MoE(nn.Module):
    """Sparsely-gated mixture-of-experts block (the JAX ``MoE``'s
    arguments): ``hidden_size``, ``expert`` (a zero-argument factory of
    the expert ``nn.Module``), ``num_experts``, ``k`` (1 or 2),
    ``capacity_factor`` / ``eval_capacity_factor``, ``min_capacity``,
    ``noisy_gate_policy`` (None or 'Jitter').

    ``out, l_aux, exp_counts = moe(x, deterministic=None, generator=None)``
    with x [B, T, C]. ``deterministic`` None follows ``self.training``
    (the torch idiom for the JAX rng-stream inference); training uses
    ``capacity_factor`` and, under 'Jitter', draws its noise from
    ``generator`` (a ``torch.Generator``, the JAX ``noise_rng``). Tokens
    dropped by capacity contribute 0 (the residual carries them)."""

    def __init__(self, hidden_size, expert, num_experts=1, k=1,
                 capacity_factor=1.25, eval_capacity_factor=2.0,
                 min_capacity=4, noisy_gate_policy=None):
        super().__init__()
        if k not in (1, 2):
            raise ValueError("MoE k must be 1 or 2, got {}".format(k))
        if noisy_gate_policy not in (None, "Jitter"):
            raise ValueError("noisy_gate_policy must be None or 'Jitter', "
                             "got {!r}".format(noisy_gate_policy))
        self.hidden_size = int(hidden_size)
        self.num_experts = int(num_experts)
        self.k = int(k)
        self.capacity_factor = float(capacity_factor)
        self.eval_capacity_factor = float(eval_capacity_factor)
        self.min_capacity = int(min_capacity)
        self.noisy_gate_policy = noisy_gate_policy
        # The router, fp32, flax layout [C, E] and no bias (JAX "gate").
        self.gate_kernel = nn.Parameter(
            torch.randn(self.hidden_size, self.num_experts) * 0.02)
        self.experts = Experts(expert, num_experts)

    def forward(self, x, deterministic=None, generator=None):
        if deterministic is None:
            deterministic = not self.training
        b, t, c = x.shape
        tokens = x.reshape(b * t, c)
        logits = tokens.float() @ self.gate_kernel.float()
        noise = None
        if self.noisy_gate_policy == "Jitter" and not deterministic:
            if generator is None:
                raise ValueError("MoE: the Jitter policy trains with a "
                                 "generator (the JAX noise_rng)")
            noise = generator
        factor = self.eval_capacity_factor if deterministic \
            else self.capacity_factor
        gate = top1gating if self.k == 1 else top2gating
        l_aux, combine, dispatch, exp_counts = gate(
            logits, capacity_factor=factor, min_capacity=self.min_capacity,
            noise_rng=noise)
        dispatched = torch.einsum("sec,sm->ecm", dispatch.to(x.dtype),
                                  tokens)
        expert_out = self.experts(dispatched)
        out = torch.einsum("sec,ecm->sm", combine.to(x.dtype),
                           expert_out.to(x.dtype))
        return out.reshape(b, t, -1), l_aux, exp_counts
