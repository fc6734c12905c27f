"""Mixture-of-Experts layer.

Counterpart of ``deepspeed_tpu/moe/layer.py`` (the DeepSpeed-MoE user
surface: construct with an expert factory, call on [B, T, C] hidden
states, get ``(output, l_aux, exp_counts)``):

- the experts are ONE stacked parameter set with a leading
  ``[num_experts]`` axis (``torch.func.stack_module_state``), run by
  ``torch.vmap`` over ``functional_call`` of one expert module, so an
  optimizer or a checkpoint sees one tensor per weight; the parameters
  carry the flax names of the JAX layer (``gate.kernel``,
  ``experts.<Expert>_0.<the expert's own names>``), so a JAX tree loads
  as it is (``runtime.utils.load_flax_tree``) and checkpoints hold JAX's
  full ``[E, ...]`` leaves;
- routing is fixed-shape capacity-based dense arithmetic
  (``sharded_moe``): no host sync, no data-dependent shape.

Over ranks (the training engine sets both):

- DATA: ``set_data_parallel(group, generator)`` gates over the data
  line's global batch (``sharded_moe.gather_rows``: the logits gathered
  in rank order, gated whole, the rank's rows kept), and draws the
  'Jitter' noise from ``generator``, seeded alike on every data rank: one
  global draw, as the JAX program's one ``noise_rng``.
- MODEL: EXPERT PARALLELISM is the first of ``DEFAULT_TP_RULES`` (the
  stacks' expert axis over 'model'). The JAX layer lets GSPMD derive the
  token all-to-alls; here the tokens are replicated over the model ranks
  (as in the port's tensor parallelism), so none is needed.
  ``tensor_parallel_leaves`` offers the stacks split on dim 0 and
  ``set_tensor_parallel`` makes the layer compute with its E/mp experts:
  the router runs replicated on the same fp32 logits (the same routing,
  ``exp_counts`` and ``l_aux`` on every model rank), the rank dispatches
  to its own experts, combines their outputs and sums the partial over
  the model group (``reduce_from_model``). The tokens it dispatches and
  the per-expert combine weights that carry the gate enter through
  ``copy_to_model``, so the router's and the input's gradients are whole
  on every rank.
"""

import copy

import torch
import torch.nn as nn
from torch.func import functional_call, stack_module_state

from deepspeed_tpu_torch.moe.sharded_moe import (gather_rows, top1gating,
                                                 top2gating)
from deepspeed_tpu_torch.parallel.tensor_parallel import (copy_to_model,
                                                          reduce_from_model)


class Experts(nn.Module):
    """``num_experts`` stacked copies of the module ``expert()`` builds:
    every parameter gets a leading expert axis, under the expert module's
    own names inside a child named as flax names it (class name + ``_0``).
    ``forward(x)`` takes [E, cap, C], one row of tokens per expert (E/mp
    of them on a model rank)."""

    def __init__(self, expert, num_experts):
        super().__init__()
        mods = [expert() for _ in range(num_experts)]
        params, buffers = stack_module_state(mods)
        self.num_experts = int(num_experts)
        self._names = sorted(params)
        # The stacks, under the expert's own module tree.
        holder = copy.deepcopy(mods[0])
        for name in self._names:
            *path, leaf = name.split(".")
            owner = holder.get_submodule(".".join(path))
            delattr(owner, leaf)
            owner.register_parameter(leaf, nn.Parameter(params[name]))
        self.add_module(type(mods[0]).__name__ + "_0", holder)
        self._holder = type(mods[0]).__name__ + "_0"
        self._buffers_stacked = buffers
        # The stateless template functional_call runs (its own tensors
        # are never read).
        self._template = [copy.deepcopy(mods[0]).to("meta")]

    def stacked_params(self):
        """{dotted name: [E, ...] tensor}, the expert module's names."""
        holder = getattr(self, self._holder)
        out = {}
        for name in self._names:
            # getattr, not get_parameter: under torch.func.functional_call
            # (the engine's cast copies) the leaves are plain tensors.
            *path, leaf = name.split(".")
            out[name] = getattr(holder.get_submodule(".".join(path)), leaf)
        return out

    def forward(self, x):
        template = self._template[0]

        def one(params, buffers, xi):
            return functional_call(template, (params, buffers), (xi,))

        return torch.vmap(one)(self.stacked_params(), self._buffers_stacked,
                               x)


class _Gate(nn.Module):
    """The router: flax ``nn.Dense(E, use_bias=False)``, fp32 [C, E]."""

    def __init__(self, hidden_size, num_experts):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.randn(hidden_size, num_experts) * 0.02)


class MoE(nn.Module):
    """Sparsely-gated mixture-of-experts block (the JAX ``MoE``'s
    arguments): ``hidden_size``, ``expert`` (a zero-argument factory of
    the expert ``nn.Module``), ``num_experts``, ``k`` (1 or 2),
    ``capacity_factor`` / ``eval_capacity_factor``, ``min_capacity``,
    ``noisy_gate_policy`` (None or 'Jitter').

    ``out, l_aux, exp_counts = moe(x, deterministic=None, generator=None)``
    with x [B, T, C]. ``deterministic`` None follows ``self.training``
    (the torch idiom for the JAX rng-stream inference); training uses
    ``capacity_factor`` and, under 'Jitter', draws its noise from the
    data-parallel generator (``set_data_parallel``) or else ``generator``
    (a ``torch.Generator``, the JAX ``noise_rng``). Tokens dropped by
    capacity contribute 0 (the residual carries them)."""

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
        self.gate = _Gate(self.hidden_size, self.num_experts)
        self.experts = Experts(expert, num_experts)
        self.tp = None
        self._dp_group = None
        self._noise = None

    def tensor_parallel_leaves(self, mp):
        """The expert stacks, split on their expert axis (the tensor-
        parallel protocol, ``parallel/tensor_parallel.py``)."""
        return {"experts.{}.{}".format(self.experts._holder, name): (0, None)
                for name in self.experts._names}

    def set_tensor_parallel(self, tp):
        self.tp = tp

    def set_data_parallel(self, group, generator=None):
        """Gate over ``group``'s global batch (None: this rank's batch is
        the batch) and draw the Jitter noise from ``generator``."""
        self._dp_group = group
        self._noise = generator

    def forward(self, x, deterministic=None, generator=None):
        if deterministic is None:
            deterministic = not self.training
        b, t, c = x.shape
        s = b * t
        tokens = x.reshape(s, c)
        logits = tokens.float() @ self.gate.kernel.float()
        group = self._dp_group
        if group is not None:
            logits = gather_rows(logits, group)
        noise = None
        if self.noisy_gate_policy == "Jitter" and not deterministic:
            noise = self._noise if self._noise is not None else generator
            if noise is None:
                raise ValueError("MoE: the Jitter policy trains with a "
                                 "generator (the JAX noise_rng)")
        factor = self.eval_capacity_factor if deterministic \
            else self.capacity_factor
        gate = top1gating if self.k == 1 else top2gating
        l_aux, combine, dispatch, exp_counts = gate(
            logits, capacity_factor=factor, min_capacity=self.min_capacity,
            noise_rng=noise)
        if group is not None:
            mine = torch.distributed.get_rank(group) * s
            combine, dispatch = combine[mine:mine + s], dispatch[mine:mine + s]
        tp = self.tp
        if tp is not None:
            # This rank's experts (module docstring). A token sits in at
            # most one slot of an expert, so the per-expert weight times
            # the dispatch mask is the combine tensor, bit for bit.
            per = self.num_experts // tp.size
            lo = tp.rank * per
            weight = copy_to_model(combine.sum(dim=2), tp)[:, lo:lo + per]
            dispatch = dispatch[:, lo:lo + per]
            combine = weight[:, :, None] * dispatch.to(weight.dtype)
            tokens = copy_to_model(tokens, tp)
        dispatched = torch.einsum("sec,sm->ecm", dispatch.to(x.dtype),
                                  tokens)
        expert_out = self.experts(dispatched)
        out = torch.einsum("sec,ecm->sm", combine.to(x.dtype),
                           expert_out.to(x.dtype))
        if tp is not None:
            out = reduce_from_model(out, tp)
        return out.reshape(b, t, -1), l_aux, exp_counts
