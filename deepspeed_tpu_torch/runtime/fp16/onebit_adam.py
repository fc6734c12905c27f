"""1-bit Adam: Adam whose momentum is exchanged 1-bit compressed.

Counterpart of ``deepspeed_tpu/runtime/fp16/onebit_adam.py`` (the
reference's OnebitAdam). Two phases split at ``freeze_step``:

- warm-up: Adam without bias correction, on gradients the engine averaged
  densely over the data ranks;
- compression: the second moment is frozen; each rank adds its LOCAL
  gradient into its momentum, and the momenta are averaged by
  ``custom_collectives.compressed_allreduce_many`` (all leaves in one
  exchange, each padded by ``corrected_size`` and compensated by its own
  worker and server error buffers). The engine then runs no dense gradient
  all-reduce (``notify_step`` clears its ``enable_backward_allreduce``).

With a data group (``group``, set by the engine on its pure data-parallel
path) the phase is the host flag ``adam_freeze_key``, as on the JAX
package's shard_map path. Without one (one rank, or an engine whose
gradients arrive averaged) the phase follows the step count and the
exchange degenerates to ``quantize_error_feedback``, as in JAX.

The state is the engine's: ``init_state`` returns {"step", "exp_avg",
"exp_avg_sq", "worker_error", "server_error"} as lists over the
parameters; a rank's error buffers are its row of the JAX layout
(``[W, padded]`` and ``[W, padded / W]``, which the engine gathers into
checkpoints). ``update`` works in place.
"""

import torch

from deepspeed_tpu_torch.runtime.custom_collectives import (
    compressed_allreduce_many, corrected_size, quantize_error_feedback)
from deepspeed_tpu_torch.utils.logging import logger


def init_onebit_adam_state(params, world_size=1):
    """Zero moments, a step counter, and per-parameter error buffers:
    worker ``[corrected_size(n, W)]``, server ``[padded / W]``."""
    def zeros(n, p):
        return torch.zeros(n, dtype=torch.float32, device=p.device)

    padded = [corrected_size(p.numel(), world_size) for p in params]
    return {
        "step": 0,
        "exp_avg": [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in params],
        "exp_avg_sq": [torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for p in params],
        "worker_error": [zeros(n, p) for n, p in zip(padded, params)],
        "server_error": [zeros(n // world_size, p)
                         for n, p in zip(padded, params)],
    }


class OnebitAdam(object):
    """The optimizer (module docstring), with the engine's optimizer
    protocol: ``param_groups``, ``init_state``, ``update``, ``state_dict``,
    ``load_state_dict``."""

    def __init__(self, params=None, deepspeed=None, lr=1e-3,
                 freeze_step=100000, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-8, eps_inside_sqrt=False, weight_decay=0.0,
                 max_grad_norm=0.0, amsgrad=False, cuda_aware=False,
                 world_size=None, group=None):
        if amsgrad:
            raise RuntimeError("1-bit Adam does not support the AMSGrad "
                               "variant.")
        self.deepspeed = deepspeed
        self.freeze_step = int(freeze_step)
        self.adam_freeze_key = False
        if world_size is None:
            world_size = getattr(deepspeed, "dp_world_size", 1) \
                if deepspeed is not None else 1
        self.world_size = max(int(world_size), 1)
        self.group = group
        self.param_groups = [{"params": params, "lr": lr,
                              "betas": tuple(betas), "eps": eps,
                              "weight_decay": weight_decay,
                              "bias_correction": bias_correction,
                              "max_grad_norm": max_grad_norm}]

    def init_state(self, params):
        return init_onebit_adam_state(params, self.world_size)

    @torch.no_grad()
    def update(self, params, grads, state, lr=None, betas=None, eps=None,
               weight_decay=None):
        """One step over aligned ``params`` and ``grads`` (in place)."""
        group = self.param_groups[0]
        lr = group["lr"] if lr is None else lr
        beta1, beta2 = group["betas"] if betas is None else betas
        eps = group["eps"] if eps is None else eps
        wd = group["weight_decay"] if weight_decay is None else weight_decay
        state["step"] += 1
        frozen = self.adam_freeze_key if self.group is not None else \
            state["step"] > self.freeze_step
        grads = [g.float() for g in grads]
        m, v = state["exp_avg"], state["exp_avg_sq"]
        torch._foreach_mul_(m, beta1)
        torch._foreach_add_(m, grads, alpha=1.0 - beta1)
        if not frozen:
            torch._foreach_mul_(v, beta2)
            torch._foreach_addcmul_(v, grads, grads, value=1.0 - beta2)
        else:
            self._exchange(m, state)
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, eps)
        upd = torch._foreach_div(m, denom)
        if wd != 0.0:
            torch._foreach_add_(upd, params, alpha=wd)
        torch._foreach_add_(params, upd, alpha=-lr)

    def _exchange(self, m, state):
        """The momenta, padded, through the compressed exchange over the
        data group (or quantized alone); written back into ``m``."""
        we, se = state["worker_error"], state["server_error"]
        flats = []
        for mi, e in zip(m, we):
            flat = torch.zeros(e.shape, dtype=torch.float32, device=e.device)
            flat[:mi.numel()] = mi.reshape(-1)
            flats.append(flat)
        if self.group is not None:
            outs, new_we, new_se = compressed_allreduce_many(flats, we, se,
                                                             self.group)
            for s, n in zip(se, new_se):
                s.copy_(n)
        else:
            outs, new_we = zip(*[quantize_error_feedback(f, e)
                                 for f, e in zip(flats, we)])
        for e, n in zip(we, new_we):
            e.copy_(n)
        for mi, out in zip(m, outs):
            mi.copy_(out[:mi.numel()].view_as(mi))

    def notify_step(self, global_step):
        """Past ``freeze_step`` the compression phase starts and the
        engine's dense gradient all-reduce stops."""
        if not self.adam_freeze_key and global_step >= self.freeze_step:
            self.adam_freeze_key = True
            if self.deepspeed is not None:
                self.deepspeed.enable_backward_allreduce = False
            logger.info("OnebitAdam: entering compression phase at step %d",
                        global_step)

    def state_dict(self):
        return {"param_groups": [
            {k: v for k, v in g.items() if k != "params"}
            for g in self.param_groups],
            "adam_freeze_key": self.adam_freeze_key}

    def load_state_dict(self, sd):
        """The groups and the phase, both ways: a checkpoint past the
        freeze resumes compressed, one before it re-enters warm-up (and the
        engine's dense all-reduce)."""
        for group, saved in zip(self.param_groups, sd.get("param_groups", [])):
            group.update(saved)
        if "adam_freeze_key" in sd:
            self.adam_freeze_key = bool(sd["adam_freeze_key"])
            if self.deepspeed is not None:
                self.deepspeed.enable_backward_allreduce = \
                    not self.adam_freeze_key
