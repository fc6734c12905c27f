"""FusedAdam: Adam/AdamW over a list of parameters.

Counterpart of ``deepspeed_tpu/ops/adam/fused_adam.py``. The JAX package
traces the whole update into one XLA program; here ``adam_update`` runs
PyTorch's multi-tensor ``torch._foreach_*`` ops over the parameter list,
and updates parameters and moments IN PLACE (JAX returns new trees).

The class carries torch-style ``param_groups`` (lr, betas, eps,
weight_decay) so the LR schedules and the engine read and write it as they
do in the JAX package.
"""

import torch


def init_adam_state(params):
    """Zero first and second moments (fp32) and a step counter for a list of
    parameters."""
    return {
        "step": 0,
        "exp_avg": [torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for p in params],
        "exp_avg_sq": [torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for p in params],
    }


def adam_update(params, grads, state, lr, beta1=0.9, beta2=0.999, eps=1e-8,
                weight_decay=0.0, adam_w_mode=True, bias_correction=True):
    """One Adam/AdamW step over aligned lists ``params`` and ``grads``,
    updating ``params`` and ``state`` in place.

    ``adam_w_mode=True``: decoupled weight decay (AdamW); False: L2 decay
    added to the gradient (classic Adam), as the JAX function computes:
    m = b1 m + (1-b1) g, v = b2 v + (1-b2) g^2,
    p -= lr * ((m / bc1) / (sqrt(v / bc2) + eps) [+ wd p])."""
    state["step"] += 1
    step = state["step"]
    bc1 = 1.0 - beta1 ** step if bias_correction else 1.0
    bc2 = 1.0 - beta2 ** step if bias_correction else 1.0
    m, v = state["exp_avg"], state["exp_avg_sq"]
    grads = [g.float() for g in grads]
    if not adam_w_mode and weight_decay != 0.0:
        grads = torch._foreach_add(grads, params, alpha=weight_decay)
    torch._foreach_mul_(m, beta1)
    torch._foreach_add_(m, grads, alpha=1.0 - beta1)
    torch._foreach_mul_(v, beta2)
    torch._foreach_addcmul_(v, grads, grads, value=1.0 - beta2)
    denom = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(m, bc1)
    torch._foreach_div_(update, denom)
    if adam_w_mode and weight_decay != 0.0:
        torch._foreach_add_(update, params, alpha=weight_decay)
    torch._foreach_add_(params, update, alpha=-lr)


class FusedAdam(object):
    """Adam/AdamW with ``param_groups`` (one group), matching the JAX
    package's ``FusedAdam``: the engine owns the moments (``init_state``)
    and calls ``update`` at each step."""

    def __init__(self, params=None, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, adam_w_mode=True,
                 weight_decay=0.0, amsgrad=False, set_grad_none=True):
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant.")
        # set_grad_none is accepted for ds_config compatibility: the engine
        # always sets gradients to None after a step.
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction
        self.param_groups = [{"params": params, "lr": lr,
                              "betas": tuple(betas), "eps": eps,
                              "weight_decay": weight_decay}]

    def init_state(self, params):
        return init_adam_state(params)

    def update(self, params, grads, state, lr=None, betas=None, eps=None,
               weight_decay=None):
        group = self.param_groups[0]
        beta1, beta2 = group["betas"] if betas is None else betas
        adam_update(params, grads, state,
                    lr=group["lr"] if lr is None else lr,
                    beta1=beta1, beta2=beta2,
                    eps=group["eps"] if eps is None else eps,
                    weight_decay=group["weight_decay"]
                    if weight_decay is None else weight_decay,
                    adam_w_mode=self.adam_w_mode,
                    bias_correction=self.bias_correction)

    def state_dict(self):
        return {"param_groups": [
            {k: v for k, v in g.items() if k != "params"}
            for g in self.param_groups]}

    def load_state_dict(self, sd):
        for group, saved in zip(self.param_groups, sd.get("param_groups", [])):
            group.update(saved)
