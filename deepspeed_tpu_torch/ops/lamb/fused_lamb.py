"""FusedLamb: LAMB with per-tensor trust ratios on the device.

Counterpart of ``deepspeed_tpu/ops/lamb/fused_lamb.py`` (an XLA update in
the JAX package, not a Pallas kernel). ``lamb_update`` runs the moment
update with PyTorch's multi-tensor ``torch._foreach_*`` ops, then per
tensor the weight and update norms and the trust-ratio-scaled step, all on
the parameters' device with no host sync, in place (the JAX function
returns new trees):

    m = b1 m + (1-b1) g;  v = b2 v + (1-b2) g^2
    u = (m / bc1) / (sqrt(v / bc2) + eps) [+ wd p]
    r = clip(||p|| / ||u||, min_coeff, max_coeff), 1 where a norm is 0
    p -= lr r u

``FusedLamb`` has ``FusedAdam``'s interface (``param_groups``,
``init_state``, ``update``), so the engine drives either. Over ranks that
each hold a shard of a tensor the engine sets ``norm_reduce``: the per
tensor [||p||^2, ||u||^2] of the rank's shards, added over the ranks that
share each tensor, so the ratio is the whole tensor's.
"""

import torch

from deepspeed_tpu_torch.ops.adam.fused_adam import init_adam_state


def init_lamb_state(params):
    """Zero moments (fp32) and a step counter: Adam's layout."""
    return init_adam_state(params)


def lamb_update(params, grads, state, lr, beta1=0.9, beta2=0.999, eps=1e-8,
                weight_decay=0.0, bias_correction=True, max_coeff=10.0,
                min_coeff=0.01, norm_reduce=None):
    """One LAMB step over aligned lists ``params`` and ``grads``, updating
    ``params`` and ``state`` in place (module docstring). ``norm_reduce``
    maps the tensors' [n, 2] sums of squares to the whole tensors'."""
    if not params:
        return
    state["step"] += 1
    step = state["step"]
    f32 = torch.float32
    dev = params[0].device
    # bc in fp32, as the JAX function raises fp32 betas to an fp32 step.
    step_f = torch.tensor(float(step), dtype=f32)
    bc1 = 1.0 - torch.tensor(beta1, dtype=f32) ** step_f \
        if bias_correction else torch.tensor(1.0, dtype=f32)
    bc2 = 1.0 - torch.tensor(beta2, dtype=f32) ** step_f \
        if bias_correction else torch.tensor(1.0, dtype=f32)
    m, v = state["exp_avg"], state["exp_avg_sq"]
    grads = [g.float() for g in grads]
    p32 = [p.float() for p in params]
    torch._foreach_mul_(m, beta1)
    torch._foreach_add_(m, grads, alpha=1.0 - beta1)
    torch._foreach_mul_(v, beta2)
    torch._foreach_addcmul_(v, grads, grads, value=1.0 - beta2)
    denom = torch._foreach_div(v, bc2.to(dev))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(m, bc1.to(dev))
    torch._foreach_div_(update, denom)
    if weight_decay != 0.0:
        torch._foreach_add_(update, p32, alpha=weight_decay)
    w_norm = torch.stack(torch._foreach_norm(p32))
    u_norm = torch.stack(torch._foreach_norm(update))
    if norm_reduce is not None:
        sq = norm_reduce(torch.stack([w_norm, u_norm], dim=1).square())
        w_norm, u_norm = sq[:, 0].sqrt(), sq[:, 1].sqrt()
    ratio = torch.where((w_norm > 0) & (u_norm > 0),
                        torch.clamp(w_norm / u_norm, min_coeff, max_coeff),
                        torch.ones_like(w_norm))
    for p, p_f, u, r in zip(params, p32, update, ratio.unbind()):
        p.copy_(p_f - lr * r * u)


class FusedLamb(object):
    """LAMB with ``param_groups`` (one group), matching the JAX package's
    ``FusedLamb``: the engine owns the moments (``init_state``) and calls
    ``update`` at each step."""

    def __init__(self, params=None, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, eps_inside_sqrt=False,
                 weight_decay=0.0, max_grad_norm=0.0, max_coeff=10.0,
                 min_coeff=0.01, amsgrad=False):
        if amsgrad:
            raise RuntimeError("FusedLamb does not support the AMSGrad "
                               "variant.")
        self.bias_correction = bias_correction
        self.eps_inside_sqrt = eps_inside_sqrt
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff
        self.param_groups = [{"params": params, "lr": lr,
                              "betas": tuple(betas), "eps": eps,
                              "weight_decay": weight_decay,
                              "max_grad_norm": max_grad_norm}]
        self.defaults = dict(self.param_groups[0])
        self.state = {}
        self.norm_reduce = None

    def init_state(self, params):
        return init_lamb_state(params)

    def update(self, params, grads, state, lr=None, betas=None, eps=None,
               weight_decay=None):
        group = self.param_groups[0]
        beta1, beta2 = group["betas"] if betas is None else betas
        lamb_update(
            params, grads, state, lr=group["lr"] if lr is None else lr,
            beta1=beta1, beta2=beta2,
            eps=group["eps"] if eps is None else eps,
            weight_decay=group["weight_decay"]
            if weight_decay is None else weight_decay,
            bias_correction=self.bias_correction, max_coeff=self.max_coeff,
            min_coeff=self.min_coeff, norm_reduce=self.norm_reduce)

    def state_dict(self):
        return {"param_groups": [
            {k: v for k, v in g.items() if k != "params"}
            for g in self.param_groups]}

    def load_state_dict(self, sd):
        for group, saved in zip(self.param_groups, sd.get("param_groups", [])):
            group.update(saved)
