"""Small models whose forward output is the loss, for the runtime tests.

Counterpart of ``deepspeed_tpu/models/simple.py``: ``loss = engine(x, y);
engine.backward(loss); engine.step()`` works as in DeepSpeed's test loop.
Parameters keep the flax names and layouts (``linear.kernel [in, out]``,
``linear.bias``), so a flax parameter tree loads through the engine's
``model_parameters`` or ``runtime.utils.load_flax_tree`` (the weight
bridge). As flax's ``nn.Dense`` without a ``dtype``, a layer computes in
the promoted type of its input and its kernel: fp32 inputs keep an fp32
product when the engine hands it bf16 parameters, and the gradient is
rounded to the parameter's dtype on the way back.

Flax infers a layer's input width at init; here it is an argument: the
models' input width is ``hidden_dim`` (``SimpleModel``), ``input_dim``
(``LinearStack``) or ``in_features`` (the pipeline stages, default
``features``). Weights are drawn from a ``torch.Generator`` seeded with
``seed`` (N(0, 1/in) kernels, zero biases) on ``device`` (default ``cuda``;
``device="cpu"`` for the host).
"""

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.device import resolve_device


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel (+ bias)``, ``kernel [in, out]``."""

    def __init__(self, n_in, n_out, use_bias=True, device=None,
                 generator=None):
        super().__init__()
        kernel = torch.randn(n_in, n_out, generator=generator,
                             device=generator.device) * n_in ** -0.5
        self.kernel = nn.Parameter(kernel.to(device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(n_out, device=device),
                                 requires_grad=False) if use_bias else None

    def forward(self, x):
        dtype = torch.promote_types(x.dtype, self.kernel.dtype)
        y = x.to(dtype) @ self.kernel.to(dtype)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


def _generator(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _nll(h, y):
    """Mean cross-entropy of integer labels ``y`` under logits ``h``."""
    logp = F.log_softmax(h, dim=-1)
    return -logp.gather(-1, y.to(torch.int64)[..., None])[..., 0].mean()


class SimpleModel(nn.Module):
    """One Linear layer and the cross-entropy loss. ``empty_grad`` declares
    a second layer the loss never uses (flax creates no parameters for a
    declared, never-called layer, so neither does this)."""

    def __init__(self, hidden_dim, empty_grad=False, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.hidden_dim = hidden_dim
        self.empty_grad = empty_grad
        self.linear = Dense(hidden_dim, hidden_dim, device=device,
                            generator=_generator(seed))

    def forward(self, x, y, deterministic=True):
        return _nll(self.linear(x), y)


class LinearStack(nn.Module):
    """Input layer, ``num_layers`` equal layers, output layer (no biases)
    and the cross-entropy loss: the serial twin of the pipeline stack."""

    def __init__(self, input_dim=128, hidden_dim=128, output_dim=128,
                 num_layers=4, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        g = _generator(seed)
        self.num_layers = num_layers
        self.input_layer = Dense(input_dim, hidden_dim, False, device, g)
        for i in range(num_layers):
            self.add_module("serial_{}".format(i),
                            Dense(hidden_dim, hidden_dim, False, device, g))
        self.output_layer = Dense(hidden_dim, output_dim, False, device, g)

    def forward(self, x, y, deterministic=True):
        x = self.input_layer(x)
        for i in range(self.num_layers):
            x = getattr(self, "serial_{}".format(i))(x)
        return _nll(self.output_layer(x), y)


class DenseRelu(nn.Module):
    """Pipeline stage: Dense (no bias) then ReLU, its layer named as flax
    names it (``Dense_0``)."""

    def __init__(self, features=32, in_features=None, device=None, seed=0):
        super().__init__()
        self.Dense_0 = Dense(in_features or features, features, False,
                             resolve_device(device), _generator(seed))

    def forward(self, x):
        return F.relu(self.Dense_0(x))


class DenseOut(nn.Module):
    """Pipeline output stage: Dense (no bias)."""

    def __init__(self, features=8, in_features=None, device=None, seed=0):
        super().__init__()
        self.Dense_0 = Dense(in_features or features, features, False,
                             resolve_device(device), _generator(seed))

    def forward(self, x):
        return self.Dense_0(x)


def ce_loss(logits, labels):
    """Cross-entropy on integer labels (the pipeline's loss function)."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.to(torch.int64)[..., None]).mean()


class PLD_SimpleModel(nn.Module):
    """``SimpleModel`` taking the progressive-layer-drop arguments the
    engine injects under a ``progressive_layer_drop`` block: with
    ``progressive_layer_drop`` the layer's output is scaled by
    ``pld_theta``."""

    def __init__(self, hidden_dim, device=None, seed=0):
        super().__init__()
        self.linear = Dense(hidden_dim, hidden_dim, device=resolve_device(
            device), generator=_generator(seed))

    def forward(self, x, y, progressive_layer_drop=False, pld_theta=1.0,
                deterministic=True):
        h = self.linear(x)
        if progressive_layer_drop:
            h = h * pld_theta
        return _nll(h, y)
