"""ADAPTER: serving code reaches models only through ModelAdapter.

Counterpart of ``deepspeed_tpu/analysis/rules/adapter.py``, over the
port's ``inference/``. Invariant guarded: the engine<->model boundary is
the ModelAdapter protocol (inference/adapters/protocol.py). The one
sanctioned ``models.generation`` import inside ``inference/`` is
``adapters/gpt2.py``, the GPT-2 implementation of the protocol. Any other
``inference/`` module importing the model source (``import
deepspeed_tpu_torch.models.generation``, ``from deepspeed_tpu_torch.models
import generation``, or a ``from ... import`` of its symbols) couples the
serving stack to one model family again and breaks the MoE and
long-context workloads that trust the engine to be model-blind.
"""

import ast

from ..core import Finding

# The model-source module serving code must not import directly.
_MODEL_MODULE = "deepspeed_tpu_torch.models.generation"

# Files under this prefix are in scope for the rule.
_SERVING_PREFIX = "deepspeed_tpu_torch/inference/"

# The one sanctioned import site (canonical relpath).
_SANCTIONED = ("deepspeed_tpu_torch/inference/adapters/gpt2.py",)

_MSG = ("imports {} inside inference/ - serving code must reach the "
        "model through the ModelAdapter protocol (inference/adapters/); "
        "only adapters/gpt2.py may import the GPT-2 source")


def _is_model_module(name):
    if not name:
        return False
    return (name == _MODEL_MODULE
            or name.startswith(_MODEL_MODULE + ".")
            or name == "models.generation"
            or name.endswith(".models.generation"))


def check(ctx, config):
    if not ctx.relpath.startswith(_SERVING_PREFIX):
        return
    if ctx.relpath in _SANCTIONED:
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if _is_model_module(alias.name):
                    yield Finding(
                        "ADAPTER", ctx.relpath, node.lineno,
                        node.col_offset, "", _MSG.format(alias.name))
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if _is_model_module(mod):
                yield Finding(
                    "ADAPTER", ctx.relpath, node.lineno, node.col_offset,
                    "", _MSG.format(mod))
                continue
            # ``from deepspeed_tpu_torch.models import generation``: the
            # module lands via the alias list, not the module field.
            if mod in ("deepspeed_tpu_torch.models", "models") or \
                    mod.endswith(".models"):
                for alias in node.names:
                    if alias.name == "generation":
                        yield Finding(
                            "ADAPTER", ctx.relpath, node.lineno,
                            node.col_offset, "",
                            _MSG.format(mod + ".generation"))
