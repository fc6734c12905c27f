"""PipelineModule, LayerSpec and TiedLayerSpec.

Counterpart of the JAX package's ``runtime/pipe/module.py``. A
``PipelineModule`` is a specification: an ordered list of layers
(``LayerSpec``s, built modules or plain callables) and their partition
over the pipeline stages. The pipeline engine builds only its own stage's
layers (``build_stage``), on its device.

Partition methods (the JAX module's):
  - ``uniform``: equal layer counts per stage;
  - ``parameters``: balanced on per-layer parameter counts (a layer type's
    ``num_params`` attribute or method; 1 where it has none, as in JAX);
  - ``type:regex``: stage boundaries balanced over the layers whose class
    name matches.

Tied layers: every ``TiedLayerSpec`` of one ``key`` shares one set of
parameters. A stage builds one module per key and uses it at each of its
indices; stages that hold the same key each hold a copy, made equal at
build and kept equal by the engine's all-reduce of their gradients
(``ReduceTiedGrads``). ``forward_fn(layer, x)`` replaces a use's forward
(GPT-2's tied head: the embedding's ``wte`` as the output projection).

``seed_layers`` seeds a layer's weights with ``base_seed + index`` (a
layer type that takes a ``seed`` argument; ``seed_fn(seed)`` is called
first where given); the ``tp_rules`` attribute holds the tensor-parallel
rules of a 'model' axis (``parallel/tensor_parallel.py``);
``compiled=True`` selects the compiled engine (``runtime/pipe/compiled.py``)
at ``initialize``.
"""

import inspect
import os
import re

from deepspeed_tpu_torch.runtime.utils import (partition_balanced,
                                               partition_uniform)


def _accepted(fn):
    try:
        return set(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return set()


class LayerSpec(object):
    """A layer's constructor and its arguments, built on demand so each
    stage makes only its own layers."""

    def __init__(self, typename, *module_args, **module_kwargs):
        self.typename = typename
        self.module_args = module_args
        self.module_kwargs = module_kwargs
        if not callable(typename):
            raise RuntimeError("LayerSpec only supports callables / module "
                               "classes")

    def __repr__(self):
        from deepspeed_tpu_torch.runtime.pipe.schedule import call_to_str
        return call_to_str(getattr(self.typename, "__name__",
                                   str(self.typename)),
                           *self.module_args, **self.module_kwargs)

    def build(self, **extra):
        """The layer. ``extra`` keyword arguments (the engine's ``device``,
        the layer's ``seed``) are passed where the constructor takes them
        and override the spec's own."""
        kwargs = dict(self.module_kwargs)
        accepted = _accepted(self.typename)
        kwargs.update({k: v for k, v in extra.items() if k in accepted})
        return self.typename(*self.module_args, **kwargs)


class TiedLayerSpec(LayerSpec):
    """A ``LayerSpec`` whose parameters every spec of the same ``key``
    shares (module docstring)."""

    def __init__(self, key, typename, *module_args, forward_fn=None,
                 tied_weight_attr="embedding", **module_kwargs):
        super().__init__(typename, *module_args, **module_kwargs)
        self.key = key
        self.forward_fn = forward_fn
        self.tied_weight_attr = tied_weight_attr


class PipelineModule(object):
    """An ordered layer list partitioned over pipeline stages (module
    docstring). ``num_stages`` or ``topology`` (a ``ProcessTopology`` with
    a 'pipe' axis) gives the depth; ``loss_fn(outputs, labels)`` runs on
    the last stage."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seed_layers=False, seed_fn=None, base_seed=1234,
                 partition_method="parameters",
                 activation_checkpoint_interval=0,
                 activation_checkpoint_func=None, compiled=False):
        from deepspeed_tpu_torch.runtime.pipe.topology import (
            PipeDataParallelTopology)
        self.compiled = compiled
        if num_stages is None and topology is None:
            raise RuntimeError("must provide num_stages or topology")
        self._layer_specs = list(layers)
        self._num_layers = len(self._layer_specs)
        self.loss_fn = loss_fn
        self.seed_layers = seed_layers
        self.seed_fn = seed_fn
        self.base_seed = base_seed
        self._partition_method = partition_method
        self.activation_checkpoint_interval = activation_checkpoint_interval
        self.activation_checkpoint_func = activation_checkpoint_func
        # The tensor-parallel rules of a 'model' axis (set as an attribute,
        # as on the JAX module); None: DEFAULT_TP_RULES.
        self.tp_rules = None
        if topology is not None:
            self._topo = topology
            self.num_stages = self._topo.get_dim("pipe")
            if num_stages is not None:
                assert num_stages == self.num_stages, \
                    "num_stages {} != topology pipe dim {}".format(
                        num_stages, self.num_stages)
        else:
            self.num_stages = num_stages
            self._topo = PipeDataParallelTopology(num_pp=num_stages,
                                                  num_dp=1)
        self.parts = None
        self._param_counts = None
        self._partition_layers()
        self.tied_specs = {}
        for idx, spec in enumerate(self._layer_specs):
            if isinstance(spec, TiedLayerSpec):
                self.tied_specs.setdefault(spec.key, []).append(idx)

    def topology(self):
        return self._topo

    def mpu(self):
        return None

    def num_layers(self):
        return self._num_layers

    @property
    def layer_specs(self):
        return self._layer_specs

    def _count_layer_params(self):
        """Per-layer weights for 'parameters': a layer type's
        ``num_params`` where it has one, else 1 (the JAX module's
        estimate, so both packages cut the same stages)."""
        counts = []
        for spec in self._layer_specs:
            target = spec.typename if isinstance(spec, LayerSpec) else spec
            n = None
            if hasattr(target, "num_params"):
                try:
                    n = int(target.num_params() if callable(
                        target.num_params) else target.num_params)
                except Exception:
                    n = None
            counts.append(n if n is not None else 1)
        return counts

    def _partition_layers(self):
        method = self._partition_method.lower()
        if method == "uniform":
            self.parts = partition_uniform(num_items=self._num_layers,
                                           num_parts=self.num_stages)
        elif method == "parameters":
            self._param_counts = self._count_layer_params()
            self.parts = partition_balanced(weights=self._param_counts,
                                            num_parts=self.num_stages)
        elif method.startswith("type:"):
            layertype = method.split(":", 1)[1]
            binary_weights = [0] * self._num_layers
            for idx, spec in enumerate(self._layer_specs):
                target = spec.typename if isinstance(spec, LayerSpec) else \
                    type(spec)
                name = getattr(target, "__name__", str(target))
                if re.match(layertype, name, re.IGNORECASE):
                    binary_weights[idx] = 1
            self.parts = partition_balanced(weights=binary_weights,
                                            num_parts=self.num_stages)
        elif method == "profile":
            raise NotImplementedError(
                "Partitioning method 'profile' not implemented")
        else:
            raise NotImplementedError(
                "Partitioning method {} not implemented".format(method))

    def stage_layer_range(self, stage_id):
        assert 0 <= stage_id < self.num_stages
        return self.parts[stage_id], self.parts[stage_id + 1]

    def stage_specs(self, stage_id):
        start, stop = self.stage_layer_range(stage_id)
        return self._layer_specs[start:stop]

    def stage_owner(self, layer_idx):
        """The stage that holds global layer ``layer_idx``."""
        for stage in range(self.num_stages):
            if self.parts[stage] <= layer_idx < self.parts[stage + 1]:
                return stage
        raise ValueError("layer {} out of range".format(layer_idx))

    def tied_stages(self, key):
        """The stages that hold a layer of tied ``key``, in order."""
        return sorted({self.stage_owner(i) for i in self.tied_specs[key]})

    def build_layer(self, idx, device=None):
        """Layer ``idx`` on ``device`` (a built module or callable spec is
        returned as it is)."""
        spec = self._layer_specs[idx]
        if not isinstance(spec, LayerSpec):
            return spec
        seed = self.base_seed + idx if self.seed_layers else idx
        if self.seed_layers and self.seed_fn is not None:
            self.seed_fn(seed)
        extra = {"seed": seed}
        if device is not None:
            extra["device"] = device
        return spec.build(**extra)

    def build_stage(self, stage_id, device=None):
        """{global index: layer} for ``stage_id``'s layers; the indices of
        one tied key share one module (built at the key's first index on
        this stage)."""
        start, stop = self.stage_layer_range(stage_id)
        layers, tied = {}, {}
        for idx in range(start, stop):
            spec = self._layer_specs[idx]
            if isinstance(spec, TiedLayerSpec):
                if spec.key not in tied:
                    tied[spec.key] = self.build_layer(idx, device)
                layers[idx] = tied[spec.key]
            else:
                layers[idx] = self.build_layer(idx, device)
        return layers

    def ckpt_layer_path(self, ckpt_dir, local_layer_idx):
        """Layer ``local_layer_idx``'s file, ``layer_XX[-model_YY]
        -model_states.pt`` (the topology's axes other than data and pipe,
        of rank 0, as the JAX module names it), so another split reloads
        it."""
        rank_repr = self._topo.get_rank_repr(rank=0)
        name = "layer_{:02d}".format(local_layer_idx)
        if rank_repr:
            name += "-" + rank_repr
        return os.path.join(ckpt_dir, name + "-model_states.pt")
