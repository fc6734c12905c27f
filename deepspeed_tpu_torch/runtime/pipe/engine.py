"""PipelineEngine: the 1F1B pipeline over the 'pipe' axis of the rank grid.

Counterpart of the JAX package's ``runtime/pipe/engine.py``. The JAX engine
is single-controller: one process drives every stage's devices and
interleaves all stages' instruction streams. Here each rank is one stage
of one pipe line (and one coordinate of its data and model lines), and it
interprets its own stage's stream of the same schedules
(``runtime/pipe/schedule.py``), in order:

- ``LoadMicroBatch``: the next micro-batch of the rank's data iterator:
  its inputs on the first stage, its labels on the last.
- ``ForwardPass``: the stage's layers (``torch.utils.checkpoint`` over
  spans of ``activation_checkpoint_interval`` layers while training); the
  last stage applies ``loss_fn``.
- ``BackwardPass``: on the last stage the loss times the loss scale over
  the micro-batches; elsewhere ``torch.autograd.backward(outputs,
  received_grads)``. Gradients add up in ``.grad`` over the micro-batches.
- ``SendActivation`` / ``RecvActivation`` / ``SendGrad`` / ``RecvGrad``:
  ``runtime/pipe/p2p.py`` between adjacent stages; the activations'
  shapes and dtypes go once as a meta message (again when the engine
  switches between training and evaluation).
- ``ReduceTiedGrads``: each tied key's gradient all-reduced (summed) over
  the stages that hold a copy (the JAX engine sums the uses of one aliased
  tree). The copies start equal (broadcast from the first such stage at
  build) and get the same updates.
- ``ReduceGrads``: the data group's mean (``allreduce_gradients``); none
  in 1-bit Adam's compression phase.
- ``OptimizerStep``: the fp16 overflow flag agreed over the world, the
  clipping norm over the model and pipe groups (each tied copy counted on
  its first stage only), then the stage's update.

``train_batch`` returns the mean loss over the micro-batches (and the
data group), broadcast from the last stage to every stage; ``eval_batch``
runs the ``InferenceSchedule`` without gradients. ``forward``,
``backward`` and ``step`` raise. As in the JAX pipeline engine, a stage's
fp32 parameters go to its layers as they are (a layer computes in its own
dtype: GPT-2's casts its weights to ``config.dtype``, flax's ``dtype=``);
fp16 brings the loss scaler. Under tensor parallelism (a 'model' axis,
the module's ``tp_rules``) the stage's layers are sharded as the base
engine shards a model.

Checkpoints have the JAX engine's per-layer layout: a
``layer_XX[-model_YY]-model_states.pt`` file of full fp32 leaves per layer
(a tied key's file at each of its indices), the optimizer states of every
layer as one list in ``zero_pp_rank_0_mp_rank_00optim_states.pt``, and
the meta file ``mp_rank_00_model_states.pt``; they load at another stage
count and in the other package. ZeRO stages 1-3 are not taken with a
pipeline (ROADMAP Queue 1 item 8).

1-bit Adam over a pipeline's data ranks (JAX ``_onebit_pp_capable``: data
ranks within the stage, no model ranks): warm-up as usual, then each stage
exchanges its layers' momenta compressed over its data group and skips
``ReduceGrads``; the error buffers go into the per-layer optimizer file in
the JAX layout (``[W, padded]`` rows).
"""

import inspect
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.parallel import comm
from deepspeed_tpu_torch.parallel import mesh as mesh_lib
from deepspeed_tpu_torch.runtime.engine import (DeepSpeedEngine, _nest,
                                                setup_placement)
from deepspeed_tpu_torch.runtime.fp16.onebit_adam import OnebitAdam
from deepspeed_tpu_torch.runtime.pipe import p2p
from deepspeed_tpu_torch.runtime.pipe import schedule as sched
from deepspeed_tpu_torch.runtime.pipe.module import (PipelineModule,
                                                     TiedLayerSpec)
from deepspeed_tpu_torch.runtime.pipe.topology import (
    PipeDataParallelTopology, PipelineParallelGrid,
    PipeModelDataParallelTopology)
from deepspeed_tpu_torch.runtime.utils import (ensure_directory_exists,
                                               has_overflow)
from deepspeed_tpu_torch.utils.distributed import group_timeout

OPTIM_FILE = "zero_pp_rank_0_mp_rank_00optim_states.pt"
META_FILE = "mp_rank_00_model_states.pt"

stats = {}


def reset_stats():
    """The tied-gradient all-reduces and their bytes."""
    stats.update(tied_calls=0, tied_bytes=0)


reset_stats()


def _accepts_seed(fn):
    try:
        return "seed" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


class _ForwardFn(nn.Module):
    """A tied use's ``forward_fn(layer, x)`` as a module over ``layer``."""

    def __init__(self, layer, fn):
        super().__init__()
        self.layer = layer
        self.fn = fn

    def forward(self, x):
        return self.fn(self.layer, x)


class _StageModule(nn.Module):
    """One stage's layers: submodule ``str(idx)`` per built layer (a tied
    key once, at its first index on the stage); ``layer_name[idx]`` the
    submodule a global layer index uses, ``fns[idx]`` a parameterless
    callable."""

    def __init__(self, pipe_module, stage_id, device):
        super().__init__()
        layers = pipe_module.build_stage(stage_id, device)
        self.indices = sorted(layers)
        self.layer_name, self.fns, seen = {}, {}, {}
        for idx in self.indices:
            layer = layers[idx]
            if not isinstance(layer, nn.Module):
                self.fns[idx] = layer
            elif id(layer) in seen:
                self.layer_name[idx] = seen[id(layer)]
            else:
                self.add_module(str(idx), layer)
                self.layer_name[idx] = seen[id(layer)] = str(idx)
        self.tp_rules = pipe_module.tp_rules

    @staticmethod
    def rule_path(name):
        """A parameter's name within its layer: the tensor-parallel rules
        match it, as the JAX engine matches them on each layer's tree."""
        return name.split(".", 1)[1]


class PipelineEngine(DeepSpeedEngine):
    """Training engine for ``PipelineModule`` models (module docstring).
    ``model_parameters`` may be a list of per-layer flax trees (the JAX
    ``PipelineEngine``'s ``layer_params``; None for a parameterless
    layer), loaded into this stage's layers."""

    _pipelined = True

    def __init__(self, args, model, optimizer=None, model_parameters=None,
                 training_data=None, lr_scheduler=None, config_params=None,
                 device=None, seed=1234, collate_fn=None, mesh=None,
                 dist_init_required=None):
        if not isinstance(model, PipelineModule):
            raise TypeError("model must be a PipelineModule")
        self.pipe_module = model
        self.num_stages = model.num_stages
        num_mp = max(model.topology().get_dim("model"), 1)
        device, mesh = setup_placement(device, mesh, dist_init_required,
                                       num_pp=self.num_stages, num_mp=num_mp)
        if mesh_lib.pp_size(mesh) != self.num_stages:
            raise ValueError("the mesh's pipe axis is {} wide; the module "
                             "has {} stages".format(mesh_lib.pp_size(mesh),
                                                    self.num_stages))
        if mesh_lib.sp_size(mesh) != 1:
            raise NotImplementedError("a pipeline over a 'seq' axis is not "
                                      "ported (ROADMAP Queue 1 item 10)")
        pp, dp, mp = (mesh_lib.pp_size(mesh), mesh_lib.dp_size(mesh),
                      mesh_lib.mp_size(mesh))
        topo = PipeModelDataParallelTopology(num_pp=pp, num_mp=mp,
                                             num_dp=dp) if mp > 1 else \
            PipeDataParallelTopology(num_pp=pp, num_dp=dp)
        self.grid = PipelineParallelGrid(topology=topo, mesh=mesh,
                                         global_rank=mesh.rank)
        self.stage_id = self.grid.get_stage_id()
        stage = self._build_stage(model, device, model_parameters)
        self._tied_groups = self._build_tied_groups(mesh)
        self._broadcast_tied(stage)
        super().__init__(args, stage, optimizer=optimizer,
                         training_data=training_data,
                         lr_scheduler=lr_scheduler,
                         config_params=config_params, device=device,
                         seed=seed, collate_fn=collate_fn, mesh=mesh,
                         dist_init_required=False)
        self._check_zero_stage()
        stages = self._config.pipeline["stages"]
        if stages != "auto" and int(stages) != self.num_stages:
            raise ValueError("ds_config pipeline.stages={} but the "
                             "PipelineModule has {} stages".format(
                                 stages, self.num_stages))
        self.activation_checkpoint_interval = \
            model.activation_checkpoint_interval or \
            self._config.pipeline["activation_checkpoint_interval"]
        self.micro_batches = self.gradient_accumulation_steps()
        self.is_first = self.stage_id == 0
        self.is_last = self.stage_id == self.num_stages - 1
        if self.num_stages > 1:
            p2p.init_process_groups(self.grid)
        # Per layer index: its parameters (engine index, name in the layer).
        self._layer_params = self._index_layers()
        # The tied copies another stage counts in the norm.
        self._tied_skip = frozenset(
            i for key, idxs in model.tied_specs.items()
            if model.tied_stages(key)[0] != self.stage_id
            for idx in idxs if idx in self._layer_params
            for i, _ in self._layer_params[idx])
        self._seeded = {idx: _accepts_seed(self._layer(idx).forward)
                        for idx in self.module.layer_name}
        self._meta_mode = None
        self._send_meta = self._recv_meta = None
        self.agg_loss = None

    # ---------------------------------------------------------- build

    def _build_stage(self, model, device, model_parameters):
        """This rank's stage module, its layers loaded from the per-layer
        trees ``model_parameters`` where given."""
        stage = _StageModule(model, self.stage_id, device)
        if model_parameters is not None:
            self._load_layer_trees(stage, model_parameters)
        return stage

    def _check_zero_stage(self):
        if self.zero_optimization() and self.zero_optimization_stage() >= 1:
            raise NotImplementedError(
                "ZeRO stage {} with a pipeline is not ported (ROADMAP Queue "
                "1 item 8)".format(self.zero_optimization_stage()))

    def _index_layers(self):
        """{layer index: [(engine parameter index, name in the layer)]}."""
        out = {}
        for idx, name in self.module.layer_name.items():
            prefix = name + "."
            out[idx] = [(i, n[len(prefix):]) for i, n in
                        enumerate(self._names) if n.startswith(prefix)]
        return out

    def _layer(self, idx):
        return getattr(self.module, self.module.layer_name[idx])

    def _load_layer_trees(self, stage, trees):
        from deepspeed_tpu_torch.runtime.utils import load_flax_tree
        trees = list(trees)
        if len(trees) != self.pipe_module.num_layers():
            raise ValueError("{} layer trees for {} layers".format(
                len(trees), self.pipe_module.num_layers()))
        done = set()
        for idx, name in stage.layer_name.items():
            if name in done or trees[idx] is None:
                continue
            load_flax_tree(getattr(stage, name), trees[idx])
            done.add(name)

    def _build_tied_groups(self, mesh):
        """{key: (group, source rank)} for the tied keys this rank holds
        on more than one stage (every rank makes every group, in order)."""
        out = {}
        if not dist.is_initialized():
            return out
        pp, dp, mp = (mesh_lib.pp_size(mesh), mesh_lib.dp_size(mesh),
                      mesh_lib.mp_size(mesh))
        for key in sorted(self.pipe_module.tied_specs):
            stages = self.pipe_module.tied_stages(key)
            if len(stages) < 2:
                continue
            for d in range(dp):
                for m in range(mp):
                    ranks = [(s * dp + d) * mp + m for s in stages]
                    group = dist.new_group(ranks, timeout=group_timeout())
                    if mesh.rank in ranks:
                        out[key] = (group, ranks[0])
        return out

    @torch.no_grad()
    def _broadcast_tied(self, stage):
        for key, (group, src) in self._tied_groups.items():
            idx = next(i for i in self.pipe_module.tied_specs[key]
                       if i in stage.layer_name)
            for p in getattr(stage, stage.layer_name[idx]).parameters():
                comm.broadcast(p.data, src, group)

    # ------------------------------------------------------- refusals

    def forward(self, *args, **kwargs):
        raise RuntimeError(
            "Only train_batch() is accessible in pipeline mode.")

    def backward(self, *args, **kwargs):
        raise RuntimeError(
            "Only train_batch() is accessible in pipeline mode.")

    def step(self, *args, **kwargs):
        raise RuntimeError(
            "Only train_batch() is accessible in pipeline mode.")

    # -------------------------------------------------------- batches

    def train_batch(self, data_iter=None, batch=None):
        """One batch: ``gradient_accumulation_steps`` micro-batches from
        ``data_iter`` (or ``batch`` split along its first dim) through the
        1F1B schedule, then the step. Returns the mean loss (a float, the
        same on every rank)."""
        if data_iter is None and batch is None:
            raise ValueError("train_batch needs a data_iter or a batch")
        if batch is not None:
            data_iter = iter(self._split(batch))
        self.train()
        self.tput_timer.start()
        self._run(sched.TrainSchedule(self.micro_batches, self.num_stages,
                                      self.stage_id), data_iter, True)
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        self._notify_optimizer()
        self.tput_timer.stop()
        self._last_loss = torch.tensor(self.agg_loss)
        self._tensorboard_step_events()
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        if self.global_rank == 0 and \
                self.global_steps % self.steps_per_print() == 0:
            self._report_progress(self.global_steps)
        return self.agg_loss

    def eval_batch(self, data_iter):
        """The mean loss over ``gradient_accumulation_steps`` micro-batches
        of ``data_iter`` through the ``InferenceSchedule``, without
        gradients; the parameters are untouched."""
        self.eval()
        with torch.no_grad():
            self._run(sched.InferenceSchedule(
                self.micro_batches, self.num_stages, self.stage_id),
                data_iter, False)
        self.train()
        return self.agg_loss

    def _split(self, batch):
        gas = self.micro_batches
        parts = tuple(batch) if isinstance(batch, (tuple, list)) \
            else (batch,)
        rows = parts[0].shape[0]
        if rows % gas:
            raise ValueError("train_batch(batch=...) with "
                             "gradient_accumulation_steps={} needs a leading "
                             "dim divisible by it, got {}".format(gas, rows))
        mb = rows // gas
        return [tuple(x[i * mb:(i + 1) * mb] for x in parts)
                for i in range(gas)]

    def _run(self, schedule, data_iter, train):
        if self._meta_mode != train:
            self._meta_mode = train
            self._send_meta = self._recv_meta = None
        self._st = {"inputs": {}, "labels": {}, "outputs": {},
                    "out_grad": {}, "in_grad": {}, "losses": [],
                    "data": data_iter, "train": train}
        for cmds in schedule.steps():
            for cmd in cmds:
                self._INSTRUCTIONS[type(cmd)](self, cmd)
        self.agg_loss = self._reduce_loss(self._st.pop("losses"))
        self._st = None

    def _reduce_loss(self, losses):
        """The micro-batches' mean loss on the last stage, the data group's
        mean, broadcast over the pipe line."""
        t = torch.zeros(1, dtype=torch.float32, device=self.device)
        if self.is_last and losses:
            t = torch.stack([x.float() for x in losses]).mean().reshape(1)
            if self.dp_world_size > 1:
                t = comm.all_reduce(t, self.dp_group, mean=True)
        if self.pp_group is not None:
            last = self.grid.stage_to_global(self.num_stages - 1)
            comm.broadcast(t, last, self.pp_group)
        return float(t)

    # ---------------------------------------------------- the forward

    def _cast(self):
        """{parameter name: the full tensor the forward uses} of the
        stored tensor-parallel shards (all-gathered), or None."""
        stored = self._tp.stored if self._tp is not None else []
        if not stored:
            return None
        return {self._names[i]: self._tp.gathered(i, self._params[i])
                for i in stored}

    def _run_layer(self, idx, h, cast, seed):
        if idx in self.module.fns:
            return self.module.fns[idx](h)
        name = self.module.layer_name[idx]
        layer = getattr(self.module, name)
        fn = getattr(self.pipe_module.layer_specs[idx], "forward_fn", None)
        kwargs = {"seed": seed} if seed is not None and \
            self._seeded[idx] and fn is None else {}
        if cast is None:
            return fn(layer, h) if fn is not None else layer(h, **kwargs)
        params = {local: cast[self._names[i]]
                  for i, local in self._layer_params[idx]
                  if self._names[i] in cast}
        if fn is not None:
            return torch.func.functional_call(
                _ForwardFn(layer, fn),
                {"layer." + k: v for k, v in params.items()}, (h,))
        return torch.func.functional_call(layer, params, (h,), kwargs)

    def _run_span(self, span, h, cast, seeds):
        for idx in span:
            h = self._run_layer(idx, h, cast, seeds.get(idx))
        return h

    def _stage_forward(self, x, labels, train):
        cast = self._cast()
        idxs = self.module.indices
        seeds = {}
        if train:
            # One dropout seed per layer and micro-batch, from the
            # engine's generator (the same on every model rank).
            drawn = torch.randint(0, 2 ** 62, (len(idxs),),
                                  generator=self._generator).tolist()
            seeds = dict(zip(idxs, drawn))
        every = self.activation_checkpoint_interval
        h = x
        if train and every > 0:
            for start in range(0, len(idxs), every):
                h = checkpoint(self._run_span, idxs[start:start + every], h,
                               cast, seeds, use_reentrant=False)
        else:
            h = self._run_span(idxs, h, cast, seeds)
        if self.is_last and self.pipe_module.loss_fn is not None:
            return self.pipe_module.loss_fn(h, labels)
        return h

    # --------------------------------------------------- instructions

    def _to_device(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(self.device) if isinstance(x, torch.Tensor) else x

    def _exec_load_micro_batch(self, cmd):
        batch = next(self._st["data"])
        parts = tuple(batch) if isinstance(batch, (tuple, list)) \
            else (batch,)
        if self.is_first:
            self._st["inputs"][cmd.buffer_id] = self._to_device(parts[0])
        if self.is_last:
            self._st["labels"][cmd.buffer_id] = self._to_device(parts[-1])

    def _exec_forward_pass(self, cmd):
        st = self._st
        x = st["inputs"][cmd.buffer_id]
        out = self._stage_forward(x, st["labels"].pop(cmd.buffer_id, None),
                                  st["train"])
        if self.is_last:
            if st["train"] and out.dim() != 0:
                raise RuntimeError(
                    "last pipeline stage produced a non-scalar output and "
                    "no loss_fn was given; provide loss_fn to PipelineModule "
                    "or make the last layer return a scalar loss")
            st["losses"].append(out.detach())
        if st["train"] or not self.is_last:
            st["outputs"][cmd.buffer_id] = out
        if not st["train"]:
            st["inputs"].pop(cmd.buffer_id, None)

    def _exec_backward_pass(self, cmd):
        st = self._st
        out = st["outputs"].pop(cmd.buffer_id)
        if self.is_last:
            scale = self.loss_scaler.loss_scale if self.loss_scaler else 1.0
            (out * (scale / self.micro_batches)).backward()
        else:
            outs = _tensors(out)
            grads = st["out_grad"].pop(cmd.buffer_id)
            pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
            torch.autograd.backward([o for o, _ in pairs],
                                    [g for _, g in pairs])
        x = st["inputs"].pop(cmd.buffer_id)
        if not self.is_first:
            st["in_grad"][cmd.buffer_id] = [
                t.grad if t.grad is not None else torch.zeros_like(t)
                for t in _tensors(x) if t.is_floating_point()]

    def _exec_send_activation(self, cmd):
        st = self._st
        out = st["outputs"][cmd.buffer_id] if st["train"] else \
            st["outputs"].pop(cmd.buffer_id)
        outs = [t.detach() for t in _tensors(out)]
        if self._send_meta is None:
            p2p.send_meta(outs, self.stage_id + 1)
            self._send_meta = [(tuple(t.shape), t.dtype) for t in outs]
        for t in outs:
            p2p.send(t, self.stage_id + 1)

    def _exec_recv_activation(self, cmd):
        if self._recv_meta is None:
            self._recv_meta = p2p.recv_meta(self.stage_id - 1)
        got = []
        for shape, dtype in self._recv_meta:
            t = p2p.recv(torch.empty(shape, dtype=dtype, device=self.device),
                         self.stage_id - 1)
            if t.is_floating_point() and self._st["train"]:
                t.requires_grad_(True)
            got.append(t)
        self._st["inputs"][cmd.buffer_id] = got[0] if len(got) == 1 \
            else tuple(got)

    def _exec_send_grad(self, cmd):
        for g in self._st["in_grad"].pop(cmd.buffer_id):
            p2p.send(g, self.stage_id - 1)

    def _exec_recv_grad(self, cmd):
        self._st["out_grad"][cmd.buffer_id] = [
            p2p.recv(torch.empty(shape, dtype=dtype, device=self.device),
                     self.stage_id + 1)
            for shape, dtype in self._send_meta if dtype.is_floating_point]

    @torch.no_grad()
    def _exec_reduce_tied_grads(self, cmd):
        for key, (group, _) in self._tied_groups.items():
            idx = next(i for i in self.pipe_module.tied_specs[key]
                       if i in self._layer_params)
            params = [self._params[i] for i, _ in self._layer_params[idx]]
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            flat = torch.cat([p.grad.reshape(-1).float() for p in params])
            stats["tied_calls"] += 1
            stats["tied_bytes"] += flat.numel() * flat.element_size()
            comm.all_reduce(flat, group)
            off = 0
            for p in params:
                p.grad.copy_(flat[off:off + p.numel()].view_as(p.grad))
                off += p.numel()

    def _onebit_eligible(self):
        """1-bit Adam's compressed exchange over the stage's data ranks."""
        return isinstance(self.optimizer, OnebitAdam) and \
            self.dp_world_size > 1 and self.mp_world_size == 1

    def _exec_reduce_grads(self, cmd):
        if not self._onebit_compressed():
            self.allreduce_gradients()

    @torch.no_grad()
    def _exec_optimizer_step(self, cmd):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params]
        cur_scale = 1.0
        if self.loss_scaler is not None:
            cur_scale = self.loss_scaler.loss_scale
            overflow = self._agreed(has_overflow(grads))
            self.loss_scaler.update_scale(overflow)
            if overflow:
                self.skipped_steps += 1
                self.zero_grad()
                return
        self._update(grads, 1.0 / cur_scale, skip=self._tied_skip)
        self.zero_grad()

    _INSTRUCTIONS = {
        sched.LoadMicroBatch: _exec_load_micro_batch,
        sched.ForwardPass: _exec_forward_pass,
        sched.BackwardPass: _exec_backward_pass,
        sched.SendActivation: _exec_send_activation,
        sched.RecvActivation: _exec_recv_activation,
        sched.SendGrad: _exec_send_grad,
        sched.RecvGrad: _exec_recv_grad,
        sched.ReduceTiedGrads: _exec_reduce_tied_grads,
        sched.ReduceGrads: _exec_reduce_grads,
        sched.OptimizerStep: _exec_optimizer_step,
    }

    # ----------------------------------------------------- checkpoints

    def _layer_full(self, idx, tensors):
        """{name in the layer: full fp32 numpy} of layer ``idx`` from
        per-parameter ``tensors`` (collective over the model group)."""
        out = {}
        for i, local in self._layer_params[idx]:
            out[local] = self._leaf_full(idx, i, tensors)
        return _nest(list(out), list(out.values()))

    def _leaf_full(self, idx, i, tensors):
        """Layer ``idx``'s full fp32 leaf of parameter ``i`` in ``tensors``
        (collective over the model group)."""
        t = tensors[i].detach().float()
        if self._tp is not None:
            t = self._tp.full(i, t)
        return t

    def _set_leaf(self, idx, i, tensors, full):
        """Copy a full saved leaf of layer ``idx`` into this rank's
        ``tensors[i]``."""
        if self._tp is not None:
            full = self._tp.local(i, full)
        tensors[i].copy_(full)

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        """The JAX engine's per-layer layout (module docstring)."""
        if tag is None:
            tag = "global_step{}".format(self.global_steps)
        ckpt_dir = os.path.join(save_dir, str(tag))
        writer = self.dp_rank == 0 and self.mp_rank == 0
        onebit_rows = self._onebit_error_rows()  # collective
        states = {}
        for idx in sorted(self._layer_params):
            if not self._layer_params[idx]:
                continue
            tree = self._layer_full(idx, self._params)
            if self.opt_state is not None:
                states[idx] = {
                    "exp_avg": self._layer_full(idx,
                                                self.opt_state["exp_avg"]),
                    "exp_avg_sq": self._layer_full(
                        idx, self.opt_state["exp_avg_sq"]),
                    "step": np.asarray(self.opt_state["step"], np.int32)}
                for key, rows in (onebit_rows or {}).items():
                    states[idx][key] = self._layer_full(idx, rows)
            if writer:
                path = self.pipe_module.ckpt_layer_path(ckpt_dir, idx)
                ensure_directory_exists(path)
                with open(path, "wb") as f:
                    pickle.dump(tree, f)
        if self.opt_state is not None:
            parts = [states]
            if self.pp_group is not None:
                parts = comm.all_gather_object(
                    states if writer else {}, self.pp_group)
            if self.global_rank == 0:
                merged = {}
                for part in parts:
                    merged.update(part)
                path = os.path.join(ckpt_dir, OPTIM_FILE)
                ensure_directory_exists(path)
                with open(path, "wb") as f:
                    pickle.dump([merged.get(i) for i in range(
                        self.pipe_module.num_layers())], f)
        if self.global_rank == 0:
            meta = {
                "global_steps": self.global_steps,
                "global_samples": self.global_samples,
                "skipped_steps": self.skipped_steps,
                "num_layers": self.pipe_module.num_layers(),
                "parts": self.pipe_module.parts,
                "lr_scheduler": self.lr_scheduler.state_dict()
                if self.lr_scheduler else None,
            }
            if client_state:
                meta.update(client_state)
            path = os.path.join(ckpt_dir, META_FILE)
            ensure_directory_exists(path)
            with open(path, "wb") as f:
                pickle.dump(meta, f)
            if save_latest:
                with open(os.path.join(save_dir, "latest"), "w") as fd:
                    fd.write(str(tag))
        if dist.is_initialized():
            dist.barrier()
        return True

    @torch.no_grad()
    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        **kwargs):
        """Load a per-layer checkpoint of either package, saved at any
        stage count. Returns (checkpoint dir, client state), or (None,
        None) without one."""
        if tag is None:
            latest = os.path.join(load_dir, "latest")
            if not os.path.isfile(latest):
                return None, None
            with open(latest) as fd:
                tag = fd.read().strip()
        ckpt_dir = os.path.join(load_dir, str(tag))
        if not os.path.isdir(ckpt_dir):
            return None, None
        for idx, params in self._layer_params.items():
            path = self.pipe_module.ckpt_layer_path(ckpt_dir, idx)
            if not params or not os.path.exists(path):
                continue
            with open(path, "rb") as f:
                tree = pickle.load(f)
            for i, local in params:
                self._set_leaf(idx, i, self._params, _full_leaf(tree, local))
        opt_path = os.path.join(ckpt_dir, OPTIM_FILE)
        if load_optimizer_states and self.opt_state is not None and \
                os.path.exists(opt_path):
            with open(opt_path, "rb") as f:
                saved = pickle.load(f)
            for idx, params in self._layer_params.items():
                entry = saved[self._owner_index(idx)]
                if entry is None:
                    continue
                for i, local in params:
                    for key in ("exp_avg", "exp_avg_sq"):
                        self._set_leaf(idx, i, self.opt_state[key],
                                       _full_leaf(entry[key], local))
                    for key in ("worker_error", "server_error"):
                        if key in entry and key in self.opt_state:
                            leaf = self._local_leaf(i, entry[key], local)
                            if leaf.dim() == 2:
                                leaf = leaf[self.dp_rank if
                                            self._onebit_eligible() else 0]
                            self.opt_state[key][i].copy_(leaf)
                self.opt_state["step"] = int(np.asarray(entry["step"]))
        with open(os.path.join(ckpt_dir, META_FILE), "rb") as f:
            meta = pickle.load(f)
        self.global_steps = meta.get("global_steps", 0)
        self.global_samples = meta.get("global_samples", 0)
        self.skipped_steps = meta.get("skipped_steps", 0)
        if isinstance(self.optimizer, OnebitAdam):
            # The phase follows the loaded step count, both ways.
            self.optimizer.load_state_dict({"adam_freeze_key": False})
        self._notify_optimizer()
        if self.lr_scheduler and meta.get("lr_scheduler"):
            self.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        return ckpt_dir, {k: v for k, v in meta.items() if k not in (
            "global_steps", "global_samples", "skipped_steps", "num_layers",
            "parts", "lr_scheduler")}

    def _owner_index(self, idx):
        """The layer index whose optimizer state a layer loads: a tied
        key's first index (the JAX engine updates the owner's only)."""
        spec = self.pipe_module.layer_specs[idx]
        if isinstance(spec, TiedLayerSpec):
            return self.pipe_module.tied_specs[spec.key][0]
        return idx

    def _local_leaf(self, i, tree, local):
        full = _full_leaf(tree, local)
        if self._tp is not None:
            full = self._tp.local(i, full)
        return full


def _full_leaf(tree, local):
    """The saved leaf ``local`` ("a.b" in the layer's tree) as an fp32
    tensor."""
    for key in local.split("."):
        tree = tree[key]
    return torch.from_numpy(np.ascontiguousarray(np.asarray(tree,
                                                            np.float32)))


def _tensors(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]
