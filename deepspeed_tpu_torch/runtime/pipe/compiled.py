"""CompiledPipelineEngine: the JAX package's one-program pipeline, per rank.

Counterpart of ``deepspeed_tpu/runtime/pipe/compiled.py``. The JAX engine
traces the whole GPipe schedule (the wavefront, the transfers, the
backward and the update) into one SPMD program over a (pipe, data) mesh.
Here each rank is one stage of one pipe line, as in the interpreter
(``runtime/pipe/engine.py``), and what carries over is the JAX engine's
contract:

- The layout (``_uniform_run``): the longest run of identical
  ``LayerSpec``s whose length is a multiple of the stage count is split
  evenly over the stages, L blocks a stage. A stage holds its blocks'
  parameters stacked, leaves ``[L, ...]`` (``blocks.<flax path joined by
  '__'>``), each block built with the interpreter's seed for its index, so
  both engines start from the same weights. The layers before the run
  (the prologue) live on stage 0, those after it (the epilogue, then
  ``loss_fn``) on the last stage. The JAX engine replicates both on every
  pipe shard and runs the epilogue on zeros off the last stage; this one
  does not.
- The schedule: GPipe's wavefront over M = ``gradient_accumulation_steps``
  micro-batches. A tick is the stage's L blocks on one micro-batch, and a
  rank runs only its M live ticks (the JAX worker also computes the S - 1
  bubble ticks on clamped inputs and masks them off). The forward ticks
  keep only their inputs; the backward recomputes each tick and
  backpropagates through it, micro-batch 0 first (``jax.checkpoint(tick)``;
  the recompute is the backward program's own, since the port's
  ``activation_checkpointing`` reads the CUDA RNG state, which a graph
  capture forbids). Activations go forward and their gradients back over
  ``runtime/pipe/p2p.py``, M each way a stage and step, and nothing goes
  from the last stage to the first. Stage 0 keeps the prologue's graph
  from its forward to its backward; the last stage runs the epilogue, the
  loss and their backward as each tick's output arrives.
- The step: the gradients' mean over the data group, one global-norm clip
  over every stage's gradients (``_global_norm`` over the pipe group), one
  optimizer update. ZeRO stage 1 shards the stacked blocks' moments over
  the stage's data group on the first dim past ``[L]`` that the data size
  divides (``zero_partition_dim`` of the block's leaf, the JAX
  ``_cp_blocks_state_sharding`` rule); each rank updates its shard of the
  fp32 parameters and the shards are all-gathered.
- The loss: the mean over the micro-batches on the last stage, the data
  group's mean, returned on every rank. ``eval_batch`` runs the forward
  ticks without dropout. Checkpoints have the interpreter's per-layer
  layout (each stacked leaf's slice per layer), so either engine, in
  either package, loads the other's.
- Dropout: one seed per layer and micro-batch from the engine's generator
  (the interpreter's draw); the recompute reuses its forward's.
- As in the interpreter, a stage's fp32 parameters go to its layers as
  they are (a layer computes in its own dtype); the JAX engine casts its
  tree to the compute dtype.

On the card each tick program is a CUDA graph: the training forward, the
evaluation forward and the backward (the recompute, the stacked leaves'
gradients added into fixed fp32 accumulators, the input's gradient out).
A program's first call runs eagerly (its warm-up, on the engine's capture
stream), its second is captured, and every call from then on replays it;
``graph_captures`` counts the captures (one per program and input shape),
``graph_replays`` the ticks the graphs serve. The transfers, the prologue,
the epilogue and the step stay outside the graphs. A failed capture
raises; nothing falls back to eager. The blocks' dropout draws from one
CUDA generator a block slot, registered with each graph
(``register_generator_state``) and seeded with the tick's seeds before
each run: a replay reads the generator's seed and offset, so it draws the
masks the eager tick draws from the same seeds (a block that takes
``seed`` gets the generator there, not the int). The flash kernels'
launches that a capture records are added at each replay
(``attention.recording``).

The JAX engine's refusals are kept, each a ValueError: a ``TiedLayerSpec``,
no uniform run, a 'pipe' axis other than the stage count, fp16 loss
scaling, ``OneBitAdam``, ZeRO stage 2 or 3. So is a 'model' axis (the JAX
worker shards over 'pipe' and 'data' only).
"""

import copy
import os

import torch
from torch import nn

from deepspeed_tpu_torch.ops.transformer.kernels import attention
from deepspeed_tpu_torch.parallel import mesh as mesh_lib
from deepspeed_tpu_torch.runtime.fp16.onebit_adam import OnebitAdam
from deepspeed_tpu_torch.runtime.pipe import p2p
from deepspeed_tpu_torch.runtime.pipe.engine import (PipelineEngine,
                                                     _accepts_seed)
from deepspeed_tpu_torch.runtime.pipe.module import (LayerSpec,
                                                     PipelineModule,
                                                     TiedLayerSpec)
from deepspeed_tpu_torch.runtime.zero.partition import gather_full


def _spec_key(spec):
    return (spec.typename, tuple(spec.module_args),
            tuple(sorted(spec.module_kwargs.items())))


def _uniform_run(specs, num_stages):
    """(i0, i1) of the longest run of identical plain LayerSpecs whose
    length is a positive multiple of ``num_stages``, or None."""
    best = None
    i, n = 0, len(specs)
    while i < n:
        if not isinstance(specs[i], LayerSpec) or \
                isinstance(specs[i], TiedLayerSpec):
            i += 1
            continue
        j = i + 1
        while j < n and isinstance(specs[j], LayerSpec) and \
                not isinstance(specs[j], TiedLayerSpec) and \
                _spec_key(specs[j]) == _spec_key(specs[i]):
            j += 1
        length = (j - i) // num_stages * num_stages
        if length >= num_stages and (best is None or
                                     length > best[1] - best[0]):
            best = (i, i + length)
        i = j
    return best


def _parts(run, num_stages, num_layers):
    """Stage boundaries: the prologue and the first L blocks on stage 0,
    L blocks a stage, the last L blocks and the epilogue on the last."""
    i0, i1 = run
    per = (i1 - i0) // num_stages
    return [0] + [i0 + s * per for s in range(1, num_stages)] + [num_layers]


class _CompiledStage(nn.Module):
    """One stage (module docstring): the prologue's and epilogue's layers
    as submodules ``str(idx)`` (``layer_name``, ``fns`` as in the
    interpreter's stage), the blocks as the stacked parameters of
    ``blocks``; ``template`` (not a submodule) runs a block on its slice."""

    def __init__(self, base, block_idx):
        super().__init__()
        self.indices = base.indices
        self.block_idx = list(block_idx)
        self.layer_name, self.fns = {}, {}
        for idx in base.indices:
            if idx in self.block_idx:
                continue
            if idx in base.fns:
                self.fns[idx] = base.fns[idx]
            else:
                self.add_module(str(idx), getattr(base, base.layer_name[idx]))
                self.layer_name[idx] = str(idx)
        blocks = [getattr(base, base.layer_name[idx]) if idx in
                  base.layer_name else base.fns[idx] for idx in block_idx]
        self._template = [blocks[0]]
        self.leaf_names = [n for n, _ in blocks[0].named_parameters()] \
            if isinstance(blocks[0], nn.Module) else []
        self.blocks = nn.Module()
        with torch.no_grad():
            for name in self.leaf_names:
                stacked = torch.stack([b.get_parameter(name) for b in blocks])
                self.blocks.register_parameter(
                    name.replace(".", "__"),
                    nn.Parameter(stacked, requires_grad=False))

    @property
    def template(self):
        return self._template[0]

    def stacked(self):
        return [self.blocks.get_parameter(n.replace(".", "__"))
                for n in self.leaf_names]

    def forward(self, *args, **kwargs):
        raise RuntimeError("Only train_batch() is accessible in pipeline "
                           "mode.")


class CompiledPipelineEngine(PipelineEngine):
    """The compiled pipeline engine (module docstring): ``train_batch`` and
    ``eval_batch`` as the interpreter's, over the GPipe wavefront."""

    def __init__(self, args, model, optimizer=None, model_parameters=None,
                 training_data=None, lr_scheduler=None, config_params=None,
                 device=None, seed=1234, collate_fn=None, mesh=None,
                 dist_init_required=None):
        if not isinstance(model, PipelineModule):
            raise TypeError("model must be a PipelineModule")
        specs = model.layer_specs
        if any(isinstance(s, TiedLayerSpec) for s in specs):
            raise ValueError(
                "compiled pipeline does not support TiedLayerSpec; use "
                "the interpreter PipelineEngine (compiled=False)")
        run = _uniform_run(specs, model.num_stages)
        if run is None:
            raise ValueError(
                "compiled pipeline needs a run of >= num_stages identical "
                "LayerSpecs (a uniform block stack); got {}".format(
                    [repr(s) for s in specs]))
        mp = max(model.topology().get_dim("model"), 1)
        if mp > 1 or (mesh is not None and mesh_lib.mp_size(mesh) > 1):
            raise ValueError("compiled pipeline runs over (pipe, data) ranks: "
                             "a 'model' axis is not supported; use the "
                             "interpreter PipelineEngine (compiled=False)")
        self._cp_run = run
        self._blocks_per_stage = (run[1] - run[0]) // model.num_stages
        # The stages as the layout cuts them (the caller's module keeps its
        # own partition).
        module = copy.copy(model)
        module.parts = _parts(run, model.num_stages, len(specs))
        self.graph_captures = 0
        self.graph_replays = 0
        self._programs = {}
        self._acc = None
        super().__init__(args, module, optimizer=optimizer,
                         model_parameters=model_parameters,
                         training_data=training_data,
                         lr_scheduler=lr_scheduler,
                         config_params=config_params, device=device,
                         seed=seed, collate_fn=collate_fn, mesh=mesh,
                         dist_init_required=dist_init_required)
        if self.loss_scaler is not None:
            raise ValueError(
                "compiled pipeline v1 does not implement fp16 dynamic loss "
                "scaling (overflow-skip needs host control flow); use bf16 "
                "or the interpreter engine (compiled=False)")
        if isinstance(self.optimizer, OnebitAdam):
            raise ValueError(
                "compiled pipeline v1 does not support OnebitAdam: its flat "
                "error-feedback buffers don't carry the [stage, block] "
                "stacking axis; use the interpreter engine (compiled=False) "
                "or a dense optimizer")
        # ZeRO-1 (module docstring): the stacked leaves' data-group dims.
        self._partitioned = False
        self._zero_dims = [None] * len(self._params)
        if self.zero_optimization() and self.dp_world_size > 1:
            for i in self._stacked_idx:
                d = mesh_lib.zero_partition_dim(
                    self._params[i].shape[1:], self.dp_world_size)
                self._zero_dims[i] = None if d is None else d + 1
        if self.optimizer is not None:
            self.opt_state = self.optimizer.init_state(
                [self._shard(i, p) for i, p in enumerate(self._params)])
        self._graphs = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._graphs \
            else None
        self._pool = None
        self._gens = None
        self._full_cache = None

    # ---------------------------------------------------------- build

    def _build_stage(self, model, device, model_parameters):
        base = super()._build_stage(model, device, model_parameters)
        i0 = self._cp_run[0]
        L = self._blocks_per_stage
        return _CompiledStage(base, range(i0 + self.stage_id * L,
                                          i0 + (self.stage_id + 1) * L))

    def _check_zero_stage(self):
        if self.zero_optimization() and self.zero_optimization_stage() >= 2:
            raise ValueError(
                "compiled pipeline v1 composes PP with ZeRO stage 1 (moments "
                "sharded over each stage's data replicas); stage {} grad/"
                "param sharding is not implemented - use stage 1 or the "
                "base engine".format(self.zero_optimization_stage()))

    def _index_layers(self):
        out = super()._index_layers()
        index = {n: i for i, n in enumerate(self._names)}
        self._stacked_idx = [index["blocks." + n.replace(".", "__")]
                             for n in self.module.leaf_names]
        self._slot = {}
        for slot, idx in enumerate(self.module.block_idx):
            self._slot[idx] = slot
            out[idx] = [(i, n) for i, n in zip(self._stacked_idx,
                                                self.module.leaf_names)]
        tmpl = self.module.template
        self._block_seeded = isinstance(tmpl, nn.Module) and \
            _accepts_seed(tmpl.forward)
        return out

    def _update_dims(self):
        return self._zero_dims

    def _shard(self, i, t):
        """This rank's ZeRO-1 shard of leaf ``i`` (a view; ``t`` itself for
        a leaf the data group does not shard)."""
        d = self._zero_dims[i]
        return t if d is None else mesh_lib.shard_slice(
            t, d, self.dp_rank, self.dp_world_size)

    def _gather(self, shards):
        """{i: the full leaf i} of every ZeRO-1 leaf from every data rank's
        ``shards`` (one per parameter)."""
        idx = [i for i, d in enumerate(self._zero_dims) if d is not None]
        if not idx:
            return {}
        return gather_full(shards, idx, self._zero_dims,
                           [tuple(p.shape) for p in self._params],
                           self.dp_group,
                           self._config.zero_config.allgather_bucket_size)

    # ------------------------------------------------------ the forward

    def _run_layers(self, idxs, h, seeds):
        for idx in idxs:
            if idx in self.module.fns:
                h = self.module.fns[idx](h)
                continue
            seed = seeds.get(idx)
            kw = {"seed": seed} if seed is not None and self._seeded[idx] \
                else {}
            h = self._layer(idx)(h, **kw)
        return h

    def _blocks(self, x, seeds):
        """The stage's L blocks on ``x``, each on its slice of the stacked
        leaves (``seeds`` per block index, or None)."""
        tmpl = self.module.template
        if not self.module.leaf_names:
            for _ in self.module.block_idx:
                x = tmpl(x)
            return x
        per = [t.unbind(0) for t in self.module.stacked()]
        for slot, idx in enumerate(self.module.block_idx):
            params = {n: leaves[slot] for n, leaves in
                      zip(self.module.leaf_names, per)}
            kw = {"seed": seeds[idx]} if seeds and self._block_seeded \
                else {}
            x = torch.func.functional_call(tmpl, params, (x,), kw)
        return x

    def _fwd_tick(self, x, seeds=None):
        with torch.no_grad():
            return self._blocks(x, seeds)

    def _bwd_tick(self, x, dy, seeds=None):
        """The recompute and backward of one tick: the stacked leaves'
        gradients added into the accumulators; returns the input's."""
        x = x.detach().requires_grad_(True)
        stacked = self.module.stacked()
        with torch.enable_grad():
            y = self._blocks(x, seeds)
        grads = torch.autograd.grad(y, [x] + stacked, dy)
        if stacked:
            torch._foreach_add_(self._acc, list(grads[1:]))
        return grads[0]

    def _tick(self, kind, *tensors, seeds=None):
        """Tick program ``kind`` ("fwd", "eval", "bwd") on ``tensors``:
        eager on the CPU; on the card its warm-up, capture or replay."""
        fn = self._bwd_tick if kind == "bwd" else self._fwd_tick
        if not self._graphs:
            return fn(*tensors, seeds=seeds)
        gens = self._seeded_gens(seeds)
        key = (kind,) + tuple((tuple(t.shape), t.dtype) for t in tensors)
        prog = self._programs.get(key)
        if prog is None:
            self._programs[key] = "warm"
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._stream):
                out = fn(*tensors, seeds=gens)
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
            return out
        if prog == "warm":
            prog = self._programs[key] = self._capture(fn, tensors, gens)
        graph, static, out, tally = prog
        for s, t in zip(static, tensors):
            s.copy_(t)
        graph.replay()
        attention.add_launches(tally)
        self.graph_replays += 1
        return out.clone()

    def _capture(self, fn, tensors, gens):
        """Capture ``fn`` on fixed copies of ``tensors`` with the block
        generators ``gens`` registered: (graph, inputs, output, the flash
        launches it recorded)."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        static = [t.detach().clone() for t in tensors]
        graph = torch.cuda.CUDAGraph()
        for gen in (gens or {}).values():
            graph.register_generator_state(gen)
        with attention.recording() as tally:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream):
                out = fn(*static, seeds=gens)
        self.graph_captures += 1
        return graph, static, out, dict(tally)

    def _seeded_gens(self, seeds):
        """{block index: its slot's generator seeded with ``seeds[idx]``}
        (module docstring), or None for a tick without seeds."""
        if not seeds or not self._block_seeded:
            return None
        if self._gens is None:
            self._gens = {idx: torch.Generator(device=self.device)
                          for idx in self.module.block_idx}
        for idx, gen in self._gens.items():
            gen.manual_seed(seeds[idx])
        return self._gens

    # ----------------------------------------------------- the schedule

    def _draw_seeds(self):
        """One dropout seed per layer of the stage for one micro-batch (the
        interpreter's draw)."""
        idxs = self.module.indices
        drawn = torch.randint(0, 2 ** 62, (len(idxs),),
                              generator=self._generator).tolist()
        return dict(zip(idxs, drawn))

    def _send_act(self, y):
        if self._send_meta is None:
            p2p.send_meta([y], self.stage_id + 1)
            self._send_meta = [(tuple(y.shape), y.dtype)]
        p2p.send(y, self.stage_id + 1)

    def _recv_act(self):
        if self._recv_meta is None:
            self._recv_meta = p2p.recv_meta(self.stage_id - 1)
        shape, dtype = self._recv_meta[0]
        return p2p.recv(torch.empty(shape, dtype=dtype, device=self.device),
                        self.stage_id - 1)

    def _run(self, schedule, data_iter, train):
        """One batch through the wavefront (module docstring): forward ticks
        for every micro-batch, then (training) the backward ticks and the
        step. ``schedule`` (the interpreter's) is not used."""
        loss_fn = self.pipe_module.loss_fn
        if not train and loss_fn is None:
            raise NotImplementedError(
                "compiled eval_batch needs a loss_fn (the interpreter "
                "engine's loss_fn-less eval exposes raw outputs; this "
                "engine's schedule reduces to a scalar)")
        if self._meta_mode != train:
            self._meta_mode = train
            self._send_meta = self._recv_meta = None
        M = self.micro_batches
        blocks = set(self.module.block_idx)
        pro = [i for i in self.module.indices if i < min(blocks)]
        epi = [i for i in self.module.indices if i > max(blocks)]
        if train and self._acc is None:
            self._acc = [torch.zeros_like(p) for p in self.module.stacked()]
        kept, losses = [], []
        for _ in range(M):
            batch = next(data_iter)
            parts = tuple(batch) if isinstance(batch, (tuple, list)) \
                else (batch,)
            seeds = self._draw_seeds() if train else {}
            h = None
            if self.is_first:
                h = self._run_layers(pro, self._to_device(parts[0]), seeds)
                x = h.detach()
            else:
                x = self._recv_act()
            y = self._tick("fwd" if train else "eval", x, seeds=seeds)
            kept.append((x, h, seeds))
            if not self.is_last:
                self._send_act(y)
                continue
            labels = self._to_device(parts[-1])
            if train:
                y.requires_grad_(True)
            out = self._run_layers(epi, y, seeds)
            loss = loss_fn(out, labels) if loss_fn is not None else out
            if train:
                if loss.dim() != 0:
                    raise RuntimeError(
                        "last pipeline stage produced a non-scalar output "
                        "and no loss_fn was given")
                (loss / M).backward()
                kept[-1] += (y.grad,)
            losses.append(loss.detach())
        if train:
            for m, entry in enumerate(kept):
                x, h, seeds = entry[:3]
                dy = entry[3] if self.is_last else p2p.recv(
                    torch.empty_like(x), self.stage_id + 1)
                dx = self._tick("bwd", x, dy, seeds=seeds)
                if not self.is_first:
                    p2p.send(dx, self.stage_id - 1)
                elif h.requires_grad:
                    torch.autograd.backward(h, dx)
        self.agg_loss = self._reduce_loss(losses)
        if train:
            self._step_batch()

    @torch.no_grad()
    def _step_batch(self):
        """The step (module docstring): the accumulated gradients as the
        stacked leaves' ``.grad``, their data-group mean, the clipped
        update; the accumulators are zeroed for the next batch."""
        for p, acc in zip(self.module.stacked(), self._acc):
            p.grad = acc
        self.allreduce_gradients()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params]
        self._update(grads, 1.0)
        self.zero_grad()
        for acc in self._acc:
            acc.zero_()

    def _step_params(self, grads):
        return ([self._shard(i, p.data) for i, p in enumerate(self._params)],
                [self._shard(i, g) for i, g in enumerate(grads)])

    def _publish(self):
        full = self._gather([self._shard(i, p.data)
                             for i, p in enumerate(self._params)])
        for i, f in full.items():
            self._params[i].data.copy_(f)

    # ----------------------------------------------------- checkpoints

    def _leaf_full(self, idx, i, tensors):
        slot = self._slot.get(idx)
        if slot is None:
            return super()._leaf_full(idx, i, tensors)
        t = tensors[i]
        if t.shape != self._params[i].shape:
            # A ZeRO-1 moment shard: a list's shards gathered once per save.
            if self._full_cache is None:
                self._full_cache = {}
            if id(tensors) not in self._full_cache:
                self._full_cache[id(tensors)] = self._gather(tensors)
            t = self._full_cache[id(tensors)][i]
        return t[slot].detach().float()

    def _set_leaf(self, idx, i, tensors, full):
        slot = self._slot.get(idx)
        if slot is None:
            return super()._set_leaf(idx, i, tensors, full)
        dst = tensors[i][slot]
        d = self._zero_dims[i]
        if d is not None and dst.shape != full.shape:
            full = mesh_lib.shard_slice(full, d - 1, self.dp_rank,
                                        self.dp_world_size)
        dst.copy_(full)

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        try:
            return super().save_checkpoint(save_dir, tag, client_state,
                                           save_latest)
        finally:
            self._full_cache = None

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        **kwargs):
        """The interpreter's load; a checkpoint without a file for one of
        this stage's blocks raises ValueError (the JAX engine's check)."""
        if tag is None:
            latest = os.path.join(load_dir, "latest")
            if not os.path.isfile(latest):
                return None, None
            with open(latest) as fd:
                tag = fd.read().strip()
        ckpt_dir = os.path.join(load_dir, str(tag))
        missing = [idx for idx in self.module.block_idx if not os.path.exists(
            self.pipe_module.ckpt_layer_path(ckpt_dir, idx))]
        if missing and self.module.leaf_names:
            raise ValueError(
                "cannot load checkpoint {}: missing layer file(s) for "
                "pipelined block layer(s) {} (expected {})".format(
                    ckpt_dir, missing, self.pipe_module.ckpt_layer_path(
                        ckpt_dir, missing[0])))
        return super().load_checkpoint(
            load_dir, tag, load_optimizer_states=load_optimizer_states,
            **kwargs)

