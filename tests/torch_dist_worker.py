"""Rank process of the port's multi-process tests (gloo on the CPU).

Started once per rank by ``deepspeed_tpu_torch.launcher.launch``, which
sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT:

    python -m deepspeed_tpu_torch.launcher.launch --world_info=<b64> \\
        tests/torch_dist_worker.py <dir>

``<dir>/spec.pkl`` lists the tasks; the rendezvous is a FileStore in
``<dir>`` (each test its own, so parallel test files never share a port),
and every process group has a 60 s timeout. Each rank writes
``<dir>/result_<rank>.pkl``: {task name: result}. It imports torch and the
port only (no JAX).

``run_ranks`` (or ``start_ranks`` and ``wait_ranks``, for the tests)
writes the spec, starts the launcher and returns every rank's results,
killing the launch at its timeout.
"""

import base64
import json
import os
import pickle
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 60


def start_ranks(n, tasks, workdir):
    """Start ``n`` ranks through the port's launcher on ``tasks`` (a list
    of dicts with "name" and "kind"); returns the launcher's process for
    ``wait_ranks``."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "spec.pkl"), "wb") as f:
        pickle.dump({"tasks": tasks}, f)
    info = base64.urlsafe_b64encode(json.dumps(
        {"localhost": list(range(n))}).encode()).decode()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
         "--world_info={}".format(info), "--master_port=1",
         os.path.join(REPO, "tests", "torch_dist_worker.py"), workdir],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    proc.n, proc.workdir = n, workdir
    return proc


def wait_ranks(proc, timeout=150):
    """Every rank's results of a ``start_ranks`` launch, in rank order.
    Raises on a failed rank; kills the launch and raises at ``timeout``
    seconds."""
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError("ranks failed ({}):\n{}".format(
            proc.returncode, err[-6000:]))
    out = []
    n, workdir = proc.n, proc.workdir
    for r in range(n):
        with open(os.path.join(workdir, "result_{}.pkl".format(r)),
                  "rb") as f:
            out.append(pickle.load(f))
    return out


def run_ranks(n, tasks, workdir, timeout=150):
    """``start_ranks`` then ``wait_ranks``."""
    return wait_ranks(start_ranks(n, tasks, workdir), timeout=timeout)


# ----------------------------------------------------------- rank side


def _model(task):
    import torch

    from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
    from deepspeed_tpu_torch.models.simple import LinearStack, SimpleModel

    kind = task["model"]
    device = task.get("device", "cpu")
    if kind == "linear":
        return LinearStack(device=device, **task["dims"])
    if kind == "gpt2":
        cfg = GPT2Config(dtype=torch.float32, **task["gpt2_cfg"],
                         **task.get("cfg", {})) if "gpt2_cfg" in task else \
            GPT2Config.tiny(dtype=torch.float32, **task.get("cfg", {}))
        return GPT2LMHeadModel(cfg, device=device, seed=None)
    if kind == "bert":
        from deepspeed_tpu_torch.models.bert import (BertConfig,
                                                     BertForPreTraining)
        return BertForPreTraining(BertConfig.tiny(dtype=torch.float32,
                                                  **task["cfg"]),
                                  device=device, seed=None)
    if kind == "embed":
        return EmbedModel()
    if kind == "simple":
        return SimpleModel(task["hidden"], device="cpu")
    raise ValueError(kind)


class EmbedModel(object):
    """Built lazily (torch is imported in the rank only)."""

    def __new__(cls, vocab=64, dim=16):
        import torch
        import torch.nn.functional as F
        from torch import nn

        from deepspeed_tpu_torch.models.simple import Dense

        class _Embed(nn.Module):
            def __init__(self):
                super().__init__()
                self.embedding = nn.Parameter(torch.zeros(vocab, dim),
                                              requires_grad=False)

        class _EmbedModel(nn.Module):
            """The JAX CSR test's EmbedModel under the flax names: an
            embedding table ("embed"), the tokens' mean, a Dense head
            ("Dense_0") and the cross-entropy loss."""

            def __init__(self):
                super().__init__()
                self.embed = _Embed()
                self.Dense_0 = Dense(dim, vocab, device="cpu",
                                     generator=torch.Generator())

            def forward(self, ids, y):
                h = self.embed.embedding[ids.long()].mean(dim=1)
                logp = F.log_softmax(self.Dense_0(h), dim=-1)
                return -logp.gather(-1, y.long()[:, None])[:, 0].mean()

        return _EmbedModel()


def _local(batch, rank, world):
    """Rank ``rank``'s rows of a global micro-batch."""
    n = batch[0].shape[0] // world
    return tuple(x[rank * n:(rank + 1) * n] for x in batch)


def _held_grads(z):
    """The shapes of the gradients a rank holds after its boundary
    backward: the reduced shard (stages 2-3) or the whole accumulated
    gradient (stage 1)."""
    return [tuple((g if g is not None else a).shape)
            for g, a in zip(z.grad, z.acc)]


def task_train(task, rank, world):
    """Train ``task["model"]`` from the flax tree ``task["params"]`` on the
    global micro-batches ``task["batches"]`` (each rank its rows): the
    data group's mean loss per micro-step, the shard shapes (gradients
    at the first boundary backward, moments and parameter shards after
    the first step), the stage-3 gathers per micro-step, the full fp32
    masters at the end, and an optional checkpoint save/load."""
    import torch
    import torch.distributed as dist

    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.ops.transformer.kernels import attention as at
    from deepspeed_tpu_torch.parallel import comm
    from deepspeed_tpu_torch.runtime import engine as engine_mod

    device = task.get("device", "cpu")
    engine, _, _, _ = tds.initialize(
        model=_model(task), model_parameters=task["params"],
        config_params=task["config"], device=device)
    at.reset_launches()
    if task.get("fp32_compute"):
        engine.compute_dtype = torch.float32
    out = {"losses": [], "gathers": [], "names": list(engine._names)}
    if task.get("load"):
        engine.load_checkpoint(task["load"])
    engine_mod.pg_correctness_test = bool(task.get("pg"))
    if task.get("pg_corrupt"):
        # A partitioner fault: one leaf's reduced gradient doubled.
        real = engine._reduce_partitioned

        def corrupt():
            grads = real()
            grads[0].mul_(2.0)
            return grads

        engine._reduce_partitioned = corrupt
    try:
        for i, batch in enumerate(task["batches"]):
            if task.get("save") and i == task["save_after"]:
                engine.save_checkpoint(task["save"], tag="ck")
                out["saved_at"] = engine.global_steps
            local = tuple(torch.from_numpy(np.asarray(x)).to(device)
                          for x in _local(batch, rank, world))
            before = engine.zero_gathers()
            boundary = engine.is_gradient_accumulation_boundary()
            comm.reset_stats()
            loss = engine(*local)
            engine.backward(loss)
            reduced = comm.stats["all_reduce"] + comm.stats["reduce_scatter"]
            if boundary and engine._zero is not None and "grad" not in out:
                out["grad"] = _held_grads(engine._zero)
            engine.step()
            out.setdefault("reductions", []).append(
                comm.stats["all_reduce"] + comm.stats["reduce_scatter"])
            out.setdefault("backward_reductions", []).append(reduced)
            out.setdefault("all_gathers", []).append(
                comm.stats["all_gather"])
            out["gathers"].append(engine.zero_gathers() - before)
            mean = comm.all_reduce(loss.detach().float().reshape(1).clone(),
                                   engine.dp_group, mean=True)
            out["losses"].append(float(mean))
            if boundary and engine._zero is not None and "moment" not in out:
                out["moment"] = [tuple(m.shape)
                                 for m in engine.opt_state["exp_avg"]]
                if engine._zero.param_shards is not None:
                    out["param"] = [tuple(s.shape)
                                    for s in engine._zero.param_shards]
    except RuntimeError as e:
        if not task.get("pg_corrupt"):
            raise
        out["error"] = str(e)
        return out
    finally:
        engine_mod.pg_correctness_test = False
    fulls = engine._zero.full_masters() if engine._zero is not None else \
        [p.detach().float() for p in engine._params]
    out["masters"] = {n: f.cpu().numpy().copy()
                      for n, f in zip(engine._names, fulls)}
    out["launches"] = dict(at.launches)
    out["skipped"] = engine.skipped_steps
    out["dp_rank"] = engine.dp_rank
    if engine._offload is not None:
        out["host_elems"] = engine._offload.total
        out["optimizer"] = type(engine.optimizer).__name__
    dist.barrier()
    return out


def task_env(task, rank, world):
    """The launcher's environment contract and a real all-reduce."""
    import torch
    import torch.distributed as dist

    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
            "CUDA_VISIBLE_DEVICES")
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    return {"env": {k: os.environ.get(k) for k in keys},
            "argv": sys.argv[1:], "sum": float(t), "backend":
            dist.get_backend()}


def task_collectives(task, rank, world):
    """parallel/comm.py's reduce-scatter and all-gather on this rank's
    numbers, and the sparse exchange on both of its paths."""
    import torch
    import torch.distributed as dist

    from deepspeed_tpu_torch.parallel import comm
    from deepspeed_tpu_torch.runtime.csr_tensor import (CSRTensor,
                                                        csr_allreduce,
                                                        pad_csr,
                                                        sparse_grad_exchange)

    group = dist.group.WORLD
    flat = torch.arange(world * 3, dtype=torch.float32) * (rank + 1)
    rs = comm.reduce_scatter(flat.clone(), group, mean=True)
    ag = comm.all_gather(torch.full((2,), float(rank)), group)
    g = torch.from_numpy(task["grads"][rank])
    csr = CSRTensor(g)
    idx, val = pad_csr(csr.indices, csr.values, task["k"])
    idx, val = csr_allreduce(idx, val, group)
    merged = CSRTensor(indices=idx, values=val, dense_size=g.shape)
    return {"rs": rs.numpy(), "ag": ag.numpy(),
            "sparse": sparse_grad_exchange(g, group, task["k"]).numpy(),
            "dense_k": sparse_grad_exchange(g, group, 1).numpy(),
            "csr": merged.to_dense().numpy()}


def task_freed(task, rank, world):
    """A dropped stage-3 engine (and its partition, whose gradient hooks
    live on the parameters) is freed by the cycle collector."""
    import gc
    import weakref

    import torch

    import deepspeed_tpu_torch as tds

    engine, _, _, _ = tds.initialize(
        model=_model(task), model_parameters=task["params"],
        config_params=task["config"], device="cpu")
    ids = torch.from_numpy(task["batches"][0][0][rank::world])
    engine.train_batch((ids, ids))
    refs = [weakref.ref(engine), weakref.ref(engine._zero)]
    del engine
    gc.collect()
    return [r() is None for r in refs]


def _tied_embed(vocab=16, dim=8, device="cpu", seed=0):
    """The JAX pipeline test's TiedEmbed under the flax name: token ids
    look up ``embedding`` rows, float inputs project onto them."""
    import torch
    from torch import nn

    class TiedEmbed(nn.Module):
        def __init__(self):
            super().__init__()
            g = torch.Generator()
            g.manual_seed(seed)
            self.embedding = nn.Parameter(
                torch.randn(vocab, dim, generator=g) * 0.1,
                requires_grad=False)

        def forward(self, x):
            if not x.is_floating_point():
                return self.embedding[x.long()]
            return x @ self.embedding.t()

    return TiedEmbed()


def _project(layer, x):
    return x @ layer.embedding.t()


def pipe_module(task, num_stages):
    """The port's PipelineModule of ``task["layers"]``: the JAX pipeline
    tests' DenseRelu stack, its tied-embedding stack, or tiny GPT-2's
    ``gpt2_pipeline``."""
    import torch

    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, gpt2_pipeline
    from deepspeed_tpu_torch.models.simple import DenseOut, DenseRelu, \
        ce_loss
    from deepspeed_tpu_torch.pipe import (LayerSpec, PipelineModule,
                                          TiedLayerSpec)

    kind = task["layers"]
    compiled = task.get("compiled", False)
    if kind == "gpt2":
        cfg = GPT2Config(dtype=torch.float32, **task["gpt2_cfg"]) \
            if "gpt2_cfg" in task else \
            GPT2Config.tiny(dtype=torch.float32, use_flash_attention=True)
        return gpt2_pipeline(cfg, num_stages=num_stages,
                             tied=task.get("tied", not compiled),
                             compiled=compiled)
    if kind == "uniform":
        # The compiled-pipeline tests' stack: n_blocks identical DenseRelu
        # blocks and a DenseOut head.
        layers = [LayerSpec(DenseRelu, 32) for _ in range(task["n_blocks"])]
        layers.append(LayerSpec(DenseOut, 8, in_features=32))
    elif kind == "tied":
        fn = _project if task.get("forward_fn") else None
        layers = [TiedLayerSpec("embed", _tied_embed),
                  LayerSpec(DenseRelu, 8, in_features=8),
                  TiedLayerSpec("embed", _tied_embed, forward_fn=fn)]
    else:
        layers = [LayerSpec(DenseRelu, 32, in_features=16),
                  LayerSpec(DenseRelu, 32), LayerSpec(DenseRelu, 32),
                  LayerSpec(DenseOut, 8, in_features=32)]
    module = PipelineModule(
        layers=layers, num_stages=num_stages, loss_fn=ce_loss,
        seed_layers=True, base_seed=42, partition_method="uniform",
        activation_checkpoint_interval=task.get("remat", 0),
        compiled=compiled)
    module.tp_rules = task.get("tp_rules")
    return module


def _mine(batch, rank, world):
    return tuple(np.asarray(x)[rank * (len(x) // world):
                               (rank + 1) * (len(x) // world)]
                 for x in batch)


def task_pipe(task, rank, world):
    """Train ``pipe_module(task)`` over ``task["stages"]`` stages (x
    ``task.get("mp", 1)`` model ranks, the rest data ranks) from the
    per-layer trees ``task["params"]``: the loss of each step (each step
    ``gas`` global micro-batches of ``task["batches"]``, each data rank
    its rows), then optionally an eval loss with the parameters checked
    unchanged, an injected overflow step, a checkpoint saved or loaded,
    and each layer's full fp32 parameters."""
    import torch
    import torch.distributed as dist

    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.ops.transformer.kernels import attention as at
    from deepspeed_tpu_torch.parallel.mesh import build_mesh

    stages, mp = task["stages"], task.get("mp", 1)
    mesh = build_mesh(num_pp=stages, num_mp=mp)
    engine, _, _, _ = tds.initialize(
        model=pipe_module(task, stages), model_parameters=task["params"],
        config_params=task["config"], device=task.get("device", "cpu"),
        mesh=mesh)
    at.reset_launches()
    dp, dp_rank = engine.dp_world_size, engine.dp_rank
    gas = engine.micro_batches
    out = {"losses": [], "stage": engine.stage_id}
    if task.get("load"):
        path, _ = engine.load_checkpoint(task["load"])
        out["loaded"] = path is not None
        out["loaded_steps"] = engine.global_steps
    batches = [_mine(b, dp_rank, dp) for b in task["batches"]]
    if task.get("onebit_capture"):
        out["onebit"] = _capture_frozen_update(engine.optimizer)
    from deepspeed_tpu_torch.parallel import comm
    from deepspeed_tpu_torch.runtime.pipe import p2p
    for step in range(task["steps"]):
        if task.get("save") and step == task["save_after"]:
            engine.save_checkpoint(task["save"], tag="ck")
        chunk = batches[step * gas:(step + 1) * gas]
        before = dict(comm.stats)
        p2p.reset_stats()
        out["losses"].append(engine.train_batch(data_iter=iter(chunk)))
        out.setdefault("step_stats", []).append(_stats_delta(before))
        out.setdefault("p2p", []).append(
            {k: (dict(v) if isinstance(v, dict) else v)
             for k, v in p2p.stats.items()})
    if task.get("eval"):
        before = [p.detach().clone() for p in engine._params]
        out["eval"] = engine.eval_batch(iter(batches[:gas]))
        out["eval_unchanged"] = all(torch.equal(a, p) for a, p in
                                    zip(before, engine._params))
    if task.get("overflow"):
        before = [p.detach().clone() for p in engine._params]
        scale, skipped = engine.loss_scaler.loss_scale, engine.skipped_steps
        if engine.stage_id == 0:
            for p in engine._params:
                p.grad = torch.full_like(p, float("inf"))
        engine._exec_optimizer_step(None)
        out["overflow"] = {
            "skipped": engine.skipped_steps - skipped,
            "scale_down": engine.loss_scaler.loss_scale < scale,
            "unchanged": all(torch.equal(a, p) for a, p in
                             zip(before, engine._params)),
            "grads_cleared": all(p.grad is None for p in engine._params)}
    if task.get("save_end"):
        engine.save_checkpoint(task["save_end"], tag="end")
    layers = {}
    for idx in sorted(engine._layer_params):
        if engine._layer_params[idx]:
            layers[idx] = engine._layer_full(idx, engine._params)
    out["layers"] = layers
    out["shards"] = {n: tuple(p.shape) for n, p in zip(engine._names,
                                                       engine._params)}
    if engine.opt_state is not None:
        out["moments"] = {n: tuple(m.shape) for n, m in zip(
            engine._names, engine.opt_state["exp_avg"])}
    if task.get("eval_twice"):
        out["evals"] = [engine.eval_batch(iter(batches[:gas]))
                        for _ in range(2)]
    out["graphs"] = (getattr(engine, "graph_captures", None),
                     getattr(engine, "graph_replays", None))
    out["launches"] = dict(at.launches)
    dist.barrier()
    return out


def _capture_frozen_update(opt):
    """A dict that gets, at 1-bit Adam's first compressed update, the
    parameters, gradients and moments before it and the parameters after
    it (numpy, in the update's parameter order)."""
    cap = {}
    real = opt.update

    def spy(params, grads, state, **kw):
        first = opt.adam_freeze_key and "before" not in cap
        if first:
            cap.update(
                before=[p.detach().float().numpy().copy() for p in params],
                grads=[g.detach().float().numpy().copy() for g in grads],
                m=[m.numpy().copy() for m in state["exp_avg"]],
                v=[v.numpy().copy() for v in state["exp_avg_sq"]])
        real(params, grads, state, **kw)
        if first:
            cap["after"] = [p.detach().float().numpy().copy()
                            for p in params]

    opt.update = spy
    return cap


def task_tp(task, rank, world):
    """Train tiny GPT-2 on a grid of ``task["mp"]`` model x the rest data
    ranks from the flax tree ``task["params"]`` (each data rank its rows of
    every global micro-batch): per-step losses (the data group's mean), the
    shard shapes of every leaf, the full fp32 masters, the collective
    counts of one step, and optional checkpoints."""
    import torch
    import torch.distributed as dist

    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
    from deepspeed_tpu_torch.ops.transformer.kernels import attention as at
    from deepspeed_tpu_torch.parallel import comm
    from deepspeed_tpu_torch.parallel.mesh import build_mesh

    device = task.get("device", "cpu")
    cfg = GPT2Config(dtype=torch.float32, **task["gpt2_cfg"]) \
        if "gpt2_cfg" in task else GPT2Config.tiny(dtype=torch.float32)
    mesh = build_mesh(num_mp=task["mp"])
    engine, _, _, _ = tds.initialize(
        model=GPT2LMHeadModel(cfg, device=device, seed=None),
        model_parameters=task["params"], config_params=task["config"],
        device=device, mesh=mesh)
    engine.compute_dtype = torch.float32
    at.reset_launches()
    out = {"losses": [], "mp_rank": engine.mp_rank, "dp_rank": engine.dp_rank}
    if task.get("load"):
        path, _ = engine.load_checkpoint(task["load"])
        out["loaded"] = path is not None
    dp = engine.dp_world_size
    for i, batch in enumerate(task["batches"]):
        if task.get("save") and i == task["save_after"]:
            engine.save_checkpoint(task["save"], tag="ck")
        local = tuple(torch.from_numpy(x).to(device) for x in
                      _mine(batch, engine.dp_rank, dp))
        comm.reset_stats()
        loss = engine(*local)
        engine.backward(loss)
        engine.step()
        out.setdefault("all_reduces", []).append(comm.stats["all_reduce"])
        mean = loss.detach().float().reshape(1).clone()
        if dp > 1:
            comm.all_reduce(mean, engine.dp_group, mean=True)
        out["losses"].append(float(mean))
    out["shards"] = {n: tuple(p.shape) for n, p in zip(engine._names,
                                                       engine._params)}
    if engine._zero is not None:
        out["zero_shards"] = {n: tuple(m.shape) for n, m in zip(
            engine._names, engine._zero.master)}
    out["masters"] = {n: f.cpu().numpy().copy() for n, f in
                      zip(engine._names, engine._full_masters())}
    out["local"] = {n: p.detach().float().cpu().numpy().copy()
                    for n, p in zip(engine._names, engine._params)} \
        if engine._zero is None else None
    out["launches"] = dict(at.launches)
    dist.barrier()
    return out


def task_tp_offload(task, rank, world):
    """ZeRO-Offload over ``world`` model ranks: two steps' losses, the host
    master's elements and the rank's and the full model's."""
    import torch

    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
    from deepspeed_tpu_torch.parallel.mesh import build_mesh

    cfg = GPT2Config.tiny(dtype=torch.float32)
    model = GPT2LMHeadModel(cfg, device="cpu", seed=None)
    full = sum(p.numel() for p in model.parameters())
    engine = tds.initialize(
        model=model, model_parameters=task["params"], device="cpu",
        mesh=build_mesh(num_mp=world),
        config_params={"train_batch_size": 2, "bf16": {"enabled": True},
                       "optimizer": {"type": "Adam",
                                     "params": {"lr": 1e-3}},
                       "zero_optimization": {"stage": 2,
                                             "cpu_offload": True}})[0]
    ids = torch.from_numpy(np.asarray(task["ids"]))
    losses = [float(engine.train_batch((ids, ids))) for _ in range(2)]
    return {"losses": losses, "host_elems": engine._offload.total,
            "local_elems": sum(p.numel() for p in engine._params),
            "full_elems": full}


def _stats_delta(before):
    from deepspeed_tpu_torch.parallel import comm
    return {k: comm.stats[k] - before.get(k, 0) for k in comm.stats}


def task_ring(task, rank, world):
    """Ring or Ulysses attention on each case of ``task["cases"]`` (global
    q, k, v, dO and an optional key mask, numpy): this rank's shard of the
    output and of dq, dk, dv, the collectives it ran, or the error it
    raised. A case's grid is ``sp`` seq ranks x the rest data ranks (the
    batch split over 'data')."""
    import torch

    from deepspeed_tpu_torch.ops.transformer import ring_attention as ra
    from deepspeed_tpu_torch.parallel import comm, sequence_parallel
    from deepspeed_tpu_torch.parallel.mesh import build_mesh, shard_batch

    from deepspeed_tpu_torch.ops.transformer.kernels import attention as at

    device = task.get("device", "cpu")
    dtype = getattr(torch, task.get("dtype", "float32"))
    meshes = {}
    out = {}
    for case in task["cases"]:
        sp = case["sp"]
        if sp not in meshes:
            meshes[sp] = build_mesh(num_sp=sp)
        mesh = meshes[sp]
        ctx = sequence_parallel.context(mesh)

        def mine(x):  # [B, H, T, D]: batch over 'data', T over 'seq'
            return torch.from_numpy(np.ascontiguousarray(np.swapaxes(
                shard_batch(np.swapaxes(x, 1, 2), mesh), 1, 2))).to(
                    device, dtype)

        q, k, v, do = (mine(case[n]).requires_grad_(n != "do")
                       for n in ("q", "k", "v", "do"))
        mask = None if case.get("mask") is None else torch.from_numpy(
            np.ascontiguousarray(shard_batch(case["mask"], mesh))).to(device)
        before = dict(comm.stats)
        at.reset_launches()
        try:
            fn = ra.get_sp_attention(case["mode"])
            o = fn(q, k, v, ctx, causal=case["causal"], mask=mask)
            fwd = _stats_delta(before)
            grads = torch.autograd.grad(o, (q, k, v), do)
        except ValueError as e:
            out[case["name"]] = {"error": str(e)}
            continue
        out[case["name"]] = {
            "o": o.detach().float().cpu().numpy(),
            "grads": [g.float().cpu().numpy() for g in grads],
            "fwd": fwd, "all": _stats_delta(before),
            "launches": dict(at.launches),
            "dp_rank": mesh.dp_rank, "sp_rank": mesh.sp_rank}
    if task.get("helper"):
        ctx = sequence_parallel.context(meshes[task["helper"]["sp"]])
        h = task["helper"]
        out["helper"] = ra.sequence_parallel_attention(
            ctx, *(torch.from_numpy(h[n]) for n in ("q", "k", "v")),
            causal=True, mode=h["mode"]).numpy()
    return out


def task_sp_train(task, rank, world):
    """Train ``task["model"]`` (tiny GPT-2 or BERT, fp32) through
    ``initialize`` with ``task["config"]`` (its sequence_parallel block
    shapes the grid) from the flax tree ``task["params"]``: each rank passes
    its data rank's rows of each global micro-batch of ``task["batches"]``.
    Returns the losses (``train_batch``'s, or with ``micro`` the forward's
    loss per micro-step), the reduced gradients of the first update, the
    full masters, the collectives of one step, an eval loss, or the error
    ``initialize``/the forward raised."""
    import torch
    import torch.distributed as dist

    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.parallel import comm
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    from deepspeed_tpu_torch.runtime import engine as engine_mod

    kw = {}
    if task.get("mesh"):
        kw["mesh"] = build_mesh(**task["mesh"])
    out = {}
    try:
        engine, _, _, _ = tds.initialize(
            model=_model(task), model_parameters=task["params"],
            config_params=task["config"], device=task.get("device", "cpu"),
            **kw)
    except (ValueError, NotImplementedError) as e:
        dist.barrier()
        return {"error": str(e)}
    if task.get("fp32_compute"):
        engine.compute_dtype = torch.float32
    real = engine._update

    def spy(grads, inv_scale, skip=()):
        if "grads" not in out:
            out["grads"] = {n: (g.detach().float() * inv_scale).cpu()
                            .numpy().copy()
                            for n, g in zip(engine._names, grads)}
        return real(grads, inv_scale, skip)

    engine._update = spy
    engine_mod.pg_correctness_test = bool(task.get("pg"))
    dp, dp_rank = engine.dp_world_size, engine.dp_rank
    losses = []
    try:
        for i, batch in enumerate(task["batches"]):
            local = tuple(None if x is None else torch.from_numpy(
                np.ascontiguousarray(_mine((x,), dp_rank, dp)[0]))
                for x in batch)
            before = dict(comm.stats)
            if task.get("micro"):
                loss = engine(*local)
                engine.backward(loss)
                engine.step()
                losses.append(float(comm.all_reduce(
                    loss.detach().reshape(1).clone(), engine.dp_group,
                    mean=True)) if dp > 1 else float(loss))
            else:
                losses.append(float(engine.train_batch(local)))
            if i == 0:
                out["step_stats"] = _stats_delta(before)
    except (ValueError, NotImplementedError) as e:
        out["error"] = str(e)
        dist.barrier()
        return out
    finally:
        engine_mod.pg_correctness_test = False
    out["losses"] = losses
    out["skipped"] = engine.skipped_steps
    out["masters"] = {n: f.cpu().numpy().copy() for n, f in
                      zip(engine._names, engine._full_masters())}
    out["coords"] = (engine.dp_rank, engine.sp_rank, engine.sp_world_size)
    if task.get("eval"):
        engine.eval()
        e = task["eval"]
        loss = engine(*(torch.from_numpy(_mine((x,), dp_rank, dp)[0])
                        for x in e))
        out["eval"] = float(loss)
        engine.train()
    if task.get("save"):
        engine.save_checkpoint(task["save"], tag="sp")
    dist.barrier()
    return out


def task_compressed(task, rank, world):
    """``compressed_allreduce_many`` of this rank's rows of
    ``task["buffers"]`` (a list of [W, n] arrays) with its error rows; the
    averages, the new errors and the collectives it ran."""
    import torch
    import torch.distributed as dist

    from deepspeed_tpu_torch.parallel import comm
    from deepspeed_tpu_torch.runtime.custom_collectives import (
        compressed_allreduce_many)

    def rows(key):
        return [torch.from_numpy(a[rank].copy()).to(task.get("device", "cpu"))
                for a in task[key]]

    before = dict(comm.stats)
    bufs, we, se = rows("buffers"), rows("worker_errors"), \
        rows("server_errors")
    outs, we, se = compressed_allreduce_many(bufs, we, se, dist.group.WORLD)
    result = {"out": [o.cpu().numpy() for o in outs],
              "we": [w.cpu().numpy() for w in we],
              "se": [x.cpu().numpy() for x in se],
              "stats": _stats_delta(before)}
    # Repeats of the same buffers with the errors fed back: the running
    # mean of the outputs.
    total = [o.clone() for o in outs]
    for _ in range(task.get("repeats", 1) - 1):
        outs, we, se = compressed_allreduce_many(bufs, we, se,
                                                 dist.group.WORLD)
        total = [t + o for t, o in zip(total, outs)]
    result["mean_out"] = [(t / task.get("repeats", 1)).cpu().numpy()
                          for t in total]
    return result


def task_onebit(task, rank, world):
    """1-bit Adam through ``initialize`` over every rank as data ranks:
    SimpleModel (``task["hidden"]``) or tiny GPT-2 from ``task["params"]``,
    each rank its rows of each global batch; per step the loss, the phase
    flag, and the collectives by kind; the full masters and the error
    buffers at the end; optional save and load."""
    import torch
    import torch.distributed as dist

    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.parallel import comm

    model = _model(task)
    engine, _, _, _ = tds.initialize(
        model=model, model_parameters=task.get("params"),
        config_params=task["config"], device=task.get("device", "cpu"))
    if task.get("fp32_compute"):
        engine.compute_dtype = torch.float32
    out = {"losses": [], "stats": [], "frozen": [],
           "eligible": engine._onebit_eligible()}
    if task.get("load"):
        path, _ = engine.load_checkpoint(task["load"], tag=task.get("tag"))
        out["loaded"] = path is not None
        out["after_load"] = (engine.optimizer.adam_freeze_key,
                             engine.enable_backward_allreduce)
    dp = engine.dp_world_size
    for i, batch in enumerate(task["batches"]):
        if task.get("save") and i == task["save_after"]:
            engine.save_checkpoint(task["save"], tag="ck")
        local = tuple(torch.from_numpy(np.ascontiguousarray(x))
                      for x in _mine(batch, engine.dp_rank, dp))
        before = dict(comm.stats)
        out["losses"].append(float(engine.train_batch(local)))
        out["stats"].append(_stats_delta(before))
        out["frozen"].append((engine.optimizer.adam_freeze_key,
                              engine.enable_backward_allreduce))
    if task.get("save_end"):
        engine.save_checkpoint(task["save_end"], tag="end")
    out["masters"] = {n: p.detach().float().cpu().numpy().copy()
                      for n, p in zip(engine._names, engine._params)}
    out["errors"] = {k: [t.cpu().numpy().copy() for t in engine.opt_state[k]]
                     for k in ("worker_error", "server_error")}
    out["step"] = engine.opt_state["step"]
    if task.get("rollback"):
        # Back to an earlier checkpoint under its own schedule.
        engine.optimizer.freeze_step = task["rollback"]["freeze_step"]
        engine.load_checkpoint(task["rollback"]["load"])
        out["after_rollback"] = (engine.optimizer.adam_freeze_key,
                                 engine.enable_backward_allreduce)
    dist.barrier()
    return out


def task_ckpt_partition(task, rank, world):
    """``checkpointing.checkpoint`` with ``partition_activations`` over a
    model group of ``world`` ranks: each rank's gradients through the
    checkpointed segment and through the plain one, the shapes the segment
    saved, and the all-gathers its backward ran."""
    import torch

    from deepspeed_tpu_torch.parallel import comm
    from deepspeed_tpu_torch.parallel.mesh import build_mesh
    from deepspeed_tpu_torch.runtime.activation_checkpointing import (
        checkpointing)

    mesh = build_mesh(num_mp=world)
    checkpointing.configure(partition_activations=True, mesh_=mesh)
    x, w = (torch.from_numpy(task[k]) for k in ("x", "w"))

    def seg(x, w):
        return torch.tanh(x @ w).square().sum()

    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    out = {}
    for name, fn in (("plain", seg),
                     ("ckpt", lambda a, b: checkpointing.checkpoint(seg, a,
                                                                    b))):
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        saved.clear()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = fn(xs, ws)
        before = dict(comm.stats)
        loss.backward()
        out[name] = {"grads": [xs.grad.numpy(), ws.grad.numpy()],
                     "saved": list(saved),
                     "gathers": comm.stats["all_gather"] -
                     before.get("all_gather", 0)}
    checkpointing.configure(partition_activations=False)
    return out


def _serve_engine(task, case, mesh):
    """This rank's serving engine of ``case`` (a dict: ``config`` and,
    for MoE, ``moe``) over ``mesh``."""
    import torch

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference import InferenceEngine
    from deepspeed_tpu_torch.inference.adapters import MoEAdapter
    from deepspeed_tpu_torch.models import GPT2Config

    if "moe" in case:
        adapter = MoEAdapter.from_config(**case["moe"])
        return InferenceEngine(None, task["params"], config=case["config"],
                               device="cpu", adapter=adapter, mesh=mesh)
    return init_inference(GPT2Config.tiny(dtype=torch.float32),
                          task["params"], config=case["config"],
                          device="cpu", mesh=mesh)


def task_serve(task, rank, world):
    """Serve every case of ``task["cases"]`` on a grid of ``task["mp"]``
    model x the rest data ranks: each request's tokens, the pool's k/v
    plane shape, ``kv_hbm_bytes``, ``compile_count`` and the MoE gauges;
    a case with ``diverge`` gives rank 1 another prompt and records the
    ``MeshDivergence`` every rank raises; ``refuse`` cases record the
    ValueError each refused composition raises."""
    from deepspeed_tpu_torch.inference import MeshDivergence
    from deepspeed_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(num_mp=task["mp"])
    out = {"mp_rank": mesh.mp_rank, "dp_rank": mesh.dp_rank}
    for case in task["cases"]:
        if case.get("refuse"):
            try:
                eng = _serve_engine(task, case, mesh)
                if "submit" in case:
                    eng.submit(task["prompts"][0], max_new_tokens=2,
                               **case["submit"])
                if "run" in case:
                    eng.run(**case["run"])
                out[case["name"]] = None
            except ValueError as exc:
                out[case["name"]] = str(exc)
            continue
        eng = _serve_engine(task, case, mesh)
        prompts = list(task["prompts"])
        if case.get("diverge") and rank == 1:
            prompts[0] = prompts[0][::-1].copy()
        reqs = [eng.submit(p, max_new_tokens=task["max_new"],
                           **case.get("submit", {})) for p in prompts]
        try:
            eng.run()
            raised = None
        except MeshDivergence as exc:
            raised = str(exc)
        m = eng.metrics()
        out[case["name"]] = {
            "tokens": [r.tokens for r in reqs], "raised": raised,
            "k_shape": tuple(eng._pool["k"].shape),
            "scale_shape": tuple(eng._pool["k_scale"].shape)
            if "k_scale" in eng._pool else None,
            "kv_hbm_bytes": m["kv_hbm_bytes"],
            "compile_count": eng.compile_count,
            "moe": {k: v for k, v in eng.telemetry.snapshot().items()
                    if "moe" in k} if "moe" in case else None,
            "expert_shape": tuple(eng._params.blocks[0].experts.w1.shape)
            if "moe" in case else None,
            "xray_keys": len(eng.perf_xray()["programs"])
            if eng.perf_xray() is not None else None}
    return out


def moe_model(width=16, classes=8, **moe_kw):
    """The JAX ``test_moe_model_trains_with_engine`` model in torch, under
    its flax names: ``Dense_0``, an ``MoE_0`` over [B, 1, width] tokens
    (experts Dense(2 width) -> tanh GELU -> Dense(width), ``_MLP``),
    the residual, ``Dense_1`` to ``classes`` logits; the loss is the mean
    cross-entropy plus 0.01 x the aux loss."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    from deepspeed_tpu_torch.moe import MoE

    class Dense(nn.Module):
        def __init__(self, n_in, n_out):
            super().__init__()
            self.kernel = nn.Parameter(torch.randn(n_in, n_out) * 0.1)
            self.bias = nn.Parameter(torch.zeros(n_out))

        def forward(self, x):
            return x.to(self.kernel.dtype) @ self.kernel + self.bias

    class _MLP(nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = Dense(width, 2 * width)
            self.Dense_1 = Dense(2 * width, width)

        def forward(self, x):
            return self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))

    class MoEModel(nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = Dense(width, width)
            self.MoE_0 = MoE(width, _MLP, **moe_kw)
            self.Dense_1 = Dense(width, classes)

        def forward(self, x, y):
            h = self.Dense_0(x)
            out, l_aux, _ = self.MoE_0(h[:, None, :])
            logits = self.Dense_1(h + out[:, 0])
            gold = logits.gather(1, y.long()[:, None])[:, 0]
            return (torch.logsumexp(logits, dim=-1) - gold).mean() + \
                0.01 * l_aux

    return MoEModel()


def task_moe_train(task, rank, world):
    """Train ``moe_model(**task["moe"])`` from the flax tree
    ``task["params"]`` on a grid of ``task["mp"]`` model x the rest data
    ranks (each data rank its rows of every global batch), after an
    optional checkpoint load: per-step losses (the data group's mean), each
    leaf's shard shape, the full fp32 masters, and an optional checkpoint
    after the last step."""
    import torch

    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.parallel import comm
    from deepspeed_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(num_mp=task["mp"])
    engine, _, _, _ = tds.initialize(
        model=moe_model(**task["moe"]), model_parameters=task["params"],
        config_params=task["config"], device="cpu", mesh=mesh)
    dp = engine.dp_world_size
    out = {"losses": [], "mp_rank": engine.mp_rank,
           "dp_rank": engine.dp_rank}
    if task.get("load"):
        path, _ = engine.load_checkpoint(task["load"], tag="ck")
        out["loaded"] = path is not None
    for batch in task["batches"]:
        x, y = (torch.from_numpy(a) for a in _mine(batch, engine.dp_rank,
                                                   dp))
        loss = engine(x, y)
        engine.backward(loss)
        engine.step()
        mean = loss.detach().float().reshape(1).clone()
        if dp > 1:
            comm.all_reduce(mean, engine.dp_group, mean=True)
        out["losses"].append(float(mean))
    out["shards"] = {n: tuple(p.shape) for n, p in zip(engine._names,
                                                       engine._params)}
    out["masters"] = {n: f.cpu().numpy().copy() for n, f in
                      zip(engine._names, engine._full_masters())}
    if task.get("save"):
        engine.save_checkpoint(task["save"], tag="ck")
    return out


TASKS = {"ckpt_partition": task_ckpt_partition, "serve": task_serve,
         "moe_train": task_moe_train, "train": task_train,
         "env": task_env, "collectives": task_collectives, "freed": task_freed,
         "pipe": task_pipe, "tp": task_tp,
         "tp_offload": task_tp_offload, "ring": task_ring,
         "sp_train": task_sp_train, "compressed": task_compressed,
         "onebit": task_onebit}


def main(workdir):
    import torch

    from deepspeed_tpu_torch.utils.distributed import init_distributed

    torch.set_num_threads(1)
    with open(os.path.join(workdir, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    init_distributed(init_method="file://" + os.path.join(workdir, "store"),
                     timeout=TIMEOUT_S, device="cpu", verbose=False)
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    results = {t["name"]: TASKS[t["kind"]](t, rank, world)
               for t in spec["tasks"]}
    with open(os.path.join(workdir, "result_{}.pkl".format(rank)),
              "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main([a for a in sys.argv[1:] if not a.startswith("--local_rank")][0])
