"""The ZeRO-Offload tier: fp32 masters and optimizer moments in host memory.

Counterpart of the offload part of ``deepspeed_tpu/runtime/engine.py``
(``_init_offload``, ``_get_offload_pre_fn``, ``_offload_chunks``,
``_offload_restore_params``, ``_offload_step`` and the streamed backward's
sink). ``HostOffload`` owns the host state of one engine:

- ``master``, ``m``, ``v``: one flat fp32 buffer per role, the parameters
  laid out in the JAX package's leaf order (its flattening of the flax
  tree: sorted names), so a checkpoint's ``fp32_master`` is the same array
  in either package. ``views(buf)`` gives per-parameter views in the
  engine's order.
- the device parameters, dropped to the compute dtype when the state is
  built (``drop_device_params``).
- ``staging``: pinned buffers, one per gradient dtype, in master layout,
  that the card's gradients are copied into chunk by chunk on a side
  stream (the transfer dtype is the gradients' own: bf16 widens exactly to
  the fp32 the JAX package packs on the host). The compute dtype's is
  allocated, pinned, with the state; the first step's gradients are fp32
  (the state is built at the first step, as in the JAX package) and get a
  pageable buffer of their own, freed when that step ends: pinning it
  would cost more than its one synchronous copy.
- ``out16``: with bf16 compute, a pinned bf16 buffer the C++ Adam/LAMB
  fills with the updated parameters in the same pass (the fused copy);
  the upload stream copies it into the device parameters.
- ``stream_g``: with ``stream_gradients``, the pinned buffer the backward's
  gradient hooks copy each gradient into.

``step`` is the pipelined host step (JAX ``_offload_step``): the gradient
chunks' device-to-host copies are queued on a side stream with an event per
chunk; one long-lived worker thread waits for chunk i+1's event and widens
it to fp32 (streamed: scales it by the unscale-and-clip factor with
``ds_scale``) while the C++ optimizer (ctypes releases the GIL) updates
chunk i; chunk i's updated parameters then go back to the card with
``non_blocking`` copies on an upload stream, overlapping the next chunk's
update. The caller's stream waits for the upload stream before the next
forward. On the CPU (the tests) the same loop runs with plain copies.

LAMB over ranks that each hold a shard of a tensor (the optimizer's
``norm_reduce`` is set): its trust ratio needs the whole tensor's norms, so
the step runs the host op's two passes apart: pass 1 over every chunk (the
moments, the update vector into a host scratch buffer, each tensor's sums
of squares), one ``norm_reduce`` of the step's sums, then pass 2 chunk by
chunk (the ratio-scaled update and the upload).

``ShardedHostOffload`` is the tier over a data group (ZeRO with
``cpu_offload`` over several data ranks): each rank's host state is its
ZeRO partition only (``mesh.zero_partition_dim``, as stages 1-3 partition),
the gradients are reduce-scattered (``reduce``: the group's fp32 mean, the
rank's shard) before their download, the host step updates the shard, the
compute-dtype shard goes back up and the parameters are all-gathered over
the group (``publish``). Under tensor parallelism the leaves are the rank's
model shards (each model rank offloads its own).
"""

import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.op_builder.builder import (flatten_into, float_ptr,
                                                   load_host)
from deepspeed_tpu_torch.parallel import comm
from deepspeed_tpu_torch.parallel.mesh import shard_slice
from deepspeed_tpu_torch.runtime.zero.partition import gather_full, reduce_mean

# fp32 elements per transfer chunk (~16 MB), as in the JAX package.
CHUNK_ELEMS = 4 * 1024 * 1024


def jax_leaf_order(names):
    """Indices of ``names`` ("a.b.c" parameter names) in the order JAX
    flattens the flax tree (dict keys sorted at every level)."""
    return sorted(range(len(names)), key=lambda i: names[i].split("."))


class HostOffload(object):
    """Host state and pipelined step of one engine (module docstring)."""

    def __init__(self, names, params, compute_dtype, grad_dtype=None):
        self.params = params
        self.order = jax_leaf_order(names)
        self.compute_dtype = compute_dtype
        self.device = params[0].device
        self.cuda = self.device.type == "cuda"
        self.sizes = [params[i].numel() for i in self.order]
        self.offsets = [0]
        for size in self.sizes:
            self.offsets.append(self.offsets[-1] + size)
        self.total = self.offsets[-1]
        # Engine index -> (offset, size) in the flat buffers.
        self.span = {i: (self.offsets[j], self.sizes[j])
                     for j, i in enumerate(self.order)}
        # fp32 or fp16 parameters go back to the card from the master
        # itself: pin it for asynchronous copies. bf16 ones from out16.
        self.master = self._host(self.total, torch.float32,
                                 pin=compute_dtype != torch.bfloat16)
        for i in self.order:
            o, n = self.span[i]
            self.master[o:o + n].copy_(params[i].detach().reshape(-1))
        self.m = torch.zeros(self.total, dtype=torch.float32)
        self.v = torch.zeros(self.total, dtype=torch.float32)
        self.out16 = self._host(self.total, torch.bfloat16, pin=True) \
            if compute_dtype == torch.bfloat16 else None
        self.step_count = 0
        # The dtype the gradients arrive in: its staging buffer is pinned.
        self.grad_dtype = grad_dtype or compute_dtype
        self.staging = {self.grad_dtype: self._host(self.total,
                                                    self.grad_dtype,
                                                    pin=True)}
        self._lamb_scratch = None
        self.stream_g = None
        self._chunk_bufs = None
        self.chunks = self._make_chunks()
        self._pool = None
        self._d2h = torch.cuda.Stream(self.device) if self.cuda else None
        self._up = torch.cuda.Stream(self.device) if self.cuda else None
        self._scale_lib = load_host("cpu_adam")
        self._timing = None
        # (start, end) CUDA event pairs of the last step's transfers.
        self._transfers = {"download_s": [], "upload_device_s": []}

    def _host(self, n, dtype, pin):
        return torch.empty(n, dtype=dtype, pin_memory=pin and self.cuda)

    def views(self, buf):
        """Per-parameter views of a flat buffer, in the engine's order."""
        out = [None] * len(self.params)
        for i, (o, n) in self.span.items():
            out[i] = buf[o:o + n].view(self.params[i].shape)
        return out

    def drop_device_params(self):
        """The master lives on the host now: the device parameters drop to
        the compute dtype (JAX ``_init_offload``)."""
        if self.compute_dtype == torch.float32:
            return
        for p in self.params:
            if p.is_floating_point() and p.dtype != self.compute_dtype:
                p.data = p.data.to(self.compute_dtype)

    def _make_chunks(self):
        """Groups of engine indices, ~CHUNK_ELEMS elements each, in master
        order (each chunk one contiguous span of the flat buffers)."""
        chunks, cur, cur_n = [], [], 0
        for j, i in enumerate(self.order):
            cur.append(i)
            cur_n += self.sizes[j]
            if cur_n >= CHUNK_ELEMS:
                chunks.append(cur)
                cur, cur_n = [], 0
        if cur:
            chunks.append(cur)
        return chunks

    def _bounds(self, chunk):
        lo = self.span[chunk[0]][0]
        o, n = self.span[chunk[-1]]
        return lo, o + n

    def _staging(self, dtype):
        buf = self.staging.get(dtype)
        if buf is None:
            buf = self.staging[dtype] = self._host(
                self.total, dtype, pin=dtype == self.grad_dtype)
        return buf

    def _widen(self, ci, src):
        """``src`` as fp32: a view when it already is, else widened into one
        of two chunk buffers (the worker fills one while the optimizer
        reads the other)."""
        if src.dtype == torch.float32:
            return src
        if self._chunk_bufs is None:
            most = max(hi - lo for lo, hi in map(self._bounds, self.chunks))
            self._chunk_bufs = [torch.empty(most, dtype=torch.float32)
                                for _ in range(2)]
        dst = self._chunk_bufs[ci % 2][:src.numel()]
        dst.copy_(src)
        return dst

    # ------------------------------------------------------------ streamed

    def stream_sink(self, i, g):
        """The backward's gradient hook for parameter ``i``: its squared
        norm (fp32, stays on the device) and a copy of ``g`` into its span
        of ``stream_g`` on the side stream. The caller then frees the
        gradient."""
        o, n = self.span[i]
        sq = g.float().square().sum()
        dst = self.stream_g[o:o + n]
        if self.cuda:
            self._d2h.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._d2h):
                dst.copy_(g.reshape(-1), non_blocking=True)
            g.record_stream(self._d2h)
        else:
            dst.copy_(g.reshape(-1))
        return sq

    def zero_span(self, i):
        """A parameter the backward gave no gradient: zeros in its span of
        ``stream_g`` (the JAX backward streams a zero gradient)."""
        o, n = self.span[i]
        self.stream_g[o:o + n].zero_()

    def begin_streamed_backward(self):
        """Make ``stream_g`` ready, in the gradients' dtype (the compute
        dtype): the compute dtype's staging buffer, which the streamed
        path has no other use for."""
        self.stream_g = self._staging(self.compute_dtype)

    def streamed_token(self):
        """An event after every streamed copy so far (None on the CPU)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self._d2h)
        return ev

    # ---------------------------------------------------------------- step

    def _event_pair(self, stream, key):
        """A timing event recorded on ``stream`` now, and its partner to
        record when the transfer is queued; kept for ``timing``."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        self._transfers[key].append((start, end))
        return end

    @property
    def timing(self):
        """The last step's phases (host clock) and, on the card, the
        transfers' device time: ``download_s`` and ``upload_device_s``,
        each the sum over chunks of CUDA-event intervals on its stream
        (read here, after the events)."""
        if self._timing is None:
            return None
        out = dict(self._timing)
        if self.cuda:
            for key, pairs in self._transfers.items():
                for _, end in pairs:
                    end.synchronize()
                out[key] = sum(a.elapsed_time(b) for a, b in pairs) / 1e3
        return out

    def _queue_downloads(self, grads, scale):
        """Scale each chunk's gradients on the caller's stream (``scale`` a
        0-d fp32 device tensor, or None for 1), then queue their copies
        into the staging buffer of their dtype on the side stream. Returns
        (that buffer, one event per chunk: None on the CPU). ``grads``
        (engine order) is emptied as the copies are queued."""
        dtypes = {grads[i].dtype for i in self.order}
        if len(dtypes) != 1:
            raise TypeError("offload: gradients of several dtypes {}".format(
                sorted(str(d) for d in dtypes)))
        staging = self._staging(dtypes.pop())
        events = []
        cur = torch.cuda.current_stream(self.device) if self.cuda else None
        for chunk in self.chunks:
            chunk_grads = []
            for i in chunk:
                g = grads[i]
                grads[i] = None
                if scale is not None:
                    # (g in fp32 * scale) rounded back to g's dtype, as the
                    # JAX pre-step computes it.
                    if g.dtype == torch.float32:
                        g.mul_(scale)
                    else:
                        g.copy_(g.float().mul_(scale))
                chunk_grads.append((i, g))
            if not self.cuda:
                for i, g in chunk_grads:
                    o, n = self.span[i]
                    staging[o:o + n].copy_(g.reshape(-1))
                events.append(None)
                continue
            self._d2h.wait_stream(cur)
            end = self._event_pair(self._d2h, "download_s")
            with torch.cuda.stream(self._d2h):
                for i, g in chunk_grads:
                    o, n = self.span[i]
                    staging[o:o + n].copy_(g.reshape(-1), non_blocking=True)
                    g.record_stream(self._d2h)
            end.record(self._d2h)
            events.append(end)
        return staging, events

    def step(self, optimizer, lr, grads=None, scale=None, host_scale=1.0,
             token=None):
        """One pipelined optimizer step (module docstring). Materialized:
        ``grads`` (engine order; consumed) with the device ``scale``.
        Streamed: the gradients are in ``stream_g`` once ``token`` has
        fired; ``host_scale`` is the unscale-and-clip factor."""
        streamed = grads is None
        self._transfers = {key: [] for key in self._transfers}
        t_queue = time.perf_counter()
        if streamed:
            if token is not None:
                token.synchronize()
            source, events = self.stream_g, [None] * len(self.chunks)
        else:
            source, events = self._queue_downloads(grads, scale)
        t_queue = time.perf_counter() - t_queue
        if self.cuda:
            # The parameters may be overwritten once the backward is done.
            self._up.wait_stream(torch.cuda.current_stream(self.device))
        self.step_count += 1
        step = self.step_count
        segmented = getattr(optimizer, "supports_segments", False)

        def stage(ci):
            t0 = time.perf_counter()
            lo, hi = self._bounds(self.chunks[ci])
            if events[ci] is not None:
                events[ci].synchronize()
            host_g = self._widen(ci, source[lo:hi])
            if streamed and host_scale != 1.0:
                # In place: an fp32 stream_g is rewritten at the next step.
                self._scale_lib.ds_scale(host_g.numel(), float(host_scale),
                                         float_ptr(host_g))
            return host_g, lo, hi, time.perf_counter() - t0

        timing = {"stage_s": 0.0, "adam_s": 0.0, "upload_s": 0.0,
                  "queue_s": t_queue}
        t_wall = time.perf_counter()
        if self._pool is None:
            # One long-lived staging worker per engine: a per-step executor
            # would pay a thread start and join every step.
            self._pool = ThreadPoolExecutor(max_workers=1)
        uploaded = set()
        two_pass = getattr(optimizer, "norm_reduce", None) is not None
        if two_pass and self._lamb_scratch is None:
            self._lamb_scratch = torch.empty(self.total, dtype=torch.float32)
        sq = torch.zeros(len(self.params), 2, dtype=torch.float64)
        nxt = self._pool.submit(stage, 0) if self.chunks else None
        try:
            for ci, chunk in enumerate(self.chunks):
                host_g, lo, hi, t_stage = nxt.result()
                nxt = None
                timing["stage_s"] += t_stage
                if ci + 1 < len(self.chunks):
                    nxt = self._pool.submit(stage, ci + 1)
                kwargs = {"step": step, "lr": lr}
                segments = [(self.span[i][0] - lo, self.span[i][1])
                            for i in chunk]
                if segmented:
                    kwargs["segments"] = segments
                if self.out16 is not None:
                    kwargs["bf16_out"] = self.out16[lo:hi]
                t0 = time.perf_counter()
                if two_pass:
                    sq[chunk] = optimizer.norms_flat(
                        self.master[lo:hi], host_g, self.m[lo:hi],
                        self.v[lo:hi], self._lamb_scratch[lo:hi], step,
                        segments)
                    timing["adam_s"] += time.perf_counter() - t0
                    continue
                optimizer.step_flat(self.master[lo:hi], host_g,
                                    self.m[lo:hi], self.v[lo:hi], **kwargs)
                timing["adam_s"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                self._upload(chunk)
                uploaded.update(chunk)
                timing["upload_s"] += time.perf_counter() - t0
            if two_pass:
                self._lamb_apply(optimizer, optimizer.norm_reduce(sq), lr,
                                 timing, uploaded)
        finally:
            if nxt is not None:
                # Drain the staging future before leaving, also on error.
                nxt.exception()
            if len(uploaded) != len(self.params):
                # A chunk failed: every parameter not sent back this step
                # is put back on the card from the master.
                self.restore_params([i for i in range(len(self.params))
                                     if i not in uploaded])
            if self.cuda:
                # The next forward reads the uploaded parameters.
                torch.cuda.current_stream(self.device).wait_stream(self._up)
            if not streamed and source.dtype != self.grad_dtype:
                # The first step's fp32 gradients: no later step copies
                # into their buffer.
                if self.cuda:
                    self._d2h.synchronize()
                del self.staging[source.dtype]
        timing["wall_s"] = time.perf_counter() - t_wall
        timing["chunks"] = len(self.chunks)
        timing["overlap_ratio"] = (
            (timing["stage_s"] + timing["adam_s"] + timing["upload_s"])
            / max(timing["wall_s"], 1e-9))
        self._timing = timing

    def _lamb_apply(self, optimizer, sq, lr, timing, uploaded):
        """LAMB's pass 2 (module docstring), chunk by chunk with the
        uploads, from every tensor's summed squares ``sq``."""
        ratios = [optimizer.ratio(w, u) for w, u in sq.tolist()]
        optimizer.lamb_coeffs = [ratios[i] for i in self.order]
        for chunk in self.chunks:
            lo, hi = self._bounds(chunk)
            t0 = time.perf_counter()
            optimizer.apply_flat(
                self.master[lo:hi], self._lamb_scratch[lo:hi],
                [ratios[i] for i in chunk], lr,
                [(self.span[i][0] - lo, self.span[i][1]) for i in chunk],
                bf16_out=None if self.out16 is None else self.out16[lo:hi])
            timing["adam_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            self._upload(chunk)
            uploaded.update(chunk)
            timing["upload_s"] += time.perf_counter() - t0

    def _upload(self, chunk):
        """Chunk's updated parameters to the card (non_blocking, on the
        upload stream), from out16 (bf16) or the master."""
        src = self.out16 if self.out16 is not None else self.master
        if not self.cuda:
            for i in chunk:
                o, n = self.span[i]
                self.params[i].data.view(-1).copy_(src[o:o + n])
            return
        end = self._event_pair(self._up, "upload_device_s")
        with torch.cuda.stream(self._up):
            for i in chunk:
                o, n = self.span[i]
                p = self.params[i].data.view(-1)
                if p.dtype == src.dtype:
                    p.copy_(src[o:o + n], non_blocking=True)
                else:
                    # fp16 parameters: the fp32 master up, then rounded on
                    # the card (round to nearest even, as on the host).
                    p.copy_(src[o:o + n].to(self.device, non_blocking=True))
        end.record(self._up)

    def restore_params(self, indices=None):
        """Re-materialize device parameters (all, or ``indices``) from the
        fp32 master (JAX ``_offload_restore_params``)."""
        if self.cuda:
            torch.cuda.current_stream(self.device).wait_stream(self._up)
        for i in range(len(self.params)) if indices is None else indices:
            o, n = self.span[i]
            p = self.params[i].data.view(-1)
            p.copy_(self.master[o:o + n].to(p.device).to(p.dtype))

    def load_moments(self, m_leaves, v_leaves, master_leaves=None):
        """Fill m, v and (where given) the master from per-parameter fp32
        tensors (engine order, this rank's shapes), one ``ds_flatten``
        each."""
        lib = load_host("flatten_unflatten")
        for buf, leaves in ((self.m, m_leaves), (self.v, v_leaves),
                            (self.master, master_leaves)):
            if leaves is None:
                continue
            for i, leaf in enumerate(leaves):
                if leaf.numel() != self.span[i][1]:
                    raise ValueError(
                        "saved leaf {} of {} elements, the model's has {}"
                        .format(i, leaf.numel(), self.span[i][1]))
            flatten_into(lib, buf, [leaves[i].reshape(-1).contiguous()
                                    for i in self.order])

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


def split_jax_flat(flat, names, shapes):
    """Per-parameter views (engine order) of ``flat``, the parameters of
    ``shapes`` laid out in JAX's leaf order (a checkpoint's
    ``fp32_master``)."""
    order = jax_leaf_order(names)
    sizes = [int(torch.Size(shapes[i]).numel()) for i in order]
    if sum(sizes) != flat.numel():
        raise ValueError("fp32_master of {} elements, the model has {}"
                         .format(flat.numel(), sum(sizes)))
    out, off = [None] * len(names), 0
    for i, n in zip(order, sizes):
        out[i] = flat[off:off + n].view(shapes[i])
        off += n
    return out


def join_jax_flat(names, leaves):
    """The inverse of ``split_jax_flat``: one flat tensor of ``leaves``
    (engine order) in JAX's leaf order."""
    return torch.cat([leaves[i].reshape(-1)
                      for i in jax_leaf_order(names)])


class ShardedHostOffload(HostOffload):
    """The offload tier of one rank's ZeRO partition over ``group`` (module
    docstring): ``params`` the rank's full (fp32) parameters, ``dims`` each
    leaf's partition dim (None: replicated). The host state and the upload
    targets are the shards: a view of its parameter where the partition is
    on dim 0, else a device buffer of its own."""

    def __init__(self, names, params, compute_dtype, dims, group, bucket,
                 seq_group=None):
        self.full_params = list(params)
        self.dims = list(dims)
        self.group = group
        self.seq_group = seq_group
        self.dp = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.bucket = int(bucket)
        self.shapes = [tuple(p.shape) for p in self.full_params]
        shards = [shard_slice(p.detach().float(), d, self.rank,
                              self.dp).contiguous()
                  for p, d in zip(self.full_params, self.dims)]
        super().__init__(names, shards, compute_dtype,
                         grad_dtype=torch.float32)

    def drop_device_params(self):
        """The full parameters drop to the compute dtype; the upload
        targets become their shards."""
        targets = []
        for p, d in zip(self.full_params, self.dims):
            if p.is_floating_point() and p.dtype != self.compute_dtype:
                p.data = p.data.to(self.compute_dtype)
            if d is None:
                targets.append(p)
            elif d == 0:
                targets.append(shard_slice(p.data, 0, self.rank, self.dp))
            else:
                targets.append(torch.empty(
                    shard_slice(p.data, d, self.rank, self.dp).shape,
                    dtype=p.dtype, device=p.device))
        self.params = targets

    def reduce(self, grads):
        """The rank's shards of the group's mean of ``grads`` (full
        gradients, engine order; the list's entries are freed), under
        sequence parallelism the mean over ``seq_group`` first
        (``partition.reduce_mean``, one bucket of ``bucket`` elements at a
        time)."""
        out = [None] * len(grads)
        idx = list(range(len(grads)))
        for start, end in comm.buckets([g.numel() for g in grads],
                                       self.bucket):
            for i, g in reduce_mean(grads, idx[start:end], self.dims,
                                    self.shapes, self.group,
                                    self.seq_group).items():
                out[i] = g
        return out

    def gather(self, shards):
        """Full fp32 tensors from per-leaf ``shards`` (collective)."""
        idx = [i for i, d in enumerate(self.dims) if d is not None]
        full = gather_full([s.detach().float() for s in shards], idx,
                           self.dims, self.shapes, self.group, self.bucket)
        return [full[i].contiguous() if i in full else s.detach().float()
                for i, s in enumerate(shards)]

    def shard(self, i, full):
        return shard_slice(full, self.dims[i], self.rank, self.dp)

    @torch.no_grad()
    def publish(self):
        """The full parameters from every rank's uploaded shards."""
        idx = [i for i, d in enumerate(self.dims) if d is not None]
        full = gather_full([t.data for t in self.params], idx, self.dims,
                           self.shapes, self.group, self.bucket)
        for i, f in full.items():
            self.full_params[i].data.copy_(f)

    def step(self, optimizer, lr, grads=None, scale=None, host_scale=1.0,
             token=None):
        super().step(optimizer, lr, grads=grads, scale=scale,
                     host_scale=host_scale, token=token)
        self.publish()

    def restore_params(self, indices=None):
        super().restore_params(indices)
        if indices is None:
            self.publish()
