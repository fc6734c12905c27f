"""Activation checkpointing: recompute a segment's forward in the backward.

Counterpart of ``deepspeed_tpu/runtime/activation_checkpointing/
checkpointing.py`` (the reference's Megatron-derived ``CheckpointFunction``),
in the reference's own form, which torch allows:

- ``checkpoint(function, *args)`` / ``CheckpointFunction.apply``: the
  forward runs under ``no_grad`` and keeps only the segment's inputs; the
  backward restores them, puts back the random states the forward saw,
  runs the forward again with gradients and backpropagates through it.
  Non-tensor arguments pass through; gradients flow to the tensor
  arguments and to the parameters the function uses.
- ``partition_activations``: each saved floating input is cut into the
  model group's ranks' equal pieces (``configure(mesh_=...)``; a 'model'
  axis of 1 cuts nothing) and the rank keeps its own; the backward
  all-gathers the input before the recompute.
- ``cpu_checkpointing``: the saved inputs wait in pinned host memory.
- ``synchronize_checkpoint_boundary``: ``torch.cuda.synchronize()`` around
  the segment (on the card). ``contiguous_memory_optimization`` and
  ``profile`` are accepted (the caching allocator owns the layout).

The random states: torch draws dropout from stateful generators, so the
recompute must replay them. A segment saves and restores the CPU default
generator (it feeds the seeds of the port's counter-based dropout, K10,
when no generator is given), every ``torch.Generator`` among its arguments
(the engine's, which feeds them under training), the CUDA generator of the
device of its inputs, and the named streams of the ``RNGStatesTracker``. The tracker keeps the reference's
named-state API: ``add(name, seed)`` makes a stream, ``fork(name)`` makes
it the current CPU and CUDA state inside the ``with`` block, then stores
its advance and restores the states the caller had.
"""

import contextlib

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.parallel import comm
from deepspeed_tpu_torch.utils.logging import logger

# Configuration (module-level, as the reference's globals).
_CONFIGURED = False
PARTITION_ACTIVATIONS = False
CONTIGUOUS_CHECKPOINTING = False
PA_TO_CPU = False
SYNCHRONIZE = False
PROFILE_TIME = False
num_layers = None

mpu = None
# The rank grid whose model group partition_activations cuts over.
_mesh = None

_MODEL_PARALLEL_RNG_TRACKER_NAME = "model-parallel-rng"


def _cuda_live():
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _get_states(device=None):
    """The CPU default generator's state and, on the card, the CUDA
    generator's of ``device`` (default: the current device)."""
    cuda = torch.cuda.get_rng_state(device or "cuda") if _cuda_live() \
        else None
    return torch.get_rng_state(), cuda


def _set_states(states, device=None):
    cpu, cuda = states
    torch.set_rng_state(cpu)
    if cuda is not None:
        torch.cuda.set_rng_state(cuda, device or "cuda")


class RNGStatesTracker(object):
    """Named random streams (the reference's CudaRNGStatesTracker): each a
    saved (CPU, CUDA) generator state (module docstring)."""

    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def get_states(self):
        return dict(self.states_)

    def set_states(self, states):
        self.states_ = dict(states)

    def add(self, name, seed):
        if seed in self.seeds_:
            raise Exception("seed {} already exists".format(seed))
        self.seeds_.add(seed)
        if name in self.states_:
            raise Exception("rng state {} already exists".format(name))
        orig = _get_states()
        torch.manual_seed(seed)
        self.states_[name] = _get_states()
        _set_states(orig)

    @contextlib.contextmanager
    def fork(self, name=_MODEL_PARALLEL_RNG_TRACKER_NAME):
        """Draw from stream ``name`` inside the block; the stream advances."""
        if name not in self.states_:
            raise Exception("rng state {} is not added".format(name))
        orig = _get_states()
        _set_states(self.states_[name])
        try:
            yield
        finally:
            self.states_[name] = _get_states()
            _set_states(orig)


_RNG_STATE_TRACKER = RNGStatesTracker()

# The reference's name.
CudaRNGStatesTracker = RNGStatesTracker


def get_cuda_rng_tracker():
    return _RNG_STATE_TRACKER


def _mp_rank():
    if mpu is not None:
        return mpu.get_model_parallel_rank()
    return _mesh.mp_rank if _mesh is not None else 0


def model_parallel_cuda_manual_seed(seed):
    """Seed the model-parallel stream with seed + 2718 + the model-parallel
    rank (the reference's rule: dropout differs across model ranks and
    agrees across data ranks); returns that seed."""
    model_parallel_seed = seed + 2718 + _mp_rank()
    _RNG_STATE_TRACKER.reset()
    _RNG_STATE_TRACKER.add(_MODEL_PARALLEL_RNG_TRACKER_NAME,
                           model_parallel_seed)
    return model_parallel_seed


def _mp_group():
    """The model group partition_activations cuts over, or None."""
    if not PARTITION_ACTIVATIONS or _mesh is None or \
            _mesh.shape.get("model", 1) <= 1:
        return None
    return _mesh.mp_group


def _stash(x, group):
    """What the forward keeps of input ``x``: the rank's piece over
    ``group`` (padded to equal pieces), in pinned host memory under
    ``cpu_checkpointing``."""
    if group is not None and x.is_floating_point():
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        per = -(-x.numel() // world)
        flat = torch.zeros(per * world, dtype=x.dtype, device=x.device)
        flat[:x.numel()] = x.detach().reshape(-1)
        x = flat[rank * per:(rank + 1) * per].clone()
    else:
        x = x.detach()
    if PA_TO_CPU and x.device.type == "cuda":
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x, non_blocking=True)
        return h
    return x


def _restore(kept, like, group):
    """Input ``like`` (shape, dtype, device) again from ``kept``."""
    x = kept.to(like["device"], non_blocking=True)
    if group is not None and like["floating"]:
        x = comm.all_gather(x, group)[:like["numel"]]
    return x.view(like["shape"])


class CheckpointFunction(torch.autograd.Function):
    """``CheckpointFunction.apply(run_function, *args)`` (module
    docstring)."""

    @staticmethod
    def forward(ctx, run_function, *args):
        ctx.run_function = run_function
        device = next((a.device for a in args if torch.is_tensor(a) and
                       a.device.type == "cuda"), None)
        ctx.device = device
        ctx.states = _get_states(device)
        ctx.tracker = _RNG_STATE_TRACKER.get_states()
        ctx.generators = [(a, a.get_state()) for a in args
                          if isinstance(a, torch.Generator)]
        if SYNCHRONIZE and device is not None:
            torch.cuda.synchronize(device)
        with torch.no_grad():
            outputs = run_function(*args)
        group = _mp_group()
        ctx.group = group
        ctx.args, ctx.likes, kept = [], [], []
        for a in args:
            if torch.is_tensor(a):
                ctx.args.append(None)
                ctx.likes.append({"shape": a.shape, "device": a.device,
                                  "numel": a.numel(),
                                  "floating": a.is_floating_point(),
                                  "requires_grad": a.requires_grad})
                kept.append(_stash(a, group))
            else:
                ctx.args.append(a)
                ctx.likes.append(None)
        ctx.save_for_backward(*kept)
        if SYNCHRONIZE and device is not None:
            torch.cuda.synchronize(device)
        return outputs

    @staticmethod
    def backward(ctx, *grads):
        kept = iter(ctx.saved_tensors)
        inputs = []
        for a, like in zip(ctx.args, ctx.likes):
            if like is None:
                inputs.append(a)
                continue
            x = _restore(next(kept), like, ctx.group).detach()
            inputs.append(x.requires_grad_(like["requires_grad"]))
        outer = _get_states(ctx.device)
        outer_tracker = _RNG_STATE_TRACKER.get_states()
        outer_gens = [(g, g.get_state()) for g, _ in ctx.generators]
        _set_states(ctx.states, ctx.device)
        _RNG_STATE_TRACKER.set_states(ctx.tracker)
        for g, state in ctx.generators:
            g.set_state(state)
        try:
            with torch.enable_grad():
                outputs = ctx.run_function(*inputs)
        finally:
            _set_states(outer, ctx.device)
            _RNG_STATE_TRACKER.set_states(outer_tracker)
            for g, state in outer_gens:
                g.set_state(state)
        if torch.is_tensor(outputs):
            outputs = (outputs,)
        pairs = [(o, g) for o, g in zip(outputs, grads)
                 if torch.is_tensor(o) and o.requires_grad and g is not None]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs],
                                    [g for _, g in pairs])
        return (None,) + tuple(x.grad if torch.is_tensor(x) else None
                               for x in inputs)


def checkpoint(function, *args):
    """Checkpoint a model segment (the reference's
    ``CheckpointFunction.apply``)."""
    return CheckpointFunction.apply(function, *args)


def checkpoint_wrapped(function):
    """``function`` checkpointed at every call (the composable form)."""
    def wrapped(*args):
        return checkpoint(function, *args)
    return wrapped


def partition_activations_in_checkpoint(partition_activation):
    global PARTITION_ACTIVATIONS
    PARTITION_ACTIVATIONS = partition_activation
    logger.info("**************Partition Activations {}************".format(
        PARTITION_ACTIVATIONS))


def set_num_layers(nlayers):
    global num_layers
    num_layers = nlayers


def reset():
    """The reference frees its contiguous buffers here each step; the
    caching allocator holds nothing of ours, so there is nothing to do."""


def _configure_using_config_file(deepspeed_config):
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    global num_layers, PARTITION_ACTIVATIONS, CONTIGUOUS_CHECKPOINTING, \
        PA_TO_CPU, SYNCHRONIZE, PROFILE_TIME

    config = DeepSpeedConfig(deepspeed_config).activation_checkpointing_config
    logger.info(config.repr())
    PARTITION_ACTIVATIONS = config.partition_activations
    CONTIGUOUS_CHECKPOINTING = config.contiguous_memory_optimization
    num_layers = config.number_checkpoints
    PA_TO_CPU = config.cpu_checkpointing
    SYNCHRONIZE = config.synchronize_checkpoint_boundary
    PROFILE_TIME = config.profile


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None,
              mesh_=None):
    """Configure activation checkpointing (the reference's signature);
    ``mesh_`` is the rank grid whose model group ``partition_activations``
    cuts over."""
    global mpu, num_layers, PARTITION_ACTIVATIONS, CONTIGUOUS_CHECKPOINTING, \
        PA_TO_CPU, SYNCHRONIZE, PROFILE_TIME, _CONFIGURED, _mesh

    _CONFIGURED = True
    if mpu_ is not None:
        mpu = mpu_
    if mesh_ is not None:
        _mesh = mesh_
    if deepspeed_config is not None:
        _configure_using_config_file(deepspeed_config)
    if partition_activations is not None:
        PARTITION_ACTIVATIONS = partition_activations
    if contiguous_checkpointing is not None:
        CONTIGUOUS_CHECKPOINTING = contiguous_checkpointing
    if num_checkpoints is not None:
        num_layers = num_checkpoints
    if checkpoint_in_cpu is not None:
        PA_TO_CPU = checkpoint_in_cpu
    if synchronize is not None:
        SYNCHRONIZE = synchronize
    if profile is not None:
        PROFILE_TIME = profile
    if CONTIGUOUS_CHECKPOINTING:
        assert num_layers is not None, \
            "Must specify the number of checkpoints with contiguous memory " \
            "optimization"


def is_configured():
    return _CONFIGURED
