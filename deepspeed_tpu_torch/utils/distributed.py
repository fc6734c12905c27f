"""Process-group bootstrap over ``torch.distributed``.

Counterpart of ``deepspeed_tpu/utils/distributed.py``, with the JAX
package's environment contract: the launcher (``launcher/launch.py``) sets
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` and
``LOCAL_RANK``; under Open MPI, ``mpi_discovery`` derives them from the
``OMPI_COMM_WORLD_*`` variables. Where the JAX package starts
``jax.distributed``, this starts ``torch.distributed.init_process_group``.

``dist_backend=None`` picks ``nccl`` when ``device`` is a CUDA device and
``gloo`` when it is the CPU; an explicit backend always wins (the card's
two-ranks-on-one-device runs pass ``"gloo"``: NCCL refuses two ranks on
one device). Nothing here switches backend on its own or catches a failed
rendezvous. ``group_timeout()`` is the timeout the default group was
started with, which every group the port makes takes too (the grid's,
the pipeline's), so a hang fails at the same bound.
"""

import datetime
import os

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.utils.logging import logger

DEFAULT_TIMEOUT_S = 1800
_timeout = None


def group_timeout():
    """The default group's timeout (a timedelta) when ``init_distributed``
    started it, else None (``new_group``'s own default)."""
    return _timeout


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def default_backend(device):
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(dist_backend=None, auto_mpi_discovery=True,
                     distributed_port=29500, verbose=True, timeout=None,
                     init_method=None, rank=None, world_size=None,
                     device="cuda"):
    """Initialise the default process group from the environment contract
    (module docstring) when it says more than one rank; a no-op when the
    group exists or the world is one rank. ``init_method`` (e.g.
    ``file:///path``) replaces the ``env://`` rendezvous; ``rank`` and
    ``world_size`` override the environment's; ``timeout`` (seconds)
    bounds the rendezvous and every collective. Returns True when a group
    is live."""
    if is_initialized():
        return True
    if auto_mpi_discovery and "OMPI_COMM_WORLD_SIZE" in os.environ and \
            "RANK" not in os.environ:
        mpi_discovery(distributed_port=distributed_port, verbose=verbose)
    world_size = int(world_size if world_size is not None
                     else os.environ.get("WORLD_SIZE", 1))
    if world_size <= 1:
        return False
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    backend = dist_backend or default_backend(device)
    if init_method is None:
        os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
        os.environ.setdefault("MASTER_PORT", str(distributed_port))
        init_method = "env://"
    if verbose:
        logger.info("Initializing torch.distributed (%s) at %s rank=%d "
                    "world_size=%d", backend, init_method if init_method !=
                    "env://" else "{}:{}".format(os.environ["MASTER_ADDR"],
                                                  os.environ["MASTER_PORT"]),
                    rank, world_size)
    global _timeout
    _timeout = datetime.timedelta(seconds=timeout or DEFAULT_TIMEOUT_S)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=_timeout)
    return True


def mpi_discovery(distributed_port=29500, verbose=True):
    """Set RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT from
    the Open MPI environment (no mpi4py: MASTER_ADDR must come from the
    launcher on several nodes; 127.0.0.1 otherwise)."""
    rank = int(os.environ["OMPI_COMM_WORLD_RANK"])
    world_size = int(os.environ["OMPI_COMM_WORLD_SIZE"])
    local_rank = int(os.environ.get("OMPI_COMM_WORLD_LOCAL_RANK", 0))
    master_addr = os.environ.get("MASTER_ADDR") or "127.0.0.1"
    os.environ["RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world_size)
    os.environ["LOCAL_RANK"] = str(local_rank)
    os.environ["MASTER_ADDR"] = master_addr
    os.environ.setdefault("MASTER_PORT", str(distributed_port))
    if verbose:
        logger.info("Discovered MPI settings of world_rank=%d, local_rank=%d,"
                    " world_size=%d, master_addr=%s, master_port=%s", rank,
                    local_rank, world_size, master_addr,
                    os.environ["MASTER_PORT"])
