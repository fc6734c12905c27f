"""The N-dimensional rank topology and the pipeline grid.

Counterpart of the JAX package's ``runtime/pipe/topology.py``. The
coordinate arithmetic (``ProcessTopology``: ranks, axis lists, filters,
the checkpoint names' rank strings) is the same pure Python.
``PipelineParallelGrid`` keeps the JAX grid's rank lists and its mpu
interface, and where a ``torch.distributed`` group is live it also holds
one process group per line of each axis that contains this rank: pipe,
data, model, the slice (the pipe x model ranks of one data replica) and
the p2p pairs (adjacent stages). ``torch.distributed.new_group`` is
collective, so every rank builds the grid, in the same order as its other
groups. Given the ``parallel.mesh.Mesh`` of the same layout, the grid
reuses the mesh's pipe, data and model groups instead of making its own.
"""

from collections import namedtuple
from itertools import product as cartesian_product

import torch.distributed as dist

from deepspeed_tpu_torch.utils.distributed import group_timeout


class ProcessTopology:
    """Maps n-dimensional cartesian coordinates to linear rank indices.

    Row-major layout: axes=['x','y'] puts (x,y) and (x,y+1) at adjacent
    linear indices.
    """

    def __init__(self, axes, dims):
        self.axes = axes
        self.dims = dims
        self.ProcessCoord = namedtuple("ProcessCoord", axes)
        self.mapping = {}
        ranges = [range(d) for d in dims]
        for global_rank, coord in enumerate(cartesian_product(*ranges)):
            key = {axis: coord[self.axes.index(axis)] for axis in self.axes}
            key = self.ProcessCoord(**key)
            self.mapping[key] = global_rank

    def get_rank(self, **coord_kwargs):
        if len(coord_kwargs) != len(self.axes):
            raise ValueError(
                "get_rank() does not support slices. Use filter_match()")
        key = self.ProcessCoord(**coord_kwargs)
        assert key in self.mapping, "key {} invalid".format(coord_kwargs)
        return self.mapping[key]

    def get_axis_names(self):
        return self.axes

    def get_rank_repr(self, rank, omit_axes=("data", "pipe"),
                      inner_sep="_", outer_sep="-"):
        """String representation of a rank, used for checkpoint file names."""
        omit_axes = frozenset(omit_axes)
        axes = [a for a in self.get_axis_names() if a not in omit_axes]
        names = []
        for ax in axes:
            ax_rank = getattr(self.get_coord(rank=rank), ax)
            names.append("{}{}{:02d}".format(ax, inner_sep, ax_rank))
        return outer_sep.join(names)

    def get_dim(self, axis):
        if axis not in self.axes:
            return 0
        return self.dims[self.axes.index(axis)]

    def get_coord(self, rank):
        for coord, idx in self.mapping.items():
            if idx == rank:
                return coord
        raise ValueError("rank {} not found in topology.".format(rank))

    def get_axis_comm_lists(self, axis):
        """Rank lists that differ only along ``axis`` — communicator groups."""
        if axis not in self.axes:
            return []
        other_axes = [a for a in self.axes if a != axis]
        lists = []
        ranges = [range(self.get_dim(a)) for a in other_axes]
        for coord in cartesian_product(*ranges):
            other_keys = {a: coord[other_axes.index(a)] for a in other_axes}
            sub_list = []
            for axis_key in range(self.get_dim(axis)):
                key = self.ProcessCoord(**other_keys, **{axis: axis_key})
                sub_list.append(self.mapping[key])
            lists.append(sub_list)
        return lists

    def filter_match(self, **filter_kwargs):
        """Ranks whose coordinates match all given axis=value criteria."""
        def _filter_helper(x):
            for key, val in filter_kwargs.items():
                if getattr(x, key) != val:
                    return False
            return True

        coords = filter(_filter_helper, self.mapping.keys())
        return [self.mapping[coo] for coo in coords]

    def get_axis_list(self, axis, idx):
        axis_num = self.axes.index(axis)
        return [self.mapping[k] for k in self.mapping.keys()
                if k[axis_num] == idx]

    def world_size(self):
        return len(self.mapping)

    def __str__(self):
        return str(self.mapping)


def _prime_factors(N):
    """Prime factorization of a positive integer ."""
    if N <= 0:
        raise ValueError("Values must be strictly positive.")
    primes = []
    while N != 1:
        for candidate in range(2, N + 1):
            if N % candidate == 0:
                primes.append(candidate)
                N //= candidate
                break
    return primes


class PipeDataParallelTopology(ProcessTopology):
    """Hybrid pipeline and data topology: data on the last (fast)
    dimension, so the gradient reductions stay within neighbouring
    ranks."""

    def __init__(self, num_pp, num_dp):
        super().__init__(axes=["pipe", "data"], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """Hybrid pipeline, data and model topology: rank = (pipe * dp +
    data) * mp + model, the rank rule of ``parallel/mesh.py``."""

    def __init__(self, num_pp, num_mp, num_dp):
        super().__init__(axes=["pipe", "data", "model"],
                         dims=[num_pp, num_dp, num_mp])


class PipelineParallelGrid:
    """The (stage, data-parallel rank) grid over a topology, with the mpu
    interface (``get_data_parallel_group`` and the like) and, where a
    process group is live, the axis groups (module docstring). The
    ``get_*_group`` methods return the rank lists, as the JAX grid does;
    the process groups are ``pipe_group``, ``dp_group``, ``mp_group``,
    ``slice_group`` and ``p2p_group(other_stage)``. ``global_rank``
    defaults to this process's rank (0 without a process group);
    ``set_rank`` re-views the grid's coordinates from another rank."""

    def __init__(self, topology=None, process_group=None, world_size=None,
                 global_rank=None, mesh=None):
        live = dist.is_available() and dist.is_initialized()
        if global_rank is None:
            global_rank = dist.get_rank() if live else 0
        self.global_rank = global_rank
        if topology is not None:
            self._topo = topology
            self.world_size = topology.world_size()
        else:
            if world_size is None:
                world_size = dist.get_world_size() if live else None
            assert world_size is not None, \
                "PipelineParallelGrid needs a topology or world_size"
            self.world_size = world_size
            num_pp, num_dp = self._infer_grid(world_size)
            self._topo = PipeDataParallelTopology(num_pp=num_pp, num_dp=num_dp)

        self.data_parallel_size = max(self._topo.get_dim("data"), 1)
        self.pipe_parallel_size = max(self._topo.get_dim("pipe"), 1)
        self.model_parallel_size = max(self._topo.get_dim("model"), 1)
        assert self.world_size == (self.data_parallel_size *
                                   self.pipe_parallel_size *
                                   self.model_parallel_size)

        self.stage_id = self.get_stage_id()
        self.data_parallel_id = self.get_data_parallel_id()

        self.dp_groups = self._topo.get_axis_comm_lists("data")
        self.pp_groups = self._topo.get_axis_comm_lists("pipe")
        self.mp_groups = self._topo.get_axis_comm_lists("model") or \
            [[r] for r in range(self.world_size)]
        self.p2p_groups = self._build_p2p_groups()
        # Slice groups: the ranks that together hold one replica of the
        # model (pipe x model).
        self.slice_groups = []
        for dp in range(self.data_parallel_size):
            ranks = sorted(self._topo.filter_match(data=dp))
            self.slice_groups.append(ranks)
        self.slice_parallel_size = self.model_parallel_size

        self.pipe_group = self.dp_group = self.mp_group = None
        self.slice_group = None
        self._pair_groups = {}
        if live and process_group is not False and \
                self.world_size == dist.get_world_size():
            self._build_process_groups(mesh)

    def _build_process_groups(self, mesh):
        """One process group per line of each axis (every rank makes every
        group, in one order); the mesh's where it has them."""
        def mine(lists, reuse=None):
            if reuse is not None:
                return reuse
            held = None
            for ranks in lists:
                group = dist.new_group(ranks, timeout=group_timeout())
                if self.global_rank in ranks:
                    held = group
            return held

        self.dp_group = mine(self.dp_groups,
                             getattr(mesh, "dp_group", None))
        self.mp_group = mine(self.mp_groups if self.model_parallel_size > 1
                             else [], getattr(mesh, "mp_group", None))
        self.pipe_group = mine(self.pp_groups,
                               getattr(mesh, "pp_group", None))
        self.slice_group = mine(self.slice_groups)
        pairs = sorted({tuple(sorted(p)) for p in self.p2p_groups
                        if p[0] != p[1]})
        for pair in pairs:
            group = dist.new_group(list(pair), timeout=group_timeout())
            if self.global_rank in pair:
                self._pair_groups[pair] = group

    def p2p_group(self, other_rank):
        """The process group of this rank and ``other_rank`` (adjacent
        stages), or None without a process group."""
        return self._pair_groups.get(
            tuple(sorted((self.global_rank, other_rank))))

    def _infer_grid(self, world_size):
        """Alternate prime factors between the pipe and data dims
        (world_size=8: pp=4, dp=2)."""
        num_pp = 1
        num_dp = 1
        for idx, prime in enumerate(_prime_factors(world_size)):
            if idx % 2 == 0:
                num_pp *= prime
            else:
                num_dp *= prime
        return num_pp, num_dp

    def set_rank(self, rank):
        """Re-view the grid's coordinates from global rank ``rank`` (the
        process groups stay this process's)."""
        self.global_rank = rank
        self.stage_id = self.get_stage_id()
        self.data_parallel_id = self.get_data_parallel_id()
        return self

    def get_stage_id(self):
        return self._topo.get_coord(rank=self.global_rank).pipe

    def get_data_parallel_id(self):
        return self._topo.get_coord(rank=self.global_rank).data

    def _build_p2p_groups(self):
        """Each rank with its next stage's rank, wrapping at the end."""
        comm_lists = self._topo.get_axis_comm_lists("pipe")
        p2p_lists = []
        for rank in range(self.world_size):
            for lst in comm_lists:
                if rank in lst:
                    idx = lst.index(rank)
                    buddy_rank = lst[(idx + 1) % self.pipe_parallel_size]
                    p2p_lists.append([rank, buddy_rank])
                    break
        assert len(p2p_lists) == self.world_size
        return p2p_lists

    def topology(self):
        return self._topo

    # The mpu interface.

    def get_global_rank(self):
        return self.global_rank

    def get_pipe_parallel_rank(self):
        return self.stage_id

    def get_pipe_parallel_world_size(self):
        return self.pipe_parallel_size

    def get_pipe_parallel_group(self):
        for ranks in self.pp_groups:
            if self.global_rank in ranks:
                return ranks
        return None

    def get_data_parallel_rank(self):
        return self.data_parallel_id

    def get_data_parallel_world_size(self):
        return self.data_parallel_size

    def get_data_parallel_group(self):
        for ranks in self.dp_groups:
            if self.global_rank in ranks:
                return ranks
        return None

    def get_model_parallel_rank(self):
        if "model" in self._topo.get_axis_names():
            return self._topo.get_coord(rank=self.global_rank).model
        return 0

    def get_model_parallel_world_size(self):
        return self.model_parallel_size

    def get_model_parallel_group(self):
        for ranks in self.mp_groups:
            if self.global_rank in ranks:
                return ranks
        return None

    def get_slice_parallel_rank(self):
        return self.get_model_parallel_rank()

    def get_slice_parallel_world_size(self):
        return self.slice_parallel_size

    def get_slice_parallel_group(self):
        for ranks in self.slice_groups:
            if self.global_rank in ranks:
                return ranks
        return None

    def is_first_stage(self):
        return self.stage_id == 0

    def is_last_stage(self):
        return self.stage_id == self.pipe_parallel_size - 1

    def stage_to_global(self, stage_id, **kwargs):
        me = self._topo.get_coord(self.global_rank)
        transform = me._replace(pipe=stage_id, **kwargs)._asdict()
        return self._topo.get_rank(**transform)
