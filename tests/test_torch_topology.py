"""The port's rank topology and pipeline grid against the JAX package's,
rank for rank (``runtime/pipe/topology.py``; no process group: the grid
holds rank lists only).

Parametrised over the topologies of the JAX ``tests/unit/
test_topology.py`` and the pipeline grids the port's engine builds (pipe
x data and pipe x data x model, up to 8 ranks): the coordinate maps, the
axis lists, the filters, the checkpoint names' rank strings, and every
rank's view of the grid (stage, data rank, model rank, the mpu groups,
the p2p pairs, stage_to_global). Exact equality. The grid also follows
the rank rule of ``parallel/mesh.py`` (rank = (pipe dp + data) mp +
model).
"""

import itertools

import pytest
import torch

from deepspeed_tpu.runtime.pipe import topology as jtopo

from deepspeed_tpu_torch.parallel import mesh as tmesh
from deepspeed_tpu_torch.runtime.pipe import topology as ttopo

torch.set_num_threads(1)

PLAIN = [(["row", "col"], [2, 2]), (["a", "b", "c"], [2, 3, 4]),
         (["pipe", "data"], [2, 2]), (["pipe", "data", "model"], [2, 2, 2]),
         (["x"], [5])]
GRIDS = [("pd", 1, 1, 2), ("pd", 2, 1, 1), ("pd", 2, 1, 2), ("pd", 4, 1, 2),
         ("pd", 4, 1, 1), ("pmd", 2, 2, 2), ("pmd", 2, 2, 1),
         ("pmd", 1, 2, 4), ("pmd", 4, 2, 1)]


def _topo(module, kind, pp, mp, dp):
    if kind == "pd":
        return module.PipeDataParallelTopology(num_pp=pp, num_dp=dp)
    return module.PipeModelDataParallelTopology(num_pp=pp, num_mp=mp,
                                                num_dp=dp)


@pytest.mark.parametrize("axes,dims", PLAIN)
def test_process_topology_matches_jax(axes, dims):
    t = ttopo.ProcessTopology(axes=axes, dims=dims)
    j = jtopo.ProcessTopology(axes=axes, dims=dims)
    assert t.world_size() == j.world_size()
    assert {tuple(k): v for k, v in t.mapping.items()} == \
        {tuple(k): v for k, v in j.mapping.items()}
    for axis in axes + ["missing"]:
        assert t.get_dim(axis) == j.get_dim(axis)
        assert t.get_axis_comm_lists(axis) == j.get_axis_comm_lists(axis)
    for axis, d in zip(axes, dims):
        for idx in range(d):
            assert t.get_axis_list(axis, idx) == j.get_axis_list(axis, idx)
            assert t.filter_match(**{axis: idx}) == \
                j.filter_match(**{axis: idx})
    for rank in range(t.world_size()):
        assert tuple(t.get_coord(rank)) == tuple(j.get_coord(rank))
        for omit in ([], ["data", "pipe"], axes[:1]):
            assert t.get_rank_repr(rank, omit_axes=omit) == \
                j.get_rank_repr(rank, omit_axes=omit)
        assert t.get_rank(**t.get_coord(rank)._asdict()) == rank


@pytest.mark.parametrize("kind,pp,mp,dp", GRIDS)
def test_pipeline_grid_matches_jax_on_every_rank(kind, pp, mp, dp):
    world = pp * mp * dp
    for rank in range(world):
        t = ttopo.PipelineParallelGrid(topology=_topo(ttopo, kind, pp, mp,
                                                      dp), global_rank=rank)
        j = jtopo.PipelineParallelGrid(topology=_topo(jtopo, kind, pp, mp,
                                                      dp)).set_rank(rank)
        for name in ("get_stage_id", "get_data_parallel_id",
                     "get_model_parallel_rank", "get_pipe_parallel_group",
                     "get_data_parallel_group", "get_model_parallel_group",
                     "get_slice_parallel_group", "is_first_stage",
                     "is_last_stage", "get_pipe_parallel_world_size",
                     "get_data_parallel_world_size",
                     "get_model_parallel_world_size",
                     "get_slice_parallel_world_size"):
            assert getattr(t, name)() == getattr(j, name)(), name
        assert t.p2p_groups == j.p2p_groups
        assert t.dp_groups == j.dp_groups and t.mp_groups == j.mp_groups
        assert t.pp_groups == j.pp_groups
        assert t.slice_groups == j.slice_groups
        for stage in range(pp):
            assert t.stage_to_global(stage) == j.stage_to_global(stage)
        # The grid's lines are the mesh's (the rank rule of parallel/mesh).
        mesh = tmesh.build_mesh(num_pp=pp, num_mp=mp, world_size=world,
                                rank=rank)
        assert mesh.pp_rank == t.get_stage_id()
        assert mesh.dp_rank == t.get_data_parallel_id()
        assert mesh.line("pipe") == t.get_pipe_parallel_group()
        assert mesh.data_line() == t.get_data_parallel_group()
        if kind == "pmd":
            assert mesh.line("model") == t.get_model_parallel_group()


@pytest.mark.parametrize("world", [1, 2, 4, 6, 8, 12])
def test_inferred_grid_matches_jax(world):
    t = ttopo.PipelineParallelGrid(world_size=world)
    j = jtopo.PipelineParallelGrid(world_size=world)
    assert (t.pipe_parallel_size, t.data_parallel_size) == \
        (j.pipe_parallel_size, j.data_parallel_size)
    assert ttopo._prime_factors(world) == jtopo._prime_factors(world)


def test_grid_without_process_group_has_no_groups():
    grid = ttopo.PipelineParallelGrid(
        topology=ttopo.PipeDataParallelTopology(num_pp=2, num_dp=1))
    assert grid.pipe_group is None and grid.p2p_group(1) is None
    assert list(itertools.chain(*grid.p2p_groups)) == [0, 1, 1, 0]
