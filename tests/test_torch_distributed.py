"""The port's process-group layer against the JAX package: the launcher's
environment contract, MPI discovery, the backend choice, a real
all-reduce, reduce-scatter and all-gather over two gloo ranks
(``tests/torch_dist_worker.py``, started by the port's launcher), and the
rank layout and ZeRO partition rule of ``parallel/mesh.py`` against the
JAX ``parallel/mesh.py`` on the same shapes. Exact comparisons (integers
and small sums of exact values)."""

import os

import jax
import numpy as np
import pytest

from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.utils import distributed as jdist
from deepspeed_tpu_torch.parallel import mesh as tmesh
from deepspeed_tpu_torch.utils import distributed as tdist
from tests.torch_dist_worker import run_ranks


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    rng = np.random.RandomState(0)
    grads = np.zeros((2, 12, 3), np.float32)
    for r in range(2):
        grads[r, rng.choice(12, 3, replace=False)] = rng.randn(3, 3)
    return grads, run_ranks(2, [
        dict(name="env", kind="env"),
        dict(name="coll", kind="collectives", grads=grads, k=3)],
        str(root / "w"))


def test_launcher_environment_contract(two):
    """Each rank sees RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT and both GPU slots in CUDA_VISIBLE_DEVICES, and gets
    --local_rank=<i> first."""
    _, ranks = two
    for r, res in enumerate(ranks):
        env = res["env"]["env"]
        assert env == {"RANK": str(r), "WORLD_SIZE": "2",
                       "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": "1", "CUDA_VISIBLE_DEVICES": "0,1"}
        assert res["env"]["argv"][0] == "--local_rank={}".format(r)
        assert res["env"]["backend"] == "gloo"


def test_real_all_reduce(two):
    _, ranks = two
    assert [r["env"]["sum"] for r in ranks] == [3.0, 3.0]


def test_reduce_scatter_and_all_gather(two):
    """reduce_scatter (gloo: an all-reduce, then the rank's slice) keeps
    the rank's chunk of the mean; all_gather concatenates in rank order."""
    _, ranks = two
    flat = np.arange(6, dtype=np.float32)
    mean = (flat * 1 + flat * 2) / 2
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["coll"]["rs"],
                                      mean[r * 3:(r + 1) * 3])
        np.testing.assert_array_equal(res["coll"]["ag"], [0, 0, 1, 1])


def test_default_backend_follows_the_device():
    assert tdist.default_backend("cuda") == "nccl"
    assert tdist.default_backend("cuda:0") == "nccl"
    assert tdist.default_backend("cpu") == "gloo"


def test_one_rank_needs_no_group(monkeypatch):
    """WORLD_SIZE 1 (or unset): nothing to start, as in the JAX package."""
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tdist.init_distributed(device="cpu", verbose=False) is False
    assert not tdist.is_initialized()


def test_mpi_discovery_sets_the_jax_packages_environment(monkeypatch):
    """(Each key is set through monkeypatch first, so that what discovery
    writes is undone after the test: a WORLD_SIZE left behind would make
    every later engine of this process start a process group.)"""
    keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    got = {}
    for name, fn in (("jax", jdist.mpi_discovery),
                     ("port", tdist.mpi_discovery)):
        for k in keys:
            monkeypatch.setenv(k, "unset")
            monkeypatch.delenv(k)
        monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "3")
        monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "8")
        monkeypatch.setenv("OMPI_COMM_WORLD_LOCAL_RANK", "1")
        fn(distributed_port=29511, verbose=False)
        got[name] = {k: os.environ.get(k) for k in keys}
    assert got["port"] == got["jax"]
    assert got["port"]["RANK"] == "3" and got["port"]["MASTER_PORT"] == \
        "29511"


def test_mpi_discovery_leaves_no_environment_behind():
    """Runs after the test above in the same process (file order)."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_PORT"):
        assert os.environ.get(k) != {"RANK": "3", "WORLD_SIZE": "8",
                                     "LOCAL_RANK": "1",
                                     "MASTER_PORT": "29511"}[k], k


SHAPES = [(), (7,), (8,), (6, 4), (3, 8), (5, 7), (16, 2), (2, 3, 4),
          (1, 12), (12, 1), (1024, 64), (1026, 64), (130, 64), (4,), (2,)]


@pytest.mark.parametrize("dp", [1, 2, 4, 8])
def test_zero_partition_dim_is_the_jax_leaf_rule(dp):
    for shape in SHAPES:
        spec = jmesh._leaf_spec_over_axis(np.zeros(shape), jmesh.DATA_AXIS,
                                          dp)
        want = next((i for i, a in enumerate(spec) if a == "data"), None) \
            if dp > 1 else None
        assert tmesh.zero_partition_dim(shape, dp) == want, shape


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_zero_partition_dims_follow_jax_zero_shardings(stage):
    """Per role the partition (``zero_partition_dim`` for the roles a stage
    partitions: moments from stage 1, gradients from 2, parameters at 3)
    equals the 'data' entry of the JAX ``zero_shardings`` spec on a
    4-device mesh."""
    mesh = jmesh.build_mesh(devices=jax.devices()[:4])
    tree = {"l{}".format(i): np.zeros(s) for i, s in enumerate(SHAPES)}
    p_sh, g_sh, opt_fn = jmesh.zero_shardings(mesh, tree, stage)
    for first, shardings in ((3, p_sh), (2, g_sh), (1, opt_fn(tree))):
        for name, leaf in tree.items():
            want = next((i for i, a in enumerate(shardings[name].spec)
                         if a == "data"), None)
            got = tmesh.zero_partition_dim(leaf.shape, 4) \
                if stage >= first else None
            assert got == want, (name, first)


def test_rank_layout_and_refusals():
    """The grid puts every rank on the data axis by default (model
    innermost as in JAX ``build_mesh``); model and seq axes above 1 are
    taken, in JAX's rank order."""
    grid = tmesh.build_mesh(world_size=4, rank=2)
    assert grid.shape == {"pipe": 1, "data": 4, "seq": 1, "model": 1}
    assert grid.dp_rank == 2 and grid.data_line() == [0, 1, 2, 3]
    assert tmesh.dp_size(grid) == 4 and tmesh.mp_size(grid) == 1
    assert tmesh.pp_size(grid) == 1 and tmesh.sp_size(grid) == 1
    jgrid = jmesh.build_mesh(devices=jax.devices()[:4])
    assert tuple(jgrid.axis_names) == tmesh.AXES
    mp_grid = tmesh.build_mesh(world_size=4, rank=3, num_mp=2)
    assert (mp_grid.dp_rank, mp_grid.mp_rank) == (1, 1)
    assert mp_grid.line("model") == [2, 3] and mp_grid.data_line() == [1, 3]
    sp_grid = tmesh.build_mesh(world_size=4, rank=3, num_sp=2)
    assert (sp_grid.dp_rank, sp_grid.sp_rank) == (1, 1)
    assert sp_grid.line("seq") == [2, 3] and sp_grid.data_line() == [1, 3]
    with pytest.raises(ValueError):
        tmesh.build_mesh(world_size=4, rank=0, num_dp=3)


def test_tensor_parallel_rules_are_the_jax_packages():
    assert tmesh.DEFAULT_TP_RULES == jmesh.DEFAULT_TP_RULES
    paths = ["h_0/attn/c_attn/kernel", "h_0/attn/c_attn/bias",
             "h_1/mlp/c_proj/kernel", "h_1/mlp/c_fc/kernel", "wte",
             "moe/experts/w1"]
    for path in paths:
        for shape in [(64, 192), (192,), (64, 64), (6, 6)]:
            for mp in (1, 2, 4):
                assert tmesh._tp_dim(path, shape, tmesh.DEFAULT_TP_RULES,
                                     mp) == jmesh._tp_dim(
                    path, np.zeros(shape), jmesh.DEFAULT_TP_RULES, mp)
