"""Port parity for the dataloader (``runtime/dataloader.py``) and its
wiring (``initialize(training_data=...)``, ``deepspeed_io``,
``train_batch(data_iter=...)``): the cases of the JAX package's
``test_data.py``, each batch equal to the JAX loader's, and the loss trace
of an engine fed by its loader equal to the JAX engine's (1e-5 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2
from deepspeed_tpu.parallel import mesh as mesh_lib
from deepspeed_tpu.runtime import dataloader as jdl
from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)

torch.set_num_threads(1)


def _equal(batch, jbatch):
    if isinstance(batch, (tuple, list)):
        assert type(batch) is type(jbatch) and len(batch) == len(jbatch)
        for a, b in zip(batch, jbatch):
            _equal(a, b)
    elif isinstance(batch, dict):
        assert batch.keys() == jbatch.keys()
        for k in batch:
            _equal(batch[k], jbatch[k])
    else:
        assert isinstance(batch, torch.Tensor)
        np.testing.assert_array_equal(batch.numpy(), jbatch)
        assert batch.numpy().dtype == np.asarray(jbatch).dtype


def test_repeating_loader():
    loader = RepeatingLoader([1, 2, 3])
    for _ in range(50):
        assert next(loader) == 1
        assert next(loader) == 2
        assert next(loader) == 3


def test_dataloader_batches():
    data = [(np.full((4,), i, np.float32), np.int32(i)) for i in range(10)]
    loader = DeepSpeedDataLoader(dataset=data, batch_size=2)
    batches = list(loader)
    assert len(batches) == len(loader) == 5
    x, y = batches[0]
    assert x.shape == (2, 4) and y.shape == (2,)
    assert float(x[1, 0]) == 1.0
    for got, want in zip(batches, jdl.DeepSpeedDataLoader(data, 2)):
        _equal(got, want)


@pytest.mark.parametrize("drop_last", [True, False])
def test_dataloader_drop_last(drop_last):
    data = [(np.zeros(2, np.float32), 0)] * 7
    loader = DeepSpeedDataLoader(dataset=data, batch_size=2,
                                 drop_last=drop_last)
    jloader = jdl.DeepSpeedDataLoader(dataset=data, batch_size=2,
                                      drop_last=drop_last)
    assert len(list(loader)) == len(loader) == len(jloader) == \
        (3 if drop_last else 4)
    for got, want in zip(loader, jloader):
        _equal(got, want)


def test_dataloader_dp_sharding():
    data = [(np.full((2,), i, np.float32), i) for i in range(8)]
    seen = []
    for rank in range(2):
        kw = dict(dataset=data, batch_size=2, data_parallel_world_size=2,
                  data_parallel_rank=rank)
        for got, want in zip(DeepSpeedDataLoader(**kw),
                             jdl.DeepSpeedDataLoader(**kw)):
            _equal(got, want)
            seen.extend(int(v) for v in got[1])
    assert sorted(seen) == list(range(8))


def test_dataloader_shuffle_epoch_rows_equal_jax():
    data = [(np.full((2,), i, np.float32), {"i": i}) for i in range(16)]
    loader = DeepSpeedDataLoader(dataset=data, batch_size=4, shuffle=True,
                                 seed=3)
    jloader = jdl.DeepSpeedDataLoader(dataset=data, batch_size=4,
                                      shuffle=True, seed=3)
    e0 = [int(v) for _, y in loader for v in y["i"]]
    loader.set_epoch(1)
    jloader.set_epoch(1)
    e1 = [int(v) for _, y in loader for v in y["i"]]
    assert sorted(e0) == sorted(e1) == list(range(16))
    assert e0 != e1
    for got, want in zip(loader, jloader):
        _equal(got, want)


def test_collate_fn_and_device_placement():
    data = [np.full((3,), i, np.int64) for i in range(6)]
    loader = DeepSpeedDataLoader(data, 3, collate_fn=lambda s: (
        torch.as_tensor(np.stack(s)), len(s)), device="cpu")
    (x, n), _ = list(loader)
    assert n == 3 and x.device.type == "cpu" and x[2, 0] == 2


def _ids_dataset(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, size=(32,)) for _ in range(n)]


def test_initialize_with_training_data_trains_like_jax():
    """initialize(training_data=...) returns the loader as its third value;
    train_batch(data_iter=RepeatingLoader(loader)) over six steps (the
    loader wraps around once) gives the JAX engine's loss trace, whose
    batches come from its own loader. The model's loss takes (ids, ids):
    the dataset's samples are (ids, ids) pairs."""
    ds = [(x, x) for x in _ids_dataset(8, 5)]
    cfg = {"train_batch_size": 2,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    jcfg = JGPT2Config.tiny(dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, JGPT2(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(ds[0][0][None]))["params"])
    mesh = mesh_lib.build_mesh(num_dp=1, devices=jax.devices()[:1])
    jeng, _, jloader, _ = jds.initialize(
        model=JGPT2(jcfg), model_parameters=jax.tree_util.tree_map(
            jnp.asarray, params), training_data=ds, config_params=cfg,
        mesh=mesh)
    teng, _, loader, _ = tds.initialize(
        model=GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.float32),
                              device="cpu", seed=None),
        model_parameters=params, training_data=ds, config_params=cfg,
        device="cpu")
    assert isinstance(loader, DeepSpeedDataLoader) and len(loader) == 4
    assert teng.training_dataloader is loader
    for got, want in zip(loader, jloader):
        _equal(got, want)
    jit, tit = RepeatingLoader(jloader), RepeatingLoader(loader)
    jl = [float(jeng.train_batch(data_iter=jit)) for _ in range(6)]
    tl = [float(teng.train_batch(data_iter=tit)) for _ in range(6)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert teng.global_steps == 6


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_engine_loader_reads_its_data_rank_share(rank):
    """Over several ranks ``initialize(training_data=...)`` hands the
    loader the engine's data-parallel size and rank: each rank reads its
    round-robin share, as the JAX loader at the same size and rank. (A
    three-rank grid with a stand-in group: nothing here runs a
    collective.)"""
    from deepspeed_tpu_torch.models.simple import SimpleModel
    from deepspeed_tpu_torch.parallel.mesh import Mesh

    rows = [(np.full(4, i, np.float32), np.int64(i % 4)) for i in range(18)]
    engine, _, loader, _ = tds.initialize(
        model=SimpleModel(4, device="cpu"), training_data=rows,
        config_params={"train_micro_batch_size_per_gpu": 2,
                       "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}},
        device="cpu", mesh=Mesh((1, 3, 1, 1), rank, object()))
    assert (loader.dp_world_size, loader.dp_rank) == (3, rank)
    assert engine.train_batch_size() == 6
    want = jdl.DeepSpeedDataLoader(rows, batch_size=2,
                                   data_parallel_world_size=3,
                                   data_parallel_rank=rank)
    got = list(loader)
    assert len(got) == len(want) == 3
    for batch, jbatch in zip(got, want):
        _equal(batch, jbatch)
        assert {int(v) % 3 for v in batch[0][:, 0]} == {rank}
