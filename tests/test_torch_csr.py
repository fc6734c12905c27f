"""Port parity for CSR (sparse) gradients: ``runtime/csr_tensor.py``
against ``deepspeed_tpu/runtime/csr_tensor.py`` (round trips, sizes,
padding, dtype buckets), the exchange over two gloo ranks against the JAX
functions under ``shard_map`` on two devices (both of its paths), and the
engine's ``sparse_gradients`` step at data-parallel size 2 against the
JAX engine's on a 2-device mesh.

Tolerances: the exchanges 1e-6 (fp32 sums of two values in another
order); the engine's losses 1e-5 relative and its fp32 masters 1e-5 of
each tensor's max-abs (the training rule of ``test_torch_zero_dp.py``).
"""

from functools import partial

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import deepspeed_tpu as jds
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.runtime import csr_tensor as jcsr
from deepspeed_tpu.runtime.engine import \
    split_half_float_double_csr as jsplit
from deepspeed_tpu.utils.jax_compat import shard_map
from deepspeed_tpu_torch.runtime import csr_tensor as tcsr
from tests.torch_dist_worker import run_ranks

torch.set_num_threads(1)

VOCAB, DIM = 64, 16


class EmbedModel(nn.Module):
    """The JAX CSR test's model (its twin is the worker's EmbedModel)."""

    @nn.compact
    def __call__(self, ids, y):
        h = nn.Embed(VOCAB, DIM, name="embed")(ids).mean(axis=1)
        logp = nn.log_softmax(nn.Dense(VOCAB)(h))
        return -jnp.mean(jnp.take_along_axis(logp, y[..., None], axis=-1))


def _batches():
    out = []
    for i in range(5):
        rng = np.random.RandomState(i % 2)
        out.append((rng.randint(0, VOCAB, size=(8, 4)),
                    rng.randint(0, VOCAB, size=(8,))))
    return out


def _cfg(sparse):
    return {"train_batch_size": 8, "sparse_gradients": sparse,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}


def _grads():
    rng = np.random.RandomState(0)
    grads = np.zeros((2, 12, 3), np.float32)
    for r in range(2):
        grads[r, rng.choice(12, 3, replace=False)] = rng.randn(3, 3)
    return grads


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    params = jax.tree_util.tree_map(np.array, EmbedModel().init(
        jax.random.PRNGKey(0), np.zeros((2, 4), np.int32),
        np.zeros(2, np.int32))["params"])
    tasks = [dict(name="coll", kind="collectives", grads=_grads(), k=3)]
    tasks += [dict(name="embed_{}".format(sparse), kind="train",
                   model="embed", params=params, config=_cfg(sparse),
                   batches=_batches()) for sparse in (True, False)]
    return params, run_ranks(2, tasks, str(tmp_path_factory.mktemp("csr")))


def test_csr_round_trip_matches_jax():
    dense = np.zeros((10, 4), np.float32)
    dense[2], dense[7] = 1.0, -2.0
    want = jcsr.CSRTensor(jnp.asarray(dense))
    got = tcsr.CSRTensor(torch.from_numpy(dense))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(
        want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(
        want.values))
    np.testing.assert_array_equal(got.to_dense().numpy(), dense)
    assert got.dense_size == want.dense_size


def test_csr_sparse_size_and_add_match_jax():
    dense = np.zeros((10, 4), np.float32)
    dense[1] = 3.0
    a, b = (tcsr.CSRTensor(torch.from_numpy(dense)) for _ in range(2))
    ja, jb = (jcsr.CSRTensor(jnp.asarray(dense)) for _ in range(2))
    a.add(b)
    ja.add(jb)
    assert a.sparse_size() == ja.sparse_size() == (10, 40)
    np.testing.assert_array_equal(a.to_dense().numpy(),
                                  np.asarray(ja.to_dense()))


def test_pad_csr_matches_jax():
    idx, val = np.asarray([3, 5]), np.ones((2, 4), np.float32)
    got = tcsr.pad_csr(torch.from_numpy(idx), torch.from_numpy(val), 5)
    want = jcsr.pad_csr(jnp.asarray(idx), jnp.asarray(val), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="exchange budget"):
        tcsr.pad_csr(torch.from_numpy(idx), torch.from_numpy(val), 1)


def test_split_half_float_double_csr_matches_jax():
    dense = np.zeros((4, 2), np.float32)
    dense[1] = 1.0
    got = dict(tcsr.split_half_float_double_csr([
        torch.zeros(2, dtype=torch.bfloat16), torch.zeros(2),
        tcsr.CSRTensor(torch.from_numpy(dense)), torch.ones(3),
        torch.zeros(2, dtype=torch.int32)]))
    want = dict(jsplit([
        jnp.zeros((2,), jnp.bfloat16), jnp.zeros((2,), jnp.float32),
        jcsr.CSRTensor(jnp.asarray(dense)), jnp.ones((3,), jnp.float32),
        jnp.zeros((2,), jnp.int32)]))
    rename = {jcsr.CSRTensor.type(): tcsr.CSRTensor.type()}
    assert list(got) == [rename.get(k, k) for k in want]
    assert [len(v) for v in got.values()] == [len(v) for v in want.values()]


def _jax_exchange(k):
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))

    @partial(shard_map, mesh=mesh, in_specs=P("data"), out_specs=P("data"),
             check_vma=False)
    def f(g):
        return jcsr.sparse_grad_exchange(g[0], "data", k)[None]

    return np.asarray(f(jnp.asarray(_grads())))


@pytest.mark.parametrize("path", ["sparse", "dense_k"])
def test_sparse_grad_exchange_matches_jax(ranks, path):
    """k = 3 rows per rank takes the (row, value) exchange; k = 1 is
    exceeded on every rank and takes the dense all-reduce. Both give the
    JAX function's result (and the dense mean)."""
    _, res = ranks
    want = _jax_exchange(3 if path == "sparse" else 1)
    mean = _grads().mean(0)
    for r in range(2):
        np.testing.assert_allclose(res[r]["coll"][path], want[r],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(res[r]["coll"][path], mean, rtol=1e-6,
                                   atol=1e-7)


def test_csr_allreduce_to_dense_is_the_mean(ranks):
    _, res = ranks
    for r in range(2):
        np.testing.assert_allclose(res[r]["coll"]["csr"], _grads().mean(0),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("sparse", [True, False])
def test_engine_sparse_gradients_match_the_jax_engine(ranks, sparse):
    """Five steps at dp 2: the port's losses and masters against the JAX
    engine's with the same ``sparse_gradients`` (the sparse run exchanges
    the embedding table with all-gathers, the dense run none)."""
    params, res = ranks
    mesh = jmesh.build_mesh(devices=jax.devices()[:2])
    engine = jds.initialize(model=EmbedModel(), model_parameters=jax
                            .tree_util.tree_map(jnp.asarray, params),
                            config_params=_cfg(sparse), mesh=mesh)[0]
    want = []
    for ids, y in _batches():
        loss = engine(ids, y)
        engine.backward(loss)
        engine.step()
        want.append(float(loss))
    got = res[0]["embed_{}".format(sparse)]
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    flat = {"embed.embedding": engine.params["embed"]["embedding"],
            "Dense_0.kernel": engine.params["Dense_0"]["kernel"],
            "Dense_0.bias": engine.params["Dense_0"]["bias"]}
    for name, w in flat.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got["masters"][name], w,
                                   atol=1e-5 * np.abs(w).max(), rtol=0)
    gathers = got["all_gathers"]
    assert all(n > 0 for n in gathers) if sparse else set(gathers) == {0}


def test_engine_csr_allreduce_at_one_rank_copies():
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models.simple import SimpleModel

    engine = tds.initialize(model=SimpleModel(8, device="cpu"),
                            config_params=dict(_cfg(True)), device="cpu")[0]
    assert engine.sparse_gradients_enabled()
    dense = torch.zeros(6, 2)
    dense[1] = 1.0
    csr = tcsr.CSRTensor(dense)
    out = engine.csr_allreduce_no_retain([csr])
    assert len(out) == 1 and out[0] is not csr
    np.testing.assert_array_equal(out[0].to_dense().numpy(), dense.numpy())
    assert engine.sparse_allreduce_bucket([csr])[0].dense_size == (6, 2)
