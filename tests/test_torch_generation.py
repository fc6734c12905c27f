"""Port parity: deepspeed_tpu_torch.models.generation against the JAX
package's models/generation.py, on the CPU.

One tiny fp32 GPT-2 is initialised in flax and carried into the port with
``params_from_jax``. The same token ids go through both packages'
``append_forward`` / ``decode_step`` with ragged per-row frontiers, and the
logits must agree within 1e-4, against the JAX einsum path and against the
JAX flash-decode path (the Pallas kernel in interpret mode). Greedy
``generate`` must emit the same tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import generation as jgen
from deepspeed_tpu.models.gpt2 import GPT2Config as JConfig
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JModel
from deepspeed_tpu_torch.models import GPT2Config, params_from_jax
from deepspeed_tpu_torch.models import generation as tgen

torch.set_num_threads(1)

_CACHE = {}


def models():
    if not _CACHE:
        jcfg = JConfig.tiny(dropout=0.0, dtype=jnp.float32,
                            use_flash_attention=False)
        ids = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 12))
        params = JModel(jcfg).init(jax.random.PRNGKey(0),
                                   jnp.asarray(ids))["params"]
        tree = jax.tree_util.tree_map(np.asarray, params)
        port = params_from_jax(tree, GPT2Config.tiny(dtype=torch.float32),
                               device="cpu")
        _CACHE.update(jcfg=jcfg, params=params, port=port)
    return _CACHE["jcfg"], _CACHE["params"], _CACHE["port"]


def test_params_from_jax_keeps_flax_names_and_layouts():
    jcfg, params, port = models()
    np.testing.assert_array_equal(
        port.h_1.attn.c_attn.kernel.numpy(),
        np.asarray(params["h_1"]["attn"]["c_attn"]["kernel"]))
    assert tuple(port.h_0.mlp.c_fc.kernel.shape) == (64, 256)  # [in, out]
    with pytest.raises(KeyError):
        params_from_jax({"wte": np.zeros((1024, 64), np.float32)},
                        GPT2Config.tiny(dtype=torch.float32), device="cpu")


@pytest.mark.parametrize("flash", [False, True])
def test_append_and_decode_logits_match_jax(flash):
    """Ragged frontiers: one prompt slice with n_valid (16, 9, 4), a second
    slice, then three decode steps; logits compared after every call."""
    jcfg, params, port = models()
    gcfg = jgen.as_gencfg(jcfg, use_flash_decode=flash)
    rng = np.random.RandomState(1)
    B, T = 3, 128  # T: a multiple of the Pallas kernel's block quantum
    jcache = jgen.init_cache(gcfg, B, T)
    tcache = tgen.init_cache(tgen.as_gencfg(port.config), B, T,
                             device="cpu")
    for S, n_valid in ((16, [16, 9, 4]), (8, [8, 8, 8])):
        ids = rng.randint(0, jcfg.vocab_size, (B, S))
        nv = np.asarray(n_valid, np.int32)
        jl, jcache = jgen.append_forward(params, gcfg, jnp.asarray(ids),
                                         jcache, n_valid=jnp.asarray(nv))
        tl, tcache = tgen.append_forward(port, torch.from_numpy(ids), tcache,
                                         n_valid=torch.from_numpy(nv))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
    for _ in range(3):
        tok = rng.randint(0, jcfg.vocab_size, (B,))
        jl, jcache = jgen.decode_step(params, gcfg, jnp.asarray(tok), jcache)
        tl, tcache = tgen.decode_step(port, torch.from_numpy(tok), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
    np.testing.assert_array_equal(tcache["pos"].numpy(), [27, 20, 15])


@pytest.mark.parametrize("flash", [False, True])
def test_greedy_generate_tokens_match_jax(flash):
    jcfg, params, port = models()
    jmodel = JModel(JConfig.tiny(dropout=0.0, dtype=jnp.float32,
                                 use_flash_attention=False,
                                 use_flash_decode=flash))
    ids = np.random.RandomState(2).randint(0, jcfg.vocab_size, (2, 10))
    want = jgen.generate(jmodel, params, ids, 8, temperature=0.0)
    got = tgen.generate(port, ids, 8, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_frontier_write_past_the_plane_raises():
    """The frontier write never clamps: a slice that runs off the plane is
    an error, not a shifted write onto live positions."""
    _, _, port = models()
    cache = tgen.init_cache(tgen.as_gencfg(port.config), 1, 16,
                            device="cpu")
    cache["pos"][0] = 12
    with pytest.raises(IndexError):
        tgen.append_forward(port, torch.zeros(1, 8, dtype=torch.int64), cache)


@pytest.mark.parametrize("layout", ["int8", "paged", "prefix"])
def test_unported_cache_layouts_raise(layout):
    """The shared-prefix layout is not ported: a ``pk`` plane raises, on a
    dense fp cache and over the int8 and paged layouts alike."""
    _, _, port = models()
    cache = tgen.init_cache(tgen.as_gencfg(port.config), 1, 16,
                            device="cpu")
    if layout == "int8":
        cache["k"] = cache["k"].to(torch.int8)
    elif layout == "paged":
        cache["block_tbl"] = torch.zeros(1, 1, dtype=torch.int32)
    cache["pk"] = torch.zeros(1)
    with pytest.raises(NotImplementedError):
        tgen.decode_step(port, torch.zeros(1, dtype=torch.int64), cache)
