"""The host C++ LUT op (``csrc/host/lut.cpp``) against the JAX package.

``build_luts`` lowers every layout through the op; its tables must equal
the JAX package's ``build_luts`` and the port's numpy
``build_luts_reference`` exactly (dtype, shape, every entry), on the
Fixed, BigBird, BSLongformer and Variable layouts, on random layouts with
an empty row and an empty column, and on an all-zero head. A failed build
raises: there is no numpy fallback.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as J
from deepspeed_tpu_torch.op_builder import builder
from deepspeed_tpu_torch.ops import sparse_attention as T
from deepspeed_tpu_torch.ops.sparse_attention import kernels as TK

torch.set_num_threads(1)

CASES = [
    ("Fixed", dict(num_local_blocks=4, num_global_blocks=2,
                   horizontal_global_attention=True)),
    ("Fixed", dict(different_layout_per_head=True, num_local_blocks=4,
                   num_different_global_patterns=4,
                   attention="unidirectional")),
    ("BigBird", dict(num_random_blocks=2, seed=7)),
    ("BSLongformer", dict(num_sliding_window_blocks=5,
                          global_block_indices=[0, 4],
                          global_block_end_indices=[2, 6])),
    ("Variable", dict(num_random_blocks=2, local_window_blocks=[2, 3],
                      global_block_indices=[0, 5], seed=3)),
]


def _assert_exact(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_op_equals_jax_and_the_numpy_lowering(case):
    name, kw = CASES[case]
    layout = getattr(T, name + "SparsityConfig")(
        num_heads=4, block=16, **kw).make_layout(512)
    got = T.build_luts(layout)
    _assert_exact(got, J.build_luts(layout))
    _assert_exact(got, TK.build_luts_reference(layout))


def test_empty_rows_columns_and_heads():
    rng = np.random.RandomState(0)
    layout = (rng.rand(3, 24, 24) < 0.2).astype(np.int64)
    layout[0, 5, :] = 0   # a query block that attends to nothing
    layout[1, :, 7] = 0   # a key block no query block attends to
    layout[2] = 0         # a head with no block at all
    got = TK.build_luts(layout)
    _assert_exact(got, J.build_luts(layout))
    _assert_exact(got, TK.build_luts_reference(layout))
    assert (got[0][0, 5] == -1).all() and (got[1][1, 7] == -1).all()
    assert (got[0][2] == -1).all()
    zero = TK.build_luts(np.zeros((1, 4, 4), np.int32))
    assert [t.shape for t in zero] == [(1, 4, 1), (1, 4, 1)]


def test_a_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(builder, "_LOADED", {})
    monkeypatch.setattr(builder, "gxx_path", lambda: "false")
    monkeypatch.setattr(builder, "BUILD_ROOT", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for host/lut"):
        TK.build_luts(np.ones((1, 2, 2), np.int32))
