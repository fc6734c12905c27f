"""Compressed sparse-row tensors for sparse (embedding) gradients.

Counterpart of ``deepspeed_tpu/runtime/csr_tensor.py``. A ``CSRTensor``
holds the row indices and value rows of a dense tensor's non-zero rows.
Across data-parallel ranks the exchange is an all-gather of padded
(index, value) pairs, then a scatter-add, instead of an all-reduce of the
whole table (``csr_allreduce``, ``sparse_grad_exchange``); the
collectives are ``parallel/comm.py``'s over a process group (the JAX
functions run inside ``shard_map`` over a mesh axis).
"""

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.parallel import comm


class CSRTensor(object):
    """Compressed Sparse Row format: row indices + dense value rows."""

    def __init__(self, dense_tensor=None, indices=None, values=None,
                 dense_size=None):
        self.orig_dense_tensor = dense_tensor
        if dense_tensor is not None:
            # Rows with any non-zero entry are kept (embedding-gradient
            # sparsity: rows a batch never touched are all zero).
            row_mask = (dense_tensor != 0).reshape(
                dense_tensor.shape[0], -1).any(dim=1)
            self.indices = torch.nonzero(row_mask)[:, 0]
            self.values = dense_tensor[self.indices]
            self.dense_size = tuple(dense_tensor.shape)
        else:
            self.indices = indices
            self.values = values
            self.dense_size = tuple(dense_size) if dense_size is not None \
                else None

    @staticmethod
    def type():
        return "deepspeed_tpu_torch.CSRTensor"

    def to_dense(self):
        dense = torch.zeros(self.dense_size, dtype=self.values.dtype,
                            device=self.values.device)
        return dense.index_add_(0, self.indices.to(torch.int64),
                                self.values)

    def sparse_size(self):
        index_size = self.indices.shape[0]
        row_size = 1
        for d in self.dense_size[1:]:
            row_size *= d
        sparse_size = index_size + index_size * row_size
        dense_size = 1
        for d in self.dense_size:
            dense_size *= d
        return sparse_size, dense_size

    def add(self, b):
        assert self.dense_size == b.dense_size
        self.indices = torch.cat([self.indices, b.indices])
        self.values = torch.cat([self.values, b.values])

    def __str__(self):
        sparse_size, dense_size = self.sparse_size()
        return ("DeepSpeed.CSRTensor(indices_size={}, values_size={}, "
                "dense_size={}, device={}, reduction_factor={:.2f})".format(
                    tuple(self.indices.shape), tuple(self.values.shape),
                    self.dense_size, self.values.device,
                    dense_size / max(sparse_size, 1)))

    def __repr__(self):
        return self.__str__()


def pad_csr(indices, values, target_rows):
    """Pad a CSR pair to ``target_rows`` rows for the exchange: padding
    rows point at index 0 with all-zero values, so the scatter-add is
    unaffected. Raises ValueError when the pair has more rows (gradient
    would be dropped)."""
    k = indices.shape[0]
    if k > target_rows:
        raise ValueError(
            "pad_csr: {} nonzero rows exceed the exchange budget of {} - "
            "raise target_rows or gradients would be silently dropped"
            .format(k, target_rows))
    if k == target_rows:
        return indices, values
    pad_n = target_rows - k
    idx = torch.cat([indices, indices.new_zeros(pad_n)])
    val = torch.cat([values, values.new_zeros((pad_n,) + values.shape[1:])])
    return idx, val


def csr_allreduce(indices, values, group, average=True):
    """All-gather every rank's (padded, equal-shaped) index/value pair over
    ``group``. Returns the merged (indices [W*k], values [W*k, ...]) with
    duplicates left in place: ``CSRTensor.to_dense`` scatter-adds them. With
    ``average`` the values are divided by the group size."""
    w = dist.get_world_size(group)
    idx_g = comm.all_gather(indices.reshape(-1).to(torch.int64), group)
    val_g = comm.all_gather(values.reshape(-1).contiguous(), group)
    val_g = val_g.reshape((w * values.shape[0],) + tuple(values.shape[1:]))
    if average:
        val_g = val_g / w
    return idx_g, val_g


def sparse_grad_exchange(grad, group, k, average=True):
    """The data-parallel sum (or mean) of a row-sparse gradient (an
    embedding table's: at most one touched row per input token) as an
    exchange of ``k`` (row index, row value) pairs per rank. ``k`` bounds a
    rank's non-zero rows (its token count). When ``k`` covers the table, or
    any rank has more than ``k`` non-zero rows (a tied softmax head makes
    every row non-zero; the count is agreed over the group so every rank
    takes the same path), the gradient is all-reduced densely instead."""
    vocab = grad.shape[0]
    k = min(int(k), vocab)
    if k == vocab:
        return comm.all_reduce(grad.clone(), group, mean=average)
    row_mask = (grad != 0).reshape(vocab, -1).any(dim=1)
    over = (row_mask.sum() > k).to(torch.int32).reshape(1)
    if int(comm.all_reduce(over, group)) > 0:
        return comm.all_reduce(grad.clone(), group, mean=average)
    _, idx = torch.topk(row_mask.to(torch.int32), k)
    idx_g, val_g = csr_allreduce(idx, grad[idx], group, average=average)
    return torch.zeros_like(grad).index_add_(0, idx_g, val_g)


def split_half_float_double_csr(tensors):
    """Bucket tensors by dtype, CSR tensors in their own bucket (the
    reference's engine.py:54-66): (dtype name, bucket) pairs in the order
    bfloat16, float16, float32, float64, CSR, other."""
    order = ["bfloat16", "float16", "float32", "float64", CSRTensor.type()]
    groups = {}
    for t in tensors:
        key = CSRTensor.type() if isinstance(t, CSRTensor) \
            else str(t.dtype).replace("torch.", "")
        groups.setdefault(key if key in order else "other", []).append(t)
    return [(dtype, groups[dtype]) for dtype in order + ["other"]
            if dtype in groups]
