"""Block-sparse attention layout configurations.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``,
kept as a copy (the port imports nothing of the JAX package): the same five
patterns (Dense, Fixed, Variable, BigBird, BSLongformer) with the same
constructor parameters, the same seeded random blocks, and the same
``make_layout(seq_len) -> [num_heads, num_blocks, num_blocks]`` contract,
built with vectorized numpy index arithmetic. A layout is host metadata: it
is lowered to lookup tables that steer kernels K7a/K7b (``kernels.py``).
"""

import numpy as np


class SparsityConfig:
    """Base class: shared block/head bookkeeping for all sparsity patterns.

    Arguments mirror the reference (sparsity_config.py:13-27):
      num_heads: attention heads in the layer.
      block: side of the square attention blocks (block x block).
      different_layout_per_head: if False (default) head 0's layout is
        propagated to all heads.
    """

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len):
        """Zero-initialized [num_heads, num_blocks, num_blocks] layout."""
        if seq_len % self.block != 0:
            raise ValueError(
                'Sequence Length, {}, needs to be dividable by Block size {}!'
                .format(seq_len, self.block))
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks), dtype=np.int64)

    def check_and_propagate_first_head_layout(self, layout):
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len):
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """Degenerate all-ones layout — dense attention expressed in the
    block-sparse machinery (reference sparsity_config.py:63-91)."""

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformer style fixed pattern: dense local windows of
    `num_local_blocks`, plus per-window global representative column blocks
    (reference sparsity_config.py:94-240; Child et al. 2019)."""

    def __init__(self,
                 num_heads,
                 block=16,
                 different_layout_per_head=False,
                 num_local_blocks=4,
                 num_global_blocks=1,
                 attention='bidirectional',
                 horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(
                'Number of blocks in a local window, {}, must be dividable by '
                'number of global blocks, {}!'.format(num_local_blocks,
                                                      num_global_blocks))
        self.num_global_blocks = num_global_blocks
        if attention not in ('unidirectional', 'bidirectional'):
            raise NotImplementedError(
                'only "uni/bi-directional" attentions are supported for now!')
        self.attention = attention
        if attention != 'bidirectional' and horizontal_global_attention:
            raise ValueError(
                'only "bi-directional" attentions can support horizontal '
                'global attention!')
        self.horizontal_global_attention = horizontal_global_attention
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                'Number of different layouts cannot be more than one when you '
                'have set a single layout for all heads! Set '
                'different_layout_per_head to True.')
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError(
                'Number of layout versions (num_different_global_patterns), '
                '{}, cannot be larger than number of local window blocks '
                'divided by number of global blocks, {} / {} = {}!'.format(
                    num_different_global_patterns, num_local_blocks,
                    num_global_blocks, num_local_blocks // num_global_blocks))
        self.num_different_global_patterns = num_different_global_patterns

    def set_local_layout(self, h, layout):
        """Dense (or, for unidirectional, lower-triangular) block windows of
        num_local_blocks along the diagonal."""
        num_blocks = layout.shape[1]
        row = np.arange(num_blocks)[:, None]
        col = np.arange(num_blocks)[None, :]
        same_window = (row // self.num_local_blocks) == (col // self.num_local_blocks)
        if self.attention == 'unidirectional':
            same_window &= col <= row
        layout[h][same_window] = 1
        return layout

    def set_global_layout(self, h, layout):
        """Column-global blocks: in each local window the representative block
        (last minus h-dependent offset) is attended by all following rows
        (bidirectional: all rows). horizontal_global_attention mirrors the
        stripe across the row too."""
        num_blocks = layout.shape[1]
        first_global = self.num_local_blocks - (
            1 + h % self.num_different_global_patterns) * self.num_global_blocks

        end = num_blocks - (num_blocks % self.num_local_blocks)
        starts = list(range(first_global, end, self.num_local_blocks))
        # Possible short last window: clamp its global block into range.
        if end < num_blocks:
            starts.append(min(end + first_global,
                              num_blocks - self.num_global_blocks))
        for i in starts:
            first_row = 0 if self.attention == 'bidirectional' else i
            layout[h, first_row:, i:i + self.num_global_blocks] = 1
            if self.horizontal_global_attention:
                layout[h, i:i + self.num_global_blocks, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_local_layout(h, layout)
            layout = self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Fixed pattern generalized: random blocks, variable-size local windows,
    explicit global block index lists (reference sparsity_config.py:243-418)."""

    def __init__(self,
                 num_heads,
                 block=16,
                 different_layout_per_head=False,
                 num_random_blocks=0,
                 local_window_blocks=None,
                 global_block_indices=None,
                 global_block_end_indices=None,
                 attention='bidirectional',
                 horizontal_global_attention=False,
                 seed=None):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = (local_window_blocks
                                    if local_window_blocks is not None else [4])
        self.global_block_indices = (global_block_indices
                                     if global_block_indices is not None else [0])
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    'Global block start indices length, {}, must be same as '
                    'global block end indices length, {}!'.format(
                        len(self.global_block_indices),
                        len(global_block_end_indices)))
            for start_idx, end_idx in zip(self.global_block_indices,
                                          global_block_end_indices):
                if start_idx >= end_idx:
                    raise ValueError(
                        'Global block start index, {}, must be smaller than '
                        'global block end index, {}!'.format(start_idx, end_idx))
        self.global_block_end_indices = global_block_end_indices
        if attention not in ('unidirectional', 'bidirectional'):
            raise NotImplementedError(
                'only "uni/bi-directional" attentions are supported for now!')
        self.attention = attention
        if attention != 'bidirectional' and horizontal_global_attention:
            raise ValueError(
                'only "bi-directional" attentions can support horizontal '
                'global attention!')
        self.horizontal_global_attention = horizontal_global_attention
        # Unlike the reference (which consumes python's global `random`), the
        # random pattern is seedable so layouts are reproducible constants,
        # the same in every process (and equal to the JAX package's).
        # seed=None still gets ONE concrete, PROCESS-INDEPENDENT seed:
        # default_rng(None) would draw fresh entropy per call (breaking the
        # repeated-make_layout invariant) and per process (every host must
        # build the SAME layout — divergent patterns with allreduced grads
        # would silently corrupt multi-host training).
        self._seed = seed if seed is not None else 0x5eed
        self._rng = np.random.default_rng(self._seed)

    def set_random_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if num_blocks < self.num_random_blocks:
            raise ValueError(
                'Number of random blocks, {}, must be smaller than overal '
                'number of blocks in a row, {}!'.format(self.num_random_blocks,
                                                        num_blocks))
        for row in range(num_blocks):
            rnd_cols = self._rng.choice(num_blocks, self.num_random_blocks,
                                        replace=False)
            layout[h, row, rnd_cols] = 1
        return layout

    def set_local_layout(self, h, layout):
        num_blocks = layout.shape[1]
        start = 0
        block_size = self.local_window_blocks[-1]
        for size in self.local_window_blocks:
            end = min(start + size, num_blocks)
            self._fill_window(h, layout, start, end)
            start += size
        # Remaining sequence: repeat the last window size.
        while start < num_blocks:
            end = min(start + block_size, num_blocks)
            self._fill_window(h, layout, start, end)
            start += block_size
        return layout

    def _fill_window(self, h, layout, start, end):
        if start >= end:
            return
        n = end - start
        row = np.arange(n)[:, None]
        col = np.arange(n)[None, :]
        keep = col <= row if self.attention == 'unidirectional' else np.ones(
            (n, n), dtype=bool)
        layout[h, start:end, start:end][keep] = 1

    def set_global_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for start_idx, end_idx in spans:
            if start_idx >= num_blocks:
                continue
            end_idx = min(end_idx, num_blocks)
            if self.horizontal_global_attention:
                layout[h, start_idx:end_idx, :] = 1
            first_row = 0 if self.attention == 'bidirectional' else start_idx
            layout[h, first_row:, start_idx:end_idx] = 1
        return layout

    def make_layout(self, seq_len):
        # Reseed per call: repeated make_layout on one config must yield the
        # SAME layout (callers treat the layout as a pure function of the
        # config; a stateful rng would silently diverge between calls).
        self._rng = np.random.default_rng(self._seed)
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_random_layout(h, layout)
            layout = self.set_local_layout(h, layout)
            layout = self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird ITC pattern: random + sliding window + leading global blocks
    (reference sparsity_config.py:421-541; Zaheer et al. 2020)."""

    def __init__(self,
                 num_heads,
                 block=16,
                 different_layout_per_head=False,
                 num_random_blocks=1,
                 num_sliding_window_blocks=3,
                 num_global_blocks=1,
                 seed=None):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        # Process-independent default seed (see VariableSparsityConfig).
        self._seed = seed if seed is not None else 0x5eed
        self._rng = np.random.default_rng(self._seed)

    def set_random_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if num_blocks < self.num_random_blocks:
            raise ValueError(
                'Number of random blocks, {}, must be smaller than overal '
                'number of blocks in a row, {}!'.format(self.num_random_blocks,
                                                        num_blocks))
        for row in range(num_blocks):
            rnd_cols = self._rng.choice(num_blocks, self.num_random_blocks,
                                        replace=False)
            layout[h, row, rnd_cols] = 1
        return layout

    def set_sliding_window_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if num_blocks < self.num_sliding_window_blocks:
            raise ValueError(
                'Number of sliding window blocks, {}, must be smaller than '
                'overal number of blocks in a row, {}!'.format(
                    self.num_sliding_window_blocks, num_blocks))
        w = self.num_sliding_window_blocks // 2
        row = np.arange(num_blocks)[:, None]
        col = np.arange(num_blocks)[None, :]
        layout[h][np.abs(row - col) <= w] = 1
        return layout

    def set_global_layout_itc(self, h, layout):
        num_blocks = layout.shape[1]
        if num_blocks < self.num_global_blocks:
            raise ValueError(
                'Number of global blocks, {}, must be smaller than overal '
                'number of blocks in a row, {}!'.format(self.num_global_blocks,
                                                        num_blocks))
        layout[h, :self.num_global_blocks, :] = 1
        layout[h, :, :self.num_global_blocks] = 1
        return layout

    def make_layout(self, seq_len):
        # Reseed per call so repeated layouts are identical (see
        # VariableSparsityConfig.make_layout).
        self._rng = np.random.default_rng(self._seed)
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_random_layout(h, layout)
            layout = self.set_sliding_window_layout(h, layout)
            layout = self.set_global_layout_itc(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + symmetric global row/column
    stripes at given block indices (reference sparsity_config.py:544-669)."""

    def __init__(self,
                 num_heads,
                 block=16,
                 different_layout_per_head=False,
                 num_sliding_window_blocks=3,
                 global_block_indices=None,
                 global_block_end_indices=None):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = (global_block_indices
                                     if global_block_indices is not None else [0])
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    'Global block start indices length, {}, must be same as '
                    'global block end indices length, {}!'.format(
                        len(self.global_block_indices),
                        len(global_block_end_indices)))
            for start_idx, end_idx in zip(self.global_block_indices,
                                          global_block_end_indices):
                if start_idx >= end_idx:
                    raise ValueError(
                        'Global block start index, {}, must be smaller than '
                        'global block end index, {}!'.format(start_idx, end_idx))
        self.global_block_end_indices = global_block_end_indices

    def set_sliding_window_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if num_blocks < self.num_sliding_window_blocks:
            raise ValueError(
                'Number of sliding window blocks, {}, must be smaller than '
                'overal number of blocks in a row, {}!'.format(
                    self.num_sliding_window_blocks, num_blocks))
        w = self.num_sliding_window_blocks // 2
        row = np.arange(num_blocks)[:, None]
        col = np.arange(num_blocks)[None, :]
        layout[h][np.abs(row - col) <= w] = 1
        return layout

    def set_global_layout(self, h, layout):
        num_blocks = layout.shape[1]
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for start_idx, end_idx in spans:
            if start_idx >= num_blocks:
                continue
            end_idx = min(end_idx, num_blocks)
            layout[h, start_idx:end_idx, :] = 1
            layout[h, :, start_idx:end_idx] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self.set_sliding_window_layout(h, layout)
            layout = self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)
