"""Sparsity layout configs (the port's own copy).

Port of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``, itself
after DeepSpeed's ``deepspeed/ops/sparse_attention/sparsity_config.py``:
``SparsityConfig`` base + Dense/Fixed/BigBird/BSLongformer/Variable
pattern generators. A *layout* is a boolean block mask
``(num_heads, seq_blocks, seq_blocks)``: entry ``[h, i, j]`` says whether
query block ``i`` of head ``h`` may attend key block ``j``. Layouts are
static per (config, seq_len), built on the host in numpy; the random
blocks of BigBird and Variable come from ``np.random.RandomState(seed)``
in the reference's call order, so the layouts equal the JAX package's bit
for bit. The CUDA kernels consume them as active-block index lists.
"""

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class SparsityConfig:
    """Reference ``sparsity_config.py SparsityConfig``."""
    num_heads: int = 1
    block: int = 16  # tokens per layout block
    different_layout_per_head: bool = False

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(f"seq_len {seq_len} must be a multiple of block {self.block}")
        nb = seq_len // self.block
        return np.zeros((self.num_heads, nb, nb), dtype=bool)

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError

    def _collapse_heads(self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[:] = layout[0:1]
        return layout


@dataclass
class DenseSparsityConfig(SparsityConfig):
    """Everything attends everything (debug/oracle)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = True
        return layout


@dataclass
class FixedSparsityConfig(SparsityConfig):
    """Reference ``FixedSparsityConfig``: local windows of
    ``num_local_blocks``; the last ``num_global_blocks`` block(s) of each
    window act as global — every later query block attends them, and with
    ``horizontal_global_attention`` they attend every block."""
    num_local_blocks: int = 4
    num_global_blocks: int = 1
    attention: str = "bidirectional"  # bidirectional | unidirectional
    horizontal_global_attention: bool = False
    num_different_global_patterns: int = 1

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        H, nb, _ = layout.shape
        L, G = self.num_local_blocks, self.num_global_blocks
        uni = self.attention == "unidirectional"
        for h in range(H):
            pat = (h % self.num_different_global_patterns) if self.different_layout_per_head else 0
            for i in range(nb):
                w = i // L
                lo, hi = w * L, min((w + 1) * L, nb)
                cols = range(lo, min(i + 1, hi)) if uni else range(lo, hi)
                layout[h, i, list(cols)] = True
            # global columns: last G blocks of each window, shifted by pattern
            for w in range(-(-nb // L)):
                g_lo = min(w * L + L - (pat + 1) * G, nb - G)
                g_lo = max(g_lo, w * L)
                for g in range(g_lo, min(g_lo + G, nb)):
                    if uni:
                        layout[h, g:, g] = True  # later rows see the global block
                    else:
                        layout[h, :, g] = True
                    if self.horizontal_global_attention:
                        layout[h, g, : (g + 1) if uni else nb] = True
        return self._collapse_heads(layout)


@dataclass
class BSLongformerSparsityConfig(SparsityConfig):
    """Reference ``BSLongformerSparsityConfig``: sliding window + chosen
    global blocks (rows and columns)."""
    num_sliding_window_blocks: int = 3
    global_block_indices: List[int] = field(default_factory=lambda: [0])
    global_block_end_indices: Optional[List[int]] = None
    attention: str = "bidirectional"

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        H, nb, _ = layout.shape
        w = self.num_sliding_window_blocks // 2
        uni = self.attention == "unidirectional"
        for i in range(nb):
            lo = max(0, i - w)
            hi = min(nb, i + 1 if uni else i + w + 1)
            layout[:, i, lo:hi] = True
        ends = self.global_block_end_indices
        spans = [(g, (ends[k] if ends else g + 1)) for k, g in enumerate(self.global_block_indices)]
        for lo, hi in spans:
            hi = min(hi, nb)
            if lo >= nb:
                continue
            if uni:
                for g in range(lo, hi):
                    layout[:, g:, g] = True
                    layout[:, g, :g + 1] = True
            else:
                layout[:, :, lo:hi] = True
                layout[:, lo:hi, :] = True
        return self._collapse_heads(layout)


@dataclass
class BigBirdSparsityConfig(SparsityConfig):
    """Reference ``BigBirdSparsityConfig``: sliding window + first/last
    global blocks + per-row random blocks (fixed seed: layouts are
    static)."""
    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1
    attention: str = "bidirectional"
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        H, nb, _ = layout.shape
        w = self.num_sliding_window_blocks // 2
        uni = self.attention == "unidirectional"
        rng = np.random.RandomState(self.seed)
        for i in range(nb):
            lo = max(0, i - w)
            hi = min(nb, i + 1 if uni else i + w + 1)
            layout[:, i, lo:hi] = True
        G = self.num_global_blocks
        if uni:
            for g in range(min(G, nb)):
                layout[:, g:, g] = True
                layout[:, g, :g + 1] = True
        else:
            layout[:, :, :G] = True
            layout[:, :, nb - G:] = True
            layout[:, :G, :] = True
            layout[:, nb - G:, :] = True
        for h in range(H if self.different_layout_per_head else 1):
            for i in range(nb):
                limit = i + 1 if uni else nb
                if limit <= 0:
                    continue
                picks = rng.randint(0, limit, size=self.num_random_blocks)
                layout[h, i, picks] = True
        return self._collapse_heads(layout)


@dataclass
class VariableSparsityConfig(SparsityConfig):
    """Reference ``VariableSparsityConfig``: variable-width local windows
    + explicit global indices."""
    num_random_blocks: int = 0
    local_window_blocks: List[int] = field(default_factory=lambda: [4])
    global_block_indices: List[int] = field(default_factory=lambda: [0])
    global_block_end_indices: Optional[List[int]] = None
    attention: str = "bidirectional"
    horizontal_global_attention: bool = False
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        H, nb, _ = layout.shape
        uni = self.attention == "unidirectional"
        # variable local windows: consume local_window_blocks sizes in order,
        # the last size repeats (reference semantics)
        sizes = list(self.local_window_blocks)
        start = 0
        k = 0
        while start < nb:
            size = sizes[min(k, len(sizes) - 1)]
            end = min(start + size, nb)
            for i in range(start, end):
                cols = range(start, min(i + 1, end)) if uni else range(start, end)
                layout[:, i, list(cols)] = True
            start = end
            k += 1
        ends = self.global_block_end_indices
        spans = [(g, (ends[j] if ends else g + 1)) for j, g in enumerate(self.global_block_indices)]
        for lo, hi in spans:
            hi = min(hi, nb)
            if lo >= nb:
                continue
            if uni:
                for g in range(lo, hi):
                    layout[:, g:, g] = True
                    if self.horizontal_global_attention:
                        layout[:, g, :g + 1] = True
            else:
                layout[:, :, lo:hi] = True
                if self.horizontal_global_attention:
                    layout[:, lo:hi, :] = True
        if self.num_random_blocks:
            rng = np.random.RandomState(self.seed)
            for h in range(H if self.different_layout_per_head else 1):
                for i in range(nb):
                    limit = i + 1 if uni else nb
                    picks = rng.randint(0, limit, size=self.num_random_blocks)
                    layout[h, i, picks] = True
        return self._collapse_heads(layout)
