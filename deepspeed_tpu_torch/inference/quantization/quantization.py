"""Post-load weight-only quantisation for serving.

Port of the serving part of ``deepspeed_tpu/inference/quantization/
quantization.py``: int8 or packed-int4 codes plus group scales live in the
parameter tree as ``QuantizedParam`` leaves in the matmul-native "kgroups"
layout, and the fused dequantise-matmul kernel (``ops/quantized_matmul.py``)
consumes them without ever materialising the dense weight. The flat
group-wise layout of the reference (``quantize_param``,
``quantize_model_params``, ``QuantizationContext``) is not ported.
"""

import logging
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ...ops.quantized_matmul import _dequantize_kgroups, quantize_weight_kgroups

logger = logging.getLogger(__name__)


@dataclass
class QuantizedParam:
    """int8-coded parameter + group scales, a leaf of the parameter tree.

    ``layout``: "kgroups" = matmul-native ``q (K, N)`` + ``scales (K/g, N)``;
    "kgroups_p4" = the same with two int4 codes per stored byte, ``q (K/2, N)``."""
    q: torch.Tensor          # int8 codes
    scales: torch.Tensor     # fp32 group scales
    shape: Tuple[int, ...]   # original shape
    dtype: Any               # original dtype
    num_bits: int = 8
    layout: str = "kgroups"

    @property
    def nbytes_quantized(self) -> int:
        """Actual storage bytes: codes are int8 storage in every layout
        (kgroups_p4 already packs two int4 codes per stored byte)."""
        return int(self.q.numel()) + int(self.scales.numel()) * 4


def dequantize_param(qp: QuantizedParam) -> torch.Tensor:
    if not qp.layout.startswith("kgroups"):
        raise NotImplementedError(f"layout {qp.layout!r}: only the kgroups layouts are ported")
    wf = _dequantize_kgroups(qp.q, qp.scales, packed=qp.layout.startswith("kgroups_p4"))
    return wf.reshape(qp.shape).to(qp.dtype)


def _matmul_2d_form(path_key: str, shape: Tuple[int, ...]) -> Optional[Tuple[int, int]]:
    """(K, N) 2D matmul form of a model ``kernel`` leaf, or None to skip.

    Kernels are stored (in_dims..., out_dims...): q/k/v are (d, H, Dh) and
    contract the leading d; o_proj is (H, Dh, d) and contracts the leading
    (H, Dh); 2D kernels contract dim 0.
    """
    if len(shape) == 2:
        return shape[0], shape[1]
    if len(shape) == 3:
        # explicit allowlist: an unknown 3D kernel gets NO quantisation
        # rather than a guessed (and possibly transposed) K/N split
        if path_key == "o_proj":
            return shape[0] * shape[1], shape[2]
        if path_key in ("q_proj", "k_proj", "v_proj"):
            return shape[0], shape[1] * shape[2]
    return None


def quantize_for_serving(params: Dict[str, Any], num_bits: int = 8, group_size: int = 128,
                         min_size: int = 4096) -> Dict[str, Any]:
    """Quantise matmul ``kernel`` weights into the kgroups layout for the v2
    serving engine: attention projections, MLP linears and the untied
    lm_head. Embeddings (gather consumers, the tied head among them), norms,
    biases and MoE expert stacks stay dense. Returns a new tree; the codes
    and scales are made on each weight's own device."""
    n_q = 0

    def walk(node, keys):
        nonlocal n_q
        if isinstance(node, dict):
            return {k: walk(v, keys + (str(k),)) for k, v in node.items()}
        if len(keys) < 2 or keys[-1] != "kernel" or "moe" in keys or "experts" in keys:
            return node
        if not isinstance(node, torch.Tensor) or node.numel() < min_size:
            return node
        form = _matmul_2d_form(keys[-2], tuple(node.shape))
        if form is None:
            return node
        K, N = form
        q, scales = quantize_weight_kgroups(node.reshape(K, N), group_size=group_size, bits=num_bits,
                                            pack=num_bits == 4)
        pack = q.shape[0] != K  # the quantiser degrades to unpacked when the group size is odd
        n_q += 1
        return QuantizedParam(q=q, scales=scales, shape=tuple(node.shape), dtype=node.dtype, num_bits=num_bits,
                              layout="kgroups_p4" if pack else "kgroups")

    out = walk(params, ())
    logger.info("quantize_for_serving: %d matmul weights -> int%d (kgroups, group_size=%d)", n_q, num_bits,
                group_size)
    return out


def dequantize_tree(params):
    """Dense compute-dtype weights from a (partially) quantised tree."""
    if isinstance(params, dict):
        return {k: dequantize_tree(v) for k, v in params.items()}
    return dequantize_param(params) if isinstance(params, QuantizedParam) else params
