"""Post-load weight-only quantisation.

Port of ``deepspeed_tpu/inference/quantization/quantization.py``. int8 or
int4 codes plus group scales live in the parameter tree as
``QuantizedParam`` leaves, in one of two layouts:

- "flat" (the default, as in the reference): groups of ``group_size``
  consecutive elements of the flattened weight, quantised by
  ``quantize_param`` / ``quantize_model_params`` for the v1 engine and
  dequantised whole by ``dequantize_param``, through the hand-written
  ``quantize_groupwise`` / ``dequantize_groupwise`` kernels
  (``ops/quantization.py``) on CUDA and their plain versions on the CPU;
- "kgroups" / "kgroups_p4": the matmul-native layout of
  ``quantize_for_serving``, which the fused dequantise-matmul kernel
  (``ops/quantized_matmul.py``) of the v2 engine consumes without ever
  materialising the dense weight. Under tensor-parallel serving each rank
  quantises its own shard (the reference's order: quantise after sharding),
  with K-groups aligned to the shard edge, and marks the layout ``+gspmd``
  (the JAX package's name for a sharded leaf's layout).

Config groups (``weight_quantization.post_init_quant``) are keyed by
substrings of the "/"-joined leaf path, as in the reference.
"""

import logging
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ...ops import quantization as groupwise
from ...ops._utils import block_that_divides
from ...ops.quantized_matmul import _dequantize_kgroups, quantize_weight_kgroups

logger = logging.getLogger(__name__)


@dataclass
class QuantizedParam:
    """int8-coded parameter + group scales, a leaf of the parameter tree.

    ``layout``: "flat" = groups along the flattened weight, ``q (rows, g)`` +
    ``scales (rows,)``, dequantised whole; "kgroups" = matmul-native
    ``q (K, N)`` + ``scales (K/g, N)``; "kgroups_p4" = the same with two
    int4 codes per stored byte, ``q (K/2, N)``."""
    q: torch.Tensor          # int8 codes
    scales: torch.Tensor     # fp32 group scales
    shape: Tuple[int, ...]   # original shape
    dtype: Any               # original dtype
    num_bits: int = 8
    layout: str = "flat"

    @property
    def nbytes_quantized(self) -> int:
        """Actual storage bytes: codes are int8 storage in every layout
        (kgroups_p4 already packs two int4 codes per stored byte)."""
        return int(self.q.numel()) + int(self.scales.numel()) * 4


def _path_str(keys) -> str:
    """The "/"-joined leaf path (the port's copy of ``utils/pytree.py``'s ``path_str``)."""
    return "/".join(str(k) for k in keys)


def quantize_param(w: torch.Tensor, num_bits: int = 8, group_size: int = 64) -> QuantizedParam:
    """Group-wise symmetric quantisation of ``w`` in the flat layout, from its
    fp32 values as in the reference (the kernel converts bf16 in registers)."""
    q, scales = groupwise.quantize_groupwise(w if w.dtype == torch.bfloat16 else w.float(), group_size=group_size,
                                   bits=num_bits)
    return QuantizedParam(q=q, scales=scales, shape=tuple(w.shape), dtype=w.dtype, num_bits=num_bits)


def dequantize_param(qp: QuantizedParam) -> torch.Tensor:
    if qp.layout.startswith("kgroups"):
        wf = _dequantize_kgroups(qp.q, qp.scales, packed=qp.layout.startswith("kgroups_p4"))
        return wf.reshape(qp.shape).to(qp.dtype)
    if qp.layout != "flat":
        raise NotImplementedError(f"layout {qp.layout!r} is not ported")
    return groupwise.dequantize_groupwise(qp.q, qp.scales, out_shape=qp.shape, out_dtype=qp.dtype)


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


def _shard_info(path_key: str, spec: tuple, ndim: int, tp: int) -> Tuple[int, bool]:
    """(K-shard count, leaf-is-sharded) of a leaf from its TP spec (JAX
    ``_shard_info``, which reads the committed sharding): the shards along
    the contraction dims of the 2D matmul form (o_proj contracts its
    leading two dims, every other kernel its first)."""
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    kdims = (0, 1) if (ndim == 3 and path_key == "o_proj") else (0,)
    kshards = tp ** sum(spec[d] == "tensor" for d in kdims)
    return kshards, any(a == "tensor" for a in spec)


def quantize_for_serving(params: Dict[str, Any], num_bits: int = 8, group_size: int = 128,
                         min_size: int = 4096, specs: Optional[Dict[str, Any]] = None,
                         tp: int = 1) -> Dict[str, Any]:
    """Quantise matmul ``kernel`` weights into the kgroups layout for the v2
    serving engine: attention projections, MLP linears and the untied
    lm_head. Embeddings (gather consumers, the tied head among them), norms,
    biases and MoE expert stacks stay dense. Returns a new tree; the codes
    and scales are made on each weight's own device.

    ``specs`` (``module_inject.tp_shardings``) and ``tp``: ``params`` is a
    rank's shard of a tensor-parallel tree, quantised after sharding. A
    K-sharded kernel takes the group size ``block_that_divides(K_local,
    group_size)``, so that its groups, scales and int4 nibble pairs are the
    JAX shard's, and every sharded kernel's layout is marked ``+gspmd``.
    ``min_size`` counts the whole kernel's elements, as the JAX package
    (which quantises the global array) does."""
    n_q = 0

    def walk(node, keys, spec_node=None):
        nonlocal n_q
        if isinstance(node, dict):
            return {k: walk(v, keys + (str(k),), None if spec_node is None else spec_node[k])
                    for k, v in node.items()}
        if len(keys) < 2 or keys[-1] != "kernel" or "moe" in keys or "experts" in keys:
            return node
        if not isinstance(node, torch.Tensor):
            return node
        kshards, sharded = _shard_info(keys[-2], spec_node or (), node.dim(), tp)
        whole = node.numel() * (tp if sharded else 1)
        if whole < min_size:
            return node
        form = _matmul_2d_form(keys[-2], tuple(node.shape))
        if form is None:
            return node
        K, N = form
        gs = group_size if kshards == 1 else block_that_divides(K, group_size)
        q, scales = quantize_weight_kgroups(node.reshape(K, N), group_size=gs, bits=num_bits, pack=num_bits == 4)
        pack = q.shape[0] != K  # the quantiser degrades to unpacked when the group size is odd
        n_q += 1
        layout = ("kgroups_p4" if pack else "kgroups") + ("+gspmd" if sharded else "")
        return QuantizedParam(q=q, scales=scales, shape=tuple(node.shape), dtype=node.dtype, num_bits=num_bits,
                              layout=layout)

    out = walk(params, (), specs)
    logger.info("quantize_for_serving: %d matmul weights -> int%d (kgroups, group_size=%d)", n_q, num_bits,
                group_size)
    return out


def quantize_model_params(params: Dict[str, Any], ds_config: Optional[Dict] = None,
                          min_size: int = 1024) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """Replace the weight leaves matched by the config groups (default: every
    >= 2-D leaf of >= ``min_size`` elements, int8, group 64) with flat-layout
    ``QuantizedParam`` leaves. A group applies where its pattern is ``"*"``
    or a substring of the leaf's "/"-joined path; the first match wins.
    Returns (quantised tree, stats) with the reference's stats keys."""
    groups = ((ds_config or {}).get("weight_quantization", {}).get("post_init_quant", {})) or \
        {"*": {"num_bits": 8, "group_size": 64}}

    def group_for(path: str):
        for pattern, g in groups.items():
            if pattern == "*" or pattern in path:
                return g
        return None

    stats = {"quantized": 0, "skipped": 0, "bytes_before": 0, "bytes_after": 0}

    def walk(node, keys):
        if isinstance(node, dict):
            return {k: walk(v, keys + (k,)) for k, v in node.items()}
        g = group_for(_path_str(keys))
        if g is None or getattr(node, "ndim", 0) < 2 or node.numel() < min_size:
            stats["skipped"] += 1
            return node
        qp = quantize_param(node, num_bits=int(g.get("num_bits", 8)), group_size=int(g.get("group_size", 64)))
        stats["quantized"] += 1
        stats["bytes_before"] += node.numel() * node.element_size()
        stats["bytes_after"] += qp.nbytes_quantized
        return qp

    out = walk(params, ())
    if stats["quantized"]:
        logger.info("weight-only quantization: %d tensors, %.1f MB -> %.1f MB", stats["quantized"],
                    stats["bytes_before"] / 1e6, stats["bytes_after"] / 1e6)
    return out, stats


def dequantize_tree(params):
    """Dense compute-dtype weights from a (partially) quantised tree."""
    if isinstance(params, dict):
        return {k: dequantize_tree(v) for k, v in params.items()}
    return dequantize_param(params) if isinstance(params, QuantizedParam) else params


class QuantizationContext:
    """The reference's ``QuantizationContext``: a scope whose ``quantize``
    applies ``quantize_model_params`` with the context's config."""

    def __init__(self, config_dict_or_path: Optional[Dict] = None, mpu=None):
        self.config = config_dict_or_path or {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def quantize(self, params):
        return quantize_model_params(params, self.config)[0]
