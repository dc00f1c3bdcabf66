"""Carry a reference parameter tree (numpy leaves) into the port.

The reference's flax tree converts leaf by leaf: the port keeps the same
keys and the same layouts (``q_proj/kernel`` stays (d, H, Dh) and is
contracted as ``bsd,dhk->bshk``), so conversion is a copy. A caller
produces the numpy tree from JAX with ``jax.tree.map(np.asarray, params)``;
this module never imports JAX.
"""

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..inference.quantization import QuantizedParam
from .transformer import TransformerConfig, param_shapes


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def params_from_numpy(tree: Mapping, device="cuda", dtype: Optional[torch.dtype] = None, *,
                      cfg: TransformerConfig) -> Dict[str, Any]:
    """Nested dict of tensors with exactly ``tree``'s keys, on ``device``.
    Floating leaves are cast to ``dtype`` when given. The key set and every
    shape are checked against ``cfg``'s model first: a missing or extra key,
    or a wrong shape, raises ``ValueError``."""
    flat = _flatten(tree)
    want = {p: spec[0] for p, spec in _flatten(param_shapes(cfg)).items()}
    missing: List[str] = sorted(set(want) - set(flat))
    extra: List[str] = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"parameter tree does not match the model: missing {missing}, extra {extra}")
    bad = [f"{p}: {tuple(np.shape(flat[p]))} != {want[p]}" for p in want
           if tuple(np.shape(flat[p])) != tuple(want[p])]
    if bad:
        raise ValueError(f"parameter shapes do not match the model: {bad}")
    device = torch.device(device)
    out = {}
    for path, leaf in flat.items():
        t = torch.from_numpy(np.array(leaf, copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[path] = t.to(device)
    return _unflatten(out)


def quantized_from_numpy(q, scales, shape, dtype: torch.dtype, num_bits: int, layout: str,
                         device="cuda") -> QuantizedParam:
    """Carry a reference ``QuantizedParam`` across as it is: its int8 codes
    and fp32 scales (numpy), original shape, the port's dtype for the
    original dtype, bits and layout ("flat", "kgroups" or "kgroups_p4")."""
    if not (layout == "flat" or layout.startswith("kgroups")) or "+" in layout:
        raise NotImplementedError(f"layout {layout!r}: only the unsharded flat and kgroups layouts are ported")
    device = torch.device(device)
    return QuantizedParam(q=torch.from_numpy(np.array(q, dtype=np.int8, copy=True)).to(device),
                          scales=torch.from_numpy(np.array(scales, dtype=np.float32, copy=True)).to(device),
                          shape=tuple(int(n) for n in shape), dtype=dtype, num_bits=int(num_bits), layout=layout)
