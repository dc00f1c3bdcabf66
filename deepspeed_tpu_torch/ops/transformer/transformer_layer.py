"""The training transformer layer: a BERT-style encoder layer.

Port of ``deepspeed_tpu/ops/transformer/transformer_layer.py`` (the
reference's ``DeepSpeedTransformerLayer`` / ``DeepSpeedTransformerConfig``):
bidirectional self-attention and a GELU MLP with pre- or post-LayerNorm,
attention and hidden dropout, and the memory knobs folded into one
``remat``. ``DeepSpeedTransformerLayer`` is an ``nn.Module`` whose
parameters keep the flax tree's names and layouts (``q_proj.kernel`` (d, H,
D), ``o_proj.kernel`` (H, D, d), ...): ``from_flax`` / ``flax_params``
carry them across. Attention goes through ``ops/attention.attention``: the
flash kernels on the card without a mask, and the plain route with one (the
mask becomes segment ids, as in the JAX layer, which route to the plain
path there too). LayerNorm goes through the norm kernels (``ops/norms.py``).
Dropout draws its masks from an explicit ``torch.Generator`` (the numbers
differ from JAX's keys); ``remat`` recomputes the layer in the backward
through ``torch.utils.checkpoint``; the recompute draws the forward's
masks again and then gives the generator back the state it had. The layer
lives on the card unless the caller passes ``device="cpu"``.
"""

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import norms
from ..attention import attention


@dataclass(frozen=True)
class DeepSpeedTransformerConfig:
    """The reference config's fields that change the math or the memory
    (``transformer.py:24``); device and stream fields are dropped."""
    hidden_size: int = 768
    intermediate_size: int = 3072
    heads: int = 12
    attn_dropout_ratio: float = 0.0
    hidden_dropout_ratio: float = 0.0
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    pre_layer_norm: bool = True
    # the reference's normalize_invertible / gelu_checkpoint / attn_dropout_checkpoint: recompute the layer
    remat: bool = False
    dtype: Any = torch.float32


class _Dense(nn.Module):
    """flax ``DenseGeneral``'s parameters: ``kernel`` (in dims..., out dims...) and ``bias`` (out dims)."""

    def __init__(self, kernel_shape, bias_shape, std: float, generator: Optional[torch.Generator], device):
        super().__init__()
        k = torch.empty(kernel_shape, device=device)
        k.normal_(0.0, std, generator=generator)
        self.kernel = nn.Parameter(k)
        self.bias = nn.Parameter(torch.zeros(bias_shape, device=device))


class _LayerNorm(nn.Module):
    """flax ``LayerNorm``'s parameters: ``scale`` and ``bias``."""

    def __init__(self, d: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))


class DeepSpeedTransformerLayer(nn.Module):
    """``forward(x, attention_mask=None, deterministic=True, generator=None)``
    with x (B, S, d) and an optional boolean mask (B, S) of valid positions.
    Parameters: ``attn_ln``, ``q_proj``, ``k_proj``, ``v_proj``, ``o_proj``,
    ``mlp_ln``, ``up_proj``, ``down_proj`` (the flax tree under ``body``),
    fp32, drawn from ``generator`` (kernels normal(``initializer_range``),
    biases zero, LayerNorm scales one)."""

    NAMES = ("attn_ln", "q_proj", "k_proj", "v_proj", "o_proj", "mlp_ln", "up_proj", "down_proj")

    def __init__(self, config: DeepSpeedTransformerConfig, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.config = cfg = config
        d, H, f = cfg.hidden_size, cfg.heads, cfg.intermediate_size
        D = d // H
        dense = lambda ks, bs: _Dense(ks, bs, cfg.initializer_range, generator, device)
        self.attn_ln = _LayerNorm(d, device)
        self.q_proj = dense((d, H, D), (H, D))
        self.k_proj = dense((d, H, D), (H, D))
        self.v_proj = dense((d, H, D), (H, D))
        self.o_proj = dense((H, D, d), (d,))
        self.mlp_ln = _LayerNorm(d, device)
        self.up_proj = dense((d, f), (f,))
        self.down_proj = dense((f, d), (d,))

    @classmethod
    def from_flax(cls, config: DeepSpeedTransformerConfig, tree: Dict[str, Any], device="cuda"):
        """The layer with a flax tree's parameters (``{"params": {"body": ...}}``, ``{"body": ...}`` or the
        body itself; numpy or tensor leaves), copied."""
        tree = tree.get("params", tree)
        tree = tree.get("body", tree)
        layer = cls(config, device=device)
        with torch.no_grad():
            for name in cls.NAMES:
                for pname, p in getattr(layer, name).named_parameters():
                    leaf = tree[name][pname]
                    src = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf, np.float32))
                    if tuple(src.shape) != tuple(p.shape):
                        raise ValueError(f"{name}/{pname}: {tuple(src.shape)} != {tuple(p.shape)}")
                    p.copy_(src)
        return layer

    def flax_params(self) -> Dict[str, Any]:
        """The parameters as the flax tree ``{"params": {"body": {name: {leaf: tensor}}}}``."""
        return {"params": {"body": {name: dict(getattr(self, name).named_parameters()) for name in self.NAMES}}}

    def _dropout(self, x: torch.Tensor, rate: float, deterministic: bool, generator) -> torch.Tensor:
        if rate <= 0 or deterministic:
            return x
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))

    def _ln(self, p: _LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return norms.layer_norm(x.contiguous(), p.scale, p.bias, self.config.layer_norm_eps).to(self.config.dtype)

    def _body(self, x, segment_ids, deterministic, generator, replay):
        with replay() if replay is not None else contextlib.nullcontext():
            return self._layer(x, segment_ids, deterministic, generator)

    def _layer(self, x, segment_ids, deterministic, generator):
        cfg = self.config
        dt = cfg.dtype
        dense = lambda p, h, spec: torch.einsum(spec, h.to(dt), p.kernel.to(dt)) + p.bias.to(dt)
        x = x.to(dt)
        h = self._ln(self.attn_ln, x) if cfg.pre_layer_norm else x
        q = dense(self.q_proj, h, "bsd,dhk->bshk")
        k = dense(self.k_proj, h, "bsd,dhk->bshk")
        v = dense(self.v_proj, h, "bsd,dhk->bshk")
        a = attention(q, k, v, causal=False, segment_ids=segment_ids)
        a = self._dropout(a, cfg.attn_dropout_ratio, deterministic, generator)
        a = dense(self.o_proj, a, "bshk,hkd->bsd")
        a = self._dropout(a, cfg.hidden_dropout_ratio, deterministic, generator)
        x = x + a
        if not cfg.pre_layer_norm:
            x = self._ln(self.attn_ln, x)
        h = self._ln(self.mlp_ln, x) if cfg.pre_layer_norm else x
        m = F.gelu(dense(self.up_proj, h, "bsd,df->bsf"), approximate="tanh")  # flax nn.gelu's default
        m = dense(self.down_proj, m, "bsf,fd->bsd")
        m = self._dropout(m, cfg.hidden_dropout_ratio, deterministic, generator)
        x = x + m
        if not cfg.pre_layer_norm:
            x = self._ln(self.mlp_ln, x)
        return x

    def forward(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        segment_ids = None
        if attention_mask is not None:
            # valid tokens are segment 1; each pad gets a segment of its own (-(position + 2)), so that it
            # attends to nothing real, as in the JAX layer
            mask = torch.as_tensor(attention_mask, device=x.device).bool()
            pad_seg = -(torch.arange(mask.shape[1], device=x.device)[None, :] + 2)
            segment_ids = torch.where(mask, torch.ones_like(pad_seg), pad_seg)
        cfg = self.config
        dropping = not deterministic and max(cfg.attn_dropout_ratio, cfg.hidden_dropout_ratio) > 0
        if cfg.remat:
            replay = _Replay(generator) if dropping and generator is not None else None
            return checkpoint(self._body, x, segment_ids, deterministic, generator, replay, use_reentrant=False)
        return self._layer(x, segment_ids, deterministic, generator)


class _Replay:
    """A remat layer's dropout generator: its state at the forward's start. The forward draws as usual; the
    recompute in the backward draws from that state again, so its masks are the forward's, and then gives the
    generator back the state it had (the layers after this one, and the caller's draws, see no rewind)."""

    def __init__(self, generator: torch.Generator):
        self.generator, self.start, self.ran = generator, generator.get_state(), False

    @contextlib.contextmanager
    def __call__(self):
        if not self.ran:
            self.ran = True
            yield
            return
        later = self.generator.get_state()
        self.generator.set_state(self.start)
        try:
            yield
        finally:
            self.generator.set_state(later)
