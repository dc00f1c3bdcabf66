"""Pipeline model description.

Port of ``deepspeed_tpu/runtime/pipe/module.py`` (reference
``runtime/pipe/module.py``): ``LayerSpec`` / ``TiedLayerSpec`` describe
layers lazily; ``PipelineModule`` partitions them into stages by the
configured method (``uniform``, ``parameters``, ``type:regex``) and builds
only the layers of the stage a rank runs (``build_stage``). A layer is a
``torch.nn.Module`` (run through ``torch.func.functional_call`` over the
stage's parameter tree, so the engine's fp32 masters drive it) or a plain
callable ``x -> x`` without parameters; a ``TiedLayerSpec`` may give a
``forward_fn(module, params, x)`` that runs the shared parameters another
way (an unembedding with the embedding's matrix).

``PipelineStage`` is what the pipeline engine runs on a rank, from
``PipelineModule.to_pipeline`` or ``models.CausalLM.to_pipeline``: the
stage's parameter tree, its embedding (first stage), its body, its loss
(last stage) and the tied parameters it shares with other stages.
"""

import logging
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

logger = logging.getLogger(__name__)


@dataclass
class PipelineStage:
    """One stage of a pipelined model, as the engine runs it.

    ``embed_fn(params, input_ids) -> x`` runs on the first stage only (None
    elsewhere, and for a ``PipelineModule``, whose first layers take the
    ids); ``stage_fn(params, x) -> (y, aux)`` is the stage's body (``aux`` a
    pre-scaled scalar loss of MoE blocks, or None); ``head_loss_fn(params, y,
    labels) -> loss`` the last stage's loss (None elsewhere). ``tied`` maps
    each tied key to (the stages that hold it, the path of its parameters
    in their trees: a leaf or a subtree), on every stage (each rank makes
    every tied group); a key on one stage only is not listed.
    ``token_weighted``: the loss is a mean over valid labels (a CausalLM's),
    so data-parallel ranks weigh it by their tokens; otherwise by rows.
    ``needs_labels``: batches must carry ``labels`` (no implicit shift)."""
    stage_id: int
    num_stages: int
    params: Dict[str, Any]
    stage_fn: Callable
    embed_fn: Optional[Callable] = None
    head_loss_fn: Optional[Callable] = None
    rules: List = field(default_factory=list)
    tied: Dict[str, Tuple[Tuple[int, ...], str]] = field(default_factory=dict)
    token_weighted: bool = False
    needs_labels: bool = False


class LayerSpec:
    """Lazily-built layer (reference ``module.py:30``)."""

    def __init__(self, typename, *module_args, **module_kwargs):
        self.typename = typename
        self.module_args = module_args
        self.module_kwargs = module_kwargs

    def build(self):
        return self.typename(*self.module_args, **self.module_kwargs)

    def param_count_estimate(self) -> int:
        obj = self.typename
        est = getattr(obj, "param_count_estimate", None)
        if callable(est):
            try:
                return int(est(*self.module_args, **self.module_kwargs))
            except TypeError:
                pass
        return 1

    def __repr__(self):
        return f"LayerSpec({getattr(self.typename, '__name__', self.typename)})"


class TiedLayerSpec(LayerSpec):
    """A layer whose parameters are shared with other layers of the same
    ``key`` (reference ``module.py:77``, e.g. tied embeddings/unembeddings)."""

    def __init__(self, key: str, typename, *module_args, forward_fn=None, tied_weight_attr="weight", **module_kwargs):
        super().__init__(typename, *module_args, **module_kwargs)
        self.key = key
        self.forward_fn = forward_fn
        self.tied_weight_attr = tied_weight_attr


def partition_uniform(num_items: int, num_parts: int) -> List[int]:
    """Boundaries [p0, p1, ..., pP] of a near-uniform split."""
    parts = [0] * (num_parts + 1)
    chunk = num_items // num_parts
    rem = num_items % num_parts
    for p in range(num_parts):
        parts[p + 1] = parts[p] + chunk + (1 if p < rem else 0)
    return parts


def partition_balanced(weights: Sequence[float], num_parts: int) -> List[int]:
    """Boundaries minimizing the max part weight (binary search over the
    bottleneck + greedy packing) — the reference's ``ds_utils.partition_balanced``."""
    weights = list(weights)
    n = len(weights)
    if num_parts >= n:
        return partition_uniform(n, num_parts)
    lo, hi = max(weights), sum(weights)

    def feasible(cap: float) -> Optional[List[int]]:
        bounds = [0]
        acc = 0.0
        for i, w in enumerate(weights):
            if acc + w > cap:
                bounds.append(i)
                acc = w
                if len(bounds) > num_parts:
                    return None
            else:
                acc += w
        bounds.append(n)
        while len(bounds) < num_parts + 1:
            bounds.insert(-1, bounds[-1])
        return bounds

    best = None
    for _ in range(64):
        mid = (lo + hi) / 2
        b = feasible(mid)
        if b is not None:
            best, hi = b, mid
        else:
            lo = mid
    return best if best is not None else partition_uniform(n, num_parts)


class PipelineModule:
    """Reference ``module.py:86``. Holds layer specs + the stage partition.

    ``loss_fn(outputs, labels)`` runs on the last stage's output; batches
    must carry ``labels``. Layers are built from their specs only on the
    stage that runs them, each under the seed ``base_seed`` plus its index
    (a tied key's first index for every occurrence), so that every rank
    builds the same parameters and a tied layer starts equal on its stages.
    """

    def __init__(self,
                 layers: Sequence,
                 num_stages: Optional[int] = None,
                 loss_fn: Optional[Callable] = None,
                 topology=None,
                 partition_method: str = "parameters",
                 activation_checkpoint_interval: int = 0,
                 seed_layers: bool = False,
                 base_seed: int = 1234):
        self.layer_specs = list(layers)
        self.num_stages = num_stages
        self.loss_fn = loss_fn
        self.topology = topology
        self.partition_method = partition_method
        self.activation_checkpoint_interval = activation_checkpoint_interval
        self.seed_layers = seed_layers
        self.base_seed = base_seed
        self.parts: Optional[List[int]] = None
        if num_stages is not None:
            self.parts = self._partition_layers(num_stages)

    def _layer_weights(self) -> List[float]:
        method = self.partition_method.lower()
        if method == "uniform":
            return [1.0] * len(self.layer_specs)
        if method == "parameters":
            return [float(spec.param_count_estimate() if isinstance(spec, LayerSpec) else 1) for spec in
                    self.layer_specs]
        if method.startswith("type:"):
            pat = method.split(":", 1)[1]
            regex = re.compile(pat, re.IGNORECASE)
            return [1.0 if regex.search(getattr(getattr(spec, "typename", spec), "__name__", str(spec))) else 0.0
                    for spec in self.layer_specs]
        raise ValueError(f"Unknown partition_method {self.partition_method}")

    def _partition_layers(self, num_stages: int) -> List[int]:
        weights = self._layer_weights()
        if self.partition_method.lower() == "uniform":
            parts = partition_uniform(len(self.layer_specs), num_stages)
        else:
            parts = partition_balanced(weights, num_stages)
        logger.info(f"PipelineModule: partition {parts} over {num_stages} stages (method={self.partition_method})")
        return parts

    def stage_layer_range(self, stage_id: int) -> range:
        assert self.parts is not None, "call with num_stages set"
        return range(self.parts[stage_id], self.parts[stage_id + 1])

    def _seed_index(self, i: int) -> int:
        spec = self.layer_specs[i]
        return self.tied_keys()[spec.key][0] if isinstance(spec, TiedLayerSpec) else i

    def _build(self, i: int):
        spec = self.layer_specs[i]
        if not isinstance(spec, LayerSpec):
            return spec
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.base_seed + self._seed_index(i))
            return spec.build()

    def build_stage(self, stage_id: int) -> List:
        """The layers of ``stage_id`` only, built from their specs."""
        return [self._build(i) for i in self.stage_layer_range(stage_id)]

    def tied_keys(self) -> Dict[str, List[int]]:
        keys: Dict[str, List[int]] = {}
        for i, spec in enumerate(self.layer_specs):
            if isinstance(spec, TiedLayerSpec):
                keys.setdefault(spec.key, []).append(i)
        return keys

    def tied_stages(self) -> Dict[str, Tuple[int, ...]]:
        """Each tied key's stages (under the current partition)."""
        assert self.parts is not None, "call with num_stages set"
        stage_of = {i: s for s in range(len(self.parts) - 1) for i in self.stage_layer_range(s)}
        return {k: tuple(sorted({stage_of[i] for i in idx})) for k, idx in self.tied_keys().items()}

    def num_layers(self) -> int:
        return len(self.layer_specs)

    def to_pipeline(self, num_stages: Optional[int] = None, params=None, stage_id: int = 0) -> PipelineStage:
        """This rank's stage (reference builds per-stage ``nn.Sequential``s,
        ``module.py:370``): its layers, and its parameter tree
        ``{"layer_<i>": {name: tensor}, "tied_<key>": {name: tensor}}`` (global
        layer indices; a tied key's parameters once a stage). ``params``, a
        tree of that form over any layers, supplies the stage's entries
        (missing ones raise); without it each layer keeps its own."""
        S = num_stages or self.num_stages
        if not S:
            raise ValueError("num_stages required (constructor or to_pipeline arg)")
        if self.loss_fn is None:
            raise ValueError("PipelineModule needs loss_fn=(outputs, labels) -> scalar for training")
        if self.parts is None or len(self.parts) != S + 1:
            self.num_stages = S
            self.parts = self._partition_layers(S)
        idx = list(self.stage_layer_range(stage_id))
        layers = dict(zip(idx, self.build_stage(stage_id)))
        tree: Dict[str, Dict[str, torch.Tensor]] = {}
        for i, layer in layers.items():
            spec = self.layer_specs[i]
            key = f"tied_{spec.key}" if isinstance(spec, TiedLayerSpec) else f"layer_{i}"
            if key in tree or not isinstance(layer, torch.nn.Module):
                continue
            own = {n: p.detach().clone() for n, p in layer.named_parameters()}
            if params is not None:
                if key not in params:
                    raise ValueError(f"params has no {key!r} for stage {stage_id}'s layer {i}")
                own = {n: torch.as_tensor(v) for n, v in params[key].items()}
            if own:
                tree[key] = own
        specs = self.layer_specs
        loss_fn = self.loss_fn

        def stage_fn(ps, x):
            for i, layer in layers.items():
                spec = specs[i]
                if isinstance(spec, TiedLayerSpec):
                    p = ps.get(f"tied_{spec.key}", {})
                    x = spec.forward_fn(layer, p, x) if spec.forward_fn is not None else \
                        torch.func.functional_call(layer, p, (x,))
                elif f"layer_{i}" in ps:
                    x = torch.func.functional_call(layer, ps[f"layer_{i}"], (x,))
                else:
                    x = layer(x)
            return x, None

        def head_loss_fn(ps, x, labels):
            return loss_fn(x, labels)

        tied = {k: (stages, f"tied_{k}") for k, stages in self.tied_stages().items() if len(stages) > 1}
        return PipelineStage(stage_id=stage_id, num_stages=S, params=tree, stage_fn=stage_fn,
                             head_loss_fn=head_loss_fn if stage_id == S - 1 else None, tied=tied, needs_labels=True)
