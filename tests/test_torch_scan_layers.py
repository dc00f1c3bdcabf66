"""Port parity: ``scan_layers`` (JAX ``Transformer._scan_blocks``).

With ``scan_layers`` the JAX model keeps its blocks as one flax scan: a
``layers/block`` tree whose leaves carry a leading (n_layers,) axis. Held:

- ``param_shapes`` equals the JAX tree's keys and shapes (gpt2-tiny,
  llama-tiny with GQA, and MoE at ``moe_layer_freq`` 1 and 2, where every
  scanned block is JAX's ``layer_idx`` 0), and ``params_from_numpy``
  carries the JAX tree;
- ``CausalLM.loss_fn`` and every leaf's gradient against JAX
  ``jax.value_and_grad`` on the same tree and batch, with and without remat:
  loss within 1e-5 relative, each gradient within 1e-5 of its leaf's largest
  (fp32, the same math in another summation order; ``k_proj``'s bias, whose
  true gradient is zero, of the model's largest);
- the scanned forward and gradients equal, bit for bit, the unrolled model's
  on the same weights (block i reads slice i: the same operations);
- the refusals are JAX's, in its words: per-layer ``window_layers``,
  progressive layer drop and the pipeline;
- the ZeRO planner's plans and the estimator's counts over the stacked tree
  equal JAX's (``tests/unit/test_zero_partition.py``), and two engine steps
  on the stacked tree equal two on the unrolled tree.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
import deepspeed_tpu_torch
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import gpt2_tiny as jax_gpt2_tiny
from deepspeed_tpu.models import llama_tiny as jax_llama_tiny
from deepspeed_tpu.parallel.mesh import MeshTopology as JaxMesh
from deepspeed_tpu.runtime import zero as jax_zero
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.config import MeshConfig as JaxMeshConfig
from deepspeed_tpu.runtime.zero.estimator import params_of_tree as jax_params_of_tree
from deepspeed_tpu_torch import zero as port_zero
from deepspeed_tpu_torch.models import CausalLM, gpt2_tiny, llama_tiny, params_from_numpy
from deepspeed_tpu_torch.models.transformer import param_shapes
from deepspeed_tpu_torch.parallel import MeshTopology
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, MeshConfig
from deepspeed_tpu_torch.runtime.zero.estimator import params_of_tree

V = 256
TOL = 1e-5
PRESETS = {"gpt2_tiny": (jax_gpt2_tiny, gpt2_tiny), "llama_tiny": (jax_llama_tiny, llama_tiny)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _cfgs(name, **kw):
    jax_preset, port_preset = PRESETS[name]
    return (dataclasses.replace(jax_preset(), vocab_size=V, scan_layers=True, **kw),
            dataclasses.replace(port_preset(), vocab_size=V, scan_layers=True, **kw))


def _jax_params(jcfg):
    model = JaxCausalLM(jcfg)
    return model, jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)}))


def _ids(seed=0):
    return np.random.default_rng(seed).integers(0, V, (2, 16)).astype(np.int32)


def _unstack(cfg, params):
    """The unrolled model's tree (``layer_{i}``) from a stacked one: the same tensors, sliced."""
    block = params["layers"]["block"]
    take = lambda t, i: {k: take(v, i) for k, v in t.items()} if isinstance(t, dict) else t[i].clone()
    out = {k: v for k, v in params.items() if k != "layers"}
    out.update({f"layer_{i}": take(block, i) for i in range(cfg.n_layers)})
    return out


@pytest.mark.parametrize("name,kw", [("gpt2_tiny", {}), ("llama_tiny", {}),
                                     ("llama_tiny", dict(moe_num_experts=4, moe_top_k=2, moe_layer_freq=1)),
                                     ("llama_tiny", dict(moe_num_experts=4, moe_top_k=2, moe_layer_freq=2))])
def test_param_shapes_equal_the_jax_scanned_tree(name, kw):
    jcfg, cfg = _cfgs(name, **kw)
    shapes = jax.eval_shape(lambda: JaxCausalLM(jcfg).init(jax.random.PRNGKey(0),
                                                           {"input_ids": np.zeros((1, 8), np.int32)}))
    want = {p: tuple(s.shape) for p, s in _flat(jax.tree.map(lambda s: s, shapes)).items()}
    got = {p: tuple(spec[0]) for p, spec in _flat(param_shapes(cfg)).items()}
    assert got == want
    assert all(p.startswith("layers/block/") for p in got if "layer" in p.split("/")[0])


@pytest.mark.parametrize("name,remat", [("gpt2_tiny", False), ("llama_tiny", False), ("llama_tiny", True)])
def test_scanned_loss_and_gradients_match_jax(name, remat):
    jcfg, cfg = _cfgs(name, remat=remat)
    jm, jp = _jax_params(jcfg)
    ids = _ids()
    want_loss, want_grads = jax.jit(jax.value_and_grad(lambda p: jm.loss_fn(p, {"input_ids": ids})))(jp)
    params = params_from_numpy(jp, "cpu", cfg=cfg)
    leaves = _flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = CausalLM(cfg).loss_fn(params, {"input_ids": torch.from_numpy(ids.astype(np.int64))})
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= TOL * abs(float(want_loss))
    want = _flat(jax.tree.map(np.asarray, want_grads))
    assert set(want) == set(leaves)
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        # k_proj's bias has a zero true gradient (softmax ignores a per-row constant): fp32 noise on both sides
        scale = top if path.endswith("k_proj/bias") else max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(leaves[path].grad.numpy() - w).max()) <= TOL * scale, path


def test_scanned_model_equals_the_unrolled_model_bit_for_bit():
    _, cfg = _cfgs("llama_tiny")
    unrolled_cfg = dataclasses.replace(cfg, scan_layers=False)
    stacked = deepspeed_tpu_torch.models.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    unrolled = _unstack(cfg, stacked)
    ids = torch.from_numpy(_ids(1).astype(np.int64))
    assert torch.equal(CausalLM(cfg).apply(stacked, ids), CausalLM(unrolled_cfg).apply(unrolled, ids))
    grads = []
    for c, tree in ((cfg, stacked), (unrolled_cfg, unrolled)):
        for t in _flat(tree).values():
            t.requires_grad_(True)
        CausalLM(c).loss_fn(tree, {"input_ids": ids}).backward()
        grads.append({p: t.grad for p, t in _flat(tree).items()})
    restacked = _unstack(cfg, {"layers": {"block": _unflat_block(grads[0])}})
    for path, g in _flat(restacked).items():
        assert torch.equal(g, grads[1][path]), path
    for path in grads[1]:
        if not path.startswith("layer_"):
            assert torch.equal(grads[0][path], grads[1][path]), path


def _unflat_block(flat):
    out = {}
    for path, v in flat.items():
        if not path.startswith("layers/block/"):
            continue
        node = out
        *parents, leaf = path[len("layers/block/"):].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_refusals_are_jax_s():
    jcfg, cfg = _cfgs("llama_tiny", sliding_window=4, window_layers=(1,))
    want = _jax_error(lambda: _jax_params(jcfg))
    with pytest.raises(ValueError) as e:
        param_shapes(cfg)
    assert str(e.value) == want
    jcfg, cfg = _cfgs("llama_tiny")
    jm, jp = _jax_params(jcfg)
    ids = _ids()
    want = _jax_error(lambda: jm.apply(jp, ids, pld_theta=0.5))
    params = params_from_numpy(jp, "cpu", cfg=cfg)
    with pytest.raises(ValueError) as e:
        CausalLM(cfg).apply(params, torch.from_numpy(ids.astype(np.int64)), pld_theta=0.5)
    assert str(e.value) == want
    want = _jax_error(lambda: jm.to_pipeline(2, params=jp))
    with pytest.raises(ValueError) as e:
        CausalLM(cfg).to_pipeline(2, params=params)
    assert str(e.value) == want


def _dims(spec_tree, axis):
    flat = jax.tree_util.tree_leaves_with_path(spec_tree, is_leaf=lambda x: isinstance(x, P))
    out = {}
    for path, spec in flat:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        dims = [i for i, e in enumerate(spec) if e == axis or (isinstance(e, tuple) and axis in e)]
        out[name] = dims[0] if dims else None
    return out


@pytest.mark.parametrize("mesh,stage", [({"data": 2}, 3), ({"data": 1, "fsdp": 2}, 2)])
def test_zero_plans_and_estimates_over_the_stacked_tree_equal_jax(mesh, stage):
    jcfg, cfg = _cfgs("llama_tiny")
    _, jp = _jax_params(jcfg)
    shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jp)
    d = {"train_micro_batch_size_per_gpu": 1, "zero_optimization": {"stage": stage}}
    n = int(np.prod(list(mesh.values())))
    jtopo = JaxMesh(JaxMeshConfig.from_dict(mesh), devices=jax.devices()[:n])
    axis = jax_zero.zero_axes_for(jtopo)[0]
    jcfg_ds = JaxConfig(d)
    jps = jax_zero.plan_param_specs(shapes, jcfg_ds, jtopo)
    jg = jax_zero.plan_grad_specs(shapes, jps, jcfg_ds, jtopo)
    jo, _ = jax_zero.plan_opt_state_specs(optax.adam(1e-3), shapes, jps, jcfg_ds, jtopo)
    plan = port_zero.plan_zero(jax.tree.map(lambda a: tuple(a.shape), jp), DeepSpeedConfig(d),
                               MeshTopology(MeshConfig.from_dict(mesh), world_size=n, rank=0))
    got = {lf.path: (lf.param_dim, lf.grad_dim, lf.opt_dim) for lf in plan.leaves}
    mu = _dims(jo[0].mu, axis)
    assert got == {p: (v, _dims(jg, axis)[p], mu[p]) for p, v in _dims(jps, axis).items()}
    assert params_of_tree(params_from_numpy(jp, "cpu", cfg=cfg)) == jax_params_of_tree(jp)


def test_two_engine_steps_on_the_stacked_tree_equal_the_unrolled_tree():
    _, cfg = _cfgs("gpt2_tiny")
    stacked = deepspeed_tpu_torch.models.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    trees = {True: stacked, False: _unstack(cfg, stacked)}
    config = {"train_micro_batch_size_per_gpu": 2, "steps_per_print": 1000,
              "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-3}}, "gradient_clipping": 1.0}
    batches = [{"input_ids": _ids(2 + i)} for i in range(2)]
    losses = {}
    for scan, tree in trees.items():
        engine, _, _, _ = deepspeed_tpu_torch.initialize(model=CausalLM(dataclasses.replace(cfg, scan_layers=scan)),
                                                         model_parameters=tree, config=config, device="cpu")
        it = iter(batches)
        losses[scan] = [float(engine.train_batch(it)) for _ in batches]
    assert losses[True] == losses[False]
