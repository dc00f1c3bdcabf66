"""Port parity: the ZeRO partition planner and the memory estimators.

Mirrors ``tests/unit/test_zero_partition.py``: the port's plans
(``runtime/zero/partition.py``: which dimension of each leaf a rank holds a
chunk of, for the masters, the gradient buffer and the optimizer state)
equal the JAX planner's PartitionSpecs leaf for leaf, for stages 0-3 on
``data`` 2 and 4, ``fsdp`` 2 and ``data`` 2 x ``fsdp`` 2, with the stage-3
persistence threshold at 0 and at 10,000, over gpt2-tiny's and
llama-tiny's parameter shapes and a tree of indivisible shapes. The
estimators' numbers and tables equal JAX's.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import gpt2_tiny as jax_gpt2_tiny
from deepspeed_tpu.models import llama_tiny as jax_llama_tiny
from deepspeed_tpu.parallel.mesh import MeshTopology as JaxMesh
from deepspeed_tpu.runtime import zero as jax_zero
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.config import MeshConfig as JaxMeshConfig
from deepspeed_tpu_torch import zero as port_zero
from deepspeed_tpu_torch.checkpoint.utils import flatten_tree
from deepspeed_tpu_torch.parallel import MeshTopology
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, MeshConfig

MESHES = [{"data": 2}, {"data": 4}, {"data": 1, "fsdp": 2}, {"data": 2, "fsdp": 2}]


def _shapes(name):
    if name == "indivisible":
        return {"a": jax.ShapeDtypeStruct((3, 5), np.float32), "b": jax.ShapeDtypeStruct((6, 4), np.float32),
                "c": jax.ShapeDtypeStruct((7,), np.float32), "d": jax.ShapeDtypeStruct((), np.float32),
                "e": {"k": jax.ShapeDtypeStruct((2, 12, 9), np.float32), "s": jax.ShapeDtypeStruct((1,), np.float32)}}
    cfg = {"gpt2_tiny": jax_gpt2_tiny, "llama_tiny": jax_llama_tiny}[name]()
    model = JaxCausalLM(cfg)
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)}))


def _dims(spec_tree, axis):
    """A JAX spec tree as {path: sharded dimension or None}."""
    flat = jax.tree_util.tree_leaves_with_path(spec_tree, is_leaf=lambda x: isinstance(x, P))
    out = {}
    for path, spec in flat:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        dims = [i for i, e in enumerate(spec) if e == axis or (isinstance(e, tuple) and axis in e)]
        out[name] = dims[0] if dims else None
    return out


CASES = [(m, s, t, name) for name in ("gpt2_tiny", "llama_tiny", "indivisible") for m in MESHES
         for s in (0, 1, 2, 3) for t in (0, 10_000)]


@pytest.mark.parametrize("mesh,stage,threshold,model", CASES,
                         ids=[f"{n}-{'x'.join(f'{k}{v}' for k, v in m.items())}-stage{s}-t{t}" for m, s, t, n in CASES])
def test_plans_equal_the_jax_planner(mesh, stage, threshold, model):
    shapes = _shapes(model)
    n = int(np.prod(list(mesh.values())))
    d = {"train_micro_batch_size_per_gpu": 1,
         "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": threshold}}
    jcfg = JaxConfig(d)
    jtopo = JaxMesh(JaxMeshConfig.from_dict(mesh), devices=jax.devices()[:n])
    axis = jax_zero.zero_axes_for(jtopo)[0]
    jp = jax_zero.plan_param_specs(shapes, jcfg, jtopo)
    jg = jax_zero.plan_grad_specs(shapes, jp, jcfg, jtopo)
    jo, _ = jax_zero.plan_opt_state_specs(optax.adam(1e-3), shapes, jp, jcfg, jtopo)
    tree = jax.tree.map(lambda s: tuple(s.shape), shapes)
    cfg = DeepSpeedConfig(d)
    for rank in range(n):
        topo = MeshTopology(MeshConfig.from_dict(mesh), world_size=n, rank=rank)
        assert port_zero.zero_axes_for(topo) == jax_zero.zero_axes_for(jtopo)
        plan = port_zero.plan_zero(tree, cfg, topo)
        assert plan.axis == axis and plan.stage == stage
        got = {lf.path: (lf.param_dim, lf.grad_dim, lf.opt_dim) for lf in plan.leaves}
        mu = _dims(jo[0].mu, axis)
        want = {p: (v, _dims(jg, axis)[p], mu[p]) for p, v in _dims(jp, axis).items()}
        assert got == want
        # each rank's chunk shapes tile the leaf
        for lf in plan.leaves:
            shard = plan.shard_shape(lf, lf.opt_dim)
            assert int(np.prod(shard)) * (plan.size if lf.opt_dim is not None else 1) == lf.numel


def test_shard_leaf_dim_picks_the_largest_divisible_dimension():
    assert port_zero.shard_leaf_dim((6, 4), 4) == 1
    assert port_zero.shard_leaf_dim((8, 8), 2) == 0  # ties: the first
    assert port_zero.shard_leaf_dim((3, 5), 2) is None
    assert port_zero.shard_leaf_dim((4,), 8) is None  # smaller than the axis
    assert port_zero.shard_leaf_dim((1024, 64), 2, min_size=100_000) is None
    assert port_zero.shard_leaf_dim((), 2) is None
    for shape, size, t in [((6, 4), 4, 0), ((8, 8), 2, 0), ((1024, 64), 2, 100_000), ((2, 12, 9), 3, 0)]:
        spec = jax_zero.shard_leaf_spec(shape, None, ("data",), size, min_size=t)
        dims = [i for i, e in enumerate(spec) if e == "data"]
        assert port_zero.shard_leaf_dim(shape, size, t) == (dims[0] if dims else None)


@pytest.mark.parametrize("args", [(10**9, 1, 1, True), (10**9, 8, 2, False), (1_300_000_000, 8, 1, True, 1.0)])
def test_zero2_estimator_equals_jax(args):
    assert port_zero.estimate_zero2_model_states_mem_needs(*args) == \
        jax_zero.estimate_zero2_model_states_mem_needs(*args)


@pytest.mark.parametrize("kw", [dict(cpu_offload=o, cpu_offload_params=p, zero_init=z)
                                for o in (True, False) for p in (True, False) for z in (True, False)])
def test_zero3_estimator_equals_jax(kw):
    args = (1_300_000_000, 103_000_000, 8, 2)
    assert port_zero.estimate_zero3_model_states_mem_needs(*args, **kw) == \
        jax_zero.estimate_zero3_model_states_mem_needs(*args, **kw)


def test_estimator_tables_over_a_live_tree_equal_jax(capsys):
    from deepspeed_tpu_torch.models import gpt2_tiny, params_from_numpy

    cfg = dataclasses.replace(gpt2_tiny(), vocab_size=512)
    jparams = jax.tree.map(np.asarray, JaxCausalLM(dataclasses.replace(jax_gpt2_tiny(), vocab_size=512)).init(
        jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)}))
    tparams = params_from_numpy(jparams, "cpu", cfg=cfg)
    from deepspeed_tpu_torch.runtime.zero.estimator import params_of_tree
    from deepspeed_tpu.runtime.zero.estimator import params_of_tree as jax_params_of_tree

    assert params_of_tree(tparams) == jax_params_of_tree(jparams)
    assert sum(int(np.prod(s)) for _, s in flatten_tree(jax.tree.map(np.shape, jparams))) == params_of_tree(tparams)[0]
    tables = []
    for mod, tree in ((port_zero, tparams), (jax_zero, jparams)):
        mod.estimate_zero2_model_states_mem_needs_all_live(tree, num_chips_per_host=4, num_hosts=2)
        mod.estimate_zero3_model_states_mem_needs_all_live(tree, num_chips_per_host=4, num_hosts=2)
        mod.estimate_zero3_model_states_mem_needs_all_cold(10**9, 10**7)
        tables.append(capsys.readouterr().out)
    assert tables[0] == tables[1] and "offload_param" in tables[0]
