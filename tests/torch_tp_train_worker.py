"""Ranks of the port's tensor-parallel training engine, spawned over gloo
(``torch_zero_worker.spawn``) for ``tests/test_torch_tensor_parallel.py``.
Imports torch and the port only.

``train_cases`` trains each case's engine (the data-parallel engine, or the
pipeline engine under ``mesh.pipe``) from a whole numpy tree on this rank's
rows of the same global micro-batches, and writes its losses, grad norms,
whole masters, the leaves it holds whole (for the bit-equality of the
replicas across tensor ranks), its collectives and its step FLOPs.
``ckpt_cases`` saves and resumes native and universal checkpoints and
merges the rank files with ``zero_to_fp32``; ``refusals`` collects the
messages of what the engine refuses beside ``tensor``.
"""

import os

import numpy as np
import torch

from torch_zero_worker import rows


def _tree(npz: str) -> dict:
    tree = {}
    for path, v in np.load(npz).items():
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = v
    return tree


def engine_for(case: dict, params_npz: str):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig, params_from_numpy

    cfg = TransformerConfig(**case["model"])
    params = params_from_numpy(_tree(params_npz), "cpu", cfg=cfg)
    engine, _, _, _ = dst.initialize(model=CausalLM(cfg), model_parameters=params, config=case["config"],
                                     device="cpu")
    return engine


def batches(batches_npz: str, engine, start: int, n: int):
    """Micro-batches ``start`` .. ``start + n - 1`` of the file, this rank's rows of each."""
    b = np.load(batches_npz)
    keys = sorted({k.split("__")[0] for k in b.files})
    return iter([rows({k: b[f"{k}__{j}"] for k in keys}, engine.dp_rank, engine.dp_world_size)
                 for j in range(start, start + n)])


def _train(engine, it, steps):
    losses, norms = [], []
    for _ in range(steps):
        losses.append(float(engine.train_batch(it)))
        norms.append(engine.get_global_grad_norm())
    return losses, norms


def train_cases(rank, world, cases, params_files, batch_files, steps, out_dir):
    for i, (case, params_npz, batches_npz) in enumerate(zip(cases, params_files, batch_files)):
        engine = engine_for(case, params_npz)
        gas = case["config"].get("gradient_accumulation_steps", 1)
        losses, norms = _train(engine, batches(batches_npz, engine, 0, steps * gas), steps)
        full = {p: t.numpy() for p, t in zip(engine._paths, engine.full_masters())}
        whole = {lf.path: m.detach().numpy() for lf, m in zip(engine.plan.leaves, engine.parameters())
                 if lf.tensor_dim is None}
        topo = engine.topology
        torch.save(dict(losses=losses, norms=norms, masters=full, whole=whole, comm=engine.comm_stats,
                        tp=(topo.axis_size("tensor"), topo.axis_rank("tensor")), dp=engine.dp_rank,
                        zero=engine.plan.rank, stage=getattr(engine, "stage_id", 0), cls=type(engine).__name__,
                        partial=[lf.path for lf in engine.plan.leaves if lf.tp_partial],
                        tensor_dims={lf.path: lf.tensor_dim for lf in engine.plan.leaves},
                        step_flops=engine._step_flops, local=[tuple(m.shape) for m in engine.parameters()]),
                   os.path.join(out_dir, f"case{i}_rank{rank}.pt"))


def ckpt_cases(rank, world, cases, params_npz, batches_npz, pre, post, root, out_dir):
    """Per case: an uninterrupted run of ``pre + post`` steps; ``pre`` steps,
    a save (native or universal), a fresh engine at the case's ``dst`` config
    that loads it and takes ``post`` steps. A native case also merges the
    rank files with ``zero_to_fp32`` and compares them with the saved masters."""
    from deepspeed_tpu_torch import comm as dist
    from deepspeed_tpu_torch.checkpoint.zero_to_fp32 import get_fp32_flat_state_dict_from_zero_checkpoint

    for i, case in enumerate(cases):
        ckpt = os.path.join(root, f"case{i}")
        straight = engine_for(case, params_npz)
        want, _ = _train(straight, batches(batches_npz, straight, 0, pre + post), pre + post)
        want_masters = [t.clone() for t in straight.full_masters()]
        first = engine_for(case, params_npz)
        got, _ = _train(first, batches(batches_npz, first, 0, pre), pre)
        saved = {p: t.clone() for p, t in zip(first._paths, first.full_masters())}
        if case["universal"]:
            first.save_universal_checkpoint(ckpt, tag="t")
        else:
            first.save_checkpoint(ckpt, tag="t")
        dist.barrier()
        merged_equal = None
        if not case["universal"]:
            merged = get_fp32_flat_state_dict_from_zero_checkpoint(ckpt, "t")
            merged_equal = set(merged) == set(saved) and all(torch.equal(merged[p], saved[p]) for p in saved)
        resumed = engine_for(dict(case, config=case.get("dst", case["config"])), params_npz)
        if case["universal"]:
            resumed.load_universal_checkpoint(ckpt, tag="t")
        else:
            resumed.load_checkpoint(ckpt, tag="t")
        steps_loaded = resumed.global_steps
        more, _ = _train(resumed, batches(batches_npz, resumed, pre, post), post)
        exact = all(torch.equal(a, b) for a, b in zip(resumed.full_masters(), want_masters))
        torch.save(dict(want=want, got=got + more, exact=exact, merged_equal=merged_equal, steps_loaded=steps_loaded),
                   os.path.join(out_dir, f"ckpt{i}_rank{rank}.pt"))


def refusals(rank, world, cases, params_npz, out_dir):
    """Each case's ``(exception type name, message)`` from ``initialize``, "" when nothing raised."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig, init_params
    from deepspeed_tpu_torch.parallel.mesh import reset_mesh

    got = []
    for case in cases:
        reset_mesh()
        cfg = TransformerConfig(**case["model"])
        params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        try:
            dst.initialize(model=CausalLM(cfg), model_parameters=params, config=case["config"], device="cpu",
                           mpu=object() if case.get("mpu") else None)
            got.append(("", ""))
        except (ValueError, NotImplementedError) as e:
            got.append((type(e).__name__, str(e)))
    torch.save(got, os.path.join(out_dir, f"refused_rank{rank}.pt"))
