"""Universal checkpoints: one layout for every world size, mesh and ZeRO
stage, and for both packages.

Port of ``deepspeed_tpu/checkpoint/universal.py`` (reference
``checkpoint/ds_to_universal.py`` and ``universal_checkpoint.py``), with
the JAX package's layout exactly:

    <dir>/<tag>/zero/<param-name>/fp32.npy
    <dir>/<tag>/zero/<param-name>/exp_avg.npy        (the optimizer's first state tensor)
    <dir>/<tag>/zero/<param-name>/exp_avg_sq.npy     (its second)
    <dir>/<tag>/zero/<param-name>/optim_state_<i>.npy  (any further one)
    <dir>/<tag>/universal_meta.json                  (counters, names, number of state trees)
    <dir>/<tag>/optim_scalar_state.pkl               (loss scaler, lr scheduler)
    <dir>/latest

Every value is a numpy array, a JSON number or a pickle of plain Python
numbers and numpy scalars, so either package reads what the other wrote
without importing it. The optimizer's step count travels as the counter
``optim_step`` (the JAX package restores every optax ``count`` from it);
an engine under ZeRO-Offload also writes it as the scalar
``__offload_step__``, as the JAX package's offload engine does, and a load
falls back on that scalar where a checkpoint lacks the counter. The
moments of a host optimizer are saved and loaded like the device
optimizer's (``engine.full_optimizer_state`` reads them from host RAM or
from the swap files).
Saving all-gathers the chunks and the expert and tensor slices (every
rank must call it; rank 0 writes); loading reads whole leaves and keeps
each rank's slice and chunk, so the target may run any world size, mesh
(tensor degree included) and stage.
"""

import json
import os
import pickle
import shutil
from typing import Any, Dict, List, Optional

import numpy as np

from .. import comm as dist

UNIVERSAL_CHECKPOINT_INFO = "universal_checkpoint_info"
UNIVERSAL_META = "universal_meta.json"
SCALAR_STATE = "optim_scalar_state.pkl"
ZERO_DIR = "zero"
FP32 = "fp32.npy"
MOMENT_FILES = ("exp_avg.npy", "exp_avg_sq.npy")  # reference naming (ds_to_universal.py:131)
LATEST_FILENAME = "latest"


def _resolve_tag(ckpt_dir: str, tag: Optional[str]) -> str:
    if tag is not None:
        return str(tag)
    latest = os.path.join(ckpt_dir, LATEST_FILENAME)
    if not os.path.exists(latest):
        raise FileNotFoundError(f"no 'latest' file in {ckpt_dir}; pass tag explicitly")
    with open(latest) as f:
        return f.read().strip()


def _moment_file(i: int) -> str:
    return MOMENT_FILES[i] if i < len(MOMENT_FILES) else f"optim_state_{i}.npy"


def _write_universal(out_dir: str, tag: str, params: Dict[str, np.ndarray], moments: List[Dict[str, np.ndarray]],
                     scalar_state: Dict[str, Any], counters: Dict[str, Any]) -> str:
    """Stage into ``<tag>.tmp-writing`` and rename, then ``latest``: a reader
    never sees half a checkpoint under its final name."""
    final = os.path.join(out_dir, tag)
    root = f"{final}.tmp-writing"
    if os.path.exists(root):
        shutil.rmtree(root)
    zdir = os.path.join(root, ZERO_DIR)
    for name, arr in params.items():
        os.makedirs(os.path.join(zdir, name), exist_ok=True)
        np.save(os.path.join(zdir, name, FP32), np.asarray(arr, dtype=np.float32))
    for i, mom in enumerate(moments):
        for name, arr in mom.items():
            np.save(os.path.join(zdir, name, _moment_file(i)), np.asarray(arr))
    with open(os.path.join(root, SCALAR_STATE), "wb") as f:
        pickle.dump(scalar_state, f)
    meta = {UNIVERSAL_CHECKPOINT_INFO: {"universal_checkpoint_version": 1.0}, "counters": counters,
            "param_names": sorted(params), "n_moment_trees": len(moments)}
    with open(os.path.join(root, UNIVERSAL_META), "w") as f:
        json.dump(meta, f, indent=2)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(root, final)
    with open(os.path.join(out_dir, LATEST_FILENAME), "w") as f:
        f.write(tag)
    return final


def save_universal_checkpoint(engine, save_dir: str, tag: Optional[str] = None) -> str:
    """Write the universal layout from a live engine (every rank calls it)."""
    tag = str(tag) if tag is not None else f"global_step{engine.global_steps}"
    masters = engine.full_masters()
    states = engine.full_optimizer_state()
    names = engine.state_names()
    root = os.path.join(save_dir, tag)
    if dist.get_rank() == 0:
        params = {p: t.cpu().numpy() for p, t in zip(engine._paths, masters)}
        moments = [{p: (st[n].cpu().numpy() if n in st else np.zeros(params[p].shape, np.float32))
                    for p, st in zip(engine._paths, states)} for n in names]
        scalar_state = {"__loss_scaler__": engine.loss_scaler.state_dict()}
        if engine._host_opt is not None:
            scalar_state["__offload_step__"] = np.asarray(engine.optimizer_step_count)
        if engine.lr_scheduler is not None:
            scalar_state["__lr_scheduler__"] = engine.lr_scheduler.state_dict()
        counters = {"global_steps": engine.global_steps, "micro_steps": engine.micro_steps,
                    "global_samples": engine.global_samples, "skipped_steps": engine.skipped_steps,
                    "optim_step": engine.optimizer_step_count}
        root = _write_universal(save_dir, tag, params, moments, scalar_state, counters)
    dist.barrier(device=engine.device)
    return root


def inspect_universal_checkpoint(load_dir: str, tag: Optional[str] = None) -> Dict[str, Any]:
    with open(os.path.join(load_dir, _resolve_tag(load_dir, tag), UNIVERSAL_META)) as f:
        return json.load(f)


def load_universal_checkpoint(engine, load_dir: str, tag: Optional[str] = None, load_optimizer_states: bool = True,
                              load_lr_scheduler_states: bool = True) -> str:
    """Resume a universal checkpoint (either package's) into a live engine at
    any world size, mesh and stage."""
    tag = _resolve_tag(load_dir, tag)
    root = os.path.join(load_dir, tag)
    zdir = os.path.join(root, ZERO_DIR)
    with open(os.path.join(root, UNIVERSAL_META)) as f:
        meta = json.load(f)
    missing = [n for n in engine._paths if n not in meta["param_names"]]
    if missing:
        raise KeyError(f"universal checkpoint at {root} missing params: {missing[:5]}...")
    engine.load_full_masters({n: np.load(os.path.join(zdir, n, FP32)) for n in engine._paths}, strict=False)
    counters = meta.get("counters", {})
    scalar_state: Dict[str, Any] = {}
    if os.path.exists(os.path.join(root, SCALAR_STATE)):
        with open(os.path.join(root, SCALAR_STATE), "rb") as f:
            scalar_state = pickle.load(f)  # plain numbers and numpy scalars, written by one of the two packages
    if load_optimizer_states:
        names = engine.state_names()
        if meta.get("n_moment_trees", 0) != len(names):
            raise ValueError(f"universal checkpoint at {root} holds {meta.get('n_moment_trees', 0)} optimizer state "
                             f"trees, this engine's {type(engine.optimizer).__name__} keeps {len(names)} ({names})")
        per_leaf = [{name: np.load(os.path.join(zdir, p, _moment_file(i))) for i, name in enumerate(names)}
                    for p in engine._paths]
        step = counters["optim_step"] if "optim_step" in counters else scalar_state.get("__offload_step__", 0)
        engine.load_optimizer_state(per_leaf, int(step), whole=True)
        if "__loss_scaler__" in scalar_state:
            engine.loss_scaler.load_state_dict(scalar_state["__loss_scaler__"])
        engine.global_steps = int(counters.get("global_steps", engine.global_steps))
        engine.micro_steps = int(counters.get("micro_steps", engine.micro_steps))
        engine.global_samples = int(counters.get("global_samples", engine.global_samples))
        engine.skipped_steps = int(counters.get("skipped_steps", engine.skipped_steps))
        engine._accum_base = engine.micro_steps
    if load_lr_scheduler_states and "__lr_scheduler__" in scalar_state and engine.lr_scheduler is not None:
        engine.lr_scheduler.load_state_dict(scalar_state["__lr_scheduler__"])
    engine.zero_grad()
    return root
