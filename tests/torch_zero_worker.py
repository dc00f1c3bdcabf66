"""Ranks of the port's training engine, spawned over gloo for the CPU tests.

``spawn(world, fn, *args)`` starts ``world`` processes (the ``spawn``
start method; a ``file://`` store in a temporary directory), each running
``fn(rank, world, *args)`` after ``comm.init_distributed(device="cpu")``,
and raises if any exits non-zero or outlives its timeout. The ranks import
torch and the port only: this module imports neither JAX nor the JAX
package, so the children start quickly.

``train_cases`` is one such ``fn``: every case in one spawn, each a fresh
engine trained on this rank's rows of the same global batches, writing what
the tests compare (losses, grad norms, the whole masters; per rank the
bytes held, stage 3's gathered-byte accounting and ZeRO-Offload's
``offload_stats``) to ``out_dir``.
"""

import dataclasses
import os
import tempfile
import traceback

import numpy as np
import torch

TIMEOUT_S = 240


def _rank_main(rank, world, store, fn, args):
    torch.set_num_threads(1)
    from deepspeed_tpu_torch import comm as dist

    try:
        dist.init_distributed(device="cpu", init_method=f"file://{store}", rank=rank, world_size=world, verbose=False)
        fn(rank, world, *args)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def spawn(world: int, fn, *args, timeout: float = TIMEOUT_S) -> None:
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank_main, args=(r, world, os.path.join(d, "store"), fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
        codes = [p.exitcode for p in procs]
    if alive or any(c != 0 for c in codes):
        raise RuntimeError(f"spawned ranks failed: exit codes {codes}, {len(alive)} killed after {timeout} s")


def rows(batch: dict, rank: int, world: int) -> dict:
    """This rank's rows of a global micro-batch."""
    m = len(next(iter(batch.values()))) // world
    return {k: v[rank * m:(rank + 1) * m] for k, v in batch.items()}


def model_cfg(vocab: int):
    from deepspeed_tpu_torch.models import gpt2_tiny

    return dataclasses.replace(gpt2_tiny(), vocab_size=vocab)


def engine_for(case: dict, params_npz: str, vocab: int):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM, params_from_numpy

    cfg = model_cfg(vocab)
    flat = dict(np.load(params_npz))
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = v
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=CausalLM(cfg), model_parameters=params_from_numpy(
        tree, "cpu", cfg=cfg), config=case["config"], device="cpu")
    return engine


def held_bytes(engine) -> dict:
    """The bytes this rank holds of fp32 masters and of optimizer state
    tensors, beside the bytes the plan gives it."""
    plan = engine.plan
    masters = sum(m.numel() * m.element_size() for m in engine.parameters())
    moments = sum(v.numel() * v.element_size() for st in engine.optimizer.state.values() for v in st.values()
                  if torch.is_tensor(v) and v.dim() > 0)
    n_state = len(engine.optimizer.state_names())
    planned_masters = sum(int(np.prod(plan.shard_shape(lf, lf.param_dim))) * 4 for lf in plan.leaves)
    planned_moments = n_state * sum(int(np.prod(plan.shard_shape(lf, lf.opt_dim))) * 4 for lf in plan.leaves)
    return dict(masters=masters, moments=moments, planned_masters=planned_masters, planned_moments=planned_moments)


def gather_limits(engine) -> dict:
    """Stage 3's accounting beside its limit: the largest block plus every other top-level group."""
    s = engine._stage3
    if s is None:
        return {}
    blocks = [s.group_bytes(k) for k in s.groups if k.startswith("layer_")]
    held = sum(s.group_bytes(k) for k in s.groups if not k.startswith("layer_"))
    return dict(peak=s.peak_gathered_bytes, now=s.gathered_bytes, limit=max(blocks, default=0) + held)


def train_cases(rank, world, cases, params_npz, batch_files, vocab, steps, out_dir):
    for i, (case, batches_npz) in enumerate(zip(cases, batch_files)):
        batches = np.load(batches_npz)
        engine = engine_for(case, params_npz, vocab)
        gas = case["config"].get("gradient_accumulation_steps", 1)
        keys = sorted({k.split("__")[0] for k in batches.files})
        it = iter([rows({k: batches[f"{k}__{j}"] for k in keys}, rank, world) for j in range(steps * gas)])
        losses, norms = [], []
        for _ in range(steps):
            losses.append(float(engine.train_batch(it)))
            norms.append(engine.get_global_grad_norm())
        full = {p: t.numpy() for p, t in zip(engine._paths, engine.full_masters())}
        torch.save(dict(losses=losses, norms=norms, masters=full if rank == 0 else None, held=held_bytes(engine),
                        gather=gather_limits(engine), comm=engine.comm_stats, steps=engine.global_steps,
                        offload=engine.offload_stats),
                   os.path.join(out_dir, f"case{i}_rank{rank}.pt"))


def _batch_iter(batches_npz: str, rank: int, world: int, start: int, n: int):
    batches = np.load(batches_npz)
    keys = sorted({k.split("__")[0] for k in batches.files})
    return iter([rows({k: batches[f"{k}__{j}"] for k in keys}, rank, world) for j in range(start, start + n)])


def ckpt_round_trip(rank, world, cases, params_npz, batches_npz, vocab, ckpt_root, out_dir):
    """Per case: 6 straight steps; 3 steps, save, a fresh engine loads and takes
    3 more; a loader at another stage must refuse the files."""
    for i, case in enumerate(cases):
        ckpt = os.path.join(ckpt_root, f"case{i}")
        straight = engine_for(case, params_npz, vocab)
        it = _batch_iter(batches_npz, rank, world, 0, 6)
        want = [float(straight.train_batch(it)) for _ in range(6)]
        want_masters = [t.clone() for t in straight.full_masters()]
        first = engine_for(case, params_npz, vocab)
        it = _batch_iter(batches_npz, rank, world, 0, 3)
        got = [float(first.train_batch(it)) for _ in range(3)]
        first.save_checkpoint(ckpt, tag="step3", client_state={"note": "kept", "rank_seen": rank})
        first.checkpoint_engine.wait()
        saved_masters = {p: t.clone() for p, t in zip(first._paths, first.full_masters())}
        resumed = engine_for(case, params_npz, vocab)
        path, client = resumed.load_checkpoint(ckpt)
        it = _batch_iter(batches_npz, rank, world, 3, 3)
        got += [float(resumed.train_batch(it)) for _ in range(3)]
        exact = all(torch.equal(a, b) for a, b in zip(resumed.full_masters(), want_masters))
        other = dict(case, config={**case["config"], "zero_optimization": {
            **case["config"]["zero_optimization"], "stage": (case["config"]["zero_optimization"]["stage"] + 1) % 4}})
        try:
            engine_for(other, params_npz, vocab).load_checkpoint(ckpt)
            refused = ""
        except ValueError as e:
            refused = str(e)
        torch.save(dict(want=want, got=got, exact=exact, client=client, path=path, refused=refused,
                        steps=resumed.global_steps, saved_masters={p: t.numpy() for p, t in saved_masters.items()}),
                   os.path.join(out_dir, f"case{i}_rank{rank}.pt"))


def universal_resume(rank, world, case, params_npz, batches_npz, vocab, src_dir, dst_dir, out_dir):
    """Resume a universal checkpoint, take 3 steps, save one, take 3 more."""
    engine = engine_for(case, params_npz, vocab)
    engine.load_universal_checkpoint(src_dir)
    steps_loaded = engine.global_steps
    it = _batch_iter(batches_npz, rank, world, 3, 6)
    before = [float(engine.train_batch(it)) for _ in range(3)]
    engine.save_universal_checkpoint(dst_dir, tag="port")
    after = [float(engine.train_batch(it)) for _ in range(3)]
    torch.save(dict(before=before, after=after, steps_loaded=steps_loaded),
               os.path.join(out_dir, f"rank{rank}.pt"))


def zero_init_matches(rank, world, vocab, out_dir):
    """An engine built from ``zero.Init``'s chunks holds the masters of one built from the whole tree."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import zero
    from deepspeed_tpu_torch.models import CausalLM, init_params

    cfg = model_cfg(vocab)
    config = {"train_micro_batch_size_per_gpu": 2, "zero_optimization": {"stage": 3,
                                                                          "stage3_param_persistence_threshold": 0}}
    chunks = zero.Init(config, device="cpu").materialize(init_params, cfg, torch.Generator().manual_seed(0))
    whole = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    a, _, _, _ = deepspeed_tpu_torch.initialize(model=CausalLM(cfg), model_parameters=chunks, config=config,
                                                device="cpu")
    b, _, _, _ = deepspeed_tpu_torch.initialize(model=CausalLM(cfg), model_parameters=whole, config=config,
                                                device="cpu")
    torch.save(dict(equal=all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters())),
                    sharded=sum(lf.param_dim is not None for lf in a.plan.leaves),
                    chunk_elems=sum(p.numel() for p in a.parameters()),
                    whole_elems=sum(lf.numel for lf in a.plan.leaves)),
               os.path.join(out_dir, f"init_rank{rank}.pt"))
