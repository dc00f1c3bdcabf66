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


# a tiny Mixtral-shaped MoE (``tests/test_torch_engine.py``'s ``MOE``), every block MoE: a case's ``"model": MOE``
MOE = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=32, max_seq_len=128, norm="rmsnorm",
           activation="swiglu", pos_emb="rope", tie_embeddings=False, moe_num_experts=4, moe_top_k=2,
           moe_layer_freq=1)


def model_cfg(vocab: int, fields=None):
    """gpt2_tiny at ``vocab``, or a ``TransformerConfig`` of ``fields``."""
    from deepspeed_tpu_torch.models import TransformerConfig, gpt2_tiny

    if fields:
        return TransformerConfig(**fields)
    return dataclasses.replace(gpt2_tiny(), vocab_size=vocab)


def engine_for(case: dict, params_npz: str, vocab: int):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM, params_from_numpy

    cfg = model_cfg(vocab, case.get("model"))
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
    """Each rank feeds its data-parallel rows (the ranks of an expert group the same rows)."""
    for i, (case, batches_npz) in enumerate(zip(cases, batch_files)):
        batches = np.load(batches_npz)
        engine = engine_for(case, params_npz, vocab)
        gas = case["config"].get("gradient_accumulation_steps", 1)
        keys = sorted({k.split("__")[0] for k in batches.files})
        it = iter([rows({k: batches[f"{k}__{j}"] for k in keys}, engine.dp_rank, engine.dp_world_size)
                   for j in range(steps * gas)])
        losses, norms = [], []
        for _ in range(steps):
            losses.append(float(engine.train_batch(it)))
            norms.append(engine.get_global_grad_norm())
        full = {p: t.numpy() for p, t in zip(engine._paths, engine.full_masters())}
        torch.save(dict(losses=losses, norms=norms, masters=full if rank == 0 else None, held=held_bytes(engine),
                        gather=gather_limits(engine), comm=engine.comm_stats, steps=engine.global_steps,
                        offload=engine.offload_stats, local=[tuple(m.shape) for m in engine.parameters()],
                        expert_dims=[lf.expert_dim for lf in engine.plan.leaves],
                        zeropp=(engine.zeropp_active, engine.zeropp_reason),
                        secondary=getattr(engine._stage3, "secondary_bytes", None)),
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
        it = _batch_iter(batches_npz, straight.dp_rank, straight.dp_world_size, 0, 6)
        want = [float(straight.train_batch(it)) for _ in range(6)]
        want_masters = [t.clone() for t in straight.full_masters()]
        first = engine_for(case, params_npz, vocab)
        it = _batch_iter(batches_npz, first.dp_rank, first.dp_world_size, 0, 3)
        got = [float(first.train_batch(it)) for _ in range(3)]
        first.save_checkpoint(ckpt, tag="step3", client_state={"note": "kept", "rank_seen": rank})
        first.checkpoint_engine.wait()
        saved_masters = {p: t.clone() for p, t in zip(first._paths, first.full_masters())}
        resumed = engine_for(case, params_npz, vocab)
        path, client = resumed.load_checkpoint(ckpt)
        it = _batch_iter(batches_npz, resumed.dp_rank, resumed.dp_world_size, 3, 3)
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
    it = _batch_iter(batches_npz, engine.dp_rank, engine.dp_world_size, 3, 6)
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


def compressed_ops(rank, world, inputs_npz, out_dir):
    """The compressed collectives on this rank's row of each seeded input, and
    ``Collectives``' bucketed qgZ sum beside the per-leaf function."""
    from deepspeed_tpu_torch.runtime.comm import compressed as c
    from deepspeed_tpu_torch.runtime.zero.partition import ZeroPlan
    from deepspeed_tpu_torch.runtime.zero.sharded import Collectives

    a = np.load(inputs_npz)
    row = lambda k: torch.from_numpy(a[k][rank])
    quant = c.all_to_all_quant_reduce(row("x"))
    out, worker_error, server_error = c.compressed_allreduce(row("x"), row("we"), row("se"))
    leaves = [row(f"t{j}") for j in range(3)]
    scattered = c.reduce_scatter_coalesced(leaves)
    coll = Collectives(ZeroPlan(3, "fsdp", world, rank, []), None, None, 1, bucket=10**9)
    bucketed = coll._quant_sum([t.reshape(-1) for t in leaves], "zero")
    each = [c.all_to_all_quant_reduce(t.reshape(-1)) * world for t in leaves]
    torch.save(dict(quant=quant, out=out, worker_error=worker_error, server_error=server_error, scattered=scattered,
                    bucketed_equal=all(torch.equal(x, y) for x, y in zip(bucketed, each)), comm=coll.stats),
               os.path.join(out_dir, f"ops_rank{rank}.pt"))


def qwz_bytes(rank, world, params_npz, vocab, out_dir):
    """The bytes of one stage-3 forward's gathers (``eval_batch``: each group
    gathered once) with and without qwZ, beside each sharded leaf's chunk size."""
    from deepspeed_tpu_torch.runtime.zero.zeropp import quant_rows

    batch = {"input_ids": np.random.default_rng(0).integers(0, vocab, (2, 16)).astype(np.int32)}
    got = {}
    for qwz in (False, True):
        case = {"config": {"train_micro_batch_size_per_gpu": 2, "mesh": {"fsdp": world}, "zero_optimization": {
            "stage": 3, "stage3_param_persistence_threshold": 0, "zero_quantized_weights": qwz}}}
        engine = engine_for(case, params_npz, vocab)
        before = engine.comm_stats.get("all_gather", [0, 0])[1]
        engine.eval_batch(batch)
        got[qwz] = engine.comm_stats["all_gather"][1] - before
        chunks = [int(np.prod(engine.plan.shard_shape(lf, lf.param_dim))) for lf in engine.plan.leaves
                  if lf.param_dim is not None]
    torch.save(dict(plain=got[False], qwz=got[True], chunks=chunks, rows=[quant_rows(n) for n in chunks]),
               os.path.join(out_dir, f"bytes_rank{rank}.pt"))


def refused(rank, world, cases, params_npz, vocab, out_dir):
    """Each case's engine must refuse its config: the ValueError's message."""
    msgs = []
    for case in cases:
        try:
            engine_for(case, params_npz, vocab)
            msgs.append("")
        except ValueError as e:
            msgs.append(str(e))
    torch.save(msgs, os.path.join(out_dir, f"refused_rank{rank}.pt"))


def expert_groups(rank, world, mesh, out_dir):
    """The getters of ``utils/groups.py`` on a mesh with an expert axis."""
    import torch.distributed as tdist

    from deepspeed_tpu_torch.parallel.mesh import initialize_mesh
    from deepspeed_tpu_torch.runtime.config import MeshConfig
    from deepspeed_tpu_torch.utils import groups

    initialize_mesh(MeshConfig.from_dict(mesh), force=True)
    try:
        groups.initialize(ep_size=3)
        bad = ""
    except ValueError as e:
        bad = str(e)
    ep_group, edp_group = groups.get_expert_parallel_group(), groups.get_expert_data_parallel_group()
    torch.save(dict(ok=groups.initialize(ep_size=mesh["expert"]) is not None, bad=bad,
                    ep=groups.get_expert_parallel_world_size(), ep_rank=groups.get_expert_parallel_rank(),
                    ep_ranks=tdist.get_process_group_ranks(ep_group) if ep_group is not None else None,
                    edp=groups.get_expert_data_parallel_world_size(),
                    edp_ranks=tdist.get_process_group_ranks(edp_group) if edp_group is not None else None,
                    dp_rank=groups.get_data_parallel_rank()),
               os.path.join(out_dir, f"groups_rank{rank}.pt"))


def moe_layer_ep(rank, world, inputs_npz, out_dir):
    """One MoE layer under ``expert_parallel`` over every rank as one expert
    group (each rank its E / world experts, the same tokens, the RSample gate
    noise from a generator seeded alike): the output, the aux loss and the
    gradients of the tokens and of this rank's experts."""
    from deepspeed_tpu_torch import comm as dist
    from deepspeed_tpu_torch.moe import ExpertParallel, MoE, expert_parallel

    a = np.load(inputs_npz)
    E = a["wi"].shape[0]
    n = E // world
    x = torch.from_numpy(a["x"]).requires_grad_(True)
    p = {"gate": {"kernel": torch.from_numpy(a["gate"]).requires_grad_(True)},
         "experts": {k: torch.from_numpy(a[k][rank * n:(rank + 1) * n]).clone().requires_grad_(True)
                     for k in ("wi", "wo", "wg")}}
    layer = MoE(hidden_size=x.shape[-1], num_experts=E, k=1, capacity_factor=1.0, min_capacity=1,
                noisy_gate_policy="RSample", d_ff=a["wi"].shape[-1], activation="swiglu")
    with expert_parallel(ExpertParallel(world, rank, None, 1, 0, None)):
        out, l_aux, counts = layer(p, x, train=True, generator=torch.Generator().manual_seed(7))
    (out.square().sum() + l_aux).backward()
    torch.save(dict(out=out.detach(), l_aux=l_aux.detach(), counts=counts, dx=x.grad,
                    dgate=p["gate"]["kernel"].grad, dexperts={k: v.grad for k, v in p["experts"].items()},
                    world=dist.get_world_size()),
               os.path.join(out_dir, f"moe_rank{rank}.pt"))


def expert_ckpt(rank, world, case, params_npz, batches_npz, vocab, ckpt_dir, load_universal, out_dir):
    """At ``case``'s mesh: 6 straight steps; 3 steps, a native and a universal
    save, a fresh engine resuming the native files for 3 more; with
    ``load_universal`` (another mesh's universal checkpoint of step 3) a fresh
    engine resumes it for 3 more steps."""
    res = {}
    straight = engine_for(case, params_npz, vocab)
    it = _batch_iter(batches_npz, straight.dp_rank, straight.dp_world_size, 0, 6)
    res["straight"] = [float(straight.train_batch(it)) for _ in range(6)]
    want = [t.clone() for t in straight.full_masters()]
    first = engine_for(case, params_npz, vocab)
    it = _batch_iter(batches_npz, first.dp_rank, first.dp_world_size, 0, 3)
    res["first"] = [float(first.train_batch(it)) for _ in range(3)]
    first.save_checkpoint(ckpt_dir, tag="native3")
    first.save_universal_checkpoint(os.path.join(ckpt_dir, "universal"), tag="step3")
    res["saved"] = {p: t.numpy() for p, t in zip(first._paths, first.full_masters())}
    resumed = engine_for(case, params_npz, vocab)
    resumed.load_checkpoint(ckpt_dir, tag="native3")
    it = _batch_iter(batches_npz, resumed.dp_rank, resumed.dp_world_size, 3, 3)
    res["resumed"] = [float(resumed.train_batch(it)) for _ in range(3)]
    res["exact"] = all(torch.equal(a, b) for a, b in zip(resumed.full_masters(), want))
    res["local"] = {lf.path: tuple(m.shape) for lf, m in zip(resumed.plan.leaves, resumed.parameters())}
    if load_universal:
        other = engine_for(case, params_npz, vocab)
        other.load_universal_checkpoint(load_universal)
        res["loaded"] = {p: t.numpy() for p, t in zip(other._paths, other.full_masters())}
        res["loaded_steps"] = other.global_steps
        it = _batch_iter(batches_npz, other.dp_rank, other.dp_world_size, 3, 3)
        res["crossed"] = [float(other.train_batch(it)) for _ in range(3)]
    torch.save(res, os.path.join(out_dir, f"ckpt_rank{rank}.pt"))
