"""Ranks of the port's pipeline and sequence-parallel engines, spawned over
gloo (``torch_zero_worker.spawn``) for the CPU tests. Imports torch and the
port only.

``pipe_cases`` trains each case's ``PipelineEngine`` (a ``CausalLM`` from a
whole numpy tree, or ``layerspec_model()``) on this rank's rows of the same
global micro-batches and writes its losses, norms, stage masters and
pipeline counters; ``seq_cases`` does the same for the data-parallel engine
under ``seq`` / ``context``; ``attention_cases`` runs ``ulysses_attention``
and ``ring_attention`` on this rank's slices of seeded q, k, v, with the
gradients of a sum of squares; ``refusals`` collects the messages of the
configurations the engines refuse.
"""

import os

import numpy as np
import torch

from torch_zero_worker import rows


# ---------------------------------------------------------------- a PipelineModule of LayerSpecs (JAX test_pipe's)
class Embed(torch.nn.Module):
    def __init__(self, vocab: int, d: int):
        super().__init__()
        self.wte = torch.nn.Parameter(torch.randn(vocab, d) * 0.02)

    def forward(self, ids):
        return torch.nn.functional.embedding(ids.long(), self.wte)


class Block(torch.nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.up = torch.nn.Linear(d, 2 * d)
        self.down = torch.nn.Linear(2 * d, d)

    def forward(self, x):
        return x + self.down(torch.nn.functional.gelu(self.up(x), approximate="tanh"))


def tied_head(module, p, x):
    """The unembedding with the tied embedding matrix (a ``TiedLayerSpec`` ``forward_fn``)."""
    return x @ p["wte"].T


def mean_ce(logits, labels):
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


def layerspec_model(vocab=64, d=16, n_blocks=4):
    from deepspeed_tpu_torch.pipe import LayerSpec, PipelineModule, TiedLayerSpec

    return PipelineModule([TiedLayerSpec("embed", Embed, vocab, d)] + [LayerSpec(Block, d) for _ in range(n_blocks)]
                          + [TiedLayerSpec("embed", Embed, vocab, d, forward_fn=tied_head)], loss_fn=mean_ce)


def _tree(npz: str) -> dict:
    tree = {}
    for path, v in np.load(npz).items():
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = v
    return tree


def _model(case):
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig

    if case["model"] == "layerspec":
        return layerspec_model()
    return CausalLM(TransformerConfig(**case["model"]))


def _params(case, params_npz):
    tree = _tree(params_npz)
    if case["model"] == "layerspec":
        return {k: {n: torch.from_numpy(v) for n, v in sub.items()} for k, sub in tree.items()}
    from deepspeed_tpu_torch.models import params_from_numpy

    return params_from_numpy(tree, "cpu", cfg=_model(case).cfg)


def _batches(batches_npz: str, engine, n: int):
    b = np.load(batches_npz)
    keys = sorted({k.split("__")[0] for k in b.files})
    return iter([rows({k: b[f"{k}__{j}"] for k in keys}, engine.dp_rank, engine.dp_world_size) for j in range(n)])


def pipe_cases(rank, world, cases, params_files, batch_files, steps, out_dir):
    import deepspeed_tpu_torch as dst

    for i, (case, params_npz, batches_npz) in enumerate(zip(cases, params_files, batch_files)):
        engine, _, _, _ = dst.initialize(model=_model(case), model_parameters=_params(case, params_npz),
                                         config=case["config"], device="cpu")
        M = engine.num_microbatches
        it = _batches(batches_npz, engine, steps * M)
        losses, norms = [], []
        for _ in range(steps):
            losses.append(float(engine.train_batch(it)))
            norms.append(engine.get_global_grad_norm())
        try:
            engine.save_checkpoint(os.path.join(out_dir, "ckpt"))
            ckpt = ""
        except NotImplementedError as e:
            ckpt = str(e)
        torch.save(dict(losses=losses, norms=norms, stage=engine.stage_id, data=engine.dp_rank,
                        cls=type(engine).__name__, masters={p: t.detach().numpy() for p, t in
                                                            zip(engine._paths, engine.parameters())},
                        peak_stash=engine.peak_stash, nbuf=engine._schedule(True).num_pipe_buffers(),
                        sent=engine.p2p.sent_bytes, comm=engine.comm_stats, ckpt=ckpt),
                   os.path.join(out_dir, f"case{i}_rank{rank}.pt"))


def seq_cases(rank, world, cases, params_npz, batches_npz, steps, out_dir):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig, params_from_numpy

    for i, case in enumerate(cases):
        cfg = TransformerConfig(**case["model"])
        engine, _, _, _ = dst.initialize(model=CausalLM(cfg), model_parameters=params_from_numpy(
            _tree(params_npz), "cpu", cfg=cfg), config=case["config"], device="cpu")
        it = _batches(batches_npz, engine, steps)
        losses, norms = [], []
        for _ in range(steps):
            losses.append(float(engine.train_batch(it)))
            norms.append(engine.get_global_grad_norm())
        full = {p: t.numpy() for p, t in zip(engine._paths, engine.full_masters())}
        from deepspeed_tpu_torch.utils import groups

        kind = engine._sp.kind
        getters = (groups.get_sequence_parallel_world_size(), groups.get_sequence_parallel_rank(),
                   groups.get_context_parallel_world_size(), groups.get_context_parallel_rank(),
                   groups.get_pipe_parallel_world_size(),
                   torch.distributed.get_process_group_ranks(getattr(groups, f"get_{'sequence' if kind == 'seq' else 'context'}_parallel_group")())
                   if engine._sp.group is not None else list(range(world)))
        torch.save(dict(losses=losses, norms=norms, masters=full if rank == 0 else None, comm=engine.comm_stats,
                        sp=(kind, engine._sp.size, engine._sp.rank), getters=getters),
                   os.path.join(out_dir, f"case{i}_rank{rank}.pt"))


def attention_cases(rank, world, inputs_npz, cases, out_dir):
    """Each case on this rank's slice of the sequence: the output and the
    gradients of q, k, v of the sum of squares of the whole output."""
    from deepspeed_tpu_torch import comm as dist
    from deepspeed_tpu_torch.sequence import ring_attention, ulysses_attention

    a = np.load(inputs_npz)
    res = {}
    for name, kind, causal in cases:
        q, k, v = (torch.from_numpy(a[f"{name}_{t}"]) for t in "qkv")
        n = q.shape[1] // world
        q, k, v = (t[:, rank * n:(rank + 1) * n].clone().requires_grad_(True) for t in (q, k, v))
        fn = ulysses_attention if kind == "ulysses" else ring_attention
        out = fn(q, k, v, causal=causal)
        out.square().sum().backward()
        res[(name, kind, causal)] = dict(out=out.detach(), dq=q.grad, dk=k.grad, dv=v.grad)
    res["world"] = dist.get_world_size()
    torch.save(res, os.path.join(out_dir, f"attn_rank{rank}.pt"))


def refusals(rank, world, cases, out_dir):
    """Each case's ``(exception type name, message)`` from ``initialize``
    (or from a step / a call, as the case says), "" when nothing raised."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig, init_params

    got = []
    for case in cases:
        cfg = TransformerConfig(**case["model"])
        params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        try:
            engine, _, _, _ = dst.initialize(model=CausalLM(cfg), model_parameters=params, config=case["config"],
                                             device="cpu")
            ids = np.zeros((engine.train_micro_batch_size_per_gpu, case.get("seq_len", 16)), np.int32)
            engine.train_batch(iter([{"input_ids": ids}] * 8))
            got.append(("", ""))
        except (ValueError, NotImplementedError, TypeError, RuntimeError) as e:
            got.append((type(e).__name__, str(e)))
    torch.save(got, os.path.join(out_dir, f"refused_rank{rank}.pt"))


def p2p_cases(rank, world, out_dir):
    """The point-to-point transfers and the all-to-all on this rank's device
    (CUDA tensors over gloo named for them are staged through the host): a
    send to the next rank and a receive from the previous one, a ring hop by
    ``batch_isend_irecv``, and ``all_to_all_single``, each on seeded bf16 and
    fp32 tensors every rank can regenerate."""
    from deepspeed_tpu_torch import comm as dist

    dev = torch.device("cuda", 0) if torch.cuda.is_available() and dist.named_backend() == "gloo" else \
        torch.device("cpu")

    def mine(r, dtype, shape=(3, 1000)):
        return torch.randn(shape, generator=torch.Generator().manual_seed(100 + r)).to(dev, dtype)

    nxt, prv = (rank + 1) % world, (rank - 1) % world
    ok = {}
    for dtype in (torch.float32, torch.bfloat16):
        if rank % 2 == 0:
            dist.send(mine(rank, dtype), nxt)
            got = torch.empty_like(mine(rank, dtype))
            dist.recv(got, prv)
        else:
            got = torch.empty_like(mine(rank, dtype))
            dist.recv(got, prv)
            dist.send(mine(rank, dtype), nxt)
        ok[f"send_recv_{dtype}"] = got.device == dev and torch.equal(got, mine(prv, dtype))
        recv = torch.empty_like(mine(rank, dtype))
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, mine(rank, dtype), nxt),
                                        dist.P2POp(dist.irecv, recv, prv)])
        for w in works:
            w.wait()
        ok[f"ring_{dtype}"] = torch.equal(recv, mine(prv, dtype))
        x = mine(rank, dtype, (world, 257))
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        want = torch.stack([mine(i, dtype, (world, 257))[rank] for i in range(world)])
        ok[f"all_to_all_{dtype}"] = out.device == dev and torch.equal(out, want)
    torch.save(dict(ok=ok, device=str(dev), named=dist.named_backend()), os.path.join(out_dir, f"p2p_rank{rank}.pt"))


def small_engine_cases(rank, world, out_dir):
    """The pipeline engine (pipe 2, 1F1B) and the engine at seq 2 and context 2
    on a small model (head dim 64, which the flash kernels take), fp32, on
    this rank's device: CUDA tensors over gloo named for them (the flash
    kernels in every stage and under Ulysses), or the CPU."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm as dist
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig, init_params
    from deepspeed_tpu_torch.parallel.mesh import reset_mesh

    dev = "cuda" if torch.cuda.is_available() and dist.named_backend() == "gloo" else "cpu"
    cfg = TransformerConfig(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=256, max_seq_len=64,
                            norm="rmsnorm", activation="swiglu", pos_emb="rope", tie_embeddings=True)
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, 128, (2, 32)).astype(np.int32)} for _ in range(8)]
    out = {}
    for name, mesh, gas in (("pipe", {"pipe": 2, "data": 1}, 2), ("seq", {"seq": 2}, 1), ("context", {"context": 2}, 1)):
        reset_mesh()
        conf = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": gas, "steps_per_print": 1000,
                "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-3}}, "mesh": mesh}
        params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        engine, _, _, _ = dst.initialize(model=CausalLM(cfg), model_parameters=params, config=conf, device=dev)
        it = iter(batches)
        out[name] = [float(engine.train_batch(it)) for _ in range(3)]
    torch.save(dict(losses=out, device=dev), os.path.join(out_dir, f"engines_{'cuda' if dev == 'cuda' else 'cpu'}"
                                                                    f"_rank{rank}.pt"))
