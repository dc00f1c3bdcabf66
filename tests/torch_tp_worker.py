"""Ranks of the port's tensor-parallel serving, spawned for the tests.

``serve_tp_cases`` is a ``torch_zero_worker.spawn`` target (two gloo ranks
on the CPU): every case of ``tests/test_torch_serve_tp.py`` in one spawn,
each rank writing what the test compares to ``out_dir``. ``spawn_cuda`` starts
ranks whose default group is gloo named for CUDA tensors
(``comm.init_distributed(device="cuda", backend="gloo")``), for the card
tests. This module imports neither JAX nor the JAX package, so the children
start quickly.
"""

import os
import tempfile
import traceback

import numpy as np
import torch

TINY = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=32, max_seq_len=128, norm="rmsnorm",
            activation="swiglu", pos_emb="rope", tie_embeddings=False)
MOE = dict(TINY, max_seq_len=64, moe_num_experts=4, moe_top_k=2, moe_layer_freq=1, d_ff=64)
MHA = dict(TINY, n_kv_heads=None, tie_embeddings=True)  # the dense model of the shard_params case
# 999 is out of vocab (128): a vocab-sharded wte must clamp to the global vocabulary, as one device does
PROMPTS = [[3, 17, 42, 9, 999], [5, 6, 7], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]]
NEW = 10
MOTIFS = [[5, 9, 13] * 3, [7] * 6, [3, 17, 42, 3, 17, 42]]  # prompt lookup drafts from these
LOGIT_PROMPT = [3, 17, 42, 9, 88, 5, 23]
QUANT_PROMPT = [3, 17, 42, 9, 88]
MOE_PROMPT = [3, 17, 42, 9, 88, 5]
V1_IDS = [[5, 9, 2, 44, 17, 3]]
V1 = dict(vocab_size=96, n_layers=2, n_heads=2, d_model=64, max_seq_len=64, norm="rmsnorm", activation="swiglu",
          pos_emb="rope")


def save_tree(path: str, tree) -> None:
    """A nested dict of arrays as one npz of "/"-joined keys."""
    flat = {}

    def walk(node, keys):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, keys + (str(k),))
        else:
            flat["/".join(keys)] = np.asarray(node)

    walk(tree, ())
    np.savez(path, **flat)


def load_tree(path: str) -> dict:
    tree = {}
    for key, v in np.load(path).items():
        node = tree
        *parents, name = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = v
    return tree


def engine(fields, tree, tp=1, **kw):
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.models import TransformerConfig, params_from_numpy

    cfg = TransformerConfig(**fields)
    smc = dict(kv_block_size=8, max_context=fields["max_seq_len"], num_kv_blocks=kw.pop("blocks", 64))
    return InferenceEngineV2(cfg, params_from_numpy(tree, "cpu", cfg=cfg), RaggedInferenceEngineConfig(
        state_manager=RaggedBatchConfig(**smc), dtype="float32", device="cpu", tensor_parallel=tp, **kw))


def _quant_leaves(tree, keys=()):
    from deepspeed_tpu_torch.inference.quantization import QuantizedParam

    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_quant_leaves(v, keys + (k,)))
        return out
    if isinstance(tree, QuantizedParam):
        return {"/".join(keys): dict(q=tree.q.numpy(), scales=tree.scales.numpy(), layout=tree.layout)}
    return {}


def _refused(fn) -> str:
    try:
        fn()
        return ""
    except (ValueError, RuntimeError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"


def serve_tp_cases(rank, world, inputs_dir, out_dir):
    """Every tensor-parallel case at tp = world, on this rank."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm.collectives import tp_all_reduce
    from deepspeed_tpu_torch.inference.v2.model_runner import TPContext
    from deepspeed_tpu_torch.inference.v2.replay import build_engine_from_session, replay_oracle
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig, params_from_numpy
    from deepspeed_tpu_torch.module_inject import shard_params
    from deepspeed_tpu_torch.moe import drop_tokens, gather_tokens
    from deepspeed_tpu_torch.parallel.mesh import get_mesh_topology, mesh_signature
    from deepspeed_tpu_torch.telemetry import Journal, journal_override
    from deepspeed_tpu_torch.telemetry.journal import sessions_from_records

    res = {}
    tiny = load_tree(os.path.join(inputs_dir, "tiny.npz"))

    # the fused loop, the prefix-cache re-serve, the step keys, the fingerprint and the residency
    e2 = engine(TINY, tiny, world)
    res["fused"] = e2.generate(PROMPTS, max_new_tokens=NEW)
    res["reserve"] = e2.generate(PROMPTS, max_new_tokens=NEW)
    res["prefix_cache"] = e2.state.prefix_cache is not None
    res["shard_sig"] = e2._shard_sig
    res["tp_ctx"] = (e2._tp_ctx.tp, e2._tp_ctx.rank)
    res["keys"] = {"fused": list(e2._fused_fns), "bursts": list(e2._bursts)}
    res["programs"] = e2._program_signatures()
    res["fingerprint"] = e2._journal_fingerprint()["engine"]
    res["residency"] = e2._residency_summary()
    res["manifest"] = e2.tp_manifest()
    res["pool"] = (tuple(e2.k_pages.shape), e2.k_pages.numel() * e2.k_pages.element_size())
    res["sampled"] = e2.generate(PROMPTS, max_new_tokens=NEW, do_sample=True, top_k=1, seed=9)
    res["logits"] = e2.put([100], [LOGIT_PROMPT])[0]
    del e2

    s2 = engine(TINY, tiny, world, spec_decode=True, spec_k=4, decode_burst=0)
    res["spec"] = s2.generate(MOTIFS, max_new_tokens=32)
    res["spec_keys"] = list(s2._spec_fns)
    res["spec_accepted"] = s2.spec_accepted

    # the refusals
    res["refuse_kvq"] = _refused(lambda: engine(TINY, tiny, world, kv_quant_bits=8))
    res["refuse_spill"] = _refused(lambda: engine(TINY, tiny, world, kv_spill=True))

    # tp_all_reduce on this rank's row of each seeded input
    red = np.load(os.path.join(inputs_dir, "reduce.npz"))
    x = torch.from_numpy(red["x"][rank])
    res["reduce"] = {"exact": tp_all_reduce(x), "il4": tp_all_reduce(x, interleave=4),
                     "odd": tp_all_reduce(x[..., :63].contiguous(), interleave=4)}
    for bits in (8, 4):
        res["reduce"][f"b{bits}"] = tp_all_reduce(torch.from_numpy(red[f"q{bits}"][rank]), bits=bits)
    res["reduce"]["agree"] = tp_all_reduce(torch.from_numpy(red["agree"][rank]), bits=8)
    msig = mesh_signature(get_mesh_topology())
    res["mesh_sig"] = msig
    res["ctx_sig"] = TPContext(tp=world, bits=8, interleave=2, mesh=msig).signature()

    # MoE at tp 2: each expert's hidden dim over tensor
    moe_tree = load_tree(os.path.join(inputs_dir, "moe.npz"))
    m2 = engine(MOE, moe_tree, world, blocks=48)
    res["moe"] = m2.generate([MOE_PROMPT], max_new_tokens=6)[0]
    res["moe_wi"] = tuple(m2.params["layer_0"]["moe"]["experts"]["wi"].shape)
    del m2

    # quantised after sharding: every rank's codes, scales and layouts, and logits beside the dense tp 2 engine
    for bits in (8, 4):
        q = engine(TINY, tiny, world, quant_bits=bits, quant_min_size=256)
        res[f"q{bits}_leaves"] = _quant_leaves(q.params)
        res[f"q{bits}_logits"] = q.put([0], [QUANT_PROMPT])[0]
        res[f"q{bits}_gen"] = q.generate([[5, 9, 2]], max_new_tokens=4)[0]
    res["dense_quant_prompt"] = engine(TINY, tiny, world).put([0], [QUANT_PROMPT])[0]

    # the v1 engine at tp_size 2 with int8 weights
    v1 = load_tree(os.path.join(inputs_dir, "v1.npz"))
    cfg = TransformerConfig(**V1)
    qcfg = {"dtype": "fp32", "device": "cpu", "quant": {"enabled": True, "bits": 8, "group_size": 64},
            "tensor_parallel": {"tp_size": world}}
    eng = deepspeed_tpu_torch.init_inference(CausalLM(cfg), config=qcfg, params=params_from_numpy(v1, "cpu", cfg=cfg))
    res["v1"] = eng.generate(np.asarray(V1_IDS, np.int32), max_new_tokens=6).tolist()
    dense = deepspeed_tpu_torch.init_inference(CausalLM(cfg), config={**qcfg, "quant": {"enabled": False}},
                                               params=params_from_numpy(v1, "cpu", cfg=cfg))
    res["v1_dense"] = dense.generate(np.asarray(V1_IDS, np.int32), max_new_tokens=6).tolist()
    res["v1_kv_heads"] = dense.module.init_kv_caches(1, 8, device="cpu")[0][0].shape[2]

    # shard_params: this rank's slice of every leaf of a dense, a GQA and an MoE tree
    for name, fields in (("mha", MHA), ("tiny", TINY), ("moe", MOE)):
        cfg = TransformerConfig(**fields)
        tree = params_from_numpy(load_tree(os.path.join(inputs_dir, f"{name}.npz")), "cpu", cfg=cfg)
        flat = {}

        def walk(node, keys):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, keys + (k,))
            else:
                flat["/".join(keys)] = node.numpy()

        walk(shard_params(tree, CausalLM(cfg), tp_size=world, rank=rank), ())
        res[f"shard_{name}"] = flat

    # the token mappings over the tensor group
    t = torch.arange(48, dtype=torch.float32).reshape(2, 6, 4)
    mine = drop_tokens(t, dim=1)
    res["mappings"] = (tuple(mine.shape), torch.equal(mine, t[:, rank * 3:(rank + 1) * 3]),
                       torch.equal(gather_tokens(mine, dim=1), t))

    # the journal: a tp 2 session replays token for token on a rebuilt tp 2 engine; the gate refuses the rest
    journal = Journal()
    with journal_override(journal):
        out = engine(TINY, tiny, world).generate(PROMPTS, max_new_tokens=NEW)
    session = sessions_from_records(journal.records)[-1]
    cfg = TransformerConfig(**TINY)
    tparams = params_from_numpy(tiny, "cpu", cfg=cfg)
    report = replay_oracle(session, engine=build_engine_from_session(session, model=cfg, params=tparams,
                                                                     device="cpu"))
    res["replay"] = (report.ok, report.n_tokens, sum(len(t) for t in out), session.header["engine"])
    bad = Journal()
    bad.begin_session({"engine": {"dtype": "float32", "tensor_parallel": 3, "num_kv_blocks": 16, "kv_block_size": 8,
                                  "max_context": 128, "mesh": "mesh[tensor3]"},
                       "model_cfg": {"vocab_size": 128, "n_layers": 1, "n_heads": 3, "n_kv_heads": 3, "d_model": 24,
                                     "max_seq_len": 128}}, kind="generate", run={"seed": 0})
    bad.record_request(0, [1, 2], arrival_s=0.0, arrival_q=0, max_new_tokens=2)
    bad.end_session({})
    res["refuse_world"] = _refused(lambda: build_engine_from_session(sessions_from_records(bad.records)[-1],
                                                                      device="cpu"))
    header = dict(session.header, engine=dict(session.header["engine"],
                                              shard_sig="tp2:tensor:b0:il2:mesh[data4,tensor2]"))
    other = type(session)(header)
    res["refuse_sig"] = _refused(lambda: build_engine_from_session(other, model=cfg, params=tparams, device="cpu"))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _cuda_rank_main(rank, world, store, fn, args):
    torch.set_num_threads(1)
    from deepspeed_tpu_torch import comm as dist

    try:
        dist.init_distributed(device="cuda:0", backend="gloo", init_method=f"file://{store}", rank=rank,
                              world_size=world, verbose=False)
        fn(rank, world, *args)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def spawn_cuda(world: int, fn, *args, timeout: float = 300) -> None:
    """``world`` ranks on the one GPU, over gloo named for CUDA tensors."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_cuda_rank_main, args=(r, world, os.path.join(d, "store"), fn, args))
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


def cuda_reduce_cases(rank, world, out_dir):
    """On the card, over gloo named for CUDA: ``tp_all_reduce`` exact,
    interleaved and 8-bit on this rank's seeded row, and ``quantized_matmul``
    on this rank's K rows of int8 codes, its partial reduced, beside the
    unsharded product on the plain version. The codes are quantised once,
    with groups that end at the shard edge, and each rank takes its rows: the
    same codes on both sides (a quantiser on another device may round a tie
    the other way)."""
    from deepspeed_tpu_torch.comm.collectives import tp_all_reduce
    from deepspeed_tpu_torch.ops._utils import block_that_divides
    from deepspeed_tpu_torch.ops.quantized_matmul import (quantize_weight_kgroups, quantized_matmul,
                                                          quantized_matmul_ref)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(0)
    xs = torch.randn((world, 8, 4096), generator=g)
    x = xs[rank].to(dev)
    res = {"exact": tp_all_reduce(x).cpu(), "il": tp_all_reduce(x, interleave=world).cpu(),
           "b8": tp_all_reduce(x, bits=8).cpu(), "want": xs.sum(0), "amax": xs.abs().amax(dim=(0, -1))}
    K, N, M = 2048, 4096, 16
    w = torch.randn((K, N), generator=g) * 0.02
    a = torch.randn((M, K), generator=g)
    k = K // world
    gs = block_that_divides(k, 128)
    qf, sf = quantize_weight_kgroups(w, group_size=gs)  # K-groups aligned to the shard edge
    q, s = qf[rank * k:(rank + 1) * k].to(dev), sf[rank * k // gs:(rank + 1) * k // gs].to(dev)
    part = quantized_matmul(a[:, rank * k:(rank + 1) * k].contiguous().to(dev), q, s)
    res["qmm"] = tp_all_reduce(part).cpu()
    res["qmm_want"] = quantized_matmul_ref(a, qf, sf)
    res["launches"] = quantized_matmul.launches
    torch.save(res, os.path.join(out_dir, f"cuda_rank{rank}.pt"))


def cuda_on_unnamed_gloo(rank, world, out_dir):
    """A CUDA tensor on a gloo group that no caller named for CUDA: the collective must raise."""
    from deepspeed_tpu_torch import comm as dist

    try:
        dist.all_reduce(torch.ones(4, device="cuda:0"))
        msg = ""
    except RuntimeError as e:
        msg = str(e)
    torch.save(dict(msg=msg, named=dist.named_backend()), os.path.join(out_dir, f"unnamed_rank{rank}.pt"))
