#!/usr/bin/env python3
"""Tile, walk and grouping choices of the bf16 block-sparse kernels on one NVIDIA GPU.

    python3 sparse_probe.py                  # from the repository root, on a machine with one CUDA GPU
    python3 sparse_probe.py fwd fwd_3st dkv  # only the variants named

Builds each bf16 body (``csrc/sparse_fwd.cu``, ``sparse_dq.cu``,
``sparse_dkv.cu``) as it stands and in variants whose geometry constants
are substituted (the forward's and dq's ``SpFwdGeo`` / ``SpDqGeo``: ring
stages, keys a sub-tile, Q's fragments in registers or shared memory, and
``sparse_walk.cuh``'s warps a block; the dk/dv's ``SpDkvGeo``: warps a
block, queries a sub-tile), each variant
linked with this tree's other sparse sources into ``build/sparse_probe/``,
and walks each with its plan: the forward and dq ``query_plan``
(``*_alike``: key-side grouping of alike lists in place of neighbouring
query blocks), dk/dv ``dkv_plan`` (the split length, the rows a block owns,
and, for ``dkv_adjacent``, groups of consecutive key blocks in place of
alike ones). Prints one JSON line each:
1. ``ptxas``: registers and spill-store bytes of each variant's entries;
2. ``case``: at every ``SPARSE_SHAPES`` case of ``chip_smoke.py`` in bf16,
   each variant's outputs against the plain version (the per-row relative
   error of ``chip_smoke.py``'s sparse phase, held to 1e-2; the forward's
   lse to 1e-4), whether a second launch gives bit-equal results, its plan
   (CUDA blocks, split groups, pieces, steps) and its time from CUDA events
   beside the bound.
The card's name and power limit come first.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "deepspeed_tpu_torch", "csrc")
OUT = os.path.join(HERE, "build", "sparse_probe")

SOURCES = {"fwd": "sparse_fwd.cu", "dq": "sparse_dq.cu", "dkv": "sparse_dkv.cu"}
ENTRY = {"fwd": "sparse_fwd_bf16", "dq": "sparse_dq_bf16", "dkv": "sparse_dkv"}  # kernel names in ptxas' log
WALK = "sparse_walk.cuh"  # the forward's and dq's shared walk: a substitution there is copied beside the variant
DKV_GEO = "  static constexpr int NW = 4, NT = 32 * NW, BM = 16 * NW, BN = 64, QS = D <= 64 ? 32 : 16;\n"
DKV_MIN = "  static constexpr int MIN_BLOCKS = D <= 64 ? 3 : 2;\n"
NW8 = [(WALK, "constexpr int kNW = 4,", "constexpr int kNW = 8,"),
       (None, "MIN_BLOCKS = D <= 64 ? 3 : 2;", "MIN_BLOCKS = D <= 64 ? 2 : 1;")]
# variant name -> (kernel, source substitutions (file, None for the kernel's own, old, new), plan fields: rows,
# alike groups (forward, dq); rows, split_tiles, adjacent groups (dk/dv))
VARIANTS = {
    "fwd": ("fwd", [], {}),
    "fwd_qsmem": ("fwd", [(None, "QREG = true;", "QREG = false;")], {}),
    "fwd_3st": ("fwd", [(None, "STAGES = 2;", "STAGES = 3;")], {}),
    "fwd_nw8": ("fwd", NW8, dict(rows=128)),
    "fwd_alike": ("fwd", [], dict(alike=True)),
    "dq": ("dq", [], {}),
    "dq_ks32": ("dq", [(None, "KS = 64;", "KS = 32;")], {}),
    "dq_qreg": ("dq", [(None, "QREG = false;", "QREG = true;")], {}),
    "dq_3st": ("dq", [(None, "STAGES = 2;", "STAGES = 3;")], {}),
    "dq_nw8": ("dq", NW8, dict(rows=128)),
    "dq_alike": ("dq", [], dict(alike=True)),
    "dkv": ("dkv", [], {}),
    "dkv_split16": ("dkv", [], dict(split_tiles=16)),
    "dkv_split32": ("dkv", [], dict(split_tiles=32)),
    "dkv_nosplit": ("dkv", [], dict(split_tiles=1 << 20)),
    "dkv_adjacent": ("dkv", [], dict(adjacent=True)),
    "dkv_nw8": ("dkv", [(None, DKV_GEO, DKV_GEO.replace("NW = 4,", "NW = 8,")),
                        (None, DKV_MIN, "  static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;\n")], dict(rows=128)),
    "dkv_qs16": ("dkv", [(None, DKV_GEO, DKV_GEO.replace("QS = D <= 64 ? 32 : 16", "QS = 16"))], {}),
}


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def build(names):
    """One library per variant: its kernel's source (substituted, or as it stands) with this tree's
    sparse_attention.cu and other two bodies. Returns {name: (path, ptxas log of the variant's source)}."""
    from deepspeed_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    nvcc = _build._nvcc()
    jobs = {"sparse_attention": os.path.join(CSRC, "sparse_attention.cu")}
    jobs.update({kernel: os.path.join(CSRC, src) for kernel, src in SOURCES.items()})
    for name in names:
        kernel, subs, _ = VARIANTS[name]
        if not subs:
            continue
        os.makedirs(os.path.join(OUT, name), exist_ok=True)
        texts = {}
        for file, old, new in subs:
            file = file or SOURCES[kernel]
            text = texts.get(file) or open(os.path.join(CSRC, file)).read()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not once in {file}")
            texts[file] = text.replace(old, new)
        texts.setdefault(SOURCES[kernel], open(os.path.join(CSRC, SOURCES[kernel])).read())
        for file, text in texts.items():  # a header beside the variant's source is found before csrc's
            with open(os.path.join(OUT, name, file), "w") as f:
                f.write(text)
        jobs[name] = os.path.join(OUT, name, SOURCES[kernel])
    procs = {key: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-I", CSRC, "-c", src, "-o",
                                    os.path.join(OUT, f"{key}.o")], stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True) for key, src in jobs.items()}
    logs = {}
    for key, proc in procs.items():
        logs[key] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{logs[key]}")
    libs = {}
    for name in names:
        kernel, subs, _ = VARIANTS[name]
        objs = ["sparse_attention"] + [name if (k == kernel and subs) else k for k in SOURCES]
        lib = os.path.join(OUT, f"lib_{name}.so")
        res = subprocess.run([nvcc, "-shared", "-o", lib] + [os.path.join(OUT, f"{o}.o") for o in objs],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"link failed for {name}:\n{res.stdout}")
        libs[name] = (lib, logs[name if subs else kernel])
    return libs


def ptxas_entries(text, kernel):
    """(entry, D, registers, spill-store bytes) of each of the kernel's entries in a ptxas -v log."""
    out, entry, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and ENTRY[kernel] in entry:
            d = re.search(r"ILi(\d+)E", entry)
            out.append(dict(kernel="reduce" if "reduce" in entry else kernel, D=int(d.group(1)) if d else None,
                            registers=int(m.group(1)), spill_store_bytes=spill))
            entry = None
    return out


def load(path):
    from deepspeed_tpu_torch.ops import _build

    handle = ctypes.CDLL(path)
    for name, argtypes in _build.SIGNATURES.items():
        if name.startswith("ds_sparse"):
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return handle


def adjacent_groups(lists, block):
    """The dk/dv's grouping without its alike rule: DKV_ROWS / min(block, DKV_ROWS) consecutive key blocks a
    group."""
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    R = min(block, ss.DKV_ROWS)
    per, n_mem = ss.DKV_ROWS // R, lists.shape[0] * (block // R)
    lens = (lists >= 0).sum(1)
    out = []
    for j0 in range(0, n_mem, per):
        members = range(j0, min(j0 + per, n_mem))
        out.append(([m * R for m in members],
                     ss._owner_walk([lists[m * R // block, :lens[m * R // block]] for m in members])))
    return out


def make_plan(ss, kernel, fields, host_idx, block):
    """The variant's plan: the forward's and dq's query plan (alike: grouped as dk/dv groups its key blocks),
    or dk/dv's dkv_plan with the variant's rows, split and grouping."""
    if kernel != "dkv":
        rows0 = ss.QUERY_ROWS
        ss.QUERY_ROWS = fields.get("rows", rows0)
        groups = ss._dkv_groups if fields.get("alike") else ss._query_groups
        try:
            return ss._walk_plan(host_idx, block, "kidx", ss.QUERY_ROWS, ss.QUERY_TILE, groups, None)
        finally:
            ss.QUERY_ROWS = rows0
    rows0, split0, groups0 = ss.DKV_ROWS, ss.DKV_SPLIT_TILES, ss._dkv_groups
    ss.DKV_ROWS, ss.DKV_SPLIT_TILES = fields.get("rows", rows0), fields.get("split_tiles", split0)
    ss._dkv_groups = adjacent_groups if fields.get("adjacent") else groups0
    try:
        plan = ss.dkv_plan(host_idx, block)
    finally:
        ss.DKV_ROWS, ss.DKV_SPLIT_TILES, ss._dkv_groups = rows0, split0, groups0
    return plan


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("sparse_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    names = [n for n in argv if n in VARIANTS] or list(VARIANTS)
    log(cs.card_line())
    libs = build(names)
    for name in names:
        log(dict(phase="ptxas", variant=name, entries=ptxas_entries(libs[name][1], VARIANTS[name][0])))
    handles = {name: load(libs[name][0]) for name in names}
    dev, dtype = torch.device("cuda", 0), torch.bfloat16
    for case, c in cs.SPARSE_SHAPES.items():
        B, S, H, D = c["q"]
        cfg, causal = cs.sparse_config(case), c["causal"]
        q, k, v, do, kidx, qidx = cs.sparse_inputs(torch, dev, dtype, case)
        k, v = ss._expand_kv(k, H // c["kvh"]), ss._expand_kv(v, H // c["kvh"])
        args = (cfg.block, D**-0.5, causal)
        o, lse = ss.sparse_fwd_ref(q, k, v, kidx, *args)
        bwd = (q, k, v, do, lse, ss.flash_delta(o, do))
        refs = {"fwd": (o, lse), "dq": (ss.sparse_bwd_dq_ref(*bwd, kidx, *args),),
                "dkv": ss.sparse_bwd_dkv_ref(*bwd, qidx, *args)}
        pairs = cs.sparse_pairs(np, case)[0] * B
        nt, stats = q.numel() * 2, B * H * S * 4
        bounds = {"fwd": cs.bound(4 * nt + stats + kidx.numel() * 4, 4 * D * pairs, dtype)[0],
                  "dq": cs.bound(5 * nt + 2 * stats + kidx.numel() * 4, 6 * D * pairs, dtype)[0],
                  "dkv": cs.bound(6 * nt + 2 * stats + qidx.numel() * 4, 8 * D * pairs, dtype)[0]}
        err = lambda a, b: cs.errors(a, b, b.float().abs().mean().item())["max_rel_err"]
        host = {"fwd": kidx.cpu().numpy(), "dq": kidx.cpu().numpy(), "dkv": qidx.cpu().numpy()}
        saved = _build._lib
        for name in names:
            kernel, _, fields = VARIANTS[name]
            plan = make_plan(ss, kernel, fields, host[kernel], cfg.block)
            dplan = ss.DevicePlan.of(plan, dev)
            run = {"fwd": lambda: ss.sparse_fwd(q, k, v, kidx, *args, plan=dplan),
                   "dq": lambda: (ss.sparse_bwd_dq(*bwd, kidx, *args, plan=dplan),),
                   "dkv": lambda: ss.sparse_bwd_dkv(*bwd, qidx, *args, plan=dplan)}[kernel]
            _build._lib = handles[name]
            try:
                got, again = run(), run()
                torch.cuda.synchronize()
                ms = cs.time_ms(run, 10)
            finally:
                _build._lib = saved
            want = refs[kernel]
            errs = [err(g, w) for g, w in zip(got, want)][:1 if kernel == "fwd" else None]
            rec = dict(phase="case", variant=name, case=case, max_rel_err=max(errs),
                       repeats=all(torch.equal(a, b) for a, b in zip(got, again)),
                       blocks=dplan.n_items * B, split_groups=dplan.n_reduce, pieces=dplan.n_slots,
                       steps=int(ss._walk_steps(plan.items[:, 2], cfg.block, 64).sum()) * B,
                       ms=ms, bound_ms=bounds[kernel], x_bound=ms / bounds[kernel])
            if kernel == "fwd":
                rec["lse_max_abs_err"] = (got[1] - want[1]).abs().max().item()
            rec["ok"] = rec["max_rel_err"] <= 1e-2 and rec.get("lse_max_abs_err", 0.0) <= 1e-4 and rec["repeats"]
            log(rec)
            del got, again
        del q, k, v, do, o, lse, bwd, refs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
