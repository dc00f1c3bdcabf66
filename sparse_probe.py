#!/usr/bin/env python3
"""Walk choices of the bf16 block-sparse dk/dv (``csrc/sparse_dkv.cu``) on one NVIDIA GPU.

    python3 sparse_probe.py                   # from the repository root, on a machine with one CUDA GPU
    python3 sparse_probe.py as_is split16     # only the variants named

Builds ``sparse_dkv.cu`` as it stands and in variants whose tile constants
(``SpDkvGeo``: warps per block, queries a sub-tile) are substituted, each
linked with this tree's ``sparse_attention.cu`` into ``build/sparse_probe/``,
and walks each with its plan (``dkv_plan``: the split length, the rows a
block owns, and, for ``adjacent``, groups of consecutive key blocks in place
of alike ones). Prints one JSON line each:
1. ``ptxas``: registers and spill-store bytes of each variant's dk/dv entries;
2. ``case``: at every ``SPARSE_SHAPES`` case of ``chip_smoke.py`` in bf16,
   each variant's dk and dv against the plain version (the per-row relative
   error of ``chip_smoke.py``'s sparse phase, held to 1e-2), whether a second
   launch gives bit-equal results, its plan (blocks, split groups, pieces)
   and its time from CUDA events beside the bound.
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

GEO = "  static constexpr int NW = 4, NT = 32 * NW, BM = 16 * NW, BN = 64, QS = D <= 64 ? 32 : 16;\n"
GEO_MIN = "  static constexpr int MIN_BLOCKS = D <= 64 ? 3 : 2;\n"
# variant name -> (source substitutions in sparse_dkv.cu, plan fields: rows, split_tiles, adjacent groups)
VARIANTS = {
    "as_is": ([], {}),
    "split16": ([], dict(split_tiles=16)),
    "split32": ([], dict(split_tiles=32)),
    "nosplit": ([], dict(split_tiles=1 << 20)),
    "adjacent": ([], dict(adjacent=True)),
    "nw8": ([(GEO, GEO.replace("NW = 4,", "NW = 8,")),
             (GEO_MIN, "  static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;\n")], dict(rows=128)),
    "qs16": ([(GEO, GEO.replace("QS = D <= 64 ? 32 : 16", "QS = 16"))], {}),
}


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def build(names):
    """One library per source variant: its sparse_dkv.cu with this tree's sparse_attention.cu. Returns
    {name: (path, ptxas log of sparse_dkv.cu)}."""
    from deepspeed_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    nvcc = _build._nvcc()
    src = open(os.path.join(CSRC, "sparse_dkv.cu")).read()
    cmd = [nvcc, *_build.NVCC_FLAGS, "-I", CSRC, "-c", os.path.join(CSRC, "sparse_attention.cu"), "-o",
           os.path.join(OUT, "sparse_attention.o")]
    procs = {"sparse_attention": subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    for name in names:
        text = src
        for old, new in VARIANTS[name][0]:
            if old not in text:
                raise RuntimeError(f"variant {name}: text not found in sparse_dkv.cu: {old!r}")
            text = text.replace(old, new)
        path = os.path.join(OUT, f"sparse_dkv_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", CSRC, "-c", path, "-o", path[:-3] + ".o"]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for key, proc in procs.items():
        logs[key] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{logs[key]}")
    libs = {}
    for name in names:
        lib = os.path.join(OUT, f"lib_{name}.so")
        res = subprocess.run([nvcc, "-shared", "-o", lib, os.path.join(OUT, "sparse_attention.o"),
                              os.path.join(OUT, f"sparse_dkv_{name}.o")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"link failed for {name}:\n{res.stdout}")
        libs[name] = (lib, logs[name])
    return libs


def ptxas_entries(text):
    """(kernel, D, registers, spill-store bytes) of each dk/dv entry in a ptxas -v log."""
    out, entry, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and "sparse_dkv" in entry:
            d = re.search(r"ILi(\d+)E", entry)
            out.append(dict(kernel="reduce" if "reduce" in entry else "dkv", D=int(d.group(1)) if d else None,
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
    """The grouping without its alike rule: DKV_ROWS / min(block, DKV_ROWS) consecutive key blocks a group."""
    import numpy as np

    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    rows = ss.DKV_ROWS
    R = min(block, rows)
    per = rows // R
    nb = lists.shape[0]
    out = []
    for j0 in range(0, nb * (block // R), per):
        members = list(range(j0, min(j0 + per, nb * (block // R))))
        blocks = [m * R // block for m in members]
        own = [lists[j][lists[j] >= 0] for j in blocks]
        union = np.unique(np.concatenate(own)).astype(np.int64) if any(len(o) for o in own) else np.zeros(0, np.int64)
        bits = np.zeros(len(union), np.int64)
        for i, o in enumerate(own):
            bits[np.searchsorted(union, o)] |= 1 << i
        out.append(([m * R for m in members], (union | bits << 24).astype(np.uint32).view(np.int32)))
    return out


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
        log(dict(phase="ptxas", variant=name, entries=ptxas_entries(libs[name][1])))
    handles = {name: load(libs[name][0]) for name in names}
    dev, dtype = torch.device("cuda", 0), torch.bfloat16
    rows0, split0, groups0 = ss.DKV_ROWS, ss.DKV_SPLIT_TILES, ss._dkv_groups
    for case, c in cs.SPARSE_SHAPES.items():
        B, S, H, D = c["q"]
        cfg, causal = cs.sparse_config(case), c["causal"]
        q, k, v, do, kidx, qidx = cs.sparse_inputs(torch, dev, dtype, case)
        k, v = ss._expand_kv(k, H // c["kvh"]), ss._expand_kv(v, H // c["kvh"])
        args = (cfg.block, D**-0.5, causal)
        o, lse = ss.sparse_fwd(q, k, v, kidx, *args)
        bwd = (q, k, v, do, lse, ss.flash_delta(o, do), qidx, *args)
        dk_ref, dv_ref = ss.sparse_bwd_dkv_ref(*bwd)
        pairs = cs.sparse_pairs(np, case)[0] * B
        nbytes = 6 * q.numel() * 2 + 2 * B * H * S * 4 + qidx.numel() * 4
        bound = cs.bound(nbytes, 8 * D * pairs, dtype)[0]
        err = lambda a, b: cs.errors(a, b, b.float().abs().mean().item())["max_rel_err"]
        host_qidx = qidx.cpu().numpy()
        saved = _build._lib
        for name in names:
            fields = VARIANTS[name][1]
            _build._lib, ss.DKV_ROWS = handles[name], fields.get("rows", rows0)
            ss.DKV_SPLIT_TILES = fields.get("split_tiles", split0)
            ss._dkv_groups = adjacent_groups if fields.get("adjacent") else groups0
            try:
                plan = ss.dkv_plan(host_qidx, cfg.block)
                dplan = ss.DeviceDkvPlan.of(plan, dev)
                dk, dv = ss.sparse_bwd_dkv(*bwd, plan=dplan)
                again = ss.sparse_bwd_dkv(*bwd, plan=dplan)
                torch.cuda.synchronize()
                ms = cs.time_ms(lambda: ss.sparse_bwd_dkv(*bwd, plan=dplan), 10)
                rec = dict(phase="case", variant=name, case=case, dk_err=err(dk, dk_ref), dv_err=err(dv, dv_ref),
                           repeats=torch.equal(dk, again[0]) and torch.equal(dv, again[1]),
                           blocks=dplan.n_items * B, split_groups=dplan.n_reduce, pieces=dplan.n_slots,
                           steps=int(ss._walk_steps(plan.items[:, 2], cfg.block, ss.DKV_TILE).sum()) * B,
                           ms=ms, bound_ms=bound, x_bound=ms / bound)
                del dk, dv, again
            finally:
                _build._lib, ss.DKV_ROWS, ss.DKV_SPLIT_TILES, ss._dkv_groups = saved, rows0, split0, groups0
            rec["ok"] = max(rec["dk_err"], rec["dv_err"]) <= 1e-2 and rec["repeats"]
            log(rec)
        del q, k, v, do, o, lse, bwd, dk_ref, dv_ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
