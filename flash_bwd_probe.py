#!/usr/bin/env python3
"""Tile choices of the bf16 flash backward (``csrc/flash_bwd.cu``) on one NVIDIA GPU.

    python3 flash_bwd_probe.py                      # from the repository root, on a machine with one CUDA GPU
    python3 flash_bwd_probe.py as_is dq_bias_3st    # only the variants named

Builds ``flash_bwd.cu`` as it stands and in variants whose tile constants
(``DqGeo``, ``DkvGeo``) are substituted, each linked with this tree's
``flash_attention.cu`` and ``flash_fwd.cu`` into ``build/flash_bwd_probe/``,
and prints one JSON line each:
1. ``ptxas``: registers and spill-store bytes of every dq and dk/dv entry of
   each variant (D, ALiBi, bias);
2. ``case``: at every ``FLASH_CASES`` case of ``chip_smoke.py`` in bf16,
   each variant's dq and dk/dv against their plain versions (the per-row
   relative error of ``chip_smoke.py``'s flash phase, held to 1e-2), whether
   a second launch gives bit-equal results, and their times from CUDA events
   beside their bounds;
3. ``bias case``: the same for the bias bodies (dq writing dbias, dk/dv with
   a bias) at the ``EVO_SHAPES`` cases ``msa_row`` and ``msa_row_finetune``
   (the 384 x 512 crop), with dbias held to the same tolerance, and the bytes
   each kernel must move over its time against the card's 3.35 TB/s;
4. ``collapsed case``: the collapsed dq (dq plus dbias summed over the
   programs that share a bias slice) at ``msa_row_pair`` (Sqb = Sq) and
   ``msa_col`` (Sqb = 1), with its plan (chunks, partials), errors, bit-equal
   repeats and time beside the bound and dk/dv with the same bias.
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
OUT = os.path.join(HERE, "build", "flash_bwd_probe")

DQ = "  static constexpr int NW = 8, NT = 32 * NW, BM = 16 * NW, BN = 64, KS = D <= 64 && !BIAS ? 32 : 64;\n"
DQ_MIN = "  static constexpr int MIN_BLOCKS = D <= 64 && !BIAS ? 2 : 1;\n"
DQ_ST = "  static constexpr int STAGES = 2;  // the ring's depth"
DQ_QBUF = "  static constexpr int QBUF = SUM && 4 * q_bytes + ring <= 200 * 1024 ? 2 : 1;\n"
DKV = "  static constexpr int NW = 4, NT = 32 * NW, BM = 16 * NW, BN = 64, QS = D <= 64 ? 32 : 16;\n"
DKV_MIN = "  static constexpr int MIN_BLOCKS = D <= (BIAS ? 32 : 64) ? 3 : (BIAS && D > 64 ? 1 : 2);\n"
# variant name -> (source text, replacement) pairs; each text must occur in flash_bwd.cu
VARIANTS = {
    "as_is": [],
    "dq_bias_3st": [(DQ_ST, DQ_ST.replace("= 2;", "= BIAS && D <= 64 ? 3 : 2;"))],
    "dq_bias_ks32_2blk": [(DQ, DQ.replace("KS = D <= 64 && !BIAS ? 32 : 64", "KS = D <= 64 ? 32 : 64")),
                          (DQ_MIN, DQ_MIN.replace("D <= 64 && !BIAS ? 2 : 1", "D <= (BIAS ? 32 : 64) ? 2 : 1"))],
    "dq_ks32": [(DQ, DQ.replace("KS = D <= 64 && !BIAS ? 32 : 64", "KS = 32"))],
    "dq_ks64_1blk": [(DQ, DQ.replace("KS = D <= 64 && !BIAS ? 32 : 64", "KS = 64")),
                     (DQ_MIN, "  static constexpr int MIN_BLOCKS = 1;\n")],
    "dq_nw4": [(DQ, DQ.replace("NW = 8,", "NW = 4,")), (DQ_MIN, "  static constexpr int MIN_BLOCKS = 3;\n")],
    "dkv_nw8": [(DKV, DKV.replace("NW = 4,", "NW = D <= 64 ? 8 : 4,")),
                (DKV_MIN, "  static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;\n")],
    "dkv_bias_3st": [("  static constexpr int STAGES = 2;\n" + DKV_MIN,
                      "  static constexpr int STAGES = BIAS && D <= 64 ? 3 : 2;\n"
                      + DKV_MIN.replace("? 3 :", "? (BIAS ? 2 : 3) :"))],
    "dkv_qs16": [(DKV, DKV.replace("QS = D <= 64 ? 32 : 16", "QS = 16"))],
    "dkv_1blk": [(DKV_MIN, "  static constexpr int MIN_BLOCKS = 1;\n")],
    "dq_sum_ks32": [(DQ, DQ.replace("KS = D <= 64 && !BIAS ? 32 : 64", "KS = D <= 64 && (!BIAS || SUM) ? 32 : 64"))],
    "dq_sum_1qbuf": [(DQ_QBUF, DQ_QBUF.replace("? 2 : 1", "? 1 : 1"))],
    # a third ring stage in the collapsed dq (its next program's Q and dO need a walk of 2 key tiles or more)
    "dq_sum_3st": [(DQ_ST, DQ_ST.replace("= 2;", "= SUM ? 3 : 2;"))],
}
BIAS_CASES = ("msa_row", "msa_row_finetune")
COLLAPSED_CASES = ("msa_row_pair", "msa_col")


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def build(names):
    """One library per variant: the variant's flash_bwd.cu with this tree's flash_attention.cu and
    flash_fwd.cu. Returns {name: (path, ptxas log of flash_bwd.cu)}."""
    from deepspeed_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    nvcc = _build._nvcc()
    src = open(os.path.join(CSRC, "flash_bwd.cu")).read()
    procs = {}
    for base in ("flash_attention", "flash_fwd"):
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", CSRC, "-c", os.path.join(CSRC, base + ".cu"), "-o",
               os.path.join(OUT, base + ".o")]
        procs[base] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: text not found in flash_bwd.cu: {old!r}")
            text = text.replace(old, new)
        path = os.path.join(OUT, f"flash_bwd_{name}.cu")
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
        objs = [os.path.join(OUT, f"{b}.o") for b in ("flash_attention", "flash_fwd")]
        res = subprocess.run([nvcc, "-shared", "-o", lib, *objs, os.path.join(OUT, f"flash_bwd_{name}.o")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"link failed for {name}:\n{res.stdout}")
        libs[name] = (lib, logs[name])
    return libs


def ptxas_entries(text):
    """(entry, registers, spill-store bytes) of each dq / dk/dv kernel in a ptxas -v log."""
    out, entry, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and any(n in entry for n in ("flash_dq_bf16_kernel", "flash_dq_collapsed_bf16_kernel",
                                                    "flash_dkv_bf16_kernel")):
            kind = "dq" if "flash_dq" in entry else "dkv"
            # dq: <D, ALIBI, what it does with dlogits (DqBias)>; dk/dv: <D, ALIBI, BIAS>
            targs = re.search(r"ILi(\d+)ELb([01])EL([ib])(\d)E", entry)
            bias = targs and (["none", "per program", "summed rows", "summed columns"][int(targs.group(4))]
                              if targs.group(3) == "i" else targs.group(4) == "1")
            out.append(dict(kernel=kind, D=int(targs.group(1)) if targs else None,
                            alibi=targs.group(2) == "1" if targs else None, bias=bias, registers=int(m.group(1)),
                            spill_store_bytes=spill))
            entry = None
    return out


def load(path):
    from deepspeed_tpu_torch.ops import _build

    handle = ctypes.CDLL(path)
    for name, argtypes in _build.SIGNATURES.items():
        if name.startswith("ds_flash"):
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return handle


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from deepspeed_tpu_torch.models import alibi_slopes
    from deepspeed_tpu_torch.ops import _build, flash_attention as fa

    names = [n for n in argv if n in VARIANTS] or list(VARIANTS)
    log(cs.card_line())
    libs = build(names)
    for name in names:
        log(dict(phase="ptxas", variant=name, entries=ptxas_entries(libs[name][1])))
    handles = {name: load(libs[name][0]) for name in names}
    dev, dtype = torch.device("cuda", 0), torch.bfloat16
    for case, c in cs.FLASH_CASES.items():
        B, Sq, Sk, H, KVH, D = (c[k] for k in ("B", "Sq", "Sk", "H", "KVH", "D"))
        causal, window = c["causal"], c.get("window", 0)
        g = torch.Generator(device=dev).manual_seed(Sq + H)
        q, k, v, do = (torch.randn(s, generator=g, device=dev).to(dtype)
                       for s in ((B, Sq, H, D), (B, Sk, KVH, D), (B, Sk, KVH, D), (B, Sq, H, D)))
        slopes = torch.from_numpy(alibi_slopes(H)).to(dev) if c.get("alibi") else None
        args = (slopes, D**-0.5, causal, window)
        o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, *args)
        bwd = (q, k, v, do, lse_ref, fa.flash_delta(o_ref, do), *args)
        dq_ref = fa.flash_bwd_dq_ref(*bwd)
        dk_ref, dv_ref = fa.flash_bwd_dkv_ref(*bwd)
        pairs = cs.visible_pairs(Sq, Sk, causal, window) * B * H
        err = lambda a, b: cs.errors(a, b, b.float().abs().mean().item())["max_rel_err"]
        saved = _build._lib
        for name in names:
            _build._lib = handles[name]
            try:
                dq = fa.flash_bwd_dq(*bwd)
                dk, dv = fa.flash_bwd_dkv(*bwd)
                torch.cuda.synchronize()
                again = fa.flash_bwd_dq(*bwd), *fa.flash_bwd_dkv(*bwd)
                torch.cuda.synchronize()
                rec = dict(phase="case", variant=name, case=case,
                           dq_err=err(dq, dq_ref), dkv_err=max(err(dk, dk_ref), err(dv, dv_ref)),
                           repeats=all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again)),
                           dq_ms=cs.time_ms(lambda: fa.flash_bwd_dq(*bwd), 20),
                           dkv_ms=cs.time_ms(lambda: fa.flash_bwd_dkv(*bwd), 20),
                           dq_bound_ms=cs.bound(0, 6 * D * pairs, dtype)[0],
                           dkv_bound_ms=cs.bound(0, 8 * D * pairs, dtype)[0])
            finally:
                _build._lib = saved
            rec["ok"] = rec["dq_err"] <= 1e-2 and rec["dkv_err"] <= 1e-2 and rec["repeats"]
            log(rec)
        del q, k, v, do, o_ref, dq_ref, dk_ref, dv_ref, bwd
        torch.cuda.empty_cache()
    for case in BIAS_CASES:
        bias_case(torch, cs, fa, _build, handles, case)
    for case in COLLAPSED_CASES:
        collapsed_case(torch, cs, fa, _build, handles, case)
    return 0


def bias_case(torch, cs, fa, _build, handles, case):
    """Each variant's dq writing dbias and dk/dv with a bias at one EVO_SHAPES case (a bias that nothing
    collapses), against the plain versions, with the bytes each must move over its time."""
    from deepspeed_tpu_torch.ops import evoformer as evo

    dev, dtype = torch.device("cuda", 0), torch.bfloat16
    q5, k5, v5, do5, biases = cs.evo_inputs(torch, dev, dtype, case)
    lead, (Sq, H, D) = q5.shape[:-3], q5.shape[-3:]
    B = q5.numel() // (Sq * H * D)
    q, k, v, do = (t.reshape(B, Sq, H, D) for t in (q5, k5, v5, do5))
    bias, meta = fa.flat_bias(*evo.fold_biases(biases, lead), B, H, Sq, Sq)
    del biases, q5, k5, v5, do5
    args = (None, D**-0.5, False, 0, bias, meta)
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, *args)
    bwd = (q, k, v, do, lse_ref, fa.flash_delta(o_ref, do), *args)
    del o_ref
    dbias_ref = torch.empty_like(bias)
    dq_ref = fa.flash_bwd_dq_ref(*bwd, dbias_ref)
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(*bwd)
    err = lambda a, b: cs.evo_err(torch, a, b)["max_rel_err"]
    nq, nk, nb, stats = q.numel() * 2, k.numel() * 2, bias.numel() * 4, B * H * Sq * 4
    dq_bytes, dkv_bytes = 3 * nq + 2 * nk + 2 * stats + 2 * nb, 2 * nq + 4 * nk + 2 * stats + nb
    flops = 2 * D * B * H * Sq * Sq
    saved = _build._lib
    for name, handle in handles.items():
        _build._lib = handle
        try:
            dbias, again = torch.empty_like(bias), torch.empty_like(bias)
            dq = fa.flash_bwd_dq(*bwd, dbias)
            dk, dv = fa.flash_bwd_dkv(*bwd)
            torch.cuda.synchronize()
            same = torch.equal(dq, fa.flash_bwd_dq(*bwd, again)) and torch.equal(dbias, again)
            same = same and all(torch.equal(x, y) for x, y in zip((dk, dv), fa.flash_bwd_dkv(*bwd)))
            dq_ms = cs.time_ms(lambda: fa.flash_bwd_dq(*bwd, again), 20)
            dkv_ms = cs.time_ms(lambda: fa.flash_bwd_dkv(*bwd), 20)
            rec = dict(phase="bias case", variant=name, case=case, dq_err=err(dq, dq_ref),
                       dbias_err=err(dbias, dbias_ref), dkv_err=max(err(dk, dk_ref), err(dv, dv_ref)),
                       repeats=same, dq_ms=dq_ms, dkv_ms=dkv_ms,
                       dq_bound_ms=cs.bound(dq_bytes, 3 * flops, dtype)[0],
                       dkv_bound_ms=cs.bound(dkv_bytes, 4 * flops, dtype)[0],
                       dq_gb_per_s=dq_bytes / dq_ms / 1e6, dkv_gb_per_s=dkv_bytes / dkv_ms / 1e6,
                       hbm_gb_per_s=cs.HBM_BYTES_PER_S / 1e9)
            del dbias, again, dq, dk, dv
        finally:
            _build._lib = saved
        rec["ok"] = max(rec["dq_err"], rec["dbias_err"], rec["dkv_err"]) <= 1e-2 and rec["repeats"]
        log(rec)
    del q, k, v, do, bias, bwd, dq_ref, dk_ref, dv_ref, dbias_ref
    torch.cuda.empty_cache()


def collapsed_case(torch, cs, fa, _build, handles, case):
    """Each variant's collapsed dq (and dk/dv with the same bias) at one EVO_SHAPES case whose bias the
    programs share, against the plain versions, with its plan and its time beside the bound."""
    from deepspeed_tpu_torch.ops import evoformer as evo

    dev, dtype = torch.device("cuda", 0), torch.bfloat16
    q5, k5, v5, do5, biases = cs.evo_inputs(torch, dev, dtype, case)
    lead, (Sq, H, D) = q5.shape[:-3], q5.shape[-3:]
    B = q5.numel() // (Sq * H * D)
    q, k, v, do = (t.reshape(B, Sq, H, D) for t in (q5, k5, v5, do5))
    bias, meta = fa.flat_bias(*evo.fold_biases(biases, lead), B, H, Sq, Sq)
    del biases, q5, k5, v5, do5
    args = (None, D**-0.5, False, 0, bias, meta)
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, *args)
    bwd = (q, k, v, do, lse_ref, fa.flash_delta(o_ref, do), *args)
    del o_ref
    dq_ref, dbias_ref = fa.flash_bwd_dq_collapsed_ref(*bwd)
    err = lambda a, b: cs.evo_err(torch, a, b)["max_rel_err"]
    nq, nk, nb, stats = q.numel() * 2, k.numel() * 2, bias.numel() * 4, B * H * Sq * 4
    dq_bytes = 3 * nq + 2 * nk + 2 * stats + 2 * nb
    flops = 2 * D * B * H * Sq * Sq
    saved = _build._lib
    for name, handle in handles.items():
        _build._lib = handle
        try:
            dq, dbias = fa.flash_bwd_dq_collapsed(*bwd)
            again = fa.flash_bwd_dq_collapsed(*bwd)
            torch.cuda.synchronize()
            rec = dict(phase="collapsed case", variant=name, case=case, meta=meta,
                       parts=handle.ds_flash_dq_collapsed_parts(B, Sq, H, *meta[:3], 1), dq_err=err(dq, dq_ref),
                       dbias_err=err(dbias, dbias_ref),
                       repeats=torch.equal(dq, again[0]) and torch.equal(dbias, again[1]),
                       dq_ms=cs.time_ms(lambda: fa.flash_bwd_dq_collapsed(*bwd), 20),
                       dkv_ms=cs.time_ms(lambda: fa.flash_bwd_dkv(*bwd), 20),
                       dq_bound_ms=cs.bound(dq_bytes, 3 * flops, dtype)[0])
            del dq, dbias, again
        finally:
            _build._lib = saved
        rec["ok"] = max(rec["dq_err"], rec["dbias_err"]) <= 1e-2 and rec["repeats"]
        log(rec)
    del q, k, v, do, bias, bwd, dq_ref, dbias_ref
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
