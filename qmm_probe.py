#!/usr/bin/env python3
"""Where `quantized_matmul`'s bf16 time goes on one NVIDIA GPU (device time from CUDA graphs).

    python3 qmm_probe.py      # from the repository root, on a machine with one CUDA GPU

Three measurements, each printed as one JSON line:
1. ``split sweep``: at M = 8 and 64, gpt2_1_3b's int8 and llama3_8b's packed
   int4 serving shapes, the cold device time (rotating over copies of the
   codes of over 100 MB) of the kernel under every split count of K the
   kernel takes, beside the plan's choice;
2. ``split tail``: the same at the plan's choice, against a copy of the
   kernel without the split-K tail (no fence, counter or last slice's
   reduce: wrong results, timing only) and against ``torch.matmul`` on the
   weight dequantised beforehand;
3. ``wgmma breakdown`` at M = 1024: the kernel against copies without the
   group drains, without the code conversion, without the loads and
   without the products (wrong results, timing only).

The copies are built from ``deepspeed_tpu_torch/csrc/quantized_matmul.cu``
by substituting source lines, with nvcc, into ``build/qmm_probe/``.
"""

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "deepspeed_tpu_torch", "csrc", "quantized_matmul.cu")
OUT = os.path.join(HERE, "build", "qmm_probe")
SHAPES = [(8, 2048, 2048), (8, 2048, 8192), (8, 8192, 2048), (4, 4096, 14336), (4, 14336, 4096)]

# variant name -> (source text, replacement); each must occur in the source
DRAIN = """            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(part);
            flush();"""
VARIANTS = {
    "notail": [("  if (split) split_finish<BMq, BNq, NTH>(ws, counters, out, M, N, m0, n0, vec, &is_last);\n}\n\n"
                "// The 128 x 128 tile", "}\n\n// The 128 x 128 tile")],
    "nodrain": [(DRAIN, "            fence_regs(part);\n            flush();")],
    "noconv": [("    convert(c, af);  // af's last products (chunk c - 2) are done", "    ;")],
    "noload": [("    if (c + S - 2 < nchunks) load((c + S - 2) % S, c + S - 2);", "    ;"),
               ("    if (s < nchunks) load(s, s);\n    cp_async_commit();\n  }\n  for (int c = 0; c < nchunks; c += 2)",
                "    cp_async_commit();\n  }\n  for (int c = 0; c < nchunks; c += 2)")],
    "nowgmma": [("    issue(c, af);\n", "    ;\n")],
}


def log(obj):
    print(json.dumps(obj), flush=True)


def build_variants(nvcc, signature):
    src = open(SRC).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"qmm_probe: variant {name}: source line not found: {old[:60]!r}")
            text = text.replace(old, new)
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-shared", "-I", os.path.dirname(SRC), "-o", os.path.join(OUT, f"lib{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"qmm_probe: nvcc failed for {name}:\n{out[-3000:]}")
        lib = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
        lib.ds_quantized_matmul.argtypes = signature
        lib.ds_quantized_matmul.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("qmm_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from deepspeed_tpu_torch.ops import _build, quantized_matmul as qm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    log(dict(card=card))
    _build.lib()
    libs = build_variants(_build._nvcc(), _build.SIGNATURES["ds_quantized_matmul"])
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def graph_ms(calls, reps=3):
        for c in calls[:2]:
            c()
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            calls[0]()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for c in calls:
                c()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps / len(calls)

    def with_lib(lib, fn):
        saved = _build.lib()
        _build._lib = lib
        try:
            return fn()
        finally:
            _build._lib = saved

    plan = qm._qmm_plan
    for bits, K, N in SHAPES:
        g = torch.Generator(device=dev).manual_seed(0)
        w = torch.randn((K, N), generator=g, device=dev) * 0.02
        q, sc = qm.quantize_weight_kgroups(w, 128, bits, pack=bits == 4)
        packed, ng = q.shape[0] != K, sc.shape[0]
        copies = [(q.clone(), sc.clone()) for _ in range(max(2, 100_000_000 // (q.numel() + sc.numel() * 4) + 1))]
        dense = [qm._dequantize_kgroups(q, sc, packed).to(torch.bfloat16)
                 for _ in range(max(2, 100_000_000 // (K * N * 2) + 1))]
        for M in (8, 64):
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            run = [lambda qq=qq, ss=ss: qm.quantized_matmul(x, qq, ss, packed=packed) for qq, ss in copies]
            cfg, splits, per = plan(M, K, N, ng, packed, sms)
            sweep = {}
            for s in range(1, min(16, ng) + 1):
                p = -(-ng // s)
                n = -(-ng // p)
                if n in sweep:
                    continue
                qm._qmm_plan = lambda *a, cfg=cfg, n=n, p=p: (cfg, n, p)
                try:
                    sweep[n] = graph_ms(run)
                finally:
                    qm._qmm_plan = plan
            log(dict(phase="split sweep", bits=bits, K=K, N=N, M=M, plan=[cfg, splits, per],
                     ms_by_splits={str(k): v for k, v in sweep.items()}))
            log(dict(phase="split tail", bits=bits, K=K, N=N, M=M, plan=[cfg, splits, per], kernel_ms=graph_ms(run),
                     without_tail_ms=with_lib(libs["notail"], lambda: graph_ms(run)),
                     library_ms=graph_ms([lambda d=d: torch.matmul(x, d) for d in dense])))
        x = torch.randn((1024, K), generator=g, device=dev).to(torch.bfloat16)
        run = [lambda: qm.quantized_matmul(x, q, sc, packed=packed)] * 10
        rec = dict(phase="wgmma breakdown", bits=bits, K=K, N=N, M=1024, kernel_ms=graph_ms(run))
        for name in ("nodrain", "noconv", "noload", "nowgmma"):
            rec[f"{name}_ms"] = with_lib(libs[name], lambda: graph_ms(run))
        rec["library_ms"] = graph_ms([lambda: torch.matmul(x, dense[0])] * 10)
        log(rec)
        del copies, dense
    return 0


if __name__ == "__main__":
    sys.exit(main())
