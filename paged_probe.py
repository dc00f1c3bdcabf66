#!/usr/bin/env python3
"""How the bf16 paged kernels' split plans set their time on one NVIDIA GPU (cold device time).

    python3 paged_probe.py      # from the repository root, on a machine with one CUDA GPU

Two sweeps, each case printed as one JSON line; every time is the device time
from a CUDA graph rotating over copies of the pools of over 100 MB
(``chip_smoke.cold_ms``), so that each launch reads them from device memory:
1. ``decode sweep``: decode at chip_smoke.py's B = 8 and B = 64 contexts
   (llama3_8b's heads on bf16 and int8 pools, gpt2_1_3b's on int8 pools)
   under ``_decode_plan`` with every pair of ``DECODE_BLOCKS_PER_SM`` and
   ``DECODE_MIN_SPLIT_KEYS`` of the grid below, beside the plan's defaults
   and SDPA on the dense K/V;
2. ``prefill sweep``: prefill at 2 x 16 and 2 x 256 queries (row 1
   continuing a context of 1,000, 512 at gpt2_1_3b's) with the split count
   forced to each value below, beside ``_prefill_plan``'s choice.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BLOCKS_PER_SM = [4, 8, 16, 32, 64]
MIN_KEYS = [128, 256, 512]
PREFILL_SPLITS = [1, 2, 4, 8, 17, 32]


def log(obj):
    print(json.dumps(obj), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("paged_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from deepspeed_tpu_torch.device import sm_count
    from deepspeed_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda", 0)
    iters = 40
    log(dict(card=cs.card_line()))
    defaults = (pa.DECODE_BLOCKS_PER_SM, pa.DECODE_MIN_SPLIT_KEYS)
    for name, geom, int8 in (("llama3_8b", cs.GEOM, False), ("llama3_8b", cs.GEOM, True),
                             ("gpt2_1_3b", cs.GPT2_GEOM, True)):
        H, KVH, D, bs, P = (geom[k] for k in ("H", "KVH", "D", "bs", "P"))
        for B in (8, 64):
            base = [1, 127, 128, 129, 4096, 513, 2000, 8192]
            ctx = [min(base[i % len(base)], P * bs) for i in range(B)]
            ctx[-1] = 1
            kd, vd, bt, cl, g = cs.paged_case(torch, dev, torch.bfloat16, ctx, H, KVH, D, bs, P, seed=B,
                                              garbage_rows=(B - 1,))
            kp, vp = cs.int8_pools(kd, vd) if int8 else (kd, vd)
            q = torch.randn((B, H, D), generator=g, device=dev).to(torch.bfloat16)
            fn = lambda kk, vv: pa.paged_attention_decode(q, kk, vv, bt, cl)
            times = {}
            for bps in BLOCKS_PER_SM:
                for keys in MIN_KEYS:
                    pa.DECODE_BLOCKS_PER_SM, pa.DECODE_MIN_SPLIT_KEYS = bps, keys
                    plan = pa._decode_plan(B, KVH, P, bs, sm_count(dev))
                    if plan not in times:
                        times[plan] = cs.cold_ms(torch, fn, (kp, vp), iters)
                    log(dict(sweep="decode", model=name, pool="int8" if int8 else "bf16", B=B, blocks_per_sm=bps,
                             min_split_keys=keys, plan=plan, cold_ms=times[plan]))
            pa.DECODE_BLOCKS_PER_SM, pa.DECODE_MIN_SPLIT_KEYS = defaults
            k, v, L = cs.dense_kv(torch, kd, vd, bt, cl)
            mask = (torch.arange(L, device=dev)[None, :] < cl[:, None])[:, None, None, :]
            sdpa = lambda kk, vv: torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], kk, vv, attn_mask=mask, scale=D**-0.5, enable_gqa=True)
            log(dict(sweep="decode", model=name, pool="int8" if int8 else "bf16", B=B,
                     plan=pa._decode_plan(B, KVH, P, bs, sm_count(dev)), default=True,
                     cold_ms=times[pa._decode_plan(B, KVH, P, bs, sm_count(dev))],
                     sdpa_cold_ms=cs.cold_ms(torch, sdpa, (k, v), iters)))
            del k, v, kd, vd, kp, vp
            torch.cuda.empty_cache()
    plan_fn = pa._prefill_plan
    for name, geom, int8 in (("llama3_8b", cs.GEOM, False), ("gpt2_1_3b", cs.GPT2_GEOM, True)):
        H, KVH, D, bs, P = (geom[k] for k in ("H", "KVH", "D", "bs", "P"))
        for S in (16, 256):
            q0 = [0, min(1000, P * bs - 512)]
            ctx = [p + S for p in q0]
            kd, vd, bt, cl, g = cs.paged_case(torch, dev, torch.bfloat16, ctx, H, KVH, D, bs, P, seed=S)
            kp, vp = cs.int8_pools(kd, vd) if int8 else (kd, vd)
            q = torch.randn((2, S, H, D), generator=g, device=dev).to(torch.bfloat16)
            pos = (torch.tensor(q0, dtype=torch.int32)[:, None] + torch.arange(S, dtype=torch.int32)[None]).to(dev)
            fn = lambda kk, vv: pa.paged_attention_prefill(q, kk, vv, bt, cl, pos)
            chosen = plan_fn(2, S, H, KVH, P, bs, sm_count(dev))
            for splits in PREFILL_SPLITS:
                pa._prefill_plan = lambda *a, s=splits: s
                log(dict(sweep="prefill", model=name, pool="int8" if int8 else "bf16", S=S, splits=splits,
                         plan=chosen, cold_ms=cs.cold_ms(torch, fn, (kp, vp), iters)))
            pa._prefill_plan = plan_fn
            del kd, vd, kp, vp
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
