#!/usr/bin/env python3
"""Drive the PyTorch port (deepspeed_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py            # from the repository root, on a machine with one CUDA GPU
    python3 chip_smoke.py --profile  # plus torch.profiler breakdowns of the serving runs, a training step, v1,
                                     # an evoformer call and a train_hf step of each model
    python3 chip_smoke.py --quick    # the build and one case of each kernel phase
    python3 chip_smoke.py --parent DIR  # plus DIR's norm, quantized_matmul, bf16 flash, paged, sparse and
                                        # Adam kernels beside this tree's
    python3 chip_smoke.py --only train_moe,train_zeropp  # the build and the named phases alone (also serve_tp,
                                                         # train_pipe, train_seq, train_tp, hf_kernels, serve_hf,
                                                         # train_kernels, sla, flash_wide, train_hf)

Phases, each fatal on failure:
1. card: the ``nvidia-smi`` name and power-limit line;
2. build: nvcc builds every CUDA kernel of the serving, training, evoformer, sparse-attention,
   quantisation and LAMB paths from csrc/;
3. kernels: each kernel's wrapper at the llama3_8b shapes of the fused serving
   path, in bf16 and fp32, against its plain PyTorch version (errors,
   tolerance, kernel/plain/library times from CUDA events, and the bound:
   the larger of bytes over 3.35 TB/s and operations over the peak rate of
   the input type, 989 TFLOP/s bf16 / 67 TFLOP/s fp32); then the kernels of
   quantised serving the same way: ``layer_norm`` at gpt2_1_3b's width
   (both norms at T 8, 768 and 2048, and at T 2048 with the weight in the
   other float type, also cold, beside ``F.rms_norm`` and ``F.layer_norm``:
   device time from a CUDA graph rotating over copies of x),
   ``quantized_matmul`` with int8 codes over gpt2_1_3b's three weight shapes
   and with packed int4 over llama3_8b's two MLP shapes at 8, 64, 512 and
   1024 tokens (at 8 and 64 also cold, in device time from a CUDA graph:
   rotating over copies of the codes, and of the library's dense weight,
   of over 100 MB, twice the L2), and
   paged decode and prefill on int8 pools at both models' heads and on bf16
   pools at gpt2_1_3b's; decode at B 64 and prefill at 2 x 512 of each pool
   and geometry also with ALiBi (``alibi_slopes(32)``) and with a window
   (4,096, 512 at gpt2_1_3b's context of 1,024; the prefill's second row
   then starts at 7,680 so that it cuts); decode at B 8 and prefill at
   2 x 16 also cold, in device time from a CUDA graph rotating over copies of
   the pools, and of SDPA's dense K/V, of over 100 MB; and prefill at the
   shape of a speculative verify step (``phase_verify``: 64 rows of 5 and of
   2 queries, each window ending a context of 130-8,192 keys) on bf16 and
   int8 pools, beside SDPA with a boolean mask; and (run after the LAMB kernel) the
   MoE grouped GEMM (``moe_grouped_gemm``, expert offsets read on the device)
   at Mixtral-8x7B's expert shapes (wi 4096 -> 14336, wo 14336 -> 4096) for
   the mixtral_8x7b_8l serve's own steps (a decode step at its bucket of 8:
   16 rows; a 2,048-token prefill quantum: 4,096 rows), a 64-token decode
   step (128 rows) and a 768-token quantum (1,536 rows) of seeded top-2
   routings, with an empty expert and with every row on one expert, each
   repeating bit for bit, beside ``torch._grouped_mm`` and a per-expert
   ``torch.matmul`` loop; then each bf16 tile body (32 and 64 rows) at the
   serve's steps of 16-4,096 rows, held to the plain version and timed in 5
   turns;
4. step parity: one prefill quantum and one mixed decode + prefill quantum
   of llama3_8b at full width and 4 layers, run with the kernels and with
   their plain versions; logits and KV pools (garbage block 0 excluded)
   agree; then the same two quanta of gpt2_1_3b at full width and 4 layers
   with int8 weights and int8 KV pools (pools compared dequantised), and of
   Mixtral-8x7B at full width and 2 layers (every block MoE: the grouped
   GEMM against its plain version);
5. serve: InferenceEngineV2 over llama3_8b at full width and depth (random
   bf16 weights from seed 0), greedy generate of 32 tokens for a dozen
   seeded prompts of 16-1500 tokens in two waves (the second wave shares a
   256-token prefix with the first, so the prefix cache is hit). The kernel
   launch counters are zeroed just before and read just after; every kernel
   must have launched. Each step replays its bucket's captured CUDA graph:
   graph replays must equal the steps and the fused quanta, and the captures,
   their host seconds and the evictions are printed; the launch counters
   count each replay as its capture's launches. The waves are then served in
   turns with each step eager (the parent's dispatch) and on graphs
   (eager, graphs, graphs, eager), every run's tokens equal to the first's;
   again on an engine built with ``DS_TPU_PROGRAM_CACHE=16`` (the waves take
   11 graphs; at the default 8 they are captured again and again); then
   through the unfused loop (``fused_step=False``: a prefill step per chunk
   bucket, a decode step, bursts), on graphs and again with eager steps,
   whose tokens must be equal; its agreement with the fused loop's tokens is
   printed (in bf16 the two loops' products have other row counts and round
   otherwise; the card tests hold the two loops to the CPU in fp32); then
   ``serve_spec`` (speculative decoding, on the first serve run's weights):
   the JAX bench's workload (32 prompts, each a seeded 16-token motif
   repeated 8 times, 128 new tokens, K 4), spec off and on with bursts off,
   spec on with an oracle drafter (spec off's tokens, while a row still
   agrees with them), spec off at burst 32, all at
   ``DS_TPU_PROGRAM_CACHE=32``, then spec on at the default cache; each a
   warm-up generate (the graphs captured; in the spec-on run the first
   verify replays held to the eager verify step on the same inputs) and a
   timed one with tokens/s, decode steps, proposed and accepted drafts,
   tokens a decode step, captures and evictions, its token agreement with
   spec off and the KV pool's free blocks before and after; then
   ``spec_fp32``: a 2-layer llama3_8b-wide engine in fp32 whose spec-on
   tokens (prompt lookup and the oracle) must equal spec off's in the fused
   and the unfused loop; then ``telemetry`` (on the first serve run's
   weights, warm graphs at ``DS_TPU_PROGRAM_CACHE=16``, the counters zeroed
   before its accounted pass and read after): the perf accountant's useful
   tokens must equal the decode steps' tokens plus the prefill tokens
   scheduled, with one cost card a graph key and every step attributed
   (``infer_mfu``, the pass's MFU and the ledger printed); the device
   profiler's ``profile_device_busy_fraction`` over one pass (a
   ``torch.profiler`` capture cut by its in-trace quantum markers) must lie
   within 3 points of ``profiled()``'s busy share of the same session; the
   ops plane on 127.0.0.1 must answer ``/metrics``, ``/healthz``, ``/perf``
   and ``/profile`` with the reference's keys; a manual flight capture must
   write the reference's manifest sections; then tokens/s with telemetry and
   accounting on and off in turns (on, off, off, on); then ``sla``: ``sla.run_load`` with 24 requests a
   row (a shared 256-token prefix and 16-1500 more tokens, 32 new tokens,
   greedy), every
   arrival at t = 0 and then Poisson rows at 1/4, 1/2 and 3/4 of that row's
   requests/s, each with tokens/s, TTFT and TPOT percentiles and its SLA
   misses, and ``effective_throughput_at_sla`` at the FastGen SLA (TTFT 1 s,
   TPOT 250 ms). Then ``serve_spill``: the host spill tier on llama3_8b at full width and depth (bf16,
   random weights from seed 0): wave A (16 requests on 4 shared 1,024-token prefixes, each with a 64-token
   suffix of its own), wave B (16 unrelated 1,024-token prompts that need the pool), wave A again, 32 new
   tokens each, on an engine whose pool wave B fills (140 blocks, ``kv_spill`` on: A's cached prefixes
   spill to pinned host slabs and the third pass re-admits them), on the same pool with the tier off (the
   third pass prefills them again) and on a pool that keeps them (400 blocks); every re-admitted block's
   pages must equal, byte for byte, its pages before the spill; the third pass must prefill only the
   suffixes, re-admit every block of the four chains and give the big pool's tokens; a forced evict and a
   fourth pass must take no new graph capture; printed: blocks and bytes spilled and re-admitted, the
   spill path's d2h and the re-admissions' h2d GB/s beside a plain pinned ``copy_`` of the same bytes, each
   pass's wall time and tokens/s (the warm fourth pass with the chains re-admitted, prefilled again and in
   HBM), and the warm wave A with telemetry on and off in turns. Then
   ``journal``: the third pass of the spill engine was recorded with ``DS_TPU_JOURNAL=1`` into a
   temporary directory; ``read_journal`` reads it back and ``replay_oracle`` replays it on a fresh engine
   rebuilt from the journal over the same weights (after serving the same first two waves unrecorded):
   it must be ok with every request's digest equal; one ``sla.run_load`` row (8 requests, every arrival
   at t = 0) recorded on a fresh engine replays ok on another; ``determinism_audit`` of wave A on two
   fresh engines must be clean. Then ``serve_spill_kv8``: the same spill traffic on gpt2_1_3b at full
   size with int8 weights and int8 KV pages (768-token prefixes; 104 and 320 blocks), the spilled blocks
   kept quantised (four pool leaves). Then ALiBi and sliding-window serving as ``serve`` does
   it (eager and graph tokens equal): a BLOOM-7b1-shaped config and a
   Mistral-7B-v0.1-shaped one (window 4,096, prompts up to 6,000 tokens),
   each at full width and 4 layers. Then MoE serving: a Mixtral-8x7B-v0.1-
   shaped config at full width and 8 layers (8 experts, top-2; 17
   ``rms_norm`` and 24 ``moe_grouped_gemm`` launches per forward), the serve
   run's waves on graphs and eager with equal tokens, and the rows each
   expert takes of real tokens (the bucket's padding apart) in every layer
   of a prefill and a decode step. Then the quantised main paths the same
   way, each with its counters zeroed before and read after: gpt2_1_3b at full width
   and depth with ``quant_bits=8`` and ``kv_quant_bits=8`` (prompts of 16-960
   tokens, max_context 1024), and llama3_8b at full width and depth with
   ``quant_bits=4`` (packed int4) on a bf16 pool; the launch counts must fit
   the models' structure (gpt2_1_3b: 49 ``layer_norm`` and 144
   ``quantized_matmul`` launches per forward; llama3_8b: 65 ``rms_norm`` and
   225 ``quantized_matmul``), and the weights' and one KV block's bytes are
   printed beside their bf16 sizes.
6. training kernels: flash attention forward, dq and dk/dv (kernels A, B, C)
   at the gpt2_1_3b shape and at GQA, Sq < Sk, window and ALiBi shapes and
   bert-base's encoder (8 x 128, 12 heads of 64, no mask), and
   fused AdamW (kernel D) over the ``wte`` leaf and over all 388 leaves of
   gpt2_1_3b in one ``fused_adam_multi`` call (one launch), against their
   plain versions, each with its bound and a library yardstick (SDPA
   forward and backward; ``torch.optim.AdamW(fused=True)``: Adam, with
   ``--parent`` the parent's Adam, and the library three times each in
   turns, their medians, spreads and GB/s), timed here only;
7. train parity: gpt2_1_3b at full width and 2 layers, fp32 and bf16, one
   engine step with the kernels and one with their plain versions from the
   same weights and batch: loss, per-leaf gradients, parameters after it;
8. train: ``initialize`` + ``train_batch`` on gpt2_1_3b at full width and
   depth in bf16 (micro-batch 8 x 1024, FusedAdam, WarmupLR, clip 1.0) for
   12 steps on one seeded batch; losses finite and falling; tokens/s, step
   time, MFU and peak memory over steps 3-12 (the engine's ``train_mfu``
   gauge must lie within 2 % of the MFU of the last step's host interval,
   the one the gauge reads), with the launch counters
   zeroed before those steps and read after (A, B, C: 24 per step; D: one
   for each 512 leaves, so one). ``--profile`` adds a torch.profiler
   breakdown of one step.
9. evoformer kernels (run after phase 6): the flash kernels' additive-bias
   bodies (forward with a bias, dq writing dbias per program, the collapsed
   dq summing dbias over the programs that share a bias slice, dk/dv with a
   bias) at AlphaFold2's widths (``EVO_SHAPES``: MSA row and column
   attention, 8 heads of 32; triangle attention, 4 heads of 32; crops of
   256 x 128 and 384 x 512) in bf16 and fp32 against their plain versions,
   the collapsed dq's dq and dbias repeating bit for bit, with bounds and SDPA
   (float ``attn_mask``) as the yardstick;
10. evoformer: ``DS4Sci_EvoformerAttention`` forward and backward at those
   shapes, the counters zeroed before each call and read after (forward,
   dk/dv and the dq of each layout must launch), output and the gradients
   of q, k, v and every bias against the same call on the plain versions,
   ms per forward + backward and peak memory;
11. sparse kernels (run after phase 9): ``sparse_fwd``, ``sparse_bwd_dq`` and
   ``sparse_bwd_dkv`` (block-sparse attention over active-block lists) at
   every ``SPARSE_SHAPES`` case (fixed unidirectional layout at gpt2_1_3b's
   heads and S 8192; fixed per-head layouts at BERT-base width; BigBird at
   bigbird-roberta-base's; a causal Longformer layout at llama3_8b's GQA
   heads and D 128; a dense layout at the flash kernels' gpt2_1_3b shape) in
   bf16 and fp32 against their plain versions (at each case's check batch),
   with bounds from the layout's active pairs and SDPA with the boolean token
   mask as the yardstick, and each kernel (bf16: the forward and dq over the
   query plan, dk/dv over its plan) repeating bit for bit; the dense layout is
   also held to, and timed beside, the flash kernels;
12. sparse: ``SparseSelfAttention`` forward and backward at those cases in
   bf16, the counters zeroed before each call and read after (all three
   kernels must launch), output and gradients against the same call on the
   plain versions, ms per forward + backward and peak memory beside the
   plain path and SDPA with the token mask.
13. train_zero (last, after the LAMB training run): the ``train`` run at
   ZeRO stages 0, 1, 2 and 3 with FusedAdam and at stage 2 with LAMB, through
   ``comm.init_distributed`` (NCCL, world 1): step ms, tokens/s, peak
   memory, the engine's collectives a step (calls and bytes) and stage 3's
   gathered peak; every run's losses equal the ``train`` (or ``train
   lamb``) run's bit for bit, and the flash kernels and ``fused_adam`` (or
   ``lamb_direction``) launch as often as there;
14. ckpt: gpt2_1_3b widths at 2 layers, stage 2: 12 straight steps; 6 steps,
   a native checkpoint saved synchronously and on the background thread
   and a universal one (bytes, seconds); fresh engines resume the native
   one at stage 2 and the universal one at stage 3 and train 6 more steps,
   equal to the straight run's last 6 bit for bit; ``zero_to_fp32`` equals
   the saved masters.
15. host_optim: ZeRO-Offload's host C++ on the card machine's CPU: the C++
   Adam (``csrc/host/cpu_adam.cpp``) against its plain PyTorch version at
   ``wte`` and over gpt2_1_3b's leaves of 6 of its 24 layers
   (``HOST_OPTIM_LAYERS``) one by one (ms, GB/s, threads),
   and the AIO pool (``csrc/host/aio.cpp``) writing and reading 1 GiB under
   ``build/``;
16. train_offload: gpt2_1_3b at full width (and depth, unless the host's
   ``MemAvailable`` cannot hold its host state: the cut is printed) for 6
   steps each at stage 2 with ``offload_optimizer: cpu``, at stage 3 with
   ``offload_param`` and ``offload_optimizer`` on the cpu, and at stage 3
   with the model's remat: step ms split into the device's share and the
   offload's d2h, host step and h2d, bytes moved, device peak (below
   train_zero's at the same stage), host RSS; offload losses within
   ``OFFLOAD_LOSS_TOL`` of train_zero's, remat's equal to stage 3's bit for
   bit; the flash kernels launch as in train_zero (the remat forward
   twice), ``fused_adam`` never under optimizer offload;
17. offload_nvme: gpt2_1_3b widths at 2 layers, stage 3, both offloads on
   NVMe under ``build/`` (moments in swap files, masters in mapped files):
   losses equal the cpu offload run's bit for bit, and a native checkpoint
   resumes bit for bit. The host code's rows are printed as
   ``{"host_code": [...]}`` on a line of their own before the kernels line.
18. train_zeropp: gpt2_1_3b widths at 2 layers at stage 3, then with ZeRO++'s
   qwZ, qgZ and hpZ 2 (world 1 over NCCL): the engine logs the JAX
   package's fallback reason (an fsdp axis of 1), runs none of ZeRO++'s
   collectives and trains plain stage 3's losses bit for bit;
19. train_moe: Mixtral-8x7B's widths (``mixtral_cfg``) at 2 layers, every
   block MoE (capacity factor 1.25, tokens dropped), bf16, FusedAdam, one
   2,048-token sequence, ``mesh: {expert: 1}`` over NCCL: the first step's
   loss and attention gradients with the flash kernels and with their plain
   versions (on the kernel run's routing); 6 steps at stage 0 with the
   counters zeroed before and read after (flash forward, dq, dk/dv once a
   layer a step, ``fused_adam`` once a step), step ms, tokens/s, device
   peak, the last step's tokens an expert, dropped share and aux loss; the
   6 steps again at stage 3, equal bit for bit. The kernels line gives the
   flash and Adam rows their launches there (``train_moe_launches``).
20. serve_tp: tensor-parallel serving at tp = 2 as two processes on the one
   card, each ``comm.init_distributed(device="cuda", backend="gloo")`` with
   mesh ``{tensor: 2}`` (NCCL takes one GPU a rank; gloo stages each
   collective through the host, so nothing here measures NVLink, and the
   engines take eager steps: gloo cannot be captured in a CUDA graph).
   First, in this process, the serving kernels at a rank's shapes against
   their plain versions (``tp_kernel_records``: paged decode and prefill
   over 16 query and 4 KV heads, ``quantized_matmul`` over llama3_8b's five
   shard shapes, the grouped GEMM at Mixtral's halved expert hidden dim).
   Then each rank runs (e) ``tp_all_reduce`` on CUDA tensors, exact,
   interleaved and 8-bit (bit-equal across ranks, the interleaved equal to
   the exact, the 8-bit within the EQuARX bound); (b) llama3_8b at full
   width and 2 layers in fp32, the step parity's two quanta with the
   kernels and their plain versions on each rank's shard, and against tp =
   1 on the kernels (logits and each rank's heads of the pools,
   ``TP_PARITY``); (c) gpt2_1_3b W8 (quantised after sharding, bf16 KV) and
   (d) Mixtral-8x7B (the plain run pinned to the kernel run's routing) the
   same way at 2 layers; (a) llama3_8b at full width and 8 of its 32 layers
   (``TP_SERVE_LAYERS``), bf16: each rank draws the
   seed-0 tree leaf by leaf and keeps its slice, then serves the serve
   phase's two waves: tokens/s, steps, the kernels' launches, each rank's
   peak memory. Every failure of a rank is fatal. The kernels line gives the rows of the kernels on this path their
   launches there (``serve_tp_launches``).
21. train_pipe and train_seq: pipeline (pipe 2) and sequence (seq or context 2)
   parallelism as two processes on the one card (``phase_train_pipe``,
   ``phase_train_seq``; ``train_pipe_launches``, ``train_seq_launches``).
22. train_tp: tensor-parallel training, mesh ``{tensor: 2}``, two processes on
   the one card over gloo named for CUDA (four for (c)). (k) In this process
   the flash forward, dq and dk/dv at a rank's shapes (gpt2_1_3b's B 8, S
   1,024, 16 heads of 64; llama3_8b's 16 / 4 heads of 128 at S 2,048) in
   bf16 and fp32, and ``fused_adam_multi`` over tensor rank 0's gpt2_1_3b
   leaves, against their plain versions. (a) gpt2_1_3b widths (tied head,
   ``wte`` whole: 50,257 is odd) and llama3_8b widths (untied vocab-parallel
   head and cross-entropy) at 2 layers in fp32, 2 steps with FusedAdam and
   with LAMB, against the one-process engine on the same weights and rows:
   losses and grad norm within 1e-5, the masters by 4 seeded +-1
   projections a leaf (``PAR_TOL``), every leaf both ranks hold whole
   bit-equal. (b) gpt2_1_3b at full width and depth in bf16 with FusedAdam
   on train's micro-batch of 8 x 1,024 on both ranks: step ms,
   tokens/s, each rank's peak, the TP collectives' calls, MB and host ms a
   step, the kernels' launches (24 a rank a step each flash kernel, one
   Adam), losses within 1 % of ``train``'s (3 steps, ``TP_STEPS``: the
   whole script's time limit). (c) pipe 2 x tensor 2 as four
   processes, gpt2_1_3b widths at 4 layers in fp32, 2 steps of 1F1B,
   against one process. The kernels line gives the flash and Adam rows
   rank 0's launches over (b)'s timed steps and the LAMB row its launches
   in (a)'s llama3_8b LAMB run (``train_tp_launches``).
23. hf kernels (run after the llama3_8b kernel phases): paged decode (B 64,
   cold at B 8) and prefill (2 x 512, cold at 2 x 16) on bf16 and int8 pools,
   with ALiBi and a window at B 64 / 2 x 512, at the heads of phi-2 (32 / 32 of
   80), phi-3-mini (32 / 32 of 96), Gemma-2B (8 / 1 of 256), Gemma-7B (16 / 16
   of 256) and falcon-7b (71 / 1 of 64) (``HF_GEOMS``), bf16 q, against their
   plain versions; then ``layer_norm`` at phi-2's d 2,560 and falcon-7b's
   4,544 and ``rms_norm`` at gemma-2b's 2,048 with its (1 + w) weight in fp32
   (``HF_NORMS``), 8 and 768 rows, bf16 and fp32; the ``hf_kernel_shapes``
   line before the kernels line lists them.
24. serve_hf (after the quantised serves): Hugging Face directories written
   under ``build/hf_checkpoints/`` with the published config.json of
   microsoft/phi-2, google/gemma-2b, tiiuae/falcon-7b (at 4 of its 32 layers)
   and bert-base-uncased, random bf16 weights from a seed, each deleted after
   its run. phi_2 and gemma_2b (full depth) and falcon_7b_4l load through
   ``load_hf_checkpoint`` (read, to the device and convert seconds) and serve
   the serve phase's two waves on graphs (then eager and graphs again: phi_2
   and gemma_2b, at a program cache of 16) with the paged kernels and the
   norm counted; phi_2 also through ``init_inference(<directory>)`` (the v1
   engine). Each at 2 layers in fp32 (``HF_PARITY_LAYERS``): the card's v2
   engine against the CPU route on the same directory, a prefill and a decode
   step within 1e-4 relative, and bf16 greedy tokens beside the fp32 CPU
   route's. bert_base through ``init_inference(<directory>)``: a bf16 forward
   of 8 x 128 tokens (12 flash launches), then 2 layers in fp32 against the
   CPU route, token types included. The kernels line gives the paged, norm
   and flash rows their launches there (``serve_hf_launches``). phi_2's and
   gemma_2b's directories are kept for train_hf.
25. flash_wide (after the training kernels): the flash forward, dq and dk/dv
   at the Hugging Face families' head dims (``WIDE_FLASH_CASES``: phi-2
   32/32 x 80, phi-3-mini 32/32 x 96, Gemma-2B 8/1 x 256, gpt-j 16/16 x 256
   at B 4 x S 2,048, causal; phi-2 with a window of 512, phi-3-mini with
   ALiBi) in bf16 and fp32 against their plain versions, with bounds and
   SDPA's forward and backward beside them.
26. train_hf (after serve_hf): phi_2 and gemma_2b fine-tuned at full width
   and depth from serve_hf's directories through ``load_hf_checkpoint`` and
   ``initialize`` (bf16, fp32 masters, FusedAdam, 2 x 2,048 tokens, remat;
   ``HF_TRAIN``): step ms, tokens/s, MFU, peak memory, losses finite and
   falling, the flash kernels at D 80 and D 256 and Adam launching as the
   model's structure says; each at 2 layers in fp32, one step on the card
   against the CPU route (loss, every leaf's gradient, the grad norm, the
   masters; ``HF_TRAIN_PARITY``); then a ``scan_layers`` step (phi-2's
   widths at 2 layers, the stacked tree against the unrolled one). The
   kernels line gives the wide flash rows their launches there.

With ``--parent DIR`` (another checkout's sources, e.g. ``git archive`` of
the parent commit unpacked under ``build/``), DIR's kernels are built from
DIR and stand in for this tree's norms, ``quantized_matmul``, flash forward, dq
(per program and collapsed) and dk/dv, paged decode and prefill, the
sparse forward, dq and dk/dv and fused Adam while each of their cases is
timed again (``parent_ms``, the bias cases of dq and dk/dv included; the ALiBi and
window cases of the paged kernels are not in the parent's), the three
serving runs and the training run are repeated on them, and each
``DS4Sci_EvoformerAttention`` and ``SparseSelfAttention`` call is timed on
them too.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a GPU, or without the package
beside this script, it exits non-zero and prints no result.
"""

import contextlib
import gc
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
# kernel vs plain version: fp32 on the max abs error; bf16 on the per-row
# relative error (max |got - want| / max |want| over each row's last dim),
# since the outputs of long-context attention rows are ~0.03 in size and one
# bf16 rounding step is 2**-7 of a value at most
TOL = {"torch.float32": ("max_abs_err", 1e-5), "torch.bfloat16": ("max_rel_err", 1e-2)}
# llama3_8b serving geometry: heads, KV heads, head dim, KV block size,
# block-table width (max_context 8192 / 128) and model width
GEOM = dict(H=32, KVH=8, D=128, bs=128, P=64, d=4096)
# gpt2_1_3b serving geometry: MHA, head dim 64, max_context 1024 / 128
GPT2_GEOM = dict(H=32, KVH=32, D=64, bs=128, P=8, d=2048)


def model_cfg(**kw):
    """llama3_8b with fields replaced (the presets fix n_layers)."""
    import dataclasses

    from deepspeed_tpu_torch.models import llama3_8b

    return dataclasses.replace(llama3_8b(), **kw)


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_ms_rotating(fn, operands, iters: int) -> float:
    """Device time per launch of ``fn``, launch i taking ``operands[i %
    len(operands)]``: copies whose bytes together exceed the 50 MB L2 make
    every launch read its operands from device memory, as a serving step
    finds them. The launches are captured once in a CUDA graph and the graph
    is replayed, so that the host's launch cost (larger than a decode-sized
    product's device time, for the kernels' wrappers and for cuBLAS alike)
    drops out: mean of 3 replays."""
    import torch

    n = max(iters, len(operands))
    for i in range(min(3, len(operands))):
        fn(*operands[i])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on a side stream, as capture wants
        fn(*operands[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*operands[i % len(operands)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (3 * n)
    del graph
    return ms


# --parent DIR: the kernels of another checkout (e.g. ``git archive`` of the parent commit, unpacked
# under build/), built from DIR's own sources, stand in for this tree's quantized_matmul, flash
# forward, dq and dk/dv, paged decode and prefill and the sparse kernels while a phase times them or runs
# a path with them ("parent" numbers, from the same run)
PARENT = {"lib": None}


class OldPagedEntry:
    """A paged decode or prefill entry point whose C interface predates the ALiBi slopes, the workspace,
    the window and the split plan, called with this tree's arguments (the slopes null and the window 0:
    the old kernels took neither; the workspace and the plan are dropped)."""

    OLD_ARGS = {"ds_paged_attention_decode": 17, "ds_paged_attention_prefill": 19}

    def __init__(self, name, fn):
        self.name, self.fn = name, fn

    def __call__(self, *args):
        if self.name == "ds_paged_attention_decode":
            q, kp, vp, ks, vs, bt, ctx, slopes, out, _ws, B, H, KVH, D, bs, P, window, _n, _keys, *rest = args
            head, dims = (q, kp, vp, ks, vs, bt, ctx), (B, H, KVH, D, bs, P)
        else:
            q, kp, vp, ks, vs, bt, ctx, qpos0, slopes, out, _ws, B, S, H, KVH, D, bs, P, window, _n, *rest = args
            head, dims = (q, kp, vp, ks, vs, bt, ctx, qpos0), (B, S, H, KVH, D, bs, P)
        if slopes is not None or window:
            raise NotImplementedError(f"{self.name}: the parent's kernel takes no ALiBi or window")
        return self.fn(*head, out, *dims, *rest)


class OldSparseEntry:
    """A sparse entry point whose C interface predates the plans, called with this tree's arguments: it walks
    the lists itself (the plan, the dk/dv's workspace and their counts are dropped)."""

    OLD_ARGS = {"ds_sparse_fwd": 16, "ds_sparse_bwd_dq": 18, "ds_sparse_bwd_dkv": 19}

    def __init__(self, name, fn):
        self.name, self.fn = name, fn

    def __call__(self, *args):
        if self.name == "ds_sparse_fwd":
            q, k, v, kidx, _plan, o, lse, B, S, H, D, blk, A, _n_items, _max_entries, _rows, *rest = args
            return self.fn(q, k, v, kidx, o, lse, B, S, H, D, blk, A, *rest)
        if self.name == "ds_sparse_bwd_dq":
            q, k, v, dout, lse, delta, kidx, _plan, dq, B, S, H, D, blk, A, _n_items, _max_entries, _rows, *rest = args
            return self.fn(q, k, v, dout, lse, delta, kidx, dq, B, S, H, D, blk, A, *rest)
        (q, k, v, dout, lse, delta, qidx, _plan, _ws, dk, dv, B, S, H, D, blk, Aq, _n_items, _n_reduce, _n_slots,
         _max_entries, _rows, *rest) = args
        return self.fn(q, k, v, dout, lse, delta, qidx, dk, dv, B, S, H, D, blk, Aq, *rest)


class OldAdamEntry:
    """The multi-leaf Adam entry point on a build that has only the one-leaf ``ds_fused_adam``: one launch of
    it for each leaf of the table, as that build's ``FusedAdam`` made them (the wrapper's launch count then
    counts calls, not launches)."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, ptrs, sizes, leaves, scal, *rest):
        for i in range(leaves):
            rc = self.fn(*ptrs[4 * i:4 * i + 4], sizes[i], scal, *rest)
            if rc:
                return rc
        return 0


class OldGemmEntry:
    """A grouped-GEMM entry point whose C interface predates the launch plan (tile rows chosen by the caller,
    no split of K, no workspace), called with this tree's arguments: the plan is dropped and the tile rows are
    those that build's wrapper chose (32 while an expert averages at most 16 rows, else 64; fp32 64)."""

    OLD_ARGS = 11

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, x, w, offsets, out, _ws, _counters, R, K, N, E, _rows, _split, _steps, _below, dtype, stream):
        bm = 64 if dtype == 0 or R > 16 * E else 32
        return self.fn(x, w, offsets, out, R, K, N, E, bm, dtype, stream)


class ParentKernels:
    """This tree's kernel library with the entry points in ``STAND_IN``
    taken from another build (the paged ones through ``OldPagedEntry``, the
    sparse ones through ``OldSparseEntry`` where that build has the old C
    interface, Adam's through ``OldAdamEntry`` where it has only the one-leaf
    entry point, the grouped GEMM's through ``OldGemmEntry`` where it has no
    launch plan). The collapsed dq's two entry points come from one build,
    whose plan sizes the partials."""

    STAND_IN = ("ds_rms_norm", "ds_layer_norm", "ds_quantized_matmul", "ds_flash_fwd", "ds_flash_bwd_dq",
                "ds_flash_bwd_dkv", "ds_flash_bwd_dq_collapsed", "ds_flash_dq_collapsed_parts",
                "ds_paged_attention_decode", "ds_paged_attention_prefill", "ds_sparse_fwd", "ds_sparse_bwd_dq",
                "ds_sparse_bwd_dkv", "ds_fused_adam_multi", "ds_moe_grouped_gemm")

    def __init__(self, lib, other):
        self._lib, self._other = lib, other

    def __getattr__(self, name):
        if name not in self.STAND_IN:
            return getattr(self._lib, name)
        if name == "ds_fused_adam_multi" and not hasattr(self._other, name):
            return OldAdamEntry(self._other.ds_fused_adam)
        fn = getattr(self._other, name)
        if len(fn.argtypes) == OldPagedEntry.OLD_ARGS.get(name):
            return OldPagedEntry(name, fn)
        if len(fn.argtypes) == OldSparseEntry.OLD_ARGS.get(name):
            return OldSparseEntry(name, fn)
        if name == "ds_moe_grouped_gemm" and len(fn.argtypes) == OldGemmEntry.OLD_ARGS:
            return OldGemmEntry(fn)
        return fn


def load_parent(path: str):
    """Build DIR's kernels with DIR's own ``_build.py`` (into DIR/build/) and
    return the stand-in library."""
    import importlib.util

    from deepspeed_tpu_torch.ops import _build

    spec = importlib.util.spec_from_file_location("parent_build",
                                                  os.path.join(path, "deepspeed_tpu_torch", "ops", "_build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return ParentKernels(_build.lib(), mod.lib())


class parent_kernels:
    """``with parent_kernels():`` runs the port on the --parent kernels."""

    def __enter__(self):
        from deepspeed_tpu_torch.ops import _build

        self._saved, _build._lib = _build.lib(), PARENT["lib"]

    def __exit__(self, *exc):
        from deepspeed_tpu_torch.ops import _build

        _build._lib = self._saved


def parent_time(fn, *args, **kw):
    """``fn(*args)`` (a timer) on the --parent kernels, or None without --parent."""
    if PARENT["lib"] is None:
        return None
    with parent_kernels():
        return fn(*args, **kw)


def errors(got, want, floor: float = 1e-30) -> dict:
    """Max abs error and max per-row relative error (rows = the last dim), each
    row's scale taken as at least ``floor``."""
    diff = (got.float() - want.float()).flatten(0, -2).abs().amax(-1)
    scale = want.float().flatten(0, -2).abs().amax(-1).clamp_min(floor)
    return dict(max_abs_err=diff.max().item(), max_rel_err=(diff / scale).max().item())


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- kernel phases
def paged_case(torch, dev, dtype, ctx, H, KVH, D, bs, P, seed, garbage_rows=()):
    """Pools holding exactly the pages of ``ctx`` (row-disjoint, shuffled), block 0 spare."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pages = [max(1, -(-c // bs)) for c in ctx]
    n_blocks = 1 + sum(pages)
    kp = torch.randn((n_blocks, bs, KVH, D), generator=g, device=dev).to(dtype)
    vp = torch.randn((n_blocks, bs, KVH, D), generator=g, device=dev).to(dtype)
    perm = (1 + torch.randperm(n_blocks - 1, generator=torch.Generator().manual_seed(seed))).tolist()
    bt = torch.zeros((len(ctx), P), dtype=torch.int32)
    i = 0
    for r, n in enumerate(pages):
        if r not in garbage_rows:
            bt[r, :n] = torch.tensor(perm[i:i + n], dtype=torch.int32)
        i += n
    return kp, vp, bt.to(dev), torch.tensor(ctx, dtype=torch.int32, device=dev), g


def dense_kv(torch, kp, vp, bt, ctx):
    """Gathered dense K/V (B, KVH, L, D) for the library yardstick (SDPA with
    ``enable_gqa``), L = the longest context: dense attention pads every row
    to it, so the yardstick reads more bytes than the paged kernel."""
    B, bs, KVH, D = bt.shape[0], kp.shape[1], kp.shape[2], kp.shape[3]
    L = -(-int(ctx.max().item()) // bs) * bs
    idx = bt[:, :L // bs].long()
    k = kp[idx].reshape(B, L, KVH, D).permute(0, 2, 1, 3).contiguous()
    v = vp[idx].reshape(B, L, KVH, D).permute(0, 2, 1, 3).contiguous()
    return k, v, L


def int8_pools(kp, vp):
    """The same pages as int8 ``(codes, scales)`` pools; block 0, the garbage
    page, is left as never written (codes 0, scale 0)."""
    from deepspeed_tpu_torch.ops import paged_attention as pa

    pools = []
    for pages in (kp, vp):
        codes, scales = pa.quantize_kv(pages)
        codes[0], scales[0] = 0, 0.0
        pools.append((codes, scales))
    return pools


def kv_bytes(slots, KVH, D, item, int8):
    """Bytes of ``slots`` K and V entries: int8 codes carry one fp32 scale per slot and head."""
    return slots * KVH * 2 * ((D + 4) if int8 else D * item)


def paged_features(torch, dev, feature, geom):
    """ALiBi slopes (fp32 (H,) on the device) and window (0: none) of a kernel case: ``alibi`` takes
    ``alibi_slopes(H)`` (bloom's), ``window`` mistral's 4,096 (scaled to the geometry's context, 512 of
    gpt2_1_3b's 1,024, so that it cuts there too)."""
    from deepspeed_tpu_torch.models import alibi_slopes

    slopes = torch.from_numpy(alibi_slopes(geom["H"])).to(dev) if feature == "alibi" else None
    window = 4096 * geom["P"] * geom["bs"] // 8192 if feature == "window" else 0
    return slopes, window


def sdpa_mask(torch, slopes, window, L, qpos, cl, dtype):
    """SDPA's mask for a paged case over the dense keys [0, L): query positions ``qpos`` (B, Sq) see the keys
    before their row's ctx ``cl``, at or before themselves and inside the window; boolean (B, 1, Sq, L), or
    with ALiBi slopes float (B, H, Sq, L) in ``dtype``: -inf outside, + slope * key position inside."""
    kpos = torch.arange(L, device=qpos.device)
    allowed = (kpos[None, None, :] <= qpos[:, :, None]) & (kpos[None, None, :] < cl[:, None, None])
    if window:
        allowed = allowed & (kpos[None, None, :] > qpos[:, :, None] - window)
    allowed = allowed[:, None]
    if slopes is None:
        return allowed
    bias = slopes[None, :, None, None] * kpos.float()
    return bias.masked_fill(~allowed, float("-inf")).to(dtype)


def paged_tol(torch, dtype, slopes, last_key, v_pages) -> tuple:
    """TOL, and in fp32 with ALiBi the plain version's own rounding on top: a score of magnitude up to
    S = max slope * the last key position rounds to fp32 with an error of up to 2**-24 S, which moves that
    key's weight by as much relatively, on either side (scores reach 6,900 at llama3_8b's 8,192 keys)."""
    from deepspeed_tpu_torch.ops import paged_attention as pa

    what, tol = TOL[str(dtype)]
    if dtype != torch.float32 or slopes is None:
        return what, tol
    v = pa.dequantize_kv(v_pages) if pa.kv_pool_is_quantized(v_pages) else v_pages
    return what, tol + 2 * 2**-24 * slopes.abs().max().item() * last_key * v.abs().max().item()


def cold_ms(torch, fn, tensors, iters):
    """Device time of ``fn(*tensors)`` from a CUDA graph rotating over copies of ``tensors`` (nested tuples
    of tensors, like an int8 pool) whose bytes together pass 100 MB, twice the L2: every launch finds them
    in device memory, as a serving step finds its pools."""
    def nbytes(t):
        return sum(nbytes(x) for x in t) if isinstance(t, tuple) else t.numel() * t.element_size()

    def clone(t):
        return tuple(clone(x) for x in t) if isinstance(t, tuple) else t.clone()

    copies = [clone(tuple(tensors)) for _ in range(max(2, 100_000_000 // nbytes(tuple(tensors)) + 1))]
    ms = time_ms_rotating(fn, copies, iters)
    del copies
    return ms


def phase_decode(torch, dev, dtype, B, iters, geom=GEOM, int8=False, feature="none"):
    """Decode at ``geom``'s heads over B rows of seeded contexts (up to P bs, one padded row on the garbage
    page) against its plain version; kernel, parent, plain and SDPA times, and at B = 8 without a feature
    also cold device times of the kernel, the parent and SDPA."""
    from deepspeed_tpu_torch.device import sm_count
    from deepspeed_tpu_torch.ops import paged_attention as pa

    H, KVH, D, bs, P = (geom[k] for k in ("H", "KVH", "D", "bs", "P"))
    base = [1, 127, 128, 129, 4096, 513, 2000, 8192]
    ctx = [min(base[i % len(base)], P * bs) for i in range(B)]
    ctx[-1] = 1  # a padded row: ctx 1 on the garbage page
    kd, vd, bt, cl, g = paged_case(torch, dev, dtype, ctx, H, KVH, D, bs, P, seed=B, garbage_rows=(B - 1,))
    kp, vp = int8_pools(kd, vd) if int8 else (kd, vd)
    if int8:  # the library yardstick reads the dequantised pages in q's type
        kd, vd = pa.dequantize_kv(kp).to(dtype), pa.dequantize_kv(vp).to(dtype)
    q = torch.randn((B, H, D), generator=g, device=dev).to(dtype)
    scale = D**-0.5
    slopes, window = paged_features(torch, dev, feature, geom)
    kw = dict(alibi_slopes=slopes, window=window or None)
    got = pa.paged_attention_decode(q, kp, vp, bt, cl, scale, **kw)
    torch.cuda.synchronize()
    want = pa.paged_attention_decode_ref(q, kp, vp, bt, cl, scale, **kw)
    err = errors(got, want)
    item = q.element_size()
    live = sum(min(c, window) if window else c for c in ctx)
    nbytes = kv_bytes(live, KVH, D, item, int8) + 2 * q.numel() * item + bt.numel() * 4 + cl.numel() * 4
    flops = 4 * live * H * D
    b_ms, b_by = bound(nbytes, flops, dtype)
    run = lambda: pa.paged_attention_decode(q, kp, vp, bt, cl, scale, **kw)
    k_ms = time_ms(run, iters)
    p_ms = time_ms(lambda: pa.paged_attention_decode_ref(q, kp, vp, bt, cl, scale, **kw), max(3, iters // 20))
    k, v, L = dense_kv(torch, kd, vd, bt, cl)
    mask = sdpa_mask(torch, slopes, window, L, (cl - 1)[:, None], cl, dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda kk, vv: sdpa(q[:, :, None], kk, vv, attn_mask=mask, scale=scale, enable_gqa=True)
    l_ms = time_ms(lambda: lib(k, v), max(3, iters // 4))
    l_bytes = 2 * k.numel() * item + 2 * q.numel() * item + mask.numel() * mask.element_size()
    cold = {}
    if B == 8 and feature == "none":
        kcold = lambda kk, vv: pa.paged_attention_decode(q, kk, vv, bt, cl, scale)
        cold = dict(kernel_cold_ms=cold_ms(torch, kcold, (kp, vp), iters),
                    parent_cold_ms=parent_time(cold_ms, torch, kcold, (kp, vp), iters),
                    library_cold_ms=cold_ms(torch, lib, (k, v), iters))
    del k, v
    return dict(kernel="paged_attention_decode", pool="int8" if int8 else str(dtype), dtype=str(dtype),
                shape=f"q({B},{H},{D}) pool({kd.shape[0]},{bs},"
                f"{KVH},{D}) bt({B},{P})", features=feature, window=window, ctx=sorted(set(ctx)), **err,
                tol=paged_tol(torch, dtype, slopes, max(ctx), vp), kernel_ms=k_ms, parent_ms=None if feature != "none" else parent_time(
                    time_ms, run, iters), plain_ms=p_ms, library_ms=l_ms, library_bytes=l_bytes, **cold,
                plan=pa._decode_plan(B, KVH * -(-(H // KVH) // pa.DECODE_HEADS), P, bs, sm_count(dev))
                if dtype == torch.bfloat16 else None,
                bound_bytes=nbytes, bound_ms=b_ms, bound_by=b_by)


def phase_prefill(torch, dev, dtype, S, iters, geom=GEOM, int8=False, feature="none"):
    """Prefill of 2 x S queries at ``geom``'s heads (row 0 from position 0, row 1 continuing a context of
    1,000, or of 7,680 with a window, so that the window cuts) against its plain version; kernel, parent,
    plain and SDPA times, and at S = 16 without a feature also cold device times."""
    from deepspeed_tpu_torch.device import sm_count
    from deepspeed_tpu_torch.ops import paged_attention as pa

    H, KVH, D, bs, P = (geom[k] for k in ("H", "KVH", "D", "bs", "P"))
    slopes, window = paged_features(torch, dev, feature, geom)
    q0 = [0, min(7680 if window else 1000, P * bs - 512)]  # row 1 continues a context: its chunk starts here
    ctx = [p + S for p in q0]
    kd, vd, bt, cl, g = paged_case(torch, dev, dtype, ctx, H, KVH, D, bs, P, seed=S)
    kp, vp = int8_pools(kd, vd) if int8 else (kd, vd)
    if int8:
        kd, vd = pa.dequantize_kv(kp).to(dtype), pa.dequantize_kv(vp).to(dtype)
    q = torch.randn((2, S, H, D), generator=g, device=dev).to(dtype)
    pos = (torch.tensor(q0, dtype=torch.int32)[:, None] + torch.arange(S, dtype=torch.int32)[None]).to(dev)
    scale = D**-0.5
    kw = dict(alibi_slopes=slopes, window=window or None)
    got = pa.paged_attention_prefill(q, kp, vp, bt, cl, pos, scale, **kw)
    torch.cuda.synchronize()
    want = pa.paged_attention_prefill_ref(q, kp, vp, bt, cl, pos, scale, **kw)
    err = errors(got, want)
    item = q.element_size()
    lo = (lambda p: max(0, p - window + 1)) if window else (lambda p: 0)
    visible = sum(min(c, p0 + s + 1) - lo(p0 + s) for c, p0 in zip(ctx, q0) for s in range(S))
    read = sum(c - lo(p0) for c, p0 in zip(ctx, q0))  # the keys some query of the row sees
    nbytes = kv_bytes(read, KVH, D, item, int8) + 2 * q.numel() * item + bt.numel() * 4 + 2 * 4 + pos.numel() * 4
    flops = 4 * visible * H * D
    b_ms, b_by = bound(nbytes, flops, dtype)
    run = lambda: pa.paged_attention_prefill(q, kp, vp, bt, cl, pos, scale, **kw)
    k_ms = time_ms(run, iters)
    p_ms = time_ms(lambda: pa.paged_attention_prefill_ref(q, kp, vp, bt, cl, pos, scale, **kw), max(3, iters // 20))
    k, v, L = dense_kv(torch, kd, vd, bt, cl)
    mask = sdpa_mask(torch, slopes, window, L, pos, cl, dtype)
    qh = q.permute(0, 2, 1, 3).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda kk, vv: sdpa(qh, kk, vv, attn_mask=mask, scale=scale, enable_gqa=True)
    l_ms = time_ms(lambda: lib(k, v), max(3, iters // 4))
    l_bytes = 2 * k.numel() * item + 2 * q.numel() * item + mask.numel() * mask.element_size()
    cold = {}
    if S == 16 and feature == "none":
        kcold = lambda kk, vv: pa.paged_attention_prefill(q, kk, vv, bt, cl, pos, scale)
        cold = dict(kernel_cold_ms=cold_ms(torch, kcold, (kp, vp), iters),
                    parent_cold_ms=parent_time(cold_ms, torch, kcold, (kp, vp), iters),
                    library_cold_ms=cold_ms(torch, lib, (k, v), iters))
    del k, v
    return dict(kernel="paged_attention_prefill", pool="int8" if int8 else str(dtype), dtype=str(dtype),
                shape=f"q(2,{S},{H},{D}) kv_heads={KVH} qpos0={q0} ctx={ctx}", features=feature, window=window,
                **err, tol=paged_tol(torch, dtype, slopes, max(ctx), vp), kernel_ms=k_ms,
                parent_ms=None if feature != "none" else parent_time(
                    time_ms, run, iters), plain_ms=p_ms, library_ms=l_ms, library_bytes=l_bytes, **cold,
                plan=pa._prefill_plan(2, S, H, KVH, P, bs, sm_count(dev)) if dtype == torch.bfloat16 else None,
                bound_bytes=nbytes, bound_ms=b_ms, bound_by=b_by)


# A speculative verify step's prefill: B rows of chunk = K + 1 queries (K drafts of 4, and of 1), each row's
# window the last positions of a context spread evenly over this range
VERIFY_CTX = (130, 8192)


def phase_verify(torch, dev, dtype, B, chunk, iters, geom=GEOM, int8=False):
    """Prefill at the shape of a speculative verify step: B rows x ``chunk`` queries at ``geom``'s heads,
    row r's window ending its context (spread over VERIFY_CTX), against its plain version; kernel, plain
    and SDPA (boolean mask) times and the bound."""
    from deepspeed_tpu_torch.device import sm_count
    from deepspeed_tpu_torch.ops import paged_attention as pa

    H, KVH, D, bs, P = (geom[k] for k in ("H", "KVH", "D", "bs", "P"))
    lo, hi = VERIFY_CTX
    ctx = [min(P * bs, lo + (hi - lo) * r // max(1, B - 1)) for r in range(B)]
    q0 = [c - chunk for c in ctx]
    kd, vd, bt, cl, g = paged_case(torch, dev, dtype, ctx, H, KVH, D, bs, P, seed=16 * B + chunk)
    kp, vp = int8_pools(kd, vd) if int8 else (kd, vd)
    if int8:
        kd, vd = pa.dequantize_kv(kp).to(dtype), pa.dequantize_kv(vp).to(dtype)
    q = torch.randn((B, chunk, H, D), generator=g, device=dev).to(dtype)
    pos = (torch.tensor(q0, dtype=torch.int32)[:, None] + torch.arange(chunk, dtype=torch.int32)[None]).to(dev)
    scale = D**-0.5
    got = pa.paged_attention_prefill(q, kp, vp, bt, cl, pos, scale)
    torch.cuda.synchronize()
    want = pa.paged_attention_prefill_ref(q, kp, vp, bt, cl, pos, scale)
    err = errors(got, want)
    item = q.element_size()
    visible = sum(p0 + s + 1 for p0 in q0 for s in range(chunk))
    nbytes = kv_bytes(sum(ctx), KVH, D, item, int8) + 2 * q.numel() * item + bt.numel() * 4 + B * 4 + pos.numel() * 4
    flops = 4 * visible * H * D
    b_ms, b_by = bound(nbytes, flops, dtype)
    k_ms = time_ms(lambda: pa.paged_attention_prefill(q, kp, vp, bt, cl, pos, scale), iters)
    p_ms = time_ms(lambda: pa.paged_attention_prefill_ref(q, kp, vp, bt, cl, pos, scale), max(3, iters // 20))
    k, v, L = dense_kv(torch, kd, vd, bt, cl)
    mask = sdpa_mask(torch, None, 0, L, pos, cl, dtype)
    qh = q.permute(0, 2, 1, 3).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    l_ms = time_ms(lambda: sdpa(qh, k, v, attn_mask=mask, scale=scale, enable_gqa=True), max(3, iters // 4))
    l_bytes = 2 * k.numel() * item + 2 * q.numel() * item + mask.numel() * mask.element_size()
    del k, v
    return dict(kernel="paged_attention_prefill", pool="int8" if int8 else str(dtype), dtype=str(dtype),
                shape=f"q({B},{chunk},{H},{D}) kv_heads={KVH} ctx={ctx[0]}..{ctx[-1]}", features="verify",
                window=0, **err, tol=TOL[str(dtype)], kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                library_bytes=l_bytes, launches_per_verify_step="one a layer (no decode launch)",
                plan=pa._prefill_plan(B, chunk, H, KVH, P, bs, sm_count(dev)) if dtype == torch.bfloat16 else None,
                bound_bytes=nbytes, bound_flops=flops, bound_ms=b_ms, bound_by=b_by)


def norm_wdtype(torch, dtype, mixed):
    """The weight's dtype of a norm case: x's, or with ``mixed`` the other one (bf16 x with fp32 w is how the
    parameters converted from the JAX package, fp32, meet bf16 activations)."""
    return ({torch.bfloat16: torch.float32, torch.float32: torch.bfloat16}[dtype]) if mixed else dtype


def norm_times(torch, kernel, library, x, iters) -> dict:
    """A norm's eager times (kernel, and the parent's with --parent; the library's where there is one) and
    its cold device times (kernel, parent, library): a CUDA graph rotating over copies of x, without the
    host's launch."""
    return dict(kernel_ms=time_ms(lambda: kernel(x), iters), parent_ms=parent_time(time_ms, lambda: kernel(x), iters),
                library_ms=library and time_ms(lambda: library(x), iters),
                kernel_cold_ms=cold_ms(torch, kernel, (x,), iters),
                parent_cold_ms=parent_time(cold_ms, torch, kernel, (x,), iters),
                library_cold_ms=library and cold_ms(torch, library, (x,), iters))


def phase_rms(torch, dev, dtype, T, iters, mixed=False, d=None, offset=False):
    """``rms_norm`` of (1, T, d) (d llama3_8b's by default); ``offset``: gemma's weight as its serving passes
    it, ``1 + w`` in fp32 for w ~ N(0, 0.02)."""
    from deepspeed_tpu_torch.ops import norms

    d = d or GEOM["d"]
    g = torch.Generator(device=dev).manual_seed(T)
    x = torch.randn((1, T, d), generator=g, device=dev).to(dtype)
    if offset:
        w = 1.0 + 0.02 * torch.randn((d,), generator=g, device=dev)
    else:
        w = torch.randn((d,), generator=g, device=dev).to(norm_wdtype(torch, dtype, mixed))
    got = norms.rms_norm(x, w, 1e-5)
    torch.cuda.synchronize()
    err = errors(got, norms.rms_norm_ref(x, w, 1e-5))
    item = x.element_size()
    nbytes = 2 * T * d * item + d * w.element_size()
    b_ms, b_by = bound(nbytes, 4 * T * d, dtype)
    p_ms = time_ms(lambda: norms.rms_norm_ref(x, w, 1e-5), iters)
    times = norm_times(torch, lambda xx: norms.rms_norm(xx, w, 1e-5),
                       lambda xx: torch.nn.functional.rms_norm(xx, (d,), w, 1e-5), x, iters)
    return dict(kernel="rms_norm", dtype=str(dtype), shape=f"x(1,{T},{d}) w({d})", wdtype=str(w.dtype), **err,
                tol=TOL[str(dtype)], plain_ms=p_ms, library="F.rms_norm", **times, library_bytes=nbytes,
                bound_bytes=nbytes, bound_ms=b_ms, bound_by=b_by)


def phase_layer_norm(torch, dev, dtype, T, iters, mixed=False, d=None):
    """``layer_norm`` of (1, T, d) (d gpt2_1_3b's by default)."""
    from deepspeed_tpu_torch.ops import norms

    d = d or GPT2_GEOM["d"]
    g = torch.Generator(device=dev).manual_seed(T)
    wdtype = norm_wdtype(torch, dtype, mixed)
    x = (torch.randn((1, T, d), generator=g, device=dev) * 2.0 + 0.5).to(dtype)
    w = torch.randn((d,), generator=g, device=dev).to(wdtype)
    b = torch.randn((d,), generator=g, device=dev).to(wdtype)
    got = norms.layer_norm(x, w, b, 1e-5)
    torch.cuda.synchronize()
    err = errors(got, norms.layer_norm_ref(x, w, b, 1e-5))
    item = x.element_size()
    nbytes = 2 * T * d * item + 2 * d * w.element_size()
    b_ms, b_by = bound(nbytes, 8 * T * d, dtype)
    p_ms = time_ms(lambda: norms.layer_norm_ref(x, w, b, 1e-5), iters)
    # F.layer_norm refuses parameters of another type than x's: no library call computes the mixed case
    library = None if mixed else lambda xx: torch.nn.functional.layer_norm(xx, (d,), w, b, 1e-5)
    times = norm_times(torch, lambda xx: norms.layer_norm(xx, w, b, 1e-5), library, x, iters)
    return dict(kernel="layer_norm", dtype=str(dtype), shape=f"x(1,{T},{d}) w({d}) b({d})", wdtype=str(wdtype),
                **err, tol=TOL[str(dtype)], plain_ms=p_ms, library=library and "F.layer_norm", **times,
                library_bytes=nbytes, bound_bytes=nbytes, bound_ms=b_ms, bound_by=b_by)


# (K, N) of the quantised projections: gpt2_1_3b's q/k/v/o, up and down (int8);
# llama3_8b's gate/up and down (packed int4), group size 128
QMM_INT8 = [(2048, 2048), (2048, 8192), (8192, 2048)]
QMM_INT4 = [(4096, 14336), (14336, 4096)]


def phase_qmm(torch, dev, dtype, M, K, N, bits, iters):
    """``quantized_matmul`` against its plain version (dequantise to fp32,
    multiply in fp32). Yardsticks, timed only: ``torch.matmul`` of x with the
    weight dequantised to x's type beforehand (what a dense engine pays, and
    the ``library_ms``), and dequantise + ``torch.matmul`` in one call. At M <=
    64 both are also timed cold (``*_cold_ms``, device time from a CUDA
    graph): rotating over copies of the codes and scales, and of the dense
    weight, of over 100 MB each."""
    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    g = torch.Generator(device=dev).manual_seed(M + K + N)
    w = torch.randn((K, N), generator=g, device=dev) * 0.02
    q, scales = qm.quantize_weight_kgroups(w, group_size=128, bits=bits, pack=bits == 4)
    packed = q.shape[0] != K
    del w
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
    got = qm.quantized_matmul(x, q, scales, packed=packed)
    torch.cuda.synchronize()
    want = qm.quantized_matmul_ref(x, q, scales, packed=packed)
    err = errors(got, want)
    # fp32: sums of K products in another order than the plain version's, held on max(1, max |plain|)
    err["max_abs_err_scaled"] = err["max_abs_err"] / max(1.0, want.float().abs().max().item())
    tol = ("max_abs_err_scaled", 1e-5) if dtype == torch.float32 else TOL[str(dtype)]
    del want
    item = x.element_size()
    nbytes = x.numel() * item + q.numel() + scales.numel() * 4 + M * N * item
    flops = 2 * M * K * N
    b_ms, b_by = bound(nbytes, flops, dtype)
    few = max(3, iters // 4)
    run = lambda: qm.quantized_matmul(x, q, scales, packed=packed)
    k_ms = time_ms(run, iters)
    p_ms = time_ms(lambda: qm.quantized_matmul_ref(x, q, scales, packed=packed), few)
    dense = qm._dequantize_kgroups(q, scales, packed).to(dtype)
    l_ms = time_ms(lambda: torch.matmul(x, dense), iters)
    cold = {}
    if M <= 64:
        kcold = lambda qq, ss: qm.quantized_matmul(x, qq, ss, packed=packed)
        cold["kernel_cold_ms"] = cold_ms(torch, kcold, (q, scales), iters)
        cold["parent_cold_ms"] = parent_time(cold_ms, torch, kcold, (q, scales), iters)
        cold["library_cold_ms"] = cold_ms(torch, lambda d: torch.matmul(x, d), (dense,), iters)
    del dense
    dq_ms = time_ms(lambda: torch.matmul(x, qm._dequantize_kgroups(q, scales, packed).to(dtype)), few)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = qm._qmm_plan(M, K, N, scales.shape[0], packed, sms) if dtype == torch.bfloat16 else None
    return dict(kernel="quantized_matmul", codes="packed int4" if packed else "int8", dtype=str(dtype),
                shape=f"x({M},{K}) codes({q.shape[0]},{N}) scales({scales.shape[0]},{N})", **err, tol=tol,
                kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms, library="torch.matmul, weight dequantised beforehand",
                parent_ms=parent_time(time_ms, run, iters), **cold, plan=plan,
                dequant_matmul_ms=dq_ms, bound_bytes=nbytes, bound_flops=flops, bound_ms=b_ms, bound_by=b_by)


def run_cases(torch, cases, dtypes=None):
    """Each case (a function of the dtype) in bf16 and fp32 (or ``dtypes``),
    held to its own tolerance; returns the per-case records."""
    records = []
    for dtype in dtypes or (torch.bfloat16, torch.float32):
        for case in cases:
            rec = case(dtype)
            log(rec)
            what, tol = rec["tol"]
            if not rec[what] <= tol:
                raise AssertionError(f"{rec['kernel']} {rec['dtype']} {rec['shape']}: {what} {rec[what]} > {tol}")
            records.append(rec)
            torch.cuda.empty_cache()
    return records


def run_kernel_phases(torch, dev, quick: bool):
    """The three kernels of unquantised serving at llama3_8b's shapes; decode (B 64) and prefill (2 x 512)
    also with ALiBi and with a window."""
    iters = 5 if quick else 20  # 50 until PR 27 (the whole script's time limit)
    sizes = [(phase_decode, 64), (phase_prefill, 512), (phase_rms, 768)] if quick else [
        (phase_decode, 8), (phase_decode, 64), (phase_prefill, 16), (phase_prefill, 256), (phase_prefill, 512),
        (phase_rms, 8), (phase_rms, 768), (phase_rms, 2048)]
    cases = [lambda dt, fn=fn, n=n: fn(torch, dev, dt, n, iters) for fn, n in sizes]
    if not quick:
        cases.append(lambda dt: phase_rms(torch, dev, dt, 2048, iters, mixed=True))
        cases += [lambda dt, fn=fn, n=n, f=f: fn(torch, dev, dt, n, iters, feature=f)
                  for f in ("alibi", "window") for fn, n in ((phase_decode, 64), (phase_prefill, 512))]
        cases += [lambda dt, c=c: phase_verify(torch, dev, dt, 64, c, iters) for c in (5, 2)]
    return run_cases(torch, cases)


def run_quant_kernel_phases(torch, dev, quick: bool):
    """The kernels of quantised serving: ``layer_norm``, ``quantized_matmul`` with
    int8 and packed-int4 codes, decode and prefill on int8 pools at both models' heads."""
    iters = 5 if quick else 30
    norm = lambda T, mixed=False: lambda dt: phase_layer_norm(torch, dev, dt, T, iters, mixed)
    qmm = lambda M, K, N, bits: lambda dt: phase_qmm(torch, dev, dt, M, K, N, bits, iters)
    decode = lambda B, geom, f="none": lambda dt: phase_decode(torch, dev, dt, B, iters, geom, int8=True, feature=f)
    prefill = lambda S, geom, f="none": lambda dt: phase_prefill(torch, dev, dt, S, iters, geom, int8=True, feature=f)
    if quick:
        return run_cases(torch, [norm(768), qmm(64, 2048, 8192, 8), qmm(64, 4096, 14336, 4), decode(64, GPT2_GEOM),
                                 prefill(512, GPT2_GEOM)])
    cases = [norm(T) for T in (8, 768, 2048)] + [norm(2048, mixed=True)]
    cases += [qmm(M, K, N, bits) for bits, shapes in ((8, QMM_INT8), (4, QMM_INT4)) for K, N in shapes
              for M in (8, 64, 512, 1024)]
    for geom in (GPT2_GEOM, GEOM):
        cases += [decode(B, geom) for B in (8, 64)] + [prefill(S, geom) for S in (16, 256, 512)]
        cases += [case(n, geom, f) for f in ("alibi", "window") for case, n in ((decode, 64), (prefill, 512))]
    # the verify windows of speculative decoding on int8 pools at llama3_8b's heads
    cases += [lambda dt, c=c: phase_verify(torch, dev, dt, 64, c, iters, int8=True) for c in (5, 2)]
    # the bf16 pool at gpt2_1_3b's heads (MHA, D 64), with and without ALiBi and a window
    plain = lambda fn, n, f: lambda dt: fn(torch, dev, dt, n, iters, GPT2_GEOM, feature=f)
    cases += [plain(fn, n, f) for f in ("none", "alibi", "window") for fn, n in ((phase_decode, 64),
                                                                                  (phase_prefill, 512))]
    return run_cases(torch, cases)


# ---------------------------------------------------------------- training kernels
# gpt2_1_3b attention: 32 heads of 64, sequence 1024, micro-batch 8
FLASH_CASES = {
    "gpt2_1_3b": dict(B=8, Sq=1024, Sk=1024, H=32, KVH=32, D=64, causal=True),
    "gqa": dict(B=1, Sq=2048, Sk=2048, H=32, KVH=8, D=128, causal=True),
    "sq_lt_sk": dict(B=4, Sq=512, Sk=1024, H=32, KVH=32, D=64, causal=True),
    "window": dict(B=4, Sq=1024, Sk=1024, H=32, KVH=32, D=64, causal=True, window=256),
    "alibi": dict(B=4, Sq=1024, Sk=1024, H=32, KVH=32, D=64, causal=True, alibi=True),
    # a rank's attention under Ulysses at llama3_8b, seq 2: the whole 8,192-token row over 16 of 32 query heads and
    # 4 of 8 KV heads (train_seq's shape, which trains in bf16: the fp32 bodies there take ~10 s a run)
    "ulysses_llama3_8b": dict(B=1, Sq=8192, Sk=8192, H=16, KVH=4, D=128, causal=True, bf16_only=True),
    # bert-base-uncased's encoder as serve_hf runs it through the v1 engine: 8 x 128 tokens, 12 heads of 64,
    # no mask
    "bert_base": dict(B=8, Sq=128, Sk=128, H=12, KVH=12, D=64, causal=False),
}


# a rank's attention at tensor 2 (train_tp): gpt2_1_3b's 16 of 32 heads, and llama3_8b's 16 of 32 query and 4 of 8
# KV heads at S 2,048
TP_FLASH_CASES = {
    "tp2_gpt2_1_3b": dict(B=8, Sq=1024, Sk=1024, H=16, KVH=16, D=64, causal=True),
    "tp2_llama3_8b": dict(B=1, Sq=2048, Sk=2048, H=16, KVH=4, D=128, causal=True),
}


# the flash kernels at the Hugging Face families' heads (flash_wide; csrc/*_wide.cu): each model's attention at a
# fine-tuning micro-batch of 4 x 2,048 (B 4 here: train_hf trains 2 x 2,048); one window and one ALiBi case
WIDE_FLASH_CASES = {
    "phi_2": dict(B=4, Sq=2048, Sk=2048, H=32, KVH=32, D=80, causal=True),           # microsoft/phi-2
    "phi_3_mini": dict(B=4, Sq=2048, Sk=2048, H=32, KVH=32, D=96, causal=True),      # Phi-3-mini-4k
    "gemma_2b": dict(B=4, Sq=2048, Sk=2048, H=8, KVH=1, D=256, causal=True),         # google/gemma-2b
    "gpt_j": dict(B=4, Sq=2048, Sk=2048, H=16, KVH=16, D=256, causal=True),          # EleutherAI/gpt-j-6b
    "phi_2_window": dict(B=4, Sq=2048, Sk=2048, H=32, KVH=32, D=80, causal=True, window=512),
    "phi_3_mini_alibi": dict(B=4, Sq=2048, Sk=2048, H=32, KVH=32, D=96, causal=True, alibi=True),
}


def visible_pairs(Sq, Sk, causal, window) -> int:
    """(query, key) pairs the mask lets through, per batch row and head."""
    if not causal:
        return Sq * Sk
    rows = [(Sk - Sq) + r for r in range(Sq)]
    return sum(max(0, min(r, Sk - 1) - (max(r - window + 1, 0) if window else 0) + 1) for r in rows)


def flash_f64(torch, q, k, v, do, lse, delta, slopes, scale, causal, window) -> dict:
    """The flash function in float64 on the card, one batch row at a time, by the plain version's formulas
    (q.k * scale + slope * key_pos, the causal band and window aligned to the end of the keys): o and lse from q,
    k, v; dq, dk, dv (summed over each KV head's query heads) from q, k, v, do and the given lse and delta, as the
    backward kernels take them. Values are (B, ...) float64 tensors."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    cols = torch.arange(Sk, device=q.device, dtype=torch.float64)
    rows = torch.arange(Sq, device=q.device, dtype=torch.float64)[:, None] + (Sk - Sq)
    allowed = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        allowed = (cols <= rows) & ((cols > rows - window) if window else allowed)
    out = {n: [] for n in ("o", "lse", "dq", "dk", "dv")}
    for b in range(B):
        qb, dob = q[b].double(), do[b].double()
        kb, vb = (t[b].double().repeat_interleave(H // KVH, dim=1) for t in (k, v))
        s = torch.einsum("qhd,khd->hqk", qb, kb) * scale
        if slopes is not None:
            s = s + slopes.double()[:, None, None] * cols
        s = s.masked_fill(~allowed, float("-inf"))
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        out["o"].append(torch.einsum("hqk,khd->qhd", p / l, vb))
        out["lse"].append((m + torch.log(l))[..., 0])
        p = torch.exp(s - lse[b].double()[..., None])
        ds = p * (torch.einsum("qhd,khd->hqk", dob, vb) - delta[b].double()[..., None])
        out["dq"].append(torch.einsum("hqk,khd->qhd", ds, kb) * scale)
        fold = lambda x: x.reshape(Sk, KVH, H // KVH, D).sum(2)  # noqa: E731
        out["dk"].append(fold(torch.einsum("hqk,qhd->khd", ds, qb) * scale))
        out["dv"].append(fold(torch.einsum("hqk,qhd->khd", p, dob)))
        del s, p, ds
    return {n: torch.stack(ts) for n, ts in out.items()}


def phase_flash(torch, dev, dtype, name, iters):
    """Kernels A, B, C at one shape against their plain versions; SDPA forward
    and backward through autograd as the library yardsticks."""
    from deepspeed_tpu_torch.models import alibi_slopes
    from deepspeed_tpu_torch.ops import flash_attention as fa

    c = {**FLASH_CASES, **TP_FLASH_CASES, **WIDE_FLASH_CASES}[name]
    B, Sq, Sk, H, KVH, D = (c[k] for k in ("B", "Sq", "Sk", "H", "KVH", "D"))
    causal, window = c["causal"], c.get("window", 0)
    g = torch.Generator(device=dev).manual_seed(Sq + H)
    q = torch.randn((B, Sq, H, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Sk, KVH, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Sk, KVH, D), generator=g, device=dev).to(dtype)
    do = torch.randn((B, Sq, H, D), generator=g, device=dev).to(dtype)
    slopes = torch.from_numpy(alibi_slopes(H)).to(dev) if c.get("alibi") else None
    scale = D**-0.5
    args = (slopes, scale, causal, window)
    o, lse = fa.flash_fwd(q, k, v, *args)
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, *args)
    delta = fa.flash_delta(o_ref, do)
    bwd = (q, k, v, do, lse_ref, delta, *args)
    dq = fa.flash_bwd_dq(*bwd)
    dk, dv = fa.flash_bwd_dkv(*bwd)
    torch.cuda.synchronize()
    dq_ref = fa.flash_bwd_dq_ref(*bwd)
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(*bwd)

    def err(a, b):
        # bf16: a row's scale is at least the tensor's mean magnitude (the first
        # causal row's dq is exactly 0 in the plain version: p = 1, dp = delta).
        # fp32: the abs error over max(1, max |want|), since dk/dv sum n_rep heads
        # of 2048 rows (values ~4) in another order than the plain version
        e = errors(a, b, b.float().abs().mean().item())
        e["max_abs_err_scaled"] = e["max_abs_err"] / max(1.0, b.float().abs().max().item())
        return e

    e_fwd = err(o, o_ref)
    e_fwd["lse_max_abs_err"] = (lse - lse_ref).abs().max().item()
    e_dq = err(dq, dq_ref)
    e_dk, e_dv = err(dk, dk_ref), err(dv, dv_ref)
    e_dkv = {key: max(e_dk[key], e_dv[key]) for key in e_dk}
    tol = ("max_abs_err_scaled", 1e-5) if dtype == torch.float32 else TOL[str(dtype)]
    if slopes is not None and name in WIDE_FLASH_CASES:
        # ALiBi at S 2,048: a score reaches max slope x last key (about 1,720), where one fp32 step is 1.2e-4, so
        # neither the kernel nor its plain version comes within 1e-5 of the true value (nor within 1e-4 in lse),
        # and the two round differently. Both are measured against the function in float64 on the same inputs;
        # the kernel may be no further from it than its plain version is, plus FLASH_CASES' bound (fp32 outputs
        # 1e-5 scaled, lse 1e-4; bf16 outputs stay held to their plain version)
        exact = flash_f64(torch, q, k, v, do, lse_ref, delta, *args)
        dist = lambda a, want: (a.double() - want).abs().max().item() / max(1.0, want.abs().max().item())
        e_fwd["lse_f64_err"] = (lse.double() - exact["lse"]).abs().max().item()
        e_fwd["plain_lse_f64_err"] = (lse_ref.double() - exact["lse"]).abs().max().item()
        e_fwd["lse_f64_excess"] = e_fwd["lse_f64_err"] - e_fwd["plain_lse_f64_err"]
        e_fwd["lse_tol"] = ("lse_f64_excess", 1e-4)
        if dtype == torch.float32:
            got = dict(o=o, dq=dq, dk=dk, dv=dv)
            plain = dict(o=o_ref, dq=dq_ref, dk=dk_ref, dv=dv_ref)
            for e, outs in ((e_fwd, ("o",)), (e_dq, ("dq",)), (e_dkv, ("dk", "dv"))):
                e["f64_err_scaled"] = max(dist(got[n], exact[n]) for n in outs)
                e["plain_f64_err_scaled"] = max(dist(plain[n], exact[n]) for n in outs)
                e["f64_excess_scaled"] = max(dist(got[n], exact[n]) - dist(plain[n], exact[n]) for n in outs)
            tol = ("f64_excess_scaled", 1e-5)
        del exact
    del o_ref, dq_ref, dk_ref, dv_ref
    item = q.element_size()
    pairs = visible_pairs(Sq, Sk, causal, window) * B * H
    nq, nk = q.numel() * item, k.numel() * item
    stats = B * H * Sq * 4  # lse or delta
    recs = {}
    few = max(2, iters // 10)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
    mask = None
    if window or slopes is not None or Sq != Sk:
        # SDPA's is_causal aligns queries to the start of the keys; give it the mask instead
        rows = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
        cols = torch.arange(Sk, device=dev)[None, :]
        allowed = (cols <= rows) & ((cols > rows - window) if window else True)
        mask = torch.zeros((Sq, Sk), device=dev).masked_fill(~allowed, float("-inf"))
        if slopes is not None:
            mask = mask[None] + slopes[:, None, None] * cols.float()
        mask = mask.to(dtype)
    lib = lambda qq, kk, vv: sdpa(qq, kk, vv, attn_mask=mask, is_causal=mask is None and causal, scale=scale,
                                  enable_gqa=KVH != H)
    leaves = [t.detach().requires_grad_(True) for t in (qh, kh, vh)]
    out = lib(*leaves)
    doh = do.permute(0, 2, 1, 3).contiguous()
    lib_fwd = time_ms(lambda: lib(qh, kh, vh), iters)
    lib_bwd = time_ms(lambda: torch.autograd.grad(out, leaves, doh, retain_graph=True), max(3, iters // 2))
    for kernel, e, fn, ref, n_prod, nbytes in (
            ("flash_fwd", e_fwd, lambda: fa.flash_fwd(q, k, v, *args), lambda: fa.flash_fwd_ref(q, k, v, *args), 2,
             2 * nq + 2 * nk + stats),
            ("flash_bwd_dq", e_dq, lambda: fa.flash_bwd_dq(*bwd), lambda: fa.flash_bwd_dq_ref(*bwd), 3,
             3 * nq + 2 * nk + 2 * stats),
            ("flash_bwd_dkv", e_dkv, lambda: fa.flash_bwd_dkv(*bwd), lambda: fa.flash_bwd_dkv_ref(*bwd), 4,
             2 * nq + 4 * nk + 2 * stats)):
        b_ms, b_by = bound(nbytes, 2 * n_prod * D * pairs, dtype)
        recs[kernel] = dict(kernel=kernel, case=name, dtype=str(dtype), shape=f"q({B},{Sq},{H},{D}) kv({B},{Sk},"
                            f"{KVH},{D}) causal={causal} window={window} alibi={slopes is not None}", **e,
                            tol=tol, kernel_ms=time_ms(fn, iters), plain_ms=time_ms(ref, few),
                            parent_ms=parent_time(time_ms, fn, iters),
                            library_ms=lib_fwd if kernel == "flash_fwd" else lib_bwd,
                            library="SDPA forward" if kernel == "flash_fwd" else "SDPA backward (dq, dk, dv)",
                            bound_bytes=nbytes, bound_flops=2 * n_prod * D * pairs, bound_ms=b_ms, bound_by=b_by)
    del out, leaves
    return list(recs.values())


def flatten(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, in sorted-key order (the engine's)."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [pair for k in sorted(tree) for pair in flatten(tree[k], f"{prefix}/{k}" if prefix else k)]


def gpt2_leaf_shapes():
    """The 388 parameter shapes of gpt2_1_3b, in the engine's order."""
    from deepspeed_tpu_torch.models import gpt2_1_3b, param_shapes

    return [(path, spec[0]) for path, spec in flatten(param_shapes(gpt2_1_3b()))]


def tp_leaf_shapes(tp: int = 2):
    """gpt2_1_3b's leaves as tensor rank 0 of ``tp`` holds them, in the engine's order (``wte`` whole: the
    vocabulary of 50,257 is odd)."""
    from deepspeed_tpu_torch.models import CausalLM, gpt2_1_3b
    from deepspeed_tpu_torch.module_inject.load_checkpoint import leaf_spec

    rules = CausalLM(gpt2_1_3b()).partition_rules()
    out = []
    for path, shape in gpt2_leaf_shapes():
        spec = leaf_spec(tuple(path.split("/")), shape, rules, tp)
        out.append((path, tuple(n // tp if d < len(spec) and spec[d] == "tensor" else n for d, n in enumerate(shape))))
    return out


def phase_adam(torch, dev, which, iters):
    """Kernel D over the wte leaf, over every gpt2_1_3b leaf or over tensor
    rank 0's leaves at tp 2 (``which``: "wte", "all", "tp2") in one
    ``fused_adam_multi`` call, as ``FusedAdam`` makes it (ceil(leaves /
    TABLE_LEAVES) launches), against its plain version. Timed three times
    each in turns (each first, second and last once): this tree's kernel,
    with ``--parent`` the parent build's through the same call (a build with
    only the one-leaf entry point launches once per leaf, ``OldAdamEntry``),
    and ``torch.optim.AdamW(fused=True)`` over the same leaves as the
    yardstick. ``kernel_ms``, ``parent_ms`` and ``library_ms`` are the
    medians; ``beats`` says whether the kernel's median is below each other
    median by more than both spreads."""
    from deepspeed_tpu_torch.ops import fused_adam as fad

    shapes = tp_leaf_shapes() if which == "tp2" else gpt2_leaf_shapes()
    if which == "wte":
        shapes = [(p, s) for p, s in shapes if p == "wte"]
    g = torch.Generator(device=dev).manual_seed(7)
    leaves = []
    for _, shape in shapes:
        p = torch.randn(shape, generator=g, device=dev)
        grad = torch.randn(shape, generator=g, device=dev)
        m = torch.randn(shape, generator=g, device=dev) * 1e-3
        v = torch.rand(shape, generator=g, device=dev) * 1e-6
        leaves.append((p, grad, m, v))
    n = sum(p.numel() for p, _, _, _ in leaves)
    scal = fad.adam_scalars(1e-4, 10, 0.9, 0.999, grad_mult=0.7, device=dev)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    lists = [list(t) for t in zip(*leaves)]
    ref = [[t.clone() for t in lists[0]], lists[1], [t.clone() for t in lists[2]], [t.clone() for t in lists[3]]]
    launches = fad.fused_adam.launches
    fad.fused_adam_multi(*lists, scal, **hyper)
    launches = fad.fused_adam.launches - launches
    fad.fused_adam_multi_ref(*ref, scal, **hyper)
    torch.cuda.synchronize()
    # relative to each updated tensor's largest value
    pairs = [(a, b) for i in (0, 2, 3) for a, b in zip(lists[i], ref[i])]
    rel = max(((a - b).abs().max() / b.abs().max()).item() for a, b in pairs)
    abs_err = max((a - b).abs().max().item() for a, b in pairs)
    del ref, pairs
    step = lambda: fad.fused_adam_multi(*lists, scal, **hyper)
    p_ms = time_ms(lambda: fad.fused_adam_multi_ref(*lists, scal, **hyper), max(2, iters // 5))
    for p, grad, _, _ in leaves:
        p.grad = grad
    opt = torch.optim.AdamW(lists[0], lr=1e-4, weight_decay=0.01, fused=True)

    def timed(name):
        if name == "parent":
            with parent_kernels():
                return time_ms(step, iters)
        return time_ms(step if name == "kernel" else opt.step, iters)

    names = ["kernel", "parent", "library"] if PARENT["lib"] is not None else ["kernel", "library"]
    runs = {name: [] for name in names}
    for turn in range(3):
        for name in names[turn % len(names):] + names[:turn % len(names)]:
            runs[name].append(timed(name))
    del opt
    nbytes = 28 * n
    alternating = {name: dict(ms=ts, median=sorted(ts)[1], spread=max(ts) - min(ts),
                              gb_per_s=nbytes / sorted(ts)[1] / 1e6) for name, ts in runs.items()}
    k = alternating["kernel"]
    beats = {name: r["median"] - k["median"] > max(k["spread"], r["spread"]) for name, r in alternating.items()
             if name != "kernel"}
    b_ms, b_by = bound(nbytes, 15 * n, torch.float32)
    return dict(kernel="fused_adam", case=which, dtype="torch.float32", shape=f"{len(leaves)} leaves, {n} elements",
                leaves=len(leaves), max_rel_err=rel, max_abs_err=abs_err, tol=("max_rel_err", 1e-6),
                launches_per_step=launches, kernel_ms=k["median"], gb_per_s=k["gb_per_s"],
                share_of_hbm=k["gb_per_s"] * 1e9 / HBM_BYTES_PER_S,
                parent_ms=alternating["parent"]["median"] if "parent" in alternating else None, plain_ms=p_ms,
                library_ms=alternating["library"]["median"], library="torch.optim.AdamW(fused=True)",
                alternating=alternating, beats=beats, bound_bytes=nbytes, bound_ms=b_ms, bound_by=b_by)


def check_flash(rec) -> None:
    what, tol = rec["tol"]
    lse_what, lse_tol = rec.get("lse_tol", ("lse_max_abs_err", 1e-4))
    if not (rec[what] <= tol and rec.get(lse_what, 0.0) <= lse_tol):
        raise AssertionError(f"{rec['kernel']} {rec['dtype']} {rec['case']}: {what} {rec[what]} > {tol}"
                             f" or {lse_what} {rec.get(lse_what)} > {lse_tol}")


def check_adam(rec) -> None:
    if not rec["max_rel_err"] <= 1e-6:
        raise AssertionError(f"fused_adam {rec['case']}: max_rel_err {rec['max_rel_err']} > 1e-6")
    if rec["launches_per_step"] != opt_launches("FusedAdam", rec["leaves"]):
        raise AssertionError(f"fused_adam {rec['case']}: {rec['launches_per_step']} launches for {rec['shape']}")


def run_flash_cases(torch, dev, cases: dict, names, iters: int) -> list:
    """The flash forward, dq and dk/dv at ``names`` of ``cases`` in bf16 and fp32 (a ``bf16_only`` case in bf16
    alone), each held to its plain version (``check_flash``), with bounds and SDPA's forward and backward."""
    records = []
    for dtype in (torch.bfloat16, torch.float32):
        for name in (n for n in names if dtype == torch.bfloat16 or not cases[n].get("bf16_only")):
            for rec in phase_flash(torch, dev, dtype, name, iters):
                log(rec)
                check_flash(rec)
                records.append(rec)
            torch.cuda.empty_cache()
    return records


def run_train_kernel_phases(torch, dev, quick: bool):
    iters = 5 if quick else 20
    records = run_flash_cases(torch, dev, FLASH_CASES, ["gpt2_1_3b"] if quick else list(FLASH_CASES), iters)
    for which in (["wte"] if quick else ["wte", "all"]):
        rec = phase_adam(torch, dev, which, iters)
        log(rec)
        check_adam(rec)
        records.append(rec)
        torch.cuda.empty_cache()
    return records


def run_wide_flash_phases(torch, dev, quick: bool) -> list:
    """flash_wide: ``run_flash_cases`` over ``WIDE_FLASH_CASES`` (D 80, 96, 256; bf16 within 1e-2 per row, fp32
    1e-5 scaled, as ``FLASH_CASES``; the ALiBi case against float64, ``phase_flash``)."""
    names = ["phi_2", "gemma_2b"] if quick else list(WIDE_FLASH_CASES)
    return run_flash_cases(torch, dev, WIDE_FLASH_CASES, names, 5 if quick else 20)


# ---------------------------------------------------------------- evoformer (DS4Sci_EvoformerAttention)
# AlphaFold2's attention widths (Jumper et al., Nature 2021, Supplementary Information): MSA row attention
# with pair bias (Algorithm 7) and MSA column attention (Algorithm 8), 8 heads of 32; triangle attention
# around the starting node (Algorithm 13), 4 heads of 32; a crop of 256 residues and 128 MSA clusters
# (initial training, Table 4) and of 384 residues and 512 clusters (fine-tuning). q is (1, rows, S, H, D).
EVO_SHAPES = {
    # mask + pair: the summed bias keeps every (row, head): nothing collapses
    "msa_row": dict(q=(1, 128, 256, 8, 32), biases=[(1, 128, 1, 1, 256), (1, 1, 8, 256, 256)]),
    # the pair bias alone: 128 MSA rows share each head's slice (the collapsed dq, Sqb = Sq)
    "msa_row_pair": dict(q=(1, 128, 256, 8, 32), biases=[(1, 1, 8, 256, 256)]),
    # the mask alone: one bias row per column, shared by the 8 heads and every query row (Sqb = 1)
    "msa_col": dict(q=(1, 256, 128, 8, 32), biases=[(1, 256, 1, 1, 128)]),
    "tri_start": dict(q=(1, 256, 256, 4, 32), biases=[(1, 256, 1, 1, 256), (1, 1, 4, 256, 256)]),
    "msa_row_finetune": dict(q=(1, 512, 384, 8, 32), biases=[(1, 512, 1, 1, 384), (1, 1, 8, 384, 384)],
                             dtypes=("torch.bfloat16",)),
}


def evo_inputs(torch, dev, dtype, name):
    """q, k, v, dO of EVO_SHAPES[name] and its biases, from a seeded generator:
    a mask bias of 0 or -1e9 (a tenth of the keys masked, key 0 never) and a
    pair bias of N(0, 1)."""
    c = EVO_SHAPES[name]
    g = torch.Generator(device=dev).manual_seed(sum(c["q"]))
    q, k, v, do = (torch.randn(c["q"], generator=g, device=dev).to(dtype) for _ in range(4))
    biases = []
    for shape in c["biases"]:
        if shape[2:4] == (1, 1):
            mask = torch.where(torch.rand(shape, generator=g, device=dev) < 0.1, -1e9, 0.0)
            mask[..., 0] = 0.0
            biases.append(mask.to(dtype))
        else:
            biases.append(torch.randn(shape, generator=g, device=dev).to(dtype))
    return q, k, v, do, biases


def evo_err(torch, got, want):
    """As phase_flash: bf16 per-row relative error, each row's scale at least the
    tensor's mean magnitude; fp32 abs error over max(1, max |want|)."""
    e = errors(got, want, want.float().abs().mean().item())
    e["max_abs_err_scaled"] = e["max_abs_err"] / max(1.0, want.float().abs().max().item())
    return e


def sdpa_yardstick(torch, q, k, v, mask, do, scale, iters):
    """SDPA over (B, H, S, D) with the summed bias as a float ``attn_mask``,
    forward and backward (dq, dk, dv and, where the backend gives one, dmask):
    the first backend of memory-efficient, cuDNN, math that takes it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                leaves = [t.detach().requires_grad_(True) for t in (q, k, v, mask)]
                out = sdpa(*leaves[:3], attn_mask=leaves[3], scale=scale)
                grads = torch.autograd.grad(out, leaves, do, retain_graph=True, allow_unused=True)
                fwd = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale), iters)
                bwd = time_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True, allow_unused=True),
                              max(3, iters // 2))
            return dict(backend=backend.name, mask_grad=grads[3] is not None, fwd_ms=fwd, bwd_ms=bwd)
        except RuntimeError as exc:
            last = str(exc).splitlines()[0][:200]
    return dict(backend=None, error=last, fwd_ms=None, bwd_ms=None)


def phase_evo_kernels(torch, dev, dtype, name, iters):
    """Each bias kernel body at one AlphaFold2 shape against its plain version:
    forward, the dq its layout selects (dbias per program, or summed over the
    sharing programs, whose result must repeat bit for bit) and dk/dv."""
    from deepspeed_tpu_torch.ops import evoformer as evo, flash_attention as fa

    q5, k5, v5, do5, biases = evo_inputs(torch, dev, dtype, name)
    lead, (Sq, H, D) = q5.shape[:-3], q5.shape[-3:]
    B = q5.numel() // (Sq * H * D)
    q, k, v, do = (t.reshape(B, Sq, H, D) for t in (q5, k5, v5, do5))
    bias, meta = fa.flat_bias(*evo.fold_biases(biases, lead), B, H, Sq, Sq)
    del biases
    scale = D**-0.5
    args = (None, scale, False, 0, bias, meta)
    o, lse = fa.flash_fwd(q, k, v, *args)
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, *args)
    bwd = (q, k, v, do, lse_ref, fa.flash_delta(o_ref, do), *args)
    collapsed = fa.bias_is_collapsed(meta, B, H)
    if collapsed:
        dq_fn, dq_ref_fn = (lambda: fa.flash_bwd_dq_collapsed(*bwd)), (lambda: fa.flash_bwd_dq_collapsed_ref(*bwd))
        dq, dbias = dq_fn()
        dq_again, dbias_again = dq_fn()
        torch.cuda.synchronize()
        repeats = torch.equal(dbias, dbias_again) and torch.equal(dq, dq_again)
        del dq_again, dbias_again
        dq_ref, dbias_ref = dq_ref_fn()
    else:
        dbias, dbias_ref = torch.empty_like(bias), torch.empty_like(bias)
        dq_fn = lambda: fa.flash_bwd_dq(*bwd, dbias)
        dq_ref_fn = lambda: fa.flash_bwd_dq_ref(*bwd, torch.empty_like(bias))
        dq = dq_fn()
        torch.cuda.synchronize()
        repeats = None
        dq_ref = fa.flash_bwd_dq_ref(*bwd, dbias_ref)
    dk, dv = fa.flash_bwd_dkv(*bwd)
    torch.cuda.synchronize()
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(*bwd)
    e_fwd = evo_err(torch, o, o_ref)
    e_fwd["lse_max_abs_err"] = (lse - lse_ref).abs().max().item()
    e_dq = evo_err(torch, dq, dq_ref)
    e_db = evo_err(torch, dbias, dbias_ref)
    e_dk, e_dv = evo_err(torch, dk, dk_ref), evo_err(torch, dv, dv_ref)
    e_dkv = {key: max(e_dk[key], e_dv[key]) for key in e_dk}
    del o_ref, dq_ref, dk_ref, dv_ref, dbias_ref
    tol = ("max_abs_err_scaled", 1e-5) if dtype == torch.float32 else TOL[str(dtype)]
    item = q.element_size()
    nq, nk, nb = q.numel() * item, k.numel() * item, bias.numel() * 4
    stats = B * H * Sq * 4
    pairs = B * H * Sq * Sq
    few = max(2, iters // 10)
    # the library yardstick: SDPA with the expanded bias as a float mask in q's type
    mask = fa.expand_bias(bias, meta, B, H, Sq).to(dtype)
    qh, kh, vh, doh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v, do))
    lib = sdpa_yardstick(torch, qh, kh, vh, mask, doh, scale, iters)
    del mask, qh, kh, vh, doh
    shape = (f"q{tuple(q5.shape)} biases {[tuple(s) for s in EVO_SHAPES[name]['biases']]} -> flat bias "
             f"{tuple(bias.shape)} meta {meta}")
    dq_name = "flash_bwd_dq_collapsed" if collapsed else "flash_bwd_dq (bias)"
    recs = []
    for kernel, e, fn, ref, n_prod, nbytes in (
            ("flash_fwd (bias)", e_fwd, lambda: fa.flash_fwd(q, k, v, *args), lambda: fa.flash_fwd_ref(q, k, v, *args),
             2, 2 * nq + 2 * nk + stats + nb),
            (dq_name, dict(e_dq, **{"dbias_" + key: val for key, val in e_db.items()}), dq_fn, dq_ref_fn, 3,
             3 * nq + 2 * nk + 2 * stats + 2 * nb),
            ("flash_bwd_dkv (bias)", e_dkv, lambda: fa.flash_bwd_dkv(*bwd), lambda: fa.flash_bwd_dkv_ref(*bwd), 4,
             2 * nq + 4 * nk + 2 * stats + nb)):
        flops = 2 * n_prod * D * pairs
        b_ms, b_by = bound(nbytes, flops, dtype)
        parent_ms = parent_time(time_ms, fn, iters)
        fwd = kernel.startswith("flash_fwd")
        rec = dict(kernel=kernel, case=name, dtype=str(dtype), shape=shape, **e, tol=tol, kernel_ms=time_ms(fn, iters),
                   plain_ms=time_ms(ref, few), parent_ms=parent_ms, library_ms=lib["fwd_ms" if fwd else "bwd_ms"],
                   library=f"SDPA {'forward' if fwd else 'backward'}, float attn_mask, backend {lib['backend']}, "
                   f"mask gradient {lib.get('mask_grad')}",
                   bound_bytes=nbytes, bound_flops=flops, bound_ms=b_ms, bound_by=b_by)
        if kernel == dq_name and collapsed:
            rec["repeats_bitwise"] = repeats  # dq and dbias of two launches
        recs.append(rec)
        torch.cuda.empty_cache()
    return recs


def run_evo_kernel_phases(torch, dev, quick: bool):
    records = []
    iters = 5 if quick else 20
    names = ["msa_row"] if quick else list(EVO_SHAPES)
    for dtype in (torch.bfloat16, torch.float32):
        for name in names:
            if str(dtype) not in EVO_SHAPES[name].get("dtypes", (str(dtype),)):
                continue
            for rec in phase_evo_kernels(torch, dev, dtype, name, iters):
                log(rec)
                what, tol = rec["tol"]
                dbias_ok = "dbias_" + what not in rec or rec["dbias_" + what] <= tol
                if not (rec[what] <= tol and dbias_ok and rec.get("lse_max_abs_err", 0.0) <= 1e-4
                        and rec.get("repeats_bitwise", True)):
                    raise AssertionError(f"{rec['kernel']} {rec['dtype']} {rec['case']}: {what} {rec[what]} "
                                         f"(dbias {rec.get('dbias_' + what)}) > {tol}, lse error "
                                         f"{rec.get('lse_max_abs_err')} or dq and dbias not repeatable")
                records.append(rec)
            torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------- MoE grouped GEMM
# Mixtral-8x7B's experts (8 experts, top-2): wi (and wg) 4096 -> 14336, wo 14336 -> 4096. Rows: the
# mixtral_8x7b_8l serve's own steps, a decode step at its bucket of 8 (16 rows) and a 2,048-token prefill
# quantum (4,096 rows); a decode step of 64 tokens (128 rows) and a 768-token quantum (1,536 rows); all routed
# by seeded top-2 draws; then the 64-token step with expert 3 empty, and with every row on one expert (the
# graph warm-up's all-zero inputs)
MOE_E, MOE_D, MOE_F = 8, 4096, 14336
MOE_GEMM_CASES = {
    "decode8_wi": (8, "top2", MOE_D, MOE_F), "decode8_wo": (8, "top2", MOE_F, MOE_D),
    "prefill2048_wi": (2048, "top2", MOE_D, MOE_F), "prefill2048_wo": (2048, "top2", MOE_F, MOE_D),
    "decode_wi": (64, "top2", MOE_D, MOE_F), "decode_wo": (64, "top2", MOE_F, MOE_D),
    "prefill_wi": (768, "top2", MOE_D, MOE_F), "prefill_wo": (768, "top2", MOE_F, MOE_D),
    "decode_wi_empty_expert": (64, "empty3", MOE_D, MOE_F), "decode_wo_one_expert": (64, "one", MOE_F, MOE_D),
}
# tensor parallelism at tp = 2 (serve_tp): each expert's hidden dim halves, wi 4096 -> 7168, wo 7168 -> 4096
MOE_TP_CASES = {
    "tp2_decode8_wi": (8, "top2", MOE_D, MOE_F // 2), "tp2_decode8_wo": (8, "top2", MOE_F // 2, MOE_D),
    "tp2_prefill2048_wi": (2048, "top2", MOE_D, MOE_F // 2), "tp2_prefill2048_wo": (2048, "top2", MOE_F // 2, MOE_D),
}
# the tile sweep's steps (top-2): the serve's buckets of 8, 136, 520 and 2,048 tokens (16, 272, 1,040 and 4,096
# rows; its first steps' routing record), and the 64- and 768-token cases above
MOE_TILE_TOKENS = (8, 64, 136, 520, 768, 2048)


def moe_routing(np, tokens, kind, seed=0):
    """Rows an expert for ``tokens`` tokens of top-2 routing: each token's two
    distinct experts drawn from a seeded generator ("top2"), with expert 3
    never drawn ("empty3"), or every row on expert 5 ("one")."""
    if kind == "one":
        return [2 * tokens if e == 5 else 0 for e in range(MOE_E)]
    rng = np.random.default_rng(seed + tokens)
    pool = [e for e in range(MOE_E) if not (kind == "empty3" and e == 3)]
    counts = [0] * MOE_E
    for _ in range(tokens):
        for e in rng.choice(pool, size=2, replace=False):
            counts[int(e)] += 1
    return counts


def moe_gemm_operands(torch, np, dev, dtype, counts, K, N):
    """Seeded x (R, K), w (E, K, N) and the int32 offsets of ``counts``."""
    R = sum(counts)
    g = torch.Generator(device=dev).manual_seed(R + K + N)
    x = torch.randn((R, K), generator=g, device=dev).to(dtype)
    w = (torch.randn((MOE_E, K, N), generator=g, device=dev) * K**-0.5).to(dtype)
    bounds = np.concatenate([[0], np.cumsum(counts)]).tolist()
    return x, w, torch.tensor(bounds, dtype=torch.int32, device=dev), bounds


def phase_moe_gemm(torch, dev, dtype, name, iters):
    """``moe_grouped_gemm`` against its plain version (each expert's rows
    times its weight in fp32, host sizes). Yardsticks, timed only: one
    ``torch._grouped_mm`` call (bf16, where the card's torch has it: the
    ``library_ms``) and a per-expert ``torch.matmul`` loop with host sizes;
    with --parent the parent's kernel (``parent_ms``). The bound counts x,
    the routed experts' weights and the output once."""
    import numpy as np

    from deepspeed_tpu_torch.device import sm_count
    from deepspeed_tpu_torch.ops import moe_grouped_gemm as mg

    tokens, kind, K, N = {**MOE_GEMM_CASES, **MOE_TP_CASES}[name]
    counts = moe_routing(np, tokens, kind)
    R = sum(counts)
    x, w, offsets, bounds = moe_gemm_operands(torch, np, dev, dtype, counts, K, N)
    got = mg.moe_grouped_gemm(x, w, offsets)
    torch.cuda.synchronize()
    want = mg.moe_grouped_gemm_ref(x, w, offsets)
    err = errors(got, want)
    # fp32: sums of up to 14,336 products in another order than cuBLAS's, held on max(1, max |plain|)
    err["max_abs_err_scaled"] = err["max_abs_err"] / max(1.0, want.float().abs().max().item())
    tol = ("max_abs_err_scaled", 1e-5) if dtype == torch.float32 else TOL[str(dtype)]
    repeat = all(torch.equal(mg.moe_grouped_gemm(x, w, offsets), got) for _ in range(2))
    del want
    item = x.element_size()
    routed = sum(1 for c in counts if c > 0)
    nbytes = (R * K + routed * K * N + R * N) * item
    flops = 2 * R * K * N
    b_ms, b_by = bound(nbytes, flops, dtype)
    few = max(3, iters // 5)
    k_ms = time_ms(lambda: mg.moe_grouped_gemm(x, w, offsets), iters)
    parent_ms = parent_time(time_ms, lambda: mg.moe_grouped_gemm(x, w, offsets), iters)
    p_ms = time_ms(lambda: mg.moe_grouped_gemm_ref(x, w, offsets), few)
    spans = [(e, bounds[e], bounds[e + 1]) for e in range(MOE_E) if bounds[e + 1] > bounds[e]]
    loop_ms = time_ms(lambda: [torch.matmul(x[a:b], w[e]) for e, a, b in spans], iters)
    l_ms = None
    if dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):  # no fp32 mode; ends of the groups as offs
        l_ms = time_ms(lambda: torch._grouped_mm(x, w, offs=offsets[1:]), iters)
    rec = dict(kernel="moe_grouped_gemm", case=name, dtype=str(dtype), shape=f"x({R},{K}) w({MOE_E},{K},{N})",
               rows_per_expert=counts, plan=mg.gemm_plan(R, K, N, MOE_E, dtype, sm_count(dev))._asdict(), **err,
               tol=tol, repeats_bit_for_bit=repeat, kernel_ms=k_ms, parent_ms=parent_ms, plain_ms=p_ms, library_ms=l_ms,
               library="torch._grouped_mm (offs = group ends)" if l_ms is not None else None,
               expert_loop_ms=loop_ms, bound_bytes=nbytes, bound_flops=flops, bound_ms=b_ms, bound_by=b_by)
    if not repeat:
        raise AssertionError(f"moe_grouped_gemm {name} {dtype}: a repeat differs")
    del x, w
    return rec


def phase_moe_plans(torch, dev, rounds: int, iters: int) -> None:
    """The plan's choices on the top-2 steps of ``MOE_TILE_TOKENS`` for wi
    and wo: each bf16 tile body (``GEMM_TILE_ROWS``) as ``gemm_plan`` would
    launch it (key "rows": its split taken only when the routing gives fewer
    tiles than SMs) and, where that plan has a split, with the split forced
    (key "rows x split"), through the wrapper, held to the plain version and
    timed in ``rounds`` turns: each choice's median and spread (max - min)
    of the turns' means, the plan's pick and the fastest."""
    import numpy as np

    from deepspeed_tpu_torch.device import sm_count
    from deepspeed_tpu_torch.ops import moe_grouped_gemm as mg

    what, tol = TOL["torch.bfloat16"]
    sms = sm_count(dev)
    for tokens in MOE_TILE_TOKENS:
        counts = moe_routing(np, tokens, "top2")
        R = sum(counts)
        for proj, (K, N) in (("wi", (MOE_D, MOE_F)), ("wo", (MOE_F, MOE_D))):
            x, w, offsets, _ = moe_gemm_operands(torch, np, dev, torch.bfloat16, counts, K, N)
            pick = mg.gemm_plan(R, K, N, MOE_E, torch.bfloat16, sms)
            plans = {}
            for rows in mg.GEMM_TILE_ROWS:
                own = plans[str(rows)] = mg.gemm_plan(R, K, N, MOE_E, torch.bfloat16, sms, rows=rows)
                if own.split > 1:
                    plans[f"{rows}x{own.split}"] = mg.gemm_plan(R, K, N, MOE_E, torch.bfloat16, sms, rows=rows,
                                                                split=own.split)
            want = mg.moe_grouped_gemm_ref(x, w, offsets)
            errs = {k: errors(mg.moe_grouped_gemm(x, w, offsets, plan=p), want)[what] for k, p in plans.items()}
            del want
            if not all(e <= tol for e in errs.values()):
                raise AssertionError(f"moe_grouped_gemm plans at R {R} {proj}: {what} {errs} > {tol}")
            turns = {k: [] for k in plans}
            for _ in range(rounds):
                for k, p in plans.items():
                    turns[k].append(time_ms(lambda: mg.moe_grouped_gemm(x, w, offsets, plan=p), iters))
            ms = {k: float(np.median(t)) for k, t in turns.items()}
            picked, fastest = str(pick.rows), min(ms, key=ms.get)
            log(dict(phase="moe plans", tokens=tokens, rows=R, proj=proj, rows_per_expert=counts, pick=picked,
                     fastest=fastest, pick_over_fastest=ms[picked] / ms[fastest], median_ms=ms,
                     spread_ms={k: max(t) - min(t) for k, t in turns.items()}, **{what: errs}))
            del x, w
            torch.cuda.empty_cache()


def run_moe_kernel_phases(torch, dev, quick: bool):
    """The grouped GEMM of MoE serving at Mixtral-8x7B's expert shapes, bf16 and fp32, then its plan sweep."""
    iters = 5 if quick else 30
    names = ["decode8_wi"] if quick else list(MOE_GEMM_CASES)
    records = run_cases(torch, [lambda dt, n=n: phase_moe_gemm(torch, dev, dt, n, iters) for n in names])
    phase_moe_plans(torch, dev, 1 if quick else 5, 5 if quick else 10)
    return records


# ---------------------------------------------------------------- step parity
def quantum_inputs(np, rows, n_dec, chunk, bs, P):
    """Flat fused-step operands for rows of (tokens, start, blocks); decode rows
    first (one token; blocks [] marks a padded row on the garbage page)."""
    n_pre = len(rows) - n_dec
    T = n_dec + n_pre * chunk
    ids, pos = np.zeros(T, np.int32), np.zeros(T, np.int32)
    slots = (np.arange(T) % bs).astype(np.int32)  # padding writes the garbage page (block 0)
    bt = np.zeros((len(rows), P), np.int32)
    ctx, last = np.ones(len(rows), np.int32), np.zeros(len(rows), np.int32)
    for r, (toks, start, blocks) in enumerate(rows):
        base = r if r < n_dec else n_dec + (r - n_dec) * chunk
        last[r] = base
        if not blocks:
            continue
        p = start + np.arange(len(toks))
        ids[base:base + len(toks)] = toks
        pos[base:base + len(toks)] = p
        slots[base:base + len(toks)] = np.asarray(blocks)[p // bs] * bs + p % bs
        bt[r, :len(blocks)] = blocks
        ctx[r] = start + len(toks)
        last[r] = base + len(toks) - 1
    return ids, pos, bt, ctx, slots, last


# step-parity tolerances, at about twice the errors measured on an H100 at these
# seeded inputs, which repeat exactly from run to run.
# llama3_8b, dense bf16/fp32 weights and pools: fp32 1.3e-5 on logits and pools;
# bf16 6.3e-2 on logits of size ~5, 4.7e-2 on the pools.
# gpt2_1_3b, int8 weights and int8 pools. The pools are compared dequantised, in
# units of one code step (the largest scale, 0.041); `codes` is the share of pool
# codes that differ. A K/V value that differs in its last bits between the two
# bundles can round to the neighbouring code, and later layers inherit the
# difference. Measured, fp32: logits 1.7e-3 of size ~4.4, pools 1.0007 steps,
# 0.80 % of the codes; bf16 (one bf16 rounding step of a K/V value of size 4 is
# 0.75 of a code step): logits 4.7e-2, pools 1.81 steps, 29.7 % of the codes.
# mixtral_8x7b (every block MoE): a token whose two best gates nearly tie can take another expert in the
# plain run than in the kernel run, and its later layers' K/V then differ at O(1) (measured on an H100, bf16,
# free routing: pools 3.57 with logits 0.064). So the plain run takes the kernel run's routing, call by call,
# and the flips its own gate would have made are printed; the tolerances are then those of the dense model.
STEP_TOL = {
    ("llama3_8b", "torch.float32"): dict(logits=1e-4, pools=1e-4),
    ("llama3_8b", "torch.bfloat16"): dict(logits=0.125, pools=0.1),
    ("gpt2_1_3b", "torch.float32"): dict(logits=3.5e-3, pools_steps=2.0, codes=0.016),
    ("gpt2_1_3b", "torch.bfloat16"): dict(logits=0.1, pools_steps=3.6, codes=0.6),
    ("mixtral_8x7b", "torch.float32"): dict(logits=1e-4, pools=1e-4),
    ("mixtral_8x7b", "torch.bfloat16"): dict(logits=0.125, pools=0.1),
}


def parity_quanta(np, vocab, bs):
    """The two quanta of the step parity (a prefill quantum of three rows, then a mixed one: two decode rows
    padded to the bucket of 8, a fresh chunk and a continued one) over seeded tokens, and the pool's block
    count (block 0 is the garbage page)."""
    rng = np.random.default_rng(0)
    tok = lambda n: rng.integers(0, vocab, n).tolist()  # noqa: E731
    a, b, c, d = tok(512), tok(300), tok(200), tok(500)
    blocks, n_blocks = {}, 1
    for name, n in (("a", 513), ("b", 301), ("c", 200), ("d", 500)):  # final KV lengths
        blocks[name] = list(range(n_blocks, n_blocks + -(-n // bs)))
        n_blocks += len(blocks[name])
    pad = ([0], 0, [])
    quanta = [
        (0, 512, [(a, 0, blocks["a"]), (b, 0, blocks["b"]), (d[:400], 0, blocks["d"])]),
        # mixed: 2 decode rows padded to the bucket of 8, a fresh chunk, and d's
        # second chunk continuing its context at position 400
        (8, 256, [([a[0]], 512, blocks["a"]), ([b[0]], 300, blocks["b"])] + [pad] * 6
         + [(c, 0, blocks["c"]), (d[400:], 400, blocks["d"])]),
    ]
    return quanta, n_blocks


def phase_step_parity(torch, dev, dtype, model="llama3_8b", n_layers=4):
    """The kernel bundle against ``build_modules(plain=True)`` over two quanta:
    llama3_8b dense, gpt2_1_3b with int8 weights and int8 KV pools, or
    Mixtral-8x7B (every block MoE: the grouped GEMM against its plain version)."""
    import numpy as np

    from deepspeed_tpu_torch.inference.quantization import quantize_for_serving
    from deepspeed_tpu_torch.inference.v2.model_runner import fused_forward
    from deepspeed_tpu_torch.inference.v2.modules import build_modules
    from deepspeed_tpu_torch.models import init_params
    from deepspeed_tpu_torch.ops import paged_attention as pa

    quant = model == "gpt2_1_3b"
    geom = GPT2_GEOM if quant else GEOM
    cfg = {"llama3_8b": model_cfg, "gpt2_1_3b": gpt2_cfg, "mixtral_8x7b": mixtral_cfg}[model](n_layers=n_layers,
                                                                                           dtype=dtype)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=dtype)
    if quant:
        params = quantize_for_serving(params, num_bits=8)
    bs, P = geom["bs"], geom["P"]
    quanta, n_blocks = parity_quanta(np, cfg.vocab_size, bs)
    shape = (cfg.n_layers, n_blocks, bs, cfg.kv_heads, cfg.head_dim)
    kvq = 8 if quant else 0
    pools = {v: (pa.make_kv_pool(shape, dtype, dev, kvq), pa.make_kv_pool(shape, dtype, dev, kvq))
             for v in ("kernel", "plain")}
    mods = {"kernel": build_modules(), "plain": build_modules(plain=True)}
    tol = STEP_TOL[(model, str(dtype))]
    moe = cfg.moe_num_experts > 0
    live = lambda pool: tuple(t[:, 1:] for t in pool) if quant else pool[:, 1:].float()  # without the garbage page
    out = []
    for n_dec, chunk, rows in quanta:
        args = [torch.from_numpy(x).to(dev) for x in quantum_inputs(np, rows, n_dec, chunk, bs, P)]
        ids, pos, bt, ctx, slots, last = args
        logits, routes = {}, {}
        for v in ("kernel", "plain"):
            kp, vp = pools[v]
            # MoE: the plain run takes the kernel run's routing (see STEP_TOL), and counts its own flips
            with route_log(pin=routes["kernel"].routes if v == "plain" else None) if moe else \
                    contextlib.nullcontext() as routes[v]:
                logits[v], _, _ = fused_forward(cfg, params, ids, pos, kp, vp, bt, ctx, slots, last, n_dec=n_dec,
                                                chunk=chunk, mods=mods[v])
        torch.cuda.synchronize()
        real = [r for r, (_, _, blk) in enumerate(rows) if blk]
        l_err = (logits["kernel"][real] - logits["plain"][real]).abs().max().item()
        agree = (logits["kernel"][real].argmax(-1) == logits["plain"][real].argmax(-1)).float().mean().item()
        rec = dict(phase="step_parity", model=model, weights="int8" if quant else str(dtype),
                   kv_pool="int8" if quant else str(dtype), dtype=str(dtype), n_layers=n_layers, n_dec=n_dec,
                   chunk=chunk, rows=len(rows), logits_max_abs_err=l_err,
                   logits_max_abs=logits["plain"][real].abs().max().item(), argmax_agree=agree, tol=tol)
        if moe:  # real tokens' routings over the MoE layers, and those the plain run's own gate would change
            real_tok = torch.zeros(ids.shape[0], dtype=torch.bool)
            for r, (toks, _, blk) in enumerate(rows):
                base = r if r < n_dec else n_dec + (r - n_dec) * chunk
                real_tok[base:base + len(toks)] = bool(blk)
            flipped = routes["plain"].flipped
            rec.update(routing="pinned to the kernel run's", routed_tokens=int(real_tok.sum()) * len(flipped),
                       routing_flips=sum(int((f & real_tok).sum()) for f in flipped))
        if quant:
            got, want = ([live(pools[v][i]) for i in (0, 1)] for v in ("kernel", "plain"))
            rec["pools_max_abs_err"] = max((pa.dequantize_kv(a) - pa.dequantize_kv(b)).abs().max().item()
                                           for a, b in zip(got, want))
            rec["pools_step"] = max(b[1].max().item() for b in want)  # the largest scale: one code step
            rec["codes_differ_share"] = max((a[0] != b[0]).float().mean().item() for a, b in zip(got, want))
            pools_ok = (rec["pools_max_abs_err"] <= tol["pools_steps"] * rec["pools_step"]
                        and rec["codes_differ_share"] <= tol["codes"])
        else:
            rec["pools_max_abs_err"] = max((live(pools["kernel"][i]) - live(pools["plain"][i])).abs().max().item()
                                           for i in (0, 1))
            pools_ok = rec["pools_max_abs_err"] <= tol["pools"]
        log(rec)
        if not (l_err <= tol["logits"] and pools_ok and torch.isfinite(logits["kernel"]).all()):
            raise AssertionError(f"step parity failed: {rec}")
        out.append(rec)
    del params, pools
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- serving run
def serving_prompts(np, vocab, longest=1500):
    """Twelve seeded prompts in two waves; three share a 256-token prefix.
    ``longest`` scales the lengths to a model's context (960 for gpt2_1_3b)."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, 256).tolist()
    lens = [16, 1500, 300, 64, 700, 1100, 40, 900, 128, 1300, 512, 200]
    if longest != 1500:
        lens = [n if n <= 300 else n * longest // 1500 for n in lens]
    prompts = [rng.integers(0, vocab, n).tolist() for n in lens]
    for i in (2, 7, 10):  # share a 256-token prefix (two full 128-token blocks)
        prompts[i] = shared + prompts[i][256:]
    return prompts[:6], prompts[6:]


def profiled(torch, fn, cats) -> dict:
    """Run ``fn`` once under torch.profiler and return its wall time and the
    device time of its kernels by category (``cats``: category -> substrings
    of kernel names; the rest is "other"), with the 15 longest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return session_device_time(prof, cats, wall_ms)


def session_device_time(prof, cats, wall_ms) -> dict:
    """``profiled()``'s account of a finished torch.profiler session: the summed device time of its kernels
    (``key_averages``) by category, over ``wall_ms``. ``record_function`` ranges (spans mirrored into the
    trace, the device profiler's markers) also carry the device time of the kernels under them: not counted."""
    from torch.autograd import DeviceType

    by_cat, top = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False) or SPAN_NAME.match(e.key):
            continue
        ms = (getattr(e, "self_device_time_total", 0) or getattr(e, "device_time_total", 0)) / 1e3
        if ms <= 0:
            continue
        cat = next((c for c, keys in cats.items() if any(k in e.key for k in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        top.append((ms, e.count, e.key[:100]))
    busy = sum(by_cat.values())
    top.sort(reverse=True)
    return dict(wall_ms_profiled=wall_ms, device_busy_ms=busy if top else "not measured",
                busy_share=busy / wall_ms if top else "not measured", by_category_ms=by_cat,
                top=[dict(ms=t, calls=c, name=n) for t, c, n in top[:15]])


MATMUL = ("gemm", "cutlass", "xmma", "nvjet", "cublas")
SPAN_NAME = re.compile(r"^(ds_tpu_|[a-z0-9_]+/[a-z0-9_/]+$)")  # telemetry spans and profiler markers


def profile_serve(torch, engine, waves, model, dispatch="graphs") -> None:
    """Device-time breakdown of the serving waves under torch.profiler: a
    separate pass after the timed one, with the prefix cache reset first so
    that it repeats the same admissions. Profiling slows the host, so only
    the shares are meant to be read, not the pass's wall time. ``dispatch``
    names the engine's step mode (``_eager_steps``) during the pass."""
    engine.state.reset_prefix_cache()

    def run():
        for wave in waves:
            engine.generate(wave, max_new_tokens=32)

    # paged_decode_kernel (bf16) and decode_kernel (fp32); a combine of split partials counts as decode
    cats = {"paged_attention_decode": ("decode_kernel", "paged_combine_kernel"),
            "paged_attention_prefill": ("prefill_kernel",),
            # layer_norm by this tree's and a --parent tree's kernel names: a bare "layer_norm" also matches
            # PyTorch's vectorized_layer_norm_kernel
            "rms_norm": ("rms_norm",),
            "layer_norm": ("layer_norm_rows", "layer_norm_general", "layer_norm_vec", "layer_norm_plain"),
            "quantized_matmul": ("qmm_",), "moe_grouped_gemm": ("gg_wgmma_kernel", "gg_bf16_kernel", "gg_fp32_kernel"),
            "matmul": MATMUL, "copy": ("Memcpy", "Memset")}
    log(dict(phase="profile", model=model, dispatch=dispatch, **profiled(torch, run, cats)))


# The serving runs: the longest prompt, max_context, the engine's quantisation fields, and the kernel
# launches per forward that the model's structure fixes
SERVE_RUNS = {
    # the main path; its waves are served again with each step eager (the parent's dispatch) and on graphs
    "llama3_8b": dict(longest=1500, max_context=8192, quant={}, per_forward={"rms_norm": 65},
                      compare_eager=(True, False, False, True)),
    # the same with DS_TPU_PROGRAM_CACHE=16, above the 11 graphs the waves take (8, the default, re-captures):
    # after the first run every step is a replay
    "llama3_8b_cache16": dict(longest=1500, max_context=8192, quant={}, per_forward={"rms_norm": 65},
                              compare_eager=(True, False, False, True), program_cache=16),
    # the same waves through the unfused loop: a prefill step per chunk bucket, a decode step, bursts; served
    # again with eager steps
    "llama3_8b_unfused": dict(longest=1500, max_context=8192, quant=dict(fused_step=False),
                              per_forward={"rms_norm": 65}, compare_eager=(True,)),
    # 24 layers x (2 norms; q, k, v, o, up, down) + the final norm; the tied head stays a dense product
    "gpt2_1_3b_w8_kv8": dict(longest=960, max_context=1024, quant=dict(quant_bits=8, kv_quant_bits=8),
                             per_forward={"layer_norm": 49, "quantized_matmul": 144}),
    # 32 layers x (2 norms; q, k, v, o, gate, up, down) + the final norm and the untied head
    "llama3_8b_w4": dict(longest=1500, max_context=8192, quant=dict(quant_bits=4),
                         per_forward={"rms_norm": 65, "quantized_matmul": 225}),
    # ALiBi serving: BLOOM-7b1's widths cut to 4 layers; 4 x 2 norms + the embedding norm + the final norm;
    # its 2,048 positions bound max_context
    "bloom_7b1_alibi_4l": dict(cfg=lambda: bloom_cfg(n_layers=4), longest=1500, max_context=2048, quant={},
                               per_forward={"layer_norm": 10}, compare_eager=(True, False)),
    # sliding-window serving: Mistral-7B-v0.1's widths cut to 4 layers, window 4,096; prompts up to 6,000
    # tokens, so that the window masks
    "mistral_7b_swa_4l": dict(cfg=lambda: mistral_cfg(n_layers=4), longest=6000, max_context=8192, quant={},
                              per_forward={"rms_norm": 9}, compare_eager=(True, False)),
    # MoE serving: Mixtral-8x7B-v0.1's widths cut to 8 layers (the 32 hold 46.7 B parameters, 93 GB in bf16,
    # more than one card); 8 x 2 norms + the final norm, 8 x 3 grouped products (wi, wg, wo)
    "mixtral_8x7b_8l": dict(cfg=lambda: mixtral_cfg(n_layers=8), longest=1500, max_context=8192, quant={},
                            per_forward={"rms_norm": 17, "moe_grouped_gemm": 24}, compare_eager=(True, False)),
    # Hugging Face checkpoints (serve_hf; the model comes from the directory): phi-2, one layernorm a block
    # (parallel_shared) and the final one, paged attention at D 80; gemma-2b, 18 x 2 RMSNorms + the final one,
    # D 256 on one KV head (G 8); falcon-7b's widths at 4 layers, 71 query heads on one KV head
    "phi_2": dict(hf=True, longest=1500, max_context=2048, quant={}, per_forward={"layer_norm": 33},
                  compare_eager=(True, False), program_cache=16),
    "gemma_2b": dict(hf=True, longest=1500, max_context=8192, quant={}, per_forward={"rms_norm": 37},
                     compare_eager=(True, False), program_cache=16),
    "falcon_7b_4l": dict(hf=True, longest=1500, max_context=2048, quant={}, per_forward={"layer_norm": 5}),
}


def bloom_cfg(**kw):
    """BLOOM-7b1 (bigscience/bloom-7b1 config.json): 30 layers, d 4096, 32 heads, vocab 250,880, ALiBi,
    LayerNorm with an embedding norm, tanh GELU, tied embeddings, 2,048 positions; fields replaced by ``kw``."""
    from deepspeed_tpu_torch.models import TransformerConfig

    fields = dict(vocab_size=250880, n_layers=30, n_heads=32, d_model=4096, max_seq_len=2048, norm="layernorm",
                  activation="gelu", pos_emb="alibi", embedding_norm=True, tie_embeddings=True)
    return TransformerConfig(**{**fields, **kw})


def mistral_cfg(**kw):
    """Mistral-7B-v0.1 (mistralai/Mistral-7B-v0.1 config.json): 32 layers, d 4096, 32/8 heads, d_ff 14,336,
    vocab 32,000, rope theta 1e4, sliding window 4,096, 32,768 positions; fields replaced by ``kw``."""
    from deepspeed_tpu_torch.models import TransformerConfig

    fields = dict(vocab_size=32000, n_layers=32, n_heads=32, n_kv_heads=8, d_model=4096, d_ff=14336,
                  max_seq_len=32768, norm="rmsnorm", activation="swiglu", pos_emb="rope", rope_theta=10000.0,
                  sliding_window=4096, tie_embeddings=False)
    return TransformerConfig(**{**fields, **kw})


def mixtral_cfg(**kw):
    """Mixtral-8x7B-v0.1 (mistralai/Mixtral-8x7B-v0.1 config.json): 32 layers, d 4096, 32/8 heads, d_ff 14,336,
    8 experts, top-2, every block MoE, vocab 32,000, RMSNorm eps 1e-5, rope theta 1e6, 32,768 positions, no
    window, untied head, router aux loss 0.02; fields replaced by ``kw``."""
    from deepspeed_tpu_torch.models import TransformerConfig

    fields = dict(vocab_size=32000, n_layers=32, n_heads=32, n_kv_heads=8, d_model=4096, d_ff=14336,
                  max_seq_len=32768, norm="rmsnorm", norm_eps=1e-5, activation="swiglu", pos_emb="rope",
                  rope_theta=1e6, tie_embeddings=False, moe_num_experts=8, moe_top_k=2, moe_layer_freq=1,
                  moe_aux_loss_coef=0.02)
    return TransformerConfig(**{**fields, **kw})


class route_log:
    """Wraps ``modules.moe_route`` over the enclosed eager steps (it syncs):
    records each MoE call's routing (weights, experts, order, offsets) in
    ``routes``, and in ``live`` which of its tokens are real: those whose KV
    slot lies outside the engine's garbage block 0 (``model_runner._run_stack``
    wrapped too, for the step's slot mapping; ``block_size`` the pool's). With
    ``pin`` (another log's routes) each call returns the pinned routing of the
    same call instead of its own, and ``flipped`` holds per call the tokens
    whose own top-k set differs from the pinned one."""

    def __init__(self, pin=None, block_size=1):
        from deepspeed_tpu_torch.inference.v2 import model_runner, modules

        self.modules, self.runner, self.pin, self.block_size = modules, model_runner, pin, block_size
        self.routes, self.live, self.flipped, self._live = [], [], [], None

    def rows(self, live_only=True):
        """Rows each expert took, per call: of the real tokens only, or
        (``live_only=False``) of every token of the bucket, padding included."""
        if not live_only:
            return [r[3].diff().tolist() for r in self.routes]
        return [r[1][m].reshape(-1).bincount(minlength=r[3].numel() - 1).tolist()
                for r, m in zip(self.routes, self.live)]

    def __enter__(self):
        inner, stack = self._inner, self._stack = self.modules.moe_route, self.runner._run_stack

        def stack_spy(cfg, params, x, k_pages, v_pages, block_tables, ctx_lens, slot_mapping, *a, **kw):
            self._live = slot_mapping.reshape(-1) >= self.block_size
            return stack(cfg, params, x, k_pages, v_pages, block_tables, ctx_lens, slot_mapping, *a, **kw)

        def spy(cfg, p, tokens):
            out = inner(cfg, p, tokens)
            self.routes.append(tuple(t.clone() for t in out))
            self.live.append(self._live.clone())
            if self.pin is None:
                return out
            pinned = self.pin[len(self.routes) - 1]
            self.flipped.append((out[1].sort(-1).values != pinned[1].sort(-1).values).any(-1).cpu())
            return pinned

        self.modules.moe_route, self.runner._run_stack = spy, stack_spy
        return self

    def __exit__(self, *exc):
        self.modules.moe_route, self.runner._run_stack = self._inner, self._stack
        return False


def tree_bytes(tree) -> int:
    """Bytes the parameter tree holds on the device (quantised leaves: codes + scales)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if hasattr(tree, "nbytes_quantized"):
        return tree.nbytes_quantized
    return tree.numel() * tree.element_size()


def graph_counts(engine) -> dict:
    """The engine's step counters (``dispatches``: graph replays or eager
    step calls; ``fused_quanta``) and its graph cache's."""
    g = engine.graphs
    return dict(dispatches=engine.dispatches, quanta=engine.fused_quanta, graph_replays=g.replays,
                captures=g.captures, capture_s=g.capture_s, evictions=g.evictions)


def counts_since(engine, before: dict) -> dict:
    return {k: v - before[k] for k, v in graph_counts(engine).items()}


def dispatch_ab(torch, engine, waves, want, turns) -> dict:
    """The serving waves again, with each step replayed from its graph and with
    each step run eagerly (``_eager_steps``: the parent's dispatch), in
    ``turns`` (True: eager), the prefix cache reset before each: the tokens/s
    of each and the graphs' captures; every run's tokens must equal
    ``want``, the first run's."""
    runs = []
    for eager in turns:
        engine.state.reset_prefix_cache()
        engine._eager_steps = eager
        before = graph_counts(engine)
        t0 = time.perf_counter()
        out = [t for wave in waves for t in engine.generate(wave, max_new_tokens=32)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if out != want:
            raise AssertionError(f"serve: the {'eager' if eager else 'graph'} steps' tokens differ from the first run's")
        runs.append(dict(dispatch="eager" if eager else "graphs", wall_s=wall,
                         tokens_per_s=sum(len(o) for o in out) / wall, **counts_since(engine, before)))
    engine._eager_steps = False
    return dict(runs=runs, tokens_equal=True)


def agreement(out, other) -> dict:
    """How far two runs' tokens agree: equal tokens, equal requests, and each
    request's first differing position (None where all agree)."""
    first = [next((i for i, (a, b) in enumerate(zip(o, w)) if a != b), None) for o, w in zip(out, other)]
    return dict(equal_tokens=sum(a == b for o, w in zip(out, other) for a, b in zip(o, w)),
                tokens=sum(len(w) for w in other), equal_requests=first.count(None), first_difference=first)


def phase_serve(torch, dev, counters, run="llama3_8b", profile=False, want=None, beside=None, keep_params=False,
                hf_dir=None):
    """One serving run through ``InferenceEngineV2.generate``: the counters in
    ``counters`` are zeroed just before the two waves and read just after.
    Each step replays its bucket's CUDA graph: the graph replays must equal
    the steps (and the fused quanta), and the captures and their seconds are
    printed. ``want``: tokens the run must give; ``beside``: tokens it is
    compared with and the agreement printed (the unfused loop's bf16 products
    have other row counts than the fused loop's, so they round otherwise).
    ``keep_params``: the record keeps the engine's weights (``params``) for
    the next phase, which then needs no set-up of its own. ``hf_dir``: a
    Hugging Face directory whose model and weights ``load_hf_checkpoint``
    loads in bf16 (the record holds its load seconds by step)."""
    import numpy as np

    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.models import init_params
    from deepspeed_tpu_torch.ops.paged_attention import kv_pool_is_quantized

    spec = SERVE_RUNS[run]
    load = {}
    if hf_dir is not None:
        model, params, load = hf_load(torch, hf_dir, torch.bfloat16, dev)
        cfg, init_s = model.cfg, load["load_s"]
    else:
        cfg = spec["cfg"]() if "cfg" in spec else gpt2_cfg() if run.startswith("gpt2") else model_cfg()
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
    bf16_weight_bytes = tree_bytes(params)
    t0 = time.perf_counter()
    with program_cache(spec.get("program_cache")):
        engine = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            state_manager=RaggedBatchConfig(max_context=spec["max_context"], kv_block_size=128, memory_gb=8.0),
            dtype="bfloat16", device=str(dev), **spec["quant"]))
    fused = engine._fused_enabled
    del params  # a quantised engine holds codes and scales only: let the bf16 kernels go
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    engine_s = time.perf_counter() - t0
    hits = []
    admit = engine.state.admit_sequence

    def admit_spy(uid, tokens):
        seq = admit(uid, tokens)
        hits.append(seq.seen_tokens)
        return seq

    engine.state.admit_sequence = admit_spy
    wave1, wave2 = serving_prompts(np, cfg.vocab_size, spec["longest"])
    engine.generate([wave1[0][:32]], max_new_tokens=4)  # warm-up: cuBLAS handles, allocator (not counted)
    torch.cuda.synchronize()
    hits.clear()
    torch.cuda.reset_peak_memory_stats()
    before = graph_counts(engine)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    out = engine.generate(wave1, max_new_tokens=32) + engine.generate(wave2, max_new_tokens=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    steps = counts_since(engine, before)
    n_out = sum(len(o) for o in out)
    slot_heads = 2 * cfg.n_layers * 128 * cfg.kv_heads  # K and V entries of one block, all layers
    int8_pool = kv_pool_is_quantized(engine.k_pages)
    rec = dict(phase="serve", run=run, model=run.split("_w")[0], layers=cfg.n_layers, d_model=cfg.d_model,
               dtype="bfloat16", quant_bits=spec["quant"].get("quant_bits", 0),
               kv_quant_bits=8 if int8_pool else 0, prompts=len(out),
               prompt_tokens=sum(len(p) for p in wave1 + wave2), new_tokens=n_out,
               wall_s=wall, tokens_per_s=n_out / wall, weights_init_s=init_s, engine_init_s=engine_s,
               kv_blocks=engine._n_kv_blocks, weight_bytes=tree_bytes(engine.params),
               weight_bytes_bf16=bf16_weight_bytes,
               kv_block_bytes=slot_heads * ((cfg.head_dim + 4) if int8_pool else cfg.head_dim * 2),
               kv_block_bytes_bf16=slot_heads * cfg.head_dim * 2,
               prefix_hit_tokens=sum(hits), max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches, forwards=launches[next(iter(spec["per_forward"]))] / next(iter(
                   spec["per_forward"].values())), loop="fused" if fused else "unfused", **steps,
               graphs_live=len(engine.graphs), program_cache=engine._max_program_variants,
               **({"source": HF_CONFIGS[run][0], "heads": [cfg.n_heads, cfg.kv_heads, cfg.head_dim], "load": load}
                  if hf_dir is not None else {}))
    log(rec)
    if steps["graph_replays"] != steps["dispatches"] or (fused and steps["quanta"] != steps["dispatches"]):
        raise AssertionError(f"serve {run}: {steps['graph_replays']} graph replays, {steps['dispatches']} steps, "
                             f"{steps['quanta']} fused quanta: each step must be one replay"
                             + (" and each quantum one step" if fused else ""))
    if want is not None and out != want:
        raise AssertionError(f"serve {run}: tokens differ from the wanted run's: {agreement(out, want)}")
    if beside is not None:
        log(dict(phase="serve agreement", run=run, beside="llama3_8b (fused loop)", **agreement(out, beside)))
    if not all(len(o) == 32 and all(0 <= t < cfg.vocab_size for t in o) for o in out):
        raise AssertionError(f"serve {run}: a request did not get 32 in-vocab tokens")
    if sum(hits) == 0:
        raise AssertionError(f"serve {run}: the prefix cache was never hit")
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"serve {run}: kernels never launched on the main path: {missing}")
    # the model's structure fixes the launches of each forward: every such counter gives the same number
    # of forwards, and each forward launches the decode kernel, the prefill kernel or both in each layer
    n_fwd = rec["forwards"]
    paged = launches["paged_attention_decode"] + launches["paged_attention_prefill"]
    if (n_fwd != int(n_fwd) or any(launches[name] != n * n_fwd for name, n in spec["per_forward"].items())
            or not cfg.n_layers * n_fwd <= paged <= 2 * cfg.n_layers * n_fwd):
        raise AssertionError(f"serve {run}: launches {launches} do not fit {spec['per_forward']} per forward "
                             f"and {cfg.n_layers} layers")
    if spec.get("compare_eager"):
        rec = dict(rec, dispatch_ab=dispatch_ab(torch, engine, (wave1, wave2), out, spec["compare_eager"]))
        log(dict(phase="serve dispatch", run=run, **rec["dispatch_ab"]))
    if cfg.moe_num_experts > 0:
        # the rows each expert takes in every layer of the first step (a prefill quantum of wave 1) and of the
        # last (a decode step), from an eager pass of wave 1 with 4 new tokens after the timed runs: of the real
        # tokens (padding rows of the bucket apart), beside each step's rows in the bucket and of real tokens,
        # and the tokens the pass generated
        engine.state.reset_prefix_cache()
        engine._eager_steps = True
        with route_log(block_size=engine.state.block_size) as spy:
            out4 = engine.generate(wave1, max_new_tokens=4)
        engine._eager_steps = False
        L, rows = cfg.n_layers, spy.rows()
        rec["expert_rows"] = dict(first_step=rows[:L], last_step=rows[-L:],
                                  bucket_rows=[sum(r) for r in spy.rows(live_only=False)[::L]],
                                  live_rows=[sum(r) for r in rows[::L]],
                                  new_tokens=out4)
        log(dict(phase="serve routing", run=run, steps=len(rows) // L, **rec["expert_rows"]))
    if profile:
        profile_serve(torch, engine, (wave1, wave2), run)
        if spec.get("compare_eager") and fused:
            engine._eager_steps = True
            profile_serve(torch, engine, (wave1, wave2), run, dispatch="eager")
    rec["params"] = engine.params if keep_params else None
    del engine
    gc.collect()  # the engine's closures form cycles: free its pools and weights before the next phase
    torch.cuda.empty_cache()
    rec["tokens"] = out
    return rec


# The SLA load: 24 requests a row, each a shared 256-token system prompt and a tail of 16-1,500 tokens,
# 32 new tokens, greedy; a row with every arrival at t = 0, then Poisson rows at fractions of its requests/s
# (fewer requests save no time: the Poisson rows' rates fall with the first row's, so their arrivals span as long)
SLA_SPEC = dict(n_requests=24, prompt_len_range=(16, 1500), max_new_tokens=32, shared_prefix_len=256, seed=0)
SLA_FRACTIONS = (0.25, 0.5, 0.75)


def phase_sla(torch, dev, counters):
    """``sla.run_load`` on llama3_8b at full size (bf16, the serve run's engine
    configuration, random weights from seed 0): the saturation row, then the
    rows of ``SLA_FRACTIONS``, the prefix cache reset before each row; each
    row's tokens/s, TTFT and TPOT percentiles and SLA misses, and
    ``effective_throughput_at_sla`` at the FastGen SLA (TTFT 1 s, TPOT
    250 ms). Every request must get its 32 in-vocab tokens and every kernel
    in ``counters`` must launch in each row."""
    import dataclasses

    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2 import sla
    from deepspeed_tpu_torch.models import init_params

    cfg = model_cfg()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.bfloat16)
    engine = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
        state_manager=RaggedBatchConfig(max_context=8192, kv_block_size=128, memory_gb=8.0), dtype="bfloat16",
        device=str(dev)))
    del params
    base = sla.LoadSpec(vocab_size=cfg.vocab_size, **SLA_SPEC)
    engine.generate([sla.load_prompts(base)[1][0][:32]], max_new_tokens=4)  # warm-up, as in serve
    torch.cuda.synchronize()
    rows = []

    def row(rate: float) -> dict:
        engine.state.reset_prefix_cache()
        before = graph_counts(engine)
        for fn in counters:
            fn.launches = 0
        stats = sla.run_load(engine, dataclasses.replace(base, arrival_rate=rate))
        torch.cuda.synchronize()
        rec = dict(phase="sla", model="llama3_8b", arrival_rate=rate, **sla.summarize(stats),
                   launches={fn.__name__: fn.launches for fn in counters}, **counts_since(engine, before))
        log(rec)
        if not all(s.n_new == base.max_new_tokens and all(0 <= t < cfg.vocab_size for t in s.tokens)
                   for s in stats):
            raise AssertionError(f"sla at {rate} requests/s: a request did not get {base.max_new_tokens} "
                                 "in-vocab tokens")
        if any(n <= 0 for n in rec["launches"].values()) or rec["graph_replays"] != rec["dispatches"]:
            raise AssertionError(f"sla at {rate} requests/s: launches {rec['launches']}, {rec['graph_replays']} "
                                 f"replays for {rec['dispatches']} steps")
        rows.append(rec)
        return rec

    saturated = row(float("inf"))["requests_per_sec"]
    for frac in SLA_FRACTIONS:
        row(frac * saturated)
    out = dict(phase="sla", effective_throughput_at_sla=sla.effective_throughput_at_sla(rows), ttft_sla_s=1.0,
               tpot_sla_s=0.25, max_miss=0.01, rates=[r["arrival_rate"] for r in rows])
    log(out)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- the host spill tier and the journal
# The spill traffic at full width: wave A is 16 requests on 4 shared prefixes (each with a 64-token suffix of its
# own), wave B 16 unrelated prompts of the prefix's length that need the pool, then wave A again; 32 new tokens a
# request. Per model: ``prefix`` (its longest prompts: llama3_8b 1,024 tokens, gpt2_1_3b 768 of its 1,024
# context), ``blocks`` (a pool that wave B fills past A's cached prefixes, so that they spill: llama3_8b's wave B
# holds up to 16 x 9 blocks beside A's 32), ``big`` (a pool that keeps them in HBM) and ``host_blocks`` (the host
# pool, sized to hold A's prefixes and what wave A's third pass spills of B's)
SPILL_RUNS = {
    "llama3_8b": dict(prefix=1024, blocks=140, big=400, host_blocks=160, max_context=8192, quant={}),
    "gpt2_1_3b_w8_kv8": dict(prefix=768, blocks=104, big=320, host_blocks=160, max_context=1024,
                             quant=dict(quant_bits=8, kv_quant_bits=8)),
}
SPILL_SUFFIX, SPILL_NEW, SPILL_PROGRAM_CACHE = 64, 32, 32
SPILL_COUNTERS = ("kv_spill_blocks_total", "kv_readmit_total", "kv_prefix_hit_tokens_total",
                  "infer_prefill_tokens_total")
# the recorded SLA row of the journal phase: every arrival at t = 0 (the logical clock then replays it exactly)
JOURNAL_SLA = dict(n_requests=8, arrival_rate=float("inf"), prompt_len_range=(16, 512), max_new_tokens=16,
                   shared_prefix_len=256, seed=0)


@contextlib.contextmanager
def env_set(values):
    """Environment knobs set while the enclosed code runs (an engine reads its knobs when it is built)."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def spill_waves(np, vocab, prefix):
    """Wave A (16 prompts: 4 shared prefixes of ``prefix`` tokens, each with its own 64-token suffix) and
    wave B (16 unrelated prompts of ``prefix`` tokens), seeded."""
    rng = np.random.default_rng(1)
    shared = [rng.integers(0, vocab, prefix).tolist() for _ in range(4)]
    wave_a = [shared[i % 4] + rng.integers(0, vocab, SPILL_SUFFIX).tolist() for i in range(16)]
    wave_b = [rng.integers(0, vocab, prefix).tolist() for _ in range(16)]
    return wave_a, wave_b


def spill_block_bytes(cfg, int8: bool) -> int:
    """K and V bytes of one 128-token block over every layer (int8: codes and fp32 scales)."""
    return 2 * cfg.n_layers * 128 * cfg.kv_heads * ((cfg.head_dim + 4) if int8 else cfg.head_dim * 2)


def spill_engine(dev, cfg, params, run, blocks, spill):
    """An engine of the spill phase: ``blocks`` KV blocks of 128 tokens, the host tier on or off (its pool
    holding ``host_blocks``), graphs for every key of the phase (``SPILL_PROGRAM_CACHE``)."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig

    spec = SPILL_RUNS[run]
    host_mb = -(-spec["host_blocks"] * spill_block_bytes(cfg, bool(spec["quant"])) // 2**20)
    with env_set({"DS_TPU_KV_HOST_POOL_MB": host_mb, "DS_TPU_PROGRAM_CACHE": SPILL_PROGRAM_CACHE}):
        return InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            state_manager=RaggedBatchConfig(max_context=spec["max_context"], kv_block_size=128, num_kv_blocks=blocks),
            dtype="bfloat16", device=str(dev), kv_spill=spill, **spec["quant"]))


def free_engine(torch) -> None:
    """Free a dropped engine's pools before the next engine is built."""
    gc.collect()  # the engine's closures form cycles
    torch.cuda.empty_cache()


def pinned_copy_gbps(torch, dev, nbytes: int, n: int) -> dict:
    """A plain pinned ``copy_`` of ``n`` blocks of ``nbytes``: d2h and h2d GB/s (CUDA events, warm)."""
    host = torch.empty(n, nbytes, dtype=torch.uint8, pin_memory=True)
    src = torch.empty(n, nbytes, dtype=torch.uint8, device=dev)
    out = {}
    for name, copy in (("d2h", lambda i: host[i].copy_(src[i], non_blocking=True)),
                       ("h2d", lambda i: src[i].copy_(host[i], non_blocking=True))):
        copy(0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            copy(i)
        end.record()
        end.synchronize()
        out[f"plain_{name}_gb_per_s"] = n * nbytes / (start.elapsed_time(end) * 1e-3) / 1e9
    return out


def record_journal(directory):
    """A journal as ``DS_TPU_JOURNAL=1`` with ``DS_TPU_JOURNAL_DIR=directory`` makes it (the process's
    journal is resolved again from the knobs)."""
    from deepspeed_tpu_torch.telemetry import journal as jmod

    with env_set({"DS_TPU_JOURNAL": 1, "DS_TPU_JOURNAL_DIR": directory}):
        jmod._JOURNAL, jmod._RESOLVED = None, False
        return jmod.get_journal()


def timed_pass(torch, engine, wave, reg, evict=False) -> dict:
    """One pass of ``wave`` (``evict``: every cached block evicted first, untimed): wall time, tokens/s, the
    deltas of ``SPILL_COUNTERS`` and of the engine's step and graph counters, the cache's state after, and
    the tokens."""
    pc = engine.state.prefix_cache
    if evict:
        pc.evict(engine.state.total_blocks)
        torch.cuda.synchronize()
    before = [reg.peek(n) or 0.0 for n in SPILL_COUNTERS]
    g0 = graph_counts(engine)
    t0 = time.perf_counter()
    got = engine.generate(wave, max_new_tokens=SPILL_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = dict(zip(SPILL_COUNTERS, ((reg.peek(n) or 0.0) - b for n, b in zip(SPILL_COUNTERS, before))))
    return dict(wall_s=wall, tokens_per_s=len(got) * SPILL_NEW / wall, **delta, **counts_since(engine, g0),
                spilled_blocks=pc.spilled_blocks, cached_blocks=pc.cached_blocks,
                free_blocks=engine.state.free_blocks, tokens=got)


def timed_evict(torch, engine, block_bytes) -> dict:
    """A forced evict of every cached block on a spill engine: the blocks spilled, the seconds to issue their
    snapshots and copies and to wait for the landings (``SpillManager.wait_all``), and the spill path's d2h
    GB/s over the whole evict."""
    mgr = engine._spill_mgr
    inner, waits = mgr.wait_all, []

    def timed_wait(timeout=60.0):
        t = time.perf_counter()
        inner(timeout)
        waits.append(time.perf_counter() - t)

    mgr.wait_all = timed_wait
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = engine.state.prefix_cache.evict(engine.state.total_blocks)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del mgr.wait_all
    return dict(blocks=n, seconds=seconds, wait_seconds=sum(waits), issue_seconds=seconds - sum(waits),
                d2h_gb_per_s=n * block_bytes / seconds / 1e9)


def phase_serve_spill(torch, dev, counters, run, params=None, journal_dir=None):
    """The host spill tier at full width (``SPILL_RUNS[run]``, bf16, random weights from seed 0, or
    ``params``): wave A, wave B, wave A again on three engines built in turn: ``spill`` (a pool that wave B
    fills, the host tier on: A's cached prefixes spill through the allocator's eviction hook and the watermark,
    and the third pass re-admits them), ``no_spill`` (the same pool, the tier off: the third pass prefills them
    again) and ``big_pool`` (A's prefixes stay in HBM). On each the counters are zeroed before the first pass
    and read after the third, and a fourth pass of wave A runs warm (its graphs captured by the third): after a
    forced evict on ``spill`` (the chains re-admitted) and ``no_spill`` (prefilled again), straight on
    ``big_pool`` (in HBM). On ``spill`` every block the third pass re-admits is held to its pages before wave B
    (``torch.equal``, every pool leaf); the third and fourth passes must prefill only the suffixes and re-admit
    every block of the four chains; the third pass's tokens must equal ``big_pool``'s; the fourth pass must take
    no new graph capture and give the third's tokens. The forced evict is timed (d2h GB/s of the spill path,
    issue and wait apart), again after the fourth pass, then a fifth pass times each re-admission's h2d,
    beside a plain pinned ``copy_`` of the same bytes. With ``journal_dir`` the third pass of ``spill`` is
    recorded there. On ``big_pool`` the warm wave A is served in turns with telemetry on and off (on, off,
    off, on)."""
    import numpy as np

    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.models import init_params

    spec = SPILL_RUNS[run]
    cfg = gpt2_cfg() if run.startswith("gpt2") else model_cfg()
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.bfloat16)
    wave_a, wave_b = spill_waves(np, cfg.vocab_size, spec["prefix"])
    reg = telemetry.get_registry()
    chain_blocks = 4 * spec["prefix"] // 128
    block_bytes = spill_block_bytes(cfg, bool(spec["quant"]))
    out = dict(phase="serve_spill", run=run, layers=cfg.n_layers, d_model=cfg.d_model, block_bytes=block_bytes,
               chain_blocks=chain_blocks, prefix=spec["prefix"], suffix=SPILL_SUFFIX, new_tokens=SPILL_NEW)
    tokens = {}
    for label, blocks, spill in (("spill", spec["blocks"], True), ("no_spill", spec["blocks"], False),
                                 ("big_pool", spec["big"], False)):
        engine = spill_engine(dev, cfg, params, run, blocks, spill)
        pc = engine.state.prefix_cache
        engine.generate([wave_a[0][:32]], max_new_tokens=4)  # warm-up: cuBLAS handles, allocator (not counted)
        engine.state.reset_prefix_cache()
        torch.cuda.synchronize()
        snapshots, readmitted = {}, []
        if spill:
            inner = pc._readmit

            def readmit_spy(node):  # keep a copy of each re-admitted block's pages (compared after the pass)
                ok = inner(node)
                if ok:
                    readmitted.append((node, [t.clone() for t in engine._gather_block(node.block)]))
                return ok

            pc._readmit = readmit_spy
        for fn in counters:
            fn.launches = 0
        passes = {}
        for name, wave in (("a1", wave_a), ("b", wave_b), ("a3", wave_a)):
            if name == "b" and spill:
                snapshots = {n: [t.clone() for t in engine._gather_block(n.block)] for n in pc._iter_nodes()
                             if n.block >= 0}
            journal = record_journal(journal_dir) if name == "a3" and spill and journal_dir else None
            passes[name] = timed_pass(torch, engine, wave, reg)
            if journal is not None:
                journal.close()
                telemetry.set_journal(None)
                out["journal_path"] = journal.path
            tokens[(label, name)] = got = passes[name].pop("tokens")
            if not all(len(o) == SPILL_NEW and all(0 <= t < cfg.vocab_size for t in o) for o in got):
                raise AssertionError(f"serve_spill {run} {label} {name}: a request did not get {SPILL_NEW} "
                                     "in-vocab tokens")
        launches = {fn.__name__: fn.launches for fn in counters}
        rec = dict(phase="serve_spill", run=run, engine=label, kv_blocks=blocks, kv_spill=spill, passes=passes,
                   launches=launches,
                   tokens_per_s=3 * 16 * SPILL_NEW / sum(p["wall_s"] for p in passes.values()))
        if any(n <= 0 for n in launches.values()):
            raise AssertionError(f"serve_spill {run} {label}: kernels never launched: {launches}")
        if spill:
            pc._readmit = inner
            a3 = passes["a3"]
            pages_equal = [all(torch.equal(g, w) for g, w in zip(got, snapshots[node])) for node, got in readmitted]
            rec.update(readmitted_checked=len(pages_equal), readmitted_pages_equal=all(pages_equal),
                       spilled_during_b=passes["b"]["kv_spill_blocks_total"],
                       spilled_bytes=int(sum(p["kv_spill_blocks_total"] for p in passes.values()) * block_bytes),
                       readmitted_bytes=int(a3["kv_readmit_total"] * block_bytes))
            if a3["infer_prefill_tokens_total"] != 16 * SPILL_SUFFIX or a3["kv_readmit_total"] < chain_blocks:
                raise AssertionError(f"serve_spill {run}: the third pass prefilled {a3['infer_prefill_tokens_total']} "
                                     f"tokens (want the {16 * SPILL_SUFFIX} of the suffixes) and re-admitted "
                                     f"{a3['kv_readmit_total']} blocks (want >= {chain_blocks})")
            if len(pages_equal) < chain_blocks or not all(pages_equal) or any(n not in snapshots
                                                                                  for n, _ in readmitted):
                raise AssertionError(f"serve_spill {run}: {len(pages_equal)} re-admitted blocks checked, "
                                     f"{pages_equal.count(False)} differ from their pages before the spill")
            readmitted.clear()
            snapshots.clear()
            # a forced evict (every cached block spills), timed twice: right after the third pass, and again
            # after the fourth pass re-admitted the chains (the caching allocator then holds the snapshots'
            # memory); then a fifth pass whose re-admissions are timed one by one (h2d), each between syncs
            rec["evict_cold"] = timed_evict(torch, engine, block_bytes)
        # the warm fourth pass: the chains re-admitted (spill), prefilled again (no_spill) or in HBM (big_pool)
        passes["a4"] = timed_pass(torch, engine, wave_a, reg, evict=label == "no_spill")
        tokens[(label, "a4")] = passes["a4"].pop("tokens")
        if spill:
            a4 = passes["a4"]
            if a4["captures"] != 0 or tokens[(label, "a4")] != tokens[(label, "a3")] or a4["kv_readmit_total"] < \
                    chain_blocks or a4["infer_prefill_tokens_total"] != 16 * SPILL_SUFFIX:
                raise AssertionError(f"serve_spill {run}: the fourth pass took {a4['captures']} new captures, "
                                     f"re-admitted {a4['kv_readmit_total']} blocks, prefilled "
                                     f"{a4['infer_prefill_tokens_total']} tokens, tokens equal to the third "
                                     f"pass's: {tokens[(label, 'a4')] == tokens[(label, 'a3')]}")
            rec["evict_warm"] = timed_evict(torch, engine, block_bytes)
            scatter, h2d = pc._scatter, []

            def timed_scatter(block, leaves):
                torch.cuda.synchronize()
                t = time.perf_counter()
                scatter(block, leaves)
                torch.cuda.synchronize()
                h2d.append(time.perf_counter() - t)

            pc._scatter = timed_scatter
            a5 = engine.generate(wave_a, max_new_tokens=SPILL_NEW)
            pc._scatter = scatter
            rec.update(readmits_timed=len(h2d), readmit_h2d_gb_per_s=len(h2d) * block_bytes / sum(h2d) / 1e9,
                       **pinned_copy_gbps(torch, dev, block_bytes, rec["evict_cold"]["blocks"]))
            if a5 != tokens[(label, "a3")] or not h2d:
                raise AssertionError(f"serve_spill {run}: the fifth pass re-admitted {len(h2d)} blocks, tokens "
                                     f"equal to the third pass's: {a5 == tokens[(label, 'a3')]}")
        if label == "big_pool":
            turns = []
            for on in (True, False, False, True):  # telemetry on and off, in turns, on the warm engine
                engine.state.reset_prefix_cache()
                telemetry.set_enabled(on)
                t0 = time.perf_counter()
                engine.generate(wave_a, max_new_tokens=SPILL_NEW)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                turns.append(dict(telemetry=on, wall_s=wall, tokens_per_s=16 * SPILL_NEW / wall))
            telemetry.set_enabled(True)
            rec["telemetry_turns"] = turns
        log(rec)
        out[label] = {k: v for k, v in rec.items() if k not in ("phase", "run", "engine")}
        del engine
        free_engine(torch)
    out["third_pass_equal_big_pool"] = tokens[("spill", "a3")] == tokens[("big_pool", "a3")]
    out["third_pass_wall_s"] = {k: out[k]["passes"]["a3"]["wall_s"] for k in ("spill", "no_spill", "big_pool")}
    # the warm fourth pass (every graph captured): the chains re-admitted, re-prefilled, or in HBM
    out["fourth_pass_wall_s"] = {k: out[k]["passes"]["a4"]["wall_s"] for k in ("spill", "no_spill", "big_pool")}
    out["no_spill_agreement"] = agreement(tokens[("no_spill", "a3")], tokens[("big_pool", "a3")])
    log(dict(phase="serve_spill summary", run=run, **{k: out[k] for k in (
        "third_pass_equal_big_pool", "third_pass_wall_s", "fourth_pass_wall_s", "no_spill_agreement")}))
    if not out["third_pass_equal_big_pool"]:
        raise AssertionError(f"serve_spill {run}: the third pass's tokens with spill differ from the big pool's: "
                             f"{agreement(tokens[('spill', 'a3')], tokens[('big_pool', 'a3')])}")
    out["params"], out["cfg"], out["waves"] = params, cfg, (wave_a, wave_b)
    return out


def phase_journal(torch, dev, counters, serve):
    """The serving journal on llama3_8b (``serve``: the serve_spill record, its weights and waves): the journal
    its spill engine's third pass recorded (``DS_TPU_JOURNAL``), read back with ``read_journal``, replayed by
    ``replay_oracle`` on a fresh engine rebuilt from the journal over the same weights, after it served the
    same first two waves unrecorded; one ``sla.run_load`` row (``JOURNAL_SLA``, every arrival at t = 0)
    recorded on a fresh engine and replayed on another; both must give ``ok`` and every request's digest;
    then ``determinism_audit`` of the serve (wave A on two fresh engines) must be clean. The counters are
    zeroed before the replays and read after."""
    import dataclasses

    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.inference.v2 import sla
    from deepspeed_tpu_torch.inference.v2.replay import build_engine_from_session, determinism_audit, replay_oracle

    cfg, params, (wave_a, wave_b) = serve["cfg"], serve["params"], serve["waves"]
    run = serve["run"]
    directory = os.path.dirname(serve["journal_path"])
    sessions = telemetry.read_journal(serve["journal_path"])
    session = sessions[-1]
    if session.kind != "generate" or len(session.requests) != len(wave_a):
        raise AssertionError(f"journal: read {len(sessions)} sessions, the last of kind {session.kind} with "
                             f"{len(session.requests)} requests")

    def fresh(sess):
        gc.collect()
        torch.cuda.empty_cache()
        spec = SPILL_RUNS[run]
        host_mb = -(-spec["host_blocks"] * spill_block_bytes(cfg, bool(spec["quant"])) // 2**20)
        with env_set({"DS_TPU_KV_HOST_POOL_MB": host_mb, "DS_TPU_PROGRAM_CACHE": SPILL_PROGRAM_CACHE}):
            return build_engine_from_session(sess, model=cfg, params=params, device=dev)

    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    engine = fresh(session)
    engine.generate(wave_a, max_new_tokens=SPILL_NEW)  # the recorded pass's starting state, unrecorded
    engine.generate(wave_b, max_new_tokens=SPILL_NEW)
    generate, replayed = engine.generate, []
    engine.generate = lambda *a, **k: replayed.append(generate(*a, **k)) or replayed[-1]
    report = replay_oracle(session, engine=engine)
    # the recorded pass ran deferred (no EOS, no streaming): each request's digest folds its whole stream once
    digests = {u: telemetry.roll_digest("", toks) for u, toks in zip(sorted(session.requests), replayed[0])}
    del engine.generate
    del engine
    free_engine(torch)
    serve_rec = dict(kind="generate", ok=report.ok, requests=report.n_requests, tokens=report.n_tokens,
                     digests_equal=digests == session.digests(), seconds=time.perf_counter() - t0,
                     divergences=[dataclasses.asdict(d) for d in report.divergences[:3]],
                     programs_recorded=len(session.header.get("programs", [])))

    t0 = time.perf_counter()
    path = os.path.join(directory, "sla.jsonl")
    journal = telemetry.Journal(path)
    load = sla.LoadSpec(vocab_size=cfg.vocab_size, **JOURNAL_SLA)
    engine = fresh(session)
    with telemetry.journal_override(journal):
        stats = sla.run_load(engine, load)
    journal.close()
    del engine
    free_engine(torch)
    sla_session = telemetry.read_journal(path)[-1]
    engine = fresh(sla_session)
    sla_report = replay_oracle(sla_session, engine=engine)
    del engine
    free_engine(torch)
    sla_rec = dict(kind="sla", ok=sla_report.ok, requests=sla_report.n_requests, tokens=sla_report.n_tokens,
                   digests=len(sla_session.digests()), summary=sla.summarize(stats), seconds=time.perf_counter() - t0,
                   divergences=[dataclasses.asdict(d) for d in sla_report.divergences[:3]])
    launches = {fn.__name__: fn.launches for fn in counters}

    t0 = time.perf_counter()
    audit = determinism_audit(lambda: fresh(session), drive=lambda e: e.generate(wave_a, max_new_tokens=SPILL_NEW))
    gc.collect()
    torch.cuda.empty_cache()
    rec = dict(phase="journal", run=run, journal=serve["journal_path"], sessions=len(sessions), serve=serve_rec,
               sla=sla_rec, launches=launches, audit=dict(audit, seconds=time.perf_counter() - t0))
    log(rec)
    if not (serve_rec["ok"] and serve_rec["digests_equal"] and sla_rec["ok"] and audit["deterministic"]):
        raise AssertionError(f"journal: replay ok {serve_rec['ok']} (digests {serve_rec['digests_equal']}), sla "
                             f"replay ok {sla_rec['ok']}, determinism audit {audit}")
    if any(n <= 0 for n in launches.values()) or sla_rec["tokens"] != JOURNAL_SLA["n_requests"] * JOURNAL_SLA[
            "max_new_tokens"]:
        raise AssertionError(f"journal: launches {launches}, {sla_rec['tokens']} SLA tokens replayed")
    return rec


# ---------------------------------------------------------------- speculative decoding
# serve_spec at the JAX bench's chip sizes (bench.py, run_serve_spec): 32 prompts, each a seeded 16-token motif
# repeated 8 times, 128 new tokens, K = 4, bursts off; the KV pool as the bench sizes it
SPEC_SERVE = dict(n_req=32, motif=16, reps=8, new=128, spec_k=4, kv_block=128)
SPEC_PROGRAM_CACHE = 32  # holds every graph key of a serve_spec run (the default, 8, is run beside)


class program_cache:
    """``DS_TPU_PROGRAM_CACHE`` set to ``n`` (None: left as it is) while an engine is built: the engine reads
    the knob once."""

    def __init__(self, n):
        self.n, self.old = n, os.environ.get("DS_TPU_PROGRAM_CACHE")

    def __enter__(self):
        if self.n is not None:
            os.environ["DS_TPU_PROGRAM_CACHE"] = str(self.n)

    def __exit__(self, *exc):
        if self.n is not None:
            if self.old is None:
                del os.environ["DS_TPU_PROGRAM_CACHE"]
            else:
                os.environ["DS_TPU_PROGRAM_CACHE"] = self.old


def spec_prompts(np, vocab, n_req, motif, reps):
    """The bench's prompts: ``n_req`` seeded motifs of ``motif`` tokens, each repeated ``reps`` times."""
    rng = np.random.RandomState(0)
    return [rng.randint(1, vocab, size=motif).tolist() * reps for _ in range(n_req)]


class OracleDrafter:
    """Proposes the tokens a reference run gave after the generated part of the history, so that the
    full-accept path of the verify runs whatever the weights (a test drafter only). A row whose tokens have
    left the reference's (bf16 rounds spec on and off otherwise) gets no proposal: plain decode."""

    def __init__(self, prompts, outs):
        self._want = {tuple(p): o for p, o in zip(prompts, outs)}
        self._plen = len(prompts[0])

    def propose(self, history, k):
        want = self._want.get(tuple(history[:self._plen]), [])
        done = len(history) - self._plen
        if list(history[self._plen:]) != want[:done]:
            return []
        return list(want[done:done + k])


def spec_engine(dev, cfg, params, dtype, cache, **kw):
    """An engine at serve_spec's KV sizes: max_context = the prompt, the new tokens, K and one block; a pool
    of one max_context a request and 8 blocks more (as the bench sizes it)."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig

    s = SPEC_SERVE
    max_ctx = min(cfg.max_seq_len, s["motif"] * s["reps"] + s["new"] + s["spec_k"] + s["kv_block"])
    smc = RaggedBatchConfig(max_context=max_ctx, kv_block_size=s["kv_block"],
                            num_kv_blocks=s["n_req"] * -(-max_ctx // s["kv_block"]) + 8)
    with program_cache(cache):
        return InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            state_manager=smc, dtype=dtype, device=str(dev), spec_k=s["spec_k"], **kw))


def verify_graph_checks(torch, engine, limit=6):
    """Hold the engine's verify graphs to the eager verify step: after each of the first ``limit`` greedy
    verify replays, the same step runs eagerly on the same inputs (it writes the same KV to the same slots)
    and its committed ids and accepted counts are compared with the replay's. Returns the list the checks
    go into; ``del engine._dispatch`` ends them."""
    checks = []
    inner = engine._dispatch

    def spy(key, step, arrays, rows, sampled=False, head=None):
        out = inner(key, step, arrays, rows, sampled, head)
        if key[0] == "spec" and not sampled and len(checks) < limit:
            eager = step(*engine._to_device(*arrays), None)
            checks.append(dict(key=list(key[:3]), committed_equal=bool(torch.equal(out[:, :-1], eager[:, :-1])),
                               counts_equal=bool(torch.equal(out[:, -1], eager[:, -1]))))
        return out

    engine._dispatch = spy
    return checks


def spec_counts(engine) -> dict:
    return dict(decode_steps=engine.decode_steps, decode_tokens=engine.decode_tokens, proposed=engine.spec_proposed,
                accepted=engine.spec_accepted, rollback_tokens=engine.state.spec_rollback_tokens,
                **graph_counts(engine))


def spec_run(torch, engine, prompts, label, counters, vocab, check_graph=False) -> dict:
    """One serve_spec run: a warm-up generate that captures every graph key the run takes (with
    ``check_graph`` also holding the verify graphs to the eager step), then the timed generate, the prefix
    cache reset before each; the counters zeroed just before the timed run and read just after. Gates:
    every request gets its new tokens, in vocab; the KV pool's free blocks come back; each step is one
    graph replay."""
    new = SPEC_SERVE["new"]
    engine.state.reset_prefix_cache()
    before = spec_counts(engine)
    checks = verify_graph_checks(torch, engine) if check_graph else None
    engine.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    if checks is not None:
        del engine._dispatch
    warm = {k: v - before[k] for k, v in spec_counts(engine).items()}
    engine.state.reset_prefix_cache()
    free0 = engine.state.free_blocks
    before = spec_counts(engine)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    c = {k: v - before[k] for k, v in spec_counts(engine).items()}
    engine.state.reset_prefix_cache()
    n_req = len(prompts)
    rec = dict(phase="serve_spec", run=label, spec=engine._spec_enabled, burst=engine._config.decode_burst,
               drafter=type(engine._drafter).__name__ if engine._spec_enabled else None,
               program_cache=engine._max_program_variants, wall_s=wall, tokens_per_s=n_req * new / wall,
               steps=c["dispatches"], decode_steps=c["decode_steps"], decode_tokens=c["decode_tokens"],
               tokens_per_decode_step=c["decode_tokens"] / max(1, c["decode_steps"]),
               tokens_per_decode_step_per_row=c["decode_tokens"] / max(1, c["decode_steps"]) / n_req,
               proposed=c["proposed"], accepted=c["accepted"],
               acceptance=c["accepted"] / c["proposed"] if c["proposed"] else None,
               rollback_tokens=c["rollback_tokens"], captures=c["captures"], capture_s=c["capture_s"],
               evictions=c["evictions"], graph_replays=c["graph_replays"], warmup_captures=warm["captures"],
               warmup_capture_s=warm["capture_s"], warmup_evictions=warm["evictions"], graphs_live=len(engine.graphs),
               launches=launches, free_blocks_before=free0, free_blocks_after=engine.state.free_blocks,
               verify_graph_checks=checks)
    log(rec)
    if not all(len(o) == new and all(0 <= t < vocab for t in o) for o in out):
        raise AssertionError(f"serve_spec {label}: a request did not get {new} in-vocab tokens")
    if rec["free_blocks_after"] != free0:
        raise AssertionError(f"serve_spec {label}: {free0} free KV blocks before, {rec['free_blocks_after']} after")
    if c["graph_replays"] != c["dispatches"]:
        raise AssertionError(f"serve_spec {label}: {c['graph_replays']} graph replays for {c['dispatches']} steps")
    if launches["paged_attention_prefill"] <= 0 or launches["rms_norm"] <= 0:
        raise AssertionError(f"serve_spec {label}: kernels of the path never launched: {launches}")
    if checks is not None and not (checks and all(x["committed_equal"] and x["counts_equal"] for x in checks)):
        raise AssertionError(f"serve_spec {label}: the verify graph's replay differs from the eager step: {checks}")
    rec["tokens"] = out
    return rec


def phase_serve_spec(torch, dev, counters, params):
    """Speculative decoding on llama3_8b at full width and depth (bf16, ``params``: the serve phase's
    weights), the JAX bench's serve_spec workload, in turns: spec off, spec on (prompt lookup, its first
    verify steps held to the eager step), spec on with the oracle drafter (the reference: spec off's tokens),
    and spec off at the default burst of 32, all at DS_TPU_PROGRAM_CACHE=32; then spec on at the default
    cache. Each run reports tokens/s, decode steps, proposed and accepted drafts, tokens a decode step,
    captures and evictions, and its bf16 token agreement with spec off; the oracle must have accepted."""
    import numpy as np

    cfg = model_cfg()
    s = SPEC_SERVE
    prompts = spec_prompts(np, cfg.vocab_size, s["n_req"], s["motif"], s["reps"])
    runs = {}

    def run(label, cache=SPEC_PROGRAM_CACHE, drafter=None, check_graph=False, **kw):
        engine = spec_engine(dev, cfg, params, "bfloat16", cache, **kw)
        if drafter is not None:
            engine._drafter = drafter
        rec = spec_run(torch, engine, prompts, label, counters, cfg.vocab_size, check_graph)
        if "off" in runs:
            rec["agreement_with_spec_off"] = agreement(rec["tokens"], runs["off"]["tokens"])
            log(dict(phase="serve_spec agreement", run=label, beside="off", **rec["agreement_with_spec_off"]))
        runs[label] = rec
        del engine
        gc.collect()
        torch.cuda.empty_cache()

    run("off", spec_decode=False, decode_burst=0)
    run("on", spec_decode=True, decode_burst=0, check_graph=True)
    run("oracle", spec_decode=True, decode_burst=0, drafter=OracleDrafter(prompts, runs["off"]["tokens"]))
    run("off_burst32", spec_decode=False, decode_burst=32)
    run("on_default_cache", cache=None, spec_decode=True, decode_burst=0)
    if runs["oracle"]["accepted"] <= 0:
        raise AssertionError(f"serve_spec: the oracle drafter's proposals were never accepted: {runs['oracle']}")
    summary = {label: {k: r[k] for k in ("tokens_per_s", "decode_steps", "tokens_per_decode_step", "proposed",
                                         "accepted", "captures", "evictions", "warmup_captures", "warmup_evictions")}
               for label, r in runs.items()}
    log(dict(phase="serve_spec summary", model="llama3_8b", **summary))
    return runs


def phase_spec_fp32(torch, dev, counters, n_layers=2, n_req=8, new=32):
    """A ``n_layers``-layer engine at llama3_8b's widths in fp32 on the card: greedy tokens with speculative
    decoding on equal those with it off, in the fused and the unfused loop (serve_spec's prompts, cut to
    ``n_req`` and ``new`` tokens), with prompt lookup and with the oracle drafter (spec off's tokens, so
    that whole windows are accepted)."""
    import numpy as np

    from deepspeed_tpu_torch.models import init_params

    cfg = model_cfg(n_layers=n_layers)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.float32)
    s = SPEC_SERVE
    prompts = spec_prompts(np, cfg.vocab_size, n_req, s["motif"], s["reps"])
    out = []
    for fused in (True, False):
        toks, counts = {}, {}
        for run in ("off", "on", "oracle"):
            engine = spec_engine(dev, cfg, params, "float32", SPEC_PROGRAM_CACHE, spec_decode=run != "off",
                                 fused_step=fused)
            if run == "oracle":
                engine._drafter = OracleDrafter(prompts, toks["off"])
            for fn in counters:
                fn.launches = 0
            toks[run] = engine.generate(prompts, max_new_tokens=new)
            torch.cuda.synchronize()
            counts[run] = dict(proposed=engine.spec_proposed, accepted=engine.spec_accepted,
                               decode_steps=engine.decode_steps, launches={fn.__name__: fn.launches for fn in counters})
            del engine
            gc.collect()
        rec = dict(phase="spec_fp32", model="llama3_8b", layers=n_layers, loop="fused" if fused else "unfused",
                   tokens_equal={run: toks[run] == toks["off"] for run in ("on", "oracle")}, **counts,
                   agreement_on=agreement(toks["on"], toks["off"]))
        log(rec)
        if not all(rec["tokens_equal"].values()) or counts["oracle"]["accepted"] <= 0:
            raise AssertionError(f"spec_fp32 ({rec['loop']} loop): spec-on tokens differ from spec-off, or the "
                                 f"oracle's drafts were never accepted: {rec}")
        out.append(rec)
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- training run
MICRO, SEQ, TRAIN_STEPS, TIMED_FROM = 8, 1024, 12, 2  # steps 3-12 are timed
# LAMB scales each leaf's step by ||p|| / ||u||, so its elements move by about lr * rms(p), not lr: it
# takes a larger lr (BERT's LAMB runs used 1e-3 to 1e-2)
# The telemetry phase's program cache: above the 11 graph keys of the serve waves, so every pass after the first
# replays warm graphs (as llama3_8b_cache16)
TELEMETRY_PROGRAM_CACHE = 16
# the perf accountant's snapshot keys, the reference's (GET /perf adds "rank")
PERF_KEYS = {"mode", "peaks", "totals", "mfu", "cards", "ledger", "hbm"}
# sections every flight manifest carries, the reference's
FLIGHT_SECTIONS = {"schema", "reason", "ts_unix", "rank", "alert", "alerts_recent", "events_tail", "spans_tail",
                   "metrics", "perf", "knobs", "knob_provenance", "tuned_profile", "journal"}


def telemetry_pass(torch, engine, waves) -> tuple:
    """The serve waves once, the prefix cache reset first (the same admissions every pass): tokens, wall s."""
    engine.state.reset_prefix_cache()
    t0 = time.perf_counter()
    out = [t for wave in waves for t in engine.generate(wave, max_new_tokens=32)]
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def get_json(opener, url) -> tuple:
    """(status, parsed body) of a GET on the loopback ops plane; an error status is a result, not a raise."""
    import urllib.error

    try:
        with opener.open(url, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def phase_telemetry(torch, dev, counters, params):
    """Telemetry on the main serving path: llama3_8b at full width and depth (bf16, ``params``: the serve
    phase's weights), the serve waves on warm graphs (``DS_TPU_PROGRAM_CACHE=16``), with the kernel counters
    zeroed before the accounting pass and read after. Checks, each fatal: (1) the perf accountant's useful
    tokens equal the tokens the decode steps generated plus the prefill tokens scheduled, its slot tokens
    the buckets' rows, one cost card per graph key; ``infer_mfu``, the pass's MFU and ``ledger()`` printed;
    (2) the device profiler (a ``torch.profiler`` session over the quanta of one pass, cut by its in-trace
    markers) gives a device-busy share within 3 points of ``profiled()``'s account of the same session
    (its kernels' summed device time over the pass's wall time); (3) the
    ops plane on 127.0.0.1 answers ``/metrics``, ``/healthz``, ``/perf`` and ``/profile`` with the
    reference's keys; (4) a manual flight capture writes a manifest with the reference's sections. Then
    tokens/s with telemetry and accounting on and off in turns (on, off, off, on), printed, not gated."""
    import numpy as np

    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.telemetry import profiler as device_profiler

    cfg = model_cfg()
    acct = telemetry.get_perf_accountant()
    reg = telemetry.get_registry()
    if not acct.enabled:
        raise AssertionError("telemetry: the perf accountant is off (DS_TPU_PERF_ACCOUNT=0 in the environment?)")
    t_start = time.perf_counter()
    with program_cache(TELEMETRY_PROGRAM_CACHE):
        engine = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            state_manager=RaggedBatchConfig(max_context=8192, kv_block_size=128, memory_gb=8.0),
            dtype="bfloat16", device=str(dev)))
    waves = serving_prompts(np, cfg.vocab_size)
    acct.reset()  # this engine's cards only
    telemetry_pass(torch, engine, waves)  # warm-up: captures every graph key of the waves
    captures = engine.graphs.captures

    # (1) accounting over one warm pass
    acct.reset_counts()
    names = ("infer_prefill_tokens_total", "infer_decode_tokens_total", "infer_model_flops_total")
    before = {n: reg.peek(n) or 0.0 for n in names}
    d0 = engine.dispatches
    for fn in counters:
        fn.launches = 0
    out, wall = telemetry_pass(torch, engine, waves)
    launches = {fn.__name__: fn.launches for fn in counters}
    delta = {n: (reg.peek(n) or 0.0) - before[n] for n in names}
    totals, ledger = acct.totals(), acct.ledger()
    cards = [c for c in acct.cards().values() if c.program in ("prefill", "decode", "burst", "fused", "spec")]
    steps = engine.dispatches - d0
    generated = sum(len(o) for o in out)
    rec = dict(phase="telemetry", model="llama3_8b", layers=cfg.n_layers, program_cache=TELEMETRY_PROGRAM_CACHE,
               prompts=len(out), new_tokens=generated, wall_s=wall, tokens_per_s=generated / wall, steps=steps,
               captures_after_warmup=engine.graphs.captures - captures, launches=launches,
               useful_tokens=totals["useful_tokens"], slot_tokens=totals["slot_tokens"],
               prefill_tokens=delta["infer_prefill_tokens_total"], decode_tokens=delta["infer_decode_tokens_total"],
               cards=len(cards), graphs_live=len(engine.graphs), timed_calls=sum(c.timed_calls for c in cards),
               model_flops=delta["infer_model_flops_total"], infer_mfu=reg.peek("infer_mfu"),
               mfu_of_the_pass=acct.mfu(flops=totals["flops"], time_s=wall), peaks=acct.peaks(), ledger=ledger,
               hbm=acct.hbm(), card_rows=[c.as_dict(*acct.peaks()) for c in sorted(cards, key=lambda c: -c.time_s)])
    log(rec)
    if any(n <= 0 for n in launches.values()):
        raise AssertionError(f"telemetry: kernels never launched on the main path: {launches}")
    if engine.graphs.captures != captures or steps <= 0:
        raise AssertionError(f"telemetry: the accounted pass captured again or ran no step: {rec}")
    if generated != 32 * len(out) or rec["decode_tokens"] != generated - len(out):
        raise AssertionError(f"telemetry: {generated} tokens generated, {rec['decode_tokens']} by decode steps")
    if totals["useful_tokens"] != rec["decode_tokens"] + rec["prefill_tokens"]:
        raise AssertionError(f"telemetry: useful tokens {totals['useful_tokens']} != decode tokens "
                             f"{rec['decode_tokens']} + prefill tokens {rec['prefill_tokens']}")
    if not (rec["timed_calls"] == steps and len(cards) == len(engine.graphs) and totals["slot_tokens"] >=
            totals["useful_tokens"] > 0):
        raise AssertionError(f"telemetry: {len(cards)} cards, {len(engine.graphs)} graphs, "
                             f"{rec['timed_calls']} timed calls, {steps} steps: one card a graph key, each step "
                             "attributed")
    if not (isinstance(rec["infer_mfu"], float) and rec["infer_mfu"] > 0 and 0 < rec["mfu_of_the_pass"] < 1):
        raise AssertionError(f"telemetry: infer_mfu {rec['infer_mfu']}, the pass's MFU {rec['mfu_of_the_pass']}")

    # (2) the device profiler's waterfall against profiled()'s account of the same session: one pass traced
    # from its start (a quantum boundary noted by the caller) to finish() after its sync
    cats = {"paged_attention_decode": ("decode_kernel", "paged_combine_kernel"),
            "paged_attention_prefill": ("prefill_kernel",), "rms_norm": ("rms_norm",), "matmul": MATMUL,
            "copy": ("Memcpy", "Memset")}
    with tempfile.TemporaryDirectory() as cap_dir:
        prof, armed = device_profiler.request_capture(quanta=1 << 20)
        prof.out_dir = cap_dir
        if not armed:
            raise AssertionError(f"telemetry: the device profiler could not be armed: {prof.status()}")
        sessions, stop = [], prof._stop_trace

        def keep_session():  # the session, for key_averages() after it stops
            sessions.append(prof._handle)
            stop()

        prof._stop_trace = keep_session
        engine.state.reset_prefix_cache()
        device_profiler.note_quantum("pass")  # the trace starts here, before the pass's first step
        t0 = time.perf_counter()
        for wave in waves:
            engine.generate(wave, max_new_tokens=32)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        summary = prof.finish()
        plain = session_device_time(sessions[0], cats, wall_ms)
        ops = telemetry.OpsServer(port=0, host="127.0.0.1").start()
        try:
            import urllib.request

            opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # loopback: never a proxy
            base = f"http://127.0.0.1:{ops.port}"
            answers = {path: get_json(opener, base + path) for path in ("/metrics", "/healthz", "/perf", "/profile")}
        finally:
            ops.stop()
        with tempfile.TemporaryDirectory() as flight_dir:
            rec_flight = telemetry.FlightRecorder(flight_dir, max_captures=2, profile_s=0.0)
            rec_flight.register_provider("residency", engine._residency_summary)
            manifest = rec_flight.read_manifest(os.path.basename(rec_flight.capture("chip_smoke")))
    busy = summary["fractions"]["device_busy"]
    rec = dict(phase="telemetry profiler", trace=summary["trace"], marker_clock=summary["marker_clock"],
               quanta=summary["n_quanta"], window_s=summary["window_s"], device_busy_fraction=busy,
               profiled_busy_share=plain["busy_share"], profiled_wall_ms=plain["wall_ms_profiled"],
               profiled_device_busy_ms=plain["device_busy_ms"], totals=summary["totals"],
               host_gap_fraction=summary["fractions"]["host_gap"], top_device_programs=summary["programs"],
               host_spans=summary["host_spans"][:8],
               widest_host_gaps=sorted(({"index": q["index"], "program": q["program"], "host_gap_s": q["host_gap_s"],
                                         "dur_s": q["dur_s"]} for q in summary["quanta"]),
                                       key=lambda q: -q["host_gap_s"])[:5])
    log(rec)
    if summary["trace"] != "ok" or summary["marker_clock"] != "trace" or summary["n_quanta"] != steps:
        raise AssertionError(f"telemetry: the capture did not trace the pass: {rec}")
    if not isinstance(plain["busy_share"], float) or abs(busy - plain["busy_share"]) > 0.03:
        raise AssertionError(f"telemetry: profile_device_busy_fraction {busy} against profiled()'s busy share "
                             f"{plain['busy_share']}: more than 3 points apart")
    if reg.peek("profile_device_busy_fraction") != busy:
        raise AssertionError("telemetry: the capture's gauges did not land in the registry")

    # (3) the ops plane, (4) the flight recorder
    status = {path: code for path, (code, _) in answers.items()}
    perf = json.loads(answers["/perf"][1])
    health = json.loads(answers["/healthz"][1])
    profile_doc = json.loads(answers["/profile"][1])
    metrics_text = answers["/metrics"][1].decode()
    log(dict(phase="telemetry ops", status=status, perf_keys=sorted(perf), healthz=health["status"],
             profile_keys=sorted(profile_doc), flight_sections=sorted(manifest)))
    # /healthz answers 503 while a detector fires: an answer all the same
    if any(code != 200 for path, code in status.items() if path != "/healthz") or status["/healthz"] not in (
            200, 503) or not PERF_KEYS | {"rank"} <= set(perf):
        raise AssertionError(f"telemetry: ops plane answers {status}, /perf keys {sorted(perf)}")
    if not ({"status", "healthy", "rank", "detectors", "alerts"} <= set(health)
            and {"configured", "rank", "state", "captures", "summary"} <= set(profile_doc)
            and "infer_useful_tokens_total" in metrics_text and "infer_mfu" in metrics_text):
        raise AssertionError(f"telemetry: ops plane bodies lack the reference's keys: {sorted(health)}, "
                             f"{sorted(profile_doc)}")
    if manifest is None or not FLIGHT_SECTIONS | {"residency"} <= set(manifest):
        raise AssertionError(f"telemetry: flight manifest sections {None if manifest is None else sorted(manifest)}")

    # telemetry's cost: on, off, off, on
    turns = []
    for on in (True, False, False, True):
        telemetry.set_enabled(on)
        acct.enabled = on
        got, wall = telemetry_pass(torch, engine, waves)
        if got != out:
            raise AssertionError("telemetry: tokens changed with telemetry switched")
        turns.append(dict(telemetry=on, wall_s=wall, tokens_per_s=generated / wall))
    telemetry.set_enabled(True)
    acct.enabled = True
    log(dict(phase="telemetry cost", turns=turns, seconds=time.perf_counter() - t_start))
    del engine
    gc.collect()
    torch.cuda.empty_cache()


TRAIN_LR = {"Lamb": 2e-3}


def gpt2_cfg(**kw):
    """gpt2_1_3b with fields replaced (the presets fix n_layers)."""
    import dataclasses

    from deepspeed_tpu_torch.models import gpt2_1_3b

    return dataclasses.replace(gpt2_1_3b(), **kw)


def train_config(torch, optimizer: str, dtype) -> dict:
    lr = TRAIN_LR.get(optimizer, 1e-4)
    return {"train_micro_batch_size_per_gpu": MICRO, "gradient_accumulation_steps": 1, "steps_per_print": 1000,
            "optimizer": {"type": optimizer, "params": {"lr": lr, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0, "warmup_max_lr": lr,
                                                         "warmup_num_steps": 5}},
            "gradient_clipping": 1.0, "bf16": {"enabled": dtype == torch.bfloat16}}


def train_batch_data(np, vocab: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, vocab, (MICRO, SEQ)).astype(np.int32)}


class PlainKernels:
    """Bind the plain versions of the flash kernels in place of their wrappers
    on the card, for a parity run (the autograd function calls them by name)."""

    NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dq_collapsed", "flash_bwd_dkv")
    PLAIN = "_ref"  # the plain version of wrapper ``n`` is ``n + PLAIN`` in the same module

    @staticmethod
    def module():
        from deepspeed_tpu_torch.ops import flash_attention as fa

        return fa

    def __enter__(self):
        fa = self.module()
        self.fa, self.saved = fa, {n: getattr(fa, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(fa, n, getattr(fa, n + self.PLAIN))

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.fa, n, fn)


class PlainLambKernels(PlainKernels):
    """The plain version of the LAMB direction kernel bound in place of its wrapper."""

    NAMES = ("lamb_direction",)

    @staticmethod
    def module():
        from deepspeed_tpu_torch.ops import fused_lamb as tfl

        return tfl


# the plain form of each optimizer of a parity run: (config name, contexts that bind plain versions)
PLAIN_OPTIMIZER = {"FusedAdam": ("AdamW", (PlainKernels,)), "Lamb": ("Lamb", (PlainKernels, PlainLambKernels))}


def phase_train_parity(torch, dev, dtype, counters, n_layers=2, optimizer="FusedAdam"):
    """One engine step of gpt2_1_3b at full width with the kernels (flash
    attention, and FusedAdam or the LAMB direction) and one with their plain
    versions (the flash plain versions under the same autograd function, and
    plain AdamW or LAMB with the direction's plain version), from the same
    weights and batch."""
    import contextlib

    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM, init_params

    cfg = gpt2_cfg(n_layers=n_layers, dtype=dtype)
    model = CausalLM(cfg)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = train_batch_data(np, cfg.vocab_size)
    ids = torch.from_numpy(batch["input_ids"]).to(dev)
    plain_name, plain_contexts = PLAIN_OPTIMIZER[optimizer]
    res = {}
    for variant, opt_name, contexts in (("kernel", optimizer, ()), ("plain", plain_name, plain_contexts)):
        for fn in counters:
            fn.launches = 0
        with contextlib.ExitStack() as stack:
            for ctx in contexts:
                stack.enter_context(ctx())
            # the loss and the gradients of the compute-dtype weights, as the engine takes them
            leaves = [(path, t.detach().clone().requires_grad_(True)) for path, t in flatten(params)]
            tree = {}
            for path, t in leaves:
                node = tree
                *parents, name = path.split("/")
                for part in parents:
                    node = node.setdefault(part, {})
                node[name] = t.to(dtype)
            loss = model.loss_fn(tree, {"input_ids": ids})
            loss.backward()
            grads = [t.grad for _, t in leaves]
            engine, _, _, _ = dst.initialize(model=model, model_parameters=params,
                                             config=train_config(torch, opt_name, dtype), device=dev)
            step_loss = engine.train_batch(iter([batch]))
            after = [t.detach() for _, t in flatten(engine.module_state_dict())]
            torch.cuda.synchronize()
        res[variant] = dict(loss=loss.item(), step_loss=step_loss.item(), grads=grads, after=after,
                            launches={fn.__name__: fn.launches for fn in counters})
        del engine, leaves, tree
    k, p = res["kernel"], res["plain"]
    lr = TRAIN_LR.get(optimizer, 1e-4)  # the first step runs at the optimizer's lr (consume-then-step clock)
    before = [t for _, t in flatten(params)]
    moved = [(a - b).abs() for a, b in zip(k["after"], p["after"])]
    # each leaf's farthest step in the plain run; k_proj's bias is left out of the share: its true gradient is
    # zero, so LAMB's step there is the engines' own fp32 noise over eps (u = g / (|g| + 1e-8)), and its
    # travel is that noise
    travel = [(a - b).abs().max() for a, b in zip(p["after"], before)]
    kept = [not path.endswith("k_proj/bias") for path, _ in flatten(params)]
    n = sum(m.numel() for m in moved)
    rec = dict(phase="train_parity", model="gpt2_1_3b", optimizer=optimizer, layers=n_layers, dtype=str(dtype),
               loss=p["loss"], loss_abs_err=abs(k["loss"] - p["loss"]),
               step_loss_abs_err=abs(k["step_loss"] - p["step_loss"]),
               # k_proj's bias has a zero true gradient (softmax ignores a per-row
               # constant): its fp32 noise is held on the abs error instead
               grad_max_rel_err=max(((a - b).abs().max() / b.abs().max()).item()
                                    for (path, _), a, b in zip(flatten(params), k["grads"], p["grads"])
                                    if not path.endswith("k_proj/bias")),
               k_bias_grad_max_abs=max(max(a.abs().max().item(), b.abs().max().item())
                                       for (path, _), a, b in zip(flatten(params), k["grads"], p["grads"])
                                       if path.endswith("k_proj/bias")),
               param_max_diff_over_lr=max(m.max().item() for m in moved) / lr,
               param_share_off_by_lr_over_10=sum((m > lr / 10).sum().item() for m in moved) / n,
               param_share_off_by_travel_over_10=sum((m > t / 10).sum().item()
                                                     for m, t, keep in zip(moved, travel, kept) if keep) / n,
               kernel_launches=k["launches"], plain_launches=p["launches"],
               moved_from_init=max((a - b).abs().max().item() for a, b in zip(k["after"], before)) / lr)
    # about twice the errors measured on an H100 at these seeded inputs (fp32:
    # loss equal, gradients 4.2e-6, one parameter element in 2e8 off by more
    # than lr/10; bf16: loss 2.6e-5, gradients 1.7e-2, 0.20 % of the elements:
    # Adam's first step is lr * sign(g), so a gradient that flips sign moves
    # its element by 2 lr). LAMB's first direction is Adam's first step over lr, scaled per leaf by
    # ||p|| / ||u||: its elements move by a leaf's own step, so the share is taken against each leaf's
    # farthest step, with the same bounds
    share = "param_share_off_by_lr_over_10" if optimizer == "FusedAdam" else "param_share_off_by_travel_over_10"
    tol = {"torch.float32": {"loss_abs_err": 1e-5, "grad_max_rel_err": 1e-5, share: 1e-8},
           "torch.bfloat16": {"loss_abs_err": 5e-5, "grad_max_rel_err": 0.035, share: 0.005}}[str(dtype)]
    rec["tol"] = tol
    log(rec)
    del res, params
    torch.cuda.empty_cache()
    kernel_launched = all(n > 0 for name, n in k["launches"].items()
                          if name.startswith(("flash", "fused" if optimizer == "FusedAdam" else "lamb")))
    plain_clean = all(n == 0 for n in p["launches"].values())
    if not (all(rec[key] <= t for key, t in tol.items()) and kernel_launched and plain_clean
            and np.isfinite(rec["loss"])):
        raise AssertionError(f"train parity failed: {rec}")
    return rec


def profile_train(torch, engine, data, optimizer="FusedAdam", **labels) -> None:
    """Device-time breakdown of one training step under torch.profiler."""
    cats = {"flash_fwd": ("flash_fwd",), "flash_bwd_dq": ("flash_dq_kernel", "flash_dq_bf16_kernel"),
            "flash_bwd_dkv": ("flash_dkv_kernel", "flash_dkv_bf16_kernel"), "fused_adam": ("adam_kernel",),
            "lamb_direction": ("lamb_dir_kernel",), "matmul": MATMUL, "copy": ("Memcpy", "Memset")}
    log(dict(phase="profile_train", optimizer=optimizer, **labels,
             **profiled(torch, lambda: engine.train_batch(data), cats)))


# the optimizer's kernel and its launches per step over n leaves in one group: FusedAdam one for each
# TABLE_LEAVES leaves, the LAMB direction one per leaf
OPT_COUNTER = {"FusedAdam": "fused_adam", "Lamb": "lamb_direction"}


def opt_launches(optimizer: str, n: int) -> int:
    from deepspeed_tpu_torch.ops.fused_adam import TABLE_LEAVES

    return -(-n // TABLE_LEAVES) if optimizer == "FusedAdam" else n


def phase_train(torch, dev, counters, profile=False, optimizer="FusedAdam"):
    """gpt2_1_3b at full width and depth in bf16 through ``initialize`` and
    ``train_batch``: 12 steps on one seeded batch with ``optimizer``."""
    import itertools

    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import telemetry
    from deepspeed_tpu_torch.models import CausalLM, init_params

    cfg = gpt2_cfg(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine, _, _, _ = dst.initialize(model=CausalLM(cfg), model_parameters=params,
                                     config=train_config(torch, optimizer, torch.bfloat16), device=dev)
    del params
    torch.cuda.empty_cache()
    n_params = sum(p.numel() for p in engine.parameters())
    data = itertools.repeat(train_batch_data(np, cfg.vocab_size))
    losses = [engine.train_batch(data) for _ in range(TIMED_FROM)]  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    stamps = [time.perf_counter()]
    for _ in range(TRAIN_STEPS - TIMED_FROM):
        losses.append(engine.train_batch(data))
        stamps.append(time.perf_counter())  # host, as the engine stamps its step interval
    torch.cuda.synchronize()
    wall = time.perf_counter() - stamps[0]
    launches = {fn.__name__: fn.launches for fn in counters}
    losses = [float(x) for x in losses]
    steps = TRAIN_STEPS - TIMED_FROM
    tokens = MICRO * SEQ
    pairs = visible_pairs(SEQ, SEQ, True, 0)
    # model FLOPs per step: 6 N T for the weights (the tied head included in N),
    # plus attention's two products, forward and backward (3x), over the causal pairs
    flops = 6 * n_params * tokens + 12 * cfg.n_layers * MICRO * cfg.n_heads * cfg.head_dim * pairs
    step_s = wall / steps
    # the engine's own gauge: FLOPs from shapes over the last step's host interval, against resolve_peaks;
    # it is held to this phase's FLOPs over the same interval (LAMB's steps spread by tens of ms, so one
    # step's rate is not the mean's)
    train_mfu = telemetry.get_registry().peek("train_mfu")
    last_step_s = stamps[-1] - stamps[-2]
    last_step_mfu = flops / last_step_s / PEAK_FLOPS["torch.bfloat16"]
    rec = dict(phase="train", model="gpt2_1_3b", optimizer=optimizer, layers=cfg.n_layers, d_model=cfg.d_model,
               params=n_params, train_mfu=train_mfu, last_step_ms=last_step_s * 1e3, last_step_mfu=last_step_mfu,
               engine_step_flops=engine._step_flops,
               leaves=len(engine.parameters()), dtype="bfloat16", micro_batch=MICRO, seq=SEQ, steps=TRAIN_STEPS,
               timed_steps=f"{TIMED_FROM + 1}-{TRAIN_STEPS}", losses=losses, step_ms=step_s * 1e3,
               tokens_per_s=tokens / step_s, model_flops_per_step=flops, mfu=flops / step_s / PEAK_FLOPS[
                   "torch.bfloat16"], max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2**30,
               weights_init_s=init_s, grad_norm=engine.get_global_grad_norm(), skipped_steps=engine.skipped_steps,
               launches=launches, launches_per_step={k: v / steps for k, v in launches.items()})
    log(rec)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses not finite or not falling: {losses}")
    if not (train_mfu and abs(train_mfu / last_step_mfu - 1) <= 0.02):
        raise AssertionError(f"train: the engine's train_mfu {train_mfu} is not within 2 % of the phase's MFU "
                             f"over the last step, {last_step_mfu}")
    want = {"flash_fwd": cfg.n_layers, "flash_bwd_dq": cfg.n_layers, "flash_bwd_dkv": cfg.n_layers,
            OPT_COUNTER[optimizer]: opt_launches(optimizer, rec["leaves"])}
    bad = {name: launches[name] / steps for name in want if launches[name] != want[name] * steps}
    if bad:
        raise AssertionError(f"train: launches per step {bad}, expected {want}")
    if profile:
        profile_train(torch, engine, data, optimizer)
    return rec


# ZeRO stages on the card at world 1 (one process over NCCL): the same gpt2_1_3b run as ``train`` at each stage,
# and LAMB at stage 2. The planner shards nothing at world 1 (as the JAX planner, a ZeRO axis of size 1), so the
# stages differ by their machinery: stage 0 and 1 all-reduce the gradients at the step, stage 2 after every
# backward, stage 3 after every block's backward, gathering each block in bf16 before it runs and again for its
# backward. The losses must equal stage 0's bit for bit.
ZERO_RUNS = [(0, "FusedAdam"), (1, "FusedAdam"), (2, "FusedAdam"), (3, "FusedAdam"), (2, "Lamb")]


def comm_per_step(before: dict, after: dict, steps: int) -> dict:
    return {op: {"calls": (c - before.get(op, [0, 0])[0]) / steps, "bytes": (b - before.get(op, [0, 0])[1]) / steps}
            for op, (c, b) in after.items()}


def zero_run(torch, dev, counters, stage: int, optimizer: str, n_layers=None, steps=TRAIN_STEPS, zero=None,
             remat=False) -> dict:
    """``steps`` steps of gpt2_1_3b (``n_layers`` of them) at ``stage`` on phase_train's seeded batch; steps
    TIMED_FROM+1.. timed, with the engine's collectives a step. ``zero``: more keys of the zero_optimization
    section (ZeRO-Offload's); ``remat``: the model checkpoints every block. Under offload, the host's share
    of a timed step (ZeRO-Offload's ``offload_stats`` over the timed steps, a step's mean)."""
    import itertools

    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM, init_params

    cfg = gpt2_cfg(dtype=torch.bfloat16, remat=remat, **({"n_layers": n_layers} if n_layers else {}))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    config = dict(train_config(torch, optimizer, torch.bfloat16), zero_optimization={"stage": stage, **(zero or {})})
    engine, _, _, _ = dst.initialize(model=CausalLM(cfg), model_parameters=params, config=config, device=dev)
    del params
    torch.cuda.empty_cache()
    data = itertools.repeat(train_batch_data(np, cfg.vocab_size))
    losses = [engine.train_batch(data) for _ in range(TIMED_FROM)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    comm0 = {op: list(v) for op, v in engine.comm_stats.items()}
    off0 = dict(engine.offload_stats)
    t0 = time.perf_counter()
    losses += [engine.train_batch(data) for _ in range(steps - TIMED_FROM)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timed = steps - TIMED_FROM
    off1 = engine.offload_stats
    offload = {k: (v - off0[k]) / timed for k, v in off1.items() if isinstance(v, (int, float)) and k in off0
               and k not in ("offloaded_leaves", "offloaded_param_bytes")}
    return dict(engine=engine, losses=[float(x) for x in losses], step_ms=wall / timed * 1e3,
                tokens_per_s=MICRO * SEQ * timed / wall, max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2**30,
                comm_per_step=comm_per_step(comm0, engine.comm_stats, timed),
                launches={fn.__name__: fn.launches for fn in counters}, timed=timed, layers=cfg.n_layers,
                gathered_peak_gb=engine.zero_gathered_bytes[1] / 2**30, offload_per_step=offload)


def phase_train_zero(torch, dev, counters, want=None) -> dict:
    """gpt2_1_3b at full size at ZeRO stages 0-3 with FusedAdam and at stage 2 with LAMB, 12 steps each, through
    the port's ``init_distributed`` (NCCL, world 1). ``want``: optimizer -> the losses of the ``train`` phase
    with that optimizer (stage 0 without the section), which every run must equal."""
    import numpy as np

    from deepspeed_tpu_torch import comm as dist

    dist.init_distributed(device=dev, verbose=False)
    runs = {}
    for stage, optimizer in ZERO_RUNS:
        r = zero_run(torch, dev, counters, stage, optimizer)
        engine = r.pop("engine")
        base = (want or {}).get(optimizer) or runs.get((0, optimizer), {}).get("losses") or r["losses"]
        rec = dict(phase="train_zero", model="gpt2_1_3b", stage=stage, optimizer=optimizer,
                   backend=dist.backend_for(dev), world_size=dist.get_world_size(), micro_batch=MICRO, seq=SEQ,
                   steps=TRAIN_STEPS, timed_steps=f"{TIMED_FROM + 1}-{TRAIN_STEPS}", **r,
                   losses_equal_stage0=r["losses"] == base,
                   loss_max_abs_diff=max(abs(a - b) for a, b in zip(r["losses"], base)))
        log(rec)
        want_launches = {"flash_fwd": r["layers"], "flash_bwd_dq": r["layers"], "flash_bwd_dkv": r["layers"],
                         OPT_COUNTER[optimizer]: opt_launches(optimizer, len(engine.parameters()))}
        bad = {k: r["launches"].get(k) for k, v in want_launches.items() if r["launches"].get(k) != v * r["timed"]}
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        if bad or not rec["losses_equal_stage0"] or not np.isfinite(r["losses"]).all():
            raise AssertionError(f"train_zero stage {stage} {optimizer}: launches {bad} (want per step "
                                 f"{want_launches}), losses {r['losses']} against {base}")
        runs[(stage, optimizer)] = rec
    return runs


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def phase_ckpt(torch, dev, counters) -> dict:
    """gpt2_1_3b widths at 2 layers, bf16, FusedAdam: 12 straight steps at stage 2; 6 steps, a native checkpoint
    (sync, then async) and a universal one; a fresh stage-2 engine resumes the native one and a fresh stage-3
    engine the universal one, each for 6 steps, which must equal the straight run's last 6 bit for bit;
    zero_to_fp32 must equal the saved masters."""
    import itertools
    import shutil

    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint.zero_to_fp32 import get_fp32_flat_state_dict_from_zero_checkpoint
    from deepspeed_tpu_torch.models import CausalLM, init_params
    from deepspeed_tpu_torch.runtime.checkpoint_engine import AsyncCheckpointEngine

    root = os.path.join(HERE, "build", "ckpt_smoke")
    shutil.rmtree(root, ignore_errors=True)
    layers, half = 2, TRAIN_STEPS // 2
    straight = zero_run(torch, dev, counters, 2, "FusedAdam", n_layers=layers)
    del straight["engine"]
    want = straight["losses"]
    gc.collect()
    torch.cuda.empty_cache()
    first = zero_run(torch, dev, counters, 2, "FusedAdam", n_layers=layers, steps=half)
    engine = first.pop("engine")
    rec = dict(phase="ckpt", model="gpt2_1_3b", layers=layers, params=sum(p.numel() for p in engine.parameters()),
               steps=f"{half} + {half}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.save_checkpoint(os.path.join(root, "native"), tag="half")
    rec["save_s"] = time.perf_counter() - t0
    rec["save_bytes"] = dir_bytes(os.path.join(root, "native", "half"))
    saved = {p: t.detach().cpu() for p, t in zip(engine._paths, engine.full_masters())}
    engine.checkpoint_engine = AsyncCheckpointEngine()
    t0 = time.perf_counter()
    engine.save_checkpoint(os.path.join(root, "async"), tag="half")
    rec["async_save_return_s"] = time.perf_counter() - t0
    engine.checkpoint_engine.wait()
    rec["async_save_durable_s"] = time.perf_counter() - t0
    rec["async_bytes"] = dir_bytes(os.path.join(root, "async", "half"))
    shutil.rmtree(os.path.join(root, "async"))
    t0 = time.perf_counter()
    engine.save_universal_checkpoint(os.path.join(root, "universal"), tag="half")
    rec["universal_save_s"] = time.perf_counter() - t0
    rec["universal_bytes"] = dir_bytes(os.path.join(root, "universal", "half"))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    merged = get_fp32_flat_state_dict_from_zero_checkpoint(os.path.join(root, "native"))
    rec["zero_to_fp32_s"] = time.perf_counter() - t0
    rec["zero_to_fp32_equal"] = set(merged) == set(saved) and all(torch.equal(merged[p], saved[p]) for p in saved)
    del merged, saved
    for label, stage, load in (("native", 2, "load_checkpoint"), ("universal", 3, "load_universal_checkpoint")):
        cfg = gpt2_cfg(dtype=torch.bfloat16, n_layers=layers)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(1), device=dev)  # overwritten by the load
        config = dict(train_config(torch, "FusedAdam", torch.bfloat16), zero_optimization={"stage": stage})
        fresh, _, _, _ = dst.initialize(model=CausalLM(cfg), model_parameters=params, config=config, device=dev)
        del params
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        getattr(fresh, load)(os.path.join(root, label))
        torch.cuda.synchronize()
        rec[f"{label}_load_s"] = time.perf_counter() - t0
        data = itertools.repeat(train_batch_data(np, cfg.vocab_size))
        got = [float(fresh.train_batch(data)) for _ in range(half)]
        rec[f"{label}_losses"] = got
        rec[f"{label}_equal"] = got == want[half:]
        del fresh
        gc.collect()
        torch.cuda.empty_cache()
    rec["straight_losses"] = want
    shutil.rmtree(root, ignore_errors=True)
    log(rec)
    if not (rec["native_equal"] and rec["universal_equal"] and rec["zero_to_fp32_equal"]):
        raise AssertionError(f"ckpt: a resumed run or zero_to_fp32 differs: {rec}")
    return rec


# ZeRO-Offload and activation checkpointing on the card. The host C++ of the offload path (``csrc/host/``) is
# host code: its rows stand on a line of their own (``host_code``), not in the kernels line.
HOST_AIO_BYTES = 1 << 30
# The host Adam and fused_adam round differently (fused_adam folds the gradient multiplier and the bias
# corrections into one kernel, the host step scales the gradient first, as the JAX offload optimizer does), so
# masters part by an fp32 rounding after the first step, and the bf16 forward turns that into loss differences
# of ~1e-3 over a few warm-up steps; the limit is 20x above that guess.
OFFLOAD_LOSS_TOL = 2e-2
OFFLOAD_STEPS = 6  # steps TIMED_FROM+1.. are timed; the host step makes each one take seconds
OFFLOAD_HOST_BYTES_PER_PARAM = 16  # fp32 master, two moments and the pinned gradient buffer


def host_rss_gb() -> dict:
    """This process's resident host memory (``/proc/self/status``) and its peak (``getrusage``)."""
    import resource

    rss = None
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                rss = int(line.split()[1]) / 2**20
    return {"rss_gb": rss, "peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20}


def mem_available_gb() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


# host_optim's leaves: gpt2_1_3b's embeddings, final norm and its first 6 of 24 layers, a depth cut for the whole
# script's time limit (the plain version over all 388 leaves, 1.3e9 elements, takes 20-38 s)
HOST_OPTIM_LAYERS = 6


def phase_host_optim(torch) -> dict:
    """The host C++ of ZeRO-Offload on the card machine's CPU: ``cpu_adam_step`` against its plain version at
    ``wte`` (50,257 x 2,048) and over gpt2_1_3b's leaves of HOST_OPTIM_LAYERS layers (with the embeddings and the
    final norm) one by one (one host step), with ms, GB/s (7 fp32
    streams an element: p, g, m, v read, p, m, v written) and the thread count; then the AIO pool writing
    and reading 1 GiB under ``build/``."""
    import shutil

    import numpy as np

    from deepspeed_tpu_torch.ops.adam import cpu_adam as ca
    from deepspeed_tpu_torch.ops.aio import AsyncIOHandle

    threads = torch.get_num_threads()
    leaves = [(p, s) for p, s in gpt2_leaf_shapes()
              if not p.startswith("layer_") or int(p.split("/")[0].split("_")[1]) < HOST_OPTIM_LAYERS]
    gen = torch.Generator().manual_seed(0)
    # one seeded pool a state, as large as the largest leaf; each leaf steps copies of its first elements
    wte = (50257, 2048)
    most = max([math.prod(wte)] + [int(math.prod(s)) for _, s in leaves])
    pool_p, pool_g = torch.randn(most, generator=gen), torch.randn(most, generator=gen)
    pool_m, pool_v = torch.randn(most, generator=gen) * 0.01, torch.rand(most, generator=gen) * 1e-4

    def one(shape, step=2):
        n = int(math.prod(shape))
        g = pool_g[:n].view(shape)
        p, m, v = (x[:n].view(shape).clone() for x in (pool_p, pool_m, pool_v))
        rp, rm, rv = p.clone(), m.clone(), v.clone()
        t0 = time.perf_counter()
        ca.cpu_adam_step(p, g, m, v, 1e-4, 0.9, 0.999, 1e-8, 0.01, step)
        c_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ca.cpu_adam_ref(rp, g, rm, rv, 1e-4, 0.9, 0.999, 1e-8, 0.01, step)
        plain_s = time.perf_counter() - t0
        err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30)) for a, b in ((p, rp), (m, rm), (v, rv)))
        return c_s, plain_s, err, p.numel()

    t0 = time.perf_counter()
    ca._lib()  # the first use builds the host library: not part of a step's time
    rec = dict(phase="host_optim", threads=threads, cpu_count=os.cpu_count(), build_s=time.perf_counter() - t0)
    ca.cpu_adam_step.launches = 0
    c_s, plain_s, err, n = one(wte)
    rec["wte"] = dict(shape=list(wte), ms=c_s * 1e3, plain_ms=plain_s * 1e3, gbps=28 * n / c_s / 1e9,
                      max_rel_err=err)
    total_c = total_plain = 0.0
    worst = 0.0
    elems = 0
    for _, shape in leaves:
        c_s, plain_s, err, n = one(shape)
        total_c += c_s
        total_plain += plain_s
        worst = max(worst, err)
        elems += n
    rec["all"] = dict(leaves=len(leaves), elements=elems, ms=total_c * 1e3, plain_ms=total_plain * 1e3,
                      gbps=28 * elems / total_c / 1e9, max_rel_err=worst, calls=ca.cpu_adam_step.launches)
    folder = os.path.join(HERE, "build", "aio_smoke")
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    chunks = 16
    bufs = [torch.from_numpy(np.random.default_rng(i).integers(0, 255, HOST_AIO_BYTES // chunks, dtype=np.uint8))
            for i in range(chunks)]
    h = AsyncIOHandle(num_threads=8)
    t0 = time.perf_counter()
    for i, b in enumerate(bufs):
        h.async_pwrite(b, os.path.join(folder, f"chunk{i}.bin"))
    errors = h.wait()
    write_s = time.perf_counter() - t0
    back = [torch.empty_like(b) for b in bufs]
    t0 = time.perf_counter()
    for i, b in enumerate(back):
        h.async_pread(b, os.path.join(folder, f"chunk{i}.bin"))
    errors += h.wait()
    read_s = time.perf_counter() - t0
    h.close()
    equal = all(torch.equal(a, b) for a, b in zip(bufs, back))
    shutil.rmtree(folder, ignore_errors=True)
    rec["aio"] = dict(bytes=HOST_AIO_BYTES, files=chunks, threads=8, write_s=write_s, read_s=read_s,
                      write_gbps=HOST_AIO_BYTES / write_s / 1e9, read_gbps=HOST_AIO_BYTES / read_s / 1e9,
                      errors=errors, equal=equal, note="warm page cache: the reads may not reach the disk")
    log(rec)
    if rec["wte"]["max_rel_err"] > 1e-6 or rec["all"]["max_rel_err"] > 1e-6 or errors or not equal:
        raise AssertionError(f"host_optim: the host Adam differs from its plain version or the AIO failed: {rec}")
    if rec["all"]["calls"] != len(leaves) + 1:
        raise AssertionError(f"host_optim: {rec['all']['calls']} cpu_adam_step calls, expected {len(leaves) + 1}")
    return rec


# the train_offload runs: (name, stage, zero_optimization keys, remat, the train_zero stage its losses are held to)
OFFLOAD_RUNS = [
    ("stage2_offload_optimizer_cpu", 2, {"offload_optimizer": {"device": "cpu"}}, False),
    ("stage3_offload_param_cpu_optimizer_cpu", 3, {"offload_param": {"device": "cpu"},
                                                    "offload_optimizer": {"device": "cpu"}}, False),
    ("stage3_remat", 3, {}, True),
]


def offload_layers(torch, n_layers: int) -> tuple:
    """The depth whose host state fits in ``MemAvailable`` (masters, moments, pinned gradient buffers, with a
    quarter to spare), and the bytes it wants."""
    cfg = gpt2_cfg(dtype=torch.bfloat16)
    per_layer = sum(int(math.prod(s)) for k, s in gpt2_leaf_shapes() if k.startswith("layer_0/"))
    rest = sum(int(math.prod(s)) for k, s in gpt2_leaf_shapes() if not k.startswith("layer_"))
    avail = mem_available_gb() * 2**30
    need = lambda n: (rest + n * per_layer) * OFFLOAD_HOST_BYTES_PER_PARAM * 1.25
    layers = n_layers
    while layers > 1 and need(layers) > avail:
        layers -= 1
    return layers, need(cfg.n_layers) / 2**30, avail / 2**30


def phase_train_offload(torch, dev, counters, zero_runs) -> dict:
    """gpt2_1_3b at full width (depth as the host's memory allows, printed) through ``initialize`` and
    ``train_batch``, world 1 over NCCL: stage 2 with ``offload_optimizer: cpu``, stage 3 with ``offload_param``
    and ``offload_optimizer`` on the cpu, and stage 3 with the model's remat. Each run: step ms split into the
    device's share and ZeRO-Offload's d2h, host step and h2d, the bytes moved, device peak, host RSS; losses
    against train_zero's at the same stage (``zero_runs``), within OFFLOAD_LOSS_TOL under offload and bit for
    bit with remat, whose peak must be lower; the flash kernels launch as in train_zero (the remat forward
    twice), ``fused_adam`` never under optimizer offload, where the host Adam steps every leaf once a step."""
    import numpy as np

    from deepspeed_tpu_torch.ops.adam import cpu_adam as ca

    full = gpt2_cfg(dtype=torch.bfloat16).n_layers
    layers, need_gb, avail_gb = offload_layers(torch, full)
    log(dict(phase="train_offload", mem_available_gb=avail_gb, host_state_wanted_gb=need_gb, layers=layers,
             depth_cut=layers < full))
    runs = {}
    for name, stage, zero, remat in OFFLOAD_RUNS:
        ca.cpu_adam_step.launches = 0
        rss0 = host_rss_gb()
        r = zero_run(torch, dev, counters, stage, "FusedAdam", n_layers=layers if layers < full else None,
                     steps=OFFLOAD_STEPS, zero=zero, remat=remat)
        engine = r.pop("engine")
        host_calls = ca.cpu_adam_step.launches
        leaves = len(engine.parameters())
        base = zero_runs[(stage, "FusedAdam")]
        want = base["losses"][:OFFLOAD_STEPS]
        diff = max(abs(a - b) for a, b in zip(r["losses"], want))
        off = r["offload_per_step"]
        split = {k: off.get(k, 0.0) * 1e3 for k in ("d2h_s", "host_s", "h2d_s")}
        rec = dict(phase="train_offload", run=name, model="gpt2_1_3b", stage=stage, remat=remat, layers=r["layers"],
                   micro_batch=MICRO, seq=SEQ, steps=OFFLOAD_STEPS, timed_steps=f"{TIMED_FROM + 1}-{OFFLOAD_STEPS}",
                   losses=r["losses"], train_zero_losses=want, loss_max_abs_diff=diff,
                   losses_equal_train_zero=r["losses"] == want, step_ms=r["step_ms"], tokens_per_s=r["tokens_per_s"],
                   step_split_ms=dict(device_and_rest=r["step_ms"] - sum(split.values()),
                                      d2h=split["d2h_s"], host_step=split["host_s"], h2d=split["h2d_s"]),
                   bytes_per_step={k: off.get(k, 0) for k in ("d2h_bytes", "h2d_bytes", "param_h2d_bytes")},
                   param_copies_per_step=off.get("param_copies", 0), offload=engine.offload_stats,
                   max_memory_allocated_gb=r["max_memory_allocated_gb"],
                   train_zero_max_memory_allocated_gb=base["max_memory_allocated_gb"],
                   gathered_peak_gb=r["gathered_peak_gb"], host_before=rss0, host_after=host_rss_gb(),
                   launches=r["launches"], host_adam_calls=host_calls, leaves=leaves,
                   train_zero_step_ms=base["step_ms"])
        log(rec)
        n = r["layers"]
        want_launches = {"flash_fwd": 2 * n if remat else n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
                         "fused_adam": 0 if zero else 1}
        bad = {k: r["launches"].get(k) for k, v in want_launches.items() if r["launches"].get(k) != v * r["timed"]}
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        problems = []
        if bad:
            problems.append(f"launches {bad}, want per step {want_launches}")
        if zero and host_calls != leaves * OFFLOAD_STEPS:
            problems.append(f"{host_calls} host Adam calls, want {leaves} a step")
        if not np.isfinite(r["losses"]).all():
            problems.append("losses not finite")
        if layers == full:  # the losses and peaks of train_zero's runs are at full depth
            if remat and not rec["losses_equal_train_zero"]:
                problems.append("remat's losses differ from stage 3's")
            if not remat and diff > OFFLOAD_LOSS_TOL:
                problems.append(f"losses {diff} from train_zero's, limit {OFFLOAD_LOSS_TOL}")
            if not r["max_memory_allocated_gb"] < base["max_memory_allocated_gb"]:
                problems.append("device peak not below train_zero's at the same stage")
        if problems:
            raise AssertionError(f"train_offload {name}: " + "; ".join(problems))
        runs[name] = rec
    return runs


def phase_offload_nvme(torch, dev, counters) -> dict:
    """gpt2_1_3b widths at 2 layers, bf16, stage 3: ``offload_param`` and ``offload_optimizer`` on the cpu
    (the reference), then both on NVMe under ``build/`` (moments in swap files, masters in mapped files):
    losses equal the cpu run's bit for bit; then an NVMe run of 3 steps saves a native checkpoint and a fresh
    NVMe engine resumes it for 3 more, equal to the reference's last 3 bit for bit."""
    import itertools
    import shutil

    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM, init_params

    root = os.path.join(HERE, "build", "offload_nvme")
    shutil.rmtree(root, ignore_errors=True)
    layers, steps, half = 2, OFFLOAD_STEPS, OFFLOAD_STEPS // 2

    def nvme(sub):
        path = os.path.join(root, sub)
        return {"offload_param": {"device": "nvme", "nvme_path": path},
                "offload_optimizer": {"device": "nvme", "nvme_path": path, "pipeline_read": True}}

    cpu = {"offload_param": {"device": "cpu"}, "offload_optimizer": {"device": "cpu"}}
    ref = zero_run(torch, dev, counters, 3, "FusedAdam", n_layers=layers, steps=steps, zero=cpu)
    del ref["engine"]
    gc.collect()
    run = zero_run(torch, dev, counters, 3, "FusedAdam", n_layers=layers, steps=steps, zero=nvme("straight"))
    engine = run.pop("engine")
    rec = dict(phase="offload_nvme", model="gpt2_1_3b", layers=layers, stage=3, steps=steps,
               cpu_losses=ref["losses"], nvme_losses=run["losses"], nvme_equal_cpu=run["losses"] == ref["losses"],
               cpu_step_ms=ref["step_ms"], nvme_step_ms=run["step_ms"], cpu_offload_per_step=ref["offload_per_step"],
               nvme_offload_per_step=run["offload_per_step"], swap_files=sum(
                   f.endswith(".swp") for _, _, fs in os.walk(root) for f in fs),
               master_files=sum(f.startswith("master_") for _, _, fs in os.walk(root) for f in fs),
               nvme_bytes=dir_bytes(root))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(root, "straight"), ignore_errors=True)
    first = zero_run(torch, dev, counters, 3, "FusedAdam", n_layers=layers, steps=half, zero=nvme("first"))
    engine = first.pop("engine")
    t0 = time.perf_counter()
    engine.save_checkpoint(os.path.join(root, "ckpt"), tag="half")
    rec["save_s"] = time.perf_counter() - t0
    rec["save_bytes"] = dir_bytes(os.path.join(root, "ckpt"))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    cfg = gpt2_cfg(dtype=torch.bfloat16, n_layers=layers)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1), device=dev)  # overwritten by the load
    config = dict(train_config(torch, "FusedAdam", torch.bfloat16), zero_optimization={"stage": 3, **nvme("resumed")})
    fresh, _, _, _ = dst.initialize(model=CausalLM(cfg), model_parameters=params, config=config, device=dev)
    del params
    t0 = time.perf_counter()
    fresh.load_checkpoint(os.path.join(root, "ckpt"))
    rec["load_s"] = time.perf_counter() - t0
    data = itertools.repeat(train_batch_data(np, cfg.vocab_size))
    got = first["losses"] + [float(fresh.train_batch(data)) for _ in range(steps - half)]
    rec["resumed_losses"] = got
    rec["resumed_equal"] = got == ref["losses"]
    del fresh
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    log(rec)
    if not (rec["nvme_equal_cpu"] and rec["resumed_equal"] and rec["swap_files"] and rec["master_files"]):
        raise AssertionError(f"offload_nvme: NVMe differs from cpu offload or the resume is not exact: {rec}")
    return rec


# ZeRO++ on the card at world 1: a ZeRO++ config (qwZ + qgZ + hpZ 2 at stage 3) falls back to plain stage 3 with
# the JAX package's reason (its wire formats need an fsdp axis above 1; the card machine's one GPU gives a world of
# one, and NCCL takes one rank a GPU), and trains stage 3's losses bit for bit; gpt2_1_3b at 2 layers keeps it short
ZEROPP = {"zero_quantized_weights": True, "zero_quantized_gradients": True, "zero_hpz_partition_size": 2}
ZEROPP_REASON = "ZeRO++ needs an fsdp axis > 1"  # deepspeed_tpu/runtime/zero/zeropp.py zeropp_applicable's words


class log_lines(logging.Handler):
    """Keeps the messages of a logger over the enclosed code."""

    def __init__(self, name):
        super().__init__(logging.INFO)
        self.logger, self.lines = logging.getLogger(name), []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        self.level0 = self.logger.level
        self.logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.level0)


def phase_train_zeropp(torch, dev, counters) -> dict:
    """Stage 3 at 2 layers, then the same with ZeRO++'s keys: the fallback is logged with JAX's reason, the
    engine runs no ZeRO++ wire format, and the losses equal plain stage 3's bit for bit."""
    import numpy as np

    from deepspeed_tpu_torch import comm as dist

    dist.init_distributed(device=dev, verbose=False)
    layers = 2
    base = zero_run(torch, dev, counters, 3, "FusedAdam", n_layers=layers)
    del base["engine"]
    gc.collect()
    torch.cuda.empty_cache()
    with log_lines("deepspeed_tpu_torch.runtime.engine") as lines:
        r = zero_run(torch, dev, counters, 3, "FusedAdam", n_layers=layers, zero=ZEROPP)
    engine = r.pop("engine")
    want_launches = {"flash_fwd": layers, "flash_bwd_dq": layers, "flash_bwd_dkv": layers,
                     "fused_adam": opt_launches("FusedAdam", len(engine.parameters()))}
    rec = dict(phase="train_zeropp", model="gpt2_1_3b", layers=layers, zero_optimization=ZEROPP,
               world_size=dist.get_world_size(), backend=dist.backend_for(dev), zeropp_active=engine.zeropp_active,
               zeropp_reason=engine.zeropp_reason,
               logged=[line for line in lines.lines if line.startswith("ZeRO++")], losses=r["losses"],
               stage3_losses=base["losses"], losses_equal_stage3=r["losses"] == base["losses"],
               step_ms=r["step_ms"], stage3_step_ms=base["step_ms"], comm_per_step=r["comm_per_step"],
               launches=r["launches"], timed=r["timed"])
    log(rec)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    bad = {k: r["launches"].get(k) for k, v in want_launches.items() if r["launches"].get(k) != v * r["timed"]}
    if (rec["zeropp_active"] or rec["zeropp_reason"] != ZEROPP_REASON or not rec["logged"]
            or ZEROPP_REASON not in rec["logged"][0] or not rec["losses_equal_stage3"] or bad
            or not np.isfinite(r["losses"]).all() or any(op.startswith(("quant", "hpz")) for op in r["comm_per_step"])):
        raise AssertionError(f"train_zeropp: {rec}, launches off: {bad}")
    return rec


# MoE training on the card: Mixtral-8x7B-v0.1's widths (``mixtral_cfg``) at 2 of its 32 layers (about 3.17 B
# parameters: fp32 masters, fp32 gradients, Adam's two moments and the bf16 copy take about 18 bytes a parameter,
# 57 GB), every block MoE with GShard's capacity einsums (capacity factor 1.25, tokens dropped), bf16, FusedAdam,
# micro-batch 1 x 2,048 seeded tokens, 6 steps through ``initialize`` at world 1 over NCCL with ``mesh: {expert:
# 1}``, at stage 0 and again at stage 3
MOE_TRAIN = dict(layers=2, tokens=2048, steps=6, capacity_factor=1.25)


class moe_gate_log:
    """Wraps the training gate's ``top_k`` (``moe/sharded_moe.py``) and ``MoE.__call__`` over the enclosed code:
    ``choices`` holds each gate call's experts and ``aux`` each layer's ``(l_aux, exp_counts)``. With ``pin``
    (another log's choices) each gate call takes the pinned experts of the same call instead of its own, and
    ``flips`` counts the tokens whose own choice differs (a bf16 difference upstream can reorder near-equal gate
    values, and a token on another expert is another function, not a rounding)."""

    def __init__(self, pin=None):
        self.pin, self.choices, self.aux, self.flips = pin, [], [], 0

    def __enter__(self):
        from deepspeed_tpu_torch.moe import layer, sharded_moe

        self.sm, self.layer = sharded_moe, layer
        inner, call = self._top_k, self._call = sharded_moe.top_k, layer.MoE.__call__

        def top_k(x, k):
            vals, idx = inner(x, k)
            self.choices.append(idx.detach().clone())
            if self.pin is None:
                return vals, idx
            pinned = self.pin[len(self.choices) - 1]
            self.flips += int((idx.sort(-1).values != pinned.sort(-1).values).any(-1).sum())
            return x.gather(-1, pinned), pinned

        def moe_call(moe, *args, **kw):
            out = call(moe, *args, **kw)
            self.aux.append((out[1].detach().float(), out[2].detach()))
            return out

        sharded_moe.top_k, layer.MoE.__call__ = top_k, moe_call
        return self

    def __exit__(self, *exc):
        self.sm.top_k, self.layer.MoE.__call__ = self._top_k, self._call


def moe_engine(torch, dev, cfg, stage: int):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM, init_params

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    config = dict(train_config(torch, "FusedAdam", torch.bfloat16), train_micro_batch_size_per_gpu=1,
                  mesh={"expert": 1}, zero_optimization={"stage": stage})
    engine, _, _, _ = dst.initialize(model=CausalLM(cfg), model_parameters=params, config=config, device=dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return engine


def phase_train_moe(torch, dev, counters) -> dict:
    """Mixtral-width MoE training (``MOE_TRAIN``): the first step's loss and attention gradients with the flash
    kernels and with their plain versions (the plain run on the kernel run's routing), then 6 steps at stage 0
    with the counters zeroed before and read after (flash forward, dq and dk/dv once a layer a step, fused_adam
    once a param group a step), step ms, tokens/s, the device peak, the last step's expert counts, dropped share
    and aux losses; then the same 6 steps at stage 3, whose losses must equal stage 0's bit for bit."""
    import contextlib
    import itertools

    import numpy as np

    from deepspeed_tpu_torch import comm as dist

    dist.init_distributed(device=dev, verbose=False)
    L, T, steps = MOE_TRAIN["layers"], MOE_TRAIN["tokens"], MOE_TRAIN["steps"]
    cfg = mixtral_cfg(n_layers=L, dtype=torch.bfloat16, moe_capacity_factor=MOE_TRAIN["capacity_factor"])
    batch = {"input_ids": np.random.default_rng(0).integers(0, cfg.vocab_size, (1, T)).astype(np.int32)}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = moe_engine(torch, dev, cfg, 0)
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in engine.parameters())
    attn = [i for i, p in enumerate(engine._paths) if "/attn/" in p]
    check, logs = {}, {}
    for variant in ("kernel", "plain"):
        for fn in counters:
            fn.launches = 0
        with contextlib.ExitStack() as stack:
            if variant == "plain":
                stack.enter_context(PlainKernels())
            logs[variant] = stack.enter_context(moe_gate_log(pin=logs["kernel"].choices if variant == "plain"
                                                             else None))
            loss = engine.forward(batch)
            engine.backward(loss)
        torch.cuda.synchronize()
        check[variant] = dict(loss=float(loss), grads=[engine._grad_acc[i].clone() for i in attn],
                              launches={fn.__name__: fn.launches for fn in counters})
        engine.zero_grad()
    k, p = check["kernel"], check["plain"]
    tol = {"loss_abs_err": 5e-5, "grad_max_rel_err": 0.035}  # phase_train_parity's bf16 limits
    rec = dict(phase="train_moe", model="mixtral_8x7b", layers=L, d_model=cfg.d_model, heads=cfg.n_heads,
               kv_heads=cfg.kv_heads, d_ff=cfg.ffn_dim, experts=cfg.moe_num_experts, top_k=cfg.moe_top_k,
               capacity_factor=cfg.moe_capacity_factor, vocab=cfg.vocab_size, params=n_params,
               leaves=len(engine.parameters()), dtype="bfloat16", micro_batch=1, seq=T, steps=steps,
               backend=dist.backend_for(dev), world_size=dist.get_world_size(),
               mesh={a: engine.topology.axis_size(a) for a in ("data", "fsdp", "expert")}, setup_s=setup_s,
               first_loss=k["loss"], loss_abs_err=abs(k["loss"] - p["loss"]),
               grad_max_rel_err=max(((a - b).abs().max() / b.abs().max()).item()
                                    for a, b in zip(k["grads"], p["grads"])),
               routing="plain pinned to the kernel run's", routing_flips=logs["plain"].flips,
               routed_tokens=T * L, check_launches=k["launches"], plain_launches=p["launches"], tol=tol)
    del check
    data = itertools.repeat(batch)
    runs = {}
    for stage in (0, 3):
        if stage == 3:
            del engine
            gc.collect()
            torch.cuda.empty_cache()
            engine = moe_engine(torch, dev, cfg, 3)
        for fn in counters:
            fn.launches = 0
        losses = [engine.train_batch(data) for _ in range(TIMED_FROM)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [engine.train_batch(data) for _ in range(steps - TIMED_FROM - 1)]
        with moe_gate_log() as last:
            losses.append(engine.train_batch(data))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        timed = steps - TIMED_FROM
        launches = {fn.__name__: fn.launches for fn in counters}
        counts = [c.tolist() for _, c in last.aux]
        runs[stage] = dict(losses=[float(x) for x in losses], step_ms=wall / timed * 1e3,
                           tokens_per_s=T * timed / wall, launches=launches,
                           launches_per_step={n: v / steps for n, v in launches.items()},
                           exp_counts=counts, aux_loss=[float(a) for a, _ in last.aux],
                           dropped_share=[1 - sum(c) / (cfg.moe_top_k * T) for c in counts],
                           grad_norm=engine.get_global_grad_norm(),
                           max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2**30)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    rec.update(stage0=runs[0], stage3=runs[3], losses_equal_stage0=runs[3]["losses"] == runs[0]["losses"],
               timed_steps=f"{TIMED_FROM + 1}-{steps}")
    log(rec)
    want = {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "fused_adam": opt_launches("FusedAdam", rec["leaves"])}
    bad = {(stage, n): r["launches"].get(n) for stage, r in runs.items() for n, v in want.items()
           if r["launches"].get(n) != v * steps}
    bad.update({("check", n): rec["check_launches"].get(n) for n in want if n != "fused_adam"
                and rec["check_launches"].get(n) != L})
    if (bad or any(rec["plain_launches"].values()) or not rec["losses_equal_stage0"]
            or not all(np.isfinite(r["losses"]).all() for r in runs.values())
            or not all(rec[key] <= t for key, t in tol.items())):
        raise AssertionError(f"train_moe failed: launches off {bad}; {rec}")
    return rec


def host_code_rows(host, offload) -> list:
    """The host C++ of the offload path, each with what bounds it and its times here."""
    run = offload["stage2_offload_optimizer_cpu"]
    return [
        {"name": "cpu_adam_step", "route": "host C++ (g++ -O3 -march=native -fopenmp)",
         "source": "deepspeed_tpu_torch/csrc/host/cpu_adam.cpp", "replaces": "csrc/cpu_adam.cpp",
         "bound_by": "host memory bandwidth", "threads": host["threads"], "wte_ms": host["wte"]["ms"],
         "wte_gbps": host["wte"]["gbps"], "all_leaves_ms": host["all"]["ms"], "all_leaves_gbps": host["all"]["gbps"],
         "all_leaves": host["all"]["leaves"], "plain_ms": host["all"]["plain_ms"],
         "max_rel_err": host["all"]["max_rel_err"],
         "host_step_ms_in_train_offload": run["step_split_ms"]["host_step"], "calls": run["host_adam_calls"]},
        {"name": "aio", "route": "host C++ (std::thread pool, pread / pwrite)",
         "source": "deepspeed_tpu_torch/csrc/host/aio.cpp", "replaces": "csrc/aio.cpp", "bound_by": "disk",
         "bytes": host["aio"]["bytes"], "write_gbps": host["aio"]["write_gbps"],
         "read_gbps": host["aio"]["read_gbps"]},
    ]


# kernel path vs plain path, forward and backward end to end. bf16: per-row relative error with each
# row's scale at least the tensor's mean magnitude, at about twice the worst measured on an H100 (dq
# 3.9e-2 at msa_row_pair; every other output and gradient at most 2.3e-2): each path's own bf16 o
# enters delta = rowsum(o * dO), so the two backward passes start from deltas one bf16 rounding apart,
# on top of the kernels' own 1e-2. fp32 (measured at most 8e-7): abs error over max(1, max |want|),
# as the kernel checks.
EVO_PATH_TOL = {"torch.bfloat16": ("max_rel_err", 0.08), "torch.float32": ("max_abs_err_scaled", 1e-5)}


# an evoformer call's kernels: the flash bodies, and the rest (the bias fold's sum and cast, autograd's
# reductions of dbias to the biases' shapes, delta)
EVO_CATS = {"flash_fwd": ("flash_fwd",), "flash_bwd_dq": ("flash_dq_bf16_kernel", "flash_dq_kernel"),
            "flash_bwd_dq_collapsed": ("flash_dq_collapsed", "dbias_reduce_kernel"),
            "flash_bwd_dkv": ("flash_dkv",), "reduce (dbias sums, delta)": ("reduce_kernel",),
            "elementwise (bias fold, casts)": ("elementwise_kernel",), "copy": ("Memcpy", "Memset", "copy")}


def evo_rest(torch, q, do, biases, iters) -> dict:
    """CUDA-event times of what an evoformer call does besides its flash
    kernels: the bias fold (``fold_biases`` summing the biases, ``flat_bias``'s
    fp32 copy), its backward (autograd's reduction of dbias to each bias's
    shape) and delta = rowsum(o * do)."""
    from deepspeed_tpu_torch.ops import evoformer as evo, flash_attention as fa

    lead, (Sq, H, D) = q.shape[:-3], q.shape[-3:]
    B = q.numel() // (Sq * H * D)
    leaves = [b.detach().requires_grad_(True) for b in biases]
    fold = lambda: fa.flat_bias(*evo.fold_biases(leaves, lead), B, H, Sq, Sq)[0]
    folded = fold()
    dbias = torch.ones_like(folded)
    o, dof = q.reshape(B, Sq, H, D), do.reshape(B, Sq, H, D)  # q stands in for o: the same shape and type
    return dict(bias_fold_ms=time_ms(fold, iters),
                dbias_reduce_ms=time_ms(lambda: torch.autograd.grad(folded, leaves, dbias, retain_graph=True), iters),
                delta_ms=time_ms(lambda: fa.flash_delta(o, dof), iters))


def phase_evoformer(torch, dev, counters, profile=False):
    """``DS4Sci_EvoformerAttention(q, k, v, biases)`` forward and backward
    through autograd (gradients of q, k, v and every bias) at the AlphaFold2
    shapes, bf16 and fp32 (the fine-tuning crop bf16): the counters are zeroed
    just before each call and read just after; each route must launch the
    forward, dk/dv and the dq its layout selects. The same call with the plain
    versions bound in place gives the output and gradients to compare with;
    ms per forward + backward and peak memory for both, and on the --parent
    kernels; the times of the work around the kernels (``evo_rest``).
    ``profile``: a torch.profiler breakdown of ten bf16 calls at ``msa_row``
    and at the crop."""
    from deepspeed_tpu_torch.ops import evoformer as evo, flash_attention as fa

    def step(q, k, v, do, biases):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v, *biases)]
        out = evo.DS4Sci_EvoformerAttention(*leaves[:3], leaves[3:])
        out.backward(do)
        return [out.detach()] + [t.grad for t in leaves]

    recs, total = [], {fn.__name__: 0 for fn in counters}
    for dtype in (torch.bfloat16, torch.float32):
        for name, c in EVO_SHAPES.items():
            if str(dtype) not in c.get("dtypes", (str(dtype),)):
                continue
            q, k, v, do, biases = evo_inputs(torch, dev, dtype, name)
            for fn in counters:
                fn.launches = 0
            got = step(q, k, v, do, biases)
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in counters}
            with PlainKernels():
                want = step(q, k, v, do, biases)
                torch.cuda.synchronize()
                plain_launches = sum(fn.launches for fn in counters) - sum(launches.values())
                torch.cuda.reset_peak_memory_stats()
                step(q, k, v, do, biases)
                plain_peak = torch.cuda.max_memory_allocated() / 2**30
                plain_ms = time_ms(lambda: step(q, k, v, do, biases), 3, warmup=1)
            labels = ["out", "dq", "dk", "dv"] + [f"dbias{i}{tuple(b.shape)}" for i, b in enumerate(biases)]
            errs = {lab: evo_err(torch, a, b) for lab, a, b in zip(labels, got, want)}
            finite = all(torch.isfinite(t).all().item() for t in got)
            del got, want
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step(q, k, v, do, biases)
            peak = torch.cuda.max_memory_allocated() / 2**30
            kernel_ms = time_ms(lambda: step(q, k, v, do, biases), 10)
            parent_peak = None
            if PARENT["lib"] is not None:
                with parent_kernels():
                    torch.cuda.reset_peak_memory_stats()
                    step(q, k, v, do, biases)
                    parent_peak = torch.cuda.max_memory_allocated() / 2**30
            parent_ms = parent_time(time_ms, lambda: step(q, k, v, do, biases), 10)
            if parent_ms is not None:  # this tree, parent, parent, this tree: each side its faster mean of 10,
                # so that the host's drift over the run (small calls are host-bound) falls on both sides alike
                parent_ms = min(parent_ms, parent_time(time_ms, lambda: step(q, k, v, do, biases), 10))
                kernel_ms = min(kernel_ms, time_ms(lambda: step(q, k, v, do, biases), 10))
            if profile and dtype == torch.bfloat16 and name in ("msa_row", "msa_row_finetune"):
                log(dict(phase="profile_evoformer", case=name, calls=10,
                         **profiled(torch, lambda: [step(q, k, v, do, biases) for _ in range(10)], EVO_CATS)))
            what, tol = EVO_PATH_TOL[str(dtype)]
            B, (Sq, H, _) = q.numel() // q.shape[-3:].numel(), q.shape[-3:]
            meta = fa.flat_bias(*evo.fold_biases(biases, q.shape[:-3]), B, H, Sq, Sq)[1]
            collapsed = fa.bias_is_collapsed(meta, B, H)
            need = ["flash_fwd", "flash_bwd_dkv", "flash_bwd_dq_collapsed" if collapsed else "flash_bwd_dq"]
            rec = dict(phase="evoformer", case=name, dtype=str(dtype), q=tuple(q.shape),
                       biases=[tuple(b.shape) for b in biases], dq_route=need[2], launches=launches,
                       plain_launches=plain_launches, errors={lab: e[what] for lab, e in errs.items()},
                       max_abs_err={lab: e["max_abs_err"] for lab, e in errs.items()}, tol=(what, tol),
                       ms_per_fwd_bwd=kernel_ms, plain_ms_per_fwd_bwd=plain_ms, peak_memory_gb=peak,
                       plain_peak_memory_gb=plain_peak, parent_ms_per_fwd_bwd=parent_ms,
                       parent_peak_memory_gb=parent_peak, rest=evo_rest(torch, q, do, biases, 10), finite=finite)
            log(rec)
            for key in total:
                total[key] += launches[key]
            if not (finite and all(e[what] <= tol for e in errs.values()) and all(launches[n] > 0 for n in need)
                    and plain_launches == 0):
                raise AssertionError(f"evoformer {name} {dtype}: {rec}")
            recs.append(rec)
            del q, k, v, do, biases
            torch.cuda.empty_cache()
    return dict(phase="evoformer", launches=total, records=recs)


# ---------------------------------------------------------------- block-sparse attention (SparseSelfAttention)
# Attention widths of models the repository supports at the lengths sparse attention is used for, each
# with a layout from a public source. q is (B, S, H, D); KV heads `kvh` are expanded to H before the
# kernels, as the path does.
SPARSE_SHAPES = {
    # gpt2_1_3b's heads at a long context with the upstream FixedSparsityConfig defaults (Sparse Transformer)
    "fixed_uni_gpt2_1_3b": dict(config="FixedSparsityConfig", fields=dict(
        num_heads=32, block=16, num_local_blocks=4, num_global_blocks=1, attention="unidirectional"),
        q=(2, 8192, 32, 64), kvh=32, causal=True),
    # BERT-base / gpt2_125m width; the `fixed` example of DeepSpeed's sparse-attention tutorial
    "fixed_bi_bert": dict(config="FixedSparsityConfig", fields=dict(
        num_heads=12, block=16, different_layout_per_head=True, num_local_blocks=4, num_global_blocks=1,
        num_different_global_patterns=4), q=(8, 4096, 12, 64), kvh=12, causal=False),
    # google/bigbird-roberta-base: 12 heads of 64, block 64, 3 random blocks, 4096 positions
    "bigbird_base": dict(config="BigBirdSparsityConfig", fields=dict(
        num_heads=12, block=64, num_random_blocks=3, num_sliding_window_blocks=3, num_global_blocks=1),
        q=(8, 4096, 12, 64), kvh=12, causal=False),
    # llama3_8b's heads (32 query / 8 KV, D 128): GQA expansion, D 128, block 64
    "longformer_gqa_llama3_8b": dict(config="BSLongformerSparsityConfig", fields=dict(
        num_heads=32, block=64, num_sliding_window_blocks=3, global_block_indices=[0], attention="unidirectional"),
        q=(1, 8192, 32, 128), kvh=8, causal=True),
    # the port's flash kernels' gpt2_1_3b training shape (FLASH_CASES): a dense layout, held to flash
    "dense_gpt2_1_3b": dict(config="DenseSparsityConfig", fields=dict(num_heads=32, block=64),
                            q=(8, 1024, 32, 64), kvh=32, causal=True),
}


def sparse_config(name):
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    c = SPARSE_SHAPES[name]
    return getattr(sa, c["config"])(**c["fields"])


def sparse_inputs(torch, dev, dtype, name):
    """q, k, v, dO of SPARSE_SHAPES[name] from a seeded generator (k, v with
    the case's KV heads), and the case's block lists on the card."""
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    c = SPARSE_SHAPES[name]
    B, S, H, D = c["q"]
    g = torch.Generator(device=dev).manual_seed(S + H + D)
    q, do = (torch.randn((B, S, H, D), generator=g, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn((B, S, c["kvh"], D), generator=g, device=dev).to(dtype) for _ in range(2))
    kidx, qidx = ss._device_lists(sparse_config(name), S, H, c["causal"], dev)
    return q, k, v, do, kidx, qidx


def sparse_pairs(np, name) -> tuple:
    """(active (query, key) pairs per batch row over all heads, active blocks per
    batch row, layout density): counted from the causal-trimmed layout, the
    diagonal blocks of a causal run at blk (blk + 1) / 2 pairs each."""
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    c = SPARSE_SHAPES[name]
    _, S, H, _ = c["q"]
    cfg = sparse_config(name)
    blk = cfg.block
    layout = np.broadcast_to(cfg.make_layout(S), (H, S // blk, S // blk))
    kidx, _ = ss._active_lists(layout, c["causal"])
    blocks = int((kidx >= 0).sum())
    pairs = blocks * blk * blk
    full = H * S * S
    if c["causal"]:
        diag = H * (S // blk)  # the causal-trimmed layouts all keep their diagonal blocks
        pairs -= diag * blk * (blk - 1) // 2
        full = H * S * (S + 1) // 2
    return pairs, blocks, pairs / full


def sdpa_bool_yardstick(torch, q, k, v, mask, do, scale, iters):
    """SDPA over (B, H, S, D) with the boolean token mask, forward and backward
    (dq, dk, dv), on the cuDNN and the memory-efficient backends: the faster of
    the two that take it (forward + backward), else the math backend."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    runs, last = [], None
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        if backend == SDPBackend.MATH and runs:
            break
        try:
            with sdpa_kernel(backend):
                leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
                out = sdpa(*leaves, attn_mask=mask, scale=scale)
                fwd = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale), iters)
                bwd = time_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), max(3, iters // 2))
            runs.append(dict(backend=backend.name, fwd_ms=fwd, bwd_ms=bwd))
        except (RuntimeError, torch.cuda.OutOfMemoryError) as exc:
            last = str(exc).splitlines()[0][:200]
        out = leaves = None
        torch.cuda.empty_cache()
    if not runs:
        return dict(backend=None, error=last, fwd_ms=None, bwd_ms=None)
    best = min(runs, key=lambda r: r["fwd_ms"] + r["bwd_ms"])
    return dict(best, tried={r["backend"]: (r["fwd_ms"], r["bwd_ms"]) for r in runs})


def phase_sparse_kernels(torch, dev, dtype, name, iters):
    """sparse_fwd, sparse_bwd_dq and sparse_bwd_dkv at one SPARSE_SHAPES case
    against their plain versions, with bounds, SDPA with the boolean token
    mask as the library yardstick (bf16) and, at the dense layout, the flash
    kernels on the same inputs."""
    import numpy as np

    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    c = SPARSE_SHAPES[name]
    B, S, H, D = c["q"]
    blk, causal = sparse_config(name).block, c["causal"]
    q, k, v, do, kidx, qidx = sparse_inputs(torch, dev, dtype, name)
    k, v = ss._expand_kv(k, H // c["kvh"]), ss._expand_kv(v, H // c["kvh"])
    # the bf16 kernels' walks, as the path's: the forward's and dq's over kidx, the dk/dv's over qidx
    qplan = ss._device_query_plan(sparse_config(name), S, H, causal, dev)
    plan = ss._device_dkv_plan(sparse_config(name), S, H, causal, dev)
    scale = D**-0.5
    args = (blk, scale, causal)
    fwd_fn = lambda: ss.sparse_fwd(q, k, v, kidx, *args, plan=qplan)
    o, lse = fwd_fn()
    delta = ss.flash_delta(o, do)
    bwd = (q, k, v, do, lse, delta)
    dq_fn = lambda: ss.sparse_bwd_dq(*bwd, kidx, *args, plan=qplan)
    dkv_fn = lambda: ss.sparse_bwd_dkv(*bwd, qidx, *args, plan=plan)
    dq = dq_fn()
    dk, dv = dkv_fn()
    # each kernel launched twice more on the same inputs: bit-equal results (no atomics, fixed-order sums)
    again = fwd_fn() + (dq_fn(),) + dkv_fn()
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip((o, lse, dq, dk, dv), again)]
    repeats = {"sparse_fwd": same[0] and same[1], "sparse_bwd_dq": same[2], "sparse_bwd_dkv": same[3] and same[4]}
    del again
    o_ref, lse_ref = ss.sparse_fwd_ref(q, k, v, kidx, *args)
    dq_ref = ss.sparse_bwd_dq_ref(*bwd, kidx, *args)
    dk_ref, dv_ref = ss.sparse_bwd_dkv_ref(*bwd, qidx, *args)

    def err(a, b):
        # as phase_flash: bf16 per row with each row's scale at least the tensor's mean magnitude;
        # fp32 abs error over max(1, max |want|)
        e = errors(a, b, b.float().abs().mean().item())
        e["max_abs_err_scaled"] = e["max_abs_err"] / max(1.0, b.float().abs().max().item())
        return e

    e_fwd = err(o, o_ref)
    e_fwd["lse_max_abs_err"] = (lse - lse_ref).abs().max().item()
    e_dq = err(dq, dq_ref)
    e_dk, e_dv = err(dk, dk_ref), err(dv, dv_ref)
    e_dkv = {key: max(e_dk[key], e_dv[key]) for key in e_dk}
    del o_ref, lse_ref, dq_ref, dk_ref, dv_ref
    flash = {}
    if c["config"] == "DenseSparsityConfig":  # the same work as the flash kernels: hold the two to each other
        o_f, lse_f = fa.flash_fwd(q, k, v, None, scale, causal, 0)
        dq_f = fa.flash_bwd_dq(*bwd, None, scale, causal, 0)
        dk_f, dv_f = fa.flash_bwd_dkv(*bwd, None, scale, causal, 0)
        e = {"sparse_fwd": err(o, o_f), "sparse_bwd_dq": err(dq, dq_f)}
        e["sparse_fwd"]["lse_max_abs_err"] = (lse - lse_f).abs().max().item()
        e_k, e_v = err(dk, dk_f), err(dv, dv_f)
        e["sparse_bwd_dkv"] = {key: max(e_k[key], e_v[key]) for key in e_k}
        fargs = (None, scale, causal, 0)
        flash = {"sparse_fwd": (e["sparse_fwd"], time_ms(lambda: fa.flash_fwd(q, k, v, *fargs), iters)),
                 "sparse_bwd_dq": (e["sparse_bwd_dq"], time_ms(lambda: fa.flash_bwd_dq(*bwd, *fargs), iters)),
                 "sparse_bwd_dkv": (e["sparse_bwd_dkv"], time_ms(lambda: fa.flash_bwd_dkv(*bwd, *fargs), iters))}
        del o_f, lse_f, dq_f, dk_f, dv_f
    del o, dq, dk, dv
    torch.cuda.empty_cache()
    tol = ("max_abs_err_scaled", 1e-5) if dtype == torch.float32 else TOL[str(dtype)]
    pairs, blocks, density = sparse_pairs(np, name)
    pairs *= B
    item = q.element_size()
    nt = q.numel() * item  # one (B, S, H, D) tensor
    stats = B * H * S * 4  # lse or delta
    few = max(2, iters // 10)
    # the library yardstick: SDPA with the (H, S, S) boolean token mask of the layout, in bf16, the type of
    # the kernels line (the plain versions, which take a second a call at the largest cases, too)
    lib = dict(backend=None, fwd_ms=None, bwd_ms=None)
    if dtype == torch.bfloat16:
        mask = torch.from_numpy(np.ascontiguousarray(ss.layout_to_token_mask(
            np.broadcast_to(sparse_config(name).make_layout(S), (H, S // blk, S // blk)), blk, causal))).to(dev)
        qh, kh, vh, doh = (t.permute(0, 2, 1, 3) for t in (q, k, v, do))
        lib = sdpa_bool_yardstick(torch, qh, kh, vh, mask[None], doh, scale, iters)
        del mask, qh, kh, vh, doh
        torch.cuda.empty_cache()
    shape = f"q({B},{S},{H},{D}) kv heads {c['kvh']} block {blk} causal={causal}"
    recs = []
    for kernel, e, fn, ref, idx, walk, n_prod, nbytes in (
            ("sparse_fwd", e_fwd, fwd_fn, lambda: ss.sparse_fwd_ref(q, k, v, kidx, *args), kidx, qplan, 2,
             4 * nt + stats),
            ("sparse_bwd_dq", e_dq, dq_fn, lambda: ss.sparse_bwd_dq_ref(*bwd, kidx, *args), kidx, qplan, 3,
             5 * nt + 2 * stats),
            ("sparse_bwd_dkv", e_dkv, dkv_fn, lambda: ss.sparse_bwd_dkv_ref(*bwd, qidx, *args), qidx, plan, 4,
             6 * nt + 2 * stats)):
        nbytes += idx.numel() * 4
        flops = 2 * n_prod * D * pairs
        b_ms, b_by = bound(nbytes, flops, dtype)
        fwd = kernel == "sparse_fwd"
        plain_ms = time_ms(ref, few, warmup=1) if dtype == torch.bfloat16 else None
        rec = dict(kernel=kernel, case=name, dtype=str(dtype), shape=shape, **e, tol=tol,
                   kernel_ms=time_ms(fn, iters), plain_ms=plain_ms,
                   library_ms=lib["fwd_ms"] if fwd else lib["bwd_ms"],
                   library=f"SDPA {'forward' if fwd else 'backward (dq, dk, dv together)'}, boolean token mask, "
                           f"backend {lib['backend']}" if lib["backend"] else None, library_tried=lib.get("tried"),
                   active_pairs=pairs,
                   active_blocks=blocks * B,
                   density=density, list_width=idx.shape[2], bound_bytes=nbytes, bound_flops=flops, bound_ms=b_ms,
                   bound_by=b_by)
        # the redesigned bf16 kernels: the parent's time, two launches bit-equal, and the walk's plan
        rec.update(parent_ms=parent_time(time_ms, fn, iters), repeats_bitwise=repeats[kernel],
                   plan=dict(items=walk.n_items, split_groups=walk.n_reduce, pieces=walk.n_slots,
                             longest_walk=walk.max_entries) if dtype == torch.bfloat16 else None)
        if kernel in flash:
            fe, f_ms = flash[kernel]
            rec.update(flash_ms=f_ms, vs_flash_max_rel_err=fe["max_rel_err"],
                       vs_flash_max_abs_err_scaled=fe["max_abs_err_scaled"],
                       vs_flash_lse_max_abs_err=fe.get("lse_max_abs_err", 0.0))
        recs.append(rec)
    torch.cuda.empty_cache()
    return recs


def run_sparse_kernel_phases(torch, dev, quick: bool):
    records = []
    iters = 5 if quick else 10
    names = ["fixed_uni_gpt2_1_3b"] if quick else list(SPARSE_SHAPES)
    for dtype in (torch.bfloat16, torch.float32):
        for name in names:
            for rec in phase_sparse_kernels(torch, dev, dtype, name, iters):
                log(rec)
                what, tol = rec["tol"]
                ok = rec[what] <= tol and rec.get("lse_max_abs_err", 0.0) <= 1e-4 and rec["repeats_bitwise"]
                if "flash_ms" in rec:  # the dense layout against the flash kernels, at the same tolerance
                    flash_what = "vs_flash_max_abs_err_scaled" if what == "max_abs_err_scaled" else "vs_flash_" + what
                    ok = ok and rec[flash_what] <= tol and rec["vs_flash_lse_max_abs_err"] <= 1e-4
                if not ok:
                    raise AssertionError(f"{rec['kernel']} {rec['dtype']} {rec['case']}: {what} {rec[what]} > "
                                         f"{tol}, lse error {rec.get('lse_max_abs_err')}, not repeatable "
                                         f"or the flash kernels disagree: {rec}")
                records.append(rec)
            torch.cuda.empty_cache()
    return records


class PlainSparseKernels(PlainKernels):
    """The plain versions of the sparse kernels bound in place of their wrappers
    (without the plans, the kernels' walks, which they do not need)."""

    NAMES = ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")

    @staticmethod
    def module():
        from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

        return ss

    def __enter__(self):
        super().__enter__()
        ss = self.fa
        for n in self.NAMES:
            setattr(ss, n, lambda *args, plan=None, ref=getattr(ss, n + self.PLAIN): ref(*args))


# kernel path vs plain path, forward and backward end to end. bf16: per-row relative error with each
# row's scale at least the tensor's mean magnitude (as the evoformer path: each path's own bf16 o enters
# delta = rowsum(o * dO), so the backward passes start one bf16 rounding apart); fp32: abs error over
# max(1, max |want|), as the kernel checks.
SPARSE_PATH_TOL = {"torch.bfloat16": ("max_rel_err", 0.08), "torch.float32": ("max_abs_err_scaled", 1e-5)}


def phase_sparse(torch, dev, counters):
    """``SparseSelfAttention(cfg, causal)(q, k, v)`` forward and backward
    through autograd (gradients of q, k and v) at each SPARSE_SHAPES case in
    bf16: the counters are zeroed just before each call and read just after,
    and each of the three kernels must launch. The same call with the plain
    versions bound in place gives the output and gradients to compare with.
    ms per forward + backward and peak memory beside the plain path and SDPA
    with the token mask."""
    import numpy as np

    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    recs, total = [], {fn.__name__: 0 for fn in counters}
    dtype = torch.bfloat16
    for name, c in SPARSE_SHAPES.items():
        q, k, v, do, _, _ = sparse_inputs(torch, dev, dtype, name)
        attn = sa.SparseSelfAttention(sparse_config(name), causal=c["causal"])

        def step(q, k, v, do, fn=attn):
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = fn(*leaves)
            out.backward(do)
            return [out.detach()] + [t.grad for t in leaves]

        for fn in counters:
            fn.launches = 0
        got = step(q, k, v, do)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        finite = all(torch.isfinite(t).all().item() for t in got)
        before = sum(fn.launches for fn in counters)
        with PlainSparseKernels():
            want = step(q, k, v, do)
            torch.cuda.synchronize()
            plain_launches = sum(fn.launches for fn in counters) - before
            torch.cuda.reset_peak_memory_stats()
            step(q, k, v, do)
            plain_peak = torch.cuda.max_memory_allocated() / 2**30
            plain_ms = time_ms(lambda: step(q, k, v, do), 2, warmup=0)
        errs = {lab: evo_err(torch, a, b) for lab, a, b in zip(["out", "dq", "dk", "dv"], got, want)}
        del got, want
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step(q, k, v, do)
        peak = torch.cuda.max_memory_allocated() / 2**30
        kernel_ms = time_ms(lambda: step(q, k, v, do), 5, warmup=1)
        parent_ms = parent_time(time_ms, lambda: step(q, k, v, do), 5, warmup=1)
        # SDPA with the token mask, forward + backward through autograd, on the expanded K/V
        B, S, H, D = c["q"]
        blk = sparse_config(name).block
        mask = torch.from_numpy(np.ascontiguousarray(ss.layout_to_token_mask(
            np.broadcast_to(sparse_config(name).make_layout(S), (H, S // blk, S // blk)), blk, c["causal"]))).to(dev)
        sdpa = lambda qq, kk, vv: torch.nn.functional.scaled_dot_product_attention(
            qq.transpose(1, 2), ss._expand_kv(kk, H // c["kvh"]).transpose(1, 2),
            ss._expand_kv(vv, H // c["kvh"]).transpose(1, 2), attn_mask=mask[None]).transpose(1, 2)
        try:
            torch.cuda.reset_peak_memory_stats()
            step(q, k, v, do, sdpa)
            sdpa_peak = torch.cuda.max_memory_allocated() / 2**30
            sdpa_ms = time_ms(lambda: step(q, k, v, do, sdpa), 3, warmup=1)
        except torch.cuda.OutOfMemoryError as exc:
            sdpa_peak, sdpa_ms = None, f"out of memory: {str(exc).splitlines()[0][:120]}"
        del mask
        what, tol = SPARSE_PATH_TOL[str(dtype)]
        rec = dict(phase="sparse", case=name, dtype=str(dtype), q=tuple(q.shape), kv_heads=c["kvh"],
                   config=c["config"], block=blk, causal=c["causal"], launches=launches,
                   plain_launches=plain_launches, errors={lab: e[what] for lab, e in errs.items()},
                   max_abs_err={lab: e["max_abs_err"] for lab, e in errs.items()}, tol=(what, tol),
                   ms_per_fwd_bwd=kernel_ms, parent_ms_per_fwd_bwd=parent_ms, peak_memory_gb=peak,
                   plain_ms_per_fwd_bwd=plain_ms,
                   plain_peak_memory_gb=plain_peak, sdpa_ms_per_fwd_bwd=sdpa_ms, sdpa_peak_memory_gb=sdpa_peak,
                   sdpa_backend="default dispatch", finite=finite)
        log(rec)
        for key in total:
            total[key] += launches[key]
        if not (finite and all(e[what] <= tol for e in errs.values()) and all(n > 0 for n in launches.values())
                and plain_launches == 0):
            raise AssertionError(f"sparse {name} {dtype}: {rec}")
        recs.append(rec)
        del q, k, v, do
        torch.cuda.empty_cache()
    return dict(phase="sparse", launches=total, records=recs)


# ---------------------------------------------------------------- group-wise quantisation (the v1 engine's flat layout)
QUANT_GROUP = 64  # the v1 engine's group size (the config's default)
# odd sizes: (rows, group): a size of 3 g, a last CUDA block cut short, scalar loads (g 3), teams shorter
# than a warp (g 16) and a team that loops over its group (g 4096)
QUANT_ODD = [(3, 64), (1003, 64), (224, 3), (15, 16), (2, 4096)]


def llama_flat_leaves():
    """The 226 leaves of llama3_8b that ``quantize_model_params`` quantises
    (>= 2-D and >= 1024 elements), as (path, shape)."""
    from deepspeed_tpu_torch.models import param_shapes

    return [(path, spec[0]) for path, spec in flatten(param_shapes(model_cfg()))
            if len(spec[0]) >= 2 and math.prod(spec[0]) >= 1024]


def each(fn, calls) -> None:
    """``fn(*args)`` for each args in ``calls``, each result dropped at once (one output alive at a time)."""
    for args in calls:
        fn(*args)


def quant_bytes(n: int, rows: int, item: int) -> int:
    """Bytes of one quantise (read ``item``-byte values, write codes and scales) or dequantise (the reverse)."""
    return n * item + n + rows * 4


def codes_differ(torch, got, want) -> int:
    """Elements of two (codes, scales) pairs that differ in any bit."""
    return int((got[0] != want[0]).sum()) + int((got[1].view(torch.int32) != want[1].view(torch.int32)).sum())


def phase_quant_odd(torch, dev, cases):
    """Quantise and dequantise at odd sizes against the plain versions, bit for bit."""
    from deepspeed_tpu_torch.ops import quantization as tq

    g = torch.Generator(device=dev).manual_seed(12)
    bad = []
    for rows, group in cases:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((rows, group), generator=g, device=dev).to(dtype)
            x[0] = 0.0  # an all-zero group
            for bits in (8, 4):
                got = tq.quantize_groupwise(x, group, bits)
                want = tq.quantize_groupwise_xla(x, group, bits)
                bad += [f"quantize {rows}x{group} {dtype} int{bits}"] if codes_differ(torch, got, want) else []
                for out in (torch.bfloat16, torch.float32):
                    if not torch.equal(tq.dequantize_groupwise(*got, out_dtype=out),
                                       tq.dequantize_groupwise_xla(*got, out_dtype=out)):
                        bad.append(f"dequantize {rows}x{group} int{bits} -> {out}")
    torch.cuda.synchronize()
    log(dict(phase="quant odd sizes", cases=[f"{r}x{g}" for r, g in cases], bit_equal=not bad))
    if bad:
        raise AssertionError(f"quant kernels differ from their plain versions at odd sizes: {bad}")


def phase_quant_kernels(torch, dev, quick: bool):
    """``quantize_groupwise`` and ``dequantize_groupwise`` over llama3_8b's 226
    flat-quantised leaves (random bf16 weights, group 64) at int8 and int4:
    codes, scales and the dequantised bf16 and fp32 weights bit-equal to the
    plain versions, leaf by leaf; then times at ``wte`` and over all leaves."""
    from deepspeed_tpu_torch.ops import quantization as tq

    phase_quant_odd(torch, dev, QUANT_ODD[1:2] if quick else QUANT_ODD)
    leaves = llama_flat_leaves()
    if not quick and (len(leaves) != 226 or sum(math.prod(s) for _, s in leaves) != 8_029_995_008):
        raise AssertionError(f"llama3_8b has {len(leaves)} flat-quantised leaves, not 226")
    if quick:
        leaves = [(p, s) for p, s in leaves if p == "wte"]
    gen = torch.Generator(device=dev).manual_seed(11)
    weights = [(torch.randn(shape, generator=gen, device=dev) * 0.02).to(torch.bfloat16) for _, shape in leaves]
    wte = weights[[p for p, _ in leaves].index("wte")]
    iters = 3 if quick else 5
    records = []
    for bits in (8,) if quick else (8, 4):
        codes, bad = [], 0
        for w in weights:  # leaf by leaf: the plain versions' fp32 temporaries stay small
            got = tq.quantize_groupwise(w, QUANT_GROUP, bits)
            bad += codes_differ(torch, got, tq.quantize_groupwise_xla(w, QUANT_GROUP, bits))
            for out in (torch.bfloat16, torch.float32):
                bad += int((tq.dequantize_groupwise(*got, w.shape, out) !=
                            tq.dequantize_groupwise_xla(*got, w.shape, out)).sum())
            codes.append(got)
        torch.cuda.synchronize()
        if bad:
            raise AssertionError(f"quant kernels int{bits}: {bad} codes, scales or dequantised values differ")
        wte_codes = codes[[p for p, _ in leaves].index("wte")]
        for case, ws, cs in (("wte", [wte], [wte_codes]), ("all", weights, codes)):
            n = sum(w.numel() for w in ws)
            rows = n // QUANT_GROUP
            shape = f"{len(ws)} leaves, {n} elements, g {QUANT_GROUP}"
            quant = lambda: each(tq.quantize_groupwise, [(w, QUANT_GROUP, bits) for w in ws])
            quant_plain = lambda: each(tq.quantize_groupwise_xla, [(w, QUANT_GROUP, bits) for w in ws])
            b_ms, b_by = bound(quant_bytes(n, rows, 2), 4 * n, torch.float32)  # |x|, max, divide, round
            records.append(dict(kernel="quantize_groupwise", case=f"{case}-int{bits}", dtype="torch.bfloat16",
                                shape=shape, bit_equal=True, max_abs_err=0.0, max_rel_err=0.0,
                                kernel_ms=time_ms(quant, iters, 1), plain_ms=time_ms(quant_plain, 1, 1),
                                library_ms=None, library="none: no single PyTorch call quantises group-wise",
                                bound_bytes=quant_bytes(n, rows, 2), bound_ms=b_ms, bound_by=b_by))
            for out in (torch.bfloat16, torch.float32) if case == "wte" else (torch.bfloat16,):
                item = 2 if out == torch.bfloat16 else 4
                deq = lambda: each(tq.dequantize_groupwise, [(q, s, None, out) for q, s in cs])
                deq_plain = lambda: each(tq.dequantize_groupwise_xla, [(q, s, None, out) for q, s in cs])
                # one PyTorch call of the same function: the fp32 product (and its bf16 cast)
                lib = lambda: each(lambda q, s: torch.mul(q, s[:, None]).to(out), cs)
                b_ms, b_by = bound(quant_bytes(n, rows, item), n, torch.float32)
                records.append(dict(kernel="dequantize_groupwise", case=f"{case}-int{bits}", dtype=str(out),
                                    shape=shape, bit_equal=True, max_abs_err=0.0, max_rel_err=0.0,
                                    kernel_ms=time_ms(deq, iters, 1), plain_ms=time_ms(deq_plain, 1, 1),
                                    library_ms=time_ms(lib, iters, 1),
                                    library="torch.mul(q, scales[:, None])" + (".to(bf16)" if item == 2 else ""),
                                    bound_bytes=quant_bytes(n, rows, item), bound_ms=b_ms, bound_by=b_by))
        del codes, wte_codes
        torch.cuda.empty_cache()
    for rec in records:
        log(rec)
    del weights, wte
    torch.cuda.empty_cache()
    return records


def phase_lamb(torch, dev, which, iters):
    """The LAMB direction over the wte leaf or over every gpt2_1_3b leaf (one
    launch per leaf) against its plain version. No PyTorch call computes the
    direction; ``torch.optim.AdamW(fused=True)`` over the same leaves moves the
    same bytes and is printed beside it, not as a library time."""
    from deepspeed_tpu_torch.ops import fused_adam as fad, fused_lamb as tfl

    shapes = gpt2_leaf_shapes()
    if which == "wte":
        shapes = [(p, s) for p, s in shapes if p == "wte"]
    g = torch.Generator(device=dev).manual_seed(8)
    leaves = []
    for _, shape in shapes:
        p = torch.randn(shape, generator=g, device=dev)
        grad = torch.randn(shape, generator=g, device=dev)
        m = torch.randn(shape, generator=g, device=dev) * 1e-3
        v = torch.rand(shape, generator=g, device=dev) * 1e-6
        leaves.append((p, grad, m, v))
    n = sum(p.numel() for p, _, _, _ in leaves)
    u = torch.empty(max(p.numel() for p, _, _, _ in leaves), device=dev)
    scal = fad.adam_scalars(1e-3, 10, 0.9, 0.999, grad_mult=0.7, device=dev)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    rel = abs_err = 0.0
    for p, grad, m, v in leaves:  # leaf by leaf: kernel and plain version from the same m and v
        rm, rv = m.clone(), v.clone()
        got = tfl.lamb_direction(p, grad, m, v, scal, u_out=u[:p.numel()].view_as(p), **hyper)
        want = tfl.lamb_direction_ref(p, grad, rm, rv, scal, **hyper)
        for a, b in ((got, want), (m, rm), (v, rv)):
            diff = (a - b).abs().max()
            rel, abs_err = max(rel, (diff / b.abs().max()).item()), max(abs_err, diff.item())
    del rm, rv, got, want
    step = lambda: each(lambda p, grad, m, v: tfl.lamb_direction(p, grad, m, v, scal, u_out=u[:p.numel()].view_as(p),
                                                                 **hyper), leaves)
    plain = lambda: each(lambda p, grad, m, v: tfl.lamb_direction_ref(p, grad, m, v, scal, **hyper), leaves)
    k_ms = time_ms(step, iters)
    p_ms = time_ms(plain, max(2, iters // 5))
    params = [p for p, _, _, _ in leaves]
    for p, grad, _, _ in leaves:
        p.grad = grad
    opt = torch.optim.AdamW(params, lr=1e-4, weight_decay=0.01, fused=True)
    adamw_ms = time_ms(opt.step, iters)
    del opt
    nbytes = 28 * n  # read p, g, m, v; write u, m, v
    b_ms, b_by = bound(nbytes, 15 * n, torch.float32)
    return dict(kernel="lamb_direction", case=which, dtype="torch.float32", shape=f"{len(leaves)} leaves, {n} elements",
                max_rel_err=rel, max_abs_err=abs_err, tol=("max_rel_err", 1e-5), launches_per_step=len(leaves),
                kernel_ms=k_ms, plain_ms=p_ms, library_ms=None, library="none: no PyTorch call computes it",
                adamw_fused_ms_same_bytes_not_same_function=adamw_ms, bound_bytes=nbytes, bound_ms=b_ms,
                bound_by=b_by)


def run_lamb_kernel_phases(torch, dev, quick: bool):
    records = []
    for which in (["wte"] if quick else ["wte", "all"]):
        rec = phase_lamb(torch, dev, which, 5 if quick else 20)
        log(rec)
        # nvcc contracts the moment updates to FMAs: fp32 within 1e-5 of each tensor's largest value
        if not rec["max_rel_err"] <= 1e-5:
            raise AssertionError(f"lamb_direction {which}: max_rel_err {rec['max_rel_err']} > 1e-5")
        records.append(rec)
        torch.cuda.empty_cache()
    return records


class PlainQuantKernels(PlainKernels):
    """The plain versions of the group-wise quantisation kernels bound in place of their wrappers."""

    NAMES = ("quantize_groupwise", "dequantize_groupwise")
    PLAIN = "_xla"

    @staticmethod
    def module():
        from deepspeed_tpu_torch.ops import quantization as tq

        return tq


# v1 serving: a batch of 4 seeded prompts at each length, greedy, V1_NEW new tokens (8: the whole script's time
# limit; 16 until the Hugging Face phases came, 32 before that)
V1_PROMPT_LENS, V1_BATCH, V1_NEW, V1_MAX_OUT = (16, 512), 4, 8, 1024
V1_RUNS = {"v1": 0, "v1_w8": 8, "v1_w4": 4}  # run -> quant bits (0: off)


def profile_v1(torch, engine, prompts, run) -> None:
    """Device-time breakdown of one pass of the v1 generate calls under
    torch.profiler (after the timed pass; only the shares are meant to be
    read, since profiling slows the host)."""

    def gen():
        for p in prompts:
            engine.generate(p, max_new_tokens=V1_NEW)

    cats = {"dequantize_groupwise": ("dequant_kernel",), "matmul": MATMUL, "softmax": ("softmax",),
            "copy": ("Memcpy", "Memset", "copy_", "Copy")}
    log(dict(phase="profile_v1", run=run, **profiled(torch, gen, cats)))


def phase_v1(torch, dev, counters, profile=False):
    """``init_inference`` + ``generate`` on llama3_8b at full width and depth
    (random bf16 weights from seed 0), quantisation off and on (flat int8
    and int4, group 64). For each quantised run the counters are zeroed just
    before ``init_inference`` (which quantises: one ``quantize_groupwise`` per
    leaf) and read after the generate calls (one ``dequantize_groupwise`` per
    leaf per forward); the same run with the plain versions must give the
    same tokens."""
    import contextlib

    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM, init_params

    cfg = model_cfg(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_leaves = len(llama_flat_leaves())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (V1_BATCH, S)) for S in V1_PROMPT_LENS]
    model = CausalLM(cfg)
    forwards = V1_NEW * len(prompts)  # a prefill and V1_NEW - 1 decode steps per generate
    base = {"dtype": "bfloat16", "max_out_tokens": V1_MAX_OUT, "device": str(dev)}
    warm = dst.init_inference(model, base, params=params)
    warm.generate(prompts[0][:, :8], max_new_tokens=2)  # warm-up: cuBLAS handles, allocator (not counted)
    del warm
    runs, tokens = {}, {}
    for run, bits in V1_RUNS.items():
        for variant in ("kernel", "plain") if bits else ("kernel",):
            config = dict(base)
            if bits:
                config["quant"] = {"enabled": True, "bits": bits, "group_size": QUANT_GROUP}
            with PlainQuantKernels() if variant == "plain" else contextlib.nullcontext():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for fn in counters:
                    fn.launches = 0
                t0 = time.perf_counter()
                engine = dst.init_inference(model, config, params=params)
                torch.cuda.synchronize()
                setup_s = time.perf_counter() - t0
                setup_launches = {fn.__name__: fn.launches for fn in counters}
                t0 = time.perf_counter()
                outs = [engine.generate(p, max_new_tokens=V1_NEW) for p in prompts]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {fn.__name__: fn.launches for fn in counters}
                weight_bytes = tree_bytes(engine.params)
                if profile and variant == "kernel" and bits in (0, 8):
                    profile_v1(torch, engine, prompts, run)
                del engine
                gc.collect()
            new = [o[:, -V1_NEW:].cpu() for o in outs]
            tokens[(run, variant)] = new
            rec = dict(phase="v1", run=run, variant=variant, model="llama3_8b", layers=cfg.n_layers,
                       d_model=cfg.d_model, dtype="bfloat16", quant_bits=bits, group_size=QUANT_GROUP if bits else 0,
                       prompts=[list(p.shape) for p in prompts], new_tokens=V1_BATCH * V1_NEW * len(prompts),
                       wall_s=wall, tokens_per_s=V1_BATCH * V1_NEW * len(prompts) / wall, setup_s=setup_s,
                       weights_init_s=init_s, weight_bytes=weight_bytes, weight_bytes_bf16=tree_bytes(params),
                       max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2**30,
                       setup_launches=setup_launches, launches=launches, forwards=forwards)
            if bits and variant == "kernel":
                rec["agree_with_unquantised"] = float(np.mean([(a == b).float().mean().item() for a, b in zip(
                    new, tokens[("v1", "kernel")])]))
                runs[run] = rec
            if run == "v1":
                runs[run] = rec
            if bits and variant == "plain":
                rec["tokens_equal_kernel_run"] = all(torch.equal(a, b) for a, b in zip(new, tokens[(run, "kernel")]))
            log(rec)
            torch.cuda.empty_cache()
            if not all(o.shape == (V1_BATCH, p.shape[1] + V1_NEW) and 0 <= int(o.min()) and int(o.max()) < cfg.vocab_size
                       for o, p in zip(outs, prompts)):
                raise AssertionError(f"v1 {run} {variant}: a prompt did not get {V1_NEW} in-vocab tokens")
            if variant == "plain" and not (rec["tokens_equal_kernel_run"] and not any(launches.values())):
                raise AssertionError(f"v1 {run}: the plain versions' tokens differ from the kernels' (or a kernel "
                                     f"launched): {rec}")
            want = {"quantize_groupwise": n_leaves, "dequantize_groupwise": n_leaves * forwards} if bits else {}
            if variant == "kernel" and (setup_launches.get("quantize_groupwise", 0) != want.get("quantize_groupwise", 0)
                                        or any(launches[k] != v for k, v in want.items())):
                raise AssertionError(f"v1 {run}: launches {launches} (set-up {setup_launches}), expected {want}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


# ---------------------------------------------------------------- Hugging Face checkpoints (serve_hf)
# The published config.json values of each run's source (the checkpoints' own fields; the weights are random
# from a seed). falcon_7b_4l cuts tiiuae/falcon-7b's 32 layers to 4: its widths (71 query heads on one KV
# head of 64) are what it tests.
HF_CONFIGS = {
    "phi_2": ("microsoft/phi-2", {
        "architectures": ["PhiForCausalLM"], "model_type": "phi", "vocab_size": 51200, "hidden_size": 2560,
        "intermediate_size": 10240, "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 32,
        "partial_rotary_factor": 0.4, "hidden_act": "gelu_new", "layer_norm_eps": 1e-05,
        "max_position_embeddings": 2048, "rope_theta": 10000.0, "rope_scaling": None, "qk_layernorm": False,
        "tie_word_embeddings": False, "bos_token_id": 50256, "eos_token_id": 50256, "torch_dtype": "float16"}),
    "gemma_2b": ("google/gemma-2b", {
        "architectures": ["GemmaForCausalLM"], "model_type": "gemma", "vocab_size": 256000, "hidden_size": 2048,
        "intermediate_size": 16384, "num_hidden_layers": 18, "num_attention_heads": 8, "num_key_value_heads": 1,
        "head_dim": 256, "hidden_act": "gelu", "rms_norm_eps": 1e-06, "max_position_embeddings": 8192,
        "rope_theta": 10000.0, "rope_scaling": None, "attention_bias": False, "pad_token_id": 0,
        "bos_token_id": 2, "eos_token_id": 1, "torch_dtype": "bfloat16"}),
    "falcon_7b_4l": ("tiiuae/falcon-7b, num_hidden_layers 32 -> 4", {
        "architectures": ["FalconForCausalLM"], "model_type": "falcon", "vocab_size": 65024, "hidden_size": 4544,
        "num_hidden_layers": 4, "num_attention_heads": 71, "multi_query": True, "parallel_attn": True,
        "new_decoder_architecture": False, "alibi": False, "bias": False, "layer_norm_epsilon": 1e-05,
        "apply_residual_connection_post_layernorm": False, "bos_token_id": 11, "eos_token_id": 11,
        "torch_dtype": "bfloat16"}),
    "bert_base": ("bert-base-uncased", {
        "architectures": ["BertForMaskedLM"], "model_type": "bert", "vocab_size": 30522, "hidden_size": 768,
        "intermediate_size": 3072, "num_hidden_layers": 12, "num_attention_heads": 12, "hidden_act": "gelu",
        "layer_norm_eps": 1e-12, "max_position_embeddings": 512, "type_vocab_size": 2, "pad_token_id": 0,
        "position_embedding_type": "absolute"}),
}
HF_DIR = os.path.join(HERE, "build", "hf_checkpoints")
HF_PARITY_LAYERS = 2
HF_PARITY_TOL = 1e-4  # fp32 logits of the card's kernels against the port's CPU route, relative to max |logit|
HF_BERT_BATCH = (8, 128)  # the encoder forward's rows and tokens


def hf_tensor_specs(hf: dict) -> list:
    """(name, shape, kind) of every tensor a Hugging Face checkpoint of ``hf`` holds, in the family's own names
    and torch layouts (Linear (out, in)); kind "w" a weight, "b" a bias, "ln" a LayerNorm scale, "rms0" a
    zero-centred RMSNorm scale (gemma)."""
    t, V, d, L = hf["model_type"], hf["vocab_size"], hf["hidden_size"], hf["num_hidden_layers"]
    H = hf["num_attention_heads"]
    out = []
    if t == "phi":
        f, D = hf["intermediate_size"], d // H
        out.append(("model.embed_tokens.weight", (V, d), "w"))
        for i in range(L):
            p = f"model.layers.{i}."
            for proj in ("q_proj", "k_proj", "v_proj"):
                out += [(p + f"self_attn.{proj}.weight", (H * D, d), "w"),
                        (p + f"self_attn.{proj}.bias", (H * D,), "b")]
            out += [(p + "self_attn.dense.weight", (d, H * D), "w"), (p + "self_attn.dense.bias", (d,), "b"),
                    (p + "mlp.fc1.weight", (f, d), "w"), (p + "mlp.fc1.bias", (f,), "b"),
                    (p + "mlp.fc2.weight", (d, f), "w"), (p + "mlp.fc2.bias", (d,), "b"),
                    (p + "input_layernorm.weight", (d,), "ln"), (p + "input_layernorm.bias", (d,), "b")]
        out += [("model.final_layernorm.weight", (d,), "ln"), ("model.final_layernorm.bias", (d,), "b"),
                ("lm_head.weight", (V, d), "w"), ("lm_head.bias", (V,), "b")]
    elif t == "gemma":
        f, D, KVH = hf["intermediate_size"], hf["head_dim"], hf["num_key_value_heads"]
        out.append(("model.embed_tokens.weight", (V, d), "w"))
        for i in range(L):
            p = f"model.layers.{i}."
            out += [(p + "self_attn.q_proj.weight", (H * D, d), "w"),
                    (p + "self_attn.k_proj.weight", (KVH * D, d), "w"),
                    (p + "self_attn.v_proj.weight", (KVH * D, d), "w"),
                    (p + "self_attn.o_proj.weight", (d, H * D), "w"),
                    (p + "mlp.gate_proj.weight", (f, d), "w"), (p + "mlp.up_proj.weight", (f, d), "w"),
                    (p + "mlp.down_proj.weight", (d, f), "w"), (p + "input_layernorm.weight", (d,), "rms0"),
                    (p + "post_attention_layernorm.weight", (d,), "rms0")]
        out.append(("model.norm.weight", (d,), "rms0"))
    elif t == "falcon":  # the 7b layout: fused rows [q (H D), k (D), v (D)], one input layernorm, tied head
        D = d // H
        out.append(("transformer.word_embeddings.weight", (V, d), "w"))
        for i in range(L):
            p = f"transformer.h.{i}."
            out += [(p + "input_layernorm.weight", (d,), "ln"), (p + "input_layernorm.bias", (d,), "b"),
                    (p + "self_attention.query_key_value.weight", ((H + 2) * D, d), "w"),
                    (p + "self_attention.dense.weight", (d, d), "w"),
                    (p + "mlp.dense_h_to_4h.weight", (4 * d, d), "w"),
                    (p + "mlp.dense_4h_to_h.weight", (d, 4 * d), "w")]
        out += [("transformer.ln_f.weight", (d,), "ln"), ("transformer.ln_f.bias", (d,), "b")]
    elif t == "bert":
        f, P, T = hf["intermediate_size"], hf["max_position_embeddings"], hf["type_vocab_size"]
        e = "bert.embeddings."
        out += [(e + "word_embeddings.weight", (V, d), "w"), (e + "position_embeddings.weight", (P, d), "w"),
                (e + "token_type_embeddings.weight", (T, d), "w"), (e + "LayerNorm.weight", (d,), "ln"),
                (e + "LayerNorm.bias", (d,), "b")]
        for i in range(L):
            p = f"bert.encoder.layer.{i}."
            for n in ("attention.self.query", "attention.self.key", "attention.self.value", "attention.output.dense"):
                out += [(p + n + ".weight", (d, d), "w"), (p + n + ".bias", (d,), "b")]
            out += [(p + "attention.output.LayerNorm.weight", (d,), "ln"),
                    (p + "attention.output.LayerNorm.bias", (d,), "b"),
                    (p + "intermediate.dense.weight", (f, d), "w"), (p + "intermediate.dense.bias", (f,), "b"),
                    (p + "output.dense.weight", (d, f), "w"), (p + "output.dense.bias", (d,), "b"),
                    (p + "output.LayerNorm.weight", (d,), "ln"), (p + "output.LayerNorm.bias", (d,), "b")]
        c = "cls.predictions."
        out += [(c + "transform.dense.weight", (d, d), "w"), (c + "transform.dense.bias", (d,), "b"),
                (c + "transform.LayerNorm.weight", (d,), "ln"), (c + "transform.LayerNorm.bias", (d,), "b"),
                (c + "bias", (V,), "b")]
    else:
        raise ValueError(f"no tensor list for model_type {t!r}")
    return out


def write_safetensors(torch, path: str, specs: list, make) -> int:
    """A ``.safetensors`` file of ``specs`` (name, shape, kind) in bf16: the 8-byte little-endian header length,
    the JSON header (padded with spaces to 8 bytes), then each tensor's bytes in order, ``make(shape, kind)``
    drawing each on the device; returns the bytes written."""
    import struct

    header, offset = {}, 0
    for name, shape, _ in specs:
        n = 2 * int(math.prod(shape))
        header[name] = {"dtype": "BF16", "shape": list(shape), "data_offsets": [offset, offset + n]}
        offset += n
    header["__metadata__"] = {"format": "pt"}
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, shape, kind in specs:
            f.write(make(shape, kind).to(torch.bfloat16).cpu().contiguous().view(torch.uint8).numpy())
    return 8 + len(raw) + offset


def write_hf_checkpoint(torch, dev, run: str, seed: int = 0) -> dict:
    """``build/hf_checkpoints/<run>/``: the published ``config.json`` and a ``model.safetensors`` of random bf16
    weights from ``seed`` (weights and biases N(0, 0.02), LayerNorm scales 1 + N(0, 0.02), gemma's zero-centred
    RMSNorm scales N(0, 0.02))."""
    source, hf = HF_CONFIGS[run]
    d = os.path.join(HF_DIR, run)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf, f, indent=2)
    g = torch.Generator(device=dev).manual_seed(seed)

    def make(shape, kind):
        x = torch.randn(shape, generator=g, device=dev) * 0.02
        return x + 1.0 if kind == "ln" else x

    t0 = time.perf_counter()
    nbytes = write_safetensors(torch, os.path.join(d, "model.safetensors"), hf_tensor_specs(hf), make)
    return dict(dir=d, source=source, bytes=nbytes, write_s=time.perf_counter() - t0)


def hf_load(torch, d: str, dtype, device, **overrides) -> tuple:
    """``load_hf_checkpoint`` of ``d``, with its seconds (read, to the device, convert) and the weight bytes."""
    from deepspeed_tpu_torch.module_inject import load_checkpoint as lc

    t0 = time.perf_counter()
    model, params = lc.load_hf_checkpoint(d, dtype=dtype, device=device, **overrides)
    wall = time.perf_counter() - t0
    return model, params, dict(load_s=wall, **lc.last_load, weight_bytes=tree_bytes(params))


def hf_engine(torch, model, params, device: str, dtype: str, max_context: int):
    """The parity runs' v2 engine: KV blocks of 128 in a 2 GB pool."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig

    return InferenceEngineV2(model, params, RaggedInferenceEngineConfig(
        state_manager=RaggedBatchConfig(max_context=max_context, kv_block_size=128, memory_gb=2.0),
        dtype=dtype, device=device))


def rel_err(torch, got, want) -> float:
    got, want = torch.as_tensor(got).float().cpu(), torch.as_tensor(want).float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def hf_parity(torch, dev, run: str, d: str) -> dict:
    """The run at ``HF_PARITY_LAYERS`` layers in fp32 (``num_hidden_layers`` overridden at load): a prefill of
    two prompts and a decode step through the v2 engine with the card's kernels against the port's CPU route
    (the plain versions) on the same directory, within ``HF_PARITY_TOL`` relative; then greedy tokens of four
    prompts, 16 new each, in bf16 on the card beside fp32 on the CPU (how many agree)."""
    import numpy as np

    model, params, _ = hf_load(torch, d, torch.float32, "cpu", n_layers=HF_PARITY_LAYERS)
    cfg = model.cfg
    wave1, _ = serving_prompts(np, cfg.vocab_size, 1500)
    prompts = [wave1[0][:16], wave1[2][:300], wave1[3][:64], wave1[4][:40]]
    engines = {"cpu": hf_engine(torch, model, params, "cpu", "float32", 1024),
               "card": hf_engine(torch, model, params, str(dev), "float32", 1024)}
    got = {}
    for name, eng in engines.items():
        pre = np.asarray(eng.put([0, 1], prompts[:2]))
        nxt = [[int(t)] for t in pre.argmax(-1)]
        got[name] = (pre, np.asarray(eng.put([0, 1], nxt)))
        eng.flush([0, 1])
    errs = dict(prefill=rel_err(torch, got["card"][0], got["cpu"][0]),
                decode=rel_err(torch, got["card"][1], got["cpu"][1]))
    fp32_cpu = engines["cpu"].generate(prompts, max_new_tokens=16)
    fp32_card = engines["card"].generate(prompts, max_new_tokens=16)
    del engines
    gc.collect()
    bf16 = hf_engine(torch, model, params, str(dev), "bfloat16", 1024).generate(prompts, max_new_tokens=16)
    rec = dict(phase="serve_hf parity", run=run, layers=HF_PARITY_LAYERS, dtype="float32", tol=HF_PARITY_TOL,
               max_rel_err=errs, fp32_card_tokens_agree=agreement(fp32_card, fp32_cpu),
               bf16_card_tokens_agree=agreement(bf16, fp32_cpu))
    log(rec)
    if not max(errs.values()) <= HF_PARITY_TOL:
        raise AssertionError(f"serve_hf {run}: fp32 logits on the card differ from the CPU route: {errs}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def hf_bert(torch, dev, counters, d: str) -> dict:
    """bert_base through ``init_inference(<directory>)`` (the v1 engine; the encoder forward, the flash
    forward non-causal at D 64): a bf16 forward of ``HF_BERT_BATCH`` tokens with the counters zeroed just before
    and read after (12 layers: 12 flash launches), logits finite and of (B, S, vocab); then the 2-layer fp32
    forward on the card against the CPU route on the same directory, and token types that change the output."""
    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.module_inject import load_checkpoint as lc

    B, S = HF_BERT_BATCH
    V = HF_CONFIGS["bert_base"][1]["vocab_size"]
    ids = np.random.default_rng(1).integers(0, V, (B, S))
    t0 = time.perf_counter()
    engine = dst.init_inference(d, {"dtype": "bf16", "device": str(dev)})
    load_s = time.perf_counter() - t0
    engine.forward(ids[:, :16])  # warm-up
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    logits = engine.forward(ids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    rec = dict(phase="serve_hf", run="bert_base", source=HF_CONFIGS["bert_base"][0], layers=12,
               tokens=B * S, forward_s=wall, tokens_per_s=B * S / wall, load_s=load_s, **lc.last_load,
               weight_bytes=tree_bytes(engine.params), launches=launches, shape=list(logits.shape),
               finite=bool(torch.isfinite(logits).all()))
    del engine, logits
    gc.collect()
    model, params = lc.load_hf_checkpoint(d, device="cpu", n_layers=HF_PARITY_LAYERS)
    cpu = dst.init_inference(model, {"dtype": "fp32", "device": "cpu"}, params=params)
    model, params = lc.load_hf_checkpoint(d, device=str(dev), n_layers=HF_PARITY_LAYERS)
    card = dst.init_inference(model, {"dtype": "fp32", "device": str(dev)}, params=params)
    tti = np.zeros_like(ids[:2, :64])
    tti[:, 32:] = 1
    want = cpu.forward(ids[:2, :64], token_type_ids=tti)
    got = card.forward(ids[:2, :64], token_type_ids=tti)
    rec["parity"] = dict(layers=HF_PARITY_LAYERS, dtype="float32", tol=HF_PARITY_TOL,
                         max_rel_err=rel_err(torch, got, want),
                         token_types_change_output=rel_err(torch, card.forward(ids[:2, :64]), got) > 1e-3)
    log(rec)
    if not (rec["finite"] and rec["shape"] == [B, S, V] and launches.get("flash_fwd") == 12
            and rec["parity"]["max_rel_err"] <= HF_PARITY_TOL and rec["parity"]["token_types_change_output"]):
        raise AssertionError(f"serve_hf bert_base: {rec}")
    del cpu, card, model, params
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def hf_v1(torch, dev, d: str, prompt: list) -> dict:
    """``init_inference(<directory>)`` (the v1 engine, bf16) and a greedy ``generate`` of ``prompt``, 8 new
    tokens, which must be in the vocabulary."""
    import numpy as np

    import deepspeed_tpu_torch as dst

    t0 = time.perf_counter()
    engine = dst.init_inference(d, {"dtype": "bf16", "device": str(dev), "max_out_tokens": 128})
    load_s = time.perf_counter() - t0
    ids = np.asarray([prompt])
    t0 = time.perf_counter()
    out = engine.generate(ids, max_new_tokens=8)[0, ids.shape[1]:].tolist()
    torch.cuda.synchronize()
    rec = dict(load_s=load_s, generate_s=time.perf_counter() - t0, tokens=out)
    vocab = engine.module.cfg.vocab_size
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    if len(out) != 8 or not all(0 <= t < vocab for t in out):
        raise AssertionError(f"serve_hf v1: {out} are not 8 in-vocab tokens")
    return rec


def hf_counters(pa, norms) -> dict:
    """The kernels each decoder run of serve_hf must launch: the paged pair and its norm."""
    paged = [pa.paged_attention_decode, pa.paged_attention_prefill]
    return {"phi_2": paged + [norms.layer_norm], "gemma_2b": paged + [norms.rms_norm],
            "falcon_7b_4l": paged + [norms.layer_norm]}


def phase_serve_hf(torch, dev, counters: dict, flash_fwd, keep=()) -> dict:
    """serve_hf: Hugging Face directories written here (the published config.json, random bf16 weights from a
    seed), loaded through ``load_hf_checkpoint`` + ``InferenceEngineV2`` and served as the serve phase serves
    llama3_8b (phi_2 and gemma_2b at full width and depth, falcon_7b_4l at 4 of 32 layers; their runs in
    ``SERVE_RUNS``: the launch counts, graphs against eager steps); phi_2 also through ``init_inference(<path>)``;
    each decoder at 2 layers in fp32 against the CPU route (``hf_parity``); bert_base through the v1 engine
    (``hf_bert``). Each directory is deleted after its run, but those of the runs in ``keep``: their records hold
    ``dir``, for train_hf to fine-tune (the caller deletes them)."""
    import shutil

    import numpy as np

    out = {}
    for run in ("phi_2", "gemma_2b", "falcon_7b_4l"):
        t0 = time.perf_counter()
        ck = write_hf_checkpoint(torch, dev, run)
        log(dict(phase="serve_hf write", run=run, **ck))
        rec = phase_serve(torch, dev, counters[run], run, hf_dir=ck["dir"])
        if run == "phi_2":
            wave1, _ = serving_prompts(np, HF_CONFIGS[run][1]["vocab_size"], 1500)
            v1 = hf_v1(torch, dev, ck["dir"], wave1[1][:64])
            log(dict(phase="serve_hf v1", run=run, **v1))
        rec["parity"] = hf_parity(torch, dev, run, ck["dir"])
        if run in keep:
            rec["dir"] = ck["dir"]
        else:
            shutil.rmtree(ck["dir"], ignore_errors=True)
        rec["seconds"] = time.perf_counter() - t0
        log(dict(phase="serve_hf run", run=run, seconds=rec["seconds"]))
        out[run] = rec
    t0 = time.perf_counter()
    ck = write_hf_checkpoint(torch, dev, "bert_base")
    out["bert_base"] = hf_bert(torch, dev, [flash_fwd], ck["dir"])
    shutil.rmtree(ck["dir"], ignore_errors=True)
    log(dict(phase="serve_hf run", run="bert_base", seconds=time.perf_counter() - t0))
    return out


# ---------------------------------------------------------------- fine-tuning the Hugging Face checkpoints (train_hf)
HF_TRAIN_RUNS = ("phi_2", "gemma_2b")
# bf16 with fp32 masters, FusedAdam at a constant lr, 2 x 2,048 tokens a micro-batch, one seeded batch repeated;
# steps TIMED_FROM+1.. timed. remat: without it the activations of phi-2's 32 layers (about 0.7 GB a layer) on top
# of its 44.5 GB of masters, gradients and moments come near the card's 80 GB
HF_TRAIN = dict(micro=2, seq=2048, steps=6, timed_from=2, lr=1e-4, remat=True)
# the fp32 step on the card against the CPU route: 2 layers at full width, one row of 128 tokens (the CPU's
# seconds: 12 s and 23 s at 256); the loss and the global gradient norm within 1e-4 relative (fp32 in another summation order), the
# masters after the step as the tensor-parallel phases hold them (PAR_TOL)
HF_TRAIN_PARITY = dict(layers=2, rows=1, seq=128, tol=1e-4)


def hf_train_config(torch, dtype, micro: int) -> dict:
    return {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": 1, "steps_per_print": 1000,
            "optimizer": {"type": "FusedAdam", "params": {"lr": HF_TRAIN["lr"], "weight_decay": 0.0}},
            "gradient_clipping": 1.0, "bf16": {"enabled": dtype == torch.bfloat16}}


def hf_matmul_params(cfg, n_params: int) -> int:
    """The parameters that multiply: all but an untied input embedding (a lookup); a tied one is the head."""
    return n_params - (0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model)


def hf_train_run(torch, dev, run: str, d: str, counters, profile=False) -> dict:
    """Fine-tune ``d`` at full width and depth: ``load_hf_checkpoint`` (fp32 masters on the card) into
    ``CausalLM(config with dtype bf16)`` through ``deepspeed_tpu_torch.initialize``, ``HF_TRAIN``'s steps on one
    seeded batch; step ms, tokens/s, MFU, peak memory, the kernels' launches over the timed steps; with
    ``profile`` one more step under torch.profiler (``profile_train``)."""
    import dataclasses
    import itertools

    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM

    torch.cuda.reset_peak_memory_stats()
    model, params, load = hf_load(torch, d, torch.float32, str(dev))
    cfg = dataclasses.replace(model.cfg, dtype=torch.bfloat16, remat=HF_TRAIN["remat"])
    micro, seq, steps, timed_from = (HF_TRAIN[k] for k in ("micro", "seq", "steps", "timed_from"))
    t0 = time.perf_counter()
    engine, _, _, _ = dst.initialize(model=CausalLM(cfg), model_parameters=params,
                                     config=hf_train_config(torch, torch.bfloat16, micro), device=dev)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in engine.parameters())
    data = itertools.repeat({"input_ids": np.random.default_rng(HF_TRAIN_RUNS.index(run)).integers(
        0, cfg.vocab_size, (micro, seq)).astype(np.int32)})
    losses = [engine.train_batch(data) for _ in range(timed_from)]
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(steps - timed_from):
        losses.append(engine.train_batch(data))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    losses = [float(x) for x in losses]
    timed = steps - timed_from
    tokens = micro * seq
    # model FLOPs a step: 6 N T over the parameters that multiply, plus attention's two products, forward and
    # backward (3x), over the causal pairs of the query heads; remat's recompute is not counted
    flops = 6 * hf_matmul_params(cfg, n_params) * tokens + \
        12 * cfg.n_layers * micro * cfg.n_heads * cfg.head_dim * visible_pairs(seq, seq, True, 0)
    step_s = wall / timed
    rec = dict(phase="train_hf", run=run, source=HF_CONFIGS[run][0], layers=cfg.n_layers, d_model=cfg.d_model,
               heads=f"{cfg.n_heads}/{cfg.kv_heads} x {cfg.head_dim}", params=n_params, dtype="bfloat16",
               masters="float32", remat=cfg.remat, micro_batch=micro, seq=seq, steps=steps,
               timed_steps=f"{timed_from + 1}-{steps}", losses=losses, step_ms=step_s * 1e3,
               tokens_per_s=tokens / step_s, model_flops_per_step=flops,
               mfu=flops / step_s / PEAK_FLOPS["torch.bfloat16"],
               max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2**30, load=load, engine_init_s=init_s,
               leaves=len(engine.parameters()), grad_norm=engine.get_global_grad_norm(),
               skipped_steps=engine.skipped_steps, launches=launches,
               launches_per_step={k: v / timed for k, v in launches.items()})
    log(rec)
    if profile:
        profile_train(torch, engine, data, run=run)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train_hf {run}: losses not finite or not falling: {losses}")
    # remat runs each block's forward again in the backward: two forward launches a layer a step
    want = {"flash_fwd": (2 if cfg.remat else 1) * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers, "fused_adam": opt_launches("FusedAdam", rec["leaves"])}
    bad = {k: launches[k] / timed for k in want if launches[k] != want[k] * timed}
    if bad:
        raise AssertionError(f"train_hf {run}: launches per step {bad}, expected {want}")
    return rec


def hf_train_parity(torch, dev, run: str, d: str, counters) -> dict:
    """One fp32 engine step at ``HF_TRAIN_PARITY``'s 2 layers, on the card (the fp32 flash bodies at the run's
    head dim, counted) and on the CPU route (the plain versions), from the same directory and batch
    (``forward``, ``backward``, ``step``): the loss, every leaf's gradient (over its largest; ``k_proj``'s
    bias, whose true gradient is zero, over the largest of the model) and the global gradient norm within
    ``tol``, and the masters after the step (the CPU's copied to the card) within ``PAR_TOL`` of each other,
    their distance over each leaf's travel."""
    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.module_inject import load_checkpoint as lc

    p = HF_TRAIN_PARITY
    batch = {"input_ids": np.random.default_rng(7).integers(0, HF_CONFIGS[run][1]["vocab_size"],
                                                             (p["rows"], p["seq"])).astype(np.int32)}
    out, masters, grads, init = {}, {}, {}, {}
    for label, where in (("cpu", "cpu"), ("card", str(dev))):
        model, params = lc.load_hf_checkpoint(d, dtype=torch.float32, device=where, n_layers=p["layers"])
        engine, _, _, _ = dst.initialize(model=CausalLM(model.cfg), model_parameters=params,
                                         config=hf_train_config(torch, torch.float32, p["rows"]), device=where)
        if label == "card":
            init = {path: t.detach().clone() for path, t in zip(engine._paths, engine.parameters())}
            for fn in counters:
                fn.launches = 0
        t0 = time.perf_counter()
        loss = engine.forward(batch)
        engine.backward(loss)
        grads[label] = {path: g.detach().clone() for path, g in zip(engine._paths, engine._grad_acc)}
        engine.step()
        out[label] = dict(loss=float(loss), grad_norm=float(engine.get_global_grad_norm()),
                          step_s=time.perf_counter() - t0)
        masters[label] = dict(zip(engine._paths, engine.parameters()))
        del engine, model, params
    launches = {fn.__name__: fn.launches for fn in counters}
    dist2, ref2, share, k_bias = 0.0, 0.0, {}, 0.0
    for path, got in masters["card"].items():
        ref = masters["cpu"][path].to(dev)
        diff = (got.double() - ref.double()).norm().item()
        travel = (ref.double() - init[path].double()).norm().item()
        dist2 += diff**2
        ref2 += ref.double().norm().item()**2
        if path.endswith("k_proj/bias"):  # a zero true gradient: each side's fp32 noise (sketch_errors' note)
            k_bias = max(k_bias, diff / max(travel, 1e-300))
        else:
            share[path] = diff / max(travel, 1e-300)
    worst = max(share, key=share.get)
    m = dict(tree_rel=math.sqrt(dist2 / ref2), max_leaf_over_travel=share[worst], worst_leaf=worst,
             k_bias_over_travel=k_bias, leaves=len(share))
    top = max(g.abs().max().item() for g in grads["cpu"].values())
    g_err = {}
    for path, want in grads["cpu"].items():
        got = grads["card"][path].cpu()
        scale = top if path.endswith("k_proj/bias") else max(want.abs().max().item(), 1e-30)
        g_err[path] = dict(rel=(got - want).abs().max().item() / scale, norm_card=got.double().norm().item(),
                           norm_cpu=want.double().norm().item())
    worst_g = sorted(g_err, key=lambda k: -g_err[k]["rel"])[:4]
    rel = lambda k: abs(out["card"][k] - out["cpu"][k]) / abs(out["cpu"][k])  # noqa: E731
    rec = dict(phase="train_hf parity", run=run, layers=p["layers"], dtype="float32", tokens=p["rows"] * p["seq"],
               tol=p["tol"], card=out["card"], cpu=out["cpu"], loss_rel_err=rel("loss"),
               grad_norm_rel_err=rel("grad_norm"), grad_max_rel_err=g_err[worst_g[0]]["rel"],
               worst_grads={k: g_err[k] for k in worst_g}, masters=m, launches=launches)
    log(rec)
    del masters, init, grads
    gc.collect()
    torch.cuda.empty_cache()
    if not (rec["loss_rel_err"] <= p["tol"] and rec["grad_max_rel_err"] <= p["tol"]
            and rec["grad_norm_rel_err"] <= p["tol"] and masters_ok(m)):
        raise AssertionError(f"train_hf {run}: the fp32 step on the card differs from the CPU route: {rec}")
    if not all(launches[fn.__name__] == p["layers"] for fn in counters):
        raise AssertionError(f"train_hf {run}: fp32 launches {launches}, expected {p['layers']} each")
    return rec


def stacked_layers(torch, cfg, params) -> dict:
    """The ``scan_layers`` tree of an unrolled one: the blocks' leaves stacked under ``layers/block`` (copies)."""
    def stack(ts):
        return {k: stack([t[k] for t in ts]) for k in ts[0]} if isinstance(ts[0], dict) else torch.stack(ts)

    out = {k: v for k, v in params.items() if not k.startswith("layer_")}
    out["layers"] = {"block": stack([params[f"layer_{i}"] for i in range(cfg.n_layers)])}
    return out


def hf_scan_step(torch, dev, d: str) -> dict:
    """``scan_layers`` on the card: phi-2's widths at 2 layers in bf16, the loaded tree stacked, against the
    unrolled tree: 3 engine steps on one batch of 2 x 2,048 tokens each, every loss equal bit for bit (block i
    reads slice i: the same operations, and FusedAdam's update is elementwise). Without gradient clipping: the
    global norm sums a stacked leaf's squares in another grouping, so a clip's multiplier may differ by a
    rounding step (with clipping the third loss moved by 1.6e-5 relative on the card)."""
    import dataclasses
    import itertools

    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.module_inject import load_checkpoint as lc

    model, params = lc.load_hf_checkpoint(d, dtype=torch.float32, device=str(dev), n_layers=2)
    cfg = dataclasses.replace(model.cfg, dtype=torch.bfloat16)
    trees = {True: stacked_layers(torch, cfg, params), False: params}
    data = {"input_ids": np.random.default_rng(9).integers(0, cfg.vocab_size, (HF_TRAIN["micro"], HF_TRAIN[
        "seq"])).astype(np.int32)}
    losses, ms = {}, {}
    config = dict(hf_train_config(torch, torch.bfloat16, HF_TRAIN["micro"]), gradient_clipping=0.0)
    for scan in (False, True):
        engine, _, _, _ = dst.initialize(model=CausalLM(dataclasses.replace(cfg, scan_layers=scan)),
                                         model_parameters=trees[scan], config=config, device=dev)
        it = itertools.repeat(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses[scan] = [float(engine.train_batch(it)) for _ in range(3)]
        torch.cuda.synchronize()
        ms[scan] = (time.perf_counter() - t0) / 3 * 1e3
        del engine
    rec = dict(phase="train_hf scan_layers", run="phi_2", layers=2, dtype="bfloat16", losses_scan=losses[True],
               losses_unrolled=losses[False], step_ms_scan=ms[True], step_ms_unrolled=ms[False],
               all_equal=losses[True] == losses[False])
    log(rec)
    del trees, params, model
    gc.collect()
    torch.cuda.empty_cache()
    if not rec["all_equal"]:
        raise AssertionError(f"train_hf scan_layers: {rec}")
    return rec


def phase_train_hf(torch, dev, counters, dirs: dict, profile=False) -> dict:
    """train_hf: fine-tune phi_2 and gemma_2b (``HF_TRAIN_RUNS``) from ``dirs`` (the serve_hf directories);
    each also in fp32 at 2 layers against the CPU route; then the ``scan_layers`` step on phi_2's widths.
    Returns, per run, the bf16 run's record (``launches`` over its timed steps) and the fp32 parity's under
    ``fp32``."""
    out = {}
    for run in HF_TRAIN_RUNS:
        t0 = time.perf_counter()
        rec = hf_train_run(torch, dev, run, dirs[run], counters, profile)
        rec["fp32"] = hf_train_parity(torch, dev, run, dirs[run], counters[:3])
        out[run] = rec
        log(dict(phase="train_hf run", run=run, seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    out["scan_layers"] = hf_scan_step(torch, dev, dirs["phi_2"])
    log(dict(phase="train_hf scan_layers", seconds=time.perf_counter() - t0))
    return out


def phase_train_hf_alone(torch, dev, counters, profile=False) -> dict:
    """train_hf for ``--only``: the directories written here, as serve_hf writes them, and deleted after."""
    import shutil

    dirs = {}
    try:
        for run in HF_TRAIN_RUNS:
            ck = write_hf_checkpoint(torch, dev, run)
            log(dict(phase="train_hf write", run=run, **ck))
            dirs[run] = ck["dir"]
        return phase_train_hf(torch, dev, counters, dirs, profile)
    finally:
        for d in dirs.values():
            shutil.rmtree(d, ignore_errors=True)


# The paged kernels at the Hugging Face families' heads: (H, KVH, D) and the block table of the model's context
HF_GEOMS = {
    "phi_2": dict(H=32, KVH=32, D=80, bs=128, P=16),          # microsoft/phi-2, 2,048 positions
    "phi_3_mini": dict(H=32, KVH=32, D=96, bs=128, P=32),     # microsoft/Phi-3-mini-4k-instruct, 4,096
    "gemma_2b": dict(H=8, KVH=1, D=256, bs=128, P=64),        # google/gemma-2b, 8,192
    "gemma_7b": dict(H=16, KVH=16, D=256, bs=128, P=64),      # google/gemma-7b, 8,192
    "falcon_7b": dict(H=71, KVH=1, D=64, bs=128, P=16),       # tiiuae/falcon-7b, 2,048
}
# The norms at serve_hf's widths: phi-2's and falcon-7b's LayerNorm (weights in x's type, as loaded), gemma-2b's
# RMSNorm with its (1 + w) weight in fp32
HF_NORMS = {
    "phi_2": (phase_layer_norm, dict(d=2560)),
    "falcon_7b": (phase_layer_norm, dict(d=4544)),
    "gemma_2b": (phase_rms, dict(d=2048, offset=True)),
}


def run_hf_kernel_phases(torch, dev, quick: bool) -> list:
    """Paged decode (B 64, and cold at B 8) and prefill (2 x 512, and cold at 2 x 16) at each ``HF_GEOMS``
    shape on bf16 and int8 pools, with ALiBi and with a window at B 64 and 2 x 512, as the llama3_8b phases;
    bf16 q (the serving path; the fp32 bodies are held by ``hf_parity``). Then the norms at the families'
    widths (``HF_NORMS``), 8 and 768 rows, bf16 and fp32."""
    iters = 5 if quick else 20
    norm_cases = [lambda dt, fn=fn, T=T, kw=kw, m=m: dict(fn(torch, dev, dt, T, iters, **kw), hf_shape=m)
                  for m, (fn, kw) in HF_NORMS.items() for T in ((768,) if quick else (8, 768))]
    cases = []
    for name, geom in HF_GEOMS.items():
        for int8 in (False, True):
            sizes = [(phase_decode, 64, "none"), (phase_prefill, 512, "none")] if quick else [
                (phase_decode, 8, "none"), (phase_decode, 64, "none"), (phase_prefill, 16, "none"),
                (phase_prefill, 512, "none")] + [(fn, n, f) for f in ("alibi", "window")
                                                 for fn, n in ((phase_decode, 64), (phase_prefill, 512))]
            cases += [lambda dt, fn=fn, n=n, f=f, g=geom, q8=int8, m=name: dict(
                fn(torch, dev, dt, n, iters, g, int8=q8, feature=f), hf_shape=m) for fn, n, f in sizes]
            if quick:
                break
    return run_cases(torch, cases, dtypes=(torch.bfloat16,)) + run_cases(torch, norm_cases)


CSRC, TPU_OPS = "deepspeed_tpu_torch/csrc/", "deepspeed_tpu/ops/"
# The kernels line: name, the run whose launches are read, the wrapper counted, the dtype and the
# fields (matched by their start) of the record that represents the kernel, its source, the TPU kernel.
KERNEL_ROWS = [
    ("paged_attention_decode", "llama3_8b", "paged_attention_decode", "bfloat16",
     dict(kernel="paged_attention_decode", pool="torch", shape="q(64,32,128)", features="none"), "paged_decode.cu",
     "pallas/paged_attention.py:386"),
    ("paged_attention_prefill", "llama3_8b", "paged_attention_prefill", "bfloat16",
     dict(kernel="paged_attention_prefill", pool="torch", shape="q(2,512,32,128)", features="none"),
     "paged_prefill.cu", "pallas/paged_attention.py:531"),
    ("rms_norm", "llama3_8b", "rms_norm", "bfloat16", dict(kernel="rms_norm", shape="x(1,768,4096)"), "rms_norm.cu",
     "pallas/norms.py:45"),
    ("layer_norm", "gpt2_1_3b_w8_kv8", "layer_norm", "bfloat16", dict(kernel="layer_norm", shape="x(1,768,2048)"),
     "layer_norm.cu", "pallas/norms.py:91"),
    ("quantized_matmul (int8 codes)", "gpt2_1_3b_w8_kv8", "quantized_matmul", "bfloat16",
     dict(kernel="quantized_matmul", shape="x(64,2048) codes(2048,8192)"), "quantized_matmul.cu",
     "pallas/quantized_matmul.py:140"),
    ("quantized_matmul (packed int4 codes)", "llama3_8b_w4", "quantized_matmul", "bfloat16",
     dict(kernel="quantized_matmul", shape="x(64,4096) codes(2048,14336)"), "quantized_matmul.cu",
     "pallas/quantized_matmul.py:140"),
    ("paged_attention_decode (int8 pool)", "gpt2_1_3b_w8_kv8", "paged_attention_decode", "bfloat16",
     dict(kernel="paged_attention_decode", pool="int8", shape="q(64,32,64)", features="none"), "paged_decode.cu",
     "pallas/paged_attention.py:386"),
    ("paged_attention_prefill (int8 pool)", "gpt2_1_3b_w8_kv8", "paged_attention_prefill", "bfloat16",
     dict(kernel="paged_attention_prefill", pool="int8", shape="q(2,512,32,64)", features="none"),
     "paged_prefill.cu", "pallas/paged_attention.py:531"),
    ("flash_fwd", "train", "flash_fwd", "bfloat16", dict(kernel="flash_fwd", case="gpt2_1_3b"), "flash_fwd.cu",
     "pallas/flash_attention.py:185"),
    ("flash_bwd_dq", "train", "flash_bwd_dq", "bfloat16", dict(kernel="flash_bwd_dq", case="gpt2_1_3b"),
     "flash_bwd.cu", "pallas/flash_attention.py:417"),
    ("flash_bwd_dkv", "train", "flash_bwd_dkv", "bfloat16", dict(kernel="flash_bwd_dkv", case="gpt2_1_3b"),
     "flash_bwd.cu", "pallas/flash_attention.py:518"),
    ("fused_adam", "train", "fused_adam", "float32", dict(kernel="fused_adam", case="all"), "fused_adam.cu",
     "pallas/fused_adam.py:51"),
    ("flash_fwd (ulysses)", "train_seq", "flash_fwd", "bfloat16", dict(kernel="flash_fwd", case="ulysses_llama3_8b"),
     "flash_fwd.cu", "pallas/flash_attention.py:185"),
    ("flash_bwd_dq (ulysses)", "train_seq", "flash_bwd_dq", "bfloat16",
     dict(kernel="flash_bwd_dq", case="ulysses_llama3_8b"), "flash_bwd.cu", "pallas/flash_attention.py:417"),
    ("flash_bwd_dkv (ulysses)", "train_seq", "flash_bwd_dkv", "bfloat16",
     dict(kernel="flash_bwd_dkv", case="ulysses_llama3_8b"), "flash_bwd.cu", "pallas/flash_attention.py:518"),
    ("flash_fwd (bias)", "evoformer", "flash_fwd", "bfloat16", dict(kernel="flash_fwd (bias)", case="msa_row"),
     "flash_fwd.cu", "pallas/flash_attention.py:185"),
    ("flash_bwd_dq (bias)", "evoformer", "flash_bwd_dq", "bfloat16", dict(kernel="flash_bwd_dq (bias)",
                                                                          case="msa_row"),
     "flash_bwd.cu", "pallas/flash_attention.py:417"),
    ("flash_bwd_dq_collapsed", "evoformer", "flash_bwd_dq_collapsed", "bfloat16",
     dict(kernel="flash_bwd_dq_collapsed", case="msa_row_pair"), "flash_bwd.cu",
     "pallas/flash_attention.py:456"),
    ("flash_bwd_dkv (bias)", "evoformer", "flash_bwd_dkv", "bfloat16", dict(kernel="flash_bwd_dkv (bias)",
                                                                            case="msa_row"),
     "flash_bwd.cu", "pallas/flash_attention.py:485"),
    ("sparse_fwd", "sparse", "sparse_fwd", "bfloat16", dict(kernel="sparse_fwd", case="fixed_uni_gpt2_1_3b"),
     "sparse_fwd.cu", "sparse_attention/sparse_self_attention.py:193"),
    ("sparse_bwd_dq", "sparse", "sparse_bwd_dq", "bfloat16", dict(kernel="sparse_bwd_dq", case="fixed_uni_gpt2_1_3b"),
     "sparse_dq.cu", "sparse_attention/sparse_self_attention.py:222"),
    ("sparse_bwd_dkv", "sparse", "sparse_bwd_dkv", "bfloat16",
     dict(kernel="sparse_bwd_dkv", case="fixed_uni_gpt2_1_3b"), "sparse_dkv.cu",
     "sparse_attention/sparse_self_attention.py:239"),
    ("lamb_direction", "train_lamb", "lamb_direction", "float32", dict(kernel="lamb_direction", case="all"),
     "fused_lamb.cu", "pallas/fused_lamb.py:45"),
    ("quantize_groupwise", "v1_w8", "quantize_groupwise", "bfloat16",
     dict(kernel="quantize_groupwise", case="all-int8"), "quantization.cu", "pallas/quantization.py:49"),
    ("dequantize_groupwise", "v1_w8", "dequantize_groupwise", "bfloat16",
     dict(kernel="dequantize_groupwise", case="all-int8"), "quantization.cu", "pallas/quantization.py:64"),
    # the flash kernels at the Hugging Face families' head dims (*_wide.cu): launches over train_hf's timed bf16
    # steps of phi_2 (D 80) and gemma_2b (D 256), and in each one's fp32 step at 2 layers
    *[(f"{kernel} ({kind}D {D}, {model})", f"train_hf_{'fp32_' if kind else ''}{run}", kernel,
       "float32" if kind else "bfloat16", dict(kernel=kernel, case=run),
       "flash_fp32_wide.cu" if kind else src, "pallas/flash_attention.py:" + line)
      for kind in ("", "fp32, ") for run, model, D in (("phi_2", "phi-2", 80), ("gemma_2b", "gemma-2b", 256))
      for kernel, src, line in (("flash_fwd", "flash_fwd_wide.cu", "185"), ("flash_bwd_dq", "flash_dq_wide.cu", "417"),
                                ("flash_bwd_dkv", "flash_dkv_wide.cu", "518"))],
    # no pallas_call: the reference's MoE serving module runs lax.ragged_dot (plain XLA) at this line
    ("moe_grouped_gemm", "mixtral_8x7b_8l", "moe_grouped_gemm", "bfloat16",
     dict(kernel="moe_grouped_gemm", case="decode8_wi"), "moe_grouped_gemm.cu",
     "deepspeed_tpu/inference/v2/modules.py:195"),
]


# ---------------------------------------------------------------- tensor-parallel serving (two ranks, one card)
TP = 2
# the heads a rank holds at llama3_8b tp = 2: 16 query and 4 KV heads of 128
TP_GEOM = dict(GEOM, H=GEOM["H"] // TP, KVH=GEOM["KVH"] // TP)
# llama3_8b's quantized_matmul shapes on a rank at tp = 2, K -> N: q, k and v, o, gate and up, down
TP_QMM_SHAPES = [(4096, 2048), (4096, 512), (2048, 4096), (4096, 7168), (7168, 4096)]
# step parity at tp = 2, (dtype, logits, pools): kernels against their plain versions on each rank's shard,
# and (llama3_8b) tp = 2 against tp = 1 on the kernels; the two partial sums of a layer add in another order
# than one device's sums, so tp = 2 and tp = 1 differ in the last bits. fp32 at the step parity's fp32
# tolerance; gpt2_1_3b W8 (bf16 KV) at the llama3_8b bf16 step parity's
TP_PARITY = {"llama3_8b": ("float32", 1e-4, 1e-4), "gpt2_1_3b_w8": ("bfloat16", 0.125, 0.1),
             "mixtral_8x7b": ("float32", 1e-4, 1e-4)}
TP_TIMEOUT_S = 900
# (a)'s depth: 8 of llama3_8b's 32 layers (at 32 its gloo reduces, two a layer a step, make it the script's longest
# phase: the depth is cut for the whole script's time limit)
TP_SERVE_LAYERS = 8


def tp_params(torch, cfg, dev, dtype, rank, seed=0):
    """``init_params``' seed-``seed`` tree drawn leaf by leaf on ``dev`` (the same draws, in the same order),
    each leaf cut at once to rank ``rank``'s slice at tp = 2 under the serving engine's rules (the
    column-parallel biases too); and the tree of specs."""
    from deepspeed_tpu_torch.models.transformer import _init_leaf, param_shapes
    from deepspeed_tpu_torch.module_inject.load_checkpoint import (SERVING_BIAS_RULES, leaf_spec, model_tp_rules,
                                                                   shard_leaf)

    rules = model_tp_rules(cfg) + SERVING_BIAS_RULES
    gen = torch.Generator(device=dev).manual_seed(seed)

    def build(tree, keys):
        if isinstance(tree, dict):
            pairs = {k: build(v, keys + (k,)) for k, v in tree.items()}
            return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}
        spec = leaf_spec(keys, tree[0], rules, TP)
        return shard_leaf(_init_leaf(tree, gen, dev, dtype), spec, TP, rank), spec

    return build(param_shapes(cfg), ())


def tp_context(rank: int):
    from deepspeed_tpu_torch.inference.v2.model_runner import TPContext
    from deepspeed_tpu_torch.parallel.mesh import mesh_signature, serving_mesh

    topo = serving_mesh(TP)
    return TPContext(tp=TP, rank=rank, group=topo.process_group("tensor"), interleave=TP, mesh=mesh_signature(topo))


def tp_reduce_case(torch, dev, rank: int) -> dict:
    """(e) ``tp_all_reduce`` on this rank's row of a seeded (2, 64, 4096) fp32 input: exact, interleaved (2
    chunks) and 8-bit; and the host time of one exact and one 8-bit reduce of a decode step's (8 rows) and a
    768-token quantum's activations in bf16 (gloo stages them through the host)."""
    from deepspeed_tpu_torch.comm.collectives import tp_all_reduce

    xs = torch.randn((TP, 64, 4096), generator=torch.Generator().manual_seed(7))
    x = xs[rank].to(dev)
    out = {"exact": tp_all_reduce(x).cpu(), "interleaved": tp_all_reduce(x, interleave=TP).cpu(),
           "bits8": tp_all_reduce(x, bits=8).cpu(), "want": xs.sum(0), "amax": xs.abs().amax(dim=(0, -1))}
    times = {}
    for rows in (8, 768):
        t = torch.randn((rows, 4096), generator=torch.Generator().manual_seed(rows)).to(dev, torch.bfloat16)
        for bits in (0, 8):
            for _ in range(3):
                tp_all_reduce(t, bits=bits, interleave=TP)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                tp_all_reduce(t, bits=bits, interleave=TP)
            torch.cuda.synchronize()
            times[f"rows{rows}_bits{bits}_ms"] = (time.perf_counter() - t0) / 20 * 1e3
    out["host_ms"] = times
    return out


def tp_parity_case(torch, dev, rank: int, model: str) -> dict:
    """(b)-(d): the two step-parity quanta at 2 layers and full width on this rank's shard, with the kernels
    and with their plain versions (each rank's own pools); llama3_8b also at tp = 1 on the kernels, on rank 0
    (the whole tree); gpt2_1_3b with int8 weights quantised after sharding (bf16 KV); Mixtral-8x7B with the
    plain run pinned to the kernel run's routing. Returns the real rows' logits, live pools (garbage block 0
    apart) and the kernels' launches of the kernel run."""
    import numpy as np

    from deepspeed_tpu_torch.inference.quantization import quantize_for_serving
    from deepspeed_tpu_torch.inference.v2.model_runner import fused_forward
    from deepspeed_tpu_torch.inference.v2.modules import build_modules
    from deepspeed_tpu_torch.models import init_params
    from deepspeed_tpu_torch.ops import moe_grouped_gemm as mg, norms, paged_attention as pa
    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    dtype = getattr(torch, TP_PARITY[model][0])
    cfg = {"llama3_8b": model_cfg, "gpt2_1_3b_w8": gpt2_cfg, "mixtral_8x7b": mixtral_cfg}[model](n_layers=2,
                                                                                              dtype=dtype)
    bs = 128
    quanta, n_blocks = parity_quanta(np, cfg.vocab_size, bs)
    shape = (cfg.n_layers, n_blocks, bs, cfg.kv_heads, cfg.head_dim)
    P = GPT2_GEOM["P"] if model.startswith("gpt2") else GEOM["P"]
    args = [[torch.from_numpy(a).to(dev) for a in quantum_inputs(np, rows, n_dec, chunk, bs, P)]
            for n_dec, chunk, rows in quanta]
    real = [[r for r, (_, _, blk) in enumerate(rows) if blk] for _, _, rows in quanta]  # padded rows apart
    out = {"model": model, "dtype": str(dtype), "logits": {}, "pools": {}}
    if model == "llama3_8b" and rank == 0:  # tp = 1 on the kernels, the whole tree
        full = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=dtype)
        kp, vp = pa.make_kv_pool(shape, dtype, dev), pa.make_kv_pool(shape, dtype, dev)
        for q, ((n_dec, chunk, _), (ids, pos, bt, cx, slots, last)) in enumerate(zip(quanta, args)):
            out["logits"][("tp1", q)] = fused_forward(cfg, full, ids, pos, kp, vp, bt, cx, slots, last, n_dec=n_dec,
                                                      chunk=chunk, mods=build_modules())[0][real[q]].cpu()
        out["pools"]["tp1"] = (kp[:, 1:].cpu(), vp[:, 1:].cpu())
        del full, kp, vp
        torch.cuda.empty_cache()
    params, specs = tp_params(torch, cfg, dev, dtype, rank)
    if model == "gpt2_1_3b_w8":
        params = quantize_for_serving(params, num_bits=8, specs=specs, tp=TP)
    ctx = tp_context(rank)
    local = pa.kv_pool_shard_shape(shape, TP)
    counters = [norms.rms_norm, norms.layer_norm, qm.quantized_matmul, mg.moe_grouped_gemm,
                pa.paged_attention_decode, pa.paged_attention_prefill]
    routes = None
    for v, plain in (("kernel", False), ("plain", True)):
        kp, vp = pa.make_kv_pool(local, dtype, dev), pa.make_kv_pool(local, dtype, dev)
        mods = build_modules(plain=plain, tp=ctx)
        for fn in counters:
            fn.launches = 0
        for q, ((n_dec, chunk, _), (ids, pos, bt, cx, slots, last)) in enumerate(zip(quanta, args)):
            pin = routes[q].routes if plain and routes is not None else None
            with route_log(pin=pin) if cfg.moe_num_experts else contextlib.nullcontext() as log_q:
                out["logits"][(v, q)] = fused_forward(cfg, params, ids, pos, kp, vp, bt, cx, slots, last,
                                                      n_dec=n_dec, chunk=chunk, mods=mods)[0][real[q]].cpu()
            if cfg.moe_num_experts and not plain:
                routes = (routes or []) + [log_q]
        torch.cuda.synchronize()
        if not plain:
            out["launches"] = {fn.__name__: fn.launches for fn in counters if fn.launches}
        out["pools"][v] = (kp[:, 1:].cpu(), vp[:, 1:].cpu())
    out["local_heads"] = (params["layer_0"]["attn"]["q_proj"]["kernel"].shape[1], local[3])  # query, KV
    del params
    torch.cuda.empty_cache()
    return out


def tp_serve_case(torch, dev, rank: int) -> dict:
    """(a) llama3_8b at full width and TP_SERVE_LAYERS layers, bf16, tp = 2: the seed-0 tree built leaf by leaf,
    each rank keeping its slice, then the serve phase's two waves, 32 new tokens each (eager steps: gloo)."""
    import numpy as np

    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.ops import norms, paged_attention as pa

    cfg = model_cfg(n_layers=TP_SERVE_LAYERS)
    t0 = time.perf_counter()
    params, _ = tp_params(torch, cfg, dev, torch.bfloat16, rank)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
        state_manager=RaggedBatchConfig(max_context=8192, kv_block_size=128, memory_gb=8.0), dtype="bfloat16",
        device=str(dev), tensor_parallel=TP))
    del params
    wave1, wave2 = serving_prompts(np, cfg.vocab_size)
    engine.generate([wave1[0][:32]], max_new_tokens=4)  # warm-up (not counted)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = [norms.rms_norm, pa.paged_attention_decode, pa.paged_attention_prefill]
    for fn in counters:
        fn.launches = 0
    d0, q0, b0 = engine.dispatches, engine.fused_quanta, engine._m_tp_bytes.value
    t0 = time.perf_counter()
    out = engine.generate(wave1, max_new_tokens=32) + engine.generate(wave2, max_new_tokens=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(tokens=out, wall_s=wall, tokens_per_s=sum(len(o) for o in out) / wall, weights_init_s=init_s,
                launches={fn.__name__: fn.launches for fn in counters}, steps=engine.dispatches - d0,
                quanta=engine.fused_quanta - q0, manifest=engine.tp_manifest(), kv_blocks=engine._n_kv_blocks,
                weight_bytes=tree_bytes(engine.params), pool_shape=tuple(engine.k_pages.shape),
                tp_allreduce_bytes=engine._m_tp_bytes.value - b0,
                peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 2**30)


def tp_rank(rank: int, store: str, out_dir: str, cases) -> None:
    """A rank of serve_tp: gloo named for CUDA tensors over a file store, then each case, its results saved."""
    sys.path.insert(0, HERE)
    import torch

    from deepspeed_tpu_torch import comm as dist

    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_distributed(device=dev, backend="gloo", init_method=f"file://{store}", rank=rank, world_size=TP,
                          verbose=False)
    try:
        for name in cases:
            t0 = time.perf_counter()
            if name == "reduce":
                res = tp_reduce_case(torch, dev, rank)
            elif name == "serve":
                res = tp_serve_case(torch, dev, rank)
            else:
                res = tp_parity_case(torch, dev, rank, name)
            res["seconds"] = time.perf_counter() - t0
            torch.save(res, os.path.join(out_dir, f"{name}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def tp_kernel_records(torch, dev, iters=20) -> list:
    """The serving kernels at a rank's shapes at llama3_8b tp = 2, bf16, against their plain versions (run
    in this process before the ranks start): paged decode (B 8 and 64) and prefill (2 x 512) over 16 query
    and 4 KV heads, ``quantized_matmul`` (int8) over the five shard shapes at 8 and 512 tokens, and the
    grouped GEMM at Mixtral's experts' halved hidden dim."""
    dt = torch.bfloat16
    cases = [lambda: phase_decode(torch, dev, dt, 8, iters, geom=TP_GEOM),
             lambda: phase_decode(torch, dev, dt, 64, iters, geom=TP_GEOM),
             lambda: phase_prefill(torch, dev, dt, 512, iters, geom=TP_GEOM)]
    cases += [lambda M=M, K=K, N=N: phase_qmm(torch, dev, dt, M, K, N, 8, iters)
              for K, N in TP_QMM_SHAPES for M in (8, 512)]
    cases += [lambda n=n: phase_moe_gemm(torch, dev, dt, n, iters) for n in MOE_TP_CASES]
    records = []
    for case in cases:
        rec = dict(case(), phase="serve_tp kernel", tp=TP)
        log(rec)
        what, tol = rec["tol"]
        if not rec[what] <= tol:
            raise AssertionError(f"serve_tp {rec['kernel']} {rec['shape']}: {what} {rec[what]} > {tol}")
        records.append(rec)
        torch.cuda.empty_cache()
    return records


def tp_check_parity(torch, model, ranks) -> dict:
    """Each rank's kernels against its plain versions (logits and pools), the ranks' logits the same bits,
    and llama3_8b's tp = 2 against tp = 1 (each rank's pools against its heads of tp = 1's)."""
    _, l_tol, p_tol = TP_PARITY[model]
    rec = dict(phase="serve_tp parity", model=model, dtype=ranks[0]["dtype"], layers=2, tp=TP,
               local_heads=ranks[0]["local_heads"], tol=dict(logits=l_tol, pools=p_tol),
               launches=ranks[0]["launches"], seconds=max(r["seconds"] for r in ranks))
    err = lambda a, b: (a.float() - b.float()).abs().max().item()  # noqa: E731
    n_q = sum(1 for k in ranks[0]["logits"] if k[0] == "kernel")
    rec["kernel_vs_plain_logits"] = max(err(r["logits"][("kernel", q)], r["logits"][("plain", q)])
                                        for r in ranks for q in range(n_q))
    rec["kernel_vs_plain_pools"] = max(err(a, b) for r in ranks for a, b in zip(r["pools"]["kernel"],
                                                                                r["pools"]["plain"]))
    rec["ranks_same_logits"] = all(torch.equal(ranks[0]["logits"][k], ranks[1]["logits"][k])
                                   for k in ranks[0]["logits"] if k[0] != "tp1")
    ok = rec["kernel_vs_plain_logits"] <= l_tol and rec["kernel_vs_plain_pools"] <= p_tol and rec["ranks_same_logits"]
    if model == "llama3_8b":
        tp1 = ranks[0]["pools"]["tp1"]
        h = tp1[0].shape[3] // TP
        rec["tp2_vs_tp1_logits"] = max(err(ranks[0]["logits"][("kernel", q)], ranks[0]["logits"][("tp1", q)])
                                       for q in range(n_q))
        rec["tp2_vs_tp1_pools"] = max(err(a, b[:, :, :, r * h:(r + 1) * h]) for r, rk in enumerate(ranks)
                                      for a, b in zip(rk["pools"]["kernel"], tp1))
        rec["logits_max_abs"] = max(ranks[0]["logits"][("tp1", q)].abs().max().item() for q in range(n_q))
        ok = ok and rec["tp2_vs_tp1_logits"] <= l_tol and rec["tp2_vs_tp1_pools"] <= p_tol
    log(rec)
    if not ok or not all(torch.isfinite(r["logits"][("kernel", q)]).all() for r in ranks for q in range(n_q)):
        raise AssertionError(f"serve_tp parity {model} failed: {rec}")
    return rec


def phase_serve_tp(torch, dev) -> dict:
    """Tensor-parallel serving at tp = 2 as two processes on the one card, over gloo (NCCL takes one GPU a
    rank): the kernels at a rank's shapes here first (``tp_kernel_records``), then two ranks (``tp_rank``),
    each ``comm.init_distributed(device="cuda", backend="gloo")``, running (e) the reduce, (b) llama3_8b,
    (c) gpt2_1_3b W8 and (d) Mixtral-8x7B step parity at 2 layers, and (a) llama3_8b served at full width
    and TP_SERVE_LAYERS layers;
    every failure of a rank is fatal. The gloo reduce is staged through the host: nothing here measures
    NVLink. Returns the serve's launches per kernel and the records."""
    import multiprocessing as mp

    from deepspeed_tpu_torch.ops import _build

    _build.lib()  # built before the ranks start, so that they only load it
    records = tp_kernel_records(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    cases = ["reduce", "llama3_8b", "gpt2_1_3b_w8", "mixtral_8x7b", "serve"]
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=tp_rank, args=(r, os.path.join(d, "store"), d, cases)) for r in range(TP)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.time() + TP_TIMEOUT_S
        while any(p.is_alive() for p in procs) and time.time() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break  # a rank failed: the other would wait on it
            time.sleep(1)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise AssertionError(f"serve_tp: ranks exited with {codes} after {time.perf_counter() - t0:.0f} s")
        res = {name: [torch.load(os.path.join(d, f"{name}_rank{r}.pt"), weights_only=False) for r in range(TP)]
               for name in cases}
    red = res["reduce"]
    want, amax = red[0]["want"], red[0]["amax"]
    bound8 = TP * (amax[:, None] / 127) / 2 + 1e-6
    rec = dict(phase="serve_tp reduce", tp=TP, backend="gloo (host-staged)", shape=list(want.shape),
               exact_max_rel_err=(red[0]["exact"] - want).abs().max().item() / want.abs().max().item(),
               interleaved_equal=torch.equal(red[0]["interleaved"], red[0]["exact"]),
               bits8_max_err_over_bound=((red[0]["bits8"] - want).abs() / bound8).max().item(),
               ranks_bit_identical=all(torch.equal(red[0][k], red[1][k]) for k in ("exact", "interleaved", "bits8")),
               host_ms=red[0]["host_ms"], seconds=red[0]["seconds"])
    log(rec)
    if not (rec["exact_max_rel_err"] <= 1e-6 and rec["interleaved_equal"] and rec["bits8_max_err_over_bound"] <= 1
            and rec["ranks_bit_identical"]):
        raise AssertionError(f"serve_tp reduce failed: {rec}")
    parity = {m: tp_check_parity(torch, m, res[m]) for m in ("llama3_8b", "gpt2_1_3b_w8", "mixtral_8x7b")}
    serve = res["serve"]
    out = serve[0]["tokens"]
    launches = serve[0]["launches"]
    rec = dict(phase="serve_tp", run="llama3_8b", tp=TP, layers=TP_SERVE_LAYERS, dtype="bfloat16",
               backend="gloo (host-staged)",
               steps_mode=serve[0]["manifest"]["steps"], prompts=len(out), new_tokens=sum(len(o) for o in out),
               wall_s=max(s["wall_s"] for s in serve), tokens_per_s=min(s["tokens_per_s"] for s in serve),
               steps=serve[0]["steps"], quanta=serve[0]["quanta"], launches=launches, kv_blocks=serve[0]["kv_blocks"],
               tp_allreduce_bytes_per_rank=serve[0]["tp_allreduce_bytes"],
               pool_shape_per_rank=serve[0]["pool_shape"], weight_bytes_per_rank=[s["weight_bytes"] for s in serve],
               peak_memory_gb_per_rank=[s["peak_memory_gb"] for s in serve],
               weights_init_s=[s["weights_init_s"] for s in serve], ranks_same_tokens=serve[1]["tokens"] == out,
               seconds=max(s["seconds"] for s in serve))
    log(rec)
    if not rec["ranks_same_tokens"]:
        raise AssertionError("serve_tp: the ranks' tokens differ")
    if not all(len(o) == 32 and all(0 <= t < 128256 for t in o) for o in out):
        raise AssertionError("serve_tp: a request did not get 32 in-vocab tokens")
    norms_a_forward = 2 * TP_SERVE_LAYERS + 1
    if any(n <= 0 for n in launches.values()) or launches["rms_norm"] % norms_a_forward:
        raise AssertionError(f"serve_tp: launches {launches} (each kernel must launch; {norms_a_forward} rms_norm a "
                             "forward)")
    return dict(launches={**parity["gpt2_1_3b_w8"]["launches"], **parity["mixtral_8x7b"]["launches"], **launches},
                records=records, parity=parity, serve=rec)


# ---------------------------------------------------------------- pipeline and sequence parallelism (two ranks, one card)
PAR = 2  # ranks: two processes on the one card over gloo (NCCL takes one GPU a rank)
PAR_TIMEOUT_S = 600
# the steps of (a) and of (b) / (c) are cut for the whole script's time limit
PIPE_FP32 = dict(layers=4, steps=2)  # (a) fp32 parity at gpt2_1_3b's widths
PIPE_STEPS = 3  # (b), (c): gpt2_1_3b at full depth, steps TIMED_FROM+1.. timed (4 in PR 26, 6 before)
PIPE_MICRO = 2  # the train phase's 8-row batch as M = 4 micro-batches of 2 rows
SEQ_FP32 = dict(layers=1, tokens=2048, steps=2)  # (a) fp32 parity at llama3_8b's widths
# (b) one row of 8,192 tokens; two full-depth replicas do not fit; 2 steps and 1 layer (the whole script's time
# limit; 2 layers until the Hugging Face phases came)
SEQ_BF16 = dict(layers=1, tokens=8192, steps=2)
SKETCH_K = 4
# fp32: losses, the grad norm and the whole tree of masters within 1e-5 relative, each leaf within 2 % of its
# travel (as the CPU parity tests hold ZeRO); bf16: each step's loss within 1 % of one process's
PAR_TOL = dict(fp32_rel=1e-5, leaf_travel=0.02, bf16_loss_rel=0.01)


def sketch(torch, t, seed: int, k: int = SKETCH_K) -> list:
    """k seeded random +-1 projections of ``t``, summed in fp64: ||sketch(a) - sketch(b)|| / ||sketch(b)||
    estimates ||a - b|| / ||b|| without moving the tensors between processes."""
    flat = t.detach().reshape(-1)
    out = []
    for j in range(k):
        g = torch.Generator(device=flat.device).manual_seed(seed * k + j)
        acc = torch.zeros((), dtype=torch.float64, device=flat.device)
        for c in flat.split(1 << 25):
            r = torch.randint(0, 2, c.shape, generator=g, device=c.device, dtype=torch.int8).double() * 2 - 1
            acc += (c.double() * r).sum()
        out.append(acc.item())
    return out


def slice_sketch(torch, t, seed: int, shape, dim: int, rank: int, k: int = SKETCH_K) -> list:
    """``sketch`` of the whole leaf of ``shape`` restricted to ``t``, tensor rank ``rank``'s slice of it along
    ``dim``: the same +-1 draws (drawn whole, in ``sketch``'s chunks), each dotted with this rank's part only, so
    the ranks' results add up to ``sketch`` of the whole leaf without moving it."""
    numel, n = math.prod(shape), t.shape[dim]
    out = []
    for j in range(k):
        g = torch.Generator(device=t.device).manual_seed(seed * k + j)
        r = torch.cat([torch.randint(0, 2, (min(1 << 25, numel - o),), generator=g, device=t.device, dtype=torch.int8)
                       for o in range(0, numel, 1 << 25)])
        r = r.view(shape).narrow(dim, rank * n, n)
        out.append((t.detach().double() * (r.double() * 2 - 1)).sum().item())
    return out


def tp_sketches(torch, engine, name=lambda path: path) -> dict:
    """{name(path): sketch} of each whole master of a tensor-parallel engine (stage 0 or 1: each rank holds its
    slices whole along the other dimensions), from this rank's slices: a split leaf's parts summed over the tensor
    group in one all-reduce; a leaf ``name`` maps to None is left out. Every rank of the group must call it."""
    import zlib

    from deepspeed_tpu_torch import comm as dist

    out, split, parts = {}, [], []
    for lf, m in zip(engine.plan.leaves, engine.parameters()):
        key = name(lf.path)
        if key is None:
            continue
        seed = zlib.crc32(key.encode()) & 0x7FFFFFF
        if lf.tensor_dim is None:
            out[key] = sketch(torch, m, seed)
        else:
            split.append(key)
            parts.append(slice_sketch(torch, m, seed, lf.shape, lf.tensor_dim, engine._tp.rank))
    if split:
        sums = torch.tensor(parts, dtype=torch.float64, device=engine.device)
        dist.all_reduce(sums, group=engine._tp.group)
        out.update(zip(split, sums.tolist()))
    return out


def sketches(torch, named) -> dict:
    """{full-model path: sketch} over (path, tensor) pairs, each seeded by its path."""
    import zlib

    return {path: sketch(torch, t, zlib.crc32(path.encode()) & 0x7FFFFFF) for path, t in named}


def sketch_rel(a: list, b: list) -> float:
    return math.sqrt(sum((x - y)**2 for x, y in zip(a, b))) / max(math.sqrt(sum(y * y for y in b)), 1e-30)


def stage_to_full(path: str, stage: int, lps: int):
    """A stage tree's path as the whole model's (None for the last stage's tied copy of ``wte``)."""
    group, rest = path.split("/", 1)
    if group == "stages":
        sub, leaf = rest.split("/", 1)
        return f"layer_{stage * lps + int(sub.split('_')[1])}/{leaf}"
    return None if (group == "embed" and stage > 0) else rest


def pipe_config(torch, dtype, schedule: str) -> dict:
    cfg = train_config(torch, "FusedAdam", dtype)
    cfg.update(train_micro_batch_size_per_gpu=PIPE_MICRO, gradient_accumulation_steps=MICRO // PIPE_MICRO,
               mesh={"pipe": PAR, "data": 1}, pipeline={"schedule": schedule})
    return cfg


def seq_config(torch, dtype, mesh) -> dict:
    cfg = train_config(torch, "FusedAdam", dtype)
    cfg.update(train_micro_batch_size_per_gpu=1, mesh=mesh)
    return cfg


def seq_batch(np, vocab: int, tokens: int) -> dict:
    return {"input_ids": np.random.default_rng(1).integers(0, vocab, (1, tokens)).astype(np.int32)}


def train_steps(torch, engine, data, steps: int, timed_from: int, counters, on_timed=None) -> dict:
    """``steps`` train_batch calls; the counters (and ``on_timed``) reset before step ``timed_from`` + 1, the
    steps after it timed on the host around a device sync."""
    losses, t0 = [], None
    for i in range(steps):
        if i == timed_from:
            torch.cuda.synchronize()
            for fn in counters:
                fn.launches = 0
            if on_timed is not None:
                on_timed()
            t0 = time.perf_counter()
        losses.append(engine.train_batch(data))
    torch.cuda.synchronize()
    n = steps - timed_from
    return dict(losses=[float(x) for x in losses], step_ms=(time.perf_counter() - t0) / n * 1e3, timed_steps=n,
                launches={fn.__name__: fn.launches for fn in counters}, grad_norm=engine.get_global_grad_norm())


def par_counters():
    from deepspeed_tpu_torch.ops import flash_attention as fa, fused_adam as fad

    return [fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, fad.fused_adam]


def pipe_case(torch, dev, rank: int, dtype_name: str, schedule: str) -> dict:
    """A stage of gpt2_1_3b (fp32 at PIPE_FP32's depth, or bf16 at full depth) under ``schedule``: the train
    phase's seed-0 weights and 8-row batch as 4 micro-batches of 2 rows."""
    import itertools

    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch import comm as dist
    from deepspeed_tpu_torch.models import CausalLM, init_params

    fp32 = dtype_name == "fp32"
    dtype = torch.float32 if fp32 else torch.bfloat16
    cfg = gpt2_cfg(n_layers=PIPE_FP32["layers"], dtype=dtype) if fp32 else gpt2_cfg(dtype=dtype)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    engine, _, _, _ = dst.initialize(model=CausalLM(cfg), model_parameters=params,
                                     config=pipe_config(torch, dtype, schedule), device=dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ids = train_batch_data(np, cfg.vocab_size)["input_ids"]
    data = itertools.cycle([{"input_ids": ids[j:j + PIPE_MICRO]} for j in range(0, MICRO, PIPE_MICRO)])
    at0 = {}
    steps = PIPE_FP32["steps"] if fp32 else PIPE_STEPS
    res = train_steps(torch, engine, data, steps, 1 if fp32 else TIMED_FROM, par_counters(),
                      lambda: at0.update(recv=engine.recv_seconds, tied=engine.tied_reduce_seconds))
    res.update(stage=engine.stage_id, peak_gb=torch.cuda.max_memory_allocated(dev) / 2**30,
               recv_ms_per_step=(engine.recv_seconds - at0["recv"]) / res["timed_steps"] * 1e3,
               tied_reduce_ms_per_step=(engine.tied_reduce_seconds - at0["tied"]) / res["timed_steps"] * 1e3,
               sent_bytes=engine.p2p.sent_bytes, peak_stash=engine.peak_stash,
               leaves=len(engine.parameters()))
    lps = cfg.n_layers // PAR
    if fp32:
        res["sketch"] = sketches(torch, [(stage_to_full(p, engine.stage_id, lps), t) for p, t in
                                         zip(engine._paths, engine.parameters())
                                         if stage_to_full(p, engine.stage_id, lps) is not None])
    wte = engine.parameters()[engine._paths.index("embed/wte")].detach()
    if rank == PAR - 1:  # the tied copy goes to the first stage, which compares it bit for bit
        dist.send(wte.contiguous(), 0)
    else:
        other = torch.empty_like(wte)
        dist.recv(other, PAR - 1)
        res["wte_bit_equal"] = torch.equal(other, wte)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return res


def seq_case(torch, dev, rank: int, dtype_name: str, axis: str) -> dict:
    """llama3_8b widths at SEQ_FP32's or SEQ_BF16's depth and tokens, one row, over ``axis`` 2."""
    import itertools

    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM, init_params

    fp32 = dtype_name == "fp32"
    dims = SEQ_FP32 if fp32 else SEQ_BF16
    dtype = torch.float32 if fp32 else torch.bfloat16
    cfg = model_cfg(n_layers=dims["layers"], dtype=dtype)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    engine, _, _, _ = dst.initialize(model=CausalLM(cfg), model_parameters=params,
                                     config=seq_config(torch, dtype, {axis: PAR}), device=dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    data = itertools.repeat(seq_batch(np, cfg.vocab_size, dims["tokens"]))

    def zero_comm():
        for v in engine._sp.stats.values():
            v[:] = [0, 0, 0.0]

    res = train_steps(torch, engine, data, dims["steps"], 1, par_counters(), zero_comm)
    res.update(peak_gb=torch.cuda.max_memory_allocated(dev) / 2**30, sp=(engine._sp.kind, engine._sp.rank),
               comm={k: dict(calls=v[0] / res["timed_steps"], mb=v[1] / res["timed_steps"] / 2**20,
                             ms=v[2] / res["timed_steps"] * 1e3) for k, v in engine._sp.stats.items()})
    if fp32:
        res["sketch"] = sketches(torch, zip(engine._paths, engine.parameters()))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return res


def par_rank(rank: int, store: str, out_dir: str, cases, world: int = PAR) -> None:
    """A rank of train_pipe / train_seq / train_tp: gloo named for CUDA tensors over a file store, then each
    case."""
    sys.path.insert(0, HERE)
    import torch

    from deepspeed_tpu_torch import comm as dist
    from deepspeed_tpu_torch.parallel.mesh import reset_mesh

    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_distributed(device=dev, backend="gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                          verbose=False)
    try:
        for phase, dtype_name, variant in cases:
            t0 = time.perf_counter()
            reset_mesh()
            fn = {"pipe": pipe_case, "seq": seq_case, "tp": tp_case, "pipetp": pipe_tp_case}[phase]
            res = fn(torch, dev, rank, dtype_name, variant)
            res["seconds"] = time.perf_counter() - t0
            torch.save(res, os.path.join(out_dir, f"{phase}_{dtype_name}_{variant}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(torch, cases, world: int = PAR) -> dict:
    """``world`` ranks (two by default) on the one card, each running every case; every failure of a rank is
    fatal."""
    import multiprocessing as mp

    from deepspeed_tpu_torch.ops import _build

    _build.lib()  # built before the ranks start, so that they only load it
    gc.collect()
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=par_rank, args=(r, os.path.join(d, "store"), d, cases, world))
                 for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.time() + PAR_TIMEOUT_S
        while any(p.is_alive() for p in procs) and time.time() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break  # a rank failed: the other would wait on it
            time.sleep(1)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise AssertionError(f"ranks exited with {codes} after {time.perf_counter() - t0:.0f} s (cases {cases})")
        return {c: [torch.load(os.path.join(d, f"{c[0]}_{c[1]}_{c[2]}_rank{r}.pt"), weights_only=False)
                    for r in range(world)] for c in cases}


def one_process(torch, dev, model, config, data, steps: int, timed_from: int, want_sketch: bool) -> dict:
    """The one-process engine on the same weights and batches, for the ranks to be held to."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM, init_params

    torch.cuda.reset_peak_memory_stats()
    params = init_params(model, torch.Generator(device=dev).manual_seed(0), device=dev)
    engine, _, _, _ = dst.initialize(model=CausalLM(model), model_parameters=params, config=config, device=dev)
    del params
    if want_sketch:
        init = sketches(torch, zip(engine._paths, engine.parameters()))
    res = train_steps(torch, engine, data, steps, timed_from, par_counters())
    res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
    if want_sketch:
        res.update(sketch=sketches(torch, zip(engine._paths, engine.parameters())), init_sketch=init)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return res


def sketch_errors(ref: dict, init: dict, got: dict) -> dict:
    """The masters against the reference's, from the sketches: the whole tree's relative distance, and each
    leaf's distance over how far the reference moved it (its travel; the sketches are linear, so the travel's
    sketch is the difference of two). k_proj's bias, whose true gradient is zero (Adam moves it by each
    engine's own fp32 noise), is left out of the per-leaf share and reported apart."""
    dist2 = lambda a, b: sum((x - y)**2 for x, y in zip(a, b))  # noqa: E731
    whole = math.sqrt(sum(dist2(got[p], ref[p]) for p in ref) / sum(sum(y * y for y in ref[p]) for p in ref))
    share = {p: math.sqrt(dist2(got[p], ref[p]) / max(dist2(ref[p], init[p]), 1e-300)) for p in ref
             if not p.endswith("k_proj/bias")}
    worst = max(share, key=share.get)
    return dict(tree_rel=whole, max_leaf_over_travel=share[worst], worst_leaf=worst, leaves=len(ref),
                k_bias_over_travel=max([math.sqrt(dist2(got[p], ref[p]) / max(dist2(ref[p], init[p]), 1e-300))
                                        for p in ref if p.endswith("k_proj/bias")] or [0.0]))


def masters_ok(m: dict) -> bool:
    return m["tree_rel"] <= PAR_TOL["fp32_rel"] and m["max_leaf_over_travel"] <= PAR_TOL["leaf_travel"]


def phase_train_pipe(torch, dev, card: str, want=None) -> dict:
    """Pipeline parallelism at pipe 2 as two processes on the one card (``run_ranks``): (a) gpt2_1_3b widths at
    4 layers in fp32, 1F1B and GPipe, against the one-process engine on the same weights and batches; (b)
    gpt2_1_3b at full depth (12 layers a stage) in bf16 with FusedAdam, 1F1B, against the train phase's first
    PIPE_STEPS losses (``want``; else a one-process run here); (c) GPipe at the same size. Returns each kernel's
    launches per step in (b) (rank 0's and rank 1's summed) and the records."""
    import itertools

    import numpy as np

    batch = train_batch_data(np, 50257)
    ref32 = one_process(torch, dev, gpt2_cfg(n_layers=PIPE_FP32["layers"], dtype=torch.float32),
                        train_config(torch, "FusedAdam", torch.float32), itertools.repeat(batch), PIPE_FP32["steps"],
                        1, True)
    if want is None:
        want = one_process(torch, dev, gpt2_cfg(dtype=torch.bfloat16), train_config(torch, "FusedAdam",
                                                                                     torch.bfloat16),
                           itertools.repeat(batch), PIPE_STEPS, TIMED_FROM, False)["losses"]
    cases = [("pipe", "fp32", "1f1b"), ("pipe", "fp32", "gpipe"), ("pipe", "bf16", "1f1b"), ("pipe", "bf16", "gpipe")]
    res = run_ranks(torch, cases)
    records, ok = [], True
    for schedule in ("1f1b", "gpipe"):
        ranks = res[("pipe", "fp32", schedule)]
        got = {**ranks[0]["sketch"], **ranks[1]["sketch"]}
        rec = dict(phase="train_pipe", case="a", model="gpt2_1_3b", layers=PIPE_FP32["layers"], dtype="float32",
                   schedule=schedule, pipe=PAR, micro_batches=MICRO // PIPE_MICRO, rows=PIPE_MICRO, seq=SEQ,
                   losses=ranks[0]["losses"], one_process_losses=ref32["losses"],
                   loss_max_rel_err=max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], ref32["losses"])),
                   grad_norm_rel_err=abs(ranks[0]["grad_norm"] - ref32["grad_norm"]) / ref32["grad_norm"],
                   masters=sketch_errors(ref32["sketch"], ref32["init_sketch"], got),
                   same_loss_on_stages=ranks[0]["losses"] == ranks[1]["losses"],
                   wte_bit_equal=ranks[0]["wte_bit_equal"], tol=PAR_TOL["fp32_rel"], card=card)
        log(rec)
        records.append(rec)
        ok = ok and rec["loss_max_rel_err"] <= PAR_TOL["fp32_rel"] and rec["grad_norm_rel_err"] <= PAR_TOL["fp32_rel"] \
            and masters_ok(rec["masters"]) and rec["same_loss_on_stages"] and rec["wte_bit_equal"]
    launches = {}
    for schedule, case in (("1f1b", "b"), ("gpipe", "c")):
        ranks = res[("pipe", "bf16", schedule)]
        losses = ranks[0]["losses"]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, want[:PIPE_STEPS])]
        rec = dict(phase="train_pipe", case=case, model="gpt2_1_3b", layers=24, layers_per_stage=12, dtype="bfloat16",
                   schedule=schedule, pipe=PAR, backend="gloo (host-staged)", micro_batches=MICRO // PIPE_MICRO,
                   rows=PIPE_MICRO, seq=SEQ, steps=PIPE_STEPS, timed_steps=f"{TIMED_FROM + 1}-{PIPE_STEPS}",
                   step_ms=max(r["step_ms"] for r in ranks), step_ms_per_rank=[r["step_ms"] for r in ranks],
                   peak_gb_per_rank=[r["peak_gb"] for r in ranks],
                   recv_blocked_ms_per_step=[r["recv_ms_per_step"] for r in ranks],
                   tied_wte_reduce_ms_per_step=[r["tied_reduce_ms_per_step"] for r in ranks],
                   peak_stash=[r["peak_stash"] for r in ranks], losses=losses, one_process_losses=want[:PIPE_STEPS],
                   loss_rel_err=rel, wte_bit_equal=ranks[0]["wte_bit_equal"],
                   same_loss_on_stages=losses == ranks[1]["losses"],
                   launches_per_step=[{k: v / r["timed_steps"] for k, v in r["launches"].items()} for r in ranks],
                   tokens_per_s=MICRO * SEQ / (max(r["step_ms"] for r in ranks) / 1e3),
                   seconds=max(r["seconds"] for r in ranks), card=card)
        log(rec)
        records.append(rec)
        ok = ok and max(rel) <= PAR_TOL["bf16_loss_rel"] and rec["wte_bit_equal"] and rec["same_loss_on_stages"] \
            and all(np.isfinite(losses))
        if schedule == "1f1b":
            launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
            per_step = {k: v / ranks[0]["timed_steps"] for k, v in launches.items()}
            # each stage: 12 blocks x 4 micro-batches a step through each flash kernel, one FusedAdam launch
            want_l = {"flash_fwd": 96, "flash_bwd_dq": 96, "flash_bwd_dkv": 96, "fused_adam": 2}
            if per_step != want_l:
                raise AssertionError(f"train_pipe: launches per step {per_step}, expected {want_l}")
    if not ok:
        raise AssertionError(f"train_pipe failed: {records}")
    return dict(launches=launches, records=records)


def phase_train_seq(torch, dev, card: str) -> dict:
    """Sequence parallelism at seq 2 (Ulysses) and context 2 (ring) as two processes on the one card: (a)
    llama3_8b widths at 1 layer and 2,048 tokens in fp32 against the one-process engine; (b) at 1 layer
    (``SEQ_BF16``), one row of 8,192 tokens in bf16 with FusedAdam, 2 steps each, against the one-process engine
    at the same tokens. Returns the Ulysses run's launches (rank 0's) and the records."""
    import itertools

    import numpy as np

    refs = {}
    for name, dims, dtype in (("fp32", SEQ_FP32, torch.float32), ("bf16", SEQ_BF16, torch.bfloat16)):
        cfg = model_cfg(n_layers=dims["layers"], dtype=dtype)
        refs[name] = one_process(torch, dev, cfg, seq_config(torch, dtype, {"data": 1}),
                                 itertools.repeat(seq_batch(np, cfg.vocab_size, dims["tokens"])), dims["steps"], 1,
                                 name == "fp32")
    cases = [("seq", d, a) for d in ("fp32", "bf16") for a in ("seq", "context")]
    res = run_ranks(torch, cases)
    records, ok, launches = [], True, {}
    for (_, dtype_name, axis), ranks in res.items():
        ref = refs[dtype_name]
        dims = SEQ_FP32 if dtype_name == "fp32" else SEQ_BF16
        losses = ranks[0]["losses"]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
        rec = dict(phase="train_seq", case="a" if dtype_name == "fp32" else "b", model="llama3_8b",
                   layers=dims["layers"], dtype="float32" if dtype_name == "fp32" else "bfloat16", axis=axis, size=PAR,
                   attention="ulysses (flash kernels)" if axis == "seq" else "ring (plain matmul blocks)",
                   backend="gloo (host-staged)", tokens=dims["tokens"], steps=dims["steps"], losses=losses,
                   one_process_losses=ref["losses"], loss_rel_err=rel,
                   grad_norm_rel_err=abs(ranks[0]["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
                   step_ms=max(r["step_ms"] for r in ranks), one_process_step_ms=ref["step_ms"],
                   peak_gb_per_rank=[r["peak_gb"] for r in ranks], one_process_peak_gb=ref["peak_gb"],
                   comm_per_step=ranks[0]["comm"], same_loss_on_ranks=losses == ranks[1]["losses"],
                   launches_per_step={k: v / ranks[0]["timed_steps"] for k, v in ranks[0]["launches"].items()},
                   seconds=max(r["seconds"] for r in ranks), card=card,
                   depth_note="depth cut: two full-depth replicas do not fit in 80 GB")
        if dtype_name == "fp32":
            rec["masters"] = sketch_errors(ref["sketch"], ref["init_sketch"], ranks[0]["sketch"])
            good = max(rel) <= PAR_TOL["fp32_rel"] and rec["grad_norm_rel_err"] <= PAR_TOL["fp32_rel"] \
                and masters_ok(rec["masters"])
        else:
            good = max(rel) <= PAR_TOL["bf16_loss_rel"]
            if axis == "seq":
                launches = dict(ranks[0]["launches"])
        log(rec)
        records.append(rec)
        ok = ok and good and rec["same_loss_on_ranks"] and all(np.isfinite(losses))
    per_step = {k: v / (SEQ_BF16["steps"] - 1) for k, v in launches.items()}
    want_l = {"flash_fwd": SEQ_BF16["layers"], "flash_bwd_dq": SEQ_BF16["layers"],
              "flash_bwd_dkv": SEQ_BF16["layers"], "fused_adam": 1}
    if per_step != want_l:
        raise AssertionError(f"train_seq: Ulysses launches per step {per_step}, expected {want_l}")
    if not ok:
        raise AssertionError(f"train_seq failed: {records}")
    return dict(launches=launches, records=records)


# ---------------------------------------------------------------- tensor-parallel training (two or four ranks)
TP_FP32 = dict(layers=2, steps=2, gpt2_rows=2, llama_tokens=2048)  # (a) fp32 parity at tensor 2
# (b) gpt2_1_3b at full depth in bf16, train's micro-batch on both ranks; steps TIMED_FROM+1.. timed (3: the whole
# script's time limit; 6 before PR 26, 4 in it)
TP_STEPS = 3
TP_PIPE = dict(layers=4, steps=2)  # (c) pipe 2 x tensor 2, four processes, fp32
TP_MODELS = ("gpt2_1_3b", "llama3_8b")
TP_OPTIMIZERS = ("FusedAdam", "Lamb")


def tp_model(torch, name: str, dtype, layers=None):
    """gpt2_1_3b or llama3_8b at ``layers`` (default: the preset's depth) in ``dtype``."""
    kw = dict(dtype=dtype, **({"n_layers": layers} if layers else {}))
    return gpt2_cfg(**kw) if name == "gpt2_1_3b" else model_cfg(**kw)


def tp_batch(np, name: str, vocab: int, fp32: bool) -> dict:
    """(a): 2 of train's rows for gpt2_1_3b, one row of 2,048 tokens for llama3_8b; (b): train's 8 x 1,024."""
    if name == "llama3_8b":
        return seq_batch(np, vocab, TP_FP32["llama_tokens"])
    ids = train_batch_data(np, vocab)["input_ids"]
    return {"input_ids": ids[:TP_FP32["gpt2_rows"]] if fp32 else ids}


def tp_train_config(torch, optimizer: str, dtype, mesh: dict, rows: int) -> dict:
    cfg = train_config(torch, optimizer, dtype)
    cfg.update(train_micro_batch_size_per_gpu=rows, mesh=mesh)
    return cfg


def tp_counters(optimizer: str):
    from deepspeed_tpu_torch.ops import fused_lamb as tfl

    return par_counters() + ([tfl.lamb_direction] if optimizer == "Lamb" else [])


def tp_case(torch, dev, rank: int, dtype_name: str, variant: str) -> dict:
    """A tensor rank of ``variant`` ("<model>-<optimizer>"): (a) fp32 at TP_FP32's depth, or (b) gpt2_1_3b at full
    depth in bf16, on the whole seeded model (each rank keeps its slices) and the same rows on both ranks."""
    import itertools

    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM, init_params

    name, optimizer = variant.split("-")
    fp32 = dtype_name == "fp32"
    dtype = torch.float32 if fp32 else torch.bfloat16
    cfg = tp_model(torch, name, dtype, TP_FP32["layers"] if fp32 else None)
    batch = tp_batch(np, name, cfg.vocab_size, fp32)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    engine, _, _, _ = dst.initialize(model=CausalLM(cfg), model_parameters=params, device=dev,
                                     config=tp_train_config(torch, optimizer, dtype, {"tensor": TP},
                                                            len(batch["input_ids"])))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    def zero_comm():
        for v in engine._tp.stats.values():
            v[:] = [0, 0, 0.0]

    res = train_steps(torch, engine, itertools.repeat(batch), TP_FP32["steps"] if fp32 else TP_STEPS,
                      1 if fp32 else TIMED_FROM, tp_counters(optimizer), zero_comm)
    n = res["timed_steps"]
    res.update(peak_gb=torch.cuda.max_memory_allocated(dev) / 2**30, tp_rank=engine._tp.rank,
               comm={k: dict(calls=v[0] / n, mb=v[1] / n / 2**20, ms=v[2] / n * 1e3) for k, v in
                     engine._tp.stats.items()}, leaves=len(engine.parameters()),
               rank_params=sum(p.numel() for p in engine.parameters()), step_flops=engine._step_flops)
    if fp32:
        t0 = time.perf_counter()
        res["sketch"] = tp_sketches(torch, engine)
        # the leaves every tensor rank holds whole, whose projections must be equal across the ranks
        res["replicated"] = [lf.path for lf in engine.plan.leaves if lf.tensor_dim is None]
        res["sketch_s"] = time.perf_counter() - t0
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return res


def pipe_tp_case(torch, dev, rank: int, dtype_name: str, schedule: str) -> dict:
    """A rank of pipe 2 x tensor 2: gpt2_1_3b widths at TP_PIPE's depth in fp32, train's batch as 4 micro-batches
    of 2 rows; the whole stage leaves' sketches from tensor rank 0."""
    import itertools

    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM, init_params

    cfg = gpt2_cfg(n_layers=TP_PIPE["layers"], dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    config = pipe_config(torch, torch.float32, schedule)
    config["mesh"] = {"pipe": PAR, "tensor": TP}
    engine, _, _, _ = dst.initialize(model=CausalLM(cfg), model_parameters=params, config=config, device=dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ids = train_batch_data(np, cfg.vocab_size)["input_ids"]
    data = itertools.cycle([{"input_ids": ids[j:j + PIPE_MICRO]} for j in range(0, MICRO, PIPE_MICRO)])
    res = train_steps(torch, engine, data, TP_PIPE["steps"], 1, par_counters())
    lps = cfg.n_layers // PAR
    res.update(stage=engine.stage_id, tp_rank=engine._tp.rank,
               sketch=tp_sketches(torch, engine, lambda p: stage_to_full(p, engine.stage_id, lps)))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tp_kernel_checks(torch, dev, card: str, iters=10) -> list:
    """(k): the flash forward, dq and dk/dv at a tensor rank's shapes (TP_FLASH_CASES) in bf16 and fp32, and
    ``fused_adam_multi`` over tensor rank 0's gpt2_1_3b leaves, each against its plain version in this
    process."""
    records = []
    for dtype in (torch.bfloat16, torch.float32):
        for name in TP_FLASH_CASES:
            for rec in phase_flash(torch, dev, dtype, name, iters):
                rec.update(phase="train_tp", part="k", card=card)
                log(rec)
                check_flash(rec)
                records.append(rec)
            torch.cuda.empty_cache()
    rec = phase_adam(torch, dev, "tp2", iters)
    rec.update(phase="train_tp", part="k", card=card)
    log(rec)
    check_adam(rec)
    records.append(rec)
    torch.cuda.empty_cache()
    return records


def phase_train_tp(torch, dev, card: str, want=None) -> dict:
    """Tensor-parallel training at tensor 2 as two processes on the one card (``run_ranks``), and pipe 2 x tensor
    2 as four: (k) the kernels at a rank's shapes against their plain versions; (a) gpt2_1_3b (tied head, ``wte``
    whole) and llama3_8b widths (untied vocab-parallel head and CE, 16 / 4 heads a rank) at 2 layers in fp32,
    2 steps with FusedAdam and with LAMB, against the one-process engine on the same weights and batches; (b)
    gpt2_1_3b at full depth in bf16 with FusedAdam on train's micro-batch, against ``train``'s first TP_STEPS
    losses (``want``; else a one-process run here); (c) pipe 2 x tensor 2, gpt2_1_3b widths at 4 layers in
    fp32, 1F1B, against one process. Returns rank 0's launches over (b)'s timed steps, the LAMB direction's
    over (a)'s llama3_8b LAMB run, and the records."""
    import itertools

    import numpy as np

    t0 = time.perf_counter()
    records = tp_kernel_checks(torch, dev, card)
    parts = dict(k=time.perf_counter() - t0)
    t0 = time.perf_counter()
    refs = {}
    for name in TP_MODELS:
        cfg = tp_model(torch, name, torch.float32, TP_FP32["layers"])
        batch = tp_batch(np, name, cfg.vocab_size, True)
        for optimizer in TP_OPTIMIZERS:
            refs[(name, optimizer)] = one_process(
                torch, dev, cfg, tp_train_config(torch, optimizer, torch.float32, {"data": 1}, len(batch["input_ids"])),
                itertools.repeat(batch), TP_FP32["steps"], 1, True)
    if want is None:
        want = one_process(torch, dev, gpt2_cfg(dtype=torch.bfloat16), train_config(torch, "FusedAdam",
                                                                                     torch.bfloat16),
                           itertools.repeat(train_batch_data(np, 50257)), TP_STEPS, TIMED_FROM, False)["losses"]
    pipe_ref = one_process(torch, dev, gpt2_cfg(n_layers=TP_PIPE["layers"], dtype=torch.float32),
                           train_config(torch, "FusedAdam", torch.float32),
                           itertools.repeat(train_batch_data(np, 50257)), TP_PIPE["steps"], 1, True)
    cases = [("tp", "fp32", f"{m}-{o}") for m in TP_MODELS for o in TP_OPTIMIZERS] + [("tp", "bf16",
                                                                                        "gpt2_1_3b-FusedAdam")]
    parts["one_process"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = run_ranks(torch, cases)
    parts["two_ranks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res.update(run_ranks(torch, [("pipetp", "fp32", "1f1b")], world=PAR * TP))
    parts["four_ranks"] = time.perf_counter() - t0
    log(dict(phase="train_tp parts", seconds=parts, card=card))
    ok, lamb_launches = True, {}
    for name in TP_MODELS:
        for optimizer in TP_OPTIMIZERS:
            ranks, ref = res[("tp", "fp32", f"{name}-{optimizer}")], refs[(name, optimizer)]
            rec = dict(phase="train_tp", case="a", model=name, layers=TP_FP32["layers"], dtype="float32",
                       optimizer=optimizer, tensor=TP, backend="gloo (host-staged)",
                       tokens=int(np.prod(tp_batch(np, name, 8, True)["input_ids"].shape)),
                       losses=ranks[0]["losses"], one_process_losses=ref["losses"],
                       loss_max_rel_err=max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], ref["losses"])),
                       grad_norm_rel_err=abs(ranks[0]["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
                       masters=sketch_errors(ref["sketch"], ref["init_sketch"], ranks[0]["sketch"]),
                       same_loss_on_ranks=ranks[0]["losses"] == ranks[1]["losses"],
                       replicas_equal=all(ranks[0]["sketch"][p] == ranks[1]["sketch"][p] for p in ranks[0]["replicated"]),
                       replicated_leaves=len(ranks[0]["replicated"]), leaves_per_rank=ranks[0]["leaves"],
                       params_per_rank=ranks[0]["rank_params"], comm_per_step=ranks[0]["comm"],
                       launches_per_step={k: v / ranks[0]["timed_steps"] for k, v in ranks[0]["launches"].items()},
                       seconds=max(r["seconds"] for r in ranks), sketch_s=max(r["sketch_s"] for r in ranks),
                       tol=PAR_TOL["fp32_rel"], card=card)
            log(rec)
            records.append(rec)
            ok = ok and rec["loss_max_rel_err"] <= PAR_TOL["fp32_rel"] and \
                rec["grad_norm_rel_err"] <= PAR_TOL["fp32_rel"] and masters_ok(rec["masters"]) and \
                rec["same_loss_on_ranks"] and rec["replicas_equal"]
            if name == "llama3_8b" and optimizer == "Lamb":
                lamb_launches = {"lamb_direction": ranks[0]["launches"]["lamb_direction"]}
    ranks = res[("tp", "bf16", "gpt2_1_3b-FusedAdam")]
    losses = ranks[0]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want[:TP_STEPS])]
    step_ms = max(r["step_ms"] for r in ranks)
    rec = dict(phase="train_tp", case="b", model="gpt2_1_3b", layers=24, dtype="bfloat16", optimizer="FusedAdam",
               tensor=TP, heads_per_rank=16, wte="whole on both ranks (50,257 is odd)", backend="gloo (host-staged)",
               rows=MICRO, seq=SEQ, steps=TP_STEPS, timed_steps=f"{TIMED_FROM + 1}-{TP_STEPS}", step_ms=step_ms,
               step_ms_per_rank=[r["step_ms"] for r in ranks], tokens_per_s=MICRO * SEQ / (step_ms / 1e3),
               peak_gb_per_rank=[r["peak_gb"] for r in ranks], params_per_rank=[r["rank_params"] for r in ranks],
               tp_comm_per_step=[r["comm"] for r in ranks], losses=losses, train_losses=want[:TP_STEPS],
               loss_rel_err=rel, same_loss_on_ranks=losses == ranks[1]["losses"],
               launches_per_step=[{k: v / r["timed_steps"] for k, v in r["launches"].items()} for r in ranks],
               engine_step_flops=ranks[0]["step_flops"], seconds=max(r["seconds"] for r in ranks), card=card)
    log(rec)
    records.append(rec)
    ok = ok and max(rel) <= PAR_TOL["bf16_loss_rel"] and rec["same_loss_on_ranks"] and all(np.isfinite(losses))
    launches = dict(ranks[0]["launches"])
    per_step = {k: v / ranks[0]["timed_steps"] for k, v in launches.items()}
    want_l = {"flash_fwd": 24, "flash_bwd_dq": 24, "flash_bwd_dkv": 24, "fused_adam": 1}  # a rank's, each block
    if per_step != want_l:
        raise AssertionError(f"train_tp: launches per step {per_step}, expected {want_l}")
    ranks = res[("pipetp", "fp32", "1f1b")]
    got = {}
    for r in ranks:
        if r["tp_rank"] == 0:
            got.update(r["sketch"])
    rec = dict(phase="train_tp", case="c", model="gpt2_1_3b", layers=TP_PIPE["layers"], dtype="float32",
               schedule="1f1b", pipe=PAR, tensor=TP, processes=PAR * TP, backend="gloo (host-staged)",
               micro_batches=MICRO // PIPE_MICRO, rows=PIPE_MICRO, seq=SEQ, losses=ranks[0]["losses"],
               one_process_losses=pipe_ref["losses"],
               loss_max_rel_err=max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], pipe_ref["losses"])),
               grad_norm_rel_err=abs(ranks[0]["grad_norm"] - pipe_ref["grad_norm"]) / pipe_ref["grad_norm"],
               masters=sketch_errors(pipe_ref["sketch"], pipe_ref["init_sketch"], got),
               same_loss_on_ranks=all(r["losses"] == ranks[0]["losses"] for r in ranks),
               step_ms=max(r["step_ms"] for r in ranks), seconds=max(r["seconds"] for r in ranks),
               tol=PAR_TOL["fp32_rel"], card=card)
    log(rec)
    records.append(rec)
    ok = ok and rec["loss_max_rel_err"] <= PAR_TOL["fp32_rel"] and rec["grad_norm_rel_err"] <= PAR_TOL["fp32_rel"] \
        and masters_ok(rec["masters"]) and rec["same_loss_on_ranks"] and len(got) == len(pipe_ref["sketch"])
    if not ok:
        raise AssertionError(f"train_tp failed: {records}")
    return dict(launches=launches, lamb_launches=lamb_launches, records=records)


def kernel_row(records, runs, name, run, counter, dtype, want, source, replaces) -> dict:
    r = next(x for x in records if x["dtype"] == f"torch.{dtype}"
             and all(str(x.get(k, "")).startswith(v) for k, v in want.items()))
    replaces = replaces if replaces.startswith("deepspeed_tpu/") else TPU_OPS + replaces
    return {"name": name, "route": "cuda", "source": CSRC + source, "replaces": replaces,
            "launches": runs[run]["launches"][counter], "max_abs_err": r["max_abs_err"],
            "max_rel_err": r["max_rel_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "dtype": dtype, "launches_read_from": run,
            **({"parent_ms": r["parent_ms"]} if r.get("parent_ms") is not None else {})}


def run_spill_phases(torch, dev, counters, quant_counters) -> None:
    """serve_spill (llama3_8b, its third pass journaled into a temporary directory), journal, and
    serve_spill_kv8 (gpt2_1_3b W8 + KV8), each with its seconds."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as journal_dir:
        spill = phase_serve_spill(torch, dev, counters, "llama3_8b", journal_dir=journal_dir)
        log(dict(phase="serve_spill", seconds=time.perf_counter() - t0))
        t0 = time.perf_counter()
        phase_journal(torch, dev, counters, spill)
        log(dict(phase="journal", seconds=time.perf_counter() - t0))
    del spill  # its weights
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_serve_spill(torch, dev, quant_counters, "gpt2_1_3b_w8_kv8")
    gc.collect()
    torch.cuda.empty_cache()
    log(dict(phase="serve_spill_kv8", seconds=time.perf_counter() - t0))


def main(argv) -> int:
    quick = "--quick" in argv  # build + one case per kernel, then stop
    profile = "--profile" in argv  # add torch.profiler passes over the serving waves and a training step
    # --parent DIR: also time DIR's quantized_matmul and flash forward, dq and dk/dv, and run the quantised
    # serving runs and the training run once more on them (DIR: another checkout's sources, e.g. under build/)
    parent_dir = argv[argv.index("--parent") + 1] if "--parent" in argv else None
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False); nothing was run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "deepspeed_tpu_torch")):
        print(f"chip_smoke: the deepspeed_tpu_torch package is not beside {__file__}; run it from the repository",
              file=sys.stderr)
        return 3
    sys.path.insert(0, HERE)
    from deepspeed_tpu_torch.ops import _build, flash_attention as fa, fused_adam as fad, fused_lamb as tfl, norms
    from deepspeed_tpu_torch.ops import moe_grouped_gemm as mg
    from deepspeed_tpu_torch.ops import paged_attention as pa, quantization as tq, quantized_matmul as qm
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 comparisons in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(dict(phase="card", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
             torch=torch.__version__, cuda=torch.version.cuda))

    t0 = time.perf_counter()
    _build.lib()
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", _build.build_log)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", _build.build_log)]
    log(dict(phase="build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.build_seconds,
             ptxas=dict(entries=len(regs), max_registers=max(regs, default=0), spill_store_bytes=sum(spills))))
    if parent_dir is not None:
        t0 = time.perf_counter()
        PARENT["lib"] = load_parent(os.path.abspath(parent_dir))
        log(dict(phase="parent build", dir=parent_dir, seconds=time.perf_counter() - t0))

    if "--only" in argv:  # a development run: the build, then the named phases alone
        only = argv[argv.index("--only") + 1].split(",")
        tc = [fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, fad.fused_adam]
        phases = {"train_zeropp": lambda: phase_train_zeropp(torch, dev, tc),
                  "train_moe": lambda: phase_train_moe(torch, dev, tc), "serve_tp": lambda: phase_serve_tp(torch, dev),
                  "train_pipe": lambda: phase_train_pipe(torch, dev, card),
                  "train_seq": lambda: phase_train_seq(torch, dev, card),
                  "train_tp": lambda: phase_train_tp(torch, dev, card),
                  "serve_hf": lambda: phase_serve_hf(torch, dev, hf_counters(pa, norms), fa.flash_fwd),
                  "hf_kernels": lambda: run_hf_kernel_phases(torch, dev, False),
                  "train_kernels": lambda: run_train_kernel_phases(torch, dev, False),
                  "flash_wide": lambda: run_wide_flash_phases(torch, dev, False),
                  "train_hf": lambda: phase_train_hf_alone(torch, dev, tc, profile),
                  "sla": lambda: phase_sla(torch, dev, [pa.paged_attention_decode, pa.paged_attention_prefill,
                                                        norms.rms_norm])}
        for name in only:
            t0 = time.perf_counter()
            phases[name]()
            log(dict(phase=name, seconds=time.perf_counter() - t0))
        return 0
    paged = [pa.paged_attention_decode, pa.paged_attention_prefill]
    counters = paged + [norms.rms_norm]
    t0 = time.perf_counter()
    records = run_kernel_phases(torch, dev, quick)
    log(dict(phase="kernels", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    records += run_hf_kernel_phases(torch, dev, quick)
    log(dict(phase="hf kernels", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    quant_records = run_quant_kernel_phases(torch, dev, quick)
    log(dict(phase="quantised serving kernels", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    records += run_train_kernel_phases(torch, dev, quick)
    log(dict(phase="train kernels", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    records += run_wide_flash_phases(torch, dev, quick)
    log(dict(phase="flash_wide", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    records += run_evo_kernel_phases(torch, dev, quick)
    log(dict(phase="evo kernels", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    records += run_sparse_kernel_phases(torch, dev, quick)
    log(dict(phase="sparse kernels", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    records += phase_quant_kernels(torch, dev, quick)
    log(dict(phase="quant kernels", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    records += run_lamb_kernel_phases(torch, dev, quick)
    log(dict(phase="lamb kernel", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    records += run_moe_kernel_phases(torch, dev, quick)
    log(dict(phase="moe kernel", seconds=time.perf_counter() - t0))
    if quick:
        log(dict(phase="quick", seconds=time.perf_counter() - t_start))
        return 0
    t0 = time.perf_counter()
    for model in ("llama3_8b", "gpt2_1_3b"):
        for dtype in (torch.float32, torch.bfloat16):
            phase_step_parity(torch, dev, dtype, model)
    for dtype in (torch.float32, torch.bfloat16):
        phase_step_parity(torch, dev, dtype, "mixtral_8x7b", n_layers=2)
    log(dict(phase="step_parity", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    serve = phase_serve(torch, dev, counters, "llama3_8b", profile, keep_params=True)
    log(dict(phase="serve", seconds=time.perf_counter() - t0))
    params = serve.pop("params")
    t0 = time.perf_counter()
    phase_serve_spec(torch, dev, counters, params)
    phase_spec_fp32(torch, dev, counters)
    log(dict(phase="serve_spec", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    phase_telemetry(torch, dev, counters, params)
    del params
    log(dict(phase="telemetry", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    phase_serve(torch, dev, counters, "llama3_8b_cache16", profile, want=serve["tokens"])
    log(dict(phase="serve_cache16", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    phase_serve(torch, dev, counters, "llama3_8b_unfused", profile, beside=serve["tokens"])
    log(dict(phase="serve_unfused", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    phase_sla(torch, dev, counters)
    log(dict(phase="sla", seconds=time.perf_counter() - t0))
    run_spill_phases(torch, dev, counters, paged + [norms.layer_norm, qm.quantized_matmul])
    t0 = time.perf_counter()
    phase_serve(torch, dev, paged + [norms.layer_norm], "bloom_7b1_alibi_4l")
    phase_serve(torch, dev, counters, "mistral_7b_swa_4l")
    log(dict(phase="serve alibi and window", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    serve_moe = phase_serve(torch, dev, counters + [mg.moe_grouped_gemm], "mixtral_8x7b_8l", profile)
    log(dict(phase="serve moe", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    serve_w8 = phase_serve(torch, dev, paged + [norms.layer_norm, qm.quantized_matmul], "gpt2_1_3b_w8_kv8", profile)
    serve_w4 = phase_serve(torch, dev, paged + [norms.rms_norm, qm.quantized_matmul], "llama3_8b_w4", profile)
    log(dict(phase="serve quantised", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    serve_hf = phase_serve_hf(torch, dev, hf_counters(pa, norms), fa.flash_fwd, keep=HF_TRAIN_RUNS)
    log(dict(phase="serve_hf", seconds=time.perf_counter() - t0))
    train_counters = [fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, fad.fused_adam]
    t0 = time.perf_counter()
    hf_dirs = {run: serve_hf[run].pop("dir") for run in HF_TRAIN_RUNS}
    try:
        train_hf = phase_train_hf(torch, dev, train_counters, hf_dirs, profile)
    finally:
        for d in hf_dirs.values():
            shutil.rmtree(d, ignore_errors=True)
    log(dict(phase="train_hf", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        phase_train_parity(torch, dev, dtype, train_counters)
    train = phase_train(torch, dev, counters + train_counters, profile)
    log(dict(phase="train", seconds=time.perf_counter() - t0))
    if PARENT["lib"] is not None:  # the same paths on the parent's kernels, for comparison only
        log(dict(phase="parent kernels", begin=True))
        with parent_kernels():
            phase_serve(torch, dev, counters, "llama3_8b", profile)
            phase_serve(torch, dev, paged + [norms.layer_norm, qm.quantized_matmul], "gpt2_1_3b_w8_kv8", profile)
            phase_serve(torch, dev, paged + [norms.rms_norm, qm.quantized_matmul], "llama3_8b_w4", profile)
            phase_serve(torch, dev, counters + [mg.moe_grouped_gemm], "mixtral_8x7b_8l", profile)
            phase_train(torch, dev, counters + train_counters, profile)
        log(dict(phase="parent kernels", begin=False))
    t0 = time.perf_counter()
    evoformer = phase_evoformer(torch, dev, [fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dq_collapsed,
                                             fa.flash_bwd_dkv], profile)
    log(dict(phase="evoformer", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    sparse = phase_sparse(torch, dev, [ss.sparse_fwd, ss.sparse_bwd_dq, ss.sparse_bwd_dkv])
    log(dict(phase="sparse", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    v1 = phase_v1(torch, dev, [tq.quantize_groupwise, tq.dequantize_groupwise], profile)
    log(dict(phase="v1", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    lamb_counters = [fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, tfl.lamb_direction]
    for dtype in (torch.float32, torch.bfloat16):
        phase_train_parity(torch, dev, dtype, lamb_counters, optimizer="Lamb")
    train_lamb = phase_train(torch, dev, lamb_counters, profile, optimizer="Lamb")
    log(dict(phase="train lamb", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    zero_runs = phase_train_zero(torch, dev, lamb_counters + [fad.fused_adam],
                                 want={"FusedAdam": train["losses"], "Lamb": train_lamb["losses"]})
    log(dict(phase="train_zero", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    phase_ckpt(torch, dev, train_counters)
    log(dict(phase="ckpt", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    host = phase_host_optim(torch)
    log(dict(phase="host_optim", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    offload = phase_train_offload(torch, dev, train_counters, zero_runs)
    log(dict(phase="train_offload", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    phase_offload_nvme(torch, dev, train_counters)
    log(dict(phase="offload_nvme", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    phase_train_zeropp(torch, dev, train_counters)
    log(dict(phase="train_zeropp", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    train_moe = phase_train_moe(torch, dev, train_counters)
    log(dict(phase="train_moe", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    serve_tp = phase_serve_tp(torch, dev)
    log(dict(phase="serve_tp", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    train_pipe = phase_train_pipe(torch, dev, card, want=train["losses"])
    log(dict(phase="train_pipe", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    train_seq = phase_train_seq(torch, dev, card)
    log(dict(phase="train_seq", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    train_tp = phase_train_tp(torch, dev, card, want=train["losses"])
    log(dict(phase="train_tp", seconds=time.perf_counter() - t0))

    runs = {"llama3_8b": serve, "gpt2_1_3b_w8_kv8": serve_w8, "llama3_8b_w4": serve_w4,
            "mixtral_8x7b_8l": serve_moe, "train": train, "train_seq": train_seq,
            "evoformer": evoformer, "sparse": sparse, "train_lamb": train_lamb, **v1,
            **{f"train_hf_{run}": train_hf[run] for run in HF_TRAIN_RUNS},
            **{f"train_hf_fp32_{run}": train_hf[run]["fp32"] for run in HF_TRAIN_RUNS}}
    kernels = [kernel_row(records + quant_records, runs, *row) for row in KERNEL_ROWS]
    for row in kernels:  # the kernels MoE training runs: their launches over its 6 steps at stage 0
        if row["name"] in train_moe["stage0"]["launches"]:
            row["train_moe_launches"] = train_moe["stage0"]["launches"][row["name"]]
    for row, spec in zip(kernels, KERNEL_ROWS):  # tensor-parallel serving's launches (bf16 pools, int8 codes)
        if spec[2] in serve_tp["launches"] and "int8 pool" not in row["name"] and "int4" not in row["name"]:
            row["serve_tp_launches"] = serve_tp["launches"][spec[2]]
    for row, spec in zip(kernels, KERNEL_ROWS):  # the pipeline's (both stages) and Ulysses' (a rank) launches
        if spec[1] == "train" and spec[2] in train_pipe["launches"]:
            row["train_pipe_launches"] = train_pipe["launches"][spec[2]]
        if spec[1] in ("train", "train_seq") and spec[2] in train_seq["launches"]:
            row["train_seq_launches"] = train_seq["launches"][spec[2]]
    for row, spec in zip(kernels, KERNEL_ROWS):  # tensor parallelism's (rank 0's): (b), and LAMB's from (a)
        if spec[1] == "train" and spec[2] in train_tp["launches"]:
            row["train_tp_launches"] = train_tp["launches"][spec[2]]
        if spec[1] == "train_lamb" and spec[2] in train_tp["lamb_launches"]:
            row["train_tp_launches"] = train_tp["lamb_launches"][spec[2]]
    for row, spec in zip(kernels, KERNEL_ROWS):  # the Hugging Face checkpoints' launches, run by run
        hf = {run: rec["launches"][spec[2]] for run, rec in serve_hf.items() if spec[2] in rec["launches"]}
        if hf and "int8 pool" not in row["name"]:
            row["serve_hf_launches"] = hf
    log({"hf_kernel_shapes": [{k: r.get(k) for k in ("kernel", "hf_shape", "dtype", "pool", "shape", "features",
                                                    "kernel_ms", "kernel_cold_ms", "bound_ms", "bound_by", "library_ms",
                                                    "library_cold_ms", "plain_ms", "max_rel_err")}
                              for r in records if r.get("hf_shape")]})
    log(dict(phase="done", seconds=time.perf_counter() - t_start, card=card))
    log({"host_code": host_code_rows(host, offload)})
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
