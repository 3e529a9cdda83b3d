#!/usr/bin/env python3
"""Drive the PyTorch port of QuantumFed on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-quantum [--src DIR]
    python3 chip_smoke.py --time-seq [--src DIR]
    python3 chip_smoke.py --time-serve
    python3 chip_smoke.py --train-probe
    python3 chip_smoke.py --nan-check [--src DIR]

Runs on cuda:0 only; without a CUDA device, or outside a checkout of the
repository, it exits non-zero before printing any result. Phases:

1. build: compile the port's CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (nvcc, sm_90a) and print the card, its power limit and the
   toolchain versions;
2. kernels: record the inputs the main path hands each kernel (one probe
   round of phase 3's configuration), then hold every kernel against its
   plain PyTorch version on those inputs and on ragged shapes (the trace
   twice, bit for bit), and time kernel, plain version and (where one
   PyTorch call computes the same function) that library call with CUDA
   events, and the kernel's device time per launch with torch.profiler;
   fidelity and mse also beside the launch floor (a one-element PyTorch
   op, back to back, and its device time);
3. main path: the paper's experiment through the port's
   ``FederationSession`` (examples/torch_quickstart.py's spec): widths
   (2,3,2), N=100, N_p=10, I_l=2, eta=1, eps=0.1, Eq. 6 product,
   impl="pallas", the data from the spec's recipe on the card, 50 rounds
   with ``EvalEvery(10)``. The launch counts are zeroed just before and
   read just after; every kernel must have run, and the final test
   fidelity must exceed 0.95. Then ms/round through the session beside
   the bare ``server_round`` loop from the same params and round keys
   (which must end on the same params bit for bit): the session's
   overhead;
4. wide cell: widths (4,5,4), N=20, N_p=10, I_l=2: one round with the
   kernels (launches counted) against one in complex128 PyTorch from the
   same params and selection, the kernels checked and timed as in phase 2
   at every shape of that round (zgemm's and the trace's rows join the
   result), then ms/round of both impls for both cells, and a profiler
   breakdown of one kernel round of each cell with the trace kernels'
   device time;
5. serving: RecurrentGemma-2B at full width (26 layers, d_model 2560,
   bf16, random weights from a seed) prefills B=4 prompts of S=4096
   tokens through ``make_prefill_step`` (launch counts zeroed before,
   read after: 8 flash_attention, 18 rglru_scan), moves the cache into a
   4096+32 decode cache and greedy-decodes 32 tokens through
   ``make_serve_step``. The same prefill through the plain versions
   (``impl="xla"``) must agree with it within the bf16 budget (the plain
   bf16 prefill's deviation from the plain fp32 one, measured in the
   run), the fp32 prefill through the kernels within the plain fp32
   prefill's deviation when every weight moves one ulp, and the first
   decode step with a prefill of S+1 tokens. Each sequence kernel is
   held against its plain version on the path's inputs and on ragged
   shapes, then timed, with the device time per launch from the
   profiler (attention also element by element, with the design its
   machine code shows, the rows more than one bf16 ulp off the plain
   version recomputed in fp64 and in the kernel's order of arithmetic,
   and the fp32-storage kernel: its design (3xTF32 on the tensor cores)
   a gate, within KERNEL_RTOL of the plain fp32 version on unit-scale
   inputs of the path's shape, within ``fp32_fn_bound`` of the fp64
   function element by element on the path's inputs, timed); then
   profiler breakdowns of one
   prefill and one decode step, and ``python -m repro_torch.launch.serve``
   as a smoke;
6. RWKV6 serving: RWKV6-7B at full width (32 layers, d_model 4096, 64
   heads of 64, bf16, 7,576,752,128 params) with the reference init's
   zero decay, bonus and mixing tensors redrawn from a seed, the same
   steps as phase 5: one prefill of B=4 x S=4096 with exactly 32
   gla_chunked launches (w handed over in fp32), the same budgets, 32
   decode tokens, the first of them against a prefill of S+1 tokens
   (the kernel at chunk 1), the kernel against its plain version on the
   path's inputs and ragged shapes, and timed at both prefills' shapes
   (chunk 16 and, for the S+1 prefill, chunk 1), profiles and the serve
   CLI;
7. engines: at BENCH_engine.json's widths (2,3,2), (3,4,3), (4,5,4) and
   (3,3,3,3) (4 nodes, 2 a round, I_l = 2, 4 pairs a node), one round of
   each engine (local, local_opb, dense) and impl from the same params:
   the complex128 engines within 1e-10 of the dense oracle, the kernel
   rounds within 1e-5, every kernel shape of those rounds against its
   plain version, then ms/round of each; one local_opb round of phase
   4's (4,5,4) cell with the kernels (launch counts zeroed before, read
   after; zgemm at the av^H B_j shapes (40,1|16,512) x (40,512,512), 18
   launches), its zgemm shapes checked and timed into the result, and
   the operands ``ops._dense`` copied counted; the certified
   approximate-rank cells (BENCH_engine.json's APPROX_SETS) through
   ``server_round_certified`` under both impls, each certificate at or
   above the deviation of the approximate K's from the exact engine's
   on the round's node batch, with approximate and exact ms/round;
8. fed core: benchmarks/bench_robust.py's grid (widths (2,3,2), N=20,
   N_p=10, I_l=2, 60 rounds a cell) of six strategies (undefended average
   and product, clip, trimmed_mean, median, the screened product) under
   three attacks (clean, 20% persistent sign-flip at scale 5 with the
   bench's scanned seed, 30% crash), each cell a ``FederationSession``
   whose sync scheduler applies the faults (``_robust_step``), the
   bench's two gates, and one round of 30% corrupt uploads (undefended
   NaN, defended finite); on phase 3's cell one round of Hermitian upload noise
   and of 8-bit quantisation and 3 of server momentum and Nesterov, each
   against its complex128 round; the weighted and dropout schedules and
   the sampled draw at N = 1,000,000 (ms per draw, dense and Floyd); the
   stacked round of 300 bench_serve.py SPEC_A slots with and without
   momentum, under both impls, against solo rounds, with the launches of
   one round, ms against 30 solo rounds scaled to 300, and peak memory;
   the kernels at the shapes of one screened round and one stacked round
   (their rows in the result, ``"cell"`` set);
9. the federation API on the card: kill-and-resume of a 4-round session
   cut after 2 rounds (saved, resumed) against the straight run, bit for
   bit, under sync, overlapped and async (cut mid-buffer); the (4,5,4)
   N=20 cell, 10 rounds through the session under both impls beside the
   bare loop; 10 commits each of the async and overlapped schedulers on
   phase 3's cell (ms/commit, the simulated clock); and faulted sync
   runs (phase 8's crash and Byzantine fault models, a round deadline
   that forces retries) through ``SyncScheduler._robust_step``, with
   their survivors and retries;
10. cohorts and serving: the paper's figure experiments through the
   session (examples/torch_fig2_interval.py's four interval runs at 50
   rounds, each above 0.95 test fidelity; torch_fig2_wider.py's three
   widths at 40; torch_fig3_noise.py's five noise ratios at 50, clean
   test fidelity), launch counts zeroed before and read after each run;
   bench_cohort.py's hierarchy cell ((2,3,2), N_p = 64 of 128 nodes, 8
   pods): one round two-level against flat for both combines and strided
   pods (1e-10 in complex128, ROUND_TOL with the kernels), zgemm at the
   pod tier's and the merge's shapes into the result, ms/round flat and
   two-level under both impls in turns; its cohort sweep (1k to 1M
   nodes, N_p = 8; ms/round within 2x); bench_serve.py's cells at 100
   and 1000 tenants through ``FederationServer`` (300 slots, 5 rounds a
   tick, stacked against solo seconds, the sampled tenants against their
   solo runs, a replay bit for bit), served == solo in complex128, a
   tick's launches against k stacked rounds', park -> evict -> revive
   bit-exact, a NaN-poisoned tenant quarantined alone, and a profile of
   one 300-slot tick beside its generators' host time;
11. training: RecurrentGemma-2B at full width and depth (26 layers, bf16
   params, remat, random init from seed 0) trained by
   ``make_train_step`` for 5 steps on one repeated B=1 x S=4096 batch of
   the Bigram stream (seed 0) with launch/train.py's optimizer (AdamW,
   fp32 moments, the global norm clipped to 1) and schedule at --lr 1e-2
   --warmup 0: the loss finite at every step and lower at step 5 than
   at step 1, each step's launches counted (zeroed before, read after)
   and gated exactly (16 flash_attention, 8 flash_attention_bwd, 52
   rglru_scan: the 16 remat-cycle recurrent layers forward, recompute
   and reverse, the 2 remainder layers forward and reverse), the
   reverse scans of step 1 counted apart inside the scan's adjoint and
   gated (18), ms/step, tokens/s, peak memory and a profile's busy
   share. Before it, one cycle (3 layers, full width)
   backpropagated through the kernels must give every parameter's
   gradient close to the plain route's: in bf16 at the init within the
   bf16 budget (the plain bf16 gradients' deviation from the plain fp32
   ones), in fp32 storage with the stacked matrices at std
   1/sqrt(d_in) within 1e-3 of each gradient's scale (each leaf
   printed); a planted fault in the attention backward (dK = 0) and in
   the scan's adjoint (da = 0) must each fail the fp32 gate. After it,
   the bf16 backward's design read from its machine code (wgmma, a
   gate), the forward's log-sum-exp at the path's inputs against the
   plain one (both storage types), the attention backward kernel at the
   path's recorded inputs (bf16: within the bf16 budget of the plain
   fp32 version; fp32 storage: within ``fp32_fn_bound`` of the same
   gradients in fp64 element by element, and on unit-scale inputs of the
   path's shape within 1e-4 of each gradient's scale of the plain
   version) and on ragged shapes, the same bits on repeat, timed beside
   its plain
   version and SDPA's backward (each pass's device time, TFLOP/s on the
   five products), the fp32-storage backward (its design a gate, its
   splits of the group printed) beside fp32 SDPA's; the
   scan's reverse use against autograd of the plain scan (1e-5), timed;
11b. RWKV6 training: RWKV6-7B at its published width (d_model 4096, 64
   heads of 64, d_ff 14336, vocab 65536) with its depth cut from 32 to
   16 layers (at 12 bytes a parameter the full model needs ~91 GB),
   bf16 params, fp32 AdamW moments, remat, the zero decay, bonus and
   mixing tensors redrawn (seed 1), trained as phase 11 (5 steps, B=1 x
   S=4096, clip 1) at lr 1e-3: the loss finite and falling, the counted
   peak and the measured one under 70 GiB, each step's launches gated
   exactly (32 gla_chunked: the forward and the remat recompute; 16
   gla_chunked_bwd), ms/step, tokens/s and a profile's busy share.
   Before it, one layer at full width in fp32 (std 1/sqrt(d_in), the
   decays redrawn) backpropagated through both GLA kernels must give
   every parameter's gradient within 1e-3 of the plain route's (each
   printed), and two planted faults must fail that gate: the carried dS
   dropped every 16 tokens, and dw = 0. After it, the GLA backward
   kernel at the step's recorded inputs and on ragged shapes (chunks 1,
   16, 48, 128, S = 17, 33, 4097 and the stages' cut points 65 and 129,
   B up to 3, dh 5 to 64, w at the clip's ends and in bf16, with and
   without a dstate) against its plain version (fp32 1e-5, bf16 one ulp
   of each gradient's scale), bit for bit on repeat, and where S <= 128
   in fp32 against the fp64 function (1e-6); timed beside its plain
   version and the forward kernel, with its device time, its bound and
   its checkpoints' bytes (the path's operands must take its TMA
   copies), and the step profile's device time of its three kernels;
   then ``python -m repro_torch.launch.train --arch
   rwkv6-7b --scale smoke`` on the card (6 steps, launches counted);
12. the classical federation: (a) Qwen1.5-4B at its published width
   (d_model 2560, 20 heads of 128, MHA, d_ff 6912, vocab 151936, qkv
   biases, bf16 params, fp32 AdamW moments, remat) with its depth cut
   from 40 to 8 layers (the selected nodes' fp32 moments and deltas
   must fit), random init from seed 0, through ``ClassicalSubstrate``
   and a ``FederationSession``: N=4, N_p=2, I_l=2, local steps of B=2 x
   S=4096, lr 3e-3, 3 rounds; each round's launches counted (zeroed
   before, read after) and gated exactly (64 flash_attention, 32
   flash_attention_bwd), the eval loss finite and lower after round 3
   than at round 0, ms/round (CUDA events, rounds 2-3), tokens/s, peak
   memory beside the counted one, a profile of a fourth round; then
   the attention kernels at the path's recorded inputs (MHA, dh 128,
   causal): the forward's LSE, the backward within the bf16 budget,
   the forward as in phase 5 (with its fp32-storage row), each timed
   beside its plain version, SDPA and its bound. (b) at the
   reference's test sizes (fp32): one round of reduced Qwen1.5-4B (1
   layer) and of reduced RecurrentGemma-2B through the kernels against
   the plain route under SGD (the aggregated delta within 1e-3 of its
   scale, launches exact, every recorded kernel call against its plain
   version), the same for reduced RWKV6-7B (2 layers, its decays
   redrawn) through both GLA kernels, kill-and-resume 2 + 2 rounds
   against 4 bit for bit, and ``python -m repro_torch.launch.fed_train
   --arch qwen1.5-4b --rounds 2`` and its round lines;
13. the model zoo: the seven architectures of the moe kind, M-RoPE,
   cross-attention and embedding inputs (ZOO: llama4-scout, arctic,
   gemma3, command-r, llama3, qwen2-vl, musicgen) at their published
   widths, random init from seed 0, bf16, depth cut to whole pattern
   cycles so that the fp32 copy for the budget fits (each cut printed
   with its reason), each in turn with one copy of its weights on the
   card: a B=4 x S=4096 prefill through the attention kernel (launch
   counts zeroed before, read after: one a layer, two with
   cross-attention; the attention calls recorded in that run, their
   counts by shape summing to the launches), 32 greedy decode tokens
   (embedding-input archs through the frontend stub, M-RoPE positions
   and the cached conditioning from the forward), the plain bf16
   prefill and the first decode step against a prefill of S+1
   positions; then the same weights at ``condition_``'s scale (the
   reference init's scores reach the tens of thousands and its deep
   stacks are chaotic, so its budgets separate nothing), where the
   kernel and plain bf16 prefills, routed alike (``PinnedRouting``),
   and the first decode step are held again; then, the bf16 weights
   freed, their fp32 copy (``zoo_fp32_gates``): the bf16 budgets at
   both weights (plain bf16 vs plain fp32), and at ``condition_``'s
   weights the fp32 kernel prefill within ZOO_FP32_RTOL of the plain
   one, beside a control that must fail that gate (the attention's q, k
   and v rounded to TF32). An MoE arch's S+1 prefill is routed as the
   prompt's prefill and the decode step were, and where either prefill
   drops an expert assignment (capacity depends on the token count) its
   decode is checked for finite logits only, as printed. Peak memory <=
   70 GiB; the attention kernel at each of the prefill's shapes against
   its plain version (and the fp32 kernel there on unit-scale inputs
   within KERNEL_RTOL), timed beside it and SDPA with its bound; ragged
   zoo shapes (G = 5, 7, 2 with window 1024, 8, 16, 1 at dh 64; not
   causal with Sk = 256 and 200); prefill ms, decode ms/token, peak GiB
   and seconds an arch;
14. continuous batching: (a) Qwen1.5-4B (40 layers) and RecurrentGemma-2B
   (26) at published width and depth, bf16, seed-0 weights at
   ``condition_``'s scale, through ``serving.ContinuousBatcher``: 4 slots,
   max_len 256, 6 requests (prompt lengths 8-32 and budgets 4-12 from a
   seed; request 2's eos_id the third token of its solo run, so it ends
   early; six through four slots, so slots are reused; the slot holders
   printed by tick; the kernel launches of the batched run counted: decode
   runs none). Gates: each request's tokens and per-step logits equal,
   bit for bit, its run alone through a 4-slot batcher (else within
   BF16_RTOL of the scale, the deviation printed); each request's logits
   within BATCH_BF16_FACTOR x its bf16 budget of its B = 1 bf16 decode of
   the same tokens (the budget: that decode against the B = 1 fp32 one);
   and a control that must fail each: RecurrentGemma's idle slots not
   frozen (the first gate), Qwen's slots all decoding at one shared
   position, the int path at max(cur) (the second). Reports ticks,
   ms/tick, ms a slot step by active slots (CUDA events) beside phase 5's
   decode ms/token, generated tokens/s over ``run_until_drained``, a
   profiled 4-slot tick's busy share, peak GiB and seconds. (b) the
   system loop: ``launch/train.py --scale smoke`` recurrentgemma-2b on the
   card, ``--steps 4 --ckpt A``, then ``--restore A --steps 6 --ckpt B``
   (checkpoints under the gitignored ``build/``), each run's
   flash_attention, flash_attention_bwd and rglru_scan launches counted
   (zeroed before, read after; each must be non-zero), A and B read back
   bit for bit as the params the trainer held, and the batcher on the
   restored B giving the tokens and logits, bit for bit, of the batcher on
   the params in memory;
15. the mesh and the roofline: (a) phase 3's round with
   fanout="shard_map" on the NCCL host mesh (world 1, a 'pod' axis),
   flat and two_level, equal to the batched round bit for bit, through
   all four quantum kernels (counts zeroed before, read after), ms/round
   of both in turns, and the host time of one NCCL gather; (b)
   ``launch.dryrun_fed`` on the (pod 2, data 16, model 16) mesh of
   torch's fake backend at phase 12a's Qwen1.5-4B shape, I_l = 1, 4, 1
   (the first cold): pod 0's node trains for real through the attention
   kernels (launches gated), the cross-pod bytes a round equal, a
   quarter a local step at I_l = 4; (c) the roofline of phase 5's
   prefill from ``roofline.trace_parse`` and ``roofline.analysis``:
   device time by family, busy share, the ATen dot FLOPs and the
   kernels' FLOPs and bytes, the compute and memory terms and their
   shares of the prefill's time, beside the card's name and power limit;
   (d) the sharded model step: on the NCCL host mesh (world 1, ('data',
   'model')) one train step of phase 11's RecurrentGemma-2B and of phase
   11b's RWKV6-7B with DTensor params, moments and batch, through the
   kernels, against the plain-tensor step from the same init and batch:
   the loss and every param after AdamW the same bits, the launches
   exact (16/8/52 and 32/16), ms/step and busy share of both; the bf16
   and the fp32 attention kernels with a query offset of S/2 on rows
   [S/2, S) at phase 5's and 12a's shapes: forward, LSE and dq the full
   call's rows bit for bit, dk and dv within the backward's budget of
   the plain version with the same offset, a planted offset of 0 failing
   the forward gate, the kernel's ms beside the full call's and SDPA's
   in the same dtype (a forward and a backward row in the result for
   each dtype and shape); the
   ``FakeTensorMode`` trace of RecurrentGemma-2B's world-1 step
   (``roofline.step_trace``), its peak within 10% of
   ``torch.cuda.max_memory_allocated`` of the real step; the decode on
   the mesh (weight-stationary under the rule overrides, the softmax
   over the cache's sequence shards): phase 5's prefill (launches 8 and
   18 on each side) and 32 greedy tokens of RecurrentGemma-2B with the
   params and the cache as DTensors against the same with plain tensors,
   every token, every step's logits and every cache entry the same bits,
   ms/token and a step's busy share of both; phase 14's
   RecurrentGemma-2B batcher (4 slots, its first three requests) with
   DTensor params, each request's tokens phase 14's, ms/tick and
   tokens/s beside the plain batcher's; and, in processes of their own
   started first, ``launch.dryrun`` of RecurrentGemma-2B's train_4k and
   decode_32k on the 2x16x16 fake mesh through the trace (temporaries,
   peak, collective bytes by axis and op, the largest collective, dot
   FLOPs by ATen op and shape, seconds), beside the same traces' counts
   on a CPU host (torch 2.13.0+cpu): train_4k's dot FLOPs within 1% of
   the CPU host's and 2% of the hand count, its 'model' bytes within 10%
   of the hand count (``TRAIN_HAND``).

Phase 5's fp32-storage attention row also plants NaNs (``nan_rows_check``:
torch's 0x7fc00000, the card's 0x7fffffff and 0xffffffff) in q, k and v
for the forward and in q, k, v and dO for the backward: every row a NaN
reaches by the attention's data flow must be NaN in the kernels' outputs,
and no row the plain version keeps finite.

The second-to-last line is a JSON object with one entry per kernel and
shape: each kernel at the main path's most frequent shape (launches of
phase 3, or of one prefill), then zgemm and the trace at each shape of
the (4,5,4) round (launches in one round, ``"cell"`` set),
gla_chunked at chunk 1 in the S+1 prefill (``"cell"`` set), zgemm at
each shape of phase 7's (4,5,4) local_opb round, and zgemm, the trace and
fidelity at each shape of phase 8's screened and stacked rounds (``"cell"``
set), the fp32-storage attention at the prefill's shape (``"cell"``
set; launches of phase 5's fp32 kernel prefill), and zgemm at the
two-level tree's pod-tier and merge shapes (``"cell"`` set), and
the attention backward (bf16, and fp32 storage: launches of the
one-cycle gate's fp32 kernel pass) and the scan's reverse use at the
train step's shapes (launches a step, ``"cell"`` set), the GLA backward
at phase 11b's train step (launches a step, ``"cell"`` set; it replaces
no TPU kernel: XLA differentiated the reference's plain chunked form),
and the attention
forward (bf16, and fp32 storage: not launched there) and backward at
phase 12a's Qwen1.5-4B shape (launches a federated round, ``"cell"``
set), and the attention forward at each shape of phase 13's prefills
(launches of that shape a prefill, ``"cell"`` set), and the bf16
and fp32 attention's query-offset forward and backward rows of phase
15(d) (each launches one offset call of its own kernel in that check,
``"cell"`` set; the world-1 path has no context parallelism); every row
but the 15(d) forward rows carries ``device_us``, and fidelity's and
mse's the launch floor.
The last line is ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits non-zero and never prints that line.

``--time-quantum`` runs none of that: it times the quantum path of the
checkout whose ``src`` is DIR (this one by default) and prints one JSON
line (see ``time_quantum``), so that two checkouts can be compared on
one card, in turns, each in its own process. ``--time-seq`` does the
same for gla_chunked (chunk 16 and chunk 1) and rglru_scan at the
prefills' shapes, for the fp32-storage attention forward (the
RecurrentGemma-2B prefill's shape) and backward (phase 11's) and for the
GLA backward (phase 11b's) (see ``time_seq``). ``--time-serve`` builds the kernels
and runs bench_serve.py's 10,000-tenant cell alone (see ``time_serve``).
``--nan-check`` runs ``nan_rows_check`` alone at phase 5's fp32
attention shape on seeded unit-scale inputs for the port under ``--src``
(see ``nan_check``). ``--train-probe`` builds the kernels and runs
phase 11's model and batch at other learning rates and clips, without
gates (see
``train_probe``). ``--time-attn-bwd`` builds the kernels and times the
bf16 attention backward alone at phase 11's shape under several splits
of the query heads, with its host and per-pass device time (see
``time_attn_bwd``).
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the port that runs: this checkout's, or another's under --src
SRC = (Path(sys.argv[sys.argv.index("--src") + 1]).resolve()
       if "--src" in sys.argv[:-1] else ROOT / "src")
sys.path.insert(0, str(SRC))

# the H100's peaks and each kernel's operations, bytes and least time
# (bound_ms, seq_bound_ms, ...) live in the package, beside the roofline
# tooling that reads them too
from repro_torch.roofline.costs import (  # noqa: E402
    FP32_FLOPS, allowed_pairs, attn_bwd_bound_ms, bound_ms, gla_bwd_bound_ms,
    gla_bwd_bytes, seq_bound_ms)

# Kernels compute in fp32 on complex128 storage. Their sums run in
# another order than the plain versions', so each is held to 1e-5 times
# the scale of the plain result: fp32 keeps ~7 digits, and the longest
# reduction (K = 512 terms of the wide cell's trace) costs about two.
KERNEL_RTOL = 1e-5
# Deviation of one round with the kernels from one in complex128, both
# from the same params and selection. The kernels' fp32 rounding enters
# K at ~1e-6 of its scale; eps * 2^m_in * that is far below 1e-5 at the
# widths here, the same budget the reference's own round gate uses.
ROUND_TOL = 1e-5
MAIN_FIDELITY = 0.95
# bf16 outputs of a sequence kernel and of its plain version are both one
# rounding of nearly the same fp32 value, so they differ by at most one
# bf16 ulp: 2^-7 of the value at worst (8 significand bits).
BF16_RTOL = 2.0 ** -7
# SDPA as a yardstick computes the same attention in its own bf16 way;
# it is checked against the plain version first, at the reference's own
# bf16 gate (tests/test_kernels.py), relative to the output's scale.
YARDSTICK_RTOL = 2e-2
SERVE_B, SERVE_S, SERVE_GEN = 4, 4096, 32

KERNELS = {
    "zgemm": dict(
        source="src/repro_torch/kernels/csrc/zgemm.cu",
        replaces="src/repro/kernels/zgemm.py:52"),
    "ensemble_commutator_trace": dict(
        source="src/repro_torch/kernels/csrc/ect.cu",
        replaces="src/repro/kernels/zgemm.py:166"),
    "fidelity": dict(
        source="src/repro_torch/kernels/csrc/fidelity.cu",
        replaces="src/repro/kernels/fidelity.py:75"),
    "mse": dict(
        source="src/repro_torch/kernels/csrc/fidelity.cu",
        replaces="src/repro/kernels/fidelity.py:81"),
}
SEQ_KERNELS = {
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        replaces="src/repro/kernels/flash_attention.py:82"),
    "rglru_scan": dict(
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:48"),
    "gla_chunked": dict(
        source="src/repro_torch/kernels/csrc/gla_chunked.cu",
        replaces="src/repro/kernels/gla_chunked.py:73"),
}

def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def say(*parts):
    print(*parts, flush=True)


# ----------------------------------------------------------------- timing
def cuda_ms(fn, *args, reps=100, warmup=10):
    import torch
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ----------------------------------------------------------------- phases
def phase_build():
    import torch
    from repro_torch.kernels import build
    say("== phase 1: build")
    t0 = time.time()
    lib = build.build()
    say(f"built {lib.relative_to(ROOT)} in {time.time() - t0:.1f} s")
    log = lib.with_suffix(".log").read_text().splitlines()
    for line in log:
        if line.startswith("==") or "registers" in line or "spill" in line:
            say("  " + line.strip())
    build.load()
    nvcc_v = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                            text=True, check=True, timeout=60).stdout
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc "
        f"{nvcc_v.strip().splitlines()[-1]}")
    say(f"card: {smi('name,power.limit')}")
    torch.backends.cuda.matmul.allow_tf32 = False   # full fp32 plain GEMMs
    torch.backends.cudnn.allow_tf32 = False


def layout(x):
    """"dense", or what the kernel's wrapper would refuse in ``x`` as it
    is: a strided layout, a lazy conjugate or negative bit."""
    tags = [tag for tag, on in (("strided", not x.is_contiguous()),
                                ("conj", x.is_conj()), ("neg", x.is_neg()))
            if on]
    return "+".join(tags) or "dense"


class Recorder:
    """Wraps ``ops`` dispatch functions to keep the first inputs of every
    distinct shape (and keyword set, and layout where an operand is not
    dense) the main path hands each kernel."""
    NAMES = {"complex_matmul": "zgemm", "fidelity": "fidelity",
             "mse": "mse",
             "ensemble_commutator_trace": "ensemble_commutator_trace"}

    def __init__(self, names=None, observe=None):
        from repro_torch.kernels import ops
        self.ops = ops
        self.names = names or self.NAMES
        self.observe = observe      # called as observe(kernel, args, kw)
        self.calls = {k: {} for k in self.names.values()}
        self.saved = {}

    def __enter__(self):
        for fn, kernel in self.names.items():
            orig = getattr(self.ops, fn)
            self.saved[fn] = orig

            def wrapped(*args, _orig=orig, _k=kernel, **kw):
                key = (tuple(tuple(a.shape) for a in args)
                       + tuple(sorted(kw.items())))
                lay = tuple(layout(a) for a in args)
                if any(t != "dense" for t in lay):
                    key += (("layout", lay),)
                # the tensors themselves, lazy conjugate views included
                seen = self.calls[_k].setdefault(
                    key, [0, tuple(a.detach() for a in args), kw])
                seen[0] += 1
                if self.observe is not None:
                    self.observe(_k, args, kw)
                return _orig(*args, **kw)
            setattr(self.ops, fn, wrapped)
        return self

    def __exit__(self, *exc):
        for fn, orig in self.saved.items():
            setattr(self.ops, fn, orig)


def main_cell(widths=(2, 3, 2), num_nodes=100, impl="pallas", device="cuda"):
    """The quickstart experiment's config, data and initial params."""
    import torch
    from repro_torch.core.quantum import data as qdata
    from repro_torch.core.quantum import federated as fed
    from repro_torch.core.quantum import qnn
    cfg = fed.QuantumFedConfig(widths=widths, num_nodes=num_nodes,
                               nodes_per_round=10, interval_length=2,
                               eta=1.0, eps=0.1, aggregation="product",
                               impl=impl)
    gen = torch.Generator(device="cpu").manual_seed(42)
    _, ds, test = qdata.make_federated_dataset(
        gen, widths[0], num_nodes, n_per_node=4, n_test=32, device=device)
    params = qnn.init_params(torch.Generator().manual_seed(7), widths,
                             device=device)
    return cfg, ds, test, params


def ragged_cases():
    """Edge shapes the kernels mask rather than pad, seeded."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(3)

    def rc(*shape):
        re = torch.randn(shape, generator=g, dtype=torch.float64)
        im = torch.randn(shape, generator=g, dtype=torch.float64)
        return torch.complex(re, im).cuda()

    return {"zgemm": [(rc(3, 7, 9), rc(3, 9, 5)),
                      (rc(2, 33, 17), rc(2, 17, 40))],
            "fidelity": [(rc(13, 4), rc(13, 4, 4)), (rc(5, 3), rc(5, 3, 3))],
            "mse": [(rc(13, 4), rc(13, 4, 4)), (rc(5, 3), rc(5, 3, 3))],
            "ensemble_commutator_trace": [
                (rc(2, 3, 5, 4, 3), rc(2, 3, 3, 4, 3)),
                (rc(2, 2, 7, 8, 3), rc(2, 2, 7, 8, 3)),
                # rows of 19,200 bytes: one a row a tile, b in two chunks
                (rc(1, 2, 2, 8, 300), rc(1, 2, 7, 8, 300)),
                # a split into row ranges with a short last one, odd
                # dk * dr
                (rc(2, 2, 300, 5, 3), rc(2, 2, 3, 5, 3)),
                (rc(3, 2, 77, 6, 5), rc(3, 2, 9, 6, 5)),
                # b's 12 rows padded to the register tile of 8: in row
                # ranges, then in one launch over n
                (rc(70, 4, 300, 4, 3), rc(70, 4, 12, 4, 3)),
                (rc(70, 4, 20, 4, 3), rc(70, 4, 12, 4, 3))]}


def device_us(fn, args, n=5):
    """Device time per call of ``fn(*args)``, summed over every kernel it
    launches (torch.profiler over ``n`` calls after one warm-up), in
    microseconds. A profile counts only when it holds one device record
    for every launch the host made (late in a long run the profiler has
    dropped some, or all); up to four tries, then CUDA events around the
    ``n`` calls, and a line says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn(*args)
            torch.cuda.synchronize()
        events = prof.events()
        spans = [e.time_range.end - e.time_range.start for e in events
                 if e.device_type == DeviceType.CUDA]
        launches = sum(1 for e in events if e.device_type == DeviceType.CPU
                       and e.name.startswith(("cudaLaunch", "cuLaunch")))
        if spans and len(spans) == launches:
            return sum(spans) / n
    say("  (the profiler lost device records: CUDA events instead)")
    return 1e3 * cuda_ms(fn, *args, reps=n, warmup=0)


def check_and_time(rec, ragged, names=tuple(KERNELS), timed=True):
    """Hold each kernel of ``names`` against its plain version on every
    recorded input (and the ragged cases; the trace twice, bit for bit),
    then, when ``timed``, time kernel, plain version and library call at
    every recorded shape. Returns {kernel: [row per shape, most frequent
    first]}, each row with the largest error on the path's own inputs,
    and the device time per launch (profiler) of the kernel alone. Raises
    on a disagreement, or when the path never called one of ``names``."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import fidelity as kfid
    from repro_torch.kernels import zgemm as kz
    op = {"zgemm": ops.complex_matmul, "fidelity": ops.fidelity,
          "mse": ops.mse,
          "ensemble_commutator_trace": ops.ensemble_commutator_trace}
    wrapper = {"zgemm": kz.zgemm, "fidelity": kfid.fidelity_batch,
               "mse": kfid.mse_batch,
               "ensemble_commutator_trace": kz.ensemble_commutator_trace}
    plain = {"zgemm": ref.zgemm_ref, "fidelity": ref.fidelity_ref,
             "mse": ref.mse_ref,
             "ensemble_commutator_trace": ref.ensemble_commutator_trace_ref}
    # one PyTorch call computing the same function in complex64, timed as
    # a yardstick only (the port never calls it); mse has no single call.
    # The trace: T[j,al,be] = sum over n, e, f, s of
    # G[e,f] a[e,(al,s)] conj(b[f,(be,s)]), with G[e,f] = <a_e|b_f>.
    library = {
        "zgemm": torch.matmul,
        "fidelity": lambda x, r: torch.einsum(
            "na,nab,nb->n", x.conj(), r, x).real,
        "ensemble_commutator_trace": lambda a, b: torch.einsum(
            "jnekr,jnfkr,jneas,jnfbs->jab", a.conj(), b, a, b.conj()),
    }
    results = {}
    for name in names:
        calls = rec.calls[name]
        if not calls:
            raise RuntimeError(f"the path never called {name}")
        worst = 0.0
        cases = [(f"path {list(key)} x{cnt}", args)
                 for key, (cnt, args, _) in calls.items()]
        cases += [(f"ragged {[list(a.shape) for a in args]}", args)
                  for args in ragged.get(name, [])]
        for label, args in cases:
            got = op[name](*args)
            want = plain[name](*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = max(1.0, float(want.abs().max()))
            ok = err <= KERNEL_RTOL * scale
            same = ""
            if name == "ensemble_commutator_trace":
                # no atomics: the same inputs give the same bits
                again = op[name](*args)
                ok = ok and torch.equal(got, again)
                same = ", repeat bit-identical" if torch.equal(
                    got, again) else ", repeat DIFFERS"
            say(f"  {name:26s} {label}: max_abs_err {err:.3e} "
                f"(tol {KERNEL_RTOL:.0e} x scale {scale:.3g}){same} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{name} disagrees with its plain version "
                                   "or with itself")
            if label.startswith("path"):
                worst = max(worst, err)
        if not timed:
            continue
        # every recorded shape is timed, the most frequent one first (of
        # equally frequent ones, the last recorded)
        rows = results[name] = []
        for key, (cnt, args, _) in reversed(sorted(calls.items(),
                                                   key=lambda kv: kv[1][0])):
            k_ms = cuda_ms(op[name], *args)
            p_ms = cuda_ms(plain[name], *args)
            lib_ms = None
            if name in library:
                args64 = tuple(x.to(torch.complex64) for x in args)
                want = plain[name](*args)
                lib_err = float((library[name](*args64) - want).abs().max())
                if lib_err > KERNEL_RTOL * max(1.0, float(want.abs().max())):
                    raise RuntimeError(f"{name}: the library yardstick "
                                       f"disagrees ({lib_err:.3e})")
                lib_ms = cuda_ms(library[name], *args64)
            b_ms, b_by = bound_ms(name, args)
            dev_us = device_us(wrapper[name], [ops._dense(x) for x in args])
            plan = ""
            if name == "ensemble_commutator_trace":
                j, n, ea, dk, dr = args[0].shape
                parts = kz._TRACE_PARTS[(j, n, ea, args[1].shape[2], dk, dr,
                                         args[0].get_device())]
                plan = (f", {parts} partial traces a j" if parts
                        else ", one launch over n")
            say(f"  {name:26s} timed at {list(key)} x{cnt}: kernel "
                f"{k_ms:.4f} ms (device {dev_us:.2f} us a launch{plan}), "
                f"plain {p_ms:.4f} ms, library "
                f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                f"{b_ms:.6f} ms ({b_by})")
            rows.append(dict(name=name, route="cuda", **KERNELS[name],
                             shape=[list(x.shape) for x in args],
                             max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                             device_us=dev_us, calls=cnt, key=key))
            lay = [layout(x) for x in args]
            if any(t != "dense" for t in lay):
                rows[-1]["layout"] = lay
    return results


def phase_kernels():
    import torch
    from repro_torch.core.quantum import federated as fed
    say("== phase 2: kernels against their plain versions, at the inputs "
        "of one probe round + evaluation of phase 3's configuration")
    cfg, ds, test, params = main_cell()
    with Recorder() as rec:
        p = fed.server_round(params, ds, torch.Generator().manual_seed(1), cfg)
        fed.evaluate(p, *test, cfg.widths, impl=cfg.impl)
        torch.cuda.synchronize()
    # the most frequent shape of each kernel reports
    rows = {name: rows[0]
            for name, rows in check_and_time(rec, ragged_cases()).items()}
    floor_ms, floor_us = launch_floor()
    for name in ("fidelity", "mse"):
        row = rows[name]
        row.update(floor_ms=floor_ms, floor_device_us=floor_us)
        say(f"  {name}: kernel {row['ms']:.4f} ms, device "
            f"{row['device_us']:.2f} us a launch; the launch floor "
            f"{floor_ms:.4f} ms, device {floor_us:.2f} us: the kernel takes "
            f"{row['ms'] / floor_ms:.2f}x / "
            f"{row['device_us'] / floor_us:.2f}x "
            f"the floor, so it is "
            f"{'within' if row['ms'] <= 2 * floor_ms else 'NOT within'} "
            f"twice the floor's time (at least half the floor's rate)")
    return rows


def launch_floor():
    """The least a launch costs through PyTorch on this card: a one-element
    op (``add_`` on one fp64 value), back to back, by CUDA events (ms per
    call, as ``cuda_ms`` times the kernels) and its device time per launch
    by the profiler (us). The yardstick of the kernels whose work is far
    below a launch."""
    import torch
    x = torch.zeros(1, dtype=torch.float64, device="cuda")
    ms = cuda_ms(x.add_, 1.0)
    us = device_us(x.add_, [1.0])
    say(f"  launch floor: a one-element add_ takes {ms:.4f} ms a call "
        f"(CUDA events, 100 back to back), {us:.2f} us of device time")
    return ms, us


def unitarity_err(params):
    import torch
    worst = 0.0
    for u in params:
        eye = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
        worst = max(worst, float((u @ u.mH - eye).abs().max()))
    return worst


def main_spec(**overrides):
    """examples/torch_quickstart.py's spec (the paper's experiment), with
    ``overrides`` replaced."""
    import dataclasses
    quickstart = load_example("torch_quickstart")
    return dataclasses.replace(quickstart.make_spec(), **overrides)


def cuda_timed(fn):
    """(ms, result) of one call of ``fn``, CUDA events around it."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def session_vs_bare(spec, rounds, label, card):
    """ms/round of ``rounds`` sync rounds through ``FederationSession.run``
    and through the bare ``server_round`` loop from the same params and
    round keys, in turns (bare, session, session, bare, twice; CUDA
    events around each loop, after one warm-up round of each); medians
    of each side's four runs. The two loops must end on the same params,
    bit for bit. Returns (session ms, bare ms)."""
    import statistics
    import torch
    from repro_torch.core.fed import api
    from repro_torch.core.fed.api import rng
    from repro_torch.core.quantum import federated as fed
    sub = api.QuantumSubstrate(spec)
    ref = api.FederationSession.create(spec, 7, substrate=sub)
    p0 = [p.clone() for p in ref.state]
    keys = [ref.round_key(t) for t in range(rounds)]

    def session(n=rounds):
        sess = api.FederationSession.create(spec, 7, substrate=sub,
                                            params=p0)

        def run():
            sess.run(n)
            return sess.state
        return cuda_timed(run)

    def bare(n=rounds):
        def loop():
            params = p0
            for t in range(n):
                params = fed.server_round(params, sub.dataset,
                                          rng.generator(keys[t]), sub.cfg)
            return params
        return cuda_timed(loop)
    session(1)
    bare(1)
    times = {"bare": [], "session": []}
    ends = {}
    for kind in ("bare", "session", "session", "bare") * 2:
        ms, ends[kind] = (bare if kind == "bare" else session)()
        times[kind].append(ms / rounds)
    same = all(torch.equal(a, b) for a, b in zip(ends["bare"],
                                                   ends["session"]))
    s_ms = statistics.median(times["session"])
    b_ms = statistics.median(times["bare"])
    say(f"  {label} impl={spec.impl}: median {s_ms:.3f} ms/round through "
        f"the session ({', '.join(f'{t:.3f}' for t in times['session'])}) "
        f"vs {b_ms:.3f} ms/round for the bare server_round loop "
        f"({', '.join(f'{t:.3f}' for t in times['bare'])}); overhead "
        f"{s_ms - b_ms:+.3f} ms/round ({rounds} rounds a run, turns bare, "
        f"session, session, bare, twice, CUDA events, {card}); same params "
        f"bit for bit: {same}")
    if not same:
        raise RuntimeError(f"{label}: the session's sync rounds differ "
                           "from the bare round loop")
    return s_ms, b_ms


def phase_main():
    import torch
    from repro_torch.core.fed import api
    from repro_torch.kernels import build
    say("== phase 3: main path through FederationSession: "
        "examples/torch_quickstart.py's spec, widths (2,3,2), N=100, "
        "N_p=10, I_l=2, 50 rounds, EvalEvery(10), impl=pallas")
    card = smi("name,power.limit")
    spec = main_spec()
    # the data from the spec's recipe, made on the card
    sess = api.FederationSession.create(spec, 7, rounds=50)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.time()
    hist = sess.run(50, callbacks=[api.EvalEvery(10)])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(build.LAUNCHES)
    for i, it in enumerate(hist["iteration"]):
        say(f"  round {it:3d}: train fidelity {hist['train_fidelity'][i]:.6f}"
            f", test fidelity {hist['test_fidelity'][i]:.6f}, test mse "
            f"{hist['test_mse'][i]:.3e}")
    say(f"  launches in this phase: {launches}")
    say(f"  host wall {wall:.3f} s for 50 rounds + 6 evaluations through "
        f"the session")
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise RuntimeError(f"main path never launched {missing}")
    if sess.round != 50 or hist["iteration"][-1] != 50:
        raise RuntimeError(f"the session stopped at round {sess.round}")
    params = sess.state
    for p in params:
        if not bool(torch.isfinite(p.abs()).all()):
            raise RuntimeError("non-finite params after training")
    u_err = unitarity_err(params)
    say(f"  final unitarity error {u_err:.3e}")
    if u_err > 1e-4:
        raise RuntimeError("params drifted from unitary")
    te = hist["test_fidelity"][-1]
    if not te > MAIN_FIDELITY:
        raise RuntimeError(f"final test fidelity {te} <= {MAIN_FIDELITY}")
    say(f"  final test fidelity {te:.6f} > {MAIN_FIDELITY}: ok")
    session_vs_bare(spec, 50, "(2,3,2) N=100", card)
    return launches


def round_ms(cfg, ds, params, reps):
    import torch
    from repro_torch.core.quantum import federated as fed
    gen = torch.Generator().manual_seed(5)
    fed.server_round(params, ds, gen, cfg)          # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fed.server_round(params, ds, gen, cfg)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_device(label, fn):
    """Device time by kernel over one call of ``fn``
    (``roofline.trace_parse.profile``: the busy share is the union of the
    device's kernel and copy intervals over the call's wall time, both
    under the profiler), its top rows printed by ``roofline.breakdown``.
    Returns {kernel name: (device us, launches)}."""
    from repro_torch.roofline import breakdown, trace_parse
    trace = trace_parse.profile(fn)
    breakdown.show(trace, label, lambda line: say("  " + line))
    return trace.by_op


def profile_round(cfg, ds, params, label):
    """Profile one round; prints the trace kernels' device time in it
    (the partial and the reduction kernel) and their launches."""
    import torch
    from repro_torch.core.quantum import federated as fed
    gen = torch.Generator().manual_seed(6)
    fed.server_round(params, ds, gen, cfg)
    by_name = profile_device(label, lambda: fed.server_round(params, ds, gen,
                                                             cfg))
    ect = [v for k, v in by_name.items()
           if "ect_partial_kernel" in k or "ect_reduce_kernel" in k]
    ect_ms, ect_n = sum(t for t, _ in ect) / 1e3, sum(c for _, c in ect)
    say(f"    trace kernels: {ect_ms:.3f} ms device time in this round "
        f"over {ect_n} device launches")


def phase_wide():
    import torch
    from repro_torch.core.quantum import federated as fed
    from repro_torch.kernels import build
    say("== phase 4: wide cell (4,5,4), N=20, N_p=10, I_l=2")
    cfg_p, ds, test, params = main_cell(widths=(4, 5, 4), num_nodes=20)
    cfg_x = cfg_p._replace(impl="xla")
    with Recorder() as rec:
        torch.cuda.synchronize()
        build.reset_launches()
        p_k = fed.server_round(params, ds, torch.Generator().manual_seed(9),
                               cfg_p)
        torch.cuda.synchronize()
        round_launches = dict(build.LAUNCHES)
        per_shape = {name: {key: seen[0] for key, seen in calls.items()}
                     for name, calls in rec.calls.items()}
        fed.evaluate(p_k, *test, cfg_p.widths, impl=cfg_p.impl)
    say(f"  launches in one kernel round: {round_launches}")
    p_x = fed.server_round(params, ds, torch.Generator().manual_seed(9), cfg_x)
    torch.cuda.synchronize()
    dev = max(float((a - b).abs().max()) for a, b in zip(p_k, p_x))
    ok = dev <= ROUND_TOL
    say(f"  one round, kernels vs complex128: max param deviation {dev:.3e} "
        f"(tol {ROUND_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("wide cell: kernels disagree with complex128")
    say("  kernels at the wide cell's shapes:")
    timed = check_and_time(rec, {})
    # zgemm and the trace at every shape of the round join the result,
    # with their launches in one round
    rows = []
    for name in ("zgemm", "ensemble_commutator_trace"):
        if sum(per_shape[name].values()) != round_launches.get(name, 0):
            raise RuntimeError(f"{name}: the round's calls and launches "
                               "disagree")
        for row in timed[name]:
            n_round = per_shape[name].get(row["key"], 0)
            if n_round:
                rows.append(dict(row, launches=n_round, cell="(4,5,4) N=20"))
    cells = [("(2,3,2) N=100", main_cell()), ("(4,5,4) N=20",
                                              (cfg_p, ds, None, params))]
    timing = {}
    for label, (cfg, cds, _, cparams) in cells:
        for impl in ("pallas", "xla"):
            c = cfg._replace(impl=impl)
            ms = round_ms(c, cds, cparams, reps=10)
            timing[f"{label} {impl}"] = ms
            say(f"  {label} impl={impl}: {ms:.3f} ms/round (CUDA events, "
                f"10 rounds after warm-up)")
    for label, (cfg, cds, _, cparams) in cells:
        profile_round(cfg, cds, cparams, f"{label} impl=pallas")
    say(f"  card during timing: "
        f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    return rows


# ------------------------------------------------------- phase 5: serving
def gla_bwd_fp64(r, k, v, w, u, dout, dstate=None):
    """The GLA's gradients in fp64: the step recurrence (w clamped to
    1e-20 as the forward clamps it) differentiated by autograd on the
    inputs cast to fp64, for the cotangents ``dout`` of out and
    ``dstate`` of the final state. (dr, dk, dv, dw, du) in fp64; dw is 0
    where w reaches nothing (one token and no dstate)."""
    import torch
    xs = [x.detach().double().requires_grad_() for x in (r, k, v, w, u)]
    rd, kd, vd, wd, ud = xs
    b, s, h, dh = r.shape
    wc = torch.clamp_min(wd, 1e-20)
    state = torch.zeros((b, h, dh, dh), dtype=torch.float64, device=r.device)
    loss = 0.0
    for t in range(s):
        kv = kd[:, t, :, :, None] * vd[:, t, :, None, :]
        out = torch.einsum("bhc,bhce->bhe", rd[:, t], state + ud[..., None] * kv)
        loss = loss + (out * dout[:, t].double()).sum()
        state = wc[:, t, :, :, None] * state + kv
    if dstate is not None:
        loss = loss + (state * dstate.double()).sum()
    grads = torch.autograd.grad(loss, xs, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for x, g in zip(xs, grads))


def gla_bwd_dropped_carry(bwd, args, chunk, span=16):
    """A planted fault: the GLA backward with the carried dS dropped at
    every ``span``-token boundary. ``bwd(r, k, v, w, u, dout, dstate,
    chunk=...)`` runs once a span with dout zero outside it (and dstate
    only for the last); each span keeps its own tokens' gradients, du
    sums the spans' in order."""
    import torch
    r, k, v, w, u, do = args[:6]
    dstate = args[6] if len(args) > 6 else None
    s = r.shape[1]
    out = [torch.empty_like(x) for x in (r, k, v, w)]
    du = None
    for t0 in range(0, s, span):
        part = torch.zeros_like(do)
        part[:, t0:t0 + span] = do[:, t0:t0 + span]
        g = bwd(r, k, v, w, u, part, dstate if t0 + span >= s else None,
                chunk=chunk)
        for x, y in zip(out, g[:4]):
            x[:, t0:t0 + span] = y[:, t0:t0 + span]
        du = g[4] if du is None else du + g[4]
    return (*out, du)


def seq_ragged_cases(device):
    """Edge shapes, seeded. Attention: Sq != Sk, S not a multiple of the
    64-row tile, a window below the tile, rows left with no allowed key,
    GQA 10:1. GLA: S = 1, S = 17 at chunk 1, 48 at chunk 16, a chunk of
    128 (run as two of 64), dh 8 and 64, odd H, w at the RWKV6 clip's
    ends (1.9e-24, below the 1e-20 clamp, and 1 - 6.1e-6), fp32 and bf16
    r/k/v, w fp32 and bf16."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(11)

    def r(dtype, *shape):
        return torch.randn(shape, generator=g).to(device, dtype)

    def u(dtype, *shape):
        return torch.rand(shape, generator=g).to(device, dtype)

    def gla(dtype, b, s, h, dh, chunk, ends=False, w_dtype=torch.float32):
        w = torch.rand((b, s, h, dh), generator=g) * 0.5 + 0.45
        if ends:
            w = torch.tensor([1.9e-24, 1.0 - 6.1e-6])[
                torch.randint(0, 2, w.shape, generator=g)]
        return ((r(dtype, b, s, h, dh), r(dtype, b, s, h, dh),
                 r(dtype, b, s, h, dh), w.to(device, w_dtype),
                 r(torch.float32, h, dh)), dict(chunk=chunk))

    bf, f32 = torch.bfloat16, torch.float32
    attn = [((r(bf, 1, 100, 10, 256), r(bf, 1, 37, 1, 256),
              r(bf, 1, 37, 1, 256)), dict(causal=True, window=0)),
            ((r(bf, 1, 37, 10, 256), r(bf, 1, 100, 1, 256),
              r(bf, 1, 100, 1, 256)), dict(causal=True, window=16)),
            ((r(f32, 2, 130, 4, 64), r(f32, 2, 130, 2, 64),
              r(f32, 2, 130, 2, 64)), dict(causal=True, window=20)),
            ((r(f32, 1, 100, 2, 64), r(f32, 1, 37, 1, 64),
              r(f32, 1, 37, 1, 64)), dict(causal=True, window=16)),
            ((r(f32, 2, 65, 2, 128), r(f32, 2, 65, 2, 128),
              r(f32, 2, 65, 2, 128)), dict(causal=False, window=0))]
    scan = [((u(f32, 3, 77, 300), r(f32, 3, 77, 300)), {}),
            ((u(bf, 3, 77, 300), r(bf, 3, 77, 300)), {}),
            ((u(f32, 1, 5, 2560), r(f32, 1, 5, 2560)), {})]
    glas = [gla(bf, 2, 1, 3, 64, 1), gla(f32, 2, 17, 3, 8, 1, ends=True),
            gla(bf, 2, 17, 5, 64, 1, ends=True),
            gla(f32, 2, 48, 5, 64, 16, ends=True),
            gla(bf, 1, 48, 3, 8, 16, ends=True),
            gla(f32, 1, 48, 3, 64, 16, w_dtype=bf),
            gla(f32, 1, 128, 3, 64, 128)]
    return {"flash_attention": attn, "rglru_scan": scan, "gla_chunked": glas}


def no_impl(kw):
    return {k: v for k, v in kw.items() if k != "impl"}


def check_and_time_seq(rec, ragged, cell="RecurrentGemma-2B fp32 prefill",
                       fp32=True):
    """Hold each sequence kernel the phase recorded against its plain
    version on the path's recorded inputs and on ragged shapes, every
    output (GLA: out and the final state) to its own tolerance: fp32 to
    KERNEL_RTOL of the plain result's scale (GLA's longest reduction, the
    state's sum over S tokens, runs chunk by chunk in the same order in
    both; each chunk's add rounds at 6e-8 of the state's scale, and 256
    such roundings of either sign add to ~1e-6), bf16 to one bf16 ulp of
    it. Then time kernel, plain version and (attention only) SDPA at the
    path's shape; with ``fp32`` also the fp32-storage attention (its row
    named ``cell``). Raises on a disagreement."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import gla_chunked as kgla
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rglru_scan as krg
    op = {"flash_attention": ops.attention, "rglru_scan": ops.lru_scan,
          "gla_chunked": ops.gla_chunked}
    results = {}
    for name, calls in rec.calls.items():
        if not calls:
            raise RuntimeError(f"the path never called {name}")
        worst = 0.0
        cases = [(f"path {list(key)} x{cnt}", args, no_impl(kw))
                 for key, (cnt, args, kw) in calls.items()]
        cases += [(f"ragged {[list(a.shape) for a in args]} "
                   f"{[str(a.dtype)[6:] for a in args]} {kw}", args, kw)
                  for args, kw in ragged[name]]
        for label, args, kw in cases:
            got = op[name](*args, **kw)
            want = op[name](*args, **dict(kw, impl="xla"))
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            ok, parts = True, []
            for g_, w_ in zip(got, want):
                err = float((g_.float() - w_.float()).abs().max())
                scale = max(1.0, float(w_.float().abs().max()))
                rtol = BF16_RTOL if w_.dtype == torch.bfloat16 else KERNEL_RTOL
                ok = ok and err <= rtol * scale
                parts.append(f"max_abs_err {err:.3e} (tol {rtol:.2e} x "
                             f"scale {scale:.3g})")
                if label.startswith("path"):
                    worst = max(worst, err)
            say(f"  {name:16s} {label}: {'; '.join(parts)} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{name} disagrees with its plain version")
        (cnt, args, kw), = calls.values()      # one shape on the path
        kw = no_impl(kw)
        b_ms, b_by = seq_bound_ms(name, args, kw)
        if name == "flash_attention":
            q, k, v = args

            def heads_major(x):                 # the layout ops hands over
                bx, sx, hx, dx = x.shape
                return ops._dense(x.transpose(1, 2).reshape(bx * hx, sx, dx))
            qf, kf, vf = (heads_major(x) for x in (q, k, v))
            k_ms = cuda_ms(lambda: kfa.flash_attention(qf, kf, vf, **kw),
                           reps=5, warmup=1)
            p_ms = cuda_ms(lambda: ref.attention_ref(qf, kf, vf, **kw),
                           reps=3, warmup=1)
            i = torch.arange(q.shape[1], device=q.device)[:, None]
            j = torch.arange(k.shape[1], device=q.device)[None, :]
            mask = j <= i if kw["causal"] else torch.ones_like(j > i)
            if kw["window"] > 0:
                mask &= j > i - kw["window"]
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)
            want = ops.attention(q, k, v, **dict(kw, impl="xla"))
            lib_err = float((lib().transpose(1, 2).float()
                             - want.float()).abs().max())
            lib_scale = float(want.float().abs().max())
            say(f"  {name:16s} SDPA yardstick: max_abs_err {lib_err:.3e} "
                f"(tol {YARDSTICK_RTOL:.0e} x scale {lib_scale:.3g})")
            if lib_err > YARDSTICK_RTOL * lib_scale:
                raise RuntimeError("SDPA yardstick disagrees with the plain "
                                   "attention")
            lib_ms = cuda_ms(lib, reps=5, warmup=1)
            got = kfa.flash_attention(qf, kf, vf, **kw).float()
            want = ref.attention_ref(qf, kf, vf, **kw).float()
            terms = ref.attention_ref(qf.float(), kf.float(), vf.float().abs(),
                                      **kw)
            excess = (((got - want).abs() - bf16_ulp(want)).clamp_min(0)
                      / terms.clamp_min(1e-30))
            say(f"  {name:16s} path, element by element: "
                f"{float((got != want).float().mean()):.4%} differ, the "
                f"largest excess over one bf16 ulp {float(excess.max()):.3e} "
                f"of (P |V|) / l")
            del terms, excess
            attention_excess_finding(qf, kf, vf, kw, got, want)
            del got, want
            dev_us = device_us(lambda *x: kfa.flash_attention(*x, **kw),
                               [qf, kf, vf])
            b, sq, h, dh = q.shape
            flops = 4 * dh * b * h * allowed_pairs(sq, k.shape[1], **kw)
            say(f"  {name:16s} {kfa.bf16_design()} design: "
                f"{flops / k_ms / 1e9:.1f} TFLOP/s on allowed pairs, "
                f"{100 * b_ms / k_ms:.1f}% of the bound, {k_ms / lib_ms:.3f}x "
                f"SDPA's time")
            if fp32:
                results[FA32] = fp32_attention_row(q, k, v, kw, mask, flops,
                                                   cell)
        elif name == "gla_chunked":
            r, k, v, w, u = args
            dense = [ops._dense(x) for x in (r, k, v, w)] + [
                ops._dense(u.float())]      # what ops hands the kernel
            k_ms = cuda_ms(lambda: kgla.gla_chunked(*dense, **kw), reps=10,
                           warmup=2)
            p_ms = cuda_ms(lambda: ref.gla_chunked_ref(r, k, v, w, u,
                                                       kw["chunk"]),
                           reps=3, warmup=1)
            lib_ms = None   # no single PyTorch call computes chunked GLA
            dev_us = device_us(lambda *x: kgla.gla_chunked(*x, **kw), dense)
        else:
            a, b = args
            k_ms = cuda_ms(lambda: krg.rglru_scan(a, b), reps=20, warmup=2)
            p_ms = cuda_ms(lambda: ref.rglru_scan_ref(a, b), reps=2,
                           warmup=1)
            lib_ms = None          # no single PyTorch call is a linear scan
            dev_us = device_us(krg.rglru_scan, [a, b])
        say(f"  {name:16s} timed at {[list(x.shape) for x in args]} "
            f"{[str(x.dtype)[6:] for x in args]} {kw} x{cnt}: kernel "
            f"{k_ms:.4f} ms (device {dev_us:.2f} us a launch), plain "
            f"{p_ms:.4f} ms, library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b_ms:.6f} ms ({b_by}), kernel/bound {k_ms / b_ms:.2f}x")
        results[name] = dict(name=name, route="cuda", **SEQ_KERNELS[name],
                             shape=[list(x.shape) for x in args],
                             max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                             device_us=dev_us)
    return results


FA32 = "flash_attention fp32"


def fp32_fn_bound(smax):
    """How far fp32 attention may be from the fp64 function at scores up
    to ``smax`` (|s| / sqrt(dh)), relative to the size of the terms summed
    into an element: every fp32 rounding of a score at its own size (the
    plain version's matmul and scale; the kernels' accumulators) and of
    the LSE puts up to |x| 2^-24 on the exponent of a weight P, x the
    largest score in log2 units. The bound, 4 |x| 2^-24 + 2^-15, is twice
    what two such roundings give; the CPU tests hold the kernels' emulated
    arithmetic to it (``test_3xtf32_attention_at_the_reference_init_logit_
    range``)."""
    import math
    return 4 * smax * math.log2(math.e) * 2.0 ** -24 + 2.0 ** -15


def attention_fp64(q, k, v, *, causal, window):
    """The attention function in fp64 of the given inputs (heads-major:
    q (BH, Sq, dh), k and v (BH / G, Sk, dh)); a = (P |V|) / l, the size
    of the terms summed into each element; and the largest |s| / sqrt(dh)
    over the allowed pairs. A row with no allowed key gives 0. One query
    head at a time."""
    import math
    import torch
    from repro_torch.kernels import ref
    bh, sq, dh = q.shape
    g = bh // k.shape[0]
    mask = ref.attention_mask(sq, k.shape[1], causal, window, q.device)
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    a = torch.empty_like(out)
    smax = 0.0
    for h in range(bh):
        s = q[h].double() @ k[h // g].double().T / math.sqrt(dh)
        smax = max(smax, float(s.masked_fill(~mask, 0.0).abs().max()))
        p = torch.softmax(s.masked_fill(~mask, float("-inf")),
                          -1).nan_to_num(0.0)
        vh = v[h // g].double()
        out[h], a[h] = p @ vh, p @ vh.abs()
    return out, a, smax


def attention_bwd_fp64(q, k, v, o, do, *, causal, window, lse=None):
    """dq, dk, dv of the attention function in fp64 at the given inputs
    (heads-major) and output o, with D_i = sum_c dO_ic o_ic and P the fp64
    softmax of the scores, or, where ``lse`` is given, P = exp(s / sqrt(dh)
    - LSE) with that LSE (what ``ref.attention_bwd_ref`` computes from the
    backward kernel's inputs); the size of the terms summed into each
    gradient element, with |dS| counted as P (|dP| + |D|), the size of what
    dS is formed from (dP and D cancel on a row's dominant key); and the
    largest |s| / sqrt(dh) over the allowed pairs. One query head at a
    time."""
    import math
    import torch
    from repro_torch.kernels import ref
    bh, sq, dh = q.shape
    bk, sk = k.shape[:2]
    g, c = bh // bk, 1.0 / math.sqrt(dh)
    mask = ref.attention_mask(sq, sk, causal, window, q.device)
    f64 = dict(dtype=torch.float64, device=q.device)
    dq, tq = torch.empty(q.shape, **f64), torch.empty(q.shape, **f64)
    dk, dv, tk, tv = (torch.zeros(k.shape, **f64) for _ in range(4))
    smax = 0.0
    for h in range(bh):
        kh, vh = k[h // g].double(), v[h // g].double()
        qh, oh, doh = q[h].double(), o[h].double(), do[h].double()
        s = qh @ kh.T * c
        smax = max(smax, float(s.masked_fill(~mask, 0.0).abs().max()))
        if lse is None:
            p = torch.softmax(s.masked_fill(~mask, float("-inf")),
                              -1).nan_to_num(0.0)
        else:                                   # -inf: a row with no key
            p = torch.where(mask, (s - lse[h].double().clamp_min(-1e30)[
                :, None]).exp(), 0.0)
        dp, dd = doh @ vh.T, (doh * oh).sum(-1, keepdim=True)
        ds, size = p * (dp - dd), p * (dp.abs() + dd.abs())
        dq[h], tq[h] = c * ds @ kh, c * size @ kh.abs()
        dk[h // g] += c * ds.T @ qh
        tk[h // g] += c * size.T @ qh.abs()
        dv[h // g] += p.T @ doh
        tv[h // g] += p.T @ doh.abs()
    return (dq, dk, dv), (tq, tk, tv), smax


def fp64_excess(got, exact, terms, smax):
    """``got`` element by element against the fp64 function ``exact``:
    the largest excess of |got - exact| over fp32_fn_bound(smax) x terms
    (<= 1e-30 passes: an element whose weights underflow fp32 may be off
    by that), and the largest |got - exact| / terms where terms > 1e-20,
    as a share of that bound."""
    bound = fp32_fn_bound(smax)
    err = (got.double() - exact).abs()
    big = terms > 1e-20
    share = float((err[big] / terms[big]).max()) / bound if big.any() else 0.0
    return float((err - bound * terms).max()), share


# NaN bit patterns planted in the fp32 attention's inputs: torch's NaN,
# the NaN the card's arithmetic makes, and that one negated
NAN_BITS = (0x7fc00000, 0x7fffffff, -1)


def nan_of(bits, device):
    """The fp32 value of the 32-bit pattern ``bits`` (as an int32)."""
    import torch
    return torch.tensor(bits, dtype=torch.int32, device=device).view(
        torch.float32)


def nan_reach(q, k, v, *, causal, window, o=None, do=None, lse=None):
    """Where the NaNs in the inputs must reach the attention function's
    outputs, by its data flow over the allowed pairs (a NaN that only meets
    a masked pair reaches nothing, whatever 0 x NaN a plain version makes
    of it). Forward (``do`` None): the (BH, Sq) rows of the output. With
    ``do``, ``o`` and ``lse``: the rows of dq (BH, Sq), dk and dv (BK,
    Sk): P_ij = exp(s_ij - lse_i) carries q_i, k_j, lse_i; dS_ij = P_ij
    (dO_i . v_j - D_i) with D_i = dO_i . o_i adds dO_i, v_j, o_i; dq_i sums
    dS_i. k, dk_j sums dS_.j q over the group's query heads, dv_j sums
    P_.j dO."""
    import torch
    from repro_torch.kernels import ref
    bh, sq = q.shape[:2]
    bk, sk = k.shape[:2]
    g = bh // bk
    m = ref.attention_mask(sq, sk, causal, window, q.device).float()

    def rows(x):
        return torch.isnan(x).reshape(x.shape[0], x.shape[1], -1).any(-1)

    def any_allowed(ai, bj):
        """Per query head h: row i is reached when some allowed j has
        ai[h, i] or bj[h // g, j]; returns (BH, Sq) and, through the
        transpose, per kv head (BK, Sk) the keys some allowed i reaches."""
        bjh = bj.repeat_interleave(g, 0).float()          # (BH, Sk)
        by_row = (ai & (m.sum(1) > 0)) | (bjh @ m.T > 0)
        by_key = ((bj.repeat_interleave(g, 0) & (m.sum(0) > 0))
                  | (ai.float() @ m > 0)).view(bk, g, sk).any(1)
        return by_row, by_key

    nq, nk, nv = rows(q), rows(k), rows(v)
    if do is None:
        return any_allowed(nq, nk | nv)[0]
    nl = torch.isnan(lse)
    dq, dk = any_allowed(nq | nl | rows(do) | rows(o), nk | nv)
    dv = any_allowed(nq | nl | rows(do), nk)[1]
    return dq, dk, dv


def plant_nans(tensors, spots, bits):
    """Copies of ``tensors`` with the pattern ``bits`` at each (tensor
    index, head, row, column) of ``spots``."""
    out = [t.clone() for t in tensors]
    for i, h, r, c in spots:
        out[i][h, r, c] = nan_of(bits, out[i].device)
    return out


def nan_rows_check(q, k, v, kw, label):
    """A NaN planted in q, k and v (forward) and in q, k, v and dO
    (backward) of the fp32 attention at the given heads-major inputs, for
    each pattern of NAN_BITS: the kernels' outputs must be NaN in every
    row the NaN reaches (``nan_reach``) and in no row the plain version
    keeps finite. Prints the row counts; returns False on a miss."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    bh, sq, dh = q.shape
    bk, sk = k.shape[:2]
    g = bh // bk
    gen = torch.Generator(device="cpu").manual_seed(31)
    do = torch.randn(q.shape, generator=gen).to(q.device)
    # q in the last group's first head; k, v and dO in other groups
    spots = [(0, (bk - 1) * g, sq - 1, 7), (1, 0, sk // 4, 5),
             (2, min(1, bk - 1), sk // 2, 9), (3, bh // 2 + 1, sq // 3, 3)]
    ok = True
    for bits in NAN_BITS:
        pq, pk, pv, pdo = plant_nans((q, k, v, do), spots, bits)
        want_o, want_lse = ref.attention_ref(pq, pk, pv, return_lse=True,
                                             **kw)
        got = kfa.flash_attention(pq, pk, pv, **kw)
        grads = kfa.flash_attention_bwd(pq, pk, pv, want_o, pdo,
                                        lse=want_lse, **kw)
        plain = ref.attention_bwd_ref(pq, pk, pv, want_o, pdo, lse=want_lse,
                                      **kw)
        reach = ((nan_reach(pq, pk, pv, **kw),)
                 + nan_reach(pq, pk, pv, o=want_o, do=pdo, lse=want_lse,
                             **kw))
        line = []
        for name, kern, pl, need in zip(("out", "dq", "dk", "dv"),
                                        (got,) + grads, (want_o,) + plain,
                                        reach):
            kr, pr = (torch.isnan(x).any(-1) for x in (kern, pl))
            hit = bool((kr | ~need).all()) and bool((~kr | pr).all())
            ok &= hit
            line.append(f"{name} {int(need.sum())}/{int(kr.sum())}/"
                        f"{int(pr.sum())}{'' if hit else ' MISS'}")
        say(f"  {label} NaN 0x{bits & 0xffffffff:08x} in q, k, v, dO: rows "
            f"reached/kernel/plain: {', '.join(line)}")
        del pq, pk, pv, pdo, want_o, want_lse, got, grads, plain
    return ok


def fp32_attention_row(q, k, v, kw, mask, flops, cell):
    """The fp32-storage attention (``csrc/flash_attention.cu``, 3xTF32
    on the tensor cores: its design read from the machine code, a gate)
    at the path's shape, held two ways: on seeded unit-scale inputs of
    that shape, within KERNEL_RTOL of the output's scale of the plain fp32
    version; on the path's inputs cast to fp32 (the reference init's
    scores reach the thousands, where the plain fp32 version is itself
    more than KERNEL_RTOL off the function), element by element within
    ``fp32_fn_bound`` of the terms of the fp64 function, the plain
    version's share of that bound and its distance from the kernel
    printed beside. Then timed beside the plain version and beside SDPA in
    fp32 with the same boolean mask (checked against the plain version
    first, at YARDSTICK_RTOL), its device time a launch, and its bound at
    the 3xTF32 rate (the fp32 CUDA-core rate's beside it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops, ref
    name = "flash_attention"
    design = kfa.fp32_design()
    say(f"  {name:16s} fp32 design: {design} (the machine code of the "
        f"forward and of the backward's dQ and dK/dV passes; HMMA .TF32 = "
        f"mma.sync)")
    if design == "none":
        raise RuntimeError("the fp32 attention kernels are not on the "
                           "tensor cores")
    q32, k32, v32 = (x.float() for x in (q, k, v))

    def heads_major(x):
        bx, sx, hx, dx = x.shape
        return ops._dense(x.transpose(1, 2).reshape(bx * hx, sx, dx))
    qf, kf, vf = (heads_major(x) for x in (q32, k32, v32))
    g = torch.Generator(device="cpu").manual_seed(14)
    unit = [torch.randn(x.shape, generator=g).to(x.device)
            for x in (qf, kf, vf)]
    got, want = (fn(*unit, **kw) for fn in (kfa.flash_attention,
                                            ref.attention_ref))
    unit_scale = max(1.0, float(want.abs().max()))
    unit_err = float((got - want).abs().max())
    ok_unit = unit_err <= KERNEL_RTOL * unit_scale
    say(f"  {name:16s} fp32 storage (3xTF32), unit-scale inputs at the "
        f"path's shape: max_abs_err {unit_err:.3e} (tol {KERNEL_RTOL:.0e} "
        f"x scale {unit_scale:.3g}) {'ok' if ok_unit else 'FAIL'}")
    del unit, got, want
    got = kfa.flash_attention(qf, kf, vf, **kw)
    want = ref.attention_ref(qf, kf, vf, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    exact, terms, smax = attention_fp64(qf, kf, vf, **kw)
    excess, share = fp64_excess(got, exact, terms, smax)
    plain_share = fp64_excess(want, exact, terms, smax)[1]
    ok = excess <= 1e-30
    del exact, terms
    say(f"  {name:16s} fp32 storage (3xTF32), the path's inputs (scores up "
        f"to {smax:.1f}, {smax * 1.4426950408889634:.1f} in log2 units): "
        f"against the fp64 function element by element, the kernel's "
        f"largest error {share:.3f} of the bound "
        f"{fp32_fn_bound(smax):.3e} x (P |V|) / l, the plain fp32 "
        f"version's {plain_share:.3f}; the kernel {err:.3e} off the plain "
        f"version (KERNEL_RTOL x scale {KERNEL_RTOL * scale:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not (ok and ok_unit):
        raise RuntimeError("the fp32 attention disagrees with its plain "
                           "version or with the fp64 function")
    if not nan_rows_check(qf, kf, vf, kw, f"{name:16s} fp32"):
        raise RuntimeError("a NaN in the fp32 attention's inputs does not "
                           "reach the rows it reaches in the function")
    b, sq, h, dh = q.shape

    def lib():
        return F.scaled_dot_product_attention(
            q32.transpose(1, 2), k32.transpose(1, 2), v32.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
    lib_out = lib().reshape(b * h, sq, dh)
    lib_err = float((lib_out - want).abs().max())
    del lib_out, got, want
    say(f"  {name:16s} fp32 SDPA yardstick: max_abs_err {lib_err:.3e} (tol "
        f"{YARDSTICK_RTOL:.0e} x scale {scale:.3g})")
    if lib_err > YARDSTICK_RTOL * scale:
        raise RuntimeError("fp32 SDPA disagrees with the plain attention")
    k_ms = cuda_ms(lambda: kfa.flash_attention(qf, kf, vf, **kw), reps=3,
                   warmup=1)
    p_ms = cuda_ms(lambda: ref.attention_ref(qf, kf, vf, **kw), reps=2,
                   warmup=1)
    lib_ms = cuda_ms(lib, reps=3, warmup=1)
    dev_us = device_us(lambda *x: kfa.flash_attention(*x, **kw),
                       [qf, kf, vf], n=2)
    b_ms, b_by = seq_bound_ms(name, (q32, k32, v32), kw)
    simt_ms = flops / FP32_FLOPS * 1e3
    say(f"  {name:16s} fp32 timed at {[list(x.shape) for x in (q, k, v)]} "
        f"{kw}: kernel {k_ms:.4f} ms (device {dev_us:.2f} us a launch), "
        f"plain {p_ms:.4f} ms, SDPA fp32 {lib_ms:.4f} ms, bound "
        f"{b_ms:.6f} ms ({b_by}, 3xTF32; {simt_ms:.6f} ms at the fp32 "
        f"CUDA-core rate); {flops / k_ms / 1e9:.1f} TFLOP/s on allowed "
        f"pairs, kernel/bound {k_ms / b_ms:.2f}x, kernel/SDPA "
        f"{k_ms / lib_ms:.3f}x; card {smi('name,power.limit')}")
    return dict(name=name, route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces=SEQ_KERNELS[name]["replaces"],
                shape=[list(x.shape) for x in (q, k, v)], max_abs_err=err,
                ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, device_us=dev_us, cell=cell)


def tensor_core_scores(q, k):
    """q (..., m, dh) @ k (..., n, dh)^T of bf16 values as Hopper's tensor
    cores sum them in fp32 (a model, fitted to the kernel's bits on the
    serving path): per wgmma k-step, the 16 exact products and the
    running sum are aligned to the largest exponent among them, each
    truncated below 2^(e - 26), added exactly, and the sum truncated to
    fp32 (toward 0). Returns fp32 (..., m, n)."""
    import torch
    qd, kd = q.double(), k.double()
    acc = torch.zeros(qd.shape[:-1] + (kd.shape[-2],), dtype=torch.float64,
                      device=q.device)
    for k0 in range(0, q.shape[-1], 16):
        terms = torch.cat([acc[..., None], qd[..., :, None, k0:k0 + 16]
                           * kd[..., None, :, k0:k0 + 16]], -1)
        e = torch.frexp(terms.abs().amax(-1, keepdim=True)).exponent
        quantum = torch.ldexp(torch.ones_like(terms[..., :1]), e - 26)
        total = (torch.trunc(terms / quantum) * quantum).sum(-1)
        rn = total.float()
        acc = torch.where(rn.double().abs() > total.abs(),
                          torch.nextafter(rn, torch.zeros_like(rn)),
                          rn).double()
    return acc.float()


def attention_excess_finding(qf, kf, vf, kw, got, want, limit=2048):
    """Recompute the query rows where the bf16 kernel (``got``) is more than
    one bf16 ulp off the plain version (``want``, both heads-major): in
    fp64 from the bf16 inputs; in the plain version's fp32 arithmetic
    (unrounded); and in the kernel's order of arithmetic in plain PyTorch
    (scores summed as the tensor cores sum them, ``tensor_core_scores``,
    then scaled by log2(e) / sqrt(dh) before the running max is
    subtracted; online softmax over 64-key tiles; P split into bf16 hi +
    lo), and the same with the scores of one fp32 matmul instead. Prints
    the share of the kernel's differing bf16 values each emulation
    reproduces and each version's largest error against fp64 there, in
    units of a = (P |V|) / l, over at most ``limit`` rows. Returns the
    finding: "order" when the kernel-order emulation reproduces at least
    90% of them, else "fault"."""
    import math
    import torch
    bad = (got - want).abs() > bf16_ulp(want)
    rows = bad.any(-1).nonzero()
    if rows.shape[0] == 0:
        say("  step 0: no element more than one bf16 ulp off")
        return "none"
    n_rows, rows = rows.shape[0], rows[:limit]
    g, dh, sk = qf.shape[0] // kf.shape[0], qf.shape[-1], kf.shape[1]
    sl2 = math.log2(math.e) / math.sqrt(dh)
    j = torch.arange(sk, device=qf.device)[None, :]
    models = ("tensor-core sums", "one fp32 matmul")
    n_el, same = 0, dict.fromkeys(models, 0)
    err = dict.fromkeys(("kernel", "plain fp32") + models, 0.0)
    xmax = 0.0
    for bh in rows[:, 0].unique().tolist():
        for part in rows[rows[:, 0] == bh, 1].split(128):
            i = part
            ok = torch.ones((i.numel(), sk), dtype=torch.bool,
                            device=qf.device)
            if kw["causal"]:
                ok &= j <= i[:, None]
            if kw["window"] > 0:
                ok &= j > i[:, None] - kw["window"]
            q, kk, vv = qf[bh, i], kf[bh // g], vf[bh // g]
            p64 = torch.softmax((q.double() @ kk.double().T
                                 / math.sqrt(dh)).masked_fill(
                ~ok, float("-inf")), -1)
            exact, a = p64 @ vv.double(), p64 @ vv.double().abs()
            s32 = ((q.float() @ kk.float().T) / math.sqrt(dh)).masked_fill(
                ~ok, float("-inf"))
            p32 = (s32 - s32.amax(-1, keepdim=True)).exp()
            b = bad[bh, i]
            n_el += int(b.sum())
            outs = {"kernel": got[bh, i],
                    "plain fp32": (p32 @ vv.float()) / p32.sum(-1,
                                                               keepdim=True)}
            for model in models:
                acc = (tensor_core_scores(q, kk) if model == models[0]
                       else q.float() @ kk.float().T)
                x = (acc * sl2).masked_fill(~ok, -1e30)
                xmax = max(xmax, float(x[ok].abs().max()))
                m = torch.full((i.numel(), 1), -1e30, device=qf.device)
                l = torch.zeros_like(m)
                o = torch.zeros((i.numel(), dh), device=qf.device)
                for k0 in range(0, sk, 64):
                    okt = ok[:, k0:k0 + 64]
                    if not bool(okt.any()):
                        continue
                    xt = x[:, k0:k0 + 64]
                    m_new = torch.maximum(m, xt.amax(-1, keepdim=True))
                    alpha, m = torch.exp2(m - m_new), m_new
                    p = torch.where(okt, torch.exp2(xt - m), 0.0)
                    l = l * alpha + p.sum(-1, keepdim=True)
                    hi = p.bfloat16().float()
                    lo = (p - hi).bfloat16().float()
                    vt = vv[k0:k0 + 64].float()
                    o = o * alpha + hi @ vt + lo @ vt
                outs[model] = o / l.clamp_min(1e-30)
                same[model] += int((outs[model].bfloat16().float()
                                    == got[bh, i])[b].sum())
            for name, val in outs.items():
                e = ((val.double() - exact).abs() / a.clamp_min(1e-300))[b]
                err[name] = max(err[name], float(e.max()))
    finding = "order" if same[models[0]] >= 0.9 * n_el else "fault"
    say(f"  step 0: {n_el} elements in {n_rows} query rows more than one "
        f"bf16 ulp off the plain version ({rows.shape[0]} rows recomputed, "
        f"scaled scores up to {xmax:.1f} in log2 units); the kernel-order "
        f"emulation gives the kernel's bf16 value at "
        + ", ".join(f"{v} ({v / max(n_el, 1):.2%}) with {k}"
                    for k, v in same.items())
        + "; largest error against the fp64 function there, in units of "
        "(P |V|) / l: " + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
        + ": " + ("the rounding of fp32 arithmetic in the kernel's order"
                  if finding == "order" else "NOT reproduced"))
    return finding


def bf16_ulp(x):
    """Spacing of bf16 at |x| (0 at 0): 2^(e - 7) for |x| in [2^e, 2^(e+1))."""
    import torch
    mant, exp = torch.frexp(x.float())
    return torch.where(mant == 0, torch.zeros_like(mant),
                       torch.ldexp(torch.ones_like(mant), exp - 8))


def logit_dev(got, want):
    """Max abs deviation relative to the scale (max |logit|) of ``want``."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def nudge_(p32, device, slab=1 << 26):
    """Move every fp32 weight one ulp, up or down at random (seeded), in
    place, ``slab`` elements at a time (no full-size temporaries)."""
    import torch
    g = torch.Generator(device=device).manual_seed(2)
    for v in p32.values():
        up = torch.randint(0, 2, v.shape, generator=g, device=device,
                           dtype=torch.bool).view(-1)
        flat = v.view(-1)
        for i in range(0, flat.numel(), slab):
            part = flat[i:i + slab]
            part.copy_(torch.nextafter(part, torch.where(
                up[i:i + slab], float("inf"), float("-inf"))))
        del up


def batch_bs(batch):
    """(B, S) of a model batch: its tokens or its embeddings."""
    x = batch["tokens"] if "tokens" in batch else batch["embeddings"]
    return tuple(x.shape[:2])


def step_input(cfg, tok):
    """A decode step's batch for the greedy tokens ``tok`` (B,): the
    tokens, or for an embedding-input arch their frames through the
    frontend stub of ``launch/serve.py``."""
    from repro_torch.launch.serve import frame_stub
    if cfg.input_kind == "embeddings":
        return {"embeddings": frame_stub(tok, cfg)[:, None]}
    return {"tokens": tok[:, None]}


def longer_batch(cfg, batch, tok):
    """The prompt and the decode step's input ``tok`` as one batch of
    S + 1 positions: the conditioning as it is, M-RoPE positions 0..S."""
    import torch
    nxt = step_input(cfg, tok)
    out = {k: torch.cat([batch[k], v], 1) for k, v in nxt.items()}
    if "cond" in batch:
        out["cond"] = batch["cond"]
    if "mrope_positions" in batch:
        mp = batch["mrope_positions"]
        out["mrope_positions"] = torch.cat([mp, mp[:, :, -1:] + 1], 2)
    return out


def plain_bf16_dev(cfg, params, batch, logits, cache):
    """The same prefill through the plain versions: prints each cache
    entry's deviation from the kernel prefill's, returns the plain
    logits and the kernel logits' deviation from them."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import Model
    plain_logits, plain_cache = make_prefill_step(Model(cfg, impl="xla"))(
        params, batch)
    for key in sorted(cache):
        say(f"    cache {key} {tuple(cache[key].shape)} {cache[key].dtype}: "
            f"kernel vs plain {logit_dev(cache[key], plain_cache[key]):.3e} "
            f"of its scale")
    return plain_logits, logit_dev(logits, plain_logits)


class PinnedRouting:
    """An MoE layer's routing is discontinuous in its input: a last-bit
    difference that flips one expert choice moves the logits by more than
    any rounding does. So runs compared for their rounding are routed
    alike: the run under ``record()`` keeps each MoE layer's top-k experts
    (a layer a call, in order), and each run under ``replay()`` takes them
    (its gates from its own probabilities at those experts), counting the
    choices its own top-k would have made otherwise. Patches
    ``moe.top_k``, which ``moe.route`` calls once a layer; a dense arch
    records nothing."""

    def __init__(self):
        from repro_torch.models.layers import moe
        self.moe, self.orig = moe, moe.top_k
        self.idx, self.differ, self.choices = [], 0, 0

    @contextlib.contextmanager
    def _run(self, fn):
        self.moe.top_k = fn
        try:
            yield
        finally:
            self.moe.top_k = self.orig

    def record(self):
        def keep(probs, k):
            vals, idx = self.orig(probs, k)
            self.idx.append(idx)
            return vals, idx
        self.idx = []
        return self._run(keep)

    def replay(self, idx=None):
        it = iter(self.idx if idx is None else idx)

        def pinned(probs, k):
            idx = next(it)
            self.differ += int((self.orig(probs, k)[1] != idx).sum())
            self.choices += idx.numel()
            return probs.gather(-1, idx), idx
        return self._run(pinned)

    def extended(self, step, b):
        """The choices of a prefill of S + 1 positions: each layer's
        recorded choices for the B x S prompt, and ``step``'s (a decode
        step's, B x 1) after each prompt row (token-major, as ``moe_ffn``
        flattens them)."""
        import torch
        return [torch.cat([p.view(b, -1, p.shape[-1]),
                           q.view(b, 1, q.shape[-1])], 1).view(-1, p.shape[-1])
                for p, q in zip(self.idx, step.idx)]


class DropCount:
    """While open, counts the expert assignments each MoE layer drops over
    its capacity (patches ``moe.slots``; a dense arch counts nothing)."""

    def __init__(self):
        from repro_torch.models.layers import moe
        self.moe, self.orig, self.seen = moe, moe.slots, []

    def __enter__(self):
        def counted(idx, cap, e):
            keep, slot = self.orig(idx, cap, e)
            self.seen.append((int((~keep).sum()), keep.numel(), cap))
            return keep, slot
        self.moe.slots = counted
        return self

    def __exit__(self, *exc):
        self.moe.slots = self.orig

    @property
    def dropped(self):
        return sum(d for d, _, _ in self.seen)

    def report(self, label):
        if self.seen:
            say(f"  {label} dropped {self.dropped:,} of "
                f"{sum(n for _, n, _ in self.seen):,} expert assignments "
                f"over {len(self.seen)} MoE layers (capacity "
                f"{self.seen[0][2]} an expert)")


def condition_(params):
    """Rescale in place each layer matrix from the reference init's std,
    1/sqrt(its first dim: the stack axis for stacked weights), to
    1/sqrt(d_in), d_in the size of what it contracts: d for the q, k, v,
    FFN-in and router projections, H·dh for wo, f for the FFN-out ones,
    and d / f for the expert stacks (E, d, f) / (E, f, d). (At the
    reference init a stack cut to one cycle has its matrices at std 1,
    and a deep one is chaotic.)"""
    import math
    for key, v in params.items():
        lead = 1 if key.startswith("stack/") else 0
        dims = v.shape[lead:]
        name = key.rsplit("/", 1)[-1]
        if not key.startswith(("stack/", "rem/")) or len(dims) < 2 or \
                name.startswith("b"):
            continue
        fan_in = (dims[0] * dims[1] if name == "wo" else
                  dims[1] if "/moe/w_" in key else dims[0])
        v.mul_(math.sqrt(v.shape[0] / fan_in))


def round_through_(params, dtype, slab=1 << 26):
    """Round each fp32 weight to ``dtype``'s nearest value in place,
    ``slab`` elements at a time (no full-size temporaries)."""
    for v in params.values():
        for part in v.view(-1).split(slab):
            part.copy_(part.to(dtype))


def tf32_(x):
    """``x`` in fp32 rounded to nearest (even) at TF32's 10 mantissa bits:
    the operands of a one-pass TF32 product."""
    import torch
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


@contextlib.contextmanager
def attention_called(call):
    """While open, ``ops.attention(q, k, v, **kw)`` is ``call(the original,
    q, k, v, **kw)``: the controls of phase 13's gates."""
    from repro_torch.kernels import ops
    orig = ops.attention
    ops.attention = lambda *args, **kw: call(orig, *args, **kw)
    try:
        yield
    finally:
        ops.attention = orig


def tf32_inputs(attn, q, k, v, **kw):
    """The fp32 gate's control: a kernel without the 3xTF32 split."""
    return attn(tf32_(q), tf32_(k), tf32_(v), **kw)


def half_window(attn, q, k, v, **kw):
    """The bf16 gate's control, a wrong call of the kernel: every causal
    attention windowed to half the prompt."""
    if kw["causal"]:
        kw = dict(kw, window=q.shape[1] // 2)
    return attn(q, k, v, **kw)


def fp32_cfg(cfg):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


def prefill_logits(cfg, impl, params, batch, *contexts):
    """The last-position logits of one prefill of ``cfg``'s model by
    ``impl`` under ``contexts``, and its launches (zeroed just before,
    read just after)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import Model
    step = make_prefill_step(Model(cfg, impl=impl))
    torch.cuda.synchronize()
    build.reset_launches()
    with contextlib.ExitStack() as stack:
        for ctx in contexts:
            stack.enter_context(ctx)
        logits, _ = step(params, batch)
    torch.cuda.synchronize()
    return logits, dict(build.LAUNCHES)


def fp32_budgets(cfg, p32, batch, plain_logits, pin=contextlib.nullcontext):
    """The plain and the kernel fp32 prefill of ``p32`` (the bf16 weights'
    values in fp32), each under a fresh ``pin()``. Returns the plain fp32
    logits, the bf16 budget (``plain_logits``, the plain bf16 prefill's,
    off them), the fp32 kernel prefill's deviation and its launches."""
    plain32, _ = prefill_logits(fp32_cfg(cfg), "xla", p32, batch, pin())
    kern32, launches32 = prefill_logits(fp32_cfg(cfg), "pallas", p32, batch,
                                        pin())
    return (plain32, logit_dev(plain_logits, plain32),
            logit_dev(kern32, plain32), launches32)


# phase 13's whole-model fp32 gate, at ``condition_``'s weights: the fp32
# kernel prefill's logits within this share of their scale of the plain
# fp32 prefill's. It sits between the sound kernel's readings (at most
# 6.929e-06) and those of a control that must fail it (at least 1.261e-05,
# gemma3), the same prefill with the attention's q, k and v rounded to
# TF32 (a kernel without the 3xTF32 split), near their geometric mean;
# PERF.md gives each arch's pair.
ZOO_FP32_RTOL = 9e-6
# phase 13's bf16 gates at ``condition_``'s weights hold two bf16
# computations of one function (kernel and plain prefill; decode step and
# prefill of S+1) to this many times the bf16 budget, the plain bf16
# prefill's distance from the plain fp32 one: two computations each as
# accurate as the plain one are at most twice that apart (the triangle
# inequality), and their own roundings differ as much as the budget.
ZOO_BF16_FACTOR = 2


def zoo_fp32_gates(cfg, p32, batch, plain_logits, plain_c, pins):
    """Phase 13's fp32 prefills of ``p32`` (the seed-0 weights' bf16
    values in fp32), which they empty. At the reference init: the bf16
    budget of ``plain_logits`` and the fp32 kernel prefill's launches.
    Then at ``condition_``'s weights (rounded through bf16, so the same
    weights as the bf16 runs there), every prefill routed as ``pins``
    recorded: the bf16 budget of ``plain_c``, the fp32 kernel prefill's
    deviation from the plain fp32 one, and the TF32 control's. Returns
    them in a dict."""
    import torch
    batch = {k: (v.float() if v.is_floating_point() else v)
             for k, v in batch.items()}
    _, budget, at_init, launches32 = fp32_budgets(cfg, p32, batch,
                                                  plain_logits)
    condition_(p32)
    round_through_(p32, cfg.param_torch_dtype)
    plain32, budget_c, dev32, _ = fp32_budgets(cfg, p32, batch, plain_c,
                                               pins.replay)
    control, _ = prefill_logits(fp32_cfg(cfg), "pallas", p32, batch,
                                pins.replay(), attention_called(tf32_inputs))
    p32.clear()
    torch.cuda.empty_cache()
    return dict(budget=budget, at_init=at_init, launches32=launches32,
                budget_c=budget_c, dev32=dev32,
                control=logit_dev(control, plain32))


def check_prefill_budgets(cfg, params, batch, logits, cache):
    """The kernel prefill (``logits``, ``cache``) against the same prefill
    through the plain versions: bf16 logits within the bf16 budget (the
    plain bf16 prefill's deviation from the plain fp32 one, same weights
    and tokens), and the fp32 kernel prefill within the plain fp32
    prefill's deviation when every weight moves one ulp. Prints each cache
    entry's deviation; returns the bf16 budget and the fp32 kernel
    prefill's launches (counts zeroed just before it, read just after)."""
    import torch
    plain_logits, dev = plain_bf16_dev(cfg, params, batch, logits, cache)
    p32 = {k: v.float() for k, v in params.items()}
    plain32, budget, dev32, launches32 = fp32_budgets(cfg, p32, batch,
                                                      plain_logits)
    # the model's own fp32 noise floor: every weight one ulp off, plain
    nudge_(p32, logits.device)
    nudged32, _ = prefill_logits(fp32_cfg(cfg), "xla", p32, batch)
    del p32
    torch.cuda.empty_cache()
    floor32 = logit_dev(nudged32, plain32)
    ok = dev <= budget and dev32 <= floor32
    say(f"  last-position logits, kernels vs plain: bf16 {dev:.3e} of the "
        f"scale {float(plain_logits.abs().max()):.4g}, bf16 budget "
        f"{budget:.3e} (plain bf16 vs plain fp32, same weights and tokens); "
        f"fp32 {dev32:.3e}, fp32 budget {floor32:.3e} (plain fp32 with "
        f"every weight one ulp off) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the kernel prefill deviates from the plain one "
                           "beyond its budget")
    say(f"  fp32 kernel prefill launches: {launches32}")
    return budget, launches32


def decode_run(cfg, model, params, batch, logits, cache, n_gen):
    """Move the prefill cache into a S + n_gen cache and greedy-decode
    n_gen tokens through ``make_serve_step``: the logits finite and the
    tokens in the vocabulary. Returns the ms a token (CUDA events)."""
    import torch
    from repro_torch.launch.steps import make_serve_step
    b, s = batch_bs(batch)
    serve = make_serve_step(model)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    warm = model.extend_cache(cache, s + n_gen)
    serve(params, warm, step_input(cfg, tok), s)        # warm-up
    del warm
    dcache = model.extend_cache(cache, s + n_gen)
    tokens = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n_gen):
        tok, step_logits, dcache = serve(params, dcache,
                                         step_input(cfg, tok), s + i)
        tokens.append(tok)
    end.record()
    torch.cuda.synchronize()
    decode_ms = start.elapsed_time(end) / n_gen
    DECODE_MS[cfg.name] = decode_ms
    gen = torch.stack(tokens, 1)
    say(f"  decode {decode_ms:.3f} ms/token over {n_gen} steps (CUDA "
        f"events, batch {b}: {b / decode_ms * 1e3:,.0f} tokens/s); sample "
        f"{gen[0, :8].tolist()}")
    if not (bool(torch.isfinite(step_logits).all())
            and int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size):
        raise RuntimeError("decode gave non-finite logits or bad tokens")
    return decode_ms


def first_step_dev(cfg, model, params, batch, logits, cache, prefix=None):
    """The first greedy decode step from a prefill's ``logits`` and
    ``cache`` against the last logits of a prefill of the prompt and that
    step's input (S + 1 positions). An MoE arch passes ``prefix``, the
    ``PinnedRouting`` that recorded (or pinned) the routing of the prefill
    that wrote ``cache``: the step's own choices are recorded and the
    longer prefill routed as prefix + step. Returns the deviation (None
    when the longer prefill drops an expert assignment: it is then not the
    step's function) and the longer prefill's launches (zeroed just
    before, read just after)."""
    import torch
    from repro_torch.launch.steps import make_serve_step
    b, s = batch_bs(batch)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    step = PinnedRouting()
    with step.record() if prefix else contextlib.nullcontext():
        _, first, _ = make_serve_step(model)(
            params, model.extend_cache(cache, s + 1), step_input(cfg, tok), s)
    with DropCount() as drops:
        longer, launches = prefill_logits(
            model.cfg, model.impl, params, longer_batch(cfg, batch, tok),
            prefix.replay(prefix.extended(step, b)) if prefix
            else contextlib.nullcontext())
    drops.report(f"the prefill of S+1 = {s + 1} positions")
    return (None if drops.dropped else logit_dev(first, longer)), launches


def decode_gate(dev_dec, budget, s, launches, where=""):
    ok = dev_dec <= budget
    say(f"  first decode step vs prefill of S+1 = {s + 1} positions"
        f"{where} (launches {launches}): {dev_dec:.3e} of the scale (limit "
        f"{budget:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("decode disagrees with prefill")


def decode_and_check(cfg, model, params, batch, logits, cache, budget,
                     n_gen):
    """``decode_run``, then the first decode step held against the
    prefill of S + 1 positions within the bf16 budget. Returns that
    prefill's launch counts."""
    decode_run(cfg, model, params, batch, logits, cache, n_gen)
    dev_dec, launches = first_step_dev(cfg, model, params, batch, logits,
                                       cache)
    decode_gate(dev_dec, budget, batch_bs(batch)[1], launches)
    return launches


def prefill_main_path(prefill, params, batch, want, timing=None, around=()):
    """The main path: one prefill with the launch counts zeroed just
    before and read just after (they must be ``want``), timed by CUDA
    events, under the contexts ``around``, then twice more; prints ms,
    tokens/s and peak memory (and puts the three times under "prefill_ms"
    in ``timing``)."""
    import torch
    from repro_torch.kernels import build
    b, s = batch_bs(batch)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with contextlib.ExitStack() as stack:
        for ctx in around:
            stack.enter_context(ctx)
        start.record()
        logits, cache = prefill(params, batch)
        end.record()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    prefill_ms = start.elapsed_time(end)
    say(f"  launches in one prefill: {launches}")
    if launches != want:
        raise RuntimeError(f"prefill launched {launches}, expected {want}")
    more = [cuda_ms(lambda: prefill(params, batch), reps=1, warmup=0)
            for _ in range(2)]
    say(f"  prefill {prefill_ms:.3f} ms (then {more[0]:.3f}, {more[1]:.3f}; "
        f"CUDA events), peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB, {b * s / prefill_ms * 1e3:,.0f} prompt tokens/s")
    if timing is not None:
        timing["prefill_ms"] = [prefill_ms] + more
    return logits, cache, launches


def profile_serving(model, params, batch, logits, cache, n_gen):
    """Profiler breakdowns of one prefill and one decode step."""
    import torch
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    b, s = batch_bs(batch)
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    profile_device(f"prefill B={b} S={s}", lambda: prefill(params, batch))
    dcache = model.extend_cache(cache, s + n_gen)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    profile_device(f"one decode step at position {s}", lambda: serve(
        params, dcache, step_input(model.cfg, tok), s))


def serve_cli(arch):
    say(f"  python -m repro_torch.launch.serve --arch {arch}:")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--arch", arch], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    for line in (out.stdout + out.stderr).strip().splitlines()[-4:]:
        say("    " + line)
    if out.returncode != 0:
        raise RuntimeError("the serve CLI failed")


def phase_serve(device="cuda"):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import concrete_batch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import Model
    b, s, n_gen = SERVE_B, SERVE_S, SERVE_GEN
    cfg = get_config("recurrentgemma-2b")
    say(f"== phase 5: {cfg.name} serving at full width ({cfg.n_layers} "
        f"layers {cfg.block_pattern}, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, window "
        f"{cfg.window}, {cfg.dtype}): B={b}, S={s}, {n_gen} decode tokens")
    model = Model(cfg)
    t0 = time.time()
    params = model.init(seed=0, device=device)
    torch.cuda.synchronize()
    say(f"  init {model.num_params():,} params in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    batch = concrete_batch(cfg, b, s, torch.Generator().manual_seed(1),
                           kind="prefill", device=device)
    prefill = make_prefill_step(model)
    with Recorder({"attention": "flash_attention",
                   "lru_scan": "rglru_scan"}) as rec:
        prefill(params, batch)                  # warm-up, inputs recorded
        torch.cuda.synchronize()
    logits, cache, launches = prefill_main_path(
        prefill, params, batch, {"flash_attention": 8, "rglru_scan": 18})
    if tuple(logits.shape) != (b, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise RuntimeError(f"prefill logits {tuple(logits.shape)} not finite")
    budget, launches32 = check_prefill_budgets(cfg, params, batch, logits,
                                               cache)
    if launches32.get("flash_attention") != launches["flash_attention"]:
        raise RuntimeError(f"the fp32 prefill launched {launches32}")
    decode_and_check(cfg, model, params, batch, logits, cache, budget, n_gen)

    say("  sequence kernels against their plain versions, at the prefill's "
        "inputs and ragged shapes:")
    results = check_and_time_seq(rec, seq_ragged_cases(device))
    del rec
    torch.cuda.empty_cache()
    profile_serving(model, params, batch, logits, cache, n_gen)
    say(f"  card during phase 5: "
        f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    del params, cache
    torch.cuda.empty_cache()
    serve_cli("recurrentgemma-2b")
    for name, row in results.items():
        row["launches"] = (launches32["flash_attention"] if name == FA32
                           else launches[name])
    return results


# ------------------------------------------------- phase 6: RWKV6 serving
def redraw_rwkv(params, seed):
    """Draw the reference init's zero tensors of the RWKV6 block anew
    (seeded), in place: w0 uniform in [-8, 1], w_lora_b and ts_lora_b
    N(0, 0.1), u N(0, 0.5), the mixing coefficients uniform in [0, 1].
    At the reference's init w is exp(-1) in every channel at every token,
    the bonus is 0 and the token shift does nothing, so the kernel would
    never meet a data-dependent decay."""
    import torch
    dev = next(iter(params.values())).device
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(shape, kind):
        if kind == "uniform":
            return torch.rand(shape, generator=g, device=dev)
        return torch.randn(shape, generator=g, device=dev)
    for key, val in params.items():
        name = key.rsplit("/", 1)[-1]
        if name == "w0":
            val.copy_(draw(val.shape, "uniform") * 9.0 - 8.0)
        elif name in ("w_lora_b", "ts_lora_b"):
            val.copy_(0.1 * draw(val.shape, "normal"))
        elif name == "u":
            val.copy_(0.5 * draw(val.shape, "normal"))
        elif name in ("mu", "mu_base", "mu_k", "mu_r"):
            val.copy_(draw(val.shape, "uniform"))


def phase_rwkv(device="cuda"):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import concrete_batch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import Model
    b, s, n_gen = SERVE_B, SERVE_S, SERVE_GEN
    cfg = get_config("rwkv6-7b")
    say(f"== phase 6: {cfg.name} serving at full width ({cfg.n_layers} "
        f"layers {cfg.block_pattern}, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, gla_chunk {cfg.gla_chunk}, {cfg.dtype}): B={b}, "
        f"S={s}, {n_gen} decode tokens")
    model = Model(cfg)
    t0 = time.time()
    params = model.init(seed=0, device=device)
    redraw_rwkv(params, seed=1)
    torch.cuda.synchronize()
    say(f"  init {model.num_params():,} params in {time.time() - t0:.1f} s "
        f"(decay, bonus and mixing tensors redrawn), "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    batch = concrete_batch(cfg, b, s, torch.Generator().manual_seed(1),
                           kind="prefill", device=device)
    prefill = make_prefill_step(model)
    w_seen = {"low": 0, "high": 0, "all": 0, "dtypes": set()}

    def w_share(kernel, args, kw):
        w = args[3]
        w_seen["low"] += int((w < 1e-3).sum())
        w_seen["high"] += int((w > 0.999).sum())
        w_seen["all"] += w.numel()
        w_seen["dtypes"].add((str(args[0].dtype), str(w.dtype)))
    with Recorder({"gla_chunked": "gla_chunked"}, observe=w_share) as rec:
        prefill(params, batch)                  # warm-up, inputs recorded
        torch.cuda.synchronize()
    say(f"  w on the path: {w_seen['low'] / w_seen['all']:.4f} below 1e-3, "
        f"{w_seen['high'] / w_seen['all']:.4f} above 0.999 over "
        f"{w_seen['all']:,} decays; (r, w) dtypes {sorted(w_seen['dtypes'])}")
    if w_seen["dtypes"] != {("torch.bfloat16", "torch.float32")}:
        raise RuntimeError("the RWKV layer must hand w to the kernel in fp32")
    logits, cache, launches = prefill_main_path(
        prefill, params, batch, {"gla_chunked": cfg.n_layers})
    if tuple(logits.shape) != (b, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise RuntimeError(f"prefill logits {tuple(logits.shape)} not finite")
    budget, _ = check_prefill_budgets(cfg, params, batch, logits, cache)
    # the S+1 prefill's inputs (the kernel at chunk 1) are kept too
    with Recorder({"gla_chunked": "gla_chunked"}) as rec1:
        s1 = decode_and_check(cfg, model, params, batch, logits, cache,
                              budget, n_gen)
    if s1 != {"gla_chunked": cfg.n_layers}:
        raise RuntimeError(f"the S+1 prefill (chunk 1) launched {s1}")

    say("  gla_chunked against its plain version, at the prefill's inputs "
        "and ragged shapes:")
    results = check_and_time_seq(rec, seq_ragged_cases(device))
    del rec
    say("  gla_chunked at the S+1 prefill's inputs (chunk 1):")
    row1 = check_and_time_seq(rec1, {"gla_chunked": []})["gla_chunked"]
    del rec1
    torch.cuda.empty_cache()
    profile_serving(model, params, batch, logits, cache, n_gen)
    say(f"  card during phase 6: "
        f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    say(f"  peak memory since the timed prefill "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params, cache
    torch.cuda.empty_cache()
    serve_cli("rwkv6-7b")
    for name, row in results.items():
        row["launches"] = launches[name]
    row1.update(launches=s1["gla_chunked"],
                cell=f"RWKV6-7B S+1 = {s + 1} prefill, chunk 1")
    return list(results.values()) + [row1]


# ------------------------------------------------------ phase 7: engines
# BENCH_engine.json's engine cells (benchmarks/bench_engine.py): 4 nodes,
# 2 a round, I_l = 2, 4 pairs a node, eta 1, eps 0.05, Eq. 6; data, params
# and the round drawn from seeds 0, 1 and 2.
ENGINE_WIDTHS = ((2, 3, 2), (3, 4, 3), (4, 5, 4), (3, 3, 3, 3))
# its certified approximate-rank cells (APPROX_SETS), same config
APPROX_SETS = (
    ((3, 4, 3), dict(interval_length=2, rank_tol=1e-3, rank_cap=6)),
    ((4, 5, 4), dict(interval_length=2, rank_tol=1e-3, rank_cap=6)),
    ((5, 6, 5), dict(interval_length=1, rank_tol=1e-3, rank_cap=4)),
    ((5, 6, 5), dict(interval_length=1, rank_tol=1e-3, rank_cap=4,
                     minibatch=2)),
)
# complex128 engines against one another: the reference's oracle budget
# (tests/test_engine_equivalence.py)
ENGINE_TOL = 1e-10


def engine_cell(widths, **overrides):
    """The config, data and params of one BENCH_engine.json cell."""
    import torch
    from repro_torch.core.quantum import data as qdata
    from repro_torch.core.quantum import federated as fed
    from repro_torch.core.quantum import qnn
    cfg = fed.QuantumFedConfig(**dict(
        dict(widths=widths, num_nodes=4, nodes_per_round=2,
             interval_length=2, eta=1.0, eps=0.05), **overrides))
    _, ds, _ = qdata.make_federated_dataset(
        torch.Generator().manual_seed(0), widths[0], 4, 4, n_test=4,
        device="cuda")
    params = qnn.init_params(torch.Generator().manual_seed(1), widths,
                             device="cuda")
    return cfg, ds, params


def max_dev(xs, ys):
    return max(float((x - y).abs().max()) for x, y in zip(xs, ys))


def engines_agree(card):
    """One round of every engine and impl at each engine width, from the
    same params and round seed: the complex128 engines against the dense
    oracle at ENGINE_TOL, every kernel round against it at ROUND_TOL; the
    kernels then held against their plain versions at every shape the
    kernel rounds recorded. Then ms/round of each (CUDA events, 10 rounds
    after a warm-up; 3 for dense at (4,5,4)) and the peak memory of each
    width's rounds."""
    import torch
    from repro_torch.core.quantum import federated as fed
    from repro_torch.core.quantum import qnn
    with Recorder() as rec:
        for widths in ENGINE_WIDTHS:
            cfg, ds, params = engine_cell(widths)
            out = {}
            for engine in qnn.ENGINES:
                for impl in qnn.IMPLS:
                    out[engine, impl] = fed.server_round(
                        params, ds, torch.Generator().manual_seed(2),
                        cfg._replace(engine=engine, impl=impl))
            oracle = out["dense", "xla"]
            devs = {key: max_dev(p, oracle) for key, p in out.items()
                    if key != ("dense", "xla")}
            bad = [key for key, d in devs.items()
                   if d > (ENGINE_TOL if key[1] == "xla" else ROUND_TOL)]
            say(f"  {widths}: one round against the dense oracle "
                f"(complex128 tol {ENGINE_TOL:.0e}, kernels {ROUND_TOL:.0e}): "
                + ", ".join(f"{e}/{i} {d:.3e}" for (e, i), d in devs.items())
                + (" ok" if not bad else f" FAIL {bad}"))
            if bad:
                raise RuntimeError(f"engines disagree at {widths}: {bad}")
    say("  the kernel rounds' every shape against the plain versions:")
    check_and_time(rec, {}, names=("zgemm", "ensemble_commutator_trace"),
                   timed=False)
    del rec
    timing = {}
    for widths in ENGINE_WIDTHS:
        cfg, ds, params = engine_cell(widths)
        torch.cuda.reset_peak_memory_stats()
        for engine in qnn.ENGINES:
            for impl in qnn.IMPLS:
                reps = 3 if engine == "dense" and widths == (4, 5, 4) else 10
                ms = round_ms(cfg._replace(engine=engine, impl=impl), ds,
                              params, reps)
                timing[f"{widths} {engine} {impl}"] = ms
                say(f"  {widths} engine={engine} impl={impl}: {ms:.3f} "
                    f"ms/round (CUDA events, {reps} rounds after a warm-up; "
                    f"{card})")
        say(f"  {widths}: peak memory of these rounds "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return timing


def opb_zgemm_rows():
    """One ``local_opb`` round of phase 4's (4,5,4) cell (N_p = 10, 4 pairs
    a node) with the kernels, launch counts zeroed just before and read
    just after: it must launch zgemm, 18 times at the av^H B_j shapes
    ((40,1,512) and (40,16,512) conjugated, against (40,512,512)), and
    agree with its complex128 round and the local engine's. Every zgemm
    shape it records is checked and timed; the rows carry their launches
    in the round. Counts the operands ``ops._dense`` copied."""
    import torch
    from repro_torch.core.quantum import federated as fed
    from repro_torch.kernels import build
    cfg, ds, _, params = main_cell(widths=(4, 5, 4), num_nodes=20)
    cfg = cfg._replace(engine="local_opb")
    with Recorder() as rec:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        p_k = fed.server_round(params, ds, torch.Generator().manual_seed(9),
                               cfg)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_shape = {key: seen[0] for key, seen in rec.calls["zgemm"].items()}
    big = {key: n for key, n in per_shape.items()
           if key[1] == (40, 512, 512)}
    say(f"  (4,5,4) N=20 local_opb round with the kernels: launches "
        f"{launches}, {sum(big.values())} at the av^H B_j shapes; peak "
        f"memory {peak:.3f} GiB")
    if launches.get("zgemm", 0) == 0 or sum(big.values()) != 18:
        raise RuntimeError("the local_opb round did not run zgemm at its "
                           "operator shapes 18 times")
    if sum(per_shape.values()) != launches["zgemm"]:
        raise RuntimeError("zgemm: the round's calls and launches disagree")
    copies = [(cnt, sum(16 * x.numel() for x in args if layout(x) != "dense"))
              for cnt, args, _ in rec.calls["zgemm"].values()
              if any(layout(x) != "dense" for x in args)]
    say(f"  ops._dense copied an operand in {sum(c for c, _ in copies)} of "
        f"the round's {launches['zgemm']} zgemm calls, "
        f"{sum(c * b for c, b in copies) / 1e6:.3f} MB in all (the "
        f"conjugated av; every B_j reached the kernel dense)")
    for impl, engine in (("xla", "local_opb"), ("xla", "local")):
        p_x = fed.server_round(params, ds, torch.Generator().manual_seed(9),
                               cfg._replace(impl=impl, engine=engine))
        dev = max_dev(p_k, p_x)
        say(f"  against the {engine} round in complex128: {dev:.3e} "
            f"(tol {ROUND_TOL:.0e}) {'ok' if dev <= ROUND_TOL else 'FAIL'}")
        if dev > ROUND_TOL:
            raise RuntimeError("local_opb: kernels disagree with complex128")
    rows = []
    for row in check_and_time(rec, {}, names=("zgemm",))["zgemm"]:
        rows.append(dict(row, launches=per_shape[row["key"]],
                         cell="(4,5,4) local_opb"))
    return rows


def certified_sweep(card):
    """The certified approximate-rank cells: ``server_round_certified``
    under both impls (the kernel round's launches zeroed before and read
    after: the trace kernel and zgemm must run; its kernel shapes held
    against the plain versions), approximate and exact ms/round (CUDA
    events, 3 rounds after a warm-up), and on the round's node batch (its
    two nodes, the first minibatch-sized slice of each) the max-abs
    deviation of the approximate K's from the exact local engine's,
    node by node, at most that node's certificate (the kernel path plus
    the kernels' fp32 budget of the K's scale). Raises otherwise."""
    import torch
    from repro_torch.core.quantum import federated as fed
    from repro_torch.core.quantum import qnn
    from repro_torch.kernels import build
    results = []
    for widths, knobs in APPROX_SETS:
        cfg, ds, params = engine_cell(widths, **knobs)
        exact = cfg._replace(rank_tol=0.0, rank_cap=None)
        label = f"{widths} {knobs}"
        bounds, ms = {}, {}
        for impl in qnn.IMPLS:
            c = cfg._replace(impl=impl)
            with Recorder() as rec:
                torch.cuda.synchronize()
                build.reset_launches()
                p, _, bound = fed.server_round_certified(
                    params, ds, torch.Generator().manual_seed(2), c)
                torch.cuda.synchronize()
                launches = dict(build.LAUNCHES)
            if impl == "pallas":
                if not (launches.get("zgemm") and launches.get(
                        "ensemble_commutator_trace")):
                    raise RuntimeError(f"{label}: the certified kernel round "
                                       f"launched {launches}")
                check_and_time(rec, {}, names=("zgemm",
                                               "ensemble_commutator_trace"),
                               timed=False)
            del rec
            if unitarity_err(p) > ROUND_TOL:
                raise RuntimeError(f"{label}: params left the unitaries")
            bounds[impl] = float(bound)
            ms[impl] = (round_ms(c, ds, params, 3),
                        round_ms(exact._replace(impl=impl), ds, params, 3))
        # the certificate is linear algebra outside the kernels; the
        # rounds' later steps start from params the kernels moved by ~1e-7
        if abs(bounds["pallas"] - bounds["xla"]) > ROUND_TOL * bounds["xla"]:
            raise RuntimeError(f"{label}: the kernel round's certificate is "
                               f"not the complex128 round's {bounds}")
        mb = cfg.minibatch or ds.phi_in.shape[1]
        phi_in, phi_out = ds.phi_in[:2, :mb], ds.phi_out[:2, :mb]
        p2 = [u.expand((2,) + u.shape) for u in params]
        k_exact = qnn.update_matrices(p2, phi_in, phi_out, widths, cfg.eta)
        scale = max(float(k.abs().max()) for k in k_exact)
        for impl in qnn.IMPLS:
            k_apx, b = qnn.update_matrices(
                p2, phi_in, phi_out, widths, cfg.eta, impl=impl,
                rank_tol=cfg.rank_tol, rank_cap=cfg.rank_cap, with_bound=True)
            dev = torch.stack([(a - e).abs().reshape(2, -1).amax(-1)
                               for a, e in zip(k_apx, k_exact)]).amax(0)
            slack = 0.0 if impl == "xla" else KERNEL_RTOL * scale
            ok = bool((dev <= b + slack + 1e-12).all())
            say(f"  {label} impl={impl}: approx {ms[impl][0]:.3f} ms/round, "
                f"exact local {ms[impl][1]:.3f} ms/round ({card}); round "
                f"err_bound {bounds[impl]:.6g}; node batch: max |K - K_exact| "
                f"{dev.tolist()} <= certificate {b.tolist()}"
                f"{f' + {slack:.2e}' if slack else ''} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{label}: the certificate does not "
                                   "dominate the deviation")
            results.append(dict(widths=list(widths), impl=impl, **knobs,
                                approx_ms=ms[impl][0], exact_ms=ms[impl][1],
                                err_bound=bounds[impl]))
    return results


def phase_engines():
    """Phase 7: the quantum engine family on the card."""
    card = smi("name,power.limit")
    say("== phase 7: engines local, local_opb and dense, both impls, at "
        "BENCH_engine.json's cells (4 nodes, 2 a round, I_l = 2, 4 pairs a "
        "node); the local_opb zgemm shapes; the certified approximate-rank "
        "cells")
    t0 = time.time()
    engines_agree(card)
    rows = opb_zgemm_rows()
    certified_sweep(card)
    say(f"  phase 7 took {time.time() - t0:.1f} s")
    return rows


# ------------------------------------------------------ phase 8: fed core
# benchmarks/bench_robust.py's grid: its strategies (STRATEGIES, lines
# 48-56), their families, 20 nodes with 10 a round, I_l = 2, 4 pairs a
# node, 16 test pairs (the screen's probe), eta 1, eps 0.1, 60 rounds
ROBUST_STRATEGIES = {
    "none_avg": dict(aggregation="average"),
    "none_prod": dict(aggregation="product"),
    "clip": dict(aggregation="average", defense="clip", clip_norm=0.5),
    "trimmed_mean": dict(aggregation="average", defense="trimmed_mean",
                         trim_frac=0.3),
    "median": dict(aggregation="average", defense="median"),
    "screen": dict(aggregation="product", defense="screen",
                   screen_tol=0.005),
}
ROBUST_FAMILY = {"none_avg": "none_avg", "clip": "none_avg",
                 "trimmed_mean": "none_avg", "median": "none_avg",
                 "none_prod": "none_prod", "screen": "none_prod"}
ROBUST_N, ROBUST_BYZ, ROBUST_ROUNDS = 20, 0.2, 60
# the bench's gate: a defended strategy keeps this share of its family's
# clean fidelity under the Byzantine attack; the undefended average not
ROBUST_KEEP = 0.95
# bench_serve.py's SPEC_A, the multi-tenant serving regime, at a group of
# 300 slots; the solo baseline runs SOLO_CAP of them (its SEQ_CAP idea)
STACK_S, SOLO_CAP, STACK_CHECKED = 300, 30, 8


def scan_byzantine_seed(rate, target_hits, num_nodes=ROBUST_N,
                        max_seed=2000):
    """bench_robust.py's scan: the first fault seed whose persistent
    sign-flip draw marks exactly ``target_hits`` of ``num_nodes``."""
    from repro_torch.core.fed import faults
    for seed in range(max_seed):
        model = faults.DrawFault("sign_flip", rate, seed, 1.0)
        if sum(model.hits(n, 0) for n in range(num_nodes)) == target_hits:
            return seed
    raise RuntimeError(f"no seed under {max_seed} marks {target_hits}")


def robust_attacks(byz_seed):
    """bench_robust.py's attacks: kind, rate, seed, scale."""
    return {"clean": None, "byz20": ("sign_flip", ROBUST_BYZ, byz_seed, 5.0),
            "crash30": ("crash", 0.3, 11, 3.0)}


def robust_spec(strategy, attack=None, **overrides):
    """bench_robust.py's cell as a spec: phase 3's widths, N=20, N_p=10,
    I_l=2, 4 pairs a node, 16 test pairs (the screen's probe), data seed
    7, the kernels; ``strategy`` from ROBUST_STRATEGIES, ``attack`` a
    (kind, rate, seed, scale) of ``robust_attacks`` or None."""
    fault = {} if attack is None else dict(
        zip(("fault_model", "fault_rate", "fault_seed", "fault_scale"),
            attack))
    return main_spec(num_nodes=ROBUST_N, n_test=16, data_seed=7,
                     **ROBUST_STRATEGIES[strategy], **fault, **overrides)


def robust_setup():
    """bench_robust.py's cell in the port: the data from the spec's
    recipe (seed 7), params from seed 0."""
    import torch
    from repro_torch.core.fed import api
    from repro_torch.core.quantum import qnn
    sub = api.QuantumSubstrate(robust_spec("none_avg"))
    params = qnn.init_params(torch.Generator().manual_seed(0), (2, 3, 2),
                             device="cuda")
    return sub.dataset, sub.test, params


def robust_session(strategy, attack, ds, test, params):
    """A session of the robust cell from the given data and params; its
    sync scheduler applies the attack's faults (``_robust_step``)."""
    from repro_torch.core.fed import api
    spec = robust_spec(strategy, attack)
    sub = api.QuantumSubstrate(spec, dataset=ds, test=test)
    return api.FederationSession.create(spec, 0, substrate=sub,
                                        params=params)


def robust_grid(card):
    """The 6 x 3 defense x attack grid, 60 faulted rounds a cell through
    the session's sync scheduler, beside the reference's CPU grid; the
    bench's two gates; one round of corrupt uploads."""
    import torch
    from repro_torch.core.fed.api import rng
    ds, test, params0 = robust_setup()
    byz_seed = scan_byzantine_seed(ROBUST_BYZ, int(round(ROBUST_BYZ
                                                         * ROBUST_N)))
    ref = json.loads((ROOT / "BENCH_robust.json").read_text())
    say(f"  sign-flip seed scan: {byz_seed} (BENCH_robust.json: "
        f"{ref['byz_seed']})")
    if byz_seed != ref["byz_seed"]:
        raise RuntimeError("the fault draws disagree with the reference's")
    grid, per, t0, n_rounds = {}, {}, time.time(), 0
    for sname in ROBUST_STRATEGIES:
        grid[sname] = {}
        torch.cuda.synchronize()
        t1 = time.time()
        for aname, attack in robust_attacks(byz_seed).items():
            sess = robust_session(sname, attack, ds, test, params0)
            sess.run(ROBUST_ROUNDS)
            n_rounds += ROBUST_ROUNDS
            grid[sname][aname] = sess.evaluate()["test_fidelity"]
        per[sname] = 1e3 * (time.time() - t1) / (3 * ROBUST_ROUNDS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    say(f"  {n_rounds} rounds through the session's sync scheduler with "
        f"the kernels in {wall:.1f} s ({1e3 * wall / n_rounds:.2f} ms a "
        f"round with its host fault loop, {card}); final test fidelity, "
        f"this port on the card | the reference's CPU grid "
        f"(BENCH_robust.json, {ref['rounds']} rounds, its own draws):")
    for sname, row in grid.items():
        say(f"    {sname:>13s}: " + ", ".join(
            f"{a} {v:.6f} | {ref['grid'][sname][a]:.6f}"
            for a, v in row.items()) + f"; {per[sname]:.2f} ms a round")
    keep = {s: grid[s]["byz20"] / max(grid[ROBUST_FAMILY[s]]["clean"], 1e-12)
            for s in ROBUST_STRATEGIES}
    defended = [s for s in ROBUST_STRATEGIES if s not in ("none_avg",
                                                          "none_prod")]
    best = max(defended, key=lambda s: keep[s])
    holds, breaks = keep[best] >= ROBUST_KEEP, keep["none_avg"] < ROBUST_KEEP
    say("  byz20 retention of the family's clean fidelity: " + ", ".join(
        f"{s} {v:.4f} (ref {ref['byz20_retention'][s]})"
        for s, v in keep.items()))
    say(f"  gates: best defended {best} {keep[best]:.4f} >= {ROBUST_KEEP} "
        f"{'ok' if holds else 'FAIL'}; undefended average "
        f"{keep['none_avg']:.4f} < {ROBUST_KEEP} "
        f"{'ok' if breaks else 'FAIL'}")
    if not (holds and breaks):
        raise RuntimeError("the robust grid's gates do not hold")
    # one round of corrupt (NaN) uploads at 30%
    corrupt = ("corrupt", 0.3, 2, 5.0)
    fids = {}
    for sname in ("none_avg", "median", "screen"):
        sess = robust_session(sname, corrupt, ds, test, params0)
        sel = sess.substrate.select(rng.generator(sess.round_key(0)), 0).sel
        model = sess.scheduler.faults
        hit = sum(model.hits(n, 0) for n in sel.tolist())
        sess.step()
        fids[sname] = sess.evaluate()["test_fidelity"]
        if hit == 0:
            raise RuntimeError("the corrupt draw hit no selected node")
    ok = (fids["none_avg"] != fids["none_avg"]
          and all(fids[s] == fids[s] for s in ("median", "screen")))
    say(f"  one round of 30% corrupt uploads: test fidelity " + ", ".join(
        f"{s} {v:.6f}" for s, v in fids.items())
        + f" (undefended NaN, defended finite) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("corrupt uploads: undefended must go NaN, "
                           "defended stay finite")


def channel_rounds(card):
    """On phase 3's cell: one round of Hermitian upload noise and of 8-bit
    quantisation, and 3 rounds of the Eq. 8 average with server momentum
    and with Nesterov momentum: each kernel round against the complex128
    round from the same params, selection and draws, and unitary."""
    import torch
    from repro_torch.core.quantum import federated as fed
    cfg0, ds, _, params0 = main_cell()
    cases = [("hermitian noise 0.1", dict(upload_noise=0.1), "none", 1),
             ("8-bit quantisation", dict(quantize_bits=8), "none", 1),
             ("average + momentum", dict(aggregation="average"), "momentum",
              3),
             ("average + nesterov", dict(aggregation="average"), "nesterov",
              3)]
    for label, kw, server_opt, rounds in cases:
        cfg_k = cfg0._replace(**kw)
        state = {impl: (params0, None) for impl in ("pallas", "xla")}
        for r in range(rounds):
            out = {}
            for impl in ("pallas", "xla"):
                p, m = state[impl]
                g = torch.Generator().manual_seed(40 + r)
                sel, _, w = fed.select_phase(ds, g, cfg_k)
                ks = fed.local_phase(p, ds, sel, g, cfg_k._replace(impl=impl))
                tx = fed.transmit_phase(ks, g, cfg_k)
                out[impl] = (fed.aggregate_phase(
                    p, tx, w, cfg_k._replace(impl=impl), smom=m,
                    server_opt=server_opt), tx)
                state[impl] = out[impl][0]
            dev = max_dev(state["pallas"][0], state["xla"][0])
            u_err = unitarity_err(state["pallas"][0])
            ok = dev <= ROUND_TOL and u_err <= ROUND_TOL
            note = ""
            if not ok and "quantize_bits" in kw and u_err <= ROUND_TOL:
                # stochastic rounding is discontinuous: an element whose
                # uniform falls between the two rounds' fractional parts
                # lands one grid step apart. Count those; the kernel
                # combine is then held on the complex128 round's uploads.
                flips = quantize_flips(out["pallas"][1], out["xla"][1],
                                       kw["quantize_bits"])
                again, _ = fed.aggregate_phase(params0, out["xla"][1], w,
                                               cfg_k, server_opt=server_opt)
                dev2 = max_dev(again, out["xla"][0][0])
                ok = flips > 0 and dev2 <= ROUND_TOL
                note = (f"; {flips} rounding decisions flipped, the kernel "
                        f"combine on the complex128 uploads {dev2:.3e}")
            say(f"  {label}, round {r + 1}: kernels vs complex128 "
                f"{dev:.3e}, unitarity {u_err:.3e} (tol {ROUND_TOL:.0e})"
                f"{note} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{label}: the kernel round disagrees")
        if server_opt != "none" and state["pallas"][1] is None:
            raise RuntimeError(f"{label}: no momentum state")
    # ms/round of each (CUDA events, 10 rounds after a warm-up)
    for label, kw, server_opt, _ in cases:
        cfg_k = cfg0._replace(**kw)
        gen = torch.Generator().manual_seed(5)
        fed.server_round_opt(params0, None, ds, gen, cfg_k,
                             server_opt=server_opt)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        p, m = params0, None
        for _ in range(10):
            p, m = fed.server_round_opt(p, m, ds, gen, cfg_k,
                                        server_opt=server_opt)
        end.record()
        torch.cuda.synchronize()
        say(f"  {label}: {start.elapsed_time(end) / 10:.3f} ms/round with "
            f"the kernels ({card})")


def quantize_flips(xs, ys, bits):
    """Elements of two quantised upload lists more than half a grid step
    apart, per real and imaginary part (the grid: max |part| over
    2^{bits-1} - 1 levels)."""
    levels = 2 ** (bits - 1) - 1
    n = 0
    for x, y in zip(xs, ys):
        for a, b in ((x.real, y.real), (x.imag, y.imag)):
            n += int(((a - b).abs() > 0.5 * b.abs().max() / levels).sum())
    return n


def schedule_checks(card):
    """weighted and dropout (0.3) rounds on phase 3's cell against their
    complex128 rounds; 200 dropout draws with no all-dropped mask; the
    sampled draw at N = 1,000,000, N_p = 10 (auto must pick Floyd), and
    ms per draw of the dense and the sampled methods there."""
    import torch
    from repro_torch.core.fed import participation
    from repro_torch.core.quantum import federated as fed
    cfg0, ds, _, params = main_cell()
    for label, kw in (("weighted", dict(participation="weighted")),
                      ("dropout 0.3", dict(participation="dropout",
                                           dropout_rate=0.3))):
        c = cfg0._replace(**kw)
        out = {impl: fed.server_round(params, ds,
                                      torch.Generator().manual_seed(3),
                                      c._replace(impl=impl))
               for impl in ("pallas", "xla")}
        sel, mask, w = fed.select_phase(ds, torch.Generator().manual_seed(3),
                                        c)
        dev = max_dev(out["pallas"], out["xla"])
        ok = (dev <= ROUND_TOL and len(set(sel.tolist())) == 10
              and abs(float(w.sum()) - 1.0) <= 1e-6 and float(mask.sum()) >= 1)
        say(f"  {label}: sel {sel.tolist()}, mask {mask.tolist()}, weights "
            f"sum {float(w.sum()):.7f}; kernel round vs complex128 {dev:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label} participation failed")
    g = torch.Generator().manual_seed(1)
    dropped = sum(float(participation.sample_nodes(
        g, 100, 10, device="cuda", schedule="dropout",
        dropout_rate=0.3)[1].sum()) == 0.0 for _ in range(200))
    if dropped:
        raise RuntimeError("dropout returned an all-dropped mask")
    n, k = 1_000_000, 10
    auto = participation.sample_nodes(torch.Generator().manual_seed(2), n, k,
                                      device="cuda")[0]
    floyd = participation.sample_nodes(torch.Generator().manual_seed(2), n, k,
                                       device="cuda", method="sampled")[0]
    dense = participation.sample_nodes(torch.Generator().manual_seed(2), n, k,
                                       device="cuda", method="dense")[0]
    ok = (torch.equal(auto, floyd) and not torch.equal(auto, dense)
          and len(set(auto.tolist())) == k and 0 <= int(auto.min())
          and int(auto.max()) < n)
    times = {}
    for method in ("dense", "sampled"):
        g = torch.Generator().manual_seed(4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            participation.sample_nodes(g, n, k, device="cuda", method=method)
        torch.cuda.synchronize()
        times[method] = (time.perf_counter() - t0) / 20 * 1e3
    say(f"  N = {n:,}, N_p = {k}: auto drew {auto.tolist()} = Floyd's draw, "
        f"not the dense one, distinct and in range {'ok' if ok else 'FAIL'}; "
        f"200 dropout draws, none all-dropped; ms per draw (host clock, "
        f"20 draws, CPU generator, result on the card): dense "
        f"{times['dense']:.3f}, sampled {times['sampled']:.3f} ({card})")
    if not ok:
        raise RuntimeError("the sampled draw is not Floyd's or not valid")


def stack_cell(s=STACK_S):
    """bench_serve.py's SPEC_A group at s slots: widths (2,3,2), N = 2,
    N_p = 2, 2 pairs a node, I_l = 1, Eq. 8 average; one dataset shared
    by the group (as the bench builds it), each slot's params from its
    own seed, eta 0.5 + (i % 7) * 0.25 (the bench's tenants) and eps
    0.05 + (i % 5) * 0.025."""
    import torch
    from repro_torch.core.quantum import data as qdata
    from repro_torch.core.quantum import federated as fed
    from repro_torch.core.quantum import qnn
    _, ds, _ = qdata.make_federated_dataset(
        torch.Generator().manual_seed(0), 2, 2, 2, n_test=2, device="cuda")
    solo = [qnn.init_params(torch.Generator().manual_seed(100 + i),
                            (2, 3, 2), device="cuda") for i in range(s)]
    params = [torch.stack(x) for x in zip(*solo)]
    sds = qdata.QuantumDataset(ds.phi_in.expand((s,) + ds.phi_in.shape),
                               ds.phi_out.expand((s,) + ds.phi_out.shape))
    eta = torch.tensor([0.5 + (i % 7) * 0.25 for i in range(s)],
                       dtype=torch.float64, device="cuda")
    eps = torch.tensor([0.05 + (i % 5) * 0.025 for i in range(s)],
                       dtype=torch.float64, device="cuda")
    cfg = fed.QuantumFedConfig(widths=(2, 3, 2), num_nodes=2,
                               nodes_per_round=2, interval_length=1,
                               aggregation="average", impl="pallas")
    return cfg, ds, sds, solo, params, eta, eps


def stacked_rounds(card):
    """One stacked round of STACK_S slots with and without momentum under
    both impls: STACK_CHECKED slots against solo ``server_round_opt``
    calls from the same state and generator (1e-10 in complex128,
    ROUND_TOL with the kernels); the stacked kernel round's launches
    (counts zeroed before, read after) against one solo kernel round's;
    ms per stacked round against SOLO_CAP solo rounds scaled to
    STACK_S, and the peak memory; then the batched eigh of the node
    pass's K's at this size, plain and through ``eigh_herm``'s finite
    mask (ms and the peak above its input)."""
    import torch
    from repro_torch.core.quantum import federated as fed
    from repro_torch.kernels import build
    cfg, ds, sds, solo, params, eta, eps = stack_cell()
    s = STACK_S

    def gens():
        return [torch.Generator().manual_seed(1000 + i) for i in range(s)]
    for server_opt in ("none", "momentum"):
        for impl in ("xla", "pallas"):
            c = cfg._replace(impl=impl)
            smom = None         # round 0: the zero momentum state
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launches()
            got, new_m, _ = fed.server_round_stacked(
                params, sds, gens(), c, smom=smom, eta=eta, eps=eps,
                server_opt=server_opt)
            torch.cuda.synchronize()
            stacked = dict(build.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2**30
            build.reset_launches()
            fed.server_round_opt(solo[0], None, ds,
                                 torch.Generator().manual_seed(1000), c._replace(
                                     eta=float(eta[0]), eps=float(eps[0])),
                                 server_opt=server_opt)
            torch.cuda.synchronize()
            one = dict(build.LAUNCHES)
            tol = ENGINE_TOL if impl == "xla" else ROUND_TOL
            dev = 0.0
            for i in range(STACK_CHECKED):
                want, want_m = fed.server_round_opt(
                    solo[i], None, ds, torch.Generator().manual_seed(1000 + i),
                    c._replace(eta=float(eta[i]), eps=float(eps[i])),
                    server_opt=server_opt)
                dev = max(dev, max_dev([x[i] for x in got], want))
                if server_opt != "none":
                    dev = max(dev, max_dev([x[i] for x in new_m], want_m))
            ok = dev <= tol and (impl == "xla" or (stacked == one
                                                    and stacked))
            say(f"  stacked S={s} server_opt={server_opt} impl={impl}: "
                f"{STACK_CHECKED} slots vs solo rounds {dev:.3e} (tol "
                f"{tol:.0e}); launches stacked {stacked} vs one solo round "
                f"{one}; peak memory {peak:.3f} GiB "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError("the stacked round disagrees with solo "
                                   "rounds or launches more kernels")
            # ms: one stacked round, and SOLO_CAP solo rounds
            st_ms = cuda_ms(lambda: fed.server_round_stacked(
                params, sds, gens(), c, smom=smom, eta=eta, eps=eps,
                server_opt=server_opt), reps=5, warmup=1)
            g = torch.Generator().manual_seed(7)

            def solo_rounds():
                for i in range(SOLO_CAP):
                    fed.server_round_opt(solo[i], None, ds, g, c._replace(
                        eta=float(eta[i]), eps=float(eps[i])),
                        server_opt=server_opt)
            so_ms = cuda_ms(solo_rounds, reps=1, warmup=1)
            scaled = so_ms * s / SOLO_CAP
            say(f"    {st_ms:.3f} ms per stacked round of {s} slots; "
                f"{SOLO_CAP} solo rounds {so_ms:.3f} ms, scaled to {s}: "
                f"{scaled:.3f} ms ({scaled / st_ms:.1f}x the stacked round; "
                f"CUDA events, {card})")
    # the peak is the batched eigh of the node pass's K's: cuSOLVER's
    # workspace, and what the finite mask of eigh_herm adds to it
    from repro_torch.core.quantum import linalg as ql
    g = torch.Generator().manual_seed(8)
    for shape in ((2 * s, 3, 8, 8), (2 * s, 2, 16, 16)):
        a = torch.randn(shape, generator=g, dtype=torch.complex128).cuda()
        k = a + a.mH
        for label, fn in (("torch.linalg.eigh", torch.linalg.eigh),
                          ("eigh_herm", ql.eigh_herm)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn(k)
            torch.cuda.synchronize()
            extra = (torch.cuda.max_memory_allocated() - base) / 2**20
            say(f"  {label} of {shape} complex128 (the node pass's K's): "
                f"{cuda_ms(fn, k, reps=20, warmup=2):.4f} ms, peak "
                f"{extra:.1f} MiB above its input ({card})")


def phase_fed_core():
    """Phase 8: the rest of the fed core on the card."""
    import torch
    from repro_torch.core.quantum import federated as fed
    card = smi("name,power.limit")
    say("== phase 8: fed core: bench_robust.py's defense x attack grid, "
        "upload channels and server momentum, participation schedules, the "
        "stacked multi-tenant round")
    t0 = time.time()
    robust_grid(card)
    channel_rounds(card)
    schedule_checks(card)
    stacked_rounds(card)
    # the kernels at the shapes this phase brings: one screened round of
    # the grid (candidate chains, the probe's densities and fidelities),
    # one stacked kernel round
    rows = []
    ds, test, params = robust_setup()
    cells = [("screen round (2,3,2) N=20", robust_session(
        "screen", None, ds, test, params).step)]
    scfg, _, sds, _, sparams, eta, eps = stack_cell()
    cells.append((f"stacked S={STACK_S} SPEC_A", lambda: fed.server_round_stacked(
        sparams, sds, [torch.Generator().manual_seed(i)
                       for i in range(STACK_S)], scfg, eta=eta, eps=eps)))
    for label, run in cells:
        with Recorder() as rec:
            run()
            torch.cuda.synchronize()
        say(f"  kernels at the shapes of one {label}:")
        names = tuple(n for n in ("zgemm", "ensemble_commutator_trace",
                                  "fidelity") if rec.calls[n])
        timed = check_and_time(rec, {}, names=names)
        for name in names:
            for row in timed[name]:
                rows.append(dict(row, launches=rec.calls[name][row["key"]][0],
                                 cell=label))
    say(f"  phase 8 took {time.time() - t0:.1f} s")
    return rows


# ------------------------------------------------- phase 9: the API
# the faulted sync runs: phase 8's crash and Byzantine models on its cell
# under the median defense, with a round deadline (s of simulated latency,
# the counter model, seed 0) that leaves fewer than API_MIN_SURVIVORS of
# the 10 uploads on time in some round, so those rounds re-dispatch
API_DEADLINE, API_MIN_SURVIVORS, API_ROUNDS = 1.0, 6, 10


def resume_checks(card):
    """A 4-round session cut after 2 rounds, saved, resumed (from the file
    alone: spec, data recipe, state, RNG and in-flight uploads) and run
    2 more, against the straight 4-round run: params and history bit for
    bit, under sync, overlapped and async (K = 3 of N_p = 10, so uploads
    are in flight at the cut). The robust cell with the kernels."""
    import tempfile
    import torch
    from repro_torch.core.fed import api
    cases = {"sync": {}, "overlapped": dict(schedule="overlapped"),
             "async": dict(schedule="async", async_commit=3)}
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        for name, kw in cases.items():
            spec = robust_spec("none_prod", **kw)
            straight = api.FederationSession.create(spec, 3)
            straight.run(4, callbacks=[api.EvalEvery(2)])
            killed = api.FederationSession.create(spec, 3)
            killed.run(2, callbacks=[api.EvalEvery(2)])
            sched = killed.scheduler
            in_flight = (len(sched.entries) if name == "async" else
                         int(getattr(sched, "pending", None) is not None))
            path = os.path.join(tmp, f"{name}.npz")
            t0 = time.time()
            killed.save(path)
            save_ms = (time.time() - t0) * 1e3
            del killed
            t0 = time.time()
            resumed = api.FederationSession.resume(path)
            resume_ms = (time.time() - t0) * 1e3
            resumed.run(2, callbacks=[api.EvalEvery(2)])
            torch.cuda.synchronize()
            same = (all(torch.equal(a, b) for a, b in zip(straight.state,
                                                          resumed.state))
                    and resumed.history == straight.history)
            say(f"  kill at round 2, save ({save_ms:.1f} ms), resume "
                f"({resume_ms:.1f} ms, the data rebuilt from the recipe), "
                f"2 more rounds, schedule={name}: {in_flight} in flight at "
                f"the cut; equal to the straight run bit for bit: {same}")
            if not same or (name != "sync" and not in_flight):
                raise RuntimeError(f"kill-and-resume under {name} is not "
                                   "bit-exact on the card")


def scheduler_commits(card, commits=10):
    """``commits`` commits of the async (K = N_p / 2 = 5) and overlapped
    schedulers on phase 3's cell: ms/commit (host clock around the
    commits, ended by a synchronize), the simulated clock, and the
    params unitary and finite."""
    import torch
    from repro_torch.core.fed import api
    for name, kw in (("async", dict(schedule="async")),
                     ("overlapped", dict(schedule="overlapped"))):
        sess = api.FederationSession.create(main_spec(**kw), 7)
        sess.step()                                    # warm-up commit
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.run(commits)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / commits
        u_err = unitarity_err(sess.state)
        fid = sess.evaluate()["test_fidelity"]
        clock = sess.sim_clock
        extra = (f", {len(sess.scheduler.entries)} uploads buffered, "
                 f"{sess.scheduler.dispatched} cohorts dispatched"
                 if name == "async" else "")
        say(f"  schedule={name}: {ms:.3f} ms/commit over {commits} commits "
            f"after one warm-up (host clock, {card}); sim_clock "
            f"{'none' if clock is None else f'{clock:.6f} s'}{extra}; test "
            f"fidelity {fid:.6f} after {sess.round} commits; unitarity "
            f"{u_err:.3e}")
        if not (u_err <= 1e-4 and fid == fid):
            raise RuntimeError(f"{name}: params not unitary or not finite")
        if name == "async" and not clock > 0.0:
            raise RuntimeError("async: the simulated clock did not advance")


def faulted_sync(card):
    """Phase 8's crash and Byzantine runs on its cell with the median
    defense and a round deadline, through ``SyncScheduler._robust_step``:
    per round the survivors and the retries; the deadline must force at
    least one retry in each run, and every committed round keeps at
    least API_MIN_SURVIVORS uploads."""
    import torch
    from repro_torch.core.fed import api
    byz_seed = scan_byzantine_seed(ROBUST_BYZ, int(round(ROBUST_BYZ
                                                         * ROBUST_N)))
    ds, test, params0 = robust_setup()
    for aname in ("crash30", "byz20"):
        attack = robust_attacks(byz_seed)[aname]
        spec = robust_spec("median", attack, round_deadline=API_DEADLINE,
                           min_participants=API_MIN_SURVIVORS)
        sub = api.QuantumSubstrate(spec, dataset=ds, test=test)
        sess = api.FederationSession.create(spec, 0, substrate=sub,
                                            params=params0)
        if not sess.scheduler.robust:
            raise RuntimeError("the faulted spec did not pick _robust_step")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = [sess.step() for _ in range(API_ROUNDS)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / API_ROUNDS
        surv = [int(m["n_survived"]) for m in rows]
        retries = [int(m["n_retries"]) for m in rows]
        fid = sess.evaluate()["test_fidelity"]
        say(f"  faulted sync {aname} + deadline {API_DEADLINE} s "
            f"(min_participants {API_MIN_SURVIVORS}, median): n_survived "
            f"{surv}, n_retries {retries} ({sum(retries)} in all); "
            f"{ms:.3f} ms a round with its retries (host clock, {card}); "
            f"test fidelity {fid:.6f}")
        if sum(retries) < 1 or min(surv) < API_MIN_SURVIVORS or fid != fid:
            raise RuntimeError(f"faulted sync {aname}: no retry, too few "
                               "survivors or non-finite params")


def phase_api():
    """Phase 9: the federation API on the card."""
    card = smi("name,power.limit")
    say("== phase 9: the federation API on the card: kill-and-resume, "
        "the (4,5,4) cell through the session, async and overlapped "
        "commits, faulted sync runs with retries")
    t0 = time.time()
    resume_checks(card)
    for impl in ("pallas", "xla"):
        session_vs_bare(main_spec(widths=(4, 5, 4), num_nodes=20, impl=impl),
                        10, "(4,5,4) N=20", card)
    scheduler_commits(card)
    faulted_sync(card)
    say(f"  phase 9 took {time.time() - t0:.1f} s")


# ------------------------------------------------- phase 10: cohorts, serving
# bench_cohort.py's hierarchy cell: (2,3,2), N_p = 64 of 128 nodes, one
# pair a node, I_l = 1, the Eq. 6 product, 8 pods, 20 rounds a run
TREE_NP, TREE_PODS, TREE_ROUNDS = 64, 8, 20
# bench_cohort.py's sweep: (2,2), N_p = 8, one pair a node, a 64-node base
# set tiled to the total; ms/round must stay within 2x across the totals
SWEEP_TOTALS, SWEEP_NP, SWEEP_BASE, SWEEP_ROUNDS = (
    (1_000, 10_000, 100_000, 1_000_000), 8, 64, 20)
SWEEP_SPREAD = 2.0
# bench_serve.py's cells: a 90/10 mix of (2,3,2) and (2,2,2) tenants, 50
# rounds each, 300 slots, 5 rounds a tick; the solo baseline steps
# SERVE_SOLO of them and is scaled (bench_serve's SEQ_CAP idea)
SERVE_TENANTS, SERVE_ROUNDS, SERVE_SLOTS, SERVE_K = (100, 1000), 50, 300, 5
SERVE_SOLO, SERVE_BIG = 24, 10_000


def load_example(name):
    """A script of ``examples/`` as a module."""
    import importlib.util
    mod_spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def figure_runs(card):
    """The paper's figure experiments through the port's session on the
    card (examples/torch_fig2_interval.py, torch_fig2_wider.py,
    torch_fig3_noise.py, the JAX scripts' specs, impl="pallas"): launch
    counts zeroed before each run and read after it (every quantum kernel
    must run), ms/round with the run's evaluations (the script's host
    clock around ``session.run``, whose last evaluation copies to the
    host), and Fig. 2's gate: every final test fidelity above
    MAIN_FIDELITY, the paper's "all reach ~1"."""
    import torch
    from repro_torch.kernels import build
    fig2 = load_example("torch_fig2_interval")
    wider = load_example("torch_fig2_wider")
    fig3 = load_example("torch_fig3_noise")
    runs = [(f"fig2 {label}", fig2, fig2.make_spec(i, mb, impl="pallas"),
             fig2.ITERS, True) for label, i, mb in fig2.RUNS]
    runs += [(f"fig2_wider {w}", wider, wider.make_spec(w, impl="pallas"),
              wider.ITERS, False) for w in wider.WIDTHS]
    runs += [(f"fig3 noise {int(r * 100)}%", fig3,
              fig3.make_spec(r, impl="pallas"), fig3.ITERS, False)
             for r in fig3.RATIOS]
    for label, mod, spec, iters, gated in runs:
        torch.cuda.synchronize()
        build.reset_launches()
        hist, secs = mod.run(spec, iters)
        torch.cuda.synchronize()
        ms = secs * 1e3 / iters
        launches = dict(build.LAUNCHES)
        tf, xf = hist["train_fidelity"][-1], hist["test_fidelity"][-1]
        ok = (all(launches.get(k, 0) for k in KERNELS) and xf == xf
              and (xf > MAIN_FIDELITY or not gated))
        say(f"  {label:22s} {iters} rounds: train fidelity {tf:.6f}, test "
            f"fidelity {xf:.6f}{' (clean test data)' if 'noise' in label else ''}"
            f"; {ms:.3f} ms/round with {len(hist['iteration'])} evaluations "
            f"(host clock, {card}); launches {launches} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{label}: a kernel never ran, the params "
                               "are not finite or the test fidelity is "
                               f"not above {MAIN_FIDELITY}")


def tree_spec(**overrides):
    """bench_cohort.py's hierarchy cell as a spec (flat; the data from
    the spec's recipe), impl="pallas"."""
    from repro_torch.core.fed import api
    return api.FedSpec.quantum(
        (2, 3, 2), **{**dict(num_nodes=2 * TREE_NP, nodes_per_round=TREE_NP,
                             n_per_node=1, interval_length=1,
                             aggregation="product", n_test=2,
                             impl="pallas"), **overrides})


def tree_checks(card):
    """One round from the same params and generator, two-level against
    flat: both combines (the average with strided pods too) in complex128
    (<= ENGINE_TOL) and with the kernels against the flat complex128
    round (<= ROUND_TOL). Then ms/round of TREE_ROUNDS session rounds,
    flat and two-level under both impls, in turns (flat, tree, tree,
    flat; CUDA events, one warm-up run each). Returns the kernel rows at
    the tree's pod-tier and merge shapes."""
    import dataclasses
    import statistics
    import torch
    from repro_torch.core.fed import api
    from repro_torch.core.quantum import federated as fed
    from repro_torch.kernels import build
    base = tree_spec()
    sub = api.QuantumSubstrate(base)
    params = api.FederationSession.create(base, 3, substrate=sub).state
    two = dict(topology="two_level", pods=TREE_PODS)
    for agg, extra in (("product", {}), ("average", {}),
                       ("average", dict(pod_assignment="strided"))):
        flat = base.to_quantum_config()._replace(aggregation=agg)
        tree = flat._replace(**two, **extra)
        want = fed.server_round(params, sub.dataset,
                                torch.Generator().manual_seed(9),
                                flat._replace(impl="xla"))
        out = {}
        for impl in ("xla", "pallas"):
            build.reset_launches()
            out[impl] = fed.server_round(params, sub.dataset,
                                         torch.Generator().manual_seed(9),
                                         tree._replace(impl=impl))
            torch.cuda.synchronize()
            out[impl + " launches"] = dict(build.LAUNCHES)
        d64, d32 = max_dev(out["xla"], want), max_dev(out["pallas"], want)
        ok = (d64 <= ENGINE_TOL and d32 <= ROUND_TOL
              and out["pallas launches"].get("zgemm", 0) > 0)
        say(f"  one round, two-level ({TREE_PODS} pods, "
            f"{tree.pod_assignment}) vs flat, {agg}: complex128 {d64:.3e} "
            f"(tol {ENGINE_TOL:.0e}), kernels vs flat complex128 {d32:.3e} "
            f"(tol {ROUND_TOL:.0e}); kernel round launches "
            f"{out['pallas launches']} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("the two-level round disagrees with the flat "
                               "round")
    # the kernels at the tree's combine shapes (one kernel round)
    cfg = base.to_quantum_config()._replace(**two)
    with Recorder() as rec:
        fed.server_round(params, sub.dataset,
                         torch.Generator().manual_seed(9), cfg)
        torch.cuda.synchronize()
    per, il = TREE_NP // TREE_PODS, cfg.interval_length
    tree_shapes = {}
    for w_in, w_out in zip(cfg.widths[:-1], cfg.widths[1:]):
        d = 2 ** (w_in + 1)
        tree_shapes[(TREE_PODS * il * w_out, d)] = "pod tier"
        tree_shapes[(il * w_out, d)] = "merge and apply"
    calls = rec.calls["zgemm"]
    for key in list(calls):
        a, b = key[0], key[1]
        if (a[0], a[1]) not in tree_shapes or a[1:] != b[1:] or a[1] != a[2]:
            del calls[key]
    rec.calls = {"zgemm": calls}
    rows = []
    label = f"two_level (2,3,2) N_p={TREE_NP} pods={TREE_PODS}"
    for row in check_and_time(rec, {}, names=("zgemm",))["zgemm"]:
        part = tree_shapes[tuple(row["shape"][0][:2])]
        say(f"    ({part}: {row['calls']} launches of "
            f"{row['shape'][0]} a round; pods of {per})")
        rows.append(dict(row, launches=row["calls"], cell=f"{label} {part}"))
    # ms/round through the session, in turns
    times = {}
    for impl in ("pallas", "xla"):
        specs = {"flat": dataclasses.replace(base, impl=impl),
                 "tree": dataclasses.replace(base, impl=impl, **two)}
        subs = {k: api.QuantumSubstrate(v, dataset=sub.dataset,
                                        test=sub.test)
                for k, v in specs.items()}

        def run(kind, n=TREE_ROUNDS):
            sess = api.FederationSession.create(specs[kind], 3,
                                                substrate=subs[kind])
            return cuda_timed(lambda: sess.run(n))[0] / n
        run("flat", 1)
        run("tree", 1)
        for kind in ("flat", "tree", "tree", "flat"):
            times.setdefault((impl, kind), []).append(run(kind))
        f_ms = statistics.median(times[(impl, "flat")])
        t_ms = statistics.median(times[(impl, "tree")])
        say(f"  {label} impl={impl}: flat {f_ms:.3f} ms/round "
            f"({', '.join(f'{t:.3f}' for t in times[(impl, 'flat')])}), "
            f"two-level {t_ms:.3f} "
            f"({', '.join(f'{t:.3f}' for t in times[(impl, 'tree')])}); "
            f"two-level / flat {t_ms / f_ms:.3f} ({TREE_ROUNDS} rounds a "
            f"run through the session, turns flat, tree, tree, flat, CUDA "
            f"events, {card})")
    return rows


def cohort_sweep(card, totals=SWEEP_TOTALS, rounds=SWEEP_ROUNDS):
    """bench_cohort.py's sweep on the card: the total cohort grows while
    every round samples SWEEP_NP nodes (Floyd's draw past 4096 nodes);
    the 64-node base set is tiled on the card to the total. ms/round of
    ``rounds`` session rounds after two warm-up rounds (CUDA events).
    Gate: the slowest total within SWEEP_SPREAD x the fastest."""
    import torch
    from repro_torch.core.fed import api
    from repro_torch.core.quantum import data as qdata
    _, base_ds, test = qdata.make_federated_dataset(
        torch.Generator().manual_seed(1), 2, SWEEP_BASE, 1, n_test=2,
        device="cuda")
    ms = {}
    for total in totals:
        reps = -(-total // SWEEP_BASE)

        def tile(x):
            return x.repeat((reps,) + (1,) * (x.dim() - 1))[:total]
        ds = qdata.QuantumDataset(tile(base_ds.phi_in), tile(base_ds.phi_out))
        spec = api.FedSpec.quantum((2, 2), num_nodes=total,
                                   nodes_per_round=SWEEP_NP, n_per_node=1,
                                   interval_length=1, aggregation="average",
                                   n_test=2, impl="pallas")
        sub = api.QuantumSubstrate(spec, dataset=ds, test=test)
        sess = api.FederationSession.create(spec, 0, substrate=sub)
        sess.run(2)
        ms[total] = cuda_timed(lambda: sess.run(rounds))[0] / rounds
        say(f"  cohort sweep: {total:>9,} nodes, N_p = {SWEEP_NP}: "
            f"{ms[total]:.3f} ms/round ({rounds} rounds through the session, "
            f"CUDA events, method {spec.participation_method}, {card})")
    spread = max(ms.values()) / min(ms.values())
    ok = spread <= SWEEP_SPREAD
    say(f"  cohort sweep spread: slowest / fastest {spread:.3f} (gate "
        f"<= {SWEEP_SPREAD}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("ms/round grows with the total cohort")


def serve_specs(impl="pallas"):
    """bench_serve.py's two groups: SPEC_A (2,3,2) and SPEC_B (2,2,2), N =
    N_p = 2, two pairs a node, I_l = 1, the average combine."""
    import dataclasses
    from repro_torch.core.fed import api
    a = api.FedSpec.quantum((2, 3, 2), num_nodes=2, nodes_per_round=2,
                            n_per_node=2, interval_length=1, n_test=2,
                            aggregation="average", impl=impl)
    return a, dataclasses.replace(a, widths=(2, 2, 2))


class Tenants:
    """bench_serve.py's tenant mix: tenant i is group B when i % 10 == 9
    (10%), else group A, with eta 0.5 + (i % 7) * 0.25 and key i; each
    group's dataset is built once on the card and shared (the tenants'
    params differ by key)."""

    def __init__(self, impl="pallas"):
        from repro_torch.core.fed import api
        self.api = api
        self.specs = serve_specs(impl)
        self.subs = [api.QuantumSubstrate(s) for s in self.specs]

    def session(self, i, poison=False):
        import dataclasses
        import torch
        g = int(i % 10 == 9)
        spec = dataclasses.replace(self.specs[g], eta=0.5 + (i % 7) * 0.25)
        base = self.subs[g]
        ds = base.dataset
        if poison:
            ds = ds._replace(phi_in=torch.full_like(
                ds.phi_in, complex(float("nan"), 0.0)))
        sub = self.api.QuantumSubstrate(spec, dataset=ds, test=base.test)
        return self.api.FederationSession.create(spec, i, substrate=sub)


def serve_cell(card, tmp, n_tenants, tenants, rounds=SERVE_ROUNDS,
               solo_n=SERVE_SOLO):
    """bench_serve.py's cell: ``n_tenants`` tenants served ``rounds``
    rounds each on SERVE_SLOTS slots, SERVE_K rounds a tick (``drain``,
    host clock ended by a synchronize; launch counts zeroed before and
    read after), against ``solo_n`` of the same tenants stepped solo
    (scaled to ``n_tenants``). The sampled tenants' served params within
    ROUND_TOL of their solo runs (kernels on both sides). Returns the
    cell's record, the launches and the served params by tenant."""
    import torch
    from repro_torch.core.fed.serve import FederationServer
    from repro_torch.kernels import build
    served = [tenants.session(i) for i in range(n_tenants)]
    server = FederationServer(slots=SERVE_SLOTS, rounds_per_tick=SERVE_K,
                              store_dir=os.path.join(tmp, f"cell{n_tenants}"))
    sids = [server.submit(session=s, rounds=rounds, sid=f"t{i:06d}")
            for i, s in enumerate(served)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    t0 = time.perf_counter()
    ticks = server.drain()
    torch.cuda.synchronize()
    stacked_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    final = {i: [p.clone() for p in server.session(sid).state]
             for i, sid in enumerate(sids)}
    solo_ids = [round(j * (n_tenants - 1) / max(solo_n - 1, 1))
                for j in range(min(solo_n, n_tenants))]
    solo = [tenants.session(i) for i in solo_ids]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in solo:
        for _ in range(rounds):
            s.step()
    torch.cuda.synchronize()
    sequential_s = (time.perf_counter() - t0) * n_tenants / len(solo)
    dev = max(max_dev(final[i], s.state) for i, s in zip(solo_ids, solo))
    ok = (dev <= ROUND_TOL and launches.get("zgemm", 0) > 0
          and launches.get("ensemble_commutator_trace", 0) > 0
          and not server.quarantined and len(server.done) == n_tenants)
    rec = {"tenants": n_tenants, "rounds": rounds, "slots": SERVE_SLOTS,
           "rounds_per_tick": SERVE_K, "ticks": ticks,
           "groups": len(server.groups), "stacked_s": stacked_s,
           "sequential_s": sequential_s, "sequential_sampled": len(solo),
           "sessions_per_s": n_tenants / stacked_s,
           "rounds_per_s": n_tenants * rounds / stacked_s,
           "speedup": sequential_s / stacked_s, "peak_gib": peak}
    say(f"  serve {n_tenants} tenants x {rounds} rounds: {ticks} ticks, "
        f"{len(server.groups)} groups, stacked {stacked_s:.3f} s, sequential "
        f"{sequential_s:.3f} s ({len(solo)} stepped solo, scaled), "
        f"{rec['sessions_per_s']:.2f} sessions/s, {rec['rounds_per_s']:.1f} "
        f"rounds/s, {rec['speedup']:.2f}x; peak {peak:.3f} GiB (host clock, "
        f"{card}); launches {launches}; the sampled tenants vs solo "
        f"{dev:.3e} (tol {ROUND_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"serving {n_tenants} tenants: a served tenant "
                           "differs from its solo run, a kernel never ran, "
                           "or a tenant did not finish")
    return rec, launches, final


def serve_checks(card, tmp, tenants):
    """Served == solo in complex128 (mixed groups, per-tenant eta,
    multi-round ticks whose budgets k does not divide); a tick's launches
    equal to k stacked rounds'; park -> evict -> revive bit-exact; one
    NaN-poisoned tenant quarantined alone; the generators' share of a
    300-slot tick, and a profile of one tick."""
    import torch
    from repro_torch.core.fed.api import rng
    from repro_torch.core.fed.serve import FederationServer
    from repro_torch.kernels import build

    def server(name, **kw):
        return FederationServer(store_dir=os.path.join(tmp, name), **kw)

    def serve(srv, sessions, budgets):
        sids = [srv.submit(session=s, rounds=r)
                for s, r in zip(sessions, budgets)]
        srv.drain()
        return [[p.clone() for p in srv.session(sid).state] for sid in sids]
    # served == solo in complex128
    t64 = Tenants("xla")
    budgets = [3, 6, 5, 1, 7, 4, 6, 2, 5, 3]
    got = serve(server("x64", slots=4, rounds_per_tick=SERVE_K),
                [t64.session(i) for i in range(10)], budgets)
    dev = 0.0
    for i, r in enumerate(budgets):
        solo = t64.session(i)
        for _ in range(r):
            solo.step()
        dev = max(dev, max_dev(got[i], solo.state))
    ok = dev <= ENGINE_TOL
    say(f"  served vs solo, complex128, 10 tenants of both groups on 4 "
        f"slots, k = {SERVE_K}, budgets {budgets}: {dev:.3e} (tol "
        f"{ENGINE_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("a served tenant differs from its solo run")
    # a tick's launches: k stacked rounds, each one solo round's
    srv = server("tick", slots=8, rounds_per_tick=SERVE_K)
    for i in range(8):
        srv.submit(session=tenants.session(10 * i), rounds=SERVE_K)
    torch.cuda.synchronize()
    build.reset_launches()
    srv.tick()
    torch.cuda.synchronize()
    tick = dict(build.LAUNCHES)
    solo = tenants.session(0)
    torch.cuda.synchronize()
    build.reset_launches()
    solo.step()
    torch.cuda.synchronize()
    one = dict(build.LAUNCHES)
    ok = bool(one) and tick == {k: SERVE_K * v for k, v in one.items()}
    say(f"  one tick of 8 SPEC_A tenants, k = {SERVE_K}: launches {tick}; "
        f"one solo round {one} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("a tick does not launch k stacked rounds' kernels")
    # park -> evict -> revive, on the card
    ids = list(range(12))
    free = serve(server("free", slots=4, rounds_per_tick=2),
                 [tenants.session(i) for i in ids], [7] * 12)
    capped = server("capped", slots=4, rounds_per_tick=2, max_live=5)
    got = serve(capped, [tenants.session(i) for i in ids], [7] * 12)
    same = all(torch_equal_all(g, f) for g, f in zip(got, free))
    ok = same and capped.store.parks > 0 and capped.store.revives > 0
    say(f"  park -> evict -> revive: 12 tenants, 4 slots, at most 5 live "
        f"sessions: {capped.store.parks} parks, {capped.store.revives} "
        f"revives; every tenant bit-equal to the uncapped server's: {same} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("park/revive on the card is not bit-exact")
    # one poisoned tenant among eight
    clean = serve(server("clean", slots=8, rounds_per_tick=SERVE_K),
                  [tenants.session(i) for i in range(8)], [10] * 8)
    bad = server("poison", slots=8, rounds_per_tick=SERVE_K)
    got = serve(bad, [tenants.session(i, poison=i == 3) for i in range(8)],
                [10] * 8)
    dev = max(max_dev(g, c) for i, (g, c) in enumerate(zip(got, clean))
              if i != 3)
    bits = all(torch_equal_all(g, c) for i, (g, c) in enumerate(zip(got, clean))
               if i != 3)
    ok = list(bad.quarantined) == ["s000003"] and dev <= ENGINE_TOL
    say(f"  poisoned tenant: quarantined {bad.quarantined}; the other 7 vs "
        f"the same grid with clean data {dev:.3e} (tol {ENGINE_TOL:.0e}; "
        f"bit-equal: {bits}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the poisoned tenant was not quarantined alone")
    # the host's share: one round's generators at SERVE_SLOTS slots, and
    # a profile of one tick of a full grid
    t0 = time.perf_counter()
    for _ in range(10):
        [rng.generator(rng.fold_in(i, 5)) for i in range(SERVE_SLOTS)]
    gen_ms = (time.perf_counter() - t0) * 1e3 / 10
    srv = server("profile", slots=SERVE_SLOTS, rounds_per_tick=SERVE_K)
    for i in range(SERVE_SLOTS):
        srv.submit(session=tenants.session(10 * i), rounds=2 * SERVE_K)
    srv.tick()
    torch.cuda.synchronize()
    profile_device(f"one tick of {SERVE_SLOTS} SPEC_A slots, k = {SERVE_K}",
                   srv.tick)
    say(f"    the {SERVE_SLOTS} per-slot round generators of one stacked "
        f"round: {gen_ms:.3f} ms of host time ({SERVE_K * gen_ms:.3f} ms a "
        f"tick; host clock, {card})")


def phase_cohorts_serving():
    """Phase 10: the figure experiments, the two-level tree and the
    multi-tenant server on the card."""
    import tempfile
    card = smi("name,power.limit")
    say("== phase 10: cohorts and serving: the paper's figures through the "
        "session, the two-level tree (bench_cohort.py's hierarchy cell and "
        "sweep), FederationServer (bench_serve.py's cells)")
    t0 = time.time()
    figure_runs(card)
    rows = tree_checks(card)
    cohort_sweep(card)
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tenants = Tenants()
        serve_cell(card, tmp, 8, tenants, rounds=SERVE_K, solo_n=1)  # warm-up
        for n in SERVE_TENANTS:
            rec, _, final = serve_cell(card, tmp, n, tenants)
            if n == SERVE_TENANTS[0]:
                _, _, again = serve_cell(card, tmp, n, tenants, solo_n=1)
                same = all(torch_equal_all(final[i], again[i])
                           for i in final)
                say(f"  replay of the {n}-tenant submissions on a fresh "
                    f"server: every tenant bit-equal: {same}")
                if not same:
                    raise RuntimeError("a replayed submission sequence "
                                       "gave other bits")
            say("  " + json.dumps({"serve_cell": rec}))
        serve_checks(card, tmp, tenants)
    say(f"  phase 10 took {time.time() - t0:.1f} s")
    return rows


# ------------------------------------------------- phase 11: training
# RecurrentGemma-2B at full width and depth trained on one card: B=1,
# S=4096 (the config's train_4k length), bf16 params, remat on, the
# Bigram stream from seed 0, 5 steps on one repeated batch with
# launch/train.py's optimizer (``train.optimizer``: AdamW with fp32
# moments, weight decay 0.01, the global norm clipped to 1) and schedule
# (linear warmup then cosine) at --lr 1e-2 --warmup 0. At this init the
# gradient's norm is far above the clip, and at a peak of 1e-3 the 5
# steps leave the loss flat; ``--train-probe`` prints the norm, where it
# sits, and the losses at other settings.
TRAIN_B, TRAIN_S, TRAIN_STEPS = 1, 4096, 5
TRAIN_LR, TRAIN_WARMUP = 1e-2, 0
# the attention backward in fp32 storage against its plain fp32 version:
# relative to each gradient's scale; dK sums up to G x window = 20,480
# products of P and dS a row in another order than the plain version
BWD_RTOL = 1e-4
# the reverse (adjoint) scan against autograd of the plain scan
SCAN_BWD_RTOL = 1e-5
# one cycle's gradients through the kernels in fp32 storage against the
# plain route's, of each gradient's scale: the whole-model tolerance of
# the card test test_forward_train_backprop_through_kernels_matches_plain
GRAD_RTOL_FP32 = 1e-3
# the forward kernels' log-sum-exp against the plain one, of its scale
LSE_RTOL = 1e-6
ATTN_BWD = "flash_attention_bwd"
ATTN_BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu"
ATTN_BWD32 = "flash_attention_bwd fp32"
SCAN_REV = "rglru_scan reverse"
GLA_BWD = "gla_chunked_bwd"
GLA_BWD_SOURCE = "src/repro_torch/kernels/csrc/gla_chunked_bwd.cu"
GLA_BWD_REPLACES = ("no TPU kernel: XLA differentiated "
                    "src/repro/models/layers/rwkv.py:80 gla_chunked_ref")


def train_launches(cfg):
    """Launches of one train step, from the config (and, under
    SCAN_REV, how many of the scan's are the backward's), the kernels
    that launch at all: each local layer's attention forward twice (the
    forward and the recompute of its remat cycle) and its backward once;
    each recurrent layer's scan in the forward, the reverse scan of the
    backward, and the recompute where the layer sits in a remat cycle;
    each RWKV layer's GLA forward (and recompute) and its backward
    (remainder layers are not recomputed, as in the reference)."""
    per_cycle = {kind: cfg.block_pattern.count(kind)
                 for kind in ("local", "attn", "rec", "rwkv")}
    rem = [cfg.block_pattern[i] for i in range(cfg.n_rem)]
    recompute = 1 if cfg.remat else 0
    attn_c = per_cycle["local"] + per_cycle["attn"]
    attn_r = sum(k in ("local", "attn") for k in rem)
    rec_c, rec_r = per_cycle["rec"], rem.count("rec")
    gla_c, gla_r = per_cycle["rwkv"], rem.count("rwkv")
    counts = {"flash_attention": cfg.n_cycles * attn_c * (1 + recompute)
              + attn_r,
              ATTN_BWD: cfg.n_cycles * attn_c + attn_r,
              "rglru_scan": cfg.n_cycles * rec_c * (2 + recompute)
              + 2 * rec_r,
              SCAN_REV: cfg.n_cycles * rec_c + rec_r,
              "gla_chunked": cfg.n_cycles * gla_c * (1 + recompute) + gla_r,
              GLA_BWD: cfg.n_cycles * gla_c + gla_r}
    return {k: n for k, n in counts.items() if n}


def attn_bwd_timing(q, k, v, o, do, kw):
    """The attention backward kernel at (q, k, v, o, dO) (heads-major; bf16
    or fp32) timed by CUDA events beside its plain version and SDPA's
    backward in the same dtype, with its device time a launch and its
    bound; printed. Returns the numbers of its row in the result."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    mask = dict(causal=kw["causal"], window=kw["window"],
                q_offset=kw.get("q_offset", 0))
    k_ms = cuda_ms(lambda: kfa.flash_attention_bwd(q, k, v, o, do, **kw),
                   reps=10, warmup=2)
    p_ms = cuda_ms(lambda: ref.attention_bwd_ref(q, k, v, o, do, **kw),
                   reps=3, warmup=1)
    lib_ms, backend = sdpa_backward_ms(q, k, v, mask)
    dev_us = device_us(lambda *x: kfa.flash_attention_bwd(*x, **kw),
                       [q, k, v, o, do], n=3)
    b_ms, b_by = attn_bwd_bound_ms(q, k, mask)
    flops = 10 * q.shape[2] * q.shape[0] * allowed_pairs(
        q.shape[1], k.shape[1], kw["causal"], kw["window"],
        kw.get("q_offset", 0))
    say(f"  {ATTN_BWD} timed at {[list(x.shape) for x in (q, k)]} "
        f"{str(q.dtype)[6:]} {mask}: kernel {k_ms:.4f} ms (device "
        f"{dev_us:.2f} us a launch; "
        f"{flops / k_ms / 1e9:.1f} TFLOP/s on the five products), plain "
        f"{p_ms:.4f} ms, SDPA backward ({backend}) "
        f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
        f"{b_ms:.6f} ms ({b_by}), kernel/bound {k_ms / b_ms:.2f}x"
        + ("" if lib_ms is None else f", kernel/SDPA {k_ms / lib_ms:.3f}x"))
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, device_us=dev_us,
                bound_ms=b_ms, bound_by=b_by)


def grad_dev(got, want, scale):
    return [float((g.float() - w.float()).abs().max()) / s
            for g, w, s in zip(got, want, scale)]


def attn_bwd_case(args, kw, label, exact=False):
    """The backward kernel on (q, k, v, o, dO) against the plain fp32
    version (the inputs cast to fp32), each gradient relative to its
    scale, and the same bits on repeat. fp32 storage: within BWD_RTOL; with
    ``exact`` (the path's inputs at the reference init, whose scores reach
    the thousands, where the plain fp32 version is itself more than that
    off the function), element by element within ``fp32_fn_bound`` of the
    terms of the same gradients in fp64 (``attention_bwd_fp64`` with the
    given LSE: the function ``ref.attention_bwd_ref`` computes), the plain
    version's share of that bound and its deviation printed beside. bf16
    storage: within the bf16 budget, the plain bf16 gradients' deviation
    from the plain fp32 ones on the same inputs, plus BWD_RTOL for the
    kernel's order of summation. Returns the worst deviation from the
    plain version."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    got = kfa.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    want = ref.attention_bwd_ref(*(x.float() for x in args), **kw)
    scale = [max(float(w.abs().max()), 1e-30) for w in want]
    dev = grad_dev(got, want, scale)
    if args[0].dtype == torch.bfloat16:
        plain = ref.attention_bwd_ref(*args, **kw)
        budget = [b + BWD_RTOL for b in grad_dev(plain, want, scale)]
        del plain
    else:
        budget = [BWD_RTOL] * 3
    again = kfa.flash_attention_bwd(*args, **kw)
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    del again
    if exact:
        grads, terms, smax = attention_bwd_fp64(
            *args, causal=kw["causal"], window=kw["window"], lse=kw["lse"])
        fits = [fp64_excess(x, e, t, smax)
                for x, e, t in zip(got, grads, terms)]
        plain_share = [fp64_excess(x, e, t, smax)[1]
                       for x, e, t in zip(want, grads, terms)]
        del grads, terms
        ok = same and all(excess <= 1e-30 for excess, _ in fits)
        say(f"  {ATTN_BWD} {label} (scores up to {smax:.1f}): against the "
            "same gradients in fp64 element by element, dq/dk/dv the "
            "kernel's largest error "
            + ", ".join(f"{share:.3f}" for _, share in fits)
            + ", the plain fp32 version's "
            + ", ".join(f"{share:.3f}" for share in plain_share)
            + f" of the bound {fp32_fn_bound(smax):.3e} x their terms; off "
            "the plain version "
            + ", ".join(f"{d:.3e}" for d in dev)
            + f" of each scale (BWD_RTOL {BWD_RTOL:.0e}); same bits on "
            f"repeat {same} {'ok' if ok else 'FAIL'}")
    else:
        ok = same and all(d <= b for d, b in zip(dev, budget))
        say(f"  {ATTN_BWD} {label}: dq/dk/dv "
            + ", ".join(f"{d:.3e} (budget {b:.3e})"
                        for d, b in zip(dev, budget))
            + f" of each scale; same bits on repeat {same} "
            f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the attention backward kernel disagrees with "
                           "its plain version or with the fp64 function")
    return max(d * s for d, s in zip(dev, scale))


def attn_bwd_ragged(device):
    """Edge shapes, seeded, both storage types: S not a multiple of the
    tiles (100: a short last key tile of 4 and query tile of 36), window
    0 causal and non-causal, G = 1 and G = 10, a window below the tile,
    Sq > Sk (rows with no allowed key), dh 64, 128, 256; each with the
    plain LSE of its (q, k, v) (o and dO are drawn apart)."""
    import torch
    from repro_torch.kernels import ref
    g = torch.Generator(device="cpu").manual_seed(12)

    def case(dtype, bh, bk, sq, sk, dh, causal, window):
        r = [torch.randn(shape, generator=g).to(device, dtype)
             for shape in ((bh, sq, dh), (bk, sk, dh), (bk, sk, dh),
                           (bh, sq, dh), (bh, sq, dh))]
        lse = ref.attention_ref(*r[:3], causal=causal, window=window,
                                return_lse=True)[1]
        return r, dict(causal=causal, window=window, lse=lse)
    out = []
    for dt in (torch.float32, torch.bfloat16):
        out += [case(dt, 10, 1, 100, 100, 256, True, 16),
                case(dt, 3, 3, 77, 77, 64, True, 0),
                case(dt, 2, 2, 65, 65, 128, False, 0),
                case(dt, 4, 2, 130, 130, 64, False, 20),
                case(dt, 2, 1, 100, 37, 64, True, 16)]
    return out


def sdpa_backward_ms(q, k, v, kw):
    """SDPA forward + backward with the boolean window mask and
    enable_gqa, minus its forward, at the path's shape, heads-major views
    of the port's tensors; and the backend that ran (from the profiler's
    kernel names). None where SDPA refuses the shape."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ref
    bk, sk, dh = k.shape
    g = q.shape[0] // bk
    mask = ref.attention_mask(q.shape[1], sk, kw["causal"], kw["window"],
                              q.device, kw.get("q_offset", 0))
    qs = q.reshape(1, bk * g, -1, dh).detach().requires_grad_()
    ks = k.reshape(1, bk, sk, dh).detach().requires_grad_()
    vs = v.reshape(1, bk, sk, dh).detach().requires_grad_()
    do = torch.randn_like(qs)

    def fwd():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              enable_gqa=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qs, ks, vs), do)
    try:
        fwd_bwd()
    except RuntimeError as e:
        say(f"  SDPA backward refused: {str(e).splitlines()[0][:100]}")
        return None, "none"
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fwd_bwd()
        torch.cuda.synchronize()
    names = sorted(((e.time_range.end - e.time_range.start, e.name)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA and e.name),
                   reverse=True)
    top = names[0][1] if names else ""
    low = top.lower()
    # late in a run the profiler may lose the device records' names
    backend = ("unknown" if not top else "cudnn" if "cudnn" in low
               else "flash" if "flash" in low
               else "efficient" if "fmha" in low or "cutlass" in low
               or "efficient" in low else "math")
    with torch.no_grad():
        f_ms = cuda_ms(fwd, reps=5, warmup=1)
    fb_ms = cuda_ms(fwd_bwd, reps=5, warmup=1)
    say(f"  SDPA ({backend}: {top[:60]}) forward {f_ms:.4f} ms, forward + "
        f"backward {fb_ms:.4f} ms")
    return fb_ms - f_ms, backend


def lse_check(q, k, v, kw, label, lse=None):
    """The forward kernel's log-sum-exp of (q, k, v) (``lse``: one already
    taken) against the plain one: within LSE_RTOL of its scale on the
    rows with an allowed key, -inf on the rows with none."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    mask = dict(causal=kw["causal"], window=kw["window"])
    if lse is None:
        lse = kfa.flash_attention(q, k, v, return_lse=True, **mask)[1]
    torch.cuda.synchronize()
    want = ref.attention_ref(q, k, v, return_lse=True, **mask)[1]
    fin = torch.isfinite(want)
    scale = max(float(want[fin].abs().max()), 1e-30) if fin.any() else 1.0
    dev = (float((lse[fin] - want[fin]).abs().max()) / scale
           if fin.any() else 0.0)
    ok = dev <= LSE_RTOL and torch.equal(torch.isfinite(lse), fin)
    say(f"  LSE {label}: {dev:.3e} of its scale {scale:.4g} (tol "
        f"{LSE_RTOL:.0e}), {int((~fin).sum())} rows with no key "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the forward kernel's LSE disagrees with the "
                           "plain one")


def one_cycle_params(cfg, params, well_conditioned=False, cycles=1):
    """The full model's first ``cycles`` cycles and its embedding. With
    ``well_conditioned`` the stacked matrices are rescaled from the
    init's std 1/sqrt(n_cycles) to the unstacked layer's 1/sqrt(d_in)
    (the CPU tests' ``well_conditioned``): at the init's std the
    attention softmax saturates and the attention and RG-LRU gradients
    are rounding noise."""
    import math
    p1 = {}
    for k, v in params.items():
        if k.startswith("rem/"):
            continue
        if k.startswith("stack/"):
            w = v[:cycles]
            if well_conditioned and v.ndim >= 3:
                w = (w.float() * math.sqrt(v.shape[0] / v.shape[1])
                     ).to(v.dtype)
            v = w
        p1[k] = v
    return p1


def one_cycle_gate(cfg, params, batch):
    """The fault's gate, on one cycle (3 layers, full width, the full
    model's first cycle and its embedding), every parameter's gradient
    printed with its bound:

    - bf16 at the init: through the kernels against the plain versions',
      within the bf16 budget (the plain bf16 gradient's deviation from
      the plain fp32 one on the same weights and tokens), each relative
      to the fp32 gradient's scale;
    - fp32 storage at ``one_cycle_params(well_conditioned=True)``: through
      the kernels against the plain versions', within GRAD_RTOL_FP32 of
      each gradient's scale.

    At the init the bf16 budgets come out near each gradient's own scale
    (the saturated softmax and gates make the bf16 gradients rounding
    noise), so the bf16 part cannot tell a wrong gradient; the fp32 part
    can. Two planted faults, the attention backward's dK set to 0 and the
    scan adjoint's da set to 0, must each fail the fp32 gate (the leaves
    where the bf16 gate would catch them are printed too). Returns the
    bf16 and the fp32 kernel passes' launches."""
    import dataclasses
    import torch
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import Model
    cfg1 = dataclasses.replace(cfg, n_layers=cfg.cycle_len)
    cfg32 = dataclasses.replace(cfg1, dtype="float32", param_dtype="float32")
    p1 = one_cycle_params(cfg, params)
    w32 = {k: v.float() for k, v in
           one_cycle_params(cfg, params, well_conditioned=True).items()}
    build.reset_launches()
    loss_k, _, g_k = loss_and_grads(Model(cfg1), p1, batch)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    t0 = time.time()
    loss_x, _, g_x = loss_and_grads(Model(cfg1, impl="xla"), p1, batch)
    p32 = {k: v.float() for k, v in p1.items()}
    loss_32, _, g_32 = loss_and_grads(Model(cfg32, impl="xla"), p32, batch)
    del p32
    loss_wx, _, h_x = loss_and_grads(Model(cfg32, impl="xla"), w32, batch)
    torch.cuda.synchronize()
    t_plain = time.time() - t0
    scale = {k: max(float(g.abs().max()), 1e-30) for k, g in g_32.items()}
    budget = {k: float((g_x[k].float() - g).abs().max()) / scale[k]
              for k, g in g_32.items()}
    del g_32
    h_scale = {k: max(float(h.abs().max()), 1e-30) for k, h in h_x.items()}

    def bf16_dev(g):
        dev = {k: float((g[k].float() - g_x[k].float()).abs().max())
               / scale[k] for k in sorted(budget)}
        return dev, [k for k in dev if not dev[k] <= budget[k]]

    def fp32_dev(h):
        dev = {k: float((h[k] - h_x[k]).abs().max()) / h_scale[k]
               for k in sorted(h_scale)}
        return dev, [k for k in dev if not dev[k] <= GRAD_RTOL_FP32]

    def kernel_grads():
        return (loss_and_grads(Model(cfg1), p1, batch),
                loss_and_grads(Model(cfg32), w32, batch))
    dev, fails = bf16_dev(g_k)
    build.reset_launches()
    loss_wk, _, h_k = loss_and_grads(Model(cfg32), w32, batch)
    torch.cuda.synchronize()
    launches32 = dict(build.LAUNCHES)
    dev32, fails32 = fp32_dev(h_k)
    del g_k, h_k
    say(f"  one cycle ({cfg1.block_pattern}, {len(budget)} params): bf16 at "
        f"the init, loss kernels {float(loss_k):.6f}, plain "
        f"{float(loss_x):.6f}, plain fp32 {float(loss_32):.6f}; fp32 at std "
        f"1/sqrt(d_in), kernels {float(loss_wk):.6f}, plain "
        f"{float(loss_wx):.6f}; launches {launches} (plain passes "
        f"{t_plain:.1f} s)")
    say("  each gradient through the kernels against the plain route's, of "
        "its scale: bf16 at the init (budget: plain bf16 vs plain fp32); "
        f"fp32 at std 1/sqrt(d_in) (tol {GRAD_RTOL_FP32:.0e}):")
    for k in dev:
        say(f"    {k}: bf16 {dev[k]:.3e} (budget {budget[k]:.3e}); fp32 "
            f"{dev32[k]:.3e} "
            f"{'ok' if k not in fails and k not in fails32 else 'FAIL'}")
    if fails or fails32:
        raise RuntimeError("gradients through the kernels deviate from the "
                           f"plain ones: bf16 {fails}, fp32 {fails32}")
    bwd, adj = kfa.flash_attention_bwd, ops.lru_scan_adjoint

    def no_dk(*args, **kw):
        dq, dk, dv = bwd(*args, **kw)
        return dq, torch.zeros_like(dk), dv

    def no_da(scan, a, h, g):
        da, db = adj(scan, a, h, g)
        return torch.zeros_like(da), db
    for label, mod, name, fn in (
            ("attention dK = 0", kfa, "flash_attention_bwd", no_dk),
            ("scan da = 0", ops, "lru_scan_adjoint", no_da)):
        orig = getattr(mod, name)
        setattr(mod, name, fn)
        try:
            (_, _, g_f), (_, _, h_f) = kernel_grads()
        finally:
            setattr(mod, name, orig)
        caught, caught32 = bf16_dev(g_f)[1], fp32_dev(h_f)[1]
        del g_f, h_f
        say(f"  planted fault, {label}: the fp32 gate fails at {caught32}; "
            f"the bf16 gate would at {caught}")
        if not caught32:
            raise RuntimeError(f"the gradient gate passed a planted fault "
                               f"({label})")
    del g_x, h_x
    torch.cuda.empty_cache()
    return launches, launches32


def phase_train(device="cuda"):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import token_batches
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rglru_scan as krg
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import linear_warmup_cosine
    torch.cuda.empty_cache()
    cfg = get_config("recurrentgemma-2b")
    b, s = TRAIN_B, TRAIN_S
    say(f"== phase 11: {cfg.name} training at full width ({cfg.n_layers} "
        f"layers {cfg.block_pattern}, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, window "
        f"{cfg.window}, {cfg.param_dtype} params, {cfg.opt_state_dtype} "
        f"AdamW moments, remat {cfg.remat}): B={b}, S={s}, {TRAIN_STEPS} "
        f"steps on one batch; {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB held on entry")
    t0 = time.time()
    model = Model(cfg)
    params = model.init(seed=0, device=device)
    batch = next(token_batches(cfg, b, s, seed=0, device=device))
    torch.cuda.synchronize()
    say(f"  init {model.num_params():,} params in {time.time() - t0:.1f} s")
    _, launches32 = one_cycle_gate(cfg, params, batch)

    opt = train.optimizer(cfg)
    schedule = linear_warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS)
    state = opt.init(params)
    step_fn = make_train_step(model, opt)
    per_step = train_launches(cfg)
    rev_want = per_step.pop(SCAN_REV, 0)
    rec, rev = {}, []
    bwd_orig, scan_orig = kfa.flash_attention_bwd, krg.rglru_scan
    adj_orig = ops.lru_scan_adjoint

    def bwd_rec(*args, **kw):
        rec.setdefault(ATTN_BWD, (tuple(x.detach() for x in args), kw))
        return bwd_orig(*args, **kw)

    def scan_rec(a, b_):
        rec.setdefault("rglru_scan", (a.detach(), b_.detach()))
        return scan_orig(a, b_)

    def adj_rec(scan, a, h, g):
        # the adjoint's own scan launches, by the wrapper's count
        before = build.LAUNCHES["rglru_scan"]
        out = adj_orig(scan, a, h, g)
        rev.append(build.LAUNCHES["rglru_scan"] - before)
        return out
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        build.reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if i == 0:
            kfa.flash_attention_bwd, krg.rglru_scan = bwd_rec, scan_rec
            ops.lru_scan_adjoint = adj_rec
        start.record()
        params, state, metrics = step_fn(params, state, batch, schedule(i))
        end.record()
        torch.cuda.synchronize()
        kfa.flash_attention_bwd, krg.rglru_scan = bwd_orig, scan_orig
        ops.lru_scan_adjoint = adj_orig
        launches = dict(build.LAUNCHES)
        if i == 0:
            first = launches
        losses.append(float(metrics["loss"]))
        step_ms.append(start.elapsed_time(end))
        say(f"  step {i + 1}: loss {losses[-1]:.6f}, lr "
            f"{float(schedule(i)):.3e}, {step_ms[-1]:.1f} ms, launches "
            f"{launches}")
        if launches != per_step:
            raise RuntimeError(f"train step launched {launches}, expected "
                               f"{per_step}")
        if not torch.isfinite(torch.tensor(losses[-1])):
            raise RuntimeError("non-finite training loss")
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"  step 1's backward: {sum(rev)} of its {first['rglru_scan']} "
        f"rglru_scan launches in the scan's adjoint ({len(rev)} adjoints; "
        f"expected {rev_want})")
    if sum(rev) != rev_want:
        raise RuntimeError(f"the scan's adjoint launched {sum(rev)} times, "
                           f"expected {rev_want}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall: {losses}")
    ms = sum(step_ms[1:]) / (TRAIN_STEPS - 1)
    say(f"  loss {losses[0]:.6f} -> {losses[-1]:.6f} (AdamW grad_clip "
        f"{opt.grad_clip}, peak lr {TRAIN_LR}, warmup {TRAIN_WARMUP}); "
        f"{ms:.1f} ms/step over steps 2-{TRAIN_STEPS} (CUDA events), "
        f"{b * s / ms * 1e3:,.0f} tokens/s, peak {peak:.2f} GiB; card "
        f"{smi('name,power.limit')}")
    profile_device("one train step", lambda: step_fn(
        params, state, batch, schedule(TRAIN_STEPS)))
    del state, params
    torch.cuda.empty_cache()

    say("  the attention backward at the path's inputs and ragged shapes, "
        "against its plain version:")
    (q, k, v, o, do), kw = rec[ATTN_BWD]
    mask = dict(causal=kw["causal"], window=kw["window"])
    design = kfa.bf16_design()
    splits = kfa.bwd_splits(q.shape[0], k.shape[0], k.shape[1],
                            torch.cuda.get_device_properties(
                                q.device).multi_processor_count)
    say(f"  {ATTN_BWD} bf16 design: {design} (the machine code of the "
        f"forward and of the dQ and dK/dV passes; HGMMA = wgmma), the "
        f"group's {q.shape[0] // k.shape[0]} query heads in {splits} splits")
    if design != "wgmma":
        raise RuntimeError(f"the bf16 attention backward runs on {design}, "
                           "not on wgmma")
    lse_check(q, k, v, kw, "path bf16 (the recompute's, saved for the "
              "backward)", lse=kw["lse"])
    p32 = tuple(x.float() for x in (q, k, v, o, do))
    lse_check(*p32[:3], kw, "path fp32 storage")
    worst = attn_bwd_case((q, k, v, o, do), kw, "path bf16")
    worst32 = attn_bwd_case(p32, kw, "path fp32 storage", exact=True)
    gen = torch.Generator(device="cpu").manual_seed(15)
    unit = tuple(torch.randn(x.shape, generator=gen).to(device)
                 for x in p32)
    kw_u = dict(mask, lse=ref.attention_ref(*unit[:3], return_lse=True,
                                            **mask)[1])
    attn_bwd_case(unit, kw_u, "unit-scale inputs at the path's shape, fp32 "
                  "storage")
    del unit, kw_u
    for args, kw_r in attn_bwd_ragged(device):
        mask_r = {x: kw_r[x] for x in ("causal", "window")}
        attn_bwd_case(args, kw_r, f"ragged {[list(x.shape) for x in args[:2]]}"
                      f" {str(args[0].dtype)[6:]} {mask_r}")
    k32_ms = cuda_ms(lambda: kfa.flash_attention_bwd(*p32, **kw), reps=3,
                     warmup=1)
    p32_ms = cuda_ms(lambda: ref.attention_bwd_ref(*p32, **kw), reps=2,
                     warmup=1)
    dev32_us = device_us(lambda *x: kfa.flash_attention_bwd(*x, **kw),
                         list(p32), n=2)
    lib32_ms, backend32 = sdpa_backward_ms(*p32[:3], mask)
    del p32
    b32_ms, b32_by = attn_bwd_bound_ms(q.float(), k.float(), mask)
    simt32_ms = 10 * q.shape[2] * q.shape[0] * allowed_pairs(
        q.shape[1], k.shape[1], kw["causal"], kw["window"]) / FP32_FLOPS * 1e3
    design32 = kfa.fp32_design()
    bwd = attn_bwd_timing(q, k, v, o, do, kw)
    profile_device(f"one {ATTN_BWD} call (its passes)",
                   lambda: kfa.flash_attention_bwd(q, k, v, o, do, **kw))
    say(f"  {ATTN_BWD32} at the same inputs in fp32 ({design32} design, "
        f"the machine code's; the group's {q.shape[0] // k.shape[0]} query "
        f"heads in {splits} splits): kernel {k32_ms:.4f} ms, "
        f"plain {p32_ms:.4f} ms, fp32 SDPA backward ({backend32}, boolean "
        f"window mask) "
        f"{'n/a' if lib32_ms is None else f'{lib32_ms:.4f} ms'}, bound "
        f"{b32_ms:.6f} ms ({b32_by}, 3xTF32; {simt32_ms:.6f} ms at the fp32 "
        f"CUDA-core rate), {k32_ms / b32_ms:.2f}x (device "
        f"{dev32_us:.2f} us a launch)"
        + ("" if lib32_ms is None else f", kernel/SDPA {k32_ms / lib32_ms:.3f}x")
        + f"; card {smi('name,power.limit')}")
    if design32 == "none":
        raise RuntimeError("the fp32 attention backward is not on the "
                           "tensor cores")

    say("  the scan's reverse use at the path's inputs, against autograd "
        "of the plain scan:")
    a, bb = rec["rglru_scan"]
    gy = torch.randn(a.shape, generator=torch.Generator(device=device)
                     .manual_seed(4), device=device)
    ah, bh = a.detach().requires_grad_(), bb.detach().requires_grad_()
    h = ops._LruScanFn.apply(ah, bh, krg.rglru_scan)
    got = torch.autograd.grad(h, (ah, bh), gy)
    ap, bp = a.detach().requires_grad_(), bb.detach().requires_grad_()
    want = torch.autograd.grad(ref.rglru_scan_ref(ap, bp), (ap, bp), gy)
    scale = [max(float(w.abs().max()), 1e-30) for w in want]
    sdev = grad_dev(got, want, scale)
    ok = all(d <= SCAN_BWD_RTOL for d in sdev)
    say(f"  da {sdev[0]:.3e}, db {sdev[1]:.3e} of each scale (tol "
        f"{SCAN_BWD_RTOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the scan's adjoint disagrees with autograd of "
                           "the plain scan")
    hd = h.detach()
    a_rev = torch.zeros_like(a)
    a_rev[:, :-1] = a[:, 1:]
    a_rev, g_rev = a_rev.flip(1), gy.flip(1)
    r_ms = cuda_ms(lambda: krg.rglru_scan(a_rev, g_rev), reps=20, warmup=2)
    adj_ms = cuda_ms(lambda: ops.lru_scan_adjoint(krg.rglru_scan, a, hd, gy),
                     reps=20, warmup=2)
    rp_ms = cuda_ms(lambda: ref.rglru_scan_ref(a_rev, g_rev), reps=2,
                    warmup=1)
    r_us = device_us(krg.rglru_scan, [a_rev, g_rev])
    rb_ms, rb_by = seq_bound_ms("rglru_scan", (a_rev, g_rev), {})
    rdev = float((krg.rglru_scan(a_rev, g_rev)
                  - ref.rglru_scan_ref(a_rev, g_rev)).abs().max())
    say(f"  {SCAN_REV} timed at {list(a.shape)} fp32: kernel {r_ms:.4f} ms "
        f"(device {r_us:.2f} us a launch; the whole adjoint with its flips "
        f"{adj_ms:.4f} ms), plain {rp_ms:.4f} ms, bound {rb_ms:.6f} ms "
        f"({rb_by}), kernel/bound {r_ms / rb_ms:.2f}x; card "
        f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    del rec
    torch.cuda.empty_cache()
    cell = f"{cfg.name} train step B={b} S={s}"
    replaces = SEQ_KERNELS["flash_attention"]["replaces"]
    shape = [list(x.shape) for x in (q, k)]
    return [dict(name=ATTN_BWD, route="cuda", source=ATTN_BWD_SOURCE,
                 replaces=replaces, launches=first[ATTN_BWD], shape=shape,
                 max_abs_err=worst, cell=cell, **bwd),
            dict(name=ATTN_BWD32, route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                 replaces=replaces, launches=launches32[ATTN_BWD],
                 shape=shape, max_abs_err=worst32, ms=k32_ms,
                 plain_ms=p32_ms, bound_ms=b32_ms, bound_by=b32_by,
                 library_ms=lib32_ms, device_us=dev32_us,
                 cell=f"{cfg.name} one cycle, fp32 storage"),
            dict(name=SCAN_REV, route="cuda", **SEQ_KERNELS["rglru_scan"],
                 launches=sum(rev), shape=[list(a.shape)] * 2,
                 max_abs_err=rdev, ms=r_ms, plain_ms=rp_ms, bound_ms=rb_ms,
                 bound_by=rb_by, library_ms=None, device_us=r_us,
                 cell=cell)]


# ------------------------------------ phase 11b: RWKV6-7B training
# RWKV6-7B at its published width with its depth cut from 32 to 16
# layers: 7,576,752,128 params are ~0.54 B of embeddings and ~220 M a
# layer, 12 bytes a parameter in training (bf16 params and grads, fp32
# AdamW moments), so 32 layers need ~91 GB and the card has 80 GB; 16
# layers need ~48.7 GB before the activations
RWKV_ARCH, RWKV_LAYERS = "rwkv6-7b", 16
RWKV_PEAK_GIB = 70.0
# phase 11's lr 1e-2 makes RWKV6's loss climb after its first step
# (11.57, 8.89, 12.89, 21.68, 14.56 on an H100); at 1e-3 it falls at
# every step
RWKV_LR = 1e-3


def rwkv_train_memory_gb(n_par, n_embed, tokens, vocab):
    """Device memory phase 11b's step must hold at its peak, counted
    (decimal GB): bf16 params and grads, fp32 AdamW moments, AdamW's fp32
    temporaries of the largest leaf (the embedding: about four), and
    the fp32 logits with their gradient and softmax."""
    return {"params + grads": 2 * 2 * n_par / 1e9,
            "moments": 2 * 4 * n_par / 1e9,
            "AdamW temporaries": 4 * 4 * n_embed / 1e9,
            "logits": 3 * 4 * tokens * vocab / 1e9}


def gla_bwd_ragged(device):
    """Edge shapes for the GLA backward, seeded (r, k, v, w, u, dout,
    dstate or None; chunk): chunks 1, 16 and above 16 (48; 128, a whole
    sequence), S that 16 does not divide (17, 33, 4097 at chunk 1), one
    token, dh 5, 8, 40 (a partial row block) and 64 (four), w at the
    clip's ends and in bf16, fp32 and bf16 r, k, v, dout, with and
    without the final state's cotangent; the stages' cut points (S = 65
    and 129, one past a multiple of the kernel's 16-token stage) at
    B = 3, so that du sums over b and over stages."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(16)
    bf, f32 = torch.bfloat16, torch.float32

    def case(dtype, b, s, h, dh, chunk, ends=False, w_dtype=f32,
             state=False):
        x = [(0.5 * torch.randn((b, s, h, dh), generator=g)).to(device, dtype)
             for _ in range(3)]
        w = torch.rand((b, s, h, dh), generator=g) * 0.5 + 0.45
        if ends:
            w = torch.tensor([1.9e-24, 1.0 - 6.1e-6])[
                torch.randint(0, 2, w.shape, generator=g)]
        u = (0.5 * torch.randn((h, dh), generator=g)).to(device)
        do = torch.randn((b, s, h, dh), generator=g).to(device, dtype)
        ds = (torch.randn((b, h, dh, dh), generator=g).to(device)
              if state else None)
        return (*x, w.to(device, w_dtype), u, do, ds), chunk
    return [case(f32, 2, 48, 3, 64, 16, ends=True, state=True),
            case(bf, 1, 64, 2, 64, 16),
            case(f32, 1, 17, 3, 8, 1, state=True),
            case(bf, 2, 33, 2, 40, 3, ends=True),
            case(f32, 1, 96, 2, 64, 48, state=True),
            case(f32, 1, 128, 2, 32, 128, ends=True, w_dtype=bf),
            case(bf, 2, 1, 5, 64, 1, state=True),
            case(f32, 2, 32, 3, 5, 16, ends=True),
            case(bf, 1, 4097, 1, 64, 1),
            case(f32, 3, 65, 2, 64, 5, ends=True, state=True),
            case(bf, 3, 129, 2, 64, 3)]


def gla_bwd_case(args, chunk, label, exact=False):
    """The GLA backward kernel on (r, k, v, w, u, dout, dstate) against its
    plain version: fp32 gradients within KERNEL_RTOL of each one's scale,
    bf16 within one bf16 ulp of it; dw 0 below the 1e-20 clamp; the same
    bits on repeat. With ``exact`` also both against the fp64 function
    (``gla_bwd_fp64``) within 1e-6 of each scale. Returns the largest
    deviation from the plain version."""
    import torch
    from repro_torch.kernels import gla_chunked as kgla
    from repro_torch.kernels import ref
    got = kgla.gla_chunked_bwd(*args, chunk=chunk)
    again = kgla.gla_chunked_bwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    del again
    want = ref.gla_chunked_bwd_ref(*args, chunk)
    devs, worst, ok = [], 0.0, same
    for x, y in zip(got, want):
        scale = max(float(y.float().abs().max()), 1e-30)
        err = float((x.float() - y.float()).abs().max())
        tol = BF16_RTOL if y.dtype == torch.bfloat16 else KERNEL_RTOL
        devs.append(err / scale)
        ok = ok and err <= tol * scale
        worst = max(worst, err)
    floor_ok = bool((got[3][args[3] < 1e-20] == 0).all())
    ok = ok and floor_ok
    text = ", ".join(f"{n} {d:.3e}" for n, d in zip(
        ("dr", "dk", "dv", "dw", "du"), devs))
    if exact:
        fp64 = gla_bwd_fp64(*args)
        ex = [float((x.double() - e).abs().max()) / max(float(e.abs().max()),
                                                        1e-300)
              for x, e in zip(got, fp64)]
        ex_p = [float((x.double() - e).abs().max()) / max(float(e.abs().max()),
                                                          1e-300)
                for x, e in zip(want, fp64)]
        ok = ok and all(d <= 1e-6 for d in ex + ex_p)
        text += ("; against fp64, kernel " + ", ".join(f"{d:.2e}" for d in ex)
                 + ", plain " + ", ".join(f"{d:.2e}" for d in ex_p)
                 + " (tol 1e-06)")
    say(f"  {GLA_BWD} {label}: of each scale {text}; dw 0 below the clamp "
        f"{floor_ok}; same bits on repeat {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("the GLA backward kernel disagrees with its plain "
                           "version or the fp64 function")
    return worst


def gla_bwd_checkpoint_bytes(args):
    """Bytes of the GLA backward kernel's checkpoints at (r, k, v, w, u,
    dout[, dstate]): the state before each stage and its cotangent after
    each stage's last token, as the kernel sizes them, written once and
    read once."""
    from repro_torch.kernels import build
    b, s, h, _ = args[0].shape
    floats = build.load().qf_gla_chunked_bwd_workspace(b, s, h, 0)
    return 2 * 2 * 4 * floats


GLA_BWD_KERNELS = ("gla_bwd_scan", "gla_bwd_stage", "gla_bwd_du")


def gla_bwd_split(by_name, launches):
    """The GLA backward's device ms in a profile (``profile_device``'s
    {name: (us, count)}): one line with each of its kernels' total, its
    records and its ms a record, beside the wrapper's ``launches``."""
    import re
    parts = []
    for kernel in GLA_BWD_KERNELS:
        pat = re.compile(rf"::{kernel}[<(]")
        hits = [v for k, v in by_name.items() if pat.search(k)]
        us, cnt = sum(t for t, _ in hits), sum(c for _, c in hits)
        parts.append(f"{kernel} {us / 1e3:.3f} ms x {cnt}"
                     + (f" ({us / 1e3 / cnt:.4f} a launch)" if cnt else ""))
    say(f"    {GLA_BWD}'s kernels in the step ({launches} launches of the "
        "wrapper): " + ", ".join(parts))


def rwkv_one_cycle_gate(cfg, params, batch):
    """One RWKV6 layer at full width (the full model's first layer and
    its embedding) in fp32, the stacked matrices at std 1/sqrt(d_in) and
    the decay, bonus and mixing tensors drawn again (``redraw_rwkv``):
    every parameter's gradient through the two GLA kernels against the
    plain route's (autodiff of the plain chunked form), within
    GRAD_RTOL_FP32 of its scale, each printed. Two planted faults must
    fail it: the backward with the carried dS dropped at every 16-token
    stage (``gla_bwd_dropped_carry``) and one that returns dw = 0.
    Returns the kernel pass's launches."""
    import dataclasses
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import gla_chunked as kgla
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import Model
    cfg32 = dataclasses.replace(cfg, n_layers=cfg.cycle_len, dtype="float32",
                                param_dtype="float32")
    w32 = {k: v.float() for k, v in
           one_cycle_params(cfg, params, well_conditioned=True).items()}
    redraw_rwkv(w32, seed=2)
    t0 = time.time()
    loss_x, _, h_x = loss_and_grads(Model(cfg32, impl="xla"), w32, batch)
    torch.cuda.synchronize()
    t_plain = time.time() - t0
    scale = {k: max(float(h.abs().max()), 1e-30) for k, h in h_x.items()}

    def devs(h):
        dev = {k: float((h[k] - h_x[k]).abs().max()) / scale[k]
               for k in sorted(scale)}
        return dev, [k for k in dev if not dev[k] <= GRAD_RTOL_FP32]
    build.reset_launches()
    loss_k, _, h_k = loss_and_grads(Model(cfg32), w32, batch)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    dev, fails = devs(h_k)
    del h_k
    say(f"  one RWKV6 layer in fp32 ({len(dev)} params, std 1/sqrt(d_in), "
        f"decays redrawn): loss kernels {float(loss_k):.6f}, plain "
        f"{float(loss_x):.6f} (plain pass {t_plain:.1f} s); launches "
        f"{launches}; each gradient through the kernels against the plain "
        f"route's, of its scale (tol {GRAD_RTOL_FP32:.0e}):")
    for k in dev:
        say(f"    {k}: {dev[k]:.3e} {'FAIL' if k in fails else 'ok'}")
    if fails or launches != {"gla_chunked": 2, GLA_BWD: 1}:
        raise RuntimeError(f"RWKV6 gradients through the kernels deviate "
                           f"({fails}) or launched {launches}")
    bwd = kgla.gla_chunked_bwd

    def dropped(*args, chunk):
        return gla_bwd_dropped_carry(bwd, args, chunk)

    def no_dw(*args, chunk):
        dr, dk, dv, dw, du = bwd(*args, chunk=chunk)
        return dr, dk, dv, torch.zeros_like(dw), du
    for label, fn in (("the carried dS dropped every 16 tokens", dropped),
                      ("dw = 0", no_dw)):
        kgla.gla_chunked_bwd = fn
        try:
            _, _, h_f = loss_and_grads(Model(cfg32), w32, batch)
        finally:
            kgla.gla_chunked_bwd = bwd
        dev_f, caught = devs(h_f)
        del h_f
        say(f"  planted fault, {label}: the gate fails at {caught} (worst "
            f"{max(dev_f.values()):.3e})")
        if not caught:
            raise RuntimeError(f"the RWKV6 gradient gate passed a planted "
                               f"fault ({label})")
    del h_x, w32
    torch.cuda.empty_cache()
    return launches


def rwkv_train_cli(device="cuda"):
    """``python -m repro_torch.launch.train --arch rwkv6-7b --scale smoke``
    on the card (``train.main`` in this process, so that its launches
    are counted): 6 steps of B=4 x S=64 (chunk 16), the loss finite, the
    GLA kernels launched as the steps need."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import train
    argv = ["--arch", RWKV_ARCH, "--scale", "smoke", "--steps", "6",
            "--batch", "4", "--seq", "64", "--log-every", "2", "--device",
            device]
    say(f"  python -m repro_torch.launch.train {' '.join(argv)}:")
    build.reset_launches()
    loss = train.main(argv)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    want = {k: 6 * n for k, n in train_launches(
        get_config(RWKV_ARCH).reduced()).items()}
    say(f"  the train CLI: loss {loss:.4f}, launches {launches} (expected "
        f"{want})")
    if not math.isfinite(loss) or launches != want:
        raise RuntimeError("the RWKV6 train CLI failed on the card")


def phase_train_rwkv(device="cuda"):
    """11b: RWKV6-7B trained at published width (depth cut to 16 of 32
    layers) through both GLA kernels; returns the backward kernel's row."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import token_batches
    from repro_torch.kernels import build
    from repro_torch.kernels import gla_chunked as kgla
    from repro_torch.kernels import ref
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import linear_warmup_cosine
    torch.cuda.empty_cache()
    t_phase = time.time()
    full = get_config(RWKV_ARCH)
    cfg = dataclasses.replace(full, n_layers=RWKV_LAYERS)
    b, s = TRAIN_B, TRAIN_S
    model = Model(cfg)
    n_par = model.num_params()
    n_embed = cfg.vocab_size * cfg.d_model
    mem = rwkv_train_memory_gb(n_par, n_embed, b * s, cfg.vocab_size)
    say(f"== phase 11b: {cfg.name} training at published width (d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, gla_chunk {cfg.gla_chunk}, "
        f"{cfg.param_dtype} params, {cfg.opt_state_dtype} AdamW moments, "
        f"remat {cfg.remat}); depth cut from {full.n_layers} to "
        f"{cfg.n_layers} layers ({n_par:,} params: at 12 bytes a parameter "
        f"the full depth needs ~91 GB of the card's 80): B={b}, S={s}, "
        f"{TRAIN_STEPS} steps on one batch; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held on entry")
    say("  counted: " + ", ".join(f"{k} {v:.2f} GB" for k, v in mem.items())
        + f"; {sum(mem.values()):.1f} GB (limit {RWKV_PEAK_GIB:.0f} GiB)")
    if sum(mem.values()) > RWKV_PEAK_GIB * 2**30 / 1e9:
        raise RuntimeError("phase 11b's counted peak passes the limit")
    t0 = time.time()
    params = model.init(seed=0, device=device)
    redraw_rwkv(params, seed=1)
    batch = next(token_batches(cfg, b, s, seed=0, device=device))
    torch.cuda.synchronize()
    say(f"  init in {time.time() - t0:.1f} s (decay, bonus and mixing "
        f"tensors redrawn)")
    t0 = time.time()
    launches32 = rwkv_one_cycle_gate(cfg, params, batch)
    say(f"  (the gradient gate in {time.time() - t0:.1f} s)")

    opt = train.optimizer(cfg)
    schedule = linear_warmup_cosine(RWKV_LR, TRAIN_WARMUP, TRAIN_STEPS)
    state = opt.init(params)
    step_fn = make_train_step(model, opt)
    per_step = train_launches(cfg)
    bwd_orig, rec = kgla.gla_chunked_bwd, []

    def bwd_rec(*args, chunk):
        if not rec:
            rec.append((tuple(None if x is None else x.detach()
                              for x in args), chunk))
        return bwd_orig(*args, chunk=chunk)
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        build.reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        kgla.gla_chunked_bwd = bwd_rec if i == 0 else bwd_orig
        try:
            start.record()
            params, state, metrics = step_fn(params, state, batch,
                                             schedule(i))
            end.record()
            torch.cuda.synchronize()
        finally:
            kgla.gla_chunked_bwd = bwd_orig
        launches = dict(build.LAUNCHES)
        if i == 0:
            first = launches
        losses.append(float(metrics["loss"]))
        step_ms.append(start.elapsed_time(end))
        say(f"  step {i + 1}: loss {losses[-1]:.6f}, lr "
            f"{float(schedule(i)):.3e}, {step_ms[-1]:.1f} ms, launches "
            f"{launches}")
        if launches != per_step:
            raise RuntimeError(f"train step launched {launches}, expected "
                               f"{per_step}")
        if not math.isfinite(losses[-1]):
            raise RuntimeError("non-finite training loss")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall: {losses}")
    if peak > RWKV_PEAK_GIB:
        raise RuntimeError(f"phase 11b peaked at {peak:.2f} GiB")
    ms = sum(step_ms[1:]) / (TRAIN_STEPS - 1)
    say(f"  loss {losses[0]:.6f} -> {losses[-1]:.6f} (AdamW grad_clip "
        f"{opt.grad_clip}, peak lr {RWKV_LR}, warmup {TRAIN_WARMUP}); "
        f"{ms:.1f} ms/step over steps 2-{TRAIN_STEPS} (CUDA events), "
        f"{b * s / ms * 1e3:,.0f} tokens/s, peak {peak:.2f} GiB; launches "
        f"a step {per_step}; card {smi('name,power.limit')}")
    by_name = profile_device("one RWKV6 train step", lambda: step_fn(
        params, state, batch, schedule(TRAIN_STEPS)))
    gla_bwd_split(by_name, per_step[GLA_BWD])
    del state, params
    torch.cuda.empty_cache()

    say(f"  {GLA_BWD} at the step's recorded inputs and ragged shapes, "
        "against its plain version:")
    args, chunk = rec[0]
    if args[6] is not None or args[0].dtype != torch.bfloat16 \
            or args[3].dtype != torch.float32:
        raise RuntimeError("the train step's GLA backward took other "
                           "operands than bf16 r, k, v, dout, fp32 w and no "
                           "dstate")
    if not kgla.backward_copies_by_tma(*args[:6]):
        raise RuntimeError("the train step's GLA backward operands do not "
                           "take the kernel's TMA copies")
    t0 = time.time()
    worst = gla_bwd_case(args, chunk, f"path {[list(args[0].shape)]} bf16, w "
                         f"fp32, chunk {chunk}, no dstate")
    for r_args, r_chunk in gla_bwd_ragged(device):
        label = (f"ragged {list(r_args[0].shape)} {str(r_args[0].dtype)[6:]}"
                 f", w {str(r_args[3].dtype)[6:]}, chunk {r_chunk}, dstate "
                 f"{r_args[6] is not None}")
        gla_bwd_case(r_args, r_chunk, label, exact=(
            r_args[0].shape[1] <= 128 and r_args[0].dtype == torch.float32
            and r_args[3].dtype == torch.float32))
    k_ms = cuda_ms(lambda: kgla.gla_chunked_bwd(*args, chunk=chunk), reps=10,
                   warmup=2)
    p_ms = cuda_ms(lambda: ref.gla_chunked_bwd_ref(*args, chunk), reps=1,
                   warmup=1)
    dev_us = device_us(lambda *x: kgla.gla_chunked_bwd(*x, chunk=chunk),
                       list(args), n=3)
    b_ms, b_by = gla_bwd_bound_ms(args)
    f_ms = cuda_ms(lambda: kgla.gla_chunked(*args[:5], chunk=chunk), reps=10,
                   warmup=2)
    say(f"  {GLA_BWD} timed at {list(args[0].shape)} bf16, w fp32, chunk "
        f"{chunk}: kernel {k_ms:.4f} ms (device {dev_us:.2f} us a launch; "
        f"the forward kernel {f_ms:.4f} ms at the same inputs), plain "
        f"{p_ms:.4f} ms, library n/a, bound {b_ms:.6f} ms ({b_by}), "
        f"kernel/bound {k_ms / b_ms:.2f}x; TMA copies; checkpoints "
        f"{gla_bwd_checkpoint_bytes(args) / 1e6:.1f} MB written and read "
        f"beside the function's {gla_bwd_bytes(args) / 1e6:.1f} MB; card "
        f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')} (checks "
        f"and times in {time.time() - t0:.1f} s)")
    row = dict(name=GLA_BWD, route="cuda", source=GLA_BWD_SOURCE,
               replaces=GLA_BWD_REPLACES, launches=first[GLA_BWD],
               shape=[list(args[0].shape), list(args[4].shape)],
               max_abs_err=worst, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=None, device_us=dev_us,
               cell=f"{cfg.name} train step B={b} S={s}, {cfg.n_layers} of "
               f"{full.n_layers} layers")
    del args, rec
    torch.cuda.empty_cache()
    rwkv_train_cli(device)
    say(f"  phase 11b took {time.time() - t_phase:.1f} s (the one-layer gate's"
        f" fp32 kernel pass: {launches32})")
    return [row]


# --------------------------------- phase 12: the classical federation
# 12a: Qwen1.5-4B at its published width, depth cut from 40 to 8 layers
# (at 40, two nodes' fp32 AdamW moments alone are 63.2 GB); the spec of
# ROADMAP.md Queue 1 item 5(b)'s slice: a local step is B=2 x S=4096
FED_ARCH, FED_LAYERS, FED_ROUNDS = "qwen1.5-4b", 8, 3
FED_SPEC = dict(num_nodes=4, nodes_per_round=2, interval_length=2,
                node_batch=2, seq_len=4096, lr=3e-3, eval_batch=2,
                data_seed=0)
# 12b: the reference's classical test sizes (tests/test_fed_api.py:207);
# SGD at 0.1 for the kernel-vs-plain round, so the deltas stand well
# above the fp32 rounding of the params they are differences of
FED_SMALL = dict(num_nodes=3, nodes_per_round=2, interval_length=2,
                 node_batch=2, seq_len=16, data_seed=0)
FED_SMALL_LR = 0.1


def fed_memory_gb(n_par, n_p, tokens_step, vocab):
    """Device memory the federated round must hold at its peak, counted
    (decimal GB): every selected node's fp32 AdamW moments and fp32
    delta, the bf16 global params and one node's working copy, the bf16
    grads, and the fp32 logits of a local step with their gradient."""
    return {"moments": 2 * n_p * 4 * n_par / 1e9,
            "deltas": n_p * 4 * n_par / 1e9,
            "params + a node's copy": 2 * 2 * n_par / 1e9,
            "grads": 2 * n_par / 1e9,
            "logits + gradient": 2 * 4 * tokens_step * vocab / 1e9}


def fed_full_width(device="cuda"):
    """12a: Qwen1.5-4B at full width through ``ClassicalSubstrate`` and a
    ``FederationSession`` for FED_ROUNDS rounds; returns the attention
    kernels' rows at the path's shape."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.fed import api
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import Model
    torch.cuda.empty_cache()
    full = get_config(FED_ARCH)
    cfg = dataclasses.replace(full, n_layers=FED_LAYERS)
    spec = api.FedSpec.classical(arch=FED_ARCH, **FED_SPEC)
    model = Model(cfg)
    n_par = model.num_params()
    n_p, il, s = spec.nodes_per_round, spec.interval_length, spec.seq_len
    per = (spec.node_pool_seqs or 2 * spec.node_batch) // il
    tokens = n_p * il * per * s
    say(f"== phase 12a: {FED_ARCH} classical federation at full width "
        f"(d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, qkv bias "
        f"{cfg.qkv_bias}, {cfg.param_dtype} params, {cfg.opt_state_dtype} "
        f"AdamW moments, remat {cfg.remat}, q_chunk {cfg.q_chunk}); depth "
        f"cut from {full.n_layers} to {cfg.n_layers} layers "
        f"({n_par:,} params): N={spec.num_nodes}, N_p={n_p}, I_l={il}, "
        f"local steps B={per} x S={s}, lr {spec.lr}, {FED_ROUNDS} rounds of "
        f"{tokens:,} tokens; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"held on entry")
    mem = fed_memory_gb(n_par, n_p, per * s, cfg.vocab_size)
    say("  counted: " + ", ".join(f"{k} {v:.2f} GB" for k, v in mem.items())
        + f"; {sum(mem.values()):.1f} GB")
    t0 = time.time()
    sub = api.ClassicalSubstrate(spec, model=model, device=device)
    sess = api.FederationSession.create(spec, 0, substrate=sub)
    torch.cuda.synchronize()
    say(f"  substrate and session in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    per_step = train_launches(cfg)
    want = {k: per_step[k] * n_p * il for k in ("flash_attention", ATTN_BWD)}
    losses = [sess.record_eval()["eval_loss"]]
    say(f"  round 0: eval loss {losses[0]:.6f}")
    bwd_orig, bwd_first = kfa.flash_attention_bwd, []

    def bwd_rec(*args, **kw):
        if not bwd_first:
            bwd_first.append((tuple(x.detach() for x in args), kw))
        return bwd_orig(*args, **kw)
    ms, counted = [], []

    def one_round(r):
        build.reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = sess.step()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        launches = {k: n for k, n in build.LAUNCHES.items() if n}
        counted.append(launches)
        losses.append(sess.record_eval()["eval_loss"])
        say(f"  round {r}: eval loss {losses[-1]:.6f}, train loss "
            f"{float(metrics['loss']):.6f}, {ms[-1]:.1f} ms, launches "
            f"{launches}")
        if launches != want:
            raise RuntimeError(f"round {r} launched {launches}, expected "
                               f"{want}")
        if not math.isfinite(losses[-1]):
            raise RuntimeError("non-finite eval loss")
    torch.cuda.reset_peak_memory_stats()
    kfa.flash_attention_bwd = bwd_rec
    try:
        with Recorder({"attention": "flash_attention"}) as rec:
            one_round(1)
    finally:
        kfa.flash_attention_bwd = bwd_orig
    for r in range(2, FED_ROUNDS + 1):
        one_round(r)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the eval loss did not fall: {losses}")
    ms_round = sum(ms[1:]) / len(ms[1:])
    say(f"  eval loss {losses[0]:.6f} -> {losses[-1]:.6f}; "
        f"{ms_round:.1f} ms/round over rounds 2-{FED_ROUNDS} (CUDA events; "
        f"round 1 {ms[0]:.1f}), {tokens / ms_round * 1e3:,.0f} tokens/s, "
        f"peak {peak:.2f} GiB; launches a round {want}; card "
        f"{smi('name,power.limit')}")
    profile_device(f"one federated round (round {FED_ROUNDS + 1})",
                   sess.step)
    del sess, sub, model
    torch.cuda.empty_cache()
    say(f"  the session's {FED_ROUNDS + 1} rounds with their evaluations "
        f"in {time.time() - t0:.1f} s")
    t0 = time.time()

    (q, k, v, o, do), kw = bwd_first[0]
    say(f"  the attention kernels at the path's inputs (MHA: G = "
        f"{q.shape[0] // k.shape[0]}, dh {q.shape[2]}, causal, no window), "
        f"against their plain versions:")
    lse_check(q, k, v, kw, "path bf16 (the recompute's, saved for the "
              "backward)", lse=kw["lse"])
    worst = attn_bwd_case((q, k, v, o, do), kw, "path bf16")
    cell = f"{FED_ARCH} {FED_LAYERS} layers, fed round B={per} S={s}"
    fwd = check_and_time_seq(rec, {"flash_attention": []}, fp32=False)
    del rec
    bwd = attn_bwd_timing(q, k, v, o, do, kw)
    # the launches counted in round 1 (every round's equal ``want``)
    fwd["flash_attention"].update(launches=counted[0]["flash_attention"],
                                  cell=cell)
    rows = [fwd["flash_attention"], dict(
        name=ATTN_BWD, route="cuda", source=ATTN_BWD_SOURCE,
        replaces=SEQ_KERNELS["flash_attention"]["replaces"],
        launches=counted[0][ATTN_BWD], shape=[list(x.shape) for x in (q, k)],
        max_abs_err=worst, cell=cell, **bwd)]
    del q, k, v, o, do, kw, bwd_first
    torch.cuda.empty_cache()
    say(f"  the kernels' checks and times at the path's shape in "
        f"{time.time() - t0:.1f} s")
    return rows


def fed_kernel_round(arch, overrides, device="cuda"):
    """One round of ``ClassicalSubstrate`` through the kernels against the
    same round through the plain versions (``Model(impl="xla")``): the
    same params, key, cohort and data, SGD as the inner optimizer. The
    params are the init's with the stacked matrices at std 1/sqrt(d_in)
    (``one_cycle_params``: at the init's stacked fan-in the gates and the
    softmax saturate, and the second local step amplifies the first
    one's rounding); RWKV6's decay, bonus and mixing tensors drawn again
    (``redraw_rwkv``). The aggregated delta within GRAD_RTOL_FP32 of each
    leaf's scale; the launches exact; every kernel call of the round,
    forward and backward, against its plain version at its recorded
    inputs."""
    import torch
    from repro_torch.core.fed import api, fed_step
    from repro_torch.core.fed.api import phases
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import gla_chunked as kgla
    from repro_torch.models import Model
    from repro_torch.optim import SGD
    spec = api.FedSpec.classical(arch=arch, lr=FED_SMALL_LR, **overrides,
                                 **FED_SMALL)
    sub = api.ClassicalSubstrate(spec, opt=SGD(), device=device)
    plain = api.ClassicalSubstrate(spec, model=Model(sub.cfg, impl="xla"),
                                   opt=SGD(), device=device)
    params = one_cycle_params(sub.cfg, sub.model.init(seed=0, device=device),
                              well_conditioned=True, cycles=sub.cfg.n_cycles)
    if "rwkv" in sub.cfg.block_pattern:
        redraw_rwkv(params, seed=1)
    state = sub.init_state(0, params=params)
    steps = spec.nodes_per_round * spec.interval_length
    want = {k: n * steps for k, n in train_launches(sub.cfg).items()
            if k != SCAN_REV}
    bwd_calls = {ATTN_BWD: [], GLA_BWD: []}
    origs = {ATTN_BWD: (kfa, kfa.flash_attention_bwd),
             GLA_BWD: (kgla, kgla.gla_chunked_bwd)}

    def recording(name, fn):
        def rec_call(*args, **kw):
            bwd_calls[name].append((tuple(
                None if x is None else x.detach() for x in args), kw))
            return fn(*args, **kw)
        return rec_call
    build.reset_launches()
    for name, (mod, fn) in origs.items():
        setattr(mod, name, recording(name, fn))
    try:
        with Recorder({"attention": "flash_attention",
                       "lru_scan": "rglru_scan",
                       "gla_chunked": "gla_chunked"}) as rec:
            _, cohort, got, _ = phases.dispatch_round(
                sub, sub.snapshot(state), 5, 0)
            torch.cuda.synchronize()
    finally:
        for name, (mod, fn) in origs.items():
            setattr(mod, name, fn)
    launches = {k: n for k, n in build.LAUNCHES.items() if n}
    _, _, ref_up, _ = phases.dispatch_round(
        plain, plain.snapshot(state), 5, 0)
    zero = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in state["params"].items()}
    agg = fed_step.aggregate_deltas(zero, got, cohort.weights, 1.0)[0]
    agg_x = fed_step.aggregate_deltas(zero, ref_up, cohort.weights, 1.0)[0]
    dev = {k: float((agg[k] - x).abs().max())
           / max(float(x.abs().max()), 1e-30) for k, x in agg_x.items()}
    worst = max(dev, key=dev.get)
    say(f"  {sub.cfg.name} ({sub.cfg.n_layers} layers "
        f"{sub.cfg.block_pattern}, {sub.cfg.dtype}): one round through the "
        f"kernels against the plain route, SGD lr {spec.lr}: the aggregated "
        f"delta within {dev[worst]:.3e} of its scale at worst ({worst}; tol "
        f"{GRAD_RTOL_FP32:.0e}); launches {launches} (expected {want})")
    if dev[worst] > GRAD_RTOL_FP32:
        raise RuntimeError(f"the kernel round's delta deviates: {dev}")
    if launches != want:
        raise RuntimeError(f"the kernel round launched {launches}")
    op = {"flash_attention": ops.attention, "rglru_scan": ops.lru_scan,
          "gla_chunked": ops.gla_chunked}
    for name, calls in rec.calls.items():
        for key, (cnt, args, kw) in calls.items():
            outs = op[name](*args, **no_impl(kw))
            ref_outs = op[name](*args, **dict(no_impl(kw), impl="xla"))
            for out, ref_out in zip(*(x if isinstance(x, tuple) else (x,)
                                      for x in (outs, ref_outs))):
                err = float((out - ref_out).abs().max())
                scale = max(1.0, float(ref_out.abs().max()))
                say(f"    {name} {[list(a.shape) for a in args]} x{cnt}: "
                    f"max_abs_err {err:.3e} (tol {KERNEL_RTOL:.0e} x scale "
                    f"{scale:.3g})")
                if err > KERNEL_RTOL * scale:
                    raise RuntimeError(f"{name} disagrees with its plain "
                                       "version")
    if bwd_calls[ATTN_BWD]:
        attn_bwd_case(*bwd_calls[ATTN_BWD][0], f"{sub.cfg.name} round fp32")
    if bwd_calls[GLA_BWD]:
        args, kw = bwd_calls[GLA_BWD][0]
        gla_bwd_case(args, kw["chunk"], f"{sub.cfg.name} round fp32",
                     exact=True)
    return launches


def fed_resume_bit_exact(device="cuda"):
    """tests/test_fed_api.py:322's kill-and-resume on the card, with the
    driver's conventions (params from seed 0, the sequential key plan of
    seed 7): 2 rounds, save, resume from the file, 2 more, against 4
    straight rounds: params, every opt/ leaf and the history bit for
    bit."""
    import tempfile
    import torch
    from repro_torch.core.fed import api
    from repro_torch.optim.tree import tree_leaves
    spec = api.FedSpec.classical(arch=FED_ARCH, n_layers=1, **FED_SMALL)

    def session():
        sub = api.ClassicalSubstrate(spec, device=device)
        params = sub.model.init(seed=spec.data_seed, device=sub.device)
        return api.FederationSession.create(
            spec, spec.data_seed, substrate=sub, params=params,
            round_keys=api.sequential_split_plan(spec.data_seed + 7, 4))
    straight = session()
    straight.run(4, callbacks=[api.EvalEvery(1)])
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        killed = session()
        killed.run(2, callbacks=[api.EvalEvery(1)])
        path = str(Path(tmp) / "fed.npz")
        killed.save(path)
        del killed
        resumed = api.FederationSession.resume(path)
        resumed.run(2, callbacks=[api.EvalEvery(1)])
    a, b = tree_leaves(straight.state), tree_leaves(resumed.state)
    same = (len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
            and resumed.history == straight.history)
    say(f"  kill-and-resume ({spec.arch} 1 layer, 2 + 2 rounds against 4): "
        f"{len(a)} state leaves (params and opt/), history "
        f"{straight.history['eval_loss']}, bit for bit {same}")
    if not same:
        raise RuntimeError("the resumed classical session diverged")


def fed_train_cli(device="cuda"):
    say(f"  python -m repro_torch.launch.fed_train --arch qwen1.5-4b "
        f"--rounds 2 --device {device}:")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.fed_train",
                          "--arch", FED_ARCH, "--rounds", "2", "--device",
                          device], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    lines = out.stdout.strip().splitlines()
    for line in lines + out.stderr.strip().splitlines()[-4:]:
        say("    " + line)
    heads = (f"fed arch={FED_ARCH}-smoke ", "round  0  eval loss ",
             "round  1  eval loss ", "round  2  eval loss ")
    if out.returncode != 0 or len(lines) != 4 or not all(
            line.startswith(h) for line, h in zip(lines, heads)):
        raise RuntimeError("the fed_train CLI failed")


def phase_fed(device="cuda"):
    t0 = time.time()
    rows = fed_full_width(device)
    t12a = time.time() - t0
    say("== phase 12b: the classical federation at reduced width (fp32, "
        "the reference's test sizes: N=3, N_p=2, I_l=2, B=2, S=16)")
    for arch, overrides in (("qwen1.5-4b", dict(n_layers=1)),
                            ("recurrentgemma-2b", {}), ("rwkv6-7b", {})):
        fed_kernel_round(arch, overrides, device)
    for part in (fed_resume_bit_exact, fed_train_cli):
        t = time.time()
        part(device)
        say(f"  ({part.__name__} in {time.time() - t:.1f} s)")
    say(f"  phase 12 took {time.time() - t0:.1f} s (12a {t12a:.1f} s)")
    return rows

# ------------------------------------------------- phase 13: the model zoo
# The seven architectures of the moe kind, M-RoPE, cross-attention and
# embedding inputs at their published widths, depth cut to whole pattern
# cycles: the bf16 weights, then (after they are freed) their fp32 copy
# for the budget (4 bytes a parameter) and the plain route's fp32 score
# chunks must stay under ZOO_PEAK_GIB. (arch, layers run, batch, why that
# cut; the prompts are SERVE_S long)
ZOO = (
    ("llama4-scout-17b-a16e", 4, 4, "fp32 copy 43.5 GB at 4 layers"),
    ("arctic-480b", 1, 4, "one layer is 13.7 B params: fp32 copy 56.3 GB"),
    ("gemma3-27b", 12, 4, "two 6-layer cycles, fp32 copy 25.5 GB"),
    ("command-r-35b", 8, 4, "fp32 copy 31.0 GB at 8 layers"),
    ("llama3-405b", 2, 2, "one layer is 3.2 B params: fp32 copy 42.3 GB; "
     "B=2: at B=4 the plain fp32 route's 8 GiB score chunks on top of it "
     "ran out of the card"),
    ("qwen2-vl-72b", 8, 4, "fp32 copy 38.0 GB at 8 layers"),
    ("musicgen-large", 48, 4, "all layers, fp32 copy 12.9 GB"),
)
ZOO_PEAK_GIB = 70.0


def fp32_weights(cfg, device):
    """The seed-0 weights in fp32 with the bf16 model's values: the fp32
    init (the bf16 init is its rounding) rounded through bf16 in place."""
    from repro_torch.models import Model
    p32 = Model(fp32_cfg(cfg)).init(seed=0, device=device)
    round_through_(p32, cfg.param_torch_dtype)
    return p32


def zoo_attention_rows(rec, arch):
    """The attention kernel at each shape the arch's main-path prefill
    handed it (``rec``, open around that run): against its plain version
    (one bf16 ulp of the scale, as ``check_and_time_seq``); the fp32
    kernel, which the budgets' fp32 prefills launch at these shapes, on
    seeded unit-scale inputs of one batch row of that shape within
    KERNEL_RTOL of the scale of its plain fp32 version, as phase 5 holds
    it; then kernel, plain and SDPA (the yardstick checked first) timed,
    the bound, the device time a launch. Returns the JSON rows (launches:
    that shape's count in the main-path prefill)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops, ref
    rows = []
    for cnt, args, kw in rec.calls["flash_attention"].values():
        kw = no_impl(kw)
        q, k, v = args
        got = ops.attention(q, k, v, **kw)
        want = ops.attention(q, k, v, **dict(kw, impl="xla"))
        err = float((got.float() - want.float()).abs().max())
        scale = max(1.0, float(want.float().abs().max()))
        ok = err <= BF16_RTOL * scale
        cell = (f"{arch} prefill, "
                f"{'causal' if kw['causal'] else 'cross-attention'}"
                f"{', window %d' % kw['window'] if kw['window'] else ''}")
        say(f"  flash_attention {cell} {[list(x.shape) for x in args]} "
            f"x{cnt}: max_abs_err {err:.3e} (tol {BF16_RTOL:.2e} x scale "
            f"{scale:.3g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("flash_attention disagrees with its plain "
                               f"version at {cell}")
        g = torch.Generator(device=q.device).manual_seed(14)
        unit = [torch.randn((x.shape[2], x.shape[1], x.shape[3]),
                            generator=g, device=q.device) for x in args]
        got32, want32 = (fn(*unit, **kw) for fn in (kfa.flash_attention,
                                                    ref.attention_ref))
        err32 = float((got32 - want32).abs().max())
        scale32 = max(1.0, float(want32.abs().max()))
        ok = err32 <= KERNEL_RTOL * scale32
        say(f"  flash_attention fp32 storage (3xTF32), unit-scale inputs "
            f"of one batch row at {cell}: max_abs_err {err32:.3e} (tol "
            f"{KERNEL_RTOL:.0e} x scale {scale32:.3g}) "
            f"{'ok' if ok else 'FAIL'}")
        del unit, got32, want32
        if not ok:
            raise RuntimeError("the fp32 flash_attention disagrees with its "
                               f"plain version at {cell}")

        def heads_major(x):                 # the layout ops hands over
            bx, sx, hx, dx = x.shape
            return ops._dense(x.transpose(1, 2).reshape(bx * hx, sx, dx))
        qf, kf, vf = (heads_major(x) for x in (q, k, v))
        k_ms = cuda_ms(lambda: kfa.flash_attention(qf, kf, vf, **kw),
                       reps=5, warmup=1)
        p_ms = cuda_ms(lambda: ref.attention_ref(qf, kf, vf, **kw),
                       reps=3, warmup=1)
        mask = ref.attention_mask(q.shape[1], k.shape[1], kw["causal"],
                                  kw["window"], q.device)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)
        lib_err = float((lib().transpose(1, 2).float()
                         - want.float()).abs().max())
        if lib_err > YARDSTICK_RTOL * float(want.float().abs().max()):
            raise RuntimeError("SDPA yardstick disagrees with the plain "
                               f"attention at {cell}")
        lib_ms = cuda_ms(lib, reps=5, warmup=1)
        del got, want
        b_ms, b_by = seq_bound_ms("flash_attention", args, kw)
        dev_us = device_us(lambda *x: kfa.flash_attention(*x, **kw),
                           [qf, kf, vf])
        b, sq, h, dh = q.shape
        flops = 4 * dh * b * h * allowed_pairs(sq, k.shape[1], **kw)
        say(f"  flash_attention {cell}: kernel {k_ms:.4f} ms (device "
            f"{dev_us:.2f} us a launch, {flops / k_ms / 1e9:.1f} TFLOP/s), "
            f"plain {p_ms:.4f} ms, SDPA {lib_ms:.4f} ms (yardstick "
            f"{lib_err:.3e}), bound {b_ms:.6f} ms ({b_by}), kernel/bound "
            f"{k_ms / b_ms:.2f}x, {k_ms / lib_ms:.3f}x SDPA's time")
        rows.append(dict(name="flash_attention", route="cuda",
                         **SEQ_KERNELS["flash_attention"],
                         shape=[list(x.shape) for x in args],
                         max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                         device_us=dev_us, launches=cnt, cell=cell))
        del qf, kf, vf, mask
        torch.cuda.empty_cache()
    return rows


def zoo_ragged(device="cuda"):
    """The bf16 kernel on ragged shapes of the zoo's kinds, seeded,
    against its plain version (one bf16 ulp of the scale): the groups G
    = 5, 7, 2 (window 1024), 8, 16 and 1 at dh 64, causal, S not a
    multiple of the tile; and cross-attention (not causal) with Sk = 256
    and 200 keys against 4096 and 1000 queries."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref
    g = torch.Generator(device="cpu").manual_seed(13)
    # (bh, bk, sq, sk, dh, window, causal)
    cases = [(10, 2, 333, 333, 128, 0, True), (14, 2, 200, 200, 128, 0, True),
             (4, 2, 1500, 1500, 128, 1024, True),
             (16, 2, 130, 130, 128, 0, True), (32, 2, 100, 100, 128, 0, True),
             (4, 4, 150, 150, 64, 0, True), (32, 32, 4096, 256, 64, 0, False),
             (32, 32, 4096, 200, 64, 0, False),
             (16, 2, 1000, 200, 128, 0, False)]
    for bh, bk, sq, sk, dh, window, causal in cases:
        q, k, v = (torch.randn(shape, generator=g).to(device, torch.bfloat16)
                   for shape in ((bh, sq, dh), (bk, sk, dh), (bk, sk, dh)))
        kw = dict(causal=causal, window=window)
        got = kfa.flash_attention(q, k, v, **kw).float()
        want = ref.attention_ref(q, k, v, **kw).float()
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        ok = err <= BF16_RTOL * scale
        say(f"  flash_attention ragged (bh {bh}, bk {bk}, Sq {sq}, Sk {sk}, "
            f"dh {dh}, {kw}): max_abs_err {err:.3e} (tol {BF16_RTOL:.2e} x "
            f"scale {scale:.3g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("flash_attention disagrees with its plain "
                               "version on a ragged zoo shape")


def zoo_features(cfg):
    parts = [str(cfg.block_pattern)]
    if cfg.window:
        parts.append(f"window {cfg.window}")
    if cfg.n_experts:
        parts.append(f"{cfg.n_experts} experts top-{cfg.top_k}"
                     f"{' + dense residual' if cfg.moe_dense_residual else ''}"
                     f"{' + shared expert' if cfg.shared_expert else ''}")
    if cfg.pos_kind == "mrope":
        parts.append(f"M-RoPE {cfg.mrope_sections}")
    if cfg.cross_attn:
        parts.append(f"cross-attention to {cfg.cond_len}")
    parts.append(f"{cfg.input_kind} input")
    return ", ".join(parts)


def zoo_arch(arch, layers, b, why, device="cuda"):
    """One architecture of phase 13, one copy of its weights on the card
    at a time. At the seed-0 init in bf16: the prefill through the kernels
    (the main path: launches zeroed before, read after, exact; its
    attention calls recorded in that run), the plain bf16 prefill, 32
    greedy decode tokens, and the first step against a prefill of S + 1
    positions. Then the same weights at ``condition_``'s scale, where the
    bf16 budget is a small share of the scale: the kernel and the plain
    bf16 prefill, routed alike, and the first decode step again. With the
    bf16 weights freed, their fp32 copy gives the budgets and the fp32
    gate (``zoo_fp32_gates``); then the attention kernel at the main
    path's shapes. Returns the JSON rows and a summary."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import concrete_batch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import Model
    t0 = time.time()
    s, n_gen = SERVE_S, SERVE_GEN
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    if layers % cfg.cycle_len:
        raise RuntimeError(f"{arch}: {layers} layers is not whole cycles")
    model = Model(cfg)
    say(f"== phase 13: {arch} at published width (d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {zoo_features(cfg)}, "
        f"{cfg.dtype}); depth cut {layers} of {full.n_layers} layers "
        f"({why}): {model.num_params():,} params; B={b}, S={s}, {n_gen} "
        "decode tokens")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(seed=0, device=device)
    batch = concrete_batch(cfg, b, s, torch.Generator().manual_seed(1),
                           kind="prefill", device=device)
    prefill = make_prefill_step(model)
    plain = make_prefill_step(Model(cfg, impl="xla"))
    with DropCount() as drops:
        prefill(params, batch)                  # warm-up
        torch.cuda.synchronize()
    drops.report("the prefill")
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": (2 if cfg.cross_attn else 1) * cfg.n_layers}
    timing = {}
    rec, pins = Recorder({"attention": "flash_attention"}), PinnedRouting()
    logits, cache, launches = prefill_main_path(
        prefill, params, batch, want, timing, around=(rec, pins.record()))
    per_shape = [c for c, _, _ in rec.calls["flash_attention"].values()]
    if sum(per_shape) != launches["flash_attention"]:
        raise RuntimeError(f"the attention calls by shape {per_shape} do not "
                           f"sum to the launches {launches}")
    if tuple(logits.shape) != (b, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise RuntimeError(f"prefill logits {tuple(logits.shape)} not finite")
    plain_logits, dev = plain_bf16_dev(cfg, params, batch, logits, cache)
    decode_ms = decode_run(cfg, model, params, batch, logits, cache, n_gen)
    moe = pins if cfg.n_experts else None
    dec = (None, None) if drops.dropped else first_step_dev(
        cfg, model, params, batch, logits, cache, moe)
    del cache
    # the same weights at condition_'s scale, routed alike
    condition_(params)
    pins_c = PinnedRouting()
    with pins_c.record():
        plain_c, _ = plain(params, batch)
    with pins_c.replay(), DropCount() as drops_c:
        kern_c, cache_c = prefill(params, batch)
    drops_c.report("at condition_'s weights, the kernel prefill")
    with pins_c.replay(), attention_called(half_window):
        control_c, _ = prefill(params, batch)
    dev_c, control_c = (logit_dev(x, plain_c) for x in (kern_c, control_c))
    dec_c = (None, None) if drops_c.dropped else first_step_dev(
        cfg, model, params, batch, kern_c, cache_c,
        pins_c if cfg.n_experts else None)
    peak = max(peak, torch.cuda.max_memory_allocated())
    del params, cache_c
    torch.cuda.empty_cache()
    p32 = fp32_weights(cfg, device)
    g = zoo_fp32_gates(cfg, p32, batch, plain_logits, plain_c, pins_c)
    if g["launches32"] != want:
        raise RuntimeError(f"the fp32 prefill launched {g['launches32']}")
    lim_c = ZOO_BF16_FACTOR * g["budget_c"]
    ok = dev <= g["budget"] and dev_c <= lim_c < control_c
    say(f"  last-position logits, kernels vs plain, bf16: at the reference "
        f"init {dev:.3e} of the scale {float(plain_logits.abs().max()):.4g}"
        f" (budget {g['budget']:.3e}: plain bf16 vs plain fp32, same weights"
        f" and batch); at condition_'s weights {dev_c:.3e} of the scale "
        f"{float(plain_c.abs().max()):.4g} (budget {g['budget_c']:.3e}, "
        f"limit {ZOO_BF16_FACTOR}x: {lim_c:.3e}) {'ok' if ok else 'FAIL'}; "
        f"the control, every causal call windowed to S/2, {control_c:.3e} "
        f"{'fails it, as it must' if control_c > lim_c else 'PASSES'}")
    ok32 = g["dev32"] <= ZOO_FP32_RTOL < g["control"]
    say(f"  fp32 at condition_'s weights: the kernel prefill {g['dev32']:.3e}"
        f" of the scale off the plain one (tol {ZOO_FP32_RTOL:.0e}); the "
        f"control, its attention's q, k, v rounded to TF32, "
        f"{g['control']:.3e} {'ok' if ok32 else 'FAIL'} (the control must "
        f"fail the tol; at the reference init the kernel prefill "
        f"{g['at_init']:.3e})")
    if cfg.n_experts:
        say(f"  routed alike at condition_'s weights: of the plain bf16 "
            f"prefill's expert choices, {pins_c.choices:,} replayed, the "
            f"replaying prefills' own top-k would have changed "
            f"{pins_c.differ:,}")
    say(f"  fp32 kernel prefill launches: {g['launches32']}")
    if not (ok and ok32):
        raise RuntimeError("the kernel prefill deviates from the plain one "
                           "beyond its limit, or a control passes it")
    for (dev_dec, s1), lim, where, dropped in (
            (dec, g["budget"], " at the reference init", drops.dropped),
            (dec_c, lim_c, f" at condition_'s weights ({ZOO_BF16_FACTOR}x "
             "the budget)", drops_c.dropped)):
        if dev_dec is None:
            say(f"  decode{where}: checked for finite logits only: "
                f"{'the prompt' if dropped else 'the S+1 prefill'} dropped "
                f"expert assignments, so no prefill is the decode step's "
                f"function (decode launches no kernel)")
            continue
        if s1 != want:
            raise RuntimeError(f"the S+1 prefill launched {s1}")
        decode_gate(dev_dec, lim, s, s1, where)
    peak = max(peak, torch.cuda.max_memory_allocated()) / 2**30
    say(f"  peak {peak:.2f} GiB (limit {ZOO_PEAK_GIB:.0f})")
    if peak > ZOO_PEAK_GIB:
        raise RuntimeError(f"{arch} peaked at {peak:.2f} GiB")
    rows = zoo_attention_rows(rec, arch)
    del rec
    torch.cuda.empty_cache()
    summary = dict(arch=arch, layers=layers, of=full.n_layers, b=b,
                   params=model.num_params(), prefill_ms=timing["prefill_ms"],
                   decode_ms=decode_ms, peak_gib=peak,
                   seconds=time.time() - t0)
    say(f"  {arch}: prefill {timing['prefill_ms'][0]:.3f} ms (then "
        f"{timing['prefill_ms'][1]:.3f}, {timing['prefill_ms'][2]:.3f}), "
        f"decode {decode_ms:.3f} ms/token, peak {peak:.2f} GiB, "
        f"{summary['seconds']:.1f} s")
    return rows, summary


def phase_archs(device="cuda"):
    """Phase 13: each arch of ZOO in turn (one copy of its weights on the
    card at a time), then the ragged zoo shapes; prints a summary."""
    t0 = time.time()
    rows, summaries = [], []
    for arch, layers, b, why in ZOO:
        r, summary = zoo_arch(arch, layers, b, why, device)
        rows += r
        summaries.append(summary)
    say("== phase 13: ragged shapes of the zoo's attention")
    zoo_ragged(device)
    say(f"== phase 13 summary ({smi('name,power.limit')}):")
    for sm in summaries:
        say(f"  {sm['arch']:22s} {sm['layers']:3d} of {sm['of']:3d} layers "
            f"{sm['params']:>15,} params, B={sm['b']}: prefill "
            f"{sm['prefill_ms'][0]:9.3f} ms, decode {sm['decode_ms']:8.3f} "
            f"ms/token, peak {sm['peak_gib']:6.2f} GiB, "
            f"{sm['seconds']:6.1f} s")
    say(f"  card during phase 13: "
        f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    say(f"  phase 13: {time.time() - t0:.1f} s")
    return rows


# ------------------------------------------ phase 14: continuous batching
BATCH_ARCHS = ("qwen1.5-4b", "recurrentgemma-2b")
BATCH_SLOTS, BATCH_MAX_LEN, BATCH_N = 4, 256, 6
BATCH_PROMPT_LENS, BATCH_BUDGETS = (8, 32), (4, 12)
# the request whose eos_id is the third token of its solo run
BATCH_EOS_UID = 2
# the controls run the first requests only (two overlap in the slots)
BATCH_CONTROL_N = 3
# a request's batched bf16 logits against its B = 1 bf16 decode of the
# same tokens: at most this many times its bf16 budget (the B = 1 bf16
# logits' distance from the B = 1 fp32 ones), ZOO_BF16_FACTOR's reasoning
BATCH_BF16_FACTOR = 2
# phase 5's decode ms/token by config name (printed beside phase 14's)
DECODE_MS = {}
# phase 14 by config name: the first BATCH_CONTROL_N requests' solo
# tokens, ms/tick and tokens/s (15(d)'s sharded batcher is held to them)
BATCH_RECORD = {}
# the kernels the system loop's training must launch
LOOP_KERNELS = ("flash_attention", "flash_attention_bwd", "rglru_scan")


def batch_requests(vocab, n=BATCH_N, seed=0):
    """n (prompt, budget) pairs from ``seed``: prompt lengths and budgets
    uniform in BATCH_PROMPT_LENS and BATCH_BUDGETS, tokens in the vocab."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(BATCH_PROMPT_LENS[0], BATCH_PROMPT_LENS[1] + 1, n)
    budgets = rng.integers(BATCH_BUDGETS[0], BATCH_BUDGETS[1] + 1, n)
    return [(rng.integers(0, vocab, int(k)).astype(np.int32), int(m))
            for k, m in zip(lens, budgets)]


def keep_logits(b):
    """Wrap the batcher ``b``'s step function to keep, for each request,
    the (V,) logits of every step its slot was active in (prompt steps
    included), in order; returns that dict (uid -> list), which fills as
    ``b`` runs."""
    import numpy as np
    kept = {}
    step_fn = b.step_fn

    def step(*args):
        out = step_fn(*args)
        for i in np.flatnonzero(args[-1]):
            kept.setdefault(b.slots[i].uid, []).append(out[1][i].clone())
        return out

    b.step_fn = step
    return kept


def run_batcher(model, params, reqs, eos=None, device="cuda"):
    """``reqs`` through a BATCH_SLOTS-slot ``ContinuousBatcher`` (``eos``
    maps a uid to its eos_id). Returns the batcher and its record: each
    request's per-step logits (``keep_logits``), each slot step's CUDA
    events and active count, each tick's slot holders, the wall seconds
    of ``run_until_drained``."""
    import numpy as np
    import torch
    from repro_torch.serving import ContinuousBatcher, Request
    b = ContinuousBatcher(model, params, n_slots=BATCH_SLOTS,
                          max_len=BATCH_MAX_LEN, device=device)
    for uid, (prompt, budget) in enumerate(reqs):
        b.submit(Request(uid=uid, prompt=prompt, max_new_tokens=budget,
                         eos_id=(eos or {}).get(uid, -1)))
    rec = dict(steps=[], ticks=[], holders=None, logits=keep_logits(b))
    step_fn, tick = b.step_fn, b.step

    def timed_step(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step_fn(*args)
        end.record()
        rec["steps"].append((start, end, int(np.sum(args[-1]))))
        rec["holders"] = tuple(None if r is None else r.uid for r in b.slots)
        return out

    def logged_tick():
        n = tick()
        rec["ticks"].append(rec["holders"])
        return n

    b.step_fn, b.step = timed_step, logged_tick
    t0 = time.time()
    b.run_until_drained()
    torch.cuda.synchronize()
    rec["wall_s"] = time.time() - t0
    return b, rec


def slot_map(ticks):
    """Which request held each slot in each tick, as runs of ticks."""
    runs = []
    for i, holders in enumerate(ticks, 1):
        if runs and runs[-1][2] == holders:
            runs[-1][1] = i
        else:
            runs.append([i, i, holders])
    return "; ".join(
        f"{a}{'' if a == z else f'-{z}'}: "
        + " ".join("--" if u is None else f"r{u}" for u in h)
        for a, z, h in runs)


def expected_run(solo, prompt, eos_id):
    """A request's solo tokens and logits (``solo``: its request and
    logits from its run alone), cut after the first eos_id."""
    req, logits = solo
    toks = req.generated
    if eos_id >= 0 and eos_id in toks:
        toks = toks[:toks.index(eos_id) + 1]
        logits = logits[:len(prompt) + len(toks) - 1]
    return toks, logits


def alone_vs_batched(b, rec, solos, reqs, eos, label):
    """Gate 1: each request's tokens and per-step logits in the batched
    run (``b``, ``rec`` from ``run_batcher``) against its run alone
    through a BATCH_SLOTS-slot batcher (the other slots idle): bit for
    bit, or else within BF16_RTOL of the logits' scale. Returns (passed,
    bit for bit, largest deviation)."""
    import torch
    worst, exact, toks_ok = 0.0, True, True
    for uid, (prompt, _) in enumerate(reqs):
        got, kept = b.completed[uid], rec["logits"][uid]
        toks, logits = expected_run(solos[uid], prompt,
                                    eos.get(uid, -1))
        toks_ok &= got.generated == toks
        n = min(len(kept), len(logits))
        g, w = torch.stack(kept[:n]), torch.stack(logits[:n])
        exact &= len(kept) == len(logits) and torch.equal(g, w)
        worst = max(worst, logit_dev(g, w))
    ok = toks_ok and (exact or worst <= BF16_RTOL)
    say(f"  {label}: tokens {'equal' if toks_ok else 'DIFFER'}, logits "
        f"{'bit for bit' if exact else f'{worst:.3e} of their scale'} "
        f"(limit: bit for bit, else {BF16_RTOL:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    return ok, exact, worst


def b1_logits(model, params, seq, device="cuda"):
    """Teacher-forced B = 1 decode of ``seq`` through
    ``Model.decode_step`` (int positions): the (len(seq), V) fp32
    logits."""
    import torch
    cache = model.init_cache(1, BATCH_MAX_LEN, device=device)
    out = []
    with torch.no_grad():
        for t, tok in enumerate(seq):
            logits, cache = model.decode_step(
                params, {"tokens": torch.tensor([[int(tok)]], device=device)},
                cache, t)
            out.append(logits[0].float())
    return torch.stack(out)


def b1_gate(model, params, b, rec, reqs, device="cuda"):
    """Gate 2: each request's batched logits (``b``, ``rec`` from
    ``run_batcher``) against the B = 1 decode of its prompt and generated
    tokens; returns the deviations (share of the B = 1 logits' scale) and
    the B = 1 logits, by uid."""
    import torch
    devs, b1 = {}, {}
    for uid, (prompt, _) in enumerate(reqs):
        seq = list(prompt) + b.completed[uid].generated[:-1]
        b1[uid] = b1_logits(model, params, seq, device)
        devs[uid] = logit_dev(torch.stack(rec["logits"][uid]), b1[uid])
    return devs, b1


def busy_tick(model, params, vocab, device="cuda"):
    """Profile one tick with every slot decoding (the queue empty)."""
    import numpy as np
    from repro_torch.serving import ContinuousBatcher, Request
    b = ContinuousBatcher(model, params, n_slots=BATCH_SLOTS,
                          max_len=BATCH_MAX_LEN, device=device)
    rng = np.random.default_rng(9)
    for uid in range(BATCH_SLOTS):
        b.submit(Request(uid=uid, prompt=rng.integers(0, vocab, 2).astype(
            np.int32), max_new_tokens=8))
    b.step()                        # admits all four, decodes once
    b.step()                        # warm
    profile_device(f"one tick, {BATCH_SLOTS} slots decoding",
                   lambda: b.step())


def batch_arch(arch, device="cuda"):
    """Phase 14(a) for one arch at published width and depth, bf16, seed-0
    weights at ``condition_``'s scale."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import Model
    from repro_torch.serving import scheduler
    t0 = time.time()
    cfg = get_config(arch)
    say(f"== phase 14: {cfg.name} continuous batching ({cfg.n_layers} layers "
        f"{cfg.block_pattern}, d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.head_dim}, {cfg.dtype}): "
        f"{BATCH_SLOTS} slots, max_len {BATCH_MAX_LEN}, {BATCH_N} requests")
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg)
    params = model.init(seed=0, device=device)
    condition_(params)
    reqs = batch_requests(cfg.vocab_size)
    say(f"  requests (prompt tokens, budget): "
        f"{[(len(p), m) for p, m in reqs]}")
    solos = []
    for r in reqs:
        sb, srec = run_batcher(model, params, [r], device=device)
        solos.append((sb.completed[0], srec["logits"][0]))
    first = solos[BATCH_EOS_UID][0].generated
    eos = {BATCH_EOS_UID: first[2]}
    say(f"  request r{BATCH_EOS_UID}'s eos_id: {eos[BATCH_EOS_UID]}, the "
        f"third token of its solo run {first}")
    build.reset_launches()
    b, rec = run_batcher(model, params, reqs, eos, device)
    launches = dict(build.LAUNCHES)
    say(f"  slot holders by tick: {slot_map(rec['ticks'])}")
    say(f"  kernel launches in the batched run: {launches} (decode runs "
        f"no hand-written kernel, as in the reference)")
    cut = b.completed[BATCH_EOS_UID]
    if len(cut.generated) >= reqs[BATCH_EOS_UID][1] \
            or cut.generated[-1] != eos[BATCH_EOS_UID]:
        raise RuntimeError(f"r{BATCH_EOS_UID} did not end at its eos_id: "
                           f"{cut.generated}")
    if max(u for h in rec["ticks"] for u in h if u is not None) \
            < BATCH_SLOTS:
        raise RuntimeError("no slot was reused")
    ok1, _, _ = alone_vs_batched(b, rec, solos, reqs, eos,
                                 "alone vs batched, each request")

    devs, b1 = b1_gate(model, params, b, rec, reqs, device=device)
    p32 = {k: v.float() for k, v in params.items()}
    m32 = Model(fp32_cfg(cfg))
    budgets = {}
    for uid, (prompt, _) in enumerate(reqs):
        seq = list(prompt) + b.completed[uid].generated[:-1]
        budgets[uid] = logit_dev(b1[uid], b1_logits(m32, p32, seq, device))
    del p32, b1
    torch.cuda.empty_cache()
    ok2 = all(devs[u] <= BATCH_BF16_FACTOR * budgets[u] for u in devs)
    for uid in devs:
        say(f"    r{uid}: batched vs B = 1 bf16 {devs[uid]:.3e} of the "
            f"scale, bf16 budget {budgets[uid]:.3e} (B = 1 bf16 vs fp32), "
            f"{devs[uid] / budgets[uid]:.3f}x")
    say(f"  B = 1 oracle: batched within {BATCH_BF16_FACTOR}x each "
        f"request's bf16 budget {'ok' if ok2 else 'FAIL'}")

    ctl = reqs[:BATCH_CONTROL_N]
    if arch == "recurrentgemma-2b":
        orig = scheduler.snapshot_idle
        scheduler.snapshot_idle = lambda *a: []
        try:
            cb, crec = run_batcher(model, params, ctl, device=device)
        finally:
            scheduler.snapshot_idle = orig
        c_ok, _, c_dev = alone_vs_batched(
            cb, crec, solos, ctl, {}, "control, idle slots not frozen")
        control_failed = not c_ok
    else:
        shared = Model.decode_step
        model.decode_step = lambda p, bt, c, cur: shared(
            model, p, bt, c, int(cur.max()))
        try:
            cb, crec = run_batcher(model, params, ctl, device=device)
        finally:
            del model.decode_step
        c_devs, _ = b1_gate(model, params, cb, crec, ctl, device=device)
        limit = BATCH_BF16_FACTOR * max(budgets.values())
        control_failed = max(c_devs.values()) > limit
        say(f"  control, every slot at one shared position (max(cur)): "
            f"batched vs B = 1 bf16 up to {max(c_devs.values()):.3e} of the "
            f"scale (limit {limit:.3e}, the largest budget x "
            f"{BATCH_BF16_FACTOR}) {'FAIL (as it must)' if control_failed else 'passes'}")
    if not control_failed:
        raise RuntimeError("the control passed the gate it must fail")
    if not (ok1 and ok2):
        raise RuntimeError("the batcher disagrees with its solo runs or "
                           "with the B = 1 decode")

    per = {}
    for start, end, n in rec["steps"]:
        per.setdefault(n, []).append(start.elapsed_time(end))
    n_gen = sum(len(r.generated) for r in b.completed.values())
    ticks = len(rec["ticks"])
    steps_ms = sum(sum(v) for v in per.values())
    say(f"  {ticks} ticks, {b.steps_run} slot steps in "
        f"{rec['wall_s'] * 1e3:.1f} ms: {rec['wall_s'] * 1e3 / ticks:.3f} "
        f"ms/tick, {steps_ms / b.steps_run:.3f} ms a slot step (CUDA events),"
        f" {n_gen} tokens generated, {n_gen / rec['wall_s']:.2f} tokens/s")
    for n in sorted(per):
        say(f"    steps with {n} of {BATCH_SLOTS} slots active: {len(per[n])}"
            f", {sum(per[n]) / len(per[n]):.3f} ms each")
    full = per.get(BATCH_SLOTS)
    say(f"  B = {BATCH_SLOTS} decode: "
        f"{'n/a' if not full else f'{sum(full) / len(full):.3f}'} ms a step;"
        f" phase 5's decode (B = 4, after a 4096-token prefill): "
        + (f"{DECODE_MS[cfg.name]:.3f} ms/token" if cfg.name in DECODE_MS
           else "not run"))
    BATCH_RECORD[cfg.name] = dict(
        tokens={u: solos[u][0].generated for u in range(BATCH_CONTROL_N)},
        ms_tick=rec["wall_s"] * 1e3 / ticks,
        tokens_s=n_gen / rec["wall_s"])
    busy_tick(model, params, cfg.vocab_size, device)
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"  peak {peak:.2f} GiB; {cfg.name}: {time.time() - t0:.1f} s")
    del params, b, solos
    torch.cuda.empty_cache()


def system_loop(device="cuda"):
    """Phase 14(b): launch/train.py at --scale smoke on the card with
    --ckpt A, then --restore A --ckpt B; both checkpoints read back bit
    for bit, the training's kernel launches counted, and the batcher on
    the restored B against the batcher on the params the trainer held."""
    import numpy as np
    import torch
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.models import Model
    from repro_torch.serving import ContinuousBatcher, Request
    say("== phase 14: system loop, recurrentgemma-2b --scale smoke: train "
        "--ckpt, --restore, serve")
    d = ROOT / "build" / "phase14"
    d.mkdir(parents=True, exist_ok=True)
    paths = [str(d / "a.npz"), str(d / "b.npz")]
    common = ["--arch", "recurrentgemma-2b", "--scale", "smoke",
              "--log-every", "2", "--device", device]
    saved = []
    save = ckpt.save

    def saving(path, params, **kw):
        saved.append({k: v.clone() for k, v in params.items()})
        return save(path, params, **kw)

    runs = (["--steps", "4", "--ckpt", paths[0]],
            ["--steps", "6", "--restore", paths[0], "--ckpt", paths[1]])
    ckpt.save = saving
    try:
        for argv in runs:
            build.reset_launches()
            loss = train.main(common + argv)
            torch.cuda.synchronize()
            launches = dict(build.LAUNCHES)
            shown = " ".join(Path(a).name for a in argv)
            say(f"  train {shown}: loss {loss:.4f}, launches {launches}")
            for name in LOOP_KERNELS:
                if not launches.get(name):
                    raise RuntimeError(f"the training launched no {name}")
    finally:
        ckpt.save = save
    for path, held in zip(paths, saved):
        back, meta = ckpt.restore(path, device=device)
        same = sorted(back) == sorted(held) and all(
            back[k].dtype == held[k].dtype and torch.equal(back[k], held[k])
            for k in held)
        say(f"  {Path(path).name} (step {meta['step']}): restored "
            f"{'bit for bit' if same else 'DIFFERS'}")
        if not same:
            raise RuntimeError(f"{path} does not restore what was saved")
    cfg = get_config("recurrentgemma-2b").reduced()
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
            for n, m in ((5, 6), (9, 4), (3, 8))]
    served = []
    for params in (ckpt.restore(paths[1], device=device)[0], saved[1]):
        b = ContinuousBatcher(Model(cfg), params, n_slots=2, max_len=32,
                              device=device)
        kept = keep_logits(b)
        for uid, (p, m) in enumerate(reqs):
            b.submit(Request(uid=uid, prompt=p, max_new_tokens=m))
        b.run_until_drained()
        served.append({u: (r.generated, torch.stack(kept[u]))
                       for u, r in b.completed.items()})
    same = served[0].keys() == served[1].keys() and all(
        served[0][u][0] == served[1][u][0]
        and torch.equal(served[0][u][1], served[1][u][1]) for u in served[1])
    say(f"  the batcher on the restored B vs on the params in memory: "
        f"{'same tokens and logits, bit for bit' if same else 'DIFFER'} "
        f"({[served[1][u][0] for u in sorted(served[1])]})")
    if not same:
        raise RuntimeError("serving the restored params differs")


def phase_batching(device="cuda"):
    """Phase 14: continuous batching at published width, then the system
    loop."""
    t0 = time.time()
    for arch in BATCH_ARCHS:
        batch_arch(arch, device)
    system_loop(device)
    say(f"  card during phase 14: "
        f"{smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")
    say(f"  phase 14: {time.time() - t0:.1f} s")


# ------------------------------------------------------------ phase 15
MESH_REPS = 20
# I_l = 1 twice: the first round of a fresh model run alone is cold (on
# an H100 80GB HBM3, 10.0-10.4 s against ~1.5 s at I_l = 4 after it)
MESH_INTERVALS = (1, 4, 1)
ROOF_ARCH = "recurrentgemma-2b"


def mesh_round(device="cuda"):
    """15a: phase 3's round (the paper's (2,3,2), N=100, N_p=10, I_l=2,
    impl="pallas") with fanout="shard_map" on the NCCL host mesh (world
    1, a 'pod' axis), flat and two_level (2 pods), against the batched
    round from the same params and generator: the same bits, the test
    fidelity and mse of the result through the kernels, every kernel
    launched (counts zeroed before the mesh round and its evaluation,
    read after), and ms/round of both (CUDA events, in turns)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.quantum import federated as fed
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.sharding import collectives
    cfg, ds, test, params = main_cell(device=device)
    mesh = mesh_lib.make_host_mesh((1,), ("pod",), device=device)
    card = smi("name,power.limit")
    say(f"== phase 15a: the {cfg.widths} N={cfg.num_nodes}, "
        f"N_p={cfg.nodes_per_round}, I_l={cfg.interval_length} round, "
        f"impl={cfg.impl!r}, fanout='shard_map' on {mesh} (backend "
        f"{dist.get_backend()}, world {dist.get_world_size()})")
    try:
        for topology, pods in (("flat", None), ("two_level", 2)):
            c = cfg._replace(topology=topology, pods=pods)
            batched, shard = c._replace(fanout="vmap"), c._replace(
                fanout="shard_map")
            want = fed.server_round(params, ds,
                                    torch.Generator().manual_seed(5), batched)
            build.reset_launches()
            with mesh:
                got = fed.server_round(params, ds,
                                       torch.Generator().manual_seed(5), shard)
                ev = fed.evaluate(got, *test, c.widths, impl=c.impl)
            torch.cuda.synchronize()
            launches = {k: n for k, n in build.LAUNCHES.items() if n}
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise RuntimeError(f"{topology}: the shard_map round differs "
                                   "from the batched round")
            missing = [k for k in KERNELS if not launches.get(k)]
            if missing:
                raise RuntimeError(f"{topology}: the mesh round never "
                                   f"launched {missing}")
            ms = {"vmap": [], "shard_map": []}
            for side in ("vmap", "shard_map", "shard_map", "vmap"):
                ctx = mesh if side == "shard_map" else contextlib.nullcontext()
                with ctx:
                    ms[side].append(round_ms(c._replace(fanout=side), ds,
                                             params, MESH_REPS))
            say(f"  {topology}: shard_map == vmap bit for bit; test fidelity "
                f"{float(ev['fidelity']):.6f}, mse {float(ev['mse']):.6e}; "
                f"launches {launches}; ms/round vmap "
                f"{sum(ms['vmap']) / 2:.4f}, shard_map "
                f"{sum(ms['shard_map']) / 2:.4f} (CUDA events, {MESH_REPS} "
                f"rounds a run, two runs each in turns; card {card})")
        x = torch.zeros((cfg.nodes_per_round, cfg.interval_length, 3, 8, 8),
                        dtype=torch.complex128, device=device)
        ms = {}
        for label, call in (
                ("the mesh's group lookup", lambda: mesh.get_group("pod")),
                ("dist.all_gather", lambda: dist.all_gather(
                    [torch.empty_like(x)], x, group=mesh.get_group("pod"))),
                ("collectives.all_gather", lambda: collectives.all_gather(
                    x, mesh, "pod"))):
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MESH_REPS):
                call()
            torch.cuda.synchronize()
            ms[label] = (time.perf_counter() - t0) * 1e3 / MESH_REPS
        say(f"  one call on the mesh, host clock to a synchronize, of the "
            f"round's {tuple(x.shape)} layer-1 uploads: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in ms.items()) + f"; card {card}")
    finally:
        mesh_lib.close()


def mesh_dryrun_fed(device="cuda"):
    """15b: ``launch.dryrun_fed`` on the 2-pod fake mesh at phase 12a's
    shape (Qwen1.5-4B at published width, 8 of 40 layers, B=2 x S=4096 a
    local step), I_l = 1, 4 and 1 again (the first round is cold): pod
    0's node trains for real through the attention kernels (launches
    gated: I_l x one step's), cross-pod bytes a round equal for all,
    a quarter a local step at I_l = 4; a local step's in-pod bytes traced
    once (``dryrun_fed.trace_local_step``, fake tensors on the card) and
    counted I_l times a round."""
    import dataclasses
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun_fed
    cfg = dataclasses.replace(get_config(FED_ARCH), n_layers=FED_LAYERS)
    per_step = train_launches(cfg)
    card = smi("name,power.limit")
    say(f"== phase 15b: dryrun_fed, {FED_ARCH} {FED_LAYERS} of "
        f"{get_config(FED_ARCH).n_layers} layers, B=2 x S={SERVE_S} a local "
        f"step, on the (pod 2, data 16, model 16) fake mesh")
    recs = []
    for il in MESH_INTERVALS:
        torch.cuda.empty_cache()
        build.reset_launches()
        t0 = time.time()
        rec = dryrun_fed.run(FED_ARCH, il, layers=FED_LAYERS, batch=2,
                             seq=SERVE_S, device=device)
        if not recs:
            in_pod = rec["in_pod_step"]
            say(f"  a local step's in-pod collectives (traced once on pod "
                f"0's (data, model) sub-mesh, with the first round in "
                f"{time.time() - t0:.1f} s): "
                f"{rec['in_pod_bytes_per_local_step']:.0f} B, by axis "
                f"{in_pod['bytes_by_axis']}, {in_pod['count_by_op']}")
        launches = {k: n for k, n in build.LAUNCHES.items() if n}
        want = {k: per_step[k] * il for k in ("flash_attention", ATTN_BWD)}
        if launches != want:
            raise RuntimeError(f"I_l={il}: launched {launches}, expected "
                               f"{want}")
        if not math.isfinite(rec["loss"]):
            raise RuntimeError(f"I_l={il}: non-finite loss {rec['loss']}")
        say(f"  I_l={il}: cross-pod {rec['cross_pod_bytes']:.0f} B a round, "
            f"{rec['cross_pod_bytes_per_local_step']:.0f} B a local step, "
            f"in-pod {rec['in_pod_bytes_per_local_step']:.0f} B a local "
            f"step, total {rec['collective_bytes_total']:.0f} B, by "
            f"axis {rec['collective_bytes_by_axis']}, collectives "
            f"{rec['collective_count']}; round {rec['round_ms']:.1f} ms "
            f"(host clock to a synchronize), loss {rec['loss']:.6f}, "
            f"launches {launches}; card {card}")
        recs.append(rec)
    cold, four, one = recs
    if not (cold["cross_pod_bytes"] == one["cross_pod_bytes"]
            == four["cross_pod_bytes"] > 0
            and 4 * four["cross_pod_bytes_per_local_step"]
            == one["cross_pod_bytes_per_local_step"]):
        raise RuntimeError("cross-pod bytes a local step did not fall to "
                           "1/4 from I_l = 1 to 4")
    say(f"  cross-pod bytes a round equal at I_l = 1, 4, 1; a local step "
        f"{one['cross_pod_bytes_per_local_step']:.0f} -> "
        f"{four['cross_pod_bytes_per_local_step']:.0f} B (1/4); "
        f"{one['values']}")
    torch.cuda.empty_cache()


def tensor_bytes(tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def roofline_prefill(device="cuda"):
    """15c: the roofline of phase 5's RecurrentGemma-2B prefill (B=4,
    S=4096, bf16, random weights from seed 0) through
    ``roofline.trace_parse`` and ``roofline.analysis``: device time by
    family and the busy share of one profiled prefill (launches zeroed
    before, read after: 8 flash_attention, 18 rglru_scan), the ATen dot
    FLOPs and the kernels' FLOPs and bytes of another, the compute and
    memory terms and their shares of the prefill's time (CUDA events)."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import concrete_batch
    from repro_torch.kernels import build
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import Model
    from repro_torch.roofline import analysis, breakdown, trace_parse
    torch.cuda.empty_cache()
    cfg = get_config(ROOF_ARCH)
    model = Model(cfg)
    params = model.init(seed=0, device=device)
    batch = concrete_batch(cfg, SERVE_B, SERVE_S,
                           torch.Generator().manual_seed(0), kind="prefill",
                           device=device)
    step = make_prefill_step(model)
    card = smi("name,power.limit")
    say(f"== phase 15c: roofline of the {ROOF_ARCH} prefill, B={SERVE_B} x "
        f"S={SERVE_S}, {cfg.param_dtype}, {cfg.n_layers} layers")
    with torch.no_grad():
        logits, cache = step(params, batch)
        out_bytes = tensor_bytes([logits, *cache.values()])
        del logits, cache
        ms = cuda_ms(step, params, batch, reps=5, warmup=1)
        work = trace_parse.count(lambda: step(params, batch))
        build.reset_launches()
        trace = trace_parse.profile(lambda: step(params, batch))
        launches = {k: n for k, n in build.LAUNCHES.items() if n}
    want = {"flash_attention": 8, "rglru_scan": 18}
    if launches != want or {k: v[0] for k, v in work.kernels.items()} != want:
        raise RuntimeError(f"the profiled prefill launched {launches}, the "
                           f"counted one {work.kernels}; expected {want}")
    arg_bytes = tensor_bytes(params.values()) + tensor_bytes(batch.values())
    t = analysis.trace_terms(work, trace, arg_bytes, out_bytes, ms)
    for line in breakdown.lines(trace, "one prefill") + \
            breakdown.family_lines(trace):
        say("  " + line)
    fam = t["device_ms_by_family"]
    if not all(fam.get(k, 0) > 0 for k in want) or not all(
            math.isfinite(t[k]) and t[k] > 0 for k in
            ("t_compute_ms", "t_memory_ms", "compute_share")):
        raise RuntimeError(f"roofline incomplete: {t}")
    say(f"  prefill {ms:.3f} ms (CUDA events, 5 runs), device busy "
        f"{100 * t['busy_share']:.1f}% of the profiled call; card {card}")
    say(f"  work: ATen dot FLOPs {t['dot_flops']:.6e} (FlopCounterMode), "
        f"kernels {t['kernel_flops']:.6e} FLOPs and {t['kernel_bytes']:.6e} "
        f"B from their shapes {t['kernels']}; arguments {arg_bytes:.6e} B, "
        f"outputs {out_bytes:.6e} B; card {card}")
    say(f"  terms: compute {t['t_compute_ms']:.4f} ms "
        f"({100 * t['compute_share']:.1f}% of the measured time), memory "
        f"{t['t_memory_ms']:.4f} ms ({100 * t['memory_share']:.1f}%), "
        f"bound by {t['bound_by']} (H100 SXM peaks: 989 TFLOP/s bf16, "
        f"3.35 TB/s); card {card}")
    say("  roofline " + json.dumps(dict(t, card=card, arch=ROOF_ARCH,
                                        batch=SERVE_B, seq=SERVE_S)))
    del params, batch
    torch.cuda.empty_cache()


# 15(d): (arch, depth (0: published), lr) of the sharded-vs-plain steps
SHARD_STEPS = (("recurrentgemma-2b", 0, TRAIN_LR),
               (RWKV_ARCH, RWKV_LAYERS, RWKV_LR))
# (label, q (B, S, H, dh), kv (B, S, K, dh), mask) of the query-offset
# check: phase 5's prefill attention and 12a's MHA dh 128
Q_OFFSET_CASES = (
    ("phase 5's prefill", (4, 4096, 10, 256), (4, 4096, 1, 256),
     dict(causal=True, window=2048)),
    ("12a's MHA dh 128", (2, 4096, 20, 128), (2, 4096, 20, 128),
     dict(causal=True, window=0)))
PEAK_RTOL = 0.10
PROD_PAIR = ("recurrentgemma-2b", "train_4k", "multi")


def local(x):
    """A DTensor's local shard (a plain tensor as it is)."""
    from repro_torch.sharding.dtensor import is_dtensor
    return x.to_local() if is_dtensor(x) else x


def sharded_vs_plain(arch, layers, lr, mesh, device="cuda"):
    """One train step (``launch.train.optimizer``'s AdamW, clip 1) of the
    arch at published width (``layers`` cuts the depth) on phase 11's
    batch, with plain tensors and then with DTensors on ``mesh`` (params,
    moments and batch placed by the rules, ``launch.steps.shard_tree``),
    each from a fresh init of the same seed: the loss and every param
    after the step the same bits, the launches exact (zeroed before, read
    after), a second step's ms (CUDA events) and a third's busy share
    (profiler) of each. Returns the sharded step's arguments' bytes and
    its peak above what was held before them."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import BATCH_AXES
    from repro_torch.data import token_batches
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step, shard_tree
    from repro_torch.models import Model
    from repro_torch.roofline import trace_parse
    from repro_torch.roofline.step_trace import storage_bytes
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = Model(cfg)
    opt = train.optimizer(cfg)
    step = make_train_step(model, opt)
    want = train_launches(cfg)
    want.pop(SCAN_REV, None)
    batch = next(token_batches(cfg, TRAIN_B, TRAIN_S, seed=0, device=device))
    card = smi("name,power.limit")
    out = {}
    for side in ("plain", "sharded"):
        torch.cuda.empty_cache()
        params = model.init(seed=0, device=device)
        if arch == RWKV_ARCH:
            redraw_rwkv(params, seed=1)
        b = batch
        if side == "sharded":
            params = shard_tree(params, model.param_axes(), mesh)
            b = shard_tree(batch, BATCH_AXES, mesh)
        state = opt.init(params)
        args_bytes = storage_bytes((params, state, b))
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        params, state, metrics = step(params, state, b, lr)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held + args_bytes
        launches = {k: n for k, n in build.LAUNCHES.items() if n}
        if launches != want:
            raise RuntimeError(f"{arch} {side} step launched {launches}, "
                               f"expected {want}")
        loss = float(local(metrics["loss"]))
        after = {k: local(v).cpu() for k, v in params.items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(params, state, b, lr)
        end.record()
        torch.cuda.synchronize()
        trace = trace_parse.profile(lambda: step(params, state, b, lr))
        out[side] = dict(loss=loss, params=after, ms=start.elapsed_time(end),
                         busy=trace.busy_share, peak=peak, args=args_bytes)
        say(f"  {arch} ({cfg.n_layers} layers) {side} step: loss {loss:.6f},"
            f" launches {launches}; step 2 {out[side]['ms']:.1f} ms (CUDA "
            f"events), step 3 busy {100 * trace.busy_share:.1f}% "
            f"(profiler); peak {peak / 2**30:.2f} GiB with its arguments "
            f"({args_bytes / 2**30:.2f} GiB); card {card}")
        del params, state, metrics, b
    plain, shard = out["plain"], out["sharded"]
    same = plain["loss"] == shard["loss"] and all(
        torch.equal(plain["params"][k], shard["params"][k])
        for k in plain["params"])
    if not same:
        raise RuntimeError(f"{arch}: the sharded step differs from the "
                           "plain step")
    say(f"  {arch}: the sharded step (DTensors on {mesh}) is the plain "
        f"step bit for bit: loss and all {len(plain['params'])} params "
        f"after AdamW; ms/step {shard['ms']:.1f} sharded vs "
        f"{plain['ms']:.1f} plain ({shard['ms'] / plain['ms']:.2f}x: "
        "DTensor's dispatch on the host), busy "
        f"{100 * shard['busy']:.1f}% vs {100 * plain['busy']:.1f}%")
    torch.cuda.empty_cache()
    return cfg, shard


def trace_peak_check(cfg, real, mesh, device="cuda"):
    """The ``FakeTensorMode`` trace of the same world-1 sharded train
    step (``roofline.step_trace``, fake tensors on the card): its peak
    within PEAK_RTOL of the real step's (``max_memory_allocated`` above
    what was held, plus the arguments)."""
    from repro_torch.launch.steps import sharded_artifacts
    from repro_torch.models.config import InputShape
    from repro_torch.roofline.step_trace import trace_step
    t0 = time.time()
    shape = InputShape("train", TRAIN_S, TRAIN_B, "train")
    tr = trace_step(lambda: sharded_artifacts(cfg, shape, mesh,
                                              device=device), mesh)
    secs = time.time() - t0
    ratio = tr.peak_bytes / real["peak"]
    say(f"  trace of the {cfg.name} world-1 step ({secs:.1f} s): peak "
        f"{tr.peak_bytes / 2**30:.3f} GiB (arguments "
        f"{tr.argument_bytes / 2**30:.3f}, temporaries "
        f"{tr.temp_bytes / 2**30:.3f}), the real step's "
        f"max_memory_allocated {real['peak'] / 2**30:.3f} GiB (arguments "
        f"{real['args'] / 2**30:.3f}): {ratio:.4f}x; dot FLOPs "
        f"{tr.dot_flops:.6e}; collectives {dict(tr.tally.count_by_op)}")
    if abs(ratio - 1.0) > PEAK_RTOL:
        raise RuntimeError(f"the traced peak is {ratio:.4f}x the card's")


def q_offset_case(label, q_shape, kv_shape, mask, dtype="bfloat16",
                  device="cuda"):
    """The attention kernels of ``dtype`` (bf16: wgmma; fp32: 3xTF32
    ``mma.sync``) on query rows [S/2, S) at q_offset S/2 against the full
    call (from 0) on seeded inputs: the forward, its LSE and dq the full
    call's rows bit for bit; dk, dv (and dq) within the backward's budget
    of the plain version with the same offset (``attn_bwd_case``: bf16's
    budget, or BWD_RTOL in fp32); a planted offset of 0 must fail the
    forward gate. Returns the offset forward's and the offset backward's
    rows, each with its own launch count (one call each)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as kfa
    dt = getattr(torch, dtype)
    fp32 = dt == torch.float32
    g = torch.Generator(device=device).manual_seed(15)
    q, k, v = (torch.randn(s, generator=g, device=device).to(dt)
               for s in (q_shape, kv_shape, kv_shape))

    def heads_major(x):
        bx, sx, hx, dx = x.shape
        return ops._dense(x.transpose(1, 2).reshape(bx * hx, sx, dx))
    qf, kf, vf = (heads_major(x) for x in (q, k, v))
    s = q.shape[1]
    off = s // 2
    qo = qf[:, off:].contiguous()
    kw = dict(mask)
    full, lse = kfa.flash_attention(qf, kf, vf, return_lse=True, **kw)
    build.reset_launches()
    got, lse_o = kfa.flash_attention(qo, kf, vf, return_lse=True,
                                     q_offset=off, **kw)
    fwd_launches = build.LAUNCHES["flash_attention"]
    dout = torch.randn(full.shape, generator=g, device=device).to(dt)
    dq, dk, dv = kfa.flash_attention_bwd(qf, kf, vf, full, dout, lse=lse, **kw)
    do_o = dout[:, off:].contiguous()
    build.reset_launches()
    dq_o, _, _ = kfa.flash_attention_bwd(qo, kf, vf, got, do_o, lse=lse_o,
                                         q_offset=off, **kw)
    bwd_launches = build.LAUNCHES[ATTN_BWD]
    torch.cuda.synchronize()
    rows_ok = (torch.equal(got, full[:, off:]) and torch.equal(
        lse_o, lse[:, off:]) and torch.equal(dq_o, dq[:, off:]))
    planted = kfa.flash_attention(qo, kf, vf, **kw)
    planted_fails = not torch.equal(planted, full[:, off:])
    say(f"  q_offset {off}, {label}, {dtype} (q {tuple(qo.shape)} of "
        f"{tuple(qf.shape)}, kv {tuple(kf.shape)}, {mask}): forward, LSE "
        f"and dq the full call's rows bit for bit {rows_ok}; a planted "
        f"offset of 0 fails that gate {planted_fails}")
    if not (rows_ok and planted_fails):
        raise RuntimeError(f"q_offset {label} {dtype}: the offset rows "
                           "differ from the full call's, or the planted "
                           "offset passes")
    bwd_kw = dict(kw, lse=lse_o, q_offset=off)
    bwd_err = attn_bwd_case((qo, kf, vf, got, do_o), bwd_kw,
                            f"q_offset {off} at {label}, {dtype}")
    bwd = attn_bwd_timing(qo, kf, vf, got, do_o, bwd_kw)
    plain = ref.attention_ref(qo, kf, vf, q_offset=off, **kw)
    err = float((got.float() - plain.float()).abs().max())
    if fp32 and err > KERNEL_RTOL * max(1.0, float(plain.abs().max())):
        raise RuntimeError(f"q_offset {label} fp32: the kernel is {err:.3e} "
                           "off the plain version")
    k_ms = cuda_ms(lambda: kfa.flash_attention(qo, kf, vf, q_offset=off,
                                               **kw), reps=10, warmup=2)
    full_ms = cuda_ms(lambda: kfa.flash_attention(qf, kf, vf, **kw),
                      reps=10, warmup=2)
    p_ms = cuda_ms(lambda: ref.attention_ref(qo, kf, vf, q_offset=off, **kw),
                   reps=3, warmup=1)
    amask = ref.attention_mask(s - off, s, kw["causal"], kw["window"],
                               q.device, off)
    qs = q[:, off:]
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qs.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=amask, enable_gqa=True)
    lib_ms = cuda_ms(lib, reps=10, warmup=2)
    args = (qs, k, v)
    b_ms, b_by = seq_bound_ms("flash_attention", args,
                              dict(kw, q_offset=off))
    full_b_ms = seq_bound_ms("flash_attention", (q, k, v), kw)[0]
    say(f"  q_offset {off}, {label}, {dtype}: kernel {k_ms:.4f} ms (the "
        f"full call {full_ms:.4f} ms), plain {p_ms:.4f} ms, "
        f"{'fp32 ' if fp32 else ''}SDPA on the same rows {lib_ms:.4f} ms, "
        f"bound {b_ms:.6f} ms ({b_by}{', 3xTF32' if fp32 else ''}), "
        f"kernel/bound {k_ms / b_ms:.2f}x (the full call "
        f"{full_ms / full_b_ms:.2f}x of its own); "
        f"max_abs_err {err:.3e} off the plain version; card "
        f"{smi('name,power.limit')}")
    bwd_shape = [list(qo.shape), list(kf.shape)]
    del q, k, v, qf, kf, vf, full, got, dq, dk, dv, dq_o, plain
    torch.cuda.empty_cache()
    cell = (f"q_offset {off}: query rows [{off}, {s}) of {label}, {dtype} "
            f"(launches: this check's one offset call; the world-1 path has "
            f"no context parallelism)")
    fwd_src = ("src/repro_torch/kernels/csrc/flash_attention.cu" if fp32
               else SEQ_KERNELS["flash_attention"]["source"])
    bwd_src = ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu" if fp32
               else ATTN_BWD_SOURCE)
    replaces = SEQ_KERNELS["flash_attention"]["replaces"]
    return [dict(name=FA32 if fp32 else "flash_attention", route="cuda",
                 source=fwd_src, replaces=replaces,
                 shape=[list(qs.shape), list(kv_shape), list(kv_shape)],
                 max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                 bound_by=b_by, library_ms=lib_ms, launches=fwd_launches,
                 cell=f"{cell}, full call {full_ms:.4f} ms"),
            dict(name=ATTN_BWD32 if fp32 else ATTN_BWD, route="cuda",
                 source=bwd_src, replaces=replaces, shape=bwd_shape,
                 max_abs_err=bwd_err, launches=bwd_launches, cell=cell,
                 **bwd)]


PROD_OUT = ROOT / "build" / "dryrun_15d"
DECODE_PAIR = ("recurrentgemma-2b", "decode_32k", "multi")
# DECODE_PAIR's trace on a CPU host (torch 2.13.0+cpu): collective bytes
# a device by axis (PERF.md's hand count) and the dot FLOPs
CPU_DECODE = {"model": 9_247_744, "pod": 73_614_336, "data": 53_256_704,
              "dot_flops": 2_118_123_520.0}
SHARD_DECODE_GEN = 32
# PROD_PAIR's trace: the dot FLOPs and 'model' collective bytes a device
# counted by hand from the layout (PERF.md: the products of the
# weights the rules shard by rows contracted on each rank's rows, the
# query rows projected on each rank under context parallelism), and the
# same trace on a CPU host (torch 2.13.0+cpu)
TRAIN_HAND = {"dot_flops": 5.128e13, "model": 92_691_628_688}
CPU_TRAIN = {"dot_flops": 51_281_909_514_240.0, "model": 98_350_252_688}


def sharded_decode(mesh, device="cuda"):
    """Phase 5's prefill (B = SERVE_B, S = SERVE_S, through the kernels)
    and SHARD_DECODE_GEN greedy tokens of RecurrentGemma-2B at published
    width and depth, seed 0, with plain tensors and then with the params,
    the batch and the cache as DTensors on ``mesh`` (placed by the rules;
    the decode weight-stationary under ``Model.decode_step``'s rule
    overrides): each prefill's launches exact (zeroed before, read
    after); every token, every step's logits and every cache entry after
    the last step the same bits; ms/token over the decode (CUDA events,
    after a warm-up step on a copy of the cache) and one step's busy
    share (profiler) of each."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import BATCH_AXES, concrete_batch
    from repro_torch.kernels import build
    from repro_torch.launch.steps import (make_prefill_step,
                                          make_serve_step, shard_tree)
    from repro_torch.models import Model
    from repro_torch.roofline import trace_parse
    cfg = get_config("recurrentgemma-2b")
    model = Model(cfg)
    b, s, n = SERVE_B, SERVE_S, SHARD_DECODE_GEN
    want = {"flash_attention": 8, "rglru_scan": 18}
    params = model.init(seed=0, device=device)
    batch = concrete_batch(cfg, b, s, torch.Generator().manual_seed(1),
                           kind="prefill", device=device)
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    card = smi("name,power.limit")
    out = {}
    for side in ("plain", "sharded"):
        p, bt = params, batch
        if side == "sharded":
            p = shard_tree(params, model.param_axes(), mesh)
            bt = shard_tree(batch, BATCH_AXES, mesh)
        torch.cuda.synchronize()
        build.reset_launches()
        logits, cache = prefill(p, bt)
        torch.cuda.synchronize()
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        if launches != want:
            raise RuntimeError(f"the {side} prefill launched {launches}, "
                               f"expected {want}")
        cache = model.extend_cache({k: local(v) for k, v in cache.items()},
                                   s + n)
        tok = torch.argmax(local(logits), dim=-1).to(torch.int32)

        def placed(c):
            return (shard_tree(c, model.cache_axes(), mesh)
                    if side == "sharded" else c)
        warm = placed({k: v.clone() for k, v in cache.items()})
        serve(p, warm, step_input(cfg, tok), s)
        cache = placed(cache)
        toks, steps = [], []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            tok, step_logits, cache = serve(p, cache, step_input(cfg, tok),
                                            s + i)
            toks.append(local(tok))
            steps.append(local(step_logits))
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / n
        trace = trace_parse.profile(lambda: serve(p, warm, step_input(
            cfg, local(toks[0])), s + 1))
        out[side] = dict(tokens=torch.stack(toks, 1).cpu(),
                         logits=torch.stack(steps).cpu(),
                         cache={k: local(v).cpu() for k, v in cache.items()},
                         ms=ms, busy=trace.busy_share)
        say(f"  {cfg.name} decode, {side}: prefill launches {launches}; "
            f"{n} tokens at {ms:.3f} ms/token (CUDA events), a step "
            f"{100 * trace.busy_share:.1f}% busy (profiler); sample "
            f"{out[side]['tokens'][0, :8].tolist()}; card {card}")
        del p, bt, cache, warm, logits, step_logits
        torch.cuda.empty_cache()
    plain, shard = out["plain"], out["sharded"]
    same = (torch.equal(plain["tokens"], shard["tokens"])
            and torch.equal(plain["logits"], shard["logits"])
            and sorted(plain["cache"]) == sorted(shard["cache"])
            and all(torch.equal(plain["cache"][k], shard["cache"][k])
                    for k in plain["cache"]))
    say(f"  {cfg.name}: the sharded decode (DTensors on {mesh}) is the "
        f"plain decode bit for bit {same}: {n} tokens, their logits and "
        f"all {len(plain['cache'])} cache entries; ms/token "
        f"{shard['ms']:.3f} sharded vs {plain['ms']:.3f} plain "
        f"({shard['ms'] / plain['ms']:.2f}x: DTensor's dispatch on the "
        f"host), busy {100 * shard['busy']:.1f}% vs "
        f"{100 * plain['busy']:.1f}%")
    if not same:
        raise RuntimeError("the sharded decode differs from the plain one")
    del params, batch
    torch.cuda.empty_cache()


def sharded_batcher(mesh, device="cuda"):
    """Phase 14's RecurrentGemma-2B batcher (BATCH_SLOTS slots, max_len
    BATCH_MAX_LEN, seed-0 weights at ``condition_``'s scale) on its first
    BATCH_CONTROL_N requests, with plain params and then with the params
    as DTensors on ``mesh`` (its cache sharded by the rules, the greedy
    token a sharded argmax): each request's tokens those of its phase-14
    solo run (of the plain run here when phase 14 has not run), ms/tick
    and tokens/s of both beside phase 14's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import shard_tree
    from repro_torch.models import Model
    cfg = get_config("recurrentgemma-2b")
    model = Model(cfg)
    params = model.init(seed=0, device=device)
    condition_(params)
    reqs = batch_requests(cfg.vocab_size)[:BATCH_CONTROL_N]
    got = {}
    for side in ("plain", "sharded"):
        p = (shard_tree(params, model.param_axes(), mesh)
             if side == "sharded" else params)
        b, rec = run_batcher(model, p, reqs, device=device)
        ticks = len(rec["ticks"])
        n_gen = sum(len(r.generated) for r in b.completed.values())
        got[side] = {u: r.generated for u, r in b.completed.items()}
        say(f"  {cfg.name} batcher, {side} params: {ticks} ticks, "
            f"{b.steps_run} slot steps, {rec['wall_s'] * 1e3 / ticks:.3f} "
            f"ms/tick, {n_gen / rec['wall_s']:.2f} tokens/s")
        del p, b, rec
    del params
    torch.cuda.empty_cache()
    phase14 = BATCH_RECORD.get(cfg.name)
    want = phase14["tokens"] if phase14 else got["plain"]
    same = got["sharded"] == want and got["plain"] == want
    say(f"  the sharded batcher's tokens are "
        f"{'phase 14' if phase14 else 'the plain run'}'s {same}: "
        f"{[got['sharded'][u] for u in sorted(got['sharded'])]}"
        + (f"; phase 14: {phase14['ms_tick']:.3f} ms/tick, "
           f"{phase14['tokens_s']:.2f} tokens/s (6 requests)"
           if phase14 else ""))
    if not same:
        raise RuntimeError("the sharded batcher's tokens differ")


def flops_by_op(hlo, top=8):
    """A record's dot FLOPs: by ATen op, and its ``top`` largest
    (op, operand shapes) entries."""
    by = hlo.get("dot_flops_by_op", {})
    ops = {}
    for key, v in by.items():
        ops[key.split(" ")[0]] = ops.get(key.split(" ")[0], 0.0) + v
    big = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return ({k: f"{v:.6e}" for k, v in sorted(ops.items())},
            [f"{k}: {v:.6e}" for k, v in big])


def train_trace_gate(hlo):
    """PROD_PAIR's traced dot FLOPs within 1% of the CPU host's trace and
    within 2% of the hand count, its 'model' bytes within 10% of the
    hand count; printed beside them."""
    flops, model = hlo["dot_flops"], hlo["collective_bytes_by_axis"]["model"]
    ok = (abs(flops / CPU_TRAIN["dot_flops"] - 1) <= 0.01
          and abs(flops / TRAIN_HAND["dot_flops"] - 1) <= 0.02
          and abs(model / TRAIN_HAND["model"] - 1) <= 0.10)
    say(f"  train_4k's trace here against the CPU host's (torch "
        f"2.13.0+cpu) and the hand count: dot FLOPs {flops:.6e} vs "
        f"{CPU_TRAIN['dot_flops']:.6e} ({flops / CPU_TRAIN['dot_flops']:.4f}"
        f"x) and {TRAIN_HAND['dot_flops']:.4e} "
        f"({flops / TRAIN_HAND['dot_flops']:.4f}x); 'model' bytes "
        f"{model:,.0f} vs {CPU_TRAIN['model']:,} "
        f"({model / CPU_TRAIN['model']:.4f}x) and the hand count "
        f"{TRAIN_HAND['model']:,} ({model / TRAIN_HAND['model']:.4f}x) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("train_4k's traced FLOPs or 'model' bytes are off "
                           "the CPU host's trace or the hand count")


def read_trace(proc, pair):
    """Wait for ``start_production_trace``'s process of ``pair``; its
    record."""
    arch, shape, mesh_name = pair
    out, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"the {shape} dry run failed:\n{out[-2000:]}\n"
                           f"{err[-4000:]}")
    return json.loads((PROD_OUT / f"{arch}__{shape}__{mesh_name}.json")
                      .read_text())


def start_production_trace(pair=PROD_PAIR):
    """A pair's traced dry run (``launch.dryrun``, host work only: ~2
    minutes for the production pair) in a process of its own, started
    ahead of the card's checks it runs beside."""
    arch, shape, mesh_name = pair
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--inline",
         "--force", "--arch", arch, "--shape", shape, "--mesh", mesh_name,
         "--out", str(PROD_OUT)],
        env=dict(os.environ, PYTHONPATH=str(SRC)), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def sharded_step(device="cuda", prod=None, dec=None):
    """15(d): the sharded model step and decode (see the module
    docstring), waiting at its end for ``prod`` and ``dec``
    (``start_production_trace``'s processes of PROD_PAIR and DECODE_PAIR;
    None starts them here). Returns the query-offset rows."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.time()
    prod = prod or start_production_trace()
    dec = dec or start_production_trace(DECODE_PAIR)
    rows = []
    try:
        mesh = mesh_lib.make_host_mesh((1, 1), ("data", "model"),
                                       device=device)
        say(f"== phase 15d: the sharded model step on {mesh} (backend "
            f"{dist.get_backend()}, world {dist.get_world_size()})")
        try:
            for a, layers, lr in SHARD_STEPS:
                cfg, real = sharded_vs_plain(a, layers, lr, mesh, device)
                if a == "recurrentgemma-2b":
                    trace_peak_check(cfg, real, mesh, device)
            t1 = time.time()
            sharded_decode(mesh, device)
            sharded_batcher(mesh, device)
            say(f"  the decode and the batcher on the mesh: "
                f"{time.time() - t1:.1f} s")
        finally:
            mesh_lib.close()
        for dtype in ("bfloat16", "float32"):
            for case in Q_OFFSET_CASES:
                rows.extend(q_offset_case(*case, dtype=dtype, device=device))
        for proc, pair in ((prod, PROD_PAIR), (dec, DECODE_PAIR)):
            arch, shape, _ = pair
            rec = read_trace(proc, pair)
            mem, hlo = rec["memory_analysis"], rec["hlo"]
            by_op, big = flops_by_op(hlo)
            say(f"  dryrun.run_one({arch!r}, {shape!r}, multi_pod=True) "
                f"through the trace (its own process, fake tensors on the "
                f"card, torch {torch.__version__}): temp "
                f"{mem['temp_bytes']:,} B, peak "
                f"{mem['peak_bytes_per_device']:,} B a device (arguments "
                f"{mem['argument_bytes']:,}), collective bytes by axis "
                f"{hlo['collective_bytes_by_axis']}, by op "
                f"{hlo['collective_bytes']}, counts "
                f"{hlo['collective_count']}, largest "
                f"{hlo['collective_largest']}, dot FLOPs "
                f"{hlo['dot_flops']:.6e} (by op {by_op}; largest {big}); "
                f"{rec['seconds']}")
            if pair == DECODE_PAIR:
                say(f"  the same trace on a CPU host (torch 2.13.0+cpu): "
                    f"collective bytes by axis {CPU_DECODE}")
            else:
                train_trace_gate(hlo)
    finally:
        for proc in (prod, dec):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    torch.cuda.empty_cache()
    say(f"  phase 15d: {time.time() - t0:.1f} s")
    return rows


def phase_mesh_roofline(device="cuda"):
    """Phase 15: the mesh fan-out of the quantum round on the NCCL host
    mesh, the federated dry run on the fake production mesh, the roofline
    of a prefill from profiler traces, and the sharded model step.
    Returns phase 15(d)'s rows."""
    t0 = time.time()
    prod = start_production_trace()
    dec = start_production_trace(DECODE_PAIR)
    try:
        mesh_round(device)
        mesh_dryrun_fed(device)
        roofline_prefill(device)
    except BaseException:
        for proc in (prod, dec):
            proc.kill()
            proc.communicate()
        raise
    rows = sharded_step(device, prod, dec)
    say(f"  phase 15: {time.time() - t0:.1f} s")
    return rows


# ------------------------------------------------------ --train-probe
# (peak lr, grad_clip) settings of phase 11's model, batch and optimizer
PROBE_SETTINGS = ((1e-3, 1.0), (1e-3, 0.0), (1e-2, 1.0))


def train_probe(device="cuda"):
    """Phase 11's model, batch, optimizer and schedule (warmup 0), no
    gate: step 1's gradient norm, the embedding's share of it and the
    share of its elements that the clip to 1 puts below AdamW's eps; then
    for each of PROBE_SETTINGS, from the same init, the share of weight
    elements the first update leaves unchanged in bf16 (all, and all but
    the embedding) and the 5 steps' losses."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import token_batches
    from repro_torch.launch import train
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import global_norm, linear_warmup_cosine
    cfg = get_config("recurrentgemma-2b")
    model = Model(cfg)
    params = model.init(seed=0, device=device)
    batch = next(token_batches(cfg, TRAIN_B, TRAIN_S, seed=0, device=device))
    base = train.optimizer(cfg)
    _, _, grads = loss_and_grads(model, params, batch)
    gnorm = float(global_norm(grads))
    emb = grads["embed/tokens"].float()
    tiny = float((emb.abs() * min(1.0, 1.0 / gnorm) < base.eps).float()
                 .mean())
    say(f"train probe ({cfg.name}, B={TRAIN_B}, S={TRAIN_S}; card "
        f"{smi('name,power.limit')}): step 1's global norm {gnorm:.4e}, "
        f"{float(emb.norm()) / gnorm:.4f} of it in embed/tokens; clipped "
        f"to 1, {tiny:.4f} of the embedding's elements are below eps "
        f"{base.eps}")
    del grads, emb, params
    torch.cuda.empty_cache()
    out = {"gnorm": gnorm, "tiny": tiny}
    for lr, clip in PROBE_SETTINGS:
        opt = dataclasses.replace(base, grad_clip=clip)
        schedule = linear_warmup_cosine(lr, 0, TRAIN_STEPS)
        params = model.init(seed=0, device=device)
        state = opt.init(params)
        step_fn = make_train_step(model, opt)
        before = {k: v.clone() for k, v in params.items()}
        losses = []
        for i in range(TRAIN_STEPS):
            params, state, metrics = step_fn(params, state, batch,
                                             schedule(i))
            losses.append(float(metrics["loss"]))
            if i == 0:
                same = {k: int((params[k] == v).sum())
                        for k, v in before.items()}
                del before
        n_all = sum(v.numel() for v in params.values())
        n_emb = params["embed/tokens"].numel()
        kept = sum(same.values()) / n_all
        kept_rest = (sum(same.values()) - same["embed/tokens"]) / (
            n_all - n_emb)
        say(f"  peak lr {lr}, grad_clip {clip}: step 1 leaves {kept:.4f} "
            f"of the weights unchanged in bf16 ({kept_rest:.4f} outside "
            f"the embedding); losses " + ", ".join(f"{x:.6f}" for x in losses))
        out[f"lr {lr} clip {clip}"] = dict(losses=losses, unchanged=kept,
                                           unchanged_rest=kept_rest)
        del params, state
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def torch_equal_all(xs, ys):
    import torch
    return all(torch.equal(a, b) for a, b in zip(xs, ys))


def time_serve():
    """bench_serve.py's 10,000-tenant cell on the card (``serve_cell``),
    one JSON line."""
    import tempfile
    card = smi("name,power.limit")
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tenants = Tenants()
        serve_cell(card, tmp, 8, tenants, rounds=SERVE_K, solo_n=1)
        rec, launches, _ = serve_cell(card, tmp, SERVE_BIG, tenants)
    print(json.dumps({"serve_cell": rec, "launches": launches,
                      "card": card}), flush=True)
    return 0


# ------------------------------------------------- --time-quantum (A/B)
def time_quantum(trials=3):
    """ms/round of both quantum cells (phase 4's ``round_ms``, 10 rounds
    after a warm-up, ``trials`` times), and ms per call through ``ops``
    (``cuda_ms``, ``trials`` times) of zgemm at the (2,3,2) chain's and
    the (4,5,4) density build's shapes, dense and with the second operand
    column-major as QR returns it, beside ``torch.matmul`` on complex64 of
    the same operands, and of the trace at the three shapes of those
    cells. Seeded inputs; one JSON line of medians and trials."""
    import statistics
    import torch
    from repro_torch.core.quantum import qnn
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(3)

    def rc(*shape):
        return torch.complex(torch.randn(shape, generator=gen,
                                         dtype=torch.float64),
                             torch.randn(shape, generator=gen,
                                         dtype=torch.float64)).cuda()

    def col_major(x):
        return x.mT.contiguous().mT

    cases = {}
    for bsz, d in ((2, 16), (40, 64)):
        a, b = rc(bsz, d, d), rc(bsz, d, d)
        for lay, bb in (("dense", b), ("strided", col_major(b))):
            cases[f"zgemm ({bsz},{d},{d}) {lay}"] = (ops.complex_matmul,
                                                     (a, bb))
            cases[f"torch.matmul ({bsz},{d},{d}) {lay}"] = (
                torch.matmul, (a.to(torch.complex64),
                               bb.to(torch.complex64)))
    for label, sa, sb in (("(2,3,2)", (30, 4, 32, 8, 4), (30, 4, 1, 8, 4)),
                          ("S1", (40, 4, 32, 64, 8), (40, 4, 16, 64, 8)),
                          ("S2", (50, 4, 512, 32, 16), (50, 4, 1, 32, 16))):
        cases[f"trace {label}"] = (ops.ensemble_commutator_trace,
                                   (rc(*sa), rc(*sb)))
    result = {"src": str(qnn.__file__).rsplit("/repro_torch/", 1)[0],
              "card": smi("name,power.limit")}
    for label, kw in (("(2,3,2) N=100", {}),
                      ("(4,5,4) N=20", dict(widths=(4, 5, 4),
                                            num_nodes=20))):
        cfg, ds, _, params = main_cell(**kw)
        ms = [round_ms(cfg, ds, params, reps=10) for _ in range(trials)]
        result[f"round {label}"] = {"median": statistics.median(ms),
                                    "trials": ms}
    for label, (fn, args) in cases.items():
        ms = [cuda_ms(fn, *args) for _ in range(trials)]
        result[label] = {"median": statistics.median(ms), "trials": ms}
    print(json.dumps(result), flush=True)
    return 0


# ----------------------------------------------------- --time-seq (A/B)
def seq_timing_inputs(device="cuda"):
    """Seeded inputs at the sequence kernels' path shapes: GLA r, k, v
    (4, 4096, 64, 64) bf16 with w fp32 drawn as the RWKV6 block's decay
    exp(-exp(x)), x uniform over its clip [-12, 4], u (64, 64); the same at
    4097 tokens (the S+1 prefill, chunk 1); the RG-LRU scan's a in (0, 1)
    and b (4, 4096, 2560) fp32; fp32-storage attention at the
    RecurrentGemma-2B prefill's shape (q (40, 4096, 256), kv (4, 4096,
    256) heads-major, causal, window 2048) and its backward at phase 11's
    (q, o, dO (10, 4096, 256), kv (1, 4096, 256), the LSE from the
    forward of the port under test); the GLA backward at phase 11b's
    (B = 1, the same draws, dout bf16 N(0, 1), no dstate)."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    g = torch.Generator(device="cpu").manual_seed(12)

    def gla(s, b=SERVE_B):
        rkv = [(0.5 * torch.randn((b, s, 64, 64), generator=g)).to(
            device, torch.bfloat16) for _ in range(3)]
        x = torch.rand((b, s, 64, 64), generator=g) * 16.0 - 12.0
        return rkv + [torch.exp(-torch.exp(x)).to(device),
                      (0.5 * torch.randn((64, 64), generator=g)).to(device)]
    a = torch.rand((SERVE_B, SERVE_S, 2560), generator=g).to(device)
    b = torch.randn((SERVE_B, SERVE_S, 2560), generator=g).to(device)

    def r(*shape):
        return torch.randn(shape, generator=g).to(device)
    mask = dict(causal=True, window=2048)
    fwd = (r(SERVE_B * 10, SERVE_S, 256), r(SERVE_B, SERVE_S, 256),
           r(SERVE_B, SERVE_S, 256))
    q, k, v, do = (r(10, TRAIN_S, 256), r(1, TRAIN_S, 256),
                   r(1, TRAIN_S, 256), r(10, TRAIN_S, 256))
    o, lse = kfa.flash_attention(q, k, v, return_lse=True, **mask)
    gla_bwd = gla(TRAIN_S, TRAIN_B)
    gla_bwd += [torch.randn(gla_bwd[0].shape, generator=g).to(
        device, torch.bfloat16), None]
    return {"gla_chunked (4,4096,64,64) bf16 chunk 16": ("gla", gla(SERVE_S),
                                                         16),
            "gla_chunked (4,4097,64,64) bf16 chunk 1": ("gla",
                                                        gla(SERVE_S + 1), 1),
            "rglru_scan (4,4096,2560) fp32": ("scan", (a, b), None),
            "flash_attention fp32 (4,4096,10|1,256) window 2048": (
                "attn", fwd, mask),
            "flash_attention_bwd fp32 (1,4096,10|1,256) window 2048": (
                "attn_bwd", (q, k, v, o, do), dict(mask, lse=lse)),
            "gla_chunked_bwd (1,4096,64,64) bf16 chunk 16": (
                "gla_bwd", gla_bwd, 16)}


def time_attn_bwd(splits=(1, 2, 3, 5, 10), reps=20):
    """The bf16 attention backward alone at phase 11's shape (q (10, 4096,
    256), kv (1, 4096, 256), causal, window 2048; inputs drawn from seed
    0): ms a call by CUDA events for each of ``splits`` groups of the
    query heads in the dK/dV pass and for the wrapper's own choice, the
    host's enqueue time a call, and one call's device time by kernel;
    one JSON line."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g).to("cuda", torch.bfloat16)
    q, k, v, do = r(10, TRAIN_S, 256), r(1, TRAIN_S, 256), \
        r(1, TRAIN_S, 256), r(10, TRAIN_S, 256)
    kw = dict(causal=True, window=2048)
    out, lse = kfa.flash_attention(q, k, v, return_lse=True, **kw)

    def call():
        kfa.flash_attention_bwd(q, k, v, out, do, lse=lse, **kw)
    by_splits, choose = {}, kfa.bwd_splits
    try:
        for n in splits:
            kfa.bwd_splits = lambda *a, n=n: n
            by_splits[n] = cuda_ms(call, reps=reps, warmup=2)
    finally:
        kfa.bwd_splits = choose
    ms = cuda_ms(call, reps=reps, warmup=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    passes = profile_device(f"one {ATTN_BWD} call", call)
    print(json.dumps({
        "splits_ms": by_splits, "ms": ms,
        "splits": choose(10, 1, TRAIN_S, torch.cuda.get_device_properties(
            0).multi_processor_count),
        "host_enqueue_ms": host_ms,
        "device_ms": {n[:60]: t / 1e3 for n, (t, _) in passes.items()},
        "card": smi("name,power.limit")}), flush=True)
    return 0


def time_seq(trials=5):
    """ms per call (``cuda_ms``, ``trials`` times) of gla_chunked and its
    backward, rglru_scan and the fp32-storage attention forward and
    backward through their wrappers at ``seq_timing_inputs``, for the
    port under ``--src`` (a port without the GLA backward skips it); one
    JSON line of medians and trials."""
    import statistics
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import gla_chunked as kgla
    from repro_torch.kernels import rglru_scan as krg
    result = {"src": str(kgla.__file__).rsplit("/repro_torch/", 1)[0],
              "card": smi("name,power.limit")}
    for label, (kind, args, extra) in seq_timing_inputs().items():
        if kind == "gla_bwd" and not hasattr(kgla, "gla_chunked_bwd"):
            continue                      # a port from before the kernel
        if kind == "gla":
            fn = lambda: kgla.gla_chunked(*args, chunk=extra)  # noqa: E731
        elif kind == "gla_bwd":
            fn = lambda: kgla.gla_chunked_bwd(  # noqa: E731
                *args, chunk=extra)
        elif kind == "attn":
            fn = lambda: kfa.flash_attention(*args, **extra)  # noqa: E731
        elif kind == "attn_bwd":
            fn = lambda: kfa.flash_attention_bwd(  # noqa: E731
                *args, **extra)
        else:
            fn = lambda: krg.rglru_scan(*args)  # noqa: E731
        ms = [cuda_ms(fn, reps=20, warmup=3) for _ in range(trials)]
        result[label] = {"median": statistics.median(ms), "trials": ms}
    print(json.dumps(result), flush=True)
    return 0


def nan_check():
    """``--nan-check``: ``nan_rows_check`` alone, at phase 5's fp32
    attention shape (q (40, 4096, 256), kv (4, 4096, 256), causal, window
    2048) on seeded unit-scale inputs, for the port under ``--src``; one
    JSON line. Exits 1 when a NaN misses a row it reaches."""
    import torch
    from repro_torch.kernels import build
    g = torch.Generator(device="cpu").manual_seed(21)
    q, k, v = (torch.randn(shape, generator=g).cuda() for shape in (
        (SERVE_B * 10, SERVE_S, 256), (SERVE_B, SERVE_S, 256),
        (SERVE_B, SERVE_S, 256)))
    ok = nan_rows_check(q, k, v, dict(causal=True, window=2048),
                        "flash_attention fp32")
    print(json.dumps({"src": str(build.__file__).rsplit("/repro_torch/",
                                                        1)[0],
                      "nan_rows_ok": ok, "card": smi("name,power.limit")}),
          flush=True)
    return 0 if ok else 1


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "the port on the card only", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no repro_torch in {SRC}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    if "--time-quantum" in sys.argv:
        return time_quantum()
    if "--time-seq" in sys.argv:
        return time_seq()
    if "--nan-check" in sys.argv:
        return nan_check()
    if "--time-serve" in sys.argv:
        phase_build()
        return time_serve()
    if "--train-probe" in sys.argv:
        phase_build()
        return train_probe()
    if "--time-attn-bwd" in sys.argv:
        phase_build()
        return time_attn_bwd()
    t0 = time.time()
    seconds = {}

    def timed(label, phase):
        start = time.time()
        out = phase()
        seconds[label] = round(time.time() - start, 1)
        return out
    timed("1", phase_build)
    results = timed("2", phase_kernels)
    launches = timed("3", phase_main)
    for name, row in results.items():
        row["launches"] = launches[name]
    rows = list(results.values()) + timed("4", phase_wide)
    rows += list(timed("5", phase_serve).values())
    rows += timed("6", phase_rwkv)
    rows += timed("7", phase_engines)
    rows += timed("8", phase_fed_core)
    timed("9", phase_api)
    rows += timed("10", phase_cohorts_serving)
    rows += timed("11", phase_train)
    rows += timed("11b", phase_train_rwkv)
    rows += timed("12", phase_fed)
    rows += timed("13", phase_archs)
    timed("14", phase_batching)
    rows += timed("15", phase_mesh_roofline)
    say(f"seconds a phase {seconds}")
    say(f"total {time.time() - t0:.1f} s")
    say(smi("name,power.limit"))
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape"]
    extra = ["device_us", "cell", "layout", "floor_ms", "floor_device_us"]
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + [k for k in extra if k in r]}
        for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
