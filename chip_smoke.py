#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. environment: the card's name and power limit (``nvidia-smi``);
2. build: compiles every CUDA kernel of the port from ``src/repro_torch/
   kernels/csrc`` with ``nvcc`` (one process per source, all at once), and
   fails unless the flash library's machine code holds tensor-core
   instructions (``cuobjdump -sass``: HGMMA and FFMA counted); counts the
   SHA-1 body's instructions in the UTS library's machine code by the
   pipe that runs them, and reads the card's top SM clock, for the
   integer bound of both UTS kernels;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, bit-equal, with CUDA-event times (median of 10 runs) and the least
   time the card could take for the same work; ``mandelbrot`` also through
   its full-iteration build (the cycle exit off), timed in turns with the
   kernel, and through a plain run of the kernel's cycle-exit schedule,
   which counts the iterations its bound holds these inputs to;
   ``uts_expand`` (a whole task's traversal in one cooperative launch) on
   full trees of depths 8, 9 and 10, on a 50,000-node task from a depth-14
   frontier, and on the same task at a capacity that forces relaunches;
   then the depth-14 tree alone through the kernel (generations, time per
   generation), and a bag of 4,194,304 leaves, whose generations hash
   nothing (the scan and the grid barrier alone);
4. UTS main path: ``uts_sequential`` for depths 4..10 against the published
   tree sizes, then the paper's Table 1 first row (seed 19, b0 4, depth 14)
   through ``uts_sequential`` and through ``run_irregular`` on the elastic
   pool with and without batching; the three counts must agree; each path
   must launch ``uts_expand`` (at most 5 times on the sequential one, at
   most once per task on the elastic ones, relaunches aside) and
   ``uts_hash`` (the root digest); then one more elastic run (batching
   off) at depth 12 under ``torch.profiler``: the device's idle share and
   every ``uts_expand`` launch's duration;
5. Mariani-Silver main path: the paper's sd-64 geometry (64-pixel seed
   rectangles, depth 5, split 2, max dwell 5,000,000) on a 512x512 image
   (the paper's is 4096x4096: some 500,000 tasks, which the host-bound
   elastic pool, at a few hundred tasks a second, cannot finish inside
   the smoke's time limit), through
   ``run_irregular`` on the elastic pool without batching, and with
   batching at 128 x 128 (``MS_BATCHING_SIDE``, for the smoke's time), then
   once more at 128 x 128 under ``torch.profiler`` (the device's idle
   share, every ``mandelbrot`` launch's duration, and the share of the
   wall time in which a launch over 1 ms ran); all three images must
   equal Mariani-Silver applied to ``naive_render``'s dwell map of their
   size on the card, pixel for pixel; then, at the paper's full size, the dwell map, the
   number of tasks Mariani-Silver over it dispatches, and the plane
   through the kernel and its full-iteration build alone, bit-equal;
6. flash attention at fixed shapes (run right after phase 3): the kernel
   against its plain version at gemma3-1b's attention shapes (G = 4 query
   heads on one KV head, D = 256, bf16, batch 2, S = 4096 causal, S = 4096
   window 512, S = 4000 ragged, and S = 4096 causal with float32 q and k
   as a bf16 model feeds it) and one float32 soft-capped case, with
   kernel, plain and ``scaled_dot_product_attention`` times and the bound;
   every case is checked twice: as given, per element, within the bound
   that rounding p and the output to bf16 allows (``flash_allowed``), and
   cast to float32 through the kernel's float32 build within the
   reference's 3e-5 + 1e-4 |value|, which holds the kernel's logic (the
   masks, the tile loop, the online softmax: one template for every
   dtype) tightly;
7. betweenness centrality at the paper's scale 17 (``BC_PAPER``: 131,072
   vertices, 1,001,740 edges; run before the model): ``bc_batch`` of 8
   sampled sources of the paper graph against a queue-based float64
   Brandes on the host (in worker processes, over their own R-MAT
   sampling, whose edge set must equal the port's), and each source's
   dependency sum against the sum of (d - 1) over the vertices it reaches
   (scipy's BFS distances); once those workers have ended, the two level
   kernels (``bc_level.cu``) against their plain versions, the whole
   state (bit-packed masks, level-ordered sigma and coeff, delta) bit for
   bit after every level of ``bc_batch``'s own loop (its ``steps`` hook),
   on a scale-12 graph with 256 sources and on the paper graph with 64
   and with 1,024 sources (a main-path task's block), with CUDA-event
   times per level (median of 10), the bytes bound (one bit a pair to
   know which pairs are on duty; beside it the bound of a design that
   reads dist, 4 bytes a pair, to find them), and
   ``torch.sparse.mm`` of the CSR adjacency with the level's operand (the
   product alone, timed, never called by the port); the build fails if
   ``bc_level`` spills; then ``bc_spec(BC_PAPER, n_tasks=128,
   regenerate_graph=True)`` through ``run_irregular``: on the elastic
   pool (the timed run, sources per second), on a local pool of 4
   threads with batching, which fuses queued blocks into
   ``execute_batch`` calls (the elastic pool would run each block on its
   own), and its first 8 blocks on the elastic pool under
   ``torch.profiler`` (the device's idle share, every level launch's
   duration, the profiler's cost in wall time against the timed run's
   per task); the profiled map must equal the timed run's partials of
   its blocks, summed in key order, bit for bit, and the fused map agree
   within the reference's tolerances; 3 sampled tasks of the first run
   replayed through the plain versions bit for bit;
8. faults, master kills and resumes, and the hybrid, sim and speculative
   pools (run after BC; ``phase_chaos``): the reference's
   ``chaos_mortality`` row at its own shapes on the sim pool (UTS, MS, BC
   at 0, 10 and 30 % container mortality; the master killed after 5
   folds and resumed for UTS plain, 3 shards and batched, MS and BC; the
   routing policies), ``cost_performance_sim`` (UTS depth 10) and
   ``fig4_dynamic_optimization_sim`` (UTS depth 11 through
   ``simulate_uts_pool``), every task body on the card, each derived
   value equal to the JAX package's (virtual time and dollars are the
   provider model's, a function of the task results alone); then on the
   elastic pool: Table 1's depth 14 at 30 % mortality; its depth 12 (cut
   from 14 to leave time for phase 9) unkilled, and killed after 264 of
   its 529 folds with the WAL spilled to a file (a checkpoint every 64
   folds) and resumed from that file, all counting 7,356,928 nodes, with
   the journal's size and the master's time to encode and write it;
   Mariani-Silver 256² (sd-64, max dwell 5,000,000) killed at
   half its folds and resumed, equal to Mariani-Silver over
   ``naive_render``; BC_SCALED's 32 tasks killed at half and resumed from
   a spilled journal, bit-equal to an unkilled run; the card's UTS and MS
   journals resumed with ``device="cpu"`` specs and a journal of the CPU
   resumed on the card, bit-equal; UTS depth 12 on a ``hybrid`` pool
   (cost-per-deadline routing) and on a ``speculative`` elastic pool
   whose clones must all finish, both equal to ``uts_sequential``;
9. the harness (``phase_harness``, after phase 8): the reference's
   ``trace_record_replay`` row at its own shapes (UTS depth 9 on a 512-wide
   AWS Lambda sim pool, every body on the card, recorded through a
   4,096-event ``TraceStore`` ring spilled under ``build/harness``; three
   what-if replays, whose bodies are virtual and launch nothing; the Fig.
   4 artifacts; ``calibrate`` recovering a known preset), every value equal
   to the JAX package's; Figs. 7-9's cost-performance row at Table 1's
   seed and branching, depth cut from 14 to 12 (``FIG7_9_DEPTH``), on its
   three pools (elastic at (4, 1000), elastic under the Listing-5
   controller, a 2-thread local pool as the VM), each counting the tree,
   with wall times, costs and price-performance beside the paper's
   figures; ``serve`` open loop at full width (4 req/s, two tenants, MMPP,
   16 requests' horizon), every request answered and its spilled timeline
   replayed to one root task a request, each decode step timed;
   ``serve_traffic_sim`` and the host-only rows ``serving_knee``,
   ``dag_pipeline`` and ``faas_parallelism`` through the port's
   ``traffic`` and ``dag``, equal to the JAX package's; the three example
   twins (``repro_torch.examples``) at their default sizes, each passing
   its own oracle;
10. the model path, gemma3-1b at full width with random weights from a
   seed: ``prefill`` of prefill_32k's S = 32,768 (batch cut from 32 to 1),
   whose 26 attention layers must each launch the flash kernel, then one
   global and one local layer's own operands again through kernel and
   plain version (both checks); 32 ``decode_step`` tokens on from that
   cache padded to an arena of 32,768 + 32; ``prefill`` at S = 4096 with the kernel and with the
   plain version forced, one decode step on each one's cache, and
   prefill(4096) + one decode step against prefill(4097), on the same
   weights (``compare_model``); a warm prefill and four decode
   steps under ``torch.profiler`` (device busy time, largest kernels, the
   device's idle share); then ``serve`` (16 requests, 4 slots, max_seq
   256) through the ElasticBatcher, which must answer all;
11. the other model families (``phase_model_families``), random bf16
   weights from seed 0 drawn on the card leaf by leaf: deepseek-moe-16b
   at full width and depth (28 layers, 64 experts, top-6, 2 shared) with
   the same prefill of 32,768 tokens (28 flash launches), 32 decode steps,
   the kernel on a layer's own operands, a profiled prefill and four
   decode steps, and ``serve`` with 16 requests; deepseek-v3-671b at full
   width cut to 2 layers (one dense MLA layer, one MoE MLA layer, the MTP
   head initialised; listed as ``reduced``), a 4,096-token prefill whose
   MLA attention goes through the kernel zero-padded from q.k 192 and v
   128 to 256 (its bound taken on the unpadded work), 8 absorbed-form
   decode steps; chatglm3-6b, starcoder2-15b, musicgen-medium and
   llava-next-mistral-7b at full width cut to 2 layers, a 4,096-token
   prefill (``embeds`` for the two frontend stubs) and 4 decode steps.
   Each model is held whole, kernel against plain version at S = 4096,
   within phase 10's gate, with one decode step on each version's cache;
   prefill(4096) + one decode step against prefill(4097) is held where
   none of the last token's MoE pairs was dropped at capacity (it is the
   first dropped), and the count is printed either way, with the pairs
   dropped per MoE layer and the routing decisions that differ between
   the kernel's and the plain version's prefill (a bf16 near-tie may
   flip; the gate stays the logits');
12. the recurrent families (``phase_recurrent_families``), random bf16
   weights from seed 0: rwkv6-1.6b at full width and depth (24 layers of
   RWKV-6 time and channel mix) with the same prefill of 32,768 tokens
   (24 ``wkv6`` launches, no flash launch), 32 decode steps (24 ``wkv6``
   launches each), ``wkv6`` on a layer's own prefill operands against its
   plain version (bit-equal) with its bound, a profiled prefill and four
   decode steps, the whole model at S = 4096 under phase 10's gate, and
   ``serve`` with 16 requests (24 ``wkv6`` launches a decode step);
   jamba-v0.1-52b at full width cut to one period of 8 layers (from 4: 7
   Mamba layers, one attention layer, 4 MoE and 4 MLP FFNs; listed as
   ``reduced``; its 51.6e9 parameters do not fit on one card, so it is not
   served), the same prefill (7 ``selective_scan`` launches and one flash
   launch), 32 decode steps, ``selective_scan`` and flash on the prefill's
   own operands, and the whole model at S = 4096 with the MoE routing
   replayed, as in phase 11; every path of this phase counts the
   launches of all three kernels it may run;
13. training (``phase_training``): the flash backward kernel
   (``csrc/flash_attention_bwd.cu``) against autograd over its plain
   version on the operands ``FlashAttention.backward`` gave it while
   gemma3-1b's whole-model gradient ran (a global and a local layer, B 1,
   S 4,096), on deepseek-moe-16b's layer (16 heads, D 128) and on one
   float32 case with a window and a soft-cap: dQ, dK, dV within
   ``FLASH_BWD_TOL`` of their largest values as given and within 1e-4
   cast to float32, two launches bit-equal, kernel, plain and SDPA-backward
   times (median of 5), the bound (all five products at the bf16 rate)
   and the floor in the products' own types; the forward's output
   bit-equal with the log-sum-exp on; ``loss_fn`` and every gradient of
   gemma3-1b at full width and depth, kernels against ``backend="ref"``
   (loss 1e-3, norm 1e-3, every leaf's cosine 0.999); gemma3-1b trained at
   full width and depth on 2 x 4,096 tokens (``train_4k``'s batch cut
   from 256; 4 does not fit):
   run (a) steps 0-5 of a 12-step schedule with a checkpoint at 6
   (restored to the host bit-equal), run (b) resumed there to 12, run (c)
   unbroken; (b)'s losses must be (c)'s bit for bit, the loss must fall,
   every step launch 52 forward and 26 backward flash kernels; step time,
   tokens/s, ``mfu``, peak memory, two steps under the profiler,
   checkpoint bytes and seconds; deepseek-moe-16b cut to 2 layers trained
   3 steps (finite, ``router_aux`` > 0, every expert that got pairs a
   finite non-zero gradient); the ``train_lm`` twin at 100 of its 200
   steps (the loss falls); then the recurrent families (``train_recurrent``): the
   scans' backward kernels (``csrc/wkv6_bwd.cu``,
   ``csrc/selective_scan_bwd.cu``) against autograd over their plain
   forwards on the operands their ops were given while a model trained
   (an rwkv6-1.6b layer at its training shape, B 4 x 4,096, from the
   rwkv6-1.6b steps below; a jamba Mamba layer, B 1 x 4,096, from the
   jamba steps below) and at small ragged and unaligned shapes:
   each gradient within ``SCAN_BWD_TOL`` of its largest value, two
   launches bit-equal, the forward's output, final state and checkpoints
   the same bits with its checkpoints on and off, kernel time (median of
   5), the plain backward's (one run: autograd over the plain loop takes
   some 9-11 s at 4,096 steps) and the bound (``scan_bound``);
   rwkv6-1.6b's whole model at full width cut to 4 of its 24 layers and
   jamba at full width cut to its blocks 2 and 4 (Mamba + MLP, attention
   + MLP; no MoE, whose routing flips between kernel and plain version),
   each at B 1 x 1,024 (the plain scans at 4,096 would take minutes, and
   over 24 layers some 85 s at 1,024) with float32 weights (with
   bf16 the gradient is chaotic at float32 rounding's scale:
   ``tools/scan_grad_control.py``), kernels against ``backend="ref"``
   under gemma3-1b's gate; rwkv6-1.6b at full width and
   depth trained 8 steps of 4 x 4,096 (``train_4k``'s batch cut from 256;
   the loss falls, 48 ``wkv6`` and 24 ``wkv6_bwd`` launches a step, step
   0's gradients taken twice bit-equal, step time, tokens/s, ``mfu``, peak
   memory, two steps under the profiler); jamba at full width cut to its
   blocks 3 and 4 (Mamba + MoE, attention + MLP; the 8-layer period's
   13.3e9 parameters with AdamW do not fit) trained 3 steps of 1 x 4,096
   (finite, ``router_aux`` > 0, 2 ``selective_scan``, 1
   ``selective_scan_bwd``, 2 flash forward and 1 flash backward launches
   a step, every expert that got pairs a finite non-zero gradient);
14. the mesh path (``phase_mesh``): one card is a world of 1, a 1 x 1
   ("data", "model") mesh over NCCL (``launch/mesh.make_host_mesh``);
   gemma3-1b at full width and depth trained 3 steps of 2 x 4,096
   through ``train(mesh=...)`` (``plan_cell(mesh, fsdp=True)``: FSDP
   gathers and reduce-scatters, the model axis's collectives, the
   vocab-parallel loss, all on one rank), its losses held to phase 13's
   unbroken run bit for bit (a world of 1 sums in the same order), 52 forward
   and 26 backward flash launches a step, its step time beside phase
   13's and its peak memory; its checkpoint restored with
   ``shardings=`` bit-equal to the same steps replayed through
   ``plan_cell``; deepseek-moe-16b cut to 2 layers through ``moe_apply``
   with the replicated and the all-to-all dispatch: a train step each
   (the replicated one's loss against the meshless step's) and a
   4,096-token prefill each, whose MoE output must equal
   ``moe_block_local`` with ``n_shards=1`` on its own operands at the
   dispatch's capacity, bit for bit; then one more gemma3-1b mesh step,
   untimed, counted op by op (``benchlib.op_analysis.analyze_step``) and
   its peak memory read;
15. the dry run held to the card (``phase_roofline``): in processes of
   their own, started after the build and run beside phases 3 and 6 (the
   run waits for them before phase 4), the dry run
   of that step (gemma3-1b, 2 x 4,096, a 1 x 1 mesh on a fake process
   group, meta tensors) and of the production cell gemma3-1b ``train_4k``
   on pod256 (16 x 16); the first's flops, bytes,
   transcendentals, kernel ops by name and collectives by kind must equal
   the real step's count exactly, its predicted peak (arguments + temp)
   be within 15 % of the step's ``max_memory_allocated``, and the second
   end "ok"; the collectives beside the 674 a step that
   ``tools/mesh_step_profile.py``'s trace counts, and the roofline terms
   beside phase 14's median step;
16. every process the run started is stopped and waited for (the
   resource tracker of the BC oracle's spawn pool, which would outlive
   the script, and any other left over, listed in the report), then one
   JSON line with every kernel's launches on each main path, error,
   times and bound, and the last line ``{"ok": true, "device": ...}``.
   A failing run stops its processes too.

Each of the main-path runs (three UTS, two Mariani-Silver (since the
dry-run phase the second, with batching on, at 128²), three BC,
prefill, decode, serve, each family's prefill and decode, the MoE and
rwkv6 serves, the training and mesh paths), and each run of phases 8 and
9 on the card, is
driven with the launch counts set to 0 just before it and read just after
it, and fails unless its kernel launched (BC: both level kernels); phase
9's replays, fit and host-only rows must launch none.  Decode and
serve of the attention models run no hand kernel (the decode product is
plain PyTorch, as the reference leaves it to XLA, and the batcher's
prefill only counts tokens); their flash launches are read and reported,
0.  The recurrent models' decode and serve run the scan kernels, one
launch a recurrent layer and step, and must.  The depth 4..10
checks and every comparison launch fall outside those counts.  During the
runs a seeded sample of the operands each kernel is given (a few per
distinct padded shape and static arguments; for ``uts_expand``, per
power-of-two bag size and budget) is kept, and afterwards each
sample goes through the kernel and its plain version again: bit for bit
for the integer kernels (a ``uts_expand`` sample with a budget over
``UTS_REPLAY_ITERS`` nodes, the sequential path's whole tree, is replayed
with that budget; and a ``mandelbrot`` sample that reaches the
plain version's cap, through the full-iteration build at the main path's
own 5,000,000, bit for bit); for flash attention within a per-element
bound as the model feeds it (bf16 v), and cast to float32 through the
kernel's float32 build at the reference's 3e-5 / 1e-4.  The
``mandelbrot`` timings of main-path border strips are taken on strips
chosen by rectangle (``time_border_strips``), not on that sample, so
every run times the same strips.  Phases 3, 6 and 7 check fixed shapes;
this checks the main path's own.  The script imports nothing of the JAX
reference package.  It needs CUDA: without a card it exits with code 2.
"""
from __future__ import annotations

import gc
import hashlib
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: published UTS tree sizes, seed 19, b0 4, depths 4..10 (the reference
#: package's Table 1 sweep)
UTS_SIZES = {4: 101, 5: 416, 6: 1787, 7: 7134, 8: 28844, 9: 115780,
             10: 461459}

#: the paper's Table 1 first row
UTS_DEPTH = 14
#: Mariani-Silver: the paper's dwell, on a 512x512 image (phase 5)
MS_SIDE = 512
MS_DWELL = 5_000_000
#: the runs under the profiler (phases 4 and 5), cut for the smoke's time:
#: UTS to depth 12, Mariani-Silver to 128x128 (256x256 before the dry-run
#: phase, 512x512 before that; the last halving some 11 s less on a fast
#: host)
UTS_PROFILE_DEPTH = 12
MS_PROFILE_SIDE = 128
#: the elastic MS run with batching on, cut for the smoke's time to this
#: side (256 since the mesh phase, 128 since the dry-run phase)
MS_BATCHING_SIDE = 128
#: the plain dwell runs a sampled main-path launch at its own max_dwell
#: only if every point escapes within this many iterations; else at this
MS_SAMPLE_CAP = 4096
#: main-path launches kept per distinct launch signature (shape, max_iter)
MS_SAMPLES_PER_SHAPE = 16
#: main-path border strips timed alone, chosen by rectangle: whose border
#: reaches the set, and others
MS_TIMED_IN_SET, MS_TIMED_OTHER = 16, 80
#: a mandelbrot launch longer than this counts as long (phase 5's profile)
MS_LONG_MS = 1.0
#: the full report goes here; the output directory of a chip call
OUT_DIR = ROOT / "chiprun_out"

#: the H100's datasheet peaks and the bound helpers (one place for the
#: port: the dry run's roofline reads the same), and the model kernels'
#: work formulas, each beside its op.  Outside a checkout these imports
#: fail, and the script with them.
from repro_torch.benchlib import (HBM_BW, PEAK_FLOPS,  # noqa: E402
                                  bound_ms, live_pairs)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_bound, flash_bwd_bound, flash_bwd_floor)
#: dispatch rates per SM and clock (lanes): one warp instruction a clock on
#: each of the 4 sub-partitions, the INT32 pipe's 64 lanes, the FMA pipe
#: (which also runs IMAD) 128; the UTS kernels' integer bound
#: (``int_bound_ms``) divides their SHA-1 body's instructions by these
DISPATCH_LANES = 128
INT_LANES = 64
FMA_LANES = 128

#: 32-bit operations per SHA-1 lane: 64 schedule words (3 xor + 1 rotate),
#: 80 rounds (2 rotates, 4 adds, a 2-operation boolean function on average
#: counting lop3 as one), 5 final adds.  Held against ``PEAK_OPS_S``, a
#: float32 rate that counts an FMA as two (``bound_ms``), this is the loose
#: bound of the UTS kernels (``bound_loose_ms``): the card has half as many
#: INT32 lanes.
UTS_OPS_PER_LANE = 64 * 4 + 80 * 8 + 5
UTS_BYTES_PER_LANE = 44           # 20 B parent + 4 B index in, 20 B out
UTS_BYTES_PER_NODE = 24           # a digest and a depth
#: the published tree sizes above and the depth-14 tree
UTS_DEPTH14_NODES = 117_669_204
#: deeper trees of seed 19, b0 4: depths 12 and 13 as ``uts_sequential``'s
#: plain version counts them on the CPU (each run holds the card's count to
#: them), and depth 14
UTS_DEEP_NODES = {12: 7_356_928, 13: 29_416_589, 14: UTS_DEPTH14_NODES}
#: a sampled main-path ``uts_expand`` call is replayed through both
#: versions with at most this budget (the plain version takes some 8 ms a
#: generation of 8,192 nodes on the card)
UTS_REPLAY_ITERS = 400_000
#: uts_expand calls kept per (bag size bucket, budget bucket)
UTS_SAMPLES_PER_KEY = 2
#: float32 operations per dwell iteration: 3 mul, 3 add/sub, 1 fma (2)
MS_OPS_PER_ITER = 8
#: one dwell iteration's dependent chain, zr -> fmul -> fsub -> fadd -> the
#: next zr: three float32 operations, each issuing no sooner than 4 cycles
#: after the one it waits on (the dependent-issue latency of the FP32 pipe
#: on Volta and later, from public microbenchmarks: an assumption, not
#: measured here).  A strip's points run side by side, so its slowest
#: orbit's iterations times this chain bound its launch (the latency bound)
MS_CHAIN_CYCLES = 3 * 4
MS_BYTES_PER_POINT = 12           # two float32 in, one int32 out

KERNEL_SOURCES = {
    "uts_hash": ("src/repro_torch/kernels/csrc/uts_hash.cu",
                 "src/repro/kernels/uts_hash/kernel.py:96"),
    "uts_expand": ("src/repro_torch/kernels/csrc/uts_hash.cu",
                   "src/repro/kernels/uts_hash/kernel.py:96"),
    "mandelbrot": ("src/repro_torch/kernels/csrc/mandelbrot.cu",
                   "src/repro/kernels/mandelbrot/kernel.py:74"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:115"),
    "bc_forward_level": ("src/repro_torch/kernels/csrc/bc_level.cu",
                         "none (XLA dots, src/repro/algorithms/"
                         "betweenness.py:107, :124)"),
    "bc_backward_level": ("src/repro_torch/kernels/csrc/bc_level.cu",
                          "none (XLA dots, src/repro/algorithms/"
                          "betweenness.py:107, :124)"),
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/"
                            "flash_attention_bwd.cu",
                            "none (XLA autodiff of attention_train, "
                            "src/repro/models/attention.py:191)"),
    "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                       "none (XLA lax.scan, src/repro/models/mamba.py:93)"),
    "wkv6": ("src/repro_torch/kernels/csrc/wkv6.cu",
             "none (XLA lax.scan, src/repro/models/rwkv6.py:106)"),
    "selective_scan_bwd": ("src/repro_torch/kernels/csrc/"
                           "selective_scan_bwd.cu",
                           "none (XLA autodiff of lax.scan, "
                           "src/repro/models/mamba.py:93)"),
    "wkv6_bwd": ("src/repro_torch/kernels/csrc/wkv6_bwd.cu",
                 "none (XLA autodiff of lax.scan, "
                 "src/repro/models/rwkv6.py:106)"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def _descendants(pid: int) -> list:
    """The live processes under ``pid`` (children first), from ``/proc``."""
    parent = {}
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                stat = (d / "stat").read_text()
            except OSError:
                continue
            parent[int(d.name)] = int(stat.rsplit(")", 1)[1].split()[1])
    found, todo = [], [pid]
    while todo:
        kids = [c for c, pp in parent.items() if pp == todo[0]]
        found += kids
        todo = todo[1:] + kids
    return found


def _state(pid: int) -> str:
    try:
        return Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0]
    except OSError:
        return "?"


def _cmdline(pid: int) -> str:
    try:
        raw = Path(f"/proc/{pid}/cmdline").read_bytes()
    except OSError:
        return "?"
    return raw.replace(b"\0", b" ").decode(errors="replace").strip()


def stop_resource_tracker() -> None:
    """Stops the multiprocessing resource tracker, which a spawn pool
    starts and which otherwise lives until this interpreter exits (and a
    moment past it, holding stderr open)."""
    from multiprocessing import resource_tracker
    tracker = getattr(resource_tracker, "_resource_tracker", None)
    if tracker is not None and hasattr(tracker, "_stop"):
        tracker._stop()


def stop_children() -> list:
    """Stops every process this script started that is still running:
    the resource tracker first, then any other descendant, by SIGTERM and,
    after 5 s, SIGKILL; each is waited for.  Returns the command lines of
    the processes it had to signal (the smoke starts none that should be
    left: ``nvcc``, ``nvidia-smi`` and ``cuobjdump`` are waited for, the
    BC oracle's workers joined)."""
    stop_resource_tracker()
    left = _descendants(os.getpid())
    stopped = [f"{pid}: {_cmdline(pid)}" for pid in left
               if _state(pid) != "Z"]   # an exited child is only reaped
    for sig, grace in ((signal.SIGTERM, 5.0), (signal.SIGKILL, 5.0)):
        for pid in left:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        t_end = time.monotonic() + grace
        while left and time.monotonic() < t_end:
            for pid in list(left):
                try:
                    done, _ = os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:   # not ours to wait for
                    done = pid if not Path(f"/proc/{pid}").exists() else 0
                if done:
                    left.remove(pid)
            time.sleep(0.05)
        if not left:
            break
    if stopped:
        print(f"chip_smoke: stopped {len(stopped)} leftover process(es): "
              + "; ".join(stopped), file=sys.stderr, flush=True)
    return stopped


def cuda_time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, in ms."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def int_bound_ms(n_bytes: float, lanes: float, sha1: dict) -> tuple:
    """Least time for ``lanes`` SHA-1 compressions against ``n_bytes``:
    the instructions of the compiled body (``sass_pipes``) at the dispatch
    rate of the pipes that run them, which work side by side (so the
    busiest bounds), on every SM at the top SM clock."""
    per_lane = max(sha1["int"] / INT_LANES, sha1["fma"] / FMA_LANES,
                   sha1["all"] / DISPATCH_LANES)
    t_ops = lanes * per_lane / (sha1["sms"] * sha1["sm_clock_hz"]) * 1e3
    t_bytes = n_bytes / HBM_BW * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


#: SASS opcodes that go to no arithmetic pipe (memory, control, the
#: uniform datapath's U* instructions are matched by prefix)
_NOT_ALU = {"LDG", "STG", "LDS", "STS", "LD", "ST", "LDC", "ATOM", "ATOMG",
            "ATOMS", "RED", "BRA", "BRX", "JMP", "EXIT", "RET", "CALL", "BAR",
            "BSSY", "BSYNC", "WARPSYNC", "NOP", "YIELD", "S2R", "S2UR", "CS2R",
            "MEMBAR", "ERRBAR", "CCTL", "DEPBAR", "BPT", "SHFL", "VOTE"}


def sass_pipes(sass: str, kernel: str) -> dict:
    """Instructions of one kernel in a ``cuobjdump -sass`` listing, per
    lane (it is straight-line code): all of them, those on the FMA pipe
    (IMAD in every form, FFMA, FADD, FMUL), and the other arithmetic and
    logic ones, on the INT32 pipe."""
    fns = re.split(r"\n\s*Function : ", sass)
    body = [f for f in fns[1:] if kernel in f.split("\n", 1)[0]]
    if len(body) != 1:
        raise AssertionError(f"{kernel}: {len(body)} functions in the SASS")
    ops = [m.split(".")[0] for m in re.findall(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body[0])]
    fma = sum(o == "IMAD" or o in ("FFMA", "FADD", "FMUL") for o in ops)
    other = sum(o in _NOT_ALU or o.startswith("U") for o in ops)
    return {"all": len(ops), "fma": fma, "int": len(ops) - fma - other}


def phase_environment() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[env] nvidia-smi: {card}")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


def phase_build() -> dict:
    """Builds every kernel, then reads the machine code: the UTS library's
    SHA-1 body by pipe (``sass_pipes``) and the card's top SM clock, for
    the UTS kernels' integer bound; the flash libraries' (forward and
    backward) products must be tensor-core instructions (HGMMA, Hopper's
    wgmma), and the FFMA count (the CUDA cores' fused multiply-adds, which
    the softmax and the float32 splits still use) stands beside it."""
    import shutil

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import kernel_tiles
    t0 = time.monotonic()
    built = _build.build()
    log(f"[build] {sorted(built) or 'all cached'} in "
        f"{time.monotonic() - t0:.3f} s")
    for name in _build.KERNELS:
        for line in _build.compiler_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    # the BC level kernels keep their accumulators in registers
    spills = [int(b) for b in re.findall(
        r"(\d+) bytes spill (?:stores|loads)",
        _build.compiler_report("bc_level"))]
    if not spills or any(spills):
        raise AssertionError(f"bc_level: spill bytes {spills} in the "
                             f"compiler's report (or no report)")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"

    def disassemble(name: str) -> str:
        return subprocess.run([cuobjdump, "-sass", str(_build._target(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout

    uts_sass = disassemble("uts_hash")
    sha1 = sass_pipes(uts_sass, "uts_hash_kernel")
    if "uts_expand_kernel" not in uts_sass:
        raise AssertionError("uts_expand_kernel missing from the UTS library")
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    sha1["sm_clock_hz"] = float(clock.stdout.split()[0]) * 1e6
    sha1["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[build] uts_hash_kernel SASS (the SHA-1 body, per lane): "
        f"{sha1['all']} instructions, {sha1['int']} on the INT32 pipe, "
        f"{sha1['fma']} on the FMA pipe; {sha1['sms']} SMs at up to "
        f"{sha1['sm_clock_hz'] / 1e6:.0f} MHz")
    flash_sass = {}
    for name in ("flash_attention", "flash_attention_bwd"):
        sass = disassemble(name)
        counts = {op: len(re.findall(rf"\b{op}[.\s]", sass))
                  for op in ("HGMMA", "FFMA")}
        log(f"[build] {name} SASS: {counts['HGMMA']} HGMMA, "
            f"{counts['FFMA']} FFMA instructions")
        if counts["HGMMA"] == 0:
            raise AssertionError(f"{name}: no HGMMA in its machine code; "
                                 f"its products are not on the tensor cores")
        flash_sass[name] = counts
    tiles = kernel_tiles()
    log(f"[build] flash_attention tiles (query rows, keys) {tiles}")
    return {"flash_sass": flash_sass["flash_attention"],
            "flash_bwd_sass": flash_sass["flash_attention_bwd"],
            "flash_tiles": list(tiles), "sha1_sass": sha1,
            "bc_level_spill_bytes": sum(spills)}


def _hashlib_digest(parent: list, ix: int) -> list:
    msg = b"".join(w.to_bytes(4, "big") for w in parent) + ix.to_bytes(4, "big")
    dig = hashlib.sha1(msg).digest()
    return [int.from_bytes(dig[4 * i:4 * i + 4], "big") for i in range(5)]


def phase_kernel_uts(dev, sha1: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels.uts_hash.ops import uts_hash_cuda
    from repro_torch.kernels.uts_hash.ref import uts_child_digests_ref

    n = 1 << 20
    rng = np.random.default_rng(11)
    par_u = rng.integers(0, 2**32, size=(5, n), dtype=np.uint32)
    ix_u = rng.integers(0, 64, size=(n,), dtype=np.uint32)
    par = torch.from_numpy(par_u.view(np.int32)).to(dev)
    ix = torch.from_numpy(ix_u.view(np.int32)).to(dev)

    got = uts_hash_cuda(par, ix)
    want = uts_child_digests_ref(par, ix)
    torch.cuda.synchronize()
    got_u = got.cpu().numpy().view(np.uint32)
    want_u = want.cpu().numpy().view(np.uint32)
    err = int(np.abs(got_u.astype(np.int64) - want_u.astype(np.int64)).max())
    if not np.array_equal(got_u, want_u):
        raise AssertionError(
            f"uts_hash: kernel differs from plain version on "
            f"{int((got_u != want_u).any(axis=0).sum())} of {n} lanes")
    for j in rng.choice(n, size=1000, replace=False):
        if _hashlib_digest([int(v) for v in par_u[:, j]], int(ix_u[j])) \
                != [int(v) for v in got_u[:, j]]:
            raise AssertionError(f"uts_hash: lane {j} differs from hashlib")
    ms = cuda_time_ms(lambda: uts_hash_cuda(par, ix))
    plain_ms = cuda_time_ms(lambda: uts_child_digests_ref(par, ix))
    b_ms, b_by = int_bound_ms(n * UTS_BYTES_PER_LANE, n, sha1)
    loose_ms, _ = bound_ms(n * UTS_BYTES_PER_LANE, n * UTS_OPS_PER_LANE)
    log(f"[kernel] uts_hash N={n}: bit-equal to plain version and hashlib "
        f"(1000 lanes); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}; the loose float32-rate bound "
        f"{loose_ms:.4f} ms)")
    return {"name": "uts_hash", "max_abs_err": err, "matched": True,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_loose_ms": loose_ms, "library_ms": None,
            "shape": f"parent [5, {n}] int32, child_ix [{n}] int32"}


def expand_bounds(s0: int, count: int, s_final: int, sha1: dict) -> dict:
    """The least time of one ``uts_expand`` call that expands ``count``
    nodes of a bag of ``s0`` and leaves ``s_final``: it hashes
    ``s_final - s0 + count`` children, reads the bag once and writes the
    leftover once (24 B a node); the integer bound (``int_bound_ms``) and
    the loose float32-rate one.  Beside them, the time the design's own
    stack traffic takes at the memory rate: every expanded node read as a
    parent and every child written, 24 B each."""
    children = s_final - s0 + count
    n_bytes = (s0 + s_final) * UTS_BYTES_PER_NODE
    b_ms, b_by = int_bound_ms(n_bytes, children, sha1)
    loose_ms, _ = bound_ms(n_bytes, children * UTS_OPS_PER_LANE)
    stack_ms = (count + children) * UTS_BYTES_PER_NODE / HBM_BW * 1e3
    return {"children": children, "bound_ms": b_ms, "bound_by": b_by,
            "bound_loose_ms": loose_ms, "stack_traffic_ms": stack_ms}


def expand_both(dig, dep, iters: int, capacity=None, **kw) -> dict:
    """One ``uts_expand`` call through the kernel (at ``capacity``) and
    through the plain version (uncapped): bit for bit on the count, the
    leftover digests and depths.  Returns the kernel's result, launches
    and generations."""
    import torch
    from repro_torch.kernels import launches
    from repro_torch.kernels.uts_hash.ops import (expand_generations,
                                                  reset_expand_generations,
                                                  uts_expand)
    before = launches("uts_expand")
    reset_expand_generations()
    got = uts_expand(dig, dep, iters, capacity=capacity, backend="cuda", **kw)
    n_launch = launches("uts_expand") - before
    gens = expand_generations()
    want = uts_expand(dig, dep, iters, backend="ref", **kw)
    torch.cuda.synchronize()
    if got[0] != want[0] or not (torch.equal(got[1], want[1]) and
                                 torch.equal(got[2], want[2])):
        raise AssertionError(
            f"uts_expand ({dep.shape[0]} nodes, budget {iters}, {kw}, "
            f"capacity {capacity}): kernel ({got[0]} nodes, "
            f"{got[2].shape[0]} left) differs from the plain version "
            f"({want[0]}, {want[2].shape[0]})")
    return {"count": got[0], "left": int(got[2].shape[0]),
            "launches": n_launch, "generations": gens, "result": got}


def phase_kernel_uts_expand(dev, sha1: dict) -> dict:
    """``uts_expand`` against its plain version on the card, bit for bit:
    the whole trees of depths 8, 9 and 10 from the root; a 50,000-node
    task (the elastic path's budget) from a depth-14 frontier that the
    plain version has made (10,000 nodes in), at chunk 8192; the same task
    at the least capacity, which must relaunch at least 3 times.  Kernel
    and plain times of the task and of depth 10; then the depth-14 tree
    through the kernel alone (time, generations, time per generation),
    and a bag of leaves, whose generations hash nothing."""
    import torch
    from repro_torch.kernels import launches
    from repro_torch.kernels.uts_hash.ops import (expand_generations,
                                                  reset_expand_generations,
                                                  root_digest, uts_expand)
    root = (root_digest(19, dev), torch.zeros(1, dtype=torch.int32,
                                              device=dev))
    cases = {}
    for depth in (8, 9, 10):
        r = expand_both(*root, 2**62, b0=4.0, max_depth=depth, chunk=8192)
        if r["count"] != UTS_SIZES[depth] or r["left"]:
            raise AssertionError(f"uts_expand depth {depth}: {r['count']} "
                                 f"nodes, {r['left']} left")
        cases[f"depth {depth}"] = r
    task = dict(b0=4.0, max_depth=UTS_DEPTH, chunk=8192)
    _, fdig, fdep = uts_expand(*root, 10_000, backend="ref", **task)
    cases["task"] = expand_both(fdig, fdep, 50_000, **task)
    cases["task, least capacity"] = r = expand_both(fdig, fdep, 50_000,
                                                    capacity=1, **task)
    if r["launches"] < 4:
        raise AssertionError(f"uts_expand at the least capacity: "
                             f"{r['launches']} launches, want >= 4")
    for name, (dig, dep, iters, kw) in {
            "depth 10": (*root, 2**62, dict(b0=4.0, max_depth=10,
                                            chunk=8192)),
            "task": (fdig, fdep, 50_000, task)}.items():
        c = cases[name]
        c["ms"] = cuda_time_ms(lambda: uts_expand(dig, dep, iters,
                                                  backend="cuda", **kw))
        c["plain_ms"] = cuda_time_ms(lambda: uts_expand(
            dig, dep, iters, backend="ref", **kw), reps=3, warmup=1)
        c["us_per_generation"] = c["ms"] * 1e3 / c["generations"]
    for name, c in cases.items():
        c.update(expand_bounds(fdep.shape[0] if name.startswith("task")
                               else 1, c["count"], c["left"], sha1))
        del c["result"]
        log(f"[kernel] uts_expand {name}: bit-equal to the plain version; "
            f"{c['count']} nodes, {c['left']} left, {c['launches']} "
            f"launches, {c['generations']} generations"
            + (f"; kernel {c['ms']:.4f} ms ({c['us_per_generation']:.3f} "
               f"us a generation), plain {c['plain_ms']:.4f} ms"
               if "ms" in c else "")
            + f"; bound {c['bound_ms']:.4f} ms ({c['bound_by']}; loose "
            f"{c['bound_loose_ms']:.4f} ms; stack traffic "
            f"{c['stack_traffic_ms']:.4f} ms)")

    # the depth-14 tree through the kernel alone
    d14 = dict(b0=4.0, max_depth=UTS_DEPTH, chunk=8192)
    before = launches("uts_expand")
    reset_expand_generations()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    count, _, left = uts_expand(*root, 2**62, backend="cuda", **d14)
    end.record()
    end.synchronize()
    if count != UTS_DEPTH14_NODES or left.shape[0]:
        raise AssertionError(f"uts_expand depth {UTS_DEPTH}: {count} nodes")
    tree = {"ms": start.elapsed_time(end),
            "launches": launches("uts_expand") - before,
            "generations": expand_generations(), "nodes": count,
            **expand_bounds(1, count, 0, sha1)}
    tree["us_per_generation"] = tree["ms"] * 1e3 / tree["generations"]
    log(f"[kernel] uts_expand depth {UTS_DEPTH} tree alone: {count} nodes in "
        f"{tree['ms']:.3f} ms, {tree['launches']} launches, "
        f"{tree['generations']} generations, "
        f"{tree['us_per_generation']:.3f} us a generation; bound "
        f"{tree['bound_ms']:.3f} ms ({tree['bound_by']}; loose "
        f"{tree['bound_loose_ms']:.3f} ms; stack traffic "
        f"{tree['stack_traffic_ms']:.3f} ms)")
    # generations with no child: a bag of leaves (depth = max_depth), so
    # each generation is the scan and the grid barrier alone
    n_leaf = 8192 * 512
    leaves = (torch.zeros((5, n_leaf), dtype=torch.int32, device=dev),
              torch.full((n_leaf,), UTS_DEPTH, dtype=torch.int32, device=dev))
    reset_expand_generations()
    count, _, left = uts_expand(*leaves, 2**62, backend="cuda", **d14)
    if count != n_leaf or left.shape[0]:
        raise AssertionError(f"uts_expand on {n_leaf} leaves: {count} nodes, "
                             f"{left.shape[0]} left")
    leaf = {"nodes": n_leaf, "generations": expand_generations(),
            "ms": cuda_time_ms(lambda: uts_expand(*leaves, 2**62,
                                                  backend="cuda", **d14),
                               reps=5, warmup=1)}
    leaf["us_per_generation"] = leaf["ms"] * 1e3 / leaf["generations"]
    log(f"[kernel] uts_expand on {n_leaf} leaves: {leaf['generations']} "
        f"generations without a child in {leaf['ms']:.3f} ms, "
        f"{leaf['us_per_generation']:.3f} us a generation (scan and grid "
        f"barrier; the bag's copy in and one launch included)")
    head = cases["task"]
    return {"name": "uts_expand", "max_abs_err": 0, "matched": True,
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "bound_loose_ms": head["bound_loose_ms"], "library_ms": None,
            "shape": f"a {fdep.shape[0]}-node depth-{UTS_DEPTH} frontier, "
                     f"budget 50,000, chunk 8192",
            "cases": cases, "depth14_tree": tree, "leaf_generations": leaf}


def cycle_exit_run(c_re, c_im, max_iter: int, every: int) -> tuple:
    """A plain PyTorch run of the kernel's schedule: the full iteration,
    plus a comparison of the state with a saved one every ``every``
    iterations, re-saved at iterations ``every * 2**k``, bit for bit.
    Returns ``(dwell, iterations)``: the dwell map this schedule gives
    (the cycle exit's claim is that it is the plain version's), and per
    point the iterations the kernel runs: its dwell if it escapes, the
    iteration at which the schedule proves its orbit periodic, else
    ``max_iter``."""
    import torch
    from repro_torch.kernels.mandelbrot.ref import _fma_f32
    zr = torch.zeros_like(c_re)
    zi = torch.zeros_like(c_im)
    sr, si = zr.clone(), zi.clone()
    dwell = torch.full(c_re.shape, max_iter, dtype=torch.int32,
                       device=c_re.device)
    iters = torch.full(c_re.shape, max_iter, dtype=torch.int64,
                       device=c_re.device)
    live = torch.ones(c_re.shape, dtype=torch.bool, device=c_re.device)
    next_save = every
    for it in range(max_iter):
        zr2, zi2 = zr * zr, zi * zi
        esc = live & ~(zr2 + zi2 <= 4.0)
        dwell[esc] = it
        iters[esc] = it
        live &= ~esc
        if not bool(live.any()):
            break
        new_re = (zr2 - zi2) + c_re
        new_im = _fma_f32(2.0 * zr, zi, c_im)
        zr = torch.where(live, new_re, zr)
        zi = torch.where(live, new_im, zi)
        i = it + 1
        if i % every == 0:
            same = live & (zr.view(torch.int32) == sr.view(torch.int32)) & \
                (zi.view(torch.int32) == si.view(torch.int32))
            iters[same] = i
            live &= ~same
            if i == next_save:
                sr, si = zr.clone(), zi.clone()
                next_save *= 2
    return dwell, iters


def time_in_turns(fns: dict, reps: int = 10) -> dict:
    """CUDA-event medians of each of ``fns``, taken forward and then in
    reverse order (a, b, .., b, a) and averaged, so that a drift of the
    card's clock between the two passes falls on every entry alike."""
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            times[k].append(cuda_time_ms(fns[k], reps=reps))
    return {k: sum(v) / len(v) for k, v in times.items()}


def mandelbrot_builds(c_re, c_im, max_iter: int) -> dict:
    """The kernel as the main path launches it, and its full-iteration
    build (the cycle exit off), for measurement."""
    from repro_torch.kernels.mandelbrot.ops import (
        mandelbrot_cuda, mandelbrot_cuda_full_iteration)
    return {"kernel": lambda: mandelbrot_cuda(c_re, c_im, max_iter=max_iter),
            "full_iteration": lambda: mandelbrot_cuda_full_iteration(
                c_re, c_im, max_iter=max_iter)}


def phase_kernel_mandelbrot(dev) -> dict:
    """At 1024^2 and max_iter 256 over the paper's view: every build
    bit-equal to the plain version, and to the plain run of the kernel's
    schedule, timed in turns.  The bound counts the iterations these
    inputs need under the cycle exit (``cycle_exit_run``); the dwell sum,
    the full iteration's count, stands beside it."""
    import torch
    from repro_torch.kernels.mandelbrot.ops import cycle_check_every
    from repro_torch.kernels.mandelbrot.ref import coords, mandelbrot_ref

    side, max_iter = 1024, 256
    c_re, c_im = coords(-2.0, -1.5, 1.0, 1.5, side, side, device=dev)
    want = mandelbrot_ref(c_re, c_im, max_iter)
    sched, iters = cycle_exit_run(c_re, c_im, max_iter, cycle_check_every())
    builds = mandelbrot_builds(c_re, c_im, max_iter)
    err = 0
    for name, fn in [("schedule", lambda: sched), *builds.items()]:
        got = fn()
        torch.cuda.synchronize()
        diff = int((got != want).sum())
        err = max(err, int((got - want).abs().max()))
        if diff:
            raise AssertionError(
                f"mandelbrot {name}: differs from plain version on {diff} "
                f"of {side * side} points (max |d dwell| {err})")
    times = time_in_turns(builds)
    plain_ms = cuda_time_ms(lambda: mandelbrot_ref(c_re, c_im, max_iter))
    n_bytes = side * side * MS_BYTES_PER_POINT
    needed = int(iters.sum())
    dwell_sum = int(want.sum())
    b_ms, b_by = bound_ms(n_bytes, needed * MS_OPS_PER_ITER)
    full_b_ms, full_b_by = bound_ms(n_bytes, dwell_sum * MS_OPS_PER_ITER)
    log(f"[kernel] mandelbrot {side}x{side} max_iter {max_iter}: every build "
        f"and the plain run of the schedule bit-equal to the plain version; "
        f"iterations needed {needed} (cycle exit), {dwell_sum} (dwell sum); "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
        + f"; plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}), with "
        f"the dwell sum {full_b_ms:.4f} ms ({full_b_by})")
    return {"name": "mandelbrot", "max_abs_err": err, "matched": True,
            "ms": times["kernel"], "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "full_iteration_ms": times["full_iteration"],
            "bound_dwell_sum_ms": full_b_ms,
            "iterations_needed": needed, "dwell_sum": dwell_sum,
            "shape": f"c_re, c_im [{side}, {side}] float32, "
                     f"max_iter {max_iter}"}


#: the elastic pool of every main path: 16 workers, 1 ms an invocation
ELASTIC_CFG = dict(max_concurrency=16, invoke_overhead=1e-3,
                   invoke_rate_limit=None)


def elastic_pool(**kw):
    """The main paths' elastic pool; ``kw`` adds ``faults=`` or
    ``trace=``."""
    from repro_torch.core import make_pool
    return make_pool("elastic", **ELASTIC_CFG, **kw)


class OperandTap:
    """Keeps a sample of the operands a kernel's CUDA body is given.

    While the tap is open, the registered op's CUDA body is wrapped: every
    launch goes through the real body (which counts it) and then offers
    its padded operands (and static arguments) to a sample of ``k`` per
    ``key``, by default the launch signature (shapes and static
    arguments), so the sample spans the whole run.  The reservoir fills
    in order of arrival, so runs with concurrent workers keep different
    samples.  It holds references, not copies:
    dispatch hands a body freshly padded tensors or the caller's own,
    which nothing writes afterwards; except the arguments at the positions
    in ``clone``, which the body updates in place (a recurrent state), and
    which a kept sample copies before the body runs.
    """

    def __init__(self, name: str, k: int, seed: int = 0, key=None,
                 clone: tuple = ()) -> None:
        import random
        import threading
        self.name, self.k, self.clone = name, k, frozenset(clone)
        self.key = key or (lambda args, static: (
            tuple(tuple(a.shape) for a in args),
            tuple(sorted(static.items()))))
        self.rng = random.Random(seed)
        self.lock = threading.Lock()
        self.seen: dict = {}
        self.samples: dict = {}

    def __enter__(self) -> "OperandTap":
        import dataclasses
        from repro_torch.kernels.dispatch import get_kernel, register_kernel
        self.op = get_kernel(self.name)
        register_kernel(dataclasses.replace(self.op, cuda_body=self._body))
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.kernels.dispatch import register_kernel
        register_kernel(self.op)

    def _body(self, *args, **static):
        key = self.key(args, static)
        with self.lock:
            seen = self.seen[key] = self.seen.get(key, 0) + 1
            slot = seen - 1 if seen <= self.k else self.rng.randrange(seen)
        offer = tuple(a.clone() if i in self.clone else a
                      for i, a in enumerate(args)) if slot < self.k else None
        out = self.op.cuda_body(*args, **static)
        if offer is not None:
            with self.lock:
                kept = self.samples.setdefault(key, [])
                if slot < len(kept):
                    kept[slot] = (offer, static)
                else:
                    kept.append((offer, static))
        return out


def run_path(name: str, kernel: str, fn, required: bool = True) -> tuple:
    """Drive one main path with the launch counts set to 0 just before it
    and read just after; returns ``(result, seconds, launches of kernel)``.
    Fails if ``kernel`` did not launch, unless the path is not ``required``
    to run it (decoding and serving run no hand kernel yet)."""
    import torch
    from repro_torch.kernels import launches, reset_launches
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n = launches(kernel)
    if required and n <= 0:
        raise AssertionError(f"{name}: {kernel} not launched on this path")
    return out, wall, n


def uts_tap_key(args, static) -> tuple:
    """A ``uts_expand`` call's sample key: its bag size and its budget,
    each to the next power of two, and its other static arguments."""
    from repro_torch.kernels.dispatch import bucket
    return (bucket(args[1].shape[0], 1), bucket(static["iters"], 1),
            tuple(sorted((k, v) for k, v in static.items() if k != "iters")))


def check_uts_samples(tap: OperandTap) -> dict:
    """Every sampled ``uts_expand`` call of the main path, again through
    the kernel and through its plain version on the card: bit-equal
    (``expand_both``), with its budget cut to ``UTS_REPLAY_ITERS``."""
    nodes, replayed = 0, 0
    for key, kept in sorted(tap.samples.items()):
        for (dig, dep), static in kept:
            kw = {k: v for k, v in static.items()
                  if k not in ("iters", "capacity")}
            iters = min(static["iters"], UTS_REPLAY_ITERS)
            replayed += iters < static["iters"]
            nodes += expand_both(dig, dep, iters, capacity=static["capacity"],
                                 **kw)["count"]
    n = sum(len(v) for v in tap.samples.values())
    calls = sum(tap.seen.values())
    log(f"[uts] {n} sampled main-path uts_expand calls of {calls} "
        f"({len(tap.samples)} keys of bag size and budget; {replayed} "
        f"replayed with the budget cut to {UTS_REPLAY_ITERS}; {nodes} nodes) "
        f"bit-equal to the plain version")
    return {"samples": n, "nodes": nodes, "cut_to_replay_budget": replayed,
            "calls_by_key": {str(k[:2]): c for k, c in
                             sorted(tap.seen.items())}}


def duration_stats(ms: list) -> dict:
    """Count, count over MS_LONG_MS, p50, p99 and max of launch times."""
    import numpy as np
    a = np.asarray(ms, dtype=np.float64)
    if a.size == 0:
        return {"count": 0}
    return {"count": int(a.size), "over_1ms": int((a > MS_LONG_MS).sum()),
            "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)), "max_ms": float(a.max()),
            "sum_ms": float(a.sum())}


def check_mandelbrot_samples(tap: OperandTap, cap: int) -> dict:
    """Every sampled ``mandelbrot`` launch of the main path, again through
    the kernel and through its plain version on the card: bit-equal.

    The plain dwell syncs with the host once per iteration and stops when
    every point has escaped, so it cannot run an in-set point's 5,000,000
    iterations.  A sample whose points all escape within ``cap``
    iterations is compared at the main path's own ``max_iter``; any other
    (it reaches the set, or escapes late) is compared at ``max_iter`` =
    ``cap``, and at its own ``max_iter`` with the full-iteration build,
    bit for bit, which checks the cycle exit where the plain version
    cannot go.  The kernel runs each sample at its own shape; the plain
    version, elementwise, runs one row of every sample of a class.
    """
    import torch
    from repro_torch.kernels.mandelbrot.ops import (
        mandelbrot, mandelbrot_cuda_full_iteration)
    classes: dict = {}
    n_full, n_in_set = 0, 0
    for (shapes, static), kept in sorted(tap.samples.items()):
        max_iter = dict(static)["max_iter"]
        for (c_re, c_im), _ in kept:
            got = mandelbrot(c_re, c_im, max_iter, backend="cuda")
            top = int(got.max())
            n_in_set += top == max_iter
            it = max_iter if max_iter <= cap or top < cap else cap
            if it != max_iter:
                full = mandelbrot_cuda_full_iteration(c_re, c_im,
                                                      max_iter=max_iter)
                if not torch.equal(got, full):
                    raise AssertionError(
                        f"mandelbrot at main-path shape {shapes}, max_iter "
                        f"{max_iter}: kernel differs from its full-iteration "
                        f"build on {int((got != full).sum())} points")
                got = mandelbrot(c_re, c_im, it, backend="cuda")
                n_full += 1
            cls = classes.setdefault(it, ([], [], [], []))
            for lst, t in zip(cls, (c_re, c_im, got)):
                lst.append(t.reshape(-1))
            cls[3].append(shapes[0])
    out = {}
    for it, (res, ims, gots, shapes) in sorted(classes.items()):
        got = torch.cat(gots)
        want = mandelbrot(torch.cat(res)[None], torch.cat(ims)[None], it,
                          backend="ref")[0]
        diff = int((got != want).sum())
        if diff:
            raise AssertionError(
                f"mandelbrot at main-path shapes, max_iter {it}: kernel "
                f"differs from plain version on {diff} of {got.numel()} "
                f"points (max |d dwell| {int((got - want).abs().max())})")
        out[str(it)] = {"samples": len(shapes), "points": got.numel(),
                        "max_dwell_seen": int(got.max()),
                        "shapes": sorted({str(s) for s in shapes})}
        log(f"[ms] {len(shapes)} sampled main-path launches at max_iter "
            f"{it} ({got.numel()} points, shapes {out[str(it)]['shapes']}) "
            f"bit-equal to the plain version")
    if not n_in_set:
        raise AssertionError("no sampled main-path launch reaches the set")
    log(f"[ms] {n_full} sampled launches that reach max_iter {cap} also "
        f"bit-equal to the full-iteration build at their own max_iter")
    return out


def border_strip(rect: tuple, p, dev) -> tuple:
    """The operands the main path hands the kernel for ``rect``'s border:
    its border coordinates as ``evaluate_rect`` takes them, one [1, n]
    row, padded as dispatch pads it."""
    import torch
    from repro_torch.algorithms.mariani_silver import Rect, _border_coords
    from repro_torch.kernels.dispatch import bucket, get_kernel
    op = get_kernel("mandelbrot")
    planes = []
    for a, pad in zip(_border_coords(Rect(*rect), p), op.pad_values):
        plane = torch.full((bucket(1, op.bucket_floor),
                            bucket(a.size, op.bucket_floor)), pad,
                           dtype=torch.float32, device=dev)
        plane[0, :a.size] = torch.from_numpy(a)
        planes.append(plane)
    return tuple(planes)


def time_border_strips(dwells, p, rects: list, dev, cap: int,
                       clock_hz: float) -> dict:
    """Main-path border strips timed alone through the kernel and its
    full-iteration build, sampled by rectangle: of the rectangles the run
    evaluates (``mariani_silver_over``), a seeded choice of
    ``MS_TIMED_IN_SET`` whose border reaches the set and
    ``MS_TIMED_OTHER`` others, so that every run times the same strips.
    Each strip's dwells must equal the naive render's on its border, and
    the two builds' must agree; the in-set strips carry their bounds
    (``in_set_bounds``)."""
    import statistics as st

    import numpy as np
    import torch

    def border(x0, y0, x1, y1, _):
        sub = dwells[y0:y1, x0:x1]
        return np.concatenate([sub[0], sub[-1], sub[1:-1, 0],
                               sub[1:-1, -1]])

    reach = [border(*r).max() == p.max_dwell for r in rects]
    rng = np.random.default_rng(14)
    picked = {}
    for want, k in ((True, MS_TIMED_IN_SET), (False, MS_TIMED_OTHER)):
        pool = [r for r, hit in zip(rects, reach) if hit == want]
        picked[want] = [pool[i] for i in sorted(rng.choice(
            len(pool), min(k, len(pool)), replace=False))]
    timed = {"kernel": [], "full_iteration": []}
    in_set = {"kernel": [], "full_iteration": []}
    in_set_planes = []
    for hit, chosen in picked.items():
        for rect in chosen:
            c_re, c_im = border_strip(rect, p, dev)
            builds = mandelbrot_builds(c_re, c_im, p.max_dwell)
            got = {k: fn() for k, fn in builds.items()}
            want = torch.from_numpy(border(*rect)).to(dev)
            n = want.shape[0]
            if not (torch.equal(got["kernel"][0, :n], want) and
                    torch.equal(got["full_iteration"], got["kernel"])):
                raise AssertionError(f"mandelbrot, the border of {rect}: "
                                     f"dwells differ from the naive render "
                                     f"or between the builds")
            for name, fn in builds.items():
                t = cuda_time_ms(fn, reps=3, warmup=1)
                timed[name].append(t)
                if hit:
                    in_set[name].append(t)
            if hit:
                in_set_planes.append((c_re, c_im, got["kernel"]))
    if not in_set["kernel"]:
        raise AssertionError("no main-path border strip reaches the set")
    med = {k: st.median(v) for k, v in in_set.items()}
    bounds = in_set_bounds(in_set_planes, cap, clock_hz)
    med_bound = {k: st.median(v) for k, v in bounds.items()}
    out = {"launch_ms": {k: duration_stats(v) for k, v in timed.items()},
           "in_set": {"samples": len(in_set["kernel"]),
                      "rects": [list(map(int, r)) for r in picked[True]],
                      "median_ms": med, "speedup": med["full_iteration"] /
                      med["kernel"], "median_bound_ms": med_bound,
                      "kernel_ms": in_set["kernel"],
                      "full_iteration_ms": in_set["full_iteration"],
                      "bound_ms": bounds}}
    for k, v in out["launch_ms"].items():
        log(f"[ms] {len(timed[k])} main-path border strips sampled by "
            f"rectangle, each alone, {k}: {v}")
    log(f"[ms] {len(in_set['kernel'])} in-set border strips: median "
        f"kernel {med['kernel']:.4f} ms, full iteration "
        f"{med['full_iteration']:.4f} ms ({out['in_set']['speedup']:.1f}x); "
        f"median bound {med_bound['kernel']:.5f} ms (cycle exit, to "
        f"{cap}), {med_bound['full_iteration']:.5f} ms (dwell sum); median "
        f"latency bound {med_bound['kernel_latency']:.5f} ms (the slowest "
        f"orbit's iterations under the cycle exit, to {cap}), "
        f"{med_bound['full_iteration_latency']:.5f} ms (its dwell)")
    return out


def in_set_bounds(planes: list, cap: int, clock_hz: float) -> dict:
    """The bounds of each in-set sample (its padded plane and its dwells
    at the main path's max_iter) for both builds.  The throughput bound:
    12 bytes a point against 8 operations an iteration, counting for the
    full iteration every dwell, and for the kernel what a plain run of its
    schedule to ``cap`` needs (points still running at ``cap`` counted at
    ``cap``, so this bound is lower still than the kernel's work).  The
    latency bound (``*_latency``): the iterations of the sample's slowest
    point, counted the same way, times ``MS_CHAIN_CYCLES`` at the card's
    top SM clock."""
    import torch
    from repro_torch.kernels.mandelbrot.ops import cycle_check_every
    res = torch.cat([p[0].reshape(-1) for p in planes])[None]
    ims = torch.cat([p[1].reshape(-1) for p in planes])[None]
    _, iters = cycle_exit_run(res, ims, cap, cycle_check_every())
    out = {"kernel": [], "full_iteration": [], "kernel_latency": [],
           "full_iteration_latency": []}
    off = 0
    for _, _, dwell in planes:
        n = dwell.numel()
        mine = iters[0, off:off + n]
        out["kernel"].append(bound_ms(n * MS_BYTES_PER_POINT, int(
            mine.sum()) * MS_OPS_PER_ITER)[0])
        out["full_iteration"].append(bound_ms(n * MS_BYTES_PER_POINT, int(
            dwell.to(torch.int64).sum()) * MS_OPS_PER_ITER)[0])
        for k, it in (("kernel_latency", mine), ("full_iteration_latency",
                                                 dwell)):
            out[k].append(int(it.max()) * MS_CHAIN_CYCLES / clock_hz * 1e3)
        off += n
    return out


def device_timeline(fn, kernel: str = "dwell_") -> tuple:
    """Run ``fn`` once under ``torch.profiler`` (device activity only, so
    the host's own pace is disturbed least) and read the device's
    timeline: its idle share of the wall time (the union of every kernel,
    copy and fill, so that work on concurrent streams counts once), the
    durations of every launch of the kernel whose name holds ``kernel``
    (``mandelbrot``'s by default), and the share of the wall time during
    which at least one launch longer than ``MS_LONG_MS`` ran; and the
    durations by kernel name.  Returns ``(fn's result, the record)``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def union_us(spans) -> float:
        total, end = 0.0, float("-inf")
        for a, b in sorted(spans):
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    # the profiler's raw device records: building its per-event objects
    # and their tree would take about a minute for one run's ~10^5 records
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    spans = [(e.start_ns() / 1e3, e.end_ns() / 1e3) for e in events]
    dwell = [s for s, e in zip(spans, events) if kernel in e.name()]
    long = [(a, b) for a, b in dwell if b - a > MS_LONG_MS * 1e3]
    by_name: dict = {}
    for (a, b), e in zip(spans, events):
        m = re.search(rf"\w*{re.escape(kernel)}\w*", e.name())
        if m:
            by_name.setdefault(m.group(0), []).append((b - a) / 1e3)
    wall_us = wall * 1e6
    rec = {"wall_s": wall, "device_ops": len(spans),
           "busy_s": union_us(spans) / 1e6,
           "idle_share": 1 - union_us(spans) / wall_us,
           "launches": duration_stats([(b - a) / 1e3 for a, b in dwell]),
           "by_name": {k: duration_stats(v) for k, v in by_name.items()},
           "long_launch_union_s": union_us(long) / 1e6,
           "long_launch_share": union_us(long) / wall_us}
    if not dwell:
        raise AssertionError(f"the profiler saw no {kernel} launch")
    return out, rec


def phase_uts(dev, depth: int) -> dict:
    from repro_torch.algorithms import UTSParams, uts_sequential, uts_spec
    from repro_torch.core import run_irregular
    from repro_torch.kernels import launches
    from repro_torch.kernels.uts_hash.ops import (expand_generations,
                                                  reset_expand_generations)

    for d, want in UTS_SIZES.items():
        got = uts_sequential(UTSParams(seed=19, b0=4.0, max_depth=d),
                             device=dev)
        if got != want:
            raise AssertionError(f"UTS depth {d}: {got} nodes, want {want}")
    log(f"[uts] depths 4..10 equal the published sizes "
        f"{list(UTS_SIZES.values())}")

    params = UTSParams(seed=19, b0=4.0, max_depth=depth)

    def elastic(batching: bool):
        def go():
            with elastic_pool() as pool:
                r = run_irregular(pool, uts_spec(params, device=dev),
                                  batching=batching)
            return r.output, r.tasks
        return go

    paths = {"sequential": lambda: (uts_sequential(params, device=dev), 1),
             "elastic batching=False": elastic(False),
             "elastic batching=True": elastic(True)}
    runs = {}
    with OperandTap("uts_expand", k=UTS_SAMPLES_PER_KEY,
                    key=uts_tap_key) as tap:
        for name, fn in paths.items():
            calls0 = sum(tap.seen.values())
            reset_expand_generations()
            (count, tasks), wall, n = run_path(f"UTS {name}", "uts_expand",
                                               fn)
            n_hash = launches("uts_hash")
            calls = sum(tap.seen.values()) - calls0
            gens = expand_generations()
            runs[name] = {"nodes": count, "seconds": wall, "tasks": tasks,
                          "nodes_per_s": count / wall, "launches": n,
                          "calls": calls, "relaunches": n - calls,
                          "generations": gens,
                          "uts_hash_launches": n_hash}
            log(f"[uts] depth {depth} {name}: {count} nodes, {tasks} tasks, "
                f"{wall:.3f} s, {count / wall:.1f} nodes/s; {calls} "
                f"uts_expand calls, {n} launches ({n - calls} relaunches), "
                f"{gens} generations ({wall * 1e6 / gens:.3f} us of wall "
                f"time a generation); {n_hash} uts_hash launches")
            if n_hash < 1:
                raise AssertionError(f"UTS {name}: uts_hash not launched")
            if calls > tasks:
                raise AssertionError(f"UTS {name}: {calls} uts_expand calls "
                                     f"for {tasks} tasks")
    if runs["sequential"]["launches"] > 5:
        raise AssertionError(f"UTS sequential: "
                             f"{runs['sequential']['launches']} uts_expand "
                             f"launches, want at most 5")
    counts = {r["nodes"] for r in runs.values()}
    if len(counts) != 1:
        raise AssertionError(f"UTS depth {depth}: counts disagree {runs}")
    samples = check_uts_samples(tap)
    # where the time of an elastic run goes: the same path (batching off)
    # at UTS_PROFILE_DEPTH, under the profiler, outside the counted runs
    params = UTSParams(seed=19, b0=4.0, max_depth=UTS_PROFILE_DEPTH)
    (count, tasks), prof = device_timeline(elastic(False), "uts_expand")
    if count != UTS_DEEP_NODES[UTS_PROFILE_DEPTH]:
        raise AssertionError(f"UTS profiled run: {count} nodes")
    log(f"[uts] profiled elastic run (depth {UTS_PROFILE_DEPTH}, batching "
        f"off): {prof['wall_s']:.3f} s "
        f"wall, {tasks} tasks, {prof['device_ops']} device operations, busy "
        f"{prof['busy_s']:.3f} s, idle share {prof['idle_share']:.4f}; "
        f"uts_expand launches {prof['launches']}")
    return {"launches": {k: r["launches"] for k, r in runs.items()},
            "uts_hash_launches": {k: r["uts_hash_launches"]
                                  for k, r in runs.items()},
            "nodes": counts.pop(), "runs": runs, "samples": samples,
            "profile": prof}


def mariani_silver_over(dwells, p):
    """Mariani-Silver applied to a finished dwell map, on the host.

    An independent statement of the algorithm's semantics: the same seed
    grid, border test (top row, bottom row, left and right columns), fill,
    split and leaf rule as ``ms_spec``, with every dwell read from
    ``dwells`` (the naive render) instead of computed.  ``ms_spec`` driven
    by ``run_irregular`` must reproduce it pixel for pixel.  Where a dwell
    band is thinner than a pixel, a rectangle's border can miss it and the
    fill paints over it, so this image may differ from ``dwells``; those
    pixels are the algorithm's, not an error of the port.  Returns the
    image and the rectangles evaluated, ``(x0, y0, x1, y1, depth)`` (one
    a task).
    """
    import numpy as np

    out = np.zeros_like(dwells)
    sd = p.initial_subdivision
    xs = np.linspace(0, p.width, sd + 1).astype(int)
    ys = np.linspace(0, p.height, sd + 1).astype(int)
    todo = [(xs[j], ys[i], xs[j + 1], ys[i + 1], 0)
            for i in range(sd) for j in range(sd)]
    rects = []
    while todo:
        rects.extend(todo)
        nxt = []
        for x0, y0, x1, y1, depth in todo:
            sub = dwells[y0:y1, x0:x1]
            border = np.concatenate([sub[0], sub[-1], sub[1:-1, 0],
                                     sub[1:-1, -1]])
            if border.size and np.all(border == border[0]):
                out[y0:y1, x0:x1] = border[0]
            elif depth >= p.max_depth or x1 - x0 <= 2 or y1 - y0 <= 2:
                out[y0:y1, x0:x1] = sub
            else:
                cx = np.linspace(x0, x1, p.split + 1).astype(int)
                cy = np.linspace(y0, y1, p.split + 1).astype(int)
                nxt.extend((cx[j], cy[i], cx[j + 1], cy[i + 1], depth + 1)
                           for i in range(p.split) for j in range(p.split)
                           if cx[j + 1] > cx[j] and cy[i + 1] > cy[i])
        todo = nxt
    return out, rects


def ms_params(side: int, max_dwell: int):
    """The paper's ``MS_PAPER_SD64`` cut to ``side`` x ``side`` pixels with
    the same 64-pixel seed rectangles (sd = side / 64), depth 5, split 2."""
    import dataclasses

    from repro_torch.configs.paper_workloads import MS_PAPER_SD64

    if side % 64:
        raise ValueError(f"--ms-side must be a multiple of 64, got {side}")
    return dataclasses.replace(MS_PAPER_SD64, width=side, height=side,
                               initial_subdivision=side // 64,
                               max_dwell=max_dwell)


def phase_ms(dev, side: int, max_dwell: int, clock_hz: float) -> dict:
    import numpy as np
    import torch
    from repro_torch.algorithms import ms_spec, naive_render
    from repro_torch.core import run_irregular

    p = ms_params(side, max_dwell)

    def elastic(batching: bool, params=p):
        def go():
            with elastic_pool() as pool:
                return run_irregular(pool, ms_spec(params, device=dev),
                                     batching=batching)
        return go

    runs, images = {}, {}
    p_batch = ms_params(MS_BATCHING_SIDE, max_dwell)
    with OperandTap("mandelbrot", k=MS_SAMPLES_PER_SHAPE) as tap:
        for batching, pb in ((False, p), (True, p_batch)):
            name = f"elastic batching={batching}"
            r, wall, n = run_path(f"MS {name}", "mandelbrot",
                                  elastic(batching, pb))
            images[name] = (pb, r.output["image"])
            runs[name] = {"seconds": wall, "tasks": r.tasks,
                          "side": pb.width,
                          "mp_per_s": pb.width * pb.height / wall / 1e6,
                          "filled": int(r.output["filled"]),
                          "evaluated": int(r.output["evaluated"]),
                          "launches": n}
            log(f"[ms] {pb.width}x{pb.height} sd {pb.initial_subdivision} "
                f"depth {pb.max_depth} max_dwell {max_dwell} {name}: "
                f"{r.tasks} tasks, {wall:.3f} s, "
                f"{runs[name]['mp_per_s']:.4f} MP/s, filled "
                f"{r.output['filled']}, evaluated {r.output['evaluated']}, "
                f"{n} mandelbrot launches")
    samples = check_mandelbrot_samples(tap, MS_SAMPLE_CAP)
    # where the time of one run goes: the same path (batching off) at
    # MS_PROFILE_SIDE, under the profiler, outside the counted runs above
    p_prof = ms_params(MS_PROFILE_SIDE, max_dwell)
    r, prof = device_timeline(elastic(False, p_prof))
    prof_image = r.output["image"]
    log(f"[ms] profiled run ({MS_PROFILE_SIDE}^2, batching off): "
        f"{prof['wall_s']:.3f} s wall, "
        f"{prof['device_ops']} device operations, busy {prof['busy_s']:.3f} "
        f"s, idle share {prof['idle_share']:.4f}; mandelbrot launches "
        f"{prof['launches']}; launches over {MS_LONG_MS} ms run during "
        f"{prof['long_launch_union_s']:.3f} s ({prof['long_launch_share']:.4f}"
        f" of the wall time)")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    oracle = naive_render(p, device=dev)
    naive_s = time.monotonic() - t0
    expected, rects = mariani_silver_over(oracle, p)
    tasks = len(rects)
    sampled = int((expected != oracle).sum())
    log(f"[ms] naive_render: {naive_s:.3f} s, "
        f"{int(oracle.astype(np.int64).sum())} iterations; Mariani-Silver "
        f"over it: {tasks} tasks, {sampled} pixels filled with another "
        f"dwell than theirs")
    small = {MS_PROFILE_SIDE: p_prof, MS_BATCHING_SIDE: p_batch}
    want = {side: mariani_silver_over(naive_render(q, device=dev), q)[0]
            for side, q in small.items()}
    want[p.width] = expected
    for name, (pb, img) in [*images.items(),
                            ("profiled", (p_prof, prof_image))]:
        exp = want[pb.width]
        if img.shape != exp.shape or not np.array_equal(img, exp):
            raise AssertionError(
                f"MS {name} {pb.width}^2: image differs from Mariani-Silver "
                f"over naive_render on {int((img != exp).sum())} pixels")
    log(f"[ms] every image equals Mariani-Silver over naive_render at its "
        f"side ({p.width}^2: naive_render itself on all but those {sampled} "
        f"pixels; batching on at {MS_BATCHING_SIDE}^2, profiled at "
        f"{MS_PROFILE_SIDE}^2)")
    samples.update(time_border_strips(oracle, p, rects, dev, MS_SAMPLE_CAP,
                                      clock_hz))
    return {"launches": {k: r["launches"] for k, r in runs.items()},
            "side": side, "max_dwell": max_dwell,
            "naive_render_s": naive_s, "pixels_off_naive": sampled,
            "reference_tasks": tasks, "runs": runs, "samples": samples,
            "profile": prof}


def phase_ms_paper_size(dev) -> dict:
    """What the paper's full ``MS_PAPER_SD64`` run would be: its dwell map
    by ``naive_render`` on the card, and the tasks Mariani-Silver over it
    dispatches, which is why phase 5 runs a smaller image.  Then the same
    plane's coordinates through every build of the kernel once (CUDA
    events; the full iteration takes seconds), each dwell map bit-equal
    to the render's."""
    import numpy as np
    import torch
    from repro_torch.algorithms import naive_render
    from repro_torch.algorithms.mariani_silver import Rect, _pixel_coords
    from repro_torch.configs.paper_workloads import MS_PAPER_SD64

    p = MS_PAPER_SD64
    torch.cuda.synchronize()
    t0 = time.monotonic()
    dwells = naive_render(p, device=dev)
    naive_s = time.monotonic() - t0
    image, rects = mariani_silver_over(dwells, p)
    tasks = len(rects)
    sampled = int((image != dwells).sum())
    log(f"[ms] paper size {p.width}x{p.height} sd {p.initial_subdivision} "
        f"max_dwell {p.max_dwell}: naive_render {naive_s:.3f} s, "
        f"{int(dwells.astype(np.int64).sum())} iterations; Mariani-Silver "
        f"over it: {tasks} tasks, {sampled} pixels filled with another "
        f"dwell than theirs")
    c_re, c_im = (torch.from_numpy(a).to(dev) for a in _pixel_coords(
        Rect(0, 0, p.width, p.height, 0), p))
    want = torch.from_numpy(dwells).to(dev)
    builds_ms = {}
    for name, fn in mandelbrot_builds(c_re, c_im, p.max_dwell).items():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = fn()
        end.record()
        end.synchronize()
        builds_ms[name] = start.elapsed_time(end)
        if not torch.equal(got, want):
            raise AssertionError(
                f"mandelbrot {name} at paper size differs from naive_render "
                f"on {int((got != want).sum())} points")
    log(f"[ms] paper size, kernel alone: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in builds_ms.items()))
    return {"naive_render_s": naive_s, "tasks": tasks,
            "pixels_off_naive": sampled, "builds_ms": builds_ms}


# -- betweenness centrality at the paper's scale 17 ------------------------------

#: fixed shapes of the level kernels: (R-MAT scale, sources); the first is
#: a task of BC_SCALED (its graph, 8 sources: S' = 32, one word a vertex),
#: the last a main-path task's (the paper graph, one 1,024-source block)
BC_FIXED = ((8, 8), (12, 256), (17, 64), (17, 1024))
#: sources of the paper graph held against the host's Brandes, in workers
BC_ORACLE_SOURCES = 8
BC_ORACLE_WORKERS = 4
#: main-path tasks replayed through the plain version
BC_REPLAY_TASKS = 3
#: the elastic run under the profiler runs the first this many of the
#: main path's blocks (32 since the mesh phase, some 40 s less; 8 since
#: the dry-run phase, some 11 s less), its map held bit for bit to the
#: timed run's partials of the same blocks
BC_PROFILE_TASKS = 8
#: threads of the local pool of the fused run: it fuses up to this many
#: queued blocks into one ``execute_batch`` call (``run_irregular``)
BC_LOCAL_WIDTH = 4
#: the reference package's tolerances (tests/test_betweenness.py)
BC_RTOL, BC_ATOL = 1e-4, 1e-3
#: spin (GPU clock cycles, about 0.5 ms) queued before each timed level,
#: so that its start event waits on the card and not on the host's
#: launch path
BC_SPIN_CYCLES = 1_000_000


def rmat_edges(scale: int, edge_factor: int, a: float, b: float, c: float,
               seed: int) -> tuple:
    """The R-MAT digraph's edge set, sampled on the host with the
    reference's draws in the reference's order, independently of the
    port: ``(n, keys)``, keys the sorted distinct ``src * n + dst``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    n = 1 << scale
    m = edge_factor * n
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for _ in range(scale):
        r = rng.rand(m)
        q_b = (r >= a) & (r < a + b)
        q_c = (r >= a + b) & (r < a + b + c)
        q_d = r >= a + b + c
        src = 2 * src + (q_c | q_d)
        dst = 2 * dst + (q_b | q_d)
    keep = src != dst
    perm = rng.permutation(n)
    return n, np.unique(perm[src[keep]] * n + perm[dst[keep]])


def brandes_host(n: int, indptr: list, indices: list, s: int) -> list:
    """Brandes' dependencies of source ``s`` on every vertex, queue-based,
    in float64 (0 at ``s`` itself), over Python lists of a CSR."""
    from collections import deque
    sigma = [0.0] * n
    dist = [-1] * n
    sigma[s], dist[s] = 1.0, 0
    order, queue = [], deque([s])
    while queue:
        v = queue.popleft()
        order.append(v)
        dv, sv = dist[v] + 1, sigma[v]
        for w in indices[indptr[v]:indptr[v + 1]]:
            if dist[w] < 0:
                dist[w] = dv
                queue.append(w)
            if dist[w] == dv:
                sigma[w] += sv
    delta = [0.0] * n
    for v in reversed(order):
        dv, acc = dist[v] + 1, 0.0
        for w in indices[indptr[v]:indptr[v + 1]]:
            if dist[w] == dv:
                acc += (1.0 + delta[w]) / sigma[w]
        delta[v] = sigma[v] * acc
    delta[s] = 0.0
    return delta


def bc_oracle(rmat: tuple, sources: list) -> dict:
    """Runs in a worker process, with nothing of the port: the graph from
    ``rmat_edges``, Brandes from each source (``brandes_host``), and
    scipy's BFS distances.  Returns the summed dependencies, and per
    source the dependency sum beside the distance identity's side,
    sum over reached t != s of (d(s, t) - 1); and a digest of the edge
    set."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path
    n, keys = rmat_edges(*rmat)
    src, dst = keys // n, keys % n
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    ip, ix = indptr.tolist(), dst.tolist()
    adj = csr_matrix((np.ones(keys.size), (src, dst)), shape=(n, n))
    dists = shortest_path(adj, directed=True, unweighted=True,
                          indices=sources)
    total = np.zeros(n)
    per = []
    for s, d in zip(sources, dists):
        delta = np.asarray(brandes_host(n, ip, ix, s))
        total += delta
        reached = np.isfinite(d)
        reached[s] = False
        per.append({"source": s, "oracle_delta_sum": float(delta.sum()),
                    "distance_identity": float((d[reached] - 1).sum()),
                    "reached": int(reached.sum()),
                    "depth": int(d[np.isfinite(d)].max())})
    return {"delta": total, "per_source": per,
            "edges_sha1": hashlib.sha1(keys.tobytes()).hexdigest()}


class BCTwinLevels:
    """Level steps for ``bc_batch(steps=...)``: each level runs through
    the kernel and, on a twin state, through the plain version, the whole
    state held bit for bit: ``sigma``, ``visited`` and the next level's
    ``on``, ``base`` and live words forward; ``delta`` and ``coeff``
    backward (``delta`` of the level below poisoned before both launches:
    it is written, not read).  Per level it records what the bound needs: the
    pairs the level must read and write (frontier and joined forward; on
    the level and a level below backward), the additions its sums make
    (every edge of a frontier pair forward, of a level pair backward: an
    upper count), and ``torch.sparse.mm`` of the CSR adjacency with the
    level's masked operand (the library yardstick of the product alone:
    the port never calls it)."""

    def __init__(self, g):
        import torch

        def adjacency(indptr, indices):
            return torch.sparse_csr_tensor(
                indptr.long(), indices.long(),
                torch.ones(g.n_edges, device=indptr.device), size=(g.n, g.n),
                check_invariants=False)
        self.a_in = adjacency(g.in_indptr, g.in_indices)
        self.a_out = adjacency(g.out_indptr, g.out_indices)
        self.out_deg = (g.out_indptr[1:] - g.out_indptr[:-1]).double()
        self.in_deg = (g.in_indptr[1:] - g.in_indptr[:-1]).double()
        self.fwd, self.bwd = [], []

    @staticmethod
    def _hold(what: str, level: int, names: tuple, got: tuple,
              want: tuple) -> None:
        import torch
        torch.cuda.synchronize()
        diff = {k: int((a != b).sum()) for k, a, b in zip(names, got, want)}
        if any(diff.values()):
            raise AssertionError(
                f"{what} {level} ({got[0].shape[0]} vertices): kernel "
                f"differs from the plain version on " + ", ".join(
                    f"{v} {k}" for k, v in diff.items() if v))

    def forward(self, indptr, indices, sigma, visited, on, base, live, level,
                *, backend=None):
        import torch
        from repro_torch.kernels.bc.ops import (bc_forward_level,
                                                level_values, unpack_bits)
        if level == 0:
            self.twin = [t.clone() for t in (sigma, visited)]
            self.on, self.base, self.back = [on.clone()], [base.clone()], None
        front = unpack_bits(on, sigma.shape[1])
        x = level_values(sigma, front, base)
        rec = {"level": level, "frontier": int(front.sum()),
               "ops": float(front.sum(dim=1).double() @ self.out_deg),
               "library_ms": cuda_time_ms(lambda: torch.sparse.mm(self.a_in,
                                                                   x))}
        del front, x
        got = bc_forward_level(indptr, indices, sigma, visited, on, base,
                               live, level, backend="cuda")
        want = bc_forward_level(indptr, indices, *self.twin, self.on[level],
                                self.base[level], live, level, backend="ref")
        self._hold("bc_forward_level", level,
                   ("on", "base", "live", "sigma", "visited"),
                   (*got, sigma, visited), (*want, *self.twin))
        self.on.append(want[0])
        self.base.append(want[1])
        rec.update(joined=int(unpack_bits(got[0], sigma.shape[1]).sum()),
                   live_sources=int(unpack_bits(got[2], sigma.shape[1])
                                    .sum()))
        self.fwd.append(rec)
        return got

    def backward(self, indptr, indices, sigma, delta, coeff, on, on_below,
                 base, base_below, level, *, backend=None):
        import torch
        from repro_torch.kernels.bc.ops import (bc_backward_level,
                                                level_values, unpack_bits)
        if self.back is None:
            self.back = [delta.clone(), coeff.clone()]
        here = unpack_bits(on, sigma.shape[1])
        sig = level_values(sigma, here, base)
        c = torch.where(here, (1.0 + delta) /
                        torch.where(sig > 0, sig, 1.0), 0.0)
        n_on = here.sum(dim=1).double()
        rec = {"level": level, "on_level": int(n_on.sum()),
               "updated": int(unpack_bits(on_below, sigma.shape[1]).sum()),
               "ops": float(n_on @ self.in_deg + 2 * n_on.sum()),
               "library_ms": cuda_time_ms(lambda: torch.sparse.mm(self.a_out,
                                                                   c))}
        del here, sig, c
        below = unpack_bits(on_below, sigma.shape[1])
        delta[below] = 7.0
        self.back[0][below] = 7.0
        del below
        bc_backward_level(indptr, indices, sigma, delta, coeff, on, on_below,
                          base, base_below, level, backend="cuda")
        bc_backward_level(indptr, indices, sigma, *self.back, self.on[level],
                          self.on[level - 1], self.base[level],
                          self.base[level - 1], level, backend="ref")
        self._hold("bc_backward_level", level, ("delta", "coeff"),
                   (delta, coeff), tuple(self.back))
        self.bwd.append(rec)
        return delta


class BCTimedLevels:
    """Level steps for ``bc_batch(steps=...)`` that run each level as
    asked, behind a spin and between two CUDA events, so that its start
    waits on the card and not on the host's launch path."""

    def __init__(self):
        self.fwd, self.bwd = [], []

    @staticmethod
    def _timed(spans: list, step, *args, **kw):
        import torch
        torch.cuda._sleep(BC_SPIN_CYCLES)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = step(*args, **kw)
        b.record()
        spans.append((a, b))
        return out

    def forward(self, *args, **kw):
        from repro_torch.kernels.bc.ops import bc_forward_level
        return self._timed(self.fwd, bc_forward_level, *args, **kw)

    def backward(self, *args, **kw):
        from repro_torch.kernels.bc.ops import bc_backward_level
        return self._timed(self.bwd, bc_backward_level, *args, **kw)

    def ms(self) -> tuple:
        import torch
        torch.cuda.synchronize()
        return tuple([a.elapsed_time(b) for a, b in spans]
                     for spans in (self.fwd, self.bwd))


def bc_sweep_times(g, src, backend: str, reps: int) -> tuple:
    """Per-level CUDA-event medians of ``reps`` sweeps of ``bc_batch``
    through ``backend`` (forward levels, then backward levels in the
    order they run)."""
    from repro_torch.algorithms import bc_batch
    fwd, bwd = [], []
    for _ in range(reps):
        t = BCTimedLevels()
        bc_batch(g, src, backend=backend, steps=(t.forward, t.backward))
        f, b = t.ms()
        fwd.append(f)
        bwd.append(b)
    return ([statistics.median(c) for c in zip(*fwd)],
            [statistics.median(c) for c in zip(*bwd)])


def bc_level_bounds(n: int, s_pad: int, csr_bytes: int,
                    twin: BCTwinLevels) -> None:
    """Adds each level's bound to ``twin``'s records: its bytes at the
    memory rate against its operations at the float32 rate.  What any
    implementation must read to know which pairs are on duty is one bit a
    pair: forward, the bits of visited, of the level's frontier and of
    the next one (3 N S' / 8 bytes), sigma of each frontier pair, sigma
    written for each pair that joins; backward, the bits of the level and
    the level below (2 N S' / 8), coeff of each pair on the level, sigma
    read and delta and coeff written for each pair a level below (its
    delta is 0 before, so no implementation need read it); 4 bytes a
    value, and the CSR.  ``bound_dist_ms``
    beside it is the bound of the design before the masks, which read
    dist (4 bytes a pair) to find the pairs on duty (forward: dist of
    every pair, sigma of the frontier, dist and sigma of the joined;
    backward: dist of every pair, sigma and delta of the level, sigma
    and delta read and delta written a level below)."""
    bits = n * s_pad / 8
    for rec in twin.fwd:
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            3 * bits + 4 * (rec["frontier"] + rec["joined"]) + csr_bytes,
            rec["ops"])
        rec["bound_dist_ms"] = bound_ms(
            4 * (n * s_pad + rec["frontier"] + 2 * rec["joined"]) +
            csr_bytes, rec["ops"])[0]
    for rec in twin.bwd:
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            2 * bits + 4 * (rec["on_level"] + 3 * rec["updated"]) +
            csr_bytes, rec["ops"])
        rec["bound_dist_ms"] = bound_ms(
            4 * (n * s_pad + 2 * rec["on_level"] + 3 * rec["updated"]) +
            csr_bytes, rec["ops"])[0]


def bc_fixed_case(g, src, label: str) -> dict:
    """The two level kernels on one sweep of ``bc_batch``: bit-equal to
    the plain versions at every level; per level and per sweep (a
    task's), kernel and plain times, bound and library time."""
    from repro_torch.algorithms import bc_batch
    from repro_torch.kernels.dispatch import bucket
    twin = BCTwinLevels(g)
    bc_batch(g, src, steps=(twin.forward, twin.backward))
    bc_level_bounds(g.n, bucket(src.shape[0], 32),
                    (g.n + 1 + g.n_edges) * 4, twin)
    kf, kb = bc_sweep_times(g, src, "cuda", reps=10)
    pf, pb = bc_sweep_times(g, src, "ref", reps=3)
    for recs, k, p in ((twin.fwd, kf, pf), (twin.bwd, kb, pb)):
        for rec, km, pm in zip(recs, k, p):
            rec.update(ms=km, plain_ms=pm)
    out = {"label": label, "vertices": g.n, "edges": g.n_edges,
           "sources": int(src.shape[0]), "levels": len(twin.fwd),
           "forward": twin.fwd, "backward": twin.bwd}
    for name, recs in (("bc_forward_level", twin.fwd),
                       ("bc_backward_level", twin.bwd)):
        tot = {k: sum(r[k] for r in recs)
               for k in ("ms", "plain_ms", "bound_ms", "bound_dist_ms",
                         "library_ms")}
        tot["bound_by"] = "bytes" if all(r["bound_by"] == "bytes"
                                         for r in recs) else "operations"
        tot["levels"] = len(recs)
        tot["ms_per_level"] = tot["ms"] / len(recs)
        tot["levels_under_library"] = sum(r["ms"] < r["library_ms"]
                                          for r in recs)
        out[name] = tot
        log(f"[bc] {label}, {name}: {len(recs)} levels bit-equal to the "
            f"plain version; a sweep (a task's) kernel {tot['ms']:.4f} ms "
            f"({tot['ms_per_level']:.4f} ms a level), plain "
            f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
            f"({tot['bound_by']}; {tot['bound_dist_ms']:.4f} ms reading "
            f"dist), sparse.mm {tot['library_ms']:.4f} ms, kernel under "
            f"sparse.mm at {tot['levels_under_library']} of {len(recs)} "
            f"levels; per level kernel ms "
            + " ".join(f"{r['ms']:.4f}" for r in recs)
            + "; per level sparse.mm ms "
            + " ".join(f"{r['library_ms']:.4f}" for r in recs)
            + "; per level bound ms "
            + " ".join(f"{r['bound_ms']:.4f}" for r in recs))
    out["task_ms"] = out["bc_forward_level"]["ms"] + \
        out["bc_backward_level"]["ms"]
    return out


def bc_task_tap(spec, block_ids: set, kept: dict):
    """``spec`` with its task body wrapped: the (block, partial) of every
    task whose first source id is in ``block_ids`` is kept."""
    import dataclasses
    execute = spec.execute

    def tapped(block, shape):
        key, partial = execute(block, shape)
        if key in block_ids:
            kept[key] = (block.copy(), partial)
        return key, partial
    return dataclasses.replace(spec, execute=tapped)


def bc_fuse_tap(spec, sizes: list):
    """``spec`` with its fused task body wrapped: the number of blocks of
    every ``execute_batch`` call is appended to ``sizes``."""
    import dataclasses
    execute_batch = spec.execute_batch

    def tapped(blocks, shape):
        sizes.append(len(blocks))
        return execute_batch(blocks, shape)
    return dataclasses.replace(spec, execute_batch=tapped)


def phase_bc(dev) -> dict:
    """Betweenness centrality at the paper's scale 17: the port's
    ``bc_batch`` held against an independent host Brandes and the
    distance identity on sampled sources of the paper graph; the level
    kernels at fixed shapes, timed once the oracle's workers have ended;
    ``bc_spec(BC_PAPER, n_tasks=128, regenerate_graph=True)`` through
    ``run_irregular`` on the elastic pool (the timed run), on a local
    pool that fuses queued blocks into ``execute_batch`` calls, and its
    first ``BC_PROFILE_TASKS`` blocks on the elastic pool under the
    profiler (their map bit-equal to the timed run's partials of them);
    sampled tasks of the first run replayed through the plain versions."""
    import dataclasses
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch
    from repro_torch.algorithms import (RMATParams, bc_batch, bc_spec,
                                        rmat_graph)
    from repro_torch.configs.paper_workloads import (BC_PAPER, BC_PAPER_TASKS,
                                                     BC_SCALED)
    from repro_torch.core import make_pool, run_irregular
    from repro_torch.kernels import launches

    p = BC_PAPER
    t0 = time.monotonic()
    host = rmat_graph(p)
    regen_s = time.monotonic() - t0
    n = host.n
    out_deg = np.diff(host.out_indptr)
    log(f"[bc] paper graph (scale {p.scale}, edge factor {p.edge_factor}, "
        f"seed {p.seed}): {n} vertices, {host.n_edges} edges, largest "
        f"out/in degree {out_deg.max()}/{np.diff(host.in_indptr).max()}; "
        f"rmat_graph {regen_s:.3f} s on the host")
    rng = np.random.default_rng(16)
    oracle_src = sorted(int(v) for v in rng.choice(
        np.flatnonzero(out_deg > 0), BC_ORACLE_SOURCES, replace=False))
    rmat = (p.scale, p.edge_factor, p.a, p.b, p.c, p.seed)
    jobs = [oracle_src[i::BC_ORACLE_WORKERS]
            for i in range(BC_ORACLE_WORKERS)]
    pool = ProcessPoolExecutor(BC_ORACLE_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        futures = [pool.submit(bc_oracle, rmat, job) for job in jobs]
        # the port's side of the gates, untimed, while the oracle runs
        g17 = host.to(dev)
        got = bc_batch(g17, torch.tensor(oracle_src, device=dev)).cpu().numpy()
        port_sums = {s: float(bc_batch(g17, torch.tensor([s], device=dev))
                              .cpu().numpy().astype(np.float64).sum())
                     for s in oracle_src}
        oracle = [f.result() for f in futures]
    finally:
        pool.shutdown(cancel_futures=True)
        stop_resource_tracker()
    oracle_s = time.monotonic() - t0

    # -- the gates that do not trust the port --------------------------------
    keys = (np.repeat(np.arange(n, dtype=np.int64), out_deg) * n +
            host.out_indices)
    if any(o["edges_sha1"] != hashlib.sha1(keys.tobytes()).hexdigest()
           for o in oracle):
        raise AssertionError("rmat_graph's edge set differs from the host's "
                             "own R-MAT sampling")
    want = sum(o["delta"] for o in oracle)
    err = np.abs(got.astype(np.float64) - want)
    if not np.allclose(got, want, rtol=BC_RTOL, atol=BC_ATOL):
        raise AssertionError(
            f"BC of {BC_ORACLE_SOURCES} sources differs from the host's "
            f"Brandes on {int((err > BC_ATOL + BC_RTOL * np.abs(want)).sum())}"
            f" vertices (max |d| {err.max():.3e})")
    per = sorted((r for o in oracle for r in o["per_source"]),
                 key=lambda r: r["source"])
    for r in per:
        r["port_delta_sum"] = port_sums[r["source"]]
        for side in ("port_delta_sum", "oracle_delta_sum"):
            if not np.isclose(r[side], r["distance_identity"], rtol=BC_RTOL,
                              atol=BC_ATOL):
                raise AssertionError(f"source {r['source']}: {side} "
                                     f"{r[side]} != sum of (d - 1) "
                                     f"{r['distance_identity']}")
    log(f"[bc] {BC_ORACLE_SOURCES} sampled sources of the paper graph: "
        f"bc_batch on the card within rtol {BC_RTOL}, atol {BC_ATOL} of the "
        f"host's float64 Brandes (max |d| {err.max():.3e}, largest value "
        f"{want.max():.6e}); the sum of each source's dependencies equals "
        f"the sum of (d - 1) over the vertices it reaches ("
        + ", ".join(f"{r['source']}: {r['reached']} reached, depth "
                    f"{r['depth']}, {r['port_delta_sum']:.6e} / "
                    f"{r['distance_identity']:.6e}" for r in per)
        + f"); the edge set equals the host's own sampling; oracle "
        f"{oracle_s:.3f} s")

    # -- the kernels at fixed shapes, with no other process on the host ------
    fixed = []
    for scale, s in BC_FIXED:
        scaled = scale == BC_SCALED.scale
        g = g17 if scale == p.scale else rmat_graph(
            BC_SCALED if scaled else RMATParams(scale=scale, seed=p.seed)
        ).to(dev)
        # a task's block: its first, at the paper's and BC_SCALED's shapes
        src = torch.arange(s, device=dev) if s == 1024 or scaled else \
            torch.from_numpy(np.random.default_rng(scale).choice(
                g.n, s, replace=False)).to(dev)
        label = (f"scale {scale}, {s} sources"
                 + (" (main-path block 0)" if s == 1024 else
                    " (BC_SCALED block 0)" if scaled else ""))
        fixed.append(bc_fixed_case(g, src, label))
        torch.cuda.empty_cache()

    # -- the main path -------------------------------------------------------
    blocks = np.array_split(np.arange(n, dtype=np.int32), BC_PAPER_TASKS)
    picked = {int(blocks[i][0]) for i in np.random.default_rng(17).choice(
        BC_PAPER_TASKS, BC_REPLAY_TASKS, replace=False)}
    kept: dict = {}
    first = {int(b[0]) for b in blocks[:BC_PROFILE_TASKS]}
    first_kept: dict = {}
    fused: list = []

    def path(name: str):
        """``run_irregular`` of the paper's BC spec, as run ``name``: the
        elastic pool's tasks are tapped for the replay, the local pool's
        fused calls counted."""
        def go():
            spec = bc_spec(p, n_tasks=BC_PAPER_TASKS, regenerate_graph=True,
                           device=dev)
            if name == "local fused":
                with make_pool("local", max_concurrency=BC_LOCAL_WIDTH) as lp:
                    return run_irregular(lp, bc_fuse_tap(spec, fused),
                                         batching=True)
            if name == "elastic profiled":      # the first blocks only
                seed = spec.seed
                spec = dataclasses.replace(spec, seed=lambda shape: seed(
                    shape)[:BC_PROFILE_TASKS])
            else:
                spec = bc_task_tap(bc_task_tap(spec, picked, kept), first,
                                   first_kept)
            with elastic_pool() as ep:
                return run_irregular(ep, spec)
        if name == "elastic profiled":
            return lambda: device_timeline(go, "_level_kernel")
        return go

    runs, maps = {}, {}
    for name in ("elastic", "local fused", "elastic profiled"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r, wall, n_fwd = run_path(f"BC {name}", "bc_forward_level",
                                  path(name))
        n_bwd = launches("bc_backward_level")
        if n_bwd <= 0:
            raise AssertionError(f"BC {name}: bc_backward_level not launched")
        if name == "elastic profiled":
            r, prof = r
        out = r.output
        if out.shape != (n,) or not np.isfinite(out).all() or \
                (out < 0).any():
            raise AssertionError(f"BC {name}: map of shape {out.shape} not "
                                 f"finite and non-negative")
        maps[name] = out
        sources = n if name != "elastic profiled" else sum(
            len(b) for b in blocks[:BC_PROFILE_TASKS])
        runs[name] = {"seconds": wall, "tasks": r.tasks,
                      "sources_per_s": sources / wall,
                      "launches": {"bc_forward_level": n_fwd,
                                   "bc_backward_level": n_bwd},
                      "peak_memory_gb": torch.cuda.max_memory_allocated()
                      / 1e9}
        log(f"[bc] BC_PAPER, {r.tasks} tasks, regenerate_graph, "
            f"{name}: {r.tasks} tasks, {wall:.3f} s, {sources / wall:.1f} "
            f"sources/s, {n_fwd} forward and {n_bwd} backward level "
            f"launches, peak device memory "
            f"{runs[name]['peak_memory_gb']:.2f} GB; map sum {out.sum():.6e}, "
            f"max {out.max():.6e}")
    if max(fused, default=0) < 2:
        raise AssertionError(f"BC local fused: no execute_batch call fused "
                             f"two blocks ({fused})")
    runs["local fused"]["fused_calls"] = len(fused)
    runs["local fused"]["blocks_per_call"] = {
        k: fused.count(k) for k in sorted(set(fused))}
    prof["device_ms_per_task"] = sum(
        v["sum_ms"] for v in prof["by_name"].values()) / BC_PROFILE_TASKS
    # against the timed run's wall for as many tasks
    prof["overhead"] = (runs["elastic profiled"]["seconds"] /
                        (runs["elastic"]["seconds"] * BC_PROFILE_TASKS
                         / BC_PAPER_TASKS) - 1)
    log(f"[bc] local fused: {len(fused)} execute_batch calls, blocks per "
        f"call {runs['local fused']['blocks_per_call']}; the first "
        f"{BC_PROFILE_TASKS} tasks under the profiler: "
        f"{prof['device_ops']} device operations, busy {prof['busy_s']:.3f} "
        f"s, idle share {prof['idle_share']:.4f}, wall {prof['overhead']:+.4f}"
        f" against the unprofiled run; level kernels "
        f"{prof['device_ms_per_task']:.3f} ms a task; "
        + "; ".join(f"{k}: {v}" for k, v in prof["by_name"].items()))
    # keyed partials, each a deterministic function of its block, summed in
    # key order: the elastic runs agree bit for bit; fusing sums a call's
    # blocks in another order
    if len(first_kept) != BC_PROFILE_TASKS:
        raise AssertionError(f"BC: kept {len(first_kept)} of the first "
                             f"{BC_PROFILE_TASKS} tasks' partials")
    want = bc_spec(p, n_tasks=BC_PAPER_TASKS, device=dev).finalize(
        [(k, part) for k, (_, part) in first_kept.items()])
    if not np.array_equal(want, maps["elastic profiled"]):
        raise AssertionError("BC: the profiled elastic map differs from the "
                             "timed run's partials of its blocks")
    a, b = maps["elastic"], maps["local fused"]
    if not np.allclose(a, b, rtol=BC_RTOL, atol=BC_ATOL):
        raise AssertionError("BC: the elastic and the fused maps disagree")
    log(f"[bc] the profiled run's map over the first {BC_PROFILE_TASKS} "
        f"blocks equals the timed run's partials of them, summed in key "
        f"order, bit for bit; the fused map agrees "
        f"within rtol {BC_RTOL}, atol {BC_ATOL} (max |d| "
        f"{float(np.abs(a - b).max()):.3e})")

    # sampled main-path tasks, again through the plain versions
    if len(kept) != BC_REPLAY_TASKS:
        raise AssertionError(f"BC: kept {len(kept)} sampled tasks")
    for key, (block, partial) in sorted(kept.items()):
        ref = bc_batch(g17, torch.from_numpy(block).to(dev),
                       backend="ref").cpu().numpy()
        if not np.array_equal(ref.view(np.uint32), partial.view(np.uint32)):
            raise AssertionError(
                f"BC task {key}: the main path's partial differs from the "
                f"plain version's on {int((ref != partial).sum())} vertices")
    log(f"[bc] {len(kept)} sampled main-path tasks (blocks "
        f"{sorted(kept)}) bit-equal to the plain version")
    torch.cuda.empty_cache()
    return {"graph": {"vertices": n, "edges": host.n_edges,
                      "rmat_graph_s": regen_s},
            "fixed": fixed, "runs": runs,
            "replayed_blocks": sorted(kept), "oracle_sources": per,
            "oracle_max_abs_err": float(err.max()), "profile": prof,
            "launches": {k: r["launches"] for k, r in runs.items()}}


# -- faults, kill-and-resume, and the hybrid, sim and speculative pools ----------

#: the ``chaos_mortality`` row (``benchmarks/run.py:806``) as the JAX package
#: gives it on the CPU (``benchmarks/BENCH_pr10.json``; a CPU run of the row
#: gives the same); every ``*_identical_*`` flag must also hold
CHAOS_ROW = {"uts_deaths_30": 30, "ms_deaths_30": 1193, "bc_deaths_30": 12,
             "makespan_tax_30_pct": 83.3, "cost_tax_30_pct": 52.6,
             "recovery_overhead_pct": 26.2, "recovered_tasks": 16,
             "route_cost_per_deadline_metric": 8.73,
             "route_threshold_metric": 11.904,
             "route_local_first_metric": 7.004}
#: ``cost_performance_sim`` (``run.py:352``), from the same BENCH file
COST_PERF_ROW = {"nodes": 461_459, "serverless_vt_s": 6.482,
                 "vm_vt_s": 20.93, "serverless_cold_starts": 1046,
                 "serverless_peak": 1046, "autoscale_resizes": 65,
                 "serverless_usd": 0.067366, "vm_usd": 0.023721,
                 "equal_cost_speedup": 1.14}
#: ``fig4_dynamic_optimization_sim`` (``run.py:209``): no BENCH file holds
#: it; these are the JAX package's row on the CPU, with the virtual times
#: as the floats its ``simulate_uts_pool`` returns (the row prints them
#: rounded, 0.202 and 0.145 s)
FIG4_SIM_ROW = {"nodes": 1_841_891, "improvement_pct": 28.5}
FIG4_SIM_VTIMES = {"static": 0.20246, "dynamic": 0.14481}
FIG4_PAPER_PCT = 41.56
#: the UTS kill: Table 1's row with its depth cut from 14 to 12, so that
#: the smoke (with phase 9) stays inside its time (at depth 14 the kill and
#: the resume took 115 s for a 2.38 GB journal); the master dies at fold
#: 265 of depth 12's 529, about half way as at depth 14 (fold 4,001 of
#: 8,249), and the journal holds a checkpoint every 64 folds (four before
#: the kill, as at depth 14)
CHAOS_KILL_DEPTH = 12
CHAOS_KILL_FOLDS = 264
CHAOS_CHECKPOINT_EVERY = 64
#: Mariani-Silver kill-and-resume: the sd-64 geometry on 256x256 pixels
CHAOS_MS_SIDE = 256
#: the hybrid and speculative pools: UTS at depth 12
CHAOS_POOL_DEPTH = 12
#: the speculative pool's watchdog: clone a task once it has waited twice
#: the median task's time, and at least 5 ms (the default floor, 0.5 s, is
#: longer than any task here, so no clone would run)
CHAOS_SPECULATION = dict(factor=2.0, floor_s=0.005, poll_s=0.01)
#: the hybrid's routing: cost per deadline, with a task's body reckoned at
#: alpha seconds a node of its bag (UTS's cost hint is the bag's size)
CHAOS_DEADLINE_S = 0.05
CHAOS_ALPHA_S = 1e-5
#: WAL spill files: under ``build/`` (ignored by git), not beside the
#: report in ``chiprun_out/``: a depth-14 journal takes gigabytes; each is
#: deleted once read
JOURNAL_DIR = ROOT / "build" / "chaos"


class CountedBodies:
    """Counts a spec's task bodies (``execute`` and ``execute_batch``
    calls), so that a path's kernel launches can be read beside the bodies
    that ran them."""

    def __init__(self) -> None:
        import threading
        self.n = 0
        self.lock = threading.Lock()

    def wrap(self, spec):
        import dataclasses

        def counted(fn):
            def body(*a, **kw):
                with self.lock:
                    self.n += 1
                return fn(*a, **kw)
            return body
        return dataclasses.replace(
            spec, execute=counted(spec.execute),
            execute_batch=spec.execute_batch and counted(spec.execute_batch))


class TimedWAL:
    """Wraps a spec's WAL encoders and a store's ``emit`` with clocks: the
    master thread's time to encode the journal (device-to-host copies
    included) and to serialize and write it."""

    def __init__(self) -> None:
        self.encode_s = 0.0
        self.emit_s = 0.0

    def wrap(self, spec):
        import dataclasses

        def timed(fn):
            def enc(x):
                t0 = time.perf_counter()
                try:
                    return fn(x)
                finally:
                    self.encode_s += time.perf_counter() - t0
            return enc
        return dataclasses.replace(
            spec, encode_item=timed(spec.encode_item),
            encode_result=timed(spec.encode_result),
            encode_state=timed(spec.encode_state))

    def store(self, path: Path):
        from repro_torch.core.telemetry import CHECKPOINT, FOLDED
        from repro_torch.trace import TraceStore
        wal = self

        class Store(TraceStore):
            def emit(self, kind, **kw):
                if kind not in (FOLDED, CHECKPOINT):
                    return super().emit(kind, **kw)
                t0 = time.perf_counter()
                try:
                    return super().emit(kind, **kw)
                finally:
                    wal.emit_s += time.perf_counter() - t0
        return Store(path=str(path))


def journal_tail(path: Path) -> dict:
    """A spilled journal's folds and checkpoints, and the folds past its
    last checkpoint (what recovery replays), read from each line's head
    (``event_to_dict`` writes ``t`` and ``kind`` first)."""
    folds = ckpts = tail = 0
    with open(path, "rb") as f:
        for line in f:
            head = line[:96]
            if b'"kind":"checkpoint"' in head:
                ckpts += 1
                tail = 0
            elif b'"kind":"folded"' in head:
                n = line.count(b'"item":')
                folds += n
                tail += n
    return {"folds": folds, "checkpoints": ckpts, "tail_folds": tail}


def chaos_path(paths: dict, name: str, kernel: str, fn) -> tuple:
    """``run_path`` of one path of the chaos phase; records the launches of
    every kernel it may run under ``name`` (BC's two level kernels, UTS's
    ``uts_expand`` and its root digest)."""
    from repro_torch.kernels import launches
    out, wall, _ = run_path(name, kernel, fn)
    kernels = {"uts_expand": ("uts_expand", "uts_hash"),
               "mandelbrot": ("mandelbrot",),
               "bc_forward_level": ("bc_forward_level", "bc_backward_level")}
    paths[name] = {"seconds": wall,
                   "launches": {k: launches(k) for k in kernels[kernel]}}
    if kernel == "bc_forward_level" and \
            paths[name]["launches"]["bc_backward_level"] <= 0:
        raise AssertionError(f"{name}: bc_backward_level not launched")
    return out, wall


def killed_run(pool_fn, spec, n_folds: int, **kw):
    """Runs ``spec`` with its master killed after ``n_folds`` folds (WAL
    on); the pool's exit drains what the dead master left in flight.
    Returns the pool (its journal and counts)."""
    from repro_torch.chaos import MasterKilledError, kill_master_after
    from repro_torch.core import run_irregular
    kw.setdefault("wal", True)
    try:
        with pool_fn() as pool:
            run_irregular(pool, kill_master_after(spec, n_folds), **kw)
    except MasterKilledError:
        return pool
    raise AssertionError(f"{spec.name}: the injected master kill after "
                         f"{n_folds} folds never fired")


def route_sim(policy, provider, tasks, deadline_s: float) -> tuple:
    """The ``chaos_mortality`` row's routing model: a bursty stream of
    mixed-size tasks placed by ``policy`` between a 4-slot donor VM and
    the provider's containers (cold or warm), in a deterministic queueing
    model; returns (billed elastic seconds, deadline-hit fraction, billed
    seconds per unit hit fraction)."""

    class Clock:
        t = 0.0

        def now(self):
            return self.t

    clk = Clock()

    class Local:
        max_concurrency = 4

        def __init__(self):
            self.ends = [0.0] * self.max_concurrency

        def idle_capacity(self):
            return sum(1 for e in self.ends if e <= clk.t)

        def pending(self):
            return 0

    class Fleet:
        def __init__(self):
            self.ends = []

        def warm_count(self, now):
            return sum(1 for e in self.ends
                       if e <= now <= e + provider.keep_alive_s)

    class Elastic:
        max_concurrency = 10_000

        def __init__(self):
            self.provider = provider
            self._fleet = Fleet()
            self.clock = clk
            self.invoke_overhead = provider.warm_overhead_s

        def idle_capacity(self):
            return self.max_concurrency

        def pending(self):
            return 0

    class Hybrid:
        """What routing policies read of a hybrid pool."""

        def __init__(self):
            self.local = Local()
            self.elastic = Elastic()

    h = Hybrid()
    billed = hits = 0.0
    for t_arr, body in tasks:
        clk.t = t_arr
        route = getattr(policy, "route", None)
        run_local = (route(h, cost_hint=body) if route is not None
                     else policy(h))
        if run_local:
            i = min(range(len(h.local.ends)), key=lambda j: h.local.ends[j])
            end = max(t_arr, h.local.ends[i]) + body
            h.local.ends[i] = end
        else:
            warm = h.elastic._fleet.warm_count(t_arr) > 0
            oh = provider.overhead_s(cold=not warm)
            end = t_arr + oh + body
            h.elastic._fleet.ends.append(end)
            billed += oh + body
        hits += 1.0 if end - t_arr <= deadline_s else 0.0
    hit_frac = hits / len(tasks)
    return billed, hit_frac, billed / max(hit_frac, 1e-9)


def check_row(label: str, got: dict, want: dict) -> None:
    bad = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if bad:
        raise AssertionError(f"{label}: differs from the JAX package's row "
                             f"(got, want): {bad}")


def chaos_mortality_row(dev, paths: dict) -> tuple:
    """The ``chaos_mortality`` row on the card, at its own shapes: UTS, MS
    and BC on the sim pool at 0, 10 and 30 % container mortality; the
    master killed after 5 folds and resumed for UTS (plain, 3 shards,
    batched), MS and BC; the routing policies.  Returns the derived
    values, the bases, and the UTS and MS journals (for the resumes
    across devices)."""
    import numpy as np
    from repro_torch.algorithms import (MSParams, RMATParams, UTSParams,
                                        bc_spec, ms_spec, uts_spec)
    from repro_torch.chaos import (CostPerDeadlinePolicy, FaultPlan,
                                   LocalFirstPolicy, ThresholdPolicy)
    from repro_torch.core import ProviderModel, TaskShape, make_pool, \
        run_irregular

    uts_p = UTSParams(seed=2, b0=3.0, max_depth=6)
    ms_p = MSParams(width=128, height=128, max_dwell=64, max_depth=4,
                    initial_subdivision=4)
    bc_p = RMATParams(scale=7, edge_factor=8, seed=2)
    uts_kw = dict(shape=TaskShape(split_factor=4, iters=50))
    same_image = (lambda a, b: a["image"].shape == b["image"].shape
                  and bool(np.array_equal(a["image"], b["image"])))
    cases = {
        "uts": (lambda d: uts_spec(uts_p, device=d), uts_kw,
                lambda a, b: a == b, "uts_expand"),
        "ms": (lambda d: ms_spec(ms_p, device=d), {}, same_image,
               "mandelbrot"),
        "bc": (lambda d: bc_spec(bc_p, n_tasks=24, device=d), {},
               lambda a, b: bool(np.array_equal(a, b)), "bc_forward_level"),
    }

    def sim(**kw):
        return make_pool("sim", max_concurrency=16, **kw)

    derived, bases = {}, {}
    for name, (mk, kw, eq, kernel) in cases.items():
        for pct in (0, 10, 30):
            bodies = CountedBodies()

            def go():
                plan = FaultPlan(seed=7, container_mortality=pct / 100) \
                    if pct else None
                with sim(faults=plan) as pool:
                    return run_irregular(pool, bodies.wrap(mk(dev)), **kw)
            label = f"sim {name} mortality {pct}%"
            r, _ = chaos_path(paths, label, kernel, go)
            paths[label].update(tasks=r.tasks, bodies=bodies.n,
                                worker_deaths=r.worker_deaths)
            if bodies.n != r.tasks:
                raise AssertionError(f"{label}: {bodies.n} task bodies ran "
                                     f"for {r.tasks} tasks")
            if not pct:
                bases[name] = r
                continue
            derived[f"{name}_identical_{pct}"] = eq(r.output,
                                                    bases[name].output)
            if pct == 30:
                derived[f"{name}_deaths_30"] = r.worker_deaths
                if name == "uts":
                    base = bases["uts"]
                    derived["makespan_tax_30_pct"] = round(
                        (r.makespan_s / base.makespan_s - 1.0) * 100, 1)
                    derived["cost_tax_30_pct"] = round(
                        (r.cost.total / base.cost.total - 1.0) * 100, 1)

    journals = {}
    for label, name, kw in (("uts", "uts", uts_kw),
                            ("uts_shards", "uts", dict(uts_kw, shards=3)),
                            ("uts_batched", "uts",
                             dict(uts_kw, batching=True)),
                            ("ms", "ms", {}), ("bc", "bc", {})):
        mk, _, eq, kernel = cases[name]
        killed, _ = chaos_path(paths, f"sim {label} killed after 5 folds",
                               kernel, lambda: killed_run(
                                   sim, mk(dev), 5, **kw))

        def resume():
            with sim() as pool:
                return run_irregular(pool, mk(dev), resume_from=killed.events,
                                     **kw)
        r, _ = chaos_path(paths, f"sim {label} resumed", kernel, resume)
        derived[f"resume_identical_{label}"] = eq(r.output,
                                                  bases[name].output)
        if label == "uts":
            killed_tasks = killed.snapshot()["submitted"]
            derived["recovery_overhead_pct"] = round(
                ((killed_tasks + r.tasks) / bases["uts"].tasks - 1.0) * 100,
                1)
            derived["recovered_tasks"] = r.recovered_tasks
        if label in ("uts", "ms"):
            journals[label] = killed.events

    provider = ProviderModel.aws_lambda()
    deadline_s = 0.6
    stream = [(burst * 1.0, 0.4 if i % 2 else 0.05)
              for burst in range(6) for i in range(8)]
    for name, pol in (("threshold", ThresholdPolicy(cost_threshold=0.2)),
                      ("local_first", LocalFirstPolicy()),
                      ("cost_per_deadline", CostPerDeadlinePolicy(
                          deadline_s=deadline_s, alpha_s_per_cost=1.0))):
        billed, hit_frac, metric = route_sim(pol, provider, stream,
                                             deadline_s)
        derived[f"route_{name}_billed_s"] = round(billed, 3)
        derived[f"route_{name}_hit_frac"] = round(hit_frac, 3)
        derived[f"route_{name}_metric"] = round(metric, 3)

    flags = {k: v for k, v in derived.items() if "_identical_" in k}
    if len(flags) != 11 or not all(flags.values()):
        raise AssertionError(f"chaos_mortality: outputs not identical: "
                             f"{flags}")
    check_row("chaos_mortality", derived, CHAOS_ROW)
    return derived, bases, journals, (uts_p, ms_p, uts_kw, same_image)


def cost_performance_row(dev, paths: dict) -> dict:
    """``cost_performance_sim`` on the card: UTS depth 10 (chunk 4096,
    shape (100, 400)) on a 2,000-wide sim pool with AWS Lambda's provider
    model and autoscaling, and on a 96-wide static VM."""
    from repro_torch.algorithms import UTSParams, uts_spec
    from repro_torch.core import (AutoscalePolicy, ProviderModel, TaskShape,
                                  VMPrice, emr_cluster_cost, make_pool,
                                  price_performance, run_irregular, vm_cost)

    p = UTSParams(seed=19, b0=4.0, max_depth=10, chunk=4096)
    alpha = 4e-3

    def dur(task, result):
        return alpha * result[0]
    shape = TaskShape(100, 400)

    def serverless():
        with make_pool("sim", max_concurrency=2000,
                       provider=ProviderModel.aws_lambda(),
                       duration_fn=dur) as pool:
            return run_irregular(pool, uts_spec(p, device=dev), shape=shape,
                                 autoscale=AutoscalePolicy(
                                     min_capacity=8, max_capacity=2000))

    def vm():
        with make_pool("sim", max_concurrency=96,
                       provider=ProviderModel.local_vm(),
                       duration_fn=dur) as pool:
            return run_irregular(pool, uts_spec(p, device=dev), shape=shape)

    r_sls, _ = chaos_path(paths, "sim cost_performance serverless",
                          "uts_expand", serverless)
    r_vm, _ = chaos_path(paths, "sim cost_performance vm", "uts_expand", vm)
    for label, r in (("serverless", r_sls), ("vm", r_vm)):
        paths[f"sim cost_performance {label}"]["tasks"] = r.tasks
    if r_sls.output != r_vm.output:
        raise AssertionError(f"cost_performance_sim: {r_sls.output} != "
                             f"{r_vm.output} nodes")
    nodes = r_sls.output
    cost_vm = vm_cost(r_vm.makespan_s, VMPrice.named("c5.24xlarge"))
    cost_emr = emr_cluster_cost(r_vm.makespan_s, workers=1)
    ppr_sls = price_performance(nodes / r_sls.makespan_s / 1e6, r_sls.cost)
    ppr_vm = price_performance(nodes / r_vm.makespan_s / 1e6, cost_vm)
    ppr_emr = price_performance(nodes / r_vm.makespan_s / 1e6, cost_emr)
    row = {"nodes": nodes,
           "serverless_vt_s": round(r_sls.makespan_s, 3),
           "vm_vt_s": round(r_vm.makespan_s, 3),
           "serverless_usd": round(r_sls.cost.total, 6),
           "vm_usd": round(cost_vm.total, 6),
           "serverless_peak": r_sls.peak_concurrency,
           "serverless_cold_starts": r_sls.cold_starts,
           "autoscale_resizes": len(r_sls.autoscale_decisions),
           "ppr_serverless": round(ppr_sls, 3), "ppr_vm": round(ppr_vm, 3),
           "ppr_emr": round(ppr_emr, 3),
           "serverless_beats_vm": ppr_sls > ppr_vm,
           "equal_cost_speedup": round(ppr_sls / ppr_vm, 2)}
    check_row("cost_performance_sim", row, COST_PERF_ROW)
    return row


def fig4_sim_row(dev, paths: dict) -> dict:
    """``fig4_dynamic_optimization_sim`` on the card: UTS depth 11 through
    the port's ``simulate_uts_pool`` (2,000 workers, 13 ms invocations),
    the best static shape against the staged controller."""
    from repro_torch.algorithms import UTSParams, uts_sequential
    from repro_torch.core import StagedController, TaskShape, \
        simulate_uts_pool
    from repro_torch.core.adaptive import Stage

    p = UTSParams(seed=19, b0=4.0, max_depth=11, chunk=4096)
    kw = dict(workers=2000, overhead_s=13e-3, alpha_s_per_node=10e-6,
              device=dev)

    def static():
        return simulate_uts_pool(p, shape=TaskShape(50, 5_000), **kw)

    def dynamic():
        ctrl = StagedController(initial=TaskShape(200, 2_000), stages=[
            Stage(800, "above", TaskShape(50, 10_000)),
            Stage(1300, "above", TaskShape(5, 25_000)),
            Stage(1100, "below", TaskShape(5, 10_000)),
            Stage(100, "below", TaskShape(5, 4_000))])
        return simulate_uts_pool(p, shape=TaskShape(200, 2_000),
                                 controller=ctrl, **kw)

    st, _ = chaos_path(paths, "simulate_uts_pool static", "uts_expand",
                       static)
    dy, _ = chaos_path(paths, "simulate_uts_pool dynamic", "uts_expand",
                       dynamic)
    want = uts_sequential(p, device=dev)
    if not st.count == dy.count == want:
        raise AssertionError(f"fig4 sim: static {st.count}, dynamic "
                             f"{dy.count}, uts_sequential {want} nodes")
    vt = {"static": st.virtual_time_s, "dynamic": dy.virtual_time_s}
    if vt != FIG4_SIM_VTIMES:
        raise AssertionError(f"fig4 sim: virtual times {vt}, the JAX "
                             f"package's {FIG4_SIM_VTIMES}")
    row = {"nodes": st.count, "vtime_static_s": round(vt["static"], 3),
           "vtime_dynamic_s": round(vt["dynamic"], 3),
           "improvement_pct": round(100 * (1 - vt["dynamic"]
                                           / vt["static"]), 1),
           "tasks_static": st.tasks, "tasks_dynamic": dy.tasks,
           "peak_static": st.peak_concurrency,
           "peak_dynamic": dy.peak_concurrency,
           "paper_improvement_pct": FIG4_PAPER_PCT}
    check_row("fig4_dynamic_optimization_sim", row, FIG4_SIM_ROW)
    return row


def uts_kill_resume(dev, paths: dict) -> dict:
    """UTS (seed 19, b0 4, ``CHAOS_KILL_DEPTH``) on the elastic pool: an
    unkilled run, then the master killed after ``CHAOS_KILL_FOLDS`` folds
    with the WAL spilled to a file under ``build/chaos`` (a checkpoint
    every ``CHAOS_CHECKPOINT_EVERY`` folds) and resumed from that file;
    both count the tree.  Returns the journal's size and the master's
    time to encode and write it beside the tasks of each run."""
    from repro_torch.algorithms import UTSParams, uts_spec
    from repro_torch.core import run_irregular
    kparams = UTSParams(seed=19, b0=4.0, max_depth=CHAOS_KILL_DEPTH)

    def unkilled():
        with elastic_pool() as pool:
            return run_irregular(pool, uts_spec(kparams, device=dev))
    name = f"elastic UTS depth {CHAOS_KILL_DEPTH}"
    base, wall_u = chaos_path(paths, name, "uts_expand", unkilled)
    paths[name]["tasks"] = base.tasks
    JOURNAL_DIR.mkdir(parents=True, exist_ok=True)
    path = JOURNAL_DIR / f"uts{CHAOS_KILL_DEPTH}.jsonl"
    wal = TimedWAL()
    store = wal.store(path)
    try:
        name = f"elastic UTS depth {CHAOS_KILL_DEPTH} killed after " \
               f"{CHAOS_KILL_FOLDS} folds"
        killed, wall_k = chaos_path(
            paths, name, "uts_expand",
            lambda: killed_run(lambda: elastic_pool(trace=store),
                               wal.wrap(uts_spec(kparams, device=dev)),
                               CHAOS_KILL_FOLDS,
                               checkpoint_every=CHAOS_CHECKPOINT_EVERY))
        store.flush()
        killed_tasks = killed.snapshot()["submitted"]
        journal = {"bytes": path.stat().st_size, **journal_tail(path),
                   "encode_s": wal.encode_s, "emit_s": wal.emit_s}
        paths[name]["tasks"] = killed_tasks

        def resume():
            with elastic_pool() as pool:
                return run_irregular(pool, uts_spec(kparams, device=dev),
                                     resume_from=str(path))
        name = f"elastic UTS depth {CHAOS_KILL_DEPTH} resumed from the " \
               f"journal"
        r, wall_r = chaos_path(paths, name, "uts_expand", resume)
    finally:
        store.close()
        path.unlink(missing_ok=True)
    if not r.output == base.output == UTS_DEEP_NODES[CHAOS_KILL_DEPTH]:
        raise AssertionError(f"{name}: {r.output} nodes, unkilled "
                             f"{base.output}")
    clean_tasks = base.tasks
    paths[name].update(tasks=r.tasks, recovered_tasks=r.recovered_tasks)
    rec = {
        "depth": CHAOS_KILL_DEPTH, "nodes": r.output,
        "killed_tasks": killed_tasks, "resumed_tasks": r.tasks,
        "unkilled_tasks": clean_tasks,
        "recovery_overhead_pct": ((killed_tasks + r.tasks) / clean_tasks
                                  - 1) * 100,
        "recovered_tasks": r.recovered_tasks, "journal": journal,
        "killed_s": wall_k, "resumed_s": wall_r, "unkilled_s": wall_u}
    log(f"[chaos] UTS depth {CHAOS_KILL_DEPTH} killed after "
        f"{CHAOS_KILL_FOLDS} "
        f"folds ({killed_tasks} tasks, {wall_k:.3f} s, WAL on, a checkpoint "
        f"every {CHAOS_CHECKPOINT_EVERY} folds) and resumed from the spilled "
        f"journal ({r.tasks} tasks, {r.recovered_tasks} recovered, "
        f"{wall_r:.3f} s): {r.output} nodes; "
        f"{killed_tasks + r.tasks} tasks against {clean_tasks} unkilled "
        f"({rec['recovery_overhead_pct']:.2f} % "
        f"overhead); journal {journal['bytes']} bytes, {journal['folds']} "
        f"folds, {journal['checkpoints']} checkpoints, "
        f"{journal['tail_folds']} folds replayed past the last; the master "
        f"spent {wal.encode_s:.3f} s encoding and {wal.emit_s:.3f} s "
        f"writing it")
    return rec


def phase_chaos(dev, uts: dict) -> dict:
    """Faults, master kills and resumes, and the hybrid, sim and
    speculative pools on the card (phase 8 of the module docstring).
    ``uts`` is phase 4's record, whose unfaulted elastic runs the faulted
    ones stand beside."""
    import numpy as np
    import torch
    from repro_torch.algorithms import (UTSParams, bc_spec, ms_spec,
                                        naive_render, uts_sequential,
                                        uts_spec)
    from repro_torch.chaos import FaultPlan, make_routing_policy
    from repro_torch.configs.paper_workloads import BC_SCALED, \
        BC_SCALED_TASKS
    from repro_torch.core import make_pool, run_irregular

    t_phase = time.monotonic()
    paths: dict = {}
    out: dict = {"paths": paths}

    # 1-3: the paper's simulated rows, every task body on the card
    row, bases, journals, (uts_p, ms_p, uts_kw, same_image) = \
        chaos_mortality_row(dev, paths)
    out["chaos_mortality"] = row
    log("[chaos] chaos_mortality on the card equals the JAX package's row: "
        + ", ".join(f"{k} {row[k]}" for k in CHAOS_ROW)
        + "; every output identical under mortality and after a resume")
    out["cost_performance_sim"] = row = cost_performance_row(dev, paths)
    log("[chaos] cost_performance_sim on the card equals the JAX package's "
        "row: " + ", ".join(f"{k} {row[k]}" for k in COST_PERF_ROW))
    out["fig4_dynamic_optimization_sim"] = row = fig4_sim_row(dev, paths)
    log(f"[chaos] fig4_dynamic_optimization_sim on the card: "
        f"{row['nodes']} nodes (= uts_sequential), virtual time static "
        f"{FIG4_SIM_VTIMES['static']} s, dynamic "
        f"{FIG4_SIM_VTIMES['dynamic']} s (the JAX package's), improvement "
        f"{row['improvement_pct']} % against the paper's {FIG4_PAPER_PCT} %")

    # 4: mortality at the paper's scale on the wall pool
    params = UTSParams(seed=19, b0=4.0, max_depth=UTS_DEPTH)
    bodies = CountedBodies()

    def mortal():
        with elastic_pool(faults=FaultPlan(seed=7,
                                           container_mortality=0.3)) as pool:
            return run_irregular(pool, bodies.wrap(uts_spec(params,
                                                            device=dev)))
    name = f"elastic UTS depth {UTS_DEPTH} mortality 30%"
    r, wall = chaos_path(paths, name, "uts_expand", mortal)
    if r.output != UTS_DEPTH14_NODES:
        raise AssertionError(f"{name}: {r.output} nodes")
    if bodies.n != r.tasks:
        raise AssertionError(f"{name}: {bodies.n} task bodies ran for "
                             f"{r.tasks} tasks")
    clean = uts["runs"]["elastic batching=False"]
    paths[name].update(tasks=r.tasks, bodies=bodies.n,
                       worker_deaths=r.worker_deaths, retries=r.retries,
                       unfaulted_seconds=clean["seconds"])
    log(f"[chaos] {name}: {r.output} nodes, {r.tasks} tasks, "
        f"{r.worker_deaths} worker deaths, {r.retries} retries, {wall:.3f} s "
        f"against {clean['seconds']:.3f} s unfaulted (phase 4); "
        f"{paths[name]['launches']['uts_expand']} uts_expand launches for "
        f"{bodies.n} task bodies (a killed attempt dies before its body)")

    # 5: kill half way and resume from the spilled journal
    out["uts_kill_resume"] = uts_kill_resume(dev, paths)

    # 6: Mariani-Silver killed at half its folds, resumed
    p = ms_params(CHAOS_MS_SIDE, MS_DWELL)
    expected, rects = mariani_silver_over(naive_render(p, device=dev), p)
    half = len(rects) // 2
    killed, _ = chaos_path(
        paths, f"elastic MS {CHAOS_MS_SIDE}^2 killed after {half} folds",
        "mandelbrot",
        lambda: killed_run(elastic_pool, ms_spec(p, device=dev), half))

    def resume():
        with elastic_pool() as pool:
            return run_irregular(pool, ms_spec(p, device=dev),
                                 resume_from=killed.events)
    name = f"elastic MS {CHAOS_MS_SIDE}^2 resumed"
    r, _ = chaos_path(paths, name, "mandelbrot", resume)
    img = r.output["image"]
    if img.shape != expected.shape or not np.array_equal(img, expected):
        raise AssertionError(f"{name}: image differs from Mariani-Silver "
                             f"over naive_render on "
                             f"{int((img != expected).sum())} pixels")
    out["ms_kill_resume"] = {"tasks": len(rects), "killed_after": half,
                             "killed_tasks": killed.snapshot()["submitted"],
                             "resumed_tasks": r.tasks,
                             "recovered_tasks": r.recovered_tasks}
    log(f"[chaos] MS {CHAOS_MS_SIDE}^2 max_dwell {MS_DWELL}: killed after "
        f"{half} of {len(rects)} folds, resumed ({r.tasks} tasks, "
        f"{r.recovered_tasks} recovered): equal to Mariani-Silver over "
        f"naive_render, pixel for pixel")

    # 7: BC at BC_SCALED, killed at half its folds, resumed
    def bc_unkilled():
        with elastic_pool() as pool:
            return run_irregular(pool, bc_spec(
                BC_SCALED, n_tasks=BC_SCALED_TASKS, device=dev))
    want, _ = chaos_path(paths, "elastic BC_SCALED", "bc_forward_level",
                         bc_unkilled)
    path = JOURNAL_DIR / "bc.jsonl"
    from repro_torch.trace import TraceStore
    store = TraceStore(path=str(path))
    try:
        half = BC_SCALED_TASKS // 2
        chaos_path(paths, f"elastic BC_SCALED killed after {half} folds",
                   "bc_forward_level",
                   lambda: killed_run(lambda: elastic_pool(trace=store),
                                      bc_spec(BC_SCALED,
                                              n_tasks=BC_SCALED_TASKS,
                                              device=dev), half))
        store.flush()
        bc_journal = {"bytes": path.stat().st_size, **journal_tail(path)}

        def resume():
            with elastic_pool() as pool:
                return run_irregular(pool, bc_spec(
                    BC_SCALED, n_tasks=BC_SCALED_TASKS, device=dev),
                    resume_from=str(path))
        r, _ = chaos_path(paths, "elastic BC_SCALED resumed",
                          "bc_forward_level", resume)
    finally:
        store.close()
        path.unlink(missing_ok=True)
    if not np.array_equal(r.output.view(np.uint32),
                          want.output.view(np.uint32)):
        raise AssertionError("BC_SCALED resumed: the map differs from the "
                             "unkilled run's")
    # a fold journals a task's whole float32 map as JSON: scale by the
    # vertices and the tasks of the paper's run
    n_bc = 2 ** BC_SCALED.scale
    per_value = bc_journal["bytes"] / (bc_journal["folds"] * n_bc)
    bc_journal["paper_bytes_reckoned"] = per_value * 128 * 2 ** 17
    out["bc_kill_resume"] = {"journal": bc_journal,
                             "resumed_tasks": r.tasks,
                             "recovered_tasks": r.recovered_tasks}
    log(f"[chaos] BC_SCALED ({BC_SCALED_TASKS} tasks) killed after {half} "
        f"folds and resumed from the spilled journal: bit-equal to the "
        f"unkilled run; journal {bc_journal['bytes']} bytes for "
        f"{bc_journal['folds']} folds ({per_value:.2f} bytes a value), "
        f"{bc_journal['paper_bytes_reckoned'] / 1e9:.3f} GB by that rate "
        f"for the paper's 128 tasks of 131,072 values")

    # 8: resumes across devices: the card's journals on the CPU, and a
    # journal written on the CPU resumed on the card
    cpu = torch.device("cpu")
    uts_mk = lambda d: uts_spec(uts_p, device=d)  # noqa: E731
    ms_mk = lambda d: ms_spec(ms_p, device=d)  # noqa: E731

    def sim_resume(spec, trace, **kw):
        with make_pool("sim", max_concurrency=16) as pool:
            return run_irregular(pool, spec, resume_from=trace, **kw)
    t0 = time.monotonic()
    r_uts = sim_resume(uts_mk(cpu), journals["uts"], **uts_kw)
    r_ms = sim_resume(ms_mk(cpu), journals["ms"])
    cpu_s = time.monotonic() - t0
    if r_uts.output != bases["uts"].output:
        raise AssertionError(f"UTS journal of the card resumed on the CPU: "
                             f"{r_uts.output} != {bases['uts'].output}")
    if not same_image(r_ms.output, bases["ms"].output):
        raise AssertionError("MS journal of the card resumed on the CPU: the "
                             "image differs")
    killed = killed_run(lambda: make_pool("sim", max_concurrency=16),
                        uts_mk(cpu), 5, **uts_kw)
    r, _ = chaos_path(paths, "sim UTS journal of the CPU resumed",
                      "uts_expand",
                      lambda: sim_resume(uts_mk(dev), killed.events,
                                         **uts_kw))
    if r.output != bases["uts"].output:
        raise AssertionError(f"UTS journal of the CPU resumed on the card: "
                             f"{r.output} != {bases['uts'].output}")
    out["cross_device"] = {"card_to_cpu_s": cpu_s,
                           "cpu_to_card_recovered": r.recovered_tasks}
    log(f"[chaos] the card's UTS and MS journals resume on the CPU "
        f"({cpu_s:.3f} s), and a journal of the CPU on the card: outputs "
        f"bit-equal to the unkilled runs")

    # 9: the hybrid and speculative pools
    p12 = UTSParams(seed=19, b0=4.0, max_depth=CHAOS_POOL_DEPTH)
    want = uts_sequential(p12, device=dev)
    policy = make_routing_policy("cost_per_deadline",
                                 deadline_s=CHAOS_DEADLINE_S,
                                 alpha_s_per_cost=CHAOS_ALPHA_S)

    def hybrid():
        with make_pool("hybrid", local_concurrency=4, elastic_concurrency=16,
                       policy=policy) as pool:
            return run_irregular(pool, uts_spec(p12, device=dev)), \
                pool.placement_counts()

    def speculative():
        with make_pool("speculative", inner="elastic",
                       inner_cfg=ELASTIC_CFG, **CHAOS_SPECULATION) as pool:
            r = run_irregular(pool, uts_spec(p12, device=dev))
        # the watchdog thread sleeps out its poll after shutdown; a process
        # that exits while it still runs aborts
        pool._thread.join(timeout=5)
        snap = pool.inner.stats.snapshot()
        return r, {"clones": pool.duplicates,
                   "wins_by_clone": pool.wins_by_clone,
                   "submitted": snap["submitted"],
                   "completed": snap["completed"], "failed": snap["failed"]}
    pools = {}
    for name, fn in (("hybrid", hybrid), ("speculative", speculative)):
        label = f"{name} UTS depth {CHAOS_POOL_DEPTH}"
        (r, info), wall = chaos_path(paths, label, "uts_expand", fn)
        if r.output != want:
            raise AssertionError(f"{label}: {r.output} nodes, uts_sequential "
                                 f"{want}")
        paths[label]["tasks"] = r.tasks
        pools[name] = {"seconds": wall, "tasks": r.tasks, **info}
        log(f"[chaos] {label}: {r.output} nodes (= uts_sequential), "
            f"{r.tasks} tasks, {wall:.3f} s; "
            + ", ".join(f"{k} {v}" for k, v in info.items()))
    spec_info = pools["speculative"]
    if spec_info["failed"] or spec_info["completed"] != \
            spec_info["submitted"]:
        raise AssertionError(f"speculative: not every invocation (clones "
                             f"included) finished: {spec_info}")
    out["pools"] = pools
    out["seconds"] = time.monotonic() - t_phase
    log(f"[chaos] phase {out['seconds']:.1f} s")
    return out


# -- the harness: record, replay and calibrate; Figs. 7-9; traffic; DAGs ----------

#: ``trace_record_replay`` (``benchmarks/run.py:435``) as
#: ``benchmarks/BENCH_pr10.json`` holds it; a CPU run of the JAX package
#: gives the same values (``figure_png`` aside, which says whether
#: matplotlib was importable)
TRACE_REPLAY_ROW = {
    "nodes": 115_780, "tasks": 39_529, "events_total": 119_100,
    "resident_events": 4096, "recorded_vt_s": 1.725,
    "recorded_usd": 0.027617, "recorded_cold_starts": 512,
    "replay_same_vt_s": 1.735, "replay_parity_pct": 0.581,
    "replay_gcf_vt_s": 15.225, "replay_gcf_usd": 0.149721,
    "gcf_slowdown_pct": 782.6, "replay_ewma_vt_s": 1.761,
    "replay_ewma_usd": 0.027619, "ewma_resizes": 5, "fitted_cold_s": 0.4,
    "fitted_warm_ms": 20.0, "fitted_ramp_per_min": 120.0,
    "fit_within_tolerance": True, "bounded_memory": True}
#: ``serving_knee`` (``run.py:529``), every derived value, from the same
#: file (a CPU run of the JAX package gives the same)
SERVING_KNEE_ROW = {
    "x1_p99_ms": 838.0, "x1_loss_pct": 0.0, "x2_p99_ms": 838.0,
    "x2_loss_pct": 0.0, "x4_p99_ms": 2297.35, "x4_loss_pct": 0.24,
    "x8_p99_ms": 2821.43, "x8_loss_pct": 28.74, "x16_p99_ms": 3026.3,
    "x16_loss_pct": 71.89, "knee_factor": 4, "knee_rate_rps": 10.0,
    "knee_p50_ms": 180.75, "knee_p99_ms": 2297.35, "knee_loss_pct": 0.24,
    "knee_cost_per_mtok_usd": 0.0317, "slo_target_ms": 2000.0,
    "slo_p99_ms": 1801.94, "static_peak_p99_ms": 530.0,
    "slo_peak_capacity": 75, "slo_resizes": 33,
    "slo_provisioned_usd": 0.010785, "static_provisioned_usd": 0.053738,
    "slo_cost_per_mtok_usd": 0.062, "static_cost_per_mtok_usd": 0.2969,
    "slo_savings_pct": 79.9, "replay_parity_pct": 0.0,
    "cost_parity_pct": 0.0, "knee_visible": True, "deterministic": True,
    "static_knee_violates_target": True, "slo_holds_target": True,
    "slo_cheaper_than_static": True, "replay_parity_ok": True}
#: ``dag_pipeline`` (``run.py:1045``), from the same file
DAG_PIPELINE_ROW = {
    "montage_nodes": 65, "montage_critical_path": 7,
    "montage_max_stage_width": 33, "montage_vt_s": 0.091,
    "montage_vt_fused_s": 0.0911, "sweep_nodes": 36,
    "sweep_critical_path": 8, "sweep_max_stage_width": 16,
    "sweep_vt_s": 0.104, "sweep_vt_fused_s": 0.104, "iter_mr_nodes": 55,
    "iter_mr_critical_path": 10, "iter_mr_max_stage_width": 16,
    "iter_mr_vt_s": 0.13, "iter_mr_vt_fused_s": 0.1301,
    "dag_identical_outputs": True}
#: ``faas_parallelism`` (``run.py:1083``), from the same file
FAAS_PARALLELISM_ROW = {
    "aws_lambda_achieved_at_512": 512, "aws_lambda_ramp_latency_s": 0.0,
    "aws_lambda_cold_share": 0.5, "gcf_achieved_at_512": 146,
    "gcf_ramp_latency_s": 0.55, "gcf_cold_share": 0.012,
    "azure_functions_achieved_at_512": 234,
    "azure_functions_ramp_latency_s": 0.0,
    "azure_functions_cold_share": 0.008, "prewarmed_achieved_at_512": 512,
    "prewarmed_ramp_latency_s": 0.0, "prewarmed_cold_share": 0.5,
    "probe_envelope_monotone": True, "fit_burst": 8,
    "fit_ramp_per_min": 239.6, "fit_cold_s": 0.3,
    "probe_fit_recovers": True}
#: ``serve_traffic_sim`` at these arguments, and its whole report as the JAX
#: package's ``repro.launch.serve.serve_traffic_sim`` gives it on the CPU
#: (unrounded: every value must be equal)
SERVE_SIM_ARGS = dict(provider="aws_lambda", rate=4.0, n_tenants=2,
                      horizon_s=60.0, seed=0)
SERVE_SIM_ROW = {
    "requests": 212, "completed": 212,
    "lost": {"busy": 0, "cold_blocked": 0, "no_memory": 0},
    "loss_rate": 0.0, "ttft_p50_s": 0.01355,
    "ttft_p99_s": 0.26358000000000004, "makespan_s": 59.82481836156087,
    "tokens": 15845, "serverless_usd": 0.0033653867361297307,
    "provisioned_usd": 0.005650121734147417,
    "cost_per_token_usd": 3.565870453863942e-07, "peak_capacity": 8,
    "cold_starts": 5, "evictions": 0, "resizes": 0,
    "provider": "aws_lambda", "mode": "traffic-sim"}
#: Figs. 7-9 (``fig7_9_cost_performance``, ``run.py:305``) at the paper's
#: Table 1 row (seed 19, b0 4), its depth cut from 14 to 12: the row's
#: static pool runs at most 1,000 nodes a task, and its master settles
#: under 1,000 tasks a second, so depth 14 would take some 117,669 tasks
#: and minutes; at depth 13 the static pool ran 61,335 tasks in 95 s (on
#: an H100 machine) and the smoke overran its time; depth 12 is some
#: 15,000 tasks
FIG7_9_DEPTH = 12
#: the paper's figures beside the row: UTS serverless beats Spark (EMR) by
#: up to 55 % in price-performance at the same cost, and the dynamic
#: optimization gains 41 % in time
PAPER_SPARK_PCT = 55
PAPER_DYNAMIC_PCT = 41
#: open-loop serving at full width: the arrival rate is one a decode step
#: of 4 slots drains (about 33 ms a step), so the queue empties
OPEN_LOOP = dict(smoke=False, rate=4.0, n_tenants=2, arrival="mmpp",
                 n_requests=16, n_slots=4, max_seq=256)
#: the phase's files: spill files and artifacts (gitignored)
HARNESS_DIR = ROOT / "build" / "harness"


def silent_path(paths: dict, name: str, fn):
    """``run_path`` of a path that must launch no kernel at all (a replay,
    a fit, a host-only row); records its wall time under ``name``."""
    from repro_torch.kernels import launches
    out, wall, _ = run_path(name, "uts_expand", fn, required=False)
    fired = {k: launches(k) for k in KERNEL_SOURCES if launches(k)}
    if fired:
        raise AssertionError(f"{name}: launched {fired}; it runs no task "
                             f"body on the card")
    paths[name] = {"seconds": wall, "launches": {}}
    return out, wall


def trace_replay_row(dev, paths: dict) -> dict:
    """``trace_record_replay`` on the card at the row's own shapes: UTS
    depth 9 (chunk 2048, shape (32, 16)) on a 512-wide AWS Lambda sim pool
    recorded through a ``TraceStore`` with a 4,096-event ring (spilled
    under ``build/harness``), every body on the card; the Fig. 4
    artifacts from the traces; replays under the same provider, GCF and
    EWMA autoscaling (virtual bodies: no launch); and ``calibrate`` on a
    saturating ``lambda: 0`` workload of a known preset (no launch)."""
    from repro_torch.algorithms import UTSParams, uts_spec
    from repro_torch.core import (AutoscalePolicy, ProviderModel, TaskShape,
                                  make_pool, run_irregular)
    from repro_torch.trace import (TraceStore, calibrate, extract_workload,
                                   render_concurrency_figure, replay)

    p = UTSParams(seed=19, b0=4.0, max_depth=9, chunk=2048)
    prov = ProviderModel.aws_lambda()
    path = HARNESS_DIR / "trace_replay.jsonl"
    store = TraceStore(ring_size=4096, path=str(path))
    ewma_trace = TraceStore(ring_size=4096,
                            path=str(HARNESS_DIR / "trace_replay_ewma.jsonl"))
    try:
        def record():
            with make_pool("sim", max_concurrency=512, provider=prov,
                           trace=store) as pool:
                return run_irregular(pool, uts_spec(p, device=dev),
                                     shape=TaskShape(32, 16))
        rec, _ = chaos_path(paths, "trace_replay recorded (sim)",
                            "uts_expand", record)
        paths["trace_replay recorded (sim)"]["tasks"] = rec.tasks
        events_total = len(store)
        resident = store.resident_events

        def replays():
            wl = extract_workload(store, provider=prov)
            same = replay(wl, provider=prov, max_concurrency=512)
            gcf = replay(wl, provider=ProviderModel.gcf(),
                         max_concurrency=512)
            ewma = replay(wl, provider=prov, max_concurrency=512,
                          autoscale=AutoscalePolicy(
                              min_capacity=32, max_capacity=512,
                              ewma_alpha=0.5, grow_cooldown_s=0.05,
                              shrink_cooldown_s=0.05),
                          trace=ewma_trace)
            return wl, same, gcf, ewma
        (wl, r_same, r_gcf, r_ewma), replay_s = silent_path(
            paths, "trace_replay extract and three replays", replays)
        parity_pct = 100 * abs(r_same.makespan_s - rec.makespan_s) \
            / rec.makespan_s
        arts = render_concurrency_figure(
            {"recorded": store, "replay-ewma": ewma_trace},
            str(HARNESS_DIR / "fig4_trace_replay"))
    finally:
        store.close()
        ewma_trace.close()
    ascii_fig = Path(arts["txt"]).read_text()

    true = ProviderModel.aws_lambda(
        cold_start_s=0.4, warm_overhead_s=0.02, burst_concurrency=5,
        scaling_ramp_per_min=120.0)

    def fit_run():
        with make_pool("sim", max_concurrency=1000, provider=true) as cp:
            for f in [cp.submit(lambda: 0,
                                cost_hint=1000 + (i * 7919) % 49000)
                      for i in range(300)]:
                f.result()
            return calibrate(cp.events, name="fitted-aws")
    fit, _ = silent_path(paths, "trace_replay calibrate (sim)", fit_run)
    fit_ok = (abs(fit.cold_start_s - true.cold_start_s)
              <= 0.25 * true.cold_start_s
              and abs(fit.warm_overhead_s - true.warm_overhead_s)
              <= 0.25 * true.warm_overhead_s
              and abs(fit.scaling_ramp_per_min - true.scaling_ramp_per_min)
              <= 0.30 * true.scaling_ramp_per_min)
    if not (events_total >= 100_000 and resident <= 4096
            and r_same.tasks == rec.tasks == wl.n_tasks):
        raise AssertionError(f"trace_replay: {events_total} events, "
                             f"{resident} resident, {rec.tasks} tasks "
                             f"recorded, {r_same.tasks} replayed")
    row = {"nodes": rec.output, "tasks": rec.tasks,
           "events_total": events_total, "resident_events": resident,
           "recorded_vt_s": round(rec.makespan_s, 3),
           "recorded_usd": round(rec.cost.total, 6),
           "recorded_cold_starts": rec.cold_starts,
           "replay_same_vt_s": round(r_same.makespan_s, 3),
           "replay_parity_pct": round(parity_pct, 3),
           "replay_gcf_vt_s": round(r_gcf.makespan_s, 3),
           "replay_gcf_usd": round(r_gcf.cost.total, 6),
           "gcf_slowdown_pct": round(
               100 * (r_gcf.makespan_s / rec.makespan_s - 1), 1),
           "replay_ewma_vt_s": round(r_ewma.makespan_s, 3),
           "replay_ewma_usd": round(r_ewma.cost.total, 6),
           "ewma_resizes": len(r_ewma.autoscale_decisions),
           "fitted_cold_s": round(fit.cold_start_s, 4),
           "fitted_warm_ms": round(fit.warm_overhead_s * 1e3, 3),
           "fitted_ramp_per_min": round(fit.scaling_ramp_per_min, 1),
           "fit_within_tolerance": fit_ok,
           "figure_png": "png" in arts,
           "bounded_memory": resident <= 4096 < events_total}
    check_row("trace_record_replay", row, TRACE_REPLAY_ROW)
    path.unlink(missing_ok=True)
    (HARNESS_DIR / "trace_replay_ewma.jsonl").unlink(missing_ok=True)
    return {"row": row, "replay_s": replay_s,
            "virtual_s": {"recorded": rec.makespan_s,
                          "same": r_same.makespan_s,
                          "gcf": r_gcf.makespan_s,
                          "ewma": r_ewma.makespan_s},
            "artifacts": sorted(arts), "fig4_ascii": ascii_fig}


def scaled_controller():
    """The Listing-5 controller, its thresholds rescaled to a 16-worker
    pool (the reference benchmark's ``_scaled_controller``)."""
    from repro_torch.core import StagedController, TaskShape
    from repro_torch.core.adaptive import Stage
    return StagedController(initial=TaskShape(32, 500), stages=[
        Stage(8, "above", TaskShape(8, 4000)),
        Stage(13, "above", TaskShape(2, 8000)),
        Stage(11, "below", TaskShape(2, 4000)),
        Stage(2, "below", TaskShape(2, 1500))])


def fig7_9_row(dev, paths: dict, depth: int) -> dict:
    """Figs. 7-9's cost-performance row on the card at UTS seed 19, b0 4,
    ``depth``: the elastic pool at shape (4, 1000), the elastic pool under
    the Listing-5 controller from (32, 500), and a 2-thread local pool
    (the VM) at (4, 4000), all bodies on the card from worker threads.
    Times are the card machine's wall clock; dollars are the cost model's
    bill of those times."""
    from repro_torch.algorithms import UTSParams, uts_sequential, uts_spec
    from repro_torch.core import (TaskShape, VMPrice, emr_cluster_cost,
                                  make_pool, price_performance,
                                  run_irregular, serverless_cost, vm_cost)

    p = UTSParams(seed=19, b0=4.0, max_depth=depth)
    want = uts_sequential(p, device=dev)
    if want != UTS_DEEP_NODES[depth]:
        raise AssertionError(f"fig7_9: uts_sequential counts {want} nodes "
                             f"at depth {depth}, not {UTS_DEEP_NODES[depth]}")

    def elastic(shape, **kw):
        def go():
            with make_pool("elastic", max_concurrency=16,
                           invoke_overhead=0.001,
                           invoke_rate_limit=None) as ex:
                t0 = time.monotonic()
                r = run_irregular(ex, uts_spec(p, device=dev), shape=shape,
                                  **kw)
                wall = time.monotonic() - t0
                return r, wall, serverless_cost(ex.records,
                                                wall_time_s=wall)
        return go

    def vm():
        with make_pool("local", max_concurrency=2, invoke_overhead=0.0) as ex:
            t0 = time.monotonic()
            r = run_irregular(ex, uts_spec(p, device=dev),
                              shape=TaskShape(4, 4000))
            return r, time.monotonic() - t0
    runs = {}
    for label, fn in (("static", elastic(TaskShape(4, 1000))),
                      ("dynamic", elastic(TaskShape(32, 500),
                                          controller=scaled_controller())),
                      ("vm", vm)):
        name = f"fig7_9 {label} UTS depth {depth}"
        runs[label], _ = chaos_path(paths, name, "uts_expand", fn)
        paths[name]["tasks"] = runs[label][0].tasks
    (r_st, wall_st, cost_st), (r_dy, wall_dy, cost_dy), (r_vm, wall_vm) = \
        runs["static"], runs["dynamic"], runs["vm"]
    counts = [r_st.output, r_dy.output, r_vm.output]
    if counts != [want] * 3:
        raise AssertionError(f"fig7_9: counts {counts}, uts_sequential "
                             f"{want}")
    cost_vm = vm_cost(wall_vm, VMPrice.named("c5.24xlarge"))
    cost_emr = emr_cluster_cost(wall_vm, workers=2)
    nodes = r_st.output

    def ppr(wall, cost):
        return price_performance(nodes / wall / 1e6, cost)
    row = {"nodes": nodes, "depth": depth,
           "serverless_static_s": wall_st, "serverless_dynamic_s": wall_dy,
           "vm_s": wall_vm,
           "tasks": {"static": r_st.tasks, "dynamic": r_dy.tasks,
                     "vm": r_vm.tasks},
           "controller_transitions": len(r_dy.controller_transitions),
           "dyn_vs_static_time_pct": 100 * (1 - wall_dy / wall_st),
           "dyn_extra_cost_pct": 100 * (cost_dy.total
                                        / max(cost_st.total, 1e-12) - 1),
           "usd": {"static": cost_st.total, "dynamic": cost_dy.total,
                   "vm": cost_vm.total, "emr": cost_emr.total},
           "ppr_static": ppr(wall_st, cost_st),
           "ppr_dynamic": ppr(wall_dy, cost_dy),
           "ppr_vm": ppr(wall_vm, cost_vm),
           "ppr_emr": ppr(wall_vm, cost_emr),
           "paper_spark_pct": PAPER_SPARK_PCT,
           "paper_dynamic_pct": PAPER_DYNAMIC_PCT}
    row["serverless_over_emr_pct"] = 100 * (
        max(row["ppr_static"], row["ppr_dynamic"]) / row["ppr_emr"] - 1)
    return row


def open_loop_serving(dev, paths: dict) -> dict:
    """``serve`` open loop at full width on the card (``OPEN_LOOP``): every
    request it submits must be answered; the timeline it spills to
    ``build/harness`` must replay to one root task a request.  Each decode
    step's wall time is read around ``TorchEngine.decode`` (it ends in a
    device-to-host copy, so the step has finished on the card)."""
    from repro_torch.launch.serve import TorchEngine, serve
    from repro_torch.trace import extract_workload, read_trace

    path = HARNESS_DIR / "serve_open_loop.jsonl"
    path.unlink(missing_ok=True)
    steps: list = []
    decode = TorchEngine.decode

    def timed(self, n_active):
        t0 = time.perf_counter()
        decode(self, n_active)
        steps.append(time.perf_counter() - t0)
    TorchEngine.decode = timed
    try:
        name = f"serve open loop {ARCH} (rate {OPEN_LOOP['rate']})"
        rep, wall, _ = run_path(name, "flash_attention_fwd", lambda: serve(
            ARCH, trace=str(path), device=dev, **OPEN_LOOP), required=False)
    finally:
        TorchEngine.decode = decode
    from repro_torch.kernels import launches
    paths[name] = {"seconds": wall, "launches": {
        "flash_attention_fwd": launches("flash_attention_fwd")}}
    if not rep["submitted"] or rep["requests"] != rep["submitted"]:
        raise AssertionError(f"open-loop serve: {rep['requests']} answered "
                             f"of {rep['submitted']} submitted")
    wl = extract_workload(read_trace(str(path)))
    if not len(wl.roots) == wl.n_tasks == rep["requests"] or wl.n_lost:
        raise AssertionError(f"open-loop serve trace: {len(wl.roots)} roots, "
                             f"{wl.n_tasks} tasks, {wl.n_lost} lost for "
                             f"{rep['requests']} requests")
    out = {k: rep[k] for k in ("submitted", "requests", "rounds", "wall_s",
                               "tokens", "tok_per_s", "ttft_p50",
                               "ttft_p99", "peak_slots",
                               "engine_decode_steps")}
    out.update(decode_steps=len(steps),
               decode_step_median_ms=1e3 * statistics.median(steps),
               trace_bytes=path.stat().st_size, trace_roots=len(wl.roots),
               open_loop=dict(OPEN_LOOP))
    path.unlink()
    return out


def serving_knee_row() -> dict:
    """``serving_knee`` through the port's ``traffic`` and ``trace`` at the
    row's shapes: a two-tenant stream (poisson chat, MMPP bursts, 60 s,
    seed 19) swept over 1-16x its rate on an 8-wide static pool; the SLO
    autoscaler against a static pool sized at its peak; the static knee
    run recorded and replayed open-loop.  Host only."""
    from repro_torch.core import ProviderModel
    from repro_torch.trace import TraceStore, extract_workload, replay
    from repro_torch.traffic import (ArrivalModel, EngineModel, LengthModel,
                                     ResidencyConfig, SLOAutoscalePolicy,
                                     TenantSpec, generate_stream, scale_rate,
                                     serve_open_loop)
    base = [
        TenantSpec("chat", ArrivalModel(kind="poisson", rate=2.0),
                   prompt_len=LengthModel(mean=100.0, sigma=0.9, lo=8,
                                          hi=1024),
                   decode_len=LengthModel(mean=48.0, sigma=0.7, lo=4,
                                          hi=512)),
        TenantSpec("burst", ArrivalModel(kind="mmpp", rate=0.5,
                                         burst_rate=6.0, calm_s=10.0,
                                         burst_s=3.0),
                   prompt_len=LengthModel(kind="pareto", mean=160.0,
                                          alpha=1.4, lo=8, hi=2048),
                   decode_len=LengthModel(mean=32.0, sigma=0.8, lo=4,
                                          hi=256)),
    ]
    engine = EngineModel(prefill_s_per_token=5e-4, decode_s_per_token=5e-3)
    prov = ProviderModel.aws_lambda()
    rescfg = ResidencyConfig(memory_capacity_mb=48 * prov.memory_mb,
                             max_per_tenant=32)
    horizon, seed, static_cap = 60.0, 19, 8

    def run(factor, **kw):
        stream = generate_stream(scale_rate(base, factor), horizon_s=horizon,
                                 seed=seed)
        return serve_open_loop(stream, engine=engine, provider=prov,
                               residency_cfg=rescfg, **kw)

    factors = (1, 2, 4, 8, 16)
    sweep = {f: run(f, capacity=static_cap) for f in factors}
    derived = {}
    for f, r in sweep.items():
        derived[f"x{f}_p99_ms"] = round(r.ttft_p99_s * 1e3, 2)
        derived[f"x{f}_loss_pct"] = round(100 * r.loss_rate, 2)
    base_p99 = sweep[factors[0]].ttft_p99_s
    knee = next((f for f in factors if sweep[f].ttft_p99_s > 2 * base_p99),
                factors[-1])
    knee_visible = sweep[factors[-1]].ttft_p99_s > 3 * base_p99
    deterministic = (run(knee, capacity=static_cap).as_dict()
                     == sweep[knee].as_dict())
    target = 2.0
    # the tests call this row alone, before any phase has made the folder
    HARNESS_DIR.mkdir(parents=True, exist_ok=True)
    slo_trace = TraceStore(ring_size=4096,
                           path=str(HARNESS_DIR / "knee_slo.jsonl"))
    rep_trace = TraceStore(ring_size=4096,
                           path=str(HARNESS_DIR / "knee_static.jsonl"))
    try:
        slo = run(knee, capacity=2, trace=slo_trace,
                  autoscale=SLOAutoscalePolicy(
                      min_capacity=2, max_capacity=256,
                      target_p99_ttft_s=target, headroom=0.5,
                      grow_cooldown_s=0.25, shrink_cooldown_s=2.0))
        static_peak = run(knee, capacity=max(slo.peak_capacity, 3))
        recorded = run(knee, capacity=static_cap, trace=rep_trace)
        wl = extract_workload(rep_trace)
        if not wl.open_loop:
            raise AssertionError("serving_knee: the serving trace carries no "
                                 "arrival offsets")
        replayed = replay(wl, max_concurrency=static_cap,
                          invoke_overhead=0.0)
    finally:
        slo_trace.close()
        rep_trace.close()
    parity_pct = 100 * abs(replayed.makespan_s - recorded.makespan_s) \
        / recorded.makespan_s
    cost_parity_pct = 100 * abs(replayed.cost.total
                                - recorded.serverless_usd) \
        / max(recorded.serverless_usd, 1e-12)
    slo_cheaper = (slo.provisioned_usd < static_peak.provisioned_usd
                   and slo.cost_per_token_usd
                   < static_peak.cost_per_token_usd)
    return dict(
        derived, knee_factor=knee, knee_rate_rps=round(2.5 * knee, 2),
        knee_p50_ms=round(sweep[knee].ttft_p50_s * 1e3, 2),
        knee_p99_ms=round(sweep[knee].ttft_p99_s * 1e3, 2),
        knee_loss_pct=round(100 * sweep[knee].loss_rate, 2),
        knee_cost_per_mtok_usd=round(sweep[knee].cost_per_token_usd * 1e6,
                                     4),
        slo_target_ms=round(target * 1e3, 1),
        slo_p99_ms=round(slo.ttft_p99_s * 1e3, 2),
        static_peak_p99_ms=round(static_peak.ttft_p99_s * 1e3, 2),
        slo_peak_capacity=slo.peak_capacity, slo_resizes=slo.resizes,
        slo_provisioned_usd=round(slo.provisioned_usd, 6),
        static_provisioned_usd=round(static_peak.provisioned_usd, 6),
        slo_cost_per_mtok_usd=round(slo.cost_per_token_usd * 1e6, 4),
        static_cost_per_mtok_usd=round(
            static_peak.cost_per_token_usd * 1e6, 4),
        slo_savings_pct=round(100 * (1 - slo.provisioned_usd / max(
            static_peak.provisioned_usd, 1e-12)), 1),
        replay_parity_pct=round(parity_pct, 3),
        cost_parity_pct=round(cost_parity_pct, 3),
        knee_visible=knee_visible, deterministic=deterministic,
        static_knee_violates_target=sweep[knee].ttft_p99_s > target,
        slo_holds_target=slo.ttft_p99_s <= target,
        slo_cheaper_than_static=slo_cheaper,
        replay_parity_ok=parity_pct <= 1.0 and cost_parity_pct <= 1.0)


def dag_pipeline_row() -> dict:
    """``dag_pipeline`` through the port's ``dag``: the three DAG families
    on a 32-wide sim pool, plain and fused, and on a 4-thread local pool;
    the sink values must agree.  Host only."""
    from repro_torch.core import make_pool, run_irregular
    from repro_torch.dag import (hyperparam_sweep_dag,
                                 iterative_mapreduce_dag, montage_dag)
    derived, identical = {}, True
    for key, mk, kw in (("montage", montage_dag, {"tiles": 32}),
                        ("sweep", hyperparam_sweep_dag,
                         {"configs": 16, "stages": 4}),
                        ("iter_mr", iterative_mapreduce_dag,
                         {"rounds": 5, "initial_width": 12})):
        with make_pool("sim", max_concurrency=32) as pool:
            plain = run_irregular(pool, mk(**kw))
        with make_pool("sim", max_concurrency=32) as pool:
            fused = run_irregular(pool, mk(**kw), batching=True)
        with make_pool("local", max_concurrency=4) as pool:
            wall = run_irregular(pool, mk(**kw))
        identical = identical and plain.output == fused.output == wall.output
        derived[f"{key}_nodes"] = plain.dag_nodes
        derived[f"{key}_critical_path"] = plain.critical_path_len
        derived[f"{key}_max_stage_width"] = max(plain.stage_widths)
        derived[f"{key}_vt_s"] = round(plain.makespan_s, 4)
        derived[f"{key}_vt_fused_s"] = round(fused.makespan_s, 4)
    derived["dag_identical_outputs"] = bool(identical)
    return derived


def faas_parallelism_row() -> dict:
    """``faas_parallelism`` through the port's ``dag.probe``: bursts up to
    512 wide against four provider presets, and ``fit_provider``
    recovering a known preset from a constant-width probe.  Host only."""
    import dataclasses
    from repro_torch.core import ProviderModel, make_pool
    from repro_torch.dag import run_parallelism_probe
    derived, monotone = {}, True
    for preset in ("aws_lambda", "gcf", "azure_functions", "prewarmed"):
        with make_pool("sim", max_concurrency=2048,
                       provider=getattr(ProviderModel, preset)()) as pool:
            prof = run_parallelism_probe(pool, max_width=512)
        monotone = monotone and prof.envelope_monotone()
        last = prof.bursts[-1]
        derived[f"{preset}_achieved_at_512"] = last.achieved
        derived[f"{preset}_ramp_latency_s"] = round(last.ramp_latency_s, 3)
        derived[f"{preset}_cold_share"] = round(last.cold_start_share, 3)
    derived["probe_envelope_monotone"] = bool(monotone)
    known = dataclasses.replace(ProviderModel.gcf(), name="probe-target",
                                burst_concurrency=8,
                                scaling_ramp_per_min=240.0, cold_start_s=0.3)
    with make_pool("sim", max_concurrency=1024, provider=known) as pool:
        prof = run_parallelism_probe(pool, max_width=256, start=256,
                                     repeats_at_max=10)
    fitted = prof.fit(base=known)
    derived["fit_burst"] = fitted.burst_concurrency
    derived["fit_ramp_per_min"] = round(fitted.scaling_ramp_per_min, 1)
    derived["fit_cold_s"] = round(fitted.cold_start_s, 4)
    derived["probe_fit_recovers"] = bool(
        abs(fitted.burst_concurrency - 8) <= 2
        and abs(fitted.scaling_ramp_per_min - 240.0) / 240.0 < 0.25
        and abs(fitted.cold_start_s - 0.3) / 0.3 < 0.25)
    return derived


def run_examples(dev, paths: dict) -> dict:
    """The three example twins through their ``main`` at their default
    sizes (UTS depth 10, Mariani-Silver 256² at dwell 96, BC R-MAT scale 8
    over 16 tasks), their printing sent to stderr; each asserts its own
    oracle, and each must launch its kernels."""
    import contextlib
    from repro_torch.examples import (betweenness_centrality,
                                      mandelbrot_render, quickstart)
    npy = HARNESS_DIR / "mandelbrot_dwell.npy"
    out = {}
    for name, kernel, fn in (
            ("quickstart", "uts_expand", lambda: quickstart.main(dev)),
            ("mandelbrot_render", "mandelbrot",
             lambda: mandelbrot_render.main(dev, out=str(npy))),
            ("betweenness_centrality", "bc_forward_level",
             lambda: betweenness_centrality.main(dev))):
        with contextlib.redirect_stdout(sys.stderr):
            res, wall = chaos_path(paths, f"example {name}", kernel, fn)
        res.pop("centrality", None)
        out[name] = {"seconds": wall, **res}
    npy.unlink(missing_ok=True)
    return out


def phase_harness(dev) -> dict:
    """Record, replay and calibrate; Figs. 7-9; open-loop serving; the
    traffic sim and the host-only rows; the three examples (phase 9 of the
    module docstring)."""
    from repro_torch.launch.serve import serve_traffic_sim
    t_phase = time.monotonic()
    HARNESS_DIR.mkdir(parents=True, exist_ok=True)
    paths: dict = {}
    out: dict = {"paths": paths}

    # 1: record -> replay -> calibrate
    t0 = time.monotonic()
    out["trace_record_replay"] = rec = trace_replay_row(dev, paths)
    rec["seconds"] = time.monotonic() - t0
    row = rec["row"]
    log("[harness] trace_record_replay on the card equals the JAX "
        "package's row: " + ", ".join(f"{k} {row[k]}"
                                      for k in TRACE_REPLAY_ROW)
        + f"; the three replays launched nothing ({rec['replay_s']:.3f} s); "
        f"{rec['seconds']:.1f} s")

    # 2: Figs. 7-9 at the paper's Table 1 row
    t0 = time.monotonic()
    out["fig7_9"] = row = fig7_9_row(dev, paths, FIG7_9_DEPTH)
    row["seconds"] = time.monotonic() - t0
    log(f"[harness] Figs. 7-9 at UTS depth {FIG7_9_DEPTH}: {row['nodes']} "
        f"nodes on each pool; wall static {row['serverless_static_s']:.3f} "
        f"s, dynamic {row['serverless_dynamic_s']:.3f} s, VM "
        f"{row['vm_s']:.3f} s; dynamic vs static "
        f"{row['dyn_vs_static_time_pct']:.1f} % time at "
        f"{row['dyn_extra_cost_pct']:+.2f} % cost (paper: "
        f"{PAPER_DYNAMIC_PCT} %); price-performance static "
        f"{row['ppr_static']:.0f}, dynamic {row['ppr_dynamic']:.0f}, VM "
        f"{row['ppr_vm']:.0f}, EMR {row['ppr_emr']:.0f} M nodes/s/$ "
        f"(serverless over EMR {row['serverless_over_emr_pct']:+.0f} %; "
        f"paper: UTS beats Spark by up to {PAPER_SPARK_PCT} %); "
        f"{row['seconds']:.1f} s")

    # 3: open-loop serving at full width, then the traffic sim
    t0 = time.monotonic()
    out["serve_open_loop"] = srv = open_loop_serving(dev, paths)
    srv["seconds"] = time.monotonic() - t0
    log(f"[harness] serve {ARCH} open loop at {OPEN_LOOP['rate']} req/s "
        f"({OPEN_LOOP['n_tenants']} tenants, {OPEN_LOOP['arrival']}): "
        f"{srv['requests']} of {srv['submitted']} answered, "
        f"{srv['tok_per_s']:.1f} tok/s, TTFT p50 {srv['ttft_p50']:.4f} s, "
        f"p99 {srv['ttft_p99']:.4f} s, decode step median "
        f"{srv['decode_step_median_ms']:.2f} ms over {srv['decode_steps']}; "
        f"its spilled trace ({srv['trace_bytes']} bytes) replays to "
        f"{srv['trace_roots']} root tasks")
    sim, _ = silent_path(paths, "serve_traffic_sim",
                         lambda: serve_traffic_sim(**SERVE_SIM_ARGS))
    check_row("serve_traffic_sim", sim, SERVE_SIM_ROW)
    out["serve_traffic_sim"] = sim
    log(f"[harness] serve_traffic_sim equals the JAX package's: "
        f"{sim['requests']} requests, TTFT p99 {sim['ttft_p99_s']} s, "
        f"makespan {sim['makespan_s']} virtual s, "
        f"${sim['provisioned_usd']} provisioned")

    # 4: the host-only rows
    for label, fn, want in (("serving_knee", serving_knee_row,
                             SERVING_KNEE_ROW),
                            ("dag_pipeline", dag_pipeline_row,
                             DAG_PIPELINE_ROW),
                            ("faas_parallelism", faas_parallelism_row,
                             FAAS_PARALLELISM_ROW)):
        got, wall = silent_path(paths, label, fn)
        check_row(label, got, want)
        out[label] = dict(got, seconds=wall)
        log(f"[harness] {label} equals the JAX package's row "
            f"({len(want)} values, {wall:.3f} s)")

    # 5: the example twins
    out["examples"] = ex = run_examples(dev, paths)
    log("[harness] examples: " + ", ".join(
        f"{k} {v['seconds']:.2f} s" for k, v in ex.items())
        + f"; quickstart {ex['quickstart']['nodes']} nodes, BC max abs "
        f"error {ex['betweenness_centrality']['max_abs_err']:.2e}")
    out["seconds"] = time.monotonic() - t_phase
    log(f"[harness] phase {out['seconds']:.1f} s")
    return out


# -- the model slice: gemma3-1b prefill, decode and serving ----------------------

#: the model path: gemma3-1b at full width; prefill_32k's sequence with the
#: batch cut from 32 to 1, then DECODE_STEPS tokens on from its cache
ARCH = "gemma3-1b"
PREFILL_S = 32_768
DECODE_STEPS = 32
#: whole-model comparison (kernel against plain version) and fixed shapes
MODEL_CMP_S = 4096
FIXED_S, FIXED_B = 4096, 2
#: serving: requests through the ElasticBatcher at full width
SERVE = dict(n_requests=16, n_slots=4, max_seq=256)
#: the whole-model check: 26 layers, each rounding its attention output to
#: bf16 (2**-8 relative) at another place in the two versions; in quadrature
#: about 2**-8 * sqrt(26) = 0.02 of the logits' scale, allowed three times
MODEL_REL_TOL = 2**-4
MODEL_MIN_COS = 0.999
#: float32 kernel check: the tolerance of the reference package's tests
F32_ATOL, F32_RTOL = 3e-5, 1e-4
#: bf16's unit roundoff: rounding to bf16 moves a value by at most this
#: share of its magnitude
BF16_U = 2**-8


def sdpa(q2, k2, v2, causal: bool, window):
    """``F.scaled_dot_product_attention`` on the kernel's operands: the
    yardstick ``library_ms``, timed only, never called by the port.  It
    takes one dtype, so operands of two are passed in the wider (and
    ``check_flash`` passes K and V repeated to the query heads)."""
    import torch
    import torch.nn.functional as F
    bhg, sq, d = q2.shape
    bhkv, skv, _ = k2.shape
    q4 = q2.view(bhkv, bhg // bhkv, sq, d)
    k4, v4 = k2.view(bhkv, 1, skv, d), v2.view(bhkv, 1, skv, v2.shape[-1])
    if window is None:
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                              scale=1.0, enable_gqa=True)
    qp = torch.arange(sq, device=q2.device)[:, None]
    kp = torch.arange(skv, device=q2.device)[None, :]
    band = (qp - kp) < window
    if causal:
        band &= qp >= kp
    return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=band,
                                          scale=1.0, enable_gqa=True)


def trap_rows(sq: int, window, tiles: tuple) -> "list":
    """Rows whose first live key tile in the kernel is wholly masked: the
    Pallas kernel's -1e30 arithmetic gives them p = 1 for that tile until a
    later tile's alpha = 0 wipes it out."""
    bq, bk = tiles
    if window is None:
        return []
    rows = []
    for r in range(sq):
        q_lo = r // bq * bq
        first_tile = max(0, q_lo - window + 1) // bk * bk
        if r - window + 1 > first_tile + bk - 1:
            rows.append(r)
    return rows


def flash_allowed(want, weight=None):
    """Per-element tolerance of the kernel against its plain version.

    float32 throughout (``weight`` None): the reference's 3e-5 + 1e-4
    |want|.  Where p is rounded to bf16 (v in bf16), each version rounds
    every p_j once, at another scale (the kernel before normalising, the
    plain version after), by at most BF16_U of it, and rounds its output
    once: so |got - want| <= BF16_U * (2 * A + |want| + |got|), with
    A = sum_j p_j |v_j| (``weight``, the plain version on |v| in float32).
    Solved for the error, plus the float32 term for the scores' sums."""
    w = want.float().abs()
    if weight is None:
        return F32_ATOL + F32_RTOL * w
    return 2 * BF16_U * (weight + w) / (1 - BF16_U) + F32_ATOL


def _agreement(q2, k2, v2, kw: dict) -> dict:
    """Kernel and plain version on these operands, held to
    ``flash_allowed``; the error, the share of the tolerance used and the
    typical sizes beside it."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (flash_attention_cuda,
                                                         kernel_tiles)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    got = flash_attention_cuda(q2, k2, v2, **kw)
    want = flash_attention_ref(q2, k2, v2, **kw)
    weight = None if v2.dtype == torch.float32 else flash_attention_ref(
        q2.float(), k2.float(), v2.float().abs(), **kw)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    allowed = flash_allowed(want, weight)
    trap = trap_rows(q2.shape[1], kw["window"], kernel_tiles())
    # medians over a strided sample of at most 2**24 values
    step = max(1, want.numel() // (1 << 24))
    rec = {"dtypes": f"{str(q2.dtype)[6:]} q/k, {str(v2.dtype)[6:]} v",
           "max_abs_err": float(diff.max()),
           "tolerance_used": float((diff / allowed).max()),
           "bad": int((diff > allowed).sum()),
           "median_abs_out": float(want.float().abs().flatten()[::step]
                                   .median()),
           "median_allowed": float(allowed.flatten()[::step].median()),
           "trap_rows": len(trap),
           "trap_rows_max_abs_err": float(diff[:, trap].max()) if trap
           else None}
    del got, want, weight, diff, allowed
    torch.cuda.empty_cache()
    return rec


def check_flash(q2, k2, v2, *, causal: bool, window, softcap=None,
                label: str, time_it: bool = True, reps: int = 10) -> dict:
    """The kernel against its plain version on these operands, with the
    tolerance of their dtypes (``flash_allowed``), and again with the
    operands cast to float32 through the kernel's float32 build at the
    reference's 3e-5 / 1e-4, which holds its logic tightly; times kernel,
    plain version and SDPA on the operands as given."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    kw = dict(causal=causal, window=window, softcap=softcap)
    as_given = _agreement(q2, k2, v2, kw)
    f32 = (as_given if torch.float32 == q2.dtype == v2.dtype else
           _agreement(q2.float(), k2.float(), v2.float(), kw))
    rec = {"label": label, "shape": f"q {list(q2.shape)}, k/v "
           f"{list(k2.shape)}, {as_given['dtypes']}",
           "causal": causal, "window": window, "softcap": softcap,
           "max_abs_err": as_given["max_abs_err"], "as_given": as_given,
           "float32": f32}
    for what, r in (("as given", as_given), ("in float32", f32)):
        log(f"[flash] {label}, {what} ({r['dtypes']}): max |err| "
            f"{r['max_abs_err']:.3e}, {r['tolerance_used']:.3f} of the "
            f"tolerance at worst; median |out| {r['median_abs_out']:.3e}, "
            f"median allowed {r['median_allowed']:.3e}; {r['trap_rows']} "
            f"rows with a wholly masked first tile (max |err| "
            f"{r['trap_rows_max_abs_err']})")
        if r["bad"]:
            raise AssertionError(f"flash_attention {label} {what}: kernel "
                                 f"differs from plain version beyond "
                                 f"tolerance on {r['bad']} values: {rec}")
    b_ms, b_by, flops = flash_bound(q2, k2, v2, causal, window)
    rec.update(bound_ms=b_ms, bound_by=b_by, flops=flops)
    if time_it:
        rec["ms"] = cuda_time_ms(lambda: flash_attention_cuda(q2, k2, v2, **kw),
                                 reps=reps)
        rec["plain_ms"] = cuda_time_ms(
            lambda: flash_attention_ref(q2, k2, v2, **kw), reps=reps)
        if softcap is None:
            wide = q2.dtype if q2.dtype == v2.dtype else torch.float32
            # K and V repeated to every query head beforehand: SDPA's
            # enable_gqa runs float32 in the math backend, which
            # materialises the [G, Sq, Skv] scores (128 GiB at jamba's
            # 32k layer), where equal heads take the memory-efficient one
            groups = q2.shape[0] // k2.shape[0]
            lq, lk, lv = (t.to(wide).repeat_interleave(
                1 if t is q2 else groups, dim=0) for t in (q2, k2, v2))
            rec["library_ms"] = cuda_time_ms(
                lambda: sdpa(lq, lk, lv, causal, window), reps=reps)
            rec["library_dtype"] = str(wide)[6:]
            del lq, lk, lv
        else:
            rec["library_ms"] = None
    log(f"[flash] {label}: {rec['shape']} causal={causal} window={window} "
        f"softcap={softcap}: kernel {rec.get('ms', float('nan')):.4f} ms, "
        f"plain {rec.get('plain_ms', float('nan')):.4f} ms, SDPA "
        f"{rec.get('library_ms')} ms ({rec.get('library_dtype')}), bound "
        f"{b_ms:.4f} ms ({b_by})")
    torch.cuda.empty_cache()
    return rec


def phase_flash_fixed(dev) -> list:
    """The kernel at gemma3-1b's attention shapes (G = 4 on one KV head,
    D = 256, bf16, S = 4096, batch 2): causal, window 512, a ragged S, and
    causal with the dtypes a bf16 model feeds it (float32 q and k, bf16 v);
    and one small float32 case with a soft-cap."""
    import numpy as np
    import torch
    rng = np.random.default_rng(5)

    def operands(bhkv, g, s, d, dtype):
        q = rng.standard_normal((bhkv * g, s, d), np.float32) * d ** -0.5
        k = rng.standard_normal((bhkv, s, d), np.float32)
        v = rng.standard_normal((bhkv, s, d), np.float32)
        return [torch.from_numpy(a).to(dev, dtype) for a in (q, k, v)]

    out = []
    for s, window, label in ((FIXED_S, None, "fixed causal"),
                             (FIXED_S, 512, "fixed window 512"),
                             (4000, None, "fixed ragged S"),
                             (FIXED_S, None, "fixed causal, float32 q/k")):
        q2, k2, v2 = operands(FIXED_B, 4, s, 256, torch.bfloat16)
        if "float32" in label:
            q2, k2 = q2.float(), k2.float()
        out.append(check_flash(q2, k2, v2, causal=True, window=window,
                               label=label))
    q2, k2, v2 = operands(2, 4, 1000, 64, torch.float32)
    out.append(check_flash(q2 * 8, k2, v2, causal=True, window=300,
                           softcap=5.0, label="float32 softcap",
                           time_it=False))
    return out


def device_busy(fn, label: str, groups: dict = None) -> dict:
    """Run ``fn`` once under ``torch.profiler`` (CPU and CUDA activities)
    and sum the device time of every kernel: the device's busy time in
    that window, its idle share of the window's wall time, the largest
    kernels by self device time, and with ``groups`` ({name: substrings})
    the device time of the kernels whose names hold one of a group's
    substrings.  The profiler slows the host side, so where the host sets
    the pace the idle share is an upper bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    # the device's own rows (kernels, copies, memsets), not the host ops
    # that launched them
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    rec = {"busy_ms": busy_ms, "profiled_wall_ms": wall * 1e3,
           "idle_share": 1 - busy_ms / (wall * 1e3),
           "device_calls": sum(e.count for e in events),
           "top": [{"kernel": e.key[:80], "ms": e.self_device_time_total
                    / 1e3, "calls": e.count} for e in top]}
    if groups:
        rec["groups_ms"] = {
            name: sum(e.self_device_time_total for e in events
                      if any(x in e.key for x in subs)) / 1e3
            for name, subs in groups.items()}
    log(f"[profile] {label}: device busy {busy_ms:.3f} ms in "
        f"{rec['device_calls']} kernels, wall under the profiler "
        f"{wall * 1e3:.3f} ms, idle share {rec['idle_share']:.3f}; "
        f"largest: " + "; ".join(
            f"{t['kernel'][:40]} {t['ms']:.3f} ms x{t['calls']}"
            for t in rec["top"][:4]) + "".join(
            f"; {n} {ms:.3f} ms ({ms / busy_ms:.3f} of busy)"
            for n, ms in rec.get("groups_ms", {}).items()))
    if busy_ms <= 0:
        raise AssertionError(f"{label}: the profiler saw no device time")
    return rec


def profile_model(cfg, params, batch: dict, step, arena_len: int,
                  label: str) -> dict:
    """Where the time goes: the prefill of ``batch`` again, warm (the
    path's run includes first-call costs), timed, then under the profiler;
    and four decode steps, ``step(t)`` for the arena's last four positions
    t, under the profiler."""
    import torch
    from repro_torch.models import prefill
    s = next(iter(batch.values())).shape[1]
    t1 = time.monotonic()
    prefill(cfg, params, batch)
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t1
    log(f"[model] {label} prefill S={s} again, warm: {warm_s:.3f} s, "
        f"{s / warm_s:.1f} tokens/s")
    prof = {"prefill": device_busy(lambda: prefill(cfg, params, batch),
                                   f"{label} prefill S={s}")}
    prof["prefill"]["warm_wall_ms"] = warm_s * 1e3

    def four_steps():
        for t in range(arena_len - 4, arena_len):
            step(t)

    prof["decode"] = device_busy(four_steps, f"{label} decode, 4 steps")
    return prof


def phase_model(dev) -> dict:
    """gemma3-1b at full width on the card: prefill of S = 32,768 through
    the flash kernel (launches counted, one global and one local layer's
    operands re-checked against the plain version), the whole model with
    kernel and plain version at S = 4096, decode on from the 32k cache, and
    the elastic serving loop."""
    import numpy as np
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import decode_step, init_params, prefill

    cfg = get_config(ARCH)
    if SHAPES["prefill_32k"].seq_len != PREFILL_S:
        raise AssertionError("prefill_32k's sequence is not PREFILL_S")
    rng = np.random.default_rng(7)
    with torch.inference_mode():
        t0 = time.monotonic()
        params = init_params(cfg, 0, device=dev)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        n_params = sum(t.numel() for _, t in _leaves(params))
        log(f"[model] {cfg.name}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {n_params} parameters (bf16), random weights "
            f"from seed 0 in {init_s:.3f} s")
        toks = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (1, PREFILL_S + DECODE_STEPS))
        ).to(dev)

        # -- the path: prefill ------------------------------------------
        torch.cuda.reset_peak_memory_stats()
        with OperandTap("flash_attention_fwd", k=1) as tap:
            (logits, cache), pre_s, n_pre = run_path(
                "prefill", "flash_attention_fwd",
                lambda: prefill(cfg, params, {"tokens": toks[:, :PREFILL_S]}))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if n_pre != cfg.n_layers:
            raise AssertionError(f"prefill: {n_pre} flash_attention_fwd "
                                 f"launches, want {cfg.n_layers}")
        if logits.shape != (1, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                                 f"finite")
        log(f"[model] prefill S={PREFILL_S} batch 1: {pre_s:.3f} s, "
            f"{PREFILL_S / pre_s:.1f} tokens/s, {n_pre} flash_attention_fwd "
            f"launches, peak memory {peak_gb:.2f} GB")

        # -- the kernel on the main path's own operands -----------------
        main_path = {}
        for (shapes, static), kept in sorted(tap.samples.items(),
                                             key=lambda kv: str(kv[0])):
            st = dict(static)
            kind = "global" if st["window"] is None else "local"
            (q2, k2, v2), _ = kept[0]
            main_path[kind] = check_flash(
                q2, k2, v2, causal=st["causal"], window=st["window"],
                softcap=st["softcap"], reps=3,
                label=f"prefill {kind} layer operands")
            main_path[kind]["launches"] = tap.seen[(shapes, static)]
        del tap, kept, q2, k2, v2
        if set(main_path) != {"global", "local"}:
            raise AssertionError(f"tapped {sorted(main_path)} layers")

        # -- the path: decode on from the 32k cache ---------------------
        arena_len = PREFILL_S + DECODE_STEPS
        arena = padded_cache(cache, arena_len)
        del cache
        nxt = torch.argmax(logits, dim=-1)[:, None]

        def decode_all():
            nonlocal nxt
            times = []
            for t in range(DECODE_STEPS):
                t1 = time.monotonic()
                lg, _ = decode_step(cfg, params, arena, {"tokens": nxt},
                                    torch.tensor([PREFILL_S + t], device=dev))
                nxt = torch.argmax(lg, dim=-1)[:, None]
                torch.cuda.synchronize()
                times.append(time.monotonic() - t1)
                if not bool(torch.isfinite(lg).all()):
                    raise AssertionError(f"decode step {t}: logits not finite")
            return times

        step_s, dec_s, n_dec = run_path("decode", "flash_attention_fwd",
                                        decode_all, required=False)
        log(f"[model] decode {DECODE_STEPS} tokens after the {PREFILL_S} "
            f"prefill (arena {arena_len}): {dec_s:.3f} s, median step "
            f"{statistics.median(step_s) * 1e3:.3f} ms, first "
            f"{step_s[0] * 1e3:.3f} ms, {n_dec} flash_attention_fwd "
            f"launches (the decode product is plain PyTorch)")
        # four decode steps rewrite the arena's last four rows
        prof = profile_model(cfg, params, {"tokens": toks[:, :PREFILL_S]},
                             lambda t: decode_step(
                                 cfg, params, arena, {"tokens": nxt},
                                 torch.tensor([t], device=dev)),
                             arena_len, cfg.name)
        del arena, logits

        # -- whole model, kernel against plain version ------------------
        cmp = compare_model(cfg, params, toks[:, :MODEL_CMP_S + 1], dev)
    del params
    torch.cuda.empty_cache()

    # -- the path: serving --------------------------------------------------
    rep, serve_s, n_srv = run_path(
        "serve", "flash_attention_fwd",
        lambda: serve(ARCH, smoke=False, seed=0, device=dev, **SERVE),
        required=False)
    if rep["requests"] != SERVE["n_requests"]:
        raise AssertionError(f"serve answered {rep['requests']} of "
                             f"{SERVE['n_requests']} requests")
    log(f"[serve] {ARCH} full width, {SERVE}: {rep['requests']} requests, "
        f"{rep['tokens']} tokens, {rep['engine_decode_steps']} decode steps, "
        f"{rep['rounds']} rounds, {rep['wall_s']:.3f} s in the batcher, "
        f"{rep['tok_per_s']:.1f} tok/s, p50 TTFT {rep['ttft_p50']:.3f} s, "
        f"{n_srv} flash_attention_fwd launches")
    torch.cuda.empty_cache()
    return {"prefill": {"seq": PREFILL_S, "batch": 1, "seconds": pre_s,
                        "tokens_per_s": PREFILL_S / pre_s,
                        "peak_memory_gb": peak_gb, "launches": n_pre,
                        "init_params_s": init_s, "n_params": n_params},
            "main_path_operands": main_path,
            "decode": {"steps": DECODE_STEPS, "arena": arena_len,
                       "seconds": dec_s, "step_ms": [t * 1e3 for t in step_s],
                       "median_step_ms": statistics.median(step_s) * 1e3,
                       "launches": n_dec},
            "whole_model": cmp, "profile": prof,
            "serve": {k: rep[k] for k in ("requests", "tokens", "rounds",
                                          "wall_s", "tok_per_s", "ttft_p50",
                                          "ttft_p99", "engine_decode_steps")}
            | {"seconds": serve_s, "launches": n_srv, **SERVE},
            "launches": {"prefill": n_pre, "decode": n_dec, "serve": n_srv}}


# -- the other families: MoE, MLA, the dense and frontend configs ------------

#: deepseek-moe-16b at full width and depth: the model path's prefill
#: (prefill_32k, batch cut to 1) and decode, and closed-loop serving
MOE_ARCH = "deepseek-moe-16b"
#: deepseek-v3-671b at full width, depth cut from 61 layers to one dense
#: MLA layer and one MoE MLA layer (the MTP head initialised)
MLA_ARCH = "deepseek-v3-671b"
MLA_PREFILL_S, MLA_DECODE_STEPS = 4096, 8
#: the capacity factor of the reference's consistency test, at which
#: compare_model holds decode against prefill where the config's own
#: capacity drops the last token's pairs
WIDE_CAPACITY = 16.0
#: the dense and frontend configs at full width, each cut to 2 layers
DENSE_FAMILIES = ("chatglm3-6b", "starcoder2-15b", "musicgen-medium",
                  "llava-next-mistral-7b")
DENSE_LAYERS, DENSE_PREFILL_S, DENSE_DECODE_STEPS = 2, 4096, 4


def family_inputs(cfg, n: int, dev, seed: int):
    """[1, n] token ids, or for a frontend stub [1, n, d_model] bf16
    embeddings, from ``seed``."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if cfg.frontend is None:
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))).to(dev)
    return torch.from_numpy(rng.standard_normal(
        (1, n, cfg.d_model), np.float32)).to(dev, torch.bfloat16)


#: the kernels whose launches every path of the model phases counts
MODEL_KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
                 "selective_scan", "selective_scan_bwd", "wkv6",
                 "wkv6_bwd")


def counted_path(name: str, fn, want: dict, paths: dict) -> tuple:
    """Drive one path with the launch counts set to 0 just before it and
    read just after (``MODEL_KERNELS``, each into
    ``paths[kernel][name]``); returns ``(result, seconds, counts)``.  Fails
    unless every kernel in ``want`` launched exactly that often."""
    import torch
    from repro_torch.kernels import launches, reset_launches
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    got = {k: launches(k) for k in MODEL_KERNELS}
    for k, n in got.items():
        paths.setdefault(k, {})[name] = n
    bad = {k: {"got": got[k], "want": n} for k, n in want.items()
           if got[k] != n}
    if bad:
        raise AssertionError(f"{name}: kernel launches {bad}")
    return out, wall, got


def model_paths(dev, cfg, prefill_s: int, decode_steps: int, paths: dict,
                want_prefill: dict, want_step: dict, taps: tuple = ()) -> dict:
    """One config on the card: random bf16 weights from seed 0 (drawn on
    the device leaf by leaf in float32, then cast); the prefill of
    ``prefill_s`` tokens with ``taps`` open (each kernel launching as
    ``want_prefill`` says; finite logits; peak memory and the MoE pairs
    dropped per layer); ``decode_steps`` decode steps on from its cache
    (the attention leaves padded), fed the seeded inputs, each launching
    as ``want_step`` says.  Records each path's launches in ``paths``
    (``counted_path``); returns the record with the weights, the inputs
    and the decode arena for the caller."""
    import contextlib
    import torch
    from repro_torch.models import decode_step, init_params, prefill
    name = cfg.name
    t0 = time.monotonic()
    params = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(t.numel() for _, t in _leaves(params))
    log(f"[model] {name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params} parameters (bf16; {cfg.param_count()} by the config's "
        f"count, which leaves out any MTP head), random weights from seed 0 "
        f"in {init_s:.3f} s")
    inputs = family_inputs(cfg, max(prefill_s + decode_steps,
                                    MODEL_CMP_S + 1), dev, seed=7)
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        for tap in taps:
            stack.enter_context(tap)
        moe = stack.enter_context(MoETap())
        (logits, cache), pre_s, n_pre = counted_path(
            f"{name} prefill", lambda: prefill(
                cfg, params, model_batch(cfg, inputs, 0, prefill_s)),
            want_prefill, paths)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if logits.shape != (1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name} prefill logits {tuple(logits.shape)} "
                             f"not finite")
    dropped = moe.dropped()
    log(f"[model] {name} prefill S={prefill_s} batch 1: {pre_s:.3f} s, "
        f"{prefill_s / pre_s:.1f} tokens/s, launches {n_pre}, peak memory "
        f"{peak_gb:.2f} GB" + (
            f"; pairs dropped at capacity per MoE layer {dropped} "
            f"({sum(dropped)} of {len(dropped) * prefill_s * cfg.moe.top_k})"
            if cfg.moe is not None else ""))
    del moe
    arena = padded_cache(cache, prefill_s + decode_steps)
    del cache

    def decode_all():
        times = []
        for t in range(prefill_s, prefill_s + decode_steps):
            t1 = time.monotonic()
            lg, _ = decode_step(cfg, params, arena,
                                model_batch(cfg, inputs, t, t + 1),
                                torch.tensor([t], device=dev))
            torch.cuda.synchronize()
            times.append(time.monotonic() - t1)
            if not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"{name} decode at {t}: logits not "
                                     f"finite")
        return times

    step_s, dec_s, n_dec = counted_path(
        f"{name} decode", decode_all,
        {k: n * decode_steps for k, n in want_step.items()}, paths)
    log(f"[model] {name} decode {decode_steps} steps on from the "
        f"{prefill_s} prefill: median step "
        f"{statistics.median(step_s) * 1e3:.3f} ms, first "
        f"{step_s[0] * 1e3:.3f} ms, launches {n_dec}")
    rec = {"n_params": n_params, "param_count": cfg.param_count(),
           "init_params_s": init_s,
           "prefill": {"seq": prefill_s, "batch": 1, "seconds": pre_s,
                       "tokens_per_s": prefill_s / pre_s,
                       "peak_memory_gb": peak_gb, "launches": n_pre,
                       "moe_dropped_pairs": dropped},
           "decode": {"steps": decode_steps, "seconds": dec_s,
                      "step_ms": [t * 1e3 for t in step_s],
                      "median_step_ms": statistics.median(step_s) * 1e3,
                      "launches": n_dec}}
    return {"rec": rec, "params": params, "inputs": inputs, "arena": arena}


def model_serve(dev, arch: str, paths: dict, want: dict) -> dict:
    """``serve(arch)`` at full width, closed loop (``SERVE``), as a path
    (``counted_path``): every request answered; ``want`` maps a kernel to
    its launches per engine decode step."""
    from repro_torch.launch.serve import serve
    rep, serve_s, n_srv = counted_path(
        f"{arch} serve",
        lambda: serve(arch, smoke=False, seed=0, device=dev, **SERVE), {},
        paths)
    if rep["requests"] != SERVE["n_requests"]:
        raise AssertionError(f"{arch} serve answered {rep['requests']} of "
                             f"{SERVE['n_requests']} requests")
    bad = {k: n_srv[k] for k, n in want.items()
           if n_srv[k] != n * rep["engine_decode_steps"]}
    if bad:
        raise AssertionError(f"{arch} serve: launches {bad} in "
                             f"{rep['engine_decode_steps']} decode steps, "
                             f"want {want} a step")
    log(f"[serve] {arch} full width, {SERVE}: {rep['requests']} requests, "
        f"{rep['tokens']} tokens, {rep['engine_decode_steps']} decode steps, "
        f"{rep['wall_s']:.3f} s in the batcher, {rep['tok_per_s']:.1f} tok/s,"
        f" p50 TTFT {rep['ttft_p50']:.3f} s, launches {n_srv}")
    return {k: rep[k] for k in (
        "requests", "tokens", "rounds", "wall_s", "tok_per_s", "ttft_p50",
        "ttft_p99", "engine_decode_steps")} | {"seconds": serve_s,
                                               "launches": n_srv, **SERVE}


def tapped_flash(tap, label: str, unpadded=None) -> dict:
    """The kernel against its plain version on the one set of operands the
    prefill's tap kept (all layers of these configs share a shape), timed.
    ``unpadded`` = (Dk, Dv) where the operands were zero-padded for the
    kernel (MLA): the bound is then taken on the unpadded work and SDPA,
    which takes Dk != Dv, timed on the unpadded operands, with the padded
    shape's bound beside them."""
    import torch
    ((shapes, static), kept), = tap.samples.items()
    st = dict(static)
    (q2, k2, v2), _ = kept[0]
    rec = check_flash(q2, k2, v2, causal=st["causal"], window=st["window"],
                      softcap=st["softcap"], reps=3, label=label)
    rec["launches"] = tap.seen[(shapes, static)]
    if unpadded is not None:
        dk, dv = unpadded
        uq, uk = (t[..., :dk].contiguous() for t in (q2, k2))
        uv = v2[..., :dv].float().contiguous()
        b_ms, b_by, flops = flash_bound(uq, uk, v2[..., :dv], st["causal"],
                                        st["window"])
        rec.update(padded_bound_ms=rec["bound_ms"], bound_ms=b_ms,
                   bound_by=b_by, flops=flops, unpadded=f"q.k {dk}, v {dv}")
        rec["library_ms"] = cuda_time_ms(
            lambda: sdpa(uq.float(), uk.float(), uv, st["causal"],
                         st["window"]), reps=3)
        log(f"[flash] {label}: unpadded (q.k {dk}, v {dv}) bound "
            f"{b_ms:.4f} ms ({b_by}), padded shape's bound "
            f"{rec['padded_bound_ms']:.4f} ms; SDPA on the unpadded operands "
            f"(float32) {rec['library_ms']:.4f} ms")
        del uq, uk, uv
    del q2, k2, v2, kept
    torch.cuda.empty_cache()
    return rec


def phase_model_families(dev) -> dict:
    """deepseek-moe-16b at full width and depth (prefill of 32,768 tokens,
    32 decode steps, the kernel on the prefill's own operands, a profiled
    prefill and decode, the whole model with kernel and plain version at
    S = 4096, and closed-loop serving), deepseek-v3-671b at full width cut
    to 2 layers (MLA through the flash kernel zero-padded; the absorbed
    decode), and the dense and frontend configs at full width cut to 2
    layers, each against the plain version."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Stage, decode_step
    t_phase = time.monotonic()
    paths: dict = {}
    out: dict = {"launches": paths}

    def run_model(cfg, prefill_s: int, decode_steps: int, tap=None):
        # every attention or MLA layer launches the flash kernel once in
        # prefill; decode runs no hand kernel
        return model_paths(dev, cfg, prefill_s, decode_steps, paths,
                           {"flash_attention_fwd": cfg.n_layers},
                           {"flash_attention_fwd": 0},
                           (tap,) if tap is not None else ())

    # -- deepseek-moe-16b, full width and depth --------------------------
    cfg = get_config(MOE_ARCH)
    with torch.inference_mode():
        tap = OperandTap("flash_attention_fwd", k=1)
        run = run_model(cfg, PREFILL_S, DECODE_STEPS, tap)
        params, inputs, arena = run["params"], run["inputs"], run["arena"]
        rec = run["rec"]
        rec["flash_global_layer"] = tapped_flash(
            tap, f"{MOE_ARCH} prefill layer operands")
        del tap
        rec["profile"] = profile_model(
            cfg, params, model_batch(cfg, inputs, 0, PREFILL_S),
            lambda t: decode_step(cfg, params, arena, model_batch(
                cfg, inputs, t, t + 1), torch.tensor([t], device=dev)),
            PREFILL_S + DECODE_STEPS, MOE_ARCH)
        del arena, run
        rec["whole_model"] = compare_model(
            cfg, params, inputs[:, :MODEL_CMP_S + 1], dev)
        rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del params, inputs
    torch.cuda.empty_cache()
    rec["serve"] = model_serve(dev, MOE_ARCH, paths,
                               {"flash_attention_fwd": 0})
    out[MOE_ARCH] = rec
    torch.cuda.empty_cache()

    # -- deepseek-v3-671b, full width, 2 layers ---------------------------
    full = get_config(MLA_ARCH)
    cfg = dataclasses.replace(full, stages=tuple(
        Stage(1, st.pattern) for st in full.stages))
    with torch.inference_mode():
        tap = OperandTap("flash_attention_fwd", k=1)
        run = run_model(cfg, MLA_PREFILL_S, MLA_DECODE_STEPS, tap)
        rec = run["rec"]
        if "mtp" not in run["params"]:
            raise AssertionError(f"{MLA_ARCH}: no MTP head initialised")
        rec["mtp_params"] = sum(t.numel() for _, t in
                                _leaves(run["params"]["mtp"]))
        rec["flash_mla_layer"] = tapped_flash(
            tap, f"{MLA_ARCH} prefill MLA layer operands "
            f"(zero-padded)", unpadded=(cfg.mla.qk_head_dim,
                                        cfg.mla.v_head_dim))
        del run["arena"]
        rec["whole_model"] = compare_model(
            cfg, run["params"], run["inputs"][:, :MODEL_CMP_S + 1], dev)
        del run
    rec["reduced"] = {"n_layers": [full.n_layers, cfg.n_layers],
                      "stages": "one dense MLA layer, one MoE MLA layer "
                                "(from 3 and 58)"}
    out[MLA_ARCH] = rec
    torch.cuda.empty_cache()

    # -- the dense and frontend configs, full width, 2 layers ---------------
    for arch in DENSE_FAMILIES:
        full = get_config(arch)
        cfg = dataclasses.replace(full, stages=(
            Stage(DENSE_LAYERS, full.stages[0].pattern),))
        with torch.inference_mode():
            run = run_model(cfg, DENSE_PREFILL_S, DENSE_DECODE_STEPS)
            rec = run["rec"]
            del run["arena"]
            rec["whole_model"] = compare_model(
                cfg, run["params"], run["inputs"][:, :MODEL_CMP_S + 1], dev)
            del run
        rec["reduced"] = {"n_layers": [full.n_layers, cfg.n_layers]}
        out[arch] = rec
        torch.cuda.empty_cache()
    out["seconds"] = time.monotonic() - t_phase
    log(f"[families] phase: {out['seconds']:.1f} s")
    return out


# -- the recurrent families: rwkv6 and the jamba hybrid ----------------------

#: rwkv6-1.6b at full width and depth (24 layers of RWKV-6 time and channel
#: mix, no attention): the model path's prefill and decode, and serving
RWKV_ARCH = "rwkv6-1.6b"
#: jamba-v0.1-52b at full width, depth cut from 4 periods of 8 layers to one
#: (7 Mamba layers and one attention layer; 4 MoE and 4 MLP FFNs)
JAMBA_ARCH = "jamba-v0.1-52b"
#: the scan kernels against their plain versions: held within this share of
#: the largest |output| (and |state|); they round alike and sum in the same
#: tree, so they are bit-equal, which the check reports
SCAN_REL_TOL = 1e-5
def scan_bound(name: str, args) -> tuple:
    """Least card time for one call of scan op ``name`` (forward or
    backward) on ``args``: its ``work`` formula (``kernels/{selective_scan,
    wkv6}/ops.py``: bytes read and written once, float operations a state
    value and step) at ``HBM_BW`` and ``PEAK_OPS_S``."""
    from repro_torch.kernels.dispatch import get_kernel
    flops, n_bytes = get_kernel(name).work(*args)
    return bound_ms(n_bytes, flops)


def check_scan(name: str, tap, label: str, reps: int = 3) -> dict:
    """A scan kernel against its plain version on the one set of operands
    the prefill's tap kept (a layer of the main path; the state as it was
    before the launch): ``check_scan_on``, with the tap's launches."""
    (kept,) = tap.samples.values()
    args, static = kept[0]
    rec = check_scan_on(name, args, static, label, reps)
    rec["launches"] = sum(tap.seen.values())
    return rec


def check_scan_on(name: str, args, static: dict, label: str,
                  reps: int = 3) -> dict:
    """A scan kernel against its plain version on these operands (the
    state last): the output and the final state within ``SCAN_REL_TOL``
    of the largest |value|; the kernel's CUDA-event time (median of
    ``reps``), the plain version's (one run, whose output is the one
    compared: a Python loop of some 8 launches a step), and the bound.
    No single PyTorch call computes either recurrence: no library time."""
    import torch
    from repro_torch.kernels.dispatch import dispatch
    *ops, state0 = args

    def run(state, backend):
        return dispatch(name, *ops, state, backend=backend, **static)

    st_r, st_k = state0.clone(), state0.clone()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    want, _ = run(st_r, "ref")
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    got, _ = run(st_k, "cuda")
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    s_err = float((st_k - st_r).abs().max())
    s_scale = float(st_r.abs().max())
    bit_equal = bool(torch.equal(got, want) and torch.equal(st_k, st_r))
    del got, want, st_r, st_k
    scratch = state0.clone()
    ms = cuda_time_ms(lambda: run(scratch, "cuda"), reps=reps)
    b_ms, b_by = scan_bound(name, args)
    shape = " ".join(f"{list(t.shape)}" for t in args)
    log(f"[recurrent] {label}: {name} {shape}: max |d out| {err:.3e} of "
        f"max |out| {scale:.3e}, max |d state| {s_err:.3e} of {s_scale:.3e} "
        f"(allowed {SCAN_REL_TOL:.0e} of each), bit-equal {bit_equal}; "
        f"kernel {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    if not (err <= SCAN_REL_TOL * scale and s_err <= SCAN_REL_TOL * s_scale):
        raise AssertionError(f"{label}: {name} disagrees with its plain "
                             f"version")
    del scratch
    return {"shape": shape, "max_abs_err": err, "max_abs_out": scale,
            "max_abs_err_state": s_err, "max_abs_state": s_scale,
            "rel_tol": SCAN_REL_TOL, "bit_equal": bit_equal, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def phase_recurrent_families(dev) -> dict:
    """rwkv6-1.6b at full width and depth (prefill of 32,768 tokens with a
    ``wkv6`` launch a layer and no flash launch, 32 decode steps, the
    kernel on a layer's own prefill operands against its plain version and
    bound, a profiled prefill and decode, the whole model with kernel and
    plain version at S = 4096, closed-loop serving) and jamba-v0.1-52b at
    full width cut to one period of 8 layers (prefill of 32,768 tokens with
    7 ``selective_scan`` launches and one flash launch, 32 decode steps,
    both kernels on the prefill's own operands, the whole model at
    S = 4096 with the MoE routing replayed)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Stage, decode_step
    t_phase = time.monotonic()
    paths: dict = {}
    out: dict = {"launches": paths}

    # -- rwkv6-1.6b, full width and depth --------------------------------
    cfg = get_config(RWKV_ARCH)
    # one wkv6 launch a layer, in prefill and in every decode step
    per_pass = {"wkv6": cfg.n_layers, "selective_scan": 0,
                "flash_attention_fwd": 0}
    with torch.inference_mode():
        tap = OperandTap("wkv6", k=1, clone=(5,))
        run = model_paths(dev, cfg, PREFILL_S, DECODE_STEPS, paths, per_pass,
                          per_pass, (tap,))
        params, inputs, arena = run["params"], run["inputs"], run["arena"]
        rec = run["rec"]
        rec["wkv6_layer"] = check_scan("wkv6", tap,
                                       f"{RWKV_ARCH} prefill layer operands")
        del tap
        rec["profile"] = profile_model(
            cfg, params, model_batch(cfg, inputs, 0, PREFILL_S),
            lambda t: decode_step(cfg, params, arena, model_batch(
                cfg, inputs, t, t + 1), torch.tensor([t], device=dev)),
            PREFILL_S + DECODE_STEPS, RWKV_ARCH)
        del arena, run
        rec["whole_model"] = compare_model(
            cfg, params, inputs[:, :MODEL_CMP_S + 1], dev)
        rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del params, inputs
    torch.cuda.empty_cache()
    # a slot carries its recurrent state from request to request, as the
    # reference's engine does
    rec["serve"] = model_serve(dev, RWKV_ARCH, paths, per_pass)
    out[RWKV_ARCH] = rec
    torch.cuda.empty_cache()

    # -- jamba-v0.1-52b, full width, one period ----------------------------
    full = get_config(JAMBA_ARCH)
    cfg = dataclasses.replace(full, stages=(
        Stage(1, full.stages[0].pattern),))
    pattern = cfg.stages[0].pattern
    n_mamba = sum(spec.mixer == "mamba" for spec in pattern)
    n_attn = sum(spec.mixer == "attn" for spec in pattern)
    with torch.inference_mode():
        stap = OperandTap("selective_scan", k=1, clone=(5,))
        ftap = OperandTap("flash_attention_fwd", k=1)
        run = model_paths(
            dev, cfg, PREFILL_S, DECODE_STEPS, paths,
            {"selective_scan": n_mamba, "wkv6": 0,
             "flash_attention_fwd": n_attn},
            {"selective_scan": n_mamba, "wkv6": 0,
             "flash_attention_fwd": 0}, (stap, ftap))
        rec = run["rec"]
        del run["arena"]
        rec["selective_scan_layer"] = check_scan(
            "selective_scan", stap, f"{JAMBA_ARCH} prefill Mamba layer "
            f"operands")
        rec["flash_attention_layer"] = tapped_flash(
            ftap, f"{JAMBA_ARCH} prefill attention layer operands")
        del stap, ftap
        rec["whole_model"] = compare_model(
            cfg, run["params"], run["inputs"][:, :MODEL_CMP_S + 1], dev)
        rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del run
    log(f"[recurrent] {JAMBA_ARCH}: peak memory {rec['peak_memory_gb']:.2f} "
        f"GB; not served: serve builds the registry's full config "
        f"({full.param_count()} parameters, "
        f"{full.param_count() * 2 / 1e9:.1f} GB in bf16), which does not fit "
        f"in this card's "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB")
    rec["reduced"] = {"n_layers": [full.n_layers, cfg.n_layers],
                      "stages": f"one period of {len(pattern)} layers (from "
                                f"{full.stages[0].n_periods}): {n_mamba} "
                                f"Mamba, {n_attn} attention; 4 MoE, 4 MLP"}
    rec["serve"] = {"skipped": "the full config does not fit on one card"}
    out[JAMBA_ARCH] = rec
    torch.cuda.empty_cache()
    out["seconds"] = time.monotonic() - t_phase
    log(f"[recurrent] phase: {out['seconds']:.1f} s")
    return out


# -- training: the flash backward kernel, gradients, a kill and a resume ------

#: gemma3-1b training at train_4k's sequence; the batch cut from 256 to 2:
#: at 4 the float32 logits and their gradient (4 x 4,096 x 262,144 x 4 bytes
#: = 17.2 GB each) do not fit beside the weights and AdamW's float32 moments
#: in 80 GB (a batch of 4 ran out of memory on the H100)
TRAIN_S, TRAIN_B = 4096, 2
#: the unbroken run's steps, and the step the first run is killed at
TRAIN_STEPS, KILL_AT = 12, 6
#: AdamW's defaults except the schedule's horizon (train()'s: total_steps =
#: TRAIN_STEPS, warmup max(1, 12 // 20) = 1) and this peak rate, the
#: reference driver's default
TRAIN_LR = 3e-4
TRAIN_DIR = ROOT / "build" / "train_ckpt"
#: the backward kernel against its plain version, each of dQ, dK, dV by its
#: largest |value|: where bf16 is among the operands the plain version
#: rounds p and dP to bf16 before its products (the kernel keeps them in
#: float32) and dP - Delta cancels, so one bf16 rounding (2**-8) grows a few
#: times; the same operands cast to float32, through the kernel's float32
#: build, within 1e-4 (float32 sums in other orders)
FLASH_BWD_TOL, FLASH_BWD_F32_TOL = 2**-5, 1e-4
#: the whole model's gradient, kernels against plain versions (bf16 weights,
#: 26 layers, each rounding its attention output and gradients at other
#: places): the loss within 1e-3 relative, the global gradient norm within
#: 1e-3, every leaf's gradient at a cosine of at least 0.999 (a sound run
#: read 1.7e-4 and 0.99967; tools/grad_gate_control.py reads a backward
#: that rounds p and dS to bf16 against the same limits)
GRAD_LOSS_RTOL, GRAD_NORM_RTOL, GRAD_MIN_COS = 1e-3, 1e-3, 0.999
#: deepseek-moe-16b at full width, 28 layers cut to its two stages' first
#: (one dense layer, one MoE layer), batch 1 of TRAIN_S, 3 steps
MOE_TRAIN_STEPS = 3
#: the train_lm twin's steps: its example's 200 cut to 100 for the smoke's
#: time, the fewest at which it asserts that the loss fell
TRAIN_LM_STEPS = 100


def sdpa_backward_ms(q2, k2, v2, dout, causal: bool, window) -> float:
    """The library yardstick: autograd through
    ``scaled_dot_product_attention`` in bf16 (K and V repeated to the query
    heads, as the forward's yardstick), its forward's time taken off."""
    import torch
    groups = q2.shape[0] // k2.shape[0]
    lq, lk, lv = (t.to(torch.bfloat16).repeat_interleave(
        1 if t is q2 else groups, dim=0).requires_grad_()
        for t in (q2, k2, v2))
    g = dout.to(torch.bfloat16)

    def both():
        out = sdpa(lq, lk, lv, causal, window)
        torch.autograd.grad(out, (lq, lk, lv), g.view(out.shape))

    def fwd():
        with torch.no_grad():
            sdpa(lq, lk, lv, causal, window)
    return cuda_time_ms(both, reps=5) - cuda_time_ms(fwd, reps=5)


def _bwd_rel_err(got, want) -> list:
    return [float((a.float() - b.float()).abs().max()
                  / b.float().abs().max().clamp_min(1e-30))
            for a, b in zip(got, want)]


def check_flash_bwd(args, static, label: str, time_it: bool = True) -> dict:
    """The backward kernel against autograd over the plain version on these
    operands (q2, k2, v2, o, dO, lse: what ``FlashAttention.backward`` gave
    it), as given and cast to float32; two launches bit-equal; with
    ``time_it``, kernel, plain and SDPA times (median of 5) and the bound."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_ref
    q2, k2, v2, o, dout, lse = args
    kw = {k: static[k] for k in ("causal", "window", "softcap")}
    got = flash_attention_bwd_cuda(*args, **kw)
    again = flash_attention_bwd_cuda(*args, **kw)
    want = flash_attention_bwd_ref(*args, **kw)
    torch.cuda.synchronize()
    deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
    bf16 = torch.bfloat16 in (q2.dtype, v2.dtype)
    err = _bwd_rel_err(got, want)
    finite = all(bool(torch.isfinite(t.float()).all()) for t in got)
    del got, again, want
    f = [t.float() for t in (q2, k2, v2)]
    o32, lse32 = flash_attention_cuda(*f, return_lse=True, **kw)
    err32 = _bwd_rel_err(
        flash_attention_bwd_cuda(*f, o32, dout.float(), lse32, **kw),
        flash_attention_bwd_ref(*f, o32, dout.float(), lse32, **kw))
    del f, o32, lse32
    rec = {"label": label, "shape": f"q {list(q2.shape)}, k/v "
           f"{list(k2.shape)}, {str(q2.dtype)[6:]} q/k, "
           f"{str(v2.dtype)[6:]} v", **kw,
           "rel_err_dq_dk_dv": err, "rel_err_float32": err32,
           "tolerance": FLASH_BWD_TOL if bf16 else FLASH_BWD_F32_TOL,
           "tolerance_float32": FLASH_BWD_F32_TOL,
           "max_abs_err": max(err), "deterministic": deterministic}
    log(f"[train] flash bwd {label}: {rec['shape']}: dQ, dK, dV max |err| "
        f"/ max |value| {', '.join(f'{e:.3e}' for e in err)} (allowed "
        f"{rec['tolerance']:.3e}); in float32 "
        f"{', '.join(f'{e:.3e}' for e in err32)} (allowed "
        f"{FLASH_BWD_F32_TOL:.0e}); two launches bit-equal: {deterministic}")
    if not (finite and max(err) <= rec["tolerance"]
            and max(err32) <= FLASH_BWD_F32_TOL and deterministic):
        raise AssertionError(f"flash_attention_bwd {label}: {rec}")
    b_ms, b_by, flops = flash_bwd_bound(q2, k2, v2, kw["causal"],
                                        kw["window"])
    floor, floor_two_pass = flash_bwd_floor(q2, k2, v2, kw["causal"],
                                            kw["window"])
    rec.update(bound_ms=b_ms, bound_by=b_by, flops=flops, floor_ms=floor,
               floor_two_pass_ms=floor_two_pass)
    if time_it:
        rec["ms"] = cuda_time_ms(
            lambda: flash_attention_bwd_cuda(*args, **kw), reps=5)
        rec["plain_ms"] = cuda_time_ms(
            lambda: flash_attention_bwd_ref(*args, **kw), reps=5)
        rec["library_ms"] = sdpa_backward_ms(q2, k2, v2, dout, kw["causal"],
                                             kw["window"]) \
            if kw["softcap"] is None else None
        log(f"[train] flash bwd {label}: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, SDPA backward "
            f"{rec['library_ms']} ms, bound {b_ms:.4f} ms ({b_by}), floor "
            f"in the products' types {floor:.4f} ms ({floor_two_pass:.4f} "
            f"with the dQ pass's recomputation)")
    torch.cuda.empty_cache()
    return rec


def lse_leaves_o(args, static) -> bool:
    """The forward kernel's output with the log-sum-exp on and off."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    kw = {k: static[k] for k in ("causal", "window", "softcap")}
    on, _ = flash_attention_cuda(*args, return_lse=True, **kw)
    off = flash_attention_cuda(*args, **kw)
    torch.cuda.synchronize()
    return bool(torch.equal(on, off))


def model_grads(cfg, params, batch, backend) -> tuple:
    """(loss, {leaf name: gradient}) of ``loss_fn`` on the card."""
    import torch
    from repro_torch.models import loss_fn
    named = list(_leaves(params))
    for _, t in named:
        t.requires_grad_(True)
    loss, _ = loss_fn(cfg, params, batch, backend=backend)
    grads = torch.autograd.grad(loss, [t for _, t in named],
                                allow_unused=True)
    out = {n: (g if g is not None else torch.zeros_like(t))
           for (n, t), g in zip(named, grads)}
    for _, t in named:
        t.requires_grad_(False)
    return float(loss.detach()), out


def grad_gap(kernel: tuple, plain: tuple) -> dict:
    """Two (loss, {leaf name: gradient}) results of ``model_grads``: the
    loss's relative gap, the global gradient norms and their relative gap,
    and the lowest cosine of a leaf's gradients."""
    import torch
    (loss_k, g_k), (loss_p, g_p) = kernel, plain
    norm = lambda g: float(torch.sqrt(sum(t.float().square().sum()
                                          for t in g.values())))
    cos = {}
    for n in g_k:
        a, b = g_k[n].float().flatten(), g_p[n].float().flatten()
        na, nb = float(a.norm()), float(b.norm())
        cos[n] = 1.0 if na == nb == 0.0 else float(a @ b) / max(na * nb,
                                                                1e-30)
    worst = min(cos, key=cos.get)
    rec = {"loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
           "grad_norm_kernel": norm(g_k), "grad_norm_plain": norm(g_p),
           "min_cosine": cos[worst], "min_cosine_leaf": worst,
           "leaves": len(cos)}
    rec["grad_norm_rel_err"] = abs(rec["grad_norm_kernel"]
                                   - rec["grad_norm_plain"]) \
        / rec["grad_norm_plain"]
    return rec


def compare_grads(cfg, params, batch, label: str = ARCH) -> dict:
    """``loss_fn`` and its gradients with the kernels (flash and the scans,
    forward and backward) against the plain versions forced, on the same
    weights."""
    t0 = time.monotonic()
    kernel = model_grads(cfg, params, batch, None)
    t1 = time.monotonic()
    rec = grad_gap(kernel, model_grads(cfg, params, batch, "ref"))
    rec["kernel_s"], rec["plain_s"] = t1 - t0, time.monotonic() - t1
    rec["batch"] = list(next(iter(batch.values())).shape)
    log(f"[train] {label} whole-model gradient {rec['batch']}, kernels vs "
        f"plain: loss "
        f"{rec['loss_kernel']:.6f} vs {rec['loss_plain']:.6f} "
        f"({rec['loss_rel_err']:.2e}, allowed {GRAD_LOSS_RTOL:.0e}); grad "
        f"norm {rec['grad_norm_kernel']:.6f} vs {rec['grad_norm_plain']:.6f} "
        f"({rec['grad_norm_rel_err']:.2e}, allowed {GRAD_NORM_RTOL}); lowest "
        f"leaf cosine {rec['min_cosine']:.6f} ({rec['min_cosine_leaf']}; "
        f"allowed >= {GRAD_MIN_COS}) over {rec['leaves']} leaves; kernels "
        f"{rec['kernel_s']:.1f} s, plain versions {rec['plain_s']:.1f} s")
    if not grad_gate_passes(rec):
        raise AssertionError(f"{label} whole-model gradient: {rec}")
    return rec


def grad_gate_passes(rec: dict) -> bool:
    return (rec["loss_rel_err"] <= GRAD_LOSS_RTOL
            and rec["grad_norm_rel_err"] <= GRAD_NORM_RTOL
            and rec["min_cosine"] >= GRAD_MIN_COS)


def train_flops(cfg, n_params: int, b: int, s: int) -> float:
    """A training step's model flops: 6 N per token (N every parameter, the
    tied table once, for the unembedding product) plus attention's live
    pairs, 12 Dh flops a pair and query head (q.k^T and p.v forward, twice
    that backward); recomputation (remat) not counted."""
    total = 6.0 * n_params * b * s
    for stage in cfg.stages:
        for spec in stage.pattern:
            a = spec.attn_override or cfg.attention
            if spec.mixer == "attn":
                total += stage.n_periods * b * a.n_heads * 12 * a.head_dim \
                    * live_pairs(s, s, True, a.sliding_window)
    return total


def _dir_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def train_kill_resume(dev, paths: dict) -> dict:
    """gemma3-1b at full width and depth: run (a) trains steps 0-5 of 12 and
    checkpoints at 6; run (b) resumes there and trains 6-11; run (c) trains
    0-11 unbroken.  Every step launches the forward kernel twice a layer
    (remat) and the backward once.  Then steps 0-5 once more through
    ``plan_cell``'s step, from the same weights, schedule and batches as
    ``train``'s: every op is deterministic (the gates above show it), so
    that state is the one (a) saved, and the checkpoint restored to the
    host must equal it bit for bit.  Two more steps of it are profiled."""
    import shutil
    import torch
    from repro_torch.checkpoint import restore_pytree
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.convert import _tensor
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import plan_cell
    from repro_torch.launch.train import checkpoint_tree, train
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    cfg = get_config(ARCH)
    per_step = {"flash_attention_fwd": 2 * cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers}
    want = lambda n: {k: v * n for k, v in per_step.items()}
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    kw = dict(smoke=False, global_batch=TRAIN_B, seq_len=TRAIN_S,
              peak_lr=TRAIN_LR, log_every=1, device=dev,
              total_steps=TRAIN_STEPS)
    rec: dict = {"batch": TRAIN_B, "seq": TRAIN_S, "peak_lr": TRAIN_LR,
                 "reduced": {"global_batch": [256, TRAIN_B]}}
    a, wall_a, _ = counted_path(f"{ARCH} train (a) steps 0-5", lambda: train(
        ARCH, steps=KILL_AT, ckpt_dir=str(TRAIN_DIR / "a"),
        ckpt_every=KILL_AT, **kw), want(KILL_AT), paths)
    ck = TRAIN_DIR / "a" / f"step_{KILL_AT}"
    rec["checkpoint_bytes"] = _dir_bytes(ck)
    rec["save_s"] = a["save_s"]
    log(f"[train] (a) {KILL_AT} steps in {wall_a:.3f} s; checkpoint "
        f"{rec['checkpoint_bytes'] / 1e9:.3f} GB saved in {a['save_s']:.3f} "
        f"s")
    b, wall_b, _ = counted_path(f"{ARCH} train (b) resume, steps 6-11",
                                lambda: train(ARCH, steps=TRAIN_STEPS,
                                              ckpt_dir=str(TRAIN_DIR / "a"),
                                              **kw),
                                want(TRAIN_STEPS - KILL_AT), paths)
    if (b["start_step"], b["steps"]) != (KILL_AT, TRAIN_STEPS - KILL_AT):
        raise AssertionError(f"resume: started at {b['start_step']}, ran "
                             f"{b['steps']} steps")
    rec["restore_s"] = b["restore_s"]
    torch.cuda.reset_peak_memory_stats()
    c, wall_c, _ = counted_path(f"{ARCH} train (c) unbroken, steps 0-11",
                                lambda: train(ARCH, steps=TRAIN_STEPS,
                                              ckpt_dir=str(TRAIN_DIR / "c"),
                                              **kw),
                                want(TRAIN_STEPS), paths)
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    losses = {"a": a["losses"], "b": b["losses"], "c": c["losses"]}
    rec["losses"] = losses
    finite = all(l == l and abs(l) != float("inf")
                 for run in losses.values() for _, l in run)
    c_loss = dict(c["losses"])
    resumed = [l for _, l in b["losses"]]
    unbroken = [c_loss[s] for s, _ in b["losses"]]
    rec["resume_max_abs_diff"] = max(abs(x - y) for x, y in
                                     zip(resumed, unbroken))
    rec["resume_bit_equal"] = resumed == unbroken
    rec["first_steps_bit_equal"] = [l for _, l in a["losses"]] == \
        [c_loss[s] for s, _ in a["losses"]]
    steps_s = [t for s, t in c["step_s"] if s > 0]
    rec["step_s_median"] = statistics.median(steps_s)
    rec["tokens_per_s"] = TRAIN_B * TRAIN_S / rec["step_s_median"]
    if not finite:
        raise AssertionError(f"non-finite training loss: {losses}")
    if not c_loss[TRAIN_STEPS - 1] < c_loss[0]:
        raise AssertionError(f"the loss did not fall: {c['losses']}")
    if not (rec["resume_bit_equal"] and rec["first_steps_bit_equal"]):
        raise AssertionError(f"the resumed run is not the unbroken run: "
                             f"{losses}")
    # (a)'s state once more, against its checkpoint; train()'s schedule
    opt_cfg = AdamWConfig(peak_lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                          warmup_steps=max(1, TRAIN_STEPS // 20))
    plan = plan_cell(cfg, ShapeSpec("train", TRAIN_S, TRAIN_B, "train"),
                     opt_cfg=opt_cfg, device=dev)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                                  global_batch=TRAIN_B))
    params = init_params(cfg, 0, device=dev)
    opt = init_opt_state(params, opt_cfg)
    for s in range(KILL_AT):
        plan.step(params, opt, data.batch(s))
    saved = checkpoint_tree(cfg, params, opt)
    t0 = time.monotonic()
    restored = restore_pytree(saved, str(ck), device="cpu")
    rec["restore_to_host_s"] = time.monotonic() - t0
    mismatched = [n for (n, s), (_, r) in zip(_leaves(saved), _leaves(restored))
                  if not torch.equal(_tensor(s, torch.device("cpu")), r)]
    rec["restored_bit_equal"] = not mismatched
    del saved, restored
    log(f"[train] checkpoint at step {KILL_AT} restored to the host in "
        f"{rec['restore_to_host_s']:.3f} s, bit-equal to the state of "
        f"{KILL_AT} steps replayed: {rec['restored_bit_equal']}")
    if mismatched:
        raise AssertionError(f"restored checkpoint differs: {mismatched[:5]}")
    n_params = sum(t.numel() for _, t in _leaves(params))
    rec["model_flops_per_step"] = train_flops(cfg, n_params, TRAIN_B,
                                              TRAIN_S)
    rec["mfu"] = rec["model_flops_per_step"] / rec["step_s_median"] \
        / PEAK_FLOPS
    rec["n_params"] = n_params
    rec["launches_per_step"] = per_step
    log(f"[train] {ARCH} B={TRAIN_B} S={TRAIN_S}: losses (c) "
        f"{[round(l, 4) for _, l in c['losses']]}; resumed steps 6-11 equal "
        f"the unbroken run's bit for bit: {rec['resume_bit_equal']} (max "
        f"|diff| {rec['resume_max_abs_diff']:.3e}); step {rec['step_s_median']:.4f} s "
        f"(median, first excluded), {rec['tokens_per_s']:.1f} tokens/s, "
        f"mfu {rec['mfu']:.4f} ({rec['model_flops_per_step']:.4e} flops a "
        f"step), peak {rec['peak_memory_gb']:.2f} GB")

    # where the step's time goes: two more steps under the profiler
    def two_steps():
        for s in (KILL_AT, KILL_AT + 1):
            plan.step(params, opt, data.batch(s))
    rec["profile"] = device_busy(
        two_steps, f"{ARCH} 2 train steps",
        groups={"flash_attention_bwd": ("flash_bwd_",),
                "flash_attention_fwd": ("flash_fwd_kernel",)})
    del params, opt, plan
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return rec


def train_moe(dev, paths: dict, tap, arch: str, cfg, n_steps: int,
              per_step: dict) -> dict:
    """``arch`` at full width, cut to ``cfg``'s layers (one of them MoE):
    ``n_steps`` train steps of 1 x 4,096, each launching ``per_step``'s
    kernels that often, with ``tap`` open; then the gradient of every
    expert that got pairs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import batch_to, plan_cell
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import AdamWConfig, init_opt_state
    params = init_params(cfg, 0, device=dev)
    opt_cfg = AdamWConfig(peak_lr=TRAIN_LR, total_steps=n_steps,
                          warmup_steps=1)
    opt = init_opt_state(params, opt_cfg)
    plan = plan_cell(cfg, ShapeSpec("train", TRAIN_S, 1, "train"),
                     opt_cfg=opt_cfg, device=dev)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                                  global_batch=1))
    metrics = []

    def steps():
        for s in range(n_steps):
            _, _, m = plan.step(params, opt, data.batch(s))
            metrics.append({k: float(v) for k, v in m.items()})
    with tap:
        counted_path(f"{arch} train, {cfg.n_layers} layers", steps,
                     {k: n * n_steps for k, n in per_step.items()}, paths)
    if not all(m.get("router_aux", 0.0) > 0
               and all(v == v and abs(v) != float("inf") for v in m.values())
               for m in metrics):
        raise AssertionError(f"{arch} train metrics: {metrics}")
    # every expert that got pairs gets a finite, non-zero gradient
    moe_block = next(p["ffn"] for spec, p in _blocks_of(cfg, params)
                     if spec.ffn == "moe")
    experts = [moe_block[k] for k in ("gate", "up", "down")]
    for t in experts:
        t.requires_grad_(True)
    with MoETap() as routing:
        loss, _ = loss_fn(cfg, params, batch_to(data.batch(n_steps), dev))
        grads = torch.autograd.grad(loss, experts)
    counts = MoETap._counts(routing.layers[0])
    got = counts > 0
    norms = torch.stack([g.float().flatten(1).norm(dim=1) for g in grads])
    ok = bool(torch.isfinite(norms).all()) and \
        bool((norms[:, got] > 0).all())
    rec = {"metrics": metrics, "experts_with_pairs": int(got.sum()),
           "experts": int(counts.numel()),
           "min_grad_norm_with_pairs": float(norms[:, got].min()),
           "reduced": {"n_layers": [get_config(arch).n_layers,
                                    cfg.n_layers]}}
    log(f"[train] {arch} {cfg.n_layers} layers, {n_steps} steps: losses "
        f"{[round(m['loss'], 4) for m in metrics]}, router_aux "
        f"{[round(m['router_aux'], 4) for m in metrics]}; "
        f"{rec['experts_with_pairs']} of {rec['experts']} experts got pairs, "
        f"their smallest gradient norm {rec['min_grad_norm_with_pairs']:.3e}")
    if not ok:
        raise AssertionError(f"{arch}: expert gradients {rec}")
    del params, opt, plan, grads
    torch.cuda.empty_cache()
    return rec


def _blocks_of(cfg, params):
    for si, stage in enumerate(cfg.stages):
        for period in params[f"stage{si}"]:
            for i, spec in enumerate(stage.pattern):
                yield spec, period[f"block{i}"]


# -- training the recurrent families: the scans' backward kernels ------------

#: each scan's backward kernel against autograd over its plain forward:
#: every gradient within this share of its largest |value| (all float32;
#: the two sum in other orders over up to 64 terms and thousands of steps)
SCAN_BWD_TOL = 1e-4
#: the recurrent configs' whole-model gradient, kernels against the plain
#: versions, at B 1 x 1,024 (the plain backward would take minutes at
#: 4,096), with float32 weights: with the configs' bf16 the gradient is
#: chaotic at float32 rounding's scale (tools/scan_grad_control.py: the
#: plain backward times 1 + 2**-23 noise misses the gate against itself)
GRAD_CHECK_S = 1024
#: rwkv6-1.6b's layers in that check: 4 of its 24 at full width (8 before
#: the dry-run phase; the plain backward over all 24 takes some 85 s;
#: training runs all 24 below)
GRAD_CHECK_RWKV_LAYERS = 4
#: rwkv6-1.6b trained at train_4k's 4,096, the batch cut from 256 to 4 (its
#: float32 logits and their gradient are 4.3 GB each), 8 steps
RWKV_TRAIN_B, RWKV_TRAIN_STEPS = 4, 8
#: jamba's blocks 3 and 4 (Mamba + MoE, attention + MLP) trained 3 steps
JAMBA_TRAIN_STEPS = 3


def _scan_fns(name: str) -> tuple:
    """(forward kernel wrapper, backward kernel wrapper, plain backward) of
    ``wkv6_bwd`` or ``selective_scan_bwd``."""
    if name == "wkv6_bwd":
        from repro_torch.kernels.wkv6.ops import (wkv6_bwd_cuda,
                                                  wkv6_bwd_ref, wkv6_cuda)
        return wkv6_cuda, wkv6_bwd_cuda, wkv6_bwd_ref
    from repro_torch.kernels.selective_scan.ops import (
        selective_scan_bwd_cuda, selective_scan_bwd_ref, selective_scan_cuda)
    return selective_scan_cuda, selective_scan_bwd_cuda, \
        selective_scan_bwd_ref


def check_scan_bwd(name: str, args, label: str, time_it: bool = True,
                   reps: int = 5) -> dict:
    """A scan's backward kernel on these operands (r, k, v, w, u, or xi,
    dt, bm, cm, a; the forward's checkpoints; the gradients of the output
    and of the final state) against autograd over its plain forward from
    the first checkpoint: each of the six gradients within
    ``SCAN_BWD_TOL`` of its largest |value|; two launches bit-equal; the
    forward kernel from the same state with its checkpoints on and off
    giving the same output and final state, and the same checkpoints.
    With ``time_it``, the kernel's CUDA-event time (median of ``reps``),
    the plain backward's (one run, whose output is the one compared:
    autograd over a Python loop, some 9-11 s at 4,096 steps) and the
    bound."""
    import torch
    fwd, bwd, plain = _scan_fns(name)
    *ops, ckpt, _, _ = args
    got = bwd(*args)
    again = bwd(*args)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    want = plain(*args)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
    err = _bwd_rel_err(got, want)
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    del got, again, want
    s_on, s_off = ckpt[:, :, 0].clone(), ckpt[:, :, 0].clone()
    out_on, _, ck_on = fwd(*ops, s_on, checkpoints=True)
    out_off, _ = fwd(*ops, s_off)
    torch.cuda.synchronize()
    forward_same = bool(torch.equal(out_on, out_off)
                        and torch.equal(s_on, s_off)
                        and torch.equal(ck_on, ckpt))
    del out_on, out_off, ck_on, s_on, s_off
    shape = " ".join(f"{list(t.shape)}" for t in args[:5])
    if not all(t.data_ptr() % 16 == 0 for t in ops):
        shape += " (unaligned)"
    rec = {"label": label, "shape": shape, "rel_err": err,
           "max_abs_err": max(err), "tolerance": SCAN_BWD_TOL,
           "deterministic": deterministic, "forward_bits_kept": forward_same}
    log(f"[train] {name} {label}: {shape}: gradients' max |err| / max "
        f"|value| {', '.join(f'{e:.2e}' for e in err)} (allowed "
        f"{SCAN_BWD_TOL:.0e}); two launches bit-equal {deterministic}; "
        f"forward bits with checkpoints on = off {forward_same}")
    if not (finite and max(err) <= SCAN_BWD_TOL and deterministic
            and forward_same):
        raise AssertionError(f"{name} {label}: {rec}")
    if time_it:
        rec["ms"] = cuda_time_ms(lambda: bwd(*args), reps=reps)
        rec["plain_ms"] = plain_ms
        rec["bound_ms"], rec["bound_by"] = scan_bound(name, args)
        rec["library_ms"] = None   # no PyTorch call computes the recurrence
        log(f"[train] {name} {label}: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.1f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), {rec['ms'] / rec['bound_ms']:.1f}x")
    torch.cuda.empty_cache()
    return rec


def _unaligned(t):
    """``t`` copied to a contiguous view 4 bytes past a 16-byte boundary,
    where the scan kernels stage with 4-byte copies."""
    import torch
    buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


#: the small shapes each backward kernel is checked at: S not a multiple
#: of 16 (and one that is), hd 16 and heads split over blocks, N 4, 8, 16,
#: channels past a block's 16, the last of each unaligned
SCAN_BWD_SMALL = {"wkv6_bwd": ((2, 37, 3, 16), (2, 32, 2, 16),
                               (1, 70, 2, 64), (3, 21, 5, 64)),
                  "selective_scan_bwd": ((2, 37, 200, 4), (1, 45, 130, 8),
                                         (2, 32, 64, 16), (3, 19, 200, 16))}


def scan_bwd_small(dev) -> dict:
    """Each backward kernel at ``SCAN_BWD_SMALL``'s shapes on operands from
    a seed: the forward kernel's own checkpoints, random gradients of the
    output and of the final state."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(11)
    rand = lambda *sh: torch.randn(*sh, device=dev, generator=gen)
    out = {}
    for name, shapes in SCAN_BWD_SMALL.items():
        fwd, _, _ = _scan_fns(name)
        for i, shape in enumerate(shapes):
            if name == "wkv6_bwd":
                b, s, h, hd = shape
                ops = [rand(b, s, h, hd) * 0.5 for _ in range(3)] + [
                    torch.exp(-torch.exp(rand(b, s, h, hd) - 2)),
                    rand(h, hd) * 0.1]
                state, dout = rand(b, h, hd, hd), rand(b, s, h, hd)
            else:
                b, s, di, n = shape
                ops = [rand(b, s, di),
                       torch.nn.functional.softplus(rand(b, s, di) - 2),
                       rand(b, s, n), rand(b, s, n),
                       -torch.arange(1, n + 1, device=dev,
                                     dtype=torch.float32).repeat(di, 1)]
                state, dout = rand(b, di, n), rand(b, s, di)
            if i == len(shapes) - 1:
                ops = [_unaligned(t) for t in ops]
                dout = _unaligned(dout)
            _, _, ckpt = fwd(*ops, state.clone(), checkpoints=True)
            args = (*ops, ckpt, dout, torch.randn_like(state))
            out[f"{name} {shape}"] = check_scan_bwd(
                name, args, f"{shape}", time_it=False)
    return out


def train_rwkv(dev, paths: dict, tap) -> dict:
    """rwkv6-1.6b at full width and depth: 8 steps of 4 x 4,096 through
    ``train`` (every step 48 ``wkv6`` and 24 ``wkv6_bwd`` launches: remat
    runs each layer's forward twice), the loss falling, ``tap`` (an
    ``OperandTap``) open around it; step 0's gradients taken twice,
    bit-equal; two more steps under the profiler."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import batch_to, plan_cell
    from repro_torch.launch.train import train
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    cfg = get_config(RWKV_ARCH)
    per_step = {"wkv6": 2 * cfg.n_layers, "wkv6_bwd": cfg.n_layers,
                "selective_scan": 0, "selective_scan_bwd": 0,
                "flash_attention_fwd": 0, "flash_attention_bwd": 0}
    torch.cuda.reset_peak_memory_stats()
    with tap:
        run, wall, _ = counted_path(
            f"{RWKV_ARCH} train", lambda: train(
                RWKV_ARCH, smoke=False, steps=RWKV_TRAIN_STEPS,
                global_batch=RWKV_TRAIN_B, seq_len=TRAIN_S,
                peak_lr=TRAIN_LR, log_every=1, device=dev),
            {k: v * RWKV_TRAIN_STEPS for k, v in per_step.items()}, paths)
    rec = {"batch": RWKV_TRAIN_B, "seq": TRAIN_S, "steps": RWKV_TRAIN_STEPS,
           "losses": run["losses"], "wall_s": wall,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_step": per_step,
           "reduced": {"global_batch": [256, RWKV_TRAIN_B]}}
    losses = [l for _, l in run["losses"]]
    if not all(l == l and abs(l) != float("inf") for l in losses):
        raise AssertionError(f"{RWKV_ARCH}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{RWKV_ARCH}: the loss did not fall {losses}")
    rec["step_s_median"] = statistics.median(
        t for s, t in run["step_s"] if s > 0)
    rec["tokens_per_s"] = RWKV_TRAIN_B * TRAIN_S / rec["step_s_median"]
    torch.cuda.empty_cache()
    # step 0's gradients, twice, from the weights train() starts from
    params = init_params(cfg, 0, device=dev)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                                  global_batch=RWKV_TRAIN_B))
    batch = batch_to(data.batch(0), dev)
    first = model_grads(cfg, params, batch, None)
    second = model_grads(cfg, params, batch, None)
    rec["step0_loss"] = first[0]
    rec["step0_grads_bit_equal"] = first[0] == second[0] and all(
        torch.equal(first[1][n], second[1][n]) for n in first[1])
    del first, second
    if not rec["step0_grads_bit_equal"]:
        raise AssertionError(f"{RWKV_ARCH}: step 0's gradients differ")
    n_params = sum(t.numel() for _, t in _leaves(params))
    rec["n_params"] = n_params
    rec["model_flops_per_step"] = train_flops(cfg, n_params, RWKV_TRAIN_B,
                                              TRAIN_S)
    rec["mfu"] = rec["model_flops_per_step"] / rec["step_s_median"] \
        / PEAK_FLOPS
    log(f"[train] {RWKV_ARCH} B={RWKV_TRAIN_B} S={TRAIN_S}: losses "
        f"{[round(l, 4) for l in losses]}; step {rec['step_s_median']:.4f} "
        f"s (median, first excluded), {rec['tokens_per_s']:.1f} tokens/s, "
        f"mfu {rec['mfu']:.4f} ({rec['model_flops_per_step']:.4e} flops a "
        f"step), peak {rec['peak_memory_gb']:.2f} GB; step 0's gradients "
        f"taken twice bit-equal: {rec['step0_grads_bit_equal']}")
    opt_cfg = AdamWConfig(peak_lr=TRAIN_LR, total_steps=RWKV_TRAIN_STEPS,
                          warmup_steps=1)
    plan = plan_cell(cfg, ShapeSpec("train", TRAIN_S, RWKV_TRAIN_B, "train"),
                     opt_cfg=opt_cfg, device=dev)
    opt = init_opt_state(params, opt_cfg)

    def two_steps():
        for s in (0, 1):
            plan.step(params, opt, data.batch(s))
    rec["profile"] = device_busy(
        two_steps, f"{RWKV_ARCH} 2 train steps",
        groups={"wkv6_bwd": ("wkv6_bwd_",), "wkv6": ("wkv6_kernel",)})
    del params, opt, plan, batch
    torch.cuda.empty_cache()
    return rec


def train_recurrent(dev, paths: dict) -> dict:
    """The recurrent families' training on the card: (a) each scan's
    backward kernel on the operands its op was given while a model trained
    (an rwkv6-1.6b layer at B 4 x 4,096 from (c)'s steps; a jamba Mamba
    layer at B 1 x 4,096 from (d)'s), and at small ragged and unaligned
    shapes; (b) the whole-model gradient at B 1 x 1,024 with float32
    weights (``GRAD_CHECK_S``), kernels against ``backend="ref"``, of
    rwkv6-1.6b at full width cut to ``GRAD_CHECK_RWKV_LAYERS`` layers and
    of jamba at full width cut to its blocks 2 and 4 (Mamba + MLP,
    attention + MLP; no MoE block, whose routing flips between kernel and
    plain version); (c) rwkv6-1.6b trained (``train_rwkv``); (d) jamba at
    full width cut to its blocks 3 and 4 (Mamba + MoE, attention + MLP)
    trained 3 steps of 1 x 4,096."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Stage, init_params
    out: dict = {"kernel": {}}
    t0 = time.monotonic()
    # (b), rwkv6-1.6b cut to GRAD_CHECK_RWKV_LAYERS layers
    cfg = get_config(RWKV_ARCH)
    cfg = dataclasses.replace(cfg, dtype="float32", stages=tuple(
        Stage(GRAD_CHECK_RWKV_LAYERS, st.pattern) for st in cfg.stages))
    params = init_params(cfg, 0, device=dev)
    toks = family_inputs(cfg, GRAD_CHECK_S + 1, dev, seed=4)
    out[RWKV_ARCH] = {"grad": compare_grads(
        cfg, params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]},
        f"{RWKV_ARCH} {GRAD_CHECK_RWKV_LAYERS} layers, float32"),
        "grad_reduced": {"n_layers": [24, GRAD_CHECK_RWKV_LAYERS]}}
    del params
    torch.cuda.empty_cache()
    out["small"] = scan_bwd_small(dev)
    # (b), jamba's blocks 2 and 4
    full = get_config(JAMBA_ARCH)
    pattern = full.stages[0].pattern
    cfg = dataclasses.replace(full, dtype="float32", stages=(
        Stage(1, (pattern[2], pattern[4])),))
    params = init_params(cfg, 0, device=dev)
    toks = family_inputs(cfg, GRAD_CHECK_S + 1, dev, seed=5)
    out[JAMBA_ARCH] = {"grad": compare_grads(
        cfg, params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]},
        f"{JAMBA_ARCH} blocks 2, 4, float32"),
        "grad_reduced": {"stages": "blocks 2 and 4 of the 8-layer period: "
                                   "Mamba + MLP, attention + MLP"}}
    del params
    torch.cuda.empty_cache()
    # (c), and (a)'s rwkv6-1.6b layer: a wkv6_bwd launch of its steps
    tap = OperandTap("wkv6_bwd", k=1)
    out[RWKV_ARCH]["train"] = train_rwkv(dev, paths, tap)
    (args, _), = (x for v in tap.samples.values() for x in v)
    del tap
    out["kernel"]["wkv6_bwd"] = check_scan_bwd(
        "wkv6_bwd", args,
        f"{RWKV_ARCH} layer (B {RWKV_TRAIN_B}, S {TRAIN_S})")
    del args
    torch.cuda.empty_cache()
    # (d), jamba's blocks 3 and 4, its Mamba layer's backward tapped
    cfg = dataclasses.replace(full, stages=(Stage(1, pattern[3:5]),))
    tap = OperandTap("selective_scan_bwd", k=1)
    out[JAMBA_ARCH]["train"] = train_moe(
        dev, paths, tap, JAMBA_ARCH, cfg, JAMBA_TRAIN_STEPS,
        {"selective_scan": 2, "selective_scan_bwd": 1,
         "flash_attention_fwd": 2, "flash_attention_bwd": 1, "wkv6": 0,
         "wkv6_bwd": 0})
    out[JAMBA_ARCH]["train"]["reduced"] = {
        "stages": "blocks 3 and 4 of the 8-layer period: Mamba + MoE, "
                  "attention + MLP", "global_batch": [256, 1]}
    (args, _), = (x for v in tap.samples.values() for x in v)
    del tap
    out["kernel"]["selective_scan_bwd"] = check_scan_bwd(
        "selective_scan_bwd", args,
        f"{JAMBA_ARCH} Mamba layer (B 1, S {TRAIN_S})")
    del args
    torch.cuda.empty_cache()
    out["seconds"] = time.monotonic() - t0
    log(f"[train] recurrent families: {out['seconds']:.1f} s")
    return out


def phase_training(dev) -> dict:
    """Phase 13: the flash backward kernel on a training layer's own
    operands, the whole model's gradient against the plain versions,
    gemma3-1b trained with a kill and a resume, deepseek-moe-16b's MoE
    trained, the ``train_lm`` twin, and the recurrent families' training
    through the scans' backward kernels (``train_recurrent``)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Stage, init_params
    t_phase = time.monotonic()
    paths: dict = {}
    out: dict = {"launches": paths}
    cfg = get_config(ARCH)
    # -- the whole model's gradient at batch 1, the kernels' operands tapped
    params = init_params(cfg, 0, device=dev)
    toks = family_inputs(cfg, TRAIN_S + 1, dev, seed=3)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with OperandTap("flash_attention_bwd", k=1) as btap, \
            OperandTap("flash_attention_fwd", k=1) as ftap:
        out["whole_model_grad"] = compare_grads(cfg, params, batch)
    del params, batch
    torch.cuda.empty_cache()
    kernel = {}
    for (args, static) in (s for v in btap.samples.values() for s in v):
        which = "global" if static["window"] is None else "local"
        kernel[which] = check_flash_bwd(
            args, static, f"{ARCH} {which} layer (B 1, S {TRAIN_S})")
    out["lse_leaves_o"] = all(lse_leaves_o(args, static) for v in
                              ftap.samples.values() for args, static in v)
    log(f"[train] forward output bit-equal with the log-sum-exp on: "
        f"{out['lse_leaves_o']}")
    if not out["lse_leaves_o"] or set(kernel) != {"global", "local"}:
        raise AssertionError(f"flash forward with lse: {out['lse_leaves_o']}"
                             f", tapped layers {sorted(kernel)}")
    del btap, ftap
    # -- one float32 case (GQA, window and soft-cap) ---------------------
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    rng = np.random.default_rng(6)
    q2, k2, v2, dout = (torch.from_numpy(rng.standard_normal(
        sh, np.float32)).to(dev) for sh in ((8, 1000, 64), (2, 1000, 64),
                                           (2, 1000, 64), (8, 1000, 64)))
    static = dict(causal=True, window=300, softcap=5.0)
    q2 = q2 * 0.125
    o, lse = flash_attention_cuda(q2, k2, v2, return_lse=True, **static)
    kernel["float32"] = check_flash_bwd((q2, k2, v2, o, dout, lse), static,
                                        "float32 softcap", time_it=False)
    del q2, k2, v2, dout, o, lse
    # -- training -----------------------------------------------------------
    out["train"] = train_kill_resume(dev, paths)
    moe_tap = OperandTap("flash_attention_bwd", k=1)
    full = get_config(MOE_ARCH)
    moe_cfg = dataclasses.replace(full, stages=tuple(
        Stage(1, st.pattern) for st in full.stages))
    out["moe"] = train_moe(dev, paths, moe_tap, MOE_ARCH, moe_cfg,
                           MOE_TRAIN_STEPS, {
                               "flash_attention_fwd": 2 * moe_cfg.n_layers,
                               "flash_attention_bwd": moe_cfg.n_layers})
    args, static = next(s for v in moe_tap.samples.values() for s in v)
    kernel["moe"] = check_flash_bwd(args, static,
                                    f"{MOE_ARCH} layer (B 1, S {TRAIN_S})")
    del moe_tap, args
    torch.cuda.empty_cache()
    from repro_torch.examples import train_lm
    lm = train_lm.make_100m()
    lm_out, lm_wall, _ = counted_path(
        "train_lm twin", lambda: train_lm.main(dev, steps=TRAIN_LM_STEPS),
        {"flash_attention_fwd": 2 * lm.n_layers * TRAIN_LM_STEPS,
         "flash_attention_bwd": lm.n_layers * TRAIN_LM_STEPS}, paths)
    out["train_lm"] = {k: lm_out[k] for k in ("first_loss", "final_loss",
                                               "tok_per_s", "steps")}
    out["train_lm"]["wall_s"] = lm_wall
    torch.cuda.empty_cache()
    out["recurrent"] = train_recurrent(dev, paths)
    out["kernel"] = kernel
    out["seconds"] = time.monotonic() - t_phase
    log(f"[train] phase: {out['seconds']:.1f} s")
    return out


#: phase 14: train steps of gemma3-1b through the mesh path, and where its
#: checkpoint goes (deleted after)
MESH_STEPS = 3
MESH_DIR = ROOT / "build" / "mesh_ckpt"


class MoEApplyTap:
    """While open, records every ``moe_apply`` call of the model
    (``repro_torch.models.transformer``'s name for it): its parameters,
    input, dispatch and output; nothing syncs until read."""

    def __enter__(self) -> "MoEApplyTap":
        import repro_torch.models.transformer as tr
        self.module, self.fn, self.calls = tr, tr.moe_apply, []
        tr.moe_apply = self._apply
        return self

    def __exit__(self, *exc) -> None:
        self.module.moe_apply = self.fn

    def _apply(self, params, x, cfg, **kw):
        y, aux, counts = self.fn(params, x, cfg, **kw)
        self.calls.append({"params": params, "x": x, "cfg": cfg, "y": y,
                           "aux": aux, "dispatch": kw["dispatch"]})
        return y, aux, counts


def moe_block_twin(call: dict):
    """``moe_block_local`` with ``n_shards=1`` (plus the shared experts) on
    a tapped world-1 ``moe_apply`` call's own operands, at the per-expert
    capacity its dispatch used: the block's own for "replicated", the
    all-to-all's ``c_loc`` for "a2a" (at one shard ``c_send`` keeps every
    pair, and ``c_loc`` is the capacity over what arrived)."""
    import dataclasses
    from repro_torch.models.moe import moe_block_local, shared_expert_mlp
    cfg, x = call["cfg"], call["x"]
    b, s, d = x.shape
    if call["dispatch"] == "a2a":
        pairs = b * s * cfg.top_k
        c_send = max(4, int(pairs * cfg.capacity_factor + 0.999))
        c_loc = max(4, int(c_send * cfg.capacity_factor / cfg.n_experts
                           + 0.999))
        cfg = dataclasses.replace(cfg, capacity_factor=c_loc * cfg.n_experts
                                  / pairs)
    out, aux, _ = moe_block_local(call["params"], x.reshape(b * s, d), cfg,
                                  n_shards=1, shard_ix=0, tp_axis=None)
    out = out.reshape(b, s, d)
    if cfg.n_shared:
        out = out + shared_expert_mlp(call["params"]["shared"], x)
    return out, aux


def mesh_train(dev, mesh, paths: dict, training: dict) -> dict:
    """gemma3-1b at full width and depth, ``MESH_STEPS`` steps of 2 x 4,096
    through ``train(mesh=...)`` (``plan_cell(mesh, fsdp=True)``; every
    leaf of 2^20 elements or more FSDP-sharded over "data", gathered at use
    and reduce-scattered), from phase 13's seed and schedule: its losses
    against phase 13's unbroken run (c), its step time beside phase 13's
    (at a world of 1 the difference is the mesh path's own cost: the
    gathers' copies, the one-rank collectives, the vocab-parallel loss),
    peak memory; the checkpoint it saves at its last step restored with
    ``shardings=`` (the train loop's resume, ``restore_state``) and held bit
    for bit to the state of the same steps replayed through
    ``plan_cell``."""
    import shutil
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import plan_cell
    from repro_torch.launch.train import restore_state, train
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    cfg = get_config(ARCH)
    per_step = {"flash_attention_fwd": 2 * cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers}
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the earlier phases' objects are frozen out of the garbage collector's
    # passes, so the steps' times are the path's own; the time spent in
    # collections while they run is read all the same
    gc.collect()
    gc.freeze()
    gc_pass = {"s": 0.0, "n": 0}

    def on_gc(phase, info):
        if phase == "start":
            gc_pass["t0"] = time.perf_counter()
        elif "t0" in gc_pass:
            gc_pass["s"] += time.perf_counter() - gc_pass.pop("t0")
            gc_pass["n"] += 1
    gc.callbacks.append(on_gc)
    try:
        r, wall, _ = counted_path(
            f"{ARCH} train on a 1x1 mesh (fsdp)", lambda: train(
                ARCH, smoke=False, steps=MESH_STEPS, global_batch=TRAIN_B,
                seq_len=TRAIN_S, peak_lr=TRAIN_LR, log_every=1,
                total_steps=TRAIN_STEPS, mesh=mesh,
                ckpt_dir=str(MESH_DIR), ckpt_every=MESH_STEPS),
            {k: v * MESH_STEPS for k, v in per_step.items()}, paths)
    finally:
        gc.callbacks.remove(on_gc)
        gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() / 1e9
    meshless = dict(training["train"]["losses"]["c"])
    losses = [l for _, l in r["losses"]]
    want = [meshless[s] for s, _ in r["losses"]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    steps_s = [t for s, t in r["step_s"] if s > 0]
    rec = {"steps": MESH_STEPS, "losses": losses, "meshless_losses": want,
           "bit_equal": losses == want, "max_rel_diff": rel,
           "step_s": steps_s, "step_s_median": statistics.median(steps_s),
           "meshless_step_s_median": training["train"]["step_s_median"],
           "peak_memory_gb": peak,
           "meshless_peak_memory_gb": training["train"]["peak_memory_gb"],
           "save_s": r["save_s"], "wall_s": wall,
           "gc_s": gc_pass["s"], "gc_passes": gc_pass["n"],
           "launches_per_step": per_step}
    log(f"[mesh] {ARCH} B={TRAIN_B} S={TRAIN_S}, {MESH_STEPS} steps on a 1x1 "
        f"mesh over NCCL (fsdp): losses {losses}; phase 13's {want}; bit for "
        f"bit: {rec['bit_equal']} (max rel diff {rel:.3e}); step "
        f"{rec['step_s_median']:.4f} s (median, first excluded, of "
        f"{[round(t, 4) for t in steps_s]}) against "
        f"{rec['meshless_step_s_median']:.4f} s meshless; peak {peak:.2f} GB "
        f"against {rec['meshless_peak_memory_gb']:.2f}; checkpoint saved in "
        f"{r['save_s']:.3f} s; the host's garbage collector "
        f"{gc_pass['s']:.3f} s in {gc_pass['n']} passes")
    if not rec["bit_equal"]:
        raise AssertionError(f"mesh losses {losses} against {want}")

    # the same steps replayed, and the checkpoint restored with shardings
    opt_cfg = AdamWConfig(peak_lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                          warmup_steps=max(1, TRAIN_STEPS // 20))
    plan = plan_cell(cfg, ShapeSpec("custom", TRAIN_S, TRAIN_B, "train"),
                     mesh, opt_cfg=opt_cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                                  global_batch=TRAIN_B))
    params = init_params(cfg, 0, device=dev, ctx=plan.ctx)
    opt = init_opt_state(params, opt_cfg)
    replay = []
    for s in range(MESH_STEPS):
        _, _, m = plan.step(params, opt, data.batch(s))
        replay.append(float(m["loss"]))
    rec["replay_equal"] = replay == losses

    t0 = time.monotonic()
    cpu = torch.device("cpu")
    step, got_params, got_opt = restore_state(
        cfg, CheckpointManager(str(MESH_DIR)), None, None, cpu, plan.ctx)
    rec["restore_s"] = time.monotonic() - t0
    mismatched = [n for tree, got in ((params, got_params), (opt, got_opt))
                  for (n, a), (_, b) in zip(_leaves(tree), _leaves(got))
                  if not torch.equal(a.detach().to(cpu), b)]
    if step != MESH_STEPS:
        mismatched.append(f"step {step}")
    rec["restored_bit_equal"] = not mismatched
    log(f"[mesh] replayed through plan_cell(mesh): losses equal: "
        f"{rec['replay_equal']}; the checkpoint restored with shardings= "
        f"in {rec['restore_s']:.3f} s, bit-equal to the replayed state: "
        f"{rec['restored_bit_equal']}")
    if not rec["replay_equal"] or mismatched:
        raise AssertionError(f"mesh replay {replay} against {losses}; "
                             f"restored leaves differing {mismatched[:5]}")
    del got_params, got_opt
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    rec["counted_step"] = counted_mesh_step(
        dev, plan, params, opt, data.batch(MESH_STEPS), per_step, paths)
    del params, opt, plan
    torch.cuda.empty_cache()
    return rec


def counted_mesh_step(dev, plan, params, opt, batch, per_step: dict,
                      paths: dict) -> dict:
    """One more mesh step, untimed, counted op by op as it runs
    (``benchlib.op_analysis.analyze_step``: flops, bytes, transcendentals,
    each collective by kind, each kernel op by its work formula), with
    the peak memory of the step alone (``max_memory_allocated`` from
    ``reset_peak_memory_stats()``, nothing else of the phase live): what
    phase 15's dry run predicts.  The batch is on the card before the
    step, as the dry run's is."""
    import torch
    from repro_torch.benchlib.op_analysis import analyze_step
    from repro_torch.benchlib.roofline import analysis_block
    from repro_torch.launch.steps import batch_to
    batch = batch_to(batch, dev)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cost, wall, _ = counted_path(
        f"{ARCH} mesh step counted (phase 15)",
        lambda: analyze_step(plan.step, params, opt, batch), per_step, paths)
    loss = float(cost.result[2]["loss"])
    cost.result = None
    rec = {"analysis": analysis_block(cost),
           "argument_bytes": cost.argument_bytes,
           "counted_peak_bytes": cost.peak_bytes,
           "memory_allocated_before": before,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "loss": loss, "wall_s": wall, "op_records": len(cost.ops)}
    a = rec["analysis"]
    log(f"[mesh] one more step counted op by op ({wall:.2f} s with the "
        f"counter): {a['flops_per_device']:.6e} flops, "
        f"{a['bytes_per_device']:.6e} bytes, collectives {a['counts']}, "
        f"kernels {a['kernels']}; max_memory_allocated "
        f"{rec['max_memory_allocated'] / 1e9:.3f} GB (allocated before it "
        f"{before / 1e9:.3f} GB, its arguments "
        f"{cost.argument_bytes / 1e9:.3f} GB)")
    return rec


def mesh_moe(dev, mesh, paths: dict) -> dict:
    """deepseek-moe-16b at full width cut to 2 layers (one dense, one MoE, as
    phase 13 cuts it), through ``moe_apply`` under both dispatches
    (``FLAGS.moe_a2a`` off and on): one train step of 1 x 4,096 each (the
    replicated dispatch's loss against the meshless step's from the same
    weights), and a 4,096-token prefill each whose MoE layer's output is
    held to ``moe_block_local`` with ``n_shards=1`` on its own operands,
    at the capacity the dispatch used (bit for bit)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import plan_cell
    from repro_torch.models import Stage, init_params
    from repro_torch.models.flags import reset_flags, set_flags
    from repro_torch.optim import AdamWConfig, init_opt_state
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, stages=tuple(
        Stage(1, st.pattern) for st in full.stages))
    opt_cfg = AdamWConfig(peak_lr=TRAIN_LR, total_steps=1, warmup_steps=1)
    shape = ShapeSpec("custom", TRAIN_S, 1, "train")
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=TRAIN_S, global_batch=1)).batch(0)
    toks = {"tokens": torch.from_numpy(batch["tokens"]).to(dev)}
    step_want = {"flash_attention_fwd": 2 * cfg.n_layers,
                 "flash_attention_bwd": cfg.n_layers}
    pre_want = {"flash_attention_fwd": cfg.n_layers,
                "flash_attention_bwd": 0}
    rec: dict = {"reduced": {"n_layers": [full.n_layers, cfg.n_layers]}}

    def one_step(mesh_or_none, name):
        plan = plan_cell(cfg, shape, mesh_or_none, opt_cfg=opt_cfg,
                         device=dev)
        params = init_params(cfg, 0, device=dev, ctx=plan.ctx)
        opt = init_opt_state(params, opt_cfg)
        (_, _, m), wall, _ = counted_path(
            name, lambda: plan.step(params, opt, batch), step_want, paths)
        del params, opt
        torch.cuda.empty_cache()
        return float(m["loss"]), wall

    meshless, _ = one_step(None, f"{MOE_ARCH} 2 layers train step, "
                                 f"meshless")
    try:
        for dispatch in ("replicated", "a2a"):
            reset_flags()
            set_flags(moe_a2a=dispatch == "a2a")
            loss, wall = one_step(mesh, f"{MOE_ARCH} 2 layers train step, "
                                        f"1x1 mesh, {dispatch}")
            pre = plan_cell(cfg, ShapeSpec("p", TRAIN_S, 1, "prefill"), mesh)
            params = init_params(cfg, 0, device=dev, ctx=pre.ctx)
            with MoEApplyTap() as tap:
                (logits, _), pwall, _ = counted_path(
                    f"{MOE_ARCH} 2 layers prefill 4096, 1x1 mesh, "
                    f"{dispatch}", lambda: pre.step(params, toks), pre_want,
                    paths)
            call = tap.calls[0]
            with torch.no_grad():
                twin, twin_aux = moe_block_twin(call)
            out = {"loss": loss, "step_s": wall, "prefill_s": pwall,
                   "moe_calls": len(tap.calls), "dispatch_run":
                   call["dispatch"],
                   "moe_bit_equal": bool(torch.equal(call["y"], twin)),
                   "aux_bit_equal": bool(torch.equal(call["aux"], twin_aux)),
                   "finite": bool(torch.isfinite(logits).all())}
            if dispatch == "replicated":
                out["meshless_loss"] = meshless
                out["loss_bit_equal"] = loss == meshless
            rec[dispatch] = out
            log(f"[mesh] {MOE_ARCH} 2 layers, {dispatch} dispatch on a 1x1 "
                f"mesh: train step loss {loss:.6f}"
                + (f" (meshless {meshless:.6f}, bit for bit "
                   f"{out['loss_bit_equal']})" if dispatch == "replicated"
                   else "")
                + f", {wall:.3f} s; prefill 4096 {pwall:.3f} s, its MoE "
                f"layer ({call['dispatch']}) bit-equal to moe_block_local "
                f"(n_shards 1) on its operands: {out['moe_bit_equal']}, aux "
                f"{out['aux_bit_equal']}")
            del params, pre, tap, call, twin
            torch.cuda.empty_cache()
            if not (out["moe_bit_equal"] and out["aux_bit_equal"]
                    and out["finite"] and out["dispatch_run"] == dispatch
                    and loss == loss):
                raise AssertionError(f"mesh MoE {dispatch}: {out}")
            if dispatch == "replicated" and not out["loss_bit_equal"]:
                raise AssertionError(f"mesh MoE loss {loss} against the "
                                     f"meshless {meshless}")
    finally:
        reset_flags()
    return rec


#: phase 14's world-1 runs of the layers the model axis splits by heads or
#: channels (at a world of 1 the one rank holds every head and channel):
#: one train step of 1 x MESH_FAMILY_S and one prefill of as many tokens,
#: each meshless and through the 1 x 1 mesh, full width, depth cut
MESH_FAMILY_S = 4096
#: deepseek-v3-671b's routed experts in those runs, cut from 256: the
#: float32 moments of 256 experts' 11.3 B parameters do not fit the card
MESH_V3_EXPERTS = 16


def mesh_family_cfgs() -> dict:
    """{name: (config, train launches, prefill launches, what was cut)}:
    deepseek-v3-671b cut to one dense and one MoE MLA layer with its MTP
    head (which the loss runs: an MLA block outside remat), jamba's
    blocks 3 and 4 (Mamba + MoE, attention + MLP) and rwkv6-1.6b cut to 2
    layers.  Under full remat a period's forward runs twice a step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import Stage
    v3 = get_config(MLA_ARCH)
    v3 = dataclasses.replace(
        v3, stages=tuple(Stage(1, st.pattern) for st in v3.stages),
        moe=dataclasses.replace(v3.moe, n_experts=MESH_V3_EXPERTS))
    jamba = get_config(JAMBA_ARCH)
    jamba = dataclasses.replace(jamba, stages=(
        Stage(1, jamba.stages[0].pattern[3:5]),))
    rwkv = get_config(RWKV_ARCH)
    rwkv = dataclasses.replace(rwkv, stages=tuple(
        Stage(2, st.pattern) for st in rwkv.stages))
    none = {k: 0 for k in MODEL_KERNELS}
    return {
        MLA_ARCH: (v3, {**none, "flash_attention_fwd": 5,
                        "flash_attention_bwd": 3},
                   {**none, "flash_attention_fwd": 2},
                   {"n_layers": [61, 2], "n_experts": [256,
                                                        MESH_V3_EXPERTS]}),
        JAMBA_ARCH: (jamba, {**none, "selective_scan": 2,
                             "selective_scan_bwd": 1,
                             "flash_attention_fwd": 2,
                             "flash_attention_bwd": 1},
                     {**none, "selective_scan": 1,
                      "flash_attention_fwd": 1},
                     {"stages": "blocks 3 and 4 of the 8-layer period: "
                                "Mamba + MoE, attention + MLP"}),
        RWKV_ARCH: (rwkv, {**none, "wkv6": 4, "wkv6_bwd": 2},
                    {**none, "wkv6": 2}, {"n_layers": [24, 2]})}


def mesh_families(dev, mesh, paths: dict) -> dict:
    """The layers the model axis now splits by heads or channels (MLA with
    the MTP head, Mamba, RWKV-6's time mix), at full width and cut depth
    (``mesh_family_cfgs``), each through one train step and one prefill,
    meshless and then through ``plan_cell`` over the 1 x 1 mesh: the
    losses and the logits bit for bit."""
    import torch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import plan_cell
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    opt_cfg = AdamWConfig(peak_lr=TRAIN_LR, total_steps=1, warmup_steps=1)
    out = {}
    for arch, (cfg, want_train, want_pre, reduced) in \
            mesh_family_cfgs().items():
        t0 = time.monotonic()
        batch = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=MESH_FAMILY_S,
            global_batch=1)).batch(0)
        toks = {"tokens": torch.from_numpy(batch["tokens"]).to(dev)}
        got: dict = {}
        for where, m in (("meshless", None), ("1x1 mesh", mesh)):
            plan = plan_cell(cfg, ShapeSpec("custom", MESH_FAMILY_S, 1,
                                            "train"), m, opt_cfg=opt_cfg,
                             device=dev)
            params = init_params(cfg, 0, device=dev, ctx=plan.ctx)
            opt = init_opt_state(params, opt_cfg)
            (_, _, metrics), step_s, _ = counted_path(
                f"{arch} cut, train step, {where}",
                lambda: plan.step(params, opt, batch), want_train, paths)
            del params, opt, plan
            torch.cuda.empty_cache()
            pre = plan_cell(cfg, ShapeSpec("p", MESH_FAMILY_S, 1,
                                           "prefill"), m, device=dev)
            params = init_params(cfg, 0, device=dev, ctx=pre.ctx)
            (logits, _), pre_s, _ = counted_path(
                f"{arch} cut, prefill {MESH_FAMILY_S}, {where}",
                lambda: pre.step(params, toks), want_pre, paths)
            del params, pre
            torch.cuda.empty_cache()
            got[where] = {"loss": float(metrics["loss"]),
                          "metrics": {k: float(v) for k, v in
                                      metrics.items()},
                          "logits": logits, "step_s": step_s,
                          "prefill_s": pre_s}
        one, mine = got["meshless"], got["1x1 mesh"]
        rec = {"reduced": reduced,
               "losses": [one["loss"], mine["loss"]],
               "metrics": [one["metrics"], mine["metrics"]],
               "loss_bit_equal": one["loss"] == mine["loss"]
               and one["metrics"] == mine["metrics"],
               "logits_bit_equal": bool(torch.equal(one["logits"],
                                                    mine["logits"])),
               "finite": bool(torch.isfinite(mine["logits"]).all())
               and mine["loss"] == mine["loss"],
               "step_s": [one["step_s"], mine["step_s"]],
               "prefill_s": [one["prefill_s"], mine["prefill_s"]],
               "seconds": time.monotonic() - t0}
        del got, one, mine
        log(f"[mesh] {arch} ({reduced}), 1 x {MESH_FAMILY_S}: train step "
            f"loss {rec['losses'][1]:.6f} on the 1x1 mesh, "
            f"{rec['losses'][0]:.6f} meshless (bit for bit with every "
            f"metric: {rec['loss_bit_equal']}); prefill logits bit for bit: "
            f"{rec['logits_bit_equal']}; steps {rec['step_s'][0]:.3f} / "
            f"{rec['step_s'][1]:.3f} s, prefills {rec['prefill_s'][0]:.3f} / "
            f"{rec['prefill_s'][1]:.3f} s; {rec['seconds']:.1f} s in all")
        if not (rec["loss_bit_equal"] and rec["logits_bit_equal"]
                and rec["finite"]):
            raise AssertionError(f"mesh {arch}: {rec}")
        out[arch] = rec
    return out


#: a rank's share of each split layer at the production mesh's model axis
#: of 16: jamba's Mamba layer 512 of its 8,192 channels, rwkv6-1.6b 2 of
#: its 32 heads of 64, two query heads on one KV head of D 128 (glm4-9b,
#: chatglm3-6b, llava-next-mistral-7b, jamba's attention), three
#: (starcoder2-15b), deepseek-v3's MLA 8 of its 128 heads (q.k 192, v 128,
#: zero-padded to 256); at S 4,096 and B 2 (a rank's 16 sequences of
#: train_4k cut to 2), the scans' backward at S 1,024 (their plain
#: backward is autograd over a Python loop of S steps)
SHARE_B, SHARE_S, SHARE_BWD_S = 2, 4096, 1024
SHARE_MAMBA_DI, SHARE_MAMBA_N = 512, 16
SHARE_RWKV_H, SHARE_RWKV_HD = 2, 64
SHARE_GQA = {"gqa_2_on_1": 2, "gqa_3_on_1": 3}
SHARE_MLA_H, SHARE_MLA_DK, SHARE_MLA_DV, SHARE_MLA_PAD = 8, 192, 128, 256


def share_kernels(dev) -> dict:
    """Every model kernel at a rank's share of its layer (``SHARE_*``), on
    operands from a seed in the models' dtypes (float32 q and k after
    RoPE, bf16 v; the scans in float32), each held to its plain version
    under the tolerances of its other checks (``check_scan_on``,
    ``check_scan_bwd``, ``check_flash``, ``check_flash_bwd``), timed beside
    its bound from its op's ``work``; the launches each check made of the
    kernel (none of the main path's)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    t0 = time.monotonic()
    gen = torch.Generator(device=dev).manual_seed(29)
    rand = lambda *sh: torch.randn(*sh, device=dev, generator=gen)
    out: dict = {}

    def counted(key: str, kernel: str, fn):
        torch.cuda.synchronize()
        reset_launches()
        rec = fn()
        torch.cuda.synchronize()
        rec["launches"] = launches(kernel)
        if rec["launches"] <= 0:
            raise AssertionError(f"{key}: {kernel} did not launch")
        out[key] = rec

    def mamba_ops(s):
        b, di, n = SHARE_B, SHARE_MAMBA_DI, SHARE_MAMBA_N
        return [rand(b, s, di), F.softplus(rand(b, s, di) - 2),
                rand(b, s, n), rand(b, s, n),
                -torch.arange(1, n + 1, device=dev,
                              dtype=torch.float32).repeat(di, 1)], \
            rand(b, di, n)

    def rwkv_ops(s):
        b, h, hd = SHARE_B, SHARE_RWKV_H, SHARE_RWKV_HD
        return [rand(b, s, h, hd) * 0.5 for _ in range(3)] + [
            torch.exp(-torch.exp(rand(b, s, h, hd) - 2)),
            rand(h, hd) * 0.1], rand(b, h, hd, hd)

    # the scans, forward at S and backward at SHARE_BWD_S
    for name, ops_of, label in (
            ("selective_scan", mamba_ops,
             f"jamba Mamba layer, a rank's Di {SHARE_MAMBA_DI}"),
            ("wkv6", rwkv_ops, f"rwkv6-1.6b layer, a rank's "
                               f"{SHARE_RWKV_H} heads of {SHARE_RWKV_HD}")):
        ops, state = ops_of(SHARE_S)
        counted(name, name, lambda: check_scan_on(
            name, (*ops, state), {}, f"{label}, B {SHARE_B}"))
        ops, state = ops_of(SHARE_BWD_S)
        fwd, _, _ = _scan_fns(f"{name}_bwd")
        _, _, ckpt = fwd(*ops, state.clone(), checkpoints=True)
        dout = rand(*ops[0].shape)
        args = (*ops, ckpt, dout, torch.randn_like(state))
        counted(f"{name}_bwd", f"{name}_bwd", lambda: check_scan_bwd(
            f"{name}_bwd", args, f"{label}, B {SHARE_B}, S {SHARE_BWD_S}",
            reps=3))
        del ops, state, ckpt, dout, args
    # flash attention: GQA query heads on one KV head, and MLA's heads
    static = dict(causal=True, window=None, softcap=None)
    cases = [(key, g, 1, 128, 128, 128, f"{g} query heads on 1 KV head, "
              f"D 128") for key, g in SHARE_GQA.items()]
    cases.append(("mla", 1, SHARE_MLA_H, SHARE_MLA_DK, SHARE_MLA_DV,
                  SHARE_MLA_PAD, f"MLA, a rank's {SHARE_MLA_H} heads "
                  f"(q.k {SHARE_MLA_DK}, v {SHARE_MLA_DV}, padded to "
                  f"{SHARE_MLA_PAD})"))
    for key, g, hkv, dk, dv, d, label in cases:
        rows = SHARE_B * hkv
        q2 = F.pad(rand(rows * g, SHARE_S, dk) * dk ** -0.5, (0, d - dk))
        k2 = F.pad(rand(rows, SHARE_S, dk), (0, d - dk))
        v2 = F.pad(rand(rows, SHARE_S, dv), (0, d - dv)).to(torch.bfloat16)
        label = f"{label}, B {SHARE_B}"

        def fwd_check():
            rec = check_flash(q2, k2, v2, label=label, reps=3, **static)
            if d != dk:     # the bound on the unpadded work
                b_ms, b_by, flops = flash_bound(
                    q2[..., :dk], k2[..., :dk], v2[..., :dv], True, None)
                rec.update(padded_bound_ms=rec["bound_ms"], bound_ms=b_ms,
                           bound_by=b_by, flops=flops,
                           unpadded=f"q.k {dk}, v {dv}")
            return rec
        counted(f"flash_attention_fwd {key}", "flash_attention_fwd",
                fwd_check)
        o, lse = flash_attention_cuda(q2, k2, v2, return_lse=True, **static)
        dout = torch.randn(o.shape, device=dev, generator=gen).to(o.dtype)
        if d != dv:         # the gradient of the cut output columns is 0
            dout[..., dv:] = 0
        counted(f"flash_attention_bwd {key}", "flash_attention_bwd",
                lambda: check_flash_bwd((q2, k2, v2, o, dout, lse), static,
                                        label))
        if d != dk:
            rec = out[f"flash_attention_bwd {key}"]
            b_ms, b_by, flops = flash_bwd_bound(
                q2[..., :dk], k2[..., :dk], v2[..., :dv], True, None)
            rec.update(padded_bound_ms=rec["bound_ms"], bound_ms=b_ms,
                       bound_by=b_by, flops=flops,
                       unpadded=f"q.k {dk}, v {dv}")
        del q2, k2, v2, o, lse, dout
        torch.cuda.empty_cache()
    for key, rec in out.items():
        log(f"[mesh] a rank's share, {key}: {rec['shape']}: kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.3f} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
            f"{rec['ms'] / rec['bound_ms']:.1f}x; {rec['launches']} "
            f"launches in the check")
    out["seconds"] = time.monotonic() - t0
    log(f"[mesh] the kernels at a rank's share: {out['seconds']:.1f} s")
    return out


def phase_mesh(dev, training: dict) -> dict:
    """Phase 14: the mesh path on the card.  One card is a world of 1: a
    1 x 1 ("data", "model") mesh over NCCL (``make_host_mesh``), which runs
    every line of the path (the process groups, the FSDP gathers and
    reduce-scatters, the model axis's all-reduces, the vocab-parallel loss,
    the MoE all-to-all) on one rank; worlds of 2 and 4 are the CPU tests'
    (``tests/test_torch_mesh.py``, gloo).  ``mesh_train``, ``mesh_moe``,
    ``mesh_families`` (MLA, Mamba and RWKV-6 through the split path), and
    ``share_kernels`` (each kernel at a rank's share of the production
    mesh's model axis of 16)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    t_phase = time.monotonic()
    paths: dict = {}
    out: dict = {"launches": paths, "world": 1, "mesh": "1x1 (data, model)",
                 "backend": "nccl"}
    # NCCL's bootstrap on the loopback device: a world of 1 needs no other
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    mesh = make_host_mesh(1, 1)
    try:
        out["train"] = mesh_train(dev, mesh, paths, training)
        out["moe"] = mesh_moe(dev, mesh, paths)
        out["families"] = mesh_families(dev, mesh, paths)
    finally:
        dist.destroy_process_group()
    out["shares"] = share_kernels(dev)
    out["seconds"] = time.monotonic() - t_phase
    log(f"[mesh] phase: {out['seconds']:.1f} s")
    return out


# -- the dry run held to the card ------------------------------------------------

#: phase 15's dry runs write their records here
DRYRUN_DIR = ROOT / "build" / "dryrun"
#: the collectives one gemma3-1b mesh step runs at a world of 1 as the
#: trace of ``tools/mesh_step_profile.py`` counts them: all-gathers,
#: reduce-scatters, all-reduces, 674 in all
MESH_STEP_COLLECTIVES = {"all_gather": 306, "reduce_scatter": 154,
                         "all_reduce": 214}
#: the dry run's peak (this rank's arguments + temp) against the step's
#: max_memory_allocated
PEAK_REL_TOL = 0.15


def start_dry_runs():
    """Phase 15's two dry runs, started right after the build in processes
    of their own: they need no card, and run on the host's spare cores
    beside phases 3 and 6, whose times are the card's (CUDA events); the
    run waits for them (``wait_dry_runs``) before the host-bound phases.
    The dry run of phase 14's counted step (gemma3-1b, 2 x 4,096, a 1 x 1
    mesh, FSDP, full remat), and the production cell gemma3-1b
    ``train_4k`` on pod256 (a fake world of 256 on this host's torch).
    Returns the function that waits for their records."""
    import shutil
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import start_cells
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    return start_cells([
        dict(arch=ARCH, shape_name="train_4k", mesh_shape=(1, 1),
             shape=ShapeSpec("train_4k", TRAIN_S, TRAIN_B, "train"),
             out_dir=str(DRYRUN_DIR / "world1")),
        dict(arch=ARCH, shape_name="train_4k",
             out_dir=str(DRYRUN_DIR / "pod256"))], jobs=2)


def wait_dry_runs(dry_runs) -> dict:
    """The dry runs' records, and how long the run waited for them."""
    t0 = time.monotonic()
    world1, pod = dry_runs()
    waited = time.monotonic() - t0
    log(f"[roofline] the dry runs ended ({world1['process_s']:.1f} and "
        f"{pod['process_s']:.1f} s in their processes); waited {waited:.1f} s"
        f" for them after phase 6")
    return {"world1": world1, "pod256": pod, "waited_s": waited}


def phase_roofline(card: str, mesh: dict, dry: dict) -> dict:
    """Phase 15: the dry run (``launch/dryrun.py``) held to the card.  The
    dry run of phase 14's counted step (``start_dry_runs``) must equal the
    real step's count exactly (the same program, traced twice: on meta
    tensors over a fake process group, and on the card over NCCL), and its
    peak (arguments + temp) be within ``PEAK_REL_TOL`` of the step's
    ``max_memory_allocated``; the production cell must end "ok".  The
    roofline terms (datasheet peaks, ``repro_torch.benchlib``) are printed
    beside phase 14's measured median step, the collectives beside
    ``MESH_STEP_COLLECTIVES``."""
    t_phase = time.monotonic()
    real = mesh["train"]["counted_step"]
    world1, pod, waited_s = dry["world1"], dry["pod256"], dry["waited_s"]
    for rec in (world1, pod):
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {rec['arch']}/{rec['shape']}/"
                                 f"{rec.get('mesh')}: {rec.get('error')}")
    got, want = world1["analysis"], real["analysis"]
    if got != want:
        raise AssertionError("dry run against the counted step: " + "; ".join(
            f"{k} {got.get(k)} != {want[k]}" for k in want
            if got.get(k) != want[k]))
    mem = world1["memory_analysis"]
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    measured = real["max_memory_allocated"]
    rel = abs(predicted - measured) / measured
    log(f"[roofline] {card}: the dry run of {ARCH}'s mesh step (2 x "
        f"{TRAIN_S}, 1 x 1, fsdp) equals the step counted on the card: "
        f"{got['flops_per_device']:.6e} flops, "
        f"{got['bytes_per_device']:.6e} bytes, "
        f"{got['transcendentals']:.6e} transcendentals, kernels "
        f"{got['kernels']}, collectives {got['counts']}, link bytes "
        f"{got['link_bytes']:.6e}")
    log(f"[roofline] {card}: predicted peak {predicted / 1e9:.3f} GB "
        f"(arguments {mem['argument_size_in_bytes'] / 1e9:.3f} + temp "
        f"{mem['temp_size_in_bytes'] / 1e9:.3f}) against "
        f"max_memory_allocated {measured / 1e9:.3f} GB over the step: "
        f"{rel:.4f} off (allowed {PEAK_REL_TOL})")
    if rel > PEAK_REL_TOL:
        raise AssertionError(f"dry-run peak {predicted} against {measured}")
    counts = world1["analysis"]["counts"]
    log(f"[roofline] collectives a step: {counts} "
        f"({sum(counts.values())}) beside the profiled trace's "
        f"{MESH_STEP_COLLECTIVES} ({sum(MESH_STEP_COLLECTIVES.values())}); "
        f"equal: {counts == MESH_STEP_COLLECTIVES}")
    a = world1["analysis"]
    step_s = mesh["train"]["step_s_median"]
    top = max(a["compute_s"], a["memory_s"], a["collective_s"])
    log(f"[roofline] {card}: roofline terms of the step: compute "
        f"{a['compute_s']:.4f} s, memory {a['memory_s']:.4f} s, collective "
        f"{a['collective_s']:.4f} s -> {a['dominant']}-bound; phase 14's "
        f"median step {step_s:.4f} s ({step_s / top:.2f}x the largest)")
    b = pod["analysis"]
    log(f"[roofline] production cell {ARCH} train_4k on pod256 (a fake "
        f"world of 256, this host's torch): ok in {pod['total_s']} s; "
        f"compute {b['compute_s']:.4f} s, memory {b['memory_s']:.4f} s, "
        f"collective {b['collective_s']:.4f} s -> {b['dominant']}-bound "
        f"(H100 datasheet peaks); replicated layers "
        f"{pod['replicated_layers']}")
    out = {"card": card, "world1": world1, "pod256": pod,
           "counted_step": real, "equal": True,
           "predicted_peak_bytes": predicted,
           "max_memory_allocated": measured, "peak_rel_err": rel,
           "collectives_traced": MESH_STEP_COLLECTIVES,
           "collectives_equal_traced": counts == MESH_STEP_COLLECTIVES,
           "step_s_median": step_s, "waited_for_dry_runs_s": waited_s,
           "dry_runs_process_s": [world1["process_s"], pod["process_s"]]}
    out["seconds"] = time.monotonic() - t_phase + real["wall_s"]
    out["seconds"] += waited_s
    log(f"[roofline] phase: {out['seconds']:.1f} s on the run's path (the "
        f"counted step {real['wall_s']:.1f} s, in phase 14; {waited_s:.1f} s "
        f"waiting for the dry runs after phase 6, which ran "
        f"{world1['process_s']:.1f} and {pod['process_s']:.1f} s in their "
        f"processes beside phases 3 and 6)")
    return out


def close_logits(a, b, what: str) -> dict:
    """Two logits tensors under the whole-model gate: max |a - b| within
    MODEL_REL_TOL of b's largest |logit|, cosine at least MODEL_MIN_COS."""
    gap = logits_gap(a, b)
    rel, cos = gap["rel_err"], gap["cosine"]
    same = bool((a.argmax(-1) == b.argmax(-1)).all())
    log(f"[model] {what}: max |d logit| / max |logit| {rel:.3e} "
        f"(allowed {MODEL_REL_TOL:.3e}), cosine {cos:.6f} (allowed "
        f">= {MODEL_MIN_COS}), same argmax {same}")
    if not (rel <= MODEL_REL_TOL and cos >= MODEL_MIN_COS):
        raise AssertionError(f"{what}: logits disagree beyond tolerance")
    return gap | {"same_argmax": same}


def model_batch(cfg, inputs, a: int, b: int) -> dict:
    """Positions [a, b) of ``inputs`` as the model's batch: token ids, or
    a frontend stub's embeddings."""
    return {"tokens" if cfg.frontend is None else "embeds": inputs[:, a:b]}


def compare_model(cfg, params, inputs, dev) -> dict:
    """The whole model, right at full width, on ``inputs[:, :S + 1]``:
    last-position logits of ``prefill(S)`` with the kernel and with the
    plain version forced (same weights); one decode step on each of their
    caches (the second with the plain versions forced, which changes
    nothing where decode runs no kernel: attention's); and prefill(S) plus
    one decode step against prefill(S + 1), all under the gate of
    ``close_logits``.

    MoE routing is discrete, and at full depth with random weights it
    amplifies rounding: a token's top-k expert set flips on a near-tie,
    and a flip moves an expert's capacity boundary for every later token.
    So in each pair the second run replays the first run's routing
    (``MoETap(replay=...)``: the same experts for each token and layer,
    weighted by its own router probabilities), which leaves the kernel's
    rounding as the only difference; the routing decisions that differ
    when the plain version routes for itself are counted and its logits'
    distance reported beside the gate.  The last token of prefill(S + 1)
    is the first dropped where an expert overflows, so that check is
    made only where none of its pairs was dropped (prefill(S) and the
    decode step then replay prefill(S + 1)'s routing of their tokens);
    the count is reported either way; where it was, the check is made
    again at capacity factor ``WIDE_CAPACITY``, on the same weights.
    Without MoE layers the taps do nothing."""
    import dataclasses
    import torch
    from repro_torch.models import decode_step, prefill

    s = inputs.shape[1] - 1
    pos = torch.tensor([s], device=dev)
    head, step = model_batch(cfg, inputs, 0, s), model_batch(
        cfg, inputs, s, s + 1)
    with MoETap() as rk:
        lk, cache = prefill(cfg, params, head)
    with MoETap(replay=rk):
        lr, cache_r = prefill(cfg, params, head, backend="ref")
    out = {"seq": s, "kernel_vs_plain": close_logits(
        lk, lr, f"prefill S={s}, kernel vs plain version")}
    if cfg.moe is not None:
        with MoETap() as rfree:
            lfree, _ = prefill(cfg, params, head, backend="ref")
        free = out["free_routing"] = rk.flips(rfree) | logits_gap(lk, lfree)
        log(f"[model] routing, kernel vs plain prefill routing for itself: "
            f"{free['flipped']} of {free['decisions']} (layer, token) "
            f"expert sets differ; logits max |d| / max |logit| "
            f"{free['rel_err']:.3e}, cosine {free['cosine']:.6f} (reported; "
            f"the gate is held with the routing replayed)")
        del lfree, rfree
    with MoETap() as dk:
        ld, _ = decode_step(cfg, params, padded_cache(cache, s + 1), step, pos)
    with MoETap(replay=dk):
        ldr, _ = decode_step(cfg, params, padded_cache(cache_r, s + 1), step,
                             pos, backend="ref")
    del cache, cache_r
    out["decode_kernel_vs_plain"] = close_logits(
        ld, ldr, f"decode 1 on the prefill {s} caches, kernel vs plain")
    # at the config's capacity, else (MoE) at WIDE_CAPACITY, where
    # fewer pairs overflow (none in deepseek-moe-16b: an expert takes at
    # most one pair a token)
    out["last_token_dropped_pairs"] = {}
    out["decode_vs_prefill"] = {"skipped": True}
    for run_cfg in (cfg,) if cfg.moe is None else (cfg, dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe,
                                         capacity_factor=WIDE_CAPACITY))):
        cf = None if cfg.moe is None else run_cfg.moe.capacity_factor
        what = f"prefill {s} + decode 1 vs prefill {s + 1}" + (
            f", capacity factor {cf}" if cf else "")
        with MoETap() as rf:
            lf, _ = prefill(run_cfg, params,
                            model_batch(cfg, inputs, 0, s + 1))
        last = out["last_token_dropped_pairs"][str(cf)] = \
            rf.last_token_dropped()
        if last:
            log(f"[model] {what}: not held, {last} of the last token's "
                f"pairs dropped at capacity in prefill {s + 1}")
            continue
        with MoETap(replay=rf):
            _, cache = prefill(run_cfg, params, head)
        with MoETap(replay=rf, offset=s):
            ld, _ = decode_step(run_cfg, params, padded_cache(cache, s + 1),
                                step, pos)
        del cache
        out["decode_vs_prefill"] = close_logits(ld, lf, what) | {
            "capacity_factor": cf}
        break
    out.update(rel_tol=MODEL_REL_TOL, min_cos=MODEL_MIN_COS)
    return out


def logits_gap(a, b) -> dict:
    """max |a - b| over b's largest |logit|, and the least cosine."""
    import torch
    a, b = a.float(), b.float()
    return {"rel_err": float((a - b).abs().max() / b.abs().max()),
            "cosine": float(torch.nn.functional.cosine_similarity(
                a, b, dim=-1).min())}


class MoETap:
    """While open, records the routing of every MoE block run: each
    token's experts and the capacity, in layer order, so the pair counts
    per expert and the pairs dropped (the block's own counts are the
    experts' histogram, n_shards 1).  With ``replay`` (another tap, read
    after its run), each block routes instead to the experts that tap
    recorded for its layer, from token ``offset`` on, weighted by this
    run's own renormalised router probabilities.  It wraps ``_route`` in
    ``repro_torch.models.moe``; nothing syncs until it is read."""

    def __init__(self, replay: "MoETap | None" = None,
                 offset: int = 0) -> None:
        self.replay, self.offset = replay, offset
        self.layers: list = []

    def __enter__(self) -> "MoETap":
        import repro_torch.models.moe as moe
        self.module, self.route = moe, moe._route
        moe._route = self._route
        return self

    def __exit__(self, *exc) -> None:
        self.module._route = self.route

    def _route(self, router_w, x, cfg):
        import torch
        from repro_torch.models.moe import expert_capacity
        t = x.shape[0]
        if self.replay is None:
            top_w, top_e, aux = self.route(router_w, x, cfg)
        else:
            top_e = self.replay.layers[len(self.layers)]["experts"][
                self.offset:self.offset + t]
            probs = torch.softmax(x.float() @ router_w, dim=-1)
            top_w = probs.gather(1, top_e)
            top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
            f = torch.bincount(top_e.reshape(-1), minlength=cfg.n_experts)
            aux = cfg.n_experts * torch.sum(f / top_e.numel()
                                            * probs.mean(dim=0))
        self.layers.append({"experts": top_e, "n_experts": cfg.n_experts,
                            "capacity": expert_capacity(t, cfg)})
        return top_w, top_e, aux

    @staticmethod
    def _counts(r):
        import torch
        return torch.bincount(r["experts"].reshape(-1),
                              minlength=r["n_experts"])

    def dropped(self) -> list:
        """Pairs dropped at capacity, per MoE layer in order."""
        return [int((self._counts(r) - r["capacity"]).clamp_min(0).sum())
                for r in self.layers]

    def last_token_dropped(self) -> int:
        """The last token's pairs dropped: it comes last in every expert's
        stable order, so its pair to expert e is dropped iff e's count
        exceeds the capacity."""
        return sum(int((self._counts(r)[r["experts"][-1]] > r["capacity"])
                       .sum()) for r in self.layers)

    def flips(self, other: "MoETap") -> dict:
        """(layer, token) expert sets that differ from ``other``'s run."""
        flipped = sum(int((a["experts"].sort(-1).values
                           != b["experts"].sort(-1).values).any(-1).sum())
                      for a, b in zip(self.layers, other.layers))
        return {"flipped": flipped, "decisions": sum(
            r["experts"].shape[0] for r in self.layers)}


#: the cache leaves with a sequence axis (attention's and MLA's); the
#: recurrent layers' states and shifted inputs have none
SEQ_LEAVES = ("k", "v", "c_kv", "k_pe")


def padded_cache(tree, length: int, key: str = ""):
    """The prefill cache padded with zeros to ``length`` positions, each
    leaf in its own dtype (float32 k, bf16 v in a bf16 model), as
    ``tests/test_models_consistency.py`` pads the reference's; a recurrent
    layer's leaves copied as they are (decode updates them in place)."""
    if isinstance(tree, dict):
        return {k: padded_cache(v, length, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [padded_cache(v, length, key) for v in tree]
    if key not in SEQ_LEAVES:
        return tree.clone()
    out = tree.new_zeros((tree.shape[0], length, *tree.shape[2:]))
    out[:, :tree.shape[1]] = tree
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda", 0)
    # the plain versions' float32 products run in full float32, not TF32,
    # and their bf16 products reduce in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_start = time.monotonic()
    card = phase_environment()
    build = phase_build()
    dry_runs = start_dry_runs()
    sha1 = build["sha1_sass"]
    kernels = {"uts_hash": phase_kernel_uts(dev, sha1),
               "uts_expand": phase_kernel_uts_expand(dev, sha1),
               "mandelbrot": phase_kernel_mandelbrot(dev)}
    flash_fixed = phase_flash_fixed(dev)
    dry = wait_dry_runs(dry_runs)
    uts = phase_uts(dev, UTS_DEPTH)
    ms = phase_ms(dev, MS_SIDE, MS_DWELL, sha1["sm_clock_hz"])
    paper = phase_ms_paper_size(dev)
    bc = phase_bc(dev)
    chaos = phase_chaos(dev, uts)
    harness = phase_harness(dev)
    model = phase_model(dev)
    families = phase_model_families(dev)
    recurrent = phase_recurrent_families(dev)
    training = phase_training(dev)
    mesh = phase_mesh(dev, training)
    roofline = phase_roofline(card, mesh, dry)
    # run_path has already required a launch on every path that runs a
    # hand kernel
    kernels["uts_expand"]["launches_by_path"] = uts["launches"]
    kernels["uts_hash"]["launches_by_path"] = uts["uts_hash_launches"]
    kernels["mandelbrot"]["launches_by_path"] = ms["launches"]
    # and at the main path's in-set shapes (max_iter 5,000,000), both builds
    kernels["mandelbrot"]["in_set_main_path"] = {
        k: ms["samples"]["in_set"][k] for k in ("samples", "median_ms",
                                                "speedup", "median_bound_ms")}
    # the BC lines are measured at a main-path task's shape (the paper
    # graph, block 0's 1,024 sources), per task: every level summed
    bc_task = bc["fixed"][-1]
    for name in ("bc_forward_level", "bc_backward_level"):
        k = bc_task[name]
        kernels[name] = {
            "max_abs_err": 0.0, "matched": True,
            "launches_by_path": {path: n[name] for path, n in
                                 bc["launches"].items()},
            **{x: k[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "levels", "ms_per_level")},
            "shape": f"CSR {bc_task['vertices']} vertices, "
                     f"{bc_task['edges']} edges; state [{bc_task['vertices']}"
                     f", {bc_task['sources']}]; a task's {k['levels']} "
                     f"levels summed"}
    # the flash line is measured on the prefill's own operands: a global
    # (causal, S = 32,768) layer, with the local (window 512) one beside it
    glob, loc = (model["main_path_operands"][k] for k in ("global", "local"))
    kernels["flash_attention_fwd"] = {
        "max_abs_err": max(glob["max_abs_err"], loc["max_abs_err"]),
        "max_abs_err_float32": max(glob["float32"]["max_abs_err"],
                                   loc["float32"]["max_abs_err"]),
        "matched": True, "launches_by_path": model["launches"],
        **{k: glob[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")},
        "shape": glob["shape"] + ", causal (global layer)",
        "library_dtype": glob["library_dtype"],
        "local_layer": {k: loc[k] for k in (
            "shape", "window", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err", "launches")}}
    # and on the other families' prefill operands: deepseek-moe-16b's
    # global layer at 32k, and deepseek-v3's MLA layer, zero-padded (its
    # bound on the unpadded work)
    flash = kernels["flash_attention_fwd"]
    flash["launches_by_path"].update(
        families["launches"]["flash_attention_fwd"])
    for key, rec in (("moe_layer", families[MOE_ARCH]["flash_global_layer"]),
                     ("mla_layer", families[MLA_ARCH]["flash_mla_layer"])):
        flash[key] = {k: rec[k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err", "launches") + (
            ("unpadded", "padded_bound_ms") if "unpadded" in rec else ())}
        flash["max_abs_err"] = max(flash["max_abs_err"], rec["max_abs_err"])
        flash["max_abs_err_float32"] = max(flash["max_abs_err_float32"],
                                           rec["float32"]["max_abs_err"])
    # and on jamba's attention layer at 32k (32 heads on 8 KV heads, D 128)
    jamba_flash = recurrent[JAMBA_ARCH]["flash_attention_layer"]
    flash["jamba_layer"] = {k: jamba_flash[k] for k in (
        "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "max_abs_err", "launches")}
    flash["max_abs_err"] = max(flash["max_abs_err"],
                               jamba_flash["max_abs_err"])
    flash["max_abs_err_float32"] = max(flash["max_abs_err_float32"],
                                       jamba_flash["float32"]["max_abs_err"])
    flash["launches_by_path"].update(
        recurrent["launches"]["flash_attention_fwd"])
    # the scan kernels, measured on the prefill's own operands: one layer of
    # rwkv6-1.6b (wkv6) and one Mamba layer of jamba (selective_scan)
    for name, arch, key in (("wkv6", RWKV_ARCH, "wkv6_layer"),
                            ("selective_scan", JAMBA_ARCH,
                             "selective_scan_layer")):
        k = recurrent[arch][key]
        kernels[name] = {
            "matched": True, "launches_by_path": {
                **families["launches"][name], **recurrent["launches"][name],
                **training["launches"][name], **mesh["launches"][name]},
            **{x: k[x] for x in ("max_abs_err", "bit_equal", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms",
                                 "shape")}}
    # the backward kernel, measured on the whole-model gradient's own
    # operands: a global (causal) layer of gemma3-1b, with its local (window
    # 512) layer, deepseek-moe-16b's layer and a float32 case beside it;
    # launches on every training path (and 0 on the inference paths)
    bwd = training["kernel"]
    kernels["flash_attention_bwd"] = {
        "max_abs_err": max(r["max_abs_err"] for r in bwd.values()),
        "matched": True,
        "launches_by_path": {
            **{p: n for ph in (model, families, recurrent)
               for p, n in ph["launches"].get("flash_attention_bwd",
                                              {}).items()},
            **training["launches"]["flash_attention_bwd"],
            **mesh["launches"]["flash_attention_bwd"]},
        **{k: bwd["global"][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms", "shape",
                                         "deterministic", "floor_ms",
                                         "floor_two_pass_ms")},
        **{f"{which}_layer" if which != "float32" else "float32_case": {
            k: bwd[which].get(k) for k in (
                "shape", "window", "softcap", "ms", "plain_ms", "bound_ms",
                "bound_by", "floor_ms", "floor_two_pass_ms", "library_ms",
                "max_abs_err", "rel_err_float32")}
           for which in ("local", "moe", "float32")},
        "lse_leaves_o": training["lse_leaves_o"],
        "max_abs_err_is": "max |err| / max |value| of each of dQ, dK, dV"}
    flash["launches_by_path"].update(
        training["launches"]["flash_attention_fwd"])
    flash["launches_by_path"].update(mesh["launches"]["flash_attention_fwd"])
    # the scans' backward kernels, measured on a training layer's own
    # operands (an rwkv6-1.6b layer and a jamba Mamba layer, B 1, S 4,096),
    # the small ragged and unaligned shapes' errors beside them; launches on
    # every training path (and 0 on the inference paths)
    scans = training["recurrent"]
    for name in ("wkv6_bwd", "selective_scan_bwd"):
        k = scans["kernel"][name]
        small = {key: r["max_abs_err"] for key, r in scans["small"].items()
                 if key.startswith(name)}
        kernels[name] = {
            "matched": True,
            "launches_by_path": {
                p: n for ph in (model, families, recurrent, training, mesh)
                for p, n in ph["launches"].get(name, {}).items()},
            "max_abs_err": max([k["max_abs_err"], *small.values()]),
            "max_abs_err_is": "max |err| / max |value| of each gradient",
            "small_shapes": small,
            **{x: k[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "shape", "deterministic",
                                 "forward_bits_kept")}}
    # each model kernel at a rank's share of its layer on the production
    # mesh's model axis of 16 (phase 14)
    for key, rec in mesh["shares"].items():
        if key == "seconds":
            continue
        name, _, case = key.partition(" ")
        k = kernels[name]
        k.setdefault("rank_share", {})[case or "layer"] = {
            x: rec[x] for x in ("shape", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "max_abs_err",
                                "launches", "unpadded", "padded_bound_ms")
            if x in rec}
        k["max_abs_err"] = max(k["max_abs_err"], rec["max_abs_err"])
    # the chaos and harness phases' paths, each with the launches of the
    # kernels it runs (a harness path that runs no kernel records none)
    for phase in (chaos, harness):
        for path, rec in phase["paths"].items():
            for name, n in rec["launches"].items():
                kernels[name]["launches_by_path"][path] = n

    summary = [{"name": name, "route": "cuda",
                "source": KERNEL_SOURCES[name][0],
                "replaces": KERNEL_SOURCES[name][1],
                "launches": sum(k["launches_by_path"].values()),
                "launches_by_path": k["launches_by_path"],
                "max_abs_err": k["max_abs_err"],
                "matched": k["matched"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
               | {x: k[x] for x in ("local_layer", "moe_layer", "mla_layer",
                                    "jamba_layer", "float32_case",
                                    "deterministic", "lse_leaves_o",
                                    "max_abs_err_is", "forward_bits_kept",
                                    "small_shapes", "rank_share",
                                    "bit_equal",
                                    "full_iteration_ms",
                                    "bound_dwell_sum_ms", "in_set_main_path",
                                    "bound_loose_ms", "levels",
                                    "ms_per_level")
                  if x in k}
               for name, k in kernels.items()]
    # nothing the run started may outlive it
    leftover = stop_children()
    report = {"card": card, "device": torch.cuda.get_device_name(0),
              "seconds": time.monotonic() - t_start, "build": build,
              "kernels": kernels,
              "flash_fixed_shapes": flash_fixed, "uts": uts, "ms": ms,
              "ms_paper_size": paper, "bc": bc, "chaos": chaos,
              "harness": harness, "model": model, "families": families,
              "recurrent": recurrent, "training": training, "mesh": mesh,
              "roofline": roofline, "leftover_processes_stopped": leftover}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"[done] {report['seconds']:.1f} s; report in "
        f"{OUT_DIR / 'chip_smoke.json'}")
    print(f"card: {card}")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        stop_children()
    sys.exit(rc)
