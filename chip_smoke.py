#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. environment: torch / CUDA / nvcc versions, the card's name and power
     limit;
  2. build: every kernel under src/repro_torch/csrc, one nvcc each, all at
     once (timed);
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the shapes the h2o-danube-1.8b, nemotron-4-340b,
     falcon-mamba-7b, gemma2-27b (attention at d = 128 with softcap 50)
     and minicpm3-4b (the MLA GEMMs, the expansion at m = 8 x 544) serving
     paths give it, with
     its time (CUDA events, L2 flushed before each launch), the plain
     version's, one PyTorch library call's and the least time the card
     could take (the bound; flash attention also at the rate of the tensor
     cores it runs on); the launch form of each GEMM case of the two
     block-sparse kernels and of w8a8, the profiler's kernel duration beside
     the event time at the headline rows (the five decode GEMMs, flash at
     sq 512, paged decode attention, the selective scan), and the kernels
     SDPA runs for f32 at d = 192. quant_matmul_w8a8 (its activation
     quantization inside the launch) is held bit for bit to its plain
     version; the paged attention and scan kernels are each held to two
     bitwise-equal calls; paged attention also at the speculative verify
     block (sq 5); bsr_matmul_experts, bsr_matmul batched over an MoE
     layer's 64 experts in one launch, at deepseek-moe-16b's routed
     projections (2048 -> 1408 and 1408 -> 2048, s0.5) at C = 6 (decode)
     and C = 60 (a 512-token prefill), against torch.bmm on the masked
     dense stack, and at jamba-v0.1-52b's (16 experts, 4096 -> 14336 and
     14336 -> 4096, s0.5) at C = 2 and C = 80; whisper-large-v3's: flash
     attention non-causal over 1500 frames (20/20 heads of 64) against
     SDPA, paged decode attention at d = 64 over up to 28 pages of 16, and
     the 1280 -> 5120 and 5120 -> 1280 projections dense and s0.5-w8 at
     m = 8 and m = 1500;
  4. model parity: the port's forward on the card against the same forward
     on the CPU (plain versions), full width cut to 2 layers, one prefill
     batch and 4 greedy decode steps;
  5. serving: h2o-danube-1.8b at full width and depth (random f32 weights
     from seed 0), packed three times (dense, sparsity 0.5, sparsity 0.5
     x int8) and served through InferenceEngine; the launch counts show
     which kernels the serving path ran. Three decode dispatches and three
     512-token prefills are then traced with torch.profiler: device time
     by kernel, GEMM device ms and device ops per micro-step, the device
     idle share within each traced call's device window, and exactly one
     device-to-host copy per decode dispatch;
  6. paged serving: the same model and traffic through the page pool
     (page_size 16), dense on the slab and paged, weight-only w4 and w8a8
     paged. Paged tokens equal slab tokens (or the first divergent step's
     top-2 logit gap is below 1e-3), each spec launches only its own GEMM,
     the page-table attention kernel runs 24 times per micro-step and
     shows device time in the trace, the prefix index is off (windowed
     arch), one device-to-host copy per traced dispatch, and the GEMM,
     non-GEMM and paged attention device ms and device ops per micro-step,
     slab against paged;
  7. prefix and conversation reuse: nemotron-4-340b at full width, depth
     cut to 1 layer, f32: a shared 512-token system prompt under 8
     requests, then 2 follow-up turns of finished conversations, through
     the paged engine with the prefix index, against a slab engine over
     the same model;
  8. Mamba serving: falcon-mamba-7b. Card-vs-CPU parity at full width cut
     to 2 layers (one 64-token prefill, 4 greedy decode steps); then full
     width, depth cut from 64 to 32 layers (random f32 weights from seed 0,
     ~15 GB), packed dense and sparsity 0.5 x int8, serving phase 5's
     traffic. Every prefill runs the selective-scan kernel once per layer
     (32 x 16 per run), each spec launches only its own GEMMs, no attention kernel
     runs, and a traced decode dispatch copies to the host once; 2 decode
     dispatches and 2 512-token prefills are traced, and each prefill shows
     the scan's device ms;
  9. speculative self-draft decode, phase 5's traffic, greedy:
     h2o-danube-1.8b at full width, depth cut to 8 layers (dense target,
     s0.5 x int8 draft, K 4) from the slab and the page pool, and
     falcon-mamba-7b at full width, depth cut to 16 layers (dense target,
     w8 draft, K 2). Tokens equal the
     same model's plain decode (or the first divergent step's top-2 gap is
     below 1e-3); acceptance rate, commits per cycle, wall and device ms
     per cycle and per committed token, idle share;
 10. gemma2-27b (local/global windows, softcaps 50 and 30, sandwich norms,
     head_dim 128, query scale 1/12). Card-vs-CPU parity at full width cut
     to 2 layers; then full width, depth cut from 46 to 4 layers (13.8 GB
     in f32), phase 5's traffic: dense and s0.5-w8 from the slab, dense
     from the page pool (every layer page-major: the page-table kernel
     once a layer a micro-step, with softcap 50, and window 4096 on local
     layers), and one long run of 2 x 4160 prompt tokens past the local
     window (max_len 4224). tok/s, GEMM / non-GEMM / paged-attention
     device ms per micro-step, the 512-token prefill's flash device ms;
     paged tokens equal slab tokens (near-tie rule), and every run's equal
     the eager step's;
 11. minicpm3-4b (MLA): card-vs-CPU parity at 2 layers; then full width,
     depth cut from 62 to 4 layers (1.8 GB): phase 5's traffic from the
     slab, dense and s0.5-w8, with the naive expansion's share of decode
     device time;
     speculative decode (K 4, w8 draft) from the slab and the page pool
     against plain decode; phase 7's prefix traffic from the page pool,
     whose skipped share of prompt tokens must be no lower than
     nemotron's. No attention kernel runs on MLA's path (as in the JAX
     package). Every run's tokens equal the eager step's;
 12. mixture-of-experts: deepseek-moe-16b, card-vs-CPU parity at 2 layers
     (the dense prelude layer and one MoE layer); then full width, depth
     cut from 28 to 4 layers (1 dense + 3 MoE): phase 5's
     traffic from the slab, dense (the routed experts a batched plain
     product, as the JAX package's einsum) and s0.5-w8 (the routed experts
     on bsr_matmul_experts over fake-quant float blocks: 9 launches a
     micro-step), with decode device ms split, from each traced dispatch,
     into the routed experts' GEMM kernels (found by name and grid in a
     trace of one layer's expert FFN), the port's other GEMMs and the
     rest; dense from the page pool without prefix
     reuse (tokens equal the slab's, near-tie rule); phase 7's prefix
     traffic (skip share, matched against unmatched admission). Then
     deepseek-v2-lite-16b (MLA + MoE): parity at 2 layers, full width cut
     from 27 to 4 layers, dense from the slab. Every run's tokens equal
     the eager step's;
 13. the jamba hybrid: jamba-v0.1-52b, card-vs-CPU parity over one Jamba
     block (8 layers: 7 Mamba, 1 attention without RoPE, 4 MoE) at the
     published d_model, heads and head_dim, the FFNs cut (4 experts, d_ff
     1024) to keep the CPU copy near 6 GB; then full width, depth cut from
     32 to 8 layers (53.2 GB in f32), phase 5's traffic: dense and s0.5-w8
     from the slab (each loaded alone, the s0.5-w8 copy packed leaf by
     leaf after the dense model is freed, with each load's peak
     memory_allocated), dense from the page pool (the attention layer's k/v
     paged, the Mamba state resident). Every run launches ssm_scan (7 a
     prefill) and flash attention (1 a prefill); s0.5-w8 runs the routed
     experts on bsr_matmul_experts (E 16, C 2 at decode: 12 launches a
     micro-step). Decode device ms per micro-step split into the routed
     experts (by kernel name and grid), the Mamba mixers (traced alone),
     the other GEMMs and the rest; paged tokens equal slab tokens (near-tie
     rule) with the capacity widened so that nothing drops (at the served
     capacity a parked row, which reads its stale slab row on the slab but
     the sink page in the pool, takes capacity from the live rows, so the
     requests that differ there are reported);
 14. the vision stub: llava-next-mistral-7b, card-vs-CPU parity at full
     width, 2 layers, with 64 of the 2880 image rows; then full width,
     depth cut from 32 to 8 layers (~8 GB): 8 requests, each with 2880
     stub image rows (the port's llava_patches of a seeded image) and a
     32-512-token prompt, 32 new tokens, n_slots 8, max_len 3456 (a 3.6 GB
     slab):
     dense and s0.5-w8 from the slab, dense from the page pool, with the
     admission wall ms of a 2880 + 512-row prefill; paged tokens equal
     slab tokens (near-tie rule);
 15. the encoder-decoder: whisper-large-v3, card-vs-CPU parity at full
     width with 2 encoder and 2 decoder layers over the audio stub's 1500
     frames (encoder output and logits; each prefill launches flash 2
     times non-causal and 2 times causal); then full width, the encoder's
     32 layers and the decoder's cut from 32 to WHISPER_LAYERS (8): 16
     requests, each with the frames of a
     seeded 30 s waveform at 16 kHz (whisper_frames) and a 4-224-token
     prompt, 32 new tokens, n_slots 8, max_len 448 (Whisper's n_text_ctx):
     dense and s0.5-w8 from the slab, dense from the page pool (the cross
     k/v resident). Flash runs 40 times an admission (the encoder's 32
     over 1500 frames, the decoder's 8); the cross-attention of one
     decode micro-step is traced alone (its projection GEMMs and the
     einsums over the 1500 keys), and an admission's wall ms is split
     into the encoder, the cross k/v projections and the decoder's
     prefill; paged tokens equal slab tokens (near-tie rule).
 16. speculative self-draft decode of the MoE, hybrid and frontend archs,
     each cell on its phase's dense-slab artifact (loaded with the cell's
     draft; the load's peak is reported with the draft named) and the
     phase's first requests (one wave of 8), greedy, run right after that
     phase's dense-slab run: 16a deepseek-moe-16b (4 layers, s0.5 x int8
     draft: its routed experts on bsr_matmul_experts, the rest on
     bsr_quant_matmul and quant_matmul; K 4; slab and paged), 16b
     jamba-v0.1-52b (8 layers, w8 draft sharing the target's raw expert
     stacks; K 2; K+1 single-token verify steps), 16c llava-next-mistral-7b
     (8 layers, 2880 image rows a request, s0.5 x int8 draft, K 4), 16d
     whisper-large-v3 (32 + 8 layers, 1500 frames through each model's
     encoder, s0.5 x int8 draft, K 4; slab and paged). Graph tokens equal
     the eager step's, paged tokens the slab's, speculative tokens plain
     decode's (near-tie rule; for an MoE arch with the capacity widened to
     n_experts / top_k, the requests that part at the served capacity
     reported); acceptance, wall ms per cycle graph and eager in turns,
     device ms per cycle, ms per committed token against plain decode's,
     the draft's admission prefill ms.
 17. resilience and the ineffectual-work ledger, right after phase 9, on
     phase 9's dense tree of h2o-danube-1.8b (full width, 8 layers),
     phase 5's first 8 requests (cut from 16 for the time limit), all at
     step 0: loaded with the QoS ladder 8:0.5,8:0.75 (the load's peak
     memory). 17a: the tiered model's tier-0 tokens equal a tierless
     model's; QoSConfig(demote_depth 4, promote_depth 0, hysteresis 2)
     demotes and promotes at least once, ends on tier 0, and every request
     completes; each tier held for the traffic, its graph's tokens equal
     its eager step's, with wall and device ms a micro-step; a swap's wall
     ms and the extra ms of the dispatch right after it; the same ladder on
     the model's 128 x 128 block grid, timed. 17b: the ledger off,
     LedgerConfig() and threshold 1e-3 (the same tokens, one host sync a
     dispatch, 128 probe launches a dispatch), the probe kernel against
     LedgerProbe.measure on every tap of an eager dispatch (counts exact,
     float columns within 1e-6 relative), wall and device ms a micro-step
     of the three engines in turns, the zero and dead k-block shares and
     flops_effective / flops_dense; one run held on tier 1 with
     quality_every=1 (top-1 agreement and mean |logit difference| against
     tier 0). 17c: a page pool of 80 pages of 16, pool_wait_retries 2,
     deadline_steps 40 on every 4th request: shed ids by reason, no
     completion past its deadline, the pool pristine.
 18. tracing, telemetry, the replica router and chaos, on phase 5's first
     8 requests (K 4). 18a, right after phase 6, on its dense h2o-danube
     (full width and depth): the slab engine with tracing off and on in
     alternating turns (off, on with a torch.profiler bracket over the
     first 3 dispatches written under chiprun_out/profile, on, off):
     tokens and launch counts equal, wall ms a decoded token each; the
     spans' step clocks equal the report's; the median `decode` span
     against phase 5's graph wall ms a micro-step x 4; the profiler
     trace's kernels by family, the dense GEMV among those the graph
     replays launched; a traced paged engine (page events, gather bytes
     avoided); a TelemetryExporter on an ephemeral port scraped mid-run
     from 127.0.0.1 (serve_tokens_generated) with its JSONL. 18b, right
     after phase 17, on phase 9's 8-layer tree: 2 replicas of 4 slots, a
     fault-free run; a crash of replica 1 at router step 3 with
     auto_restart (tokens equal the fault-free run's; the restart's wall
     ms; memory_allocated after it less than half a replica above its
     level before the crash); one nan_logits sync (tokens equal); every
     free page of a paged replica squeezed for 4 steps (admissions wait,
     the pools end pristine).
 19. the serving surface, on phase 5's first 8 requests. 19a, right after
     phase 18a, on its dense h2o-danube (full width and depth): the legacy
     gather/scatter paged decode (paged_native=False) against the native
     one, page 16, K 4, in alternating turns (legacy, native, legacy,
     native): tokens equal, the "gather" event stream (a gather and a
     scatter in each engine's warm-up and capture, none per replay; none
     native), paged_flash_attention launches (legacy 0, native 24 a
     micro-step), gather_bytes_avoided, peak memory_allocated, and graph
     wall ms a micro-step of both forms in alternating turns. 19c:
     StaticScheduler against ContinuousScheduler on a 4-slot slab (two
     waves), in alternating turns: tokens equal, dispatches, tokens a
     dispatch, tok/s. 19d: `python -m repro_torch.launch.serve --full ...`
     in a subprocess, as users start it: exit 0, `scheduler=static
     backend=local`, a non-empty trace, its wall seconds. 19b, right after
     phase 18b, on phase 9's 8-layer tree with its s0.5 x int8 draft, K 4,
     page 16, 4 requests: legacy speculative tokens equal native ones, and
     paged attention runs only in the native cycle.
 20. the fleet, right after phase 19d, on phase 6's dense h2o-danube (full
     width and depth), 2 processes. 20a, in process: a FleetRouter over 2
     LocalProcess handles (a one-replica ReplicaRouter each, 4 slots, K 4)
     on phase 5's first 8 requests: tokens equal one engine's, both
     processes serve; then process 1 killed once a request of its own has
     tokens: the heartbeat-timeout failover re-prefills its requests on
     process 0 (fleet_failovers >= 1, processes_dead 1), tokens still
     equal, a zombie status counted in resurrections_ignored; dense_matmul
     and flash_attention launch in both runs; tokens a fleet step. 20b, as
     users start it: `python -m repro_torch.launch.fleet --device cuda
     --full --processes 2 --requests 12 --inject-death` in a subprocess (a
     coordinator and 2 worker processes, each with its own copy of the
     weights on the card, 3 x the model's bytes required free first): exit
     0, its fleet's tokens equal its own engine's across the killed
     worker; its wall s and the report's fleet keys.
 21. training, right after phase 20. 21a: phase 6's dense h2o-danube (full
     width and depth, 1.831 B f32 parameters) trained in place through
     `distributed.steps.make_train_step` (the reference path, remat as the
     config has it, AdamW lr 1e-3 with 5 warmup steps): 5 steps of 4 x 256
     markov tokens, each step's loss, grad_norm, wall ms, training tokens
     a second, peak memory_allocated and the hand-written kernels' launch
     counts, which must stay 0; the loss finite and step 5's below step
     1's. 21b: a full-width 1-layer h2o-danube under phase 5's s0.5-w8
     spec (128 x 128 blocks): grad_accum 2 against 1 on one batch (loss and
     grad_norm within 1e-5 relative); every pruned block exactly zero after
     4 steps; 4 uninterrupted steps against a run that crashes at step 3
     (`fail_at_step`, after the async checkpoint at step 2, in a temporary
     directory under build/ removed afterwards) and resumes to step 4, all
     three runs under torch.use_deterministic_algorithms (the losses of
     steps 3-4 bitwise equal), the checkpoint's bytes and the snapshot,
     npz write and restore wall ms; the trained tree packed
     (`serve.registry.pack_model_params`) and phase 5's first 4 prompts
     prefilled through it on the kernels, against the training-time
     forward (plain, fake-quant): max |logit difference| within
     HANDOFF_LOGIT_TOL, the int8 codes on which packing's exact scale and
     the fake-quant's FMA scale disagree, the last position's argmax equal
     (near-tie rule), the launches of bsr_quant_matmul, flash_attention and
     dense_matmul.
 22. the paper's grid, right after phase 21: `repro_torch.figures.run`
     with --quick in process (Figs. 1, 5, 6, 7 and Table III: counts on
     each point's plain path, device ms of its packed artifact on the
     kernels, each timed point held to its plain version; the C1-C5
     check lines at the H100's peaks), which must launch dense_matmul,
     bsr_matmul, quant_matmul and bsr_quant_matmul; then every Table II
     kernel (element-granular blocks, bk = bn = 1) packed at sparsity 0 /
     0.5 / 0.9 x bits None / 8 / 4:
     one launch of the wrapper its buffers select, held to the plain
     version of the same buffers at TOL, conv points also to F.conv1d /
     F.conv2d of the masked, fake-quantized filter at 2e-2; each point's
     kernel form, packed format, device ms, bound ms and plain ms, each
     kernel family's ms against its bound, and the phase's wall seconds.
     The phase's launches are every launch of both parts, timed ones too.
 23. the examples, right after phase 21 (before phase 22): each
     `examples_torch/*.py` loaded by path and its `main` run in process
     with `--device cuda`, so each example's own assertions run on the
     card (the loss falls; the resumed loss equals the reference's bit for
     bit, under torch.use_deterministic_algorithms; slab and paged, plain
     and speculative tokens identical; every routed request completes; the
     spans reconcile with ServeMetrics). serve_traced and serve_router run
     with `--full` on phase 6's dense h2o-danube tree (full width and
     depth, packed s0.5-w8 on 8 x 8 blocks), the other six at their own
     smoke sizes, sparsity_sweep at SWEEP_STEPS of its 120 steps. Each
     example's wall seconds, key outcome and launches by kernel: every
     serving example launches the kernels EXAMPLES names for it, the
     training examples none. Each example's output goes to
     chiprun_out/examples/<name>.log, serve_traced's exports under
     chiprun_out/traced_torch/.
 24. multi-device at one rank, inside phase 5, right after its dense and
     s0.5-w8 runs, on those packed models (no new model): the process
     joins a one-rank NCCL process group (`ensure_distributed` at
     127.0.0.1 on a free port; one world all-reduce shows NCCL runs);
     phase 5's first 4 requests through `ShardedBackend(mesh_shape=(1,
     1))` on the slab and on pages (16) and through `DistributedBackend`:
     greedy tokens equal phase 5's LocalBackend tokens, `describe()`
     gives mesh_shape [1, 1], each run launches the spec's GEMM and flash
     attention (and paged attention on pages), counts reset before each;
     the sharded and the local graph wall ms a micro-step in alternating
     turns, slots parked, on the card's name and power limit. After the
     dense run: `pipeline_apply` against `pipeline_reference` on CUDA
     tensors (one stage, d 2560), `cross_pod_psum_int8` against its
     quantization, and a re-mesh restore of layer 0's attention weights
     onto the card (saved through `CheckpointManager` under build/,
     restored with `shardings=` as DTensors, bitwise).
Phase 5 also holds the host-loop cell ([5h]): h2o-danube dense served by
the host decode loop (device_loop=False, one graphed (B, 1) forward a step,
logits to the host) and by the device loop, whole runs in alternating
turns: greedy tokens equal, 3 host syncs a decode step against 1 a
dispatch, wall ms per decoded token, and one host step against the device
loop's micro-step.
Every decode dispatch of phases 5-16 replays the CUDA graph the engine
captured at build: each of those phases times it against the eager step on
the same state, in alternating turns within this process, traces both
(device ms and ops, idle share, one device-to-host copy each), and serves
one of its configurations a second time through the eager step, which must
give the same tokens.
The last lines are the kernels JSON line (the eight TPU kernels,
`bsr_matmul_experts` and the port-only `ledger_probe`), the card line and
{"ok": true, "device": {...}}. Per-case numbers go to
chiprun_out/chip_smoke.json. Without a CUDA device it exits 2.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the H100 data sheet's peaks (dense, no sparsity), the port's one copy;
# every bound below is `analysis.cost.bound_ms` at these peaks
from repro_torch.launch import mesh  # noqa: E402

SEED = 0
# wall s and count of the run's recurring parts, summed over every phase
# and printed at the end: profiler sessions with their parsing ("traces"),
# graph-against-eager timed turns, eager identity serves, card-vs-CPU parity
PART_S = collections.Counter()
PART_N = collections.Counter()


def timed_part(part):
    """Add each call's wall s to PART_S[part]."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                PART_S[part] += time.perf_counter() - t
                PART_N[part] += 1
        return run
    return deco
# flash attention's second bound, at the rate of the units it runs on:
# 3xTF32 spends three TF32 products on each f32 one, bf16 runs at the bf16
# tensor-core rate
TC_FLOPS = {"float32": mesh.PEAK_TF32_FLOPS / 3,
            "bfloat16": mesh.PEAK_BF16_FLOPS}
GEMM_SHAPES = [(2560, 2560), (2560, 640), (2560, 6912), (6912, 2560)]
# falcon-mamba's x_proj: dense and weight-only only (its 288 columns are off
# the 128-wide block grid of the block-sparse kernels)
XPROJ = (8192, 288)
# kernels whose split partials meet in distributed shared memory in a fixed
# order (or as exact int32 sums): each is also held to two bitwise-equal
# calls on the same inputs
BITWISE = ("dense_matmul", "quant_matmul", "bsr_quant_matmul", "bsr_matmul",
           "quant_matmul_w8a8", "paged_flash_attention", "ssm_scan",
           "bsr_matmul_experts")
GEMM_ROWS = [1, 8, 77, 512]
BITS = [8, 4, 2, 1]
SPARSITIES = [0.5, 0.75]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 2.0 ** -7)}    # atol, rtol
EXACT = (0.0, 0.0)        # bit for bit (torch.equal)
# bf16 flash: the kernel rounds the unnormalised p to bf16 (as the Pallas
# kernel does), the plain version the normalised p; each is off by up to
# 2^-9 * sum_j p_j |v_j| (~6e-3 for randn v at these lengths), plus one
# bf16 ulp of the output
FA_TOL = {"float32": (2e-3, 2e-3), "bfloat16": (8e-3, 2.0 ** -7)}
# selective scan: f32 state on both sides (the kernel's expf against
# torch.exp, FMA contraction); bf16 inputs at the JAX test's tolerance
SSM_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 3e-2)}
# the case whose times stand for each kernel in the kernels line: the
# largest decode GEMM of a micro-step (w_gate / w_up at m = n_slots) and
# the longest prefill bucket
HEADLINE = {
    "dense_matmul": ("dense_matmul", "float32", 8, (2560, 6912), 0.0, None),
    "bsr_matmul": ("bsr_matmul", "float32", 8, (2560, 6912), 0.5, None),
    "bsr_quant_matmul": ("bsr_quant_matmul", "float32", 8, (2560, 6912),
                         0.5, 8),
    "flash_attention": ("flash_attention", "float32", 512, None, None, 80),
    "quant_matmul": ("quant_matmul", "float32", 8, (2560, 6912), 4),
    "quant_matmul_w8a8": ("quant_matmul_w8a8", "float32", 8, (2560, 6912)),
    # one h2o-danube layer's decode attention: 8 slots, 34 pages of 16
    "paged_flash_attention": ("paged_flash_attention", "float32", 80, 1,
                              None, None),
    # one falcon-mamba layer's scan in a 512-token prefill
    "ssm_scan": ("ssm_scan", "float32", 1, 512, 8192, 16),
    # one deepseek-moe MoE layer's w_gate at decode: 64 experts x C = 6
    "bsr_matmul_experts": ("bsr_matmul_experts", 6, (2048, 1408)),
    # h2o-danube's widest decode tap: the MLP hidden activation at 8 slots
    "ledger_probe": ("ledger_probe", "float32", (8, 1, 6912), 2560)}
SOURCES = {
    "dense_matmul": ("src/repro_torch/csrc/dense_matmul.cu",
                     "src/repro/kernels/dense_matmul.py:38"),
    "bsr_matmul": ("src/repro_torch/csrc/bsr_matmul.cu",
                   "src/repro/kernels/bsr_matmul.py:47"),
    "quant_matmul": ("src/repro_torch/csrc/quant_matmul.cu",
                     "src/repro/kernels/quant_matmul.py:73"),
    "quant_matmul_w8a8": ("src/repro_torch/csrc/quant_matmul_w8a8.cu",
                          "src/repro/kernels/quant_matmul.py:135"),
    "bsr_quant_matmul": ("src/repro_torch/csrc/quant_matmul.cu",
                         "src/repro/kernels/quant_matmul.py:200"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:91"),
    "paged_flash_attention": ("src/repro_torch/csrc/paged_attention.cu",
                              "src/repro/kernels/flash_attention.py:213"),
    "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan.py:64"),
    # the same Pallas kernel, which the JAX package vmaps over an MoE
    # layer's experts (src/repro/models/moe.py:90-97)
    "bsr_matmul_experts": ("src/repro_torch/csrc/bsr_matmul.cu",
                           "src/repro/kernels/bsr_matmul.py:47"),
    # a port-only kernel: the JAX package's ledger probe is array code that
    # XLA fuses into the jitted step (no Pallas kernel behind it)
    "ledger_probe": ("src/repro_torch/csrc/ledger_probe.cu",
                     "src/repro/serve/ledger.py:105"),
}
GEMMA, MINICPM = "gemma2-27b", "minicpm3-4b"
GEMMA_LAYERS = 4                       # of 46 (phase 10's depth cut)
MINICPM_LAYERS = 4                     # of 62 (phase 11's depth cut)
DEEPSEEK, LITE = "deepseek-moe-16b", "deepseek-v2-lite-16b"
DEEPSEEK_LAYERS = 4                    # of 28: 1 dense + 3 MoE (phase 12;
#                                        8 until phase 23 took the time)
LITE_LAYERS = 4                        # of 27: 1 dense + 3 MoE (phase 12)
# deepseek's routed projections (n_in, n_out) and the expert rows C of a
# decode micro-step at 8 slots and of a 512-token prefill
EXPERT_SHAPES = [(2048, 1408), (1408, 2048)]
EXPERT_ROWS = (6, 60)
JAMBA, LLAVA = "jamba-v0.1-52b", "llava-next-mistral-7b"
JAMBA_LAYERS = 8                       # of 32: one Jamba block (phase 13)
# phase 13's card-vs-CPU parity: one Jamba block at the published d_model,
# heads and head_dim, the FFNs cut so the CPU copy stays near 6 GB
JAMBA_PARITY = dict(n_layers=8, n_experts=4, d_ff=1024, d_ff_expert=1024)
# jamba's routed projections and the expert rows C at 8 slots and in a
# 512-token prefill
JAMBA_EXPERT_SHAPES = [(4096, 14336), (14336, 4096)]
JAMBA_EXPERT_ROWS = (2, 80)
# phase 14: 8 requests, each 2880 image rows + 32-512 prompt tokens + 32
# new; max_len >= 2880 + 512 + 32, a multiple of 16. Parity on the CPU
# keeps 64 of the 2880 image rows. Depth cut from 32 to 16 layers (phase
# 15 took the time it saves), then to 8 for the time limit
LLAVA_REQUESTS, LLAVA_MAX_LEN, LLAVA_PARITY_IMG = 8, 3456, 64
LLAVA_LAYERS = 8
# phase 15: whisper-large-v3's 1500 encoder frames (30 s at 50 a second),
# its published decoder context n_text_ctx (448; the config does not carry
# it) as max_len and its prompt limit n_text_ctx // 2; each request's
# frames come from a 30 s waveform at 16 kHz. The decoder's depth is cut
# from 32 to 8 layers for the time limit (phase 23 took the time it
# saves); the encoder keeps its 32 (every admission's 1500-frame encode)
WHISPER = "whisper-large-v3"
WHISPER_LAYERS = 8
WHISPER_FRAMES, WHISPER_MAX_LEN, WHISPER_PROMPT = 1500, 448, 224
WHISPER_SAMPLES = 30 * 16000
GEMMA_SCALE = (4608 / 32) ** -0.5      # gemma2's query scale, 1/12
# minicpm3's projections (n_in, n_out): MLA's low-rank factors, wo and the
# MLP; wkv_b also runs at m = n_slots x max_len, the naive expansion of the
# whole latent cache at every decode micro-step
MLA_SHAPES = {"wq_a": (2560, 768), "wq_b": (768, 3840), "wkv_a": (2560, 288),
              "wkv_b": (256, 5120), "wo": (2560, 2560), "w_up": (2560, 6400),
              "w_down": (6400, 2560)}
EXPANSION_ROWS = 8 * 544
GEMM_KERNELS = ("dense_matmul", "bsr_matmul", "quant_matmul",
                "quant_matmul_w8a8", "bsr_quant_matmul", "bsr_matmul_experts")
# a divergent greedy token is accepted only at a near-tie of the top two
# logits (f32 kernels and plain versions sum in different orders)
TOP2_GAP = 1e-3


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


class Timer:
    """Median device time of one call, L2 flushed before every launch.

    After the flush the stream is held busy by a ~0.1 ms sleep kernel
    queued before the start event, so the wrapper's host work (argument
    checks, the launch plan, the launch itself) overlaps the sleep and the
    event pair times the device work alone."""

    SLEEP_CYCLES = 200_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=10, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SLEEP_CYCLES)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)


def profiled_kernel_ms(torch, fn, family, iters=10):
    """Median device duration of the kernels whose name holds `family`,
    one per call of `fn`, from torch.profiler (L2 flushed before each
    call): the profiler's own reading beside the event pair's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    ms = [(e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
          if e.device_type == DeviceType.CUDA and family in e.name]
    assert len(ms) == iters, (family, len(ms))
    return statistics.median(ms)


def device_kernels(torch, fn):
    """The device kernels one call of `fn` runs: name and duration in ms,
    from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def demangle(name):
    """A kernel's C++ name without its parameter list (the mangled name
    where c++filt is missing)."""
    try:
        return sh(["c++filt", "-p", name])
    except (OSError, subprocess.CalledProcessError):
        return name


def bound_ms(n_bytes, flops, dtype):
    from repro_torch.analysis import cost
    return cost.bound_ms(flops, n_bytes, dtype)


def nbytes(*ts):
    """Bytes of each tensor once: `analysis.cost.nbytes`."""
    from repro_torch.analysis import cost
    return cost.nbytes(*ts)


# device-kernel name fragments of the port's projection GEMMs: the decode
# and prefill forms of the float-activation GEMMs (every weight source), the
# tiled mainloop kept for block shapes those forms do not take, and w8a8's
# int8 GEMV, its row-quantize kernel and its tensor-core tile
GEMM_FAMILIES = ("gemv_cluster_kernel", "gemm_pipe_kernel", "gemm_tile_kernel",
                 "w8a8_gemv_kernel", "act_quant_kernel", "w8a8_mma_kernel")
KERNEL_FAMILIES = GEMM_FAMILIES + ("fa_tc_kernel", "paged_kernel",
                                   "ledger_probe_kernel",
                                   "ssm_scan_kernel")
# device-kernel families of the GEMMs' tiled forms: at decode (m = n_slots
# = 8) every projection runs a GEMV form, so in an MLA decode dispatch these
# are the expansion of the latent cache through wkv_b (m = n_slots x max_len)
TILE_FAMILIES = ("gemm_pipe_kernel", "gemm_tile_kernel", "act_quant_kernel",
                 "w8a8_mma_kernel")
# instantiations held to no register spill: every family but the old GEMM
# mainloop
NO_SPILL = tuple(f for f in KERNEL_FAMILIES if f != "gemm_tile_kernel")


def gemm_ms(call):
    """Device ms of a traced call in the port's projection GEMMs."""
    return sum(call["device_ms_by_kernel"].get(f, 0.0) for f in GEMM_FAMILIES)


def non_gemm_ms(call):
    """Device ms of a traced call outside the port's projection GEMMs."""
    return sum(v for f, v in call["device_ms_by_kernel"].items()
               if f not in GEMM_FAMILIES)


def family(name):
    """The kernel family of a traced device op's name."""
    low = name.lower()
    return next((f for f in KERNEL_FAMILIES if f in name),
                "memcpy_memset" if "mem" in low else
                "library_gemm" if "gemm" in low or "gemv" in low else "other")


def gemm_kernels_by_grid(prof):
    """Device ms and launches of each GEMM kernel (the port's and the
    library's) of a finished profile, keyed by name and launch grid, so two
    launches of one kernel at different shapes (a batched launch over an
    MoE layer's experts, a head) tell apart. The grid is read from the
    profile's Chrome trace (written under chiprun_out/ and removed): the
    profiler's events do not carry it."""
    path = ROOT / "chiprun_out" / f"trace-{os.getpid()}.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink()
    ms, launches = {}, {}
    for e in events:
        if e.get("cat") != "kernel" or \
                family(e["name"]) not in GEMM_FAMILIES + ("library_gemm",):
            continue
        key = f"{e['name']} grid {tuple(e['args']['grid'])}"
        ms[key] = ms.get(key, 0.0) + e["dur"] / 1e3
        launches[key] = launches.get(key, 0) + 1
    return ms, launches


EMPTY_RETRIES = 2


@timed_part("traces")
def trace_call(torch, fn, grids=False):
    """Trace one call of `fn` (closed by a device sync) in its own
    torch.profiler session of device activity. Returns the device window
    (first device op's start to last one's end), the device ms by kernel
    family, the numbers of device ops and of device-to-host copies, the
    device idle share = 1 - (union of device activity) / (device window),
    and the host wall time of the traced call (the tracing widens it). With
    `grids`, also the device ms and launches of each GEMM kernel by name
    and grid (`gemm_kernels_by_grid`). A session that recorded no device
    op at all (the tracer can lose every record of a call: `routed_kernels`
    meets it on its short traces, and it once hit a phase-11 prefill) is
    taken again, at most EMPTY_RETRIES times, and counted in
    `empty_traces_retaken`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for empty in range(EMPTY_RETRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t_host = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t_host = time.perf_counter() - t_host
        device = sorted((e.time_range.start, e.time_range.end, e.name)
                        for e in prof.events()
                        if e.device_type == DeviceType.CUDA)
        if device:
            break
        print(f"    a traced call recorded no device op (trace {empty + 1})",
              flush=True)
    else:
        raise AssertionError("profiler saw no device activity in "
                             f"{EMPTY_RETRIES + 1} traces")
    t0, t1 = device[0][0], max(e for _, e, _ in device)
    busy, end, by_kernel, dtoh = 0.0, t0, {}, 0
    for s, e, name in device:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        fam = family(name)
        by_kernel[fam] = by_kernel.get(fam, 0.0) + (e - s) / 1e3
        dtoh += "DtoH" in name
    out = dict(window_ms=(t1 - t0) / 1e3, busy_ms=busy / 1e3,
               idle_share=1.0 - busy / (t1 - t0),
               traced_host_ms=t_host * 1e3, device_ms_by_kernel=by_kernel,
               dtoh_copies=dtoh, device_ops=len(device),
               empty_traces_retaken=empty)
    if grids:
        out["gemm_device_ms_by_grid"], out["gemm_launches_by_grid"] = \
            gemm_kernels_by_grid(prof)
    return out


def profile_calls(torch, fn, n, dtoh=None, retries=3, grids=False):
    """`n` traces of `fn`, each by `trace_call`. With `dtoh`, every kept
    trace must hold exactly that many device-to-host copies. The tracer can
    lose records of a call with thousands of device ops (a falcon-mamba
    decode dispatch, ~15.5k ops, lost its host copy in one trace of
    three); a trace whose copy count differs is taken again, at most
    `retries` more times in all. A real extra or missing copy repeats in
    every dispatch and still fails. `grids` goes to `trace_call`. Returns
    (kept traces, retaken ones)."""
    kept, retaken = [], []
    while len(kept) < n:
        c = trace_call(torch, fn, grids)
        if dtoh is not None and c["dtoh_copies"] != dtoh \
                and len(retaken) < retries:
            retaken.append(c)
            continue
        kept.append(c)
    if dtoh is not None:
        copies = [c["dtoh_copies"] for c in kept]
        assert copies == [dtoh] * n, \
            f"device-to-host copies per call {copies}, expected {dtoh} " \
            f"(retaken: {[c['dtoh_copies'] for c in retaken]})"
    return kept, retaken


def dispatch_fn(eng):
    """The engine's decode dispatch on its backend: `decode_block`, or
    `spec_decode_block` when it speculates. Both replay the CUDA graph
    captured at build and take eager=True to run the eager step instead,
    on the same state."""
    bk = eng.backend
    return bk.spec_decode_block if eng.cfg.speculate else bk.decode_block


def run_eager(eng):
    """Route every dispatch of `eng` through its eager step (the graph's
    A/B partner)."""
    bk = eng.backend
    name = "spec_decode_block" if eng.cfg.speculate else "decode_block"
    setattr(bk, name, functools.partial(getattr(bk, name), eager=True))
    return eng


def graph_vs_eager(torch, eng, per, turns=3, n=1, traces=1, grids=False):
    """Wall ms per micro-step (`per` micro-steps a dispatch; 1 for a
    speculative cycle) of the graphed dispatch against the eager step on
    the same state, in alternating turns of n dispatches each, in this one
    process; then `traces` traced graph dispatches (with `grids`, keyed as
    `trace_call` says) and one traced eager one, each with exactly one
    device-to-host copy."""
    fn = dispatch_fn(eng)
    fn()
    fn(eager=True)
    torch.cuda.synchronize()
    ms = {"graph": [], "eager": []}
    for _ in range(turns):
        for mode, out in ms.items():
            t = time.perf_counter()
            for _ in range(n):
                fn(eager=mode == "eager")
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3 / (n * per))
            PART_S["A/B turns"] += out[-1] * n * per / 1e3
    PART_N["A/B turns"] += 1
    graph_prof, retaken = profile_calls(torch, fn, traces, dtoh=1,
                                        grids=grids)
    eager_prof, eager_retaken = profile_calls(
        torch, lambda: fn(eager=True), 1, dtoh=1)
    return dict(graph_ms=ms["graph"], eager_ms=ms["eager"],
                graph_prof=graph_prof, eager_prof=eager_prof,
                retaken_graph_traces=len(retaken),
                retaken_eager_traces=len(eager_retaken))


def ab_summary(ab, per):
    """The A/B's numbers without the raw traces: wall ms per micro-step,
    and per micro-step device ms, device ops and the idle share of each
    traced dispatch."""
    out = dict(graph_ms=ab["graph_ms"], eager_ms=ab["eager_ms"],
               retaken_graph_traces=ab["retaken_graph_traces"],
               retaken_eager_traces=ab["retaken_eager_traces"])
    for mode in ("graph", "eager"):
        prof = ab[mode + "_prof"]
        out[mode + "_idle_share"] = [c["idle_share"] for c in prof]
        out[mode + "_device_ms"] = [c["busy_ms"] / per for c in prof]
        out[mode + "_device_ops"] = [c["device_ops"] / per for c in prof]
    return out


def print_ab(card, ab, per, unit="micro-step"):
    s = ab_summary(ab, per)
    r = lambda xs, d=3: [round(x, d) for x in xs]
    print(f"    graph against eager [{card}], wall ms / {unit} in "
          f"alternating turns: graph {r(s['graph_ms'])} (median "
          f"{statistics.median(s['graph_ms']):.3f}), eager "
          f"{r(s['eager_ms'])} (median {statistics.median(s['eager_ms']):.3f}"
          f"); device ms / {unit} graph {r(s['graph_device_ms'])} eager "
          f"{r(s['eager_device_ms'])}; device ops / {unit} graph "
          f"{s['graph_device_ops']} eager {s['eager_device_ops']}; idle share "
          f"graph {r(s['graph_idle_share'], 4)} eager "
          f"{r(s['eager_idle_share'], 4)}; traces retaken graph "
          f"{s['retaken_graph_traces']} eager {s['retaken_eager_traces']}",
          flush=True)
    return s


@timed_part("eager identity")
def eager_identity(torch, model, ecfg, prompts, gen_len, want, extras=None):
    """Serve the same traffic through a fresh engine whose every dispatch
    runs the eager step: its tokens must equal the graphed run's."""
    from repro_torch.serve import InferenceEngine
    eng = run_eager(InferenceEngine(model, ecfg))
    reqs = [eng.submit(p, gen_len, extras=None if extras is None else e)
            for p, e in zip(prompts, extras or prompts)]
    eng.run()
    torch.cuda.synchronize()
    got = [list(r.generated) for r in reqs]
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    print(f"    graph against eager tokens over {len(want)} requests: "
          f"{'identical' if not bad else f'requests {bad} differ'}",
          flush=True)
    if bad:
        raise AssertionError(f"graphed and eager tokens differ: {bad}")
    return True


def _expert_cases(torch, gen, record, experts, shapes, rows):
    """bsr_matmul_experts against its plain version at an MoE layer's
    routed shapes, one case per projection and rows C an expert."""
    from repro_torch.core import kratos as kr
    from repro_torch.core import sparsity as sp
    from repro_torch.kernels import gemm_plan, ops, ref
    dev = "cuda"
    for n, p in shapes:
        w = torch.randn((experts, n, p), generator=gen, device=dev) \
            * n ** -0.5
        spec = kr.KratosSpec(sparsity=0.5)
        plan = kr.plan_for(n, p, spec)
        packed = kr.pack_experts(w, spec)
        w.mul_(torch.as_tensor(sp.plan_mask(plan), device=dev))
        for c in rows:
            x = torch.randn((experts, c, n), generator=gen, device=dev)
            y = torch.empty((experts, c, p), device=dev)
            args = (x, packed.blocks, packed.indices)
            form = gemm_plan.bsr_plan(c, plan.n_pb, plan.nnz, plan.bk,
                                      plan.bn, 0, batch=experts).form
            record("bsr_matmul_experts", "float32",
                   ops.bsr_matmul_experts(*args),
                   ref.bsr_matmul_experts_ref(*args), TOL["float32"],
                   ("bsr_matmul_experts", c, (n, p)),
                   nbytes(x, packed.blocks, packed.indices, y),
                   2 * experts * c * plan.nnz * plan.bk * p,
                   lambda: ops.bsr_matmul_experts(*args),
                   lambda: ref.bsr_matmul_experts_ref(*args),
                   lambda: torch.bmm(x, w), experts=experts, m=c, n=n,
                   p=p, sparsity=0.5, form=form)
        del w, packed


def phase_kernels(torch, timer):
    from repro_torch.core import kratos as kr
    from repro_torch.core import quantize as qz
    from repro_torch.core import sparsity as sp
    from repro_torch.kernels import gemm_plan, ops, ref
    from repro_torch.kernels.flash_attention import (fa_plan,
                                                     flash_attention_plain)

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = []

    def record(kernel, dtype, got, want, tol, key, n_bytes, flops, run,
               plain, library, peak=None, tc_peak=None, **shape):
        err = (got.float() - want.float()).abs()
        atol, rtol = tol
        ok = bool((err <= atol + rtol * want.float().abs()).all())
        if tol == EXACT:
            ok = torch.equal(got, want)
        if kernel in BITWISE:
            first, second = run(), run()     # a tensor, or the scan's (y, h)
            if torch.is_tensor(first):
                first, second = (first,), (second,)
            if not all(map(torch.equal, first, second)):
                raise AssertionError(f"{kernel} {dtype} {shape}: two calls "
                                     "on the same inputs differ")
        b_ms, b_by = bound_ms(n_bytes, flops, peak or dtype)
        case = dict(kernel=kernel, dtype=dtype, **shape,
                    max_abs_err=float(err.max()), atol=atol, rtol=rtol,
                    ms=timer(run), plain_ms=timer(plain, iters=5),
                    library_ms=None if library is None else timer(library,
                                                                  iters=5),
                    bound_ms=b_ms, bound_by=b_by, key=key)
        if tc_peak:
            case["bound_tc_ms"] = flops / tc_peak * 1e3
        cases.append(case)
        print(f"  {kernel:16s} {dtype:8s} {json.dumps(shape)} "
              f"err={case['max_abs_err']:.3g} (atol {atol:g}, rtol {rtol:g}) "
              f"ms={case['ms']:.4f} plain={case['plain_ms']:.4f} "
              f"lib={case['library_ms'] if library is None else round(case['library_ms'], 4)} "
              f"bound={b_ms:.4f} ({b_by})", flush=True)
        if not ok:
            raise AssertionError(f"{kernel} {dtype} {shape}: max abs error "
                                 f"{case['max_abs_err']} over tolerance")

    for dtype in DTYPES:
        dt = getattr(torch, dtype)
        for n, p in GEMM_SHAPES + [XPROJ]:
            w32 = torch.randn((n, p), generator=gen, device=dev) * n ** -0.5
            w = w32.to(dt)
            for m in GEMM_ROWS:
                x = torch.randn((m, n), generator=gen, device=dev).to(dt)
                y = torch.empty((m, p), dtype=dt, device=dev)
                record("dense_matmul", dtype, ops.matmul(x, w),
                       ref.dense_matmul_ref(x, w), TOL[dtype],
                       ("dense_matmul", dtype, m, (n, p), 0.0, None),
                       nbytes(x, w, y), 2 * m * n * p,
                       lambda: ops.matmul(x, w),
                       lambda: ref.dense_matmul_ref(x, w),
                       lambda: torch.matmul(x, w), m=m, n=n, p=p)
                if (n, p) == XPROJ:
                    continue
                for s in SPARSITIES:
                    spec = kr.KratosSpec(sparsity=s)
                    plan = kr.plan_for(n, p, spec)
                    idx = torch.as_tensor(plan.indices, device=dev)
                    keep = plan.nnz * plan.bk
                    blocks = sp.pack_blocks(w, plan)
                    w_mask = w * torch.as_tensor(sp.plan_mask(plan), dtype=dt,
                                                 device=dev)
                    form = gemm_plan.bsr_plan(
                        m, plan.n_pb, plan.nnz, plan.bk, plan.bn, 0,
                        x.element_size()).form
                    record("bsr_matmul", dtype, ops.bsr_matmul(x, blocks, idx),
                           ref.bsr_matmul_ref(x, blocks, idx), TOL[dtype],
                           ("bsr_matmul", dtype, m, (n, p), s, None),
                           nbytes(x, blocks, idx, y), 2 * m * keep * p,
                           lambda: ops.bsr_matmul(x, blocks, idx),
                           lambda: ref.bsr_matmul_ref(x, blocks, idx),
                           lambda: torch.matmul(x, w_mask),
                           m=m, n=n, p=p, sparsity=s, form=form)
                    for bits in BITS:
                        buf = kr.pack({"w": w32}, spec.with_(bits=bits))
                        qb, sc = buf["qblocks"], buf["qscale"]
                        scale = qz.compute_scale(w32, bits)
                        w_deq = (qz.quantize_values(w32, scale, bits).float()
                                 * scale * torch.as_tensor(
                                     sp.plan_mask(plan), device=dev)).to(dt)
                        form = gemm_plan.bsr_plan(
                            m, plan.n_pb, plan.nnz, plan.bk, plan.bn, bits,
                            x.element_size()).form
                        record("bsr_quant_matmul", dtype,
                               ops.bsr_quant_matmul(x, qb, sc, idx, bits),
                               ref.bsr_quant_matmul_ref(x, qb, sc, idx, bits),
                               TOL[dtype],
                               ("bsr_quant_matmul", dtype, m, (n, p), s, bits),
                               nbytes(x, qb, sc, idx, y), 2 * m * keep * p,
                               lambda: ops.bsr_quant_matmul(x, qb, sc, idx,
                                                            bits),
                               lambda: ref.bsr_quant_matmul_ref(x, qb, sc,
                                                                idx, bits),
                               lambda: torch.matmul(x, w_deq),
                               m=m, n=n, p=p, sparsity=s, bits=bits,
                               form=form)

    # weight-only and w8a8 GEMMs on the same shapes and rows
    for dtype in DTYPES:
        dt = getattr(torch, dtype)
        for n, p in GEMM_SHAPES + [XPROJ]:
            w32 = torch.randn((n, p), generator=gen, device=dev) * n ** -0.5
            qts = {bits: qz.quantize(w32, bits) for bits in BITS}
            w_deq = {bits: qz.dequantize(qt, dt) for bits, qt in qts.items()}
            for m in GEMM_ROWS:
                x = torch.randn((m, n), generator=gen, device=dev).to(dt)
                y = torch.empty((m, p), dtype=dt, device=dev)
                for bits, qt in qts.items():
                    record("quant_matmul", dtype, ops.quant_matmul(x, qt),
                           ref.quant_matmul_ref(x, qt), TOL[dtype],
                           ("quant_matmul", dtype, m, (n, p), bits),
                           nbytes(x, qt.data, qt.scale, y), 2 * m * n * p,
                           lambda: ops.quant_matmul(x, qt),
                           lambda: ref.quant_matmul_ref(x, qt),
                           lambda: torch.matmul(x, w_deq[bits]),
                           m=m, n=n, p=p, bits=bits)
                qt = qts[8]
                # the kernel's codes and row scales are made as PyTorch makes
                # them on the card, its int32 sums are exact like the plain
                # version's float64 ones, and the dequant takes the same
                # steps: bit for bit
                record("quant_matmul_w8a8", dtype,
                       ops.quant_matmul_w8a8(x, qt),
                       ref.quant_matmul_w8a8_ref(x, qt), EXACT,
                       ("quant_matmul_w8a8", dtype, m, (n, p)),
                       nbytes(x, qt.data, qt.scale, y), 2 * m * n * p,
                       lambda: ops.quant_matmul_w8a8(x, qt),
                       lambda: ref.quant_matmul_w8a8_ref(x, qt),
                       lambda: torch.matmul(x, w_deq[8]),
                       m=m, n=n, p=p, peak="int8",
                       form=gemm_plan.w8a8_plan(m, n, p).form)

    # flash attention: h2o-danube prefill heads (32 q over 8 kv, d = 80),
    # and nemotron-4-340b's (96 q over 8 kv, d = 192)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype in DTYPES:
        dt = getattr(torch, dtype)
        for heads, d, sqs, caps in ((32, 80, (16, 77, 512), (None, 50.0)),
                                    (96, 192, (77, 512), (None,))):
            for sq in sqs:
                q = torch.randn((1, heads, sq, d), generator=gen,
                                device=dev).to(dt)
                k = torch.randn((1, 8, sq, d), generator=gen, device=dev).to(dt)
                v = torch.randn((1, 8, sq, d), generator=gen, device=dev).to(dt)
                qf, kf, vf = q[0], k[0], v[0]
                pos = np.arange(sq)
                for window in (None, 64):
                    live = pos[None, :] <= pos[:, None]
                    if window is not None:
                        live &= pos[None, :] > pos[:, None] - window
                    mask = torch.as_tensor(live, device=dev)
                    for cap in caps:
                        kw = dict(window=window, softcap=cap)
                        if cap is not None:
                            library = None
                        elif window is None:
                            library = lambda: sdpa(q, k, v, is_causal=True,
                                                   enable_gqa=True)
                        else:
                            library = lambda: sdpa(q, k, v, attn_mask=mask,
                                                   enable_gqa=True)
                        record("flash_attention", dtype,
                               (o := ops.flash_attention(q, k, v, **kw)),
                               flash_attention_plain(qf, kf, vf, **kw)[None],
                               FA_TOL[dtype],
                               ("flash_attention", dtype, sq, window, cap, d),
                               nbytes(q, k, v, o),
                               4 * d * int(live.sum()) * heads,
                               lambda: ops.flash_attention(q, k, v, **kw),
                               lambda: flash_attention_plain(qf, kf, vf, **kw),
                               library, tc_peak=TC_FLOPS[dtype], sq=sq,
                               heads=heads, kv_heads=8, d=d, window=window,
                               softcap=cap,
                               bkv=fa_plan(d, q.element_size()).bkv)

    # paged decode attention: 8 slots with random clocks over a shuffled
    # page pool, slot 3 idle on the sink page; h2o-danube (32/8 heads,
    # d = 80, 34 pages of 16 = 544 positions) and nemotron-4-340b (96/8,
    # d = 192, 48 pages = 768 positions)
    b, page = 8, 16
    for dtype in DTYPES:
        dt = getattr(torch, dtype)
        for heads, d, pp in ((32, 80, 34), (96, 192, 48)):
            n_pages = b * pp + 1
            kp = torch.randn((n_pages, 8, page, d), generator=gen,
                             device=dev).to(dt)
            vp = torch.randn((n_pages, 8, page, d), generator=gen,
                             device=dev).to(dt)
            perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
            table = perm.reshape(b, pp).to(torch.int32)
            table[3] = 0
            last = torch.randint(pp * page // 4, pp * page, (b,),
                                 generator=gen, device=dev).to(torch.int32)
            last_np, table_np = last.cpu().numpy(), table.cpu().numpy()
            kview = ref.paged_view(kp, table)
            vview = ref.paged_view(vp, table)
            # sq 5: h2o-danube's speculative verify block (K = 4), 4 x 5 =
            # 20 query rows a kv head, two 16-row tiles
            for sq in (1, 3, 5) if heads == 32 else (1, 3):
                q = torch.randn((b, heads, sq, d), generator=gen,
                                device=dev).to(dt)
                kpos = np.arange(pp * page)
                qpos = last_np[:, None] - (sq - 1) + np.arange(sq)[None, :]
                for window in (None, 64):
                    live = kpos[None, None, :] <= qpos[:, :, None]
                    if window is not None:
                        live &= kpos[None, None, :] > qpos[:, :, None] - window
                    # bytes: q, out, table, clocks and every distinct live
                    # K/V page once
                    first = np.zeros(b, np.int64) if window is None else \
                        np.maximum(0, (last_np - (sq - 1) - window - page
                                       + 1) // page + 1)
                    pages_read = set()
                    for bb in range(b):
                        pages_read.update(
                            table_np[bb, first[bb]:last_np[bb] // page + 1])
                    kv_bytes = len(pages_read) * 2 * 8 * page * d \
                        * kp.element_size()
                    mask = torch.as_tensor(live, device=dev)[:, None]
                    for cap in (None, 50.0):
                        kw = dict(window=window, softcap=cap)
                        library = None if cap is not None else (
                            lambda: sdpa(q, kview, vview, attn_mask=mask,
                                         enable_gqa=True))
                        args = (q, kp, vp, table, last)
                        record("paged_flash_attention", dtype,
                               (o := ops.paged_attention(*args, **kw)),
                               ref.paged_attention_ref(*args, **kw),
                               FA_TOL[dtype],
                               ("paged_flash_attention", dtype, d, sq, window,
                                cap),
                               kv_bytes + nbytes(q, o, table, last),
                               4 * d * heads * int(live.sum()),
                               lambda: ops.paged_attention(*args, **kw),
                               lambda: ref.paged_attention_ref(*args, **kw),
                               library, slots=b, heads=heads, kv_heads=8,
                               d=d, page=page, pages_per_slot=pp, sq=sq,
                               window=window, softcap=cap)

    # selective scan: falcon-mamba prefill (1 sequence, d_inner 8192,
    # d_state 16) at 1, 7, 64 and 512 positions, and a ragged small case;
    # inputs drawn as tests/test_ssm_kernel.py draws them. No PyTorch call
    # computes a selective scan, so there is no library time. Operations:
    # per (position, channel, state) element, dt*a, exp, dt*u, *b, the
    # update's multiply-add and the output's multiply-add, 8 in f32
    n = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    for dtype in DTYPES:
        dt = getattr(torch, dtype)
        for bsz, s, di, st in ((1, 1, 8192, 16), (1, 7, 8192, 16),
                               (1, 64, 8192, 16), (1, 512, 8192, 16),
                               (2, 33, 128, 8)):
            u = n(bsz, s, di) * 0.5
            delta = torch.nn.functional.softplus(n(bsz, s, di) - 1.0)
            b_, c_ = n(bsz, s, st) * 0.5, n(bsz, s, st) * 0.5
            a = -torch.exp(n(di, st) * 0.3)
            args = [x.to(dt) for x in (u, delta, b_, c_)] + [a]
            y, h = ops.ssm_scan(*args)
            want_y, want_h = ref.ssm_scan_ref(*args)
            record("ssm_scan", dtype,
                   torch.cat([y.float().flatten(), h.flatten()]),
                   torch.cat([want_y.float().flatten(), want_h.flatten()]),
                   SSM_TOL[dtype], ("ssm_scan", dtype, bsz, s, di, st),
                   nbytes(*args, y, h), 8 * bsz * s * di * st,
                   lambda: ops.ssm_scan(*args),
                   lambda: ref.ssm_scan_ref(*args), None, peak="float32",
                   batch=bsz, s=s, d_inner=di, d_state=st)

    # gemma2-27b's attention: 32 q over 16 kv heads, d = 128, softcap 50,
    # query scale 1/12. Flash prefill at sq 512 and 4160 (past the local
    # layers' 4096 window: tiles wholly behind it are skipped); paged decode
    # over 8 slots of 34 pages of 16, sq 1 and the verify block sq 5. SDPA
    # has no softcap: its time on the same inputs, mask and scale without
    # the cap is the yardstick
    for sq in (512, 4160):
        q = torch.randn((1, 32, sq, 128), generator=gen, device=dev)
        k = torch.randn((1, 16, sq, 128), generator=gen, device=dev)
        v = torch.randn((1, 16, sq, 128), generator=gen, device=dev)
        qf, kf, vf = q[0], k[0], v[0]
        pos = torch.arange(sq, device=dev)
        for window in (None, 4096):
            live = pos[None, :] <= pos[:, None]
            if window is not None:
                live &= pos[None, :] > pos[:, None] - window
            n_live = int(live.sum())
            kw = dict(window=window, softcap=50.0, scale=GEMMA_SCALE)
            library = (lambda: sdpa(q, k, v, is_causal=True, scale=GEMMA_SCALE,
                                    enable_gqa=True)) if window is None else (
                lambda: sdpa(q, k, v, attn_mask=live, scale=GEMMA_SCALE,
                             enable_gqa=True))
            record("flash_attention", "float32",
                   (o := ops.flash_attention(q, k, v, **kw)),
                   flash_attention_plain(qf, kf, vf, **kw)[None],
                   FA_TOL["float32"],
                   ("flash_attention", "float32", sq, window, 50.0, 128),
                   nbytes(q, k, v, o), 4 * 128 * n_live * 32,
                   lambda: ops.flash_attention(q, k, v, **kw),
                   lambda: flash_attention_plain(qf, kf, vf, **kw),
                   library, tc_peak=TC_FLOPS["float32"], sq=sq, heads=32,
                   kv_heads=16, d=128, window=window, softcap=50.0,
                   scale=GEMMA_SCALE, library_without_softcap=True,
                   bkv=fa_plan(128, 4).bkv)
            del live
    b, page, pp, h_kv = 8, 16, 34, 16
    n_pages = b * pp + 1
    kp = torch.randn((n_pages, h_kv, page, 128), generator=gen, device=dev)
    vp = torch.randn((n_pages, h_kv, page, 128), generator=gen, device=dev)
    table = (torch.randperm(n_pages - 1, generator=gen, device=dev)
             + 1).reshape(b, pp).to(torch.int32)
    table[3] = 0
    last = torch.randint(pp * page // 4, pp * page, (b,), generator=gen,
                         device=dev).to(torch.int32)
    last_np, table_np = last.cpu().numpy(), table.cpu().numpy()
    kview, vview = ref.paged_view(kp, table), ref.paged_view(vp, table)
    kpos = np.arange(pp * page)
    pages_read = set()
    for bb in range(b):
        pages_read.update(table_np[bb, :last_np[bb] // page + 1])
    kv_bytes = len(pages_read) * 2 * h_kv * page * 128 * 4
    for sq in (1, 5):
        q = torch.randn((b, 32, sq, 128), generator=gen, device=dev)
        qpos = last_np[:, None] - (sq - 1) + np.arange(sq)[None, :]
        live = kpos[None, None, :] <= qpos[:, :, None]
        mask = torch.as_tensor(live, device=dev)[:, None]
        kw = dict(softcap=50.0, scale=GEMMA_SCALE)
        args = (q, kp, vp, table, last)
        record("paged_flash_attention", "float32",
               (o := ops.paged_attention(*args, **kw)),
               ref.paged_attention_ref(*args, **kw), FA_TOL["float32"],
               ("paged_flash_attention", "float32", 128, sq, None, 50.0),
               kv_bytes + nbytes(q, o, table, last),
               4 * 128 * 32 * int(live.sum()),
               lambda: ops.paged_attention(*args, **kw),
               lambda: ref.paged_attention_ref(*args, **kw),
               lambda: sdpa(q, kview, vview, attn_mask=mask,
                            scale=GEMMA_SCALE, enable_gqa=True),
               slots=b, heads=32, kv_heads=h_kv, d=128, page=page,
               pages_per_slot=pp, sq=sq, window=None, softcap=50.0,
               scale=GEMMA_SCALE, library_without_softcap=True)

    # minicpm3-4b's projections at decode (m = 8 slots), and wkv_b at the
    # naive MLA expansion's m = 8 x 544: packed dense, s0.5-w8 (wkv_a's 288
    # outputs are off the 128 grid: no plan, w8 codes) and w8 (the
    # speculative draft's), each through the kernel `apply_packed` picks.
    # The library time is torch.matmul on the effective weight (masked
    # and/or dequantized), which the plain version gives from an identity
    for leaf, (n, p) in MLA_SHAPES.items():
        w32 = torch.randn((n, p), generator=gen, device=dev) * n ** -0.5
        for spec in (kr.DENSE, kr.KratosSpec(sparsity=0.5, bits=8),
                     kr.KratosSpec(bits=8)):
            lin = kr.pack_linear({"w": w32}, spec)
            w_eff = kr.plain_packed(lin, torch.eye(n, device=dev))
            plan = kr.plan_for(n, p, lin.spec)
            keep = n if plan is None or "qt" in lin.buffers \
                else plan.nnz * plan.bk
            for m in (8,) + ((EXPANSION_ROWS,) if leaf == "wkv_b" else ()):
                x = torch.randn((m, n), generator=gen, device=dev)
                y = torch.empty((m, p), device=dev)
                ops.reset_launch_counts()
                got = kr.apply_packed(lin, x)
                kernel = next(name for name, c in ops.launch_counts().items()
                              if c)
                idx = () if lin.indices is None else (lin.indices,)
                record(kernel, "float32", got, kr.plain_packed(lin, x),
                       TOL["float32"], ("mla", leaf, kr.spec_tag(spec), m),
                       nbytes(x, y, *idx) + lin.packed_bytes,
                       2 * m * keep * p,
                       lambda: kr.apply_packed(lin, x),
                       lambda: kr.plain_packed(lin, x),
                       lambda: torch.matmul(x, w_eff), m=m, n=n, p=p,
                       leaf=leaf, spec=kr.spec_tag(lin.spec))
            del w_eff

    # bsr_matmul batched over an MoE layer's experts: deepseek-moe-16b's 64
    # routed experts, w_gate / w_up (2048 -> 1408) and w_down (1408 ->
    # 2048) at s0.5, C = 6 rows an expert (decode at 8 slots) and C = 60 (a
    # 512-token prefill); one launch a call. Bytes: x, the kept blocks, the
    # index table and y once; operations: every expert's C rows against
    # its kept k. The library time is torch.bmm on the masked dense stack
    # then jamba-v0.1-52b's 16 routed experts, w_gate / w_up (4096 ->
    # 14336) and w_down (14336 -> 4096) at s0.5, C = 2 (decode at 8 slots)
    # and C = 80 (a 512-token prefill): 1.88 GB of kept blocks a projection
    for experts, shapes, rows in ((64, EXPERT_SHAPES, EXPERT_ROWS),
                                  (16, JAMBA_EXPERT_SHAPES,
                                   JAMBA_EXPERT_ROWS)):
        _expert_cases(torch, gen, record, experts, shapes, rows)

    # whisper-large-v3 (phase 15): the encoder's self-attention, non-causal
    # over 1500 frames (20 heads of 64 over 20 kv heads; 23 full q tiles
    # and a tail of 28), with SDPA without a mask as the yardstick
    q, k, v = (torch.randn((1, 20, WHISPER_FRAMES, 64), generator=gen,
                           device=dev) for _ in range(3))
    qf, kf, vf = q[0], k[0], v[0]
    record("flash_attention", "float32",
           (o := ops.flash_attention(q, k, v, causal=False)),
           flash_attention_plain(qf, kf, vf, causal=False)[None],
           FA_TOL["float32"], ("whisper", "flash_attention"),
           nbytes(q, k, v, o), 4 * 64 * WHISPER_FRAMES ** 2 * 20,
           lambda: ops.flash_attention(q, k, v, causal=False),
           lambda: flash_attention_plain(qf, kf, vf, causal=False),
           lambda: sdpa(q, k, v, is_causal=False), tc_peak=TC_FLOPS["float32"],
           sq=WHISPER_FRAMES, skv=WHISPER_FRAMES, heads=20, kv_heads=20, d=64,
           causal=False, bkv=fa_plan(64, 4).bkv)
    # the decoder's self-attention at decode from the page pool: 8 slots of
    # up to 28 pages of 16 (max_len 448), 20/20 heads of 64, slot 3 idle on
    # the sink page
    b, page, pp, heads = 8, 16, WHISPER_MAX_LEN // 16, 20
    n_pages = b * pp + 1
    kp, vp = (torch.randn((n_pages, heads, page, 64), generator=gen,
                          device=dev) for _ in range(2))
    table = (torch.randperm(n_pages - 1, generator=gen, device=dev)
             + 1).reshape(b, pp).to(torch.int32)
    table[3] = 0
    last = torch.randint(4, pp * page, (b,), generator=gen,
                         device=dev).to(torch.int32)
    last_np, table_np = last.cpu().numpy(), table.cpu().numpy()
    pages_read = set()
    for bb in range(b):
        pages_read.update(table_np[bb, :last_np[bb] // page + 1])
    live = np.arange(pp * page)[None, None, :] <= last_np[:, None, None]
    mask = torch.as_tensor(live, device=dev)[:, None]
    kview, vview = ref.paged_view(kp, table), ref.paged_view(vp, table)
    q = torch.randn((b, heads, 1, 64), generator=gen, device=dev)
    args = (q, kp, vp, table, last)
    record("paged_flash_attention", "float32",
           (o := ops.paged_attention(*args)),
           ref.paged_attention_ref(*args), FA_TOL["float32"],
           ("whisper", "paged_flash_attention"),
           len(pages_read) * 2 * heads * page * 64 * 4
           + nbytes(q, o, table, last), 4 * 64 * heads * int(live.sum()),
           lambda: ops.paged_attention(*args),
           lambda: ref.paged_attention_ref(*args),
           lambda: sdpa(q, kview, vview, attn_mask=mask),
           slots=b, heads=heads, kv_heads=heads, d=64, page=page,
           pages_per_slot=pp, sq=1)
    del kp, vp, kview, vview
    # the projections' GEMMs, 1280 -> 5120 (w_up) and 5120 -> 1280
    # (w_down), at m = 8 (decode) and m = 1500 (the encoder's frames, and
    # the cross k/v of an admission), dense and s0.5-w8 through the kernel
    # `apply_packed` picks; the library time is torch.matmul on the
    # effective weight
    for n, p in ((1280, 5120), (5120, 1280)):
        w32 = torch.randn((n, p), generator=gen, device=dev) * n ** -0.5
        for spec in (kr.DENSE, kr.KratosSpec(sparsity=0.5, bits=8)):
            lin = kr.pack_linear({"w": w32}, spec)
            w_eff = kr.plain_packed(lin, torch.eye(n, device=dev))
            plan = kr.plan_for(n, p, lin.spec)
            keep = n if plan is None else plan.nnz * plan.bk
            for m in (8, WHISPER_FRAMES):
                x = torch.randn((m, n), generator=gen, device=dev)
                y = torch.empty((m, p), device=dev)
                ops.reset_launch_counts()
                got = kr.apply_packed(lin, x)
                kernel = next(name for name, c in ops.launch_counts().items()
                              if c)
                idx = () if lin.indices is None else (lin.indices,)
                record(kernel, "float32", got, kr.plain_packed(lin, x),
                       TOL["float32"],
                       ("whisper", (n, p), kr.spec_tag(spec), m),
                       nbytes(x, y, *idx) + lin.packed_bytes,
                       2 * m * keep * p,
                       lambda: kr.apply_packed(lin, x),
                       lambda: kr.plain_packed(lin, x),
                       lambda: torch.matmul(x, w_eff), m=m, n=n, p=p,
                       spec=kr.spec_tag(lin.spec), model="whisper")
            del w_eff

    # the event pair against the profiler's own kernel duration at the
    # headline rows of the redesigned kernels (same shapes, fresh inputs):
    # the five decode GEMVs, flash attention at sq 512, paged decode
    # attention and the selective scan
    n, p = HEADLINE["dense_matmul"][3]
    w32 = torch.randn((n, p), generator=gen, device=dev) * n ** -0.5
    x = torch.randn((8, n), generator=gen, device=dev)
    q4 = qz.quantize(w32, 4)
    spec = kr.KratosSpec(sparsity=0.5, bits=8)
    buf = kr.pack({"w": w32}, spec)
    idx = torch.as_tensor(kr.plan_for(n, p, spec).indices, device=dev)
    blocks = sp.pack_blocks(w32, kr.plan_for(n, p, spec))
    q8 = qz.quantize(w32, 8)
    fa_in = {d: [torch.randn((1, h, 512, d), generator=gen, device=dev)
                 for h in (hq, 8, 8)] for hq, d in ((32, 80), (96, 192))}
    profiled = [
        ("dense_matmul", HEADLINE["dense_matmul"], "gemv_cluster_kernel",
         lambda: ops.matmul(x, w32)),
        ("quant_matmul", HEADLINE["quant_matmul"], "gemv_cluster_kernel",
         lambda: ops.quant_matmul(x, q4)),
        ("bsr_quant_matmul", HEADLINE["bsr_quant_matmul"],
         "gemv_cluster_kernel",
         lambda: ops.bsr_quant_matmul(x, buf["qblocks"], buf["qscale"], idx,
                                      8)),
        ("bsr_matmul", HEADLINE["bsr_matmul"], "gemv_cluster_kernel",
         lambda: ops.bsr_matmul(x, blocks, idx)),
        ("quant_matmul_w8a8", HEADLINE["quant_matmul_w8a8"],
         "w8a8_gemv_kernel", lambda: ops.quant_matmul_w8a8(x, q8))]
    for d in (80, 192):
        profiled.append(("flash_attention",
                         ("flash_attention", "float32", 512, None, None, d),
                         "fa_tc_kernel",
                         lambda d=d: ops.flash_attention(*fa_in[d])))
    # one h2o-danube layer's paged decode (8 slots, 34 pages of 16, slot 3
    # idle on the sink page) and one falcon-mamba layer's 512-token scan
    n_pages = 8 * 34 + 1
    pg_kv = [torch.randn((n_pages, 8, 16, 80), generator=gen, device=dev)
             for _ in range(2)]
    pg_table = (torch.randperm(n_pages - 1, generator=gen, device=dev)
                + 1).reshape(8, 34).to(torch.int32)
    pg_table[3] = 0
    pg_last = torch.randint(34 * 16 // 4, 34 * 16, (8,), generator=gen,
                            device=dev).to(torch.int32)
    pg_q = torch.randn((8, 32, 1, 80), generator=gen, device=dev)
    profiled.append(("paged_flash_attention",
                     HEADLINE["paged_flash_attention"], "paged_kernel",
                     lambda: ops.paged_attention(pg_q, *pg_kv, pg_table,
                                                 pg_last)))
    scan_in = [torch.randn(shape, generator=gen, device=dev)
               for shape in ((1, 512, 8192),) * 2 + ((1, 512, 16),) * 2
               + ((8192, 16),)]
    scan_in = [scan_in[0] * 0.5,
               torch.nn.functional.softplus(scan_in[1] - 1.0),
               scan_in[2] * 0.5, scan_in[3] * 0.5,
               -torch.exp(scan_in[4] * 0.3)]
    profiled.append(("ssm_scan", HEADLINE["ssm_scan"], "ssm_scan_kernel",
                     lambda: ops.ssm_scan(*scan_in)))
    n, p = HEADLINE["bsr_matmul_experts"][2]
    ex = kr.pack_experts(torch.randn((64, n, p), generator=gen, device=dev)
                         * n ** -0.5, kr.KratosSpec(sparsity=0.5))
    ex_x = torch.randn((64, HEADLINE["bsr_matmul_experts"][1], n),
                       generator=gen, device=dev)
    profiled.append(("bsr_matmul_experts", HEADLINE["bsr_matmul_experts"],
                     "gemv_cluster_kernel",
                     lambda: ops.bsr_matmul_experts(ex_x, ex.blocks,
                                                    ex.indices)))
    for name, key, family, fn in profiled:
        case = next(c for c in cases if c["key"] == key)
        case["profiler_ms"] = profiled_kernel_ms(torch, fn, family)
        case["events_ms_same_inputs"] = timer(fn)
        print(f"  {name} {key[1:]}: events "
              f"{case['events_ms_same_inputs']:.4f} ms, profiler kernel "
              f"duration {case['profiler_ms']:.4f} ms", flush=True)
    # which kernel SDPA runs for f32 at d = 192 (the library yardstick of
    # the flash rows), by name and device time, from the profiler
    case = next(c for c in cases if c["key"] == (
        "flash_attention", "float32", 512, None, None, 192))
    case["library_kernels"] = device_kernels(torch, lambda: sdpa(
        *fa_in[192], is_causal=True, enable_gqa=True))
    print(f"  SDPA f32 d=192 sq=512 runs: {case['library_kernels']}",
          flush=True)
    torch.cuda.synchronize()
    return cases


@timed_part("parity")
def phase_parity(torch, arch, s0, max_len, **overrides):
    """The port's forward on the card against the same forward on the CPU
    (plain versions): `arch` at full width cut to 2 layers (or the config
    `overrides` give), a batch of 2 prompts of s0 tokens (after
    n_img_tokens stub image rows for a vision arch; after the encoder over
    the audio stub's frames of two 30 s waveforms for an encoder-decoder,
    whose output is held to the CPU's too), then 4 greedy decode steps.
    Returns the kernel launches of the card's prefills (an encoder's
    included: each of its layers launches flash attention non-causal, and
    each decoder layer causal, once a prefill)."""
    from repro_torch import configs as C
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import ops
    from repro_torch.models import frontends as F
    from repro_torch.models import transformer as T
    from repro_torch.serve.registry import pack_model_params, tree_to

    cfg = C.get_config(arch, **{"n_layers": 2, **overrides})
    params = T.init(cfg, seed=SEED, device="cuda")
    params_cpu = tree_to(params, "cpu")
    rng = np.random.default_rng(SEED)
    b, steps = 2, 4
    tokens = rng.integers(0, cfg.vocab, (b, s0)).astype(np.int32)
    n_img = cfg.n_img_tokens
    img = F.llava_patches(rng.random((b, 336, 336, 3)), cfg.d_model,
                          device="cpu")[:, :n_img] if n_img else None
    frames = F.whisper_frames(rng.standard_normal((b, WHISPER_SAMPLES)),
                              cfg.d_model, device="cpu") \
        if cfg.enc_dec else None
    prefill_launches = {name: 0 for name in ops.KERNELS}
    for spec in (kr.DENSE, kr.KratosSpec(sparsity=0.5, bits=8)):
        out = {}
        for dev, tree in (("cuda", params), ("cpu", params_cpu)):
            packed, _ = pack_model_params(tree, spec)
            caches = T.make_caches(cfg, b, max_len, torch.float32, dev)
            ops.reset_launch_counts()
            enc_out = None
            if frames is not None:
                enc_out = T.encode(packed, frames.to(dev), cfg)
                out[dev + "_enc"] = enc_out.cpu()
                if dev == "cuda":
                    assert ops.launch_counts()["flash_attention"] == \
                        cfg.n_enc_layers, ops.launch_counts()
            logits, caches = T.forward(
                packed, torch.from_numpy(tokens).to(dev), cfg, caches=caches,
                img_embeds=None if img is None else img.to(dev),
                enc_out=enc_out)
            if dev == "cuda" and frames is not None:
                # the decoder's layers add one causal launch each
                assert ops.launch_counts()["flash_attention"] == \
                    cfg.n_enc_layers + cfg.n_layers, ops.launch_counts()
            for name, c in ops.launch_counts().items():
                prefill_launches[name] += c
            out[dev] = [logits.cpu()]
            out[dev + "_state"] = (packed, caches)
        worst = float((out["cuda"][0] - out["cpu"][0]).abs().max())
        if frames is not None:
            enc_err = float((out["cuda_enc"] - out["cpu_enc"]).abs().max())
            print(f"  parity {arch}: encoder output max |diff| card vs CPU "
                  f"= {enc_err:.3g} (tol 1e-3)", flush=True)
            assert enc_err <= 1e-3, enc_err
        tok = out["cpu"][0][:, -1].argmax(-1).to(torch.int32)
        same = bool((out["cuda"][0][:, -1].argmax(-1) == tok.long()).all())
        for step in range(steps):
            index = torch.full((b,), n_img + s0 + step, dtype=torch.int32)
            lg = {}
            for dev in ("cuda", "cpu"):
                packed, caches = out[dev + "_state"]
                lg[dev], _ = T.forward(packed, tok[:, None].to(dev), cfg,
                                       caches=caches, index=index.to(dev))
                lg[dev] = lg[dev].cpu()
            worst = max(worst, float((lg["cuda"] - lg["cpu"]).abs().max()))
            tok = lg["cpu"][:, -1].argmax(-1).to(torch.int32)
            same &= bool((lg["cuda"][:, -1].argmax(-1) == tok.long()).all())
        tag = kr.spec_tag(spec)
        print(f"  parity {arch} {tag}: max |logit diff| card vs CPU = "
              f"{worst:.3g} (tol 1e-3), greedy tokens identical: {same}",
              flush=True)
        if worst > 1e-3 or not same:
            raise AssertionError(f"model parity failed for {arch} {tag}")
    del params, params_cpu, out
    gc.collect()
    torch.cuda.empty_cache()
    return prefill_launches


DANUBE = "h2o-danube-1.8b"
N_SLOTS, GEN_LEN, CHUNK = 8, 32, 4


def serving_traffic(vocab=32000):
    """Phases 5, 6 and 8: 16 prompts of 32-512 tokens from the seed."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(32, 513, 16)
    return [rng.integers(0, vocab, int(s)).astype(np.int32) for s in lens]


def init_danube(torch):
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    t0 = time.perf_counter()
    params = T.init(C.get_config(DANUBE), seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"  init full-width {DANUBE} (f32): {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    return params


def phase_serving(torch, card, params):
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import ops
    from repro_torch.serve import EngineConfig, InferenceEngine, ModelRegistry

    arch, n_slots, gen_len, k = DANUBE, N_SLOTS, GEN_LEN, CHUNK
    reg = ModelRegistry()
    prompts = serving_traffic()
    specs = {"dense": (kr.DENSE, "dense_matmul"),
             "s0.5": (kr.KratosSpec(sparsity=0.5), "bsr_matmul"),
             "s0.5-w8": (kr.KratosSpec(sparsity=0.5, bits=8),
                         "bsr_quant_matmul")}
    totals = {name: 0 for name in ops.KERNELS}
    results = {}
    for tag, (spec, gemm) in specs.items():
        t0 = time.perf_counter()
        model = reg.load(arch, spec, smoke=False, params=params, seed=SEED)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        ecfg = EngineConfig(n_slots=n_slots, max_len=512 + gen_len,
                            decode_chunk=k, seed=SEED)
        warm = InferenceEngine(model, ecfg)          # allocator warm-up
        warm.submit(prompts[0][:32], 4)
        warm.run()
        del warm
        eng = InferenceEngine(model, ecfg)
        reqs = [eng.submit(p, gen_len) for p in prompts]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        for name, c in counts.items():
            totals[name] += c
        rep = eng.metrics.report()
        for r in reqs:
            assert r.done and len(r.generated) == gen_len
            assert all(0 <= t < model.cfg.vocab for t in r.generated)
        for name in GEMM_KERNELS:
            assert (counts[name] > 0) == (name == gemm), (tag, counts)
        assert counts["flash_attention"] > 0, counts
        # bookkeeping only (the engine counts one sync per dispatch); the
        # checks are the sync-debug guard around every dispatch and the
        # traced device-to-host copies below
        assert rep["host_syncs_decode"] == rep["decode_steps"], rep
        # decode dispatch time at full slab width (masks make the work the
        # same whether slots are live or parked), graph against eager
        ab = graph_vs_eager(torch, eng, k, traces=2)
        step_ms = statistics.median(ab["graph_ms"])
        decode_prof, retaken = ab["graph_prof"], ab["retaken_graph_traces"]
        # one 512-token prefill (the largest bucket), wall and device time
        batch = {"tokens": torch.from_numpy(
            np.resize(prompts[0], (1, 512)).astype(np.int32)).cuda()}
        eng.backend.prefill(batch, exact=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng.backend.prefill(batch, exact=True)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t1) * 1e3
        prefill_prof, _ = profile_calls(
            torch, lambda: eng.backend.prefill(batch, exact=True), 2)
        gemm = [gemm_ms(c) / k for c in decode_prof]
        other = [non_gemm_ms(c) / k for c in decode_prof]
        n_ops = [c["device_ops"] / k for c in decode_prof]
        prefill_gemm = [gemm_ms(c) for c in prefill_prof]
        results[tag] = dict(
            gemm_device_ms_per_micro_step=gemm,
            non_gemm_device_ms_per_micro_step=other,
            device_ops_per_micro_step=n_ops,
            prefill_512_gemm_device_ms=prefill_gemm,
            prefill_512_ms=prefill_ms, prefill_512_profiled=prefill_prof,
            decode_dispatch_profiled=decode_prof,
            retaken_decode_traces=retaken,
            spec=kr.spec_tag(spec), pack_s=pack_s, wall_s=wall,
            tok_per_s=rep["tokens_generated"] / wall,
            latency_s_p50=rep["latency_s_p50"],
            latency_s_p99=rep["latency_s_p99"],
            decode_dispatches=rep["decode_steps"],
            host_syncs_decode=rep["host_syncs_decode"],
            host_syncs_prefill=rep["host_syncs_prefill"],
            tokens=rep["tokens_generated"],
            decode_micro_step_ms=step_ms,
            eager_decode_micro_step_ms=statistics.median(ab["eager_ms"]),
            eager_decode_dispatch_profiled=ab["eager_prof"],
            packed_mb=model.packed_bytes / 2 ** 20,
            dense_mb=model.dense_bytes / 2 ** 20, launches=counts)
        print(f"  serve {tag:8s} [{card}] tok/s={results[tag]['tok_per_s']:.1f} "
              f"p50={rep['latency_s_p50']:.3f}s p99={rep['latency_s_p99']:.3f}s "
              f"packed={results[tag]['packed_mb']:.0f} MB "
              f"decode micro-step={step_ms:.2f} ms "
              f"dispatches={rep['decode_steps']:.0f} "
              f"host_syncs_decode={rep['host_syncs_decode']:.0f} "
              f"launches={counts}", flush=True)
        for what, prof in (("decode dispatch", decode_prof),
                           ("512-token prefill", prefill_prof)):
            for c in prof:
                by = {n: round(v, 3) for n, v in
                      c["device_ms_by_kernel"].items()}
                print(f"    traced {what}: host {c['traced_host_ms']:.3f} "
                      f"ms, device window {c['window_ms']:.3f} ms, busy "
                      f"{c['busy_ms']:.3f} ms, idle share "
                      f"{c['idle_share']:.4f}, device-to-host copies "
                      f"{c['dtoh_copies']}, device ms by kernel {by}",
                      flush=True)
        print(f"    untraced 512-token prefill {prefill_ms:.2f} ms, GEMM "
              f"device ms {[round(v, 3) for v in prefill_gemm]}; decode "
              f"GEMM device ms / micro-step {[round(v, 3) for v in gemm]}, "
              f"non-GEMM {[round(v, 3) for v in other]}, device ops / "
              f"micro-step {n_ops}", flush=True)
        results[tag]["graph_vs_eager"] = print_ab(card, ab, k)
        if tag in SHARDED_SPECS:
            sharded_counts, results[tag]["sharded"] = sharded_cell(
                torch, card, tag, model, ecfg, eng, specs[tag][1],
                prompts[:SHARDED_REQUESTS],
                [list(r.generated) for r in reqs[:SHARDED_REQUESTS]])
            for name, c in sharded_counts.items():
                totals[name] += c
            if tag == "dense":
                results["sharded_extras"] = sharded_extras(torch, card,
                                                           params)
        if tag == "dense":
            results[tag]["eager_tokens_identical"] = eager_identity(
                torch, model, ecfg, prompts, gen_len,
                [list(r.generated) for r in reqs])
            del eng
            gc.collect()
            # phase 5's first 8 requests (one wave), cut for the time limit
            host_counts, results["host_loop"] = host_loop_cell(
                torch, card, model, prompts[:N_SLOTS],
                [list(r.generated) for r in reqs[:N_SLOTS]], step_ms)
            for name, c in host_counts.items():
                totals[name] += c
            eng = None
        del eng, model
        gc.collect()
    return totals, results


SHARDED_SPECS = ("dense", "s0.5-w8")
SHARDED_REQUESTS = 4


def join_one_rank_group(torch):
    """Phase 24's process group: one NCCL rank, joined through the port's
    `ensure_distributed` (a TCP rendezvous on a free local port); one
    world all-reduce on the card shows NCCL runs."""
    import torch.distributed as dist
    from repro_torch.serve import ensure_distributed
    if not dist.is_initialized():
        ensure_distributed(f"127.0.0.1:{mesh.free_port()}", 1, 0)
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    assert dist.get_backend() == "nccl" and torch.equal(
        x.cpu(), torch.ones(4)), (dist.get_backend(), x)


def sharded_cell(torch, card, tag, model, ecfg, local_eng, gemm, prompts,
                 want):
    """Phase 24 on phase 5's `tag` artifact: phase 5's first requests
    through ShardedBackend (slab, pages) and DistributedBackend at one
    rank; the tokens must be phase 5's (`want`). Then the sharded and the
    local (phase 5's engine) graph wall ms a micro-step in turns."""
    from repro_torch.kernels import ops
    from repro_torch.serve import (DistributedBackend, InferenceEngine,
                                   ShardedBackend)
    t_cell = time.perf_counter()
    join_one_rank_group(torch)
    runs = {"slab": (lambda: ShardedBackend(mesh_shape=(1, 1)), None),
            "paged": (lambda: ShardedBackend(mesh_shape=(1, 1)), 16),
            "distributed": (lambda: DistributedBackend(mesh_shape=(1, 1)),
                            None)}
    totals = {name: 0 for name in ops.KERNELS}
    out, engines = {}, {}
    for name, (backend, page) in runs.items():
        cfg = dataclasses.replace(ecfg, page_size=page)
        eng = InferenceEngine(model, cfg, backend=backend())
        assert eng.backend._graphs, "the sharded dispatch was not captured"
        eng, reqs, wall, counts, _ = serve_traffic(torch, model, prompts,
                                                   cfg, eng=eng)
        add_counts(totals, counts)
        toks = [list(r.generated) for r in reqs]
        assert toks == want, (tag, name, toks, want)
        assert counts[gemm] > 0 and counts["flash_attention"] > 0, counts
        if page:
            assert counts["paged_flash_attention"] > 0, counts
        desc = eng.backend.describe()
        assert desc["mesh_shape"] == [1, 1], desc
        out[name] = dict(wall_s=wall, launches=counts, describe=desc)
        if name == "slab":
            engines["sharded"] = eng
        else:
            del eng
    engines["local"] = local_eng
    ms = timed_dispatches(torch, engines, CHUNK)
    med = {k: statistics.median(v) for k, v in ms.items()}
    out["micro_step_ms"] = ms
    out["seconds"] = time.perf_counter() - t_cell
    print(f"  [24] {tag}: ShardedBackend(1, 1) slab and pages, "
          f"DistributedBackend, {len(prompts)} requests: tokens equal "
          f"phase 5's LocalBackend tokens; dispatches captured as CUDA graphs "
          f"(no collective at one rank); graph wall ms / micro-step sharded "
          f"{med['sharded']:.3f} local {med['local']:.3f} "
          f"(turns {[round(v, 3) for v in ms['sharded']]} / "
          f"{[round(v, 3) for v in ms['local']]}) [{card}]; launches slab "
          f"{ {k: v for k, v in out['slab']['launches'].items() if v} }; "
          f"{out['seconds']:.1f} s", flush=True)
    del engines
    gc.collect()
    return totals, out


def sharded_extras(torch, card, params):
    """Phase 24's other checks at one rank on the card: the pipeline, the
    int8 psum and a re-mesh restore."""
    import shutil

    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.compression import (_quant_int8,
                                                     cross_pod_psum_int8)
    from repro_torch.distributed.pipeline import (pipeline_apply,
                                                  pipeline_reference)
    from repro_torch.launch import mesh as M
    t0 = time.perf_counter()
    pod = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("pod",),
                     _init_backend=False)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    d = 2560
    ws = torch.randn((1, d, d), generator=gen, device="cuda") * d ** -0.5
    x = torch.randn((4, 8, d), generator=gen, device="cuda")

    def stage(w, h):
        return torch.tanh(h @ w)
    got = pipeline_apply(ws, x, stage, pod)
    want = pipeline_reference(ws, x, stage)
    pipe_err = float((got - want).abs().max())
    assert pipe_err <= 1e-5, pipe_err
    v = torch.randn((2560, 2560), generator=gen, device="cuda")
    q, scale = _quant_int8(v)
    psum = cross_pod_psum_int8(v, pod)
    assert torch.equal(psum, q.float() * scale)
    psum_err = float((psum - v).abs().max() / v.abs().max())
    assert psum_err < 0.05, psum_err
    mesh11 = M.make_local_mesh(1, 1)
    attn = {k: params["layers"][0]["mixer"][k]["w"]
            for k in ("wq", "wk", "wv", "wo")}
    ck = ROOT / "build" / "remesh_ck"
    shutil.rmtree(ck, ignore_errors=True)
    try:
        mgr = CheckpointManager(str(ck))
        t1 = time.perf_counter()
        mgr.save(1, attn)
        save_s = time.perf_counter() - t1
        shardings = {k: SH.NamedSharding(mesh11, v) for k, v in
                     SH.param_pspecs(
                         {"mixer": {k: {"w": t} for k, t in attn.items()}},
                         mesh11).items()}
        shardings = {k.split("/")[1]: v for k, v in shardings.items()}
        # the first restore also pays DTensor's one-time set-up; the
        # second is the restore itself
        restore_s = []
        for _ in range(2):
            t1 = time.perf_counter()
            restored, step = mgr.restore(attn, shardings=shardings)
            torch.cuda.synchronize()
            restore_s.append(time.perf_counter() - t1)
        assert step == 1
        for k, t in attn.items():
            r = restored[k]
            assert r.to_local().device.type == "cuda"
            assert torch.equal(r.to_local(), t), k
            assert torch.equal(r.full_tensor(), t), k
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    out = dict(pipeline_max_abs_err=pipe_err, psum_rel_err=psum_err,
               remesh_bytes=sum(t.numel() * 4 for t in attn.values()),
               remesh_save_s=save_s, remesh_restore_s=restore_s,
               seconds=time.perf_counter() - t0)
    print(f"  [24] pipeline_apply against pipeline_reference (1 stage, "
          f"d {d}, 4 x 8 rows) max |err| {pipe_err:.2e}; cross_pod_psum_int8 "
          f"rel err {psum_err:.4f} and equal to its quantization; re-mesh "
          f"restore of layer 0's attention ({out['remesh_bytes'] / 1e6:.1f} "
          f"MB) onto the card bitwise, save {save_s:.2f} s, restore "
          f"{restore_s[0]:.2f} s (the first, with DTensor's set-up) then "
          f"{restore_s[1]:.2f} s [{card}]; {out['seconds']:.1f} s",
          flush=True)
    return out


def host_loop_cell(torch, card, model, prompts, device_tokens, step_ms):
    """Phase 5's host-loop cell: the dense artifact served by the host
    decode loop (`device_loop=False`: one graphed (B, 1) forward a step,
    the logits pulled, argmax on the host, token and index uploaded) and by
    the device loop (K = CHUNK), whole runs in alternating turns; then one
    host step on parked slots, graph and eager, against the device loop's
    micro-step (`step_ms`, phase 5). Greedy tokens must equal the device
    loop's (`device_tokens`, near-tie rule); the host loop counts 3 host
    syncs a decode step, the device loop 1 a dispatch."""
    from repro_torch.kernels import ops
    from repro_torch.serve import EngineConfig, InferenceEngine
    base = dict(n_slots=N_SLOTS, max_len=512 + GEN_LEN, seed=SEED)
    cfgs = {"host": EngineConfig(device_loop=False, **base),
            "device": EngineConfig(decode_chunk=CHUNK, **base)}
    warm = InferenceEngine(model, cfgs["host"])     # allocator warm-up
    warm.submit(prompts[0][:32], 4)
    warm.run()
    del warm
    gc.collect()
    walls = {mode: [] for mode in cfgs}
    admit = {mode: [] for mode in cfgs}
    reps, tokens, counts = {}, {}, {}
    for _ in range(2):
        for mode, ecfg in cfgs.items():
            eng = InferenceEngine(model, ecfg)
            reqs = [eng.submit(p, GEN_LEN) for p in prompts]
            # admissions' wall (each ends on its first token's host sync)
            spent, start = [0.0], eng._start

            def timed_start(r, start=start, spent=spent):
                t = time.perf_counter()
                start(r)
                spent[0] += time.perf_counter() - t
            eng._start = timed_start
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            eng.run()
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
            admit[mode].append(spent[0])
            counts[mode] = ops.launch_counts()
            reps[mode] = eng.metrics.report()
            tokens[mode] = [list(r.generated) for r in reqs]
            if mode == "host":
                host_eng = eng
    assert counts["host"]["dense_matmul"] > 0, counts
    h, d = reps["host"], reps["device"]
    assert h["host_syncs_decode"] == 3 * h["decode_steps"] > 0, h
    assert d["host_syncs_decode"] == d["decode_steps"], d
    assert d["host_syncs_per_token"] <= 1.0 / CHUNK \
        < h["host_syncs_per_token"], (d, h)
    print(f"  [5h] host loop against device loop (K {CHUNK}) [{card}]: "
          "greedy host-loop tokens against the device loop's:", flush=True)
    div = first_divergence(torch, model, prompts, tokens["host"],
                           device_tokens)
    assert tokens["device"] == device_tokens
    bk = host_eng.backend
    tok = np.zeros((N_SLOTS, 1), np.int32)
    idx = np.full((N_SLOTS,), 100, np.int32)

    def step(eager):
        ms = []
        for _ in range(10 if not eager else 3):
            t = time.perf_counter()
            rows = bk.decode_host(tok, idx, eager=eager)
            np.argmax(rows, axis=-1)
            ms.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ms)
    step(False)
    host_step = {"graph": [], "eager": []}
    for _ in range(2):
        for mode in host_step:
            host_step[mode].append(step(mode == "eager"))
    decoded = {m: reps[m]["tokens_generated"] - len(prompts) for m in reps}
    per_tok = {m: [w * 1e3 / decoded[m] for w in walls[m]] for m in walls}
    # the decode loop alone: the run's wall less its admissions'
    loop_tok = {m: [(w - a) * 1e3 / decoded[m]
                    for w, a in zip(walls[m], admit[m])] for m in walls}
    res = dict(wall_s=walls, admission_wall_s=admit,
               wall_ms_per_decoded_token=per_tok,
               decode_loop_wall_ms_per_decoded_token=loop_tok,
               host_syncs_per_token={m: reps[m]["host_syncs_per_token"]
                                     for m in reps},
               host_syncs_per_decode_step=h["host_syncs_decode"]
               / h["decode_steps"],
               decode_steps={m: reps[m]["decode_steps"] for m in reps},
               host_step_ms=host_step, device_micro_step_ms=step_ms,
               divergences=div, launches=counts["host"])
    r = lambda xs, dd=3: [round(x, dd) for x in xs]
    print(f"    wall ms / decoded token (whole runs, admissions included, "
          f"turns): host {r(per_tok['host'])}, device {r(per_tok['device'])}"
          f" (admissions' wall s host {r(admit['host'])}, device "
          f"{r(admit['device'])}; the rest a decoded token: host "
          f"{r(loop_tok['host'])}, device {r(loop_tok['device'])});"
          f" host syncs / decode step {res['host_syncs_per_decode_step']:.0f}"
          f" (host) against 1 a {CHUNK}-step dispatch; host syncs / token "
          f"{h['host_syncs_per_token']:.4f} against "
          f"{d['host_syncs_per_token']:.4f}; one host step on parked slots "
          f"(forward, logits pull, argmax) ms graph {r(host_step['graph'])} "
          f"eager {r(host_step['eager'])} against the device loop's "
          f"micro-step {step_ms:.3f}; host-loop launches {counts['host']}",
          flush=True)
    return counts["host"], res


def first_divergence(torch, model, prompts, got, want, extras=None):
    """Hold greedy tokens `got` to `want` request by request. Where they
    first differ, recompute the logits of the common prefix (after the
    request's image rows, or over its encoded frames, with `extras`) on
    the card and require a top-2 gap below TOP2_GAP (a near-tie that two
    summation orders may break either way). Returns the divergences
    found."""
    from repro_torch.models import transformer as T
    out = []
    extras = extras or [{}] * len(prompts)
    for i, (p, a, b) in enumerate(zip(prompts, got, want)):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        seq = np.concatenate([p, np.asarray(a[:j], np.int32)])
        caches = T.make_caches(model.cfg, 1,
                               model.cfg.n_img_tokens + len(seq),
                               torch.float32, "cuda")
        frames = extras[i].get("frames")
        logits, _ = T.forward(model.params,
                              torch.from_numpy(seq[None]).cuda(), model.cfg,
                              caches=caches, last_only=True,
                              img_embeds=extras[i].get("img_embeds"),
                              enc_out=None if frames is None else T.encode(
                                  model.params, frames, model.cfg))
        top = torch.topk(logits[0, -1].float(), 2).values
        gap = float(top[0] - top[1])
        out.append(dict(request=i, step=j, top2_gap=gap))
        print(f"    request {i}: first divergent token at step {j}, top-2 "
              f"logit gap {gap:.3g} (limit {TOP2_GAP:g})", flush=True)
        if gap >= TOP2_GAP:
            raise AssertionError(f"request {i} diverges at step {j} with a "
                                 f"top-2 gap of {gap}")
    if not out:
        print("    tokens identical, no divergent step", flush=True)
    return out


def phase_paged_serving(torch, card, params):
    """h2o-danube-1.8b at full width and depth through the page pool: its
    window (4096) exceeds max_len (544), so every k/v leaf is paged and
    decode attention runs through the page-table kernel."""
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import ops
    from repro_torch.serve import EngineConfig, InferenceEngine, ModelRegistry

    arch, n_slots, gen_len, k = DANUBE, N_SLOTS, GEN_LEN, CHUNK
    prompts = serving_traffic()
    runs = {"dense-slab": (kr.DENSE, None, "dense_matmul"),
            "dense-paged": (kr.DENSE, 16, "dense_matmul"),
            "w4-paged": (kr.KratosSpec(bits=4), 16, "quant_matmul"),
            "w8a8-paged": (kr.KratosSpec(bits=8, act_bits=8), 16,
                           "quant_matmul_w8a8")}
    totals = {name: 0 for name in ops.KERNELS}
    results, tokens = {}, {}
    for tag, (spec, page_size, gemm) in runs.items():
        model = ModelRegistry().load(arch, spec, smoke=False, params=params,
                                     seed=SEED)
        ecfg = EngineConfig(n_slots=n_slots, max_len=512 + gen_len,
                            decode_chunk=k, seed=SEED, page_size=page_size)
        warm = InferenceEngine(model, ecfg)          # allocator warm-up
        warm.submit(prompts[0][:32], 4)
        warm.run()
        del warm
        eng = InferenceEngine(model, ecfg)
        reqs = [eng.submit(p, gen_len) for p in prompts]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        for name, c in counts.items():
            totals[name] += c
        rep = eng.metrics.report()
        tokens[tag] = [list(r.generated) for r in reqs]
        for r in reqs:
            assert r.done and len(r.generated) == gen_len
        for name in GEMM_KERNELS:
            assert (counts[name] > 0) == (name == gemm), (tag, counts)
        assert counts["flash_attention"] > 0, counts
        layers = model.cfg.n_layers
        if page_size:
            assert eng.pool.index is None       # windowed arch: no reuse
            assert counts["paged_flash_attention"] \
                == layers * rep["micro_steps"], (counts, rep["micro_steps"])
        else:
            assert counts["paged_flash_attention"] == 0, counts
        ab = graph_vs_eager(torch, eng, k)
        step_ms = statistics.median(ab["graph_ms"])
        prof, retaken = ab["graph_prof"], ab["retaken_graph_traces"]
        other = [non_gemm_ms(c) / k for c in prof]
        gemm = [gemm_ms(c) / k for c in prof]
        n_ops = [c["device_ops"] / k for c in prof]
        attn = [c["device_ms_by_kernel"].get("paged_kernel", 0.0) / k
                for c in prof]
        # a paged run that launched the kernel must show its device time
        # (a renamed device kernel would read 0 here)
        if counts["paged_flash_attention"]:
            assert all(a > 0 for a in attn), (tag, attn)
        results[tag] = dict(
            spec=kr.spec_tag(spec), page_size=page_size, wall_s=wall,
            tok_per_s=rep["tokens_generated"] / wall,
            latency_s_p50=rep["latency_s_p50"],
            latency_s_p99=rep["latency_s_p99"],
            decode_dispatches=rep["decode_steps"],
            micro_steps=rep["micro_steps"], decode_micro_step_ms=step_ms,
            non_gemm_device_ms_per_micro_step=other,
            gemm_device_ms_per_micro_step=gemm,
            device_ops_per_micro_step=n_ops,
            idle_share=[c["idle_share"] for c in prof],
            paged_attention_device_ms_per_micro_step=attn,
            decode_dispatch_profiled=prof, retaken_decode_traces=retaken,
            packed_mb=model.packed_bytes / 2 ** 20, launches=counts,
            pages_in_use=rep["pages_in_use"],
            page_occupancy=rep["page_occupancy"])
        print(f"  {tag:11s} [{card}] tok/s={results[tag]['tok_per_s']:.1f} "
              f"p50={rep['latency_s_p50']:.3f}s p99={rep['latency_s_p99']:.3f}s "
              f"micro-step={step_ms:.2f} ms packed="
              f"{results[tag]['packed_mb']:.0f} MB GEMM device ms / "
              f"micro-step {[round(v, 3) for v in gemm]} non-GEMM "
              f"{[round(v, 3) for v in other]} (of it paged "
              f"attention {[round(v, 3) for v in attn]}) device ops / "
              f"micro-step {n_ops} idle share "
              f"{[round(c['idle_share'], 4) for c in prof]} "
              f"dispatches={rep['decode_steps']:.0f} "
              f"micro_steps={rep['micro_steps']:.0f} launches={counts}",
              flush=True)
        results[tag]["graph_vs_eager"] = print_ab(card, ab, k)
        if tag == "dense-paged":
            print("  dense paged against dense slab tokens:", flush=True)
            results[tag]["divergences"] = first_divergence(
                torch, model, prompts, tokens[tag], tokens["dense-slab"])
            results[tag]["eager_tokens_identical"] = eager_identity(
                torch, model, ecfg, prompts, gen_len, tokens[tag])
        del eng, model
        gc.collect()
    return totals, results


def phase_prefix_reuse(torch, card, arch="nemotron-4-340b", n_layers=1):
    """`arch` at full width, depth cut to `n_layers` (nemotron-4-340b: one
    layer plus the untied embedding and head is ~52 GB in f32), dense: a
    shared 512-token system prompt, then two follow-up turns of finished
    conversations; paged engine with the prefix index against a slab
    engine over the same model. An MoE arch is not held to the slab: a
    matched admission routes only its suffix (its capacity groups differ
    from a full prefill's, as in the JAX package), so its tokens may
    differ from the slab's; graph against eager still holds."""
    from repro_torch import configs as C
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import EngineConfig, InferenceEngine
    from repro_torch.serve.registry import PackedModel, pack_model_params

    page, n_slots, max_len, k, gen = 16, 8, 768, 4, 16
    cfg = C.get_config(arch, n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init(cfg, seed=SEED, device="cuda")
    packed, n_packed = pack_model_params(params, kr.DENSE)
    del params
    n_bytes = sum(t.numel() * t.element_size()
                  for layer in packed["layers"] for group in layer.values()
                  for leaf in group.values()
                  for t in getattr(leaf, "buffers", {}).values())
    model = PackedModel(name=f"{arch}-{n_layers}layer", cfg=cfg, params=packed,
                        spec=kr.DENSE, n_packed=n_packed,
                        packed_bytes=n_bytes, dense_bytes=n_bytes,
                        device=torch.device("cuda"))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"  init {arch} full width, {n_layers} layers (f32): "
          f"{time.perf_counter() - t0:.1f} s, max_memory_allocated "
          f"{peak / 2 ** 30:.2f} GiB", flush=True)
    rng = np.random.default_rng(SEED + 1)
    system = rng.integers(0, cfg.vocab, 512).astype(np.int32)
    wave = [np.concatenate([system, rng.integers(0, cfg.vocab, int(n))])
            .astype(np.int32) for n in rng.integers(32, 97, 8)]
    # a follow-up turn is a conversation hit only if its prior turn
    # published a page of generated tokens: prompt length not a multiple
    # of the page
    sources = [i for i, p in enumerate(wave) if len(p) % page][:2]
    assert len(sources) == 2, [len(p) for p in wave]
    follow_new = [rng.integers(0, cfg.vocab, 32).astype(np.int32)
                  for _ in sources]

    def serve(page_size, eager=False):
        eng = InferenceEngine(model, EngineConfig(
            n_slots=n_slots, max_len=max_len, decode_chunk=k, seed=SEED,
            page_size=page_size))
        if eager:
            run_eager(eng)
        admit_ms = []
        start = eng._start

        def timed_start(r):
            torch.cuda.synchronize()
            t = time.perf_counter()
            start(r)
            torch.cuda.synchronize()
            admit_ms.append((r.prefix_matched, len(r.prompt),
                             (time.perf_counter() - t) * 1e3))
        eng._start = timed_start
        reqs = [eng.submit(p, gen) for p in wave]
        eng.run()
        follow = [np.concatenate([wave[i], np.asarray(reqs[i].generated,
                                                      np.int32), f])
                  for i, f in zip(sources, follow_new)]
        reqs += [eng.submit(p, gen, arrival_step=eng.step_count)
                 for p in follow]
        eng.run()
        return eng, reqs, follow, admit_ms

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng, reqs, follow, admit_ms = serve(page)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    rep = eng.metrics.report()
    matched = [r.prefix_matched for r in reqs]
    assert matched[:8] == [0] + [512] * 7, matched
    assert rep["prefill_tokens_skipped"] >= 7 * 512, rep
    assert rep["conversation_prefix_hits"] == 2, rep
    for r, p in zip(reqs[8:], follow):
        conv_len = len(p) - 32
        assert r.prefix_matched == (conv_len - 1) // page * page, \
            (r.prefix_matched, conv_len)
    assert eng.pool.pages_in_use == eng.pool.index.n_nodes, \
        (eng.pool.pages_in_use, eng.pool.index.n_nodes)
    assert counts["dense_matmul"] > 0, counts
    # MLA attends on the table view of its latent pages, as in the JAX
    # package: no attention kernel
    assert (counts["paged_flash_attention"] > 0) != cfg.mla, counts
    assert (counts["flash_attention"] > 0) != cfg.mla, counts
    hit = [ms for m_, _, ms in admit_ms if m_]
    miss = [ms for m_, _, ms in admit_ms if not m_]
    print(f"  paged [{card}] {len(reqs)} requests in {wall:.2f} s, prefix_"
          f"matched {matched}, prefill_tokens_skipped "
          f"{rep['prefill_tokens_skipped']:.0f}, skip fraction "
          f"{rep['prefill_skip_fraction']:.3f}, conversation hits "
          f"{rep['conversation_prefix_hits']:.0f} "
          f"({rep['conversation_tokens_reused']:.0f} tokens), pages in use "
          f"after drain {eng.pool.pages_in_use} = index nodes "
          f"{eng.pool.index.n_nodes}, launches {counts}", flush=True)
    print(f"  admission wall ms: unmatched {[round(v, 1) for v in miss]}, "
          f"matched {[round(v, 1) for v in hit]}", flush=True)
    paged_tokens = [list(r.generated) for r in reqs]
    ab = print_ab(card, graph_vs_eager(torch, eng, k), k)
    del eng
    _, eager_reqs, _, _ = serve(page, eager=True)
    eager_same = [list(r.generated) for r in eager_reqs] == paged_tokens
    print(f"    graph against eager tokens over {len(reqs)} requests: "
          f"{'identical' if eager_same else 'different'}", flush=True)
    assert eager_same, "graphed and eager tokens differ"
    del eager_reqs
    gc.collect()
    slab, div, slab_admit = None, None, None
    if cfg.n_experts:
        print("  paged against slab tokens: not compared (an MoE suffix "
              "prefill routes only the suffix)", flush=True)
    else:
        slab, slab_reqs, _, slab_admit = serve(None)
        print("  paged against slab tokens:", flush=True)
        div = first_divergence(torch, model, wave + follow, paged_tokens,
                               [list(r.generated) for r in slab_reqs])
    result = dict(wall_s=wall, prefix_matched=matched, launches=counts,
                  max_memory_allocated=peak, admission_ms=admit_ms,
                  slab_admission_ms=slab_admit, divergences=div,
                  graph_vs_eager=ab, eager_tokens_identical=eager_same,
                  report={key: rep[key] for key in (
                      "prefix_hit_rate", "prefill_skip_fraction",
                      "prefill_tokens_skipped", "conversation_prefix_hits",
                      "conversation_tokens_reused", "pages_in_use",
                      "page_occupancy", "tok_per_s")})
    del slab, model, packed
    gc.collect()
    torch.cuda.empty_cache()
    return counts, result


FALCON = "falcon-mamba-7b"
FALCON_LAYERS = 32                     # of 64 (phase 8's depth cut)
SPEC_FALCON_LAYERS = 16                # of 64 (phase 9's depth cut)


def phase_mamba_serving(torch, card):
    """falcon-mamba-7b at full width, depth cut to FALCON_LAYERS (for the
    time limit), random f32 weights from the seed, packed dense and sparsity 0.5 x int8 (x_proj's 288 outputs do
    not divide the 128-wide block grid, so it packs weight-only w8), over
    phase 5's traffic in this vocab. The prompts prefill at exact length."""
    from repro_torch import configs as C
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import EngineConfig, InferenceEngine

    cfg = C.get_config(FALCON, n_layers=FALCON_LAYERS)
    n_slots, gen_len, k = N_SLOTS, GEN_LEN, CHUNK
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"  init full-width {FALCON} ({cfg.n_layers} layers, f32): "
          f"{time.perf_counter() - t0:.1f} s, memory_allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    prompts = serving_traffic(cfg.vocab)
    specs = {"dense": (kr.DENSE, {"dense_matmul"}),
             "s0.5-w8": (kr.KratosSpec(sparsity=0.5, bits=8),
                         {"bsr_quant_matmul", "quant_matmul"})}
    totals = {name: 0 for name in ops.KERNELS}
    results = {}
    for tag, (spec, gemms) in specs.items():
        t0 = time.perf_counter()
        model = load_cut(FALCON, spec, params, cfg.n_layers)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        ecfg = EngineConfig(n_slots=n_slots, max_len=512 + gen_len,
                            decode_chunk=k, seed=SEED)
        warm = InferenceEngine(model, ecfg)          # allocator warm-up
        warm.submit(prompts[0][:32], 4)
        warm.run()
        del warm
        eng = InferenceEngine(model, ecfg)
        reqs = [eng.submit(p, gen_len) for p in prompts]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        for name, c in counts.items():
            totals[name] += c
        rep = eng.metrics.report()
        for r in reqs:
            assert r.done and len(r.generated) == gen_len
            assert all(0 <= t < cfg.vocab for t in r.generated)
        assert counts["ssm_scan"] == cfg.n_layers * len(prompts), counts
        for name in GEMM_KERNELS:
            assert (counts[name] > 0) == (name in gemms), (tag, counts)
        assert counts["flash_attention"] == 0, counts
        assert counts["paged_flash_attention"] == 0, counts
        assert rep["host_syncs_decode"] == rep["decode_steps"], rep
        ab = graph_vs_eager(torch, eng, k, traces=2)
        step_ms = statistics.median(ab["graph_ms"])
        decode_prof, retaken = ab["graph_prof"], ab["retaken_graph_traces"]
        batch = {"tokens": torch.from_numpy(
            np.resize(prompts[0], (1, 512)).astype(np.int32)).cuda()}
        eng.backend.prefill(batch, exact=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng.backend.prefill(batch, exact=True)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t1) * 1e3
        prefill_prof, _ = profile_calls(
            torch, lambda: eng.backend.prefill(batch, exact=True), 2)
        gemm = [gemm_ms(c) / k for c in decode_prof]
        other = [non_gemm_ms(c) / k for c in decode_prof]
        idle = [c["idle_share"] for c in decode_prof]
        scan = [c["device_ms_by_kernel"].get("ssm_scan_kernel", 0.0)
                for c in prefill_prof]
        assert counts["ssm_scan"] and all(v > 0 for v in scan), (tag, scan)
        prefill_gemm = [gemm_ms(c) for c in prefill_prof]
        results[tag] = dict(
            spec=kr.spec_tag(spec), pack_s=pack_s, wall_s=wall,
            tok_per_s=rep["tokens_generated"] / wall,
            latency_s_p50=rep["latency_s_p50"],
            latency_s_p99=rep["latency_s_p99"],
            decode_dispatches=rep["decode_steps"],
            micro_steps=rep["micro_steps"], decode_micro_step_ms=step_ms,
            gemm_device_ms_per_micro_step=gemm,
            non_gemm_device_ms_per_micro_step=other,
            decode_idle_share=idle, prefill_512_ms=prefill_ms,
            prefill_512_ssm_scan_device_ms=scan,
            prefill_512_gemm_device_ms=prefill_gemm,
            decode_dispatch_profiled=decode_prof,
            retaken_decode_traces=retaken,
            eager_decode_micro_step_ms=statistics.median(ab["eager_ms"]),
            eager_decode_dispatch_profiled=ab["eager_prof"],
            prefill_512_profiled=prefill_prof,
            packed_mb=model.packed_bytes / 2 ** 20,
            dense_mb=model.dense_bytes / 2 ** 20, launches=counts)
        print(f"  mamba {tag:8s} [{card}] tok/s="
              f"{results[tag]['tok_per_s']:.1f} p50="
              f"{rep['latency_s_p50']:.3f}s p99={rep['latency_s_p99']:.3f}s "
              f"packed={results[tag]['packed_mb']:.0f} MB pack={pack_s:.1f} s "
              f"wall ms / micro-step={step_ms:.2f} GEMM device ms / "
              f"micro-step {[round(v, 3) for v in gemm]} non-GEMM "
              f"{[round(v, 3) for v in other]} idle share "
              f"{[round(v, 4) for v in idle]} (decode traces retaken: "
              f"{retaken}) "
              f"dispatches="
              f"{rep['decode_steps']:.0f} micro_steps="
              f"{rep['micro_steps']:.0f} launches={counts}", flush=True)
        results[tag]["graph_vs_eager"] = print_ab(card, ab, k)
        if tag == "dense":
            results[tag]["eager_tokens_identical"] = eager_identity(
                torch, model, ecfg, prompts, gen_len,
                [list(r.generated) for r in reqs])
        print(f"    512-token prefill: untraced wall {prefill_ms:.2f} ms, "
              f"ssm_scan device ms {[round(v, 3) for v in scan]} against "
              f"GEMM device ms {[round(v, 3) for v in prefill_gemm]}, idle "
              f"share {[round(c['idle_share'], 4) for c in prefill_prof]}",
              flush=True)
        for what, prof in (("decode dispatch", decode_prof),
                           ("512-token prefill", prefill_prof)):
            for c in prof:
                by = {n: round(v, 3) for n, v in
                      c["device_ms_by_kernel"].items()}
                print(f"    traced {what}: host {c['traced_host_ms']:.3f} "
                      f"ms, device window {c['window_ms']:.3f} ms, busy "
                      f"{c['busy_ms']:.3f} ms, {c['device_ops']} device "
                      f"ops, device-to-host copies {c['dtoh_copies']}, "
                      f"device ms by kernel {by}", flush=True)
        del eng, model
        gc.collect()
    results["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return totals, results


def spec_cell(torch, card, model, prompts, k, page_size, gemms):
    """One speculative cell: `model` (a drafted artifact) serves `prompts`
    greedy with speculate=k, after the same model's plain decode (K =
    CHUNK) on the same traffic; the launch counts of the speculative run
    are returned."""
    from repro_torch.kernels import ops
    from repro_torch.serve import EngineConfig, InferenceEngine
    from repro_torch.models import transformer as T
    cfg = model.cfg
    base = dict(n_slots=N_SLOTS, max_len=512 + GEN_LEN, seed=SEED,
                page_size=page_size)
    # how far the draft's repack moves this network's argmax: top-1
    # agreement of draft and target over the prompts' first 32 positions
    tokens = torch.from_numpy(np.stack([p[:32] for p in prompts])).cuda()
    top1 = [T.forward(params, tokens, c)[0].argmax(-1) for params, c in (
        (model.params, cfg), (model.draft_params, model.draft_cfg))]
    agreement = float((top1[0] == top1[1]).float().mean())
    del top1
    spec_cfg = EngineConfig(speculate=k, **base)

    def serve(ecfg):
        eng = InferenceEngine(model, ecfg)
        reqs = [eng.submit(p, GEN_LEN) for p in prompts]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        return eng, [list(r.generated) for r in reqs], wall, counts

    plain_eng, plain, plain_wall, _ = serve(EngineConfig(decode_chunk=CHUNK,
                                                         **base))
    plain_ms = graph_vs_eager(torch, plain_eng, CHUNK, turns=2, traces=1)
    plain_tok_s = plain_eng.metrics.report()["tokens_generated"] / plain_wall
    del plain_eng
    warm = InferenceEngine(model, spec_cfg)          # allocator warm-up
    warm.submit(prompts[0][:32], 4)
    warm.run()
    del warm
    gc.collect()
    eng, got, wall, counts = serve(spec_cfg)       # the main path
    rep = eng.metrics.report()
    layers = cfg.n_layers
    assert all(len(t) == GEN_LEN for t in got)
    for name in GEMM_KERNELS:
        assert (counts[name] > 0) == (name in gemms), counts
    if cfg.is_ssm:
        # one scan a layer in the target's and in the draft's prefill
        assert counts["ssm_scan"] == (layers + model.draft_cfg.n_layers) \
            * len(prompts), counts
        assert counts["flash_attention"] == counts["paged_flash_attention"] \
            == 0, counts
    elif cfg.mla:
        # MLA reaches no attention kernel, as in the JAX package
        assert counts["flash_attention"] == counts["paged_flash_attention"] \
            == 0, counts
    else:
        assert counts["flash_attention"] > 0, counts
        # one verify block a layer a cycle through the page table
        assert counts["paged_flash_attention"] == (
            layers * rep["spec_dispatches"] if page_size else 0), \
            (counts, rep["spec_dispatches"])
    assert rep["host_syncs_decode"] == rep["spec_dispatches"], rep
    print("    speculative against plain tokens:", flush=True)
    div = first_divergence(torch, model, prompts, got, plain)
    decoded = rep["tokens_generated"] - len(prompts)   # first tokens aside
    slot_cycles = sum(eng.metrics.occupancy) * N_SLOTS
    commits = decoded / slot_cycles             # per live slot and cycle
    ab = graph_vs_eager(torch, eng, 1)
    s = ab_summary(ab, 1)
    cycle_ms = statistics.median(s["graph_ms"])
    plain_step = statistics.median(plain_ms["graph_ms"])
    res = dict(
        k=k, page_size=page_size, draft=model.draft_spec.tag,
        wall_s=wall, tok_per_s=rep["tokens_generated"] / wall,
        plain_wall_s=plain_wall, plain_tok_per_s=plain_tok_s,
        spec_dispatches=rep["spec_dispatches"],
        acceptance_rate=rep["acceptance_rate"],
        draft_proposed=rep["draft_proposed"],
        draft_accepted=rep["draft_accepted"],
        draft_verify_flop_ratio=rep["draft_verify_flop_ratio"],
        commits_per_slot_cycle=commits, draft_top1_agreement=agreement,
        committed_per_cycle=decoded / rep["spec_dispatches"],
        cycle_ms=cycle_ms, eager_cycle_ms=statistics.median(s["eager_ms"]),
        # at full occupancy: every slot live, `commits` tokens each
        ms_per_committed_token=cycle_ms / (N_SLOTS * commits),
        plain_micro_step_ms=plain_step,
        plain_ms_per_token=plain_step / N_SLOTS,
        cycle_device_ms=s["graph_device_ms"],
        cycle_idle_share=s["graph_idle_share"],
        cycle_device_ops=s["graph_device_ops"],
        cycle_device_ms_by_kernel=[c["device_ms_by_kernel"]
                                   for c in ab["graph_prof"]],
        graph_vs_eager=s, plain_graph_vs_eager=ab_summary(plain_ms, CHUNK),
        latency_s_p50=rep["latency_s_p50"],
        latency_s_p99=rep["latency_s_p99"], divergences=div,
        launches=counts)
    print(f"  spec {cfg.name} {'paged' if page_size else 'slab'} K={k} draft "
          f"{res['draft']} [{card}] acceptance {res['acceptance_rate']:.4f} "
          f"({rep['draft_accepted']:.0f} of {rep['draft_proposed']:.0f}; "
          f"draft top-1 agreement over {tokens.numel()} prompt positions "
          f"{agreement:.4f}), "
          f"commits / slot-cycle {commits:.3f}, cycles "
          f"{rep['spec_dispatches']:.0f}, wall ms / cycle {cycle_ms:.3f} "
          f"(eager {res['eager_cycle_ms']:.3f}), ms / committed token at "
          f"{N_SLOTS} slots {res['ms_per_committed_token']:.3f} against "
          f"plain {res['plain_ms_per_token']:.3f} (micro-step "
          f"{plain_step:.3f}), device ms / cycle "
          f"{[round(v, 3) for v in s['graph_device_ms']]}, idle share "
          f"{[round(v, 4) for v in s['graph_idle_share']]}, tok/s "
          f"{res['tok_per_s']:.1f} (plain {plain_tok_s:.1f}), launches "
          f"{counts}", flush=True)
    print_ab(card, ab, 1, unit="cycle")
    for c in ab["graph_prof"]:
        by = {n: round(v, 3) for n, v in c["device_ms_by_kernel"].items()}
        print(f"    traced cycle: device ms by kernel {by}", flush=True)
    del eng
    gc.collect()
    res["eager_tokens_identical"] = eager_identity(torch, model, spec_cfg,
                                                   prompts, GEN_LEN, got)
    return counts, res


def phase_speculative(torch, card):
    """Speculative self-draft decode at full width, random f32 weights from
    the seed, phase 5's traffic, greedy: h2o-danube-1.8b (depth cut from 24
    to 8 layers, dense target, s0.5 x int8 draft through bsr_quant_matmul,
    K 4) from the slab and the page pool; falcon-mamba-7b (depth cut from 64
    to 16 layers, dense target, w8 draft through quant_matmul, K 2: the
    recurrent rollback). The cuts keep the script inside its time limit
    with phases 10-11 (their eager A/B partners are host-bound). Returns
    h2o-danube's dense tree too, for phase 17."""
    from repro_torch import configs as C
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import DraftSpec

    cells = ((DANUBE, 8, DraftSpec(bits=8, sparsity=0.5), 4, (None, 16),
              {"dense_matmul", "bsr_quant_matmul"}),
             (FALCON, SPEC_FALCON_LAYERS, DraftSpec(bits=8), 2, (None,),
              {"dense_matmul", "quant_matmul"}))
    totals = {name: 0 for name in ops.KERNELS}
    results, kept = {}, None
    for arch, n_layers, dspec, k, pages, gemms in cells:
        cfg = C.get_config(arch, n_layers=n_layers)
        torch.cuda.reset_peak_memory_stats()
        params = T.init(cfg, seed=SEED, device="cuda")
        t0 = time.perf_counter()
        model = load_cut(arch, kr.DENSE, params, n_layers, draft_spec=dspec)
        torch.cuda.synchronize()
        print(f"  {model.name}: draft packed in "
              f"{time.perf_counter() - t0:.1f} s, memory_allocated "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
        prompts = serving_traffic(cfg.vocab)
        for page_size in pages:
            counts, res = spec_cell(torch, card, model, prompts, k,
                                    page_size, gemms)
            results[f"{arch} {'paged' if page_size else 'slab'}"] = res
            for name, c in counts.items():
                totals[name] += c
        results[arch + " max_memory_allocated"] = \
            torch.cuda.max_memory_allocated()
        if arch == DANUBE:
            kept = params
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    return totals, results, kept



# phase 17: the QoS ladder of the JAX package's resilience tests (two tiers
# below the dense model) over phase 9's depth cut of h2o-danube-1.8b, the
# probe's tolerance against its plain version (counts exact), and 17c's
# page pool: the fewest pages that still hold the longest request (34 of
# 16 positions) and some, a deadline on every 4th request
TIER_LADDER = "8:0.5,8:0.75"
QOS_LAYERS = 8
LEDGER_RTOL = 1e-6
POOL_PAGES, POOL_RETRIES, POOL_DEADLINE = 80, 2, 40
# phase 5's first 8 requests (one wave), cut from 16 for the time limit
QOS_REQUESTS = 8


def serve_traffic(torch, model, prompts, ecfg, tier=None, eager=False,
                  deadline=None, eng=None):
    """Serve `prompts` (GEN_LEN new tokens each, all arriving at step 0)
    through `eng` (a fresh engine when None), held on `tier` when given,
    every dispatch through the eager step with `eager`; `deadline(i)` gives
    request i's deadline_steps. Returns (engine, requests, wall s, launch
    counts, the engine's tier after each step)."""
    from repro_torch.kernels import ops
    from repro_torch.serve import InferenceEngine
    eng = eng or InferenceEngine(model, ecfg)
    if tier is not None:
        eng.set_tier(tier)
    if eager:
        run_eager(eng)
    reqs = [eng.submit(p, GEN_LEN, deadline_steps=None if deadline is None
                       else deadline(i)) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    path = []
    t0 = time.perf_counter()
    while eng.n_waiting or eng.pool.n_active:
        eng.step()
        path.append(eng.tier)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, reqs, wall, ops.launch_counts(), path


def pool_pressure_cell(torch, model, prompts, ecfg):
    """17c: a page pool short of pages, pool_wait_retries and a deadline on
    every 4th request. Each request ends done or shed; the shed split by
    reason; no completion past its deadline; the pool back to pristine."""
    eng, reqs, wall, counts, _ = serve_traffic(
        torch, model, prompts, ecfg,
        deadline=lambda i: POOL_DEADLINE if i % 4 == 0 else None)
    rep = eng.metrics.report()
    pool = eng.pool
    by = {reason: [r.id for r in reqs if r.shed_reason == reason]
          for reason in ("deadline", "pool")}
    assert all(r.finished for r in reqs), [r.state for r in reqs]
    assert rep["shed"] == len(by["deadline"]) + len(by["pool"]) \
        == rep["deadline_missed"] + rep["shed_pool_pressure"], (rep, by)
    assert rep["requests_completed"] + rep["shed"] == len(reqs), rep
    assert by["deadline"] and by["pool"], by
    assert all(r.pool_retries == POOL_RETRIES + 1 for r in reqs
               if r.shed_reason == "pool")
    for r in reqs:
        if r.done:
            assert len(r.generated) == GEN_LEN
            if r.deadline_steps is not None:
                assert eng.metrics.records[r.id].finish_step \
                    <= r.deadline_step(), r.id
    pristine = (pool.n_active == 0 and pool.n_free == ecfg.n_slots
                and int(pool.refs[1:].sum()) == 0
                and len(pool._free_pages) == pool.n_usable_pages)
    assert pristine, "page pool not pristine after 17c"
    return eng, dict(
        wall_s=wall, shed_ids=by, completed=rep["requests_completed"],
        shed=rep["shed"], deadline_missed=rep["deadline_missed"],
        shed_pool_pressure=rep["shed_pool_pressure"],
        pool_waits=rep["pool_waits"], decode_dispatches=rep["decode_steps"],
        pages=POOL_PAGES, retries=POOL_RETRIES, deadline=POOL_DEADLINE,
        pristine=pristine), counts


def probe_taps(torch, eng):
    """The (activation, fan-out) of every ledger tap of one eager dispatch
    of `eng`, recorded at the wrapper."""
    from repro_torch.kernels import ops
    taps, inner = [], ops.ledger_probe

    def record(x, n_out, out_row, **kw):
        taps.append((x.detach().clone(), n_out))
        return inner(x, n_out, out_row, **kw)
    ops.ledger_probe = record
    try:
        eng.backend.decode_block(eager=True)
    finally:
        ops.ledger_probe = inner
    torch.cuda.synchronize()
    return taps


def probe_cases(torch, timer, taps, led, tag):
    """The probe kernel against `LedgerProbe.measure` on every tap shape
    met: counts and histogram bit for bit, the float columns within
    LEDGER_RTOL; each distinct shape's kernel, plain and bound ms."""
    from repro_torch.kernels import ops
    from repro_torch.serve.ledger import C_BYTES_EFF, C_FLOPS_EFF, LedgerProbe
    dev = taps[0][0].device
    probe = LedgerProbe(led, torch.zeros(1, led.width, device=dev))
    floats = [C_FLOPS_EFF, C_BYTES_EFF]
    exact = [c for c in range(led.width) if c not in floats]
    cases, seen = [], set()
    for x, n_out in taps:
        key = (tuple(x.shape), n_out)
        row = torch.zeros(led.width, device=dev)
        ops.ledger_probe(x, n_out, row, threshold=led.threshold,
                         group=led.group, k_block=led.k_block)
        want = probe.measure(x, n_out)
        if not torch.equal(row[exact], want[exact]):
            raise AssertionError(f"ledger_probe {tag} {key}: counts differ: "
                                 f"{row.tolist()} against {want.tolist()}")
        rel = ((row[floats] - want[floats]).abs()
               / want[floats].abs().clamp(min=1e-30)).max().item()
        if rel > LEDGER_RTOL:
            raise AssertionError(f"ledger_probe {tag} {key}: float columns "
                                 f"{rel:.3g} relative off")
        if key in seen:
            continue
        seen.add(key)
        b_ms, b_by = bound_ms(nbytes(x) + 4 * led.width, 0, "float32")
        case = dict(
            kernel="ledger_probe", dtype="float32", ledger=tag,
            shape=list(key[0]), n_out=n_out,
            max_abs_err=float((row - want).abs().max()), atol=0.0,
            rtol=LEDGER_RTOL, zeros=float(want[1]), near=float(want[2]),
            dead_kblocks=float(want[5]),
            ms=timer(lambda: ops.ledger_probe(
                x, n_out, row, threshold=led.threshold, group=led.group,
                k_block=led.k_block)),
            plain_ms=timer(lambda: probe.measure(x, n_out), iters=5),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            key=("ledger_probe", "float32", key[0], n_out))
        cases.append(case)
        print(f"  ledger_probe     {tag:9s} {list(key[0])} n_out={n_out} "
              f"counts exact, floats within {rel:.2g} ms={case['ms']:.4f} "
              f"plain={case['plain_ms']:.4f} bound={b_ms:.5f} ({b_by})",
              flush=True)
    return cases


def phase_resilience(torch, card, params, timer):
    """Phase 17: the QoS tier ladder, the ineffectual-work ledger and the
    pool-wait / deadline shedding on h2o-danube-1.8b at full width, depth
    cut to 8 layers (phase 9's dense tree), phase 5's traffic."""
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import ops
    from repro_torch.serve import (DraftSpec, EngineConfig, InferenceEngine,
                                   LedgerConfig, QoSConfig, parse_tiers)

    prompts = serving_traffic()[:QOS_REQUESTS]
    base = dict(n_slots=N_SLOTS, max_len=512 + GEN_LEN, decode_chunk=CHUNK,
                seed=SEED)
    totals = {name: 0 for name in ops.KERNELS}
    res, cases = {}, []
    t_phase = time.perf_counter()

    def count(launches):
        for name, c in launches.items():
            totals[name] += c

    # the ladder packs off the dense tree before the target's pack takes it
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = load_cut(DANUBE, kr.DENSE, params, QOS_LAYERS,
                     tier_specs=parse_tiers(TIER_LADDER))
    torch.cuda.synchronize()
    res["load"] = dict(s=time.perf_counter() - t0, before_gb=before / 1e9,
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                       after_gb=torch.cuda.memory_allocated() / 1e9)
    plain = load_cut(DANUBE, kr.DENSE, params, QOS_LAYERS)
    print(f"  {model.name}: {model.n_tiers} tiers loaded in "
          f"{res['load']['s']:.2f} s, memory_allocated "
          f"{res['load']['before_gb']:.2f} -> {res['load']['after_gb']:.2f} "
          f"GB, load peak {res['load']['peak_gb']:.2f} GB", flush=True)

    # ---- 17a: the QoS ladder -------------------------------------------
    ecfg = EngineConfig(**base)
    _, reqs, _, counts, _ = serve_traffic(torch, plain, prompts, ecfg)
    count(counts)
    want = [list(r.generated) for r in reqs]
    _, reqs, _, counts, _ = serve_traffic(torch, model, prompts, ecfg)
    count(counts)
    assert [list(r.generated) for r in reqs] == want, \
        "a tiered model's tier-0 tokens differ from a tierless model's"
    print("[17a] tier-0 tokens of the tiered model against the tierless "
          "one: identical", flush=True)
    qos = QoSConfig(demote_depth=4, promote_depth=0, hysteresis=2)
    eng, reqs, wall, counts, path = serve_traffic(
        torch, model, prompts, EngineConfig(qos=qos, **base))
    count(counts)
    rep = eng.metrics.report()
    assert all(r.done and len(r.generated) == GEN_LEN for r in reqs)
    assert rep["tier_demotions"] >= 1 and rep["tier_promotions"] >= 1, rep
    assert path[-1] == 0 and eng.tier == 0, path
    res["qos"] = dict(
        path=path, demotions=rep["tier_demotions"],
        promotions=rep["tier_promotions"], wall_s=wall,
        tok_per_s=rep["tokens_generated"] / wall,
        request_tiers=[r.tier for r in reqs],
        steps_by_tier=[path.count(t) for t in range(model.n_tiers)],
        latency_s_p50=rep["latency_s_p50"], latency_s_p99=rep["latency_s_p99"],
        launches=counts)
    print(f"[17a] QoS {qos} [{card}]: tier after each step {path}; "
          f"demotions {rep['tier_demotions']:.0f}, promotions "
          f"{rep['tier_promotions']:.0f}, requests' cheapest tier "
          f"{res['qos']['request_tiers']}, tok/s "
          f"{res['qos']['tok_per_s']:.1f}, launches {counts}", flush=True)
    res["tiers"] = {}
    for tier in range(model.n_tiers):
        eng, reqs, wall, counts, _ = serve_traffic(
            torch, model, prompts, ecfg, tier=tier)
        count(counts)
        got = [list(r.generated) for r in reqs]
        ab = graph_vs_eager(torch, eng, CHUNK, turns=2, traces=1)
        res["tiers"][tier] = dict(
            spec=model.tier_specs[tier - 1].tag if tier else "dense",
            graph_vs_eager=ab_summary(ab, CHUNK), wall_s=wall,
            graph_launches=eng.backend._graphs[tier][2],
            gemm_device_ms=[gemm_ms(c) / CHUNK for c in ab["graph_prof"]])
        print_ab(card, ab, CHUNK)
        if tier == model.n_tiers - 1:
            # a swap selects a captured graph: its wall ms, and a
            # dispatch right after a swap against one without, in turns
            swap, after, steady = [], [], []
            for i in range(6):
                t = time.perf_counter()
                eng.set_tier(i % 2)
                swap.append((time.perf_counter() - t) * 1e3)
                for out in (after, steady):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    eng.backend.decode_block()
                    torch.cuda.synchronize()
                    out.append((time.perf_counter() - t) * 1e3)
            extra = [a - b for a, b in zip(after, steady)]
            res["swap"] = dict(set_tier_ms=swap, dispatch_after_swap_ms=after,
                               dispatch_ms=steady, extra_ms=extra)
            print(f"[17a] swap [{card}]: set_tier wall ms "
                  f"{[round(v, 4) for v in swap]}; a dispatch right after "
                  f"it (tiers 0 and 1 in turn) {[round(v, 3) for v in after]} "
                  f"against the next one on the same tier "
                  f"{[round(v, 3) for v in steady]}: the swap's extra ms "
                  f"{[round(v, 3) for v in extra]} (median "
                  f"{statistics.median(extra):.3f})", flush=True)
        # the same traffic again on the same engine, every dispatch eager
        _, eager_reqs, _, _, _ = serve_traffic(
            torch, model, prompts, ecfg, tier=tier, eager=True, eng=eng)
        assert got == [list(r.generated) for r in eager_reqs], \
            f"tier {tier}: graph and eager tokens differ"
        print(f"[17a] tier {tier} ({res['tiers'][tier]['spec']}) [{card}]: "
              f"graph against eager tokens over {len(prompts)} requests "
              f"identical", flush=True)
        del eng
        gc.collect()
    # the same ladder on the model's own 128 x 128 block grid (the JAX
    # tests' ladder packs 8 x 8 blocks, which the port's GEMV and
    # prefill-tile forms do not take): graphed dispatches on parked slots,
    # the tiers in turns, then one trace each
    grid = load_cut(DANUBE, kr.DENSE, params, QOS_LAYERS, tier_specs=tuple(
        DraftSpec(bits=8, sparsity=sp) for sp in (0.5, 0.75)))
    eng = InferenceEngine(grid, ecfg)
    bk, ms = eng.backend, {t: [] for t in range(grid.n_tiers)}
    for t in list(ms) + list(ms)[::-1]:
        eng.set_tier(t)
        bk.decode_block()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            bk.decode_block()
        torch.cuda.synchronize()
        ms[t].append((time.perf_counter() - t0) * 1e3 / (3 * CHUNK))
    res["grid128"] = {}
    for t in ms:
        eng.set_tier(t)
        prof, _ = profile_calls(torch, bk.decode_block, 1, dtoh=1)
        res["grid128"][t] = dict(
            spec=grid.tier_specs[t - 1].tag if t else "dense",
            wall_ms_per_micro_step=ms[t],
            device_ms_per_micro_step=[c["busy_ms"] / CHUNK for c in prof],
            gemm_device_ms=[gemm_ms(c) / CHUNK for c in prof],
            idle_share=[c["idle_share"] for c in prof])
        r = res["grid128"][t]
        print(f"[17a] 128 x 128 grid, tier {t} ({r['spec']}) [{card}]: wall "
              f"ms / micro-step in turns {[round(v, 3) for v in ms[t]]}, "
              f"device ms / micro-step "
              f"{[round(v, 3) for v in r['device_ms_per_micro_step']]} "
              f"(GEMM {[round(v, 3) for v in r['gemm_device_ms']]})",
              flush=True)
    del eng, grid, bk
    gc.collect()
    res["seconds"] = {"17a": time.perf_counter() - t_phase}

    # ---- 17b: the ledger -------------------------------------------------
    ledgers = {"off": None, "exact": LedgerConfig(),
               "t1e-3": LedgerConfig(threshold=1e-3)}
    engines, res["ledger"] = {}, {}
    for tag, led in ledgers.items():
        eng, reqs, wall, counts, _ = serve_traffic(
            torch, plain, prompts, EngineConfig(ledger=led, **base))
        count(counts)
        rep = eng.metrics.report()
        assert [list(r.generated) for r in reqs] == want, \
            f"ledger {tag}: tokens differ from the ledger off"
        assert rep["host_syncs_decode"] == rep["decode_steps"], rep
        taps = 4 * QOS_LAYERS * CHUNK            # a dispatch's probe taps
        assert counts["ledger_probe"] == (
            taps * rep["decode_steps"] if led else 0), counts
        if led:
            assert rep["ledger_dispatches"] == rep["decode_steps"], rep
        engines[tag] = eng
        summary = eng.ledger.summary()
        res["ledger"][tag] = dict(
            wall_s=wall, tok_per_s=rep["tokens_generated"] / wall,
            decode_dispatches=rep["decode_steps"],
            host_syncs_decode=rep["host_syncs_decode"], launches=counts,
            act_zero_fraction=rep["act_zero_fraction"],
            act_near_zero_fraction=rep["act_near_zero_fraction"],
            dead_kblock_fraction=rep["dead_kblock_fraction"],
            effective_flop_fraction=rep["effective_flop_fraction"],
            act_probe_elems=rep["act_probe_elems"],
            hist_checksum=summary.get("act_hist_checksum"),
            zero_fraction_by_layer=summary.get("zero_fraction_by_layer"))
        if led:
            print(f"[17b] ledger {tag} ({led}) [{card}]: tokens identical to "
                  f"the ledger off; host syncs decode "
                  f"{rep['host_syncs_decode']:.0f} = dispatches "
                  f"{rep['decode_steps']:.0f}; ledger_probe launches "
                  f"{counts['ledger_probe']}; act_zero_fraction "
                  f"{rep['act_zero_fraction']:.6g}, near-zero "
                  f"{rep['act_near_zero_fraction']:.6g}, dead k-block share "
                  f"{rep['dead_kblock_fraction']:.6g}, flops_effective / "
                  f"flops_dense {rep['effective_flop_fraction']:.6g}",
                  flush=True)
            cases += probe_cases(torch, timer, probe_taps(torch, eng), led,
                                 tag)
    # the ledger's cost a micro-step: graphed dispatches on parked slots,
    # the three engines in turns (off, exact, 1e-3, then back)
    order = list(engines)
    ms = {tag: [] for tag in order}
    for tag in order:
        engines[tag].backend.decode_block()
    for turn in order + order[::-1]:
        bk = engines[turn].backend
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            bk.decode_block()
        torch.cuda.synchronize()
        ms[turn].append((time.perf_counter() - t) * 1e3 / (3 * CHUNK))
    for tag in order:
        prof, _ = profile_calls(torch, engines[tag].backend.decode_block, 2,
                                dtoh=1)
        r = res["ledger"][tag]
        r["wall_ms_per_micro_step"] = ms[tag]
        r["device_ms_per_micro_step"] = [c["busy_ms"] / CHUNK for c in prof]
        r["device_ops_per_micro_step"] = [c["device_ops"] / CHUNK
                                          for c in prof]
        r["probe_device_ms_per_micro_step"] = [
            c["device_ms_by_kernel"].get("ledger_probe_kernel", 0.0) / CHUNK
            for c in prof]
        r["idle_share"] = [c["idle_share"] for c in prof]
        print(f"[17b] ledger {tag} [{card}]: wall ms / micro-step in turns "
              f"{[round(v, 3) for v in ms[tag]]}, device ms / micro-step "
              f"{[round(v, 3) for v in r['device_ms_per_micro_step']]} (the "
              f"probe's {[round(v, 4) for v in r['probe_device_ms_per_micro_step']]}"
              f"), device ops / micro-step {r['device_ops_per_micro_step']}, "
              f"idle share {[round(v, 4) for v in r['idle_share']]}",
              flush=True)
    del engines, eng
    gc.collect()
    # the quality probe on tier 1: every admission shadow-run through tier 0
    eng, reqs, wall, counts, _ = serve_traffic(
        torch, model, prompts,
        EngineConfig(ledger=LedgerConfig(quality_every=1), **base), tier=1)
    count(counts)
    rep = eng.metrics.report()
    q = eng.metrics.quality_by_tier()
    assert q[1]["probes"] == len(prompts) and set(q) == {1}, q
    assert rep["host_syncs_quality"] == 2 * rep["quality_probes"], rep
    assert rep["host_syncs_decode"] == rep["decode_steps"], rep
    res["quality"] = dict(by_tier=q, log=eng.quality_log)
    print(f"[17b] quality probe, held on tier 1 ({model.tier_specs[0].tag}) "
          f"[{card}]: top-1 agreement with tier 0 {q[1]['top1_rate']:.4f}, "
          f"mean |logit difference| {q[1]['logit_mad']:.6g} over "
          f"{q[1]['probes']:.0f} admissions", flush=True)
    del eng
    gc.collect()
    res["seconds"]["17b"] = time.perf_counter() - t_phase \
        - res["seconds"]["17a"]

    # ---- 17c: deadlines and pool waits ----------------------------------
    eng, res["pool_pressure"], counts = pool_pressure_cell(
        torch, plain, prompts, EngineConfig(
            page_size=16, n_pages=POOL_PAGES, prefix_cache=False,
            pool_wait_retries=POOL_RETRIES, **base))
    count(counts)
    p = res["pool_pressure"]
    print(f"[17c] {POOL_PAGES} pages of 16, pool_wait_retries "
          f"{POOL_RETRIES}, deadline_steps {POOL_DEADLINE} on every 4th "
          f"request [{card}]: completed {p['completed']:.0f}, shed "
          f"{p['shed']:.0f} (deadline {p['shed_ids']['deadline']}, pool "
          f"{p['shed_ids']['pool']}), pool waits {p['pool_waits']:.0f}; "
          f"page pool pristine after the run", flush=True)
    res["seconds"]["17c"] = time.perf_counter() - t_phase \
        - res["seconds"]["17a"] - res["seconds"]["17b"]
    print(f"[17] seconds by part {res['seconds']}", flush=True)
    del eng, model, plain
    gc.collect()
    torch.cuda.empty_cache()
    return totals, res, cases



# phase 16: the draft each family's dense-slab artifact carries, its K, the
# port's GEMM kernels the speculating path launches (target dense, draft
# as named), the page size of its paged run (None: slab only) and the
# requests it serves: the phase's first ones, one wave of at most 8 slots,
# with SPEC_GEN_LEN new tokens each (cut from GEN_LEN to 16, for the time
# limit, and llava's and whisper's requests from 8 to 4: their eager
# cycles and image or audio admissions are the cells' costliest parts)
SPEC_GEN_LEN = 16
SPEC_FAMILIES = {
    "16a": dict(draft=dict(bits=8, sparsity=0.5), k=4, paged=16,
                gemms={"dense_matmul", "bsr_quant_matmul", "quant_matmul",
                       "bsr_matmul_experts"}, requests=8),
    "16b": dict(draft=dict(bits=8), k=2, paged=None,
                gemms={"dense_matmul", "quant_matmul"}, requests=8),
    "16c": dict(draft=dict(bits=8, sparsity=0.5), k=4, paged=None,
                gemms={"dense_matmul", "bsr_quant_matmul"}, requests=4),
    "16d": dict(draft=dict(bits=8, sparsity=0.5), k=4, paged=16,
                gemms={"dense_matmul", "bsr_quant_matmul"}, requests=4)}
def draft_spec_for(cell):
    from repro_torch.serve import DraftSpec
    return DraftSpec(**SPEC_FAMILIES[cell]["draft"])


def serve_spec(torch, model, ecfg, prompts, extras):
    """Serve `prompts` (SPEC_GEN_LEN new tokens each, greedy) through a
    fresh speculating engine (its build's warm-up dispatch and capture
    allocate the step's buffers); the launch counts are those of the
    served run alone. Returns (engine, tokens, wall s, launches)."""
    from repro_torch.kernels import ops
    from repro_torch.serve import InferenceEngine
    eng = InferenceEngine(model, ecfg)
    reqs = [eng.submit(p, SPEC_GEN_LEN, extras=e)
            for p, e in zip(prompts, extras)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = [list(r.generated) for r in reqs]
    assert all(len(t) == SPEC_GEN_LEN
               and all(0 <= x < model.cfg.vocab for x in t) for t in tokens)
    return eng, tokens, wall, ops.launch_counts()


def timed_ms(torch, fn, n=3, warm=True):
    """Median wall ms of `fn` over n calls, each closed by a device sync,
    after one untimed call (unless `warm` is False: the caller already ran
    `fn` at these shapes)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ms)


def spec_family_cell(torch, card, cell, model, prompts, extras, plain,
                     load):
    """Phase 16, one cell: the dense-slab artifact `model` (its phase's,
    loaded with the cell's draft) speculates greedily over the phase's
    first requests. `plain` is that artifact's plain decode in its phase
    ((tokens, serve_run's result)): its tokens, cut to SPEC_GEN_LEN, are
    the reference of an arch whose rows decode independently, its
    micro-step the plain time a token; an MoE cell serves its own plain
    reference. `load` is the load's (seconds, peak GB). Checks: the spec
    GEMMs and no others, one verify
    block a layer through the page table when paged, graph tokens equal
    the eager step's, paged tokens equal the slab's (near-tie rule),
    speculative tokens equal plain decode's (near-tie rule), on an MoE
    arch with the capacity widened to n_experts / top_k (nothing drops:
    at the served capacity the requests that part are reported, the JAX
    package's behaviour). Reports acceptance, wall ms per cycle graph and
    eager in turns, device ms per cycle, ms per committed token against
    plain's per token, the draft's admission prefill ms (for whisper its
    encoder alone too) and the load's peak."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import EngineConfig
    spec = SPEC_FAMILIES[cell]
    k, n_req = spec["k"], spec["requests"]
    prompts = prompts[:n_req]
    # per-request extras for the engine; None for first_divergence
    given = extras[:n_req] if extras else None
    extras = given or [None] * n_req
    plain_tokens = [t[:SPEC_GEN_LEN] for t in plain[0][:n_req]]
    plain_res = plain[1]
    cfg, dcfg = model.cfg, model.draft_cfg
    max_len = {"llava-next-mistral-7b": LLAVA_MAX_LEN,
               "whisper-large-v3": WHISPER_MAX_LEN}.get(cfg.name,
                                                        512 + GEN_LEN)
    ecfg = EngineConfig(n_slots=N_SLOTS, max_len=max_len, seed=SEED,
                        speculate=k, prefix_cache=False)
    kinds = [T.layer_kind(cfg, i) for i in range(cfg.n_layers)]
    n_attn = sum(kd["mixer"] == "attn" for kd in kinds)
    n_moe = sum(kd["ffn"] == "moe" for kd in kinds)
    n_mamba = sum(kd["mixer"] == "mamba" for kd in kinds)
    r = lambda xs, d=3: [round(x, d) for x in xs]
    res = dict(k=k, draft=model.draft_spec.tag, requests=n_req,
               new_tokens=SPEC_GEN_LEN,
               load_s=load[0], load_peak_memory_allocated_gb=load[1],
               draft_verify_flop_ratio=model.draft_cost_fraction())
    counts, tokens = {}, {}
    for page_size in ((None,) if spec["paged"] is None
                      else (None, spec["paged"])):
        tag = "paged" if page_size else "slab"
        pcfg = dataclasses.replace(ecfg, page_size=page_size)
        eng, tokens[tag], wall, c = serve_spec(torch, model, pcfg, prompts,
                                               extras)
        counts[tag] = c
        rep = eng.metrics.report()
        for name in GEMM_KERNELS:
            assert (c[name] > 0) == (name in spec["gemms"]), (cell, tag, c)
        assert rep["host_syncs_decode"] == rep["spec_dispatches"] > 0, rep
        cycles = rep["spec_dispatches"]
        # prefills: the target's and the draft's, each encoder included
        n_fwd_layers = (cfg.n_layers + dcfg.n_layers) if not cfg.enc_dec \
            else 2 * (cfg.n_layers + cfg.n_enc_layers)
        if cfg.is_ssm or cfg.attn_period:
            assert c["ssm_scan"] == 2 * n_mamba * n_req, c
            assert c["flash_attention"] == 2 * n_attn * n_req, c
        else:
            assert c["flash_attention"] == n_fwd_layers * n_req, c
        # the target's verify block through the page table, once a layer a
        # cycle (the draft keeps its slab)
        assert c["paged_flash_attention"] == (
            n_attn * cycles if page_size else 0), (c, cycles)
        if "bsr_matmul_experts" in spec["gemms"]:
            # the draft's routed projections: its prefills and K + 1
            # micro-steps a cycle
            assert c["bsr_matmul_experts"] == 3 * n_moe * (
                n_req + (k + 1) * cycles), (c, cycles)
        decoded = rep["tokens_generated"] - n_req
        commits = decoded / (sum(eng.metrics.occupancy) * N_SLOTS)
        out = dict(wall_s=wall, tok_per_s=rep["tokens_generated"] / wall,
                   spec_dispatches=cycles,
                   acceptance_rate=rep["acceptance_rate"],
                   draft_proposed=rep["draft_proposed"],
                   draft_accepted=rep["draft_accepted"],
                   commits_per_slot_cycle=commits,
                   latency_s_p50=rep["latency_s_p50"],
                   latency_s_p99=rep["latency_s_p99"], launches=c)
        if page_size is None:
            ab = graph_vs_eager(torch, eng, 1, turns=2, traces=1)
            s = ab_summary(ab, 1)
            cycle_ms = statistics.median(s["graph_ms"])
            plain_step = plain_res["decode_micro_step_ms"]
            # the draft's batch-1 prefill of one admission (the first
            # request: its image rows or frames), against the target's
            bk = eng.backend
            batch = {"tokens": torch.from_numpy(prompts[0][None]).cuda(),
                     **(extras[0] or {})}
            draft_ms = timed_ms(torch, lambda: bk._draft_prefill(
                bk.draft_params, batch), warm=False)
            target_ms = timed_ms(torch, lambda: bk._prefill_last(bk.params,
                                                                 batch),
                                 warm=False)
            out.update(
                cycle_ms=cycle_ms,
                eager_cycle_ms=statistics.median(s["eager_ms"]),
                cycle_device_ms=s["graph_device_ms"],
                cycle_device_ops=s["graph_device_ops"],
                cycle_idle_share=s["graph_idle_share"],
                ms_per_committed_token=cycle_ms / (N_SLOTS * commits),
                plain_micro_step_ms=plain_step,
                plain_ms_per_token=plain_step / N_SLOTS,
                draft_prefill_ms=draft_ms,
                admission_prefill_ms=target_ms, graph_vs_eager=s)
            if cfg.enc_dec:
                out["draft_encoder_ms"] = timed_ms(torch, lambda: T.encode(
                    model.draft_params, extras[0]["frames"], dcfg),
                    warm=False)
            enc = f", of it the draft's encoder " \
                f"{out['draft_encoder_ms']:.1f}" if cfg.enc_dec else ""
            print(f"  [{cell}] spec {cfg.name} slab K={k} draft "
                  f"{res['draft']} [{card}] acceptance "
                  f"{out['acceptance_rate']:.4f} ({rep['draft_accepted']:.0f}"
                  f" of {rep['draft_proposed']:.0f}), commits / slot-cycle "
                  f"{commits:.3f}, cycles {cycles:.0f}, wall ms / cycle "
                  f"{cycle_ms:.3f} (eager {out['eager_cycle_ms']:.3f}), "
                  f"device ms / cycle {r(s['graph_device_ms'])}, idle share "
                  f"{r(s['graph_idle_share'], 4)}; ms / committed token at "
                  f"{N_SLOTS} slots {out['ms_per_committed_token']:.3f} "
                  f"against plain {out['plain_ms_per_token']:.3f} "
                  f"(micro-step {plain_step:.3f}, K {CHUNK}); admission "
                  f"prefill ms: draft {draft_ms:.1f}{enc}, target "
                  f"{target_ms:.1f}; tok/s {out['tok_per_s']:.1f}; load "
                  f"{load[0]:.1f} s, peak {load[1]:.2f} GB with the draft; "
                  f"launches {c}", flush=True)
            out["graph_vs_eager"] = print_ab(card, ab, 1, unit="cycle")
            del eng
            gc.collect()
            out["eager_tokens_identical"] = eager_identity(
                torch, model, pcfg, prompts, SPEC_GEN_LEN, tokens["slab"],
                extras)
        else:
            print(f"  [{cell}] spec {cfg.name} paged (page {page_size}) K={k} "
                  f"[{card}] acceptance {out['acceptance_rate']:.4f}, "
                  f"commits / slot-cycle {commits:.3f}, cycles {cycles:.0f}, "
                  f"tok/s {out['tok_per_s']:.1f}; launches {c}", flush=True)
            del eng
            gc.collect()
            print("    speculative paged against speculative slab tokens:",
                  flush=True)
            out["divergences_from_slab"] = first_divergence(
                torch, model, prompts, tokens["paged"], tokens["slab"],
                given)
        res[tag] = out
    got = tokens["slab"]
    if not cfg.n_experts:
        print("    speculative against plain tokens:", flush=True)
        res["divergences_from_plain"] = first_divergence(
            torch, model, prompts, got, plain_tokens, given)
    else:
        # a decode step routes every live slot as one group, so the plain
        # reference serves this cell's own traffic (the phase's run had
        # other requests live beside these)
        plain_cfg = dataclasses.replace(ecfg, speculate=0, decode_chunk=CHUNK)
        plain_s = serve_tokens(torch, model, plain_cfg, prompts,
                               gen_len=SPEC_GEN_LEN)
        apart = [i for i, (a, b) in enumerate(zip(got, plain_s)) if a != b]
        print(f"    speculative against plain tokens at the served capacity "
              f"{cfg.capacity_factor:g}: requests {apart} of {n_req} part "
              f"(the verify routes other groups than a plain decode step, "
              f"and admissions land a cycle, not {CHUNK} micro-steps, "
              f"apart)", flush=True)
        wide = cfg.n_experts / cfg.top_k
        wmodel = dataclasses.replace(
            model, cfg=dataclasses.replace(cfg, capacity_factor=wide),
            draft_cfg=dataclasses.replace(dcfg, capacity_factor=wide))
        spec_w = serve_tokens(torch, wmodel, ecfg, prompts,
                              gen_len=SPEC_GEN_LEN)
        plain_w = serve_tokens(torch, wmodel, plain_cfg, prompts,
                               gen_len=SPEC_GEN_LEN)
        print(f"    speculative against plain tokens, capacity factor "
              f"{wide:g} (no drops):", flush=True)
        res.update(requests_apart_at_served_capacity=apart,
                   divergences_without_drops=first_divergence(
                       torch, wmodel, prompts, spec_w, plain_w))
    total = {}
    for c in counts.values():
        for name, v in c.items():
            total[name] = total.get(name, 0) + v
    return total, res


def run_spec_family(torch, card, mark, cell, model, prompts, extras, plain,
                    load, totals):
    """Phase 16's cell `cell` on its phase's dense-slab artifact, after
    `mark(cell)`; its launches are added to the phase's `totals`, its
    result returned."""
    mark(cell)
    spec = SPEC_FAMILIES[cell]
    print(f"[{cell}] speculative self-draft decode, {model.cfg.name}, "
          f"{model.cfg.n_layers} layers: dense target, draft "
          f"{model.draft_spec.tag}, K {spec['k']}, the first "
          f"{spec['requests']} requests, {SPEC_GEN_LEN} new tokens each, slab"
          + (f" and paged (page {spec['paged']})" if spec["paged"] else ""),
          flush=True)
    counts, res = spec_family_cell(torch, card, cell, model, prompts, extras,
                                   plain, load)
    add_counts(totals, counts)
    return res


def load_cut(arch, spec, params, n_layers, **kw):
    """The registry's full-config artifact cut to its first `n_layers`
    layers (its draft's config cut with it), over `params`."""
    from repro_torch.serve import ModelRegistry
    return ModelRegistry().load(arch, spec, smoke=False, params=params,
                                n_layers=n_layers, seed=SEED, **kw)


def serve_run(torch, card, model, prompts, ecfg, gemms, tag, grids=False,
              extras=None, prefill_len=512):
    """Serve `prompts` (GEN_LEN new tokens each, greedy; with `extras`, the
    per-request model inputs, a vision arch's image rows or an
    encoder-decoder's frames) through a fresh engine after an allocator
    warm-up, as the main path; check that only the spec's GEMMs ran and
    which attention kernels did (flash at prefill for GQA, the page-table
    kernel once an attention layer a micro-step when paged; none for MLA);
    time and trace the graphed dispatch against the eager step, and trace
    a `prefill_len`-token prefill (with the first request's extras).
    Returns (launches, result, engine, tokens)."""
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import gemm_plan, ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import InferenceEngine
    cfg, k = model.cfg, ecfg.decode_chunk
    extras = extras or [None] * len(prompts)
    warm = InferenceEngine(model, ecfg)          # allocator warm-up
    warm.submit(prompts[0][:32], 4, extras=extras[0])
    warm.run()
    del warm
    gc.collect()
    eng = InferenceEngine(model, ecfg)
    reqs = [eng.submit(p, GEN_LEN, extras=e) for p, e in zip(prompts, extras)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    rep = eng.metrics.report()
    tokens = [list(r.generated) for r in reqs]
    assert all(len(t) == GEN_LEN and all(0 <= x < cfg.vocab for x in t)
               for t in tokens)
    for name in GEMM_KERNELS:
        assert (counts[name] > 0) == (name in gemms), (tag, counts)
    paged = ecfg.page_size is not None
    n_attn = sum(T.layer_kind(cfg, i)["mixer"] == "attn"
                 for i in range(cfg.n_layers))
    assert (counts["flash_attention"] > 0) != cfg.mla, counts
    assert counts["paged_flash_attention"] == (
        n_attn * rep["micro_steps"] if paged and not cfg.mla else 0), \
        (counts, rep["micro_steps"])
    assert rep["host_syncs_decode"] == rep["decode_steps"], rep
    ab = graph_vs_eager(torch, eng, k, grids=grids)
    prof = ab["graph_prof"]
    gemm = [gemm_ms(c) / k for c in prof]
    other = [non_gemm_ms(c) / k for c in prof]
    attn = [c["device_ms_by_kernel"].get("paged_kernel", 0.0) / k
            for c in prof]
    if counts["paged_flash_attention"]:
        assert all(a > 0 for a in attn), (tag, attn)
    tile = [sum(c["device_ms_by_kernel"].get(f, 0.0) for f in TILE_FAMILIES)
            / k for c in prof]
    busy = [c["busy_ms"] / k for c in prof]
    batch = {"tokens": torch.from_numpy(
        np.resize(prompts[0], (1, prefill_len)).astype(np.int32)).cuda(),
        **(extras[0] or {})}
    eng.backend.prefill(batch, exact=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.backend.prefill(batch, exact=True)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t1) * 1e3
    prefill_prof, _ = profile_calls(
        torch, lambda: eng.backend.prefill(batch, exact=True), 1)
    flash = [c["device_ms_by_kernel"].get("fa_tc_kernel", 0.0)
             for c in prefill_prof]
    if not cfg.mla:
        assert all(f > 0 for f in flash), (tag, flash)
    res = dict(
        spec=kr.spec_tag(model.spec), page_size=ecfg.page_size, wall_s=wall,
        tok_per_s=rep["tokens_generated"] / wall,
        latency_s_p50=rep["latency_s_p50"],
        latency_s_p99=rep["latency_s_p99"],
        decode_dispatches=rep["decode_steps"], micro_steps=rep["micro_steps"],
        decode_micro_step_ms=statistics.median(ab["graph_ms"]),
        gemm_device_ms_per_micro_step=gemm,
        non_gemm_device_ms_per_micro_step=other,
        paged_attention_device_ms_per_micro_step=attn,
        device_ms_per_micro_step=busy,
        tile_gemm_device_ms_per_micro_step=tile,
        idle_share=[c["idle_share"] for c in prof],
        device_ops_per_micro_step=[c["device_ops"] / k for c in prof],
        decode_dispatch_profiled=prof,
        packed_mb=model.packed_bytes / 2 ** 20, launches=counts)
    pre = f"prefill_{prefill_len}_"
    res.update({pre + "ms": prefill_ms, pre + "flash_device_ms": flash,
                pre + "gemm_device_ms": [gemm_ms(c) for c in prefill_prof],
                pre + "profiled": prefill_prof})
    if cfg.mla:
        # the expansion is the only tiled GEMM of an MLA decode dispatch
        assert gemm_plan.plan(ecfg.n_slots * ecfg.max_len, cfg.kv_lora_rank,
                              cfg.n_heads * (cfg.qk_nope_dim
                                             + cfg.v_head_dim)).form == "tile"
        res["expansion_share_of_device_time"] = [t / b_ for t, b_ in
                                                 zip(tile, busy)]
    r = lambda xs, d=3: [round(x, d) for x in xs]
    print(f"  {cfg.name} {tag:12s} [{card}] tok/s={res['tok_per_s']:.1f} "
          f"p50={rep['latency_s_p50']:.3f}s p99={rep['latency_s_p99']:.3f}s "
          f"packed={res['packed_mb']:.0f} MB micro-step="
          f"{res['decode_micro_step_ms']:.2f} ms; device ms / micro-step "
          f"{r(busy)}: GEMM {r(gemm)} (tiled {r(tile)}), non-GEMM {r(other)} "
          f"(of it paged attention {r(attn)}); device ops / micro-step "
          f"{res['device_ops_per_micro_step']}; idle share "
          f"{r(res['idle_share'], 4)}; dispatches {rep['decode_steps']:.0f}, "
          f"micro-steps {rep['micro_steps']:.0f}; launches {counts}",
          flush=True)
    if cfg.mla:
        print(f"    naive MLA expansion (wkv_b at m = "
              f"{ecfg.n_slots * ecfg.max_len}): share of decode device time "
              f"{r(res['expansion_share_of_device_time'], 4)}", flush=True)
    img = f"{cfg.n_img_tokens} image rows + " if cfg.n_img_tokens else \
        f"{cfg.enc_positions} encoder frames + " if cfg.enc_dec else ""
    print(f"    {img}{prefill_len}-token prefill: untraced wall "
          f"{prefill_ms:.2f} ms, flash device ms {r(flash, 4)}, GEMM device "
          f"ms {r(res[pre + 'gemm_device_ms'])}", flush=True)
    res["graph_vs_eager"] = print_ab(card, ab, k)
    return counts, res, eng, tokens


def add_counts(totals, counts):
    for name, c in counts.items():
        totals[name] += c


def phase_gemma2(torch, card):
    """gemma2-27b at its published width (d_model 4608, 32/16 heads,
    head_dim 128, d_ff 36864 gelu_tanh, vocab 256000 tied), depth cut from
    46 to 4 layers (2 local/global pairs; 46 layers are 108.9 GB in f32, and
    8 would not leave the script its time limit),
    random f32 weights from the seed, phase 5's traffic in its vocab:
    dense and s0.5-w8 from the slab, dense from the page pool (page 16:
    the local window 4096 exceeds max_len, so every layer is page-major
    and the page-table kernel runs with softcap 50 and window 4096 on
    local layers). Then one long run past the window: 2 requests of 4160
    prompt tokens (flash prefill at sq 4160, window 4096 on local layers)
    and 32 new tokens, max_len 4224 (local layers hold a 4096-row
    circular cache), whose tokens must equal the eager step's."""
    from repro_torch import configs as C
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import EngineConfig, InferenceEngine

    cfg = C.get_config(GEMMA, n_layers=GEMMA_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"  init {GEMMA} full width, {cfg.n_layers} layers (f32): "
          f"{time.perf_counter() - t0:.1f} s, memory_allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    prompts = serving_traffic(cfg.vocab)
    totals = {name: 0 for name in ops.KERNELS}
    results, tokens = {}, {}
    runs = {"dense-slab": (kr.DENSE, None, {"dense_matmul"}),
            "s0.5-w8-slab": (kr.KratosSpec(sparsity=0.5, bits=8), None,
                             {"bsr_quant_matmul"}),
            "dense-paged": (kr.DENSE, 16, {"dense_matmul"})}
    for tag, (spec, page_size, gemms) in runs.items():
        model = load_cut(GEMMA, spec, params, cfg.n_layers)
        ecfg = EngineConfig(n_slots=N_SLOTS, max_len=512 + GEN_LEN,
                            decode_chunk=CHUNK, seed=SEED,
                            page_size=page_size)
        counts, res, eng, tokens[tag] = serve_run(torch, card, model,
                                                  prompts, ecfg, gemms, tag)
        add_counts(totals, counts)
        if page_size:
            assert all(eng.pool.layout.paged[i]["k"]
                       for i in range(cfg.n_layers))
            assert eng.pool.index is None     # a windowed arch shares none
        del eng
        gc.collect()
        res["eager_tokens_identical"] = eager_identity(
            torch, model, ecfg, prompts, GEN_LEN, tokens[tag])
        if tag == "dense-paged":
            print("  dense paged against dense slab tokens:", flush=True)
            res["divergences"] = first_divergence(
                torch, model, prompts, tokens[tag], tokens["dense-slab"])
        results[tag] = res
        del model
        gc.collect()

    # the long run: past the local layers' window
    model = load_cut(GEMMA, kr.DENSE, params, cfg.n_layers)
    rng = np.random.default_rng(SEED + 2)
    long_prompts = [rng.integers(0, cfg.vocab, 4160).astype(np.int32)
                    for _ in range(2)]
    ecfg = EngineConfig(n_slots=2, max_len=4160 + GEN_LEN + 32,
                        decode_chunk=CHUNK, seed=SEED)
    eng = InferenceEngine(model, ecfg)
    assert tuple(eng.pool.caches[0]["k"].shape[2:]) == (4096, 128)
    assert tuple(eng.pool.caches[1]["k"].shape[2:]) == (ecfg.max_len, 128)
    reqs = [eng.submit(p, GEN_LEN) for p in long_prompts]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    add_counts(totals, counts)
    rep = eng.metrics.report()
    long_tokens = [list(r.generated) for r in reqs]
    assert all(len(t) == GEN_LEN for t in long_tokens)
    assert counts["flash_attention"] == cfg.n_layers * 2, counts
    ab = graph_vs_eager(torch, eng, CHUNK, turns=2, traces=1)
    del eng
    gc.collect()
    results["long"] = dict(
        prompt_tokens=4160, max_len=ecfg.max_len, wall_s=wall,
        tok_per_s=rep["tokens_generated"] / wall,
        latency_s_p50=rep["latency_s_p50"], launches=counts,
        micro_steps=rep["micro_steps"], tokens=long_tokens)
    print(f"  {cfg.name} long [{card}] 2 x 4160 prompt tokens past the "
          f"4096 window, max_len {ecfg.max_len}: wall {wall:.2f} s, tok/s "
          f"{results['long']['tok_per_s']:.1f}, launches {counts}",
          flush=True)
    results["long"]["graph_vs_eager"] = print_ab(card, ab, CHUNK)
    results["long"]["eager_tokens_identical"] = eager_identity(
        torch, model, ecfg, long_prompts, GEN_LEN, long_tokens)
    results["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return totals, results


def phase_minicpm3(torch, card):
    """minicpm3-4b (MLA) at its published width (d_model 2560, 40 heads,
    q_lora 768, kv_lora 256, nope 64 / rope 32 / v 64, d_ff 6400, vocab
    73448 tied), depth cut from 62 to 4 layers (62 layers took 397 s of
    the script's 1200, most of it the host-bound eager partners, 16 layers
    107-117 s, 8 layers 62 s; 4 make room for phase 21; the residual scale
    stays the published 1.4 / sqrt(62)), random f32 weights
    from the seed: phase 5's traffic from the slab,
    dense and s0.5-w8; phase 7's prefix traffic from the page pool;
    speculative decode (K 4, draft DraftSpec(bits=8)) from the slab and
    the page pool against plain decode. MLA is the reference's naive form:
    every decode micro-step expands the whole latent cache through wkv_b
    (m = n_slots x max_len), and no attention kernel runs."""
    from repro_torch import configs as C
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import DraftSpec, EngineConfig

    cfg = C.get_config(MINICPM, n_layers=MINICPM_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"  init {MINICPM} full width, {cfg.n_layers} layers (f32): "
          f"{time.perf_counter() - t0:.1f} s, memory_allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    prompts = serving_traffic(cfg.vocab)
    totals = {name: 0 for name in ops.KERNELS}
    results = {}
    for tag, spec, gemms in (
            ("dense-slab", kr.DENSE, {"dense_matmul"}),
            ("s0.5-w8-slab", kr.KratosSpec(sparsity=0.5, bits=8),
             {"bsr_quant_matmul", "quant_matmul"})):
        model = load_cut(MINICPM, spec, params, cfg.n_layers)
        ecfg = EngineConfig(n_slots=N_SLOTS, max_len=512 + GEN_LEN,
                            decode_chunk=CHUNK, seed=SEED)
        counts, res, eng, toks = serve_run(torch, card, model, prompts, ecfg,
                                           gemms, tag)
        add_counts(totals, counts)
        del eng
        gc.collect()
        res["eager_tokens_identical"] = eager_identity(
            torch, model, ecfg, prompts, GEN_LEN, toks)
        results[tag] = res
        del model
        gc.collect()
    model = load_cut(MINICPM, kr.DENSE, params, cfg.n_layers,
                     draft_spec=DraftSpec(bits=8))
    print(f"  {model.name}: memory_allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    for page_size in (None, 16):
        counts, res = spec_cell(torch, card, model, prompts, 4, page_size,
                                {"dense_matmul", "quant_matmul"})
        results[f"spec {'paged' if page_size else 'slab'}"] = res
        add_counts(totals, counts)
    results["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {MINICPM} prefix and conversation reuse through the page pool",
          flush=True)
    counts, results["prefix_reuse"] = phase_prefix_reuse(
        torch, card, MINICPM, cfg.n_layers)
    add_counts(totals, counts)
    return totals, results


def routed_kernels(torch, model, rows):
    """The GEMM kernels of one MoE layer's expert FFN at the capacity C of
    a `rows`-token group, by name and grid: the union of two traces of 3
    calls of it alone, after a warm-up call. The tracer can miss the first
    launches of so short a trace, or all of it: such a trace is taken
    again, at most 4 times in all (`routed_ms` checks that the set is
    whole). Under a block-sparse spec the kernels are bsr_matmul_experts'
    with the experts in the grid; under the dense spec the library's
    batched GEMM, which its name and grid tell from the head's and the
    attention's library GEMMs."""
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    cfg = model.cfg
    moe = next(i for i in range(cfg.n_layers)
               if T.layer_kind(cfg, i)["ffn"] == "moe")
    mcfg = T.moe_cfg_for(cfg)
    ffn = model.params["layers"][moe]["ffn"]
    xe = torch.randn((cfg.n_experts, M.capacity(mcfg, rows), cfg.d_model),
                     device="cuda")
    M._expert_ffn(ffn, xe, mcfg)
    torch.cuda.synchronize()
    keys, kept = set(), 0
    for _ in range(4):
        try:
            got = trace_call(torch, lambda: [M._expert_ffn(ffn, xe, mcfg)
                                             for _ in range(3)],
                             grids=True)["gemm_launches_by_grid"]
        except AssertionError:              # the trace holds no device op
            continue
        keys |= set(got)
        kept += bool(got)
        if kept == 2:
            break
    assert keys, "no GEMM kernel traced in the expert FFN"
    return sorted(keys)


def routed_ms(call, keys, forwards):
    """Device ms of a traced call (taken with grids) in the routed experts'
    GEMM kernels (`routed_kernels`' keys); they must have launched 3 times
    (one a projection) in each of the call's `forwards` MoE-layer forwards,
    or a key also names another GEMM and the split would not hold."""
    n = sum(call["gemm_launches_by_grid"].get(k, 0) for k in keys)
    assert n == 3 * forwards, (n, forwards, keys)
    return sum(call["gemm_device_ms_by_grid"].get(k, 0.0) for k in keys)


def mamba_mixer_ms(torch, model, rows):
    """Device ms and GEMM device ms of one decode micro-step of the model's
    Mamba mixers alone (every Mamba layer's mixer on `rows` slots, eager,
    on fresh states): the median of two traces. The mixers' kernels are
    those of the graphed dispatch; traced alone, their time is told apart
    from the attention, FFN and routing kernels that share their names."""
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T
    cfg = model.cfg
    mcfg = T.mamba_cfg_for(cfg)
    layers = [i for i in range(cfg.n_layers)
              if T.layer_kind(cfg, i)["mixer"] == "mamba"]
    caches = [S.make_mamba_cache(mcfg, rows, torch.float32, "cuda")
              for _ in layers]
    h = torch.randn((rows, 1, cfg.d_model), device="cuda")
    index = torch.full((rows,), 100, dtype=torch.int32, device="cuda")

    def step():
        for i, c in zip(layers, caches):
            S.mamba_apply(model.params["layers"][i]["mixer"], h, mcfg,
                          cache=c, index=index)
    step()
    torch.cuda.synchronize()
    calls = [trace_call(torch, step) for _ in range(2)]
    return (statistics.median(c["busy_ms"] for c in calls),
            statistics.median(gemm_ms(c) for c in calls), len(layers))


def split_moe_step(torch, model, res, n_moe, per_fwd, mamba):
    """Decode device ms per micro-step of an MoE run (`res` from serve_run
    with grids) split from each traced dispatch: the routed experts'
    GEMM kernels (by name and grid, `routed_kernels`), the Mamba mixers
    (`mamba`: their device ms and GEMM ms traced alone, or None), the
    port's other GEMMs and the rest. Returns (keys, routed, mamba, other
    GEMM, rest) per traced dispatch."""
    keys = routed_kernels(torch, model, N_SLOTS)
    routed = [routed_ms(c, keys, n_moe * CHUNK) / CHUNK
              for c in res["decode_dispatch_profiled"]]
    assert all(v > 0 for v in routed), routed
    mix, mix_gemm = mamba or (0.0, 0.0)
    other = [g - (v if per_fwd else 0.0) - mix_gemm for g, v in
             zip(res["gemm_device_ms_per_micro_step"], routed)]
    rest = [b - v - mix - o for b, v, o in
            zip(res["device_ms_per_micro_step"], routed, other)]
    return keys, routed, [mix] * len(routed), other, rest


def phase_moe(torch, card, mark):
    """deepseek-moe-16b at its published width (d_model 2048, 16 heads of
    128, 64 routed experts of d_ff 1408, top 6, 2 shared, the dense prelude
    layer of d_ff 10944, vocab 102400 untied), depth cut from 28 to
    DEEPSEEK_LAYERS (28 layers are 65.5 GB in f32: no room for a second
    packed copy or the KV pool, nor time in the script's limit), random
    f32 weights from the seed, phase 5's traffic in its vocab: dense and
    s0.5-w8 from the slab, dense from the page pool without prefix reuse,
    and phase 7's prefix traffic. Prompts prefill at exact length (pad tokens would take
    expert capacity). Then deepseek-v2-lite-16b (MLA + MoE), depth cut
    from 27 to 4 layers, dense from the slab."""
    from repro_torch import configs as C
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import EngineConfig

    cfg = C.get_config(DEEPSEEK, n_layers=DEEPSEEK_LAYERS)
    n_moe = sum(T.layer_kind(cfg, i)["ffn"] == "moe"
                for i in range(cfg.n_layers))
    assert n_moe == DEEPSEEK_LAYERS - 1, n_moe
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"  init {DEEPSEEK} full width, {cfg.n_layers} layers (f32): "
          f"{time.perf_counter() - t0:.1f} s, memory_allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    prompts = serving_traffic(cfg.vocab)
    totals = {name: 0 for name in ops.KERNELS}
    results, tokens = {}, {}
    runs = {"dense-slab": (kr.DENSE, None, {"dense_matmul"}),
            "s0.5-w8-slab": (kr.KratosSpec(sparsity=0.5, bits=8), None,
                             {"bsr_quant_matmul", "quant_matmul",
                              "bsr_matmul_experts"}),
            "dense-paged": (kr.DENSE, 16, {"dense_matmul"})}
    r = lambda xs, d=3: [round(x, d) for x in xs]
    for tag, (spec, page_size, gemms) in runs.items():
        # the dense-slab artifact carries phase 16a's draft
        draft = draft_spec_for("16a") if tag == "dense-slab" else None
        model, pack_s, peak = load_peak(torch, lambda: load_cut(
            DEEPSEEK, spec, params, cfg.n_layers, draft_spec=draft))
        ecfg = EngineConfig(n_slots=N_SLOTS, max_len=512 + GEN_LEN,
                            decode_chunk=CHUNK, seed=SEED,
                            page_size=page_size, prefix_cache=False)
        counts, res, eng, tokens[tag] = serve_run(
            torch, card, model, prompts, ecfg, gemms, tag, grids=True)
        add_counts(totals, counts)
        assert eng._exact_prefill
        if page_size:
            assert eng.pool.index is None
        # the batched kernel: once per routed projection of every MoE layer
        # in every forward, prefills and graphed micro-steps alike
        per_fwd = 3 * n_moe if "bsr_matmul_experts" in gemms else 0
        per_replay = eng.backend._graph_launches.get("bsr_matmul_experts", 0)
        assert per_replay == per_fwd * CHUNK, per_replay
        assert counts["bsr_matmul_experts"] == per_fwd * (
            len(prompts) + res["micro_steps"]), counts
        # decode device ms split from the dispatch's own trace: the routed
        # experts' GEMM kernels (the port's batched kernel, or the dense
        # spec's library batched GEMM), the port's other GEMMs, the rest
        keys, routed_step, _, other_gemm, non_gemm = split_moe_step(
            torch, model, res, n_moe, per_fwd, None)
        res.update(pack_s=pack_s, load_peak_memory_allocated_gb=peak,
                   draft=None if draft is None else draft.tag,
                   routed_expert_kernels=keys,
                   routed_expert_device_ms_per_micro_step=routed_step,
                   other_gemm_device_ms_per_micro_step=other_gemm,
                   non_gemm_rest_device_ms_per_micro_step=non_gemm,
                   expert_launches_per_micro_step=per_fwd)
        print(f"    {tag}: device ms / micro-step "
              f"{r(res['device_ms_per_micro_step'])} = routed experts "
              f"{r(routed_step)} + other port GEMM {r(other_gemm)} + the "
              f"rest (router, sort, combine, attention, head, elementwise) "
              f"{r(non_gemm)}; routed-expert kernels "
              f"{[k.split('<')[0][-24:] + ' ' + k.split(' grid ')[-1] for k in keys]}; "
              f"bsr_matmul_experts launches / micro-step {per_fwd}, per "
              f"replay {per_replay}; pack {pack_s:.1f} s, load peak "
              f"{peak:.2f} GB"
              + ("" if draft is None else f" with the draft {draft.tag}"),
              flush=True)
        del eng
        gc.collect()
        res["eager_tokens_identical"] = eager_identity(
            torch, model, ecfg, prompts, GEN_LEN, tokens[tag])
        if tag == "dense-paged":
            print("  dense paged against dense slab tokens:", flush=True)
            res["divergences"] = first_divergence(
                torch, model, prompts, tokens[tag], tokens["dense-slab"])
        results[tag] = res
        if draft is not None:
            results["16a"] = run_spec_family(
                torch, card, mark, "16a", model, prompts, None,
                (tokens[tag], res), (pack_s, peak), totals)
        del model
        gc.collect()
    results["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {DEEPSEEK} prefix and conversation reuse through the page pool",
          flush=True)
    counts, results["prefix_reuse"] = phase_prefix_reuse(
        torch, card, DEEPSEEK, DEEPSEEK_LAYERS)
    add_counts(totals, counts)

    print(f"  {LITE} (MLA + MoE): card vs CPU at full width, 2 layers; then "
          f"full width, {LITE_LAYERS} layers", flush=True)
    parity = phase_parity(torch, LITE, 48, 128)
    assert parity["flash_attention"] == 0, parity
    assert parity["bsr_matmul_experts"] == 3, parity
    lcfg = C.get_config(LITE, n_layers=LITE_LAYERS)
    params = T.init(lcfg, seed=SEED, device="cuda")
    model = load_cut(LITE, kr.DENSE, params, lcfg.n_layers)
    ecfg = EngineConfig(n_slots=N_SLOTS, max_len=512 + GEN_LEN,
                        decode_chunk=CHUNK, seed=SEED)
    counts, res, eng, toks = serve_run(torch, card, model,
                                       serving_traffic(lcfg.vocab), ecfg,
                                       {"dense_matmul"}, "dense-slab")
    add_counts(totals, counts)
    del eng
    gc.collect()
    res["eager_tokens_identical"] = eager_identity(
        torch, model, ecfg, serving_traffic(lcfg.vocab), GEN_LEN, toks)
    results[LITE + " dense-slab"] = res
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return totals, results


def serve_tokens(torch, model, ecfg, prompts, extras=None, gen_len=GEN_LEN):
    """Greedy tokens of `prompts` (`gen_len` new each) through a fresh
    engine, every dispatch a graph replay."""
    from repro_torch.serve import InferenceEngine
    eng = InferenceEngine(model, ecfg)
    reqs = [eng.submit(p, gen_len, extras=None if extras is None else e)
            for p, e in zip(prompts, extras or prompts)]
    eng.run()
    torch.cuda.synchronize()
    return [list(r.generated) for r in reqs]


def load_peak(torch, load):
    """(model, seconds, peak GB of memory_allocated) of one load."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = load()
    torch.cuda.synchronize()
    return (model, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 1e9)


def paged_against_slab(torch, model, ecfg, prompts, paged, slab):
    """Hold an MoE arch's paged tokens to its slab tokens. A decode step
    routes the parked rows with the live ones, and a parked row reads its
    stale slab row on the slab but the sink page in a pool, so where
    capacity drops assignments the two pools' tokens may part, as the JAX
    package's two engines do (tests/test_torch_jamba.py::
    test_engines_part_where_decode_drops): at the served capacity the
    requests that differ are reported. The identity is held with the
    capacity widened to n_experts / top_k (C = the whole group: nothing
    drops, and a row's routing is its own), both pools graphed, near-tie
    rule."""
    apart = [i for i, (a, b) in enumerate(zip(paged, slab)) if a != b]
    print(f"  dense paged against dense slab tokens at the served capacity: "
          f"requests {apart} differ", flush=True)
    cfg = model.cfg
    wide = dataclasses.replace(model, cfg=dataclasses.replace(
        cfg, capacity_factor=cfg.n_experts / cfg.top_k))
    got = serve_tokens(torch, wide, ecfg, prompts)
    want = serve_tokens(torch, wide, dataclasses.replace(ecfg, page_size=None),
                        prompts)
    print(f"  dense paged against dense slab tokens, capacity factor "
          f"{wide.cfg.capacity_factor:g} (no drops):", flush=True)
    return dict(requests_apart_at_served_capacity=apart,
                divergences_without_drops=first_divergence(
                    torch, wide, prompts, got, want))


def phase_jamba(torch, card, mark):
    """jamba-v0.1-52b at its published width (d_model 4096, 32/8 heads of
    128 without RoPE, Mamba d_inner 8192 / d_state 16, 16 routed experts
    of d_ff 14336 top 2 at odd layers, dense MLPs of 14336 at even ones,
    vocab 65536 untied), depth cut from 32 to one Jamba block of 8 layers
    (7 Mamba, 1 attention, 4 MoE; 53.2 GB in f32, 206 GB at 32), random
    f32 weights from the seed, phase 5's traffic in its vocab: dense and
    s0.5-w8 from the slab (each model loaded alone: the s0.5-w8 copy packs
    leaf by leaf out of its own dense tree after the dense model is
    freed), dense from the page pool (the attention layer's k/v paged, the
    Mamba state resident). Prompts prefill at exact length. Every run
    launches ssm_scan (7 a prefill), flash attention (1 a prefill) and,
    under s0.5-w8, bsr_matmul_experts (12 a forward)."""
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import EngineConfig, ModelRegistry

    prompts = serving_traffic(65536)
    totals = {name: 0 for name in ops.KERNELS}
    results, tokens = {}, {}
    runs = {"dense-slab": (kr.DENSE, None, {"dense_matmul"}),
            "s0.5-w8-slab": (kr.KratosSpec(sparsity=0.5, bits=8), None,
                             {"bsr_quant_matmul", "quant_matmul",
                              "bsr_matmul_experts"}),
            "dense-paged": (kr.DENSE, 16, {"dense_matmul"})}
    r = lambda xs, d=3: [round(x, d) for x in xs]
    for tag, (spec, page_size, gemms) in runs.items():
        # the dense-slab artifact carries phase 16b's draft: bits-only, so
        # its routed stacks are the target's own (a block-sparse expert
        # draft would freeze ~22 GB of f32 blocks beside the 53.2 GB tree)
        draft = draft_spec_for("16b") if tag == "dense-slab" else None
        model, load_s, peak = load_peak(torch, lambda: ModelRegistry().load(
            JAMBA, spec, smoke=False, seed=SEED, n_layers=JAMBA_LAYERS,
            draft_spec=draft))
        cfg = model.cfg
        kinds = [T.layer_kind(cfg, i) for i in range(cfg.n_layers)]
        n_moe = sum(k["ffn"] == "moe" for k in kinds)
        n_mamba = sum(k["mixer"] == "mamba" for k in kinds)
        assert (n_moe, n_mamba) == (4, 7) and not cfg.use_rope
        print(f"  load {JAMBA} {tag}: {load_s:.1f} s, memory_allocated "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB, peak "
              f"{peak:.2f} GB", flush=True)
        ecfg = EngineConfig(n_slots=N_SLOTS, max_len=512 + GEN_LEN,
                            decode_chunk=CHUNK, seed=SEED,
                            page_size=page_size)
        counts, res, eng, tokens[tag] = serve_run(
            torch, card, model, prompts, ecfg, gemms, tag, grids=True)
        add_counts(totals, counts)
        assert eng._exact_prefill and eng._len_bounded
        if page_size:
            assert eng.pool.index is None
        n_pre = len(prompts)
        assert counts["ssm_scan"] == n_mamba * n_pre, counts
        assert counts["flash_attention"] == n_pre, counts
        per_fwd = 3 * n_moe if "bsr_matmul_experts" in gemms else 0
        assert counts["bsr_matmul_experts"] == per_fwd * (
            n_pre + res["micro_steps"]), counts
        assert eng.backend._graph_launches.get(
            "bsr_matmul_experts", 0) == per_fwd * CHUNK
        mamba = mamba_mixer_ms(torch, model, N_SLOTS)[:2]
        keys, routed, mix, other, rest = split_moe_step(
            torch, model, res, n_moe, per_fwd, mamba)
        res.update(load_s=load_s, load_peak_memory_allocated_gb=peak,
                   draft=None if draft is None else draft.tag,
                   routed_expert_kernels=keys,
                   routed_expert_device_ms_per_micro_step=routed,
                   mamba_mixer_device_ms_per_micro_step=mix,
                   mamba_mixer_gemm_device_ms_per_micro_step=mamba[1],
                   other_gemm_device_ms_per_micro_step=other,
                   non_gemm_rest_device_ms_per_micro_step=rest,
                   expert_launches_per_micro_step=per_fwd)
        print(f"    {tag}: device ms / micro-step "
              f"{r(res['device_ms_per_micro_step'])} = routed experts "
              f"{r(routed)} + Mamba mixers {r(mix)} (traced alone; GEMM "
              f"{mamba[1]:.3f} of it) + other port GEMM {r(other)} + the "
              f"rest (attention, router, combine, head, elementwise) "
              f"{r(rest)}; bsr_matmul_experts launches / micro-step "
              f"{per_fwd}; load peak {peak:.2f} GB"
              + ("" if draft is None else f" with the draft {draft.tag}"),
              flush=True)
        del eng
        gc.collect()
        res["eager_tokens_identical"] = eager_identity(
            torch, model, ecfg, prompts, GEN_LEN, tokens[tag])
        if tag == "dense-paged":
            res.update(paged_against_slab(torch, model, ecfg, prompts,
                                          tokens[tag], tokens["dense-slab"]))
        results[tag] = res
        if draft is not None:
            # a bits-only draft keeps the raw expert stacks: the target's
            shared = [model.draft_params["layers"][i]["ffn"][w].data_ptr()
                      == model.params["layers"][i]["ffn"][w].data_ptr()
                      for i, kd in enumerate(kinds) if kd["ffn"] == "moe"
                      for w in ("w_gate", "w_up", "w_down")]
            assert shared and all(shared), shared
            print(f"  the draft's {len(shared)} routed stacks are the "
                  "target's own tensors (same data_ptr)", flush=True)
            results["16b"] = run_spec_family(
                torch, card, mark, "16b", model, prompts, None,
                (tokens[tag], res), (load_s, peak), totals)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return totals, results


def phase_llava(torch, card, mark):
    """llava-next-mistral-7b at its published width (d_model 4096, 32/8
    heads of 128, d_ff 14336, window 4096, vocab 32000 untied), depth cut
    from 32 to 8 layers (~8 GB in f32), random f32 weights from the
    seed: 8 requests, each with 2880 stub image rows (the port's
    llava_patches of a seeded image) and phase 5's first 8 prompts
    (32-512 tokens) with 32 new tokens, n_slots 8, max_len 3456: dense and
    s0.5-w8 from the slab, dense from the page pool (every layer's k/v
    paged: the window is past max_len). Prefix reuse is off for the
    arch."""
    from repro_torch import configs as C
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import ops
    from repro_torch.models import frontends as F
    from repro_torch.models import transformer as T
    from repro_torch.serve import EngineConfig

    cfg = C.get_config(LLAVA, n_layers=LLAVA_LAYERS)
    t0 = time.perf_counter()
    params = T.init(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"  init {LLAVA} full width, {cfg.n_layers} layers (f32): "
          f"{time.perf_counter() - t0:.1f} s, memory_allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    prompts = serving_traffic(cfg.vocab)[:LLAVA_REQUESTS]
    rng = np.random.default_rng(SEED)
    extras = [{"img_embeds": F.llava_patches(rng.random((1, 336, 336, 3)),
                                             cfg.d_model)}
              for _ in prompts]
    assert all(e["img_embeds"].shape == (1, cfg.n_img_tokens, cfg.d_model)
               for e in extras)
    assert max(map(len, prompts)) + cfg.n_img_tokens + GEN_LEN \
        <= LLAVA_MAX_LEN
    totals = {name: 0 for name in ops.KERNELS}
    results, tokens = {}, {}
    runs = {"dense-slab": (kr.DENSE, None, {"dense_matmul"}),
            "s0.5-w8-slab": (kr.KratosSpec(sparsity=0.5, bits=8), None,
                             {"bsr_quant_matmul"}),
            "dense-paged": (kr.DENSE, 16, {"dense_matmul"})}
    for tag, (spec, page_size, gemms) in runs.items():
        draft = draft_spec_for("16c") if tag == "dense-slab" else None
        model, load_s, peak = load_peak(
            torch, lambda: load_cut(LLAVA, spec, params, cfg.n_layers,
                                    draft_spec=draft))
        ecfg = EngineConfig(n_slots=N_SLOTS, max_len=LLAVA_MAX_LEN,
                            decode_chunk=CHUNK, seed=SEED,
                            page_size=page_size)
        counts, res, eng, tokens[tag] = serve_run(
            torch, card, model, prompts, ecfg, gemms, tag, extras=extras)
        add_counts(totals, counts)
        assert counts["flash_attention"] == cfg.n_layers * len(prompts)
        if page_size:
            assert eng.pool.index is None and eng.pool.layout.has_paged
        res.update(load_s=load_s, load_peak_memory_allocated_gb=peak,
                   draft=None if draft is None else draft.tag,
                   admission_ms_image_plus_512=res["prefill_512_ms"])
        print(f"    {tag}: load {load_s:.1f} s, peak memory_allocated "
              f"{peak:.2f} GB"
              + ("" if draft is None else f" with the draft {draft.tag}")
              + f"; a {cfg.n_img_tokens} + 512-row admission prefill "
              f"{res['prefill_512_ms']:.1f} ms", flush=True)
        del eng
        gc.collect()
        res["eager_tokens_identical"] = eager_identity(
            torch, model, ecfg, prompts, GEN_LEN, tokens[tag], extras)
        if tag == "dense-paged":
            print("  dense paged against dense slab tokens:", flush=True)
            res["divergences"] = first_divergence(
                torch, model, prompts, tokens[tag], tokens["dense-slab"],
                extras)
        results[tag] = res
        if draft is not None:
            results["16c"] = run_spec_family(
                torch, card, mark, "16c", model, prompts, extras,
                (tokens[tag], res), (load_s, peak), totals)
        del model
        gc.collect()
    del params, extras
    gc.collect()
    torch.cuda.empty_cache()
    return totals, results


def whisper_traffic(cfg):
    """Phase 15's 16 requests from the seed: prompts of 4-224 tokens (the
    prompt limit) in the vocab, each with the audio stub's frames of its
    own 30 s waveform at 16 kHz, on the card."""
    from repro_torch.models import frontends as F
    rng = np.random.default_rng(SEED)
    lens = rng.integers(4, WHISPER_PROMPT + 1, 16)
    prompts = [rng.integers(0, cfg.vocab, int(s)).astype(np.int32)
               for s in lens]
    extras = [{"frames": F.whisper_frames(
        rng.standard_normal((1, WHISPER_SAMPLES)), cfg.d_model)}
        for _ in prompts]
    assert all(e["frames"].shape == (1, WHISPER_FRAMES, cfg.d_model)
               for e in extras)
    return prompts, extras


def cross_attention_ms(torch, eng):
    """Device ms of one decode micro-step's cross-attention alone: every
    decoder layer's, on n_slots query rows over its slots' cross leaves in
    the engine's pool, eager; the median of two traces. Split into the
    port's projection GEMMs (wq, wo), the library's GEMMs (the plain
    products of the queries with the enc_positions keys and values, as
    the JAX package's einsums) and the rest (softmax, masking, copies)."""
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    model, n = eng.model, eng.cfg.n_slots
    cfg = model.cfg
    caches = eng.pool.store if eng.backend.paged else eng.pool.caches
    ccfg = T.cross_cfg_for(cfg, T.layer_kind(cfg, 0))
    h = torch.randn((n, 1, cfg.d_model), device="cuda")
    index = torch.full((n,), 100, dtype=torch.int32, device="cuda")

    def step():
        for lp, c in zip(model.params["layers"], caches):
            A.gqa_apply(lp["cross"], h, ccfg, index=index,
                        cache={"k": c["cross_k"], "v": c["cross_v"]})
    step()
    torch.cuda.synchronize()
    calls = [trace_call(torch, step) for _ in range(2)]
    med = lambda f: statistics.median(f(c) for c in calls)
    return dict(
        device_ms=med(lambda c: c["busy_ms"]),
        projection_gemm_device_ms=med(gemm_ms),
        einsum_device_ms=med(
            lambda c: c["device_ms_by_kernel"].get("library_gemm", 0.0)),
        device_ops=med(lambda c: c["device_ops"]))


def admission_split(torch, eng, batch):
    """Wall ms (median of 3, each closed by a device sync) of one
    admission's prefill step and of two of its parts run alone: the
    encoder over the frames, and every decoder layer's cross k/v
    projections of the encoder output (m = enc_positions); the decoder's
    prefill is the rest, the cross k/v among it."""
    from repro_torch.core import kratos as kr
    from repro_torch.models import transformer as T
    model = eng.model
    cfg = model.cfg
    enc_out = T.encode(model.params, batch["frames"], cfg)
    whole = timed_ms(torch, lambda: eng.backend.prefill(batch, exact=True))
    enc = timed_ms(torch, lambda: T.encode(model.params, batch["frames"], cfg))
    kv = timed_ms(torch, lambda: [kr.apply(lp["cross"][w], enc_out)
                                  for lp in model.params["layers"]
                                  for w in ("wk", "wv")])
    return dict(admission_ms=whole, encoder_ms=enc, cross_kv_ms=kv,
                decoder_prefill_ms=whole - enc)


def phase_whisper(torch, card, mark):
    """whisper-large-v3 at its published width (32 encoder layers, the
    decoder's 32 cut to WHISPER_LAYERS; d_model 1280, 20/20 heads of 64,
    d_ff 5120 GELU not gated, vocab 51866 tied, LayerNorm, sinusoidal
    positions; 6.1 GB in f32 at full depth), random f32 weights from the
    seed: 16 requests, each with the
    audio stub's 1500 frames of a 30 s waveform and a 4-224-token prompt,
    32 new tokens, n_slots 8, max_len 448 (Whisper's n_text_ctx): dense and
    s0.5-w8 from the slab, dense from the page pool (the decoder's k/v
    paged, the cross k/v resident). Every admission runs the encoder (32
    non-causal flash launches over 1500 frames) and prefills at exact
    length (one causal launch a decoder layer); decode reads the cross leaves through the
    plain products, as the JAX package does."""
    from repro_torch import configs as C
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import EngineConfig

    cfg = C.get_config(WHISPER, n_layers=WHISPER_LAYERS)
    t0 = time.perf_counter()
    params = T.init(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"  init {WHISPER} full width, {cfg.n_enc_layers} + {cfg.n_layers}"
          " layers (f32): "
          f"{time.perf_counter() - t0:.1f} s, memory_allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    prompts, extras = whisper_traffic(cfg)
    assert max(map(len, prompts)) + GEN_LEN <= WHISPER_MAX_LEN
    totals = {name: 0 for name in ops.KERNELS}
    results, tokens = {}, {}
    runs = {"dense-slab": (kr.DENSE, None, {"dense_matmul"}),
            "s0.5-w8-slab": (kr.KratosSpec(sparsity=0.5, bits=8), None,
                             {"bsr_quant_matmul"}),
            "dense-paged": (kr.DENSE, 16, {"dense_matmul"})}
    r = lambda xs, d=3: [round(x, d) for x in xs]
    for tag, (spec, page_size, gemms) in runs.items():
        draft = draft_spec_for("16d") if tag == "dense-slab" else None
        model, load_s, peak = load_peak(
            torch, lambda: load_cut(WHISPER, spec, params, cfg.n_layers,
                                    draft_spec=draft))
        ecfg = EngineConfig(n_slots=N_SLOTS, max_len=WHISPER_MAX_LEN,
                            decode_chunk=CHUNK, seed=SEED,
                            page_size=page_size)
        counts, res, eng, tokens[tag] = serve_run(
            torch, card, model, prompts, ecfg, gemms, tag, extras=extras,
            prefill_len=WHISPER_PROMPT)
        add_counts(totals, counts)
        assert counts["flash_attention"] == \
            (cfg.n_enc_layers + cfg.n_layers) * len(prompts), counts
        assert eng._exact_prefill and eng._len_bounded
        if page_size:
            assert counts["paged_flash_attention"] > 0, counts
            assert eng.pool.index is None and all(
                paged == {"k": True, "v": True, "cross_k": False,
                          "cross_v": False}
                for paged in eng.pool.layout.paged)
        cross = cross_attention_ms(torch, eng)
        batch = {"tokens": torch.from_numpy(np.resize(
            prompts[0], (1, WHISPER_PROMPT)).astype(np.int32)).cuda(),
            **extras[0]}
        split = admission_split(torch, eng, batch)
        res.update(load_s=load_s, load_peak_memory_allocated_gb=peak,
                   draft=None if draft is None else draft.tag,
                   cross_attention_per_micro_step=cross,
                   admission_224=split)
        print(f"    {tag}: load {load_s:.1f} s, peak memory_allocated "
              f"{peak:.2f} GB"
              + ("" if draft is None else f" with the draft {draft.tag}")
              + "; cross-attention alone a micro-step: "
              f"{cross['device_ms']:.3f} device ms (projection GEMMs "
              f"{cross['projection_gemm_device_ms']:.3f}, einsums "
              f"{cross['einsum_device_ms']:.3f}, "
              f"{cross['device_ops']:.0f} ops); a 1500-frame + "
              f"{WHISPER_PROMPT}-token admission {split['admission_ms']:.1f} "
              f"ms wall = encoder {split['encoder_ms']:.1f} + decoder "
              f"prefill {split['decoder_prefill_ms']:.1f} (cross k/v "
              f"projections alone {split['cross_kv_ms']:.1f})", flush=True)
        del eng
        gc.collect()
        res["eager_tokens_identical"] = eager_identity(
            torch, model, ecfg, prompts, GEN_LEN, tokens[tag], extras)
        if tag == "dense-paged":
            print("  dense paged against dense slab tokens:", flush=True)
            res["divergences"] = first_divergence(
                torch, model, prompts, tokens[tag], tokens["dense-slab"],
                extras)
        results[tag] = res
        if draft is not None:
            results["16d"] = run_spec_family(
                torch, card, mark, "16d", model, prompts, extras,
                (tokens[tag], res), (load_s, peak), totals)
        del model
        gc.collect()
    del params, extras
    gc.collect()
    torch.cuda.empty_cache()
    return totals, results


# phase 18: tracing and telemetry on the dense h2o-danube-1.8b of phase 5
# (full width and depth), the router and chaos on phase 9's 8-layer tree;
# both on phase 5's first 8 requests (one wave), K 4
SERVE_REQUESTS = 8
PROFILE_DISPATCHES = 3
ROUTER_REPLICAS = 2
CRASH_STEP = 3


def profile_kernels(path):
    """The device kernels of a profiler bracket's Chrome trace by the
    port's kernel families: all of them, and those a CUDA graph replay
    launched (their correlation id is a cudaGraphLaunch's)."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    replays = {e["args"]["correlation"] for e in events
               if e.get("name") == "cudaGraphLaunch"
               and "correlation" in e.get("args", {})}
    every, in_graphs = {}, {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        fam = family(e["name"])
        every[fam] = every.get(fam, 0) + 1
        if e.get("args", {}).get("correlation") in replays:
            in_graphs[fam] = in_graphs.get(fam, 0) + 1
    return dict(graph_launches=len(replays), kernels=every,
                kernels_in_graph_replays=in_graphs)


def phase_tracing(torch, card, params, step_ms):
    """18a: tracing and telemetry on the dense slab engine of phase 5
    (h2o-danube-1.8b, full width and depth, K 4) over phase 5's first 8
    requests. Trace off and on in alternating turns (off, on with the
    torch.profiler bracket over the first 3 dispatches, on, off): tokens
    and launch counts equal, wall ms a decoded token each; the spans'
    step clocks against the report's; the median `decode` span against
    phase 5's graph wall ms a micro-step x K (`step_ms`); the profiler
    trace's kernels, the dense GEMV among those the graph replays
    launched. Then a traced paged engine (page 16: page events, gather
    bytes avoided) and a TelemetryExporter on an ephemeral port, scraped
    mid-run from 127.0.0.1."""
    import urllib.request
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import ops
    from repro_torch.serve import (EngineConfig, InferenceEngine,
                                   ModelRegistry, TelemetryConfig,
                                   TelemetryExporter, TraceConfig,
                                   engine_sample)
    t_phase = time.perf_counter()
    model = ModelRegistry().load(DANUBE, kr.DENSE, smoke=False,
                                 params=params, seed=SEED)
    prompts = serving_traffic(model.cfg.vocab)[:SERVE_REQUESTS]
    base = dict(n_slots=N_SLOTS, max_len=512 + GEN_LEN, decode_chunk=CHUNK,
                seed=SEED, device=model.device.type)
    profile_dir = ROOT / "chiprun_out" / "profile"
    totals = {name: 0 for name in ops.KERNELS}
    turns = (("off", None),
             ("on, profiled", TraceConfig(
                 profile_dir=str(profile_dir),
                 profile_dispatches=PROFILE_DISPATCHES)),
             ("on", TraceConfig()), ("off", None))
    runs = []
    for tag, trace in turns:
        eng, reqs, wall, counts, _ = serve_traffic(
            torch, model, prompts, EngineConfig(trace=trace, **base))
        add_counts(totals, counts)
        rep = eng.metrics.report()
        decoded = rep["tokens_generated"] - len(prompts)
        runs.append(dict(tag=tag, eng=eng, counts=counts, wall_s=wall,
                         tokens=[list(r.generated) for r in reqs],
                         ms_per_decoded_token=wall * 1e3 / decoded))
        assert all(r.done and len(r.generated) == GEN_LEN for r in reqs)
    for run in runs[1:]:
        assert run["tokens"] == runs[0]["tokens"], run["tag"]
        assert run["counts"] == runs[0]["counts"], (run["tag"],
                                                    run["counts"])
    traced = runs[1]["eng"]
    spans = traced.trace.request_spans()
    for rid, rec in traced.metrics.records.items():
        s = spans[rid]
        assert s["ttft_steps"] == rec.first_token_step - rec.arrival_step
        assert s["latency_steps"] == rec.finish_step - rec.arrival_step
    rep = traced.metrics.report()
    assert rep["latency_steps_p99"] == max(s["latency_steps"]
                                           for s in spans.values())
    evs = list(runs[2]["eng"].trace.events)
    decode_ms = [e["dur"] * 1e3 for e in evs if e["ev"] == "decode"]
    syncs = [e["bytes"] for e in evs if e["ev"] == "host_sync"
             and e["kind"] == "decode"]
    assert syncs == [4 * N_SLOTS * CHUNK] * len(decode_ms), syncs
    kinds = [e["ev"] for e in traced.trace.events]
    assert kinds.count("profile_start") == kinds.count("profile_stop") == 1
    prof = profile_kernels(traced.trace.profile_path)
    assert prof["kernels_in_graph_replays"].get("gemv_cluster_kernel", 0) \
        > 0, prof
    # the paged engine, traced
    eng, reqs, wall, counts, _ = serve_traffic(
        torch, model, prompts, EngineConfig(trace=TraceConfig(),
                                            page_size=16, **base))
    add_counts(totals, counts)
    paged_events = {k: sum(e["ev"] == k for e in eng.trace.events)
                    for k in ("page_alloc", "page_free", "gather_avoided")}
    assert all(paged_events.values()), paged_events
    paged_rep = eng.metrics.report()
    assert paged_rep["gather_bytes_avoided"] == \
        eng.backend.gather_bytes_per_dispatch() * paged_rep["decode_steps"] \
        > 0, paged_rep
    # live telemetry: a scrape mid-run
    jsonl = ROOT / "chiprun_out" / "telemetry.jsonl"
    jsonl.unlink(missing_ok=True)
    eng = InferenceEngine(model, EngineConfig(**base))
    exporter = TelemetryExporter(lambda: engine_sample(eng), TelemetryConfig(
        interval=0.05, port=0, jsonl=str(jsonl)))
    for p in prompts:
        eng.submit(p, GEN_LEN)
    exporter.start()
    try:
        for _ in range(6):
            eng.step()
        exporter.sample()
        url = f"http://127.0.0.1:{exporter.port}/metrics"
        body = urllib.request.urlopen(url, timeout=10).read().decode()
        eng.run()
    finally:
        exporter.stop()
    scraped = {line.split()[0]: float(line.split()[1])
               for line in body.splitlines() if line.startswith("serve_")}
    assert scraped.get("serve_tokens_generated", 0) > 0, body[:400]
    lines = jsonl.read_text().splitlines()
    assert len(lines) >= 2, len(lines)
    off = [r["ms_per_decoded_token"] for r in runs if r["tag"] == "off"]
    on = [r["ms_per_decoded_token"] for r in runs if r["tag"] != "off"]
    res = dict(
        turns=[r["tag"] for r in runs],
        wall_s=[r["wall_s"] for r in runs],
        ms_per_decoded_token=[r["ms_per_decoded_token"] for r in runs],
        tracing_cost_ms_per_decoded_token=runs[2]["ms_per_decoded_token"]
        - statistics.mean(off),
        decode_span_ms=decode_ms,
        decode_span_ms_median=statistics.median(decode_ms),
        graph_wall_ms_per_dispatch=step_ms * CHUNK,
        events=len(traced.trace.events), dropped=traced.trace.dropped,
        profile=prof, profile_path=str(traced.trace.profile_path),
        paged_gather_bytes_avoided=paged_rep["gather_bytes_avoided"],
        paged_events=paged_events,
        telemetry_lines=len(lines), telemetry_samples=exporter.n_samples,
        scraped_tokens_generated=scraped["serve_tokens_generated"],
        launches=runs[0]["counts"], seconds=time.perf_counter() - t_phase)
    r = lambda xs, d=3: [round(x, d) for x in xs]
    print(f"  [18a] trace off / on [{card}], turns {res['turns']}: wall ms / "
          f"decoded token {r(res['ms_per_decoded_token'])} (off "
          f"{r(off)}, on {r(on)}); tokens and launch counts equal "
          f"({runs[0]['counts']}); spans reconcile with the report over "
          f"{len(spans)} requests; {res['events']} events, "
          f"{res['dropped']} dropped", flush=True)
    print(f"    decode span median {res['decode_span_ms_median']:.3f} ms "
          f"({len(decode_ms)} dispatches, {r(sorted(decode_ms)[:3])} .. "
          f"{r(sorted(decode_ms)[-3:])}) against phase 5's graph wall "
          f"{step_ms:.3f} ms / micro-step x {CHUNK} = "
          f"{res['graph_wall_ms_per_dispatch']:.3f} ms", flush=True)
    print(f"    profiler bracket over {PROFILE_DISPATCHES} dispatches: "
          f"{prof['graph_launches']} graph launches; kernels by family "
          f"{prof['kernels']}; in graph replays "
          f"{prof['kernels_in_graph_replays']}", flush=True)
    print(f"    paged (page 16), traced: gather_bytes_avoided "
          f"{paged_rep['gather_bytes_avoided']:.0f} over "
          f"{paged_rep['decode_steps']:.0f} dispatches, page events "
          f"{res['paged_events']}; telemetry: scrape mid-run "
          f"serve_tokens_generated {scraped['serve_tokens_generated']:g}, "
          f"{len(lines)} JSONL lines, {exporter.n_samples} samples",
          flush=True)
    return totals, res


def phase_router(torch, card, params):
    """18b: the replica router and the chaos harness on phase 9's 8-layer
    h2o-danube-1.8b tree (full width, dense), 2 replicas of 4 slots, phase
    5's first 8 requests: a fault-free run; a crash of replica 1 at router
    step 3 with auto_restart (its tokens equal the fault-free run's; the
    restart's wall ms, engine build and graph capture; memory_allocated
    after it no more than half a replica above its level before the
    crash, so the dead replica's cache and graphs were freed); one
    nan_logits sync on replica 0 (tokens equal); a squeeze of every free
    page of replica 0 on a paged router (page 16) for 4 steps (admissions
    wait; the pools end pristine)."""
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import ops
    from repro_torch.serve import (ChaosHarness, EngineConfig, Fault,
                                   InferenceEngine, ReplicaRouter)
    t_phase = time.perf_counter()
    model = load_cut(DANUBE, kr.DENSE, params, QOS_LAYERS)
    prompts = serving_traffic(model.cfg.vocab)[:SERVE_REQUESTS]
    n_slots = SERVE_REQUESTS // ROUTER_REPLICAS
    ecfg = EngineConfig(n_slots=n_slots, max_len=512 + GEN_LEN,
                        decode_chunk=CHUNK, seed=SEED,
                        device=model.device.type)
    cuda = model.device.type == "cuda"
    mem = torch.cuda.memory_allocated if cuda else (lambda: 0)
    totals = {name: 0 for name in ops.KERNELS}

    def fleet(faults, cfg=ecfg, **kw):
        router = ReplicaRouter.build(model, cfg, ROUTER_REPLICAS, **kw)
        reqs = [router.submit(p, GEN_LEN) for p in prompts]
        harness = ChaosHarness(router, faults)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        harness.run()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        add_counts(totals, ops.launch_counts())
        assert all(r.done and len(r.generated) == GEN_LEN for r in reqs)
        return router, [list(r.generated) for r in reqs], wall, harness

    gc.collect()
    m0 = mem()
    one = InferenceEngine(model, ecfg)
    replica_bytes = mem() - m0
    del one
    gc.collect()
    clean, want, clean_wall, _ = fleet([])
    clean_rep = clean.report()
    del clean
    # the crash, stepped by hand around it for the memory reading
    router = ReplicaRouter.build(model, ecfg, ROUTER_REPLICAS,
                                 auto_restart=True)
    build_ms, factory = [], router.engine_factory

    def timed_factory(i):
        t = time.perf_counter()
        eng = factory(i)
        if cuda:
            torch.cuda.synchronize()
        build_ms.append((time.perf_counter() - t) * 1e3)
        return eng
    router.engine_factory = timed_factory
    reqs = [router.submit(p, GEN_LEN) for p in prompts]
    harness = ChaosHarness(router, [Fault(kind="crash", step=CRASH_STEP,
                                          replica=1)])
    ops.reset_launch_counts()
    while router.step_count < CRASH_STEP - 1:
        harness.step()
    if cuda:
        torch.cuda.synchronize()
    gc.collect()
    before = mem()
    harness.step()
    assert router.restarts == 1 and router.replica_deaths == 1
    if cuda:
        torch.cuda.synchronize()
    gc.collect()
    after = mem()
    harness.run()
    add_counts(totals, ops.launch_counts())
    crash_tokens = [list(r.generated) for r in reqs]
    crash_rep = router.report()
    assert crash_tokens == want, "crash run's tokens differ"
    if cuda:
        assert after - before < replica_bytes / 2, (before, after,
                                                    replica_bytes)
    del router, harness, reqs
    gc.collect()
    nan_router, nan_tokens, nan_wall, _ = fleet(
        [Fault(kind="nan_logits", step=CRASH_STEP, replica=0)])
    assert nan_router.replica_deaths == 1 and nan_tokens == want
    nan_rep = nan_router.report()
    del nan_router
    paged_cfg = dataclasses.replace(ecfg, page_size=16)
    # every free page of replica 0 taken for 4 router steps
    squeeze = Fault(kind="pool_squeeze", step=2, duration=4)
    sq_router, sq_tokens, sq_wall, _ = fleet([squeeze], cfg=paged_cfg)
    sq_rep = sq_router.report()
    assert sq_rep["pool_waits"] >= 1, sq_rep
    for eng in sq_router.replicas:
        pool = eng.pool
        if pool.index is not None:        # the tree's pages are its own
            assert pool.pages_in_use == pool.index.n_nodes
            pool.index.clear(pool._release)
        assert pool.n_active == 0 and int(pool.refs[1:].sum()) == 0 \
            and len(pool._free_pages) == pool.n_usable_pages
    del sq_router
    res = dict(
        replicas=ROUTER_REPLICAS, n_slots=n_slots, layers=QOS_LAYERS,
        replica_bytes=replica_bytes, clean_wall_s=clean_wall,
        clean_report={k: clean_rep[k] for k in (
            "tokens_per_router_step", "router_steps", "spills",
            "rebalanced", "tok_per_s")},
        restart_ms=build_ms, memory_before_crash=before,
        memory_after_restart=after,
        crash_report={k: crash_rep[k] for k in (
            "replica_deaths", "restarts", "failovers", "router_steps")},
        nan_wall_s=nan_wall, nan_failovers=nan_rep["failovers"],
        squeeze_wall_s=sq_wall, squeeze_pool_waits=sq_rep["pool_waits"],
        squeeze_tokens_equal=sq_tokens == want,
        seconds=time.perf_counter() - t_phase)
    print(f"  [18b] router, {ROUTER_REPLICAS} replicas of {n_slots} slots, "
          f"{QOS_LAYERS} layers [{card}]: fault-free {clean_wall:.2f} s, "
          f"{clean_rep['tokens_per_router_step']:.2f} tok / router step, "
          f"spills {clean_rep['spills']:.0f}, rebalanced "
          f"{clean_rep['rebalanced']:.0f}", flush=True)
    print(f"    crash of replica 1 at router step {CRASH_STEP}, auto_restart:"
          f" tokens identical; deaths {crash_rep['replica_deaths']:.0f}, "
          f"restarts {crash_rep['restarts']:.0f}, failovers "
          f"{crash_rep['failovers']:.0f}; restart (engine build + graph "
          f"capture) {[round(x, 1) for x in build_ms]} ms; memory_allocated "
          f"{before / 1e9:.3f} GB before the crash, {after / 1e9:.3f} GB "
          f"after the restart (one replica {replica_bytes / 1e9:.3f} GB)",
          flush=True)
    print(f"    nan_logits on replica 0: tokens identical, failovers "
          f"{nan_rep['failovers']:.0f}; pool squeeze (paged, every free page "
          f"of replica 0 for 4 steps): pool waits {sq_rep['pool_waits']:.0f}, pools pristine, "
          f"tokens {'equal to' if sq_tokens == want else 'differ from'} "
          "the slab's", flush=True)
    return totals, res


# phase 19: the serving surface. 19a alternates the two paged forms this
# many turns; 19b speculates on this many of phase 5's requests; 19c runs
# two waves on 4 slots; 19d gives the CLI subprocess this long
LEGACY_TURNS = 2
LEGACY_SPEC_REQUESTS = 4
STATIC_SLOTS = 4
CLI_TIMEOUT_S = 300


def timed_dispatches(torch, engines, per, turns=3, n=3):
    """Graph wall ms per micro-step of each engine's decode dispatch (slots
    parked), §5's method: `turns` alternating turns of `n` dispatches on
    every engine in turn, in this one process."""
    fns = {tag: eng.backend.decode_block for tag, eng in engines.items()}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    ms = {tag: [] for tag in fns}
    for _ in range(turns):
        for tag, fn in fns.items():
            t = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            ms[tag].append((time.perf_counter() - t) * 1e3 / (n * per))
    return ms


def phase_surface(torch, card, params):
    """19a, 19c and 19d, right after phase 18a, on phase 6's dense
    h2o-danube-1.8b (full width and depth) and phase 5's first 8 requests.
    19a: the legacy gather/scatter paged decode (paged_native=False)
    against the native one, page 16, K 4, n_slots 8, max_len 544, in
    alternating turns (legacy, native, legacy, native): tokens equal, the
    "gather" event stream (legacy: a gather and a scatter per capture,
    none per replay; native: none), paged_flash_attention launches (legacy
    0, native 24 a micro-step), gather_bytes_avoided, peak
    memory_allocated of each run, and graph wall ms a micro-step of the
    last turn's two engines in alternating turns. 19c: StaticScheduler
    against ContinuousScheduler on the slab, 4 slots (two waves), in
    alternating turns: tokens equal, dispatches, tokens a dispatch, tok/s.
    19d: `python -m repro_torch.launch.serve --full ...` in a subprocess,
    as a user starts it: exit 0, the `scheduler=static backend=local`
    report and a non-empty trace."""
    from repro_torch.core import kratos as kr
    from repro_torch.instrument import REGISTRY
    from repro_torch.kernels import ops
    from repro_torch.serve import (EngineConfig, InferenceEngine,
                                   ModelRegistry, StaticScheduler)
    t_phase = time.perf_counter()
    model = ModelRegistry().load(DANUBE, kr.DENSE, smoke=False,
                                 params=params, seed=SEED)
    prompts = serving_traffic(model.cfg.vocab)[:SERVE_REQUESTS]
    layers = model.cfg.n_layers
    totals = {name: 0 for name in ops.KERNELS}
    base = dict(n_slots=N_SLOTS, max_len=512 + GEN_LEN, decode_chunk=CHUNK,
                seed=SEED, page_size=16)
    # ---- 19a: legacy against native paged decode ----------------------
    runs, engines = [], {}
    for turn in range(LEGACY_TURNS):
        for native in (False, True):
            tag = "native" if native else "legacy"
            engines.pop(tag, None)
            gc.collect()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with REGISTRY.scoped("gather") as ev:
                eng, reqs, wall, counts, _ = serve_traffic(
                    torch, model, prompts,
                    EngineConfig(paged_native=native, **base))
                events = [e[0] for e in ev["gather"]]
            peak = torch.cuda.max_memory_allocated()
            add_counts(totals, counts)
            rep = eng.metrics.report()
            assert all(r.done and len(r.generated) == GEN_LEN for r in reqs)
            view = eng.pool.layout.slab_view_bytes()
            if native:
                assert not events, events
                assert counts["paged_flash_attention"] \
                    == layers * rep["micro_steps"], counts
                assert rep["gather_bytes_avoided"] \
                    == 2 * view * rep["decode_steps"] > 0, rep
            else:
                # one gather and one scatter in the warm-up and the capture
                assert events == ["gather", "scatter"] * 2, events
                assert counts["paged_flash_attention"] == 0, counts
                assert rep["gather_bytes_avoided"] == 0.0, rep
            assert counts["dense_matmul"] > 0 and counts["flash_attention"] \
                > 0, counts
            engines[tag] = eng
            runs.append(dict(
                form=tag, turn=turn, wall_s=wall,
                tok_per_s=rep["tokens_generated"] / wall,
                decode_steps=rep["decode_steps"],
                micro_steps=rep["micro_steps"],
                gather_events=len(events),
                gather_bytes_avoided=rep["gather_bytes_avoided"],
                slab_view_bytes=view, memory_before=before,
                peak_memory_allocated=peak, launches=counts,
                tokens=[list(r.generated) for r in reqs]))
    for run in runs[1:]:
        assert run["tokens"] == runs[0]["tokens"], (run["form"],
                                                    run["turn"])
    with REGISTRY.scoped("gather") as ev:
        step_ms = timed_dispatches(torch, engines, CHUNK)
        assert not ev["gather"], "a graph replay appended a gather event"
    del engines, eng
    gc.collect()
    torch.cuda.empty_cache()
    legacy = dict(
        runs=[{k: v for k, v in r.items() if k != "tokens"} for r in runs],
        micro_step_ms=step_ms,
        micro_step_ms_median={t: statistics.median(v)
                              for t, v in step_ms.items()})
    r = lambda xs, d=3: [round(x, d) for x in xs]
    for run in runs:
        print(f"  [19a] {run['form']:6s} paged, turn {run['turn']} [{card}]: "
              f"tok/s {run['tok_per_s']:.1f}, dispatches "
              f"{run['decode_steps']:.0f}, gather events "
              f"{run['gather_events']}, paged_flash_attention launches "
              f"{run['launches']['paged_flash_attention']}, "
              f"gather_bytes_avoided {run['gather_bytes_avoided']:.0f} "
              f"(slab view {run['slab_view_bytes']} B a direction), peak "
              f"memory_allocated {run['peak_memory_allocated'] / 1e9:.3f} "
              f"GB ({(run['peak_memory_allocated'] - run['memory_before']) / 1e9:.3f} "
              f"GB over the {run['memory_before'] / 1e9:.3f} GB before the "
              "build)", flush=True)
    print(f"    legacy against native tokens over {len(prompts)} requests "
          f"and {len(runs)} runs: identical; graph wall ms / micro-step in "
          f"alternating turns: legacy {r(step_ms['legacy'])} (median "
          f"{legacy['micro_step_ms_median']['legacy']:.3f}), native "
          f"{r(step_ms['native'])} (median "
          f"{legacy['micro_step_ms_median']['native']:.3f}); no gather "
          "event in the replays", flush=True)
    # ---- 19c: static against continuous admission ---------------------
    admission = []
    slab = dict(n_slots=STATIC_SLOTS, max_len=512 + GEN_LEN,
                decode_chunk=CHUNK, seed=SEED)
    for tag in ("continuous", "static", "static", "continuous"):
        eng = InferenceEngine(model, EngineConfig(**slab),
                              scheduler=StaticScheduler()
                              if tag == "static" else None)
        eng, reqs, wall, counts, _ = serve_traffic(torch, model, prompts,
                                                   None, eng=eng)
        add_counts(totals, counts)
        rep = eng.metrics.report()
        assert eng.scheduler.name == tag
        admission.append(dict(
            scheduler=tag, wall_s=wall,
            tok_per_s=rep["tokens_generated"] / wall,
            decode_steps=rep["decode_steps"],
            tokens_per_dispatch=rep["tokens_per_step"],
            mean_occupancy=rep["mean_occupancy"],
            latency_s_p50=rep["latency_s_p50"],
            latency_s_p99=rep["latency_s_p99"],
            tokens=[list(r.generated) for r in reqs]))
        del eng
        gc.collect()
    for run in admission[1:]:
        assert run["tokens"] == admission[0]["tokens"], run["scheduler"]
    for run in admission:
        print(f"  [19c] {run['scheduler']:10s} [{card}] slab, "
              f"{STATIC_SLOTS} slots: dispatches {run['decode_steps']:.0f}, "
              f"tokens / dispatch {run['tokens_per_dispatch']:.3f}, "
              f"occupancy {run['mean_occupancy']:.3f}, tok/s "
              f"{run['tok_per_s']:.1f}, p50 / p99 "
              f"{run['latency_s_p50']:.3f} / {run['latency_s_p99']:.3f} s",
              flush=True)
    print("    static against continuous tokens: identical", flush=True)
    # ---- 19d: the CLI as users start it ---------------------------------
    trace = ROOT / "chiprun_out" / "cli_trace.jsonl"
    trace.parent.mkdir(exist_ok=True)
    trace.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--full",
           "--arch", DANUBE, "--requests", "8", "--prompt-len", "128",
           "--gen", "32", "--slots", "4", "--decode-chunk", "4",
           "--page-size", "16", "--static", "--trace-out", str(trace)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=CLI_TIMEOUT_S)
    cli_s = time.perf_counter() - t0
    print(f"  [19d] {' '.join(cmd[1:])}: exit {proc.returncode} in "
          f"{cli_s:.1f} s", flush=True)
    for line in proc.stdout.splitlines():
        print(f"    | {line}", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"the CLI exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    assert "scheduler=static backend=local" in proc.stdout, proc.stdout
    assert trace.stat().st_size > 0, trace
    res = dict(
        legacy=legacy,
        admission=[{k: v for k, v in a.items() if k != "tokens"}
                   for a in admission],
        cli=dict(cmd=cmd[1:], returncode=proc.returncode, seconds=cli_s,
                 stdout=proc.stdout, trace_bytes=trace.stat().st_size),
        seconds=time.perf_counter() - t_phase)
    return totals, res


def phase_legacy_spec(torch, card, params):
    """19b, right after phase 18b, on phase 9's 8-layer h2o-danube-1.8b
    tree: the dense target with its s0.5 x int8 draft, K 4, page 16,
    phase 5's first 4 requests, native then legacy paged: the legacy
    tokens equal the native ones, paged_flash_attention runs only in the
    native cycle (one verify block a layer a cycle), and the legacy form
    appends its gather and scatter per capture."""
    from repro_torch.core import kratos as kr
    from repro_torch.instrument import REGISTRY
    from repro_torch.kernels import ops
    from repro_torch.serve import DraftSpec, EngineConfig
    t_phase = time.perf_counter()
    model = load_cut(DANUBE, kr.DENSE, params, QOS_LAYERS,
                     draft_spec=DraftSpec(bits=8, sparsity=0.5))
    prompts = serving_traffic(model.cfg.vocab)[:LEGACY_SPEC_REQUESTS]
    totals = {name: 0 for name in ops.KERNELS}
    out = {}
    for native in (True, False):
        with REGISTRY.scoped("gather") as ev:
            eng, reqs, wall, counts, _ = serve_traffic(
                torch, model, prompts, EngineConfig(
                    n_slots=N_SLOTS, max_len=512 + GEN_LEN, seed=SEED,
                    speculate=4, page_size=16, paged_native=native))
            events = [e[0] for e in ev["gather"]]
        add_counts(totals, counts)
        rep = eng.metrics.report()
        assert all(r.done and len(r.generated) == GEN_LEN for r in reqs)
        if native:
            assert not events and counts["paged_flash_attention"] \
                == QOS_LAYERS * rep["spec_dispatches"], (events, counts)
        else:
            assert events == ["gather", "scatter"] * 2, events
            assert counts["paged_flash_attention"] == 0, counts
        out["native" if native else "legacy"] = dict(
            wall_s=wall, spec_dispatches=rep["spec_dispatches"],
            acceptance_rate=rep["acceptance_rate"], gather_events=len(events),
            launches=counts, tokens=[list(r.generated) for r in reqs])
        del eng
        gc.collect()
    assert out["legacy"]["tokens"] == out["native"]["tokens"]
    print(f"  [19b] speculative paged, {QOS_LAYERS} layers, draft s0.5-w8, "
          f"K 4, {len(prompts)} requests [{card}]: legacy against native "
          f"tokens identical; cycles legacy "
          f"{out['legacy']['spec_dispatches']:.0f} native "
          f"{out['native']['spec_dispatches']:.0f}; acceptance "
          f"{out['legacy']['acceptance_rate']:.4f}; paged_flash_attention "
          f"launches legacy {out['legacy']['launches']['paged_flash_attention']}"
          f" native {out['native']['launches']['paged_flash_attention']}; "
          f"gather events legacy {out['legacy']['gather_events']} native "
          f"{out['native']['gather_events']}; wall legacy "
          f"{out['legacy']['wall_s']:.2f} s native "
          f"{out['native']['wall_s']:.2f} s", flush=True)
    for v in out.values():
        del v["tokens"]
    out["seconds"] = time.perf_counter() - t_phase
    return totals, out


FLEET_PROCESSES = 2
FLEET_SLOTS = 4
# step-clock horizons of the in-process fleet (one coordinator step is one
# pump of each process: an engine step, at most one K-step dispatch)
FLEET_HEARTBEAT_TIMEOUT = 6.0
FLEET_CLI_REQUESTS = 12
FLEET_CLI_TIMEOUT_S = 240


def report_parting(torch, model, prompt, got, want):
    """Where a fleet's greedy stream parts from the engine's: the first
    differing step and both candidates' logits there, recomputed on the
    card over the common prefix."""
    from repro_torch.models import transformer as T
    j = next(j for j, (x, y) in enumerate(zip(got, want)) if x != y)
    seq = np.concatenate([prompt, np.asarray(want[:j], np.int32)])
    caches = T.make_caches(model.cfg, 1, len(seq), torch.float32, "cuda")
    logits, _ = T.forward(model.params, torch.from_numpy(seq[None]).cuda(),
                          model.cfg, caches=caches, last_only=True)
    row = logits[0, -1].float()
    return (f"step {j}: fleet token {got[j]} (logit {float(row[got[j]]):.6f})"
            f" against the engine's {want[j]} (logit "
            f"{float(row[want[j]]):.6f})")


def phase_fleet(torch, card, params):
    """20a and 20b, right after phase 19d, on phase 6's dense h2o-danube-1.8b
    (full width and depth). 20a, in process: a FleetRouter over 2
    LocalProcess handles, each a one-replica ReplicaRouter (4 slots, K 4,
    max_len 544), phase 5's first 8 requests: the tokens equal one engine's
    on the same requests and both processes serve; then the same traffic
    with process 1 killed once a request of its own has tokens: the
    heartbeat-timeout failover re-prefills its requests on process 0
    (fleet_failovers >= 1, processes_dead 1), the tokens still equal, and
    a zombie status from the dead process is counted in
    resurrections_ignored. dense_matmul and flash_attention launch in both
    runs; tokens a fleet step and wall s each. 20b, as a user starts it:
    `python -m repro_torch.launch.fleet --device cuda --full --processes 2
    --requests 12 --inject-death` in a subprocess (a coordinator and 2
    worker processes, each with its own copy of the weights on the card):
    exit 0 means its fleet's tokens equal its own engine's across one
    killed worker. Before it the phase frees what it holds and requires
    3 x the model's bytes free on the card."""
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import ops
    from repro_torch.serve import (EngineConfig, FleetConfig, FleetRouter,
                                   LocalProcess, ModelRegistry, ProcessStatus,
                                   ReplicaRouter)
    from repro_torch.serve.registry import _leaves
    t_phase = time.perf_counter()
    model = ModelRegistry().load(DANUBE, kr.DENSE, smoke=False,
                                 params=params, seed=SEED)
    prompts = serving_traffic(model.cfg.vocab)[:SERVE_REQUESTS]
    ecfg = EngineConfig(n_slots=FLEET_SLOTS, max_len=512 + GEN_LEN,
                        decode_chunk=CHUNK, seed=SEED)
    totals = {name: 0 for name in ops.KERNELS}
    eng, reqs, one_wall, counts, _ = serve_traffic(torch, model, prompts,
                                                   ecfg)
    add_counts(totals, counts)
    want = [list(r.generated) for r in reqs]
    del eng, reqs
    gc.collect()
    # ---- 20a: the fleet in process -------------------------------------
    fcfg = FleetConfig(heartbeat_every=1, staleness=4.0,
                       heartbeat_timeout=FLEET_HEARTBEAT_TIMEOUT)
    runs = {}
    for tag in ("clean", "death"):
        procs = [LocalProcess(ReplicaRouter.build(model, ecfg, 1),
                              process_index=i, cfg=fcfg)
                 for i in range(FLEET_PROCESSES)]
        fleet = FleetRouter(procs, cfg=fcfg)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        reqs = [fleet.submit(p, GEN_LEN) for p in prompts]
        killed_at = None
        if tag == "death":
            while not any(r.process == 1 and not r.finished and r.tokens
                          for r in reqs):
                assert fleet.step_count < 200, "process 1 never had tokens"
                fleet.step()
            killed_at = fleet.step_count
            procs[1].kill()
        fleet.run()
        fleet.stop()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        add_counts(totals, counts)
        got = [list(r.tokens) for r in reqs]
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                raise AssertionError(
                    f"20a {tag}: request {i} parts from the engine at "
                    + report_parting(torch, model, prompts[i], g, w))
        rep = fleet.report()
        assert {r.process for r in reqs} == set(range(FLEET_PROCESSES)) \
            or tag == "death", [r.process for r in reqs]
        assert counts["dense_matmul"] > 0 and counts["flash_attention"] > 0, \
            counts
        if tag == "death":
            assert rep["fleet_failovers"] >= 1 and rep["processes_dead"] == 1
            assert rep["failovers"] == rep["fleet_failovers"], rep
            zombie = ProcessStatus(
                process_index=1, seq=10_000, step=0, replica_loads=[0],
                n_free_slots=FLEET_SLOTS, n_waiting=0, page_occupancy=0.0,
                qos_tier=0, submits_seen=0,
                progress={str(reqs[0].rid): [1, 2, 3]})
            before = fleet.state.resurrections_ignored
            fleet._handle(1, zombie.to_wire())
            assert [list(r.tokens) for r in reqs] == got
            assert fleet.state.resurrections_ignored == before + 1
            rep = fleet.report()
        else:
            assert rep["fleet_failovers"] == 0 and rep["processes_dead"] == 0
        runs[tag] = dict(
            wall_s=wall, killed_at_step=killed_at, launches=counts,
            served_by=[r.process for r in reqs],
            **{k: rep[k] for k in (
                "fleet_steps", "fleet_tokens", "tokens_per_fleet_step",
                "fleet_failovers", "processes_dead", "resurrections_ignored",
                "stale_skips", "failovers", "tokens_generated")})
        print(f"  [20a] {tag:5s} [{card}] {FLEET_PROCESSES} LocalProcess x 1 "
              f"replica, {FLEET_SLOTS} slots, K {CHUNK}, {len(prompts)} "
              f"requests: tokens equal one engine's; served by "
              f"{runs[tag]['served_by']}"
              + (f"; process 1 killed at fleet step {killed_at}"
                 if killed_at else "")
              + f"; fleet steps {rep['fleet_steps']:.0f}, tokens / fleet "
              f"step {rep['tokens_per_fleet_step']:.3f}, failovers "
              f"{rep['fleet_failovers']:.0f}, dead "
              f"{rep['processes_dead']:.0f}, resurrections ignored "
              f"{rep['resurrections_ignored']:.0f}; wall {wall:.2f} s (one "
              f"engine {one_wall:.2f} s); launches dense_matmul "
              f"{counts['dense_matmul']}, flash_attention "
              f"{counts['flash_attention']}", flush=True)
        del fleet, procs, reqs
        gc.collect()
    # ---- 20b: the launcher, as users start it ---------------------------
    n_bytes = nbytes(*_leaves(params, lambda n: isinstance(n, torch.Tensor)))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"  [20b] card memory before the fleet: {free / 1e9:.2f} GB free "
          f"of {total / 1e9:.2f} GB; the model holds {n_bytes / 1e9:.2f} GB",
          flush=True)
    if free < 3 * n_bytes:
        raise RuntimeError(
            f"20b needs 3 x {n_bytes / 1e9:.2f} GB free on the card (a "
            "coordinator and two workers, each with its own copy of the "
            f"weights) and {free / 1e9:.2f} GB are free")
    out = ROOT / "chiprun_out" / "fleet.json"
    out.parent.mkdir(exist_ok=True)
    out.unlink(missing_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.fleet", "--device",
           "cuda", "--full", "--processes", str(FLEET_PROCESSES),
           "--requests", str(FLEET_CLI_REQUESTS), "--inject-death", "--out",
           str(out)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=FLEET_CLI_TIMEOUT_S)
    cli_s = time.perf_counter() - t0
    print(f"  [20b] {' '.join(cmd[1:])}: exit {proc.returncode} in "
          f"{cli_s:.1f} s", flush=True)
    for line in proc.stdout.splitlines():
        print(f"    | {line}", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"the fleet launcher exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    res = json.loads(out.read_text())
    rep = res["report"]
    fleet_keys = {k: rep[k] for k in (
        "n_processes", "processes_dead", "fleet_steps", "fleet_tokens",
        "fleet_requests_completed", "tokens_per_fleet_step",
        "fleet_failovers", "fleet_overflowed", "resurrections_ignored",
        "stale_skips")}
    print(f"  [20b] report: {json.dumps(fleet_keys)}", flush=True)
    assert res["identical"] and rep["processes_dead"] == 1 \
        and rep["fleet_failovers"] >= 1, fleet_keys
    assert rep["fleet_requests_completed"] == FLEET_CLI_REQUESTS, fleet_keys
    return totals, dict(
        one_engine_wall_s=one_wall, runs=runs,
        cli=dict(cmd=cmd[1:], returncode=proc.returncode, seconds=cli_s,
                 stdout=proc.stdout, free_bytes_before=free,
                 model_bytes=n_bytes, report=fleet_keys),
        seconds=time.perf_counter() - t_phase)


# phase 21: training. 21a trains phase 6's full h2o-danube in place, 5
# steps of 4 x 256 markov tokens (lr 1e-3, warmup 5); 21b a full-width
# 1-layer copy under phase 5's s0.5-w8 spec (bk = bn = 128)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 5, 4, 256
QAT_STEPS, QAT_CRASH_AT, QAT_CKPT_EVERY, QAT_PROMPTS = 4, 3, 2, 4
# the hand-off's max |logit difference|, packed on the kernels against the
# training-time forward: f32 kernels against plain products, and a few
# int8 codes at a rounding tie that packing's exact scale and the
# fake-quant's FMA scale round apart
HANDOFF_LOGIT_TOL = 1e-3


def train_batches(torch, cfg, steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    from repro_torch.data import DataConfig, make_pipeline
    pipe = make_pipeline(DataConfig(vocab=cfg.vocab, batch=batch, seq=seq,
                                    seed=SEED))
    return [{k: torch.from_numpy(v).cuda() for k, v in pipe.batch(s).items()}
            for s in steps]


def pruned_blocks_zero(torch, params, spec):
    """(projections checked, all pruned blocks exactly zero)."""
    from repro_torch.core import kratos as kr
    from repro_torch.core import sparsity as sp
    n, ok = 0, True
    for lp in params["layers"]:
        for node in (lp["mixer"], lp["ffn"]):
            for leaf in node.values():
                plan = kr.plan_for(*leaf["w"].shape, spec)
                mask = torch.as_tensor(sp.plan_mask(plan), device="cuda")
                ok &= bool((leaf["w"][mask == 0] == 0).all())
                n += 1
    return n, ok


def code_flips(torch, params, spec):
    """(int8 codes on which packing's scale (exact division) and the
    training forward's fake-quant scale (one FMA, as jax.jit computes it)
    disagree, codes compared) over every projection of `params`."""
    from repro_torch.core import quantize as qz
    flips = total = 0
    for lp in params["layers"]:
        for node in (lp["mixer"], lp["ffn"]):
            for leaf in node.values():
                w = leaf["w"]
                a = qz.quantize_values(w, qz.compute_scale(w, spec.bits),
                                       spec.bits)
                b = qz.quantize_values(
                    w, qz.compute_scale(w, spec.bits, jitted=True), spec.bits)
                flips += int((a != b).sum())
                total += a.numel()
    return flips, total


def phase_train(torch, card, params):
    """21a and 21b (see the docstring at the top). No hand-written kernel
    runs in a train step: the launch counts stay 0 across 21a's steps."""
    import shutil
    import tempfile
    from repro_torch import configs as C
    from repro_torch import tree as tu
    from repro_torch.checkpoint import manager as CM
    from repro_torch.core import kratos as kr
    from repro_torch.data import DataConfig
    from repro_torch.distributed import steps as ST
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw as O
    from repro_torch.serve.registry import pack_model_params
    from repro_torch.train import (SimulatedFailure, TrainLoopConfig,
                                   run_training)

    t_phase = time.perf_counter()
    out = {}
    # ---- 21a: full width and depth, dense, in place ----------------------
    cfg = C.get_config(DANUBE)
    opt = O.OptimizerConfig(lr=1e-3, warmup_steps=TRAIN_STEPS,
                            total_steps=TRAIN_STEPS)
    n_params = sum(t.numel() for t in tu.leaves(params))
    state = {"params": params, "opt": O.adamw_init(params, opt),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    step_fn = ST.make_train_step(cfg, opt)
    batches = train_batches(torch, cfg, range(TRAIN_STEPS))
    torch.cuda.synchronize()
    print(f"  [21a] {DANUBE}: {n_params / 1e9:.3f} B params, remat "
          f"{cfg.remat} ({cfg.remat_policy}), memory_allocated with AdamW "
          f"state {torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    ops.reset_launch_counts()
    steps = []
    for i, b in enumerate(batches):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step_fn(state, b)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        rec = dict(step=i + 1, loss=float(m["loss"]),
                   grad_norm=float(m["grad_norm"]), lr=float(m["lr"]),
                   wall_ms=ms,
                   tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches=counts)
        steps.append(rec)
        print(f"  [21a] step {i + 1}: loss {rec['loss']:.4f}, grad_norm "
              f"{rec['grad_norm']:.4f}, {ms:.1f} ms, "
              f"{rec['tokens_per_s']:.0f} training tokens/s, peak "
              f"{rec['peak_gb']:.2f} GB, kernel launches {counts}",
              flush=True)
        assert not counts, f"a train step launched hand-written kernels: " \
            f"{counts}"
    losses = [r["loss"] for r in steps]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    out["21a"] = dict(n_params=n_params, steps=steps)
    del state, step_fn, batches
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 21b: full width, 1 layer, s0.5-w8 -------------------------------
    spec = kr.KratosSpec(sparsity=0.5, bits=8)
    qcfg = dataclasses.replace(C.get_config(DANUBE), n_layers=1, kratos=spec)
    qopt = O.OptimizerConfig(lr=1e-3, warmup_steps=QAT_STEPS,
                             total_steps=QAT_STEPS)
    b0 = train_batches(torch, qcfg, [0])[0]
    # (i) grad_accum 2 against 1 on one batch (lr 0: the step leaves the
    # parameters as they are)
    st = ST.init_train_state(SEED, qcfg, qopt, device="cuda")
    still = O.OptimizerConfig(lr=0.0, weight_decay=0.0, clip_norm=None)
    acc = {}
    for ga in (1, 2):
        _, m = ST.make_train_step(qcfg, still, grad_accum=ga)(st, b0)
        acc[ga] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
    rel = {k: abs(acc[2][k] - acc[1][k]) / abs(acc[1][k]) for k in acc[1]}
    print(f"  [21b] {DANUBE} 1 layer {kr.spec_tag(spec)}: grad_accum 2 "
          f"against 1: loss {acc[2]['loss']:.6f} / {acc[1]['loss']:.6f}, "
          f"grad_norm {acc[2]['grad_norm']:.6f} / {acc[1]['grad_norm']:.6f}"
          f" (relative {rel['loss']:.2e}, {rel['grad_norm']:.2e})",
          flush=True)
    assert max(rel.values()) <= 1e-5, rel
    # (ii) 4 steps: every pruned block stays exactly zero
    st = ST.init_train_state(SEED, qcfg, qopt, device="cuda")
    step_fn = ST.make_train_step(qcfg, qopt)
    qat_losses = []
    for b in train_batches(torch, qcfg, range(QAT_STEPS)):
        st, m = step_fn(st, b)
        qat_losses.append(float(m["loss"]))
    n_proj, zero = pruned_blocks_zero(torch, st["params"], spec)
    print(f"  [21b] {QAT_STEPS} QAT steps: losses "
          f"{[round(v, 4) for v in qat_losses]}; pruned blocks of "
          f"{n_proj} projections exactly zero: {zero}", flush=True)
    assert zero and all(np.isfinite(qat_losses)), qat_losses
    # (iii) crash at step 3 (after the async checkpoint at 2), resume to 4
    data = DataConfig(vocab=qcfg.vocab, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                      seed=SEED)
    tmp = Path(tempfile.mkdtemp(prefix="train-ckpt-", dir=ROOT / "build"))
    loop = dict(steps=QAT_STEPS, ckpt_every=QAT_CKPT_EVERY, log_every=0,
                async_checkpoint=True)

    # the checkpoint's wall ms, read off the loop's own calls: the npz
    # write (on the async writer's thread), the snapshot the save call
    # blocks for, the restore
    ckpt_ms = {"write": [], "snapshot": [], "restore": []}

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                ckpt_ms[name].append((time.perf_counter() - t0) * 1e3)
        return run

    def crash_resume(tag):
        ref = run_training(qcfg, qopt, data, TrainLoopConfig(**loop),
                           device="cuda")["history"]
        d = tmp / tag
        try:
            run_training(qcfg, qopt, data, TrainLoopConfig(
                **loop, ckpt_dir=str(d), fail_at_step=QAT_CRASH_AT),
                device="cuda")
            raise AssertionError("the injected failure did not fire")
        except SimulatedFailure:
            pass
        res = run_training(qcfg, qopt, data, TrainLoopConfig(
            **loop, ckpt_dir=str(d)), device="cuda")
        assert res["resumed_from"] == QAT_CKPT_EVERY, res["resumed_from"]
        want = [h["loss"] for h in ref[QAT_CKPT_EVERY:]]
        got = [h["loss"] for h in res["history"]]
        n_bytes = (d / f"step-{QAT_STEPS}" / "arrays.npz").stat().st_size
        return want, got, n_bytes

    patched = {"save_pytree": CM.save_pytree,
               "save_train_state": CM.save_train_state,
               "restore_train_state": CM.restore_train_state}
    CM.save_pytree = timed("write", CM.save_pytree)
    CM.save_train_state = timed("snapshot", CM.save_train_state)
    CM.restore_train_state = timed("restore", CM.restore_train_state)
    # without it the embedding's and the block gather's backward add with
    # atomics, and the resumed losses part from the uninterrupted ones in
    # the last bits
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        want, got, n_bytes = crash_resume("run")
        torch.use_deterministic_algorithms(False)
        for name, fn in patched.items():
            setattr(CM, name, fn)
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        bitwise = got == want
        print(f"  [21b] crash at step {QAT_CRASH_AT}, resumed from "
              f"{QAT_CKPT_EVERY}, under use_deterministic_algorithms: "
              f"losses of steps {QAT_CKPT_EVERY + 1}-{QAT_STEPS} {got} "
              f"against uninterrupted {want} (relative {rel:.2e}; bitwise "
              f"{bitwise})", flush=True)
        assert bitwise and rel <= 1e-6, (got, want)
        print(f"  [21b] checkpoint {n_bytes / 1e9:.3f} GB: async save's "
              f"snapshot {[round(v) for v in ckpt_ms['snapshot']]} ms, its "
              f"npz write {[round(v) for v in ckpt_ms['write']]} ms, "
              f"restore {[round(v) for v in ckpt_ms['restore']]} ms",
              flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
        for name, fn in patched.items():
            setattr(CM, name, fn)
        shutil.rmtree(tmp, ignore_errors=True)
    out["21b"] = dict(grad_accum=acc, qat_losses=qat_losses,
                      pruned_zero_projections=n_proj,
                      resume=dict(want=want, got=got, rel=rel,
                                  bitwise=bitwise, deterministic=True),
                      ckpt_bytes=n_bytes, ckpt_ms=ckpt_ms)
    # (iv) the hand-off to serving: the trained tree packed, phase 5's first
    # prompts prefilled on the kernels, against the training-time forward
    trained = st["params"]
    prompts = serving_traffic()[:QAT_PROMPTS]
    packed, n_packed = pack_model_params(trained, spec)
    prefill = ST.make_prefill_step(qcfg, last_only=False,
                                   cache_len=max(map(len, prompts)),
                                   device="cuda")
    ops.reset_launch_counts()
    served = []
    with torch.no_grad():
        for p in prompts:
            logits, _ = prefill(packed, {"tokens": torch.from_numpy(
                p[None]).cuda()})
            served.append(logits[0])
    counts = ops.launch_counts()
    diffs, parts = [], []
    with torch.no_grad(), ops.reference_path():
        for i, (p, got) in enumerate(zip(prompts, served)):
            want, _ = T.forward(trained, torch.from_numpy(p[None]).cuda(),
                                qcfg)
            want = want[0]
            diffs.append(float((got - want).abs().max()))
            a, b = int(got[-1].argmax()), int(want[-1].argmax())
            if a != b:
                top = torch.topk(want[-1], 2).values
                gap = float(top[0] - top[1])
                parts.append(dict(request=i, top2_gap=gap))
                assert gap < TOP2_GAP, (i, a, b, gap)
    shown = {k: counts[k] for k in ("bsr_quant_matmul", "flash_attention",
                                    "dense_matmul")}
    flips, n_codes = code_flips(torch, trained, spec)
    print(f"  [21b] hand-off: {n_packed} packed projections, {QAT_PROMPTS} "
          f"prompts of {[len(p) for p in prompts]} tokens prefilled on the "
          f"kernels against the training-time forward: max |logit diff| "
          f"{max(diffs):.3g} (limit {HANDOFF_LOGIT_TOL:g}; per prompt "
          f"{[float(f'{d:.3g}') for d in diffs]}), int8 codes packing and "
          f"the fake-quant round apart {flips} of {n_codes}, last-position "
          "argmax " + ("equal" if not parts else f"parts at near-ties {parts}")
          + f"; launches {shown}", flush=True)
    assert counts["bsr_quant_matmul"] > 0 and counts["flash_attention"] > 0
    assert max(diffs) <= HANDOFF_LOGIT_TOL, diffs
    out["21b"]["handoff"] = dict(max_abs_logit_diff=max(diffs),
                                 per_prompt=diffs, parts=parts,
                                 code_flips=flips, codes=n_codes,
                                 launches=shown, n_packed=n_packed)
    del st, trained, packed, served
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return counts, out


# phase 23: the examples. Each name, the arguments its main takes after
# --device cuda (--full: h2o-danube-1.8b at its published width and depth,
# on phase 6's dense tree), and the kernels its run must launch (training
# runs on the reference path: none)
SWEEP_STEPS = 5                        # of sparsity_sweep's 120, for time
EXAMPLES = {
    "quickstart": ((), ()),
    "sparsity_sweep": (("--steps", str(SWEEP_STEPS)), ()),
    "train_resume": ((), ()),
    "serve_batched": ((), ("bsr_quant_matmul", "bsr_matmul_experts",
                           "ssm_scan", "flash_attention")),
    "serve_prefix": ((), ("dense_matmul", "flash_attention",
                          "paged_flash_attention")),
    "serve_speculative": ((), ("dense_matmul", "quant_matmul",
                               "flash_attention")),
    "serve_router": (("--full",), ("bsr_quant_matmul", "flash_attention")),
    "serve_traced": (("--full", "--out-dir",
                      str(ROOT / "chiprun_out" / "traced_torch")),
                     ("bsr_quant_matmul", "flash_attention")),
}


def load_example(name):
    """A fresh module of examples_torch/<name>.py."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_outcome(name, out):
    """The one line of an example's result phase 23 prints."""
    if name == "quickstart":
        return f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}"
    if name == "sparsity_sweep":
        return "; ".join(f"s{r['sparsity']} b{r['bits'] or 32} loss "
                         f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}"
                         for r in out["rows"])
    if name == "train_resume":
        return (f"resumed from {out['resumed_from']}, final loss "
                f"{out['resumed_losses'][-1]!r} against the reference's "
                f"{out['reference_losses'][-1]!r}")
    if name == "serve_batched":
        return "; ".join(f"{a}: {r['report']['tokens_per_step']:.2f} tok/step"
                         f", {r['seconds']:.2f} s" for a, r in out.items())
    if name == "serve_prefix":
        rep = out["report"]
        return (f"hit rate {rep['prefix_hit_rate']:.2f}, skip fraction "
                f"{rep['prefill_skip_fraction']:.3f}, admitted tok/s paged "
                f"{out['paged_tps']:.1f} against slab {out['slab_tps']:.1f}")
    if name == "serve_speculative":
        spec, plain = out["spec_report"], out["plain_report"]
        return (f"acceptance {spec['acceptance_rate']:.3f}, tok/dispatch "
                f"{spec['tokens_per_dispatch']:.2f} against plain "
                f"{plain['tokens_per_dispatch']:.2f}")
    if name == "serve_router":
        rep = out["report"]
        return (f"{rep['tokens_per_router_step']:.2f} tok/router-step, "
                f"spills {rep['spills']:.0f}, rejected {rep['rejected']:.0f}, "
                f"tokens per replica {out['per_replica']}")
    rep = out["report"]
    return (f"{rep['tokens_per_step']:.2f} tok/step, {rep['tok_per_s']:.1f} "
            f"tok/s, {out['n_events']} trace events")


def phase_examples(torch, params):
    """23 (see the docstring at the top): every example's main in process
    on the card, its printed output kept under chiprun_out/examples/."""
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    logs = ROOT / "chiprun_out" / "examples"
    logs.mkdir(parents=True, exist_ok=True)
    totals = {name: 0 for name in ops.KERNELS}
    out = {}
    for name, (argv, kernels) in EXAMPLES.items():
        ex = load_example(name)
        kw = {"params": params} if "--full" in argv else {}
        buf = io.StringIO()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                res = ex.main(["--device", "cuda", *argv], **kw)
        finally:
            (logs / f"{name}.log").write_text(buf.getvalue())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        add_counts(totals, counts)
        last = buf.getvalue().strip().splitlines()[-1]
        outcome = example_outcome(name, res)
        flags = " ".join(a for a in argv if "/" not in a)
        print(f"  [23] {name} {flags}: {secs:.1f} s; "
              f"{outcome}; launches {counts}; last line: {last}",
              flush=True)
        missing = [k for k in kernels if not counts.get(k)]
        assert not missing, (name, missing, counts)
        if not kernels:
            assert not counts, (name, counts)
        out[name] = dict(seconds=secs, launches=counts, outcome=outcome,
                         argv=list(argv), last_line=last)
        del res, ex
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 23: {out['seconds']:.1f} s", flush=True)
    return totals, out


# phase 22: the paper's grid. figures.run --quick in process, then every
# Table II kernel packed at these sparsities x weight widths and run on the
# hand-written kernels, each point held to the plain version of its packed
# buffers (f32 points at the f32 GEMM tolerance, TOL) and each conv point
# to F.conv1d / F.conv2d of its masked, fake-quantized filter at the JAX
# test's bound for the quantized conv
GRID_SPARSITIES = (0.0, 0.5, 0.9)
GRID_BITS = (None, 8, 4)
GRID_KERNELS = ("dense_matmul", "bsr_matmul", "quant_matmul",
                "bsr_quant_matmul")
CONV_TOL = 2e-2


def conv_oracle(torch, spec, params, lin, x):
    """F.conv of the filter a packed conv point multiplies: the weight
    masked by the block plan and fake-quantized at the pack-time spec's
    bits (a 1-wide tree point below 8 bits keeps float blocks)."""
    from repro_torch.core import conv as kconv
    from repro_torch.core import kratos as kr
    from repro_torch.core import quantize as qz
    from repro_torch.core import sparsity as sp
    d, w = spec.dims, params["w"]
    plan = kr.plan_for(lin.n_in, lin.n_out, lin.spec)
    if plan is not None:
        w = w * torch.as_tensor(sp.plan_mask(plan), device=w.device)
    if lin.spec.bits is not None:
        w = qz.fake_quantize(w, lin.spec.bits)
    if spec.kernel == "conv1d":
        return kconv.conv1d_ref(x, w.reshape(d["fw"], d["ic"], d["oc"]))
    return kconv.conv2d_ref(x, w.reshape(d["fw"], d["fh"], d["ic"],
                                         d["oc"]))


def phase_grid(torch):
    """Phase 22: `repro_torch.figures.run.run(quick=True)` as users run it
    (`python -m repro_torch.figures.run --quick`): every timed point held
    to its plain version inside, the four GEMM wrappers each launched; then
    the grid of every Table II kernel at GRID_SPARSITIES x GRID_BITS
    (`figures.common.point`: one launch of the wrapper its buffers select,
    held to the plain version, device and plain ms, the bound), conv points
    also against F.conv. The phase's launches are every launch of both
    parts, timed ones included. Prints each point, each kernel family's ms
    against its bound, and the wall s."""
    from repro_torch.core import bench_specs as BS
    from repro_torch.figures import common
    from repro_torch.figures import run as figures_run
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    figures = figures_run.run(quick=True, device="cuda")
    torch.cuda.synchronize()
    fig_counts = ops.launch_counts()
    fig_s = time.perf_counter() - t0
    print(f"  figures.run --quick: {fig_s:.1f} s, launches "
          f"{ {k: fig_counts[k] for k in GRID_KERNELS} }", flush=True)
    for k in GRID_KERNELS:
        assert fig_counts[k] > 0, (k, fig_counts)
    t1 = time.perf_counter()
    points, families = [], {}
    for base in BS.TABLE_II:
        line = []
        for s in GRID_SPARSITIES:
            for b in GRID_BITS:
                spec = dataclasses.replace(base, sparsity=s, bits=b)
                pt = common.point(spec, "cuda", plain_ms=True)
                rec = {k: pt[k] for k in ("macs", "bytes", "kernel",
                                          "format", "device_ms", "bound_ms",
                                          "bound_by", "plain_ms",
                                          "max_abs_err")}
                rec.update(name=base.name, sparsity=s, bits=b)
                if spec.kernel.startswith("conv"):
                    y = pt["fn"](pt["packed"], pt["x"])
                    want = conv_oracle(torch, spec, pt["params"],
                                       pt["packed"]["w"], pt["x"])
                    err = (y - want).abs()
                    assert bool((err <= CONV_TOL + CONV_TOL
                                 * want.abs()).all()), (base.name, s, b)
                    rec["conv_err"] = err.max().item()
                points.append(rec)
                families.setdefault(pt["kernel"], []).append(rec)
                line.append(f"{'w' + str(b) if b else 'f32'} {pt['kernel']} "
                            f"{pt['format']} {pt['device_ms']:.4f} ms "
                            f"(bound {pt['bound_ms']:.2e}, plain "
                            f"{pt['plain_ms']:.4f})")
            print(f"  {base.name} s{s:g}: " + " | ".join(line[-3:]),
                  flush=True)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t1
    summary = {}
    for fam, recs in sorted(families.items()):
        ms = [r["device_ms"] for r in recs]
        bound = [r["bound_ms"] for r in recs]
        ratio = statistics.median(m / b for m, b in zip(ms, bound))
        summary[fam] = dict(points=len(recs), ms_min=min(ms), ms_max=max(ms),
                            ms_median=statistics.median(ms),
                            bound_min=min(bound), bound_max=max(bound),
                            median_ms_over_bound=ratio)
        print(f"  {fam}: {len(recs)} points, device ms {min(ms):.4f}-"
              f"{max(ms):.4f} (median {statistics.median(ms):.4f}), bound "
              f"{min(bound):.2e}-{max(bound):.2e} ms, median ms / bound "
              f"{ratio:.0f}", flush=True)
    wall = time.perf_counter() - t0
    print(f"  phase 22: {wall:.1f} s (figures {fig_s:.1f} s, grid "
          f"{grid_s:.1f} s, {len(points)} points)", flush=True)
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    print(f"  phase 22 launches (figures and grid): {launches}", flush=True)
    fig_rows = {k: v["csv"] for k, v in figures.items()}
    return launches, dict(figures=fig_rows, points=points, families=summary,
                          figures_launches={k: v for k, v in
                                            fig_counts.items() if v},
                          best_grain=figures["table3"]["best_grain"],
                          device_TMACs=figures["fig7"]["device_TMACs"],
                          figures_s=fig_s, grid_s=grid_s, seconds=wall)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    t_main = time.perf_counter()
    marks = {}

    def mark(phase):
        """Seconds since the start, printed before each phase."""
        marks[phase] = time.perf_counter() - t_main
        print(f"  [t = {marks[phase]:.0f} s]", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    nvcc = sh([build.nvcc_path(), "--version"]).splitlines()[-1]
    env = (f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"nvcc {nvcc}, Python {sys.version.split()[0]}")
    print(f"[1] env: {env}; card: {card}", flush=True)

    secs = build.build_all()
    mark(2)
    print(f"[2] build: {len(build.SOURCES)} sources in {secs:.1f} s", flush=True)
    ptxas = {name: build.ptxas_kernels(name) for name in build.SOURCES}
    for name, kernels in ptxas.items():
        for k in kernels:
            k["name"] = demangle(k["kernel"])
            print(f"  {name}: {k['name']}: {k['registers']} registers, "
                  f"spill stores {k['spill_stores']} B, loads "
                  f"{k['spill_loads']} B, {k['smem_bytes']} B static smem")
    spills = [k["name"] for kernels in ptxas.values() for k in kernels
              if any(f in k["kernel"] for f in NO_SPILL)
              and (k["spill_stores"] or k["spill_loads"])]
    assert not spills, f"register spills in {spills}"

    mark(3)
    print("[3] kernels against their plain versions", flush=True)
    cases = phase_kernels(torch, Timer(torch))
    mark(4)
    print("[4] model parity: card vs CPU, h2o-danube-1.8b width, 2 layers",
          flush=True)
    phase_parity(torch, DANUBE, 100, 128)
    params = init_danube(torch)
    mark(5)
    print("[5] serving h2o-danube-1.8b, full width and depth", flush=True)
    launches, serving = phase_serving(torch, card, params)
    mark(6)
    print("[6] paged serving h2o-danube-1.8b, full width and depth",
          flush=True)
    paged_launches, paged = phase_paged_serving(torch, card, params)
    mark("18a")
    print(f"[18a] tracing and telemetry: {DANUBE} full width and depth, "
          f"phase 5's first {SERVE_REQUESTS} requests", flush=True)
    trace_launches, tracing = phase_tracing(
        torch, card, params, serving["dense"]["decode_micro_step_ms"])
    mark("19a")
    print(f"[19a-19d] the serving surface: {DANUBE} full width and depth, "
          f"phase 5's first {SERVE_REQUESTS} requests: legacy against native "
          "paged decode, static against continuous admission, the CLI",
          flush=True)
    surface_launches, surface = phase_surface(torch, card, params)
    gc.collect()
    torch.cuda.empty_cache()
    mark(20)
    print(f"[20] the fleet: {DANUBE} full width and depth, "
          f"{FLEET_PROCESSES} processes: in process (20a), then the "
          "launcher's worker processes (20b)", flush=True)
    fleet_launches, fleet = phase_fleet(torch, card, params)
    gc.collect()
    torch.cuda.empty_cache()
    mark(21)
    print(f"[21] training: {DANUBE} full width and depth, "
          f"{TRAIN_STEPS} steps in place (21a); full width, 1 layer, "
          "s0.5-w8: grad_accum, pruned blocks, crash and resume, the "
          "hand-off to serving (21b)", flush=True)
    train_launches, train = phase_train(torch, card, params)
    gc.collect()
    torch.cuda.empty_cache()
    mark(23)
    print(f"[23] the examples: examples_torch/*.py, main in process; "
          f"serve_traced and serve_router on {DANUBE} full width and depth, "
          "the other six at their own sizes", flush=True)
    example_launches, examples = phase_examples(torch, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    mark(22)
    print("[22] the paper's grid: figures.run --quick in process; every "
          "Table II kernel at s 0 / 0.5 / 0.9 x bits None / 8 / 4 on the "
          "hand-written kernels", flush=True)
    grid_launches, grid = phase_grid(torch)
    mark(7)
    print("[7] prefix and conversation reuse, nemotron-4-340b full width, "
          "1 layer", flush=True)
    reuse_launches, reuse = phase_prefix_reuse(torch, card)
    mark(8)
    print(f"[8] Mamba serving, {FALCON}: memory_allocated before "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; card vs CPU at "
          "full width, 2 layers", flush=True)
    parity_launches = phase_parity(torch, FALCON, 64, 128)
    assert parity_launches["ssm_scan"] == 2 * 2, parity_launches
    print(f"  {FALCON} full width, {FALCON_LAYERS} layers", flush=True)
    mamba_launches, mamba = phase_mamba_serving(torch, card)
    mark(9)
    print("[9] speculative self-draft decode: h2o-danube-1.8b (slab, paged) "
          f"and {FALCON}, full width, depth cut to 8 and 16 layers",
          flush=True)
    spec_launches, spec, danube8 = phase_speculative(torch, card)
    mark(17)
    print(f"[17] resilience and the ledger: {DANUBE} full width, "
          f"{QOS_LAYERS} layers (phase 9's tree), tiers {TIER_LADDER}",
          flush=True)
    qos_launches, resilience, probe_cases_ = phase_resilience(
        torch, card, danube8, Timer(torch))
    cases += probe_cases_
    mark("18b")
    print(f"[18b] the replica router and chaos: {DANUBE} full width, "
          f"{QOS_LAYERS} layers (phase 9's tree), {ROUTER_REPLICAS} "
          "replicas", flush=True)
    router_launches, router = phase_router(torch, card, danube8)
    mark("19b")
    print(f"[19b] legacy speculative paged decode: {DANUBE} full width, "
          f"{QOS_LAYERS} layers (phase 9's tree)", flush=True)
    legacy_spec_launches, legacy_spec = phase_legacy_spec(torch, card,
                                                          danube8)
    del danube8
    gc.collect()
    torch.cuda.empty_cache()
    mark(10)
    print(f"[10] {GEMMA}: card vs CPU at full width, 2 layers; then full "
          f"width, {GEMMA_LAYERS} layers", flush=True)
    parity_launches = phase_parity(torch, GEMMA, 48, 128)
    assert parity_launches["flash_attention"] == 2 * 2, parity_launches
    gemma_launches, gemma = phase_gemma2(torch, card)
    mark(11)
    print(f"[11] {MINICPM} (MLA): card vs CPU at full width, 2 layers; then "
          f"full width, {MINICPM_LAYERS} layers", flush=True)
    parity_launches = phase_parity(torch, MINICPM, 48, 128)
    assert parity_launches["flash_attention"] == 0, parity_launches
    mla_launches, mla = phase_minicpm3(torch, card)
    skip = (reuse["report"]["prefill_skip_fraction"],
            mla["prefix_reuse"]["report"]["prefill_skip_fraction"])
    print(f"  prefill skip fraction: {MINICPM} {skip[1]:.4f} against "
          f"nemotron-4-340b's {skip[0]:.4f} (phase 7)", flush=True)
    assert skip[1] >= skip[0], skip
    mark(12)
    print(f"[12] mixture-of-experts, {DEEPSEEK}: card vs CPU at full width, "
          f"2 layers; then full width, {DEEPSEEK_LAYERS} layers; then "
          f"{LITE}", flush=True)
    parity_launches = phase_parity(torch, DEEPSEEK, 48, 128)
    assert parity_launches["flash_attention"] == 2 * 2, parity_launches
    assert parity_launches["bsr_matmul_experts"] == 3, parity_launches
    moe_launches, moe = phase_moe(torch, card, mark)
    print(f"  prefill skip fraction: {DEEPSEEK} "
          f"{moe['prefix_reuse']['report']['prefill_skip_fraction']:.4f} "
          f"against nemotron-4-340b's {skip[0]:.4f} (phase 7)", flush=True)
    mark(13)
    print(f"[13] the jamba hybrid, {JAMBA}: card vs CPU at full width, one "
          f"Jamba block with the FFNs cut; then full width, {JAMBA_LAYERS} "
          "layers", flush=True)
    parity_launches = phase_parity(torch, JAMBA, 48, 128, **JAMBA_PARITY)
    assert parity_launches["ssm_scan"] == 2 * 7, parity_launches
    assert parity_launches["flash_attention"] == 2, parity_launches
    assert parity_launches["bsr_matmul_experts"] == 3 * 4, parity_launches
    jamba_launches, jamba = phase_jamba(torch, card, mark)
    mark(14)
    print(f"[14] the vision stub, {LLAVA}: card vs CPU at full width, 2 "
          f"layers, {LLAVA_PARITY_IMG} image rows; then full width, "
          f"{LLAVA_LAYERS} layers, 2880 image rows a request", flush=True)
    parity_launches = phase_parity(torch, LLAVA, 48, 128,
                                   n_img_tokens=LLAVA_PARITY_IMG)
    assert parity_launches["flash_attention"] == 2 * 2, parity_launches
    llava_launches, llava = phase_llava(torch, card, mark)
    mark(15)
    print(f"[15] the encoder-decoder, {WHISPER}: card vs CPU at full width, 2 "
          f"encoder and 2 decoder layers; then full width, 32 encoder and "
          f"{WHISPER_LAYERS} decoder layers, 1500 "
          "frames a request", flush=True)
    parity_launches = phase_parity(torch, WHISPER, 48, 128, n_enc_layers=2)
    assert parity_launches["flash_attention"] == 2 * (2 + 2), parity_launches
    whisper_launches, whisper = phase_whisper(torch, card, mark)
    for more in (paged_launches, reuse_launches, mamba_launches,
                 spec_launches, qos_launches, gemma_launches, mla_launches,
                 moe_launches, jamba_launches, llava_launches,
                 whisper_launches, trace_launches, router_launches,
                 surface_launches, legacy_spec_launches, fleet_launches,
                 train_launches, grid_launches, example_launches):
        for name, c in more.items():
            launches[name] += c

    mark("end")
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        assert launches[name] > 0, (name, launches)
        mine = [c for c in cases if c["kernel"] == name]
        h = next(c for c in mine if c["key"] == HEADLINE[name])
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(c["max_abs_err"] for c in mine),
            ms=h["ms"], plain_ms=h["plain_ms"], bound_ms=h["bound_ms"],
            bound_by=h["bound_by"], library_ms=h["library_ms"]))
    parts = {k: dict(seconds=PART_S[k], calls=PART_N[k])
             for k in sorted(PART_S)}
    print("time by part, summed over the phases: " + "; ".join(
        f"{k} {v['seconds']:.1f} s in {v['calls']} calls"
        for k, v in parts.items()), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "env": env, "build_s": secs, "ptxas": ptxas,
         "kernels": kernels,
         "cases": [{k: v for k, v in c.items() if k != "key"} for c in cases],
         "serving": serving, "paged_serving": paged, "prefix_reuse": reuse,
         "mamba_serving": mamba, "speculative": spec, "gemma2": gemma,
         "minicpm3": mla, "moe": moe, "jamba": jamba, "llava": llava,
         "whisper": whisper, "resilience": resilience,
         "tracing": tracing, "router": router, "surface": surface,
         "legacy_spec": legacy_spec, "fleet": fleet, "train": train,
         "paper_grid": grid, "examples": examples,
         "phase_start_s": marks, "time_by_part": parts},
        indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
