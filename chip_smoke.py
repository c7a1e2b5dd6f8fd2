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
     dense stack;
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
     to 2 layers (one 64-token prefill, 4 greedy decode steps); then the
     full model (64 layers, random f32 weights from seed 0, 29.1 GB),
     packed dense and sparsity 0.5 x int8, serving phase 5's traffic. Every
     prefill runs the selective-scan kernel once per layer (64 x 16 per
     run), each spec launches only its own GEMMs, no attention kernel
     runs, and a traced decode dispatch copies to the host once; 3 decode
     dispatches and 3 512-token prefills are traced, and each prefill shows
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
     to 2 layers; then full width, depth cut from 46 to 8 layers (22.8 GB
     in f32), phase 5's traffic: dense and s0.5-w8 from the slab, dense
     from the page pool (every layer page-major: the page-table kernel
     once a layer a micro-step, with softcap 50, and window 4096 on local
     layers), and one long run of 2 x 4160 prompt tokens past the local
     window (max_len 4224). tok/s, GEMM / non-GEMM / paged-attention
     device ms per micro-step, the 512-token prefill's flash device ms;
     paged tokens equal slab tokens (near-tie rule), and every run's equal
     the eager step's;
 11. minicpm3-4b (MLA): card-vs-CPU parity at 2 layers; then full width,
     depth cut from 62 to 16 layers (4.8 GB): phase 5's traffic from the
     slab, dense and s0.5-w8, with the naive expansion's share of decode
     device time;
     speculative decode (K 4, w8 draft) from the slab and the page pool
     against plain decode; phase 7's prefix traffic from the page pool,
     whose skipped share of prompt tokens must be no lower than
     nemotron's. No attention kernel runs on MLA's path (as in the JAX
     package). Every run's tokens equal the eager step's;
 12. mixture-of-experts: deepseek-moe-16b, card-vs-CPU parity at 2 layers
     (the dense prelude layer and one MoE layer); then full width, depth
     cut from 28 to 8 layers (1 dense + 7 MoE, 18.5 GB in f32): phase 5's
     traffic from the slab, dense (the routed experts a batched plain
     product, as the JAX package's einsum) and s0.5-w8 (the routed experts
     on bsr_matmul_experts over fake-quant float blocks: 21 launches a
     micro-step), with decode device ms split, from each traced dispatch,
     into the routed experts' GEMM kernels (found by name and grid in a
     trace of one layer's expert FFN), the port's other GEMMs and the
     rest; dense from the page pool without prefix
     reuse (tokens equal the slab's, near-tie rule); phase 7's prefix
     traffic (skip share, matched against unmatched admission). Then
     deepseek-v2-lite-16b (MLA + MoE): parity at 2 layers, full width cut
     from 27 to 4 layers, dense from the slab. Every run's tokens equal
     the eager step's.
Every decode dispatch of phases 5-12 replays the CUDA graph the engine
captured at build: each of those phases times it against the eager step on
the same state, in alternating turns within this process, traces both
(device ms and ops, idle share, one device-to-host copy each), and serves
one of its configurations a second time through the eager step, which must
give the same tokens.
The last lines are the kernels JSON line, the card line and
{"ok": true, "device": {...}}. Per-case numbers go to
chiprun_out/chip_smoke.json. Without a CUDA device it exits 2.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12                                # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12,      # dense, no sparsity
              "int8": 1979e12}
# flash attention's second bound, at the rate of the units it runs on:
# 3xTF32 spends three TF32 products (495 TFLOP/s) on each f32 one, bf16
# runs at the bf16 tensor-core rate
TC_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
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
    "bsr_matmul_experts": ("bsr_matmul_experts", 6, (2048, 1408))}
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
}
GEMMA, MINICPM = "gemma2-27b", "minicpm3-4b"
GEMMA_LAYERS = 8                       # of 46 (phase 10's depth cut)
MINICPM_LAYERS = 16                    # of 62 (phase 11's depth cut)
DEEPSEEK, LITE = "deepseek-moe-16b", "deepseek-v2-lite-16b"
DEEPSEEK_LAYERS = 8                    # of 28: 1 dense + 7 MoE (phase 12)
LITE_LAYERS = 4                        # of 27: 1 dense + 3 MoE (phase 12)
# deepseek's routed projections (n_in, n_out) and the expert rows C of a
# decode micro-step at 8 slots and of a 512-token prefill
EXPERT_SHAPES = [(2048, 1408), (1408, 2048)]
EXPERT_ROWS = (6, 60)
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
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# device-kernel name fragments of the port's projection GEMMs: the decode
# and prefill forms of the float-activation GEMMs (every weight source), the
# tiled mainloop kept for block shapes those forms do not take, and w8a8's
# int8 GEMV, its row-quantize kernel and its tensor-core tile
GEMM_FAMILIES = ("gemv_cluster_kernel", "gemm_pipe_kernel", "gemm_tile_kernel",
                 "w8a8_gemv_kernel", "act_quant_kernel", "w8a8_mma_kernel")
KERNEL_FAMILIES = GEMM_FAMILIES + ("fa_tc_kernel", "paged_kernel",
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


def trace_call(torch, fn, grids=False):
    """Trace one call of `fn` (closed by a device sync) in its own
    torch.profiler session of device activity. Returns the device window
    (first device op's start to last one's end), the device ms by kernel
    family, the numbers of device ops and of device-to-host copies, the
    device idle share = 1 - (union of device activity) / (device window),
    and the host wall time of the traced call (the tracing widens it). With
    `grids`, also the device ms and launches of each GEMM kernel by name
    and grid (`gemm_kernels_by_grid`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_host = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t_host = time.perf_counter() - t_host
    device = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    if not device:
        raise AssertionError("profiler saw no device activity")
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
               dtoh_copies=dtoh, device_ops=len(device))
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


def graph_vs_eager(torch, eng, per, turns=3, n=3, traces=2, grids=False):
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


def eager_identity(torch, model, ecfg, prompts, gen_len, want):
    """Serve the same traffic through a fresh engine whose every dispatch
    runs the eager step: its tokens must equal the graphed run's."""
    from repro_torch.serve import InferenceEngine
    eng = run_eager(InferenceEngine(model, ecfg))
    reqs = [eng.submit(p, gen_len) for p in prompts]
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


def plain_packed(ref, lin, x):
    """The plain version of the kernel `apply_packed` picks for `lin`."""
    b = lin.buffers
    if "w" in b:
        return ref.dense_matmul_ref(x, b["w"])
    if "qt" in b:
        if lin.spec.act_bits == 8:
            return ref.quant_matmul_w8a8_ref(x, b["qt"])
        return ref.quant_matmul_ref(x, b["qt"])
    if "blocks" in b:
        return ref.bsr_matmul_ref(x, b["blocks"], lin.indices)
    return ref.bsr_quant_matmul_ref(x, b["qblocks"], b["qscale"],
                                    lin.indices, lin.spec.bits)


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
                               ops.flash_attention(q, k, v, **kw),
                               flash_attention_plain(qf, kf, vf, **kw)[None],
                               FA_TOL[dtype],
                               ("flash_attention", dtype, sq, window, cap, d),
                               nbytes(q, k, v, q),
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
                               ops.paged_attention(*args, **kw),
                               ref.paged_attention_ref(*args, **kw),
                               FA_TOL[dtype],
                               ("paged_flash_attention", dtype, d, sq, window,
                                cap),
                               kv_bytes + nbytes(q, q, table, last),
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
                   ops.flash_attention(q, k, v, **kw),
                   flash_attention_plain(qf, kf, vf, **kw)[None],
                   FA_TOL["float32"],
                   ("flash_attention", "float32", sq, window, 50.0, 128),
                   nbytes(q, k, v, q), 4 * 128 * n_live * 32,
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
               ops.paged_attention(*args, **kw),
               ref.paged_attention_ref(*args, **kw), FA_TOL["float32"],
               ("paged_flash_attention", "float32", 128, sq, None, 50.0),
               kv_bytes + nbytes(q, q, table, last),
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
            w_eff = plain_packed(ref, lin, torch.eye(n, device=dev))
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
                record(kernel, "float32", got, plain_packed(ref, lin, x),
                       TOL["float32"], ("mla", leaf, kr.spec_tag(spec), m),
                       nbytes(x, y, *idx) + lin.packed_bytes,
                       2 * m * keep * p,
                       lambda: kr.apply_packed(lin, x),
                       lambda: plain_packed(ref, lin, x),
                       lambda: torch.matmul(x, w_eff), m=m, n=n, p=p,
                       leaf=leaf, spec=kr.spec_tag(lin.spec))
            del w_eff

    # bsr_matmul batched over an MoE layer's experts: deepseek-moe-16b's 64
    # routed experts, w_gate / w_up (2048 -> 1408) and w_down (1408 ->
    # 2048) at s0.5, C = 6 rows an expert (decode at 8 slots) and C = 60 (a
    # 512-token prefill); one launch a call. Bytes: x, the kept blocks, the
    # index table and y once; operations: every expert's C rows against
    # its kept k. The library time is torch.bmm on the masked dense stack
    experts = 64
    for n, p in EXPERT_SHAPES:
        w = torch.randn((experts, n, p), generator=gen, device=dev) \
            * n ** -0.5
        spec = kr.KratosSpec(sparsity=0.5)
        plan = kr.plan_for(n, p, spec)
        packed = kr.pack_experts(w, spec)
        w.mul_(torch.as_tensor(sp.plan_mask(plan), device=dev))
        for c in EXPERT_ROWS:
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


def phase_parity(torch, arch, s0, max_len):
    """The port's forward on the card against the same forward on the CPU
    (plain versions): `arch` at full width cut to 2 layers, a batch of 2
    prompts of s0 tokens, then 4 greedy decode steps. Returns the kernel
    launches of the card's prefills."""
    from repro_torch import configs as C
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve.registry import pack_model_params, tree_to

    cfg = C.get_config(arch, n_layers=2)
    params = T.init(cfg, seed=SEED, device="cuda")
    params_cpu = tree_to(params, "cpu")
    rng = np.random.default_rng(SEED)
    b, steps = 2, 4
    tokens = rng.integers(0, cfg.vocab, (b, s0)).astype(np.int32)
    prefill_launches = {name: 0 for name in ops.KERNELS}
    for spec in (kr.DENSE, kr.KratosSpec(sparsity=0.5, bits=8)):
        out = {}
        for dev, tree in (("cuda", params), ("cpu", params_cpu)):
            packed, _ = pack_model_params(tree, spec)
            caches = T.make_caches(cfg, b, max_len, torch.float32, dev)
            ops.reset_launch_counts()
            logits, caches = T.forward(packed, torch.from_numpy(tokens).to(dev),
                                       cfg, caches=caches)
            for name, c in ops.launch_counts().items():
                prefill_launches[name] += c
            out[dev] = [logits.cpu()]
            out[dev + "_state"] = (packed, caches)
        worst = float((out["cuda"][0] - out["cpu"][0]).abs().max())
        tok = out["cpu"][0][:, -1].argmax(-1).to(torch.int32)
        same = bool((out["cuda"][0][:, -1].argmax(-1) == tok.long()).all())
        for step in range(steps):
            index = torch.full((b,), s0 + step, dtype=torch.int32)
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
        ab = graph_vs_eager(torch, eng, k, traces=3)
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
            torch, lambda: eng.backend.prefill(batch, exact=True), 3)
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
        if tag == "dense":
            results[tag]["eager_tokens_identical"] = eager_identity(
                torch, model, ecfg, prompts, gen_len,
                [list(r.generated) for r in reqs])
        del eng, model
        gc.collect()
    return totals, results


def first_divergence(torch, model, prompts, got, want):
    """Hold greedy tokens `got` to `want` request by request. Where they
    first differ, recompute the logits of the common prefix on the card
    and require a top-2 gap below TOP2_GAP (a near-tie that two summation
    orders may break either way). Returns the divergences found."""
    from repro_torch.models import transformer as T
    out = []
    for i, (p, a, b) in enumerate(zip(prompts, got, want)):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        seq = np.concatenate([p, np.asarray(a[:j], np.int32)])
        caches = T.make_caches(model.cfg, 1, len(seq), torch.float32, "cuda")
        logits, _ = T.forward(model.params,
                              torch.from_numpy(seq[None]).cuda(), model.cfg,
                              caches=caches, last_only=True)
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


def phase_mamba_serving(torch, card):
    """falcon-mamba-7b at full width and depth, random f32 weights from the
    seed, packed dense and sparsity 0.5 x int8 (x_proj's 288 outputs do
    not divide the 128-wide block grid, so it packs weight-only w8), over
    phase 5's traffic in this vocab. The prompts prefill at exact length."""
    from repro_torch import configs as C
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import EngineConfig, InferenceEngine, ModelRegistry

    cfg = C.get_config(FALCON)
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
        model = ModelRegistry().load(FALCON, spec, smoke=False, params=params,
                                     seed=SEED)
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
        ab = graph_vs_eager(torch, eng, k, traces=3)
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
            torch, lambda: eng.backend.prefill(batch, exact=True), 3)
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
    with phases 10-11 (their eager A/B partners are host-bound)."""
    from repro_torch import configs as C
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import DraftSpec

    cells = ((DANUBE, 8, DraftSpec(bits=8, sparsity=0.5), 4, (None, 16),
              {"dense_matmul", "bsr_quant_matmul"}),
             (FALCON, 16, DraftSpec(bits=8), 2, (None,),
              {"dense_matmul", "quant_matmul"}))
    totals = {name: 0 for name in ops.KERNELS}
    results = {}
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
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    return totals, results




def load_cut(arch, spec, params, n_layers, **kw):
    """The registry's full-config artifact over a depth-cut parameter tree
    (the first `n_layers` layers): its config, and its draft's, cut to
    match."""
    from repro_torch.serve import ModelRegistry
    model = ModelRegistry().load(arch, spec, smoke=False, params=params,
                                 seed=SEED, **kw)
    model.cfg = dataclasses.replace(model.cfg, n_layers=n_layers)
    if model.has_draft:
        model.draft_cfg = dataclasses.replace(model.draft_cfg,
                                              n_layers=n_layers)
    return model


def serve_run(torch, card, model, prompts, ecfg, gemms, tag, grids=False):
    """Serve `prompts` (GEN_LEN new tokens each, greedy) through a fresh
    engine after an allocator warm-up, as the main path; check that only
    the spec's GEMMs ran and which attention kernels did (flash at prefill
    for GQA, the page-table kernel once a layer a micro-step when paged;
    none for MLA); time and trace the graphed dispatch against the eager
    step, and trace a 512-token prefill. Returns (launches, result,
    engine, tokens)."""
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import gemm_plan, ops
    from repro_torch.serve import InferenceEngine
    cfg, k = model.cfg, ecfg.decode_chunk
    warm = InferenceEngine(model, ecfg)          # allocator warm-up
    warm.submit(prompts[0][:32], 4)
    warm.run()
    del warm
    gc.collect()
    eng = InferenceEngine(model, ecfg)
    reqs = [eng.submit(p, GEN_LEN) for p in prompts]
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
    assert (counts["flash_attention"] > 0) != cfg.mla, counts
    assert counts["paged_flash_attention"] == (
        cfg.n_layers * rep["micro_steps"] if paged and not cfg.mla else 0), \
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
        np.resize(prompts[0], (1, 512)).astype(np.int32)).cuda()}
    eng.backend.prefill(batch, exact=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.backend.prefill(batch, exact=True)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t1) * 1e3
    prefill_prof, _ = profile_calls(
        torch, lambda: eng.backend.prefill(batch, exact=True), 2)
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
        prefill_512_ms=prefill_ms,
        prefill_512_flash_device_ms=flash,
        prefill_512_gemm_device_ms=[gemm_ms(c) for c in prefill_prof],
        decode_dispatch_profiled=prof, prefill_512_profiled=prefill_prof,
        packed_mb=model.packed_bytes / 2 ** 20, launches=counts)
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
    print(f"    512-token prefill: untraced wall {prefill_ms:.2f} ms, flash "
          f"device ms {r(flash, 4)}, GEMM device ms "
          f"{r(res['prefill_512_gemm_device_ms'])}", flush=True)
    res["graph_vs_eager"] = print_ab(card, ab, k)
    return counts, res, eng, tokens


def add_counts(totals, counts):
    for name, c in counts.items():
        totals[name] += c


def phase_gemma2(torch, card):
    """gemma2-27b at its published width (d_model 4608, 32/16 heads,
    head_dim 128, d_ff 36864 gelu_tanh, vocab 256000 tied), depth cut from
    46 to 8 layers (4 local/global pairs; 46 layers are 108.9 GB in f32, and
    16 would not leave the script its time limit),
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
    73448 tied), depth cut from 62 to 16 layers (62 layers took 397 s of
    the script's 1200, most of it the host-bound eager partners; the
    residual scale stays the published 1.4 / sqrt(62)), random f32 weights
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


def phase_moe(torch, card):
    """deepseek-moe-16b at its published width (d_model 2048, 16 heads of
    128, 64 routed experts of d_ff 1408, top 6, 2 shared, the dense prelude
    layer of d_ff 10944, vocab 102400 untied), depth cut from 28 to 8
    layers (28 layers are 65.5 GB in f32: no room for a second packed copy
    or the KV pool, nor time in the script's limit), random f32 weights
    from the seed, phase 5's traffic in its vocab: dense and s0.5-w8 from
    the slab, dense from the page pool without prefix reuse, and phase 7's
    prefix traffic. Prompts prefill at exact length (pad tokens would take
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
        t0 = time.perf_counter()
        model = load_cut(DEEPSEEK, spec, params, cfg.n_layers)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
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
        keys = routed_kernels(torch, model, N_SLOTS)
        routed_step = [routed_ms(c, keys, n_moe * CHUNK) / CHUNK
                       for c in res["decode_dispatch_profiled"]]
        assert all(v > 0 for v in routed_step), routed_step
        other_gemm = [g - (v if per_fwd else 0.0) for g, v in
                      zip(res["gemm_device_ms_per_micro_step"],
                          routed_step)]
        non_gemm = [b - v - g for b, v, g in
                    zip(res["device_ms_per_micro_step"], routed_step,
                        other_gemm)]
        res.update(pack_s=pack_s, routed_expert_kernels=keys,
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
              f"replay {per_replay}; pack {pack_s:.1f} s", flush=True)
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
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
    del params
    gc.collect()
    torch.cuda.empty_cache()
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
    print(f"  {FALCON} full width and depth", flush=True)
    mamba_launches, mamba = phase_mamba_serving(torch, card)
    mark(9)
    print("[9] speculative self-draft decode: h2o-danube-1.8b (slab, paged) "
          f"and {FALCON}, full width, depth cut to 8 and 16 layers",
          flush=True)
    spec_launches, spec = phase_speculative(torch, card)
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
    moe_launches, moe = phase_moe(torch, card)
    print(f"  prefill skip fraction: {DEEPSEEK} "
          f"{moe['prefix_reuse']['report']['prefill_skip_fraction']:.4f} "
          f"against nemotron-4-340b's {skip[0]:.4f} (phase 7)", flush=True)
    for more in (paged_launches, reuse_launches, mamba_launches,
                 spec_launches, gemma_launches, mla_launches, moe_launches):
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
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "env": env, "build_s": secs, "ptxas": ptxas,
         "kernels": kernels,
         "cases": [{k: v for k, v in c.items() if k != "key"} for c in cases],
         "serving": serving, "paged_serving": paged, "prefix_reuse": reuse,
         "mamba_serving": mamba, "speculative": spec, "gemma2": gemma,
         "minicpm3": mla, "moe": moe, "phase_start_s": marks},
        indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
