#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. environment: torch / CUDA / nvcc versions, the card's name and power
     limit;
  2. build: every kernel under src/repro_torch/csrc, one nvcc each, all at
     once (timed);
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card, at the shapes the h2o-danube-1.8b serving path gives it, with
     its time (CUDA events, L2 flushed before each launch), the plain
     version's, one PyTorch library call's and the least time the card
     could take (the bound);
  4. model parity: the port's forward on the card against the same forward
     on the CPU (plain versions), full width cut to 2 layers, one prefill
     batch and 4 greedy decode steps;
  5. serving: h2o-danube-1.8b at full width and depth (random f32 weights
     from seed 0), packed three times (dense, sparsity 0.5, sparsity 0.5
     x int8) and served through InferenceEngine; the launch counts show
     which kernels the serving path ran. Three decode dispatches and three
     512-token prefills are then traced with torch.profiler: device time
     by kernel, the device idle share within each traced call's device
     window, and exactly one device-to-host copy per decode dispatch.
The last lines are the kernels JSON line, the card line and
{"ok": true, "device": {...}}. Per-case numbers go to
chiprun_out/chip_smoke.json. Without a CUDA device it exits 2.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12                                # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}      # dense, no sparsity
GEMM_SHAPES = [(2560, 2560), (2560, 640), (2560, 6912), (6912, 2560)]
GEMM_ROWS = [1, 8, 77, 512]
BITS = [8, 4, 2, 1]
SPARSITIES = [0.5, 0.75]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-3, 2.0 ** -7)}    # atol, rtol
# bf16 flash: the kernel rounds the unnormalised p to bf16 (as the Pallas
# kernel does), the plain version the normalised p; each is off by up to
# 2^-9 * sum_j p_j |v_j| (~6e-3 for randn v at these lengths), plus one
# bf16 ulp of the output
FA_TOL = {"float32": (2e-3, 2e-3), "bfloat16": (8e-3, 2.0 ** -7)}
# the case whose times stand for each kernel in the kernels line: the
# largest decode GEMM of a micro-step (w_gate / w_up at m = n_slots) and
# the longest prefill bucket
HEADLINE = {
    "dense_matmul": ("dense_matmul", "float32", 8, (2560, 6912), 0.0, None),
    "bsr_matmul": ("bsr_matmul", "float32", 8, (2560, 6912), 0.5, None),
    "bsr_quant_matmul": ("bsr_quant_matmul", "float32", 8, (2560, 6912),
                         0.5, 8),
    "flash_attention": ("flash_attention", "float32", 512, None, None)}
SOURCES = {
    "dense_matmul": ("src/repro_torch/csrc/dense_matmul.cu",
                     "src/repro/kernels/dense_matmul.py:38"),
    "bsr_matmul": ("src/repro_torch/csrc/bsr_matmul.cu",
                   "src/repro/kernels/bsr_matmul.py:47"),
    "bsr_quant_matmul": ("src/repro_torch/csrc/quant_matmul.cu",
                         "src/repro/kernels/quant_matmul.py:200"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:91"),
}


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


class Timer:
    """Median device time of one call, L2 flushed before every launch."""

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
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)


def bound_ms(n_bytes, flops, dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def profile_calls(torch, fn, n):
    """Trace `n` calls of `fn` (each closed by a device sync), one
    torch.profiler session of device activity per call. For each call: the
    device window (first device op's start to last one's end), the device
    ms by kernel family, the number of device-to-host copies, the device
    idle share = 1 - (union of device activity) / (device window), and the
    host wall time of the traced call (the tracing widens it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    calls = []
    for i in range(n):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t_host = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t_host = time.perf_counter() - t_host
        device = sorted((e.time_range.start, e.time_range.end, e.name)
                        for e in prof.events()
                        if e.device_type == DeviceType.CUDA)
        if not device:
            raise AssertionError(f"profiler saw no device activity in "
                                 f"call {i}")
        t0, t1 = device[0][0], max(e for _, e, _ in device)
        busy, end, by_kernel, dtoh = 0.0, t0, {}, 0
        for s, e, name in device:
            busy += max(0.0, e - max(s, end))
            end = max(end, e)
            fam = ("gemm_tile_kernel" if "gemm_tile_kernel" in name else
                   "fa_kernel" if "fa_kernel" in name else
                   "memcpy_memset" if "mem" in name.lower() else "other")
            by_kernel[fam] = by_kernel.get(fam, 0.0) + (e - s) / 1e3
            dtoh += "DtoH" in name
        calls.append(dict(window_ms=(t1 - t0) / 1e3, busy_ms=busy / 1e3,
                          idle_share=1.0 - busy / (t1 - t0),
                          traced_host_ms=t_host * 1e3,
                          device_ms_by_kernel=by_kernel, dtoh_copies=dtoh))
    return calls


def phase_kernels(torch, timer):
    from repro_torch.core import kratos as kr
    from repro_torch.core import quantize as qz
    from repro_torch.core import sparsity as sp
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_plain

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = []

    def record(kernel, dtype, got, want, tol, key, n_bytes, flops, run,
               plain, library, **shape):
        err = (got.float() - want.float()).abs()
        atol, rtol = tol
        ok = bool((err <= atol + rtol * want.float().abs()).all())
        b_ms, b_by = bound_ms(n_bytes, flops, dtype)
        case = dict(kernel=kernel, dtype=dtype, **shape,
                    max_abs_err=float(err.max()), atol=atol, rtol=rtol,
                    ms=timer(run), plain_ms=timer(plain, iters=5),
                    library_ms=None if library is None else timer(library,
                                                                  iters=5),
                    bound_ms=b_ms, bound_by=b_by, key=key)
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
        for n, p in GEMM_SHAPES:
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
                for s in SPARSITIES:
                    spec = kr.KratosSpec(sparsity=s)
                    plan = kr.plan_for(n, p, spec)
                    idx = torch.as_tensor(plan.indices, device=dev)
                    keep = plan.nnz * plan.bk
                    blocks = sp.pack_blocks(w, plan)
                    w_mask = w * torch.as_tensor(sp.plan_mask(plan), dtype=dt,
                                                 device=dev)
                    record("bsr_matmul", dtype, ops.bsr_matmul(x, blocks, idx),
                           ref.bsr_matmul_ref(x, blocks, idx), TOL[dtype],
                           ("bsr_matmul", dtype, m, (n, p), s, None),
                           nbytes(x, blocks, idx, y), 2 * m * keep * p,
                           lambda: ops.bsr_matmul(x, blocks, idx),
                           lambda: ref.bsr_matmul_ref(x, blocks, idx),
                           lambda: torch.matmul(x, w_mask),
                           m=m, n=n, p=p, sparsity=s)
                    for bits in BITS:
                        buf = kr.pack({"w": w32}, spec.with_(bits=bits))
                        qb, sc = buf["qblocks"], buf["qscale"]
                        scale = qz.compute_scale(w32, bits)
                        w_deq = (qz.quantize_values(w32, scale, bits).float()
                                 * scale * torch.as_tensor(
                                     sp.plan_mask(plan), device=dev)).to(dt)
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
                               m=m, n=n, p=p, sparsity=s, bits=bits)

    # flash attention: h2o-danube prefill heads (32 q over 8 kv, d = 80)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype in DTYPES:
        dt = getattr(torch, dtype)
        for sq in (16, 77, 512):
            q = torch.randn((1, 32, sq, 80), generator=gen, device=dev).to(dt)
            k = torch.randn((1, 8, sq, 80), generator=gen, device=dev).to(dt)
            v = torch.randn((1, 8, sq, 80), generator=gen, device=dev).to(dt)
            qf, kf, vf = q[0], k[0], v[0]
            pos = np.arange(sq)
            for window in (None, 64):
                live = pos[None, :] <= pos[:, None]
                if window is not None:
                    live &= pos[None, :] > pos[:, None] - window
                mask = torch.as_tensor(live, device=dev)
                for cap in (None, 50.0):
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
                           ("flash_attention", dtype, sq, window, cap),
                           nbytes(q, k, v, q),
                           4 * 80 * int(live.sum()) * 32,
                           lambda: ops.flash_attention(q, k, v, **kw),
                           lambda: flash_attention_plain(qf, kf, vf, **kw),
                           library, sq=sq, heads=32, kv_heads=8, d=80,
                           window=window, softcap=cap)
    torch.cuda.synchronize()
    return cases


def phase_parity(torch):
    from repro_torch import configs as C
    from repro_torch.core import kratos as kr
    from repro_torch.models import transformer as T
    from repro_torch.serve.registry import pack_model_params, tree_to

    cfg = C.get_config("h2o-danube-1.8b", n_layers=2)
    params = T.init(cfg, seed=SEED, device="cuda")
    params_cpu = tree_to(params, "cpu")
    rng = np.random.default_rng(SEED)
    b, s0, steps, max_len = 2, 100, 4, 128
    tokens = rng.integers(0, cfg.vocab, (b, s0)).astype(np.int32)
    for spec in (kr.DENSE, kr.KratosSpec(sparsity=0.5, bits=8)):
        out = {}
        for dev, tree in (("cuda", params), ("cpu", params_cpu)):
            packed, _ = pack_model_params(tree, spec)
            caches = T.make_caches(cfg, b, max_len, torch.float32, dev)
            logits, caches = T.forward(packed, torch.from_numpy(tokens).to(dev),
                                       cfg, caches=caches)
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
        print(f"  parity {tag}: max |logit diff| card vs CPU = {worst:.3g} "
              f"(tol 1e-3), greedy tokens identical: {same}", flush=True)
        if worst > 1e-3 or not same:
            raise AssertionError(f"model parity failed for {tag}")
    del params, params_cpu
    torch.cuda.empty_cache()


def phase_serving(torch, card):
    from repro_torch import configs as C
    from repro_torch.core import kratos as kr
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import EngineConfig, InferenceEngine, ModelRegistry

    arch, n_slots, n_req, gen_len, k = "h2o-danube-1.8b", 8, 16, 32, 4
    t0 = time.perf_counter()
    reg = ModelRegistry()
    params = T.init(C.get_config(arch), seed=SEED, device="cuda")
    torch.cuda.synchronize()
    print(f"  init full-width {arch} (f32): {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.default_rng(SEED)
    lens = rng.integers(32, 513, n_req)
    prompts = [rng.integers(0, 32000, int(s)).astype(np.int32) for s in lens]
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
        for name in ("dense_matmul", "bsr_matmul", "bsr_quant_matmul"):
            assert (counts[name] > 0) == (name == gemm), (tag, counts)
        assert counts["flash_attention"] > 0, counts
        # bookkeeping only (the engine counts one sync per dispatch); the
        # checks are the sync-debug guard around every dispatch and the
        # traced device-to-host copies below
        assert rep["host_syncs_decode"] == rep["decode_steps"], rep
        # decode dispatch time at full slab width (masks make the work the
        # same whether slots are live or parked)
        n_disp = 5
        eng.backend.decode_block()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(n_disp):
            eng.backend.decode_block()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t1) * 1e3 / (n_disp * k)
        decode_prof = profile_calls(torch, eng.backend.decode_block, 3)
        copies = [c["dtoh_copies"] for c in decode_prof]
        assert copies == [1] * len(copies), \
            f"device-to-host copies per dispatch {copies}, expected 1"
        # one 512-token prefill (the largest bucket), wall and device time
        batch = {"tokens": torch.from_numpy(
            np.resize(prompts[0], (1, 512)).astype(np.int32)).cuda()}
        eng.backend.prefill(batch, exact=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng.backend.prefill(batch, exact=True)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t1) * 1e3
        prefill_prof = profile_calls(
            torch, lambda: eng.backend.prefill(batch, exact=True), 3)
        results[tag] = dict(
            prefill_512_ms=prefill_ms, prefill_512_profiled=prefill_prof,
            decode_dispatch_profiled=decode_prof,
            spec=kr.spec_tag(spec), pack_s=pack_s, wall_s=wall,
            tok_per_s=rep["tokens_generated"] / wall,
            latency_s_p50=rep["latency_s_p50"],
            latency_s_p99=rep["latency_s_p99"],
            decode_dispatches=rep["decode_steps"],
            host_syncs_decode=rep["host_syncs_decode"],
            host_syncs_prefill=rep["host_syncs_prefill"],
            tokens=rep["tokens_generated"],
            decode_micro_step_ms=step_ms,
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
        print(f"    untraced 512-token prefill {prefill_ms:.2f} ms",
              flush=True)
        del eng, model
    return totals, results


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    nvcc = sh([build.nvcc_path(), "--version"]).splitlines()[-1]
    env = (f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"nvcc {nvcc}, Python {sys.version.split()[0]}")
    print(f"[1] env: {env}; card: {card}", flush=True)

    secs = build.build_all()
    print(f"[2] build: {len(build.SOURCES)} kernels in {secs:.1f} s", flush=True)
    ptxas = {name: [line.split(":", 1)[1].strip() for line in
                    build.ptxas_report(name).splitlines()
                    if "registers" in line]
             for name in build.SOURCES}
    for name, lines in ptxas.items():
        print(f"  {name}: {lines}")

    print("[3] kernels against their plain versions", flush=True)
    cases = phase_kernels(torch, Timer(torch))
    print("[4] model parity: card vs CPU, h2o-danube-1.8b width, 2 layers",
          flush=True)
    phase_parity(torch)
    print("[5] serving h2o-danube-1.8b, full width and depth", flush=True)
    launches, serving = phase_serving(torch, card)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
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
         "serving": serving}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
