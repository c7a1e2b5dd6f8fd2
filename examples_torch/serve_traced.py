"""Traced serving: one run, three views of the same events (the PyTorch
port of `examples/serve_traced.py`).

Runs a mixed trace through the continuous-batching engine with the serve
tracer on, then shows what tracing buys you over the summary line:

  1. a per-request SPAN TIMELINE (queue -> ttft -> decode -> finish) in
     both clocks: the deterministic engine-step clock benchmarks gate on
     and monotonic wall milliseconds;
  2. a reconciliation against `ServeMetrics`: the tracer is a strictly
     richer view of the same events, so its step-clock numbers match the
     metrics records EXACTLY (asserted here);
  3. a Chrome trace-event JSON: open <out-dir>/serve.chrome.json in
     chrome://tracing or https://ui.perfetto.dev to see one track per
     decode slot, the admission queue, the dispatch lane, and the batch
     occupancy counter.

  PYTHONPATH=src python examples_torch/serve_traced.py [--device cuda|cpu] \
      [--full] [--out-dir results/traced_torch]

`--full` serves h2o-danube-1.8b's published config (full width and depth)
where the default is the smoke config. On the card every projection runs
the block-sparse int8 kernel (`bsr_quant_matmul`) and every prefill flash
attention.
"""

import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core.kratos import KratosSpec
from repro_torch.serve import (EngineConfig, InferenceEngine, ModelRegistry,
                               TraceConfig)
from repro_torch.serve.registry import check_device

ARCH = "h2o-danube-1.8b"
SPEC = KratosSpec(sparsity=0.5, bits=8, bk=8, bn=8)
OUT_DIR = "results/traced_torch"
# (prompt_len, gen_len, arrival_step): ragged on purpose so the spans show
# queueing, staggered admission, and slots turning over mid-run
TRACE = [(20, 16, 0), (8, 24, 0), (14, 10, 2), (24, 12, 4), (6, 20, 6),
         (16, 8, 9)]


def run(device="cuda", *, full=False, params=None, out_dir=OUT_DIR):
    """Serve TRACE traced, then export the JSONL and Chrome traces under
    `out_dir`.

    full: the published config in place of the smoke one. params: a dense
    parameter tree (of that config) to pack in place of the seed's init."""
    device = check_device(device)
    jsonl = os.path.join(out_dir, "serve.trace.jsonl")
    chrome = os.path.join(out_dir, "serve.chrome.json")
    rng = np.random.default_rng(0)
    model = ModelRegistry().load(ARCH, SPEC, params=params, smoke=not full,
                                 device=device)
    engine = InferenceEngine(model, EngineConfig(
        n_slots=4, max_len=64, decode_chunk=4, device=device,
        trace=TraceConfig(out=jsonl, chrome=chrome)))
    reqs = [engine.submit(rng.integers(0, model.cfg.vocab, s0), gen,
                          arrival_step=at) for s0, gen, at in TRACE]
    engine.run()
    spans = engine.trace.request_spans()
    engine.trace.export()                 # writes TraceConfig.out + .chrome
    return {"name": model.name, "report": engine.metrics.report(),
            "format_report": engine.metrics.format_report(),
            # arrived at step 4: it queued
            "timeline": engine.trace.format_timeline(reqs[3].id),
            "tokens": [list(r.generated) for r in reqs],
            "spans": [spans[r.id] for r in reqs],
            "records": [engine.metrics.records[r.id] for r in reqs],
            "n_events": len(engine.trace.events),
            "dropped": engine.trace.dropped, "jsonl": jsonl,
            "chrome": chrome}


def main(argv=None, **run_kw):
    """Parse the flags, serve, print and assert; `run_kw` goes to `run`."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the published config at full width and depth "
                         "(default: the reduced smoke config)")
    ap.add_argument("--out-dir", default=OUT_DIR,
                    help="where the JSONL and Chrome exports go")
    a = ap.parse_args(argv)
    check_device(a.device)
    out = run(a.device, full=a.full, out_dir=a.out_dir, **run_kw)
    print(out["format_report"], "\n")

    # -- 1. one request's span timeline, both clocks ------------------------
    print(out["timeline"], "\n")

    # -- 2. spans reconcile exactly with ServeMetrics -----------------------
    for s, rec, tokens in zip(out["spans"], out["records"], out["tokens"]):
        assert s["ttft_steps"] == rec.first_token_step - rec.arrival_step
        assert s["latency_steps"] == rec.finish_step - rec.arrival_step
        assert s["tokens"] == rec.n_generated == len(tokens)
    print(f"spans reconcile with ServeMetrics for all {len(out['spans'])} "
          "requests (ttft/latency steps + token counts identical)")

    # -- 3. exports ---------------------------------------------------------
    print(f"wrote {out['jsonl']} ({out['n_events']} events, "
          f"{out['dropped']} dropped)")
    print(f"wrote {out['chrome']} — open in chrome://tracing or "
          "https://ui.perfetto.dev")
    return out


if __name__ == "__main__":
    main()
