"""Prefix-cached paged serving end-to-end: a chat fleet sharing one system
prompt (the PyTorch port of `examples/serve_prefix.py`).

The canonical shape prefix reuse exists for: every request carries the SAME
long system prompt followed by a short unique user turn. The demo serves
the trace twice through the same packed model: once with the slab pool
(every admission prefills the whole prompt), once with the paged pool +
radix prefix index (`EngineConfig.page_size`): the first admission
prefills and PUBLISHES the system prompt's pages, every later admission
matches them, bumps their refcounts, and prefills only its user suffix.
The demo prints, per run: admitted tokens per second, the prefix hit rate,
how many prompt tokens were never prefilled (and the FLOPs that saved),
the page-pool occupancy, and each request's matched length. It then
verifies greedy token-identity: sharing must not change one token.

  PYTHONPATH=src python examples_torch/serve_prefix.py [--device cuda|cpu]

On the card the paged run's decode reads the KV pages through the page
table in the hand-written paged attention kernel (`paged_flash_attention`);
prefills run flash attention and the dense GEMMs.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.serve import EngineConfig, InferenceEngine, ModelRegistry
from repro_torch.serve.registry import check_device

ARCH = "nemotron-4-340b"           # full-attention transformer smoke config
N_SLOTS, PAGE = 4, 8
SYS_LEN, N_TURNS = 96, 8           # one system prompt, 8 user questions
MAX_LEN = SYS_LEN + 16 + 16


def build_trace(vocab: int):
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, SYS_LEN)
    trace = []
    for i in range(N_TURNS):
        user = rng.integers(0, vocab, int(rng.integers(4, 12)))
        trace.append((np.concatenate([system, user]), 12, i))
    return trace


def serve(model, trace, device, **kw):
    """Replay `trace` twice through one engine; the second replay is the
    timed one. Returns (its tokens, the engine, admitted tok/s, its
    requests)."""
    engine = InferenceEngine(
        model, EngineConfig(n_slots=N_SLOTS, max_len=MAX_LEN,
                            decode_chunk=2, device=device, **kw))
    # the first replay warms: graph captures (one per suffix length on the
    # paged side) AND the radix tree; the timed replay is the steady state
    # a long-running chat fleet lives in
    reqs = [engine.submit(p, g, arrival_step=a) for p, g, a in trace]
    engine.run()
    t0 = time.time()
    off = engine.step_count + 1
    reqs2 = [engine.submit(p, g, arrival_step=a + off) for p, g, a in trace]
    engine.run()
    dt = max(time.time() - t0, 1e-9)
    admitted = sum(len(p) + g for p, g, _ in trace)
    return [list(r.generated) for r in reqs2], engine, admitted / dt, reqs2


def run(device="cuda", *, params=None):
    """Serve the chat trace from the slab and from the page pool.

    params: a dense parameter tree to pack in place of the seed's init."""
    device = check_device(device)
    model = ModelRegistry().load(ARCH, params=params, device=device)
    trace = build_trace(model.cfg.vocab)
    slab, slab_eng, slab_tps, _ = serve(model, trace, device)
    paged, paged_eng, paged_tps, reqs = serve(model, trace, device,
                                              page_size=PAGE)
    return {"name": model.name, "slab_tokens": slab, "paged_tokens": paged,
            "slab_tps": slab_tps, "paged_tps": paged_tps,
            "slab_report": slab_eng.metrics.report(),
            "report": paged_eng.metrics.report(),
            "flops_per_token": 2.0 * model.cfg.active_param_count(),
            "pool_bytes": paged_eng.pool.bytes(),
            "n_usable_pages": paged_eng.pool.n_usable_pages,
            "n_pages": paged_eng.pool.describe()["n_pages"],
            "matched": [(r.id, r.prefix_matched, len(r.prompt))
                        for r in reqs]}


def main(argv=None, **run_kw):
    """Parse the flags, serve, print and assert; `run_kw` goes to `run`."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    check_device(a.device)
    out = run(a.device, **run_kw)
    print(f"[prefix] {out['name']}: {N_TURNS} chat turns sharing a "
          f"{SYS_LEN}-token system prompt (+4-11 token user suffixes)")
    rep = out["report"]
    flops_saved = out["flops_per_token"] * rep["prefill_tokens_skipped"]
    print(f"[prefix] slab : {out['slab_tps']:8.1f} admitted tok/s "
          f"(every prompt fully prefilled)")
    print(f"[prefix] paged: {out['paged_tps']:8.1f} admitted tok/s | hit rate "
          f"{rep['prefix_hit_rate']:.2f} | {int(rep['prefill_tokens_skipped'])}"
          f" prompt toks never prefilled ({rep['prefill_skip_fraction']:.0%}"
          f" of all prompt tokens, ~{flops_saved / 1e9:.2f} GFLOPs) | pages "
          f"{rep['pages_in_use']:.1f}/{out['n_usable_pages']} "
          f"({rep['page_occupancy']:.2f} full)")
    print("[prefix] per-request matched prefix:")
    for rid, matched, n_prompt in out["matched"]:
        print(f"    req{rid}: matched {matched:3d} of "
              f"{n_prompt} prompt tokens"
              + ("  <- first admission publishes the prefix"
                 if matched == 0 else ""))

    assert out["slab_tokens"] == out["paged_tokens"], \
        "prefix sharing changed greedy output!"
    print(f"[prefix] greedy outputs token-identical; "
          f"{out['paged_tps'] / out['slab_tps']:.2f}x admitted throughput "
          f"({out['n_pages']} pages x {PAGE} positions"
          f" vs {N_SLOTS} x {MAX_LEN}-position slab rows)")
    return out


if __name__ == "__main__":
    main()
