"""Speculative decode end-to-end: plain vs self-draft serving, one config
(the PyTorch port of `examples/serve_speculative.py`).

The same trace is served twice through the same packed target: once with
the plain device-resident loop, once speculatively with a SELF-DRAFT (the
target's weights re-packed at 8-bit through core/quantize, derived by
`registry.load(..., draft_spec=...)`). The demo prints, per run: tokens
per decode dispatch (the host-sync economy speculation buys), the fleet
acceptance rate and rollback count, the draft/verify FLOP ratio, and the
PER-SLOT acceptance rates: the tuning signal for picking a draft point
(more sparsity / fewer layers = cheaper draft, lower acceptance). It then
verifies greedy token-identity: speculation must not change one token.

  PYTHONPATH=src python examples_torch/serve_speculative.py [--device cuda|cpu]

On the card the target's projections run the dense GEMM kernel
(`dense_matmul`) and the w8 draft's the weight-only int8 kernel
(`quant_matmul`), each propose-then-verify cycle one CUDA graph replay.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.serve import (DraftSpec, EngineConfig, InferenceEngine,
                               ModelRegistry)
from repro_torch.serve.registry import check_device

ARCH = "nemotron-4-340b"           # full-attention transformer smoke config
DRAFT = DraftSpec(bits=8)          # highest-fidelity self-draft
K = 4                              # draft tokens per propose-verify dispatch
N_SLOTS, MAX_LEN = 4, 64
# (prompt_len, gen_len, arrival_step): deliberately ragged
TRACE = [(12, 16, 0), (6, 20, 0), (9, 12, 2), (15, 18, 4), (5, 14, 7)]


def serve(model, speculate: int, device):
    rng = np.random.default_rng(0)
    engine = InferenceEngine(
        model, EngineConfig(n_slots=N_SLOTS, max_len=MAX_LEN,
                            speculate=speculate, device=device))
    reqs = [engine.submit(rng.integers(0, model.cfg.vocab, p), g,
                          arrival_step=a) for p, g, a in TRACE]
    engine.run()
    return [list(r.generated) for r in reqs], engine


def run(device="cuda", *, params=None):
    """Serve TRACE plainly and with the K-token self-draft.

    params: a dense parameter tree to pack in place of the seed's init."""
    device = check_device(device)
    model = ModelRegistry().load(ARCH, params=params, draft_spec=DRAFT,
                                 device=device)
    plain, plain_eng = serve(model, 0, device)
    spec, spec_eng = serve(model, K, device)
    return {"name": model.name, "draft_packed": model.draft_packed,
            "draft_cost_fraction": model.draft_cost_fraction(),
            "plain_tokens": plain, "spec_tokens": spec,
            "plain_report": plain_eng.metrics.report(),
            "spec_report": spec_eng.metrics.report(),
            "spec_dispatches": spec_eng.metrics.spec_dispatches,
            "slot_acceptance": {s: list(a) for s, a in
                                spec_eng.metrics.slot_acceptance.items()}}


def main(argv=None, **run_kw):
    """Parse the flags, serve, print and assert; `run_kw` goes to `run`."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    check_device(a.device)
    out = run(a.device, **run_kw)
    print(f"[spec] {out['name']}: draft packs {out['draft_packed']} "
          f"projections at {DRAFT.tag}, draft/verify flops "
          f"{out['draft_cost_fraction']:.2f}")
    for label, rep, spec in (("plain", out["plain_report"], False),
                             (f"spec K={K}", out["spec_report"],
                              out["spec_dispatches"] > 0)):
        print(f"[spec] {label:9s} {int(rep['tokens_generated'])} toks over "
              f"{int(rep['decode_steps'])} dispatches = "
              f"{rep['tokens_per_dispatch']:.2f} tok/dispatch"
              + (f" | accept {rep['acceptance_rate']:.3f} "
                 f"({int(rep['draft_rolled_back'])} rolled back)"
                 if spec else ""))

    print("[spec] per-slot acceptance:")
    for slot in sorted(out["slot_acceptance"]):
        acc, prop = out["slot_acceptance"][slot]
        print(f"    slot {slot}: {acc}/{prop} = {acc / max(1, prop):.3f}")

    assert out["plain_tokens"] == out["spec_tokens"], \
        "speculation changed greedy output!"
    ratio = (out["spec_report"]["tokens_per_dispatch"]
             / out["plain_report"]["tokens_per_dispatch"])
    print(f"[spec] greedy outputs token-identical; {ratio:.2f}x tokens per "
          "dispatch vs the plain loop")
    return out


if __name__ == "__main__":
    main()
