#!/usr/bin/env python3
"""Time the depth cuts of `chip_smoke.py` on one NVIDIA GPU: each cut
phase at its depth before the cut and after it, in one process.

    python3 depth_ab.py [PHASE ...]

The cuts: phase 12's deepseek-moe-16b with its speculative cell 16a
(DEEPSEEK_LAYERS 8 -> 4; deepseek-v2-lite on both sides) and phase 15's
whisper-large-v3 decoder with 16d (WHISPER_LAYERS 32 -> 8); and a cut
measured and not taken, phase 9's falcon-mamba-7b speculative cell
(SPEC_FALCON_LAYERS 16 -> 8, which saved nothing; phase 9's h2o-danube
cells run on both sides). PHASE names a subset (9, 12, 15; all three by
default). After the kernel build and phase 4's 2-layer parity
run (the process's warm-up), each phase function runs at the cut depth,
then at the old one (a warm-up left over falls on the cut side, so the
saving is not overstated), with every check it makes in `chip_smoke.py`.
Prints each phase's wall seconds at both depths and the saving, and
writes chiprun_out/depth_ab.json. Exits non-zero without a GPU or where a
phase fails.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (phase, chip_smoke constant, depth after the cut, depth before it;
# phase 9's cut is a candidate: chip_smoke.py keeps 16)
CUTS = (("9", "SPEC_FALCON_LAYERS", 8, 16),
        ("12", "DEEPSEEK_LAYERS", 4, 8),
        ("15", "WHISPER_LAYERS", 8, 32))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("depth_ab: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"]).splitlines()[0]
    print(f"card: {card}; build {build.build_all():.1f} s", flush=True)
    t0 = time.perf_counter()
    cs.phase_parity(torch, cs.DANUBE, 100, 128)
    print(f"[depth_ab] warm-up (phase 4): {time.perf_counter() - t0:.1f} s",
          flush=True)
    chosen = sys.argv[1:] or [c[0] for c in CUTS]
    phases = {"9": lambda: cs.phase_speculative(torch, card),
              "12": lambda: cs.phase_moe(torch, card, lambda _: None),
              "15": lambda: cs.phase_whisper(torch, card, lambda _: None)}
    out = {"card": card, "cuts": {}}
    for phase, name, cut, old in CUTS:
        if phase not in chosen:
            continue
        secs = {}
        for depth in (cut, old):
            setattr(cs, name, depth)
            t0 = time.perf_counter()
            phases[phase]()
            torch.cuda.synchronize()
            secs[depth] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
            print(f"[depth_ab] phase {phase}, {name} {depth}: "
                  f"{secs[depth]:.1f} s", flush=True)
        out["cuts"][phase] = dict(constant=name, cut=cut, old=old,
                                  seconds_cut=secs[cut],
                                  seconds_old=secs[old],
                                  saving=secs[old] - secs[cut])
        print(f"[depth_ab] phase {phase}: {name} {old} -> {cut} saves "
              f"{secs[old] - secs[cut]:.1f} s", flush=True)
    total = sum(c["saving"] for c in out["cuts"].values())
    out["saving"] = total
    print(f"[depth_ab] the cuts of phases {', '.join(out['cuts'])} save "
          f"{total:.1f} s ({card})",
          flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "depth_ab.json").write_text(
        json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
