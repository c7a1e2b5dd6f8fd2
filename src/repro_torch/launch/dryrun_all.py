"""Batch dry-run: every (arch x shape x mesh) cell as a subprocess
(port of `repro.launch.dryrun_all`).

Each cell runs in a fresh `python -m repro_torch.launch.dryrun` process, so
the fake process group's size (256 or 512 ranks) and the memory of the
count are isolated; results append to a JSONL ledger and finished cells
are skipped on re-run (resumable). A cell that fails or outlives
--timeout appends an `error` or `timeout` line and is run again next time.
Host only: no card is needed. This process itself imports torch only to
list the grid's shapes when no --shape is given.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_all \
      [--out results/dryrun_torch.jsonl] [--arch A]... [--shape S]... \
      [--single-pod-only] [--timeout SECONDS]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# cheapest-first so early failures surface fast and partial ledgers are useful
ARCH_ORDER = (
    "h2o_danube_1_8b", "minicpm3_4b", "llava_next_mistral_7b",
    "falcon_mamba_7b", "deepseek_moe_16b", "deepseek_v2_lite_16b",
    "whisper_large_v3", "gemma2_27b", "jamba_v0_1_52b", "nemotron_4_340b",
)


def done_keys(path: str):
    keys = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("status") in ("ok", "skipped"):
                    keys.add((r["arch"], r["shape"], r["multi_pod"]))
    return keys


def _append(path: str, rec) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--timeout", type=int, default=3000)
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    archs = args.arch or list(ARCH_ORDER)
    if args.shape:
        shapes = args.shape
    else:
        from repro_torch.launch import shapes as SP
        shapes = [s.name for s in SP.SHAPES]
    meshes = [False] if args.single_pod_only else [False, True]

    done = done_keys(args.out)
    todo = []
    for mp in meshes:               # mesh-major: single-pod table completes first
        for shape in shapes:
            for arch in archs:
                if (arch, shape, mp) not in done:
                    todo.append((arch, shape, mp))
    print(f"{len(todo)} cells to run ({len(done)} already done)", flush=True)

    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    for i, (arch, shape, mp) in enumerate(todo):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", args.out]
        if mp:
            cmd.append("--multi-pod")
        t0 = time.time()
        print(f"[{i+1}/{len(todo)}] {arch} {shape} multi_pod={mp} ...",
              flush=True)
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout, env=env)
            if p.returncode != 0:
                _append(args.out, {"arch": arch, "shape": shape,
                                   "multi_pod": mp, "status": "error",
                                   "error": (p.stderr or p.stdout)[-2000:]})
                print(f"   ERROR ({time.time()-t0:.0f}s): "
                      f"{(p.stderr or '')[-300:]}", flush=True)
            else:
                print(f"   ok ({time.time()-t0:.0f}s)", flush=True)
        except subprocess.TimeoutExpired:
            _append(args.out, {"arch": arch, "shape": shape, "multi_pod": mp,
                               "status": "timeout"})
            print(f"   TIMEOUT after {args.timeout}s", flush=True)


if __name__ == "__main__":
    main()
