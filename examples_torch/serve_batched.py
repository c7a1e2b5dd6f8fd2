"""Continuous-batched serving across mixed architectures (the PyTorch port
of `examples/serve_batched.py`).

Serves three very different backbones (SWA dense, MLA+MoE, pure SSM)
through the SAME continuous-batching engine: requests with staggered
arrivals and unequal prompt/generation lengths join and leave the decode
slab mid-flight, weights are packed once at load (`kratos.pack` via the
serve registry), and per-arch cache-slab sizes are printed: the reason
long contexts are feasible for SSM/SWA archs (O(1) / O(window) state per
slot) and not for full-attention ones.

  PYTHONPATH=src python examples_torch/serve_batched.py [--device cuda|cpu]

On the card every decode dispatch replays a CUDA graph of the hand-written
kernels: block-sparse int8 projections (`bsr_quant_matmul`), the
expert-batched block-sparse product for deepseek-v2-lite's routed experts
(`bsr_matmul_experts`), flash attention in h2o-danube's prefill and the
selective scan in falcon-mamba's.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core.kratos import KratosSpec
from repro_torch.serve import EngineConfig, InferenceEngine, ModelRegistry
from repro_torch.serve.registry import check_device

ARCHS = ("h2o-danube-1.8b", "deepseek-v2-lite-16b", "falcon-mamba-7b")
SPEC = KratosSpec(sparsity=0.5, bits=8, bk=8, bn=8)   # the paper's headline
N_SLOTS, MAX_LEN = 4, 64
DECODE_CHUNK = 4   # K micro-steps per device-resident dispatch (1 sync per K)
# (prompt_len, gen_len, arrival_step): deliberately ragged
TRACE = [(20, 16, 0), (8, 24, 0), (14, 10, 2), (24, 12, 4), (6, 20, 6),
         (16, 8, 9)]


def run(device="cuda", *, params=None):
    """Serve TRACE on each of ARCHS (smoke configs) under SPEC.

    params: {arch: dense parameter tree} to pack in place of the seed's
    init, for any of ARCHS."""
    device = check_device(device)
    params = params or {}
    rng = np.random.default_rng(0)
    registry = ModelRegistry()
    out = {}
    for arch in ARCHS:
        model = registry.load(arch, SPEC, params=params.get(arch),
                              device=device)
        engine = InferenceEngine(
            model, EngineConfig(n_slots=N_SLOTS, max_len=MAX_LEN,
                                decode_chunk=DECODE_CHUNK, device=device))
        cfg = model.cfg
        t0 = time.time()
        reqs = [engine.submit(rng.integers(0, cfg.vocab, s0), gen,
                              arrival_step=at) for s0, gen, at in TRACE]
        engine.run()
        kind = ("SSM: O(1) state" if cfg.is_ssm else
                f"SWA: O(window={cfg.window})" if cfg.window else
                f"MLA: O(S x {cfg.kv_lora_rank + cfg.qk_rope_dim})"
                if cfg.mla else "full: O(S x 2·H·dh)")
        out[arch] = {"seconds": time.time() - t0,
                     "report": engine.metrics.report(),
                     "tokens": [list(r.generated) for r in reqs],
                     "pool_bytes": engine.pool.bytes(), "kind": kind,
                     "compression": model.compression}
    return out


def main(argv=None, **run_kw):
    """Parse the flags, serve, print; `run_kw` goes to `run`."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    check_device(a.device)
    out = run(a.device, **run_kw)
    for arch, r in out.items():
        rep = r["report"]
        print(f"{arch:24s} {int(rep['tokens_generated'])} toks in "
              f"{r['seconds']:5.1f}s"
              f" | {rep['tokens_per_step']:.2f} tok/step,"
              f" {rep['host_syncs_per_token']:.2f} syncs/tok,"
              f" occupancy {rep['mean_occupancy']:.2f}"
              f" | slab {r['pool_bytes'] / 1e6:6.2f} MB"
              f"/{N_SLOTS} slots ({r['kind']})"
              f" | packed {r['compression']:.1f}x"
              f" | sample: {np.asarray(r['tokens'][0])[:6]}")
    print("serve_batched OK")
    return out


if __name__ == "__main__":
    main()
