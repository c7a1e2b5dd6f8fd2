"""Replica-routed serving: one front-end over N engine replicas (the
PyTorch port of `examples/serve_router.py`).

Builds two continuous-batching engine replicas with BOUNDED waiting deques
(EngineConfig.max_waiting) and drives a bursty trace through
`serve.ReplicaRouter`: least-loaded admission spreads arrivals, a replica
whose deque fills REJECTS (counted, raising EngineSaturated) and the router
spills the request to its sibling or parks it in the overflow deque, and
the per-step rebalancer moves tail-of-queue requests off a backed-up
replica. Aggregate metrics pool both replicas (fleet-level p99, not a mean
of per-replica p99s).

The JAX example scales the same script out by giving each replica a
disjoint data-submesh (ShardedBackend over `launch.mesh.replica_meshes`).
The port's replicas share one card through LocalBackend; its sharded form
(ShardedBackend on the same submeshes, one process a rank) runs from the
serve launcher (`python -m repro_torch.launch.serve --mesh 2,2 --replicas
2`).

  PYTHONPATH=src python examples_torch/serve_router.py [--device cuda|cpu] \
      [--full]

`--full` serves h2o-danube-1.8b's published config (full width and depth)
where the default is the smoke config. On the card every projection runs
the block-sparse int8 kernel (`bsr_quant_matmul`) and every prefill flash
attention.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core.kratos import KratosSpec
from repro_torch.serve import EngineConfig, ModelRegistry, ReplicaRouter
from repro_torch.serve.registry import check_device

ARCH = "h2o-danube-1.8b"
SPEC = KratosSpec(sparsity=0.5, bits=8, bk=8, bn=8)
N_REPLICAS, N_SLOTS, MAX_WAITING = 2, 2, 2
# (prompt_len, gen_len, arrival_step): a burst at t=0 that MUST spill
# (> one replica's slots + deque), then a trickle.
TRACE = [(8, 12, 0), (6, 10, 0), (10, 8, 0), (7, 14, 0), (9, 6, 0),
         (5, 12, 0), (8, 10, 4), (6, 8, 8)]


def run(device="cuda", *, full=False, params=None):
    """Route TRACE over N_REPLICAS engines of one packed model.

    full: the published config in place of the smoke one. params: a dense
    parameter tree (of that config) to pack in place of the seed's init."""
    device = check_device(device)
    rng = np.random.default_rng(0)
    model = ModelRegistry().load(ARCH, SPEC, params=params, smoke=not full,
                                 device=device)
    router = ReplicaRouter.build(
        model,
        EngineConfig(n_slots=N_SLOTS, max_len=48, decode_chunk=2,
                     max_waiting=MAX_WAITING, device=device),
        N_REPLICAS)
    reqs = [router.submit(rng.integers(0, model.cfg.vocab, s0), gen,
                          arrival_step=at) for s0, gen, at in TRACE]
    router.run()
    return {"name": model.name, "report": router.report(),
            "format_report": router.format_report(),
            "tokens": [list(r.generated) for r in reqs],
            "per_replica": [int(e.metrics.tokens_generated)
                            for e in router.replicas]}


def main(argv=None, **run_kw):
    """Parse the flags, serve, print and assert; `run_kw` goes to `run`."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the published config at full width and depth "
                         "(default: the reduced smoke config)")
    a = ap.parse_args(argv)
    check_device(a.device)
    out = run(a.device, full=a.full, **run_kw)
    print(f"router: {out['format_report']}")
    per_replica = out["per_replica"]
    print(f"tokens per replica: {per_replica} "
          f"(imbalance {max(per_replica) / max(1, min(per_replica)):.2f}x)")
    assert all(len(t) == g for t, (_, g, _) in zip(out["tokens"], TRACE))
    assert out["report"]["requests_completed"] == len(TRACE)
    print("serve_router OK")
    return out


if __name__ == "__main__":
    main()
