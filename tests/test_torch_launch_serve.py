"""Port parity, the serving CLI (`python -m repro_torch.launch.serve`):
`main(argv)` on the CPU for the default flags, `--static`,
`--page-size 8`, `--speculate 2`, `--replicas 2` and `--trace-out`, its
printed tokens against the port's engine (or router) built directly with
the same arguments; its `[serve]` lines against the JAX CLI's
(`repro.launch.serve.main` under a patched `sys.argv`) line for line, the
numbers and the registry name aside (each framework seeds its own weights,
so tokens are not compared); the refused flags naming their ROADMAP.md
items, and `--processes 2` serving through the fleet; `--mesh 2,2
--dry-run`'s printed specs against the JAX package's spec functions on
an abstract (2, 2) mesh; and a module that imports no JAX."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_serve_parity import NEMOTRON, P, needs_jax, torch
from torch_serve_parity import one_torch_thread  # noqa: F401 (autouse)

from repro_torch.core.kratos import KratosSpec
from repro_torch.launch import serve as cli

SMALL = ["--device", "cpu", "--requests", "3", "--prompt-len", "8",
         "--gen", "5", "--slots", "2"]
ROOT = Path(__file__).resolve().parent.parent


def _printed_tokens(out):
    """The `  req<id>: [...] ...` lines' token lists, in order."""
    return [[int(t) for t in m.group(1).split()]
            for m in re.finditer(r"^  req\d+: \[([^\]]*)\] \.\.\.$", out,
                                 re.M)]


def _direct(arch=cli.parse_args([]).arch, requests=3, prompt_len=8, gen=5,
            slots=2, static=False, replicas=1, **cfg_kw):
    """The CLI's run built by hand: registry load at the CLI's default
    spec (block 8), the seeded trace, an engine or a router."""
    draft = P.DraftSpec.from_args(8, 0.0, 0) if cfg_kw.get("speculate") \
        else None
    m = P.ModelRegistry().load(arch, KratosSpec(bk=8, bn=8), seed=0,
                               draft_spec=draft, device="cpu")
    cfg = P.EngineConfig(n_slots=slots, seed=0, device="cpu",
                         max_len=m.cfg.n_img_tokens + prompt_len + gen + 8,
                         **cfg_kw)
    rng = np.random.default_rng(0)
    traffic = []
    for i in range(requests):
        s0 = max(1, prompt_len + int(rng.integers(-4, 5)))
        traffic.append((rng.integers(0, m.cfg.vocab, s0), i))
    sched = (lambda i: P.StaticScheduler()) if static else None
    if replicas > 1:
        front = P.ReplicaRouter.build(m, cfg, replicas,
                                      scheduler_factory=sched)
    else:
        front = P.InferenceEngine(m, cfg,
                                  scheduler=sched(0) if sched else None)
    reqs = [front.submit(p, gen, arrival_step=at) for p, at in traffic]
    front.run()
    return [list(r.generated)[:16] for r in reqs[:2]]


@pytest.mark.parametrize("flags,kw", [
    ([], {}),
    (["--static"], dict(static=True)),
    (["--page-size", "8", "--decode-chunk", "2"],
     dict(page_size=8, decode_chunk=2)),
    (["--arch", NEMOTRON, "--speculate", "2"],
     dict(arch=NEMOTRON, speculate=2)),
    (["--replicas", "2", "--static"], dict(replicas=2, static=True))])
def test_cli_tokens_equal_the_engine(capsys, flags, kw):
    """The CLI's printed tokens (first 2 requests) equal the port's engine
    or router run directly with the same arguments, and the report line
    names the scheduler and the backend (or the router)."""
    cli.main(SMALL + flags)
    out = capsys.readouterr().out
    assert _printed_tokens(out) == _direct(**kw)
    if kw.get("replicas"):
        assert "\n[serve] router 2 replicas" in out
    else:
        sched = "static" if kw.get("static") else "continuous"
        assert f"\n[serve] scheduler={sched} backend=local " in out


def test_cli_trace_out(capsys, tmp_path):
    """--trace-out writes the tracer's JSONL stream (a meta line, then
    the events) and says so."""
    path = tmp_path / "t.jsonl"
    cli.main(SMALL + ["--trace-out", str(path)])
    out = capsys.readouterr().out
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert f"[serve] trace: {len(lines) - 1} events -> {path}" in out
    assert lines[0]["ev"] == "meta"
    assert {"submit", "decode", "finish"} <= {e["ev"] for e in lines}


def _shape(out):
    """The `[serve]` lines with numbers, the registry name and the trace
    path replaced: what must match between the two CLIs."""
    out = re.sub(r"(\[serve\] )\S+: (\d+ packed)", r"\1<name>: \2", out)
    out = re.sub(r"-> \S+", "-> <path>", out)
    return [re.sub(r"-?\d+(\.\d+)?(e[-+]?\d+)?", "#", line)
            for line in out.splitlines() if line.startswith("[serve]")]


@needs_jax
@pytest.mark.parametrize("flags", [
    ["--static", "--page-size", "8", "--trace-out", "{tmp}/t.jsonl"],
    ["--arch", NEMOTRON, "--speculate", "2", "--replicas", "2"]])
def test_cli_lines_match_jax(capsys, monkeypatch, tmp_path, flags):
    """The port's `[serve]` lines have the JAX CLI's prefixes and fields
    for the same flags."""
    from repro.launch import serve as jcli
    flags = [f.format(tmp=tmp_path) for f in flags]
    common = ["--requests", "3", "--prompt-len", "8", "--gen", "5",
              "--slots", "2"]
    monkeypatch.setattr(sys, "argv", ["serve"] + common + flags)
    jcli.main()
    want = _shape(capsys.readouterr().out)
    cli.main(["--device", "cpu"] + common + flags)
    got = _shape(capsys.readouterr().out)
    assert got == want and len(got) >= 2


@pytest.mark.parametrize("flags,exc,match", [
    (["--mesh", "2,2"], None, "backend=sharded"),
    (["--coordinator", "127.0.0.1:{port}", "--num-processes", "1"], None,
     "backend=local"),
    (["--process-id", "1"], SystemExit,
     "--process-id 1 out of range for --num-processes 1"),
    (["--processes", "2", "--requests", "4", "--gen", "4"], None,
     "[serve] fleet 2 processes:"),
    (["--dry-run"], SystemExit, "--dry-run needs --mesh data,model")])
def test_cli_refusals_name_their_items(capfd, monkeypatch, flags, exc,
                                       match):
    """What cannot run is refused before any weights load; `--mesh 2,2`
    serves through four gloo ranks (spawned by the launcher) with the
    greedy tokens of the same command without it, `--coordinator` joins a
    process group (of one rank here) and serves, and `--processes 2`
    serves through two worker processes."""
    if exc is not None:
        with pytest.raises(exc, match=match):
            cli.main(SMALL + flags)
        return
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # each worker's threads
    from repro_torch.launch.mesh import free_port
    flags = [f.format(port=free_port()) for f in flags]
    cli.main(SMALL + flags)
    out = capfd.readouterr().out
    assert match in out, out
    assert len(_printed_tokens(out)) == 2
    if flags[0] == "--processes":
        assert "failovers 0" in out
    elif flags[0] == "--mesh":
        cli.main(SMALL)
        assert _printed_tokens(capfd.readouterr().out) == \
            _printed_tokens(out)
    else:
        import torch.distributed as dist
        dist.destroy_process_group()


_SPEC_LINE = re.compile(r"^    \[(\d+)\]\['(\w+)'\]\s+(?:paged|resident)?\s*"
                        r"PartitionSpec(\(.*\))$")


@needs_jax
@pytest.mark.parametrize("page", [[], ["--page-size", "8"]],
                         ids=["slab", "paged"])
def test_cli_dry_run_prints_jax_specs(capsys, page):
    """`--mesh 2,2 --dry-run` prints, without joining a serving group,
    every slab or page-store leaf's spec and every decode-state vector's,
    each the JAX package's for the same (2, 2) mesh; and rank 0's dispatch
    counted on the dry-run's fake group of 4 ranks, in the JAX launcher's
    line: one all-gather of the heads a layer, and on the slab one of the
    token block over 'data'."""
    import ast

    import jax
    from jax.sharding import AbstractMesh
    from repro import configs as JC
    from repro.distributed import sharding as JSH, steps as JST
    from repro.models import transformer as JT
    from repro.serve.paging import PageLayout
    cli.main(SMALL + ["--mesh", "2,2", "--dry-run"] + page)
    out = capsys.readouterr().out
    cfg = JC.get_smoke("h2o-danube-1.8b")
    mesh = AbstractMesh((2, 2), ("data", "model"))
    slots, max_len = 2, 8 + 5 + 8
    caches = jax.eval_shape(lambda: JT.make_caches(cfg, slots, max_len))
    if page:
        layout = PageLayout(cfg, slots, max_len, 8)
        specs = JSH.page_pspecs(caches, layout, mesh,
                                slots * layout.pp + 1)
        want = {s.name.rsplit(".", 1)[1]: tuple(p)[1:]
                for s, p in zip(layout.specs, specs)}
    else:
        flat = jax.tree_util.tree_leaves_with_path(
            JSH.cache_pspecs(caches, mesh, slots, slab=True),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        want = {str(path[-1].key): tuple(p)[1:] for path, p in flat}
    got = [_SPEC_LINE.match(line).groups() for line in out.splitlines()
           if _SPEC_LINE.match(line)]
    assert len(got) == cfg.n_layers * 2, out
    for _, name, spec in got:
        assert ast.literal_eval(spec) == want[name], (name, spec)
    state = JST.decode_state_pspecs(mesh, slots)
    for k, spec in state.items():
        assert re.search(rf"^    {k} +PartitionSpec{re.escape(repr(tuple(spec)))}$",
                         out, re.M), (k, out)
    assert re.search(r"per device: 1 of 2 slot rows" if not page
                     else r"per device: 2 of 2 slot rows", out), out
    gathers = cfg.n_layers + (0 if page else 1)
    assert re.search(r"^\[dry-run\] (paged )?decode step \(K=1.*\): \S+ flops, "
                     r"\S+ B touched, \S+ B wire, collectives "
                     rf"\{{'all-gather': {gathers}\}}$", out, re.M), out


def test_cli_card_by_default():
    """Without a GPU the default device is refused with the registry's
    error; there is no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--requests", "1"])


def test_cli_imports_no_jax():
    """The CLI module imports neither JAX nor the JAX package."""
    code = ("import sys, repro_torch.launch.serve; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
