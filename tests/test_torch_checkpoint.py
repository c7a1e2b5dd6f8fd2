"""Port parity, checkpoints and the crash-safe loop: the port's checkpoint
in the JAX package's layout, read by `repro.checkpoint.manager` into a JAX
train state and the other way round (each continued 2 steps against 4
uninterrupted ones), `convert` / `to_reference` inverses on every arch's
smoke tree, and the loop's fault-tolerance cases of
`tests/test_fault_tolerance.py` on the port alone (crash and resume bit
for bit, orphaned tmp directories, retention, async against blocking), and
the train CLI in a subprocess (it learns; a rerun after --fail-at
resumes)."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as JC
from repro.checkpoint import manager as JM
from repro.distributed import steps as JST
from repro.models import transformer as JT
from repro.optim import adamw as JO
from repro_torch import configs as PC
from repro_torch import tree as tu
from repro_torch.checkpoint import convert as CV
from repro_torch.checkpoint import manager as PM
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.distributed import steps as PST
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw as PO
from repro_torch.train import SimulatedFailure, TrainLoopConfig, run_training

DANUBE = "h2o_danube_1_8b"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jflat(tree):
    return {k: np.asarray(v) for k, v in JM._flatten_with_paths(tree).items()}


def _pflat(state, cfg):
    return {k: v.numpy() for k, v in tu.flatten_with_paths(
        CV.state_to_reference(state, cfg)).items()}


def _assert_states(got, want, atol):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


def _danube_run():
    """(JAX cfg, port cfg, JAX init state, port init state carried from
    it, jitted JAX step, port step, 4 batches)."""
    jcfg, pcfg = JC.get_smoke(DANUBE), PC.get_smoke(DANUBE)
    jopt = JO.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=4)
    popt = PO.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=4)
    jst = JST.init_train_state(jax.random.PRNGKey(0), jcfg, jopt)
    pst = CV.convert_state(_jflat(jst), pcfg)
    pipe = make_pipeline(DataConfig(vocab=jcfg.vocab, batch=2, seq=16))
    bs = [pipe.batch(s) for s in range(4)]
    return (jcfg, pcfg, jst, pst, jax.jit(JST.make_train_step(jcfg, jopt)),
            PST.make_train_step(pcfg, popt), bs)


def test_checkpoints_cross_both_ways(tmp_path):
    """Port 2 steps, saved; JAX restores it into its own init state and
    trains 2 more: equal to 4 port steps. JAX 2 steps, saved; the port
    restores it and trains 2 more: equal to 4 JAX steps. atol 2e-5."""
    jcfg, pcfg, jst0, pst, jstep, pstep, bs = _danube_run()
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in bs]
    pb = [{k: torch.from_numpy(v) for k, v in b.items()} for b in bs]
    for b in pb[:2]:
        pst, _ = pstep(pst, b)
    pm = PM.CheckpointManager(str(tmp_path / "port"))
    PM.save_train_state(pm, 2, pst, pcfg)
    jst, step = JM.CheckpointManager(str(tmp_path / "port")).restore(jst0)
    assert step == 2 and int(jst["step"]) == 2
    for b in jb[2:]:
        jst, _ = jstep(jst, b)
    for b in pb[2:]:
        pst, _ = pstep(pst, b)
    _assert_states(_pflat(pst, pcfg), _jflat(jst), 2e-5)

    jst = jst0
    for b in jb[:2]:
        jst, _ = jstep(jst, b)
    JM.CheckpointManager(str(tmp_path / "jax")).save(2, jst)
    like = PST.init_train_state(0, pcfg, PO.OptimizerConfig(), device="cpu")
    pst, step = PM.restore_train_state(
        PM.CheckpointManager(str(tmp_path / "jax")), like, pcfg)
    assert step == 2 and int(pst["step"]) == 2
    for b in pb[2:]:
        pst, _ = pstep(pst, b)
    for b in jb[2:]:
        jst, _ = jstep(jst, b)
    _assert_states(_pflat(pst, pcfg), _jflat(jst), 2e-5)


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_convert_and_to_reference_are_inverses(arch):
    """convert(to_reference(tree)) == tree exactly, and to_reference of a
    carried tree is the JAX tree, key for key and bit for bit: gemma2's
    interleaved slots, jamba's 8-slot block, MoE stacks, MLA, whisper's
    encoder, the prelude layers. Whisper's pos_table is in no
    checkpoint."""
    jcfg, pcfg = JC.get_smoke(arch), PC.get_smoke(arch)
    jflat = _jflat(JT.init(jax.random.PRNGKey(0), jcfg))
    params = CV.convert(jflat, pcfg.n_layers)
    back = {k: v.numpy() for k, v in
            tu.flatten_with_paths(CV.to_reference(params, pcfg)).items()}
    assert set(back) == set(jflat)
    for k in jflat:
        np.testing.assert_array_equal(back[k], jflat[k], err_msg=k)
    again = CV.convert(back, pcfg.n_layers)
    for (k1, a), (k2, b) in zip(tu.items(params), tu.items(again)):
        assert k1 == k2 and torch.equal(a, b), k1
    # the port's own init has the JAX tree's keys too (pos_table dropped)
    own = PT.init(pcfg, device="cpu")
    assert ("pos_table" in own) == bool(pcfg.enc_dec)
    keys = set(tu.flatten_with_paths(CV.to_reference(own, pcfg)))
    assert keys == set(jflat)
    assert not any("pos_table" in k for k in keys)


def _setup(tmp_path=None, steps=9, fail_at=None, ckpt_every=3,
           async_checkpoint=False):
    cfg = PC.get_smoke(DANUBE)
    opt = PO.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    data = DataConfig(vocab=cfg.vocab, batch=2, seq=16, seed=5)
    loop = TrainLoopConfig(
        steps=steps, ckpt_dir=str(tmp_path) if tmp_path else None,
        ckpt_every=ckpt_every, log_every=0,
        async_checkpoint=async_checkpoint, fail_at_step=fail_at)
    return cfg, opt, data, loop


@pytest.mark.parametrize("async_checkpoint", [False, True],
                         ids=["blocking", "async"])
def test_crash_resume_bitwise_equals_uninterrupted(tmp_path,
                                                   async_checkpoint):
    """Fail at step 5, resume from the checkpoint at 3: the final params
    and AdamW state equal a never-failed run bit for bit on the CPU."""
    ref = run_training(*_setup(None), device="cpu")
    ck = tmp_path / "ck"
    with pytest.raises(SimulatedFailure):
        run_training(*_setup(ck, fail_at=5,
                             async_checkpoint=async_checkpoint),
                     device="cpu")
    assert PM.CheckpointManager(str(ck)).latest_step() == 3
    out = run_training(*_setup(ck, async_checkpoint=async_checkpoint),
                       device="cpu")
    assert out["resumed_from"] == 3
    assert [h["step"] for h in out["history"]] == list(range(4, 10))
    assert [h["loss"] for h in out["history"]] == \
        [h["loss"] for h in ref["history"][3:]]
    for (k, a), (_, b) in zip(tu.items(ref["state"]), tu.items(out["state"])):
        assert torch.equal(a, b), k


def test_checkpoint_atomicity_orphan_tmp_ignored(tmp_path):
    mgr = PM.CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(4.0), "b": {"c": torch.ones(2, 2)}}
    mgr.save(1, tree)
    os.makedirs(tmp_path / "tmp-99")
    (tmp_path / "tmp-99" / "arrays.npz").write_bytes(b"garbage")
    os.makedirs(tmp_path / "step-50")           # no manifest: not a checkpoint
    assert mgr.latest_step() == 1
    restored, step = mgr.restore(tree)
    assert step == 1
    assert torch.equal(restored["a"], tree["a"])
    assert PM.load_metadata(mgr.path(1))["step"] == 1


def test_checkpoint_retention_gc(tmp_path):
    mgr = PM.CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    steps = sorted(int(n.split("-")[1]) for n in os.listdir(tmp_path)
                   if n.startswith("step-"))
    assert steps == [3, 4]


def test_async_checkpoint_snapshots_by_copy(tmp_path):
    """An async save equals a blocking one, though the tensor is updated in
    place right after the save returns (the snapshot is a copy); a bf16
    leaf round-trips; shardings= restores onto a mesh (here of one gloo
    rank: every leaf whole, as a DTensor), and run_training takes
    state_shardings."""
    x = torch.arange(10.0)
    tree = {"x": x, "h": torch.arange(4.0).to(torch.bfloat16)}
    a = PM.CheckpointManager(str(tmp_path / "a"))
    a.save(7, tree, blocking=False)
    x.add_(100.0)
    a.wait()
    b = PM.CheckpointManager(str(tmp_path / "b"))
    b.save(7, {"x": torch.arange(10.0), "h": tree["h"]})
    ra, step = a.restore(tree)
    rb, _ = b.restore(tree)
    assert step == 7
    assert torch.equal(ra["x"], torch.arange(10.0))
    assert torch.equal(ra["x"], rb["x"]) and ra["h"].dtype == torch.bfloat16
    assert torch.equal(ra["h"], tree["h"])
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as M
    placed = SH.NamedSharding(M.make_local_mesh(1, 1, device="cpu"), SH.P())
    rs, _ = a.restore(tree, shardings=placed)
    assert torch.equal(rs["x"].to_local(), torch.arange(10.0))
    assert torch.equal(rs["h"].full_tensor(), tree["h"])
    out = run_training(*_setup(None, steps=1), device="cpu",
                       state_shardings=placed)
    assert len(out["history"]) == 1


@pytest.mark.parametrize("arch", [DANUBE, "deepseek_moe_16b",
                                  "jamba_v0_1_52b", "whisper_large_v3"])
def test_async_train_state_save_snapshots_leaves(arch, tmp_path):
    """save_train_state copies each leaf to the host before the writer
    restacks the layers: an async save, whose state is updated in place
    right after it returns, writes exactly the keys and arrays of
    state_to_reference of the state as it was saved."""
    pcfg = PC.get_smoke(arch)
    st = PST.init_train_state(0, pcfg, PO.OptimizerConfig(), device="cpu")
    want = {k: v.copy() for k, v in _pflat(st, pcfg).items()}
    mgr = PM.CheckpointManager(str(tmp_path))
    PM.save_train_state(mgr, 3, st, pcfg, blocking=False)
    for t in tu.leaves(st):
        t.add_(1)
    mgr.wait()
    got = CV.read_flat(mgr.path(3))
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--device", "cpu", *args], capture_output=True,
                          text=True, env=env, timeout=300)


def test_cli_learns_and_resumes(tmp_path):
    """30 steps on the CPU: exit 0 and the loss falls (the JAX launcher's
    smoke run); then --fail-at 15 with checkpoints every 10 exits non-zero,
    and the rerun resumes from step 10 and ends at step 30."""
    out = _cli("--steps", "30", "--batch", "8", "--seq", "32")
    assert out.returncode == 0, out.stderr
    done = [ln for ln in out.stdout.splitlines()
            if ln.startswith("[train] done")]
    assert done, out.stdout
    first, last = (float(v) for v in done[0].split("loss ")[1]
                   .split(" over")[0].split(" -> "))
    assert last < first - 1.0, done
    ck = str(tmp_path / "ck")
    args = ("--steps", "30", "--batch", "4", "--seq", "16", "--ckpt-dir",
            ck, "--ckpt-every", "10")
    crashed = _cli(*args, "--fail-at", "15")
    assert crashed.returncode != 0 and "SimulatedFailure" in crashed.stderr
    resumed = _cli(*args)
    assert resumed.returncode == 0, resumed.stderr
    assert "[train] resumed from checkpoint step 10" in resumed.stdout
    assert "resumed_from=10" in resumed.stdout
    assert sorted(os.listdir(ck)) == ["step-10", "step-20", "step-30"]
