"""Port parity, speculative self-draft decode (`repro_torch.serve.
speculative` and `distributed.steps.make_speculative_decode_step`).

On the CPU, at the smoke configs, with JAX weights carried across by
`checkpoint.convert`:
  * registry: a drafted artifact's key, name and truncation, and
    `draft_cost_fraction` equal to the JAX package's (active parameters:
    an MoE arch's top_k routed experts), for every arch family;
  * validation: the JAX engine's errors (a circular window refused);
  * the step against JAX's `make_speculative_decode_step` on the same
    state: greedy commit, commit and accept counts equal, caches after the
    rollback equal to 1e-5, for nemotron on the slab and through the page
    pool, falcon-mamba (recurrent leaves at the accepted step),
    deepseek-moe and deepseek-v2-lite (an MoE verify block: each slot's
    K+1 positions route as a group; slab and paged), the jamba hybrid
    (K+1 single-token verify steps; slab and paged), llava without its
    window (image rows in every slot's prefill and clock) and whisper
    (frames through each model's own encoder, the cross leaves);
  * the engine: greedy speculative tokens equal plain decode and JAX's
    speculating engine for K in {1, 2, 4}, nemotron and falcon-mamba on
    the slab and nemotron paged with prefix reuse; a bad draft, EOS
    truncation, the per-request cap and opt-out, seeded sampling;
  * `accept_tokens`' committed token follows the target distribution.
`cuda`-marked tests hold the CUDA graph of the dispatch to the eager step
on the card (tokens, launch counts, the recurrent select)."""

import dataclasses
import functools
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
except ImportError:     # a GPU machine without JAX runs the `cuda` tests only
    jax = None
if jax is not None:
    import jax.numpy as jnp

    from repro import configs as JC
    from repro.checkpoint.manager import save_pytree
    from repro.distributed import steps as JST
    from repro.models import transformer as JT
    from repro.serve import DraftSpec as JDraftSpec
    from repro.serve import EngineConfig as JEngineConfig
    from repro.serve import InferenceEngine as JEngine
    from repro.serve import ModelRegistry as JRegistry

from repro_torch import configs as PC
from repro_torch.checkpoint.convert import convert
from repro_torch.distributed import steps as PST
from repro_torch.kernels import ops as pops
from repro_torch.models import transformer as PT
from repro_torch.serve import (CachePool, DraftSpec, EngineConfig,
                               InferenceEngine, ModelRegistry,
                               PagedCachePool)
from repro_torch.serve import speculative as PSP

needs_jax = pytest.mark.skipif(
    jax is None, reason="compares the port with the JAX package, and JAX is "
    "not installed")
NEMOTRON, FALCON, DANUBE = ("nemotron-4-340b", "falcon-mamba-7b",
                            "h2o-danube-1.8b")
DEEPSEEK, LITE, JAMBA = ("deepseek-moe-16b", "deepseek-v2-lite-16b",
                         "jamba-v0.1-52b")
LLAVA, WHISPER = "llava-next-mistral-7b", "whisper-large-v3"
ARCHS = [NEMOTRON, FALCON]
# (prompt length, new tokens): mixed lengths, staggered arrivals
JOBS = ((5, 7), (9, 4), (7, 6))
MAX_LEN = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Smoke-sized CPU ops run far faster on one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jobs(vocab, seed=11, lens=JOBS):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, s0).astype(np.int32), g)
            for s0, g in lens]


def _run(eng, jobs, **submit_kw):
    reqs = [eng.submit(p, g, arrival_step=i, **submit_kw)
            for i, (p, g) in enumerate(jobs)]
    eng.run()
    return [list(r.generated) for r in reqs]


def _record_host_reads(monkeypatch, backend, method):
    """Record every tensor-to-host read made inside `backend.<method>`."""
    reads, active = [], [False]
    for name in ("cpu", "item", "tolist", "__int__", "__float__",
                 "__bool__", "__index__"):
        def wrapped(self, *a, _orig=getattr(torch.Tensor, name), _name=name,
                    **kw):
            if active[0]:
                reads.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, wrapped)
    inner = getattr(backend, method)

    def counted(*a, **kw):
        active[0] = True
        try:
            return inner(*a, **kw)
        finally:
            active[0] = False
    monkeypatch.setattr(backend, method, counted)
    return reads


@functools.lru_cache(maxsize=None)
def _carried(arch):
    """(JAX params, the port's dense params) on the same weights."""
    cfg = JC.get_smoke(arch)
    params = JT.init(jax.random.PRNGKey(0), cfg)
    with tempfile.TemporaryDirectory() as d:
        save_pytree(d, params)
        ported = convert(d, cfg.n_layers)
    return params, ported


def _unwindowed(model):
    """llava's smoke window (8) makes its cache circular, which speculation
    refuses: its step runs with the window off, in both packages."""
    if model.cfg.name.startswith("llava"):
        model.cfg = dataclasses.replace(model.cfg, window=None)
        model.draft_cfg = dataclasses.replace(model.draft_cfg, window=None)
    return model


@functools.lru_cache(maxsize=None)
def _jax_model(arch, **dspec):
    params, _ = _carried(arch)
    return _unwindowed(JRegistry().load(arch, params=params,
                                        draft_spec=JDraftSpec(**dspec)))


@functools.lru_cache(maxsize=None)
def _port_model(arch, **dspec):
    _, ported = _carried(arch)
    return _unwindowed(ModelRegistry().load(arch, params=ported, device="cpu",
                                            draft_spec=DraftSpec(**dspec)))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_draft_artifact_and_key_isolation():
    reg = ModelRegistry()
    plain = reg.load(NEMOTRON, device="cpu")
    drafted = reg.load(NEMOTRON, device="cpu", draft_spec=DraftSpec(bits=8))
    assert plain is not drafted and plain.name != drafted.name
    assert drafted.name == "nemotron-4-340b@s0-bf16-tree+draft[s0-w8-tree]"
    assert reg.get(plain.name) is plain and reg.get(drafted.name) is drafted
    assert drafted.has_draft and drafted.draft_packed > 0
    assert not plain.has_draft and plain.draft_cost_fraction() == 1.0
    assert reg.load(NEMOTRON, device="cpu",
                    draft_spec=DraftSpec(bits=8)) is drafted
    other = reg.load(NEMOTRON, device="cpu", draft_spec=DraftSpec(bits=4))
    assert other is not drafted and other.name != drafted.name
    g8 = reg.load(NEMOTRON, device="cpu", draft_spec=DraftSpec(
        bits=8, sparsity=0.5, bk=8, bn=8))
    g16 = reg.load(NEMOTRON, device="cpu", draft_spec=DraftSpec(
        bits=8, sparsity=0.5, bk=16, bn=16))
    assert g8 is not g16 and g8.name != g16.name
    # the draft shares the target's embedding, final norm and head tensors
    d, t = drafted.draft_params, drafted.params
    assert d["embed"]["emb"] is t["embed"]["emb"]
    assert d["final_norm"]["scale"] is t["final_norm"]["scale"]
    assert d["head"]["w"] is t["head"]["w"]


def test_draft_truncation():
    m = ModelRegistry().load(NEMOTRON, device="cpu",
                             draft_spec=DraftSpec(bits=8, keep_layers=2))
    assert m.draft_cfg.n_layers == 2 and m.cfg.n_layers == 4
    assert len(m.draft_params["layers"]) == 2 and len(m.params["layers"]) == 4
    assert m.draft_cfg.kratos.bits == 8 and m.cfg.kratos.bits is None
    with pytest.raises(ValueError):
        DraftSpec(keep_layers=0)
    with pytest.raises(ValueError, match="keep_layers"):
        ModelRegistry().load(NEMOTRON, device="cpu",
                             draft_spec=DraftSpec(keep_layers=99))
    assert DraftSpec.from_args(0, 0.5, 0) == DraftSpec(
        bits=None, sparsity=0.5, bk=8, bn=8)


@needs_jax
@pytest.mark.parametrize("arch,dspec", [
    (NEMOTRON, dict(bits=8)), (NEMOTRON, dict(bits=8, keep_layers=2)),
    (NEMOTRON, dict(bits=4, sparsity=0.5, bk=8, bn=8)),
    (FALCON, dict(bits=8)), (FALCON, dict(bits=8, keep_layers=1)),
    (DANUBE, dict(bits=8, sparsity=0.5, bk=8, bn=8, cache_dtype="bfloat16")),
    (DEEPSEEK, dict(bits=8)), (DEEPSEEK, dict(bits=8, keep_layers=2)),
    (DEEPSEEK, dict(bits=8, sparsity=0.5, bk=8, bn=8)),
    (LITE, dict(bits=8)), (JAMBA, dict(bits=8)),
    (JAMBA, dict(bits=4, sparsity=0.5, bk=8, bn=8)),
    (LLAVA, dict(bits=8, sparsity=0.5, bk=8, bn=8)),
    (WHISPER, dict(bits=8)), (WHISPER, dict(bits=8, keep_layers=1))])
def test_names_and_cost_fraction_match_jax(arch, dspec):
    jm, pm = _jax_model(arch, **dspec), _port_model(arch, **dspec)
    assert pm.name == jm.name
    assert DraftSpec(**dspec).tag == JDraftSpec(**dspec).tag
    assert pm.draft_cfg.n_layers == jm.draft_cfg.n_layers
    # counted as the JAX package's tree holds them: a projection once for
    # the layers a scan slot (or the encoder) stacks
    assert pm.draft_packed == jm.draft_packed
    assert pm.cfg.param_count() == jm.cfg.param_count()
    # an MoE token runs through top_k of n_experts routed experts
    assert pm.cfg.active_param_count() == jm.cfg.active_param_count()
    assert pm.draft_cfg.active_param_count() == \
        jm.draft_cfg.active_param_count()
    assert (pm.cfg.active_param_count() < pm.cfg.param_count()) \
        == bool(pm.cfg.n_experts)
    assert pm.draft_cost_fraction() == pytest.approx(
        jm.draft_cost_fraction(), rel=1e-12)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

def test_speculate_validation():
    reg = ModelRegistry()
    drafted = reg.load(NEMOTRON, device="cpu", draft_spec=DraftSpec(bits=8))
    plain = reg.load(NEMOTRON, device="cpu")
    with pytest.raises(ValueError, match="self-draft"):
        InferenceEngine(plain, EngineConfig(speculate=2, device="cpu"))
    with pytest.raises(ValueError, match="decode_chunk"):
        InferenceEngine(drafted, EngineConfig(speculate=2, decode_chunk=2,
                                              device="cpu"))
    with pytest.raises(ValueError, match="speculate must be >= 0"):
        EngineConfig(speculate=-1, device="cpu")
    # the propose-then-verify cycle is one fused dispatch: the host loop
    # does not speculate (the JAX engine's error)
    with pytest.raises(ValueError, match="speculate requires device_loop=True"):
        EngineConfig(speculate=2, device_loop=False, device="cpu")
    # circular sliding-window caches cannot roll back: the smoke window
    # (8) is below max_len + K
    swa = reg.load(DANUBE, device="cpu", draft_spec=DraftSpec(bits=8))
    with pytest.raises(ValueError, match="window"):
        InferenceEngine(swa, EngineConfig(n_slots=2, max_len=32, speculate=2,
                                          device="cpu"))
    # ... and a window that covers max_len + K is served
    PSP.check_supported(PC.get_config(DANUBE), 544 + 4)
    with pytest.raises(ValueError, match="window"):
        PSP.check_supported(PC.get_config(DANUBE), 4096 + 1)


# ---------------------------------------------------------------------------
# the step against JAX's, on the same state
# ---------------------------------------------------------------------------

# per-slot prompt lengths (so the clocks differ), budgets, caps: slot 1
# runs out of budget mid-block, slot 2 is parked
STEP_LENS, STEP_REMAINING, STEP_ACTIVE = (6, 4, 9), (6, 2, 0), (1, 1, 0)


def _jax_write_row(full, one, slot):
    """Row `slot` of JAX's caches <- a batch-1 cache: a prelude layer's
    leaves are (B, ...), a scan slot's stacked (layers, B, ...)."""
    tm = jax.tree_util.tree_map
    return {"prelude": tm(lambda f, o: f.at[slot].set(o[0]),
                          full["prelude"], one["prelude"]),
            "blocks": tm(lambda f, o: f.at[:, slot].set(o[:, 0]),
                         full["blocks"], one["blocks"])}


def _step_extras(cfg, slot):
    """A slot's model inputs besides its tokens (numpy, batch 1): the
    vision stub's image rows or the audio stub's frames, from a seed."""
    rng = np.random.default_rng(100 + slot)
    if cfg.n_img_tokens:
        return {"img_embeds": rng.standard_normal(
            (1, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)}
    if cfg.enc_dec:
        return {"frames": rng.standard_normal(
            (1, cfg.enc_positions, cfg.d_model)).astype(np.float32)}
    return {}


def _jax_prefill(cfg, params, tokens, extras, cache_len):
    one = JT.make_caches(cfg, 1, cache_len, jnp.float32)
    enc = JT.encode(params, jnp.asarray(extras["frames"]), cfg) \
        if "frames" in extras else None
    img = extras.get("img_embeds")
    logits, _, one = JT.forward(params, jnp.asarray(tokens[None]), cfg,
                                caches=one, enc_out=enc,
                                img_embeds=None if img is None
                                else jnp.asarray(img))
    return logits, one


def _port_prefill(cfg, params, tokens, extras, cache_len):
    one = PT.make_caches(cfg, 1, cache_len, torch.float32, "cpu")
    enc = PT.encode(params, torch.from_numpy(extras["frames"]), cfg) \
        if "frames" in extras else None
    img = extras.get("img_embeds")
    PT.forward(params, torch.from_numpy(tokens[None]), cfg, caches=one,
               enc_out=enc,
               img_embeds=None if img is None else torch.from_numpy(img))
    return one


def _step_prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, s).astype(np.int32) for s in STEP_LENS]


def _install_rows(make, install, first, k, n_img):
    st = make()
    for slot in range(len(STEP_LENS)):
        rem = STEP_REMAINING[slot] if STEP_ACTIVE[slot] else 0
        lim = 1 if slot == 1 else k
        st = install(st, slot, first[slot], n_img + STEP_LENS[slot], 0.0, -1,
                     rem, lim) or st
    return st


@functools.lru_cache(maxsize=None)
def _jax_step(arch, k, dspec_items):
    """JAX's step on its slab state (target and draft caches filled slot by
    slot from batch-1 prefills, with each slot's image rows or frames,
    which target and draft each encode). Returns (model, first tokens,
    commit, n_commit, n_accept, caches, draft caches, state) after one
    cycle; the port's slab and paged steps are both held to it."""
    jm = _jax_model(arch, **dict(dspec_items))
    cache_len = MAX_LEN + k
    n = len(STEP_LENS)
    jc = JT.make_caches(jm.cfg, n, cache_len, jnp.float32)
    jd = JT.make_caches(jm.draft_cfg, n, cache_len, jnp.float32)
    first = []
    for slot, p in enumerate(_step_prompts(jm.cfg.vocab)):
        extras = _step_extras(jm.cfg, slot)
        logits, one = _jax_prefill(jm.cfg, jm.params, p, extras, cache_len)
        jc = _jax_write_row(jc, one, slot)
        first.append(int(jnp.argmax(logits[0, -1])))
        _, one = _jax_prefill(jm.draft_cfg, jm.draft_params, p, extras,
                              cache_len)
        jd = _jax_write_row(jd, one, slot)
    jst = _install_rows(lambda: JST.make_decode_state(n, 0),
                        JST.install_slot, first, k, jm.cfg.n_img_tokens)
    jstep = jax.jit(JST.make_speculative_decode_step(
        jm.cfg, jm.draft_cfg, "ref", n_draft=k))
    return (jm, first) + tuple(jstep(jm.params, jm.draft_params, jc, jd,
                                     jst))


def _step_inputs(arch, k, dspec, first):
    """The port's model, its slab caches (target and draft) filled as
    JAX's, and the decode state with JAX's first tokens."""
    pm = _port_model(arch, **dspec)
    cache_len = MAX_LEN + k
    n = len(STEP_LENS)
    pc = PT.make_caches(pm.cfg, n, cache_len, torch.float32, "cpu")
    pd = PT.make_caches(pm.draft_cfg, n, cache_len, torch.float32, "cpu")
    for slot, p in enumerate(_step_prompts(pm.cfg.vocab)):
        extras = _step_extras(pm.cfg, slot)
        for cfg, params, caches in ((pm.cfg, pm.params, pc),
                                    (pm.draft_cfg, pm.draft_params, pd)):
            one = _port_prefill(cfg, params, p, extras, cache_len)
            for row, o in zip(caches, one):
                for name, t in row.items():
                    t[slot].copy_(o[name][0])
    pst = _install_rows(lambda: PST.make_decode_state(n, 0, "cpu"),
                        PST.install_slot, first, k, pm.cfg.n_img_tokens)
    return pm, pc, pd, pst, cache_len


def _jax_leaf(caches, cfg, li, name):
    """JAX's leaf of the port's layer li: a prelude layer's own, or row t
    of scan slot s's stack (layer prelude + t * period + s); the port's
    cross_k / cross_v are JAX's cross k / v."""
    group, leaf = ("cross", name[len("cross_"):]) \
        if name.startswith("cross_") else ("mixer", name)
    n0, p = cfg.prelude_layers, cfg.scan_period
    if li < n0:
        return np.asarray(caches["prelude"][li][group][leaf])
    return np.asarray(caches["blocks"][(li - n0) % p][group][leaf]
                      [(li - n0) // p])


def _assert_caches_equal(jcaches, pcaches, cfg, atol=1e-5):
    assert cfg.n_layers == len(pcaches)
    for li, layer in enumerate(pcaches):
        for name, t in layer.items():
            np.testing.assert_allclose(t.numpy(),
                                       _jax_leaf(jcaches, cfg, li, name),
                                       rtol=1e-5, atol=atol,
                                       err_msg=f"layer {li} {name}")


@needs_jax
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("arch,dspec,paged", [
    (NEMOTRON, dict(bits=8), False), (NEMOTRON, dict(bits=8), True),
    (NEMOTRON, dict(bits=8, keep_layers=2), False),
    (FALCON, dict(bits=8), False), (FALCON, dict(bits=8, keep_layers=1), False),
    (DEEPSEEK, dict(bits=8), False), (DEEPSEEK, dict(bits=8), True),
    (DEEPSEEK, dict(bits=8, sparsity=0.5, bk=8, bn=8), False),
    (LITE, dict(bits=8), False), (LITE, dict(bits=8), True),
    (JAMBA, dict(bits=8), False), (JAMBA, dict(bits=8), True),
    (LLAVA, dict(bits=8), False), (WHISPER, dict(bits=8), False)])
def test_step_matches_jax(arch, dspec, paged, k):
    jm, first, jcommit, jm_, jacc, jc, jd, jst = _jax_step(
        arch, k, tuple(sorted(dspec.items())))
    pm, pc, pd, pst, cache_len = _step_inputs(arch, k, dspec, first)
    if paged:
        pool = PagedCachePool(pm.cfg, len(STEP_LENS), cache_len, page_size=4,
                              device="cpu", prefix_cache=False)
        for slot in range(len(STEP_LENS)):
            assert pool.alloc() == slot
            pool.alloc_pages(slot, cache_len)
            pool.write_slot(slot, [{n: t[slot:slot + 1] for n, t in l.items()}
                                   for l in pc])
        step = PST.make_paged_speculative_decode_step(
            pm.cfg, pm.draft_cfg, n_draft=k, layout=pool.layout)
        commit, m, acc, store, table, pd, pst = step(
            pm.params, pm.draft_params, pool.store, pool.page_table, pd, pst)
        assert store is pool.store and table is pool.page_table
        pc = [{} for _ in pc]
        for slot in range(len(STEP_LENS)):
            one = pool.layout.gather_one(store, table[slot], slot)
            for li, layer in enumerate(one):
                for name, t in layer.items():
                    pc[li].setdefault(name, []).append(t)
        pc = [{n: torch.cat(ts) for n, ts in layer.items()} for layer in pc]
    else:
        step = PST.make_speculative_decode_step(pm.cfg, pm.draft_cfg,
                                                n_draft=k)
        commit, m, acc, pc, pd, pst = step(pm.params, pm.draft_params, pc, pd,
                                           pst)
    np.testing.assert_array_equal(commit.numpy(), np.asarray(jcommit))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm_))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    for name in PST.LOOP_STATE + ("spec_limit",):
        np.testing.assert_array_equal(pst[name].numpy(),
                                      np.asarray(jst[name]), err_msg=name)
    _assert_caches_equal(jc, pc, jm.cfg)
    _assert_caches_equal(jd, pd, jm.draft_cfg)
    m = m.numpy()
    assert m[2] == 0 and 1 <= m[0] <= k + 1 and m[1] <= 2   # parked, budget
    assert acc.numpy()[1] <= 1                               # cap of 1


def test_recurrent_leaves_select_the_accepted_step():
    """After a cycle of a rejecting draft, each slot's conv / ssm state is
    bitwise the state the target reaches by feeding the committed tokens
    one at a time from the pre-dispatch state."""
    _assert_recurrent_select("cpu")


def _assert_recurrent_select(device):
    reg = ModelRegistry()
    m = reg.load(FALCON, device=device,
                 draft_spec=DraftSpec(bits=8, keep_layers=1))
    k, n = 4, 3
    caches = PT.make_caches(m.cfg, n, MAX_LEN + k, torch.float32, device)
    draft = PT.make_caches(m.draft_cfg, n, MAX_LEN + k, torch.float32, device)
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, m.cfg.vocab, (n, 6))
                              .astype(np.int32)).to(device)
    logits, _ = PT.forward(m.params, tokens, m.cfg, caches=caches)
    PT.forward(m.draft_params, tokens, m.draft_cfg, caches=draft)
    st = PST.make_decode_state(n, 0, device)
    first = logits[:, -1].argmax(-1).tolist()
    for slot in range(n):
        PST.install_slot(st, slot, first[slot], 6, 0.0, -1, 20, k)
    before = [{name: t.clone() for name, t in layer.items()}
              for layer in caches]
    step = PST.make_speculative_decode_step(m.cfg, m.draft_cfg, n_draft=k)
    commit, n_commit, _, caches, _, _ = step(m.params, m.draft_params, caches,
                                             draft, st)
    n_commit = n_commit.tolist()
    assert all(1 <= c <= k + 1 for c in n_commit)
    # replay: feed t0 and the committed drafts one token at a time
    feed = torch.cat([torch.tensor(first, dtype=torch.int32,
                                   device=device)[:, None], commit], 1)
    states = []
    for j in range(k + 1):
        PT.forward(m.params, feed[:, j:j + 1], m.cfg, caches=before,
                   index=torch.full((n,), 6 + j, dtype=torch.int32,
                                    device=device))
        states.append([{name: t.clone() for name, t in layer.items()}
                       for layer in before])
    for slot, c in enumerate(n_commit):
        want = states[c - 1]            # after t0 and the c - 1 drafts
        for li, layer in enumerate(caches):
            for name, t in layer.items():
                assert torch.equal(t[slot], want[li][name][slot]), \
                    (slot, li, name)


# ---------------------------------------------------------------------------
# engine: greedy tokens against plain decode and JAX's engine
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_tokens(arch, k, page_size=None, trace="jobs"):
    m = _jax_model(arch, bits=8)
    if trace == "jobs":
        eng = JEngine(m, JEngineConfig(n_slots=4, max_len=MAX_LEN,
                                       speculate=k))
        return _run(eng, _jobs(m.cfg.vocab))
    eng = JEngine(m, JEngineConfig(n_slots=4, max_len=PREFIX_MAX_LEN,
                                   speculate=k, page_size=page_size))
    return _serve_prefix(eng, m.cfg.vocab)


def _port_engine(arch, dspec=None, **kw):
    model = _port_model(arch, **(dspec or dict(bits=8)))
    return InferenceEngine(model, EngineConfig(
        **dict(dict(n_slots=4, max_len=MAX_LEN, device="cpu"), **kw)))


@needs_jax
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_plain_and_jax(arch, k, monkeypatch):
    jobs = _jobs(PC.get_smoke(arch).vocab)
    plain = _run(_port_engine(arch), jobs)
    eng = _port_engine(arch, speculate=k)
    reads = _record_host_reads(monkeypatch, eng.backend, "spec_decode_block")
    got = _run(eng, jobs)
    monkeypatch.undo()
    assert got == plain == _jax_tokens(arch, k)
    rep = eng.metrics.report()
    # one host read per cycle: the packed (commit, counts) block
    assert reads == ["cpu"] * int(rep["spec_dispatches"])
    assert rep["host_syncs_decode"] == rep["decode_steps"] \
        == rep["spec_dispatches"] > 0
    assert 0.0 < rep["acceptance_rate"] <= 1.0
    assert rep["tokens_per_dispatch"] > 1.0
    n_target = k + 1 if arch == FALCON else 1
    assert rep["micro_steps"] == rep["decode_steps"] * (k + 1 + n_target)


PREFIX_MAX_LEN = 48


def _serve_prefix(eng, vocab):
    """A shared 24-token system prompt under four requests, then the
    second turn of the first conversation."""
    rng = np.random.default_rng(0)
    sys_p = rng.integers(0, vocab, 24)
    wave = [np.concatenate([sys_p, rng.integers(0, vocab, 3)])
            for _ in range(4)]
    reqs = [eng.submit(p, 4, arrival_step=i) for i, p in enumerate(wave)]
    eng.run()
    conv = np.concatenate([wave[0], np.asarray(reqs[0].generated, np.int32)])
    reqs.append(eng.submit(np.concatenate([conv, rng.integers(0, vocab, 3)]),
                           4, arrival_step=eng.step_count))
    eng.run()
    return [list(r.generated) for r in reqs], [r.prefix_matched for r in reqs]


@needs_jax
@pytest.mark.parametrize("k", [1, 2, 4])
def test_paged_prefix_reuse_matches_plain_and_jax(k):
    """Nemotron through the page pool (page_size 8) with prefix and
    conversation reuse: a matched admission prefills the suffix into the
    target's pages and the whole prompt into the draft's slab."""
    vocab = PC.get_smoke(NEMOTRON).vocab
    kw = dict(page_size=8, max_len=PREFIX_MAX_LEN)
    plain = _serve_prefix(_port_engine(NEMOTRON, **kw), vocab)
    eng = _port_engine(NEMOTRON, speculate=k, **kw)
    got = _serve_prefix(eng, vocab)
    assert got == plain == _jax_tokens(NEMOTRON, k, 8, "prefix")
    assert got[1] == [0, 24, 24, 24, 24]
    assert eng.metrics.report()["spec_dispatches"] > 0
    pool = eng.pool
    assert pool.n_active == 0 and pool.pages_in_use == pool.index.n_nodes


@pytest.mark.parametrize("arch", ARCHS)
def test_bad_draft_rolls_back_and_keeps_tokens(arch):
    """A draft cut to one layer disagrees almost always: rollback on nearly
    every cycle, the same tokens."""
    jobs = _jobs(PC.get_smoke(arch).vocab, seed=3,
                 lens=((5, 12), (9, 8), (7, 10)))
    dspec = dict(bits=8, keep_layers=1)
    plain = _run(_port_engine(arch, dspec, max_len=48), jobs)
    eng = _port_engine(arch, dspec, max_len=48, speculate=4)
    assert _run(eng, jobs) == plain
    rep = eng.metrics.report()
    assert rep["draft_rolled_back"] > 0 and rep["acceptance_rate"] < 0.5


def test_eos_truncates_commit_on_device():
    vocab = PC.get_smoke(NEMOTRON).vocab
    prompt = np.arange(6) % vocab
    free = _run(_port_engine(NEMOTRON), [(prompt, 8)])[0]
    eos = free[2]
    expect = free[:free.index(eos) + 1]

    def run_eos(**kw):
        eng = _port_engine(NEMOTRON, **kw)
        r = eng.submit(prompt, 8, eos_id=eos)
        eng.run()
        return list(r.generated), eng
    plain, _ = run_eos()
    spec, eng = run_eos(speculate=4)
    assert plain == spec == expect
    assert eng.requests[0].done and eng.pool.n_free == 4


def test_per_request_cap_and_opt_out():
    jobs = _jobs(PC.get_smoke(NEMOTRON).vocab)
    plain = _run(_port_engine(NEMOTRON), jobs)
    eng = _port_engine(NEMOTRON, speculate=4)
    reqs = [eng.submit(p, g, arrival_step=i,
                       speculate=(0 if i == 0 else 1 if i == 1 else None))
            for i, (p, g) in enumerate(jobs)]
    eng.run()
    assert [list(r.generated) for r in reqs] == plain
    acc = eng.metrics.slot_acceptance
    # the opt-out slot proposes nothing; the capped one at most 1 a cycle
    assert reqs[0].slot not in acc
    capped = acc[reqs[1].slot]
    assert capped[1] <= jobs[1][1] and capped[0] <= capped[1]
    rep = eng.metrics.report()
    assert rep["draft_proposed"] == sum(p for _, p in acc.values())
    assert rep["draft_accepted"] == sum(a for a, _ in acc.values())


def test_sampling_reproducible_and_seeded():
    prompt = np.arange(5) % PC.get_smoke(NEMOTRON).vocab

    def run_t(seed):
        eng = _port_engine(NEMOTRON, seed=seed, speculate=4)
        r = eng.submit(prompt, 9, temperature=1.0)
        eng.run()
        return list(r.generated)
    a, b, c = run_t(7), run_t(7), run_t(8)
    assert a == b and len(a) == 9 and a != c


def test_spec_metrics_in_report():
    eng = _port_engine(NEMOTRON, speculate=4)
    _run(eng, _jobs(PC.get_smoke(NEMOTRON).vocab))
    rep = eng.metrics.report()
    for key in ("acceptance_rate", "draft_rolled_back", "draft_proposed",
                "draft_accepted", "spec_dispatches", "tokens_per_dispatch",
                "draft_verify_flop_ratio"):
        assert key in rep
    assert rep["draft_proposed"] > 0
    assert rep["draft_rolled_back"] == rep["draft_proposed"] \
        - rep["draft_accepted"]
    assert rep["draft_verify_flop_ratio"] == 1.0      # full depth, s0
    # the draft's slab rides beside the target's, padded by K
    bk = eng.backend
    assert isinstance(bk.draft_pool, CachePool)
    assert bk.draft_pool.caches[0]["k"].shape[2] == MAX_LEN + 4
    assert eng.pool.caches[0]["k"].shape[2] == MAX_LEN + 4


# ---------------------------------------------------------------------------
# accept / bonus distribution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,limit", [(1, 1), (2, 2), (2, 0)])
def test_committed_token_follows_the_target(k, limit):
    """Drafts drawn from q, the accept test and the residual bonus: the
    first committed token of each row is distributed as p (softmax of the
    target logits at temperature 0.8), within a total-variation bound of
    0.02 over 40,000 rows (the sampling error alone is ~0.006)."""
    n, vocab, temp = 40000, 6, 0.8
    g = torch.Generator().manual_seed(0)
    zl = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0])
    ql = torch.tensor([0.0, 1.5, 0.5, 1.0, -1.0, 0.3])
    z = zl.expand(n, k + 1, vocab).clone()
    dlog = ql.expand(n, k, vocab).clone()
    t = torch.full((n,), temp)
    d_block = torch.stack([PT.sample_tokens(dlog[:, j], g, t)
                           for j in range(k)], 1)
    l_acc, l_run, bonus = PST.accept_tokens(
        z, dlog, d_block, t, torch.full((n,), limit, dtype=torch.int32), g)
    assert bool((l_acc <= limit).all()) and bool((l_acc <= l_run).all())
    first = torch.where(l_acc > 0, d_block[:, 0], bonus)
    freq = torch.bincount(first.long(), minlength=vocab).double() / n
    p = torch.softmax(zl.double() / temp, 0)
    tv = 0.5 * float((freq - p).abs().sum())
    assert tv < 0.02, (tv, freq, p)
    if limit:
        # the draft does propose: some rows accept, some fall to the bonus
        assert 0 < int((l_acc > 0).sum()) < n


def test_greedy_accept_is_the_argmax_run():
    z = torch.tensor([[[0., 5, 1], [4, 0, 1], [0, 1, 3]]])     # argmax 1 0 2
    dlog = torch.zeros(1, 2, 3)
    g = torch.Generator().manual_seed(0)
    t = torch.zeros(1)
    for d, lim, want_acc, want_bonus in (([1, 0], 2, 2, 2), ([1, 2], 2, 1, 0),
                                         ([2, 0], 2, 0, 1), ([1, 0], 1, 1, 0)):
        l_acc, _, bonus = PST.accept_tokens(
            z, dlog, torch.tensor([d], dtype=torch.int32), t,
            torch.tensor([lim], dtype=torch.int32), g)
        assert (int(l_acc), int(bonus)) == (want_acc, want_bonus)


# ---------------------------------------------------------------------------
# on the card: the dispatch as a CUDA graph
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


def _cuda_engine(arch, **kw):
    model = ModelRegistry().load(arch, device="cuda",
                                 draft_spec=DraftSpec(bits=8))
    return InferenceEngine(model, EngineConfig(n_slots=4, max_len=MAX_LEN,
                                               **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kw", [
    (NEMOTRON, dict(decode_chunk=4)), (NEMOTRON, dict(decode_chunk=4,
                                                      page_size=8)),
    (FALCON, dict(decode_chunk=2)), (NEMOTRON, dict(speculate=2)),
    (NEMOTRON, dict(speculate=4, page_size=8)), (FALCON, dict(speculate=2))])
def test_cuda_graph_replay_matches_eager(cuda_device, arch, kw):
    """The graphed engine's tokens equal the same engine run through the
    eager step, greedy and sampled (the state's generator is registered
    with the graph and seeded alike)."""
    jobs = _jobs(PC.get_smoke(arch).vocab)
    out = []
    for eager in (False, True):
        eng = _cuda_engine(arch, **kw)
        assert eng.backend._graph is not None
        if eager:
            name = "spec_decode_block" if kw.get("speculate") \
                else "decode_block"
            setattr(eng.backend, name, functools.partial(
                getattr(eng.backend, name), eager=True))
        out.append((_run(eng, jobs), _run(eng, jobs, temperature=0.7)))
    assert out[0] == out[1]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(decode_chunk=4, page_size=8),
                                dict(speculate=2, page_size=8)])
def test_cuda_launch_counts_count_replays(cuda_device, kw):
    eng = _cuda_engine(NEMOTRON, **kw)
    per = dict(eng.backend._graph_launches)
    assert per["dense_matmul"] > 0 and per["paged_flash_attention"] > 0
    eng.submit(np.arange(5), 6)
    eng.step()                               # admission + one dispatch
    pops.reset_launch_counts()
    n = 3
    for _ in range(n):
        (eng.backend.spec_decode_block if kw.get("speculate")
         else eng.backend.decode_block)()
    got = pops.launch_counts()
    assert {name: c for name, c in got.items() if c} \
        == {name: c * n for name, c in per.items()}
    layers = PC.get_smoke(NEMOTRON).n_layers
    if kw.get("speculate"):                  # one verify block a layer
        assert per["paged_flash_attention"] == layers
    else:
        assert per["paged_flash_attention"] == layers * 4


@pytest.mark.cuda
def test_cuda_recurrent_select_is_bitwise(cuda_device):
    _assert_recurrent_select("cuda")
