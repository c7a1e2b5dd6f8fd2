"""Serving steps (the serving half of `repro.distributed.steps`).

`make_decode_step(n_steps=K)` is the device-resident loop: K micro-steps
run back to back on the device — forward, Gumbel-max / greedy sampling,
per-slot EOS and length masking with `torch.where` — and nothing inside
the loop reads a value back to the host (no `.item()`, `.cpu()` or
`nonzero`). The stacked (K, B) int32 token block is the one thing the
caller copies out per dispatch. The KV slab (or page store) and the loop
state are updated in place on the device: every step ends by `copy_`-ing
its results into the state's own tensors, so a CUDA graph of the step
(serve.backend) reads and writes fixed addresses. `make_paged_decode_step`
is the paged form — natively, the page table rides into every forward as
device state; `native=False` wraps the slab step in a gather and a scatter
— and `make_suffix_prefill_step` prefills only the unmatched suffix of a
prefix-reuse admission.

`make_speculative_decode_step` (and its paged form) is the fused
propose-then-verify cycle of speculative decode (serve.speculative): the
draft proposes K tokens, the target verifies them in one dispatch,
`accept_tokens` picks each slot's commit, and rejected suffixes roll back
(an index rewind; recurrent leaves select the state at the accepted step).

`ledger=LedgerConfig` (serve.ledger) appends the ineffectual-work ledger's
(n_layers, width) f32 buffer as a trailing operand and return of the
decode, speculative and suffix-prefill steps: every probed forward adds
its rows into it in place, so it accumulates across the K micro-steps and
a captured graph writes the same tensor at every replay. A speculative
step probes the target's verify forwards only.

Training: `make_loss_fn` runs the forward on the reference path
(`kernels.ops.reference_path`, the counterpart of the JAX package's
`backend="ref"`, which its training steps use): plain products under
autograd, no hand-written kernel (none has a backward). `make_train_step`
takes the gradient with `torch.autograd.grad`, splits a `grad_accum`
batch interleaved as the reference does (microbatch j takes rows j,
j + ga, ...), runs the `compress_fn` hook and AdamW in place.
`init_train_state` builds {"params", "opt", "step"} from the port's init.

Shape-only construction (the dry-run's, `launch.shapes`, where the JAX
package takes `jax.eval_shape`): `init_train_state`, `make_decode_state`,
`transformer.init` and `make_caches` build on `device="meta"`, which
allocates nothing. These functions skip the seeded generator there
(`transformer.seeded_generator`: meta has none) rather than run under
FakeTensorMode; on a real device they draw the same numbers as before.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import tree as tu
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as O
from repro_torch.serve.ledger import LedgerProbe

# the loop-state entries a decode step advances (the rest are written only
# at admission)
LOOP_STATE = ("tokens", "index", "remaining", "active")


def make_loss_fn(cfg: T.ModelConfig):
    """loss_fn(params, batch) -> (loss + aux, loss), f32 0-d tensors: the
    mean next-token cross-entropy (llava's logits past its image rows)
    plus the MoE load-balancing term, from a forward on the reference
    path. The choice is explicit, here and nowhere else, because it is a
    property of the step and not of the tensors: it holds for the CPU and
    the card alike, reaches the attention and Mamba branches and the dense
    leaves' Kratos apply without a `backend` argument on every model
    function, and makes any hand-written wrapper reached inside it raise
    instead of cutting the graph. An encoder-decoder's position table is
    not a parameter (the JAX package computes it in the forward): it is
    made here once per device."""
    tables: Dict[torch.device, torch.Tensor] = {}

    def loss_fn(params, batch):
        with ops.reference_path():
            enc_out = None
            if cfg.enc_dec:
                if "pos_table" not in params:
                    dev = batch["frames"].device
                    if dev not in tables:
                        tables[dev] = T.position_table(cfg.d_model, dev)
                    params = dict(params, pos_table=tables[dev])
                enc_out = T.encode(params, batch["frames"], cfg)
            logits, aux, _ = T.forward(
                params, batch["tokens"], cfg,
                img_embeds=batch.get("img_embeds"), enc_out=enc_out,
                with_aux=True)
            if cfg.n_img_tokens:
                logits = logits[:, cfg.n_img_tokens:]
            loss = T.lm_loss(logits, batch["labels"])
            return loss + aux.float(), loss

    return loss_fn


@contextlib.contextmanager
def _grad_leaves(leaves):
    """The parameters require grad for one step only, so the state stays
    plain tensors between steps (what serving and checkpoints see)."""
    for p in leaves:
        p.requires_grad_(True)
    try:
        yield
    finally:
        for p in leaves:
            p.requires_grad_(False)


def make_train_step(cfg: T.ModelConfig, opt_cfg: O.OptimizerConfig, *,
                    grad_accum: int = 1, compress_fn: Optional[Callable] = None,
                    accum_dtype=torch.float32, mesh=None):
    """train_step(state, batch) -> (state, metrics), the JAX package's:
    state {"params", "opt", "step"} (+ "comp" with a compress_fn), batch
    {"tokens", "labels", "frames"?, "img_embeds"?} tensors on the
    parameters' device; metrics {"loss", "grad_norm", "lr"} as 0-d
    tensors (read them when needed: nothing in the step syncs with the
    host). The parameters and AdamW's m and v are updated in place.

    grad_accum splits the batch into that many microbatches, interleaved
    (microbatch j takes rows j, j + grad_accum, ...: the reference's
    reshape(mb, ga).swapaxes(0, 1)), sums their gradients in accum_dtype
    and divides by grad_accum. A contiguous split gives the same mean for
    a dense model but other routing groups for an MoE one.
    compress_fn(grads, comp) -> (grads, comp) runs on the accumulated
    gradients (distributed.compression.ef_int8_compress).

    mesh: data parallelism over its 'data' axis (and 'pod', where the
    mesh has one). Each rank passes its own equal share of the batch's
    rows; the gradients and the loss are averaged over those axes (an
    all-reduce over each, 'data' first) before the compression and the
    update, so every rank takes the same step on a whole copy of the
    state."""
    loss_fn = make_loss_fn(cfg)
    groups = []
    if mesh is not None:
        axes = SH.mesh_axes(mesh)
        groups = [(SH.axis_group(mesh, a), axes[a]) for a in ("data", "pod")
                  if a in axes and axes[a] > 1]

    def train_step(state, batch):
        params = state["params"]
        leaves = tu.leaves(params)
        with _grad_leaves(leaves):
            if grad_accum == 1:
                total, loss = loss_fn(params, batch)
                flat = torch.autograd.grad(total, leaves)
            else:
                flat = [torch.zeros(p.shape, dtype=accum_dtype,
                                    device=p.device) for p in leaves]
                loss = torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
                for j in range(grad_accum):
                    micro = {k: _microbatch(v, j, grad_accum)
                             for k, v in batch.items()}
                    total, lj = loss_fn(params, micro)
                    for acc, g in zip(flat, torch.autograd.grad(total,
                                                                leaves)):
                        acc.add_(g.to(accum_dtype))
                    loss = loss + lj.detach()
                flat = [g / grad_accum for g in flat]
                loss = loss / grad_accum
        for group, n in groups:
            import torch.distributed as dist
            flat = [g.contiguous() for g in flat]
            for g in flat:
                dist.all_reduce(g, group=group)
                g.div_(n)
            loss = loss.detach().clone()
            dist.all_reduce(loss, group=group)
            loss = loss / n
        grads = tu.unflatten(params, flat)
        new_comp = state.get("comp")
        if compress_fn is not None:
            grads, new_comp = compress_fn(grads, new_comp)
        new_p, new_opt, gn = O.adamw_update(grads, state["opt"], params,
                                            opt_cfg)
        new_state = {"params": new_p, "opt": new_opt,
                     "step": state["step"] + 1}
        if new_comp is not None:
            new_state["comp"] = new_comp
        metrics = {"loss": loss.detach(), "grad_norm": gn,
                   "lr": O.warmup_cosine(opt_cfg, new_opt["count"])}
        return new_state, metrics

    return train_step


def _microbatch(x: torch.Tensor, j: int, ga: int) -> torch.Tensor:
    if x.shape[0] % ga:
        raise ValueError(f"batch of {x.shape[0]} rows does not split into "
                         f"grad_accum={ga} microbatches")
    return x[j::ga]


def init_train_state(seed: int, cfg: T.ModelConfig,
                     opt_cfg: O.OptimizerConfig, *, device="cuda"):
    """{"params", "opt", "step"} from the port's seeded init (other numbers
    than the JAX package's; parity tests carry JAX's state across with
    `checkpoint.convert.convert_state`). An encoder-decoder's position
    table is left out: it is no parameter."""
    params = T.init(cfg, seed=seed, device=device)
    params.pop("pos_table", None)
    return {"params": params, "opt": O.adamw_init(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def make_prefill_step(cfg: T.ModelConfig, last_only: bool = True, *,
                      cache_len: Optional[int] = None,
                      cache_dtype=torch.float32, device="cuda"):
    """prefill(params, batch) -> (logits, batch-1 caches).

    cache_len=None is the JAX package's other form, the dry-run's:
    prefill(params, batch, caches) -> (logits, caches), into caches the
    caller made (`transformer.make_caches`), written in place.

    The step allocates its own batch-1 cache list of `cache_len` positions
    on the device. last_only=False returns (1, S, vocab) logits: the engine
    right-pads prompts into buckets and reads the column at the true end.
    A vision-stub batch carries `img_embeds` (1, n_img, d), prepended; an
    enc_dec batch carries the audio stub's `frames` (1, enc_positions, d),
    which the encoder runs over first, the decoder's cross-attention
    writing its k/v into the returned caches."""
    def body(params, batch, caches):
        enc_out = T.encode(params, batch["frames"], cfg) if cfg.enc_dec \
            else None
        return T.forward(params, batch["tokens"], cfg, caches=caches,
                         img_embeds=batch.get("img_embeds"), enc_out=enc_out,
                         last_only=last_only)

    if cache_len is None:
        return body

    def prefill(params, batch):
        return body(params, batch,
                    T.make_caches(cfg, 1, cache_len, cache_dtype, device))
    return prefill


def make_decode_step(cfg: T.ModelConfig, *, n_steps: Optional[int] = None,
                     pages_meta: Optional[Dict[str, int]] = None,
                     ledger=None):
    """decode(params, caches, state) -> (tok_block (K, B) int32 on the
    device, caches, state). Slots that finish mid-block (EOS or budget)
    freeze their token and index; the host catches up from the block.

    n_steps=None is the JAX package's legacy lock-step form (what its
    dry-run lowers): decode(params, caches, token (B, 1) int32, index
    0-d int32) -> (logits (B, 1, vocab) f32, caches), one forward at
    position `index` writing the caches in place.

    pages_meta={'size': page_size, 'len': cache_len} builds the native
    paged form, which takes the (n_slots, pp) page table after `caches`:
        decode(params, caches, page_table, state)
            -> (tok_block, caches, page_table, state)
    and threads pages={'table', 'size', 'len'} into every forward. The
    table is loop-invariant inside the dispatch (admission changes it
    between dispatches).

    ledger=LedgerConfig appends the ledger buffer as the last operand and
    return: decode(params, caches, state, ledger) -> (tok_block, caches,
    state, ledger) (paged: after `state`); every micro-step's forward
    adds its probe rows into it."""
    if n_steps is None:
        if pages_meta is not None or ledger is not None:
            raise ValueError("pages_meta and ledger require the n_steps "
                             "form")

        def legacy_decode(params, caches, token, index):
            return T.forward(params, token, cfg, caches=caches, index=index)
        return legacy_decode
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")

    def decode(params, caches, state, page_table=None, led=None):
        pages = None if page_table is None else dict(pages_meta,
                                                     table=page_table)
        probe = None if led is None else LedgerProbe(ledger, led)
        toks = []
        st = {name: state[name] for name in LOOP_STATE}
        eos = state["eos"]
        for _ in range(n_steps):
            logits, caches = T.forward(params, st["tokens"][:, None], cfg,
                                       caches=caches, index=st["index"],
                                       pages=pages, probe=probe)
            tok = T.sample_tokens(logits[:, -1], state["generator"],
                                  state["temperature"], state.get("rows"))
            active = st["active"]
            tok = torch.where(active, tok, st["tokens"])
            remaining = torch.where(active, st["remaining"] - 1,
                                    st["remaining"])
            hit_eos = active & (eos >= 0) & (tok == eos)
            st = dict(tokens=tok,
                      index=torch.where(active, st["index"] + 1, st["index"]),
                      remaining=remaining,
                      active=active & (remaining > 0) & ~hit_eos)
            toks.append(tok)
        write_state(state, st)
        return torch.stack(toks), caches, state

    if pages_meta is not None:
        def paged_decode(params, caches, page_table, state, *led):
            tok_block, caches, state = decode(params, caches, state,
                                              page_table, *led)
            return (tok_block, caches, page_table, state, *led)
        return paged_decode
    if ledger is not None:
        def ledger_decode(params, caches, state, led):
            return (*decode(params, caches, state, None, led), led)
        return ledger_decode
    return decode


def make_paged_decode_step(cfg: T.ModelConfig, *, n_steps: int, layout,
                           native: bool = True, ledger=None):
    """Paged form of the device-resident loop (serve.paging):

        decode(params, store, page_table, state)
            -> (tok_block, store, page_table, state)

    native=True: the store's leaves pass straight into the forward as its
    cache list and the attention layers read and write them through the
    table — one indexed write per leaf for the new rows, the page-table
    kernel for the read — so no per-dispatch slab view exists.

    native=False, the legacy form (the A/B baseline): gather every slot's
    pages into the slab layout (`layout.gather`), run the unchanged slab
    step, scatter the view back (`layout.scatter`), each appending one
    `GATHER_EVENTS` entry; the table passes through. Both forms write the
    store in place and give the slab's greedy tokens.

    ledger=LedgerConfig appends the ledger buffer after `state` on either
    form (see make_decode_step)."""
    if native:
        meta = {"size": layout.page_size, "len": layout.cache_len}
        inner = make_decode_step(cfg, n_steps=n_steps, pages_meta=meta,
                                 ledger=ledger)

        def decode(params, store, page_table, state, *led):
            return inner(params, layout.as_tree(store), page_table, state,
                         *led)

        return decode

    inner = make_decode_step(cfg, n_steps=n_steps, ledger=ledger)

    def legacy_decode(params, store, page_table, state, *led):
        caches = layout.gather(store, page_table)
        tok_block, caches, state, *led = inner(params, caches, state, *led)
        layout.scatter(store, page_table, caches)
        return (tok_block, store, page_table, state, *led)

    return legacy_decode


def make_host_decode_step(cfg: T.ModelConfig):
    """The host loop's step (the JAX package's `make_decode_step` without
    n_steps):

        decode(params, caches, tokens (B, 1) int32, index (B,) int32)
            -> (B, vocab) f32 logits of the last column, on the device

    one forward with per-slot index clocks, writing the slab in place;
    sampling, EOS and the clocks stay on the host (serve.engine)."""
    def decode(params, caches, tokens, index):
        logits, _ = T.forward(params, tokens, cfg, caches=caches, index=index)
        return logits[:, -1]
    return decode


def make_suffix_prefill_step(cfg: T.ModelConfig, *, layout, ledger=None):
    """Prefill ONLY the unmatched suffix of a prompt whose prefix pages are
    already resident:

        prefill(params, batch, store, page_table, slot, index)
            -> ((1, S, vocab) suffix logits, store)

    Gathers the slot's batch-1 slab-layout view (the shared prefix pages
    supply positions < index), runs the suffix through the decode-form
    forward (the s > 1 contiguous block write, so suffix tokens attend to
    the cached prefix under the validity masks) and scatters the view back
    in place: fresh suffix pages receive the new KV, shared prefix pages
    the values they supplied. `index` is the matched prefix length (a 0-d
    int32 device tensor). Padded suffix rows land past the shared region,
    masked until decode overwrites them; the caller reads the logits
    column at the true suffix end. ledger=LedgerConfig appends the ledger
    buffer: prefill(..., index, ledger) -> (logits, store, ledger)."""
    def prefill(params, batch, store, page_table, slot, index, *led):
        row = page_table[slot]
        caches = layout.gather_one(store, row, slot)
        probe = LedgerProbe(ledger, led[0]) if led else None
        logits, caches = T.forward(params, batch["tokens"], cfg,
                                   caches=caches, index=index, probe=probe)
        layout.scatter_one(store, row, slot, caches)
        return (logits, store, *led)

    return prefill


def make_decode_state(n_slots: int, seed: int = 0,
                      device="cuda") -> Dict[str, object]:
    """Device-resident per-slot loop state: the token/index feedback loop,
    per-slot temperature / EOS / remaining budget / active flag and
    speculation cap `spec_limit` (written only at admission; 0 opts a slot
    out of drafting, and the plain step ignores it) and the sampling
    generator (None on the meta device). Every row starts parked
    (remaining 0, inactive)."""
    z = dict(device=device)
    return {
        "tokens": torch.zeros(n_slots, dtype=torch.int32, **z),
        "index": torch.zeros(n_slots, dtype=torch.int32, **z),
        "generator": T.seeded_generator(seed, device),
        "temperature": torch.zeros(n_slots, dtype=torch.float32, **z),
        "eos": torch.full((n_slots,), -1, dtype=torch.int32, **z),
        "remaining": torch.zeros(n_slots, dtype=torch.int32, **z),
        "active": torch.zeros(n_slots, dtype=torch.bool, **z),
        "spec_limit": torch.zeros(n_slots, dtype=torch.int32, **z),
    }


def decode_state_pspecs(mesh, n_slots: int) -> Dict[str, SH.PartitionSpec]:
    """PartitionSpecs of `make_decode_state(n_slots)`, the JAX package's:
    every per-slot vector shards like the slab's slot axis
    (`sharding.batch_pspec`); the sampling generator (JAX's threaded rng
    key, under its name) is replicated."""
    slot_spec = SH.batch_pspec(mesh, n_slots)
    spec = {k: slot_spec for k in ("tokens", "index", "temperature", "eos",
                                   "remaining", "active", "spec_limit")}
    spec["key"] = SH.P(None)
    return spec


def write_state(state: Dict[str, object], new: Dict[str, torch.Tensor]) -> None:
    """Copy a step's advanced loop state into the state's own tensors (the
    fixed addresses a captured graph reads at its next replay)."""
    for name, t in new.items():
        state[name].copy_(t)


def install_slot(state: Dict[str, object], slot: int, token: int, index: int,
                 temperature: float, eos: int, remaining: int,
                 spec_limit: int = 0) -> None:
    """Write one admitted request's row of the decode state, in place.
    eos < 0 means no EOS; remaining <= 0 installs an inactive row;
    spec_limit caps the draft tokens a dispatch may accept (speculative
    decode only)."""
    state["tokens"][slot] = token
    state["index"][slot] = index
    state["temperature"][slot] = temperature
    state["eos"][slot] = eos
    state["remaining"][slot] = remaining
    state["active"][slot] = remaining > 0
    state["spec_limit"][slot] = spec_limit


# ---------------------------------------------------------------------------
# Speculative decode: fused propose-then-verify (serve.speculative)
# ---------------------------------------------------------------------------

RECURRENT_LEAVES = ("conv", "ssm")


def recurrent_cache_paths(caches) -> List[Tuple[int, str]]:
    """(layer, leaf name) of every NON-POSITIONAL cache leaf: a Mamba
    layer's `conv` tail and `ssm` state (models.ssm.make_mamba_cache),
    slot-major on the slab and resident in a page store alike.

    Attention caches are positional: a rolled-back write lands past the
    rewound clock, masked until it is overwritten. A recurrent state after
    K tokens cannot be rewound, so the speculative step keeps a per-step
    stack of these leaves and selects each slot's accepted step."""
    return [(li, name) for li, layer in enumerate(caches)
            for name in layer if name in RECURRENT_LEAVES]


def accept_tokens(z: torch.Tensor, dlog: torch.Tensor, d_block: torch.Tensor,
                  temperature: torch.Tensor, spec_limit: torch.Tensor,
                  generator: torch.Generator, slot_rows=None):
    """Per-slot accept/reject and bonus token, pure on tensors.

    z: (B, K+1, V) target logits on [t0, d_1..d_K]; dlog: (B, K, V) the
    draft logits d_i was drawn from; d_block: (B, K) int32 drafts;
    temperature: (B,) f32 (<= 0 greedy); spec_limit: (B,) int32 cap;
    slot_rows: a rank's rows of the batch (`transformer.noise`).
    Returns (l_acc (B,) int32 accepted drafts, l_run (B,) int32 the
    uncapped accepted run, bonus (B,) int32).

    Greedy rows accept the longest prefix where d_i equals the target's
    argmax; sampled rows accept d_i while u < p(d_i) / q(d_i). The bonus is
    drawn from the target's column l_acc: its argmax (greedy), the residual
    (p - q)+ after a true rejection, else p itself (a run that was capped
    or fully accepted), so the committed stream follows p."""
    b, k = d_block.shape
    dev = z.device
    greedy = temperature <= 0.0
    tgt_next = torch.argmax(z, dim=-1).to(torch.int32)          # (B, K+1)
    match = d_block == tgt_next[:, :k]
    safe_t = temperature.clamp(min=1e-6)[:, None, None]
    logp = torch.log_softmax(z[:, :k].float() / safe_t, dim=-1)
    logq = torch.log_softmax(dlog.float() / safe_t, dim=-1)
    d_idx = d_block.long()[..., None]
    p_d = torch.gather(logp, 2, d_idx)[..., 0]
    q_d = torch.gather(logq, 2, d_idx)[..., 0]
    u = T.noise((b, k), generator, dev, slot_rows).clamp(min=1e-20)
    accept = torch.where(greedy[:, None], match, torch.log(u) < p_d - q_d)
    l_run = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1) \
        .to(torch.int32)
    l_acc = torch.minimum(l_run, spec_limit.to(torch.int32))
    rows = torch.arange(b, device=dev)
    lacc = l_acc.long()
    z_l = z[rows, lacc].float()                                 # (B, V)
    bonus_g = torch.argmax(z_l, dim=-1).to(torch.int32)
    q_l = torch.cat([dlog, torch.zeros_like(dlog[:, :1])], 1)[rows, lacc]
    logp_l = torch.log_softmax(z_l / safe_t[:, 0], dim=-1)
    logq_l = torch.log_softmax(q_l.float() / safe_t[:, 0], dim=-1)
    resid = torch.log((logp_l.exp() - logq_l.exp()).clamp(min=1e-30))
    # the residual conditions on "an ELIGIBLE draft token was rejected": a
    # column past the cap could never commit, so its bonus is a plain draw
    # from p (a capped or opted-out slot takes one plain target step)
    use_resid = (l_acc == l_run) & (l_run < k) & (l_run < spec_limit)
    t_logits = torch.where(use_resid[:, None], resid, logp_l)
    g = T.noise(z_l.shape, generator, dev, slot_rows)
    gum = -torch.log(-torch.log(g.clamp_(min=torch.finfo(torch.float32).tiny)))
    bonus_t = torch.argmax(t_logits + gum, dim=-1).to(torch.int32)
    return l_acc, l_run, torch.where(greedy, bonus_g, bonus_t)


def _stacks(bufs: Dict, tag: str, caches, paths, depth: int) -> List:
    """The per-step stacks of the recurrent leaves, (depth, *leaf) each,
    allocated once per step function and reused by every call (a captured
    graph writes the same buffers at every replay)."""
    out = []
    for li, name in paths:
        leaf = caches[li][name]
        key = (tag, li, name)
        want = (depth,) + tuple(leaf.shape)
        buf = bufs.get(key)
        if buf is None or tuple(buf.shape) != want or buf.device != leaf.device:
            buf = bufs[key] = torch.empty(want, dtype=leaf.dtype,
                                          device=leaf.device)
        out.append(buf)
    return out


def _snapshot(caches, paths, stacks, j: int) -> None:
    for (li, name), stack in zip(paths, stacks):
        stack[j].copy_(caches[li][name])


def _restore(caches, paths, stacks, g: torch.Tensor) -> None:
    """Each slot's recurrent leaves <- its row of the stack at step g[b]
    (0 = the pre-dispatch state): an exact select, no arithmetic."""
    rows = torch.arange(g.shape[0], device=g.device)
    for (li, name), stack in zip(paths, stacks):
        caches[li][name].copy_(stack[g, rows])


def make_speculative_decode_step(cfg: T.ModelConfig,
                                 draft_cfg: T.ModelConfig, *, n_draft: int,
                                 pages_meta: Optional[Dict[str, int]] = None,
                                 ledger=None):
    """Fused propose-then-verify decode:

        spec_decode(params, draft_params, caches, draft_caches, state)
            -> (commit (B, K+1), n_commit (B,), n_accept (B,),
                caches, draft_caches, state)

    all int32 on the device; caches, draft caches and state are updated in
    place. pages_meta={'size', 'len'} builds the native paged form, which
    takes the target's page table after `caches` and returns it after
    them (the draft keeps its slab).

    One dispatch per cycle, nothing read back to the host:
      1. DRAFT: K+1 micro-steps (proposals d_1..d_K, then one feed of d_K
         so the draft's cache covers a fully accepted block), sampling
         with each slot's temperature from the state's generator.
      2. VERIFY: the target scores [t0, d_1..d_K] in ONE (B, K+1) forward
         with per-slot index clocks (an MoE layer routes each slot's K+1
         positions as a group of its own); a recurrent arch, pure Mamba or
         the hybrid (whose Mamba layers decode one token at a time), runs
         K+1 single-token forwards and stacks its `conv` / `ssm` leaves
         after each.
      3. ACCEPT: `accept_tokens`, capped per slot by `spec_limit`.
      4. COMMIT: EOS and budget truncate the commit on the device; the
         index advances by the commit count (the rollback of a positional
         cache); recurrent leaves of target and draft select each slot's
         state after step l_acc + 1 (inactive slots keep step 0).

    Greedy output equals plain greedy decode for any draft and any K,
    except on an MoE target whose capacity drops assignments: its verify
    routes other groups than a plain decode step (each slot's block alone;
    on the hybrid, the other slots' draft tokens), and the JAX package's
    step parts from plain decode there too.

    ledger=LedgerConfig appends the ledger buffer as the last operand and
    return; the target's verify forwards add their probe rows into it (the
    draft's cost is accounted analytically, as in the JAX package)."""
    if n_draft < 1:
        raise ValueError(f"n_draft must be >= 1, got {n_draft}")
    k = n_draft
    recurrent = bool(cfg.is_ssm or cfg.attn_period)
    bufs: Dict = {}

    def spec_decode(params, draft_params, caches, draft_caches, state,
                    page_table=None, led=None):
        pages = None if page_table is None else dict(pages_meta,
                                                     table=page_table)
        probe = None if led is None else LedgerProbe(ledger, led)
        gen, temp = state["generator"], state["temperature"]
        active, idx0, tok0 = state["active"], state["index"], state["tokens"]

        # ---- 1. draft proposes (K+1 micro-steps) -------------------------
        d_paths = recurrent_cache_paths(draft_caches)
        d_stacks = _stacks(bufs, "draft", draft_caches, d_paths, k + 2)
        _snapshot(draft_caches, d_paths, d_stacks, 0)
        tok, idx, props, dlogits = tok0, idx0, [], []
        for j in range(k + 1):
            logits, _ = T.forward(draft_params, tok[:, None], draft_cfg,
                                  caches=draft_caches, index=idx)
            _snapshot(draft_caches, d_paths, d_stacks, j + 1)
            idx = torch.where(active, idx + 1, idx)
            if j == k:              # the trailing feed of d_K: cache only
                break
            nxt = torch.where(active, T.sample_tokens(
                logits[:, -1], gen, temp, state.get("rows")), tok)
            props.append(nxt)
            dlogits.append(logits[:, -1])
            tok = nxt
        d_block = torch.stack(props, dim=1)                     # (B, K)
        dlog = torch.stack(dlogits, dim=1)                      # (B, K, V)

        # ---- 2. target verifies the block --------------------------------
        tok_in = torch.cat([tok0[:, None], d_block], dim=1)     # (B, K+1)
        t_paths = recurrent_cache_paths(caches)
        if not recurrent:
            z, _ = T.forward(params, tok_in, cfg, caches=caches, index=idx0,
                             pages=pages, probe=probe)
        else:
            t_stacks = _stacks(bufs, "target", caches, t_paths, k + 2)
            _snapshot(caches, t_paths, t_stacks, 0)
            zs = []
            for j in range(k + 1):
                idx_j = torch.where(active, idx0 + j, idx0)
                lg, _ = T.forward(params, tok_in[:, j:j + 1], cfg,
                                  caches=caches, index=idx_j, pages=pages,
                                  probe=probe)
                _snapshot(caches, t_paths, t_stacks, j + 1)
                zs.append(lg[:, -1])
            z = torch.stack(zs, dim=1)

        # ---- 3. per-slot accept/reject -----------------------------------
        l_acc, _, bonus = accept_tokens(z, dlog, d_block, temp,
                                        state["spec_limit"], gen,
                                        state.get("rows"))

        # ---- 4. commit, on-device lifecycle, rollback --------------------
        ar = torch.arange(k + 1, dtype=torch.int32, device=tok0.device)[None]
        d_pad = torch.cat([d_block, torch.zeros_like(d_block[:, :1])], 1)
        lc = l_acc[:, None]
        commit = torch.where(ar < lc, d_pad, torch.zeros_like(d_pad))
        commit = torch.where(ar == lc, bonus[:, None], commit)
        m_full = l_acc + 1
        eos = state["eos"][:, None]
        is_eos = (eos >= 0) & (commit == eos) & (ar < m_full[:, None])
        first_eos = torch.where(is_eos, ar, torch.full_like(ar, k + 1)) \
            .amin(dim=1)
        m = torch.minimum(m_full, torch.minimum(first_eos + 1,
                                                state["remaining"]))
        m = torch.where(active, m, torch.zeros_like(m)).to(torch.int32)
        hit_eos = (first_eos + 1) <= m
        remaining = state["remaining"] - m
        last = torch.gather(commit, 1, (m - 1).clamp(min=0).long()[:, None])
        # accepted = draft tokens actually COMMITTED (EOS and budget may cut
        # an accepted run; the bonus commits only when m == l_acc + 1)
        n_accept = torch.where(active, torch.minimum(l_acc, m),
                               torch.zeros_like(m))
        if recurrent:
            # committed state = after consuming [t0, d_1..d_L] = step L+1,
            # for the draft and the target alike (both fed that prefix)
            g = torch.where(active, l_acc + 1, torch.zeros_like(l_acc)).long()
            _restore(caches, t_paths, t_stacks, g)
            _restore(draft_caches, d_paths, d_stacks, g)
        write_state(state, dict(
            tokens=torch.where(active, last[:, 0], tok0),
            index=idx0 + m,                   # the rollback: rewind the clock
            remaining=remaining,
            active=active & (remaining > 0) & ~hit_eos))
        return commit, m, n_accept, caches, draft_caches, state

    if pages_meta is not None:
        def paged_spec_decode(params, draft_params, caches, page_table,
                              draft_caches, state, *led):
            commit, m, acc, caches, draft_caches, state = spec_decode(
                params, draft_params, caches, draft_caches, state, page_table,
                *led)
            return (commit, m, acc, caches, page_table, draft_caches, state,
                    *led)
        return paged_spec_decode
    if ledger is not None:
        def ledger_spec_decode(params, draft_params, caches, draft_caches,
                               state, led):
            return (*spec_decode(params, draft_params, caches, draft_caches,
                                 state, None, led), led)
        return ledger_spec_decode
    return spec_decode


def make_paged_speculative_decode_step(cfg: T.ModelConfig,
                                       draft_cfg: T.ModelConfig, *,
                                       n_draft: int, layout,
                                       native: bool = True, ledger=None):
    """Paged form of the propose-then-verify cycle:

        spec_decode(params, draft_params, store, page_table, draft_caches,
                    state) -> (commit, n_commit, n_accept, store,
                               page_table, draft_caches, state)

    Only the target's cache is paged; the draft keeps its slab. A rejected
    suffix is an index rewind that frees no page, and the speculative
    headroom lands in the slot's private tail pages (prefix sharing only
    publishes pages of final KV), so a rolled-back write never touches a
    shared page. native=False is the legacy gather / slab cycle / scatter
    form (see make_paged_decode_step). ledger=LedgerConfig appends the
    ledger buffer last on either form."""
    if native:
        meta = {"size": layout.page_size, "len": layout.cache_len}
        inner = make_speculative_decode_step(cfg, draft_cfg, n_draft=n_draft,
                                             pages_meta=meta, ledger=ledger)

        def spec_decode(params, draft_params, store, page_table,
                        draft_caches, state, *led):
            return inner(params, draft_params, layout.as_tree(store),
                         page_table, draft_caches, state, *led)

        return spec_decode

    inner = make_speculative_decode_step(cfg, draft_cfg, n_draft=n_draft,
                                         ledger=ledger)

    def legacy_spec_decode(params, draft_params, store, page_table,
                           draft_caches, state, *led):
        caches = layout.gather(store, page_table)
        commit, m, acc, caches, draft_caches, state, *led = inner(
            params, draft_params, caches, draft_caches, state, *led)
        layout.scatter(store, page_table, caches)
        return (commit, m, acc, store, page_table, draft_caches, state, *led)

    return legacy_spec_decode
