"""The arithmetic of the two decode-path kernel designs, checked on the CPU.

`paged_plan` (`repro_torch.kernels.flash_attention`) and `scan_plan`
(`repro_torch.kernels.ssm_scan`): every plan fits shared memory and the
cluster limit, the serving shapes get the planned splits, and the plans
refuse what the kernels do not take. Then plain-PyTorch mirrors of what the
CUDA kernels compute in another order: the paged kernel's split of each
slot's live pages over the CTAs of a cluster and over a CTA's warps, with
the partial (m, l, o) merged warp by warp and rank by rank; and the scan's
state split into groups of 4, with y summed group by group and the decay
factor formed as a power of two. Both are held to the plain versions (`kernels/ref.py`) and
through them to the JAX package: `paged_flash_attention` in Pallas
interpret mode and `repro.kernels.ssm_scan.ssm_scan_ref`."""

import inspect
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels.ssm_scan import ssm_scan_ref as jssm_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as pref
from repro_torch.kernels import ssm_scan as ss

NEG = -1e30


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# paged_plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("elem", [4, 2])
def test_paged_plan_fits_shared_memory_and_the_cluster(elem):
    for d in (1, 8, 16, 33, 64, 80, 96, 128, 160, 192, 255, 256):
        for b, h, h_kv, sq in ((1, 4, 4, 1), (8, 32, 8, 1), (8, 96, 8, 3),
                               (64, 32, 8, 1), (2, 8, 1, 5)):
            for page, pp in ((4, 1), (16, 34), (16, 48), (8, 512)):
                pl = fa.paged_plan(b, h, h_kv, sq, d, page, pp, elem)
                assert d <= pl.dp and pl.dp in fa.FA_DP
                assert 1 <= pl.split <= fa.PAGED_MAX_SPLIT
                assert 1 <= pl.stages <= fa.PAGED_MAX_STAGES
                assert pl.smem_bytes == fa.paged_smem_bytes(pl.dp, elem,
                                                            pl.stages)
                assert pl.smem_bytes <= fa.MAX_SMEM, (d, elem, pl)
                assert pl.bq == 16 and pl.threads == 128
                assert pl.row_tiles == math.ceil(h // h_kv * sq / 16)
                # a second stage never costs a CTA an SM
                per_sm = fa.paged_ctas_per_sm(pl.smem_bytes)
                assert per_sm >= 1
                if pl.stages > 1:
                    assert per_sm == fa.paged_ctas_per_sm(
                        fa.paged_smem_bytes(pl.dp, elem, 1))
                # a split keeps the grid within one wave of the card
                assert pl.split & (pl.split - 1) == 0
                if pl.split > 1:
                    assert b * h_kv * pl.row_tiles * pl.split \
                        <= fa.SM_COUNT * per_sm


def test_paged_plan_of_the_serving_shapes():
    # h2o-danube decode: 8 slots, 32 q over 8 kv heads, d 80, 34 pages of
    # 16: 4 CTAs a (slot, kv head) share its live pages, 256 CTAs of 4 warps
    # in one wave (4 an SM); 8 would leave a warp under 2 tiles of the table
    h2o = fa.paged_plan(8, 32, 8, 1, 80, 16, 34, 4)
    assert h2o == fa.PagedPlan(80, 16, 1, 4, 1, 53_632, 128)
    assert fa.paged_ctas_per_sm(h2o.smem_bytes) == 4
    # a second stage would halve the CTAs an SM
    assert fa.paged_ctas_per_sm(fa.paged_smem_bytes(80, 4, 2)) == 2
    # nemotron-4-340b: 96 over 8 heads (12 live rows of the 16), d 192, 48
    # pages: one CTA an SM with 1 stage or 2, so 2 stages; 2 splits fill
    # the 132 SMs once
    nem = fa.paged_plan(8, 96, 8, 1, 192, 16, 48, 4)
    assert nem == fa.PagedPlan(192, 16, 1, 2, 2, 225_664, 128)
    # a 3-row verify block: 36 rows are three query tiles, 192 CTAs already
    ver = fa.paged_plan(8, 96, 8, 3, 192, 16, 48, 4)
    assert ver.row_tiles == 3 and ver.split == 1
    # bf16 pages halve the ring
    assert fa.paged_plan(8, 32, 8, 1, 80, 16, 34, 2).smem_bytes == 33_152
    # a short table, or many slots, take no split
    assert fa.paged_plan(4, 8, 2, 1, 16, 4, 5, 4).split == 1
    assert fa.paged_plan(64, 32, 8, 1, 80, 16, 34, 4).split == 1
    # one long sequence splits 8 ways
    assert fa.paged_plan(1, 32, 8, 1, 80, 16, 256, 4).split == 8
    # Q, a ring of 1 stage x 4 warps x {K, V} x 16 rows, the merged partial
    assert fa.paged_smem_bytes(80, 4, 1) == (16 * 84 * 4 + 4 * 2 * 16 * 84
                                             * 4 + 16 * 82 * 4)


def test_paged_plan_reads_no_device_clock():
    """The plan's inputs are sizes the host knows; `last` lives on the
    device and reading it would sync the host every layer."""
    assert list(inspect.signature(fa.paged_plan).parameters) == \
        ["b", "h", "h_kv", "sq", "d", "page", "pp", "elem"]


def test_paged_plan_refuses_what_the_kernel_does_not_take():
    for args in [(8, 32, 8, 1, 0, 16, 34, 4), (8, 32, 8, 1, 257, 16, 34, 4),
                 (8, 32, 8, 1, 80, 16, 34, 8), (8, 30, 8, 1, 80, 16, 34, 4),
                 (8, 32, 8, 0, 80, 16, 34, 4), (8, 32, 8, 1, 80, 16, 0, 4),
                 (0, 32, 8, 1, 80, 16, 34, 4), (8, 32, 8, 1, 80, 0, 34, 4)]:
        with pytest.raises(ValueError):
            fa.paged_plan(*args)


# ---------------------------------------------------------------------------
# paged split-and-merge mirror
# ---------------------------------------------------------------------------

def paged_split_mirror(q, k_pages, v_pages, table, last, split, *,
                       window=None, softcap=None, warps=4, bk=16):
    """The paged kernel's arithmetic in plain PyTorch (f32): for each slot,
    the live pages [ip_lo, ip_hi) split in rank order into `split` shares
    of whole pages; a share's positions cut into bk-key tiles, tile t
    walked by warp t % warps with an online softmax from m = -1e30, l = 0;
    masked scores inside a live page are -1e30, keys past the share add
    exactly 0; the warps' (m, l, o) merge in warp order, the ranks' in rank
    order; a row with l == 0 is divided by 1."""
    b, h, sq, d = q.shape
    _, h_kv, page, _ = k_pages.shape
    g = h // h_kv
    pp = table.shape[1]
    scale = d ** -0.5
    out = torch.zeros((b, h, sq, d), dtype=torch.float32)

    def merge(parts):
        ms = torch.stack([m for m, _, _ in parts])        # (n, h, sq)
        mc = ms.max(0).values
        f = torch.exp(ms - mc)
        return (mc, (f * torch.stack([l for _, l, _ in parts])).sum(0),
                (f[..., None] * torch.stack([o for _, _, o in parts])).sum(0))

    for bb in range(b):
        last_b = int(last[bb])
        ip_hi = min(pp, last_b // page + 1) if last_b >= 0 else 0
        ip_lo = 0
        if window is not None:
            x = last_b - (sq - 1) - window - page + 1
            ip_lo = 0 if x < 0 else x // page + 1
        n_live = max(0, ip_hi - ip_lo)
        qpos = last_b - (sq - 1) + torch.arange(sq)
        kv_h = torch.arange(h) // g
        qf = q[bb].float()                                # (h, sq, d)
        ranks = []
        for rank in range(split):
            beg = (ip_lo + rank * n_live // split) * page
            end = (ip_lo + (rank + 1) * n_live // split) * page
            n_tiles = -(-(end - beg) // bk)
            parts = []
            for w in range(warps):
                m = torch.full((h, sq), NEG)
                l = torch.zeros((h, sq))
                o = torch.zeros((h, sq, d))
                for t in range(w, n_tiles, warps):
                    keys = torch.arange(beg + t * bk, beg + (t + 1) * bk)
                    live = keys < end
                    kk = keys.clamp(max=end - 1)
                    rows = table[bb, kk // page].long()
                    kt = k_pages[rows[:, None], kv_h[None, :], (kk % page)[:, None]]
                    vt = v_pages[rows[:, None], kv_h[None, :], (kk % page)[:, None]]
                    s = torch.einsum("hqd,khd->hqk", qf, kt.float()) * scale
                    if softcap is not None:
                        s = softcap * torch.tanh(s / softcap)
                    ok = keys[None, :] <= qpos[:, None]
                    if window is not None:
                        ok &= keys[None, :] > qpos[:, None] - window
                    s = torch.where(ok[None], s, torch.tensor(NEG))
                    s = torch.where(live[None, None], s,
                                    torch.tensor(-math.inf))
                    m_cur = torch.maximum(m, s.max(-1).values)
                    alpha = torch.exp(m - m_cur)
                    p = torch.exp(s - m_cur[..., None])
                    l = l * alpha + p.sum(-1)
                    p = p.to(vt.dtype).float()
                    o = o * alpha[..., None] + torch.einsum(
                        "hqk,khd->hqd", p, vt.float())
                    m = m_cur
                parts.append((m, l, o))
            ranks.append(merge(parts))
        _, l, o = merge(ranks)
        out[bb] = o / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    return out.to(q.dtype)


def _paged_inputs(seed, b, h, h_kv, sq, d, page, pp, last):
    rng = np.random.default_rng(seed)
    n_pages = b * pp + 1
    kp = rng.standard_normal((n_pages, h_kv, page, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, h_kv, page, d)).astype(np.float32)
    table = (rng.permutation(n_pages - 1) + 1).reshape(b, pp).astype(np.int32)
    last = np.asarray(last, np.int32)
    for bb in range(b):       # pages past a slot's clock stay on the sink
        table[bb, max(0, last[bb]) // page + 1:] = 0
    table[1] = 0              # an idle slot parked on the sink page
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    return q, kp, vp, table, last


# (h, h_kv, sq, window, softcap, last): slot 1 idle on the sink page; slot 2
# holds fewer live pages than the splits (a short `last`, 2 pages of 8)
PAGED_CASES = [
    (8, 2, 1, None, None, [95, 0, 9, 60]),
    (8, 2, 3, None, None, [95, 2, 9, 60]),
    (8, 2, 1, 64, None, [95, 0, 9, 80]),
    (8, 2, 3, 64, 50.0, [95, 0, 9, 70]),
    (8, 2, 1, None, 50.0, [95, 0, 13, 60]),
    (4, 4, 3, 64, None, [90, 0, 12, 33]),
]


@pytest.mark.parametrize("h,h_kv,sq,window,softcap,last", PAGED_CASES)
def test_paged_split_mirror_matches_plain_and_pallas(h, h_kv, sq, window,
                                                     softcap, last):
    b, d, page, pp = 4, 16, 8, 12          # 96 positions, 12 pages a slot
    q, kp, vp, table, last = _paged_inputs(len(last) + sq, b, h, h_kv, sq, d,
                                           page, pp, last)
    t = [torch.from_numpy(x) for x in (q, kp, vp, table, last)]
    kw = dict(window=window, softcap=softcap)
    want = pref.paged_attention_ref(*t, **kw)
    jax_out = np.asarray(jops.paged_attention(
        *map(jnp.asarray, (q, kp, vp, table, last)), backend="interpret",
        **kw))
    np.testing.assert_allclose(want.numpy(), jax_out, rtol=2e-3, atol=2e-3)
    for split in range(1, 9):
        got = paged_split_mirror(*t, split, **kw)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"split {split}")
    # a split whose share is empty (slot 2 at 8 splits, the idle slot at
    # any split above 1) merges as nothing, never as NaN
    assert torch.isfinite(got).all()


def test_paged_split_mirror_bf16_pages_round_p():
    """bf16 pages: p is rounded to v's dtype before PV on both sides."""
    q, kp, vp, table, last = _paged_inputs(7, 4, 8, 2, 1, 16, 8, 12,
                                           [95, 0, 9, 60])
    t = [torch.from_numpy(q), torch.from_numpy(kp).bfloat16(),
         torch.from_numpy(vp).bfloat16(), torch.from_numpy(table),
         torch.from_numpy(last)]
    want = pref.paged_attention_ref(*t)
    for split in (1, 3, 8):
        got = paged_split_mirror(*t, split)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2.0 ** -7,
                                   atol=8e-3)


# ---------------------------------------------------------------------------
# scan_plan
# ---------------------------------------------------------------------------

def test_scan_plan_fits_every_shape():
    for bsz in (1, 2, 8):
        for s in (1, 7, 15, 16, 31, 33, 64, 65, 130, 512, 4096):
            for di in (1, 72, 128, 512, 8192):
                for st in (1, 4, 5, 8, 16, 17, 32):
                    pl = ss.scan_plan(bsz, s, di, st)
                    assert pl.groups * ss.SCAN_STATES >= st
                    assert pl.groups in (1, 2, 4, 8)
                    # a warp per (group, 32 channels); 4 warps or 8 a CTA
                    assert pl.threads == 32 * max(4, pl.groups)
                    assert pl.channels * pl.groups == pl.threads
                    assert pl.smem_bytes == ss.scan_smem_bytes(pl.groups)
                    assert pl.smem_bytes <= 232_448


def test_scan_plan_of_the_serving_shapes():
    # falcon-mamba prefill: one sequence, d_inner 8192, d_state 16: 4 groups
    # of 4 states, 32 channels a CTA (256 CTAs, 1,024 warps) at any length
    for s in (1, 32, 64, 512):
        pl = ss.scan_plan(1, s, 8192, 16)
        assert (pl.groups, pl.channels, pl.threads) == (4, 32, 128)
    # u, dt (32 x 32), b, c (32 x 16), y parts (32 x 4 x 32), f32
    assert ss.scan_plan(1, 512, 8192, 16).smem_bytes == 4 * (
        2 * 32 * 32 + 2 * 32 * 16 + 32 * 4 * 32) == 28_672
    assert ss.scan_plan(2, 33, 128, 8) == ss.ScanPlan(2, 64, 34_816, 128)
    # d_state 32: 8 groups, 8 warps a CTA; d_state 4: 16 positions staged
    assert ss.scan_plan(1, 512, 8192, 32).threads == 256
    assert ss.scan_plan(1, 512, 8192, 4) == ss.ScanPlan(1, 128, 4 * (
        2 * 16 * 128 + 2 * 16 * 4 + 16 * 128), 128)


def test_scan_plan_refuses_what_the_kernel_does_not_take():
    for args in [(1, 512, 8192, 0), (1, 512, 8192, 33), (0, 512, 8192, 16),
                 (1, 0, 8192, 16), (1, 512, 0, 16), (70000, 8, 64, 16)]:
        with pytest.raises(ValueError):
            ss.scan_plan(*args)


# ---------------------------------------------------------------------------
# grouped scan mirror
# ---------------------------------------------------------------------------

def grouped_scan_mirror(u, dt, b, c, a, groups, staged):
    """The scan kernel's arithmetic in plain PyTorch (f32): d_state padded
    to `groups` groups of 4 (a = b = c = 0 past it); the decay factor is
    2^(dt * (a * log2 e)), as the kernel forms it; each group's part of
    y_t is its 4 states' c * h summed in order, and y_t the groups' parts
    summed in group order; positions go through `staged` at a time, the
    last block padded with dt = u = 0, which leaves h as it is."""
    uf, dtf, bf, cf = u.float(), dt.float(), b.float(), c.float()
    bsz, s, di = u.shape
    st = a.shape[1]
    sw = ss.SCAN_STATES * groups
    pad = lambda x: torch.nn.functional.pad(x, (0, sw - st))
    a2 = pad(a.float() * math.log2(math.e))
    bf, cf = pad(bf), pad(cf)
    h = torch.zeros((bsz, di, sw))
    y = torch.zeros((bsz, s, di))
    for t0 in range(0, s, staged):
        for t in range(t0, t0 + staged):
            live = t < s
            d = dtf[:, t] if live else torch.zeros((bsz, di))
            x = d * uf[:, t] if live else torch.zeros((bsz, di))
            bt = bf[:, t] if live else torch.zeros((bsz, sw))
            h = torch.exp2(d[:, :, None] * a2) * h + x[:, :, None] * bt[:, None]
            if live:
                part = (cf[:, t, None] * h).reshape(bsz, di, groups,
                                                     ss.SCAN_STATES)
                p = part[..., 0]
                for n in range(1, ss.SCAN_STATES):
                    p = p + part[..., n]
                yt = p[..., 0]
                for k in range(1, groups):
                    yt = yt + p[..., k]
                y[:, t] = yt
    return y.to(u.dtype), h[..., :st]


def _scan_inputs(seed, bsz, s, di, st):
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    u = n(bsz, s, di) * 0.5
    dt = np.log1p(np.exp(n(bsz, s, di) - 1.0)).astype(np.float32)
    b, c = n(bsz, s, st) * 0.5, n(bsz, s, st) * 0.5
    a = -np.exp(n(di, st) * 0.3).astype(np.float32)
    return u, dt, b, c, a


@pytest.mark.parametrize("bsz,s,di,st", [
    (2, 37, 12, 8),      # S off the staged blocks
    (1, 64, 8, 16),      # S on the staged-block boundary
    (1, 1, 8, 16),       # one position: the block holds 31 dead ones
    (2, 9, 6, 5),        # ragged d_state
])
def test_grouped_scan_mirror_matches_plain_and_jax(bsz, s, di, st):
    arrays = _scan_inputs(bsz * 100 + s, bsz, s, di, st)
    t = [torch.from_numpy(x) for x in arrays]
    want_y, want_h = pref.ssm_scan_ref(*t)
    jy, jh = jssm_ref(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(want_y.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(want_h.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)
    pl = ss.scan_plan(bsz, s, di, st)
    for groups in range(pl.groups, 9):
        if groups & (groups - 1):
            continue
        y, h = grouped_scan_mirror(*t, groups, 16 if groups == 1 else 32)
        np.testing.assert_allclose(y.numpy(), want_y.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=f"{groups} groups")
        np.testing.assert_allclose(h.numpy(), want_h.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=f"{groups} groups")


@pytest.mark.parametrize("st", [1, 4, 5, 8, 16, 17, 32])
def test_grouped_scan_mirror_at_the_planned_groups(st):
    """The groups the plan picks for each d_state, through the mirror,
    against the plain version."""
    bsz, s, di = 2, 33, 20
    pl = ss.scan_plan(bsz, s, di, st)
    t = [torch.from_numpy(x) for x in _scan_inputs(3 + st, bsz, s, di, st)]
    y, h = grouped_scan_mirror(*t, pl.groups, 16 if pl.groups == 1 else 32)
    want_y, want_h = pref.ssm_scan_ref(*t)
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-4)
