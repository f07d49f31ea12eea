"""The tensor-core design of the port's prefill attention kernels (the bf16
forms of kernel 3, ``flash_prefill``, and kernel 8, ``paged_flash_prefill``)
on the CPU.

``csrc/prefill_mma.cuh`` packs 64 / group positions x the group's q heads
of one kv head into each 64-row tile, walks each tile's keys from its
oldest row's band start to its newest row's last key in 64-key tiles,
splits the walk over blocks when the tiles alone leave the card idle, and
runs both products on bf16 tensor cores with P split into a high and a low
bf16 part. The kernel runs only on the card; here its tiling
(:mod:`prefill_tiles`, the arithmetic the kernel does) is held on its
own, and a plain torch emulation of its arithmetic (packed tiles, per-tile
online softmax in log2 units, P split hi + lo, f32 accumulators, the
log-sum-exp merge of the splits) is held against the port's plain versions
and the JAX kernels in interpret mode (as tests/test_flash_attention.py and
tests/test_sliding_window.py run them) on the same numpy inputs: float32
within 1e-5 (summation order); bfloat16 by the card's rule, one bf16 ulp of
each output plus 1e-5 of the largest, at the Mistral window chunk and the
prefix path's suffix batch (heads cut to 4 and 2: each head is
independent). With P rounded to bf16 alone, as the TPU kernels round it,
the emulation breaks that rule at the Mistral chunk.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.ops.attention.flash_prefill import (
    flash_prefill as jflash_prefill)
from simplellminference_tpu.ops.attention.paged_prefill import (
    paged_flash_prefill as jpaged_prefill)
from simplellminference_tpu_torch.ops.attention import flash_prefill as tfp
from simplellminference_tpu_torch.ops.attention import paged_prefill as tpp
from simplellminference_tpu_torch.ops.attention import prefill_tiles as pt

TOL = 1e-5
F32_REL = 1e-5
NEG_INF = -1e30
LOG2E = 1.4426950408889634


def t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def j(a):
    return None if a is None else jnp.asarray(a)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------ the tiling

@pytest.mark.parametrize("group", [1, 3, 4, 8, 80])
@pytest.mark.parametrize("seq", [1, 64, 100, 256])
def test_tiles_hold_every_row_once(group, seq):
    heads, positions, chunks = pt.packing(group)
    assert heads * positions <= pt.TILE and heads * chunks >= group
    seen = np.zeros((seq, group), np.int64)
    tiles = pt.tile_rows(seq, group)
    assert len(tiles) == pt.grid_tiles(seq, group)
    for p0, hc, held in tiles:
        for r in range(pt.TILE):     # row r as the kernel reads it
            pl, hg = r // heads, hc * heads + r % heads
            if pl < positions and p0 + pl < seq and hg < group:
                assert pl < held
                seen[p0 + pl, hg] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("window", [0, 6, 200, 4096])
@pytest.mark.parametrize("sq", [1, 64, 100, 256])
def test_walk_covers_every_admitted_pair_once(group, window, sq):
    rng = np.random.default_rng(group * 1000 + window + sq)
    _h, positions, _c = pt.packing(group)
    for _ in range(12):
        off = int(rng.choice([0, 1, 63, 64, 100, 3840, int(rng.integers(0,
                                                                       5000))]))
        n_keys = int(rng.integers(max(1, off - 50), off + sq + 70))
        splits = int(rng.choice([1, 2, 3, 16]))
        kmax = off + sq + 70
        count = np.zeros((sq, kmax), np.int64)
        for p0 in range(0, sq, positions):
            k_lo, last = pt.key_walk(p0, positions, sq, off, n_keys, window)
            # no key below the tile's oldest row's band, none past its
            # newest row or the keys
            assert k_lo == (max(0, off + p0 - window + 1) if window else 0)
            assert last == min(off + min(p0 + positions, sq) - 1,
                               n_keys - 1)
            cuts = pt.split_keys(k_lo, last, splits)
            assert len(cuts) == splits
            rows = slice(p0, min(p0 + positions, sq))
            for lo, hi in cuts:
                assert lo <= hi and (lo == hi or (lo >= k_lo and hi <= last
                                                  + 1))
                assert (lo - k_lo) % pt.TILE == 0 or lo == hi
                count[rows, lo:hi] += 1
        pos = off + np.arange(sq)[:, None]
        key = np.arange(kmax)[None]
        admitted = (key <= pos) & (key < n_keys)
        if window:
            admitted &= key > pos - window
        assert (count[admitted] == 1).all()
        assert (count <= 1).all()


@pytest.mark.parametrize("b,seq,n,kvn,window,cap,want", [
    (1, 256, 32, 8, 4096, 35 * 128, 2),   # Mistral window chunk (8w): 128
    (8, 64, 32, 32, 0, 5 * 128, 1),       # the prefix suffix batch: 256
    (1, 256, 32, 32, 0, 6 * 128, 1),      # a 256-row chunk: short walks
    (8, 128, 32, 32, 0, 128, 1),          # kernel 3 at bench.py's prompts
    (8, 128, 32, 8, 4096, 128, 1),        # 3w, Mistral prompts
    (1, 1000, 8, 8, 0, 1000, 2),
    (1, 64, 1, 1, 0, 100000, 16),         # the cap
    (1, 64, 1, 1, 0, 8 * 64 - 1, 1),      # a split walks 8 tiles at least
])
def test_splits_from_shapes(b, seq, n, kvn, window, cap, want):
    assert pt.launch_splits(b, seq, n, kvn, window, cap) == want


# ------------------------------------------------ the kernel's arithmetic

def emulate(q, k_all, v_all, readable, offs, n_keys, window, splits,
            p_mode, scale=None, sinks=None):
    """The kernel's arithmetic in plain torch: q [B, Sq, N, D] at positions
    offs[b] + s; k_all / v_all [B, kvN, K, D] f32 (the values the kernel
    multiplies: bf16 rows, or INT8 codes x scale rounded to q's dtype);
    readable [B, K]: a row the kernel may read (mapped page). Rows outside
    a tile's walk or unreadable are zero-filled (never read), masked keys
    enter the products with p = 0. p_mode: "f32" (the f32 forms), "split"
    (p_hi + p_lo in bf16) or "round" (p in bf16 alone, as the TPU kernels
    round it). ``sinks`` [N]: split 0 of each tile starts its rows' state at
    (m, l) = (their heads' sink x log2 e, 1), as the kernels' sink forms
    do. Returns [B, Sq, N, D] in q's dtype."""
    b, sq, n, d = q.shape
    kvn, kmax = k_all.shape[1], k_all.shape[2]
    group = n // kvn
    heads, positions, chunks = pt.packing(group)
    scale = (d ** -0.5 if scale is None else scale) * LOG2E
    tiles = pt.tile_rows(sq, group)
    # one entry per (sequence, kv head, tile, split)
    ent = [(bi, kh, p0, hc, z) for bi in range(b) for kh in range(kvn)
           for p0, hc, _held in tiles for z in range(splits)]
    T = len(ent)
    r = torch.arange(pt.TILE)
    pl, hl = r // heads, r % heads
    qt = torch.zeros((T, pt.TILE, d))
    qpos = torch.zeros((T, pt.TILE), dtype=torch.long)
    rng_lo, rng_hi = torch.zeros(T, dtype=torch.long), torch.zeros(
        T, dtype=torch.long)
    kb = torch.zeros(T, dtype=torch.long)
    for i, (bi, kh, p0, hc, z) in enumerate(ent):
        pos = p0 + pl
        hg = hc * heads + hl
        ok = (pl < positions) & (pos < sq) & (hg < group)
        qt[i, ok] = q[bi, pos[ok], kh * group + hg[ok]].float()
        qpos[i] = int(offs[bi]) + pos
        k_lo, last = pt.key_walk(p0, positions, sq, int(offs[bi]),
                                 int(n_keys[bi]), window)
        lo, hi = pt.split_keys(k_lo, last, splits)[z]
        rng_lo[i], rng_hi[i], kb[i] = lo, hi, bi
    khead = torch.tensor([e[1] for e in ent])
    nk = torch.as_tensor(n_keys, dtype=torch.long)[kb]
    m = torch.full((T, pt.TILE), NEG_INF)
    l = torch.zeros((T, pt.TILE))
    if sinks is not None:
        for i, (bi, kh, p0, hc, z) in enumerate(ent):
            hg = hc * heads + hl
            ok = hg < group
            if z == 0:
                m[i, ok] = sinks.float()[kh * group + hg[ok]] * LOG2E
                l[i, ok] = 1.0
    o = torch.zeros((T, pt.TILE, d))
    steps = int(((rng_hi - rng_lo + pt.TILE - 1) // pt.TILE).max())
    for step in range(steps):
        kp = rng_lo[:, None] + step * pt.TILE + r[None]           # [T, 64]
        inwalk = kp < rng_hi[:, None]
        kc = kp.clamp(0, kmax - 1)
        live = inwalk & readable[kb[:, None], kc]
        kt = torch.where(live[..., None], k_all[kb[:, None], khead[:, None],
                                                 kc], 0.0)
        vt = torch.where(live[..., None], v_all[kb[:, None], khead[:, None],
                                                 kc], 0.0)
        s = qt @ kt.transpose(1, 2)                                # f32
        adm = ((kp[:, None, :] <= qpos[:, :, None])
               & (kp[:, None, :] < nk[:, None, None]))
        if window:
            adm &= kp[:, None, :] > qpos[:, :, None] - window
        s = torch.where(adm, s * scale, torch.full((), NEG_INF))
        active = (rng_lo + step * pt.TILE < rng_hi)[:, None]      # [T, 1]
        mn = torch.maximum(m, s.max(-1).values)
        ms = torch.where(mn <= NEG_INF, torch.zeros(()), mn)
        alpha = torch.exp2(m - ms)
        p = torch.exp2(s - ms[..., None])
        if p_mode == "f32":
            pv = p @ vt
        else:
            hi = p.to(torch.bfloat16).float()
            pv = hi @ vt
            if p_mode == "split":
                pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
        m = torch.where(active, mn, m)
        l = torch.where(active, l * alpha + p.sum(-1), l)
        o = torch.where(active[..., None], o * alpha[..., None] + pv, o)
    # merge the splits by log-sum-exp (one split: o / l)
    m, l, o = (x.reshape(-1, splits, *x.shape[1:]) for x in (m, l, o))
    mx = m.max(1, keepdim=True).values
    f = torch.exp2(m - mx)
    out_t = (f[..., None] * o).sum(1) / (f * l).sum(1).clamp_min(
        1e-30)[..., None]
    out = torch.zeros((b, sq, n, d))
    for i, (bi, kh, p0, hc, z) in enumerate(ent[::splits]):
        pos = p0 + pl
        hg = hc * heads + hl
        ok = (pl < positions) & (pos < sq) & (hg < group)
        out[bi, pos[ok], kh * group + hg[ok]] = out_t[i, ok]
    return out.to(q.dtype)


def paged_keys(pk, pv, tables, layer, ks=None, vs=None, dtype=torch.float32):
    """[B, kvN, MP * ps, D] f32 K and V through the tables (INT8 codes x
    scale rounded to ``dtype``, as the kernel converts them) and which
    rows the kernel may read (a page id in range)."""
    p1, kvn, ps = pk.shape[1], pk.shape[2], pk.shape[3]
    b, mp = tables.shape
    col = torch.arange(mp * ps) // ps
    page = tables.long()[:, col]                                  # [B, K]
    readable = (page >= 0) & (page < p1)
    pc = page.clamp(0, p1 - 1)
    inp = (torch.arange(mp * ps) % ps)[None].expand(b, -1)

    def rows(pool, sc):
        x = pool[layer][pc, :, inp].float()                      # [B,K,kvN,D]
        if sc is not None:
            x = (x * sc[layer][pc, :, inp][..., None]).to(dtype).float()
        return x.transpose(1, 2)
    return rows(pk, ks), rows(pv, vs), readable


def dense_keys(k, v):
    b, s = k.shape[:2]
    return (k.float().transpose(1, 2), v.float().transpose(1, 2),
            torch.ones((b, s), dtype=torch.bool))


def bf16_ulp(a):
    return torch.exp2(torch.floor(torch.log2(a.abs().clamp_min(2.0 ** -100)))
                      - 7)


def rule_share(got, want):
    """The card's rule for bf16 outputs (chip_smoke._rounding_rule): the
    largest share of its limit an element takes (<= 1 passes)."""
    g, w = got.float(), want.float()
    lim = F32_REL * float(w.abs().max()) + bf16_ulp(torch.maximum(g.abs(),
                                                                 w.abs()))
    return float(((g - w).abs() / lim).max())


def close(got, want, rows=None):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if rows is not None:
        g = np.concatenate([g[i, :n] for i, n in enumerate(rows)])
        w = np.concatenate([w[i, :n] for i, n in enumerate(rows)])
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("window", [None, 6, 40])
@pytest.mark.parametrize("n,kvn", [(8, 8), (8, 2), (8, 1)])
@pytest.mark.parametrize("splits", [1, 2])
def test_emulation_matches_flash_prefill(window, n, kvn, splits):
    rng = np.random.default_rng(n * kvn + (window or 0) + splits)
    b, s, d = 2, 64, 32
    q, k, v = rand(rng, b, s, n, d), rand(rng, b, s, kvn, d), rand(
        rng, b, s, kvn, d)
    got = emulate(t(q), *dense_keys(t(k), t(v)), [0] * b, [s] * b,
                  window or 0, splits, "f32")
    close(got, tfp.flash_prefill_ref(t(q), t(k), t(v), window=window))
    want = jflash_prefill(j(q), j(k), j(v), causal=True, bq=32, bk=32,
                          interpret=True, window=window)
    close(got, want)


L, KVN, N, D, PS = 2, 2, 8, 32, 8


def _pools(rng, pages, quant):
    shape = (L, pages, KVN, PS, D)
    if not quant:
        return rand(rng, *shape), rand(rng, *shape), None, None
    return (rng.integers(-127, 128, shape).astype(np.int8),
            rng.integers(-127, 128, shape).astype(np.int8),
            rng.uniform(0.01, 0.1, shape[:-1]).astype(np.float32),
            rng.uniform(0.01, 0.1, shape[:-1]).astype(np.float32))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8kv"])
@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("splits", [1, 3])
def test_emulation_matches_paged_flash_prefill(quant, window, splits):
    rng = np.random.default_rng(7 + 2 * quant + (window or 0) + splits)
    b, s, mp = 2, 32, 8
    pk, pv, ks, vs = _pools(rng, b * mp + 1, quant)
    tables = rng.permutation(b * mp)[:b * mp].astype(np.int32).reshape(b, mp)
    offs = np.asarray([8, 24], np.int32)
    lens = np.asarray([8 + 32, 24 + 19], np.int32)
    q = rand(rng, b, s, N, D)
    kk, vv, readable = paged_keys(t(pk), t(pv), t(tables), 1, _tt(ks),
                                  _tt(vs))
    got = emulate(t(q), kk, vv, readable, offs, lens, window or 0, splits,
                  "f32")
    live = list(lens - offs)
    close(got, tpp.paged_flash_prefill_ref(
        t(q), t(pk), t(pv), t(tables), t(lens), t(offs), 1, window=window,
        k_scale=_tt(ks), v_scale=_tt(vs)), live)
    want = jpaged_prefill(j(q), j(pk), j(pv), j(tables), j(lens), j(offs),
                          bq=32, interpret=True, layer=jnp.int32(1),
                          k_scale=j(ks), v_scale=j(vs), window=window)
    close(got, want, live)


def _tt(a):
    return None if a is None else t(a)


def _serving_case(shape, seed):
    """bf16 q and pools at one of the kernels' serving shapes, heads cut:
    the Mistral window chunk (256 rows at offset 3840, kv_len 4096, window
    4096, group 4, D 128, page 128) or the prefix path's suffix batch (8 x
    64 rows at offset 512, kv_len 540-575, group 1)."""
    rng = np.random.default_rng(seed)
    if shape == "mistral chunk":
        b, sq, n, kvn, offs, lens, window = 1, 256, 4, 1, [3840], [4096], 4096
    else:
        b, sq, n, kvn, offs, lens, window = (8, 64, 2, 2, [512] * 8,
                                             [540 + 5 * i for i in range(8)],
                                             None)
    d, ps = 128, 128
    mp = -(-max(o + sq for o in offs) // ps)
    bf = torch.bfloat16
    shape5 = (2, b * mp + 1, kvn, ps, d)
    pk, pv = (t(rand(rng, *shape5)).to(bf) for _ in range(2))
    tables = t(rng.permutation(b * mp).astype(np.int32).reshape(b, mp))
    q = t(rand(rng, b, sq, n, d)).to(bf)
    return (q, pk, pv, tables, torch.tensor(lens, dtype=torch.int32),
            torch.tensor(offs, dtype=torch.int32), window)


@pytest.mark.parametrize("shape,splits", [("mistral chunk", 2),
                                          ("suffix batch", 1),
                                          ("suffix batch", 2)])
def test_split_p_meets_the_rounding_rule_in_bf16(shape, splits):
    q, pk, pv, tables, lens, offs, window = _serving_case(shape, 11)
    kk, vv, readable = paged_keys(pk, pv, tables, 1)
    got = emulate(q, kk, vv, readable, offs, lens, window or 0, splits,
                  "split")
    want = tpp.paged_flash_prefill_ref(q, pk, pv, tables, lens, offs, 1,
                                       window=window)
    assert got.dtype == torch.bfloat16
    assert rule_share(got, want) <= 1.0


def test_p_rounded_to_bf16_alone_breaks_the_rule():
    # why the kernel splits P: the TPU kernels' p.astype(v.dtype) before
    # the PV product, on tensor cores, misses the card's rule at the
    # Mistral chunk (24-65x at full width on the card's shapes)
    q, pk, pv, tables, lens, offs, window = _serving_case("mistral chunk",
                                                          11)
    kk, vv, readable = paged_keys(pk, pv, tables, 1)
    want = tpp.paged_flash_prefill_ref(q, pk, pv, tables, lens, offs, 1,
                                       window=window)
    split = emulate(q, kk, vv, readable, offs, lens, window, 2, "split")
    rounded = emulate(q, kk, vv, readable, offs, lens, window, 2, "round")
    assert rule_share(split, want) <= 1.0
    assert rule_share(rounded, want) > 4.0


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8kv"])
def test_nan_pages_below_the_band_and_unmapped_pages(quant):
    # ring tables (column j of slot s -> s * R + j % R) whose columns below
    # the oldest row's band point at NaN pages, and an unmapped page inside
    # kv_len: the emulated kernel reads neither, so its output over the
    # poisoned tables is finite and bit-equal to the clean one's, and
    # within 1e-5 of the plain version (which reads the unmapped page as
    # zeros too)
    rng = np.random.default_rng(3 + quant)
    b, r, mp, window, s = 2, 5, 8, 12, 16
    pk, pv, ks, vs = _pools(rng, b * r + 5, quant)
    for x in (ks, vs) if quant else (pk, pv):
        x[:, b * r:b * r + 4] = np.nan
    ring = (np.arange(b)[:, None] * r + np.arange(mp)[None] % r).astype(
        np.int32)
    offs = np.asarray([24, 40], np.int32)
    lens = offs + np.asarray([s, 9], np.int32)
    ring[1, (offs[1] + 3) // PS] = -1        # unmapped, inside kv_len
    k_lo = offs - window + 1
    dirty = ring.copy()
    below = (np.arange(mp)[None] + 1) * PS <= k_lo[:, None]
    dirty[below] = b * r + (np.arange(mp)[None].repeat(b, 0)[below] % 4)
    assert below.any()
    q = rand(rng, b, s, N, D)
    outs = []
    for tb in (ring, dirty):
        kk, vv, readable = paged_keys(t(pk), t(pv), t(tb), 1, _tt(ks),
                                      _tt(vs))
        outs.append(emulate(t(q), kk, vv, readable, offs, lens, window, 2,
                            "f32"))
    assert torch.isfinite(outs[1]).all()
    assert torch.equal(outs[0], outs[1])
    plain = [tpp.paged_flash_prefill_ref(
        t(q), t(pk), t(pv), t(tb), t(lens), t(offs), 1, window=window,
        k_scale=_tt(ks), v_scale=_tt(vs)) for tb in (ring, dirty)]
    assert torch.equal(plain[0], plain[1])
    close(outs[1], plain[0], list(lens - offs))
