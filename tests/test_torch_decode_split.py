"""The split key walk of the port's decode attention kernel (forms 4*, 13)
on the CPU.

``csrc/paged_decode.cu`` cuts each sequence's live keys into splits, one
block each, and merges the splits' f32 partials (m, l, acc) by
log-sum-exp. The kernel runs only on the card; here its cut
(:func:`split_keys`, the arithmetic the kernel does) and its chooser
(:func:`decode_splits`, from shapes alone) are held on their own, and a
plain torch emulation of the split-and-merge (partials per split with the
kernel's late INT8 dequant, empty splits included, then the merge) is held
against the port's plain versions and the JAX kernels in interpret mode
(as tests/test_paged_decode.py and tests/test_sliding_window.py run them)
on the same numpy inputs. Float32; stated tolerance 1e-5 (summation
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.ops.attention.flash_decode import (
    flash_decode as jflash_decode)
from simplellminference_tpu.ops.attention.paged_decode import (
    paged_flash_decode as jpaged_decode)
from simplellminference_tpu.ops.attention.paged_decode import (
    paged_flash_verify as jpaged_verify)
from simplellminference_tpu_torch.ops.attention import flash_decode as tfd
from simplellminference_tpu_torch.ops.attention import paged_decode as tpd

TOL = 1e-5
L, KVN, N, D, PS = 2, 2, 4, 32, 8


def t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("seed", range(6))
def test_split_keys_cover_every_live_key_once(seed):
    rng = np.random.default_rng(seed)
    for _ in range(400):
        b, kvn = int(rng.integers(1, 17)), int(rng.choice([1, 4, 8, 32]))
        mp, ps = int(rng.integers(1, 40)), int(rng.choice([8, 16, 128]))
        wins = int(rng.choice([1, 2, 5, 8]))
        window = int(rng.choice([0, 0, 1, 6, 200, 4096]))
        kv_len = int(rng.integers(-2, mp * ps + 50))
        span = mp * ps if not window else min(mp * ps, window + wins - 1)
        z = tpd.decode_splits(b, kvn, span)
        cuts = tpd.split_keys(kv_len, wins, window, mp * ps, z)
        n_keys = max(0, min(kv_len, mp * ps))
        k_lo = max(0, kv_len - wins - window + 1) if window else 0
        keys = [k for lo, hi in cuts for k in range(lo, hi)]
        # every live key exactly once, in order; none below the band
        assert keys == list(range(k_lo, n_keys))
        assert len(cuts) == z and all(lo <= hi for lo, hi in cuts)
        # whole 64-key tiles: every cut inside the span is tile-aligned
        for lo, hi in cuts:
            assert lo == k_lo or lo % tpd.TILE_KEYS == 0 or lo == hi
            assert hi == n_keys or hi % tpd.TILE_KEYS == 0 or lo == hi


@pytest.mark.parametrize("b,kvn,span,rows,want", [
    (4, 8, 4096, 4, 8),        # Mistral-7B decode (4w): 32 blocks
    (4, 8, 4100, 20, 8),       # its verify window (4vw, S 5)
    (8, 32, 4096, 1, 1),       # Llama-2-7B at kv_len 4096: 256 blocks
    (8, 32, 3 * 128, 1, 1),    # the bench shape (MP 3)
    (4, 32, 2048, 1, 2),
    (9, 4, 8320, 8, 7),        # the TinyLlama draft arena (13)
    (1, 1, 64, 1, 1),          # one tile: one split
    (1, 1, 100000, 1, 32),     # the cap
    (2, 8, 256, 40, 4),        # 40 rows: two row blocks, tiles cap it
])
def test_decode_splits_from_shapes(b, kvn, span, rows, want):
    rb = tpd.row_blocks(rows)
    z = tpd.decode_splits(b, kvn, span, rb)
    assert z == want
    tiles = -(-span // tpd.TILE_KEYS)
    blocks = b * kvn * rb
    assert 1 <= z <= min(tpd.MAX_SPLITS, tiles)
    # one wave of two blocks per SM, as full as the tiles and the cap let
    assert z == 1 or blocks * z <= 2 * tpd.SM_COUNT
    assert z in (tpd.MAX_SPLITS, tiles) or blocks * (z + 1) > 2 * tpd.SM_COUNT


def split_merge(q, k_pool, v_pool, tables, kv_lens, layer, splits,
                window=0, k_scale=None, v_scale=None, dense=False,
                sinks=None, seed_every_split=False):
    """The kernel's arithmetic in plain torch, f32: q [B, S, N, D] against
    paged pools [L, P+1, kvN, ps, D] (``dense``: the arena [L, B', kvN,
    Smax, D], sequence b reading row b), each split's keys from
    :func:`split_keys`; per split m (-1e30 with no key), l (the sum of the
    unscaled probabilities) and acc (with the V scale folded into p), the
    K scale times q.k; then the log-sum-exp merge. ``sinks`` [N]: split 0
    starts each row's state at (m, l) = (its head's sink, 1), as the
    kernel's sink forms do (``seed_every_split``: every split, the fault
    the kernel must not make)."""
    b, s, n, d = q.shape
    kvn, ps = k_pool.shape[2], k_pool.shape[3]
    group = n // kvn
    mp = 1 if dense else tables.shape[1]
    scale = d ** -0.5
    out = torch.zeros((b, s, n, d))
    for i in range(b):
        kv = int(kv_lens[i])
        parts = []
        for lo, hi in tpd.split_keys(kv, s, window, mp * ps, splits):
            kp = torch.arange(lo, hi)
            page = (torch.full_like(kp, i) if dense
                    else tables[i].long()[kp // ps])
            ok = page >= 0
            pg = page.clamp_min(0)
            kk = k_pool[layer, pg, :, kp % ps].float() * ok[:, None, None]
            vv = v_pool[layer, pg, :, kp % ps].float() * ok[:, None, None]
            ks = vs = torch.ones((len(kp), kvn))
            if k_scale is not None:
                ks = k_scale[layer, pg, :, kp % ps] * ok[:, None]
                vs = v_scale[layer, pg, :, kp % ps] * ok[:, None]
            # scores [S, N, keys]: head h reads kv head h // group
            qh = q[i].float().reshape(s, kvn, group, d)
            sc = torch.einsum("sghd,kgd->sghk", qh, kk) * scale
            sc = sc * ks.T[None, :, None, :]
            w = torch.arange(s)[:, None]
            live = kp[None] < kv - s + 1 + w
            if window:
                live &= kp[None] > kv - s + w - window
            sc = torch.where(live[:, None, None, :], sc,
                             torch.tensor(float("-inf")))
            m = torch.clamp_min(sc.amax(-1) if len(kp) else
                                torch.full((s, kvn, group), -1e30), -1e30)
            seed = sinks is not None and (seed_every_split or not parts)
            if seed:
                m = torch.maximum(m, sinks.float().reshape(kvn, group))
            p = torch.exp(sc - m[..., None])
            l_ = p.sum(-1)
            if seed:
                l_ = l_ + torch.exp(sinks.float().reshape(kvn, group) - m)
            acc = torch.einsum("sghk,kgd->sghd", p * vs.T[None, :, None, :],
                               vv)
            parts.append((m, l_, acc))
        mx = torch.stack([m for m, _l, _a in parts]).amax(0)
        wts = [torch.exp(m - mx) for m, _l, _a in parts]
        tot_l = sum(l_ * w_ for (_m, l_, _a), w_ in zip(parts, wts))
        tot_a = sum(a * w_[..., None] for (_m, _l, a), w_ in zip(parts, wts))
        out[i] = (tot_a / tot_l.clamp_min(1e-30)[..., None]).reshape(s, n, d)
    return out


def _pools(rng, pages, quant):
    shape = (L, pages, KVN, PS, D)
    if not quant:
        return (rng.standard_normal(shape).astype(np.float32),
                rng.standard_normal(shape).astype(np.float32), None, None)
    return (rng.integers(-127, 128, shape).astype(np.int8),
            rng.integers(-127, 128, shape).astype(np.int8),
            rng.uniform(0.01, 0.1, shape[:-1]).astype(np.float32),
            rng.uniform(0.01, 0.1, shape[:-1]).astype(np.float32))


def _case(seed, b, mp, lens, quant):
    rng = np.random.default_rng(seed)
    p = b * mp + 1
    pk, pv, ks, vs = _pools(rng, p, quant)
    tables = rng.permutation(p - 1)[:b * mp].astype(np.int32).reshape(b, mp)
    return rng, pk, pv, ks, vs, tables, np.asarray(lens, np.int32)


# kv_lens: 0, 1, tile edges +- 1 (64 keys), the table's end; 11 pages of 8
LENS = [0, 1, 63, 64, 65, 88]


@pytest.mark.parametrize("splits", [1, 2, 3, 32])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8kv"])
@pytest.mark.parametrize("s,window", [(1, 0), (5, 0), (1, 6), (5, 16),
                                      (5, 70)])
def test_split_merge_matches_plain_and_jax(s, window, quant, splits):
    b, mp = len(LENS), 11
    rng, pk, pv, ks, vs, tables, lens = _case(100 * s + window, b, mp, LENS,
                                              quant)
    q = rng.standard_normal((b, s, N, D)).astype(np.float32)
    got = split_merge(t(q), t(pk), t(pv), t(tables), t(lens), 1, splits,
                      window=window, k_scale=t(ks), v_scale=t(vs))
    kw = dict(k_scale=t(ks), v_scale=t(vs), window=window or None)
    jkw = dict(interpret=True, layer=jnp.int32(1), k_scale=j(ks),
               v_scale=j(vs), window=window or None)
    if s == 1:
        plain = tpd.paged_flash_decode_ref(t(q[:, 0]), t(pk), t(pv),
                                           t(tables), t(lens), 1, **kw)
        want = jpaged_decode(j(q[:, 0]), j(pk), j(pv), j(tables), j(lens),
                             **jkw)
        got = got[:, 0]
    else:
        plain = tpd.paged_flash_verify_ref(t(q), t(pk), t(pv), t(tables),
                                           t(lens), 1, **kw)
        want = jpaged_verify(j(q), j(pk), j(pv), j(tables), j(lens), **jkw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL,
                               atol=TOL)
    # against JAX where a row has keys (kv_len - S + s >= 0): a row with
    # none is zero in the port, something else in the JAX kernel
    has = (lens[:, None] - s + np.arange(s)[None] >= 0).reshape(
        (b,) + (s,) * (s > 1))
    np.testing.assert_allclose(got.numpy()[has], np.asarray(want)[has],
                               rtol=TOL, atol=TOL)
    assert not got[0].any()          # kv_len 0: every split empty, zeros


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8kv"])
def test_split_merge_reads_unmapped_pages_as_zeros(quant):
    # a dead slot (every page -1) and an unmapped tail inside kv_len: the
    # plain version's gather reads zeros there, as the kernel does (the
    # JAX kernel clamps such pages, only dead burst rows meet them)
    b, mp = 3, 11
    rng, pk, pv, ks, vs, tables, lens = _case(7, b, mp, [80, 70, 88], quant)
    tables[1, 5:] = -1
    tables[2] = -1
    q = rng.standard_normal((b, 1, N, D)).astype(np.float32)
    for splits in (1, 3):
        got = split_merge(t(q), t(pk), t(pv), t(tables), t(lens), 0, splits,
                          k_scale=t(ks), v_scale=t(vs))[:, 0]
        plain = tpd.paged_flash_decode_ref(t(q[:, 0]), t(pk), t(pv),
                                           t(tables), t(lens), 0,
                                           k_scale=t(ks), v_scale=t(vs))
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL,
                                   atol=TOL)
        assert not got[2].any()


@pytest.mark.parametrize("splits", [1, 2, 5])
def test_dense_split_merge_matches_plain_and_jax(splits):
    rng = np.random.default_rng(splits)
    b, smax = 6, 256
    shape = (L, b + 1, KVN, smax, D)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    lens = np.asarray([1, 0, 64, 129, 256, 200], np.int32)
    q = rng.standard_normal((b, N, D)).astype(np.float32)
    got = split_merge(t(q[:, None]), t(ck), t(cv), None, t(lens), 1, splits,
                      dense=True)[:, 0]
    plain = tfd.flash_decode_ref(t(q), t(ck), t(cv), t(lens), layer=1)
    want = jflash_decode(j(q), j(ck), j(cv), j(lens), bk=64, interpret=True,
                         layer=jnp.int32(1))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert not got[1].any()
