"""GPT-OSS's attention sinks in the port's kernels (the sink forms 3s, 3ws,
4s, 4ws, 4vs, 4vws, 8s, 8ws, 13s, 13ws) against the JAX package on the
CPU.

A sink is a learned logit per q head that joins each row's softmax
denominator and adds no value. The port's wrappers run their plain
versions on CPU tensors; the JAX kernels run in interpret mode, as the
JAX package's own tests run them, on the same numpy inputs (float32,
seeded), at head dims 32 and 64 (gpt-oss-20b's), with and without a
window, with kv_len 0 rows, ring tables whose columns below the band
point at NaN pages, and sinks drawn N(0, 1) as the JAX package draws
them or set above every score of their rows. Verify rows (S 5) run at a
GQA group of 8, gpt-oss-20b's: 40 rows, which the kernel holds in two
row blocks of 32 and 8; the dense arena's forms over a stacked arena.
The kernels' own arithmetic (split 0 seeding each row with (sink, 1), the
log-sum-exp merge of the split key walk; each row block seeding its own
rows) is emulated in plain torch by the split emulations of
tests/test_torch_decode_split.py and tests/test_torch_prefill_tiles.py
with more than one split, and held to the same outputs; seeding every
split instead (the sink counted ``splits`` times) is shown to miss them.
Stated tolerance 1e-5 on the outputs (summation order). Sinks outside the
slice (INT8 and e4m3 pools, head_dim 256) raise NotImplementedError
naming the form.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_decode_split as dsplit
import test_torch_prefill_tiles as tiles
from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.ops import ref_ops as jref
from simplellminference_tpu.ops.attention import dispatch as jdispatch
from simplellminference_tpu.ops.attention.flash_decode import (
    flash_decode as jflash_decode)
from simplellminference_tpu.ops.attention.flash_prefill import (
    flash_prefill as jflash_prefill)
from simplellminference_tpu.ops.attention.paged_decode import (
    paged_flash_decode as jpaged_decode)
from simplellminference_tpu.ops.attention.paged_decode import (
    paged_flash_verify as jpaged_verify)
from simplellminference_tpu.ops.attention.paged_prefill import (
    paged_flash_prefill as jpaged_prefill)
from simplellminference_tpu_torch.core.config import ModelConfig
from simplellminference_tpu_torch.ops import paged_append as tpa
from simplellminference_tpu_torch.ops import ref_ops as tref
from simplellminference_tpu_torch.ops.attention import dispatch
from simplellminference_tpu_torch.ops.attention import flash_decode as tfd
from simplellminference_tpu_torch.ops.attention import flash_prefill as tfp
from simplellminference_tpu_torch.ops.attention import paged_decode as tpd
from simplellminference_tpu_torch.ops.attention import paged_prefill as tpp

TOL = 1e-5
HEAD_DIMS = (32, 64)
N, KVN, PS = 8, 2, 8     # a GQA group of 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread: the tiny models' ops are far
    below where threads pay off, and under the suite's parallel workers
    (each with an OpenMP thread per core) the threads spin against each
    other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def j(a):
    return None if a is None else jnp.asarray(a)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


BIG_SINK = 8.0   # above every score of unit inputs at D**-0.5 (about 5)


def _sinks(rng, big=False):
    """Sinks drawn N(0, 1), or BIG_SINK: above every score of their rows,
    so that a sink counted twice or in the wrong units moves the outputs
    far (the outputs keep a few hundredths of their size)."""
    return np.full(N, BIG_SINK, np.float32) if big else rand(rng, N)


def test_reference_attention_sinks_match_jax():
    """ref_ops.attention(sinks=) against JAX's, with the soft cap and a
    mask that leaves one row no key (its output is zero)."""
    rng = np.random.default_rng(0)
    q, k, v = rand(rng, 2, 6, N, 32), rand(rng, 2, 9, KVN, 32), rand(
        rng, 2, 9, KVN, 32)
    sinks = _sinks(rng)
    mask = np.tril(np.ones((6, 9), bool), 3)[None, None].repeat(2, 0)
    mask[1, :, 0] = False
    for cap in (None, 2.0):
        got = tref.attention(t(q), t(k), t(v), t(mask), logit_cap=cap,
                             sinks=t(sinks))
        want = jref.attention(j(q), j(k), j(v), j(mask), logit_cap=cap,
                              sinks=j(sinks))
        close(got, want)
    assert not got[1, 0].any()
    # the sink takes weight: the outputs move
    assert not torch.allclose(got, tref.attention(t(q), t(k), t(v), t(mask),
                                                  logit_cap=2.0), atol=1e-2)


@pytest.mark.parametrize("window", [None, 5], ids=["3s", "3ws"])
@pytest.mark.parametrize("d,big", [(32, False), (64, False), (64, True)],
                         ids=["d32", "d64", "d64-above"])
def test_flash_prefill_sinks_match_jax(d, window, big):
    rng = np.random.default_rng(d + (window or 0) + big)
    s = 20
    q, k, v = rand(rng, 2, s, N, d), rand(rng, 2, s, KVN, d), rand(
        rng, 2, s, KVN, d)
    sinks = _sinks(rng, big)
    got = tfp.flash_prefill(t(q), t(k), t(v), window=window, sinks=t(sinks))
    want = jflash_prefill(j(q), j(k), j(v), causal=True, interpret=True,
                          window=window, sinks=j(sinks))
    close(got, want)
    # through the dispatcher, with GPT-OSS's options
    kw = dict(attn_sinks=True, sliding_window=window)
    via = dispatch.attention(ModelConfig.tiny_test(**kw), t(q), t(k), t(v),
                             sinks=t(sinks))
    close(via, want)


def _paged(rng, d, b, mp):
    p = b * mp + 1
    pk, pv = rand(rng, 2, p, KVN, PS, d), rand(rng, 2, p, KVN, PS, d)
    tables = rng.permutation(p - 1)[:b * mp].astype(np.int32).reshape(b, mp)
    return pk, pv, tables


@pytest.mark.parametrize("window", [None, 1, 6], ids=["4s", "4ws1", "4ws6"])
@pytest.mark.parametrize("d,big", [(32, False), (64, False), (64, True)],
                         ids=["d32", "d64", "d64-above"])
def test_paged_decode_sinks_match_jax(d, window, big):
    # kv_len 0 (a zero row), 1, a band starting inside a page, a full table
    rng = np.random.default_rng(10 * d + (window or 0) + big)
    b, mp = 4, 6
    pk, pv, tables = _paged(rng, d, b, mp)
    lens = np.asarray([0, 1, 19, 48], np.int32)
    q = rand(rng, b, N, d)
    sinks = _sinks(rng, big)
    got = tpd.paged_flash_decode(t(q), t(pk), t(pv), t(tables), t(lens), 1,
                                 window=window, sinks=t(sinks))
    want = jpaged_decode(j(q), j(pk), j(pv), j(tables), j(lens),
                         interpret=True, layer=jnp.int32(1), window=window,
                         sinks=j(sinks))
    close(got, want)
    assert not got[0].any()
    # through the dispatcher against JAX's (its CPU route, the dense
    # reference): the kv_len-0 row is zero there too with a sink
    kw = dict(attn_sinks=True, sliding_window=window)
    via = dispatch.attention_paged(ModelConfig.tiny_test(**kw), t(q)[:, None],
                                   t(pk), t(pv), t(tables), t(lens), 1,
                                   sinks=t(sinks))
    jvia = jdispatch.attention_paged(
        JaxModelConfig.tiny_test(**kw), j(q)[:, None], j(pk), j(pv),
        j(tables), j(lens), layer=jnp.int32(1), sinks=j(sinks))
    close(via, jvia)


def test_paged_decode_window_sinks_read_no_page_below_the_band():
    """4ws over ring tables (column c of slot s -> ring page s*R + c % R)
    whose columns below each row's band point at NaN pages: finite, equal
    to the clean tables' outputs and to JAX's kernel on them."""
    rng = np.random.default_rng(4)
    b, r, mp, d, window = 2, 3, 12, 64, 10
    p = b * r + 5
    pk, pv = rand(rng, 2, p, KVN, PS, d), rand(rng, 2, p, KVN, PS, d)
    pk[:, b * r:b * r + 4] = np.nan
    pv[:, b * r:b * r + 4] = np.nan
    ring = (np.arange(b)[:, None] * r + np.arange(mp)[None] % r).astype(
        np.int32)
    lens = np.asarray([29, 41], np.int32)
    dirty = ring.copy()
    for i in range(b):
        below = (np.arange(mp) + 1) * PS <= lens[i] - window
        dirty[i, below] = b * r + np.arange(below.sum()) % 4
    q, sinks = rand(rng, b, N, d), _sinks(rng)
    clean = tpd.paged_flash_decode(t(q), t(pk), t(pv), t(ring), t(lens), 1,
                                   window=window, sinks=t(sinks))
    got = tpd.paged_flash_decode(t(q), t(pk), t(pv), t(dirty), t(lens), 1,
                                 window=window, sinks=t(sinks))
    assert bool(torch.isfinite(got).all())
    close(got, clean, tol=0)
    want = jpaged_decode(j(q), j(pk), j(pv), j(ring), j(lens),
                         interpret=True, layer=jnp.int32(1), window=window,
                         sinks=j(sinks))
    close(got, want)


# verify rows: gpt-oss-20b's GQA group of 8 over a 5-row window (40 rows,
# two of the kernel's row blocks)
VN, VS = 16, 5


@pytest.mark.parametrize("window", [None, 6], ids=["4vs", "4vws"])
@pytest.mark.parametrize("d,big", [(32, False), (64, False), (64, True)],
                         ids=["d32", "d64", "d64-above"])
def test_paged_verify_sinks_match_jax(d, window, big):
    # kv_len 0 (no row has a key), 2 (the oldest rows before position 0),
    # a band starting inside a page, a full table
    rng = np.random.default_rng(20 * d + (window or 0) + big)
    b, mp = 4, 6
    pk, pv, tables = _paged(rng, d, b, mp)
    lens = np.asarray([0, 2, 19, 48], np.int32)
    q = rand(rng, b, VS, VN, d)
    sinks = (np.full(VN, BIG_SINK, np.float32) if big
             else rand(rng, VN))
    assert (VN // KVN) * VS > tpd.ROW_BLOCK
    got = tpd.paged_flash_verify(t(q), t(pk), t(pv), t(tables), t(lens), 1,
                                 window=window, sinks=t(sinks))
    want = np.asarray(jpaged_verify(j(q), j(pk), j(pv), j(tables), j(lens),
                                    interpret=True, layer=jnp.int32(1),
                                    window=window, sinks=j(sinks)))
    # rows with keys (row s of sequence i sits at lens[i] - S + s): a row
    # with none is zero in the port by design
    for i, ln in enumerate(lens):
        live = [s for s in range(VS) if ln - VS + s >= 0]
        close(got[i, live], want[i, live])
        assert not got[i, [s for s in range(VS) if s not in live]].any()
    # a row's sink is its head's whatever its window row: the sinks moved
    # by head show in every row of that head
    shifted = sinks + 0.5 + np.arange(VN, dtype=np.float32) * 0.5
    moved = tpd.paged_flash_verify(t(q), t(pk), t(pv), t(tables), t(lens),
                                   1, window=window, sinks=t(shifted))
    assert float((moved[3] - got[3]).abs().amax((0, 2)).min()) > 1e-4
    # through the dispatcher (S > 1: the verify form)
    kw = dict(attn_sinks=True, sliding_window=window)
    via = dispatch.attention_paged(ModelConfig.tiny_test(**kw), t(q), t(pk),
                                   t(pv), t(tables), t(lens), 1,
                                   sinks=t(sinks))
    close(via, got, tol=0)


@pytest.mark.parametrize("window", [None, 6, 100],
                         ids=["13s", "13ws6", "13ws100"])
@pytest.mark.parametrize("d,big", [(32, False), (64, False), (64, True)],
                         ids=["d32", "d64", "d64-above"])
def test_flash_decode_sinks_match_jax(d, window, big):
    # kv_len 0 (a zero row), below the window, on its edge, past it, the
    # whole arena of a stacked two-layer arena with a spare row
    rng = np.random.default_rng(40 * d + (window or 0) + big)
    smax = 128
    lens = np.asarray([0, 3, 6, 7, 77, smax], np.int32)
    b = len(lens)
    ck = rand(rng, 2, b + 1, KVN, smax, d)
    cv = rand(rng, 2, b + 1, KVN, smax, d)
    q, sinks = rand(rng, b, N, d), _sinks(rng, big)
    got = tfd.flash_decode(t(q), t(ck), t(cv), t(lens), layer=1,
                           window=window, sinks=t(sinks))
    want = jflash_decode(j(q), j(ck[:, :b]), j(cv[:, :b]), j(lens),
                         interpret=True, layer=jnp.int32(1), window=window,
                         sinks=j(sinks))
    close(got, want)
    assert not got[0].any()
    # through the dispatcher, with GPT-OSS's options
    kw = dict(attn_sinks=True, sliding_window=window)
    via = dispatch.attention_cached(ModelConfig.tiny_test(**kw),
                                    t(q)[:, None], t(ck), t(cv), t(lens), 1,
                                    sinks=t(sinks))
    close(via[:, 0], got, tol=0)


def test_verify_row_blocks_seed_each_row_with_its_head():
    """The kernel's row-block arithmetic (csrc/paged_decode.cu: block y of
    kv head g holds rows row0 = (y % nrb) * 32 .. of group x S; row rr
    reads q row rr / group, head g * group + rr % group; split 0 seeds it
    with sinks[g * group + rr - rr / group * group]; it writes output row
    (b * S + rr / group) * N + that head): at gpt-oss-20b's 64 heads over
    8 kv heads, S 5 (two row blocks a kv head), and at the tiny shapes,
    every (window row, head) is seeded once, with its own head's sink."""
    for n, kvn, s in ((64, 8, 5), (VN, KVN, VS), (8, 2, 8), (64, 8, 1)):
        group = n // kvn
        nrb = tpd.row_blocks(group * s)
        seen = []
        for y in range(kvn * nrb):
            g, row0 = y // nrb, (y % nrb) * tpd.ROW_BLOCK
            for r in range(min(tpd.ROW_BLOCK, group * s - row0)):
                rr = row0 + r
                w = rr // group
                head = g * group + rr - w * group
                sink = g * group + rr - rr // group * group
                assert sink == head
                seen.append((w, head))
        assert sorted(seen) == [(w, h) for w in range(s) for h in range(n)]
    assert tpd.row_blocks(8 * 5) == 2


@pytest.mark.parametrize("splits", [2, 3])
@pytest.mark.parametrize("form", ["4vs", "4vws", "13s", "13ws"])
def test_verify_and_dense_split_merge_count_the_sink_once(form, splits):
    """Kernel 4's arithmetic with sinks on verify rows (S 5) and on the
    dense arena (the same body, one page of Smax slots a sequence) against
    the plain versions and the JAX kernels; seeding every split misses
    them once a row's walk splits."""
    window = 6 if "w" in form else 0
    dense = form.startswith("13")
    b, mp = len(dsplit.LENS), 11
    rng, pk, pv, _ks, _vs, tables, lens = dsplit._case(
        500 + window + splits + dense, b, mp, dsplit.LENS, False)
    s = 1 if dense else 5
    q = rng.standard_normal((b, s, dsplit.N, dsplit.D)).astype(np.float32)
    sinks = np.full(dsplit.N, BIG_SINK, np.float32)
    if dense:
        # the arena [L, B + 1, kvN, Smax, D]: row b is sequence b
        smax = 128
        pk = rng.standard_normal((2, b + 1, dsplit.KVN, smax, dsplit.D)
                                 ).astype(np.float32)
        pv = rng.standard_normal(pk.shape).astype(np.float32)
    kw = dict(window=window, sinks=t(sinks), dense=dense)
    got = dsplit.split_merge(t(q), t(pk), t(pv), t(tables), t(lens), 1,
                             splits, **kw)
    if dense:
        got = got[:, 0]
        plain = tfd.flash_decode_ref(t(q[:, 0]), t(pk), t(pv), t(lens), 1,
                                     window=window or None, sinks=t(sinks))
        want = jflash_decode(j(q[:, 0]), j(pk[:, :b]), j(pv[:, :b]),
                             j(lens), interpret=True, layer=jnp.int32(1),
                             window=window or None, sinks=j(sinks))
    else:
        plain = tpd.paged_flash_verify_ref(t(q), t(pk), t(pv), t(tables),
                                           t(lens), 1, window=window or None,
                                           sinks=t(sinks))
        want = jpaged_verify(j(q), j(pk), j(pv), j(tables), j(lens),
                             interpret=True, layer=jnp.int32(1),
                             window=window or None, sinks=j(sinks))
    close(got, plain)
    # rows with keys: a verify row with none is zero in the port by design
    live = torch.from_numpy(np.asarray(lens))[:, None] - s + torch.arange(
        s)[None] >= 0
    got_l = got.reshape(b, s, -1)[live]
    close(got_l, np.asarray(want).reshape(b, s, -1)[live.numpy()])
    twice = dsplit.split_merge(t(q), t(pk), t(pv), t(tables), t(lens), 1,
                               splits, seed_every_split=True, **kw)
    twice = twice[:, 0] if dense else twice
    assert float((twice - plain).abs().max()) > 1e-3


@pytest.mark.parametrize("window", [None, 7], ids=["8s", "8ws"])
@pytest.mark.parametrize("d,big", [(32, False), (64, False), (64, True)],
                         ids=["d32", "d64", "d64-above"])
def test_paged_prefill_sinks_match_jax(d, window, big):
    rng = np.random.default_rng(20 * d + (window or 0) + big)
    b, s, mp = 3, 16, 6
    pk, pv, tables = _paged(rng, d, b, mp)
    tables[2] = -1                          # a padding row: no key at all
    offs = np.asarray([8, 24, 0], np.int32)
    lens = np.asarray([8 + 16, 24 + 11, 0], np.int32)
    q = rand(rng, b, s, N, d)
    sinks = _sinks(rng, big)
    got = tpp.paged_flash_prefill(t(q), t(pk), t(pv), t(tables), t(lens),
                                  t(offs), 1, window=window, sinks=t(sinks))
    want = jpaged_prefill(j(q), j(pk), j(pv), j(tables), j(lens), j(offs),
                          bq=16, interpret=True, layer=jnp.int32(1),
                          window=window, sinks=j(sinks))
    for i in range(2):
        live = int(lens[i] - offs[i])
        close(got[i, :live], np.asarray(want)[i, :live])
    assert not got[2].any()
    kw = dict(attn_sinks=True, sliding_window=window)
    via = dispatch.attention_paged_prefill(
        ModelConfig.tiny_test(**kw), t(q), t(pk), t(pv), t(tables), t(lens),
        t(offs), 1, sinks=t(sinks))
    close(via, got, tol=0)


@pytest.mark.parametrize("splits", [1, 2, 3, 32])
@pytest.mark.parametrize("window", [0, 6, 70])
def test_decode_split_merge_counts_the_sink_once(window, splits):
    """Kernel 4's arithmetic with sinks (split 0 seeds each row; the f32
    partials merged by log-sum-exp) against the plain version and the JAX
    kernel, at kv_lens 0, 1, tile edges and the table's end; a sink seeded
    in every split instead misses them once the walk splits."""
    b, mp = len(dsplit.LENS), 11
    rng, pk, pv, _ks, _vs, tables, lens = dsplit._case(
        300 + window + splits, b, mp, dsplit.LENS, False)
    q = rng.standard_normal((b, 1, dsplit.N, dsplit.D)).astype(np.float32)
    scores = np.einsum("bnd,lpkcd->bnlpkc", q[:, 0], pk) * dsplit.D ** -0.5
    assert np.abs(scores).max() < BIG_SINK
    for sinks in (rng.standard_normal(dsplit.N).astype(np.float32),
                  np.full(dsplit.N, BIG_SINK, np.float32)):
        got = dsplit.split_merge(t(q), t(pk), t(pv), t(tables), t(lens), 1,
                                 splits, window=window, sinks=t(sinks))[:, 0]
        plain = tpd.paged_flash_decode_ref(t(q[:, 0]), t(pk), t(pv),
                                           t(tables), t(lens), 1,
                                           window=window or None,
                                           sinks=t(sinks))
        want = jpaged_decode(j(q[:, 0]), j(pk), j(pv), j(tables), j(lens),
                             interpret=True, layer=jnp.int32(1),
                             window=window or None, sinks=j(sinks))
        close(got, plain)
        close(got, want)
        assert not got[0].any()
        # several splits walk a row: seeding each counts the sink `splits`
        # times (rows of 64+ keys, split from 2 on)
        twice = dsplit.split_merge(t(q), t(pk), t(pv), t(tables), t(lens),
                                   1, splits, window=window, sinks=t(sinks),
                                   seed_every_split=True)[:, 0]
        live = tpd.split_keys(int(lens[-1]), 1, window, mp * PS, splits)
        if sum(hi > lo for lo, hi in live) > 1:
            assert float((twice - plain).abs().max()) > 1e-3


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("window", [None, 6])
def test_prefill_emulation_counts_the_sink_once(window, splits):
    """Kernels 3 and 8's tiled arithmetic with sinks (split 0 of each tile
    seeds its rows in log2 units; P in f32) against the plain versions and
    the JAX kernels."""
    rng = np.random.default_rng(5 + splits + (window or 0))
    b, s, d = 2, 64, 32
    q, k, v = rand(rng, b, s, N, d), rand(rng, b, s, KVN, d), rand(
        rng, b, s, KVN, d)
    sinks = _sinks(rng)
    got = tiles.emulate(t(q), *tiles.dense_keys(t(k), t(v)), [0] * b,
                        [s] * b, window or 0, splits, "f32", sinks=t(sinks))
    close(got, tfp.flash_prefill_ref(t(q), t(k), t(v), window=window,
                                     sinks=t(sinks)))
    close(got, jflash_prefill(j(q), j(k), j(v), causal=True, bq=32, bk=32,
                              interpret=True, window=window,
                              sinks=j(sinks)))
    # the paged form at offsets 8 and 24 through shuffled pages
    mp = 12
    pk, pv, tables = _paged(rng, d, b, mp)
    offs = np.asarray([8, 24], np.int32)
    lens = offs + np.asarray([16, 11], np.int32)
    qp = rand(rng, b, 16, N, d)
    kall, vall, readable = tiles.paged_keys(t(pk), t(pv), t(tables), 1)
    got = tiles.emulate(t(qp), kall, vall, readable, offs, lens, window or 0,
                        splits, "f32", sinks=t(sinks))
    plain = tpp.paged_flash_prefill_ref(t(qp), t(pk), t(pv), t(tables),
                                        t(lens), t(offs), 1, window=window,
                                        sinks=t(sinks))
    want = jpaged_prefill(j(qp), j(pk), j(pv), j(tables), j(lens), j(offs),
                          bq=16, interpret=True, layer=jnp.int32(1),
                          window=window, sinks=j(sinks))
    for i in range(b):
        live = int(lens[i] - offs[i])
        close(got[i, :live], plain[i, :live])
        close(got[i, :live], np.asarray(want)[i, :live])


def test_sink_forms_count_their_launches_apart():
    # on the CPU nothing launches: sinks are a count of their own only on
    # the card, and the wrappers' CPU path leaves every count alone
    before = dict(tfp.SINK_LAUNCHES)
    rng = np.random.default_rng(3)
    q, k = rand(rng, 1, 8, N, 32), rand(rng, 1, 8, KVN, 32)
    tfp.flash_prefill(t(q), t(k), t(k), sinks=torch.zeros(N))
    assert tfp.SINK_LAUNCHES == before
    assert tfp.sink_values(None, N, "cpu") is None
    sinks = torch.zeros(N)
    assert tfp.sink_values(sinks, N, "cpu") is sinks
    with pytest.raises(ValueError, match="one logit per q head"):
        tfp.sink_values(torch.zeros(N + 1), N, "cpu")
    # the params hold the sinks in f32; the kernels take no other form
    with pytest.raises(ValueError, match="f32 contiguous"):
        tfp.sink_values(torch.zeros(N, dtype=torch.bfloat16), N, "cpu")
    with pytest.raises(ValueError, match="f32 contiguous"):
        tfp.sink_values(torch.zeros(2 * N)[::2], N, "cpu")


def test_sinks_outside_the_slice_raise():
    """Sinks at head_dim 256 (over float and INT8 pools) raise
    NotImplementedError naming the form, on the CPU as on the card; over
    INT8 pools (4qs, 4vqs, 8qs) and e4m3 pools (4es, 4ves, 8es: held to
    JAX in tests/test_torch_fp8kv_sinks_window.py), on verify rows (4vs)
    and on the dense arena (13s) they run."""
    rng = np.random.default_rng(1)
    d = 32
    shape = (2, 7, KVN, PS, d)
    pk, pv = t(rand(rng, *shape)), t(rand(rng, *shape))
    qk, ks = tpa.quantize_kv(pk)
    qv, vs = tpa.quantize_kv(pv)
    ek, ev = pk.to(torch.float8_e4m3fn), pv.to(torch.float8_e4m3fn)
    tables = t(np.asarray([[0, 1], [2, 3], [4, 5]], np.int32))
    kv, offs = t(np.asarray([5, 9, 2], np.int32)), torch.zeros(
        3, dtype=torch.int32)
    q1, q3 = t(rand(rng, 3, N, d)), t(rand(rng, 3, 3, N, d))
    arena = t(rand(rng, 2, 3, KVN, 16, d))
    sk = dict(sinks=torch.zeros(N))
    # sinks over INT8 pools run: decode, verify and prefill rows
    for fn, want in (
            (lambda: tpd.paged_flash_decode(q1, qk, qv, tables, kv, 0,
                                            k_scale=ks, v_scale=vs, **sk),
             q1.shape),
            (lambda: tpd.paged_flash_verify(q3, qk, qv, tables, kv, 0,
                                            k_scale=ks, v_scale=vs, **sk),
             q3.shape),
            (lambda: tpp.paged_flash_prefill(q3, qk, qv, tables, kv, offs, 0,
                                             k_scale=ks, v_scale=vs, **sk),
             q3.shape),
            # and over e4m3 pools
            (lambda: tpd.paged_flash_decode(q1, ek, ev, tables, kv, 0, **sk),
             q1.shape),
            (lambda: tpd.paged_flash_verify(q3, ek, ev, tables, kv, 0, **sk),
             q3.shape),
            (lambda: tpp.paged_flash_prefill(q3, ek, ev, tables, kv, offs, 0,
                                             **sk), q3.shape)):
        out = fn()
        assert out.shape == want and bool(torch.isfinite(out).all())
    # verify rows and the dense arena run, with and without a window
    for w in (None, 4):
        assert tpd.paged_flash_verify(q3, pk, pv, tables, kv, 0, window=w,
                                      **sk).shape == q3.shape
        assert tfd.flash_decode(q1, arena, arena, kv, layer=0, window=w,
                                **sk).shape == q1.shape
    # no model with sinks has head_dim 256: the sink forms take 32-128,
    # over float pools and INT8 ones
    q256, p256 = t(rand(rng, 3, N, 256)), t(rand(rng, 2, 7, KVN, PS, 256))
    a256 = t(rand(rng, 2, 3, KVN, 16, 256))
    c256, s256 = tpa.quantize_kv(p256)
    for fn in (lambda: tpd.paged_flash_decode(q256, c256, c256, tables, kv,
                                              0, k_scale=s256, v_scale=s256,
                                              **sk),
               lambda: tpd.paged_flash_verify(q256[:, None], c256, c256,
                                              tables, kv, 0, k_scale=s256,
                                              v_scale=s256, **sk),
               lambda: tpp.paged_flash_prefill(q256[:, None], c256, c256,
                                               tables, kv, offs, 0,
                                               k_scale=s256, v_scale=s256,
                                               **sk),
               lambda: tpd.paged_flash_decode(q256, p256, p256, tables, kv,
                                              0, **sk),lambda: tpd.paged_flash_decode(q256, p256, p256, tables, kv,
                                              0, **sk),
               lambda: tpd.paged_flash_verify(q256[:, None], p256, p256,
                                              tables, kv, 0, **sk),
               lambda: tpd.paged_flash_verify(q256[:, None], p256, p256,
                                              tables, kv, 0, window=4,
                                              **sk),
               lambda: tfd.flash_decode(q256, a256, a256, kv, layer=0,
                                        **sk),
               lambda: tfd.flash_decode(q256, a256, a256, kv, layer=0,
                                        window=4, **sk),
               lambda: tpp.paged_flash_prefill(q256[:, None], p256, p256,
                                               tables, kv, offs, 0, **sk),
               lambda: tfp.flash_prefill(q256[:, None], p256[0, :3, :, :1],
                                         p256[0, :3, :, :1], window=4,
                                         **sk)):
        with pytest.raises(NotImplementedError, match="head_dim 256"):
            fn()
