"""GPT-OSS's attention sinks and Gemma-2's soft cap over INT8 KV pools in
the port's kernels (forms 4qs, 4qws, 4vqs, 4vqws, 8qs, 8qws and 4qc, 4qwc,
4vqc, 4vqwc, 8qc, 8qwc) against the JAX package on the CPU.

The port's wrappers run their plain versions on CPU tensors (gather, f32
dequantization, reference attention: the sink a raw logit in the softmax,
the cap on the dequantized score); the JAX kernels run in interpret mode,
as the JAX package's own tests run them, on the same numpy inputs
(float32, seeded), at head dims 32, 64 and 128: int8 codes over the whole
range and scales of 0.01-0.1, far from 1, so a cap applied before the K
scale, or a sink put under a scale, moves the outputs far; scores several
times past the cap; sinks N(0, 1) and sinks above every score of their
rows; kv_len 0 rows; verify rows at a GQA group of 8 x 5 rows (two of the
kernel's row blocks); window forms over ring tables whose columns below
the band point at pages with NaN scales, which no form may read. Stated
tolerance on the outputs (summation order, the dequantization's
place): 1e-5 of the outputs' largest magnitude, which the dequantized V
rows take to about 10. And the tiny GPT-OSS of tests/test_torch_gpt_oss.py
over INT8 KV through ``forward_paged`` (chunked prefill and decode over
the grouped engine's INT8 ring pools): logits within 1e-4 while both
caches hold the same codes, within 1e-3 once a code is one apart (the rule
of tests/test_torch_int8kv_engine.py), greedy tokens equal. The Engines
over INT8 KV: tests/test_torch_int8kv_models.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.ops.attention.paged_decode import (
    paged_flash_decode as jpaged_decode)
from simplellminference_tpu.ops.attention.paged_decode import (
    paged_flash_verify as jpaged_verify)
from simplellminference_tpu.ops.attention.paged_prefill import (
    paged_flash_prefill as jpaged_prefill)
from simplellminference_tpu_torch.ops.attention import flash_prefill as tfp
from simplellminference_tpu_torch.ops.attention import paged_decode as tpd
from simplellminference_tpu_torch.ops.attention import paged_prefill as tpp

TOL = 1e-5
N, KVN, PS = 8, 2, 8          # a GQA group of 4
VN = 16                       # verify rows: a group of 8 x VS rows
VS = 5
CAP = 2.0                     # scores of the draws below pass it several
                              # times over (checked)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread: the tiny ops are far below
    where threads pay off, and under the suite's parallel workers the
    threads spin against each other."""
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
    """Within ``tol`` of the outputs' largest magnitude (the dequantized V
    rows reach 12.7 here, so f32 rounding scales with them)."""
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * max(1.0, top))


def quant_pools(rng, pages, d, kvn=KVN, ps=PS):
    """Two layers of int8 pools (codes over the whole range) and their
    scale pools (0.01-0.1: far from 1)."""
    shape = (2, pages, kvn, ps, d)
    return (rng.integers(-127, 128, shape).astype(np.int8),
            rng.integers(-127, 128, shape).astype(np.int8),
            rng.uniform(0.01, 0.1, shape[:-1]).astype(np.float32),
            rng.uniform(0.01, 0.1, shape[:-1]).astype(np.float32))


def top_score(q, pk, ks, tables, d):
    """The largest |score| of any q row against any dequantized key of
    layer 1's pages in ``tables`` (at least every score a row meets)."""
    pages = np.unique(tables[tables >= 0])
    k = (pk[1][pages].astype(np.float32) * ks[1][pages][..., None]
         ).reshape(-1, d)
    return float(np.abs(q.reshape(-1, d) @ k.T).max()) * d ** -0.5


def options(rng, kind, n, bound):
    """(logit_cap, sinks) of a case: sinks N(0, 1), sinks just above every
    score (``bound``), the cap, or the cap with sinks."""
    sinks = {"sinks": rand(rng, n), "sinks-above": np.full(n, bound + 0.5,
                                                           np.float32),
             "cap": None, "cap-sinks": rand(rng, n)}[kind]
    return (CAP if kind.startswith("cap") else None), sinks


def ring_case(rng, b, r, mp, d, k_lo):
    """Ring pools (b slots x r pages, 4 pages whose scales are NaN, the
    trash page), the ring tables (column c of slot s -> s*r + c % r) and
    the same tables with every column that ends at or below row i's band
    start k_lo[i] on a NaN page."""
    pk, pv, ks, vs = quant_pools(rng, b * r + 5, d)
    for sc in (ks, vs):
        sc[:, b * r:b * r + 4] = np.nan
    ring = (np.arange(b)[:, None] * r + np.arange(mp)[None] % r).astype(
        np.int32)
    dirty = ring.copy()
    for i, lo in enumerate(k_lo):
        below = (np.arange(mp) + 1) * PS <= lo
        dirty[i, below] = b * r + np.arange(below.sum()) % 4
    return pk, pv, ks, vs, ring, dirty


KINDS = ["sinks", "sinks-above", "cap", "cap-sinks"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", [32, 64, 128])
def test_paged_decode_int8kv_sinks_cap_match_jax(d, kind):
    """4qs, 4qc: kv_len 0 (a zero row), 1, a page edge, a full table."""
    rng = np.random.default_rng(d + KINDS.index(kind))
    b, mp = 4, 6
    pk, pv, ks, vs = quant_pools(rng, b * mp + 1, d)
    tables = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    lens = np.asarray([0, 1, 16, 48], np.int32)
    q = rand(rng, b, N, d)
    bound = top_score(q, pk, ks, tables, d)
    cap, sinks = options(rng, kind, N, bound)
    got = tpd.paged_flash_decode(t(q), t(pk), t(pv), t(tables), t(lens), 1,
                                 k_scale=t(ks), v_scale=t(vs), logit_cap=cap,
                                 sinks=None if sinks is None else t(sinks))
    want = jpaged_decode(j(q), j(pk), j(pv), j(tables), j(lens),
                         interpret=True, layer=jnp.int32(1), k_scale=j(ks),
                         v_scale=j(vs), logit_cap=cap, sinks=j(sinks))
    close(got, want)
    assert not got[0].any()
    # the scores pass the cap; past it, capping before the K scale would
    # be another function
    if cap:
        assert bound > 3 * cap
        early = tpd.paged_flash_decode_ref(
            t(q), t(pk).float(), t(pv).float(), t(tables), t(lens), 1,
            logit_cap=cap, sinks=None if sinks is None else t(sinks))
        assert float((early - got).abs().max()) > 1e-2


@pytest.mark.parametrize("kind", ["sinks-above", "cap-sinks"])
@pytest.mark.parametrize("window", [1, 6], ids=["w1", "w6"])
def test_paged_decode_int8kv_window_sinks_cap_read_no_page_below_the_band(
        window, kind):
    """4qws, 4qwc over ring tables: finite, equal to the clean tables'
    outputs and to JAX's kernel on them."""
    rng = np.random.default_rng(10 + window + KINDS.index(kind))
    b, r, mp, d = 3, 3, 12, 64
    lens = np.asarray([0, 29, 41], np.int32)
    pk, pv, ks, vs, ring, dirty = ring_case(rng, b, r, mp, d, lens - window)
    q = rand(rng, b, N, d)
    cap, sinks = options(rng, kind, N, top_score(q, pk[:, :-5], ks[:, :-5],
                                                 ring, d))
    kw = dict(k_scale=t(ks), v_scale=t(vs), window=window, logit_cap=cap,
              sinks=None if sinks is None else t(sinks))
    clean = tpd.paged_flash_decode(t(q), t(pk), t(pv), t(ring), t(lens), 1,
                                   **kw)
    got = tpd.paged_flash_decode(t(q), t(pk), t(pv), t(dirty), t(lens), 1,
                                 **kw)
    assert bool(torch.isfinite(got).all())
    close(got, clean, tol=0)
    want = jpaged_decode(j(q), j(pk), j(pv), j(ring), j(lens),
                         interpret=True, layer=jnp.int32(1), k_scale=j(ks),
                         v_scale=j(vs), window=window, logit_cap=cap,
                         sinks=j(sinks))
    close(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("window", [None, 6], ids=["4vq", "4vqw"])
@pytest.mark.parametrize("d", [64])
def test_paged_verify_int8kv_sinks_cap_match_jax(d, window, kind):
    """4vqs, 4vqws, 4vqc, 4vqwc at a GQA group of 8 over 5 rows (40 rows:
    two row blocks): kv_len 0, 2 (the oldest rows before position 0), a
    band inside a page, a full table. A row with no key is zero in the
    port by design; the rows with keys are held to JAX's."""
    rng = np.random.default_rng(20 + d + (window or 0) + KINDS.index(kind))
    b, mp = 4, 6
    pk, pv, ks, vs = quant_pools(rng, b * mp + 1, d)
    tables = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    lens = np.asarray([0, 2, 19, 48], np.int32)
    q = rand(rng, b, VS, VN, d)
    assert tpd.row_blocks((VN // KVN) * VS) == 2
    cap, sinks = options(rng, kind, VN, top_score(q, pk, ks, tables, d))
    got = tpd.paged_flash_verify(t(q), t(pk), t(pv), t(tables), t(lens), 1,
                                 k_scale=t(ks), v_scale=t(vs), window=window,
                                 logit_cap=cap,
                                 sinks=None if sinks is None else t(sinks))
    want = np.asarray(jpaged_verify(
        j(q), j(pk), j(pv), j(tables), j(lens), interpret=True,
        layer=jnp.int32(1), k_scale=j(ks), v_scale=j(vs), window=window,
        logit_cap=cap, sinks=j(sinks)))
    for i, ln in enumerate(lens):
        live = [s for s in range(VS) if ln - VS + s >= 0]
        close(got[i, live], want[i, live])
        assert not got[i, [s for s in range(VS) if s not in live]].any()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("window", [None, 5], ids=["8q", "8qw"])
@pytest.mark.parametrize("d", [64])
def test_paged_prefill_int8kv_sinks_cap_match_jax(d, window, kind):
    """8qs, 8qws, 8qc, 8qwc: two 16-row chunks at offsets 0 and 16 (the
    second row ragged), against JAX's kernel row by valid row."""
    rng = np.random.default_rng(40 + d + (window or 0) + KINDS.index(kind))
    b, s, mp = 2, 16, 6
    pk, pv, ks, vs = quant_pools(rng, b * mp + 1, d)
    tables = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    offs = np.asarray([0, 16], np.int32)
    kv = np.asarray([16, 27], np.int32)
    q = rand(rng, b, s, N, d)
    cap, sinks = options(rng, kind, N, top_score(q, pk, ks, tables, d))
    got = tpp.paged_flash_prefill(t(q), t(pk), t(pv), t(tables), t(kv),
                                  t(offs), 1, window=window, logit_cap=cap,
                                  sinks=None if sinks is None else t(sinks),
                                  k_scale=t(ks), v_scale=t(vs))
    want = np.asarray(jpaged_prefill(
        j(q), j(pk), j(pv), j(tables), j(kv), j(offs), bq=s, interpret=True,
        layer=jnp.int32(1), k_scale=j(ks), v_scale=j(vs), window=window,
        logit_cap=cap, sinks=j(sinks)))
    for i in range(b):
        valid = int(kv[i] - offs[i])
        close(got[i, :valid], want[i, :valid])


@pytest.mark.parametrize("kind", ["sinks-above", "cap"])
def test_paged_prefill_int8kv_window_reads_no_page_below_the_band(kind):
    """8qws, 8qwc over ring tables whose columns below the chunk's band
    sit on pages with NaN scales: finite and equal to the clean tables."""
    rng = np.random.default_rng(60 + KINDS.index(kind))
    b, r, mp, d, s, window = 2, 4, 8, 32, 8, 5
    offs = np.asarray([24, 40], np.int32)
    kv = offs + s
    # the chunk's oldest row attends keys from off - window + 1 on
    pk, pv, ks, vs, ring, dirty = ring_case(rng, b, r, mp, d,
                                            offs - window + 1)
    q = rand(rng, b, s, N, d)
    cap, sinks = options(rng, kind, N, top_score(q, pk[:, :-5], ks[:, :-5],
                                                 ring, d))
    kw = dict(window=window, logit_cap=cap, k_scale=t(ks), v_scale=t(vs),
              sinks=None if sinks is None else t(sinks))
    clean = tpp.paged_flash_prefill(t(q), t(pk), t(pv), t(ring), t(kv),
                                    t(offs), 1, **kw)
    got = tpp.paged_flash_prefill(t(q), t(pk), t(pv), t(dirty), t(kv),
                                  t(offs), 1, **kw)
    assert bool(torch.isfinite(got).all())
    close(got, clean, tol=0)


def test_int8kv_sink_and_cap_forms_count_apart_on_the_card_only():
    """On the CPU nothing launches: the INT8-KV forms' sink and cap counts
    (by form name and head dim) move only on the card."""
    rng = np.random.default_rng(7)
    pk, pv, ks, vs = quant_pools(rng, 9, 32)
    tables = np.arange(8, dtype=np.int32).reshape(2, 4)
    lens = np.asarray([5, 9], np.int32)
    before = (dict(tfp.SINK_LAUNCHES), dict(tfp.CAP_LAUNCHES),
              tpd.paged_flash_decode_int8kv.launches)
    tpd.paged_flash_decode(t(rand(rng, 2, N, 32)), t(pk), t(pv), t(tables),
                           t(lens), 0, k_scale=t(ks), v_scale=t(vs),
                           logit_cap=CAP, sinks=torch.zeros(N))
    assert before == (tfp.SINK_LAUNCHES, tfp.CAP_LAUNCHES,
                      tpd.paged_flash_decode_int8kv.launches)


# ------------------------------------ tiny gpt-oss over INT8 KV (sinks)

def int8_caches(cfg, grouped, tables, ring_pages):
    """Both packages' INT8 caches (int8 pools, f32 scale pools): one pool
    set, or the grouped engine's main pools (full layers) and ring pools
    (sliding layers) of ``ring_pages`` pages a slot with the (full, ring)
    table pair."""
    import test_torch_gpt_oss as oss
    n_w = sum(w is not None for w in cfg.layer_windows)
    full = cfg.num_layers - n_w if grouped else cfg.num_layers
    jc = oss.JaxCache.create(full, 20, cfg.num_kv_heads, PS, cfg.head_dim,
                             jnp.int8)
    tc = oss.PagedKVCache.create(full, 20, cfg.num_kv_heads, PS,
                                 cfg.head_dim, torch.int8, device="cpu")
    if not grouped:
        return jc, tc, jnp.asarray(tables), torch.from_numpy(tables)
    b = tables.shape[0]
    jc = jc.with_windowed(n_w, b * ring_pages)
    tc = tc.with_windowed(n_w, b * ring_pages)
    ring = oss._ring(b, tables.shape[1], ring_pages)
    assert tc.k_w.dtype == torch.int8 and tc.k_w_scale is not None
    return (jc, tc, (jnp.asarray(tables), jnp.asarray(ring)),
            (torch.from_numpy(tables), torch.from_numpy(ring)))


def same_codes(tc, jc) -> bool:
    pairs = [(tc.k, jc.k), (tc.v, jc.v)]
    if tc.k_w is not None:
        pairs += [(tc.k_w, jc.k_w), (tc.v_w, jc.v_w)]
    return all(np.array_equal(a.numpy()[:, :-1], np.asarray(b)[:, :-1])
               for a, b in pairs)


LOGIT_TOL, LOGIT_TOL_CODE_APART = 1e-4, 1e-3


def forward_step(model, jc, tc, jt, tt, toks, pos, lens, **kw):
    """One forward_paged call of each package: logits within 1e-4 while
    both caches hold the same codes, within 1e-3 once a code is one apart
    (tests/test_torch_int8kv_engine.py's rule); the same greedy tokens."""
    import test_torch_gpt_oss as oss
    jcfg, jp, cfg, tp = model
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    prefill = "chunk_offset" in kw or toks.shape[1] > 1
    jl, jc = oss.jllama.forward_paged(
        jcfg, jp, jnp.asarray(toks), jnp.asarray(pos), jc, jt,
        jnp.asarray(lens), prefill=prefill, last_token_only=True, **jkw)
    tl, tc = oss.tllama.forward_paged(
        cfg, tp, torch.from_numpy(toks), torch.from_numpy(pos), tc, tt,
        torch.from_numpy(lens), prefill=prefill, last_token_only=True, **tkw)
    tol = LOGIT_TOL if same_codes(tc, jc) else LOGIT_TOL_CODE_APART
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                               atol=tol)
    nxt = tl[:, -1].argmax(-1).numpy().astype(np.int32)
    np.testing.assert_array_equal(nxt, np.asarray(jl)[:, -1].argmax(-1))
    return jc, tc, nxt


@pytest.mark.parametrize("how", ["grouped-chunked"])
def test_gpt_oss_forward_paged_int8kv_matches_jax(how):
    """The tiny GPT-OSS of tests/test_torch_gpt_oss.py over INT8 KV: two
    prompts of 21 and 30 tokens (past its window of 8) in 16-row chunks
    over the grouped engine's INT8 ring pools (8qs, 8qws) or whole, then
    6 decode steps (4qs, 4qws; the ring wraps)."""
    import test_torch_gpt_oss as oss
    model = oss._drawn("f32")
    cfg = model[2]
    rng = np.random.default_rng(9)
    lens0 = np.asarray([21, 30], np.int32)
    prompt = rng.integers(1, cfg.vocab_size, (2, 32)).astype(np.int32)
    grouped = how.startswith("grouped")
    jc, tc, jt, tt = int8_caches(cfg, grouped, oss.TABLES,
                                 (oss.WINDOW + 16 - 2) // PS + 2)
    if grouped:
        for off in (0, 16):
            lens = np.minimum(lens0, off + 16).astype(np.int32)
            toks = np.where(off + np.arange(16)[None] < lens[:, None],
                            prompt[:, off:off + 16], 0).astype(np.int32)
            pos = (off + np.arange(16, dtype=np.int32))[None].repeat(2, 0)
            jc, tc, nxt = forward_step(model, jc, tc, jt, tt, toks, pos,
                                       lens, chunk_offset=np.full(2, off,
                                                                  np.int32))
    else:
        toks = np.where(np.arange(32)[None] < lens0[:, None], prompt, 0)
        pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32)).copy()
        jc, tc, nxt = forward_step(model, jc, tc, jt, tt,
                                   toks.astype(np.int32), pos, lens0)
    lens = lens0.copy()
    for _ in range(6):
        jc, tc, nxt = forward_step(model, jc, tc, jt, tt, nxt[:, None],
                                   lens[:, None].copy(), lens + 1)
        lens = lens + 1
