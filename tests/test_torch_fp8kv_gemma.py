"""Gemma-1 and Gemma-2 over FP8 (e4m3) KV in the port against the JAX
package on the CPU: Gemma-2's soft cap over e4m3 pools (4ec, 4ewc, 4vec,
4vewc, 8ec, 8ewc) at head_dim 128 and 256, and the e4m3 forms at Gemma's
head_dim 256 (4e, 4ew, 4ve, 4vew, 8e, 8ew; the writes 1e, 2e, 11e; the
fused qkv 6e, with a kv_layer 6ek).

The port's wrappers run their plain versions on CPU tensors (the gather of
the exact e4m3 values, reference attention with the cap applied to the f32
score of those values, as JAX's kernels cast each element to f32 and cap
after: paged_decode.py:79-91, paged_prefill.py:108-124); the JAX kernels
run in interpret mode, its writes through their scatter route, as the JAX
package's own tests run them, on the same numpy inputs (float32, seeded),
e4m3 pools passing between the packages as their bytes
(tests/test_torch_fp8kv.py's helpers). Stated tolerances:
- attention over e4m3 pools: 1e-5 of the outputs' largest magnitude (sums
  in another order; the stored values are exact in both), scores several
  times past the cap, kv_len 0 rows, verify rows at Gemma-1's group of 8
  x 5 rows (two of the kernel's row blocks) and Gemma-2's group of 2,
  windows over ring tables whose columns below the band sit on pages of
  code 0x7f (NaN in e4m3fn), which no form may read;
- the writes 1e, 2e, 11e at D 256: byte-equal (every page but the trash
  page), rows past 464 (NaN codes) included;
- the fused qkv at D 256: f32 against JAX's unfused route, q within 1e-5
  and the pools byte-equal; bf16 against JAX's kernel, q within 2e-2 of
  its standard deviation and the written codes at most one e4m3 step
  apart (tests/test_torch_fp8kv.py's rule); the kernels' D-256 column map
  (two 64-column runs of one head a block, each block rounding its own
  columns to e4m3) emulated in numpy and shown to write every k/v column
  of every row once, with the plain version's bytes.

And the models: the tiny Gemma of tests/test_torch_gemma.py (D 256, one
kv head) and the tiny Gemma-2 of tests/test_torch_gemma2.py at D 256
(query_pre_attn_scalar 256, cap 50, window 4) over FP8 KV, in the Engine
(Gemma-1: INT8 weights with the prefix cache and 16-row chunks; Gemma-2:
the grouped engine's e4m3 ring pools, INT8 weights in 16-row chunks) and
the spec Engine (spec_tokens 4, f32 weights), and Gemma-2's
``forward_paged`` call by call from JAX's codes; the rule of
tests/test_torch_fp8kv_engine.py: the rows a call writes at most one e4m3
step apart, logits within 1e-4 while both caches hold the same codes and
within 1e-2 once a code parts, greedy tokens exact, the prefix and
speculation metrics equal.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_fp8kv as f8
import test_torch_fp8kv_sinks_window as sw
import test_torch_gemma as gem
import test_torch_gemma2 as gem2
import test_torch_gpt_oss as oss
from simplellminference_tpu.memory import paged_kv as jpkv
from simplellminference_tpu.ops import qkv_fused as jqkv
from simplellminference_tpu.ops import ref_ops as jref
from simplellminference_tpu.ops.attention.paged_decode import (
    paged_flash_decode as jpaged_decode)
from simplellminference_tpu.ops.attention.paged_decode import (
    paged_flash_verify as jpaged_verify)
from simplellminference_tpu.ops.attention.paged_prefill import (
    paged_flash_prefill as jpaged_prefill)
from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                      KVCacheConfig,
                                                      SamplingParams)
from simplellminference_tpu_torch.engine import Engine
from simplellminference_tpu_torch.memory import paged_kv as tpkv
from simplellminference_tpu_torch.ops import qkv_fused as tqkv
from simplellminference_tpu_torch.ops.attention import flash_prefill as tfp
from simplellminference_tpu_torch.ops.attention import paged_decode as tpd
from simplellminference_tpu_torch.ops.attention import paged_prefill as tpp
from simplellminference_tpu_torch.ops.ref_ops import to_e4m3

D = 256
N, KVN, PS = 8, 2, 8          # a GQA group of 4
CAP = 2.0                     # scores of these draws reach several times it
E4 = torch.float8_e4m3fn
t, j, rand, codes, close = f8.t, sw.j, f8.rand, f8.codes, sw.close
# (head dim, cap) of the attention cases: the e4m3 forms at D 256, their
# capped forms at D 256 and 128
DCAP = [(256, None), (256, CAP), (128, CAP)]
DCAP_IDS = ["d256", "d256-capped", "d128-capped"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread (see
    tests/test_torch_fp8kv_sinks_window.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bites(q, pk, tables, d, cap):
    """With a cap, the case's scores reach well past it."""
    if cap:
        assert sw.top_score(q, pk, tables, d) > 3 * cap


# ------------------------------------------------------------ kernel 4

@pytest.mark.parametrize("window", [None, 6], ids=["4e", "4ew"])
@pytest.mark.parametrize("d,cap", DCAP, ids=DCAP_IDS)
def test_paged_decode_fp8kv_gemma_matches_jax(d, cap, window):
    """4e/256, 4ew/256, 4ec, 4ewc: kv_len 0 (a zero row), 1, 7 (the
    window's edge), a page edge, a full table."""
    rng = np.random.default_rng(d + bool(cap) + (window or 0))
    b, mp = 5, 6
    pk, pv = sw.pools(rng, b * mp + 1, d)
    tables = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    lens = np.asarray([0, 1, 7, 16, 48], np.int32)
    q = rand(rng, b, N, d)
    _bites(q, pk, tables, d, cap)
    (tk, tv), (jk, jv) = sw.both(pk, pv)
    got = tpd.paged_flash_decode(t(q), tk, tv, t(tables), t(lens), 1,
                                 window=window, logit_cap=cap)
    want = jpaged_decode(j(q), jk, jv, j(tables), j(lens), interpret=True,
                         layer=jnp.int32(1), window=window, logit_cap=cap)
    close(got, want)
    assert not got[0].any()
    if cap:
        # the cap moves the outputs: it bites
        plain = tpd.paged_flash_decode(t(q), tk, tv, t(tables), t(lens), 1,
                                       window=window)
        assert float((plain - got).abs().max()) > 1e-2


@pytest.mark.parametrize("window", [None, 6], ids=["4ve", "4vew"])
@pytest.mark.parametrize("d,n,cap", [(256, 16, None), (256, 4, CAP),
                                     (128, 16, CAP)],
                         ids=["d256-gemma-group8", "d256-gemma2-group2-capped",
                              "d128-group8-capped"])
def test_paged_verify_fp8kv_gemma_matches_jax(d, n, cap, window):
    """4ve/256, 4vew/256 at Gemma-1's group of 8 over 5 rows (two row
    blocks), 4vec, 4vewc at Gemma-2's group of 2 (D 256) and a group of 8
    (D 128): the rows with keys against JAX's, the rows without zero."""
    rng = np.random.default_rng(10 + d + n + (window or 0))
    b, mp, s = 4, 6, 5
    pk, pv = sw.pools(rng, b * mp + 1, d)
    tables = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    lens = np.asarray([0, 2, 19, 48], np.int32)
    q = rand(rng, b, s, n, d)
    _bites(q, pk, tables, d, cap)
    if n == 16:
        assert tpd.row_blocks((n // KVN) * s) == 2
    (tk, tv), (jk, jv) = sw.both(pk, pv)
    form = (tpd.paged_flash_verify_fp8kv_window if window
            else tpd.paged_flash_verify_fp8kv)
    got = (tpd.paged_flash_verify(t(q), tk, tv, t(tables), t(lens), 1,
                                  window=window, logit_cap=cap)
           if cap else form(t(q), tk, tv, t(tables), t(lens), 1,
                            *([window] if window else [])))
    want = np.asarray(jpaged_verify(
        j(q), jk, jv, j(tables), j(lens), interpret=True, layer=jnp.int32(1),
        window=window, logit_cap=cap))
    for i, ln in enumerate(lens):
        live = [r for r in range(s) if ln - s + r >= 0]
        close(got[i, live], want[i, live])
        assert not got[i, [r for r in range(s) if r not in live]].any()


@pytest.mark.parametrize("cap", [None, CAP], ids=["4ew-4vew", "4ewc-4vewc"])
def test_paged_decode_verify_fp8kv_d256_window_read_no_page_below_the_band(
        cap):
    """4ew/256, 4vew/256 and their capped forms over ring tables whose
    columns below the band sit on pages of NaN codes: finite, equal to the
    clean tables' outputs and to JAX's kernel on them."""
    rng = np.random.default_rng(30 + bool(cap))
    b, r, mp, window = 3, 3, 12, 6
    lens = np.asarray([0, 29, 41], np.int32)
    pk, pv, ring, dirty = sw.ring_case(rng, b, r, mp, D,
                                       lens - 5 - window + 1)
    (tk, tv), (jk, jv) = sw.both(pk, pv)
    for s, n in ((1, N), (5, 2 * N)):
        q = rand(rng, b, s, n, D)
        kw = dict(window=window, logit_cap=cap)
        fn, jfn = ((tpd.paged_flash_verify, jpaged_verify) if s > 1
                   else (tpd.paged_flash_decode, jpaged_decode))
        qq = q if s > 1 else q[:, 0]
        clean = fn(t(qq), tk, tv, t(ring), t(lens), 1, **kw)
        got = fn(t(qq), tk, tv, t(dirty), t(lens), 1, **kw)
        assert bool(torch.isfinite(got).all())
        close(got, clean, tol=0)
        want = np.asarray(jfn(j(qq), jk, jv, j(ring), j(lens),
                              interpret=True, layer=jnp.int32(1), **kw))
        live = lens > 0
        close(got.numpy()[live], want[live])


# ------------------------------------------------------------ kernel 8

@pytest.mark.parametrize("window", [None, 5], ids=["8e", "8ew"])
@pytest.mark.parametrize("d,cap", DCAP, ids=DCAP_IDS)
def test_paged_prefill_fp8kv_gemma_matches_jax(d, cap, window):
    """8e/256, 8ew/256, 8ec, 8ewc: two 16-row chunks at offsets 0 and 16
    (the second ragged), against JAX's kernel row by valid row."""
    rng = np.random.default_rng(40 + d + bool(cap) + (window or 0))
    b, s, mp = 2, 16, 6
    pk, pv = sw.pools(rng, b * mp + 1, d)
    tables = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    offs = np.asarray([0, 16], np.int32)
    kv = np.asarray([16, 27], np.int32)
    q = rand(rng, b, s, N, d)
    _bites(q, pk, tables, d, cap)
    (tk, tv), (jk, jv) = sw.both(pk, pv)
    if cap:
        got = tpp.paged_flash_prefill(t(q), tk, tv, t(tables), t(kv),
                                      t(offs), 1, window=window,
                                      logit_cap=cap)
    elif window:
        got = tpp.paged_flash_prefill_fp8kv_window(
            t(q), tk, tv, t(tables), t(kv), t(offs), 1, window)
    else:
        got = tpp.paged_flash_prefill_fp8kv(t(q), tk, tv, t(tables), t(kv),
                                            t(offs), 1)
    want = np.asarray(jpaged_prefill(
        j(q), jk, jv, j(tables), j(kv), j(offs), bq=s, interpret=True,
        layer=jnp.int32(1), window=window, logit_cap=cap))
    for i in range(b):
        valid = int(kv[i] - offs[i])
        close(got[i, :valid], want[i, :valid])


@pytest.mark.parametrize("cap", [None, CAP], ids=["8ew", "8ewc"])
def test_paged_prefill_fp8kv_d256_window_reads_no_page_below_the_band(cap):
    """8ew/256, 8ewc/256 over ring tables whose columns below the chunk's
    band sit on pages of NaN codes: finite, equal to the clean tables and
    to JAX's kernel on them."""
    rng = np.random.default_rng(60 + bool(cap))
    b, r, mp, s, window = 2, 4, 8, 8, 5
    offs = np.asarray([24, 40], np.int32)
    kv = offs + s
    pk, pv, ring, dirty = sw.ring_case(rng, b, r, mp, D, offs - window + 1)
    q = rand(rng, b, s, N, D)
    (tk, tv), (jk, jv) = sw.both(pk, pv)
    kw = dict(window=window, logit_cap=cap)
    clean = tpp.paged_flash_prefill(t(q), tk, tv, t(ring), t(kv), t(offs), 1,
                                    **kw)
    got = tpp.paged_flash_prefill(t(q), tk, tv, t(dirty), t(kv), t(offs), 1,
                                  **kw)
    assert bool(torch.isfinite(got).all())
    close(got, clean, tol=0)
    want = jpaged_prefill(j(q), jk, jv, j(ring), j(kv), j(offs), bq=s,
                          interpret=True, layer=jnp.int32(1), **kw)
    close(got, want)


def test_fp8kv_gemma_forms_count_on_the_card_only():
    """On the CPU nothing launches: the e4m3 forms' counts, their D-256
    counts and the capped launches by form and head dim move only on the
    card."""
    rng = np.random.default_rng(7)
    pk, pv = sw.pools(rng, 9, D)
    (tk, tv), _ = sw.both(pk, pv)
    tables = np.arange(8, dtype=np.int32).reshape(2, 4)
    lens = np.asarray([5, 9], np.int32)
    forms = (tpd.paged_flash_decode_fp8kv, tpd.paged_flash_verify_fp8kv,
             tpp.paged_flash_prefill_fp8kv)
    before = (dict(tfp.CAP_LAUNCHES), dict(tpd.D256_LAUNCHES),
              dict(tpp.D256_LAUNCHES), [f.launches for f in forms])
    q = t(rand(rng, 2, 1, N, D))
    tpd.paged_flash_decode(q[:, 0], tk, tv, t(tables), t(lens), 0,
                           logit_cap=CAP)
    tpd.paged_flash_verify(q, tk, tv, t(tables), t(lens), 0, logit_cap=CAP)
    tpp.paged_flash_prefill(q, tk, tv, t(tables), t(lens), t(lens - 1), 0,
                            logit_cap=CAP)
    assert before == (tfp.CAP_LAUNCHES, tpd.D256_LAUNCHES,
                      tpp.D256_LAUNCHES, [f.launches for f in forms])


def test_sinks_at_d256_still_raise_over_e4m3_pools():
    """Sinks at head_dim 256 (no model with sinks has it) raise, named,
    over e4m3 pools as over every pool dtype, on the CPU as on the card."""
    rng = np.random.default_rng(8)
    pk, pv = sw.pools(rng, 9, D)
    (tk, tv), _ = sw.both(pk, pv)
    tables = np.arange(8, dtype=np.int32).reshape(2, 4)
    lens = np.asarray([5, 9], np.int32)
    q = t(rand(rng, 2, 1, N, D))
    for call in (
            lambda: tpd.paged_flash_decode(q[:, 0], tk, tv, t(tables),
                                           t(lens), 0, sinks=torch.zeros(N),
                                           logit_cap=CAP),
            lambda: tpd.paged_flash_verify(q, tk, tv, t(tables), t(lens), 0,
                                           sinks=torch.zeros(N)),
            lambda: tpp.paged_flash_prefill(q, tk, tv, t(tables), t(lens),
                                            t(lens - 1), 0,
                                            sinks=torch.zeros(N))):
        with pytest.raises(NotImplementedError, match="sinks at head_dim"):
            call()


# ------------------------------------------------- 1e, 2e, 11e at D 256

TABLES = f8.TABLES


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_write_decode_e4m3_d256_matches_jax(dtype):
    """1e/256: three rows (one into page 1's slot 1, one into page 11,
    one of an inactive slot: the trash page), rows past 464 too."""
    rng = np.random.default_rng(1)
    pools = f8.e4m3_pools(rng, d=D)
    tk, jk = f8.rows(rng, (3, f8.KVN, D), dtype)
    tv, jv = f8.rows(rng, (3, f8.KVN, D), dtype)
    positions = np.array([17, 9, 4], np.int32)
    want = jpkv.write_decode_stacked(
        f8.jax_e4(pools[0]), f8.jax_e4(pools[1]), jk, jv,
        jnp.asarray(TABLES), jnp.asarray(positions), jnp.int32(2))
    tp = [f8.torch_e4(p) for p in pools]
    tpkv.write_decode_stacked(tp[0], tp[1], tk, tv, t(TABLES), t(positions),
                              2)
    f8.assert_pools_equal(tp, want[:2])
    assert (codes(tp[0])[2, 1, :, 1] & 0x7F == 0x7F).any()  # NaN codes


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s", [16, 13, 1], ids=["full", "ragged", "one"])
def test_write_prefill_e4m3_d256_matches_jax(dtype, s):
    """2e/256: whole and ragged prompts (code 0 past the prompt in its
    last page), an unmapped tail and an inactive slot."""
    rng = np.random.default_rng(s)
    pools = f8.e4m3_pools(rng, d=D)
    tk, jk = f8.rows(rng, (3, s, f8.KVN, D), dtype)
    tv, jv = f8.rows(rng, (3, s, f8.KVN, D), dtype)
    want = jpkv.write_prefill_stacked(
        f8.jax_e4(pools[0]), f8.jax_e4(pools[1]), jk, jv,
        jnp.asarray(TABLES), jnp.int32(1))
    tp = [f8.torch_e4(p) for p in pools]
    tpkv.write_prefill_stacked(tp[0], tp[1], tk, tv, t(TABLES), 1)
    f8.assert_pools_equal(tp, want[:2])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("span", [1, 5])
def test_write_span_e4m3_d256_matches_jax(dtype, span):
    """11e/256: spans of 1 and 5 rows, one across a page, one unmapped."""
    rng = np.random.default_rng(20 + span)
    pools = f8.e4m3_pools(rng, pages=13, d=D)
    tables = np.array([[3, 7, 1], [0, 11, -1], [-1, -1, -1], [5, 2, 9]],
                      np.int32)
    positions = np.array([6, 12, 0, 21], np.int32)
    tk, jk = f8.rows(rng, (4, span, f8.KVN, D), dtype)
    tv, jv = f8.rows(rng, (4, span, f8.KVN, D), dtype)
    want = jpkv.write_span_stacked(
        f8.jax_e4(pools[0]), f8.jax_e4(pools[1]), jk, jv,
        jnp.asarray(tables), jnp.asarray(positions), jnp.int32(0))
    tp = [f8.torch_e4(p) for p in pools]
    tpkv.write_span_stacked(tp[0], tp[1], tk, tv, t(tables), t(positions), 0)
    f8.assert_pools_equal(tp, want[:2])


# ------------------------------------------ 6e and 6ek at D 256

def _qkv_case(seed, n, kvn, dtype, kv_layer):
    """Gemma's fused qkv shapes, small: n q heads over kvn kv heads of 256,
    three rows (row 2's page unmapped: the trash page), the weights of
    layer 1, e4m3 pools written at ``kv_layer`` (or 1); weight scales that
    put some k/v values past 464 (NaN codes)."""
    rng = np.random.default_rng(seed)
    lyr, h, ps, mp, b, li = 2, 128, 16, 3, 3, 1
    nq = (n + 2 * kvn) * D
    p1 = b * mp + 1
    wq = rng.integers(-127, 128, (lyr, h, nq)).astype(np.int8)
    ws = (rng.uniform(0.5, 2.0, (lyr, 1, nq)) * 2e-1).astype(np.float32)
    nw = (rng.standard_normal((lyr, h)) * 0.1 + 1.0).astype(np.float32)
    x = rand(rng, b, h)
    if dtype == "bf16":
        xt = t(x).bfloat16()
        xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    else:
        xt, xj = t(x), jnp.asarray(x)
    pos = np.asarray([5, 20, 40], np.int32)
    tables = np.asarray([[3, 7, 1], [0, 5, 8], [2, 4, -1]], np.int32)
    pools = f8.e4m3_pools(rng, lyr, p1, kvn, ps, D)
    kli = li if kv_layer is None else kv_layer
    written = np.zeros((lyr, p1, kvn, ps), bool)
    for r in range(b):
        page = tables[r, pos[r] // ps]
        written[kli, page if page >= 0 else p1 - 1, :, pos[r] % ps] = True
    return dict(wq=wq, ws=ws, nw=nw, xt=xt, xj=xj, pos=pos, tables=tables,
                pools=pools, written=written, n=n, kvn=kvn, li=li, kli=kli,
                kv_layer=kv_layer)


def _port_fused(c, fn=tqkv.fused_qkv_append):
    sin, cos = jref.rope_tables(jnp.asarray(c["pos"]), D, 10000.0)
    tp = [f8.torch_e4(p) for p in c["pools"]]
    q, *out = fn(c["xt"], t(c["nw"]), t(c["wq"]), t(c["ws"]),
                 t(np.array(sin)), t(np.array(cos)), tp[0], tp[1], c["li"],
                 t(c["pos"]), n_heads=c["n"], kv_heads=c["kvn"], eps=1e-5,
                 tables=t(c["tables"]), kv_layer=c["kv_layer"])
    assert all(a is b for a, b in zip(out, tp))
    return q, tp, (sin, cos)


def _jax_unfused(c, sin, cos):
    """JAX's unfused f32 route of the same step: rmsnorm, the INT8
    product, RoPE, the e4m3 decode write (at the kv_layer)."""
    n, kvn, li = c["n"], c["kvn"], c["li"]
    xn = jref.rmsnorm(c["xj"], jnp.asarray(c["nw"][li]), 1e-5)
    qkv = f8.jlinear(xn, f8.JaxQW(q=jnp.asarray(c["wq"]),
                                  scales=jnp.asarray(c["ws"])),
                     layer=jnp.int32(li))
    b = qkv.shape[0]

    def rope(x, heads):
        return jref.apply_rope(x.reshape(b, 1, heads, D), sin[:, None],
                               cos[:, None])[:, 0]

    q = rope(qkv[:, :n * D], n)
    k = rope(qkv[:, n * D:(n + kvn) * D], kvn)
    v = qkv[:, (n + kvn) * D:].reshape(b, kvn, D)
    want = jpkv.write_decode_stacked(
        f8.jax_e4(c["pools"][0]), f8.jax_e4(c["pools"][1]), k, v,
        jnp.asarray(c["tables"]), jnp.asarray(c["pos"]), jnp.int32(c["kli"]))
    return q, k, want


@pytest.mark.parametrize("kv_layer", [None, 0], ids=["6e", "6ek"])
@pytest.mark.parametrize("n,kvn", [(4, 1), (4, 2)], ids=["gemma", "gemma2"])
def test_fused_qkv_append_e4m3_d256_matches_jax_unfused_f32(n, kvn,
                                                             kv_layer):
    """6e/256, 6ek/256 in f32 against JAX's unfused route: q within 1e-5,
    the pools byte-equal (the written rows' NaN codes included)."""
    c = _qkv_case(50 + n + kvn + (kv_layer or 0), n, kvn, "f32", kv_layer)
    q_t, tp, (sin, cos) = _port_fused(c)
    q, k, want = _jax_unfused(c, sin, cos)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q), rtol=f8.TOL,
                               atol=f8.TOL * float(np.abs(np.asarray(q)).max()))
    assert float(np.abs(np.asarray(k)).max()) > 464
    f8.assert_pools_equal(tp, want[:2])
    assert c["written"][c["kli"], -1].any()   # the trash page took row 2


@pytest.mark.parametrize("kv_layer", [None, 0], ids=["6e", "6ek"])
@pytest.mark.parametrize("n,kvn", [(4, 1), (4, 2)], ids=["gemma", "gemma2"])
def test_fused_qkv_append_e4m3_d256_matches_jax_kernel_bf16(n, kvn,
                                                             kv_layer):
    """6e/256, 6ek/256 in bf16 against JAX's kernel in interpret mode: q
    within 2e-2 of its standard deviation, the written codes at most one
    e4m3 step apart, every other byte equal."""
    c = _qkv_case(60 + n + kvn + (kv_layer or 0), n, kvn, "bf16", kv_layer)
    q_t, tp, (sin, cos) = _port_fused(c, tqkv.fused_qkv_append_fp8kv)
    q_j, *want = jqkv.fused_qkv_append(
        c["xj"], jnp.asarray(c["nw"]), jnp.asarray(c["wq"]),
        jnp.asarray(c["ws"]), sin, cos, f8.jax_e4(c["pools"][0]),
        f8.jax_e4(c["pools"][1]), jnp.int32(c["li"]), jnp.asarray(c["pos"]),
        n_heads=n, kv_heads=kvn, eps=1e-5, tables=jnp.asarray(c["tables"]),
        kv_layer=None if kv_layer is None else jnp.int32(kv_layer),
        interpret=True)
    assert q_t.dtype == torch.bfloat16
    want_q = np.asarray(q_j, np.float32)
    np.testing.assert_allclose(q_t.float().numpy(), want_q, rtol=0,
                               atol=2e-2 * float(np.std(want_q)))
    w = c["written"][..., None].repeat(D, -1)
    for g, jw in zip(tp, want):
        g, jw = codes(g), codes(jw)
        np.testing.assert_array_equal(g[~w], jw[~w])
        assert np.abs(f8._ordinal(g[w]) - f8._ordinal(jw[w])).max() <= 1


@pytest.mark.parametrize("n,kvn", [(4, 1), (4, 2)], ids=["gemma", "gemma2"])
def test_e4m3_d256_blocks_write_every_kv_column_once(n, kvn):
    """Kernels 6 and 6m at D 256 over e4m3 pools (csrc/qkv_fused*.cu):
    block x's tail rotates each of its pairs (t1, t1 + 64) of qkv columns
    g1 = block_col(x, t1) and g1 + 128 (head g1 / 256, columns j and j +
    128) and rounds each to e4m3 into its row's slot on its own, with no
    further launch. Emulated block by block from the plain version's f32
    k/v rows: every (row, k/v head, column) written exactly once, no q
    column in a pool, and the pools byte-equal to the plain version's."""
    c = _qkv_case(70 + n + kvn, n, kvn, "f32", None)
    sin, cos = jref.rope_tables(jnp.asarray(c["pos"]), D, 10000.0)
    q_t, tp, _ = _port_fused(c)
    _q, k, _want = _jax_unfused(c, sin, cos)
    k = np.asarray(k)
    li, b = c["li"], 3
    xn = jref.rmsnorm(c["xj"], jnp.asarray(c["nw"][li]), 1e-5)
    qkv = np.asarray(f8.jlinear(xn, f8.JaxQW(
        q=jnp.asarray(c["wq"]), scales=jnp.asarray(c["ws"])),
        layer=jnp.int32(li)))
    v = qkv[:, (n + kvn) * D:].reshape(b, kvn, D)
    rows = codes(to_e4m3(t(np.concatenate([k, v], axis=1))))  # [b, 2kvn, D]
    emu = [p.copy() for p in c["pools"]]
    seen = np.zeros((b, 2 * kvn, D), int)
    ps, p1 = 16, c["pools"][0].shape[1]
    for x in range((n + 2 * kvn) * D // 128):
        for row in range(b):
            page = c["tables"][row, c["pos"][row] // ps]
            page = page if page >= 0 else p1 - 1
            slot = c["pos"][row] % ps
            for p in range(64):
                for col in (p, p + 64):
                    g = gem._block_col(x, col, D)
                    head, jj = g // D, g % D
                    if head < n:
                        continue
                    hh = head - n
                    seen[row, hh, jj] += 1
                    emu[hh // kvn][li, page, hh % kvn, slot, jj] = rows[
                        row, hh, jj]
    assert (seen == 1).all()
    f8.assert_pools_equal(tp, [f8.torch_e4(e) for e in emu])


# ----------------------------------------------------------- the models

_MODELS: dict = {}


def _gemma(kind):
    """The tiny Gemma of tests/test_torch_gemma.py (D 256, 4 heads over
    one kv head)."""
    key = ("gemma", kind)
    if key not in _MODELS:
        _MODELS[key] = gem._gemma(kind == "int8")
    return _MODELS[key]


def _gemma2(kind):
    """The tiny Gemma-2 of tests/test_torch_gemma2.py at head_dim 256
    (query_pre_attn_scalar 256): 4 heads over 2 kv heads, cap 50, window
    4."""
    key = ("gemma2", kind)
    if key not in _MODELS:
        _MODELS[key] = gem2._model(kind == "int8", head_dim=D,
                                   query_pre_attn_scalar=256.0)
    return _MODELS[key]


KV = dict(page_size=PS, num_pages=96, max_pages_per_seq=16, kv_dtype="fp8")


def port_engine(model, **ecfg):
    _jcfg, _jp, cfg, tp = model
    return Engine(cfg, tp, EngineConfig(max_batch_size=4,
                                        kv=KVCacheConfig(**KV), **ecfg),
                  decode_burst=3, device="cpu")


def engine_pair(model, **ecfg):
    """A JAX Engine and a port Engine over FP8 KV, one configuration (JAX
    warns that FP8 KV is slow on a TPU v5e; the port does not)."""
    jcfg, jp, cfg, tp = model
    kv = KV
    with pytest.warns(RuntimeWarning, match="v5e"):
        je = oss.JaxEngine(jcfg, jp, oss.JaxEngineConfig(
            max_batch_size=4, kv=oss.JaxKVConfig(**kv), **ecfg),
            decode_burst=3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        te = port_engine(model, **ecfg)
    assert te._grouped == je._grouped
    assert te.cache.k.dtype == E4 and te.cache.k_scale is None
    return je, te


def test_gemma_engine_fp8kv_prefix_cache_matches_jax():
    """Gemma-1 (D 256, one kv head; INT8 weights) over FP8 KV with the
    prefix cache and 16-row chunks: a prompt, then (after it finished) two
    sharing its system prompt: 6e/256, 4e/256, 8e/256, 2e/256 on the
    card."""
    model = _gemma("int8")
    je, te = engine_pair(model, prefill_chunk=16)
    assert not te._grouped
    waves = [[oss.SYSTEM + [7, 7, 7]],
             [oss.SYSTEM + [101, 4, 9], list(range(30, 49))]]
    jr, tr = sw.run_both(je, te, waves, 8)
    sw.assert_engines_agree(model[2], je, te, jr, tr)
    assert te.metrics.prefix_cache_hits > 0
    assert len({tok for r in tr for tok in r.output_ids}) > 2


def test_gemma_spec_engine_fp8kv_matches_jax():
    """Gemma-1 (f32 weights) over FP8 KV in the spec Engine (spec_tokens
    4): 4ve/256 on the verify rows (a group of 4 x 5 rows), 11e/256;
    tokens and speculative metrics equal JAX's, and the tokens the
    spec_tokens=0 Engine's."""
    model = _gemma("f32")
    prompts = [[2, 5, 9, 200, 17] * 3, [7, 7, 7] * 4, list(range(30, 49))]
    je, te = engine_pair(model, spec_tokens=4)
    jr, tr = sw.run_both(je, te, [prompts], 10)
    sw.assert_engines_agree(model[2], je, te, jr, tr)
    assert te.metrics.spec_accepted > 0
    assert port_engine(model).generate(
        prompts, SamplingParams(max_new_tokens=10)) == [r.output_ids
                                                        for r in tr]


def test_gemma2_d256_grouped_engine_fp8kv_matches_jax():
    """Gemma-2 at D 256 (INT8 weights) over FP8 KV in the grouped engine
    (e4m3 ring pools for the sliding layers), 16-row chunks: 8ec/8ewc,
    4ec/4ewc, 6ek/256, 2e/256."""
    model = _gemma2("int8")
    je, te = engine_pair(model, prefill_chunk=16)
    assert te._grouped and te.cache.k_w.dtype == E4
    assert te.cache.k_w_scale is None
    jr, tr = sw.run_both(je, te, [gem2.PROMPTS], 10)
    sw.assert_engines_agree(model[2], je, te, jr, tr)
    assert len({tok for r in tr for tok in r.output_ids}) > 2


def test_gemma2_d256_spec_engine_fp8kv_matches_jax():
    """The spec Engine (spec_tokens 4, f32 weights) over FP8 KV at
    Gemma-2's D 256: 4vec/256 and 4vewc/256 on the verify rows, 11e/256;
    tokens and speculative metrics equal JAX's, and the tokens the
    spec_tokens=0 Engine's."""
    model = _gemma2("f32")
    prompts = [[5, 6, 7, 8] * 4, list(range(30, 45)), [9, 8, 7] * 3]
    je, te = engine_pair(model, spec_tokens=4)
    assert te._grouped
    jr, tr = sw.run_both(je, te, [prompts], 10)
    sw.assert_engines_agree(model[2], je, te, jr, tr)
    assert te.metrics.spec_accepted > 0
    assert port_engine(model).generate(
        prompts, SamplingParams(max_new_tokens=10)) == [r.output_ids
                                                        for r in tr]


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_gemma2_d256_forward_paged_fp8kv_matches_jax(kind):
    """Gemma-2 at D 256 over FP8 KV through ``forward_paged``, call by
    call from JAX's codes: two prompts of 11 and 14 tokens (past the
    window of 4) in 8-row chunks over the grouped engine's e4m3 ring pools
    (8ec, 8ewc), then 5 decode steps (4ec, 4ewc; the ring wraps)."""
    model = _gemma2(kind)
    cfg = model[2]
    rng = np.random.default_rng(19)
    lens0 = np.asarray([11, 14], np.int32)
    prompt = rng.integers(1, cfg.vocab_size, (2, 16)).astype(np.int32)
    tables = np.arange(2 * 4, dtype=np.int32).reshape(2, 4)
    jc, tc, jt, tt = sw.fp8_caches(cfg, tables,
                                   (gem2.WINDOW + 8 - 2) // PS + 2)
    for off in (0, 8):
        lens = np.minimum(lens0, off + 8).astype(np.int32)
        toks = np.where(off + np.arange(8)[None] < lens[:, None],
                        prompt[:, off:off + 8], 0).astype(np.int32)
        pos = (off + np.arange(8, dtype=np.int32))[None].repeat(2, 0)
        jc, tc, nxt = sw.forward_step(model, jc, tc, jt, tt, toks, pos, lens,
                                      chunk_offset=np.full(2, off, np.int32))
    lens = lens0.copy()
    for _ in range(5):
        jc, tc, nxt = sw.forward_step(model, jc, tc, jt, tt, nxt[:, None],
                                      lens[:, None].copy(), lens + 1)
        lens = lens + 1
