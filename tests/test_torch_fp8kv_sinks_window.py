"""GPT-OSS's attention sinks and sliding windows over FP8 (e4m3) KV pools in
the port (forms 4es, 4ews, 4ves, 4vews, 8es, 8ews; 4ew, 4vew, 8ew; 6ek,
the fused qkv writing e4m3 ring pools at a kv_layer) against the JAX
package on the CPU.

The port's wrappers run their plain versions on CPU tensors (gather of the
exact e4m3 values, reference attention: the sink a raw logit in the
softmax); the JAX kernels run in interpret mode, as the JAX package's own
tests run them, on the same numpy inputs (float32, seeded), e4m3 pools
passing between the packages as their bytes, cast by the port's
``to_e4m3`` (byte-equal to JAX's cast: tests/test_torch_fp8kv.py), at head
dims 32, 64 and 128: sinks N(0, 1) and sinks above every score of their
rows; kv_len 0 rows; windows at their edges; verify rows at a GQA group of
8 x 5 rows (two of the kernel's row blocks); window forms over ring tables
whose columns below the band point at pages of code 0x7f (NaN in e4m3fn),
which no form may read. Stated tolerances: 1e-5 for the attention forms
(sums in another order; the stored values are exact in both), exact bytes
for the pool writes (6ek in f32 against JAX's unfused route, and
``with_windowed``), codes at most one e4m3 step apart for 6ek in bf16
against JAX's kernel (tests/test_torch_fp8kv.py's rule).

And the models: the tiny GPT-OSS of tests/test_torch_gpt_oss.py over FP8
KV through ``forward_paged`` (16-row chunks and decode over the grouped
engine's e4m3 ring pools) and the grouped Engine (INT8 weights with the
prefix cache and chunked prefill; f32 weights with spec_tokens 2), and a
tiny Mistral-style model (``ModelConfig.tiny_test`` with a sliding window
of 8, INT8 weights, so its decode takes the fused qkv with a kv_layer:
6ek), each against JAX's: ``forward_paged`` call by call from the same
cache, the rows each call writes at most one e4m3 step apart and its
logits within 1e-4 where both wrote the same codes, within 1e-2 where a
code is a step apart; the Engines' greedy tokens exact, logprobs within
1e-2, the model's first layer's codes at most one step apart (later
layers are held by the logit rule: a parted code moves their inputs), the
prefix and speculation metrics equal.
"""

import inspect
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_fp8kv as f8
import test_torch_gpt_oss as oss
from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.core.config import QuantConfig as JaxQuantConfig
from simplellminference_tpu.memory import paged_kv as jpkv
from simplellminference_tpu.ops import qkv_fused as jqkv
from simplellminference_tpu.ops import ref_ops as jref
from simplellminference_tpu.ops.attention.paged_decode import (
    paged_flash_decode as jpaged_decode)
from simplellminference_tpu.ops.attention.paged_decode import (
    paged_flash_verify as jpaged_verify)
from simplellminference_tpu.ops.attention.paged_prefill import (
    paged_flash_prefill as jpaged_prefill)
from simplellminference_tpu.runtime.weights import (
    quantize_params as jquantize_params)
from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                      KVCacheConfig,
                                                      ModelConfig,
                                                      SamplingParams)
from simplellminference_tpu_torch.engine import Engine
from simplellminference_tpu_torch.memory import paged_kv as tpkv
from simplellminference_tpu_torch.models.convert import params_from_jax
from simplellminference_tpu_torch.ops import qkv_fused as tqkv
from simplellminference_tpu_torch.ops.attention import flash_prefill as tfp
from simplellminference_tpu_torch.ops.attention import paged_decode as tpd
from simplellminference_tpu_torch.ops.attention import paged_prefill as tpp
from simplellminference_tpu_torch.ops.ref_ops import to_e4m3

TOL = 1e-5
N, KVN, PS = 8, 2, 8          # a GQA group of 4
VN, VS = 16, 5                # verify rows: a group of 8 x 5 rows
E4 = torch.float8_e4m3fn
NAN = 0x7F                    # an e4m3fn NaN code
LOGIT_TOL, LOGIT_TOL_CODE_APART = 1e-4, 1e-2
KINDS = ["sinks", "sinks-above", "window", "window-sinks"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread: the tiny ops are far below
    where threads pay off, and under the suite's parallel workers the
    threads spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


t, rand, codes = f8.t, f8.rand, f8.codes


def j(a):
    return None if a is None else jnp.asarray(a)


def close(got, want, tol=TOL):
    """Within ``tol`` of the outputs' largest magnitude (at least 1)."""
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * max(1.0, top))


def e4m3(rng, *shape):
    """uint8 e4m3 codes of N(0, 2^2) values (the port's cast)."""
    return codes(to_e4m3(t(rand(rng, *shape, scale=2.0))))


def pools(rng, pages, d, kvn=KVN, ps=PS):
    """Two layers of e4m3 K and V pools (uint8 codes)."""
    return (e4m3(rng, 2, pages, kvn, ps, d), e4m3(rng, 2, pages, kvn, ps, d))


def both(pk, pv):
    """The pools as each package takes them."""
    return (f8.torch_e4(pk), f8.torch_e4(pv)), (f8.jax_e4(pk), f8.jax_e4(pv))


def top_score(q, pk, tables, d):
    """The largest |score| of any q row against any key of layer 1's pages
    in ``tables`` (at least every score a row meets)."""
    pages = np.unique(tables[tables >= 0])
    k = codes_f32(pk[1][pages]).reshape(-1, d)
    return float(np.abs(q.reshape(-1, d) @ k.T).max()) * d ** -0.5


def codes_f32(u8):
    return f8.torch_e4(u8).float().numpy()


def options(rng, kind, n, bound):
    """(window, sinks) of a case: sinks N(0, 1) or just above every score
    (``bound``), a window of 6, or both."""
    window = 6 if kind.startswith("window") else None
    sinks = {"sinks": rand(rng, n),
             "sinks-above": np.full(n, bound + 0.5, np.float32),
             "window": None, "window-sinks": rand(rng, n)}[kind]
    return window, sinks


def ring_case(rng, b, r, mp, d, k_lo):
    """e4m3 ring pools (b slots x r pages, 4 pages of NaN codes, the trash
    page), the ring tables (column c of slot s -> s*r + c % r) and the
    same tables with every column that ends at or below row i's band start
    k_lo[i] on a NaN page."""
    pk, pv = pools(rng, b * r + 5, d)
    for p in (pk, pv):
        p[:, b * r:b * r + 4] = NAN
    ring = oss._ring(b, mp, r)
    dirty = ring.copy()
    for i, lo in enumerate(k_lo):
        below = (np.arange(mp) + 1) * PS <= lo
        dirty[i, below] = b * r + np.arange(below.sum()) % 4
    return pk, pv, ring, dirty


def _sinks_t(sinks):
    return None if sinks is None else t(sinks)


# ------------------------------------------------------------ kernel 4

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", [32, 64, 128])
def test_paged_decode_fp8kv_sinks_window_match_jax(d, kind):
    """4es, 4ews, 4ew: kv_len 0 (a zero row), 1, 6 and 7 (the window's
    edge), a page edge, a full table."""
    rng = np.random.default_rng(d + KINDS.index(kind))
    b, mp = 5, 6
    pk, pv = pools(rng, b * mp + 1, d)
    tables = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    lens = np.asarray([0, 1, 7, 16, 48], np.int32)
    q = rand(rng, b, N, d)
    window, sinks = options(rng, kind, N, top_score(q, pk, tables, d))
    (tk, tv), (jk, jv) = both(pk, pv)
    form = (tpd.paged_flash_decode_fp8kv_window if window
            else tpd.paged_flash_decode_fp8kv)
    got = (form(t(q), tk, tv, t(tables), t(lens), 1, window, sinks=_sinks_t(
        sinks)) if window else tpd.paged_flash_decode(
        t(q), tk, tv, t(tables), t(lens), 1, sinks=_sinks_t(sinks)))
    want = jpaged_decode(j(q), jk, jv, j(tables), j(lens), interpret=True,
                         layer=jnp.int32(1), window=window, sinks=j(sinks))
    close(got, want)
    assert not got[0].any()
    if kind == "sinks-above":
        # the sink takes most of each row's weight: the outputs shrink
        assert float(got.abs().max()) < 0.5 * float(
            tpd.paged_flash_decode(t(q), tk, tv, t(tables), t(lens),
                                   1).abs().max())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", [32, 64, 128])
def test_paged_verify_fp8kv_sinks_window_match_jax(d, kind):
    """4ves, 4vews, 4vew at a GQA group of 8 over 5 rows (40 rows: two row
    blocks): kv_len 0, 2 (the oldest rows before position 0), a band
    inside a page, a full table. A row with no key is zero in the port by
    design; the rows with keys are held to JAX's."""
    rng = np.random.default_rng(20 + d + KINDS.index(kind))
    b, mp = 4, 6
    pk, pv = pools(rng, b * mp + 1, d)
    tables = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    lens = np.asarray([0, 2, 19, 48], np.int32)
    q = rand(rng, b, VS, VN, d)
    assert tpd.row_blocks((VN // KVN) * VS) == 2
    window, sinks = options(rng, kind, VN, top_score(q, pk, tables, d))
    (tk, tv), (jk, jv) = both(pk, pv)
    got = (tpd.paged_flash_verify_fp8kv_window(
        t(q), tk, tv, t(tables), t(lens), 1, window, sinks=_sinks_t(sinks))
        if window else tpd.paged_flash_verify(
            t(q), tk, tv, t(tables), t(lens), 1, sinks=_sinks_t(sinks)))
    want = np.asarray(jpaged_verify(
        j(q), jk, jv, j(tables), j(lens), interpret=True, layer=jnp.int32(1),
        window=window, sinks=j(sinks)))
    for i, ln in enumerate(lens):
        live = [s for s in range(VS) if ln - VS + s >= 0]
        close(got[i, live], want[i, live])
        assert not got[i, [s for s in range(VS) if s not in live]].any()


@pytest.mark.parametrize("kind", ["window", "window-sinks"])
@pytest.mark.parametrize("window", [1, 6], ids=["w1", "w6"])
def test_paged_decode_verify_fp8kv_window_read_no_page_below_the_band(
        window, kind):
    """4ew/4ews and 4vew/4vews over ring tables whose columns below the
    band sit on pages of NaN codes: finite, equal to the clean tables'
    outputs and to JAX's kernel on them."""
    rng = np.random.default_rng(10 + window + KINDS.index(kind))
    b, r, mp, d = 3, 3, 12, 64
    lens = np.asarray([0, 29, 41], np.int32)
    pk, pv, ring, dirty = ring_case(rng, b, r, mp, d, lens - VS - window + 1)
    (tk, tv), (jk, jv) = both(pk, pv)
    for s, n in ((1, N), (VS, VN)):
        q = rand(rng, b, s, n, d)
        _w, sinks = options(rng, kind, n, 0.0)
        kw = dict(window=window, sinks=_sinks_t(sinks))
        fn, jfn = ((tpd.paged_flash_verify, jpaged_verify) if s > 1
                   else (tpd.paged_flash_decode, jpaged_decode))
        qq = q if s > 1 else q[:, 0]
        clean = fn(t(qq), tk, tv, t(ring), t(lens), 1, **kw)
        got = fn(t(qq), tk, tv, t(dirty), t(lens), 1, **kw)
        assert bool(torch.isfinite(got).all())
        close(got, clean, tol=0)
        want = np.asarray(jfn(j(qq), jk, jv, j(ring), j(lens),
                              interpret=True, layer=jnp.int32(1),
                              window=window, sinks=j(sinks)))
        live = lens > 0
        close(got.numpy()[live], want[live])


# ------------------------------------------------------------ kernel 8

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("d", [32, 64, 128])
def test_paged_prefill_fp8kv_sinks_window_match_jax(d, kind):
    """8es, 8ews, 8ew: two 16-row chunks at offsets 0 and 16 (the second
    row ragged), against JAX's kernel row by valid row."""
    rng = np.random.default_rng(40 + d + KINDS.index(kind))
    b, s, mp = 2, 16, 6
    pk, pv = pools(rng, b * mp + 1, d)
    tables = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    offs = np.asarray([0, 16], np.int32)
    kv = np.asarray([16, 27], np.int32)
    q = rand(rng, b, s, N, d)
    window, sinks = options(rng, kind, N, top_score(q, pk, tables, d))
    (tk, tv), (jk, jv) = both(pk, pv)
    got = (tpp.paged_flash_prefill_fp8kv_window(
        t(q), tk, tv, t(tables), t(kv), t(offs), 1, window,
        sinks=_sinks_t(sinks)) if window else tpp.paged_flash_prefill(
        t(q), tk, tv, t(tables), t(kv), t(offs), 1, sinks=_sinks_t(sinks)))
    want = np.asarray(jpaged_prefill(
        j(q), jk, jv, j(tables), j(kv), j(offs), bq=s, interpret=True,
        layer=jnp.int32(1), window=window, sinks=j(sinks)))
    for i in range(b):
        valid = int(kv[i] - offs[i])
        close(got[i, :valid], want[i, :valid])


@pytest.mark.parametrize("kind", ["window", "window-sinks"])
def test_paged_prefill_fp8kv_window_reads_no_page_below_the_band(kind):
    """8ew, 8ews over ring tables whose columns below the chunk's band sit
    on pages of NaN codes: finite, equal to the clean tables and to JAX's
    kernel on them."""
    rng = np.random.default_rng(60 + KINDS.index(kind))
    b, r, mp, d, s, window = 2, 4, 8, 32, 8, 5
    offs = np.asarray([24, 40], np.int32)
    kv = offs + s
    pk, pv, ring, dirty = ring_case(rng, b, r, mp, d, offs - window + 1)
    q = rand(rng, b, s, N, d)
    _w, sinks = options(rng, kind, N, 0.0)
    (tk, tv), (jk, jv) = both(pk, pv)
    kw = dict(window=window, sinks=_sinks_t(sinks))
    clean = tpp.paged_flash_prefill(t(q), tk, tv, t(ring), t(kv), t(offs), 1,
                                    **kw)
    got = tpp.paged_flash_prefill(t(q), tk, tv, t(dirty), t(kv), t(offs), 1,
                                  **kw)
    assert bool(torch.isfinite(got).all())
    close(got, clean, tol=0)
    want = jpaged_prefill(j(q), jk, jv, j(ring), j(kv), j(offs), bq=s,
                          interpret=True, layer=jnp.int32(1), window=window,
                          sinks=j(sinks))
    close(got, want)


def test_fp8kv_sink_and_window_forms_count_on_the_card_only():
    """On the CPU nothing launches: the e4m3 forms' counts (the window
    forms', and the sink launches by form name and head dim) move only on
    the card."""
    rng = np.random.default_rng(7)
    pk, pv = pools(rng, 9, 32)
    (tk, tv), _ = both(pk, pv)
    tables = np.arange(8, dtype=np.int32).reshape(2, 4)
    lens = np.asarray([5, 9], np.int32)
    forms = (tpd.paged_flash_decode_fp8kv_window,
             tpd.paged_flash_verify_fp8kv_window,
             tpp.paged_flash_prefill_fp8kv_window)
    before = (dict(tfp.SINK_LAUNCHES), [f.launches for f in forms])
    q = t(rand(rng, 2, 1, N, 32))
    tpd.paged_flash_decode(q[:, 0], tk, tv, t(tables), t(lens), 0, window=4,
                           sinks=torch.zeros(N))
    tpd.paged_flash_verify(q, tk, tv, t(tables), t(lens), 0, window=4,
                           sinks=torch.zeros(N))
    tpp.paged_flash_prefill(q, tk, tv, t(tables), t(lens), t(lens - 1), 0,
                            window=4, sinks=torch.zeros(N))
    assert before == (tfp.SINK_LAUNCHES, [f.launches for f in forms])


# --------------------------------------------- 6ek and the ring pools

@pytest.mark.parametrize("n,kvn", [(4, 2), (4, 4)], ids=["gqa", "mha"])
def test_fused_qkv_append_e4m3_kv_layer_matches_jax_kernel_bf16(n, kvn):
    """6ek: the weights of layer 1, the rows written at kv_layer 0, against
    JAX's kernel with the same kv_layer in interpret mode: q within 2e-2
    of its standard deviation, the written codes at most one e4m3 step
    apart, every other byte equal."""
    c = f8._qkv_case(20 + n + kvn, n, kvn, "bf16")
    sin, cos = jref.rope_tables(jnp.asarray(c["pos"]), c["d"], 10000.0)
    tp = [f8.torch_e4(p) for p in c["pools"]]
    q_t, *out = tqkv.fused_qkv_append(
        c["xt"], t(c["nw"]), t(c["wq"]), t(c["ws"]), t(np.array(sin)),
        t(np.array(cos)), tp[0], tp[1], c["li"], t(c["pos"]),
        n_heads=n, kv_heads=kvn, eps=1e-5, tables=t(c["tables"]),
        kv_layer=0)
    assert all(a is b for a, b in zip(out, tp))
    q_j, *want = jqkv.fused_qkv_append(
        c["xj"], jnp.asarray(c["nw"]), jnp.asarray(c["wq"]),
        jnp.asarray(c["ws"]), sin, cos, f8.jax_e4(c["pools"][0]),
        f8.jax_e4(c["pools"][1]), jnp.int32(c["li"]), jnp.asarray(c["pos"]),
        n_heads=n, kv_heads=kvn, eps=1e-5,
        tables=jnp.asarray(c["tables"]), kv_layer=jnp.int32(0),
        interpret=True)
    want_q = np.asarray(q_j, np.float32)
    np.testing.assert_allclose(q_t.float().numpy(), want_q, rtol=0,
                               atol=2e-2 * float(np.std(want_q)))
    w = np.roll(c["written"], -c["li"], axis=0)[..., None].repeat(c["d"],
                                                                  -1)
    assert w[0].any() and not w[1:].any()
    for g, jw in zip(tp, want):
        g, jw = codes(g), codes(jw)
        np.testing.assert_array_equal(g[~w], jw[~w])
        assert np.abs(f8._ordinal(g[w]) - f8._ordinal(jw[w])).max() <= 1


def test_fused_qkv_append_e4m3_kv_layer_matches_jax_unfused_f32():
    """6ek in f32 against JAX's unfused route (the norm, the product of
    layer 1, RoPE, the e4m3 write at pool layer 0): q within 1e-5, the
    pools byte-equal."""
    n, kvn = 4, 2
    c = f8._qkv_case(31, n, kvn, "f32")
    d, li = c["d"], c["li"]
    sin, cos = jref.rope_tables(jnp.asarray(c["pos"]), d, 10000.0)
    tp = [f8.torch_e4(p) for p in c["pools"]]
    q_t, *_ = tqkv.fused_qkv_append(
        c["xt"], t(c["nw"]), t(c["wq"]), t(c["ws"]), t(np.array(sin)),
        t(np.array(cos)), tp[0], tp[1], li, t(c["pos"]), n_heads=n,
        kv_heads=kvn, eps=1e-5, tables=t(c["tables"]), kv_layer=0)
    xn = jref.rmsnorm(c["xj"], jnp.asarray(c["nw"][li]), 1e-5)
    qkv = f8.jlinear(xn, f8.JaxQW(q=jnp.asarray(c["wq"]),
                                  scales=jnp.asarray(c["ws"])),
                     layer=jnp.int32(li))
    b = qkv.shape[0]
    q = jref.apply_rope(qkv[:, None, :n * d].reshape(b, 1, n, d),
                        sin[:, None], cos[:, None])[:, 0]
    k = jref.apply_rope(qkv[:, None, n * d:(n + kvn) * d].reshape(
        b, 1, kvn, d), sin[:, None], cos[:, None])[:, 0]
    v = qkv[:, (n + kvn) * d:].reshape(b, kvn, d)
    want = jpkv.write_decode_stacked(
        f8.jax_e4(c["pools"][0]), f8.jax_e4(c["pools"][1]), k, v,
        jnp.asarray(c["tables"]), jnp.asarray(c["pos"]), jnp.int32(0))
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q), rtol=TOL,
                               atol=TOL * float(np.abs(np.asarray(q)).max()))
    f8.assert_pools_equal(tp, want[:2])
    assert not np.array_equal(codes(tp[0])[0], c["pools"][0][0])


@pytest.mark.parametrize("layers,pages", [(2, 6), (1, 12)])
def test_with_windowed_e4m3_matches_jax(layers, pages):
    """The grouped engine's e4m3 ring pools: zeroed e4m3 pools of the
    cache's geometry and a trash page, no scale pools, byte-equal to JAX's
    ``with_windowed``; the main pools untouched."""
    tc = tpkv.PagedKVCache.create(3, 9, 2, 16, 64, E4, device="cpu")
    tc.k.view(torch.uint8).fill_(5)
    w = tc.with_windowed(layers, pages)
    jw = jpkv.PagedKVCache.create(3, 9, 2, 16, 64,
                                  jnp.float8_e4m3fn).with_windowed(layers,
                                                                   pages)
    for got, want in ((w.k_w, jw.k_w), (w.v_w, jw.v_w)):
        assert got.dtype == E4 and tuple(got.shape) == tuple(want.shape)
        assert got.shape == (layers, pages + 1, 2, 16, 64)
        np.testing.assert_array_equal(codes(got), codes(want))
    assert w.k_w_scale is None and jw.k_w_scale is None
    assert w.v_w_scale is None and jw.v_w_scale is None
    assert w.k is tc.k and bool((codes(w.k) == 5).all())


# ---------------------------------------- tiny gpt-oss over FP8 KV

def fp8_caches(cfg, tables, ring_pages):
    """Both packages' e4m3 caches: the grouped engine's main pools (full
    layers) and ring pools (sliding layers) of ``ring_pages`` pages a
    slot, with the (full, ring) table pair."""
    n_w = sum(w is not None for w in cfg.layer_windows)
    full = cfg.num_layers - n_w
    jc = oss.JaxCache.create(full, 20, cfg.num_kv_heads, PS, cfg.head_dim,
                             jnp.float8_e4m3fn)
    tc = oss.PagedKVCache.create(full, 20, cfg.num_kv_heads, PS,
                                 cfg.head_dim, E4, device="cpu")
    b = tables.shape[0]
    jc = jc.with_windowed(n_w, b * ring_pages)
    tc = tc.with_windowed(n_w, b * ring_pages)
    ring = oss._ring(b, tables.shape[1], ring_pages)
    assert tc.k_w.dtype == E4 and tc.k_w_scale is None
    return (jc, tc, (jnp.asarray(tables), jnp.asarray(ring)),
            (torch.from_numpy(tables), torch.from_numpy(ring)))


def _pools(c):
    """A cache's pool tensors: K and V, then the ring pools' K and V."""
    return [c.k, c.v] + ([] if c.k_w is None else [c.k_w, c.v_w])


def _pool_pairs(tc, jc):
    """Both caches' pools as codes, the trash page left out."""
    return [(codes(a)[:, :-1], codes(b)[:, :-1])
            for a, b in zip(_pools(tc), _pools(jc))]


def same_codes(tc, jc) -> bool:
    return all(np.array_equal(a, b) for a, b in _pool_pairs(tc, jc))


def assert_codes_close(tc, jc):
    """Every pool set, the trash page excluded: codes at most one e4m3
    step apart."""
    for a, b in _pool_pairs(tc, jc):
        assert a.shape == b.shape
        if a.size:
            assert np.abs(f8._ordinal(a) - f8._ordinal(b)).max() <= 1


def forward_step(model, jc, tc, jt, tt, toks, pos, lens, **kw):
    """One forward_paged call of each package from the same cache (the
    port's pools take JAX's codes first: a code a step apart moves its
    value by up to 1/8, so later calls would attend other values and their
    rows drift further, as free-running decode on the card does, see
    chip_smoke.py's card_vs_cpu): the rows written codes at most one e4m3
    step apart, logits within 1e-4 where they wrote the same codes and
    within 1e-2 where a code is a step apart; the same greedy tokens."""
    jcfg, jp, cfg, tp = model
    for a, b in zip(_pools(tc), _pools(jc)):
        a.view(torch.uint8).copy_(torch.from_numpy(codes(b).copy()))
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
    assert_codes_close(tc, jc)
    nxt = tl[:, -1].argmax(-1).numpy().astype(np.int32)
    np.testing.assert_array_equal(nxt, np.asarray(jl)[:, -1].argmax(-1))
    return jc, tc, nxt


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_gpt_oss_forward_paged_fp8kv_matches_jax(kind):
    """The tiny GPT-OSS over FP8 KV: two prompts of 21 and 30 tokens (past
    its window of 8) in 16-row chunks over the grouped engine's e4m3 ring
    pools (8es, 8ews), then 6 decode steps (4es, 4ews; the ring wraps)."""
    model = oss._drawn(kind)
    cfg = model[2]
    rng = np.random.default_rng(9)
    lens0 = np.asarray([21, 30], np.int32)
    prompt = rng.integers(1, cfg.vocab_size, (2, 32)).astype(np.int32)
    jc, tc, jt, tt = fp8_caches(cfg, oss.TABLES,
                                (oss.WINDOW + 16 - 2) // PS + 2)
    for off in (0, 16):
        lens = np.minimum(lens0, off + 16).astype(np.int32)
        toks = np.where(off + np.arange(16)[None] < lens[:, None],
                        prompt[:, off:off + 16], 0).astype(np.int32)
        pos = (off + np.arange(16, dtype=np.int32))[None].repeat(2, 0)
        jc, tc, nxt = forward_step(model, jc, tc, jt, tt, toks, pos, lens,
                                   chunk_offset=np.full(2, off, np.int32))
    lens = lens0.copy()
    for _ in range(6):
        jc, tc, nxt = forward_step(model, jc, tc, jt, tt, nxt[:, None],
                                   lens[:, None].copy(), lens + 1)
        lens = lens + 1


def engine_pair(model, **ecfg):
    """A JAX Engine and a port Engine over FP8 KV, one configuration (JAX
    warns that FP8 KV is slow on a TPU v5e; the port does not)."""
    jcfg, jp, cfg, tp = model
    kv = dict(page_size=PS, num_pages=96, max_pages_per_seq=16,
              kv_dtype="fp8")
    with pytest.warns(RuntimeWarning, match="v5e"):
        je = oss.JaxEngine(jcfg, jp, oss.JaxEngineConfig(
            max_batch_size=4, kv=oss.JaxKVConfig(**kv), **ecfg),
            decode_burst=3)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        te = Engine(cfg, tp, EngineConfig(
            max_batch_size=4, kv=KVCacheConfig(**kv), **ecfg),
            decode_burst=3, device="cpu")
    assert te._grouped and je._grouped
    assert te.cache.k_w.dtype == E4 and te.cache.k_w_scale is None
    return je, te


def run_both(je, te, waves, new):
    """Each wave added to both Engines, then run to the end."""
    jr, tr = [], []
    for wave in waves:
        jr += [je.add_request(prompt_ids=p, sampling=oss.JaxSampling(
            max_new_tokens=new)) for p in wave]
        tr += [te.add_request(prompt_ids=p, sampling=SamplingParams(
            max_new_tokens=new)) for p in wave]
        je.run()
        te.run()
    return jr, tr


def assert_engines_agree(cfg, je, te, jr, tr):
    """Greedy tokens exact, logprobs within 1e-2, the prefix and spec
    metrics equal; the model's first layer, written from the same
    embeddings in both packages, codes at most one e4m3 step apart (later
    layers take inputs that a parted code of an earlier one moved, so they
    are held by the logit rule, as chip_smoke.py's card_vs_cpu holds FP8
    KV)."""
    for a, b in zip(jr, tr):
        assert b.output_ids == a.output_ids, a.prompt_ids
        np.testing.assert_allclose(b.output_logprobs, a.output_logprobs,
                                   rtol=LOGIT_TOL_CODE_APART,
                                   atol=LOGIT_TOL_CODE_APART)
    for name in ("prefix_cache_hits", "prompt_tokens_cached", "prefills",
                 "prompt_tokens", "tokens_generated", "spec_steps",
                 "spec_accepted"):
        assert getattr(te.metrics, name) == getattr(je.metrics, name), name
    ring = te._grouped and cfg.layer_windows[0] is not None
    for a, b in _pool_pairs(te.cache, je.cache)[2 * ring:2 * ring + 2]:
        assert a.shape == b.shape
        assert np.abs(f8._ordinal(a[0]) - f8._ordinal(b[0])).max() <= 1


@pytest.mark.parametrize("kind,ecfg", [
    ("int8", dict(prefill_chunk=16)), ("f32", dict(spec_tokens=2))],
    ids=["int8-prefix-chunked", "f32-spec"])
def test_gpt_oss_engine_fp8kv_matches_jax(kind, ecfg):
    """The tiny GPT-OSS over FP8 KV in the grouped Engine: INT8 weights
    with the prefix cache on and 16-row chunks (8es, 8ews, 4es, 4ews), or
    f32 weights in the spec Engine (spec_tokens 2: 4ves, 4vews on the
    verify rows, 11e): greedy tokens exact, logprobs within 1e-2, codes
    at most one step apart, the speculative metrics equal."""
    spec = "spec_tokens" in ecfg
    prompts = ([[5, 6, 7, 8] * 5, list(range(30, 51)), [9, 8, 7] * 3]
               if spec else oss.PROMPTS)
    model = oss._drawn(kind)
    je, te = engine_pair(model, **ecfg)
    jr, tr = run_both(je, te, [prompts], 12)
    assert_engines_agree(model[2], je, te, jr, tr)
    assert len({tok for r in tr for tok in r.output_ids}) > 2
    assert (te.metrics.spec_accepted > 0) == spec


_MISTRAL: dict = {}


def _mistral_style():
    """``tiny_test`` with a sliding window of 8 (Mistral's: every layer
    slides), INT8 weights per output channel and an INT8 LM head."""
    if not _MISTRAL:
        jcfg = JaxModelConfig.tiny_test(sliding_window=8)
        jp = oss.jllama.init_params(jcfg, jax.random.PRNGKey(5))
        jp = jquantize_params(jp, JaxQuantConfig(mode="int8", group_size=0,
                                                 quantize_lm_head=True))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        _MISTRAL["m"] = (jcfg, jp, ModelConfig.tiny_test(sliding_window=8),
                         tp)
    return _MISTRAL["m"]


@pytest.mark.parametrize("ecfg", [dict(prefill_chunk=16),
                                  dict(prefix_cache_entries=0)],
                         ids=["chunked", "whole"])
def test_mistral_style_engine_int8_fp8kv_matches_jax(monkeypatch, ecfg):
    """A Mistral-style model (every layer sliding, window 8) with INT8
    weights over FP8 KV in the grouped Engine: its decode takes the fused
    qkv with a kv_layer over the e4m3 ring pools (6ek's plain version,
    checked by its calls), prefill 2e into the ring, 8ew or 3w, 4ew;
    tokens exact, logprobs within 1e-2, codes at most one step apart."""
    calls = []
    ref = tqkv.fused_qkv_append_ref
    sig = inspect.signature(ref)

    def spy(*a, **kw):
        arg = sig.bind(*a, **kw).arguments
        calls.append((arg["pool_k"].dtype, arg.get("kv_layer")))
        return ref(*a, **kw)
    monkeypatch.setattr(tqkv, "fused_qkv_append_ref", spy)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, 250, n).tolist() for n in (21, 9, 30)]
    model = _mistral_style()
    je, te = engine_pair(model, **ecfg)
    assert te.cache.k.shape[0] == 0                 # every layer slides
    jr, tr = run_both(je, te, [prompts[:1], prompts[1:]], 10)
    assert_engines_agree(model[2], je, te, jr, tr)
    assert calls and all(dt == E4 and kl is not None for dt, kl in calls)
    assert {kl for _dt, kl in calls} == {0, 1}
