"""INT8 KV at head_dim 256 (Gemma-1 and Gemma-2 over INT8 KV) in the port
against the JAX package on the CPU: the forms 4q, 4qw, 4qc, 4qwc, 4vq,
4vqw, 4vqc, 4vqwc, 8q, 8qw, 8qc, 8qwc, 6q (with and without a kv_layer),
9 and 10 at D 256, and the tiny Gemma of tests/test_torch_gemma.py (D
256, one kv head) over INT8 KV through the Engine with the prefix cache
(the grouped engine and the spec Engine over INT8 KV, with Gemma-2 at D
256 and gpt-oss: tests/test_torch_int8kv_models.py).

The port's wrappers run their plain versions on CPU tensors; the JAX
kernels run in interpret mode (the attention, the quantizing fused qkv),
its quantizing writes through their scatter route, as the JAX package's
own tests run them, on the same numpy inputs (seeded). Stated tolerances:
- attention over INT8 pools (f32): 1e-5 of the outputs' largest
  magnitude, with int8 codes over the whole range and scales of 0.01-0.1,
  scores past the cap, windows over ring tables whose columns below the
  band sit on pages with NaN scales (which no form may read), kv_len 0;
- 9 and 10 at D 256: codes and scales byte-equal (every page but the
  trash page);
- the quantizing fused qkv at D 256: codes at most 1 apart and scales
  within 1e-5 relative (f32) or one bf16 ulp of the absmax (bf16), as in
  tests/test_torch_int8kv.py; q as there;
- the Engines: greedy tokens exact, logprobs within 1e-3, since their
  pools' codes may part by one (the rule of
  tests/test_torch_int8kv_engine.py: 1e-4 while the codes agree, 1e-3
  once a code is one apart), the prefix metrics equal.
The kernels' own D-256 column map for 6q (two 64-column runs of one head
a block, both halves left in a scratch for a further launch that
quantizes whole heads) is emulated in numpy and shown to hand every k/v
column of every row over once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_gemma as gem
import test_torch_gpt_oss as oss
import test_torch_int8kv_sinks_cap as sc
from simplellminference_tpu.core.config import EngineConfig as JaxEngineConfig
from simplellminference_tpu.core.config import KVCacheConfig as JaxKVConfig
from simplellminference_tpu.core.config import SamplingParams as JaxSampling
from simplellminference_tpu.engine import Engine as JaxEngine
from simplellminference_tpu.memory import paged_kv as jpkv
from simplellminference_tpu.ops import qkv_fused as jqkv
from simplellminference_tpu.ops import ref_ops as jref
from simplellminference_tpu.ops.linear import QuantizedWeight as JaxQW
from simplellminference_tpu.ops.linear import linear as jlinear
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
from simplellminference_tpu_torch.ops.attention import paged_decode as tpd
from simplellminference_tpu_torch.ops.attention import paged_prefill as tpp

D = 256
N, KVN, PS = 8, 2, 8
CAP = 2.0
LOGIT_TOL, LOGIT_TOL_CODE_APART = 1e-4, 1e-3
t, j, rand, close = sc.t, sc.j, sc.rand, sc.close


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread (see
    tests/test_torch_int8kv_sinks_cap.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------- attention at D 256

@pytest.mark.parametrize("window", [None, 6], ids=["4q", "4qw"])
@pytest.mark.parametrize("cap", [None, CAP], ids=["plain", "capped"])
def test_paged_decode_int8kv_d256_matches_jax(cap, window):
    """4q/256, 4qw/256, 4qc/256, 4qwc/256: kv_len 0, 1, a page edge, a
    full table; the capped scores several times past the cap."""
    rng = np.random.default_rng(1 + bool(cap) + (window or 0))
    b, mp = 4, 6
    pk, pv, ks, vs = sc.quant_pools(rng, b * mp + 1, D)
    tables = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    lens = np.asarray([0, 1, 16, 48], np.int32)
    q = rand(rng, b, N, D)
    assert sc.top_score(q, pk, ks, tables, D) > 3 * CAP
    got = tpd.paged_flash_decode(t(q), t(pk), t(pv), t(tables), t(lens), 1,
                                 k_scale=t(ks), v_scale=t(vs), window=window,
                                 logit_cap=cap)
    want = jpaged_decode(j(q), j(pk), j(pv), j(tables), j(lens),
                         interpret=True, layer=jnp.int32(1), k_scale=j(ks),
                         v_scale=j(vs), window=window, logit_cap=cap)
    close(got, want)
    assert not got[0].any()


@pytest.mark.parametrize("cap", [None, CAP], ids=["4qw", "4qwc"])
def test_paged_decode_int8kv_d256_window_reads_no_page_below_the_band(cap):
    rng = np.random.default_rng(5 + bool(cap))
    b, r, mp, window = 2, 3, 12, 6
    lens = np.asarray([29, 41], np.int32)
    pk, pv, ks, vs, ring, dirty = sc.ring_case(rng, b, r, mp, D,
                                               lens - window)
    q = rand(rng, b, N, D)
    kw = dict(k_scale=t(ks), v_scale=t(vs), window=window, logit_cap=cap)
    clean = tpd.paged_flash_decode(t(q), t(pk), t(pv), t(ring), t(lens), 1,
                                   **kw)
    got = tpd.paged_flash_decode(t(q), t(pk), t(pv), t(dirty), t(lens), 1,
                                 **kw)
    assert bool(torch.isfinite(got).all())
    close(got, clean, tol=0)


@pytest.mark.parametrize("window", [None, 6], ids=["4vq", "4vqw"])
@pytest.mark.parametrize("n,cap", [(16, None), (4, CAP)],
                         ids=["gemma-group8", "gemma2-group2-capped"])
def test_paged_verify_int8kv_d256_matches_jax(n, cap, window):
    """4vq/256, 4vqw/256 at Gemma-1's group of 8 over 5 rows (two row
    blocks) and 4vqc/256, 4vqwc/256 at Gemma-2's group of 2: the rows with
    keys against JAX's, the rows without zero."""
    rng = np.random.default_rng(10 + n + (window or 0))
    b, mp, s = 4, 6, 5
    pk, pv, ks, vs = sc.quant_pools(rng, b * mp + 1, D)
    tables = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    lens = np.asarray([0, 2, 19, 48], np.int32)
    q = rand(rng, b, s, n, D)
    got = tpd.paged_flash_verify(t(q), t(pk), t(pv), t(tables), t(lens), 1,
                                 k_scale=t(ks), v_scale=t(vs), window=window,
                                 logit_cap=cap)
    want = np.asarray(jpaged_verify(
        j(q), j(pk), j(pv), j(tables), j(lens), interpret=True,
        layer=jnp.int32(1), k_scale=j(ks), v_scale=j(vs), window=window,
        logit_cap=cap))
    for i, ln in enumerate(lens):
        live = [r for r in range(s) if ln - s + r >= 0]
        close(got[i, live], want[i, live])
        assert not got[i, [r for r in range(s) if r not in live]].any()


@pytest.mark.parametrize("window", [None, 5], ids=["8q", "8qw"])
@pytest.mark.parametrize("cap", [None, CAP], ids=["plain", "capped"])
def test_paged_prefill_int8kv_d256_matches_jax(cap, window):
    """8q/256, 8qw/256, 8qc/256, 8qwc/256: two 16-row chunks at offsets 0
    and 16, the second ragged."""
    rng = np.random.default_rng(20 + bool(cap) + (window or 0))
    b, s, mp = 2, 16, 6
    pk, pv, ks, vs = sc.quant_pools(rng, b * mp + 1, D)
    tables = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    offs = np.asarray([0, 16], np.int32)
    kv = np.asarray([16, 27], np.int32)
    q = rand(rng, b, s, N, D)
    got = tpp.paged_flash_prefill(t(q), t(pk), t(pv), t(tables), t(kv),
                                  t(offs), 1, window=window, logit_cap=cap,
                                  k_scale=t(ks), v_scale=t(vs))
    want = np.asarray(jpaged_prefill(
        j(q), j(pk), j(pv), j(tables), j(kv), j(offs), bq=s, interpret=True,
        layer=jnp.int32(1), k_scale=j(ks), v_scale=j(vs), window=window,
        logit_cap=cap))
    for i in range(b):
        valid = int(kv[i] - offs[i])
        close(got[i, :valid], want[i, :valid])


# ------------------------------------------------- 9 and 10 at D 256

TABLES = np.array([[3, 7, 1, 4], [0, 11, -1, -1], [-1, -1, -1, -1]],
                  np.int32)


def _pools12(rng):
    return sc.quant_pools(rng, 13, D)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_write_decode_quant_d256_matches_jax(dtype):
    rng = np.random.default_rng(30)
    pools = _pools12(rng)
    x = [rand(rng, 3, KVN, D) * 3 for _ in range(2)]
    tk, tv = (t(a).bfloat16() if dtype == "bf16" else t(a) for a in x)
    jk, jv = (jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16 if dtype == "bf16" else jnp.float32) for a in (tk, tv))
    positions = np.array([17, 9, 4], np.int32)    # page 1 slot 1; 11; dead
    want = jpkv.write_decode_stacked(
        *(jnp.asarray(p) for p in pools[:2]), jk, jv, jnp.asarray(TABLES),
        jnp.asarray(positions), jnp.int32(1),
        *(jnp.asarray(p) for p in pools[2:]))
    tp = [t(p.copy()) for p in pools]
    tpkv.write_decode_stacked(tp[0], tp[1], tk, tv, t(TABLES), t(positions),
                              1, pool_ks=tp[2], pool_vs=tp[3])
    for g, w in zip(tp, want):
        np.testing.assert_array_equal(g.numpy()[:, :-1], np.asarray(w)[:, :-1])


@pytest.mark.parametrize("s", [16, 13, 1], ids=["full", "ragged", "one"])
def test_write_prefill_quant_d256_matches_jax(s):
    rng = np.random.default_rng(31 + s)
    pools = _pools12(rng)
    tk, tv = (t(rand(rng, 3, s, KVN, D) * 3) for _ in range(2))
    want = jpkv.write_prefill_stacked(
        *(jnp.asarray(p) for p in pools[:2]), jnp.asarray(tk.numpy()),
        jnp.asarray(tv.numpy()), jnp.asarray(TABLES), jnp.int32(1),
        *(jnp.asarray(p) for p in pools[2:]))
    tp = [t(p.copy()) for p in pools]
    tpkv.write_prefill_stacked(tp[0], tp[1], tk, tv, t(TABLES), 1,
                               pool_ks=tp[2], pool_vs=tp[3])
    for g, w in zip(tp, want):
        np.testing.assert_array_equal(g.numpy()[:, :-1], np.asarray(w)[:, :-1])


# -------------------------------------- the quantizing fused qkv at D 256

def _qkv_case(seed, n, kvn, dtype, kv_layer):
    """Gemma's fused qkv shapes, small: n q heads over kvn kv heads of
    256, three rows (row 2's page unmapped: the trash page), the weights
    of layer 1, the pools at ``kv_layer`` (or 1)."""
    rng = np.random.default_rng(seed)
    lyr, h, ps, mp, b, li = 2, 128, 16, 3, 3, 1
    nq = (n + 2 * kvn) * D
    p1 = b * mp + 1
    wq = rng.integers(-127, 128, (lyr, h, nq)).astype(np.int8)
    ws = (rng.uniform(0.5, 2.0, (lyr, 1, nq)) * 1e-2).astype(np.float32)
    nw = (rng.standard_normal((lyr, h)) * 0.1 + 1.0).astype(np.float32)
    x = rand(rng, b, h)
    if dtype == "bf16":
        xt = t(x).bfloat16()
        xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    else:
        xt, xj = t(x), jnp.asarray(x)
    pos = np.asarray([5, 20, 40], np.int32)
    tables = np.asarray([[3, 7, 1], [0, 5, 8], [2, 4, -1]], np.int32)
    pools = sc.quant_pools(rng, p1, D, kvn=kvn, ps=ps)
    kli = li if kv_layer is None else kv_layer
    written = np.zeros((lyr, p1, kvn, ps), bool)
    for r in range(b):
        page = tables[r, pos[r] // ps]
        written[kli, page if page >= 0 else p1 - 1, :, pos[r] % ps] = True
    return dict(wq=wq, ws=ws, nw=nw, xt=xt, xj=xj, pos=pos, tables=tables,
                pools=pools, written=written, n=n, kvn=kvn, li=li,
                kv_layer=kv_layer)


def _check_quant_rows(c, got, want, scale_tol):
    """Codes at most 1 apart and scales within ``scale_tol`` on the
    written rows; every other entry unchanged and equal."""
    w = c["written"]
    for g, jj in zip(got, want):
        g, jj = np.asarray(g), np.asarray(jj)
        mask = w if g.ndim == 4 else w[..., None].repeat(g.shape[-1], -1)
        np.testing.assert_array_equal(g[~mask], jj[~mask])
        if g.dtype == np.int8:
            assert np.abs(g[mask].astype(int) - jj[mask]).max() <= 1
        else:
            assert (np.abs(g[mask] - jj[mask]) <= scale_tol(jj[mask])).all()
    assert w[:, -1].any()                    # the trash page took row 2


def _jax_unfused(c, sin, cos):
    """JAX's unfused f32 route of the same step: rmsnorm, the INT8
    product, RoPE, the quantizing decode write (at the kv_layer)."""
    n, kvn, li = c["n"], c["kvn"], c["li"]
    xn = jref.rmsnorm(c["xj"], jnp.asarray(c["nw"][li]), 1e-5)
    qkv = jlinear(xn, JaxQW(q=jnp.asarray(c["wq"]), scales=jnp.asarray(
        c["ws"])), layer=jnp.int32(li))
    b = qkv.shape[0]

    def rope(x, heads):
        return jref.apply_rope(x.reshape(b, 1, heads, D), sin[:, None],
                               cos[:, None])[:, 0]

    q = rope(qkv[:, :n * D], n)
    k = rope(qkv[:, n * D:(n + kvn) * D], kvn)
    v = qkv[:, (n + kvn) * D:].reshape(b, kvn, D)
    kli = li if c["kv_layer"] is None else c["kv_layer"]
    want = jpkv.write_decode_stacked(
        *(jnp.asarray(p) for p in c["pools"][:2]), k, v,
        jnp.asarray(c["tables"]), jnp.asarray(c["pos"]), jnp.int32(kli),
        *(jnp.asarray(p) for p in c["pools"][2:]))
    return q, want


@pytest.mark.parametrize("kv_layer", [None, 0], ids=["6q", "6q-kv_layer"])
@pytest.mark.parametrize("n,kvn", [(4, 1), (4, 2)], ids=["gemma", "gemma2"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_qkv_append_int8kv_d256_matches_jax_kernel(dtype, n, kvn,
                                                         kv_layer):
    c = _qkv_case(40 + n + kvn + (kv_layer or 0), n, kvn, dtype, kv_layer)
    sin, cos = jref.rope_tables(jnp.asarray(c["pos"]), D, 10000.0)
    tp = [t(p.copy()) for p in c["pools"]]
    q_t, *out = tqkv.fused_qkv_append(
        c["xt"], t(c["nw"]), t(c["wq"]), t(c["ws"]), t(np.array(sin)),
        t(np.array(cos)), tp[0], tp[1], c["li"], t(c["pos"]), n_heads=n,
        kv_heads=kvn, eps=1e-5, tables=t(c["tables"]), cache_ks=tp[2],
        cache_vs=tp[3], kv_layer=kv_layer)
    assert all(a is b for a, b in zip(out, tp))
    if dtype == "f32":
        # JAX's kernel rounds the normalized rows to bf16 whatever the
        # activation dtype: f32 is held to its unfused CPU path
        q_j, want = _jax_unfused(c, sin, cos)
        want_q = np.asarray(q_j)
        np.testing.assert_allclose(q_t.numpy(), want_q, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want_q).max()))
        _check_quant_rows(c, tp, want, lambda s: 1e-5 * s)
        return
    q_j, *want = jqkv.fused_qkv_append(
        c["xj"], jnp.asarray(c["nw"]), jnp.asarray(c["wq"]),
        jnp.asarray(c["ws"]), sin, cos,
        *(jnp.asarray(p) for p in c["pools"][:2]), jnp.int32(c["li"]),
        jnp.asarray(c["pos"]), n_heads=n, kv_heads=kvn, eps=1e-5,
        tables=jnp.asarray(c["tables"]), cache_ks=jnp.asarray(c["pools"][2]),
        cache_vs=jnp.asarray(c["pools"][3]),
        kv_layer=None if kv_layer is None else jnp.int32(kv_layer),
        interpret=True)
    want_q = np.asarray(q_j, np.float32)
    np.testing.assert_allclose(q_t.float().numpy(), want_q, rtol=0,
                               atol=2e-2 * float(np.std(want_q)))

    def one_bf16_ulp_of_absmax(s):
        ulp = np.exp2(np.floor(np.log2(s * 127.0)) - 7)
        return ulp / 127.0 * (1 + 1e-6)

    _check_quant_rows(c, tp, want, one_bf16_ulp_of_absmax)


@pytest.mark.parametrize("n,kvn,b", [(8, 1, 3), (8, 4, 8), (16, 8, 64)])
def test_int8kv_d256_blocks_hand_every_kv_column_over_once(n, kvn, b):
    """Kernels 6 and 6m at D 256 over INT8 KV (csrc/qkv_fused*.cu): block
    x's tail writes each of its pairs (t1, t1 + 64) of qkv columns g1 =
    block_col(x, t1) and g1 + 128 (head g1 / 256, columns j and j + 128)
    into kv_rows[row, head - n, :] for a k or v head; the further launch
    then quantizes kv_rows[row, h] whole. Every (row, k/v head, column)
    is written exactly once, and no q column lands there."""
    nq = (n + 2 * kvn) * D
    seen = np.zeros((b, 2 * kvn, D), int)
    for x in range(nq // 128):
        for row in range(b):
            for p in range(64):
                t1 = p                              # pair_col at D 256
                g1 = gem._block_col(x, t1, D)
                head, jj = g1 // D, g1 % D
                assert gem._block_col(x, t1 + 64, D) == g1 + D // 2
                if head < n:
                    continue
                seen[row, head - n, jj] += 1
                seen[row, head - n, jj + D // 2] += 1
    assert (seen == 1).all()


# ---------------------------------------------------- the models

def _kv(**kw):
    return dict(page_size=PS, num_pages=96, max_pages_per_seq=16,
                kv_dtype="int8", **kw)


def _engine_pair(model, kv, **ecfg):
    jcfg, jp, cfg, tp = model
    je = JaxEngine(jcfg, jp, JaxEngineConfig(
        max_batch_size=4, kv=JaxKVConfig(**kv), **ecfg), decode_burst=4)
    te = Engine(cfg, tp, EngineConfig(max_batch_size=4,
                                      kv=KVCacheConfig(**kv), **ecfg),
                decode_burst=4, device="cpu")
    assert te.cache.k.dtype == torch.int8 and te._grouped == je._grouped
    return je, te


def _run_both(je, te, waves, n):
    """Each wave added to both engines after the last one ran out;
    returns the (JAX, port) request lists."""
    outs = ([], [])
    for wave in waves:
        for eng, samp, out in ((je, JaxSampling, outs[0]),
                               (te, SamplingParams, outs[1])):
            out += [eng.add_request(prompt_ids=p,
                                    sampling=samp(max_new_tokens=n))
                    for p in wave]
            eng.run()
    return outs


def assert_engines_agree(je, te, jr, tr):
    """Greedy tokens exact, logprobs within LOGIT_TOL_CODE_APART (the
    pools' codes may part by one), the prefix metrics equal."""
    for a, b in zip(jr, tr):
        assert b.output_ids == a.output_ids, a.prompt_ids
        np.testing.assert_allclose(b.output_logprobs, a.output_logprobs,
                                   rtol=LOGIT_TOL_CODE_APART,
                                   atol=LOGIT_TOL_CODE_APART)
    for name in ("prefix_cache_hits", "prompt_tokens_cached",
                 "prefix_cache_persistent_hits", "prefills"):
        assert getattr(te.metrics, name) == getattr(je.metrics, name), name
    assert len({tok for r in tr for tok in r.output_ids}) > 2


_GEMMA: dict = {}


def _gemma(kind):
    if kind not in _GEMMA:
        _GEMMA[kind] = gem._gemma(kind == "int8")
    return _GEMMA[kind]


def test_gemma_engine_int8kv_prefix_cache_matches_jax():
    """Gemma-1 (D 256, one kv head; INT8 weights) over INT8 KV with the
    prefix cache and 16-row chunks: a prompt, then (after it finished)
    two sharing its system prompt: 6q/256, 4q/256, 8q/256, 10/256 on the
    card."""
    je, te = _engine_pair(_gemma("int8"), _kv(), prefill_chunk=16)
    waves = [[oss.SYSTEM + [7, 7, 7]],
             [oss.SYSTEM + [101, 4, 9], list(range(30, 49))]]
    jr, tr = _run_both(je, te, waves, 8)
    assert_engines_agree(je, te, jr, tr)
    assert te.metrics.prefix_cache_hits > 0
