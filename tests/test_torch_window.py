"""Sliding-window attention forms of the port's kernels against the JAX
package on the CPU.

The port's wrappers run their plain versions on CPU tensors; the JAX
kernels run in interpret mode (flash_prefill 3w, paged_flash_decode 4w
and its INT8-KV form 4qw, paged_flash_verify 4vw/4vqw, paged_flash_prefill
8w/8qw), as tests/test_sliding_window.py runs them, on the same numpy
inputs at windows 1, 4, 6 and 16 with kv_lens on both sides of them; the
kv_layer form of fused_qkv_append (6k) against the JAX kernel in
interpret mode; and the grouped Engine over INT8 weights, whose decode
takes 6k at kv_layer != layer, against the JAX grouped Engine. Float32;
stated tolerance 1e-5 on the outputs (summation order), exact for pool
entries no write touches and for greedy tokens. 6k runs on bf16
activations, where the TPU kernel's rounding points and the port's agree
(tests/test_torch_fused.py): q and the written rows within 2e-2 of their
standard deviation, INT8 codes at most one step apart.

The ring aliasing trap: over the grouped engine's ring pools, a table
column below a row's window band maps to the live page of a newer
position. The window forms read no page wholly below the oldest row's
band: filling such pages with NaN leaves every output finite and equal.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.core.config import EngineConfig as JaxEngineConfig
from simplellminference_tpu.core.config import KVCacheConfig as JaxKVConfig
from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.core.config import QuantConfig as JaxQuantConfig
from simplellminference_tpu.core.config import SamplingParams as JaxSampling
from simplellminference_tpu.engine import Engine as JaxEngine
from simplellminference_tpu.models import llama as jllama
from simplellminference_tpu.ops import qkv_fused as jqkv
from simplellminference_tpu.ops import ref_ops as jref
from simplellminference_tpu.ops.attention import dispatch as jdispatch
from simplellminference_tpu.ops.attention.flash_prefill import (
    flash_prefill as jflash_prefill)
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
from simplellminference_tpu_torch.models.convert import params_from_jax
from simplellminference_tpu_torch.ops import qkv_fused as tqkv
from simplellminference_tpu_torch.ops.attention import dispatch
from simplellminference_tpu_torch.ops.attention import flash_prefill as tfp
from simplellminference_tpu_torch.ops.attention import paged_decode as tpd
from simplellminference_tpu_torch.ops.attention import paged_prefill as tpp

TOL = 1e-5
REL = 2e-2
WINDOWS = (1, 4, 6, 16)
L, KVN, N, D, PS = 2, 2, 4, 32, 8


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pools(rng, pages, quant):
    shape = (L, pages, KVN, PS, D)
    if not quant:
        return rand(rng, *shape), rand(rng, *shape), None, None
    return (rng.integers(-127, 128, shape).astype(np.int8),
            rng.integers(-127, 128, shape).astype(np.int8),
            rng.uniform(0.01, 0.1, shape[:-1]).astype(np.float32),
            rng.uniform(0.01, 0.1, shape[:-1]).astype(np.float32))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _tt(a):
    return None if a is None else t(a)


@pytest.mark.parametrize("window", WINDOWS)
def test_flash_prefill_window_matches_jax_kernel(window):
    rng = np.random.default_rng(window)
    b, s = 2, 64
    q, k, v = rand(rng, b, s, N, D), rand(rng, b, s, KVN, D), rand(
        rng, b, s, KVN, D)
    got = tfp.flash_prefill(t(q), t(k), t(v), window=window)
    want = jflash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, bq=32, bk=32, interpret=True,
                          window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # the dispatcher takes the window from the config, or per layer
    cfg = ModelConfig.tiny_test(sliding_window=window)
    torch.testing.assert_close(dispatch.attention(cfg, t(q), t(k), t(v)),
                               got, rtol=0, atol=0)
    full = dispatch.attention(cfg, t(q), t(k), t(v), window=None)
    torch.testing.assert_close(full, tfp.flash_prefill(t(q), t(k), t(v)),
                               rtol=0, atol=0)


def _decode_case(rng, b, mp, lens, quant):
    p = b * mp + 1
    pk, pv, ks, vs = _pools(rng, p, quant)
    tables = rng.permutation(p - 1)[:b * mp].astype(np.int32).reshape(b, mp)
    return pk, pv, ks, vs, tables, np.asarray(lens, np.int32)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8kv"])
@pytest.mark.parametrize("window", WINDOWS)
def test_paged_flash_decode_window_matches_jax_kernel(window, quant):
    rng = np.random.default_rng(10 + window)
    b, mp = 4, 6
    # kv_lens on both sides of every window, a page-straddling band
    pk, pv, ks, vs, tables, lens = _decode_case(rng, b, mp, [1, 5, 19, 47],
                                                quant)
    q = rand(rng, b, N, D)
    got = tpd.paged_flash_decode(t(q), t(pk), t(pv), t(tables), t(lens), 1,
                                 k_scale=_tt(ks), v_scale=_tt(vs),
                                 window=window)
    want = jpaged_decode(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                         jnp.asarray(tables), jnp.asarray(lens),
                         interpret=True, layer=jnp.int32(1), k_scale=_j(ks),
                         v_scale=_j(vs), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # the dispatcher with the config's window, against JAX's
    cfg = ModelConfig.tiny_test(sliding_window=window)
    jcfg = JaxModelConfig.tiny_test(sliding_window=window)
    via = dispatch.attention_paged(cfg, t(q)[:, None], t(pk), t(pv),
                                   t(tables), t(lens), 1, pool_ks=_tt(ks),
                                   pool_vs=_tt(vs))
    jvia = jdispatch.attention_paged(
        jcfg, jnp.asarray(q)[:, None], jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(lens), _j(ks), _j(vs),
        layer=jnp.int32(1))
    np.testing.assert_allclose(via.numpy(), np.asarray(jvia), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8kv"])
@pytest.mark.parametrize("window", WINDOWS)
def test_paged_flash_verify_window_matches_jax_kernel(window, quant):
    rng = np.random.default_rng(20 + window)
    b, mp, s = 3, 6, 3
    pk, pv, ks, vs, tables, lens = _decode_case(rng, b, mp, [3, 14, 40],
                                                quant)
    q = rand(rng, b, s, N, D)
    got = tpd.paged_flash_verify(t(q), t(pk), t(pv), t(tables), t(lens), 0,
                                 k_scale=_tt(ks), v_scale=_tt(vs),
                                 window=window)
    want = jpaged_verify(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                         jnp.asarray(tables), jnp.asarray(lens),
                         interpret=True, layer=jnp.int32(0), k_scale=_j(ks),
                         v_scale=_j(vs), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8kv"])
@pytest.mark.parametrize("window", WINDOWS)
def test_paged_flash_prefill_window_matches_jax_kernel(window, quant):
    rng = np.random.default_rng(30 + window)
    b, s, mp = 2, 32, 8
    pk, pv, ks, vs, tables, _ = _decode_case(rng, b, mp, [0, 0], quant)
    offs = np.asarray([8, 24], np.int32)
    lens = np.asarray([8 + 32, 24 + 19], np.int32)
    q = rand(rng, b, s, N, D)
    got = tpp.paged_flash_prefill(t(q), t(pk), t(pv), t(tables), t(lens),
                                  t(offs), 1, window=window, k_scale=_tt(ks),
                                  v_scale=_tt(vs))
    want = jpaged_prefill(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                          jnp.asarray(tables), jnp.asarray(lens),
                          jnp.asarray(offs), bq=32, interpret=True,
                          layer=jnp.int32(1), k_scale=_j(ks), v_scale=_j(vs),
                          window=window)
    assert torch.isfinite(got).all()
    for i in range(b):
        valid = int(lens[i] - offs[i])
        np.testing.assert_allclose(got.numpy()[i, :valid],
                                   np.asarray(want)[i, :valid], rtol=TOL,
                                   atol=TOL)


def _ring(b, mp, r):
    """The grouped engine's ring tables: column j of slot s -> s*R + j%R."""
    return (np.arange(b)[:, None] * r + np.arange(mp)[None] % r).astype(
        np.int32)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8kv"])
def test_window_forms_read_no_page_below_the_band(quant):
    """Columns wholly below the oldest row's band point at NaN pages: the
    outputs stay finite and equal those over the clean ring tables."""
    rng = np.random.default_rng(40)
    b, mp, r, window = 2, 12, 4, 13
    p = b * r + 4 + 1                   # ring pages, 4 poison pages, trash
    pk, pv, ks, vs = _pools(rng, p, quant)
    poison = np.arange(b * r, b * r + 4)
    if quant:
        ks[:, poison] = np.nan
        vs[:, poison] = np.nan
    else:
        pk[:, poison] = np.nan
        pv[:, poison] = np.nan
    ring = _ring(b, mp, r)
    lens = np.asarray([51, 60], np.int32)

    def poisoned(k_lo):
        tb = ring.copy()
        for i in range(b):
            below = (np.arange(mp) + 1) * PS <= k_lo[i]
            tb[i, below] = poison[np.arange(below.sum()) % 4]
        return tb

    kw = dict(k_scale=_tt(ks), v_scale=_tt(vs), window=window)
    q1 = t(rand(rng, b, N, D))
    qs = t(rand(rng, b, 3, N, D))
    cases = [
        (lambda tb: tpd.paged_flash_decode(q1, t(pk), t(pv), t(tb), t(lens),
                                           1, **kw), lens - 1 - window + 1),
        (lambda tb: tpd.paged_flash_verify(qs, t(pk), t(pv), t(tb), t(lens),
                                           1, **kw), lens - 3 - window + 1),
    ]
    offs = np.asarray([40, 48], np.int32)
    qp = t(rand(rng, b, 16, N, D))
    cases.append((lambda tb: tpp.paged_flash_prefill(
        qp, t(pk), t(pv), t(tb), t(offs + 16), t(offs), 1, **kw),
        offs - window + 1))
    for fn, k_lo in cases:
        clean = fn(ring)
        dirty = fn(poisoned(k_lo))
        assert torch.isfinite(clean).all() and torch.isfinite(dirty).all()
        torch.testing.assert_close(dirty, clean, rtol=0, atol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8kv"])
def test_fused_qkv_append_kv_layer_matches_jax_kernel(quant):
    """6k: weights and norm of layer 1, k/v written at pool layer 0."""
    rng = np.random.default_rng(50 + quant)
    n, kvn, d, h, b, li, kli = 4, 2, 32, 128, 3, 1, 0
    nq = (n + 2 * kvn) * d
    ps, mp = 16, 3
    p1 = b * mp + 1
    wq = rng.integers(-127, 128, (2, h, nq)).astype(np.int8)
    ws = (rng.uniform(0.5, 2.0, (2, 1, nq)) * 1e-2).astype(np.float32)
    nw = (rng.standard_normal((2, h)) * 0.1 + 1.0).astype(np.float32)
    xt = t(rand(rng, b, h)).bfloat16()
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    pos = np.asarray([5, 20, 40], np.int32)
    tables = np.asarray([[3, 7, 1], [0, 5, 8], [2, 4, 6]], np.int32)
    sin_j, cos_j = jref.rope_tables(jnp.asarray(pos), d, 10000.0)
    shape = (2, p1, kvn, ps, d)
    if quant:
        pools = [np.zeros(shape, np.int8), np.zeros(shape, np.int8),
                 np.zeros(shape[:-1], np.float32),
                 np.zeros(shape[:-1], np.float32)]
    else:
        pools = [rand(rng, *shape), rand(rng, *shape)]
    jkw = dict(cache_ks=_j(pools[2]), cache_vs=_j(pools[3])) if quant else {}
    tkw = dict(cache_ks=t(pools[2].copy()),
               cache_vs=t(pools[3].copy())) if quant else {}
    jout = jqkv.fused_qkv_append(
        xj, jnp.asarray(nw), jnp.asarray(wq), jnp.asarray(ws),
        sin_j, cos_j, jnp.asarray(pools[0]), jnp.asarray(pools[1]),
        jnp.int32(li), jnp.asarray(pos), n_heads=n, kv_heads=kvn, eps=1e-5,
        tables=jnp.asarray(tables), kv_layer=jnp.int32(kli), interpret=True,
        **jkw)
    tout = tqkv.fused_qkv_append(
        xt, t(nw), t(wq), t(ws), t(np.array(sin_j)), t(np.array(cos_j)),
        t(pools[0].copy()), t(pools[1].copy()), li, t(pos), n_heads=n,
        kv_heads=kvn, eps=1e-5, tables=t(tables), kv_layer=kli, **tkw)
    want_q = np.asarray(jout[0], np.float32)
    np.testing.assert_allclose(tout[0].float().numpy(), want_q, rtol=0,
                               atol=REL * float(np.std(want_q)))
    written = np.zeros(shape, bool)
    for r in range(b):
        written[kli, tables[r, pos[r] // ps], :, pos[r] % ps] = True
    for got, want, before in zip(tout[1:], jout[1:], pools):
        got, want = got.numpy(), np.asarray(want)
        mask = written if got.ndim == 5 else written[..., 0]
        np.testing.assert_array_equal(got[~mask], before[~mask])
        np.testing.assert_array_equal(want[~mask], before[~mask])
        if quant and got.dtype == np.int8:
            # codes from sums in another order: at most one step apart
            assert np.abs(got[mask].astype(int)
                          - want[mask].astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(
                got[mask], want[mask], rtol=0,
                atol=REL * float(np.std(want[mask])))
    # layer 1 of the pools (the weight layer) is untouched
    assert not written[li].any()


def test_fused_qkv_append_kv_layer_counts_its_own_form():
    """On CPU tensors the 6k wrapper runs the plain version; the
    dispatcher sends a kv_layer over float pools to it."""
    rng = np.random.default_rng(60)
    n, kvn, d, h, b = 4, 2, 32, 128, 2
    nq = (n + 2 * kvn) * d
    args = dict(x=t(rand(rng, b, h)), norm_w=torch.ones(2, h),
                wq=t(rng.integers(-127, 128, (2, h, nq)).astype(np.int8)),
                ws=torch.full((2, 1, nq), 1e-2), sin=torch.zeros(b, d // 2),
                cos=torch.ones(b, d // 2), layer=1,
                offsets=torch.tensor([3, 9], dtype=torch.int32),
                n_heads=n, kv_heads=kvn)
    pools = [torch.zeros(1, 5, kvn, 16, d) for _ in range(2)]
    before = tqkv.fused_qkv_append_kv_layer.launches
    q, pk, pv = tqkv.fused_qkv_append(
        **args, pool_k=pools[0], pool_v=pools[1], kv_layer=0,
        tables=torch.tensor([[1, 2], [3, 0]], dtype=torch.int32))
    q2, *_ = tqkv.fused_qkv_append_kv_layer(
        **{k: v for k, v in args.items() if k != "offsets"},
        pool_k=torch.zeros_like(pools[0]), pool_v=torch.zeros_like(pools[1]),
        kv_layer=0, offsets=args["offsets"],
        tables=torch.tensor([[1, 2], [3, 0]], dtype=torch.int32))
    assert torch.equal(q, q2) and pk.abs().sum() > 0
    assert tqkv.fused_qkv_append_kv_layer.launches == before  # CPU: plain


ALTERNATING = ("sliding_attention", "full_attention")


@pytest.mark.parametrize("layer_types", [None, ALTERNATING * 2],
                         ids=["all-sliding", "alternating"])
def test_grouped_engine_int8_weights_matches_jax(layer_types):
    """INT8 weights: the port's decode takes fused_qkv_append over the
    ring pools at kv_layer (6k; != layer when the stack alternates) and
    the window forms of 4 and 3; tokens equal the JAX grouped Engine's."""
    kw = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
              num_layers=4, num_heads=4, num_kv_heads=2, head_dim=32,
              max_seq_len=1024, dtype="float32", sliding_window=6,
              layer_types=layer_types)
    jcfg, tcfg = JaxModelConfig.tiny_test(**kw), ModelConfig.tiny_test(**kw)
    jp = jquantize_params(
        jllama.init_params(jcfg, jax.random.PRNGKey(11)),
        JaxQuantConfig(mode="int8", group_size=0, quantize_lm_head=True))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    kv = dict(page_size=8, num_pages=64, max_pages_per_seq=16)
    je = JaxEngine(jcfg, jp, JaxEngineConfig(max_batch_size=3,
                                             kv=JaxKVConfig(**kv)),
                   decode_burst=4)
    te = Engine(tcfg, tp, EngineConfig(max_batch_size=3,
                                       kv=KVCacheConfig(**kv)),
                decode_burst=4, device="cpu")
    assert te._grouped and te._ring == je._ring
    prompts = [list(range(1, 23)), [7, 3, 9], list(range(50, 61))]
    want = je.generate(prompts, JaxSampling(max_new_tokens=14))
    calls = []
    orig = tqkv.fused_qkv_append_ref

    def spy(*a, **k):
        calls.append(inspect.signature(orig).bind(*a, **k).arguments.get(
            "kv_layer"))
        return orig(*a, **k)

    tqkv.fused_qkv_append_ref = spy
    try:
        got = te.generate(prompts, SamplingParams(max_new_tokens=14))
    finally:
        tqkv.fused_qkv_append_ref = orig
    assert got == want
    # every decode layer went through the fused route with its pool layer
    assert calls and all(c is not None for c in calls)
    if layer_types is not None:
        assert set(calls) == {0, 1}      # group-local: layers 0, 2 -> 0, 1
