"""Gemma-2's attention soft cap in the port's kernels (the capped forms
3c, 3wc, 4c, 4wc, 8c, 8wc) and the kv_layer form of the fused qkv (6k) at
head_dim 256, against the JAX package on the CPU.

The port's wrappers run their plain versions on CPU tensors; the JAX
kernels run in interpret mode, as the JAX package's own tests run them,
on the same numpy inputs (float32, from seeded generators). The scores are
scaled past the cap (|s| up to several times it), with windows whose band
starts inside a page, a kv_len of 0 and rows whose window holds one key.
Stated tolerance 1e-5 on the outputs (summation order); 6k at D 256 (bf16
rows, Gemma-2-2B's GQA of 2 q heads a kv head, f32 pools) as
tests/test_torch_gemma.py holds 6 at D 256: q and the written rows within
2e-2 of their standard deviation, every other pool entry exact, and the
written rows within 1e-5 of the largest magnitude of the JAX package's
plain product on the same bf16 intermediates. The forms still left out
raise NotImplementedError naming the feature: the cap over INT8 and e4m3
pools (decode, verify and prefill), and sinks over INT8 and e4m3 pools
(sinks over pools of q's dtype run since GPT-OSS's slices, on verify rows
and the dense arena too, tests/test_torch_sinks.py). The cap on verify
rows and
on the dense arena (4vc, 4vwc, 13c) runs since Gemma-2's dense slice
(tests/test_torch_dense_window.py holds them against JAX).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
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
from simplellminference_tpu_torch.core.config import ModelConfig
from simplellminference_tpu_torch.ops import paged_append as tpa
from simplellminference_tpu_torch.ops import qkv_fused as tqkv
from simplellminference_tpu_torch.ops import ref_ops as tref
from simplellminference_tpu_torch.ops.attention import dispatch
from simplellminference_tpu_torch.ops.attention import flash_decode as tfd
from simplellminference_tpu_torch.ops.attention import flash_prefill as tfp
from simplellminference_tpu_torch.ops.attention import paged_decode as tpd
from simplellminference_tpu_torch.ops.attention import paged_prefill as tpp

TOL = 1e-5
CAP = 5.0          # small, so that the scaled scores pass it
SCALE_Q = 4.0      # q x 4: scores of about 4 standard deviations of one
HEAD_DIMS = (32, 64, 128, 256)
N, KVN, PS = 4, 2, 8


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _bites(q, k, d):
    """The cap bites: some scaled score is past it."""
    s = np.einsum("...d,kd->...k", q.reshape(-1, d),
                  k.reshape(-1, d)) * d ** -0.5
    assert np.abs(s).max() > CAP


def test_reference_attention_caps_before_the_mask():
    # ref_ops.attention against JAX's: a masked key gets no weight (the
    # cap would make it -cap, not -1e30, were the mask applied first)
    rng = np.random.default_rng(0)
    q, k, v = rand(rng, 2, 6, 4, 32) * SCALE_Q, rand(rng, 2, 9, 2, 32), \
        rand(rng, 2, 9, 2, 32)
    mask = np.tril(np.ones((6, 9), bool), 3)[None, None]
    got = tref.attention(t(q), t(k), t(v), t(mask), logit_cap=CAP)
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(mask), logit_cap=CAP)
    close(got, want)
    uncapped = tref.attention(t(q), t(k), t(v), t(mask))
    assert not torch.allclose(got, uncapped, atol=1e-2)


@pytest.mark.parametrize("window", [None, 5], ids=["3c", "3wc"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_prefill_capped_matches_jax(d, window):
    rng = np.random.default_rng(d + (window or 0))
    s = 20
    q = rand(rng, 2, s, N, d) * SCALE_Q
    k, v = rand(rng, 2, s, KVN, d), rand(rng, 2, s, KVN, d)
    _bites(q[0, :, 0], k[0, :, 0], d)
    got = tfp.flash_prefill(t(q), t(k), t(v), window=window, logit_cap=CAP)
    want = jflash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, interpret=True, window=window,
                          logit_cap=CAP)
    close(got, want)
    # query_pre_attn_scalar's scale (24, not D: a dropped scale shows)
    got = tfp.flash_prefill(t(q), t(k), t(v), sm_scale=24.0 ** -0.5,
                            window=window, logit_cap=CAP)
    want = jflash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, interpret=True, window=window,
                          sm_scale=24.0 ** -0.5, logit_cap=CAP)
    close(got, want)


def _paged(rng, d, b, mp):
    p = b * mp + 1
    pk, pv = rand(rng, 2, p, KVN, PS, d), rand(rng, 2, p, KVN, PS, d)
    tables = rng.permutation(p - 1)[:b * mp].astype(np.int32).reshape(b, mp)
    return pk, pv, tables


@pytest.mark.parametrize("window", [None, 1, 6], ids=["4c", "4wc1", "4wc6"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_paged_decode_capped_matches_jax(d, window):
    # kv_len 0 (a zero row), 1, a band starting inside a page, a full table
    rng = np.random.default_rng(10 * d + (window or 0))
    b, mp = 4, 6
    pk, pv, tables = _paged(rng, d, b, mp)
    lens = np.asarray([0, 1, 19, 48], np.int32)
    q = rand(rng, b, N, d) * SCALE_Q
    _bites(q[3], pk[1, tables[3, 0], 0], d)
    got = tpd.paged_flash_decode(t(q), t(pk), t(pv), t(tables), t(lens), 1,
                                 window=window, logit_cap=CAP)
    want = jpaged_decode(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                         jnp.asarray(tables), jnp.asarray(lens),
                         interpret=True, layer=jnp.int32(1), window=window,
                         logit_cap=CAP)
    close(got, want)
    assert not got[0].any()
    # through the dispatcher, with Gemma-2's options, against JAX's (its
    # CPU route, the dense reference, averages a kv_len-0 row's masked
    # keys where the kernels give zeros: rows with keys only)
    kw = dict(query_pre_attn_scalar=24.0, attn_logit_softcap=CAP,
              sliding_window=window)
    via = dispatch.attention_paged(ModelConfig.tiny_test(**kw), t(q)[:, None],
                                   t(pk), t(pv), t(tables), t(lens), 1)
    jvia = jdispatch.attention_paged(
        JaxModelConfig.tiny_test(**kw), jnp.asarray(q)[:, None],
        jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tables),
        jnp.asarray(lens), layer=jnp.int32(1))
    close(via[1:], np.asarray(jvia)[1:])


@pytest.mark.parametrize("window", [None, 7], ids=["8c", "8wc"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_paged_prefill_capped_matches_jax(d, window):
    rng = np.random.default_rng(20 * d + (window or 0))
    b, s, mp = 2, 16, 6
    pk, pv, tables = _paged(rng, d, b, mp)
    offs = np.asarray([8, 24], np.int32)
    lens = np.asarray([8 + 16, 24 + 11], np.int32)
    q = rand(rng, b, s, N, d) * SCALE_Q
    got = tpp.paged_flash_prefill(t(q), t(pk), t(pv), t(tables), t(lens),
                                  t(offs), 1, window=window, logit_cap=CAP)
    want = jpaged_prefill(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                          jnp.asarray(tables), jnp.asarray(lens),
                          jnp.asarray(offs), bq=16, interpret=True,
                          layer=jnp.int32(1), window=window, logit_cap=CAP)
    for i in range(b):
        live = int(lens[i] - offs[i])
        close(got[i, :live], np.asarray(want)[i, :live])
    kw = dict(attn_logit_softcap=CAP, sliding_window=window)
    via = dispatch.attention_paged_prefill(
        ModelConfig.tiny_test(**kw), t(q), t(pk), t(pv), t(tables), t(lens),
        t(offs), 1)
    for i in range(b):
        live = int(lens[i] - offs[i])
        close(via[i, :live], np.asarray(want)[i, :live])


def test_capped_forms_count_their_launches_apart():
    # on the CPU nothing launches: the cap is a count of its own only on
    # the card, and the wrappers' CPU path leaves every count alone
    before = dict(tfp.CAP_LAUNCHES)
    rng = np.random.default_rng(3)
    q = rand(rng, 1, 8, N, 32)
    k = rand(rng, 1, 8, KVN, 32)
    tfp.flash_prefill(t(q), t(k), t(k), logit_cap=CAP)
    assert tfp.CAP_LAUNCHES == before
    with pytest.raises(ValueError, match="soft cap"):
        tfp.flash_prefill(t(q), t(k), t(k), logit_cap=-1.0)


def test_fused_qkv_append_kv_layer_d256_matches_jax():
    # 6k at D 256: Gemma-2-2B's 8 q heads over 4 kv heads (scaled down to
    # 4 over 2), weights and norm of layer 1, k/v into pool layer 0
    rng = np.random.default_rng(60)
    d, n, kvn, h, b, li, kli, eps = 256, 4, 2, 128, 3, 1, 0, 1e-6
    nq = (n + 2 * kvn) * d
    ps, mp = 16, 3
    p1 = b * mp + 1
    wq = rng.integers(-127, 128, (2, h, nq)).astype(np.int8)
    ws = (rng.uniform(0.5, 2.0, (2, 1, nq)) * 1e-2).astype(np.float32)
    nw = (rng.standard_normal((2, h)) * 0.1 + 1.0).astype(np.float32)
    xt = t(rand(rng, b, h)).to(torch.bfloat16)
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    pos = np.asarray([5, 17, 40], np.int32)
    tables = np.arange(b * mp, dtype=np.int32).reshape(b, mp)
    sin_j, cos_j = jref.rope_tables(jnp.asarray(pos), d, 10000.0)
    pk, pv = rand(rng, 2, p1, kvn, ps, d), rand(rng, 2, p1, kvn, ps, d)
    q_j, jk, jv = jqkv.fused_qkv_append(
        xj, jnp.asarray(nw), jnp.asarray(wq), jnp.asarray(ws), sin_j, cos_j,
        jnp.asarray(pk), jnp.asarray(pv), jnp.int32(li), jnp.asarray(pos),
        n_heads=n, kv_heads=kvn, eps=eps, tables=jnp.asarray(tables),
        kv_layer=jnp.int32(kli), interpret=True)
    tk, tv = t(pk), t(pv)
    q_t, tk, tv = tqkv.fused_qkv_append(
        xt, t(nw), t(wq), t(ws), t(np.array(sin_j)), t(np.array(cos_j)), tk,
        tv, li, t(pos), n_heads=n, kv_heads=kvn, eps=eps, tables=t(tables),
        kv_layer=kli)
    want_q = np.asarray(q_j, np.float32)
    np.testing.assert_allclose(q_t.float().numpy(), want_q, rtol=0,
                               atol=2e-2 * float(np.std(want_q)))
    written = np.zeros(pk.shape, bool)
    for r in range(b):
        written[kli, tables[r, pos[r] // ps], :, pos[r] % ps] = True
    for got, want, before in ((tk, jk, pk), (tv, jv, pv)):
        g, w = got.numpy(), np.asarray(want)
        np.testing.assert_array_equal(g[~written], before[~written])
        np.testing.assert_array_equal(g[~written], w[~written])
        np.testing.assert_allclose(g[written], w[written], rtol=0,
                                   atol=2e-2 * float(np.std(w[written])))
    # the f32 stages on the same bf16 intermediates, against the JAX
    # package's plain product with RoPE in f32
    xf = xt.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xn = (xf * inv * t(nw[li])).to(torch.bfloat16)
    jq = np.asarray(jref.quantized_matmul_ref(
        jnp.asarray(xn.float().numpy(), jnp.bfloat16), jnp.asarray(wq[li]),
        jnp.asarray(ws[li]), out_dtype=jnp.float32))
    half = d // 2
    s, c = np.asarray(sin_j)[:, None], np.asarray(cos_j)[:, None]
    k = jq[:, n * d:(n + kvn) * d].reshape(b, kvn, d)
    k = np.concatenate([k[..., :half] * c - k[..., half:] * s,
                        k[..., half:] * c + k[..., :half] * s], -1)
    v = jq[:, (n + kvn) * d:].reshape(b, kvn, d)
    for r in range(b):
        page = tables[r, pos[r] // ps]
        for pool, want in ((tk, k[r]), (tv, v[r])):
            np.testing.assert_allclose(
                pool.numpy()[kli, page, :, pos[r] % ps], want, rtol=0,
                atol=TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("d", [64, 256])
def test_forms_outside_the_slice_raise(d):
    rng = np.random.default_rng(70)
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
    cap = dict(logit_cap=CAP)
    # the cap over INT8 pools runs (4qc, 4vqc, 8qc), at D 256 too
    for fn, want in (
            (lambda: tpd.paged_flash_decode(q1, qk, qv, tables, kv, 0,
                                            k_scale=ks, v_scale=vs, **cap),
             q1.shape),
            (lambda: tpd.paged_flash_verify(q3, qk, qv, tables, kv, 0,
                                            k_scale=ks, v_scale=vs, **cap),
             q3.shape),
            (lambda: tpp.paged_flash_prefill(q3, qk, qv, tables, kv, offs, 0,
                                             k_scale=ks, v_scale=vs, **cap),
             q3.shape)):
        out = fn()
        assert out.shape == want and bool(torch.isfinite(out).all())
    # the cap over e4m3 pools runs since Gemma's FP8-KV slice (4ec, 4vec,
    # 8ec; at D 256 too, their values: tests/test_torch_fp8kv_gemma.py):
    # these calls, which raised before it, match JAX's kernels on the
    # pools' bytes (rows with keys; rows past kv_len in the prefill are
    # garbage by contract in JAX's)
    jk, jv = (jnp.asarray(x.view(torch.uint8).numpy()).view(
        jnp.float8_e4m3fn) for x in (ek, ev))
    jkw = dict(interpret=True, layer=jnp.int32(0), logit_cap=CAP)
    jt, jl = jnp.asarray(tables.numpy()), jnp.asarray(kv.numpy())
    close(tpd.paged_flash_decode(q1, ek, ev, tables, kv, 0, **cap),
          jpaged_decode(jnp.asarray(q1.numpy()), jk, jv, jt, jl, **jkw))
    got = tpd.paged_flash_verify(q3, ek, ev, tables, kv, 0, **cap)
    want = np.asarray(jpaged_verify(jnp.asarray(q3.numpy()), jk, jv, jt, jl,
                                    **jkw))
    for i, ln in enumerate(kv.tolist()):
        live = [r for r in range(3) if ln - 3 + r >= 0]
        close(got[i, live], want[i, live])
    got = tpp.paged_flash_prefill(q3, ek, ev, tables, kv, offs, 0, **cap)
    want = np.asarray(jpaged_prefill(jnp.asarray(q3.numpy()), jk, jv, jt, jl,
                                     jnp.asarray(offs.numpy()), bq=3, **jkw))
    for i, ln in enumerate(kv.tolist()):
        close(got[i, :min(3, ln)], want[i, :min(3, ln)])
    calls = {}
    # sinks run over every pool dtype (3s, 4s, 8s, 4vs, 13s, 4qs, 8qs:
    # tests/test_torch_sinks.py; 4es, 4ves: tests/test_torch_fp8kv_sinks_
    # window.py) at D 32-128; at D 256 they raise
    e4_sinks = [
        lambda: tpd.paged_flash_decode(q1, ek, ev, tables, kv, 0,
                                       sinks=torch.zeros(N)),
        lambda: tpd.paged_flash_verify(q3, ek, ev, tables, kv, 0,
                                       sinks=torch.zeros(N))]
    if d == 256:
        calls["sinks"] = e4_sinks
    else:
        for fn in e4_sinks:
            assert bool(torch.isfinite(fn()).all())
    for feature, fns in calls.items():
        for fn in fns:
            with pytest.raises(NotImplementedError, match=feature):
                fn()
    # the cap on verify rows (4vc, 4vwc) and on the dense arena (13c,
    # 13wc) runs, at D 256 too
    assert tpd.paged_flash_verify(q3, pk, pv, tables, kv, 0,
                                  **cap).shape == q3.shape
    assert tpd.paged_flash_verify(q3, pk, pv, tables, kv, 0, window=4,
                                  **cap).shape == q3.shape
    for w in (None, 4):
        assert tfd.flash_decode(q1, arena, arena, kv, layer=0, window=w,
                                **cap).shape == q1.shape
    # sinks with the cap over pools of q's dtype and INT8 pools run (paged
    # prefill, self-attention of a prompt, verify rows and the dense
    # arena), but at head_dim 256, which no model with sinks has
    sink_calls = (
        lambda: tpp.paged_flash_prefill(q3, pk, pv, tables, kv, offs, 0,
                                        sinks=torch.zeros(N), **cap),
        lambda: tpp.paged_flash_prefill(q3, qk, qv, tables, kv, offs, 0,
                                        k_scale=ks, v_scale=vs,
                                        sinks=torch.zeros(N), **cap),
        lambda: tpd.paged_flash_verify(q3, qk, qv, tables, kv, 0, window=4,
                                       k_scale=ks, v_scale=vs,
                                       sinks=torch.zeros(N), **cap),
        lambda: dispatch.attention(ModelConfig.tiny_test(attn_sinks=True), q3,
                                   pk[0, :3, :, :3].transpose(1, 2),
                                   pk[0, :3, :, :3].transpose(1, 2),
                                   sinks=torch.zeros(N)),
        lambda: dispatch.attention_paged(
            ModelConfig.tiny_test(attn_sinks=True), q3, pk, pv, tables, kv,
            0, sinks=torch.zeros(N)),
        lambda: tpd.paged_flash_verify(q3, pk, pv, tables, kv, 0, window=4,
                                       sinks=torch.zeros(N), **cap),
        lambda: tfd.flash_decode(q1, arena, arena, kv, layer=0, window=4,
                                 sinks=torch.zeros(N), **cap)[:, None])
    for fn in sink_calls:
        if d == 256:
            with pytest.raises(NotImplementedError, match="head_dim 256"):
                fn()
        else:
            assert fn().shape[::2] == q3.shape[::2]
