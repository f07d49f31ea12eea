"""The speculative-decoding ops of the PyTorch port against the JAX package
on the CPU: the span write (kernel 11), the verify-window attention
(kernel 4 with S rows, and its INT8-KV form) and the speculative sampler.

Inputs come from numpy with fixed seeds and go through both packages. The
JAX side runs as its own CPU tests run it: ``paged_append_span`` and
``paged_flash_verify`` in Pallas interpret mode, ``write_span_stacked``
on its scatter path.

Stated tolerances:
- span writes (bf16/f32 pools; INT8 codes and scales): byte-equal on
  every page but the trash page, which -1 entries and columns past the
  table hit in both packages.
- verify attention, f32: 1e-5 (sums in another order).
- ``shaped_token_prob``: 1e-6.
- the rejection sampler's marginal: a chi-square test against the shaped
  distribution (the random bits differ from JAX's, so not bit-equality).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from simplellminference_tpu.memory import paged_kv as jpkv
from simplellminference_tpu.ops import sampling as jsamp
from simplellminference_tpu.ops.attention.paged_decode import (
    paged_flash_verify as jax_paged_flash_verify)
from simplellminference_tpu.ops.paged_append import (
    paged_append_span as jax_paged_append_span)
from simplellminference_tpu_torch.memory import paged_kv as tpkv
from simplellminference_tpu_torch.ops import paged_append as tpa
from simplellminference_tpu_torch.ops import sampling as tsamp
from simplellminference_tpu_torch.ops.attention import paged_decode as tpd

L, P, KVN, PS, D = 2, 12, 2, 8, 16
# row 0 spans a page boundary, row 1 runs past its mapped pages into an
# unmapped column, row 2 is an inactive slot (all -1), row 3 runs past the
# table's last column
TABLES = np.array([[3, 7, 1], [0, 11, -1], [-1, -1, -1], [5, 2, 9]],
                  np.int32)
POSITIONS = np.array([6, 12, 0, 21], np.int32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def draw(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def pools_np(rng):
    return draw(rng, L, P + 1, KVN, PS, D), draw(rng, L, P + 1, KVN, PS, D)


def torch_dtype(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def as_f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("span", [1, 3, 5, 8])
def test_paged_append_span_matches_jax_kernel(dtype, span):
    rng = np.random.default_rng(span)
    pk, pv = pools_np(rng)
    nk, nv = draw(rng, 4, span, KVN, D), draw(rng, 4, span, KVN, D)
    layer = 1
    jk, jv = jax_paged_append_span(
        jnp.asarray(pk, dtype), jnp.asarray(pv, dtype), jnp.asarray(nk),
        jnp.asarray(nv), jnp.asarray(TABLES), jnp.asarray(POSITIONS),
        jnp.int32(layer), interpret=True)
    tdt = torch_dtype(dtype)
    tk, tv = t(pk).to(tdt), t(pv).to(tdt)
    before = tpa.paged_append_span.launches
    tpa.paged_append_span(tk, tv, t(nk), t(nv), t(TABLES), t(POSITIONS),
                          layer)
    assert tpa.paged_append_span.launches == before   # CPU: plain version
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(as_f32(got)[:, :-1],
                                      as_f32(want)[:, :-1])
    # the rows landed where the tables say, and nowhere else
    changed = (as_f32(tk) != as_f32(t(pk).to(tdt)))[layer, :-1].any(
        axis=(1, 3))
    assert changed.sum() <= 4 * span * KVN


@pytest.mark.parametrize("kv", ["f32", "bf16", "int8"])
def test_write_span_stacked_matches_jax(kv):
    rng = np.random.default_rng(11)
    span = 5
    nk, nv = draw(rng, 4, span, KVN, D) * 3, draw(rng, 4, span, KVN, D) * 3
    if kv == "int8":
        jc = jpkv.PagedKVCache.create(L, P, KVN, PS, D, jnp.int8)
        tc = tpkv.PagedKVCache.create(L, P, KVN, PS, D, torch.int8,
                                      device="cpu")
        jpools = [jc.k, jc.v, jc.k_scale, jc.v_scale]
        tpools = [tc.k, tc.v, tc.k_scale, tc.v_scale]
    else:
        pk, pv = pools_np(rng)
        dt = {"f32": "float32", "bf16": "bfloat16"}[kv]
        jpools = [jnp.asarray(pk, dt), jnp.asarray(pv, dt), None, None]
        tpools = [t(pk).to(torch_dtype(dt)), t(pv).to(torch_dtype(dt)),
                  None, None]
    for layer in range(L):
        jpools = list(jpkv.write_span_stacked(
            jpools[0], jpools[1], jnp.asarray(nk), jnp.asarray(nv),
            jnp.asarray(TABLES), jnp.asarray(POSITIONS + layer),
            jnp.int32(layer), jpools[2], jpools[3]))
        tpkv.write_span_stacked(tpools[0], tpools[1], t(nk), t(nv),
                                t(TABLES), t(POSITIONS + layer), layer,
                                pool_ks=tpools[2], pool_vs=tpools[3])
    for got, want in zip(tpools, jpools):
        if got is None:
            assert want is None
            continue
        np.testing.assert_array_equal(as_f32(got)[:, :-1],
                                      as_f32(want)[:, :-1])


def test_span_write_refuses_shared_kv_pools():
    pk = torch.zeros((1, 3, 1, 8, 16))
    with pytest.raises(NotImplementedError, match="shared-KV"):
        tpa.paged_append_span(pk, None, torch.zeros((1, 2, 1, 16)), None,
                              torch.zeros((1, 1), dtype=torch.int32),
                              torch.zeros(1, dtype=torch.int32), 0)


def _verify_inputs(rng, s, n, kvn, int8):
    b, mp = 4, 4
    tables = np.array([[3, 7, 1, 4], [0, 11, 2, 6], [8, 5, 9, 10],
                       [-1, -1, -1, -1]], np.int32)
    # kv_len ranges over page boundaries; the dead row has kv_len 0
    kv_lens = np.array([s + 3, 17, 32, 0], np.int32)
    q = draw(rng, b, s, n, D)
    if int8:
        pk = rng.integers(-127, 128, (L, P + 1, kvn, PS, D)).astype(np.int8)
        pv = rng.integers(-127, 128, (L, P + 1, kvn, PS, D)).astype(np.int8)
        ks = rng.uniform(1e-3, 2e-2, (L, P + 1, kvn, PS)).astype(np.float32)
        vs = rng.uniform(1e-3, 2e-2, (L, P + 1, kvn, PS)).astype(np.float32)
        scales = (ks, vs)
    else:
        pk, pv = draw(rng, L, P + 1, kvn, PS, D), draw(rng, L, P + 1, kvn,
                                                        PS, D)
        scales = (None, None)
    assert mp * PS >= kv_lens.max()
    return q, pk, pv, scales, tables, kv_lens


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8kv"])
@pytest.mark.parametrize("s", [1, 2, 5, 8])
@pytest.mark.parametrize("n,kvn", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_paged_flash_verify_matches_jax_kernel(int8, s, n, kvn):
    rng = np.random.default_rng(s * 10 + n)
    q, pk, pv, (ks, vs), tables, kv_lens = _verify_inputs(rng, s, n, kvn,
                                                          int8)
    layer = 1
    jax_scales = {} if not int8 else dict(k_scale=jnp.asarray(ks),
                                          v_scale=jnp.asarray(vs))
    want = jax_paged_flash_verify(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(kv_lens), interpret=True,
        layer=jnp.int32(layer), **jax_scales)
    fn = tpd.paged_flash_verify_int8kv if int8 else tpd.paged_flash_verify
    args = (t(q), t(pk), t(pv))
    if int8:
        args += (t(ks), t(vs))
    before = fn.launches
    got = fn(*args, t(tables), t(kv_lens), layer)
    assert fn.launches == before                          # CPU: plain
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the S == 1 window is the decode kernel's call
    if s == 1:
        dec = tpd.paged_flash_decode(t(q[:, 0]), t(pk), t(pv), t(tables),
                                     t(kv_lens), layer,
                                     k_scale=t(ks) if int8 else None,
                                     v_scale=t(vs) if int8 else None)
        np.testing.assert_array_equal(dec.numpy(), got[:, 0].numpy())


def test_verify_rows_without_keys_are_zero():
    # kv_len 2 with a 4-row window: rows 0 and 1 sit before position 0
    rng = np.random.default_rng(3)
    q, pk, pv, _, tables, _ = _verify_inputs(rng, 4, 4, 4, False)
    kv_lens = np.array([2, 4, 9, 0], np.int32)
    got = tpd.paged_flash_verify(t(q), t(pk), t(pv), t(tables), t(kv_lens),
                                 0).numpy()
    assert (got[0, :2] == 0).all() and (got[0, 2:] != 0).any()
    assert (got[3] == 0).all() and (got[1] != 0).all(axis=(1, 2)).any()


SHAPING = [dict(top_k=0, top_p=1.0, min_p=0.0),
           dict(top_k=8, top_p=0.95, min_p=0.0),
           dict(top_k=0, top_p=0.7, min_p=0.05),
           dict(top_k=1, top_p=1.0, min_p=0.0)]


@pytest.mark.parametrize("shaping", SHAPING,
                         ids=["neutral", "topk-topp", "topp-minp", "topk1"])
def test_shaped_token_prob_matches_jax(shaping):
    rng = np.random.default_rng(4)
    b, v = 6, 64
    lg = (rng.standard_normal((b, v)) * 2).astype(np.float32)
    tok = np.concatenate([lg.argmax(-1)[:3],
                          rng.integers(0, v, 3)]).astype(np.int32)
    temp = np.array([0.9, 1.0, 0.5, 1.5, 0.7, 1.2], np.float32)
    rows = {k: np.full(b, val, np.float32 if k != "top_k" else np.int32)
            for k, val in shaping.items()}
    want = jsamp.shaped_token_prob(
        jnp.asarray(lg), jnp.asarray(tok), jnp.asarray(temp),
        *(jnp.asarray(rows[k]) for k in ("top_k", "top_p", "min_p")))
    for flag in (None, shaping != SHAPING[0]):
        got = tsamp.shaped_token_prob(
            t(lg), t(tok), t(temp),
            *(t(rows[k]) for k in ("top_k", "top_p", "min_p")),
            shaping_on=flag)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_sample_excluding_empty_support_fallback():
    # excluding the only surviving token falls back to the full shaped row
    lg = torch.zeros((1, 32))
    lg[0, 3] = 50.0
    tok = tsamp.sample_excluding(
        lg, torch.tensor([1.0]), torch.tensor([1], dtype=torch.int32),
        torch.tensor([1.0]), torch.tensor([0.0]),
        torch.tensor([3], dtype=torch.int32),
        tsamp.spec_row_keys(torch.tensor([5]), torch.tensor([0]), 2))
    assert int(tok[0]) == 3


def test_spec_streams_share_no_bits():
    seeds = torch.arange(200).repeat_interleave(50)
    pos = torch.arange(50).repeat(200)
    plain = tsamp._row_keys(seeds, pos)
    acc = tsamp.spec_row_keys(seeds, pos, 1)
    res = tsamp.spec_row_keys(seeds, pos, 2)
    keys = torch.cat([plain, acc, res])
    assert keys.unique().numel() == keys.numel()
    u = tsamp.row_uniform(acc)
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01


def test_spec_rejection_sampling_preserves_marginals():
    """Emit draft d w.p. p(d), else draw from p | != d: the emitted
    marginal is the shaped distribution p (JAX test_ops.py:219), checked
    by a chi-square test over 20000 seeds."""
    rng = np.random.default_rng(0)
    v, n = 16, 20000
    lg = (rng.standard_normal((1, v)) * 2).astype(np.float32)
    temp, top_k, top_p, min_p = 0.9, 8, 0.95, 0.0
    masked, si = jsamp._shaped_sorted(
        jnp.asarray(lg), jnp.asarray([temp]), jnp.asarray([top_k]),
        jnp.asarray([top_p]), jnp.asarray([min_p]))
    target = np.zeros(v)
    target[np.asarray(si)[0]] = np.exp(np.asarray(masked, np.float64)
                                       - float(masked.max()))[0]
    target /= target.sum()
    logits = t(np.repeat(lg, n, 0))
    rows = [torch.full((n,), x, dtype=dt) for x, dt in (
        (temp, torch.float32), (top_k, torch.int32), (top_p, torch.float32),
        (min_p, torch.float32))]
    draft = torch.full((n,), int(lg.argmax()), dtype=torch.int32)
    seeds, pos = torch.arange(n), torch.zeros(n, dtype=torch.int64)
    pd = tsamp.shaped_token_prob(logits, draft, *rows)
    u = tsamp.row_uniform(tsamp.spec_row_keys(seeds, pos, 1))
    res = tsamp.sample_excluding(logits, *rows, draft,
                                 tsamp.spec_row_keys(seeds, pos, 2))
    draws = torch.where(u < pd, draft, res).numpy()
    support = np.flatnonzero(target > 0)
    assert set(np.unique(draws)) <= set(support)   # never a filtered token
    obs = np.bincount(draws, minlength=v)[support]
    stat, p_value = scipy.stats.chisquare(obs, target[support] * n)
    assert p_value > 1e-3, (stat, obs, target[support] * n)
