"""INT8 KV storage in the PyTorch port against the JAX package on the CPU.

Inputs come from numpy with fixed seeds and go through both packages. The
JAX side runs as its own CPU tests run it: the jnp scatter path of
``write_*_stacked`` (its quantizing Pallas writes take no interpret
mode), and interpret mode for ``paged_flash_decode`` /
``paged_flash_prefill`` with scale pools and for ``fused_qkv_append``
with ``cache_ks``/``cache_vs``.

Stated tolerances:
- ``quantize_kv`` and the quantizing writes: codes and scales byte-equal
  (every page but the trash page, which -1 entries hit in both packages).
- Attention over INT8 pools, f32: 1e-5 (the kernels dequantize late,
  the plain versions early: f32 rounding).
- The quantizing ``fused_qkv_append``: codes at most 1 apart (k/v come
  from sums in another order, so a value at a rounding midpoint may round
  the other way); scales within 1e-5 relative in f32 and one bf16 ulp of
  the absmax with bf16 activations (the absmax is a bf16 value that may
  round the other way); q as in tests/test_torch_fused.py.
- ``forward_paged``: logits within 1e-4 (f32) for prefill, chunked
  prefill and decode.
The Engines' runs are in tests/test_torch_int8kv_engine.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.memory import paged_kv as jpkv
from simplellminference_tpu.ops import qkv_fused as jqkv
from simplellminference_tpu.ops import ref_ops as jref
from simplellminference_tpu.ops.attention import dispatch as jdispatch
from simplellminference_tpu.ops.attention.paged_decode import (
    paged_flash_decode as jax_paged_flash_decode)
from simplellminference_tpu.ops.attention.paged_prefill import (
    paged_flash_prefill as jax_paged_flash_prefill)
from simplellminference_tpu.ops.linear import QuantizedWeight as JaxQW
from simplellminference_tpu.ops.linear import linear as jlinear
from simplellminference_tpu_torch.core.config import ModelConfig
from simplellminference_tpu_torch.memory import paged_kv as tpkv
from simplellminference_tpu_torch.ops import paged_append as tpa
from simplellminference_tpu_torch.ops import qkv_fused as tqkv
from simplellminference_tpu_torch.ops.attention import dispatch
from simplellminference_tpu_torch.ops.attention.paged_decode import (
    paged_flash_decode)
from simplellminference_tpu_torch.ops.attention.paged_prefill import (
    paged_flash_prefill)

L, P, KVN, PS, D = 3, 12, 2, 8, 16
TOL = 1e-5
# row 1 has an unmapped tail, row 2 is an inactive slot (all -1)
TABLES = np.array([[3, 7, 1, 4], [0, 11, -1, -1], [-1, -1, -1, -1]],
                  np.int32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def quant_pools(rng, layers=L, pages=P + 1, kvn=KVN, ps=PS, d=D):
    """Random int8 pools and positive scale pools (numpy): pages a write
    does not touch must come back unchanged."""
    shape = (layers, pages, kvn, ps, d)
    return (rng.integers(-127, 128, shape).astype(np.int8),
            rng.integers(-127, 128, shape).astype(np.int8),
            rng.uniform(0.01, 0.1, shape[:-1]).astype(np.float32),
            rng.uniform(0.01, 0.1, shape[:-1]).astype(np.float32))


def rows(rng, shape, dtype):
    """New K/V rows with per-row magnitudes spread over 1e-3..1e2, as one
    array for each package (bf16 rounded once, on the torch side)."""
    x = rand(rng, *shape) * np.exp(rng.uniform(-7, 4.6, shape[:-1] + (1,))
                                   ).astype(np.float32)
    if dtype == "bf16":
        tx = t(x).bfloat16()
        return tx, jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16)
    return t(x), jnp.asarray(x)


def assert_pools_equal(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g[:, :-1], w[:, :-1])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_kv_matches_jax(dtype):
    rng = np.random.default_rng(0)
    tx, jx = rows(rng, (5, 7, 3, 64), dtype)
    tx[0, 0, 0] = 0                                 # absmax 0: the 1e-8 floor
    jx = jx.at[0, 0, 0].set(0)
    # exact ties: x / scale lands on k + 0.5 for a row whose absmax is 127
    tie = np.arange(64, dtype=np.float32) + 0.5
    tie[-1] = 127.0
    tx[0, 0, 1] = t(tie).to(tx.dtype)
    jx = jx.at[0, 0, 1].set(jnp.asarray(tie).astype(jx.dtype))
    tq, ts = tpkv.quantize_kv(tx)
    jq, js = jpkv.quantize_kv(jx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s,offset", [(16, None), (13, None), (1, None),
                                      (9, 1), (5, [0, 1, 3])],
                         ids=["full", "ragged", "one", "offset", "offsets"])
def test_write_prefill_quant_matches_jax(dtype, s, offset):
    rng = np.random.default_rng(s)
    pools = quant_pools(rng)
    tk, jk = rows(rng, (3, s, KVN, D), dtype)
    tv, jv = rows(rng, (3, s, KVN, D), dtype)
    po = None if offset is None else np.asarray(offset, np.int32)
    want = jpkv.write_prefill_stacked(
        *(jnp.asarray(p) for p in pools[:2]), jk, jv, jnp.asarray(TABLES),
        jnp.int32(1), *(jnp.asarray(p) for p in pools[2:]),
        page_offset=None if po is None else jnp.asarray(po))
    tp = [t(p.copy()) for p in pools]
    got = tpkv.write_prefill_stacked(
        tp[0], tp[1], tk, tv, t(TABLES), 1, pool_ks=tp[2], pool_vs=tp[3],
        page_offset=(None if po is None else int(po) if po.ndim == 0
                     else t(po)))
    assert all(a is b for a, b in zip(got, tp))      # updated in place
    assert_pools_equal(tp, want)


def test_write_prefill_quant_pads_last_page_with_zero_scales():
    rng = np.random.default_rng(3)
    pools = [t(p) for p in quant_pools(rng)]
    nk = t(rand(rng, 1, 5, KVN, D))
    tpa.paged_append_prefill_quant_ref(*pools, nk, nk, torch.tensor([[6]]),
                                       0)
    q, s = tpkv.quantize_kv(nk[0].transpose(0, 1))
    assert torch.equal(pools[0][0, 6, :, :5], q)
    assert torch.equal(pools[2][0, 6, :, :5], s)
    assert not pools[0][0, 6, :, 5:].any() and not pools[2][0, 6, :, 5:].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_write_decode_quant_matches_jax(dtype):
    rng = np.random.default_rng(1)
    pools = quant_pools(rng)
    tk, jk = rows(rng, (3, KVN, D), dtype)
    tv, jv = rows(rng, (3, KVN, D), dtype)
    positions = np.array([17, 9, 4], np.int32)   # page 1 slot 1; page 11; dead
    want = jpkv.write_decode_stacked(
        *(jnp.asarray(p) for p in pools[:2]), jk, jv, jnp.asarray(TABLES),
        jnp.asarray(positions), jnp.int32(2),
        *(jnp.asarray(p) for p in pools[2:]))
    tp = [t(p.copy()) for p in pools]
    got = tpkv.write_decode_stacked(tp[0], tp[1], tk, tv, t(TABLES),
                                    t(positions), 2, pool_ks=tp[2],
                                    pool_vs=tp[3])
    assert all(a is b for a, b in zip(got, tp))
    assert_pools_equal(tp, want)
    q, s = tpkv.quantize_kv(tk[0])
    assert torch.equal(tp[0][2, 1, :, 1], q) and torch.equal(tp[2][2, 1, :, 1],
                                                             s)


def test_gather_dense_dequantizes_like_jax():
    rng = np.random.default_rng(2)
    pk, pv, ks, vs = quant_pools(rng)
    jk, jv = jpkv.gather_dense(jnp.asarray(pk[0]), jnp.asarray(pv[0]),
                               jnp.asarray(TABLES), jnp.asarray(ks[0]),
                               jnp.asarray(vs[0]))
    tk, tv = tpkv.gather_dense(t(pk[0]), t(pv[0]), t(TABLES), t(ks[0]),
                               t(vs[0]))
    mapped = np.repeat(TABLES >= 0, PS, axis=1)          # [B, MP*ps]
    for g, w in ((tk, jk), (tv, jv)):
        assert g.dtype == torch.float32
        g, w = g.numpy().transpose(0, 2, 1, 3), np.asarray(w).transpose(
            0, 2, 1, 3)
        np.testing.assert_array_equal(g[mapped], w[mapped])
        assert not g[~mapped].any()


def test_cache_create_int8_has_zeroed_scale_pools():
    c = tpkv.PagedKVCache.create(2, 5, 3, 8, 16, torch.int8, device="cpu")
    assert c.k.dtype == c.v.dtype == torch.int8
    assert c.k_scale.shape == c.v_scale.shape == (2, 6, 3, 8)
    assert c.k_scale.dtype == torch.float32 and not c.k_scale.any()
    f = tpkv.PagedKVCache.create(2, 5, 3, 8, 16, torch.float32, device="cpu")
    assert f.k_scale is None and f.v_scale is None


def _decode_case(rng, b, n, kvn, d, ps, mp, lens):
    p = b * mp + 1
    pk, pv, ks, vs = quant_pools(rng, 2, p, kvn, ps, d)
    tables = (rng.permutation(p - 1)[:b * mp]).astype(np.int32).reshape(
        b, mp)
    lens = np.asarray(lens, np.int32)
    tables[lens == 0] = -1                        # dead slots: all -1
    return rand(rng, b, n, d), pk, pv, ks, vs, tables, lens


@pytest.mark.parametrize("n,kvn,d", [(4, 2, 32), (4, 4, 64), (8, 1, 32)],
                         ids=["gqa", "mha", "mqa"])
def test_paged_flash_decode_int8kv_matches_jax_kernel(n, kvn, d):
    rng = np.random.default_rng(n * kvn + d)
    q, pk, pv, ks, vs, tables, lens = _decode_case(
        rng, 4, n, kvn, d, 8, 5, [1, 17, 40, 0])
    got = paged_flash_decode(t(q), t(pk), t(pv), t(tables), t(lens), 1,
                             k_scale=t(ks), v_scale=t(vs))
    want = jax_paged_flash_decode(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(lens), interpret=True,
        layer=jnp.int32(1), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    cfg, jcfg = ModelConfig.tiny_test(), JaxModelConfig.tiny_test()
    via = dispatch.attention_paged(cfg, t(q)[:, None], t(pk), t(pv),
                                   t(tables), t(lens), 1, pool_ks=t(ks),
                                   pool_vs=t(vs))
    jvia = jdispatch.attention_paged(
        jcfg, jnp.asarray(q)[:, None], jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(ks),
        jnp.asarray(vs), layer=jnp.int32(1))
    live = lens > 0
    np.testing.assert_allclose(via.numpy()[live], np.asarray(jvia)[live],
                               rtol=TOL, atol=TOL)


def test_paged_flash_decode_refuses_mixed_pools():
    rng = np.random.default_rng(5)
    q, pk, pv, ks, vs, tables, lens = _decode_case(
        rng, 2, 4, 2, 32, 8, 2, [3, 9])
    with pytest.raises(NotImplementedError, match="no V scale pool"):
        paged_flash_decode(t(q), t(pk), t(pv), t(tables), t(lens), 0,
                           k_scale=t(ks))
    with pytest.raises(ValueError, match="int8 pools"):
        paged_flash_decode(t(q), t(pk).float(), t(pv).float(), t(tables),
                           t(lens), 0, k_scale=t(ks), v_scale=t(vs))


@pytest.mark.parametrize("b,s,n,kvn,d,ps", [
    (2, 32, 4, 2, 32, 8),
    (1, 64, 4, 4, 64, 16),
], ids=["gqa", "mha"])
def test_paged_flash_prefill_int8kv_matches_jax_kernel(b, s, n, kvn, d, ps):
    rng = np.random.default_rng(b * s + n)
    mp = 2 * s // ps
    p = b * mp + 1
    pk, pv, ks, vs = quant_pools(rng, 2, p, kvn, ps, d)
    q = rand(rng, b, s, n, d)
    offs = np.asarray([(i % 2) * ps for i in range(b)], np.int32)
    kv = (offs + rng.integers(1, s + 1, size=b)).astype(np.int32)
    tables = (rng.permutation(p - 1)[:b * mp]).astype(np.int32).reshape(
        b, mp)
    got = paged_flash_prefill(t(q), t(pk), t(pv), t(tables), t(kv), t(offs),
                              1, k_scale=t(ks), v_scale=t(vs))
    want = jax_paged_flash_prefill(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(kv), jnp.asarray(offs), bq=s,
        interpret=True, layer=jnp.int32(1), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    assert torch.isfinite(got).all()
    for i in range(b):
        valid = int(kv[i] - offs[i])
        np.testing.assert_allclose(got[i, :valid].numpy(),
                                   np.asarray(want)[i, :valid], rtol=TOL,
                                   atol=TOL)


def test_paged_flash_prefill_int8kv_dispatch_padding_row():
    # any Sq through the dispatcher (the JAX CPU path), with a batch's
    # padding row (all -1 table, kv_len 1, offset 0): finite everywhere
    rng = np.random.default_rng(11)
    b, s, n, kvn, d, ps, mp = 3, 20, 4, 2, 32, 8, 6
    pk, pv, ks, vs = quant_pools(rng, 2, b * mp + 1, kvn, ps, d)
    q = rand(rng, b, s, n, d)
    tables = np.arange(b * mp, dtype=np.int32).reshape(b, mp)
    tables[2] = -1
    offs = np.asarray([8, 0, 0], np.int32)
    kv = np.asarray([28, 5, 1], np.int32)
    got = dispatch.attention_paged_prefill(
        ModelConfig.tiny_test(), t(q), t(pk), t(pv), t(tables), t(kv),
        t(offs), 1, pool_ks=t(ks), pool_vs=t(vs))
    want = jdispatch.attention_paged_prefill(
        JaxModelConfig.tiny_test(), jnp.asarray(q), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(tables), jnp.asarray(kv),
        jnp.asarray(offs), jnp.asarray(ks), jnp.asarray(vs),
        layer=jnp.int32(1))
    assert torch.isfinite(got).all()
    for i in range(2):
        valid = int(kv[i] - offs[i])
        np.testing.assert_allclose(got[i, :valid].numpy(),
                                   np.asarray(want)[i, :valid], rtol=TOL,
                                   atol=TOL)


# ---------------------------------------------- the quantizing fused qkv

def _qkv_case(seed, n, kvn, dtype):
    rng = np.random.default_rng(seed)
    lyr, h, d, ps, mp, b, li = 2, 128, 32, 16, 3, 3, 1
    nq = (n + 2 * kvn) * d
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
    # row 2's page for position 40 is unmapped: it writes to the trash page
    tables = np.asarray([[3, 7, 1], [0, 5, 8], [2, 4, -1]], np.int32)
    pools = quant_pools(rng, lyr, p1, kvn, ps, d)
    written = np.zeros((lyr, p1, kvn, ps), bool)
    for r in range(b):
        page = tables[r, pos[r] // ps]
        written[li, page if page >= 0 else p1 - 1, :, pos[r] % ps] = True
    return dict(wq=wq, ws=ws, nw=nw, xt=xt, xj=xj, pos=pos, tables=tables,
                pools=pools, written=written, n=n, kvn=kvn, d=d, li=li)


def _port_fused(c):
    sin, cos = jref.rope_tables(jnp.asarray(c["pos"]), c["d"], 10000.0)
    tp = [t(p.copy()) for p in c["pools"]]
    q, *out = tqkv.fused_qkv_append(
        c["xt"], t(c["nw"]), t(c["wq"]), t(c["ws"]), t(np.array(sin)),
        t(np.array(cos)), tp[0], tp[1], c["li"], t(c["pos"]),
        n_heads=c["n"], kv_heads=c["kvn"], eps=1e-5, tables=t(c["tables"]),
        cache_ks=tp[2], cache_vs=tp[3])
    assert all(a is b for a, b in zip(out, tp))
    return q, tp, (sin, cos)


def _check_quant_rows(c, got, want, scale_rtol):
    """Codes at most 1 apart and scales within ``scale_rtol`` (a callable
    of the wanted scales giving the allowed difference) on the written
    rows; everything else unchanged and equal."""
    w = c["written"]
    for g, j in zip(got, want):
        g, j = np.asarray(g), np.asarray(j)
        mask = w if g.ndim == 4 else w[..., None].repeat(g.shape[-1], -1)
        np.testing.assert_array_equal(g[~mask], j[~mask])
        if g.dtype == np.int8:
            assert np.abs(g[mask].astype(int) - j[mask]).max() <= 1
        else:
            assert (np.abs(g[mask] - j[mask]) <= scale_rtol(j[mask])).all()
    assert w[c["li"], -1].any()              # the trash page took row 2


@pytest.mark.parametrize("n,kvn", [(4, 2), (4, 4)], ids=["gqa", "mha"])
def test_fused_qkv_append_int8kv_matches_jax_unfused_f32(n, kvn):
    c = _qkv_case(n + kvn, n, kvn, "f32")
    q_t, tp, (sin, cos) = _port_fused(c)
    d, li = c["d"], c["li"]
    xn = jref.rmsnorm(c["xj"], jnp.asarray(c["nw"][li]), 1e-5)
    qkv = jlinear(xn, JaxQW(q=jnp.asarray(c["wq"]), scales=jnp.asarray(
        c["ws"])), layer=jnp.int32(li))
    b = qkv.shape[0]
    q = jref.apply_rope(qkv[:, None, :n * d].reshape(b, 1, n, d),
                        sin[:, None], cos[:, None])[:, 0]
    k = jref.apply_rope(qkv[:, None, n * d:(n + kvn) * d].reshape(
        b, 1, kvn, d), sin[:, None], cos[:, None])[:, 0]
    v = qkv[:, (n + kvn) * d:].reshape(b, kvn, d)
    want = jpkv.write_decode_stacked(
        *(jnp.asarray(p) for p in c["pools"][:2]), k, v,
        jnp.asarray(c["tables"]), jnp.asarray(c["pos"]), jnp.int32(li),
        *(jnp.asarray(p) for p in c["pools"][2:]))
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q), rtol=TOL,
                               atol=TOL * float(np.abs(np.asarray(q)).max()))
    _check_quant_rows(c, tp, want, lambda s: TOL * s)


@pytest.mark.parametrize("n,kvn", [(4, 2), (4, 4)], ids=["gqa", "mha"])
def test_fused_qkv_append_int8kv_matches_jax_kernel_bf16(n, kvn):
    c = _qkv_case(10 + n + kvn, n, kvn, "bf16")
    q_t, tp, (sin, cos) = _port_fused(c)
    q_j, *want = jqkv.fused_qkv_append(
        c["xj"], jnp.asarray(c["nw"]), jnp.asarray(c["wq"]),
        jnp.asarray(c["ws"]), sin, cos,
        *(jnp.asarray(p) for p in c["pools"][:2]), jnp.int32(c["li"]),
        jnp.asarray(c["pos"]), n_heads=n, kv_heads=kvn, eps=1e-5,
        tables=jnp.asarray(c["tables"]),
        cache_ks=jnp.asarray(c["pools"][2]),
        cache_vs=jnp.asarray(c["pools"][3]), interpret=True)
    assert q_t.dtype == torch.bfloat16
    want_q = np.asarray(q_j, np.float32)
    np.testing.assert_allclose(q_t.float().numpy(), want_q, rtol=0,
                               atol=2e-2 * float(np.std(want_q)))

    def one_bf16_ulp_of_absmax(s):
        amax = s * 127.0
        ulp = np.exp2(np.floor(np.log2(amax)) - 7)
        return ulp / 127.0 * (1 + 1e-6)

    _check_quant_rows(c, tp, want, one_bf16_ulp_of_absmax)


def test_fused_qkv_append_int8kv_refuses_half_pools():
    c = _qkv_case(0, 4, 2, "f32")
    pk, pv, ks, _vs = (t(p) for p in c["pools"])
    with pytest.raises(ValueError, match="int8 pools"):
        tqkv.fused_qkv_append(
            c["xt"], t(c["nw"]), t(c["wq"]), t(c["ws"]), torch.zeros(3, 16),
            torch.ones(3, 16), pk.float(), pv.float(), 1, t(c["pos"]),
            tables=t(c["tables"]), cache_ks=ks, cache_vs=ks)
