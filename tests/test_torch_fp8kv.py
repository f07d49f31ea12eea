"""FP8 (e4m3) KV storage in the PyTorch port against the JAX package on the
CPU.

Inputs come from numpy with fixed seeds and go through both packages;
e4m3 arrays pass between them as their bytes (uint8 views). The JAX side
runs as its own CPU tests run it: the jnp scatter path of
``write_*_stacked`` (its Pallas writes take no interpret mode) and
interpret mode for ``paged_flash_decode``, ``paged_flash_verify``,
``paged_flash_prefill`` and ``fused_qkv_append`` over e4m3 pools.

Stated tolerances:
- ``to_e4m3`` and the writes: byte-equal (every page but the trash page,
  which -1 entries hit in both packages), rows past 464 (NaN in JAX's
  cast) included.
- Attention over e4m3 pools, f32: 1e-5 (sums in another order; the
  stored values are exact in both).
- ``fused_qkv_append`` over e4m3 pools: f32 against the JAX unfused path
  (the TPU kernel rounds x to bf16 whatever its dtype), k/v codes
  byte-equal and q within 1e-5; bf16 against the JAX kernel, k/v codes at
  most one e4m3 step apart (sums in another order may cross a rounding
  midpoint) and q within 2e-2 of its standard deviation, as
  tests/test_torch_int8kv.py holds the INT8-KV form.
The Engines' runs are in tests/test_torch_fp8kv_engine.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.core.config import SamplingParams as JaxSampling
from simplellminference_tpu.memory import paged_kv as jpkv
from simplellminference_tpu.models import llama as jllama
from simplellminference_tpu.ops import qkv_fused as jqkv
from simplellminference_tpu.ops import ref_ops as jref
from simplellminference_tpu.ops.attention import dispatch as jdispatch
from simplellminference_tpu.ops.attention.paged_decode import (
    paged_flash_decode as jax_paged_flash_decode)
from simplellminference_tpu.ops.attention.paged_decode import (
    paged_flash_verify as jax_paged_flash_verify)
from simplellminference_tpu.ops.attention.paged_prefill import (
    paged_flash_prefill as jax_paged_flash_prefill)
from simplellminference_tpu.ops.linear import QuantizedWeight as JaxQW
from simplellminference_tpu.ops.linear import linear as jlinear
from simplellminference_tpu.runtime.generator import (
    Generator as JaxGenerator)
from simplellminference_tpu_torch.core.config import (ModelConfig,
                                                      SamplingParams)
from simplellminference_tpu_torch.memory import paged_kv as tpkv
from simplellminference_tpu_torch.models.convert import params_from_jax
from simplellminference_tpu_torch.ops import cuda_build
from simplellminference_tpu_torch.ops import paged_append as tpa
from simplellminference_tpu_torch.ops import qkv_fused as tqkv
from simplellminference_tpu_torch.ops.attention import dispatch
from simplellminference_tpu_torch.ops.attention import paged_decode as tpd
from simplellminference_tpu_torch.ops.attention import paged_prefill as tpp
from simplellminference_tpu_torch.ops.ref_ops import to_e4m3
from simplellminference_tpu_torch.runtime.generator import Generator

L, P, KVN, PS, D = 3, 12, 2, 8, 16
TOL = 1e-5
E4 = torch.float8_e4m3fn
# row 1 has an unmapped tail, row 2 is an inactive slot (all -1)
TABLES = np.array([[3, 7, 1, 4], [0, 11, -1, -1], [-1, -1, -1, -1]],
                  np.int32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def jax_e4(u8):
    """uint8 codes (numpy) -> a JAX float8_e4m3fn array."""
    return jnp.asarray(u8).view(jnp.float8_e4m3fn)


def torch_e4(u8):
    return t(u8.copy()).view(E4)


def codes(x) -> np.ndarray:
    """The bytes of an e4m3 array of either package."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def e4m3_pools(rng, layers=L, pages=P + 1, kvn=KVN, ps=PS, d=D):
    """Pools of e4m3 codes (uint8) of N(0, 2^2) K/V values, as the Engine
    fills them: pages a write does not touch must come back unchanged."""
    shape = (layers, pages, kvn, ps, d)
    return tuple(codes(to_e4m3(t(rand(rng, *shape, scale=2.0))))
                 for _ in range(2))


def rows(rng, shape, dtype):
    """New K/V rows of magnitudes 1e-4..1e3, so that some pass 464 (NaN
    in JAX's cast) and some fall in e4m3's subnormals, as one array for
    each package (bf16 rounded once, on the torch side)."""
    x = rand(rng, *shape) * np.exp(rng.uniform(-9, 7, shape)).astype(
        np.float32)
    if dtype == "bf16":
        tx = t(x).bfloat16()
        return tx, jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16)
    return t(x), jnp.asarray(x)


def assert_pools_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(codes(g)[:, :-1], codes(w)[:, :-1])


# --------------------------------------------------------------- the cast

def test_to_e4m3_matches_jax_over_every_bf16_pattern():
    pat = torch.arange(-32768, 32768, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    got = to_e4m3(pat)
    assert got.dtype == E4 and got.shape == pat.shape
    want = jnp.asarray(pat.view(torch.int16).numpy()).view(
        jnp.bfloat16).astype(jnp.float8_e4m3fn)
    np.testing.assert_array_equal(codes(got), codes(want))


def test_to_e4m3_matches_jax_f32_edges_and_random_bits():
    edges = np.array([448, 464, np.nextafter(np.float32(464), 1e9), 480,
                      479.9, 500, 1e4, np.inf, np.nan, 0.0, 2.0 ** -9,
                      2.0 ** -10, 2.0 ** -10 * 1.0001, 3 * 2.0 ** -10,
                      2.0 ** -6, 2.0 ** -6 * 0.99, 1e-40, 240, 232, 248,
                      1.0625, 1.1875], np.float32)
    edges = np.concatenate([edges, -edges])
    bits = np.random.default_rng(0).integers(0, 2 ** 32, 200_000,
                                             dtype=np.uint64)
    x = np.concatenate([edges, bits.astype(np.uint32).view(np.float32)])
    got = codes(to_e4m3(t(x)))
    want = codes(jnp.asarray(x).astype(jnp.float8_e4m3fn))
    np.testing.assert_array_equal(got, want)
    # JAX's cast: 464 rounds to the even 448, past it NaN with the sign
    assert got[:4].tolist() == [0x7E, 0x7E, 0x7F, 0x7F]
    assert got[len(edges) // 2 + 2] == 0xFF


def test_pool_codes():
    assert [cuda_build.pool_code(d) for d in (
        torch.float32, torch.bfloat16, torch.int8, E4)] == [0, 1, 2, 3]
    with pytest.raises(TypeError, match="KV pools"):
        cuda_build.pool_code(torch.float16)


# -------------------------------------------------------------- the writes

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s,offset", [(16, None), (13, None), (1, None),
                                      (9, 1), (5, [0, 1, 3])],
                         ids=["full", "ragged", "one", "offset", "offsets"])
def test_write_prefill_e4m3_matches_jax(dtype, s, offset):
    rng = np.random.default_rng(s)
    pools = e4m3_pools(rng)
    tk, jk = rows(rng, (3, s, KVN, D), dtype)
    tv, jv = rows(rng, (3, s, KVN, D), dtype)
    po = None if offset is None else np.asarray(offset, np.int32)
    want = jpkv.write_prefill_stacked(
        jax_e4(pools[0]), jax_e4(pools[1]), jk, jv, jnp.asarray(TABLES),
        jnp.int32(1), page_offset=None if po is None else jnp.asarray(po))
    tp = [torch_e4(p) for p in pools]
    got = tpkv.write_prefill_stacked(
        tp[0], tp[1], tk, tv, t(TABLES), 1,
        page_offset=(None if po is None else int(po) if po.ndim == 0
                     else t(po)))
    assert got[0] is tp[0] and got[1] is tp[1] and got[2] is None
    assert_pools_equal(tp, want[:2])


def test_write_prefill_e4m3_pads_last_page_with_zero_codes():
    rng = np.random.default_rng(3)
    pools = [torch_e4(p) for p in e4m3_pools(rng)]
    nk = t(rand(rng, 1, 5, KVN, D) * 600)
    tpa.paged_append_prefill_ref(*pools, nk, nk, torch.tensor([[6]]), 0)
    page = codes(pools[0])[0, 6]
    np.testing.assert_array_equal(page[:, :5], codes(to_e4m3(
        nk[0].transpose(0, 1))))
    assert not page[:, 5:].any()
    assert (page[:, :5] & 0x7F == 0x7F).any()    # rows past 464: NaN


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_write_decode_e4m3_matches_jax(dtype):
    rng = np.random.default_rng(1)
    pools = e4m3_pools(rng)
    tk, jk = rows(rng, (3, KVN, D), dtype)
    tv, jv = rows(rng, (3, KVN, D), dtype)
    positions = np.array([17, 9, 4], np.int32)   # page 1 slot 1; page 11; dead
    want = jpkv.write_decode_stacked(
        jax_e4(pools[0]), jax_e4(pools[1]), jk, jv, jnp.asarray(TABLES),
        jnp.asarray(positions), jnp.int32(2))
    tp = [torch_e4(p) for p in pools]
    before = tpa.paged_append_decode_fp8kv.launches
    got = tpkv.write_decode_stacked(tp[0], tp[1], tk, tv, t(TABLES),
                                    t(positions), 2)
    assert tpa.paged_append_decode_fp8kv.launches == before   # plain on CPU
    assert got[0] is tp[0] and got[2] is None
    assert_pools_equal(tp, want[:2])
    np.testing.assert_array_equal(codes(tp[0])[2, 1, :, 1],
                                  codes(to_e4m3(tk[0])))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("span", [1, 5])
def test_write_span_e4m3_matches_jax(dtype, span):
    rng = np.random.default_rng(20 + span)
    pools = e4m3_pools(rng, pages=13)
    tables = np.array([[3, 7, 1], [0, 11, -1], [-1, -1, -1], [5, 2, 9]],
                      np.int32)
    positions = np.array([6, 12, 0, 21], np.int32)
    tk, jk = rows(rng, (4, span, KVN, D), dtype)
    tv, jv = rows(rng, (4, span, KVN, D), dtype)
    want = jpkv.write_span_stacked(
        jax_e4(pools[0]), jax_e4(pools[1]), jk, jv, jnp.asarray(tables),
        jnp.asarray(positions), jnp.int32(0))
    tp = [torch_e4(p) for p in pools]
    tpkv.write_span_stacked(tp[0], tp[1], tk, tv, t(tables), t(positions), 0)
    assert_pools_equal(tp, want[:2])


def test_gather_dense_e4m3_matches_jax():
    rng = np.random.default_rng(2)
    pk, pv = e4m3_pools(rng)
    jk, jv = jpkv.gather_dense(jax_e4(pk[0]), jax_e4(pv[0]),
                               jnp.asarray(TABLES))
    tk, tv = tpkv.gather_dense(torch_e4(pk[0]), torch_e4(pv[0]), t(TABLES))
    mapped = np.repeat(TABLES >= 0, PS, axis=1)          # [B, MP*ps]
    for g, w in ((tk, jk), (tv, jv)):
        assert g.dtype == torch.float32                  # exact values
        g = g.numpy().transpose(0, 2, 1, 3)
        w = np.asarray(w.astype(jnp.float32)).transpose(0, 2, 1, 3)
        np.testing.assert_array_equal(g[mapped], w[mapped])
        assert not g[~mapped].any()


def test_cache_create_e4m3_has_no_scale_pools_and_no_window_group():
    """e4m3 pools have no scale pools; their windowed group (the grouped
    engine's ring pools) is zeroed e4m3 pools with none either, as JAX's
    ``with_windowed`` builds them."""
    c = tpkv.PagedKVCache.create(2, 5, 3, 8, 16, E4, device="cpu")
    assert c.k.dtype == c.v.dtype == E4 and c.k.shape == (2, 6, 3, 8, 16)
    assert c.k_scale is None and c.v_scale is None
    assert not c.k.view(torch.uint8).any()
    assert tpkv.kv_storage_dtype("fp8") == E4
    assert c.k_w is None
    w = c.with_windowed(1, 4)
    jw = jpkv.PagedKVCache.create(2, 5, 3, 8, 16,
                                  jnp.float8_e4m3fn).with_windowed(1, 4)
    for got, want in ((w.k_w, jw.k_w), (w.v_w, jw.v_w)):
        assert got.dtype == E4 and got.shape == want.shape == (1, 5, 3, 8, 16)
        np.testing.assert_array_equal(codes(got), codes(want))
    assert w.k_w_scale is None and w.v_w_scale is None
    assert jw.k_w_scale is None and jw.v_w_scale is None
    assert w.k is c.k and w.v is c.v


# ------------------------------------------------------------ attention

def _decode_case(rng, b, n, kvn, d, ps, mp, lens):
    p = b * mp + 1
    pk, pv = e4m3_pools(rng, 2, p, kvn, ps, d)
    tables = (rng.permutation(p - 1)[:b * mp]).astype(np.int32).reshape(
        b, mp)
    lens = np.asarray(lens, np.int32)
    tables[lens == 0] = -1                        # dead slots: all -1
    return rand(rng, b, n, d), pk, pv, tables, lens


@pytest.mark.parametrize("n,kvn,d", [(4, 2, 32), (4, 4, 64), (8, 1, 32)],
                         ids=["gqa", "mha", "mqa"])
def test_paged_flash_decode_e4m3_matches_jax_kernel(n, kvn, d):
    rng = np.random.default_rng(n * kvn + d)
    q, pk, pv, tables, lens = _decode_case(rng, 4, n, kvn, d, 8, 5,
                                           [1, 17, 40, 0])
    got = tpd.paged_flash_decode_fp8kv(t(q), torch_e4(pk), torch_e4(pv),
                                       t(tables), t(lens), 1)
    want = jax_paged_flash_decode(
        jnp.asarray(q), jax_e4(pk), jax_e4(pv), jnp.asarray(tables),
        jnp.asarray(lens), interpret=True, layer=jnp.int32(1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    cfg, jcfg = ModelConfig.tiny_test(), JaxModelConfig.tiny_test()
    via = dispatch.attention_paged(cfg, t(q)[:, None], torch_e4(pk),
                                   torch_e4(pv), t(tables), t(lens), 1)
    jvia = jdispatch.attention_paged(
        jcfg, jnp.asarray(q)[:, None], jax_e4(pk), jax_e4(pv),
        jnp.asarray(tables), jnp.asarray(lens), layer=jnp.int32(1))
    live = lens > 0
    np.testing.assert_allclose(via.numpy()[live], np.asarray(jvia)[live],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s", [1, 2, 5])
def test_paged_flash_verify_e4m3_matches_jax_kernel(s):
    rng = np.random.default_rng(30 + s)
    _, pk, pv, tables, lens = _decode_case(rng, 4, 4, 2, 32, 8, 5,
                                           [s + 3, 17, 33, 0])
    q = rand(rng, 4, s, 4, 32)
    got = tpd.paged_flash_verify_fp8kv(t(q), torch_e4(pk), torch_e4(pv),
                                       t(tables), t(lens), 1)
    want = jax_paged_flash_verify(
        jnp.asarray(q), jax_e4(pk), jax_e4(pv), jnp.asarray(tables),
        jnp.asarray(lens), interpret=True, layer=jnp.int32(1))
    live = lens > 0
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               rtol=TOL, atol=TOL)
    assert not got.numpy()[~live].any()


@pytest.mark.parametrize("b,s,n,kvn,d,ps", [
    (2, 32, 4, 2, 32, 8),
    (1, 64, 4, 4, 64, 16),
], ids=["gqa", "mha"])
def test_paged_flash_prefill_e4m3_matches_jax_kernel(b, s, n, kvn, d, ps):
    rng = np.random.default_rng(b * s + n)
    mp = 2 * s // ps
    p = b * mp + 1
    pk, pv = e4m3_pools(rng, 2, p, kvn, ps, d)
    q = rand(rng, b, s, n, d)
    offs = np.asarray([(i % 2) * ps for i in range(b)], np.int32)
    kv = (offs + rng.integers(1, s + 1, size=b)).astype(np.int32)
    tables = (rng.permutation(p - 1)[:b * mp]).astype(np.int32).reshape(
        b, mp)
    got = tpp.paged_flash_prefill_fp8kv(t(q), torch_e4(pk), torch_e4(pv),
                                        t(tables), t(kv), t(offs), 1)
    want = jax_paged_flash_prefill(
        jnp.asarray(q), jax_e4(pk), jax_e4(pv), jnp.asarray(tables),
        jnp.asarray(kv), jnp.asarray(offs), bq=s, interpret=True,
        layer=jnp.int32(1))
    assert torch.isfinite(got).all()
    for i in range(b):
        valid = int(kv[i] - offs[i])
        np.testing.assert_allclose(got[i, :valid].numpy(),
                                   np.asarray(want)[i, :valid], rtol=TOL,
                                   atol=TOL)
    via = dispatch.attention_paged_prefill(
        ModelConfig.tiny_test(), t(q), torch_e4(pk), torch_e4(pv),
        t(tables), t(kv), t(offs), 1)
    assert torch.equal(via, got)


def test_e4m3_pools_with_a_window_raise():
    """e4m3 pools with a window (4ew, 4vew, 8ew) once raised; they now run
    and match the JAX kernels in interpret mode. The FP8-KV wrappers still
    refuse pools that are not e4m3."""
    rng = np.random.default_rng(9)
    q, pk, pv, tables, lens = _decode_case(rng, 2, 4, 2, 32, 8, 2, [3, 9])
    args = (torch_e4(pk), torch_e4(pv), t(tables), t(lens), 0)
    jargs = (jax_e4(pk), jax_e4(pv), jnp.asarray(tables), jnp.asarray(lens))
    got = tpd.paged_flash_decode(t(q), *args, window=4)
    want = jax_paged_flash_decode(jnp.asarray(q), *jargs, window=4,
                                  interpret=True, layer=jnp.int32(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    got = tpd.paged_flash_verify(t(q)[:, None], *args, window=4)
    want = jax_paged_flash_verify(jnp.asarray(q)[:, None], *jargs, window=4,
                                  interpret=True, layer=jnp.int32(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    got = tpp.paged_flash_prefill(t(q)[:, None], args[0], args[1], args[2],
                                  args[3], t(lens) - 1, 0, window=4)
    want = jax_paged_flash_prefill(
        jnp.asarray(q)[:, None], *jargs, jnp.asarray(lens - 1), bq=1,
        window=4, interpret=True, layer=jnp.int32(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        tpd.paged_flash_decode_fp8kv(t(q), torch_e4(pk).float(),
                                     torch_e4(pv).float(), *args[2:])


# -------------------------------------------------------- the fused qkv

def _qkv_case(seed, n, kvn, dtype):
    rng = np.random.default_rng(seed)
    lyr, h, d, ps, mp, b, li = 2, 128, 32, 16, 3, 3, 1
    nq = (n + 2 * kvn) * d
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
    # row 2's page for position 40 is unmapped: it writes to the trash page
    tables = np.asarray([[3, 7, 1], [0, 5, 8], [2, 4, -1]], np.int32)
    pools = e4m3_pools(rng, lyr, p1, kvn, ps, d)
    written = np.zeros((lyr, p1, kvn, ps), bool)
    for r in range(b):
        page = tables[r, pos[r] // ps]
        written[li, page if page >= 0 else p1 - 1, :, pos[r] % ps] = True
    return dict(wq=wq, ws=ws, nw=nw, xt=xt, xj=xj, pos=pos, tables=tables,
                pools=pools, written=written, n=n, kvn=kvn, d=d, li=li)


def _port_fused(c):
    sin, cos = jref.rope_tables(jnp.asarray(c["pos"]), c["d"], 10000.0)
    tp = [torch_e4(p) for p in c["pools"]]
    q, *out = tqkv.fused_qkv_append(
        c["xt"], t(c["nw"]), t(c["wq"]), t(c["ws"]), t(np.array(sin)),
        t(np.array(cos)), tp[0], tp[1], c["li"], t(c["pos"]),
        n_heads=c["n"], kv_heads=c["kvn"], eps=1e-5, tables=t(c["tables"]))
    assert all(a is b for a, b in zip(out, tp))
    return q, tp, (sin, cos)


def _ordinal(u8):
    """e4m3 codes in value order: +-0 both 0, one step per code."""
    mag = (u8 & 0x7F).astype(int)
    return np.where(u8 & 0x80, -mag, mag)


@pytest.mark.parametrize("n,kvn", [(4, 2), (4, 4)], ids=["gqa", "mha"])
def test_fused_qkv_append_e4m3_matches_jax_unfused_f32(n, kvn):
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
        jax_e4(c["pools"][0]), jax_e4(c["pools"][1]), k, v,
        jnp.asarray(c["tables"]), jnp.asarray(c["pos"]), jnp.int32(li))
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q), rtol=TOL,
                               atol=TOL * float(np.abs(np.asarray(q)).max()))
    assert float(np.abs(np.asarray(k)).max()) > 464      # NaN rows too
    assert_pools_equal(tp, want[:2])
    assert c["written"][li, -1].any()         # the trash page took row 2


@pytest.mark.parametrize("n,kvn", [(4, 2), (4, 4)], ids=["gqa", "mha"])
def test_fused_qkv_append_e4m3_matches_jax_kernel_bf16(n, kvn):
    c = _qkv_case(10 + n + kvn, n, kvn, "bf16")
    q_t, tp, (sin, cos) = _port_fused(c)
    q_j, *want = jqkv.fused_qkv_append(
        c["xj"], jnp.asarray(c["nw"]), jnp.asarray(c["wq"]),
        jnp.asarray(c["ws"]), sin, cos, jax_e4(c["pools"][0]),
        jax_e4(c["pools"][1]), jnp.int32(c["li"]), jnp.asarray(c["pos"]),
        n_heads=n, kv_heads=kvn, eps=1e-5,
        tables=jnp.asarray(c["tables"]), interpret=True)
    assert q_t.dtype == torch.bfloat16
    want_q = np.asarray(q_j, np.float32)
    np.testing.assert_allclose(q_t.float().numpy(), want_q, rtol=0,
                               atol=2e-2 * float(np.std(want_q)))
    w = c["written"][..., None].repeat(c["d"], -1)
    for g, j in zip(tp, want):
        g, j = codes(g), codes(j)
        np.testing.assert_array_equal(g[~w], j[~w])
        assert np.abs(_ordinal(g[w]) - _ordinal(j[w])).max() <= 1


def test_fused_qkv_append_e4m3_refuses_dense_arena_and_kv_layer():
    """e4m3 pools on the dense arena once raised; that form (6de) now
    runs and writes, at arena row r's slot pos[r], the codes the paged
    form writes at row r's page slot, with the same q (against JAX's
    dense kernel: tests/test_torch_fp8kv_dense.py); every other arena
    byte unchanged. With a ``kv_layer`` (6ek, the grouped engine's e4m3
    ring pools) the form runs: the weights of ``layer``, the rows written
    at ``kv_layer`` with the bytes the coupled call writes at ``layer``,
    every other pool byte unchanged (against JAX's kernel:
    tests/test_torch_fp8kv_sinks_window.py)."""
    c = _qkv_case(0, 4, 2, "f32")
    pk, pv = (torch_e4(p) for p in c["pools"])
    args = (c["xt"], t(c["nw"]), t(c["wq"]), t(c["ws"]), torch.zeros(3, 16),
            torch.ones(3, 16), pk, pv, 1, t(c["pos"]))
    rng = np.random.default_rng(5)
    ak, av = e4m3_pools(rng, 2, 3, 2, 48, 32)       # [L, 3 rows, kvN, 48, D]
    dense = [torch_e4(ak), torch_e4(av)]
    q_d, *out_d = tqkv.fused_qkv_append(*args[:6], *dense, 1, t(c["pos"]))
    assert all(a is b for a, b in zip(out_d, dense))
    paged = [torch_e4(p) for p in c["pools"]]
    q_p, *_ = tqkv.fused_qkv_append(*args[:6], *paged, 1, t(c["pos"]),
                                    tables=t(c["tables"]))
    assert torch.equal(q_d, q_p)
    p1, ps = paged[0].shape[1], paged[0].shape[3]
    for got, old, pp in zip(dense, (ak, av), paged):
        want = old.copy()
        for r, pos in enumerate(c["pos"]):
            page = c["tables"][r, pos // ps]
            page = page if page >= 0 else p1 - 1
            want[1, r, :, pos] = codes(pp)[1, page, :, pos % ps]
        np.testing.assert_array_equal(codes(got), want)
    before = [codes(p).copy() for p in (pk, pv)]
    q_k, *out_k = tqkv.fused_qkv_append(*args, tables=t(c["tables"]),
                                        kv_layer=0)
    assert all(a is b for a, b in zip(out_k, (pk, pv)))
    coupled = [torch_e4(p) for p in c["pools"]]
    q_c, *_ = tqkv.fused_qkv_append(*args[:6], *coupled, 1, t(c["pos"]),
                                    tables=t(c["tables"]))
    assert torch.equal(q_k, q_c)
    w = c["written"][1]
    for got, cpl, old in zip((pk, pv), coupled, before):
        got = codes(got)
        np.testing.assert_array_equal(got[0][w], codes(cpl)[1][w])
        np.testing.assert_array_equal(got[0][~w], old[0][~w])
        np.testing.assert_array_equal(got[1:], old[1:])


def test_generator_refuses_e4m3_arena():
    """An e4m3 arena once raised in the Generator; it now runs (12e, 13e),
    and one greedy step over it gives JAX's token (its Generator over a
    ``jnp.float8_e4m3fn`` arena); the full runs are in
    tests/test_torch_fp8kv_dense.py."""
    jcfg = JaxModelConfig.tiny_test()
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(4))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    prompts = [[5, 9, 2, 44], [33, 4, 250, 1, 2, 3]]
    gen = Generator(ModelConfig.tiny_test(), tp, max_batch=2, max_seq=64,
                    kv_dtype=E4, device="cpu")
    assert gen.kv_dtype == E4 and gen.new_cache(2, 16).k.dtype == E4
    got = gen.generate(prompts, SamplingParams(max_new_tokens=2))
    want = JaxGenerator(jcfg, jp, max_batch=2, max_seq=64,
                        kv_dtype=jnp.float8_e4m3fn).generate(
        prompts, JaxSampling(max_new_tokens=2))
    assert got.token_ids == want.token_ids and got.steps == 2
