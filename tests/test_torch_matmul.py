"""The port's INT8 weight path (quantization helpers, QuantizedWeight,
quantized_matmul's plain version, linear, quantize_params) against the
JAX package on the CPU.

Inputs come from numpy with fixed seeds. Stated tolerances: against the
JAX Pallas kernel run in interpret mode (bf16 activations, bf16 output),
one bf16 ulp of the output (both sum exact products in f32, in different
orders, then round once); against ``quantized_matmul_ref`` in f32, 1e-5;
integer-valued inputs with power-of-two scales make every sum exact, so
there the port equals the reference bit for bit (K % 128 != 0 included,
where the TPU wrapper drops the K remainder). Quantization is byte-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.core.config import QuantConfig as JaxQuantConfig
from simplellminference_tpu.ops import linear as jlinear
from simplellminference_tpu.ops import ref_ops as jref
from simplellminference_tpu.ops.matmul import quantized_matmul as jqmm
from simplellminference_tpu.runtime.weights import (
    quantize_params as jquantize_params)
from simplellminference_tpu_torch.core.config import QuantConfig
from simplellminference_tpu_torch.ops import linear as tlinear
from simplellminference_tpu_torch.ops import matmul as tmm
from simplellminference_tpu_torch.runtime.weights import quantize_params


def _qweights(rng, k, n, groups, layers=None):
    lead = () if layers is None else (layers,)
    q = rng.integers(-127, 128, (*lead, k, n)).astype(np.int8)
    s = (rng.uniform(0.5, 2.0, (*lead, groups, n)) * 1e-2).astype(np.float32)
    return q, s


def _bf16_ulp(a):
    a = np.maximum(np.abs(a), np.float32(2.0 ** -100))
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("groups", [1, 2], ids=["per-channel", "group128"])
def test_plain_matches_jax_kernel_bf16(groups):
    rng = np.random.default_rng(groups)
    m, k, n = 16, 256, 256
    q, s = _qweights(rng, k, n, groups)
    xt = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                          ).bfloat16()
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jqmm(xj, jnp.asarray(q), jnp.asarray(s),
                           out_dtype=jnp.bfloat16, interpret=True),
                      np.float32)
    got = tmm.quantized_matmul(xt, torch.from_numpy(q), torch.from_numpy(s),
                               out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    got = got.float().numpy()
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize("groups,layer", [(1, None), (4, None), (1, 1),
                                          (2, 2)])
def test_plain_matches_jax_ref_f32(groups, layer):
    rng = np.random.default_rng(10 + groups)
    k, n = 256, 96
    q, s = _qweights(rng, k, n, groups, layers=None if layer is None else 3)
    x = rng.standard_normal((2, 5, k)).astype(np.float32)
    ql, sl = (q, s) if layer is None else (q[layer], s[layer])
    want = jref.quantized_matmul_ref(jnp.asarray(x), jnp.asarray(ql),
                                     jnp.asarray(sl), out_dtype=jnp.float32)
    got = tmm.quantized_matmul(torch.from_numpy(x), torch.from_numpy(q),
                               torch.from_numpy(s), out_dtype=torch.float32,
                               layer=layer)
    assert got.shape == (2, 5, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("k,groups", [(200, 1), (200, 5), (72, 3)])
def test_exact_for_k_not_a_multiple_of_128(k, groups):
    rng = np.random.default_rng(k + groups)
    n = 48
    q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = np.exp2(-rng.integers(4, 9, (groups, n))).astype(np.float32)
    x = rng.integers(-3, 4, (7, k)).astype(np.float32)
    want = np.asarray(jref.quantized_matmul_ref(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
        out_dtype=jnp.float32))
    got = tmm.quantized_matmul(torch.from_numpy(x), torch.from_numpy(q),
                               torch.from_numpy(s), out_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    if groups == 1:
        # what a K tile of 128 that drops the remainder would give
        cut = (k // 128) * 128 or 64
        part = x[:, :cut] @ q[:cut].astype(np.float32) * s[0]
        assert not np.array_equal(part, want)


@pytest.mark.parametrize("group", [64, 256])
def test_quantize_dequantize_byte_equal_to_jax(group):
    rng = np.random.default_rng(group)
    w = rng.standard_normal((2, 256, 40)).astype(np.float32)
    w[0, :64, 0] = 0.0                      # an all-zero group: scale 1e-8
    jw = jlinear.QuantizedWeight.quantize(jnp.asarray(w), group)
    tw = tlinear.QuantizedWeight.quantize(torch.from_numpy(w), group)
    assert tw.q.dtype == torch.int8 and tw.scales.dtype == torch.float32
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    np.testing.assert_array_equal(tw.scales.numpy(), np.asarray(jw.scales))
    assert tw.shape == jw.shape and tw.group_size == jw.group_size == group
    np.testing.assert_array_equal(tw.dequantize().numpy(),
                                  np.asarray(jw.dequantize()))


@pytest.mark.parametrize("group_size,lm_head", [(0, True), (64, False),
                                                (96, True)])
def test_quantize_params_byte_equal_to_jax(group_size, lm_head):
    rng = np.random.default_rng(group_size)
    h, i, v, nq, L = 128, 192, 64, 96, 2
    tree = {"embed": rng.standard_normal((v, h)).astype(np.float32),
            "layers": {"input_norm": np.ones((L, h), np.float32),
                       "wqkv": rng.standard_normal((L, h, nq)
                                                   ).astype(np.float32),
                       "w_down": rng.standard_normal((L, i, h)
                                                     ).astype(np.float32)},
            "final_norm": np.ones((h,), np.float32),
            "lm_head": rng.standard_normal((h, v)).astype(np.float32)}
    jq = jquantize_params(jax.tree.map(jnp.asarray, tree), JaxQuantConfig(
        mode="int8", group_size=group_size, quantize_lm_head=lm_head))
    tp = {"embed": torch.from_numpy(tree["embed"]),
          "layers": {k: torch.from_numpy(a)
                     for k, a in tree["layers"].items()},
          "final_norm": torch.from_numpy(tree["final_norm"]),
          "lm_head": torch.from_numpy(tree["lm_head"])}
    tq = quantize_params(tp, QuantConfig(mode="int8", group_size=group_size,
                                         quantize_lm_head=lm_head))
    for name in ("wqkv", "w_down"):
        jw, tw = jq["layers"][name], tq["layers"][name]
        assert isinstance(tw, tlinear.QuantizedWeight)
        np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
        np.testing.assert_array_equal(tw.scales.numpy(),
                                      np.asarray(jw.scales))
    assert torch.equal(tq["layers"]["input_norm"], tp["layers"]["input_norm"])
    if lm_head:
        np.testing.assert_array_equal(tq["lm_head"].q.numpy(),
                                      np.asarray(jq["lm_head"].q))
    else:
        assert isinstance(tq["lm_head"], torch.Tensor)


def test_quantize_params_refuses_int4():
    # mode="int4" is served (tests/test_torch_int4.py); an odd K has no
    # split-half packing (the JAX package asserts it)
    p = {"layers": {"wo": torch.zeros(1, 7, 8)}}
    with pytest.raises(ValueError, match="even K"):
        quantize_params(p, QuantConfig(mode="int4"))


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("out", [None, "float32"])
def test_linear_int8_matches_jax(stacked, out):
    rng = np.random.default_rng(3)
    k, n = 128, 40
    q, s = _qweights(rng, k, n, 1, layers=2 if stacked else None)
    x = rng.standard_normal((3, 2, k)).astype(np.float32)
    layer = 1 if stacked else None
    jw = jlinear.QuantizedWeight(q=jnp.asarray(q), scales=jnp.asarray(s))
    tw = tlinear.QuantizedWeight(q=torch.from_numpy(q),
                                 scales=torch.from_numpy(s))
    want = jlinear.linear(jnp.asarray(x), jw, out_dtype=out and jnp.float32,
                          layer=None if layer is None else jnp.int32(layer))
    got = tlinear.linear(torch.from_numpy(x), tw,
                         out_dtype=out and torch.float32, layer=layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kw,feature", [
    (dict(bits=3), "INT4"),
    (dict(n_size=128), "n_start/n_size"),
    (dict(zs=torch.zeros(1, 8)), "zero points"),
])
def test_quantized_matmul_unported_options_raise(kw, feature):
    # INT4 (bits=4, with or without zs) is served (tests/test_torch_int4.py)
    # and zero points on 8-bit weights are refused as the JAX package
    # asserts (ValueError); other widths and the ring matmul's column
    # chunks are not ported
    err = ValueError if "zs" in kw else NotImplementedError
    with pytest.raises(err, match=feature):
        tmm.quantized_matmul(torch.zeros(2, 8), torch.zeros(8, 8,
                                                            dtype=torch.int8),
                             torch.ones(1, 8), **kw)


@pytest.mark.parametrize("m,k,n", [(8, 4096, 4096), (8, 4096, 32000),
                                   (1, 11008, 4096), (3, 72, 40)])
def test_rows_split_covers_k(m, k, n):
    kch = tmm.rows_split(m, k, n)
    chunks = -(-k // kch)
    assert 1 <= kch <= k and (chunks - 1) * kch < k <= chunks * kch
    blocks = chunks * -(-n // tmm.ROWS_COLS)
    assert blocks >= min(2 * tmm.SM_COUNT, -(-k // tmm.ROWS_MIN_K)
                         * -(-n // tmm.ROWS_COLS))


@pytest.mark.parametrize("m,k,n,group,dtype,want", [
    (8, 4096, 4096, 4096, torch.bfloat16, "rmma"),     # decode: M <= 8
    (8, 4096, 4096, 4096, torch.float32, "rows"),
    (8, 4096, 4096, 128, torch.bfloat16, "rows"),      # grouped, M <= 8
    (8, 4096, 4000, 4096, torch.bfloat16, "rows"),     # N % 64 != 0
    (9, 4096, 4096, 4096, torch.bfloat16, "mma"),      # the first mma row
    (40, 4096, 32000, 4096, torch.bfloat16, "mma"),    # verify head
    (1024, 4096, 12288, 128, torch.bfloat16, "mma"),   # group 128
    (256, 4096, 6144, 64, torch.bfloat16, "mma"),      # group 64
    (256, 4096, 6144, 32, torch.bfloat16, "fma"),      # group 32: off-slab
    (1024, 4096, 12288, 4096, torch.float32, "fma"),   # f32 activations
    (100, 1000, 2048, 125, torch.bfloat16, "fma"),     # off-slab group
    (100, 1000, 2048, 8, torch.bfloat16, "fma"),       # group of 8 rows
    (70, 300, 136, 300, torch.bfloat16, "fma"),        # N % 16 != 0
    (70, 300, 4096, 300, torch.bfloat16, "fma"),       # K % 8 != 0
])
def test_tiled_regime_from_dtype_and_shape(m, k, n, group, dtype, want):
    assert tmm.tiled_regime(m, k, n, group, dtype) == want
    # the CPU takes the plain version: no kernel launches, no count moves
    before = dict(tmm.REGIME_LAUNCHES)
    x = torch.zeros((min(m, 9), k), dtype=dtype)
    tmm.quantized_matmul(x, torch.zeros((k, 32), dtype=torch.int8),
                         torch.ones((1, 32)))
    assert tmm.REGIME_LAUNCHES == before


@pytest.mark.parametrize("m,k,n,group", [
    (1024, 4096, 12288, 4096), (40, 4096, 4096, 4096),
    (40, 4096, 32000, 4096), (256, 14336, 4096, 14336),
    (256, 4096, 6144, 32), (64, 4000, 4096, 4000), (100, 512, 384, 128),
    (9, 40, 16, 40), (1000, 4096, 4000, 32)])
def test_mma_split_covers_k_on_slab_and_group_edges(m, k, n, group):
    wm, kch = tmm.mma_split(m, k, n, group)
    assert wm == (2 if m >= 128 else 1)
    assert kch % tmm.MMA_BK == 0 and (group >= k or kch % group == 0)
    chunks = -(-k // kch)
    assert (chunks - 1) * kch < k <= chunks * kch
    tiles = -(-n // tmm.MMA_BN) * -(-m // (64 * wm))
    target = tmm.SM_COUNT * (1 if wm == 2 else 2)
    # one wave of blocks at most, at least 256 rows a block
    assert chunks <= max(1, min(target // tiles, k // tmm.MMA_MIN_K))


def _mma_order(x, q, s, kch):
    """The mma kernel's sums in f32 (plain torch): K blocks of kch rows,
    their f32 partials added in block order as qmm_finish adds them; in a
    block, exact bf16 products summed per scale group, each group's
    partial times its scale (grouped), or the blocks' total times the
    per-channel scale once."""
    k = q.shape[0]
    g = s.shape[0]
    gs = k // g
    xf, qf, sf = x.float(), q.float(), s.float()
    total = torch.zeros((x.shape[0], q.shape[1]))
    for k0 in range(0, k, kch):
        k1 = min(k, k0 + kch)
        if g == 1:
            total = total + xf[:, k0:k1] @ qf[k0:k1]
            continue
        block = torch.zeros_like(total)
        for g0 in range(k0, k1, gs):
            block = block + (xf[:, g0:g0 + gs] @ qf[g0:g0 + gs]) * sf[g0 // gs]
        total = total + block
    return total * sf[0] if g == 1 else total


@pytest.mark.parametrize("group", [32, 64, 128, 512],
                         ids=["g32", "g64", "g128", "per-channel"])
@pytest.mark.parametrize("m", [40, 128])
def test_group_partial_order_matches_jax_kernel(group, m):
    rng = np.random.default_rng(group + m)
    k, n = 512, 256
    q, s = _qweights(rng, k, n, k // group)
    xt = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                          ).bfloat16()
    _wm, kch = tmm.mma_split(m, k, n, group)
    got = _mma_order(xt, torch.from_numpy(q), torch.from_numpy(s), kch)
    want = np.asarray(jqmm(jnp.asarray(xt.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(q), jnp.asarray(s),
        out_dtype=jnp.float32, interpret=True))
    lim = 1e-5 * float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= lim
    # and the port's plain version (per-group partials in one block)
    plain = tmm.quantized_matmul(xt, torch.from_numpy(q), torch.from_numpy(s),
                                 out_dtype=torch.float32)
    assert float((got - plain).abs().max()) <= lim
