"""The tensor-core designs of the port's fused qkv (kernel 6m, every form of
``fused_qkv_append`` on bf16 rows) and of kernel 5's few-rows regime (5r,
``quantized_matmul`` at M <= 8 with bf16 rows) on the CPU.

Both stream the int8 weight through ``csrc/int8_mma_rows.cuh`` (the header
of kernel 7m, whose conversion and fragment mapping
tests/test_torch_ffn_tiles.py holds): ``mma.sync.m16n8k16`` with the weight
as A, all rows in one pass, a block of 4 warps on two 64-column groups and
a K range, K split over blocks from shapes, the last block at a column
tile adding the partials in block order. 6m's block takes 128 contiguous
qkv columns (whole heads at D 32, 64 and 128), runs the rmsnorm once per
row before it (bf16 ``xn``) and finishes the tile: per-channel scale, RoPE
in f32, q in bf16, k/v into their slots or, INT8 KV, rounded to bf16 and
quantized with ``quantize_kv``'s math. 5r's block takes 128 output columns
(the second group zero past an odd multiple of 64) and finishes with the
per-channel scale and one rounding to the output dtype.

The kernels run only on the card; here (a) the tail's pairs (c, c + D/2)
cover a block's 128 columns once, each pair and each group of four in one
head, and every INT8-KV head of a block lies whole in it at the model
shapes; (b) the kernels' f32 order over bf16 inputs (16-row k-step sums
into the two K warps' accumulators, the warps' sums added, the K-split
partials added in block order, then the scale, RoPE and the rounding or
quantizing) agrees on the same bf16 intermediates with the port's plain
versions and with the JAX package's plain product within 1e-5 of the
largest magnitude (q, k and v in f32; 5r's f32 outputs, and its bf16
outputs within one bf16 ulp beyond that), and end to end with the JAX
``fused_qkv_append`` and ``quantized_matmul`` in interpret mode within
tests/test_torch_fused.py's 2e-2 of the standard deviation (6m, whose
normalized rows round to bf16 on both sides) and 1e-5 of the largest
(5r), INT8-KV codes at most 1 apart; (c) ``qkv_regime``, ``qkv_split``,
``tiled_regime``'s "rmma" branch and ``rows_mma_split`` send the 7B and
Mistral shapes to the tensor cores and f32 rows and misfit shapes to the
FMA kernels, and the splits cover K in whole 64-row stages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.ops import matmul as jmm
from simplellminference_tpu.ops import qkv_fused as jqkv
from simplellminference_tpu.ops import ref_ops as jref
from simplellminference_tpu_torch.ops import matmul as tmm
from simplellminference_tpu_torch.ops import qkv_fused as tqkv
from simplellminference_tpu_torch.ops import ref_ops as tref

REL = 1e-5
FUSED_REL = 2e-2                      # tests/test_torch_fused.py's rule
KT, COLS = 64, 128                    # stage rows, block columns
bf = torch.bfloat16


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_ulp(a):
    a = np.maximum(np.abs(a), np.float32(2.0 ** -100))
    return np.exp2(np.floor(np.log2(a)) - 7)


# --------------------------------------------- 6m's columns and heads

def tail_pairs(d):
    """The tail's work in one row of a block: thread group i (0 .. 15)
    takes the 4 pairs from p0 = 4i, block columns (t1 + e, t1 + D/2 + e)
    with t1 = (p0 // (D/2)) D + p0 % (D/2)."""
    half = d // 2
    out = []
    for i in range(16):
        p0 = 4 * i
        t1 = (p0 // half) * d + p0 % half
        out.append([(t1 + e, t1 + half + e) for e in range(4)])
    return out


@pytest.mark.parametrize("d", [32, 64, 128])
def test_tail_takes_every_column_once_in_rope_pairs(d):
    groups = tail_pairs(d)
    cols = sorted(c for grp in groups for pair in grp for c in pair)
    assert cols == list(range(COLS))
    for grp in groups:
        # one head a group: its float4 loads (partials, scales, sin/cos at
        # column % D) stay in one head and on a 16-byte edge
        assert len({c1 // d for c1, _ in grp}) == 1 and grp[0][0] % 4 == 0
        for c1, c2 in grp:
            assert c1 // d == c2 // d and c2 - c1 == d // 2
            assert c1 % d < d // 2


SHAPES = {"llama2-7b": (4096, 32, 32, 128), "mistral-7b": (4096, 32, 8, 128),
          "tinyllama": (2048, 32, 4, 64), "d32": (512, 8, 4, 32)}


@pytest.mark.parametrize("name", list(SHAPES))
def test_blocks_hold_whole_heads(name):
    h, n, kvn, d = SHAPES[name]
    nq = (n + 2 * kvn) * d
    assert tqkv.qkv_regime(8, h, nq, d, bf) == "mma"
    kinds = set()
    for col0 in range(0, nq, COLS):
        # the INT8-KV pass's heads col0 / D + hb, hb < 128 / D, are the
        # block's columns, each head whole
        heads = [col0 // d + hb for hb in range(COLS // d)]
        assert [c // d for c in range(col0, col0 + COLS)] == [
            hd for hd in heads for _ in range(d)]
        kinds |= {"q" if hd < n else "k" if hd < n + kvn else "v"
                  for hd in heads}
    assert kinds == {"q", "k", "v"}


# ----------------------------------------- the kernels' f32 arithmetic

def product_order(xb, q, kch):
    """One tensor-core product's f32 order, all columns at once: per K
    block and K warp, 16-row k-steps (an mma's f32 sum) into the warp's
    accumulator; the two warps' sums added; the blocks' partials added in
    block order (0 + p0 + p1 ..) when K is split."""
    xf, qf = xb.float(), q.float()
    k = q.shape[0]
    parts = []
    for kb in range(0, k, kch):
        warps = []
        for kw in range(2):
            acc = torch.zeros(xf.shape[0], qf.shape[1])
            for st in range(kb, min(k, kb + kch), KT):
                for j in range(2):
                    r = st + kw * 32 + j * 16
                    acc = acc + xf[:, r:r + 16] @ qf[r:r + 16]
            warps.append(acc)
        parts.append(warps[0] + warps[1])
    if len(parts) == 1:
        return parts[0]
    out = torch.zeros_like(parts[0])
    for p in parts:
        out = out + p
    return out


def norm_order(x, nw, eps):
    """The norm pass (i8m::norm_rows_kernel): f32, rounded to bf16."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).sum(-1, keepdim=True) / x.shape[1] + eps)
    return (xf * inv * nw.float()).to(bf)


def tail_order(qkv, sin, cos, n, kvn, d):
    """The last block's tail over the scaled sums: RoPE on q and k in f32
    (r1 = x1 c - x2 s, r2 = x2 c + x1 s), q rounded to bf16; k and v in
    f32 (rounded by the pool store or the INT8-KV pass)."""
    b = qkv.shape[0]
    half = d // 2
    s, c = sin.float()[:, None, :], cos.float()[:, None, :]

    def rope(t):
        t1, t2 = t[..., :half], t[..., half:]
        return torch.cat([t1 * c - t2 * s, t2 * c + t1 * s], dim=-1)

    q = rope(qkv[:, :n * d].reshape(b, n, d))
    k = rope(qkv[:, n * d:(n + kvn) * d].reshape(b, kvn, d))
    v = qkv[:, (n + kvn) * d:].reshape(b, kvn, d)
    return q.to(bf), k, v


def quantize_order(t):
    """The INT8-KV pass: the row rounded to bf16, then per (row, head)
    scale = max(absmax / 127, 1e-8) by IEEE division, code = rint(x /
    scale) clipped to +-127."""
    tb = t.to(bf).float()
    amax = tb.abs().amax(-1, keepdim=True)
    sc = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-8)
    codes = torch.clamp(torch.round(tb / sc), -127, 127).to(torch.int8)
    return codes, sc[..., 0]


def _qkv_inputs(seed, b, h, n, kvn, d):
    rng = np.random.default_rng(seed)
    nq = (n + 2 * kvn) * d
    wq = rng.integers(-127, 128, (2, h, nq)).astype(np.int8)
    ws = (rng.uniform(0.5, 2.0, (2, 1, nq)) * 1e-2).astype(np.float32)
    nw = (rng.standard_normal((2, h)) * 0.1 + 1.0).astype(np.float32)
    x = _t(rng.standard_normal((b, h)).astype(np.float32)).to(bf)
    pos = (5 + 7 * np.arange(b) % 40).astype(np.int32)
    return rng, x, _t(nw), _t(wq), _t(ws), pos


# b across one and several n8 row tiles; D 32 (4 heads a block), 64, 128
QKV_CASES = [(1, 4, 2, 32), (8, 4, 2, 64), (9, 2, 1, 128), (40, 4, 2, 32),
             (64, 2, 2, 64)]


@pytest.mark.parametrize("b,n,kvn,d", QKV_CASES)
def test_qkv_order_matches_plain_and_jax_product(b, n, kvn, d):
    h, eps, li = 256, 1e-5, 1
    _, x, nw, wq, ws, pos = _qkv_inputs(b + d, b, h, n, kvn, d)
    sin, cos = tref.rope_tables(_t(pos), d, 10000.0)
    # the plain version's stages (ops/qkv_fused.py fused_qkv_append_ref)
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xn_p = (xf * inv * nw[li].float()).to(bf)
    qkv_p = tref.quantized_matmul_ref(xn_p, wq[li], ws[li],
                                      out_dtype=torch.float32)
    q_p, k_p, v_p = tail_order(qkv_p, sin, cos, n, kvn, d)
    # the JAX package's plain product on the same intermediates
    jq = np.asarray(jref.quantized_matmul_ref(
        jnp.asarray(xn_p.float().numpy(), jnp.bfloat16),
        jnp.asarray(wq[li].numpy()), jnp.asarray(ws[li].numpy()),
        out_dtype=jnp.float32))
    nq = wq.shape[-1]
    for kch in (64, 128, h, tqkv.qkv_split(b, h, nq // COLS)):
        # the norm: the same f32 math but the sum's order; within one
        # bf16 ulp of the plain version's
        xn = norm_order(x, nw[li], eps)
        diff = (xn.float() - xn_p.float()).numpy()
        assert (np.abs(diff) <= _bf16_ulp(xn_p.float().numpy())).all()
        qkv = product_order(xn_p, wq[li], kch) * ws[li].float()
        for want in (qkv_p.numpy(), jq):
            np.testing.assert_allclose(qkv.numpy(), want, rtol=0,
                                       atol=REL * float(np.abs(want).max()))
        q, k, v = tail_order(qkv, sin, cos, n, kvn, d)
        for got, want in ((k, k_p), (v, v_p)):
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=0,
                atol=REL * float(want.abs().max()))
        # q in bf16: one ulp beyond the f32 difference
        gq, wq_ = q.float().numpy(), q_p.float().numpy()
        assert (np.abs(gq - wq_) <= _bf16_ulp(np.maximum(np.abs(gq),
                                                         np.abs(wq_)))
                + REL * float(np.abs(wq_).max())).all()


def _pools(rng, b, kvn, d, ps=16, mp=3, quant=False):
    p1 = b * mp + 1
    shape = (2, p1, kvn, ps, d)
    if quant:
        return (rng.integers(-127, 128, shape).astype(np.int8),
                rng.integers(-127, 128, shape).astype(np.int8),
                rng.uniform(0.01, 0.1, shape[:-1]).astype(np.float32),
                rng.uniform(0.01, 0.1, shape[:-1]).astype(np.float32))
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("b,n,kvn,d", [(3, 4, 2, 32), (8, 2, 1, 128),
                                       (9, 4, 2, 64)])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16-kv", "int8-kv"])
def test_qkv_kernel_order_matches_jax_kernel(b, n, kvn, d, quant):
    h, eps, li, ps, mp = 256, 1e-5, 1, 16, 3
    rng, x, nw, wq, ws, pos = _qkv_inputs(b * d + quant, b, h, n, kvn, d)
    tables = np.arange(b * mp, dtype=np.int32).reshape(b, mp)
    tables[-1, pos[-1] // ps] = -1       # the last row writes to the trash
    sin, cos = jref.rope_tables(jnp.asarray(pos), d, 10000.0)
    pools = _pools(rng, b, kvn, d, ps, mp, quant)
    if not quant:
        pools = tuple(p.astype(np.float32) for p in pools)
    out = jqkv.fused_qkv_append(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(nw.numpy()),
        jnp.asarray(wq.numpy()), jnp.asarray(ws.numpy()), sin, cos,
        *(jnp.asarray(p) for p in pools[:2]), jnp.int32(li),
        jnp.asarray(pos), n_heads=n, kv_heads=kvn, eps=eps,
        tables=jnp.asarray(tables),
        **(dict(cache_ks=jnp.asarray(pools[2]),
                cache_vs=jnp.asarray(pools[3])) if quant else {}),
        interpret=True)
    q_j, pools_j = np.asarray(out[0], np.float32), out[1:]
    # the kernels' order on the CPU, split as the card splits it
    nq = wq.shape[-1]
    xn = norm_order(x, nw[li], eps)
    qkv = product_order(xn, wq[li], tqkv.qkv_split(b, h, nq // COLS))
    q, k, v = tail_order(qkv * ws[li].float(), _t(np.array(sin)),
                         _t(np.array(cos)), n, kvn, d)
    np.testing.assert_allclose(q.float().numpy(), q_j, rtol=0,
                               atol=FUSED_REL * float(np.std(q_j)))
    p1 = pools[0].shape[1]
    for r in range(b):
        page = tables[r, pos[r] // ps]
        page = page if page >= 0 else p1 - 1
        slot = pos[r] % ps
        for t, pj, sj in ((k, pools_j[0], 2), (v, pools_j[1], 3)):
            row = np.asarray(pj)[li, page, :, slot]
            if quant:
                codes, sc = quantize_order(t[r])
                assert np.abs(codes.numpy().astype(int) - row).max() <= 1
                want_s = np.asarray(pools_j[sj])[li, page, :, slot]
                assert (np.abs(sc.numpy() - want_s)
                        <= _bf16_ulp(want_s * 127.0) / 127.0 * 1.01).all()
            else:
                np.testing.assert_allclose(
                    t[r].numpy(), row, rtol=0,
                    atol=FUSED_REL * float(np.std(row)))


@pytest.mark.parametrize("b,n,kvn,d", [(8, 4, 2, 64), (5, 2, 1, 128)])
def test_qkv_int8kv_codes_match_plain_version(b, n, kvn, d):
    # the plain version's quantizing form against 6m's order: codes at
    # most 1 apart (k/v sums in another order may cross a midpoint)
    h, eps, li, ps, mp = 256, 1e-5, 1, 16, 3
    rng, x, nw, wq, ws, pos = _qkv_inputs(b + 100 * d, b, h, n, kvn, d)
    tables = _t(np.arange(b * mp, dtype=np.int32).reshape(b, mp))
    sin, cos = tref.rope_tables(_t(pos), d, 10000.0)
    pools = [_t(p) for p in _pools(rng, b, kvn, d, ps, mp, quant=True)]
    q_p, pk, pv, ks, vs = tqkv.fused_qkv_append(
        x, nw, wq, ws, sin, cos, pools[0], pools[1], li, _t(pos),
        n_heads=n, kv_heads=kvn, eps=eps, tables=tables, cache_ks=pools[2],
        cache_vs=pools[3])
    nq = wq.shape[-1]
    qkv = product_order(norm_order(x, nw[li], eps), wq[li],
                        tqkv.qkv_split(b, h, nq // COLS)) * ws[li].float()
    q, k, v = tail_order(qkv, sin, cos, n, kvn, d)
    np.testing.assert_allclose(q.float().numpy(), q_p.float().numpy(),
                               rtol=0, atol=FUSED_REL * float(
                                   q_p.float().std()))
    for r in range(b):
        page, slot = int(tables[r, pos[r] // ps]), int(pos[r]) % ps
        for t, pool in ((k, pk), (v, pv)):
            codes, _ = quantize_order(t[r])
            got = pool[li, page, :, slot].int()
            assert int((codes.int() - got).abs().max()) <= 1


# ------------------------------------------------------ 5r's order

@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("k,n", [(512, 256), (256, 192)],
                         ids=["k512-n256", "k256-n192-odd-group"])
def test_rows_mma_order_matches_plain_and_jax(m, k, n):
    rng = np.random.default_rng(m * k + n)
    q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = (rng.uniform(0.5, 2.0, (1, n)) * 1e-2).astype(np.float32)
    xt = _t(rng.standard_normal((m, k)).astype(np.float32)).to(bf)
    qt, st = _t(q), _t(s)
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    assert tmm.tiled_regime(m, k, n, k, bf) == "rmma"
    plain = tmm.quantized_matmul(xt, qt, st, out_dtype=torch.float32)
    plain16 = tmm.quantized_matmul(xt, qt, st, out_dtype=bf)
    jplain = np.asarray(jref.quantized_matmul_ref(
        xj, jnp.asarray(q), jnp.asarray(s), out_dtype=jnp.float32))
    wants = [plain.numpy(), jplain]
    if n % 128 == 0:
        # the Pallas kernel tiles N by 128 (an odd 64-column group comes
        # back NaN in interpret mode): the odd group meets its plain product
        wants.append(np.asarray(jmm.quantized_matmul(
            xj, jnp.asarray(q), jnp.asarray(s), out_dtype=jnp.float32,
            interpret=True)))
    for kch in (64, 128, k, tmm.rows_mma_split(m, k, n)):
        # the scale once, after the partials, as _qmm_kernel applies it
        got = (product_order(xt, qt, kch) * st[0]).numpy()
        for want in wants:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=REL * float(np.abs(want).max()))
        # one rounding to bf16: within one ulp of the plain version's
        got16 = torch.from_numpy(got).to(bf).float().numpy()
        w16 = plain16.float().numpy()
        assert (np.abs(got16 - w16) <= _bf16_ulp(np.maximum(
            np.abs(got16), np.abs(w16))) + REL * float(
                np.abs(w16).max())).all()


# ------------------------------------------------------------ the gates

MODELS = {"llama2-7b": (4096, 32, 32, 128, 32000),
          "mistral-7b": (4096, 32, 8, 128, 32000),
          "tinyllama": (2048, 32, 4, 64, 32000)}


@pytest.mark.parametrize("m", [1, 8, 9, 40, 64])
@pytest.mark.parametrize("name", list(MODELS))
def test_qkv_regime_sends_bf16_rows_to_the_tensor_cores(name, m):
    h, n, kvn, d, _ = MODELS[name]
    nq = (n + 2 * kvn) * d
    assert tqkv.qkv_regime(m, h, nq, d, bf) == "mma"
    assert tqkv.qkv_regime(m, h, nq, d, torch.float32) == "fma"


@pytest.mark.parametrize("m,h,nq,d", [
    (8, 4000, 12288, 128),     # H off a multiple of 64
    (8, 4096, 320, 64),        # 3 + 2 heads of 64: Nq off 128
    (8, 2048, 2496, 96),       # D 96
    (65, 4096, 12288, 128)])   # more rows than the kernel takes
def test_qkv_regime_sends_the_rest_to_the_fma_kernel(m, h, nq, d):
    assert tqkv.qkv_regime(m, h, nq, d, bf) == "fma"


@pytest.mark.parametrize("m", [1, 8, 9, 40, 64])
@pytest.mark.parametrize("name", list(MODELS))
def test_qkv_split_covers_k_in_whole_stages(name, m):
    h, n, kvn, d, _ = MODELS[name]
    tiles = (n + 2 * kvn) * d // COLS
    kch = tqkv.qkv_split(m, h, tiles)
    chunks = -(-h // kch)
    assert kch % KT == 0 and kch >= min(h, 256)
    assert chunks <= 8 and (chunks - 1) * kch < h <= chunks * kch
    if name != "tinyllama":
        assert chunks > 1         # 96 or 48 tiles alone leave SMs idle


def test_qkv_split_at_the_7b_and_mistral_decode():
    assert -(-4096 // tqkv.qkv_split(8, 4096, 96)) == 5
    assert -(-4096 // tqkv.qkv_split(8, 4096, 48)) == 8


@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("name", list(MODELS))
def test_tiled_regime_sends_few_bf16_rows_to_rmma(name, m):
    h, n, kvn, d, vocab = MODELS[name]
    nq = (n + 2 * kvn) * d
    for k, nn in ((h, nq), (n * d, h), (h, vocab)):      # wqkv, wo, head
        assert tmm.tiled_regime(m, k, nn, k, bf) == "rmma"
        assert tmm.tiled_regime(m, k, nn, k, torch.float32) == "rows"
        assert tmm.tiled_regime(m + 8, k, nn, k, bf) == "mma"


@pytest.mark.parametrize("k,n,group", [
    (4096, 4096, 128),         # grouped scales keep the FMA kernel
    (4096, 4000, 4096),        # N off a multiple of 64
    (4000, 4096, 4000),        # K off a multiple of 64
    (4096, 64 * 128 * 4097, 4096)])   # past the arrival counters
def test_tiled_regime_keeps_misfit_few_rows_on_rows(k, n, group):
    assert tmm.tiled_regime(8, k, n, group, bf) == "rows"


@pytest.mark.parametrize("m,k,n", [(8, 4096, 4096), (8, 4096, 32000),
                                   (1, 4096, 6144), (8, 11008, 4096),
                                   (3, 256, 192), (8, 64, 64)])
def test_rows_mma_split_covers_k_in_whole_stages(m, k, n):
    kch = tmm.rows_mma_split(m, k, n)
    chunks = -(-k // kch)
    tiles = -(-n // tmm.ROWS_MMA_COLS)
    assert kch % tmm.ROWS_MMA_KT == 0
    assert (chunks - 1) * kch < k <= chunks * kch          # every row, once
    assert chunks <= tmm.ROWS_MMA_MAX_SPLIT
    assert kch >= min(k, tmm.ROWS_MMA_MIN_K) or chunks == 1
    # the grid fits the blocks the card holds at once
    assert tiles * chunks <= max(tiles, tmm.ROWS_MMA_RES * tmm.SM_COUNT)


def test_rows_mma_split_at_the_7b_wo_and_head():
    assert -(-4096 // tmm.rows_mma_split(8, 4096, 4096)) == 8
    assert -(-4096 // tmm.rows_mma_split(8, 4096, 32000)) == 2


def test_cpu_calls_move_no_regime_count():
    # the CPU takes the plain versions: no kernel launches, no count moves
    before = (dict(tqkv.QKV_REGIME_LAUNCHES), dict(tmm.REGIME_LAUNCHES))
    _, x, nw, wq, ws, pos = _qkv_inputs(0, 2, 128, 2, 1, 64)
    sin, cos = tref.rope_tables(_t(pos), 64, 10000.0)
    pk, pv = (_t(p) for p in _pools(np.random.default_rng(0), 2, 1, 64))
    tqkv.fused_qkv_append(x, nw, wq, ws, sin, cos, pk, pv, 1, _t(pos),
                          n_heads=2, kv_heads=1,
                          tables=_t(np.arange(6, dtype=np.int32)
                                    .reshape(2, 3)))
    tmm.quantized_matmul(x, wq[0], ws[0])
    assert (tqkv.QKV_REGIME_LAUNCHES, tmm.REGIME_LAUNCHES) == before
