"""The tensor-core design of the port's fused FFN (kernel 7,
``fused_ffn``) for bf16 rows on the CPU.

``csrc/ffn_fused_mma.cu`` runs the rmsnorm once (xn, bf16), then gate_up +
SwiGLU and down + residual on ``mma.sync.m16n8k16`` with the operands
swapped (``csrc/int8_mma_rows.cuh``): A is the weight, 16 columns x 16 k a
tile, B is x^T, 16 k x 8 rows a tile (all m <= 64 rows in one pass). A block
of 4 warps owns two 64-column groups (gate and the matching up columns; or
128 down columns) and a K range, staged 64 rows at a time with each row
padded to 144 bytes; warp (cg, kw) = (warp % 2, warp / 2) takes group cg
as four tiles (tile j's row r at column 4r + j, r >= 8 at 32 + 4(r - 8) + j)
and rows kw * 32 .. + 32 of a stage. A thread reads the 32-bit words of
its 4 columns at rows p = P + 2t, p + 1, p + 8, p + 9, converts each byte
exactly to f32 (a byte permute into the mantissa of 2^23, minus 2^23 + 128)
and packs rows p, p + 1 of a column into a bf16x2.

The kernels run only on the card; here, with numpy bit operations, (a) the
conversion is bit-exact for every byte value, and the fragments, built lane
by lane from the bytes and x words a thread reads, give every A register
the code of its (column, row) and reproduce x @ q exactly in float64; (b)
the kernels' f32 order over bf16 inputs (k-step sums into the two K warps'
accumulators, the warps' sums added, K-split partials added in block order
by the last block to arrive, then the scales, SwiGLU and the residual) agrees
stage by stage, on the same bf16 intermediates, with the port's plain
version and with the JAX package's plain product within 1e-5 of each
stage's largest magnitude, and end to end (the normalized rows and h
rounded to bf16 on both sides, where a rounding flip of one intermediate
moves the output by more than 1e-5) with the JAX ``fused_ffn`` in
interpret mode (as tests/test_torch_fused.py runs it) within that test's
fused-kernel tolerance, 2e-2 of the output's standard deviation; (c)
``ffn_regime`` sends bf16 rows at Llama-2-7B and Mistral-7B widths to the
tensor cores and f32 rows and H or I off a multiple of 64 to the FMA
kernels, and ``ffn_split`` covers K in whole 64-row stages within the
blocks the card holds at once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.ops import ffn_fused as jffn
from simplellminference_tpu.ops import ref_ops as jref
from simplellminference_tpu_torch.ops import ffn_fused as tffn
from simplellminference_tpu_torch.ops import ref_ops as tref

REL = 1e-5
FUSED_REL = 2e-2                      # tests/test_torch_fused.py's rule
KT, WROW, XROW = 64, 144, 144         # stage rows, staged row bytes
LANE = np.arange(32)
G_, T_ = LANE >> 2, LANE & 3


def _t(a):
    return torch.from_numpy(np.array(a))


def byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays."""
    both = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(
        x, np.uint64)
    out = np.zeros(np.shape(x), np.uint32)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        out |= ((both >> np.uint64(8 * src)) & np.uint64(0xFF)).astype(
            np.uint32) << np.uint32(8 * i)
    return out


def i8x4_to_f32(w):
    """``sli::i8x4_to_f32``: byte j of w -> float, [4, ...] float32."""
    u = np.asarray(w, np.uint32) ^ np.uint32(0x80808080)
    return np.stack([byte_perm(u, np.full_like(u, 0x4B000000), 0x7540 + j)
                     .view(np.float32) - np.float32(8388736.0)
                     for j in range(4)])


def bf16_round(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def test_conversion_is_bit_exact_for_every_byte():
    b = np.arange(256, dtype=np.uint8)
    for shift in range(4):                    # every byte position
        words = np.zeros(256, np.uint32) | (b.astype(np.uint32) << (8 * shift))
        f = i8x4_to_f32(words)[shift]
        np.testing.assert_array_equal(f, b.view(np.int8).astype(np.float32))
        # the bf16x2 pack of exact codes is exact: every int8 fits bf16
        np.testing.assert_array_equal(bf16_round(f), f)


# --------------------------------------------------- the fragment mapping

def tile_col(j, r):
    return np.where(r < 8, 4 * r + j, 32 + 4 * (r - 8) + j)


def stage(qb, x16, k0, col0, col1, m, nt):
    """One ring stage as the copies lay it: weight rows [64][144 bytes]
    (group 0's 64 columns, then group 1's, then 16 bytes of padding) and
    the x slab [8 nt rows][144 bytes] (64 bf16 of a row, rows past m 0)."""
    ws = np.zeros((KT, WROW), np.uint8)
    ws[:, :64] = qb[k0:k0 + KT, col0:col0 + 64]
    ws[:, 64:128] = qb[k0:k0 + KT, col1:col1 + 64]
    xs = np.zeros((8 * nt, XROW), np.uint8)
    rows = min(m, 8 * nt)
    xs[:rows, :128] = x16[:rows, k0:k0 + KT].view(np.uint8).reshape(rows, 128)
    return ws.reshape(-1), xs.reshape(-1)


def words_at(buf, off):
    return buf[off[..., None] + np.arange(4)].astype(np.uint32) @ (
        np.uint32(1) << (8 * np.arange(4, dtype=np.uint32)))


def fragments(ws, xs, cg, kw, j, nt):
    """A [4 tiles][16 rows][16 k] and B [nt][16 k][8 rows] of warp (cg,
    kw)'s k-step j, built lane by lane from the words each lane reads."""
    p = kw * 32 + j * 16 + 2 * T_
    a = np.full((4, 16, 16), np.nan, np.float32)
    for u in range(4):                        # rows p, p+1, p+8, p+9
        off = (p + (u >> 1) * 8 + (u & 1)) * WROW + cg * 64 + 4 * G_
        fa = i8x4_to_f32(words_at(ws, off))          # [4 columns][32 lanes]
        fb = i8x4_to_f32(words_at(ws, off + 32))
        kslot = 2 * T_ + (u >> 1) * 8 + (u & 1)
        for tj in range(4):
            a[tj, G_, kslot] = bf16_round(fa[tj])
            a[tj, G_ + 8, kslot] = bf16_round(fb[tj])
    b = np.full((nt, 16, 8), np.nan, np.float32)
    xw = xs.view(np.uint16)
    for n in range(nt):
        base = ((n * 8 + G_) * XROW + (kw * 32 + j * 16 + 2 * T_) * 2) // 2
        for hk in range(2):                   # b0: k 2t, 2t+1; b1: + 8
            for e in range(2):
                bits = xw[base + hk * 8 + e].astype(np.uint32) << 16
                b[n, 2 * T_ + 8 * hk + e, G_] = bits.view(np.float32)
    return a, b


@pytest.mark.parametrize("m", [1, 8, 9, 40])
def test_fragment_mapping_reproduces_the_product(m):
    # two blocks of two 64-column groups (the down kernel's 128 columns),
    # two stages; integer x (exact in bf16 and float64)
    rng = np.random.default_rng(m)
    k, n = 128, 256
    nt = -(-m // 8)
    qb = rng.integers(-128, 128, (k, n)).astype(np.int8)
    x = rng.integers(-9, 10, (m, k)).astype(np.float32)
    x16 = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    got = np.zeros((m, n))
    for n0 in range(0, n, 128):
        for k0 in range(0, k, KT):
            ws, xs = stage(qb.view(np.uint8), x16, k0, n0, n0 + 64, m, nt)
            for cg in range(2):
                for kw in range(2):
                    for j in range(2):
                        a, b = fragments(ws, xs, cg, kw, j, nt)
                        rows = k0 + kw * 32 + j * 16 + np.arange(16)
                        for tj in range(4):
                            cols = n0 + 64 * cg + tile_col(tj, np.arange(16))
                            np.testing.assert_array_equal(
                                a[tj], qb[rows][:, cols].T.astype(np.float32))
                            d = a[tj].astype(np.float64) @ np.concatenate(
                                b, axis=1).astype(np.float64)   # [16, 8 nt]
                            got[:, cols] += d[:, :m].T
            assert not np.isnan(b).any()
    np.testing.assert_array_equal(got, x.astype(np.float64) @ qb)


# --------------------------------------------- the kernels' f32 arithmetic

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


def kernel_stages(x, nw, q1, s1, q2, s2, eps, kch1, kch2):
    """The first two launches' arithmetic: (xn, the scaled gate_up sums,
    h); :func:`down_order` is the third's."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).sum(-1, keepdim=True) / x.shape[1] + eps)
    xn = (xf * inv * nw.float()).to(torch.bfloat16)
    gu = product_order(xn, q1, kch1) * s1.float()
    inter = q2.shape[0]
    g, u = gu[:, :inter], gu[:, inter:]
    h = (g * (1.0 / (1.0 + torch.exp(-g))) * u).to(torch.bfloat16)
    return xn, gu, h


def down_order(h, q2, s2, x, kch2):
    return product_order(h, q2, kch2) * s2.float() + x.float()


def _case(m, h, inter, seed):
    rng = np.random.default_rng(seed)
    q1 = rng.integers(-127, 128, (h, 2 * inter)).astype(np.int8)
    s1 = (rng.uniform(0.5, 2.0, 2 * inter) * 1e-2).astype(np.float32)
    q2 = rng.integers(-127, 128, (inter, h)).astype(np.int8)
    s2 = (rng.uniform(0.5, 2.0, h) * 1e-2).astype(np.float32)
    nw = (rng.standard_normal(h) * 0.1 + 1.0).astype(np.float32)
    x = _t(rng.standard_normal((m, h)).astype(np.float32)).to(torch.bfloat16)
    return x, _t(nw), _t(q1), _t(s1), _t(q2), _t(s2)


@pytest.mark.parametrize("m", [1, 8, 9, 40, 64])
def test_kernel_order_matches_plain_and_jax_bf16(m):
    h, inter, eps = 128, 256, 1e-5
    x, nw, q1, s1, q2, s2 = _case(m, h, inter, m)
    # the plain version's stages (ops/ffn_fused.py _ffn_plain)
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xn_p = (xf * inv * nw.float()).to(torch.bfloat16)
    gu_p = tref.quantized_matmul_ref(xn_p, q1, s1.reshape(1, -1),
                                     out_dtype=torch.float32)
    g, u = gu_p[:, :inter], gu_p[:, inter:]
    h_p = (g * torch.sigmoid(g) * u).to(torch.bfloat16)
    dn_p = tref.quantized_matmul_ref(h_p, q2, s2.reshape(1, -1),
                                     out_dtype=torch.float32) + xf
    plain = tffn.fused_ffn_ref(x, nw[None], q1[None], s1[None, None],
                               q2[None], s2[None, None], 0, eps)
    assert torch.equal(dn_p.to(torch.bfloat16), plain)
    # the JAX package's plain product on the same intermediates
    jgu = np.asarray(jref.quantized_matmul_ref(
        jnp.asarray(xn_p.float().numpy(), jnp.bfloat16),
        jnp.asarray(q1.numpy()), jnp.asarray(s1.numpy()[None]),
        out_dtype=jnp.float32))
    jdn = np.asarray(jref.quantized_matmul_ref(
        jnp.asarray(h_p.float().numpy(), jnp.bfloat16),
        jnp.asarray(q2.numpy()), jnp.asarray(s2.numpy()[None]),
        out_dtype=jnp.float32)) + xf.numpy()
    for kch1, kch2 in ((64, 64), (128, 128), (h, inter)):
        xn, _, _ = kernel_stages(x, nw, q1, s1, q2, s2, eps, kch1, kch2)
        # the norm: the same f32 math but the sum's order; xn within one
        # bf16 ulp of the plain version's
        diff = (xn.float() - xn_p.float()).abs()
        assert bool((diff <= torch.exp2(torch.floor(torch.log2(
            xn_p.float().abs().clamp_min(1e-30))) - 7)).all())
        # gate_up over the plain version's xn, down over its h
        gu = product_order(xn_p, q1, kch1) * s1.float()
        dn = down_order(h_p, q2, s2, x, kch2)
        for got, want in ((gu, gu_p.numpy()), (gu, jgu), (dn, dn_p.numpy()),
                          (dn, jdn)):
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=REL * float(np.abs(want).max()))
    # end to end against the JAX kernel in interpret mode
    _, _, hk = kernel_stages(x, nw, q1, s1, q2, s2, eps, 64, 64)
    out = down_order(hk, q2, s2, x, 64).to(torch.bfloat16)
    want = np.asarray(jffn.fused_ffn(
        jnp.asarray(x.float().numpy(), jnp.bfloat16),
        jnp.asarray(nw.numpy()[None]), jnp.asarray(q1.numpy()[None]),
        jnp.asarray(s1.numpy()[None, None]), jnp.asarray(q2.numpy()[None]),
        jnp.asarray(s2.numpy()[None, None]), jnp.int32(0), eps=eps,
        interpret=True)).astype(np.float32)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=0,
                               atol=FUSED_REL * float(np.std(want)))


# ------------------------------------------------------------- the gate

WIDTHS = {"llama2-7b": (4096, 11008), "mistral-7b": (4096, 14336),
          "tinyllama": (2048, 5632)}


@pytest.mark.parametrize("m", [1, 8, 9, 40, 64])
@pytest.mark.parametrize("name", list(WIDTHS))
def test_regime_sends_bf16_rows_to_the_tensor_cores(name, m):
    h, inter = WIDTHS[name]
    assert tffn.ffn_regime(m, h, inter, torch.bfloat16) == "mma"
    assert tffn.ffn_regime(m, h, inter, torch.float32) == "fma"


@pytest.mark.parametrize("m,h,inter", [(8, 4000, 11008), (8, 4096, 11000),
                                       (3, 128, 200), (40, 96, 256)])
def test_regime_sends_the_rest_to_the_fma_kernels(m, h, inter):
    assert h % 64 or inter % 64
    assert tffn.ffn_regime(m, h, inter, torch.bfloat16) == "fma"


@pytest.mark.parametrize("m", [1, 8, 9, 16, 40, 41, 64])
@pytest.mark.parametrize("name", list(WIDTHS))
def test_splits_cover_k_in_whole_stages(name, m):
    h, inter = WIDTHS[name]
    for k, tiles in ((h, inter // 64), (inter, -(-h // 128))):
        kch = tffn.ffn_split(m, k, tiles)
        chunks = -(-k // kch)
        assert kch % tffn.MMA_KT == 0 and kch >= min(k, tffn.MMA_MIN_K)
        assert chunks <= tffn.MMA_MAX_SPLIT
        assert (chunks - 1) * kch < k <= chunks * kch   # every row, once
        # the grid fits the blocks the card holds at once
        assert tiles * chunks <= max(tiles, tffn.ffn_resident(m)
                                     * tffn.SM_COUNT)
