"""The int8 tensor-core design of the port's W8A8 product (kernel 15,
``quantized_matmul_w8a8``) on the CPU.

``csrc/quantized_matmul_w8a8_wgmma.cu`` runs ``wgmma.m64n128k32.s32.s8.s8``,
which reads both operands K-major from shared memory with a 128-byte
swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)). The activation
codes [M, K] are K-major as they are; the weights [K, N] are staged as
[k][n] (chunk c of row k at c ^ (k / 16 % 8)) and each 128-row slab is
transposed into an int8 tile [n][k] by 4 x 4 byte permutes: a thread takes
16 k x 4 n, reads 16 words, and writes four 16-byte chunks.

The kernel runs only on the card; here, with numpy bit operations, (a) the
transpose, emulated thread by thread from the bytes each reads, gives the
tile wgmma reads through its swizzle bit for bit for every byte value, and
the emulated products over the staged tiles (rows past M and K, columns
past N zero-filled) reproduce xi @ q exactly; (b) the kernel's arithmetic
(exact s32 sums, per channel (float)sum * s * xs; grouped each group's
(float)partial * s added in group order, then * xs; K-split partials added
in block order, as integers per channel) over bf16 inputs agrees with the
JAX ``quantized_matmul_w8a8`` in interpret mode (as tests/test_torch_w8a8.py
runs it) within 1e-5 of the output's largest magnitude, on the codes JAX's
quantizer gives under jit (they may part from the eager ones by a step),
and on the port's codes with the port's plain version: per channel bit for
bit, grouped within the same 1e-5; (c)
``w8a8_regime`` sends bench.py's 7B products to the tensor cores, and K or
N off a multiple of 16 and groups off a multiple of the 128-row slab to the
dp4a kernel, and ``w8a8_split`` covers K in whole slabs and groups.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.ops import matmul as jmm
from simplellminference_tpu_torch.ops import matmul as tmm

REL = 1e-5
BK = BN = ROW = 128                     # slab rows, tile columns, row bytes


def _t(a):
    return torch.from_numpy(np.array(a))


def byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: result byte i is byte
    (sel >> 4i) & 7 of x.b0 .. x.b3, y.b0 .. y.b3."""
    both = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(
        x, np.uint64)
    out = np.zeros(np.shape(x), np.uint32)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        out |= ((both >> np.uint64(8 * src)) & np.uint64(0xFF)).astype(
            np.uint32) << np.uint32(8 * i)
    return out


# --------------------------------------------- the staged and read layouts

def stage_x(xi, m0, k0, m, ke, bm):
    """The activation stage as the copies lay it: [bm rows][128 bytes],
    chunk c of row r at c ^ (r % 8); zero past M and ke."""
    smem = np.zeros(bm * ROW, np.uint8)
    for r in range(bm):
        for c in range(8):
            if m0 + r < m and k0 + 16 * c < ke:
                dst = r * ROW + ((c ^ (r & 7)) << 4)
                smem[dst:dst + 16] = xi[m0 + r, k0 + 16 * c:k0 + 16 * c + 16]
    return smem


def stage_w(qb, k0, n0, ke, n):
    """The weight stage: [128 k][128 n] bytes, chunk c of row k at
    c ^ (k / 16 % 8); zero past ke rows and N columns."""
    smem = np.zeros(BK * BN, np.uint8)
    for r in range(BK):
        for c in range(8):
            if k0 + r < ke and n0 + 16 * c < n:
                dst = r * BN + ((c ^ ((r >> 4) & 7)) << 4)
                smem[dst:dst + 16] = qb[k0 + r, n0 + 16 * c:n0 + 16 * c + 16]
    return smem


def transpose(bs):
    """The kernel's transpose, all 256 thread tasks at once: task blk =
    (kc = blk % 8, bn = blk / 8) reads 16 words (k = 16 kc + 4h + i, the 4
    columns 4 bn ..), permutes 4 x 4 bytes and writes column 4 bn + jn's
    16 k as chunk kc ^ (n % 8) of row n of the [n][k] tile."""
    words = bs.view(np.uint32)
    blk = np.arange(256)
    kc, bn = blk & 7, blk >> 3
    boff = (((bn >> 2) ^ kc) << 4) + ((bn & 3) << 2)
    col = np.zeros((4, 4, 256), np.uint32)
    for h in range(4):
        w = [words[((kc * 16 + 4 * h + i) * BN + boff) // 4] for i in range(4)]
        t01 = byte_perm(w[0], w[1], 0x5140)
        t23 = byte_perm(w[2], w[3], 0x5140)
        u01 = byte_perm(w[0], w[1], 0x7362)
        u23 = byte_perm(w[2], w[3], 0x7362)
        col[h, 0] = byte_perm(t01, t23, 0x5410)
        col[h, 1] = byte_perm(t01, t23, 0x7632)
        col[h, 2] = byte_perm(u01, u23, 0x5410)
        col[h, 3] = byte_perm(u01, u23, 0x7632)
    out = np.full(BN * ROW // 4, 0xDEADBEEF, np.uint32)   # unwritten shows
    for jn in range(4):
        nn = 4 * bn + jn
        base = (nn * ROW + ((kc ^ (nn & 7)) << 4)) // 4
        for h in range(4):
            out[base + h] = col[h, jn]
    return out.view(np.uint8)


def wgmma_read(tile, rows):
    """A K-major operand as wgmma reads it through the 128-byte swizzle:
    element (r, k) at byte r * 128 + ((k / 16) ^ (r % 8)) * 16 + k % 16."""
    r = np.arange(rows)[:, None]
    k = np.arange(ROW)[None, :]
    return tile[r * ROW + (((k >> 4) ^ (r & 7)) << 4) + (k & 15)]


def test_transpose_is_bit_exact_for_every_byte():
    # every byte value at every (k, n) residue of a 4 x 4 block, both
    # halves of the swizzle pattern
    rng = np.random.default_rng(0)
    qb = rng.permutation(np.arange(BK * BN) % 256).astype(np.uint8).reshape(
        BK, BN)
    assert len(np.unique(qb[:4, :4])) > 1 and len(np.unique(qb)) == 256
    got = wgmma_read(transpose(stage_w(qb, 0, 0, BK, BN)), BN)
    np.testing.assert_array_equal(got, qb.T)


@pytest.mark.parametrize("m,k,n,bm", [(70, 400, 272, 128), (64, 256, 128, 64),
                                      (130, 160, 144, 128),
                                      (300, 256, 128, 256)])
def test_staged_products_reproduce_the_integer_product(m, k, n, bm):
    # the kernel's tiles, slab by slab: 64-row warpgroup tiles of the
    # staged activations against the transposed weight tile, k32 steps;
    # ragged M, K (a partial last slab) and N (a partial column tile)
    rng = np.random.default_rng(m + k)
    xi = rng.integers(-127, 128, (m, k)).astype(np.int8)
    qb = rng.integers(-127, 128, (k, n)).astype(np.int8)
    want = xi.astype(np.int64) @ qb.astype(np.int64)
    got = np.zeros((m, n), np.int64)
    for m0 in range(0, m, bm):
        for n0 in range(0, n, BN):
            acc = np.zeros((bm, BN), np.int64)
            for k0 in range(0, k, BK):
                a = wgmma_read(stage_x(xi.view(np.uint8), m0, k0, m, k, bm),
                               bm).view(np.int8).astype(np.int64)
                b = wgmma_read(transpose(stage_w(qb.view(np.uint8), k0, n0,
                                                 k, n)), BN)
                b = b.view(np.int8).astype(np.int64)       # [n][k]
                for wg in range(bm // 64):
                    for kk in range(0, BK, 32):
                        acc[wg * 64:wg * 64 + 64] += (
                            a[wg * 64:wg * 64 + 64, kk:kk + 32]
                            @ b[:, kk:kk + 32].T)
            rows = min(bm, m - m0)
            cols = min(BN, n - n0)
            got[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
            assert not acc[rows:].any() and not acc[:, cols:].any()
    np.testing.assert_array_equal(got, want)


# --------------------------------------------- the kernel's f32 arithmetic

def kernel_order(xi, xs, q, s, kch):
    """The kernel's arithmetic in float32: per K block exact integer sums;
    per channel the blocks' s32 partials added as integers, then
    (float)sum * s * xs; grouped each group's (float)partial * s added to
    the block's total in group order, the blocks' totals added in block
    order (0 + p0 + p1 ..), then * xs. No multiply-add is fused."""
    k = xi.shape[1]
    gs = k // s.shape[0]
    xi64, q64 = xi.astype(np.int64), q.astype(np.int64)
    f = np.float32
    if gs == k:
        total = np.zeros((xi.shape[0], q.shape[1]), np.int64)
        for kb in range(0, k, kch):
            total += xi64[:, kb:kb + kch] @ q64[kb:kb + kch]
        return (total.astype(f) * s[0]).astype(f) * xs
    out = np.zeros((xi.shape[0], q.shape[1]), f)
    for kb in range(0, k, kch):
        tot = np.zeros_like(out)
        for g0 in range(kb, min(k, kb + kch), gs):
            part = xi64[:, g0:g0 + gs] @ q64[g0:g0 + gs]
            tot = (tot + (part.astype(f) * s[g0 // gs]).astype(f)).astype(f)
        out = (out + tot).astype(f)
    return (out * xs).astype(f)


@pytest.mark.parametrize("odt", [torch.float32, torch.bfloat16],
                         ids=["f32-out", "bf16-out"])
@pytest.mark.parametrize("groups", [1, 2, 4], ids=["per-channel", "group256",
                                                   "group128"])
def test_kernel_order_matches_jax_kernel_interpret_bf16(groups, odt):
    # K 512 and N 256, multiples of 128, so JAX runs its Pallas kernel (in
    # interpret mode); kch 128, 256 and K split K over blocks on slab and
    # group edges; a zero row takes the 1e-10 scale floor
    rng = np.random.default_rng(groups)
    m, k, n = 128, 512, 256
    q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = ((rng.random((groups, n)) + 0.5) / (127 * np.sqrt(k))).astype(
        np.float32)
    xb = _t(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    xb[1] = 0
    want = np.asarray(jmm.quantized_matmul_w8a8(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(q),
        jnp.asarray(s), out_dtype=jnp.float32, interpret=True))
    plain = tmm.quantized_matmul_w8a8_ref(xb, _t(q), _t(s), out_dtype=odt)
    plain32 = tmm.quantized_matmul_w8a8_ref(xb, _t(q), _t(s),
                                            out_dtype=torch.float32).numpy()
    xi, xs = tmm.quantize_activations_int8(xb)
    # the JAX kernel's codes: its quantizer under jit may part from the
    # eager one (and the port's) by a step where x / xs is near a tie
    ji, js = jax.jit(jmm.quantize_activations_int8)(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16))
    gs = k // groups
    assert tmm.w8a8_regime(m, k, n, gs) == "wgmma"
    tol = REL * float(np.abs(want).max())
    for kch in (128, 256, k):
        if kch % gs and gs < k:
            continue
        np.testing.assert_allclose(
            kernel_order(np.asarray(ji), np.asarray(js), q, s, kch), want,
            rtol=0, atol=tol)
        got = kernel_order(xi.numpy(), xs.numpy(), q, s, kch)
        assert not got[1].any()
        if groups == 1:                   # exact sums, the same two products
            assert torch.equal(_t(got).to(odt), plain)
        else:                             # the f32 sums in another order
            np.testing.assert_allclose(got, plain32, rtol=0, atol=tol)


@pytest.mark.parametrize("kch", [128, 256, 384, 1024])
def test_split_integer_partials_are_exact(kch):
    # per channel the blocks' s32 partials add as integers: the total is
    # the unsplit one whatever the split, so the output is bit-equal to the
    # plain version's, which rounds the exact total once
    rng = np.random.default_rng(kch)
    m, k, n = 16, 1024, 64
    q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = ((rng.random((1, n)) + 0.5) / (127 * np.sqrt(k))).astype(np.float32)
    x = _t(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    xi, xs = tmm.quantize_activations_int8(x)
    got = kernel_order(xi.numpy(), xs.numpy(), q, s, kch)
    plain = tmm.quantized_matmul_w8a8_ref(x, _t(q), _t(s),
                                          out_dtype=torch.float32)
    np.testing.assert_array_equal(got, plain.numpy())


# ------------------------------------------------------------- the gate

SEVEN_B = {"wqkv": (4096, 12288), "wo": (4096, 4096),
           "gate_up": (4096, 22016), "down": (11008, 4096)}


@pytest.mark.parametrize("m", [128, 256, 300, 1024])
@pytest.mark.parametrize("name", list(SEVEN_B))
def test_regime_sends_7b_products_to_the_tensor_cores(name, m):
    k, n = SEVEN_B[name]
    for gs in (k, 128, 256):                  # per channel, groups
        assert tmm.w8a8_regime(m, k, n, gs) == "wgmma"


@pytest.mark.parametrize("m,k,n,gs", [
    (1024, 4096, 12288, 64),      # group 64: off the 128-row slab
    (128, 4096, 4096, 32),        # group 32
    (256, 1000, 2048, 1000),      # K % 16 != 0
    (141, 1000, 136, 1000),       # K and N off 16
    (300, 4096, 4000 + 8, 4096),  # N % 16 != 0
    (128, 1200, 4096, 200),       # group 200
])
def test_regime_sends_the_rest_to_the_dp4a_kernel(m, k, n, gs):
    fits = k % 16 == 0 and n % 16 == 0 and (gs == k or gs % 128 == 0)
    assert not fits
    assert tmm.w8a8_regime(m, k, n, gs) == "dp4a"


@pytest.mark.parametrize("m", [1, 64, 128, 256, 300, 1024])
@pytest.mark.parametrize("name", list(SEVEN_B))
def test_splits_cover_k_in_whole_slabs_and_groups(name, m):
    k, n = SEVEN_B[name]
    for gs in (k, 128, 256):
        wm, kch = tmm.w8a8_split(m, k, n, gs)
        assert wm == (4 if m >= 256 and gs == k else 2 if m >= 128 else 1)
        chunks = -(-k // kch)
        assert kch % tmm.W8A8_BK == 0 and kch >= min(k, tmm.W8A8_MIN_K)
        if gs < k:
            assert kch % gs == 0              # a group never straddles two
        assert (chunks - 1) * kch < k <= chunks * kch   # every row, once
        tiles = -(-n // 128) * -(-m // (64 * wm))
        if chunks > 1:                        # splits only fill idle SMs
            assert tiles * chunks <= tmm.SM_COUNT
        else:
            assert tiles * 2 > tmm.SM_COUNT or k < 2 * tmm.W8A8_MIN_K or (
                gs < k and k // gs < 2)
