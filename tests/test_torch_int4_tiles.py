"""The tensor-core design of the port's INT4 product (kernel 14,
``quantized_matmul_int4``, and its zero-point form) on the CPU.

Two kernels run bf16 activations on the tensor cores with the operands
swapped (``csrc/int4_tiles.cuh``): A is the weight, converted in registers
from split-half packed bytes, B is x^T. ``csrc/quantized_matmul_int4_mma.cu``
(mma.sync, M <= 8) lays four 16-column tiles over a warp's 64 columns (tile
j's row r at column 4r + j, rows 8-15 at 32 + 4(r - 8) + j);
``csrc/quantized_matmul_int4_wgmma.cu`` (wgmma, M > 8) two m64 tiles over a
warp's 32 columns of a warpgroup's 128 (tile j's row r at 4(r % 8) + 2j +
r // 8). Both read 32-bit words of 4 columns at packed rows p = P + 2t (+ 8)
and p + 1, pair two columns' bytes of both rows with one byte permute and
convert nibbles i and i + 4 (the same column, rows p and p + 1, one half)
to a bf16x2: flip bit 3 (v + 8), put it under the bf16 pattern 0x4300
(136 + v), subtract 136. A k-step of 16 slots is logical rows P .. P + 15 of
one half, in order.

The kernels run only on the card; here, with numpy bit operations, (a) the
conversion is bit-exact against ``ref_ops.unpack_int4`` for every byte
value; (b) the fragment mapping, emulated lane by lane from the bytes a
thread reads, gives every A register the code of its (column, logical row),
and the emulated products reproduce x @ w exactly in float64 (integer x,
power-of-two scales) per channel and in groups, no k-step of either kernel
mixing two groups; (c) the kernels' f32 order (k-step sums into
accumulators, each group folded times its scale minus rowsum_g(x) * zs at
its end (the wgmma kernel: at each 64-row k-block's end), the K warps'
totals added, split partials added, a per-channel scale once at the end) over bf16 inputs agrees with the JAX
``_quantized_matmul_int4`` in interpret mode (as tests/test_torch_int4.py
runs it) and with the port's plain version within 1e-5 of the output's
largest magnitude (only the f32 summation order differs); (d)
``int4_regime`` sends bench.py's 7B products and AWQ's groups of 128 to the
tensor-core kernels and f32 activations, groups of 32 (or off a multiple of
64), N off a multiple of 16 and K/2 off a multiple of 64 to the FMA kernels,
and the K splits cover K/2 in whole 64-row stages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.ops import matmul as jmm
from simplellminference_tpu.ops import ref_ops as jref
from simplellminference_tpu_torch.ops import matmul as tmm
from simplellminference_tpu_torch.ops import ref_ops as tref

REL = 1e-5
FLIP = np.uint32(0x88888888)
LANE = np.arange(32)
G_, T_ = LANE >> 2, LANE & 3          # a lane's group row g and slot pair t
# A register -> (tile row, first k slot) of its bf16x2, for lane (g, t)
A_SLOTS = ((0, 0), (8, 0), (0, 8), (8, 8))


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------- the kernels' bit tricks

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


def to_bf16x2(w, s):
    """``q4::to_bf16x2``: nibbles s and s + 4 of a flipped word under
    0x4300, minus 136, as (low, high) float32 (the fma is exact)."""
    r = ((np.asarray(w, np.uint32) >> np.uint32(4 * s))
         & np.uint32(0x000F000F)) | np.uint32(0x43004300)
    lo = ((r & np.uint32(0xFFFF)) << np.uint32(16)).view(np.float32)
    hi = (r & np.uint32(0xFFFF0000)).view(np.float32)
    return lo - np.float32(136.0), hi - np.float32(136.0)


def words(qb, rows, cols):
    """The 32-bit words a thread reads: bytes qb[rows, cols .. cols + 3]."""
    w = np.zeros(np.shape(rows), np.uint32)
    for j in range(4):
        w |= qb[rows, cols + j].astype(np.uint32) << np.uint32(8 * j)
    return w


def bf16_bits(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy()


@pytest.mark.parametrize("s", [0, 1, 2, 3])
@pytest.mark.parametrize("hi_bytes", [False, True], ids=["bytes01", "bytes23"])
def test_conversion_is_bit_exact_for_every_byte(hi_bytes, s):
    # row p holds every byte value, row p + 1 the same reversed, 4 columns
    # a word: all 256 x 256 pairs would add nothing (nibbles are converted
    # one at a time); each byte of both rows meets every selector and shift
    b = np.arange(256, dtype=np.uint8)
    qb = np.stack([b, b[::-1]]).reshape(2, 256)
    codes = tref.unpack_int4(_t(qb.view(np.int8))).numpy()  # [4, 256]
    cols = np.arange(0, 256, 4)
    r0 = words(qb, np.zeros_like(cols), cols) ^ FLIP
    r1 = words(qb, np.ones_like(cols), cols) ^ FLIP
    lo, hi = to_bf16x2(byte_perm(r0, r1, 0x7632 if hi_bytes else 0x5410), s)
    col = cols + 2 * hi_bytes + s // 2       # the column of nibbles s, s + 4
    half = s % 2                             # even s: low nibbles
    want_p = codes[2 * half, col]            # logical rows p, p + 1 of half
    want_p1 = codes[2 * half + 1, col]
    np.testing.assert_array_equal(bf16_bits(lo), bf16_bits(want_p))
    np.testing.assert_array_equal(bf16_bits(hi), bf16_bits(want_p1))
    assert codes.min() == -8 and codes.max() == 7


# --------------------------------------------------- the fragment mapping

def mma_column(cn, tile, row):
    """Block column of tile ``tile``'s row ``row`` in warp column ``cn``
    of the few-rows kernel (tile j's row r at 4r + j, r >= 8 at 32 + ...)."""
    return 64 * cn + 4 * (row % 8) + tile + 32 * (row // 8)


def wgmma_column(base, w, tile, row):
    """Block column of tile ``tile``'s row ``row`` of warp ``w`` in a
    warpgroup owning columns ``base`` .. + 128 of the wgmma kernel."""
    return base + 32 * w + 4 * (row % 8) + 2 * tile + row // 8


def kstep_rows(p0, half, kp):
    """Logical row of each of the 16 k slots of the k-step at packed rows
    p0 .. p0 + 15 of ``half`` (0: low nibbles, 1: high)."""
    return half * kp + p0 + np.arange(16)


def mma_registers(qb, n0, cn, p0, half):
    """A of the few-rows kernel's 4 tiles for one k-step, built lane by
    lane as the kernel does: [tile][16 rows][16 slots] float32."""
    a = np.full((4, 16, 16), np.nan, np.float32)
    ca = n0 + 64 * cn + 4 * G_
    for ab, base in enumerate((ca, ca + 32)):     # tile rows g / g + 8
        r = [words(qb, p0 + 2 * T_ + (u >> 1) * 8 + (u & 1), base) ^ FLIP
             for u in range(4)]                   # rows p, p+1, p+8, p+9
        for kk in range(2):
            for hb in range(2):
                pr = byte_perm(r[2 * kk], r[2 * kk + 1],
                               0x7632 if hb else 0x5410)
                for c in range(2):
                    lo, hi = to_bf16x2(pr, 2 * c + half)
                    row0, slot0 = A_SLOTS[2 * kk + ab]
                    a[2 * hb + c, row0 + G_, slot0 + 2 * T_] = lo
                    a[2 * hb + c, row0 + G_, slot0 + 2 * T_ + 1] = hi
    return a


def wgmma_registers(qb, n0, base, w, p0, half):
    """A of the wgmma kernel's 2 tiles for warp ``w`` of a warpgroup at
    columns ``base``: [tile][16 rows of the warp][16 slots]."""
    a = np.full((2, 16, 16), np.nan, np.float32)
    cw = n0 + base + 32 * w + 4 * G_
    r = [words(qb, p0 + 2 * T_ + (u >> 1) * 8 + (u & 1), cw) ^ FLIP
         for u in range(4)]
    for kk in range(2):
        for tj in range(2):
            pr = byte_perm(r[2 * kk], r[2 * kk + 1], 0x7632 if tj else 0x5410)
            for c in range(2):                    # tile rows g / g + 8
                lo, hi = to_bf16x2(pr, 2 * c + half)
                row0, slot0 = A_SLOTS[2 * kk + c]
                a[tj, row0 + G_, slot0 + 2 * T_] = lo
                a[tj, row0 + G_, slot0 + 2 * T_ + 1] = hi
    return a


def emulate(kind, x, qb, codes, scales, kp, n):
    """out = x @ w by the kernel's fragments, float64: every k-step's
    D = A @ B (B = x^T at the k-step's rows) scattered to the columns of
    its tile rows, times the k-step's group scale. Checks each register
    against the code of its (column, logical row) on the way."""
    m = x.shape[0]
    gs = 2 * kp // scales.shape[0]
    out = np.zeros((m, n))
    if kind == "mma":
        units = [(n0, ("mma", cn)) for n0 in range(0, n, 128)
                 for cn in range(2)]
    else:                         # two warpgroups split 256 columns
        units = [(n0, ("wg", base, w)) for n0 in range(0, n, 256)
                 for base in (0, 128) for w in range(4)]
    for n0, unit in units:
        for p0 in range(0, kp, 16):
            for half in range(2):
                rows = kstep_rows(p0, half, kp)
                assert len(set(rows // gs)) == 1    # one group a k-step
                if unit[0] == "mma":
                    a = mma_registers(qb, n0, unit[1], p0, half)
                    cols = [[n0 + mma_column(unit[1], j, r) for r in range(16)]
                            for j in range(4)]
                else:
                    a = wgmma_registers(qb, n0, unit[1], unit[2], p0, half)
                    cols = [[n0 + wgmma_column(unit[1], unit[2], j, r)
                             for r in range(16)] for j in range(2)]
                for j, cj in enumerate(cols):
                    cj = np.asarray(cj)
                    ok = cj < n
                    np.testing.assert_array_equal(
                        a[j][ok], codes[rows][:, cj[ok]].T)
                    d = a[j].astype(np.float64) @ x[:, rows].T   # [16, m]
                    s = scales[rows[0] // gs, cj[ok]]
                    out[:, cj[ok]] += (d[ok] * s[:, None]).T
    return out


@pytest.mark.parametrize("kind", ["mma", "wgmma"])
@pytest.mark.parametrize("gs", [64, 128, 0], ids=["g64", "g128", "per-channel"])
def test_fragment_mapping_reproduces_the_product(kind, gs):
    rng = np.random.default_rng(gs + len(kind))
    kp, n, m = 128, 512, 5
    k = 2 * kp
    gs = gs or k
    qb = rng.integers(0, 256, (kp, n), dtype=np.uint8)
    codes = tref.unpack_int4(_t(qb.view(np.int8))).numpy().astype(np.int64)
    scales = 2.0 ** rng.integers(-8, 0, (k // gs, n)).astype(np.float64)
    x = rng.integers(-9, 10, (m, k)).astype(np.float64)
    got = emulate(kind, x, qb, codes, scales, kp, n)
    w = codes.astype(np.float64) * np.repeat(scales, gs, axis=0)
    np.testing.assert_array_equal(got, x @ w)
    if gs < k:
        assert tmm.int4_regime(8, kp, n, gs, torch.bfloat16) == "mma"
        assert tmm.int4_regime(9, kp, n, gs, torch.bfloat16) == "wgmma"


@pytest.mark.parametrize("gs", [64, 128, 256, 4096])
@pytest.mark.parametrize("kp", [2048, 5504])
def test_no_k_step_or_stage_mixes_two_groups(kp, gs):
    # every group the gate admits: a 16-row k-step, a 64-row k-block (the
    # wgmma kernel's and both kernels' stage) and every split edge lie in
    # one group of each half, or end on a group edge
    if kp % gs and gs != 2 * kp:
        gs = 2 * kp
    for m in (8, 1024):
        assert tmm.int4_regime(m, kp, 4096, gs, torch.bfloat16) in (
            "mma", "wgmma")
    for span in (16, 64):
        for p0 in range(0, kp, span):
            for half in range(2):
                lo = half * kp + p0
                assert lo // gs == (lo + span - 1) // gs


# --------------------------------------------- the kernels' f32 arithmetic

def _stage_groups(pst, kp, gs):
    return pst // gs, (kp + pst) // gs


def kernel_order_mma(xb, codes, s, zs, kp, kch):
    """The few-rows kernel's f32 order, all columns at once: per block
    range and K warp, 16-row k-steps (an mma's f32 sum) into the low and
    high accumulators (one with per-channel scales), each stage's groups
    folded at their end (times the scale, minus the x row sums of the
    warp's rows times the zero points), the K warps added, the ranges'
    partials added, a per-channel scale at the end."""
    xf = xb.float()
    cf = codes.float()
    gs = 2 * kp // s.shape[0]
    scaled = zs is not None or gs < 2 * kp
    parts = []
    for kb in range(0, kp, kch):
        ke = min(kp, kb + kch)
        warps = []
        for kw in range(2):
            acc = torch.zeros(xf.shape[0], cf.shape[1])
            ach, tot = torch.zeros_like(acc), torch.zeros_like(acc)
            rl = torch.zeros(xf.shape[0])
            rh = torch.zeros_like(rl)
            for pst in range(kb, ke, 64):
                for j in range(2):
                    p = pst + 32 * kw + 16 * j
                    acc = acc + xf[:, p:p + 16] @ cf[p:p + 16]
                    d = xf[:, kp + p:kp + p + 16] @ cf[kp + p:kp + p + 16]
                    if scaled:
                        ach = ach + d
                    else:
                        acc = acc + d
                    rl = rl + xf[:, p:p + 16].sum(-1)
                    rh = rh + xf[:, kp + p:kp + p + 16].sum(-1)
                if scaled and ((pst + 64) % gs == 0 or pst + 64 == ke):
                    glo, ghi = _stage_groups(pst, kp, gs)
                    tot = tot + acc * s[glo] + ach * s[ghi]
                    if zs is not None:
                        tot = tot - rl[:, None] * zs[glo] - rh[:, None] * zs[ghi]
                    acc, ach = torch.zeros_like(acc), torch.zeros_like(acc)
                    rl, rh = torch.zeros_like(rl), torch.zeros_like(rh)
            warps.append(tot if scaled else acc)
        parts.append(warps[0] + warps[1])
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out if scaled else out * s[0]


def kernel_order_wgmma(xb, codes, s, zs, kp, kch):
    """The wgmma kernel's f32 order: per block range and stage, per
    channel one accumulator taking each 16-row k-step of the low then the
    high k-block; grouped, the low k-block's 4 k-steps into the
    accumulator, folded into the total times its group's scale (minus its
    x row sums times the zero points), then the high k-block's; then the
    ranges' partials and a per-channel scale at the end."""
    xf = xb.float()
    cf = codes.float()
    gs = 2 * kp // s.shape[0]
    grouped = zs is not None or gs < 2 * kp
    parts = []
    for kb in range(0, kp, kch):
        ke = min(kp, kb + kch)
        acc = torch.zeros(xf.shape[0], cf.shape[1])
        tot = torch.zeros_like(acc)
        for pst in range(kb, ke, 64):
            if not grouped:
                for ks in range(4):
                    for half in range(2):
                        p = half * kp + pst + 16 * ks
                        acc = acc + xf[:, p:p + 16] @ cf[p:p + 16]
                continue
            for half in range(2):
                p = half * kp + pst
                for ks in range(4):
                    q = p + 16 * ks
                    acc = acc + xf[:, q:q + 16] @ cf[q:q + 16]
                tot = tot + acc * s[p // gs]
                if zs is not None:
                    tot = tot - xf[:, p:p + 64].sum(-1)[:, None] * zs[p // gs]
                acc = torch.zeros_like(acc)
        parts.append(tot if grouped else acc)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out if grouped else out * s[0]


@pytest.mark.parametrize("with_zs", [False, True], ids=["sym", "zs"])
@pytest.mark.parametrize("gs", [128, 512], ids=["g128", "per-channel"])
@pytest.mark.parametrize("kind,m", [("mma", 8), ("mma", 3), ("wgmma", 72)])
def test_kernel_order_matches_jax_kernel_interpret_bf16(kind, m, gs, with_zs):
    # K/2 and N multiples of 128, so JAX runs its Pallas kernel (in
    # interpret mode); kch 64 and 128 split K/2 = 256 over blocks with
    # group edges (128) at and between the splits
    rng = np.random.default_rng(gs + m + with_zs)
    k, n = 512, 256
    kp = k // 2
    w = rng.standard_normal((k, n)).astype(np.float32) * k ** -0.5
    x = rng.standard_normal((m, k)).astype(np.float32)
    jq, js = jref.quantize_int4_groupwise(jnp.asarray(w), gs)
    zs = ((rng.integers(0, 16, np.asarray(js).shape) - 8).astype(np.float32)
          * np.asarray(js)) if with_zs else None
    want = np.asarray(jmm.quantized_matmul(
        jnp.asarray(x, jnp.bfloat16), jq, js, out_dtype=jnp.float32,
        interpret=True, bits=4, zs=None if zs is None else jnp.asarray(zs)))
    assert tmm.int4_regime(m, kp, n, gs, torch.bfloat16) == kind
    xb = _t(x).to(torch.bfloat16)
    q, s = _t(np.asarray(jq)), _t(np.asarray(js))
    z = None if zs is None else _t(zs)
    codes = tref.unpack_int4(q)
    order = kernel_order_mma if kind == "mma" else kernel_order_wgmma
    plain = tmm.quantized_matmul_int4_ref(xb, q, s, out_dtype=torch.float32,
                                          zs=z).numpy()
    tol = REL * float(np.abs(want).max())
    for kch in (64, 128, kp):
        got = order(xb, codes, s, z, kp, kch).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        np.testing.assert_allclose(got, plain, rtol=0, atol=tol)


# ------------------------------------------------------------- the gate

SEVEN_B = {"wqkv": (4096, 12288), "wo": (4096, 4096),
           "gate_up": (4096, 22016), "down": (11008, 4096),
           "lm_head": (4096, 32000)}


@pytest.mark.parametrize("m", [1, 8, 9, 1024])
@pytest.mark.parametrize("name", list(SEVEN_B))
def test_regime_sends_7b_products_to_the_tensor_cores(name, m):
    k, n = SEVEN_B[name]
    want = "mma" if m <= 8 else "wgmma"
    for gs in (k, 128):                       # bench.py --quant int4, AWQ
        assert tmm.int4_regime(m, k // 2, n, gs, torch.bfloat16) == want


@pytest.mark.parametrize("m,k,n,gs,dtype", [
    (8, 4096, 12288, 4096, torch.float32),    # f32 activations
    (1024, 4096, 12288, 128, torch.float32),
    (8, 4096, 4096, 32, torch.bfloat16),      # groups of 32
    (70, 300, 136, 30, torch.bfloat16),       # K 300 in 10 groups, N 136
    (77, 2000, 1000, 200, torch.bfloat16),    # group 200
    (8, 4096, 3000, 4096, torch.bfloat16),    # N % 16 != 0
    (8, 4002, 4096, 4002, torch.bfloat16),    # odd K/2
    (300, 4000, 3000, 4000, torch.bfloat16),  # K/2 2000: not whole stages
    (1024, 256, 264, 256, torch.bfloat16),    # N 264
])
def test_regime_sends_the_rest_to_the_fma_kernels(m, k, n, gs, dtype):
    got = tmm.int4_regime(m, k // 2, n, gs, dtype)
    fits = (dtype == torch.bfloat16 and n % 16 == 0 and (k // 2) % 64 == 0
            and (gs == k or gs % 64 == 0))
    assert not fits
    assert got == ("rows" if m <= 8 else "tiled")


@pytest.mark.parametrize("m", [1, 8, 9, 65, 300, 1024])
@pytest.mark.parametrize("name", list(SEVEN_B))
def test_splits_cover_k_in_whole_stages(name, m):
    k, n = SEVEN_B[name]
    kp = k // 2
    if m <= 8:
        splits = [(tmm.int4_mma_split(kp, n), -(-n // tmm.INT4_MMA_COLS),
                   3 * tmm.SM_COUNT)]
    else:
        splits = []
        for zeros, gs in ((False, k), (True, 128), (False, 128), (True, k)):
            bm, kch = tmm.int4_wgmma_split(m, kp, n, gs, zeros)
            grouped = zeros or gs < k
            assert bm == (64 if grouped or m <= 64 else 128)
            tiles = -(-n // 256) * -(-m // bm)
            splits.append((kch, tiles, tmm.SM_COUNT))
    for kch, tiles, wave in splits:
        chunks = -(-kp // kch)
        assert kch % tmm.INT4_KP == 0 and kch >= min(kp, tmm.INT4_MIN_KP)
        assert (chunks - 1) * kch < kp <= chunks * kch   # every row, once
        if chunks > 1:                        # splits only fill a wave
            assert tiles * chunks <= wave + tiles
