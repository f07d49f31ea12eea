"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (a CUDA kernel has no CPU mode) and
skips without one. The file imports no JAX, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_kernels.py --noconftest -m gpu -q

(``--noconftest``: the suite's conftest.py sets JAX up for the CPU).
Stated tolerances: the paged writes are exact (every page but the trash
page); attention 1e-4 absolute in float32 and 2e-2 in bfloat16 (both sides
accumulate in f32, in different orders; bf16 rounds the outputs), the
bf16 prefill forms (3, 3w, 8, 8q, 8w, 8qw and their sink forms 3s, 3ws,
8s, 8ws, on the tensor cores with P
split into two bf16 parts) within one bf16 ulp of each output plus 1e-5
of the largest (``_attn_ok``); model
logits 1e-3 in float32 with TF32 off. The INT8 kernels sum exact products
in f32 in another order than their plain versions: f32 outputs within
1e-5 of the output's largest magnitude, bf16 outputs within one bf16 ulp
beyond that, and the fused kernels' outputs (which also round
intermediates to the activation dtype) within 2e-2 of their standard
deviation in bf16. The INT4 kernel (with and without zero points) and
the W8A8 kernel are held to the INT8 product's rule; the quantizers
(INT4 weights, per-token int8 activations) are byte-equal card vs CPU.
"""

import numpy as np
import pytest
import torch

from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                      KVCacheConfig,
                                                      ModelConfig,
                                                      QuantConfig,
                                                      SamplingParams)
from simplellminference_tpu_torch.engine import Engine
from simplellminference_tpu_torch.models import llama
from simplellminference_tpu_torch.ops import ffn_fused as ff
from simplellminference_tpu_torch.ops import matmul as mm
from simplellminference_tpu_torch.ops import paged_append as pa
from simplellminference_tpu_torch.ops import qkv_fused as qf
from simplellminference_tpu_torch.ops import ref_ops
from simplellminference_tpu_torch.ops.attention import flash_prefill as fp
from simplellminference_tpu_torch.ops.attention import paged_decode as pd
from simplellminference_tpu_torch.ops.attention import paged_prefill as pp
from simplellminference_tpu_torch.ops.linear import QuantizedWeight
from simplellminference_tpu_torch.runtime.weights import quantize_params

pytestmark = pytest.mark.gpu
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 references
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pools(g, dev, dtype, b=3, kvn=4, ps=128, d=64, mp=2):
    shape = (2, b * mp + 1, kvn, ps, d)
    return (torch.randn(shape, generator=g, device=dev, dtype=dtype),
            torch.randn(shape, generator=g, device=dev, dtype=dtype))


def _tables(dev):
    # row 1 has an unmapped tail, row 2 is a dead slot (all -1)
    return torch.tensor([[4, 1], [0, -1], [-1, -1]], dtype=torch.int32,
                        device=dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [128, 100, 1])
def test_paged_append_prefill(cuda, dtype, s):
    g = torch.Generator(device=cuda).manual_seed(s)
    pk, pv = _pools(g, cuda, dtype)
    big = torch.randn((3, s, 3 * 4 * 64), generator=g, device=cuda,
                      dtype=dtype)
    nk = big[..., :256].reshape(3, s, 4, 64)
    nv = big[..., 512:].reshape(3, s, 4, 64)      # strided views
    a, r = (pk.clone(), pv.clone()), (pk.clone(), pv.clone())
    before = pa.paged_append_prefill.launches
    pa.paged_append_prefill(*a, nk, nv, _tables(cuda), 1)
    pa.paged_append_prefill_ref(*r, nk, nv, _tables(cuda), 1)
    assert pa.paged_append_prefill.launches == before + 1
    for x, y in zip(a, r):
        assert torch.equal(x[:, :-1], y[:, :-1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_append_decode(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    pk, pv = _pools(g, cuda, dtype)
    nk = torch.randn((3, 4, 64), generator=g, device=cuda, dtype=dtype)
    nv = torch.randn((3, 4, 64), generator=g, device=cuda, dtype=dtype)
    pos = torch.tensor([130, 7, 3], dtype=torch.int32, device=cuda)
    a, r = (pk.clone(), pv.clone()), (pk.clone(), pv.clone())
    pa.paged_append_decode(*a, nk, nv, _tables(cuda), pos, 0)
    pa.paged_append_decode_ref(*r, nk, nv, _tables(cuda), pos, 0)
    for x, y in zip(a, r):
        assert torch.equal(x[:, :-1], y[:, :-1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,n,kvn,d", [(128, 32, 32, 128), (100, 32, 4, 64),
                                       (33, 8, 2, 32)])
def test_flash_prefill(cuda, dtype, s, n, kvn, d):
    g = torch.Generator(device=cuda).manual_seed(s)
    q = torch.randn((2, s, n, d), generator=g, device=cuda, dtype=dtype)
    k = torch.randn((2, s, kvn, d), generator=g, device=cuda, dtype=dtype)
    v = torch.randn((2, s, kvn, d), generator=g, device=cuda, dtype=dtype)
    before = fp.flash_prefill.launches
    got = fp.flash_prefill(q, k, v)
    assert fp.flash_prefill.launches == before + 1
    want = fp.flash_prefill_ref(q, k, v)
    assert _attn_ok(got, want)


def _attn_ok(got, want):
    """Kernels 3 and 8 against their plain versions: f32 within ATTN_TOL,
    bf16 within one bf16 ulp of each output plus 1e-5 of the largest."""
    if got.dtype == torch.float32:
        return float((got - want).abs().max()) <= ATTN_TOL[torch.float32]
    return bool(torch.isfinite(got).all()) and _close(got, want, got.dtype)


# bf16 tensor-core tiles of kernel 3: packed GQA groups (32/8 at D 128,
# 32/4 at D 64), D 32, S 1, a window whose tiles start off a multiple of
# 64, a strided v, and key walks split over blocks (few tiles)
@pytest.mark.parametrize("b,s,n,kvn,d,window", [
    (8, 128, 32, 8, 128, None),      # Mistral-7B bench prompts
    (2, 256, 32, 4, 64, None),
    (3, 77, 8, 2, 32, None),
    (2, 1, 32, 8, 128, None),
    (3, 300, 32, 8, 128, 200),
    (1, 1000, 8, 8, 128, None),      # 16 tiles: the walk split 2 ways
    (1, 1500, 4, 4, 64, 1100),       # window walks split 2 ways
    (2, 70, 12, 4, 64, 20),          # group 3: 21 positions, a pad row
    (1, 50, 80, 1, 64, None),        # group 80: two head chunks a position
])
def test_flash_prefill_tensor_core_tiles(cuda, b, s, n, kvn, d, window):
    g = torch.Generator(device=cuda).manual_seed(s + n + d)
    bf = torch.bfloat16
    q = torch.randn((b, s, n, d), generator=g, device=cuda, dtype=bf)
    k = torch.randn((b, s, kvn, d), generator=g, device=cuda, dtype=bf)
    vbig = torch.randn((b, s, 3 * kvn * d), generator=g, device=cuda,
                       dtype=bf)
    v = vbig[..., kvn * d:2 * kvn * d].reshape(b, s, kvn, d)
    kern = fp.flash_prefill_window if window else fp.flash_prefill
    before = kern.launches
    got = fp.flash_prefill(q, k, v, window=window)
    assert kern.launches == before + 1
    assert _attn_ok(got, fp.flash_prefill_ref(q, k, v, window=window))


def _split_edge_lens(kvn, span, wins=1, rows=1):
    """Batches of kv_lens for the split edges of the key walk: 1, every
    boundary of the splits over the whole span +- 1 and the span itself,
    each batch as large as keeps more than one split, sequence 0 at kv_len
    0 and the last one left for the test's dead all -1 slot."""
    rb = pd.row_blocks(rows)
    b = max(i for i in range(2, 65) if pd.decode_splits(i, kvn, span, rb) > 1)
    z = pd.decode_splits(b, kvn, span, rb)
    cuts = [lo for lo, _hi in pd.split_keys(span, wins, 0, span, z)][1:]
    edges = sorted({min(span, c + e) for c in cuts for e in (-1, 0, 1)}
                   | {1, span - 1, span})
    assert b >= 4
    return [([0] + edges[i:i + b - 2] + [wins + 7 * j for j in range(b)])[:b]
            for i in range(0, len(edges), b - 2)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,kvn,d", [(32, 32, 128), (32, 4, 64)])
@pytest.mark.parametrize("edges", [False, True], ids=["lens", "split-edges"])
def test_paged_flash_decode(cuda, dtype, n, kvn, d, edges):
    g = torch.Generator(device=cuda).manual_seed(n + kvn)
    batches = ([[1, 128, 129, 200, 0, 57]] if not edges
               else _split_edge_lens(kvn, 16 * 128, rows=n // kvn))
    for lens in batches:
        _check_paged_flash_decode(g, cuda, dtype, n, kvn, d, lens,
                                  2 if not edges else 16)


def _check_paged_flash_decode(g, cuda, dtype, n, kvn, d, lens, mp):
    b, ps = len(lens), 128
    pk, pv = _pools(g, cuda, dtype, b=b, kvn=kvn, ps=ps, d=d, mp=mp)
    q = torch.randn((b, n, d), generator=g, device=cuda, dtype=dtype)
    tables = torch.randperm(b * mp, generator=g, device=cuda).to(
        torch.int32).reshape(b, mp)
    tables[-1] = -1                  # a dead slot: every entry unmapped
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = pd.paged_flash_decode.launches
    got = pd.paged_flash_decode(q, pk, pv, tables, kv, 1)
    assert pd.paged_flash_decode.launches == before + 1
    want = pd.paged_flash_decode_ref(q, pk, pv, tables, kv, 1)
    assert float((got.float() - want.float()).abs().max()) <= ATTN_TOL[dtype]
    assert not got[lens.index(0)].any()   # kv_len 0 -> zero output
    assert not got[-1].any()              # the dead slot reads zeros


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,n,kvn,d,ps", [(64, 32, 32, 128, 128),
                                          (100, 32, 4, 64, 16),
                                          (1, 8, 2, 32, 8)])
def test_paged_flash_prefill(cuda, dtype, s, n, kvn, d, ps):
    g = torch.Generator(device=cuda).manual_seed(s + n)
    b, mp = 4, 48 * 8 // ps
    pk, pv = _pools(g, cuda, dtype, b=b, kvn=kvn, ps=ps, d=d, mp=mp)
    q = torch.randn((b, s, n, d), generator=g, device=cuda, dtype=dtype)
    tables = torch.randperm(b * mp, generator=g, device=cuda).to(
        torch.int32).reshape(b, mp)
    # ragged page-aligned offsets; row 2 has an unmapped page inside
    # kv_len; row 3 is a batch's padding row (-1 table, kv_len 1)
    offs = torch.tensor([0, 2 * ps, ps, 0], dtype=torch.int32, device=cuda)
    kv = offs + torch.tensor([s, max(s - 7, 1), s, 1], dtype=torch.int32,
                             device=cuda)
    tables[2, 0] = -1
    tables[3] = -1
    before = pp.paged_flash_prefill.launches
    got = pp.paged_flash_prefill(q, pk, pv, tables, kv, offs, 1)
    assert pp.paged_flash_prefill.launches == before + 1
    want = pp.paged_flash_prefill_ref(q, pk, pv, tables, kv, offs, 1)
    assert bool(torch.isfinite(got).all())
    assert _attn_ok(got, want)


# bf16 tensor-core tiles of kernel 8, every KV kind: packed GQA groups,
# D 32, Sq 1, page 16 (a key tile over four pages), ragged offsets off a
# page multiple, an unmapped page inside kv_len, a padding row
@pytest.mark.parametrize("int8", [False, True], ids=["bf16-kv", "int8-kv"])
@pytest.mark.parametrize("s,n,kvn,d,ps", [(256, 32, 8, 128, 128),
                                          (64, 32, 4, 64, 16),
                                          (37, 8, 2, 32, 16),
                                          (1, 32, 8, 128, 16),
                                          (45, 6, 2, 64, 16)])
def test_paged_flash_prefill_tensor_core_tiles(cuda, int8, s, n, kvn, d, ps):
    g = torch.Generator(device=cuda).manual_seed(s + n + d + int8)
    b, mp = 4, -(-(s + 300) // ps)
    if int8:
        pk, pv, ks, vs = _quant_pools(g, cuda, b=b, kvn=kvn, ps=ps, d=d,
                                      mp=mp)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        pk, pv = _pools(g, cuda, torch.bfloat16, b=b, kvn=kvn, ps=ps, d=d,
                        mp=mp)
        scales = {}
    q = torch.randn((b, s, n, d), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    tables = torch.randperm(b * mp, generator=g, device=cuda).to(
        torch.int32).reshape(b, mp)
    offs = torch.tensor([0, 37, 300, 0], dtype=torch.int32, device=cuda)
    kv = offs + torch.tensor([s, max(s - 5, 1), s, 1], dtype=torch.int32,
                             device=cuda)
    tables[2, 1] = -1
    tables[3] = -1
    kern = (pp.paged_flash_prefill_int8kv if int8
            else pp.paged_flash_prefill)
    before = kern.launches
    got = pp.paged_flash_prefill(q, pk, pv, tables, kv, offs, 1, **scales)
    assert kern.launches == before + 1
    want = pp.paged_flash_prefill_ref(q, pk, pv, tables, kv, offs, 1,
                                      **scales)
    assert _attn_ok(got, want)


# the split key walk's edges: one sequence (few tiles, the walk split 4
# ways over a 2048-key table, 2 ways over a 1500-key band) at offsets that
# put its tiles' last keys on both sides of the splits' 64-key cuts
@pytest.mark.parametrize("window", [None, 1500])
def test_paged_flash_prefill_split_edges(cuda, window):
    from simplellminference_tpu_torch.ops.attention import prefill_tiles
    g = torch.Generator(device=cuda).manual_seed(5)
    n, kvn, d, ps, mp, s = 32, 8, 128, 16, 128, 64
    assert prefill_tiles.launch_splits(1, s, n, kvn, window or 0,
                                       mp * ps) > 1
    pk, pv = _pools(g, cuda, torch.bfloat16, b=1, kvn=kvn, ps=ps, d=d, mp=mp)
    tables = torch.randperm(mp, generator=g, device=cuda).to(
        torch.int32).reshape(1, mp)
    q = torch.randn((1, s, n, d), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    for off in (0, 1, 48, 49, 63, 64, 65, 447, 448, 449, 895, 960, 1500,
                1983):
        offs = torch.tensor([off], dtype=torch.int32, device=cuda)
        kv = offs + s
        got = pp.paged_flash_prefill(q, pk, pv, tables, kv, offs, 1,
                                     window=window)
        want = pp.paged_flash_prefill_ref(q, pk, pv, tables, kv, offs, 1,
                                          window=window)
        assert _attn_ok(got, want), off


def test_prefix_cache_engine_card_matches_cpu(cuda):
    # the JAX Engine's default configuration (prefix cache on) with
    # chunked prefill: sharing, a suffix batch and a persistent hit run
    # the kernels only and give the CPU's greedy tokens
    cfg = ModelConfig.tiny_test(num_layers=2)
    p_cpu = llama.init_params(cfg, seed=5, device="cpu")
    p_gpu = _to(p_cpu, cuda)
    ecfg = EngineConfig(max_batch_size=4, prefill_chunk=16,
                        kv=KVCacheConfig(page_size=8, num_pages=64,
                                         max_pages_per_seq=8,
                                         kv_dtype="f32"))
    system = list(range(3, 35))
    waves = [[system + [40]], [system + [41, 42], system + [43] * 9],
             [system + [44, 45, 46]]]
    refs = (pa.paged_append_prefill_ref, pp.paged_flash_prefill_ref,
            fp.flash_prefill_ref, pd.paged_flash_decode_ref)
    calls = [f.cuda_calls for f in refs]
    launches = pp.paged_flash_prefill.launches
    outs = []
    for p, dev in ((p_cpu, "cpu"), (p_gpu, cuda)):
        eng = Engine(cfg, p, ecfg, decode_burst=4, device=dev)
        outs.append([eng.generate(w, SamplingParams(max_new_tokens=6))
                     for w in waves])
        assert eng.metrics.prefix_cache_persistent_hits == 3
    assert outs[0] == outs[1]
    assert [f.cuda_calls for f in refs] == calls
    assert pp.paged_flash_prefill.launches > launches


def test_cuda_entry_points_never_take_the_plain_path(cuda):
    cfg = ModelConfig.tiny_test(num_layers=2)
    params = llama.init_params(cfg, seed=0)          # CUDA by default
    assert params["embed"].is_cuda
    ecfg = EngineConfig(max_batch_size=2, prefix_cache_entries=0,
                        kv=KVCacheConfig(page_size=16, num_pages=16,
                                         max_pages_per_seq=4,
                                         kv_dtype="f32"))
    refs = (pa.paged_append_decode_ref, pa.paged_append_prefill_ref,
            fp.flash_prefill_ref, pd.paged_flash_decode_ref)
    calls = [f.cuda_calls for f in refs]
    eng = Engine(cfg, params, ecfg, decode_burst=4)
    out = eng.generate([[1, 2, 3], [4, 5, 6, 7, 8]],
                       SamplingParams(max_new_tokens=9))
    assert [len(o) for o in out] == [9, 9]
    assert [f.cuda_calls for f in refs] == calls


def test_engine_card_matches_cpu(cuda):
    cfg = ModelConfig.tiny_test(num_layers=2)
    params_cpu = llama.init_params(cfg, seed=3, device="cpu")
    params_gpu = {k: ({kk: vv.to(cuda) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.to(cuda))
                  for k, v in params_cpu.items()}
    ecfg = EngineConfig(max_batch_size=3, prefix_cache_entries=0,
                        kv=KVCacheConfig(page_size=16, num_pages=32,
                                         max_pages_per_seq=4,
                                         kv_dtype="f32"))
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 11],
               list(range(20, 40))]
    s = SamplingParams(max_new_tokens=12)
    e_cpu = Engine(cfg, params_cpu, ecfg, decode_burst=4, device="cpu")
    e_gpu = Engine(cfg, params_gpu, ecfg, decode_burst=4, device=cuda)
    r_cpu = [e_cpu.add_request(prompt_ids=p, sampling=s) for p in prompts]
    r_gpu = [e_gpu.add_request(prompt_ids=p, sampling=s) for p in prompts]
    e_cpu.run()
    e_gpu.run()
    for a, b in zip(r_cpu, r_gpu):
        assert b.output_ids == a.output_ids
        np.testing.assert_allclose(b.output_logprobs, a.output_logprobs,
                                   atol=1e-3)


def _bf16_ulp(a):
    return torch.exp2(torch.floor(torch.log2(a.abs().clamp_min(2.0 ** -100)))
                      - 7)


def _qw(g, dev, shape, groups):
    q = torch.randint(-127, 128, shape, generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand((*shape[:-2], groups, shape[-1]), generator=g,
                   device=dev) * 1e-2 + 5e-3
    return q, s


@pytest.mark.parametrize("m,k,n,groups,xdt,odt", [
    (8, 4096, 4096, 1, torch.bfloat16, torch.bfloat16),   # decode wo
    (8, 4096, 3000, 32, torch.float32, torch.float32),    # rows, grouped
    (3, 200, 40, 5, torch.float32, torch.float32),        # K % 128 != 0
    (100, 512, 384, 4, torch.bfloat16, torch.float32),    # mma, group 128
    (70, 300, 136, 1, torch.float32, torch.bfloat16),     # N % 16 != 0
    # the few-rows tensor-core kernel (rmma): M 1 to 8, the head's f32
    # output, K split and whole, an odd 64-column group; grouped scales
    # keep the FMA kernel (rows)
    (1, 4096, 32000, 1, torch.bfloat16, torch.float32),
    (8, 4096, 32000, 1, torch.bfloat16, torch.float32),
    (1, 4096, 4096, 1, torch.bfloat16, torch.bfloat16),
    (8, 4096, 4160, 1, torch.bfloat16, torch.bfloat16),
    (3, 512, 192, 1, torch.bfloat16, torch.float32),
    (5, 11008, 4096, 1, torch.bfloat16, torch.bfloat16),
    (8, 4096, 4096, 32, torch.bfloat16, torch.bfloat16),
    # the mma kernel: M across its 64- and 128-row tiles and K splits,
    # N off a multiple of 128, K 4000, groups of 32, 128 and 125 (fma)
    (9, 4096, 4096, 1, torch.bfloat16, torch.bfloat16),
    (16, 4096, 4000, 1, torch.bfloat16, torch.bfloat16),
    (40, 4096, 4096, 1, torch.bfloat16, torch.bfloat16),
    (40, 4096, 32000, 1, torch.bfloat16, torch.float32),
    (64, 4000, 4096, 125, torch.bfloat16, torch.bfloat16),
    (65, 4000, 1040, 1, torch.bfloat16, torch.float32),
    (256, 4096, 6144, 32, torch.bfloat16, torch.bfloat16),
    (256, 14336, 4096, 1, torch.bfloat16, torch.bfloat16),
    (1024, 4096, 12288, 32, torch.bfloat16, torch.bfloat16),
    (1024, 1000, 2000, 8, torch.bfloat16, torch.float32),  # group 125
    (1000, 4096, 4000, 128, torch.bfloat16, torch.float32),
])
def test_quantized_matmul(cuda, m, k, n, groups, xdt, odt):
    g = torch.Generator(device=cuda).manual_seed(m + k)
    q, s = _qw(g, cuda, (2, k, n), groups)
    x = torch.randn((m, k), generator=g, device=cuda).to(xdt)
    regime = mm.tiled_regime(m, k, n, k // groups, xdt)
    before = (mm.quantized_matmul.launches, dict(mm.REGIME_LAUNCHES))
    got = mm.quantized_matmul(x, q, s, out_dtype=odt, layer=1)
    assert mm.quantized_matmul.launches == before[0] + 1
    assert mm.REGIME_LAUNCHES == {r: c + (r == regime)
                                  for r, c in before[1].items()}
    want = mm.quantized_matmul_ref(x, q, s, out_dtype=odt, layer=1)
    assert got.dtype == odt and got.shape == (m, n)
    diff = (got.float() - want.float()).abs()
    if odt == torch.float32:
        assert float(diff.max()) <= 1e-5 * float(want.abs().max())
    else:
        ulp = _bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
        assert bool((diff <= ulp + 1e-5 * float(want.float().abs().max()))
                    .all())


class _one_launch:
    """Within the block, one launch of ``regime`` in the regime counts
    ``counts`` and none of the others."""

    def __init__(self, counts, regime):
        self.counts, self.regime = counts, regime

    def __enter__(self):
        self.before = dict(self.counts)

    def __exit__(self, *exc):
        if exc[0] is None:
            assert self.counts == {r: c + (r == self.regime)
                                   for r, c in self.before.items()}


def _check_qkv(cuda, g, xdt, pdt, n, kvn, d, pos, tables, h=512, ps=16,
               kv_layer=None):
    """One fused qkv append (weights of layer 1; pools at layer 1, or at
    ``kv_layer``: the form 6k) against its plain version."""
    L, b, mp = 2, tables.shape[0], tables.shape[1]
    kli = 1 if kv_layer is None else kv_layer
    form = (qf.fused_qkv_append if kv_layer is None
            else qf.fused_qkv_append_kv_layer)
    kw = {} if kv_layer is None else dict(kv_layer=kv_layer)
    nq = (n + 2 * kvn) * d
    wq, ws = _qw(g, cuda, (L, h, nq), 1)
    nw = torch.rand((L, h), generator=g, device=cuda).to(xdt) + 0.5
    x = torch.randn((b, h), generator=g, device=cuda).to(xdt)
    sin, cos = ref_ops.rope_tables(pos, d, 10000.0)
    pk, pv = _pools(g, cuda, pdt, b=b, kvn=kvn, ps=ps, d=d, mp=mp)
    a, r = (pk.clone(), pv.clone()), (pk.clone(), pv.clone())
    before = form.launches
    with _one_launch(qf.QKV_REGIME_LAUNCHES,
                     qf.qkv_regime(b, h, nq, d, xdt)):
        qa, *_ = qf.fused_qkv_append(x, nw, wq, ws, sin, cos, *a, 1, pos,
                                     n_heads=n, kv_heads=kvn, tables=tables,
                                     **kw)
    assert form.launches == before + 1
    qr, *_ = qf.fused_qkv_append_ref(x, nw, wq, ws, sin, cos, *r, 1, pos,
                                     n_heads=n, kv_heads=kvn, tables=tables,
                                     **kw)
    tol = 1e-5 if xdt == torch.float32 else 2e-2
    sd = float(qr.float().std())
    assert float((qa.float() - qr.float()).abs().max()) <= tol * sd
    written = torch.zeros(pk.shape, dtype=torch.bool, device=cuda)
    for i, p in enumerate(pos.tolist()):
        page = int(tables[i, p // ps])
        written[kli, page if page >= 0 else pk.shape[1] - 1, :,
                p % ps] = True
    for x_a, x_r in zip(a, r):
        assert torch.equal(x_a[~written], x_r[~written])
        w_r = x_r[written].float()
        err = float((x_a[written].float() - w_r).abs().max())
        assert err <= tol * float(w_r.std())


@pytest.mark.parametrize("xdt,pdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("n,kvn,d", [(8, 2, 64), (4, 4, 128), (8, 4, 32)])
def test_fused_qkv_append(cuda, xdt, pdt, n, kvn, d):
    g = torch.Generator(device=cuda).manual_seed(n * kvn + d)
    pos = torch.tensor([5, 20, 40], dtype=torch.int32, device=cuda)
    tables = torch.tensor([[3, 7, 1], [0, 5, 8], [2, 4, -1]],
                          dtype=torch.int32, device=cuda)
    _check_qkv(cuda, g, xdt, pdt, n, kvn, d, pos, tables)


@pytest.mark.parametrize("b,mp", [(20, 3), (64, 8)])
def test_fused_qkv_append_many_rows(cuda, b, mp):
    # 20 rows: two full 8-row tiles and a partial one; 64: the most the
    # kernels take (eight n8 tiles on the tensor cores); row 7 unmapped
    g = torch.Generator(device=cuda).manual_seed(b)
    ps = 16
    pos = (2 * torch.arange(b, device=cuda)).to(torch.int32)
    tables = torch.arange(b * mp, dtype=torch.int32,
                          device=cuda).reshape(b, mp)
    tables[7, 14 // ps] = -1
    _check_qkv(cuda, g, torch.bfloat16, torch.bfloat16, 4, 2, 64, pos,
               tables, h=256, ps=ps)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 3, 8, 9, 40, 64])
def test_fused_ffn(cuda, dtype, m):
    # bf16 rows take the tensor-core regime (H 512, I 1408: multiples of
    # 64), f32 rows the FMA kernels
    g = torch.Generator(device=cuda).manual_seed(m)
    L, h, inter = 2, 512, 1408
    q1, s1 = _qw(g, cuda, (L, h, 2 * inter), 1)
    q2, s2 = _qw(g, cuda, (L, inter, h), 1)
    nw = torch.rand((L, h), generator=g, device=cuda).to(dtype) + 0.5
    x = torch.randn((m, h), generator=g, device=cuda).to(dtype)
    regime = ff.ffn_regime(m, h, inter, dtype)
    assert regime == ("mma" if dtype == torch.bfloat16 else "fma")
    before = (ff.fused_ffn.launches, dict(ff.FFN_REGIME_LAUNCHES))
    got = ff.fused_ffn(x, nw, q1, s1, q2, s2, 1)
    assert ff.fused_ffn.launches == before[0] + 1
    assert ff.FFN_REGIME_LAUNCHES == {r: c + (r == regime)
                                      for r, c in before[1].items()}
    want = ff.fused_ffn_ref(x, nw, q1, s1, q2, s2, 1)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    sd = float(want.float().std())
    assert float((got.float() - want.float()).abs().max()) <= tol * sd


@pytest.mark.parametrize("m", [1, 8, 9, 40, 64])
@pytest.mark.parametrize("h,inter", [(4096, 11008), (4096, 14336),
                                     (480, 1400)],
                         ids=["llama2-7b", "mistral-7b", "h480-fma"])
def test_fused_ffn_tensor_core_regime(cuda, h, inter, m):
    # bf16 rows at the 7B widths (K split over blocks, the last block at a
    # column tile finishing it) and at widths off a multiple of 64 (the
    # FMA kernels); the fused tolerance of test_fused_ffn. Scales as
    # bench.py draws them (K^-0.5 / 127, times 0.5-1.5): with _qw's 1e-2
    # the FFN's output at 7B width reaches 5e5, where one bf16 ulp (of a
    # summation-order flip) is 4096, above 2e-2 of the output's std
    g = torch.Generator(device=cuda).manual_seed(m + h + inter)
    q1, s1 = _qw(g, cuda, (2, h, 2 * inter), 1)
    q2, s2 = _qw(g, cuda, (2, inter, h), 1)
    s1 = s1 * (h ** -0.5 / 127 / 1e-2)
    s2 = s2 * (inter ** -0.5 / 127 / 1e-2)
    nw = (torch.rand((2, h), generator=g, device=cuda) + 0.5).to(
        torch.bfloat16)
    x = torch.randn((m, h), generator=g, device=cuda).to(torch.bfloat16)
    regime = ff.ffn_regime(m, h, inter, torch.bfloat16)
    assert regime == ("fma" if h % 64 or inter % 64 else "mma")
    before = dict(ff.FFN_REGIME_LAUNCHES)
    got = ff.fused_ffn(x, nw, q1, s1, q2, s2, 1)
    assert ff.FFN_REGIME_LAUNCHES == {r: c + (r == regime)
                                      for r, c in before.items()}
    want = ff.fused_ffn_ref(x, nw, q1, s1, q2, s2, 1)
    sd = float(want.float().std())
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * sd


def test_fused_ffn_tensor_core_graph_replay(cuda):
    # the K-split grids' arrival counters are left at zero by every launch:
    # replays of a captured call (and eager calls between them) give the
    # eager output bit for bit
    g = torch.Generator(device=cuda).manual_seed(11)
    h, inter, m = 4096, 11008, 8
    q1, s1 = _qw(g, cuda, (1, h, 2 * inter), 1)
    q2, s2 = _qw(g, cuda, (1, inter, h), 1)
    nw = torch.ones((1, h), device=cuda, dtype=torch.bfloat16)
    x = torch.randn((m, h), generator=g, device=cuda).to(torch.bfloat16)
    eager = ff.fused_ffn(x, nw, q1, s1, q2, s2, 0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ff.fused_ffn(x, nw, q1, s1, q2, s2, 0)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert torch.equal(ff.fused_ffn(x, nw, q1, s1, q2, s2, 0), eager)


@pytest.mark.parametrize("kind", ["qkv", "qkv-int8kv", "rows"])
def test_tensor_core_qkv_and_rows_graph_replay(cuda, kind):
    # 6m's and 5r's K-split grids leave their arrival counters at zero:
    # replays of a captured call (and eager calls between them) give the
    # eager output bit for bit (7B widths, 8 rows: 5 and 8 K ranges)
    g = torch.Generator(device=cuda).manual_seed(12)
    h, b = 4096, 8
    x = torch.randn((b, h), generator=g, device=cuda).to(torch.bfloat16)
    if kind == "rows":
        q, s = _qw(g, cuda, (1, h, h), 1)
        assert mm.tiled_regime(b, h, h, h, x.dtype) == "rmma"

        def call():
            return (mm.quantized_matmul(x, q, s, layer=0),)
    else:
        n, kvn, d, ps, mp = 32, 32, 128, 128, 2
        nq = (n + 2 * kvn) * d
        wq, ws = _qw(g, cuda, (1, h, nq), 1)
        assert qf.qkv_regime(b, h, nq, d, x.dtype) == "mma"
        nw = torch.ones((1, h), device=cuda, dtype=torch.bfloat16)
        pos = (100 + torch.arange(b, device=cuda)).to(torch.int32)
        tables = torch.arange(b * mp, dtype=torch.int32,
                              device=cuda).reshape(b, mp)
        sin, cos = ref_ops.rope_tables(pos, d, 10000.0)
        if kind == "qkv":
            pools = _pools(g, cuda, torch.bfloat16, b=b, kvn=kvn, ps=ps, d=d,
                           mp=mp)
        else:
            pools = _quant_pools(g, cuda, b=b, kvn=kvn, ps=ps, d=d, mp=mp)
        extra = (dict(cache_ks=pools[2], cache_vs=pools[3])
                 if kind == "qkv-int8kv" else {})

        def call():
            qo, *_ = qf.fused_qkv_append(x, nw, wq, ws, sin, cos, pools[0],
                                         pools[1], 0, pos, tables=tables,
                                         **extra)
            return (qo, *(p.clone() for p in pools))
    eager = call()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, e) for o, e in zip(out, eager))
        assert all(torch.equal(o, e) for o, e in zip(call(), eager))


def _int8_params(cfg, seed, device):
    p = llama.init_params(cfg, seed=seed, device=device)
    return quantize_params(p, QuantConfig(mode="int8", group_size=0,
                                          quantize_lm_head=True))


def test_int8_engine_runs_the_kernels_only(cuda):
    cfg = ModelConfig.tiny_test(num_layers=2)
    params = _int8_params(cfg, 0, cuda)
    ecfg = EngineConfig(max_batch_size=2, prefix_cache_entries=0,
                        kv=KVCacheConfig(page_size=16, num_pages=16,
                                         max_pages_per_seq=4,
                                         kv_dtype="f32"))
    refs = (pa.paged_append_decode_ref, pa.paged_append_prefill_ref,
            fp.flash_prefill_ref, pd.paged_flash_decode_ref,
            mm.quantized_matmul_ref, qf.fused_qkv_append_ref,
            ff.fused_ffn_ref)
    calls = [f.cuda_calls for f in refs]
    kerns = (mm.quantized_matmul, qf.fused_qkv_append, ff.fused_ffn)
    launches = [f.launches for f in kerns]
    eng = Engine(cfg, params, ecfg, decode_burst=4)
    out = eng.generate([[1, 2, 3], [4, 5, 6, 7, 8]],
                       SamplingParams(max_new_tokens=9))
    assert [len(o) for o in out] == [9, 9]
    assert [f.cuda_calls for f in refs] == calls
    assert all(f.launches > n for f, n in zip(kerns, launches))


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, QuantizedWeight):
        return QuantizedWeight(q=tree.q.to(dev), scales=tree.scales.to(dev),
                               bits=tree.bits,
                               zs=None if tree.zs is None else tree.zs.to(dev))
    return tree.to(dev)


def test_int8_engine_card_matches_cpu(cuda):
    cfg = ModelConfig.tiny_test(num_layers=2)
    p_cpu = _int8_params(cfg, 3, "cpu")
    p_gpu = _to(p_cpu, cuda)
    ecfg = EngineConfig(max_batch_size=3, prefix_cache_entries=0,
                        kv=KVCacheConfig(page_size=16, num_pages=32,
                                         max_pages_per_seq=4,
                                         kv_dtype="f32"))
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5, 4, 3, 2, 1, 0, 11],
               list(range(20, 40))]
    s = SamplingParams(max_new_tokens=12)
    outs = [Engine(cfg, p, ecfg, decode_burst=4, device=dev).generate(
        prompts, s) for p, dev in ((p_cpu, "cpu"), (p_gpu, cuda))]
    assert outs[0] == outs[1]


# ------------------------------------------------------------- INT8 KV
# Kernels 9 and 10 are byte-equal to their plain versions; the INT8-KV
# attention forms are held at the attention tolerances; the quantizing
# fused qkv at codes at most 1 apart and scales within one bf16 ulp of
# the absmax (bf16) or 1e-5 relative (f32).

def _quant_pools(g, dev, b=3, kvn=4, ps=128, d=64, mp=2):
    """INT8 pools as the Engine fills them: N(0, 1) rows (as _pools draws)
    quantized per (token, head) by the plain quantize_kv."""
    shape = (2, b * mp + 1, kvn, ps, d)
    qk, sk = pa.quantize_kv(torch.randn(shape, generator=g, device=dev))
    qv, sv = pa.quantize_kv(torch.randn(shape, generator=g, device=dev))
    return qk, qv, sk, sv


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [128, 100, 1])
def test_paged_append_prefill_quant(cuda, dtype, s):
    g = torch.Generator(device=cuda).manual_seed(s)
    pools = _quant_pools(g, cuda)
    big = torch.randn((3, s, 3 * 4 * 64), generator=g, device=cuda,
                      dtype=dtype) * 3
    nk = big[..., :256].reshape(3, s, 4, 64)
    nv = big[..., 512:].reshape(3, s, 4, 64)      # strided views
    a, r = [p.clone() for p in pools], [p.clone() for p in pools]
    before = pa.paged_append_prefill_quant.launches
    pa.paged_append_prefill_quant(*a, nk, nv, _tables(cuda), 1)
    assert pa.paged_append_prefill_quant.launches == before + 1
    pa.paged_append_prefill_quant_ref(*r, nk, nv, _tables(cuda), 1)
    for x, y in zip(a, r):
        assert torch.equal(x[:, :-1], y[:, :-1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_append_decode_quant(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    pools = _quant_pools(g, cuda)
    nk = torch.randn((3, 4, 64), generator=g, device=cuda, dtype=dtype)
    nv = torch.randn((3, 4, 64), generator=g, device=cuda, dtype=dtype)
    pos = torch.tensor([130, 7, 3], dtype=torch.int32, device=cuda)
    a, r = [p.clone() for p in pools], [p.clone() for p in pools]
    before = pa.paged_append_decode_quant.launches
    pa.paged_append_decode_quant(*a, nk, nv, _tables(cuda), pos, 0)
    assert pa.paged_append_decode_quant.launches == before + 1
    pa.paged_append_decode_quant_ref(*r, nk, nv, _tables(cuda), pos, 0)
    for x, y in zip(a, r):
        assert torch.equal(x[:, :-1], y[:, :-1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,kvn,d", [(32, 32, 128), (32, 4, 64)])
def test_paged_flash_decode_int8kv(cuda, dtype, n, kvn, d):
    g = torch.Generator(device=cuda).manual_seed(n + kvn)
    lens = [1, 128, 129, 200, 0, 57]
    b, ps, mp = len(lens), 128, 2
    pk, pv, ks, vs = _quant_pools(g, cuda, b=b, kvn=kvn, ps=ps, d=d, mp=mp)
    q = torch.randn((b, n, d), generator=g, device=cuda, dtype=dtype)
    tables = torch.randperm(b * mp, generator=g, device=cuda).to(
        torch.int32).reshape(b, mp)
    tables[-1] = -1
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = (pd.paged_flash_decode.launches,
              pd.paged_flash_decode_int8kv.launches)
    got = pd.paged_flash_decode(q, pk, pv, tables, kv, 1, k_scale=ks,
                                v_scale=vs)
    assert (pd.paged_flash_decode.launches,
            pd.paged_flash_decode_int8kv.launches) == (before[0],
                                                        before[1] + 1)
    want = pd.paged_flash_decode_ref(q, pk, pv, tables, kv, 1, k_scale=ks,
                                     v_scale=vs)
    assert got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) <= ATTN_TOL[dtype]
    assert not got[4].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,n,kvn,d,ps", [(64, 32, 32, 128, 128),
                                          (100, 32, 4, 64, 16)])
def test_paged_flash_prefill_int8kv(cuda, dtype, s, n, kvn, d, ps):
    g = torch.Generator(device=cuda).manual_seed(s + n)
    b, mp = 4, 48 * 8 // ps
    pk, pv, ks, vs = _quant_pools(g, cuda, b=b, kvn=kvn, ps=ps, d=d, mp=mp)
    q = torch.randn((b, s, n, d), generator=g, device=cuda, dtype=dtype)
    tables = torch.randperm(b * mp, generator=g, device=cuda).to(
        torch.int32).reshape(b, mp)
    offs = torch.tensor([0, 2 * ps, ps, 0], dtype=torch.int32, device=cuda)
    kv = offs + torch.tensor([s, max(s - 7, 1), s, 1], dtype=torch.int32,
                             device=cuda)
    tables[2, 0] = -1
    tables[3] = -1
    before = pp.paged_flash_prefill_int8kv.launches
    got = pp.paged_flash_prefill(q, pk, pv, tables, kv, offs, 1, k_scale=ks,
                                 v_scale=vs)
    assert pp.paged_flash_prefill_int8kv.launches == before + 1
    want = pp.paged_flash_prefill_ref(q, pk, pv, tables, kv, offs, 1,
                                      k_scale=ks, v_scale=vs)
    assert bool(torch.isfinite(got).all())
    assert _attn_ok(got, want)


@pytest.mark.parametrize("xdt", DTYPES)
@pytest.mark.parametrize("n,kvn,d", [(8, 2, 64), (4, 4, 128), (8, 4, 32)])
def test_fused_qkv_append_int8kv(cuda, xdt, n, kvn, d):
    g = torch.Generator(device=cuda).manual_seed(n * kvn + d)
    L, h, ps = 2, 512, 16
    pos = torch.tensor([5, 20, 40], dtype=torch.int32, device=cuda)
    tables = torch.tensor([[3, 7, 1], [0, 5, 8], [2, 4, -1]],
                          dtype=torch.int32, device=cuda)
    nq = (n + 2 * kvn) * d
    wq, ws = _qw(g, cuda, (L, h, nq), 1)
    nw = torch.rand((L, h), generator=g, device=cuda).to(xdt) + 0.5
    x = torch.randn((3, h), generator=g, device=cuda).to(xdt)
    sin, cos = ref_ops.rope_tables(pos, d, 10000.0)
    pools = _quant_pools(g, cuda, b=3, kvn=kvn, ps=ps, d=d, mp=3)
    a, r = [p.clone() for p in pools], [p.clone() for p in pools]
    before = (qf.fused_qkv_append.launches,
              qf.fused_qkv_append_int8kv.launches)
    with _one_launch(qf.QKV_REGIME_LAUNCHES,
                     qf.qkv_regime(3, h, nq, d, xdt)):
        qa, *_ = qf.fused_qkv_append(x, nw, wq, ws, sin, cos, a[0], a[1], 1,
                                     pos, n_heads=n, kv_heads=kvn,
                                     tables=tables, cache_ks=a[2],
                                     cache_vs=a[3])
    assert (qf.fused_qkv_append.launches,
            qf.fused_qkv_append_int8kv.launches) == (before[0],
                                                      before[1] + 1)
    qr, *_ = qf.fused_qkv_append_ref(x, nw, wq, ws, sin, cos, r[0], r[1], 1,
                                     pos, n_heads=n, kv_heads=kvn,
                                     tables=tables, cache_ks=r[2],
                                     cache_vs=r[3])
    tol = 1e-5 if xdt == torch.float32 else 2e-2
    assert float((qa.float() - qr.float()).abs().max()) <= tol * float(
        qr.float().std())
    written = torch.zeros(pools[2].shape, dtype=torch.bool, device=cuda)
    for i, p in enumerate(pos.tolist()):
        page = int(tables[i, p // ps])
        written[1, page if page >= 0 else pools[2].shape[1] - 1, :,
                p % ps] = True
    for x_a, x_r in zip(a[:2], r[:2]):
        assert torch.equal(x_a[~written], x_r[~written])
        assert int((x_a[written].int() - x_r[written].int()).abs().max()) <= 1
    for s_a, s_r in zip(a[2:], r[2:]):
        assert torch.equal(s_a[~written], s_r[~written])
        if xdt == torch.float32:
            lim = 1e-5 * s_r[written]
        else:
            lim = _bf16_ulp(s_r[written] * 127.0) / 127.0 * (1 + 1e-6)
        assert bool(((s_a[written] - s_r[written]).abs() <= lim).all())


def test_int8kv_engine_runs_the_kernels_only(cuda):
    # kv_dtype="int8" on both weight paths, with the prefix cache and
    # chunked prefill: every INT8-KV form launches, no plain version runs
    cfg = ModelConfig.tiny_test(num_layers=2)
    refs = (pa.paged_append_decode_quant_ref,
            pa.paged_append_prefill_quant_ref, fp.flash_prefill_ref,
            pd.paged_flash_decode_ref, pp.paged_flash_prefill_ref,
            mm.quantized_matmul_ref, qf.fused_qkv_append_ref,
            ff.fused_ffn_ref)
    calls = [f.cuda_calls for f in refs]
    ecfg = EngineConfig(max_batch_size=4, prefill_chunk=16,
                        kv=KVCacheConfig(page_size=8, num_pages=64,
                                         max_pages_per_seq=8,
                                         kv_dtype="int8"))
    system = list(range(3, 35))
    waves = [[[1, 2, 3]], [system + [40]],
             [system + [41, 42], system + [43] * 9]]
    for params, kerns in (
            (llama.init_params(cfg, seed=0, device=cuda),
             (pa.paged_append_decode_quant, pd.paged_flash_decode_int8kv,
              pa.paged_append_prefill_quant, pp.paged_flash_prefill_int8kv)),
            (_int8_params(cfg, 0, cuda),
             (qf.fused_qkv_append_int8kv, pd.paged_flash_decode_int8kv,
              pa.paged_append_prefill_quant))):
        launches = [f.launches for f in kerns]
        eng = Engine(cfg, params, ecfg, decode_burst=4)
        assert eng.cache.k.dtype == torch.int8
        outs = [eng.generate(w, SamplingParams(max_new_tokens=6))
                for w in waves]
        assert all(len(o) == 6 for w in outs for o in w)
        assert all(f.launches > n for f, n in zip(kerns, launches))
    assert [f.cuda_calls for f in refs] == calls


def test_int8kv_engine_card_matches_cpu(cuda):
    cfg = ModelConfig.tiny_test(num_layers=2)
    p_cpu = llama.init_params(cfg, seed=3, device="cpu")
    ecfg = EngineConfig(max_batch_size=3, prefill_chunk=16,
                        kv=KVCacheConfig(page_size=8, num_pages=64,
                                         max_pages_per_seq=8,
                                         kv_dtype="int8"))
    system = list(range(5, 29))
    prompts = [system + [1, 2, 3], system + [9, 8, 7, 6], list(range(20, 40))]
    s = SamplingParams(max_new_tokens=8)
    for p in (p_cpu, _int8_params(cfg, 3, "cpu")):
        outs = [Engine(cfg, pp_, ecfg, decode_burst=4, device=dev).generate(
            prompts, s) for pp_, dev in ((p, "cpu"), (_to(p, cuda), cuda))]
        assert outs[0] == outs[1]


def _span_inputs(g, dev, dtype, span):
    # row 0 crosses a page boundary, row 1 runs into an unmapped column,
    # row 2 is a dead slot (all -1), row 3 runs past the last column
    pk, pv = _pools(g, dev, dtype, b=4, kvn=4, ps=16, d=64, mp=3)
    tables = torch.tensor([[4, 1, 7], [0, 2, -1], [-1, -1, -1], [3, 5, 6]],
                          dtype=torch.int32, device=dev)
    pos = torch.tensor([14, 29, 0, 44], dtype=torch.int32, device=dev)
    big = torch.randn((4, span, 3 * 4 * 64), generator=g, device=dev,
                      dtype=dtype)
    nk = big[..., :256].reshape(4, span, 4, 64)
    nv = big[..., 512:].reshape(4, span, 4, 64)      # strided views
    return pk, pv, nk, nv, tables, pos


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("span", [1, 5, 8])
def test_paged_append_span(cuda, dtype, span):
    g = torch.Generator(device=cuda).manual_seed(span)
    pk, pv, nk, nv, tables, pos = _span_inputs(g, cuda, dtype, span)
    a, r = (pk.clone(), pv.clone()), (pk.clone(), pv.clone())
    before = pa.paged_append_span.launches
    pa.paged_append_span(*a, nk, nv, tables, pos, 1)
    assert pa.paged_append_span.launches == before + 1
    pa.paged_append_span_ref(*r, nk, nv, tables, pos, 1)
    for x, y in zip(a, r):
        assert torch.equal(x[:, :-1], y[:, :-1])


def _verify_case(g, dev, dtype, s, n, kvn, d, int8, lens=None):
    """Pools, q and tables for kv_lens ``lens`` (default: across a page and
    kv_len 0 at row 4, the second-last slot dead (all -1); the split-edge
    batches' last slot is dead)."""
    mp, dead = (3, -2) if lens is None else (16, -1)
    lens = [s, 128, 129 + s, 200, 0, 57 + s] if lens is None else lens
    b, ps = len(lens), 128
    if int8:
        pools = _quant_pools(g, dev, b=b, kvn=kvn, ps=ps, d=d, mp=mp)
    else:
        pools = _pools(g, dev, dtype, b=b, kvn=kvn, ps=ps, d=d, mp=mp)
    q = torch.randn((b, s, n, d), generator=g, device=dev, dtype=dtype)
    tables = torch.randperm(b * mp, generator=g, device=dev).to(
        torch.int32).reshape(b, mp)
    tables[dead] = -1                # a dead slot: every entry unmapped
    return q, pools, tables, torch.tensor(lens, dtype=torch.int32,
                                          device=dev)


@pytest.mark.parametrize("int8", [False, True], ids=["float-kv", "int8-kv"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 2, 5, 8])
@pytest.mark.parametrize("n,kvn,d", [(32, 32, 128), (32, 8, 128),
                                     (32, 4, 64)])
@pytest.mark.parametrize("edges", [False, True], ids=["lens", "split-edges"])
def test_paged_flash_verify(cuda, int8, dtype, s, n, kvn, d, edges):
    g = torch.Generator(device=cuda).manual_seed(s * 100 + kvn)
    batches = ([None] if not edges else
               _split_edge_lens(kvn, 16 * 128, wins=s, rows=s * n // kvn))
    for lens in batches:
        _check_paged_flash_verify(g, cuda, int8, dtype, s, n, kvn, d, lens)


def _check_paged_flash_verify(g, cuda, int8, dtype, s, n, kvn, d, lens):
    q, pools, tables, kv = _verify_case(g, cuda, dtype, s, n, kvn, d, int8,
                                        lens)
    scales = dict(k_scale=pools[2], v_scale=pools[3]) if int8 else {}
    kern = pd.paged_flash_verify_int8kv if int8 else pd.paged_flash_verify
    others = [f for f in (pd.paged_flash_verify, pd.paged_flash_verify_int8kv,
                          pd.paged_flash_decode,
                          pd.paged_flash_decode_int8kv) if f is not kern]
    before = (kern.launches, [f.launches for f in others])
    got = pd.paged_flash_verify(q, pools[0], pools[1], tables, kv, 1,
                                **scales)
    assert (kern.launches, [f.launches for f in others]) == (
        before[0] + 1, before[1])
    want = pd.paged_flash_verify_ref(q, pools[0], pools[1], tables, kv, 1,
                                     **scales)
    assert got.shape == q.shape and got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) <= ATTN_TOL[dtype]
    assert not got[kv.tolist().index(0)].any()   # kv_len 0 -> zero output


def test_spec_engine_runs_the_kernels_only(cuda):
    # spec_tokens=3 on both weight paths over f32 and INT8 KV, with the
    # prefix cache and chunked prefill: the verify window writes spans and
    # attends with the verify kernels, no single-row decode kernel runs,
    # no plain version runs
    cfg = ModelConfig.tiny_test(num_layers=2)
    refs = (pa.paged_append_span_ref, pa.paged_append_decode_ref,
            pa.paged_append_prefill_ref, pa.paged_append_decode_quant_ref,
            pa.paged_append_prefill_quant_ref, fp.flash_prefill_ref,
            pd.paged_flash_decode_ref, pd.paged_flash_verify_ref,
            pp.paged_flash_prefill_ref, mm.quantized_matmul_ref,
            qf.fused_qkv_append_ref, ff.fused_ffn_ref)
    decode_kernels = (pa.paged_append_decode, pa.paged_append_decode_quant,
                      pd.paged_flash_decode, pd.paged_flash_decode_int8kv,
                      qf.fused_qkv_append, qf.fused_qkv_append_int8kv)
    calls = [f.cuda_calls for f in refs]
    decode = [f.launches for f in decode_kernels]
    system = list(range(3, 35))
    waves = [[[5, 6, 7, 8] * 4], [system + [40]],
             [system + [41, 42], system + [43] * 9]]
    for kv_dtype, verify in (("f32", pd.paged_flash_verify),
                             ("int8", pd.paged_flash_verify_int8kv)):
        for params in (llama.init_params(cfg, seed=0, device=cuda),
                       _int8_params(cfg, 0, cuda)):
            kerns = (verify, ) + ((pa.paged_append_span, )
                                  if kv_dtype == "f32" else ())
            launches = [f.launches for f in kerns]
            eng = Engine(cfg, params, EngineConfig(
                max_batch_size=4, prefill_chunk=16, spec_tokens=3,
                kv=KVCacheConfig(page_size=8, num_pages=64,
                                 max_pages_per_seq=8, kv_dtype=kv_dtype)),
                decode_burst=4)
            outs = [eng.generate(w, SamplingParams(max_new_tokens=6))
                    for w in waves]
            assert all(len(o) == 6 for w in outs for o in w)
            assert all(f.launches > n for f, n in zip(kerns, launches))
            assert eng.metrics.spec_steps > 0
    assert [f.launches for f in decode_kernels] == decode
    assert [f.cuda_calls for f in refs] == calls


def test_spec_engine_card_matches_cpu(cuda):
    cfg = ModelConfig.tiny_test(num_layers=2)
    p_cpu = llama.init_params(cfg, seed=3, device="cpu")
    prompts = [[5, 6, 7, 8] * 5, [9, 1, 2, 3] * 4, list(range(20, 40))]
    s = SamplingParams(max_new_tokens=16)
    for kv_dtype in ("f32", "int8"):
        ecfg = EngineConfig(max_batch_size=3, prefill_chunk=16,
                            spec_tokens=4,
                            kv=KVCacheConfig(page_size=8, num_pages=64,
                                             max_pages_per_seq=8,
                                             kv_dtype=kv_dtype))
        for p in (p_cpu, _int8_params(cfg, 3, "cpu")):
            engs = [Engine(cfg, pp_, ecfg, decode_burst=4, device=dev)
                    for pp_, dev in ((p, "cpu"), (_to(p, cuda), cuda))]
            outs = [e.generate(prompts, s) for e in engs]
            assert outs[0] == outs[1]
            got = [(e.metrics.spec_steps, e.metrics.spec_accepted)
                   for e in engs]
            assert got[0] == got[1] and got[0][1] > 0


# ------------------------------------------------------------ dense path
# Kernel 12 is byte-equal to its plain version over the whole arena (rows
# past Smax dropped); kernel 13 at the attention tolerances; form 6d at the
# fused qkv tolerances; the Generator and the draft Engine equal on both
# devices; quantize_params byte-equal on both devices.

def _arena(g, dev, dtype, rows=5, kvn=4, smax=384, d=64):
    shape = (2, rows, kvn, smax, d)
    return (torch.randn(shape, generator=g, device=dev, dtype=dtype),
            torch.randn(shape, generator=g, device=dev, dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,offs", [(1, [0, 383, 384, 7]),
                                    (8, [3, 376, 380, 500]),
                                    (128, [0, 256, 300, 0])])
def test_kv_append(cuda, dtype, s, offs):
    from simplellminference_tpu_torch.ops import kv_append as ka
    g = torch.Generator(device=cuda).manual_seed(s)
    ck, cv = _arena(g, cuda, dtype)
    big = torch.randn((4, s, 3 * 4 * 64), generator=g, device=cuda,
                      dtype=dtype)
    nk = big[..., 256:512].reshape(4, s, 4, 64)
    nv = big[..., 512:].reshape(4, s, 4, 64)          # strided views
    off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    a, r = (ck.clone(), cv.clone()), (ck.clone(), cv.clone())
    before = ka.kv_append.launches
    ka.kv_append(*a, nk, nv, 1, off)
    assert ka.kv_append.launches == before + 1
    ka.kv_append_ref(*r, nk, nv, 1, off)
    assert torch.equal(a[0], r[0]) and torch.equal(a[1], r[1])
    assert torch.equal(a[0][0], ck[0]) and torch.equal(a[0][:, 4], ck[:, 4])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,kvn,d", [(32, 32, 128), (32, 4, 64), (8, 2, 32)])
@pytest.mark.parametrize("edges", [False, True], ids=["lens", "split-edges"])
def test_flash_decode(cuda, dtype, n, kvn, d, edges):
    g = torch.Generator(device=cuda).manual_seed(n + kvn + d)
    if not edges:
        _check_flash_decode(g, cuda, dtype, n, kvn, d, [1, 0, 161, 256, 300],
                            256)
        return
    for lens in _split_edge_lens(kvn, 2048, rows=n // kvn):
        # kv_len 0 at row 1, past Smax in the last row
        lens[0], lens[1], lens[-1] = lens[1], 0, 2048 + 5
        _check_flash_decode(g, cuda, dtype, n, kvn, d, lens, 2048)


def _check_flash_decode(g, cuda, dtype, n, kvn, d, lens, smax):
    from simplellminference_tpu_torch.ops.attention import flash_decode as fd
    ck, cv = _arena(g, cuda, dtype, rows=len(lens) + 1, kvn=kvn, smax=smax,
                    d=d)
    q = torch.randn((len(lens), n, d), generator=g, device=cuda, dtype=dtype)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = fd.flash_decode.launches
    got = fd.flash_decode(q, ck, cv, kv_lens, layer=1)
    assert fd.flash_decode.launches == before + 1
    want = fd.flash_decode_ref(q, ck, cv, kv_lens, layer=1)
    assert got.shape == q.shape and got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) <= ATTN_TOL[dtype]
    assert not got[1].any()          # kv_len 0 -> zero output
    # the window form (13w) on the same inputs: its own launch count
    before = fd.flash_decode.launches, fd.flash_decode_window.launches
    got = fd.flash_decode(q, ck, cv, kv_lens, layer=1, window=16)
    assert (fd.flash_decode.launches, fd.flash_decode_window.launches) == (
        before[0], before[1] + 1)
    want = fd.flash_decode_ref(q, ck, cv, kv_lens, layer=1, window=16)
    assert float((got.float() - want.float()).abs().max()) <= ATTN_TOL[dtype]
    assert not got[1].any()


@pytest.mark.parametrize("xdt", DTYPES)
@pytest.mark.parametrize("n,kvn,d,b,rows", [(8, 2, 64, 4, 5), (4, 4, 128, 3, 3),
                                            (8, 4, 32, 5, 5)])
def test_fused_qkv_append_dense(cuda, xdt, n, kvn, d, b, rows):
    g = torch.Generator(device=cuda).manual_seed(n * kvn + d)
    h, smax = 256, 128
    nq = (n + 2 * kvn) * d
    wq = torch.randint(-127, 128, (2, h, nq), generator=g, device=cuda,
                       dtype=torch.int8)
    ws = (torch.rand((2, 1, nq), generator=g, device=cuda) + 0.5) * 1e-2
    nw = (1.0 + 0.1 * torch.randn((2, h), generator=g, device=cuda)).to(xdt)
    x = torch.randn((b, h), generator=g, device=cuda).to(xdt)
    pos = torch.tensor([5, 127, 128, 40, 3][:b], dtype=torch.int32,
                       device=cuda)
    sin, cos = ref_ops.rope_tables(pos, d, 10000.0)
    ck, cv = _arena(g, cuda, xdt, rows=rows, kvn=kvn, smax=smax, d=d)
    a, r = (ck.clone(), cv.clone()), (ck.clone(), cv.clone())
    before = qf.fused_qkv_append_dense.launches
    with _one_launch(qf.QKV_REGIME_LAUNCHES,
                     qf.qkv_regime(b, h, nq, d, xdt)):
        qa, *_ = qf.fused_qkv_append(x, nw, wq, ws, sin, cos, *a, 1, pos,
                                     n_heads=n, kv_heads=kvn)
    assert qf.fused_qkv_append_dense.launches == before + 1
    qr, *_ = qf.fused_qkv_append_ref(x, nw, wq, ws, sin, cos, *r, 1, pos,
                                     n_heads=n, kv_heads=kvn)
    tol = 1e-5 if xdt == torch.float32 else 2e-2
    sd = float(qr.float().std())
    assert float((qa.float() - qr.float()).abs().max()) <= tol * sd
    for ta, tr in zip(a, r):
        assert float((ta.float() - tr.float()).abs().max()) <= tol * sd
        assert torch.equal(ta[0], tr[0])              # other layer untouched
    # slot 128 (row 2) is past Smax: dropped, the row keeps its bytes
    assert torch.equal(a[0][1, 2], ck[1, 2])


def test_quantize_params_card_matches_cpu(cuda):
    # the scales divide by a tensor (IEEE) on both devices, so the codes
    # and scales quantized on the card are the CPU's byte for byte
    g = torch.Generator().manual_seed(0)
    w = torch.randn((2, 512, 384), generator=g) * 0.05
    w[0, :, :7] *= 1e-3                 # small columns: small scales
    params = {"embed": torch.zeros(4, 512), "final_norm": torch.ones(512),
              "layers": {"wqkv": w}, "lm_head": w[0].clone()}
    for gs in (0, 128):
        qc = QuantConfig(mode="int8", group_size=gs, quantize_lm_head=True)
        cpu = quantize_params(params, qc)
        gpu = quantize_params(_to(params, cuda), qc)
        for a, b in ((cpu["layers"]["wqkv"], gpu["layers"]["wqkv"]),
                     (cpu["lm_head"], gpu["lm_head"])):
            assert torch.equal(a.q, b.q.cpu())
            assert torch.equal(a.scales, b.scales.cpu())


def test_generator_runs_the_kernels_only_and_matches_cpu(cuda):
    from simplellminference_tpu_torch.ops import kv_append as ka
    from simplellminference_tpu_torch.ops.attention import flash_decode as fd
    from simplellminference_tpu_torch.runtime.generator import Generator
    cfg = ModelConfig.tiny_test(num_layers=2)
    prompts = [[5, 9, 2, 44, 17], [33, 4, 250, 1, 2, 3, 4, 5, 6], [7]]
    refs = (ka.kv_append_ref, fd.flash_decode_ref, fp.flash_prefill_ref,
            qf.fused_qkv_append_ref)
    calls = [f.cuda_calls for f in refs]
    for p_cpu in (llama.init_params(cfg, seed=3, device="cpu"),
                  _int8_params(cfg, 3, "cpu")):
        kerns = (fd.flash_decode, fp.flash_prefill, ka.kv_append
                 if isinstance(p_cpu["layers"]["wqkv"], torch.Tensor)
                 else qf.fused_qkv_append_dense)
        launches = [f.launches for f in kerns]
        outs = []
        for p, dev in ((p_cpu, "cpu"), (_to(p_cpu, cuda), cuda)):
            gen = Generator(cfg, p, max_batch=3, max_seq=128, device=dev)
            res = gen.generate(prompts, SamplingParams(max_new_tokens=12))
            fused = gen.generate_fused(prompts, 12)
            assert fused.tolist() == res.token_ids
            outs.append(res.token_ids)
        assert outs[0] == outs[1]
        assert all(f.launches > n for f, n in zip(kerns, launches))
    assert [f.cuda_calls for f in refs] == calls


def test_draft_engine_card_matches_cpu(cuda):
    cfg = ModelConfig.tiny_test(num_layers=2)
    dcfg = ModelConfig.tiny_test(num_layers=1, hidden_size=64,
                                 intermediate_size=128, num_heads=2,
                                 num_kv_heads=1)
    p_cpu = llama.init_params(cfg, seed=3, device="cpu")
    d_cpu = llama.init_params(dcfg, seed=42, device="cpu")
    prompts = [[5, 6, 7, 8] * 5, [9, 1, 2, 3], list(range(20, 40))]
    s = SamplingParams(max_new_tokens=16)
    ecfg = EngineConfig(max_batch_size=3, spec_tokens=3,
                        kv=KVCacheConfig(page_size=8, num_pages=64,
                                         max_pages_per_seq=8,
                                         kv_dtype="f32"))
    outs, metrics = [], []
    for dev, to in (("cpu", lambda t: t), (cuda, lambda t: _to(t, cuda))):
        for draft in ((dcfg, to(d_cpu)), (cfg, to(p_cpu))):
            eng = Engine(cfg, to(p_cpu), ecfg, decode_burst=3, device=dev,
                         draft=draft)
            outs.append(eng.generate(prompts, s))
            metrics.append((eng.metrics.spec_steps,
                            eng.metrics.spec_accepted))
    assert outs[0] == outs[1] == outs[2] == outs[3]
    assert metrics[0] == metrics[2] and metrics[1] == metrics[3]
    assert metrics[1][1] >= 2 * metrics[1][0]      # a self-draft accepts


def _int4w(g, dev, shape, groups, zs):
    """Random split-half packed bytes (every nibble, -8 included) for a
    logical [.., K, N] weight, f32 scales and, with ``zs``, zero points
    (z - 8) * s for z in [0, 16)."""
    *lead, k, n = shape
    q = torch.randint(-128, 128, (*lead, k // 2, n), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand((*lead, groups, n), generator=g, device=dev) * 1e-2 + 5e-3
    z = None
    if zs:
        z = (torch.randint(0, 16, s.shape, generator=g, device=dev) - 8) * s
    return q, s, z


def _close(got, want, odt):
    diff = (got.float() - want.float()).abs()
    slack = 1e-5 * float(want.float().abs().max())
    if odt == torch.float32:
        return float(diff.max()) <= slack
    ulp = _bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
    return bool((diff <= ulp + slack).all())


@pytest.mark.parametrize("m,k,n,groups,xdt,odt,zs", [
    (8, 4096, 4096, 1, torch.bfloat16, torch.bfloat16, False),  # bench.py
    (1, 4096, 3000, 32, torch.float32, torch.float32, True),    # AWQ form
    (5, 200, 40, 1, torch.float32, torch.float32, True),        # K/2 = 100
    (8, 4096, 512, 32, torch.bfloat16, torch.float32, False),   # grouped
    (100, 512, 384, 4, torch.bfloat16, torch.float32, False),   # tiled
    (70, 300, 136, 10, torch.float32, torch.bfloat16, True),    # ragged
    (1024, 256, 264, 1, torch.bfloat16, torch.bfloat16, False),
])
def test_quantized_matmul_int4(cuda, m, k, n, groups, xdt, odt, zs):
    g = torch.Generator(device=cuda).manual_seed(m + k + zs)
    q, s, z = _int4w(g, cuda, (2, k, n), groups, zs)
    x = torch.randn((m, k), generator=g, device=cuda).to(xdt)
    kern = mm.quantized_matmul_int4_zs if zs else mm.quantized_matmul_int4
    before = kern.launches
    got = mm.quantized_matmul(x, q, s, out_dtype=odt, layer=1, bits=4, zs=z)
    assert kern.launches == before + 1
    want = mm.quantized_matmul_int4_ref(x, q, s, out_dtype=odt, layer=1,
                                        zs=z)
    assert got.dtype == odt and got.shape == (m, n)
    assert _close(got, want, odt)


# The tensor-core regimes of the INT4 product: mma.sync (M <= 8) and wgmma
# (M > 8) with bf16 activations, per channel, in groups of 128 (and 192)
# and with zero points; bf16 and f32 outputs; ragged M; K/2 split across
# blocks with the split on a group edge (5 x 4096 x 4096: 256-row ranges,
# 65 x 1024 x 384) and off one (8 x 11008: 448-row ranges, 24 x 2688:
# 320-row ranges over groups of 192); each launch counted in its regime.
@pytest.mark.parametrize("m,k,n,groups,zs,odt", [
    (1, 4096, 12288, 1, False, torch.bfloat16),     # wqkv, one request
    (5, 4096, 4096, 32, False, torch.float32),      # group 128, split edges
    (8, 4096, 22016, 1, False, torch.bfloat16),     # gate_up
    (8, 11008, 4096, 86, True, torch.bfloat16),     # AWQ down, mid-group
    (8, 4096, 32000, 1, True, torch.float32),       # per-channel zs, head
    (8, 512, 256, 4, True, torch.bfloat16),         # one range, no split
    (9, 4096, 4096, 1, False, torch.bfloat16),      # 64-row tiles, split
    (65, 4096, 4096, 1, False, torch.float32),      # 128-row tiles, split
    (65, 1024, 384, 8, True, torch.bfloat16),       # grouped split at edge
    (24, 2688, 256, 14, True, torch.float32),       # groups of 192, mid
    (300, 4096, 4096, 32, True, torch.float32),     # ragged AWQ
    (300, 11008, 4096, 86, False, torch.bfloat16),  # grouped, no zs
    (1024, 4096, 12288, 1, False, torch.bfloat16),  # prefill wqkv
    (1024, 4096, 12288, 32, True, torch.bfloat16),  # AWQ prefill wqkv
])
def test_quantized_matmul_int4_tensor_core_regimes(cuda, m, k, n, groups, zs,
                                                   odt):
    g = torch.Generator(device=cuda).manual_seed(m + k + n + zs)
    q, s, z = _int4w(g, cuda, (2, k, n), groups, zs)
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    regime = mm.int4_regime(m, k // 2, n, k // groups, torch.bfloat16)
    assert regime == ("mma" if m <= 8 else "wgmma")
    kern = mm.quantized_matmul_int4_zs if zs else mm.quantized_matmul_int4
    before = (kern.launches, dict(mm.INT4_REGIME_LAUNCHES))
    got = mm.quantized_matmul(x, q, s, out_dtype=odt, layer=1, bits=4, zs=z)
    assert kern.launches == before[0] + 1
    assert mm.INT4_REGIME_LAUNCHES == {r: c + (r == regime)
                                       for r, c in before[1].items()}
    want = mm.quantized_matmul_int4_ref(x, q, s, out_dtype=odt, layer=1,
                                        zs=z)
    assert got.dtype == odt and got.shape == (m, n)
    assert bool(torch.isfinite(got).all())
    assert _close(got, want, odt)


@pytest.mark.parametrize("m,k,n,groups,xdt,odt", [
    (128, 4096, 4096, 1, torch.bfloat16, torch.bfloat16),       # wo prefill
    (300, 512, 384, 4, torch.bfloat16, torch.float32),          # group 128
    (129, 200, 40, 1, torch.float32, torch.float32),            # K % 16
    (256, 1000, 136, 125, torch.float32, torch.float32),        # groups of 8
    (130, 256, 70, 2, torch.float32, torch.bfloat16),           # N % 4
    # the int8 tensor cores at M 128, 300 and 1024, per channel and group
    # 128, K split (wo, down at M 128) and not; group 64: the dp4a kernel
    (128, 4096, 12288, 1, torch.bfloat16, torch.bfloat16),      # wqkv
    (128, 11008, 4096, 86, torch.bfloat16, torch.float32),      # down g128
    (300, 4096, 4096, 1, torch.float32, torch.bfloat16),        # ragged M
    (300, 4096, 4096, 32, torch.bfloat16, torch.bfloat16),      # group 128
    (1024, 4096, 4096, 1, torch.bfloat16, torch.float32),       # wo
    (1024, 11008, 4096, 86, torch.bfloat16, torch.bfloat16),    # down g128
    (1024, 4096, 4096, 64, torch.bfloat16, torch.bfloat16),     # group 64
    (64, 4096, 4096, 1, torch.bfloat16, torch.bfloat16),        # 64-row tiles
])
def test_quantized_matmul_w8a8(cuda, m, k, n, groups, xdt, odt):
    g = torch.Generator(device=cuda).manual_seed(m + k)
    q, s = _qw(g, cuda, (2, k, n), groups)
    x = torch.randn((m, k), generator=g, device=cuda).to(xdt)
    x[3] = 0.0                                  # the 1e-10 row-scale floor
    regime = mm.w8a8_regime(m, k, n, k // groups)
    before = (mm.quantized_matmul_w8a8.launches,
              dict(mm.W8A8_REGIME_LAUNCHES))
    got = mm.quantized_matmul_w8a8(x, q, s, out_dtype=odt, layer=1)
    assert mm.quantized_matmul_w8a8.launches == before[0] + 1
    assert mm.W8A8_REGIME_LAUNCHES == {r: c + (r == regime)
                                       for r, c in before[1].items()}
    want = mm.quantized_matmul_w8a8_ref(x, q, s, out_dtype=odt, layer=1)
    assert got.dtype == odt and got.shape == (m, n)
    assert not got[3].any()
    assert _close(got, want, odt)
    if regime == "wgmma" and groups == 1:
        # exact integer sums, the plain version's two f32 products
        assert torch.equal(got, want)


def test_int4_and_activation_quantizers_card_match_cpu(cuda):
    g = torch.Generator().manual_seed(1)
    w = torch.randn((2, 512, 384), generator=g) * 0.05
    w[0, :, :7] *= 1e-3
    for gs in (512, 128):
        qc, sc = ref_ops.quantize_int4_groupwise(w, gs)
        qg, sg = ref_ops.quantize_int4_groupwise(w.to(cuda), gs)
        assert torch.equal(qc, qg.cpu()) and torch.equal(sc, sg.cpu())
    x = torch.randn((300, 4096), generator=g) * torch.rand((300, 1),
                                                           generator=g)
    x[5] = 0.0
    for dt in DTYPES:
        ic, sc = mm.quantize_activations_int8(x.to(dt))
        ig, sg = mm.quantize_activations_int8(x.to(dt).to(cuda))
        assert torch.equal(ic, ig.cpu()) and torch.equal(sc, sg.cpu())


def test_int4_and_w8a8_engines_run_the_kernels_only_and_match_cpu(cuda):
    import dataclasses
    cfg = ModelConfig.tiny_test(num_layers=2)
    p = llama.init_params(cfg, seed=3, device="cpu")
    int4 = quantize_params(p, QuantConfig(mode="int4", group_size=32,
                                          quantize_lm_head=True))
    g = torch.Generator().manual_seed(4)
    awq = {**int4, "layers": {
        k: (QuantizedWeight(q=w.q, scales=w.scales, bits=4,
                            zs=(torch.randint(0, 16, w.scales.shape,
                                              generator=g) - 8) * w.scales
                            * 0.1)
            if isinstance(w, QuantizedWeight) else w)
        for k, w in int4["layers"].items()}}
    int8 = quantize_params(p, QuantConfig(mode="int8", group_size=32,
                                          quantize_lm_head=True))
    prompts = [list(range(1, 60)), [5, 6, 7] * 15, list(range(100, 140)),
               [9] * 33]
    ecfg = EngineConfig(max_batch_size=4, prefix_cache_entries=0,
                        kv=KVCacheConfig(page_size=8, num_pages=64,
                                         max_pages_per_seq=10,
                                         kv_dtype="f32"))
    refs = (mm.quantized_matmul_int4_ref, mm.quantized_matmul_w8a8_ref,
            mm.quantized_matmul_ref)
    calls = [f.cuda_calls for f in refs]
    for params, act, kern in ((int4, None, mm.quantized_matmul_int4),
                              (awq, None, mm.quantized_matmul_int4_zs),
                              (int8, "int8", mm.quantized_matmul_w8a8)):
        c = dataclasses.replace(cfg, act_quant=act)
        before = kern.launches
        outs = [Engine(c, pp, ecfg, decode_burst=4, device=dev).generate(
            prompts, SamplingParams(max_new_tokens=10))
            for pp, dev in ((params, "cpu"), (_to(params, cuda), cuda))]
        # W8A8 only at the 4 x 64-row prefill: 4 products a layer
        want = 4 * cfg.num_layers if act else None
        assert kern.launches > before and (
            want is None or kern.launches == before + want)
        if act is None:
            assert outs[0] == outs[1]           # f32 weights: same greedy
        else:                                   # codes may part by a step
            assert all(len(o) == 10 for o in outs[1])
    assert [f.cuda_calls for f in refs] == calls


# ------------------------------------------------------- sliding windows
# The window forms 3w, 4w/4qw/4vw/4vqw and 8w/8qw at the attention
# tolerances against their plain versions, at windows off a page multiple
# and kv_lens on both sides of them; over ring tables whose columns below
# the oldest row's band point at NaN pages, which neither version reads
# (the outputs stay finite and equal the clean run's); 6k at the fused qkv
# tolerances with kv_layer != layer; the grouped engine on the kernels
# only and equal to the CPU.

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [1, 6, 200])
def test_flash_prefill_window(cuda, dtype, window):
    g = torch.Generator(device=cuda).manual_seed(window)
    s, n, kvn, d = 300, 8, 2, 128
    q = torch.randn((2, s, n, d), generator=g, device=cuda, dtype=dtype)
    k = torch.randn((2, s, kvn, d), generator=g, device=cuda, dtype=dtype)
    v = torch.randn((2, s, kvn, d), generator=g, device=cuda, dtype=dtype)
    before = (fp.flash_prefill_window.launches, fp.flash_prefill.launches)
    got = fp.flash_prefill(q, k, v, window=window)
    assert (fp.flash_prefill_window.launches,
            fp.flash_prefill.launches) == (before[0] + 1, before[1])
    want = fp.flash_prefill_ref(q, k, v, window=window)
    assert _attn_ok(got, want)


def _ring_case(g, dev, dtype, int8, b, r, mp, kvn, d, ps):
    """Ring pools (b slots x r pages, 4 NaN poison pages, the trash page)
    and the ring tables (column j of slot s -> s*r + j % r)."""
    shape = (2, b * r + 5, kvn, ps, d)
    if int8:
        pk, sk = pa.quantize_kv(torch.randn(shape, generator=g, device=dev))
        pv, sv = pa.quantize_kv(torch.randn(shape, generator=g, device=dev))
        sk[:, b * r:b * r + 4] = float("nan")
        sv[:, b * r:b * r + 4] = float("nan")
        pools = [pk, pv, sk, sv]
    else:
        pk = torch.randn(shape, generator=g, device=dev, dtype=dtype)
        pv = torch.randn(shape, generator=g, device=dev, dtype=dtype)
        pk[:, b * r:b * r + 4] = float("nan")
        pv[:, b * r:b * r + 4] = float("nan")
        pools = [pk, pv]
    ring = (torch.arange(b, device=dev)[:, None] * r
            + torch.arange(mp, device=dev)[None] % r).to(torch.int32)
    return pools, ring


def _poisoned(ring, k_lo, ps, first):
    """The ring tables with every column that ends at or below k_lo[b]
    pointing at a NaN page."""
    tb = ring.clone()
    ends = (torch.arange(ring.shape[1], device=ring.device) + 1) * ps
    below = ends[None, :] <= k_lo[:, None]
    tb[below] = first + (torch.arange(ring.shape[1], device=ring.device)
                         [None].expand_as(ring)[below] % 4).to(torch.int32)
    return tb


@pytest.mark.parametrize("int8", [False, True], ids=["float-kv", "int8-kv"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("window", [200, 700])   # bands over 4 and 9 splits
def test_paged_flash_decode_window_reads_only_the_band(cuda, int8, dtype, s,
                                                       window):
    g = torch.Generator(device=cuda).manual_seed(s + 10 * int8)
    b, r, mp, kvn, n, d, ps = 4, 4 if window == 200 else 8, 8, 8, 32, 128, 128
    pools, ring = _ring_case(g, cuda, dtype, int8, b, r, mp, kvn, d, ps)
    kv = torch.tensor([150, 201, 640, 1000], dtype=torch.int32, device=cuda)
    q = torch.randn((b, s, n, d), generator=g, device=cuda, dtype=dtype)
    scales = dict(k_scale=pools[2], v_scale=pools[3]) if int8 else {}
    if s == 1:
        fn, ref = pd.paged_flash_decode, pd.paged_flash_decode_ref
        kern = (pd.paged_flash_decode_int8kv_window if int8
                else pd.paged_flash_decode_window)
        q = q[:, 0]
    else:
        fn, ref = pd.paged_flash_verify, pd.paged_flash_verify_ref
        kern = (pd.paged_flash_verify_int8kv_window if int8
                else pd.paged_flash_verify_window)
    dirty = _poisoned(ring, kv.long() - s - window + 1, ps, b * r)
    before = kern.launches
    got = fn(q, pools[0], pools[1], dirty, kv, 1, window=window, **scales)
    assert kern.launches == before + 1
    clean = fn(q, pools[0], pools[1], ring, kv, 1, window=window, **scales)
    want = ref(q, pools[0], pools[1], ring, kv, 1, window=window, **scales)
    assert bool(torch.isfinite(got).all()) and torch.equal(got, clean)
    assert float((got.float() - want.float()).abs().max()) <= ATTN_TOL[dtype]


@pytest.mark.parametrize("int8", [False, True], ids=["float-kv", "int8-kv"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_flash_prefill_window_reads_only_the_band(cuda, int8, dtype):
    g = torch.Generator(device=cuda).manual_seed(7 + int8)
    b, r, mp, kvn, n, d, ps, window = 2, 5, 8, 8, 32, 128, 128, 200
    pools, ring = _ring_case(g, cuda, dtype, int8, b, r, mp, kvn, d, ps)
    offs = torch.tensor([256, 512], dtype=torch.int32, device=cuda)
    kv = offs + torch.tensor([256, 100], dtype=torch.int32, device=cuda)
    q = torch.randn((b, 256, n, d), generator=g, device=cuda, dtype=dtype)
    scales = dict(k_scale=pools[2], v_scale=pools[3]) if int8 else {}
    kern = (pp.paged_flash_prefill_int8kv_window if int8
            else pp.paged_flash_prefill_window)
    dirty = _poisoned(ring, offs.long() - window + 1, ps, b * r)
    before = kern.launches
    got = pp.paged_flash_prefill(q, pools[0], pools[1], dirty, kv, offs, 1,
                                 window=window, **scales)
    assert kern.launches == before + 1
    clean = pp.paged_flash_prefill(q, pools[0], pools[1], ring, kv, offs, 1,
                                   window=window, **scales)
    want = pp.paged_flash_prefill_ref(q, pools[0], pools[1], ring, kv, offs,
                                      1, window=window, **scales)
    assert bool(torch.isfinite(got).all()) and torch.equal(got, clean)
    for i in range(b):
        live = int(kv[i] - offs[i])
        assert _attn_ok(got[i, :live], want[i, :live])


@pytest.mark.parametrize("dead", [False, True], ids=["mapped", "dead-row"])
@pytest.mark.parametrize("xdt", DTYPES)
def test_fused_qkv_append_kv_layer(cuda, xdt, dead):
    g = torch.Generator(device=cuda).manual_seed(61)
    n, kvn, d, h, ps, L = 32, 8, 128, 512, 16, 2
    nq = (n + 2 * kvn) * d
    wq, ws = _qw(g, cuda, (L, h, nq), 1)
    nw = torch.rand((L, h), generator=g, device=cuda).to(xdt) + 0.5
    x = torch.randn((3, h), generator=g, device=cuda).to(xdt)
    pos = torch.tensor([5, 20, 40], dtype=torch.int32, device=cuda)
    tables = torch.tensor([[3, 7, 1], [0, 5, 8], [2, 4, 6]],
                          dtype=torch.int32, device=cuda)
    if dead:
        tables[1] = -1                # its write goes to the trash page
    sin, cos = ref_ops.rope_tables(pos, d, 10000.0)
    pk, pv = _pools(g, cuda, xdt, b=3, kvn=kvn, ps=ps, d=d, mp=3)
    a, r = (pk.clone(), pv.clone()), (pk.clone(), pv.clone())
    before = (qf.fused_qkv_append_kv_layer.launches,
              qf.fused_qkv_append.launches)
    with _one_launch(qf.QKV_REGIME_LAUNCHES,
                     qf.qkv_regime(3, h, nq, d, xdt)):
        qa, *_ = qf.fused_qkv_append(x, nw, wq, ws, sin, cos, *a, 1, pos,
                                     tables=tables, kv_layer=0)
    assert (qf.fused_qkv_append_kv_layer.launches,
            qf.fused_qkv_append.launches) == (before[0] + 1, before[1])
    qr, *_ = qf.fused_qkv_append_ref(x, nw, wq, ws, sin, cos, *r, 1, pos,
                                     tables=tables, kv_layer=0)
    tol = 1e-5 if xdt == torch.float32 else 2e-2
    assert float((qa.float() - qr.float()).abs().max()) <= tol * float(
        qr.float().std())
    for x_a, x_r, x_0 in zip(a, r, (pk, pv)):
        assert torch.equal(x_a[1], x_0[1])          # weight layer untouched
        w_r = x_r[0].float()
        assert float((x_a[0].float() - w_r).abs().max()) <= tol * float(
            w_r.std())


def test_grouped_engine_runs_the_kernels_only_and_matches_cpu(cuda):
    # all-sliding and alternating stacks, float and INT8 weights, f32 and
    # INT8 KV, chunked prefill and a verify span: the window forms and 6k
    # run on the card, no plain version runs, tokens equal the CPU's
    refs = (fp.flash_prefill_ref, pd.paged_flash_decode_ref,
            pd.paged_flash_verify_ref, pp.paged_flash_prefill_ref,
            qf.fused_qkv_append_ref, ff.fused_ffn_ref,
            mm.quantized_matmul_ref)
    calls = [f.cuda_calls for f in refs]
    kerns = (fp.flash_prefill_window, pd.paged_flash_decode_window,
             pp.paged_flash_prefill_window, qf.fused_qkv_append_kv_layer,
             pd.paged_flash_verify_window)
    before = [f.launches for f in kerns]
    prompts = [list(range(1, 40)), [7, 3, 9] * 3, list(range(50, 61))]
    for types in (None, ("sliding_attention", "full_attention")):
        cfg = ModelConfig.tiny_test(num_layers=2, sliding_window=13,
                                    layer_types=types)
        for spec, kv_dtype in ((0, "f32"), (3, "f32"), (0, "int8")):
            ecfg = EngineConfig(max_batch_size=3, prefill_chunk=16,
                                spec_tokens=spec,
                                kv=KVCacheConfig(page_size=8, num_pages=64,
                                                 max_pages_per_seq=10,
                                                 kv_dtype=kv_dtype))
            for p in (llama.init_params(cfg, seed=5, device="cpu"),
                      _int8_params(cfg, 5, "cpu")):
                outs = [Engine(cfg, pp_, ecfg, decode_burst=4,
                               device=dev).generate(
                    prompts, SamplingParams(max_new_tokens=12))
                    for pp_, dev in ((p, "cpu"), (_to(p, cuda), cuda))]
                assert outs[0] == outs[1]
    assert all(f.launches > n for f, n in zip(kerns, before))
    assert [f.cuda_calls for f in refs] == calls


# ---------------------------------------------------- kernels 16 and 17

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [3, 8, 40])
def test_fused_wo_ffn(cuda, dtype, m):
    g = torch.Generator(device=cuda).manual_seed(m + 1)
    L, h, nd, inter = 2, 512, 640, 1408
    wq, ws = _qw(g, cuda, (L, nd, h), 1)
    q1, s1 = _qw(g, cuda, (L, h, 2 * inter), 1)
    q2, s2 = _qw(g, cuda, (L, inter, h), 1)
    nw = torch.rand((L, h), generator=g, device=cuda).to(dtype) + 0.5
    attn = torch.randn((m, nd), generator=g, device=cuda).to(dtype)
    x = torch.randn((m, h), generator=g, device=cuda).to(dtype)
    before = ff.fused_wo_ffn.launches
    got = ff.fused_wo_ffn(attn, x, wq, ws, nw, q1, s1, q2, s2, 1)
    assert ff.fused_wo_ffn.launches == before + 1
    want = ff.fused_wo_ffn_ref(attn, x, wq, ws, nw, q1, s1, q2, s2, 1)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    sd = float(want.float().std())
    assert float((got.float() - want.float()).abs().max()) <= tol * sd
    # a grid past what the card holds at once would deadlock: refused
    most = ff.wo_ffn_max_grid(dtype)
    assert most > 0
    with pytest.raises(RuntimeError, match="cooperative grid"):
        ff._fused_wo_ffn_launch(attn, x, wq, ws, nw, q1, s1, q2, s2, 1,
                                1e-5, most + 1)
    small = ff._fused_wo_ffn_launch(attn, x, wq, ws, nw, q1, s1, q2, s2, 1,
                                    1e-5, 3)
    assert float((small.float() - want.float()).abs().max()) <= tol * sd


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bk", [128, 256])
@pytest.mark.parametrize("n,kvn", [(32, 32), (32, 8)])
def test_flash_decode_dyn(cuda, dtype, bk, n, kvn):
    from simplellminference_tpu_torch.ops.attention import flash_decode_dyn

    g = torch.Generator(device=cuda).manual_seed(bk + kvn)
    shape = (2, 6, kvn, 512, 128)
    ck = torch.randn(shape, generator=g, device=cuda, dtype=dtype)
    cv = torch.randn(shape, generator=g, device=cuda, dtype=dtype)
    q = torch.randn((5, n, 128), generator=g, device=cuda, dtype=dtype)
    kv = torch.tensor([0, 1, 33, 300, 512], dtype=torch.int32, device=cuda)
    kern = flash_decode_dyn.flash_decode_dyn
    before = kern.launches
    got = kern(q, ck, cv, kv, bk=bk, layer=1)
    assert kern.launches == before + 1
    want = flash_decode_dyn.flash_decode_dyn_ref(q, ck, cv, kv, layer=1)
    assert float((got.float() - want.float()).abs().max()) <= ATTN_TOL[dtype]
    assert not got[0].any()          # kv_len 0 -> zero output
    other = kern(q, ck, cv, kv, bk=384 - bk, layer=1)
    assert torch.equal(got, other)   # bk does not change the result


# ----------------------------------------------- FP8 (e4m3) KV: 1e-8e

E4 = torch.float8_e4m3fn


def _e4m3_pools(g, dev, b=3, kvn=4, ps=128, d=64, mp=2):
    """e4m3 pools as the Engine fills them: N(0, 1) rows (as _pools draws)
    cast by the plain to_e4m3."""
    shape = (2, b * mp + 1, kvn, ps, d)
    return tuple(ref_ops.to_e4m3(torch.randn(shape, generator=g, device=dev))
                 for _ in range(2))


def _bytes_equal(a, b):
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _ordinal(x):
    """e4m3 codes in value order: +-0 both 0, one step per code."""
    u = x.view(torch.uint8).int()
    return torch.where(u >= 128, -(u & 0x7F), u & 0x7F)


def test_e4m3_conversion_every_bf16_pattern_and_f32_edges(cuda):
    # every bf16 bit pattern through form 2e (bf16 rows), f32 edges through
    # form 1e (f32 rows), each byte-equal to to_e4m3 computed on the CPU
    pat = torch.arange(-32768, 32768, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    want = ref_ops.to_e4m3(pat).view(torch.uint8)
    rows = pat.reshape(1, 512, 1, 128).to(cuda)
    pk = torch.zeros((1, 5, 1, 128, 128), dtype=E4, device=cuda)
    pv = torch.zeros_like(pk)
    tables = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32, device=cuda)
    pa.paged_append_prefill_fp8kv(pk, pv, rows, rows, tables, 0)
    got = pk[0, :4, 0].reshape(-1).view(torch.uint8).cpu()
    assert torch.equal(got, want)
    edges = torch.tensor([448, 464, 464.00003, 480, 500, 1e4, float("inf"),
                          float("nan"), 0.0, 2.0 ** -9, 2.0 ** -10,
                          3 * 2.0 ** -10, 2.0 ** -6 * 0.99, 1e-40, 240, 232],
                         dtype=torch.float32)
    edges = torch.cat([edges, -edges])
    for d, rows in ((32, edges.reshape(1, 1, 32)),          # 8 a thread
                    (8, edges.reshape(4, 1, 8))):           # vec8 off
        pk = torch.zeros((1, 5, 1, 8, d), dtype=E4, device=cuda)
        pv = torch.zeros_like(pk)
        b = rows.shape[0]
        tbl = torch.arange(b, dtype=torch.int32, device=cuda)[:, None]
        pa.paged_append_decode_fp8kv(pk, pv, rows.to(cuda), rows.to(cuda),
                                     tbl, torch.zeros(b, dtype=torch.int32,
                                                      device=cuda), 0)
        got = pk[0, :b, 0, 0].reshape(-1).view(torch.uint8).cpu()
        assert torch.equal(got, ref_ops.to_e4m3(edges).view(torch.uint8))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [128, 100, 1])
def test_paged_append_prefill_fp8kv(cuda, dtype, s):
    g = torch.Generator(device=cuda).manual_seed(s)
    pools = _e4m3_pools(g, cuda)
    big = torch.randn((3, s, 3 * 4 * 64), generator=g, device=cuda,
                      dtype=dtype) * 200                 # some past 464
    nk = big[..., :256].reshape(3, s, 4, 64)
    nv = big[..., 512:].reshape(3, s, 4, 64)      # strided views
    a, r = [p.clone() for p in pools], [p.clone() for p in pools]
    before = (pa.paged_append_prefill.launches,
              pa.paged_append_prefill_fp8kv.launches)
    pa.paged_append_prefill(*a, nk, nv, _tables(cuda), 1)
    assert (pa.paged_append_prefill.launches,
            pa.paged_append_prefill_fp8kv.launches) == (before[0],
                                                         before[1] + 1)
    pa.paged_append_prefill_ref(*r, nk, nv, _tables(cuda), 1)
    for x, y in zip(a, r):
        assert _bytes_equal(x[:, :-1], y[:, :-1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("span", [0, 1, 5, 8])
def test_paged_append_decode_and_span_fp8kv(cuda, dtype, span):
    g = torch.Generator(device=cuda).manual_seed(span)
    _pk, _pv, nk, nv, tables, pos = _span_inputs(g, cuda, dtype,
                                                 max(span, 1))
    pools = _e4m3_pools(g, cuda, b=4, kvn=4, ps=16, d=64, mp=3)
    nk, nv = nk * 200, nv * 200
    a, r = [p.clone() for p in pools], [p.clone() for p in pools]
    if span == 0:              # one row per sequence: form 1e
        kern, ref = pa.paged_append_decode_fp8kv, pa.paged_append_decode_ref
        nk, nv = nk[:, 0], nv[:, 0]
    else:
        kern, ref = pa.paged_append_span_fp8kv, pa.paged_append_span_ref
    before = kern.launches
    kern(*a, nk, nv, tables, pos, 1)
    assert kern.launches == before + 1
    ref(*r, nk, nv, tables, pos, 1)
    for x, y in zip(a, r):
        assert _bytes_equal(x[:, :-1], y[:, :-1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("n,kvn,d", [(32, 32, 128), (32, 4, 64)])
def test_paged_flash_decode_and_verify_fp8kv(cuda, dtype, s, n, kvn, d):
    g = torch.Generator(device=cuda).manual_seed(n + kvn + s)
    lens = [s, 128, 129, 200, 0, 57]
    b, ps, mp = len(lens), 128, 2
    pk, pv = _e4m3_pools(g, cuda, b=b, kvn=kvn, ps=ps, d=d, mp=mp)
    q = torch.randn((b, s, n, d), generator=g, device=cuda, dtype=dtype)
    tables = torch.randperm(b * mp, generator=g, device=cuda).to(
        torch.int32).reshape(b, mp)
    tables[-1] = -1
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    if s == 1:
        form, ref = pd.paged_flash_decode_fp8kv, pd.paged_flash_decode_ref
        q = q[:, 0]
        call = pd.paged_flash_decode
    else:
        form, ref = pd.paged_flash_verify_fp8kv, pd.paged_flash_verify_ref
        call = pd.paged_flash_verify
    before = (call.launches, form.launches)
    got = call(q, pk, pv, tables, kv, 1)
    assert (call.launches, form.launches) == (before[0], before[1] + 1)
    want = ref(q, pk, pv, tables, kv, 1)
    assert got.dtype == dtype
    assert _close(got, want, dtype)
    assert not got[4].any()
    # with a window (4ew, 4vew; the tests below hold them over ring pools)
    wform = (pd.paged_flash_decode_fp8kv_window if s == 1
             else pd.paged_flash_verify_fp8kv_window)
    before = wform.launches
    got = call(q, pk, pv, tables, kv, 1, window=16)
    assert wform.launches == before + 1
    assert _close(got, ref(q, pk, pv, tables, kv, 1, window=16), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,n,kvn,d,ps", [(64, 32, 32, 128, 128),
                                          (100, 32, 4, 64, 16),
                                          (256, 32, 8, 128, 128)])
def test_paged_flash_prefill_fp8kv(cuda, dtype, s, n, kvn, d, ps):
    g = torch.Generator(device=cuda).manual_seed(s + n)
    b, mp = 4, 768 // ps
    pk, pv = _e4m3_pools(g, cuda, b=b, kvn=kvn, ps=ps, d=d, mp=mp)
    q = torch.randn((b, s, n, d), generator=g, device=cuda, dtype=dtype)
    tables = torch.randperm(b * mp, generator=g, device=cuda).to(
        torch.int32).reshape(b, mp)
    offs = torch.tensor([0, 2 * ps, ps, 0], dtype=torch.int32, device=cuda)
    kv = offs + torch.tensor([s, max(s - 7, 1), s, 1], dtype=torch.int32,
                             device=cuda)
    tables[2, 0] = -1
    tables[3] = -1
    before = pp.paged_flash_prefill_fp8kv.launches
    got = pp.paged_flash_prefill(q, pk, pv, tables, kv, offs, 1)
    assert pp.paged_flash_prefill_fp8kv.launches == before + 1
    want = pp.paged_flash_prefill_ref(q, pk, pv, tables, kv, offs, 1)
    assert bool(torch.isfinite(got).all())
    assert _attn_ok(got, want)


@pytest.mark.parametrize("xdt", DTYPES)
@pytest.mark.parametrize("n,kvn,d,h", [(8, 2, 64, 512), (4, 4, 128, 512),
                                       (8, 4, 32, 512), (32, 32, 128, 4096)])
def test_fused_qkv_append_fp8kv(cuda, xdt, n, kvn, d, h):
    g = torch.Generator(device=cuda).manual_seed(n * kvn + d)
    L, ps = 2, 16
    pos = torch.tensor([5, 20, 40], dtype=torch.int32, device=cuda)
    tables = torch.tensor([[3, 7, 1], [0, 5, 8], [2, 4, -1]],
                          dtype=torch.int32, device=cuda)
    nq = (n + 2 * kvn) * d
    wq, ws = _qw(g, cuda, (L, h, nq), 1)
    ws = ws * 30                                    # k/v past 464 too
    nw = torch.rand((L, h), generator=g, device=cuda).to(xdt) + 0.5
    x = torch.randn((3, h), generator=g, device=cuda).to(xdt)
    sin, cos = ref_ops.rope_tables(pos, d, 10000.0)
    pools = _e4m3_pools(g, cuda, b=3, kvn=kvn, ps=ps, d=d, mp=3)
    a, r = [p.clone() for p in pools], [p.clone() for p in pools]
    before = (qf.fused_qkv_append.launches,
              qf.fused_qkv_append_fp8kv.launches)
    with _one_launch(qf.QKV_REGIME_LAUNCHES,
                     qf.qkv_regime(3, h, nq, d, xdt)):
        qa, *_ = qf.fused_qkv_append(x, nw, wq, ws, sin, cos, a[0], a[1], 1,
                                     pos, n_heads=n, kv_heads=kvn,
                                     tables=tables)
    assert (qf.fused_qkv_append.launches,
            qf.fused_qkv_append_fp8kv.launches) == (before[0], before[1] + 1)
    qr, *_ = qf.fused_qkv_append_ref(x, nw, wq, ws, sin, cos, r[0], r[1], 1,
                                     pos, n_heads=n, kv_heads=kvn,
                                     tables=tables)
    tol = 1e-5 if xdt == torch.float32 else 2e-2
    assert float((qa.float() - qr.float()).abs().max()) <= tol * float(
        qr.float().std())
    written = torch.zeros(pools[0].shape, dtype=torch.bool, device=cuda)
    for i, p in enumerate(pos.tolist()):
        page = int(tables[i, p // ps])
        written[1, page if page >= 0 else pools[0].shape[1] - 1, :,
                p % ps] = True
    for x_a, x_r in zip(a, r):
        assert _bytes_equal(x_a[~written], x_r[~written])
        # k/v from sums in another order: a code one step apart at most
        assert int((_ordinal(x_a[written]) - _ordinal(x_r[written])).abs()
                   .max()) <= 1
        assert bool((x_r[written].view(torch.uint8) & 0x7F == 0x7F).any())


def test_fp8kv_engine_runs_the_kernels_only(cuda):
    # kv_dtype="fp8" on both weight paths, with the prefix cache, chunked
    # prefill and speculation: every FP8-KV form launches, no plain version
    # runs
    cfg = ModelConfig.tiny_test(num_layers=2)
    refs = (pa.paged_append_decode_ref, pa.paged_append_prefill_ref,
            pa.paged_append_span_ref, fp.flash_prefill_ref,
            pd.paged_flash_decode_ref, pd.paged_flash_verify_ref,
            pp.paged_flash_prefill_ref, mm.quantized_matmul_ref,
            qf.fused_qkv_append_ref, ff.fused_ffn_ref)
    calls = [f.cuda_calls for f in refs]
    system = list(range(3, 35))
    waves = [[[1, 2, 3]], [system + [40]],
             [system + [41, 42], system + [43, 44] * 9]]
    for params, spec, kerns in (
            (llama.init_params(cfg, seed=0, device=cuda), 0,
             (pa.paged_append_decode_fp8kv, pd.paged_flash_decode_fp8kv,
              pa.paged_append_prefill_fp8kv, pp.paged_flash_prefill_fp8kv)),
            (_int8_params(cfg, 0, cuda), 0,
             (qf.fused_qkv_append_fp8kv, pd.paged_flash_decode_fp8kv,
              pa.paged_append_prefill_fp8kv)),
            (llama.init_params(cfg, seed=0, device=cuda), 3,
             (pa.paged_append_span_fp8kv, pd.paged_flash_verify_fp8kv))):
        ecfg = EngineConfig(max_batch_size=4, prefill_chunk=16,
                            spec_tokens=spec,
                            kv=KVCacheConfig(page_size=8, num_pages=64,
                                             max_pages_per_seq=8,
                                             kv_dtype="fp8"))
        launches = [f.launches for f in kerns]
        eng = Engine(cfg, params, ecfg, decode_burst=4)
        assert eng.cache.k.dtype == E4 and eng.cache.k_scale is None
        outs = [eng.generate(w, SamplingParams(max_new_tokens=6))
                for w in waves]
        assert all(len(o) == 6 for w in outs for o in w)
        assert all(f.launches > n for f, n in zip(kerns, launches))
    assert [f.cuda_calls for f in refs] == calls


def test_fp8kv_engine_card_matches_cpu(cuda):
    cfg = ModelConfig.tiny_test(num_layers=2)
    p_cpu = llama.init_params(cfg, seed=3, device="cpu")
    system = list(range(5, 29))
    prompts = [system + [1, 2, 3], system + [9, 8, 7, 6], list(range(20, 40))]
    s = SamplingParams(max_new_tokens=8)
    for p in (p_cpu, _int8_params(cfg, 3, "cpu")):
        for spec in (0, 2):
            ecfg = EngineConfig(max_batch_size=3, prefill_chunk=16,
                                spec_tokens=spec,
                                kv=KVCacheConfig(page_size=8, num_pages=64,
                                                 max_pages_per_seq=8,
                                                 kv_dtype="fp8"))
            outs = [Engine(cfg, pp_, ecfg, decode_burst=4,
                           device=dev).generate(prompts, s)
                    for pp_, dev in ((p, "cpu"), (_to(p, cuda), cuda))]
            assert outs[0] == outs[1]


# ------------------------------------------------ head_dim 256 (Gemma-2B)
# Gemma-2B's attention: 8 q heads over one kv head, D 256, page 128.

G_N, G_KVN, G_D = 8, 1, 256


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [128, 100, 1])
def test_paged_append_head_dim_256(cuda, dtype, s):
    # kernels 1 and 2 on 512-byte (bf16) and 1 KB (f32) rows: the
    # 16-byte vector path, byte-exact against the plain versions
    g = torch.Generator(device=cuda).manual_seed(256 + s)
    pk, pv = _pools(g, cuda, dtype, kvn=G_KVN, d=G_D)
    nk = torch.randn((3, s, G_KVN, G_D), generator=g, device=cuda,
                     dtype=dtype)
    nv = torch.randn((3, s, G_KVN, G_D), generator=g, device=cuda,
                     dtype=dtype)
    a, r = (pk.clone(), pv.clone()), (pk.clone(), pv.clone())
    before = pa.paged_append_prefill.launches
    pa.paged_append_prefill(*a, nk, nv, _tables(cuda), 1)
    assert pa.paged_append_prefill.launches == before + 1
    pa.paged_append_prefill_ref(*r, nk, nv, _tables(cuda), 1)
    pos = torch.tensor([s, 130, 5], dtype=torch.int32, device=cuda)
    before = pa.paged_append_decode.launches
    pa.paged_append_decode(*a, nk[:, 0], nv[:, 0], _tables(cuda), pos, 0)
    assert pa.paged_append_decode.launches == before + 1
    pa.paged_append_decode_ref(*r, nk[:, 0], nv[:, 0], _tables(cuda), pos, 0)
    for x, y in zip(a, r):
        assert torch.equal(x[:, :-1], y[:, :-1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s", [(8, 128), (3, 77), (2, 1), (1, 1000)])
def test_flash_prefill_head_dim_256(cuda, dtype, b, s):
    # kernel 3 at D 256: bf16 on wgmma.m64n256k16 (8 positions x 8 heads a
    # tile; (1, 1000): the key walk split over blocks), f32 on FMAs; a
    # strided v
    g = torch.Generator(device=cuda).manual_seed(b * s)
    q = torch.randn((b, s, G_N, G_D), generator=g, device=cuda, dtype=dtype)
    k = torch.randn((b, s, G_KVN, G_D), generator=g, device=cuda,
                    dtype=dtype)
    vbig = torch.randn((b, s, 3 * G_D), generator=g, device=cuda,
                       dtype=dtype)
    v = vbig[..., G_D:2 * G_D].reshape(b, s, G_KVN, G_D)
    before = fp.flash_prefill.launches
    got = fp.flash_prefill(q, k, v)
    assert fp.flash_prefill.launches == before + 1
    assert _attn_ok(got, fp.flash_prefill_ref(q, k, v))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("edges", [False, True], ids=["lens", "split-edges"])
def test_paged_flash_decode_head_dim_256(cuda, dtype, edges):
    g = torch.Generator(device=cuda).manual_seed(256 + edges)
    batches = ([[1, 128, 129, 200, 0, 57, 152, 3]] if not edges
               else _split_edge_lens(G_KVN, 16 * 128, rows=G_N // G_KVN))
    for lens in batches:
        _check_paged_flash_decode(g, cuda, dtype, G_N, G_KVN, G_D, lens,
                                  2 if not edges else 16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("edges", [False, True], ids=["lens", "split-edges"])
def test_flash_decode_head_dim_256(cuda, dtype, edges):
    g = torch.Generator(device=cuda).manual_seed(257 + edges)
    if not edges:
        _check_flash_decode(g, cuda, dtype, G_N, G_KVN, G_D,
                            [1, 0, 161, 256, 300], 256)
        return
    for lens in _split_edge_lens(G_KVN, 2048, rows=G_N // G_KVN):
        lens[0], lens[1], lens[-1] = lens[1], 0, 2048 + 5
        _check_flash_decode(g, cuda, dtype, G_N, G_KVN, G_D, lens, 2048)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,ps", [(64, 128), (256, 128), (37, 16), (1, 16)])
def test_paged_flash_prefill_head_dim_256(cuda, dtype, s, ps):
    # kernel 8 at D 256: ragged offsets off a page multiple, an unmapped
    # page inside kv_len, a batch's padding row (-1 table, kv_len 1)
    g = torch.Generator(device=cuda).manual_seed(s + ps)
    b, mp = 4, -(-(s + 600) // ps)
    pk, pv = _pools(g, cuda, dtype, b=b, kvn=G_KVN, ps=ps, d=G_D, mp=mp)
    q = torch.randn((b, s, G_N, G_D), generator=g, device=cuda, dtype=dtype)
    tables = torch.randperm(b * mp, generator=g, device=cuda).to(
        torch.int32).reshape(b, mp)
    offs = torch.tensor([0, 37, 512, 0], dtype=torch.int32, device=cuda)
    kv = offs + torch.tensor([s, max(s - 5, 1), s, 1], dtype=torch.int32,
                             device=cuda)
    tables[2, 1] = -1
    tables[3] = -1
    before = pp.paged_flash_prefill.launches
    got = pp.paged_flash_prefill(q, pk, pv, tables, kv, offs, 1)
    assert pp.paged_flash_prefill.launches == before + 1
    want = pp.paged_flash_prefill_ref(q, pk, pv, tables, kv, offs, 1)
    assert bool(torch.isfinite(got).all())
    assert _attn_ok(got, want)


@pytest.mark.parametrize("xdt,pdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("b", [3, 8])
def test_fused_qkv_append_head_dim_256(cuda, xdt, pdt, b):
    # kernel 6 at Gemma-2B's shape (H 2048, 10 heads of 256: 2560 qkv
    # columns): bf16 rows on 6m, whose blocks take a head's RoPE pairs
    # (two 64-column runs 128 apart), f32 rows on the FMA kernel
    g = torch.Generator(device=cuda).manual_seed(256 * b)
    pos = torch.tensor([5, 127, 128, 40, 300, 3, 255, 600][:b],
                       dtype=torch.int32, device=cuda)
    tables = torch.arange(b * 6, dtype=torch.int32,
                          device=cuda).reshape(b, 6)
    tables[b - 1, pos[b - 1] // 128] = -1      # the trash page
    assert qf.qkv_regime(b, 2048, 2560, G_D, xdt) == (
        "mma" if xdt == torch.bfloat16 else "fma")
    _check_qkv(cuda, g, xdt, pdt, G_N, G_KVN, G_D, pos, tables, h=2048,
               ps=128)


@pytest.mark.parametrize("xdt", DTYPES)
def test_fused_qkv_append_dense_head_dim_256(cuda, xdt):
    g = torch.Generator(device=cuda).manual_seed(7)
    b, h, smax = 4, 2048, 128
    nq = (G_N + 2 * G_KVN) * G_D
    wq = torch.randint(-127, 128, (2, h, nq), generator=g, device=cuda,
                       dtype=torch.int8)
    ws = (torch.rand((2, 1, nq), generator=g, device=cuda) + 0.5) * 1e-2
    nw = (1.0 + 0.1 * torch.randn((2, h), generator=g, device=cuda)).to(xdt)
    x = torch.randn((b, h), generator=g, device=cuda).to(xdt)
    pos = torch.tensor([5, 127, 128, 40], dtype=torch.int32, device=cuda)
    sin, cos = ref_ops.rope_tables(pos, G_D, 10000.0)
    ck, cv = _arena(g, cuda, xdt, rows=5, kvn=G_KVN, smax=smax, d=G_D)
    a, r = (ck.clone(), cv.clone()), (ck.clone(), cv.clone())
    before = qf.fused_qkv_append_dense.launches
    qa, *_ = qf.fused_qkv_append(x, nw, wq, ws, sin, cos, *a, 1, pos,
                                 n_heads=G_N, kv_heads=G_KVN)
    assert qf.fused_qkv_append_dense.launches == before + 1
    qr, *_ = qf.fused_qkv_append_ref(x, nw, wq, ws, sin, cos, *r, 1, pos,
                                     n_heads=G_N, kv_heads=G_KVN)
    tol = 1e-5 if xdt == torch.float32 else 2e-2
    sd = float(qr.float().std())
    assert float((qa.float() - qr.float()).abs().max()) <= tol * sd
    for ta, tr in zip(a, r):
        assert float((ta.float() - tr.float()).abs().max()) <= tol * sd
    assert torch.equal(a[0][1, 2], ck[1, 2])   # slot 128 past Smax: dropped


def test_head_dim_256_forms_outside_the_slice_raise(cuda):
    # every paged form takes D 256 (the window forms 3w, 4w, 8w and 6k since
    # Gemma-2's slice, the verify forms 4v and 4vw over pools of q's dtype
    # since its dense slice, the INT8-KV forms since the INT8-KV slice of
    # Gemma, the e4m3 forms since its FP8-KV slice: these e4m3 calls raised
    # before it): each launches, counts in its module's D256_LAUNCHES and,
    # for the e4m3 forms, matches its plain version (the writes byte for
    # byte)
    g = torch.Generator(device=cuda).manual_seed(0)
    bf, e4 = torch.bfloat16, torch.float8_e4m3fn
    pk, pv = _pools(g, cuda, bf, kvn=G_KVN, d=G_D)
    qk, qv, ks, vs = _quant_pools(g, cuda, kvn=G_KVN, d=G_D)
    ek, ev = pk.to(e4), pv.to(e4)
    tables, kv = _tables(cuda), torch.tensor([5, 9, 0], dtype=torch.int32,
                                             device=cuda)
    q1 = torch.randn((3, G_N, G_D), generator=g, device=cuda, dtype=bf)
    q3 = torch.randn((3, 3, G_N, G_D), generator=g, device=cuda, dtype=bf)
    offs = torch.zeros(3, dtype=torch.int32, device=cuda)
    nk = torch.randn((3, 4, G_KVN, G_D), generator=g, device=cuda, dtype=bf)
    attn = [
        (pd.D256_LAUNCHES, "paged_flash_decode_fp8kv",
         lambda: pd.paged_flash_decode(q1, ek, ev, tables, kv, 0),
         lambda: pd.paged_flash_decode_ref(q1, ek, ev, tables, kv, 0)),
        (pd.D256_LAUNCHES, "paged_flash_verify_fp8kv",
         lambda: pd.paged_flash_verify(q3, ek, ev, tables, kv, 0),
         lambda: pd.paged_flash_verify_ref(q3, ek, ev, tables, kv, 0)),
        (pp.D256_LAUNCHES, "paged_flash_prefill_fp8kv",
         lambda: pp.paged_flash_prefill(q3, ek, ev, tables, kv, offs, 0),
         lambda: pp.paged_flash_prefill_ref(q3, ek, ev, tables, kv, offs,
                                            0)),
    ]
    for counts, form, call, plain in attn:
        before = counts[form]
        got = call()
        torch.cuda.synchronize()
        assert counts[form] == before + 1, form
        want = plain()
        live = [i for i in range(3) if int(kv[i]) > 0]
        assert _close(got[live], want[live], bf), form
    for counts, form, call in (
            (pa.D256_LAUNCHES, "paged_append_decode_fp8kv",
             lambda p: pa.paged_append_decode(*p, nk[:, 0], nk[:, 0], tables,
                                              offs, 0)),
            (pa.D256_LAUNCHES, "paged_append_prefill_fp8kv",
             lambda p: pa.paged_append_prefill(*p, nk, nk, tables, 0))):
        a, r = [ek.clone(), ev.clone()], [ek.clone(), ev.clone()]
        before = counts[form]
        call(a)
        torch.cuda.synchronize()
        assert counts[form] == before + 1, form
        plain = (pa.paged_append_decode_ref if "decode" in form
                 else pa.paged_append_prefill_ref)
        if "decode" in form:
            plain(*r, nk[:, 0], nk[:, 0], tables, offs, 0)
        else:
            plain(*r, nk, nk, tables, 0)
        for x, y in zip(a, r):
            assert _bytes_equal(x[:, :-1], y[:, :-1]), form
    runs = [
        (pd.D256_LAUNCHES, "paged_flash_decode_int8kv",
         lambda: pd.paged_flash_decode(q1, qk, qv, tables, kv, 0,
                                       k_scale=ks, v_scale=vs)),
        (pd.D256_LAUNCHES, "paged_flash_verify_int8kv",
         lambda: pd.paged_flash_verify(q3, qk, qv, tables, kv, 0,
                                       k_scale=ks, v_scale=vs)),
        (pd.D256_LAUNCHES, "paged_flash_verify_int8kv_window",
         lambda: pd.paged_flash_verify(q3, qk, qv, tables, kv, 0,
                                       k_scale=ks, v_scale=vs, window=4)),
        (pp.D256_LAUNCHES, "paged_flash_prefill_int8kv",
         lambda: pp.paged_flash_prefill(q3, qk, qv, tables, kv, offs, 0,
                                        k_scale=ks, v_scale=vs)),
        (pa.D256_LAUNCHES, "paged_append_decode_quant",
         lambda: pa.paged_append_decode_quant(qk, qv, ks, vs, nk[:, 0],
                                              nk[:, 0], tables, offs, 0)[0]),
        (pa.D256_LAUNCHES, "paged_append_prefill_quant",
         lambda: pa.paged_append_prefill_quant(qk, qv, ks, vs, nk, nk,
                                               tables, 0)[0]),
    ]
    for counts, form, call in runs:
        before = counts[form]
        out = call()
        torch.cuda.synchronize()
        assert counts[form] == before + 1, form
        if out.dtype == bf:
            assert bool(torch.isfinite(out).all()), form


# ------------------------------------- Gemma-2-2B: the soft cap, D-256 windows
# Gemma-2-2B's attention: 8 q heads over 4 kv heads (GQA group 2), D 256,
# query_pre_attn_scalar 256 (the D**-0.5 scale), attention soft cap 50,
# window 4096 on the sliding layers. Scores x SCORE_X pass the cap.

G2_N, G2_KVN, G2_CAP = 8, 4, 50.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 40], ids=["3c", "3wc"])
@pytest.mark.parametrize("d,big", [(256, False), (256, True), (128, True)],
                         ids=["d256", "d256-past-cap", "d128-past-cap"])
def test_flash_prefill_softcap(cuda, dtype, window, d, big):
    # bench.py's prefill at Gemma-2-2B (8 x 128) and a window whose tiles
    # start off a multiple of 64; scores of ~1 (the cap barely bites) or
    # ~100 (|s| past the cap)
    g = torch.Generator(device=cuda).manual_seed(d + big + (window or 0))
    b, s = (8, 128) if d == 256 else (3, 130)
    q = torch.randn((b, s, G2_N, d), generator=g, device=cuda, dtype=dtype)
    if big:
        q = q * 100
    k = torch.randn((b, s, G2_KVN, d), generator=g, device=cuda, dtype=dtype)
    v = torch.randn((b, s, G2_KVN, d), generator=g, device=cuda, dtype=dtype)
    form = fp.flash_prefill_window if window else fp.flash_prefill
    before = form.launches, fp.CAP_LAUNCHES.get((form.__name__, d), 0)
    got = fp.flash_prefill(q, k, v, window=window, logit_cap=G2_CAP)
    assert (form.launches, fp.CAP_LAUNCHES[form.__name__, d]) == (
        before[0] + 1, before[1] + 1)
    want = fp.flash_prefill_ref(q, k, v, window=window, logit_cap=G2_CAP)
    assert _attn_ok(got, want)
    # past the cap the outputs move (the cap bites)
    if big:
        plain = fp.flash_prefill_ref(q, k, v, window=window)
        assert float((plain.float() - got.float()).abs().max()) > 1e-2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 4096, 100],
                         ids=["4c", "4wc", "4wc-100"])
@pytest.mark.parametrize("d", [256, 128])
def test_paged_flash_decode_softcap(cuda, dtype, window, d):
    # Gemma-2's decode at the bench batch, kv_len 0 and 1, the window's
    # edges (kv_len window, window + 1, a band starting inside a page)
    # and past the cap; a dead slot
    g = torch.Generator(device=cuda).manual_seed(d + (window or 1))
    lens = [0, 1, 128, 4096, 4097, 4200, 4321, 3]
    b, ps, mp = len(lens), 128, 35
    pk, pv = _pools(g, cuda, dtype, b=b, kvn=G2_KVN, ps=ps, d=d, mp=mp)
    q = torch.randn((b, G2_N, d), generator=g, device=cuda,
                    dtype=dtype) * 60
    tables = torch.randperm(b * mp, generator=g, device=cuda).to(
        torch.int32).reshape(b, mp)
    tables[-1] = -1
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    form = pd.paged_flash_decode_window if window else pd.paged_flash_decode
    before = form.launches, fp.CAP_LAUNCHES.get((form.__name__, d), 0)
    got = pd.paged_flash_decode(q, pk, pv, tables, kv, 1, window=window,
                                logit_cap=G2_CAP)
    assert (form.launches, fp.CAP_LAUNCHES[form.__name__, d]) == (
        before[0] + 1, before[1] + 1)
    want = pd.paged_flash_decode_ref(q, pk, pv, tables, kv, 1,
                                     window=window, logit_cap=G2_CAP)
    assert float((got.float() - want.float()).abs().max()) <= ATTN_TOL[dtype]
    assert not got[0].any() and not got[-1].any()


def test_paged_flash_decode_window_d256_reads_no_page_below_the_band(cuda):
    # 4wc at D 256 over ring tables whose columns below the band point at
    # NaN pages: finite, and equal to the clean tables' outputs
    g = torch.Generator(device=cuda).manual_seed(4)
    b, r, mp, ps, window = 2, 4, 12, 16, 40
    pk, pv = _pools(g, cuda, torch.bfloat16, b=b, kvn=G2_KVN, ps=ps,
                    d=G_D, mp=r + 2)
    poison = torch.arange(b * r, b * r + 4, device=cuda)
    pk[:, poison] = float("nan")
    pv[:, poison] = float("nan")
    ring = (torch.arange(b, device=cuda)[:, None] * r
            + torch.arange(mp, device=cuda)[None] % r).to(torch.int32)
    lens = torch.tensor([150, 171], dtype=torch.int32, device=cuda)
    dirty = ring.clone()
    for i in range(b):
        below = (torch.arange(mp, device=cuda) + 1) * ps <= (
            int(lens[i]) - window)
        dirty[i, below] = poison[torch.arange(int(below.sum()),
                                              device=cuda) % 4].to(
            torch.int32)
    q = torch.randn((b, G2_N, G_D), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    clean = pd.paged_flash_decode(q, pk, pv, ring, lens, 1, window=window,
                                  logit_cap=G2_CAP)
    got = pd.paged_flash_decode(q, pk, pv, dirty, lens, 1, window=window,
                                logit_cap=G2_CAP)
    assert bool(torch.isfinite(clean).all()) and torch.equal(got, clean)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 4096, 70],
                         ids=["8c", "8wc", "8wc-70"])
@pytest.mark.parametrize("d,s", [(256, 256), (256, 37), (128, 64)])
def test_paged_flash_prefill_softcap(cuda, dtype, window, d, s):
    # 8c/8wc: Gemma-2's 256-row chunks past a window of 4096 (offset
    # 4096), ragged offsets, an unmapped page inside kv_len, a padding row;
    # scores past the cap
    g = torch.Generator(device=cuda).manual_seed(d + s + (window or 0))
    ps = 128
    b, mp = 4, -(-(s + 4200) // ps)
    pk, pv = _pools(g, cuda, dtype, b=b, kvn=G2_KVN, ps=ps, d=d, mp=mp)
    q = torch.randn((b, s, G2_N, d), generator=g, device=cuda,
                    dtype=dtype) * 60
    tables = torch.randperm(b * mp, generator=g, device=cuda).to(
        torch.int32).reshape(b, mp)
    offs = torch.tensor([4096, 37, 512, 0], dtype=torch.int32, device=cuda)
    kv = offs + torch.tensor([s, max(s - 5, 1), s, 1], dtype=torch.int32,
                             device=cuda)
    tables[2, 1] = -1
    tables[3] = -1
    form = (pp.paged_flash_prefill_window if window
            else pp.paged_flash_prefill)
    before = form.launches, fp.CAP_LAUNCHES.get((form.__name__, d), 0)
    got = pp.paged_flash_prefill(q, pk, pv, tables, kv, offs, 1,
                                 window=window, logit_cap=G2_CAP)
    assert (form.launches, fp.CAP_LAUNCHES[form.__name__, d]) == (
        before[0] + 1, before[1] + 1)
    want = pp.paged_flash_prefill_ref(q, pk, pv, tables, kv, offs, 1,
                                      window=window, logit_cap=G2_CAP)
    assert bool(torch.isfinite(got).all())
    assert _attn_ok(got, want)


@pytest.mark.parametrize("xdt,pdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32)])
@pytest.mark.parametrize("b", [1, 8])
def test_fused_qkv_append_kv_layer_head_dim_256(cuda, xdt, pdt, b):
    # 6k at Gemma-2-2B's shape (H 2304, 8 + 2 x 4 heads of 256: 4096 qkv
    # columns): the weights of layer 1, k/v into the ring pools' layer 0;
    # bf16 rows on 6m, f32 rows on the FMA kernel
    g = torch.Generator(device=cuda).manual_seed(2304 + b)
    pos = torch.tensor([5, 127, 128, 40, 300, 3, 255, 600][:b],
                       dtype=torch.int32, device=cuda)
    tables = torch.arange(b * 6, dtype=torch.int32,
                          device=cuda).reshape(b, 6)
    assert qf.qkv_regime(b, 2304, 4096, G_D, xdt) == (
        "mma" if xdt == torch.bfloat16 else "fma")
    _check_qkv(cuda, g, xdt, pdt, G2_N, G2_KVN, G_D, pos, tables, h=2304,
               ps=128, kv_layer=0)


def test_softcap_forms_outside_the_slice_raise(cuda):
    # the cap over every pool dtype launches: over e4m3 pools (4ec, 4vec,
    # 8ec, which raised before Gemma's FP8-KV slice) it counts in
    # CAP_LAUNCHES under the FP8-KV form's name and matches its plain
    # version; over INT8 pools (4qc, 4vqc, 8qc) under the INT8-KV form's
    # (on verify rows and on the dense arena over pools of q's dtype it
    # runs since Gemma-2's dense slice)
    g = torch.Generator(device=cuda).manual_seed(1)
    bf, e4 = torch.bfloat16, torch.float8_e4m3fn
    pk, pv = _pools(g, cuda, bf, kvn=2, d=64)
    qk, qv, ks, vs = _quant_pools(g, cuda, kvn=2, d=64)
    ek, ev = pk.to(e4), pv.to(e4)
    tables, kv = _tables(cuda), torch.tensor([5, 9, 0], dtype=torch.int32,
                                             device=cuda)
    q1 = torch.randn((3, 4, 64), generator=g, device=cuda, dtype=bf) * 40
    q3 = torch.randn((3, 3, 4, 64), generator=g, device=cuda, dtype=bf) * 40
    offs = torch.zeros(3, dtype=torch.int32, device=cuda)
    cap = dict(logit_cap=G2_CAP)
    e4_runs = [
        ("paged_flash_decode_fp8kv",
         lambda: pd.paged_flash_decode(q1, ek, ev, tables, kv, 0, **cap),
         lambda: pd.paged_flash_decode_ref(q1, ek, ev, tables, kv, 0, **cap)),
        ("paged_flash_verify_fp8kv",
         lambda: pd.paged_flash_verify(q3, ek, ev, tables, kv, 0, **cap),
         lambda: pd.paged_flash_verify_ref(q3, ek, ev, tables, kv, 0,
                                           **cap)),
        ("paged_flash_prefill_fp8kv",
         lambda: pp.paged_flash_prefill(q3, ek, ev, tables, kv, offs, 0,
                                        **cap),
         lambda: pp.paged_flash_prefill_ref(q3, ek, ev, tables, kv, offs, 0,
                                            **cap)),
    ]
    for form, call, plain in e4_runs:
        n = fp.CAP_LAUNCHES.get((form, 64), 0)
        got = call()
        torch.cuda.synchronize()
        assert fp.CAP_LAUNCHES[form, 64] == n + 1, form
        want = plain()
        assert _close(got[:2], want[:2], bf), form
    runs = [
        ("paged_flash_decode_int8kv",
         lambda: pd.paged_flash_decode(q1, qk, qv, tables, kv, 0, k_scale=ks,
                                       v_scale=vs, **cap)),
        ("paged_flash_verify_int8kv",
         lambda: pd.paged_flash_verify(q3, qk, qv, tables, kv, 0,
                                       k_scale=ks, v_scale=vs, **cap)),
        ("paged_flash_prefill_int8kv",
         lambda: pp.paged_flash_prefill(q3, qk, qv, tables, kv, offs, 0,
                                        k_scale=ks, v_scale=vs, **cap)),
    ]
    for form, call in runs:
        n = fp.CAP_LAUNCHES.get((form, 64), 0)
        out = call()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all()), form
        assert fp.CAP_LAUNCHES[form, 64] == n + 1, form


# --------------------- Gemma-2 on the dense arena and under speculation
# 13w, 13c and 13wc at Gemma-2-2B's decode (8 q heads over 4 kv heads,
# D 256, an arena of 8192 slots) and D 128 (Mistral's 32 over 8); the
# verify forms at D 256 (4v/256, 4vw/256: Gemma-1's group of 8, two row
# blocks at S 5; Gemma-2-2B's and -9B's group of 2) and capped (4vc, 4vwc
# at D 128 and 256). Scores past the cap where it is on; kv_len 0, below
# and past the window, a band starting inside a tile.


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,cap", [(4096, None), (None, G2_CAP),
                                        (4096, G2_CAP), (100, G2_CAP)],
                         ids=["13w", "13c", "13wc", "13wc-100"])
@pytest.mark.parametrize("n,kvn,d", [(G2_N, G2_KVN, 256), (32, 8, 128)])
def test_flash_decode_window_and_softcap(cuda, dtype, window, cap, n, kvn,
                                         d):
    from simplellminference_tpu_torch.ops.attention import flash_decode as fd
    g = torch.Generator(device=cuda).manual_seed(d + (window or 7))
    lens = [0, 1, 100, 4096, 4097, 4224, 4543, 8192]
    b, smax = len(lens), 8192
    ck, cv = _arena(g, cuda, dtype, rows=b + 1, kvn=kvn, smax=smax, d=d)
    q = torch.randn((b, n, d), generator=g, device=cuda,
                    dtype=dtype) * (60 if cap else 1)
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    form = fd.flash_decode_window if window else fd.flash_decode
    key = (form.__name__, d)
    before = form.launches, fp.CAP_LAUNCHES.get(key, 0)
    got = fd.flash_decode(q, ck, cv, kv, layer=1, window=window,
                          logit_cap=cap)
    assert (form.launches, fp.CAP_LAUNCHES.get(key, 0)) == (
        before[0] + 1, before[1] + bool(cap))
    want = fd.flash_decode_ref(q, ck, cv, kv, layer=1, window=window,
                               logit_cap=cap)
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    assert float((got.float() - want.float()).abs().max()) <= ATTN_TOL[dtype]
    assert not got[0].any()          # kv_len 0 -> zero output


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 4096, 100],
                         ids=["4v", "4vw", "4vw-100"])
@pytest.mark.parametrize("n,kvn,d,cap", [
    (G_N, G_KVN, 256, None), (G2_N, G2_KVN, 256, None),
    (G2_N, G2_KVN, 256, G2_CAP), (16, 8, 256, G2_CAP), (32, 8, 128, G2_CAP)],
    ids=["gemma-1", "gemma-2", "gemma-2-cap", "gemma-2-9b-cap", "d128-cap"])
def test_paged_flash_verify_head_dim_256_and_softcap(cuda, dtype, window, n,
                                                     kvn, d, cap):
    g = torch.Generator(device=cuda).manual_seed(n + kvn + d + (window or 3))
    s, ps, mp = 5, 128, 36
    lens = [0, 3, 5, 128, 4096, 4100, 4500, 200]
    b = len(lens)
    pk, pv = _pools(g, cuda, dtype, b=b, kvn=kvn, ps=ps, d=d, mp=mp)
    q = torch.randn((b, s, n, d), generator=g, device=cuda,
                    dtype=dtype) * (60 if cap else 1)
    tables = torch.randperm(b * mp, generator=g, device=cuda).to(
        torch.int32).reshape(b, mp)
    tables[-1] = -1                  # a dead slot: every entry unmapped
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    form = pd.paged_flash_verify_window if window else pd.paged_flash_verify
    name = form.__name__

    def counts():
        return (form.launches, pd.D256_LAUNCHES[name],
                fp.CAP_LAUNCHES.get((name, d), 0))

    before = counts()
    got = pd.paged_flash_verify(q, pk, pv, tables, kv, 1, window=window,
                                logit_cap=cap)
    assert counts() == (before[0] + 1, before[1] + (d == 256),
                        before[2] + bool(cap))
    want = pd.paged_flash_verify_ref(q, pk, pv, tables, kv, 1,
                                     window=window, logit_cap=cap)
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    assert float((got.float() - want.float()).abs().max()) <= ATTN_TOL[dtype]
    assert not got[0].any() and not got[-1].any()
    assert not got[1, :2].any()      # rows before position 0


# ------------------------------------------- gpt-oss-20b: attention sinks
# gpt-oss-20b's attention: 64 q heads over 8 kv heads (GQA group 8), D 64,
# window 128 on the sliding layers, a sink logit per q head drawn N(0, 1),
# or SINK_ABOVE, above every score of unit q and k (a sink counted twice
# or in the wrong units then moves every output far past the rule).

OSS_N, OSS_KVN, OSS_D, SINK_ABOVE = 64, 8, 64, 10.0


def _oss_sinks(g, dev, above):
    if above:
        return torch.full((OSS_N,), SINK_ABOVE, device=dev)
    return torch.randn((OSS_N,), generator=g, device=dev).to(
        torch.bfloat16).float()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 128, 40], ids=["3s", "3ws",
                                                        "3ws-40"])
@pytest.mark.parametrize("above", [False, True], ids=["n01", "above"])
def test_flash_prefill_sinks(cuda, dtype, window, above):
    # bench.py's prefill at gpt-oss-20b (8 x 128) and 3 x 300 rows
    g = torch.Generator(device=cuda).manual_seed(64 + (window or 0) + above)
    b, s = (8, 128) if window != 40 else (3, 300)
    q = torch.randn((b, s, OSS_N, OSS_D), generator=g, device=cuda,
                    dtype=dtype)
    k = torch.randn((b, s, OSS_KVN, OSS_D), generator=g, device=cuda,
                    dtype=dtype)
    v = torch.randn((b, s, OSS_KVN, OSS_D), generator=g, device=cuda,
                    dtype=dtype)
    sinks = _oss_sinks(g, cuda, above)
    form = fp.flash_prefill_window if window else fp.flash_prefill
    before = form.launches, fp.SINK_LAUNCHES.get((form.__name__, OSS_D), 0)
    got = fp.flash_prefill(q, k, v, window=window, sinks=sinks)
    assert (form.launches, fp.SINK_LAUNCHES[form.__name__, OSS_D]) == (
        before[0] + 1, before[1] + 1)
    want = fp.flash_prefill_ref(q, k, v, window=window, sinks=sinks)
    assert _attn_ok(got, want)
    # the sink takes weight: the outputs move
    plain = fp.flash_prefill_ref(q, k, v, window=window)
    assert float((plain.float() - got.float()).abs().max()) > 1e-2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 128, 70],
                         ids=["4s", "4ws", "4ws-70"])
@pytest.mark.parametrize("above", [False, True], ids=["n01", "above"])
def test_paged_flash_decode_sinks(cuda, dtype, window, above):
    # the decode at the bench batch, kv_len 0 and 1, the window's edges and
    # 4096 (the key walk split over blocks); a dead slot
    g = torch.Generator(device=cuda).manual_seed(65 + (window or 0) + above)
    lens = [0, 1, 128, 129, 4096, 4097, 300, 3]
    b, ps, mp = len(lens), 128, 33
    pk, pv = _pools(g, cuda, dtype, b=b, kvn=OSS_KVN, ps=ps, d=OSS_D, mp=mp)
    q = torch.randn((b, OSS_N, OSS_D), generator=g, device=cuda,
                    dtype=dtype)
    tables = torch.randperm(b * mp, generator=g, device=cuda).to(
        torch.int32).reshape(b, mp)
    tables[-1] = -1
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    sinks = _oss_sinks(g, cuda, above)
    span = mp * ps if not window else window
    assert window or pd.decode_splits(b, OSS_KVN, span) > 1
    form = pd.paged_flash_decode_window if window else pd.paged_flash_decode
    before = form.launches, fp.SINK_LAUNCHES.get((form.__name__, OSS_D), 0)
    got = pd.paged_flash_decode(q, pk, pv, tables, kv, 1, window=window,
                                sinks=sinks)
    assert (form.launches, fp.SINK_LAUNCHES[form.__name__, OSS_D]) == (
        before[0] + 1, before[1] + 1)
    want = pd.paged_flash_decode_ref(q, pk, pv, tables, kv, 1,
                                     window=window, sinks=sinks)
    assert _close(got, want, dtype)
    assert not got[0].any() and not got[-1].any()


def test_paged_flash_decode_window_sinks_read_no_page_below_the_band(cuda):
    # 4ws over ring tables whose columns below the band point at NaN pages
    g = torch.Generator(device=cuda).manual_seed(66)
    b, r, mp, ps, window = 2, 3, 12, 128, 128
    pk, pv = _pools(g, cuda, torch.bfloat16, b=b, kvn=OSS_KVN, ps=ps,
                    d=OSS_D, mp=r + 2)
    poison = torch.arange(b * r, b * r + 4, device=cuda)
    pk[:, poison] = float("nan")
    pv[:, poison] = float("nan")
    ring = (torch.arange(b, device=cuda)[:, None] * r
            + torch.arange(mp, device=cuda)[None] % r).to(torch.int32)
    lens = torch.tensor([700, 1291], dtype=torch.int32, device=cuda)
    dirty = ring.clone()
    for i in range(b):
        below = (torch.arange(mp, device=cuda) + 1) * ps <= (
            int(lens[i]) - window)
        dirty[i, below] = poison[torch.arange(int(below.sum()),
                                              device=cuda) % 4].to(
            torch.int32)
    q = torch.randn((b, OSS_N, OSS_D), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    sinks = _oss_sinks(g, cuda, False)
    clean = pd.paged_flash_decode(q, pk, pv, ring, lens, 1, window=window,
                                  sinks=sinks)
    got = pd.paged_flash_decode(q, pk, pv, dirty, lens, 1, window=window,
                                sinks=sinks)
    assert bool(torch.isfinite(clean).all()) and torch.equal(got, clean)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 128], ids=["8s", "8ws"])
@pytest.mark.parametrize("sq,above", [(256, False), (64, True), (37, True)],
                         ids=["chunk", "split-above", "ragged-above"])
def test_paged_flash_prefill_sinks(cuda, dtype, window, sq, above):
    # gpt-oss-20b's 256-row chunks, 64 rows at offset 4096 (the key walk
    # split over blocks), ragged offsets, an unmapped page inside kv_len,
    # a padding row
    g = torch.Generator(device=cuda).manual_seed(67 + sq + (window or 0))
    ps = 128
    b, mp = 4, -(-(sq + 4200) // ps)
    pk, pv = _pools(g, cuda, dtype, b=b, kvn=OSS_KVN, ps=ps, d=OSS_D, mp=mp)
    q = torch.randn((b, sq, OSS_N, OSS_D), generator=g, device=cuda,
                    dtype=dtype)
    tables = torch.randperm(b * mp, generator=g, device=cuda).to(
        torch.int32).reshape(b, mp)
    offs = torch.tensor([4096, 37, 512, 0], dtype=torch.int32, device=cuda)
    kv = offs + torch.tensor([sq, max(sq - 5, 1), sq, 1], dtype=torch.int32,
                             device=cuda)
    tables[2, 1] = -1
    tables[3] = -1
    sinks = _oss_sinks(g, cuda, above)
    form = (pp.paged_flash_prefill_window if window
            else pp.paged_flash_prefill)
    before = form.launches, fp.SINK_LAUNCHES.get((form.__name__, OSS_D), 0)
    got = pp.paged_flash_prefill(q, pk, pv, tables, kv, offs, 1,
                                 window=window, sinks=sinks)
    assert (form.launches, fp.SINK_LAUNCHES[form.__name__, OSS_D]) == (
        before[0] + 1, before[1] + 1)
    want = pp.paged_flash_prefill_ref(q, pk, pv, tables, kv, offs, 1,
                                      window=window, sinks=sinks)
    assert bool(torch.isfinite(got).all())
    assert _attn_ok(got, want)
    one = pp.paged_flash_prefill(q[:1], pk, pv, tables[:1], kv[:1],
                                 offs[:1], 1, window=window, sinks=sinks)
    assert _attn_ok(one, want[:1])


def test_sink_forms_outside_the_slice_raise(cuda):
    # sinks at head_dim 256 (float and INT8 pools) raise; over INT8 pools
    # (4qs, 4vqs) and e4m3 pools (4es, 4ves), on verify rows and on the
    # dense arena they run (the tests above and below)
    g = torch.Generator(device=cuda).manual_seed(68)
    pk, pv = _pools(g, cuda, torch.bfloat16, b=2, kvn=OSS_KVN, d=OSS_D)
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=cuda)
    kv = torch.tensor([5, 9], dtype=torch.int32, device=cuda)
    q3 = torch.randn((2, 3, OSS_N, OSS_D), generator=g, device=cuda,
                     dtype=torch.bfloat16)
    sinks = torch.zeros(OSS_N, device=cuda)
    qk, ks = pa.quantize_kv(pk.float())
    qv, vs = pa.quantize_kv(pv.float())
    for form, call in (
            ("paged_flash_decode_int8kv",
             lambda: pd.paged_flash_decode(q3[:, 0], qk, qv, tables, kv, 0,
                                           k_scale=ks, v_scale=vs,
                                           sinks=sinks)),
            ("paged_flash_verify_int8kv",
             lambda: pd.paged_flash_verify(q3, qk, qv, tables, kv, 0,
                                           k_scale=ks, v_scale=vs,
                                           sinks=sinks))):
        n = fp.SINK_LAUNCHES.get((form, OSS_D), 0)
        out = call()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all()), form
        assert fp.SINK_LAUNCHES[form, OSS_D] == n + 1, form
    ek, ev = ref_ops.to_e4m3(pk.float()), ref_ops.to_e4m3(pv.float())
    for form, call in (
            ("paged_flash_decode_fp8kv",
             lambda: pd.paged_flash_decode(q3[:, 0], ek, ev, tables, kv, 0,
                                           sinks=sinks)),
            ("paged_flash_verify_fp8kv",
             lambda: pd.paged_flash_verify(q3, ek, ev, tables, kv, 0,
                                           sinks=sinks))):
        n = fp.SINK_LAUNCHES.get((form, OSS_D), 0)
        out = call()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(out).all()), form
        assert fp.SINK_LAUNCHES[form, OSS_D] == n + 1, form
    from simplellminference_tpu_torch.ops.attention import flash_decode as fd
    p256 = torch.zeros((2, 5, OSS_KVN, 16, 256), device=cuda,
                       dtype=torch.bfloat16)
    q256 = torch.zeros((2, 3, OSS_N, 256), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="head_dim 256"):
        pd.paged_flash_verify(q256, p256, p256, tables, kv, 0, sinks=sinks)
    with pytest.raises(NotImplementedError, match="head_dim 256"):
        fd.flash_decode(q256[:, 0], p256[:, :2], p256[:, :2], kv, layer=0,
                        sinks=sinks)
    c256, s256 = pa.quantize_kv(p256.float())
    with pytest.raises(NotImplementedError, match="head_dim 256"):
        pd.paged_flash_decode(q256[:, 0], c256, c256, tables, kv, 0,
                              k_scale=s256, v_scale=s256, sinks=sinks)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 128, 70],
                         ids=["4vs", "4vws", "4vws-70"])
@pytest.mark.parametrize("above", [False, True], ids=["n01", "above"])
def test_paged_flash_verify_sinks(cuda, dtype, window, above):
    # gpt-oss-20b's verify step: 64 q heads over 8 kv heads x 5 rows = 40
    # rows, two row blocks a kv head; kv_len 0, 1, 5, the window's edges
    # and 4096 (the key walk split over blocks); a dead slot
    g = torch.Generator(device=cuda).manual_seed(71 + (window or 0) + above)
    lens = [0, 1, 5, 132, 133, 4096, 4100, 3]
    b, s, ps, mp = len(lens), 5, 128, 33
    pk, pv = _pools(g, cuda, dtype, b=b, kvn=OSS_KVN, ps=ps, d=OSS_D, mp=mp)
    q = torch.randn((b, s, OSS_N, OSS_D), generator=g, device=cuda,
                    dtype=dtype)
    tables = torch.randperm(b * mp, generator=g, device=cuda).to(
        torch.int32).reshape(b, mp)
    tables[-1] = -1
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    sinks = _oss_sinks(g, cuda, above)
    assert pd.row_blocks((OSS_N // OSS_KVN) * s) == 2
    span = mp * ps if not window else window + s - 1
    assert window or pd.decode_splits(b, OSS_KVN, span, 2) > 1
    form = pd.paged_flash_verify_window if window else pd.paged_flash_verify
    before = form.launches, fp.SINK_LAUNCHES.get((form.__name__, OSS_D), 0)
    got = pd.paged_flash_verify(q, pk, pv, tables, kv, 1, window=window,
                                sinks=sinks)
    assert (form.launches, fp.SINK_LAUNCHES[form.__name__, OSS_D]) == (
        before[0] + 1, before[1] + 1)
    want = pd.paged_flash_verify_ref(q, pk, pv, tables, kv, 1,
                                     window=window, sinks=sinks)
    assert bool(torch.isfinite(got).all()) and _close(got, want, dtype)
    assert not got[0].any() and not got[1, :4].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 128], ids=["13s", "13ws"])
@pytest.mark.parametrize("above", [False, True], ids=["n01", "above"])
def test_flash_decode_sinks(cuda, dtype, window, above):
    # gpt-oss-20b's decode on the dense arena (a stacked arena with a
    # spare row): kv_len 0, 1, the window's edges, 4096 (the key walk
    # split over blocks) and the whole arena
    from simplellminference_tpu_torch.ops.attention import flash_decode as fd
    g = torch.Generator(device=cuda).manual_seed(72 + (window or 0) + above)
    smax = 4224
    lens = [0, 1, 128, 129, 300, 4096, smax, 17]
    b = len(lens)
    shape = (2, b + 1, OSS_KVN, smax, OSS_D)
    ck = torch.randn(shape, generator=g, device=cuda, dtype=dtype)
    cv = torch.randn(shape, generator=g, device=cuda, dtype=dtype)
    q = torch.randn((b, OSS_N, OSS_D), generator=g, device=cuda,
                    dtype=dtype)
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    sinks = _oss_sinks(g, cuda, above)
    assert window or pd.decode_splits(b, OSS_KVN, smax) > 1
    form = fd.flash_decode_window if window else fd.flash_decode
    before = form.launches, fp.SINK_LAUNCHES.get((form.__name__, OSS_D), 0)
    got = fd.flash_decode(q, ck, cv, kv, layer=1, window=window,
                          sinks=sinks)
    assert (form.launches, fp.SINK_LAUNCHES[form.__name__, OSS_D]) == (
        before[0] + 1, before[1] + 1)
    want = fd.flash_decode_ref(q, ck, cv, kv, layer=1, window=window,
                               sinks=sinks)
    assert bool(torch.isfinite(got).all()) and _close(got, want, dtype)
    assert not got[0].any()


# a gpt-oss-shaped model (openai/gpt-oss-20b's config.json) cut to 2 layers
# and narrow widths, keeping its attention (64 q heads over 8 kv heads of
# 64, sinks, biases, yarn) and its 32 experts with top 4
OSS_HF = dict(
    model_type="gpt_oss", vocab_size=512, hidden_size=256,
    intermediate_size=128, num_hidden_layers=2, num_attention_heads=64,
    num_key_value_heads=8, head_dim=64, num_local_experts=32,
    num_experts_per_tok=4, experts_per_token=4, tie_word_embeddings=False,
    attention_bias=True, sliding_window=32, rope_theta=150000.0,
    rope_scaling={"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
                  "beta_slow": 1.0, "original_max_position_embeddings": 4096,
                  "truncate": False},
    max_position_embeddings=131072, rms_norm_eps=1e-5, swiglu_limit=7.0,
    hidden_act="silu", initial_context_length=4096,
    layer_types=["sliding_attention", "full_attention"])


def test_gpt_oss_verify_step_graph_replay(cuda):
    """A gpt-oss verify step of the spec engine (8 sequences x 5 rows: 4vs
    on the full layer, 4vws over the ring pools, the MoE on verify rows
    padded to T = 40 with no host read) runs eagerly under sync debug mode
    "error" and is captured in a CUDA graph (a host read breaks the
    capture); the replay gives the eager call's logits."""
    from simplellminference_tpu_torch.ops import moe
    cfg = ModelConfig.from_hf_dict(OSS_HF, dtype="bfloat16")
    params = llama.init_params(cfg, seed=5, device=cuda)
    b, s, mp, ps = 8, 5, 8, 16
    eng = Engine(cfg, params, EngineConfig(
        max_batch_size=b, spec_tokens=s - 1,
        kv=KVCacheConfig(page_size=ps, num_pages=b * mp + 8,
                         max_pages_per_seq=mp)), device=cuda)
    assert eng._grouped and moe.pads_to_tokens(b * s, 32, 4)
    tables = (torch.arange(b * mp, dtype=torch.int32,
                           device=cuda).reshape(b, mp), eng._ring_table(mp))
    g = torch.Generator(device=cuda).manual_seed(73)
    tok = torch.randint(1, cfg.vocab_size, (b, s), generator=g, device=cuda,
                        dtype=torch.int32)
    ctx = torch.tensor([40, 41, 60, 77, 90, 33, 100, 120], device=cuda,
                       dtype=torch.int32)
    pos = (ctx[:, None] - s + torch.arange(s, device=cuda,
                                           dtype=torch.int32)[None])

    def step():
        return llama.forward_paged(cfg, params, tok, pos, eng.cache, tables,
                                   ctx, prefill=False)[0]

    counts = (pd.paged_flash_verify.launches,
              pd.paged_flash_verify_window.launches)
    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (pd.paged_flash_verify.launches,
            pd.paged_flash_verify_window.launches) == (counts[0] + 2,
                                                       counts[1] + 2)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    graph.replay()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(eager).all())
    scale = float(eager.float().abs().max())
    assert float((out.float() - eager.float()).abs().max()) <= 1e-2 * scale


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("skew", [False, True], ids=["padded", "per-expert"])
def test_moe_grouped_prefill_on_the_card(cuda, dtype, skew):
    """The grouped MoE prefill on the card, both of its forms: a random
    router (one padded batched product) and a router bias that sends
    every token to experts 2 and 0 of 8 (one product per expert), each
    against the same function on the CPU in f32 from the same weights."""
    from simplellminference_tpu_torch.ops import moe
    cfg = ModelConfig.tiny_test(
        dtype="float32", hidden_size=256, intermediate_size=128,
        num_layers=1, num_heads=4, num_kv_heads=2, head_dim=64,
        num_experts=8, num_experts_per_tok=2, moe_intermediate_size=128,
        hidden_act="swiglu_oss", moe_bias=True)
    lw = llama.init_params(cfg, seed=3, device="cpu")["layers"]
    if skew:
        lw["router_bias"] = torch.zeros((1, 8))
        lw["router_bias"][:, 2], lw["router_bias"][:, 0] = 60.0, 40.0
    lw = {k: v.to(dtype).float() for k, v in lw.items()}
    x = torch.randn((3, 40, 256), generator=torch.Generator().manual_seed(4))
    x = x.to(dtype).float()
    want = moe.moe_ffn_grouped(cfg, lw, 0, x)
    got = moe.moe_ffn_grouped(cfg, {k: v.to(cuda, dtype) for k, v in
                                    lw.items()}, 0, x.to(cuda, dtype))
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    err = float((got.float().cpu() - want).abs().max())
    tol = (1e-5 if dtype == torch.float32 else 2e-2) * float(
        want.abs().max())
    assert err <= tol, (err, tol)


# --------------- INT8 KV with sinks, the soft cap, and at head_dim 256
# gpt-oss-20b over INT8 KV (4qs, 4qws, 4vqs, 4vqws, 8qs, 8qws at D 64),
# Gemma-2 over INT8 KV (4qc, 4qwc, 4vqc, 4vqwc, 8qc, 8qwc at D 128 and
# 256), Gemma-1 over INT8 KV (4q, 4vq, 8q at D 256), the quantizing writes
# (9, 10) and the quantizing fused qkv (6q) at D 256. Pools quantized from
# N(0, 1) rows (scales near 0.02, far from 1); q x SCORE_X passes the cap.

INT8_CASES = {  # name: (n, kvn, d, cap, sink kind)
    "4qs": (OSS_N, OSS_KVN, OSS_D, None, "n01"),
    "4qs-above": (OSS_N, OSS_KVN, OSS_D, None, "above"),
    "4qc-d128": (32, 8, 128, G2_CAP, None),
    "4qc-d256": (G2_N, G2_KVN, 256, G2_CAP, None),
    "4q-d256": (G_N, G_KVN, 256, None, None),
}


def _int8_opts(g, dev, n, cap, sink):
    sinks = None if sink is None else _oss_sinks(g, dev, sink == "above")
    return dict(logit_cap=cap, sinks=sinks)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 70], ids=["plain", "window"])
@pytest.mark.parametrize("case", list(INT8_CASES))
def test_paged_flash_decode_int8kv_options(cuda, dtype, window, case):
    # kv_len 0, 1, a tile edge, the window's edges and 4096 (the key walk
    # split over blocks: a sink seeded in every split would count several
    # times); a dead slot; the window over ring tables whose columns below
    # the band point at pages with NaN scales
    n, kvn, d, cap, sink = INT8_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(list(INT8_CASES).index(case) + 3)
    lens = [0, 1, 64, 70, 71, 4096, 300, 3]
    b, ps = len(lens), 128
    mp = 4096 // ps
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q = torch.randn((b, n, d), generator=g, device=cuda, dtype=dtype)
    if cap:
        q = q * 30.0                          # scores past the cap
    opts = _int8_opts(g, cuda, n, cap, sink)
    if window:
        r = (window + 128 - 2) // ps + 2
        (pk, pv, ks, vs), ring = _ring_case(g, cuda, dtype, True, b, r,
                                            mp, kvn, d, ps)
        clean = ring
        dirty = _poisoned(ring, kv - window, ps, b * r)
    else:
        pk, pv, ks, vs = _quant_pools(g, cuda, b=b, kvn=kvn, ps=ps, d=d,
                                      mp=mp)
        clean = torch.randperm(b * mp, generator=g, device=cuda).to(
            torch.int32).reshape(b, mp)
        clean[-1] = -1
        dirty = clean
    form = (pd.paged_flash_decode_int8kv_window if window
            else pd.paged_flash_decode_int8kv)
    before = form.launches
    got = pd.paged_flash_decode(q, pk, pv, dirty, kv, 1, k_scale=ks,
                                v_scale=vs, window=window, **opts)
    assert form.launches == before + 1
    want = pd.paged_flash_decode_ref(q, pk, pv, clean, kv, 1, k_scale=ks,
                                     v_scale=vs, window=window, **opts)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    assert _close(got, want, dtype)
    assert not got[0].any()
    assert window or pd.decode_splits(b, kvn, mp * ps) > 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 70], ids=["plain", "window"])
@pytest.mark.parametrize("case", ["4vqs", "4vqs-above", "4vqc-d256",
                                  "4vq-d256-group8"])
def test_paged_flash_verify_int8kv_options(cuda, dtype, window, case):
    # S 5: gpt-oss-20b's group of 8 (40 rows, two row blocks), Gemma-2's
    # group of 2 capped at D 256, Gemma-1's group of 8 at D 256 (two row
    # blocks); kv_len 0, 1, 5, 4096 (split walks); a dead slot
    n, kvn, d, cap, sink = {
        "4vqs": (OSS_N, OSS_KVN, OSS_D, None, "n01"),
        "4vqs-above": (OSS_N, OSS_KVN, OSS_D, None, "above"),
        "4vqc-d256": (G2_N, G2_KVN, 256, G2_CAP, None),
        "4vq-d256-group8": (G_N, G_KVN, 256, None, None)}[case]
    g = torch.Generator(device=cuda).manual_seed(len(case) + 5)
    lens = [0, 1, 5, 132, 4096, 3]
    b, s, ps = len(lens), 5, 128
    mp = 4096 // ps
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q = torch.randn((b, s, n, d), generator=g, device=cuda, dtype=dtype)
    if cap:
        q = q * 30.0
    opts = _int8_opts(g, cuda, n, cap, sink)
    pk, pv, ks, vs = _quant_pools(g, cuda, b=b, kvn=kvn, ps=ps, d=d, mp=mp)
    tables = torch.randperm(b * mp, generator=g, device=cuda).to(
        torch.int32).reshape(b, mp)
    tables[-1] = -1
    form = (pd.paged_flash_verify_int8kv_window if window
            else pd.paged_flash_verify_int8kv)
    before = form.launches
    got = pd.paged_flash_verify(q, pk, pv, tables, kv, 1, k_scale=ks,
                                v_scale=vs, window=window, **opts)
    assert form.launches == before + 1
    want = pd.paged_flash_verify_ref(q, pk, pv, tables, kv, 1, k_scale=ks,
                                     v_scale=vs, window=window, **opts)
    assert bool(torch.isfinite(got).all())
    for i, ln in enumerate(lens):
        live = [r for r in range(s) if ln - s + r >= 0]
        if live:
            assert _close(got[i, live], want[i, live], dtype)
        assert not got[i, [r for r in range(s) if r not in live]].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 100], ids=["plain", "window"])
@pytest.mark.parametrize("case", ["8qs", "8qs-above", "8qc-d128",
                                  "8qc-d256", "8q-d256"])
def test_paged_flash_prefill_int8kv_options(cuda, dtype, window, case):
    # a 256-row chunk at offset 256, 64 rows at offset 4096 (bf16: the key
    # walk split over blocks), a ragged row and a padding row (-1 table,
    # kv_len 1)
    n, kvn, d, cap, sink = {
        "8qs": (OSS_N, OSS_KVN, OSS_D, None, "n01"),
        "8qs-above": (OSS_N, OSS_KVN, OSS_D, None, "above"),
        "8qc-d128": (32, 8, 128, G2_CAP, None),
        "8qc-d256": (G2_N, G2_KVN, 256, G2_CAP, None),
        "8q-d256": (G_N, G_KVN, 256, None, None)}[case]
    g = torch.Generator(device=cuda).manual_seed(len(case) + 7)
    ps = 128
    for sq, offs, lens in ((256, [256], [512]),
                           (64, [4096, 0, 0], [4160, 37, 1])):
        b = len(offs)
        mp = -(-max(o + sq for o in offs) // ps)
        pk, pv, ks, vs = _quant_pools(g, cuda, b=b, kvn=kvn, ps=ps, d=d,
                                      mp=mp)
        tables = torch.randperm(b * mp, generator=g, device=cuda).to(
            torch.int32).reshape(b, mp)
        if b > 2:
            tables[2] = -1
        off_t = torch.tensor(offs, dtype=torch.int32, device=cuda)
        kv_t = torch.tensor(lens, dtype=torch.int32, device=cuda)
        q = torch.randn((b, sq, n, d), generator=g, device=cuda, dtype=dtype)
        if cap:
            q = q * 30.0
        opts = _int8_opts(g, cuda, n, cap, sink)
        form = (pp.paged_flash_prefill_int8kv_window if window
                else pp.paged_flash_prefill_int8kv)
        before = form.launches
        got = pp.paged_flash_prefill(q, pk, pv, tables, kv_t, off_t, 1,
                                     window=window, k_scale=ks, v_scale=vs,
                                     **opts)
        assert form.launches == before + 1
        want = pp.paged_flash_prefill_ref(q, pk, pv, tables, kv_t, off_t, 1,
                                          window=window, k_scale=ks,
                                          v_scale=vs, **opts)
        assert bool(torch.isfinite(got).all())
        for i in range(b):
            valid = max(0, min(sq, lens[i] - offs[i]))
            assert _attn_ok(got[i, :valid], want[i, :valid]), (sq, i)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [128, 100, 1])
def test_paged_append_quant_head_dim_256(cuda, dtype, s):
    # kernels 9 and 10 at D 256 (8 values a lane): byte-equal to their
    # plain versions, counted in paged_append.D256_LAUNCHES
    g = torch.Generator(device=cuda).manual_seed(900 + s)
    pools = _quant_pools(g, cuda, kvn=G2_KVN, d=256)
    big = torch.randn((3, s, 3 * G2_KVN * 256), generator=g, device=cuda,
                      dtype=dtype) * 3
    nk = big[..., :G2_KVN * 256].reshape(3, s, G2_KVN, 256)
    nv = big[..., 2 * G2_KVN * 256:].reshape(3, s, G2_KVN, 256)
    pos = torch.tensor([130, 7, 3], dtype=torch.int32, device=cuda)
    for name, kern, ref, args in (
            ("paged_append_prefill_quant", pa.paged_append_prefill_quant,
             pa.paged_append_prefill_quant_ref, (nk, nv, _tables(cuda), 1)),
            ("paged_append_decode_quant", pa.paged_append_decode_quant,
             pa.paged_append_decode_quant_ref,
             (nk[:, 0], nv[:, 0], _tables(cuda), pos, 0))):
        a, r = [p.clone() for p in pools], [p.clone() for p in pools]
        before = (kern.launches, pa.D256_LAUNCHES[name])
        kern(*a, *args)
        assert (kern.launches, pa.D256_LAUNCHES[name]) == (before[0] + 1,
                                                           before[1] + 1)
        ref(*r, *args)
        for x, y in zip(a, r):
            assert torch.equal(x[:, :-1], y[:, :-1]), name


def _qkv_int8kv_256(g, cuda, xdt, n, kvn, b, h=2048, kv_layer=None):
    """Kernel 6q at head_dim 256 (Gemma's widths: H 2048, n heads over kvn
    kv heads of 256): the call and its plain version's result on copies
    of the same INT8 pools, and the rows it writes."""
    d, L, ps, mp = 256, 2, 128, 6
    pos = torch.tensor([5, 127, 128, 40, 300, 3, 255, 600][:b],
                       dtype=torch.int32, device=cuda)
    tables = torch.arange(b * mp, dtype=torch.int32,
                          device=cuda).reshape(b, mp)
    tables[b - 1, pos[b - 1] // ps] = -1       # the trash page
    nq = (n + 2 * kvn) * d
    wq, ws = _qw(g, cuda, (L, h, nq), 1)
    nw = torch.rand((L, h), generator=g, device=cuda).to(xdt) + 0.5
    x = torch.randn((b, h), generator=g, device=cuda).to(xdt)
    sin, cos = ref_ops.rope_tables(pos, d, 10000.0)
    pools = _quant_pools(g, cuda, b=b, kvn=kvn, ps=ps, d=d, mp=mp)
    kw = dict(n_heads=n, kv_heads=kvn, tables=tables, kv_layer=kv_layer)
    kli = 1 if kv_layer is None else kv_layer
    written = torch.zeros(pools[2].shape, dtype=torch.bool, device=cuda)
    for i, p in enumerate(pos.tolist()):
        page = int(tables[i, p // ps])
        written[kli, page if page >= 0 else pools[2].shape[1] - 1, :,
                p % ps] = True

    def call(p):
        return qf.fused_qkv_append(x, nw, wq, ws, sin, cos, p[0], p[1], 1,
                                   pos, cache_ks=p[2], cache_vs=p[3], **kw)[0]

    r = [p.clone() for p in pools]
    qr = qf.fused_qkv_append_ref(x, nw, wq, ws, sin, cos, r[0], r[1], 1, pos,
                                 cache_ks=r[2], cache_vs=r[3], **kw)[0]
    return pools, call, qr, r, written


@pytest.mark.parametrize("xdt", DTYPES)
@pytest.mark.parametrize("n,kvn,b", [(G_N, G_KVN, 8), (G2_N, G2_KVN, 3)],
                         ids=["gemma", "gemma2"])
@pytest.mark.parametrize("kv_layer", [None, 0], ids=["6q", "6q-kv_layer"])
def test_fused_qkv_append_int8kv_head_dim_256(cuda, xdt, n, kvn, b,
                                              kv_layer):
    # 6q/256: bf16 rows on 6m, f32 rows on the FMA kernel; a head's columns
    # lie in two blocks, whose rounded halves a further launch quantizes:
    # codes at most one apart, scales within 1e-5 (f32) or one bf16 ulp of
    # the absmax (bf16), q as the fused qkv's rule, every other entry equal
    g = torch.Generator(device=cuda).manual_seed(256 * b + (kv_layer or 0))
    pools, call, qr, r, written = _qkv_int8kv_256(g, cuda, xdt, n, kvn, b,
                                                  kv_layer=kv_layer)
    a = [p.clone() for p in pools]
    nq = (n + 2 * kvn) * 256
    before = (qf.fused_qkv_append_int8kv.launches,
              dict(qf.D256_FORM_LAUNCHES))
    with _one_launch(qf.QKV_REGIME_LAUNCHES,
                     qf.qkv_regime(b, 2048, nq, 256, xdt)):
        qa = call(a)
    assert qf.fused_qkv_append_int8kv.launches == before[0] + 1
    assert qf.D256_FORM_LAUNCHES["fused_qkv_append_int8kv"] == before[1][
        "fused_qkv_append_int8kv"] + 1
    assert qf.D256_FORM_LAUNCHES["fused_qkv_append_int8kv_kv_layer"] == (
        before[1]["fused_qkv_append_int8kv_kv_layer"] + (kv_layer is not None))
    tol = 1e-5 if xdt == torch.float32 else 2e-2
    assert float((qa.float() - qr.float()).abs().max()) <= tol * float(
        qr.float().std())
    for x_a, x_r in zip(a[:2], r[:2]):
        assert torch.equal(x_a[~written], x_r[~written])
        assert int((x_a[written].int() - x_r[written].int()).abs().max()) <= 1
    for s_a, s_r in zip(a[2:], r[2:]):
        assert torch.equal(s_a[~written], s_r[~written])
        if xdt == torch.float32:
            lim = 1e-5 * s_r[written]
        else:
            lim = _bf16_ulp(s_r[written] * 127.0) / 127.0 * (1 + 1e-6)
        assert bool(((s_a[written] - s_r[written]).abs() <= lim).all())


@pytest.mark.parametrize("kv_layer", [None, 0], ids=["6q", "6q-kv_layer"])
def test_fused_qkv_append_int8kv_head_dim_256_graph_replay(cuda, kv_layer):
    # 6q/256 at Gemma-2B's widths, 8 bf16 rows (6m's K split: arrival
    # counters, then the quantizing launch): replays of a captured call
    # and eager calls between them give the eager output bit for bit
    g = torch.Generator(device=cuda).manual_seed(77 + (kv_layer or 0))
    pools, call, _qr, _r, _w = _qkv_int8kv_256(g, cuda, torch.bfloat16,
                                               G_N, G_KVN, 8,
                                               kv_layer=kv_layer)
    assert qf.qkv_split(8, 2048, (G_N + 2 * G_KVN) * 2) < 2048

    def step():
        return (call(pools), *(p.clone() for p in pools))
    eager = step()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, e) for o, e in zip(out, eager))
        assert all(torch.equal(o, e) for o, e in zip(step(), eager))


# ---------- FP8 KV with sinks and sliding windows (head_dim 32-128)
# gpt-oss-20b over FP8 KV (4es, 4ews, 4ves, 4vews, 8es, 8ews at D 64) and
# Mistral-7B's window over FP8 KV (4ew, 4vew, 8ew at D 128; 6ek, the fused
# qkv writing e4m3 ring pools at a kv_layer). e4m3 pools of N(0, 1) rows;
# the window cases over ring tables whose columns below the band point at
# pages of code 0x7f (NaN in e4m3fn): the output equals the clean
# tables', so no form read them.

FP8_CASES = {  # name: (n, kvn, d, sink kind)
    "oss-sinks": (OSS_N, OSS_KVN, OSS_D, "n01"),
    "oss-sinks-above": (OSS_N, OSS_KVN, OSS_D, "above"),
    "mistral": (32, 8, 128, None),
}


def _e4m3_ring(g, dev, b, r, mp, kvn, d, ps):
    """e4m3 ring pools (b slots x r pages, 4 pages of NaN codes, the trash
    page) and the ring tables (column j of slot s -> s*r + j % r)."""
    shape = (2, b * r + 5, kvn, ps, d)
    pools = [ref_ops.to_e4m3(torch.randn(shape, generator=g, device=dev))
             for _ in range(2)]
    for p in pools:
        p.view(torch.uint8)[:, b * r:b * r + 4] = 0x7F
    ring = (torch.arange(b, device=dev)[:, None] * r
            + torch.arange(mp, device=dev)[None] % r).to(torch.int32)
    return pools, ring


def _fp8_tables(g, dev, kind, b, rows, window, kv, mp, kvn, d, ps):
    """(pools, clean tables, poisoned tables) of a case: ring pools with
    NaN pages below each row's band with a window, else e4m3 pools with a
    permuted table whose last row is dead."""
    if window:
        r = (window + max(rows, 128) - 2) // ps + 2
        pools, ring = _e4m3_ring(g, dev, len(kv), r, mp, kvn, d, ps)
        k_lo = (kv - window + 1) if kind == "prefill" else (
            kv - rows - window + 1)
        return pools, ring, _poisoned(ring, k_lo, ps, len(kv) * r)
    pools = _e4m3_pools(g, dev, b=b, kvn=kvn, ps=ps, d=d, mp=mp)
    tables = torch.randperm(b * mp, generator=g, device=dev).to(
        torch.int32).reshape(b, mp)
    tables[-1] = -1
    return pools, tables, tables


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 128, 70],
                         ids=["plain", "window", "window-70"])
@pytest.mark.parametrize("case", list(FP8_CASES))
def test_paged_flash_decode_fp8kv_options(cuda, dtype, window, case):
    # 4es/4ews (and 4ew at D 128): kv_len 0, 1, a tile edge, the window's
    # edges and 4096 (a split walk: a sink seeded in every split would
    # count several times); a dead slot
    n, kvn, d, sink = FP8_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(
        list(FP8_CASES).index(case) + 31)
    lens = [0, 1, 64, 70, 71, 4096, 300, 3]
    b, ps = len(lens), 128
    mp = 4096 // ps
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q = torch.randn((b, n, d), generator=g, device=cuda, dtype=dtype)
    sinks = None if sink is None else _oss_sinks(g, cuda, sink == "above")
    (pk, pv), clean, dirty = _fp8_tables(g, cuda, "decode", b, 1, window,
                                         kv, mp, kvn, d, ps)
    form = (pd.paged_flash_decode_fp8kv_window if window
            else pd.paged_flash_decode_fp8kv)
    before = (form.launches, fp.SINK_LAUNCHES.get((form.__name__, d), 0))
    got = pd.paged_flash_decode(q, pk, pv, dirty, kv, 1, window=window,
                                sinks=sinks)
    assert (form.launches, fp.SINK_LAUNCHES.get((form.__name__, d), 0)) == (
        before[0] + 1, before[1] + (sinks is not None))
    want = pd.paged_flash_decode_ref(q, pk, pv, clean, kv, 1, window=window,
                                     sinks=sinks)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    assert _close(got, want, dtype)
    assert not got[0].any()
    if window:
        assert torch.equal(got, pd.paged_flash_decode(
            q, pk, pv, clean, kv, 1, window=window, sinks=sinks))
    else:
        assert pd.decode_splits(b, kvn, mp * ps) > 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 128, 70],
                         ids=["plain", "window", "window-70"])
@pytest.mark.parametrize("case", list(FP8_CASES))
def test_paged_flash_verify_fp8kv_options(cuda, dtype, window, case):
    # 4ves/4vews (and 4vew at D 128), S 5: gpt-oss-20b's group of 8 x 5
    # rows takes two row blocks, each block's split 0 seeding its rows;
    # kv_len 0, 1, 5, 132 and 4096 (split walks); a dead slot
    n, kvn, d, sink = FP8_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(
        list(FP8_CASES).index(case) + 41)
    lens = [0, 1, 5, 132, 4096, 3]
    b, s, ps = len(lens), 5, 128
    mp = 4096 // ps
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q = torch.randn((b, s, n, d), generator=g, device=cuda, dtype=dtype)
    sinks = None if sink is None else _oss_sinks(g, cuda, sink == "above")
    (pk, pv), clean, dirty = _fp8_tables(g, cuda, "verify", b, s, window,
                                         kv, mp, kvn, d, ps)
    form = (pd.paged_flash_verify_fp8kv_window if window
            else pd.paged_flash_verify_fp8kv)
    before = form.launches
    got = pd.paged_flash_verify(q, pk, pv, dirty, kv, 1, window=window,
                                sinks=sinks)
    assert form.launches == before + 1
    want = pd.paged_flash_verify_ref(q, pk, pv, clean, kv, 1, window=window,
                                     sinks=sinks)
    assert bool(torch.isfinite(got).all())
    for i, ln in enumerate(lens):
        live = [r for r in range(s) if ln - s + r >= 0]
        if live:
            assert _close(got[i, live], want[i, live], dtype)
        assert not got[i, [r for r in range(s) if r not in live]].any()
    if sink is not None:
        assert pd.row_blocks((n // kvn) * s) == 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 128, 100],
                         ids=["plain", "window", "window-100"])
@pytest.mark.parametrize("case", list(FP8_CASES))
def test_paged_flash_prefill_fp8kv_options(cuda, dtype, window, case):
    # 8es/8ews (and 8ew at D 128): a 256-row chunk at offset 256, 64 rows
    # at offset 4096 (bf16: a split key walk) with a ragged row and a
    # padding row (-1 table, kv_len 1)
    n, kvn, d, sink = FP8_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(
        list(FP8_CASES).index(case) + 51)
    ps = 128
    for sq, offs, lens in ((256, [256], [512]),
                           (64, [4096, 0, 0], [4160, 37, 1])):
        b = len(offs)
        mp = -(-max(o + sq for o in offs) // ps)
        off_t = torch.tensor(offs, dtype=torch.int32, device=cuda)
        kv_t = torch.tensor(lens, dtype=torch.int32, device=cuda)
        (pk, pv), clean, dirty = _fp8_tables(g, cuda, "prefill", b, sq,
                                             window, off_t, mp, kvn, d, ps)
        if b > 2:
            clean[2] = -1
            dirty[2] = -1
        q = torch.randn((b, sq, n, d), generator=g, device=cuda, dtype=dtype)
        sinks = (None if sink is None
                 else _oss_sinks(g, cuda, sink == "above"))
        form = (pp.paged_flash_prefill_fp8kv_window if window
                else pp.paged_flash_prefill_fp8kv)
        before = form.launches
        got = pp.paged_flash_prefill(q, pk, pv, dirty, kv_t, off_t, 1,
                                     window=window, sinks=sinks)
        assert form.launches == before + 1
        want = pp.paged_flash_prefill_ref(q, pk, pv, clean, kv_t, off_t, 1,
                                          window=window, sinks=sinks)
        assert bool(torch.isfinite(got).all())
        for i in range(b):
            valid = max(0, min(sq, lens[i] - offs[i]))
            assert _attn_ok(got[i, :valid], want[i, :valid]), (sq, i)


@pytest.mark.parametrize("xdt", DTYPES)
def test_fused_qkv_append_fp8kv_kv_layer(cuda, xdt):
    # 6ek at Mistral-7B's widths (32 q heads over 8 of 128, H 4096; bf16
    # rows take 6m, f32 ones the FMA kernel): the weights of layer 1, the
    # rows written into e4m3 ring pools at kv_layer 0, codes at most one
    # step apart from the plain version's, every other byte equal
    g = torch.Generator(device=cuda).manual_seed(66)
    n, kvn, d, h, ps, b, r = 32, 8, 128, 4096, 128, 8, 3
    nq = (n + 2 * kvn) * d
    wq, ws = _qw(g, cuda, (2, h, nq), 1)
    ws = ws * 30                                    # k/v past 464 too
    nw = torch.rand((2, h), generator=g, device=cuda).to(xdt) + 0.5
    x = torch.randn((b, h), generator=g, device=cuda).to(xdt)
    pos = (4200 + 37 * torch.arange(b, device=cuda)).to(torch.int32)
    pools, ring = _e4m3_ring(g, cuda, b, r, 40, kvn, d, ps)
    sin, cos = ref_ops.rope_tables(pos, d, 10000.0)
    a, rf = [p.clone() for p in pools], [p.clone() for p in pools]
    before = (qf.fused_qkv_append_fp8kv.launches,
              qf.KV_LAYER_LAUNCHES["fused_qkv_append_fp8kv"],
              qf.fused_qkv_append_kv_layer.launches)
    qa, *_ = qf.fused_qkv_append(x, nw, wq, ws, sin, cos, a[0], a[1], 1,
                                 pos, n_heads=n, kv_heads=kvn, tables=ring,
                                 kv_layer=0)
    assert (qf.fused_qkv_append_fp8kv.launches,
            qf.KV_LAYER_LAUNCHES["fused_qkv_append_fp8kv"],
            qf.fused_qkv_append_kv_layer.launches) == (
        before[0] + 1, before[1] + 1, before[2])
    qr, *_ = qf.fused_qkv_append_ref(x, nw, wq, ws, sin, cos, rf[0], rf[1],
                                     1, pos, n_heads=n, kv_heads=kvn,
                                     tables=ring, kv_layer=0)
    tol = 1e-5 if xdt == torch.float32 else 2e-2
    assert float((qa.float() - qr.float()).abs().max()) <= tol * float(
        qr.float().std())
    written = torch.zeros(pools[0].shape, dtype=torch.bool, device=cuda)
    for i, p in enumerate(pos.tolist()):
        written[0, int(ring[i, p // ps]), :, p % ps] = True
    for x_a, x_r in zip(a, rf):
        assert _bytes_equal(x_a[~written], x_r[~written])
        assert int((_ordinal(x_a[written]) - _ordinal(x_r[written])).abs()
                   .max()) <= 1


# ---------------- Gemma over FP8 KV: the cap over e4m3 pools, D 256
# Gemma-2-2B (8 q heads over 4 kv heads of 256, cap 50, window 4096) and
# Gemma-1 (8 over one kv head of 256) over e4m3 pools: 4ec/4ewc, 4vec/
# 4vewc, 8ec/8ewc past the cap (q x 40), the uncapped e4m3 forms at D 256
# (4e, 4ew, 4ve, 4vew, 8e, 8ew /256), and D 128 capped; window cases over
# ring tables whose columns below the band point at pages of code 0x7f
# (NaN in e4m3fn); the writes 1e, 2e, 11e and the fused qkv 6e/6ek at
# D 256 byte for byte.

GEMMA_FP8 = {  # name: (n, kvn, d, cap)
    "gemma2": (G2_N, G2_KVN, 256, G2_CAP),
    "gemma": (G_N, G_KVN, G_D, None),
    "d128": (32, 8, 128, G2_CAP),
}


def _count(form, d, cap):
    """A form's launches, its D-256 launches and its capped ones at d."""
    counts = pp.D256_LAUNCHES if "prefill" in form else pd.D256_LAUNCHES
    return (counts[form], fp.CAP_LAUNCHES.get((form, d), 0)) if cap else (
        counts[form], 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 4096, 100],
                         ids=["plain", "window", "window-100"])
@pytest.mark.parametrize("case", list(GEMMA_FP8))
def test_paged_flash_decode_fp8kv_gemma(cuda, dtype, window, case):
    # 4ec/4ewc (D 256 and 128) and 4e/4ew at D 256: kv_len 0, 1, a tile
    # edge, the window-100 edges, 4096 and past the window (split walks);
    # a dead slot
    n, kvn, d, cap = GEMMA_FP8[case]
    g = torch.Generator(device=cuda).manual_seed(
        list(GEMMA_FP8).index(case) + 71)
    lens = [0, 1, 64, 100, 101, 4096, 4300, 3]
    b, ps = len(lens), 128
    mp = 4352 // ps
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q = torch.randn((b, n, d), generator=g, device=cuda, dtype=dtype) * (
        40.0 if cap else 1.0)
    (pk, pv), clean, dirty = _fp8_tables(g, cuda, "decode", b, 1, window,
                                         kv, mp, kvn, d, ps)
    form = ("paged_flash_decode_fp8kv_window" if window
            else "paged_flash_decode_fp8kv")
    before = (getattr(pd, form).launches, _count(form, d, cap))
    got = pd.paged_flash_decode(q, pk, pv, dirty, kv, 1, window=window,
                                logit_cap=cap)
    after = (getattr(pd, form).launches, _count(form, d, cap))
    assert after[0] == before[0] + 1
    assert after[1][0] == before[1][0] + (d == 256)
    assert after[1][1] == before[1][1] + bool(cap)
    want = pd.paged_flash_decode_ref(q, pk, pv, clean, kv, 1, window=window,
                                     logit_cap=cap)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    assert _close(got, want, dtype)
    assert not got[0].any()
    if window:
        assert torch.equal(got, pd.paged_flash_decode(
            q, pk, pv, clean, kv, 1, window=window, logit_cap=cap))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 4096, 100],
                         ids=["plain", "window", "window-100"])
@pytest.mark.parametrize("case", list(GEMMA_FP8))
def test_paged_flash_verify_fp8kv_gemma(cuda, dtype, window, case):
    # 4vec/4vewc and 4ve/4vew at D 256, S 5: Gemma-1's group of 8 x 5 rows
    # takes two row blocks; kv_len 0, 1, 5, 105, 4096 and past the window;
    # a dead slot
    n, kvn, d, cap = GEMMA_FP8[case]
    g = torch.Generator(device=cuda).manual_seed(
        list(GEMMA_FP8).index(case) + 81)
    lens = [0, 1, 5, 105, 4096, 4300, 3]
    b, s, ps = len(lens), 5, 128
    mp = 4352 // ps
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q = torch.randn((b, s, n, d), generator=g, device=cuda, dtype=dtype) * (
        40.0 if cap else 1.0)
    (pk, pv), clean, dirty = _fp8_tables(g, cuda, "verify", b, s, window,
                                         kv, mp, kvn, d, ps)
    form = ("paged_flash_verify_fp8kv_window" if window
            else "paged_flash_verify_fp8kv")
    before = (getattr(pd, form).launches, _count(form, d, cap))
    got = pd.paged_flash_verify(q, pk, pv, dirty, kv, 1, window=window,
                                logit_cap=cap)
    after = (getattr(pd, form).launches, _count(form, d, cap))
    assert after[0] == before[0] + 1
    assert after[1] == (before[1][0] + (d == 256), before[1][1] + bool(cap))
    want = pd.paged_flash_verify_ref(q, pk, pv, clean, kv, 1, window=window,
                                     logit_cap=cap)
    assert bool(torch.isfinite(got).all())
    for i, ln in enumerate(lens):
        live = [r for r in range(s) if ln - s + r >= 0]
        if live:
            assert _close(got[i, live], want[i, live], dtype)
        assert not got[i, [r for r in range(s) if r not in live]].any()
    if case == "gemma":
        assert pd.row_blocks((n // kvn) * s) == 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 4096, 100],
                         ids=["plain", "window", "window-100"])
@pytest.mark.parametrize("case", list(GEMMA_FP8))
def test_paged_flash_prefill_fp8kv_gemma(cuda, dtype, window, case):
    # 8ec/8ewc and 8e/8ew at D 256: a 256-row chunk at offset 256, 64 rows
    # at offset 4096 (bf16: a split key walk) with a ragged row and a
    # padding row (-1 table, kv_len 1)
    n, kvn, d, cap = GEMMA_FP8[case]
    g = torch.Generator(device=cuda).manual_seed(
        list(GEMMA_FP8).index(case) + 91)
    ps = 128
    form = ("paged_flash_prefill_fp8kv_window" if window
            else "paged_flash_prefill_fp8kv")
    for sq, offs, lens in ((256, [256], [512]),
                           (64, [4096, 0, 0], [4160, 37, 1])):
        b = len(offs)
        mp = -(-max(o + sq for o in offs) // ps)
        off_t = torch.tensor(offs, dtype=torch.int32, device=cuda)
        kv_t = torch.tensor(lens, dtype=torch.int32, device=cuda)
        (pk, pv), clean, dirty = _fp8_tables(g, cuda, "prefill", b, sq,
                                             window, off_t, mp, kvn, d, ps)
        if b > 2:
            clean[2] = -1
            dirty[2] = -1
        q = torch.randn((b, sq, n, d), generator=g, device=cuda,
                        dtype=dtype) * (40.0 if cap else 1.0)
        before = (getattr(pp, form).launches, _count(form, d, cap))
        got = pp.paged_flash_prefill(q, pk, pv, dirty, kv_t, off_t, 1,
                                     window=window, logit_cap=cap)
        after = (getattr(pp, form).launches, _count(form, d, cap))
        assert after[0] == before[0] + 1
        assert after[1] == (before[1][0] + (d == 256),
                            before[1][1] + bool(cap))
        want = pp.paged_flash_prefill_ref(q, pk, pv, clean, kv_t, off_t, 1,
                                          window=window, logit_cap=cap)
        assert bool(torch.isfinite(got).all())
        for i in range(b):
            valid = max(0, min(sq, lens[i] - offs[i]))
            assert _attn_ok(got[i, :valid], want[i, :valid]), (sq, i)


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_append_fp8kv_head_dim_256(cuda, dtype):
    # 1e, 2e and 11e at Gemma-2-2B's 4 kv heads of 256: 8 decode rows, 8 x
    # 128 prompt rows and a ragged batch, spans of 5 across a page; rows
    # past 464 (NaN codes) too; byte for byte
    g = torch.Generator(device=cuda).manual_seed(101)
    kvn, d, ps, b = G2_KVN, 256, 128, 8
    pools = _e4m3_pools(g, cuda, b=b, kvn=kvn, ps=ps, d=d, mp=3)
    tables = torch.randperm(b * 3, generator=g, device=cuda).to(
        torch.int32).reshape(b, 3)
    tables[-1, 1:] = -1

    def rows(*shape):
        return (torch.randn(shape, generator=g, device=cuda) * 200).to(dtype)

    pos = (120 + 3 * torch.arange(b, device=cuda)).to(torch.int32)
    cases = [
        ("paged_append_decode_fp8kv", (rows(b, kvn, d), rows(b, kvn, d),
                                       tables, pos, 1),
         pa.paged_append_decode, pa.paged_append_decode_ref),
        ("paged_append_prefill_fp8kv", (rows(b, 128, kvn, d),
                                        rows(b, 128, kvn, d), tables, 0),
         pa.paged_append_prefill, pa.paged_append_prefill_ref),
        ("paged_append_prefill_fp8kv", (rows(3, 100, kvn, d),
                                        rows(3, 100, kvn, d), tables[:3], 1),
         pa.paged_append_prefill, pa.paged_append_prefill_ref),
        ("paged_append_span_fp8kv", (rows(b, 5, kvn, d), rows(b, 5, kvn, d),
                                     tables, pos, 0),
         pa.paged_append_span, pa.paged_append_span_ref),
    ]
    for form, args, kern, plain in cases:
        a, r = [p.clone() for p in pools], [p.clone() for p in pools]
        before = (getattr(pa, form).launches, pa.D256_LAUNCHES[form])
        kern(*a, *args)
        torch.cuda.synchronize()
        assert (getattr(pa, form).launches, pa.D256_LAUNCHES[form]) == (
            before[0] + 1, before[1] + 1), form
        plain(*r, *args)
        for x, y in zip(a, r):
            assert _bytes_equal(x[:, :-1], y[:, :-1]), form
        assert (a[0].view(torch.uint8) & 0x7F == 0x7F).any()   # NaN codes


@pytest.mark.parametrize("xdt", DTYPES)
@pytest.mark.parametrize("case", ["gemma", "gemma2-kv_layer"])
def test_fused_qkv_append_fp8kv_head_dim_256(cuda, xdt, case):
    # 6e/256 at Gemma-2B (H 2048, 8 q heads over one kv head) and 6ek/256
    # at Gemma-2-2B (H 2304, 8 over 4, e4m3 ring pools at kv_layer 0): bf16
    # rows take 6m, f32 ones the FMA kernel; a head's columns lie in two
    # blocks, each writing its own codes: the pools byte for byte against
    # the plain version, k/v past 464 (NaN codes) too
    g = torch.Generator(device=cuda).manual_seed(111)
    n, kvn, h, kv_layer = ((G_N, G_KVN, 2048, None) if case == "gemma"
                           else (G2_N, G2_KVN, 2304, 0))
    d, ps, b, r = 256, 128, 8, 3
    nq = (n + 2 * kvn) * d
    wq, ws = _qw(g, cuda, (2, h, nq), 1)
    ws = ws * 30
    nw = torch.rand((2, h), generator=g, device=cuda).to(xdt) + 0.5
    x = torch.randn((b, h), generator=g, device=cuda).to(xdt)
    pos = (4200 + 37 * torch.arange(b, device=cuda)).to(torch.int32)
    pools, ring = _e4m3_ring(g, cuda, b, r, 40, kvn, d, ps)
    sin, cos = ref_ops.rope_tables(pos, d, 10000.0)
    a, rf = [p.clone() for p in pools], [p.clone() for p in pools]
    before = (qf.fused_qkv_append_fp8kv.launches,
              dict(qf.D256_FORM_LAUNCHES))
    qa, *_ = qf.fused_qkv_append(x, nw, wq, ws, sin, cos, a[0], a[1], 1,
                                 pos, n_heads=n, kv_heads=kvn, tables=ring,
                                 kv_layer=kv_layer)
    torch.cuda.synchronize()
    assert qf.fused_qkv_append_fp8kv.launches == before[0] + 1
    assert qf.D256_FORM_LAUNCHES["fused_qkv_append_fp8kv"] == before[1][
        "fused_qkv_append_fp8kv"] + 1
    assert qf.D256_FORM_LAUNCHES["fused_qkv_append_fp8kv_kv_layer"] == (
        before[1]["fused_qkv_append_fp8kv_kv_layer"]
        + (kv_layer is not None))
    qr, *_ = qf.fused_qkv_append_ref(x, nw, wq, ws, sin, cos, rf[0], rf[1],
                                     1, pos, n_heads=n, kv_heads=kvn,
                                     tables=ring, kv_layer=kv_layer)
    tol = 1e-5 if xdt == torch.float32 else 2e-2
    assert float((qa.float() - qr.float()).abs().max()) <= tol * float(
        qr.float().std())
    for x_a, x_r in zip(a, rf):
        assert _bytes_equal(x_a[:, :-1], x_r[:, :-1])
    kli = 1 if kv_layer is None else kv_layer
    pages = ring[torch.arange(b, device=cuda), pos.long() // ps].long()
    assert (a[0].view(torch.uint8)[kli, pages] & 0x7F == 0x7F).any()


# ------------------------------------------- FP8 KV on the dense arena

def _e4m3_arena(g, dev, rows, kvn, smax, d):
    """An e4m3 dense arena [2, rows, kvN, Smax, D] as the Generator fills
    it: N(0, 1) rows cast by the plain to_e4m3."""
    shape = (2, rows, kvn, smax, d)
    return tuple(ref_ops.to_e4m3(torch.randn(shape, generator=g, device=dev))
                 for _ in range(2))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("s,offs", [(1, [0, 383, 384, 7]),
                                    (8, [3, 376, 380, 500]),
                                    (128, [0, 256, 300, 0])])
def test_kv_append_fp8kv(cuda, dtype, d, s, offs):
    # 12e: rows past 464 (NaN codes) converted into the e4m3 arena byte
    # for byte as the plain version writes them, slots past Smax dropped,
    # the other layer and the arena row past the batch untouched
    from simplellminference_tpu_torch.ops import kv_append as ka
    g = torch.Generator(device=cuda).manual_seed(s + d)
    ck, cv = _e4m3_arena(g, cuda, 5, 4, 384, d)
    big = torch.randn((4, s, 3 * 4 * d), generator=g, device=cuda,
                      dtype=dtype) * 300
    nk = big[..., 4 * d:8 * d].reshape(4, s, 4, d)
    nv = big[..., 8 * d:].reshape(4, s, 4, d)          # strided views
    off = torch.tensor(offs, dtype=torch.int32, device=cuda)
    a, r = (ck.clone(), cv.clone()), (ck.clone(), cv.clone())
    before = (ka.kv_append_fp8kv.launches, ka.kv_append.launches,
              ka.D256_LAUNCHES["kv_append_fp8kv"])
    ka.kv_append(*a, nk, nv, 1, off)
    torch.cuda.synchronize()
    assert (ka.kv_append_fp8kv.launches, ka.kv_append.launches,
            ka.D256_LAUNCHES["kv_append_fp8kv"]) == (
        before[0] + 1, before[1], before[2] + (d == 256))
    ka.kv_append_ref(*r, nk, nv, 1, off)
    assert _bytes_equal(a[0], r[0]) and _bytes_equal(a[1], r[1])
    assert _bytes_equal(a[0][0], ck[0]) and _bytes_equal(a[0][:, 4], ck[:, 4])
    assert (a[0].view(torch.uint8) & 0x7F == 0x7F).any()


# name: (n, kvn, d, smax, cap, sink kind)
DENSE_FP8_CASES = {
    "llama": (32, 32, 128, 256, None, None),
    "gqa": (32, 4, 64, 2048, None, None),
    "gemma2-capped": (G2_N, G2_KVN, 256, 1024, G2_CAP, None),
    "gemma2-uncapped": (G2_N, G2_KVN, 256, 1024, None, None),
    "oss-sinks": (OSS_N, OSS_KVN, OSS_D, 2048, None, "n01"),
    "oss-sinks-above": (OSS_N, OSS_KVN, OSS_D, 2048, None, "above"),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 64], ids=["13e", "13ew"])
@pytest.mark.parametrize("case", list(DENSE_FP8_CASES))
def test_flash_decode_fp8kv_options(cuda, dtype, window, case):
    # 13e, 13ew and their capped (13ec, 13ewc at D 256) and sink (13es,
    # 13ews at D 64) forms over an e4m3 arena whose slots past kv_len and
    # below the band hold code 0x7f (NaN): kv_len 0, 1, a tile edge, the
    # window's edges, the arena's end and past it (a split walk at 2048
    # slots): by the rounding rule against the plain version, and bit for
    # bit the output over the arena with finite codes there
    from simplellminference_tpu_torch.ops.attention import flash_decode as fd
    n, kvn, d, smax, cap, sink = DENSE_FP8_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(
        list(DENSE_FP8_CASES).index(case) + 77)
    lens = [0, 1, 64, 65, 129, smax, smax + 40, 3]
    b = len(lens)
    clean = _e4m3_arena(g, cuda, b + 1, kvn, smax, d)
    ck, cv = (x.clone() for x in clean)
    for x in (ck, cv):
        u = x.view(torch.uint8)
        for i, ln in enumerate(lens):
            u[1, i, :, min(ln, smax):] = 0x7F
            if window:
                u[1, i, :, :max(0, min(ln - window, smax))] = 0x7F
    q = torch.randn((b, n, d), generator=g, device=cuda, dtype=dtype) * (
        20.0 if cap else 1.0)
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    sinks = None if sink is None else _oss_sinks(g, cuda, sink == "above")
    form = fd.flash_decode_fp8kv_window if window else fd.flash_decode_fp8kv
    counts = (form.launches, fd.D256_LAUNCHES[form.__name__],
              fp.CAP_LAUNCHES.get((form.__name__, d), 0),
              fp.SINK_LAUNCHES.get((form.__name__, d), 0))
    got = fd.flash_decode(q, ck, cv, kv, layer=1, window=window,
                          logit_cap=cap, sinks=sinks)
    torch.cuda.synchronize()
    assert (form.launches, fd.D256_LAUNCHES[form.__name__],
            fp.CAP_LAUNCHES.get((form.__name__, d), 0),
            fp.SINK_LAUNCHES.get((form.__name__, d), 0)) == (
        counts[0] + 1, counts[1] + (d == 256), counts[2] + bool(cap),
        counts[3] + (sinks is not None))
    want = fd.flash_decode_ref(q, ck, cv, kv, layer=1, window=window,
                               logit_cap=cap, sinks=sinks)
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    assert _close(got, want, dtype)
    assert not got[0].any()
    assert torch.equal(got, fd.flash_decode(q, *clean, kv, layer=1,
                                            window=window, logit_cap=cap,
                                            sinks=sinks))


@pytest.mark.parametrize("xdt", DTYPES)
@pytest.mark.parametrize("n,kvn,d,b,rows", [(8, 2, 64, 4, 5),
                                            (4, 4, 128, 3, 3),
                                            (8, 4, 256, 4, 4)])
def test_fused_qkv_append_dense_fp8kv(cuda, xdt, n, kvn, d, b, rows):
    # 6de (bf16 rows: 6m; f32 rows: the FMA kernel): k/v past 464 (NaN
    # codes) at most one e4m3 step from the plain version's codes (past
    # it, the values within the bf16 dense form's rule), every other byte
    # equal, a slot at Smax (row 2) dropped; counted in the
    # FP8-KV form and its dense count (and at D 256 in both D-256 counts)
    g = torch.Generator(device=cuda).manual_seed(n * kvn + d + 5)
    h, smax = 256, 128
    nq = (n + 2 * kvn) * d
    wq = torch.randint(-127, 128, (2, h, nq), generator=g, device=cuda,
                       dtype=torch.int8)
    ws = (torch.rand((2, 1, nq), generator=g, device=cuda) + 0.5) * 3.0
    nw = (1.0 + 0.1 * torch.randn((2, h), generator=g, device=cuda)).to(xdt)
    x = torch.randn((b, h), generator=g, device=cuda).to(xdt)
    pos = torch.tensor([5, 127, 128, 40, 3][:b], dtype=torch.int32,
                       device=cuda)
    sin, cos = ref_ops.rope_tables(pos, d, 10000.0)
    ck, cv = _e4m3_arena(g, cuda, rows, kvn, smax, d)
    a, r = (ck.clone(), cv.clone()), (ck.clone(), cv.clone())
    before = (qf.fused_qkv_append_fp8kv.launches,
              qf.fused_qkv_append_dense.launches,
              qf.DENSE_LAUNCHES["fused_qkv_append_fp8kv"],
              qf.D256_FORM_LAUNCHES["fused_qkv_append_fp8kv_dense"])
    with _one_launch(qf.QKV_REGIME_LAUNCHES,
                     qf.qkv_regime(b, h, nq, d, xdt)):
        qa, *_ = qf.fused_qkv_append(x, nw, wq, ws, sin, cos, *a, 1, pos,
                                     n_heads=n, kv_heads=kvn)
    torch.cuda.synchronize()
    assert (qf.fused_qkv_append_fp8kv.launches,
            qf.fused_qkv_append_dense.launches,
            qf.DENSE_LAUNCHES["fused_qkv_append_fp8kv"],
            qf.D256_FORM_LAUNCHES["fused_qkv_append_fp8kv_dense"]) == (
        before[0] + 1, before[1], before[2] + 1, before[3] + (d == 256))
    qr, *_ = qf.fused_qkv_append_ref(x, nw, wq, ws, sin, cos, *r, 1, pos,
                                     n_heads=n, kv_heads=kvn)
    tol = 1e-5 if xdt == torch.float32 else 2e-2
    assert float((qa.float() - qr.float()).abs().max()) <= tol * float(
        qr.float().std())
    written = torch.zeros(ck.shape[:4], dtype=torch.bool, device=cuda)
    for i, p in enumerate(pos.tolist()):
        if p < smax:
            written[1, i, :, p] = True
    for ta, tr in zip(a, r):
        assert _bytes_equal(ta[~written], tr[~written])
        # past one e4m3 step (a value near zero, when the kernel's rmsnorm
        # rounds an element of the row to the next bf16), the values by
        # the bf16 dense form's k/v rule above
        ga, gr = ta[written], tr[written]
        far = (_ordinal(ga) - _ordinal(gr)).abs() > 1
        fin = gr.float()[torch.isfinite(gr.float())]
        lim = tol * float(fin.std() if xdt == torch.bfloat16
                          else fin.abs().max())
        assert float((ga.float()[far] - gr.float()[far]).abs().max()
                     if far.any() else 0.0) <= lim
    assert (r[0].view(torch.uint8)[written] & 0x7F == 0x7F).any()


def test_generator_fp8kv_runs_the_kernels_only_and_matches_cpu(cuda):
    # the Generator over an e4m3 arena (f32 weights: 12e and 13e at every
    # step; INT8 weights: 6de at decode) on the card and the CPU: greedy
    # tokens of generate and generate_fused equal, every launch a kernel's
    from simplellminference_tpu_torch.ops import kv_append as ka
    from simplellminference_tpu_torch.ops.attention import flash_decode as fd
    from simplellminference_tpu_torch.runtime.generator import Generator
    cfg = ModelConfig.tiny_test(num_layers=2)
    prompts = [[5, 9, 2, 44, 17], [33, 4, 250, 1, 2, 3, 4, 5, 6], [7]]
    refs = (ka.kv_append_ref, fd.flash_decode_ref, fp.flash_prefill_ref,
            qf.fused_qkv_append_ref)
    calls = [f.cuda_calls for f in refs]
    for p_cpu in (llama.init_params(cfg, seed=5, device="cpu"),
                  _int8_params(cfg, 5, "cpu")):
        kerns = (fd.flash_decode_fp8kv, fp.flash_prefill, ka.kv_append_fp8kv
                 if isinstance(p_cpu["layers"]["wqkv"], torch.Tensor)
                 else qf.fused_qkv_append_fp8kv)
        launches = [f.launches for f in kerns]
        outs = []
        for p, dev in ((p_cpu, "cpu"), (_to(p_cpu, cuda), cuda)):
            gen = Generator(cfg, p, max_batch=3, max_seq=128,
                            kv_dtype=torch.float8_e4m3fn, device=dev)
            res = gen.generate(prompts, SamplingParams(max_new_tokens=12))
            fused = gen.generate_fused(prompts, 12)
            assert fused.tolist() == res.token_ids
            outs.append(res.token_ids)
        assert outs[0] == outs[1]
        assert all(f.launches > n for f, n in zip(kerns, launches))
    assert [f.cuda_calls for f in refs] == calls


# --- absorbed MLA: the shared-KV forms (one pool whose latent row is both
# the key and the value; DeepSeek-V2-Lite's 16 q heads over a 640-lane row)

MLA_N, MLA_D = 16, 640
MLA_SCALE = 192 ** -0.5


def _shared_pool(g, dev, dtype, pages, d=MLA_D, ps=128):
    return torch.randn((2, pages + 1, 1, ps, d), generator=g, device=dev,
                       dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [640, 128])
def test_paged_append_shared(cuda, dtype, d):
    # 1l and 2l: the latent rows alone into the shared pool, exact on every
    # page but the trash page, the pages no row goes to untouched
    g = torch.Generator(device=cuda).manual_seed(d)
    pool = _shared_pool(g, cuda, dtype, 12, d)
    tables = torch.arange(12, dtype=torch.int32, device=cuda).reshape(3, 4)
    tables[1, 3] = -1
    row = torch.randn((3, 2, 1, d), generator=g, device=cuda,
                      dtype=dtype)[:, 1]
    pos = torch.tensor([5, 400, 130], dtype=torch.int32, device=cuda)
    a, r = pool.clone(), pool.clone()
    pa.paged_append_decode(a, None, row, None, tables, pos, 1)
    pa.paged_append_decode_shared_ref(r, row, tables, pos, 1)
    assert torch.equal(a[:, :-1], r[:, :-1])
    assert torch.equal(a[:, 4:8], pool[:, 4:8]) and torch.equal(a[0], pool[0])
    chunk = torch.randn((3, 300, 1, d), generator=g, device=cuda, dtype=dtype)
    a, r = pool.clone(), pool.clone()
    pa.paged_append_prefill(a, None, chunk, None, tables, 0)
    pa.paged_append_prefill_shared_ref(r, chunk, tables, 0)
    assert torch.equal(a[:, :-1], r[:, :-1]) and torch.equal(a[1], pool[1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,lens", [(640, [1090, 1100, 0, 1, 1919, 128]),
                                    (640, [4096] * 2), (128, [5, 129, 0])])
def test_paged_flash_decode_shared(cuda, dtype, d, lens):
    # 4l at D 640 (the `mla` path's decode, kv_len 4096, edges) and D 128
    g = torch.Generator(device=cuda).manual_seed(len(lens))
    b = len(lens)
    mp = -(-max(lens) // 128) or 1
    pool = _shared_pool(g, cuda, dtype, b * mp, d)
    tables = torch.arange(b * mp, dtype=torch.int32,
                          device=cuda).reshape(b, mp)
    q = torch.randn((b, MLA_N, d), generator=g, device=cuda, dtype=dtype)
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = pd.paged_flash_decode_shared.launches
    got = pd.paged_flash_decode(q, pool, None, tables, kv, 1,
                                sm_scale=MLA_SCALE)
    want = pd.paged_flash_decode_ref(q, pool, None, tables, kv, 1,
                                     sm_scale=MLA_SCALE)
    assert pd.paged_flash_decode_shared.launches == before + 1
    assert _close(got, want, dtype)
    for i, n in enumerate(lens):
        if n == 0:
            assert not got[i].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,sq,offs,lens", [
    (640, 512, [0], [512]), (640, 512, [512], [1024]),
    (640, 100, [0, 128, 0], [100, 200, 1]), (128, 512, [512], [1024])])
def test_paged_flash_prefill_shared(cuda, dtype, d, sq, offs, lens):
    # 8l: chunks at the `mla` path's offsets, ragged offsets with a
    # padding row, and D 128
    if dtype == torch.float32 and sq == 512:
        sq = 64                      # the FMA kernel: a shorter chunk
        lens = [o + sq for o in offs]
    g = torch.Generator(device=cuda).manual_seed(sq + d)
    b = len(offs)
    mp = -(-max(o + sq for o in offs) // 128)
    pool = _shared_pool(g, cuda, dtype, b * mp, d)
    tables = torch.arange(b * mp, dtype=torch.int32,
                          device=cuda).reshape(b, mp)
    q = torch.randn((b, sq, MLA_N, d), generator=g, device=cuda, dtype=dtype)
    off_t = torch.tensor(offs, dtype=torch.int32, device=cuda)
    kv = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = pp.paged_flash_prefill_shared.launches
    got = pp.paged_flash_prefill(q, pool, None, tables, kv, off_t, 1,
                                 sm_scale=MLA_SCALE)
    want = pp.paged_flash_prefill_shared_ref(q, pool, tables, kv, off_t, 1,
                                             MLA_SCALE)
    assert pp.paged_flash_prefill_shared.launches == before + 1
    assert _attn_ok(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,d", [(8, 128, 640), (2, 200, 640),
                                   (3, 33, 128)])
def test_flash_prefill_shared(cuda, dtype, b, s, d):
    # 3l: the whole prompt's fresh latent rows, K as V (a strided view)
    g = torch.Generator(device=cuda).manual_seed(s)
    qkv = torch.randn((b, s, MLA_N + 1, d), generator=g, device=cuda,
                      dtype=dtype)
    q, kv = qkv[:, :, :MLA_N], qkv[:, :, MLA_N:]
    before = fp.flash_prefill_shared.launches
    got = fp.flash_prefill_shared(q, kv, sm_scale=MLA_SCALE)
    want = fp.flash_prefill_ref(q, kv, kv, MLA_SCALE)
    assert fp.flash_prefill_shared.launches == before + 1
    assert _attn_ok(got, want)


def test_mla_engine_runs_the_shared_forms_and_matches_cpu(cuda):
    # a tiny DeepSeek-V2 (the absorbed lane 128) through the Engine on the
    # card and the CPU, absorbed and naive: greedy tokens equal, the
    # absorbed run through the shared forms only
    hf = dict(model_type="deepseek_v2", vocab_size=256, hidden_size=128,
              intermediate_size=256, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=4,
              max_position_embeddings=256, rms_norm_eps=1e-6,
              rope_theta=10000.0, tie_word_embeddings=False,
              n_routed_experts=None, q_lora_rank=None, kv_lora_rank=64,
              qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
              first_k_dense_replace=2, attention_bias=False)
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], list(range(30, 70))]
    outs = {}
    for absorbed in (True, False):
        cfg = ModelConfig.from_hf_dict(hf, dtype="float32",
                                       mla_absorbed=absorbed)
        p_cpu = llama.init_params(cfg, seed=3, device="cpu")
        shared = (pa.paged_append_decode_shared, pd.paged_flash_decode_shared,
                  pp.paged_flash_prefill_shared, fp.flash_prefill_shared)
        dual = (pa.paged_append_decode, pd.paged_flash_decode,
                pp.paged_flash_prefill, fp.flash_prefill)
        counts = [f.launches for f in shared + dual]
        for p, dev in ((p_cpu, "cpu"), (_to(p_cpu, cuda), cuda)):
            eng = Engine(cfg, p, EngineConfig(
                max_batch_size=4, prefill_chunk=16,
                kv=KVCacheConfig(page_size=8, num_pages=64,
                                 max_pages_per_seq=16, kv_dtype="f32")),
                decode_burst=3, device=dev)
            assert (eng.cache.v is None) == absorbed
            outs[absorbed, str(dev)] = eng.generate(
                prompts, SamplingParams(max_new_tokens=8))
        ran = [f.launches > n for f, n in zip(shared + dual, counts)]
        assert ran == [absorbed] * 4 + [not absorbed] * 4
    assert outs[True, "cpu"] == outs[True, "cuda"] == outs[False, "cuda"]
