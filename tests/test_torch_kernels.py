"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (a CUDA kernel has no CPU mode) and
skips without one. The file imports no JAX, so it runs on a machine that
has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_kernels.py --noconftest -m gpu -q

(``--noconftest``: the suite's conftest.py sets JAX up for the CPU).
Stated tolerances: the paged writes are exact (every page but the trash
page); attention 1e-4 absolute in float32 and 2e-2 in bfloat16 (both sides
accumulate in f32, in different orders; bf16 rounds the outputs); model
logits 1e-3 in float32 with TF32 off.
"""

import numpy as np
import pytest
import torch

from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                      KVCacheConfig,
                                                      ModelConfig,
                                                      SamplingParams)
from simplellminference_tpu_torch.engine import Engine
from simplellminference_tpu_torch.models import llama
from simplellminference_tpu_torch.ops import paged_append as pa
from simplellminference_tpu_torch.ops.attention import flash_prefill as fp
from simplellminference_tpu_torch.ops.attention import paged_decode as pd

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
    assert float((got.float() - want.float()).abs().max()) <= ATTN_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,kvn,d", [(32, 32, 128), (32, 4, 64)])
def test_paged_flash_decode(cuda, dtype, n, kvn, d):
    g = torch.Generator(device=cuda).manual_seed(n + kvn)
    lens = [1, 128, 129, 200, 0, 57]
    b, ps, mp = len(lens), 128, 2
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
    assert not got[4].any()          # kv_len 0 -> zero output


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
