"""Attention of the PyTorch port against the JAX package's Pallas kernels.

The plain versions (what the port runs on the CPU) take the same numpy
inputs as JAX's ``flash_prefill`` / ``paged_flash_decode`` run in
interpret mode (as the JAX package's own tests run them on the CPU) and
as ``ref_ops.attention``; float32, stated tolerance 1e-5 relative /
2e-6 absolute (summation order differs). tests/test_torch_kernels.py
holds the CUDA kernels against these plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.ops import ref_ops as jref
from simplellminference_tpu.ops.attention.flash_prefill import (
    flash_prefill as jax_flash_prefill)
from simplellminference_tpu.ops.attention.paged_decode import (
    paged_flash_decode as jax_paged_flash_decode)
from simplellminference_tpu_torch.core.config import ModelConfig
from simplellminference_tpu_torch.ops.attention import dispatch
from simplellminference_tpu_torch.ops.attention.flash_prefill import (
    flash_prefill)
from simplellminference_tpu_torch.ops.attention.paged_decode import (
    paged_flash_decode, paged_flash_verify)

RTOL, ATOL = 1e-5, 2e-6


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("s,n,kvn", [(128, 4, 2), (20, 4, 1), (20, 2, 2)],
                         ids=["s128-gqa", "s20-mqa", "s20-mha"])
def test_flash_prefill_plain_matches_jax(s, n, kvn):
    rng = np.random.default_rng(s + n)
    q, k, v = rand(rng, 2, s, n, 32), rand(rng, 2, s, kvn, 32), rand(
        rng, 2, s, kvn, 32)
    got = flash_prefill(*(torch.from_numpy(a) for a in (q, k, v)))
    want = jax_flash_prefill(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=True, interpret=True)
    close(got, want)
    mask = jref.causal_mask(s, s)[None, None]
    close(got, jref.attention(*(jnp.asarray(a) for a in (q, k, v)), mask))


def test_flash_prefill_sm_scale_via_dispatch():
    rng = np.random.default_rng(9)
    q, k, v = rand(rng, 1, 9, 2, 32), rand(rng, 1, 9, 2, 32), rand(
        rng, 1, 9, 2, 32)
    cfg = ModelConfig.tiny_test(query_pre_attn_scalar=24.0)
    got = dispatch.attention(cfg, *(torch.from_numpy(a) for a in (q, k, v)))
    want = jax_flash_prefill(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=True, interpret=True,
                             sm_scale=24.0 ** -0.5)
    close(got, want)
    # Gemma-2's soft cap goes through too (scores x3 so that it bites),
    # and GPT-OSS's sinks (a layer's logit per q head)
    q3 = q * 3.0
    got = dispatch.attention(
        ModelConfig.tiny_test(query_pre_attn_scalar=24.0,
                              attn_logit_softcap=2.0),
        *(torch.from_numpy(a) for a in (q3, k, v)))
    want = jax_flash_prefill(*(jnp.asarray(a) for a in (q3, k, v)),
                             causal=True, interpret=True,
                             sm_scale=24.0 ** -0.5, logit_cap=2.0)
    close(got, want)
    sinks = rng.standard_normal(2).astype(np.float32)
    got = dispatch.attention(ModelConfig.tiny_test(attn_sinks=True),
                             *(torch.from_numpy(a) for a in (q, k, v)),
                             sinks=torch.from_numpy(sinks))
    want = jax_flash_prefill(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=True, interpret=True,
                             sinks=jnp.asarray(sinks))
    close(got, want)


def _paged_case(rng, b, n, kvn, d, ps, mp, lens):
    n_layers, p = 2, b * mp
    pk = rand(rng, n_layers, p + 1, kvn, ps, d)
    pv = rand(rng, n_layers, p + 1, kvn, ps, d)
    q = rand(rng, b, n, d)
    tables = rng.permutation(p).astype(np.int32).reshape(b, mp)
    kv = np.asarray(lens, np.int32)
    for i, ln in enumerate(lens):      # pages past the live prefix unmapped
        tables[i, -(-ln // ps):] = -1
    return q, pk, pv, tables, kv


@pytest.mark.parametrize("lens,n,kvn", [
    ([1, 8, 13, 32], 4, 4),          # one key, a full page, partial, full
    ([5, 17, 32, 0], 8, 2),          # GQA, and an empty row
    ([3, 30], 4, 1),                 # MQA
], ids=["mha", "gqa", "mqa"])
def test_paged_decode_plain_matches_jax(lens, n, kvn):
    rng = np.random.default_rng(len(lens) + n)
    ps, mp, d = 8, 4, 32
    q, pk, pv, tables, kv = _paged_case(rng, len(lens), n, kvn, d, ps, mp,
                                        lens)
    got = paged_flash_decode(torch.from_numpy(q), torch.from_numpy(pk),
                             torch.from_numpy(pv), torch.from_numpy(tables),
                             torch.from_numpy(kv), 1)
    want = jax_paged_flash_decode(jnp.asarray(q), jnp.asarray(pk),
                                  jnp.asarray(pv), jnp.asarray(tables),
                                  jnp.asarray(kv), interpret=True,
                                  layer=jnp.int32(1))
    close(got, want)


def test_attention_paged_dispatch_shapes():
    rng = np.random.default_rng(3)
    q, pk, pv, tables, kv = _paged_case(rng, 2, 4, 2, 32, 8, 2, [3, 9])
    cfg = ModelConfig.tiny_test()
    out = dispatch.attention_paged(
        cfg, torch.from_numpy(q)[:, None], torch.from_numpy(pk),
        torch.from_numpy(pv), torch.from_numpy(tables), torch.from_numpy(kv),
        0)
    assert out.shape == (2, 1, 4, 32)
    # a multi-row window is a speculative verify step
    q3 = torch.from_numpy(rand(rng, 2, 3, 4, 32))
    args = tuple(torch.from_numpy(a) for a in (pk, pv, tables, kv))
    out3 = dispatch.attention_paged(cfg, q3, *args, 0)
    assert out3.shape == (2, 3, 4, 32)
    assert torch.equal(out3, paged_flash_verify(q3, *args, 0))
    # Gemma-2's soft cap reaches the verify rows too (4vc)
    assert torch.equal(
        dispatch.attention_paged(
            ModelConfig.tiny_test(attn_logit_softcap=50.0), q3, *args, 0),
        paged_flash_verify(q3, *args, 0, logit_cap=50.0))
