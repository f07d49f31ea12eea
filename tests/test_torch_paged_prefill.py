"""Chunked prefill through the page tables: the port against the JAX package.

``paged_flash_prefill_ref`` (what the port runs on the CPU, and what the
CUDA kernel is held against on the card) takes the same numpy inputs as
the JAX ``paged_flash_prefill`` in interpret mode (as the JAX package's own
tests run it on the CPU) and, at Sq not a multiple of 128, as the JAX
dispatcher's CPU path (gather + masked reference attention). Float32;
stated tolerance 1e-5 on the valid query rows (summation order differs;
rows past kv_len are garbage by contract in the JAX kernel), and every
output row of the port must be finite, padding rows included.
``write_prefill_stacked(page_offset=...)`` is byte-equal to the JAX
write.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.memory import paged_kv as jpkv
from simplellminference_tpu.ops.attention import dispatch as jdispatch
from simplellminference_tpu.ops.attention.paged_prefill import (
    paged_flash_prefill as jax_paged_flash_prefill)
from simplellminference_tpu_torch.core.config import ModelConfig
from simplellminference_tpu_torch.memory import paged_kv as tpkv
from simplellminference_tpu_torch.ops.attention import dispatch
from simplellminference_tpu_torch.ops.attention.paged_prefill import (
    paged_flash_prefill, paged_flash_prefill_ref)

TOL = 1e-5


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(rng, b, s, n, kvn, d, ps, mp, layers=1):
    """Per-row page-aligned offsets, ragged kv_lens in (off, off + s],
    distinct pages per row."""
    p = b * mp + 1
    q = rand(rng, b, s, n, d)
    pk = rand(rng, layers, p, kvn, ps, d)
    pv = rand(rng, layers, p, kvn, ps, d)
    offs = np.asarray([(i % 2) * ps for i in range(b)], np.int32)
    kv = (offs + rng.integers(1, s + 1, size=b)).astype(np.int32)
    tables = (rng.permutation(p - 1)[:b * mp] + 1).astype(np.int32)
    return q, pk, pv, tables.reshape(b, mp), kv, offs


def _valid_close(got, want, kv, offs):
    got = got.numpy()
    assert np.isfinite(got).all()
    for i in range(got.shape[0]):
        valid = int(kv[i] - offs[i])
        np.testing.assert_allclose(got[i, :valid], np.asarray(want)[i, :valid],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,s,n,kvn,d,ps", [
    (2, 128, 4, 2, 64, 16),
    (1, 256, 8, 8, 128, 32),   # MHA, two q blocks
    (2, 128, 4, 1, 64, 64),    # MQA
], ids=["gqa", "mha", "mqa"])
def test_plain_matches_jax_kernel(b, s, n, kvn, d, ps):
    rng = np.random.default_rng(b * s + n)
    q, pk, pv, tables, kv, offs = _case(rng, b, s, n, kvn, d, ps, 8)
    got = paged_flash_prefill(t(q), t(pk), t(pv), t(tables), t(kv), t(offs),
                              0)
    want = jax_paged_flash_prefill(
        jnp.asarray(q), jnp.asarray(pk[0]), jnp.asarray(pv[0]),
        jnp.asarray(tables), jnp.asarray(kv), jnp.asarray(offs), bq=128,
        interpret=True)
    _valid_close(got, want, kv, offs)


def test_plain_matches_jax_kernel_stacked_pools_and_padding_row():
    # stacked [L, P+1, ...] pools read at layer 1; a last row as the
    # engine pads a batch (all -1 table, kv_len 1, offset 0) must come
    # out finite
    rng = np.random.default_rng(21)
    b, s, n, kvn, d, ps, mp = 3, 128, 4, 2, 32, 8, 24
    q, pk, pv, tables, kv, offs = _case(rng, b, s, n, kvn, d, ps, mp,
                                        layers=2)
    offs = np.asarray([0, 40, 0], np.int32)
    kv = np.asarray([77, 40 + 128, 1], np.int32)
    tables[2] = -1
    got = paged_flash_prefill(t(q), t(pk), t(pv), t(tables), t(kv), t(offs),
                              1)
    assert torch.isfinite(got).all()
    want = jax_paged_flash_prefill(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables), jnp.asarray(kv), jnp.asarray(offs), bq=128,
        interpret=True, layer=jnp.int32(1))
    _valid_close(got[:2], np.asarray(want)[:2], kv, offs)


@pytest.mark.parametrize("s,offs,lens", [
    (64, [16, 0, 32], [70, 64, 33]),     # a suffix batch bucket
    (20, [8, 0, 0], [28, 5, 1]),         # ragged, a padding-like row
    (1, [24, 0, 8], [25, 1, 9]),
], ids=["sq64", "sq20", "sq1"])
def test_plain_matches_jax_dispatch_any_sq(s, offs, lens):
    rng = np.random.default_rng(s)
    b, n, kvn, d, ps, mp = 3, 4, 2, 32, 8, 12
    q, pk, pv, tables, _kv, _ = _case(rng, b, s, n, kvn, d, ps, mp, layers=2)
    offs = np.asarray(offs, np.int32)
    kv = np.asarray(lens, np.int32)
    cfg = ModelConfig.tiny_test()
    got = dispatch.attention_paged_prefill(cfg, t(q), t(pk), t(pv),
                                           t(tables), t(kv), t(offs), 1)
    want = jdispatch.attention_paged_prefill(
        JaxModelConfig.tiny_test(), jnp.asarray(q), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(tables), jnp.asarray(kv),
        jnp.asarray(offs), layer=jnp.int32(1))
    _valid_close(got, want, kv, offs)


@pytest.mark.parametrize("kw,feature,fp8", [
    # the cap runs over every pool dtype, with or without a window (over
    # e4m3 pools since Gemma's FP8-KV slice: 8ec, 8ewc; at D 256 too:
    # tests/test_torch_fp8kv_gemma.py), so these two cases, which raised
    # before it, now hold the port to the JAX kernel over e4m3 pools
    (dict(window=16, logit_cap=30.0), "FP8 KV", True),
    (dict(logit_cap=30.0), "soft cap", True),
    # sinks run over every pool dtype at head_dim 32-128 (8s, 8ws, 8qs,
    # 8qws, 8es, 8ews: tests/test_torch_sinks.py,
    # tests/test_torch_int8kv_sinks_cap.py,
    # tests/test_torch_fp8kv_sinks_window.py and
    # test_sinks_run_over_float_pools below), not at head_dim 256 (this
    # case's pools are e4m3 pools of head_dim 256)
    (dict(sinks=torch.zeros(4)), "sinks", True),
    (dict(k_scale=torch.ones(1)), "INT8 KV", False),     # no V scale pool
])
def test_unported_options_raise(kw, feature, fp8):
    rng = np.random.default_rng(0)
    d = 256 if "sinks" in kw else 32
    q, pk, pv, tables, kv, offs = _case(rng, 2, 16, 4, 2, d, 8, 4)
    if fp8:
        pk, pv = (x.astype(np.float32) for x in (pk, pv))
        pk = t(pk).to(torch.float8_e4m3fn)
        pv = t(pv).to(torch.float8_e4m3fn)
    else:
        pk, pv = t(pk), t(pv)
    if "logit_cap" in kw:
        # q x 8: scores several times past the cap
        got = paged_flash_prefill(t(q * 8), pk, pv, t(tables), t(kv),
                                  t(offs), 0, **kw)
        jk, jv = (jnp.asarray(x.view(torch.uint8).numpy()).view(
            jnp.float8_e4m3fn) for x in (pk, pv))
        want = jax_paged_flash_prefill(
            jnp.asarray(q * 8), jk, jv, jnp.asarray(tables), jnp.asarray(kv),
            jnp.asarray(offs), bq=16, interpret=True, layer=jnp.int32(0),
            **kw)
        _valid_close(got, want, kv, offs)
    else:
        with pytest.raises(NotImplementedError, match=feature):
            paged_flash_prefill(t(q), pk, pv, t(tables), t(kv), t(offs), 0,
                                **kw)
    with pytest.raises(NotImplementedError, match="shared-KV"):
        paged_flash_prefill(t(q), pk, None, t(tables), t(kv), t(offs), 0)


@pytest.mark.parametrize("window", [None, 16], ids=["8s", "8ws"])
def test_sinks_run_over_float_pools(window):
    """The sink forms, which raised before GPT-OSS's slice: the wrapper's
    CPU path against JAX's dispatcher (the gather + masked reference) on
    the rows of the chunk that hold a query."""
    rng = np.random.default_rng(2)
    q, pk, pv, tables, kv, offs = _case(rng, 2, 16, 4, 2, 32, 8, 4)
    sinks = rng.standard_normal(4).astype(np.float32)
    got = paged_flash_prefill(t(q), t(pk), t(pv), t(tables), t(kv), t(offs),
                              0, window=window, sinks=t(sinks))
    want = jdispatch.attention_paged_prefill(
        JaxModelConfig.tiny_test(sliding_window=window), jnp.asarray(q),
        jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tables),
        jnp.asarray(kv), jnp.asarray(offs), layer=jnp.int32(0),
        sinks=jnp.asarray(sinks))
    _valid_close(got, want, kv, offs)


def test_cpu_wrapper_runs_the_plain_version():
    rng = np.random.default_rng(1)
    q, pk, pv, tables, kv, offs = _case(rng, 2, 16, 4, 2, 32, 8, 4)
    before = paged_flash_prefill.launches, paged_flash_prefill_ref.cuda_calls
    got = paged_flash_prefill(t(q), t(pk), t(pv), t(tables), t(kv), t(offs),
                              0)
    want = paged_flash_prefill_ref(t(q), t(pk), t(pv), t(tables), t(kv),
                                   t(offs), 0)
    assert torch.equal(got, want)
    assert (paged_flash_prefill.launches,
            paged_flash_prefill_ref.cuda_calls) == before


@pytest.mark.parametrize("page_offset,s", [
    (2, 16),                        # scalar offset, two pages
    (np.asarray([0, 3, 4]), 12),    # [B] offsets, a ragged last page
    (np.asarray([1, 5, 2]), 16),    # row 1's second page is past the width
], ids=["scalar", "vector", "past-width"])
def test_write_prefill_stacked_page_offset_byte_equal(page_offset, s):
    rng = np.random.default_rng(s)
    b, kvn, d, ps, mp, layers = 3, 2, 16, 8, 6, 2
    p = b * mp
    pk, pv = rand(rng, layers, p + 1, kvn, ps, d), rand(rng, layers, p + 1,
                                                       kvn, ps, d)
    tables = rng.permutation(p).astype(np.int32).reshape(b, mp)
    nk, nv = rand(rng, b, s, kvn, d), rand(rng, b, s, kvn, d)
    jk, jv, _, _ = jpkv.write_prefill_stacked(
        jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(nk), jnp.asarray(nv),
        jnp.asarray(tables), jnp.int32(1),
        page_offset=jnp.asarray(page_offset, jnp.int32))
    tk, tv = t(pk.copy()), t(pv.copy())
    po = (page_offset if np.ndim(page_offset) == 0
          else t(page_offset.astype(np.int64)))
    tpkv.write_prefill_stacked(tk, tv, t(nk), t(nv), t(tables), 1,
                               page_offset=po)
    # at most one page lands in the trash page, so it compares too
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if np.ndim(page_offset) and (page_offset + 2 > mp).any():
        np.testing.assert_array_equal(tk.numpy()[1, -1].transpose(1, 0, 2),
                                      nk[1, ps:2 * ps])
