"""Paged KV writes and gathers of the PyTorch port against the JAX package.

The port's plain ``paged_append_*`` and its ``write_*_stacked`` take the
same inputs (numpy, fixed seed) as JAX's ``write_prefill_stacked`` /
``write_decode_stacked`` (the scatter path on the CPU). Pools must be
byte-equal on every page but the trash page (the last row), where -1
entries land in both packages. tests/test_torch_kernels.py holds the
CUDA kernels against these plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.memory import paged_kv as jpkv
from simplellminference_tpu_torch.memory import paged_kv as tpkv
from simplellminference_tpu_torch.ops import paged_append as tpa

L, P, KVN, PS, D = 3, 12, 2, 8, 16


def pools(rng):
    shape = (L, P + 1, KVN, PS, D)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def assert_pools_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got[:, :-1], want[:, :-1])


# tables: row 1 has an unmapped tail, row 2 is an inactive slot (all -1)
TABLES = np.array([[3, 7, 1, 4], [0, 11, -1, -1], [-1, -1, -1, -1]],
                  np.int32)


@pytest.mark.parametrize("s", [16, 13, 1], ids=["full", "ragged", "one"])
def test_write_prefill_matches_jax(s):
    rng = np.random.default_rng(s)
    pk, pv = pools(rng)
    nk = rng.standard_normal((3, s, KVN, D)).astype(np.float32)
    nv = rng.standard_normal((3, s, KVN, D)).astype(np.float32)
    jk, jv, _, _ = jpkv.write_prefill_stacked(
        jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(nk), jnp.asarray(nv),
        jnp.asarray(TABLES), jnp.int32(1))
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    out = tpkv.write_prefill_stacked(tk, tv, torch.from_numpy(nk),
                                     torch.from_numpy(nv),
                                     torch.from_numpy(TABLES), 1)
    assert out[0] is tk and out[1] is tv        # updated in place
    assert_pools_equal(tk, jk)
    assert_pools_equal(tv, jv)


def test_write_prefill_zero_pads_last_page():
    rng = np.random.default_rng(0)
    pk, pv = pools(rng)
    nk = rng.standard_normal((1, 5, KVN, D)).astype(np.float32)
    tk, tv = torch.from_numpy(pk), torch.from_numpy(pv)
    tpa.paged_append_prefill_ref(tk, tv, torch.from_numpy(nk),
                                 torch.from_numpy(nk), torch.tensor([[6]]),
                                 0)
    assert torch.equal(tk[0, 6, :, :5], torch.from_numpy(nk[0]).transpose(
        0, 1))
    assert not tk[0, 6, :, 5:].any()


def test_write_decode_matches_jax():
    rng = np.random.default_rng(1)
    pk, pv = pools(rng)
    nk = rng.standard_normal((3, KVN, D)).astype(np.float32)
    nv = rng.standard_normal((3, KVN, D)).astype(np.float32)
    positions = np.array([17, 9, 4], np.int32)   # page 1 slot 1; page 11; dead
    jk, jv, _, _ = jpkv.write_decode_stacked(
        jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(nk), jnp.asarray(nv),
        jnp.asarray(TABLES), jnp.asarray(positions), jnp.int32(2))
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    tpkv.write_decode_stacked(tk, tv, torch.from_numpy(nk),
                              torch.from_numpy(nv), torch.from_numpy(TABLES),
                              torch.from_numpy(positions), 2)
    assert_pools_equal(tk, jk)
    assert_pools_equal(tv, jv)
    assert torch.equal(tk[2, 1, :, 1], torch.from_numpy(nk[0]))


def test_gather_dense_zeroes_unmapped_pages():
    rng = np.random.default_rng(2)
    pk, pv = pools(rng)
    jk, jv = jpkv.gather_dense(jnp.asarray(pk[0]), jnp.asarray(pv[0]),
                               jnp.asarray(TABLES))
    tk, tv = tpkv.gather_dense(torch.from_numpy(pk[0]),
                               torch.from_numpy(pv[0]),
                               torch.from_numpy(TABLES))
    mapped = np.repeat(TABLES >= 0, PS, axis=1)          # [B, MP*ps]
    for t, j in ((tk, jk), (tv, jv)):
        t, j = t.numpy(), np.asarray(j)
        np.testing.assert_array_equal(t.transpose(0, 2, 1, 3)[mapped],
                                      j.transpose(0, 2, 1, 3)[mapped])
        # unmapped pages: zeros in the port; JAX's mode="fill" gather
        # normalizes -1 to the last row first and reads the trash page
        assert not t.transpose(0, 2, 1, 3)[~mapped].any()
        np.testing.assert_array_equal(j[2, :, :PS], j[2, :, PS:2 * PS])
    assert not tk[2].any()                     # the all -1 row
    assert not tk[1, :, 2 * PS:].any()         # the unmapped tail


def test_cache_create_layout_and_unsupported():
    c = tpkv.PagedKVCache.create(2, 5, 3, 8, 16, torch.float32,
                                 device="cpu")
    assert c.k.shape == (2, 6, 3, 8, 16) and c.v.shape == c.k.shape
    assert c.page_size == 8 and c.num_pages == 6 and not c.k.any()
    assert tpkv.kv_storage_dtype("bf16") == torch.bfloat16
    # e4m3 storage takes a windowed group too: zeroed e4m3 ring pools, no
    # scale pools
    w = tpkv.PagedKVCache.create(2, 5, 3, 8, 16, torch.float8_e4m3fn,
                                 device="cpu").with_windowed(1, 4)
    assert w.k_w.dtype == w.v_w.dtype == torch.float8_e4m3fn
    assert w.k_w.shape == w.v_w.shape == (1, 5, 3, 8, 16)
    assert not w.k_w.view(torch.uint8).any()
    assert w.k_w_scale is None and w.v_w_scale is None
    # a shared-KV cache (absorbed MLA): one bf16/f32 pool, v None; INT8
    # and e4m3 shared pools are not ported
    sh = tpkv.PagedKVCache.create(2, 5, 1, 8, 16, shared_kv=True,
                                  device="cpu")
    assert sh.v is None and sh.k.shape == (2, 6, 1, 8, 16)
    assert sh.k_scale is None and sh.v_scale is None
    for dt in (torch.int8, torch.float8_e4m3fn):
        with pytest.raises(NotImplementedError, match="shared-KV"):
            tpkv.PagedKVCache.create(2, 5, 3, 8, 16, dt, shared_kv=True,
                                     device="cpu")
    q = tpkv.PagedKVCache.create(2, 5, 3, 8, 16, torch.int8, device="cpu")
    with pytest.raises(NotImplementedError, match="no V scale pool"):
        tpkv.write_decode_stacked(q.k, q.v, None, None, None, None, 0,
                                  pool_ks=q.k_scale)


def test_cache_defaults_to_cuda():
    if torch.cuda.is_available():
        c = tpkv.PagedKVCache.create(1, 2, 1, 8, 16)
        assert c.k.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tpkv.PagedKVCache.create(1, 2, 1, 8, 16)
