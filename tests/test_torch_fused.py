"""The port's fused decode kernels' plain versions (fused_qkv_append in its
paged form, fused_ffn) and their availability gates against the JAX
package, whose Pallas kernels run in interpret mode on the CPU.

Activations are bf16, so both packages round at the same points (the
normalized rows, the SwiGLU output, q); everything else is f32 on both
sides, summed in different orders. Stated tolerances: q, the written k/v
rows and the FFN output within 2e-2 of their standard deviation (one
bf16 ulp of the largest values, and the rare bf16 rounding flip of an
intermediate); every pool entry that is not written, the other layers
and the trash page's unwritten slots, exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.ops import ffn_fused as jffn
from simplellminference_tpu.ops import qkv_fused as jqkv
from simplellminference_tpu.ops import ref_ops as jref
from simplellminference_tpu.ops.linear import QuantizedWeight as JaxQW
from simplellminference_tpu_torch.core.config import ModelConfig
from simplellminference_tpu_torch.ops import ffn_fused as tffn
from simplellminference_tpu_torch.ops import qkv_fused as tqkv
from simplellminference_tpu_torch.ops.linear import QuantizedWeight as TQW

REL = 2e-2


def bf16_pair(a):
    """One bf16 array, as a torch tensor and a jax array."""
    t = torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def f32(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("n,kvn,pool_dtype", [(4, 2, "f32"), (4, 4, "bf16")],
                         ids=["gqa-f32-pools", "mha-bf16-pools"])
def test_fused_qkv_append_matches_jax_kernel(n, kvn, pool_dtype):
    rng = np.random.default_rng(n + kvn)
    L, h, d, ps, mp, b, li = 2, 128, 32, 16, 3, 3, 1
    nq = (n + 2 * kvn) * d
    p1 = b * mp + 1
    wq = rng.integers(-127, 128, (L, h, nq)).astype(np.int8)
    ws = (rng.uniform(0.5, 2.0, (L, 1, nq)) * 1e-2).astype(np.float32)
    nw = (rng.standard_normal((L, h)) * 0.1 + 1.0).astype(np.float32)
    xt, xj = bf16_pair(rng.standard_normal((b, h)))
    pos = np.asarray([5, 20, 40], np.int32)
    # row 2's page for position 40 is unmapped: it writes to the trash page
    tables = np.asarray([[3, 7, 1], [0, 5, 8], [2, 4, -1]], np.int32)
    sin_j, cos_j = jref.rope_tables(jnp.asarray(pos), d, 10000.0)
    tdt = torch.float32 if pool_dtype == "f32" else torch.bfloat16
    jdt = jnp.float32 if pool_dtype == "f32" else jnp.bfloat16
    pk = torch.from_numpy(rng.standard_normal((L, p1, kvn, ps, d))
                          .astype(np.float32)).to(tdt)
    pv = torch.from_numpy(rng.standard_normal((L, p1, kvn, ps, d))
                          .astype(np.float32)).to(tdt)
    jk = jnp.asarray(pk.float().numpy()).astype(jdt)
    jv = jnp.asarray(pv.float().numpy()).astype(jdt)
    before_k, before_v = pk.clone(), pv.clone()

    q_j, jk, jv = jqkv.fused_qkv_append(
        xj, jnp.asarray(nw), jnp.asarray(wq), jnp.asarray(ws), sin_j, cos_j,
        jk, jv, jnp.int32(li), jnp.asarray(pos), n_heads=n, kv_heads=kvn,
        eps=1e-5, tables=jnp.asarray(tables), interpret=True)
    q_t, pk, pv = tqkv.fused_qkv_append(
        xt, torch.from_numpy(nw), torch.from_numpy(wq), torch.from_numpy(ws),
        torch.from_numpy(np.array(sin_j)),
        torch.from_numpy(np.array(cos_j)), pk, pv, li,
        torch.from_numpy(pos), n_heads=n, kv_heads=kvn, eps=1e-5,
        tables=torch.from_numpy(tables))
    assert q_t.shape == (b, n, d) and q_t.dtype == torch.bfloat16
    want_q = f32(q_j)
    sd = float(np.std(want_q))
    np.testing.assert_allclose(q_t.float().numpy(), want_q, rtol=0,
                               atol=REL * sd)

    written = np.zeros((L, p1, kvn, ps, d), bool)
    for r in range(b):
        page = tables[r, pos[r] // ps]
        written[li, page if page >= 0 else p1 - 1, :, pos[r] % ps] = True
    assert written[li, p1 - 1].any()             # the trash page took row 2
    for t, j, before in ((pk, jk, before_k), (pv, jv, before_v)):
        got, want = t.float().numpy(), f32(j)
        np.testing.assert_array_equal(got[~written], want[~written])
        np.testing.assert_array_equal(got[~written],
                                      before.float().numpy()[~written])
        np.testing.assert_allclose(got[written], want[written], rtol=0,
                                   atol=REL * float(np.std(want[written])))


@pytest.mark.parametrize("m", [3, 8])
def test_fused_ffn_matches_jax_kernel(m):
    rng = np.random.default_rng(m)
    L, h, inter, li = 2, 128, 256, 1
    q1 = rng.integers(-127, 128, (L, h, 2 * inter)).astype(np.int8)
    s1 = (rng.uniform(0.5, 2.0, (L, 1, 2 * inter)) * 1e-2).astype(np.float32)
    q2 = rng.integers(-127, 128, (L, inter, h)).astype(np.int8)
    s2 = (rng.uniform(0.5, 2.0, (L, 1, h)) * 1e-2).astype(np.float32)
    nw = (rng.standard_normal((L, h)) * 0.1 + 1.0).astype(np.float32)
    xt, xj = bf16_pair(rng.standard_normal((m, h)))
    want = f32(jffn.fused_ffn(xj, jnp.asarray(nw), jnp.asarray(q1),
                              jnp.asarray(s1), jnp.asarray(q2),
                              jnp.asarray(s2), jnp.int32(li), eps=1e-5,
                              interpret=True))
    got = tffn.fused_ffn(xt, torch.from_numpy(nw), torch.from_numpy(q1),
                         torch.from_numpy(s1), torch.from_numpy(q2),
                         torch.from_numpy(s2), li, eps=1e-5)
    assert got.shape == (m, h) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=REL * float(np.std(want)))


def _qkv_case(lib, b, s, scales_rows=1, bias=False, bits=8, n=8, kv=8):
    """The availability cases of tests/test_qkv_fused.py:68-84, built for
    one package (``lib`` "jax" or "torch")."""
    nq = (8 + 16) * 64
    if lib == "jax":
        cfg = JaxModelConfig(vocab_size=256, hidden_size=512,
                             intermediate_size=1024, num_layers=2,
                             num_heads=8, num_kv_heads=8, head_dim=64,
                             max_seq_len=64, dtype="float32")
        w = JaxQW(q=jnp.zeros((2, 512, nq), jnp.int8),
                  scales=jnp.zeros((2, scales_rows, nq), jnp.float32),
                  bits=bits)
        ck = jnp.zeros((2, 4, 8, 64, 64), jnp.float32)
        avail = jqkv.fused_qkv_available
    else:
        cfg = ModelConfig(vocab_size=256, hidden_size=512,
                          intermediate_size=1024, num_layers=2, num_heads=8,
                          num_kv_heads=8, head_dim=64, max_seq_len=64,
                          dtype="float32")
        w = TQW(q=torch.zeros((2, 512, nq), dtype=torch.int8),
                scales=torch.zeros((2, scales_rows, nq)), bits=bits)
        ck = torch.zeros((2, 4, 8, 64, 64))
        avail = tqkv.fused_qkv_available
    lw = {"wqkv": w}
    if bias:
        lw["wqkv_bias"] = 1
    return avail(lw, cfg, b, s, ck, n_heads=n, kv_heads=kv)


@pytest.mark.parametrize("case", [
    dict(b=4, s=1), dict(b=4, s=2), dict(b=4, s=1, bias=True),
    dict(b=64, s=1), dict(b=65, s=1), dict(b=4, s=1, scales_rows=4),
    dict(b=4, s=1, n=4, kv=8)])
def test_fused_qkv_available_matches_jax(case):
    assert (_qkv_case("torch", **case) == _qkv_case("jax", **case))


def _ffn_case(lib, m, scales_rows=1):
    """The availability cases of tests/test_ffn_fused.py:50-66."""
    if lib == "jax":
        zi, zf, qw, avail = (lambda s: jnp.zeros(s, jnp.int8),
                             lambda s: jnp.zeros(s, jnp.float32), JaxQW,
                             jffn.fused_ffn_available)
    else:
        zi, zf, qw, avail = (lambda s: torch.zeros(s, dtype=torch.int8),
                             torch.zeros, TQW, tffn.fused_ffn_available)
    lw = {"w_gate_up": qw(q=zi((2, 512, 2816)),
                          scales=zf((2, scales_rows, 2816))),
          "w_down": qw(q=zi((2, 1408, 512)), scales=zf((2, 1, 512)))}
    return avail(lw, 512, 1408, m)


@pytest.mark.parametrize("m,scales_rows", [(8, 1), (64, 1), (65, 1),
                                           (512, 1), (8, 4)])
def test_fused_ffn_available_matches_jax(m, scales_rows):
    assert _ffn_case("torch", m, scales_rows) == _ffn_case("jax", m,
                                                           scales_rows)


def test_fused_qkv_append_unported_forms_raise():
    x = torch.zeros(2, 128)
    pools = torch.zeros(2, 5, 2, 16, 32)
    base = dict(x=x, norm_w=torch.ones(2, 128),
                wq=torch.zeros(2, 128, 256, dtype=torch.int8),
                ws=torch.ones(2, 1, 256), sin=torch.zeros(2, 16),
                cos=torch.ones(2, 16), pool_k=pools, pool_v=pools.clone(),
                layer=1, offsets=torch.zeros(2, dtype=torch.int32))
    tables = torch.zeros(2, 2, dtype=torch.int32)
    # the dense-arena form is ported; its quantizing form stays paged-only
    with pytest.raises(NotImplementedError, match="dense KV arena"):
        tqkv.fused_qkv_append(**base, cache_ks=pools[..., 0],
                              cache_vs=pools[..., 0])
    with pytest.raises(NotImplementedError, match="INT8 KV"):
        tqkv.fused_qkv_append(**base, tables=tables, cache_ks=pools[..., 0])
    with pytest.raises(NotImplementedError, match="kv_layer"):
        tqkv.fused_qkv_append(**base, kv_layer=0)     # the dense arena
