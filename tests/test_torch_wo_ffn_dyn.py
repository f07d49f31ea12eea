"""The last two TPU kernels' counterparts, fused_wo_ffn (16) and
flash_decode_dyn (17), against the JAX package on the CPU.

The port's wrappers run their plain versions on CPU tensors; the JAX
kernels run in interpret mode, as tests/test_ffn_fused.py and the JAX
package run them. fused_wo_ffn: the JAX test's shapes and draw (m 8, H
512, N*D 512, I 1408, bf16 activations); the TPU kernel rounds the wo
product, the residual, the normalized rows and the SwiGLU output to bf16
at the points the port rounds in the activation dtype, so stated
tolerance 8e-2 of the output's standard deviation, as
tests/test_ffn_fused.py:100-101 holds the kernel to its own reference.
flash_decode_dyn: f32, several kv_lens including 0 and Smax, stacked and
4-D caches, bk 128 and 256; stated tolerance 1e-5 (summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.ops import ffn_fused as jffn
from simplellminference_tpu.ops.attention.flash_decode_dyn import (
    flash_decode_dyn as jflash_decode_dyn)
from simplellminference_tpu.ops.linear import QuantizedWeight as JaxQW
from simplellminference_tpu_torch.ops import ffn_fused as tffn
from simplellminference_tpu_torch.ops.attention import flash_decode_dyn as tfd
from simplellminference_tpu_torch.ops.linear import QuantizedWeight as TQW

TOL = 1e-5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _wo_ffn_case(rng, L=2, h=512, nd=512, inter=1408, m=8):
    """The draw of tests/test_ffn_fused.py::test_fused_wo_ffn_matches_ref."""
    wq = rng.integers(-127, 128, (L, nd, h)).astype(np.int8)
    ws = (rng.uniform(0.5, 2.0, (L, 1, h)) * 1e-2).astype(np.float32)
    q1 = rng.integers(-127, 128, (L, h, 2 * inter)).astype(np.int8)
    s1 = (rng.uniform(0.5, 2.0, (L, 1, 2 * inter)) * 1e-2).astype(np.float32)
    q2 = rng.integers(-127, 128, (L, inter, h)).astype(np.int8)
    s2 = (rng.uniform(0.5, 2.0, (L, 1, h)) * 1e-2).astype(np.float32)
    nw = (rng.standard_normal((L, h)) * 0.1 + 1.0).astype(np.float32)
    attn = rng.standard_normal((m, nd)).astype(np.float32)
    x = rng.standard_normal((m, h)).astype(np.float32)
    return attn, x, wq, ws, nw, q1, s1, q2, s2


def test_fused_wo_ffn_matches_jax_kernel():
    rng = np.random.default_rng(0)
    attn, x, wq, ws, nw, q1, s1, q2, s2 = _wo_ffn_case(rng)
    li = 1
    at, xt = t(attn).bfloat16(), t(x).bfloat16()
    aj = jnp.asarray(at.float().numpy()).astype(jnp.bfloat16)
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jffn.fused_wo_ffn(
        aj, xj, jnp.asarray(wq), jnp.asarray(ws), jnp.asarray(nw),
        jnp.asarray(q1), jnp.asarray(s1), jnp.asarray(q2), jnp.asarray(s2),
        jnp.int32(li), eps=1e-5, interpret=True), np.float32)
    got = tffn.fused_wo_ffn(at, xt, t(wq), t(ws), t(nw), t(q1), t(s1),
                            t(q2), t(s2), li, eps=1e-5)
    assert got.shape == xt.shape and got.dtype == torch.bfloat16
    scale = float(np.std(want))
    np.testing.assert_allclose(got.float().numpy() / scale, want / scale,
                               rtol=0, atol=8e-2)


def test_fused_wo_ffn_plain_is_wo_then_fused_ffn():
    """f32: x + wo, then the plain FFN, exactly (no rounding in f32)."""
    rng = np.random.default_rng(1)
    attn, x, wq, ws, nw, q1, s1, q2, s2 = _wo_ffn_case(rng, h=256, nd=384,
                                                       inter=320, m=5)
    got = tffn.fused_wo_ffn(t(attn), t(x), t(wq), t(ws), t(nw), t(q1),
                            t(s1), t(q2), t(s2), 0)
    xres = t(x) + t(attn) @ t(wq[0]).float() * t(ws[0])
    want = tffn.fused_ffn(xres, t(nw), t(q1), t(s1), t(q2), t(s2), 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("m,wo_rows", [(8, 1), (64, 1), (65, 1), (8, 4)])
def test_fused_wo_ffn_available_matches_jax(m, wo_rows):
    L, h, nd, inter = 2, 512, 512, 1408
    gates = {}
    for kind, np_, qw in (("jax", jnp, JaxQW), ("torch", torch, TQW)):
        def z(shape, dt):
            return (jnp.zeros(shape, dt) if kind == "jax" else
                    torch.zeros(shape, dtype=dt))
        i8 = jnp.int8 if kind == "jax" else torch.int8
        f4 = jnp.float32 if kind == "jax" else torch.float32
        lw = {"wo": qw(q=z((L, nd, h), i8), scales=z((L, wo_rows, h), f4)),
              "w_gate_up": qw(q=z((L, h, 2 * inter), i8),
                              scales=z((L, 1, 2 * inter), f4)),
              "w_down": qw(q=z((L, inter, h), i8), scales=z((L, 1, h), f4))}
        mod = jffn if kind == "jax" else tffn
        gates[kind] = mod.fused_wo_ffn_available(lw, nd, h, inter, m)
    assert gates["torch"] == gates["jax"]


def _arena(rng, L, rows, kvn, smax, d):
    return (rng.standard_normal((L, rows, kvn, smax, d)).astype(np.float32),
            rng.standard_normal((L, rows, kvn, smax, d)).astype(np.float32))


@pytest.mark.parametrize("bk", [128, 256])
@pytest.mark.parametrize("lens", [[0, 256], [1, 129], [200, 37]],
                         ids=["zero-full", "one-past-tile", "ragged"])
def test_flash_decode_dyn_matches_jax_kernel(lens, bk):
    rng = np.random.default_rng(sum(lens) + bk)
    L, b, kvn, n, d, smax = 2, 2, 2, 4, 128, 256
    ck, cv = _arena(rng, L, b, kvn, smax, d)
    q = rng.standard_normal((b, n, d)).astype(np.float32)
    kv = np.asarray(lens, np.int32)
    got = tfd.flash_decode_dyn(t(q), t(ck), t(cv), t(kv), bk=bk, layer=1)
    want = np.asarray(jflash_decode_dyn(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(kv),
        bk=bk, interpret=True, layer=jnp.int32(1)))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    for i, ln in enumerate(lens):
        if ln == 0:
            assert not got[i].any()


def test_flash_decode_dyn_4d_cache_and_arena_rows_past_the_batch():
    """A 4-D cache is layer 0; an arena with more rows than sequences reads
    rows [0, B)."""
    rng = np.random.default_rng(7)
    kvn, n, d, smax = 1, 4, 128, 128
    ck, cv = _arena(rng, 1, 3, kvn, smax, d)
    q = rng.standard_normal((2, n, d)).astype(np.float32)
    kv = np.asarray([5, 128], np.int32)
    got = tfd.flash_decode_dyn(t(q), t(ck[0]), t(cv[0]), t(kv))
    want = np.asarray(jflash_decode_dyn(
        jnp.asarray(q), jnp.asarray(ck[0, :2]), jnp.asarray(cv[0, :2]),
        jnp.asarray(kv), interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_flash_decode_dyn_keeps_the_tpu_shape_rules():
    q = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="D % 128"):
        tfd.flash_decode_dyn(q, torch.zeros(1, 1, 128, 64),
                             torch.zeros(1, 1, 128, 64), torch.tensor([3]))
    q = torch.zeros(1, 2, 128)
    with pytest.raises(ValueError, match="multiple of bk"):
        tfd.flash_decode_dyn(q, torch.zeros(1, 1, 384, 128),
                             torch.zeros(1, 1, 384, 128), torch.tensor([3]),
                             bk=256)
    with pytest.raises(ValueError, match="layer index"):
        tfd.flash_decode_dyn(q, torch.zeros(2, 1, 1, 128, 128),
                             torch.zeros(2, 1, 1, 128, 128),
                             torch.tensor([3]))
