"""Plain ops of the PyTorch port against simplellminference_tpu.ops.

Inputs come from numpy with a fixed seed and go through the JAX function
and its port counterpart; float32 on the CPU, stated tolerance 1e-5
relative (the two frameworks reduce in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.ops import linear as jlinear
from simplellminference_tpu.ops import ref_ops as jref
from simplellminference_tpu_torch.core.config import ModelConfig
from simplellminference_tpu_torch.ops import linear as tlinear
from simplellminference_tpu_torch.ops import ref_ops as tref

RTOL, ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x, w = rand(rng, 2, 5, 64), rand(rng, 64)
    close(tref.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
          jref.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6))


def test_glu_act_silu():
    rng = np.random.default_rng(1)
    g, u = rand(rng, 3, 7, 48), rand(rng, 3, 7, 48)
    close(tref.glu_act(torch.from_numpy(g), torch.from_numpy(u)),
          jref.glu_act(jnp.asarray(g), jnp.asarray(u), "silu"))
    # GeGLU is ported (tests/test_torch_gemma.py), and so is GPT-OSS's
    # clamped SwiGLU (the MoE FFN; tests/test_torch_moe.py); an unknown
    # name raises as in JAX
    close(tref.glu_act(torch.from_numpy(g * 8), torch.from_numpy(u * 8),
                       "swiglu_oss"),
          jref.glu_act(jnp.asarray(g * 8), jnp.asarray(u * 8), "swiglu_oss"))
    with pytest.raises(ValueError):
        tref.glu_act(torch.from_numpy(g), torch.from_numpy(u), "relu")


@pytest.mark.parametrize("scaling", [
    None,
    {"rope_type": "linear", "factor": 4.0},
    {"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
], ids=["plain", "linear", "llama3"])
def test_rope_tables(scaling):
    pos = np.arange(0, 294, 7, dtype=np.int32).reshape(3, -1)
    s_t, c_t = tref.rope_tables(torch.from_numpy(pos), 64, 10000.0,
                                rope_scaling=scaling)
    s_j, c_j = jref.rope_tables(jnp.asarray(pos), 64, 10000.0,
                                rope_scaling=scaling)
    # sin/cos of angles up to ~300 rad: the two libm's differ by an ulp
    close(s_t, s_j, atol=2e-5)
    close(c_t, c_j, atol=2e-5)


def test_rope_tables_for_config():
    cfg_j = JaxModelConfig.tiny_test()
    cfg_t = ModelConfig.tiny_test()
    pos = np.arange(12, dtype=np.int32)[None]
    for a, b in zip(tref.rope_tables_for(cfg_t, torch.from_numpy(pos)),
                    jref.rope_tables_for(cfg_j, jnp.asarray(pos))):
        close(a, b)
    wins, nope = (None, None), (False, False)
    tabs = tref.rope_tables_by_sublayer(cfg_t, torch.from_numpy(pos), wins,
                                        nope)
    assert len(tabs) == 2
    with pytest.raises(NotImplementedError):
        tref.rope_tables_by_sublayer(cfg_t, torch.from_numpy(pos), wins,
                                     (True, False))


def test_apply_rope():
    rng = np.random.default_rng(2)
    x = rand(rng, 2, 6, 4, 32)
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    s, c = jref.rope_tables(jnp.asarray(pos), 32, 10000.0)
    close(tref.apply_rope(torch.from_numpy(x), torch.tensor(np.asarray(s)),
                          torch.tensor(np.asarray(c))),
          jref.apply_rope(jnp.asarray(x), s, c))


def test_repeat_kv():
    rng = np.random.default_rng(3)
    x = rand(rng, 2, 5, 2, 8)
    close(tref.repeat_kv(torch.from_numpy(x), 3),
          jref.repeat_kv(jnp.asarray(x), 3), rtol=0, atol=0)


@pytest.mark.parametrize("sq,sk,n,kvn,offset", [
    (7, 7, 4, 2, 0), (3, 11, 4, 4, 8), (1, 9, 8, 2, 8)])
def test_attention_masked(sq, sk, n, kvn, offset):
    rng = np.random.default_rng(4)
    q, k, v = rand(rng, 2, sq, n, 16), rand(rng, 2, sk, kvn, 16), rand(
        rng, 2, sk, kvn, 16)
    mask_t = tref.causal_mask(sq, sk, q_offset=offset)[None, None]
    mask_j = jref.causal_mask(sq, sk, q_offset=offset)[None, None]
    np.testing.assert_array_equal(np.asarray(mask_t), np.asarray(mask_j))
    close(tref.attention(*(torch.from_numpy(a) for a in (q, k, v)), mask_t,
                         scale=0.3),
          jref.attention(*(jnp.asarray(a) for a in (q, k, v)), mask_j,
                         scale=0.3))


def test_causal_mask_window():
    np.testing.assert_array_equal(
        np.asarray(tref.causal_mask(6, 9, q_offset=3, window=4)),
        np.asarray(jref.causal_mask(6, 9, q_offset=3, window=4)))


@pytest.mark.parametrize("stacked", [False, True])
def test_linear_plain(stacked):
    rng = np.random.default_rng(5)
    x = rand(rng, 2, 3, 32)
    w = rand(rng, 3, 32, 24) if stacked else rand(rng, 32, 24)
    layer = 2 if stacked else None
    close(tlinear.linear(torch.from_numpy(x), torch.from_numpy(w),
                         layer=layer),
          jlinear.linear(jnp.asarray(x), jnp.asarray(w),
                         layer=None if layer is None else jnp.int32(layer)))


def test_linear_rejects_quantized():
    # INT8, INT4 (with zero points) and W8A8 are served
    # (tests/test_torch_matmul.py, test_torch_int4.py, test_torch_w8a8.py);
    # other widths, zero points on 8-bit weights and other activation
    # quantizations are not (the last two where the JAX package asserts)
    w = tlinear.QuantizedWeight(q=torch.zeros(4, 4, dtype=torch.int8),
                                scales=torch.ones(1, 4))
    w3 = tlinear.QuantizedWeight(q=w.q, scales=w.scales, bits=3)
    with pytest.raises(NotImplementedError, match="INT4"):
        tlinear.linear(torch.zeros(1, 4), w3)
    wz = tlinear.QuantizedWeight(q=w.q, scales=w.scales, zs=w.scales)
    with pytest.raises(ValueError, match="zero points"):
        tlinear.linear(torch.zeros(1, 4), wz)
    with pytest.raises(ValueError, match="act_quant"):
        tlinear.linear(torch.zeros(1, 4), w, act_quant="fp8")


def test_linear_bf16_keeps_the_f32_accumulator():
    # bf16 operands with an f32 output: the exact products summed in f32,
    # as jnp.dot(..., preferred_element_type=float32). At the Llama-2-7B
    # LM-head width a bf16 result cast up is off by up to half a bf16 ulp
    # of the logits (~4e-3 here); f32 summation orders differ by ~1e-6.
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rand(rng, 8, 4096)).bfloat16()
    w = torch.from_numpy(rand(rng, 4096, 512) * 0.02).bfloat16()
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    wj = jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jlinear.linear(xj, wj, out_dtype=jnp.float32))
    for got in (tlinear.linear(x, w, out_dtype=torch.float32),
                tlinear.dot_f32(x, w)):
        assert got.dtype == torch.float32
        close(got.numpy(), want, rtol=0, atol=1e-4)
    # the smallest case: 1 + 2**-8 is a bf16 tie and rounds to 1.0
    one = torch.tensor([[1.0, 1.0]], dtype=torch.bfloat16)
    w2 = torch.tensor([[1.0], [2.0 ** -8]], dtype=torch.bfloat16)
    assert float(tlinear.linear(one, w2, out_dtype=torch.float32)) == \
        1.0 + 2.0 ** -8
