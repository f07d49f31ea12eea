"""Gemma (head_dim 256, GeGLU, embedding scale, MQA) through the PyTorch
port against the JAX package on the CPU.

The same numpy inputs (float32, from seeded generators) go through each
JAX function and its counterpart in the port; the JAX Pallas kernels run
in interpret mode, as the JAX package's own tests run them on the CPU.
Stated tolerances: ``glu_act`` and the attention modules at D 256 within
1e-5 (sums in another order); pool writes byte-exact; the embedding scale
in bf16 exact (both round sqrt(H) to bf16 first); the fused qkv append
(which rounds its normalized rows to bf16 on both sides) at
tests/test_torch_fused.py's 2e-2 of the standard deviation end to end,
and its f32 k/v within 1e-5 of the largest magnitude of the JAX
package's plain product on the same bf16 intermediates; a tiny Gemma
(transformers.GemmaConfig, 2 layers, 4 heads over 1 kv head, D 256,
through JAX's ``params_from_torch_state_dict``, which folds Gemma's +1
into the norm weights, then the port's ``params_from_jax``): Engine
greedy tokens exact and logprobs within 1e-4 with f32 and INT8 weights
and with the prefix cache, the Generator's greedy tokens exact. The
kernel forms outside the Gemma slice (INT8-KV, e4m3, verify, window)
raise NotImplementedError at D 256 on the CPU as on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

import test_torch_prefill_tiles as tiles
from simplellminference_tpu.core.config import EngineConfig as JaxEngineConfig
from simplellminference_tpu.core.config import KVCacheConfig as JaxKVConfig
from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.core.config import QuantConfig as JaxQuantConfig
from simplellminference_tpu.core.config import SamplingParams as JaxSampling
from simplellminference_tpu.engine import Engine as JaxEngine
from simplellminference_tpu.memory import paged_kv as jpkv
from simplellminference_tpu.models import llama as jllama
from simplellminference_tpu.ops import kv_append as jkva
from simplellminference_tpu.ops import qkv_fused as jqkv
from simplellminference_tpu.ops import ref_ops as jref
from simplellminference_tpu.ops.attention.flash_decode import (
    flash_decode as jflash_decode)
from simplellminference_tpu.ops.attention.flash_prefill import (
    flash_prefill as jflash_prefill)
from simplellminference_tpu.ops.attention.paged_decode import (
    paged_flash_decode as jpaged_decode)
from simplellminference_tpu.ops.attention.paged_prefill import (
    paged_flash_prefill as jpaged_prefill)
from simplellminference_tpu.runtime.generator import Generator as JaxGenerator
from simplellminference_tpu.runtime.weights import (
    params_from_torch_state_dict)
from simplellminference_tpu.runtime.weights import (
    quantize_params as jquantize_params)
from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                      KVCacheConfig,
                                                      ModelConfig,
                                                      SamplingParams)
from simplellminference_tpu_torch.engine import Engine
from simplellminference_tpu_torch.memory import paged_kv as tpkv
from simplellminference_tpu_torch.models import llama as tllama
from simplellminference_tpu_torch.models.convert import params_from_jax
from simplellminference_tpu_torch.ops import kv_append as tkva
from simplellminference_tpu_torch.ops import paged_append as tpa
from simplellminference_tpu_torch.ops import qkv_fused as tqkv
from simplellminference_tpu_torch.ops import ref_ops as tref
from simplellminference_tpu_torch.ops.attention import flash_decode as tfd
from simplellminference_tpu_torch.ops.attention import flash_prefill as tfp
from simplellminference_tpu_torch.ops.attention import paged_decode as tpd
from simplellminference_tpu_torch.ops.attention import paged_prefill as tpp
from simplellminference_tpu_torch.runtime.generator import Generator

TOL = 1e-5
D = 256


def t(a):
    return torch.from_numpy(np.array(a))


def j(a):
    return None if a is None else jnp.asarray(a)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------ GeGLU, scale

@pytest.mark.parametrize("act", ["gelu_pytorch_tanh", "gelu_tanh", "gelu",
                                 "silu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_glu_act_matches_jax(act, dtype):
    rng = np.random.default_rng(len(act))
    gate, up = rand(rng, 4, 96) * 3, rand(rng, 4, 96)
    tg, tu = t(gate).to(getattr(torch, dtype)), t(up).to(getattr(torch,
                                                                 dtype))
    got = tref.glu_act(tg, tu, act)
    want = jref.glu_act(jnp.asarray(tg.float().numpy()).astype(dtype),
                        jnp.asarray(tu.float().numpy()).astype(dtype), act)
    assert got.dtype == tg.dtype
    if dtype == "float32":
        close(got, want)
    else:
        # f32 math on both sides, one rounding to bf16: within one bf16
        # ulp of each output plus 1e-5 of the largest (the f32 GELUs part
        # by a few f32 ulps, which can straddle a rounding midpoint)
        g, w = got.float().numpy(), np.asarray(want, np.float32)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -100)))
                      - 7)
        assert (np.abs(g - w) <= ulp + TOL * np.abs(w).max()).all()


def test_glu_act_refuses_what_jax_refuses():
    x = torch.ones(2, 4)
    with pytest.raises(ValueError, match="unknown activation"):
        tref.glu_act(x, x, "relu")
    with pytest.raises(ValueError):
        jref.glu_act(jnp.ones((2, 4)), jnp.ones((2, 4)), "relu")
    # GPT-OSS's clamped SwiGLU runs (tests/test_torch_moe.py holds it at
    # the clamps), as in JAX
    g = torch.linspace(-9, 9, 8)[None].repeat(2, 1)
    np.testing.assert_allclose(
        tref.glu_act(g, g.flip(-1), "swiglu_oss").numpy(),
        np.asarray(jref.glu_act(jnp.asarray(g.numpy()),
                                jnp.asarray(g.flip(-1).numpy()),
                                "swiglu_oss")), rtol=1e-6, atol=1e-6)


def test_embed_scale_rounds_to_bf16_as_jax():
    cfg = ModelConfig.gemma_2b(num_layers=1, vocab_size=64, hidden_size=64,
                               dtype="bfloat16")
    jcfg = JaxModelConfig.gemma_2b(num_layers=1, vocab_size=64,
                                   hidden_size=64, dtype="bfloat16")
    assert cfg.embed_scale == jcfg.embed_scale == 2048.0 ** 0.5
    rng = np.random.default_rng(0)
    table = t(rand(rng, 64, 64)).to(torch.bfloat16)
    tokens = np.asarray([[3, 9, 63, 0]], np.int32)
    pos = np.arange(4, dtype=np.int32)[None]
    x, _s, _c = tllama._embed(cfg, {"embed": table}, t(tokens), t(pos))
    jtab = jnp.asarray(table.float().numpy()).astype(jnp.bfloat16)
    want = jtab[jnp.asarray(tokens)] * jnp.asarray(jcfg.embed_scale,
                                                   jnp.bfloat16)
    assert float(jnp.asarray(jcfg.embed_scale, jnp.bfloat16)) == 45.25
    assert x.dtype == torch.bfloat16
    np.testing.assert_array_equal(x.float().numpy(),
                                  np.asarray(want, np.float32))
    # the f32 scale would move the rows: the rounding is what matches
    unrounded = (table[t(tokens).long()].float() * cfg.embed_scale).to(
        torch.bfloat16)
    assert not torch.equal(unrounded, x)


def test_check_supported_admits_gemma_and_refuses_the_rest():
    tllama.check_supported(ModelConfig.gemma_2b())
    # GPT-OSS's clamped SwiGLU runs since its slice (the dense FFN takes
    # it through glu_act, as in JAX)
    tllama.check_supported(ModelConfig.gemma_2b(hidden_act="swiglu_oss"))
    for kw, name in ((dict(rope_interleaved=True), "interleaved rotary"),
                     (dict(logit_scale=0.5), "logit_scale"),
                     (dict(residual_scale=0.5), "residual_scale"),
                     (dict(qk_norm=True), "q/k RMSNorm")):
        with pytest.raises(NotImplementedError, match=name):
            tllama.check_supported(ModelConfig.gemma_2b(**kw))


# ------------------------------------------------ the kernel modules at D 256

@pytest.mark.parametrize("lens", [[1, 8, 13, 32], [0, 30, 17]],
                         ids=["lens", "empty-row"])
def test_paged_decode_d256_matches_jax(lens):
    # 4 (and the plain version on the CPU): Gemma's MQA, 8 q heads over 1
    rng = np.random.default_rng(len(lens))
    b, n, kvn, ps, mp = len(lens), 8, 1, 8, 4
    pk, pv = rand(rng, 2, b * mp + 1, kvn, ps, D), rand(rng, 2, b * mp + 1,
                                                          kvn, ps, D)
    q = rand(rng, b, n, D)
    tables = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    for i, ln in enumerate(lens):
        tables[i, -(-ln // ps):] = -1
    kv = np.asarray(lens, np.int32)
    got = tpd.paged_flash_decode(t(q), t(pk), t(pv), t(tables), t(kv), 1)
    want = jpaged_decode(j(q), j(pk), j(pv), j(tables), j(kv),
                         interpret=True, layer=jnp.int32(1))
    close(got, want)


@pytest.mark.parametrize("s,n,kvn", [(20, 8, 1), (24, 4, 2)])
def test_flash_prefill_d256_matches_jax(s, n, kvn):
    rng = np.random.default_rng(s + n)
    q, k, v = rand(rng, 2, s, n, D), rand(rng, 2, s, kvn, D), rand(
        rng, 2, s, kvn, D)
    got = tfp.flash_prefill(t(q), t(k), t(v))
    want = jflash_prefill(j(q), j(k), j(v), causal=True, interpret=True)
    close(got, want)


def test_paged_prefill_d256_matches_jax():
    rng = np.random.default_rng(3)
    b, s, n, kvn, ps, mp = 2, 16, 8, 1, 8, 6
    pk, pv = rand(rng, 2, b * mp + 1, kvn, ps, D), rand(rng, 2, b * mp + 1,
                                                          kvn, ps, D)
    tables = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    offs = np.asarray([8, 24], np.int32)
    lens = np.asarray([8 + 16, 24 + 11], np.int32)
    q = rand(rng, b, s, n, D)
    got = tpp.paged_flash_prefill(t(q), t(pk), t(pv), t(tables), t(lens),
                                  t(offs), 1)
    want = jpaged_prefill(j(q), j(pk), j(pv), j(tables), j(lens), j(offs),
                          bq=16, interpret=True, layer=jnp.int32(1))
    live = lens - offs
    for i, nrow in enumerate(live):
        close(got[i, :nrow], np.asarray(want)[i, :nrow])


def test_flash_decode_d256_matches_jax():
    rng = np.random.default_rng(4)
    lens, n, kvn, smax = [1, 64, 0, 37], 8, 1, 64
    b = len(lens)
    q = rand(rng, b, n, D)
    ck, cv = rand(rng, 2, b + 1, kvn, smax, D), rand(rng, 2, b + 1, kvn,
                                                      smax, D)
    kv = np.asarray(lens, np.int32)
    want = jflash_decode(j(q), j(ck[:, :b]), j(cv[:, :b]), j(kv),
                         interpret=True, layer=jnp.int32(1))
    got = tfd.flash_decode(t(q), t(ck), t(cv), t(kv), layer=1)
    close(got, want)
    assert not got[2].any()


@pytest.mark.parametrize("splits", [1, 3])
def test_tensor_core_prefill_emulation_at_d256(splits):
    # kernels 3 and 8's arithmetic at D 256 (tests/test_torch_prefill_
    # tiles.py's emulation: 8 positions x 8 heads a 64-row tile, P split
    # hi + lo, the split merge) against the plain version and JAX's
    # kernel in interpret mode, and in bf16 within the one-ulp rule
    rng = np.random.default_rng(11 + splits)
    b, s, n, kvn, ps, mp = 2, 24, 8, 1, 8, 6
    assert tiles.pt.packing(n // kvn) == (8, 8, 1)
    pk, pv = rand(rng, 2, b * mp + 1, kvn, ps, D), rand(rng, 2, b * mp + 1,
                                                          kvn, ps, D)
    tables = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    offs, lens = np.asarray([8, 16], np.int32), np.asarray([32, 35],
                                                          np.int32)
    q = rand(rng, b, s, n, D)
    kk, vv, readable = tiles.paged_keys(t(pk), t(pv), t(tables), 1)
    got = tiles.emulate(t(q), kk, vv, readable, offs, lens, 0, splits,
                        "f32")
    live = list(lens - offs)
    tiles.close(got, tpp.paged_flash_prefill_ref(
        t(q), t(pk), t(pv), t(tables), t(lens), t(offs), 1), live)
    want = jpaged_prefill(j(q), j(pk), j(pv), j(tables), j(lens), j(offs),
                          bq=8, interpret=True, layer=jnp.int32(1))
    tiles.close(got, want, live)
    bf = torch.bfloat16
    qb, kb, vb = t(q).to(bf), t(pk).to(bf), t(pv).to(bf)
    kk, vv, readable = tiles.paged_keys(kb, vb, t(tables), 1)
    got = tiles.emulate(qb, kk, vv, readable, offs, lens, 0, splits,
                        "split")
    want = tpp.paged_flash_prefill_ref(qb, kb, vb, t(tables), t(lens),
                                       t(offs), 1)
    shares = [tiles.rule_share(got[i, :r], want[i, :r])
              for i, r in enumerate(live)]
    assert max(shares) <= 1.0


# ---------------------------------------------------- 6m's blocks at D 256

def _block_col(x, c, d):
    """csrc/qkv_slots.cuh block_col: the qkv column of block x's local
    column c (0 .. 127)."""
    if d < 256:
        return x * 128 + c
    return (x // 2) * 256 + (x % 2) * 64 + (c % 64) + (c // 64) * 128


def _pairs(d):
    """The tail's pairs of a block (qkv_slots.cuh pair_col and
    pair_partner): local (t1, t2) for p = 0 .. 63."""
    half = d // 2
    out = []
    for p in range(64):
        t1 = (p // half) * d + p % half if d < 256 else p
        out.append((t1, t1 + (half if d < 256 else 64)))
    return out


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_qkv_blocks_keep_every_rope_pair(d):
    nq = 20 * d                              # a multiple of 128 columns
    cols = sorted(_block_col(x, c, d) for x in range(nq // 128)
                  for c in range(128))
    assert cols == list(range(nq))            # every column once
    for x in range(nq // 128):
        pairs = _pairs(d)
        assert sorted(c for pr in pairs for c in pr) == list(range(128))
        for t1, t2 in pairs:
            g1, g2 = _block_col(x, t1, d), _block_col(x, t2, d)
            # (c, c + D/2) of one head, c in its first half
            assert g2 - g1 == d // 2 and g1 // d == g2 // d
            assert g1 % d < d // 2
        for p0 in range(0, 64, 4):            # float4 groups: one head,
            g = [_block_col(x, pairs[p0 + e][0], d) for e in range(4)]
            assert g == list(range(g[0], g[0] + 4)) and g[0] % 4 == 0


def test_qkv_regime_takes_gemma_2b_to_the_tensor_cores():
    cfg = ModelConfig.gemma_2b()
    nq = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    assert nq == 2560 and nq // tqkv.MMA_COLS <= tqkv.MMA_MAX_TILES
    assert tqkv.qkv_regime(8, cfg.hidden_size, nq, 256,
                           torch.bfloat16) == "mma"
    assert tqkv.qkv_regime(8, cfg.hidden_size, nq, 256,
                           torch.float32) == "fma"
    kch = tqkv.qkv_split(8, cfg.hidden_size, nq // tqkv.MMA_COLS)
    assert kch % tqkv.MMA_KT == 0 and kch <= cfg.hidden_size


@pytest.mark.parametrize("b", [3, 8])
def test_fused_qkv_append_d256_matches_jax(b):
    # INT8 wqkv over one kv head (Gemma's MQA); f32 pools, bf16 rows
    rng = np.random.default_rng(b)
    L, h, n, kvn, ps, mp, li, eps = 2, 128, 4, 1, 16, 3, 1, 1e-6
    nq = (n + 2 * kvn) * D
    p1 = b * mp + 1
    wq = rng.integers(-127, 128, (L, h, nq)).astype(np.int8)
    ws = (rng.uniform(0.5, 2.0, (L, 1, nq)) * 1e-2).astype(np.float32)
    nw = (rng.standard_normal((L, h)) * 0.1 + 1.0).astype(np.float32)
    xt = t(rand(rng, b, h)).to(torch.bfloat16)
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    pos = (5 + 9 * np.arange(b) % 40).astype(np.int32)
    tables = np.arange(b * mp, dtype=np.int32).reshape(b, mp)
    tables[-1, pos[-1] // ps] = -1            # the trash page
    sin_j, cos_j = jref.rope_tables(jnp.asarray(pos), D, 10000.0)
    pk, pv = rand(rng, L, p1, kvn, ps, D), rand(rng, L, p1, kvn, ps, D)
    q_j, jk, jv = jqkv.fused_qkv_append(
        xj, j(nw), j(wq), j(ws), sin_j, cos_j, j(pk), j(pv), jnp.int32(li),
        j(pos), n_heads=n, kv_heads=kvn, eps=eps, tables=j(tables),
        interpret=True)
    tk, tv = t(pk), t(pv)
    q_t, tk, tv = tqkv.fused_qkv_append(
        xt, t(nw), t(wq), t(ws), t(np.array(sin_j)), t(np.array(cos_j)), tk,
        tv, li, t(pos), n_heads=n, kv_heads=kvn, eps=eps, tables=t(tables))
    assert q_t.shape == (b, n, D) and q_t.dtype == torch.bfloat16
    want_q = np.asarray(q_j, np.float32)
    np.testing.assert_allclose(q_t.float().numpy(), want_q, rtol=0,
                               atol=2e-2 * float(np.std(want_q)))
    written = np.zeros(pk.shape, bool)
    for r in range(b):
        page = tables[r, pos[r] // ps]
        written[li, page if page >= 0 else p1 - 1, :, pos[r] % ps] = True
    for got, want, before in ((tk, jk, pk), (tv, jv, pv)):
        g, w = got.numpy(), np.asarray(want)
        np.testing.assert_array_equal(g[~written], before[~written])
        np.testing.assert_array_equal(g[~written], w[~written])
        np.testing.assert_allclose(g[written], w[written], rtol=0,
                                   atol=2e-2 * float(np.std(w[written])))
    # the f32 stages on the same bf16 intermediates: the port's k/v rows
    # against the JAX package's plain product, RoPE in f32
    xf = xt.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xn = (xf * inv * t(nw[li])).to(torch.bfloat16)
    jq = np.asarray(jref.quantized_matmul_ref(
        jnp.asarray(xn.float().numpy(), jnp.bfloat16), j(wq[li]),
        j(ws[li]), out_dtype=jnp.float32))
    half = D // 2
    s, c = np.asarray(sin_j)[:, None], np.asarray(cos_j)[:, None]
    k = jq[:, n * D:(n + kvn) * D].reshape(b, kvn, D)
    k = np.concatenate([k[..., :half] * c - k[..., half:] * s,
                        k[..., half:] * c + k[..., :half] * s], -1)
    v = jq[:, (n + kvn) * D:].reshape(b, kvn, D)
    for r in range(b):
        page = tables[r, pos[r] // ps]
        page = page if page >= 0 else p1 - 1
        for pool, want in ((tk, k[r]), (tv, v[r])):
            np.testing.assert_allclose(
                pool.numpy()[li, page, :, pos[r] % ps], want, rtol=0,
                atol=TOL * float(np.abs(want).max()))


# ---------------------------------------------------------- pool writes

def test_paged_writes_d256_byte_equal_to_jax():
    # kernels 1 and 2's plain versions (write_*_stacked) at D 256
    rng = np.random.default_rng(6)
    b, s, kvn, ps, mp = 3, 20, 1, 8, 4
    shape = (2, b * mp + 1, kvn, ps, D)
    pk, pv = rand(rng, *shape), rand(rng, *shape)
    tables = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    tables[2] = -1
    jk, jv = j(pk), j(pv)
    tk, tv = t(pk), t(pv)
    for layer in range(2):
        nk, nv = rand(rng, b, s, kvn, D), rand(rng, b, s, kvn, D)
        jk, jv, _, _ = jpkv.write_prefill_stacked(jk, jv, j(nk), j(nv),
                                                  j(tables), jnp.int32(layer))
        tpkv.write_prefill_stacked(tk, tv, t(nk), t(nv), t(tables), layer)
        pos = np.asarray([20, 31, 3], np.int32)
        dk, dv = rand(rng, b, kvn, D), rand(rng, b, kvn, D)
        jk, jv, _, _ = jpkv.write_decode_stacked(
            jk, jv, j(dk), j(dv), j(tables), j(pos), jnp.int32(layer))
        tpkv.write_decode_stacked(tk, tv, t(dk), t(dv), t(tables), t(pos),
                                  layer)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(got.numpy()[:, :-1],
                                      np.asarray(want)[:, :-1])


def test_kv_append_d256_byte_equal_to_jax(monkeypatch):
    # kernel 12's plain version at D 256 against JAX's kernel in
    # interpret mode (kv_append has no interpret argument of its own)
    monkeypatch.setattr(jkva.pl, "pallas_call",
                        functools.partial(jkva.pl.pallas_call,
                                          interpret=True))
    rng = np.random.default_rng(7)
    shape = (2, 3, 1, 32, D)
    ck, cv = rand(rng, *shape), rand(rng, *shape)
    for s, offs in ((8, [0, 8, 16]), (1, [3, 31, 9])):
        nk, nv = rand(rng, 3, s, 1, D), rand(rng, 3, s, 1, D)
        off = np.asarray(offs, np.int32)
        tk, tv = t(ck), t(cv)
        tkva.kv_append(tk, tv, t(nk), t(nv), 1, t(off))
        wk, wv = jkva.kv_append(j(ck), j(cv), j(nk), j(nv), jnp.int32(1),
                                j(off))
        for got, want in ((tk, wk), (tv, wv)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ tiny Gemma

def _gemma(quant):
    hf_cfg = transformers.GemmaConfig(
        vocab_size=256, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1,
        head_dim=D, max_position_embeddings=256, rms_norm_eps=1e-6,
        tie_word_embeddings=True, hidden_activation="gelu_pytorch_tanh",
        initializer_range=0.3)          # 0.02 greedy-decodes one token
    torch.manual_seed(5)
    hf = transformers.GemmaForCausalLM(hf_cfg).eval()
    jcfg = JaxModelConfig.from_hf_dict(hf_cfg.to_dict(), dtype="float32")
    jp = params_from_torch_state_dict(jcfg, hf.state_dict(),
                                      dtype="float32")
    if quant:
        jp = jquantize_params(jp, JaxQuantConfig(mode="int8", group_size=0))
    cfg = ModelConfig.from_hf_dict(hf_cfg.to_dict(), dtype="float32")
    assert (cfg.head_dim, cfg.num_kv_heads, cfg.hidden_act) == (
        D, 1, "gelu_pytorch_tanh") and cfg.embed_scale == 128 ** 0.5
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, cfg, tp


@pytest.fixture(scope="module", params=["f32", "int8"])
def gemma(request):
    return _gemma(request.param == "int8")


PROMPTS = [[2, 5, 9, 200, 17], [7, 7, 7], list(range(30, 49)), [101]]


def _engines(model, **ecfg):
    jcfg, jp, cfg, tp = model
    kv = dict(page_size=8, num_pages=64, max_pages_per_seq=12,
              kv_dtype="f32")
    je = JaxEngine(jcfg, jp, JaxEngineConfig(
        max_batch_size=4, kv=JaxKVConfig(**kv), **ecfg), decode_burst=4)
    te = Engine(cfg, tp, EngineConfig(max_batch_size=4,
                                      kv=KVCacheConfig(**kv), **ecfg),
                decode_burst=4, device="cpu")
    return je, te


def _serve(je, te, prompts, n):
    jr = [je.add_request(prompt_ids=p, sampling=JaxSampling(
        max_new_tokens=n)) for p in prompts]
    tr = [te.add_request(prompt_ids=p, sampling=SamplingParams(
        max_new_tokens=n)) for p in prompts]
    je.run()
    te.run()
    for a, b in zip(jr, tr):
        assert b.output_ids == a.output_ids, a.prompt_ids
        assert b.cached_len == a.cached_len
        np.testing.assert_allclose(b.output_logprobs, a.output_logprobs,
                                   rtol=1e-4, atol=1e-4)
    return [b.output_ids for b in tr]


def test_engine_matches_jax(gemma):
    out = _serve(*_engines(gemma, prefix_cache_entries=0), PROMPTS, 10)
    assert len({tok for o in out for tok in o}) > 4   # not one token


def test_engine_prefix_cache_matches_jax(gemma):
    # the server's default: prefix cache on, chunked prefill; waves
    # sharing a 24-token system prompt
    je, te = _engines(gemma, prefill_chunk=16)
    system = list(range(40, 64))
    _serve(je, te, [system + [1, 2, 3]], 6)
    _serve(je, te, [system + [9, 8, 7, 6], system + [5], [3, 4]], 6)
    assert te.metrics.prefix_cache_hits == je.metrics.prefix_cache_hits > 0


def test_generator_matches_jax(gemma):
    jcfg, jp, cfg, tp = gemma
    jg = JaxGenerator(jcfg, jp, max_batch=4, max_seq=64)
    tg = Generator(cfg, tp, max_batch=4, max_seq=64, device="cpu")
    want = jg.generate(PROMPTS, JaxSampling(max_new_tokens=8))
    got = tg.generate(PROMPTS, SamplingParams(max_new_tokens=8))
    assert got.token_ids == want.token_ids
    assert tg.generate_fused(PROMPTS, 8).tolist() == got.token_ids


# ------------------------------------------------- forms outside the slice

def test_forms_outside_the_slice_raise_at_d256():
    rng = np.random.default_rng(8)
    bf, e4 = torch.bfloat16, torch.float8_e4m3fn
    shape = (2, 7, 1, 8, D)
    pk, pv = t(rand(rng, *shape)), t(rand(rng, *shape))
    qk, ks = tpa.quantize_kv(pk)
    qv, vs = tpa.quantize_kv(pv)
    ek, ev = pk.to(e4), pv.to(e4)
    tables = t(np.asarray([[0, 1], [2, 3], [4, 5]], np.int32))
    kv, offs = t(np.asarray([5, 9, 2], np.int32)), torch.zeros(
        3, dtype=torch.int32)
    q1, q3 = t(rand(rng, 3, 8, D)), t(rand(rng, 3, 3, 8, D))
    nk = t(rand(rng, 3, 4, 1, D))
    x = t(rand(rng, 3, 64)).to(bf)
    wq = torch.zeros((2, 64, 10 * D), dtype=torch.int8)
    ws = torch.ones((2, 1, 10 * D))
    sin, cos = tref.rope_tables(kv, D, 10000.0)
    qkv = (x, torch.ones(2, 64), wq, ws, sin, cos)
    # the e4m3 forms run at D 256 since Gemma's FP8-KV slice (these calls
    # raised before it): 4e and 8e match JAX's kernels, 1e and 2e write
    # JAX's bytes, 6e writes finite codes (every form's values at D 256:
    # tests/test_torch_fp8kv_gemma.py)
    def j_e4(x):
        return jnp.asarray(x.view(torch.uint8).numpy()).view(
            jnp.float8_e4m3fn)

    jk, jv, jt = j_e4(ek), j_e4(ev), jnp.asarray(tables.numpy())
    jl, jo = jnp.asarray(kv.numpy()), jnp.asarray(offs.numpy())
    np.testing.assert_allclose(
        tpd.paged_flash_decode(q1, ek, ev, tables, kv, 0).numpy(),
        np.asarray(jpaged_decode(jnp.asarray(q1.numpy()), jk, jv, jt, jl,
                                 interpret=True, layer=jnp.int32(0))),
        rtol=1e-5, atol=1e-5)
    got = tpp.paged_flash_prefill(q3, ek, ev, tables, kv, offs, 0).numpy()
    want = np.asarray(jpaged_prefill(jnp.asarray(q3.numpy()), jk, jv, jt, jl,
                                     jo, bq=3, interpret=True,
                                     layer=jnp.int32(0)))
    for i, ln in enumerate(kv.tolist()):
        np.testing.assert_allclose(got[i, :min(3, ln)], want[i, :min(3, ln)],
                                   rtol=1e-5, atol=1e-5)
    assert bool(torch.isfinite(tpd.paged_flash_verify(q3, ek, ev, tables,
                                                      kv, 0)).all())
    pk1, pv1 = ek.clone(), ev.clone()
    tpa.paged_append_decode(pk1, pv1, nk[:, 0], nk[:, 0], tables, offs, 0)
    jw = jpkv.write_decode_stacked(jk, jv, jnp.asarray(nk[:, 0].numpy()),
                                   jnp.asarray(nk[:, 0].numpy()), jt, jo,
                                   jnp.int32(0))
    for a, b in zip((pk1, pv1), jw[:2]):
        np.testing.assert_array_equal(a.view(torch.uint8).numpy()[:, :-1],
                                      np.asarray(b).view(np.uint8)[:, :-1])
    pk2, pv2 = ek.clone(), ev.clone()
    tpa.paged_append_prefill(pk2, pv2, nk, nk, tables, 0)
    jw = jpkv.write_prefill_stacked(jk, jv, jnp.asarray(nk.numpy()),
                                    jnp.asarray(nk.numpy()), jt,
                                    jnp.int32(0))
    for a, b in zip((pk2, pv2), jw[:2]):
        np.testing.assert_array_equal(a.view(torch.uint8).numpy()[:, :-1],
                                      np.asarray(b).view(np.uint8)[:, :-1])
    pk3, pv3 = ek.clone(), ev.clone()
    tqkv.fused_qkv_append(*qkv, pk3, pv3, 0, offs, n_heads=8, kv_heads=1,
                          tables=tables)
    assert not torch.equal(pk3.view(torch.uint8), ek.view(torch.uint8))
    assert bool(torch.isfinite(pk3.float()).all())
    # the INT8-KV forms run at D 256 since Gemma's INT8-KV slice (their
    # values: tests/test_torch_int8kv_d256.py)
    runs = {
        "4q": lambda: tpd.paged_flash_decode(q1, qk, qv, tables, kv, 0,
                                             k_scale=ks, v_scale=vs),
        "4qw": lambda: tpd.paged_flash_decode(q1, qk, qv, tables, kv, 0,
                                              k_scale=ks, v_scale=vs,
                                              window=4),
        "4vq": lambda: tpd.paged_flash_verify(q3, qk, qv, tables, kv, 0,
                                              k_scale=ks, v_scale=vs),
        "4vqw": lambda: tpd.paged_flash_verify(q3, qk, qv, tables, kv, 0,
                                               k_scale=ks, v_scale=vs,
                                               window=4),
        "8q": lambda: tpp.paged_flash_prefill(q3, qk, qv, tables, kv, offs,
                                              0, k_scale=ks, v_scale=vs),
        "6q": lambda: tqkv.fused_qkv_append(
            *qkv, qk.clone(), qv.clone(), 0, offs, n_heads=8, kv_heads=1,
            tables=tables, cache_ks=ks.clone(), cache_vs=vs.clone())[0],
        "9": lambda: tpa.paged_append_decode_quant(
            qk.clone(), qv.clone(), ks.clone(), vs.clone(), nk[:, 0],
            nk[:, 0], tables, offs, 0)[0],
        "10": lambda: tpa.paged_append_prefill_quant(
            qk.clone(), qv.clone(), ks.clone(), vs.clone(), nk, nk, tables,
            0)[0],
    }
    for form, call in runs.items():
        assert bool(torch.isfinite(call().float()).all()), form
    # and the forms of the slice run at D 256 on the CPU, since Gemma-2's
    # slice the window forms 4w, 8w, 3w and 6k too, since its dense slice
    # the verify forms over pools of q's dtype (4v, 4vw)
    assert tpd.paged_flash_verify(q3, pk, pv, tables, kv, 0).shape == (
        3, 3, 8, D)
    assert tpd.paged_flash_verify(q3, pk, pv, tables, kv, 0,
                                  window=4).shape == (3, 3, 8, D)
    assert tpd.paged_flash_decode(q1, pk, pv, tables, kv, 0).shape == (
        3, 8, D)
    tqkv.fused_qkv_append(*qkv, pk, pv, 0, offs, n_heads=8, kv_heads=1,
                          tables=tables)
    assert tpd.paged_flash_decode(q1, pk, pv, tables, kv, 0,
                                  window=4).shape == (3, 8, D)
    assert tpp.paged_flash_prefill(q3, pk, pv, tables, kv, offs, 0,
                                   window=4).shape == (3, 3, 8, D)
    assert tfp.flash_prefill(q3, nk[:, :3], nk[:, :3],
                             window=4).shape == (3, 3, 8, D)
    tqkv.fused_qkv_append(*qkv, pk, pv, 1, offs, n_heads=8, kv_heads=1,
                          tables=tables, kv_layer=0)
