"""INT4 weights in the port against the JAX package on the CPU.

The split-half packing, its quantizer and unpacker are byte-equal to the
JAX package's ``ref_ops`` (stacked, groups of 32, 64 and K). The port's
``quantized_matmul(bits=4)``, with and without zero points, runs its
plain version on the CPU and agrees with JAX's
``quantized_matmul_int4_ref`` within 1e-5 in f32 (the same math; XLA and
PyTorch sum in other orders), and with the JAX Pallas kernel in interpret
mode within 1e-5 of the output's largest magnitude with bf16 activations
(the products of bf16 values and int4 codes are exact in f32 on both
sides; only the order of the f32 sums differs). One JAX draw of
``ModelConfig.tiny_test()`` quantized to INT4 by the JAX package's
``quantize_params`` (per output channel and groups of 32, INT4 LM head)
and carried over by ``params_from_jax`` drives ``forward_paged`` (logits
within 1e-4), the Engine and the Generator (greedy tokens equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.core.config import EngineConfig as JaxEngineConfig
from simplellminference_tpu.core.config import KVCacheConfig as JaxKVConfig
from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.core.config import QuantConfig as JaxQuantConfig
from simplellminference_tpu.core.config import SamplingParams as JaxSampling
from simplellminference_tpu.engine import Engine as JaxEngine
from simplellminference_tpu.memory.paged_kv import PagedKVCache as JaxCache
from simplellminference_tpu.models import llama as jllama
from simplellminference_tpu.ops import linear as jlinear
from simplellminference_tpu.ops import matmul as jmm
from simplellminference_tpu.ops import ref_ops as jref
from simplellminference_tpu.runtime.generator import Generator as JaxGenerator
from simplellminference_tpu.runtime.weights import (
    quantize_params as jquantize_params)
from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                      KVCacheConfig,
                                                      ModelConfig,
                                                      QuantConfig,
                                                      SamplingParams)
from simplellminference_tpu_torch.engine import Engine
from simplellminference_tpu_torch.memory.paged_kv import PagedKVCache
from simplellminference_tpu_torch.models import llama as tllama
from simplellminference_tpu_torch.models.convert import params_from_jax
from simplellminference_tpu_torch.ops import linear as tlinear
from simplellminference_tpu_torch.ops import matmul as tmm
from simplellminference_tpu_torch.ops import ref_ops as tref
from simplellminference_tpu_torch.runtime.generator import Generator
from simplellminference_tpu_torch.runtime.weights import quantize_params

PS, MP, PAGES = 8, 4, 12
PROMPTS = [[5, 9, 2, 44, 17, 3, 8, 120, 7, 7, 1], [33, 4, 250],
           [60, 61, 62, 63, 64, 65, 66, 67, 68]]
TABLES = np.asarray([[2, 9, 4, 11], [0, 5, -1, -1], [7, 1, 3, -1]],
                    np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("gs", [32, 64, 128], ids=["g32", "g64", "gK"])
def test_quantize_pack_unpack_match_jax(gs):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((2, 128, 48)).astype(np.float32)
    jq, js = jref.quantize_int4_groupwise(jnp.asarray(w), gs)
    tq, ts = tref.quantize_int4_groupwise(_t(w), gs)
    assert tq.dtype == torch.int8 and tuple(tq.shape) == (2, 64, 48)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tref.unpack_int4(tq).numpy(),
                                  np.asarray(jref.unpack_int4(jq)))
    assert torch.equal(tref.pack_int4(tref.unpack_int4(tq)), tq)
    zs = rng.standard_normal(np.asarray(js).shape).astype(np.float32)
    for z in (None, zs):
        np.testing.assert_array_equal(
            tref.dequantize_int4_groupwise(
                tq, ts, zs=None if z is None else _t(z)).numpy(),
            np.asarray(jref.dequantize_int4_groupwise(
                jq, js, zs=None if z is None else jnp.asarray(z))))


def test_unpack_sign_extends_every_byte():
    # every byte value, so both nibbles reach -8 and 7
    b = np.arange(-128, 128, dtype=np.int8).reshape(2, 128)
    got = tref.unpack_int4(_t(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.unpack_int4(
        jnp.asarray(b))))
    assert got.min() == -8 and got.max() == 7


def test_quantize_rejects_groups_across_the_halves():
    with pytest.raises(ValueError, match="split-half"):
        tref.quantize_int4_groupwise(torch.zeros(96, 8), 64)


@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "stacked"])
@pytest.mark.parametrize("with_zs", [False, True], ids=["sym", "zs"])
@pytest.mark.parametrize("gs", [16, 64, 128], ids=["g16", "g64", "gK"])
def test_quantized_matmul_int4_matches_jax_ref(gs, with_zs, stacked):
    rng = np.random.default_rng(gs + 2 * with_zs)
    k, n = 128, 40
    w = (rng.standard_normal((2, k, n)) * k ** -0.5).astype(np.float32)
    x = rng.standard_normal((3, 2, k)).astype(np.float32)
    q, s = (np.asarray(a) for a in jref.quantize_int4_groupwise(
        jnp.asarray(w), gs))
    zs = ((rng.integers(0, 16, s.shape) - 8) * s).astype(np.float32)
    zs = zs if with_zs else None
    layer = 1 if stacked else None

    def pick(a):
        return a if a is None or stacked else a[1]
    want = jref.quantized_matmul_int4_ref(
        jnp.asarray(x), jnp.asarray(q[1]), jnp.asarray(s[1]),
        out_dtype=jnp.float32, zs=None if zs is None else jnp.asarray(zs[1]))
    got = tmm.quantized_matmul(
        _t(x), _t(pick(q)), _t(pick(s)), out_dtype=torch.float32,
        layer=layer, bits=4, zs=None if zs is None else _t(pick(zs)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the port's copy of the reference math itself
    np.testing.assert_allclose(tref.quantized_matmul_int4_ref(
        _t(x), _t(q[1]), _t(s[1]), out_dtype=torch.float32,
        zs=None if zs is None else _t(zs[1])).numpy(), np.asarray(want),
        rtol=1e-5, atol=1e-5)
    # and through linear, both packages' QuantizedWeight
    jw = jlinear.QuantizedWeight(
        q=jnp.asarray(pick(q)), scales=jnp.asarray(pick(s)), bits=4,
        zs=None if zs is None else jnp.asarray(pick(zs)))
    tw = tlinear.QuantizedWeight(q=_t(pick(q)), scales=_t(pick(s)), bits=4,
                                 zs=None if zs is None else _t(pick(zs)))
    jy = jlinear.linear(jnp.asarray(x), jw,
                        layer=None if layer is None else jnp.int32(layer))
    ty = tlinear.linear(_t(x), tw, layer=layer)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("with_zs", [False, True], ids=["sym", "zs"])
@pytest.mark.parametrize("gs", [128, 512], ids=["g128", "gK"])
def test_int4_matches_jax_kernel_interpret_bf16(gs, with_zs):
    # K/2 and N multiples of 128, so JAX runs its Pallas kernel (in
    # interpret mode), not its jnp fallback
    rng = np.random.default_rng(11)
    m, k, n = 8, 512, 256
    w = rng.standard_normal((k, n)).astype(np.float32) * k ** -0.5
    x = rng.standard_normal((m, k)).astype(np.float32)
    jq, js = jref.quantize_int4_groupwise(jnp.asarray(w), gs)
    zs = (rng.integers(0, 16, np.asarray(js).shape) - 8).astype(
        np.float32) * np.asarray(js) if with_zs else None
    jx = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jmm.quantized_matmul(
        jx, jq, js, out_dtype=jnp.float32, interpret=True, bits=4,
        zs=None if zs is None else jnp.asarray(zs)))
    fn = tmm.quantized_matmul_int4_zs if with_zs else tmm.quantized_matmul_int4
    args = (_t(np.asarray(jq)), _t(np.asarray(js)))
    if with_zs:
        args += (_t(zs),)
    got = fn(torch.from_numpy(x).to(torch.bfloat16), *args,
             out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_quantize_params_int4_matches_jax_with_the_group_fix():
    rng = np.random.default_rng(4)

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    tree = {"embed": w(50, 96),
            "layers": {"input_norm": np.ones((2, 96), np.float32),
                       "wqkv": w(2, 96, 64),      # K 96: groups 64 -> 16
                       "wo": w(2, 160, 96),       # K 160: 64 -> 32 -> 16
                       "w_gate_up": w(2, 128, 128),
                       "w_down": w(2, 64, 96)},   # K 64: one group of K
            "final_norm": np.ones((96,), np.float32),
            "lm_head": w(96, 50)}
    jt = jax.tree.map(jnp.asarray, tree)
    tt = params_from_jax(tree, device="cpu")
    for gs in (64, 0):
        jq = jquantize_params(jt, JaxQuantConfig(
            mode="int4", group_size=gs, quantize_lm_head=True))
        tq = quantize_params(tt, QuantConfig(mode="int4", group_size=gs,
                                             quantize_lm_head=True))
        for name in ("wqkv", "wo", "w_gate_up", "w_down", "lm_head"):
            jw = jq[name] if name == "lm_head" else jq["layers"][name]
            tw = tq[name] if name == "lm_head" else tq["layers"][name]
            assert tw.bits == 4 and tw.shape == tuple(jw.shape)
            assert tw.group_size == jw.group_size
            np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
            np.testing.assert_array_equal(tw.scales.numpy(),
                                          np.asarray(jw.scales))
        if gs:
            got = {k: tq["layers"][k].group_size
                   for k in ("wqkv", "wo", "w_gate_up", "w_down")}
            assert got == {"wqkv": 16, "wo": 16, "w_gate_up": 64,
                           "w_down": 64}
        assert torch.equal(tq["embed"], tt["embed"])


def test_quantized_weight_shape_is_logical_for_int4():
    w = torch.randn(3, 64, 24)
    tw = tlinear.QuantizedWeight.quantize(w, 32, bits=4)
    jw = jlinear.QuantizedWeight.quantize(jnp.asarray(w.numpy()), 32, bits=4)
    assert tuple(tw.q.shape) == (3, 32, 24) == jw.q.shape
    assert tw.shape == (3, 64, 24) == tuple(jw.shape)
    assert tw.group_size == 32 == jw.group_size
    np.testing.assert_array_equal(tw.dequantize().numpy(),
                                  np.asarray(jw.dequantize()))
    w8 = tlinear.QuantizedWeight.quantize(w, 32)
    assert w8.shape == (3, 64, 24) == tuple(w8.q.shape)


# ---------------------------------------------------------------- the model

def int4_model(group_size: int):
    jcfg = JaxModelConfig.tiny_test()
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    jp = jquantize_params(jp, JaxQuantConfig(mode="int4",
                                             group_size=group_size,
                                             quantize_lm_head=True))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, ModelConfig.tiny_test(), tp


@pytest.fixture(scope="module", params=[0, 32],
                ids=["per-channel", "group32"])
def model(request):
    return int4_model(request.param)


def test_params_from_jax_carries_int4_leaves(model):
    _jcfg, jp, _cfg, tp = model
    for name in ("wqkv", "wo", "w_gate_up", "w_down"):
        jw, tw = jp["layers"][name], tp["layers"][name]
        assert isinstance(tw, tlinear.QuantizedWeight) and tw.bits == 4
        assert tw.zs is None and tw.shape == tuple(jw.shape)
        np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
        np.testing.assert_array_equal(tw.scales.numpy(),
                                      np.asarray(jw.scales))
    assert tp["lm_head"].bits == 4


def test_forward_paged_int4_matches_jax(model, monkeypatch):
    jcfg, jp, cfg, tp = model
    calls = []
    orig = tmm.quantized_matmul_int4

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(tmm, "quantized_matmul_int4", spy)
    b, bucket = len(PROMPTS), 16
    toks = np.zeros((b, bucket), np.int32)
    for i, p in enumerate(PROMPTS):
        toks[i, :len(p)] = p
    lens = np.asarray([len(p) for p in PROMPTS], np.int32)
    pos0 = np.arange(bucket, dtype=np.int32)[None]
    jc = JaxCache.create(cfg.num_layers, PAGES, cfg.num_kv_heads, PS,
                         cfg.head_dim, jnp.float32)
    tc = PagedKVCache.create(cfg.num_layers, PAGES, cfg.num_kv_heads, PS,
                             cfg.head_dim, torch.float32, device="cpu")
    jl, jc = jllama.forward_paged(jcfg, jp, jnp.asarray(toks),
                                  jnp.asarray(pos0), jc, jnp.asarray(TABLES),
                                  jnp.asarray(lens), prefill=True,
                                  last_token_only=True)
    tl, tc = tllama.forward_paged(cfg, tp, _t(toks), _t(pos0), tc,
                                  _t(TABLES), _t(lens), prefill=True,
                                  last_token_only=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)
    pos = lens.copy()
    for _ in range(3):
        jl, jc = jllama.forward_paged(
            jcfg, jp, jnp.asarray(tok[:, None]), jnp.asarray(pos[:, None]),
            jc, jnp.asarray(TABLES), jnp.asarray(pos + 1), prefill=False)
        tl, tc = tllama.forward_paged(
            cfg, tp, _t(tok[:, None]), _t(pos[:, None]), tc, _t(TABLES),
            _t(pos + 1), prefill=False)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(tl.numpy()[:, 0].argmax(-1),
                                      np.asarray(jl)[:, 0].argmax(-1))
        tok = np.asarray(jnp.argmax(jl[:, 0], -1), np.int32)
        pos = pos + 1
    # no fused INT8 route: 4 products per layer and the head, every call
    assert len(calls) == 4 * (4 * cfg.num_layers + 1)


def test_engine_int4_greedy_matches_jax(model):
    jcfg, jp, cfg, tp = model
    kv = dict(page_size=8, num_pages=48, max_pages_per_seq=8, kv_dtype="f32")
    je = JaxEngine(jcfg, jp, JaxEngineConfig(
        max_batch_size=3, kv=JaxKVConfig(**kv), prefix_cache_entries=0),
        decode_burst=4)
    te = Engine(cfg, tp, EngineConfig(
        max_batch_size=3, kv=KVCacheConfig(**kv), prefix_cache_entries=0),
        decode_burst=4, device="cpu")
    want = je.generate(PROMPTS, JaxSampling(max_new_tokens=9))
    got = te.generate(PROMPTS, SamplingParams(max_new_tokens=9))
    assert got == want


def test_generator_int4_greedy_matches_jax(model):
    jcfg, jp, cfg, tp = model
    jg = JaxGenerator(jcfg, jp, max_batch=4, max_seq=128)
    tg = Generator(cfg, tp, max_batch=4, max_seq=128, device="cpu")
    want = jg.generate(PROMPTS, JaxSampling(max_new_tokens=10))
    got = tg.generate(PROMPTS, SamplingParams(max_new_tokens=10))
    assert got.token_ids == want.token_ids
    assert tg.generate_fused(PROMPTS, 10).tolist() == got.token_ids
