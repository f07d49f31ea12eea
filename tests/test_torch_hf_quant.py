"""AWQ / GPTQ 4-bit import in the port against the JAX package on the CPU.

The unpackers give JAX's arrays on the same packed tensors (packed here
by independent test-side packers); GPTQ act-order is rejected;
``quantized_params_from_fetcher`` over an in-memory dict fetcher of a
random tiny Llama gives, leaf for leaf and byte for byte, what JAX's
gives once carried over by ``params_from_jax`` (INT4 codes, scales and
zero points); and the Engine and the Generator over those params give
JAX's greedy tokens.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.core.config import EngineConfig as JaxEngineConfig
from simplellminference_tpu.core.config import KVCacheConfig as JaxKVConfig
from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.core.config import SamplingParams as JaxSampling
from simplellminference_tpu.engine import Engine as JaxEngine
from simplellminference_tpu.runtime import hf_quant as jhq
from simplellminference_tpu.runtime.generator import Generator as JaxGenerator
from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                      KVCacheConfig,
                                                      ModelConfig,
                                                      SamplingParams)
from simplellminference_tpu_torch.engine import Engine
from simplellminference_tpu_torch.models.convert import params_from_jax
from simplellminference_tpu_torch.ops import ref_ops as tref
from simplellminference_tpu_torch.ops.linear import QuantizedWeight
from simplellminference_tpu_torch.runtime import hf_quant as thq
from simplellminference_tpu_torch.runtime.generator import Generator
from simplellminference_tpu_torch.runtime.weights import llama_hf_param_map

AWQ_ORDER = [0, 2, 4, 6, 1, 3, 5, 7]
PROMPTS = [[5, 9, 2, 44, 17, 3, 8, 120, 7, 7, 1], [33, 4, 250],
           [60, 61, 62, 63, 64, 65, 66, 67, 68]]


def awq_pack(u4: np.ndarray) -> np.ndarray:
    """[.., A*8] uint4 values -> int32 [.., A], AWQ interleaved order."""
    *lead, n = u4.shape
    r = u4.reshape(*lead, n // 8, 8).astype(np.uint32)
    out = np.zeros((*lead, n // 8), np.uint32)
    for j, o in enumerate(AWQ_ORDER):
        out |= r[..., o] << np.uint32(4 * j)
    return out.view(np.int32)


def gptq_pack_k(u4: np.ndarray) -> np.ndarray:
    """[K, N] uint4 -> int32 [K/8, N], sequential order along K."""
    k, n = u4.shape
    r = u4.reshape(k // 8, 8, n).astype(np.uint32)
    out = np.zeros((k // 8, n), np.uint32)
    for j in range(8):
        out |= r[:, j, :] << np.uint32(4 * j)
    return out.view(np.int32)


def seq_pack_n(u4: np.ndarray) -> np.ndarray:
    """[G, N] uint4 -> int32 [G, N/8], sequential order along N."""
    g, n = u4.shape
    r = u4.reshape(g, n // 8, 8).astype(np.uint32)
    out = np.zeros((g, n // 8), np.uint32)
    for j in range(8):
        out |= r[..., j] << np.uint32(4 * j)
    return out.view(np.int32)


def asym_quantize(w: np.ndarray, gs: int):
    """Group-wise asymmetric uint4 quantization (the AWQ/GPTQ scheme):
    (q [K, N] in 0..15, z [G, N] in 0..15, s [G, N] f16)."""
    k, n = w.shape
    wg = w.reshape(k // gs, gs, n)
    wmin, wmax = wg.min(1), wg.max(1)
    s = np.maximum((wmax - wmin) / 15.0, 1e-6).astype(np.float16)
    sf = s.astype(np.float32)
    z = np.clip(np.round(-wmin / sf), 0, 15)
    q = np.clip(np.round(wg / sf[:, None]) + z[:, None], 0, 15)
    return q.reshape(k, n).astype(np.int64), z.astype(np.int64), s


def test_awq_unpack_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.integers(0, 16, (64, 48))
    z = rng.integers(0, 16, (2, 48))
    s = rng.random((2, 48)).astype(np.float16)
    qw, qz = awq_pack(q), awq_pack(z)
    got = thq.unpack_awq(qw, qz, s)
    want = jhq.unpack_awq(qw, qz, s)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], (q - 8).astype(np.int8))


def test_gptq_unpack_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.integers(0, 16, (64, 40))
    z = rng.integers(1, 16, (4, 40))
    s = rng.random((4, 40)).astype(np.float16)
    qw, qz = gptq_pack_k(q), seq_pack_n(z - 1)
    g_idx = np.arange(64, dtype=np.int32) // 16
    for gi in (None, g_idx):
        got = thq.unpack_gptq(qw, qz, s, gi)
        want = jhq.unpack_gptq(qw, qz, s, gi)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], (z - 8) * s.astype(np.float32))


def test_gptq_act_order_rejected():
    rng = np.random.default_rng(2)
    qw = gptq_pack_k(rng.integers(0, 16, (64, 8)))
    qz = seq_pack_n(rng.integers(0, 15, (4, 8)))
    s = np.ones((4, 8), np.float16)
    g_idx = rng.permutation(np.arange(64, dtype=np.int32) // 16)
    with pytest.raises(NotImplementedError, match="act-order"):
        thq.unpack_gptq(qw, qz, s, g_idx)


def test_pack_split_half_matches_jax_and_ref_ops():
    q = np.random.default_rng(3).integers(-8, 8, (64, 24)).astype(np.int8)
    got = thq.pack_split_half(q)
    np.testing.assert_array_equal(got, jhq.pack_split_half(q))
    np.testing.assert_array_equal(got, tref.pack_int4(
        torch.from_numpy(q)).numpy())
    np.testing.assert_array_equal(tref.unpack_int4(
        torch.from_numpy(got)).numpy(), q)


def test_read_quantization_config(tmp_path):
    assert thq.read_quantization_config(str(tmp_path)) is None
    qc = dict(quant_method="awq", bits=4, group_size=32, version="gemm")
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": "llama", "quantization_config": qc}))
    assert thq.read_quantization_config(str(tmp_path)) == qc == \
        jhq.read_quantization_config(str(tmp_path))


@pytest.mark.parametrize("override,family", [
    (dict(num_experts=4), "mixture-of-experts"),
    (dict(attention_bias=True), "QKV biases"),
    (dict(model_type="phi3"), "Phi-3"),
    (dict(pre_norms=False), "post-norm"),
])
def test_param_map_refuses_other_families(override, family):
    with pytest.raises(NotImplementedError, match=family):
        llama_hf_param_map(ModelConfig.tiny_test(**override))


# ------------------------------------------- a tiny Llama as a checkpoint

def checkpoint(method: str, gs: int = 32, quant_head: bool = False):
    """Tensors of a random ``ModelConfig.tiny_test()`` Llama in AWQ or GPTQ
    form, keyed by HF name, and its quantization_config."""
    rng = np.random.default_rng({"awq": 10, "gptq": 11}[method])
    cfg = ModelConfig.tiny_test()
    h, inter, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    tensors = {}

    def plain(name, shape, scale=0.05, base=0.0):
        tensors[name] = (base + rng.standard_normal(shape) * scale).astype(
            np.float32)

    def quantized(name, k, n):
        w = (rng.standard_normal((k, n)) * k ** -0.5 + 0.01).astype(
            np.float32)
        q, z, s = asym_quantize(w, gs)
        if method == "awq":
            tensors[name + ".qweight"] = awq_pack(q)
            tensors[name + ".qzeros"] = awq_pack(z)
        else:
            tensors[name + ".qweight"] = gptq_pack_k(q)
            tensors[name + ".qzeros"] = seq_pack_n(z - 1)
            tensors[name + ".g_idx"] = np.arange(k, dtype=np.int32) // gs
        tensors[name + ".scales"] = s

    plain("model.embed_tokens.weight", (v, h))
    plain("model.norm.weight", (h,), 0.1, 1.0)
    if quant_head:
        quantized("lm_head", h, v)
    else:
        plain("lm_head.weight", (v, h))
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        plain(p + "input_layernorm.weight", (h,), 0.1, 1.0)
        plain(p + "post_attention_layernorm.weight", (h,), 0.1, 1.0)
        for nm, n in (("q", nd), ("k", kvd), ("v", kvd)):
            quantized(p + f"self_attn.{nm}_proj", h, n)
        quantized(p + "self_attn.o_proj", nd, h)
        for nm in ("gate", "up"):
            quantized(p + f"mlp.{nm}_proj", h, inter)
        quantized(p + "mlp.down_proj", inter, h)

    def fetch(name):
        return tensors[name]                     # KeyError when absent
    qcfg = dict(quant_method=method, bits=4, group_size=gs)
    return fetch, qcfg


def _both(method, quant_head=False):
    fetch, qcfg = checkpoint(method, quant_head=quant_head)
    jcfg = JaxModelConfig.tiny_test()
    jp = jhq.quantized_params_from_fetcher(jcfg, fetch, qcfg)
    tp = thq.quantized_params_from_fetcher(ModelConfig.tiny_test(), fetch,
                                           qcfg, device="cpu")
    return jcfg, jp, ModelConfig.tiny_test(), tp


@pytest.fixture(scope="module", params=["awq", "gptq"])
def models(request):
    return _both(request.param)


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", v


@pytest.mark.parametrize("quant_head", [False, True],
                         ids=["plain-head", "int4-head"])
def test_fetcher_params_equal_jax_carried_over(quant_head):
    for method in ("awq", "gptq"):
        _jcfg, jp, _cfg, tp = _both(method, quant_head)
        carried = params_from_jax(jax.tree.map(np.asarray, jp),
                                  device="cpu")
        got, want = dict(_leaves(tp)), dict(_leaves(carried))
        assert got.keys() == want.keys()
        for path, w in want.items():
            g = got[path]
            if isinstance(w, QuantizedWeight):
                assert isinstance(g, QuantizedWeight) and g.bits == 4
                assert g.zs is not None and g.shape == w.shape
                for a in ("q", "scales", "zs"):
                    assert getattr(g, a).dtype == getattr(w, a).dtype
                    assert torch.equal(getattr(g, a), getattr(w, a)), path
            else:
                assert g.dtype == w.dtype and torch.equal(g, w), path
        assert isinstance(tp["lm_head"], QuantizedWeight) == quant_head


def test_engine_over_fetched_params_matches_jax(models):
    jcfg, jp, cfg, tp = models
    kv = dict(page_size=8, num_pages=48, max_pages_per_seq=8, kv_dtype="f32")
    je = JaxEngine(jcfg, jp, JaxEngineConfig(
        max_batch_size=3, kv=JaxKVConfig(**kv)), decode_burst=4)
    te = Engine(cfg, tp, EngineConfig(max_batch_size=3,
                                      kv=KVCacheConfig(**kv)),
                decode_burst=4, device="cpu")
    want = je.generate(PROMPTS, JaxSampling(max_new_tokens=9))
    got = te.generate(PROMPTS, SamplingParams(max_new_tokens=9))
    assert got == want


def test_generator_over_fetched_params_matches_jax(models):
    jcfg, jp, cfg, tp = models
    jg = JaxGenerator(jcfg, jp, max_batch=4, max_seq=128)
    tg = Generator(cfg, tp, max_batch=4, max_seq=128, device="cpu")
    want = jg.generate(PROMPTS, JaxSampling(max_new_tokens=8))
    got = tg.generate(PROMPTS, SamplingParams(max_new_tokens=8))
    assert got.token_ids == want.token_ids
