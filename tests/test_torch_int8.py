"""INT8 weights through the port's paged Llama forward and Engine, against
the JAX package on the CPU.

One JAX draw of ``ModelConfig.tiny_test()`` (2 layers, GQA) is quantized
by the JAX package's ``quantize_params`` (per output channel, or groups of
64; INT8 LM head) and carried to the port with ``params_from_jax``. In
f32 the JAX package runs its unfused CPU path and the port its fused
plain versions (``fused_qkv_append`` at decode, ``fused_ffn`` wherever
B*S <= 64): the same math in another summation order, so logits agree
within 1e-4 and greedy tokens are equal. In bf16 the JAX package's decode
runs its fused Pallas kernels in interpret mode (its test hook
``FORCE_FUSED_INTERPRET``); both round at the same points, and logits
agree within 2e-2 of their standard deviation (a bf16 ulp of the hidden
state, carried through two layers).
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
from simplellminference_tpu.ops import ffn_fused as jffn
from simplellminference_tpu.ops import qkv_fused as jqkv
from simplellminference_tpu.ops.linear import QuantizedWeight as JaxQW
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
from simplellminference_tpu_torch.ops import ffn_fused, qkv_fused
from simplellminference_tpu_torch.ops.linear import QuantizedWeight

PS, MP, PAGES = 8, 4, 12
PROMPTS = [[5, 9, 2, 44, 17, 3, 8, 120, 7, 7, 1], [33, 4, 250],
           [60, 61, 62, 63, 64, 65, 66, 67, 68]]
TABLES = np.asarray([[2, 9, 4, 11], [0, 5, -1, -1], [7, 1, 3, -1]],
                    np.int32)


def int8_model(group_size: int, dtype: str = "float32"):
    jcfg = JaxModelConfig.tiny_test(dtype=dtype)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    jp = jquantize_params(jp, JaxQuantConfig(mode="int8",
                                             group_size=group_size,
                                             quantize_lm_head=True))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu",
                         dtype=dtype)
    return jcfg, jp, ModelConfig.tiny_test(dtype=dtype), tp


@pytest.fixture(scope="module", params=[0, 64],
                ids=["per-channel", "group64"])
def model(request):
    return int8_model(request.param)


def trace_both(jcfg, jp, cfg, tp, steps: int, pool_dtype: str):
    """Greedy prefill + ``steps`` decode steps through both packages'
    forward_paged; yields (jax logits, port logits, jax cache, port
    cache) after each call."""
    b, bucket = len(PROMPTS), 16
    toks = np.zeros((b, bucket), np.int32)
    for i, p in enumerate(PROMPTS):
        toks[i, :len(p)] = p
    lens = np.asarray([len(p) for p in PROMPTS], np.int32)
    pos0 = np.arange(bucket, dtype=np.int32)[None]
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[pool_dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[pool_dtype]
    jc = JaxCache.create(cfg.num_layers, PAGES, cfg.num_kv_heads, PS,
                         cfg.head_dim, jdt)
    tc = PagedKVCache.create(cfg.num_layers, PAGES, cfg.num_kv_heads, PS,
                             cfg.head_dim, tdt, device="cpu")
    jl, jc = jllama.forward_paged(jcfg, jp, jnp.asarray(toks),
                                  jnp.asarray(pos0), jc, jnp.asarray(TABLES),
                                  jnp.asarray(lens), prefill=True,
                                  last_token_only=True)
    tl, tc = tllama.forward_paged(cfg, tp, torch.from_numpy(toks),
                                  torch.from_numpy(pos0), tc,
                                  torch.from_numpy(TABLES),
                                  torch.from_numpy(lens), prefill=True,
                                  last_token_only=True)
    yield np.asarray(jl, np.float32), tl.numpy(), jc, tc
    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
    pos = lens.copy()
    for _ in range(steps):
        jl, jc = jllama.forward_paged(
            jcfg, jp, jnp.asarray(tok[:, None]), jnp.asarray(pos[:, None]),
            jc, jnp.asarray(TABLES), jnp.asarray(pos + 1), prefill=False)
        tl, tc = tllama.forward_paged(
            cfg, tp, torch.from_numpy(tok[:, None]),
            torch.from_numpy(pos[:, None]), tc, torch.from_numpy(TABLES),
            torch.from_numpy(pos + 1), prefill=False)
        yield np.asarray(jl, np.float32), tl.numpy(), jc, tc
        tok = np.array(jnp.argmax(jl[:, 0], -1), np.int32)
        pos = pos + 1


def test_params_from_jax_carries_int8_leaves(model):
    _jcfg, jp, _cfg, tp = model
    for name in ("wqkv", "wo", "w_gate_up", "w_down"):
        jw, tw = jp["layers"][name], tp["layers"][name]
        assert isinstance(tw, QuantizedWeight) and tw.bits == 8
        assert tw.q.dtype == torch.int8 and tw.scales.dtype == torch.float32
        np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
        np.testing.assert_array_equal(tw.scales.numpy(),
                                      np.asarray(jw.scales))
    assert isinstance(tp["lm_head"], QuantizedWeight)


def test_params_from_jax_refuses_int4():
    # INT4 leaves are carried over (tests/test_torch_int4.py); one whose
    # scale groups do not fit the split-half packing is refused: K = 8,
    # groups of 8/3 rows, and K = 12 with groups of 4 (4 does not divide
    # K/2 = 6)
    w = JaxQW(q=np.zeros((4, 4), np.int8), scales=np.ones((3, 4), np.float32),
              bits=4)
    with pytest.raises(ValueError, match="do not group"):
        params_from_jax({"layers": {"wqkv": w}}, device="cpu")
    w = JaxQW(q=np.zeros((6, 4), np.int8), scales=np.ones((3, 4), np.float32),
              bits=4)
    with pytest.raises(ValueError, match="split-half"):
        params_from_jax({"layers": {"wqkv": w}}, device="cpu")


def test_forward_paged_int8_matches_jax_f32(model, monkeypatch):
    jcfg, jp, cfg, tp = model
    per_channel = tp["layers"]["wqkv"].scales.shape[-2] == 1
    calls = {"qkv": 0, "ffn": 0}
    for mod, fn, key in ((qkv_fused, "fused_qkv_append", "qkv"),
                         (ffn_fused, "fused_ffn", "ffn")):
        orig = getattr(mod, fn)

        def spy(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, fn, spy)
    for step, (jl, tl, jc, tc) in enumerate(
            trace_both(jcfg, jp, cfg, tp, steps=3, pool_dtype="f32")):
        assert tl.dtype == np.float32
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1),
                                      jl[:, -1].argmax(-1))
    for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(t.numpy()[:, :-1], np.asarray(j)[:, :-1],
                                   rtol=1e-4, atol=1e-4)
    # per-channel weights take the fused route: qkv at each of the 3
    # decode steps, the FFN at every call (B*S = 48 <= 64 in prefill too)
    layers = cfg.num_layers
    assert calls == ({"qkv": 3 * layers, "ffn": 4 * layers} if per_channel
                     else {"qkv": 0, "ffn": 0})


def test_forward_paged_int8_bf16_matches_jax_fused_kernels(monkeypatch):
    jcfg, jp, cfg, tp = int8_model(0, "bfloat16")
    assert tp["embed"].dtype == torch.bfloat16
    monkeypatch.setattr(jllama, "FORCE_FUSED_INTERPRET", True)
    ran = []
    for mod, fn in ((jqkv, "fused_qkv_append"), (jffn, "fused_ffn")):
        orig = getattr(mod, fn)

        def spy(*a, _orig=orig, _fn=fn, **kw):
            ran.append(_fn)
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, fn, spy)
    for jl, tl, _jc, _tc in trace_both(jcfg, jp, cfg, tp, steps=2,
                                       pool_dtype="bf16"):
        sd = float(np.std(jl))
        np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-2 * sd)
    # traced once per forward (the JAX layers run under one lax.scan): the
    # fused qkv at the 2 decode steps, the fused FFN at all 3 calls
    assert ran.count("fused_qkv_append") == 2
    assert ran.count("fused_ffn") == 3


def engines(jcfg, jp, cfg, tp, quant_mode="none"):
    kv = dict(page_size=8, num_pages=48, max_pages_per_seq=8, kv_dtype="f32")
    je = JaxEngine(jcfg, jp, JaxEngineConfig(
        max_batch_size=3, kv=JaxKVConfig(**kv), prefix_cache_entries=0,
        quant=JaxQuantConfig(mode=quant_mode)), decode_burst=4)
    te = Engine(cfg, tp, EngineConfig(
        max_batch_size=3, kv=KVCacheConfig(**kv), prefix_cache_entries=0,
        quant=QuantConfig(mode=quant_mode)), decode_burst=4, device="cpu")
    return je, te


def serve_both(je, te, new_tokens):
    jr = [je.add_request(prompt_ids=p, sampling=JaxSampling(max_new_tokens=n))
          for p, n in zip(PROMPTS, new_tokens)]
    tr = [te.add_request(prompt_ids=p,
                         sampling=SamplingParams(max_new_tokens=n))
          for p, n in zip(PROMPTS, new_tokens)]
    je.run()
    te.run()
    for a, b in zip(jr, tr):
        assert b.output_ids == a.output_ids, a.prompt_ids
        assert b.state.value == a.state.value == "finished"
    return [r.output_ids for r in tr]


def test_engine_int8_greedy_matches_jax(model):
    serve_both(*engines(*model), new_tokens=(9, 5, 12))


def test_engine_ignores_quant_config_and_serves_params_as_given(model):
    # The JAX engine never reads EngineConfig.quant; neither does the
    # port's: quant="int8" with float weights serves the float weights,
    # and with INT8 leaves serves those (no second quantization).
    jcfg, jp, cfg, tp = model
    for params_j, params_t in ((jp, tp), float_params(jcfg, cfg)):
        je, te = engines(jcfg, params_j, cfg, params_t, quant_mode="int8")
        assert te.params is params_t
        got = serve_both(je, te, new_tokens=(6, 6, 6))
        _, plain = engines(jcfg, params_j, cfg, params_t)
        assert plain.generate(PROMPTS, SamplingParams(max_new_tokens=6)) \
            == got


def float_params(jcfg, cfg):
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(1))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
