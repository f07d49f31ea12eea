"""W8A8 prefill (``ModelConfig.act_quant="int8"``) in the port against the
JAX package on the CPU.

``quantize_activations_int8`` gives JAX's codes and scales byte for byte
(a zero row takes the 1e-10 floor, exact .5 ties round to even). The
plain W8A8 product agrees with JAX's ``quantized_matmul_w8a8_ref`` within
1e-5 relative (the integer dots are exact on both sides; the f32 sums of
the scaled group partials run in another order), and with the JAX Pallas
kernel in interpret mode likewise. ``linear`` takes W8A8 exactly where
JAX's gate does: ``act_quant="int8"``, 8-bit weights without zero points,
at least 128 rows counted over every leading dim. One JAX draw of
``ModelConfig.tiny_test(act_quant="int8")`` with INT8 weights (per output
channel and groups of 32) drives ``forward_paged`` (activation codes at
most one step from JAX's at every call; logits within 1e-4 once the port
carries on with JAX's codes), the Engine over prefix-cache traffic and the
Generator (greedy tokens equal).
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
                                                      SamplingParams)
from simplellminference_tpu_torch.engine import Engine
from simplellminference_tpu_torch.memory.paged_kv import PagedKVCache
from simplellminference_tpu_torch.models import llama as tllama
from simplellminference_tpu_torch.models.convert import params_from_jax
from simplellminference_tpu_torch.ops import linear as tlinear
from simplellminference_tpu_torch.ops import matmul as tmm
from simplellminference_tpu_torch.ops import ref_ops as tref
from simplellminference_tpu_torch.runtime.generator import Generator


def _t(a):
    return torch.from_numpy(np.array(a))


def _qweight(rng, k, n, groups, layers=None):
    lead = () if layers is None else (layers,)
    q = rng.integers(-127, 128, (*lead, k, n)).astype(np.int8)
    s = ((rng.random((*lead, groups, n)) + 0.5) / (127 * np.sqrt(k))
         ).astype(np.float32)
    return q, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activations_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    x[1] = 0.0                                  # the 1e-10 floor
    # amax 127 gives the scale 1.0: x / xs lands on exact .5 ties
    x[2, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    jx = jnp.asarray(x, dtype)
    tx = _t(x).to(getattr(torch, dtype))
    ji, js = jmm.quantize_activations_int8(jx)
    ti, ts = tmm.quantize_activations_int8(tx)
    assert ti.dtype == torch.int8 and tuple(ts.shape) == (5, 1)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[1, 0]) == np.float32(1e-10) and not ti[1].any()
    assert ti[2, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "stacked"])
@pytest.mark.parametrize("groups", [1, 4], ids=["per-channel", "group32"])
def test_w8a8_plain_matches_jax_ref(groups, stacked):
    rng = np.random.default_rng(groups)
    k, n = 128, 48
    q, s = _qweight(rng, k, n, groups, layers=2)
    x = rng.standard_normal((3, 50, k)).astype(np.float32)
    want = np.asarray(jref.quantized_matmul_w8a8_ref(
        jnp.asarray(x), jnp.asarray(q[1]), jnp.asarray(s[1]),
        out_dtype=jnp.float32))
    if stacked:
        got = tmm.quantized_matmul_w8a8(_t(x), _t(q), _t(s),
                                        out_dtype=torch.float32, layer=1)
    else:
        got = tmm.quantized_matmul_w8a8(_t(x), _t(q[1]), _t(s[1]),
                                        out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("groups", [1, 2], ids=["per-channel", "group128"])
def test_w8a8_matches_jax_kernel_interpret(groups):
    rng = np.random.default_rng(3)
    m, k, n = 128, 256, 256
    q, s = _qweight(rng, k, n, groups)
    x = rng.standard_normal((m, k)).astype(np.float32)
    want = np.asarray(jmm.quantized_matmul_w8a8(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
        out_dtype=jnp.float32, interpret=True))
    got = tmm.quantized_matmul_w8a8(_t(x), _t(q), _t(s),
                                    out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("lead,applies", [((127,), False), ((128,), True),
                                          ((8, 16), True), ((2, 8, 7), False),
                                          ((8,), False)])
def test_act_quant_row_gate_matches_jax(lead, applies, monkeypatch):
    rng = np.random.default_rng(5)
    k, n = 64, 32
    q, s = _qweight(rng, k, n, 1)
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    jw = jlinear.QuantizedWeight(q=jnp.asarray(q), scales=jnp.asarray(s))
    tw = tlinear.QuantizedWeight(q=_t(q), scales=_t(s))
    assert jlinear._act_quant_applies(jnp.asarray(x), jw, "int8") == applies
    assert tlinear._act_quant_applies(_t(x), tw, "int8") == applies
    calls = []
    orig = tlinear.quantized_matmul_w8a8

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    monkeypatch.setattr(tlinear, "quantized_matmul_w8a8", spy)
    want = jlinear.linear(jnp.asarray(x), jw, act_quant="int8")
    got = tlinear.linear(_t(x), tw, act_quant="int8")
    assert len(calls) == int(applies)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_int4_and_zero_point_weights_are_ineligible(monkeypatch):
    rng = np.random.default_rng(6)
    k, n = 64, 32
    w = rng.standard_normal((k, n)).astype(np.float32)
    q4, s4 = tref.quantize_int4_groupwise(_t(w), 16)
    zs = _t(rng.standard_normal(tuple(s4.shape)).astype(np.float32))
    x = _t(rng.standard_normal((256, k)).astype(np.float32))
    monkeypatch.setattr(tlinear, "quantized_matmul_w8a8", None)  # unused
    for tw in (tlinear.QuantizedWeight(q=q4, scales=s4, bits=4),
               tlinear.QuantizedWeight(q=q4, scales=s4, bits=4, zs=zs)):
        jw = jlinear.QuantizedWeight(
            q=jnp.asarray(tw.q.numpy()), scales=jnp.asarray(tw.scales.numpy()),
            bits=4, zs=None if tw.zs is None else jnp.asarray(tw.zs.numpy()))
        assert not jlinear._act_quant_applies(jnp.asarray(x.numpy()), jw,
                                              "int8")
        assert not tlinear._act_quant_applies(x, tw, "int8")
        assert torch.equal(tlinear.linear(x, tw, act_quant="int8"),
                           tlinear.linear(x, tw))


def test_other_activation_quantizations_raise():
    tllama.check_supported(ModelConfig.tiny_test(act_quant="int8"))
    with pytest.raises(ValueError, match="act_quant"):
        tllama.check_supported(ModelConfig.tiny_test(act_quant="fp8"))
    w = tlinear.QuantizedWeight(q=torch.zeros(4, 4, dtype=torch.int8),
                                scales=torch.ones(1, 4))
    with pytest.raises(ValueError, match="act_quant"):
        tlinear.linear(torch.zeros(1, 4), w, act_quant="fp8")


# ---------------------------------------------------------------- the model

PS, PAGES = 8, 40
PROMPTS = [[5, 9, 2, 44, 17, 3, 8, 120, 7, 7, 1], [33, 4, 250],
           [60, 61, 62, 63, 64, 65, 66, 67, 68]]


def w8a8_model(group_size: int):
    jcfg = JaxModelConfig.tiny_test(act_quant="int8")
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    jp = jquantize_params(jp, JaxQuantConfig(mode="int8",
                                             group_size=group_size,
                                             quantize_lm_head=True))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, ModelConfig.tiny_test(act_quant="int8"), tp


@pytest.fixture(scope="module", params=[0, 32],
                ids=["per-channel", "group32"])
def model(request):
    return w8a8_model(request.param)


def _jax_codes(monkeypatch):
    """Spies on JAX's quantize_activations_int8: the (codes, scales) of
    each call, in order."""
    seen = []
    orig = jmm.quantize_activations_int8

    def spy(x):
        xi, xs = orig(x)
        seen.append((np.asarray(xi), np.asarray(xs)))
        return xi, xs
    monkeypatch.setattr(jmm, "quantize_activations_int8", spy)
    return seen


def test_forward_paged_w8a8_matches_jax(model, monkeypatch):
    # The same f32 activations computed in another order may sit on either
    # side of a rounding midpoint, and one code a step apart moves every
    # later activation a little (measured on the CPU: logits 5.8e-3 apart
    # after two layers at this size). So the port quantizes to its own
    # codes, which must lie within one step of JAX's at every call, and
    # then carries on with JAX's codes and scales: from there only f32
    # summation order differs, and the logits agree within 1e-4.
    jcfg, jp, cfg, tp = model
    seen = _jax_codes(monkeypatch)
    calls = []
    orig = tmm.quantize_activations_int8

    def forced(x):
        xi, _xs = orig(x)
        j_xi, j_xs = seen[len(calls)]
        calls.append(int((xi.numpy() != j_xi).sum()))
        assert int(np.abs(xi.numpy().astype(int) - j_xi).max()) <= 1
        return _t(j_xi), _t(j_xs)
    monkeypatch.setattr(tmm, "quantize_activations_int8", forced)
    b, bucket = len(PROMPTS), 64                  # 192 prefill rows
    toks = np.zeros((b, bucket), np.int32)
    for i, p in enumerate(PROMPTS):
        toks[i, :len(p)] = p
    lens = np.asarray([len(p) for p in PROMPTS], np.int32)
    pos0 = np.arange(bucket, dtype=np.int32)[None]
    tables = np.arange(b * 8, dtype=np.int32).reshape(b, 8)
    jc = JaxCache.create(cfg.num_layers, PAGES, cfg.num_kv_heads, PS,
                         cfg.head_dim, jnp.float32)
    tc = PagedKVCache.create(cfg.num_layers, PAGES, cfg.num_kv_heads, PS,
                             cfg.head_dim, torch.float32, device="cpu")
    with jax.disable_jit():                     # concrete codes to record
        jl, jc = jllama.forward_paged(jcfg, jp, jnp.asarray(toks),
                                      jnp.asarray(pos0), jc,
                                      jnp.asarray(tables), jnp.asarray(lens),
                                      prefill=True, last_token_only=True)
    tl, tc = tllama.forward_paged(cfg, tp, _t(toks), _t(pos0), tc,
                                  _t(tables), _t(lens), prefill=True,
                                  last_token_only=True)
    # W8A8 on every product of the prefill but the head: 4 per layer
    assert len(seen) == len(calls) == 4 * cfg.num_layers
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)
    pos = lens.copy()
    for _ in range(2):                          # decode: 3 rows, no W8A8
        jl, jc = jllama.forward_paged(
            jcfg, jp, jnp.asarray(tok[:, None]), jnp.asarray(pos[:, None]),
            jc, jnp.asarray(tables), jnp.asarray(pos + 1), prefill=False)
        tl, tc = tllama.forward_paged(
            cfg, tp, _t(tok[:, None]), _t(pos[:, None]), tc, _t(tables),
            _t(pos + 1), prefill=False)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        tok = np.asarray(jnp.argmax(jl[:, 0], -1), np.int32)
        pos = pos + 1
    assert len(calls) == 4 * cfg.num_layers


def _waves():
    """Four 40-token system prompts with 8-token user suffixes: the first
    wave (one request each) prefills 4 x 64 rows at once, the next two
    hit the cached prompts with new suffixes."""
    rng = np.random.default_rng(2)
    systems = [rng.integers(1, 256, 40).tolist() for _ in range(4)]
    return [[sp + rng.integers(1, 256, 8).tolist() for sp in systems]
            for _ in range(3)]


def test_engine_w8a8_prefix_traffic_matches_jax(model, monkeypatch):
    jcfg, jp, cfg, tp = model
    calls = []
    orig = tmm.quantize_activations_int8

    def spy(x):
        calls.append(x.shape[:-1].numel())
        return orig(x)
    monkeypatch.setattr(tmm, "quantize_activations_int8", spy)
    kv = dict(page_size=8, num_pages=64, max_pages_per_seq=8,
              kv_dtype="f32")
    je = JaxEngine(jcfg, jp, JaxEngineConfig(
        max_batch_size=4, kv=JaxKVConfig(**kv)), decode_burst=4)
    te = Engine(cfg, tp, EngineConfig(max_batch_size=4,
                                      kv=KVCacheConfig(**kv)),
                decode_burst=4, device="cpu")
    outs = []
    for eng, samp in ((je, JaxSampling), (te, SamplingParams)):
        reqs = []
        for wave in _waves():                   # each wave after the last
            reqs += [eng.add_request(prompt_ids=p,
                                     sampling=samp(max_new_tokens=6))
                     for p in wave]
            eng.run()
        outs.append([r.output_ids for r in reqs])
        assert eng.metrics.prefix_cache_hits > 0
    assert outs[1] == outs[0]
    # the first wave prefills 4 x 64 rows at once: W8A8 on its 4 products
    # a layer; the suffix batches stay below 128 rows
    assert calls == [256] * 4 * cfg.num_layers


def test_generator_w8a8_matches_jax(model, monkeypatch):
    jcfg, jp, cfg, tp = model
    calls = []
    orig = tmm.quantize_activations_int8

    def spy(x):
        calls.append(1)
        return orig(x)
    monkeypatch.setattr(tmm, "quantize_activations_int8", spy)
    prompts = PROMPTS + [[1] * 19]              # bucket 32: 4 x 32 rows
    jg = JaxGenerator(jcfg, jp, max_batch=4, max_seq=128)
    tg = Generator(cfg, tp, max_batch=4, max_seq=128, device="cpu")
    want = jg.generate(prompts, JaxSampling(max_new_tokens=8))
    got = tg.generate(prompts, SamplingParams(max_new_tokens=8))
    assert got.token_ids == want.token_ids
    assert len(calls) == 4 * cfg.num_layers
    assert tg.generate_fused(prompts, 8).tolist() == got.token_ids
