"""GPT-OSS (attention sinks, q/k/v/o biases, yarn rotary, the clamped
SwiGLU mixture of experts with router and expert biases, alternating
sliding and full layers) through the PyTorch port against the JAX package
on the CPU.

The tiny model is the JAX package's own GPT-OSS test's
(tests/test_model_families.py: a ``transformers.GptOssConfig`` of 4
layers, 4 heads over 2 kv heads at D 32, 4 experts of width 64 with top
2, window 8, yarn factor 4 over 64 original positions, truncate off). Its
weights are one JAX draw (``init_params``; sinks N(0, 1), every bias
0.02), carried to the port with ``params_from_jax``. Stated tolerances:
the yarn tables within 1e-6; logits of ``forward_paged`` within 1e-4
over whole-prompt prefill, chunked prefill and decode steps, with
ungrouped pools and the grouped engine's ring pools (window 8, the ring
wrapping); the Engine's greedy tokens exact and its logprobs within 1e-4,
prefix cache on and off, f32 and INT8 weights; params carried leaf for
leaf exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from simplellminference_tpu.core.config import EngineConfig as JaxEngineConfig
from simplellminference_tpu.core.config import KVCacheConfig as JaxKVConfig
from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.core.config import QuantConfig as JaxQuantConfig
from simplellminference_tpu.core.config import SamplingParams as JaxSampling
from simplellminference_tpu.engine import Engine as JaxEngine
from simplellminference_tpu.memory.paged_kv import PagedKVCache as JaxCache
from simplellminference_tpu.models import llama as jllama
from simplellminference_tpu.ops import ref_ops as jref
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
from simplellminference_tpu_torch.ops import ref_ops as tref
from simplellminference_tpu_torch.ops.linear import QuantizedWeight
from simplellminference_tpu_torch.runtime.generator import Generator
from simplellminference_tpu_torch.runtime.weights import quantize_params

LOGIT_TOL = 1e-4
PS = 8
WINDOW = 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread: the tiny models' ops are far
    below where threads pay off, and under the suite's parallel workers
    (each with an OpenMP thread per core) the threads spin against each
    other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gpt_oss_hf(**kw):
    """The JAX package's tiny GPT-OSS (test_model_families.py:672-688)."""
    base = dict(
        vocab_size=256, hidden_size=96, intermediate_size=64,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=32, max_position_embeddings=256, rms_norm_eps=1e-5,
        rope_theta=10000.0, tie_word_embeddings=False,
        num_local_experts=4, num_experts_per_tok=2,
        sliding_window=WINDOW,
        layer_types=["sliding_attention", "full_attention"] * 2,
        attention_bias=True, attention_dropout=0.0,
        rope_scaling={"rope_type": "yarn", "factor": 4.0,
                      "original_max_position_embeddings": 64,
                      "beta_fast": 32.0, "beta_slow": 1.0,
                      "truncate": False},
        attn_implementation="eager")
    base.update(kw)
    return transformers.GptOssConfig(**base).to_dict()


def _model(quant: bool):
    hf = _gpt_oss_hf()
    jcfg = JaxModelConfig.from_hf_dict(hf, dtype="float32")
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(13))
    if quant:
        jp = jquantize_params(jp, JaxQuantConfig(mode="int8", group_size=0,
                                                 quantize_lm_head=True))
    cfg = ModelConfig.from_hf_dict(hf, dtype="float32")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, cfg, tp


_MODELS: dict = {}


def _drawn(kind: str):
    """The f32 or INT8 model, drawn once for the module."""
    if kind not in _MODELS:
        _MODELS[kind] = _model(kind == "int8")
    return _MODELS[kind]


@pytest.fixture(scope="module", params=["f32", "int8"])
def gpt_oss(request):
    return _drawn(request.param)


def test_from_hf_dict_matches_jax():
    hf = _gpt_oss_hf()
    jcfg = JaxModelConfig.from_hf_dict(hf, dtype="float32")
    cfg = ModelConfig.from_hf_dict(hf, dtype="float32")
    mine, theirs = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
    for name, value in theirs.items():
        assert mine[name] == value, name
    assert set(mine) == set(theirs)
    assert cfg.attn_sinks and cfg.o_bias and cfg.moe_bias
    assert cfg.attention_bias and cfg.hidden_act == "swiglu_oss"
    assert cfg.num_experts == 4 and cfg.num_experts_per_tok == 2
    assert cfg.expert_intermediate_size == 64 and cfg.norm_topk_prob
    assert cfg.layer_windows == (WINDOW, None) * 2
    tllama.check_supported(cfg)


@pytest.mark.parametrize("truncate", [False, True])
@pytest.mark.parametrize("extra", [{}, {"attention_factor": 1.3},
                                   {"mscale": 1.0, "mscale_all_dim": 0.5}],
                         ids=["default", "attention_factor", "mscale"])
def test_yarn_tables_match_jax(truncate, extra):
    """Yarn's per-dim ramp between the beta_fast and beta_slow correction
    dims (rounded outward with ``truncate``) and its attention factor on
    sin and cos (``amp``: 0.1 ln(factor) + 1 by default)."""
    rs = {"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
          "beta_slow": 1.0, "original_max_position_embeddings": 4096,
          "truncate": truncate, **extra}
    pos = np.asarray([[0, 1, 7, 130, 4095], [4096, 9000, 65535, 131071, 3]],
                     np.int32)
    for d, theta in ((64, 150000.0), (32, 10000.0)):
        ts, tc = tref.rope_tables(torch.from_numpy(pos), d, theta,
                                  rope_scaling=rs)
        js, jc = jref.rope_tables(jnp.asarray(pos), d, theta,
                                  rope_scaling=rs)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6,
                                   rtol=1e-6)
    # the attention factor scales the tables: at position 0 cos is amp
    want = extra.get("attention_factor", 1.0)
    if not extra:
        want = 0.1 * np.log(32.0) + 1.0
    elif "mscale" in extra:
        want = (0.1 * np.log(32.0) + 1.0) / (0.05 * np.log(32.0) + 1.0)
    assert abs(float(tc[0, 0, 0]) - want) < 1e-6
    # the model's tables go through the config's frozen rope_scaling
    cfg = ModelConfig.from_hf_dict(_gpt_oss_hf(), dtype="float32")
    jcfg = JaxModelConfig.from_hf_dict(_gpt_oss_hf(), dtype="float32")
    ts, tc = tref.rope_tables_for(cfg, torch.from_numpy(pos))
    js, jc = jref.rope_tables_for(jcfg, jnp.asarray(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6,
                               rtol=1e-6)


def test_params_carry_every_gpt_oss_leaf(gpt_oss):
    """``params_from_jax`` carries the router, its bias, the folded
    experts (INT8 codes byte for byte), their biases, the sinks and the
    q/k/v and o biases; the port's own draw has the JAX package's leaves
    and shapes, on the device asked for."""
    jcfg, jp, cfg, tp = gpt_oss
    lw, jlw = tp["layers"], jp["layers"]
    assert set(lw) == set(jlw)
    for name in ("router", "router_bias", "w_gate_up_bias", "w_down_bias",
                 "sinks", "wo_bias", "wqkv_bias"):
        assert isinstance(lw[name], torch.Tensor), name
        np.testing.assert_array_equal(lw[name].numpy(),
                                      np.asarray(jlw[name], np.float32))
    for name in ("w_gate_up", "w_down"):
        w, jw = lw[name], jlw[name]
        if hasattr(jw, "q"):
            assert isinstance(w, QuantizedWeight)
            np.testing.assert_array_equal(w.q.numpy(), np.asarray(jw.q))
            np.testing.assert_array_equal(w.scales.numpy(),
                                          np.asarray(jw.scales))
        else:
            np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    mine = tllama.init_params(cfg, seed=0, device="cpu")
    theirs = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    assert set(mine["layers"]) == set(theirs["layers"])
    for k, v in theirs["layers"].items():
        assert tuple(mine["layers"][k].shape) == v.shape, k
    assert abs(float(mine["layers"]["sinks"].std()) - 1.0) < 0.5
    # the sinks are held in f32, as the kernels take them, whatever the
    # dtype of the other weights
    half = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu",
                           dtype="bfloat16")["layers"]
    assert half["sinks"].dtype == torch.float32
    assert half["wo_bias"].dtype == torch.bfloat16
    drawn = tllama.init_params(dataclasses.replace(cfg, dtype="bfloat16"),
                               seed=0, device="cpu")["layers"]
    assert drawn["sinks"].dtype == torch.float32
    assert drawn["wo_bias"].dtype == torch.bfloat16


def test_quantize_params_matches_jax():
    """INT8 folded experts through both ``quantize_params`` (per channel
    and group 32): codes and scales exact; the router and every bias stay
    float."""
    jcfg, jp, cfg, _ = _model(False)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for gs in (0, 32):
        jq = jquantize_params(jp, JaxQuantConfig(mode="int8", group_size=gs))
        tq = quantize_params(tp, QuantConfig(mode="int8", group_size=gs))
        for name in ("w_gate_up", "w_down", "wqkv", "wo"):
            np.testing.assert_array_equal(tq["layers"][name].q.numpy(),
                                          np.asarray(jq["layers"][name].q))
            np.testing.assert_array_equal(
                tq["layers"][name].scales.numpy(),
                np.asarray(jq["layers"][name].scales))
        for name in ("router", "router_bias", "w_gate_up_bias",
                     "w_down_bias", "sinks", "wo_bias", "wqkv_bias"):
            assert isinstance(tq["layers"][name], torch.Tensor), name
            assert not hasattr(jq["layers"][name], "q"), name
        assert tq["layers"]["sinks"].dtype == torch.float32


def _ring(b, mp, r):
    """Ring tables: column j of slot s maps to ring page s*R + j % R."""
    return (np.arange(b)[:, None] * r + np.arange(mp)[None] % r).astype(
        np.int32)


TABLES = np.asarray([[3, 9, 4, 11, 0, 15, 7, 19],
                     [5, 1, 13, 2, 17, 6, 8, 10]], np.int32)


def _caches(cfg, grouped):
    """Both packages' f32 caches and the tables: ungrouped pools, or the
    grouped engine's main pools (full layers) and ring pools (sliding
    layers) of R pages a slot, with the (full, ring) table pair."""
    n_w = sum(w is not None for w in cfg.layer_windows)
    full = cfg.num_layers - n_w if grouped else cfg.num_layers
    jc = JaxCache.create(full, 20, cfg.num_kv_heads, PS, cfg.head_dim,
                         jnp.float32)
    tc = PagedKVCache.create(full, 20, cfg.num_kv_heads, PS, cfg.head_dim,
                             torch.float32, device="cpu")
    if not grouped:
        return jc, tc, jnp.asarray(TABLES), torch.from_numpy(TABLES)
    r = (WINDOW + 16 - 2) // PS + 2       # the ring for 16-row chunks
    jc = jc.with_windowed(n_w, 2 * r)
    tc = tc.with_windowed(n_w, 2 * r)
    ring = _ring(2, TABLES.shape[1], r)
    return (jc, tc, (jnp.asarray(TABLES), jnp.asarray(ring)),
            (torch.from_numpy(TABLES), torch.from_numpy(ring)))


def _step(jcfg, jp, cfg, tp, jc, tc, jt, tt, toks, pos, lens, **kw):
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    prefill = "chunk_offset" in kw or toks.shape[1] > 1
    jl, jc = jllama.forward_paged(jcfg, jp, jnp.asarray(toks),
                                  jnp.asarray(pos), jc, jt, jnp.asarray(lens),
                                  prefill=prefill, last_token_only=True,
                                  **jkw)
    tl, tc = tllama.forward_paged(cfg, tp, torch.from_numpy(toks),
                                  torch.from_numpy(pos), tc, tt,
                                  torch.from_numpy(lens), prefill=prefill,
                                  last_token_only=True, **tkw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    return jc, tc, tl[:, -1].argmax(-1).numpy().astype(np.int32)


@pytest.mark.parametrize("kind,how", [
    ("f32", "whole"), ("f32", "chunked"), ("f32", "grouped-chunked"),
    ("int8", "grouped-chunked")])
def test_forward_paged_matches_jax(kind, how):
    """Two prompts of 21 and 30 tokens (past the window of 8): prefill
    whole (ungrouped) or in 16-row chunks (ungrouped, and grouped over the
    ring pools), then 6 decode steps (the ring wraps in the grouped
    case). Prefill takes the grouped MoE route, decode the folded one."""
    jcfg, jp, cfg, tp = _drawn(kind)
    rng = np.random.default_rng(9)
    lens0 = np.asarray([21, 30], np.int32)
    prompt = rng.integers(1, cfg.vocab_size, (2, 32)).astype(np.int32)
    jc, tc, jt, tt = _caches(cfg, how.startswith("grouped"))
    if how == "whole":
        toks = np.where(np.arange(32)[None] < lens0[:, None], prompt, 0)
        pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32)).copy()
        jc, tc, nxt = _step(jcfg, jp, cfg, tp, jc, tc, jt, tt,
                            toks.astype(np.int32), pos, lens0)
    else:
        for off in (0, 16):
            lens = np.minimum(lens0, off + 16).astype(np.int32)
            toks = np.where(off + np.arange(16)[None] < lens[:, None],
                            prompt[:, off:off + 16], 0).astype(np.int32)
            pos = (off + np.arange(16, dtype=np.int32))[None].repeat(2, 0)
            offs = np.full(2, off, np.int32)
            jc, tc, nxt = _step(jcfg, jp, cfg, tp, jc, tc, jt, tt, toks, pos,
                                lens, chunk_offset=offs)
    lens = lens0.copy()
    for _ in range(6):
        jc, tc, nxt = _step(jcfg, jp, cfg, tp, jc, tc, jt, tt, nxt[:, None],
                            lens[:, None].copy(), lens + 1)
        lens = lens + 1


def _engines(model, reclaim=True, **ecfg):
    jcfg, jp, cfg, tp = model
    kv = dict(page_size=PS, num_pages=96, max_pages_per_seq=16,
              kv_dtype="f32", sliding_reclaim=reclaim)
    je = JaxEngine(jcfg, jp, JaxEngineConfig(
        max_batch_size=4, kv=JaxKVConfig(**kv), **ecfg), decode_burst=4)
    te = Engine(cfg, tp, EngineConfig(max_batch_size=4,
                                      kv=KVCacheConfig(**kv), **ecfg),
                decode_burst=4, device="cpu")
    assert te._grouped == je._grouped == reclaim
    assert te._ring == je._ring
    return je, te


SYSTEM = [2, 5, 9, 200, 17, 3, 77, 120, 44, 8, 19, 66, 31, 250, 12, 90]
PROMPTS = [SYSTEM + [7, 7, 7], list(range(30, 59)), SYSTEM + [101, 4, 9],
           [101, 4]]


@pytest.mark.parametrize("kind,prefix,chunk,reclaim", [
    ("f32", 0, 0, True), ("f32", 16, 16, True), ("f32", 16, 16, False),
    ("int8", 16, 16, True)],
    ids=["f32-plain", "f32-prefix-chunked", "f32-prefix-shared",
         "int8-prefix-chunked"])
def test_engine_matches_jax(kind, prefix, chunk, reclaim):
    """The Engine's greedy tokens against JAX's Engine, prefix cache off
    (whole prompts) and on (16-row chunks; two prompts share a 16-token
    system prompt, the second admitted after the first has cached it),
    14 new tokens so the ring wraps. The grouped engine
    (ring pools for the sliding layers) shares no prefix, as in JAX; over
    the ordinary pools (``sliding_reclaim`` off) the second prompt's
    suffix attends the shared pages through the sink forms of kernel
    8."""
    je, te = _engines(_drawn(kind), reclaim, prefix_cache_entries=prefix,
                      prefill_chunk=chunk)
    n = 14
    outs = []
    for eng, samp in ((je, JaxSampling), (te, SamplingParams)):
        first = eng.add_request(prompt_ids=PROMPTS[0],
                                sampling=samp(max_new_tokens=n))
        eng.run()
        rest = [eng.add_request(prompt_ids=p,
                                sampling=samp(max_new_tokens=n))
                for p in PROMPTS[1:]]
        eng.run()
        outs.append([first] + rest)
    for a, b in zip(*outs):
        assert b.output_ids == a.output_ids, a.prompt_ids
        np.testing.assert_allclose(b.output_logprobs, a.output_logprobs,
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert te.metrics.prefix_cache_hits == je.metrics.prefix_cache_hits
    assert (te.metrics.prefix_cache_hits > 0) == (prefix and not reclaim)
    assert len({t for r in outs[1] for t in r.output_ids}) > 2


def test_sinks_and_biases_move_the_logits():
    """The test model is sensitive to every GPT-OSS piece: without the
    sinks, a bias, or yarn's attention factor, the port's prefill logits
    part from JAX's by far more than the tolerance."""
    jcfg, jp, cfg, tp = _drawn("f32")
    toks = np.asarray([list(range(40, 56))], np.int32)
    pos = np.arange(16, dtype=np.int32)[None]
    tables = TABLES[:1, :2]

    def logits(c, p):
        cache = PagedKVCache.create(c.num_layers, 20, c.num_kv_heads, PS,
                                    c.head_dim, torch.float32, device="cpu")
        return tllama.forward_paged(
            c, p, torch.from_numpy(toks), torch.from_numpy(pos), cache,
            torch.from_numpy(tables), torch.tensor([16]), prefill=True)[0]

    jc = JaxCache.create(cfg.num_layers, 20, cfg.num_kv_heads, PS,
                         cfg.head_dim, jnp.float32)
    want = np.asarray(jllama.forward_paged(
        jcfg, jp, jnp.asarray(toks), jnp.asarray(pos), jc,
        jnp.asarray(tables), jnp.asarray([16]), prefill=True)[0])
    np.testing.assert_allclose(logits(cfg, tp).numpy(), want,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    rs = dict(cfg.rope_scaling)
    variants = {name: (cfg, {**tp, "layers": {
        k: v for k, v in tp["layers"].items() if k != name}})
        for name in ("sinks", "wqkv_bias", "wo_bias")}
    variants["expert biases"] = (cfg, {**tp, "layers": {
        **tp["layers"], "w_down_bias": tp["layers"]["w_down_bias"] * 0,
        "w_gate_up_bias": tp["layers"]["w_gate_up_bias"] * 0}})
    variants["router bias"] = (cfg, {**tp, "layers": {
        **tp["layers"], "router_bias": tp["layers"]["router_bias"] * 40}})
    variants["yarn amp"] = (dataclasses.replace(
        cfg, rope_scaling={**rs, "attention_factor": 1.0}), tp)
    for name, (c, p) in variants.items():
        assert np.abs(logits(c, p).numpy() - want).max() > 1e-3, name


def test_forms_outside_the_slice_raise(gpt_oss):
    """Sinks at head_dim 256 raise NotImplementedError naming the form,
    as do the MoE routes the slice does not serve; over INT8 KV
    (tests/test_torch_int8kv_sinks_cap.py and
    tests/test_torch_int8kv_models.py hold them to JAX) and FP8 KV
    (tests/test_torch_fp8kv_sinks_window.py), on verify rows
    (speculation) and on the dense arena (the Generator) the sink forms
    run (tests/test_torch_gpt_oss_spec.py and
    tests/test_torch_gpt_oss_dense.py)."""
    jcfg, jp, cfg, tp = gpt_oss
    kv = dict(page_size=PS, num_pages=64, max_pages_per_seq=16)
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7]]
    samp = SamplingParams(max_new_tokens=3)
    out = Engine(cfg, tp, EngineConfig(
        max_batch_size=2, kv=KVCacheConfig(kv_dtype="fp8", **kv)),
        device="cpu").generate(prompts, samp)
    assert [len(o) for o in out] == [3, 3]
    out = Engine(cfg, tp, EngineConfig(
        max_batch_size=2, kv=KVCacheConfig(kv_dtype="int8", **kv)),
        device="cpu").generate(prompts, samp)
    assert [len(o) for o in out] == [3, 3]
    out = Engine(cfg, tp, EngineConfig(
        max_batch_size=2, kv=KVCacheConfig(kv_dtype="f32", **kv),
        spec_tokens=2), device="cpu").generate([[5, 6, 5, 6, 5, 6]], samp)
    assert len(out[0]) == 3
    res = Generator(cfg, tp, max_batch=2, max_seq=32,
                    device="cpu").generate(prompts, samp)
    assert [len(o) for o in res.token_ids] == [3, 3]
    # head_dim 256, which no model with sinks has
    c256 = dataclasses.replace(cfg, head_dim=256)
    p256 = tllama.init_params(c256, seed=1, device="cpu")
    with pytest.raises(NotImplementedError, match="head_dim 256"):
        Engine(c256, p256, EngineConfig(
            max_batch_size=2, kv=KVCacheConfig(kv_dtype="f32", **kv)),
            device="cpu").generate(prompts, samp)
    with pytest.raises(NotImplementedError, match="head_dim 256"):
        Generator(c256, p256, max_batch=2, max_seq=32,
                  device="cpu").generate(prompts, samp)
    for kw, name in ((dict(router_score_fn="sigmoid"), "sigmoid"),
                     (dict(router_n_group=2), "grouped routing"),
                     (dict(shared_expert_intermediate_size=32),
                      "shared experts")):
        with pytest.raises(NotImplementedError, match=name):
            tllama.check_supported(dataclasses.replace(cfg, **kw))
