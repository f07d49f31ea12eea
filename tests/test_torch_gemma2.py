"""Gemma-2 (sandwich norms, attention and final logit soft caps,
query_pre_attn_scalar, alternating sliding/full layers at head_dim 32)
through the PyTorch port against the JAX package on the CPU.

A tiny ``transformers.Gemma2Config`` with the values of the JAX package's
own Gemma-2 test (tests/test_model_families.py: 4 layers, 4 heads over 2
kv heads, D 32, query_pre_attn_scalar 24 so that a dropped score scale
shows, caps 50 and 30, window 4), its weights drawn by transformers from a
seed, goes through JAX's ``from_hf_dict`` and
``params_from_torch_state_dict`` (which folds Gemma's +1 into the norm
weights), then the port's ``params_from_jax``; the sandwich norms are
perturbed, as JAX's ``test_gemma2_paged_engine_matches_dense`` does, so
that a dropped norm changes the outputs. Stated tolerances: logits of
``forward_paged`` within 1e-4 over whole-prompt prefill, chunked prefill
and decode steps, with ungrouped pools and the grouped engine's ring
pools, prompts past the window; the Engine's greedy tokens exact and its
logprobs within 1e-4, with f32 and INT8 weights, with and without
``prefill_chunk``; the HF name map equal to JAX's.
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
from simplellminference_tpu.runtime.weights import (
    llama_hf_param_map as jhf_map)
from simplellminference_tpu.runtime.weights import (
    params_from_torch_state_dict)
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
from simplellminference_tpu_torch.runtime.weights import (
    llama_hf_param_map as thf_map)
from simplellminference_tpu_torch.runtime.generator import Generator
from simplellminference_tpu_torch.runtime.weights import quantize_params

LOGIT_TOL = 1e-4
PS = 8
WINDOW = 4


def _gemma2_cfg(**kw):
    base = dict(
        vocab_size=256, hidden_size=128, intermediate_size=256,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=32, max_position_embeddings=256, rms_norm_eps=1e-6,
        rope_theta=10000.0, tie_word_embeddings=True,
        hidden_activation="gelu_pytorch_tanh",
        query_pre_attn_scalar=24.0, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, sliding_window=WINDOW,
        attn_implementation="eager")
    base.update(kw)
    return transformers.Gemma2Config(**base)


def _model(quant: bool, **kw):
    hf_cfg = _gemma2_cfg(**kw)
    torch.manual_seed(6)
    hf = transformers.Gemma2ForCausalLM(hf_cfg).eval()
    jcfg = JaxModelConfig.from_hf_dict(hf_cfg.to_dict(), dtype="float32")
    jp = params_from_torch_state_dict(jcfg, hf.state_dict(),
                                      dtype="float32")
    # perturb the sandwich norms so that dropping one changes the outputs
    jp["layers"]["post_attn_norm"] = jp["layers"]["post_attn_norm"] * 1.3
    jp["layers"]["post_ffn_norm"] = jp["layers"]["post_ffn_norm"] * 0.6
    if quant:
        jp = jquantize_params(jp, JaxQuantConfig(mode="int8", group_size=0))
    cfg = ModelConfig.from_hf_dict(hf_cfg.to_dict(), dtype="float32")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, cfg, tp


@pytest.fixture(scope="module", params=["f32", "int8"])
def gemma2(request):
    return _model(request.param == "int8")


def test_from_hf_dict_matches_jax():
    hf_cfg = _gemma2_cfg()
    jcfg = JaxModelConfig.from_hf_dict(hf_cfg.to_dict(), dtype="float32")
    cfg = ModelConfig.from_hf_dict(hf_cfg.to_dict(), dtype="float32")
    mine = dataclasses.asdict(cfg)
    theirs = dataclasses.asdict(jcfg)
    for name, value in mine.items():
        if name in theirs:
            assert value == theirs[name], name
    assert cfg.sandwich_norms and cfg.attn_logit_softcap == 50.0
    assert cfg.final_logit_softcap == 30.0
    assert cfg.query_pre_attn_scalar == 24.0
    assert cfg.layer_windows == (WINDOW, None) * 2
    assert cfg.window_pattern() == jcfg.window_pattern() == (2, (WINDOW,
                                                                 None))
    assert abs(cfg.embed_scale - 128.0 ** 0.5) < 1e-9
    tllama.check_supported(cfg)
    # the dense arena takes the window and the cap too (13w, 13c): the
    # Generator and a draft model admit the configuration, with or
    # without its windows
    tp = tllama.init_params(cfg, device="cpu")
    for c in (cfg, dataclasses.replace(cfg, layer_types=None,
                                       sliding_window=None)):
        assert Generator(c, tp, max_batch=1, max_seq=32,
                         device="cpu").cfg is c


def test_hf_param_map_matches_jax():
    hf_cfg = _gemma2_cfg()
    jcfg = JaxModelConfig.from_hf_dict(hf_cfg.to_dict(), dtype="float32")
    cfg = ModelConfig.from_hf_dict(hf_cfg.to_dict(), dtype="float32")
    assert thf_map(cfg) == jhf_map(jcfg)
    m = thf_map(cfg)
    assert m["layers/post_attn_norm"] == (
        "model.layers.{i}.post_attention_layernorm.weight")
    assert m["layers/post_norm"] == (
        "model.layers.{i}.pre_feedforward_layernorm.weight")
    assert m["layers/post_ffn_norm"] == (
        "model.layers.{i}.post_feedforward_layernorm.weight")
    # GLM-4's sandwich norms come with partial rotary: still refused
    with pytest.raises(NotImplementedError, match="sandwich norms"):
        thf_map(dataclasses.replace(cfg, model_type="glm4"))


def test_params_carry_the_sandwich_norms(gemma2):
    jcfg, jp, cfg, tp = gemma2
    for name in ("post_attn_norm", "post_ffn_norm", "post_norm"):
        np.testing.assert_array_equal(tp["layers"][name].numpy(),
                                      np.asarray(jp["layers"][name]))
    # the port's own draw has the JAX package's leaves and shapes
    mine = tllama.init_params(cfg, seed=0, device="cpu")
    theirs = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    assert set(mine["layers"]) == set(theirs["layers"])
    for k, v in theirs["layers"].items():
        assert tuple(mine["layers"][k].shape) == v.shape, k
    # quantize_params leaves the new norms unquantized
    q = quantize_params(mine, QuantConfig(mode="int8", group_size=0))
    assert isinstance(q["layers"]["post_ffn_norm"], torch.Tensor)
    assert torch.equal(q["layers"]["post_attn_norm"],
                       mine["layers"]["post_attn_norm"])


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
    # the final cap holds every logit within 30
    assert float(tl.abs().max()) <= cfg.final_logit_softcap
    return jc, tc, tl[:, -1].argmax(-1).numpy().astype(np.int32)


@pytest.mark.parametrize("how", ["whole", "chunked", "grouped-chunked"])
def test_forward_paged_matches_jax(gemma2, how):
    """Two prompts of 21 and 30 tokens (past the window of 4): prefill
    whole (ungrouped) or in 16-row chunks (ungrouped, and grouped over the
    ring pools), then 5 decode steps (the ring wraps in the grouped
    case)."""
    jcfg, jp, cfg, tp = gemma2
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
    for _ in range(5):
        jc, tc, nxt = _step(jcfg, jp, cfg, tp, jc, tc, jt, tt, nxt[:, None],
                            lens[:, None].copy(), lens + 1)
        lens = lens + 1


def _engines(model, **ecfg):
    jcfg, jp, cfg, tp = model
    kv = dict(page_size=PS, num_pages=96, max_pages_per_seq=16,
              kv_dtype="f32")
    je = JaxEngine(jcfg, jp, JaxEngineConfig(
        max_batch_size=4, kv=JaxKVConfig(**kv), **ecfg), decode_burst=4)
    te = Engine(cfg, tp, EngineConfig(max_batch_size=4,
                                      kv=KVCacheConfig(**kv), **ecfg),
                decode_burst=4, device="cpu")
    assert te._grouped and je._grouped and te._ring == je._ring
    assert te.cache.k_w.shape[0] == te.cache.k.shape[0] == 2
    return je, te


PROMPTS = [[2, 5, 9, 200, 17, 3, 77, 120, 44, 8], [7, 7, 7],
           list(range(30, 59)), [101, 4]]


@pytest.mark.parametrize("chunk", [0, 16], ids=["whole", "chunked"])
def test_engine_matches_jax(gemma2, chunk):
    je, te = _engines(gemma2, prefill_chunk=chunk)
    n = 12
    jr = [je.add_request(prompt_ids=p, sampling=JaxSampling(
        max_new_tokens=n)) for p in PROMPTS]
    tr = [te.add_request(prompt_ids=p, sampling=SamplingParams(
        max_new_tokens=n)) for p in PROMPTS]
    je.run()
    te.run()
    for a, b in zip(jr, tr):
        assert b.output_ids == a.output_ids, a.prompt_ids
        np.testing.assert_allclose(b.output_logprobs, a.output_logprobs,
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    out = [b.output_ids for b in tr]
    assert len({tok for o in out for tok in o}) > 2   # not one token


def test_dropped_norm_or_cap_changes_the_logits():
    """The test model is sensitive to every Gemma-2 piece: without a
    sandwich norm, or with either cap off (a biting attention cap of 1.0
    over weights drawn at 0.3, whose scores pass it), the port's prefill
    logits part from JAX's by far more than the tolerance."""
    jcfg, jp, cfg, tp = _model(False, attn_logit_softcapping=1.0,
                               initializer_range=0.3)
    toks = np.asarray([PROMPTS[2][:16]], np.int32)
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
    variants = {
        "post_attn_norm": (cfg, {**tp, "layers": {
            k: v for k, v in tp["layers"].items() if k != "post_attn_norm"}}),
        "post_ffn_norm": (cfg, {**tp, "layers": {
            k: v for k, v in tp["layers"].items() if k != "post_ffn_norm"}}),
        "attn cap": (dataclasses.replace(cfg, attn_logit_softcap=None), tp),
        "final cap": (dataclasses.replace(cfg, final_logit_softcap=None), tp),
    }
    for name, (c, p) in variants.items():
        assert np.abs(logits(c, p).numpy() - want).max() > 1e-2, name
