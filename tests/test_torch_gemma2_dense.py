"""Gemma-2 (alternating sliding/full layers, the attention and final soft
caps, sandwich norms, query_pre_attn_scalar) and a uniformly windowed
model (Mistral's shape) through the port's dense forward, the Generator
and both kinds of speculation, against the JAX package on the CPU.

Gemma-2 is the tiny ``transformers.Gemma2Config`` of
tests/test_torch_gemma2.py (4 layers, 4 heads over 2 kv heads, D 32,
query_pre_attn_scalar 24, caps 50 and 30, window 4), its weights drawn by
transformers from a seed, through JAX's ``params_from_torch_state_dict``
and the port's ``params_from_jax``, the sandwich norms perturbed so that
a dropped norm shows; the windowed model is ``tiny_test(sliding_window=
6)``, one JAX draw. Prompts and generation run past the window, so the
sliding layers' decode attends through 13w/13wc. Stated tolerances, f32:
the dense forward's logits within 1e-4 over a prefill and decode steps,
its arena within 1e-5; greedy tokens of the Generator (``generate`` and
``generate_fused``), of the prompt-lookup Engine (spec_tokens 4, grouped
ring pools and not) and of the draft-model Engine (a 2-layer Gemma-2
drafting for the 4-layer one) exact, with the same speculative metrics;
the port's grouped and ungrouped engines are both held to one JAX run a
model over the JAX engine's ring pools (its grouped and ungrouped runs
give the same tokens and metrics).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from simplellminference_tpu.core.config import EngineConfig as JaxEngineConfig
from simplellminference_tpu.core.config import KVCacheConfig as JaxKVConfig
from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.core.config import SamplingParams as JaxSampling
from simplellminference_tpu.engine import Engine as JaxEngine
from simplellminference_tpu.models import llama as jllama
from simplellminference_tpu.runtime.generator import (
    Generator as JaxGenerator)
from simplellminference_tpu.runtime.kv_cache import DenseKVCache as JaxDense
from simplellminference_tpu.runtime.weights import (
    params_from_torch_state_dict)
from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                      KVCacheConfig,
                                                      ModelConfig,
                                                      SamplingParams)
from simplellminference_tpu_torch.engine import Engine
from simplellminference_tpu_torch.models import llama as tllama
from simplellminference_tpu_torch.models.convert import params_from_jax
from simplellminference_tpu_torch.runtime.generator import Generator
from simplellminference_tpu_torch.runtime.kv_cache import DenseKVCache

LOGIT_TOL = 1e-4
ARENA_TOL = 1e-5
GEMMA2_WINDOW = 4
PROMPTS = [[2, 5, 9, 200, 17, 3, 77, 120, 44, 8, 2, 5, 9, 200, 17],
           [7, 7, 7], [30, 31, 32, 33, 34, 35, 36, 37, 38], [101, 4]]


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



def _gemma2(seed: int, **kw):
    """A tiny Gemma-2 (the JAX package's test values) from transformers'
    seeded draw: (jax cfg, jax params, port cfg, port params)."""
    base = dict(
        vocab_size=256, hidden_size=128, intermediate_size=256,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=32, max_position_embeddings=256, rms_norm_eps=1e-6,
        rope_theta=10000.0, tie_word_embeddings=True,
        hidden_activation="gelu_pytorch_tanh", query_pre_attn_scalar=24.0,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        sliding_window=GEMMA2_WINDOW, attn_implementation="eager")
    base.update(kw)
    hf_cfg = transformers.Gemma2Config(**base)
    torch.manual_seed(seed)
    hf = transformers.Gemma2ForCausalLM(hf_cfg).eval()
    jcfg = JaxModelConfig.from_hf_dict(hf_cfg.to_dict(), dtype="float32")
    jp = params_from_torch_state_dict(jcfg, hf.state_dict(),
                                      dtype="float32")
    # perturb the sandwich norms so that dropping one changes the outputs
    jp["layers"]["post_attn_norm"] = jp["layers"]["post_attn_norm"] * 1.3
    jp["layers"]["post_ffn_norm"] = jp["layers"]["post_ffn_norm"] * 0.6
    cfg = ModelConfig.from_hf_dict(hf_cfg.to_dict(), dtype="float32")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, cfg, tp


def _windowed():
    """Mistral's shape in small: every layer sliding, window 6."""
    kw = dict(sliding_window=6, max_seq_len=256)
    jcfg = JaxModelConfig.tiny_test(**kw)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, ModelConfig.tiny_test(**kw), tp


@pytest.fixture(scope="module", params=["gemma2", "windowed"])
def model(request):
    return _gemma2(6) if request.param == "gemma2" else _windowed()


def test_models_have_sliding_layers(model):
    _jcfg, _jp, cfg, _tp = model
    wins = cfg.layer_windows
    assert any(w is not None for w in wins)
    assert (cfg.attn_logit_softcap == 50.0) == (None in wins)
    assert max(len(p) for p in PROMPTS) > max(w for w in wins if w)


def _trace(model, steps):
    """Greedy prefill + ``steps`` decode steps through both packages'
    dense forward; yields (jax logits, port logits, jax cache, port
    cache) after each call."""
    jcfg, jp, cfg, tp = model
    b, bucket, smax = len(PROMPTS), 16, 64
    toks = np.zeros((b, bucket), np.int32)
    for i, p in enumerate(PROMPTS):
        toks[i, :len(p)] = p
    lens = np.asarray([len(p) for p in PROMPTS], np.int32)
    pos0 = np.broadcast_to(np.arange(bucket, dtype=np.int32), (b, bucket))
    jc = JaxDense.create(cfg.num_layers, b, smax, cfg.num_kv_heads,
                         cfg.head_dim, jnp.float32)
    tc = DenseKVCache.create(cfg.num_layers, b, smax, cfg.num_kv_heads,
                             cfg.head_dim, torch.float32, device="cpu")
    zeros = np.zeros(b, np.int32)
    jl, jc = jllama.forward(jcfg, jp, jnp.asarray(toks), jnp.asarray(pos0),
                            jc, jnp.asarray(zeros), jnp.asarray(lens),
                            last_token_only=True)
    tl, tc = tllama.forward(cfg, tp, torch.from_numpy(toks),
                            torch.from_numpy(pos0.copy()), tc,
                            torch.from_numpy(zeros), torch.from_numpy(lens),
                            last_token_only=True)
    yield np.asarray(jl, np.float32), tl.numpy(), jc, tc
    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
    pos = lens.copy()
    for _ in range(steps):
        jl, jc = jllama.forward(jcfg, jp, jnp.asarray(tok[:, None]),
                                jnp.asarray(pos[:, None]), jc,
                                jnp.asarray(pos), jnp.asarray(pos + 1))
        tl, tc = tllama.forward(cfg, tp, torch.from_numpy(tok[:, None]),
                                torch.from_numpy(pos[:, None]), tc,
                                torch.from_numpy(pos),
                                torch.from_numpy(pos + 1))
        yield np.asarray(jl, np.float32), tl.numpy(), jc, tc
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
        pos = pos + 1


def test_dense_forward_matches_jax(model):
    # the prefill from slot 0 (3w/3wc on the sliding layers), then decode
    # steps past every window (13w/13wc; 13c on Gemma-2's full layers)
    for jl, tl, jc, tc in _trace(model, steps=8):
        np.testing.assert_allclose(tl, jl, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1),
                                      jl[:, -1].argmax(-1))
    for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=ARENA_TOL,
                                   atol=ARENA_TOL)


def test_dense_forward_without_cache_matches_jax(model):
    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(8)
    toks = rng.integers(1, cfg.vocab_size, (2, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    jl, _ = jllama.forward(jcfg, jp, jnp.asarray(toks), jnp.asarray(pos))
    tl, _ = tllama.forward(cfg, tp, torch.from_numpy(toks),
                           torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_generator_matches_jax(model):
    jcfg, jp, cfg, tp = model
    jg = JaxGenerator(jcfg, jp, max_batch=4, max_seq=128)
    tg = Generator(cfg, tp, max_batch=4, max_seq=128, device="cpu")
    want = jg.generate(PROMPTS, JaxSampling(max_new_tokens=16))
    got = tg.generate(PROMPTS, SamplingParams(max_new_tokens=16))
    assert got.token_ids == want.token_ids
    assert got.prompt_lens == want.prompt_lens and got.steps == want.steps
    fused = tg.generate_fused(PROMPTS, 16)
    assert fused.tolist() == got.token_ids
    assert np.asarray(jg.generate_fused(PROMPTS, 16)).tolist() == (
        got.token_ids)
    assert len({tok for o in got.token_ids for tok in o}) > 2


def _kv(reclaim: bool):
    return dict(page_size=8, num_pages=96, max_pages_per_seq=16,
                kv_dtype="f32", sliding_reclaim=reclaim)


SPEC_PROMPTS = PROMPTS + [[9, 8, 7, 9, 8, 7, 9, 8, 7, 9, 8]]


_JAX_SPEC: list = []   # (jax params, draft params, result): held alive


def _jax_spec(jcfg, jp, draft=None):
    """JAX's spec Engine (spec_tokens 4, burst 3) on SPEC_PROMPTS over the
    grouped engine's ring pools, run once a model for the module: (greedy
    outputs, (spec_steps, spec_accepted)). JAX's grouped and ungrouped
    engines give the same tokens and metrics on these models, so the
    port's engines of both kinds are held to this one run."""
    dp = None if draft is None else draft[1]
    for p, d, res in _JAX_SPEC:
        if p is jp and d is dp:
            return res
    je = JaxEngine(jcfg, jp, JaxEngineConfig(
        kv=JaxKVConfig(**_kv(True)), max_batch_size=4, spec_tokens=4),
        decode_burst=3, draft=draft)
    assert je._grouped
    out = je.generate(SPEC_PROMPTS, JaxSampling(max_new_tokens=14))
    res = (out, (je.metrics.spec_steps, je.metrics.spec_accepted))
    _JAX_SPEC.append((jp, dp, res))
    return res


@pytest.mark.parametrize("grouped", [False, True],
                         ids=["ungrouped", "grouped"])
def test_spec_engine_matches_jax(model, grouped):
    # prompt-lookup speculation: the verify rows through 4vw/4vwc on the
    # sliding layers (over the ring pools when grouped), 4vc on Gemma-2's
    # full ones
    jcfg, jp, cfg, tp = model
    kw = dict(max_batch_size=4, spec_tokens=4)
    te = Engine(cfg, tp, EngineConfig(kv=KVCacheConfig(**_kv(grouped)),
                                      **kw), decode_burst=3, device="cpu")
    assert te._grouped == grouped
    want, metrics = _jax_spec(jcfg, jp)
    got = te.generate(SPEC_PROMPTS, SamplingParams(max_new_tokens=14))
    assert got == want
    assert (te.metrics.spec_steps, te.metrics.spec_accepted) == metrics
    assert te.metrics.spec_accepted > 0
    plain = Engine(cfg, tp, EngineConfig(kv=KVCacheConfig(**_kv(grouped)),
                                         max_batch_size=4), decode_burst=3,
                   device="cpu")
    assert plain.generate(SPEC_PROMPTS,
                          SamplingParams(max_new_tokens=14)) == got


@pytest.fixture(scope="module")
def gemma2_pair():
    """The 4-layer tiny Gemma-2 target and a 2-layer Gemma-2 draft of
    another draw in the same token space."""
    return _gemma2(6), _gemma2(11, num_hidden_layers=2, hidden_size=64,
                               intermediate_size=128)


def test_gemma2_draft_params_convert(gemma2_pair):
    # every leaf the dense forward reads, the sandwich norms included,
    # carried over from JAX value for value
    _target, (_jdcfg, jdp, dcfg, tdp) = gemma2_pair
    fresh = tllama.init_params(dcfg, device="cpu")
    assert set(tdp) == set(fresh) == set(jdp)
    assert "post_attn_norm" in tdp["layers"]
    assert set(tdp["layers"]) == set(fresh["layers"]) == set(jdp["layers"])
    for k, v in tdp["layers"].items():
        assert v.shape == fresh["layers"][k].shape
        np.testing.assert_array_equal(v.numpy(), np.asarray(jdp["layers"][k]))


@pytest.mark.parametrize("grouped", [False, True],
                         ids=["ungrouped", "grouped"])
def test_draft_engine_matches_jax(gemma2_pair, grouped):
    # the draft's rollout through 13c/13wc over its dense arena (and its
    # prefill through 3c/3wc), the target's verify rows through 4vc/4vwc
    (jcfg, jp, cfg, tp), (jdcfg, jdp, dcfg, tdp) = gemma2_pair
    kw = dict(max_batch_size=4, spec_tokens=4)
    te = Engine(cfg, tp, EngineConfig(kv=KVCacheConfig(**_kv(grouped)),
                                      **kw), decode_burst=3, device="cpu",
                draft=(dcfg, tdp))
    assert te._grouped == grouped
    want, metrics = _jax_spec(jcfg, jp, draft=(jdcfg, jdp))
    got = te.generate(SPEC_PROMPTS, SamplingParams(max_new_tokens=14))
    assert got == want
    assert (te.metrics.spec_steps, te.metrics.spec_accepted) == metrics
    assert te.metrics.spec_steps > 0
    plain = Engine(cfg, tp, EngineConfig(kv=KVCacheConfig(**_kv(grouped)),
                                         max_batch_size=4), decode_burst=3,
                   device="cpu")
    assert plain.generate(SPEC_PROMPTS,
                          SamplingParams(max_new_tokens=14)) == got
