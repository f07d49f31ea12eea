"""The tiny gpt-oss and Gemma-2 models over INT8 KV through the port's
grouped Engine, the prefix cache and the spec Engine, against the JAX
package's Engines on the CPU (float32).

gpt-oss: the tiny GPT-OSS of tests/test_torch_gpt_oss.py (attention sinks,
window 8, D 32), INT8 weights with the prefix cache on and 16-row chunks,
and f32 weights in the spec Engine (spec_tokens 4), both over the grouped
engine's INT8 ring pools: the sink forms over INT8 KV (8qs, 8qws, 4qs,
4qws, 4vqs, 4vqws on the card). Gemma-2: the tiny Gemma-2 of
tests/test_torch_gemma2.py at head_dim 256 (query_pre_attn_scalar 256,
attention cap 50, window 4): INT8 weights in the grouped engine with
16-row chunks (4qc, 4qwc, 8qc, 8qwc, 6q/256 with a kv_layer, 10/256 on
the card) and f32 weights in the spec Engine (4vqc, 4vqwc at D 256).
Stated tolerances: greedy tokens exact, logprobs within 1e-3 (the pools'
codes may part by one: tests/test_torch_int8kv_engine.py's rule), the
speculative and prefix metrics equal; the spec Engine's tokens equal the
spec_tokens=0 Engine's.
"""

import numpy as np
import pytest
import torch

import test_torch_gemma2 as gem2
import test_torch_gpt_oss as oss
import test_torch_int8kv_d256 as d256
from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                      KVCacheConfig,
                                                      SamplingParams)
from simplellminference_tpu_torch.engine import Engine

PS = 8
LOGIT_TOL_CODE_APART = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread (see
    tests/test_torch_int8kv_sinks_cap.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind,ecfg", [
    ("int8", dict(prefill_chunk=16)), ("f32", dict(spec_tokens=4))],
    ids=["int8-prefix-chunked", "f32-spec"])
def test_gpt_oss_engine_int8kv_matches_jax(kind, ecfg):
    """The tiny GPT-OSS over INT8 KV in the grouped Engine: INT8 weights
    with the prefix cache on and 16-row chunks (8qs, 8qws, 4qs, 4qws), or
    f32 weights in the spec Engine (spec_tokens 4: 4vqs, 4vqws on the
    verify rows): greedy tokens exact, logprobs within 1e-3 (the pools'
    codes may part), the speculative metrics equal."""
    from simplellminference_tpu.engine import Engine as JaxEngine
    kv = dict(page_size=PS, num_pages=96, max_pages_per_seq=16,
              kv_dtype="int8")
    spec = "spec_tokens" in ecfg
    prompts = ([[5, 6, 7, 8] * 5, list(range(30, 51)), [9, 8, 7] * 3]
               if spec else oss.PROMPTS)
    jcfg, jp, cfg, tp = oss._drawn(kind)
    je = JaxEngine(jcfg, jp, oss.JaxEngineConfig(
        max_batch_size=4, kv=oss.JaxKVConfig(**kv), **ecfg), decode_burst=3)
    te = Engine(cfg, tp, EngineConfig(
        max_batch_size=4, kv=KVCacheConfig(**kv), **ecfg), decode_burst=3,
        device="cpu")
    assert te._grouped and je._grouped
    assert te.cache.k_w.dtype == torch.int8
    jr = [je.add_request(prompt_ids=p, sampling=oss.JaxSampling(
        max_new_tokens=12)) for p in prompts]
    tr = [te.add_request(prompt_ids=p, sampling=SamplingParams(
        max_new_tokens=12)) for p in prompts]
    je.run()
    te.run()
    for a, b in zip(jr, tr):
        assert b.output_ids == a.output_ids, a.prompt_ids
        np.testing.assert_allclose(b.output_logprobs, a.output_logprobs,
                                   rtol=LOGIT_TOL_CODE_APART,
                                   atol=LOGIT_TOL_CODE_APART)
    assert (te.metrics.spec_steps, te.metrics.spec_accepted) == (
        je.metrics.spec_steps, je.metrics.spec_accepted)
    assert len({tok for r in tr for tok in r.output_ids}) > 2
    assert (te.metrics.spec_accepted > 0) == spec


_GEMMA2: dict = {}


def _gemma2_256(kind):
    """The tiny Gemma-2 of tests/test_torch_gemma2.py at head_dim 256
    (query_pre_attn_scalar 256): 4 heads over 2 kv heads, window 4."""
    if kind not in _GEMMA2:
        _GEMMA2[kind] = gem2._model(kind == "int8", head_dim=d256.D,
                                    query_pre_attn_scalar=256.0)
    return _GEMMA2[kind]


def test_gemma2_d256_grouped_engine_int8kv_matches_jax():
    """Gemma-2 at D 256 (INT8 weights) over INT8 KV in the grouped engine
    (INT8 ring pools for the sliding layers), 16-row chunks: 4qc/4qwc,
    8qc/8qwc, 6q/256 with a kv_layer, 10/256."""
    je, te = d256._engine_pair(_gemma2_256("int8"), d256._kv(),
                               prefill_chunk=16)
    assert te._grouped and te.cache.k_w.dtype == torch.int8
    jr, tr = d256._run_both(je, te, [gem2.PROMPTS], 10)
    d256.assert_engines_agree(je, te, jr, tr)


def test_gemma2_d256_spec_engine_int8kv_matches_jax():
    """The spec Engine (spec_tokens 4) over INT8 KV at Gemma-2's D 256:
    4vqc/256 and 4vqwc/256 on the verify rows; tokens and speculative
    metrics equal JAX's, and the tokens the spec_tokens=0 Engine's."""
    model = _gemma2_256("f32")
    je, te = d256._engine_pair(model, d256._kv(), spec_tokens=4)
    prompts = [[5, 6, 7, 8] * 4, list(range(30, 45)), [9, 8, 7] * 3]
    jr, tr = d256._run_both(je, te, [prompts], 10)
    d256.assert_engines_agree(je, te, jr, tr)
    assert (te.metrics.spec_steps, te.metrics.spec_accepted) == (
        je.metrics.spec_steps, je.metrics.spec_accepted)
    _jcfg, _jp, cfg, tp = model
    plain = Engine(cfg, tp, EngineConfig(max_batch_size=4,
                                         kv=KVCacheConfig(**d256._kv())),
                   decode_burst=4, device="cpu")
    assert plain.generate(prompts, SamplingParams(max_new_tokens=10)) == [
        r.output_ids for r in tr]
