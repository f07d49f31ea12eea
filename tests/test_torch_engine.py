"""The port's serving Engine against the JAX package's Engine on the CPU.

Both engines get one JAX parameter draw (``tiny_test``, float32; the port
through ``params_from_jax``) and the same requests. Greedy tokens, finish
states and stop handling must be identical; logprobs and the KV pools
after the run agree within 1e-4 / 1e-5 (float32: XLA and PyTorch round
rmsnorm, RoPE and matmul sums differently, so the pools are not
bit-identical). Fed the same K/V at the engines' tables and positions,
the two packages' pool writes are byte-equal.
"""

import dataclasses
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
from simplellminference_tpu.memory import paged_kv as jpkv
from simplellminference_tpu.models import llama as jllama
from simplellminference_tpu.tokenizer import ByteTokenizer
from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                      KVCacheConfig,
                                                      ModelConfig,
                                                      SamplingParams)
from simplellminference_tpu_torch.engine import Engine, RequestState
from simplellminference_tpu_torch.memory import paged_kv as tpkv
from simplellminference_tpu_torch.models.convert import params_from_jax


@pytest.fixture(scope="module")
def model():
    jcfg = JaxModelConfig.tiny_test(vocab_size=258)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, ModelConfig.tiny_test(vocab_size=258), tp


def engines(model, max_batch=4, num_pages=64, page_size=8, burst=4,
            max_pages=16, tokenizer=None):
    jcfg, jp, cfg, tp = model
    kv = dict(page_size=page_size, num_pages=num_pages,
              max_pages_per_seq=max_pages, kv_dtype="f32")
    je = JaxEngine(jcfg, jp, JaxEngineConfig(
        max_batch_size=max_batch, kv=JaxKVConfig(**kv),
        prefix_cache_entries=0), tokenizer=tokenizer, decode_burst=burst)
    te = Engine(cfg, tp, EngineConfig(
        max_batch_size=max_batch, kv=KVCacheConfig(**kv),
        prefix_cache_entries=0), tokenizer=tokenizer, decode_burst=burst,
        device="cpu")
    return je, te


def serve_both(je, te, prompts, samplings):
    jr = [je.add_request(prompt_ids=p, sampling=JaxSampling(**s))
          for p, s in zip(prompts, samplings)]
    tr = [te.add_request(prompt_ids=p, sampling=SamplingParams(**s))
          for p, s in zip(prompts, samplings)]
    je.run()
    te.run()
    for a, b in zip(jr, tr):
        assert b.output_ids == a.output_ids, (a.req_id, a.prompt_ids)
        assert b.state.value == a.state.value
        np.testing.assert_allclose(b.output_logprobs, a.output_logprobs,
                                   rtol=1e-4, atol=1e-4)
    return jr, tr


def assert_pools_close(je, te):
    for t, j in ((te.cache.k, je.cache.k), (te.cache.v, je.cache.v)):
        np.testing.assert_allclose(t.numpy()[:, :-1], np.asarray(j)[:, :-1],
                                   rtol=1e-5, atol=1e-5)


PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], [42, 43, 44, 45, 46, 47, 48],
           [100, 3, 7, 9, 11, 13, 15, 17, 19, 21, 23, 25, 27, 29, 31, 33, 35]]


def test_mixed_lengths_greedy_matches_jax(model):
    je, te = engines(model)
    serve_both(je, te, PROMPTS, [dict(max_new_tokens=n)
                                 for n in (10, 3, 13, 7)])
    assert te.metrics.requests_finished == 4
    assert te.metrics.tokens_generated == 33
    assert not te.has_work


def test_pools_match_jax_after_prefill_and_decode(model):
    je, te = engines(model)
    # long-running requests: their pages are still mapped at the end
    jr = [je.add_request(prompt_ids=p, sampling=JaxSampling(
        max_new_tokens=9)) for p in PROMPTS]
    tr = [te.add_request(prompt_ids=p, sampling=SamplingParams(
        max_new_tokens=9)) for p in PROMPTS]
    for _ in range(3):
        je.step()
        te.step()
    assert [r.output_ids for r in tr] == [r.output_ids for r in jr]
    np.testing.assert_array_equal(te.allocator.table(),
                                  je.allocator.table())
    assert_pools_close(je, te)


def test_pools_byte_equal_for_the_same_kv_inputs(model):
    # The engines' own K/V differ in the last float32 bits, so here one
    # numpy draw of pools and K/V goes through each package's writes at
    # the tables and positions the two engines hold mid-run (one slot
    # finished: an all -1 table row).
    je, te = engines(model)
    for new in (9, 2, 9, 9):
        je.add_request(prompt_ids=PROMPTS[0], sampling=JaxSampling(
            max_new_tokens=new))
        te.add_request(prompt_ids=PROMPTS[0], sampling=SamplingParams(
            max_new_tokens=new))
    for _ in range(3):
        je.step()
        te.step()
    tables = te.allocator.table()
    np.testing.assert_array_equal(tables, je.allocator.table())
    np.testing.assert_array_equal(te._pos, je._pos)
    assert (tables == -1).all(axis=1).any()
    rng = np.random.default_rng(5)
    L, _, kvn, _, d = te.cache.k.shape
    b = tables.shape[0]

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    pk, pv = draw(*te.cache.k.shape), draw(*te.cache.v.shape)
    jk, jv = jnp.asarray(pk), jnp.asarray(pv)
    tk, tv = torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy())
    for layer in range(L):
        nk, nv = draw(b, 16, kvn, d), draw(b, 16, kvn, d)
        jk, jv, _, _ = jpkv.write_prefill_stacked(
            jk, jv, jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(tables),
            jnp.int32(layer))
        tpkv.write_prefill_stacked(tk, tv, torch.from_numpy(nk),
                                   torch.from_numpy(nv),
                                   torch.from_numpy(tables), layer)
        dk, dv = draw(b, kvn, d), draw(b, kvn, d)
        jk, jv, _, _ = jpkv.write_decode_stacked(
            jk, jv, jnp.asarray(dk), jnp.asarray(dv), jnp.asarray(tables),
            jnp.asarray(te._pos), jnp.int32(layer))
        tpkv.write_decode_stacked(tk, tv, torch.from_numpy(dk),
                                  torch.from_numpy(dv),
                                  torch.from_numpy(tables),
                                  torch.from_numpy(te._pos.copy()), layer)
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(t.numpy()[:, :-1], np.asarray(j)[:, :-1])


def test_more_requests_than_slots(model):
    je, te = engines(model, max_batch=2)
    prompts = [[i + 1, i + 2, i + 3] for i in range(7)]
    serve_both(je, te, prompts, [dict(max_new_tokens=6)] * 7)
    assert te.metrics.requests_finished == 7


def test_stop_tokens_and_min_tokens(model):
    je, te = engines(model)
    ref, _ = serve_both(*engines(model), [PROMPTS[0]],
                        [dict(max_new_tokens=12)])
    stop = ref[0].output_ids[4]
    jr, tr = serve_both(je, te, [PROMPTS[0]] * 3, [
        dict(max_new_tokens=12, stop_token_ids=(stop,)),
        dict(max_new_tokens=12, stop_token_ids=(stop,), min_tokens=6),
        dict(max_new_tokens=12, stop_token_ids=(stop,), ignore_eos=True)])
    first = ref[0].output_ids.index(stop)
    assert tr[0].output_ids == ref[0].output_ids[:first]
    assert len(tr[2].output_ids) == 12


def test_preemption_under_page_pressure(model):
    # 9 pages of 8 tokens; three requests growing to 28 tokens each
    je, te = engines(model, max_batch=3, num_pages=9, burst=2)
    prompts = [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]]
    serve_both(je, te, prompts, [dict(max_new_tokens=24)] * 3)
    assert te.metrics.preemptions == je.metrics.preemptions > 0


def test_stop_strings_and_penalties_with_tokenizer(model):
    tok = ByteTokenizer()
    je, te = engines(model, tokenizer=tok)
    ref, _ = serve_both(*engines(model, tokenizer=tok), [PROMPTS[2]],
                        [dict(max_new_tokens=16, ignore_eos=True)])
    text = tok.decode(ref[0].output_ids)
    stop = text[5:7] if len(text) >= 7 else "\x00never\x00"
    jr, tr = serve_both(je, te, [PROMPTS[2], PROMPTS[1]], [
        dict(max_new_tokens=16, stop_strings=(stop,), ignore_eos=True),
        dict(max_new_tokens=8, repetition_penalty=1.3,
             frequency_penalty=0.4, presence_penalty=0.2,
             logit_bias=((3, 2.5), (9, -100.0)))])
    assert tr[0].final_text == jr[0].final_text


def test_sampled_requests_are_seeded_and_finish(model):
    _, te = engines(model)
    s = SamplingParams(max_new_tokens=8, temperature=0.9, top_k=20,
                       seed=123)
    a = te.generate([PROMPTS[1]], s)
    b = te.generate([PROMPTS[1]], s)
    assert a == b and len(a[0]) == 8


@pytest.mark.parametrize("kw,feature", [
    (dict(sp_prefill_threshold=64), "sequence-parallel"),
    (dict(top_logprobs=2), "top_logprobs"),
    (dict(mesh_shape={"model": 2}), "tensor-parallel"),
    (dict(kv=KVCacheConfig(kv_dtype="fp8")), "FP8 KV"),
])
def test_unsupported_engine_features_raise(model, kw, feature):
    _jcfg, _jp, cfg, tp = model
    base = dict(prefix_cache_entries=0)
    base.update(kw)
    if feature == "FP8 KV":
        # FP8 KV serves, with sliding windows (tests/test_torch_fp8kv_
        # engine.py) and the attention soft cap over e4m3 pools too
        # (tests/test_torch_fp8kv_gemma.py): a capped model over FP8 KV
        # runs, and its greedy tokens and logprobs are the JAX Engine's
        jcfg = dataclasses.replace(_jcfg, attn_logit_softcap=30.0)
        cfg = dataclasses.replace(cfg, attn_logit_softcap=30.0)
        eng = Engine(cfg, tp, EngineConfig(**base), device="cpu")
        with pytest.warns(RuntimeWarning, match="v5e"):
            je = JaxEngine(jcfg, _jp, JaxEngineConfig(
                prefix_cache_entries=0, kv=JaxKVConfig(kv_dtype="fp8")))
        samp = dict(max_new_tokens=4)
        got = eng.add_request(prompt_ids=[1, 2, 3],
                              sampling=SamplingParams(**samp))
        want = je.add_request(prompt_ids=[1, 2, 3],
                              sampling=JaxSampling(**samp))
        eng.run()
        je.run()
        assert eng.cache.k.dtype == torch.float8_e4m3fn
        assert got.output_ids == want.output_ids and len(got.output_ids) == 4
        np.testing.assert_allclose(got.output_logprobs, want.output_logprobs,
                                   rtol=1e-2, atol=1e-2)
        return
    with pytest.raises(NotImplementedError, match=feature):
        Engine(cfg, tp, EngineConfig(**base), device="cpu")


def test_unsupported_request_features_raise(model):
    _, te = engines(model)
    with pytest.raises(NotImplementedError, match="guided decoding"):
        te.add_request(prompt_ids=[1, 2],
                       sampling=SamplingParams(guided_regex="[ab]+"))
    with pytest.raises(NotImplementedError, match="LoRA"):
        te.add_request(prompt_ids=[1, 2], lora="adapter")


def test_capacity_and_queue_rejections(model):
    _, te = engines(model, max_pages=2)          # 16-token capacity
    r = te.add_request(prompt_ids=list(range(1, 12)),
                       sampling=SamplingParams(max_new_tokens=8))
    assert r.state == RequestState.FAILED and "capacity" in r.error


def test_engine_defaults_to_cuda(model):
    _jcfg, _jp, cfg, tp = model
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, tp, EngineConfig(prefix_cache_entries=0))
