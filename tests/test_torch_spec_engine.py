"""Prompt-lookup speculative decoding through the port's ``forward_paged``
and Engine, against the JAX package on the CPU.

One JAX parameter draw of ``ModelConfig.tiny_test()`` (2 layers, GQA),
float32 and INT8 (per output channel, INT8 LM head), carried to the port
with ``params_from_jax``. Stated tolerances:
- ``forward_paged`` with a verify window: logits within 1e-4 and f32
  pools within 1e-5 (sums in another order); over INT8 KV, logits within
  1e-4 while both caches hold the same codes and 1e-3 once a code is one
  apart (tests/test_torch_int8kv_engine.py says why).
- Engines: greedy tokens, finish states and the speculative metrics
  (``spec_steps``, ``spec_accepted``) identical to the JAX spec Engine's,
  and the tokens identical to the port's non-spec Engine's; logprobs
  within 1e-4. Sampled rows draw other random bits than JAX's, so they
  are held to their distribution, not to JAX's tokens.
"""

from collections import Counter

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
from simplellminference_tpu.runtime.weights import (
    quantize_params as jquantize_params)
from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                      KVCacheConfig,
                                                      ModelConfig,
                                                      SamplingParams)
from simplellminference_tpu_torch.engine import Engine, RequestState
from simplellminference_tpu_torch.memory.paged_kv import PagedKVCache
from simplellminference_tpu_torch.models import llama as tllama
from simplellminference_tpu_torch.models.convert import params_from_jax
from simplellminference_tpu_torch.ops.attention import dispatch

REPETITIVE = [([5, 6, 7, 8] * 6)[:20], [9, 1, 2, 3, 9, 1, 2, 3, 9, 1, 2, 3]]
TERMINAL = {RequestState.FINISHED, RequestState.FAILED,
            RequestState.CANCELLED}


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


def _params(kind):
    jcfg = JaxModelConfig.tiny_test()
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    if kind == "int8":
        jp = jquantize_params(jp, JaxQuantConfig(mode="int8", group_size=0,
                                                 quantize_lm_head=True))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, ModelConfig.tiny_test(), tp


@pytest.fixture(scope="module")
def model():
    return _params("float")


@pytest.fixture(scope="module")
def int8_model():
    return _params("int8")


# ---------------------------------------------------------- forward_paged

PS, PAGES = 8, 24
TABLES = np.asarray([[3, 9, 4, 11, 0, 15, 7, 19, 21],
                     [5, 1, 13, 2, 17, 6, 8, 10, 12]], np.int32)


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("kind", ["float", "int8"])
def test_forward_paged_verify_window_matches_jax(model, int8_model, kind,
                                                 kv, monkeypatch):
    jcfg, jp, cfg, tp = model if kind == "float" else int8_model
    verify = []
    orig = dispatch.paged_flash_verify
    monkeypatch.setattr(dispatch, "paged_flash_verify",
                        lambda *a, **k: verify.append(a[0].shape) or orig(
                            *a, **k))
    jdt, tdt = (jnp.int8, torch.int8) if kv == "int8" else (jnp.float32,
                                                           torch.float32)
    jc = JaxCache.create(cfg.num_layers, PAGES, cfg.num_kv_heads, PS,
                         cfg.head_dim, jdt)
    tc = PagedKVCache.create(cfg.num_layers, PAGES, cfg.num_kv_heads, PS,
                             cfg.head_dim, tdt, device="cpu")
    rng = np.random.default_rng(1)
    lens = np.asarray([13, 6], np.int32)
    toks = rng.integers(1, cfg.vocab_size, (2, 16)).astype(np.int32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()

    def both(toks, pos, lens, prefill, jc, tc):
        jl, jc = jllama.forward_paged(
            jcfg, jp, jnp.asarray(toks), jnp.asarray(pos), jc,
            jnp.asarray(TABLES), jnp.asarray(lens), prefill=prefill,
            last_token_only=prefill)
        tl, tc = tllama.forward_paged(
            cfg, tp, torch.from_numpy(toks), torch.from_numpy(pos), tc,
            torch.from_numpy(TABLES), torch.from_numpy(lens),
            prefill=prefill, last_token_only=prefill)
        same = kv != "int8" or all(
            np.array_equal(a.numpy()[:, :-1], np.asarray(b)[:, :-1])
            for a, b in ((tc.k, jc.k), (tc.v, jc.v)))
        tol = 1e-4 if same else 1e-3
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                                   atol=tol)
        return jl, jc, tl, tc

    jl, jc, tl, tc = both(toks, pos, lens, True, jc, tc)
    # three verify windows of 5, 3 and 8 rows; windows cross pages
    for s in (5, 3, 8):
        win = rng.integers(1, cfg.vocab_size, (2, s)).astype(np.int32)
        wpos = lens[:, None] + np.arange(s, dtype=np.int32)[None]
        jl, jc, tl, tc = both(win, wpos, lens + s, False, jc, tc)
        assert tl.shape == (2, s, cfg.vocab_size)
        lens = lens + s - 1          # as if all but the last row accepted
    assert [v[1] for v in verify] == [s for s in (5, 3, 8)
                                      for _ in range(cfg.num_layers)]
    if kv == "f32":
        for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
            np.testing.assert_allclose(a.numpy()[:, :-1],
                                       np.asarray(b)[:, :-1], rtol=1e-5,
                                       atol=1e-5)
    else:
        for a, b in ((tc.k_scale, jc.k_scale), (tc.v_scale, jc.v_scale)):
            np.testing.assert_allclose(a.numpy()[:, :-1],
                                       np.asarray(b)[:, :-1], rtol=1e-5,
                                       atol=1e-12)
        for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
            assert np.abs(a.numpy()[:, :-1].astype(int)
                          - np.asarray(b)[:, :-1]).max() <= 1


# ---------------------------------------------------------------- engines

def _kv(kv_dtype, num_pages=64, max_pages=24):
    return dict(page_size=8, num_pages=num_pages,
                max_pages_per_seq=max_pages, kv_dtype=kv_dtype)


def jax_engine(m, spec, burst=3, kv_dtype="f32", max_batch=4, **ecfg):
    jcfg, jp, _cfg, _tp = m
    kv = _kv(kv_dtype, **{k: ecfg.pop(k) for k in ("num_pages", "max_pages")
                          if k in ecfg})
    return JaxEngine(jcfg, jp, JaxEngineConfig(
        max_batch_size=max_batch, spec_tokens=spec, kv=JaxKVConfig(**kv),
        **ecfg), decode_burst=burst)


def port_engine(m, spec, burst=3, kv_dtype="f32", max_batch=4, **ecfg):
    _jcfg, _jp, cfg, tp = m
    kv = _kv(kv_dtype, **{k: ecfg.pop(k) for k in ("num_pages", "max_pages")
                          if k in ecfg})
    return Engine(cfg, tp, EngineConfig(
        max_batch_size=max_batch, spec_tokens=spec, kv=KVCacheConfig(**kv),
        **ecfg), decode_burst=burst, device="cpu")


def serve(eng, prompts, samplings, jax_side=False):
    cls = JaxSampling if jax_side else SamplingParams
    reqs = [eng.add_request(prompt_ids=list(p), sampling=cls(**s))
            for p, s in zip(prompts, samplings)]
    eng.run()
    return reqs


def check_against_jax(m, prompts, samplings, spec=3, **kw):
    """The port's spec Engine against the JAX spec Engine and the port's
    non-spec Engine on the same requests: tokens, states, logprobs and
    the speculative metrics. Returns the port spec Engine."""
    je = jax_engine(m, spec, **dict(kw))
    jr = serve(je, prompts, samplings, jax_side=True)
    te = port_engine(m, spec, **dict(kw))
    tr = serve(te, prompts, samplings)
    base = serve(port_engine(m, 0, **dict(kw)), prompts, samplings)
    for a, b, c in zip(jr, tr, base):
        assert b.output_ids == a.output_ids == c.output_ids, a.prompt_ids
        assert b.state.value == a.state.value
        np.testing.assert_allclose(b.output_logprobs, a.output_logprobs,
                                   rtol=1e-4, atol=1e-4)
    _spec_metrics_equal(te, je)
    return te


def _spec_metrics_equal(te, je):
    for name in ("spec_steps", "spec_accepted", "preemptions",
                 "prefix_cache_hits", "prompt_tokens_cached", "prefills",
                 "tokens_generated"):
        assert getattr(te.metrics, name) == getattr(je.metrics, name), name


ENGINE_CASES = {
    "f32-kv": dict(kv_dtype="f32", prefix_cache_entries=0),
    "bf16-kv": dict(kv_dtype="bf16", prefix_cache_entries=0),
    "int8-kv": dict(kv_dtype="int8", prefix_cache_entries=0),
    "prefix-cache-and-chunks": dict(kv_dtype="f32", prefill_chunk=16),
    "int8-kv-prefix-cache-and-chunks": dict(kv_dtype="int8",
                                            prefill_chunk=16),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
@pytest.mark.parametrize("kind", ["float", "int8"])
def test_spec_engine_greedy_matches_jax_and_non_spec(model, int8_model,
                                                     kind, case):
    """Greedy outputs equal the JAX spec Engine's and the port's non-spec
    Engine's, with the same verify steps and accepted drafts (JAX
    test_engine.py:223, over every KV kind, with the prefix cache and
    chunked prefill); drafts get accepted on repetitive prompts."""
    m = model if kind == "float" else int8_model
    rng = np.random.default_rng(5)
    system = rng.integers(1, 250, 24).tolist()
    prompts = REPETITIVE + [rng.integers(1, 250, 13).tolist(),
                            system + [4, 4, 4], system + [7, 1]]
    samplings = [dict(max_new_tokens=n) for n in (24, 17, 24, 9, 12)]
    te = check_against_jax(m, prompts, samplings, **ENGINE_CASES[case])
    assert te.metrics.spec_steps > 0 and te.metrics.spec_accepted > 0
    assert te.metrics.requests_finished == len(prompts)
    if ENGINE_CASES[case].get("prefill_chunk"):
        assert te.metrics.prefix_cache_hits > 0


@pytest.mark.parametrize("spec", list(range(1, 8)))
def test_every_window_size_serves(model, spec):
    """spec_tokens 1..7 (windows of 2..8 rows) serve the non-spec greedy
    tokens, with the JAX Engine's acceptance counts."""
    check_against_jax(model, REPETITIVE, [dict(max_new_tokens=20)] * 2,
                      spec=spec, burst=2)


def test_spec_with_sampling_and_stops(model):
    """A stop token truncates a greedy row mid-span; a sampled row inside
    the speculative batch emits its full length (JAX test_engine.py:248)."""
    base = serve(port_engine(model, 0), [[5, 6, 7, 8] * 5],
                 [dict(max_new_tokens=16)])[0].output_ids
    stop = base[7]
    prompts = [[5, 6, 7, 8] * 5, [1, 2, 3]]
    samplings = [dict(max_new_tokens=16, stop_token_ids=(stop,)),
                 dict(max_new_tokens=10, temperature=0.9, top_k=20, seed=4)]
    je = jax_engine(model, 3)
    jr = serve(je, prompts, samplings, jax_side=True)
    tr = serve(port_engine(model, 3), prompts, samplings)
    assert tr[0].output_ids == jr[0].output_ids == base[:7]
    assert len(tr[1].output_ids) == len(jr[1].output_ids) == 10
    assert all(r.state == RequestState.FINISHED for r in tr)


def test_spec_respects_penalties_and_logit_bias(model):
    """Rows with penalties fall back to one penalized sample per verify
    step and produce the non-spec tokens; logit_bias shapes greedy
    acceptance (JAX test_engine.py:373)."""
    prompts = [[5, 6, 7, 8] * 5, [1, 2, 3, 1, 2, 3], [9, 1, 2, 3] * 3]
    samplings = [dict(max_new_tokens=14, repetition_penalty=1.6),
                 dict(max_new_tokens=14, repetition_penalty=1.6),
                 dict(max_new_tokens=14, logit_bias=((2, 3.0), (3, -100.0)))]
    te = check_against_jax(model, prompts, samplings)
    assert te.metrics.spec_steps > 0


def test_spec_stochastic_rows_accept(model):
    """temperature 1.0 with top_k=1 is a point mass on the argmax:
    rejection sampling accepts exactly the drafts greedy acceptance would
    (JAX test_engine.py:510)."""
    prompt = ([5, 6, 7, 8] * 6)[:20]
    base = serve(port_engine(model, 0, max_batch=2), [prompt],
                 [dict(max_new_tokens=24)])[0].output_ids
    eng = port_engine(model, 3, max_batch=2)
    r = serve(eng, [prompt], [dict(max_new_tokens=24, temperature=1.0,
                                   top_k=1, seed=3)])[0]
    assert r.output_ids == base
    assert eng.metrics.spec_accepted > 0, \
        "stochastic row accepted zero drafts (rejection sampling dead)"


def test_spec_sampling_marginals(model):
    """The joint law of the first two sampled tokens under speculation
    matches the non-spec engine's (JAX test_engine.py:542): top_k=2
    keeps the outcome space small; total variation over 192 seeds."""
    prompt = ([5, 6, 7, 8] * 5)[:20]
    n = 192

    def run_mode(spec):
        eng = port_engine(model, spec, burst=2, max_batch=8, num_pages=256,
                          max_pages=8)
        reqs = serve(eng, [prompt] * n, [dict(
            max_new_tokens=2, temperature=1.5, top_k=2, seed=1000 + i)
            for i in range(n)])
        assert (eng.metrics.spec_steps > 0) == bool(spec)
        return Counter(tuple(r.output_ids) for r in reqs)

    base, spec = run_mode(0), run_mode(3)
    keys = set(base) | set(spec)
    tv = 0.5 * sum(abs(base.get(k, 0) - spec.get(k, 0)) for k in keys) / n
    # ~4 outcomes, n=192 each: noise ~0.08; a draft-biased sampler >~ 0.4
    assert tv < 0.2, (tv, base, spec)


def test_spec_preemption_under_page_pressure_matches_jax(model):
    """9 pages of 8 tokens, three requests growing to 28 tokens each:
    the spec Engine preempts as the JAX spec Engine does and still serves
    the non-spec tokens."""
    prompts = [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]]
    te = check_against_jax(model, prompts, [dict(max_new_tokens=24)] * 3,
                           num_pages=9, max_pages=16, max_batch=3, burst=2)
    assert te.metrics.preemptions > 0


@pytest.mark.parametrize("spec", [0, 3])
def test_engine_chaos_invariants(model, spec):
    """Randomized soak of admits, cancels, preemptions, prefix sharing,
    speculation and mixed sampling (JAX test_engine_chaos.py:23): every
    request ends in a terminal state within its length, and every page
    returns to the pool."""
    eng = port_engine(model, spec, max_batch=3, num_pages=40, max_pages=12,
                      max_queue=64)
    rng = np.random.default_rng(42 + spec)
    vocab = model[2].vocab_size
    base = rng.integers(1, vocab, 24).tolist()
    reqs = []

    def submit():
        if rng.random() < 0.4:  # shared prefix candidates
            ids = base[:16] + rng.integers(1, vocab,
                                           rng.integers(1, 20)).tolist()
        else:
            ids = rng.integers(1, vocab, rng.integers(1, 40)).tolist()
        sp = SamplingParams(
            max_new_tokens=int(rng.integers(1, 20)),
            temperature=float(rng.choice([0.0, 0.0, 0.9])),
            top_k=int(rng.choice([0, 20])),
            repetition_penalty=float(rng.choice([1.0, 1.0, 1.4])))
        reqs.append(eng.add_request(prompt_ids=ids, sampling=sp))

    steps = 0
    for _ in range(8):
        submit()
    while eng.has_work or len(reqs) < 40:
        if len(reqs) < 40 and rng.random() < 0.5:
            submit()
        if reqs and rng.random() < 0.15:
            eng.cancel(reqs[int(rng.integers(0, len(reqs)))])
        eng.step()
        steps += 1
        assert steps < 2000, "engine livelocked"
    for r in reqs:
        assert r.state in TERMINAL, (r.req_id, r.state)
        assert len(r.output_ids) <= r.sampling.max_new_tokens
    eng.flush_prefix_cache()
    assert eng.allocator.num_free == 40, "page leak"
    m = eng.metrics
    assert (m.requests_finished + m.requests_failed
            + m.requests_cancelled) == len(reqs)
    assert (m.spec_steps > 0) == bool(spec)


def test_spec_capacity_leaves_room_for_the_window(model):
    """A request must leave spec_tokens of headroom below the per-sequence
    capacity (JAX engine.py:827-828)."""
    eng = port_engine(model, 3, max_pages=2)            # 16-token capacity
    ok = eng.add_request(prompt_ids=[1] * 5, sampling=SamplingParams(
        max_new_tokens=8))
    bad = eng.add_request(prompt_ids=[1] * 6, sampling=SamplingParams(
        max_new_tokens=8))
    assert ok.state == RequestState.WAITING
    assert bad.state == RequestState.FAILED and "capacity 13" in bad.error


@pytest.mark.parametrize("kw,exc,match", [
    (dict(spec_tokens=8), ValueError, "spec_tokens in"),
    (dict(spec_tokens=-1), ValueError, "spec_tokens in"),
    (dict(spec_tokens=2, top_logprobs=2), ValueError, "incompatible"),
])
def test_spec_config_errors(model, kw, exc, match):
    _jcfg, _jp, cfg, tp = model
    with pytest.raises(exc, match=match):
        Engine(cfg, tp, EngineConfig(**kw), device="cpu")


def test_draft_model_speculation_raises(model):
    # draft-model speculation is ported (tests/test_torch_draft_spec.py);
    # without spec_tokens it raises, where the JAX engine asserts
    _jcfg, _jp, cfg, tp = model
    with pytest.raises(ValueError, match="draft-model"):
        Engine(cfg, tp, EngineConfig(spec_tokens=0), device="cpu",
               draft=(cfg, tp))
