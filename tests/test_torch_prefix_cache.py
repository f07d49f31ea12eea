"""The port's Engine with the prefix cache and chunked prefill, against the
JAX package's Engine on the CPU.

Both engines get one JAX parameter draw (``tiny_test``, float32; the port
through ``params_from_jax``), the same ``EngineConfig`` (the prefix cache
at its default of 16 entries unless a scenario sets it) and the same
requests, in the scenarios of the JAX package's own tests
(tests/test_engine.py: chunked prefill, running-request sharing, the
persistent store, eviction, the LRU cap). Greedy tokens and finish states
must be identical, and so must the prefix metrics; logprobs agree within
1e-4 (float32 in another summation order). Each scenario also holds the
port's output against its own uncached run, as the JAX tests do.
"""

import jax
import numpy as np
import pytest
import torch

from simplellminference_tpu.core.config import EngineConfig as JaxEngineConfig
from simplellminference_tpu.core.config import KVCacheConfig as JaxKVConfig
from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.core.config import QuantConfig as JaxQuantConfig
from simplellminference_tpu.core.config import SamplingParams as JaxSampling
from simplellminference_tpu.engine import Engine as JaxEngine
from simplellminference_tpu.models import llama as jllama
from simplellminference_tpu.runtime.weights import (
    quantize_params as jquantize_params)
from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                      KVCacheConfig,
                                                      ModelConfig,
                                                      SamplingParams)
from simplellminference_tpu_torch.engine import Engine, RequestState
from simplellminference_tpu_torch.models.convert import params_from_jax

METRICS = ("prefix_cache_hits", "prompt_tokens_cached",
           "prefix_cache_persistent_hits", "prefix_cache_evictions",
           "preemptions", "prefills", "prompt_tokens", "requests_finished",
           "requests_cancelled", "tokens_generated")


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


def _model(quant: bool):
    jcfg = JaxModelConfig.tiny_test()
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    if quant:
        jp = jquantize_params(jp, JaxQuantConfig(mode="int8", group_size=0,
                                                 quantize_lm_head=True))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, ModelConfig.tiny_test(), tp


@pytest.fixture(scope="module")
def model():
    return _model(quant=False)


class Pair:
    """A JAX Engine and a port Engine built from one configuration, fed
    the same calls."""

    def __init__(self, model, max_batch=4, num_pages=64, page_size=8,
                 burst=4, max_pages=16, **ecfg):
        jcfg, jp, cfg, tp = model
        kv = dict(page_size=page_size, num_pages=num_pages,
                  max_pages_per_seq=max_pages, kv_dtype="f32")
        self.je = JaxEngine(jcfg, jp, JaxEngineConfig(
            max_batch_size=max_batch, kv=JaxKVConfig(**kv), **ecfg),
            decode_burst=burst)
        self.te = Engine(cfg, tp, EngineConfig(
            max_batch_size=max_batch, kv=KVCacheConfig(**kv), **ecfg),
            decode_burst=burst, device="cpu")
        self.pending = []

    def add(self, prompt, **samp):
        a = self.je.add_request(prompt_ids=list(prompt),
                                sampling=JaxSampling(**samp))
        b = self.te.add_request(prompt_ids=list(prompt),
                                sampling=SamplingParams(**samp))
        self.pending.append((a, b))
        return a, b

    def step(self):
        self.je.step()
        self.te.step()

    def run(self):
        self.je.run()
        self.te.run()
        self.check()

    def check(self):
        for a, b in self.pending:
            assert b.output_ids == a.output_ids, (a.req_id, a.prompt_ids)
            assert b.state.value == a.state.value
            assert b.cached_len == a.cached_len
            np.testing.assert_allclose(b.output_logprobs, a.output_logprobs,
                                       rtol=1e-4, atol=1e-4)
        for name in METRICS:
            assert getattr(self.te.metrics, name) == getattr(
                self.je.metrics, name), name
        np.testing.assert_array_equal(self.te.allocator.table(),
                                      self.je.allocator.table())
        assert self.te.allocator.num_free == self.je.allocator.num_free
        assert list(self.te._prefix_store) == list(self.je._prefix_store)

    def generate(self, prompts, **samp):
        reqs = [self.add(p, **samp) for p in prompts]
        self.run()
        return [b.output_ids for _a, b in reqs]


def solo(model, prompt, **samp):
    """The port's uncached greedy output for one prompt (fresh engine,
    nothing to share, whole-prompt prefill)."""
    _jcfg, _jp, cfg, tp = model
    eng = Engine(cfg, tp, EngineConfig(
        max_batch_size=4, prefix_cache_entries=0,
        kv=KVCacheConfig(page_size=8, num_pages=64, max_pages_per_seq=16,
                         kv_dtype="f32")), decode_burst=4, device="cpu")
    return eng.generate([prompt], SamplingParams(**samp))[0]


def test_default_engine_config_serves(model):
    # the JAX Engine's default configuration (the server CLI's): prefix
    # cache on with 16 entries
    _jcfg, _jp, cfg, tp = model
    ecfg = EngineConfig(kv=KVCacheConfig(page_size=8, num_pages=64,
                                         max_pages_per_seq=16,
                                         kv_dtype="f32"))
    assert ecfg.prefix_cache_entries == 16 and ecfg.prefill_chunk == 0
    eng = Engine(cfg, tp, ecfg, device="cpu")
    out = eng.generate([[1, 2, 3, 4, 5, 6, 7, 8, 9], [1, 2, 3, 4, 5, 6, 7, 8,
                                                      9, 10]],
                       SamplingParams(max_new_tokens=5))
    assert [len(o) for o in out] == [5, 5]
    assert eng.metrics.prefix_cache_hits == 1
    assert list(eng._prefix_store) == [(None, (1, 2, 3, 4, 5, 6, 7, 8))]


@pytest.mark.parametrize("chunk", [12, 16], ids=["not-page-multiple",
                                                 "page-multiple"])
def test_prefill_chunk_gate_matches_jax(model, chunk):
    # a chunk size that is not a page multiple leaves prompts whole
    rng = np.random.default_rng(chunk)
    pair = Pair(model, prefill_chunk=chunk, prefix_cache_entries=0)
    pair.generate([rng.integers(1, 256, 40).tolist()], max_new_tokens=4)


def test_chunked_prefill_matches_whole(model):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 256, 70).tolist(),
               rng.integers(1, 256, 33).tolist()]
    pair = Pair(model, prefill_chunk=32, prefix_cache_entries=0)
    got = pair.generate(prompts, max_new_tokens=8)
    assert got == [solo(model, p, max_new_tokens=8) for p in prompts]
    assert pair.te.metrics.prefills == 2


def test_prefix_cache_matches_uncached(model):
    rng = np.random.default_rng(3)
    base = rng.integers(1, 256, 40).tolist()
    prompts = [base, list(base), base[:24] + [7, 8, 9]]
    pair = Pair(model)
    got = pair.generate(prompts, max_new_tokens=8)
    assert got == [solo(model, p, max_new_tokens=8) for p in prompts]
    # req 1 shares base's full pages (40 capped at 39 -> 32 tokens), req 2
    # shares 24 tokens
    assert pair.te.metrics.prefix_cache_hits == 2
    assert pair.te.metrics.prompt_tokens_cached == 32 + 24


def test_prefix_cache_survives_source_finish(model):
    rng = np.random.default_rng(4)
    base = rng.integers(1, 256, 32).tolist()
    pair = Pair(model, max_batch=2)
    _, r1 = pair.add(base, max_new_tokens=2)
    _, r2 = pair.add(list(base), max_new_tokens=12)
    pair.run()
    want = solo(model, base, max_new_tokens=12)
    assert r1.output_ids == want[:2] and r2.output_ids == want
    assert pair.te.metrics.prefix_cache_hits == 1


def test_persistent_prefix_cache_sequential(model):
    rng = np.random.default_rng(11)
    base = rng.integers(1, 256, 40).tolist()
    pair = Pair(model)
    _, r1 = pair.add(base, max_new_tokens=8)
    pair.run()
    assert not pair.te.has_work and len(pair.te._prefix_store) == 1
    _, r2 = pair.add(list(base), max_new_tokens=8)
    pair.run()
    assert r1.output_ids == r2.output_ids == solo(model, base,
                                                  max_new_tokens=8)
    assert pair.te.metrics.prefix_cache_persistent_hits == 1
    assert r2.cached_len == 32


def test_persistent_prefix_partial_and_exact_match(model):
    rng = np.random.default_rng(12)
    base = rng.integers(1, 256, 32).tolist()     # page-aligned
    short = base[:16] + [3, 1]
    pair = Pair(model)
    pair.generate([base], max_new_tokens=6)
    _, r_exact = pair.add(list(base), max_new_tokens=6)
    pair.run()
    _, r_short = pair.add(short, max_new_tokens=6)
    pair.run()
    assert r_exact.output_ids == solo(model, base, max_new_tokens=6)
    assert r_exact.cached_len == 24
    assert r_short.output_ids == solo(model, short, max_new_tokens=6)
    assert r_short.cached_len == 16


def test_persistent_prefix_evicts_under_pressure(model):
    # 10 pages of 8: each request peaks at 5 pages; the retained 3 pages
    # of each finished prompt must be evicted, never a live request
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, 256, 24).tolist() for _ in range(3)]
    pair = Pair(model, max_batch=1, num_pages=10)
    for p in prompts:
        assert pair.generate([p], max_new_tokens=16)[0] == solo(
            model, p, max_new_tokens=16)
    assert pair.te.metrics.prefix_cache_evictions > 0
    assert pair.te.metrics.preemptions == 0


def test_preemption_with_shared_pages_matches_jax(model):
    # three requests sharing a 16-token prefix grow past a 12-page pool:
    # retained prefixes are evicted first, then the youngest is preempted
    # and re-admitted (re-sharing its prefix); refcounts keep the shared
    # pages alive throughout
    rng = np.random.default_rng(19)
    base = rng.integers(1, 256, 16).tolist()
    pair = Pair(model, max_batch=3, num_pages=12, burst=2, prefill_chunk=8)
    for i in range(3):
        pair.add(base + [i + 1, i + 2], max_new_tokens=20)
    pair.run()
    assert pair.te.metrics.preemptions > 0
    assert pair.te.metrics.prefix_cache_hits >= 2


def test_persistent_prefix_store_lru_cap(model):
    rng = np.random.default_rng(14)
    pair = Pair(model, max_batch=2, prefix_cache_entries=2)
    for _ in range(5):
        pair.generate([rng.integers(1, 256, 16).tolist()], max_new_tokens=4)
        assert len(pair.te._prefix_store) <= 2
    assert pair.te.metrics.prefix_cache_evictions >= 3


def test_chunked_suffix_of_a_cached_prefix(model):
    # a long prompt behind a retained prefix: the uncached remainder is
    # longer than the chunk, so it runs the chunk loop from the cached
    # offset (the "others" dispatch), after an uncached whole prompt of
    # the same admit cycle
    rng = np.random.default_rng(15)
    base = rng.integers(1, 256, 24).tolist()
    long = base + rng.integers(1, 256, 50).tolist()
    pair = Pair(model, prefill_chunk=16)
    pair.generate([base], max_new_tokens=3)
    _, r = pair.add(long, max_new_tokens=6)
    pair.add([9, 8, 7], max_new_tokens=6)
    pair.run()
    assert r.cached_len == 24
    assert r.output_ids == solo(model, long, max_new_tokens=6)


def test_cancel_and_flush_match_jax(model):
    rng = np.random.default_rng(16)
    base = rng.integers(1, 256, 40).tolist()
    pair = Pair(model, max_batch=2)
    run_a, run_t = pair.add(base, max_new_tokens=12)
    pair.add(list(base), max_new_tokens=12)
    wait_a, wait_t = pair.add(base[:16] + [5], max_new_tokens=4)
    pair.step()
    # RUNNING (its pages are shared with the other running request) and
    # WAITING requests; a second cancel is refused
    for a, b in ((run_a, run_t), (wait_a, wait_t)):
        assert pair.je.cancel(a) and pair.te.cancel(b)
        assert b.state == RequestState.CANCELLED and b.slot == -1
        assert not pair.je.cancel(a) and not pair.te.cancel(b)
    pair.run()
    assert pair.te.metrics.requests_cancelled == 2
    assert len(pair.te._prefix_store) == 1
    assert pair.je.flush_prefix_cache() == pair.te.flush_prefix_cache() == 1
    assert pair.te.allocator.num_free == pair.je.allocator.num_free == 64
    assert pair.te.flush_prefix_cache() == 0
    pair.check()


def test_server_traffic_shape_counts_dispatches(model, monkeypatch):
    # chip_smoke.py's `prefix` path at a small size: one request whose
    # prompt (a 32-token system prompt + a 4-token user suffix, page 8)
    # prefills as 3 chunks of 16; after its first step, 7 more with their
    # own suffixes share its 32 tokens and prefill as ONE suffix batch;
    # after all finish, 8 more hit the persistent store as one suffix
    # batch. Dispatches through the chunk path: 3 + 1 + 1, none whole.
    rng = np.random.default_rng(17)
    system = rng.integers(1, 256, 32).tolist()
    pair = Pair(model, max_batch=8, num_pages=128, prefill_chunk=16)
    calls = {"jax_chunk": 0, "jax_whole": 0, "chunk": 0, "whole": 0}
    for name, key in (("_prefill_chunk_fn", "chunk"),
                      ("_prefill_fn", "whole")):
        for eng, tag in ((pair.je, "jax_" + key), (pair.te, key)):
            orig = getattr(eng, name)

            def spy(*a, _orig=orig, _tag=tag, **kw):
                calls[_tag] += 1
                return _orig(*a, **kw)
            monkeypatch.setattr(eng, name, spy)

    def prompt():
        return system + rng.integers(1, 256, 4).tolist()

    pair.add(prompt(), max_new_tokens=12)
    pair.step()
    for _ in range(7):
        pair.add(prompt(), max_new_tokens=12)
    pair.run()
    for _ in range(8):
        pair.add(prompt(), max_new_tokens=12)
    pair.run()
    assert calls == {"jax_chunk": 5, "jax_whole": 0, "chunk": 5, "whole": 0}
    m = pair.te.metrics
    assert (m.prefix_cache_hits, m.prefix_cache_persistent_hits) == (15, 8)
    assert m.requests_finished == 16


def test_int8_weights_prefix_cache_and_chunks_match_jax():
    # a chunk loop, a suffix batch of two persistent hits, and a chunk
    # loop behind a persistent hit, with INT8 weights
    model = _model(quant=True)
    rng = np.random.default_rng(18)
    base = rng.integers(1, 256, 40).tolist()
    pair = Pair(model, prefill_chunk=16)
    pair.generate([base], max_new_tokens=6)
    pair.generate([list(base), base[:32] + [4, 5]], max_new_tokens=6)
    pair.generate([base + rng.integers(1, 256, 30).tolist()],
                  max_new_tokens=6)
    assert pair.te.metrics.prefix_cache_persistent_hits == 3
    assert pair.te.metrics.prefix_cache_hits == 3
