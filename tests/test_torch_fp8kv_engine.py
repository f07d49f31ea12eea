"""FP8 (e4m3) KV through the port's ``forward_paged`` and Engine, against the
JAX package on the CPU.

One JAX parameter draw of ``ModelConfig.tiny_test()`` (2 layers, GQA),
float32 and INT8 (per output channel, INT8 LM head: bench.py's weights),
carried to the port with ``params_from_jax``; both packages' caches are
float8_e4m3fn pools. The JAX package runs its CPU path (scatter writes
with its e4m3 cast, gather + dense attention); the port its plain
versions, which with INT8 weights include the fused qkv at decode, its
k/v rounded from f32 to e4m3 once. Stated tolerances: on every page but
the trash page, codes at most one e4m3 step apart and apart in under 1e-3
of the entries (k/v come from sums in another order, about 1e-6 apart as
the f32 pools of tests/test_torch_engine.py, so a value next to a
rounding midpoint may take the neighbouring code); logits within 1e-4
while both caches hold the same codes and within 1e-2 once a code is one
step (up to 1/8 of its value) apart; greedy tokens, prefix and
speculation metrics identical.
"""

import warnings

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
from simplellminference_tpu_torch.engine import Engine
from simplellminference_tpu_torch.memory.paged_kv import PagedKVCache
from simplellminference_tpu_torch.models import llama as tllama
from simplellminference_tpu_torch.models.convert import params_from_jax
from simplellminference_tpu_torch.ops import qkv_fused

PS, PAGES = 8, 20
E4 = torch.float8_e4m3fn
TABLES = np.asarray([[3, 9, 4, 11, 0, 15, 7, 19],
                     [5, 1, 13, 2, 17, 6, 8, 10]], np.int32)
LOGIT_TOL_CODE_APART = 1e-2
METRICS = ("prefix_cache_hits", "prompt_tokens_cached",
           "prefix_cache_persistent_hits", "prefix_cache_evictions",
           "preemptions", "prefills", "prompt_tokens", "requests_finished",
           "tokens_generated", "spec_steps", "spec_accepted")


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


@pytest.fixture(scope="module", params=["float", "int8"])
def model(request):
    jcfg = JaxModelConfig.tiny_test()
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    if request.param == "int8":
        jp = jquantize_params(jp, JaxQuantConfig(mode="int8", group_size=0,
                                                 quantize_lm_head=True))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return request.param, jcfg, jp, ModelConfig.tiny_test(), tp


def caches(cfg):
    jc = JaxCache.create(cfg.num_layers, PAGES, cfg.num_kv_heads, PS,
                         cfg.head_dim, jnp.float8_e4m3fn)
    tc = PagedKVCache.create(cfg.num_layers, PAGES, cfg.num_kv_heads, PS,
                             cfg.head_dim, E4, device="cpu")
    assert tc.k_scale is None and jc.k_scale is None
    return jc, tc


def _codes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _ordinal(u8):
    """e4m3 codes in value order: +-0 both 0, one step per code."""
    mag = (u8 & 0x7F).astype(int)
    return np.where(u8 & 0x80, -mag, mag)


def assert_codes_close(tc, jc):
    """Trash page excluded: codes at most one step apart, in under 1e-3 of
    the entries (pools of no layer, as the grouped engine's main pools
    of a model whose every layer slides, are equal)."""
    for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
        t, j = _codes(t)[:, :-1], _codes(j)[:, :-1]
        assert t.shape == j.shape
        if not t.size:
            continue
        assert np.abs(_ordinal(t) - _ordinal(j)).max() <= 1
        assert (t != j).mean() < 1e-3, (t != j).mean()


def same_codes(tc, jc) -> bool:
    return all(np.array_equal(_codes(t)[:, :-1], _codes(j)[:, :-1])
               for t, j in ((tc.k, jc.k), (tc.v, jc.v)))


def both(jcfg, jp, jc, cfg, tp, tc, toks, pos, lens, **kw):
    """One forward_paged call of each package on the same inputs: logits
    within 1e-4 while both caches hold the same codes, within
    LOGIT_TOL_CODE_APART once a code is a step apart; the same greedy
    token."""
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    jl, jc = jllama.forward_paged(jcfg, jp, jnp.asarray(toks),
                                  jnp.asarray(pos), jc, jnp.asarray(TABLES),
                                  jnp.asarray(lens), **jkw)
    tl, tc = tllama.forward_paged(cfg, tp, torch.from_numpy(toks),
                                  torch.from_numpy(pos), tc,
                                  torch.from_numpy(TABLES),
                                  torch.from_numpy(lens), **tkw)
    tol = 1e-4 if same_codes(tc, jc) else LOGIT_TOL_CODE_APART
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                               atol=tol)
    np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(),
                                  np.asarray(jl)[:, -1].argmax(-1))
    return jl, jc, tl, tc


def test_forward_paged_fp8kv_prefill_and_decode_match_jax(model,
                                                          monkeypatch):
    kind, jcfg, jp, cfg, tp = model
    fused = []
    orig = qkv_fused.fused_qkv_append

    def spy(*a, **kw):
        fused.append(a[6].dtype)
        return orig(*a, **kw)
    monkeypatch.setattr(qkv_fused, "fused_qkv_append", spy)
    rng = np.random.default_rng(3)
    lens = np.asarray([13, 7], np.int32)
    toks = rng.integers(1, cfg.vocab_size, (2, 16)).astype(np.int32)
    toks[np.arange(16)[None] >= lens[:, None]] = 0
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    jc, tc = caches(cfg)
    jl, jc, tl, tc = both(jcfg, jp, jc, cfg, tp, tc, toks, pos, lens,
                          prefill=True, last_token_only=True)
    tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    for _ in range(3):
        jl, jc, tl, tc = both(jcfg, jp, jc, cfg, tp, tc, tok[:, None],
                              lens[:, None], lens + 1, prefill=False)
        tok = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)
        lens = lens + 1
    assert_codes_close(tc, jc)
    assert _codes(tc.k).any() and tc.k.dtype == E4
    # INT8 weights: the fused qkv over e4m3 pools at every decode step
    assert fused == ([E4] * 3 * cfg.num_layers if kind == "int8" else [])


def test_forward_paged_fp8kv_chunked_and_verify_match_jax(model):
    _kind, jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, cfg.vocab_size, (2, 72)).astype(np.int32)
    jc, tc = caches(cfg)
    # row 0 runs three chunks, row 1 starts one page in: per-row offsets
    for s, offs, lens in [(16, [0, 0], [16, 8]), (16, [16, 8], [32, 24]),
                          (40, [32, 24], [61, 50])]:
        offs = np.asarray(offs, np.int32)
        lens = np.asarray(lens, np.int32)
        toks = np.stack([prompt[i, o:o + s] for i, o in enumerate(offs)])
        toks = np.where(offs[:, None] + np.arange(s)[None] < lens[:, None],
                        toks, 0).astype(np.int32)
        pos = offs[:, None] + np.arange(s, dtype=np.int32)[None]
        jl, jc, tl, tc = both(jcfg, jp, jc, cfg, tp, tc, toks, pos, lens,
                              prefill=True, last_token_only=True,
                              chunk_offset=offs)
    # a speculative verify window of 3 rows (span write, verify attention)
    toks = rng.integers(1, cfg.vocab_size, (2, 3)).astype(np.int32)
    pos = lens[:, None] + np.arange(3, dtype=np.int32)[None]
    jl, jc, tl, tc = both(jcfg, jp, jc, cfg, tp, tc, toks, pos, lens + 3,
                          prefill=False)
    assert_codes_close(tc, jc)


class Pair:
    """A JAX Engine and a port Engine over FP8 KV, one configuration, fed
    the same calls."""

    def __init__(self, model, sliding_reclaim=True, **ecfg):
        _kind, jcfg, jp, cfg, tp = model
        kv = dict(page_size=PS, num_pages=48, max_pages_per_seq=12,
                  kv_dtype="fp8", sliding_reclaim=sliding_reclaim)
        with pytest.warns(RuntimeWarning, match="v5e"):   # JAX's TPU note
            self.je = JaxEngine(jcfg, jp, JaxEngineConfig(
                max_batch_size=4, kv=JaxKVConfig(**kv), **ecfg),
                decode_burst=4)
        with warnings.catch_warnings():
            warnings.simplefilter("error")       # no TPU speed warning
            self.te = Engine(cfg, tp, EngineConfig(
                max_batch_size=4, kv=KVCacheConfig(**kv), **ecfg),
                decode_burst=4, device="cpu")
        assert self.te.cache.k.dtype == E4 and self.te.cache.k_scale is None
        self.pending = []

    def add(self, prompts, new):
        for p in prompts:
            self.pending.append((
                self.je.add_request(prompt_ids=list(p), sampling=JaxSampling(
                    max_new_tokens=new)),
                self.te.add_request(prompt_ids=list(p),
                                    sampling=SamplingParams(
                                        max_new_tokens=new))))

    def step(self):
        self.je.step()
        self.te.step()

    def run(self):
        self.je.run()
        self.te.run()

    def check(self):
        for a, b in self.pending:
            assert b.output_ids == a.output_ids, a.prompt_ids
            assert b.state.value == a.state.value == "finished"
            assert b.cached_len == a.cached_len
        for name in METRICS:
            assert getattr(self.te.metrics, name) == getattr(
                self.je.metrics, name), name
        assert_codes_close(self.te.cache, self.je.cache)


@pytest.mark.parametrize("ecfg", [
    dict(prefix_cache_entries=0),                 # bench.py --kv-dtype fp8
    dict(prefill_chunk=16),       # the server's --kv-dtype fp8 (prefix cache)
    dict(prefix_cache_entries=0, spec_tokens=2),  # prompt-lookup speculation
], ids=["no-prefix-cache", "prefix-cache-and-chunks", "spec"])
def test_engines_fp8kv_match(model, ecfg):
    rng = np.random.default_rng(7)
    system = rng.integers(1, 250, 24).tolist()
    pattern = rng.integers(1, 250, 6).tolist()
    waves = [[system + rng.integers(1, 250, n).tolist() for n in ns]
             for ns in ((5,), (9, 3, 12), (4, 7))]
    waves[1][1] = waves[1][1] + pattern * 3       # prompt lookup finds drafts
    pair = Pair(model, **ecfg)
    # one request, then a wave sharing its prompt pages while it runs,
    # then (after all finish) a wave hitting the persistent store
    pair.add(waves[0], 6)
    pair.step()
    pair.add(waves[1], 5)
    pair.run()
    pair.add(waves[2], 7)
    pair.run()
    pair.check()
    m = pair.te.metrics
    assert (m.prefix_cache_persistent_hits > 0) == (
        ecfg.get("prefix_cache_entries") != 0)
    assert (m.spec_steps > 0) == ("spec_tokens" in ecfg)


def test_engine_fp8kv_with_sliding_window_raises(model):
    """FP8 KV with a sliding window once raised; it now runs and matches
    JAX's Engine, grouped (e4m3 ring pools; with INT8 weights the fused
    qkv writes them with a kv_layer, 6ek) and over the ordinary pools
    (``sliding_reclaim=False``): greedy tokens and metrics equal, codes of
    both pool sets at most one step apart."""
    import dataclasses
    kind, jcfg, jp, cfg, tp = model
    wmodel = (kind, dataclasses.replace(jcfg, sliding_window=8), jp,
              dataclasses.replace(cfg, sliding_window=8), tp)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 250, n).tolist() for n in (21, 9, 30)]
    for reclaim in (True, False):
        pair = Pair(wmodel, sliding_reclaim=reclaim, prefix_cache_entries=0)
        assert pair.te._grouped == reclaim
        pair.add(prompts, 12)
        pair.run()
        pair.check()
        if reclaim:
            assert pair.te.cache.k_w.dtype == E4
            assert_codes_close(
                type("Ring", (), dict(k=pair.te.cache.k_w,
                                      v=pair.te.cache.v_w)),
                type("Ring", (), dict(k=pair.je.cache.k_w,
                                      v=pair.je.cache.v_w)))
