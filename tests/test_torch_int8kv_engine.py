"""INT8 KV through the port's ``forward_paged`` and Engine, against the JAX
package on the CPU.

One JAX parameter draw of ``ModelConfig.tiny_test()`` (2 layers, GQA),
float32 and INT8 (per output channel, INT8 LM head), carried to the port
with ``params_from_jax``; both packages' caches are INT8 (int8 pools with
per-token-per-head scale pools). The JAX package runs its CPU path
(quantizing scatter writes, gather + dequant + dense attention); the port
its plain versions, which with INT8 weights include the quantizing
``fused_qkv_append`` at decode. Stated tolerances: logits within 1e-4
(summation order) while both caches hold the same codes and within 1e-3
once a code is one apart (below), greedy tokens and prefix metrics
identical; on every
page but the trash page, scales within 1e-5 and the pools' dequantized
values (code x scale) within 1e-5 wherever the codes agree. The k/v rows
come from sums in another order (about 1e-6 apart, as the f32 pools of
tests/test_torch_engine.py), so a row value next to a rounding midpoint
may take the neighbouring code: codes are held at most 1 apart, in under
1e-3 of the entries.
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
TABLES = np.asarray([[3, 9, 4, 11, 0, 15, 7, 19],
                     [5, 1, 13, 2, 17, 6, 8, 10]], np.int32)
# a code one apart moves its dequantized value by one scale step
# (absmax / 127) and the logits downstream by up to about 1e-3 here
LOGIT_TOL_CODE_APART = 1e-3
METRICS = ("prefix_cache_hits", "prompt_tokens_cached",
           "prefix_cache_persistent_hits", "prefix_cache_evictions",
           "preemptions", "prefills", "prompt_tokens", "requests_finished",
           "tokens_generated")


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
                         cfg.head_dim, jnp.int8)
    tc = PagedKVCache.create(cfg.num_layers, PAGES, cfg.num_kv_heads, PS,
                             cfg.head_dim, torch.int8, device="cpu")
    assert tc.k_scale is not None and jc.k_scale is not None
    return jc, tc


def assert_dequantized_close(tc, jc):
    """Trash page excluded: scales within 1e-5, codes at most 1 apart and
    apart in under 1e-3 of the entries, code x scale within 1e-5 wherever
    the codes agree."""
    for tq, ts, jq, js in ((tc.k, tc.k_scale, jc.k, jc.k_scale),
                           (tc.v, tc.v_scale, jc.v, jc.v_scale)):
        tq, jq = tq.numpy()[:, :-1], np.asarray(jq)[:, :-1]
        ts, js = ts.numpy()[:, :-1], np.asarray(js)[:, :-1]
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-12)
        apart = tq != jq
        assert np.abs(tq.astype(int) - jq).max() <= 1
        assert apart.mean() < 1e-3, apart.mean()
        got = tq * ts[..., None]
        want = jq * js[..., None]
        np.testing.assert_allclose(got[~apart], want[~apart], rtol=1e-5,
                                   atol=1e-5)


def same_codes(tc, jc) -> bool:
    return all(np.array_equal(t.numpy()[:, :-1], np.asarray(j)[:, :-1])
               for t, j in ((tc.k, jc.k), (tc.v, jc.v)))


def both(jcfg, jp, jc, cfg, tp, tc, toks, pos, lens, **kw):
    """One forward_paged call of each package on the same inputs: logits
    within 1e-4 while both caches hold the same codes, within
    LOGIT_TOL_CODE_APART once a code is one apart; the same greedy
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


def test_forward_paged_int8kv_prefill_and_decode_match_jax(model,
                                                           monkeypatch):
    kind, jcfg, jp, cfg, tp = model
    fused = []
    orig = qkv_fused.fused_qkv_append

    def spy(*a, **kw):
        fused.append(kw.get("cache_ks") is not None)
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
    assert_dequantized_close(tc, jc)
    # INT8 weights: the quantizing fused qkv at every decode step's layers
    assert fused == ([True] * 3 * cfg.num_layers if kind == "int8" else [])


def test_forward_paged_int8kv_chunked_matches_jax(model):
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
    assert_dequantized_close(tc, jc)


class Pair:
    """A JAX Engine and a port Engine over INT8 KV, one configuration,
    fed the same calls."""

    def __init__(self, model, **ecfg):
        _kind, jcfg, jp, cfg, tp = model
        kv = dict(page_size=PS, num_pages=48, max_pages_per_seq=12,
                  kv_dtype="int8")
        self.je = JaxEngine(jcfg, jp, JaxEngineConfig(
            max_batch_size=4, kv=JaxKVConfig(**kv), **ecfg), decode_burst=4)
        self.te = Engine(cfg, tp, EngineConfig(
            max_batch_size=4, kv=KVCacheConfig(**kv), **ecfg),
            decode_burst=4, device="cpu")
        assert self.te.cache.k.dtype == torch.int8
        self.pending = []

    def add(self, prompts, new):
        for p in prompts:
            self.pending.append((
                self.je.add_request(prompt_ids=list(p), sampling=JaxSampling(
                    max_new_tokens=new)),
                self.te.add_request(prompt_ids=list(p), sampling=SamplingParams(
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
        assert_dequantized_close(self.te.cache, self.je.cache)


@pytest.mark.parametrize("ecfg", [
    dict(prefix_cache_entries=0),
    dict(prefill_chunk=16),       # the default prefix cache (16 entries)
], ids=["no-prefix-cache", "prefix-cache-and-chunks"])
def test_engines_int8kv_match(model, ecfg):
    rng = np.random.default_rng(7)
    system = rng.integers(1, 250, 24).tolist()
    waves = [[system + rng.integers(1, 250, n).tolist() for n in ns]
             for ns in ((5,), (9, 3, 12), (4, 7))]
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
    # running-request sharing either way; the persistent store only with
    # the default prefix cache
    m = pair.te.metrics
    assert m.prefix_cache_hits >= 4
    assert (m.prefix_cache_persistent_hits > 0) == (
        ecfg.get("prefix_cache_entries") != 0)
