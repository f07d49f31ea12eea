"""The port's Engine under multi-head latent attention (DeepSeek's MLA)
against the JAX package's Engine on the CPU, in both cache modes: absorbed
(one shared latent pool, ``cache.v`` None) and naive (per-head K/V padded
to the pools' lane dim).

The tiny DeepSeek-V2 of tests/test_model_families.py:313-326 (H 128, 4
heads, kv_lora_rank 64, rope 16: the absorbed lane is 128), built from a
plain dict, with JAX's weights carried over by ``params_from_jax``. Two
scenarios, page size 8, f32 pools, 8 new tokens: the prompts [[1, 2, 3,
4, 5], [9, 8, 7]] (whole-prompt prefill, decode bursts), and a chunked
run with a prefix-cache hit (a 16-token system prompt: the first wave's
prompt runs the chunk loop, the second wave's two prompts hit the cached
pages and prefill their suffixes through the page tables). Held: greedy
tokens equal to JAX's, absorbed equal to naive (as JAX's
``test_deepseek_absorbed_shared_pool_matches_naive`` asks of its own
engine), and the pools after the run within 1e-5 of JAX's page for page
(but the trash page), ``cache.v is None`` for absorbed. The JAX runs are
made once a module.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from simplellminference_tpu.core.config import EngineConfig as JaxEngineConfig
from simplellminference_tpu.core.config import KVCacheConfig as JaxKV
from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.core.config import SamplingParams as JaxSampling
from simplellminference_tpu.engine import Engine as JaxEngine
from simplellminference_tpu.models import llama as jllama
from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                      KVCacheConfig,
                                                      ModelConfig,
                                                      SamplingParams)
from simplellminference_tpu_torch.engine import Engine
from simplellminference_tpu_torch.models.convert import params_from_jax

from test_torch_mla import TINY_HF

TOL = 1e-5
SYSTEM = list(range(20, 36))          # a 16-token system prompt
SCENARIOS = {
    # name: (waves of prompts, prefill_chunk)
    "plain": ([[[1, 2, 3, 4, 5], [9, 8, 7]]], 0),
    "chunked-prefix": ([[SYSTEM + [1, 2, 3, 4, 5]],
                        [SYSTEM + [7, 7, 2], SYSTEM + [40, 41, 42, 43]]], 8),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread (tests/test_torch_fp8kv_dense.py
    says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kv(cls):
    return cls(page_size=8, num_pages=64, max_pages_per_seq=16,
               kv_dtype="f32")


@functools.lru_cache(maxsize=None)
def _jax_weights(absorbed: bool):
    cfg = JaxModelConfig.from_hf_dict(TINY_HF, dtype="float32",
                                      mla_absorbed=absorbed)
    return cfg, jllama.init_params(cfg, jax.random.PRNGKey(11))


@functools.lru_cache(maxsize=None)
def _jax_run(absorbed: bool, scenario: str):
    """JAX's tokens (every wave's, in order) and its pools after the run
    (numpy; v None for the shared pool)."""
    waves, chunk = SCENARIOS[scenario]
    cfg, params = _jax_weights(absorbed)
    eng = JaxEngine(cfg, params, JaxEngineConfig(
        max_batch_size=4, prefill_chunk=chunk, kv=_kv(JaxKV)),
        decode_burst=3)
    assert (eng.cache.v is None) == absorbed
    toks = sum((eng.generate(w, JaxSampling(max_new_tokens=8))
                for w in waves), [])
    m = eng.metrics
    hits = (m.prefix_cache_hits, m.prefix_cache_persistent_hits)
    v = None if eng.cache.v is None else np.asarray(eng.cache.v)
    return toks, np.asarray(eng.cache.k), v, hits


def _port_run(absorbed: bool, scenario: str):
    waves, chunk = SCENARIOS[scenario]
    jcfg, jparams = _jax_weights(absorbed)
    cfg = ModelConfig.from_hf_dict(TINY_HF, dtype="float32",
                                   mla_absorbed=absorbed)
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             device="cpu")
    eng = Engine(cfg, params, EngineConfig(
        max_batch_size=4, prefill_chunk=chunk, kv=_kv(KVCacheConfig)),
        decode_burst=3, device="cpu")
    toks = sum((eng.generate(w, SamplingParams(max_new_tokens=8))
                for w in waves), [])
    m = eng.metrics
    return toks, eng, (m.prefix_cache_hits, m.prefix_cache_persistent_hits)


def _pools_close(got: torch.Tensor, want: np.ndarray):
    np.testing.assert_allclose(got.numpy()[:, :-1], want[:, :-1], rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("absorbed", [True, False],
                         ids=["absorbed", "naive"])
def test_engine_matches_jax(absorbed, scenario):
    want, jk, jv, jhits = _jax_run(absorbed, scenario)
    got, eng, hits = _port_run(absorbed, scenario)
    assert got == want
    assert hits == jhits
    if scenario == "chunked-prefix":
        assert hits[0] > 0              # the second wave hit the cache
    assert (eng.cache.v is None) == absorbed
    if absorbed:
        assert jv is None
        assert eng.cache.k.shape[2:] == (1, 8, 128)   # one latent head
    else:
        _pools_close(eng.cache.v, jv)
    _pools_close(eng.cache.k, jk)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_absorbed_matches_naive(scenario):
    """The shared latent pool serves the same greedy tokens as the naive
    per-head pools, and holds one 128-lane row a token where naive holds 4
    heads of K and V at 64 lanes."""
    a_toks, a_eng, _ = _port_run(True, scenario)
    n_toks, n_eng, _ = _port_run(False, scenario)
    assert a_toks == n_toks
    per_token = {name: sum(x[0, 0, :, 0].numel() for x in (e.cache.k,
                                                            e.cache.v)
                           if x is not None)
                 for name, e in (("absorbed", a_eng), ("naive", n_eng))}
    assert per_token == {"absorbed": 128, "naive": 2 * 4 * 64}
