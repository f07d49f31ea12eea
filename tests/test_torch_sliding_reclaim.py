"""Sliding-window KV reclamation (grouped ring pools) through the port's
Engine, against the JAX package's grouped Engine on the CPU.

Every scenario of tests/test_sliding_reclaim.py: one JAX parameter draw of
the tiny sliding-window model (f32, window 6 unless stated), carried to
the port with ``params_from_jax``, served by both Engines with the same
EngineConfig. The JAX Engine runs its CPU path (the dense reference over
``gather_dense`` of the ring tables), the port its plain versions.
Stated tolerances: greedy tokens identical, ring geometry identical, and
f32 pools (ring and main) within 1e-5 page for page (the k/v rows come
from sums in another order, as in tests/test_torch_engine.py).
"""

import jax
import numpy as np
import pytest
import torch

from simplellminference_tpu.core.config import EngineConfig as JaxEngineConfig
from simplellminference_tpu.core.config import KVCacheConfig as JaxKVConfig
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

ALTERNATING = ("sliding_attention", "full_attention")
POOL_TOL = 1e-5


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


def _cfgs(**ov):
    kw = dict(vocab_size=256, hidden_size=64, intermediate_size=96,
              num_layers=4, num_heads=4, num_kv_heads=2, head_dim=16,
              max_seq_len=1024, dtype="float32", sliding_window=6)
    kw.update(ov)
    return JaxModelConfig.tiny_test(**kw), ModelConfig.tiny_test(**kw)


def _params(jcfg, seed):
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _engines(jcfg, tcfg, jp, tp, *, page_size=8, num_pages=96,
             max_pages_per_seq=32, reclaim=True, kv_dtype="f32", spec=0,
             chunk=0, max_batch=4, burst=4):
    kw = dict(max_batch_size=max_batch, spec_tokens=spec,
              prefill_chunk=chunk)
    kv = dict(page_size=page_size, num_pages=num_pages,
              max_pages_per_seq=max_pages_per_seq, kv_dtype=kv_dtype,
              sliding_reclaim=reclaim)
    je = JaxEngine(jcfg, jp, JaxEngineConfig(kv=JaxKVConfig(**kv), **kw),
                   decode_burst=burst)
    te = Engine(tcfg, tp, EngineConfig(kv=KVCacheConfig(**kv), **kw),
                decode_burst=burst, device="cpu")
    assert te._grouped == je._grouped and te._ring == je._ring
    assert te._window == je._window
    for name in ("k", "v", "k_scale", "v_scale", "k_w", "v_w", "k_w_scale",
                 "v_w_scale"):
        j, t = getattr(je.cache, name), getattr(te.cache, name)
        assert (j is None) == (t is None), name
        if t is not None:
            assert tuple(t.shape) == j.shape, name
    return je, te


def _serve(je, te, prompts, new):
    want = je.generate(prompts, JaxSampling(max_new_tokens=new))
    got = te.generate(prompts, SamplingParams(max_new_tokens=new))
    assert got == want
    return got


def _pools_close(je, te, live_slots: int):
    """Pools page for page but the pages dead burst rows write: the trash
    page, and the ring pages of the slots past ``live_slots`` (the
    requests fill slots 0.. and finish together). A dead row attends its
    full layers over -1 tables, where the port reads zeros and the JAX
    reference gather the trash page (ROADMAP §3), so its k/v differ."""
    for name in ("k", "v", "k_w", "v_w"):
        j, t = getattr(je.cache, name), getattr(te.cache, name)
        if t is None or t.numel() == 0:
            continue
        n = live_slots * te._ring if name.endswith("_w") else -1
        np.testing.assert_allclose(t.numpy()[:, :n], np.asarray(j)[:, :n],
                                   rtol=0, atol=POOL_TOL, err_msg=name)


def test_all_sliding_engine_grouped_matches_jax():
    """Mistral's shape (every layer sliding): the whole cache is the ring
    pool, R = (6 + 1 - 2) // 8 + 2 = 2 pages per slot, no full group."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, 0)
    je, te = _engines(jcfg, tcfg, jp, tp)
    assert te._grouped and te._window == 6 and te._ring == 2
    assert tuple(te.cache.k_w.shape[:2]) == (4, 4 * 2 + 1)
    assert te.cache.k.shape[0] == 0
    _serve(je, te, [list(range(1, 20)), [9, 8, 7], list(range(40, 71))], 24)
    _pools_close(je, te, 3)


def test_alternating_stack_grouped_matches_jax():
    """Alternating sliding/full layers: sliding layers on the ring pools at
    group-local indices, full ones on the allocator's pools."""
    jcfg, tcfg = _cfgs(layer_types=ALTERNATING * 2)
    jp, tp = _params(jcfg, 1)
    je, te = _engines(jcfg, tcfg, jp, tp)
    assert te._grouped
    assert te.cache.k_w.shape[0] == 2 and te.cache.k.shape[0] == 2
    _serve(je, te, [list(range(1, 26)), [5, 6, 7, 8], list(range(60, 75))],
           20)
    _pools_close(je, te, 3)


def test_long_decode_ring_wraps_many_times():
    """Decode far past R * page = 24 tokens (window 16): every ring page
    is overwritten several times; tokens equal JAX's and the ring pool
    keeps its B * R + 1 pages."""
    jcfg, tcfg = _cfgs(num_layers=2, layer_types=ALTERNATING,
                       sliding_window=16)
    jp, tp = _params(jcfg, 2)
    je, te = _engines(jcfg, tcfg, jp, tp, num_pages=128,
                      max_pages_per_seq=64, max_batch=2, burst=8)
    assert te._ring == 3
    assert te.cache.k_w.shape[1] == 2 * 3 + 1
    _serve(je, te, [list(range(1, 30))], 160)
    _pools_close(je, te, 1)


def test_grouped_int8_kv_matches_jax_and_ungrouped():
    """INT8-KV ring pools (with their scale pools): tokens equal the JAX
    grouped engine's and the port's own ungrouped INT8 engine's."""
    jcfg, tcfg = _cfgs(layer_types=ALTERNATING * 2)
    jp, tp = _params(jcfg, 3)
    prompts = [list(range(1, 22)), list(range(30, 45))]
    je, te = _engines(jcfg, tcfg, jp, tp, kv_dtype="int8")
    assert te._grouped and te.cache.k_w_scale is not None
    got = _serve(je, te, prompts, 16)
    _, flat = _engines(jcfg, tcfg, jp, tp, kv_dtype="int8", reclaim=False)
    assert not flat._grouped
    assert flat.generate(prompts, SamplingParams(max_new_tokens=16)) == got


def test_grouped_speculative_matches_jax():
    """Verify spans (G + 1 ring writes a step) across both groups: tokens
    and speculative metrics equal JAX's."""
    jcfg, tcfg = _cfgs(layer_types=ALTERNATING * 2)
    jp, tp = _params(jcfg, 4)
    je, te = _engines(jcfg, tcfg, jp, tp, spec=3)
    assert te._grouped and te._ring == je._ring >= 2
    _serve(je, te, [[1, 2, 3, 4] * 5, [7, 8, 9] * 6], 18)
    assert te.metrics.spec_steps > 0
    for name in ("spec_steps", "spec_accepted"):
        assert getattr(te.metrics, name) == getattr(je.metrics, name), name


def test_grouped_chunked_prefill_matches_jax():
    """Chunks read back through the unmasked ring: R covers window + the
    JAX sizing's max(chunk, 128) rows."""
    jcfg, tcfg = _cfgs(layer_types=ALTERNATING * 2)
    jp, tp = _params(jcfg, 5)
    je, te = _engines(jcfg, tcfg, jp, tp, chunk=16)
    assert te._grouped and te._ring == -(-(6 + 128 - 1) // 8) + 1
    prompts = [np.random.default_rng(0).integers(1, 250, 70).tolist(),
               list(range(2, 12))]
    _serve(je, te, prompts, 12)
    _pools_close(je, te, 2)


def test_reclaim_off_keeps_allocator_pools():
    """sliding_reclaim=False: the window over the ordinary pools."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, 6)
    je, te = _engines(jcfg, tcfg, jp, tp, reclaim=False)
    assert not te._grouped and te.cache.k_w is None
    assert te.cache.k.shape[0] == tcfg.num_layers
    _serve(je, te, [list(range(1, 20)), [9, 8, 7]], 10)
    _pools_close(je, te, 2)


def test_grouped_disables_prefix_cache_and_adopt():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, 7)
    je, te = _engines(jcfg, tcfg, jp, tp)
    shared = [1, 2, 3, 4, 5, 6, 7, 8] * 2
    _serve(je, te, [shared, shared], 8)
    m = te.metrics.summary()
    assert m["prefix_cache_hits"] == 0 and m["prompt_tokens_cached"] == 0
    with pytest.raises(RuntimeError, match="sliding_reclaim"):
        te.adopt_prefill([1, 2, 3], 4, lambda c, t: c)


def test_full_model_unaffected_by_reclaim_flag():
    """No sliding layers: the grouped machinery never engages."""
    jcfg, tcfg = JaxModelConfig.tiny_test(), ModelConfig.tiny_test()
    jp, tp = _params(jcfg, 8)
    je, te = _engines(jcfg, tcfg, jp, tp)
    assert not te._grouped and te.cache.k_w is None
    with pytest.raises(NotImplementedError, match="adopt_prefill"):
        te.adopt_prefill([1, 2, 3], 4, lambda c, t: c)
    _serve(je, te, [[3, 1, 4, 1, 5], [9, 2, 6]], 6)


def test_dense_forward_still_refuses_windows():
    """No longer: the Generator attends through flash_decode's window form
    (13w), greedy tokens equal to JAX's Generator and to the grouped
    Engine's, prompts and generation past the window."""
    from simplellminference_tpu.runtime.generator import (
        Generator as JaxGenerator)
    from simplellminference_tpu_torch.runtime.generator import Generator

    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, 9)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3], [9, 2, 6]]
    want = JaxGenerator(jcfg, jp, max_batch=2, max_seq=64).generate(
        prompts, JaxSampling(max_new_tokens=12)).token_ids
    gen = Generator(tcfg, tp, max_batch=2, max_seq=64, device="cpu")
    assert gen.generate(prompts, SamplingParams(
        max_new_tokens=12)).token_ids == want
    je, te = _engines(jcfg, tcfg, jp, tp)
    assert _serve(je, te, prompts, 12) == want
