"""Draft-model speculative decoding (``Engine(draft=...)``) in the port,
against the JAX package on the CPU: the counterparts of
tests/test_draft_spec.py.

The target is one JAX draw of ``ModelConfig.tiny_test()``; the draft a
smaller model in the same token space (1 layer, 64 wide), both carried to
the port with ``params_from_jax``. Greedy outputs are token-exact: equal to
the JAX draft Engine's (with the same speculative metrics) and to the
port's Engine without speculation, whatever the draft proposes; a
self-draft accepts every window; slot reuse re-prefills the draft arena;
stochastic rows keep emitting through the rejection-sampling acceptance.
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
from simplellminference_tpu_torch.models import llama as tllama
from simplellminference_tpu_torch.models.convert import params_from_jax

DRAFT = dict(num_layers=1, hidden_size=64, intermediate_size=128,
             num_heads=2, num_kv_heads=1)
KV = dict(page_size=8, num_pages=64, max_pages_per_seq=24, kv_dtype="f32")


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


@pytest.fixture(scope="module")
def models():
    jcfg = JaxModelConfig.tiny_test()
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    jdcfg = JaxModelConfig.tiny_test(**DRAFT)
    jdp = jllama.init_params(jdcfg, jax.random.PRNGKey(42))
    tp, tdp = (params_from_jax(jax.tree.map(np.asarray, p), device="cpu")
               for p in (jp, jdp))
    return ((jcfg, jp), (jdcfg, jdp), (ModelConfig.tiny_test(), tp),
            (ModelConfig.tiny_test(**DRAFT), tdp))


def mk_engine(target, spec=0, draft=None, burst=3, max_batch=4):
    cfg, params = target
    return Engine(cfg, params, EngineConfig(
        max_batch_size=max_batch, spec_tokens=spec, kv=KVCacheConfig(**KV)),
        decode_burst=burst, device="cpu", draft=draft)


def test_draft_params_carry_every_leaf_forward_reads(models):
    (_jcfg, _jp), (_jdcfg, jdp), _target, (dcfg, tdp) = models
    fresh = tllama.init_params(dcfg, device="cpu")
    assert set(tdp) == set(fresh) == set(jdp)
    assert set(tdp["layers"]) == set(fresh["layers"]) == set(jdp["layers"])
    for k, v in tdp["layers"].items():
        assert v.shape == fresh["layers"][k].shape
        np.testing.assert_array_equal(v.numpy(), np.asarray(jdp["layers"][k]))


def test_draft_spec_greedy_matches_jax_and_the_plain_engine(models):
    jtarget, jdraft, target, draft = models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, n).tolist() for n in (20, 13, 5)]
    je = JaxEngine(*jtarget, JaxEngineConfig(
        max_batch_size=4, spec_tokens=3, kv=JaxKVConfig(**KV)),
        decode_burst=3, draft=jdraft)
    want = je.generate(prompts, JaxSampling(max_new_tokens=24))
    eng = mk_engine(target, spec=3, draft=draft)
    got = eng.generate(prompts, SamplingParams(max_new_tokens=24))
    assert got == want
    assert (eng.metrics.spec_steps, eng.metrics.spec_accepted) == (
        je.metrics.spec_steps, je.metrics.spec_accepted)
    assert eng.metrics.spec_steps > 0
    assert got == mk_engine(target).generate(
        prompts, SamplingParams(max_new_tokens=24))


def test_self_draft_accepts_everything(models):
    _j, _jd, target, _draft = models
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 256, 9).tolist()]
    base = mk_engine(target).generate(prompts,
                                      SamplingParams(max_new_tokens=20))
    eng = mk_engine(target, spec=3, draft=target)
    assert eng.generate(prompts, SamplingParams(max_new_tokens=20)) == base
    m = eng.metrics
    assert m.spec_accepted >= m.spec_steps * 2, (m.spec_accepted,
                                                 m.spec_steps)


def test_draft_spec_slot_reuse_two_waves(models):
    _j, _jd, target, draft = models
    rng = np.random.default_rng(11)
    wave1 = [rng.integers(1, 256, n).tolist() for n in (8, 15)]
    wave2 = [rng.integers(1, 256, n).tolist() for n in (12, 6)]
    sp = SamplingParams(max_new_tokens=12)
    eng = mk_engine(target, spec=2, draft=draft, max_batch=2)
    got1 = eng.generate(wave1, sp)
    got2 = eng.generate(wave2, sp)
    assert got1 == mk_engine(target, max_batch=2).generate(wave1, sp)
    assert got2 == mk_engine(target, max_batch=2).generate(wave2, sp)


def test_draft_spec_stochastic_and_stops(models):
    _j, _jd, target, draft = models
    prompts = [[5, 6, 7, 8] * 5, [1, 2, 3]]
    base = mk_engine(target).generate([prompts[0]],
                                      SamplingParams(max_new_tokens=16))
    stop = base[0][7]
    eng = mk_engine(target, spec=3, draft=draft)
    r1 = eng.add_request(prompt_ids=prompts[0], sampling=SamplingParams(
        max_new_tokens=16, stop_token_ids=(stop,)))
    r2 = eng.add_request(prompt_ids=prompts[1], sampling=SamplingParams(
        max_new_tokens=10, temperature=0.9, top_k=20))
    eng.run()
    assert r1.output_ids == base[0][:base[0].index(stop)]
    assert len(r2.output_ids) == 10


def test_draft_spec_mixed_lengths_batch(models):
    _j, _jd, target, draft = models
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, n).tolist() for n in (4, 19, 11, 7)]
    news = (5, 17, 1, 9)
    outs = []
    for eng in (mk_engine(target, spec=3, draft=draft), mk_engine(target)):
        reqs = [eng.add_request(prompt_ids=p, sampling=SamplingParams(
            max_new_tokens=n)) for p, n in zip(prompts, news)]
        eng.run()
        outs.append([r.output_ids for r in reqs])
    assert outs[0] == outs[1]
    assert [len(o) for o in outs[0]] == list(news)


def test_draft_requires_spec_tokens(models):
    _j, _jd, target, draft = models
    with pytest.raises(ValueError, match="spec_tokens"):
        mk_engine(target, spec=0, draft=draft)


def test_draft_vocab_mismatch_rejected(models):
    _j, _jd, target, _draft = models
    dcfg = ModelConfig.tiny_test(vocab_size=128)
    with pytest.raises(ValueError, match="token space"):
        mk_engine(target, spec=2,
                  draft=(dcfg, tllama.init_params(dcfg, device="cpu")))
