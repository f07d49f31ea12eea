"""GPT-OSS through the port's dense forward and the Generator against the
JAX package on the CPU.

The model is tests/test_torch_gpt_oss.py's tiny GPT-OSS (4 layers, 4
heads over 2 kv heads at D 32, sliding and full layers alternating at
window 8, attention sinks, q/k/v/o biases, yarn rotary, 4 experts of 64
with top 2 and their biases; one JAX draw carried by ``params_from_jax``).
Prompts of up to 21 tokens and the steps run past the window, so the
prefill attends through 3s and 3ws (the grouped MoE), and the decode
through 13s on the full layers and 13ws on the sliding ones (the folded
MoE), the K/V written by ``kv_append``. Stated tolerances, f32: the dense
forward's logits within 1e-4 over the prefill and 6 decode steps, its
arena within 1e-5; the Generator's greedy tokens (``generate`` and
``generate_fused``) exact against JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_gpt_oss as oss
from simplellminference_tpu.core.config import SamplingParams as JaxSampling
from simplellminference_tpu.models import llama as jllama
from simplellminference_tpu.runtime.generator import (
    Generator as JaxGenerator)
from simplellminference_tpu.runtime.kv_cache import DenseKVCache as JaxDense
from simplellminference_tpu_torch.core.config import SamplingParams
from simplellminference_tpu_torch.models import llama as tllama
from simplellminference_tpu_torch.runtime.generator import Generator
from simplellminference_tpu_torch.runtime.kv_cache import DenseKVCache

LOGIT_TOL = 1e-4
ARENA_TOL = 1e-5
PROMPTS = [[5, 6, 7, 8] * 5, list(range(30, 51)), [9, 8, 7, 9, 8, 7],
           [101, 4]]


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


@pytest.fixture(scope="module", params=["f32", "int8"])
def model(request):
    return oss._drawn(request.param)


def test_prompts_pass_the_window():
    _jcfg, _jp, cfg, _tp = oss._drawn("f32")
    wins = cfg.layer_windows
    assert None in wins and oss.WINDOW in wins and cfg.attn_sinks
    assert max(len(p) for p in PROMPTS) > oss.WINDOW


def _trace(model, steps):
    """Greedy prefill + ``steps`` decode steps through both packages'
    dense forward; yields (jax logits, port logits, jax cache, port
    cache) after each call."""
    jcfg, jp, cfg, tp = model
    b, bucket, smax = len(PROMPTS), 32, 64
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
    for jl, tl, jc, tc in _trace(model, steps=6):
        np.testing.assert_allclose(tl, jl, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1),
                                      jl[:, -1].argmax(-1))
    for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=ARENA_TOL,
                                   atol=ARENA_TOL)


def test_generator_matches_jax(model):
    jcfg, jp, cfg, tp = model
    jg = JaxGenerator(jcfg, jp, max_batch=4, max_seq=64)
    tg = Generator(cfg, tp, max_batch=4, max_seq=64, device="cpu")
    want = jg.generate(PROMPTS, JaxSampling(max_new_tokens=12))
    got = tg.generate(PROMPTS, SamplingParams(max_new_tokens=12))
    assert got.token_ids == want.token_ids
    assert got.prompt_lens == want.prompt_lens and got.steps == want.steps
    fused = tg.generate_fused(PROMPTS, 12)
    assert fused.tolist() == got.token_ids
    assert np.asarray(jg.generate_fused(PROMPTS, 12)).tolist() == (
        got.token_ids)
    assert len({tok for o in got.token_ids for tok in o}) > 2
