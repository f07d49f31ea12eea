"""The port's dense Generator (and the generate CLI) against the JAX
package's on the CPU.

One JAX parameter draw of ``ModelConfig.tiny_test()`` (2 layers, GQA),
float32 and INT8 (per output channel, INT8 LM head), carried to the port
with ``params_from_jax``. Greedy tokens are exact: ``generate`` at mixed
prompt lengths, with stop tokens and with penalties equals JAX's
``Generator.generate``; ``generate_fused`` equals ``generate`` (the loop
vs fused invariant of the JAX package's recipe). Sampled rows draw other
random bits than JAX's, so they are held to their distribution: a
chi-square test of 4000 first tokens against the shaped probabilities of
the JAX package's logits.
"""

import io
from contextlib import redirect_stderr, redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.core.config import QuantConfig as JaxQuantConfig
from simplellminference_tpu.core.config import SamplingParams as JaxSampling
from simplellminference_tpu.models import llama as jllama
from simplellminference_tpu.ops import sampling as jsamp
from simplellminference_tpu.runtime.generator import Generator as JaxGenerator
from simplellminference_tpu.runtime.weights import (
    quantize_params as jquantize_params)
from simplellminference_tpu_torch.cli import generate as cli_generate
from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                      KVCacheConfig,
                                                      ModelConfig,
                                                      SamplingParams)
from simplellminference_tpu_torch.engine import Engine
from simplellminference_tpu_torch.models.convert import params_from_jax
from simplellminference_tpu_torch.runtime.generator import Generator

PROMPTS = [[5, 9, 2, 44, 17, 3, 8, 120, 7, 7, 1], [33, 4, 250],
           [60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75,
            76, 77, 78], [1]]


def _models(kind):
    jcfg = JaxModelConfig.tiny_test()
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    if kind == "int8":
        jp = jquantize_params(jp, JaxQuantConfig(mode="int8", group_size=0,
                                                 quantize_lm_head=True))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, ModelConfig.tiny_test(), tp


@pytest.fixture(scope="module", params=["float", "int8"])
def models(request):
    return _models(request.param)


@pytest.fixture(scope="module")
def float_models():
    return _models("float")


def _pair(jcfg, jp, cfg, tp, max_seq=128):
    return (JaxGenerator(jcfg, jp, max_batch=4, max_seq=max_seq),
            Generator(cfg, tp, max_batch=4, max_seq=max_seq, device="cpu"))


def test_greedy_generate_matches_jax(models):
    jg, tg = _pair(*models)
    want = jg.generate(PROMPTS, JaxSampling(max_new_tokens=12))
    got = tg.generate(PROMPTS, SamplingParams(max_new_tokens=12))
    assert got.token_ids == want.token_ids
    assert got.prompt_lens == want.prompt_lens and got.steps == want.steps
    # the fused loop is the same greedy computation
    fused = tg.generate_fused(PROMPTS, 12)
    assert fused.dtype == torch.int32 and fused.tolist() == got.token_ids


def test_stop_tokens_match_jax(float_models):
    jg, tg = _pair(*float_models)
    free = jg.generate(PROMPTS, JaxSampling(max_new_tokens=10)).token_ids
    stops = (free[0][3], free[2][6])
    want = jg.generate(PROMPTS, JaxSampling(max_new_tokens=10,
                                            stop_token_ids=stops))
    got = tg.generate(PROMPTS, SamplingParams(max_new_tokens=10,
                                              stop_token_ids=stops))
    assert got.token_ids == want.token_ids and got.steps == want.steps
    assert got.token_ids[0][-1] == stops[0]


def test_penalties_match_jax_and_the_engine(float_models):
    """tests/test_ops.py:192 for the port: the Generator's penalty math is
    the JAX Generator's and the port Engine's."""
    jcfg, jp, cfg, tp = float_models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, 9).tolist(),
               rng.integers(1, cfg.vocab_size, 15).tolist()]
    kw = dict(max_new_tokens=10, repetition_penalty=1.7,
              presence_penalty=0.3, frequency_penalty=0.2)
    jg, tg = _pair(jcfg, jp, cfg, tp)
    got = tg.generate(prompts, SamplingParams(**kw)).token_ids
    assert got == jg.generate(prompts, JaxSampling(**kw)).token_ids
    eng = Engine(cfg, tp, EngineConfig(
        max_batch_size=2, kv=KVCacheConfig(page_size=8, num_pages=64,
                                           max_pages_per_seq=16,
                                           kv_dtype="f32")), device="cpu")
    assert eng.generate(prompts, SamplingParams(**kw)) == got


def test_sampled_first_tokens_follow_the_shaped_distribution(float_models):
    jcfg, jp, cfg, tp = float_models
    n, temp, top_k = 4000, 0.8, 8
    prompt = PROMPTS[0]
    tg = Generator(cfg, tp, max_batch=n, max_seq=64, device="cpu")
    got = tg.generate([prompt] * n, SamplingParams(
        max_new_tokens=1, temperature=temp, top_k=top_k, seed=5)).token_ids
    toks = np.asarray([t[0] for t in got])
    logits, _ = jllama.forward(jcfg, jp, jnp.asarray([prompt]),
                               jnp.arange(len(prompt))[None])
    lg = logits[:, -1]
    probs = np.asarray([float(jsamp.shaped_token_prob(
        lg, jnp.asarray([t]), jnp.asarray([temp]), jnp.asarray([top_k]),
        jnp.ones(1), jnp.zeros(1))[0]) for t in range(cfg.vocab_size)])
    support = probs > 0
    assert support.sum() == top_k and set(toks) <= set(np.flatnonzero(
        support))
    obs = np.bincount(toks, minlength=cfg.vocab_size)[support]
    want = probs[support] / probs[support].sum() * n
    _stat, p_value = scipy.stats.chisquare(obs, want)
    assert p_value > 1e-3, (obs, want)


def test_capacity_errors(float_models):
    _jcfg, _jp, cfg, tp = float_models
    tg = Generator(cfg, tp, max_batch=2, max_seq=32, device="cpu")
    with pytest.raises(ValueError, match="exceeds the KV arena"):
        tg.generate([[1] * 20], SamplingParams(max_new_tokens=13))
    with pytest.raises(ValueError, match="exceeds the KV arena"):
        tg.generate_fused([[1] * 20], 13)
    assert len(tg.generate([[1] * 20], SamplingParams(
        max_new_tokens=12)).token_ids[0]) == 12


def test_generator_defaults_to_cuda(float_models):
    _jcfg, _jp, cfg, tp = float_models
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="params live on cpu"):
            Generator(cfg, tp)
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Generator(cfg, tp)


@pytest.mark.parametrize("quant", ["none", "int8", "int4", "int8-act"])
def test_generate_cli_no_model_path_prints_text(quant):
    out, err = io.StringIO(), io.StringIO()
    flags = (["--quant", "int8", "--act-quant"] if quant == "int8-act"
             else ["--quant", quant])
    with redirect_stdout(out), redirect_stderr(err):
        cli_generate.main(["--cpu", "--dtype", "float32", *flags,
                           "--prompt", "Hello", "--max-new-tokens", "6"])
    text = out.getvalue()
    assert text.startswith("Hello") and text.endswith("\n")
    assert "random TinyLlama" in err.getvalue()
    assert "tokens in" in err.getvalue()


@pytest.mark.parametrize("argv", [["--model-dir", "a_checkpoint_dir"],
                                  ["--blob", "a_blob"],
                                  ["--tokenizer", "a_tokenizer_dir"]])
def test_generate_cli_refuses_unported_options(argv):
    with redirect_stderr(io.StringIO()), pytest.raises(SystemExit) as e:
        cli_generate.main(["--cpu", *argv])
    assert e.value.code == 2
