"""The port's mixture-of-experts FFN (``ops/moe.py``) against the JAX
package's (``simplellminference_tpu/ops/moe.py``) on the CPU.

One JAX parameter draw (``init_params`` of a GPT-OSS-shaped tiny config:
4 experts of width 64, top 2, router and expert biases, the clamped
SwiGLU; and of a Mixtral-shaped one: plain softmax routing, SwiGLU, no
biases) goes to the port through ``params_from_jax``; the same numpy
activations (float32, seeded) go through both. Stated tolerances: the
router's expert ids exact (ties in ``jax.lax.top_k``'s order, the lower
index first) and its probabilities within 1e-6; the FFN outputs within
1e-5 of their largest magnitude, folded (decode) and grouped (prefill),
f32 and INT8 experts (codes from both ``quantize_params`` byte-equal),
with activations scaled so that the SwiGLU clamps at +-7 bite; the
routes the port does not serve raise NotImplementedError naming them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.core.config import QuantConfig as JaxQuantConfig
from simplellminference_tpu.models import llama as jllama
from simplellminference_tpu.ops import moe as jmoe
from simplellminference_tpu.ops import ref_ops as jref
from simplellminference_tpu.runtime.weights import (
    quantize_params as jquantize_params)
from simplellminference_tpu_torch.core.config import ModelConfig, QuantConfig
from simplellminference_tpu_torch.models.convert import params_from_jax
from simplellminference_tpu_torch.ops import moe as tmoe
from simplellminference_tpu_torch.ops import ref_ops as tref
from simplellminference_tpu_torch.runtime.weights import quantize_params

TOL = 1e-5


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


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


GPT_OSS = dict(hidden_size=96, intermediate_size=64, num_layers=2,
               num_heads=4, num_kv_heads=2, head_dim=32, num_experts=4,
               num_experts_per_tok=2, moe_intermediate_size=64,
               hidden_act="swiglu_oss", moe_bias=True, norm_topk_prob=True)
MIXTRAL = dict(hidden_size=96, intermediate_size=64, num_layers=2,
               num_heads=4, num_kv_heads=2, head_dim=32, num_experts=4,
               num_experts_per_tok=2)


def _configs(kw):
    return (JaxModelConfig.tiny_test(dtype="float32", **kw),
            ModelConfig.tiny_test(dtype="float32", **kw))


def _layers(jcfg, quant=None):
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(5))
    if quant is not None:
        jp = jquantize_params(jp, JaxQuantConfig(mode="int8",
                                                 group_size=quant))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp["layers"], tp["layers"]


def _close_rel(got, want):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(g).all()
    assert np.abs(g - w).max() <= TOL * np.abs(w).max(), np.abs(g - w).max()


@pytest.mark.parametrize("bias", [False, True])
def test_router_matches_jax(bias):
    rng = np.random.default_rng(1)
    x, w = rand(rng, 40, 96), rand(rng, 96, 8) * 0.3
    b = rand(rng, 8) if bias else None
    kw = {} if b is None else {"bias": t(b)}
    jkw = {} if b is None else {"bias": jnp.asarray(b)}
    for k, norm in ((2, True), (3, False), (8, True)):
        tv, ti = tmoe.router_topk(t(x), t(w), k, norm, **kw)
        jv, ji = jmoe.router_topk(jnp.asarray(x), jnp.asarray(w), k, norm,
                                  **jkw)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                                   atol=1e-6)
        tp = tmoe.router_probs(t(x), t(w), k, norm, **kw)
        jp = jmoe.router_probs(jnp.asarray(x), jnp.asarray(w), k, norm,
                               **jkw)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=1e-6)
    assert tp.dtype == torch.float32


def test_router_ties_keep_jax_order():
    """Experts with equal router logits (duplicate router columns, and
    logits all zero) are chosen lower index first, as ``jax.lax.top_k``
    chooses them; the probabilities tie too."""
    rng = np.random.default_rng(2)
    x = rand(rng, 16, 32)
    w = rand(rng, 32, 8)
    w[:, 5] = w[:, 2]
    w[:, 7] = w[:, 2]
    w[:, 4] = w[:, 1]
    x[:3] = 0.0                       # every logit 0: experts 0, 1, 2
    for k in (1, 2, 3, 4):
        ti = tmoe.router_topk(t(x), t(w), k)[1].numpy()
        ji = np.asarray(jmoe.router_topk(jnp.asarray(x), jnp.asarray(w),
                                         k)[1])
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ti[:3], np.arange(k)[None].repeat(3, 0))
    # a tie with a bias that breaks it the other way
    b = np.zeros(8, np.float32)
    b[5] = 1e-3
    ti = tmoe.router_topk(t(x), t(w), 4, bias=t(b))[1].numpy()
    ji = np.asarray(jmoe.router_topk(jnp.asarray(x), jnp.asarray(w), 4,
                                     bias=jnp.asarray(b))[1])
    np.testing.assert_array_equal(ti, ji)


def test_swiglu_oss_clamps_as_jax():
    """The clamped SwiGLU at its edges: gate clamped above at 7, up to
    [-7, 7], exactly as the JAX package's."""
    edges = np.asarray([-9.0, -7.0001, -7.0, -6.9999, -1.0, 0.0, 1.0,
                        6.9999, 7.0, 7.0001, 9.0], np.float32)
    g, u = np.meshgrid(edges, edges)
    got = tref.glu_act(t(g), t(u), "swiglu_oss")
    want = jref.glu_act(jnp.asarray(g), jnp.asarray(u), "swiglu_oss")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # past a clamp the output stops moving: the gate above 7, up beyond
    # +-7; the gate has no floor (1e-6: PyTorch's vector and scalar
    # sigmoids part in the last bits)
    for a, b in ((got[:, -1], got[:, -3]), (got[0], got[2]),
                 (got[-1], got[-3])):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-6)
    assert not torch.allclose(got[:, 0], got[:, 1], rtol=1e-6, atol=1e-6)
    bf = tref.glu_act(t(g).bfloat16(), t(u).bfloat16(), "swiglu_oss")
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("quant", [None, 0, 32], ids=["f32", "int8",
                                                      "int8-g32"])
@pytest.mark.parametrize("family", ["gpt_oss", "mixtral"])
@pytest.mark.parametrize("s", [1, 7])
def test_moe_ffn_matches_jax(family, quant, s):
    """S = 1 takes the folded route (decode), S = 7 the grouped one
    (prefill); activations x 6 so that the clamps at +-7 bite."""
    jcfg, cfg = _configs(GPT_OSS if family == "gpt_oss" else MIXTRAL)
    jlw, tlw = _layers(jcfg, quant)
    rng = np.random.default_rng(3 + s)
    x = rand(rng, 3, s, 96) * 6.0
    for li in (0, 1):
        got = tmoe.moe_ffn(cfg, tlw, li, t(x))
        want = jmoe.moe_ffn(jcfg, jlw, jnp.int32(li), jnp.asarray(x))
        _close_rel(got, want)
    if family == "gpt_oss":
        # the clamps bite: some expert's gate or up passes 7
        wgu = tlw["w_gate_up"]
        wgu = wgu.dequantize() if hasattr(wgu, "q") else wgu
        gu = t(x).reshape(-1, 96) @ wgu[1] + tlw["w_gate_up_bias"][1]
        assert float(gu.abs().max()) > 7.0


def test_folded_and_grouped_routes_agree():
    """The two routes are the same function: the grouped route on one
    row a sequence gives the folded route's outputs."""
    jcfg, cfg = _configs(GPT_OSS)
    _jlw, tlw = _layers(jcfg)
    rng = np.random.default_rng(11)
    x = t(rand(rng, 5, 1, 96) * 3.0)
    _close_rel(tmoe.moe_ffn_grouped(cfg, tlw, 1, x),
               tmoe.moe_ffn(cfg, tlw, 1, x))


@pytest.mark.parametrize("experts", [4, 8], ids=["padded", "per-expert"])
def test_grouped_route_with_skewed_router_matches_jax(experts):
    """A router bias that sends every token to experts 2 and 0: two
    groups hold every row and the rest are empty. Over 4 experts padding
    each group to the largest doubles the rows (one batched product);
    over 8 it would quadruple them, past ``PAD_SLACK`` rows an expert, so
    each expert takes its own product. Both give the JAX package's
    outputs (and the folded route's)."""
    jcfg, cfg = _configs(dict(GPT_OSS, num_experts=experts))
    jlw, tlw = _layers(jcfg)
    bias = np.zeros((2, experts), np.float32)
    bias[:, 2], bias[:, 0] = 60.0, 40.0
    jlw = dict(jlw, router_bias=jnp.asarray(bias))
    tlw = dict(tlw, router_bias=t(bias))
    rng = np.random.default_rng(12)
    x = rand(rng, 2, 40, 96) * 3.0
    assert (experts * 80 > 2 * 80 * 2 + tmoe.PAD_SLACK * experts) == (
        experts == 8)
    ids = tmoe.router_topk(t(x).reshape(-1, 96), tlw["router"][1], 2,
                           bias=tlw["router_bias"][1])[1]
    assert torch.equal(ids, torch.tensor([[2, 0]]).expand(80, 2))
    got = tmoe.moe_ffn_grouped(cfg, tlw, 1, t(x))
    _close_rel(got, jmoe.moe_ffn(jcfg, jlw, jnp.int32(1), jnp.asarray(x)))
    _close_rel(got, tmoe.moe_ffn(cfg, tlw, 1, t(x).reshape(80, 1, 96))
               .reshape(2, 40, 96))


def test_int8_experts_quantize_as_jax():
    """INT8 folded experts through both ``quantize_params`` (per channel
    and group 32): codes and scales byte-equal, the router and biases
    left float."""
    jcfg, cfg = _configs(GPT_OSS)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(5))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for gs in (0, 32):
        jq = jquantize_params(jp, JaxQuantConfig(mode="int8", group_size=gs))
        tq = quantize_params(tp, QuantConfig(mode="int8", group_size=gs))
        for name in ("w_gate_up", "w_down"):
            np.testing.assert_array_equal(tq["layers"][name].q.numpy(),
                                          np.asarray(jq["layers"][name].q))
            np.testing.assert_array_equal(
                tq["layers"][name].scales.numpy(),
                np.asarray(jq["layers"][name].scales))
        for name in ("router", "router_bias", "w_gate_up_bias",
                     "w_down_bias"):
            assert torch.equal(tq["layers"][name], tp["layers"][name])


def test_unserved_routes_raise():
    _jcfg, cfg = _configs(MIXTRAL)
    _, tlw = _layers(_jcfg)
    x = torch.zeros((1, 1, 96))
    for kw, name in ((dict(router_score_fn="sigmoid"), "sigmoid"),
                     (dict(router_n_group=2, router_topk_group=1),
                      "grouped routing"),
                     (dict(shared_expert_intermediate_size=32),
                      "shared experts")):
        with pytest.raises(NotImplementedError, match=name):
            tmoe.moe_ffn(dataclasses.replace(cfg, **kw), tlw, 0, x)
    with pytest.raises(NotImplementedError, match="first_k_dense"):
        tmoe.check_supported(ModelConfig.tiny_test(
            num_layers=2, num_experts=4, first_k_dense=1))
    with pytest.raises(NotImplementedError, match="tp_axis"):
        tmoe.moe_ffn(cfg, tlw, 0, x, tp_axis="model")
    with pytest.raises(NotImplementedError, match="sigmoid"):
        tmoe.moe_ffn_grouped(dataclasses.replace(
            cfg, router_score_fn="sigmoid"), tlw, 0, torch.zeros((1, 2, 96)))
