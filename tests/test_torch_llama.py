"""The port's paged Llama forward against the JAX package's.

One JAX parameter draw on ``ModelConfig.tiny_test()`` (GQA: 4 heads over
2 kv heads) is carried to the port with ``params_from_jax``; both run a
right-padded batched prefill and three decode steps over their own paged
pools with the same tables. Stated tolerance: 1e-4 on the logits
(float32; XLA and PyTorch sum matmuls in different orders), and the same
on every pool page but the trash page.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.memory.paged_kv import PagedKVCache as JaxCache
from simplellminference_tpu.models import llama as jllama
from simplellminference_tpu.ops.linear import QuantizedWeight
from simplellminference_tpu_torch.core.config import ModelConfig
from simplellminference_tpu_torch.memory.paged_kv import PagedKVCache
from simplellminference_tpu_torch.models import llama as tllama
from simplellminference_tpu_torch.models.convert import params_from_jax

TOL = 1e-4
PS, MP = 8, 4


@pytest.fixture(scope="module")
def model():
    jcfg = JaxModelConfig.tiny_test()
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, ModelConfig.tiny_test(), tp


def test_params_from_jax_names_and_values(model):
    _jcfg, jp, _cfg, tp = model
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == sum(1 for _ in _leaves(tp))
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        t = tp
        for k in keys:
            t = t[k]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_init_params_layout_matches_jax(model):
    _jcfg, jp, cfg, _tp = model
    tp = tllama.init_params(cfg, seed=0, device="cpu")
    assert set(tp) == set(jp) and set(tp["layers"]) == set(jp["layers"])
    for k, v in jp["layers"].items():
        assert tuple(tp["layers"][k].shape) == v.shape, k
        assert tp["layers"][k].dtype == torch.float32
    assert tuple(tp["embed"].shape) == jp["embed"].shape
    # same scales: N(0,1) * K**-0.5
    std = float(tp["layers"]["wqkv"].std())
    assert abs(std - cfg.hidden_size ** -0.5) < 0.1 * cfg.hidden_size ** -0.5
    again = tllama.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["layers"]["w_down"], tp["layers"]["w_down"])


@pytest.mark.parametrize("override,feature", [
    # Gemma-2's soft caps and sandwich norms run since its slice, GeGLU
    # since Gemma's, and the mixture of experts, QKV biases, sinks and the
    # clamped SwiGLU since GPT-OSS's (test_ported_model_features_pass)
    (dict(num_experts=4, router_score_fn="sigmoid"), "sigmoid routing"),
    (dict(num_experts=4, shared_expert_intermediate_size=32),
     "shared experts"),
    (dict(qk_norm=True), "q/k RMSNorm"),
    (dict(hidden_act="relu2"), "activation"),
])
def test_unsupported_model_features_raise(override, feature):
    with pytest.raises(NotImplementedError, match=feature):
        tllama.check_supported(ModelConfig.tiny_test(**override))


@pytest.mark.parametrize("override", [
    dict(num_experts=4), dict(attention_bias=True), dict(attn_sinks=True),
    dict(hidden_act="swiglu_oss"), dict(o_bias=True),
], ids=["mixture-of-experts", "QKV bias", "sinks", "swiglu_oss", "o bias"])
def test_ported_model_features_pass(override):
    """The features GPT-OSS's slice ported: check_supported admits them
    and init_params draws their leaves with the JAX package's shapes."""
    cfg = ModelConfig.tiny_test(**override)
    tllama.check_supported(cfg)
    jcfg = JaxModelConfig.tiny_test(**override)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tllama.init_params(cfg, seed=0, device="cpu")
    assert set(tp["layers"]) == set(jp["layers"])
    for k, v in jp["layers"].items():
        assert tuple(tp["layers"][k].shape) == v.shape, k


def test_quantized_params_rejected():
    # INT8 and INT4 leaves, zero points included, are carried over
    # (tests/test_torch_int8.py, tests/test_torch_int4.py); other widths
    # and zero points that do not fit their scales are not
    q3 = QuantizedWeight(q=np.zeros((4, 4), np.int8),
                         scales=np.ones((1, 4), np.float32), bits=3)
    with pytest.raises(NotImplementedError, match="INT4"):
        params_from_jax({"layers": {"wqkv": q3}}, device="cpu")
    qz = QuantizedWeight(q=np.zeros((4, 4), np.int8),
                         scales=np.ones((1, 4), np.float32), bits=4,
                         zs=np.zeros((2, 4), np.float32))
    with pytest.raises(ValueError, match="zs"):
        params_from_jax({"layers": {"wqkv": qz}}, device="cpu")


def test_init_params_defaults_to_cuda():
    cfg = ModelConfig.tiny_test(num_layers=1)
    if torch.cuda.is_available():
        assert tllama.init_params(cfg)["embed"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tllama.init_params(cfg)


def test_forward_paged_prefill_and_decode_match_jax(model):
    jcfg, jp, cfg, tp = model
    prompts = [[5, 9, 2, 44, 17, 3, 8, 120, 7, 7, 1], [33, 4, 250],
               [60, 61, 62, 63, 64, 65, 66, 67, 68]]
    b, bucket = len(prompts), 16
    toks = np.zeros((b, bucket), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.asarray([len(p) for p in prompts], np.int32)
    tables = np.asarray([[2, 9, 4, 11], [0, 5, -1, -1], [7, 1, 3, -1]],
                        np.int32)
    pos0 = np.arange(bucket, dtype=np.int32)[None]
    jc = JaxCache.create(cfg.num_layers, 12, cfg.num_kv_heads, PS,
                         cfg.head_dim, jnp.float32)
    tc = PagedKVCache.create(cfg.num_layers, 12, cfg.num_kv_heads, PS,
                             cfg.head_dim, torch.float32, device="cpu")

    jl, jc = jllama.forward_paged(jcfg, jp, jnp.asarray(toks),
                                  jnp.asarray(pos0), jc, jnp.asarray(tables),
                                  jnp.asarray(lens), prefill=True,
                                  last_token_only=True)
    tl, tc = tllama.forward_paged(cfg, tp, torch.from_numpy(toks),
                                  torch.from_numpy(pos0), tc,
                                  torch.from_numpy(tables),
                                  torch.from_numpy(lens), prefill=True,
                                  last_token_only=True)
    assert tl.shape == (b, 1, cfg.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
    pos = lens.copy()
    for _ in range(3):
        jl, jc = jllama.forward_paged(
            jcfg, jp, jnp.asarray(tok[:, None]), jnp.asarray(pos[:, None]),
            jc, jnp.asarray(tables), jnp.asarray(pos + 1), prefill=False)
        tl, tc = tllama.forward_paged(
            cfg, tp, torch.from_numpy(tok[:, None]),
            torch.from_numpy(pos[:, None]), tc, torch.from_numpy(tables),
            torch.from_numpy(pos + 1), prefill=False)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        t_tok = tl[:, 0].argmax(-1).numpy().astype(np.int32)
        tok = np.array(jnp.argmax(jl[:, 0], -1), np.int32)
        np.testing.assert_array_equal(t_tok, tok)
        pos = pos + 1
    for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(t.numpy()[:, :-1], np.asarray(j)[:, :-1],
                                   rtol=TOL, atol=TOL)
