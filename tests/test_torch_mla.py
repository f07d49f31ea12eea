"""Multi-head latent attention (DeepSeek's MLA) in the port against the JAX
package on the CPU: the interleaved rotary and MLA's rope tables, the QKV
block in both cache modes (``mla_qkv``, ``mla_qkv_absorbed``,
``mla_unabsorb``) with and without the low-rank query path, the MLA leaves
through ``params_from_jax``, the plain versions of the shared-KV forms
(1l, 2l, 3l, 4l, 8l) against JAX's Pallas kernels in interpret mode (the
writes against JAX's scatter route, which its CPU path takes), and every
refusal this slice adds, each by its name.

Inputs come from numpy with fixed seeds, in f32. Stated tolerances:
- ops and the QKV block: 1e-5 (f32 sums in another order);
- attention: within 1e-5 of the outputs' largest magnitude (at least 1)
  at D 128 and 640 (DeepSeek-V2-Lite's latent row), tiny pages, a few
  keys, an unmapped page;
- writes: byte-equal on every page but the trash page, and the pages no
  row goes to byte-equal to the pool before the call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.memory import paged_kv as jpkv
from simplellminference_tpu.models import llama as jllama
from simplellminference_tpu.models import mla as jmla
from simplellminference_tpu.ops import ref_ops as jref
from simplellminference_tpu.ops.attention.flash_prefill import (
    flash_prefill as jflash_prefill)
from simplellminference_tpu.ops.attention.paged_decode import (
    paged_flash_decode as jpaged_decode)
from simplellminference_tpu.ops.attention.paged_prefill import (
    paged_flash_prefill as jpaged_prefill)
from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                      KVCacheConfig,
                                                      ModelConfig,
                                                      QuantConfig)
from simplellminference_tpu_torch.engine import Engine
from simplellminference_tpu_torch.memory import paged_kv as tpkv
from simplellminference_tpu_torch.models import llama as tllama
from simplellminference_tpu_torch.models import mla as tmla
from simplellminference_tpu_torch.models.convert import params_from_jax
from simplellminference_tpu_torch.ops import paged_append as tpa
from simplellminference_tpu_torch.ops import ref_ops as tref
from simplellminference_tpu_torch.ops.attention import dispatch as tdispatch
from simplellminference_tpu_torch.ops.attention import flash_prefill as tfp
from simplellminference_tpu_torch.ops.attention import paged_decode as tpd
from simplellminference_tpu_torch.ops.attention import paged_prefill as tpp
from simplellminference_tpu_torch.runtime.generator import Generator
from simplellminference_tpu_torch.runtime.weights import quantize_params

TOL = 1e-5
# the tiny DeepSeek-V2 of tests/test_model_families.py:313-326, as a plain
# dict: H 128, 4 heads, kv_lora_rank 64, rope 16 (the absorbed lane 128)
TINY_HF = dict(
    model_type="deepseek_v2", vocab_size=256, hidden_size=128,
    intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=4, max_position_embeddings=256, rms_norm_eps=1e-6,
    rope_theta=10000.0, tie_word_embeddings=False, n_routed_experts=None,
    q_lora_rank=None, kv_lora_rank=64, qk_nope_head_dim=32,
    qk_rope_head_dim=16, v_head_dim=32, first_k_dense_replace=2,
    attention_bias=False)
YARN = {"type": "yarn", "factor": 40.0, "beta_fast": 32, "beta_slow": 1,
        "mscale": 0.707, "mscale_all_dim": 0.707,
        "original_max_position_embeddings": 4096}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread (tests/test_torch_fp8kv_dense.py
    says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def configs(hf, absorbed=True):
    return (JaxModelConfig.from_hf_dict(hf, dtype="float32",
                                        mla_absorbed=absorbed),
            ModelConfig.from_hf_dict(hf, dtype="float32",
                                     mla_absorbed=absorbed))


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def attn_close(got, want):
    want = np.asarray(want, np.float32)
    close(got, want, TOL * max(1.0, float(np.abs(want).max())))


def test_apply_rope_interleaved():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    ang = rng.uniform(-3, 3, (2, 3, 8)).astype(np.float32)
    sin, cos = np.sin(ang), np.cos(ang)
    got = tref.apply_rope_interleaved(t(x), t(sin), t(cos))
    want = jref.apply_rope_interleaved(jnp.asarray(x), jnp.asarray(sin),
                                       jnp.asarray(cos))
    close(got, want)
    # pairs (2i, 2i+1), not the half split
    assert not np.allclose(got.numpy(), tref.apply_rope(
        t(x), t(sin), t(cos)).numpy())


@pytest.mark.parametrize("scaling", [None, YARN], ids=["plain", "yarn"])
def test_mla_rope_tables(scaling):
    jcfg, tcfg = configs(dict(TINY_HF, rope_scaling=scaling))
    pos = np.array([[0, 1, 7, 200], [3, 4, 5, 4095]], np.int32)
    ts, tc = tref.rope_tables_for(tcfg, t(pos))
    js, jc = jref.rope_tables_for(jcfg, jnp.asarray(pos))
    assert ts.shape == (2, 4, TINY_HF["qk_rope_head_dim"] // 2)
    close(ts, js)
    close(tc, jc)


def _jax_params(jcfg, seed=11):
    return jax.tree.map(np.asarray,
                        jllama.init_params(jcfg, jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("q_lora", [None, 48], ids=["q_proj", "q_lora"])
def test_params_from_jax_mla(q_lora):
    jcfg, tcfg = configs(dict(TINY_HF, q_lora_rank=q_lora))
    jp = _jax_params(jcfg)
    tp = params_from_jax(jp, device="cpu")
    names = {"kv_a", "kv_a_norm", "kv_b", "wo"} | (
        {"q_a", "q_a_norm", "q_b"} if q_lora else {"q_proj"})
    assert names <= set(tp["layers"]) and "wqkv" not in tp["layers"]
    for name, w in jp["layers"].items():
        assert np.array_equal(tp["layers"][name].numpy(), w), name
    # the port's own draw has the JAX package's leaves and shapes
    own = tllama.init_params(tcfg, seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in own["layers"].items()} == {
        k: v.shape for k, v in jp["layers"].items()}


@pytest.mark.parametrize("q_lora", [None, 48], ids=["q_proj", "q_lora"])
@pytest.mark.parametrize("absorbed", [True, False],
                         ids=["absorbed", "naive"])
def test_mla_qkv_matches_jax(absorbed, q_lora):
    jcfg, tcfg = configs(dict(TINY_HF, q_lora_rank=q_lora), absorbed)
    jp = _jax_params(jcfg)
    tp = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, TINY_HF["hidden_size"])).astype(
        np.float32)
    pos = np.arange(10, dtype=np.int32).reshape(2, 5)
    js, jc = jref.rope_tables_for(jcfg, jnp.asarray(pos))
    ts, tc = tref.rope_tables_for(tcfg, t(pos))
    jlw = jax.tree.map(jnp.asarray, jp["layers"])
    li = 1
    if absorbed:
        jq, jk = jmla.mla_qkv_absorbed(jcfg, jlw, li, jnp.asarray(x), js, jc)
        tq, tk = tmla.mla_qkv_absorbed(tcfg, tp["layers"], li, t(x), ts, tc)
        assert tuple(tk.shape) == (2, 5, 1, tcfg.head_dim) == (2, 5, 1, 128)
        close(tq, jq)
        close(tk, jk)
        attn = rng.standard_normal((2, 5, 4, tcfg.head_dim)).astype(
            np.float32)
        close(tmla.mla_unabsorb(tcfg, tp["layers"], li, t(attn)),
              jmla.mla_unabsorb(jcfg, jlw, li, jnp.asarray(attn)))
    else:
        want = jmla.mla_qkv(jcfg, jlw, li, jnp.asarray(x), js, jc)
        got = tmla.mla_qkv(tcfg, tp["layers"], li, t(x), ts, tc)
        for g, w in zip(got, want):
            assert tuple(g.shape) == (2, 5, 4, tcfg.head_dim)
            close(g, w)


# --- the shared-KV forms' plain versions against JAX's kernels ----------

L, P, PS = 2, 12, 8
TABLES = np.array([[3, 7, 1, 4], [0, 11, -1, -1], [5, 2, 9, 10]], np.int32)


def _pool(rng, d):
    return rng.standard_normal((L, P + 1, 1, PS, d)).astype(np.float32)


@pytest.mark.parametrize("d", [128, 640])
def test_shared_decode_matches_jax(d):
    """4l's plain version (the port's wrapper on CPU tensors) against the
    JAX kernel with v_pool None, interpret mode."""
    rng = np.random.default_rng(d)
    pool = _pool(rng, d)
    q = rng.standard_normal((3, 4, d)).astype(np.float32)
    lens = np.array([29, 11, 1], np.int32)   # row 1 past an unmapped page
    want = jpaged_decode(jnp.asarray(q), jnp.asarray(pool), None,
                         jnp.asarray(TABLES), jnp.asarray(lens),
                         interpret=True, layer=jnp.int32(1), sm_scale=0.1)
    got = tpd.paged_flash_decode(t(q), t(pool), None, t(TABLES), t(lens), 1,
                                 sm_scale=0.1)
    attn_close(got, want)
    close(tpd.paged_flash_decode_shared(t(q), t(pool), t(TABLES), t(lens), 1,
                                        0.1), got, 0)


@pytest.mark.parametrize("d", [128, 640])
def test_shared_prefill_matches_jax(d):
    """8l's plain version against the JAX kernel with v_pool None, chunks
    at offsets 8, 0 and 16, interpret mode."""
    rng = np.random.default_rng(d + 1)
    pool = _pool(rng, d)
    q = rng.standard_normal((3, 16, 4, d)).astype(np.float32)
    offs = np.array([8, 0, 16], np.int32)
    lens = np.array([24, 11, 32], np.int32)
    want = jpaged_prefill(jnp.asarray(q), jnp.asarray(pool), None,
                          jnp.asarray(TABLES), jnp.asarray(lens),
                          jnp.asarray(offs), bq=16, interpret=True,
                          layer=jnp.int32(1), sm_scale=0.1)
    got = tpp.paged_flash_prefill(t(q), t(pool), None, t(TABLES), t(lens),
                                  t(offs), 1, sm_scale=0.1)
    rows = [r for r in range(3) for _ in range(1)]
    for b in rows:   # rows past kv_len are padding in both
        n_valid = int(lens[b] - offs[b])
        attn_close(got[b, :n_valid], want[b, :n_valid])


@pytest.mark.parametrize("d", [128, 640])
def test_shared_flash_prefill_matches_jax(d):
    """3l's plain version against the JAX kernel called with v = k, and
    dispatch.attention routing v is k to it."""
    rng = np.random.default_rng(d + 2)
    k = rng.standard_normal((2, 32, 1, d)).astype(np.float32)
    q = rng.standard_normal((2, 32, 4, d)).astype(np.float32)
    want = jflash_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                          bq=16, bk=16, interpret=True, sm_scale=0.1)
    got = tfp.flash_prefill_shared(t(q), t(k), sm_scale=0.1)
    attn_close(got, want)
    _, tcfg = configs(TINY_HF)
    kt = t(k)
    routed = tdispatch.attention(tcfg, t(q), kt, kt)
    attn_close(routed, tfp.flash_prefill_ref(t(q), kt, kt, tcfg.
                                             query_pre_attn_scalar ** -0.5))


@pytest.mark.parametrize("d", [128, 640])
def test_shared_writes_match_jax(d):
    """1l and 2l (the port's write_*_stacked over a shared pool) against
    JAX's scatter route with pool_v None: byte-equal, the pages no row
    goes to untouched."""
    rng = np.random.default_rng(d + 3)
    pool = _pool(rng, d)
    row = rng.standard_normal((3, 1, d)).astype(np.float32)
    pos = np.array([5, 9, 30], np.int32)
    jk, jv, _, _ = jpkv.write_decode_stacked(
        jnp.asarray(pool), None, jnp.asarray(row), None, jnp.asarray(TABLES),
        jnp.asarray(pos), jnp.int32(1))
    assert jv is None
    tk = t(pool)
    out = tpkv.write_decode_stacked(tk, None, t(row), None, t(TABLES),
                                    t(pos), 1)
    assert out[0] is tk and out[1] is None
    np.testing.assert_array_equal(tk.numpy()[:, :-1], np.asarray(jk)[:, :-1])
    hit = {3, 11, 10}
    keep = [p for p in range(P) if p not in hit]
    np.testing.assert_array_equal(tk.numpy()[:, keep], pool[:, keep])

    chunk = rng.standard_normal((3, 13, 1, d)).astype(np.float32)
    jk, jv, _, _ = jpkv.write_prefill_stacked(
        jnp.asarray(pool), None, jnp.asarray(chunk), None,
        jnp.asarray(TABLES), jnp.int32(0), page_offset=1)
    assert jv is None
    tk = t(pool)
    tpkv.write_prefill_stacked(tk, None, t(chunk), None, t(TABLES), 0,
                               page_offset=1)
    np.testing.assert_array_equal(tk.numpy()[:, :-1], np.asarray(jk)[:, :-1])
    hit = {7, 1, 11, 2, 9}
    keep = [p for p in range(P) if p not in hit]
    np.testing.assert_array_equal(tk.numpy()[:, keep], pool[:, keep])
    np.testing.assert_array_equal(tk.numpy()[1], pool[1])   # other layer


# --- the refusals this slice adds, each by its name ----------------------

def _engine(cfg, params, **kw):
    kv = kw.pop("kv_dtype", "f32")
    return Engine(cfg, params, EngineConfig(
        max_batch_size=2, kv=KVCacheConfig(page_size=8, num_pages=16,
                                           max_pages_per_seq=4, kv_dtype=kv),
        **kw), device="cpu")


def test_mla_refusals():
    jcfg, tcfg = configs(TINY_HF)
    tp = params_from_jax(_jax_params(jcfg), device="cpu")
    tok = torch.ones((1, 3), dtype=torch.int32)
    pos = torch.arange(3, dtype=torch.int32)[None]
    cache = tpkv.PagedKVCache.create(2, 4, 1, 8, 128, torch.float32,
                                     shared_kv=True, device="cpu")
    tables = torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(NotImplementedError, match="verify window under MLA"):
        tllama.forward_paged(tcfg, tp, tok, pos, cache, tables,
                             torch.tensor([3]), prefill=False)
    with pytest.raises(NotImplementedError, match="MLA on the dense arena"):
        tllama.forward(tcfg, tp, tok, pos, cache=object())
    with pytest.raises(NotImplementedError, match="Generator under MLA"):
        Generator(tcfg, tp, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="speculative decoding .* under MLA"):
        _engine(tcfg, tp, spec_tokens=2)
    with pytest.raises(NotImplementedError,
                       match="speculative decoding .* under MLA"):
        Engine(tcfg, tp, EngineConfig(spec_tokens=2), device="cpu",
               draft=(tcfg, tp))
    for kv in ("int8", "fp8"):
        with pytest.raises(NotImplementedError, match=f"{kv} KV under MLA"):
            _engine(tcfg, tp, kv_dtype=kv)
    with pytest.raises(NotImplementedError,
                       match="quantized weights under MLA"):
        _engine(tcfg, tp, quant=QuantConfig(mode="int8"))
    with pytest.raises(NotImplementedError, match="quantize_params on MLA"):
        quantize_params(tp, QuantConfig(mode="int8"))
    moe_hf = dict(TINY_HF, n_routed_experts=4, num_experts_per_tok=2,
                  moe_intermediate_size=32, first_k_dense_replace=0)
    with pytest.raises(NotImplementedError,
                       match="routed experts under MLA"):
        tllama.check_supported(ModelConfig.from_hf_dict(moe_hf))
    with pytest.raises(NotImplementedError, match="dense-prefix"):
        tllama.check_supported(ModelConfig.from_hf_dict(
            dict(moe_hf, first_k_dense_replace=1)))
    # the pools, writes and forms outside the slice
    with pytest.raises(NotImplementedError, match="shared-KV pools"):
        tpkv.PagedKVCache.create(2, 4, 1, 8, 128, torch.int8, shared_kv=True,
                                 device="cpu")
    with pytest.raises(NotImplementedError, match="span write over a "
                                                  "shared-KV pool"):
        tpkv.write_span_stacked(cache.k, None, torch.zeros(1, 2, 1, 128),
                                None, tables, torch.tensor([0]), 0)
    with pytest.raises(NotImplementedError, match="span write over a "
                                                  "shared-KV pool"):
        tpa.paged_append_span(cache.k, None, torch.zeros(1, 2, 1, 128), None,
                              tables, torch.tensor([0]), 0)
    q = torch.zeros(1, 2, 4, 128)
    with pytest.raises(NotImplementedError, match="verify form over a "
                                                  "shared-KV pool"):
        tpd.paged_flash_verify(q, cache.k, None, tables, torch.tensor([3]), 0)
    for opt in (dict(window=4), dict(logit_cap=30.0),
                dict(sinks=torch.zeros(4))):
        with pytest.raises(NotImplementedError, match="over a shared-KV"):
            tpd.paged_flash_decode(q[:, 0], cache.k, None, tables,
                                   torch.tensor([3]), 0, **opt)
        with pytest.raises(NotImplementedError, match="over a shared-KV"):
            tpp.paged_flash_prefill(q, cache.k, None, tables,
                                    torch.tensor([3]), torch.tensor([0]), 0,
                                    **opt)
    for d in (256, 512):
        wide = torch.zeros(1, 1, 1, 8, d)
        with pytest.raises(NotImplementedError, match=f"head_dim {d} over"):
            tpd.paged_flash_decode(torch.zeros(1, 4, d), wide, None, tables,
                                   torch.tensor([3]), 0)
        with pytest.raises(NotImplementedError, match=f"head_dim {d} over"):
            tpp.paged_flash_prefill(torch.zeros(1, 2, 4, d), wide, None,
                                    tables, torch.tensor([3]),
                                    torch.tensor([0]), 0)
        with pytest.raises(NotImplementedError, match=f"head_dim {d} over"):
            tfp.flash_prefill_shared(torch.zeros(1, 2, 4, d),
                                     torch.zeros(1, 2, 1, d))
