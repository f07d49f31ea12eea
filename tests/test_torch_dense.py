"""The dense path's kernels and forward against the JAX package on the CPU.

The port's ``kv_append``, ``flash_decode`` and dense-arena
``fused_qkv_append`` (their plain versions here) get the same numpy inputs
as the JAX functions, whose Pallas kernels run in interpret mode. Stated
tolerances:
- ``kv_append``: byte-equal to JAX's kernel and to ``kv_append_ref``
  wherever the JAX kernel's rules hold (S = 1 at any offset, S > 1 at
  offset 0); a row past Smax is dropped where the JAX reference clamps.
- ``flash_decode``: 1e-5 in float32 (sums in another order).
- dense ``fused_qkv_append``: bf16 activations, q and the written rows
  within 2e-2 of their standard deviation, every other arena entry equal
  (tests/test_torch_fused.py says why).
- ``forward``: logits within 1e-4 and the f32 arena within 1e-5 after a
  prefill and 4 decode steps, float and INT8 weights; in bf16 with the
  JAX fused kernels in interpret mode, 2e-2 of the logits' deviation.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.core.config import QuantConfig as JaxQuantConfig
from simplellminference_tpu.models import llama as jllama
from simplellminference_tpu.ops import kv_append as jkva
from simplellminference_tpu.ops import qkv_fused as jqkv
from simplellminference_tpu.ops import ref_ops as jref
from simplellminference_tpu.ops.attention import dispatch as jdispatch
from simplellminference_tpu.ops.attention.flash_decode import (
    flash_decode as jflash_decode)
from simplellminference_tpu.runtime.kv_cache import DenseKVCache as JaxDense
from simplellminference_tpu.runtime.kv_cache import (
    update_layer as jupdate_layer)
from simplellminference_tpu.runtime.weights import (
    quantize_params as jquantize_params)
from simplellminference_tpu_torch.core.config import ModelConfig
from simplellminference_tpu_torch.models import llama as tllama
from simplellminference_tpu_torch.models.convert import params_from_jax
from simplellminference_tpu_torch.ops import kv_append as tkva
from simplellminference_tpu_torch.ops import qkv_fused as tqkv
from simplellminference_tpu_torch.ops.attention import dispatch
from simplellminference_tpu_torch.ops.attention.flash_decode import (
    flash_decode, flash_decode_ref)
from simplellminference_tpu_torch.runtime.kv_cache import (DenseKVCache,
                                                           update_layer)

REL = 2e-2


def _interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas calls in interpret mode (kv_append has
    no ``interpret`` argument of its own)."""
    orig = jkva.pl.pallas_call
    monkeypatch.setattr(jkva.pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _arena(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(a).to(dtype)
    return t, jnp.asarray(t.float().numpy()).astype(
        jnp.float32 if dtype == torch.float32 else jnp.bfloat16)


# ------------------------------------------------------------- kv_append

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s,offs", [(1, [0, 7, 13, 63]), (8, [0, 0, 0, 0]),
                                    (128, [0, 0, 0, 0])],
                         ids=["decode-mixed-offsets", "s8", "s128"])
def test_kv_append_byte_equal_to_jax(monkeypatch, dtype, s, offs):
    _interpret_pallas(monkeypatch)
    rng = np.random.default_rng(s)
    smax = 64 if s < 128 else 256
    shape = (2, 4, 2, smax, 32)
    tk, jk = _arena(rng, shape, dtype)
    tv, jv = _arena(rng, shape, dtype)
    nk = rng.standard_normal((4, s, 2, 32)).astype(np.float32)
    nv = rng.standard_normal((4, s, 2, 32)).astype(np.float32)
    off = np.asarray(offs, np.int32)
    tkva.kv_append(tk, tv, torch.from_numpy(nk), torch.from_numpy(nv), 1,
                   torch.from_numpy(off))
    args = (jnp.asarray(nk), jnp.asarray(nv), jnp.int32(1), jnp.asarray(off))
    for fn in (jkva.kv_append, jkva.kv_append_ref):
        wk, wv = fn(jk, jv, *args)
        for t, w in ((tk, wk), (tv, wv)):
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(w, np.float32))


def test_kv_append_drops_rows_past_smax():
    """A difference by design: rows whose slot is at or past Smax are
    dropped; JAX's reference clamps the block start instead (its kernel
    never sees such offsets)."""
    rng = np.random.default_rng(3)
    shape = (1, 2, 2, 16, 8)
    base = rng.standard_normal(shape).astype(np.float32)
    nk = rng.standard_normal((2, 4, 2, 8)).astype(np.float32)
    off = np.asarray([14, 16], np.int32)       # rows 14, 15 kept; the rest
    tk, tv = torch.from_numpy(base.copy()), torch.from_numpy(base.copy())
    tkva.kv_append(tk, tv, torch.from_numpy(nk), torch.from_numpy(nk), 0,
                   torch.from_numpy(off))
    want = base.copy()
    want[0, 0, :, 14:16] = nk[0, :2].transpose(1, 0, 2)
    np.testing.assert_array_equal(tk.numpy(), want)
    jk, _ = jkva.kv_append_ref(jnp.asarray(base), jnp.asarray(base),
                               jnp.asarray(nk), jnp.asarray(nk), 0,
                               jnp.asarray(off))
    # JAX clamps: row 0's block lands at slots 12..15, row 1's at 12..15
    np.testing.assert_array_equal(np.asarray(jk)[0, 1, :, 12:16],
                                  nk[1].transpose(1, 0, 2))
    assert not np.array_equal(np.asarray(jk), want)


def test_update_layer_writes_one_layer_in_place():
    rng = np.random.default_rng(4)
    ck = torch.from_numpy(rng.standard_normal((3, 2, 32, 8))
                          .astype(np.float32))
    cv = ck.clone()
    nk = rng.standard_normal((3, 2, 2, 8)).astype(np.float32)
    off = np.asarray([0, 5, 30], np.int32)
    want_k, _ = jupdate_layer(jnp.asarray(ck.numpy()),
                              jnp.asarray(cv.numpy()), jnp.asarray(nk),
                              jnp.asarray(nk), jnp.asarray(off))
    k, v = update_layer(ck, cv, torch.from_numpy(nk), torch.from_numpy(nk),
                        torch.from_numpy(off))
    assert k is ck and v is cv
    np.testing.assert_array_equal(ck.numpy(), np.asarray(want_k))


# ----------------------------------------------------------- flash_decode

@pytest.mark.parametrize("n,kvn,d,smax,lens", [
    (4, 4, 128, 256, [1, 256, 100]),          # MHA, kv_len 1 and Smax
    (8, 2, 64, 256, [1, 256, 0]),             # GQA, a row with no keys
    (4, 1, 64, 1152, [1000, 1152, 129]),      # the 1152-slot arena
], ids=["mha-d128", "gqa-d64", "arena1152"])
def test_flash_decode_matches_jax_kernel(n, kvn, d, smax, lens):
    rng = np.random.default_rng(d + smax)
    b, li = len(lens), 1
    q = rng.standard_normal((b, n, d)).astype(np.float32)
    ck = rng.standard_normal((2, b + 1, kvn, smax, d)).astype(np.float32)
    cv = rng.standard_normal((2, b + 1, kvn, smax, d)).astype(np.float32)
    kv = np.asarray(lens, np.int32)
    want = np.asarray(jflash_decode(
        jnp.asarray(q), jnp.asarray(ck[:, :b]), jnp.asarray(cv[:, :b]),
        jnp.asarray(kv), interpret=True, layer=jnp.int32(li)))
    # the port's arena may have more rows than the batch (the draft's B+1)
    got = flash_decode(torch.from_numpy(q), torch.from_numpy(ck),
                       torch.from_numpy(cv), torch.from_numpy(kv), layer=li)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for i, ln in enumerate(lens):
        if ln == 0:
            assert not got[i].any()


def test_flash_decode_takes_4d_caches_and_refuses_unported_options():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 4, 32)).astype(np.float32))
    ck = torch.from_numpy(rng.standard_normal((2, 2, 64, 32))
                          .astype(np.float32))
    lens = torch.tensor([3, 64])
    # the window (13w), the soft cap (13c) and GPT-OSS's attention sinks
    # (13s, 13ws: tests/test_torch_sinks.py) take 4-D caches as well;
    # sinks at head_dim 256, which no model with sinks has, are refused
    sinks = torch.from_numpy(rng.standard_normal(4).astype(np.float32))
    for kw in ({}, dict(window=8), dict(logit_cap=30.0),
               dict(window=8, logit_cap=30.0), dict(sinks=sinks),
               dict(window=8, sinks=sinks)):
        np.testing.assert_array_equal(
            flash_decode(q, ck, ck, lens, **kw).numpy(),
            flash_decode_ref(q, ck[None], ck[None], lens, layer=0,
                             **kw).numpy())
    q256 = torch.zeros((2, 4, 256))
    c256 = torch.zeros((2, 2, 64, 256))
    with pytest.raises(NotImplementedError, match="sinks at head_dim 256"):
        flash_decode(q256, c256, c256, lens, sinks=torch.zeros(4))


# ------------------------------------------- dense fused_qkv_append (6d)

@pytest.mark.parametrize("n,kvn,pool_dtype,rows", [
    (4, 2, "f32", 3), (4, 4, "bf16", 4)], ids=["gqa-f32", "mha-bf16-b<rows"])
def test_fused_qkv_append_dense_matches_jax_kernel(n, kvn, pool_dtype, rows):
    rng = np.random.default_rng(n * kvn)
    L, h, d, smax, b, li = 2, 128, 32, 64, 3, 1
    nq = (n + 2 * kvn) * d
    wq = rng.integers(-127, 128, (L, h, nq)).astype(np.int8)
    ws = (rng.uniform(0.5, 2.0, (L, 1, nq)) * 1e-2).astype(np.float32)
    nw = (rng.standard_normal((L, h)) * 0.1 + 1.0).astype(np.float32)
    xt = torch.from_numpy(rng.standard_normal((b, h)).astype(np.float32)
                          ).bfloat16()
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    pos = np.asarray([5, 20, 40], np.int32)
    sin_j, cos_j = jref.rope_tables(jnp.asarray(pos), d, 10000.0)
    tdt = torch.float32 if pool_dtype == "f32" else torch.bfloat16
    tk, jk = _arena(rng, (L, rows, kvn, smax, d), tdt)
    tv, jv = _arena(rng, (L, rows, kvn, smax, d), tdt)
    before_k = tk.clone()
    q_j, jk, jv = jqkv.fused_qkv_append(
        xj, jnp.asarray(nw), jnp.asarray(wq), jnp.asarray(ws), sin_j, cos_j,
        jk, jv, jnp.int32(li), jnp.asarray(pos), n_heads=n, kv_heads=kvn,
        eps=1e-5, interpret=True)
    q_t, tk, tv = tqkv.fused_qkv_append(
        xt, torch.from_numpy(nw), torch.from_numpy(wq), torch.from_numpy(ws),
        torch.from_numpy(np.array(sin_j)), torch.from_numpy(np.array(cos_j)),
        tk, tv, li, torch.from_numpy(pos), n_heads=n, kv_heads=kvn, eps=1e-5)
    assert q_t.shape == (b, n, d) and q_t.dtype == torch.bfloat16
    want_q = np.asarray(q_j, np.float32)
    np.testing.assert_allclose(q_t.float().numpy(), want_q, rtol=0,
                               atol=REL * float(np.std(want_q)))
    written = np.zeros((L, rows, kvn, smax, d), bool)
    for r in range(b):
        written[li, r, :, pos[r]] = True
    for t, j in ((tk, jk), (tv, jv)):
        got, want = t.float().numpy(), np.asarray(j, np.float32)
        np.testing.assert_array_equal(got[~written], want[~written])
        np.testing.assert_allclose(got[written], want[written], rtol=0,
                                   atol=REL * float(np.std(want[written])))
    np.testing.assert_array_equal(tk.float().numpy()[~written],
                                  before_k.float().numpy()[~written])


def test_fused_qkv_append_dense_drops_slots_past_smax():
    rng = np.random.default_rng(6)
    L, h, n, kvn, d, smax = 1, 64, 2, 1, 16, 16
    nq = (n + 2 * kvn) * d
    wq = torch.from_numpy(rng.integers(-127, 128, (L, h, nq)).astype(np.int8))
    ws = torch.full((L, 1, nq), 1e-2)
    x = torch.from_numpy(rng.standard_normal((2, h)).astype(np.float32))
    ck = torch.zeros((L, 2, kvn, smax, d))
    cv = torch.zeros((L, 2, kvn, smax, d))
    pos = torch.tensor([15, 16], dtype=torch.int32)
    sin, cos = torch.zeros(2, d // 2), torch.ones(2, d // 2)
    tqkv.fused_qkv_append(x, torch.ones(L, h), wq, ws, sin, cos, ck, cv, 0,
                          pos)
    assert ck[0, 0, :, 15].any() and not ck[0, 1].any()


# --------------------------------------------------------------- forward

def _models(kind, dtype="float32"):
    jcfg = JaxModelConfig.tiny_test(dtype=dtype)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    if kind == "int8":
        jp = jquantize_params(jp, JaxQuantConfig(mode="int8", group_size=0,
                                                 quantize_lm_head=True))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu",
                         dtype=dtype)
    return jcfg, jp, ModelConfig.tiny_test(dtype=dtype), tp


PROMPTS = [[5, 9, 2, 44, 17, 3, 8, 120, 7, 7, 1], [33, 4, 250],
           [60, 61, 62, 63, 64, 65, 66, 67, 68]]


def _trace(jcfg, jp, cfg, tp, steps, dtype=torch.float32):
    """Greedy prefill + ``steps`` decode steps through both packages'
    dense forward; yields (jax logits, port logits, jax cache, port
    cache) after each call."""
    b, bucket, smax = len(PROMPTS), 16, 64
    toks = np.zeros((b, bucket), np.int32)
    for i, p in enumerate(PROMPTS):
        toks[i, :len(p)] = p
    lens = np.asarray([len(p) for p in PROMPTS], np.int32)
    pos0 = np.broadcast_to(np.arange(bucket, dtype=np.int32), (b, bucket))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jc = JaxDense.create(cfg.num_layers, b, smax, cfg.num_kv_heads,
                         cfg.head_dim, jdt)
    tc = DenseKVCache.create(cfg.num_layers, b, smax, cfg.num_kv_heads,
                             cfg.head_dim, dtype, device="cpu")
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


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_forward_prefill_and_decode_match_jax(kind, monkeypatch):
    jcfg, jp, cfg, tp = _models(kind)
    fused = []
    orig = tqkv.fused_qkv_append
    monkeypatch.setattr(tqkv, "fused_qkv_append",
                        lambda *a, **k: fused.append(k.get("tables"))
                        or orig(*a, **k))
    for jl, tl, jc, tc in _trace(jcfg, jp, cfg, tp, steps=4):
        assert tl.dtype == np.float32
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1),
                                      jl[:, -1].argmax(-1))
    for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    # INT8 per-channel wqkv: the dense fused qkv at each decode step
    assert fused == ([None] * 4 * cfg.num_layers if kind == "int8" else [])


def test_forward_int8_bf16_matches_jax_fused_kernels(monkeypatch):
    jcfg, jp, cfg, tp = _models("int8", "bfloat16")
    monkeypatch.setattr(jllama, "FORCE_FUSED_INTERPRET", True)
    for jl, tl, _jc, _tc in _trace(jcfg, jp, cfg, tp, steps=2,
                                   dtype=torch.bfloat16):
        sd = float(np.std(jl))
        np.testing.assert_allclose(tl, jl, rtol=0, atol=REL * sd)


def test_forward_without_cache_matches_jax():
    jcfg, jp, cfg, tp = _models("float")
    rng = np.random.default_rng(8)
    toks = rng.integers(1, cfg.vocab_size, (2, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    jl, _ = jllama.forward(jcfg, jp, jnp.asarray(toks), jnp.asarray(pos))
    tl, cache = tllama.forward(cfg, tp, torch.from_numpy(toks),
                               torch.from_numpy(pos))
    assert cache is None and tl.shape == (2, 12, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


def test_attention_cached_decode_matches_jax():
    jcfg = JaxModelConfig.tiny_test()
    cfg = ModelConfig.tiny_test()
    rng = np.random.default_rng(9)
    b, n, kvn, d, smax = 3, 4, 2, 32, 128
    q = rng.standard_normal((b, 1, n, d)).astype(np.float32)
    ck = rng.standard_normal((2, b, kvn, smax, d)).astype(np.float32)
    cv = rng.standard_normal((2, b, kvn, smax, d)).astype(np.float32)
    lens = np.asarray([1, 77, smax], np.int32)
    mask = (np.arange(smax)[None, None, None, :]
            < lens[:, None, None, None])
    want = jdispatch.attention_cached(
        jcfg, jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(mask), jnp.asarray(lens), False, layer=jnp.int32(1))
    got = dispatch.attention_cached(cfg, torch.from_numpy(q),
                                    torch.from_numpy(ck),
                                    torch.from_numpy(cv),
                                    torch.from_numpy(lens), 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="one query row"):
        dispatch.attention_cached(cfg, torch.from_numpy(q).expand(b, 2, n, d),
                                  torch.from_numpy(ck), torch.from_numpy(cv),
                                  torch.from_numpy(lens), 1)


def test_forward_multi_token_continuation_raises():
    cfg = ModelConfig.tiny_test()
    tp = tllama.init_params(cfg, device="cpu")
    cache = DenseKVCache.create(cfg.num_layers, 1, 64, cfg.num_kv_heads,
                                cfg.head_dim, torch.float32, device="cpu")
    toks = torch.ones((1, 4), dtype=torch.int32)
    pos = torch.arange(8, 12, dtype=torch.int32)[None]
    with pytest.raises(NotImplementedError, match="continuation"):
        tllama.forward(cfg, tp, toks, pos, cache, prefill_from_zero=False)


def test_dense_cache_defaults_to_cuda():
    if torch.cuda.is_available():
        assert DenseKVCache.create(1, 1, 8, 1, 8).k.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DenseKVCache.create(1, 1, 8, 1, 8)
