"""FP8 (e4m3) KV on the dense arena in the port against the JAX package on
the CPU: the e4m3 forms of kernels 12 (12e: ``kv_append`` into an e4m3
arena), 13 (13e, 13ew, 13ec, 13ewc, 13es, 13ews: ``flash_decode`` over
one) and 6d (6de: the dense fused qkv writing one), and the Generator over
e4m3 arenas for the three families it serves.

The port's wrappers run their plain versions on CPU tensors; the JAX side
runs as its own CPU tests run it: ``kv_append_ref`` (its Pallas write takes
no interpret mode), ``flash_decode`` and the dense ``fused_qkv_append`` in
interpret mode, and its ``Generator`` with ``jnp.float8_e4m3fn`` arenas
(the jnp writes and attention of its CPU path). Inputs come from numpy
with fixed seeds; e4m3 arrays pass between the packages as their bytes
(tests/test_torch_fp8kv.py's helpers). Stated tolerances:
- 12e: byte-equal to JAX's ``kv_append_ref`` at D 32-256, S 1 and S 5,
  f32 and bf16 rows of magnitudes past 464 (NaN codes in JAX's cast);
  a slot past Smax is dropped by the port where JAX clamps the start
  (ROADMAP §3, "The dense path"), so that case is pinned against the
  port's own rule;
- the 13e-forms: within 1e-5 of the outputs' largest magnitude (at least
  1) of JAX's ``flash_decode`` over the same e4m3 arena (sums in another
  order; the stored values are exact in both) at D 64 and 128, and 256
  without sinks (sinks at D 256 raise in the port): kv_len 0, a window
  wholly inside the arena and one wholly past Smax, scores past the cap;
  slots past kv_len and below the band holding NaN codes (0x7f) reach no
  output;
- 6de: bf16 rows against JAX's dense kernel in interpret mode at D 128
  and 256, q within 2e-2 of its standard deviation and the written codes
  at most one e4m3 step apart (tests/test_torch_fp8kv.py's 6e rule), every
  other byte equal; f32 rows against JAX's unfused route, byte-equal;
- the Generators (tiny Llama in f32 and with INT8 weights, the tiny
  Gemma-2 of tests/test_torch_gemma2.py at head_dim 256 with INT8
  weights: its window of 4, the cap and 6de/256; the tiny GPT-OSS of
  tests/test_torch_gpt_oss.py with INT8 weights: sinks, biases, experts,
  12e every step): ``generate`` and ``generate_fused`` greedy tokens equal
  to JAX's ``Generator``; the dense forward call by call from JAX's codes,
  the codes a call writes at most one e4m3 step apart and its logits
  within 1e-4 while both wrote the same codes, within 1e-2 once a code is
  a step apart (tests/test_torch_fp8kv_engine.py's FP8-KV rule).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_fp8kv as f8
import test_torch_gemma2 as gem2
import test_torch_gpt_oss as oss
from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.core.config import QuantConfig as JaxQuantConfig
from simplellminference_tpu.core.config import SamplingParams as JaxSampling
from simplellminference_tpu.models import llama as jllama
from simplellminference_tpu.ops import qkv_fused as jqkv
from simplellminference_tpu.ops import ref_ops as jref
from simplellminference_tpu.ops.attention.flash_decode import (
    flash_decode as jflash_decode)
from simplellminference_tpu.ops.kv_append import (
    kv_append_ref as jkv_append_ref)
from simplellminference_tpu.runtime.generator import (
    Generator as JaxGenerator)
from simplellminference_tpu.runtime.kv_cache import DenseKVCache as JaxDense
from simplellminference_tpu.runtime.weights import (
    quantize_params as jquantize_params)
from simplellminference_tpu_torch.core.config import (ModelConfig,
                                                      SamplingParams)
from simplellminference_tpu_torch.models import llama as tllama
from simplellminference_tpu_torch.models.convert import params_from_jax
from simplellminference_tpu_torch.ops import kv_append as tka
from simplellminference_tpu_torch.ops import qkv_fused as tqkv
from simplellminference_tpu_torch.ops.attention import flash_decode as tfd
from simplellminference_tpu_torch.ops.ref_ops import to_e4m3
from simplellminference_tpu_torch.runtime.generator import Generator
from simplellminference_tpu_torch.runtime.kv_cache import DenseKVCache

TOL = 1e-5
LOGIT_TOL, LOGIT_TOL_CODE_APART = 1e-4, 1e-2
E4 = torch.float8_e4m3fn
NAN = 0x7F                    # an e4m3fn NaN code
t, rand, codes = f8.t, f8.rand, f8.codes


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


def j(a):
    return None if a is None else jnp.asarray(a)


def close(got, want, tol=TOL):
    """Within ``tol`` of the outputs' largest magnitude (at least 1)."""
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * max(1.0, top))


def arena(rng, layers, rows, kvn, smax, d):
    """K and V arenas [L, B', kvN, Smax, D] of e4m3 codes (uint8) of
    N(0, 2^2) values, cast by the port's ``to_e4m3``."""
    return f8.e4m3_pools(rng, layers, rows, kvn, smax, d)


# -------------------------------------------------------------- 12e

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s", [1, 5], ids=["decode", "rows"])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_kv_append_fp8kv_matches_jax(d, s, dtype):
    """12e: rows of 1e-4..1e3 (some past 464: NaN codes) written into the
    e4m3 arena byte for byte as JAX's kv_append_ref writes them, at
    offsets 0, 7 and Smax - S (JAX's fallback takes an arena of B rows);
    the other layer untouched."""
    rng = np.random.default_rng(d + 10 * s + (dtype == "bf16"))
    b, kvn, smax = 3, 2, 32
    ck, cv = arena(rng, 2, b, kvn, smax, d)
    tk, jk = f8.rows(rng, (b, s, kvn, d), dtype)
    tv, jv = f8.rows(rng, (b, s, kvn, d), dtype)
    offs = np.asarray([0, 7, smax - s], np.int32)
    want = jkv_append_ref(f8.jax_e4(ck), f8.jax_e4(cv), jk, jv,
                          jnp.int32(1), j(offs))
    tp = [f8.torch_e4(ck), f8.torch_e4(cv)]
    before = tka.kv_append_fp8kv.launches, tka.kv_append.launches
    got = tka.kv_append(tp[0], tp[1], tk, tv, 1, t(offs))
    assert got[0] is tp[0] and got[1] is tp[1]
    assert (tka.kv_append_fp8kv.launches,
            tka.kv_append.launches) == before       # plain on the CPU
    for g, w in zip(tp, want):
        np.testing.assert_array_equal(codes(g), codes(w))
    assert (codes(tp[0])[1, :b] & 0x7F == 0x7F).any()   # rows past 464
    np.testing.assert_array_equal(codes(tp[0])[0], ck[0])
    # the named form takes the same path
    tq = [f8.torch_e4(ck), f8.torch_e4(cv)]
    tka.kv_append_fp8kv(tq[0], tq[1], tk, tv, 1, t(offs))
    assert all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for x, y in zip(tp, tq))


def test_kv_append_fp8kv_drops_slots_outside_the_arena():
    """The port's rule where JAX's jnp fallback clamps the start: each row
    whose slot falls outside [0, Smax) is dropped, the rows inside written
    (S 5 at offsets Smax - 2 and -3), nothing else touched (the arena's
    third row, past the batch, included)."""
    rng = np.random.default_rng(77)
    kvn, smax, d, s = 2, 16, 64, 5
    ck, cv = arena(rng, 2, 3, kvn, smax, d)
    nk = t(rand(rng, 2, s, kvn, d) * 100)
    nv = t(rand(rng, 2, s, kvn, d) * 100)
    offs = np.asarray([smax - 2, -3], np.int32)
    tp = [f8.torch_e4(ck), f8.torch_e4(cv)]
    tka.kv_append(tp[0], tp[1], nk, nv, 0, t(offs))
    for got, old, new in zip(tp, (ck, cv), (nk, nv)):
        want = old.copy()
        cast = codes(to_e4m3(new))                    # [B, S, kvN, D]
        for r, off in enumerate(offs):
            for i in range(s):
                if 0 <= off + i < smax:
                    want[0, r, :, off + i] = cast[r, i]
        np.testing.assert_array_equal(codes(got), want)
    assert not np.array_equal(codes(tp[0])[0, 0, :, smax - 2],
                              ck[0, 0, :, smax - 2])


# ------------------------------------------------------------ kernel 13

WINDOW, CAP = 16, 2.0
N, KVN, SMAX = 8, 2, 128      # a GQA group of 4
# kv_len 0 (a zero row), 1, 40 (the window wholly inside), Smax, and 150
# (past Smax: every slot, or with the window a band wholly past Smax)
LENS = [0, 1, 40, SMAX, 150]
# form: (window, cap, sinks)
FORMS13 = {"13e": (None, None, False), "13ew": (WINDOW, None, False),
           "13ec": (None, CAP, False), "13ewc": (WINDOW, CAP, False),
           "13es": (None, None, True), "13ews": (WINDOW, None, True)}
CASES13 = [(d, form) for d in (64, 128, 256) for form in FORMS13
           if not (d == 256 and FORMS13[form][2])]


def _decode_case(seed, d):
    rng = np.random.default_rng(seed)
    ck, cv = arena(rng, 2, len(LENS) + 1, KVN, SMAX, d)
    q = rand(rng, len(LENS), N, d, scale=3.0)       # scores past the cap
    return rng, q, ck, cv, np.asarray(LENS, np.int32)


@pytest.mark.parametrize("d,form", CASES13,
                         ids=[f"{f}-d{d}" for d, f in CASES13])
def test_flash_decode_fp8kv_matches_jax(d, form):
    window, cap, has_sinks = FORMS13[form]
    rng, q, ck, cv, lens = _decode_case(d + list(FORMS13).index(form), d)
    sinks = rand(rng, N) if has_sinks else None
    got = tfd.flash_decode(t(q), f8.torch_e4(ck), f8.torch_e4(cv), t(lens),
                           layer=1, window=window, logit_cap=cap,
                           sinks=None if sinks is None else t(sinks))
    want = jflash_decode(j(q), f8.jax_e4(ck), f8.jax_e4(cv), j(lens),
                         interpret=True, layer=jnp.int32(1), window=window,
                         logit_cap=cap, sinks=j(sinks))
    assert got.dtype == torch.float32 and got.shape == q.shape
    close(got.numpy(), want)
    assert not got[0].any()
    if window:
        assert not got[-1].any()       # the band lies wholly past Smax
    if cap:
        plain = tfd.flash_decode(t(q), f8.torch_e4(ck), f8.torch_e4(cv),
                                 t(lens), layer=1, window=window)
        assert float((plain - got).abs().max()) > 1e-2   # the cap bites
    # the named forms: the same function, and nothing launched on the CPU
    before = [f.launches for f in tfd._FORMS.values()]
    named = (tfd.flash_decode_fp8kv(t(q), f8.torch_e4(ck), f8.torch_e4(cv),
                                    t(lens), layer=1, logit_cap=cap,
                                    sinks=None if sinks is None else t(sinks))
             if window is None else
             tfd.flash_decode_fp8kv_window(
                 t(q), f8.torch_e4(ck), f8.torch_e4(cv), t(lens), window,
                 layer=1, logit_cap=cap,
                 sinks=None if sinks is None else t(sinks)))
    assert torch.equal(named, got)
    assert [f.launches for f in tfd._FORMS.values()] == before


@pytest.mark.parametrize("window", [None, WINDOW], ids=["13e", "13ew"])
def test_flash_decode_fp8kv_reads_no_stale_slot(window):
    """Slots past kv_len, and below the window's band, holding NaN codes
    (stale e4m3 rows) change nothing: the output equals the one over the
    arena with finite codes there, bit for bit, and is finite."""
    rng, q, ck, cv, lens = _decode_case(91, 64)
    dirty = [c.copy() for c in (ck, cv)]
    for r, ln in enumerate(lens):
        for c in dirty:
            c[1, r, :, max(0, ln):] = NAN
            if window:
                c[1, r, :, :max(0, ln - window)] = NAN
    c_tk, c_tv = (f8.torch_e4(c) for c in (ck, cv))
    d_tk, d_tv = (f8.torch_e4(c) for c in dirty)
    clean = tfd.flash_decode(t(q), c_tk, c_tv, t(lens), layer=1,
                             window=window)
    got = tfd.flash_decode(t(q), d_tk, d_tv, t(lens), layer=1,
                           window=window)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, clean)


def test_flash_decode_fp8kv_refuses_sinks_at_d256_and_other_arenas():
    """Sinks at head_dim 256 raise, named, as over every arena; the
    FP8-KV forms refuse arenas that are not e4m3; q in another dtype than
    bf16 or f32 over an e4m3 arena is not a form."""
    _rng, q, ck, cv, lens = _decode_case(5, 256)
    with pytest.raises(NotImplementedError, match="sinks at head_dim 256"):
        tfd.flash_decode(t(q), f8.torch_e4(ck), f8.torch_e4(cv), t(lens),
                         layer=1, sinks=torch.zeros(N))
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        tfd.flash_decode_fp8kv(t(q), f8.torch_e4(ck).float(),
                               f8.torch_e4(cv).float(), t(lens), layer=1)


# ------------------------------------------------------------ 6de

def _qkv_case(seed, d, n, kvn, dtype):
    """A dense fused qkv step: three rows into an e4m3 arena of three rows
    (Smax 64) at layer 1, the weights of layer 1; weight scales that put
    some k/v values past 464 (NaN codes)."""
    rng = np.random.default_rng(seed)
    lyr, h, smax, b, li = 2, 128, 64, 3, 1
    nq = (n + 2 * kvn) * d
    wq = rng.integers(-127, 128, (lyr, h, nq)).astype(np.int8)
    ws = (rng.uniform(0.5, 2.0, (lyr, 1, nq)) * 2e-1).astype(np.float32)
    nw = (rng.standard_normal((lyr, h)) * 0.1 + 1.0).astype(np.float32)
    x = rand(rng, b, h)
    if dtype == "bf16":
        xt = t(x).bfloat16()
        xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    else:
        xt, xj = t(x), jnp.asarray(x)
    pos = np.asarray([5, 20, 63], np.int32)
    ck, cv = arena(rng, lyr, b, kvn, smax, d)
    written = np.zeros((lyr, b, kvn, smax), bool)
    written[li, np.arange(b), :, pos] = True
    sin, cos = jref.rope_tables(jnp.asarray(pos), d, 10000.0)
    return dict(wq=wq, ws=ws, nw=nw, xt=xt, xj=xj, pos=pos, ck=ck, cv=cv,
                written=written, n=n, kvn=kvn, d=d, li=li, sin=sin, cos=cos)


def _port_dense(c, fn=tqkv.fused_qkv_append):
    tp = [f8.torch_e4(c["ck"]), f8.torch_e4(c["cv"])]
    before = (tqkv.fused_qkv_append_fp8kv.launches,
              tqkv.fused_qkv_append_dense.launches,
              dict(tqkv.DENSE_LAUNCHES))
    q, *out = fn(c["xt"], t(c["nw"]), t(c["wq"]), t(c["ws"]),
                 t(np.array(c["sin"])), t(np.array(c["cos"])), tp[0], tp[1],
                 c["li"], t(c["pos"]), n_heads=c["n"], kv_heads=c["kvn"],
                 eps=1e-5)
    assert all(a is b for a, b in zip(out, tp))
    assert (tqkv.fused_qkv_append_fp8kv.launches,
            tqkv.fused_qkv_append_dense.launches,
            dict(tqkv.DENSE_LAUNCHES)) == before     # plain on the CPU
    return q, tp


QKV_CASES = {"d128": (128, 4, 2), "d256": (256, 4, 2)}


@pytest.mark.parametrize("case", list(QKV_CASES))
def test_fused_qkv_append_dense_fp8kv_matches_jax_kernel_bf16(case):
    """6de, 6de/256 in bf16 against JAX's dense kernel in interpret mode:
    q within 2e-2 of its standard deviation, the written codes at most
    one e4m3 step apart, every other byte equal."""
    d, n, kvn = QKV_CASES[case]
    c = _qkv_case(40 + d, d, n, kvn, "bf16")
    q_t, tp = _port_dense(c)
    q_j, *want = jqkv.fused_qkv_append(
        c["xj"], jnp.asarray(c["nw"]), jnp.asarray(c["wq"]),
        jnp.asarray(c["ws"]), c["sin"], c["cos"], f8.jax_e4(c["ck"]),
        f8.jax_e4(c["cv"]), jnp.int32(c["li"]), jnp.asarray(c["pos"]),
        n_heads=n, kv_heads=kvn, eps=1e-5, interpret=True)
    assert q_t.dtype == torch.bfloat16
    want_q = np.asarray(q_j, np.float32)
    np.testing.assert_allclose(q_t.float().numpy(), want_q, rtol=0,
                               atol=2e-2 * float(np.std(want_q)))
    w = c["written"][..., None].repeat(d, -1)
    for g, jw in zip(tp, want):
        g, jw = codes(g), codes(jw)
        np.testing.assert_array_equal(g[~w], jw[~w])
        assert np.abs(f8._ordinal(g[w]) - f8._ordinal(jw[w])).max() <= 1


@pytest.mark.parametrize("case", list(QKV_CASES))
def test_fused_qkv_append_dense_fp8kv_matches_jax_unfused_f32(case):
    """6de, 6de/256 in f32 against JAX's unfused route (rmsnorm, the INT8
    product, RoPE, kv_append_ref into the e4m3 arena): q within 1e-5 of
    its largest magnitude, the arena byte-equal (NaN codes included); the
    dense wrapper and the FP8-KV form write the same bytes."""
    d, n, kvn = QKV_CASES[case]
    c = _qkv_case(50 + d, d, n, kvn, "f32")
    q_t, tp = _port_dense(c)
    li, b = c["li"], 3
    xn = jref.rmsnorm(c["xj"], jnp.asarray(c["nw"][li]), 1e-5)
    qkv = f8.jlinear(xn, f8.JaxQW(q=jnp.asarray(c["wq"]),
                                  scales=jnp.asarray(c["ws"])),
                     layer=jnp.int32(li))
    sin, cos = c["sin"][:, None], c["cos"][:, None]
    q = jref.apply_rope(qkv[:, None, :n * d].reshape(b, 1, n, d), sin,
                        cos)[:, 0]
    k = jref.apply_rope(qkv[:, None, n * d:(n + kvn) * d].reshape(
        b, 1, kvn, d), sin, cos)
    v = qkv[:, None, (n + kvn) * d:].reshape(b, 1, kvn, d)
    want = jkv_append_ref(f8.jax_e4(c["ck"]), f8.jax_e4(c["cv"]), k, v,
                          jnp.int32(li), jnp.asarray(c["pos"]))
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q), rtol=0,
                               atol=TOL * float(np.abs(np.asarray(q)).max()))
    assert float(np.abs(np.asarray(k)).max()) > 464
    for g, jw in zip(tp, want):
        np.testing.assert_array_equal(codes(g), codes(jw))
    for fn in (tqkv.fused_qkv_append_dense, functools.partial(
            tqkv.fused_qkv_append_fp8kv, tables=None)):
        _q, again = _port_dense(c, fn)
        assert all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                   for x, y in zip(again, tp))


def test_dense_int8_kv_still_raises():
    """INT8 KV on the dense arena stays refused, named: the JAX dense
    arena has no scale pools (the fused qkv asserts it,
    qkv_fused.py:291-292), and the Generator refuses an int8 arena."""
    c = _qkv_case(3, 128, 4, 2, "f32")
    ck = t(np.zeros((2, 3, 2, 64, 128), np.int8))
    scales = torch.zeros((2, 3, 2, 64))
    with pytest.raises(NotImplementedError, match="INT8 KV on a dense"):
        tqkv.fused_qkv_append(
            c["xt"], t(c["nw"]), t(c["wq"]), t(c["ws"]),
            t(np.array(c["sin"])), t(np.array(c["cos"])), ck, ck.clone(),
            1, t(c["pos"]), n_heads=4, kv_heads=2, cache_ks=scales,
            cache_vs=scales.clone())
    cfg = ModelConfig.tiny_test()
    params = {"embed": torch.zeros((cfg.vocab_size, cfg.hidden_size))}
    with pytest.raises(NotImplementedError, match="INT8 KV on the dense"):
        Generator(cfg, params, kv_dtype=torch.int8, device="cpu")


# --------------------------------------------------------- the Generators

_MODELS: dict = {}
LLAMA_PROMPTS = [[5, 9, 2, 44, 17, 3], [33, 4, 250, 1, 2, 3, 4, 5, 6, 7],
                 [7, 8], list(range(100, 121))]
GPT_OSS_PROMPTS = [[5, 6, 7, 8] * 5, list(range(30, 51)),
                   [9, 8, 7, 9, 8, 7], [101, 4]]


def _llama(quant: bool):
    jcfg = JaxModelConfig.tiny_test(max_seq_len=256)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(21))
    if quant:
        jp = jquantize_params(jp, JaxQuantConfig(mode="int8", group_size=0,
                                                 quantize_lm_head=True))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, ModelConfig.tiny_test(max_seq_len=256), tp


def _drawn(name: str):
    """(jax cfg, jax params, port cfg, port params, prompts), drawn once a
    module: the tiny Llama (f32, INT8 weights), the tiny Gemma-2 at head
    dim 256 (INT8 weights: 6de/256, 13ec, 13ewc) and the tiny GPT-OSS
    (INT8 weights: 13es, 13ews, 12e at every step)."""
    if name not in _MODELS:
        if name.startswith("llama"):
            m = _llama(name.endswith("int8")) + (LLAMA_PROMPTS,)
        elif name == "gemma2-int8":
            m = gem2._model(True, head_dim=256,
                            query_pre_attn_scalar=256.0) + (gem2.PROMPTS,)
        else:
            m = oss._drawn("int8") + (GPT_OSS_PROMPTS,)
        _MODELS[name] = m
    return _MODELS[name]


MODELS = ["llama-f32", "llama-int8", "gemma2-int8", "gpt_oss-int8"]


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    return _drawn(request.param)


def test_models_reach_the_forms(model):
    _jcfg, _jp, cfg, _tp, prompts = model
    if cfg.head_dim == 256:
        assert cfg.attn_logit_softcap and None in cfg.layer_windows
        assert max(len(p) for p in prompts) > max(
            w for w in cfg.layer_windows if w)
    if cfg.attn_sinks:
        assert cfg.attention_bias and cfg.num_experts
        assert max(len(p) for p in prompts) > oss.WINDOW


def test_generator_fp8kv_matches_jax(model):
    jcfg, jp, cfg, tp, prompts = model
    jg = JaxGenerator(jcfg, jp, max_batch=4, max_seq=64,
                      kv_dtype=jnp.float8_e4m3fn)
    tg = Generator(cfg, tp, max_batch=4, max_seq=64, kv_dtype=E4,
                   device="cpu")
    want = jg.generate(prompts, JaxSampling(max_new_tokens=10))
    got = tg.generate(prompts, SamplingParams(max_new_tokens=10))
    assert got.token_ids == want.token_ids
    assert got.prompt_lens == want.prompt_lens and got.steps == want.steps
    assert tg.generate_fused(prompts, 10).tolist() == got.token_ids
    assert np.asarray(jg.generate_fused(prompts, 10)).tolist() == (
        got.token_ids)
    assert tg.new_cache(2, 40).k.dtype == E4


def _arena_codes(c):
    return [codes(x) for x in (c.k, c.v)]


def test_dense_forward_fp8kv_matches_jax_call_by_call(model):
    """The prefill and 6 greedy decode steps through both packages' dense
    forward over e4m3 arenas, the port's arena set to JAX's codes before
    each call: the codes a call writes at most one step apart, every other
    byte equal, logits within LOGIT_TOL while both wrote the same codes
    and within LOGIT_TOL_CODE_APART once a code is a step apart."""
    jcfg, jp, cfg, tp, prompts = model
    b, bucket, smax = len(prompts), 32, 64
    toks = np.zeros((b, bucket), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.asarray([len(p) for p in prompts], np.int32)
    pos0 = np.broadcast_to(np.arange(bucket, dtype=np.int32), (b, bucket))
    jc = JaxDense.create(cfg.num_layers, b, smax, cfg.num_kv_heads,
                         cfg.head_dim, jnp.float8_e4m3fn)
    tc = DenseKVCache.create(cfg.num_layers, b, smax, cfg.num_kv_heads,
                             cfg.head_dim, E4, device="cpu")
    zeros = np.zeros(b, np.int32)
    calls = [((jnp.asarray(toks), jnp.asarray(pos0), jnp.asarray(zeros),
               jnp.asarray(lens)), dict(last_token_only=True))]
    apart_calls = 0
    tok = pos = None
    for step in range(7):
        if step:
            calls = [((jnp.asarray(tok[:, None]), jnp.asarray(pos[:, None]),
                       jnp.asarray(pos), jnp.asarray(pos + 1)), {})]
        (jt, jpos, joff, jlen), kw = calls[0]
        before = _arena_codes(jc)
        for dst, src in zip((tc.k, tc.v), before):
            dst.view(torch.uint8).copy_(t(src))
        jl, jc = jllama.forward(jcfg, jp, jt, jpos, jc, joff, jlen, **kw)
        tl, tc = tllama.forward(
            cfg, tp, t(np.array(jt)), t(np.array(jpos)), tc,
            t(np.array(joff)), t(np.array(jlen)), **kw)
        written = np.zeros(tc.k.shape[:4], bool)   # [L, B, kvN, Smax]
        if step:
            written[:, np.arange(b), :, pos] = True
        else:
            written[:, :, :, :bucket] = True
        apart = 0
        for g, w, old in zip(_arena_codes(tc), _arena_codes(jc), before):
            np.testing.assert_array_equal(g[~written], old[~written])
            np.testing.assert_array_equal(w[~written], old[~written])
            assert np.abs(f8._ordinal(g[written])
                          - f8._ordinal(w[written])).max() <= 1
            apart += int((g != w).sum())
        jl = np.asarray(jl, np.float32)
        tol = LOGIT_TOL if apart == 0 else LOGIT_TOL_CODE_APART
        np.testing.assert_allclose(tl.numpy(), jl, rtol=tol, atol=tol)
        apart_calls += apart > 0
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)
        pos = lens.copy() if step == 0 else pos + 1
    # the steps wrote codes: the arenas are not empty at the last position
    assert (codes(tc.k)[:, np.arange(b), :, pos - 1] != 0).any()
