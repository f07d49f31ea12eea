"""The window and soft-cap forms of the dense decode attention (13w, 13c,
13wc) and the capped and head_dim-256 verify forms of the paged decode
attention (4vc, 4vwc, 4v/256, 4vw/256), against the JAX kernels on the CPU.

The port's wrappers run their plain versions on CPU tensors; the JAX
Pallas kernels run in interpret mode, as the JAX package's own tests run
them, on the same numpy inputs (float32, from seeded generators). Scores
are scaled past the cap, kv_lens are 0, below the window, on its edge and
past it, rows ragged. Stated tolerance 1e-5 on the outputs (summation
order). ``dispatch.attention_cached`` takes each layer's window, as JAX's
does (dispatch.py:95-123), where it read ``cfg.sliding_window`` alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.ops.attention import dispatch as jdispatch
from simplellminference_tpu.ops.attention.flash_decode import (
    flash_decode as jflash_decode)
from simplellminference_tpu.ops.attention.paged_decode import (
    paged_flash_verify as jpaged_verify)
from simplellminference_tpu_torch.core.config import ModelConfig
from simplellminference_tpu_torch.ops.attention import dispatch
from simplellminference_tpu_torch.ops.attention import flash_decode as tfd
from simplellminference_tpu_torch.ops.attention import flash_prefill as tfp
from simplellminference_tpu_torch.ops.attention import paged_decode as tpd

TOL = 1e-5
CAP = 5.0          # small, so that the scaled scores pass it
SCALE_Q = 4.0
N, KVN, PS = 4, 2, 8
SMAX = 128         # the JAX kernel's key block divides the arena


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _arena(rng, b, d):
    """A stacked arena of two layers with one row more than the batch (the
    draft's trash row)."""
    return (rand(rng, 2, b + 1, KVN, SMAX, d),
            rand(rng, 2, b + 1, KVN, SMAX, d))


@pytest.mark.parametrize("window,cap", [(6, None), (100, None), (None, CAP),
                                        (6, CAP), (100, CAP)],
                         ids=["13w-6", "13w-100", "13c", "13wc-6",
                              "13wc-100"])
@pytest.mark.parametrize("d", [32, 256])
def test_flash_decode_window_and_cap_match_jax(d, window, cap):
    # kv_len 0 (a zero row), below the window, on its edge, past it, the
    # whole arena
    rng = np.random.default_rng(d + (window or 0) + int(cap or 0))
    lens = np.asarray([0, 3, 6, 7, 77, SMAX], np.int32)
    b = len(lens)
    ck, cv = _arena(rng, b, d)
    q = rand(rng, b, N, d) * (SCALE_Q if cap else 1.0)
    got = tfd.flash_decode(t(q), t(ck), t(cv), t(lens), layer=1,
                           window=window, logit_cap=cap)
    want = jflash_decode(jnp.asarray(q), jnp.asarray(ck[:, :b]),
                         jnp.asarray(cv[:, :b]), jnp.asarray(lens),
                         interpret=True, layer=jnp.int32(1), window=window,
                         logit_cap=cap)
    close(got, want)
    assert not got[0].any()
    # query_pre_attn_scalar's scale (24, not D: a dropped scale shows)
    got = tfd.flash_decode(t(q), t(ck), t(cv), t(lens), layer=1,
                           window=window, sm_scale=24.0 ** -0.5,
                           logit_cap=cap)
    want = jflash_decode(jnp.asarray(q), jnp.asarray(ck[:, :b]),
                         jnp.asarray(cv[:, :b]), jnp.asarray(lens),
                         interpret=True, layer=jnp.int32(1), window=window,
                         sm_scale=24.0 ** -0.5, logit_cap=cap)
    close(got, want)


def test_flash_decode_forms_count_their_launches_apart():
    # on the CPU nothing launches; the forms and the cap still check
    # their options
    rng = np.random.default_rng(5)
    ck, cv = _arena(rng, 2, 32)
    q, lens = t(rand(rng, 2, N, 32)), t(np.asarray([3, 9], np.int32))
    counts = (tfd.flash_decode.launches, tfd.flash_decode_window.launches,
              dict(tfd.D256_LAUNCHES), dict(tfp.CAP_LAUNCHES))
    tfd.flash_decode(q, t(ck), t(cv), lens, layer=0, window=4,
                     logit_cap=CAP)
    assert counts == (tfd.flash_decode.launches,
                      tfd.flash_decode_window.launches,
                      dict(tfd.D256_LAUNCHES), dict(tfp.CAP_LAUNCHES))
    with pytest.raises(ValueError, match="sliding window"):
        tfd.flash_decode(q, t(ck), t(cv), lens, layer=0, window=0)
    with pytest.raises(ValueError, match="soft cap"):
        tfd.flash_decode(q, t(ck), t(cv), lens, layer=0, logit_cap=-1.0)


def _paged(rng, d, b, mp):
    p = b * mp + 1
    pk, pv = rand(rng, 2, p, KVN, PS, d), rand(rng, 2, p, KVN, PS, d)
    tables = rng.permutation(p - 1)[:b * mp].astype(np.int32).reshape(b, mp)
    return pk, pv, tables


@pytest.mark.parametrize("d,window,cap", [
    (32, None, CAP), (32, 3, CAP), (256, None, CAP), (256, 3, CAP),
    (256, None, None), (256, 3, None)],
    ids=["4vc", "4vwc", "4vc-256", "4vwc-256", "4v-256", "4vw-256"])
def test_paged_flash_verify_capped_and_d256_match_jax(d, window, cap):
    # S 3: a row with no key (kv_len 0), a row before position 0 (kv_len
    # 2), a band starting inside a page, a full table; group 2 (Gemma-2).
    # A row with no key is zero in the port, where the JAX kernel averages
    # its masked keys (ROADMAP, differences by design): rows with keys are
    # compared
    rng = np.random.default_rng(30 * d + (window or 0) + int(cap or 0))
    b, s, mp = 4, 3, 6
    pk, pv, tables = _paged(rng, d, b, mp)
    lens = np.asarray([0, 2, 19, 48], np.int32)
    q = rand(rng, b, s, N, d) * (SCALE_Q if cap else 1.0)
    got = tpd.paged_flash_verify(t(q), t(pk), t(pv), t(tables), t(lens), 1,
                                 window=window, logit_cap=cap)
    want = jpaged_verify(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                         jnp.asarray(tables), jnp.asarray(lens),
                         interpret=True, layer=jnp.int32(1), window=window,
                         logit_cap=cap)
    close(got[1:, 1:], np.asarray(want)[1:, 1:])
    close(got[2:], np.asarray(want)[2:])
    assert not got[0].any() and not got[1, :1].any()
    # Gemma-1's group of 8 at D 256 (the kernel's two row blocks at S 5)
    if d == 256 and cap is None:
        q8 = rand(rng, b, 5, 4 * KVN, d)
        lens8 = np.asarray([5, 9, 23, 48], np.int32)
        got = tpd.paged_flash_verify(t(q8), t(pk), t(pv), t(tables),
                                     t(lens8), 0, window=window)
        want = jpaged_verify(jnp.asarray(q8), jnp.asarray(pk),
                             jnp.asarray(pv), jnp.asarray(tables),
                             jnp.asarray(lens8), interpret=True,
                             layer=jnp.int32(0), window=window)
        close(got, want)


def test_attention_cached_honours_a_per_layer_window():
    # a model whose cfg.sliding_window is 6: a full layer (window None)
    # attends every slot below kv_len, a sliding one the last 6, as JAX's
    # attention_cached with each sublayer's window (its kernel, and its
    # CPU route under each window's mask)
    kw = dict(sliding_window=6, num_heads=N, num_kv_heads=KVN, head_dim=32)
    cfg, jcfg = ModelConfig.tiny_test(**kw), JaxModelConfig.tiny_test(**kw)
    rng = np.random.default_rng(9)
    lens = np.asarray([1, 6, 40, SMAX], np.int32)
    b = len(lens)
    ck, cv = _arena(rng, b - 1, 32)
    q = rand(rng, b, 1, N, 32)
    key_pos = np.arange(SMAX)[None, None, None, :]
    kv4 = lens[:, None, None, None]
    for window in (None, 6, 3):
        got = dispatch.attention_cached(cfg, t(q), t(ck), t(cv), t(lens), 1,
                                        window=window)
        want = jflash_decode(jnp.asarray(q[:, 0]), jnp.asarray(ck),
                             jnp.asarray(cv), jnp.asarray(lens),
                             interpret=True, layer=jnp.int32(1),
                             window=window)
        close(got[:, 0], want)
        mask = key_pos < kv4
        if window is not None:
            mask = mask & (key_pos >= kv4 - window)
        jvia = jdispatch.attention_cached(
            jcfg, jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
            jnp.asarray(mask), jnp.asarray(lens), False, layer=jnp.int32(1),
            window=window)
        close(got, jvia)
    # the default is still cfg.sliding_window
    close(dispatch.attention_cached(cfg, t(q), t(ck), t(cv), t(lens), 1),
          dispatch.attention_cached(cfg, t(q), t(ck), t(cv), t(lens), 1,
                                    window=6))
    full = dispatch.attention_cached(cfg, t(q), t(ck), t(cv), t(lens), 1,
                                     window=None)
    assert float((full[2:] - got[2:]).abs().max()) > 1e-2
