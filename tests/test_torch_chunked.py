"""The port's chunked ``forward_paged`` against the JAX package's.

One JAX parameter draw of ``ModelConfig.tiny_test()`` (2 layers, GQA),
float32 and INT8 (per output channel, INT8 LM head, the JAX package's
``quantize_params``), carried to the port with ``params_from_jax``. Two
rows prefill their prompts in chunks at per-row page-aligned offsets
(``chunk_offset``), each chunk attending through the page tables to what
the earlier chunks wrote. Stated tolerances: logits within 1e-4 (XLA and
PyTorch sum matmuls in different orders), pools within 1e-5 on every page
but the trash page. With INT8 weights the port takes ``fused_ffn`` where
B*S <= 64 rows (its plain version here) and the unfused FFN above; the
JAX package runs its unfused CPU path throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplellminference_tpu.core.config import ModelConfig as JaxModelConfig
from simplellminference_tpu.core.config import QuantConfig as JaxQuantConfig
from simplellminference_tpu.memory.paged_kv import PagedKVCache as JaxCache
from simplellminference_tpu.models import llama as jllama
from simplellminference_tpu.runtime.weights import (
    quantize_params as jquantize_params)
from simplellminference_tpu_torch.core.config import ModelConfig
from simplellminference_tpu_torch.memory.paged_kv import (PagedKVCache,
                                                          gather_dense)
from simplellminference_tpu_torch.models import llama as tllama
from simplellminference_tpu_torch.models.convert import params_from_jax
from simplellminference_tpu_torch.ops import ffn_fused

PS, PAGES = 8, 20
TABLES = np.asarray([[3, 9, 4, 11, 0, 15, 7, 19],
                     [5, 1, 13, 2, 17, 6, 8, 10]], np.int32)


@pytest.fixture(scope="module", params=["float", "int8"])
def model(request):
    jcfg = JaxModelConfig.tiny_test()
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    if request.param == "int8":
        jp = jquantize_params(jp, JaxQuantConfig(mode="int8", group_size=0,
                                                 quantize_lm_head=True))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return request.param, jcfg, jp, ModelConfig.tiny_test(), tp


# (S, per-row chunk offsets, kv_lens after the chunk): row 0 runs three
# chunks of 16, row 1 starts one page in (its first page written by the
# first call's 8-token chunk), so offsets differ per row
CHUNKS = [(16, [0, 0], [16, 8]),
          (16, [16, 8], [32, 24]),
          (40, [32, 24], [61, 50])]


@pytest.mark.parametrize("chunks", [CHUNKS[:2], CHUNKS],
                         ids=["m32", "m32-m80"])
def test_forward_paged_chunked_matches_jax(model, chunks, monkeypatch):
    kind, jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, cfg.vocab_size, (2, 72)).astype(np.int32)
    ffn_rows = []
    orig = ffn_fused.fused_ffn

    def spy(x, *a, **kw):
        ffn_rows.append(x.shape[0])
        return orig(x, *a, **kw)
    monkeypatch.setattr(ffn_fused, "fused_ffn", spy)
    jc = JaxCache.create(cfg.num_layers, PAGES, cfg.num_kv_heads, PS,
                         cfg.head_dim, jnp.float32)
    tc = PagedKVCache.create(cfg.num_layers, PAGES, cfg.num_kv_heads, PS,
                             cfg.head_dim, torch.float32, device="cpu")
    for s, offs, lens in chunks:
        offs = np.asarray(offs, np.int32)
        lens = np.asarray(lens, np.int32)
        toks = np.stack([prompt[i, o:o + s] for i, o in enumerate(offs)])
        toks = np.where(offs[:, None] + np.arange(s)[None] < lens[:, None],
                        toks, 0).astype(np.int32)
        pos = (offs[:, None] + np.arange(s, dtype=np.int32)[None])
        jl, jc = jllama.forward_paged(
            jcfg, jp, jnp.asarray(toks), jnp.asarray(pos), jc,
            jnp.asarray(TABLES), jnp.asarray(lens), prefill=True,
            last_token_only=True, chunk_offset=jnp.asarray(offs))
        tl, tc = tllama.forward_paged(
            cfg, tp, torch.from_numpy(toks), torch.from_numpy(pos), tc,
            torch.from_numpy(TABLES), torch.from_numpy(lens), prefill=True,
            last_token_only=True, chunk_offset=torch.from_numpy(offs))
        assert tl.shape == (2, 1, cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(tl[:, 0].argmax(-1).numpy(),
                                      np.asarray(jl[:, 0]).argmax(-1))
    for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(t.numpy()[:, :-1], np.asarray(j)[:, :-1],
                                   rtol=1e-5, atol=1e-5)
    # INT8: m = 2 x 16 = 32 rows fuse the FFN, 2 x 40 = 80 rows do not
    want = ([32] * cfg.num_layers * 2 if kind == "int8" else [])
    assert ffn_rows == want


def test_chunked_equals_whole_prompt_prefill(model):
    # the same prompt prefilled whole and in two chunks gives the same
    # last-token logits and pools (both in the port)
    _kind, _jcfg, _jp, cfg, tp = model
    rng = np.random.default_rng(6)
    prompt = rng.integers(1, cfg.vocab_size, (1, 29)).astype(np.int32)
    tables = torch.from_numpy(TABLES[:1].copy())
    whole = PagedKVCache.create(cfg.num_layers, PAGES, cfg.num_kv_heads, PS,
                                cfg.head_dim, torch.float32, device="cpu")
    toks = np.zeros((1, 32), np.int32)
    toks[0, :29] = prompt[0]
    lw, whole = tllama.forward_paged(
        cfg, tp, torch.from_numpy(toks), torch.arange(32)[None], whole,
        tables, torch.tensor([29]), prefill=True, last_token_only=True)
    chunked = PagedKVCache.create(cfg.num_layers, PAGES, cfg.num_kv_heads,
                                  PS, cfg.head_dim, torch.float32,
                                  device="cpu")
    for off in (0, 16):
        lc, chunked = tllama.forward_paged(
            cfg, tp, torch.from_numpy(toks[:, off:off + 16]),
            torch.arange(off, off + 16)[None], chunked, tables,
            torch.tensor([min(29, off + 16)]), prefill=True,
            last_token_only=True, chunk_offset=torch.tensor([off]))
    np.testing.assert_allclose(lc.numpy(), lw.numpy(), rtol=1e-4, atol=1e-4)
    # positions < 29 (the padding rows attend differently: causally to
    # each other in the whole pass, only below kv_len in the chunked one)
    for layer in range(cfg.num_layers):
        got = gather_dense(chunked.k[layer], chunked.v[layer], tables)
        want = gather_dense(whole.k[layer], whole.v[layer], tables)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[:, :, :29].numpy(),
                                       w[:, :, :29].numpy(), rtol=1e-5,
                                       atol=1e-5)
