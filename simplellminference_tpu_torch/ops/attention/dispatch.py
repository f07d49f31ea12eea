"""Attention dispatch for the model.

Counterpart of simplellminference_tpu/ops/attention/dispatch.py:68-137,
:140-194 and :197-269. There is no backend switch here: each kernel
wrapper launches its CUDA kernel for CUDA tensors and takes its plain
version for CPU tensors, so on the card every call goes through a kernel.
INT8-KV pools pass their scale pools (``pool_ks``/``pool_vs``) on to the
paged kernels, FP8 (e4m3) pools go, by their dtype, to the kernels'
FP8-KV forms (4e, 4ve, 8e), and a sliding window (``cfg.sliding_window``,
or the per-layer ``window`` a caller passes for ``layer_types`` stacks)
goes to each kernel's window form, the dense arena's included (13w) and
over e4m3 pools (4ew, 4vew, 8ew), and Gemma-2's logit soft cap
(``cfg.attn_logit_softcap``) to the capped forms of kernels 3, 4 (decode
and verify rows), 8 and 13 over bf16/f32 KV and of 4 and 8 over INT8 and
e4m3 pools (4ec, 4ewc, 4vec, 4vewc, 8ec, 8ewc), at head_dim 256 too, and
a layer's GPT-OSS attention sinks (``sinks`` [N], passed by the caller as
the JAX dispatcher takes them) to the sink forms of kernels 3, 4 (decode
and verify rows), 8 and 13 over bf16/f32 KV and of 4 and 8 over INT8 and
e4m3 pools (4es, 4ews, 4ves, 4vews, 8es, 8ews). Sinks at head_dim 256,
which the kernels do not take yet, raise. Absorbed MLA's shared-KV rows go
to the shared forms: a whole prompt called with v = k to 3l
(``flash_prefill_shared``), a shared pool (``pool_v`` None, as the JAX
dispatcher passes it) to 8l and 4l through ``paged_flash_prefill`` and
``paged_flash_decode``.
"""

from __future__ import annotations

import torch

from simplellminference_tpu_torch.core.config import ModelConfig
from simplellminference_tpu_torch.ops.attention.flash_decode import (
    flash_decode)
from simplellminference_tpu_torch.ops.attention.flash_prefill import (
    flash_prefill, flash_prefill_shared)
from simplellminference_tpu_torch.ops.attention.paged_decode import (
    paged_flash_decode, paged_flash_verify)
from simplellminference_tpu_torch.ops.attention.paged_prefill import (
    paged_flash_prefill)


_UNSET = object()


def _attn_opts(cfg: ModelConfig, window=_UNSET):
    """(window, sm_scale, logit_cap) for one attention call
    (dispatch.py:68-79): ``window`` defaults to cfg.sliding_window, and
    alternating sliding/full stacks (``layer_types``) pass each layer's;
    sm_scale is query_pre_attn_scalar**-0.5 when set, else None (the
    kernels' D**-0.5); logit_cap is attn_logit_softcap (Gemma-2). A
    layer's sinks travel beside them, as in the JAX dispatcher."""
    w = cfg.sliding_window if window is _UNSET else window
    sm = (None if cfg.query_pre_attn_scalar is None
          else cfg.query_pre_attn_scalar ** -0.5)
    return w, sm, cfg.attn_logit_softcap


def attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, window=_UNSET,
              sinks: torch.Tensor | None = None) -> torch.Tensor:
    """Causal self-attention of a prompt, no cache read-back.
    q: [B, S, N, D]; k/v: [B, S, kvN, D]; ``sinks`` [N]: the layer's
    GPT-OSS attention-sink logits. ``v is k`` (absorbed MLA's latent rows,
    llama.py:713-717) takes the shared form 3l."""
    window, sm, cap = _attn_opts(cfg, window)
    if v is k:
        if window is not None or cap or sinks is not None:
            raise NotImplementedError("a window, a soft cap or sinks over "
                                      "shared-KV rows (absorbed MLA)")
        return flash_prefill_shared(q, k, sm_scale=sm)
    return flash_prefill(q, k, v, sm_scale=sm, window=window, logit_cap=cap,
                         sinks=sinks)


def attention_cached(cfg: ModelConfig, q: torch.Tensor,
                     ck: torch.Tensor, cv: torch.Tensor,
                     kv_lens: torch.Tensor, layer: int | None = None,
                     window=_UNSET,
                     sinks: torch.Tensor | None = None) -> torch.Tensor:
    """Decode attention against the dense arena (counterpart of
    dispatch.py:95-123): ``flash_decode`` over slots [0, kv_len), the last
    ``window`` of them with a sliding window (default cfg.sliding_window;
    alternating ``layer_types`` stacks pass each layer's, as for
    :func:`attention`). q: [B, 1, N, D]; ck/cv: [B, kvN, Smax, D], or the
    stacked arena [L, B', kvN, Smax, D] with an int ``layer``; kv_lens:
    [B]. A prefill from slot 0 attends its fresh k/v through
    :func:`attention` instead, as ``models.llama.forward`` does.
    ``sinks`` [N]: the layer's GPT-OSS attention-sink logits (13s,
    13ws)."""
    if q.shape[1] != 1:
        raise ValueError(f"one query row per sequence, not {q.shape[1]}")
    window, sm, cap = _attn_opts(cfg, window)
    return flash_decode(q[:, 0], ck, cv, kv_lens, layer=layer,
                        window=window, sm_scale=sm, logit_cap=cap,
                        sinks=sinks)[:, None]


def attention_paged_prefill(cfg: ModelConfig, q: torch.Tensor,
                            pool_k: torch.Tensor, pool_v: torch.Tensor,
                            tables: torch.Tensor, kv_lens: torch.Tensor,
                            chunk_offset: torch.Tensor, layer: int,
                            pool_ks: torch.Tensor | None = None,
                            pool_vs: torch.Tensor | None = None,
                            window=_UNSET,
                            sinks: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Chunked-prefill attention through the page tables (counterpart of
    dispatch.py:140-194): row b's queries sit at absolute positions
    chunk_offset[b] + 0..S-1 and attend to every cached position
    < kv_lens[b] up to the causal frontier. q: [B, S, N, D]; pools:
    stacked [L, P+1, kvN, ps, D] with an int ``layer``, and their scale
    pools [L, P+1, kvN, ps] for INT8 KV."""
    window, sm, cap = _attn_opts(cfg, window)
    return paged_flash_prefill(q, pool_k, pool_v, tables, kv_lens,
                               chunk_offset, layer, sm_scale=sm,
                               window=window, logit_cap=cap, sinks=sinks,
                               k_scale=pool_ks, v_scale=pool_vs)


def attention_paged(cfg: ModelConfig, q: torch.Tensor, pool_k: torch.Tensor,
                    pool_v: torch.Tensor, tables: torch.Tensor,
                    kv_lens: torch.Tensor, layer: int,
                    pool_ks: torch.Tensor | None = None,
                    pool_vs: torch.Tensor | None = None,
                    window=_UNSET,
                    sinks: torch.Tensor | None = None) -> torch.Tensor:
    """Paged decode attention (counterpart of dispatch.py:197-269).
    q: [B, S, N, D]: S = 1 is decode; S > 1 a speculative verify window,
    whose row s sits at position kv_lens - S + s. Pools: stacked
    [L, P+1, kvN, ps, D] with an int ``layer``, and their scale pools
    [L, P+1, kvN, ps] for INT8 KV."""
    window, sm, cap = _attn_opts(cfg, window)
    if q.shape[1] == 1:
        return paged_flash_decode(q[:, 0], pool_k, pool_v, tables, kv_lens,
                                  layer, sm_scale=sm, k_scale=pool_ks,
                                  v_scale=pool_vs, window=window,
                                  logit_cap=cap, sinks=sinks)[:, None]
    return paged_flash_verify(q, pool_k, pool_v, tables, kv_lens, layer,
                              sm_scale=sm, k_scale=pool_ks, v_scale=pool_vs,
                              window=window, logit_cap=cap, sinks=sinks)
