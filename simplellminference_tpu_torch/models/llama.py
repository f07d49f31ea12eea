"""Llama-family decoder over the paged KV cache and over the dense KV
arena, as plain functions over a params dict.

Counterpart of simplellminference_tpu/models/llama.py:342-481
(``forward``, the dense arena of the Generator and the draft model; see
its docstring), :484-911 (``forward_paged``) and :914 (``init_params``)
for the plain pre-norm,
full-rotary Llama branch: whole-prompt prefill from position 0, chunked
prefill at per-row page-aligned offsets (prefill chunks and
prefix-cached suffixes, attending through the page tables with
``paged_flash_prefill``), single-token decode, and the speculative verify
window (S > 1 tokens per row at consecutive positions, written with
``paged_append_span`` and attended with ``paged_flash_verify``; the JAX
``spec`` branch, llama.py:548, :688-698). A Python loop over
layers stands in for the ``lax.scan``; stacked [L, ...] weights are
indexed per layer, and the KV pools are written in place. Sliding-window
attention (Mistral's ``sliding_window``, alternating ``layer_types``)
runs in every branch of both forwards, over the ordinary pools, the
grouped engine's ring pools or the dense arena, each layer with its own
window (the JAX scan's static window per sublayer, llama.py:376-456).
Gemma-2's pieces run in both: the attention soft cap (the kernels' capped
forms), the final logit soft cap, the sandwich norms and
``query_pre_attn_scalar``. GPT-OSS's run in both too: the q/k/v bias
after the qkv product, the o bias, each layer's attention sinks (the
kernels' sink forms, on the dense arena and on verify rows too), yarn
rotary tables and the mixture-of-experts FFN
(:mod:`~simplellminference_tpu_torch.ops.moe`: folded experts at decode,
grouped by expert at prefill and on verify rows), which the Mixtral
family's plain softmax route shares.

KV pools are bf16/f32, or INT8 with per-token-per-head scale pools
(``cache.k_scale``/``cache.v_scale``): every write quantizes and every
paged attention dequantizes through the scales, in every branch
(llama.py:559, :610-628, :687-727). The whole-prompt prefill still attends
to its fresh, unquantized k/v; only its write is quantized. FP8 (e4m3)
pools take the same paged branches, the grouped engine's e4m3 ring pools,
sinks and the soft cap included (4ew, 4vew, 8ew, 6ek; 4es, 4ews, 4ves,
4vews, 8es, 8ews; 4ec, 4ewc, 4vec, 4vewc, 8ec, 8ewc), at Gemma's head_dim
256 too; and an e4m3 dense arena takes the dense branches of
:func:`forward` (12e, 6de, 13e with its window, capped and sink forms),
the prefill from slot 0 still attending its fresh rows.

Weights are plain tensors or :class:`~simplellminference_tpu_torch.ops.
linear.QuantizedWeight` leaves, INT8 or split-half INT4 with optional
zero points (``runtime.weights.quantize_params``,
``runtime.hf_quant.quantized_params_from_fetcher`` or
``models.convert.params_from_jax``). ``cfg.act_quant="int8"`` sends every
product but the LM head's through ``linear``'s W8A8 gate (prefill rows
over INT8 weights). With INT8 weights the JAX gates
pick the fused kernels (llama.py:583-632, :766-790): ``fused_qkv_append``
for decode with per-channel ``wqkv`` and ``fused_ffn`` for m = B*S <= 64
rows with per-channel ``w_gate_up``/``w_down``, prefill included. The
JAX package takes that route only on a TPU; the port takes it on any
device, and each wrapper runs its CUDA kernel or, for CPU tensors, its
plain version. The TPU's VMEM tiling gates (``qkv_tiles``, ``ffn_tiles``)
describe the TPU and are dropped.

DeepSeek's multi-head latent attention (``cfg.kv_lora_rank``,
:mod:`~simplellminference_tpu_torch.models.mla`) runs in every branch of
:func:`forward_paged` but the verify window, in both cache modes: absorbed
(the default: one latent row per token in a shared pool, ``cache.v`` None,
read by the shared forms 1l, 2l, 3l, 4l, 8l) and naive (per-head K/V padded
to ``cfg.head_dim``, the ordinary pools and forms). The dense arena under
MLA is not ported (:func:`forward` with a cache raises).

Params dict (the JAX package's names, layers stacked on a leading L):

    {"embed": [V, H],
     "layers": {"input_norm": [L, H], "post_norm": [L, H],
                "wqkv": [L, H, (N + 2*kvN) * D], "wo": [L, N*D, H],
                "w_gate_up": [L, H, 2*I], "w_down": [L, I, H],
                # Gemma-2 (sandwich_norms) only:
                "post_attn_norm": [L, H], "post_ffn_norm": [L, H]},
     "final_norm": [H],
     "lm_head": [H, V]}          # absent when tie_word_embeddings

MLA replaces ``wqkv`` with ``kv_a`` [L, H, dc + rope], ``kv_a_norm`` [L,
dc], ``kv_b`` [L, dc, N*(nope + vd)] and ``q_proj`` [L, H, N*(nope +
rope)] (or ``q_a`` [L, H, qr], ``q_a_norm`` [L, qr], ``q_b`` [L, qr,
N*(nope + rope)]), and ``wo`` is [L, N*vd, H].

A mixture-of-experts model (``cfg.num_experts``) folds its experts into
``w_gate_up`` [L, H, E * 2*Ie] and ``w_down`` [L, E * Ie, H] and adds
``router`` [L, H, E]; GPT-OSS adds ``router_bias`` [L, E],
``w_gate_up_bias`` [L, E * 2*Ie], ``w_down_bias`` [L, E, H],
``wqkv_bias`` [L, (N + 2*kvN) * D], ``wo_bias`` [L, H] and ``sinks``
[L, N].
"""

from __future__ import annotations

from typing import Any

import torch

from simplellminference_tpu_torch.core.config import ModelConfig
from simplellminference_tpu_torch.core.device import (resolve_device,
                                                      torch_dtype)
from simplellminference_tpu_torch.memory import paged_kv as pkv
from simplellminference_tpu_torch.models import mla
from simplellminference_tpu_torch.ops import (ffn_fused, moe, qkv_fused,
                                              ref_ops)
from simplellminference_tpu_torch.ops.attention import dispatch
from simplellminference_tpu_torch.ops.kv_append import kv_append
from simplellminference_tpu_torch.ops.linear import dot_f32, linear

Params = dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError naming the first feature of ``cfg`` that
    the port's decoder does not run yet."""
    unsupported = [
        ("first_k_dense", "dense-prefix layer group"),
        ("qk_norm", "q/k RMSNorm"),
        ("mlp_bias", "FFN biases"),
        ("nope_layers", "NoPE layers"),
        ("rope_local_theta", "local rope theta"),
        ("rope_interleaved", "interleaved rotary"),
    ]
    for field, name in unsupported:
        if getattr(cfg, field):
            raise NotImplementedError(name)
    if cfg.num_experts:
        if cfg.mla:
            raise NotImplementedError("routed experts under MLA (DeepSeek "
                                      "MoE)")
        moe.check_supported(cfg)
    if not cfg.pre_norms:
        raise NotImplementedError("post-norm-only blocks (OLMo-2)")
    if cfg.partial_rotary_factor != 1.0:
        raise NotImplementedError("partial rotary")
    if cfg.hidden_act not in ref_ops.GLU_ACTS:
        raise NotImplementedError(f"activation {cfg.hidden_act!r}")
    for field in ("residual_scale", "logit_scale"):
        if getattr(cfg, field) != 1.0:
            raise NotImplementedError(field)
    if cfg.act_quant not in (None, "int8"):
        # the JAX package asserts this in ops/linear.py:87
        raise ValueError(f"act_quant={cfg.act_quant!r} (only 'int8')")


def _fqkv_gate(cfg: ModelConfig, lw, b: int, s: int, cache_k) -> bool:
    """The JAX gate of the fused qkv route (llama.py:123-129, :583-594),
    TPU tiling aside: decode, plain pre-norm full rotary, per-channel INT8
    ``wqkv``."""
    return (s == 1 and "q_norm" not in lw and cfg.pre_norms
            and cfg.partial_rotary_factor == 1.0 and not cfg.rope_interleaved
            and qkv_fused.fused_qkv_available(lw, cfg, b, s, cache_k))


def _fffn_gate(cfg: ModelConfig, lw, m: int) -> bool:
    """The JAX gate of the fused FFN route (llama.py:278-284, :766-775)
    for ``m`` rows, TPU tiling aside; a mixture-of-experts model takes
    its MoE FFN before that gate (llama.py:266-273, :757-761)."""
    return (not cfg.num_experts and cfg.pre_norms
            and cfg.hidden_act == "silu"
            and "post_ffn_norm" not in lw and "w_gate_up_bias" not in lw
            and ffn_fused.fused_ffn_available(lw, cfg.hidden_size,
                                              cfg.intermediate_size, m))


def _qkv(cfg: ModelConfig, lw, li: int, x, sin, cos):
    """rmsnorm, the qkv product (+ the q/k/v bias, llama.py:657-658) and
    RoPE of layer ``li``: x [B, S, H] -> (q [B, S, N, D], k, v
    [B, S, kvN, D]). MLA (llama.py:637-650): the absorbed block's latent
    row is both k and v (one kv head of ``cfg.head_dim`` lanes), the naive
    block's per-head q/k/v come padded to ``cfg.head_dim``."""
    b, s = x.shape[:2]
    n, kvn, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = ref_ops.rmsnorm(x, lw["input_norm"][li], cfg.rms_norm_eps)
    if cfg.mla:
        if cfg.mla_absorbed:
            q, k = mla.mla_qkv_absorbed(cfg, lw, li, h, sin, cos,
                                        act_quant=cfg.act_quant)
            return q, k, k
        return mla.mla_qkv(cfg, lw, li, h, sin, cos, act_quant=cfg.act_quant)
    qkv = linear(h, lw["wqkv"], layer=li, act_quant=cfg.act_quant)
    if "wqkv_bias" in lw:
        qkv = qkv + lw["wqkv_bias"][li].to(qkv.dtype)
    q = qkv[..., :n * d].reshape(b, s, n, d)
    k = qkv[..., n * d:(n + kvn) * d].reshape(b, s, kvn, d)
    v = qkv[..., (n + kvn) * d:].reshape(b, s, kvn, d)
    return ref_ops.apply_rope(q, sin, cos), ref_ops.apply_rope(k, sin, cos), v


def _fused_qkv(cfg: ModelConfig, lw, li: int, x, sin, cos, ck, cv, offsets,
               **kw):
    """The fused qkv route for S = 1: q [B, N, D], k/v appended in place
    to the pools (``tables`` in ``kw``, and ``kv_layer`` for the grouped
    engine's pools) or to the dense arena."""
    w = lw["wqkv"]
    q1, *_ = qkv_fused.fused_qkv_append(
        x[:, 0], lw["input_norm"], w.q, w.scales, sin[:, 0], cos[:, 0], ck,
        cv, li, offsets, n_heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        eps=cfg.rms_norm_eps, **kw)
    return q1


def _post_attention(cfg: ModelConfig, lw, li: int, x, attn, use_fffn: bool):
    """wo projection (+ GPT-OSS's o bias, llama.py:256-257) + residual +
    FFN (llama.py:224-334, the plain pre-norm branch), with ``fused_ffn``
    under its gate, or the MoE FFN of a mixture-of-experts model
    (llama.py:266-273). Gemma-2's sandwich norms (llama.py:258-260,
    :328-330): ``post_attn_norm`` on the attention output and
    ``post_ffn_norm`` on the FFN's, each before its residual add
    (``post_ffn_norm`` closes the fused FFN's gate). MLA: the absorbed
    block's latent outputs expand through W_uv first, the naive block's
    drop v's pad lanes."""
    b, s, h = x.shape
    aq = cfg.act_quant
    if cfg.mla:   # llama.py:730-738
        attn = attn.reshape(b, s, cfg.num_heads, cfg.head_dim)
        attn = (mla.mla_unabsorb(cfg, lw, li, attn) if cfg.mla_absorbed
                else attn[..., :cfg.v_head_dim])
    attn = linear(attn.reshape(b, s, -1), lw["wo"], layer=li, act_quant=aq)
    if "wo_bias" in lw:
        attn = attn + lw["wo_bias"][li].to(attn.dtype)
    if "post_attn_norm" in lw:
        attn = ref_ops.rmsnorm(attn, lw["post_attn_norm"][li],
                               cfg.rms_norm_eps)
    x = x + attn
    if cfg.num_experts:
        hn = ref_ops.rmsnorm(x, lw["post_norm"][li], cfg.rms_norm_eps)
        return x + moe.moe_ffn(cfg, lw, li, hn)
    if use_fffn:
        gu, dn = lw["w_gate_up"], lw["w_down"]
        return ffn_fused.fused_ffn(
            x.reshape(b * s, h), lw["post_norm"], gu.q, gu.scales, dn.q,
            dn.scales, li, eps=cfg.rms_norm_eps).reshape(b, s, h)
    i_sz = cfg.intermediate_size
    hn = ref_ops.rmsnorm(x, lw["post_norm"][li], cfg.rms_norm_eps)
    gate_up = linear(hn, lw["w_gate_up"], layer=li, act_quant=aq)
    swi = ref_ops.glu_act(gate_up[..., :i_sz], gate_up[..., i_sz:],
                          cfg.hidden_act)
    down = linear(swi, lw["w_down"], layer=li, act_quant=aq)
    if "post_ffn_norm" in lw:
        down = ref_ops.rmsnorm(down, lw["post_ffn_norm"][li],
                               cfg.rms_norm_eps)
    return x + down


def _logits(cfg: ModelConfig, params: Params, x) -> torch.Tensor:
    """Final norm and LM head: f32 logits, soft-capped as
    cap * tanh(logits / cap) with Gemma-2's final_logit_softcap
    (llama.py:478-480, :908-910). The head takes no ``act_quant``
    (llama.py:475, :905)."""
    x = ref_ops.rmsnorm(x, params["final_norm"], cfg.rms_norm_eps)
    lm_head = params.get("lm_head")
    if lm_head is None:
        # tied head: the f32 accumulator, as jnp.dot(...,
        # preferred_element_type=float32) at llama.py:472-473, :902-903
        logits = dot_f32(x, params["embed"].t()).float()
    else:
        logits = linear(x, lm_head, out_dtype=torch.float32).float()
    cap = cfg.final_logit_softcap
    if cap:
        logits = cap * torch.tanh(logits / cap)
    return logits


def _embed(cfg: ModelConfig, params: Params, tokens, positions):
    """Embedding rows in the activation dtype, times Gemma's embed_scale
    rounded to that dtype first (llama.py:365-366, :545-546: in bf16
    sqrt(2048) multiplies as 45.25), and the rope tables."""
    dtype = torch_dtype(cfg.dtype)
    x = params["embed"][tokens.long()].to(dtype)
    if cfg.embed_scale != 1.0:
        # the rounded scale as a Python number: no host-to-device copy
        x = x * float(torch.tensor(cfg.embed_scale, dtype=dtype))
    _period, wins, nope = cfg.scan_pattern()
    sin, cos = ref_ops.rope_tables_by_sublayer(cfg, positions, wins,
                                               nope)[0]
    return x, sin, cos


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            positions: torch.Tensor, cache=None,
            offsets: torch.Tensor | None = None,
            kv_lens: torch.Tensor | None = None,
            prefill_from_zero: bool = True, last_token_only: bool = False):
    """Forward pass over the dense KV arena (the Generator's and the
    draft model's path; counterpart of llama.py:342-481).

    tokens/positions: [B, S]; cache: :class:`~simplellminference_tpu_torch.
    runtime.kv_cache.DenseKVCache` (updated in place; its arena may have
    more rows than B, row b serving sequence b) or None. ``offsets[b]``:
    the arena slot of sequence b's first new token (default
    positions[:, 0]); ``kv_lens[b]``: valid slots after this step (default
    offsets + S).
    - ``cache=None``: causal self-attention over the tokens, no cache.
    - S > 1 with ``prefill_from_zero``: ``kv_append`` at the offsets, then
      causal attention on the fresh k/v (llama.py:207-211).
    - S = 1: with per-channel INT8 ``wqkv`` the dense ``fused_qkv_append``,
      else the qkv product, RoPE and ``kv_append``; then ``flash_decode``.
    S > 1 with ``prefill_from_zero=False`` (a multi-token continuation,
    which the JAX package runs through its jnp reference even on a TPU)
    is not ported and raises. ``last_token_only``: project only slot
    kv_lens - 1 - offsets of each sequence (S - 1 without kv_lens).
    Each layer attends with its own window (``cfg.layer_windows``: the
    window forms 3w and 13w on sliding layers) and the soft cap, as
    :func:`forward_paged` does. Returns (logits [B, S or 1, V] f32,
    cache)."""
    check_supported(cfg)
    b, s = tokens.shape
    if cache is not None and cfg.mla:
        raise NotImplementedError("MLA on the dense arena (the Generator, "
                                  "draft models)")
    if cache is not None and s > 1 and not prefill_from_zero:
        raise NotImplementedError("dense multi-token continuation (S > 1 "
                                  "with prefill_from_zero=False)")
    x, sin, cos = _embed(cfg, params, tokens, positions)
    lw = params["layers"]
    use_fqkv = False
    if cache is not None:
        ck, cv = cache.k, cache.v
        if offsets is None:
            offsets = positions[:, 0]
        if kv_lens is None:
            kv_lens = offsets + s
        use_fqkv = _fqkv_gate(cfg, lw, b, s, ck)
    use_fffn = _fffn_gate(cfg, lw, b * s)
    for li, window in enumerate(cfg.layer_windows):
        sinks = _sinks(lw, li)
        if use_fqkv:
            q1 = _fused_qkv(cfg, lw, li, x, sin, cos, ck, cv, offsets)
            attn = dispatch.attention_cached(cfg, q1[:, None], ck, cv,
                                             kv_lens, li, window=window,
                                             sinks=sinks)
        else:
            q, k, v = _qkv(cfg, lw, li, x, sin, cos)
            if cache is not None:
                kv_append(ck, cv, k, v, li, offsets)
            if cache is None or s > 1:
                # no cache, or a prefill from slot 0: the fresh k/v are
                # the whole prefix
                attn = dispatch.attention(cfg, q, k, v, window=window,
                                          sinks=sinks)
            else:
                attn = dispatch.attention_cached(cfg, q, ck, cv, kv_lens,
                                                 li, window=window,
                                                 sinks=sinks)
        x = _post_attention(cfg, lw, li, x, attn, use_fffn)
    if last_token_only and s > 1:
        if kv_lens is None:
            last = torch.full((b,), s - 1, device=x.device)
        else:
            last = kv_lens.long() - 1
            if offsets is not None:
                last = last - offsets.long()
        x = x[torch.arange(b, device=x.device), last.to(x.device)][:, None]
    return _logits(cfg, params, x), cache


def forward_paged(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  positions: torch.Tensor, cache, tables: torch.Tensor,
                  kv_lens: torch.Tensor, prefill: bool,
                  last_token_only: bool = False,
                  chunk_offset: torch.Tensor | None = None):
    """Forward pass over the paged KV cache (engine path).

    tokens/positions: [B, S]; cache: :class:`PagedKVCache` (updated in
    place); tables: [B, MP] page ids (-1 unmapped); kv_lens: [B] valid
    tokens AFTER this step. ``prefill``: S-token whole-prompt pass from
    position 0 (right-padded), attention is causal self-attention on the
    fresh k/v; otherwise decode through the page tables: S == 1, or a
    speculative verify window of S <= 8 tokens at positions[b, 0] + 0..S-1
    with kv_lens = positions[:, 0] + S (row s attends the keys up to its
    own position).
    ``chunk_offset`` ([B], page-aligned, with ``prefill``): chunked
    prefill — row b processes prompt tokens [chunk_offset[b],
    chunk_offset[b] + S), writes their pages and attends through the page
    tables to every cached position < kv_lens[b] up to its own.
    ``last_token_only``: project only row b's position kv_lens[b]-1
    through the LM head.

    Sliding windows (``cfg.sliding_window``, per layer with
    ``layer_types``) go to the attention kernels' window forms. The
    grouped engine (llama.py:515-530, :826-848) passes ``tables`` as a
    (full tables, ring tables) pair with a cache carrying the windowed
    group's pools (``cache.k_w``): sliding layers read and write those
    through the ring tables at group-local layer indices, full layers the
    main pools likewise; the weights keep the global index.
    Returns (logits [B, S or 1, V] f32, cache)."""
    check_supported(cfg)
    if isinstance(tables, (tuple, list)):
        tables, tables_w = tables
    else:
        tables_w = None
    grouped = tables_w is not None
    if grouped != (cache.k_w is not None):
        raise ValueError("a windowed-group cache needs (full, ring) tables, "
                         "and the other way round")
    b, s = tokens.shape
    chunked = prefill and chunk_offset is not None
    spec = not prefill and s > 1   # speculative-decoding verify window
    if spec and cfg.mla:
        raise NotImplementedError("the verify window under MLA (speculative "
                                  "decoding over latent pools)")
    x, sin, cos = _embed(cfg, params, tokens, positions)
    lw = params["layers"]
    page_offset = chunk_offset // cache.page_size if chunked else None
    use_fqkv = not prefill and _fqkv_gate(cfg, lw, b, s, cache.k)
    use_fffn = _fffn_gate(cfg, lw, b * s)
    n_group = {True: 0, False: 0}   # layers seen so far per pool group
    for li, window in enumerate(cfg.layer_windows):
        # the pools, tables and pool layer of this layer's group
        sliding = grouped and window is not None
        if sliding:
            pk, pv, tbl = cache.k_w, cache.v_w, tables_w
            pks, pvs = cache.k_w_scale, cache.v_w_scale
        else:
            pk, pv, tbl = cache.k, cache.v, tables
            pks, pvs = cache.k_scale, cache.v_scale   # None unless INT8 KV
        kli = n_group[sliding] if grouped else li
        n_group[sliding] += 1
        scales = dict(pool_ks=pks, pool_vs=pvs)
        sinks = _sinks(lw, li)
        if use_fqkv:
            q1 = _fused_qkv(cfg, lw, li, x, sin, cos, pk, pv,
                            positions[:, 0], tables=tbl, cache_ks=pks,
                            cache_vs=pvs, kv_layer=kli if grouped else None)
            attn = dispatch.attention_paged(cfg, q1[:, None], pk, pv, tbl,
                                            kv_lens, kli, window=window,
                                            sinks=sinks, **scales)
        else:
            q, k, v = _qkv(cfg, lw, li, x, sin, cos)
            if chunked:
                pkv.write_prefill_stacked(pk, pv, k, v, tbl, kli,
                                          page_offset=page_offset, **scales)
                attn = dispatch.attention_paged_prefill(
                    cfg, q, pk, pv, tbl, kv_lens, chunk_offset, kli,
                    window=window, sinks=sinks, **scales)
            elif prefill:
                pkv.write_prefill_stacked(pk, pv, k, v, tbl, kli, **scales)
                attn = dispatch.attention(cfg, q, k, v, window=window,
                                          sinks=sinks)
            elif spec:
                pkv.write_span_stacked(pk, pv, k, v, tbl, positions[:, 0],
                                       kli, **scales)
                attn = dispatch.attention_paged(cfg, q, pk, pv, tbl, kv_lens,
                                                kli, window=window,
                                                sinks=sinks, **scales)
            else:
                pkv.write_decode_stacked(pk, pv, k[:, 0], v[:, 0], tbl,
                                         positions[:, 0], kli, **scales)
                attn = dispatch.attention_paged(cfg, q, pk, pv, tbl, kv_lens,
                                                kli, window=window,
                                                sinks=sinks, **scales)
        x = _post_attention(cfg, lw, li, x, attn, use_fffn)

    if last_token_only and s > 1:
        # the last valid slot kv_len-1 (absolute) as a chunk-local index
        idx = kv_lens.long() - 1
        if chunked:
            idx = idx - chunk_offset.long()
        idx = idx.to(x.device)
        x = x[torch.arange(b, device=x.device), idx][:, None]
    return _logits(cfg, params, x), cache


def _sinks(lw, li: int):
    """Layer ``li``'s attention-sink logits [N] (GPT-OSS), or None."""
    return lw["sinks"][li] if "sinks" in lw else None


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                dtype=None) -> Params:
    """Random-init params from a seeded ``torch.Generator`` on ``device``
    (CUDA unless ``device="cpu"``), with the JAX package's names and
    scales: N(0, 1) * K**-0.5 for [.., K, N] weights (Ie**-0.5 for the
    folded experts' ``w_down``), * 0.02 for the embedding, the LM head,
    the router and every bias, * 1 for the sinks, ones for the norms
    (llama.py:914-995). Every leaf is drawn on ``device``. The values
    differ from the JAX package's draw (threefry vs Philox/MT); tests
    carry JAX weights over with :func:`~simplellminference_tpu_torch.
    models.convert.params_from_jax` instead."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    n, kvn, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L = cfg.num_layers

    def w(shape, scale=None):
        scale = scale or shape[-2] ** -0.5
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=dtype).mul_(scale)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    params: Params = {
        "embed": w((v, h), 0.02),
        "layers": {
            "input_norm": ones((L, h)),
            "post_norm": ones((L, h)),
        },
        "final_norm": ones((h,)),
    }
    lw = params["layers"]
    if cfg.mla:   # DeepSeek MLA's projections (llama.py:950-966)
        qk = cfg.qk_head_dim
        lw["kv_a"] = w((L, h, cfg.kv_lora_rank + cfg.qk_rope_head_dim))
        lw["kv_a_norm"] = ones((L, cfg.kv_lora_rank))
        lw["kv_b"] = w((L, cfg.kv_lora_rank,
                        n * (cfg.qk_nope_head_dim + cfg.v_head_dim)))
        lw["wo"] = w((L, n * cfg.v_head_dim, h))
        if cfg.q_lora_rank:
            lw["q_a"] = w((L, h, cfg.q_lora_rank))
            lw["q_a_norm"] = ones((L, cfg.q_lora_rank))
            lw["q_b"] = w((L, cfg.q_lora_rank, n * qk))
        else:
            lw["q_proj"] = w((L, h, n * qk))
    else:
        lw["wqkv"] = w((L, h, (n + 2 * kvn) * d))
        lw["wo"] = w((L, n * d, h))
    if cfg.num_experts:   # folded experts (ops/moe.py) and the router
        e, ie = cfg.num_experts, cfg.expert_intermediate_size
        lw["router"] = w((L, h, e), 0.02)
        lw["w_gate_up"] = w((L, h, e * 2 * ie))
        lw["w_down"] = w((L, e * ie, h), ie ** -0.5)
        if cfg.moe_bias:   # GPT-OSS: the router's and the experts' biases
            lw["router_bias"] = w((L, e), 0.02)
            lw["w_gate_up_bias"] = w((L, e * 2 * ie), 0.02)
            lw["w_down_bias"] = w((L, e, h), 0.02)
    else:
        lw["w_gate_up"] = w((L, h, 2 * i))
        lw["w_down"] = w((L, i, h))
    if cfg.attention_bias:
        lw["wqkv_bias"] = w((L, (n + 2 * kvn) * d), 0.02)
    if cfg.attn_sinks:   # GPT-OSS's attention-sink logits, held in f32
        lw["sinks"] = w((L, n), 1.0).float()   # as the kernels take them
    if cfg.o_bias:
        lw["wo_bias"] = w((L, h), 0.02)
    if cfg.sandwich_norms:   # Gemma-2's pre-residual output norms
        params["layers"]["post_attn_norm"] = ones((L, h))
        params["layers"]["post_ffn_norm"] = ones((L, h))
    if not cfg.tie_word_embeddings:
        params["lm_head"] = w((h, v), 0.02)
    return params
