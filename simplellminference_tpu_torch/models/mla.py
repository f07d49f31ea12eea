"""Multi-head Latent Attention (DeepSeek-V2/V3): the QKV block and the
value expansion after attention.

Counterpart of simplellminference_tpu/models/mla.py. A single ``kv_a``
projection emits [kv_lora_rank | qk_rope_head_dim]: the latent half is
RMSNorm'd, the rope half becomes ONE roped key shared by every head.
Queries come from ``q_proj``, or from the low-rank path q_a -> norm ->
q_b. DeepSeek's RoPE is interleaved (:func:`~simplellminference_tpu_torch.
ops.ref_ops.apply_rope_interleaved`), over tables of qk_rope_head_dim
(``ref_ops.rope_tables_for``).

Two cache modes, as in the JAX package:

* naive (:func:`mla_qkv`): per-head K/V from ``kv_b``, q/k/v zero-padded
  to the cache lane dim ``cfg.head_dim`` (256 for DeepSeek-V2-Lite), so
  the ordinary pools and kernels serve them; zero key lanes add nothing to
  a score, zero value lanes give columns the caller drops.
* absorbed (:func:`mla_qkv_absorbed` + :func:`mla_unabsorb`, the default):
  the cache holds one row per token, [rmsnorm(c_kv) | roped shared key |
  0-pad] of ``cfg.head_dim`` lanes (640 for DeepSeek-V2-Lite), one kv head
  whose row is both key and value (a shared pool, ``cache.v is None``).
  The key half of ``kv_b`` folds into the query (q' = [q_nope W_uk | q_pe]:
  q'.row = q.k by associativity), its value half expands the attention
  output afterwards (W_uv).

The two ``kv_b`` products run in f32 and are cast to the activation dtype
after, the JAX package's rounding order (mla.py:104-106, :128-130). The
projections are :func:`~simplellminference_tpu_torch.ops.linear.linear`
(``torch.matmul`` for float weights, as the JAX package leaves them to
XLA). The true score scale, (nope + rope)^-0.5, rides in
``cfg.query_pre_attn_scalar``.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from simplellminference_tpu_torch.core.config import ModelConfig
from simplellminference_tpu_torch.ops import ref_ops
from simplellminference_tpu_torch.ops.linear import linear
from simplellminference_tpu_torch.ops.moe import _dense_layer_weight

Params = dict[str, Any]


def _dense_kv_b(cfg: ModelConfig, lw: Params, li: int, dtype,
                n: int) -> torch.Tensor:
    """Layer ``li``'s kv_b as a dense [dc, n, nope + vd] tensor of
    ``dtype`` (dequantized in f32 first for a quantized leaf)."""
    w = _dense_layer_weight(lw["kv_b"], li, dtype)   # [dc, n*(nope+vd)]
    return w.reshape(cfg.kv_lora_rank, n,
                     cfg.qk_nope_head_dim + cfg.v_head_dim)


def _q_proj(cfg: ModelConfig, lw: Params, li: int, attn_in, act_quant):
    """The queries [B, S, n * (nope + rope)]: q_proj, or q_a -> RMSNorm ->
    q_b."""
    if "q_a" in lw:
        qa = linear(attn_in, lw["q_a"], layer=li, act_quant=act_quant)
        qa = ref_ops.rmsnorm(qa, lw["q_a_norm"][li], cfg.rms_norm_eps)
        return linear(qa, lw["q_b"], layer=li, act_quant=act_quant)
    return linear(attn_in, lw["q_proj"], layer=li, act_quant=act_quant)


def _latent(cfg: ModelConfig, lw: Params, li: int, attn_in, sin, cos,
            act_quant):
    """(rmsnorm(c_kv) [B, S, dc], the roped shared key [B, S, 1, rope])."""
    dc = cfg.kv_lora_rank
    ckv = linear(attn_in, lw["kv_a"], layer=li, act_quant=act_quant)
    c = ref_ops.rmsnorm(ckv[..., :dc], lw["kv_a_norm"][li], cfg.rms_norm_eps)
    k_pe = ref_ops.apply_rope_interleaved(ckv[..., None, dc:], sin, cos)
    return c, k_pe


def mla_qkv_absorbed(cfg: ModelConfig, lw: Params, li: int, attn_in,
                     sin, cos, act_quant=None):
    """Absorbed MLA: attn_in [B, S, H] (already normed), sin/cos [B, S,
    rope/2] -> (q' [B, S, N, Dl], kv_row [B, S, 1, Dl]), Dl =
    ``cfg.head_dim``: q' = [q_nope @ W_uk | roped q_pe | 0],
    kv_row = [rmsnorm(c_kv) | roped shared key | 0] (mla.py:72-118)."""
    b, s, _ = attn_in.shape
    n = cfg.num_heads
    nope, rd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dc, dl = cfg.kv_lora_rank, cfg.head_dim
    q = _q_proj(cfg, lw, li, attn_in, act_quant).reshape(b, s, n, nope + rd)
    c, k_pe = _latent(cfg, lw, li, attn_in, sin, cos, act_quant)
    w_kv = _dense_kv_b(cfg, lw, li, torch.float32, n)   # [dc, n, nope+vd]
    q_lat = torch.einsum("bsnp,dnp->bsnd", q[..., :nope].float(),
                         w_kv[..., :nope]).to(q.dtype)   # [B, S, n, dc]
    q_pe = ref_ops.apply_rope_interleaved(q[..., nope:], sin, cos)
    qp = torch.cat([q_lat, q_pe], dim=-1)
    kv_row = torch.cat([c[:, :, None, :], k_pe], dim=-1)
    if dc + rd < dl:
        qp = F.pad(qp, (0, dl - dc - rd))
        kv_row = F.pad(kv_row, (0, dl - dc - rd))
    return qp, kv_row


def mla_unabsorb(cfg: ModelConfig, lw: Params, li: int,
                 attn: torch.Tensor) -> torch.Tensor:
    """attn [B, S, n, Dl] (probabilities times latent rows) -> values
    [B, S, n, vd] through the per-head W_uv half of kv_b, in f32
    (mla.py:121-130)."""
    w_kv = _dense_kv_b(cfg, lw, li, torch.float32, attn.shape[2])
    out_lat = attn[..., :cfg.kv_lora_rank].float()
    return torch.einsum("bsnd,dnv->bsnv", out_lat,
                        w_kv[..., cfg.qk_nope_head_dim:]).to(attn.dtype)


def mla_qkv(cfg: ModelConfig, lw: Params, li: int, attn_in, sin, cos,
            act_quant=None):
    """Naive MLA: attn_in [B, S, H] (already normed), sin/cos [B, S,
    rope/2] -> (q, k, v) [B, S, N, D] zero-padded to D = ``cfg.head_dim``:
    per-head keys [k_nope | the shared roped key], values from kv_b
    (mla.py:133-179)."""
    b, s, _ = attn_in.shape
    n = cfg.num_heads
    nope, rd, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                    cfg.v_head_dim)
    dpad = cfg.head_dim
    q = _q_proj(cfg, lw, li, attn_in, act_quant).reshape(b, s, n, nope + rd)
    c, k_pe = _latent(cfg, lw, li, attn_in, sin, cos, act_quant)
    kv = linear(c, lw["kv_b"], layer=li, act_quant=act_quant)
    kv = kv.reshape(b, s, n, nope + vd)
    q_pe = ref_ops.apply_rope_interleaved(q[..., nope:], sin, cos)
    q = torch.cat([q[..., :nope], q_pe], dim=-1)
    k = torch.cat([kv[..., :nope], k_pe.expand(b, s, n, rd)], dim=-1)
    v = kv[..., nope:]
    if nope + rd < dpad:
        q = F.pad(q, (0, dpad - nope - rd))
        k = F.pad(k, (0, dpad - nope - rd))
    if vd < dpad:
        v = F.pad(v, (0, dpad - vd))
    return q, k, v
