"""Sparse mixture-of-experts FFN (top-k routing) over folded expert weights.

Counterpart of simplellminference_tpu/ops/moe.py, with its layout: the
experts of a layer are folded into the dense FFN's stacked shapes,

    w_gate_up  [L, H, E * 2*Ie]   (per-expert [gate_e | up_e] column blocks)
    w_down     [L, E * Ie, H]     (per-expert row blocks)
    router     [L, H, E]          (never quantized; routed in f32)

plus GPT-OSS's biases (``router_bias`` [L, E], ``w_gate_up_bias``
[L, E * 2*Ie], ``w_down_bias`` [L, E, H]). Two forms, as in the JAX
package:

- :func:`moe_ffn` for one row a sequence (decode): one product over
  every expert's gate/up, the activation, the router's gates zeroing the
  unselected experts, one product over every expert's down rows (the
  JAX folded route, moe.py:251-302). Decode is bound by the weight
  bytes, and batch x top-k draws over E experts read nearly every expert
  anyway. The products go through :func:`~simplellminference_tpu_torch.
  ops.linear.linear`: INT8 weights to kernel 5 (its few-rows regime at
  M <= 8), bf16 ones to ``torch.matmul`` as the JAX package leaves them
  to XLA. Nothing reads the device from the host, so a CUDA-graph
  capture of the decode step holds it.
- :func:`moe_ffn_grouped` for S > 1 rows (prefill, verify windows): the
  (token, expert) assignments sorted by expert and one product per
  expert's group of rows (moe.py:173-249). JAX's ``jax.lax.ragged_dot``
  is XLA's grouped product, outside any Pallas kernel. While padding
  every group to the largest at most doubles the rows (give or take
  ``PAD_SLACK`` rows an expert, the spread of even routing over short
  chunks), the products are one ``torch.bmm`` over the experts (the
  padding rows are zeros and are dropped), and past that (a skewed
  router) one product per expert's rows, each with an f32 result. One
  batched product costs the host far less than 2E launches; the bound
  keeps its memory and work near twice T*k rows. Where the bound holds
  for the worst case, every group padded to T rows (no expert gets more:
  a token's k experts are distinct), :func:`pads_to_tokens` says so from
  the shapes alone and the groups are padded to T with nothing read on
  the host: a speculative verify step (gpt-oss-20b: 8 x 5 rows, T 40 <=
  42) runs with no host sync and can be captured in a CUDA graph.
  Otherwise the group sizes are read to the host once a layer (longer
  prefills). INT8 experts are dequantized one layer at a time
  (``_dense_layer_weight``, moe.py:150-171).

The router (moe.py:49-128) takes the softmax route: softmax over all
experts in f32, the top k kept in ``jax.lax.top_k``'s order (a lower
expert index first among equal probabilities), renormalized with
``norm_topk``. GPT-OSS's router bias is a linear bias on the logits
(top-k over the biased logits with a softmax over the k, which is the
same). DeepSeek's sigmoid and grouped routing, Qwen2-MoE's shared
experts, a dense-prefix layer group (``first_k_dense``) and
tensor-parallel experts raise NotImplementedError naming them.
"""

from __future__ import annotations

import torch

from simplellminference_tpu_torch.core.config import ModelConfig
from simplellminference_tpu_torch.ops import ref_ops
from simplellminference_tpu_torch.ops.linear import (QuantizedWeight,
                                                     bmm_f32, dot_f32,
                                                     linear)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError naming the first MoE feature of ``cfg``
    the port does not serve."""
    if cfg.router_score_fn != "softmax":
        raise NotImplementedError(
            f"{cfg.router_score_fn} routing (DeepSeek-V3)")
    if cfg.router_n_group > 1:
        raise NotImplementedError("grouped routing (DeepSeek-V2)")
    if cfg.shared_expert_intermediate_size:
        raise NotImplementedError("shared experts (Qwen2-MoE)")
    if cfg.first_k_dense:
        raise NotImplementedError("first_k_dense (a dense-prefix layer "
                                  "group)")


# Rows an expert that padding may add beyond doubling the rows: even
# routing over a short chunk (8 rows an expert at 64 tokens, top 4 of 32)
# spreads its largest group to about twice the mean, and padding those few
# rows costs less than 2E launches of one product an expert.
PAD_SLACK = 32


def pads_to_tokens(t: int, e: int, k: int) -> bool:
    """True when T = ``t`` tokens' k-of-``e`` routing can take the padded
    product with every expert's group padded to T rows, the most any
    group can hold, within the padding bound ``e * cap <= 2 * t * k +
    PAD_SLACK * e``: a pure function of shapes, so the grouped route
    reads nothing on the host (gpt-oss-20b, 32 experts with top 4: T <=
    42, a verify step of 8 x 5 rows included)."""
    return e * t <= 2 * t * k + PAD_SLACK * e


def _stable_topk(p: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, equal
    values in ``jax.lax.top_k``'s order: the lower index first (a stable
    descending sort; ``torch.topk`` does not promise an order for ties)."""
    vals, idx = torch.sort(p, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_topk(x: torch.Tensor, w_router: torch.Tensor, top_k: int,
                norm_topk: bool = True, scaling: float = 1.0,
                bias: torch.Tensor | None = None):
    """Top-k routing of x [T, H] over w_router [H, E]: (probs [T, k] f32,
    expert ids [T, k] int64). Softmax over all experts of the f32 logits
    (plus ``bias``, GPT-OSS's router bias), the k largest, renormalized to
    sum to 1 with ``norm_topk``, times ``scaling``."""
    logits = torch.matmul(x.float(), w_router.float())
    if bias is not None:
        logits = logits + bias.float()[None]
    probs = torch.softmax(logits, dim=-1)
    topv, topi = _stable_topk(probs, min(top_k, probs.shape[-1]))
    if norm_topk:
        topv = topv / topv.sum(dim=-1, keepdim=True)
    if scaling != 1.0:
        topv = topv * scaling
    return topv, topi


def router_probs(x: torch.Tensor, w_router: torch.Tensor, top_k: int,
                 norm_topk: bool = True, scaling: float = 1.0,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """The dense gate matrix [T, E] f32: each token's top-k router probs
    at their experts, zero elsewhere (the folded route's gates)."""
    topv, topi = router_topk(x, w_router, top_k, norm_topk, scaling, bias)
    gates = torch.zeros((x.shape[0], w_router.shape[-1]),
                        dtype=torch.float32, device=x.device)
    return gates.scatter_(1, topi, topv)


def _router_bias(lw: dict, li: int):
    """Layer ``li``'s router bias (GPT-OSS), or None."""
    bias = lw.get("router_bias")
    return None if bias is None else bias[li]


def _dense_layer_weight(w, li: int, dtype) -> torch.Tensor:
    """Layer ``li`` of a stacked expert weight as a dense tensor of
    ``dtype``, dequantized from INT8 (or INT4) in f32 first."""
    if isinstance(w, QuantizedWeight):
        one = QuantizedWeight(q=w.q[li], scales=w.scales[li], bits=w.bits,
                              zs=None if w.zs is None else w.zs[li])
        return one.dequantize(torch.float32).to(dtype)
    return w[li].to(dtype)


def moe_ffn_grouped(cfg: ModelConfig, lw: dict, li: int,
                    x: torch.Tensor) -> torch.Tensor:
    """The grouped MoE FFN of layer ``li`` (prefill, verify windows):
    x [B, S, H] (already normed) -> [B, S, H]. The T*k assignments sort by
    expert (stable), each expert's rows go through its gate/up and down
    blocks with f32 results (one batched product with each group padded to
    the largest while that at most doubles the rows, give or take
    ``PAD_SLACK`` rows an expert, else one product per expert: the work
    stays within that bound whatever the router's skew; padded to T with
    no host read where :func:`pads_to_tokens`), the biases ride each
    assignment (the down bias weighted by its gate), and the weighted
    rows add back to their tokens in f32."""
    check_supported(cfg)
    b, s, h = x.shape
    e, ie = cfg.num_experts, cfg.expert_intermediate_size
    t = b * s
    xf = x.reshape(t, h)
    topv, topi = router_topk(xf, lw["router"][li], cfg.num_experts_per_tok,
                             cfg.norm_topk_prob, cfg.routed_scaling_factor,
                             _router_bias(lw, li))
    k = topi.shape[-1]
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    tok = (torch.arange(t * k, device=x.device) // k)[order]
    row_e = flat_e[order]
    g_row = topv.reshape(-1)[order]
    xg = xf[tok]
    padded = pads_to_tokens(t, e, k)
    if padded:
        cap = t       # every group padded to T rows, its most: no host read
    else:
        counts = torch.bincount(flat_e, minlength=e).tolist()  # host read
        cap = max(counts)
        padded = e * cap <= 2 * t * k + PAD_SLACK * e
    if padded:
        # groups even enough: one batched product over the experts, each
        # group padded with zero rows to ``cap`` (the padding dropped); a
        # row's slot in its group from the sorted experts' first rows
        starts = torch.searchsorted(row_e, torch.arange(e, device=x.device))
        slot = (row_e * cap + torch.arange(t * k, device=x.device)
                - starts[row_e])

        def grouped(rows, w):
            """rows [T*k, K] sorted by expert through w [E, K, N]:
            [T*k, N] f32."""
            buf = rows.new_zeros((e * cap, rows.shape[1]))
            buf[slot] = rows
            out = bmm_f32(buf.view(e, cap, -1), w)
            return out.view(e * cap, -1)[slot]
    else:
        # a skewed router: padding would more than double the rows, so
        # one product per expert that has rows (2E launches)

        def grouped(rows, w):
            """rows [T*k, K] sorted by expert through w [E, K, N]:
            [T*k, N] f32."""
            outs, lo = [], 0
            for ei, n in enumerate(counts):
                if n:
                    outs.append(dot_f32(rows[lo:lo + n], w[ei]))
                    lo += n
            return torch.cat(outs)

    wgu = _dense_layer_weight(lw["w_gate_up"], li, xf.dtype).reshape(
        h, e, 2 * ie).transpose(0, 1)                        # [E, H, 2Ie]
    wd = _dense_layer_weight(lw["w_down"], li, xf.dtype).reshape(e, ie, h)
    gu = grouped(xg, wgu)
    if cfg.moe_bias:
        bgu = lw["w_gate_up_bias"][li].reshape(e, 2 * ie)
        gu = gu + bgu[row_e].float()
    act = ref_ops.glu_act(gu[:, :ie], gu[:, ie:], cfg.hidden_act)
    act = (act * g_row[:, None]).to(xf.dtype)
    yg = grouped(act, wd)
    if cfg.moe_bias:
        bd = lw["w_down_bias"][li]                               # [E, H]
        yg = yg + g_row[:, None] * bd[row_e].float()
    y = torch.zeros((t, h), dtype=torch.float32, device=x.device)
    y.index_add_(0, tok, yg)
    return y.reshape(b, s, h).to(x.dtype)


def moe_ffn(cfg: ModelConfig, lw: dict, li: int,
            x: torch.Tensor, tp_axis=None) -> torch.Tensor:
    """The MoE FFN of layer ``li`` on the (already normed) x [B, S, H] ->
    [B, S, H]: the folded route for S == 1, :func:`moe_ffn_grouped` for
    S > 1, as the JAX package routes them. ``tp_axis`` (experts sharded
    over a mesh) raises."""
    if tp_axis is not None:
        raise NotImplementedError("tensor-parallel experts (tp_axis)")
    check_supported(cfg)
    b, s, h = x.shape
    if s > 1:
        return moe_ffn_grouped(cfg, lw, li, x)
    e, ie = cfg.num_experts, cfg.expert_intermediate_size
    t = b * s
    xf = x.reshape(t, h)
    gates = router_probs(xf, lw["router"][li], cfg.num_experts_per_tok,
                         cfg.norm_topk_prob, cfg.routed_scaling_factor,
                         _router_bias(lw, li))                    # [T, E]
    gu = linear(xf, lw["w_gate_up"], layer=li)               # [T, E*2Ie]
    if cfg.moe_bias:
        gu = gu + lw["w_gate_up_bias"][li][None].to(gu.dtype)
    gu = gu.reshape(t, e, 2 * ie)
    act = ref_ops.glu_act(gu[..., :ie], gu[..., ie:], cfg.hidden_act)
    act = act * gates[..., None].to(act.dtype)             # zero unselected
    y = linear(act.reshape(t, e * ie), lw["w_down"], layer=li)
    if cfg.moe_bias:
        # each selected expert's down bias, weighted by its gate
        y = y + torch.matmul(gates, lw["w_down_bias"][li].float()).to(
            y.dtype)
    return y.reshape(b, s, h)
