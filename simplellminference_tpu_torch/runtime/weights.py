"""Post-hoc weight quantization of a params dict, and the HF name map.

Counterpart of simplellminference_tpu/runtime/weights.py:375
(``quantize_params``) with ``_maybe_quantize`` (:235, INT8 and split-half
INT4) and ``_QUANTIZABLE`` (:58), and of the Llama name map the AWQ/GPTQ
import reads (:28 ``_HF_LLAMA_MAP``, :45 ``_TRANSPOSED``, :53
``_ROW_CONCAT``, :74 ``llama_hf_param_map``, :228 ``_set_path``) for the
dense Llama graph; the other families' branches raise. The checkpoint
loaders of that module are not ported yet. ``canonicalize_layouts``
(:353) has no counterpart: it pins XLA's device layouts to row-major for
the Pallas calls, and the port's tensors are row-major already.
"""

from __future__ import annotations

import math
from typing import Any

from simplellminference_tpu_torch.core.config import ModelConfig, QuantConfig
from simplellminference_tpu_torch.ops.linear import QuantizedWeight

# Param-tree paths use "/" notation. A tuple of HF names means: load each,
# transpose to [K, N], and concatenate along the output (N) axis.
_HF_LLAMA_MAP: dict[str, Any] = {
    "embed": "model.embed_tokens.weight",            # [V, H] (no transpose)
    "final_norm": "model.norm.weight",
    "lm_head": "lm_head.weight",                     # [V, H] -> transpose
    "layers/input_norm": "model.layers.{i}.input_layernorm.weight",
    "layers/post_norm": "model.layers.{i}.post_attention_layernorm.weight",
    "layers/wqkv": ("model.layers.{i}.self_attn.q_proj.weight",
                    "model.layers.{i}.self_attn.k_proj.weight",
                    "model.layers.{i}.self_attn.v_proj.weight"),
    "layers/wo": "model.layers.{i}.self_attn.o_proj.weight",
    "layers/w_gate_up": ("model.layers.{i}.mlp.gate_proj.weight",
                         "model.layers.{i}.mlp.up_proj.weight"),
    "layers/w_down": "model.layers.{i}.mlp.down_proj.weight",
}

# HF Linear weights are [out, in]; the port's are [in, out]: every
# projection matrix is transposed. Embedding and norms keep HF orientation.
# (The other families' projections join this set with their maps.)
_TRANSPOSED = {"lm_head", "layers/wqkv", "layers/wo", "layers/w_gate_up",
               "layers/w_down"}

# Tuple entries of these paths concatenate along the contraction (row)
# axis after the transpose (per-expert w_down blocks stack rows).
_ROW_CONCAT = {"layers/w_down"}

# Paths eligible for weight-only quantization (the JAX package's set).
# Embedding, norms and (unless QuantConfig.quantize_lm_head) the LM head
# stay high-precision.
_QUANTIZABLE = {"layers/wqkv", "layers/wo", "layers/w_gate_up",
                "layers/w_down", "layers/shared_gate_up",
                "layers/shared_down",
                "layers/q_proj", "layers/q_b", "layers/kv_b"}

# ModelConfig fields whose branch of the JAX name map (llama_hf_param_map
# :74-226) the port has not taken over, with the family they name.
_UNMAPPED = [
    ("num_experts", "mixture-of-experts checkpoints (Mixtral, Qwen2-MoE, "
                    "DeepSeek, GPT-OSS, OLMoE)"),
    ("kv_lora_rank", "multi-head latent attention checkpoints (DeepSeek)"),
    ("first_k_dense", "dense-prefix layer groups (DeepSeek)"),
    ("attention_bias", "QKV biases (Qwen2)"),
    ("qk_norm", "q/k RMSNorm (Qwen3, OLMo-2)"),
    ("attn_sinks", "attention sinks (GPT-OSS)"),
    ("o_bias", "o_proj biases (GPT-OSS)"),
    ("mlp_bias", "FFN biases (Ernie-4.5)"),
    ("sandwich_norms", "sandwich norms (Gemma-3, GLM-4)"),
]

# Gemma-2's sandwich norms (weights.py:182-205): post_attention_layernorm
# norms the attention OUTPUT, the pre-FFN norm (the post_norm role) loads
# from pre_feedforward_layernorm
_HF_GEMMA2_NORMS = {
    "layers/post_attn_norm":
        "model.layers.{i}.post_attention_layernorm.weight",
    "layers/post_norm": "model.layers.{i}.pre_feedforward_layernorm.weight",
    "layers/post_ffn_norm":
        "model.layers.{i}.post_feedforward_layernorm.weight",
}


def llama_hf_param_map(cfg: ModelConfig) -> dict[str, Any]:
    """Param path -> HF tensor name(s) for the dense Llama graph (Llama,
    Mistral, Gemma, Gemma-2 and their like). The other families' names
    raise NotImplementedError naming them."""
    gemma2 = cfg.sandwich_norms and cfg.model_type == "gemma2"
    for field, name in _UNMAPPED:
        if getattr(cfg, field) and not (field == "sandwich_norms" and gemma2):
            raise NotImplementedError(f"HF names of {name}")
    if cfg.model_type == "phi3":
        raise NotImplementedError("HF names of Phi-3's fused projections")
    if not cfg.pre_norms:
        raise NotImplementedError("HF names of post-norm-only blocks "
                                  "(OLMo-2)")
    m = dict(_HF_LLAMA_MAP)
    if gemma2:
        m.update(_HF_GEMMA2_NORMS)
    if cfg.tie_word_embeddings:
        m.pop("lm_head")
    return m


def _set_path(tree: dict, path: str, value):
    parts = path.split("/")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


def _maybe_quantize(path: str, w, quant: QuantConfig):
    eligible = path in _QUANTIZABLE or (path == "lm_head"
                                        and quant.quantize_lm_head)
    if quant.enabled and eligible and not isinstance(w, QuantizedWeight):
        if quant.mode not in ("int8", "int4"):
            raise ValueError(f"quantization mode {quant.mode!r} (int8 or "
                             f"int4)")
        k = w.shape[-2]
        bits = 4 if quant.mode == "int4" else 8
        gs = quant.group_size or k          # 0 = per-output-channel
        if k % gs != 0:
            gs = math.gcd(k, gs) or k
        if bits == 4 and gs != k and (k // 2) % gs != 0:
            # split-half packing needs gs | K/2 (ref_ops)
            gs = math.gcd(k // 2, gs) or k
        return _quantize_by_layer(w, gs, bits)
    return w


def _quantize_by_layer(w, gs: int, bits: int) -> QuantizedWeight:
    """QuantizedWeight.quantize of ``w``, a stacked [L, K, N] weight one
    layer at a time into the stacked codes and scales: the same values
    (each group lies in one layer), with one layer's f32 temporaries
    instead of the stack's (a folded-expert stack of gpt-oss-20b is
    25 GB in bf16, 51 GB in f32)."""
    if w.ndim != 3:
        return QuantizedWeight.quantize(w, gs, bits=bits)
    first = QuantizedWeight.quantize(w[0], gs, bits=bits)
    q = first.q.new_empty((w.shape[0], *first.q.shape))
    scales = first.scales.new_empty((w.shape[0], *first.scales.shape))
    q[0], scales[0] = first.q, first.scales
    for li in range(1, w.shape[0]):
        one = QuantizedWeight.quantize(w[li], gs, bits=bits)
        q[li], scales[li] = one.q, one.scales
    return QuantizedWeight(q=q, scales=scales, bits=bits)


def quantize_params(params: dict, quant: QuantConfig) -> dict:
    """Post-hoc quantization of an already-loaded float params dict: the
    eligible stacked weights become :class:`QuantizedWeight` (int8 codes,
    or split-half packed INT4 with ``mode="int4"``, with f32 scales, on
    the weights' device), the folded experts of a mixture-of-experts
    model (``w_gate_up``, ``w_down``) among them, one layer at a time;
    everything else (the router and every bias included) is passed
    through. MLA params (``kv_a`` among the layers) raise: quantized
    weights under MLA are not ported."""
    if "kv_a" in params["layers"]:
        raise NotImplementedError("quantize_params on MLA weights "
                                  "(quantized weights under MLA)")
    out = dict(params)
    out["layers"] = {
        name: _maybe_quantize(f"layers/{name}", w, quant)
        for name, w in params["layers"].items()
    }
    if "lm_head" in params:
        out["lm_head"] = _maybe_quantize("lm_head", params["lm_head"], quant)
    return out
