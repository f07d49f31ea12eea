"""Typed configuration for models, quantization, KV cache, and the engine.

Successor of the reference's hard-coded ``LlamaModelConfig`` struct
(reference: include/model/config.h:5-17) and its absent engine/flag system
(SURVEY.md §5 "Config / flag system"): model configs are parsed from HF
``config.json`` instead of being baked in, and engine behavior is a typed
dataclass instead of compile-time constants.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for a Llama-family decoder.

    Field-for-field covers everything the reference hard-codes
    (config.h:5-17: vocab, head_dim, hidden, kv-hidden, intermediate,
    max_length, layer_num, head_num, kv_head_num, eps, theta) plus what a
    real checkpoint zoo needs (tied embeddings, rope scaling, dtype).
    """

    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 22
    num_heads: int = 32
    num_kv_heads: int = 4
    head_dim: int = 64
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_seq_len: int = 2048
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"  # parameter/compute dtype ("float32" for parity tests)
    # Optional rope scaling; dict per HF config.json ("rope_type":
    # "llama3" | "linear", plus factors). None = plain RoPE.
    rope_scaling: Optional[dict] = None
    # QKV projection bias (Qwen2-style; Llama has none).
    attention_bias: bool = False
    model_type: str = "llama"
    # FFN gate activation ("silu" | "gelu_pytorch_tanh" | "gelu") and
    # input-embedding multiplier (Gemma scales by sqrt(hidden_size))
    hidden_act: str = "silu"
    embed_scale: float = 1.0
    # Sparse-MoE FFN (Mixtral-style): 0 = dense FFN. The reference is
    # dense-only (model.cpp:99-121; SURVEY.md §2.8 "Expert parallel:
    # absent"); see ops/moe.py for the TPU-native design.
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # Per-expert FFN width; None = intermediate_size (Mixtral semantics;
    # Qwen2-MoE checkpoints carry a distinct moe_intermediate_size).
    moe_intermediate_size: Optional[int] = None
    # Renormalize the top-k router probabilities to sum to 1 (Mixtral
    # always does; Qwen2-MoE exposes norm_topk_prob, default False).
    norm_topk_prob: bool = True
    # Qwen2-MoE: an always-on dense FFN of this width runs beside the
    # sparse experts, weighted by sigmoid(x @ shared_expert_gate).
    # None = no shared expert (Mixtral).
    shared_expert_intermediate_size: Optional[int] = None
    # Shared-expert weighting: Qwen2-MoE gates it by
    # sigmoid(x @ shared_expert_gate); DeepSeek's shared experts are
    # unweighted (always fully on).
    shared_expert_gate: bool = True
    # DeepSeek: multiply the (optionally normalized) top-k router
    # weights by this factor (routed_scaling_factor).
    routed_scaling_factor: float = 1.0
    # Router score function: "softmax" (Mixtral/Qwen/DeepSeek-V2) or
    # "sigmoid" (DeepSeek-V3 noaux_tc: selection on bias-corrected
    # sigmoid scores restricted to the top `router_topk_group` of
    # `router_n_group` expert groups; weights from the unbiased scores).
    router_score_fn: str = "softmax"
    router_n_group: int = 1
    router_topk_group: int = 1
    # DeepSeek: the first k layers use the DENSE FFN (intermediate_size
    # wide); only layers >= k are sparse-MoE. Their weights live in a
    # separate stacked group (params["dense_layers"]) so both stacks
    # stay scannable.
    first_k_dense: int = 0
    # Sliding-window attention (Mistral-style): each query attends only
    # to keys within the last `sliding_window` positions, i.e. keys with
    # q_pos - k_pos < window. None = full causal attention. The flash
    # kernels skip KV blocks outside the window (decode cost becomes
    # O(window) instead of O(context)).
    sliding_window: Optional[int] = None
    # Per-head RMSNorm on q and k BEFORE RoPE (Qwen3-style; weights
    # q_norm/k_norm [head_dim] shared across heads within a layer).
    qk_norm: bool = False
    # qk_norm over the FULL concatenated projection instead of per-head
    # (OLMo-2: weights [N*D]/[KV*D], ONE rms denominator across heads,
    # applied before the head split).
    qk_norm_full: bool = False
    # Pre-norms exist (input_layernorm + the pre-FFN norm) — every
    # family but OLMo-2. False = block inputs are used RAW and the only
    # norms are the pre-residual output norms (sandwich_norms):
    # OLMo-2's h += norm(attn(h)); h += norm(mlp(h)).
    pre_norms: bool = True
    # Residual-branch multiplier (Granite residual_multiplier, muP-style
    # depth scaling): h = h + scale * block_out(h). 1.0 = plain adds.
    residual_scale: float = 1.0
    # Multiplicative LM-head logit scale (Granite: 1/logits_scaling;
    # Cohere: logit_scale), applied before any final softcap.
    logit_scale: float = 1.0
    # Partial rotary (GLM-4 0.5, Nemotron/StableLM): only the first
    # head_dim * factor dims rotate, the rest pass through. 1.0 = full.
    partial_rotary_factor: float = 1.0
    # Pairing inside the rotary slice: True = interleaved lanes
    # (2i, 2i+1) share frequency f_i (GLM-4's rotate_half); False =
    # half-split NeoX pairing (Nemotron/StableLM partial rotary).
    rope_interleaved: bool = False
    # Per-layer NoPE (SmolLM3 no_rope_layers): True = this layer applies
    # NO rotary embedding (identity rotation; position information flows
    # only through the causal mask). None = every layer rotates.
    nope_layers: Optional[tuple] = None
    # Gemma-2-style "sandwich" norms: RMSNorm the attention output
    # (post_attention_layernorm) and the FFN output
    # (post_feedforward_layernorm) BEFORE their residual adds; the
    # pre-FFN norm then loads from pre_feedforward_layernorm.
    sandwich_norms: bool = False
    # Attention-score soft capping (Gemma-2): s = cap * tanh(s / cap)
    # before masking/softmax. None = off.
    attn_logit_softcap: Optional[float] = None
    # Final-logit soft capping (Gemma-2): applied to the LM-head output.
    final_logit_softcap: Optional[float] = None
    # Attention score scale = query_pre_attn_scalar**-0.5 when set
    # (Gemma-2; e.g. 27B uses hidden/num_heads != head_dim). None =
    # head_dim**-0.5.
    query_pre_attn_scalar: Optional[float] = None
    # Gemma-3: sliding_attention layers use a DIFFERENT rope base
    # frequency (rope_local_base_freq, e.g. 10k local vs 1M global);
    # rope_scaling applies to the global (full_attention) tables only.
    rope_local_theta: Optional[float] = None
    # Per-layer attention type ("sliding_attention" | "full_attention"),
    # one entry per layer (Gemma-2 alternates). None = uniform
    # (sliding_window applies to every layer when set). The layer scan
    # runs over the pattern's period, so the stacked-layer kernels still
    # apply (p compiled sub-bodies, L/p scan steps).
    layer_types: Optional[tuple] = None
    # --- Multi-head Latent Attention (DeepSeek-V2/V3) ---
    # kv_lora_rank non-None switches the attention block to MLA: K/V
    # derive from a compressed per-token latent (kv_lora_rank wide) plus
    # a shared rope key (qk_rope_head_dim). head_dim then holds the
    # PADDED cache lane dim (k 192 / v 128 both pad to 256 so the flash
    # kernels' (8,128)-tiled pools apply); the real dims live below and
    # query_pre_attn_scalar carries the true 1/sqrt(192) score scale.
    # DeepSeek RoPE is INTERLEAVED (complex pairs), not half-split.
    kv_lora_rank: Optional[int] = None
    q_lora_rank: Optional[int] = None     # None = direct q_proj
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # Absorbed MLA decode (the MLA serving win): cache ONE row per token
    # — the compressed latent + roped shared key ([kv_lora_rank +
    # qk_rope_head_dim] padded to a 128-lane multiple) instead of
    # per-head K/V. Attention becomes MQA over the latent rows with
    # q' = [q_nope @ W_uk | q_pe] (scores identical by associativity:
    # W_uk c == k_nope) and the output un-absorbs through W_uv. KV bytes
    # per token drop ~13x vs the naive per-head cache (e.g. V2-Lite:
    # 2*640*2 B vs 2*16*256*2 B). num_kv_heads=1 and head_dim=the padded
    # latent width describe the cache pools in this mode.
    mla_absorbed: bool = False
    # --- GPT-OSS ---
    # attn_sinks: learned per-head attention-sink logits (params leaf
    # "sinks" [L, N]) join every softmax denominator with zero value
    # contribution; the flash kernels initialize their online-softmax
    # accumulators at (m=sink, l=1). o_bias: bias on the attention out
    # projection. moe_bias: router linear bias + per-expert gate_up/down
    # biases (clamped-SwiGLU experts when hidden_act="swiglu_oss":
    # gate clamped to <= 7, up to +-7, glu = g*sigmoid(1.702 g),
    # out = (up+1)*glu — HF GptOssExperts constants).
    attn_sinks: bool = False
    o_bias: bool = False
    moe_bias: bool = False
    # Dense-FFN projection biases (Ernie-4.5 use_bias, Llama mlp_bias):
    # gate/up biases fold into one stacked w_gate_up_bias [L, 2I] (gate
    # columns first, matching the fused w_gate_up layout), down_proj
    # bias into w_down_bias [L, H].
    mlp_bias: bool = False
    # Activation quantization for the PREFILL matmuls ("int8" | None):
    # per-token symmetric int8 activations feed the MXU's double-rate
    # int8 path against the int8 weights (W8A8) — measured 329 vs 184
    # TFLOPs on the 7B gate_up shape, ~2x prefill compute. Applies only
    # to compute-bound row counts (>= 256 rows: prefill chunks, never
    # decode bursts or the LM head) and only to symmetric int8 weights.
    # Quality: adds per-token activation rounding on top of weight
    # quantization (standard W8A8-token recipe); validate per checkpoint
    # with the PPL harness before enabling in production.
    act_quant: Optional[str] = None

    @property
    def mla(self) -> bool:
        """Multi-head Latent Attention (DeepSeek-V2/V3)."""
        return self.kv_lora_rank is not None

    @property
    def qk_head_dim(self) -> int:
        """True MLA query/key dim (nope + rope parts)."""
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def kv_group_size(self) -> int:
        """Heads per KV head (GQA group; reference: mha.cpp:23)."""
        return self.num_heads // self.num_kv_heads

    @property
    def expert_intermediate_size(self) -> int:
        """Per-expert FFN width (MoE models only)."""
        return self.moe_intermediate_size or self.intermediate_size

    def __post_init__(self):
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError(
                f"num_heads ({self.num_heads}) must be divisible by "
                f"num_kv_heads ({self.num_kv_heads})"
            )
        # Configs are jit static args -> must be hashable; freeze the
        # rope_scaling dict into a sorted item tuple. (Lists appear when
        # a checkpoint's JSON round-trips the tuple form; LIST VALUES
        # appear in longrope's per-dim short/long factor arrays.)
        def _freeze(v):
            return tuple(v) if isinstance(v, list) else v
        if isinstance(self.rope_scaling, dict):
            object.__setattr__(
                self, "rope_scaling",
                tuple(sorted((k, _freeze(v))
                             for k, v in self.rope_scaling.items())))
        elif isinstance(self.rope_scaling, list):
            object.__setattr__(
                self, "rope_scaling",
                tuple(sorted((k, _freeze(v))
                             for k, v in self.rope_scaling)))
        if isinstance(self.layer_types, list):
            object.__setattr__(self, "layer_types",
                               tuple(self.layer_types))
        if isinstance(self.nope_layers, list):
            object.__setattr__(self, "nope_layers",
                               tuple(self.nope_layers))
        if (self.nope_layers is not None
                and len(self.nope_layers) != self.num_layers):
            raise ValueError(
                f"nope_layers has {len(self.nope_layers)} entries for "
                f"{self.num_layers} layers")
        if self.first_k_dense:
            if not (0 < self.first_k_dense < self.num_layers):
                raise ValueError(
                    f"first_k_dense={self.first_k_dense} out of range "
                    f"for {self.num_layers} layers")
            if not self.num_experts:
                raise ValueError("first_k_dense requires a MoE config")
            if self.layer_types is not None:
                raise ValueError("first_k_dense with alternating "
                                 "layer_types is not supported")
        if self.layer_types is not None:
            if len(self.layer_types) != self.num_layers:
                raise ValueError(
                    f"layer_types has {len(self.layer_types)} entries for "
                    f"{self.num_layers} layers")
            bad = set(self.layer_types) - {"sliding_attention",
                                           "full_attention"}
            if bad:
                raise ValueError(f"unknown layer_types {sorted(bad)}")
            if ("sliding_attention" in self.layer_types
                    and not self.sliding_window):
                raise ValueError("layer_types has sliding_attention but "
                                 "sliding_window is unset")

    @property
    def layer_windows(self) -> tuple:
        """Per-layer attention window (None = full causal)."""
        if self.layer_types is None:
            return (self.sliding_window,) * self.num_layers
        return tuple(self.sliding_window if t == "sliding_attention"
                     else None for t in self.layer_types)

    def window_pattern(self) -> tuple[int, tuple]:
        """(period p, per-sublayer windows) — the smallest repeating
        window pattern. The layer scan runs L/p steps of p sub-bodies so
        alternating sliding/full stacks (Gemma-2) keep the one-trace
        stacked-layer design."""
        wins = self.layer_windows
        for p in range(1, len(wins) + 1):
            if len(wins) % p == 0 and wins == wins[:p] * (len(wins) // p):
                return p, wins[:p]
        return len(wins), wins  # unreachable (p = L always matches)

    @property
    def layer_nope(self) -> tuple:
        """Per-layer NoPE flag (True = skip rotary on this layer)."""
        if self.nope_layers is None:
            return (False,) * self.num_layers
        return tuple(bool(v) for v in self.nope_layers)

    def scan_pattern(self) -> tuple[int, tuple, tuple]:
        """(period p, windows[:p], nope[:p]) — like
        :meth:`window_pattern` but the period also respects the
        per-layer NoPE pattern, so SmolLM3's every-4th-layer no-rope
        stack scans as 4 sub-bodies with per-sublayer rope tables."""
        keys = tuple(zip(self.layer_windows, self.layer_nope))
        for p in range(1, len(keys) + 1):
            if len(keys) % p == 0 and keys == keys[:p] * (len(keys) // p):
                wins, nope = zip(*keys[:p])
                return p, tuple(wins), tuple(nope)
        wins, nope = zip(*keys)  # unreachable (p = L always matches)
        return len(keys), tuple(wins), tuple(nope)

    @property
    def rope_scaling_dict(self) -> Optional[dict]:
        if self.rope_scaling is None:
            return None
        return dict(self.rope_scaling)

    @classmethod
    def from_hf_dict(cls, d: dict[str, Any], **overrides) -> "ModelConfig":
        """Build from a HuggingFace ``config.json`` dict.

        The reference ignores checkpoint metadata entirely and copies
        hard-coded defaults (model.cpp:219-230); we parse the real thing.
        """
        head_dim = d.get("head_dim") or d["hidden_size"] // d["num_attention_heads"]
        kw = dict(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            intermediate_size=d["intermediate_size"],
            num_layers=d["num_hidden_layers"],
            num_heads=d["num_attention_heads"],
            num_kv_heads=d.get("num_key_value_heads", d["num_attention_heads"]),
            head_dim=head_dim,
            rms_norm_eps=d.get("rms_norm_eps", 1e-5),
            rope_theta=d.get("rope_theta", 10000.0),
            max_seq_len=d.get("max_position_embeddings", 2048),
            tie_word_embeddings=d.get("tie_word_embeddings", False),
            rope_scaling=d.get("rope_scaling"),
            # Qwen2 has QKV bias unconditionally; Llama exposes a flag;
            # Ernie-4.5 calls it use_bias.
            attention_bias=d.get(
                "attention_bias",
                d.get("model_type") in ("qwen2", "qwen2_moe"))
            or bool(d.get("use_bias")),
            # Ernie-4.5's use_bias puts a bias on EVERY projection
            # (o_proj and gate/up/down too); Llama/SeedOss expose
            # mlp_bias / attention_out_bias separately.
            o_bias=bool(d.get("use_bias"))
            or bool(d.get("attention_out_bias")),
            mlp_bias=bool(d.get("mlp_bias")) or bool(d.get("use_bias")),
            # Qwen3 and Gemma-3 use per-head q/k RMSNorm before RoPE;
            # OLMo-2 norms the FULL q/k projections (one denominator).
            qk_norm=d.get("model_type") in ("qwen3", "qwen3_moe",
                                            "gemma3_text", "olmo2",
                                            "olmoe"),
            qk_norm_full=d.get("model_type") in ("olmo2", "olmoe"),
            # OLMo-2 is post-norm only: no input/pre-FFN norms; its
            # post_attention/post_feedforward norms are exactly the
            # Gemma-2 pre-residual output norms.
            pre_norms=d.get("model_type") != "olmo2",
            # Gemma-2/3: sandwich norms, logit soft caps (2 only), query
            # scale, alternating sliding/full attention layers; Gemma-3
            # adds a separate LOCAL rope base for the sliding layers.
            sandwich_norms=d.get("model_type") in ("gemma2",
                                                   "gemma3_text", "olmo2",
                                                   "glm4"),
            # GLM-4: rope over the first half of head_dim with the
            # repeat-interleaved frequency layout; Qwen2-style QKV bias
            partial_rotary_factor=(
                float(d.get("partial_rotary_factor", 0.5))
                if d.get("model_type") == "glm4" else 1.0),
            # Helium and Ernie-4.5 rotate the FULL head_dim with the
            # interleaved pairing (their apply repeat-interleaves
            # truncated tables exactly like GLM-4, just with
            # rotary_dim == head_dim).
            rope_interleaved=d.get("model_type") in ("glm4", "helium",
                                                     "ernie4_5"),
            rope_local_theta=(float(d["rope_local_base_freq"])
                              if d.get("rope_local_base_freq") is not None
                              and d.get("model_type") == "gemma3_text"
                              else None),
            attn_logit_softcap=d.get("attn_logit_softcapping"),
            final_logit_softcap=d.get("final_logit_softcapping"),
            query_pre_attn_scalar=(
                float(d["query_pre_attn_scalar"])
                if d.get("query_pre_attn_scalar") is not None else None),
            # keep layer_types only when it actually mixes attention
            # kinds (many HF configs carry an all-full list)
            layer_types=(tuple(d["layer_types"])
                         if d.get("layer_types")
                         and len(set(d["layer_types"])) > 1 else None),
            # SmolLM3 no_rope_layers: HF stores 1 = rope ON, 0 = NoPE.
            nope_layers=(tuple(not bool(v) for v in d["no_rope_layers"])
                         if d.get("no_rope_layers")
                         and not all(d["no_rope_layers"]) else None),
            model_type=d.get("model_type", "llama"),
            # HF resolves the FFN activation from `hidden_activation`
            # first; stock Gemma checkpoints carry a legacy
            # `hidden_act: "gelu"` that transformers IGNORES (it uses
            # gelu_pytorch_tanh) — mirroring that order here keeps our
            # outputs matched to HF on real Gemma configs.
            hidden_act=d.get("hidden_activation")
            or ("gelu_pytorch_tanh" if d.get("model_type") == "gemma"
                else d.get("hidden_act") or "silu"),
            embed_scale=(float(d["hidden_size"]) ** 0.5
                         if d.get("model_type") in ("gemma", "gemma2",
                                                    "gemma3_text")
                         else 1.0),
            # Mixtral: num_local_experts/num_experts_per_tok; dense
            # checkpoints carry neither.
            num_experts=d.get("num_local_experts",
                              d.get("num_experts", 0)),
            num_experts_per_tok=d.get("num_experts_per_tok", 2),
            moe_intermediate_size=d.get("moe_intermediate_size"),
            # HF default: Mixtral always renormalizes; Qwen2-MoE's
            # norm_topk_prob defaults to False.
            norm_topk_prob=d.get(
                "norm_topk_prob",
                d.get("model_type") not in ("qwen2_moe", "olmoe")),
            shared_expert_intermediate_size=d.get(
                "shared_expert_intermediate_size"),
            sliding_window=cls._resolve_sliding_window(d),
        )
        if d.get("model_type") == "olmoe" and d.get("clip_qkv"):
            # OLMo-1-era qkv clamp; no released OLMoE checkpoint sets it
            raise ValueError("OLMoE clip_qkv is not supported")
        if d.get("model_type") == "granite":
            # Granite (IBM): Llama graph + four muP-style scalar
            # multipliers. attention_multiplier IS the score scale, so
            # it rides query_pre_attn_scalar = scale**-2 (the same
            # carrier MLA uses for its true 1/sqrt(192) scale).
            kw.update(
                embed_scale=float(d.get("embedding_multiplier", 1.0)),
                query_pre_attn_scalar=(
                    float(d["attention_multiplier"]) ** -2.0
                    if d.get("attention_multiplier") is not None
                    else None),
                residual_scale=float(d.get("residual_multiplier", 1.0)),
                logit_scale=1.0 / float(d.get("logits_scaling", 1.0)),
            )
        # Qwen2-MoE can interleave dense layers (decoder_sparse_step,
        # mlp_only_layers); heterogeneous layer stacks don't fit the
        # scanned stacked-layer layout, and every released Qwen-MoE
        # checkpoint is all-sparse — gate loudly rather than mis-run.
        if kw["num_experts"] and (d.get("decoder_sparse_step", 1) != 1
                                  or d.get("mlp_only_layers")):
            raise ValueError(
                "mixed dense/sparse MoE layer stacks (decoder_sparse_step"
                " != 1 or mlp_only_layers) are not supported")
        if d.get("model_type") in ("deepseek_v2", "deepseek_v3"):
            # DeepSeek MoE: greedy softmax routing with a scaling factor,
            # unweighted shared experts, dense first-k layers.
            if d.get("n_routed_experts"):
                v3 = d.get("model_type") == "deepseek_v3"
                method = d.get("topk_method",
                               "noaux_tc" if v3 else "greedy")
                score = d.get("scoring_func",
                              "sigmoid" if v3 else "softmax")
                if (score, method) not in (
                        ("softmax", "greedy"),
                        ("softmax", "group_limited_greedy"),
                        ("sigmoid", "noaux_tc")):
                    raise ValueError(
                        f"unsupported DeepSeek routing ({score!r}, "
                        f"{method!r}); supported: V2 greedy / "
                        "group_limited_greedy softmax, V3 noaux_tc "
                        "sigmoid")
                if d.get("moe_layer_freq", 1) != 1:
                    raise ValueError("moe_layer_freq != 1 unsupported")
                kw.update(
                    router_score_fn=score,
                    router_n_group=int(d.get("n_group") or 1),
                    router_topk_group=int(d.get("topk_group") or 1),
                    num_experts=int(d["n_routed_experts"]),
                    num_experts_per_tok=int(d["num_experts_per_tok"]),
                    moe_intermediate_size=int(d["moe_intermediate_size"]),
                    norm_topk_prob=bool(d.get("norm_topk_prob", False)),
                    routed_scaling_factor=float(
                        d.get("routed_scaling_factor", 1.0)),
                    first_k_dense=int(d.get("first_k_dense_replace", 0)),
                    shared_expert_gate=False,
                    shared_expert_intermediate_size=(
                        int(d["moe_intermediate_size"])
                        * int(d["n_shared_experts"])
                        if d.get("n_shared_experts") else None),
                )
            # MLA: real q/k dim = nope + rope; the cache lane dim pads to
            # a flash-kernel-tileable width and query_pre_attn_scalar
            # carries the true score scale.
            nope = int(d.get("qk_nope_head_dim", 128))
            rope_d = int(d.get("qk_rope_head_dim", 64))
            vd = int(d.get("v_head_dim", 128))
            dc = int(d["kv_lora_rank"])
            m = max(nope + rope_d, vd)
            if m > 256:
                raise ValueError(f"MLA head dims too wide to pad ({m})")
            absorbed = overrides.pop("mla_absorbed", True)
            if absorbed:
                # one latent row per token: [c_kv | roped shared key],
                # padded to a 128-lane multiple; MQA cache (1 kv head)
                lane = -(-(dc + rope_d) // 128) * 128
                cache_kw = dict(head_dim=max(lane, 128), num_kv_heads=1)
            else:
                cache_kw = dict(
                    head_dim=64 if m <= 64 else (128 if m <= 128 else 256),
                    num_kv_heads=d["num_attention_heads"])
            # Score scale: (nope+rope)^-0.5; DeepSeek-V3 checkpoints
            # with yarn additionally fold in mscale(factor,
            # mscale_all_dim)^2 (HF DeepseekV3Attention.__init__ —
            # V2 applies only the sin/cos attention factor). Stored as
            # query_pre_attn_scalar = scale^-2.
            qpas = float(nope + rope_d)
            rs = d.get("rope_scaling") or {}
            if (d.get("model_type") == "deepseek_v3"
                    and rs.get("rope_type", rs.get("type")) == "yarn"
                    and rs.get("mscale_all_dim")):
                m = yarn_mscale(float(rs["factor"]),
                                float(rs["mscale_all_dim"]))
                qpas /= m ** 4
            kw.update(
                kv_lora_rank=dc,
                q_lora_rank=(int(d["q_lora_rank"])
                             if d.get("q_lora_rank") else None),
                qk_nope_head_dim=nope, qk_rope_head_dim=rope_d,
                v_head_dim=vd, mla_absorbed=absorbed,
                query_pre_attn_scalar=qpas,
                **cache_kw,
            )
            if kw.get("first_k_dense", 0) >= d["num_hidden_layers"]:
                # every layer dense: plain dense-FFN model
                kw.update(num_experts=0, first_k_dense=0,
                          shared_expert_intermediate_size=None)
        rs_ = d.get("rope_scaling") or {}
        if rs_.get("rope_type", rs_.get("type")) == "longrope":
            # Phi-3 longrope: per-dim short/long frequency factors chosen
            # by position, sin/cos scaled by sqrt(1 + ln(f)/ln(orig));
            # the factor and the pretrained length ride inside the
            # frozen rope_scaling tuple (HF keeps orig at config top
            # level). NOTE: factor selection here is PER POSITION
            # (positions >= orig use long_factor — cache-consistent for
            # serving, the vLLM convention); HF eager instead re-ropes
            # the whole sequence once seq_len crosses orig.
            rs_ = dict(rs_)
            orig = int(d.get("original_max_position_embeddings")
                       or rs_.get("original_max_position_embeddings")
                       or d["max_position_embeddings"])
            rs_["original_max_position_embeddings"] = orig
            rs_.setdefault("factor",
                           float(d["max_position_embeddings"]) / orig)
            kw["rope_scaling"] = rs_
        if d.get("model_type") == "gpt_oss":
            # GPT-OSS: attention sinks + o_proj bias, clamped-SwiGLU MoE
            # with router/expert biases, alternating sliding/full layers
            # (layer_types, handled generically), yarn rope. The config's
            # intermediate_size IS the expert width (no dense FFN);
            # routing = top-k on biased logits, softmax over the k ==
            # softmax-all + renorm (norm_topk).
            kw.update(attn_sinks=True, o_bias=True, moe_bias=True,
                      hidden_act="swiglu_oss",
                      moe_intermediate_size=d["intermediate_size"],
                      norm_topk_prob=True)
        kw.update(overrides)
        return cls(**kw)

    @staticmethod
    def _resolve_sliding_window(d: dict[str, Any]) -> Optional[int]:
        """HF sliding-window semantics per model family.

        Mistral applies ``sliding_window`` to every layer when set
        (v0.2+ checkpoints carry null = full attention). Qwen2 gates on
        ``use_sliding_window`` (default False — released checkpoints
        run full attention at inference) and applies it only to layers
        >= ``max_window_layers``; a heterogeneous full/SWA stack does
        not fit the scanned stacked-layer layout, so gate loudly.
        """
        w = d.get("sliding_window")
        if not w:
            return None
        mt = d.get("model_type", "llama")
        if mt in ("mistral", "phi3"):
            return int(w)
        if mt in ("gemma2", "gemma3_text", "gpt_oss"):
            # applies to the sliding_attention layers of layer_types
            # (alternating; the full layers ignore it)
            return int(w)
        if mt in ("qwen2", "qwen2_moe", "qwen3", "qwen3_moe"):
            if not d.get("use_sliding_window", False):
                return None
            mwl = d.get("max_window_layers", 0)
            if mwl >= d["num_hidden_layers"]:
                return None  # every layer below the cutoff: all-full
            if mwl != 0:
                raise ValueError(
                    "mixed full/sliding-window layer stacks "
                    f"(max_window_layers={mwl}) are not supported")
            return int(w)
        return None

    @classmethod
    def from_hf_json(cls, path: str, **overrides) -> "ModelConfig":
        with open(path) as f:
            return cls.from_hf_dict(json.load(f), **overrides)

    @classmethod
    def from_pretrained_dir(cls, model_dir: str, **overrides) -> "ModelConfig":
        return cls.from_hf_json(os.path.join(model_dir, "config.json"), **overrides)

    # Well-known architectures, for tests/benches without checkpoint files.
    @classmethod
    def _preset(cls, base: dict, ov: dict) -> "ModelConfig":
        base.update(ov)
        return cls(**base)

    @classmethod
    def tinyllama_1_1b(cls, **ov) -> "ModelConfig":
        return cls._preset(dict(
            vocab_size=32000, hidden_size=2048, intermediate_size=5632,
            num_layers=22, num_heads=32, num_kv_heads=4, head_dim=64,
            rope_theta=10000.0, max_seq_len=2048), ov)

    @classmethod
    def llama2_7b(cls, **ov) -> "ModelConfig":
        return cls._preset(dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=11008,
            num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128,
            rope_theta=10000.0, max_seq_len=4096), ov)

    @classmethod
    def llama2_13b(cls, **ov) -> "ModelConfig":
        return cls._preset(dict(
            vocab_size=32000, hidden_size=5120, intermediate_size=13824,
            num_layers=40, num_heads=40, num_kv_heads=40, head_dim=128,
            rope_theta=10000.0, max_seq_len=4096), ov)

    @classmethod
    def llama3_2_3b(cls, **ov) -> "ModelConfig":
        # The reference's hard-coded defaults approximate this model
        # (config.h:5-17: vocab 128256, hidden 3072, 28 layers, 24/8 heads).
        return cls._preset(dict(
            vocab_size=128256, hidden_size=3072, intermediate_size=8192,
            num_layers=28, num_heads=24, num_kv_heads=8, head_dim=128,
            rope_theta=500000.0, max_seq_len=8192,
            rope_scaling={"rope_type": "llama3", "factor": 32.0,
                          "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                          "original_max_position_embeddings": 8192},
            tie_word_embeddings=True), ov)

    @classmethod
    def mistral_7b(cls, **ov) -> "ModelConfig":
        return cls._preset(dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
            rope_theta=10000.0, max_seq_len=8192,
            model_type="mistral"), ov)

    @classmethod
    def gemma_2b(cls, **ov) -> "ModelConfig":
        return cls._preset(dict(
            vocab_size=256000, hidden_size=2048, intermediate_size=16384,
            num_layers=18, num_heads=8, num_kv_heads=1, head_dim=256,
            rope_theta=10000.0, max_seq_len=8192, tie_word_embeddings=True,
            model_type="gemma", hidden_act="gelu_pytorch_tanh",
            embed_scale=2048.0 ** 0.5), ov)

    @classmethod
    def qwen2_7b(cls, **ov) -> "ModelConfig":
        return cls._preset(dict(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_layers=28, num_heads=28, num_kv_heads=4, head_dim=128,
            rope_theta=1000000.0, max_seq_len=32768,
            attention_bias=True, model_type="qwen2"), ov)

    @classmethod
    def mixtral_8x7b(cls, **ov) -> "ModelConfig":
        return cls._preset(dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
            rope_theta=1000000.0, max_seq_len=32768,
            model_type="mixtral", num_experts=8, num_experts_per_tok=2),
            ov)

    @classmethod
    def qwen15_moe_a2_7b(cls, **ov) -> "ModelConfig":
        return cls._preset(dict(
            vocab_size=151936, hidden_size=2048, intermediate_size=5632,
            num_layers=24, num_heads=16, num_kv_heads=16, head_dim=128,
            rope_theta=1000000.0, max_seq_len=32768, attention_bias=True,
            model_type="qwen2_moe", num_experts=60, num_experts_per_tok=4,
            moe_intermediate_size=1408, norm_topk_prob=False,
            shared_expert_intermediate_size=5632,
            tie_word_embeddings=False), ov)

    @classmethod
    def tiny_test(cls, **ov) -> "ModelConfig":
        """Small config for unit tests (runs in seconds on 1 CPU core)."""
        kw = dict(
            vocab_size=256, hidden_size=128, intermediate_size=256,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=32,
            rope_theta=10000.0, max_seq_len=128, dtype="float32",
        )
        kw.update(ov)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Weight/KV quantization spec.

    The reference is FP32-only (alloc.h:12 hard-codes 4-byte dtype); this is
    the BASELINE.json north-star extension: weight-only INT8 group quant with
    fused Pallas dequant+matmul, and INT8/FP8 paged KV.
    """

    # "none" | "int8" | "int4" (weight-only group quant). int4 packs two
    # nibbles per byte (ops/matmul.py int4 path): on v5e it is a CAPACITY
    # mode — weights/checkpoints halve again (13B fits one 16 GB chip),
    # but decode is VPU-dequant-bound (~270 GB/s logical vs int8's ~740;
    # the MXU needs bf16 operands and converting 2x the elements per byte
    # outweighs the DMA savings). On parts with native int4 MXU feed the
    # same layout becomes bandwidth-optimal.
    mode: str = "none"
    # Contraction-dim group for scales; 0 = per-output-channel (one scale
    # per column — the standard near-lossless weight-only INT8 scheme, and
    # the fastest: scales shrink K/group x, which matters because XLA's
    # loop optimizer re-stages large scale arrays every layer step).
    group_size: int = 128
    kv_dtype: str = "bf16"      # "bf16" | "int8" | "fp8"  (KV cache storage)
    scale_dtype: str = "float32"
    # Also quantize the LM head (embeddings/norms always stay high
    # precision). Halves the head's HBM read per step; costs ~0.01 PPL.
    quantize_lm_head: bool = False

    @property
    def enabled(self) -> bool:
        return self.mode != "none"

    def __post_init__(self):
        if self.mode not in ("none", "int8", "int4"):
            raise ValueError(f"unknown quant mode {self.mode!r}")
        if self.kv_dtype not in ("bf16", "f32", "int8", "fp8"):
            raise ValueError(f"unknown kv dtype {self.kv_dtype!r}")


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Paged KV cache geometry.

    Successor of the reference's dense static arena
    (``key_cache/value_cache [L, max_len, kv_hidden]``, model.cpp:264-268)
    — capacity is bounded by HBM pages, not per-sequence max length.
    """

    page_size: int = 32            # tokens per page (bigger pages = bigger page DMAs)
    num_pages: int = 1024          # total device pages (per layer tier)
    max_pages_per_seq: int = 512   # block-table width
    kv_dtype: str = "bf16"
    # Sliding-window KV page reclamation: models with sliding layers
    # (Mistral, Gemma-2/3, GPT-OSS) store those layers' KV in a separate
    # RING pool of ceil(window/page)+1 pages per slot — out-of-window
    # pages are overwritten in place, so sliding-layer memory is
    # O(window) instead of O(context). Tradeoff: ring pages are
    # slot-owned, so the prefix cache is disabled for such models while
    # this is on. Set False to restore O(context) sliding pools (+
    # prefix sharing). No effect on models without sliding layers.
    sliding_reclaim: bool = True

    @property
    def max_seq_len(self) -> int:
        return self.page_size * self.max_pages_per_seq


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving engine configuration (continuous batching scheduler)."""

    max_batch_size: int = 8
    max_seq_len: int = 8192
    # Chunked prefill: prompts longer than this run in fixed chunks
    # (bounded activation memory, one compiled graph for any length,
    # TTFT-fairness scheduling granularity). 0 = always whole-prompt
    # (fastest for prompts that fit — the default).
    prefill_chunk: int = 0
    # Engine-native SP x TP prefill: on a (data x model) mesh with
    # data >= 2, prompts at least this long ring-prefill over the full
    # mesh (the data axis doubles as the sequence ring), their K/V
    # scatter into the TP paged pools, and decode continues normally —
    # no caller orchestration (successor of the sequential prefill,
    # model.cpp:159-165; VERDICT r4 #4). 0 = off. Requires bf16/f32 KV
    # and a non-MLA model (llama_sp handoff gate).
    sp_prefill_threshold: int = 0
    max_queue: int = 256
    # Speculative decoding (prompt-lookup self-drafting): propose
    # spec_tokens continuations from the last spec_ngram-gram's previous
    # occurrence in the context and verify them in ONE forward — decode
    # is weight-bound, so verifying G+1 tokens costs nearly the same HBM
    # traffic as 1. 0 = off. Greedy rows accept by argmax equality;
    # stochastic rows accept by distribution-preserving rejection
    # sampling (penalty rows fall back to one token per step).
    spec_tokens: int = 0
    spec_ngram: int = 2
    # Persistent prefix cache: retain finished requests' prompt pages in
    # an LRU store (refcounted, zero-copy) so a recurring system prompt
    # skips its prefill even with no concurrent request in flight. Value
    # = max retained entries (0 = only share with RUNNING requests).
    # Retained pages are evicted before any preemption under pool
    # pressure — they can never cost a live request its slot.
    prefix_cache_entries: int = 16
    # Per-request logit_bias capacity: (token, bias) pairs ride as static
    # [B, max_logit_bias] sampler rows (OpenAI caps the field at 300).
    max_logit_bias: int = 16
    # Top-K per-token alternative logprobs (OpenAI `logprobs`/
    # `top_logprobs`): every decode/prefill graph additionally emits the
    # K highest-logprob token ids + logprobs per emitted token (one
    # lax.top_k over the raw logits per step — linear scan, cheap next
    # to the matmuls). 0 = off (the packed sync object stays [.., 2]).
    # Incompatible with speculative decoding.
    top_logprobs: int = 0
    # Guided decoding co-tenancy: while guided requests run, the engine
    # dispatches pipelined bursts of this depth in which guided rows are
    # live only at step 0 — their NEXT mask is selected in-graph from
    # the device-carried token via an uploaded FSM successor-mask table
    # (fan-out), so unguided co-tenants keep multi-step pipelining and
    # guided rows emit one token per burst without any host sync stall.
    # States with more than guided_fanout distinct successors fall back
    # to the serialized mask->step->sync path for that dispatch.
    guided_burst: int = 4
    guided_fanout: int = 8
    kv: KVCacheConfig = dataclasses.field(default_factory=KVCacheConfig)
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    # Mesh geometry: axis name -> size. Absent axes = 1.
    mesh_shape: Optional[dict] = None   # e.g. {"data": 1, "model": 4}


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.

    The reference supports only greedy argmax on CPU with a per-token D2H
    logits copy (model.cpp:166-184); here sampling runs on-device and
    supports temperature / top-k / top-p.
    """

    max_new_tokens: int = 128
    temperature: float = 0.0       # 0 => greedy
    top_k: int = 0                 # 0 => disabled
    top_p: float = 1.0             # 1.0 => disabled
    min_p: float = 0.0             # 0 => disabled (keep p >= min_p * pmax)
    repetition_penalty: float = 1.0   # 1.0 => neutral (HF semantics)
    frequency_penalty: float = 0.0    # OpenAI semantics (per count)
    presence_penalty: float = 0.0     # OpenAI semantics (per presence)
    stop_token_ids: tuple = ()
    # OpenAI-style stop STRINGS: generation halts when the decoded text
    # contains any of these; output text is truncated exactly at the
    # match even across token boundaries (engine/stop.py). Requires the
    # engine to have a tokenizer. (The reference decodes unconditionally
    # to max_length, model.cpp:157 — no stop handling of any kind.)
    stop_strings: tuple = ()
    # OpenAI logit_bias: ((token_id, bias), ...) added to the raw logits
    # every step (greedy rows included; -100 effectively bans a token).
    # Capacity per request is EngineConfig.max_logit_bias.
    logit_bias: tuple = ()
    # Minimum tokens to generate before stop_token_ids / stop_strings
    # may end the request (max_new_tokens still caps it). vLLM-style.
    min_tokens: int = 0
    # Ignore stop token ids entirely (benchmarks, fixed-length evals).
    ignore_eos: bool = False
    # None = nondeterministic (the engine derives a unique per-request
    # seed); set for reproducible sampling independent of batching.
    seed: Optional[int] = None
    # Guided (constrained) decoding — at most one of these may be set.
    # guided_regex: output must full-match this pattern
    # (structured/regex_fsm.py syntax). guided_json: a JSON schema
    # (dict or json string; True/{} = any JSON value) — output is
    # compact JSON satisfying it. guided_choice: output is exactly one
    # of these strings. Each decode step masks the vocabulary to tokens
    # that keep the constraint satisfiable; EOS is only reachable once
    # the constraint is complete. Requires an engine tokenizer;
    # incompatible with speculative decoding.
    guided_regex: Optional[str] = None
    guided_json: object = None
    guided_choice: Optional[tuple] = None

    def guided_pattern(self) -> Optional[str]:
        """The effective constraint regex, or None."""
        set_ = [k for k in ("guided_regex", "guided_json",
                            "guided_choice")
                if getattr(self, k) not in (None,)]
        if not set_:
            return None
        if len(set_) > 1:
            raise ValueError(f"at most one guided_* may be set: {set_}")
        # the regex/JSON-schema compilers (structured/) are not ported yet
        raise NotImplementedError(f"guided decoding ({set_[0]})")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    @property
    def penalties_neutral(self) -> bool:
        return (self.repetition_penalty == 1.0
                and self.frequency_penalty == 0.0
                and self.presence_penalty == 0.0)


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """DeepSeek/yarn attention magnitude correction: 0.1·m·ln(s) + 1."""
    if scale <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def next_power_of_2(x: int) -> int:
    return 1 if x <= 1 else 2 ** math.ceil(math.log2(x))
