"""Plain PyTorch reference math of the ops the serving path runs.

Counterpart of simplellminference_tpu/ops/ref_ops.py:24-364, function for
function and with the same shape conventions:

    x:       [B, S, H]           activations
    q/k/v:   [B, S, N, D]        per-head layout
    weights: [K, N]              contraction-first (x @ w)

Reductions and softmax run in float32 and cast back, as the reference
does. :func:`to_e4m3` is the cast into FP8 (e4m3) KV pools with the JAX
package's rounding. The quantized-weight helpers
(simplellminference_tpu/ops/ref_ops.py:367-508: INT8, split-half INT4
with optional zero points, W8A8) are at the end.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * w, accumulated in fp32."""
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype) * weight


# the activations glu_act runs: SwiGLU, Gemma's GeGLU and GPT-OSS's
# clamped SwiGLU (its experts)
GLU_ACTS = ("silu", "gelu_pytorch_tanh", "gelu_tanh", "gelu", "swiglu_oss")
# GPT-OSS's clamped SwiGLU (HF GptOssExperts; the JAX package hard-codes
# both, ref_ops.py:56-63)
OSS_LIMIT = 7.0
OSS_ALPHA = 1.702


def glu_act(gate: torch.Tensor, up: torch.Tensor,
            act: str = "silu") -> torch.Tensor:
    """Gated linear unit with a configurable activation, in f32, cast back
    to gate's dtype (simplellminference_tpu/ops/ref_ops.py:46-75): "silu"
    is SwiGLU (the Llama family), "gelu_pytorch_tanh"/"gelu_tanh" and
    "gelu" are Gemma's GeGLU (tanh approximation and exact erf),
    "swiglu_oss" GPT-OSS's clamped SwiGLU (the gate clamped above at 7,
    up to [-7, 7], (up + 1) * gate * sigmoid(1.702 * gate)); an unknown
    name raises ValueError, as in the JAX package."""
    g = gate.float()
    if act == "swiglu_oss":
        g = torch.clamp(g, max=OSS_LIMIT)
        u = torch.clamp(up.float(), -OSS_LIMIT, OSS_LIMIT)
        return ((u + 1.0) * (g * torch.sigmoid(g * OSS_ALPHA))).to(
            gate.dtype)
    if act == "silu":
        a = g * torch.sigmoid(g)
    elif act in ("gelu_pytorch_tanh", "gelu_tanh"):
        a = torch.nn.functional.gelu(g, approximate="tanh")
    elif act == "gelu":
        a = torch.nn.functional.gelu(g)
    else:
        raise ValueError(f"unknown activation {act!r}")
    return (a * up.float()).to(gate.dtype)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                dtype=torch.float32, rope_scaling=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """sin/cos tables for the given positions: [..., head_dim // 2].

    freq_d = theta^(-2d/head_dim), angle = pos * freq, with the "linear",
    "llama3" and "yarn" frequency scalings ("yarn" also scales sin and
    cos by its attention factor, as the JAX package does,
    ref_ops.py:87-99); "longrope" is not ported.
    """
    half = head_dim // 2
    dev = positions.device
    amp = 1.0   # yarn's attention factor on sin and cos
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=dev) * 2.0 / head_dim)
    if rope_scaling is not None:
        rs = dict(rope_scaling)
        kind = rs.get("rope_type", rs.get("type", "llama3"))
        factor = float(rs.get("factor", 8.0))
        if kind == "linear":
            freqs = freqs / factor
        elif kind == "llama3":
            low = float(rs.get("low_freq_factor", 1.0))
            high = float(rs.get("high_freq_factor", 4.0))
            old_len = float(rs.get("original_max_position_embeddings", 8192))
            wavelen = 2.0 * math.pi / freqs
            smooth = ((old_len / wavelen - low) / (high - low)).clamp(0.0, 1.0)
            scaled = (1.0 - smooth) * (freqs / factor) + smooth * freqs
            freqs = torch.where(wavelen > old_len / low, freqs / factor,
                                torch.where(wavelen < old_len / high, freqs,
                                            scaled))
        elif kind == "yarn":
            freqs, amp = _yarn_freqs(freqs, head_dim, theta, rs, factor)
        elif kind != "default":
            raise NotImplementedError(f"rope_type {kind!r}")
    angles = positions[..., None].float() * freqs
    return ((amp * torch.sin(angles)).to(dtype),
            (amp * torch.cos(angles)).to(dtype))


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """Yarn's attention magnitude correction: 0.1 * m * ln(s) + 1."""
    if scale <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _yarn_freqs(freqs: torch.Tensor, head_dim: int, theta: float, rs: dict,
                factor: float) -> tuple[torch.Tensor, float]:
    """Yarn (NTK-by-parts) frequencies and attention factor
    (simplellminference_tpu/ops/ref_ops.py:154-196, HF
    ``_compute_yarn_parameters``): each dim blends the original frequency
    and freq / factor by a ramp between the beta_fast and beta_slow
    correction dims (rounded outward unless ``truncate`` is false); the
    factor is ``attention_factor``, the mscale ratio, or
    0.1 * ln(factor) + 1."""
    half = head_dim // 2
    orig = float(rs.get("original_max_position_embeddings") or 4096)
    beta_fast = float(rs.get("beta_fast") or 32.0)
    beta_slow = float(rs.get("beta_slow") or 1.0)
    att = rs.get("attention_factor")
    if att is None:
        ms, msad = rs.get("mscale"), rs.get("mscale_all_dim")
        if ms and msad:
            att = yarn_mscale(factor, float(ms)) / yarn_mscale(
                factor, float(msad))
        else:
            att = yarn_mscale(factor)

    def correction_dim(num_rotations: float) -> float:
        return (head_dim * math.log(orig / (num_rotations * 2 * math.pi))
                ) / (2 * math.log(theta))

    low, high = correction_dim(beta_fast), correction_dim(beta_slow)
    if rs.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low = max(low, 0)
    high = min(high, head_dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(half, dtype=torch.float32, device=freqs.device)
             - low) / (high - low)).clamp(0.0, 1.0)
    return freqs / factor * ramp + freqs * (1.0 - ramp), float(att)


def rope_tables_for(cfg, positions: torch.Tensor, dtype=torch.float32):
    """rope_tables driven by a ModelConfig (theta + scaling), as
    ref_ops.py:198-210: full rotary over head_dim, or for MLA (DeepSeek)
    tables over the key's rope part alone (qk_rope_head_dim), consumed
    interleaved (:func:`apply_rope_interleaved`). Partial rotary is not
    ported."""
    if cfg.partial_rotary_factor < 1.0 and not cfg.mla:
        raise NotImplementedError("partial rotary rope tables")
    d = cfg.qk_rope_head_dim if cfg.mla else cfg.head_dim
    return rope_tables(positions, d, cfg.rope_theta, dtype,
                       rope_scaling=cfg.rope_scaling)


def rope_tables_by_sublayer(cfg, positions: torch.Tensor, wins, nope,
                            dtype=torch.float32) -> list:
    """Per-sublayer (sin, cos) for one scan period. Only uniform stacks
    are ported: one table pair shared by every sublayer."""
    if cfg.rope_local_theta is not None:
        raise NotImplementedError("rope_local_theta (Gemma-3)")
    if any(nope):
        raise NotImplementedError("NoPE layers")
    tab = rope_tables_for(cfg, positions, dtype)
    return [tab for _ in wins]


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """Half-split (NeoX/Llama-style) rotation of the last dim.

    x: [B, S, N, D]; sin/cos: [B, S, D/2] (broadcast over heads)."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    r1 = xf1 * cos - xf2 * sin
    r2 = xf2 * cos + xf1 * sin
    return torch.cat([r1, r2], dim=-1).to(x.dtype)


def apply_rope_interleaved(x: torch.Tensor, sin: torch.Tensor,
                           cos: torch.Tensor) -> torch.Tensor:
    """Interleaved (DeepSeek-style) rotation of the last dim, in f32: lane
    pairs (2i, 2i+1) are the complex components rotated by frequency i
    (ref_ops.py:288-303).

    x: [B, S, N, D]; sin/cos: [B, S, D/2] (broadcast over heads)."""
    x0 = x[..., 0::2].float()
    x1 = x[..., 1::2].float()
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    r0 = x0 * cos - x1 * sin
    r1 = x0 * sin + x1 * cos
    return torch.stack([r0, r1], dim=-1).reshape(x.shape).to(x.dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, kvN, D] -> [B, S, kvN * n_rep, D] (GQA head expansion)."""
    if n_rep == 1:
        return x
    b, s, n, d = x.shape
    return x[:, :, :, None, :].expand(b, s, n, n_rep, d).reshape(
        b, s, n * n_rep, d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor | None = None,
              scale: float | None = None,
              logit_cap: float | None = None,
              sinks: torch.Tensor | None = None) -> torch.Tensor:
    """Dense reference attention with fp32 softmax.

    q: [B, Sq, N, D]; k/v: [B, Sk, kvN, D]; mask: broadcastable to
    [B, N, Sq, Sk] (True = attend; masked logits are -1e30).
    ``logit_cap``: Gemma-2's score soft cap, cap * tanh(s / cap) on the
    f32 scores after the scale and before the mask (ref_ops.py:336-338),
    so a masked key still gets no weight. ``sinks`` [N]: GPT-OSS's
    attention sinks (ref_ops.py:339-345), a learned logit per q head that
    joins each row's softmax as one more column (neither scaled nor
    capped) and adds no value."""
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    if logit_cap:
        logits = logit_cap * torch.tanh(logits / logit_cap)
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.full((), NEG_INF, dtype=logits.dtype,
                                        device=logits.device))
    if sinks is not None:
        b, n, sq, _ = logits.shape
        col = sinks.float().to(logits.device)[None, :, None, None].expand(
            b, n, sq, 1)
        probs = torch.softmax(torch.cat([logits, col], dim=-1),
                              dim=-1)[..., :-1]
    else:
        probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnqk,bknd->bqnd", probs, v.float())
    return out.to(q.dtype)


def causal_mask(sq: int, sk: int, q_offset: int = 0,
                window: int | None = None,
                device=None) -> torch.Tensor:
    """[Sq, Sk] boolean causal mask; query i attends to keys <= q_offset + i
    (and, with ``window``, to keys with q_pos - k_pos < window)."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(sk, device=device)[None, :]
    mask = ki <= qi
    if window is not None:
        mask = mask & (ki > qi - window)
    return mask


E4M3 = torch.float8_e4m3fn


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x (f32, bf16, ...) -> float8_e4m3fn with the JAX package's cast
    (ml_dtypes and XLA: ``x.astype(jnp.float8_e4m3fn)``), byte for byte:
    round to nearest even from x's exact f32 value; |x| > 464 (past the
    tie between 448 and 480, which goes to the even 448) and NaN become
    NaN with x's sign (0x7F | sign). PyTorch's own cast does not keep to
    that across versions (2.13 saturates to +-448 on the CPU), so the
    bytes are computed here with integer operations, alike on every
    device and version: normal results round the f32 mantissa to 3 bits
    (carry into the exponent included), subnormal ones (|x| < 2^-6) are
    round_half_even(|x| * 512) units of 2^-9."""
    xf = x.float()
    sign = (xf.view(torch.int32) >> 24) & 0x80
    a = xf.abs()
    ab = a.view(torch.int32)
    normal = ((ab + 0x7FFFF + ((ab >> 20) & 1)) >> 20) - (120 << 3)
    sub = torch.round(a * 512).to(torch.int32)
    code = torch.where(a < 2.0 ** -6, sub, normal)
    code = torch.where(a <= 464, code, 0x7F) | sign   # NaN fails a <= 464
    return code.to(torch.uint8).view(E4M3)


def quantize_int8_groupwise(w: torch.Tensor, group_size: int,
                            scale_dtype=torch.float32):
    """Symmetric per-group INT8 quantization along the contraction dim.

    w: [..., K, N] -> (q: int8 [..., K, N], scales: [..., K // group, N]);
    leading dims (the stacked layer axis) pass through.
    scale = max(absmax(group) / 127, 1e-8); q = round(w / scale), ties to
    even, as jnp.round."""
    *lead, k, n = w.shape
    if k % group_size:
        raise ValueError(f"group {group_size} does not divide K={k}")
    wg = w.float().reshape(*lead, k // group_size, group_size, n)
    absmax = wg.abs().amax(dim=-2)                               # [..., G, N]
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient jnp
    # computes (quantize_kv in ops/paged_append.py does the same)
    scales = torch.clamp(absmax / torch.full_like(absmax, 127.0), min=1e-8)
    q = torch.clamp(torch.round(wg / scales[..., None, :]), -127, 127)
    return q.to(torch.int8).reshape(*lead, k, n), scales.to(scale_dtype)


def dequantize_int8_groupwise(q: torch.Tensor, scales: torch.Tensor,
                              dtype=torch.float32) -> torch.Tensor:
    """Inverse of quantize_int8_groupwise: [..., K, N] + [..., G, N]."""
    *lead, k, n = q.shape
    g = scales.shape[-2]
    wq = q.float().reshape(*lead, g, k // g, n)
    return (wq * scales.float()[..., None, :]).reshape(*lead, k, n).to(dtype)


def quantized_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                         scales: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """x @ dequant(q, scales) for one layer: x [..., K]; q [K, N] int8;
    scales [K // group, N]. Per-group partial sums in f32, each times its
    group's scale, summed in f32, then rounded once to ``out_dtype``."""
    out_dtype = out_dtype or x.dtype
    k, n = q.shape
    g = scales.shape[0]
    xg = x.float().reshape(*x.shape[:-1], g, k // g)
    if g == 1:
        out = torch.matmul(xg[..., 0, :], q.float()) * scales[0].float()
    else:
        partial = torch.einsum("...gk,gkn->...gn", xg,
                               q.float().reshape(g, k // g, n))
        out = torch.einsum("...gn,gn->...n", partial, scales.float())
    return out.to(out_dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[..., K, N] int4 values in [-8, 7] -> the split-half layout
    [..., K/2, N] int8: row i in the low nibble, row i + K/2 in the high
    (int8 ops, whose left shift wraps in two's complement as jnp's)."""
    k = q.shape[-2]
    v = q.to(torch.int8)
    return (v[..., :k // 2, :] & 0xF) | (v[..., k // 2:, :] << 4)


def quantize_int4_groupwise(w: torch.Tensor, group_size: int,
                            scale_dtype=torch.float32):
    """Symmetric per-group INT4 quantization, split-half nibble packed.

    w: [..., K, N] -> (packed: int8 [..., K/2, N], scales: [..., K//G, N]).
    scale = max(absmax(group) / 7, 1e-8); q = round(w / scale) (ties to
    even) clipped to [-7, 7]; ``packed[..., i, n]`` holds row i in its low
    nibble and row i + K/2 in its high nibble. Needs ``group_size | K/2``
    or ``group_size == K`` (per output channel), as the reference
    asserts."""
    *lead, k, n = w.shape
    if k % 2 or not (group_size == k or (k // 2) % group_size == 0):
        raise ValueError(f"split-half INT4 needs an even K and a group "
                         f"dividing K/2 (or equal to K): K={k}, group "
                         f"{group_size}")
    wg = w.float().reshape(*lead, k // group_size, group_size, n)
    absmax = wg.abs().amax(dim=-2)
    # divide by a tensor (IEEE), as quantize_int8_groupwise does
    scales = torch.clamp(absmax / torch.full_like(absmax, 7.0), min=1e-8)
    q = torch.clamp(torch.round(wg / scales[..., None, :]), -7, 7)
    return pack_int4(q.reshape(*lead, k, n)), scales.to(scale_dtype)


def _nibbles(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(low, high) nibbles of int8 bytes, sign-extended by arithmetic
    shifts on the int8 values, as the reference shifts (PyTorch's int8
    left shift wraps in two's complement)."""
    return (packed << 4) >> 4, packed >> 4


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of the split-half packing: [..., K/2, N] int8 ->
    [..., K, N] int8 in [-8, 7] (each nibble sign-extended)."""
    return torch.cat(_nibbles(packed), dim=-2)


def dequantize_int4_groupwise(packed: torch.Tensor, scales: torch.Tensor,
                              dtype=torch.float32,
                              zs: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """[..., K/2, N] packed + [..., K//G, N] scales -> [..., K, N];
    ``zs`` (AWQ/GPTQ): per-group zero * scale, w = q * s - zs, in f32."""
    w = dequantize_int8_groupwise(unpack_int4(packed), scales, torch.float32)
    if zs is not None:
        k = w.shape[-2]
        w = w - torch.repeat_interleave(zs.float(), k // zs.shape[-2],
                                        dim=-2)
    return w.to(dtype)


def quantized_matmul_int4_ref(x: torch.Tensor, packed: torch.Tensor,
                              scales: torch.Tensor, out_dtype=None,
                              zs: torch.Tensor | None = None) -> torch.Tensor:
    """x @ dequant(packed, scales, zs) for one layer, in the reference's
    math: per-group f32 partial sums of x against the unpacked codes,
    each times its scale; with ``zs`` minus rowsum_g(x) * zs[g] per
    group."""
    out = quantized_matmul_ref(x, unpack_int4(packed), scales,
                               out_dtype=torch.float32)
    if zs is not None:
        k = x.shape[-1]
        g = zs.shape[-2]
        rs = x.float().reshape(*x.shape[:-1], g, k // g).sum(-1)  # [..., G]
        out = out - torch.einsum("...g,gn->...n", rs, zs.float())
    return out.to(out_dtype or x.dtype)


def _int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer dot of int8 codes a [..., k] and b [k, n], as f32
    (rounded once, as an int32 sum converts). The products and sums run
    in f32 over chunks of at most 1024 rows, where every partial sum of
    int8 products is an integer below 2^24 (1024 * 127 * 128), so exact in
    any order; chunks add in float64. Needs TF32 off for f32 products on
    the card (PyTorch's default)."""
    k = a.shape[-1]
    if k <= 1024:
        return torch.matmul(a.float(), b.float())
    acc = None
    for c in range(0, k, 1024):
        part = torch.matmul(a[..., c:c + 1024].float(),
                            b[c:c + 1024].float()).double()
        acc = part if acc is None else acc + part
    return acc.float()


def quantized_matmul_w8a8_ref(x: torch.Tensor, q: torch.Tensor,
                              scales: torch.Tensor,
                              out_dtype=None) -> torch.Tensor:
    """W8A8 for one layer: x quantized per token to int8
    (``matmul.quantize_activations_int8``), exact integer dots per scale
    group against the int8 weight (:func:`_int_dot`), each group's sum as
    f32 times its scale, summed over the groups in order, times the row
    scale; one group at a time, so no [rows, groups, N] intermediate is
    made."""
    from simplellminference_tpu_torch.ops.matmul import (
        quantize_activations_int8)
    out_dtype = out_dtype or x.dtype
    k, n = q.shape
    g = scales.shape[0]
    gs = k // g
    xi, xs = quantize_activations_int8(x)
    out = None
    for j in range(g):
        term = _int_dot(xi[..., j * gs:(j + 1) * gs],
                        q[j * gs:(j + 1) * gs]) * scales[j].float()
        out = term if out is None else out + term
    return (out * xs).to(out_dtype)
