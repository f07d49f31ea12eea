"""Token sampling on the device: greedy, temperature, top-k, top-p, min-p,
repetition / frequency / presence penalties and logit bias, and the
speculative acceptance and residual draws.

Counterpart of simplellminference_tpu/ops/sampling.py:18-296 with the same
semantics and cost tiers (all-greedy batches pay one argmax; sampling
without top-k/top-p/min-p pays a sort-free Gumbel-max; only shaping
filters pay the [B, V] sort). The JAX package chooses a tier in-graph
with ``lax.cond``; here the caller may pass the tier as host-side flags
(the engine knows them from its host arrays), so choosing costs no
device-to-host sync.

Random bits: a seeded row draws Gumbel noise from a counter-based hash of
(seed, position, token id) — the role of the JAX package's
``fold_in(fold_in(key, seed), position)`` threefry keys, and like them
independent of batch composition. The speculative draws key (seed,
position) on streams of their own (:func:`spec_row_keys`). The bits differ
from JAX's, so only greedy rows are token-exact across the two packages;
sampled rows agree in distribution. CPU and CUDA give the same bits.
"""

from __future__ import annotations

from typing import Optional

import torch

_M32 = 0xFFFFFFFF


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis. logits: [..., V] -> [...] int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def apply_penalties(logits, counts, repetition_penalty, frequency_penalty,
                    presence_penalty) -> torch.Tensor:
    """HF/OpenAI-style penalties from per-row token counts [B, V]:
    repetition divides seen positive logits by rp (multiplies negative);
    frequency/presence subtract fp*count + pp*seen."""
    lf = logits.float()
    seen = counts > 0
    rp = repetition_penalty[:, None]
    penalized = torch.where(lf > 0, lf / rp, lf * rp)
    lf = torch.where(seen, penalized, lf)
    return lf - (frequency_penalty[:, None] * counts.float()
                 + presence_penalty[:, None] * seen.float())


def apply_logit_bias(logits, bias_ids, bias_vals) -> torch.Tensor:
    """OpenAI-style logit_bias: sparse per-row (token id, bias) pairs
    [B, K], id -1 = unused slot. logits [B, V], or [B, S, V] (the same
    row bias at every window position) -> biased f32 logits."""
    v = logits.shape[-1]
    safe = bias_ids.long().clamp(0, v - 1)
    vals = torch.where(bias_ids >= 0, bias_vals.float(),
                       torch.zeros((), device=logits.device))
    if logits.ndim == 3:
        s = logits.shape[1]
        safe = safe[:, None].expand(-1, s, -1)
        vals = vals[:, None].expand(-1, s, -1)
    return logits.float().scatter_add(-1, safe, vals)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without int64
    overflow (the constant is split into 16-bit halves)."""
    lo = (x * (c & 0xFFFF)) & _M32
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer mixer (lowbias32) on int64 tensors in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _row_keys(seeds: torch.Tensor, seed_pos: torch.Tensor) -> torch.Tensor:
    """[B] 32-bit keys (int64) of (seed, position)."""
    s = _hash32(seeds.long() & _M32)
    p = _hash32((seed_pos.long() & _M32) ^ 0x9E3779B9)
    return _hash32(s ^ _mul32(p, 0x85EBCA6B))


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    """f32 uniforms in (0, 1) from the top 24 of 32 hashed bits."""
    return ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))


def _gumbel(keys: torch.Tensor, v: int) -> torch.Tensor:
    """[B, V] f32 Gumbel noise keyed by (row key, token id)."""
    tok = torch.arange(v, dtype=torch.int64, device=keys.device)[None]
    u = _uniform(_hash32(keys[:, None] ^ _hash32(tok ^ 0x68E31DA4)))
    return -torch.log(-torch.log(u))


def row_gumbel(seeds: torch.Tensor, seed_pos: torch.Tensor,
               v: int) -> torch.Tensor:
    """[B, V] f32 Gumbel noise keyed by (seed, position, token id)."""
    return _gumbel(_row_keys(seeds, seed_pos), v)


def spec_row_keys(seeds: torch.Tensor, seed_pos: torch.Tensor,
                  tag: int) -> torch.Tensor:
    """[B] keys for the speculative accept/residual draws: the (seed,
    position) key mixed with a stream ``tag`` (1: the acceptance uniform,
    2: the residual draw), so neither shares bits with the other or with
    the plain path's draw at the same position (simplellminference_tpu/
    ops/sampling.py:162-170)."""
    tag_bits = _hash32(torch.full_like(seeds, tag, dtype=torch.int64)
                       ^ 0x3C6EF372)
    return _hash32(_row_keys(seeds, seed_pos) ^ _mul32(tag_bits, 0xC2B2AE35))


def row_uniform(keys: torch.Tensor) -> torch.Tensor:
    """[B] f32 uniforms in (0, 1), one per row key (the role of
    ``jax.random.uniform`` on a key)."""
    return _uniform(_hash32(keys ^ 0x27D4EB2F))


def _shaped(logits, temperature, top_k, top_p, min_p) -> torch.Tensor:
    """Temperature-scaled logits with top-k, then top-p on the renormalized
    survivors, then min-p applied; filtered entries are -inf. Token order
    (the JAX package works in sorted space and scatters back). The sort is
    the JAX package's (sampling.py:89-92): ascending and stable, then
    reversed, so tied logits rank in descending token id and a cut inside
    a tie keeps the same tokens in both packages."""
    b, v = logits.shape
    t = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = logits.float() / t
    sv, si = torch.sort(scaled, dim=-1, stable=True)
    sv, si = sv.flip(-1), si.flip(-1)
    rank = torch.arange(v, device=logits.device)[None]
    k_eff = torch.where(top_k > 0, top_k.long(), torch.full_like(
        top_k.long(), v))[:, None]
    keep = rank < k_eff
    probs = torch.softmax(torch.where(keep, sv, torch.full_like(
        sv, float("-inf"))), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = keep & (cum - probs < top_p[:, None])
    keep = keep & (probs >= min_p[:, None] * probs[:, :1])
    masked = torch.where(keep, sv, torch.full_like(sv, float("-inf")))
    return torch.full_like(scaled, float("-inf")).scatter(-1, si, masked)


def _shaped_or_scaled(logits, temperature, top_k, top_p, min_p,
                      shaping_on: Optional[bool]) -> torch.Tensor:
    """The shaped logits of :func:`_shaped`, or only temperature-scaled
    where no row filters (``shaping_on`` False; None reads the tensors)."""
    if shaping_on is None:
        shaping_on = not bool((top_k <= 0).all() & (top_p >= 1.0).all()
                              & (min_p <= 0.0).all())
    if shaping_on:
        return _shaped(logits, temperature, top_k, top_p, min_p)
    return logits.float() / torch.clamp(temperature, min=1e-6)[:, None]


def shaped_token_prob(logits: torch.Tensor, tok: torch.Tensor,
                      temperature: torch.Tensor, top_k: torch.Tensor,
                      top_p: torch.Tensor, min_p: torch.Tensor,
                      shaping_on: Optional[bool] = None) -> torch.Tensor:
    """P(tok) under the shaped sampling distribution (temperature, then
    top-k/top-p/min-p, renormalized): the acceptance probability of a
    drafted token in speculative rejection sampling (a point-mass
    proposal is accepted with probability p_target(tok)). logits [B, V],
    tok [B] -> [B] f32 (0 for a filtered-out token)."""
    shaped = _shaped_or_scaled(logits, temperature, top_k, top_p, min_p,
                               shaping_on)
    probs = torch.softmax(shaped, dim=-1)
    return probs.gather(-1, tok.long()[:, None])[:, 0]


def sample_excluding(logits: torch.Tensor, temperature: torch.Tensor,
                     top_k: torch.Tensor, top_p: torch.Tensor,
                     min_p: torch.Tensor, exclude: torch.Tensor,
                     keys: torch.Tensor,
                     shaping_on: Optional[bool] = None) -> torch.Tensor:
    """Draw from the shaped distribution with token ``exclude`` removed
    and renormalized: the residual draw after a speculative rejection
    (for a point-mass proposal at d, max(0, p - q) / Z is p conditioned
    on != d). ``exclude`` [B] (-1: nothing); ``keys`` [B] from
    :func:`spec_row_keys`. A row whose support the exclusion empties
    draws from the full shaped row. Gumbel-max in token order. -> [B]
    int32."""
    shaped = _shaped_or_scaled(logits, temperature, top_k, top_p, min_p,
                               shaping_on)
    v = shaped.shape[-1]
    tok = torch.arange(v, device=shaped.device)[None]
    excluded = torch.where(tok == exclude.long()[:, None],
                           torch.full_like(shaped, float("-inf")), shaped)
    ok = (excluded > float("-inf")).any(dim=-1, keepdim=True)
    shaped = torch.where(ok, excluded, shaped)
    return torch.argmax(shaped + _gumbel(keys, v), dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, temperature: torch.Tensor,
           top_k: torch.Tensor, top_p: torch.Tensor,
           min_p: Optional[torch.Tensor] = None,
           counts: Optional[torch.Tensor] = None,
           repetition_penalty: Optional[torch.Tensor] = None,
           frequency_penalty: Optional[torch.Tensor] = None,
           presence_penalty: Optional[torch.Tensor] = None,
           seeds: Optional[torch.Tensor] = None,
           seed_pos: Optional[torch.Tensor] = None,
           bias_ids: Optional[torch.Tensor] = None,
           bias_vals: Optional[torch.Tensor] = None,
           all_greedy: Optional[bool] = None,
           penalties_on: Optional[bool] = None,
           shaping_on: Optional[bool] = None) -> torch.Tensor:
    """Batched sampling with per-row params. logits [B, V]; the sampler
    rows are [B] tensors (temperature <= 0: greedy row; top_k == 0,
    top_p >= 1, min_p <= 0 disable their filters). ``counts`` [B, V] with
    the penalty vectors enables the penalties (greedy rows included);
    ``bias_ids``/``bias_vals`` [B, K] add logit_bias to the raw logits.
    ``seeds``/``seed_pos`` [B] key each row's noise by (seed, position);
    sampled (temperature > 0) rows need them.

    ``all_greedy`` / ``penalties_on`` / ``shaping_on``: the cost tier, as
    host booleans; each one left None is read from the tensors (a
    device sync on CUDA). Returns [B] int32 token ids."""
    b, v = logits.shape
    if bias_ids is not None:
        logits = apply_logit_bias(logits, bias_ids, bias_vals)
    if min_p is None:
        min_p = torch.zeros(b, device=logits.device)
    if counts is None:
        penalties_on = False
    elif penalties_on is None:
        penalties_on = not bool(
            (repetition_penalty == 1.0).all()
            & (frequency_penalty == 0.0).all()
            & (presence_penalty == 0.0).all())
    if all_greedy is None:
        all_greedy = bool((temperature <= 0.0).all())
    if all_greedy and not penalties_on:
        return greedy(logits)
    lf = (apply_penalties(logits, counts, repetition_penalty,
                          frequency_penalty, presence_penalty)
          if penalties_on else logits.float())
    gr = greedy(lf)
    if all_greedy:
        return gr
    shaped = _shaped_or_scaled(lf, temperature, top_k, top_p, min_p,
                               shaping_on)
    if seeds is None:
        raise ValueError("sampled rows need seeds and seed_pos")
    g = row_gumbel(seeds, seed_pos, v)
    s = torch.argmax(shaped + g, dim=-1).to(torch.int32)
    return torch.where(temperature <= 0.0, gr, s)


def token_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """log P(tok) under the model's raw distribution. logits [B, V],
    tok [B] -> [B] f32."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    return lf.gather(-1, tok.long()[:, None])[:, 0] - lse
