"""Single-model generation over the dense KV arena: batched prefill, then
decode steps.

Counterpart of simplellminference_tpu/runtime/generator.py:54
(``Generator``) with ``_sample_and_count`` (:34). Prompts are right-padded
to a power-of-two bucket and prefilled in one forward; the arena is sized
to the bucket plus the new tokens, rounded up to 256 slots. Each step is
the dense :func:`~simplellminference_tpu_torch.models.llama.forward` on
the card (kernels ``kv_append``, ``flash_decode`` and, with INT8
per-channel weights, the dense ``fused_qkv_append``; a sliding window or
Gemma-2's soft cap takes their window and capped forms, each layer its
own window, so Mistral and Gemma-2 run here as on the Engine). An FP8
arena (``kv_dtype=torch.float8_e4m3fn``, as JAX's Generator takes any
arena dtype) takes the kernels' e4m3 forms: ``kv_append`` (12e) rounds the
new rows into codes, the fused qkv (6de) its f32 k/v, ``flash_decode``
(13e and its window, capped and sink forms) reads them exactly; the
prefill still attends its fresh rows.

- :meth:`Generator.generate` is the Python loop with host control per
  step (stop tokens), sampling with the port's counter-hash sampler:
  greedy rows are token-exact with the JAX package, sampled rows agree in
  distribution. A row's draw at position p is keyed by (its seed, p).
- :meth:`Generator.generate_fused` is bench.py's peak-throughput loop
  (one jit with a ``lax.scan`` in the JAX package): greedy, and no host
  sync between the prefill and the end: tokens stay on the device and
  the result is one [B, T] device tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from simplellminference_tpu_torch.core.config import (ModelConfig,
                                                      SamplingParams,
                                                      next_power_of_2)
from simplellminference_tpu_torch.core.device import (resolve_device,
                                                      torch_dtype)
from simplellminference_tpu_torch.models import llama
from simplellminference_tpu_torch.ops import sampling as sampling_ops
from simplellminference_tpu_torch.runtime.kv_cache import DenseKVCache

_GOLDEN = 0x9E3779B9


@dataclasses.dataclass
class GenerateResult:
    token_ids: list[list[int]]      # per sequence, generated tokens only
    prompt_lens: list[int]
    steps: int


class Generator:
    """Greedy/sampled generation over a dense KV cache (single model)."""

    def __init__(self, cfg: ModelConfig, params, max_batch: int = 1,
                 max_seq: Optional[int] = None, kv_dtype=None,
                 device=None):
        """``device``: CUDA unless ``device="cpu"``; ``params`` must live
        there. ``kv_dtype``: the arena's dtype (default the model's;
        ``torch.float8_e4m3fn`` for FP8 KV: the e4m3 forms 12e, 13e and
        6de write and read it)."""
        llama.check_supported(cfg)
        if cfg.mla:
            raise NotImplementedError("the Generator under MLA (the dense "
                                      "arena's latent rows)")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"generator on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq or cfg.max_seq_len
        self.kv_dtype = torch_dtype(kv_dtype or cfg.dtype)
        if self.kv_dtype == torch.int8:
            # JAX's dense arena has no scale pools: an int8 arena would
            # hold values cast to int8, not quantized KV
            raise NotImplementedError("INT8 KV on the dense arena (no "
                                      "scale pools; a paged-pool path)")

    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def new_cache(self, batch: int,
                  seq_len: Optional[int] = None) -> DenseKVCache:
        """``seq_len``: the workload's true bound (prompt bucket +
        max_new); the arena is sized to it, rounded up to 256 slots, and
        at most ``max_seq``."""
        c = self.cfg
        s = self.max_seq if seq_len is None else min(
            self.max_seq, -(-seq_len // 256) * 256)
        return DenseKVCache.create(c.num_layers, batch, s, c.num_kv_heads,
                                   c.head_dim, self.kv_dtype,
                                   device=self.device)

    def _bucket(self, prompts) -> tuple[np.ndarray, list[int]]:
        """Prompts right-padded to a power-of-two bucket (at most
        ``max_seq``): (tokens [B, bucket] int32, lengths)."""
        lens = [len(p) for p in prompts]
        if max(lens) > self.max_seq:
            raise ValueError(f"a prompt of {max(lens)} tokens exceeds "
                             f"max_seq {self.max_seq}")
        bucket = min(next_power_of_2(max(lens)), self.max_seq)
        tokens = np.zeros((len(prompts), bucket), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = np.asarray(p, np.int32)
        return tokens, lens

    def _prefill_fn(self, tokens, cache, kv_lens):
        """One batched forward of right-padded prompts from slot 0: the
        last valid token's logits [B, V]."""
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=self.device)[None].expand(b, s)
        offsets = torch.zeros(b, dtype=torch.int32, device=self.device)
        logits, cache = llama.forward(self.cfg, self.params, tokens,
                                      positions, cache, offsets, kv_lens,
                                      last_token_only=True)
        return logits[:, -1], cache

    def _decode_fn(self, tok, pos, cache):
        """One decode step of tokens ``tok`` [B] at positions ``pos`` [B]:
        logits [B, V]."""
        logits, cache = llama.forward(self.cfg, self.params, tok[:, None],
                                      pos[:, None], cache, pos, pos + 1)
        return logits[:, -1], cache

    def prefill(self, cache: DenseKVCache, prompts: Sequence[Sequence[int]]):
        """Right-pad prompts to a bucket, run one batched forward.
        Returns (last-token logits [B, V], cache, prompt_lens)."""
        tokens, lens = self._bucket(prompts)
        logits, cache = self._prefill_fn(self._tensor(tokens), cache,
                                         self._tensor(lens))
        return logits, cache, lens

    def generate(self, prompts: Sequence[Sequence[int]],
                 params: SamplingParams = SamplingParams()) -> GenerateResult:
        """Python-loop generation (per-step host control: stop tokens)."""
        b = len(prompts)
        need = max(len(p) for p in prompts) + params.max_new_tokens
        if need > self.max_seq:
            raise ValueError(
                f"prompt+max_new_tokens ({need}) exceeds the KV arena "
                f"capacity ({self.max_seq}); raise max_seq or shorten the "
                "request")
        bucket = min(next_power_of_2(max(len(p) for p in prompts)),
                     self.max_seq)
        cache = self.new_cache(b, bucket + params.max_new_tokens)
        last_logits, cache, lens = self.prefill(cache, prompts)
        pick = self.sampler(prompts, params)
        out: list[list[int]] = [[] for _ in range(b)]
        done = np.zeros(b, bool)
        stop = set(params.stop_token_ids)
        pos = self._tensor(lens)
        next_tok = pick(last_logits, pos - 1)
        steps = 0
        for _ in range(params.max_new_tokens):
            ids = next_tok.cpu().numpy()
            for i in range(b):
                if not done[i]:
                    out[i].append(int(ids[i]))
                    if int(ids[i]) in stop:
                        done[i] = True
            steps += 1
            if done.all() or steps >= params.max_new_tokens:
                break
            logits, cache = self._decode_fn(next_tok, pos, cache)
            next_tok = pick(logits, pos)
            pos = pos + 1
        return GenerateResult(token_ids=out, prompt_lens=lens, steps=steps)

    def sampler(self, prompts, params: SamplingParams):
        """``pick(logits [B, V], seed_pos [B]) -> [B] int32``: the sampler
        of ``params`` for every row; with penalties it carries the rows'
        token counts (prompt included) and adds each pick, as
        ``_sample_and_count`` does. Row r's seed mixes ``params.seed``
        with r, so rows of one batch draw independently."""
        b, v = len(prompts), self.cfg.vocab_size

        def full(x, dt=torch.float32):
            return torch.full((b,), x, dtype=dt, device=self.device)

        seed = params.seed or 0
        kw = dict(temperature=full(params.temperature),
                  top_k=full(params.top_k, torch.int32),
                  top_p=full(params.top_p), min_p=full(params.min_p),
                  seeds=self._tensor((np.arange(b, dtype=np.int64) * _GOLDEN
                                      + seed) % (1 << 32), torch.int64),
                  all_greedy=params.greedy,
                  shaping_on=not (params.top_k <= 0 and params.top_p >= 1.0
                                  and params.min_p <= 0.0))
        if params.penalties_neutral:
            if params.greedy:
                return lambda logits, _pos: sampling_ops.greedy(logits)
            return lambda logits, pos: sampling_ops.sample(
                logits, seed_pos=pos, penalties_on=False, **kw)
        counts = self._tensor(np.stack([
            np.bincount(np.asarray(p, np.int64), minlength=v)[:v]
            for p in prompts]), torch.float32)
        rows = torch.arange(b, device=self.device)
        pen = dict(repetition_penalty=full(params.repetition_penalty),
                   frequency_penalty=full(params.frequency_penalty),
                   presence_penalty=full(params.presence_penalty))

        def pick(logits, pos):
            tok = sampling_ops.sample(logits, seed_pos=pos, counts=counts,
                                      penalties_on=True, **pen, **kw)
            counts.index_put_((rows, tok.long()),
                              torch.ones(b, device=self.device),
                              accumulate=True)
            return tok

        return pick

    def generate_fused(self, prompts: Sequence[Sequence[int]],
                       max_new_tokens: int) -> torch.Tensor:
        """Prefill + ``max_new_tokens`` greedy decode steps with no host
        sync between them (bench.py's fused loop). Returns [B,
        max_new_tokens] int32 on the device."""
        b = len(prompts)
        if max(len(p) for p in prompts) + max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt+max_new_tokens "
                f"({max(len(p) for p in prompts) + max_new_tokens}) exceeds "
                f"the KV arena capacity ({self.max_seq})")
        tokens, lens = self._bucket(prompts)
        return self._fused_generate(self._tensor(tokens),
                                    self._tensor(lens), max_new_tokens)

    def _fused_generate(self, tokens: torch.Tensor, kv_lens: torch.Tensor,
                        max_new_tokens: int) -> torch.Tensor:
        """The device part of :meth:`generate_fused` (the JAX package's
        jit of the same name): right-padded ``tokens`` [B, bucket] and
        ``kv_lens`` [B] already on the device; every step's inputs stay
        there, so nothing here waits for the device."""
        b, bucket = tokens.shape
        cache = self.new_cache(b, bucket + max_new_tokens)
        logits, cache = self._prefill_fn(tokens, cache, kv_lens)
        return self._decode_steps(sampling_ops.greedy(logits),
                                  kv_lens.to(torch.int32), cache,
                                  max_new_tokens)

    def _decode_steps(self, tok: torch.Tensor, pos: torch.Tensor, cache,
                      n: int) -> torch.Tensor:
        """``n`` greedy decode steps from tokens ``tok`` [B] at positions
        ``pos`` [B] on the device: [B, n] int32, ``tok`` first."""
        out = torch.empty((tok.shape[0], n), dtype=torch.int32,
                          device=tok.device)
        for t in range(n):
            out[:, t] = tok
            logits, cache = self._decode_fn(tok, pos, cache)
            tok = sampling_ops.greedy(logits)
            pos = pos + 1
        return out
