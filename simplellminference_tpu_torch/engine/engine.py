"""Continuous-batching engine core over the paged KV cache.

Counterpart of simplellminference_tpu/engine/engine.py:439-2096 in its
serving configuration: whole-prompt batched prefill, pipelined multi-step
decode bursts, stop tokens / stop strings / max_new_tokens, logit bias,
penalties and seeded sampling, preemption under page pressure.

Scheduling is the JAX engine's:

  * admit: WAITING requests take a free slot when the pool has pages for
    their prompt; a cycle's admits prefill as ONE batched dispatch,
    right-padded to a power-of-2 bucket (>= 16) with the row count
    quantized to {1, max_batch}; padding rows carry -1 tables (the trash
    page) and kv_len 1. The first token is sampled in the same call.
  * decode: bursts of ``decode_burst`` steps. Token, position and
    penalty-count state stay on the device between bursts; the next
    burst is dispatched before the previous one's tokens reach the host
    (copied asynchronously to pinned memory and synced one burst late),
    and host-side admits merge through per-slot override masks.
  * finish / preempt / OOM as in the JAX engine.

``_prefill_fn`` and ``_burst_fn`` (jitted graphs in the JAX engine) are
plain methods here: a Python loop over the burst steps, launching the
CUDA kernels on the card.

The engine serves whatever weights ``params`` carries (bf16/f32, or INT8
``QuantizedWeight`` leaves); like the JAX engine it never reads
``EngineConfig.quant``.

Features outside this configuration raise NotImplementedError naming the
feature: speculative decoding, guided decoding, LoRA adapters,
tensor/sequence parallelism, chunked prefill, the prefix cache (the port
never shares prompt pages), top_logprobs, quantized KV, sliding windows
and the non-Llama model branches. The JAX engine's
``forward_paged``, ``draft`` and ``loras`` constructor arguments are not
taken yet.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch

from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                      ModelConfig,
                                                      SamplingParams,
                                                      next_power_of_2)
from simplellminference_tpu_torch.core.device import resolve_device
from simplellminference_tpu_torch.engine import metrics as metrics_lib
from simplellminference_tpu_torch.engine.request import Request, RequestState
from simplellminference_tpu_torch.engine.stop import StopStringMatcher
from simplellminference_tpu_torch.memory.allocator import PageAllocator
from simplellminference_tpu_torch.memory.paged_kv import (PagedKVCache,
                                                          kv_storage_dtype)
from simplellminference_tpu_torch.models import llama
from simplellminference_tpu_torch.ops import sampling as sampling_ops


def _check_engine_config(ec: EngineConfig) -> None:
    if ec.spec_tokens:
        raise NotImplementedError("speculative decoding (spec_tokens)")
    if ec.prefill_chunk:
        raise NotImplementedError("chunked prefill (prefill_chunk)")
    if ec.prefix_cache_entries:
        raise NotImplementedError(
            "persistent prefix cache (set prefix_cache_entries=0)")
    if ec.top_logprobs:
        raise NotImplementedError("top_logprobs")
    if ec.sp_prefill_threshold:
        raise NotImplementedError("sequence-parallel prefill")
    if ec.mesh_shape and int(np.prod(list(ec.mesh_shape.values()))) > 1:
        raise NotImplementedError("tensor-parallel serving (mesh_shape)")
    if ec.kv.kv_dtype not in ("bf16", "f32"):
        raise NotImplementedError(f"{ec.kv.kv_dtype} KV cache")


class Engine:
    """Single-model continuous-batching inference engine."""

    def __init__(self, cfg: ModelConfig, params, engine_cfg: EngineConfig,
                 tokenizer=None, decode_burst: int = 4, device=None):
        """``device``: CUDA unless ``device="cpu"``; ``params`` must live
        there (``models.llama.init_params`` or
        ``models.convert.params_from_jax``)."""
        _check_engine_config(engine_cfg)
        llama.check_supported(cfg)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.ecfg = engine_cfg
        self.tokenizer = tokenizer
        self.burst = decode_burst

        kv = engine_cfg.kv
        self.allocator = PageAllocator(
            kv.num_pages, kv.page_size, engine_cfg.max_batch_size,
            kv.max_pages_per_seq)
        self.cache = PagedKVCache.create(
            cfg.num_layers, kv.num_pages, cfg.num_kv_heads, kv.page_size,
            cfg.head_dim, kv_storage_dtype(kv.kv_dtype), device=self.device)

        b = engine_cfg.max_batch_size
        self.slots: list[Optional[Request]] = [None] * b
        self.waiting: deque[Request] = deque()
        self._req_ids = itertools.count()
        self.metrics = metrics_lib.EngineMetrics()

        # host-side per-slot decode state
        self._pos = np.zeros(b, np.int32)          # next write position
        self._next_tok = np.zeros(b, np.int32)
        self._temp = np.zeros(b, np.float32)
        self._top_k = np.zeros(b, np.int32)
        self._top_p = np.ones(b, np.float32)
        self._min_p = np.zeros(b, np.float32)
        self._rep_p = np.ones(b, np.float32)
        self._freq_p = np.zeros(b, np.float32)
        self._pres_p = np.zeros(b, np.float32)
        self._seed = np.zeros(b, np.uint32)
        # OpenAI logit_bias: per-slot sparse (token, bias) rows, id -1 =
        # unused
        self._nbias = engine_cfg.max_logit_bias
        self._bias_ids = np.full((b, self._nbias), -1, np.int32)
        self._bias_vals = np.zeros((b, self._nbias), np.float32)
        # per-slot context token counts (penalty state); rebuilt from
        # prompt+outputs at admit, advanced ON DEVICE during bursts
        self._counts_host = np.zeros((b, cfg.vocab_size), np.float32)

        # burst pipeline: device-carried (token, pos, counts) from the
        # in-flight burst, host overrides for slots changed since its
        # dispatch, and the unprocessed burst output (synced one late)
        self._dev_tok = None
        self._dev_pos = None
        self._dev_counts = None
        self._override = np.zeros(b, bool)
        self._inflight = None  # ((host_rows, event), [(slot, req, n)])

        # device copies of burst arguments that rarely change, re-uploaded
        # only when dirty (admit / extend / finish)
        self._samp_dev = None
        self._samp_dirty = True
        self._tables_dev = None
        self._tables_dirty = True
        self._tables_width = 0
        self._active_dev = None
        self._active_dirty = True
        self._zero_ov = None

    # ------------- public API -------------

    def add_request(self, prompt_ids: Optional[Sequence[int]] = None,
                    prompt: Optional[str] = None,
                    sampling: SamplingParams = SamplingParams(),
                    on_tokens=None, lora: Optional[str] = None) -> Request:
        if lora is not None:
            raise NotImplementedError("LoRA adapters")
        sampling.guided_pattern()   # raises for guided decoding
        if prompt_ids is None:
            if prompt is None or self.tokenizer is None:
                raise ValueError("need prompt_ids, or prompt + tokenizer")
            prompt_ids = self.tokenizer.encode(prompt)
        if self.tokenizer is not None and not sampling.stop_token_ids \
                and self.tokenizer.eos_id >= 0:
            sampling = SamplingParams(
                **{**sampling.__dict__,
                   "stop_token_ids": (self.tokenizer.eos_id,)})
        req = Request(req_id=next(self._req_ids),
                      prompt_ids=list(prompt_ids), sampling=sampling,
                      on_tokens=on_tokens)
        if len(sampling.logit_bias) > self._nbias:
            return self._reject(req, (
                f"logit_bias has {len(sampling.logit_bias)} entries; "
                f"engine capacity is {self._nbias} "
                "(EngineConfig.max_logit_bias)"))
        if sampling.stop_strings:
            if self.tokenizer is None:
                return self._reject(req,
                                    "stop_strings require an engine tokenizer")
            req.stop_matcher = StopStringMatcher(self.tokenizer,
                                                 sampling.stop_strings)
        if len(self.waiting) >= self.ecfg.max_queue:
            return self._reject(req, "queue full")
        max_len = self.ecfg.kv.max_pages_per_seq * self.ecfg.kv.page_size
        if len(req.prompt_ids) + sampling.max_new_tokens > max_len:
            return self._reject(req, (
                f"prompt+max_new ({len(req.prompt_ids)}+"
                f"{sampling.max_new_tokens}) exceeds capacity {max_len}"))
        self.waiting.append(req)
        metrics_lib.log_event("request_added", req_id=req.req_id,
                              prompt_len=len(req.prompt_ids))
        return req

    def _reject(self, req: Request, error: str) -> Request:
        req.state = RequestState.FAILED
        req.error = error
        self.metrics.requests_failed += 1
        req.emit([], finished=True)
        return req

    @property
    def has_work(self) -> bool:
        return (bool(self.waiting) or self._inflight is not None
                or any(s is not None for s in self.slots))

    def run(self):
        """Drive until all requests complete."""
        while self.has_work:
            self.step()
        return self.metrics

    def generate(self, prompts: Sequence[Sequence[int]],
                 sampling=SamplingParams()) -> list[list[int]]:
        """Submit all, run to completion, return the generated ids.
        ``sampling``: one SamplingParams for all prompts, or one each."""
        samp = (sampling if isinstance(sampling, (list, tuple))
                else [sampling] * len(prompts))
        reqs = [self.add_request(prompt_ids=p, sampling=s)
                for p, s in zip(prompts, samp)]
        self.run()
        return [r.output_ids for r in reqs]

    # ------------- host <-> device -------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Copy a host array to the device. The copy first: the host
        mutates these arrays while earlier work may still read them, and
        ``torch.from_numpy`` aliases."""
        return torch.from_numpy(np.array(arr, copy=True)).to(self.device)

    def _to_host_async(self, t: torch.Tensor):
        """Start the device-to-host copy of a burst's output without
        waiting for it (CUDA: pinned buffer + event)."""
        if self.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return host, ev

    @staticmethod
    def _wait_host(payload) -> np.ndarray:
        host, ev = payload
        if ev is not None:
            ev.synchronize()
        return host.numpy()

    # ------------- scheduling internals -------------

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _admit(self):
        free = self._free_slots()
        admitted: list[Request] = []
        while free and self.waiting:
            req = self.waiting[0]
            slot = free[0]
            req.cached_len = 0   # no prefix sharing: whole prompts only
            if not self.allocator.alloc_seq(slot, req.total_len):
                break            # pool exhausted: wait for finishes
            self.waiting.popleft()
            free.pop(0)
            req.slot = slot
            req.state = RequestState.RUNNING
            self.slots[slot] = req
            s = req.sampling
            self._temp[slot] = s.temperature
            self._top_k[slot] = s.top_k
            self._top_p[slot] = s.top_p
            self._min_p[slot] = s.min_p
            self._rep_p[slot] = s.repetition_penalty
            self._freq_p[slot] = s.frequency_penalty
            self._pres_p[slot] = s.presence_penalty
            self._seed[slot] = np.uint32(
                s.seed if s.seed is not None
                else (0x9E3779B9 ^ req.req_id))
            self._counts_host[slot] = np.bincount(
                np.asarray(req.prompt_ids + req.output_ids, np.int64),
                minlength=self.cfg.vocab_size)[:self.cfg.vocab_size]
            self._bias_ids[slot] = -1
            self._bias_vals[slot] = 0.0
            for j, (t, v) in enumerate(s.logit_bias):
                self._bias_ids[slot, j] = int(t)
                self._bias_vals[slot, j] = float(v)
            admitted.append(req)
            metrics_lib.log_event("request_admitted", req_id=req.req_id,
                                  slot=slot, cached=0)
        if not admitted:
            return
        self._active_dirty = True
        self._tables_dirty = True
        self._samp_dirty = True
        arr = self._prefill_batch(admitted)
        for i, req in enumerate(admitted):
            tok_id = int(arr[i, 0])
            self._next_tok[req.slot] = tok_id
            self._counts_host[req.slot, tok_id] += 1
            self._override[req.slot] = True  # fresh state for the pipeline
            self._emit_tokens(req, [tok_id], [float(arr[i, 1])])

    def _prefill_batch(self, reqs: list[Request]) -> np.ndarray:
        """ONE batched whole-prompt prefill for a cycle's admits: rows
        right-padded to the longest power-of-2 bucket (>= 16), row count
        quantized to {1, max_batch}; padding rows carry -1 tables (trash
        page) and kv_len 1. Returns the host rows [len(reqs), 2]:
        (first token, its logprob)."""
        n = len(reqs)
        todo = [r.total_len for r in reqs]
        bucket = next_power_of_2(max(max(todo), 16))
        nb = 1 if n == 1 else len(self.slots)
        tokens = np.zeros((nb, bucket), np.int32)
        mp = self.allocator.max_pages_per_seq
        tables = np.full((nb, mp), -1, np.int32)
        kv_len = np.ones(nb, np.int32)
        for i, r in enumerate(reqs):
            ids = r.prompt_ids + r.output_ids
            tokens[i, :todo[i]] = ids
            tables[i] = self.allocator.row(r.slot)
            kv_len[i] = r.total_len
            self._pos[r.slot] = r.total_len
            self.metrics.prefills += 1
            self.metrics.prompt_tokens += r.total_len
        idx = np.asarray([r.slot for r in reqs] + [0] * (nb - n))
        packed = self._prefill_fn(tokens, tables, kv_len, idx)
        return packed.cpu().numpy()[:n]

    def _prefill_fn(self, tokens, tables, kv_len, idx) -> torch.Tensor:
        """Prefill forward + in-call sampling of each row's first token.
        The noise is keyed by the position of the consumed input token
        (kv_len - 1), like the burst recurrence."""
        tok_d = self._upload(tokens)
        kv_d = self._upload(kv_len)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=self.device)[None]
        logits, self.cache = llama.forward_paged(
            self.cfg, self.params, tok_d, positions, self.cache,
            self._upload(tables), kv_d, prefill=True, last_token_only=True)
        samp = self._sampler_rows(idx, with_counts=True)
        last = logits[:, -1]
        tok = sampling_ops.sample(last, seed_pos=kv_d - 1, **samp)
        lp = sampling_ops.token_logprob(last, tok)
        return torch.stack([tok.float(), lp], dim=-1)

    def _sampler_rows(self, idx, with_counts: bool) -> dict:
        """Sampler keyword arguments for slot rows ``idx``: device rows
        plus the host-side cost-tier flags."""
        kw = dict(
            temperature=self._upload(self._temp[idx]),
            top_k=self._upload(self._top_k[idx]),
            top_p=self._upload(self._top_p[idx]),
            min_p=self._upload(self._min_p[idx]),
            repetition_penalty=self._upload(self._rep_p[idx]),
            frequency_penalty=self._upload(self._freq_p[idx]),
            presence_penalty=self._upload(self._pres_p[idx]),
            seeds=self._upload(self._seed[idx].astype(np.int64)),
            all_greedy=bool((self._temp[idx] <= 0.0).all()),
            penalties_on=not bool((self._rep_p[idx] == 1.0).all()
                                  and (self._freq_p[idx] == 0.0).all()
                                  and (self._pres_p[idx] == 0.0).all()),
            shaping_on=not bool((self._top_k[idx] <= 0).all()
                                and (self._top_p[idx] >= 1.0).all()
                                and (self._min_p[idx] <= 0.0).all()))
        if with_counts:
            kw["counts"] = self._upload(self._counts_host[idx])
        if (self._bias_ids[idx] >= 0).any():
            kw["bias_ids"] = self._upload(self._bias_ids[idx])
            kw["bias_vals"] = self._upload(self._bias_vals[idx])
        return kw

    def _emit_tokens(self, req: Request, toks: list[int],
                     lps: Optional[list[float]] = None):
        """Append sampled tokens, applying stop conditions. May finish."""
        accepted = []
        finished = False
        matcher = req.stop_matcher
        for i, t in enumerate(toks):
            if (t in req.sampling.stop_token_ids
                    and not req.sampling.ignore_eos
                    and req.num_generated >= req.sampling.min_tokens):
                finished = True
                break
            req.output_ids.append(t)
            if lps is not None:
                req.output_logprobs.append(float(lps[i]))
            accepted.append(t)
            if matcher is not None and matcher.push(t):
                # stop string completed: text is truncated exactly at the
                # match (may be mid-token); final_text is authoritative
                req.final_text = matcher.final_text
                req.final_ids_len = matcher.released_count()
                finished = True
                break
            if req.num_generated >= req.sampling.max_new_tokens:
                finished = True
                break
        self.metrics.tokens_generated += len(accepted)
        if matcher is not None:
            accepted = matcher.release(finished)
        req.emit(accepted, finished)
        if finished:
            self._finish(req)

    def _release_slot_bias(self, slot: int):
        """Drop a departing request's logit_bias rows so bias-free
        batches return to the scatter-free sampler."""
        if slot >= 0 and (self._bias_ids[slot] >= 0).any():
            self._bias_ids[slot] = -1
            self._bias_vals[slot] = 0.0
            self._samp_dirty = True

    def _finish(self, req: Request):
        req.state = RequestState.FINISHED
        self._release_slot_bias(req.slot)
        self.allocator.free_seq(req.slot)
        self.slots[req.slot] = None
        self._active_dirty = True
        self._tables_dirty = True
        self.metrics.requests_finished += 1
        if req.ttft is not None:
            self.metrics.ttfts.append(req.ttft)
        metrics_lib.log_event("request_finished", req_id=req.req_id,
                              generated=req.num_generated)
        req.slot = -1

    def _preempt_youngest(self) -> bool:
        """Reclaim the youngest running request's pages; requeue it."""
        running = [s for s in self.slots if s is not None]
        if len(running) <= 1:
            return False
        victim = max(running, key=lambda r: r.req_id)
        self._release_slot_bias(victim.slot)
        self.allocator.free_seq(victim.slot)
        self.slots[victim.slot] = None
        self._active_dirty = True
        self._tables_dirty = True
        victim.slot = -1
        victim.state = RequestState.PREEMPTED
        victim.preempt_count += 1
        self.waiting.appendleft(victim)
        self.metrics.preemptions += 1
        metrics_lib.log_event("request_preempted", req_id=victim.req_id)
        return True

    def _ensure_burst_pages(self) -> bool:
        """Extend every running slot's pages to cover the pipeline depth:
        host ``_pos`` lags the device position by up to one unprocessed
        burst, and the burst about to dispatch advances one more."""
        while True:
            ok = True
            for req in list(self.slots):
                if req is None:
                    continue
                # clamp to the request's lifetime maximum
                lim = len(req.prompt_ids) + req.sampling.max_new_tokens
                target = min(int(self._pos[req.slot]) + 2 * self.burst + 1,
                             lim)
                cur = self.allocator.seq_len(req.slot)
                if cur < target:
                    if not self.allocator.extend(req.slot, target):
                        ok = False
                        break
                    # re-upload the tables only when the PAGE map grew
                    ps = self.ecfg.kv.page_size
                    if -(-target // ps) != -(-cur // ps):
                        self._tables_dirty = True
            if ok:
                return True
            if not self._preempt_youngest():
                return False

    def step(self):
        """One scheduling iteration: admit → dispatch burst N+1 → process
        burst N (its output syncs one burst late)."""
        self._admit()
        running = [r for r in self.slots if r is not None]
        if not running:
            self._process_inflight()
            if any(s is not None for s in self.slots) or not self.waiting:
                return
            self._admit()  # the drain may have freed pages
            if any(s is not None for s in self.slots):
                return
            # nothing running but the head request cannot be admitted:
            # hard OOM for it — fail it rather than livelock
            req = self.waiting.popleft()
            self._reject(req, "prompt does not fit in KV page pool")
            return
        if self._inflight is not None:
            got = {id(req): n for _s, req, n in self._inflight[1]}
            if all(r.sampling.max_new_tokens - r.num_generated
                   <= got.get(id(r), 0) for r in running):
                # the in-flight burst already finishes every running
                # request — don't dispatch a burst of pure waste
                self._process_inflight()
                return
        if not self._ensure_burst_pages():
            self._process_inflight()  # finishes may free pages
            if not self._ensure_burst_pages():
                running = [r for r in self.slots if r is not None]
                if not running:
                    return
                victim = max(running, key=lambda r: r.total_len)
                self.allocator.free_seq(victim.slot)
                self.slots[victim.slot] = None
                self._active_dirty = True
                self._tables_dirty = True
                self._reject(victim, "KV page pool exhausted")
                return

        # _ensure_burst_pages may have preempted members of `running`
        running = [r for r in self.slots if r is not None]
        if not running:
            self._process_inflight()
            return
        steps = self.burst
        active, tables, samp = self._dispatch_args(running)
        if self._dev_tok is None:
            dev_tok = self._upload(self._next_tok)
            dev_pos = self._upload(self._pos)
            dev_counts = torch.zeros(self._counts_host.shape,
                                     dtype=torch.float32, device=self.device)
            ov_mask = np.ones(len(self.slots), bool)
            any_ov = True
        else:
            dev_tok, dev_pos = self._dev_tok, self._dev_pos
            dev_counts = self._dev_counts
            ov_mask = self._override
            any_ov = bool(ov_mask.any())
        if any_ov:
            ov = (self._upload(self._next_tok), self._upload(self._pos),
                  self._upload(self._counts_host), self._upload(ov_mask))
        else:
            ov = self._get_zero_ov()
        packed, self._dev_tok, self._dev_pos, self._dev_counts = \
            self._burst_fn(steps, dev_tok, dev_pos, dev_counts, *ov, tables,
                           active, samp)
        payload = self._to_host_async(packed)
        self._override[:] = False
        self.metrics.decode_bursts += 1
        prev = self._inflight
        self._inflight = (payload, [(r.slot, r, steps) for r in running])
        if prev is not None:
            self._bookkeep(*prev)
        self.metrics.observe_step(
            busy_slots=len(running), total_slots=len(self.slots),
            used_pages=self.ecfg.kv.num_pages - self.allocator.num_free,
            total_pages=self.ecfg.kv.num_pages)

    def _burst_fn(self, steps, dev_tok, dev_pos, dev_counts, ov_tok, ov_pos,
                  ov_counts, ov_mask, tables, active, samp):
        """``steps`` decode steps of every slot. dev_* come back from the
        previous burst (possibly still running on the device); ov_*
        override the slots the host changed since. Returns (packed rows
        [B, steps, 2] of (token, logprob), token, pos, counts)."""
        tok = torch.where(ov_mask, ov_tok, dev_tok)
        pos = torch.where(ov_mask, ov_pos, dev_pos)
        counts = torch.where(ov_mask[:, None], ov_counts, dev_counts)
        pen_on = samp["penalties_on"]
        rows = torch.arange(tok.shape[0], device=self.device)
        live = active.to(torch.int32)
        out = []
        for _ in range(steps):
            logits, self.cache = llama.forward_paged(
                self.cfg, self.params, tok[:, None], pos[:, None],
                self.cache, tables, pos + 1, prefill=False)
            nxt = sampling_ops.sample(logits[:, 0], counts=counts,
                                      seed_pos=pos, **samp)
            nxt = torch.where(active, nxt, torch.zeros_like(nxt))
            lp = sampling_ops.token_logprob(logits[:, 0], nxt)
            if pen_on:
                counts.index_put_((rows, nxt.long()), active.float(),
                                  accumulate=True)
            pos = pos + live
            tok = nxt
            out.append(torch.stack([nxt.float(), lp], dim=-1))
        return torch.stack(out, dim=1), tok, pos, counts

    def _dispatch_args(self, running):
        """Device-cached burst arguments, re-uploaded only when dirty:
        (active mask, tables, sampler kwargs)."""
        if self._active_dirty or self._active_dev is None:
            self._active_dev = self._upload(
                np.asarray([s is not None for s in self.slots], bool))
            self._active_dirty = False
        max_len = max(self.allocator.seq_len(r.slot) for r in running)
        self._ensure_tables(max_len)
        if self._samp_dirty or self._samp_dev is None:
            self._samp_dev = self._sampler_rows(
                np.arange(len(self.slots)), with_counts=False)
            self._samp_dirty = False
        return self._active_dev, self._tables_dev, self._samp_dev

    def _ensure_tables(self, width_tokens: int):
        """Refresh the device tables snapshot, sliced to a power-of-2
        page-column width covering ``width_tokens`` (the decode kernel
        reads only live pages, but a narrow table keeps the uploads and
        the plain version's gather small)."""
        ps = self.ecfg.kv.page_size
        mp = self.allocator.max_pages_per_seq
        need = max(-(-width_tokens // ps), 1)
        width = 1
        while width < need:
            width *= 2
        width = min(width, mp)
        if (self._tables_dirty or self._tables_dev is None
                or self._tables_width != width):
            self._tables_dev = self._upload(self.allocator.table()[:, :width])
            self._tables_width = width
            self._tables_dirty = False

    def _get_zero_ov(self):
        """(tok, pos, counts, mask) no-op overrides — device-resident so
        an override-free burst uploads nothing."""
        if self._zero_ov is None:
            b = len(self.slots)
            z = torch.zeros(b, dtype=torch.int32, device=self.device)
            self._zero_ov = (z, z, torch.zeros(self._counts_host.shape,
                                               dtype=torch.float32,
                                               device=self.device),
                             torch.zeros(b, dtype=torch.bool,
                                         device=self.device))
        return self._zero_ov

    def _process_inflight(self):
        """Drain the pipeline: sync + bookkeep the in-flight burst."""
        if self._inflight is None:
            return
        payload, snapshot = self._inflight
        self._inflight = None
        self._bookkeep(payload, snapshot)

    def _bookkeep(self, payload, snapshot):
        arr = self._wait_host(payload)   # [B, burst, 2] — the sync point
        toks = arr[..., 0].astype(np.int64)
        blps = arr[..., 1]
        for slot, req, n_valid in snapshot:
            # skip slots whose request was replaced/finished since dispatch
            if self.slots[slot] is not req \
                    or req.state != RequestState.RUNNING:
                continue
            burst_toks = toks[slot][:n_valid].tolist()
            self._emit_tokens(req, burst_toks, blps[slot][:n_valid].tolist())
            if req.state == RequestState.RUNNING:
                self._pos[slot] += n_valid
                self._next_tok[slot] = burst_toks[-1]
