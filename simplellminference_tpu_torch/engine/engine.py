"""Continuous-batching engine core over the paged KV cache.

Counterpart of simplellminference_tpu/engine/engine.py:439-2096 in its
serving configuration: whole-prompt batched prefill, chunked prefill, the
prefix cache (running-request page sharing and the persistent store of
finished prompts), pipelined multi-step decode bursts, prompt-lookup
speculative decoding (``spec_tokens``), stop tokens / stop strings /
max_new_tokens, logit bias, penalties and seeded sampling, preemption
under page pressure, ``cancel`` and ``flush_prefix_cache``.

Scheduling is the JAX engine's:

  * admit: WAITING requests take a free slot when the pool has pages for
    their prompt. A prompt first shares the complete pages of its longest
    page-aligned prefix with a running request, or attaches them from a
    retained prefix handle (whichever covers more), and allocates only the
    rest; under pool pressure retained prefixes are evicted (LRU) before
    live work waits. Dispatch order is dependency order: the cycle's
    uncached admits prefill as ONE batched dispatch, right-padded to a
    power-of-2 bucket (>= 16) with the row count quantized to
    {1, max_batch}; then each prompt longer than ``prefill_chunk`` runs
    its chunk loop; then the prefix-cached admits prefill their suffixes
    as one batched dispatch at per-row page offsets. Padding rows carry -1
    tables (the trash page) and kv_len 1. The first token is sampled in
    the same call, and one host sync reads every admit's.
  * finish: a finishing request's full prompt pages are detached into the
    persistent store (refcounted allocator handles, at most
    ``prefix_cache_entries``, LRU) before its slot is freed.
  * decode: bursts of ``decode_burst`` steps. Token, position and
    penalty-count state stay on the device between bursts; the next
    burst is dispatched before the previous one's tokens reach the host
    (copied asynchronously to pinned memory and synced one burst late),
    and host-side admits merge through per-slot override masks.
  * speculative decode (``EngineConfig.spec_tokens`` = G in [1, 7]):
    each burst step drafts G tokens by prompt lookup (the latest earlier
    occurrence of the context's last ``spec_ngram``-gram, from a token
    history carried on the device), verifies G+1 positions in one
    forward (``paged_append_span`` writes their K/V, ``paged_flash_verify``
    attends them) and emits the accepted prefix plus one token: greedy
    rows accept by equality with the argmax, sampled penalty-free rows by
    rejection sampling against the shaped distribution, rows with
    penalties take one sampled token per step.
  * draft-model speculation (``draft=(draft_cfg, draft_params)``, with
    ``spec_tokens``): the prompt-lookup draft gives way to a greedy
    G+1-step rollout of the draft model's dense ``forward`` over its own
    arena [L, B+1, kvN, cap, D] (row B is the trash row for padding),
    indexed by absolute position: a rejected draft's stale entries sit at
    or past kv_len and are never rolled back. Admits prefill the draft
    over the whole context from position 0 (no prefix cache, no chunks).
  * finish / preempt / OOM as in the JAX engine.

``_prefill_fn``, ``_prefill_chunk_fn``, ``_burst_fn`` and
``_spec_burst_fn`` (jitted graphs in the JAX engine) are plain methods
here: a Python loop over the burst
steps, launching the CUDA kernels on the card, all on one stream, so
launch order is the dependency order above. Suffix buckets and chunk
steps are not raised to 128 rows as the JAX engine does on a TPU
(engine.py:1364-1369, :1550-1551): that floor serves the Pallas kernel's
Sq % 128 gate, and the port's ``paged_flash_prefill`` takes any Sq.

The engine serves whatever weights ``params`` carries (bf16/f32, or INT8
``QuantizedWeight`` leaves); like the JAX engine it never reads
``EngineConfig.quant``. KV storage is bf16, f32, FP8 (``kv_dtype="fp8"``:
float8_e4m3fn pools, no scales, rows cast with the JAX package's rounding)
or INT8 (``kv_dtype="int8"``: int8 pools with per-token-per-head f32
scale pools at the same page ids, so prefix sharing, the persistent store
and preemption move scales with their pages and need nothing more, as in
the JAX engine, which never touches ``k_scale`` past creating it). FP8 KV
takes sliding windows too (e4m3 ring pools in grouped mode), and serves
Gemma-1 and Gemma-2 (head_dim 256, the soft cap) as the JAX engine does.
The
JAX engine's warning that FP8 KV is slow on a TPU v5e (engine.py:466-476)
is a claim about that chip and is not carried over.

Sliding-window models (Mistral's ``sliding_window``, alternating
``layer_types``) with ``KVCacheConfig.sliding_reclaim`` (the default) and
one window size run in grouped mode (engine.py:483-531): the sliding
layers keep their KV in per-slot ring pools of R pages, R = (window +
span - 2) // page + 2 with span the largest single write (a verify window
or a ``max(prefill_chunk, 128)``-row chunk), and table column j of slot s
maps to ring page s*R + j % R; full layers keep the allocator's pools.
The ring tables are a pure function of (slot, column), cached per width.
Whole-prompt prefills write through ring rows masked to the in-window
columns, chunk loops through the unmasked rows (engine.py:1397-1403,
:1519-1530), and prefix sharing is off (ring pages are slot-owned), as is
``adopt_prefill``. Without reclaim the windows run over the ordinary
pools.

DeepSeek's multi-head latent attention runs in both cache modes over bf16
and f32 KV: absorbed (one shared latent pool, ``cache.v`` None) and naive;
under it speculation, INT8/FP8 KV and quantized weights raise.

Features outside this configuration raise NotImplementedError naming the
feature: guided decoding, LoRA
adapters, tensor/sequence parallelism (``adopt_prefill`` included),
top_logprobs and the non-Llama model branches.
The JAX engine's ``forward_paged`` and ``loras`` constructor arguments are
not taken yet.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from simplellminference_tpu_torch.core.config import (EngineConfig,
                                                      ModelConfig,
                                                      SamplingParams,
                                                      next_power_of_2)
from simplellminference_tpu_torch.core.device import (resolve_device,
                                                      torch_dtype)
from simplellminference_tpu_torch.engine import metrics as metrics_lib
from simplellminference_tpu_torch.engine.request import Request, RequestState
from simplellminference_tpu_torch.engine.stop import StopStringMatcher
from simplellminference_tpu_torch.memory.allocator import PageAllocator
from simplellminference_tpu_torch.memory.paged_kv import (PagedKVCache,
                                                          kv_storage_dtype)
from simplellminference_tpu_torch.models import llama
from simplellminference_tpu_torch.ops import sampling as sampling_ops
from simplellminference_tpu_torch.ops.linear import QuantizedWeight
from simplellminference_tpu_torch.ops.paged_append import SPAN_MAX
from simplellminference_tpu_torch.runtime.kv_cache import DenseKVCache


def _check_engine_config(ec: EngineConfig) -> None:
    if ec.spec_tokens and not 1 <= ec.spec_tokens <= SPAN_MAX - 1:
        raise ValueError(f"spec_tokens in [1, {SPAN_MAX - 1}] (the span "
                         f"kernel writes <= {SPAN_MAX} rows)")
    if ec.top_logprobs and ec.spec_tokens:
        raise ValueError("top_logprobs is incompatible with speculative "
                         "decoding (spec_tokens > 0)")
    if ec.top_logprobs:
        raise NotImplementedError("top_logprobs")
    if ec.sp_prefill_threshold:
        raise NotImplementedError("sequence-parallel prefill")
    if ec.mesh_shape and int(np.prod(list(ec.mesh_shape.values()))) > 1:
        raise NotImplementedError("tensor-parallel serving (mesh_shape)")
    if ec.kv.kv_dtype not in ("bf16", "f32", "fp8", "int8"):
        raise NotImplementedError(f"{ec.kv.kv_dtype} KV cache")


def _check_mla(cfg: ModelConfig, params, ec: EngineConfig, draft) -> None:
    """Raise NotImplementedError, naming it, for what the port does not
    serve under multi-head latent attention (DeepSeek): speculation,
    quantized KV, quantized weights."""
    if not cfg.mla:
        return
    if ec.spec_tokens or draft is not None:
        raise NotImplementedError("speculative decoding (spec_tokens, draft) "
                                  "under MLA")
    if ec.kv.kv_dtype in ("int8", "fp8"):
        raise NotImplementedError(f"{ec.kv.kv_dtype} KV under MLA (INT8/FP8 "
                                  f"latent pools)")
    if ec.quant.mode != "none" or any(
            isinstance(w, QuantizedWeight)
            for w in (*params["layers"].values(), params.get("lm_head"))):
        raise NotImplementedError("quantized weights under MLA "
                                  "(EngineConfig.quant, QuantizedWeight "
                                  "leaves)")


def draft_arena_slots(ec: EngineConfig) -> int:
    """Slots per row of the draft model's dense arena: a sequence's page
    capacity plus the rollout's G + 2 positions past it, rounded up to
    128 (engine.py:707-709)."""
    kv = ec.kv
    return -(-(kv.max_pages_per_seq * kv.page_size + ec.spec_tokens + 2)
             // 128) * 128


class Engine:
    """Single-model continuous-batching inference engine."""

    def __init__(self, cfg: ModelConfig, params, engine_cfg: EngineConfig,
                 tokenizer=None, decode_burst: int = 4, device=None,
                 draft=None):
        """``device``: CUDA unless ``device="cpu"``; ``params`` must live
        there (``models.llama.init_params`` or
        ``models.convert.params_from_jax``). ``draft``: an optional
        (draft_cfg, draft_params) pair, a small model in the same token
        space (params on the same device) that drafts the speculative
        windows instead of prompt lookup; needs ``spec_tokens`` >= 1."""
        _check_engine_config(engine_cfg)
        llama.check_supported(cfg)
        _check_mla(cfg, params, engine_cfg, draft)
        if draft is not None:
            if engine_cfg.spec_tokens < 1:
                raise ValueError("draft-model speculation needs "
                                 "EngineConfig.spec_tokens >= 1")
            if draft[0].vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share the token "
                                 "space")
            llama.check_supported(draft[0])
        self.device = resolve_device(device)
        for p in (params, draft[1] if draft is not None else params):
            if p["embed"].device.type != self.device.type:
                raise ValueError(f"params live on {p['embed'].device}, "
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
        kv_dtype = kv_storage_dtype(kv.kv_dtype)
        # sliding-window KV reclamation (engine.py:483-531): the sliding
        # layers' ring pools, slot s owning ring pages [s*R, (s+1)*R)
        wins = cfg.layer_windows
        w_set = {w for w in wins if w is not None}
        self._grouped = kv.sliding_reclaim and len(w_set) == 1
        self._window = next(iter(w_set)) if self._grouped else None
        self._ring = 0
        self._ring_tables: dict = {}
        if self._grouped:
            chunk = engine_cfg.prefill_chunk
            chunking = chunk and chunk > 0 and chunk % kv.page_size == 0
            # the ring absorbs the largest single write span (a chunk or
            # a verify window) plus the window without aliasing a live
            # column; the 128 floor is the JAX engine's sizing, kept so
            # that pools compare page for page
            span = max(engine_cfg.spec_tokens + 1,
                       max(chunk, 128) if chunking else 1)
            self._ring = (self._window + span - 2) // kv.page_size + 2
            lw = sum(w is not None for w in wins)
            self.cache = PagedKVCache.create(
                cfg.num_layers - lw, kv.num_pages, cfg.num_kv_heads,
                kv.page_size, cfg.head_dim, kv_dtype,
                device=self.device).with_windowed(
                    lw, engine_cfg.max_batch_size * self._ring)
        else:
            # absorbed MLA: one shared latent pool, v None (engine.py:530-536)
            self.cache = PagedKVCache.create(
                cfg.num_layers, kv.num_pages, cfg.num_kv_heads,
                kv.page_size, cfg.head_dim, kv_dtype,
                shared_kv=cfg.mla and cfg.mla_absorbed, device=self.device)

        b = engine_cfg.max_batch_size
        self.slots: list[Optional[Request]] = [None] * b
        self.waiting: deque[Request] = deque()
        self._req_ids = itertools.count()
        self.metrics = metrics_lib.EngineMetrics()

        # persistent prefix cache: finished requests' prompt pages are
        # DETACHED into refcounted allocator handles instead of freed, so
        # a recurring system prompt skips its prefill even with no
        # concurrent request in flight. LRU by insertion order; evicted
        # under pool pressure before any preemption. Maps (lora, the
        # retained page-aligned token prefix) -> allocator handle.
        self._prefix_store: dict[tuple, int] = {}

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

        # speculative decoding: the token history the prompt-lookup draft
        # reads (hist[b, 0..pos] = the context, hist[b, pos] the pending
        # input token), carried on the device between bursts like the
        # token and position, with host rows for the override path; the
        # tail past the capacity absorbs writes of rows running past it
        self.spec = engine_cfg.spec_tokens
        if self.spec:
            cap = kv.max_pages_per_seq * kv.page_size
            self._hist_host = np.zeros((b, cap + self.spec + 8), np.int32)
            self._dev_hist = None
            self._zero_hist = None

        # draft-model speculation: the draft's dense arena, indexed by
        # absolute position (the rollout writes up to pos + G), row b the
        # trash row of prefill padding and the rollout's pad row
        self._dcache = None
        if draft is not None:
            self._dcfg, self._dparams = draft
            self._dcache = DenseKVCache.create(
                self._dcfg.num_layers, b + 1, draft_arena_slots(engine_cfg),
                self._dcfg.num_kv_heads, self._dcfg.head_dim,
                torch_dtype("float32" if self._dcfg.dtype == "float32"
                            else "bfloat16"), device=self.device)

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
        # a verify window writes up to spec rows past the last token
        max_len = (self.ecfg.kv.max_pages_per_seq * self.ecfg.kv.page_size
                   - self.spec)
        if len(req.prompt_ids) + sampling.max_new_tokens > max_len:
            return self._reject(req, (
                f"prompt+max_new ({len(req.prompt_ids)}+"
                f"{sampling.max_new_tokens}) exceeds capacity {max_len}"))
        self.waiting.append(req)
        metrics_lib.log_event("request_added", req_id=req.req_id,
                              prompt_len=len(req.prompt_ids))
        return req

    def adopt_prefill(self, prompt_ids, first_token: int, write_cache_fn,
                      sampling: SamplingParams = SamplingParams(),
                      first_logprob: float = 0.0, on_tokens=None):
        """The sequence-parallel prefill handoff (engine.py:842): not
        ported. Grouped sliding-window pools refuse it first, as the JAX
        engine does (engine.py:862-865)."""
        if self._grouped:
            raise RuntimeError(
                "adopt_prefill is unsupported with grouped sliding-window "
                "pools (KVCacheConfig.sliding_reclaim=False to use it)")
        raise NotImplementedError("adopt_prefill (sequence-parallel "
                                  "prefill handoff)")

    def _reject(self, req: Request, error: str) -> Request:
        req.state = RequestState.FAILED
        req.error = error
        self.metrics.requests_failed += 1
        req.emit([], finished=True)
        return req

    def flush_prefix_cache(self) -> int:
        """Release every retained prefix (persistent prefix cache) back
        to the page pool. Returns entries released. Serving never needs
        this (pressure evicts LRU)."""
        n = 0
        while self._evict_prefix_lru():
            n += 1
        return n

    def cancel(self, req: Request) -> bool:
        """Client abort: reclaim the request's resources immediately.

        WAITING and PREEMPTED requests leave the queue; RUNNING requests
        free their pages and slot (an in-flight burst's tokens for the
        slot are discarded by the snapshot identity check in
        bookkeeping). Returns True if the request was live."""
        if req.state in (RequestState.WAITING, RequestState.PREEMPTED):
            try:
                self.waiting.remove(req)
            except ValueError:
                return False
        elif req.state == RequestState.RUNNING:
            self._release_slot_bias(req.slot)
            self.allocator.free_seq(req.slot)
            self.slots[req.slot] = None
            self._active_dirty = True
            self._tables_dirty = True
            req.slot = -1
        else:
            return False
        req.state = RequestState.CANCELLED
        self.metrics.requests_cancelled += 1
        metrics_lib.log_event("request_cancelled", req_id=req.req_id)
        req.emit([], finished=True)
        return True

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

    def _chunked(self, todo: int) -> bool:
        """Whether ``todo`` prompt tokens run as a chunk loop."""
        chunk = self.ecfg.prefill_chunk
        return (chunk > 0 and todo > chunk
                and chunk % self.ecfg.kv.page_size == 0)

    def _find_prefix_source(self, req: Request,
                            exclude: set[int]) -> tuple[int, int]:
        """(src_slot, shareable_tokens): the RUNNING request whose prompt
        shares the longest page-aligned prefix with ``req``. Shared pages
        are complete and immutable — each sequence only writes at
        positions >= its own prompt length >= the shared prefix.

        ``exclude``: slots admitted THIS cycle whose prefill dispatches
        after the uncached batch (cached/chunked admits) — sharing from
        them would read pages before they are written."""
        ps = self.ecfg.kv.page_size
        best_slot, best = -1, 0
        cap = req.total_len - 1  # at least one token must prefill
        for cand in self.slots:
            if cand is None or cand.state != RequestState.RUNNING \
                    or cand.slot in exclude or cand.lora != req.lora:
                continue
            n = 0
            for a, b in zip(req.prompt_ids, cand.prompt_ids):
                if a != b:
                    break
                n += 1
            n = (min(n, cap) // ps) * ps
            if n > best:
                best, best_slot = n, cand.slot
        return best_slot, best

    def _find_prefix_handle(self, req: Request) -> tuple[tuple, int, int]:
        """(key, handle, tokens) of the RETAINED prefix sharing the most
        full pages with ``req``'s prompt, or ((), -1, 0). Partial use of
        a longer entry is fine: its leading pages are valid for any
        prompt that begins with them."""
        ps = self.ecfg.kv.page_size
        best_key, best_h, best = (), -1, 0
        cap = ((req.total_len - 1) // ps) * ps  # >= 1 token must prefill
        for key, h in self._prefix_store.items():
            lora_name, toks = key
            if lora_name != req.lora:
                continue
            m = min(len(toks), cap)
            common = 0
            for a, b in zip(req.prompt_ids[:m], toks):
                if a != b:
                    break
                common += 1
            common = (common // ps) * ps
            if common > best:
                best_key, best_h, best = key, h, common
        return best_key, best_h, best

    def _evict_prefix_lru(self) -> bool:
        """Release the least-recently-used retained prefix handle."""
        if not self._prefix_store:
            return False
        key = next(iter(self._prefix_store))
        h = self._prefix_store.pop(key)
        self.allocator.prefix_release(h)
        self.metrics.prefix_cache_evictions += 1
        metrics_lib.log_event("prefix_evicted", tokens=len(key[1]))
        return True

    def _retain_prefix(self, req: Request):
        """Detach a finishing request's full prompt pages into the
        persistent store (refcounted — they survive the slot's
        free_seq)."""
        cap = self.ecfg.prefix_cache_entries
        if cap <= 0 or req.slot < 0 or self._grouped:
            return
        ps = self.ecfg.kv.page_size
        n = (len(req.prompt_ids) // ps) * ps
        if n <= 0:
            return
        key = (req.lora, tuple(req.prompt_ids[:n]))
        if key in self._prefix_store:
            self._prefix_store[key] = self._prefix_store.pop(key)  # LRU
            return
        h = self.allocator.prefix_detach(req.slot, n)
        if h < 0:
            return
        self._prefix_store[key] = h
        while len(self._prefix_store) > cap:
            self._evict_prefix_lru()

    def _admit(self):
        free = self._free_slots()
        admitted: list[Request] = []
        late: set[int] = set()  # this cycle's cached/chunked admits
        while free and self.waiting:
            req = self.waiting[0]
            slot = free[0]
            # share complete prompt-prefix pages with a running request
            # OR a retained prefix handle — whichever covers more — then
            # allocate only the remainder; prefill starts after them.
            # Grouped sliding pools share nothing: ring pages are
            # slot-owned, and a shared full-group prefix would leave the
            # sliding group's window unwritten
            req.cached_len = 0
            if self._grouped:
                src, shareable, pkey, ph, ph_tok = -1, 0, (), -1, 0
            else:
                src, shareable = self._find_prefix_source(req, late)
                pkey, ph, ph_tok = self._find_prefix_handle(req)
            if ph_tok > shareable:
                shared = self.allocator.prefix_attach(ph, slot, ph_tok)
                if shared > 0 and self.allocator.extend(slot,
                                                        req.total_len):
                    req.cached_len = shared
                    # LRU refresh
                    self._prefix_store[pkey] = self._prefix_store.pop(pkey)
                    self.metrics.prefix_cache_persistent_hits += 1
                elif shared > 0:
                    self.allocator.free_seq(slot)  # drop the share
            if req.cached_len == 0 and src >= 0 and shareable > 0:
                shared = self.allocator.share_prefix(src, slot, shareable)
                if shared > 0:
                    if self.allocator.extend(slot, req.total_len):
                        req.cached_len = shared
                    else:
                        self.allocator.free_seq(slot)  # drop the share
            if req.cached_len == 0 \
                    and not self.allocator.alloc_seq(slot, req.total_len):
                # pool exhausted: retained prefixes give way before live
                # work waits — evict LRU and retry this same request
                if self._evict_prefix_lru():
                    continue
                break  # truly exhausted — wait for finishes
            if req.cached_len or self._chunked(req.total_len):
                late.add(slot)
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
            if self.spec:
                ids = req.prompt_ids + req.output_ids
                self._hist_host[slot] = 0
                self._hist_host[slot, :len(ids)] = ids
            admitted.append(req)
            if req.cached_len:
                self.metrics.prefix_cache_hits += 1
                self.metrics.prompt_tokens_cached += req.cached_len
            metrics_lib.log_event("request_admitted", req_id=req.req_id,
                                  slot=slot, cached=req.cached_len)
        if not admitted:
            return
        self._active_dirty = True
        self._tables_dirty = True
        self._samp_dirty = True
        batchable: list[Request] = []
        others: list[Request] = []      # long remainder: chunk loop
        cached: list[Request] = []      # short suffix: batched below
        for req in admitted:
            if self._chunked(req.total_len - req.cached_len):
                others.append(req)
            elif req.cached_len:
                cached.append(req)
            else:
                batchable.append(req)
        # dispatch order = dependency order: a prefix-cached request may
        # share pages written by an EARLIER admit of this same cycle, so
        # whole-prompt prefills go first and suffixes follow
        pending: list[tuple[list[Request], torch.Tensor]] = []
        if batchable:
            pending.append((batchable, self._prefill_batch(batchable)))
        for req in others:
            pending.append(([req], self._prefill(req, start=req.cached_len)))
        if cached:
            pending.append((cached,
                            self._prefill_batch(cached, suffixes=True)))
        if self._dcache is not None:
            self._draft_prefill_admitted(admitted)
        # one host sync for every admitted prefill: the dispatches queue
        # back to back on the device
        for reqs, packed in pending:
            arr = packed.cpu().numpy()       # [n, 2]: token, logprob
            for i, req in enumerate(reqs):
                tok_id = int(arr[i, 0])
                self._next_tok[req.slot] = tok_id
                self._counts_host[req.slot, tok_id] += 1
                if self.spec:
                    # the pending input token closes the history row
                    self._hist_host[req.slot, self._pos[req.slot]] = tok_id
                self._override[req.slot] = True  # fresh pipeline state
                self._emit_tokens(req, [tok_id], [float(arr[i, 1])])

    def _draft_prefill_admitted(self, reqs: list[Request]):
        """One batched draft prefill for a cycle's admits (engine.py:
        1319-1345, :717-732): the whole context from position 0 (the
        draft has no prefix cache or chunking), rows gathered from the
        arena, prefilled and scattered back; the row count quantized to
        {1, max_batch}, padding rows on the trash row."""
        n = len(reqs)
        b = len(self.slots)
        lens = [r.total_len for r in reqs]
        cap = self._dcache.max_seq
        if max(lens) > cap:
            raise ValueError(f"a context of {max(lens)} tokens exceeds the "
                             f"draft arena's {cap} slots")
        bucket = min(next_power_of_2(max(max(lens), 16)), cap)
        nb = 1 if n == 1 else b
        tokens = np.zeros((nb, bucket), np.int32)
        idx = np.full(nb, b, np.int64)            # default: the trash row
        kv_lens = np.ones(nb, np.int32)
        for i, r in enumerate(reqs):
            ids = r.prompt_ids + r.output_ids
            tokens[i, :len(ids)] = ids
            idx[i] = r.slot
            kv_lens[i] = len(ids)
        idx_d = self._upload(idx)
        dc = self._dcache
        sub = DenseKVCache(k=dc.k.index_select(1, idx_d),
                           v=dc.v.index_select(1, idx_d))
        positions = torch.arange(bucket, dtype=torch.int32,
                                 device=self.device)[None].expand(nb, bucket)
        llama.forward(self._dcfg, self._dparams, self._upload(tokens),
                      positions, sub,
                      torch.zeros(nb, dtype=torch.int32, device=self.device),
                      self._upload(kv_lens), last_token_only=True)
        dc.k.index_copy_(1, idx_d, sub.k)
        dc.v.index_copy_(1, idx_d, sub.v)

    def _model_draft(self, tok, pos):
        """[B, G] draft tokens by a greedy G+1-step rollout of the draft
        model over its arena (engine.py:280-296): B+1 rows, the last a
        pad row (token 0 at position 0, the trash row); the extra step
        writes the G-th draft's K/V, so a full accept leaves no gap."""
        b = tok.shape[0]
        t = torch.cat([tok, tok.new_zeros(1)])
        p = torch.cat([pos, pos.new_zeros(1)])
        drafts = []
        for _ in range(self.spec + 1):
            logits, _ = llama.forward(self._dcfg, self._dparams, t[:, None],
                                      p[:, None], self._dcache, p, p + 1)
            t = sampling_ops.greedy(logits[:, -1])
            p = p + 1
            drafts.append(t)
        return torch.stack(drafts[:self.spec], 1)[:b]

    def _prefill_batch(self, reqs: list[Request],
                       suffixes: bool = False) -> torch.Tensor:
        """ONE batched prefill dispatch for a cycle's admits.

        ``suffixes=False``: whole prompts (each row writes its own pages
        from position 0). ``suffixes=True``: prefix-cached admits — each
        row prefills only its uncached suffix at its own page-aligned
        offset. Rows are right-padded to the longest power-of-2 bucket
        (>= 16), the row count quantized to {1, max_batch}; padding rows
        carry -1 tables (trash page), kv_len 1 and offset 0. Returns the
        device rows [len(reqs), 2]: (first token, its logprob)."""
        n = len(reqs)
        starts = [r.cached_len if suffixes else 0 for r in reqs]
        todo = [r.total_len - s for r, s in zip(reqs, starts)]
        bucket = next_power_of_2(max(max(todo), 16))
        nb = 1 if n == 1 else len(self.slots)
        tokens = np.zeros((nb, bucket), np.int32)
        mp = self.allocator.max_pages_per_seq
        tables = np.full((nb, mp), -1, np.int32)
        kv_len = np.ones(nb, np.int32)
        offs = np.zeros(nb, np.int32)
        for i, r in enumerate(reqs):
            ids = r.prompt_ids + r.output_ids
            tokens[i, :todo[i]] = ids[starts[i]:]
            tables[i] = self.allocator.row(r.slot)
            kv_len[i] = r.total_len
            offs[i] = starts[i]
            self._pos[r.slot] = r.total_len
            self.metrics.prefills += 1
            self.metrics.prompt_tokens += r.total_len
        idx = np.asarray([r.slot for r in reqs] + [0] * (nb - n))
        if self._grouped:
            # whole-prompt dispatch: ring rows masked to the in-window
            # columns (no suffix dispatch runs grouped: no prefix cache)
            tw = np.full((nb, mp), -1, np.int32)
            for i, r in enumerate(reqs):
                tw[i] = self._ring_row_masked(r.slot, int(kv_len[i]), mp)
            tables = (tables, tw)
        if suffixes:
            packed = self._prefill_chunk_fn(tokens, tables, kv_len, offs,
                                            idx)
        else:
            packed = self._prefill_fn(tokens, tables, kv_len, idx)
        return packed[:n]

    def _prefill(self, req: Request, start: int) -> torch.Tensor:
        """B=1 chunk loop over prompt tokens [start, total): ``start`` > 0
        means the prefix cache covered [0, start) with shared pages
        (page-aligned). Steps of ``prefill_chunk`` tokens, each attending
        through the page tables to everything before it. Returns the
        last chunk's device row [1, 2]."""
        ids = req.prompt_ids + req.output_ids
        ln = len(ids)
        todo = ln - start
        tables = self.allocator.row(req.slot)[None]
        if self._grouped:
            # chunks read back through the ring (paged prefill
            # attention): the unmasked ring row, sized for window + chunk
            mp = self.allocator.max_pages_per_seq
            tables = (tables, self._ring_row(req.slot, mp)[None])
        idx = np.asarray([req.slot])
        step = self.ecfg.prefill_chunk
        n_chunks = -(-todo // step)
        padded = np.zeros((n_chunks * step,), np.int32)
        padded[:todo] = ids[start:]
        for j in range(n_chunks):
            off = start + j * step
            packed = self._prefill_chunk_fn(
                padded[None, j * step:(j + 1) * step], tables,
                np.asarray([min(ln, off + step)], np.int32),
                np.asarray([off], np.int32), idx)
        self.metrics.prefills += 1
        self.metrics.prompt_tokens += ln
        self._pos[req.slot] = ln
        return packed

    def _prefill_fn(self, tokens, tables, kv_len, idx) -> torch.Tensor:
        """Prefill forward + in-call sampling of each row's first token.
        The noise is keyed by the position of the consumed input token
        (kv_len - 1), like the burst recurrence."""
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=self.device)[None]
        return self._forward_and_sample(tokens, positions, tables, kv_len,
                                        idx, None)

    def _prefill_chunk_fn(self, tokens, tables, kv_len, chunk_offset,
                          idx) -> torch.Tensor:
        """Chunked prefill forward (row b at its own page-aligned offset
        ``chunk_offset[b]``) + in-call sampling, as :meth:`_prefill_fn`."""
        offs = self._upload(chunk_offset)
        positions = offs[:, None] + torch.arange(
            tokens.shape[1], dtype=torch.int32, device=self.device)[None]
        return self._forward_and_sample(tokens, positions, tables, kv_len,
                                        idx, offs)

    def _forward_and_sample(self, tokens, positions, tables, kv_len, idx,
                            chunk_offset) -> torch.Tensor:
        kv_d = self._upload(kv_len)
        tables = (tuple(self._upload(t) for t in tables)
                  if isinstance(tables, tuple) else self._upload(tables))
        logits, self.cache = llama.forward_paged(
            self.cfg, self.params, self._upload(tokens), positions,
            self.cache, tables, kv_d, prefill=True,
            last_token_only=True, chunk_offset=chunk_offset)
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
        self._retain_prefix(req)
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
        burst, and the burst about to dispatch advances one more (a
        speculative step up to spec + 1 tokens)."""
        per_step = self.spec + 1
        while True:
            ok = True
            for req in list(self.slots):
                if req is None:
                    continue
                # clamp to the request's lifetime maximum (plus the rows a
                # verify window writes past its last token)
                lim = (len(req.prompt_ids) + req.sampling.max_new_tokens
                       + self.spec)
                target = min(int(self._pos[req.slot])
                             + 2 * self.burst * per_step + 1, lim)
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
            # retained prefixes are strictly lower priority than live
            # requests: evict them all before preempting anyone
            if self._evict_prefix_lru():
                continue
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
        if self.spec:
            # the first burst overrides every row (any_ov)
            dev_hist = (self._get_zero_hist() if self._dev_hist is None
                        else self._dev_hist)
            ov_hist = (self._upload(self._hist_host) if any_ov
                       else self._get_zero_hist())
            # the cost tier of the rejection sampler, from the host rows
            live = np.asarray([s is not None for s in self.slots])
            any_rs = bool((live & (self._temp > 0.0) & (self._rep_p == 1.0)
                           & (self._freq_p == 0.0)
                           & (self._pres_p == 0.0)).any())
            (packed, self._dev_tok, self._dev_pos, self._dev_counts,
             self._dev_hist) = self._spec_burst_fn(
                steps, dev_tok, dev_pos, dev_counts, dev_hist, ov, ov_hist,
                tables, active, samp, any_rs)
        else:
            packed, self._dev_tok, self._dev_pos, self._dev_counts = \
                self._burst_fn(steps, dev_tok, dev_pos, dev_counts, *ov,
                               tables, active, samp)
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

    def _spec_burst_fn(self, steps, dev_tok, dev_pos, dev_counts, dev_hist,
                       ov, ov_hist, tables, active, samp, any_rs: bool):
        """``steps`` speculative steps of every slot (engine.py:227-433):
        each drafts G tokens by prompt lookup, verifies G+1 positions in
        one forward (kv_lens = pos + G + 1) and emits the accepted prefix
        plus a bonus token per active row. ``ov`` = (token, pos, counts,
        mask) overrides and ``ov_hist`` the history rows, as in
        :meth:`_burst_fn`. ``any_rs``: some live row samples without
        penalties (the rejection sampler runs). Returns (packed rows
        [B, steps, 2(G+1)+1] of (emitted tokens, -1 past the count; their
        logprobs; the count emitted), token, pos, counts, history)."""
        g = self.spec
        ov_tok, ov_pos, ov_counts, ov_mask = ov
        tok = torch.where(ov_mask, ov_tok, dev_tok)
        pos = torch.where(ov_mask, ov_pos, dev_pos)
        counts = torch.where(ov_mask[:, None], ov_counts, dev_counts)
        hist = torch.where(ov_mask[:, None], ov_hist, dev_hist)
        b, hl = hist.shape
        rows = torch.arange(b, device=self.device)[:, None]
        kidx = torch.arange(g + 1, dtype=torch.int32, device=self.device)[None]
        temp, top_k, top_p, min_p = (samp[k] for k in (
            "temperature", "top_k", "top_p", "min_p"))
        pen_neutral = ((samp["repetition_penalty"] == 1.0)
                       & (samp["frequency_penalty"] == 0.0)
                       & (samp["presence_penalty"] == 0.0))
        greedy_row = (temp <= 0.0) & pen_neutral
        rs_row = (temp > 0.0) & pen_neutral
        bias = ((samp["bias_ids"], samp["bias_vals"]) if "bias_ids" in samp
                else None)
        plain_kw = {k: v for k, v in samp.items()
                    if k not in ("bias_ids", "bias_vals")}
        shaping = samp["shaping_on"]

        def per_draft(x):          # [B] sampler row -> [B * G]
            return x.repeat_interleave(g)

        out = []
        for _ in range(steps):
            draft = (self._model_draft(tok, pos) if self._dcache is not None
                     else self._find_draft(hist, pos))            # [B, G]
            logits, self.cache = llama.forward_paged(
                self.cfg, self.params, torch.cat([tok[:, None], draft], 1),
                pos[:, None] + kidx, self.cache, tables, pos + g + 1,
                prefill=False)
            # logit_bias shapes every decision; logprobs stay raw
            logits_b = (sampling_ops.apply_logit_bias(logits, *bias)
                        if bias is not None else logits)
            pred = sampling_ops.greedy(logits_b)                  # [B, G+1]
            # greedy rows accept drafts equal to the argmax
            eq = (draft == pred[:, :g]) & greedy_row[:, None]
            if any_rs:
                # sampled penalty-free rows: accept draft d w.p. p(d)
                pd = sampling_ops.shaped_token_prob(
                    logits_b[:, :g].reshape(b * g, -1), draft.reshape(-1),
                    per_draft(temp), per_draft(top_k), per_draft(top_p),
                    per_draft(min_p), shaping_on=shaping).reshape(b, g)
                u = sampling_ops.row_uniform(sampling_ops.spec_row_keys(
                    per_draft(samp["seeds"]),
                    (pos[:, None] + kidx[:, :g]).reshape(-1), 1)).reshape(b, g)
                eq = eq | ((u < pd) & rs_row[:, None])
            n_acc = torch.cumprod(eq.to(torch.int32), 1).sum(
                1, dtype=torch.int32)
            bonus = pred.gather(1, n_acc.long()[:, None])[:, 0]
            if any_rs:
                # the residual p | != d after a rejection, or the full
                # shaped p after G accepts, from window n_acc's logits
                lg = logits_b[torch.arange(b, device=self.device),
                              n_acc.long()]
                excl = torch.where(n_acc < g, draft.gather(
                    1, n_acc.clamp(max=g - 1).long()[:, None])[:, 0], -1)
                bonus = torch.where(rs_row, sampling_ops.sample_excluding(
                    lg, temp, top_k, top_p, min_p, excl,
                    sampling_ops.spec_row_keys(samp["seeds"], pos + n_acc, 2),
                    shaping_on=shaping), bonus)
            if samp["penalties_on"]:
                # rows with penalties: one penalized sample per step
                first = sampling_ops.sample(logits_b[:, 0], counts=counts,
                                            seed_pos=pos, **plain_kw)
                bonus = torch.where(greedy_row | rs_row, bonus, first)
            draft_p = torch.cat([draft, torch.zeros_like(draft[:, :1])], 1)
            emitted = torch.where(
                kidx < n_acc[:, None], draft_p,
                torch.where(kidx == n_acc[:, None], bonus[:, None], -1))
            emitted = torch.where(active[:, None], emitted, -1)
            n_em = torch.where(active, n_acc + 1, 0)
            live = kidx < n_em[:, None]
            safe = emitted.clamp(min=0)
            # emitted tokens enter the history at positions pos+1+k
            cols = torch.where(live, pos[:, None] + 1 + kidx, hl - 1)
            hist.scatter_(1, cols.clamp(max=hl - 1).long(), safe)
            if samp["penalties_on"]:
                counts.index_put_((rows.expand(-1, g + 1), safe.long()),
                                  live.float(), accumulate=True)
            lps = torch.log_softmax(logits.float(), -1).gather(
                -1, safe.long()[..., None])[..., 0]               # [B, G+1]
            tok = torch.where(active, bonus, tok)
            pos = pos + n_em
            out.append(torch.cat([emitted.float(), lps,
                                  n_em.float()[:, None]], -1))
        return torch.stack(out, dim=1), tok, pos, counts, hist

    def _find_draft(self, hist, pos):
        """[B, G] draft tokens by prompt lookup (engine.py:260-278): the
        continuation of the latest window ending before ``pos`` that
        matches the context's last ``spec_ngram`` tokens (which end at
        pos), drafting only from known context; 0 where none matches."""
        ng = self.ecfg.spec_ngram
        b, hl = hist.shape
        idxs = torch.arange(hl, device=hist.device)[None]
        p = pos.long()
        m = (idxs < p[:, None]) & (idxs >= ng - 1)
        for j in range(ng):
            tj = hist.gather(1, (p - j).clamp(0, hl - 1)[:, None])
            hj = hist if j == 0 else F.pad(hist[:, :hl - j], (j, 0), value=-1)
            m &= hj == tj
        e = torch.where(m, idxs, -1).amax(1)
        found = (e >= 0) & (p >= ng)
        gat = e[:, None] + 1 + torch.arange(self.spec, device=hist.device)[None]
        draft = hist.gather(1, gat.clamp(0, hl - 1))
        ok = found[:, None] & (gat <= p[:, None])
        return torch.where(ok, draft, 0)

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
            full = self._upload(self.allocator.table()[:, :width])
            # grouped pools: the ring table never changes for a width
            self._tables_dev = ((full, self._ring_table(width))
                                if self._grouped else full)
            self._tables_width = width
            self._tables_dirty = False

    def _ring_row(self, slot: int, width: int) -> np.ndarray:
        """Slot ``slot``'s ring table row: column j -> ring page
        slot*R + j % R."""
        return (slot * self._ring
                + np.arange(width, dtype=np.int32) % self._ring)

    def _ring_table(self, width: int) -> torch.Tensor:
        """The device ring tables [B, width] (engine.py:2001-2012), cached
        per width (a column below a row's window band aliases a live page;
        the attention kernels never read one)."""
        rt = self._ring_tables.get(width)
        if rt is None:
            rt = self._upload(np.stack([self._ring_row(s, width)
                                        for s in range(len(self.slots))]))
            self._ring_tables[width] = rt
        return rt

    def _ring_row_masked(self, slot: int, kv_len: int,
                         mp: int) -> np.ndarray:
        """Ring row of a whole-prompt prefill (engine.py:2014-2026): only
        the in-window columns are mapped, the older ones -1 (the trash
        page), so the ring takes no duplicate page writes in one
        dispatch."""
        ps = self.ecfg.kv.page_size
        row = np.full(mp, -1, np.int32)
        lo = max(0, kv_len - self._window) // ps
        hi = (kv_len - 1) // ps
        cols = np.arange(lo, min(hi, mp - 1) + 1, dtype=np.int32)
        row[cols] = slot * self._ring + cols % self._ring
        return row

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

    def _get_zero_hist(self):
        """No-op history override rows, device-resident."""
        if self._zero_hist is None:
            self._zero_hist = torch.zeros(self._hist_host.shape,
                                          dtype=torch.int32,
                                          device=self.device)
        return self._zero_hist

    def _process_inflight(self):
        """Drain the pipeline: sync + bookkeep the in-flight burst."""
        if self._inflight is None:
            return
        payload, snapshot = self._inflight
        self._inflight = None
        self._bookkeep(payload, snapshot)

    def _bookkeep(self, payload, snapshot):
        if self.spec:
            self._bookkeep_spec(payload, snapshot)
            return
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

    def _bookkeep_spec(self, payload, snapshot):
        """Emit a speculative burst's tokens (engine.py:2054-2077): each
        step's accepted drafts and bonus token, in order; every step in
        which a row emitted counts one verify step, every token past the
        first of a step one accepted draft."""
        arr = self._wait_host(payload)   # [B, steps, 2(G+1)+1]: the sync
        g1 = self.spec + 1
        ems = arr[..., :g1].astype(np.int64)
        elps = arr[..., g1:2 * g1]
        nems = arr[..., -1].astype(np.int64)
        for slot, req, _n in snapshot:
            if self.slots[slot] is not req \
                    or req.state != RequestState.RUNNING:
                continue
            seq: list[int] = []
            seq_lp: list[float] = []
            for st in range(ems.shape[1]):
                n = nems[slot, st]
                seq.extend(ems[slot, st, :n].tolist())
                seq_lp.extend(elps[slot, st, :n].tolist())
            steps_active = int((nems[slot] > 0).sum())
            self.metrics.spec_steps += steps_active
            self.metrics.spec_accepted += len(seq) - steps_active
            self._emit_tokens(req, seq, seq_lp)
            if req.state == RequestState.RUNNING and seq:
                self._pos[slot] += len(seq)
                self._next_tok[slot] = seq[-1]
