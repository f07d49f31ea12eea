"""Request state machine for the serving engine."""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, Optional

from simplellminference_tpu_torch.core.config import SamplingParams


class RequestState(enum.Enum):
    WAITING = "waiting"       # queued, no pages
    RUNNING = "running"       # slot + pages assigned, decoding
    PREEMPTED = "preempted"   # pages reclaimed, back to queue
    FINISHED = "finished"
    CANCELLED = "cancelled"   # client abort; pages reclaimed immediately
    FAILED = "failed"         # request-scoped error (never process-fatal —
                              # unlike the reference's exit() LOG, base.h:6-10)


@dataclasses.dataclass
class Request:
    req_id: int
    prompt_ids: list[int]
    sampling: SamplingParams
    state: RequestState = RequestState.WAITING
    slot: int = -1
    output_ids: list[int] = dataclasses.field(default_factory=list)
    # log P(token) under the model's raw distribution, aligned with
    # output_ids
    output_logprobs: list[float] = dataclasses.field(default_factory=list)
    # top-K alternative (token id, logprob) lists per emitted token
    # (EngineConfig.top_logprobs > 0), aligned with output_ids
    output_top_logprobs: list = dataclasses.field(default_factory=list)
    # streaming callback: (req, new_token_ids, finished) -> None
    on_tokens: Optional[Callable] = None
    error: Optional[str] = None
    # timing
    arrival_t: float = dataclasses.field(default_factory=time.perf_counter)
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    preempt_count: int = 0
    # tokens covered by prefix-cache page sharing at the LAST admit
    # (prefill starts there instead of 0); reset on each (re)admission
    cached_len: int = 0
    # stop-string machinery (set by the engine when sampling.stop_strings
    # is non-empty): the incremental matcher, and — once a stop string
    # matched — the authoritative output text truncated at the match
    stop_matcher: Optional[object] = None
    final_text: Optional[str] = None
    # LoRA adapter name (must be registered with the engine); None = base
    lora: Optional[str] = None
    # on a stop-string match: count of output_ids whose decoded text lies
    # entirely within final_text (ids past it decode stop-string content
    # and must not reach clients that consume token_ids)
    final_ids_len: Optional[int] = None
    # guided decoding (set by the engine when sampling.guided_* is set):
    # the TokenIndex over the constraint FSM, and the current FSM state
    guided_index: Optional[object] = None
    guided_state: int = 0

    @property
    def num_generated(self) -> int:
        return len(self.output_ids)

    @property
    def total_len(self) -> int:
        return len(self.prompt_ids) + self.num_generated

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.arrival_t

    def should_stop(self, token_id: int) -> bool:
        if token_id in self.sampling.stop_token_ids:
            return True
        return self.num_generated >= self.sampling.max_new_tokens

    def emit(self, new_ids: list[int], finished: bool):
        if new_ids and self.first_token_t is None:
            self.first_token_t = time.perf_counter()
        if self.on_tokens is not None:
            self.on_tokens(self, new_ids, finished)
        if finished:
            self.finish_t = time.perf_counter()
