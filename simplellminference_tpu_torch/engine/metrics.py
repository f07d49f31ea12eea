"""Engine observability: counters + structured event log.

SURVEY.md §5 "Metrics/observability": the reference has nothing beyond a
fatal LOG macro and raw std::cout token printing (base.h:6-10,
model.cpp:155-182). Here: counters the BASELINE metrics are computed from
(tokens/s, TTFT percentiles, batch occupancy, page utilization) plus an
optional structured event stream (admit/preempt/finish) for tracing.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Optional

logger = logging.getLogger("simplellminference_tpu_torch.engine")


@dataclasses.dataclass
class EngineMetrics:
    tokens_generated: int = 0
    prompt_tokens: int = 0
    requests_finished: int = 0
    requests_failed: int = 0
    requests_cancelled: int = 0
    preemptions: int = 0
    engine_steps: int = 0
    decode_bursts: int = 0
    prefills: int = 0
    sp_prefills: int = 0           # engine-native SP x TP ring prefills
    prefix_cache_hits: int = 0
    prefix_cache_persistent_hits: int = 0  # hits from RETAINED (finished)
    prefix_cache_evictions: int = 0
    prompt_tokens_cached: int = 0  # prompt tokens served by shared pages
    spec_steps: int = 0            # speculative verify steps (active rows)
    spec_accepted: int = 0         # draft tokens accepted
    # guided decoding dispatch modes: pipelined fan-out bursts (unguided
    # co-tenants keep multi-step bursts) vs serialized masked steps
    guided_fanout_bursts: int = 0
    guided_serial_steps: int = 0
    # time integrals for occupancy/utilization averages
    busy_slot_steps: int = 0
    total_slot_steps: int = 0
    used_page_steps: int = 0
    total_page_steps: int = 0
    ttfts: list = dataclasses.field(default_factory=list)
    start_t: float = dataclasses.field(default_factory=time.perf_counter)

    def observe_step(self, busy_slots: int, total_slots: int,
                     used_pages: int, total_pages: int):
        self.engine_steps += 1
        self.busy_slot_steps += busy_slots
        self.total_slot_steps += total_slots
        self.used_page_steps += used_pages
        self.total_page_steps += total_pages

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.start_t

    @property
    def tokens_per_sec(self) -> float:
        return self.tokens_generated / max(self.elapsed, 1e-9)

    @property
    def batch_occupancy(self) -> float:
        return self.busy_slot_steps / max(self.total_slot_steps, 1)

    @property
    def page_utilization(self) -> float:
        return self.used_page_steps / max(self.total_page_steps, 1)

    def ttft_percentile(self, p: float) -> Optional[float]:
        if not self.ttfts:
            return None
        xs = sorted(self.ttfts)
        i = min(int(len(xs) * p), len(xs) - 1)
        return xs[i]

    def summary(self) -> dict:
        return {
            "tokens_generated": self.tokens_generated,
            "prompt_tokens": self.prompt_tokens,
            "requests_finished": self.requests_finished,
            "requests_failed": self.requests_failed,
            "requests_cancelled": self.requests_cancelled,
            "preemptions": self.preemptions,
            "engine_steps": self.engine_steps,
            "decode_bursts": self.decode_bursts,
            "prefills": self.prefills,
            "sp_prefills": self.sp_prefills,
            "prefix_cache_hits": self.prefix_cache_hits,
            "prefix_cache_persistent_hits":
            self.prefix_cache_persistent_hits,
            "prefix_cache_evictions": self.prefix_cache_evictions,
            "prompt_tokens_cached": self.prompt_tokens_cached,
            "spec_steps": self.spec_steps,
            "spec_accepted": self.spec_accepted,
            "spec_acceptance_rate": round(
                self.spec_accepted / self.spec_steps, 3)
            if self.spec_steps else 0.0,
            "tokens_per_sec": round(self.tokens_per_sec, 2),
            "batch_occupancy": round(self.batch_occupancy, 4),
            "page_utilization": round(self.page_utilization, 4),
            "ttft_p50_s": self.ttft_percentile(0.5),
            "ttft_p99_s": self.ttft_percentile(0.99),
        }


#: Cumulative TTFT histogram bucket upper bounds (seconds), Prometheus
#: convention (le-labeled, +Inf implicit). Spans interactive sub-100ms
#: hits through multi-second long-prompt chunked prefills.
TTFT_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _prom_escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def prometheus_text(metrics: "EngineMetrics",
                    extra_gauges: Optional[dict] = None) -> str:
    """Render engine metrics in the Prometheus text exposition format
    (version 0.0.4): ``# HELP``/``# TYPE`` headers, counters, gauges,
    and a cumulative TTFT histogram.

    The reference's whole observability story is a fatal LOG macro
    (include/base.h:6-10); this is the serving-side
    successor every scraper expects.
    """
    m = metrics
    ns = "slli"  # simplellminference_tpu
    lines: list = []

    def counter(name, help_, value):
        lines.append(f"# HELP {ns}_{name} {help_}")
        lines.append(f"# TYPE {ns}_{name} counter")
        lines.append(f"{ns}_{name} {value}")

    def gauge(name, help_, value):
        lines.append(f"# HELP {ns}_{name} {help_}")
        lines.append(f"# TYPE {ns}_{name} gauge")
        lines.append(f"{ns}_{name} {value}")

    counter("tokens_generated_total",
            "Decode tokens produced across all requests",
            m.tokens_generated)
    counter("prompt_tokens_total", "Prompt tokens prefilled",
            m.prompt_tokens)
    counter("prompt_tokens_cached_total",
            "Prompt tokens served from shared prefix pages",
            m.prompt_tokens_cached)
    counter("requests_finished_total", "Requests finished successfully",
            m.requests_finished)
    counter("requests_failed_total", "Requests finished with an error",
            m.requests_failed)
    counter("requests_cancelled_total", "Requests cancelled by clients",
            m.requests_cancelled)
    counter("preemptions_total", "Requests preempted on KV pressure",
            m.preemptions)
    counter("engine_steps_total", "Engine scheduler steps",
            m.engine_steps)
    counter("decode_bursts_total", "Fused multi-token decode bursts",
            m.decode_bursts)
    counter("prefills_total", "Prefill dispatches", m.prefills)
    counter("sp_prefills_total",
            "Engine-native SP x TP ring prefills of long prompts",
            m.sp_prefills)
    counter("prefix_cache_hits_total", "Prefix cache hits",
            m.prefix_cache_hits)
    counter("prefix_cache_persistent_hits_total",
            "Prefix hits against retained finished-request pages",
            m.prefix_cache_persistent_hits)
    counter("prefix_cache_evictions_total", "Persistent prefix evictions",
            m.prefix_cache_evictions)
    counter("spec_steps_total", "Speculative verify steps", m.spec_steps)
    counter("spec_accepted_total", "Draft tokens accepted",
            m.spec_accepted)
    counter("guided_fanout_bursts_total",
            "Guided-decoding pipelined fan-out bursts",
            m.guided_fanout_bursts)
    counter("guided_serial_steps_total",
            "Guided-decoding serialized masked steps",
            m.guided_serial_steps)

    gauge("tokens_per_sec", "Decode tokens/s since engine start",
          round(m.tokens_per_sec, 3))
    gauge("batch_occupancy",
          "Mean fraction of batch slots busy per step",
          round(m.batch_occupancy, 6))
    gauge("page_utilization", "Mean fraction of KV pages in use per step",
          round(m.page_utilization, 6))
    for name, (help_, value) in sorted((extra_gauges or {}).items()):
        gauge(name, help_, value)

    # TTFT histogram: cumulative le buckets + sum + count
    lines.append(f"# HELP {ns}_ttft_seconds Time to first token")
    lines.append(f"# TYPE {ns}_ttft_seconds histogram")
    xs = sorted(m.ttfts)
    i = 0
    cum = 0
    for le in TTFT_BUCKETS:
        while i < len(xs) and xs[i] <= le:
            i += 1
        cum = i
        lines.append(f'{ns}_ttft_seconds_bucket{{le="{le}"}} {cum}')
    lines.append(f'{ns}_ttft_seconds_bucket{{le="+Inf"}} {len(xs)}')
    lines.append(f"{ns}_ttft_seconds_sum {sum(xs)}")
    lines.append(f"{ns}_ttft_seconds_count {len(xs)}")
    return "\n".join(lines) + "\n"


def log_event(event: str, **fields):
    """Structured engine event (admit/preempt/finish/oom)."""
    if logger.isEnabledFor(logging.INFO):
        logger.info(json.dumps({"event": event, "t": time.time(), **fields}))
