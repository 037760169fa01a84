"""Serving — port of ``repro/serving``: the static-batch ``Engine`` with its
evaluation helpers, and the continuous-batching ``Server`` over a slot pool
with its scheduler (``Request``, ``Scheduler``), ``SlotKVCache``,
telemetry and the step profiler (``StepProfiler``)."""

from repro_torch.serving.engine import (
    KV_LOGIT_TOL,
    Engine,
    kv_oracle_logit_gap,
    perplexity,
    sample_token,
)
from repro_torch.serving.kvcache import SlotKVCache
from repro_torch.serving.profiler import StepProfiler
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.server import Server
from repro_torch.serving.telemetry import NOOP, Telemetry

__all__ = ["KV_LOGIT_TOL", "NOOP", "Engine", "Request", "Scheduler", "Server", "SlotKVCache",
           "StepProfiler", "Telemetry", "kv_oracle_logit_gap", "perplexity", "sample_token"]
