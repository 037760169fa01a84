"""Serving — port of ``repro/serving``: the static-batch ``Engine`` and its
evaluation helpers.  The continuous-batching server comes in a later slice."""

from repro_torch.serving.engine import (
    KV_LOGIT_TOL,
    Engine,
    kv_oracle_logit_gap,
    perplexity,
    sample_token,
)

__all__ = ["KV_LOGIT_TOL", "Engine", "kv_oracle_logit_gap", "perplexity", "sample_token"]
