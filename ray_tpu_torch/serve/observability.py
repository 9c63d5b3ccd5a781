"""Serve observability for the decode scheduler: the tokens-generated
counter and the inter-token-latency histogram (the part of
``ray_tpu/serve/observability.py`` that ``serve/decode.py`` uses).

The request-path rest of that module (request ids, per-stage latency
histograms, access logs, slow-request events) belongs to the serve
control plane and comes with the runtime's port. Metric names take the
port's ``port_`` prefix.
"""

from __future__ import annotations

from typing import Dict

from ray_tpu_torch.core.config import global_config
from ray_tpu_torch.util.metrics import Counter, Histogram, tags_key

_WAIT_BUCKETS = [0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0, 2.5, 5.0, 10.0]

ITL = Histogram(
    "port_serve_itl_seconds",
    "Inter-token latency: gap between consecutive token chunks "
    "streamed for one decode sequence",
    boundaries=_WAIT_BUCKETS, tag_keys=("deployment",))
TOKENS_GENERATED = Counter(
    "port_serve_tokens_generated_total",
    "Tokens emitted by the generative-decode plane",
    tag_keys=("deployment",))


def enabled() -> bool:
    return bool(global_config().serve_observability_enabled)


# hot-path tag keys, memoized per deployment: building and sorting a tags
# dict per record costs more than the record itself at token rate
_key_cache: Dict[tuple, tuple] = {}


def dep_key(deployment: str) -> tuple:
    k = ("d", deployment)
    v = _key_cache.get(k)
    if v is None:
        v = _key_cache[k] = tags_key({"deployment": deployment})
    return v
