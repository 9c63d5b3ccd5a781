"""Serve config dataclasses.

Reference: python/ray/serve/config.py (AutoscalingConfig, HTTPOptions) and
schema.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0
    metrics_interval_s: float = 0.2


@dataclass
class HTTPOptions:
    host: str = "127.0.0.1"
    port: int = 8000
    # "HeadOnly" (driver-resident proxy) or "EveryNode" (one proxy actor
    # per alive node, each on an OS-assigned port — reference:
    # ProxyLocation / proxy_state.py)
    proxy_location: str = "HeadOnly"


@dataclass
class gRPCOptions:
    """gRPC ingress config (reference: serve.config.gRPCOptions)."""

    host: str = "127.0.0.1"
    port: int = 0  # 0 = ephemeral
    request_timeout_s: float = 60.0


@dataclass
class DeploymentConfig:
    name: str
    num_replicas: int = 1
    max_ongoing_requests: int = 100
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    autoscaling_config: Optional[AutoscalingConfig] = None
    health_check_period_s: float = 2.0
    version: str = "1"
    user_config: Optional[Dict[str, Any]] = None
    route_prefix: Optional[str] = None
    # e2e latency above this (seconds) emits a WARNING cluster event with
    # the request's stage breakdown; None falls back to the global
    # serve_slow_request_threshold_s config, <= 0 disables
    slow_request_threshold_s: Optional[float] = None
