"""@serve.deployment decorator, Deployment, and bind() composition.

Port of ``ray_tpu/serve/deployment.py``, options included
(``decode=True`` makes a deployment's streams the decode plane's).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

from .config import AutoscalingConfig


class Application:
    """A bound deployment DAG node (reference: serve Application)."""

    def __init__(self, deployment: "Deployment", args: Tuple,
                 kwargs: Dict[str, Any]):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs

    def walk(self):
        """Yield child applications (dependencies) depth-first."""
        for a in list(self.args) + list(self.kwargs.values()):
            if isinstance(a, Application):
                yield from a.walk()
                yield a


class Deployment:
    def __init__(self, target: Union[type, Callable], name: str,
                 *, num_replicas: int = 1, max_ongoing_requests: int = 100,
                 ray_actor_options: Optional[Dict[str, Any]] = None,
                 autoscaling_config: Optional[
                     Union[AutoscalingConfig, dict]] = None,
                 user_config: Optional[dict] = None,
                 version: str = "1",
                 route_prefix: Optional[str] = "/",
                 health_check_period_s: float = 2.0,
                 stream: bool = False,
                 request_timeout_s: float = 60.0,
                 retry_on_replica_failure: bool = True,
                 slow_request_threshold_s: Optional[float] = None,
                 max_inflight: Optional[int] = None,
                 concurrency_budget: Optional[int] = None,
                 compiled_dispatch: Optional[bool] = None,
                 decode: bool = False,
                 bytes_body: bool = False):
        self._target = target
        self.name = name
        if isinstance(autoscaling_config, dict):
            autoscaling_config = AutoscalingConfig(**autoscaling_config)
        self._opts = dict(
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            ray_actor_options=ray_actor_options or {},
            autoscaling_config=autoscaling_config,
            user_config=user_config,
            version=version,
            route_prefix=route_prefix,
            health_check_period_s=health_check_period_s,
            stream=stream,
            request_timeout_s=request_timeout_s,
            retry_on_replica_failure=retry_on_replica_failure,
            slow_request_threshold_s=slow_request_threshold_s,
            max_inflight=max_inflight,
            concurrency_budget=concurrency_budget,
            compiled_dispatch=compiled_dispatch,
            decode=decode,
            bytes_body=bytes_body,
        )

    def options(self, **overrides) -> "Deployment":
        opts = dict(self._opts)
        name = overrides.pop("name", self.name)
        opts.update(overrides)
        auto = opts.pop("autoscaling_config", None)
        return Deployment(self._target, name,
                          autoscaling_config=auto, **opts)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    @property
    def func_or_class(self):
        return self._target

    def config_dict(self) -> dict:
        auto = self._opts["autoscaling_config"]
        return {
            "num_replicas": self._opts["num_replicas"],
            "max_ongoing_requests": self._opts["max_ongoing_requests"],
            "ray_actor_options": self._opts["ray_actor_options"],
            "autoscaling": {
                "min_replicas": auto.min_replicas,
                "max_replicas": auto.max_replicas,
                "target_ongoing_requests": auto.target_ongoing_requests,
                "upscale_delay_s": auto.upscale_delay_s,
                "downscale_delay_s": auto.downscale_delay_s,
            } if auto else None,
            "user_config": self._opts["user_config"],
            "version": self._opts["version"],
            "route_prefix": self._opts["route_prefix"],
            "stream": self._opts.get("stream", False),
            "request_timeout_s": self._opts.get("request_timeout_s", 60.0),
            # a replica dying MID-REQUEST may have executed side effects:
            # users with non-idempotent endpoints disable redispatch
            # (reference: Serve gates request retries)
            "retry_on_replica_failure": self._opts.get(
                "retry_on_replica_failure", True),
            # e2e latency above this emits a WARNING cluster event with
            # the stage breakdown; None -> global config default
            "slow_request_threshold_s": self._opts.get(
                "slow_request_threshold_s"),
            # compiled dispatch plane (serve/compiled_dispatch.py):
            # per-replica admission window, per-deployment shed budget,
            # and the per-deployment plane toggle; None -> the
            # RAY_TPU_SERVE_* config defaults
            "max_inflight": self._opts.get("max_inflight"),
            "concurrency_budget": self._opts.get("concurrency_budget"),
            "compiled_dispatch": self._opts.get("compiled_dispatch"),
            # generative decode plane (serve/decode.py): the callable
            # provides create_decode_engine(); requests stream tokens
            # over compiled stream lanes with iteration-level batching
            "decode": self._opts.get("decode", False),
            # hand the raw HTTP body to __call__ as bytes (TAG_BYTES
            # fast lane: serializer skipped proxy->ring->replica)
            "bytes_body": self._opts.get("bytes_body", False),
        }

    def __repr__(self):
        return f"Deployment({self.name})"


def deployment(_target=None, *, name: Optional[str] = None, **opts):
    """Decorator: @serve.deployment or @serve.deployment(num_replicas=2)."""

    def wrap(target):
        return Deployment(target, name or target.__name__, **opts)

    if _target is not None:
        return wrap(_target)
    return wrap
