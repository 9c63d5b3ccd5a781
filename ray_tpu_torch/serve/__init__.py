"""ray_tpu_torch.serve — online model serving on actors.

Port of the JAX package's serve: ``serve.run`` deploys an application
through the controller actor, which spawns its replicas (a replica
asking ``num_gpus=1`` gets one card); ``DeploymentHandle`` and the HTTP
proxy route requests to them. Every call takes the eager actor path;
the compiled dispatch plane (and ``BackPressureError``, its load
shedder's error) comes with the compiled graph. A ``decode=True``
deployment's callable provides ``create_decode_engine()``; its streams
ride the replica's continuous-batching ``decode.DecodeScheduler``, as
server-sent events over HTTP.
"""

from ray_tpu_torch.util.usage_stats import record_library_usage as _rlu
_rlu("serve")
del _rlu


from ray_tpu_torch.serve.api import (  # noqa: F401
    delete,
    get_deployment_handle,
    get_grpc_ingress,
    get_proxy_addresses,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.batching import batch  # noqa: F401
from ray_tpu_torch.serve.config import (  # noqa: F401
    AutoscalingConfig,
    HTTPOptions,
    gRPCOptions,
)
from ray_tpu_torch.serve.dag import DAGDriver, DAGNode, InputNode  # noqa: F401
from ray_tpu_torch.serve.deployment import (  # noqa: F401
    Application,
    Deployment,
    deployment,
)
from ray_tpu_torch.serve.handle import (  # noqa: F401
    DeploymentHandle,
    DeploymentResponse,
)
from ray_tpu_torch.serve.multiplex import (  # noqa: F401
    get_multiplexed_model_id,
    multiplexed,
)
from ray_tpu_torch.serve.observability import (  # noqa: F401
    get_request_id,
    serve_stats,
)
from ray_tpu_torch.serve.proxy import Request  # noqa: F401

__all__ = [
    "deployment", "Deployment", "Application", "run", "start", "shutdown",
    "status", "delete", "get_deployment_handle", "DeploymentHandle",
    "DeploymentResponse", "AutoscalingConfig", "HTTPOptions", "batch",
    "Request", "multiplexed", "get_multiplexed_model_id",
    "get_request_id", "serve_stats",
    "gRPCOptions", "get_grpc_ingress", "get_proxy_addresses",
    "InputNode", "DAGNode", "DAGDriver",
]
