"""Autoscaler: reconcile cluster size against pending resource demand
(port of ``ray_tpu/autoscaler/``).

Reference: autoscaler v2 (python/ray/autoscaler/v2/autoscaler.py:42 — a
periodic reconciler reading demand from GCS load reports and instance
state from a cloud provider) and the v1 StandardAutoscaler
(_private/autoscaler.py:172). A node is a *host joining over TCP* (the
``python -m ray_tpu_torch start`` daemon), and the cloud-provider seam is
:class:`NodeProvider` — the local subprocess provider is fully
functional (used in tests and single-machine elasticity, handing each
node its own cards); :class:`CallbackNodeProvider` maps node requests
onto an operator-supplied launcher.
"""

from ray_tpu_torch.autoscaler.autoscaler import Autoscaler, AutoscalerConfig  # noqa: F401
from ray_tpu_torch.autoscaler.node_provider import (  # noqa: F401
    CallbackNodeProvider,
    LocalNodeProvider,
    NodeProvider,
)

__all__ = ["Autoscaler", "AutoscalerConfig", "NodeProvider",
           "LocalNodeProvider", "CallbackNodeProvider"]
