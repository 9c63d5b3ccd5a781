"""Node providers: the cloud seam of the autoscaler (port of
``ray_tpu/autoscaler/node_provider.py``).

Reference: python/ray/autoscaler/node_provider.py (NodeProvider interface:
create_node/terminate_node/non_terminated_nodes) and the per-cloud
implementations under python/ray/autoscaler/_private/. Here the
interface is minimal and synchronous; the reconciler serializes calls.
The JAX package's ``TPUQueuedResourceProvider`` (``gcloud compute tpus
queued-resources`` for TPU VMs) has no counterpart on a GPU host and is
not ported; an operator's own launcher plugs into
:class:`CallbackNodeProvider`.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional


class NodeProvider:
    """Create/terminate worker nodes. Implementations must be idempotent
    on terminate and report only their own (non-head) nodes."""

    def create_node(self, node_config: dict) -> str:
        raise NotImplementedError

    def terminate_node(self, provider_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError

    def is_running(self, provider_id: str) -> bool:
        return provider_id in self.non_terminated_nodes()

    def shutdown(self) -> None:
        for pid in list(self.non_terminated_nodes()):
            self.terminate_node(pid)


class LocalNodeProvider(NodeProvider):
    """Worker nodes as local ``python -m ray_tpu_torch start`` daemon
    processes joining the head over TCP — the autoscaler analog of the
    reference's 'local' provider, and the test double for cloud
    providers (every launched node is a REAL separate-process node
    daemon).

    A node config's ``num_gpus`` takes that many of this host's cards:
    the daemon is started under the ``CUDA_VISIBLE_DEVICES`` that
    :func:`~ray_tpu_torch.core.accelerators.bind_gpus` gives for its
    slots (through the list this process inherited), so two daemons
    never advertise the same card. The slots are the cards visible to
    this process; a node is refused when not enough are free, and its
    cards return to the pool when it is terminated."""

    def __init__(self, head_address, cluster_key_hex: str):
        from ray_tpu_torch.core.accelerators import (detect_num_gpus,
                                                     visible_devices)

        self._address = f"{head_address[0]}:{head_address[1]}"
        self._key = cluster_key_hex
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()
        self._inherited = visible_devices()
        self._free_gpus: List[int] = list(range(detect_num_gpus()))
        self._gpus: Dict[str, List[int]] = {}   # provider id -> slots

    def _take_gpus(self, provider_id: str, n: int) -> Optional[str]:
        """Reserve ``n`` card slots for a node; its CUDA_VISIBLE_DEVICES
        (None for a node without cards)."""
        from ray_tpu_torch.core.accelerators import bind_gpus

        if n <= 0:
            return None
        with self._lock:
            if len(self._free_gpus) < n:
                raise RuntimeError(
                    f"node asks for {n} GPU(s); {len(self._free_gpus)} of "
                    "this host's cards are free")
            slots, self._free_gpus = self._free_gpus[:n], \
                self._free_gpus[n:]
            self._gpus[provider_id] = slots
        return bind_gpus(slots, self._inherited)

    def _release_gpus(self, provider_id: str) -> None:
        with self._lock:
            self._free_gpus = sorted(self._free_gpus
                                     + self._gpus.pop(provider_id, []))

    def create_node(self, node_config: dict) -> str:
        import json

        provider_id = f"local-{uuid.uuid4().hex[:8]}"
        num_gpus = int(node_config.get("num_gpus", 0) or 0)
        cmd = [sys.executable, "-m", "ray_tpu_torch", "start",
               "--address", self._address, "--key", self._key,
               # the provider_id label is how the reconciler maps a
               # cluster node back to this instance for termination
               "--labels", json.dumps({"provider_id": provider_id}),
               # explicit counts — never auto-detect (a co-located node
               # already advertises this host's cards)
               "--num-cpus", str(node_config.get("num_cpus", 1)),
               "--num-gpus", str(num_gpus)]
        if node_config.get("resources"):
            cmd += ["--resources", json.dumps(node_config["resources"])]
        env = dict(os.environ)
        cuda_visible = self._take_gpus(provider_id, num_gpus)
        if cuda_visible is not None:
            env["CUDA_VISIBLE_DEVICES"] = cuda_visible
        repo = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        try:
            proc = subprocess.Popen(cmd, env=env, start_new_session=True,
                                    stdout=subprocess.DEVNULL,
                                    stderr=subprocess.DEVNULL)
        except OSError:
            self._release_gpus(provider_id)
            raise
        with self._lock:
            self._procs[provider_id] = proc
        return provider_id

    def gpus_of(self, provider_id: str) -> List[int]:
        """The card slots a node holds (indices into this host's cards)."""
        with self._lock:
            return list(self._gpus.get(provider_id, ()))

    def terminate_node(self, provider_id: str) -> None:
        with self._lock:
            proc = self._procs.pop(provider_id, None)
        if proc is None:
            return
        self._release_gpus(provider_id)
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            return
        deadline = time.time() + 3.0
        while time.time() < deadline and proc.poll() is None:
            time.sleep(0.05)
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass

    def non_terminated_nodes(self) -> List[str]:
        with self._lock:
            return [pid for pid, proc in self._procs.items()
                    if proc.poll() is None]


class CallbackNodeProvider(NodeProvider):
    """Provisioning seam of injected callables (the counterpart of the
    JAX package's ``TPUSliceProvider``).

    Zero-egress environments can't call cloud APIs, so actual
    provisioning is delegated to operator-supplied callables — e.g.
    wrappers over a cloud's instance API or a KubeRay-style CRD
    reconciler that starts ``python -m ray_tpu_torch start`` on each new
    host. The autoscaler treats each launch as one atomic node: one
    create_node call = one launch_fn call (the reference's per-VM cloud
    providers).
    """

    def __init__(self, launch_fn: Callable[[dict], str],
                 terminate_fn: Callable[[str], None],
                 list_fn: Callable[[], List[str]]):
        self._launch = launch_fn
        self._terminate = terminate_fn
        self._list = list_fn

    def create_node(self, node_config: dict) -> str:
        return self._launch(node_config)

    def terminate_node(self, provider_id: str) -> None:
        self._terminate(provider_id)

    def non_terminated_nodes(self) -> List[str]:
        return list(self._list())
