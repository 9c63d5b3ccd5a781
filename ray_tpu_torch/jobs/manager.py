"""JobManager (head-side) + JobSubmissionClient (REST client); port of
``ray_tpu/jobs/manager.py``.

Reference: python/ray/dashboard/modules/job/job_manager.py (submit_job →
driver subprocess with RAY_ADDRESS env; status polling via actor),
common.py (JobStatus/JobInfo), sdk.py (JobSubmissionClient over HTTP).

The driver subprocess here connects back through the head's ClientServer
(core/client_server.py) via ``RAY_TPU_ADDRESS``/``RAY_TPU_CLUSTER_KEY`` —
a real shared-cluster driver, not a fresh local cluster. Logs stream to a
per-job file; stop sends SIGTERM then SIGKILL to the process group.
"""

from __future__ import annotations

import json
import os
import shlex
import signal
import subprocess
import tempfile
import threading
import time
import uuid
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


@dataclass
class JobInfo:
    submission_id: str
    entrypoint: str
    status: str = JobStatus.PENDING
    message: str = ""
    start_time: float = 0.0
    end_time: Optional[float] = None
    metadata: Dict[str, str] = field(default_factory=dict)
    runtime_env: Dict[str, Any] = field(default_factory=dict)
    driver_exit_code: Optional[int] = None
    stop_requested: bool = False

    def to_dict(self) -> dict:
        return asdict(self)


class JobManager:
    """Spawns and tracks job driver subprocesses."""

    def __init__(self, client_address=None, cluster_key_hex: Optional[str] = None,
                 log_dir: Optional[str] = None):
        self._jobs: Dict[str, JobInfo] = {}
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()
        self._client_address = client_address
        self._cluster_key_hex = cluster_key_hex
        self._log_dir = log_dir or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch_jobs")
        os.makedirs(self._log_dir, exist_ok=True)

    # ---- API --------------------------------------------------------------
    def submit_job(self, entrypoint: str,
                   runtime_env: Optional[Dict[str, Any]] = None,
                   metadata: Optional[Dict[str, str]] = None,
                   submission_id: Optional[str] = None) -> str:
        submission_id = submission_id or f"raytpu-job-{uuid.uuid4().hex[:10]}"
        with self._lock:
            if submission_id in self._jobs:
                raise ValueError(f"job {submission_id} already exists")
            info = JobInfo(submission_id=submission_id,
                           entrypoint=entrypoint,
                           metadata=dict(metadata or {}),
                           runtime_env=dict(runtime_env or {}),
                           start_time=time.time())
            self._jobs[submission_id] = info

        env = dict(os.environ)
        renv = runtime_env or {}
        env.update({str(k): str(v)
                    for k, v in (renv.get("env_vars") or {}).items()})
        if self._client_address is not None:
            host, port = self._client_address
            env["RAY_TPU_ADDRESS"] = f"ray_tpu://{host}:{port}"
        if self._cluster_key_hex:
            env["RAY_TPU_CLUSTER_KEY"] = self._cluster_key_hex
        env["RAY_TPU_JOB_SUBMISSION_ID"] = submission_id
        cwd = renv.get("working_dir") or os.getcwd()

        log_path = self.log_path(submission_id)
        logf = open(log_path, "ab", buffering=0)
        try:
            proc = subprocess.Popen(
                entrypoint, shell=True, cwd=cwd, env=env,
                stdout=logf, stderr=subprocess.STDOUT,
                start_new_session=True)  # own pgid: stop kills the tree
        except OSError as e:
            info.status = JobStatus.FAILED
            info.message = f"failed to spawn: {e}"
            info.end_time = time.time()
            logf.close()
            return submission_id
        finally:
            logf.close()
        with self._lock:
            info.status = JobStatus.RUNNING
            info.message = "driver running"
            self._procs[submission_id] = proc
        threading.Thread(target=self._monitor,
                         args=(submission_id, proc),
                         name=f"job-{submission_id}", daemon=True).start()
        return submission_id

    def _monitor(self, submission_id: str, proc: subprocess.Popen) -> None:
        rc = proc.wait()
        with self._lock:
            info = self._jobs[submission_id]
            self._procs.pop(submission_id, None)
            # the monitor is the single writer of terminal status: a clean
            # exit-0 that raced an (undelivered) stop is SUCCEEDED, not
            # STOPPED
            if rc == 0:
                info.status = JobStatus.SUCCEEDED
                info.message = "driver exited 0"
            elif info.stop_requested:
                info.status = JobStatus.STOPPED
                info.message = "stopped by user"
            else:
                info.status = JobStatus.FAILED
                info.message = f"driver exited {rc}"
            info.driver_exit_code = rc
            info.end_time = time.time()

    def stop_job(self, submission_id: str) -> bool:
        with self._lock:
            info = self._jobs.get(submission_id)
            proc = self._procs.get(submission_id)
            if info is None:
                raise KeyError(submission_id)
            if proc is None or proc.poll() is not None:
                return False  # already terminal; _monitor records the truth
            info.stop_requested = True
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            return False
        deadline = time.time() + 3.0
        while time.time() < deadline:
            if proc.poll() is not None:
                return True
            time.sleep(0.05)
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        return True

    def delete_job(self, submission_id: str) -> bool:
        with self._lock:
            info = self._jobs.get(submission_id)
            if info is None:
                raise KeyError(submission_id)
            if info.status not in JobStatus.TERMINAL:
                raise RuntimeError(
                    f"job {submission_id} is {info.status}; stop it first")
            del self._jobs[submission_id]
        try:
            os.remove(self.log_path(submission_id))
        except OSError:
            pass
        return True

    def get_job_status(self, submission_id: str) -> str:
        with self._lock:
            info = self._jobs.get(submission_id)
        if info is None:
            raise KeyError(submission_id)
        return info.status

    def get_job_info(self, submission_id: str) -> JobInfo:
        with self._lock:
            info = self._jobs.get(submission_id)
        if info is None:
            raise KeyError(submission_id)
        return info

    def list_jobs(self) -> List[JobInfo]:
        with self._lock:
            return list(self._jobs.values())

    def log_path(self, submission_id: str) -> str:
        return os.path.join(self._log_dir, f"{submission_id}.log")

    def read_job_logs(self, submission_id: str, offset: int = 0):
        """(text, next_byte_offset) from byte ``offset``. Tailers must
        carry ``next_byte_offset`` (not len(text): decoding with
        errors='replace' changes lengths for non-UTF-8 / torn multibyte
        tails, which would desynchronize a re-encoded offset)."""
        with self._lock:
            if submission_id not in self._jobs:
                raise KeyError(submission_id)
        try:
            with open(self.log_path(submission_id), "rb") as f:
                if offset:
                    f.seek(offset)
                data = f.read()
                return data.decode(errors="replace"), offset + len(data)
        except OSError:
            return "", offset

    def get_job_logs(self, submission_id: str, offset: int = 0) -> str:
        return self.read_job_logs(submission_id, offset)[0]

    def shutdown(self) -> None:
        with self._lock:
            procs = list(self._procs.items())
        for sid, proc in procs:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except Exception:
                pass


# --------------------------------------------------------------------------- #
# REST client (reference: dashboard/modules/job/sdk.py JobSubmissionClient)
# --------------------------------------------------------------------------- #


class JobSubmissionClient:
    """HTTP client against the dashboard's /api/jobs endpoints.

    ``auth_token`` (or env ``RAY_TPU_JOB_TOKEN``) is required when the
    dashboard was started on a non-loopback interface."""

    def __init__(self, address: str, auth_token: Optional[str] = None):
        self._base = address.rstrip("/")
        if not self._base.startswith("http"):
            self._base = "http://" + self._base
        self._token = auth_token or os.environ.get("RAY_TPU_JOB_TOKEN", "")

    def _request(self, method: str, path: str,
                 body: Optional[dict] = None) -> Any:
        import urllib.error
        import urllib.request

        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        req = urllib.request.Request(
            self._base + path, data=data, method=method, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                raw = resp.read().decode()
                ctype = resp.headers.get_content_type()
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")
            raise RuntimeError(
                f"{method} {path} -> {e.code}: {detail}") from None
        return json.loads(raw) if ctype == "application/json" else raw

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[dict] = None,
                   metadata: Optional[dict] = None,
                   submission_id: Optional[str] = None) -> str:
        out = self._request("POST", "/api/jobs/", {
            "entrypoint": entrypoint, "runtime_env": runtime_env,
            "metadata": metadata, "submission_id": submission_id,
        })
        return out["submission_id"]

    def get_job_status(self, submission_id: str) -> str:
        return self._request("GET", f"/api/jobs/{submission_id}")["status"]

    def get_job_info(self, submission_id: str) -> dict:
        return self._request("GET", f"/api/jobs/{submission_id}")

    def list_jobs(self) -> List[dict]:
        return self._request("GET", "/api/jobs/")

    def get_job_logs(self, submission_id: str, offset: int = 0) -> str:
        return self._get_logs(submission_id, offset)[0]

    def _get_logs(self, submission_id: str, offset: int = 0):
        """(text, next_byte_offset) — offset from the X-Next-Offset header
        so polling stays byte-accurate across encodings."""
        import urllib.error
        import urllib.request

        path = f"/api/jobs/{submission_id}/logs"
        if offset:
            path += f"?offset={offset}"
        req = urllib.request.Request(self._base + path)
        if self._token:
            req.add_header("Authorization", f"Bearer {self._token}")
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                text = resp.read().decode(errors="replace")
                nxt = int(resp.headers.get("X-Next-Offset") or offset)
        except urllib.error.HTTPError as e:
            raise RuntimeError(
                f"GET {path} -> {e.code}: "
                f"{e.read().decode(errors='replace')}") from None
        return text, nxt

    def stop_job(self, submission_id: str) -> bool:
        return self._request(
            "POST", f"/api/jobs/{submission_id}/stop")["stopped"]

    def delete_job(self, submission_id: str) -> bool:
        return self._request(
            "DELETE", f"/api/jobs/{submission_id}")["deleted"]

    def tail_job_logs(self, submission_id: str, interval: float = 0.5):
        """Generator yielding log increments until the job terminates.
        Polls with a byte offset so each request transfers only new text."""
        seen = 0
        while True:
            chunk, seen = self._get_logs(submission_id, offset=seen)
            if chunk:
                yield chunk
            if self.get_job_status(submission_id) in JobStatus.TERMINAL:
                rest, seen = self._get_logs(submission_id, offset=seen)
                if rest:
                    yield rest
                return
            time.sleep(interval)
