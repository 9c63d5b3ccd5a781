"""Run a function of the port in ``world`` ranks: ``launch(fn, world, args)``.

Each rank is a fresh process (``python -m ray_tpu_torch.train.launch``)
that joins a ``torch.distributed`` process group, calls ``fn(*args)`` and
hands its result back; ``launch`` returns the results in rank order.

- CUDA (the default): NCCL, one card per rank (rank r uses ``cuda:r``).
  The kernels are built once here, before any rank starts, so the ranks
  never race to build them.
- ``device="cpu"``: gloo, each rank on one CPU thread.

The rendezvous is a file in a temporary directory, not a TCP port, so
launches that run side by side never collide. ``fn`` must be a function
of ``ray_tpu_torch``: a rank imports nothing else of the caller. A rank
that raises fails the launch with its traceback; a launch that outlasts
``timeout`` seconds kills every rank and raises. Ranks that fail to form
their process group, before any of them has run ``fn``, are started
again on a fresh rendezvous (:data:`RENDEZVOUS_ATTEMPTS` in all): gloo's
TCP mesh on one host fails now and then ("connectFullMesh failed ...
Connection closed by peer") when several launches start at once. The
ranks stay in the caller's process group, and on Linux the kernel kills
each rank when the launching process dies, so a launcher killed from
outside leaves no rank running.
"""

from __future__ import annotations

import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, List, Sequence

PACKAGE = "ray_tpu_torch"
ROOT = Path(__file__).resolve().parents[2]
# times a launch starts its ranks, while they fail to form their process
# group; the launch's deadline covers them all
RENDEZVOUS_ATTEMPTS = 3


class _RendezvousFailed(RuntimeError):
    """A rank failed while joining its process group, before ``fn``."""


def launch(fn: Callable, world: int, args: Sequence[Any] = (),
           device=None, timeout: float = 600.0) -> List[Any]:
    """``fn(*args)`` in each of ``world`` ranks; their results by rank.
    A rank's standard output goes to this process's standard error."""
    import torch

    from ray_tpu_torch import resolve_device

    dev = resolve_device(device)
    if not fn.__module__.startswith(PACKAGE + "."):
        raise ValueError(f"a rank runs functions of {PACKAGE} only, not "
                         f"{fn.__module__}.{fn.__qualname__}")
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        if world > have:
            raise RuntimeError(f"{world} ranks need {world} CUDA devices, "
                               f"have {have}")
        from ray_tpu_torch.ops import _build

        _build.build(list(_build.LIBRARIES))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    deadline = time.monotonic() + timeout
    for attempt in range(RENDEZVOUS_ATTEMPTS):
        try:
            return _launch_once(fn, world, args, dev.type, backend, attempt,
                                deadline, timeout)
        except _RendezvousFailed as e:
            failed = e
    raise RuntimeError(f"{world} ranks could not form their process group "
                       f"in {RENDEZVOUS_ATTEMPTS} attempts; the last:\n"
                       f"{failed}")


def _launch_once(fn, world, args, device, backend, attempt, deadline,
                 timeout):
    """One start of the ranks on a fresh rendezvous; their results."""
    work = Path(tempfile.mkdtemp(prefix="ray_tpu_torch_launch_"))
    try:
        (work / "job.pkl").write_bytes(pickle.dumps({
            "module": fn.__module__, "name": fn.__qualname__,
            "args": tuple(args), "world": world, "backend": backend,
            "device": device, "attempt": attempt,
            "init_method": f"file://{work / 'rendezvous'}"}))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
                os.pathsep) if p])
        procs = [subprocess.Popen(
            [sys.executable, "-m", f"{PACKAGE}.train.launch", str(work),
             str(rank), str(os.getpid())], env=env, cwd=str(ROOT),
            stdout=2)
            for rank in range(world)]
        try:
            _wait(procs, work, deadline, timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return [pickle.loads((work / f"result-{r}.pkl").read_bytes())
                for r in range(world)]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def loaded_modules() -> List[str]:
    """The modules a rank has loaded (run through :func:`launch`, it shows
    what a rank process imports)."""
    return sorted(sys.modules)


def _wait(procs, work: Path, deadline: float, timeout: float) -> None:
    """Wait for every rank; raise on the first that fails (its peers may
    be blocked in a collective, so they are killed; _RendezvousFailed if
    it failed joining the process group) or at the deadline."""
    while True:
        codes = [p.poll() for p in procs]
        failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if failed:
            r = failed[0]
            joining = work / f"rendezvous-error-{r}.txt"
            if joining.is_file():
                raise _RendezvousFailed(f"rank {r} of {len(procs)} failed "
                                        f"joining its process group:\n"
                                        f"{joining.read_text()}")
            err = work / f"error-{r}.txt"
            why = err.read_text() if err.is_file() else \
                f"exit code {codes[r]}"
            raise RuntimeError(f"rank {r} of {len(procs)} failed:\n{why}")
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            raise RuntimeError(f"{len(procs)} ranks did not finish within "
                               f"{timeout:.0f} s; killed")
        time.sleep(0.05)


def _die_with(parent: int) -> None:
    """Have the kernel SIGKILL this process when ``parent`` dies (Linux's
    PR_SET_PDEATHSIG); exit now if it is already gone."""
    if sys.platform.startswith("linux"):
        import ctypes

        pr_set_pdeathsig = 1
        ctypes.CDLL(None, use_errno=True).prctl(pr_set_pdeathsig,
                                                signal.SIGKILL)
    if os.getppid() != parent:
        os._exit(1)


def _rank_main(work: Path, rank: int, parent: int) -> int:
    _die_with(parent)
    import importlib
    import traceback

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.core import fault_injection

    job = pickle.loads((work / "job.pkl").read_bytes())
    try:
        if job["device"] == "cuda":
            torch.cuda.set_device(rank)
        else:
            torch.set_num_threads(1)
        fault_injection.fire("launch.rendezvous", str(job["attempt"]))
        dist.init_process_group(job["backend"],
                                init_method=job["init_method"],
                                world_size=job["world"], rank=rank)
    except BaseException:
        (work / f"rendezvous-error-{rank}.txt").write_text(
            traceback.format_exc())
        return 1
    try:
        try:
            fn = getattr(importlib.import_module(job["module"]), job["name"])
            result = fn(*job["args"])
        finally:
            dist.destroy_process_group()
    except BaseException:
        (work / f"error-{rank}.txt").write_text(traceback.format_exc())
        return 1
    tmp = work / f"result-{rank}.pkl.tmp"
    tmp.write_bytes(pickle.dumps(result))
    os.replace(tmp, work / f"result-{rank}.pkl")
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(Path(sys.argv[1]), int(sys.argv[2]),
                        int(sys.argv[3])))
