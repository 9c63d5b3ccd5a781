"""joblib backend: scikit-learn's Parallel over ray_tpu_torch actors.

Reference: python/ray/util/joblib (register_ray + RayBackend built on
ray.util.multiprocessing.Pool). Same construction here — joblib's
MultiprocessingBackend drives a pool object through apply_async, so the
cluster-backed :class:`ray_tpu_torch.util.multiprocessing.Pool` slots straight
in. Usage::

    from ray_tpu_torch.util.joblib_backend import register_ray_tpu
    import joblib

    register_ray_tpu()
    with joblib.parallel_backend("ray_tpu_torch", n_jobs=8):
        scores = cross_val_score(model, X, y)   # runs on the cluster
"""

from __future__ import annotations


def register_ray_tpu() -> None:
    from joblib._parallel_backends import MultiprocessingBackend
    from joblib.parallel import register_parallel_backend

    import ray_tpu_torch
    from ray_tpu_torch.util.multiprocessing import Pool

    class RayTpuBackend(MultiprocessingBackend):
        supports_timeout = True

        def effective_n_jobs(self, n_jobs):
            if n_jobs == 0:
                raise ValueError("n_jobs == 0 has no meaning")
            if n_jobs is None:
                return 1
            if n_jobs < 0:
                # joblib contract: -1 = all cluster CPUs, -2 = all but
                # one, ... (n_cpus + 1 + n_jobs)
                try:
                    cpus = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
                except Exception:
                    cpus = 1
                return max(1, cpus + 1 + n_jobs)
            return n_jobs

        def configure(self, n_jobs=1, parallel=None, prefer=None,
                      require=None, **_memmap_args):
            n_jobs = self.effective_n_jobs(n_jobs)
            self.parallel = parallel
            self._pool = Pool(processes=n_jobs)
            return n_jobs

        def terminate(self):
            if getattr(self, "_pool", None) is not None:
                self._pool.terminate()
                self._pool = None

    register_parallel_backend("ray_tpu_torch", RayTpuBackend)
