"""Learner / LearnerGroup: policy updates on the card, optionally across
learner actors.

Port of the JAX package's ``rllib/learner.py`` (reference:
rllib/core/learner/learner.py:116, compute_gradients :446 /
apply_gradients :568; learner_group.py:83). A JAX learner is one jitted
function (loss, grad, ``optax.chain(clip_by_global_norm, adam)``); here
it is autograd over the module's params and :class:`ClippedAdam`, the
optax chain written out (optax's clip rule and Adam's bias-corrected
moments, in ``torch._foreach`` ops: one launch per op for every leaf).

Device policy: a learner runs on ``cuda`` unless the config asks for
the CPU with ``learners(num_gpus_per_learner=0)`` (upstream Ray's name;
the port's default is 1), and raises where there is no card. Remote
learners (``num_learners >= 1``) are actors with
``num_gpus_per_learner`` cards each; their gradients sync by the mean
over an ``nccl`` collective group on cards or a ``gloo`` one on the CPU
(the JAX package's ``store`` group), and are clipped after the sync, as
the JAX learner applies its optimizer to the all-reduced grads.

The JAX learner's ``config.mesh`` (one jitted update over a device mesh
in one process) has no counterpart where a process drives one card:
the port refuses it and names ``num_learners``.
"""

from __future__ import annotations

import pickle
import uuid
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .rl_module import load_numpy, to_numpy


def learner_device(config) -> torch.device:
    """``cuda`` when the config gives a learner cards
    (``num_gpus_per_learner > 0``, the default), else the CPU. Raises
    ``RuntimeError`` where a card is wanted and none is there."""
    if getattr(config, "num_gpus_per_learner", 1) <= 0:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the RL learner runs on a CUDA device by default and none is "
            "available; pass .learners(num_gpus_per_learner=0) to run it "
            "on the CPU")
    return torch.device("cuda")


def to_tensors(batch: Mapping[str, Any], device) -> Dict[str, Any]:
    """A batch of numpy arrays (dicts of them nested, e.g. a target
    network's params) as tensors on ``device``; tensors move, arrays
    are copied."""
    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if isinstance(v, Mapping):
            out[k] = to_tensors(v, device)
        elif isinstance(v, torch.Tensor):
            out[k] = v.to(device)
        else:
            arr = np.asarray(v)
            if not arr.flags.writeable:  # a read-only view of the store
                arr = arr.copy()
            out[k] = torch.as_tensor(arr).to(device)
    return out


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: every leaf scaled by
    ``max_norm / norm`` when the global norm is at least ``max_norm``,
    untouched below it; no epsilon (``torch.nn.utils.clip_grad_norm_``
    divides by ``norm + 1e-6`` and scales from ``max_norm - 1e-6``).
    Decided on the device: no host sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    return list(torch._foreach_mul(grads, scale))


class ClippedAdam:
    """``optax.chain(clip_by_global_norm(grad_clip), adam(lr))`` (the
    clip left out when ``grad_clip`` is None), applied in place:
    ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``,
    ``p -= lr * mu_hat / (sqrt(nu_hat) + eps)`` with both moments
    bias-corrected by the step count, in optax's order of operations.
    The corrections ``1 - b**count`` are taken in float32 as optax takes
    them: ``1 - 0.999`` in float32 is 1.3e-5 off, which moves every
    early step by about 6e-6 of itself. The state is plain tensors, and
    :meth:`state_dict` gives numpy arrays, so a checkpoint taken on the
    card restores on the CPU."""

    def __init__(self, params: Mapping[str, torch.Tensor], lr: float,
                 grad_clip: Optional[float] = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.names = list(params)
        self.lr, self.grad_clip = lr, grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params.values()]
        self.nu = [torch.zeros_like(m) for m in self.mu]

    def _bias_correction(self, decay: float) -> float:
        one = np.float32(1.0)
        return float(one - np.power(np.float32(decay),
                                    np.float32(self.count)))

    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor]) -> None:
        if self.grad_clip is not None:
            grads = clip_by_global_norm(grads, self.grad_clip)
        self.count += 1
        b1, b2 = self.b1, self.b2
        with torch.no_grad():
            torch._foreach_mul_(self.mu, b1)
            torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(self.nu, b2)
            torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
            update = torch._foreach_div(self.mu, self._bias_correction(b1))
            denom = torch._foreach_div(self.nu, self._bias_correction(b2))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            torch._foreach_div_(update, denom)
            torch._foreach_mul_(update, -self.lr)
            torch._foreach_add_(list(params), update)

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count,
                "mu": {k: t.cpu().numpy().copy()
                       for k, t in zip(self.names, self.mu)},
                "nu": {k: t.cpu().numpy().copy()
                       for k, t in zip(self.names, self.nu)}}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self.count = int(state["count"])
        for part in ("mu", "nu"):
            for t, k in zip(getattr(self, part), self.names):
                t.copy_(torch.as_tensor(np.asarray(state[part][k])))


def grads_of(loss: torch.Tensor, params: Sequence[torch.Tensor]
             ) -> List[torch.Tensor]:
    """d loss / d param for each param, zeros for a param the loss does
    not use (as ``jax.grad`` gives; e.g. DQN's value tower)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def mean_stats(names: Sequence[str], rows: List[torch.Tensor]
               ) -> Dict[str, float]:
    """The mean over updates of each stat (one host sync for all)."""
    if not rows:
        return {}
    means = torch.stack(rows).double().mean(0).tolist()
    return dict(zip(names, means))


class Learner:
    """Owns the module's params and optimizer state on its device; runs
    minibatch updates."""

    def __init__(self, module, config, loss_fn: Callable,
                 collective_group: Optional[str] = None):
        if getattr(config, "mesh", None) is not None:
            raise ValueError(
                "config.mesh (a device mesh under one learner process) has "
                "no counterpart in the port: one learner drives one card; "
                "use .learners(num_learners=N) for N learners on N cards")
        self.config = config
        self.device = learner_device(config)
        self.loss_fn = loss_fn  # (module, params, minibatch) -> (loss, stats)
        self._collective_group = collective_group
        module.init_params(torch.Generator().manual_seed(config.seed))
        self.module = module.to(self.device)
        self.params = self.module.params()
        self.optimizer = ClippedAdam(self.params, config.lr,
                                     getattr(config, "grad_clip", 0.5))
        self.stat_names: List[str] = []

    # ---- one update, in the reference's two halves ----

    def compute_gradients(self, minibatch: Mapping[str, Any]):
        """``(loss, stats, grads)`` of the loss at the current params;
        ``grads`` in the order of ``self.params``."""
        loss, stats = self.loss_fn(self.module, self.params, minibatch)
        return loss.detach(), {k: v.detach() for k, v in stats.items()}, \
            grads_of(loss, list(self.params.values()))

    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> None:
        self.optimizer.step(list(self.params.values()), grads)

    def _step(self, minibatch) -> torch.Tensor:
        _, stats, grads = self.compute_gradients(minibatch)
        if self._collective_group is not None:
            grads = self._allreduce(grads)
        self.apply_gradients(grads)
        self.stat_names = list(stats)
        return torch.stack(list(stats.values()))

    def update(self, flat_batch: Dict[str, np.ndarray], *, num_epochs: int,
               minibatch_size: int, rng: Optional[np.random.Generator] = None,
               sequence_batch: bool = False) -> Dict[str, float]:
        """SGD epochs over shuffled minibatches; returns mean stats.

        ``sequence_batch``: the batch is time-major [T, N] sequences (e.g.
        IMPALA/V-trace) consumed whole — no row shuffling or minibatching.
        The batch moves to the device once; minibatches are gathered
        there, in the order the JAX learner takes them.
        """
        batch = to_tensors(flat_batch, self.device)
        rows: List[torch.Tensor] = []
        if sequence_batch:
            for _ in range(num_epochs):
                rows.append(self._step(batch))
            return mean_stats(self.stat_names, rows)
        rng = rng or np.random.default_rng(0)
        n = len(flat_batch["actions"])
        mbs = min(minibatch_size, n)
        for _ in range(num_epochs):
            perm = torch.from_numpy(rng.permutation(n)).to(self.device)
            for start in range(0, n - mbs + 1, mbs):
                idx = perm[start:start + mbs]
                rows.append(self._step({k: v[idx] for k, v in batch.items()}))
        return mean_stats(self.stat_names, rows)

    def _allreduce(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The mean over the group's learners, as one flat buffer."""
        from ray_tpu_torch import collective
        from ray_tpu_torch.collective.types import ReduceOp

        flat = torch.cat([g.reshape(-1) for g in grads])
        flat = collective.allreduce(flat, group_name=self._collective_group,
                                    op=ReduceOp.MEAN)
        out, start = [], 0
        for g in grads:
            out.append(flat[start:start + g.numel()].view_as(g))
            start += g.numel()
        return out

    # ---- weights ----

    def get_weights(self) -> Dict[str, np.ndarray]:
        return to_numpy(self.module)

    def set_weights(self, weights) -> None:
        load_numpy(self.module, weights)

    def get_state(self) -> bytes:
        return pickle.dumps({"params": self.get_weights(),
                             "opt_state": self.optimizer.state_dict()})

    def set_state(self, blob: bytes) -> None:
        state = pickle.loads(blob)
        self.set_weights(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])


class _LearnerActor:
    """One remote learner: joins the group's collective (NCCL on a card,
    gloo on the CPU), then builds its learner."""

    def __init__(self, spec, cfg, loss, obs_space, act_space, rank: int,
                 world: int, group_name: str):
        from ray_tpu_torch import collective

        from .env_runner import fit_threads_to_reservation

        fit_threads_to_reservation()
        backend = "nccl" if learner_device(cfg).type == "cuda" else "gloo"
        collective.init_collective_group(world, rank, backend=backend,
                                         group_name=group_name)
        self.learner = Learner(spec.build(obs_space, act_space), cfg, loss,
                               collective_group=group_name)

    def update(self, shard, num_epochs, minibatch_size, seed):
        return self.learner.update(shard, num_epochs=num_epochs,
                                   minibatch_size=minibatch_size,
                                   rng=np.random.default_rng(seed))

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, w):
        self.learner.set_weights(w)

    def get_state(self):
        return self.learner.get_state()

    def set_state(self, blob):
        self.learner.set_state(blob)

    def device(self) -> Dict[str, Any]:
        """The learner's device and the cards its process sees."""
        import os

        return {"device": str(self.learner.device),
                "cuda_visible_devices":
                    os.environ.get("CUDA_VISIBLE_DEVICES")}


class LearnerGroup:
    """One local learner (num_learners=0) or N learner actors with
    collective gradient sync (num_learners>=1)."""

    def __init__(self, config, module_spec, obs_space, act_space, loss_fn):
        self.config = config
        self._local: Optional[Learner] = None
        self._actors: List[Any] = []
        if config.num_learners <= 0:
            module = module_spec.build(obs_space, act_space)
            self._local = Learner(module, config, loss_fn)
            return
        import ray_tpu_torch as rt

        group = f"learners_{uuid.uuid4().hex[:12]}"
        actor_cls = rt.remote(num_cpus=config.num_cpus_per_learner,
                              num_gpus=config.num_gpus_per_learner)(
            _LearnerActor)
        world = config.num_learners
        cfg = config.copy()
        self._actors = [
            actor_cls.remote(module_spec, cfg, loss_fn, obs_space, act_space,
                             rank, world, group)
            for rank in range(world)]
        # start from identical weights
        w0 = rt.get(self._actors[0].get_weights.remote())
        rt.get([a.set_weights.remote(w0) for a in self._actors[1:]])

    def update(self, flat_batch, *, num_epochs, minibatch_size, seed=0,
               sequence_batch: bool = False):
        if self._local is not None:
            return self._local.update(flat_batch, num_epochs=num_epochs,
                                      minibatch_size=minibatch_size,
                                      rng=np.random.default_rng(seed),
                                      sequence_batch=sequence_batch)
        if sequence_batch:
            raise NotImplementedError(
                "sequence (time-major) batches are not sharded across "
                "remote learners yet; use num_learners=0")
        import ray_tpu_torch as rt

        n = len(flat_batch["actions"])
        world = len(self._actors)
        if n < world:
            raise ValueError(
                f"train batch of {n} rows cannot shard over {world} "
                f"learners; raise train_batch_size or lower num_learners")
        per = n // world
        mbs = max(1, minibatch_size // world)
        refs = []
        for rank, a in enumerate(self._actors):
            shard = {k: v[rank * per:(rank + 1) * per]
                     for k, v in flat_batch.items()}
            # same seed everywhere: ranks must take identical minibatch
            # counts/order for the allreduce schedule to line up
            refs.append(a.update.remote(shard, num_epochs, mbs, seed))
        stats = rt.get(refs)
        keys = stats[0].keys() if stats else ()
        return {k: float(np.mean([s[k] for s in stats])) for k in keys}

    def get_weights(self):
        if self._local is not None:
            return self._local.get_weights()
        import ray_tpu_torch as rt

        return rt.get(self._actors[0].get_weights.remote())

    def set_weights(self, w):
        if self._local is not None:
            self._local.set_weights(w)
            return
        import ray_tpu_torch as rt

        rt.get([a.set_weights.remote(w) for a in self._actors])

    def get_state(self):
        if self._local is not None:
            return self._local.get_state()
        import ray_tpu_torch as rt

        return rt.get(self._actors[0].get_state.remote())

    def set_state(self, blob):
        if self._local is not None:
            self._local.set_state(blob)
            return
        import ray_tpu_torch as rt

        rt.get([a.set_state.remote(blob) for a in self._actors])

    def stop(self) -> None:
        """Kill the learner actors (their cards go back to the pool)."""
        import ray_tpu_torch as rt

        for a in self._actors:
            rt.kill(a)
        self._actors = []
