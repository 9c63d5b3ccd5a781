"""RLModule: the policy and value networks as a ``torch.nn.Module``.

Port of the JAX package's ``rllib/rl_module.py`` (reference:
rllib/core/rl_module/rl_module.py:271, spec :48). The JAX module is a
pair of pure functions over a params pytree; here the params are the
module's own ``nn.Parameter`` s, named as the JAX keys (``pi_w0``,
``pi_b0``, ..., ``vf_out_b``) with weights laid out ``[in, out]``
(``x @ w + b``), so one flat dict of numpy arrays loads into either.
``TorchRLModule.forward_with(params, obs)`` is the functional form
the losses call (it takes any dict of tensors under those names, e.g.
a target network's); ``forward`` applies the module's own params.

The JAX init draws ``normal * sqrt(2 / fan_in)`` from a PRNG key; the
port draws the same distribution from an explicit ``torch.Generator``
on the CPU (:meth:`TorchRLModule.init_params`), so a learner on the card
and one on the CPU start from the same params. The two RNGs never
agree: parity tests carry params across with :func:`from_jax_params`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch
from torch import nn

ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu}


def from_jax_params(params: Mapping[str, Any], prefix: str = ""
                    ) -> Dict[str, torch.Tensor]:
    """A JAX params tree (numpy or JAX arrays, dicts nested by module
    part) as a flat state dict: nested keys joined by ``.``, as
    ``nn.Module.state_dict`` names them."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in params.items():
        if isinstance(v, Mapping):
            out.update(from_jax_params(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.as_tensor(np.array(v))
    return out


def to_numpy(module: nn.Module) -> Dict[str, np.ndarray]:
    """The module's params as a flat dict of numpy arrays (copies)."""
    return {k: v.detach().cpu().numpy().copy()
            for k, v in module.state_dict().items()}


def load_numpy(module: nn.Module, weights: Mapping[str, Any]) -> None:
    """Copy a flat dict of arrays (numpy or tensors) into the module's
    params, in place: no new storage, whatever device they are on."""
    params = dict(module.named_parameters())
    missing = set(params) ^ set(weights)
    if missing:
        raise KeyError(f"weights do not match the module's params: "
                       f"{sorted(missing)}")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(torch.tensor(np.asarray(weights[k])))


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * scale


class TorchRLModule(nn.Module):
    """Discrete-action policy and value function, separate towers.

    ``forward(obs) -> (logits [B, num_actions], value [B])`` in float32.
    """

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens: Sequence[int] = (64, 64), activation: str = "tanh"):
        super().__init__()
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hiddens = tuple(hiddens)
        self.activation = activation
        self.act = ACTIVATIONS[activation]
        for tower in ("pi", "vf"):
            d = obs_dim
            for i, h in enumerate(self.hiddens):
                self.register_parameter(
                    f"{tower}_w{i}", nn.Parameter(torch.zeros(d, h)))
                self.register_parameter(
                    f"{tower}_b{i}", nn.Parameter(torch.zeros(h)))
                d = h
        self.pi_out_w = nn.Parameter(torch.zeros(d, num_actions))
        self.pi_out_b = nn.Parameter(torch.zeros(num_actions))
        self.vf_out_w = nn.Parameter(torch.zeros(d, 1))
        self.vf_out_b = nn.Parameter(torch.zeros(1))

    def init_params(self, gen: torch.Generator) -> "TorchRLModule":
        """The JAX init's distributions, drawn from ``gen`` (a CPU
        generator), in the JAX init's order: each tower's hidden
        weights, then the policy and value heads."""
        with torch.no_grad():
            for tower in ("pi", "vf"):
                d = self.obs_dim
                for i, h in enumerate(self.hiddens):
                    getattr(self, f"{tower}_w{i}").copy_(
                        _normal(gen, (d, h), float(np.sqrt(2.0 / d))))
                    getattr(self, f"{tower}_b{i}").zero_()
                    d = h
            self.pi_out_w.copy_(_normal(gen, self.pi_out_w.shape, 0.01))
            self.pi_out_b.zero_()
            self.vf_out_w.copy_(_normal(gen, self.vf_out_w.shape, 1.0))
            self.vf_out_b.zero_()
        return self

    def forward_with(self, params: Mapping[str, torch.Tensor],
                     obs: torch.Tensor):
        """The forward pass over ``params`` (a dict under the module's
        param names): ``(logits, value)``."""
        def tower(prefix, x):
            for i in range(len(self.hiddens)):
                x = self.act(x @ params[f"{prefix}_w{i}"]
                             + params[f"{prefix}_b{i}"])
            return x

        x = obs.to(torch.float32)
        logits = tower("pi", x) @ params["pi_out_w"] + params["pi_out_b"]
        value = tower("vf", x) @ params["vf_out_w"] + params["vf_out_b"]
        return logits, value[..., 0]

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def forward(self, obs: torch.Tensor):
        return self.forward_with(self.params(), obs)


@dataclass
class RLModuleSpec:
    """Builds a module from env spaces (reference: RLModuleSpec :48).
    Spaces are read by their ``shape`` and ``n``, so the port's
    ``envs`` spaces and gymnasium's both serve."""

    module_class: type = TorchRLModule
    hiddens: Sequence[int] = (64, 64)
    activation: str = "tanh"
    module_kwargs: Dict[str, Any] = field(default_factory=dict)

    def build(self, obs_space, act_space, device="cpu") -> TorchRLModule:
        """The module on ``device``, its params zeros until a learner
        draws them (:meth:`TorchRLModule.init_params`) or a runner loads
        its first weights."""
        obs_dim = int(np.prod(obs_space.shape))
        num_actions = int(act_space.n)
        module = self.module_class(obs_dim, num_actions,
                                   hiddens=self.hiddens,
                                   activation=self.activation,
                                   **self.module_kwargs)
        return module.to(device)
