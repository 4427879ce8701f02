"""The FedAdapt PPO agent, deployment half (counterpart of
``repro/core/agent.py``).

Actor and critic are fully-connected nets with two hidden layers (64, 32),
the paper's architecture, with the reference's parameter layout: a dict
``{"actor": {w0, b0, w1, b1, w2, b2}, "critic": {...}}`` with ``w_i`` of
shape ``(in, out)``.  The actor's sigmoid head gives one workload fraction
mu in (0, 1] per device group.  ``run_federated`` deploys the agent without
exploration, so only the actor's forward runs here; PPO training and
exploration noise are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import not_ported

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """The networks' shape; the PPO training hyper-parameters of the
    reference's config come with PPO training."""
    num_groups: int
    hidden: Tuple[int, int] = (64, 32)
    factored: bool = False          # critic: one value per group

    @property
    def obs_dim(self) -> int:
        return 2 * self.num_groups    # {T_t^g, mu_{t-1}^g} per group (Eq. 4)

    @property
    def act_dim(self) -> int:
        return self.num_groups


def _mlp_init(generator: torch.Generator, dims: List[int]
              ) -> Dict[str, torch.Tensor]:
    p = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        p[f"w{i}"] = torch.randn((a, b), generator=generator) / np.sqrt(a)
        p[f"b{i}"] = torch.zeros(b)
    return p


def _mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
               n_layers: int) -> torch.Tensor:
    for i in range(n_layers):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n_layers - 1:
            x = torch.tanh(x)
    return x


def init_agent(cfg: PPOConfig, generator: torch.Generator) -> Params:
    """The reference's distributions (N(0, 1) / sqrt(fan_in) weights, zero
    biases) from a torch generator; not the reference's threefry draws."""
    dims_a = [cfg.obs_dim, *cfg.hidden, cfg.act_dim]
    dims_c = [cfg.obs_dim, *cfg.hidden, cfg.act_dim if cfg.factored else 1]
    return {"actor": _mlp_init(generator, dims_a),
            "critic": _mlp_init(generator, dims_c)}


def actor_mean(cfg: PPOConfig, params: Params, obs: torch.Tensor
               ) -> torch.Tensor:
    """mu in (0, 1] per group."""
    return torch.sigmoid(_mlp_apply(params["actor"], obs,
                                    len(cfg.hidden) + 1))


class PPOAgent:
    """The controller's agent in deployment mode (``explore=False``).

    The actor runs where its params lie.  A default agent's params stay on
    the host: the actor is a (2G)-64-32-G MLP evaluated once per round
    whose output goes straight back to the numpy control plane, so the
    card would only add two copies.  Params carried in (``convert.
    agent_params_from_numpy``) run on the device they were given."""

    def __init__(self, cfg: PPOConfig, seed: int = 0,
                 params: Optional[Params] = None):
        self.cfg = cfg
        self.params = params if params is not None else init_agent(
            cfg, torch.Generator().manual_seed(seed))
        self.round_idx = 0

    def act(self, obs: np.ndarray, explore: bool = True) -> np.ndarray:
        if explore:
            raise not_ported("PPO exploration (PPOAgent.act(explore=True))",
                             "PPO training and exploration")
        device = self.params["actor"]["w0"].device
        with torch.no_grad():
            mean = actor_mean(self.cfg, self.params, torch.from_numpy(
                np.asarray(obs, np.float32)).to(device))
        return mean.cpu().numpy()

    def observe(self, reward) -> None:
        """Deployment records no learning transition: the round advances."""
        self.round_idx += 1
