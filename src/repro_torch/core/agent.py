"""The FedAdapt PPO agent (paper §IV; counterpart of
``repro/core/agent.py``).

Actor and critic are fully-connected nets with two hidden layers (64, 32),
the paper's architecture, with the reference's parameter layout: a dict
``{"actor": {w0, b0, w1, b1, w2, b2}, "critic": {...}}`` with ``w_i`` of
shape ``(in, out)``.  The actor's sigmoid head gives one workload fraction
mu in (0, 1] per device group; exploration adds Gaussian noise whose
stddev starts at 0.5 and decays exponentially (rate 0.9) after
``std_decay_after`` rounds.  PPO follows §V-B: gamma = 0.9, lr = 1e-4 for
both nets, an update every 10 rounds that reuses the buffer for 50 epochs.

The reference draws its exploration noise from threefry keys; here it
comes from a callable ``shape -> ndarray`` of standard normals
(``PPOAgent(noise=...)``), by default a CPU ``torch.Generator`` seeded
with the agent's seed, so a run on the card and one on the CPU see the
same noise.  The tests inject the reference's draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.optim import adamw, constant
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    num_groups: int
    hidden: Tuple[int, int] = (64, 32)
    gamma: float = 0.9
    lr: float = 1e-4
    clip_eps: float = 0.2
    update_every: int = 10          # rounds between updates
    reuse_epochs: int = 50          # reuse of the last trajectory chunk
    std_init: float = 0.5
    std_decay: float = 0.9
    std_decay_after: int = 200      # rounds (paper §V-B)
    std_decay_every: int = 1        # paper: exponential decay per round
    std_floor: float = 0.02
    entropy_coef: float = 0.0
    value_coef: float = 0.5
    # factored per-group credit assignment (beyond the paper, as in the
    # reference): the reward is a per-group vector and both the critic and
    # the policy ratios are per dimension
    factored: bool = False

    @property
    def obs_dim(self) -> int:
        return 2 * self.num_groups    # {T_t^g, mu_{t-1}^g} per group (Eq. 4)

    @property
    def act_dim(self) -> int:
        return self.num_groups


# =============================================================================
# networks
# =============================================================================
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


def critic_value(cfg: PPOConfig, params: Params, obs: torch.Tensor
                 ) -> torch.Tensor:
    out = _mlp_apply(params["critic"], obs, len(cfg.hidden) + 1)
    return out if cfg.factored else out[..., 0]


def current_std(cfg: PPOConfig, round_idx: int) -> float:
    if round_idx <= cfg.std_decay_after:
        return cfg.std_init
    n = (round_idx - cfg.std_decay_after) // max(cfg.std_decay_every, 1)
    return float(max(cfg.std_init * (cfg.std_decay ** n), cfg.std_floor))


def _log_prob_dims(mean: torch.Tensor, std, raw: torch.Tensor
                   ) -> torch.Tensor:
    """Per-dimension Gaussian log-prob (..., act_dim); ``std`` and
    log(2 pi) in float32, as the reference computes them."""
    def f32(x):
        # a fill on the device, not a copy from the host (which would wait
        # for the device)
        return x.to(torch.float32) if isinstance(x, torch.Tensor) else \
            torch.full((), x, dtype=torch.float32, device=mean.device)

    std = f32(std)
    return -0.5 * (((raw - mean) / std) ** 2 + 2 * torch.log(std)
                   + torch.log(f32(2 * math.pi)))


def _log_prob(mean: torch.Tensor, std, raw: torch.Tensor) -> torch.Tensor:
    return torch.sum(_log_prob_dims(mean, std, raw), dim=-1)


def sample_action(cfg: PPOConfig, params: Params, obs: torch.Tensor,
                  noise: torch.Tensor, std: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(action clipped to [1e-3, 1], log-prob of the raw Gaussian sample);
    ``noise`` holds standard normals of the mean's shape."""
    mean = actor_mean(cfg, params, obs)
    raw = mean + noise * std
    return torch.clamp(raw, 1e-3, 1.0), _log_prob(mean, std, raw)


# =============================================================================
# PPO update
# =============================================================================
class Trajectory(NamedTuple):
    obs: torch.Tensor         # (T, obs_dim)
    actions: torch.Tensor     # (T, act_dim) raw (pre-clip) samples
    logps: torch.Tensor       # (T, act_dim) per-dim log-probs
    rewards: torch.Tensor     # (T,) scalar Eq. 5, or (T, G) factored
    next_obs: torch.Tensor    # (T, obs_dim)


def gae_advantages(cfg: PPOConfig, params: Params, traj: Trajectory,
                   lam: float = 0.95) -> Tuple[torch.Tensor, torch.Tensor]:
    """TD/GAE advantages with bootstrapped values over the truncated
    buffer; returns ``(advantages, value targets)``."""
    v = critic_value(cfg, params, traj.obs)
    v_next = critic_value(cfg, params, traj.next_obs)
    delta = traj.rewards + cfg.gamma * v_next - v     # (T,) or (T, G)
    carry = torch.zeros(delta.shape[1:], dtype=torch.float32,
                        device=delta.device)
    rev = []
    for d in delta.flip(0):                  # the reference's reversed scan
        carry = d + cfg.gamma * lam * carry
        rev.append(carry)
    adv = torch.stack(rev[::-1])
    return adv, adv + v


def ppo_loss(cfg: PPOConfig, params: Params, traj: Trajectory,
             adv: torch.Tensor, v_target: torch.Tensor,
             std) -> torch.Tensor:
    mean = actor_mean(cfg, params, traj.obs)
    logp_dims = _log_prob_dims(mean, std, traj.actions)   # (T, act_dim)
    values = critic_value(cfg, params, traj.obs)
    # the population std, as jnp.std
    adv = (adv - adv.mean(dim=0)) / (adv.std(dim=0, correction=0) + 1e-8)
    if cfg.factored:
        # per-group ratios against per-group advantages
        ratio = torch.exp(logp_dims - traj.logps)                 # (T, G)
    else:
        ratio = torch.exp(torch.sum(logp_dims - traj.logps, dim=-1))  # (T,)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
    policy_loss = -torch.mean(torch.minimum(unclipped, clipped))
    value_loss = torch.mean((values - v_target) ** 2)
    return policy_loss + cfg.value_coef * value_loss


def _sorted(tree):
    """``tree`` with every dict's keys in sorted order (tree_leaves')."""
    return {k: _sorted(tree[k]) for k in sorted(tree)} \
        if isinstance(tree, dict) else tree


def make_update_fn(cfg: PPOConfig):
    """``(opt, update)``: ``update(params, opt_state, obs, actions, logps,
    rewards, next_obs, std) -> (params, opt_state)`` runs
    ``cfg.reuse_epochs`` epochs over one buffer.  Each epoch recomputes the
    advantages from the current params (no gradient through them), takes
    the loss's gradient by autograd and one AdamW step (lr ``cfg.lr``, no
    weight decay, global-norm clip 0.5)."""
    opt = adamw(schedule=constant(cfg.lr), weight_decay=0.0, clip_norm=0.5)

    def update(params, opt_state, obs, actions, logps, rewards, next_obs,
               std):
        traj = Trajectory(obs, actions, logps, rewards, next_obs)
        for _ in range(cfg.reuse_epochs):
            with torch.no_grad():
                adv, v_target = gae_advantages(cfg, params, traj)
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            grads = iter(torch.autograd.grad(
                ppo_loss(cfg, live, traj, adv, v_target, std),
                tree_leaves(live)))
            # tree_leaves and tree_map walk the dicts in the same order
            grads = tree_map(lambda _: next(grads), _sorted(live))
            params, opt_state = opt.update(params, grads, opt_state)
        return params, opt_state

    return opt, update


class PPOAgent:
    """Stateful wrapper used by the controller and the training loop.

    ``device=None`` means the card (raising if none is visible), as for the
    other entry points; pass ``device="cpu"`` for the CPU.  Carried params
    (``convert.agent_params_from_numpy``) are moved to ``device`` when one
    is given, else used where they lie.  ``noise(shape)`` returns standard
    normals as a numpy array; by default a CPU ``torch.Generator`` seeded
    with ``seed`` (after the default params' draws) supplies them."""

    def __init__(self, cfg: PPOConfig, seed: int = 0,
                 params: Optional[Params] = None, device=None,
                 noise: Optional[Callable[[Tuple[int, ...]],
                                          np.ndarray]] = None):
        self.cfg = cfg
        generator = torch.Generator().manual_seed(seed)
        if params is None:
            self.device = resolve_device(device)
            params = init_agent(cfg, generator)
        else:
            self.device = (resolve_device(device) if device is not None
                           else params["actor"]["w0"].device)
        self.params = tree_map(lambda p: p.to(self.device), params)
        self.noise = noise or (lambda shape: torch.randn(
            shape, generator=generator, dtype=torch.float32).numpy())
        self.opt, self._update = make_update_fn(cfg)
        self.opt_state = self.opt.init(self.params)
        self.round_idx = 0
        self._buf: List[Tuple] = []
        self._pending = None
        self._last = None

    # --- acting ---------------------------------------------------------
    def act(self, obs: np.ndarray, explore: bool = True) -> np.ndarray:
        obs_np = np.asarray(obs, np.float32)
        # complete the pending transition with this obs as next_obs
        if self._pending is not None:
            p_obs, p_raw, p_logp, p_rew = self._pending
            self._buf.append((p_obs, p_raw, p_logp, p_rew, obs_np))
            self._pending = None
            if len(self._buf) >= self.cfg.update_every:
                self._train_on_buffer()
                self._buf = []
        obs_t = torch.from_numpy(obs_np).to(self.device)
        with torch.no_grad():
            mean = actor_mean(self.cfg, self.params, obs_t)
            if not explore:
                self._last = None   # deployment: no learning transition
                return mean.cpu().numpy()
            std = current_std(self.cfg, self.round_idx)
            noise = torch.from_numpy(np.array(
                self.noise(tuple(mean.shape)), np.float32)).to(self.device)
            raw = mean + noise * std
            logp = _log_prob_dims(mean, std, raw)
            action = torch.clamp(raw, 1e-3, 1.0)
        self._last = (obs_np, raw.cpu().numpy(), logp.cpu().numpy(),
                      float(std))
        return action.cpu().numpy()

    # --- learning --------------------------------------------------------
    def observe(self, reward) -> None:
        """reward: float (Eq. 5 scalar) or (G,) vector (factored mode).
        No transition after a non-exploring act (deployment)."""
        if self._last is not None:
            obs, raw, logp, _ = self._last
            self._pending = (obs, raw, logp, np.asarray(reward, np.float32))
        self.round_idx += 1

    def _train_on_buffer(self) -> None:
        def stack(i):
            return torch.from_numpy(np.asarray(
                [b[i] for b in self._buf], np.float32)).to(self.device)

        std = current_std(self.cfg, self.round_idx)
        self.params, self.opt_state = self._update(
            self.params, self.opt_state, stack(0), stack(1), stack(2),
            stack(3), stack(4),
            torch.tensor(std, dtype=torch.float32, device=self.device))
