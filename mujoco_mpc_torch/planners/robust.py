"""Robust planner: candidates re-ranked by their mean return under
disturbances.

Counterpart of mujoco_mpc_tpu/planners/robust.py (reference
mjpc/planners/robust/robust_planner.cc:91, parameters
robust_planner.h:66-72): the delegate sampling planner's candidates (one
MegaRollout launch on the card), its ncandidates best, each re-scored by
nrepetitions rollouts under Ornstein-Uhlenbeck body wrenches, the best
mean kept. The ncandidates x nrepetitions re-scoring rollouts are one
batch of the general engine (ops/rollout.py::noisy_rollout): the kernel
has no applied-force operand.

Randomness comes from explicit torch.Generators, or is given: the
delegate's candidate noise (`noise`, `use2`) and the re-scoring's standard
normals (`eps`, (T, ncandidates, nrepetitions, nbody, 6)).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from mujoco_mpc_torch.ops import rollout as rollout_mod
from mujoco_mpc_torch.ops import spline
from mujoco_mpc_torch.physics.types import Data
from mujoco_mpc_torch.planners.base import PlanInfo, pick
from mujoco_mpc_torch.planners.sampling import SamplingPlanner, SamplingPolicy
from mujoco_mpc_torch.tasks.base import Task, TaskParams


@dataclasses.dataclass(frozen=True)
class RobustConfig:
  ncandidates: int = 12  # reference default
  nrepetitions: int = 5
  xfrc_std: float = 0.1
  xfrc_rate: float = 0.1


class RobustPlanner:
  """A decorator over a SamplingPlanner delegate."""

  def __init__(self, delegate: SamplingPlanner, config: RobustConfig):
    self.delegate = delegate
    self.config = config

  @property
  def mega(self):
    """The delegate's MegaRollout (None on the general route)."""
    return self.delegate.mega

  def init(self, task: Task) -> SamplingPolicy:
    return self.delegate.init(task)

  def action(self, task: Task, policy: SamplingPolicy,
             data: Data) -> torch.Tensor:
    return self.delegate.action(task, policy, data)

  def optimize(self, task: Task, policy: SamplingPolicy, data: Data,
               generator: Optional[torch.Generator],
               params: Optional[TaskParams] = None, noise=None, use2=None,
               eps: Optional[torch.Tensor] = None
               ) -> Tuple[SamplingPolicy, PlanInfo]:
    nc = self.config.ncandidates
    resampled, cands, returns = self.delegate.candidates(
        task, policy, data, generator, params, noise, use2)
    # the delegate's best, best first
    _, top_idx = torch.topk(returns, nc, largest=False)
    top = cands[top_idx]  # (nc, k, nu)
    scores = self._scores(task, data, resampled.times, top, generator,
                          params, eps)
    best = torch.argmin(scores)
    new_policy = resampled.replace(values=pick(top, best))
    return new_policy, PlanInfo(costs=scores, winner=pick(top_idx, best),
                                best_return=pick(scores, best))

  def _scores(self, task: Task, data: Data, times: torch.Tensor,
              top: torch.Tensor, generator: Optional[torch.Generator],
              params: Optional[TaskParams],
              eps: Optional[torch.Tensor]) -> torch.Tensor:
    """The mean return (nc,) of each spline of `top` (nc, k, nu) on the
    grid `times` over nrepetitions disturbed rollouts, one batch of the
    general engine; eps (T, nc, nrepetitions, nbody, 6) replaces the
    draws from `generator` when given."""
    cfg = self.config
    dcfg = self.delegate.config
    nc, nr = top.shape[0], cfg.nrepetitions
    values = top[:, None].expand(nc, nr, *top.shape[1:])

    def policy_fn(t, d):
      return spline.sample(times, values, t.reshape(-1)[0], dcfg.interp)

    return rollout_mod.noisy_rollout(
        task, rollout_mod.broadcast(data, (nc, nr)), policy_fn, dcfg.horizon,
        generator, xfrc_std=cfg.xfrc_std, xfrc_rate=cfg.xfrc_rate,
        params=params, eps=eps).mean(dim=1)
