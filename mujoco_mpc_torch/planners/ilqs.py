"""iLQS: predictive sampling and iLQG in one planner, the winner kept.

Counterpart of mujoco_mpc_tpu/planners/ilqs.py (reference
mjpc/planners/ilqs/planner.cc:87, the spline/action conversions of
ilqs/planner.h:42-48): the sampling improvement (one MegaRollout launch on
the card), iLQG seeded with the sampled winner's actions unless iLQG won
the last plan (the general engine), and the winner's actions written back
to the spline. Which planner won stays a device tensor, combined with
torch.where, so nothing is read back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from mujoco_mpc_torch.ops import spline
from mujoco_mpc_torch.physics.types import Data
from mujoco_mpc_torch.planners.base import PlanInfo
from mujoco_mpc_torch.planners.ilqg import ILQGConfig, ILQGPlanner, ILQGPolicy
from mujoco_mpc_torch.planners.sampling import (SamplingConfig,
                                                SamplingPlanner,
                                                SamplingPolicy)
from mujoco_mpc_torch.tasks.base import Task, TaskParams


@dataclasses.dataclass
class ILQSPolicy:
  sampling: SamplingPolicy
  ilqg: ILQGPolicy
  use_ilqg: torch.Tensor  # () bool: iLQG won the last plan

  def replace(self, **kw) -> "ILQSPolicy":
    return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ILQSConfig:
  sampling: SamplingConfig = dataclasses.field(
      default_factory=SamplingConfig)
  ilqg: ILQGConfig = dataclasses.field(default_factory=ILQGConfig)

  @classmethod
  def from_task(cls, task: Task, horizon_steps: Optional[int] = None):
    return cls(sampling=SamplingConfig.from_task(task, horizon_steps),
               ilqg=ILQGConfig.from_task(task, horizon_steps))


class ILQSPlanner:
  def __init__(self, config: ILQSConfig):
    self.config = config
    self.sampler = SamplingPlanner(config.sampling)
    self.ilqg = ILQGPlanner(config.ilqg)

  @property
  def mega(self):
    """The sampling half's MegaRollout (None on the general route)."""
    return self.sampler.mega

  def init(self, task: Task) -> ILQSPolicy:
    return ILQSPolicy(
        sampling=self.sampler.init(task), ilqg=self.ilqg.init(task),
        use_ilqg=torch.zeros((), dtype=torch.bool, device=task.model.device))

  def action(self, task: Task, policy: ILQSPolicy,
             data: Data) -> torch.Tensor:
    return torch.where(policy.use_ilqg,
                       self.ilqg.action(task, policy.ilqg, data),
                       self.sampler.action(task, policy.sampling, data))

  def optimize(self, task: Task, policy: ILQSPolicy, data: Data,
               generator: Optional[torch.Generator],
               params: Optional[TaskParams] = None, noise=None, use2=None
               ) -> Tuple[ILQSPolicy, PlanInfo]:
    """One iteration; `noise` and `use2` are the sampling half's (see
    SamplingPlanner.optimize)."""
    m = task.model
    T = self.config.ilqg.horizon
    interp = self.config.sampling.interp
    # 1. the sampling improvement
    s_policy, s_info = self.sampler.optimize(task, policy.sampling, data,
                                             generator, params, noise, use2)
    # 2. iLQG's nominal seeded with the sampled winner (spline -> actions),
    #    unless iLQG won the last plan
    ts = data.time + m.opt.timestep * torch.arange(
        T, dtype=data.qpos.dtype, device=data.qpos.device)
    us_seed = spline.sample_many(s_policy.times, s_policy.values, ts, interp)
    use = policy.use_ilqg
    seeded = policy.ilqg.replace(
        us=torch.where(use, policy.ilqg.us, us_seed),
        gains=torch.where(use, policy.ilqg.gains,
                          torch.zeros_like(policy.ilqg.gains)),
        t0=data.time)
    i_policy, i_info = self.ilqg.optimize(task, seeded, data, generator,
                                          params)
    use_ilqg = i_info.best_return < s_info.best_return
    # 3. the winner back to the spline (actions -> nodes)
    from_ilqg = spline.sample_many(ts, i_policy.us, s_policy.times, interp)
    s_policy = s_policy.replace(
        values=torch.where(use_ilqg, from_ilqg, s_policy.values))
    new_policy = ILQSPolicy(sampling=s_policy, ilqg=i_policy,
                            use_ilqg=use_ilqg)
    info = PlanInfo(
        costs=torch.stack([s_info.best_return, i_info.best_return]),
        winner=use_ilqg.long(),
        best_return=torch.minimum(s_info.best_return, i_info.best_return))
    return new_policy, info
