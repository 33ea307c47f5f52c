"""Cross-Entropy Method planner.

Counterpart of mujoco_mpc_tpu/planners/cross_entropy.py (reference
mjpc/planners/cross_entropy/planner.cc:168-260): the sampling planner's
candidates, scored by the same MegaRollout call (the CUDA kernel on the
card, its plain version on the CPU; the general rollout for a task with
no CUDA residual, or with use_megakernel=False), but the nominal is
refit to the mean of the n_elite best candidates and the per-parameter
sampling std is re-estimated from them, floored at std_min.

Noise comes from an explicit torch.Generator, or is given (tests hand the
same standard normals to both packages).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from mujoco_mpc_torch.ops import megarollout
from mujoco_mpc_torch.ops import spline
from mujoco_mpc_torch.physics.types import Data
from mujoco_mpc_torch.planners import sampling
from mujoco_mpc_torch.planners.base import PlanInfo, new_grid
from mujoco_mpc_torch.tasks.base import Task, TaskParams


@dataclasses.dataclass
class CEMPolicy:
  """Spline control policy with a per-node sampling std."""
  times: torch.Tensor  # (k,)
  values: torch.Tensor  # (k, nu)
  std: torch.Tensor  # (k, nu)

  def replace(self, **kw) -> "CEMPolicy":
    return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class CEMConfig:
  num_trajectories: int = 128
  n_elite: int = 12  # reference default max(N / 10, 2)
  spline_points: int = 10
  horizon: int = 100  # steps
  interp: spline.Interp = spline.Interp.ZERO
  std_min: float = 0.1
  std_initial: float = 0.3

  @classmethod
  def from_task(cls, task: Task, horizon_steps: Optional[int] = None):
    m = task.model
    dt = float(m.custom("agent_timestep", float(m.opt.timestep)))
    hor = horizon_steps or int(
        round(float(m.custom("agent_horizon", 1.0)) / dt))
    n = int(m.custom("sampling_trajectories", 128))
    return cls(
        num_trajectories=n,
        n_elite=int(m.custom("n_elite", max(n // 10, 2))),
        spline_points=int(m.custom("sampling_spline_points", 10)),
        horizon=hor,
        std_initial=float(m.custom("sampling_exploration", 0.3)),
        std_min=float(m.custom("std_min", 0.1)),
    )


def elite_update(cands: torch.Tensor, returns: torch.Tensor, n_elite: int,
                 std_min: float):
  """(elite indices best first, their mean (k, nu), their std (k, nu)):
  the variance over n_elite - 1 (at least 1), the std floored at
  std_min."""
  _, elite_idx = torch.topk(-returns, n_elite)
  elites = cands[elite_idx]
  mean = torch.mean(elites, dim=0)
  var = torch.sum((elites - mean[None]) ** 2, dim=0) / max(n_elite - 1, 1)
  return elite_idx, mean, torch.clamp(torch.sqrt(var), min=std_min)


class CrossEntropyPlanner:
  """CEM planner over MegaRollout."""

  def __init__(self, config: CEMConfig, use_megakernel: bool = True):
    self.config = config
    self.use_megakernel = use_megakernel
    self.mega: Optional[megarollout.MegaRollout] = None
    self.general_reason: Optional[str] = None

  def init(self, task: Task) -> CEMPolicy:
    """Fresh policy (the std at std_initial times half the control range);
    picks the route as SamplingPlanner.init does."""
    if self.mega is None and self.general_reason is None:
      self.mega, self.general_reason = sampling.build_rollout(
          task, self.config.horizon, self.use_megakernel)
    m = task.model
    k = self.config.spline_points
    horizon_time = self.config.horizon * m.opt.timestep
    times = torch.linspace(0.0, float(horizon_time), k, dtype=m.dtype,
                           device=m.device)
    scale = torch.where(
        m.actuator_ctrllimited,
        0.5 * (m.actuator_ctrlrange[:, 1] - m.actuator_ctrlrange[:, 0]),
        torch.ones_like(m.actuator_ctrlrange[:, 0]))
    std = (self.config.std_initial * scale)[None].repeat(k, 1)
    values = task.default_ctrl()[None].repeat(k, 1)
    return CEMPolicy(times=times, values=values, std=std)

  def action(self, task: Task, policy: CEMPolicy,
             data: Data) -> torch.Tensor:
    return sampling.spline_action(task, policy.times, policy.values,
                                  data.time, self.config.interp)

  def _gen_candidates(self, task: Task, policy: CEMPolicy, data: Data,
                      generator: Optional[torch.Generator],
                      noise: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(new_times, nominal, candidate values (N, k, nu)); `noise`
    (N-1, k, nu) standard normals replace the draws from `generator` when
    given."""
    cfg = self.config
    m = task.model
    k, n = cfg.spline_points, cfg.num_trajectories
    new_times = new_grid(cfg, policy.times, data, m.opt.timestep)
    nominal = spline.resample(policy.times, policy.values, new_times,
                              cfg.interp)
    std_rs = spline.resample(policy.times, policy.std, new_times, cfg.interp)
    if noise is None:
      noise = torch.randn((n - 1, k, m.nu), generator=generator,
                          dtype=nominal.dtype, device=m.device)
    cands = torch.cat([nominal[None], nominal[None] + noise * std_rs[None]])
    lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
    cands = torch.where(m.actuator_ctrllimited, torch.clamp(cands, lo, hi),
                        cands)
    return new_times, nominal, cands

  def _actions(self, task: Task, data: Data, new_times: torch.Tensor,
               cands: torch.Tensor) -> torch.Tensor:
    """Per-step actions (N, T, nu) of the candidate splines."""
    return sampling.candidate_actions(task, data, new_times, cands,
                                      self.config.horizon, self.config.interp)

  def _returns(self, task: Task, data: Data, new_times: torch.Tensor,
               cands: torch.Tensor,
               params: Optional[TaskParams]) -> torch.Tensor:
    """Candidate returns (N,) from one MegaRollout call, with the state's
    mocap poses and userdata as rollout constants; from the general
    rollout where there is no MegaRollout."""
    if self.mega is None:
      return sampling.general_returns(task, data, new_times, cands,
                                      self.config.horizon, self.config.interp,
                                      params)
    return self.mega.returns(
        data.qpos, data.qvel, self._actions(task, data, new_times, cands),
        params if params is not None else task.params, data.time,
        mocap_pos=data.mocap_pos, mocap_quat=data.mocap_quat,
        userdata=data.userdata)

  def optimize(self, task: Task, policy: CEMPolicy, data: Data,
               generator: Optional[torch.Generator],
               params: Optional[TaskParams] = None, noise=None
               ) -> Tuple[CEMPolicy, PlanInfo]:
    cfg = self.config
    new_times, _, cands = self._gen_candidates(task, policy, data, generator,
                                               noise)
    returns = self._returns(task, data, new_times, cands, params)
    elite_idx, mean, std = elite_update(cands, returns, cfg.n_elite,
                                        cfg.std_min)
    new_policy = policy.replace(times=new_times, values=mean, std=std)
    winner = elite_idx[0]
    info = PlanInfo(costs=returns, winner=winner,
                    best_return=returns[winner])
    return new_policy, info
