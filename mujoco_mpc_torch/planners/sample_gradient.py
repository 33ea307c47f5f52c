"""Sample-gradient planner: a search gradient from sampled returns, then a
line search along it.

Counterpart of mujoco_mpc_tpu/planners/sample_gradient.py (reference
mjpc/planners/sample_gradient/planner.cc:169-470): perturbations of the
nominal spline; a search gradient from their returns with log-rank fitness
shaping (planner.cc:436-449) and exponential filtering; more candidates
along the negative gradient at log-spaced step sizes; the winner among
the nominal, the perturbations and the gradient candidates.

The JAX planner scores its candidates through the general rollout. Here
they go through the sampling planners' route (planners/sampling.py::
build_rollout): on the card, one MegaRollout launch for the nominal and
the perturbations and one for the gradient candidates, which depend on
the first launch's returns: 2 launches a plan. A task with no CUDA
residual, or a planner built with use_megakernel=False, scores them
through the general batched rollout. The perturbations' standard normals
come from an explicit torch.Generator, or are given as `noise`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from mujoco_mpc_torch.ops import megarollout
from mujoco_mpc_torch.ops import spline
from mujoco_mpc_torch.physics.types import Data
from mujoco_mpc_torch.planners import sampling
from mujoco_mpc_torch.planners.base import (PlanInfo, log_steps, new_grid,
                                             pick)
from mujoco_mpc_torch.tasks.base import Task, TaskParams


@dataclasses.dataclass
class SGPolicy:
  times: torch.Tensor  # (k,)
  values: torch.Tensor  # (k, nu)
  gradient: torch.Tensor  # (k, nu) filtered search gradient
  exploration: torch.Tensor  # ()

  def replace(self, **kw) -> "SGPolicy":
    return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class SGConfig:
  num_noisy: int = 56  # perturbation candidates (besides the nominal)
  num_gradient: int = 8  # line-search candidates along -gradient
  spline_points: int = 10
  horizon: int = 100
  interp: spline.Interp = spline.Interp.ZERO
  min_step: float = 1e-3
  max_step: float = 1.0
  gradient_filter: float = 1.0  # 1 = no momentum

  @classmethod
  def from_task(cls, task: Task, horizon_steps: Optional[int] = None):
    m = task.model
    dt = float(m.custom("agent_timestep", float(m.opt.timestep)))
    hor = horizon_steps or int(
        round(float(m.custom("agent_horizon", 1.0)) / dt))
    return cls(num_noisy=int(m.custom("sampling_trajectories", 64)) - 8,
               spline_points=int(m.custom("sampling_spline_points", 10)),
               horizon=hor)


def fitness_weights(n: int, like: torch.Tensor) -> torch.Tensor:
  """Log-rank utility weights (planner.cc:436-449), best rank first."""
  ranks = torch.arange(n, dtype=like.dtype, device=like.device)
  w = torch.clamp(math.log(0.5 * n + 1.0) - torch.log(ranks + 1.0),
                  min=0.0)
  return w / torch.sum(w) - 1.0 / n


class SampleGradientPlanner:
  """Sample-gradient planner over MegaRollout, or over the general rollout
  (`mega` is None, `general_reason` says why)."""

  def __init__(self, config: SGConfig, use_megakernel: bool = True):
    self.config = config
    self.use_megakernel = use_megakernel
    self.mega: Optional[megarollout.MegaRollout] = None
    self.general_reason: Optional[str] = None

  def init(self, task: Task) -> SGPolicy:
    """Fresh policy; the first call picks the route (build_rollout)."""
    if self.mega is None and self.general_reason is None:
      self.mega, self.general_reason = sampling.build_rollout(
          task, self.config.horizon, self.use_megakernel)
    m = task.model
    k = self.config.spline_points
    horizon_time = self.config.horizon * m.opt.timestep
    times = torch.linspace(0.0, float(horizon_time), k, dtype=m.dtype,
                           device=m.device)
    return SGPolicy(
        times=times, values=task.default_ctrl()[None].repeat(k, 1),
        gradient=torch.zeros((k, m.nu), dtype=m.dtype, device=m.device),
        exploration=torch.tensor(
            float(m.custom("sampling_exploration", 0.2)), dtype=m.dtype,
            device=m.device))

  def action(self, task: Task, policy: SGPolicy,
             data: Data) -> torch.Tensor:
    return sampling.spline_action(task, policy.times, policy.values,
                                  data.time, self.config.interp)

  def _returns(self, task: Task, data: Data, new_times: torch.Tensor,
               cands: torch.Tensor,
               params: Optional[TaskParams]) -> torch.Tensor:
    """Returns (N,) of candidate splines (N, k, nu): one MegaRollout call
    with the state's mocap poses and userdata as rollout constants, or the
    general rollout where there is no MegaRollout."""
    cfg = self.config
    if self.mega is None:
      return sampling.general_returns(task, data, new_times, cands,
                                      cfg.horizon, cfg.interp, params)
    actions = sampling.candidate_actions(task, data, new_times, cands,
                                         cfg.horizon, cfg.interp)
    return self.mega.returns(
        data.qpos, data.qvel, actions,
        params if params is not None else task.params, data.time,
        mocap_pos=data.mocap_pos, mocap_quat=data.mocap_quat,
        userdata=data.userdata)

  def optimize(self, task: Task, policy: SGPolicy, data: Data,
               generator: Optional[torch.Generator],
               params: Optional[TaskParams] = None,
               noise: Optional[torch.Tensor] = None
               ) -> Tuple[SGPolicy, PlanInfo]:
    """One iteration; `noise` (num_noisy, k, nu) standard normals replace
    the draws from `generator` when given."""
    cfg = self.config
    m = task.model
    k, nn, ng = cfg.spline_points, cfg.num_noisy, cfg.num_gradient
    new_times = new_grid(cfg, policy.times, data, m.opt.timestep)
    nominal = spline.resample(policy.times, policy.values, new_times,
                              cfg.interp)
    lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
    limited = m.actuator_ctrllimited
    scale = torch.where(limited, 0.5 * (hi - lo), torch.ones_like(lo))
    if noise is None:
      noise = torch.randn((nn, k, m.nu), generator=generator,
                          dtype=nominal.dtype, device=nominal.device)
    noise = noise * policy.exploration * scale[None, None, :]

    def clipc(c):
      return torch.where(limited, torch.clamp(c, lo, hi), c)

    # launch 1: the nominal and the perturbations
    first = torch.cat([nominal[None], clipc(nominal[None] + noise)])
    first_returns = self._returns(task, data, new_times, first, params)
    noisy_returns = first_returns[1:]

    # the search gradient, the perturbations weighted by return rank
    order = torch.argsort(noisy_returns, stable=True)  # best first
    w = fitness_weights(nn, nominal)
    grad = -torch.einsum("i,ikl->kl", w, noise[order]) / nn
    grad = (cfg.gradient_filter * grad +
            (1.0 - cfg.gradient_filter) * policy.gradient)

    # launch 2: log-spaced steps along -gradient
    steps = log_steps(cfg.min_step, cfg.max_step, ng, nominal)
    grad_cands = clipc(nominal[None] - steps[:, None, None] * grad[None])
    grad_returns = self._returns(task, data, new_times, grad_cands, params)

    all_cands = torch.cat([first, grad_cands])
    all_returns = torch.cat([first_returns, grad_returns])
    winner = torch.argmin(all_returns)
    new_policy = policy.replace(times=new_times,
                                values=pick(all_cands, winner),
                                gradient=grad)
    return new_policy, PlanInfo(costs=all_returns, winner=winner,
                                best_return=pick(all_returns, winner))
