"""Gradient-descent planner: reverse mode through the rollout, then a line
search.

Counterpart of mujoco_mpc_tpu/planners/gradient.py (reference
mjpc/planners/gradient/planner.cc:159-, gradient.cc, spline_mapping.cc,
which chain finite-difference model Jacobians, cost derivatives and spline
maps). Here dJ/d(spline values) is one backward pass through the
eager rollout of the general engine (physics/step.py). The activations are
kept (JAX recomputes them with jax.checkpoint): a planning horizon's worth
fits the card many times over, and recomputing would add a forward pass.
The line search's candidates are the engine's leading batch dimension:
one batched rollout. Controls go through a tanh-smoothed clip, so the
gradient stays useful at the control bounds.

The planner never changes PyTorch's matmul precision: float32 products
stay full precision (no TF32), which the JAX planner forces with
default_matmul_precision("highest").
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from mujoco_mpc_torch.ops import rollout as rollout_mod
from mujoco_mpc_torch.ops import spline
from mujoco_mpc_torch.physics import step as phys_step
from mujoco_mpc_torch.physics.types import Data
from mujoco_mpc_torch.planners import sampling
from mujoco_mpc_torch.planners.base import (PhaseMarks, PlanInfo, log_steps,
                                             new_grid, pick)
from mujoco_mpc_torch.tasks.base import Task, TaskParams

MAX_RETURN = rollout_mod.MAX_RETURN


@dataclasses.dataclass
class GradientPolicy:
  times: torch.Tensor  # (k,)
  values: torch.Tensor  # (k, nu)

  def replace(self, **kw) -> "GradientPolicy":
    return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class GradientConfig:
  spline_points: int = 10
  horizon: int = 100
  interp: spline.Interp = spline.Interp.LINEAR
  num_steps: int = 10  # line-search candidates
  min_step: float = 1e-4
  max_step: float = 1.0

  @classmethod
  def from_task(cls, task: Task, horizon_steps: Optional[int] = None):
    m = task.model
    dt = float(m.custom("agent_timestep", float(m.opt.timestep)))
    hor = horizon_steps or int(
        round(float(m.custom("agent_horizon", 1.0)) / dt))
    return cls(spline_points=int(m.custom("gradient_spline_points", 10)),
               horizon=hor)


class GradientPlanner(PhaseMarks):
  """Gradient descent on the spline values, through the general engine."""

  mega = None  # no MegaRollout: the general engine scores every rollout

  def __init__(self, config: GradientConfig):
    self.config = config

  def init(self, task: Task) -> GradientPolicy:
    m = task.model
    k = self.config.spline_points
    horizon_time = self.config.horizon * m.opt.timestep
    times = torch.linspace(0.0, float(horizon_time), k, dtype=m.dtype,
                           device=m.device)
    return GradientPolicy(times=times,
                          values=task.default_ctrl()[None].repeat(k, 1))

  def action(self, task: Task, policy: GradientPolicy,
             data: Data) -> torch.Tensor:
    return sampling.spline_action(task, policy.times, policy.values,
                                  data.time, self.config.interp)

  def total(self, task: Task, data: Data, times: torch.Tensor,
            tp: TaskParams, values: torch.Tensor) -> torch.Tensor:
    """The mean per-step cost (*b,) of spline values (*b, k, nu) on the
    grid `times`, from `data`; differentiable in `values`. Each step
    starts from the state's derived fields and warm start, with the
    previous step's qpos, qvel, act and time (JAX's slim carry)."""
    cfg = self.config
    m = task.model
    lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    ts = data.time + torch.arange(cfg.horizon, dtype=values.dtype,
                                  device=values.device) * m.opt.timestep
    us = spline.sample_many(times, values, ts, cfg.interp)
    us = torch.where(m.actuator_ctrllimited,
                     mid + half * torch.tanh((us - mid) / half), us)
    batch = values.shape[:-2]
    d0 = rollout_mod.broadcast(data, batch)
    qpos, qvel, act, t = d0.qpos, d0.qvel, d0.act, d0.time
    costs = []
    for i in range(cfg.horizon):
      d = phys_step.step(m, d0.replace(qpos=qpos, qvel=qvel, act=act,
                                       time=t, ctrl=us[..., i, :]))
      costs.append(rollout_mod.step_cost(task, tp, d))
      qpos, qvel, act, t = d.qpos, d.qvel, d.act, d.time
    return torch.mean(torch.stack(costs, dim=-1), dim=-1)

  def optimize(self, task: Task, policy: GradientPolicy, data: Data,
               generator: Optional[torch.Generator] = None,
               params: Optional[TaskParams] = None
               ) -> Tuple[GradientPolicy, PlanInfo]:
    del generator  # a deterministic planner
    cfg = self.config
    m = task.model
    tp = params if params is not None else task.params
    new_times = new_grid(cfg, policy.times, data, m.opt.timestep)
    nominal = spline.resample(policy.times, policy.values, new_times,
                              cfg.interp).detach()
    values = nominal.clone().requires_grad_(True)
    with torch.enable_grad():
      nominal_return = self.total(task, data, new_times, tp, values)
      self._mark("nominal rollout")
      grad, = torch.autograd.grad(nominal_return, values)
    self._mark("gradient")
    nominal_return = nominal_return.detach()
    # the step is normalized by the gradient's scale
    direction = grad / torch.clamp(torch.linalg.vector_norm(grad),
                                   min=1e-10)
    steps = log_steps(cfg.min_step, cfg.max_step, cfg.num_steps, nominal)
    cands = nominal[None] - steps[:, None, None] * direction[None]
    lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
    cands = torch.where(m.actuator_ctrllimited, torch.clamp(cands, lo, hi),
                        cands)
    with torch.no_grad():
      returns = self.total(task, data, new_times, tp, cands)
    returns = torch.nan_to_num(returns, nan=MAX_RETURN, posinf=MAX_RETURN)
    self._mark("line search")
    all_returns = torch.cat([nominal_return[None], returns])
    all_cands = torch.cat([nominal[None], cands])
    winner = torch.argmin(all_returns)
    new_policy = policy.replace(times=new_times,
                                values=pick(all_cands, winner))
    return new_policy, PlanInfo(costs=all_returns, winner=winner,
                                best_return=pick(all_returns, winner))
