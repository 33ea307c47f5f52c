"""Predictive Sampling: the zero-order random-search planner.

Counterpart of mujoco_mpc_tpu/planners/sampling.py (reference
mjpc/planners/sampling/planner.cc:155-393): N noisy copies of the nominal
spline policy (index 0 = the noise-free nominal), one rollout each, keep
the argmin. The rollouts are one MegaRollout call (ops/megarollout.py):
the CUDA kernel on the card, its plain version on the CPU. A model outside
the kernel's class, or a planner built with use_megakernel=False, scores
its candidates through the general batched rollout (ops/rollout.py)
instead, as the JAX planner does off the TPU.

Noise follows the reference (AddNoiseToPolicy, planner.cc:326-352):
per-actuator std = exploration * ctrlrange/2, with 20% of samples on a
second std when one is set, then clamping to ctrlrange. Noise comes from
an explicit torch.Generator, or is given (tests hand the same numbers to
both packages).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import torch

from mujoco_mpc_torch.ops import megarollout
from mujoco_mpc_torch.ops import rollout as rollout_mod
from mujoco_mpc_torch.ops import spline
from mujoco_mpc_torch.physics.types import Data
from mujoco_mpc_torch.planners.base import PlanInfo, new_grid
from mujoco_mpc_torch.tasks.base import Task, TaskParams

_STD2_PROPORTION = 0.2  # reference kStd2Proportion


def general_reason(task: Task, use_megakernel: bool = True) -> Optional[str]:
  """Why a sampling-family planner scores `task`'s candidates through the
  general batched rollout instead of MegaRollout, or None where it takes
  the kernel. The route follows what the caller and the task declare: a
  task with a CUDA residual takes the kernel, and a model that the kernel
  then refuses raises tilestep.UnsupportedModel rather than planning
  slower."""
  if not use_megakernel:
    return "use_megakernel=False"
  if task.device_residual is None:
    return (f"task {task.name!r} has no CUDA residual in "
            "csrc/megarollout.cu (ROADMAP queue 1 item 11)")
  return None


def build_rollout(task: Task, horizon: int, use_megakernel: bool = True
                  ) -> Tuple[Optional[megarollout.MegaRollout], Optional[str]]:
  """(the MegaRollout a sampling-family planner scores its candidates
  with, on the task model's device, or None; general_reason). Taking the
  general route warns with the reason unless the caller asked for it."""
  reason = general_reason(task, use_megakernel)
  if reason is None:
    return megarollout.MegaRollout(task, horizon,
                                   device=task.model.device), None
  if use_megakernel:
    warnings.warn(f"planning through the general rollout: {reason}",
                  stacklevel=3)
  return None, reason


def general_returns(task: Task, data: Data, new_times: torch.Tensor,
                    cands: torch.Tensor, horizon: int, interp: spline.Interp,
                    params: Optional[TaskParams]) -> torch.Tensor:
  """Candidate returns (N,) of the splines cands (N, k, nu) on the grid
  new_times through the general batched rollout from `data` (its warm
  start included); each step's action is the spline at the rollout's
  clock, which all candidates share."""
  def policy(t, d):
    return spline.sample(new_times, cands, t.reshape(-1)[0], interp)

  d0 = rollout_mod.broadcast(data, cands.shape[:1])
  return rollout_mod.rollout_return(task, d0, policy, horizon, params)


def spline_action(task: Task, times: torch.Tensor, values: torch.Tensor, t,
                  interp: spline.Interp) -> torch.Tensor:
  """The policy spline at time t, clamped to the control range."""
  u = spline.sample(times, values, t, interp)
  lo = task.model.actuator_ctrlrange[:, 0]
  hi = task.model.actuator_ctrlrange[:, 1]
  return torch.where(task.model.actuator_ctrllimited,
                     torch.clamp(u, lo, hi), u)


def candidate_actions(task: Task, data: Data, new_times: torch.Tensor,
                      cands: torch.Tensor, horizon: int,
                      interp: spline.Interp) -> torch.Tensor:
  """Per-step actions (N, T, nu) of candidate splines (N, k, nu) on the
  grid new_times, at the planning model's timestep from data.time."""
  ts = data.time + torch.arange(
      horizon, dtype=cands.dtype, device=cands.device) * \
      task.model.opt.timestep
  return spline.sample_many(new_times, cands, ts, interp).contiguous()


@dataclasses.dataclass
class SamplingPolicy:
  """Spline control policy: (times, values) node arrays."""
  times: torch.Tensor  # (k,)
  values: torch.Tensor  # (k, nu)
  exploration: torch.Tensor  # () noise std
  exploration2: torch.Tensor  # () second mixture std (0 = disabled)

  def replace(self, **kw) -> "SamplingPolicy":
    return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
  num_trajectories: int = 128
  spline_points: int = 10
  horizon: int = 100  # steps
  interp: spline.Interp = spline.Interp.ZERO

  @classmethod
  def from_task(cls, task: Task, horizon_steps: Optional[int] = None):
    m = task.model
    dt = float(m.custom("agent_timestep", float(m.opt.timestep)))
    hor = horizon_steps or int(
        round(float(m.custom("agent_horizon", 1.0)) / dt))
    return cls(
        num_trajectories=int(m.custom("sampling_trajectories", 128)),
        spline_points=int(m.custom("sampling_spline_points", 10)),
        horizon=hor,
        interp=spline.Interp(int(m.custom("sampling_representation", 0))),
    )


class SamplingPlanner:
  """Predictive-sampling planner over MegaRollout, or over the general
  rollout (`mega` is None, `general_reason` says why)."""

  def __init__(self, config: SamplingConfig, use_megakernel: bool = True):
    self.config = config
    self.use_megakernel = use_megakernel
    self.mega: Optional[megarollout.MegaRollout] = None
    self.general_reason: Optional[str] = None

  def init(self, task: Task) -> SamplingPolicy:
    """Fresh policy; the first call picks the route (build_rollout)."""
    if self.mega is None and self.general_reason is None:
      self.mega, self.general_reason = build_rollout(
          task, self.config.horizon, self.use_megakernel)
    m = task.model
    k = self.config.spline_points
    horizon_time = self.config.horizon * m.opt.timestep
    times = torch.linspace(0.0, float(horizon_time), k, dtype=m.dtype,
                           device=m.device)
    values = task.default_ctrl()[None].repeat(k, 1)
    expl = torch.tensor(float(m.custom("sampling_exploration", 0.1)),
                        dtype=m.dtype, device=m.device)
    return SamplingPolicy(times=times, values=values, exploration=expl,
                          exploration2=torch.zeros_like(expl))

  # ---------------------------------------------------------------- action
  def action(self, task: Task, policy: SamplingPolicy,
             data: Data) -> torch.Tensor:
    return spline_action(task, policy.times, policy.values, data.time,
                         self.config.interp)

  # -------------------------------------------------------------- optimize
  def _gen_candidates(self, task: Task, policy: SamplingPolicy, data: Data,
                      generator: Optional[torch.Generator],
                      noise: Optional[torch.Tensor] = None,
                      use2: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(new_times, nominal, candidate values (N, k, nu)).

    `noise` (N-1, k, nu) standard normals and `use2` (N-1,) bool replace
    the draws from `generator` when given."""
    cfg = self.config
    m = task.model
    k, n = cfg.spline_points, cfg.num_trajectories

    # 1. resample the nominal onto a grid anchored at the current time
    new_times = new_grid(cfg, policy.times, data, m.opt.timestep)
    nominal = spline.resample(policy.times, policy.values, new_times,
                              cfg.interp)

    # 2. two-component Gaussian noise on the nodes, scaled by ctrlrange
    if noise is None:
      noise = torch.randn((n - 1, k, m.nu), generator=generator,
                          dtype=nominal.dtype, device=m.device)
    if use2 is None:
      use2 = torch.rand((n - 1,), generator=generator, dtype=nominal.dtype,
                        device=m.device) < _STD2_PROPORTION
    scale = 0.5 * (m.actuator_ctrlrange[:, 1] - m.actuator_ctrlrange[:, 0])
    scale = torch.where(m.actuator_ctrllimited, scale,
                        torch.ones_like(scale))
    use2 = use2 & (policy.exploration2 > 0)
    stds = torch.where(use2, policy.exploration2, policy.exploration)
    noise = noise * stds[:, None, None] * scale[None, None, :]
    cands = torch.cat([nominal[None], nominal[None] + noise])
    lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
    cands = torch.where(m.actuator_ctrllimited, torch.clamp(cands, lo, hi),
                        cands)
    return new_times, nominal, cands

  def _actions(self, task: Task, data: Data, new_times: torch.Tensor,
               cands: torch.Tensor) -> torch.Tensor:
    """Per-step actions (N, T, nu) of the candidate splines."""
    return candidate_actions(task, data, new_times, cands,
                             self.config.horizon, self.config.interp)

  def _returns(self, task: Task, data: Data, new_times: torch.Tensor,
               cands: torch.Tensor,
               params: Optional[TaskParams]) -> torch.Tensor:
    """Candidate returns (N,) from one MegaRollout call, with the state's
    mocap poses and userdata as rollout constants; from the general
    rollout where there is no MegaRollout."""
    if self.mega is None:
      return general_returns(task, data, new_times, cands,
                             self.config.horizon, self.config.interp, params)
    actions = self._actions(task, data, new_times, cands)
    return self.mega.returns(
        data.qpos, data.qvel, actions,
        params if params is not None else task.params, data.time,
        mocap_pos=data.mocap_pos, mocap_quat=data.mocap_quat,
        userdata=data.userdata)

  def candidates(self, task: Task, policy: SamplingPolicy, data: Data,
                 generator: Optional[torch.Generator],
                 params: Optional[TaskParams] = None, noise=None, use2=None
                 ) -> Tuple[SamplingPolicy, torch.Tensor, torch.Tensor]:
    """(resampled nominal policy, candidate values (N, k, nu), returns)."""
    new_times, nominal, cands = self._gen_candidates(
        task, policy, data, generator, noise, use2)
    returns = self._returns(task, data, new_times, cands, params)
    resampled = policy.replace(times=new_times, values=nominal)
    return resampled, cands, returns

  def optimize(self, task: Task, policy: SamplingPolicy, data: Data,
               generator: Optional[torch.Generator],
               params: Optional[TaskParams] = None, noise=None, use2=None
               ) -> Tuple[SamplingPolicy, PlanInfo]:
    resampled, cands, returns = self.candidates(
        task, policy, data, generator, params, noise, use2)
    winner = torch.argmin(returns)
    new_policy = resampled.replace(values=cands[winner])
    info = PlanInfo(costs=returns, winner=winner,
                    best_return=returns[winner])
    return new_policy, info
