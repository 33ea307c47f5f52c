"""The planner interface and what a planning iteration reports
(reference Planner::Plots).

Counterpart of mujoco_mpc_tpu/planners/base.py. A planner (`Planner`, the
protocol a planner given to agent.register_planner implements) has
`config`, `init(task)`, `optimize(task, policy, data, generator,
params=None)` -> (policy, PlanInfo) and `action(task, policy, data)`; the
seven planners also have `mega`, the MegaRollout their candidates go
through, or None.
"""

from __future__ import annotations

import math
from typing import (TYPE_CHECKING, Any, Callable, NamedTuple, Optional,
                    Protocol, Tuple)

import torch

from mujoco_mpc_torch.ops import spline

if TYPE_CHECKING:
  from mujoco_mpc_torch.physics.types import Data
  from mujoco_mpc_torch.tasks.base import Task, TaskParams


class PlanInfo(NamedTuple):
  """Diagnostics from one planning iteration (reference Planner::Plots)."""
  costs: torch.Tensor  # per-candidate total returns
  winner: torch.Tensor  # index of the selected candidate
  best_return: torch.Tensor  # scalar winning return
  trace_qpos: Any = None  # optional (T, nq) winner trajectory


class Planner(Protocol):
  """The structural protocol every planner implements. Where the JAX
  package's optimize takes a PRNG key, the port's takes a torch.Generator
  (None: the global one) for its random draws."""

  def init(self, task: Task) -> Any:
    """Fresh policy/planner state."""

  def optimize(self, task: Task, state: Any, data: Data,
               generator: Optional[torch.Generator],
               params: Optional[TaskParams] = None
               ) -> Tuple[Any, PlanInfo]:
    """One OptimizePolicy iteration."""

  def action(self, task: Task, state: Any, data: Data) -> torch.Tensor:
    """ActionFromPolicy: ctrl at data.time."""



def pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
  """x[i] for a 0-d index tensor on x's device, as a gather: indexing with
  a tensor scalar would read it back to the host."""
  return torch.index_select(x, 0, i.reshape(1))[0]


class PhaseMarks:
  """A planner whose optimize names its phases: `timer`, where set, is
  called with each phase's name as optimize ends it (chip_smoke.py times
  the phases with CUDA events through it)."""

  timer: Optional[Callable[[str], None]] = None

  def _mark(self, name: str) -> None:
    if self.timer is not None:
      self.timer(name)


def new_grid(cfg, policy_times: torch.Tensor, data, timestep) -> torch.Tensor:
  """A spline policy's node times for the next plan: cfg.spline_points
  nodes over the planning horizon, anchored at the state's time (the
  reference's UpdateNominalPolicy grid)."""
  k = cfg.spline_points
  horizon_time = torch.as_tensor((cfg.horizon - 1) * timestep,
                                 dtype=policy_times.dtype,
                                 device=policy_times.device)
  denom = k if cfg.interp == spline.Interp.ZERO else k - 1
  # a true division on either device: a CUDA tensor divided by a Python
  # number is multiplied by its reciprocal, an ulp off the CPU's quotient,
  # which moves a knot that falls on a step's time across it
  spacing = horizon_time / torch.full_like(horizon_time, float(max(denom, 1)))
  return data.time + torch.arange(
      k, dtype=policy_times.dtype, device=policy_times.device) * spacing


def log_steps(lo: float, hi: float, n: int, like: torch.Tensor):
  """n step sizes log-spaced over [lo, hi], in like's dtype and device
  (made in float64, as the JAX package makes them under x64)."""
  return torch.exp(torch.linspace(math.log(lo), math.log(hi), n,
                                  dtype=torch.float64, device=like.device)
                   ).to(like.dtype)
