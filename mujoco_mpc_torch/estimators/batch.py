"""Batch estimator: a fixed-lag smoother, the direct optimizer over a
sliding window.

Counterpart of mujoco_mpc_tpu/estimators/batch.py (reference
mjpc/estimators/batch.h:39, `class Batch : public Direct, public
Estimator`; Update at batch.cc:285): predict the newest configuration by
stepping the last estimate, shift the window, append the newest
measurement and control, re-optimize the window's configurations
(estimators/direct.py) and report the newest state. The window holds at
most kMaxFilterHistory = 64 configurations (batch.h:35).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from mujoco_mpc_torch.estimators import base
from mujoco_mpc_torch.estimators.direct import Direct, DirectConfig
from mujoco_mpc_torch.physics import io as phys_io
from mujoco_mpc_torch.physics import step as phys_step
from mujoco_mpc_torch.physics.types import Data, Model

MAX_FILTER_HISTORY = 64  # reference batch.h:35


@dataclasses.dataclass
class BatchState:
  qpos: torch.Tensor  # (W, nq) the configuration window
  sensors: torch.Tensor  # (W, ns)
  ctrls: torch.Tensor  # (W, nu)
  time: torch.Tensor  # ()

  def replace(self, **kw) -> "BatchState":
    return dataclasses.replace(self, **kw)


class Batch:
  def __init__(self, model: Model, window: int = 16, sensor_start: int = 0,
               nsensordata: Optional[int] = None, max_iterations: int = 3):
    assert 3 <= window <= MAX_FILTER_HISTORY
    self.model = model
    self.window = window
    self.direct = Direct(
        model, DirectConfig(horizon=window, max_iterations=max_iterations),
        sensor_start=sensor_start, nsensordata=nsensordata)
    self.ns = self.direct.ns
    self._template = phys_io.make_data(model)

  def init(self, data: Optional[Data] = None) -> BatchState:
    m = self.model
    d = data if data is not None else self._template
    kw = {"dtype": d.qpos.dtype, "device": d.qpos.device}
    return BatchState(
        qpos=d.qpos[None].repeat(self.window, 1),
        sensors=torch.zeros((self.window, self.ns), **kw),
        ctrls=torch.zeros((self.window, m.nu), **kw), time=d.time)

  def _velocity(self, qpos: torch.Tensor) -> torch.Tensor:
    m = self.model
    return (base.local_diff(m, qpos[-1], qpos[-2]) /
            m.opt.timestep.to(qpos.dtype))

  def update(self, state: BatchState, ctrl: torch.Tensor,
             sensor: torch.Tensor) -> BatchState:
    m = self.model
    z = base.measured(sensor, m, self.direct.sensor_start, self.ns)
    # predict the newest configuration by stepping the last estimate
    d = self._template.replace(qpos=state.qpos[-1],
                               qvel=self._velocity(state.qpos), ctrl=ctrl)
    q_new = phys_step.step(m, d).qpos
    qpos = torch.cat([state.qpos[1:], q_new[None]])
    sensors = torch.cat([state.sensors[1:], z[None]])
    ctrls = torch.cat([state.ctrls[1:], ctrl[None]])
    result = self.direct.optimize(qpos, sensors, ctrls)
    return BatchState(qpos=result.qpos, sensors=sensors, ctrls=ctrls,
                      time=state.time + m.opt.timestep.to(qpos.dtype))

  def state(self, s: BatchState) -> Tuple[torch.Tensor, ...]:
    return (s.qpos[-1], self._velocity(s.qpos),
            torch.zeros((self.model.na,), dtype=s.qpos.dtype,
                        device=s.qpos.device))
