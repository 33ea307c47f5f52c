"""Ground-truth 'estimator': open-loop stepping of the model.

Counterpart of mujoco_mpc_tpu/estimators/ground_truth.py (reference
mjpc/estimators/estimator.h:101-288 GroundTruth): it ignores the
measurement and steps the model with the given controls.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mujoco_mpc_torch.physics import io as phys_io
from mujoco_mpc_torch.physics import step as phys_step
from mujoco_mpc_torch.physics.types import Data, Model


@dataclasses.dataclass
class GroundTruthState:
  data: Data

  def replace(self, **kw) -> "GroundTruthState":
    return dataclasses.replace(self, **kw)


class GroundTruth:
  def __init__(self, model: Model, sensor_start: int = 0,
               nsensordata: Optional[int] = None):
    # it measures nothing; the measurement's slice is taken and ignored,
    # as every estimator's is (Agent.attach_estimator passes it)
    del sensor_start, nsensordata
    self.model = model

  def init(self, data: Optional[Data] = None) -> GroundTruthState:
    return GroundTruthState(
        data=data if data is not None else phys_io.make_data(self.model))

  def update(self, state: GroundTruthState, ctrl: torch.Tensor,
             sensor: torch.Tensor) -> GroundTruthState:
    del sensor
    return GroundTruthState(data=phys_step.step(
        self.model, state.data.replace(ctrl=ctrl)))

  def state(self, s: GroundTruthState):
    return s.data.qpos, s.data.qvel, s.data.act
