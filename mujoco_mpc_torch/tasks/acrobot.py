"""Acrobot swing-up (reference: mjpc/tasks/acrobot).

Counterpart of mujoco_mpc_tpu/tasks/acrobot.py ("Acrobot") on the
dm_control acrobot (dm_suite.build_acrobot).
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.tasks import base, dm_suite, registry

# residual_acrobot in csrc/megarollout.cu
DEVICE_RESIDUAL_ID = 8


def residual(model, data, params):
  """[|tip - target|, qvel[:2], ctrl[:1]] (4, B); the distance a plain
  Euclidean norm."""
  d = data.site_xpos[model.site("tip")] - data.site_xpos[model.site("target")]
  dist = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
  return torch.cat([dist[None], data.qvel[:2], data.ctrl[:1]])


def probe_states(model, b: int, seed: int = 0):
  """base.probe_states about the hanging pose, where the lower link's end
  sinks into the floor (plane-capsule end)."""
  return base.probe_states(model, b, seed, qpos=(np.pi, 0.0))


@registry.register("Acrobot", snapshot="acrobot",
                   builder=dm_suite.build_acrobot)
def make(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model(
      "acrobot", dtype, device)
  return base.Task(
      name="Acrobot", model=model, spec=spec, params=params,
      residual=residual, param_names=pnames,
      device_residual=base.DeviceResidual(
          DEVICE_RESIDUAL_ID, sites=(base.site_ref(model, "tip"),
                                     base.site_ref(model, "target"))))
