"""Planar point mass reaching a goal (reference: mjpc/tasks/particle).

Counterpart of mujoco_mpc_tpu/tasks/particle.py ("Particle",
"ParticleFixed") on the dm_control point mass with a mocap goal
(dm_suite.build_particle). Both tasks share the model and the residual;
Particle's transition moves the goal on a Lissajous path, a function of
time, and ParticleFixed keeps the goal Agent.set_state(mocap_pos=...)
gives it.
"""

from __future__ import annotations

import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.tasks import base, dm_suite, registry

# residual_particle in csrc/megarollout.cu
DEVICE_RESIDUAL_ID = 9


def residual(model, data, params):
  """[tip - goal (x, y), qvel[:2], ctrl[:2]] (6, B); the goal is mocap
  body 0."""
  pos = data.site_xpos[model.site("tip")][:2]
  goal = data.mocap_pos[0][:2]
  return torch.cat([pos - goal, data.qvel[:2], data.ctrl[:2]])


def transition(model, data, params):
  """The goal (mocap body 0) at 0.25 (sin 0.4 t, cos 0.8 t)."""
  t = data.time
  mocap = data.mocap_pos.clone()
  mocap[0, :2] = 0.25 * torch.stack([torch.sin(0.4 * t),
                                     torch.cos(0.8 * t)]).to(mocap.dtype)
  return data.replace(mocap_pos=mocap)


def _make(name, dtype, device, transition=None):
  model, spec, params, pnames = registry.load_task_model(
      "particle", dtype, device)
  return base.Task(
      name=name, model=model, spec=spec, params=params, residual=residual,
      param_names=pnames, transition=transition,
      device_residual=base.DeviceResidual(
          DEVICE_RESIDUAL_ID, sites=(base.site_ref(model, "tip"),)))


@registry.register("Particle", snapshot="particle",
                   builder=dm_suite.build_particle)
def make(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  return _make("Particle", dtype, device, transition)


@registry.register("ParticleFixed", snapshot="particle",
                   builder=dm_suite.build_particle)
def make_fixed(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  """The fixed-goal variant (reference ParticleFixed)."""
  return _make("ParticleFixed", dtype, device)
