"""Pick: a Panda-style arm reaches a cube and brings it to a 6-DoF target
pose (reference: mjpc/tasks/panda/panda.cc:38-99).

Counterpart of mujoco_mpc_tpu/tasks/pick.py ("Pick") on
tasks/models/panda_pick.xml, the JAX package's MJCF. The target is mocap
body 0, which carries the sites target1 and target2; the two-point bring
(box1 and box2 against them) holds position and axis in 6 numbers.

Residual layout, 9 entries: Reach (3) (end effector - box), Bring (6)
(box1 - target1, box2 - target2).
"""

from __future__ import annotations

import math
import os

import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.tasks import base, registry

# residual_pick in csrc/megarollout.cu
DEVICE_RESIDUAL_ID = 15

_PHI = 0.6180339887498949  # golden-ratio sequence for relocations
_SITES = ("eeff", "box1", "box2", "target1", "target2")


def residual(model, data, params):
  """Residual (9, B) on the component-leading, batch-trailing view."""
  s = [data.site_xpos[model.site(n)] for n in _SITES]
  return torch.cat([s[0] - data.xpos[model.body("box")], s[1] - s[3],
                    s[2] - s[4]])


def transition(model, data, params):
  """The relocation of the JAX package (panda.cc:74-99): once the box's
  two sites are within 1.5 cm of the target's on average (after time 0),
  the box moves to a new spot on the table and the target to a new pose,
  both on a golden-ratio sequence; userdata[0] counts the relocations."""
  s = [data.site_xpos[model.site(n)] for n in _SITES[1:]]
  bring = 0.5 * (torch.linalg.vector_norm(s[0] - s[2], dim=0)
                 + torch.linalg.vector_norm(s[1] - s[3], dim=0))
  done = (bring < 0.015) & (data.time > 0)
  count = data.userdata[0] + torch.where(done, 1.0, 0.0)
  ang = 2.0 * math.pi * _PHI * count
  new_box = torch.stack([0.35 * torch.cos(ang), 0.35 * torch.sin(ang),
                         torch.full_like(ang, 0.05)])
  new_tgt = torch.stack([0.35 * torch.cos(ang + 2.0),
                         0.35 * torch.sin(ang + 2.0),
                         0.15 + 0.25 * (0.5 + 0.5 * torch.sin(3.0 * ang))])
  qadr = model.jnt_qposadr[model.joint("box_root")]
  qpos = data.qpos
  box = torch.where(done, new_box.to(qpos.dtype), qpos[qadr:qadr + 3])
  qpos = torch.cat([qpos[:qadr], box, qpos[qadr + 3:]])
  mp = data.mocap_pos
  target = torch.where(done, new_tgt.to(mp.dtype), mp[0])
  return data.replace(
      qpos=qpos, mocap_pos=torch.cat([target[None], mp[1:]]),
      userdata=torch.cat([count[None].to(data.userdata.dtype),
                          data.userdata[1:]]))


def build_pick():
  """tasks/models/panda_pick.xml as a mujoco.MjModel (needs mujoco)."""
  import mujoco
  return mujoco.MjModel.from_xml_path(
      os.path.join(os.path.dirname(__file__), "models", "panda_pick.xml"))


@registry.register("Pick", snapshot="pick", builder=build_pick)
def make(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model("pick", dtype,
                                                         device)
  return base.Task(
      name="Pick", model=model, spec=spec, params=params, residual=residual,
      param_names=pnames, transition=transition,
      device_residual=base.DeviceResidual(
          DEVICE_RESIDUAL_ID, (model.body("box"),), (),
          tuple(base.site_ref(model, n) for n in _SITES)))
