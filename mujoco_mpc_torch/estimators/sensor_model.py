"""A small model whose sensors an estimator measures: a pendulum (a hinge
under a motor) with sensors of its angle, its speed and its tip's position
and velocity, the MJCF of the test suite's pendulum (tests/models.py).

The registered tasks' measurements are mostly the cost terms' USER slots
(Cartpole measures only those: zero after forward, so its Kalman filter's
C and gain are zero), so the estimators' measurement updates are held on
the card on this model. Built through `mujoco` where it is installed
(`build`); `write_snapshot()` writes tasks/models/estimator_pendulum.npz,
which `load` reads on a host without `mujoco`:

    python -c "from mujoco_mpc_torch.estimators import sensor_model; \\
               sensor_model.write_snapshot()"
"""

from __future__ import annotations

import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.physics import io as phys_io
from mujoco_mpc_torch.physics.types import Model
from mujoco_mpc_torch.tasks import registry

PENDULUM_XML = """
<mujoco model="pendulum">
  <option timestep="0.005" gravity="0 0 -9.81"/>
  <worldbody>
    <body name="arm" pos="0 0 1">
      <joint name="pivot" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom name="rod" type="capsule" fromto="0 0 0 0 0 -0.5" size="0.02"
            contype="0" conaffinity="0"/>
      <body name="bob" pos="0 0 -0.5">
        <geom name="ball" type="sphere" size="0.05" mass="0.3"
              contype="0" conaffinity="0"/>
        <site name="tip" pos="0 0 0"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor name="torque" joint="pivot" gear="2" ctrlrange="-1 1"
           ctrllimited="true"/>
  </actuator>
  <sensor>
    <jointpos name="angle" joint="pivot"/>
    <jointvel name="speed" joint="pivot"/>
    <framepos name="tip_pos" objtype="site" objname="tip"/>
    <framelinvel name="tip_vel" objtype="site" objname="tip"/>
  </sensor>
</mujoco>
"""

SNAPSHOT = "estimator_pendulum"


def build(dtype=torch.float64, device="cpu") -> Model:
  """The Model from the MJCF (needs mujoco)."""
  import mujoco
  return phys_io.from_mjmodel(mujoco.MjModel.from_xml_string(PENDULUM_XML),
                              dtype=dtype, device=device)


def write_snapshot() -> None:
  phys_io.save_snapshot(registry.snapshot_path(SNAPSHOT), build())


def load(dtype=torch.float32, device=devices.DEFAULT) -> Model:
  """The Model from its snapshot."""
  return phys_io.load_snapshot(registry.snapshot_path(SNAPSHOT), dtype,
                               device)[0]
