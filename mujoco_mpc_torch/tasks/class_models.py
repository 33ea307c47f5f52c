"""Small models of the kernel's class, one or a few constraint row kinds
each, with the state (qpos, qvel) as their residual.

No registered task runs a connect or weld equality, and the tasks mix
their row kinds; these models hold the kernel against the plain version
kind by kind. Their MJCF are the JAX package's own small test models
(tests/test_tilestep_classes.py) and a capsule pressing a box. Built
through `mujoco` where it is installed (`build`); `write_snapshots()`
writes each one's Model as tasks/models/class_<name>.npz, which `task`
loads on a host without `mujoco`:

    python -c "from mujoco_mpc_torch.tasks import class_models; \\
               class_models.write_snapshots()"
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.physics import io as phys_io
from mujoco_mpc_torch.tasks import base, registry

# residual_state in csrc/megarollout.cu: the residual (qpos, qvel)
STATE_RESIDUAL_ID = 5

TENDON_XML = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.005"/>
  <default><geom contype="0" conaffinity="0"/></default>
  <worldbody>
    <body name="a" pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0"/>
      <geom type="capsule" size="0.02" fromto="0 0 0 0 0 -0.3" mass="1"/>
      <body name="b" pos="0 0 -0.3">
        <joint name="j2" type="hinge" axis="0 1 0"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0 0 -0.3" mass="1"/>
      </body>
    </body>
  </worldbody>
  <tendon>
    <fixed name="t1" {attr}>
      <joint joint="j1" coef="1.0"/>
      <joint joint="j2" coef="-0.7"/>
    </fixed>
  </tendon>
  <actuator>{act}</actuator>
  {extra}
</mujoco>
"""

MOTOR_J1 = ('<motor joint="j1" gear="2" ctrlrange="-1 1" '
            'ctrllimited="true"/>')

CHAIN_XML = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002"/>
  <default><geom contype="0" conaffinity="0"/></default>
  <worldbody>
    <body name="a" pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0"/>
      <geom type="capsule" size="0.02" fromto="0 0 0 0.3 0 0" mass="1"/>
      <body name="tip_a" pos="0.3 0 0">
        <joint name="j2" type="hinge" axis="0 1 0"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0.2 0 0" mass="0.5"/>
      </body>
    </body>
    <body name="c" pos="0.5 0 1">
      <joint name="j3" type="hinge" axis="0 1 0"/>
      <geom type="capsule" size="0.02" fromto="0 0 0 0 0 -0.2" mass="0.5"/>
    </body>
  </worldbody>
  <actuator><motor joint="j1" gear="1" ctrlrange="-1 1"
    ctrllimited="true"/></actuator>
  <equality>{eq}</equality>
</mujoco>
"""

BALL_XML = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.005"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1" condim="{condim}"/>
    <body name="ball" pos="0 0 0.11">
      <freejoint/>
      <geom type="sphere" size="0.1" mass="0.5" condim="{condim}"
            friction="0.8 0.01 0.002"/>
    </body>
    <body name="pusher" pos="0.5 0 0.1">
      <joint name="slide" type="slide" axis="1 0 0" damping="1"/>
      <geom type="sphere" size="0.08" mass="0.3" condim="{condim}"
            friction="0.8 0.01 0.002"/>
    </body>
  </worldbody>
  <actuator><motor joint="slide" gear="5" ctrlrange="-1 1"
    ctrllimited="true"/></actuator>
</mujoco>
"""

CAPBOX_XML = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.005"/>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 0.1"/>
    <body name="arm" pos="0 0 0.2">
      <joint name="lift" type="slide" axis="0 0 1" damping="2"/>
      <joint name="tilt" type="hinge" axis="0 1 0" damping="0.5"/>
      <geom type="capsule" size="0.02" fromto="-0.08 0 0 0.08 0 0"
            mass="0.5" condim="4" friction="1 0.02 0.001"/>
    </body>
    <body name="box" pos="0 0 0.05">
      <freejoint/>
      <geom type="box" size="0.1 0.08 0.05" mass="1"/>
    </body>
  </worldbody>
  <actuator>
    <motor joint="lift" gear="10" ctrlrange="-1 1" ctrllimited="true"/>
    <motor joint="tilt" gear="1" ctrlrange="-1 1" ctrllimited="true"/>
  </actuator>
</mujoco>
"""

# the port's own model (no JAX test has a ball-joint tile model): a ball
# joint mid-chain, with damping and armature on its dofs and a limited
# hinge after it, whose tip sphere meets a capsule on a slide joint
# (sphere-capsule) and the floor (plane-sphere); the chain's capsules
# collide with nothing
BALL_CHAIN_XML = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.005"/>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 0.1"/>
    <body name="base" pos="0 0 0.598">
      <joint name="swing" type="hinge" axis="0 1 0" damping="0.2"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0 0 -0.2" mass="1"
            contype="0" conaffinity="0"/>
      <body name="arm" pos="0 0 -0.2">
        <joint name="ball" type="ball" damping="0.3" armature="0.01"/>
        <geom type="capsule" size="0.03" fromto="0 0 0 0.2 0 0" mass="0.5"
              contype="0" conaffinity="0"/>
        <body name="fore" pos="0.2 0 0">
          <joint name="elbow" type="hinge" axis="0 0 1" damping="0.1"
                 limited="true" range="-1 1"/>
          <geom name="tip" type="sphere" size="0.05" pos="0.15 0 0"
                mass="0.3"/>
        </body>
      </body>
    </body>
    <body name="rod" pos="0.3 0 0.1">
      <joint name="lift" type="slide" axis="0 0 1" damping="1"/>
      <geom name="rod" type="capsule" size="0.04" fromto="-0.2 0 0 0.2 0 0"
            mass="0.5"/>
    </body>
  </worldbody>
  <actuator>
    <motor joint="swing" gear="1" ctrlrange="-1 1" ctrllimited="true"/>
    <motor joint="elbow" gear="1" ctrlrange="-1 1" ctrllimited="true"/>
    <motor joint="lift" gear="5" ctrlrange="-1 1" ctrllimited="true"/>
  </actuator>
</mujoco>
"""

# the ball 2 mm into the floor, the pusher into the ball
_BALL_Q0 = (0.0, 0.0, 0.098, 1.0, 0.0, 0.0, 0.0, -0.33)


@dataclasses.dataclass(frozen=True)
class ClassModel:
  xml: str
  qpos0: tuple  # the start state's qpos (states() adds noise)
  vscale: float  # qvel of states() uniform in +-vscale
  kinds: tuple  # the row classes that carry force on states()


MODELS = {
    "tendon_spring": ClassModel(
        TENDON_XML.format(
            attr='limited="true" range="-0.25 0.25" stiffness="3" '
                 'damping="0.5" springlength="0 0.05"',
            act=MOTOR_J1, extra=""),
        (0.35, 0.1), 1.0, ("tendon_limit",)),
    "tendon_actuator": ClassModel(
        TENDON_XML.format(
            attr="", act='<motor tendon="t1" gear="1.5" ctrlrange="-1 1" '
                         'ctrllimited="true"/>', extra=""),
        (0.3, -0.2), 1.0, ()),
    "condim4_ball": ClassModel(
        BALL_XML.format(condim=4), _BALL_Q0, 0.3,
        ("plane_sphere", "sphere_sphere", "torsional")),
    # the capsule 5 mm into the box's top, the box 1 mm into the floor
    "capsule_box": ClassModel(
        CAPBOX_XML, (-0.085, 0.05, 0.0, 0.0, 0.049, 1.0, 0.0, 0.0, 0.0), 0.3,
        ("cap_box", "plane_boxcorner", "torsional")),
    "joint_equality": ClassModel(
        TENDON_XML.format(
            attr="", act=MOTOR_J1,
            extra='<equality><joint joint1="j1" joint2="j2" '
                  'polycoef="0 0.5 0.1 0 0"/></equality>'),
        (0.3, -0.2), 1.0, ("eq_joint",)),
    "connect": ClassModel(
        CHAIN_XML.format(
            eq='<connect body1="tip_a" body2="c" anchor="0.2 0 0"/>'),
        (0.05, -0.05, 0.05), 1.0, ("eq_connect",)),
    "weld": ClassModel(
        CHAIN_XML.format(eq='<weld body1="tip_a" body2="c"/>'),
        (0.05, -0.05, 0.05), 1.0, ("eq_weld",)),
    "condim6_ball": ClassModel(
        BALL_XML.format(condim=6), _BALL_Q0, 0.3,
        ("plane_sphere", "sphere_sphere", "torsional", "rolling")),
    # states: _ball_chain_states
    "ball_chain": ClassModel(
        BALL_CHAIN_XML, (0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0), 1.0,
        ("sphere_cap", "plane_sphere", "plane_capend", "joint_limit")),
}


def build(name: str):
  """MODELS[name] as a mujoco.MjModel (needs mujoco)."""
  import mujoco
  return mujoco.MjModel.from_xml_string(MODELS[name].xml)


def snapshot_path(name: str) -> str:
  return registry.snapshot_path(f"class_{name}")


def write_snapshots(names=None) -> None:
  """Rebuild the snapshots of MODELS, all or those in `names` (needs
  mujoco)."""
  for name in MODELS if names is None else names:
    phys_io.save_snapshot(snapshot_path(name), phys_io.from_mjmodel(
        build(name), dtype=torch.float64, device="cpu"))


def task(name: str, dtype=torch.float32, device=devices.DEFAULT,
         model=None) -> base.Task:
  """The Task of MODELS[name]: its model (from the snapshot unless given),
  one QUADRATIC term on (qpos, qvel), and residual_state on the card."""
  if model is None:
    model, _ = phys_io.load_snapshot(snapshot_path(name), dtype, device)
  dev = model.device
  spec = base.CostSpec(("State",), (0,), (model.nq + model.nv,))

  def f(x):
    return torch.tensor(x, dtype=dtype, device=dev)

  params = base.TaskParams(weights=f([1.0]), norm_params=f([[0.0, 0.0]]),
                           risk=f(0.0), residual_params=f([]))
  return base.Task(
      model=model, params=params, name=name, spec=spec,
      residual=lambda m, data, p: torch.cat([data.qpos, data.qvel]),
      device_residual=base.DeviceResidual(STATE_RESIDUAL_ID))


def _axis_quat(axis, angle):
  """Quaternions (b, 4) of rotations by angle (b,) about a unit axis."""
  return np.concatenate([np.cos(angle / 2)[:, None],
                         np.sin(angle / 2)[:, None] * np.asarray(axis)[None]],
                        1)


def _ball_chain_states(b: int, rng):
  """State i % 3 of the ball chain: 0 turns the ball far about the arm's
  axis and lifts the rod into the tip sphere (sphere-capsule); 1 turns it
  a quarter about y, so the arm points down and the tip sinks into the
  floor (plane-sphere), and lowers the rod's ends into the floor
  (plane-capsule end); 2 bends the elbow past its range (joint limit).
  Every ball quaternion is far from identity, and every third one is
  unnormalized (scaled by 1.3). qpos is (swing, ball w x y z, elbow,
  lift)."""
  kind = np.arange(b) % 3
  qp = np.zeros((b, 7))
  qp[:, 0] = rng.uniform(-0.02, 0.02, b)
  about_x = _axis_quat((1.0, 0.0, 0.0), rng.uniform(1.8, 2.4, b))
  # the tip on the arm's axis at (0.35, 0, 0.398): the rod 5 mm into it
  qp[:, 1:5] = about_x
  qp[:, 5] = rng.uniform(-0.02, 0.02, b)
  qp[:, 6] = 0.398 - 0.09 + 0.005 - 0.1
  down = kind == 1  # the arm down: the tip 2 mm into the floor
  qp[down, 1:5] = _axis_quat((0.0, 1.0, 0.0), np.full(down.sum(),
                                                      np.pi / 2))
  qp[down, 6] = -0.062
  past = kind == 2
  qp[past, 5] = 1.05
  qp[np.arange(b) % 3 == 0, 1:5] *= 1.3
  qv = rng.uniform(-1.0, 1.0, (b, 6))
  qv[kind == 0, 5] = rng.uniform(0.2, 0.5, (kind == 0).sum())  # rod up
  ct = rng.uniform(-1.0, 1.0, (b, 3))
  return tuple(np.ascontiguousarray(x.T, np.float32) for x in (qp, qv, ct))


def states(name: str, model, b: int, seed: int = 0):
  """(qpos (nq, b), qvel (nv, b), ctrl (nu, b)) float32 numpy: the model's
  start state with noise; with a spin about the vertical on the free
  bodies, so the torsional rows carry force. The ball chain's are
  _ball_chain_states."""
  if name == "ball_chain":
    return _ball_chain_states(b, np.random.RandomState(seed))
  cm = MODELS[name]
  rng = np.random.RandomState(seed)
  qp = np.asarray(cm.qpos0, np.float32)[:, None] + rng.uniform(
      -0.002, 0.002, (model.nq, b)).astype(np.float32)
  qv = cm.vscale * rng.uniform(-1.0, 1.0, (model.nv, b))
  for j in range(model.njnt):
    if model.jnt_type[j] == 0:  # free joint: spin about z
      qv[model.jnt_dofadr[j] + 5] = rng.uniform(2.0, 4.0, b)
  ct = rng.uniform(-1.0, 1.0, (model.nu, b))
  return qp, qv.astype(np.float32), ct.astype(np.float32)
