"""Reference-fidelity models built from the installed dm_control.

Copy of the parts of mujoco_mpc_tpu/tasks/dm_suite.py that the ported
tasks use (importing that module would import JAX). The XML comes from the
installed dm_control package; the reference's build-time patches
(mjpc/tasks/CMakeLists.txt:19-50) and this framework's task layer (cost
`<user>` sensors, `agent_*` / `residual_*` numerics, keyframes) are applied
with `mujoco.MjSpec`. Host-only: needs `mujoco` and `dm_control`.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple


def suite_dir() -> str:
  import dm_control.suite
  return os.path.dirname(dm_control.suite.__file__)


def load_spec(name: str):
  """MjSpec for a dm_control suite model (resolves common/ includes)."""
  import mujoco

  return mujoco.MjSpec.from_file(os.path.join(suite_dir(), f"{name}.xml"))


def strip_sensors(spec) -> None:
  """Drop dm_control's instrumentation; the task defines its own sensors."""
  for s in list(spec.sensors):
    spec.delete(s)


def add_numerics(spec, numerics: Dict[str, Sequence[float]]) -> None:
  for name, data in numerics.items():
    if isinstance(data, (int, float)):
      data = [float(data)]
    spec.add_numeric(name=name, data=[float(v) for v in data],
                     size=len(data))


def add_cost_sensors(spec, terms: Sequence[Tuple[str, int,
                                                 Sequence[float]]]) -> None:
  """Task cost terms as `<user>` sensors (user="norm weight lo hi
  params...")."""
  import mujoco

  for name, dim, user in terms:
    s = spec.add_sensor(name=name, type=mujoco.mjtSensor.mjSENS_USER,
                        dim=int(dim))
    s.userdata = [float(v) for v in user]


def compile_model(spec):
  return spec.compile()


def build_walker():
  """dm_control planar walker + reference patch semantics
  (walker.xml.patch: long runway floor, sensors stripped)."""
  spec = load_spec("walker")
  spec.modelname = "Walker (dm_control)"
  strip_sensors(spec)
  floor = spec.geom("floor")
  floor.pos = [998.0, 0.0, 0.0]
  floor.size = [1000.0, 0.8, 0.2]

  add_numerics(spec, {
      "agent_planner": 0,
      "agent_horizon": 0.8,
      "agent_timestep": 0.01,
      "sampling_spline_points": 6,
      "sampling_trajectories": 128,
      "sampling_exploration": 0.35,
      "residual_Speed": 1.0,
      "residual_Height": 1.2,
  })
  add_cost_sensors(spec, [
      ("Height", 1, [6, 15.0, 0, 100.0, 0.02]),
      ("Upright", 1, [6, 8.0, 0, 50.0, 0.02]),
      ("Speed", 1, [6, 5.0, 0, 50.0, 0.1]),
      ("Control", 6, [0, 0.05, 0, 1.0]),
  ])
  spec.add_key(name="home",
               qpos=[0, 0, 0, 0.2, -0.3, 0.1, -0.2, -0.1, -0.1])
  return compile_model(spec)


def _humanoid_spec():
  """The full-DOF dm_control humanoid plant with the reference patch
  semantics (humanoid.xml.patch): spawn height 1.282, knee gear 100,
  hip_x range -30..10, hip_y -150..20, elbow -100..50, two limited
  hamstring tendons (hip_y/knee, range -0.3..2), lower_waist/thigh contact
  excludes, dm_control's sensors removed. The planning model's contacts
  are scoped with contype/conaffinity bits (bit 0 = floor group, bit 1 =
  legs): floor against feet, shins, butt, torso and head, plus the
  leg-leg pairs (condim 1); no arm or waist self-collision."""
  import mujoco

  spec = load_spec("humanoid")
  spec.modelname = "Humanoid (dm_control)"
  spec.option.timestep = 0.005
  strip_sensors(spec)
  spec.body("torso").pos = [0.0, 0.0, 1.282]

  floor_only = ("butt", "torso", "head")
  leg_floor = ("right_shin", "left_shin", "right_right_foot",
               "left_right_foot", "left_left_foot", "right_left_foot")
  leg_only = ("right_thigh", "left_thigh")
  for g in spec.geoms:
    if g.name == "floor":
      g.contype, g.conaffinity = 1, 1
    elif g.name in leg_floor:
      g.contype, g.conaffinity = 3, 2
    elif g.name in leg_only:
      g.contype, g.conaffinity = 2, 2
    elif g.name in floor_only:
      g.contype, g.conaffinity = 1, 0
    else:
      g.contype, g.conaffinity = 0, 0

  for side in ("right", "left"):
    spec.actuator(f"{side}_knee").gear = [100, 0, 0, 0, 0, 0]
    spec.joint(f"{side}_hip_x").range = [-30.0, 10.0]
    spec.joint(f"{side}_hip_y").range = [-150.0, 20.0]
    spec.joint(f"{side}_elbow").range = [-100.0, 50.0]
    t = spec.add_tendon(name=f"hamstring_{side}",
                        limited=mujoco.mjtLimited.mjLIMITED_TRUE,
                        range=[-0.3, 2.0])
    t.wrap_joint(f"{side}_hip_y", 0.5)
    t.wrap_joint(f"{side}_knee", -0.5)
    spec.add_exclude(bodyname1="lower_waist", bodyname2=f"{side}_thigh")
  return spec


def build_humanoid(mode: str = "walk"):
  """Humanoid Stand/Walk model: the plant above plus the cost spec of
  the reference's tasks/humanoid/walk/task.xml; mode "stand" sets the
  Speed parameter to 0."""
  spec = _humanoid_spec()
  add_numerics(spec, {
      "agent_planner": 0,
      "agent_horizon": 0.5,
      "agent_timestep": 0.015,
      "sampling_spline_points": 4,
      "sampling_trajectories": 128,
      "sampling_exploration": 0.12,
      "residual_Height": 1.35,
      "residual_Speed": 0.0 if mode == "stand" else 1.0,
      "residual_Balance": 0.3,
  })
  add_cost_sensors(spec, [
      ("Height", 1, [7, 5.0, 0, 25.0, 0.1, 4.0]),
      ("Pelvis/Feet", 1, [8, 1.0, 0, 10.0, 0.05]),
      ("Balance", 2, [1, 5.0, 0, 25.0, 0.02, 4.0]),
      ("Upright", 8, [2, 5.0, 0, 25.0, 0.01]),
      ("Posture", 21, [0, 0.025, 0, 1.0]),
      ("Walk", 1, [7, 1.0, 0, 25.0, 0.5, 3.0]),
      ("Velocity", 2, [7, 0.625, 0, 25.0, 0.2, 4.0]),
      ("Control", 21, [3, 0.025, 0, 1.0, 0.3]),
  ])
  spec.add_key(name="home",
               qpos=[0, 0, 1.282, 1, 0, 0, 0] + [0.0] * 21)
  return compile_model(spec)


def build_cartpole():
  """dm_control cartpole + reference patch semantics (cartpole.xml.patch:
  Euler @ 1 kHz, lighter joint damping)."""
  import mujoco

  spec = load_spec("cartpole")
  spec.modelname = "Cartpole (dm_control)"
  spec.option.timestep = 0.01  # planning timestep == sim here
  spec.option.integrator = mujoco.mjtIntegrator.mjINT_EULER
  spec.joint("slider").damping = [1.0e-4, 0.0, 0.0]
  spec.joint("hinge_1").damping = [1.0e-4, 0.0, 0.0]
  strip_sensors(spec)

  add_numerics(spec, {
      # reference task.xml:10 runs cartpole with the GRADIENT planner —
      # random spline noise alone cannot pump out of the hanging
      # equilibrium at dm_control's gear-10 torque budget
      "agent_planner": 1,
      "agent_horizon": 1.0,
      "agent_timestep": 0.01,
      "sampling_spline_points": 10,
      "sampling_trajectories": 128,
      "sampling_exploration": 0.5,
      "residual_Goal": 0.0,
  })
  add_cost_sensors(spec, [
      # norms/params mirror reference task.xml:31-34 (SMOOTH_ABS)
      ("Vertical", 1, [6, 10.0, 0, 100.0, 0.01]),
      ("Centered", 1, [6, 10.0, 0, 100.0, 0.1]),
      ("Velocity", 1, [0, 0.1, 0, 1.0]),
      ("Control", 1, [0, 0.1, 0, 1.0]),
  ])
  # reference task.xml:48 home: cart offset at x=1, pole UP — the
  # gradient planner (agent_planner 1) balances while recentering; the
  # exact hanging pose is a saddle where its gradient vanishes. A "down"
  # keyframe is kept for swing-up experiments.
  spec.add_key(name="home", qpos=[1.0, 0.0])
  spec.add_key(name="down", qpos=[0.0, 3.14159265])
  return compile_model(spec)


def build_acrobot():
  """dm_control acrobot + patch semantics (Euler instead of RK4)."""
  import mujoco

  spec = load_spec("acrobot")
  spec.modelname = "Acrobot (dm_control)"
  spec.option.integrator = mujoco.mjtIntegrator.mjINT_EULER
  strip_sensors(spec)

  add_numerics(spec, {
      "agent_planner": 0,
      "agent_horizon": 1.5,
      "agent_timestep": 0.01,
      "sampling_spline_points": 10,
      "sampling_trajectories": 128,
      "sampling_exploration": 0.4,
  })
  add_cost_sensors(spec, [
      ("Height", 1, [6, 8.0, 0, 50.0, 0.02]),
      ("Velocity", 2, [0, 0.05, 0, 1.0]),
      ("Control", 1, [0, 0.05, 0, 1.0]),
  ])
  return compile_model(spec)


def build_particle(fixed_goal: bool = False):
  """dm_control point_mass + patch semantics (particle.xml.patch: mocap
  goal body, direct joint motors instead of tendon transmission).
  `fixed_goal` is accepted and ignored, as in the JAX package: Particle
  and ParticleFixed share this model."""
  import mujoco

  spec = load_spec("point_mass")
  spec.modelname = "Particle (dm_control)"
  spec.option.timestep = 0.01
  strip_sensors(spec)

  # tendon-transmission motors -> direct joint motors (patch semantics;
  # also keeps this task in the megakernel's joint-transmission class)
  for a in list(spec.actuators):
    spec.delete(a)
  for t in list(spec.tendons):
    spec.delete(t)
  for jnt, name in (("root_x", "x_motor"), ("root_y", "y_motor")):
    a = spec.add_actuator(name=name, target=jnt,
                          trntype=mujoco.mjtTrn.mjTRN_JOINT,
                          ctrllimited=mujoco.mjtLimited.mjLIMITED_TRUE,
                          ctrlrange=[-1.0, 1.0])
    a.gear = [1, 0, 0, 0, 0, 0]

  # tip site on the point mass (patch adds it; the residual reads it)
  spec.body("pointmass").add_site(name="tip", pos=[0, 0, 0],
                                  size=[0.01, 0, 0])

  # target geom -> mocap goal body
  tgt = spec.geom("target")
  spec.delete(tgt)
  goal = spec.worldbody.add_body(name="goal", mocap=True,
                                 pos=[0.15, 0.15, 0.01])
  goal.add_geom(name="goal", type=mujoco.mjtGeom.mjGEOM_SPHERE,
                size=[0.01, 0, 0], contype=0, conaffinity=0,
                rgba=[0, 1, 0, 0.5])

  add_numerics(spec, {
      "agent_planner": 0,
      "agent_horizon": 0.5,
      "agent_timestep": 0.01,
      "sampling_spline_points": 5,
      "sampling_trajectories": 64,
      "sampling_exploration": 0.3,
  })
  add_cost_sensors(spec, [
      ("Position", 2, [2, 5.0, 0, 20.0, 0.01]),
      ("Velocity", 2, [0, 0.1, 0, 1.0]),
      ("Control", 2, [0, 0.05, 0, 1.0]),
  ])
  return compile_model(spec)


def build_humanoid_track():
  """Humanoid Track model: the humanoid plant with the mocap-tracking cost
  spec (reference humanoid/tracking/task.xml:82-91: joint velocity,
  control, average marker position, per-marker position and marker
  velocity terms, at nv - 6 = 21 and nu = 21)."""
  spec = _humanoid_spec()
  add_numerics(spec, {
      "agent_planner": 0,
      "agent_horizon": 0.5,
      "agent_timestep": 0.01,
      "sampling_spline_points": 4,
      "sampling_trajectories": 128,
      "sampling_exploration": 0.25,
      "residual_Clip": 0,
  })
  add_cost_sensors(spec, [
      ("JointVel", 21, [0, 0.01, 0, 0.1]),
      ("Control", 21, [3, 0.02, 0, 1.0, 0.3]),
      ("AvgPos", 3, [2, 4.0, 0, 20.0, 0.01]),
      ("MarkerPos", 18, [2, 4.0, 0, 20.0, 0.01]),
      ("MarkerVel", 18, [0, 0.05, 0, 1.0]),
  ])
  spec.add_key(name="home",
               qpos=[0, 0, 1.282, 1, 0, 0, 0] + [0.0] * 21)
  return compile_model(spec)


def build_humanoid_interact():
  """Humanoid Interact model: the humanoid plant with a chair (a seat and
  a backrest that collide, four legs that do not) and the sit/stand cost
  spec (reference humanoid/interact/interact.cc:30-196)."""
  import mujoco

  spec = _humanoid_spec()
  spec.body("head").add_site(name="head_site", pos=[0.0, 0.0, 0.0])
  chair = spec.worldbody.add_body(name="chair", pos=[0.6, 0.0, 0.0])
  g = chair.add_geom(name="seat", type=mujoco.mjtGeom.mjGEOM_BOX,
                     pos=[0.0, 0.0, 0.4], size=[0.22, 0.24, 0.03])
  g.contype, g.conaffinity = 1, 1
  g = chair.add_geom(name="backrest", type=mujoco.mjtGeom.mjGEOM_BOX,
                     pos=[0.2, 0.0, 0.7], size=[0.03, 0.24, 0.3])
  g.contype, g.conaffinity = 1, 1
  for i, (sx, sy) in enumerate(((1, 1), (1, -1), (-1, 1), (-1, -1))):
    g = chair.add_geom(name=f"leg{i}", type=mujoco.mjtGeom.mjGEOM_BOX,
                       pos=[0.17 * sx, 0.19 * sy, 0.185],
                       size=[0.03, 0.03, 0.185])
    g.contype, g.conaffinity = 0, 0
  chair.add_site(name="seat_site", pos=[0.0, 0.0, 0.43])
  add_numerics(spec, {
      "agent_planner": 0,
      "agent_horizon": 0.5,
      "agent_timestep": 0.01,
      "sampling_spline_points": 4,
      "sampling_trajectories": 128,
      "sampling_exploration": 0.25,
      "residual_SitHeadHeight": 0.95,
      "residual_StandHeadHeight": 1.48,
  })
  add_cost_sensors(spec, [
      ("Torso Up", 1, [6, 10.0, 0, 100.0, 0.1]),
      ("Pelvis Up", 1, [6, 10.0, 0, 100.0, 0.1]),
      ("RFoot Up", 1, [6, 2.0, 0, 100.0, 0.1]),
      ("LFoot Up", 1, [6, 2.0, 0, 100.0, 0.1]),
      ("Head Height", 1, [6, 20.0, 0, 100.0, 0.1]),
      ("Knee Feet XY", 1, [6, 5.0, 0, 100.0, 0.1]),
      ("COM Feet XY", 1, [6, 5.0, 0, 100.0, 0.1]),
      ("Facing Dir", 1, [6, 2.0, 0, 100.0, 0.1]),
      ("CoM Vel", 2, [0, 5.0, 0, 100.0]),
      ("Pelvis Seat", 3, [2, 10.0, 0, 50.0, 0.02]),
      ("Control", 21, [3, 0.05, 0, 1.0, 0.3]),
  ])
  spec.add_key(name="home",
               qpos=[0, 0, 1.282, 1, 0, 0, 0] + [0.0] * 21)
  return compile_model(spec)


def build_swimmer(nsegment: int = 5):
  """dm_control swimmer with the reference patch (swimmer.xml.patch:1-107):
  the installed swimmer.xml holds only the head, and the patch appends five
  segments and filter actuators; timestep 0.01, fluid density 1000,
  contacts off, joints +-90 degrees with stiffness 0.001 and solreflimit
  (0.05, 0.3), `general` actuators of gain 2e-3, dyntype filter, dynprm
  0.6; the target a mocap body."""
  import mujoco

  spec = load_spec("swimmer")
  spec.modelname = "Swimmer (dm_control)"
  spec.option.timestep = 0.01
  spec.option.density = 1000.0
  spec.option.integrator = mujoco.mjtIntegrator.mjINT_EULER
  strip_sensors(spec)
  for g in spec.geoms:
    g.contype, g.conaffinity = 0, 0

  dflt = spec.find_default("swimmer")
  dflt.joint.range = [-1.5707963, 1.5707963]
  dflt.joint.stiffness = [0.001, 0.0, 0.0]
  dflt.joint.solref_limit = [0.05, 0.3]

  head = spec.body("head")
  head.add_site(name="nose", pos=[0, -0.06, 0], size=[0.004, 0, 0])
  parent = head
  for i in range(nsegment):
    seg = parent.add_body(name=f"segment_{i}", pos=[0, 0.1, 0])
    seg.add_geom(spec.find_default("visual"), name=f"visual_{i}")
    seg.add_geom(spec.find_default("inertial"), name=f"inertial_{i}")
    seg.add_joint(dflt, name=f"joint_{i}")
    parent = seg

  for i in range(nsegment):
    a = spec.add_actuator(
        name=str(i), target=f"joint_{i}",
        trntype=mujoco.mjtTrn.mjTRN_JOINT,
        dyntype=mujoco.mjtDyn.mjDYN_FILTER,
        gaintype=mujoco.mjtGain.mjGAIN_FIXED,
        ctrllimited=mujoco.mjtLimited.mjLIMITED_TRUE,
        ctrlrange=[-1.0, 1.0])
    a.gainprm = [2e-3] + [0.0] * 9
    a.dynprm = [0.6] + [0.0] * 9

  spec.delete(spec.geom("target"))
  tgt = spec.worldbody.add_body(name="target", mocap=True,
                                pos=[0.3, 0.3, 0.05])
  tgt.add_geom(name="target", type=mujoco.mjtGeom.mjGEOM_SPHERE,
               size=[0.05, 0, 0], contype=0, conaffinity=0,
               rgba=[1, 0, 0, 0.5])

  add_numerics(spec, {
      "agent_planner": 0,
      "agent_horizon": 2.0,
      "agent_timestep": 0.01,
      "sampling_spline_points": 10,
      "sampling_trajectories": 128,
      "sampling_exploration": 0.5,
  })
  add_cost_sensors(spec, [
      ("Distance", 2, [2, 3.0, 0, 10.0, 0.04]),
      ("MoveToward", 1, [6, 2.0, 0, 10.0, 0.05]),
      ("Control", nsegment, [0, 0.001, 0, 1.0]),
  ])
  return compile_model(spec)
