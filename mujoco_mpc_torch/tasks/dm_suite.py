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
