"""What the general engine's parity tests rest on: the step tests' models
cover the RK4 integrator, a free joint and a ball joint
(tests/torch_engine_cases.py), and a model with a mesh or heightfield pair
steps as JAX's does (a sphere dropped on a tetrahedron hull or on a 3x3
field; JAX's step jitted once)."""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.physics import step as tstep
from mujoco_mpc_torch.physics.types import JointType
from mujoco_mpc_tpu.physics import io as jio
from mujoco_mpc_tpu.physics.step import step as jax_step
from tests import torch_engine_cases as cases
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

jax.config.update("jax_enable_x64", True)


def test_models_cover_rk4_free_and_ball_joints():
  kinds = {}
  for name, build in cases.STEP_MODELS.items():
    m = tio.from_mjmodel(build(), dtype=torch.float64, device="cpu")
    kinds[name] = (m.opt.integrator, set(m.jnt_type))
  assert kinds["pendulum_rk4"][0] == 1
  assert JointType.FREE in kinds["box_on_plane"][1]
  assert JointType.BALL in kinds["ball_chain"][1]


MESH_XML = """
<mujoco>
  <asset>
    <mesh name="tet" vertex="0 0 0  0.1 0 0  0 0.1 0  0 0 0.1"/>
    <hfield name="ground" nrow="3" ncol="3" size="1 1 0.1 0.1"/>
  </asset>
  <worldbody>
    <geom type="{kind}" {attr}/>
    <body pos="0 0 0.05"><freejoint/><geom type="sphere" size="0.1"/></body>
  </worldbody>
</mujoco>
"""


@pytest.mark.parametrize("kind,attr", [("mesh", 'mesh="tet"'),
                                       ("hfield", 'hfield="ground"')])
def test_mesh_and_heightfield_pairs_raise(kind, attr):
  """Once these pairs raised NotImplementedError; now three steps of the
  sphere, pressed into the tetrahedron's hull or onto the field, equal
  JAX's: qpos and qvel to 1e-10, the contact forces to 1e-8."""
  mj = mujoco.MjModel.from_xml_string(MESH_XML.format(kind=kind, attr=attr))
  tm = tio.from_mjmodel(mj, dtype=torch.float64, device="cpu")
  jm = jio.from_mjmodel(mj, dtype=jnp.float64)
  assert tm.collision_pairs
  q = np.asarray(tm.qpos0, np.float64).copy()
  q[:3] = (0.02, 0.03, 0.15 if kind == "mesh" else 0.095)
  dt = tio.make_data(tm).replace(qpos=torch.as_tensor(q))
  dj = jio.make_data(jm).replace(qpos=jnp.asarray(q))
  step = jax.jit(jax_step)
  for _ in range(3):
    dt, dj = tstep.step(tm, dt), step(jm, dj)
    np.testing.assert_allclose(dt.qpos.numpy(), np.asarray(dj.qpos),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(dt.qvel.numpy(), np.asarray(dj.qvel),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(dt.contact.force.numpy(),
                               np.asarray(dj.contact.force), rtol=0,
                               atol=1e-8)
  assert float(dt.contact.force.abs().max()) > 0  # the pair carries force
