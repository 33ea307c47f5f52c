"""What the general engine's parity tests rest on, with no JAX run: the
step tests' models cover the RK4 integrator, a free joint and a ball joint
(tests/torch_engine_cases.py), and a model with a mesh or heightfield pair,
which the port's collide does not take yet, raises rather than stepping
without it."""

import mujoco
import pytest
import torch

from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.physics import step as tstep
from mujoco_mpc_torch.physics.types import JointType
from tests import torch_engine_cases as cases


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
  mj = mujoco.MjModel.from_xml_string(MESH_XML.format(kind=kind, attr=attr))
  tm = tio.from_mjmodel(mj, dtype=torch.float64, device="cpu")
  assert tm.collision_pairs
  with pytest.raises(NotImplementedError, match="queue 1 item 4"):
    tstep.step(tm, tio.make_data(tm))
