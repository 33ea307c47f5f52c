"""The public names the port took over from the JAX package last, each held
against JAX's on the CPU (float64 where a value is compared):

- tasks/rubik.py: `make` builds "Rubik" (the hand) and `make_faces` "Rubik
  Faces" in both packages; the module-level `residual` is the hand's and
  `_faces_residual` the faces', each against JAX's on one stepped state
  per task, JAX's run on that one state (its hand residual fails on the
  tile view; ROADMAP queue 3), at atol 1e-12 (measured equal);
- Model.sensor_adr on the estimators' pendulum and on Humanoid Walk's
  cost sensors;
- Task.residual_size, Task.set_mode (the userdata's dtype, a new Data)
  and Task.get_mode (int32), and Humanoid Track's MODE_NAMES;
- ops/norms.py::num_norm_params for every NormType, physics/sensors.py::
  mat_tvec0 and sub_const0;
- planners/base.py::Planner (its methods and their parameters; where JAX
  takes `rng` the port takes `generator`) and PlanInfo's fields and
  defaults (trace_qpos None);
- tasks/registry.py::load_task_model_from_builder on dm_suite.
  build_humanoid(mode="stand") (Speed 0) and build_particle(fixed_goal=
  True), which both packages ignore.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.agent import agent as tagent
from mujoco_mpc_torch.estimators import sensor_model
from mujoco_mpc_torch.ops import norms as tnorms
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.physics import sensors as tsens
from mujoco_mpc_torch.physics import step as tstep
from mujoco_mpc_torch.physics.types import batch_trailing
from mujoco_mpc_torch.planners import base as tpbase
from mujoco_mpc_torch.tasks import base as tbase
from mujoco_mpc_torch.tasks import dm_suite as tdm
from mujoco_mpc_torch.tasks import humanoid_track as thtrack
from mujoco_mpc_torch.tasks import registry as treg
from mujoco_mpc_torch.tasks import rubik as trubik
from mujoco_mpc_tpu import physics as jphys
from mujoco_mpc_tpu.ops import norms as jnorms
from mujoco_mpc_tpu.physics import sensors as jsens
from mujoco_mpc_tpu.planners import base as jpbase
from mujoco_mpc_tpu.tasks import dm_suite as jdm
from mujoco_mpc_tpu.tasks import humanoid_track as jhtrack
from mujoco_mpc_tpu.tasks import registry as jreg
from mujoco_mpc_tpu.tasks import rubik as jrubik
from tests import models as tm
from tests import torch_engine_cases as cases
from tests import torch_flat_cases as fc
from tests.test_torch_transitions import _state, to_jax
from tests.torch_cases import RUBIK_TARGETS, one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

# (name, factory, the port's residual, JAX's residual, userdata)
RUBIKS = {
    "Rubik": (trubik.make, jrubik.make, trubik.residual, jrubik.residual,
              None),
    "Rubik Faces": (trubik.make_faces, jrubik.make_faces,
                    trubik._faces_residual, jrubik._faces_residual,
                    RUBIK_TARGETS),
}


@one_torch_thread()
@pytest.mark.parametrize("name", list(RUBIKS))
def test_rubik_factories_and_residuals_match_jax(name):
  make, jmake, res, jres, targets = RUBIKS[name]
  assert make(device="cpu").name == name == jmake().name
  assert treg.get_task(name, device="cpu").residual is res
  t, j = cases.pair(name)
  mp, mq, ud = fc.operands(name, t.model)
  if targets is not None:
    ud = trubik.faces_userdata(t.model.nuserdata, targets)
  d = fc.general_batch(t, tbase.probe_states(t.model, 1), (mp, mq, ud))
  rp = t.params.residual_params
  ours = res(t.model, batch_trailing(d), rp).numpy()[:, 0]
  theirs = np.asarray(jres(j.model, to_jax(_state(d, 0), j.model),
                           jnp.asarray(rp.numpy())))
  assert ours.shape == (t.spec.nresidual,) and np.all(np.isfinite(ours))
  np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-12)


def test_sensor_adr_matches_jax():
  pend = sensor_model.load(torch.float64, "cpu")
  jpend = jphys.load_model(tm.PENDULUM, dtype=jnp.float64)
  walk, jwalk = cases.pair("Humanoid Walk")
  for m, jm in ((pend, jpend), (walk.model, jwalk.model)):
    assert m.sensor_names == jm.sensor_names
    for name in m.sensor_names:
      assert m.sensor_adr(name) == jm.sensor_adr(name)
  assert walk.model.sensor_adr("Posture")[1] == 21
  with pytest.raises(KeyError):
    pend.sensor_adr("no such sensor")


def _home(t):
  """One forward-filled state of task t at its home keyframe."""
  d = tio.make_data(t.model)
  return tstep.forward(t.model, d.replace(qpos=torch.as_tensor(
      t.model.keyframe("home")[0], dtype=t.model.dtype)))


def test_task_mode_and_residual_size_match_jax():
  t, j = cases.pair("Quadruped Flat")
  assert t.residual_size() == j.residual_size() == t.spec.nresidual
  d = _home(t)
  jd = to_jax(d, j.model)
  for mode in (2, 3.0):
    ours, theirs = t.set_mode(d, mode), j.set_mode(jd, mode)
    assert ours is not d and ours.userdata.dtype == d.userdata.dtype
    np.testing.assert_array_equal(ours.userdata.numpy(),
                                  np.asarray(theirs.userdata))
    got, want = t.get_mode(ours), j.get_mode(theirs)
    assert got.dtype == torch.int32 and want.dtype == jnp.int32
    assert int(got) == int(want) == int(mode)
  assert d.userdata[tbase.MODE_SLOT] == 0.0  # set_mode made a new Data
  assert thtrack.MODE_NAMES == jhtrack.MODE_NAMES


def test_norm_params_and_sensor_helpers_match_jax():
  assert [n.name for n in tnorms.NormType] == [
      n.name for n in jnorms.NormType]
  for n in tnorms.NormType:
    assert tnorms.num_norm_params(n) == jnorms.num_norm_params(int(n))
  rng = np.random.RandomState(5)
  mat, v, c = rng.randn(3, 3, 4), rng.randn(3, 4), rng.randn(3)
  np.testing.assert_allclose(
      tsens.mat_tvec0(torch.tensor(mat), torch.tensor(v)).numpy(),
      jsens.mat_tvec0(jnp.asarray(mat), jnp.asarray(v)), rtol=0,
      atol=1e-14)
  want = np.asarray(jsens.sub_const0(jnp.asarray(v), c))
  for const in (c, tuple(c), torch.tensor(c)):
    np.testing.assert_allclose(
        tsens.sub_const0(torch.tensor(v), const).numpy(), want, rtol=0,
        atol=1e-15)
  np.testing.assert_allclose(
      np.asarray(jsens.sub_const0(jnp.asarray(v), jnp.asarray(c))), want,
      rtol=0, atol=1e-15)


def test_planner_protocol_and_plan_info_match_jax():
  assert tpbase.PlanInfo._fields == jpbase.PlanInfo._fields
  assert tpbase.PlanInfo._field_defaults == {"trace_qpos": None} == \
      jpbase.PlanInfo._field_defaults
  info = tpbase.PlanInfo(torch.zeros(2), torch.tensor(0), torch.tensor(0.))
  assert info.trace_qpos is None
  for method in ("init", "optimize", "action"):
    ours = list(inspect.signature(getattr(tpbase.Planner, method)).parameters)
    theirs = list(inspect.signature(getattr(jpbase.Planner,
                                            method)).parameters)
    assert ours == [("generator" if p == "rng" else p) for p in theirs]
  for factory in tagent._PLANNERS.values():
    planner = factory(treg.get_task("Particle", device="cpu"), 10)
    for method in ("init", "optimize", "action"):
      assert callable(getattr(planner, method))


@pytest.mark.parametrize("build", ["humanoid_stand", "particle_fixed"])
def test_builders_match_jax(build):
  if build == "humanoid_stand":
    ours = treg.load_task_model_from_builder(
        lambda: tdm.build_humanoid(mode="stand"), torch.float64, "cpu")
    theirs = jreg.load_task_model_from_builder(
        lambda: jdm.build_humanoid(mode="stand"), jnp.float64)
    walk = treg.load_task_model_from_builder(tdm.build_humanoid,
                                             torch.float64, "cpu")
    speed = ours[3].index("residual_Speed")
    assert ours[2].residual_params[speed] == 0.0
    assert walk[2].residual_params[speed] == 1.0
  else:
    ours = treg.load_task_model_from_builder(
        lambda: tdm.build_particle(fixed_goal=True), torch.float64, "cpu")
    theirs = jreg.load_task_model_from_builder(
        lambda: jdm.build_particle(fixed_goal=True), jnp.float64)
    plain = treg.load_task_model_from_builder(tdm.build_particle,
                                              torch.float64, "cpu")
    np.testing.assert_array_equal(ours[0].body_pos.numpy(),
                                  plain[0].body_pos.numpy())
    assert ours[3] == plain[3]
  assert ours[3] == tuple(theirs[3])
  np.testing.assert_array_equal(ours[2].residual_params.numpy(),
                                np.asarray(theirs[2].residual_params))
  np.testing.assert_array_equal(ours[0].body_mass.numpy(),
                                np.asarray(theirs[0].body_mass))
