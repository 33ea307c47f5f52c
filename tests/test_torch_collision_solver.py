"""The general engine's collision and constraint solve held against the
JAX package in float64 on the CPU.

The models (tests/torch_engine_cases.py): `PAIRS_XML`, free bodies of
every primitive geom type on a plane and into each other, 13 candidate
pairs covering every primitive pair kind of physics/collision.py, with
condim 1, 3, 4 and 6 geoms, a limited hinge and a connect equality: its
100-odd rows take the matrix-free solve. The oracle tests' box on a plane
(24 rows) takes the dense one. Each is held cold and warm-started (a
second forward from the first one's duals); rows compare class by class
in the layout both packages share.

Tolerances, with the errors measured when they were set:
  contact points (dist, pos, frame), every point: atol 1e-12 (measured
    2e-16);
  forces per row class (normal, friction, torsional, rolling, limit,
    equality), qfrc_constraint and the contact forces: rtol 1e-9, atol
    1e-9 times the largest force (measured 3e-13 relative).
"""

import importlib

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu import physics as jphys
from mujoco_mpc_torch.physics import collision as tcol
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.physics import solver as tsolver
from mujoco_mpc_torch.physics import step as tstep
from mujoco_mpc_torch.physics.types import GeomType
from tests import models as oracle_models
from tests import torch_engine_cases as cases
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

jstep = importlib.import_module("mujoco_mpc_tpu.physics.step")
jcol = importlib.import_module("mujoco_mpc_tpu.physics.collision")
jsolver = importlib.import_module("mujoco_mpc_tpu.physics.solver")


@pytest.fixture(scope="module",
                params=list(cases.COLLISION_MODELS))
def case(request):
  """(name, torch model, [cold, warm] port forwards, the same of JAX as
  numpy, the JAX model)."""
  mj = mujoco.MjModel.from_xml_string(
      cases.COLLISION_MODELS[request.param])
  rng = np.random.RandomState(1)
  qvel = rng.uniform(-0.3, 0.3, mj.nv)
  jm = jphys.from_mjmodel(mj, dtype=jnp.float64)
  tm = tio.from_mjmodel(mj, dtype=torch.float64, device="cpu")
  fwd = jax.jit(jstep.forward)
  qpos = mj.qpos0.copy()
  if request.param == "box_on_plane":
    qpos[2] = 0.055  # 5 mm into the plane
  jd = jphys.make_data(jm).replace(qpos=jnp.asarray(qpos),
                                   qvel=jnp.asarray(qvel))
  td = tio.make_data(tm).replace(qpos=torch.tensor(qpos),
                                 qvel=torch.tensor(qvel))
  ours, theirs = [], []
  for _ in range(2):  # cold, then warm-started from the first duals
    jd = fwd(jm, jd)
    td = tstep.forward(tm, td)
    theirs.append(jax.tree_util.tree_map(np.asarray, jd))
    ours.append(td)
  return request.param, tm, ours, theirs, jm


def test_pair_kinds_cover_the_primitives():
  tm = tio.from_mjmodel(mujoco.MjModel.from_xml_string(cases.PAIRS_XML),
                        dtype=torch.float64, device="cpu")
  kinds = {(GeomType(tm.geom_type[a]), GeomType(tm.geom_type[b]))
           for a, b in tm.collision_pairs}
  assert cases.KINDS <= kinds, cases.KINDS - kinds
  assert set(tcol.point_condims(tm)) == {1, 3, 4, 6}
  assert not tsolver.amat_is_dense(tsolver.nrow_static(tm))
  small = tio.from_mjmodel(
      mujoco.MjModel.from_xml_string(oracle_models.BOX_ON_PLANE),
      dtype=torch.float64, device="cpu")
  assert tsolver.amat_is_dense(tsolver.nrow_static(small))


def test_contact_points_match_jax(case):
  name, tm, ours, theirs, jm = case
  assert tcol.pair_slots(tm) == jcol.pair_slots(jm)
  assert tcol.angular_points(tm) == jcol.angular_points(jm)
  assert tsolver.nrow_static(tm) == jsolver.nrow_static(jm)
  for o, t in zip(ours, theirs):
    for f in ("dist", "pos", "frame", "friction", "torsion", "roll",
              "solref", "solimp", "geom1", "geom2"):
      np.testing.assert_allclose(getattr(o.contact, f).numpy(),
                                 getattr(t.contact, f), atol=1e-12,
                                 err_msg=f"{name} {f}")
  assert (ours[0].contact.dist < 0).sum() >= (8 if name == "pairs" else 4)


def test_forces_per_row_class_match_jax(case):
  name, tm, ours, theirs, _ = case
  classes = cases.row_classes(tm)
  for step, (o, t) in enumerate(zip(ours, theirs)):
    scale = float(np.abs(t.efc_lambda).max())
    assert scale > 0.1, name
    lam = o.efc_lambda.numpy()
    for c in dict.fromkeys(classes):
      sel = classes == c
      np.testing.assert_allclose(lam[sel], t.efc_lambda[sel], rtol=1e-9,
                                 atol=1e-9 * scale,
                                 err_msg=f"{name} step {step} {c} rows")
    for f in ("qfrc_constraint", "qacc"):
      np.testing.assert_allclose(getattr(o, f).numpy(), getattr(t, f),
                                 rtol=1e-9, atol=1e-9 * scale,
                                 err_msg=f"{name} {f}")
    np.testing.assert_allclose(o.contact.force.numpy(), t.contact.force,
                               rtol=1e-9, atol=1e-9 * scale)
  if name == "pairs":
    lam = ours[1].efc_lambda.numpy()
    for c in ("normal", "friction", "torsional", "rolling", "equality"):
      assert np.abs(lam[classes == c]).max() > 0, c
