"""The port's mesh and heightfield pairs against the JAX package's, in
float64 on the CPU: each pair function on the same world-frame poses
(random ones, and an axis-aligned one where hull vertices tie in depth,
so the contact set itself must be JAX's), a heightfield point at the
field's far edge in float32, and one general step each of Bimanual
Insert and Quadruped Hill on states where every new pair kind carries
force. JAX runs eagerly, its step jitted once per model. Where
the two packages pick different hull vertices that tie in depth only up
to rounding (a hull face square to the contact axis), the positions are
held along the normal and the substitutions counted (printed with -s).

The module holds no float32 tile step. Measured on a CPU host: the mesh
pairs within 5.6e-17 of TOL; the heightfield pairs 8.9e-16 of TOL in
float64 and 4.8e-7 of 2e-6 in float32 (the box); the steps' qpos 8.9e-16
and qvel 3.3e-13 of 1e-10, each pair kind's summed forces 1.3e-11 where
1e-8 of the largest is 3.2e-6."""

import functools
import types

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.ops import rollout as trollout
from mujoco_mpc_torch.physics import collision as tcol
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.physics import step as tstep
from mujoco_mpc_torch.physics.types import GeomType
from mujoco_mpc_torch.tasks import registry as tregistry
from mujoco_mpc_tpu.physics import collision as jcol
from mujoco_mpc_tpu.physics import io as jio
from mujoco_mpc_tpu.physics.step import step as jax_step
from mujoco_mpc_tpu.tasks import registry as jregistry
from tests import torch_mesh_cases as cases
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

jax.config.update("jax_enable_x64", True)

TOL = 1e-12


def _models(xml):
  mj = mujoco.MjModel.from_xml_string(xml)
  return (jio.from_mjmodel(mj, dtype=jnp.float64),
          tio.from_mjmodel(mj, dtype=torch.float64, device="cpu"))


def _hold(port_pts, jax_pts, b, exact):
  """Pose b of the port's batched points against JAX's list: distances
  and normals to TOL; positions to TOL, or, where the two picked
  different hull vertices that tie in depth along the normal up to
  rounding (a face square to the axis: JAX's pick follows its matmul's
  rounding, the port's is the lowest index), to TOL along the normal.
  With `exact` (ties exact in both) the positions must match. Returns
  the count of tied substitutions."""
  assert len(port_pts) == len(jax_pts)
  swaps = 0
  for (pd, pp, pn), (jd, jp, jn) in zip(port_pts, jax_pts):
    jd, jp, jn = np.asarray(jd), np.asarray(jp), np.asarray(jn)
    np.testing.assert_allclose(pd[b].numpy(), jd, rtol=0, atol=TOL)
    np.testing.assert_allclose(pn[b].numpy(), jn, rtol=0, atol=TOL)
    gap = pp[b].numpy() - jp
    if exact or np.abs(gap).max() <= TOL:
      np.testing.assert_allclose(gap, 0.0, rtol=0, atol=TOL)
    else:
      assert abs(gap @ jn) <= TOL, gap @ jn
      swaps += 1
  return swaps


@pytest.mark.parametrize("kind", ["plane", "sphere", "capsule", "box",
                                  "mesh"])
def test_mesh_pair_matches_jax(kind):
  jm, tm = _models(cases.MESH_PAIRS_XML)
  g1 = tm.geom({"plane": "floor", "mesh": "female"}.get(kind, kind))
  g2 = tm.geom("male")
  pos, mat = cases.pair_poses(kind, b=12, seed=3)
  fn = tcol._pair_fn(GeomType(tm.geom_type[g1]), GeomType(tm.geom_type[g2]))
  arrays = tcol._group_arrays(tm, fn, [g1], [g2], torch.float64)
  size = tm.geom_size
  pts = fn(torch.as_tensor(pos[:, 0:1]), torch.as_tensor(mat[:, 0:1]),
           torch.as_tensor(pos[:, 1:2]), torch.as_tensor(mat[:, 1:2]),
           size[[g1]], size[[g2]], **arrays)
  pts = [(d[:, 0], p[:, 0], n[:, 0]) for d, p, n in pts]
  assert len(pts) == tcol._MESH_COUNTS[GeomType(tm.geom_type[g1])]
  jfn = jcol._MESH_DISPATCH[GeomType(tm.geom_type[g1])]
  swaps = 0
  for b in range(pos.shape[0]):
    xpos = np.zeros((tm.ngeom, 3))
    xmat = np.tile(np.eye(3), (tm.ngeom, 1, 1))
    xpos[[g1, g2]], xmat[[g1, g2]] = pos[b], mat[b]
    d = types.SimpleNamespace(geom_xpos=jnp.asarray(xpos),
                              geom_xmat=jnp.asarray(xmat))
    # pose 0 is axis aligned: its hull vertices tie exactly, and the
    # points chosen must be JAX's, not just as deep
    swaps += _hold(pts, jfn(jm, d, g1, g2), b, exact=b == 0)
  print(f"{kind}-mesh: {swaps} tied substitutions of "
        f"{len(pts) * pos.shape[0]} points")


@pytest.mark.parametrize("kind", ["sphere", "capsule", "box"])
def test_hfield_pair_matches_jax(kind):
  """On Quadruped Hill's 64x64 field, the field turned and moved, and a
  geom over its far corner in float32 (the clip bound rounds to 63 there,
  so the gathered neighbour is clamped as JAX clamps it)."""
  for dtype, jdtype, tol in ((torch.float64, jnp.float64, TOL),
                             (torch.float32, jnp.float32, 2e-6)):
    jm = _jax_model("Quadruped Hill", jdtype)
    tm = tregistry.get_task("Quadruped Hill", dtype=dtype,
                            device="cpu").model
    np.testing.assert_array_equal(tm.hfield_data.numpy(),
                                  np.asarray(jm.hfield_data))
    hp, hm, pos, mat, size = cases.hfield_poses(kind, b=10, seed=5)
    fn = tcol._HFIELD_DISPATCH[GeomType[kind.upper()]]
    arrays = tcol._group_arrays(tm, fn, [0], [1], dtype)
    t = lambda x: torch.as_tensor(x, dtype=dtype)  # noqa: E731
    pts = fn(t(hp), t(hm), t(pos), t(mat), t(np.zeros(3)), t(size),
             **arrays)
    jfn = jcol._HFIELD_DISPATCH[GeomType[kind.upper()]]
    for b in range(pos.shape[0]):
      j = jfn(jm, jnp.asarray(hp[b], jdtype), jnp.asarray(hm[b], jdtype),
              jnp.asarray(pos[b], jdtype), jnp.asarray(mat[b], jdtype),
              jnp.asarray(size, jdtype))
      for (pd, pp, pn), (jd, jp, jn) in zip(pts, j):
        for x, y in ((pd, jd), (pp, jp), (pn, jn)):
          assert torch.isfinite(x[b]).all()
          np.testing.assert_allclose(x[b].numpy(), np.asarray(y), rtol=0,
                                     atol=tol)


@functools.lru_cache(maxsize=None)
def _jax_model(name, dtype):
  return jregistry.get_task(name, dtype=dtype).model


@pytest.mark.parametrize("name", ["Bimanual Insert", "Quadruped Hill"])
def test_step_matches_jax(name):
  """One general step of each task on probe states where every new pair
  kind carries force (tests/torch_mesh_cases.py), held against JAX's
  step (jitted once, a state at a time): qpos and qvel to 1e-10, each
  pair kind's contact forces summed over its points to 1e-8 of its
  largest (a point's own force moves with the tied vertex each package
  picks)."""
  tm = tregistry.get_task(name, dtype=torch.float64, device="cpu").model
  jm = _jax_model(name, jnp.float64)
  states = cases.probe_states(name, tm, 8 if name == "Bimanual Insert"
                              else 4)
  d0 = trollout.broadcast(tio.make_data(tm), (states["qpos"].shape[0],))
  dt = tstep.step(tm, d0.replace(
      **{k: torch.as_tensor(v) for k, v in states.items()}))
  assert cases.active_kinds(tm, dt) == cases.NEW_KINDS[name]
  step = jax.jit(jax_step)
  d0 = jio.make_data(jm)
  dj = [step(jm, d0.replace(**{k: jnp.asarray(v[i])
                               for k, v in states.items()}))
        for i in range(states["qpos"].shape[0])]
  np.testing.assert_allclose(dt.qpos.numpy(), np.stack(
      [np.asarray(x.qpos) for x in dj]), rtol=0, atol=1e-10)
  np.testing.assert_allclose(dt.qvel.numpy(), np.stack(
      [np.asarray(x.qvel) for x in dj]), rtol=0, atol=1e-10)
  ft = cases.force_by_kind(tm, dt.contact)
  fj = cases.force_by_kind(tm, types.SimpleNamespace(force=torch.as_tensor(
      np.stack([np.asarray(x.contact.force) for x in dj]))))
  for k in ft:  # summed over each kind's points, per state
    scale = max(1.0, float(np.abs(fj[k]).max()))
    np.testing.assert_allclose(ft[k].sum(-2), fj[k].sum(-2), rtol=0,
                               atol=1e-8 * scale, err_msg=k)
