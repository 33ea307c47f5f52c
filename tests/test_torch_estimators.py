"""The estimator layer against the JAX package in float64 on the CPU:
measurement_slice and pack_state, the band solver (ops/band.py), and the
ground-truth, Kalman, Unscented and Batch estimators over the same control
and sensor sequence from the same state.

The models are tests/models.py's pendulum (a hinge, real sensors) and free
body (a free joint: the quaternion paths); each JAX update is jitted once.
On the free body the JAX Kalman filter's and direct optimizer's Jacobians
lose the rotation columns (its retraction is constant below a rotation of
1e-12, so it has no derivative at zero), so there the port's C and A are
held against central differences of the port's own measurement and step
(both held against JAX in tests/test_torch_step.py), and the Kalman and
Batch updates against JAX on the pendulum alone.

Tolerances, with the errors measured when they were set:
  measurement_slice: equal; pack_state atol 1e-12 (measured 2.8e-17);
    the pendulum snapshot that chip_smoke.py measures: equal to a fresh
    build of this MJCF;
  band.factor, band.solve against JAX's and against a dense solve, and
    assemble_from_stencils and scatter_grad against JAX's: 1e-12 of the
    largest entry (measured 1.1e-15);
  5 updates of each estimator: the state (qpos, qvel; Batch's window) and
    the covariance within 1e-9 of their largest entry (measured 1.5e-15
    ground truth, 4.8e-14 Kalman, 2.8e-14 Unscented, 1.7e-12 Batch);
  the free body's C and A against central differences (eps 1e-6): atol
    1e-7 (measured 1.4e-10); its predicted measurement against forward's:
    atol 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch import convert
from mujoco_mpc_torch.estimators import base, get_estimator
from mujoco_mpc_torch.estimators import kalman as tkalman
from mujoco_mpc_torch.estimators import sensor_model
from mujoco_mpc_torch.ops import band
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.physics import step as tstep
from mujoco_mpc_tpu import physics as jphys
from mujoco_mpc_tpu.estimators import base as jbase
from mujoco_mpc_tpu.estimators import get_estimator as jget_estimator
from mujoco_mpc_tpu.ops import band as jband
from tests import models as tm
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import np_tree
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

K = 5  # updates per estimator

# the estimator slice's custom numerics: sensors 1 and 2 of the pendulum
# (its speed and tip position)
PENDULUM_SLICE = tm.PENDULUM.replace(
    "<worldbody>", '<custom><numeric name="estimator_sensor_start" '
    'data="1"/><numeric name="estimator_number_sensor" data="2"/>'
    "</custom>\n  <worldbody>", 1)


def _pair(xml):
  jm = jphys.load_model(xml, dtype=jnp.float64)
  return convert.model(np_tree(jm), "cpu"), jm


@pytest.fixture(scope="module")
def models():
  return {name: _pair(getattr(tm, name)) for name in ("PENDULUM",
                                                       "FREEBODY")}


def rel_err(got, want) -> float:
  got, want = np.asarray(got), np.asarray(want)
  return float(np.max(np.abs(got - want)) /
               max(np.max(np.abs(want)), 1e-300))


def _start(m, jm, seed=0):
  """A state near qpos0 (unit quaternion), a nonzero velocity, and K
  controls and noisy sensordata vectors (numpy)."""
  rng = np.random.RandomState(seed)
  q = np.asarray(jm.qpos0) + 0.1 * rng.randn(jm.nq)
  if jm.nq == 7:
    q[3:7] /= np.linalg.norm(q[3:7])
  v = 0.3 * rng.randn(jm.nv)
  jd = jphys.make_data(jm).replace(qpos=jnp.asarray(q), qvel=jnp.asarray(v))
  td = tio.make_data(m).replace(qpos=torch.tensor(q), qvel=torch.tensor(v))
  ctrls = rng.uniform(-0.5, 0.5, (K, jm.nu))
  sensors = 0.01 * rng.randn(K, jm.nsensordata)
  return td, jd, ctrls, sensors


def _same_fields(a, b) -> bool:
  """Dataclasses equal field by field, tensors by value."""
  if isinstance(a, torch.Tensor):
    return torch.equal(a, b)
  if dataclasses.is_dataclass(a):
    return all(_same_fields(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))
  return a == b


def test_measurement_slice_and_pack_state(models):
  for xml in (tm.PENDULUM, tm.FREEBODY, tm.CARTPOLE, PENDULUM_SLICE):
    m, jm = _pair(xml)
    assert base.measurement_slice(m) == jbase.measurement_slice(jm)
  m, jm = _pair(PENDULUM_SLICE)
  assert base.measurement_slice(m) == (1, 4)  # speed, then tip_pos
  # the port's pendulum snapshot (estimators/sensor_model.py) is this
  # MJCF's fresh build, every sensor measured
  assert sensor_model.PENDULUM_XML == tm.PENDULUM
  snap, fresh = sensor_model.load(torch.float64, "cpu"), sensor_model.build()
  assert _same_fields(snap, fresh)
  assert base.measurement_slice(snap) == (0, 8)
  m, jm = models["FREEBODY"]
  td, jd, _, _ = _start(m, jm)
  dx = np.random.RandomState(1).uniform(-0.4, 0.4, (6, 12))
  got = base.pack_state(m, td.qpos, td.qvel, td.act, torch.tensor(dx))
  want = jax.vmap(lambda x: jbase.pack_state(jm, jd.qpos, jd.qvel, jd.act,
                                             x))(jnp.asarray(dx))
  for g, w in zip(got[:2], want[:2]):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)


def _band_system(T, n, seed):
  """Random stencil Jacobians' band blocks (SPD after a diagonal shift),
  in both packages, and the dense matrix."""
  rng = np.random.RandomState(seed)
  jac = rng.randn(T - 2, 2 * n, 3 * n)
  jtj = np.einsum("tri,trj->tij", jac, jac)
  got = band.assemble_from_stencils(torch.tensor(jtj), T)
  want = jband.assemble_from_stencils(jnp.asarray(jtj), T)
  for g, w in zip(got, want):
    assert rel_err(g.numpy(), w) <= 1e-12
  diag, off1, off2 = (x.numpy() for x in got)
  diag = diag + 0.5 * np.eye(n)
  dense = np.zeros((T * n, T * n))
  for t in range(T):
    dense[t * n:(t + 1) * n, t * n:(t + 1) * n] = diag[t]
    for k, off in ((1, off1), (2, off2)):
      if t >= k:
        dense[t * n:(t + 1) * n, (t - k) * n:(t - k + 1) * n] = off[t]
        dense[(t - k) * n:(t - k + 1) * n, t * n:(t + 1) * n] = off[t].T
  return (diag, off1, off2), dense


@pytest.mark.parametrize("k", [None, 5])
def test_band_matches_jax_and_dense(k):
  T, n = 9, 4
  blocks, dense = _band_system(T, n, seed=0 if k is None else 3)
  rng = np.random.RandomState(1)
  b = rng.randn(T, n) if k is None else rng.randn(T, n, k)
  f = band.factor(*(torch.tensor(x) for x in blocks))
  jf = jband.factor(*(jnp.asarray(x) for x in blocks))
  for g, w in zip(f, jf):
    assert rel_err(g.numpy(), w) <= 1e-12
  x = band.solve(f, torch.tensor(b)).numpy()
  assert rel_err(x, jband.solve(jf, jnp.asarray(b))) <= 1e-12
  want = torch.linalg.solve(torch.tensor(dense),
                            torch.tensor(b.reshape(T * n, -1))).numpy()
  assert rel_err(x.reshape(T * n, -1), want) <= 1e-12
  jtr = rng.randn(T - 2, 3 * n)
  assert rel_err(band.scatter_grad(torch.tensor(jtr), T).numpy(),
                 jband.scatter_grad(jnp.asarray(jtr), T)) <= 1e-12


CASES = [("PENDULUM", "ground_truth"), ("PENDULUM", "kalman"),
         ("PENDULUM", "unscented"), ("PENDULUM", "batch"),
         ("FREEBODY", "ground_truth"), ("FREEBODY", "unscented")]


@pytest.mark.parametrize("model,name", CASES)
@one_torch_thread()
def test_estimator_updates_match_jax(models, model, name):
  m, jm = models[model]
  td, jd, ctrls, sensors = _start(m, jm)
  kw = {"window": 8, "max_iterations": 2} if name == "batch" else {}
  ours, theirs = get_estimator(name, m, **kw), jget_estimator(name, jm, **kw)
  init = {"kalman": {"p0": 0.05}, "unscented": {"p0": 0.05}}.get(name, {})
  jstate = theirs.init(jd, **init)
  # the port starts from JAX's state, carried over
  state = {"kalman": lambda: convert.kalman_state(np_tree(jstate), "cpu"),
           "unscented": lambda: convert.unscented_state(np_tree(jstate),
                                                        "cpu"),
           "batch": lambda: convert.batch_state(np_tree(jstate), "cpu"),
           "ground_truth": lambda: ours.init(td)}[name]()
  update = jax.jit(theirs.update)
  for k in range(K):
    state = ours.update(state, torch.tensor(ctrls[k]),
                        torch.tensor(sensors[k]))
    jstate = update(jstate, jnp.asarray(ctrls[k]), jnp.asarray(sensors[k]))
  for g, w in zip(ours.state(state)[:2], theirs.state(jstate)[:2]):
    assert rel_err(g.numpy(), w) <= 1e-9
  if name == "batch":
    assert rel_err(state.qpos.numpy(), jstate.qpos) <= 1e-9
  if hasattr(state, "cov"):
    assert rel_err(state.cov.numpy(), jstate.cov) <= 1e-9
    np.testing.assert_allclose(float(state.data.time),
                               float(jstate.data.time), rtol=1e-12)


def _central(fn, n, eps=1e-6):
  """Central differences of fn(dx (b, n)) -> (b, k) at 0: all 2n
  displaced states in one batch."""
  e = eps * torch.eye(n, dtype=torch.float64)
  out = fn(torch.cat([e, -e]))
  return ((out[:n] - out[n:]) / (2 * eps)).T


@one_torch_thread()
def test_freebody_kalman_jacobians(models):
  m, jm = models["FREEBODY"]
  td, jd, _, _ = _start(m, jm)
  filt = tkalman.Kalman(m)
  nt, nv = base.tangent_dim(m), m.nv
  u = torch.zeros(0, dtype=torch.float64)
  y, cmat = filt.measurement_jacobian(td)
  ref, amat = filt.transition_jacobian(td, u)

  def meas(dx):
    return tstep.forward(m, base.perturbed(m, td, dx)).sensordata

  def trans(dx):
    d2 = tstep.step(m, base.perturbed(m, td, dx, ctrl=u))
    return torch.cat([base.local_diff(m, d2.qpos, ref.qpos),
                      d2.qvel - ref.qvel], dim=-1)

  np.testing.assert_allclose(cmat.numpy(), _central(meas, nt).numpy(),
                             rtol=0, atol=1e-7)
  np.testing.assert_allclose(amat.numpy(), _central(trans, nt).numpy(),
                             rtol=0, atol=1e-7)
  np.testing.assert_allclose(y.numpy(), tstep.forward(m, td).sensordata,
                             rtol=0, atol=1e-12)

  # the rotation columns (tangent 3:6), which JAX's C lacks
  assert np.abs(cmat.numpy()[:, 3:6]).max() > 0.1
  assert nt == 2 * nv
