"""The direct optimizer (estimators/direct.py) in float64 on the CPU:
optimize through the band solver against the dense fallback, and with
dof_damping and body_mass parameters (the arrowhead system) against the
JAX package (jitted once), from a noisy trajectory of tests/models.py's
pendulum; the parameter plug-ins' model fields against JAX's; and on the
free body (a free joint), the stencil Jacobians against central
differences of the port's own residual (JAX's lose the rotation
columns: tests/test_torch_estimators.py). The band path without
parameters is held against JAX through the Batch estimator
(tests/test_torch_estimators.py).

Tolerances, with the errors measured when they were set:
  optimize, band against dense: qpos atol 1e-10 (measured 1.7e-12), the
    costs within 1e-9 of cost_initial (the optimum's cost is 1.6e-10 of
    the start's; measured 6.0e-20), cost_initial equal;
  optimize with parameters: qpos atol 1e-10 (measured 9.4e-13), the cost
    within 1e-9 of cost_initial (measured 2.9e-18), the parameters rtol
    1e-6 (measured 4.5e-8: the Schur complement on theta is ill-
    conditioned, its prior weighing 1e-6; the stencil Jacobians agree
    exactly and one step's dtheta to 4.1e-10);
  each ParameterSpec.apply's fields: atol 1e-15 (measured 0), the engine
    constants shared with the optimizer's Model;
  the free body's stencil Jacobians against central differences (eps
    1e-6): 1e-6 of the largest entry (measured 1.4e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch import convert
from mujoco_mpc_torch.estimators import base
from mujoco_mpc_torch.estimators import direct as tdirect
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.physics import step as tstep
from mujoco_mpc_tpu import physics as jphys
from mujoco_mpc_tpu.estimators import direct as jdirect
from tests import models as tm
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import np_tree
from tests.torch_engine_cases import release_jax_executables  # noqa: F401


@pytest.fixture(scope="module")
def pendulum():
  jm = jphys.load_model(tm.PENDULUM, dtype=jnp.float64)
  return convert.model(np_tree(jm), "cpu"), jm


def _trajectory(m, T, seed=0, noise=0.04):
  """A simulated pendulum trajectory under sinusoidal controls (the port's
  step), its sensordata with noise, and its configurations with noise:
  (qpos (T, nq), sensors (T, ns), ctrls (T, nu)), numpy."""
  rng = np.random.RandomState(seed)
  d = tio.make_data(m)
  d = d.replace(qpos=d.qpos + 0.1)
  qs, ys, us = [], [], []
  for t in range(T):
    u = torch.full((m.nu,), 0.5 * np.sin(0.05 * t), dtype=torch.float64)
    d = tstep.step(m, d.replace(ctrl=u))
    ys.append(tstep.forward(m, d).sensordata.numpy() +
              rng.normal(0, 1e-3, m.nsensordata))
    qs.append(d.qpos.numpy())
    us.append(u.numpy())
  qs = np.asarray(qs)
  return qs + rng.normal(0, noise, qs.shape), np.asarray(ys), np.asarray(us)


def _run(ours, theirs, args, params_init=None):
  got = ours.optimize(*(torch.tensor(a) for a in args),
                      params_init=params_init and torch.tensor(params_init))
  want = jax.jit(theirs.optimize)(
      *(jnp.asarray(a) for a in args),
      params_init=params_init and jnp.asarray(params_init))
  return got, want


@one_torch_thread()
def test_direct_band_matches_dense(pendulum):
  m, _ = pendulum
  T = 12
  args = [torch.tensor(a) for a in _trajectory(m, T)]
  cfg = dict(horizon=T, max_iterations=4)
  band = tdirect.Direct(m, tdirect.DirectConfig(**cfg)).optimize(*args)
  dense = tdirect.Direct(m, tdirect.DirectConfig(**cfg, solver="dense")
                         ).optimize(*args)
  np.testing.assert_allclose(band.qpos.numpy(), dense.qpos.numpy(), rtol=0,
                             atol=1e-10)
  assert float(band.cost_initial) == float(dense.cost_initial)
  np.testing.assert_allclose(float(band.cost), float(dense.cost), rtol=0,
                             atol=1e-9 * float(band.cost_initial))
  for got in (band, dense):
    assert got.parameters is None and got.iterations == 4
  assert float(band.cost) < 1e-6 * float(band.cost_initial)


@one_torch_thread()
def test_direct_parameters_match_jax(pendulum):
  m, jm = pendulum
  T = 12
  args = _trajectory(m, T, seed=1, noise=0.005)
  damping, mass = float(m.dof_damping[0]), float(m.body_mass[1])
  specs = {}
  for pkg, mod in (("ours", tdirect), ("theirs", jdirect)):
    specs[pkg] = [
        mod.dof_damping_parameter([0], prior=[3.0 * damping],
                                  prior_weight=1e-6),
        mod.body_mass_parameter([1], prior=[0.5 * mass],
                                prior_weight=1e-6)]
  cfg = dict(horizon=T, max_iterations=3, force_weight=10.0)
  ours = tdirect.Direct(m, tdirect.DirectConfig(**cfg),
                        parameters=specs["ours"])
  theirs = jdirect.Direct(jm, jdirect.DirectConfig(**cfg),
                          parameters=specs["theirs"])
  got, want = _run(ours, theirs, args, params_init=[2.0 * damping, mass])
  np.testing.assert_allclose(got.qpos.numpy(), np.asarray(want.qpos),
                             rtol=0, atol=1e-10)
  np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=0,
                             atol=1e-9 * float(want.cost_initial))
  np.testing.assert_allclose(got.parameters.numpy(),
                             np.asarray(want.parameters), rtol=1e-6)
  np.testing.assert_allclose(ours.default_parameters().numpy(),
                             np.asarray(theirs.default_parameters()))


def test_parameter_specs_match_jax(pendulum):
  """Each plug-in writes the same model fields as JAX's."""
  m, jm = pendulum
  theta = np.asarray([0.7, 0.2, -0.1, 0.3])
  for name, idx, dim in (("dof_damping", [0], 1), ("body_mass", [1], 1),
                         ("site_pos", [0], 3)):
    ours = getattr(tdirect, f"{name}_parameter")(idx)
    theirs = getattr(jdirect, f"{name}_parameter")(idx)
    assert (ours.name, ours.dim, ours.prior) == (theirs.name, theirs.dim,
                                                 theirs.prior)
    got = ours.apply(m, torch.tensor(theta[:dim]))
    want = theirs.apply(jm, jnp.asarray(theta[:dim]))
    for f in ("dof_damping", "body_mass", "body_inertia", "site_pos"):
      np.testing.assert_allclose(getattr(got, f).numpy(),
                                 np.asarray(getattr(want, f)), rtol=0,
                                 atol=1e-15, err_msg=f"{name}: {f}")
    # the new Model shares the engine's constants (none copied again from
    # the host), but for the masses' host copies (physics/sensors.py)
    assert got.__dict__["_const"] is m.__dict__["_const"]
    assert got.__dict__["_own"] == (
        {"sensors_host"} if name == "body_mass" else set())


@one_torch_thread()
def test_freebody_stencil_jacobians():
  jm = jphys.load_model(tm.FREEBODY, dtype=jnp.float64)
  m = convert.model(np_tree(jm), "cpu")
  T, nv = 5, m.nv
  rng = np.random.RandomState(2)
  q0 = np.asarray(jm.qpos0)
  dq = rng.uniform(-0.2, 0.2, (T, nv))
  qs = base.retract(m, torch.tensor(q0)[None], torch.tensor(dq))
  sensors = torch.tensor(rng.randn(T, m.nsensordata))
  ctrls = torch.zeros((T, 0), dtype=torch.float64)
  opt = tdirect.Direct(m, tdirect.DirectConfig(horizon=T))
  theta = torch.zeros(0, dtype=torch.float64)
  rs, jac = opt._stencil_blocks(qs, theta, sensors, ctrls)
  eps = 1e-6
  e = eps * torch.eye(3 * nv, dtype=torch.float64)
  dz = torch.cat([e, -e])  # (6nv, 3nv)
  stencils = [q[:, None, :] for q in opt._stencils(qs)]
  moved = [base.retract(m, stencils[k], dz[:, k * nv:(k + 1) * nv])
           for k in range(3)]
  r = opt._window_residual(m, *moved, sensors[1:-1, None], ctrls[2:, None])
  cd = ((r[:, :3 * nv] - r[:, 3 * nv:]) / (2 * eps)).transpose(1, 2)
  scale = float(jac.abs().max())
  assert float((jac - cd).abs().max()) <= 1e-6 * scale
  r0 = opt._window_residual(m, *opt._stencils(qs), sensors[1:-1], ctrls[2:])
  np.testing.assert_allclose(rs.numpy(), r0.numpy(), rtol=0, atol=1e-12)
  # the rotation columns of each configuration carry the residual
  for k in range(3):
    assert float(jac[..., k * nv + 3:k * nv + 6].abs().max()) > 1e-3
