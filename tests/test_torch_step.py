"""The general step (physics/step.py) held against the JAX package over
20-step trajectories, and inverse dynamics, in float64 on the CPU.

Models (tests/torch_engine_cases.py): the oracle tests' pendulum under the
RK4 integrator, their box on a plane (a free joint landing on its
corners), and the class model ball_chain (a ball joint mid-chain with a
limit, the sphere-capsule pair). Each trajectory starts 5 mm into
contact where the model has any, at random velocities and controls, and
carries the solver's warm start from step to step (Data.efc_lambda), as a
rollout does.

The module starts by releasing the executables JAX holds
(torch_engine_cases.release_jax_executables, autouse): late in a long
test worker the jitted step's compile otherwise found the process's
memory-map limit spent by earlier tests' executables, and the worker died
in XLA's compile (a segfault, reported as this test failing).

Tolerances, with the errors measured when they were set:
  every step's qpos, qvel, act, time and duals: rtol 1e-9, atol 1e-9
    (measured 2e-13);
  inverse dynamics against JAX, at each trajectory's last state: rtol
    1e-9, atol 1e-9 (measured 4e-14).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu import physics as jphys
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.physics import step as tstep
from tests import torch_engine_cases as cases
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

jstep = importlib.import_module("mujoco_mpc_tpu.physics.step")

STEPS = 20
_FIELDS = ("qpos", "qvel", "act", "time", "efc_lambda")


@pytest.fixture(scope="module", params=list(cases.STEP_MODELS))
def case(request):
  """(name, torch model, [port Data per step], [JAX Data per step as
  numpy], JAX model)."""
  mj = cases.STEP_MODELS[request.param]()
  rng = np.random.RandomState(2)
  qpos = mj.qpos0.copy()
  if request.param == "box_on_plane":
    qpos[2] = 0.055
  qvel = rng.uniform(-0.5, 0.5, mj.nv)
  ctrl = rng.uniform(-1, 1, mj.nu)
  jm = jphys.from_mjmodel(mj, dtype=jnp.float64)
  tm = tio.from_mjmodel(mj, dtype=torch.float64, device="cpu")
  jd = jphys.make_data(jm).replace(qpos=jnp.asarray(qpos),
                                   qvel=jnp.asarray(qvel),
                                   ctrl=jnp.asarray(ctrl))
  td = tio.make_data(tm).replace(qpos=torch.tensor(qpos),
                                 qvel=torch.tensor(qvel),
                                 ctrl=torch.tensor(ctrl))
  step = jax.jit(jstep.step)
  ours, theirs = [], []
  for _ in range(STEPS):
    jd = step(jm, jd)
    td = tstep.step(tm, td)
    theirs.append(jax.tree_util.tree_map(np.asarray, jd))
    ours.append(td)
  return request.param, tm, ours, theirs, jm


def test_trajectory_matches_jax(case):
  name, _, ours, theirs, _ = case
  for i, (o, t) in enumerate(zip(ours, theirs)):
    for f in _FIELDS:
      np.testing.assert_allclose(getattr(o, f).numpy(), getattr(t, f),
                                 rtol=1e-9, atol=1e-9,
                                 err_msg=f"{name} step {i} {f}")
  moved = np.abs(ours[-1].qpos.numpy() - ours[0].qpos.numpy()).max()
  assert moved > 1e-3, name


def test_inverse_matches_jax(case):
  name, tm, ours, theirs, jm = case
  d = tstep.forward(tm, ours[-1])
  ours_inv = tstep.inverse(tm, d)
  # the forward pass's qacc and duals into JAX's last state (the two
  # forward passes agree, test_torch_engine.py): inverse reads qpos, qvel,
  # qacc and the warm start
  jd = jax.tree_util.tree_map(jnp.asarray, theirs[-1]).replace(
      qacc=jnp.asarray(d.qacc.numpy()),
      efc_lambda=jnp.asarray(d.efc_lambda.numpy()))
  theirs_inv = np.asarray(jax.jit(jstep.inverse)(jm, jd))
  np.testing.assert_allclose(ours_inv.numpy(), theirs_inv, rtol=1e-9,
                             atol=1e-9, err_msg=name)
