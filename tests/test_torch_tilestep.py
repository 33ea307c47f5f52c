"""The port's plain tile step held against the JAX tile path.

mujoco_mpc_torch.physics.tilestep.step_tb against
mujoco_mpc_tpu.physics.tilestep.step_tb on the same float32 inputs made
with numpy from a seed; the rollouts are held in
tests/test_torch_planner.py.

Tolerances, with the errors measured when they were set:
  one step: qpos atol 1e-6 (measured 3e-8), qvel atol 1e-4 (8e-6), duals
    atol 1e-5 * max|duals| (3e-3 of 2.2e3, i.e. 1.4e-6 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.physics import tilestep as tts
from mujoco_mpc_torch.tasks import registry as treg
from mujoco_mpc_tpu.physics import tilestep as jts
from mujoco_mpc_tpu.tasks import registry as jreg
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

B = 16


@pytest.fixture(scope="module")
def tasks():
  return (treg.get_task("Walker", device="cpu"),
          jreg.get_task("Walker", dtype=jnp.float32))


def _states(seed, home):
  rng = np.random.RandomState(seed)
  qp = (home + rng.uniform(-0.05, 0.05, (B, 9))).astype(np.float32)
  qp[:, 0] -= 0.03  # sink the walker a little: contacts active
  qv = rng.uniform(-0.5, 0.5, (B, 9)).astype(np.float32)
  ct = rng.uniform(-1.0, 1.0, (B, 6)).astype(np.float32)
  return qp.T.copy(), qv.T.copy(), ct.T.copy()


def _jax_step(jtm):
  """The JAX tile step, eagerly: two steps take seconds, where compiling it
  takes half a minute on a CPU."""
  def f(q, v, c, lam):
    q2, v2, view = jts.step_tb(jtm, q, v, c, efc_lambda=lam)
    return q2, v2, view.efc_lambda
  return f


def _compare_two_steps(ttm, jtm, home):
  qp, qv, ct = _states(1, home)
  jstep = _jax_step(jtm)
  lam = np.zeros((ttm.nrow, B), np.float32)
  tq, tv, tl = torch.tensor(qp), torch.tensor(qv), torch.tensor(lam)
  jq, jv, jl = jnp.asarray(qp), jnp.asarray(qv), jnp.asarray(lam)
  for _ in range(2):  # a cold step, then a warm-started one
    tq, tv, view = tts.step_tb(ttm, tq, tv, torch.tensor(ct), tl)
    tl = view.efc_lambda
    jq, jv, jl = jstep(jq, jv, jnp.asarray(ct), jl)
    scale = float(np.abs(np.asarray(jl)).max())
    assert scale > 1.0  # contacts carry force
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=1e-5 * scale)


def test_step_matches_jax_matrix_free(tasks):
  """Walker: nrow = 54 > the dense threshold, matrix-free solve."""
  t, j = tasks
  ttm, jtm = tts.extract(t.model), jts.extract(j.model)
  assert not tts.amat_is_dense(ttm.nrow)
  _compare_two_steps(ttm, jtm, np.asarray(t.model.keyframe("home")[0]))


def test_step_matches_jax_dense(tasks):
  """Walker with only the feet colliding: nrow = 24, the dense Delassus
  branch with the Gershgorin step."""
  t, j = tasks
  feet = (t.model.geom("right_foot"), t.model.geom("left_foot"))
  pairs = tuple(p for p in t.model.collision_pairs if p[1] in feet)
  ttm = tts.extract(t.model.replace(collision_pairs=pairs))
  jtm = jts.extract(j.model.replace(collision_pairs=pairs))
  assert ttm.nrow == 24 and tts.amat_is_dense(ttm.nrow)
  _compare_two_steps(ttm, jtm, np.asarray(t.model.keyframe("home")[0]))
