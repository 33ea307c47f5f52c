"""The port's general engine, its smooth stages, held against the JAX
package and against MuJoCo C, in float64 on the CPU: ops/linalg and
physics/math, and the forward pass of the cartpole and the Walker (the
other models: test_torch_engine_b.py and _c.py; the models, their checks
and tolerances: tests/torch_engine_cases.py).

Tolerances, with the errors measured when they were set:
  ops/linalg and physics/math against JAX: atol 1e-12 (measured 4e-15);
  the forward pass: tests/torch_engine_cases.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_tpu.ops import linalg as jlinalg
from mujoco_mpc_tpu.physics import math as jmath
from mujoco_mpc_torch.ops import linalg as tlinalg
from mujoco_mpc_torch.physics import math as tmath
from tests import torch_engine_cases as cases
from tests.torch_engine_cases import release_jax_executables  # noqa: F401


@pytest.fixture(scope="module", params=["cartpole", "walker"])
def case(request):
  return cases.engine_case(request.param)


def test_linalg_and_math_match_jax():
  rng = np.random.RandomState(0)
  a = rng.randn(3, 7, 7)
  spd = a @ a.transpose(0, 2, 1) + 7 * np.eye(7)
  b, bk = rng.randn(3, 7), rng.randn(3, 7, 4)
  tl = tlinalg.chol_factor(torch.tensor(spd))
  jl = jlinalg.chol_factor(jnp.asarray(spd))
  np.testing.assert_allclose(tl.numpy(), jl, atol=1e-12)
  for rhs in (b, bk):
    np.testing.assert_allclose(
        tlinalg.chol_solve(tl, torch.tensor(rhs)).numpy(),
        jlinalg.chol_solve(jl, jnp.asarray(rhs)), atol=1e-12)
  np.testing.assert_allclose(
      tlinalg.solve_sym(torch.tensor(spd), torch.tensor(b)).numpy(),
      jlinalg.solve_sym(jnp.asarray(spd), jnp.asarray(b)), atol=1e-12)

  q = rng.randn(5, 4)
  q /= np.linalg.norm(q, axis=-1, keepdims=True)
  q2 = rng.randn(5, 4)
  q2 /= np.linalg.norm(q2, axis=-1, keepdims=True)
  v, w = rng.randn(5, 3), rng.randn(5, 6)
  w[0] = 0.0  # the zero-vector branches
  m3 = jmath.quat_to_mat(jnp.asarray(q2))
  cases = [
      ("quat_mul", (q, q2)), ("quat_conj", (q,)), ("quat_rot", (q, v)),
      ("quat_rot_inv", (q, v)), ("quat_to_mat", (q,)),
      ("mat_to_quat", (np.asarray(m3),)),
      ("axis_angle_quat", (v / np.linalg.norm(v, axis=-1, keepdims=True),
                           v[:, 0])),
      ("quat_integrate", (q, np.concatenate([np.zeros((1, 3)), v[1:]]),
                          0.01)),
      ("quat_sub", (q, q2)), ("motion_cross", (w, rng.randn(5, 6))),
      ("force_cross", (w, rng.randn(5, 6))), ("skew", (v,)),
      ("spatial_inertia", (rng.rand(5), np.asarray(m3), v)),
      ("normalize", (w,))]
  for name, args in cases:
    ours = getattr(tmath, name)(*(torch.tensor(x) if isinstance(
        x, np.ndarray) else x for x in args))
    theirs = getattr(jmath, name)(*(jnp.asarray(x) if isinstance(
        x, np.ndarray) else x for x in args))
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-12,
                               err_msg=name)
  for ours, theirs in zip(tmath.safe_norm(torch.tensor(w)),
                          jmath.safe_norm(jnp.asarray(w))):
    np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-12)


def test_forward_matches_jax(case):
  cases.check_forward(case)


def test_smooth_matches_mujoco(case):
  cases.check_smooth(case)
