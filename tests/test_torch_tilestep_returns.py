"""The port's CPU MegaRollout.returns held against the JAX
MegaRollout.returns_xla (which tests/test_megarollout.py pins to the
interpret-mode Pallas kernel) on the Walker, on the same float32 inputs
made with numpy from a seed. The JAX function is jitted once per module:
compiling it takes about half a minute on a CPU, and the tests call it
four times.

Tolerance: rtol 2e-3, the repo's tolerance between two implementations
(test_megarollout.py), measured 2.4e-7 at T=10, n=8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.ops import megarollout as tmr
from mujoco_mpc_tpu.ops import megarollout as jmr
from tests.test_torch_tilestep import tasks  # noqa: F401 (fixture)

T, N = 10, 8


@pytest.fixture(scope="module")
def rollouts(tasks):  # noqa: F811
  t, j = tasks
  home = np.asarray(t.model.keyframe("home")[0], np.float32)
  acts = (0.4 * np.random.RandomState(0).randn(N, T, 6)).astype(np.float32)
  jm = jmr.MegaRollout(j, T)
  jf = jax.jit(jm.returns_xla)

  def jax_returns(actions, params):
    return np.asarray(jf(jnp.asarray(home), jnp.zeros(9, jnp.float32),
                         jnp.asarray(actions), params, 0.0))

  def torch_returns(actions, params):
    return tmr.MegaRollout(t, T, device="cpu").returns(
        torch.tensor(home), torch.zeros(9), torch.tensor(actions), params,
        torch.tensor(0.0)).numpy()

  return t, j, acts, jax_returns, torch_returns


def test_returns_match_jax_returns_xla(rollouts):
  t, j, acts, jax_returns, torch_returns = rollouts
  got = torch_returns(acts, t.params)
  want = jax_returns(acts, j.params)
  np.testing.assert_allclose(got, want, rtol=2e-3)
  assert np.all(np.isfinite(got)) and np.all(got < tmr.MAX_RETURN)


def test_divergence_guard(rollouts):
  """Exploding actions -> MAX_RETURN in both packages, not nan."""
  t, j, acts, jax_returns, torch_returns = rollouts
  bad = acts.copy()
  bad[0] = 1e30
  got = torch_returns(bad, t.params)
  assert got[0] == tmr.MAX_RETURN
  np.testing.assert_allclose(got, jax_returns(bad, j.params), rtol=2e-3)


def test_params_are_runtime_tunable(rollouts):
  """Changing weights and residual params changes returns, no rebuild."""
  t, j, acts, jax_returns, torch_returns = rollouts
  mr = tmr.MegaRollout(t, T, device="cpu")
  args = (torch.tensor(np.asarray(t.model.keyframe("home")[0], np.float32)),
          torch.zeros(9), torch.tensor(acts))
  r1 = mr.returns(*args, t.params, 0.0).numpy()
  heavier = t.params.replace(weights=t.params.weights * 3.0)
  r2 = mr.returns(*args, heavier, 0.0).numpy()
  np.testing.assert_allclose(r2, 3.0 * r1, rtol=1e-5)
  faster = t.set_parameter("Speed", 2.0).params
  r3 = mr.returns(*args, faster, 0.0).numpy()
  assert not np.allclose(r1, r3)
  np.testing.assert_allclose(
      r3, jax_returns(acts, j.set_parameter("Speed", 2.0).params),
      rtol=2e-3)
