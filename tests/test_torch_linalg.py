"""The Cholesky factor with its pivot floor (ops/linalg.py) held against the
JAX package's in float64 on the CPU, and the general step's inertia
factor (physics/step.py::_chol, no floor) shown to stay clear of it.

The factor and the solve run on three inputs: the singular PSD matrix
[[1, 1, 0], [1, 1, 0], [0, 0, 2]] (its second pivot floors at 1e-12, so
the solution of [1, 2, 3] is about (-1e12, 1e12, 1.5); an unfloored
factor gives NaN), an indefinite matrix and a batch of random SPD
matrices. The factor is held at 1e-12 relative to its largest entry and
the solve at 1e-8 relative to the solution's largest entry (measured: the
factor 2.1e-16 at most, the solve 1.2e-15, the indefinite one's), finite
wherever JAX's is.

The inertia test takes M + h diag(damping) at every registered task's
home keyframe (qpos0 without one), in float32 and float64, and holds its
smallest pivot (the squared diagonal of its factor) at 1e6 times the
floor or more: the smallest measured, the Swimmer's, is 6.7e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.ops import linalg as tlinalg
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.physics import step as tstep
from mujoco_mpc_torch.tasks import registry as treg
from mujoco_mpc_tpu.ops import linalg as jlinalg
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

EPS = 1e-12  # the factor's pivot floor, as in both packages
MARGIN = 1e6  # the inertia pivots' least multiple of the floor


def _inputs(kind):
  rng = np.random.RandomState(3)
  if kind == "singular":
    a = np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 2.0]])
    return a, np.array([1.0, 2.0, 3.0])
  if kind == "indefinite":
    a = np.array([[2.0, 3.0, 0.5, 0.0], [3.0, 1.0, 0.0, 0.2],
                  [0.5, 0.0, 4.0, 1.0], [0.0, 0.2, 1.0, -1.0]])
    return a, rng.randn(4, 2)
  x = rng.randn(5, 6, 6)
  return x @ x.transpose(0, 2, 1) + 0.5 * np.eye(6), rng.randn(5, 6)


def _close(ours, theirs, rtol):
  theirs = np.asarray(theirs)
  assert np.array_equal(np.isfinite(ours), np.isfinite(theirs))
  fin = np.isfinite(theirs)
  scale = np.max(np.abs(theirs[fin]))
  np.testing.assert_allclose(ours[fin], theirs[fin], rtol=0,
                             atol=rtol * scale)


@pytest.mark.parametrize("kind", ["singular", "indefinite", "spd_batch"])
def test_chol_matches_jax(kind):
  a, b = _inputs(kind)
  tl = tlinalg.chol_factor(torch.tensor(a), eps=EPS)
  jl = jlinalg.chol_factor(jnp.asarray(a), eps=EPS)
  _close(tl.numpy(), jl, 1e-12)
  x = tlinalg.chol_solve(tl, torch.tensor(b)).numpy()
  _close(x, jlinalg.chol_solve(jl, jnp.asarray(b)), 1e-8)
  assert np.all(np.isfinite(x))
  if kind == "singular":
    assert tl[1, 1].item() == pytest.approx(1e-6, rel=1e-12)
    assert abs(x[0]) > 1e11 and abs(x[1]) > 1e11


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_inertia_pivots_stay_above_the_floor(dtype):
  least = {}
  for name in treg.task_names():
    m = treg.get_task(name, dtype=dtype, device="cpu").model
    d = tio.make_data(m)
    try:
      d = d.replace(qpos=torch.as_tensor(m.keyframe("home")[0], dtype=dtype))
    except KeyError:
      pass
    d = tstep._smooth(m, d, actuate=False)
    pivots = torch.diagonal(tstep._chol(m, d)) ** 2
    assert torch.all(torch.isfinite(pivots)), name
    least[name] = pivots.min().item()
  assert len(least) == 26
  low = min(least, key=least.get)
  assert least[low] >= MARGIN * EPS, (low, least[low])
