"""mujoco_mpc_torch norms, costs and splines held against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: 1e-10 for the norms and cost_value in float64, 1e-6 (relative)
for the float32 tile cost, 1e-12 for the splines in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.ops import megarollout as tmr
from mujoco_mpc_torch.ops import norms as tnorms
from mujoco_mpc_torch.ops import spline as tspline
from mujoco_mpc_torch.tasks import base as tbase
from mujoco_mpc_tpu.ops import megarollout as jmr
from mujoco_mpc_tpu.ops import norms as jnorms
from mujoco_mpc_tpu.ops import spline as jspline
from mujoco_mpc_tpu.tasks import base as jbase
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

# (norm, p, q): parameters in each norm's valid range
_NORMS = [(-1, 0.0, 0.0), (0, 0.0, 0.0), (1, 0.3, 2.5), (2, 0.2, 0.0),
          (3, 0.7, 0.0), (5, 1.7, 0.0), (6, 0.1, 0.0), (7, 0.2, 1.5),
          (8, 0.3, 0.0), (8, 0.0, 0.0)]


@pytest.mark.parametrize("norm,p,q", _NORMS)
def test_norm_value_matches_jax(norm, p, q):
  x = np.random.RandomState(norm + 2).randn(4, 5)
  f64 = torch.float64
  got = tnorms.norm_value(torch.tensor(x), norm, torch.tensor(p, dtype=f64),
                          torch.tensor(q, dtype=f64))
  want = jnorms.norm_value(jnp.asarray(x), norm, jnp.asarray(p),
                           jnp.asarray(q))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                             atol=1e-10)


def _spec_and_params(risk, dtype):
  norm_types = tuple(n for n, _, _ in _NORMS[:-1])
  dims = (1, 3, 2, 2, 1, 3, 2, 2, 3)
  rng = np.random.RandomState(7)
  weights = rng.uniform(0.1, 2.0, len(dims))
  npar = np.asarray([[p, q] for _, p, q in _NORMS[:-1]])
  names = tuple(f"t{i}" for i in range(len(dims)))
  rp = np.zeros((0,))
  t = tbase.TaskParams(*(torch.tensor(v, dtype=dtype) for v in
                         (weights, npar, np.asarray(risk), rp)))
  jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
  j = jbase.TaskParams(*(jnp.asarray(v, dtype=jdt) for v in
                         (weights, npar, np.asarray(risk), rp)))
  return (tbase.CostSpec(names, norm_types, dims),
          jbase.CostSpec(names, norm_types, dims), t, j)


@pytest.mark.parametrize("risk", [0.0, 0.3, -0.2])
def test_cost_value_matches_jax(risk):
  tspec, jspec, tp, jp = _spec_and_params(risk, torch.float64)
  res = np.random.RandomState(3).randn(tspec.nresidual) * 0.5
  got = tbase.cost_value(tspec, tp, torch.tensor(res))
  want = jbase.cost_value(jspec, jp, jnp.asarray(res))
  np.testing.assert_allclose(got.item(), float(want), rtol=1e-10)
  np.testing.assert_allclose(
      tbase.cost_terms(tspec, tp, torch.tensor(res)).numpy(),
      np.asarray(jbase.cost_terms(jspec, jp, jnp.asarray(res))), rtol=1e-10)


@pytest.mark.parametrize("risk", [0.0, 0.3])
def test_cost_value_t_matches_jax(risk):
  tspec, jspec, tp, jp = _spec_and_params(risk, torch.float32)
  res = (np.random.RandomState(4).randn(tspec.nresidual, 16) * 0.5
         ).astype(np.float32)
  got = tmr.cost_value_t(tspec, tp.weights, tp.norm_params, tp.risk,
                         torch.tensor(res))
  want = jmr.cost_value_t(jspec, jp.weights.reshape(-1, 1),
                          jp.norm_params.reshape(-1, 2, 1), jp.risk,
                          jnp.asarray(res))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _spline_case(seed):
  rng = np.random.RandomState(seed)
  k, dim = 6, 3
  times = np.sort(rng.uniform(0.0, 1.0, k)) + 0.1
  values = rng.randn(k, dim)
  ts = np.concatenate([[0.0, times[0], times[-1], 2.0],
                       rng.uniform(0.0, 1.2, 12)])
  return times, values, ts


@pytest.mark.parametrize("interp", list(tspline.Interp))
def test_spline_sample_matches_jax(interp):
  times, values, ts = _spline_case(int(interp))
  for t in ts:
    got = tspline.sample(torch.tensor(times), torch.tensor(values), t,
                         interp)
    want = jspline.sample(jnp.asarray(times), jnp.asarray(values),
                          jnp.asarray(t), jspline.Interp(int(interp)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("interp", list(tspline.Interp))
def test_spline_sample_many_matches_jax(interp):
  times, values, ts = _spline_case(10 + int(interp))
  batch = np.random.RandomState(5).randn(4, *values.shape)
  got = tspline.sample_many(torch.tensor(times), torch.tensor(batch),
                            torch.tensor(ts), interp)
  ji = jspline.Interp(int(interp))
  want = jax.vmap(lambda v: jspline.sample_many(
      jnp.asarray(times), v, jnp.asarray(ts), ji))(jnp.asarray(batch))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                             atol=1e-12)


@pytest.mark.parametrize("interp", list(tspline.Interp))
def test_spline_resample_matches_jax(interp):
  times, values, _ = _spline_case(20 + int(interp))
  new_times = times[0] - 0.05 + np.arange(6) * 0.2
  got = tspline.resample(torch.tensor(times), torch.tensor(values),
                         torch.tensor(new_times), interp)
  want = jspline.resample(jnp.asarray(times), jnp.asarray(values),
                          jnp.asarray(new_times), jspline.Interp(int(interp)))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                             atol=1e-12)
