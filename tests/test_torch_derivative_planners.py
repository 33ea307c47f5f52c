"""The port's gradient, sample-gradient, robust and iLQS planners held
against the JAX package in float64 on the CPU, on Particle at horizon 10
from qpos (0.2, -0.2) (tests/test_planners.py's start), two iterations
each, every JAX optimize jitted once.

jax.random and torch.Generator draw different numbers, so the random
inputs are JAX's own draws, injected: sample-gradient's `noise`, the
sampling candidates' normals of robust and iLQS (`noise`; their second
std is off, so `use2` is all False), and robust's re-scoring normals
(`eps`), each drawn from the keys JAX's planners split them from. The
sampling-family planners score through the general rollout
(use_megakernel=False), the JAX planners' route at these candidate
counts; the kernel's route is held on the card (chip_smoke.py, D2).

Tolerances, with the errors measured when they were set: every policy
field and every return at rtol 1e-9, atol 1e-12 (measured 3e-16), the
same winner; the fitness weights and log-spaced steps at 1e-15.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.planners import base as tbase
from mujoco_mpc_torch.planners import gradient as tgr
from mujoco_mpc_torch.planners import ilqg as til
from mujoco_mpc_torch.planners import ilqs as tis
from mujoco_mpc_torch.planners import robust as trb
from mujoco_mpc_torch.planners import sample_gradient as tsg
from mujoco_mpc_torch.planners import sampling as tsa
from mujoco_mpc_tpu.physics import io as jio
from mujoco_mpc_tpu.planners import gradient as jgr
from mujoco_mpc_tpu.planners import ilqg as jil
from mujoco_mpc_tpu.planners import ilqs as jis
from mujoco_mpc_tpu.planners import robust as jrb
from mujoco_mpc_tpu.planners import sample_gradient as jsg
from mujoco_mpc_tpu.planners import sampling as jsa
from tests import torch_engine_cases as cases
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

H, K, N = 10, 5, 16  # horizon, spline points, sampling candidates
F64 = torch.float64


@pytest.fixture(scope="module")
def particle():
  t, j = cases.pair("Particle")
  start = [0.2, -0.2]
  td = tio.make_data(t.model).replace(qpos=torch.tensor(start, dtype=F64))
  jd = jio.make_data(j.model).replace(qpos=jnp.asarray(start))
  return t, j, td, jd


def _close(ours, theirs, what):
  np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                             rtol=1e-9, atol=1e-12, err_msg=what)


def _normals(key, shape):
  return torch.tensor(np.asarray(jax.random.normal(key, shape,
                                                   dtype=jnp.float64)))


def _run(particle, tp, jp, fields, inject):
  """Two iterations of both planners from their init; inject(key) gives
  the port's random inputs for JAX's key."""
  t, j, td, jd = particle
  tpol, jpol = tp.init(t), jp.init(j)
  opt = jax.jit(jp.optimize)
  for it in range(2):
    key = jax.random.PRNGKey(it)
    with one_torch_thread():
      tpol, ti = tp.optimize(t, tpol, td, None, **inject(key))
    jpol, ji = opt(j, jpol, jd, key)
    for f in fields:
      ours, theirs = tpol, jpol
      for part in f.split("."):
        ours, theirs = getattr(ours, part), getattr(theirs, part)
      _close(ours, theirs, f)
    _close(ti.costs, ji.costs, "costs")
    _close(ti.best_return, ji.best_return, "best_return")
    assert int(ti.winner) == int(ji.winner)
  return tpol


def test_gradient_optimize_matches_jax(particle):
  cfg = dict(spline_points=K, horizon=H, num_steps=8)
  _run(particle, tgr.GradientPlanner(tgr.GradientConfig(**cfg)),
       jgr.GradientPlanner(jgr.GradientConfig(**cfg)), ("times", "values"),
       lambda key: {})


def test_sample_gradient_optimize_matches_jax(particle):
  cfg = dict(num_noisy=12, num_gradient=6, spline_points=K, horizon=H)
  tp = tsg.SampleGradientPlanner(tsg.SGConfig(**cfg), use_megakernel=False)
  pol = _run(particle, tp, jsg.SampleGradientPlanner(jsg.SGConfig(**cfg)),
             ("times", "values", "gradient"),
             lambda key: {"noise": _normals(key, (12, K, 2))})
  assert tp.general_reason == "use_megakernel=False"
  assert float(pol.gradient.abs().max()) > 0


def _sampling_noise(key):
  """The sampling candidates' standard normals JAX draws from `key`."""
  rng_n, _ = jax.random.split(key)
  return {"noise": _normals(rng_n, (N - 1, K, 2)),
          "use2": torch.zeros(N - 1, dtype=torch.bool)}


def test_robust_optimize_matches_jax(particle):
  t = particle[0]
  scfg = dict(num_trajectories=N, spline_points=K, horizon=H)
  nc, nr = 4, 2

  def inject(key):
    rng_c, rng_n = jax.random.split(key)
    keys = jax.random.split(rng_n, nc * nr).reshape(nc, nr, 2)
    # (T, nc, nr, nbody, 6), as noisy_rollout draws them per rollout
    eps = np.stack([[[np.asarray(jax.random.normal(
        k, (t.model.nbody, 6), dtype=jnp.float64))
        for k in jax.random.split(keys[a, b], H)] for b in range(nr)]
        for a in range(nc)]).transpose(2, 0, 1, 3, 4)
    return {**_sampling_noise(rng_c), "eps": torch.tensor(eps)}

  _run(particle,
       trb.RobustPlanner(tsa.SamplingPlanner(tsa.SamplingConfig(**scfg),
                                             use_megakernel=False),
                         trb.RobustConfig(ncandidates=nc, nrepetitions=nr)),
       jrb.RobustPlanner(jsa.SamplingPlanner(jsa.SamplingConfig(**scfg),
                                             use_megakernel=False),
                         jrb.RobustConfig(ncandidates=nc, nrepetitions=nr)),
       ("times", "values"), inject)


def test_ilqs_optimize_matches_jax(particle):
  scfg = dict(num_trajectories=N, spline_points=K, horizon=H)
  tp = tis.ILQSPlanner(tis.ILQSConfig(sampling=tsa.SamplingConfig(**scfg),
                                      ilqg=til.ILQGConfig(horizon=H)))
  tp.sampler = tsa.SamplingPlanner(tp.config.sampling, use_megakernel=False)
  pol = _run(
      particle, tp,
      jis.ILQSPlanner(jis.ILQSConfig(sampling=jsa.SamplingConfig(**scfg),
                                     ilqg=jil.ILQGConfig(horizon=H))),
      ("use_ilqg", "sampling.times", "sampling.values", "ilqg.xs",
       "ilqg.us", "ilqg.gains", "ilqg.reg", "ilqg.t0"), _sampling_noise)
  assert pol.use_ilqg.dtype == torch.bool and pol.use_ilqg.dim() == 0


def test_step_sizes_and_fitness_weights_match_jax():
  like = torch.zeros((), dtype=F64)
  for n in (6, 12, 56):
    np.testing.assert_allclose(tsg.fitness_weights(n, like).numpy(),
                               np.asarray(jsg._fitness_weights(n,
                                                               jnp.float64)),
                               rtol=1e-15, atol=1e-15)
  np.testing.assert_allclose(
      tbase.log_steps(1e-4, 1.0, 10, like).numpy(),
      np.exp(np.linspace(np.log(1e-4), np.log(1.0), 10)), rtol=1e-15)
