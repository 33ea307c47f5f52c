"""The sharded planners (mujoco_mpc_torch/parallel/mesh.py) on the CPU,
held against the JAX package's on its 8-device CPU mesh
(tests/conftest.py), and Model.to, Data.to and Task.to, which place a
task on a shard's device.

The port's mesh mirrors JAX's with eight shards of the one CPU device,
Mesh((cpu,) * 8). Particle in float64 at horizon 10 over 32 candidates
(tests/test_planners.py's sharded cells): both packages score each shard
through the general rollout, JAX's route for a float64 task (its
returns_xla, the kernel's route off the TPU, computes in float32).
jax.random and torch.Generator draw different numbers, so JAX's draws
are injected: the candidates' normals and, for the robust planner, each
shard's re-scoring normals, drawn from the key JAX folds the shard's
index into. The kernel's route is held on the Walker, eight shards
through MegaRollout's plain version against the unsharded plain returns,
and on the card by chip_smoke.py's phase SH.

Tolerances, with the errors measured when they were set: returns, the
winner and the new policy against JAX at rtol 1e-10, atol 1e-12
(measured 0 in every field); the Walker's sharded returns against the
unsharded plain version at rtol 1e-12 (measured 0: each candidate's
rollout is the same arithmetic whatever its shard).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from mujoco_mpc_torch.parallel import mesh as tpm
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.planners import cross_entropy as tce
from mujoco_mpc_torch.planners import robust as trb
from mujoco_mpc_torch.planners import sampling as tsa
from mujoco_mpc_torch.tasks import registry as treg
from mujoco_mpc_tpu.parallel import mesh as jpm
from mujoco_mpc_tpu.physics import io as jio
from mujoco_mpc_tpu.planners import cross_entropy as jce
from mujoco_mpc_tpu.planners import robust as jrb
from mujoco_mpc_tpu.planners import sampling as jsa
from tests import torch_engine_cases as cases
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

H, K, N, SHARDS = 10, 5, 32, 8
F64 = torch.float64


def _particle():
  t, j = cases.pair("Particle")
  start = [0.2, -0.2]
  td = tio.make_data(t.model).replace(qpos=torch.tensor(start, dtype=F64))
  jd = jio.make_data(j.model).replace(qpos=jnp.asarray(start))
  return t, j, td, jd


def _meshes():
  return (tpm.Mesh(("cpu",) * SHARDS),
          JaxMesh(np.array(jax.devices()[:SHARDS]), (jpm.AXIS,)))


def _normals(key, shape):
  return torch.tensor(np.asarray(jax.random.normal(key, shape,
                                                   dtype=jnp.float64)))


def _close(ours, theirs, what):
  np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                             rtol=1e-10, atol=1e-12, err_msg=what)


def _plan(tp, jp, fields, inject, jit=False):
  """Two iterations of both planners from their init, JAX's optimize
  jitted or called eagerly (around its jitted returns); inject(key) gives
  the port's draws for JAX's key."""
  t, j, td, jd = _particle()
  tpol, jpol = tp.init(t), jp.init(j)
  opt = jax.jit(jp.optimize) if jit else jp.optimize
  for it in range(2):
    key = jax.random.PRNGKey(it)
    with one_torch_thread():
      tpol, ti = tp.optimize(t, tpol, td, None, **inject(key))
    jpol, ji = opt(j, jpol, jd, key)
    # the new policy carries the mesh's sharding: taken off, so that the
    # next plan hits the same compile
    jpol = jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x)),
                                  jpol)
    for f in fields:
      _close(getattr(tpol, f), getattr(jpol, f), f)
    _close(ti.costs, ji.costs, "costs")
    _close(ti.best_return, ji.best_return, "best_return")
    assert int(ti.winner) == int(ji.winner)


def _sampling_noise(key, n=N):
  rng_n, _ = jax.random.split(key)
  return {"noise": _normals(rng_n, (n - 1, K, 2)),
          "use2": torch.zeros(n - 1, dtype=torch.bool)}


def _robust_eps(key, nc, nr, nbody):
  """JAX's re-scoring normals of each shard for the robust planner's
  `key`, shard after shard along the candidates axis."""
  per = nc // SHARDS
  eps = []  # (T, per, nr, nbody, 6) each
  for s in range(SHARDS):
    keys = jax.random.split(jax.random.fold_in(key, s),
                            per * nr).reshape(per, nr, 2)
    eps.append(np.stack([[[np.asarray(jax.random.normal(
        k, (nbody, 6), dtype=jnp.float64))
        for k in jax.random.split(keys[a, b], H)] for b in range(nr)]
        for a in range(per)]).transpose(2, 0, 1, 3, 4))
  return torch.tensor(np.concatenate(eps, axis=1))


def test_sharded_planners_match_jax():
  """Two plans of each. The JAX sampling and CEM planners run their
  optimize eagerly around one jitted _sharded_returns, which they share;
  the robust planner's optimize is jitted (an eager one compiles its
  shard_map anew each call), its delegate's candidates scored by the
  same function (the sharded returns equal the unsharded ones)."""
  tmesh, jmesh = _meshes()
  cfg = dict(num_trajectories=N, spline_points=K, horizon=H)
  jsp = jpm.ShardedSamplingPlanner(jsa.SamplingConfig(**cfg), jmesh,
                                   use_megakernel=False)
  jcp = jpm.ShardedCrossEntropyPlanner(
      jce.CEMConfig(**cfg, n_elite=4), jmesh, use_megakernel=False)
  jdelegate = jsa.SamplingPlanner(jsa.SamplingConfig(**cfg),
                                  use_megakernel=False)
  returns = jax.jit(jsp._returns)
  jsp._returns = jcp._returns = jdelegate._returns = (
      lambda task, data, new_times, cands, params=None:
      returns(task, data, new_times, cands, params))
  _plan(
      tpm.ShardedSamplingPlanner(tsa.SamplingConfig(**cfg), tmesh,
                                 use_megakernel=False),
      jsp, ("times", "values"), _sampling_noise)
  _plan(
      tpm.ShardedCrossEntropyPlanner(tce.CEMConfig(**cfg, n_elite=4), tmesh,
                                     use_megakernel=False),
      jcp, ("times", "values", "std"),
      lambda key: {"noise": _normals(key, (N - 1, K, 2))})
  nc, nr = 8, 2
  nbody = _particle()[0].model.nbody

  def inject(key):
    rng_c, rng_n = jax.random.split(key)
    return {**_sampling_noise(rng_c),
            "eps": _robust_eps(rng_n, nc, nr, nbody)}

  rcfg = dict(ncandidates=nc, nrepetitions=nr)
  _plan(
      tpm.ShardedRobustPlanner(
          tsa.SamplingPlanner(tsa.SamplingConfig(**cfg),
                              use_megakernel=False),
          trb.RobustConfig(**rcfg), tmesh),
      jpm.ShardedRobustPlanner(jdelegate, jrb.RobustConfig(**rcfg), jmesh),
      ("times", "values"), inject, jit=True)
  assert returns._cache_size() == 1


@one_torch_thread()
def test_sharded_robust_draws_a_generator_per_shard():
  """Without eps, each shard draws from its own generator, seeded from
  one draw of the caller's: the same caller's seed gives the same scores,
  another seed others."""
  t, _, td, _ = _particle()
  cfg = tsa.SamplingConfig(num_trajectories=N, spline_points=K, horizon=H)
  tp = tpm.ShardedRobustPlanner(
      tsa.SamplingPlanner(cfg, use_megakernel=False),
      trb.RobustConfig(ncandidates=8, nrepetitions=2),
      tpm.Mesh(("cpu",) * 4))
  policy = tp.init(t)
  noise = _normals(jax.random.PRNGKey(0), (N - 1, K, 2))
  use2 = torch.zeros(N - 1, dtype=torch.bool)
  runs = [tp.optimize(t, policy, td, torch.Generator().manual_seed(seed),
                      noise=noise, use2=use2)[1].costs
          for seed in (3, 3, 4)]
  torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
  assert not torch.equal(runs[0], runs[2])
  assert bool(torch.all(torch.isfinite(runs[0])))


@one_torch_thread()
def test_sharded_kernel_route_equals_unsharded_plain():
  """Walker, T 10, N 16 over eight CPU shards through MegaRollout's plain
  version, in float64, against the unsharded plain returns of the same
  candidates; the planners' winner and policy equal the unsharded one's."""
  t = treg.get_task("Walker", dtype=F64, device="cpu")
  d = tio.make_data(t.model).replace(
      qpos=torch.tensor(t.model.keyframe("home")[0], dtype=F64))
  cfg = tsa.SamplingConfig(num_trajectories=16, spline_points=K, horizon=H)
  sharded = tpm.ShardedSamplingPlanner(cfg, tpm.Mesh(("cpu",) * SHARDS))
  plain = tsa.SamplingPlanner(cfg)
  rng = np.random.RandomState(0)
  noise = torch.tensor(rng.randn(15, K, 6))
  use2 = torch.zeros(15, dtype=torch.bool)
  got, gi = sharded.optimize(t, sharded.init(t), d, None, noise=noise,
                             use2=use2)
  want, wi = plain.optimize(t, plain.init(t), d, None, noise=noise,
                            use2=use2)
  assert list(sharded.megas) == [torch.device("cpu")]
  assert sharded.megas[torch.device("cpu")] is sharded.mega
  np.testing.assert_allclose(gi.costs.numpy(), wi.costs.numpy(),
                             rtol=1e-12, atol=0)
  assert int(gi.winner) == int(wi.winner)
  torch.testing.assert_close(got.values, want.values, rtol=0, atol=0)
  assert bool(torch.all(gi.costs < tsa.megarollout.MAX_RETURN))


def test_mesh_errors(monkeypatch):
  cfg = tsa.SamplingConfig(num_trajectories=30, spline_points=K, horizon=H)
  with pytest.raises(ValueError,
                     match="num_trajectories=30 must be divisible by mesh "
                           "size 8"):
    tpm.ShardedSamplingPlanner(cfg, tpm.Mesh(("cpu",) * 8))
  with pytest.raises(ValueError, match="ncandidates=12 must be divisible"):
    tpm.ShardedRobustPlanner(tsa.SamplingPlanner(cfg), trb.RobustConfig(),
                             tpm.make_mesh(8, device="cpu"))
  # a task off the mesh's first device
  t = treg.get_task("Particle", device="cpu")
  p = tpm.ShardedSamplingPlanner(
      tsa.SamplingConfig(num_trajectories=32, spline_points=K, horizon=H),
      tpm.Mesh(("meta", "cpu")))
  with pytest.raises(ValueError, match="first device is meta"):
    p.init(t)
  # CUDA meshes on a host without a card
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  for build in (tpm.make_mesh, lambda: tpm.Mesh(("cuda",))):
    with pytest.raises(RuntimeError, match="is_available"):
      build()
  # more cards than the host has: never shrunk
  monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
  monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
  monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
  assert tpm.make_mesh(device="cuda").devices == (torch.device("cuda", 0),)
  with pytest.raises(ValueError, match="has 1 CUDA devices"):
    tpm.make_mesh(2)


def test_task_model_and_data_move_between_devices():
  t = treg.get_task("Walker", device="cpu")
  assert t.to("cpu").model is t.model  # its engine constants kept
  d = tio.make_data(t.model)
  assert d.to("cpu") is d
  moved, dm = t.to("meta"), d.to("meta")
  for obj in (moved.model, moved.model.opt, moved.params, dm, dm.contact):
    for name, v in vars(obj).items():
      if isinstance(v, torch.Tensor):
        assert v.device.type == "meta", name
  assert moved.model.device == torch.device("meta")
  assert (moved.residual, moved.device_residual, moved.transition) == (
      t.residual, t.device_residual, t.transition)
  assert moved.model.body_names == t.model.body_names
  # the source keeps its tensors where they were
  assert t.model.device == torch.device("cpu")
  assert d.contact.pos.device == torch.device("cpu")
