"""Humanoid Walk in the port held against the JAX package.

The same float32 inputs, made with numpy from a seed, go through both
packages. The states are humanoid.probe_states: every constraint row class
(plane-capsule end, plane-sphere, capsule-capsule at condim 1, joint limit,
tendon limit) carries force in at least one of them. The JAX reference runs
eagerly, without an outer jax.jit (compiling its humanoid tile path takes
minutes on a CPU), and each JAX result is computed once per module.

Tolerances, with the errors measured on a CPU host:
  snapshot: integers exact, floats 1e-6 (measured 0);
  extract: integers exact, floats 1e-6 (measured 0);
  one step, cold and warm, two float32 steps, the tolerances of
    test_megarollout.py:113-114 between two f32 paths: each field per
    state within max(its atol, 8 times that state's distance of JAX's
    float32 step from the port's float64 one) (torch_cases.
    within_rounding; parity with JAX is tests/test_torch_tilestep64.py's
    float64 hold): qpos atol 2e-5 (measured 1.5e-6), qvel atol 2e-4
    (1.96e-4, the cold step, a margin under 2 that the witness, 8 x
    1.0e-4 there, covers 4.1 times), the frames the residual reads atol
    2e-4 (2.06e-4, cvel after the warm step, beyond the atol within
    8 x 1.04e-4: a margin of 4.0); duals atol 1e-4 * max|duals| (4.5e-3
    of 2.25e3, i.e. 2.0e-6 relative);
  residual on the same view: atol 1e-5 (measured 0);
  returns at n = 8, T = 4: rtol 2e-3 (measured 3.6e-7).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.agent.agent import Agent
from mujoco_mpc_torch.ops import megarollout as tmr
from mujoco_mpc_torch.physics import tilestep as tts
from mujoco_mpc_torch.planners import sampling as tsampling
from mujoco_mpc_torch.tasks import dm_suite
from mujoco_mpc_torch.tasks import humanoid as thum
from mujoco_mpc_torch.tasks import registry as treg
from mujoco_mpc_tpu.physics import tilestep as jts
from mujoco_mpc_tpu.tasks import registry as jreg
from tests.test_torch_model import _same
from tests.test_torch_tilestep_classes import shared_probe_and_returns
from tests.torch_cases import one_torch_thread, port_steps, within_rounding
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

B, N, T = 8, 8, 4
_KINDS = ("plane_capend", "plane_sphere", "cap_cap", "joint_limit",
          "tendon_limit")


@pytest.fixture(scope="module")
def tasks():
  return (treg.get_task("Humanoid Walk", device="cpu"),
          jreg.get_task("Humanoid Walk", dtype=jnp.float32))


@pytest.fixture(scope="module")
def tile_models(tasks):
  t, j = tasks
  return tts.extract(t.model), jts.extract(j.model)


def test_humanoid_snapshot_matches_fresh_build():
  fresh, spec, params, names = treg.load_task_model_from_builder(
      dm_suite.build_humanoid, dtype=torch.float64, device="cpu")
  snap, sspec, sparams, snames = treg.load_task_model(
      "humanoid", dtype=torch.float64, device="cpu")
  for f in dataclasses.fields(fresh):
    if f.name == "opt":
      for g in dataclasses.fields(fresh.opt):
        _same(g.name, getattr(fresh.opt, g.name), getattr(snap.opt, g.name),
              1e-6)
    else:
      _same(f.name, getattr(fresh, f.name), getattr(snap, f.name), 1e-6)
  assert (spec, names) == (sspec, snames)
  for f in dataclasses.fields(params):
    _same(f.name, getattr(params, f.name), getattr(sparams, f.name), 1e-6)


def test_humanoid_task_matches_jax_task(tasks):
  t, j = tasks
  assert (t.spec.names, t.spec.norm_types, t.spec.dims) == (
      j.spec.names, j.spec.norm_types, j.spec.dims)
  assert t.param_names == j.param_names
  for f in ("weights", "norm_params", "risk", "residual_params"):
    _same(f, getattr(t.params, f), np.asarray(getattr(j.params, f)), 1e-6)
  stand = treg.get_task("Humanoid Stand", device="cpu")
  _same("stand residual_params", stand.params.residual_params,
        np.asarray(jreg.get_task("Humanoid Stand",
                                 dtype=jnp.float32).params.residual_params),
        1e-6)


def test_humanoid_extract_matches_jax(tile_models):
  ours, theirs = tile_models
  assert (ours.nq, ours.nv, ours.nu, ours.nbody, ours.njnt) == (
      28, 27, 21, 17, 22)
  assert (ours.ncon, ours.ncon_rows, ours.nlim, ours.nrow) == (
      theirs.ncon, theirs.ncon_rows, theirs.nlim, theirs.nrow) == (
          37, 71, 46, 117)
  for f in dataclasses.fields(ours):
    if f.name != "con_points":
      _same(f.name, getattr(ours, f.name), getattr(theirs, f.name), 1e-6)
  assert len(ours.con_points) == len(theirs.con_points)
  for i, (a, b) in enumerate(zip(ours.con_points, theirs.con_points)):
    for f in dataclasses.fields(a):
      _same(f"con_points[{i}].{f.name}", getattr(a, f.name),
            getattr(b, f.name), 1e-6)
  kinds = tts.row_kinds(ours)
  assert [kinds.count(k) for k in _KINDS] == [48, 3, 20, 42, 4]


@pytest.fixture(scope="module")
def jax_run(tasks, tile_models, tmp_path_factory):
  """One JAX rollout for the one-step checks and the returns check
  (tests/test_torch_tilestep_classes.py::jax_probe_and_returns), once a
  session."""
  t, j = tasks
  _, jtm = tile_models
  return shared_probe_and_returns(
      tmp_path_factory, "humanoid", j, jtm, thum.probe_states(t.model, B),
      *_returns_inputs(t), 0.1, None)


@pytest.fixture(scope="module")
def two_steps(tasks, tile_models, jax_run):
  """A cold step, then a warm-started one, in both packages, and the
  port's in float64 (the rounding witness)."""
  t, _ = tasks
  ttm, _ = tile_models
  probe = thum.probe_states(t.model, B)
  return [(v.qpos, v.qvel, v, jq, jv, jview, v64)
          for v, v64, (jq, jv, jview) in zip(
              port_steps(ttm, probe), port_steps(ttm, probe, torch.float64),
              jax_run[0])]


@pytest.mark.parametrize("which", ["cold", "warm"])
def test_humanoid_step_matches_jax(tile_models, two_steps, which):
  ttm, _ = tile_models
  tq, tv, tview, jq, jv, jview, view64 = two_steps[
      ("cold", "warm").index(which)]
  jl = np.asarray(jview.efc_lambda)
  kinds = np.asarray(tts.row_kinds(ttm))
  for kind in _KINDS:  # every row class carries force in some state
    assert np.abs(tview.efc_lambda.numpy()[kinds == kind]).max() > 0, kind
  scale = float(np.abs(jl).max())
  within_rounding(tq, jq, view64.qpos, 2e-5, "qpos")
  within_rounding(tv, jv, view64.qvel, 2e-4, "qvel")
  np.testing.assert_allclose(tview.efc_lambda.numpy(), jl,
                             atol=1e-4 * scale)
  for name in ("xpos", "xmat", "xipos", "cvel", "subtree_com"):
    within_rounding(getattr(tview, name), getattr(jview, name),
                    getattr(view64, name), 2e-4, name)
  # free joint: the integrated quaternion stays unit
  np.testing.assert_allclose(np.linalg.norm(tq.numpy()[3:7], axis=0), 1.0,
                             atol=1e-6)


def test_humanoid_residual_matches_jax(tasks, two_steps):
  """The port's residual on a StepView carried across from the JAX view
  (the mocap and userdata operands, which the JAX step leaves None
  without a mocap body, from the port's view)."""
  t, j = tasks
  tview, jview = two_steps[0][2], two_steps[0][5]
  fields = {f.name: getattr(tview, f.name) if getattr(jview, f.name) is None
            else torch.tensor(np.asarray(getattr(jview, f.name)))
            for f in dataclasses.fields(tts.StepView) if f.name != "time"}
  ours = thum.residual(t.model, tts.StepView(**fields),
                       t.params.residual_params)
  theirs = j.residual(j.model, jview, j.params.residual_params)
  assert ours.shape == (57, B)
  np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5)


def _returns_inputs(t):
  """The returns check's start state, velocities and N candidates, one of
  them diverging."""
  rng = np.random.RandomState(3)
  home = np.asarray(t.model.keyframe("home")[0], np.float32)
  qvel0 = rng.uniform(-0.2, 0.2, 27).astype(np.float32)
  acts = (0.3 * rng.randn(N, T, 21)).astype(np.float32)
  acts[5] = 1e30  # a diverging candidate
  return home, qvel0, acts


def test_humanoid_returns_match_jax(tasks, jax_run):
  """The port's CPU MegaRollout against the JAX composition (step_tb, the
  humanoid residual and cost_value_t per step)."""
  t, _ = tasks
  home, qvel0, acts = _returns_inputs(t)
  got = tmr.MegaRollout(t, T, device="cpu").returns(
      torch.tensor(home), torch.tensor(qvel0), torch.tensor(acts), t.params,
      0.1).numpy()
  want = jax_run[1]
  assert got[5] == want[5] == tmr.MAX_RETURN
  np.testing.assert_allclose(got, want, rtol=2e-3)
  assert np.all(np.isfinite(got))


@one_torch_thread()
def test_humanoid_agent_plans_on_cpu():
  """Two plan iterations at a fixed state at the agent's dt 0.015: finite,
  and the best return does not rise (candidate 0 is the previous
  winner)."""
  agent = Agent("Humanoid Walk", device="cpu", horizon_steps=4)
  assert float(agent.task.model.opt.timestep) == pytest.approx(0.015)
  assert tsampling.SamplingConfig.from_task(agent.task).horizon == 33
  agent.reset("home")
  assert agent.data.qpos.shape == (28,) and agent.data.qvel.shape == (27,)
  best = []
  for _ in range(2):
    info = agent.planner_step()
    assert info.costs.shape == (128,)
    assert bool(torch.all(torch.isfinite(info.costs)))
    best.append(float(info.best_return))
  assert best[1] <= best[0]
  u = agent.action()
  assert u.shape == (21,) and np.all(np.isfinite(u))
  assert agent.planner.mega.launches == 0  # CPU tensors: the plain version
