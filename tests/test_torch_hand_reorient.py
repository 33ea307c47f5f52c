"""Shadow (hand reorient) in the port held against the JAX package.

The same float32 inputs, made with numpy from a seed, go through both
packages, with the goal as an unnormalized mocap quaternion. The states are
hand_reorient.probe_states: every constraint row class (capsule-box,
sphere-box, torsional, joint limit) carries force in at least one of them.
The JAX reference runs eagerly, without jax.jit (compiling its Shadow tile
path takes minutes on a CPU).

Tolerances, with the errors measured on a CPU host:
  snapshot: integers exact, floats 1e-6 (measured 0);
  task and extract: integers exact, floats 1e-6 (measured 0);
  one step, cold and warm, two float32 steps, the quadruped's
    tolerances: each field per state within max(its atol, 8 times that
    state's distance of JAX's float32 step from the port's float64 one)
    (torch_cases.within_rounding; parity with JAX is tests/
    test_torch_tilestep64.py's float64 hold): qpos atol 2e-5 (measured
    1.2e-7), qvel atol 2e-4 (3.7e-5), the view fields the residual reads
    atol 2e-4 (9.5e-7, the actuator forces); duals per row class atol
    1e-4 * max|duals| (4.3e-5 of 11.7);
  residual on the same view: atol 1e-5 (measured 1.4e-6);
  returns at n = 8, T = 4: rtol 2e-3.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.agent.agent import Agent
from mujoco_mpc_torch.ops import megarollout as tmr
from mujoco_mpc_torch.physics import tilestep as tts
from mujoco_mpc_torch.planners import sampling as tsampling
from mujoco_mpc_torch.tasks import hand_reorient as thand
from mujoco_mpc_torch.tasks import registry as treg
from mujoco_mpc_tpu.physics import tilestep as jts
from mujoco_mpc_tpu.tasks import registry as jreg
from tests.test_torch_model import _same
from tests.test_torch_tilestep_classes import shared_probe_and_returns
from tests.torch_cases import (SHADOW_GOAL, one_torch_thread, port_steps,
                               step_operands, within_rounding)
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

B, N, T = 8, 8, 4
_KINDS = ("cap_box", "sphere_box", "torsional", "joint_limit")
GOAL = np.asarray(SHADOW_GOAL, np.float32)


@pytest.fixture(scope="module")
def tasks():
  return (treg.get_task("Shadow", device="cpu"),
          jreg.get_task("Shadow", dtype=jnp.float32))


@pytest.fixture(scope="module")
def tile_models(tasks):
  t, j = tasks
  return tts.extract(t.model), jts.extract(j.model)


def test_shadow_snapshot_matches_fresh_build():
  fresh, spec, params, names = treg.load_task_model_from_builder(
      thand.build_hand_reorient, dtype=torch.float64, device="cpu")
  snap, sspec, sparams, snames = treg.load_task_model(
      "hand_reorient", dtype=torch.float64, device="cpu")
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
  assert (snap.nq, snap.nv, snap.nu, snap.ntendon, snap.nmocap) == (
      31, 30, 20, 4, 1)


def test_shadow_task_matches_jax_task(tasks):
  t, j = tasks
  assert (t.spec.names, t.spec.norm_types, t.spec.dims) == (
      j.spec.names, j.spec.norm_types, j.spec.dims)
  assert t.spec.nresidual == 77
  assert t.param_names == j.param_names
  for f in ("weights", "norm_params", "risk", "residual_params"):
    _same(f, getattr(t.params, f), np.asarray(getattr(j.params, f)), 1e-6)
  _same("default_ctrl", t.default_ctrl(), np.asarray(j.default_ctrl()), 1e-6)


def test_shadow_extract_matches_jax(tile_models):
  ours, theirs = tile_models
  assert (ours.nq, ours.nv, ours.nu, ours.nbody, ours.njnt) == (
      31, 30, 20, 20, 25)
  assert (ours.ncon, ours.ntor, ours.nrow, ours.nmocap) == (
      theirs.ncon, len(theirs.tor_pts), theirs.nrow, theirs.nmocap) == (
          14, 14, 104, 1)
  assert ours.act_tendon == theirs.act_tendon
  assert [u for u, t in enumerate(ours.act_tendon) if t >= 0] == [4, 7, 10,
                                                                   14]
  for f in dataclasses.fields(ours):
    if f.name != "con_points":
      _same(f.name, getattr(ours, f.name), getattr(theirs, f.name), 1e-6)
  for i, (a, b) in enumerate(zip(ours.con_points, theirs.con_points)):
    for f in dataclasses.fields(a):
      _same(f"con_points[{i}].{f.name}", getattr(a, f.name),
            getattr(b, f.name), 1e-6)
  assert {cp.condim for cp in ours.con_points} == {4}
  kinds = tts.row_kinds(ours)
  assert [kinds.count(k) for k in _KINDS] == [30, 12, 14, 48]


@pytest.fixture(scope="module")
def jax_run(tasks, tile_models, tmp_path_factory):
  """One JAX rollout for the one-step checks and the returns check
  (tests/test_torch_tilestep_classes.py::jax_probe_and_returns), once a
  session."""
  t, j = tasks
  _, jtm = tile_models
  return shared_probe_and_returns(
      tmp_path_factory, "hand_reorient", j, jtm,
      thand.probe_states(t.model, B), *_returns_inputs(t), 0.1,
      step_operands(t))


@pytest.fixture(scope="module")
def two_steps(tasks, tile_models, jax_run):
  """A cold step, then a warm-started one, in both packages, and the
  port's in float64 (the rounding witness)."""
  t, _ = tasks
  ttm, _ = tile_models
  probe, ops = thand.probe_states(t.model, B), step_operands(t)
  return [(v.qpos, v.qvel, v, jq, jv, jview, v64)
          for v, v64, (jq, jv, jview) in zip(
              port_steps(ttm, probe, ops=ops),
              port_steps(ttm, probe, torch.float64, ops), jax_run[0])]


@pytest.mark.parametrize("which", ["cold", "warm"])
def test_shadow_step_matches_jax(tile_models, two_steps, which):
  ttm, _ = tile_models
  tq, tv, tview, jq, jv, jview, view64 = two_steps[
      ("cold", "warm").index(which)]
  jl = np.asarray(jview.efc_lambda)
  lam = tview.efc_lambda.numpy()
  kinds = np.asarray(tts.row_kinds(ttm))
  scale = float(np.abs(jl).max())
  for kind in _KINDS:  # every row class carries force in some state
    assert np.abs(lam[kinds == kind]).max() > 0, kind
    np.testing.assert_allclose(lam[kinds == kind], jl[kinds == kind],
                               atol=1e-4 * scale, err_msg=kind)
  within_rounding(tq, jq, view64.qpos, 2e-5, "qpos")
  within_rounding(tv, jv, view64.qvel, 2e-4, "qvel")
  for name in ("xpos", "xquat", "xmat", "site_xpos", "actuator_force",
               "mocap_quat"):
    within_rounding(getattr(tview, name), getattr(jview, name),
                    getattr(view64, name), 2e-4, name)


def test_shadow_residual_matches_jax(tasks, two_steps):
  """The port's residual on a StepView carried across from the JAX view."""
  t, j = tasks
  jview = types.SimpleNamespace(**vars(two_steps[1][5]))
  jview.time = jnp.float32(0.3)
  fields = {f.name: torch.tensor(np.asarray(getattr(jview, f.name)))
            for f in dataclasses.fields(tts.StepView)}
  view = tts.StepView(**fields)
  ours = thand.residual(t.model, view, t.params.residual_params)
  theirs = j.residual(j.model, jview, j.params.residual_params)
  assert ours.shape == (77, B)
  np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-5)


def _returns_inputs(t):
  """The returns check's start state, velocities and N candidates."""
  rng = np.random.RandomState(3)
  home = np.asarray(t.model.keyframe("home")[0], np.float32)
  qvel0 = rng.uniform(-0.2, 0.2, 30).astype(np.float32)
  acts = (np.asarray(t.default_ctrl()) + 0.2 * rng.randn(N, T, 20)
          ).astype(np.float32)
  return home, qvel0, acts


def test_shadow_returns_match_jax(tasks, jax_run):
  """The port's CPU MegaRollout against the JAX composition, with the
  goal."""
  t, _ = tasks
  home, qvel0, acts = _returns_inputs(t)
  got = tmr.MegaRollout(t, T, device="cpu").returns(
      torch.tensor(home), torch.tensor(qvel0), torch.tensor(acts), t.params,
      0.1, *(torch.tensor(x[..., 0]) for x in step_operands(t))).numpy()
  want = jax_run[1]
  assert np.all(np.isfinite(got)) and np.all(got < tmr.MAX_RETURN)
  np.testing.assert_allclose(got, want, rtol=2e-3)


@one_torch_thread()
def test_shadow_agent_plans_on_cpu():
  """Two plan iterations at a fixed state with the goal set through
  set_state: finite, and the best return does not rise (candidate 0 is the
  previous winner). The Agent's defaults are 60 x 25 at agent_timestep
  0.01."""
  agent = Agent("Shadow", device="cpu", horizon_steps=4)
  assert float(agent.task.model.opt.timestep) == pytest.approx(0.01)
  cfg = tsampling.SamplingConfig.from_task(agent.task)
  assert (cfg.num_trajectories, cfg.horizon) == (60, 25)
  agent.reset("home")
  agent.set_state(mocap_quat=GOAL)
  np.testing.assert_array_equal(agent.get_state()["mocap_quat"], GOAL)
  best = []
  for _ in range(2):
    info = agent.planner_step()
    assert info.costs.shape == (60,)
    assert bool(torch.all(torch.isfinite(info.costs)))
    best.append(float(info.best_return))
  assert best[1] <= best[0]
  u = agent.action()
  assert u.shape == (20,) and np.all(np.isfinite(u))
  assert agent.planner.mega.launches == 0  # CPU tensors: the plain version
