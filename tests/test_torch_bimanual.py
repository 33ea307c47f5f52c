"""Bimanual Handover in the port held against the JAX package.

The same float32 inputs, made with numpy from a seed, go through both
packages, with the target as the mocap body's position. The states are
bimanual.probe_states: every constraint row class (plane-box corner,
capsule-box, torsional, rolling, joint limit, joint equality) carries force
in at least one of them, and the joint equality's duals take both signs.
The JAX reference runs eagerly, without jax.jit (compiling its tile path
takes minutes on a CPU).

Tolerances, with the errors measured on a CPU host:
  snapshot: integers exact, floats 1e-6 (measured 0);
  task and extract: integers exact, floats 1e-6 (measured 0);
  contact slots: exact;
  one step, cold and warm, two float32 steps, the Shadow's tolerances:
    each field per state within max(its atol, 8 times that state's
    distance of JAX's float32 step from the port's float64 one)
    (torch_cases.within_rounding; parity with JAX is tests/
    test_torch_tilestep64.py's float64 hold): qpos atol 2e-5 (measured
    9.1e-7), qvel atol 2e-4 (3.7e-4 after the warm step, the pinched box
    spinning at up to 103 rad/s: beyond the atol within 8 x 1.3e-4, JAX's
    float32 distance there, a margin of 2.8; 1.3e-4 after the cold one,
    a margin under 2 that the witness covers 4.6 times), the view fields
    the residual reads (frames, site frames, contact distances and
    frames) atol 2e-4 (1.1e-5, a contact frame); duals per row class
    atol 1e-4 * max|duals| (2.3e-4 of 78.5, capsule-box);
  residual on the same view, per term: atol 1e-5 (measured 0);
  returns at n = 8, T = 4: rtol 2e-3 (measured 6.9e-8).
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
from mujoco_mpc_torch.tasks import bimanual as tbim
from mujoco_mpc_torch.tasks import registry as treg
from mujoco_mpc_tpu.physics import collision as jcollision
from mujoco_mpc_tpu.physics import tilestep as jts
from mujoco_mpc_tpu.tasks import registry as jreg
from tests.test_torch_model import _same
from tests.test_torch_tilestep_classes import shared_probe_and_returns
from tests.torch_cases import (HANDOVER_TARGET, one_torch_thread,
                               port_steps, step_operands, within_rounding)
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

B, N, T = 8, 8, 4
NAME = "Bimanual Handover"
_KINDS = ("plane_boxcorner", "cap_box", "torsional", "rolling",
          "joint_limit", "eq_joint")
TARGET = np.asarray(HANDOVER_TARGET, np.float32)


@pytest.fixture(scope="module")
def tasks():
  return (treg.get_task(NAME, device="cpu"),
          jreg.get_task(NAME, dtype=jnp.float32))


@pytest.fixture(scope="module")
def tile_models(tasks):
  t, j = tasks
  return tts.extract(t.model), jts.extract(j.model)


def test_handover_snapshot_matches_fresh_build():
  fresh, spec, params, names = treg.load_task_model_from_builder(
      tbim.build_bimanual, dtype=torch.float64, device="cpu")
  snap, sspec, sparams, snames = treg.load_task_model(
      "bimanual", dtype=torch.float64, device="cpu")
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
  assert (snap.nq, snap.nv, snap.nu, snap.nmocap, snap.nuserdata) == (
      23, 22, 16, 1, 16)


def test_handover_task_matches_jax_task(tasks):
  t, j = tasks
  assert (t.spec.names, t.spec.norm_types, t.spec.dims) == (
      j.spec.names, j.spec.norm_types, j.spec.dims)
  assert t.spec.nresidual == 26
  assert t.param_names == j.param_names
  for f in ("weights", "norm_params", "risk", "residual_params"):
    _same(f, getattr(t.params, f), np.asarray(getattr(j.params, f)), 1e-6)
  _same("default_ctrl", t.default_ctrl(), np.asarray(j.default_ctrl()), 1e-6)


def test_handover_extract_matches_jax(tile_models):
  ours, theirs = tile_models
  assert (ours.nq, ours.nv, ours.nu, ours.nbody, ours.njnt) == (
      23, 22, 16, 17, 17)
  assert (ours.ncon, ours.ntor, ours.nroll, ours.neq_rows, ours.nrow) == (
      theirs.ncon, len(theirs.tor_pts), len(theirs.roll_pts),
      theirs.neq_rows, theirs.nrow) == (16, 16, 16, 2, 130)
  for f in dataclasses.fields(ours):
    if f.name not in ("con_points", "eq_rows"):
      _same(f.name, getattr(ours, f.name), getattr(theirs, f.name), 1e-6)
  for i, (a, b) in enumerate(zip(ours.con_points, theirs.con_points)):
    for f in dataclasses.fields(a):
      _same(f"con_points[{i}].{f.name}", getattr(a, f.name),
            getattr(b, f.name), 1e-6)
  assert {cp.condim for cp in ours.con_points} == {6}
  assert len(ours.eq_rows) == len(theirs.eq_rows) == 2
  for a, b in zip(ours.eq_rows, theirs.eq_rows):
    for f in dataclasses.fields(a):
      _same(f"eq_rows.{f.name}", getattr(a, f.name), getattr(b, f.name),
            1e-6)
  kinds = tts.row_kinds(ours)
  assert [kinds.count(k) for k in _KINDS] == [24, 24, 16, 32, 32, 2]


def test_handover_contact_slots_match_jax(tasks, tile_models):
  """The finger-box slots found in the port's contact points equal JAX's
  collision.geom_pair_slots over its collision pairs."""
  t, j = tasks
  ours, _ = tile_models
  slots = tbim.contact_slots(t.model,
                             [(cp.g1, cp.g2) for cp in ours.con_points])
  want = tuple(jcollision.geom_pair_slots(j.model, j.model.geom(f),
                                          j.model.geom("box_geom"))
               for f in tbim._FINGERS)
  assert slots == want == ((8, 2, 1.0), (10, 2, 1.0), (12, 2, 1.0),
                           (14, 2, 1.0))


@pytest.fixture(scope="module")
def jax_run(tasks, tile_models, tmp_path_factory):
  """One JAX rollout for the one-step checks and the returns check
  (tests/test_torch_tilestep_classes.py::jax_probe_and_returns), once a
  session."""
  t, j = tasks
  _, jtm = tile_models
  return shared_probe_and_returns(
      tmp_path_factory, "bimanual", j, jtm, tbim.probe_states(t.model, B),
      *_returns_inputs(t), 0.1, step_operands(t))


@pytest.fixture(scope="module")
def two_steps(tasks, tile_models, jax_run):
  """A cold step, then a warm-started one, in both packages, and the
  port's in float64 (the rounding witness)."""
  t, _ = tasks
  ttm, _ = tile_models
  probe, ops = tbim.probe_states(t.model, B), step_operands(t)
  return [(v.qpos, v.qvel, v, jq, jv, jview, v64)
          for v, v64, (jq, jv, jview) in zip(
              port_steps(ttm, probe, ops=ops),
              port_steps(ttm, probe, torch.float64, ops), jax_run[0])]


@pytest.mark.parametrize("which", ["cold", "warm"])
def test_handover_step_matches_jax(tile_models, two_steps, which):
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
  # the bilateral rows pull both ways
  eq = lam[kinds == "eq_joint"]
  assert eq.min() < 0 < eq.max()
  within_rounding(tq, jq, view64.qpos, 2e-5, "qpos")
  within_rounding(tv, jv, view64.qvel, 2e-4, "qvel")
  for name in ("xpos", "xmat", "site_xpos", "site_xmat", "mocap_pos"):
    within_rounding(getattr(tview, name), getattr(jview, name),
                    getattr(view64, name), 2e-4, name)
  for name in ("dist", "frame"):
    within_rounding(getattr(tview.contact, name),
                    getattr(jview.contact, name),
                    getattr(view64.contact, name), 2e-4, f"contact.{name}")


def _port_view(jview, ttm):
  """The JAX view's arrays as a port StepView, its contact view included."""
  jview = types.SimpleNamespace(**vars(jview))
  view = tts.StepView(**{
      f.name: torch.tensor(np.asarray(getattr(jview, f.name)))
      for f in dataclasses.fields(tts.StepView) if f.name != "time"})
  view.contact = tts.ContactView(
      dist=torch.tensor(np.asarray(jview.contact.dist)),
      frame=torch.tensor(np.asarray(jview.contact.frame)),
      pairs=tuple((cp.g1, cp.g2) for cp in ttm.con_points))
  return view


def test_handover_residual_matches_jax(tasks, tile_models, two_steps):
  """The port's residual on the JAX view carried across, term by term;
  the grasp term is 0 where both grippers pinch the box and 1 where no
  finger is near it."""
  t, j = tasks
  ttm, _ = tile_models
  jview = two_steps[0][5]
  ours = tbim.residual(t.model, _port_view(jview, ttm),
                       t.params.residual_params).numpy()
  theirs = np.asarray(j.residual(j.model, jview, j.params.residual_params))
  assert ours.shape == (26, B)
  shift = 0
  for name, dim in zip(t.spec.names, t.spec.dims):
    np.testing.assert_allclose(ours[shift:shift + dim],
                               theirs[shift:shift + dim], atol=1e-5,
                               err_msg=name)
    shift += dim
  grasp = ours[6]
  assert grasp.min() < 0.5 and grasp.max() == 1.0


def _returns_inputs(t):
  """The returns check's start state, velocities and N candidates."""
  rng = np.random.RandomState(3)
  home = np.asarray(t.model.keyframe("home")[0], np.float32)
  qvel0 = rng.uniform(-0.2, 0.2, 22).astype(np.float32)
  acts = (np.asarray(t.default_ctrl()) + 0.2 * rng.randn(N, T, 16)
          ).astype(np.float32)
  return home, qvel0, acts


def test_handover_returns_match_jax(tasks, jax_run):
  """The port's CPU MegaRollout against the JAX composition, with the
  target."""
  t, _ = tasks
  home, qvel0, acts = _returns_inputs(t)
  got = tmr.MegaRollout(t, T, device="cpu").returns(
      torch.tensor(home), torch.tensor(qvel0), torch.tensor(acts), t.params,
      0.1, *(torch.tensor(x[..., 0]) for x in step_operands(t))).numpy()
  want = jax_run[1]
  assert np.all(np.isfinite(got)) and np.all(got < tmr.MAX_RETURN)
  np.testing.assert_allclose(got, want, rtol=2e-3)


@one_torch_thread()
def test_handover_agent_plans_on_cpu():
  """Two plan iterations at a fixed state with the target set through
  set_state: finite, and the best return does not rise (candidate 0 is
  the previous winner). The Agent's defaults are 128 x 70 at
  agent_timestep 0.01."""
  agent = Agent(NAME, device="cpu", horizon_steps=4)
  assert float(agent.task.model.opt.timestep) == pytest.approx(0.01)
  cfg = tsampling.SamplingConfig.from_task(agent.task)
  assert (cfg.num_trajectories, cfg.horizon) == (128, 70)
  agent.reset("home")
  agent.set_state(mocap_pos=TARGET)
  np.testing.assert_array_equal(agent.get_state()["mocap_pos"], TARGET)
  best = []
  for _ in range(2):
    info = agent.planner_step()
    assert info.costs.shape == (128,)
    assert bool(torch.all(torch.isfinite(info.costs)))
    best.append(float(info.best_return))
  assert best[1] <= best[0]
  u = agent.action()
  assert u.shape == (16,) and np.all(np.isfinite(u))
  assert agent.planner.mega.launches == 0  # CPU tensors: the plain version
