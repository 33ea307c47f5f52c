"""The CUDA kernel (csrc/megarollout.cu) against its plain PyTorch version.

Needs an NVIDIA GPU (sm_90a) and nvcc; every test skips without a card.
On the card: python -m pytest tests/test_torch_megarollout_cuda.py -q

Tolerances as in tests/test_torch_tilestep.py: one Walker step qpos atol
1e-6, qvel atol 1e-4, duals atol 1e-5 * max|duals|; one Humanoid or
Quadruped step qpos atol 1e-5, qvel atol 1e-3, duals atol 1e-4 * max|duals|
(18-30 dofs and 90-117 rows carry more f32 rounding); returns rtol 2e-3. The kernel's float64
instance against the plain version in float64, as in
tests/test_torch_kernel_host.py: step qpos atol 1e-12, qvel 1e-10, duals
1e-12 * max|duals|; returns over 30 steps rtol 1e-9. The CEM planner's
elite update from the kernel's returns against the same update on the CPU
at atol 1e-6. The handover, Allegro (the large size tier) and the small
class models (from their snapshots) as the Quadruped.
"""

import numpy as np
import pytest
import torch

from mujoco_mpc_torch.agent.agent import Agent
from mujoco_mpc_torch.ops import megarollout as tmr
from mujoco_mpc_torch.physics import tilestep as tts
from mujoco_mpc_torch.planners import cross_entropy as tcem
from mujoco_mpc_torch.tasks import allegro as tall
from mujoco_mpc_torch.tasks import bimanual as tbim
from mujoco_mpc_torch.tasks import class_models
from mujoco_mpc_torch.tasks import hand_reorient as thand
from mujoco_mpc_torch.tasks import humanoid as thum
from mujoco_mpc_torch.tasks import quadruped as tquad
from mujoco_mpc_torch.tasks import registry as treg
from tests.torch_cases import (HANDOVER_TARGET, QUADRUPED_MODES,
                               SHADOW_GOAL, quadruped_mode)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def walker():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device and nvcc")
  dev = torch.device("cuda")
  return treg.get_task("Walker", device=dev), dev


def _feet_only(task):
  """Walker with only the feet colliding: nrow 24, the dense branch."""
  feet = (task.model.geom("right_foot"), task.model.geom("left_foot"))
  pairs = tuple(p for p in task.model.collision_pairs if p[1] in feet)
  return task.replace(model=task.model.replace(collision_pairs=pairs))


def _states(dev, b, seed=1):
  rng = np.random.RandomState(seed)
  home = np.asarray(treg.get_task("Walker", device="cpu").model
                    .keyframe("home")[0])
  qp = (home + rng.uniform(-0.05, 0.05, (b, 9))).astype(np.float32)
  qp[:, 0] -= 0.03
  qv = rng.uniform(-0.5, 0.5, (b, 9)).astype(np.float32)
  ct = rng.uniform(-1.0, 1.0, (b, 6)).astype(np.float32)
  return [torch.tensor(x.T.copy(), device=dev) for x in (qp, qv, ct)]


@pytest.mark.parametrize("dense", [False, True])
def test_step_matches_plain(walker, dense):
  task, dev = walker
  task = _feet_only(task) if dense else task
  mr = tmr.MegaRollout(task, 1, device=dev)
  assert tts.amat_is_dense(mr.tm.nrow) == dense
  q, v, c = _states(dev, 96)
  kq, kv, kl = q, v, None
  pq, pv, pl = q, v, None
  for _ in range(2):  # cold, then warm-started
    kq, kv, kl = mr.step(kq, kv, c, kl)
    pq, pv, view = tts.step_tb(mr.tm, pq, pv, c, pl)
    pl = view.efc_lambda
    torch.cuda.synchronize()
    scale = float(pl.abs().max())
    assert scale > 1.0
    torch.testing.assert_close(kq, pq, atol=1e-6, rtol=0)
    torch.testing.assert_close(kv, pv, atol=1e-4, rtol=0)
    torch.testing.assert_close(kl, pl, atol=1e-5 * scale, rtol=0)
  assert mr.step_launches == 2 and mr.launches == 0


@pytest.mark.parametrize("dense", [False, True])
def test_returns_match_plain(walker, dense):
  task, dev = walker
  task = _feet_only(task) if dense else task
  n, horizon = 100, 8  # n not a multiple of the block: ragged edge
  mr = tmr.MegaRollout(task, horizon, device=dev)
  acts = torch.tensor(0.4 * np.random.RandomState(0).randn(n, horizon, 6),
                      dtype=torch.float32, device=dev)
  acts[5] = 1e30
  q0 = torch.tensor(task.model.keyframe("home")[0], device=dev)
  v0 = torch.zeros(9, device=dev)
  t0 = torch.tensor(0.75, device=dev)  # a runtime operand, as on the CPU
  got = mr.returns(q0, v0, acts, task.params, t0)
  want = mr.returns_plain(q0, v0, acts, task.params, t0)
  got_f = mr.returns(q0, v0, acts, task.params, 0.75)
  torch.cuda.synchronize()
  assert mr.launches == 2
  torch.testing.assert_close(got_f, got, rtol=0, atol=0)
  assert float(got[5]) == float(want[5]) == tmr.MAX_RETURN
  torch.testing.assert_close(got, want, rtol=2e-3, atol=0)
  heavier = task.params.replace(weights=task.params.weights * 3.0)
  got3 = mr.returns(q0, v0, acts, heavier, t0)
  keep = torch.arange(n, device=dev) != 5
  torch.testing.assert_close(got3[keep], 3.0 * got[keep], rtol=1e-5, atol=0)


@pytest.mark.parametrize("n", [1, 33, 257])
def test_returns_at_block_edges(walker, n):
  """Candidate counts that leave the last block of W warps part-filled:
  every candidate's return against the plain version (rtol 2e-3), a
  diverging last candidate held at MAX_RETURN, and a geometry that
  covers the SMs (at 257 candidates at least 128 of them, on a card with
  132)."""
  task, dev = walker
  horizon = 8
  mr = tmr.MegaRollout(task, horizon, device=dev)
  acts = torch.tensor(0.4 * np.random.RandomState(3).randn(n, horizon, 6),
                      dtype=torch.float32, device=dev)
  acts[-1] = 1e30
  q0 = torch.tensor(task.model.keyframe("home")[0], device=dev)
  v0 = torch.zeros(9, device=dev)
  got = mr.returns(q0, v0, acts, task.params, 0.5)
  want = mr.returns_plain(q0, v0, acts, task.params, 0.5)
  torch.cuda.synchronize()
  assert float(got[-1]) == float(want[-1]) == tmr.MAX_RETURN
  torch.testing.assert_close(got, want, rtol=2e-3, atol=0)
  geo = mr.geometry(n)
  w = geo["warps_per_block"]
  assert (geo["blocks"] - 1) * w < n <= geo["blocks"] * w
  assert geo["blocks_per_sm"] >= 1  # the runtime's occupancy reading
  sms = torch.cuda.get_device_properties(dev).multi_processor_count
  if n == 257:
    assert geo["sms_in_use"] >= min(128, sms)


def test_wrapper_checks_inputs(walker):
  task, dev = walker
  mr = tmr.MegaRollout(task, 4, device=dev)
  q0 = torch.tensor(task.model.keyframe("home")[0], device=dev)
  acts = torch.zeros((8, 4, 6), device=dev)
  with pytest.raises(ValueError, match="float32"):
    mr.returns(q0.double(), torch.zeros(9, device=dev), acts, task.params,
               0.0)
  with pytest.raises(ValueError, match="shape"):
    mr.returns(q0, torch.zeros(9, device=dev), acts[:, :3], task.params,
               0.0)
  with pytest.raises(ValueError, match="built for cpu"):
    tmr.MegaRollout(task, 4, device="cpu").returns(
        q0, torch.zeros(9, device=dev), acts, task.params, 0.0)
  assert mr.launches == 0


@pytest.fixture(scope="module")
def humanoid():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device and nvcc")
  dev = torch.device("cuda")
  return treg.get_task("Humanoid Walk", device=dev), dev


def test_humanoid_step_matches_plain(humanoid):
  """Free joint, plane-sphere, capsule-capsule (condim 1) and tendon-limit
  rows, each carrying force in some of the states."""
  task, dev = humanoid
  mr = tmr.MegaRollout(task, 1, device=dev)
  assert mr.tm.nrow == 117 and not tts.amat_is_dense(mr.tm.nrow)
  kinds = np.array(tts.row_kinds(mr.tm))
  q, v, c = (torch.tensor(x, device=dev)
             for x in thum.probe_states(task.model, 72))
  kq, kv, kl = q, v, None
  pq, pv, pl = q, v, None
  for _ in range(2):  # cold, then warm-started
    kq, kv, kl = mr.step(kq, kv, c, kl)
    pq, pv, view = tts.step_tb(mr.tm, pq, pv, c, pl)
    pl = view.efc_lambda
    torch.cuda.synchronize()
    lam = pl.abs().cpu().numpy()
    for kind in set(kinds):
      assert lam[kinds == kind].max() > 0.0, kind
    scale = float(lam.max())
    torch.testing.assert_close(kq, pq, atol=1e-5, rtol=0)
    torch.testing.assert_close(kv, pv, atol=1e-3, rtol=0)
    torch.testing.assert_close(kl, pl, atol=1e-4 * scale, rtol=0)
  assert mr.step_launches == 2


def test_humanoid_returns_match_plain(humanoid):
  task, dev = humanoid
  n, horizon = 70, 6
  mr = tmr.MegaRollout(task, horizon, device=dev)
  acts = torch.tensor(0.3 * np.random.RandomState(2).randn(n, horizon, 21),
                      dtype=torch.float32, device=dev)
  acts[3] = 1e30
  q0 = torch.tensor(task.model.keyframe("home")[0], device=dev)
  v0 = torch.zeros(27, device=dev)
  got = mr.returns(q0, v0, acts, task.params, 0.3)
  want = mr.returns_plain(q0, v0, acts, task.params, 0.3)
  torch.cuda.synchronize()
  assert mr.launches == 1
  assert float(got[3]) == float(want[3]) == tmr.MAX_RETURN
  torch.testing.assert_close(got, want, rtol=2e-3, atol=0)


def test_humanoid_float64_step_matches_plain(humanoid):
  task, dev = humanoid
  mr = tmr.MegaRollout(task, 1, device=dev)
  q, v, c = (torch.tensor(x, device=dev, dtype=torch.float64)
             for x in thum.probe_states(task.model, 72))
  kq, kv, kl = mr.step(q, v, c)
  pq, pv, view = tts.step_tb(mr.tm, q, v, c)
  torch.cuda.synchronize()
  assert kq.dtype == torch.float64
  scale = float(view.efc_lambda.abs().max())
  torch.testing.assert_close(kq, pq, atol=1e-12, rtol=0)
  torch.testing.assert_close(kv, pv, atol=1e-10, rtol=0)
  torch.testing.assert_close(kl, view.efc_lambda, atol=1e-12 * scale, rtol=0)


def test_humanoid_float64_returns_match_plain(humanoid):
  task, dev = humanoid
  n, horizon = 70, 30
  mr = tmr.MegaRollout(task, horizon, device=dev)
  acts = torch.tensor(0.3 * np.random.RandomState(2).randn(n, horizon, 21),
                      dtype=torch.float64, device=dev)
  acts[3] = 1e300
  q0 = torch.tensor(task.model.keyframe("home")[0], device=dev).double()
  v0 = torch.zeros(27, device=dev, dtype=torch.float64)
  params = task.params.to(dtype=torch.float64)
  got = mr.returns(q0, v0, acts, params, 0.3)
  want = mr.returns_plain(q0, v0, acts, params, 0.3, dtype=torch.float64)
  torch.cuda.synchronize()
  assert got.dtype == torch.float64 and mr.launches == 1
  assert float(got[3]) == float(want[3]) == tmr.MAX_RETURN
  torch.testing.assert_close(got, want, rtol=1e-9, atol=0)


@pytest.fixture(scope="module")
def quadruped():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device and nvcc")
  dev = torch.device("cuda")
  return treg.get_task("Quadruped Flat", device=dev), dev


def _quadruped_operands(task, dev, dtype=torch.float32, userdata=None):
  """The goal mocap at (1.0, 0.3, 0.3) and a trot's userdata, as
  MegaRollout takes them."""
  u = tquad.fsm_userdata(task.model.nuserdata) if userdata is None \
      else userdata
  return dict(
      mocap_pos=torch.tensor([[1.0, 0.3, 0.3]], dtype=dtype, device=dev),
      mocap_quat=torch.tensor([[1.0, 0.0, 0.0, 0.0]], dtype=dtype,
                              device=dev),
      userdata=torch.tensor(u, dtype=dtype, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_quadruped_step_matches_plain(quadruped, dtype):
  """Plane-box corner, sphere-sphere and sphere-box rows and the mocap
  goal, each row class carrying force in some of the states."""
  task, dev = quadruped
  mr = tmr.MegaRollout(task, 1, device=dev)
  assert mr.tm.nrow == 90 and mr.tm.nmocap == 1
  kinds = np.array(tts.row_kinds(mr.tm))
  ops = _quadruped_operands(task, dev, dtype)
  q, v, c = (torch.tensor(x, device=dev, dtype=dtype)
             for x in tquad.probe_states(task.model, 72))
  tq, tv, tl = (1e-5, 1e-3, 1e-4) if dtype == torch.float32 else (
      1e-12, 1e-10, 1e-12)
  kq, kv, kl = q, v, None
  pq, pv, pl = q, v, None
  for _ in range(2):  # cold, then warm-started
    kq, kv, kl = mr.step(kq, kv, c, kl, **ops)
    pq, pv, view = tts.step_tb(mr.tm, pq, pv, c, pl, **ops)
    pl = view.efc_lambda
    torch.cuda.synchronize()
    lam = pl.abs().cpu().numpy()
    for kind in set(kinds):
      assert lam[kinds == kind].max() > 0.0, kind
    scale = float(lam.max())
    torch.testing.assert_close(kq, pq, atol=tq, rtol=0)
    torch.testing.assert_close(kv, pv, atol=tv, rtol=0)
    torch.testing.assert_close(kl, pl, atol=tl * scale, rtol=0)
  assert mr.step_launches == 2


@pytest.mark.parametrize("case", sorted(QUADRUPED_MODES))
def test_quadruped_returns_match_plain(quadruped, case):
  """Each residual branch: float32 over 6 steps at rtol 2e-3, float64 over
  30 at rtol 1e-9, with the goal and the mode's userdata."""
  task, dev = quadruped
  u, params = quadruped_mode(task, case)
  n = 70
  q0 = torch.tensor(task.model.keyframe("home")[0], device=dev)
  for dtype, horizon, rtol in ((torch.float32, 6, 2e-3),
                               (torch.float64, 30, 1e-9)):
    mr = tmr.MegaRollout(task, horizon, device=dev)
    acts = (task.default_ctrl().to(dtype) + torch.tensor(
        0.3 * np.random.RandomState(2).randn(n, horizon, 12), dtype=dtype,
        device=dev)).contiguous()
    ops = _quadruped_operands(task, dev, dtype, u)
    p = params.to(dtype=dtype)
    args = (q0.to(dtype), torch.zeros(18, device=dev, dtype=dtype), acts, p,
            0.25)
    got = mr.returns(*args, **ops)
    want = mr.returns_plain(*args, dtype=dtype, **ops)
    torch.cuda.synchronize()
    assert mr.launches == 1
    assert bool(torch.all(want < tmr.MAX_RETURN))
    torch.testing.assert_close(got, want, rtol=rtol, atol=0)


def test_quadruped_wrapper_checks_operands(quadruped):
  task, dev = quadruped
  mr = tmr.MegaRollout(task, 2, device=dev)
  q0 = torch.tensor(task.model.keyframe("home")[0], device=dev)
  acts = torch.zeros((8, 2, 12), device=dev)
  ops = _quadruped_operands(task, dev)
  with pytest.raises(ValueError, match="userdata"):
    mr.returns(q0, torch.zeros(18, device=dev), acts, task.params, 0.0,
               **{**ops, "userdata": ops["userdata"][:16]})
  with pytest.raises(ValueError, match="mocap_pos"):
    mr.returns(q0, torch.zeros(18, device=dev), acts, task.params, 0.0,
               **{**ops, "mocap_pos": ops["mocap_pos"].double()})
  assert mr.launches == 0


@pytest.fixture(scope="module")
def shadow():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device and nvcc")
  dev = torch.device("cuda")
  return treg.get_task("Shadow", device=dev), dev


def _shadow_operands(dev, dtype=torch.float32):
  return dict(mocap_quat=torch.tensor(SHADOW_GOAL, dtype=dtype, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_shadow_step_matches_plain(shadow, dtype):
  """Tendon-driven fingers, capsule-box and sphere-box points with their
  torsional rows, joint limits: each row class carrying force in some of
  the states."""
  task, dev = shadow
  mr = tmr.MegaRollout(task, 1, device=dev)
  assert mr.tm.nrow == 104 and mr.tm.ntor == 14
  kinds = np.array(tts.row_kinds(mr.tm))
  ops = _shadow_operands(dev, dtype)
  q, v, c = (torch.tensor(x, device=dev, dtype=dtype)
             for x in thand.probe_states(task.model, 72))
  tq, tv, tl = (1e-5, 1e-3, 1e-4) if dtype == torch.float32 else (
      1e-12, 1e-10, 1e-12)
  kq, kv, kl = q, v, None
  pq, pv, pl = q, v, None
  for _ in range(2):  # cold, then warm-started
    kq, kv, kl = mr.step(kq, kv, c, kl, **ops)
    pq, pv, view = tts.step_tb(mr.tm, pq, pv, c, pl, **ops)
    pl = view.efc_lambda
    torch.cuda.synchronize()
    lam = pl.abs().cpu().numpy()
    for kind in set(kinds):
      assert lam[kinds == kind].max() > 0.0, kind
    scale = float(lam.max())
    torch.testing.assert_close(kq, pq, atol=tq, rtol=0)
    torch.testing.assert_close(kv, pv, atol=tv, rtol=0)
    torch.testing.assert_close(kl, pl, atol=tl * scale, rtol=0)
  assert mr.step_launches == 2


def test_shadow_returns_match_plain(shadow):
  """float32 over 6 steps at rtol 2e-3, float64 over 30 at rtol 1e-9, with
  the goal quaternion as an operand."""
  task, dev = shadow
  n = 70
  q0 = torch.tensor(task.model.keyframe("home")[0], device=dev)
  for dtype, horizon, rtol in ((torch.float32, 6, 2e-3),
                               (torch.float64, 30, 1e-9)):
    mr = tmr.MegaRollout(task, horizon, device=dev)
    acts = (task.default_ctrl().to(dtype) + torch.tensor(
        0.2 * np.random.RandomState(2).randn(n, horizon, 20), dtype=dtype,
        device=dev)).contiguous()
    args = (q0.to(dtype), torch.zeros(30, device=dev, dtype=dtype), acts,
            task.params.to(dtype=dtype), 0.1)
    ops = _shadow_operands(dev, dtype)
    got = mr.returns(*args, **ops)
    want = mr.returns_plain(*args, dtype=dtype, **ops)
    torch.cuda.synchronize()
    assert mr.launches == 1
    assert bool(torch.all(want < tmr.MAX_RETURN))
    torch.testing.assert_close(got, want, rtol=rtol, atol=0)


@pytest.mark.parametrize("name", ["Walker", "Shadow"])
def test_cem_plans_through_the_kernel(name):
  """Agent(planner="cross_entropy"): one launch per plan, and the new
  policy is the elite update of the kernel's returns computed on the
  CPU."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device and nvcc")
  agent = Agent(name, planner="cross_entropy", device="cuda")
  agent.reset("home")
  assert isinstance(agent.planner, tcem.CrossEntropyPlanner)
  for i in range(3):
    policy = agent.policy
    gen_state = agent.generator.get_state()
    info = agent.planner_step()
    assert agent.planner.mega.launches == i + 1
    pl, cfg = agent.planner, agent.planner.config
    agent.generator.set_state(gen_state)
    _, _, cands = pl._gen_candidates(agent.task, policy, agent.data,
                                     agent.generator)
    _, mean, std = tcem.elite_update(cands.cpu(), info.costs.cpu(),
                                     cfg.n_elite, cfg.std_min)
    torch.testing.assert_close(agent.policy.values.cpu(), mean, atol=1e-6,
                               rtol=0)
    torch.testing.assert_close(agent.policy.std.cpu(), std, atol=1e-6,
                               rtol=0)


@pytest.fixture(scope="module")
def handover():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device and nvcc")
  dev = torch.device("cuda")
  return treg.get_task("Bimanual Handover", device=dev), dev


def _handover_operands(dev, dtype=torch.float32):
  return dict(mocap_pos=torch.tensor(HANDOVER_TARGET, dtype=dtype,
                                     device=dev))


def _check_two_steps(mr, q, v, c, ops, dtype, every_kind=True):
  """A cold step, then a warm-started one, kernel against step_tb: every
  row class carries force (unless every_kind is False); float32 qpos 1e-5, qvel max(1e-3, 8 x the
  state's own plain float32-vs-float64 distance) (chip_smoke.py's
  probe_step: the pinched box spins at up to 16 rad/s, where contracted
  multiply-adds move qvel by 1e-3), duals 1e-4 * max; float64 1e-12,
  1e-10, 1e-12 * max."""
  kinds = np.array(tts.row_kinds(mr.tm))
  tq, tv, tl = (1e-5, 1e-3, 1e-4) if dtype == torch.float32 else (
      1e-12, 1e-10, 1e-12)
  ops64 = {k: x.double() for k, x in ops.items()}
  kq, kv, kl = q, v, None
  pq, pv, pl = q, v, None
  wq, wv, wl = q.double(), v.double(), None  # the plain version in float64
  for _ in range(2):
    kq, kv, kl = mr.step(kq, kv, c, kl, **ops)
    pq, pv, view = tts.step_tb(mr.tm, pq, pv, c, pl, **ops)
    pl = view.efc_lambda
    wq, wv, wview = tts.step_tb(mr.tm, wq, wv, c.double(), wl, **ops64)
    wl = wview.efc_lambda
    torch.cuda.synchronize()
    lam = pl.cpu().numpy()
    for kind in set(kinds) if every_kind else ():
      assert np.abs(lam[kinds == kind]).max() > 0.0, kind
    scale = float(np.abs(lam).max())
    torch.testing.assert_close(kq, pq, atol=tq, rtol=0)
    noise = (pv.double() - wv).abs().amax(0)
    err = (kv - pv).abs().amax(0).double()
    assert bool(torch.all(err <= torch.clamp(8.0 * noise, min=tv))), (
        float(err.max()), float((err / noise).max()))
    torch.testing.assert_close(kl, pl, atol=tl * scale, rtol=0)
  assert mr.step_launches == 2
  return lam, kinds


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_handover_step_matches_plain(handover, dtype):
  """Condim-6 plane-box corner and capsule-box points with their torsional
  and rolling rows, joint limits and the fingers' joint equalities, each
  row class carrying force in some of the states, the equality rows both
  ways."""
  task, dev = handover
  mr = tmr.MegaRollout(task, 1, device=dev)
  assert (mr.tm.nrow, mr.tm.nroll, mr.tm.neq_rows) == (130, 16, 2)
  q, v, c = (torch.tensor(x, device=dev, dtype=dtype)
             for x in tbim.probe_states(task.model, 72))
  lam, kinds = _check_two_steps(mr, q, v, c, _handover_operands(dev, dtype),
                                dtype)
  eq = lam[kinds == "eq_joint"]
  assert eq.min() < 0.0 < eq.max()


def test_handover_returns_match_plain(handover):
  """float32 over 6 steps at rtol 2e-3, float64 over 30 at rtol 1e-9,
  from a handover (both grippers pinching the box, probe state 1) with the
  target as an operand: the grasp term reads the contact view."""
  task, dev = handover
  n = 70
  q0 = torch.tensor(tbim.probe_states(task.model, 2)[0][:, 1], device=dev)
  for dtype, horizon, rtol in ((torch.float32, 6, 2e-3),
                               (torch.float64, 30, 1e-9)):
    mr = tmr.MegaRollout(task, horizon, device=dev)
    acts = (task.default_ctrl().to(dtype) + torch.tensor(
        0.2 * np.random.RandomState(2).randn(n, horizon, 16), dtype=dtype,
        device=dev)).contiguous()
    args = (q0.to(dtype), torch.zeros(22, device=dev, dtype=dtype), acts,
            task.params.to(dtype=dtype), 0.1)
    ops = _handover_operands(dev, dtype)
    got = mr.returns(*args, **ops)
    want = mr.returns_plain(*args, dtype=dtype, **ops)
    torch.cuda.synchronize()
    assert mr.launches == 1
    assert bool(torch.all(want < tmr.MAX_RETURN))
    torch.testing.assert_close(got, want, rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["condim6_ball", "connect", "joint_equality",
                                  "weld"])
def test_class_model_step_matches_plain(name, dtype):
  """The small class models loaded from their snapshots: every equality
  kind and the condim-6 rolling rows on the card."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device and nvcc")
  dev = torch.device("cuda")
  task = class_models.task(name, device=dev)
  mr = tmr.MegaRollout(task, 1, device=dev)
  q, v, c = (torch.tensor(x, device=dev, dtype=dtype)
             for x in class_models.states(name, task.model, 72))
  _check_two_steps(mr, q, v, c, {}, dtype)


@pytest.fixture(scope="module")
def allegro():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device and nvcc")
  dev = torch.device("cuda")
  return treg.get_task("Allegro", device=dev), dev


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_allegro_step_matches_plain(allegro, dtype):
  """The large tier: box-box corners of both boxes, capsule-box and
  plane-box corner points, joint limits (nrow 144), each row class
  carrying force in some of the states."""
  task, dev = allegro
  mr = tmr.MegaRollout(task, 1, device=dev)
  assert (mr.tier.name, mr.tm.nrow, mr.tm.ncon) == ("large", 144, 40)
  q, v, c = (torch.tensor(x, device=dev, dtype=dtype)
             for x in tall.probe_states(task.model, 70))
  lam, kinds = _check_two_steps(mr, q, v, c, _shadow_operands(dev, dtype),
                                dtype)
  fric = tts.row_points(mr.tm)[0]
  for owner in (1, 2):
    rows = [3 * i for i, cp in enumerate(fric)
            if cp.kind == "boxbox_corner" and cp.owner == owner]
    assert np.abs(lam[rows]).max() > 0.0, owner


@pytest.mark.parametrize("b", [1, 33, 257])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_allegro_step_at_block_edges(allegro, dtype, b):
  """The large tier's largest registered model at candidate counts that
  leave a block of W warps part-filled (W = 2 where the launch has two
  candidates per SM): each candidate's step against the plain version at
  the tolerances of test_allegro_step_matches_plain."""
  task, dev = allegro
  mr = tmr.MegaRollout(task, 1, device=dev)
  geo = mr.geometry(b, dtype, step=True)
  w = geo["warps_per_block"]
  assert (geo["blocks"] - 1) * w < b <= geo["blocks"] * w
  q, v, c = (torch.tensor(x, device=dev, dtype=dtype)
             for x in tall.probe_states(task.model, b))
  _check_two_steps(mr, q, v, c, _shadow_operands(dev, dtype), dtype,
                   every_kind=False)
  assert mr.step_launches == 2


def test_allegro_returns_match_plain(allegro):
  """float32 over 6 steps at rtol 2e-3, float64 over 30 at rtol 1e-9,
  from the cube over a palm corner (probe state 1) with the goal
  quaternion as an operand."""
  task, dev = allegro
  n = 70
  q0 = torch.tensor(tall.probe_states(task.model, 2)[0][:, 1], device=dev)
  for dtype, horizon, rtol in ((torch.float32, 6, 2e-3),
                               (torch.float64, 30, 1e-9)):
    mr = tmr.MegaRollout(task, horizon, device=dev)
    acts = (task.default_ctrl().to(dtype) + torch.tensor(
        0.2 * np.random.RandomState(2).randn(n, horizon, 12), dtype=dtype,
        device=dev)).contiguous()
    args = (q0.to(dtype), torch.zeros(18, device=dev, dtype=dtype), acts,
            task.params.to(dtype=dtype), 0.1)
    ops = _shadow_operands(dev, dtype)
    got = mr.returns(*args, **ops)
    want = mr.returns_plain(*args, dtype=dtype, **ops)
    torch.cuda.synchronize()
    assert mr.launches == 1
    assert bool(torch.all(want < tmr.MAX_RETURN))
    torch.testing.assert_close(got, want, rtol=rtol, atol=0)


def test_tiers_build_and_match_their_mirrors():
  """Every tier's library builds in both precisions, and its struct
  matches the ctypes mirror; the small tier holds the handover, the large
  one Allegro."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device and nvcc")
  for tier in tmr.TIERS:
    for dt in (torch.float32, torch.float64):
      tmr._library(tier, dt)
  cpu = {name: treg.get_task(name, device="cpu")
         for name in ("Bimanual Handover", "Allegro")}
  assert [tmr.select_tier(tts.extract(t.model), t).name
          for t in cpu.values()] == ["small", "large"]
