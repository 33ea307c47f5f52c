"""The host build of the CUDA kernel (tests/test_torch_kernel_host.py's)
on the five flat-ground kernel tasks, against the plain version: one step
of 8 probe states (tests/torch_flat_cases.py: every row kind the search
reaches carries force), cold then warm, in float32 and float64; then each
new residual (residual_op3, residual_pick, residual_pick_and_place,
residual_bimanual_reorient, residual_humanoid_interact) one cost term at
a time (the other weights 0), each scored from one plain rollout
(MegaRollout.returns_plain_variants) under a userdata that leaves its
weight on (PickAndPlace's Reach in the bring phase, Away in the away
phase; Humanoid Interact's seat term in Sit, its feet-placement terms in
Stand), float32 over 4 steps at rtol 2e-3 and float64 over 12 at 1e-9
(measured 2.7e-5 and 9.9e-13, Bimanual Reorient), from a probe state
where contacts are active (PickAndPlace's palm on the table, so the
careful term reads force).

Tolerances, with the errors measured when they were set: step float32
qpos atol 1e-5 (1.2e-6), duals 1e-4 * max (4.1e-6 relative), qvel per
state within max(1e-3, 8 times the state's plain float32-vs-float64
error), the float32 rounding witness of test_torch_kernel_host.py's
contraction test (Bimanual Reorient's warm step 2.5e-3, 1.15 times its
plain float32 step's own error; elsewhere under 2.2e-4); float64 qpos
1e-12, qvel 1e-11, duals 1e-12 * max (4.4e-16, 5.9e-14, 3.3e-15
relative).
"""

import functools

import numpy as np
import pytest
import torch

from mujoco_mpc_torch.ops import megarollout as tmr
from mujoco_mpc_torch.physics import tilestep as tts
from mujoco_mpc_torch.tasks import base as tbase
from mujoco_mpc_torch.tasks import registry as treg
from tests import torch_flat_cases as fc
from tests.test_torch_kernel_host import (_NP, _TOL64, _host_step, _packed,
                                          host_returns)
from tests.test_torch_kernel_host import lib  # noqa: F401 (fixture)
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

_TOL32 = (1e-5, 1e-3, 1e-4)


def kernel_aux(tm, name, dtype, userdata=None):
  """The task's operands as the kernel takes them: (mocap_pos, mocap_quat,
  userdata) flat numpy in dtype."""
  mp, mq, ud = fc.operands(name, treg.get_task(name, device="cpu").model)
  if userdata is not None:
    ud = userdata
  aux = tts.aux_operands(tm, mp, mq, ud, dtype)
  return [np.ascontiguousarray(x[..., 0].numpy()) for x in aux]


def check_steps(libs, name):
  task = treg.get_task(name, device="cpu")
  tm = tts.extract(task.model)
  probe = fc.states(name, task.model, 8)
  plain = {}
  for dtype in (torch.float64, torch.float32):
    raw, tier = _packed(tm, task, dtype)
    assert tier.name == "large"
    aux = kernel_aux(tm, name, dtype)
    ops = dict(zip(("mocap_pos", "mocap_quat", "userdata"),
                   (torch.tensor(x)[..., None] for x in aux)))
    qp, qv, ct = (x.astype(_NP[dtype]) for x in probe)
    kq, kv, kl = qp, qv, np.zeros((tm.nrow, 8), _NP[dtype])
    pq, pv, pl = torch.tensor(qp), torch.tensor(qv), None
    for i in range(2):
      kq, kv, kl = _host_step(libs[tier], raw, dtype, kq, kv, ct, kl, aux)
      pq, pv, view = tts.step_tb(tm, pq, pv, torch.tensor(ct), pl, **ops)
      pl = view.efc_lambda
      plain[dtype, i] = pv.double().numpy()
      scale = float(pl.abs().max())
      if dtype == torch.float64:
        tq, tv, tl = _TOL64
        np.testing.assert_allclose(kv, pv.numpy(), atol=tv, rtol=0)
      else:
        tq, _, tl = _TOL32
        # per state: 1e-3, or 8 times the state's own float32 rounding
        # (its plain float32 step against the float64 one)
        noise = np.abs(plain[torch.float32, i]
                       - plain[torch.float64, i]).max(0)
        err = np.abs(kv - pv.numpy()).max(0)
        assert np.all(err <= np.maximum(_TOL32[1], 8.0 * noise)), (
            err, noise)
      np.testing.assert_allclose(kq, pq.numpy(), atol=tq, rtol=0)
      np.testing.assert_allclose(kl, pl.numpy(), atol=tl * scale, rtol=0)


def _term_userdata(name, k, ud):
  """userdata under which term k's weight_mod scale is 1."""
  ud = ud.copy()
  if name == "PickAndPlace":
    ud[0] = 1.0 if k == 3 else 0.0
  elif name == "Humanoid Interact":
    ud[tbase.MODE_SLOT] = 1.0 if k in (5, 6) else 0.0
  return ud


@functools.cache
def _plain(name, dtype, horizon):
  """The plain returns of every term of `name` and the inputs."""
  task = treg.get_task(name, device="cpu")
  mr = tmr.MegaRollout(task, horizon, device="cpu")
  home = fc.states(name, task.model, 1)[0][:, 0].astype(_NP[dtype])
  v0 = np.zeros(mr.tm.nv, _NP[dtype])
  acts = (0.3 * np.random.RandomState(0).randn(8, horizon, mr.tm.nu)
          ).astype(_NP[dtype])
  mp, mq, ud = fc.operands(name, task.model)
  variants = []
  for k in range(task.spec.nterm):
    w = torch.zeros_like(task.params.weights)
    w[k] = task.params.weights[k]
    variants.append((task.params.replace(weights=w),
                     _term_userdata(name, k, ud)))
  aux = tts.aux_operands(mr.tm, mp, mq, None, dtype)
  want = mr.returns_plain_variants(
      torch.tensor(home), torch.tensor(v0), torch.tensor(acts),
      [(p, torch.tensor(u)) for p, u in variants], 0.25, dtype,
      aux[0][..., 0], aux[1][..., 0])
  return mr, home, v0, acts, variants, [x.numpy() for x in want]


def check_terms(libs, name):
  for dtype, horizon, rtol in ((torch.float32, 4, 2e-3),
                               (torch.float64, 12, 1e-9)):
    mr, home, v0, acts, variants, want = _plain(name, dtype, horizon)
    for k, (params, ud) in enumerate(variants):
      aux = kernel_aux(mr.tm, name, dtype, ud)
      out = host_returns(libs, mr, dtype, home, v0, acts,
                         params.to(dtype=dtype), aux)
      assert np.all(want[k] < tmr.MAX_RETURN)
      np.testing.assert_allclose(out, want[k], rtol=rtol, atol=0,
                                 err_msg=f"{name} term {k} {dtype}")
    if name == "PickAndPlace":
      assert want[2].min() > 0.0  # the careful term reads force


@one_torch_thread()
@pytest.mark.parametrize("name", fc.KERNEL_TASKS)
def test_host_kernel_flat_task_step_and_terms_match_plain(  # noqa: F811
    lib, name):
  check_steps(lib, name)
  check_terms(lib, name)
