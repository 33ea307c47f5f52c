"""The host build of the CUDA kernel's task residuals against the plain
ones, one cost term or one residual branch at a time.

The plain version scores every case of a task from one physics rollout
(MegaRollout.returns_plain_variants: the physics reads neither the weights,
the residual parameters nor the userdata), computed once per (task,
precision, horizon, start state); the host kernel runs the whole rollout
for each case. float32 over 4 steps at rtol 2e-3, float64 over 12 steps
(the quadruped's branches: 30) at 1e-9. The build and the inputs are
tests/test_torch_kernel_host.py's.
"""

import functools

import numpy as np
import pytest
import torch

from mujoco_mpc_torch.ops import megarollout as tmr
from mujoco_mpc_torch.tasks import allegro as tall
from mujoco_mpc_torch.tasks import bimanual as tbim
from tests.test_torch_kernel_host import _aux, host_returns, rollout_inputs
from tests.test_torch_kernel_host import lib  # noqa: F401 (fixture)
from tests.torch_cases import QUADRUPED_MODES, quadruped_mode
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

_QUADRUPED = "Quadruped Flat"


def _start(name, start):
  """The start state of a case: the keyframe (None), or probe state 1 of
  the handover (both grippers pinching the box) or of Allegro (the cube
  over a palm corner, box-box and finger contacts active)."""
  if start is None:
    return None
  probe = {"Bimanual Handover": tbim, "Allegro": tall}[name].probe_states
  return probe(rollout_inputs(name, torch.float32, 1)[0].model, 2)[0][:, 1]


def _variants(name):
  """(TaskParams, userdata) per case: each cost term alone (the other
  weights 0), or each of the quadruped's residual branches."""
  task = rollout_inputs(name, torch.float32, 1)[0]
  if name == _QUADRUPED:
    return [quadruped_mode(task, case)[::-1]
            for case in sorted(QUADRUPED_MODES)]
  out = []
  for k in range(task.spec.nterm):
    w = torch.zeros_like(task.params.weights)
    w[k] = task.params.weights[k]
    out.append((task.params.replace(weights=w), None))
  return out


@functools.cache
def _plain(name, dtype, horizon, start):
  """The plain returns of every case of `name`, and the inputs."""
  task, mr, home, v0, acts = rollout_inputs(name, dtype, horizon,
                                            _start(name, start))
  mp, mq, ud = (torch.tensor(x) for x in _aux(mr.tm, dtype, name=name))
  variants = [(p, ud if u is None else u) for p, u in _variants(name)]
  want = mr.returns_plain_variants(torch.tensor(home), torch.tensor(v0),
                                   torch.tensor(acts), variants, 0.25, dtype,
                                   mp, mq)
  return mr, home, v0, acts, variants, [w.numpy() for w in want]


def _check(libs, name, case, dtype, horizon, rtol, start=None):
  mr, home, v0, acts, variants, want = _plain(name, dtype, horizon, start)
  params, userdata = variants[case]
  aux = _aux(mr.tm, dtype, np.asarray(userdata), name)
  out = host_returns(libs, mr, dtype, home, v0, acts, params, aux)
  assert np.all(want[case] < tmr.MAX_RETURN)
  np.testing.assert_allclose(out, want[case], rtol=rtol)


def _check_term(libs, name, term, start=None):
  _check(libs, name, term, torch.float32, 4, 2e-3, start)
  _check(libs, name, term, torch.float64, 12, 1e-9, start)


@pytest.mark.parametrize("term", range(6))
def test_host_kernel_shadow_residual_terms_match_plain(  # noqa: F811
    lib, term):
  """residual_reorient on Shadow against the Python residual, one cost
  term at a time (the other weights 0): the cube against the grasp site,
  the orientation error to the unnormalized goal, the cube's velocity, the
  actuator forces (four of them through the coupling tendons), the hand
  posture and its velocity."""
  _check_term(lib, "Shadow", term)


@pytest.mark.parametrize("term", range(6))
def test_host_kernel_allegro_residual_terms_match_plain(  # noqa: F811
    lib, term):
  """residual_reorient on Allegro, one cost term at a time: the cube
  against the world-fixed palm site and the hold offset, the orientation
  error, the cube's velocity, the actuator forces, the 12 hand angles
  against home and their velocities. From the cube over a palm corner
  (probe state 1), box-box and finger contacts active."""
  _check_term(lib, "Allegro", term, start="touch")


@pytest.mark.parametrize("term", range(5))
def test_host_kernel_handover_residual_terms_match_plain(  # noqa: F811
    lib, term):
  """residual_handover against the Python residual, one cost term at a
  time (the other weights 0): reach in each gripper's frame, the grasp
  quality, box - target, the arms' velocities. From a handover (both
  grippers pinching the box, probe state 1), where the grasp term reads
  the fingers' contact normals."""
  _check_term(lib, "Bimanual Handover", term, start="pinch")


@pytest.mark.parametrize("case", sorted(QUADRUPED_MODES))
def test_host_kernel_quadruped_modes_match_plain(lib, case):  # noqa: F811
  """Each residual branch, float32 over 4 steps (rtol 2e-3) and float64
  over 30 (rtol 1e-9)."""
  k = sorted(QUADRUPED_MODES).index(case)
  _check(lib, _QUADRUPED, k, torch.float32, 4, 2e-3)
  _check(lib, _QUADRUPED, k, torch.float64, 30, 1e-9)
