"""The transitions of the nine flat-ground tasks that have one, held
against the JAX package in float64 on the CPU, as
tests/test_torch_transitions.py holds the others (its helpers): each runs
in the port on a batch of states, in JAX one state at a time from the same
Data, with the states placed to fire it: Pick's relocation (box sites on
the target's after time 0; at time 0 and far off it does not fire);
PickAndPlace's bring-to-away switch (corners on the target's) and its
away-to-bring switch with a new target pose (the gripper raised);
Bimanual Reorient's goal advance (the goal at the box's orientation);
Swimmer's relocation (the target at the nose); Rubik's scramble, its
solve moves (down a stage; at stage 0 to wait) and the drop check; Humanoid
Track's re-anchor after a reset (time before the clip's start) and past
the clip's end (the loop).

Tolerance, with the error measured when it was set: qpos, qvel, mocap
poses and userdata atol 1e-9 (measured 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.ops import rollout as trollout
from mujoco_mpc_torch.tasks import base as tbase
from mujoco_mpc_torch.tasks import humanoid_track as ttrack
from mujoco_mpc_torch.tasks import rubik as trubik
from tests import torch_engine_cases as cases
from tests.test_torch_transitions import _batch, _state, to_jax
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401


def _home(m, b):
  return np.tile(np.asarray(m.keyframe("home")[0], np.float64), (b, 1))


def _free(m, body):
  """The qpos address of a body's free joint."""
  return m.jnt_qposadr[m.body_jntadr[m.body(body)]]


def _pick(t):
  m = t.model
  qp = _home(m, 3)
  box = _free(m, "box")
  target = np.tile([[[0.3, -0.2, 0.3]]], (3, 1, 1))
  target[:2, 0] = qp[:2, box:box + 3]  # the box's sites on the target's
  ud = np.zeros((3, m.nuserdata))
  ud[:, 0] = 4.0
  time = np.asarray([0.5, 0.0, 0.5])  # at time 0 nothing moves
  return _batch(t, qp, np.zeros((3, m.nv)), ud, target,
                np.tile([[[1.0, 0.0, 0.0, 0.0]]], (3, 1, 1)), time)


def _pick_and_place(t):
  m = t.model
  qp = _home(m, 3)
  obj = _free(m, "object")
  pos = np.tile([[[0.1, -0.15, 0.15]]], (3, 1, 1))
  quat = np.tile([[[0.9, 0.1, 0.3, 0.2]]], (3, 1, 1))
  quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
  pos[0, 0] = qp[0, obj:obj + 3]  # state 0: corners on the target's
  quat[0, 0] = qp[0, obj + 3:obj + 7]
  qp[1, m.jnt_qposadr[m.joint("lift")]] = -1.2  # state 1: raised
  qp[1, m.jnt_qposadr[m.joint("elbow")]] = -0.4
  ud = np.zeros((3, m.nuserdata))
  ud[:, 1] = 5.0
  ud[1:, 0] = 1.0  # states 1 and 2 in the away phase, 2 still low
  return _batch(t, qp, np.zeros((3, m.nv)), ud, pos, quat,
                np.full(3, 0.7))


def _reorient(t):
  m = t.model
  qp = _home(m, 2)
  box = _free(m, "box")
  goal = np.tile([[[0.0, 1.0, 0.0, 0.0]]], (2, 1, 1))  # a half turn off
  goal[0, 0] = qp[0, box + 3:box + 7] * 2.0  # reached (unnormalized)
  ud = np.zeros((2, m.nuserdata))
  ud[:, 0] = [2.0, 7.0]
  return _batch(t, qp, np.zeros((2, m.nv)), ud,
                np.tile([[[-0.15, 0.0, 0.02]]], (2, 1, 1)), goal)


def _swimmer(t):
  m = t.model
  qp = np.tile(m.qpos0.numpy(), (2, 1))
  qp[:, 2] = [0.3, -0.4]
  d = _batch(t, qp, np.zeros((2, m.nv)))
  nose = d.site_xpos[:, m.site("nose")].numpy()
  target = np.tile([[[0.5, 0.5, 0.05]]], (2, 1, 1))
  target[0, 0, :2] = nose[0, :2] + 0.01  # within 6 cm
  ud = np.zeros((2, m.nuserdata))
  ud[:, 0] = 3.0
  return _batch(t, qp, np.zeros((2, m.nv)), ud, target)


def _rubik(t):
  m = t.model
  qp = _home(m, 4)
  faces = slice(trubik._QFACE, trubik._QFACE + 6)
  qp[1, faces] = trubik._face_targets(
      torch.tensor(2.0, dtype=torch.float64),
      torch.float64).numpy() + 0.01  # stage 2 reached
  qp[2, faces] = 0.0  # stage 0 reached
  qp[3, trubik._QCUBE + 2] = 0.05  # dropped
  qv = np.zeros((4, m.nv))
  qv[0, trubik._VFACE:trubik._VFACE + 6] = 0.3
  ud = np.zeros((4, m.nuserdata))
  ud[:, 0] = [trubik.MODE_SCRAMBLE, trubik.MODE_SOLVE, trubik.MODE_SOLVE,
              trubik.MODE_SOLVE]
  ud[:, 1] = [0.0, 2.0, 0.0, 1.0]
  return _batch(t, qp, qv, ud,
                np.tile([[[0.25, 0.0, 0.3]]], (4, 1, 1)))


def _track(t):
  m = t.model
  qp = _home(m, 3)
  ud = np.zeros((3, m.nuserdata))
  ud[:, 0] = [2.0, 0.5, 0.5]
  ud[:, tbase.MODE_SLOT] = [0.0, 4.0, 1.0]
  span = (ttrack.clip_table()[2][4] - 1) / 30.0
  time = np.asarray([1.0, 0.5 + span + 0.01, 1.0])
  return _batch(t, qp, np.zeros((3, m.nv)), ud, time=time)


STATES = {"Pick": _pick, "PickAndPlace": _pick_and_place,
          "Bimanual Reorient": _reorient, "Swimmer": _swimmer,
          "Rubik": _rubik, "Humanoid Track": _track}
# the states whose userdata or pose the transition must move
_MOVED = {"Pick": (0,), "PickAndPlace": (0, 1), "Bimanual Reorient": (0,),
          "Swimmer": (0,), "Rubik": (0, 1, 2, 3), "Humanoid Track": (0, 1)}


@one_torch_thread()
@pytest.mark.parametrize("name", list(STATES))
def test_flat_task_transition_matches_jax(name):
  t, j = cases.pair(name)
  d = STATES[name](t)
  out = trollout.run_transition(t, d, t.params)
  jt = jax.jit(j.transition)
  params = jnp.asarray(t.params.residual_params.numpy())
  moved = set()
  for b in range(d.qpos.shape[0]):
    want = cases.np_tree(jt(j.model, to_jax(_state(d, b), j.model), params))
    got = _state(out, b)
    for f in ("qpos", "qvel", "mocap_pos", "mocap_quat", "userdata"):
      np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f),
                                 atol=1e-9, err_msg=f"{name} state {b} {f}")
      if not np.array_equal(getattr(got, f).numpy(),
                            getattr(_state(d, b), f).numpy()):
        moved.add(b)
  assert moved == set(_MOVED[name]), (name, moved)
