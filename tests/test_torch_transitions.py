"""The tasks' transitions (Task.transition, the FSMs Agent.step runs
before each action) held against the JAX package in float64 on the CPU.

Each transition runs in the port on a batch of states (the batch-trailing
view a rollout gives it, ops/rollout.py::run_transition) and in JAX one
state at a time, from the same Data: the port's forward pass fills the
derived fields (kinematics, velocities; the engine's parity with JAX is
tests/test_torch_engine.py) and the same arrays become the JAX Data. The
states take each FSM through its branches: Particle's goal on the clock;
the quadruped's gait switching, Walk entry (straight and turning), Flip
entry and exit and the reset; Shadow's and Allegro's goal advance and drop
reset; the handover's success, fall and timeout; Rubik Faces' scramble
and solve moves.

Tolerance, with the error measured when it was set: qpos, qvel, mocap
poses and userdata atol 1e-9 (measured 4e-16).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.ops import rollout as trollout
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.physics import step as tstep
from mujoco_mpc_torch.tasks import base as tbase
from mujoco_mpc_torch.tasks import bimanual as tbim
from mujoco_mpc_torch.tasks import hand_reorient as thand
from mujoco_mpc_torch.tasks import quadruped as tquad
from mujoco_mpc_torch.tasks import rubik as trubik
from tests import torch_engine_cases as cases
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

jio = importlib.import_module("mujoco_mpc_tpu.physics.io")


def _state(d, b):
  """State b of a batched Data."""
  def pick(obj):
    return dataclasses.replace(obj, **{
        f.name: (pick(v) if dataclasses.is_dataclass(v) else
                 v[b] if isinstance(v, torch.Tensor) else v)
        for f in dataclasses.fields(obj)
        for v in (getattr(obj, f.name),)})
  return pick(d)


def to_jax(td, jm):
  """A JAX Data holding a port Data's arrays (one state)."""
  jd = jio.make_data(jm)
  kw = {f.name: jnp.asarray(getattr(td, f.name).numpy())
        for f in dataclasses.fields(td)
        if isinstance(getattr(td, f.name), torch.Tensor)}
  c = td.contact
  kw["contact"] = jd.contact.replace(**{
      f.name: jnp.asarray(getattr(c, f.name).numpy())
      for f in dataclasses.fields(c)
      if isinstance(getattr(c, f.name), torch.Tensor)})
  return jd.replace(**kw)


def _batch(t, qpos, qvel, userdata=None, mocap_pos=None, mocap_quat=None,
           time=None):
  """A batch of B states (numpy rows), forward-filled."""
  b = len(qpos)
  d = trollout.broadcast(tio.make_data(t.model), (b,))
  kw = dict(qpos=torch.tensor(np.asarray(qpos, np.float64)),
            qvel=torch.tensor(np.asarray(qvel, np.float64)))
  for name, v in (("userdata", userdata), ("mocap_pos", mocap_pos),
                  ("mocap_quat", mocap_quat), ("time", time)):
    if v is not None:
      kw[name] = torch.tensor(np.asarray(v, np.float64))
  return tstep.forward(t.model, d.replace(**kw))


def _quadruped(t):
  m = t.model
  b = 6
  qp, qv, _ = tquad.probe_states(m, b)
  ud = np.stack([tquad.fsm_userdata(m.nuserdata, tquad.MODE_QUADRUPED,
                                    tquad.GAIT_STAND) for _ in range(b)])
  time = np.asarray([1.5, 2.0, 2.0, 1.0, 2.5, 5.0])
  ud[:, 3] = 0.0  # a cadence change on the first transition
  ud[1, tbase.MODE_SLOT] = tquad.MODE_WALK  # entering Walk
  ud[2, tbase.MODE_SLOT] = tquad.MODE_FLIP  # entering Flip
  ud[3, 7], ud[3, tbase.MODE_SLOT] = 4.0, tquad.MODE_WALK  # a reset
  ud[4, tbase.MODE_SLOT] = ud[4, 16] = tquad.MODE_WALK  # walking, turned
  ud[4, 13], ud[4, 14] = 0.5, 0.3
  ud[5, tbase.MODE_SLOT] = ud[5, 16] = tquad.MODE_FLIP  # the flip is done
  qv = qv.T.copy()
  qv[0, :3] = [0.9, 0.2, 0.0]  # fast: auto gait moves up
  mocap = np.tile([[[1.0, 0.3, 0.3]]], (b, 1, 1))
  params = t.params.residual_params.clone()
  params[3] = 0.3  # Walk turns
  return _batch(t, qp.T, qv, ud, mocap, time=time), params


def _hand(t):
  m = t.model
  qp, qv, _ = t_probe(t.name)(m, 3)
  qp, qv = qp.T.copy(), qv.T.copy()
  qadr, _ = thand._cube_adr(m)
  goal = np.tile(qp[0, qadr + 3:qadr + 7], (3, 1))[:, None]
  goal[1:] = [[[0.8, 0.2, 0.4, 0.3]]]
  qp[2, qadr + 2] = 0.1  # dropped
  ud = np.zeros((3, m.nuserdata))
  ud[:, 0] = [3.0, 1.0, 2.0]
  return _batch(t, qp, qv, ud, mocap_quat=goal), t.params.residual_params


def t_probe(name):
  from mujoco_mpc_torch.tasks import allegro
  return {"Shadow": thand.probe_states,
          "Allegro": allegro.probe_states}[name]


def _handover(t):
  m = t.model
  qp, qv, _ = tbim.probe_states(m, 3)
  qp, qv = qp.T.copy(), qv.T.copy()
  box = m.jnt_qposadr[m.body_jntadr[m.body("box")]]
  target = np.tile([[[0.35, -0.25, 0.3]]], (3, 1, 1))
  target[0, 0] = qp[0, box:box + 3]  # solved
  qp[1, box + 2] = -0.2  # fell off the table
  ud = np.zeros((3, m.nuserdata))
  ud[:, 0], ud[:, 1] = 2.0, 1.0
  time = np.asarray([3.0, 3.0, 40.0])  # the last one stuck
  return _batch(t, qp, qv, ud, target, time=time), t.params.residual_params


def _rubik(t):
  m = t.model
  targets = np.asarray([0.3, 0.0, -0.2, 0.1, 0.0, 0.0])
  qp = np.tile(m.qpos0.numpy(), (3, 1))
  qp[:, :6] = targets
  qp[2, 0] += 0.5  # not settled
  qv = np.zeros((3, m.nv))
  ud = np.stack([trubik.faces_userdata(m.nuserdata, targets, mode, index)
                 for mode, index in ((trubik.MODE_SCRAMBLE, 3.0),
                                     (trubik.MODE_SOLVE, 1.0),
                                     (trubik.MODE_SCRAMBLE, 0.0))])
  return _batch(t, qp, qv, ud), t.params.residual_params


def _particle(t):
  qp = np.asarray([[0.1, -0.05], [0.0, 0.2]])
  return (_batch(t, qp, np.zeros((2, 2)), time=[1.3, 0.2]),
          t.params.residual_params)


STATES = {"Particle": _particle, "Quadruped Flat": _quadruped,
          "Shadow": _hand, "Allegro": _hand, "Bimanual Handover": _handover,
          "Rubik Faces": _rubik}


@pytest.mark.parametrize("name", list(STATES))
def test_transition_matches_jax(name):
  t, j = cases.pair(name)
  d, params = STATES[name](t)
  out = trollout.run_transition(t, d, t.params.replace(
      residual_params=params))
  jt = jax.jit(j.transition)
  moved = False
  for b in range(d.qpos.shape[0]):
    want = cases.np_tree(jt(j.model, to_jax(_state(d, b), j.model),
                  jnp.asarray(params.numpy())))
    got = _state(out, b)
    for f in ("qpos", "qvel", "mocap_pos", "mocap_quat", "userdata"):
      np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f),
                                 atol=1e-9, err_msg=f"{name} state {b} {f}")
      moved |= not np.allclose(getattr(got, f).numpy(),
                               getattr(_state(d, b), f).numpy())
  assert moved, f"{name}: no state moved the FSM"
