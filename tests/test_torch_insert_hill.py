"""Bimanual Insert's and Quadruped Hill's residuals and transitions against
the JAX package's, in float64 on the CPU. Each JAX residual runs one
candidate at a time on a general Data (as JAX's general path runs it),
on tests/torch_mesh_cases.py's probe states stepped once by the port's
general engine and carried into a JAX Data
(tests/test_torch_transitions.py::to_jax); rtol 1e-9, atol 1e-12, as
the other tasks' residual tests. Insert's transition is held through its
success and timeout branches, Hill's through a Flip entry standing on the
slope (the ground under the CoM it saves) and its residual in the
Quadruped and Scramble modes (the ground under each foot, or under a
point moved toward the goal)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.ops import rollout as trollout
from mujoco_mpc_torch.physics import io as tio
from mujoco_mpc_torch.physics import step as tstep
from mujoco_mpc_torch.physics.types import batch_trailing
from mujoco_mpc_torch.tasks import base as tbase
from mujoco_mpc_torch.tasks import quadruped as tquad
from mujoco_mpc_torch.tasks import registry as treg
from mujoco_mpc_tpu.tasks import quadruped as jquad
from mujoco_mpc_tpu.tasks import registry as jreg
from tests import torch_mesh_cases as cases
from tests.test_torch_transitions import _state, to_jax
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

jax.config.update("jax_enable_x64", True)

B = 8


@functools.lru_cache(maxsize=None)
def _pair(name):
  t = treg.get_task(name, dtype=torch.float64, device="cpu")
  j = jreg.get_task(name, dtype=jnp.float64)
  np.testing.assert_array_equal(t.params.residual_params.numpy(),
                                np.asarray(j.params.residual_params))
  return t, j


def _stepped(t, states, **kw):
  """The states (and the extra fields kw, one row each) stepped once."""
  b = states["qpos"].shape[0]
  d = trollout.broadcast(tio.make_data(t.model), (b,))
  fields = dict(states, **kw)
  return tstep.step(t.model, d.replace(
      **{k: torch.as_tensor(np.asarray(v, np.float64))
         for k, v in fields.items()}))


def _hold_residual(t, j, d):
  ours = t.residual(t.model, batch_trailing(d),
                    t.params.residual_params).numpy()
  params = jnp.asarray(t.params.residual_params.numpy())
  b = d.qpos.shape[0]
  theirs = np.stack([
      np.asarray(j.residual(j.model, to_jax(_state(d, i), j.model), params))
      for i in range(b)], -1)
  assert ours.shape == (t.spec.nresidual, b)
  assert np.all(np.isfinite(ours))
  np.testing.assert_allclose(ours, theirs, rtol=1e-9, atol=1e-12)
  return ours


def _hold_transition(t, j, d):
  out = trollout.run_transition(t, d, t.params)
  params = jnp.asarray(t.params.residual_params.numpy())
  for i in range(d.qpos.shape[0]):
    theirs = j.transition(j.model, to_jax(_state(d, i), j.model), params)
    for f in ("qpos", "qvel", "userdata", "mocap_pos", "mocap_quat"):
      np.testing.assert_allclose(getattr(out, f)[i].numpy(),
                                 np.asarray(getattr(theirs, f)), rtol=0,
                                 atol=1e-12, err_msg=f"{f} of state {i}")
  return out


@one_torch_thread()
def test_insert_residual_matches_jax():
  """Per candidate, with the target set; the grasp terms read the
  finger-connector box-mesh rows (4 points each), and at least one state
  has both fingers of a hand within the grasp margin."""
  t, j = _pair("Bimanual Insert")
  states = cases.probe_states("Bimanual Insert", t.model, B)
  d = _stepped(t, states, mocap_pos=np.tile([[[0.05, -0.02, 0.25]]],
                                            (B, 1, 1)), time=np.full(B, 0.3))
  res = _hold_residual(t, j, d)
  grasp = res[6:8]
  assert np.any(grasp < 1.0)


@one_torch_thread()
def test_insert_transition_matches_jax():
  """Three states: the connectors mated (the male site on the female
  one), so the success branch resets them; the last success 61 s ago, so
  the timeout resets the rig; neither."""
  t, j = _pair("Bimanual Insert")
  m = t.model
  states = {k: v[[0, 2, 3]] for k, v in cases.probe_states(
      "Bimanual Insert", m, 4, seed=1).items()}  # no mated one among them
  q = states["qpos"]
  fa = cases._free_qpos(m, m.body("female"))
  ma = cases._free_qpos(m, m.body("male"))
  q[0, ma + 3:ma + 7] = q[0, fa + 3:fa + 7]
  one = tstep.forward(m, tio.make_data(m).replace(
      qpos=torch.as_tensor(q[0])))
  q[0, ma:ma + 3] = one.site_xpos[m.site("female_site")].numpy()
  userdata = np.zeros((3, m.nuserdata))
  userdata[:, 0] = (2.0, 5.0, 1.0)
  userdata[:, 1] = (0.1, 0.2, 0.25)
  time = np.array([0.3, 61.5, 0.3])
  d = tstep.forward(m, trollout.broadcast(tio.make_data(m), (3,)).replace(
      **{k: torch.as_tensor(v) for k, v in
         dict(qpos=q, qvel=states["qvel"], userdata=userdata,
              time=time).items()}))
  out = _hold_transition(t, j, d)
  assert out.userdata[0, 0] == 3.0 and out.userdata[0, 1] == 0.3
  home = np.asarray(m.keyframe("home")[0])
  np.testing.assert_array_equal(out.qpos[1].numpy(), home)
  assert out.userdata[1, 1] == 61.5
  assert out.userdata[2, 0] == 1.0


@one_torch_thread()
@pytest.mark.parametrize("mode", [tquad.MODE_QUADRUPED, tquad.MODE_SCRAMBLE])
def test_hill_residual_matches_jax(mode, monkeypatch):
  """Per candidate on the hill's slope, trotting (every foot's gait term
  reads the ground under it), the goal up the hill. The port keeps the
  gait tables in float32, as the CUDA kernel does; JAX's are float64
  under x64, so JAX reads them rounded to float32 here."""
  for name in ("_GAIT_PARAM", "_GAIT_PHASE"):
    table = np.asarray(getattr(jquad, name))
    monkeypatch.setattr(jquad, name, jnp.asarray(
        table.astype(np.float32).astype(np.float64)))
  t, j = _pair("Quadruped Hill")
  m = t.model
  b = 4  # two standing on the slope, two on their backs
  states = cases.probe_states("Quadruped Hill", m, b)
  ud = tquad.fsm_userdata(m.nuserdata, mode, tquad.GAIT_TROT)
  d = _stepped(t, states, userdata=np.tile(ud, (b, 1)),
               mocap_pos=np.tile([[[4.0, 0.5, 0.6]]], (b, 1, 1)),
               time=np.full(b, 0.13))
  res = _hold_residual(t, j, d)
  ground = tquad._ground_under(m, batch_trailing(d), torch.stack(
      [batch_trailing(d).geom_xpos[m.geom(f)] for f in tquad._FEET]))
  assert float(ground.abs().max()) > 0.05  # the feet stand on the slope
  assert np.all(np.isfinite(res))


@one_torch_thread()
def test_hill_transition_matches_jax():
  """A Flip requested from Quadruped on the slope: the transition saves
  the ground height under the CoM (userdata[21]), nonzero there."""
  t, j = _pair("Quadruped Hill")
  m = t.model
  states = cases.probe_states("Quadruped Hill", m, 4)
  ud = tquad.fsm_userdata(m.nuserdata, tquad.MODE_QUADRUPED,
                          tquad.GAIT_TROT)
  ud = np.tile(ud, (4, 1))
  ud[:, tbase.MODE_SLOT] = tquad.MODE_FLIP
  d = _stepped(t, states, userdata=ud, time=np.full(4, 0.2))
  out = _hold_transition(t, j, d)
  assert np.all(out.userdata[:, 16].numpy() == tquad.MODE_FLIP)
  assert float(out.userdata[:, 21].abs().min()) > 0.05
