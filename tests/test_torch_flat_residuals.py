"""The residuals of the five flat-ground tasks that plan through the CUDA
kernel (OP3, Pick, PickAndPlace, Bimanual Reorient, Humanoid Interact),
held against the JAX package's general residuals in float64 on the CPU.

Each JAX residual runs one candidate at a time on a general Data, as JAX's
general path runs it: three of them are written for one state and fail on
the kernel's tile view (OP3's balance norm over every axis and home ctrl,
PickAndPlace's corner add, Humanoid Interact's seat offset; ROADMAP queue
3), and the port takes their meaning for each candidate. The states are
tests/torch_flat_cases.py's probe states with the task's goal and mode
operands, stepped once by the port's general engine (PickAndPlace's
careful term reads that step's contact forces), each carried into a JAX
Data (tests/test_torch_transitions.py::to_jax). Tolerance: rtol 1e-9,
atol 1e-12 (measured: equal, or 2.1e-16 relative).

PickAndPlace's careful term reads the converged duals of the kernel's own
step on its tile view (tilestep.ContactView.force, rows ordered per
class): the last test holds the tile residual against the general route's
on the same states, both float64 on the kernel's float32-rounded
constants, rtol 1e-6, atol 1e-9 (measured 2.6e-7 relative over the
residual; the careful term, where the palm presses the table, 3.186 in
both).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.physics import tilestep as tts
from mujoco_mpc_torch.physics.types import batch_trailing
from mujoco_mpc_torch.tasks import bring as tbring
from mujoco_mpc_torch.tasks import registry as treg
from tests import torch_engine_cases as cases
from tests import torch_flat_cases as fc
from tests.test_torch_rollout import _rounded64
from tests.test_torch_transitions import _state, to_jax
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

B = 4


def check_residual(name):
  """The port's residual of a stepped batch against JAX's, state by
  state."""
  t, j = cases.pair(name)
  probe = fc.states(name, t.model, B)
  d = fc.general_batch(t, probe, fc.operands(name, t.model))
  ours = t.residual(t.model, batch_trailing(d),
                    t.params.residual_params).numpy()
  params = jnp.asarray(t.params.residual_params.numpy())
  theirs = np.stack([
      np.asarray(j.residual(j.model, to_jax(_state(d, b), j.model), params))
      for b in range(B)], -1)
  assert ours.shape == (t.spec.nresidual, B)
  assert np.all(np.isfinite(ours))
  np.testing.assert_allclose(ours, theirs, rtol=1e-9, atol=1e-12)


@one_torch_thread()
@pytest.mark.parametrize("name", fc.KERNEL_TASKS)
def test_kernel_task_residual_matches_jax(name):
  check_residual(name)


@one_torch_thread()
def test_pick_and_place_tile_residual_matches_general():
  """The careful term from the tile step's duals (tilestep.
  _contact_force) against the general step's contact forces, per
  candidate, with the rest of the residual."""
  name = "PickAndPlace"
  t32 = treg.get_task(name, device="cpu")
  t = _rounded64(t32)
  tm = tts.extract(t32.model)
  probe = fc.states(name, t.model, 8)
  mp, mq, ud = fc.operands(name, t.model)
  aux = tts.aux_operands(tm, mp, mq, ud, torch.float64)
  _, _, view = tts.step_tb(tm, *(torch.tensor(x, dtype=torch.float64)
                                 for x in probe), mocap_pos=aux[0],
                           mocap_quat=aux[1], userdata=aux[2])
  tile = t.residual(t.model, view, t.params.residual_params).numpy()
  d = fc.general_batch(t, probe, (mp, mq, ud))
  general = t.residual(t.model, batch_trailing(d),
                       t.params.residual_params).numpy()
  careful = tile[11]
  assert np.count_nonzero(careful) >= 1  # the palm presses the table
  idx = tbring.palm_table_points(view.contact.pairs, t.model)
  assert len(idx) == 8
  np.testing.assert_allclose(tile, general, rtol=1e-6, atol=1e-9)
