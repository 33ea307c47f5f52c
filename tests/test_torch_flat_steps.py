"""One tile step of each of the five flat-ground kernel tasks' models
(OP3, Pick, PickAndPlace, Bimanual Reorient, Humanoid Interact, all in the
kernel's large tier) against the JAX package's step_tb, in float32, run
eagerly at 16 columns (jitting the JAX tile step of these models takes
minutes on a CPU; the eager step 15 to 23 s each here).

The states are tasks.base.covering_states: one step puts force on every
row kind the seeded search reaches, which is every kind of the model but
OP3's hand-hand capsule pair and its hand-foot capsule-box pair (the
hands move in two planes 0.15 m apart and, over 20,000 random poses within
the joint ranges, come no nearer a foot's centre than 0.088 m). The goal
and mode operands are tests/torch_flat_cases.py's.

Tolerances (ROADMAP's per-class holds of the large models), with the
errors measured on a CPU host: qpos atol 1e-5 (1.1e-6, Pick), qvel atol
1e-3 (2.1e-4, Pick), duals atol 1e-4 * max|duals| (1.6e-6 of the max,
Pick; Humanoid Interact 5.0e-3 of 5.05e3): a margin of 4.7 or more; every
row kind that carries force in the port's step carries it in JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_mpc_torch.physics import tilestep as tts
from mujoco_mpc_torch.tasks import registry as treg
from mujoco_mpc_tpu.physics import tilestep as jts
from mujoco_mpc_tpu.tasks import registry as jreg
from tests import torch_flat_cases as fc
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401

B = 16


def _kinds_with_force(kinds, lam):
  return {kinds[r] for r in np.nonzero(np.any(lam != 0, axis=1))[0]}


@one_torch_thread()
@pytest.mark.parametrize("name", fc.KERNEL_TASKS)
def test_kernel_task_step_matches_jax(name):
  task = treg.get_task(name, device="cpu")
  tm = tts.extract(task.model)
  jtm = jts.extract(jreg.get_task(name, dtype=jnp.float32).model)
  assert (tm.nrow, tm.ncon) == (jtm.nrow, jtm.ncon)
  probe = fc.states(name, task.model, B)
  aux = tts.aux_operands(tm, *fc.operands(name, task.model))
  q, v, view = tts.step_tb(tm, *(torch.tensor(x) for x in probe),
                           mocap_pos=aux[0], mocap_quat=aux[1],
                           userdata=aux[2])
  jq, jv, jview = jts.step_tb(
      jtm, *(jnp.asarray(x) for x in probe),
      **{k: jnp.asarray(x.numpy()) for k, x in zip(
          ("mocap_pos", "mocap_quat", "userdata"), aux)})
  lam, jlam = view.efc_lambda.numpy(), np.asarray(jview.efc_lambda)
  kinds = tts.row_kinds(tm)
  got = _kinds_with_force(kinds, lam)
  want = set(kinds) - ({"cap_cap", "cap_box"} if name == "OP3" else set())
  assert got == want
  assert _kinds_with_force(kinds, jlam) >= got
  np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-5, rtol=0)
  np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-3, rtol=0)
  np.testing.assert_allclose(lam, jlam, atol=1e-4 * np.abs(jlam).max(),
                             rtol=0)
