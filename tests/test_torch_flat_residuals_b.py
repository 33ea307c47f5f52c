"""The residuals of the four flat-ground tasks on the general route
(Quadrotor, Swimmer, Rubik, Humanoid Track) against the JAX package's in
float64, as tests/test_torch_flat_residuals.py holds the kernel tasks
(its check and tolerance: rtol 1e-9, atol 1e-12; measured equal, Humanoid
Track 3.8e-15 relative); Humanoid Track at the time 0.3 s with its Jog
clip started at 0.1 s, which both packages read from the Data. The last
test checks the route: each task plans through the general rollout with
the warning that says why, and the registry lists all 26 tasks."""

import warnings

import pytest

from mujoco_mpc_torch.planners import sampling as tsampling
from mujoco_mpc_torch.tasks import registry as treg
from tests import torch_flat_cases as fc
from tests.test_torch_flat_residuals import check_residual
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401


@one_torch_thread()
@pytest.mark.parametrize("name", fc.GENERAL_TASKS)
def test_general_task_residual_matches_jax(name):
  check_residual(name)


def test_flat_tasks_take_their_routes():
  """The kernel tasks have a CUDA residual and no reason for the general
  route; the general ones have none and warn; all 26 tasks are
  registered, Bimanual Insert among them, on the general route."""
  names = treg.task_names()
  assert len(names) == 26
  assert set(fc.KERNEL_TASKS + fc.GENERAL_TASKS) <= set(names)
  for name in fc.KERNEL_TASKS:
    task = treg.get_task(name, device="cpu")
    assert task.device_residual is not None
    assert tsampling.general_reason(task) is None
  for name in fc.GENERAL_TASKS:
    task = treg.get_task(name, device="cpu")
    assert task.device_residual is None
    with warnings.catch_warnings(record=True) as caught:
      warnings.simplefilter("always")
      mega, reason = tsampling.build_rollout(task, 4)
    assert mega is None and "no CUDA residual" in reason
    assert any("general rollout" in str(w.message) for w in caught)
  insert = treg.get_task("Bimanual Insert", device="cpu")
  assert insert.device_residual is None
  with pytest.warns(UserWarning, match="general rollout"):
    mega, reason = tsampling.build_rollout(insert, 4)
  assert mega is None and "no CUDA residual" in reason
