"""The Agent on the five flat-ground kernel tasks on the CPU: built by
name, set to the task's goal and mode operands, it plans once through its
MegaRollout's plain version (CPU tensors: the kernel is not launched),
acts and steps once (the transition, where the task has one, then the
general physics step); every cost, the action, the new state and its
cost (the residual on one state) are finite, the best return below the
divergence guard. The horizon is cut to
3 steps; the card's check runs the Agent's own shape (chip_smoke.py
phase 4f and G4)."""

import warnings

import numpy as np
import pytest
import torch

from mujoco_mpc_torch.agent.agent import Agent
from mujoco_mpc_torch.ops import megarollout as tmr
from tests import torch_flat_cases as fc
from tests.torch_cases import one_torch_thread
from tests.torch_engine_cases import release_jax_executables  # noqa: F401


def check_agent(name):
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    agent = Agent(name, device="cpu", horizon_steps=3)
  kernel = name in fc.KERNEL_TASKS
  assert (agent.planner.mega is not None) == kernel
  assert any("general rollout" in str(w.message) for w in caught) != kernel
  m = agent.task.model
  mp, mq, ud = fc.operands(name, m)
  agent.set_state(mocap_pos=mp if m.nmocap else None,
                  mocap_quat=mq if m.nmocap else None, userdata=ud)
  with one_torch_thread():
    info = agent.planner_step()
    u = agent.action()
    d = agent.step()
  assert bool(torch.all(torch.isfinite(info.costs)))
  assert float(info.best_return) < tmr.MAX_RETURN
  assert u.shape == (m.nu,) and np.all(np.isfinite(u))
  assert bool(torch.all(torch.isfinite(d.qpos)))
  assert np.isfinite(agent.total_cost())  # the residual on one state
  if kernel:
    assert agent.planner.mega.launches == 0


@pytest.mark.parametrize("name", fc.KERNEL_TASKS)
def test_kernel_task_agent_plans_on_cpu(name):
  check_agent(name)
