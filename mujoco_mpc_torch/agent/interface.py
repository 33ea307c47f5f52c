"""Embedding interface: run the agent inside another program.

Counterpart of mujoco_mpc_tpu/agent/interface.py (reference
mjpc/interface.{h,cc}: AgentRunner and the create_policy / step_policy /
set_weights functions, interface.h:43-48). An AgentRunner owns an Agent
whose plan loop runs in a thread; the caller publishes states and reads
the latest policy's action. The functional surface below, handles over
plain arrays, is what native/mjpc_capi.cc forwards to. The device is an
argument (the card by default), where the JAX package reads an
environment variable.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.agent.agent import Agent

_RUNNERS: Dict[int, "AgentRunner"] = {}
_NEXT_ID = [1]


class AgentRunner:
  """Owns an asynchronously planning agent; callers feed states and read
  actions (reference AgentRunner semantics). The plan loop's first plan
  runs in the constructor (Agent.start_planning), so a policy is in place
  when it returns."""

  def __init__(self, task: str, planner: str = "sampling",
               device=devices.DEFAULT):
    self.agent = Agent(task, planner=planner, device=device)
    self.agent.start_planning()

  def step_policy(self, qpos, qvel, time: float = 0.0) -> np.ndarray:
    """Publish the latest state, return the current policy's action (nu,);
    raises the error that ended the plan thread, if one did."""
    self.agent.raise_planning_error()
    self.agent.set_state(qpos=qpos, qvel=qvel, time=time)
    return self.agent.action()

  def set_weights(self, weights: Dict[str, float]):
    self.agent.set_cost_weights(weights)

  def close(self):
    """Stop the plan loop and join its thread."""
    self.agent.stop_planning()


# --- the C-ABI-style functional surface (reference interface.h:43-48) ----

def create_policy(task: str, planner: str = "sampling",
                  device=devices.DEFAULT) -> int:
  runner = AgentRunner(task, planner, device)
  handle = _NEXT_ID[0]
  _NEXT_ID[0] += 1
  _RUNNERS[handle] = runner
  return handle


def step_policy(handle: int, qpos, qvel, time: float = 0.0) -> np.ndarray:
  return _RUNNERS[handle].step_policy(qpos, qvel, time)


def set_weights(handle: int, weights: Dict[str, float]) -> None:
  _RUNNERS[handle].set_weights(weights)


def destroy_policy(handle: int) -> None:
  runner = _RUNNERS.pop(handle, None)
  if runner is not None:
    runner.close()
