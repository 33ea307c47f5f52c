"""Trajectory recording and export: the headless stand-in for the GUI.

Counterpart of mujoco_mpc_tpu/tools/trace.py. The reference renders live
candidate traces and state in its GLFW viewer (SURVEY §2.1 App/GUI); here
an episode (qpos, ctrl, cost, cost terms, the planner's best returns) is
recorded to an .npz with the JAX tool's keys and meta, so that either
package's plot_trace reads it, and replayed in MuJoCo's viewer on a
machine with a display (replay_script).
"""

from __future__ import annotations

import json
import os

import numpy as np


class TraceRecorder:
  """Record an agent episode for later visualization and analysis."""

  def __init__(self, agent, record_terms: bool = True):
    self.agent = agent
    self.record_terms = record_terms
    self.times, self.qpos, self.qvel, self.ctrl, self.cost = (
        [], [], [], [], [])
    self.terms = []  # per-step cost-term values (GUI cost figure)
    self.best_returns = []  # planner improvement figure

  def record(self):
    st = self.agent.get_state()
    self.times.append(st["time"])
    self.qpos.append(st["qpos"])
    self.qvel.append(st["qvel"])
    self.ctrl.append(self.agent.data.ctrl.cpu().numpy())
    self.cost.append(self.agent.total_cost())
    if self.record_terms:
      t = self.agent.cost_terms()
      self.terms.append([t[k] for k in self.agent.task.spec.names])
    info = self.agent.last_info
    self.best_returns.append(
        float(info.best_return) if info is not None else np.nan)

  def save(self, path: str) -> str:
    path = os.path.abspath(path)
    np.savez(
        path,
        times=np.asarray(self.times),
        qpos=np.asarray(self.qpos),
        qvel=np.asarray(self.qvel),
        ctrl=np.asarray(self.ctrl),
        cost=np.asarray(self.cost),
        terms=np.asarray(self.terms) if self.terms else np.zeros((0, 0)),
        best_returns=np.asarray(self.best_returns),
        meta=json.dumps({
            "task": self.agent.task.name,
            "planner": self.agent.planner_name,
            "term_names": list(self.agent.task.spec.names),
        }))
    return path + (".npz" if not path.endswith(".npz") else "")


def best_root_trace(agent, horizon=None, stride: int = 1) -> np.ndarray:
  """(T, 3) world positions of the root body (index 1; the world where
  the model has no other) along the current best trajectory, every
  stride-th state: one batched forward over those states. The
  dashboard's and live_view's candidate traces."""
  import torch

  from mujoco_mpc_torch.ops import rollout as rollout_mod
  from mujoco_mpc_torch.physics import step as phys_step

  traj = agent.best_trajectory(horizon=horizon)
  m = agent.sim_task.model
  body = 1 if int(m.nbody) > 1 else 0
  qs = torch.as_tensor(traj["qpos"][::stride], dtype=m.dtype,
                       device=agent.device)
  d = rollout_mod.broadcast(agent.data, qs.shape[:1]).replace(qpos=qs)
  return phys_step.forward(m, d).xpos[:, body].cpu().numpy()


def replay_script(trace_path: str, task_xml: str) -> str:
  """A standalone replay script for machines with a display."""
  return f"""# replay with: python replay.py (requires a display + mujoco)
import time
import numpy as np
import mujoco
import mujoco.viewer

data = np.load({trace_path!r})
m = mujoco.MjModel.from_xml_path({task_xml!r})
d = mujoco.MjData(m)
with mujoco.viewer.launch_passive(m, d) as v:
  for qpos, t in zip(data["qpos"], data["times"]):
    d.qpos[:] = qpos
    mujoco.mj_forward(m, d)
    v.sync()
    time.sleep(float(m.opt.timestep))
"""
