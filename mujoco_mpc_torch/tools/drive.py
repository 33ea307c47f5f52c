"""Headless behavior drive: plan + act a task for N steps, print metrics.

Counterpart of mujoco_mpc_tpu/tools/drive.py: the synchronous plan/act loop
(reference testspeed-style cadence, mjpc/testspeed.cc:44-146), printing
one JSON line with the root body's displacement and cost metrics, under
the JAX tool's keys.

Usage:
  python -m mujoco_mpc_torch.tools.drive --task Walker --steps 600 \\
      --plan_every 2 [--candidates 1024] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time as time_mod

from mujoco_mpc_torch import device as devices


def with_candidates(agent, n: int) -> None:
  """Rebuild the agent's planner with n candidates (num_trajectories) and
  start its policy afresh, as the JAX tools do."""
  cfg = dataclasses.replace(agent.planner.config, num_trajectories=n)
  agent.planner = type(agent.planner)(cfg)
  agent.policy = agent.planner.init(agent.task)
  agent.previous_policy = agent.policy


def root_position(agent):
  """The root body's (index 1: world is 0) world position, numpy (3,)."""
  import numpy as np

  from mujoco_mpc_torch.physics import step as phys_step
  m = agent.sim_task.model
  if m.nbody <= 1:
    return np.zeros(3)
  return phys_step.forward(m, agent.data).xpos[1].cpu().numpy()


def main(argv=None) -> dict:
  p = argparse.ArgumentParser(description="mujoco_mpc_torch behavior drive")
  p.add_argument("--task", required=True)
  p.add_argument("--planner", default="sampling")
  p.add_argument("--steps", type=int, default=600)
  p.add_argument("--plan_every", type=int, default=2)
  p.add_argument("--candidates", type=int, default=0,
                 help="override sampling_trajectories (0 = task XML value)")
  p.add_argument("--horizon", type=int, default=0)
  p.add_argument("--keyframe", default="home")
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--mode", default="", help="initial task mode")
  p.add_argument("--device", default=devices.DEFAULT,
                 help="cuda (default) or cpu")
  args = p.parse_args(argv)

  import numpy as np

  from mujoco_mpc_torch.agent.agent import Agent

  agent = Agent(args.task, planner=args.planner,
                horizon_steps=args.horizon or None, seed=args.seed,
                device=args.device)
  if args.candidates:
    with_candidates(agent, args.candidates)
  try:
    agent.reset(keyframe=args.keyframe)
  except KeyError:
    agent.reset()
  if args.mode:
    agent.set_mode(args.mode)

  start_root = root_position(agent)
  start_qpos = agent.data.qpos.cpu().numpy()

  t0 = time_mod.perf_counter()
  best_returns = []
  modes_seen = set()
  for i in range(0, args.steps, args.plan_every):
    info = agent.planner_step()
    best_returns.append(float(info.best_return))
    agent.steps(min(args.plan_every, args.steps - i))
    modes_seen.add(agent.get_mode())
  wall = time_mod.perf_counter() - t0

  delta = root_position(agent) - start_root
  ud = agent.data.userdata.cpu().numpy()
  out = {
      "task": args.task,
      "planner": args.planner,
      "steps": args.steps,
      "sim_time": float(agent.data.time),
      "wall_s": round(wall, 2),
      "displacement": [round(float(x), 4) for x in delta],
      "horizontal_displacement": round(
          float(np.linalg.norm(delta[:2])), 4),
      "final_cost": agent.total_cost(),
      "best_return_last": best_returns[-1] if best_returns else None,
      "best_return_first": best_returns[0] if best_returns else None,
      "modes_seen": sorted(modes_seen),
      "final_mode": agent.get_mode(),
      "userdata": [round(float(x), 4) for x in ud[:8]],
      "qpos_start": [round(float(x), 4) for x in start_qpos[:3]],
      "qpos_end": [round(float(x), 4)
                   for x in agent.data.qpos.cpu().numpy()[:3]],
  }
  print(json.dumps(out))
  return out


if __name__ == "__main__":
  main()
