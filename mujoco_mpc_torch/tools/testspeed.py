"""Benchmark harness: synchronous plan+step loop with realtime factor.

Counterpart of mujoco_mpc_tpu/tools/testspeed.py (reference
mjpc/testspeed.{h,cc}, flags testspeed_app.cc:23-28):
SynchronousPlanningCost runs `plan_every` physics steps per planning
iteration for `total_time` simulated seconds and prints the accumulated
cost, wall time and realtime factor (printout testspeed.cc:118-122). One
plan and one step run first, outside the timed window, and the state is
reset after them.

Usage:
  python -m mujoco_mpc_torch.tools.testspeed --task=Cartpole \\
      --planner=sampling --total_time=10 --plan_every=4 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from mujoco_mpc_torch import device as devices


def _reset(agent, keyframe):
  try:
    agent.reset(keyframe=keyframe)
  except KeyError:
    agent.reset()


def synchronous_planning_cost(task_name: str, planner=None,
                              total_time: float = 10.0,
                              plan_every: int = 4,
                              keyframe: str | None = "home",
                              verbose: bool = True,
                              device=devices.DEFAULT) -> dict:
  from mujoco_mpc_torch.agent.agent import Agent

  agent = Agent(task_name, planner=planner, device=device)
  _reset(agent, keyframe)

  sim_dt = float(agent.sim_task.model.opt.timestep)
  nsteps = int(round(total_time / sim_dt))
  nplan = 0

  # warm-up outside the timed window (first calls build the kernel)
  agent.planner_step()
  agent.step()
  _reset(agent, keyframe)

  total_cost = 0.0
  t0 = time.perf_counter()
  for i in range(nsteps):
    if i % plan_every == 0:
      agent.planner_step()
      nplan += 1
    agent.step()
    total_cost += agent.total_cost() * sim_dt
  wall = time.perf_counter() - t0
  out = {
      "task": task_name,
      "planner": planner,
      "total_cost": total_cost,
      "wall_s": wall,
      "sim_s": nsteps * sim_dt,
      "realtime_factor": nsteps * sim_dt / wall,
      "planning_steps": nplan,
  }
  if verbose:
    print(f"Total time-accumulated cost: {total_cost:.3f}")
    print(f"Total wall time ({nplan} planning steps): {wall:.2f} s "
          f"({out['realtime_factor']:.2f}x realtime)")
  return out


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--task", default="Cartpole")
  p.add_argument("--planner", default="sampling")
  p.add_argument("--total_time", type=float, default=10.0)
  p.add_argument("--plan_every", type=int, default=4)
  p.add_argument("--device", default=devices.DEFAULT,
                 help="cuda (default) or cpu")
  args = p.parse_args(argv)
  synchronous_planning_cost(args.task, args.planner, args.total_time,
                            args.plan_every, device=args.device)


if __name__ == "__main__":
  main()
