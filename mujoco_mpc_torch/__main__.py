"""CLI entry point (reference mjpc/main.cc: --task flag + run loop).

Counterpart of mujoco_mpc_tpu/__main__.py. Headless: run the agent on a
task through tools/testspeed.py's loop and print its cost and realtime
factor, on the card unless --device cpu.

  python -m mujoco_mpc_torch --task Cartpole --planner sampling --time 5
  python -m mujoco_mpc_torch --list
"""

import argparse
import sys

from mujoco_mpc_torch import device as devices


def main(argv=None):
  p = argparse.ArgumentParser(prog="mujoco_mpc_torch",
                              description=__doc__.splitlines()[0])
  p.add_argument("--task", default="Cartpole")
  p.add_argument("--planner", default="")
  p.add_argument("--time", type=float, default=5.0,
                 help="simulated seconds")
  p.add_argument("--plan_every", type=int, default=2)
  p.add_argument("--list", action="store_true", help="list tasks and exit")
  p.add_argument("--device", default=devices.DEFAULT,
                 help="cuda (default) or cpu")
  args = p.parse_args(argv)

  from mujoco_mpc_torch.tasks import registry
  if args.list:
    from mujoco_mpc_torch.agent import agent as agent_mod
    print("tasks:", ", ".join(registry.task_names()))
    print("planners:", ", ".join(sorted(agent_mod._PLANNERS)))
    return 0

  from mujoco_mpc_torch.tools.testspeed import synchronous_planning_cost
  synchronous_planning_cost(args.task, args.planner or None,
                            total_time=args.time,
                            plan_every=args.plan_every, device=args.device)
  return 0


if __name__ == "__main__":
  sys.exit(main())
