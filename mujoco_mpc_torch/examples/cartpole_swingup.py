"""Cartpole balance + recenter demo (the reference's own cartpole task:
task.xml home is cart x=1 / pole up, solved by the gradient planner —
reference mjpc/tasks/cartpole/task.xml:10,48).

Counterpart of examples/cartpole_swingup.py.

Usage: python -m mujoco_mpc_torch.examples.cartpole_swingup [--device cpu]
"""

import argparse
import math

from mujoco_mpc_torch import device as devices


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--device", default=devices.DEFAULT)
  args = parser.parse_args(argv)

  from mujoco_mpc_torch.agent.agent import Agent

  agent = Agent("Cartpole", device=args.device)
  agent.reset(keyframe="home")  # cart at x=1, pole up (reference home)
  print(f"initial cost: {agent.total_cost():.2f}")
  for i in range(300):
    if i % 2 == 0:
      agent.planner_step()
    agent.step()
  st = agent.get_state()
  ang = float(st["qpos"][1]) % (2 * math.pi)
  print(f"final cost: {agent.total_cost():.3f}; "
        f"cart {float(st['qpos'][0]):.3f}; "
        f"pole {min(ang, 2*math.pi-ang):.3f} rad from upright")


if __name__ == "__main__":
  main()
