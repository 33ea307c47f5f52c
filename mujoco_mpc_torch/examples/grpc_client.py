"""Drive the agent over gRPC (reference: python/mujoco_mpc demos).

Counterpart of examples/grpc_client.py: the port's AgentClient spawns the
port's agent server and drives Particle through it.

Usage: python -m mujoco_mpc_torch.examples.grpc_client [--device cpu]
"""

import argparse

from mujoco_mpc_torch import device as devices


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--device", default=devices.DEFAULT)
  args = parser.parse_args(argv)

  from mujoco_mpc_torch.service.client import AgentClient

  with AgentClient("Particle", device=args.device) as agent:
    agent.set_state(qpos=[0.2, -0.2])
    print("cost terms:", agent.get_cost_term_values())
    for _ in range(50):
      agent.planner_step()
      agent.step()
    print("final state:", agent.get_state()["qpos"],
          "cost:", agent.get_total_cost())


if __name__ == "__main__":
  main()
