"""Humanoid walking demo with 1024-candidate batches; run on the card.

Counterpart of examples/humanoid_walk.py: the sampling planner and the
physics step driven directly, a plan every 2 steps.

Usage: python -m mujoco_mpc_torch.examples.humanoid_walk [--device cpu]
"""

import argparse
import dataclasses

from mujoco_mpc_torch import device as devices


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--device", default=devices.DEFAULT)
  args = parser.parse_args(argv)

  import torch

  from mujoco_mpc_torch.physics import io as phys_io
  from mujoco_mpc_torch.physics import step as phys_step
  from mujoco_mpc_torch.planners import sampling
  from mujoco_mpc_torch.tasks import registry

  dev = devices.resolve(args.device)
  task = registry.get_task("Humanoid Walk", device=dev)
  cfg = dataclasses.replace(sampling.SamplingConfig.from_task(task),
                            num_trajectories=1024)
  planner = sampling.SamplingPlanner(cfg)
  policy = planner.init(task)
  d = phys_io.make_data(task.model).replace(qpos=torch.as_tensor(
      task.model.keyframe("home")[0], dtype=task.model.dtype, device=dev))
  gen = torch.Generator(device=dev).manual_seed(0)
  # the Humanoid Walk model names its head site "head" (the JAX example
  # asks for "head_site", which only Humanoid Interact's model has)
  head = task.model.site("head")
  for i in range(800):
    if i % 2 == 0:
      policy, info = planner.optimize(task, policy, d, gen)
    d = d.replace(ctrl=planner.action(task, policy, d))
    d = phys_step.step(task.model, d)
    if i % 100 == 99:
      print(f"t={float(d.time):4.1f}s  x={float(d.qpos[0]):+5.2f}m  "
            f"head z={float(d.site_xpos[head, 2]):.2f}  "
            f"best={float(info.best_return):.3f}")


if __name__ == "__main__":
  main()
