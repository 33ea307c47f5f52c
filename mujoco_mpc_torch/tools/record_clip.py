"""Record a marker clip for Humanoid Track from a driven simulation.

Counterpart of mujoco_mpc_tpu/tools/record_clip.py. The reference
interpolates real CMU mocap keyframes (mjpc/tasks/humanoid/tracking/
tracking.cc:28-141); those files are not shippable, so this tool drives
Humanoid Walk with its planner and samples the tracking marker set at the
clip rate. It writes the clip format tasks/humanoid_track.py loads
(markers (L, nmarker, 3), fps, name).

Usage:
  python -m mujoco_mpc_torch.tools.record_clip --steps 800 \\
      --out mujoco_mpc_torch/tasks/models/assets/clips/strider.npz \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import os

from mujoco_mpc_torch import device as devices


def main(argv=None) -> str:
  p = argparse.ArgumentParser(description="record a Humanoid Track clip")
  p.add_argument("--task", default="Humanoid Walk")
  p.add_argument("--steps", type=int, default=800)
  p.add_argument("--plan_every", type=int, default=2)
  p.add_argument("--fps", type=float, default=30.0)
  p.add_argument("--name", default="strider")
  p.add_argument("--out", required=True)
  p.add_argument("--candidates", type=int, default=0)
  p.add_argument("--param", action="append", default=[],
                 help="task parameter override, name=value (repeatable); "
                      "e.g. --param Speed=2.5 records a faster gait")
  p.add_argument("--keyframe", default="home")
  p.add_argument("--device", default=devices.DEFAULT,
                 help="cuda (default) or cpu")
  args = p.parse_args(argv)

  import numpy as np

  from mujoco_mpc_torch.agent.agent import Agent
  from mujoco_mpc_torch.physics import step as phys_step
  from mujoco_mpc_torch.tasks import humanoid_track
  from mujoco_mpc_torch.tools.drive import with_candidates

  agent = Agent(args.task, device=args.device)
  if args.candidates:
    with_candidates(agent, args.candidates)
  agent.reset(keyframe=args.keyframe)
  for kv in args.param:
    name, val = kv.split("=", 1)
    agent.set_task_parameter(name, float(val))
  m = agent.sim_task.model
  marker_ids = [m.body(n) for n in humanoid_track._MARKERS]

  frames = []
  next_sample = 0.0
  for i in range(args.steps):
    if i % args.plan_every == 0:
      agent.planner_step()
    agent.step()
    t = float(agent.data.time)
    if t >= next_sample:
      df = phys_step.forward(m, agent.data)
      frames.append(df.xpos[marker_ids].cpu().numpy())
      next_sample += 1.0 / args.fps

  out = os.path.abspath(args.out)
  os.makedirs(os.path.dirname(out), exist_ok=True)
  np.savez(out, markers=np.asarray(frames), fps=args.fps, name=args.name)
  print(f"wrote {len(frames)} frames ({len(frames)/args.fps:.1f} s) "
        f"to {out}; final sim x = {float(agent.data.qpos[0]):+.2f} m")
  return out


if __name__ == "__main__":
  main()
