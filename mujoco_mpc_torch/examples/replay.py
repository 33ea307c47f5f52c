"""Replay a recorded episode in the MuJoCo viewer (the headless
counterpart of the reference's GLFW app, mjpc/app.cc:209-386).

Counterpart of examples/replay.py. The trace is a TraceRecorder .npz
(tools/trace.py; either package's): times/qpos/qvel/ctrl/cost arrays plus
task metadata. The viewer and the video need `mujoco` (and a display or a
GL backend); the model is the one the task's snapshot was built from
(tasks/registry.py::get_mj_model). --summary needs neither.

Usage:
  python -m mujoco_mpc_torch.examples.replay trace.npz          # live view
  python -m mujoco_mpc_torch.examples.replay trace.npz --video out.mp4
  python -m mujoco_mpc_torch.examples.replay trace.npz --summary  # no GL
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("trace", help=".npz file from TraceRecorder.save")
  ap.add_argument("--task", default=None,
                  help="task name (default: from trace metadata)")
  ap.add_argument("--video", default=None,
                  help="render offscreen to this .mp4 instead of live view")
  ap.add_argument("--summary", action="store_true",
                  help="print a text summary only (no GL required)")
  ap.add_argument("--fps", type=float, default=None,
                  help="playback rate (default: recorded timestamps)")
  args = ap.parse_args(argv)

  data = np.load(args.trace, allow_pickle=False)
  meta = json.loads(str(data["meta"])) if "meta" in data else {}
  task_name = args.task or meta.get("task")
  if task_name is None:
    raise SystemExit("--task required (trace has no metadata)")

  times, qpos = data["times"], data["qpos"]
  print(f"trace: {len(times)} frames over {times[-1] - times[0]:.2f}s, "
        f"task={task_name}, planner={meta.get('planner', '?')}")
  if "cost" in data:
    c = data["cost"]
    print(f"cost: start {c[0]:.4f} min {c.min():.4f} end {c[-1]:.4f}")
  if args.summary:
    print(f"qpos[0] range: [{qpos[:, 0].min():.3f}, {qpos[:, 0].max():.3f}]")
    return

  import mujoco

  from mujoco_mpc_torch.tasks import registry
  m = registry.get_mj_model(task_name)
  d = mujoco.MjData(m)

  if args.video:
    import imageio
    renderer = mujoco.Renderer(m, height=480, width=640)
    frames = []
    stride = max(1, len(qpos) // int((times[-1] - times[0]) * 30 + 1))
    for q in qpos[::stride]:
      d.qpos[:] = q
      mujoco.mj_forward(m, d)
      renderer.update_scene(d)
      frames.append(renderer.render())
    imageio.mimsave(args.video, frames, fps=30)
    print(f"wrote {args.video} ({len(frames)} frames)")
    return

  import mujoco.viewer
  with mujoco.viewer.launch_passive(m, d) as viewer:
    t_prev = times[0]
    for q, t in zip(qpos, times):
      if not viewer.is_running():
        break
      d.qpos[:] = q
      mujoco.mj_forward(m, d)
      viewer.sync()
      dt = (1.0 / args.fps) if args.fps else float(t - t_prev)
      t_prev = t
      if dt > 0:
        time.sleep(dt)


if __name__ == "__main__":
  main()
