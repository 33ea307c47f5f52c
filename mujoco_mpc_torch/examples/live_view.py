"""Live interactive viewer: plan-while-acting with GUI mutation + traces.

Counterpart of examples/live_view.py. The reference is an interactive
application: render loop ∥ physics loop ∥ plan loop with live weight/mode
mutation and candidate-trace rendering (mjpc/app.cc:209-386,464-503;
mjpc/planners/sampling/planner.cc:401-438). On a host with a display and
`mujoco`, mujoco.viewer's passive viewer runs around the asynchronous
Agent:

  python -m mujoco_mpc_torch.examples.live_view --task Cartpole
  python -m mujoco_mpc_torch.examples.live_view --task "Quadruped Flat" \\
      --ctrl-noise 0.05

Keys (the mutation surface of the RPC SetAnything/SetCostWeights/SetMode):
  M        cycle task mode            R   reset (home keyframe)
  UP/DOWN  scale first cost weight    T   toggle candidate traces
  SPACE    pause/resume physics

Without a display (the card's host has no `mujoco` either), --headless N
runs the same loop windowless and writes the best trajectory's root-body
trace every 20 steps and each plan's candidate returns to an .npz.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.tools.trace import best_root_trace


def main(argv=None):
  p = argparse.ArgumentParser(description="mujoco_mpc_torch live viewer")
  p.add_argument("--task", default="Cartpole")
  p.add_argument("--planner", default="sampling")
  p.add_argument("--ctrl-noise", type=float, default=0.0)
  p.add_argument("--headless", type=int, default=0,
                 help="run N steps without GL, export traces")
  p.add_argument("--trace-out", default="live_traces.npz")
  p.add_argument("--device", default=devices.DEFAULT,
                 help="cuda (default) or cpu")
  args = p.parse_args(argv)

  from mujoco_mpc_torch.agent.agent import Agent

  agent = Agent(args.task, planner=args.planner, device=args.device)
  try:
    agent.reset(keyframe="home")
  except KeyError:
    agent.reset()

  if args.headless:
    # windowless: the same loop, traces to disk
    agent.start_planning()
    traces, returns = [], []
    try:
      for i in range(args.headless):
        agent.step(ctrl_noise_std=args.ctrl_noise)
        if i % 20 == 0:
          traces.append(best_root_trace(agent))
          info = agent.last_info
          returns.append(info.costs.cpu().numpy() if info is not None
                         else np.zeros(1))
    finally:
      agent.stop_planning()
    np.savez(args.trace_out, traces=np.asarray(traces),
             candidate_returns=np.asarray(returns))
    print(f"wrote {len(traces)} trace snapshots to {args.trace_out}; "
          f"final cost {agent.total_cost():.3f}")
    return

  import mujoco
  import mujoco.viewer

  from mujoco_mpc_torch.tasks import registry
  mj = registry.get_mj_model(args.task)
  md = mujoco.MjData(mj)
  state = {"paused": False, "traces": True, "wscale": 1.0}

  def on_key(keycode):
    name = agent.task.spec.names[0]
    if keycode == ord(' '):
      state["paused"] = not state["paused"]
    elif keycode == ord('R'):
      agent.reset(keyframe="home")
    elif keycode == ord('T'):
      state["traces"] = not state["traces"]
    elif keycode == ord('M') and len(agent.mode_names) > 1:
      cur = agent.mode_names.index(agent.get_mode())
      agent.set_mode(agent.mode_names[(cur + 1) % len(agent.mode_names)])
      print("mode:", agent.get_mode())
    elif keycode == 265:  # UP
      state["wscale"] *= 1.25
      agent.set_cost_weights({name: state["wscale"]})
      print(f"weight {name} = {state['wscale']:.3f}")
    elif keycode == 264:  # DOWN
      state["wscale"] *= 0.8
      agent.set_cost_weights({name: state["wscale"]})
      print(f"weight {name} = {state['wscale']:.3f}")

  agent.start_planning()
  try:
    with mujoco.viewer.launch_passive(mj, md, key_callback=on_key) as v:
      while v.is_running():
        t0 = time.perf_counter()
        if not state["paused"]:
          agent.step(ctrl_noise_std=args.ctrl_noise)
        st = agent.get_state()
        md.qpos[:] = st["qpos"]
        md.qvel[:] = st["qvel"]
        mujoco.mj_forward(mj, md)
        if state["traces"] and agent.last_info is not None:
          pts = best_root_trace(agent, horizon=20)
          v.user_scn.ngeom = 0
          for pt in pts[::2]:
            if v.user_scn.ngeom >= v.user_scn.maxgeom:
              break
            g = v.user_scn.geoms[v.user_scn.ngeom]
            mujoco.mjv_initGeom(
                g, mujoco.mjtGeom.mjGEOM_SPHERE, [0.01, 0, 0],
                pt.astype(np.float64), np.eye(3).ravel(),
                [0.2, 0.8, 0.2, 0.7])
            v.user_scn.ngeom += 1
        v.sync()
        dt = float(mj.opt.timestep) - (time.perf_counter() - t0)
        if dt > 0:
          time.sleep(dt)
  finally:
    agent.stop_planning()


if __name__ == "__main__":
  main()
