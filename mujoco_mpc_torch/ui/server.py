"""Interactive browser GUI for the MPC agent.

Counterpart of mujoco_mpc_tpu/ui/server.py. The reference is a desktop
application: a GLFW render loop with a planner dropdown, per-term
cost-weight sliders, task-parameter sliders, mode selection, pause/reset,
candidate traces and live cost / planner-timing plots (mjpc/simulate.{h,cc},
mjpc/app.cc:209-386; Simulate::Sidebar, mjpc/planners/planner.cc::Plots).
This module serves the same mutation and observability surface as a
zero-dependency web dashboard around the Agent, on the card unless asked
for the CPU:

  python -m mujoco_mpc_torch.ui --task Walker --port 8008 [--device cpu]

* a physics loop and a plan loop in threads (reference PhysicsLoop /
  PlanLoop, app.cc:117-206), pause/resume, realtime pacing with a speed
  slider; a loop that fails records its error, which /api/state reports
  under "error", and both loops stop
* planner dropdown over every registered planner, switched live with the
  sim state kept (the loops are stopped around the swap)
* task dropdown over the registry; mode dropdown (transition FSMs)
* per-term cost-weight and task-parameter sliders
* live plots: per-term cost history and planner iteration time
* rendered frames over HTTP where `mujoco` imports and a GL backend works
  (EGL headless); elsewhere /frame.jpg answers 404 with the reason and the
  dashboard shows plots only (the card's host has no `mujoco`)
* best-trajectory trace overlay (reference candidate traces,
  sampling/planner.cc:401-438)

Endpoints (all JSON unless noted):
  GET  /                 dashboard page (no external assets)
  GET  /api/state        full observable state + history ring
  POST /api/set          {weights|params|mode|paused|speed|ctrl_noise|traces}
  POST /api/planner      {planner}   POST /api/task  {task}
  POST /api/reset        (home keyframe)
  GET  /frame.jpg        latest render (404 with the reason without one)
"""

from __future__ import annotations

import collections
import io
import json
import os
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.tools.trace import best_root_trace
from mujoco_mpc_torch.ui import page as page_mod

HISTORY = 600  # plot ring length (samples; ~1 sample / 2 sim steps)


class AgentUI:
  """Owns the Agent, the physics/plan threads, and the render state."""

  def __init__(self, task: str = "Cartpole", planner: Optional[str] = None,
               render: bool = True, width: int = 480, height: int = 360,
               ctrl_noise: float = 0.0, device=devices.DEFAULT):
    self.device = devices.resolve(device)
    self._ui_lock = threading.RLock()  # guards agent swaps + history
    self.width, self.height = width, height
    self.render_enabled = render
    self.ctrl_noise = ctrl_noise
    self.speed = 1.0           # realtime factor (reference speed slider)
    self.paused = False
    self.traces = False
    self._running = False
    self._phys_thread = None
    self._plan_thread = None
    self._exit = threading.Event()
    # the failure that stopped the loops ("where: Type: message"), and its
    # traceback
    self.error: Optional[str] = None
    self.error_traceback: Optional[str] = None
    self.plan_times = collections.deque(maxlen=50)
    self.history = collections.deque(maxlen=HISTORY)
    self._trace_pts = np.zeros((0, 3))
    self._trace_tick = 0.0
    # render state: a GL context is bound to the thread that created it,
    # so a dedicated render thread owns the Renderer and publishes JPEG
    # bytes; HTTP handler threads only read the published frame
    self._frame = None          # latest jpeg bytes
    self._frame_req = 0.0       # last client request time (render gating)
    self._frame_ready = threading.Event()
    self._render_thread = None
    self._render_gen = 0        # bumped on task swap → renderer rebuild
    self.render_ok = None       # None until first probe, then bool
    self.render_error = None if render else "rendering is off (render=False)"
    self._build(task, planner)

  # ------------------------------------------------------------- lifecycle
  def _build(self, task_name: str, planner: Optional[str]):
    from mujoco_mpc_torch.agent.agent import Agent

    self.task_name = task_name
    self.agent = Agent(task_name, planner=planner, device=self.device)
    try:
      self.agent.reset(keyframe="home")
    except KeyError:
      self.agent.reset()
    self.history.clear()
    self.plan_times.clear()
    self._trace_pts = np.zeros((0, 3))
    self._frame = None
    self._render_gen += 1

  def start(self):
    with self._ui_lock:
      if self._running:
        return
      self._running = True
      self._exit.clear()
      self.error = self.error_traceback = None
      self._phys_thread = threading.Thread(target=self._phys_loop,
                                           daemon=True)
      self._plan_thread = threading.Thread(target=self._plan_loop,
                                           daemon=True)
      self._phys_thread.start()
      self._plan_thread.start()
      if self.render_enabled and self._render_thread is None:
        self._render_thread = threading.Thread(target=self._render_loop,
                                               daemon=True)
        self._render_thread.start()

  def stop(self):
    self._exit.set()
    self._frame_ready.set()
    for t in (self._phys_thread, self._plan_thread, self._render_thread):
      if t is not None:
        t.join(timeout=30)
    self._phys_thread = self._plan_thread = self._render_thread = None
    self._running = False

  def _fail(self, where: str, e: BaseException):
    """Record a loop's failure for /api/state and stop both loops."""
    if self.error is None:
      self.error = f"{where}: {type(e).__name__}: {e}"
      self.error_traceback = traceback.format_exc()
    self._exit.set()

  # ----------------------------------------------------------------- loops
  def _phys_loop(self):
    """Realtime-paced sim stepping (reference PhysicsLoop, app.cc:117-148).

    Pacing follows sim time so the view runs at `speed` x realtime
    regardless of how fast the device steps."""
    tick = 0
    try:
      while not self._exit.is_set():
        if self.paused:
          time.sleep(0.05)
          continue
        with self._ui_lock:
          agent = self.agent
          dt = float(agent.sim_task.model.opt.timestep)
        t0 = time.perf_counter()
        agent.step(ctrl_noise_std=self.ctrl_noise)
        tick += 1
        if tick % 2 == 0:
          terms = agent.cost_terms()
          self.history.append({
              "t": float(agent.data.time),
              "total": float(sum(terms.values())),
              "terms": {k: float(v) for k, v in terms.items()},
          })
        lag = dt / max(self.speed, 1e-3) - (time.perf_counter() - t0)
        if lag > 0:
          time.sleep(lag)
    except Exception as e:  # reported by /api/state
      self._fail("physics loop", e)

  def _plan_loop(self):
    """Asynchronous planner iterations (reference PlanLoop,
    app.cc:151-206), recording each iteration's wall time, its device work
    included, for the timing plot (planner.cc::Plots 'time' figure)."""
    try:
      while not self._exit.is_set():
        if self.paused:
          time.sleep(0.05)
          continue
        with self._ui_lock:
          agent = self.agent
        t0 = time.perf_counter()
        agent.planner_step()
        devices.wait(agent.device)
        self.plan_times.append(time.perf_counter() - t0)
        if self.traces and time.perf_counter() - self._trace_tick > 0.5:
          self._trace_tick = time.perf_counter()
          # every other state of the first 24
          self._trace_pts = best_root_trace(agent, horizon=24, stride=2)
    except Exception as e:  # reported by /api/state
      self._fail("plan loop", e)

  # -------------------------------------------------------------- mutation
  def set_planner(self, name: str):
    from mujoco_mpc_torch.agent.agent import _PLANNERS
    if name not in _PLANNERS:
      raise KeyError(f"unknown planner {name!r}")
    self._swap(lambda: self._rebuild(planner=name))

  def set_task(self, name: str):
    from mujoco_mpc_torch.tasks import registry
    if name not in registry.task_names():
      raise KeyError(f"unknown task {name!r}")
    self._swap(lambda: self._build(name, None))

  def _rebuild(self, planner: str):
    st = self.agent.get_state()
    self._build(self.task_name, planner)
    self.agent.set_state(qpos=st["qpos"], qvel=st["qvel"], time=st["time"])

  def _swap(self, fn):
    """fn with the loops stopped (restarted after it where they ran)."""
    was_running = self._running
    if was_running:
      self.stop()
    with self._ui_lock:
      fn()
    if was_running:
      self.start()

  def reset(self):
    with self._ui_lock:
      try:
        self.agent.reset(keyframe="home")
      except KeyError:
        self.agent.reset()
      self.history.clear()

  # ------------------------------------------------------------- observers
  def state(self) -> dict:
    from mujoco_mpc_torch.agent.agent import _PLANNERS
    from mujoco_mpc_torch.tasks import registry

    with self._ui_lock:
      agent = self.agent
      hist = list(self.history)
    weights = {k: float(v) for k, v in agent.get_cost_weights().items()}
    residual_params = agent.task.params.residual_params.cpu().numpy()
    params = {n: float(residual_params[i])
              for i, n in enumerate(agent.task.param_names)}
    pt = list(self.plan_times)
    out = {
        "task": self.task_name,
        "tasks": registry.task_names(),
        "planner": agent.planner_name,
        "planners": sorted(_PLANNERS),
        "mode": agent.get_mode(),
        "modes": list(agent.mode_names),
        "time": float(agent.data.time),
        "paused": self.paused,
        "speed": self.speed,
        "ctrl_noise": self.ctrl_noise,
        "traces": self.traces,
        "weights": weights,
        "params": params,
        "planner_ms": round(1e3 * float(np.mean(pt)), 2) if pt else None,
        "planner_hz": round(1.0 / float(np.mean(pt)), 1) if pt else None,
        "render": bool(self.render_enabled if self.render_ok is None
                       else self.render_ok),
        "history": hist,
    }
    if self.error is not None:
      out["error"] = self.error
    return out

  def _render_loop(self):
    """Owns the GL context (thread-bound) and publishes JPEG frames at
    ~12 fps while a client is polling (reference render loop,
    simulate.cc RenderLoop). Rebuilds the renderer on task swaps. Where
    `mujoco` or a GL backend is missing, or a render fails, the reason is
    kept for /frame.jpg's 404 and the thread ends."""
    from mujoco_mpc_torch.tasks import registry

    renderer = mj = mjd = cam = None
    gen = -1
    try:
      # mujoco picks its GL backend when it is first imported: headless
      # EGL unless the caller chose one
      os.environ.setdefault("MUJOCO_GL", "egl")
      import mujoco
      from PIL import Image
      while not self._exit.is_set():
        if gen != self._render_gen:
          gen = self._render_gen
          if renderer is not None:
            renderer.close()
          mj = registry.get_mj_model(self.task_name)
          mjd = mujoco.MjData(mj)
          renderer = mujoco.Renderer(mj, self.height, self.width)
          cam = mujoco.MjvCamera()
          mujoco.mjv_defaultFreeCamera(mj, cam)
          self.render_ok = True
        if time.perf_counter() - self._frame_req > 3.0:
          time.sleep(0.1)  # nobody watching: don't render
          continue
        self._render_frame(mujoco, Image, renderer, mj, mjd, cam)
        time.sleep(0.08)
    except Exception as e:  # reported by /frame.jpg
      self.render_error = f"{type(e).__name__}: {e}"
      self.render_ok = False
      self._frame_ready.set()

  def _render_frame(self, mujoco, Image, renderer, mj, mjd, cam):
    st = self.agent.get_state()
    n = min(len(st["qpos"]), mj.nq)
    mjd.qpos[:n] = st["qpos"][:n]
    nv = min(len(st["qvel"]), mj.nv)
    mjd.qvel[:nv] = st["qvel"][:nv]
    nm = min(len(st["mocap_pos"]), mj.nmocap)
    if nm:
      mjd.mocap_pos[:nm] = st["mocap_pos"][:nm]
      mjd.mocap_quat[:nm] = st["mocap_quat"][:nm]
    mujoco.mj_forward(mj, mjd)
    renderer.update_scene(mjd, camera=cam)
    if self.traces and len(self._trace_pts):
      scn = renderer.scene
      for pt in self._trace_pts:
        if scn.ngeom >= scn.maxgeom:
          break
        g = scn.geoms[scn.ngeom]
        mujoco.mjv_initGeom(
            g, mujoco.mjtGeom.mjGEOM_SPHERE, [0.012, 0, 0],
            np.asarray(pt, dtype=np.float64), np.eye(3).ravel(),
            [0.16, 0.68, 0.47, 0.8])
        scn.ngeom += 1
    img = renderer.render()
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=80)
    self._frame = buf.getvalue()
    self._frame_ready.set()

  def frame_jpeg(self, timeout: float = 5.0) -> Optional[bytes]:
    """Latest rendered frame (None where there is none: render_error says
    why)."""
    if not self.render_enabled or self.render_ok is False:
      return None
    self._frame_req = time.perf_counter()
    if self._frame is None:  # first frame: wait for the render thread
      self._frame_ready.wait(timeout)
    if self._frame is None and self.render_error is None:
      self.render_error = ("no frame yet: the render thread runs while the "
                           "loops do (start())")
    return self._frame


def make_server(ui: AgentUI, port: int = 0,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
  """Bind the dashboard HTTP server (port=0 picks a free port)."""

  class Handler(BaseHTTPRequestHandler):

    def log_message(self, *a):  # quiet
      pass

    def _json(self, obj, code=200):
      body = json.dumps(obj).encode()
      self.send_response(code)
      self.send_header("Content-Type", "application/json")
      self.send_header("Content-Length", str(len(body)))
      self.end_headers()
      self.wfile.write(body)

    def do_GET(self):
      path = self.path.split("?")[0]
      if path == "/":
        body = page_mod.PAGE.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
      elif path == "/api/state":
        self._json(ui.state())
      elif path == "/frame.jpg":
        jpg = ui.frame_jpeg()
        if jpg is None:
          self._json({"error": ui.render_error}, 404)
          return
        self.send_response(200)
        self.send_header("Content-Type", "image/jpeg")
        self.send_header("Content-Length", str(len(jpg)))
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        self.wfile.write(jpg)
      else:
        self._json({"error": "not found"}, 404)

    def do_POST(self):
      n = int(self.headers.get("Content-Length", 0))
      try:
        req = json.loads(self.rfile.read(n) or b"{}")
      except json.JSONDecodeError:
        self._json({"error": "bad json"}, 400)
        return
      path = self.path.split("?")[0]
      try:
        if path == "/api/set":
          if "weights" in req:
            ui.agent.set_cost_weights(
                {k: float(v) for k, v in req["weights"].items()})
          for name, val in req.get("params", {}).items():
            ui.agent.set_task_parameter(name, float(val))
          if "mode" in req:
            ui.agent.set_mode(req["mode"])
          if "paused" in req:
            ui.paused = bool(req["paused"])
          if "speed" in req:
            ui.speed = min(max(float(req["speed"]), 0.05), 10.0)
          if "ctrl_noise" in req:
            ui.ctrl_noise = max(float(req["ctrl_noise"]), 0.0)
          if "traces" in req:
            ui.traces = bool(req["traces"])
        elif path == "/api/planner":
          ui.set_planner(req["planner"])
        elif path == "/api/task":
          ui.set_task(req["task"])
        elif path == "/api/reset":
          ui.reset()
        else:
          self._json({"error": "not found"}, 404)
          return
      except (KeyError, ValueError) as e:
        self._json({"error": str(e)}, 400)
        return
      self._json({"ok": True})

  return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
  import argparse

  p = argparse.ArgumentParser(description="mujoco_mpc_torch web dashboard")
  p.add_argument("--task", default="Cartpole")
  p.add_argument("--planner", default=None)
  p.add_argument("--port", type=int, default=8008)
  p.add_argument("--host", default="127.0.0.1")
  p.add_argument("--no-render", action="store_true")
  p.add_argument("--ctrl-noise", type=float, default=0.0)
  p.add_argument("--device", default=devices.DEFAULT,
                 help="cuda (default) or cpu")
  args = p.parse_args(argv)
  ui = AgentUI(args.task, planner=args.planner, render=not args.no_render,
               ctrl_noise=args.ctrl_noise, device=args.device)
  ui.start()
  srv = make_server(ui, port=args.port, host=args.host)
  print(f"mujoco_mpc_torch dashboard: http://{args.host}:"
        f"{srv.server_address[1]}/  (task={args.task}, device={ui.device}, "
        f"render={'on' if ui.render_enabled else 'off'})")
  try:
    srv.serve_forever()
  except KeyboardInterrupt:
    pass
  finally:
    ui.stop()
    srv.server_close()


if __name__ == "__main__":
  main()
