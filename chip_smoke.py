"""Smoke run of mujoco_mpc_torch on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py [--out FILE.json]

Builds the CUDA kernel from mujoco_mpc_torch/csrc/, holds it against its
plain PyTorch version, drives the Walker agent's plan loop through it, and
times the planner at 1024 candidates x 80 steps. Exits non-zero, printing
no result, without a CUDA device or on any failed check. The last line of
standard output is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launch counts, errors and times.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def fail(msg: str):
  raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond, msg: str):
  if not cond:
    fail(msg)


def agreement(got, want, what: str):
  """(max relative, max absolute) |kernel - plain| of returns; fails on a
  non-finite kernel return or beyond rtol 2e-3."""
  import torch
  check(bool(torch.all(torch.isfinite(got))),
        f"{what}: non-finite kernel returns")
  diff = (got - want).abs()
  rel = float((diff / want.abs()).max())
  check(rel <= 2e-3, f"{what}: kernel disagrees with the plain version "
        f"(max rel err {rel:.3g} > 2e-3)")
  return rel, float(diff.max())


def timed_cuda(fn, reps: int) -> float:
  """Mean milliseconds per call of fn() between CUDA events."""
  import torch
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--out", help="also write every measured number here")
  args = ap.parse_args()

  import numpy as np
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
          file=sys.stderr)
    return 2
  from mujoco_mpc_torch.agent.agent import Agent
  from mujoco_mpc_torch.ops import _cuda_build
  from mujoco_mpc_torch.ops import megarollout as MR
  from mujoco_mpc_torch.physics import io as phys_io
  from mujoco_mpc_torch.physics import tilestep
  from mujoco_mpc_torch.planners import sampling
  from mujoco_mpc_torch.tasks import registry

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda", 0)
  rec = {}

  # ---- 1. the card and the toolchain
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  card = smi.stdout.strip().splitlines()[0]
  print(card)
  print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
  rec["card"] = card

  # ---- 2. build the kernel from the sources
  t = time.perf_counter()
  so = _cuda_build.build()
  _cuda_build.load()
  rec["build_s"] = time.perf_counter() - t
  ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text()
           .splitlines() if "registers" in ln or "stack frame" in ln]
  print(f"[2] built {so.name} in {rec['build_s']:.2f} s")
  for ln in ptxas:
    print(f"    {ln}")

  # ---- 3. kernel against its plain version on the card
  task = registry.get_task("Walker", device=dev)
  home = torch.tensor(task.model.keyframe("home")[0], device=dev)
  rng = np.random.RandomState(0)
  b = 128
  qp = home[:, None] + torch.tensor(rng.uniform(-0.05, 0.05, (9, b)),
                                    dtype=torch.float32, device=dev)
  qp[0] -= 0.03  # sink the walker a little: contacts active
  qv = torch.tensor(rng.uniform(-0.5, 0.5, (9, b)), dtype=torch.float32,
                    device=dev)
  ct = torch.tensor(rng.uniform(-1, 1, (6, b)), dtype=torch.float32,
                    device=dev)
  mr1 = MR.MegaRollout(task, 1, device=dev)
  kq, kv, kl = mr1.step(qp, qv, ct)
  pq, pv, view = tilestep.step_tb(mr1.tm, qp, qv, ct)
  torch.cuda.synchronize()
  scale = float(view.efc_lambda.abs().max())
  err = {"qpos": float((kq - pq).abs().max()),
         "qvel": float((kv - pv).abs().max()),
         "lambda": float((kl - view.efc_lambda).abs().max())}
  print(f"[3] one step, B={b}: max |kernel - plain| qpos {err['qpos']:.3g} "
        f"(tol 1e-6), qvel {err['qvel']:.3g} (tol 1e-4), lambda "
        f"{err['lambda']:.3g} (tol {1e-5 * scale:.3g} = 1e-5 * max|lambda|)")
  check(scale > 1.0, "no contact force in the step check")
  check(err["qpos"] <= 1e-6 and err["qvel"] <= 1e-4
        and err["lambda"] <= 1e-5 * scale, "step kernel disagrees")
  rec["step_err"] = err

  n, horizon = 256, 20
  mr = MR.MegaRollout(task, horizon, device=dev)
  acts = torch.tensor(0.4 * rng.randn(n, horizon, 6), dtype=torch.float32,
                      device=dev)
  acts[7] = 1e30  # a diverging candidate
  v0 = torch.zeros(9, device=dev)
  t0 = torch.tensor(0.0, device=dev)
  got = mr.returns(home, v0, acts, task.params, t0)
  want = mr.returns_plain(home, v0, acts, task.params, t0)
  torch.cuda.synchronize()
  rel, max_abs = agreement(got, want, f"returns {n}x{horizon}")
  print(f"[3] returns {n}x{horizon}: max rel err {rel:.3g} (tol 2e-3), "
        f"max abs err {max_abs:.3g}; diverging candidate: kernel "
        f"{float(got[7]):g}, plain {float(want[7]):g}")
  check(float(got[7]) == float(want[7]) == MR.MAX_RETURN,
        "divergence guard")
  ms_small = timed_cuda(
      lambda: mr.returns(home, v0, acts, task.params, t0), 10)
  t = time.perf_counter()
  mr.returns_plain(home, v0, acts, task.params, t0)
  torch.cuda.synchronize()
  plain_small = (time.perf_counter() - t) * 1e3
  print(f"[3] {n}x{horizon}: kernel {ms_small:.3f} ms, plain "
        f"{plain_small:.1f} ms")
  rec.update(returns_rel_err=rel, returns_abs_err=max_abs,
             kernel_ms_256x20=ms_small, plain_ms_256x20=plain_small)

  # ---- 4. the main path: the agent's plan loop on the card
  agent = Agent("Walker", device=dev)
  agent.reset("home")
  cfg = agent.planner.config
  agent.planner.mega.launches = 0
  best = []
  t = time.perf_counter()
  for _ in range(5):
    info = agent.planner_step()
    best.append(float(info.best_return))
    check(bool(torch.all(torch.isfinite(info.costs))), "non-finite costs")
  u = agent.action()
  plan_ms = (time.perf_counter() - t) * 1e3 / 5
  launches = agent.planner.mega.launches
  print(f"[4] Agent('Walker', cuda) {cfg.num_trajectories}x{cfg.horizon} "
        f"at dt {float(agent.task.model.opt.timestep):g}: best returns "
        f"{[round(x, 4) for x in best]}, action {np.round(u, 3).tolist()}, "
        f"kernel launches {launches}, {plan_ms:.1f} ms per planner_step "
        f"(first call included)")
  check(np.all(np.isfinite(u)) and u.shape == (6,), "bad action")
  check(all(b2 <= b1 for b1, b2 in zip(best, best[1:])),
        "best return increased at a fixed state")
  check(launches == 5, f"{launches} kernel launches for 5 plan steps")
  # one plan's candidates at the agent's shape and dt: kernel vs plain
  pl, atask, d = agent.planner, agent.task, agent.data
  new_times, _, cands = pl._gen_candidates(atask, agent.policy, d,
                                           agent.generator)
  plan_args = (d.qpos, d.qvel, pl._actions(atask, d, new_times, cands),
               atask.params, d.time)
  got = pl.mega.returns(*plan_args)
  want = pl.mega.returns_plain(*plan_args)
  torch.cuda.synchronize()
  rel4, abs4 = agreement(got, want, f"returns {cfg.num_trajectories}x"
                         f"{cfg.horizon} at the agent's dt")
  print(f"[4] one plan's candidates {tuple(plan_args[2].shape)}: max rel "
        f"err {rel4:.3g} (tol 2e-3), max abs err {abs4:.3g}")
  rec.update(agent_best=best, agent_launches=launches,
             agent_ms_per_plan=plan_ms, agent_returns_rel_err=rel4,
             agent_returns_abs_err=abs4)

  # ---- 5. the bench shape: 1024 candidates x 80 steps at the XML dt
  cfg = sampling.SamplingConfig(num_trajectories=1024, horizon=80,
                                spline_points=cfg.spline_points,
                                interp=cfg.interp)
  planner = sampling.SamplingPlanner(cfg)
  policy = planner.init(task)
  data = phys_io.make_data(task.model).replace(qpos=home.clone())
  gen = torch.Generator(device=dev).manual_seed(0)
  for _ in range(3):
    policy, info = planner.optimize(task, policy, data, gen)
  torch.cuda.synchronize()
  reps = 30
  per_call = []
  for _ in range(reps):
    t = time.perf_counter()
    policy, info = planner.optimize(task, policy, data, gen)
    torch.cuda.synchronize()
    per_call.append((time.perf_counter() - t) * 1e3)
  wall = sum(per_call) / 1e3
  q = np.percentile(per_call, [50, 66.7, 100])
  steps_s = reps * cfg.num_trajectories * cfg.horizon / wall
  acts = torch.tensor(0.4 * rng.randn(1024, 80, 6), dtype=torch.float32,
                      device=dev)
  got = planner.mega.returns(home, v0, acts, task.params, t0)
  torch.cuda.synchronize()
  t = time.perf_counter()
  plain = planner.mega.returns_plain(home, v0, acts, task.params, t0)
  torch.cuda.synchronize()
  plain_big = (time.perf_counter() - t) * 1e3
  rel5, abs5 = agreement(got, plain, "returns 1024x80")
  ms_big = timed_cuda(
      lambda: planner.mega.returns(home, v0, acts, task.params, t0), 10)
  print(f"[5] SamplingPlanner 1024x80 at dt {float(task.model.opt.timestep):g}"
        f": {steps_s:.0f} steps/s, {reps / wall:.2f} plan Hz; optimize "
        f"ms median {q[0]:.3f}, p66.7 {q[1]:.3f}, max {q[2]:.3f} (n={reps});"
        f" kernel {ms_big:.3f} ms/call, plain {plain_big:.1f} ms/call;"
        f" kernel vs plain max rel err {rel5:.3g} (tol 2e-3), max abs err "
        f"{abs5:.3g}")
  rec.update(returns_rel_err_1024x80=rel5, returns_abs_err_1024x80=abs5,
             plan_steps_per_s=steps_s, plan_hz=reps / wall,
             optimize_ms=per_call,
             kernel_ms_1024x80=ms_big, plain_ms_1024x80=plain_big)

  kernels = {"kernels": [{
      "name": "megarollout_returns", "route": "cuda",
      "source": "mujoco_mpc_torch/csrc/megarollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/megarollout.py:339",
      "launches": launches, "max_abs_err": abs5,
      "ms": ms_big, "plain_ms": plain_big}]}
  if args.out:
    with open(args.out, "w") as f:
      json.dump({**rec, **kernels}, f, indent=1)
  print(json.dumps(kernels))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
