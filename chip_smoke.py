"""Smoke run of mujoco_mpc_torch on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py [--out FILE.json]

Builds the CUDA kernel from mujoco_mpc_torch/csrc/ (one library per size
tier and precision, and an uncontracted float library per tier, the nvcc
processes at once) and, for each path it
serves (Walker, Humanoid Walk, Quadruped Flat, Shadow, Bimanual Handover
and Allegro, and the cross-entropy planner on Walker and Shadow), holds it
against its plain PyTorch version, drives the agent's plan loop through it,
and times the planner: Walker at 1024 candidates x 80 steps, Humanoid at
the north-star 256 x 67 at the planning dt 0.015, Quadruped at 1024 x 70,
Shadow at 512 x 100, the handover at 256 x 80 and Allegro at 512 x 80, the
last four at dt 0.005. The small class models (every equality kind,
condim 6) are held one step each. Humanoid rollouts that long are chaotic
in float32, so there the kernel's float64 instance is held against the
plain version in float64 candidate by candidate, and the float32 kernel as
a population; the Quadruped's, Shadow's, the handover's and Allegro's
float32 kernel is held per candidate within its own float32 noise; a
candidate beyond it passes only where the same source built without
multiply-add contraction lands within it, so that the miss lies in the
contraction's rounding alone.
Exits non-zero, printing no result, without a CUDA
device or on any failed check. The last line of standard output is
{"ok": true, "device": {...}}; the line before it lists the kernel once per
path with its launch count, error, time, plain time and bound.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time


def fail(msg: str):
  raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond, msg: str):
  if not cond:
    fail(msg)


def run_plain(fn, *args, **kwargs):
  """A call of the plain version under torch.inference_mode, which spares
  its thousands of small ops autograd's bookkeeping (its results only feed
  comparisons)."""
  import torch
  with torch.inference_mode():
    return fn(*args, **kwargs)


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


@contextlib.contextmanager
def uncontracted(MR):
  """MegaRollout's float kernels swapped for the same source built
  without multiply-add contraction (-fmad=false), which rounds as the
  plain version does, op for op."""
  import torch
  from mujoco_mpc_torch.ops import _cuda_build
  library = MR._library

  def swapped(tier, dtype):
    if dtype != torch.float32:
      return library(tier, dtype)
    lib = _cuda_build.load(MR.TIERS.index(tier), False, contract=False)
    MR.check_layout(lib.mr_model_layout, lib.mr_model_size,
                    MR._MODEL_STRUCT[tier, dtype])
    return lib

  MR._library = swapped
  try:
    yield
  finally:
    MR._library = library


def noise_bound(got, plain, plain64, what: str, hold: bool = True,
                witness=None) -> dict:
  """The float32 kernel per candidate against the plain float32 version
  within 2e-3 |p32| + 4 |p32 - p64|: the plain version's own float32
  distance from float64 widens the bound where rounding is amplified.
  Where a candidate is beyond it, `witness()` gives the returns of the
  same kernel built without contraction: a candidate whose uncontracted
  returns lie within the bound missed it by contraction rounding alone
  (listed in contraction_only). Fails, where `hold`, on any other
  candidate beyond the bound."""
  import torch
  check(bool(torch.all(torch.isfinite(got))),
        f"{what}: non-finite kernel returns")
  gap = (got - plain).abs()
  dist = (plain - plain64.to(plain.dtype)).abs()
  allowed = 2e-3 * plain.abs() + 4.0 * dist
  beyond = gap > allowed
  out = {"rel_err": float((gap / plain.abs()).max()),
         "abs_err": float(gap.max()),
         "gap_over_bound": float((gap / allowed).max()),
         "plain_f32_vs_f64_max_abs": float(dist.max()),
         "plain_f32_vs_f64_max_rel": float((dist / plain64.abs()).max()),
         "contraction_only": []}
  worst = int(torch.argmax(gap / allowed))
  out["worst"] = {"candidate": worst, "kernel": float(got[worst]),
                  "plain32": float(plain[worst]),
                  "plain64": float(plain64[worst])}
  if witness is not None and bool(beyond.any()):
    u = witness()
    ugap = (u - plain).abs()
    explained = beyond & (ugap <= allowed)
    for i in torch.nonzero(explained).flatten().tolist():
      out["contraction_only"].append({
          "candidate": i, "kernel": float(got[i]),
          "uncontracted": float(u[i]), "plain32": float(plain[i]),
          "plain64": float(plain64[i]),
          "kernel_over_bound": float(gap[i] / allowed[i]),
          "uncontracted_over_bound": float(ugap[i] / allowed[i])})
    beyond = beyond & ~explained
  over = out["beyond_noise_bound"] = int(beyond.sum())
  check(over == 0 or not hold, f"{what}: {over} candidates beyond |k - "
        f"p32| <= 2e-3 |p32| + 4 |p32 - p64| (the uncontracted kernel "
        f"beyond it too); the worst, {out['worst']}, at "
        f"{out['gap_over_bound']:.4g} of it")
  return out


def row_classes(tm):
  """tilestep.row_kinds with the box-box corner rows split by the box
  whose corner they hold."""
  import numpy as np
  from mujoco_mpc_torch.physics import tilestep
  kinds = list(tilestep.row_kinds(tm))
  for i, cp in enumerate(tilestep.row_points(tm)[0]):
    if cp.kind == "boxbox_corner":
      kinds[3 * i:3 * i + 3] = [f"boxbox_corner[box {cp.owner}]"] * 3
  return np.asarray(kinds)


# H100 SXM data sheet: f32 outside the tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# aten ops counted as arithmetic, by their output size (elementwise) or by
# their input size (reductions); a triangular solve counts n*n per column
_ELEMENTWISE = {"add", "sub", "rsub", "mul", "div", "neg", "reciprocal",
                "sqrt", "rsqrt", "pow", "exp", "log1p", "sin", "cos", "cosh",
                "tanh", "abs", "clamp", "clamp_min", "clamp_max", "minimum",
                "maximum", "where", "lt", "le", "gt", "ge", "eq", "ne",
                "bitwise_and", "bitwise_or", "logical_not", "isfinite"}
_REDUCTIONS = {"sum", "max", "amax", "min", "amin"}


def step_ops(task) -> int:
  """Floating-point operations of one plain step at B = 1: step_tb, the
  task residual, its weight_mod and the cost, counted per aten op. step_tb computes both
  sides of every torch.where and runs fixed iteration counts, so the count
  does not depend on the data. Counted on CPU tensors: it is a count of
  work from shapes, not a measurement."""
  import numpy as np
  import torch
  from torch.utils._python_dispatch import TorchDispatchMode
  from mujoco_mpc_torch.ops import megarollout as MR
  from mujoco_mpc_torch.physics import tilestep

  total = 0

  class Count(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
      nonlocal total
      out = func(*args, **(kwargs or {}))
      name = func.overloadpacket.__name__
      if name in _ELEMENTWISE:
        total += out.numel()
      elif name == "linalg_cross":
        total += 3 * out.numel()  # two products and a difference each
      elif name in _REDUCTIONS:
        total += args[0].numel()
      elif name == "linalg_solve_triangular":
        a, b = args[0], args[1]
        total += a.shape[-1] * a.shape[-1] * b[..., 0, :].numel()
      return out

  tm = tilestep.extract(task.model)
  p = task.params
  qpos = torch.tensor(np.asarray(task.model.keyframe("home")[0],
                                 np.float32))[:, None]
  with torch.inference_mode(), Count():
    _, _, view = tilestep.step_tb(tm, qpos, torch.zeros(tm.nv, 1),
                                  torch.zeros(tm.nu, 1),
                                  torch.zeros(tm.nrow, 1))
    view.time = torch.tensor(0.0)
    res = task.residual(task.model, view, p.residual_params)
    scale = (task.weight_mod(task.model, view, p.residual_params)
             if task.weight_mod is not None else None)
    MR.cost_value_t(task.spec, p.weights, p.norm_params, p.risk, res, scale)
  return total


def bound(ops_per_step: int, n: int, horizon: int, task):
  """(bound ms, what bounds it) for returns at n x horizon: the larger of
  the operations over the f32 peak and the bytes (actions in, returns
  out, the start state and task parameters, each once) over HBM
  bandwidth."""
  m = task.model
  p = task.params
  nbytes = 4 * (n * horizon * m.nu + n + m.nq + m.nv + p.weights.numel()
                + p.norm_params.numel() + p.residual_params.numel() + 2)
  t_ops = ops_per_step * n * horizon / PEAK_F32_FLOPS
  t_bytes = nbytes / PEAK_BYTES_S
  return (1e3 * max(t_ops, t_bytes),
          "operations" if t_ops >= t_bytes else "bytes")


def agreement64(got, want, what: str) -> dict:
  """Kernel vs plain returns, both in float64, candidate by candidate at
  rtol 2e-3. A candidate the plain version scores at MAX_RETURN or more
  (diverged, or blown up to a finite return past it) must be scored so by
  the kernel too: past that point nothing compares, in any precision."""
  import torch
  from mujoco_mpc_torch.ops import megarollout as MR
  check(bool(torch.all(~torch.isnan(got))), f"{what}: NaN kernel returns")
  blown = want >= MR.MAX_RETURN
  check(bool(torch.all(got[blown] >= MR.MAX_RETURN)),
        f"{what}: the kernel scores a candidate below MAX_RETURN that the "
        f"plain version scores at or above it")
  ok = ~blown
  diff = (got[ok] - want[ok]).abs()
  rel = diff / want[ok].abs()
  out = {"max_rel": float(rel.max()), "max_abs": float(diff.max()),
         "blown": int(blown.sum())}
  check(out["max_rel"] <= 2e-3, f"{what}: kernel disagrees with the plain "
        f"version (max rel err {out['max_rel']:.3g} > 2e-3)")
  return out


def float_noise(got, plain, plain64, what: str) -> dict:
  """The float32 kernel's distance from the float64 answer against the
  plain float32 version's, over all candidates: long humanoid rollouts
  amplify float rounding until no two float32 orderings agree to 2e-3 on
  every candidate, so the float kernel is held, as a population, to be no
  noisier than the plain float32 version (at most twice its count beyond
  rel 2e-3 of float64, at least 2, and at most twice its median, at least
  1e-5), and to pick a winner the plain float32 version scores within
  2e-3 of its best. Candidate by candidate the code is held in float64
  (agreement64)."""
  import torch
  check(bool(torch.all(torch.isfinite(got))),
        f"{what}: non-finite kernel returns")
  rel_k = ((got.double() - plain64) / plain64).abs()
  rel_p = ((plain.double() - plain64) / plain64).abs()
  out = {"kernel_beyond": int((rel_k > 2e-3).sum()),
         "plain_beyond": int((rel_p > 2e-3).sum()),
         "kernel_median": float(rel_k.median()),
         "plain_median": float(rel_p.median()),
         "kernel_vs_plain_max_rel": float(((got - plain) / plain).abs().max()),
         "winner": int(torch.argmin(got)),
         "plain_winner": int(torch.argmin(plain))}
  best = float(plain.min())
  allowed = max(2 * out["plain_beyond"], 2)
  check(out["kernel_beyond"] <= allowed,
        f"{what}: {out['kernel_beyond']} candidates beyond rel 2e-3 of "
        f"float64, the plain float32 version has {out['plain_beyond']}")
  check(out["kernel_median"] <= max(2 * out["plain_median"], 1e-5),
        f"{what}: median rel err {out['kernel_median']:.3g} above the "
        f"plain float32 version's")
  check(float(plain[out["winner"]]) <= best + 2e-3 * abs(best),
        f"{what}: the kernel's winner is not the plain version's best")
  return out


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


def probe_step(tag: str, mr, states, operands) -> dict:
  """One step of the float and double step kernels on probe states in which
  every row class carries force, against the plain step_tb: float32 qpos
  1e-5, qvel max(1e-3, 8 x the state's float32-vs-float64 distance), duals
  1e-4 * max; float64 1e-12, 1e-10, 1e-12 * max. `operands(dtype)` gives
  the mocap and userdata keywords. Returns the errors per precision and the
  largest dual per row class."""
  import numpy as np
  import torch
  from mujoco_mpc_torch.physics import tilestep

  dev = mr.device
  kinds = row_classes(mr.tm)
  plain = {}
  for dt in (torch.float32, torch.float64):
    x = [torch.tensor(v, device=dev, dtype=dt) for v in states]
    ops = operands(dt)
    pq, pv, view = run_plain(tilestep.step_tb, mr.tm, *x, **ops)
    plain[dt] = (x, ops, pq, pv, view.efc_lambda)
  torch.cuda.synchronize()
  signed = plain[torch.float32][4].cpu().numpy()
  lam = np.abs(signed)
  per_kind = {str(k): float(lam[kinds == k].max())
              for k in dict.fromkeys(kinds)}
  sign_range = {str(k): (float(signed[kinds == k].min()),
                         float(signed[kinds == k].max()))
                for k in dict.fromkeys(kinds)}
  check(all(v > 0.0 for v in per_kind.values()),
        f"{tag}: a constraint row class carries no force in the step check")
  noise = (plain[torch.float32][3].double()
           - plain[torch.float64][3]).abs().amax(0)
  err = {}
  for dt, key in ((torch.float32, "f32"), (torch.float64, "f64")):
    x, ops, pq, pv, pl = plain[dt]
    kq, kv, kl = mr.step(*x, **ops)
    torch.cuda.synchronize()
    ev = (kv - pv).abs().amax(0).double()
    err[key] = {"qpos": float((kq - pq).abs().max()),
                "qvel": float(ev.max()), "qvel_state": int(ev.argmax()),
                "lambda": float((kl - pl).abs().max()),
                "scale": float(pl.abs().max()),
                "qvel_over_noise": float((ev / noise).max()),
                "states_qvel_over_1e-3": int((ev > 1e-3).sum()),
                "qvel_ok": bool(torch.all(
                    ev <= torch.clamp(8.0 * noise, min=1e-3)))}
  e32, e64 = err["f32"], err["f64"]
  b = states[0].shape[1]
  print(f"[{tag}] one step, B={b}, nrow {mr.tm.nrow}, float32: max "
        f"|kernel - plain| qpos {e32['qpos']:.3g} (tol 1e-5), qvel "
        f"{e32['qvel']!r} at state {e32['qvel_state']} (tol max(1e-3, 8 x "
        f"the state's plain float32-vs-float64 distance, which is "
        f"{float(noise[e32['qvel_state']])!r} there); "
        f"{e32['states_qvel_over_1e-3']} states above 1e-3; worst ratio to "
        f"that distance {e32['qvel_over_noise']:.3g}), lambda "
        f"{e32['lambda']:.3g} (tol {1e-4 * e32['scale']:.3g} = 1e-4 * "
        f"max|lambda|)")
  print(f"[{tag}] float64: qpos {e64['qpos']:.3g} (tol 1e-12), qvel "
        f"{e64['qvel']:.3g} (tol 1e-10), lambda {e64['lambda']:.3g} (tol "
        f"{1e-12 * e64['scale']:.3g}); max |lambda| per row class "
        f"{({k: round(v, 3) for k, v in per_kind.items()})}")
  check(e32["qpos"] <= 1e-5 and e32["lambda"] <= 1e-4 * e32["scale"]
        and e32["qvel_ok"], f"{tag}: float32 step kernel disagrees")
  check(e64["qpos"] <= 1e-12 and e64["qvel"] <= 1e-10
        and e64["lambda"] <= 1e-12 * e64["scale"],
        f"{tag}: float64 step kernel disagrees")
  return {"err": err, "max_dual_per_class": per_kind,
          "dual_range_per_class": sign_range}


def drive_agent(tag: str, agent, nu: int, monotone: bool = True,
                noisy: bool = False):
  """The main path: the agent's launch count set to 0, 5 plan steps at a
  fixed state, the count read back. Checks one launch per plan, finite
  costs and action, and (for the sampling planner, whose candidate 0 is
  the previous winner) a best return that does not rise. Then one plan's
  candidates, with the state's mocap poses and userdata, through the
  kernel (timed) and the plain version, per candidate at rtol 2e-3 or,
  `noisy`, within 2e-3 |p32| + 4 |p32 - p64| (noise_bound). Returns (the
  numbers, that plan's actions)."""
  import numpy as np
  import torch
  cfg = agent.planner.config
  agent.planner.mega.launches = 0
  best = []
  t = time.perf_counter()
  for _ in range(5):
    info = agent.planner_step()
    best.append(float(info.best_return))
    check(bool(torch.all(torch.isfinite(info.costs))),
          f"{tag}: non-finite costs")
  u = agent.action()
  plan_ms = (time.perf_counter() - t) * 1e3 / 5
  launches = agent.planner.mega.launches
  print(f"[{tag}] Agent('{agent.task.name}', {agent.planner_name}, cuda) "
        f"{cfg.num_trajectories}x{cfg.horizon} at dt "
        f"{float(agent.task.model.opt.timestep):g}: best returns "
        f"{[round(x, 4) for x in best]}, kernel launches {launches}, "
        f"{plan_ms:.1f} ms per planner_step (first call included)")
  check(np.all(np.isfinite(u)) and u.shape == (nu,), f"{tag}: bad action")
  if monotone:
    check(all(b2 <= b1 for b1, b2 in zip(best, best[1:])),
          f"{tag}: best return increased at a fixed state")
  check(launches == 5, f"{tag}: {launches} kernel launches for 5 plan steps")
  pl, atask, d = agent.planner, agent.task, agent.data
  new_times, _, cands = pl._gen_candidates(atask, agent.policy, d,
                                           agent.generator)
  acts = pl._actions(atask, d, new_times, cands)
  args = (d.qpos, d.qvel, acts, atask.params, d.time)
  ops = dict(mocap_pos=d.mocap_pos, mocap_quat=d.mocap_quat,
             userdata=d.userdata)
  got = pl.mega.returns(*args, **ops)
  t = time.perf_counter()
  want = run_plain(pl.mega.returns_plain, *args, **ops)
  torch.cuda.synchronize()
  plain_ms = (time.perf_counter() - t) * 1e3
  what = f"{tag}: returns {tuple(acts.shape)}"
  out = {"best": best, "launches": launches, "ms_per_plan": plan_ms,
         "plain_ms": plain_ms}
  if noisy:
    want64 = run_plain(pl.mega.returns_plain, *args,
                       dtype=torch.float64, **ops)
    nb = out["noise"] = noise_bound(got, want, want64, what)
    rel, abs_err = nb["rel_err"], nb["abs_err"]
    tol = (f"tol 2e-3 |p32| + 4 |p32 - p64|, at most "
           f"{nb['gap_over_bound']:.3g} of it; plain float32 vs float64 "
           f"max abs {nb['plain_f32_vs_f64_max_abs']:.3g}, max rel "
           f"{nb['plain_f32_vs_f64_max_rel']:.3g}")
  else:
    rel, abs_err = agreement(got, want, what)
    tol = "tol 2e-3"
  ms = timed_cuda(lambda: pl.mega.returns(*args, **ops), 3)
  print(f"[{tag}] one plan's candidates {tuple(acts.shape)}: max rel err "
        f"{rel:.3g}, max abs err {abs_err:.3g} ({tol}); kernel {ms:.3f} "
        f"ms/call, plain {plain_ms:.1f} ms/call")
  out.update(returns_rel_err=rel, returns_abs_err=abs_err, kernel_ms=ms)
  return out, acts


def bench_shape(tag: str, task, n: int, horizon: int, cfg, operands,
                reps: int, chaotic: bool = False) -> dict:
  """The bench shape: SamplingPlanner.optimize timed at n x horizon at the
  task model's dt (median, p66.7, max over reps calls after a warm-up
  call), the kernel timed between CUDA events, and one plan's returns held
  against the plain version: the double instance per candidate in float64
  (agreement64), and the float kernel per candidate within 2e-3 |p32| +
  4 |p32 - p64| (noise_bound, with the uncontracted kernel as its
  witness) or, for chaotic rollouts, as a population (float_noise)."""
  import numpy as np
  import torch
  from mujoco_mpc_torch.ops import megarollout as MR
  from mujoco_mpc_torch.physics import io as phys_io
  from mujoco_mpc_torch.planners import sampling
  from mujoco_mpc_torch.tasks import registry

  dev = task.model.device
  shape = f"{n}x{horizon}"
  planner = sampling.SamplingPlanner(sampling.SamplingConfig(
      num_trajectories=n, horizon=horizon, spline_points=cfg.spline_points,
      interp=cfg.interp))
  policy = planner.init(task)
  home = torch.tensor(task.model.keyframe("home")[0], device=dev)
  ops32 = operands(torch.float32)
  data = phys_io.make_data(task.model).replace(qpos=home.clone(), **ops32)
  gen = torch.Generator(device=dev).manual_seed(0)
  policy, _ = planner.optimize(task, policy, data, gen)
  torch.cuda.synchronize()
  per_call = []
  for _ in range(reps):
    t = time.perf_counter()
    policy, _ = planner.optimize(task, policy, data, gen)
    torch.cuda.synchronize()
    per_call.append((time.perf_counter() - t) * 1e3)
  wall = sum(per_call) / 1e3
  q = np.percentile(per_call, [50, 66.7, 100])
  steps_s = reps * n * horizon / wall
  new_times, _, cands = planner._gen_candidates(task, policy, data, gen)
  acts = planner._actions(task, data, new_times, cands)
  v0 = torch.zeros(task.model.nv, device=dev)
  args = (home, v0, acts, task.params, data.time)
  got = planner.mega.returns(*args, **ops32)
  torch.cuda.synchronize()
  t = time.perf_counter()
  plain = run_plain(planner.mega.returns_plain, *args, **ops32)
  torch.cuda.synchronize()
  plain_ms = (time.perf_counter() - t) * 1e3
  ops64 = operands(torch.float64)
  args64 = (home.double(), v0.double(), acts.double(),
            task.params.to(dtype=torch.float64), data.time.double())
  got64 = planner.mega.returns(*args64, **ops64)
  torch.cuda.synchronize()
  t = time.perf_counter()
  plain64 = run_plain(planner.mega.returns_plain, *args64,
                      dtype=torch.float64, **ops64)
  torch.cuda.synchronize()
  plain64_ms = (time.perf_counter() - t) * 1e3
  name = task.name
  r64 = agreement64(got64, plain64, f"{name} returns {shape} in float64")
  check(bool(torch.all(torch.isfinite(got))),
        f"{name}: non-finite kernel returns at {shape}")
  rel_p = ((plain.double() - plain64) / plain64).abs()

  def witness():
    with uncontracted(MR):
      return planner.mega.returns(*args, **ops32)

  out = {"optimize_ms": per_call, "steps_per_s": steps_s,
         "plan_hz": reps / wall, "plain_ms": plain_ms,
         "plain64_ms": plain64_ms, "f64": r64,
         **noise_bound(got, plain, plain64, f"{name} returns {shape}",
                       hold=not chaotic, witness=None if chaotic else witness),
         "plain_f32_beyond_2e-3_of_f64": int((rel_p > 2e-3).sum())}
  over = out["beyond_noise_bound"]
  if chaotic:
    pop = out["population"] = float_noise(got, plain, plain64,
                                          f"{name} returns {shape}")
    print(f"[{tag}] float32 against float64, over all candidates: kernel "
          f"{pop['kernel_beyond']} beyond rel 2e-3 (median rel "
          f"{pop['kernel_median']:.3g}), plain float32 {pop['plain_beyond']} "
          f"(median {pop['plain_median']:.3g}); winner kernel "
          f"{pop['winner']}, plain {pop['plain_winner']}")
  out["kernel_ms"] = ms = timed_cuda(
      lambda: planner.mega.returns(*args, **ops32), 3)
  out["kernel64_ms"] = timed_cuda(
      lambda: planner.mega.returns(*args64, **ops64), 1)
  out["step_ops"] = step_ops(registry.get_task(name, device="cpu"))
  out["bound_ms"], out["bound_by"] = bound(out["step_ops"], n, horizon, task)
  print(f"[{tag}] SamplingPlanner {shape} at dt "
        f"{float(task.model.opt.timestep):g}: {steps_s:.0f} steps/s, "
        f"{reps / wall:.3f} plan Hz; optimize ms median {q[0]:.3f}, p66.7 "
        f"{q[1]:.3f}, max {q[2]:.3f} (n={reps}); kernel {ms:.3f} ms/call "
        f"({ms / horizon:.3f} ms per step), plain {plain_ms:.1f} ms/call")
  print(f"[{tag}] float64 kernel vs float64 plain, per candidate: max rel "
        f"err {r64['max_rel']:.3g} (tol 2e-3), max abs err "
        f"{r64['max_abs']:.3g}, {r64['blown']} at or past MAX_RETURN in "
        f"both; float64 kernel {out['kernel64_ms']:.3f} ms/call, plain "
        f"{plain64_ms:.1f} ms/call")
  print(f"[{tag}] float32 kernel vs float32 plain, per candidate: max rel "
        f"err {out['rel_err']:.3g}, max abs err {out['abs_err']:.3g}; beyond "
        f"2e-3 |p32| + 4 |p32 - p64|: {over}"
        f"{' (not a check: chaotic, held as a population)' if chaotic else ''}"
        f"; plain float32 vs float64 max rel "
        f"{out['plain_f32_vs_f64_max_rel']:.3g}, "
        f"{out['plain_f32_beyond_2e-3_of_f64']} candidates beyond 2e-3")
  for c in out["contraction_only"]:
    print(f"[{tag}] candidate {c['candidate']} beyond the bound by "
          f"contraction alone: kernel {c['kernel']:.7g} "
          f"({c['kernel_over_bound']:.3g} of the bound), uncontracted "
          f"{c['uncontracted']:.7g} ({c['uncontracted_over_bound']:.3g}), "
          f"plain float32 {c['plain32']:.7g}, float64 {c['plain64']:.10g}")
  print(f"[{tag}] plain {name} step at B=1: {out['step_ops']} operations; "
        f"bound at {shape} {out['bound_ms']:.4f} ms ({out['bound_by']}); "
        f"kernel at {100 * out['bound_ms'] / ms:.4f} % of it")
  return out


def run_quadruped(dev, rec: dict, reps: int) -> dict:
  """Phases 3q, 4q, 4q-modes and 5q: Quadruped Flat, with the goal mocap
  body and the gait FSM's userdata as rollout-constant operands. Returns
  its row of the kernels line."""
  import torch
  from mujoco_mpc_torch.agent.agent import Agent
  from mujoco_mpc_torch.ops import megarollout as MR
  from mujoco_mpc_torch.tasks import quadruped
  from mujoco_mpc_torch.tasks import registry

  name = "Quadruped Flat"
  task = registry.get_task(name, device=dev)
  nud = task.model.nuserdata
  goal = [[1.0, 0.3, 0.3]]

  def operands(dtype, userdata=None):
    return dict(
        mocap_pos=torch.tensor(goal, dtype=dtype, device=dev),
        mocap_quat=torch.tensor([[1.0, 0.0, 0.0, 0.0]], dtype=dtype,
                                device=dev),
        userdata=torch.tensor(quadruped.fsm_userdata(nud) if userdata is None
                              else userdata, dtype=dtype, device=dev))

  # ---- 3q. one step on states in which every row class carries force
  mrq = MR.MegaRollout(task, 1, device=dev)
  rec["quadruped_step"] = probe_step(
      "3q", mrq, quadruped.probe_states(task.model, 128), operands)

  # ---- 4q. the main path: Agent("Quadruped Flat") at its defaults, the
  #      goal and a trot set through set_state
  agent = Agent(name, device=dev)
  agent.reset("home")
  agent.set_state(mocap_pos=goal, userdata=quadruped.fsm_userdata(nud))
  cfg = agent.planner.config
  drive, acts = drive_agent("4q", agent, 12)
  rel4, abs4 = drive["returns_rel_err"], drive["returns_abs_err"]
  pl, atask, d = agent.planner, agent.task, agent.data

  # ---- 4q-modes. every branch of residual_quadruped and
  #      weight_mod_quadruped on the same candidates: the mode in userdata
  #      (a Flip entered 0.4 s before: the jump, then the flight) and the
  #      Biped type parameter
  modes = {"quadruped": (quadruped.MODE_QUADRUPED, 0),
           "biped": (quadruped.MODE_BIPED, 0),
           "handstand": (quadruped.MODE_BIPED, 1),
           "walk": (quadruped.MODE_WALK, 0),
           "scramble": (quadruped.MODE_SCRAMBLE, 0),
           "flip": (quadruped.MODE_FLIP, 0)}
  variants = {}
  for case, (mode, biped_type) in modes.items():
    ud = quadruped.fsm_userdata(
        nud, mode, time=float(d.time) - 0.4 if mode == quadruped.MODE_FLIP
        else float(d.time))
    variants[case] = (atask.set_parameter("select_Biped type",
                                          biped_type).params, ud)
  ops = operands(torch.float32)
  # the plain version scores every branch from one physics rollout
  wants = run_plain(
      pl.mega.returns_plain_variants, d.qpos, d.qvel, acts,
      [(p, torch.tensor(u, device=dev)) for p, u in variants.values()],
      d.time, mocap_pos=ops["mocap_pos"], mocap_quat=ops["mocap_quat"])
  mode_err = {}
  for (case, (params, ud)), want in zip(variants.items(), wants):
    got = pl.mega.returns(d.qpos, d.qvel, acts, params, d.time,
                          **operands(torch.float32, ud))
    torch.cuda.synchronize()
    mode_err[case] = agreement(got, want, f"Quadruped {case} returns")
  print(f"[4q-modes] per candidate at {tuple(acts.shape)}, (max rel, max "
        f"abs) err per branch (tol rel 2e-3): "
        f"{({k: (float(f'{r:.3g}'), float(f'{a:.3g}')) for k, (r, a) in mode_err.items()})}")
  rec.update(quadruped_agent=drive, quadruped_mode_errs=mode_err)

  # ---- 5q. the bench shape: 1024 candidates x 70 steps at the XML dt
  b5 = bench_shape("5q", task, 1024, 70, cfg, operands, reps)
  rec["quadruped_bench_1024x70"] = b5
  return {
      "name": "megarollout_returns[quadruped]", "route": "cuda",
      "source": "mujoco_mpc_torch/csrc/megarollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/megarollout.py:339",
      "launches": drive["launches"], "max_abs_err": max(abs4,
                                                         b5["abs_err"]),
      "ms": b5["kernel_ms"], "plain_ms": b5["plain_ms"],
      "bound_ms": b5["bound_ms"], "bound_by": b5["bound_by"],
      "library_ms": None,
      "err_over_tol": max([rel4, b5["f64"]["max_rel"]]
                          + [r for r, _ in mode_err.values()]) / 2e-3}


# Shadow's goal orientation: a quarter turn about the vertical
SHADOW_GOAL = [[0.70710678, 0.0, 0.0, 0.70710678]]


def run_shadow(dev, rec: dict, reps: int) -> dict:
  """Phases 3s, 4s and 5s: Shadow, the goal quaternion a rollout-constant
  operand. Returns its row of the kernels line."""
  import torch
  from mujoco_mpc_torch.agent.agent import Agent
  from mujoco_mpc_torch.ops import megarollout as MR
  from mujoco_mpc_torch.tasks import hand_reorient
  from mujoco_mpc_torch.tasks import registry

  task = registry.get_task("Shadow", device=dev)

  def operands(dtype):
    return dict(mocap_quat=torch.tensor(SHADOW_GOAL, dtype=dtype,
                                        device=dev))

  # ---- 3s. one step on states in which every row class (capsule-box,
  #      sphere-box, torsional, joint limit) carries force
  mrs = MR.MegaRollout(task, 1, device=dev)
  rec["shadow_step"] = probe_step(
      "3s", mrs, hand_reorient.probe_states(task.model, 128), operands)

  # ---- 4s. the main path: Agent("Shadow") at its defaults, the goal set
  #      through set_state
  agent = Agent("Shadow", device=dev)
  agent.reset("home")
  agent.set_state(mocap_quat=SHADOW_GOAL)
  cfg = agent.planner.config
  drive, _ = drive_agent("4s", agent, 20)
  rec["shadow_agent"] = drive

  # ---- 5s. the bench shape: 512 candidates x 100 steps at the XML dt
  b5 = bench_shape("5s", task, 512, 100, cfg, operands, reps)
  rec["shadow_bench_512x100"] = b5
  return {
      "name": "megarollout_returns[shadow]", "route": "cuda",
      "source": "mujoco_mpc_torch/csrc/megarollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/megarollout.py:339",
      "launches": drive["launches"],
      "max_abs_err": max(drive["returns_abs_err"], b5["abs_err"]),
      "ms": b5["kernel_ms"], "plain_ms": b5["plain_ms"],
      "bound_ms": b5["bound_ms"], "bound_by": b5["bound_by"],
      "library_ms": None,
      "err_over_tol": max(drive["returns_rel_err"],
                          b5["f64"]["max_rel"]) / 2e-3}


# the handover's target: across the table from the box, as its transition
# places it
HANDOVER_TARGET = [[0.35, -0.25, 0.3]]


def run_handover(dev, rec: dict, reps: int) -> dict:
  """Phases 3b, 3e, 4b and 5b: Bimanual Handover, the target a
  rollout-constant operand, and the small class models. Returns its row of
  the kernels line."""
  import torch
  from mujoco_mpc_torch.agent.agent import Agent
  from mujoco_mpc_torch.ops import megarollout as MR
  from mujoco_mpc_torch.tasks import bimanual
  from mujoco_mpc_torch.tasks import class_models
  from mujoco_mpc_torch.tasks import registry

  task = registry.get_task("Bimanual Handover", device=dev)

  def operands(dtype):
    return dict(mocap_pos=torch.tensor(HANDOVER_TARGET, dtype=dtype,
                                       device=dev))

  # ---- 3b. one step on states in which every row class (plane-box
  #      corner, capsule-box, torsional, rolling, joint limit, joint
  #      equality) carries force, the equality rows both ways
  mrb = MR.MegaRollout(task, 1, device=dev)
  step = rec["handover_step"] = probe_step(
      "3b", mrb, bimanual.probe_states(task.model, 128), operands)
  lo, hi = step["dual_range_per_class"]["eq_joint"]
  print(f"[3b] joint-equality duals from {lo:.4g} to {hi:.4g}")
  check(lo < 0.0 < hi, "3b: the equality rows do not pull both ways")

  # ---- 3e. the small class models from their snapshots: each equality
  #      kind and the condim-6 rolling rows, one step each
  rec["class_steps"] = {}
  for name in ("joint_equality", "connect", "weld", "condim6_ball"):
    ctask = class_models.task(name, device=dev)
    rec["class_steps"][name] = probe_step(
        f"3e {name}", MR.MegaRollout(ctask, 1, device=dev),
        class_models.states(name, ctask.model, 128), lambda dt: {})

  # ---- 4b. the main path: Agent("Bimanual Handover") at its defaults,
  #      the target set through set_state; at dt 0.01, the contacts'
  #      solref time constant, the float32 returns are held within their
  #      own float32 noise
  agent = Agent("Bimanual Handover", device=dev)
  agent.reset("home")
  agent.set_state(mocap_pos=HANDOVER_TARGET)
  cfg = agent.planner.config
  drive, _ = drive_agent("4b", agent, 16, noisy=True)
  rec["handover_agent"] = drive

  # ---- 5b. the bench shape: 256 candidates x 80 steps at the XML dt
  b5 = bench_shape("5b", task, 256, 80, cfg, operands, reps)
  rec["handover_bench_256x80"] = b5
  return {
      "name": "megarollout_returns[handover]", "route": "cuda",
      "source": "mujoco_mpc_torch/csrc/megarollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/megarollout.py:339",
      "launches": drive["launches"],
      "max_abs_err": max(drive["returns_abs_err"], b5["abs_err"]),
      "ms": b5["kernel_ms"], "plain_ms": b5["plain_ms"],
      "bound_ms": b5["bound_ms"], "bound_by": b5["bound_by"],
      "library_ms": None,
      "err_over_tol": max(drive["noise"]["gap_over_bound"],
                          b5["f64"]["max_rel"] / 2e-3)}


def run_allegro(dev, rec: dict, reps: int) -> dict:
  """Phases 3a, 4a and 5a: Allegro through the large size tier (box-box
  corners, 144 rows), the goal quaternion a rollout-constant operand.
  Returns its row of the kernels line."""
  import torch
  from mujoco_mpc_torch.agent.agent import Agent
  from mujoco_mpc_torch.ops import megarollout as MR
  from mujoco_mpc_torch.tasks import allegro
  from mujoco_mpc_torch.tasks import registry

  task = registry.get_task("Allegro", device=dev)

  def operands(dtype):
    return dict(mocap_quat=torch.tensor(SHADOW_GOAL, dtype=dtype,
                                        device=dev))

  # ---- 3a. one step on states in which every row class (the box-box
  #      corners of the cube and of the palm, capsule-box, plane-box
  #      corner, joint limit) carries force
  mra = MR.MegaRollout(task, 1, device=dev)
  check(mra.tier.name == "large", f"Allegro in the {mra.tier.name} tier")
  rec["allegro_step"] = probe_step(
      "3a", mra, allegro.probe_states(task.model, 128), operands)

  # ---- 4a. the main path: Agent("Allegro") at its defaults (256 x 40 at
  #      agent_timestep 0.01), the goal set through set_state
  agent = Agent("Allegro", device=dev)
  agent.reset("home")
  agent.set_state(mocap_quat=SHADOW_GOAL)
  cfg = agent.planner.config
  check(agent.planner.mega.tier.name == "large",
        "Agent('Allegro') plans outside the large tier")
  drive, _ = drive_agent("4a", agent, 12, noisy=True)
  rec["allegro_agent"] = drive

  # ---- 5a. the bench shape: 512 candidates x 80 steps at the XML dt
  b5 = bench_shape("5a", task, 512, 80, cfg, operands, reps)
  rec["allegro_bench_512x80"] = b5
  return {
      "name": "megarollout_returns[allegro]", "route": "cuda",
      "source": "mujoco_mpc_torch/csrc/megarollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/megarollout.py:339",
      "launches": drive["launches"],
      "max_abs_err": max(drive["returns_abs_err"], b5["abs_err"]),
      "ms": b5["kernel_ms"], "plain_ms": b5["plain_ms"],
      "bound_ms": b5["bound_ms"], "bound_by": b5["bound_by"],
      "library_ms": None,
      "err_over_tol": max(drive["noise"]["gap_over_bound"],
                          b5["gap_over_bound"], b5["f64"]["max_rel"] / 2e-3)}


def run_cem(dev, rec: dict) -> dict:
  """Phase 4c: Agent(planner="cross_entropy") on the Walker and on Shadow:
  5 plan steps each with one launch per plan, then one plan's returns
  against the plain version per candidate (drive_agent); and one more
  plan, replayed from the same generator state, whose new policy (elite
  mean and std) must equal the elite update computed on the CPU from its
  kernel returns. Returns the Shadow CEM agent's row of the kernels line,
  timed at its shape."""
  from mujoco_mpc_torch.agent.agent import Agent
  from mujoco_mpc_torch.planners import cross_entropy
  from mujoco_mpc_torch.tasks import registry

  for name, nu, goal in (("Walker", 6, None), ("Shadow", 20, SHADOW_GOAL)):
    agent = Agent(name, planner="cross_entropy", device=dev)
    agent.reset("home")
    if goal is not None:
      agent.set_state(mocap_quat=goal)
    drive, acts = drive_agent("4c", agent, nu, monotone=False)
    pl, cfg = agent.planner, agent.planner.config
    policy, state = agent.policy, agent.generator.get_state()
    info = agent.planner_step()
    agent.generator.set_state(state)
    _, _, cands = pl._gen_candidates(agent.task, policy, agent.data,
                                     agent.generator)
    _, mean, std = cross_entropy.elite_update(
        cands.cpu(), info.costs.cpu(), cfg.n_elite, cfg.std_min)
    pol_err = max(float((agent.policy.values.cpu() - mean).abs().max()),
                  float((agent.policy.std.cpu() - std).abs().max()))
    print(f"[4c] {name} CEM: the new policy against the CPU elite update "
          f"from the same kernel returns {pol_err:.3g} (tol 1e-6)")
    check(pol_err <= 1e-6, f"{name} CEM: the new policy differs from the "
          f"CPU elite update by {pol_err:.3g}")
    rec[f"cem_{name.lower()}"] = dict(drive, policy_err=pol_err)
  ops = step_ops(registry.get_task(name, device="cpu"))
  bound_ms, bound_by = bound(ops, acts.shape[0], acts.shape[1], agent.task)
  return {
      "name": "megarollout_returns[cem shadow]", "route": "cuda",
      "source": "mujoco_mpc_torch/csrc/megarollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/megarollout.py:339",
      "launches": drive["launches"], "max_abs_err": drive["returns_abs_err"],
      "ms": drive["kernel_ms"], "plain_ms": drive["plain_ms"],
      "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
      "err_over_tol": drive["returns_rel_err"] / 2e-3}


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
  t_start = time.perf_counter()
  from mujoco_mpc_torch.agent.agent import Agent
  from mujoco_mpc_torch.ops import _cuda_build
  from mujoco_mpc_torch.ops import megarollout as MR
  from mujoco_mpc_torch.physics import io as phys_io
  from mujoco_mpc_torch.physics import tilestep
  from mujoco_mpc_torch.planners import sampling
  from mujoco_mpc_torch.tasks import humanoid
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

  # ---- 2. build the kernel from the sources: a library per size tier and
  #      precision, the nvcc processes at once, each checked against its
  #      ctypes mirror
  t = time.perf_counter()
  libs = _cuda_build.build_all(
      [(i, double, True) for i in range(len(MR.TIERS))
       for double in (False, True)]
      + [(i, False, False) for i in range(len(MR.TIERS))])
  for tier in MR.TIERS:
    for dt in (torch.float32, torch.float64):
      MR._library(tier, dt)
  rec["build_s"] = time.perf_counter() - t
  print(f"[2] built {len(libs)} libraries ({2 * len(libs)} kernel instances;"
        f" {len(MR.TIERS)} of them uncontracted witnesses) in "
        f"{rec['build_s']:.2f} s")
  rec["ptxas"] = {}
  for so in libs:
    ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "stack frame" in ln
             or "Function properties" in ln]
    rec["ptxas"][so.name] = ptxas
    print(f"    {so.name}:")
    for ln in ptxas:
      print(f"      {ln}")

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
  pq, pv, view = run_plain(tilestep.step_tb, mr1.tm, qp, qv, ct)
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
  want = run_plain(mr.returns_plain, home, v0, acts, task.params, t0)
  torch.cuda.synchronize()
  rel, max_abs = agreement(got, want, f"returns {n}x{horizon}")
  print(f"[3] returns {n}x{horizon}: max rel err {rel:.3g} (tol 2e-3), "
        f"max abs err {max_abs:.3g}; diverging candidate: kernel "
        f"{float(got[7]):g}, plain {float(want[7]):g}")
  check(float(got[7]) == float(want[7]) == MR.MAX_RETURN,
        "divergence guard")
  ms_small = timed_cuda(
      lambda: mr.returns(home, v0, acts, task.params, t0), 3)
  t = time.perf_counter()
  run_plain(mr.returns_plain, home, v0, acts, task.params, t0)
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
  drive, _ = drive_agent("4", agent, 6)
  rec["walker_agent"] = drive

  # ---- 5. the bench shape: 1024 candidates x 80 steps at the XML dt
  cfg = sampling.SamplingConfig(num_trajectories=1024, horizon=80,
                                spline_points=cfg.spline_points,
                                interp=cfg.interp)
  planner = sampling.SamplingPlanner(cfg)
  policy = planner.init(task)
  data = phys_io.make_data(task.model).replace(qpos=home.clone())
  gen = torch.Generator(device=dev).manual_seed(0)
  policy, info = planner.optimize(task, policy, data, gen)  # warm-up
  torch.cuda.synchronize()
  reps = 5
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
  plain = run_plain(planner.mega.returns_plain, home, v0, acts, task.params,
                    t0)
  torch.cuda.synchronize()
  plain_big = (time.perf_counter() - t) * 1e3
  rel5, abs5 = agreement(got, plain, "returns 1024x80")
  ms_big = timed_cuda(
      lambda: planner.mega.returns(home, v0, acts, task.params, t0), 3)
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

  ops_w = step_ops(registry.get_task("Walker", device="cpu"))
  bound_w, by_w = bound(ops_w, 1024, 80, task)
  print(f"[5] plain Walker step at B=1: {ops_w} operations; bound at "
        f"1024x80 {bound_w:.4f} ms ({by_w}); kernel at "
        f"{100 * bound_w / ms_big:.4f} % of it")
  rec.update(walker_step_ops=ops_w, walker_bound_ms=bound_w)
  walker_row = {
      "name": "megarollout_returns[walker]", "route": "cuda",
      "source": "mujoco_mpc_torch/csrc/megarollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/megarollout.py:339",
      "launches": drive["launches"], "max_abs_err": abs5,
      "ms": ms_big, "plain_ms": plain_big, "bound_ms": bound_w,
      "bound_by": by_w, "library_ms": None,
      "err_over_tol": max(rel, drive["returns_rel_err"], rel5) / 2e-3}

  # ---- 3h. Humanoid: one step against the plain version, on states in
  #      which every constraint row class carries force (a state whose own
  #      float32 step is far from float64, a stiff leg-leg crossing, may
  #      have qvel up to 8 times that distance)
  htask = registry.get_task("Humanoid Walk", device=dev)
  mrh = MR.MegaRollout(htask, 1, device=dev)
  rec["humanoid_step"] = probe_step(
      "3h", mrh, humanoid.probe_states(htask.model, 128), lambda dt: {})

  # ---- 4h. the main path: Agent("Humanoid Walk") at its defaults
  hagent = Agent("Humanoid Walk", device=dev)
  hagent.reset("home")
  hdrive, _ = drive_agent("4h", hagent, 21)
  rec["humanoid_agent"] = hdrive

  # ---- 5h. the north star: 256 candidates x 67 steps at the planning dt;
  #      chaotic in float32, so the float kernel is held as a population
  b5h = bench_shape("5h", hagent.task, 256, 67, hagent.planner.config,
                    lambda dt: {}, reps, chaotic=True)
  rec["humanoid_bench_256x67"] = b5h
  humanoid_row = {
      "name": "megarollout_returns[humanoid]", "route": "cuda",
      "source": "mujoco_mpc_torch/csrc/megarollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/megarollout.py:339",
      "launches": hdrive["launches"], "max_abs_err": hdrive["returns_abs_err"],
      "ms": b5h["kernel_ms"], "plain_ms": b5h["plain_ms"],
      "bound_ms": b5h["bound_ms"], "bound_by": b5h["bound_by"],
      "library_ms": None,
      "err_over_tol": max(hdrive["returns_rel_err"],
                          b5h["f64"]["max_rel"]) / 2e-3}

  quadruped_row = run_quadruped(dev, rec, reps)
  shadow_row = run_shadow(dev, rec, reps)
  handover_row = run_handover(dev, rec, reps)
  allegro_row = run_allegro(dev, rec, reps)
  cem_row = run_cem(dev, rec)
  kernels = {"kernels": [walker_row, humanoid_row, quadruped_row, shadow_row,
                         handover_row, allegro_row, cem_row]}
  rec["total_s"] = time.perf_counter() - t_start
  print(f"[end] every phase passed in {rec['total_s']:.1f} s, the build "
        f"included")
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
