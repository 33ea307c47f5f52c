"""Smoke run of mujoco_mpc_torch on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py [--out FILE.json]

Builds the CUDA kernel from mujoco_mpc_torch/csrc/ (one library per size
tier and precision, an uncontracted float library per tier, and each
tier's float library with its phase counters, the nvcc processes at once;
it prints each instance's ptxas registers and stack frame, and fails at a
card instance's frame of 8 KB or more) and, for each path it
serves (Walker, Humanoid Walk, Quadruped Flat, Shadow, Bimanual Handover
and Allegro, the cross-entropy planner on Walker and Shadow, and the small
tasks Cartpole, Acrobot, Particle, ParticleFixed, Fingers, Arm Reach, Push
and Rubik Faces, and the flat-ground tasks OP3, Pick, PickAndPlace,
Bimanual Reorient and Humanoid Interact in the large tier), holds it
against its plain PyTorch version, drives the agent's plan loop through
it, and times the planner: Walker at 1024
candidates x 80 steps, Humanoid at the north-star 256 x 67 at the planning
dt 0.015, Quadruped at 1024 x 70, Shadow at 512 x 100, the handover at
256 x 80 and Allegro at 512 x 80, the last four at dt 0.005, each small
task at 1024 candidates over its Agent's horizon at the model's dt, and
each flat-ground kernel task at 512 over its Agent's horizon and dt
(phases 3f, 4f and 5f, with the bytes of a block's shared memory; Pick,
whose perturbed candidates diverge past about 26 steps, held and timed
again over its first 20). The
small class models (every equality kind, condim 6, the ball chain with a
ball joint and the sphere-capsule pair) and Rubik Faces, which has no
constraint rows, are held one step each. Each phase's returns are held
as its Hold says: Humanoid rollouts that long, and Acrobot's at its
folded elbow, are chaotic in float32, so there the kernel's float64
instance is held against the plain version in float64 candidate by
candidate, and the float32 kernel as a population; elsewhere the float32
kernel is held per candidate, at rtol 2e-3 or within its own float32
noise; a candidate beyond that noise passes only where a witness shows
the miss is rounding: the same source built without multiply-add
contraction lands within it, or the plain version itself, perturbed by
one float32 rounding, lands beyond it on the kernel's side. The plain
version's rollouts run in worker processes on the host's
CPU cores, beside the card's work (the checks wait for them at the end);
the one-step checks run it on the card.
Exits non-zero, printing no result, without a CUDA
device or on any failed check. Phase P measures where the time goes: the
Walker, Humanoid and Allegro benches' returns once through the profiling
build (where a step's cycles go), the device's busy share over 5
planner_steps of the Walker and Rubik Faces Agents (torch.profiler), and
Nsight Compute's occupancy and stall reasons where ncu runs. Phases G1-G3
hold the general engine (physics/step.py, plain PyTorch) and the closed
loop: G1 one general step of five models' probe states on the card
against the CPU in float64 and against the kernel's step, and one step
under torch.cuda.set_sync_debug_mode("error"); G2 the general batched
rollout's returns against the kernel's at the Walker and Humanoid agent
shapes; G3 the Walker, Quadruped Flat and Cartpole agents from their home
keyframes, a planner_step every 2 steps, each loop counting its kernel
launches (reported per kernel row as closed_loop_launches), with ms per
Agent.step and per plan, CUDA launches per step and the device's busy
share (torch.profiler, after every timing); G4 the nine flat-ground
tasks' loops (the five kernel tasks 50 steps, the four on the general
route, Quadrotor, Swimmer, Rubik and Humanoid Track, 6), the transition
on the card at every step, and those four tasks' first float64 plans on
the card against the CPU's. Phases D1-D3 hold the
planners (planners/*.py): D1 iLQG's transition Jacobians of the Walker
and Humanoid Walk at 8 states from home, on the card against the CPU in
float64 and against central differences of the card's step, and the ms
and launches of one Jacobian call over the Agent's horizon; D2 each of
the seven planners through Agent("Walker", planner=p): its first float64
plan on the card against the CPU's (the CPU's in a worker, the same
injected noise; the kernel-scored ones also through the double library
built without multiply-add contraction), its kernel launches a plan
(reported on the Walker kernel row as planner_launches), 5 timed float32
plans (1 of gradient, iLQG, iLQS and robust), sample-gradient's two
launches timed apart, the host syncs of one iLQG and one gradient
optimize and their peak memory; D3 the iLQG
(Walker 80, Humanoid Walk 33) and gradient (Walker 80) iterations split
by phase with CUDA events and the device's busy share, and the Cartpole
quick start with its own (gradient) planner for about 20 s (at least 4
steps), its first 4 float64 steps held against the CPU's. Phase E holds
the estimators (estimators/*.py): E1 the ground-truth, Kalman, Unscented
and Batch estimators and the direct optimizer on Cartpole's simulation
model, and the measurement updates of Kalman, Unscented and Direct
identifying a damping on the pendulum with sensors
(estimators/sensor_model.py), E2 Kalman, Unscented, Batch and Direct
(window 64, 3 iterations) on Humanoid Walk's, each float64 update on the
card against the CPU's (its CPU half in the plain version's workers from
the build on, its card half with the other float64 holds; the pendulum's
under set_sync_debug_mode("error")), then, but for the pendulum, the ms
and host syncs of float32 updates and the CUDA kernels and busy share of
one; E3 Agent("Cartpole", planner="sampling") planning from its Kalman
estimate every 2 steps (one kernel launch a plan, reported on the
Cartpole kernel row as from_estimate_launches; the estimate within 1e-4
of the sim state), then the estimation and plan threads beside step().
Phase M holds the mesh and heightfield pairs (physics/collision.py) on
Bimanual Insert and Quadruped Hill, both on the general route: one
float64 general step of 16 probe states each (every new pair kind
carrying force) and each task's first float64 plan on the card against
the CPU, a float32 step over the heightfield's far corner, then float32
ms and launches per step and each Agent's closed loop (6 steps, a plan
every 2). Phase S serves the Walker Agent on the card through the gRPC
agent service in this process (service/), the port's AgentClient on
localhost: GetAction against the Agent's own, one kernel launch per
PlannerStep, the RPC's time beside a direct planner_step, the server's
own plan loop; then the estimation and direct services on Cartpole, each
response against the direct call's. Phase N (after SH) drives the names
taken over from the JAX package last: rubik.make() and make_faces(), a
Rubik Faces plan and a Quadruped Flat plan after Task.set_mode (one
launch each, returns against the plain version; the latter bitwise the
plan after Agent.set_mode), Model.sensor_adr, and ops/linalg.py's floored
Cholesky factor and solve on the card against the CPU, with G1's launches
per step beside PERF.md's. Phase X drives the edges on the
card: X1 the embedding interface (create_policy("Walker") on the default
device, its plan loop in a thread beside 30 general steps from home, each
publishing its state through step_policy and applying the action: ms a
call, plans, kernel launches equal to the plans, the policy's age; with
the loop stopped step_policy against Agent.action bitwise; destroy_policy
joins the thread), X2 the C ABI (native/: built with g++ beside X1, its
smoke on Walker on the card: nu 6, two same-state calls 300 ms apart
with no call between differ, so the plan thread ran between them; the
smoke asks such a pair up to 5 times), X3 a checkpoint round trip
(the next plan bitwise; the file loaded on the CPU), X4 the phase timer
over 5 plans and a device trace whose phase ranges hold the kernel, X5
the CLI as a subprocess (beside X2's smoke) and its plans' launches in
this process, X6 tools/drive.py on Walker for 100 steps, X7 the dashboard
(ui/server.py) with its threads on the card for 5 s: its state, a weight,
a switch to cross_entropy keeping the state, launches a plan, /frame.jpg's
404 (no mujoco on the card's host).
The elapsed seconds at each phase go to --out's "t". The
last line of standard output is {"ok": true, "device": {...}}; the line
before it lists the kernel once per path with its launch count, error,
time, plain time, bound and launch geometry (warps per block, blocks
resident per SM, SMs in use).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import multiprocessing
import os
import re
import shutil
import signal
import subprocess
import sys
import time
import traceback


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


@contextlib.contextmanager
def no_sync(what: str):
  """torch.cuda.set_sync_debug_mode("error") over the block: a host sync
  in it fails the run."""
  import torch
  torch.cuda.set_sync_debug_mode("error")
  try:
    yield
  except RuntimeError as e:
    fail(f"{what}: synchronizes with the host: {e}\n"
         f"{traceback.format_exc()}")
  finally:
    torch.cuda.set_sync_debug_mode(0)


# the script's elapsed seconds at each "[t]" line (--out's "t")
T_START = time.perf_counter()
TIMELINE = []


def timeline(what: str) -> float:
  """Keep and print the script's elapsed seconds at `what`."""
  t = time.perf_counter() - T_START
  TIMELINE.append([t, what])
  print(f"[t] {t:.1f} s: {what}", flush=True)
  return t


# The plain version's returns run in worker processes while the main
# process goes on with the card: each comparison's checks run when its
# plain returns are in (DEFERRED, resolved before the kernels line). The
# float64 runs go to PLAIN, on the host's CPU cores (split over the
# candidates), from the start: they never touch the card, so no kernel
# timing shares it with them. The float32 runs must round as the card
# does, so they wait (CARD_QUEUE) until the card's work is done, then run
# on it in CARD_WORKERS processes at once. A worker builds each (task,
# planning timestep, horizon, device) MegaRollout once.
PLAIN = None
PLAIN_WORKERS = 7
CARD_WORKERS = 4
CARD_QUEUE = []
DEFERRED = []
_WORKER_ROLLOUTS = {}


def _worker_init(card: bool):
  import os
  if not card:
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
  import torch
  torch.set_num_threads(1)


def _worker_warm():
  """A worker's imports, made while the main process builds the kernel."""
  from mujoco_mpc_torch.tasks import registry  # noqa: F401
  return True


def _plain_job(spec, arrays, variants, dtype_name, device, trig64=False):
  """MegaRollout.returns_plain_variants in a worker: spec (task name, the
  model's timestep, horizon); arrays the numpy inputs; variants (weights,
  norm_params, risk, residual_params, userdata or None) numpy tuples; on
  `device`; with `trig64`, sin and cos rounded from float64
  (trig_from_float64). Returns (the returns per variant, numpy; ms)."""
  import torch
  from mujoco_mpc_torch.ops import megarollout as MR
  from mujoco_mpc_torch.tasks import base, registry
  if (spec, device) not in _WORKER_ROLLOUTS:
    name, timestep, horizon = spec
    task = registry.get_task(name, device=device)
    m = task.model
    task = task.replace(model=m.replace(opt=m.opt.replace(
        timestep=torch.tensor(timestep, dtype=m.dtype, device=device))))
    _WORKER_ROLLOUTS[spec, device] = MR.MegaRollout(task, horizon,
                                                    device=device)
  mr = _WORKER_ROLLOUTS[spec, device]
  dt = getattr(torch, dtype_name)

  def t(a):
    return None if a is None else torch.tensor(a, dtype=dt, device=device)

  x = {k: t(v) for k, v in arrays.items()}
  vs = [(base.TaskParams(*(t(a) for a in v[:4])), t(v[4]))
        for v in variants]
  start = time.perf_counter()
  trig = trig_from_float64() if trig64 else contextlib.nullcontext()
  with torch.inference_mode(), trig:
    out = mr.returns_plain_variants(x["qpos0"], x["qvel0"], x["actions"],
                                    vs, x["t0"], dt, x.get("mocap_pos"),
                                    x.get("mocap_quat"))
    out = [o.cpu().numpy() for o in out]
  return out, (time.perf_counter() - start) * 1e3


class PlainReturns:
  """The plain version's returns of one action set from the workers:
  `get()` waits and gives (the returns on the card, one tensor per
  variant; the milliseconds of plain work, summed over the chunks: a
  float32 run's time on the card beside CARD_WORKERS - 1 others, a
  float64 run's on the host's CPU cores)."""

  def __init__(self, jobs, dev):
    self.jobs, self.dev = jobs, dev  # futures, or CARD_QUEUE entries

  def get(self):
    import numpy as np
    import torch
    parts = [(j["future"] if isinstance(j, dict) else j).result()
             for j in self.jobs]
    outs = [torch.tensor(np.concatenate([p[0][k] for p in parts]),
                         device=self.dev) for k in range(len(parts[0][0]))]
    return outs, sum(p[1] for p in parts)


def plain_submit(task, horizon, args, ops, dtype, variants=None,
                 witness=None, now=False):
  """MegaRollout(task, horizon).returns_plain(*args, dtype, **ops) (or,
  with `variants`, (TaskParams, userdata) pairs, returns_plain_variants)
  as worker jobs: float64 to PLAIN now, in chunks of candidates; float32
  to CARD_QUEUE; or, given `witness` ("trig64" or "nudge":
  rounding_witnesses) or `now` (once CARD_QUEUE has run), float32 to
  PLAIN now, on the host's cores. A PlainReturns."""
  import numpy as np
  import torch

  def npy(a):
    return None if a is None else a.detach().cpu().double().numpy()

  qpos0, qvel0, actions, params, t0 = args
  if variants is None:
    variants = [(params, ops.get("userdata"))]
  vs = [(npy(p.weights), npy(p.norm_params), npy(p.risk),
         npy(p.residual_params), npy(u)) for p, u in variants]
  common = {"qpos0": npy(qpos0), "qvel0": npy(qvel0),
            "t0": np.asarray(float(t0)),
            "mocap_pos": npy(ops.get("mocap_pos")),
            "mocap_quat": npy(ops.get("mocap_quat"))}
  spec = (task.name, float(task.model.opt.timestep), horizon)
  acts = npy(actions)
  if dtype == torch.float32 and witness is None and not now:
    entry = {"job": (spec, {**common, "actions": acts}, vs, "float32",
                     "cuda")}
    CARD_QUEUE.append(entry)
    return PlainReturns([entry], actions.device)
  # chunks of at least 128 candidates: below that a chunk's time is the
  # per-op dispatch of every step, the same for any count
  chunks = np.array_split(np.arange(acts.shape[0]), max(1, min(
      PLAIN_WORKERS, acts.shape[0] // 128)))
  futures = [PLAIN.submit(_plain_job, spec, {**common, "actions": acts[c]},
                          vs, str(dtype).split(".")[1], "cpu",
                          witness == "trig64")
             for c in chunks if len(c)]
  return PlainReturns(futures, actions.device)


def run_card_queue():
  """The queued float32 runs, CARD_WORKERS at once on the card (none of
  the card's work is timed any more); the pool, for main to stop."""
  pool = concurrent.futures.ProcessPoolExecutor(
      max_workers=CARD_WORKERS, initializer=_worker_init, initargs=(True,),
      mp_context=multiprocessing.get_context("spawn"))
  for entry in CARD_QUEUE:
    entry["future"] = pool.submit(_plain_job, *entry["job"])
  return pool


def resolve_deferred():
  """Every deferred comparison, in the order the phases made them."""
  while DEFERRED:
    DEFERRED.pop(0)()


def ratio(num, den):
  """num / den elementwise, 0 where both are 0 (a return of exactly 0 in
  both versions) and inf where only den is."""
  import torch
  zero = den == 0
  safe = torch.where(zero, torch.ones_like(den), den)
  return torch.where(zero, torch.where(num == 0, 0.0, float("inf")).to(
      num.dtype), num / safe)


def agreement(got, want, what: str):
  """(max relative, max absolute) |kernel - plain| of returns; fails on a
  non-finite kernel return or beyond rtol 2e-3."""
  import torch
  check(bool(torch.all(torch.isfinite(got))),
        f"{what}: non-finite kernel returns")
  diff = (got - want).abs()
  rel = float(ratio(diff, want.abs()).max())
  check(rel <= 2e-3, f"{what}: kernel disagrees with the plain version "
        f"(max rel err {rel:.3g} > 2e-3)")
  return rel, float(diff.max())


# How a phase holds the kernel's returns against the plain version's: in
# float32 per candidate at rtol 2e-3 (agreement), per candidate within the
# plain float32 version's own distance from float64 (NOISE_BOUND:
# noise_bound), or as a population (float_noise) where rounding decides
# the rollouts, so that no two float32 orderings agree per candidate; in
# float64 per candidate at rtol 2e-3 (agreement64) or not at all (None).
PER_CANDIDATE, NOISE_BOUND, POPULATION = ("per candidate", "noise bound",
                                          "population")


@dataclasses.dataclass(frozen=True)
class Hold:
  f32: str = PER_CANDIDATE
  f64: str | None = None


def hold_returns(what: str, hold: Hold, got, plain, got64=None, plain64=None,
                 witness=None, perturbed=None) -> dict:
  """The kernel's returns (got; got64 from its double instance) held
  against the plain version's (plain; plain64 in float64) as `hold` says;
  `witness` and `perturbed` are noise_bound's witnesses of rounding. Fails
  on any candidate or population beyond its hold. Returns the results per
  precision, the max rel and abs |kernel - plain| in float32 and
  `err_over_tol`, the largest error as a fraction of what its hold
  allows."""
  out = {"hold": dataclasses.asdict(hold)}
  diff = (got - plain).abs()
  out["rel_err"] = float(ratio(diff, plain.abs()).max())
  out["abs_err"] = float(diff.max())
  over = []
  if hold.f32 == PER_CANDIDATE:
    agreement(got, plain, what)
    over.append(out["rel_err"] / 2e-3)
  elif hold.f32 == NOISE_BOUND:
    nb = out["f32"] = noise_bound(got, plain, plain64, what, witness,
                                  perturbed)
    over.append(nb["held_over_bound"])
  else:
    pop = out["f32"] = float_noise(got, plain, plain64, what)
    over.append(population_ratio(pop))
  if hold.f64 == PER_CANDIDATE:
    r64 = out["f64"] = agreement64(got64, plain64, f"{what} in float64")
    over.append(r64["max_rel"] / 2e-3)
  out["err_over_tol"] = max(over)
  return out


def hold_summary(res: dict) -> str:
  """One line of a hold_returns result."""
  hold = res["hold"]
  line = (f"float32 {hold['f32']}: max rel err {res['rel_err']:.3g}, max "
          f"abs err {res['abs_err']:.3g}")
  f32 = res.get("f32", {})
  if hold["f32"] == NOISE_BOUND:
    line += (f", within 2e-3 |p32| + 4 |p32 - p64| at most "
             f"{f32['held_over_bound']:.3g} of it, "
             f"{len(f32['contraction_only'])} beyond it by contraction alone "
             f"and {len(f32['rounding_witnessed'])} with a perturbed plain "
             f"run beyond it on the kernel's side; plain float32 vs float64 "
             f"max rel {f32['plain_f32_vs_f64_max_rel']:.3g}")
  elif hold["f32"] == POPULATION:
    line += (f", beyond rel 2e-3 of float64: kernel {f32['kernel_beyond']},"
             f" plain float32 {f32['plain_beyond']} (median rel "
             f"{f32['kernel_median']:.3g} and {f32['plain_median']:.3g}); "
             f"winner kernel {f32['winner']}, plain {f32['plain_winner']}")
  else:
    line += " (tol 2e-3)"
  f64 = res.get("f64")
  if hold["f64"] == PER_CANDIDATE:
    line += (f"; float64 per candidate: max rel err {f64['max_rel']:.3g} "
             f"(tol 2e-3), max abs {f64['max_abs']:.3g}, {f64['blown']} at "
             f"or past MAX_RETURN in both")
  return line


def noise_bound(got, plain, plain64, what: str, witness=None,
                perturbed=None) -> dict:
  """The float32 kernel per candidate against the plain float32 version
  within 2e-3 |p32| + 4 |p32 - p64|: the plain version's own float32
  distance from float64 widens the bound where rounding is amplified. A
  candidate beyond it passes only where a witness shows the miss is
  rounding: the same kernel built without contraction (`witness`, its
  returns) lands within the bound, so the miss is the contraction's
  rounding alone (contraction_only); or the plain float32 version itself,
  under a perturbation the size of float32 rounding (`perturbed(idx)`,
  rounding_witnesses), lands beyond the bound on the kernel's side, so the
  plain version's own answer there is rounding's (rounding_witnessed).
  Fails on any other candidate beyond the bound."""
  import torch
  check(bool(torch.all(torch.isfinite(got))),
        f"{what}: non-finite kernel returns")
  gap = (got - plain).abs()
  dist = (plain - plain64.to(plain.dtype)).abs()
  allowed = 2e-3 * plain.abs() + 4.0 * dist
  beyond = gap > allowed
  over = ratio(gap, allowed)
  out = {"rel_err": float(ratio(gap, plain.abs()).max()),
         "abs_err": float(gap.max()),
         "gap_over_bound": float(over.max()),
         "plain_f32_vs_f64_max_abs": float(dist.max()),
         "plain_f32_vs_f64_max_rel": float(ratio(
             dist.double(), plain64.abs()).max()),
         "contraction_only": [], "rounding_witnessed": []}
  worst = int(torch.argmax(over))
  out["worst"] = {"candidate": worst, "kernel": float(got[worst]),
                  "plain32": float(plain[worst]),
                  "plain64": float(plain64[worst])}
  if witness is not None and bool(beyond.any()):
    ugap = (witness - plain).abs()
    explained = beyond & (ugap <= allowed)
    for i in torch.nonzero(explained).flatten().tolist():
      out["contraction_only"].append({
          "candidate": i, "kernel": float(got[i]),
          "uncontracted": float(witness[i]), "plain32": float(plain[i]),
          "plain64": float(plain64[i]),
          "kernel_over_bound": float(gap[i] / allowed[i]),
          "uncontracted_over_bound": float(ugap[i] / allowed[i])})
    beyond = beyond & ~explained
  if perturbed is not None and bool(beyond.any()):
    idx = torch.nonzero(beyond).flatten()
    runs = perturbed(idx)
    side = torch.sign(got[idx] - plain[idx])
    for j, i in enumerate(idx.tolist()):
      sides = [k for k, r in runs.items()
               if abs(float(r[j] - plain[i])) > float(allowed[i])
               and torch.sign(r[j] - plain[i]) == side[j]]
      if sides:
        beyond[i] = False
        out["rounding_witnessed"].append({
            "candidate": i, "kernel": float(got[i]),
            "plain32": float(plain[i]), "plain64": float(plain64[i]),
            "kernel_over_bound": float(gap[i] / allowed[i]),
            "perturbed": {k: float(r[j]) for k, r in runs.items()},
            "sides_with_the_kernel": sides})
  out["held_over_bound"] = float(torch.where(beyond | (gap <= allowed),
                                             over, 0.0).max())
  n_out = out["beyond_noise_bound"] = int(beyond.sum())
  check(n_out == 0, f"{what}: {n_out} candidates beyond |k - p32| <= "
        f"2e-3 |p32| + 4 |p32 - p64| with no witness of rounding (the "
        f"uncontracted kernel beyond it too, and no perturbed plain run "
        f"beyond it on the kernel's side); the worst, {out['worst']}, at "
        f"{out['gap_over_bound']:.4g} of it")
  return out


# float32's machine epsilon
EPS32 = 1.1920929e-07


@contextlib.contextmanager
def trig_from_float64():
  """torch.sin and torch.cos computed in float64 and rounded to the
  argument's dtype: another rounding of the plain version's joint
  quaternions."""
  import torch
  sin, cos = torch.sin, torch.cos
  torch.sin = lambda x: sin(x.double()).to(x.dtype)
  torch.cos = lambda x: cos(x.double()).to(x.dtype)
  try:
    yield
  finally:
    torch.sin, torch.cos = sin, cos


def rounding_witnesses(task, args, ops):
  """noise_bound's `perturbed`: idx -> the plain float32 returns of those
  candidates of args (qpos0, qvel0, actions, params, t0) under five
  perturbations the size of float32 rounding, on the CPU workers at once:
  sin and cos rounded from float64, and the start qpos, then qvel, moved
  by one machine epsilon (relative, at least absolute) either way."""
  import torch
  qpos0, qvel0, actions, params, t0 = args

  def nudge(x, sign):
    return x + sign * EPS32 * torch.clamp(x.abs(), min=1.0)

  def runs(idx):
    sub = actions[idx].contiguous()

    def submit(q, v, trig64=False):
      return plain_submit(task, sub.shape[1], (q, v, sub, params, t0), ops,
                          torch.float32,
                          witness="trig64" if trig64 else "nudge")

    jobs = {"trig_from_float64": submit(qpos0, qvel0, trig64=True)}
    for sign in (1, -1):
      jobs[f"qpos{sign:+d}eps"] = submit(nudge(qpos0, sign), qvel0)
      jobs[f"qvel{sign:+d}eps"] = submit(qpos0, nudge(qvel0, sign))
    return {k: j.get()[0][0] for k, j in jobs.items()}

  return runs


def print_witnessed(tag: str, res: dict) -> None:
  """The candidates noise_bound let pass on a perturbed plain run."""
  for c in res.get("f32", {}).get("rounding_witnessed", []):
    print(f"[{tag}] candidate {c['candidate']} beyond the bound "
          f"({c['kernel_over_bound']:.3g} of it), a perturbed plain run "
          f"beyond it on the kernel's side: kernel {c['kernel']:.7g}, plain "
          f"float32 {c['plain32']:.7g}, float64 {c['plain64']:.10g}, "
          f"perturbed {c['perturbed']}, on the kernel's side "
          f"{c['sides_with_the_kernel']}")


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


def ptxas_entries(log: str) -> list:
  """Each kernel entry's registers, stack frame, spills and static shared
  bytes from nvcc's -Xptxas -v report."""
  out, cur = [], None
  for ln in log.splitlines():
    m = re.search(r"Compiling entry function '(\w+)'", ln)
    if m:
      name = m.group(1)
      kernel = next((k for k in ("mr_returns_kernel", "mr_step_kernel")
                     if k in name), name)
      cur = {"kernel": kernel, "registers": None, "stack": 0,
             "spill_stores": 0, "spill_loads": 0, "smem": 0}
      out.append(cur)
      continue
    if cur is None:
      continue
    m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                  r"(\d+) bytes spill loads", ln)
    if m and cur["registers"] is None:
      cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                 spill_loads=int(m.group(3)))
    m = re.search(r"Used (\d+) registers", ln)
    if m:
      cur["registers"] = int(m.group(1))
      sm = re.search(r"(\d+) bytes smem", ln)
      cur["smem"] = int(sm.group(1)) if sm else 0
  return out


def geometry_keys(out: dict) -> dict:
  """The launch geometry a kernels-line row reports, from a phase's
  numbers."""
  g = out["geometry"]
  return {"warps_per_block": g["warps_per_block"],
          "blocks_per_sm": g["blocks_per_sm"],
          "sms_in_use": g["sms_in_use"]}


def start_qpos(model):
  """The model's home keyframe's qpos, or qpos0 where it has none."""
  import numpy as np
  try:
    return np.asarray(model.keyframe("home")[0], np.float32)
  except KeyError:
    return model.qpos0.detach().cpu().numpy().astype(np.float32)


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
  qpos = torch.tensor(start_qpos(task.model))[:, None]
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
  rtol 2e-3. A candidate the
  plain version scores at MAX_RETURN or more (diverged, or blown up to a
  finite return past it) must be scored so by the kernel too: past that
  point nothing compares, in any precision."""
  import torch
  from mujoco_mpc_torch.ops import megarollout as MR
  check(bool(torch.all(~torch.isnan(got))), f"{what}: NaN kernel returns")
  blown = want >= MR.MAX_RETURN
  check(bool(torch.all(got[blown] >= MR.MAX_RETURN)),
        f"{what}: the kernel scores a candidate below MAX_RETURN that the "
        f"plain version scores at or above it")
  ok = ~blown
  diff = (got[ok] - want[ok]).abs()
  rel = ratio(diff, want[ok].abs())
  out = {"max_rel": float(rel.max()), "max_abs": float(diff.max()),
         "blown": int(blown.sum())}
  check(out["max_rel"] <= 2e-3, f"{what}: kernel disagrees "
        f"with the plain version (max rel err {out['max_rel']:.3g} > 2e-3)")
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
  rel_k = ratio((got.double() - plain64).abs(), plain64.abs())
  rel_p = ratio((plain.double() - plain64).abs(), plain64.abs())
  out = {"kernel_beyond": int((rel_k > 2e-3).sum()),
         "plain_beyond": int((rel_p > 2e-3).sum()),
         "kernel_median": float(rel_k.median()),
         "plain_median": float(rel_p.median()),
         "kernel_vs_plain_max_rel": float(ratio(
             (got.double() - plain.double()).abs(), plain.double().abs())
             .max()),
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


def population_ratio(pop: dict) -> float:
  """A float_noise result as a fraction of what it allows: the kernel's
  count beyond rel 2e-3 of float64 over the count allowed."""
  return pop["kernel_beyond"] / max(2 * pop["plain_beyond"], 2)


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


def phase_breakdown(tag: str, mr, args, ops) -> dict:
  """Phase P at one bench cell: one plan's returns `args` through the
  float kernel of mr's size tier built with its phase counters
  (-DMR_PROFILE=1: clock64() on each candidate's lane 0 around each phase
  of a step, summed over candidates and steps), after a warm-up call
  through it. The cycles per candidate step by phase, their shares, and
  the counted call's kernel ms."""
  from mujoco_mpc_torch.ops import megarollout as MR
  n, horizon = args[2].shape[:2]
  with MR.float_kernels(profile=True):
    mr.returns(*args, **ops)
    MR.phase_cycles(mr.tier)  # the read zeroes the counters
    ms = timed_cuda(lambda: mr.returns(*args, **ops), 1)
    cyc = MR.phase_cycles(mr.tier)
  total, steps = sum(cyc.values()), n * horizon
  check(total > 0, f"{tag}: the profiling build counted no cycles")
  print(f"[P] {tag} {n}x{horizon} ({mr.tier.name} tier) through the "
        f"profiling build: {total / steps:.0f} cycles per candidate step, "
        f"kernel {ms:.3f} ms with the counters")
  for phase, c in cyc.items():
    print(f"    {phase:24s} {c / steps:10.0f} cycles/step "
          f"{100 * c / total:6.2f} %")
  return {"kernel_ms_profiled": ms, "cycles_per_step": total / steps,
          "per_step": {k: v / steps for k, v in cyc.items()},
          "share": {k: v / total for k, v in cyc.items()}}


# the host's CUDA launch calls as torch.profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def raw_events(prof) -> list:
  """A finished torch.profiler run's events as the profiler recorded
  them (name(), device_type(), start_ns(), end_ns()), without building
  its event tree, which takes minutes over the hundreds of thousands of
  launches of a derivative planner's plan."""
  return prof.profiler.kineto_results.events()


def busy_share(agent, steps: int = 5, warm: bool = True,
               host_ops: bool = True) -> dict:
  """The device's busy share over `steps` planner_steps of `agent` after
  a warm-up one (unless `warm` is False: the agent has planned already),
  as device_busy measures it. With host_ops False the profiler records
  the device's activity alone: a derivative planner's plan runs hundreds
  of thousands of host ops, whose recording doubles its wall time."""
  if warm:
    agent.planner_step()
  return device_busy(agent.planner_step, steps, host_ops)


def device_busy(fn, calls: int, host_ops: bool = False) -> dict:
  """The device's busy share over `calls` calls of fn: the union of the
  CUDA kernels' and copies' intervals that torch.profiler records (with
  the host's ops too where host_ops), over the host's wall time of the
  window, which ends in torch.cuda.synchronize(); and the kernels among
  those device events (the copies and memsets left out)."""
  import torch
  from torch.autograd import DeviceType
  torch.cuda.synchronize()
  acts = ([torch.profiler.ProfilerActivity.CPU] if host_ops else []) + [
      torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as prof:
    t = time.perf_counter()
    for _ in range(calls):
      fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t) * 1e6
  events = [e for e in raw_events(prof) if e.device_type() == DeviceType.CUDA]
  spans = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3) for e in events)
  busy, cur = 0.0, None
  for a, b in spans:  # the union of the device intervals
    if cur is None or a > cur[1]:
      busy += 0.0 if cur is None else cur[1] - cur[0]
      cur = [a, b]
    else:
      cur[1] = max(cur[1], b)
  busy += 0.0 if cur is None else cur[1] - cur[0]
  return {"wall_ms": wall_us / 1e3, "device_events": len(spans),
          "kernels": sum(not e.name().startswith(("Memcpy", "Memset"))
                         for e in events),
          "busy_ms": busy / 1e3,
          "busy_share": busy / wall_us if spans else None}


def ncu_probe(timeout: int = 180) -> dict:
  """Whether Nsight Compute (ncu) is on the host and, if it is, what it
  says of one Walker launch's occupancy and warp stalls (this script's
  --ncu-target, in a session of its own that a timeout stops whole)."""
  import shutil
  path = shutil.which("ncu") or next(
      (p for p in ("/usr/local/cuda/bin/ncu",) if os.path.exists(p)), None)
  if path is None:
    print("[P] ncu is not on this host: occupancy and stall reasons not "
          "measured")
    return {"present": False}
  proc = subprocess.Popen(
      [path, "--section", "Occupancy", "--section", "WarpStateStats", "-k",
       "regex:mr_returns", "-c", "1", sys.executable,
       os.path.abspath(__file__), "--ncu-target"],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
      start_new_session=True)
  try:
    text, _ = proc.communicate(timeout=timeout)
  except subprocess.TimeoutExpired:
    os.killpg(proc.pid, signal.SIGKILL)
    text = proc.communicate()[0] + f"\n(stopped after {timeout} s)"
  text = text[-3000:]
  print(f"[P] {path}, exit {proc.returncode}:\n{text}")
  return {"present": True, "path": path, "rc": proc.returncode,
          "output": text}


def ncu_target() -> int:
  """The process ncu profiles: one Walker launch of 256 x 20."""
  import torch
  from mujoco_mpc_torch.ops import megarollout as MR
  from mujoco_mpc_torch.tasks import registry
  dev = torch.device("cuda", 0)
  task = registry.get_task("Walker", device=dev)
  mr = MR.MegaRollout(task, 20, device=dev)
  gen = torch.Generator(device=dev).manual_seed(0)
  acts = 0.4 * torch.randn((256, 20, 6), device=dev, generator=gen)
  home = torch.tensor(task.model.keyframe("home")[0], device=dev)
  mr.returns(home, torch.zeros(9, device=dev), acts, task.params, 0.0)
  torch.cuda.synchronize()
  return 0


def probe_step(tag: str, mr, states, operands, exempt=(),
               qpos_witness: bool = False) -> dict:
  """One step of the float and double step kernels on probe states in which
  every row class carries force, against the plain step_tb: float32 qpos
  1e-5, qvel max(1e-3, 8 x the state's float32-vs-float64 distance), duals
  1e-4 * max; float64 1e-12, 1e-10, 1e-12 * max. With `qpos_witness` (the
  flat-ground tasks' covering states, tasks.base.covering_states, whose
  contact points reach up to tasks.base.COVER_DEPTH, 5 cm, into a surface)
  the float32 qpos hold is max(1e-5, 8 x the state's float32-vs-float64
  qpos distance), as qvel's: a step moves qpos by dt x qvel.
  `operands(dtype)` gives the mocap and userdata keywords; the row classes in `exempt` (ones no state of the
  model reaches) may carry none. Returns the errors per precision and the
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
  check(all(v > 0.0 for k, v in per_kind.items() if k not in exempt),
        f"{tag}: a constraint row class carries no force in the step check: "
        f"{per_kind}")
  noise = (plain[torch.float32][3].double()
           - plain[torch.float64][3]).abs().amax(0)
  qnoise = (plain[torch.float32][2].double()
            - plain[torch.float64][2]).abs().amax(0)
  qtol = torch.clamp(8.0 * qnoise, min=1e-5) if qpos_witness else 1e-5
  err = {}
  for dt, key in ((torch.float32, "f32"), (torch.float64, "f64")):
    x, ops, pq, pv, pl = plain[dt]
    kq, kv, kl = mr.step(*x, **ops)
    torch.cuda.synchronize()
    ev = (kv - pv).abs().amax(0).double()
    eq = (kq - pq).abs().amax(0).double()
    err[key] = {"qpos": float(eq.max()), "qpos_state": int(eq.argmax()),
                "states_qpos_over_1e-5": int((eq > 1e-5).sum()),
                "qpos_ok": bool(torch.all(eq <= qtol)),
                "qvel": float(ev.max()), "qvel_state": int(ev.argmax()),
                "lambda": float((kl - pl).abs().max()),
                "scale": float(pl.abs().max()),
                "qvel_over_noise": float((ev / noise).max()),
                "states_qvel_over_1e-3": int((ev > 1e-3).sum()),
                "qvel_ok": bool(torch.all(
                    ev <= torch.clamp(8.0 * noise, min=1e-3)))}
  e32, e64 = err["f32"], err["f64"]
  b = states[0].shape[1]
  qhold = (f"tol max(1e-5, 8 x the state's plain float32-vs-float64 qpos "
           f"distance, {float(qnoise[e32['qpos_state']])!r} there)"
           if qpos_witness else "tol 1e-5")
  print(f"[{tag}] one step, B={b}, nrow {mr.tm.nrow}, float32: max "
        f"|kernel - plain| qpos {e32['qpos']:.3g} at state "
        f"{e32['qpos_state']} ({qhold}; {e32['states_qpos_over_1e-5']} "
        f"states above 1e-5), qvel "
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
  check(e32["qpos_ok"] and e32["lambda"] <= 1e-4 * e32["scale"]
        and e32["qvel_ok"], f"{tag}: float32 step kernel disagrees")
  check(e64["qpos"] <= 1e-12 and e64["qvel"] <= 1e-10
        and e64["lambda"] <= 1e-12 * e64["scale"],
        f"{tag}: float64 step kernel disagrees")
  return {"err": err, "max_dual_per_class": per_kind,
          "dual_range_per_class": sign_range}


def drive_agent(tag: str, agent, nu: int, monotone: bool = True,
                hold: Hold = Hold()):
  """The main path: the agent's launch count set to 0, 5 plan steps at a
  fixed state, the count read back. Checks one launch per plan, finite
  costs and action, and (for the sampling planner, whose candidate 0 is
  the previous winner) a best return that does not rise. Then one plan's
  candidates, with the state's mocap poses and userdata, through the
  kernel (timed) and the plain version (on the workers; the checks
  deferred to resolve_deferred), held as `hold` says (hold_returns).
  Returns (the numbers, that plan's actions)."""
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
  out = {"best": best, "launches": launches, "ms_per_plan": plan_ms,
         "geometry": pl.mega.geometry(cfg.num_trajectories)}
  finish = hold_deferred(f"{tag}: returns {tuple(acts.shape)}", hold,
                         pl.mega, (d.qpos, d.qvel, acts, atask.params,
                                   d.time),
                         dict(mocap_pos=d.mocap_pos, mocap_quat=d.mocap_quat,
                              userdata=d.userdata), out)

  def report():
    res = finish()
    print(f"[{tag}] one plan's candidates {tuple(acts.shape)}: "
          f"{hold_summary(res)}; kernel {out['kernel_ms']:.3f} ms/call, "
          f"plain {out['plain_ms']:.1f} ms (on the card, beside "
          f"{CARD_WORKERS - 1} more plain runs)")
    print_witnessed(tag, res)

  DEFERRED.append(report)
  return out, acts


def hold_deferred(what: str, hold: Hold, mr, args, ops, out: dict,
                  witness=None):
  """The kernel's returns of args (qpos0, qvel0, actions, params, t0) with
  the rollout-constant ops, in float32 (timed into out["kernel_ms"]) and,
  where `hold` compares float64, from the double instance; the plain
  version's in float32 (the card's queue) and, where a hold needs it, in
  float64 (the CPU workers). Returns the deferred check: it waits for the
  plain returns, holds the kernel's (hold_returns, with the uncontracted
  kernel's returns `witness` and the plain version's under rounding-sized
  perturbations as noise_bound's witnesses), records the result and the
  plain times in `out` and returns the result."""
  import torch
  qpos0, qvel0, actions, params, t0 = args
  got = mr.returns(*args, **ops)
  out["kernel_ms"] = timed_cuda(lambda: mr.returns(*args, **ops), 3)
  got64 = None
  if hold.f64 is not None:
    wide = {k: v.double() for k, v in ops.items()}
    got64 = mr.returns(qpos0.double(), qvel0.double(), actions.double(),
                       params.to(dtype=torch.float64), torch.as_tensor(
                           t0).double(), **wide)
  torch.cuda.synchronize()
  task, horizon = mr.task, actions.shape[1]
  jobs = plain_submit(task, horizon, args, ops, torch.float32)
  needs64 = hold.f32 != PER_CANDIDATE or hold.f64 is not None
  jobs64 = (plain_submit(task, horizon, args, ops, torch.float64)
            if needs64 else None)

  def finish():
    (plain,), out["plain_ms"] = jobs.get()
    plain64 = None
    if jobs64 is not None:
      (plain64,), out["plain64_ms"] = jobs64.get()
    res = hold_returns(what, hold, got, plain, got64, plain64,
                       witness=witness,
                       perturbed=rounding_witnesses(task, args, ops))
    out.update(res)
    out.update(returns_rel_err=res["rel_err"], returns_abs_err=res["abs_err"])
    return res

  return finish


def bench_shape(tag: str, task, n: int, horizon: int, cfg, operands,
                reps: int, hold: Hold | None = Hold(NOISE_BOUND,
                                                     PER_CANDIDATE),
                prefix=None, profile: bool = False) -> dict:
  """The bench shape: SamplingPlanner.optimize timed at n x horizon at the
  task model's dt (median, p66.7, max over reps calls after a warm-up
  call), the kernel timed between CUDA events, and one plan's returns held
  against the plain version as `hold` says (hold_returns; by default the
  float kernel within its own float32 noise, the uncontracted kernel its
  witness, and the double instance per candidate). With `prefix`, the
  plain comparisons run on the first `prefix` candidates of the same
  action set: candidates are independent. With no `hold`, the bench is
  timed only: a caller whose Agent plans at the same horizon and dt holds
  the kernel there. With `profile`, phase P's breakdown of the timed
  returns (phase_breakdown)."""
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
  home = torch.tensor(start_qpos(task.model), device=dev)
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
  ops64 = operands(torch.float64)

  def wide(a):
    return (home.double(), v0.double(), a.double(),
            task.params.to(dtype=torch.float64), data.time.double())

  # the kernel timed over the whole action set before any plain run
  timed_args, timed64 = (home, v0, acts, task.params, data.time), wide(acts)
  ms = timed_cuda(lambda: planner.mega.returns(*timed_args, **ops32), 3)
  ms64 = timed_cuda(lambda: planner.mega.returns(*timed64, **ops64), 1)
  name = task.name
  out = {"optimize_ms": per_call, "steps_per_s": steps_s,
         "plan_hz": reps / wall, "kernel_ms": ms, "kernel64_ms": ms64,
         "geometry": planner.mega.geometry(n),
         "step_ops": step_ops(registry.get_task(name, device="cpu"))}
  out["bound_ms"], out["bound_by"] = bound(out["step_ops"], n, horizon, task)
  if profile:
    out["phases"] = phase_breakdown(task.name, planner.mega, timed_args,
                                    ops32)
  summary = (f"[{tag}] SamplingPlanner {shape} at dt "
             f"{float(task.model.opt.timestep):g}: {steps_s:.0f} steps/s, "
             f"{reps / wall:.3f} plan Hz; optimize ms median {q[0]:.3f}, "
             f"p66.7 {q[1]:.3f}, max {q[2]:.3f} (n={reps}); kernel "
             f"{ms:.3f} ms/call ({ms / horizon:.3f} ms per step), float64 "
             f"{ms64:.3f} ms/call")
  bounded = (f"[{tag}] plain {name} step at B=1: {out['step_ops']} "
             f"operations; bound at {shape} {out['bound_ms']:.4f} ms "
             f"({out['bound_by']}); kernel at "
             f"{100 * out['bound_ms'] / ms:.4f} % of it")
  if hold is None:
    print(f"{summary} (timed only: the Agent's phase held the kernel at "
          f"this horizon and dt)")
    print(bounded)
    return out
  if prefix is not None:  # the comparisons' candidates
    acts = acts[:prefix].contiguous()
  args = (home, v0, acts, task.params, data.time)
  # the uncontracted kernel's returns, on the card now (no timing runs
  # later in this phase): the witness of a candidate beyond the bound
  unfused = None
  if hold.f32 == NOISE_BOUND:
    with MR.float_kernels(contract=False):
      unfused = planner.mega.returns(*args, **ops32)
  timing = {}
  finish = hold_deferred(f"{name} returns {shape}", hold, planner.mega, args,
                         ops32, timing, witness=unfused)

  def report():
    res = finish()
    out.update(res, plain_ms=timing["plain_ms"],
               plain64_ms=timing.get("plain64_ms"))
    print(f"{summary}, plain {timing['plain_ms']:.1f} ms on the card beside "
          f"{CARD_WORKERS - 1} more plain runs ({acts.shape[0]} "
          f"candidates)")
    print(f"[{tag}] {hold_summary(res)}")
    for c in res.get("f32", {}).get("contraction_only", []):
      print(f"[{tag}] candidate {c['candidate']} beyond the bound by "
            f"contraction alone: kernel {c['kernel']:.7g} "
            f"({c['kernel_over_bound']:.3g} of the bound), uncontracted "
            f"{c['uncontracted']:.7g} "
            f"({c['uncontracted_over_bound']:.3g}), plain float32 "
            f"{c['plain32']:.7g}, float64 {c['plain64']:.10g}")
    print_witnessed(tag, res)
    print(bounded)

  DEFERRED.append(report)
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
  jobs = plain_submit(
      atask, acts.shape[1], (d.qpos, d.qvel, acts, atask.params, d.time),
      ops, torch.float32,
      [(p, torch.tensor(u, device=dev)) for p, u in variants.values()])
  gots = [pl.mega.returns(d.qpos, d.qvel, acts, params, d.time,
                          **operands(torch.float32, ud))
          for params, ud in variants.values()]
  torch.cuda.synchronize()
  mode_err = {}
  rec.update(quadruped_agent=drive, quadruped_mode_errs=mode_err)

  def finish():
    wants, _ = jobs.get()
    for case, got, want in zip(variants, gots, wants):
      mode_err[case] = agreement(got, want, f"Quadruped {case} returns")
    errs = {k: (float(f"{r:.3g}"), float(f"{a:.3g}"))
            for k, (r, a) in mode_err.items()}
    print(f"[4q-modes] per candidate at {tuple(acts.shape)}, (max rel, max "
          f"abs) err per branch (tol rel 2e-3): {errs}")

  DEFERRED.append(finish)

  # ---- 5q. the bench shape: 1024 candidates x 70 steps at the XML dt
  b5 = bench_shape("5q", task, 1024, 70, cfg, operands, reps)
  rec["quadruped_bench_1024x70"] = b5
  return lambda: {
      "name": "megarollout_returns[quadruped]", "route": "cuda",
      "source": "mujoco_mpc_torch/csrc/megarollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/megarollout.py:339",
      "launches": drive["launches"],
      "max_abs_err": max(drive["returns_abs_err"], b5["abs_err"]),
      "ms": b5["kernel_ms"], "plain_ms": b5["plain_ms"],
      "bound_ms": b5["bound_ms"], "bound_by": b5["bound_by"],
      "library_ms": None, **geometry_keys(b5),
      "err_over_tol": max([drive["err_over_tol"], b5["err_over_tol"]]
                          + [r / 2e-3 for r, _ in mode_err.values()])}


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
  return lambda: {
      "name": "megarollout_returns[shadow]", "route": "cuda",
      "source": "mujoco_mpc_torch/csrc/megarollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/megarollout.py:339",
      "launches": drive["launches"],
      "max_abs_err": max(drive["returns_abs_err"], b5["abs_err"]),
      "ms": b5["kernel_ms"], "plain_ms": b5["plain_ms"],
      "bound_ms": b5["bound_ms"], "bound_by": b5["bound_by"],
      "library_ms": None, **geometry_keys(b5),
      "err_over_tol": max(drive["err_over_tol"], b5["err_over_tol"])}


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
  drive, _ = drive_agent("4b", agent, 16, hold=Hold(NOISE_BOUND))
  rec["handover_agent"] = drive

  # ---- 5b. the bench shape: 256 candidates x 80 steps at the XML dt
  b5 = bench_shape("5b", task, 256, 80, cfg, operands, reps)
  rec["handover_bench_256x80"] = b5
  return lambda: {
      "name": "megarollout_returns[handover]", "route": "cuda",
      "source": "mujoco_mpc_torch/csrc/megarollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/megarollout.py:339",
      "launches": drive["launches"],
      "max_abs_err": max(drive["returns_abs_err"], b5["abs_err"]),
      "ms": b5["kernel_ms"], "plain_ms": b5["plain_ms"],
      "bound_ms": b5["bound_ms"], "bound_by": b5["bound_by"],
      "library_ms": None, **geometry_keys(b5),
      "err_over_tol": max(drive["err_over_tol"], b5["err_over_tol"])}


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
  drive, _ = drive_agent("4a", agent, 12, hold=Hold(NOISE_BOUND))
  rec["allegro_agent"] = drive

  # ---- 5a. the bench shape: 512 candidates x 80 steps at the XML dt
  b5 = bench_shape("5a", task, 512, 80, cfg, operands, reps, profile=True)
  rec["allegro_bench_512x80"] = b5
  return lambda: {
      "name": "megarollout_returns[allegro]", "route": "cuda",
      "source": "mujoco_mpc_torch/csrc/megarollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/megarollout.py:339",
      "launches": drive["launches"],
      "max_abs_err": max(drive["returns_abs_err"], b5["abs_err"]),
      "ms": b5["kernel_ms"], "plain_ms": b5["plain_ms"],
      "bound_ms": b5["bound_ms"], "bound_by": b5["bound_by"],
      "library_ms": None, **geometry_keys(b5),
      "err_over_tol": max(drive["err_over_tol"], b5["err_over_tol"])}


# the small tasks' Agent operands (tests/test_torch_small_tasks.py): a goal
# for the mocap tasks, Rubik Faces' face targets
SMALL_GOALS = {"Particle": [[0.1, -0.15, 0.01]],
               "ParticleFixed": [[0.1, -0.15, 0.01]],
               "Arm Reach": [[0.35, 0.25, 0.45]],
               "Push": [[0.55, -0.2, 0.035]]}
RUBIK_TARGETS = [1.5707963, 0.0, -1.5707963, 0.0, 0.0, 0.0]
# the bench shape of each small task: 1024 candidates over the Agent's
# horizon at the model's dt (ParticleFixed shares Particle's model)
SMALL_BENCH = {"Cartpole": 100, "Acrobot": 150, "Particle": 50,
               "Fingers": 100, "Arm Reach": 160, "Push": 140,
               "Rubik Faces": 50}
# the tasks whose model dt is their agent_timestep: the Agent plans at the
# bench's horizon and dt, so the Agent's phase holds the kernel there and
# the bench is timed only
SAME_DT = ("Cartpole", "Acrobot", "Particle", "Rubik Faces")
# how each small task's Agent plan (4x) is held: per candidate in both
# precisions, the float32 kernel within its own float32 noise, but
# Acrobot's float32 kernel as a population: its folded elbow (the links
# antiparallel, the reference's parent-child capsule pair active) puts
# the float32 closest points of the two links where rounding decides
# them, so a candidate's float32 rollout may cross a contact that float64
# does not (a state where the kernel and the plain float32 version agree,
# 31468 and 31417 N, and float64 has no contact)
SMALL_HOLD = {"Acrobot": Hold(POPULATION, PER_CANDIDATE)}


def zero_row_step(tag: str, mr, states, operands) -> dict:
  """One step of a model with no constraint rows (Rubik Faces) in both
  precisions: finite, no duals, and the plain step_tb's qpos and qvel
  (float32 1e-5 and 1e-4, float64 1e-12 and 1e-10)."""
  import torch
  from mujoco_mpc_torch.physics import tilestep

  check(mr.tm.nrow == 0, f"{tag}: {mr.tm.nrow} constraint rows")
  err = {}
  for dt, key, tq, tv in ((torch.float32, "f32", 1e-5, 1e-4),
                          (torch.float64, "f64", 1e-12, 1e-10)):
    x = [torch.tensor(v, device=mr.device, dtype=dt) for v in states]
    ops = operands(dt)
    kq, kv, kl = mr.step(*x, **ops)
    pq, pv, _ = run_plain(tilestep.step_tb, mr.tm, *x, **ops)
    torch.cuda.synchronize()
    err[key] = {"qpos": float((kq - pq).abs().max()),
                "qvel": float((kv - pv).abs().max())}
    check(bool(torch.all(torch.isfinite(kq)) and torch.all(
        torch.isfinite(kv))) and kl.shape[0] == 0,
          f"{tag}: non-finite step or duals in a zero-row model")
    check(err[key]["qpos"] <= tq and err[key]["qvel"] <= tv,
          f"{tag}: {key} zero-row step kernel disagrees: {err[key]}")
  print(f"[{tag}] one step with no constraint rows, B="
        f"{states[0].shape[1]}: float32 qpos {err['f32']['qpos']:.3g} "
        f"(tol 1e-5), qvel {err['f32']['qvel']:.3g} (tol 1e-4); float64 "
        f"{err['f64']['qpos']:.3g} (1e-12), {err['f64']['qvel']:.3g} (1e-10)")
  return err


def small_row(name, drive, b5) -> dict:
  """A small task's row of the kernels line, once its comparisons are in:
  the bench's kernel time (the Agent's for ParticleFixed), and the plain
  time where the bench compared, else the Agent's (at the same horizon and
  dt)."""
  timed = b5 if b5 is not None else drive
  held = [x for x in (drive, b5) if x and "err_over_tol" in x]
  return {
      "name": f"megarollout_returns[{name.lower()}]", "route": "cuda",
      "source": "mujoco_mpc_torch/csrc/megarollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/megarollout.py:339",
      "launches": drive["launches"],
      "max_abs_err": max(x["abs_err"] for x in held),
      "ms": timed["kernel_ms"], "plain_ms": (b5 or {}).get(
          "plain_ms", drive["plain_ms"]),
      "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
      "library_ms": None, **geometry_keys(timed), "err_over_tol": max(x["err_over_tol"]
                                              for x in held)}


def run_small_tasks(dev, rec: dict, reps: int) -> list:
  """Phases 3k (the ball chain: a ball joint and the sphere-capsule pair),
  3r (Rubik Faces' zero-row step), 4x and 5x per small task: the Agent at
  its defaults (Cartpole through planner="sampling": its MJCF names the
  gradient planner, not ported), held as SMALL_HOLD says, and the bench
  shape, 1024 candidates at the model's dt, compared on a 128-candidate
  prefix (timed only for SAME_DT). Returns their rows of the kernels
  line."""
  import torch
  from mujoco_mpc_torch.agent.agent import Agent
  from mujoco_mpc_torch.ops import megarollout as MR
  from mujoco_mpc_torch.tasks import base
  from mujoco_mpc_torch.tasks import class_models
  from mujoco_mpc_torch.tasks import registry
  from mujoco_mpc_torch.tasks import rubik

  # ---- 3k. the ball chain from its snapshot: a ball joint mid-chain
  #      (quaternions far from identity, some unnormalized), the
  #      sphere-capsule pair, plane-sphere and plane-capsule end points
  ctask = class_models.task("ball_chain", device=dev)
  rec["ball_chain_step"] = probe_step(
      "3k", MR.MegaRollout(ctask, 1, device=dev),
      class_models.states("ball_chain", ctask.model, 128), lambda dt: {})

  rows = []
  for name in ("Cartpole", "Acrobot", "Particle", "ParticleFixed",
               "Fingers", "Arm Reach", "Push", "Rubik Faces"):
    t_task = time.perf_counter()
    task = registry.get_task(name, device=dev)
    ud = None
    if name == "Rubik Faces":
      ud = rubik.faces_userdata(task.model.nuserdata, RUBIK_TARGETS)
    goal = SMALL_GOALS.get(name)

    def operands(dtype, goal=goal, ud=ud):
      ops = {}
      if goal is not None:
        ops["mocap_pos"] = torch.tensor(goal, dtype=dtype, device=dev)
      if ud is not None:
        ops["userdata"] = torch.tensor(ud, dtype=dtype, device=dev)
      return ops

    if name == "Rubik Faces":  # ---- 3r. no constraint rows at all
      rec["rubik_zero_row_step"] = zero_row_step(
          "3r", MR.MegaRollout(task, 1, device=dev),
          base.probe_states(task.model, 128), operands)
    # ---- 4x. the main path: the Agent at its defaults on the card
    agent = Agent(name, device=dev, planner="sampling")
    try:
      agent.reset("home")
    except KeyError:
      agent.reset()
    agent.set_state(**{k: v.cpu().numpy()
                       for k, v in operands(torch.float32).items()})
    drive, _ = drive_agent(f"4x {name}", agent, task.model.nu,
                              hold=SMALL_HOLD.get(
                                  name, Hold(NOISE_BOUND, PER_CANDIDATE)))
    rec[f"agent[{name}]"] = drive
    # ---- 5x. the bench shape (ParticleFixed: Particle's model and path)
    b5 = None
    if name in SMALL_BENCH:
      b5 = bench_shape(f"5x {name}", task, 1024, SMALL_BENCH[name],
                       agent.planner.config, operands, reps, prefix=128,
                       hold=None if name in SAME_DT else Hold(
                           NOISE_BOUND, PER_CANDIDATE))
      rec[f"bench[{name}]"] = b5
    if b5 is None:  # the kernels line's bound, at the Agent's shape
      cfg = agent.planner.config
      drive["bound_ms"], drive["bound_by"] = bound(
          step_ops(registry.get_task(name, device="cpu")),
          cfg.num_trajectories, cfg.horizon, agent.task)
    rec[f"phase_s[{name}]"] = time.perf_counter() - t_task
    print(f"[5x {name}] phases of {name} on the card: "
          f"{rec[f'phase_s[{name}]']:.1f} s")
    rows.append(functools.partial(small_row, name, drive, b5))
  return rows


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
    drive["policy_err"] = pol_err
    rec[f"cem_{name.lower()}"] = drive
  ops = step_ops(registry.get_task(name, device="cpu"))
  bound_ms, bound_by = bound(ops, acts.shape[0], acts.shape[1], agent.task)
  return lambda: {
      "name": "megarollout_returns[cem shadow]", "route": "cuda",
      "source": "mujoco_mpc_torch/csrc/megarollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/megarollout.py:339",
      "launches": drive["launches"], "max_abs_err": drive["returns_abs_err"],
      "ms": drive["kernel_ms"], "plain_ms": drive["plain_ms"],
      "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
      **geometry_keys(drive),
      "err_over_tol": drive["returns_rel_err"] / 2e-3}


# ---------------------------------------------------------------------------
# G: the general engine (physics/step.py) and the closed loop (Agent.step)
# ---------------------------------------------------------------------------

# the models of G1, and each one's probe states: (task, states(model, b))
GENERAL_MODELS = (("Walker", "base"), ("Humanoid Walk", "humanoid"),
                  ("Quadruped Flat", "quadruped"),
                  ("Bimanual Handover", "bimanual"), ("Allegro", "allegro"))


def tile_row_class(tm):
  """The coarse class of each row of the kernel's (tile) layout: normal,
  friction, torsional, rolling, limit, equality."""
  import numpy as np
  from mujoco_mpc_torch.physics import tilestep
  fric = tilestep.row_points(tm)[0]
  out = []
  for i, k in enumerate(tilestep.row_kinds(tm)):
    if i < 3 * len(fric):
      out.append("normal" if i % 3 == 0 else "friction")
    elif k in ("torsional", "rolling"):
      out.append(k)
    elif k in ("joint_limit", "tendon_limit"):
      out.append("limit")
    elif k.startswith("eq_"):
      out.append("equality")
    else:  # a condim-1 point's one row
      out.append("normal")
  return np.asarray(out)


def general_row_class(m):
  """The same classes in the general solver's layout (physics/solver.py)."""
  import numpy as np
  from mujoco_mpc_torch.physics import solver
  out = []
  if m.collision_pairs:
    lay = solver._Layout(m)
    rows = np.full(lay.ncrow, "friction", dtype=object)
    rows[lay.nrm] = "normal"
    out += list(rows) + ["torsional"] * len(lay.tor) + [
        "rolling"] * (2 * len(lay.roll))
  neq = sum({0: 3, 1: 6, 2: 1}[int(k)] for e, k in enumerate(m.eq_type)
            if m.eq_active0[e])
  out += ["limit"] * (solver.nrow_static(m) - len(out) - neq)
  out += ["equality"] * neq
  return np.asarray(out)


def class_sums(lam, classes):
  """{class: per-state sum of the duals (B,)} of lam (B, nrow)."""
  import numpy as np
  lam = np.asarray(lam)
  return {str(c): lam[:, classes == c].sum(1) for c in dict.fromkeys(classes)}


def profile_launches(fn) -> dict:
  """The CUDA kernels one call of fn launches (torch.profiler: device
  kernel events, and the host's cudaLaunchKernel calls)."""
  import torch
  from torch.autograd import DeviceType
  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as prof:
    fn()
    torch.cuda.synchronize()
  events = raw_events(prof)
  kernels = sum(1 for e in events if e.device_type() == DeviceType.CUDA)
  launches = sum(1 for e in events if e.name() in LAUNCH_CALLS)
  return {"device_events": kernels, "launch_calls": launches}


def general_step_check(name: str, states_of, dev, b: int = 16) -> dict:
  """G1 on one model: the general step of b probe states on the card in
  float64 against the same code on the CPU (1e-10), and against the
  kernel's float32 MegaRollout.step (qpos 1e-5; qvel max(1e-3, 8 x the
  state's float32-vs-float64 distance of the general step); each row
  class's summed force within max(1e-3 x its summed |force|, 8 x that
  distance of the general step's sum, 1e-6)). Then ms and CUDA launches
  per step of one state (the Agent's step) in float32."""
  import numpy as np
  import torch
  from mujoco_mpc_torch.ops import megarollout as MR
  from mujoco_mpc_torch.ops import rollout as R
  from mujoco_mpc_torch.physics import io as phys_io
  from mujoco_mpc_torch.physics import step as S
  from mujoco_mpc_torch.tasks import registry
  task32 = registry.get_task(name, device=dev)
  states = [np.ascontiguousarray(x[:, :b]) for x in states_of(task32.model,
                                                             b)]
  out = {}
  for key, device, dt in (("card64", dev, torch.float64),
                          ("cpu64", "cpu", torch.float64),
                          ("card32", dev, torch.float32)):
    m = registry.get_task(name, dtype=dt, device=device).model
    qp, qv, ct = (torch.tensor(x.T, dtype=dt, device=device) for x in states)
    d = R.broadcast(phys_io.make_data(m), (b,)).replace(qpos=qp, qvel=qv,
                                                         ctrl=ct)
    out[key] = run_plain(S.step, m, d)
  c64, h64, c32 = out["card64"], out["cpu64"], out["card32"]
  torch.cuda.synchronize()
  cpu_err = {f: float((getattr(c64, f).cpu() - getattr(h64, f)).abs().max())
             for f in ("qpos", "qvel", "efc_lambda")}
  check(cpu_err["qpos"] <= 1e-10 and cpu_err["qvel"] <= 1e-10,
        f"G1 {name}: the general step on the card is {cpu_err} from the "
        "CPU's in float64")
  # the kernel's step on the same states, with make_data's mocap poses
  mr = MR.MegaRollout(task32, 1, device=dev)
  d32 = phys_io.make_data(task32.model)
  x32 = [torch.tensor(x, device=dev) for x in states]
  kq, kv, kl = mr.step(*x32, mocap_pos=d32.mocap_pos,
                       mocap_quat=d32.mocap_quat, userdata=d32.userdata)
  torch.cuda.synchronize()
  noise = (c32.qvel.double() - c64.qvel).abs().amax(1).cpu()
  eq = (kq.T.double() - c64.qpos).abs().max().item()
  ev = (kv.T.double() - c64.qvel).abs().amax(1).cpu()
  tol_v = torch.clamp(8.0 * noise, min=1e-3)
  tcls, gcls = tile_row_class(mr.tm), general_row_class(task32.model)
  ks = class_sums(kl.T.double().cpu(), tcls)
  gs = class_sums(c64.efc_lambda.cpu(), gcls)
  gs32 = class_sums(c32.efc_lambda.double().cpu(), gcls)
  ga = class_sums(c64.efc_lambda.abs().cpu(), gcls)
  check(set(ks) == set(gs), f"G1 {name}: row classes {sorted(ks)} (kernel) "
        f"against {sorted(gs)} (general)")
  cls_err = {}
  for c in gs:
    tol = np.maximum(np.maximum(1e-3 * ga[c], 8.0 * np.abs(gs32[c] - gs[c])),
                     1e-6)
    cls_err[c] = float(np.max(np.abs(ks[c] - gs[c]) / tol))
  print(f"[G1] {name}, {b} probe states: general step card vs CPU (float64) "
        f"qpos {cpu_err['qpos']:.3g}, qvel {cpu_err['qvel']:.3g} (tol 1e-10),"
        f" duals {cpu_err['efc_lambda']:.3g}; general (float64) vs the "
        f"kernel's step (float32) qpos {eq:.3g} (tol 1e-5), qvel "
        f"{float(ev.max())!r} (tol max(1e-3, 8 x the general step's float32-"
        f"vs-float64 distance), worst ratio {float((ev / tol_v).max()):.3g});"
        f" per row class |sum kernel - sum general| over its tolerance "
        f"{ {c: round(v, 4) for c, v in cls_err.items()} }, summed force "
        f"{ {c: round(float(np.abs(v).max()), 3) for c, v in gs.items()} }")
  check(eq <= 1e-5 and bool(torch.all(ev <= tol_v)),
        f"G1 {name}: the general step disagrees with the kernel's")
  check(all(v <= 1.0 for v in cls_err.values()),
        f"G1 {name}: a row class's force disagrees with the kernel's")
  # one state, the Agent's step, in float32
  m = task32.model
  d1 = phys_io.make_data(m).replace(qpos=x32[0][:, 0].clone(),
                                    qvel=x32[1][:, 0].clone(),
                                    ctrl=x32[2][:, 0].clone())
  S.step(m, d1)  # builds the model's constants
  ms = timed_cuda(lambda: S.step(m, d1), 20)
  print(f"[G1] {name}: one state's general step (float32) {ms:.3f} ms "
        f"(CUDA events over 20 steps)")
  return {"card_vs_cpu": cpu_err, "qpos_vs_kernel": eq,
          "qvel_vs_kernel": float(ev.max()), "class_err": cls_err,
          "ms_per_step": ms, "one_step": lambda: S.step(m, d1)}


def no_sync_step(name: str, dev) -> None:
  """G1: one general step of one state under
  torch.cuda.set_sync_debug_mode("error"), which raises on a host sync."""
  import torch
  from mujoco_mpc_torch.physics import io as phys_io
  from mujoco_mpc_torch.physics import step as S
  from mujoco_mpc_torch.tasks import registry
  m = registry.get_task(name, device=dev).model
  d = phys_io.make_data(m)
  d = d.replace(qpos=torch.tensor(m.keyframe("home")[0], device=dev))
  d = S.step(m, d)  # the model's constants are built once, outside
  torch.cuda.synchronize()
  with no_sync(f"G1 {name}: the general step"):
    d = S.step(m, d)
  torch.cuda.synchronize()
  check(bool(torch.all(torch.isfinite(d.qpos))), f"G1 {name}: non-finite")
  print(f"[G1] {name}: one general step under set_sync_debug_mode('error')"
        f": no host sync")


def task_in(task, dtype, dev):
  """`task` (an Agent's, in float32) in `dtype` on dev: the registered
  task in `dtype` with `task`'s model constants, planning timestep and
  parameters cast to it. In float64 the general engine then holds the
  float32-rounded constants that the kernel's double instance packs
  (tilestep.extract of the float32 model)."""
  import dataclasses
  import torch
  from mujoco_mpc_torch.tasks import registry

  def cast(obj):
    return dataclasses.replace(obj, **{
        f.name: v.to(device=dev, dtype=dtype)
        for f in dataclasses.fields(obj) for v in (getattr(obj, f.name),)
        if isinstance(v, torch.Tensor) and v.is_floating_point()})

  t = registry.get_task(task.name, dtype=dtype, device=dev)
  m = task.model
  return t.replace(model=cast(m).replace(opt=cast(m.opt)),
                   params=task.params.to(device=dev, dtype=dtype))


def general_rollout_check(name: str, dev, n: int, horizon: int,
                          float32: bool) -> dict:
  """G2: one plan's candidates of Agent(name) (n x horizon) through the
  general batched rollout (ops/rollout.py) against the kernel's returns,
  per candidate at rtol 2e-3, atol 1e-4: in float64 (the double kernel
  instance; the general engine on the same float32-rounded constants,
  task_in) and, where float32 is not chaotic, in float32.

  The double instance holds the general engine's constants: a geom
  pair's solref and solimp mixed whole, and the constants derived from
  them (a row's stiffness, damping and impedance) whole, so a float64
  step of the two paths differs only in the order of its operations,
  which a chaotic rollout (the Humanoid's) may amplify. Where a
  float64 candidate misses, the returns are held as a population
  (float_noise): the kernel no further from the general returns than the
  general rollout on the unrounded (registered float64) constants is
  (twice its count beyond rel 2e-3, at least 2; twice its median), and
  the kernel's winner within 2e-3 of the general best."""
  import numpy as np
  import torch
  from mujoco_mpc_torch.agent.agent import Agent
  from mujoco_mpc_torch.planners import sampling
  from mujoco_mpc_torch.tasks import registry
  agent = Agent(name, device=dev, horizon_steps=horizon)
  agent.reset("home")
  cfg = agent.planner.config
  check(cfg.num_trajectories == n, f"G2 {name}: {cfg.num_trajectories} "
        f"candidates, not {n}")
  pl, task, d = agent.planner, agent.task, agent.data
  new_times, _, cands = pl._gen_candidates(task, agent.policy, d,
                                           agent.generator)
  res = {}
  for dt in ((torch.float64, torch.float32) if float32 else
             (torch.float64,)):
    acts = pl._actions(task, d, new_times, cands).to(dt)
    tdt = task_in(task, dt, dev)
    dd = d.replace(**{f: v.to(dt) for f, v in vars(d).items()
                      if isinstance(v, torch.Tensor) and v.is_floating_point()})

    def kernel_returns():
      return pl.mega.returns(dd.qpos, dd.qvel, acts, tdt.params, dd.time,
                             mocap_pos=dd.mocap_pos,
                             mocap_quat=dd.mocap_quat, userdata=dd.userdata)

    kernel = kernel_returns()
    kms = timed_cuda(kernel_returns, 3)
    t = time.perf_counter()
    general = run_plain(sampling.general_returns, tdt, dd,
                        new_times.to(dt), cands.to(dt), horizon, cfg.interp,
                        None)
    torch.cuda.synchronize()
    gms = (time.perf_counter() - t) * 1e3
    k, g = kernel.double().cpu().numpy(), general.double().cpu().numpy()

    bad = np.flatnonzero(np.abs(k - g) > 1e-4 + 2e-3 * np.abs(g))
    key = "f64" if dt == torch.float64 else "f32"
    res[key] = {"max_rel": float(np.max(np.abs(k - g) / np.maximum(
        np.abs(g), 1e-12))), "max_abs": float(np.max(np.abs(k - g))),
                "misses": [int(i) for i in bad],
                "kernel_ms": kms, "general_ms": gms}
    print(f"[G2] {name} {n}x{horizon} ({key}): general rollout vs kernel "
          f"returns, per candidate max rel {res[key]['max_rel']:.3g}, max "
          f"abs {res[key]['max_abs']:.3g} (rtol 2e-3, atol 1e-4), misses "
          f"{res[key]['misses']}; general rollout {gms:.1f} ms, kernel "
          f"{kms:.3f} ms")
    if len(bad) and dt == torch.float64:
      t64 = registry.get_task(name, dtype=dt, device=dev)
      t64 = t64.replace(model=t64.model.replace(opt=t64.model.opt.replace(
          timestep=tdt.model.opt.timestep)), params=tdt.params)
      unrounded = run_plain(sampling.general_returns, t64, dd,
                            new_times.to(dt), cands.to(dt), horizon,
                            cfg.interp, None)
      pop = res[key]["population"] = float_noise(
          kernel, unrounded, general, f"G2 {name} ({key})")
      print(f"[G2] {name} ({key}): held as a population, {pop}")
    else:
      check(not len(bad), f"G2 {name} ({key}): the general returns "
            f"disagree with the kernel's at candidates {res[key]['misses']}")
  return res


def closed_loop(name: str, dev, steps: int, plan_every: int = 2,
                planner=None, record_at: int = 0):
  """G3, the main path: Agent(name) from reset("home"), a planner_step
  every plan_every steps and step() between, for `steps` steps, with the
  kernel's launch count set to 0 before and read after. Returns (the
  numbers, the agent): the root body's horizontal displacement (also after
  record_at steps), the final total_cost, ms per Agent.step and per
  planner_step (each call synchronized), kernel launches and plans."""
  import numpy as np
  import torch
  from mujoco_mpc_torch.agent.agent import Agent
  from mujoco_mpc_torch.physics import step as S
  agent = (Agent(name, device=dev) if planner is None
           else Agent(name, device=dev, planner=planner))
  agent.reset("home")
  m = agent.sim_task.model

  def root():
    return S.forward(m, agent.data).xpos[1].cpu().numpy()

  start = root()
  agent.planner.mega.launches = 0
  plan_ms, step_ms, plans, early = [], [], 0, None
  for i in range(0, steps, plan_every):
    t = time.perf_counter()
    agent.planner_step()
    torch.cuda.synchronize()
    plan_ms.append((time.perf_counter() - t) * 1e3)
    plans += 1
    for k in range(min(plan_every, steps - i)):
      t = time.perf_counter()
      agent.step()
      torch.cuda.synchronize()
      step_ms.append((time.perf_counter() - t) * 1e3)
      if i + k + 1 == record_at:
        early = root() - start
  launches = agent.planner.mega.launches
  delta = root() - start
  cost = agent.total_cost()
  out = {"steps": steps, "plans": plans, "launches": launches,
         "horizontal_displacement": float(np.linalg.norm(delta[:2])),
         "displacement": [float(x) for x in delta], "final_cost": cost,
         "ms_per_step": float(np.mean(step_ms)),
         "plan_ms": plan_ms, "ms_per_plan": float(np.mean(plan_ms)),
         "sim_time": float(agent.data.time),
         "userdata": [float(x) for x in agent.data.userdata[:8].cpu()]}
  if early is not None:
    out[f"horizontal_displacement_at_{record_at}"] = float(
        np.linalg.norm(early[:2]))
  print(f"[G3] {name}: {steps} steps ({out['sim_time']:.3f} s), a "
        f"planner_step every {plan_every}: horizontal displacement "
        f"{out['horizontal_displacement']:.4f} m"
        + (f" ({out[f'horizontal_displacement_at_{record_at}']:.4f} m "
           f"after {record_at} steps)" if early is not None else "")
        + f", final total_cost {cost:.4f}; {out['ms_per_step']:.3f} ms per "
        f"Agent.step, {out['ms_per_plan']:.3f} ms per planner_step (each "
        f"synchronized), kernel launches {launches} in {plans} plans")
  check(launches == plans, f"G3 {name}: {launches} kernel launches in "
        f"{plans} plans")
  check(np.isfinite(cost) and np.all(np.isfinite(delta)),
        f"G3 {name}: non-finite state or cost")
  return out, agent


def loop_window(name: str, agent, out: dict, plan_every: int = 2,
                window: int = 10) -> None:
  """G3 under torch.profiler: `window` more plan-and-steps iterations of
  a driven agent; into `out` the CUDA launches per step, kernel launches
  per plan and the device's busy share (the union of the device intervals
  over the window's host wall time, ending in a synchronize)."""
  import torch
  from torch.autograd import DeviceType
  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  agent.planner.mega.launches = 0
  step_calls = []
  with torch.profiler.profile(activities=acts) as prof:
    t = time.perf_counter()
    for _ in range(window):
      agent.planner_step()
      for _ in range(plan_every):
        with torch.profiler.record_function("agent_step"):
          agent.step()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t) * 1e6
  events = prof.events()
  # the device's work: kernels, copies and sets (not the agent_step
  # range's own annotation on the device's timeline)
  spans = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == DeviceType.CUDA
                 and e.name != "agent_step")
  busy, cur = 0.0, None
  for a, b in spans:
    if cur is None or a > cur[1]:
      busy += 0.0 if cur is None else cur[1] - cur[0]
      cur = [a, b]
    else:
      cur[1] = max(cur[1], b)
  busy += 0.0 if cur is None else cur[1] - cur[0]
  names = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
           "cuLaunchKernelEx")
  steps = [e for e in events if e.name == "agent_step"
           and e.device_type == DeviceType.CPU]
  in_steps = sum(1 for e in events if e.name in names and any(
      s.time_range.start <= e.time_range.start <= s.time_range.end
      for s in steps))
  calls = sum(1 for e in events if e.name in names)
  nsteps = window * plan_every
  out.update(window_plans=window, window_steps=nsteps,
             window_wall_ms=wall_us / 1e3,
             window_kernel_launches=agent.planner.mega.launches,
             launches_per_step=in_steps / nsteps,
             launch_calls_per_plan=(calls - in_steps) / window,
             busy_share=busy / wall_us if spans else None)
  share = ("not measured (no device events)" if out["busy_share"] is None
           else f"{100 * out['busy_share']:.2f} %")
  print(f"[G3] {name}, {window} more plans and {nsteps} steps under "
        f"torch.profiler: {out['launches_per_step']:.1f} CUDA launches per "
        f"Agent.step, {out['launch_calls_per_plan']:.1f} per planner_step "
        f"({out['window_kernel_launches']} of them the rollout kernel), the "
        f"device busy {share} of {out['window_wall_ms']:.1f} ms")
  check(agent.planner.mega.launches == window,
        f"G3 {name}: {agent.planner.mega.launches} kernel launches in "
        f"{window} plans")


def run_general(dev, rec: dict) -> None:
  """Phases G1-G3. Every timing comes before the first torch.profiler
  run (the launch counts and busy shares, at the end)."""
  from mujoco_mpc_torch.tasks import (allegro, base, bimanual, humanoid,
                                      quadruped)
  probes = {"base": base.probe_states, "humanoid": humanoid.probe_states,
            "quadruped": quadruped.probe_states,
            "bimanual": bimanual.probe_states,
            "allegro": allegro.probe_states}
  g = rec.setdefault("general", {})
  g.update(G1={}, G2={}, G3={})
  t0 = time.perf_counter()

  def stamp(what):
    timeline(f"G +{time.perf_counter() - t0:.1f} s: {what}")

  one_step = {}
  for name, probe in GENERAL_MODELS:
    g["G1"][name] = general_step_check(name, probes[probe], dev)
    one_step[name] = g["G1"][name].pop("one_step")
  for name in ("Walker", "Humanoid Walk"):
    no_sync_step(name, dev)
  stamp("G1")
  # the closed loops; the Walker's JAX lock (tests/test_behaviors_tpu.py)
  # is 2.0 m in 800 steps at the model's 0.0025 s: 2 s, more than the
  # task's 1 m/s speed goal allows from rest; the JAX package's README
  # says "walks >=2 m in a 4 s sim", so the drive is 4 s
  agents = {}
  for name, steps, planner, at in (("Walker", 1600, None, 800),
                                   ("Quadruped Flat", 500, None, 0),
                                   ("Cartpole", 300, "sampling", 0)):
    g["G3"][name], agents[name] = closed_loop(name, dev, steps,
                                              planner=planner, record_at=at)
  stamp("G3's closed loops")
  walker, quad = g["G3"]["Walker"], g["G3"]["Quadruped Flat"]
  check(walker["horizontal_displacement"] >= 2.0
        and walker["final_cost"] < 10.0,
        f"G3 Walker: {walker['horizontal_displacement']:.4f} m (at least "
        f"2.0), final cost {walker['final_cost']:.4f} (below 10)")
  check(quad["horizontal_displacement"] >= 0.3 and quad["final_cost"] < 10.0,
        f"G3 Quadruped Flat: {quad['horizontal_displacement']:.4f} m (at "
        f"least 0.3), final cost {quad['final_cost']:.4f} (below 10)")
  g["G2"]["Walker"] = general_rollout_check("Walker", dev, 128, 80, True)
  g["G2"]["Humanoid Walk"] = general_rollout_check("Humanoid Walk", dev, 128,
                                                   33, False)
  stamp("G2")
  # the profiler runs
  for name, fn in one_step.items():
    prof = profile_launches(fn)
    g["G1"][name].update(prof)
    print(f"[G1] {name}: one state's general step launches "
          f"{prof['launch_calls']} CUDA kernels ({prof['device_events']} "
          f"device events in torch.profiler)")
  for name, agent in agents.items():
    loop_window(name, agent, g["G3"][name])


# ---------------------------------------------------------------------------
# the flat-ground tasks: five through the kernel (3f-5f), the nine closed
# loops (G4)
# ---------------------------------------------------------------------------

# G4's closed loops, Agent.steps each (a planner_step every 2): a
# general-route plan takes seconds of eager general steps (Swimmer's
# 128 x 200 7-9 s on the card), so those loops run 6 steps where the
# kernel tasks run 50, to keep the script's time
FLAT_LOOP_STEPS = {"kernel": 26, "general": 6}
# G4's float64 first plans on the general route, card against CPU: the
# candidates of each (a prefix of the Agent's count keeps the CPU's time
# down)
G4_CANDIDATES = 32
# the row classes of a flat-ground kernel task that no state reaches:
# OP3's hands move in two planes 0.15 m apart and never near a foot, so
# its hand-hand capsule pair and hand-foot capsule-box pair carry no force
# (tasks.base.covering_states)
FLAT_EXEMPT = {"OP3": ("cap_cap", "cap_box")}
# Pick's perturbed candidates diverge from about their 26th step at its
# planning dt, in the JAX package's general rollout as in the port
# (tests/test_torch_pick_divergence.py), so that its Agent-shape holds
# compare one finite candidate: its returns are held again, and the kernel
# timed, over the first PICK_FINITE_STEPS steps, where every candidate
# stays finite
PICK_FINITE_STEPS = 20


def flat_operands(name, model, dev):
  """A flat-ground task's goal and mode operands (tests/
  torch_flat_cases.py, or tests/torch_mesh_cases.py for Bimanual Insert
  and Quadruped Hill): operands(dtype), the phases' keywords, and the
  set_state keywords (numpy)."""
  import torch
  from tests import torch_flat_cases as fc
  from tests import torch_mesh_cases as mc
  mp, mq, ud = (mc.operands if name in mc.NEW_KINDS else fc.operands)(
      name, model)
  state = {"userdata": ud}
  if model.nmocap:
    state.update(mocap_pos=mp, mocap_quat=mq)

  def operands(dtype):
    return {k: torch.tensor(v, dtype=dtype, device=dev)
            for k, v in state.items()}

  return operands, state


def flat_row(name, drive, b5, carve, finite=None) -> dict:
  """A flat-ground kernel task's row of the kernels line: the bench's
  kernel, plain and bound times and geometry, the Agent's launches; for
  Pick (`finite`, pick_finite) also the same over its first
  PICK_FINITE_STEPS steps."""
  from tests import torch_flat_cases as fc
  row = {
      "name": f"megarollout_returns[{fc.KERNEL_ROWS[name]}]",
      "route": "cuda", "source": "mujoco_mpc_torch/csrc/megarollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/megarollout.py:339",
      "launches": drive["launches"],
      "max_abs_err": max(drive["returns_abs_err"], b5["abs_err"]),
      "ms": b5["kernel_ms"], "plain_ms": b5["plain_ms"],
      "bound_ms": b5["bound_ms"], "bound_by": b5["bound_by"],
      "library_ms": None, **geometry_keys(b5), "block_bytes": carve,
      "err_over_tol": max(drive["err_over_tol"], b5["err_over_tol"])}
  if finite is not None:
    a, b = finite["agent"], finite["bench"]
    row["finite_horizon"] = {
        "steps": finite["agent"]["horizon"], "ms": b["kernel_ms"],
        "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
        "max_abs_err": max(a["returns_abs_err"], b["abs_err"]),
        "err_over_tol": max(a["err_over_tol"], b["err_over_tol"])}
  return row


def pick_finite(agent, acts, operands, reps: int) -> dict:
  """4f and 5f for Pick over its first PICK_FINITE_STEPS steps: the
  Agent's plan candidates `acts` cut to those steps, every float32 kernel
  return below MAX_RETURN, held per candidate against the plain version
  in float32 (within its noise) and float64; then 512 candidates timed
  (bench_shape, its plain hold on a 128-candidate prefix). The deferred
  check fails if a candidate reaches MAX_RETURN in float64. Returns the
  hold's and the bench's numbers."""
  import torch
  from mujoco_mpc_torch.ops import megarollout as MR
  task, d, h = agent.task, agent.data, PICK_FINITE_STEPS
  cut = acts[:, :h].contiguous()
  args = (d.qpos, d.qvel, cut, task.params, d.time)
  ops = dict(mocap_pos=d.mocap_pos, mocap_quat=d.mocap_quat,
             userdata=d.userdata)
  mr = MR.MegaRollout(task, h, device=task.model.device)
  got = mr.returns(*args, **ops)
  check(bool(torch.all(got < MR.MAX_RETURN)),
        f"4f Pick: a candidate at MAX_RETURN in its first {h} steps")
  out = {"horizon": h}
  finish = hold_deferred(f"4f Pick: returns {tuple(cut.shape)}",
                         Hold(NOISE_BOUND, PER_CANDIDATE), mr, args, ops, out)
  b5 = bench_shape("5f Pick", task, 512, h, agent.planner.config, operands,
                   reps, prefix=128)

  def report():
    res = finish()
    print(f"[4f Pick] the Agent's candidates {tuple(cut.shape)}, the first "
          f"{h} of its {acts.shape[1]} steps: {hold_summary(res)}; kernel "
          f"{out['kernel_ms']:.3f} ms/call")
    print_witnessed("4f Pick", res)
    check(out["f64"]["blown"] == 0 and b5["f64"]["blown"] == 0,
          f"Pick: a candidate at MAX_RETURN in its first {h} steps")

  DEFERRED.append(report)
  return {"agent": out, "bench": b5}


def run_flat_tasks(dev, rec: dict, reps: int) -> list:
  """Phases 3f, 4f and 5f per flat-ground kernel task (OP3, Pick,
  PickAndPlace, Bimanual Reorient, Humanoid Interact), all in the large
  tier, at the Agent's planning dt with the task's goal and mode
  operands: 3f one step of 128 states in which every row class carries
  force (tasks.base.covering_states; FLAT_EXEMPT), float32 and double;
  the bytes of a block (the model head and one candidate's working set,
  carve) in both precisions; 4f the Agent at its own shape, its plan's
  candidates held per candidate in both precisions; 5f 512 candidates
  over the Agent's horizon, timed, compared on a 128-candidate prefix.
  Returns their rows of the kernels line."""
  import torch
  from mujoco_mpc_torch.agent.agent import Agent
  from mujoco_mpc_torch.ops import megarollout as MR
  from tests import torch_flat_cases as fc

  rows = []
  for name in fc.KERNEL_TASKS:
    t_task = time.perf_counter()
    agent = Agent(name, device=dev)
    agent.reset("home")
    task, cfg = agent.task, agent.planner.config
    operands, state = flat_operands(name, task.model, dev)
    agent.set_state(**state)
    mega = agent.planner.mega
    check(mega.tier.name == "large",
          f"{name} plans in the {mega.tier.name} tier")
    carve = {}
    for dt in (torch.float32, torch.float64):
      g = mega.geometry(cfg.num_trajectories, dt)
      carve[str(dt).split(".")[1]] = {
          "cand_bytes": g["cand_bytes"],
          "head_and_one_cand": g["smem_bytes"] - (g["warps_per_block"] - 1)
          * g["cand_bytes"], "smem_bytes": g["smem_bytes"],
          "warps_per_block": g["warps_per_block"]}
    print(f"[3f {name}] nrow {mega.tm.nrow}, {mega.tm.ncon} contact "
          f"points; a block's shared memory at {cfg.num_trajectories} "
          f"candidates: {carve} (the card allows {MR.SMEM_MAX})")
    # ---- 3f. one step on states in which every row class carries force
    rec[f"flat_step[{name}]"] = probe_step(
        f"3f {name}", MR.MegaRollout(task, 1, device=dev),
        fc.states(name, task.model, 128), operands,
        exempt=FLAT_EXEMPT.get(name, ()), qpos_witness=True)
    # ---- 4f. the main path: the Agent at its own shape
    drive, acts = drive_agent(f"4f {name}", agent, task.model.nu,
                              hold=Hold(NOISE_BOUND, PER_CANDIDATE))
    rec[f"flat_agent[{name}]"] = drive
    # ---- 5f. 512 candidates over the Agent's horizon at its dt
    b5 = bench_shape(f"5f {name}", task, 512, cfg.horizon, cfg, operands,
                     reps, prefix=128)
    b5["block_bytes"] = carve
    rec[f"flat_bench[{name}]"] = b5
    print(f"[5f {name}] launch geometry at 512x{cfg.horizon}: "
          f"{b5['geometry']}; phases of {name} on the card: "
          f"{time.perf_counter() - t_task:.1f} s")
    finite = None
    if name == "Pick":
      finite = rec["flat_finite[Pick]"] = pick_finite(agent, acts, operands,
                                                      reps)
    rows.append(functools.partial(flat_row, name, drive, b5, carve, finite))
  return rows


def first_general_plan(name: str, device) -> dict:
  """G4: the first float64 optimize of Agent(name) on the general route
  from its home keyframe (or reset()), with the task's operands and
  G4_CANDIDATES candidates (the injected standard normals and second-std
  flags of seed 0): best_return, winner and the new policy's values
  (numpy)."""
  import warnings
  import numpy as np
  import torch
  from mujoco_mpc_torch.agent.agent import Agent
  from mujoco_mpc_torch.tasks import registry
  task = registry.get_task(name, dtype=torch.float64, device=device)
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")  # the general route's warning
    agent = Agent(task, device=device)
  try:
    agent.reset("home")
  except KeyError:
    agent.reset()
  agent.set_state(**flat_operands(name, agent.task.model, device)[1])
  cfg = agent.planner.config
  n = G4_CANDIDATES
  rng = np.random.RandomState(0)
  noise = torch.tensor(rng.randn(n - 1, cfg.spline_points, task.model.nu),
                       device=device)
  use2 = torch.tensor(rng.rand(n - 1) < 0.2, device=device)
  policy, info = agent.planner.optimize(agent.task, agent.policy, agent.data,
                                        agent.generator, noise=noise,
                                        use2=use2)
  return {"best_return": float(info.best_return),
          "winner": int(info.winner),
          "values": policy.values.detach().cpu().numpy()}


def _first_general_plan_job(name: str) -> dict:
  """first_general_plan on the CPU, in a worker, with its seconds."""
  t = time.perf_counter()
  return {**first_general_plan(name, "cpu"),
          "cpu_s": time.perf_counter() - t}


def flat_loop(name: str, dev, steps: int) -> dict:
  """G4, the main path: Agent(name) from its home keyframe (or reset())
  with the task's operands, a planner_step every 2 steps and step()
  between, for `steps` steps; the kernel's launch count set to 0
  before and read after, the transition's calls counted with the device
  of the state they read. Checks a finite state and cost, the transition
  on the card at every step, and one kernel launch a plan through the
  kernel (none on the general route)."""
  import warnings
  import numpy as np
  import torch
  from mujoco_mpc_torch.agent.agent import Agent
  with warnings.catch_warnings():
    warnings.simplefilter("ignore")  # the general route's warning
    agent = Agent(name, device=dev)
  try:
    agent.reset("home")
  except KeyError:
    agent.reset()
  agent.set_state(**flat_operands(name, agent.task.model, dev)[1])
  seen = []
  inner = agent.task.transition
  if inner is not None:
    def counted(model, data, params):
      seen.append(data.qpos.device.type)
      return inner(model, data, params)
    agent.task = agent.task.replace(transition=counted)
  mega = agent.planner.mega
  if mega is not None:
    mega.launches = 0
  plan_ms, step_ms, plans = [], [], 0
  for i in range(0, steps, 2):
    t = time.perf_counter()
    agent.planner_step()
    torch.cuda.synchronize()
    plan_ms.append((time.perf_counter() - t) * 1e3)
    plans += 1
    for _ in range(min(2, steps - i)):
      t = time.perf_counter()
      agent.step()
      torch.cuda.synchronize()
      step_ms.append((time.perf_counter() - t) * 1e3)
  launches = 0 if mega is None else mega.launches
  d = agent.data
  finite = bool(torch.all(torch.isfinite(d.qpos))
                and torch.all(torch.isfinite(d.qvel)))
  cost = agent.total_cost()
  cfg = agent.planner.config
  out = {"steps": steps, "plans": plans, "launches": launches,
         "route": "kernel" if mega is not None else "general",
         "shape": [cfg.num_trajectories, cfg.horizon],
         "ms_per_step": float(np.mean(step_ms)),
         "plan_ms": plan_ms, "ms_per_plan": float(np.mean(plan_ms)),
         "ms_per_plan_median": float(np.median(plan_ms)),
         "final_cost": cost, "transition_calls": len(seen),
         "userdata": [float(x) for x in d.userdata[:4].cpu()],
         "sim_time": float(d.time)}
  print(f"[G4] {name} ({out['route']} route, {cfg.num_trajectories}x"
        f"{cfg.horizon} at dt {float(agent.task.model.opt.timestep):g}): "
        f"{steps} steps, a planner_step every 2: "
        f"{out['ms_per_step']:.3f} ms per Agent.step, "
        f"{out['ms_per_plan']:.3f} ms per planner_step (median "
        f"{out['ms_per_plan_median']:.3f}; each synchronized), kernel "
        f"launches {launches} in {plans} plans; transition calls "
        f"{len(seen)} on {sorted(set(seen))}; final cost {cost:.4f}, "
        f"userdata[:4] {out['userdata']}")
  check(finite and np.isfinite(cost), f"G4 {name}: non-finite state or cost")
  check(launches == (plans if mega is not None else 0),
        f"G4 {name}: {launches} kernel launches in {plans} plans")
  if inner is not None:
    check(len(seen) == steps and set(seen) == {"cuda"},
          f"G4 {name}: the transition ran {len(seen)} times on {set(seen)}")
  return out


def flat_first_plans(dev, rec: dict) -> None:
  """Phase G4's holds: the first float64 plan of each general-route
  flat-ground task on the card against the CPU's (rel 1e-8 of
  best_return, the same winner, the policy's values within 1e-6 of their
  max; G4_CANDIDATES candidates). Times nothing."""
  import numpy as np
  from tests import torch_flat_cases as fc
  g = rec.setdefault("general", {})["G4"] = {}
  cpu = {name: PLAIN.submit(_first_general_plan_job, name)
         for name in fc.GENERAL_TASKS}
  for name in fc.GENERAL_TASKS:
    card = first_general_plan(name, dev)
    ref = cpu[name].result()
    br = abs(card["best_return"] - ref["best_return"]) / max(
        abs(ref["best_return"]), 1e-300)
    gap = rel_to_max(card["values"], ref["values"])
    g[f"first_plan[{name}]"] = {"best_return": card["best_return"],
                                "best_return_rel": br, "values_gap": gap,
                                "winner": (card["winner"], ref["winner"]),
                                "cpu_s": ref["cpu_s"]}
    print(f"[G4] {name}: first float64 plan, {G4_CANDIDATES} candidates "
          f"on the general route, card vs CPU: best_return {card['best_return']:.10g} rel "
          f"{br:.3g} (tol 1e-8), values {gap:.3g} of the max (tol 1e-6), "
          f"winner {card['winner']} ({ref['winner']} on the CPU, "
          f"{ref['cpu_s']:.1f} s in its worker)")
    check(card["winner"] == ref["winner"] and br <= 1e-8 and gap <= 1e-6
          and np.isfinite(card["best_return"]),
          f"G4 {name}: the first plan on the card disagrees with the CPU's")


def run_flat_loops(dev, rec: dict) -> None:
  """Phase G4's closed loops: the nine tasks (flat_loop,
  FLAT_LOOP_STEPS), every float32 plan at the Agent's own shape."""
  from tests import torch_flat_cases as fc
  g = rec["general"]["G4"]
  for name in fc.KERNEL_TASKS:
    g[name] = flat_loop(name, dev, FLAT_LOOP_STEPS["kernel"])
  for name in fc.GENERAL_TASKS:
    g[name] = flat_loop(name, dev, FLAT_LOOP_STEPS["general"])


# ---------------------------------------------------------------------------
# D: every planner through the Agent, and the derivative planners' rates
# ---------------------------------------------------------------------------

# the reference order (mjpc/planners/include.h:26-34)
PLANNERS = ("sampling", "gradient", "ilqg", "ilqs", "robust",
            "cross_entropy", "sample_gradient")
# MegaRollout launches per plan on the Walker: sample-gradient scores its
# perturbations, then its gradient candidates; robust and iLQS score their
# sampling candidates once; iLQG and the gradient planner run the general
# engine only
PLAN_LAUNCHES = {"sampling": 1, "gradient": 0, "ilqg": 0, "ilqs": 1,
                 "robust": 1, "cross_entropy": 1, "sample_gradient": 2}
# D2's timed float32 plans a planner: 5, but 1 of the planners whose plan
# takes seconds of eager general steps, and D3's of iLQG on Humanoid Walk
# (to keep the script's time: a full run took 1,250 s on a slow host)
PLAN_REPS = {"gradient": 1, "ilqg": 1, "ilqs": 1, "robust": 1}
D3_HUMANOID_REPS = 1
# D3's quick start: Agent("Cartpole") with its own planner, a plan every 2
# steps, for about this many seconds and at least this many steps
QUICK_START_S, QUICK_START_STEPS = 20.0, 4
# D2: the planner_steps over which sample-gradient's two launches are timed
# apart
LAUNCH_SPLIT_REPS = 3


def planner_inputs(name: str, planner, model, seed: int = 0) -> dict:
  """The random inputs of one optimize of `planner` (numpy, from a seed):
  the sampling candidates' standard normals and second-std flags,
  robust's re-scoring normals (T, ncandidates, nrepetitions, nbody, 6),
  sample-gradient's perturbations; none for iLQG and the gradient
  planner."""
  import numpy as np
  rng = np.random.RandomState(seed)
  if name == "sample_gradient":
    c = planner.config
    return {"noise": rng.randn(c.num_noisy, c.spline_points, model.nu)}
  if name not in ("sampling", "ilqs", "robust", "cross_entropy"):
    return {}
  cfg = {"ilqs": lambda: planner.config.sampling,
         "robust": lambda: planner.delegate.config}.get(
             name, lambda: planner.config)()
  n, k = cfg.num_trajectories, cfg.spline_points
  out = {"noise": rng.randn(n - 1, k, model.nu)}
  if name != "cross_entropy":
    out["use2"] = rng.rand(n - 1) < 0.2
  if name == "robust":
    rc = planner.config
    out["eps"] = rng.randn(cfg.horizon, rc.ncandidates, rc.nrepetitions,
                           model.nbody, 6)
  return out


def first_plan(name: str, device, seed: int = 0) -> dict:
  """D2: the first optimize of Agent("Walker", planner=name) in float64
  from reset("home") on `device`, with planner_inputs(seed): its
  best_return, winner and the new policy's arrays (numpy), its kernel
  launches, and whether the kernel scored the winning return."""
  import torch
  from mujoco_mpc_torch.agent.agent import Agent
  from mujoco_mpc_torch.tasks import registry
  task = registry.get_task("Walker", dtype=torch.float64, device=device)
  agent = Agent(task, planner=name, device=device)
  agent.reset("home")
  inputs = planner_inputs(name, agent.planner, agent.task.model, seed)
  kw = {k: torch.as_tensor(v, device=device) for k, v in inputs.items()}
  mega = agent.planner.mega
  if mega is not None:
    mega.launches = 0
  policy, info = agent.planner.optimize(agent.task, agent.policy, agent.data,
                                        agent.generator, **kw)
  fields = {"ilqg": ("us", "gains"),
            "ilqs": ("sampling.values", "ilqg.us", "ilqg.gains")}.get(
                name, ("values",))
  out = {"best_return": float(info.best_return),
         "winner": int(info.winner),
         "launches": 0 if mega is None else mega.launches,
         "kernel_scored": name in KERNEL_SCORED or (
             name == "ilqs" and not bool(policy.use_ilqg))}
  for f in fields:
    v = policy
    for part in f.split("."):
      v = getattr(v, part)
    out[f] = v.detach().cpu().numpy()
  return out


def _first_plan_job(name: str) -> dict:
  """first_plan on the CPU, in a worker, with its seconds."""
  t = time.perf_counter()
  return {**first_plan(name, "cpu"), "cpu_s": time.perf_counter() - t}


# the planners whose winning return the kernel scores (iLQS's too where
# its sampling half wins)
KERNEL_SCORED = ("sampling", "cross_entropy", "sample_gradient")
# D2's holds of a first float64 plan, card against CPU: the policy's
# arrays within 1e-6 of their max, best_return within 1e-8 of itself,
# whether the general engine or the kernel scored it (through the double
# library as built, and built without multiply-add contraction)
PLAN_TOL = {"arrays": 1e-6, "general": 1e-8, "kernel": 1e-8,
            "uncontracted": 1e-8}


def quick_start(device, steps: int, dtype_name: str = "float64") -> dict:
  """Agent("Cartpole") with its own planner from reset("home"), a
  planner_step every 2 steps, for `steps` steps in `dtype_name`: the
  states after each step (numpy)."""
  import numpy as np
  import torch
  from mujoco_mpc_torch.agent.agent import Agent
  from mujoco_mpc_torch.tasks import registry
  task = registry.get_task("Cartpole", dtype=getattr(torch, dtype_name),
                           device=device)
  agent = Agent(task, device=device)
  agent.reset("home")
  qpos, qvel = [], []
  for i in range(steps):
    if i % 2 == 0:
      agent.planner_step()
    d = agent.step()
    qpos.append(d.qpos.cpu().numpy())
    qvel.append(d.qvel.cpu().numpy())
  return {"planner": agent.planner_name, "qpos": np.stack(qpos),
          "qvel": np.stack(qvel)}


def _quick_start_job(steps: int) -> dict:
  """quick_start on the CPU in float64, in a worker, with its seconds."""
  t = time.perf_counter()
  return {**quick_start("cpu", steps), "cpu_s": time.perf_counter() - t}


def rel_to_max(got, want) -> float:
  """max |got - want| over max |want|."""
  import numpy as np
  got, want = np.asarray(got), np.asarray(want)
  return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                1e-300))


def nominal_states(task, horizon: int, seed: int = 0):
  """(xs (T+1, nq+nv), us (T, nu), ts (T,), the start Data): the general
  step from the home keyframe under random controls inside the control
  range."""
  import numpy as np
  import torch
  from mujoco_mpc_torch.physics import io as phys_io
  from mujoco_mpc_torch.physics import step as S
  m = task.model
  q, v, _ = m.keyframe("home")
  d = phys_io.make_data(m).replace(
      qpos=torch.tensor(q, dtype=m.dtype, device=m.device),
      qvel=torch.tensor(v, dtype=m.dtype, device=m.device))
  lo, hi = m.actuator_ctrlrange[:, 0], m.actuator_ctrlrange[:, 1]
  us = lo + (hi - lo) * torch.tensor(
      np.random.RandomState(seed).uniform(0.1, 0.9, (horizon, m.nu)),
      dtype=m.dtype, device=m.device)
  xs, dd = [torch.cat([d.qpos, d.qvel])], d
  for i in range(horizon):
    dd = S.step(m, dd.replace(ctrl=us[i]))
    xs.append(torch.cat([dd.qpos, dd.qvel]))
  ts = d.time + m.opt.timestep * torch.arange(horizon, dtype=m.dtype,
                                              device=m.device)
  return torch.stack(xs), us, ts, d


def jacobian_check(name: str, dev, states: int = 8) -> dict:
  """D1 on one model: the transition Jacobians A and B at `states` states
  along a nominal from home, in float64 on the card, against the same
  call on the CPU (each matrix within 1e-9 of its max) and against
  central differences of the card's own float64 step (eps 1e-6; the
  worst gap within 1e-3 of each Jacobian's max)."""
  import torch
  from mujoco_mpc_torch.ops import rollout as R
  from mujoco_mpc_torch.physics import step as S
  from mujoco_mpc_torch.planners import ilqg
  from mujoco_mpc_torch.tasks import registry
  out = {}
  planner = ilqg.ILQGPlanner(ilqg.ILQGConfig(horizon=states))
  for key, device in (("card", dev), ("cpu", "cpu")):
    task = registry.get_task(name, dtype=torch.float64, device=device)
    xs, us, ts, d = nominal_states(task, states)
    a, b = planner.jacobians(task, d, xs, us, ts)
    out[key] = (a.cpu(), b.cpu())
    if key == "card":
      card = (task, xs, us, ts, d)
  torch.cuda.synchronize()
  cpu_gap = max(rel_to_max(x[t], y[t]) for x, y in zip(out["card"],
                                                        out["cpu"])
                for t in range(states))
  # central differences: every +-eps of every state in one batched step
  task, xs, us, ts, d = card
  m = task.model
  nx, nxu, eps = 2 * m.nv, 2 * m.nv + m.nu, 1e-6
  e = eps * torch.eye(nxu, dtype=torch.float64, device=dev)
  dxu = torch.cat([e, -e])[None].expand(states, 2 * nxu, nxu)
  xf = ilqg.apply_tangent(m, xs[:-1, None], dxu[..., :nx])
  dd = R.broadcast(d, dxu.shape[:2]).replace(
      qpos=xf[..., :m.nq], qvel=xf[..., m.nq:],
      ctrl=us[:, None] + dxu[..., nx:],
      time=ts[:, None].expand(dxu.shape[:2]))
  dd = run_plain(S.step, m, dd)
  f = ilqg.tangent(m, torch.cat([dd.qpos, dd.qvel], dim=-1), xs[1:, None])
  cd = ((f[:, :nxu] - f[:, nxu:]) / (2 * eps)).transpose(1, 2).cpu()
  jac = torch.cat(out["card"], dim=-1)
  cd_gap = max(rel_to_max(jac[t], cd[t]) for t in range(states))
  print(f"[D1] {name}: A {tuple(jac.shape[1:2]) * 2}, B "
        f"{tuple(out['card'][1].shape[1:])} at {states} states from home "
        f"(float64): card vs CPU worst {cpu_gap:.3g} of a matrix's max "
        f"(tol 1e-9); against central differences of the card's step "
        f"(eps 1e-6) worst {cd_gap:.3g} of a Jacobian's max (tol 1e-3)")
  check(cpu_gap <= 1e-9, f"D1 {name}: the Jacobians on the card are "
        f"{cpu_gap:.3g} from the CPU's")
  check(cd_gap <= 1e-3, f"D1 {name}: the Jacobians are {cd_gap:.3g} from "
        "central differences")
  return {"card_vs_cpu": cpu_gap, "vs_central_differences": cd_gap}


def precision_check(what: str) -> None:
  """Float32 matmuls at full precision (no TF32), as the derivative
  planners need."""
  import torch
  check(torch.get_float32_matmul_precision() == "highest"
        and not torch.backends.cuda.matmul.allow_tf32,
        f"{what}: float32 matmul precision "
        f"{torch.get_float32_matmul_precision()!r}, allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}")


class PhaseTimer:
  """A planner's timer (planners/base.py::PhaseMarks): a CUDA event and a
  host clock reading at the start of each plan and at the end of each of
  its phases."""

  def __init__(self):
    self.plans = []

  def start(self):
    self.plans.append([])
    self("start")

  def __call__(self, name: str):
    import torch
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    self.plans[-1].append((name, ev, time.perf_counter()))

  def split(self) -> dict:
    """{phase: (mean device ms, mean host enqueue ms)} over the plans."""
    import numpy as np
    import torch
    torch.cuda.synchronize()
    out = {}
    for plan in self.plans:
      for (_, e0, h0), (name, e1, h1) in zip(plan, plan[1:]):
        out.setdefault(name, []).append((e0.elapsed_time(e1),
                                         (h1 - h0) * 1e3))
    return {k: tuple(float(x) for x in np.mean(v, axis=0))
            for k, v in out.items()}


# what set_sync_debug_mode("warn") says at a host sync
SYNC_WARNING = "called a synchronizing CUDA operation"


def count_syncs(agent) -> dict:
  """Host syncs in one optimize of the agent's planner, counted as
  torch.cuda.set_sync_debug_mode("warn") warns them ("called a
  synchronizing CUDA operation"; the mode, PyTorch warns, does not yet
  detect every synchronizing operation): the count, the count in each of
  the planner's phases (its `timer` hook), and the source line each
  warning names."""
  import collections
  import warnings
  import torch
  torch.cuda.synchronize()
  marks = []
  # the mode is entered before the recording starts: only the plan's own
  # syncs are counted
  torch.cuda.set_sync_debug_mode("warn")
  try:
    with warnings.catch_warnings(record=True) as caught:
      warnings.simplefilter("always")

      def syncs():
        return sum(1 for w in caught if SYNC_WARNING in str(w.message))

      agent.planner.timer = lambda name: marks.append((name, syncs()))
      try:
        agent.planner.optimize(agent.task, agent.policy, agent.data,
                               agent.generator)
        count = syncs()
      finally:
        agent.planner.timer = None
  finally:
    torch.cuda.set_sync_debug_mode(0)
  torch.cuda.synchronize()
  phases, before = {}, 0
  for name, n in marks:
    phases[name], before = n - before, n
  where = collections.Counter(
      f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
      if SYNC_WARNING in str(w.message))
  return {"count": count, "by_phase": phases, "where": dict(where)}


def time_planner(name: str, dev, reps: int = 5, task: str = "Walker"):
  """D2/D3: Agent(task, planner=name) in float32 from reset("home"), one
  warm-up and `reps` timed planner_steps (each synchronized), with the
  kernel's launch count set to 0 before and read after, and the phases of
  iLQG and the gradient planner timed (PhaseTimer). Returns (the numbers,
  the agent)."""
  import numpy as np
  import torch
  from mujoco_mpc_torch.agent.agent import Agent
  agent = Agent(task, planner=name, device=dev)
  agent.reset("home")
  precision_check(f"{task} {name}")
  agent.planner_step()
  torch.cuda.synchronize()
  mega = agent.planner.mega
  if mega is not None:
    mega.launches = 0
  timer = None
  if name in ("ilqg", "gradient"):
    timer = agent.planner.timer = PhaseTimer()
  ms, best = [], []
  for _ in range(reps):
    t = time.perf_counter()
    if timer is not None:
      timer.start()
    info = agent.planner_step()
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t) * 1e3)
    best.append(float(info.best_return))
  agent.planner.timer = None
  precision_check(f"{task} {name}")
  launches = 0 if mega is None else mega.launches
  q = np.percentile(ms, [50, 66.7])
  cfg = agent.planner.config
  horizon = {"ilqs": lambda: cfg.ilqg.horizon,
             "robust": lambda: agent.planner.delegate.config.horizon}.get(
                 name, lambda: cfg.horizon)()
  out = {"ms": ms, "median_ms": float(q[0]), "p66_7_ms": float(q[1]),
         "launches": launches, "launches_per_plan": launches / reps,
         "best_return": best, "horizon": horizon}
  if timer is not None:
    out["phases"] = timer.split()
  policy = agent.policy.ilqg if name == "ilqs" else agent.policy
  if hasattr(policy, "gains"):  # a finding to report, with its state
    out["gains_finite"] = bool(torch.all(torch.isfinite(policy.gains)))
    if not out["gains_finite"]:
      print(f"[D] {task} {name}: non-finite float32 feedback gains, from "
            f"the state qpos {agent.data.qpos.tolist()}, qvel "
            f"{agent.data.qvel.tolist()} at t {float(agent.data.time)}")
  check(all(np.isfinite(best)), f"D {task} {name}: non-finite best return")
  check(launches == PLAN_LAUNCHES[name] * reps,
        f"D {task} {name}: {launches} kernel launches in {reps} plans, not "
        f"{PLAN_LAUNCHES[name]} a plan")
  return out, agent


def launch_split(agent) -> dict:
  """D2: a sampling-family Agent's kernel launches timed apart over
  LAUNCH_SPLIT_REPS planner_steps, each between CUDA events (sample-gradient's two a plan:
  its perturbations, then its line-search candidates), with each launch's
  candidates, geometry, bound and share of it."""
  import numpy as np
  import torch
  from mujoco_mpc_torch.tasks import registry
  mega = agent.planner.mega
  inner = mega.returns
  calls = []

  def timed(*args, **kw):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = inner(*args, **kw)
    end.record()
    calls.append((args[2].shape[0], start, end))
    return out

  mega.returns = timed
  try:
    for _ in range(LAUNCH_SPLIT_REPS):
      agent.planner_step()
  finally:
    del mega.returns
  torch.cuda.synchronize()
  per = len(calls) // LAUNCH_SPLIT_REPS
  ops = step_ops(registry.get_task(agent.task.name, device="cpu"))
  out = []
  for k in range(per):
    n = calls[k][0]
    ms = [s.elapsed_time(e) for _, s, e in calls[k::per]]
    b, by = bound(ops, n, mega.horizon, agent.task)
    out.append({"candidates": n, "ms": ms, "median_ms": float(np.median(ms)),
                "bound_ms": b, "bound_by": by,
                "share": b / float(np.median(ms)),
                "geometry": mega.geometry(n)})
  return {"launches_per_plan": per, "launches": out}


def print_phases(tag: str, what: str, res: dict) -> None:
  total = sum(v[0] for v in res["phases"].values())
  split = ", ".join(f"{k} {v[0]:.1f} ms (host {v[1]:.1f})"
                    for k, v in res["phases"].items())
  print(f"[{tag}] {what}: {res['median_ms']:.1f} ms an iteration (median "
        f"of {len(res['ms'])}, p66.7 {res['p66_7_ms']:.1f}); CUDA events "
        f"{total:.1f} ms: {split}")


def derivative_holds(dev, rec: dict) -> None:
  """The float64 holds of phases D1-D3, their CPU halves in the plain
  version's workers: D1's Jacobians, D2's first plans, D3's quick start's
  first 6 steps. Times nothing."""
  import numpy as np
  from mujoco_mpc_torch.ops import megarollout as MR
  r = rec["derivative"] = {"D1": {}, "D2": {}, "D3": {}}
  t0 = time.perf_counter()

  def stamp(what):
    timeline(f"D +{time.perf_counter() - t0:.1f} s: {what}")

  cpu_quick = PLAIN.submit(_quick_start_job, 6)
  cpu_plans = {name: PLAIN.submit(_first_plan_job, name)
               for name in PLANNERS}
  # ---- D1: the transition Jacobians on the card
  for name in ("Walker", "Humanoid Walk"):
    r["D1"][name] = jacobian_check(name, dev)
  stamp("D1's holds")
  # ---- D2: each planner's first float64 plan on the card against the CPU
  for name in PLANNERS:
    card = first_plan(name, dev)
    stamp(f"{name}'s first float64 plan on the card")
    cpu = cpu_plans[name].result()
    br_tol = PLAN_TOL["kernel" if cpu["kernel_scored"] else "general"]
    br = abs(card["best_return"] - cpu["best_return"]) / max(
        abs(cpu["best_return"]), 1e-300)
    gaps = {f: rel_to_max(card[f], cpu[f]) for f in cpu
            if isinstance(cpu[f], np.ndarray)}
    r["D2"][name] = {"first_plan": {
        "best_return": card["best_return"], "best_return_rel": br,
        "best_return_tol": br_tol, "gaps": gaps,
        "winner": (card["winner"], cpu["winner"]),
        "launches": card["launches"]}}
    print(f"[D2] Agent('Walker', '{name}') first plan, float64, card vs "
          f"CPU: best_return {card['best_return']:.10g} rel {br:.3g} (tol "
          f"{br_tol:g}, scored by the "
          f"{'kernel' if cpu['kernel_scored'] else 'general engine'}); "
          + ", ".join(f"{f} {g:.3g}" for f, g in gaps.items())
          + f" of the max (tol {PLAN_TOL['arrays']:g}); winner "
          f"{card['winner']} ({cpu['winner']} on the CPU, "
          f"{cpu['cpu_s']:.1f} s in its worker); kernel launches "
          f"{card['launches']}")
    check(card["winner"] == cpu["winner"] and br <= br_tol
          and all(g <= PLAN_TOL["arrays"] for g in gaps.values()),
          f"D2 {name}: the first plan on the card disagrees with the CPU's")
    check(card["launches"] == PLAN_LAUNCHES[name],
          f"D2 {name}: {card['launches']} kernel launches in one plan")
    if name in KERNEL_SCORED:
      # the same plan through the double kernel built without
      # multiply-add contraction (-fmad=false), as the plain version
      # rounds: both libraries within the general engine's hold
      with MR.double_kernels():
        plain_ops = first_plan(name, dev)
      bru = abs(plain_ops["best_return"] - cpu["best_return"]) / max(
          abs(cpu["best_return"]), 1e-300)
      gaps_u = {f: rel_to_max(plain_ops[f], cpu[f]) for f in cpu
                if isinstance(cpu[f], np.ndarray)}
      r["D2"][name]["first_plan"].update(
          uncontracted_best_return_rel=bru, uncontracted_gaps=gaps_u,
          uncontracted_winner=plain_ops["winner"])
      print(f"[D2] Agent('Walker', '{name}') first plan through the "
            f"uncontracted double kernel: best_return rel {bru:.3g} (tol "
            f"{PLAN_TOL['uncontracted']:g}), "
            + ", ".join(f"{f} {g:.3g}" for f, g in gaps_u.items())
            + f" of the max; winner {plain_ops['winner']}")
      check(plain_ops["winner"] == cpu["winner"]
            and bru <= PLAN_TOL["uncontracted"]
            and all(g <= PLAN_TOL["arrays"] for g in gaps_u.values()),
            f"D2 {name}: the uncontracted double kernel's first plan "
            f"disagrees with the CPU's")
  quick64 = quick_start(dev, 6)
  stamp("the quick start's 6 float64 steps on the card")
  quick64_cpu = cpu_quick.result()
  qgap = max(float(np.max(np.abs(quick64[k] - quick64_cpu[k])))
             for k in ("qpos", "qvel"))
  print(f"[D3] Agent('Cartpole') quick start ({quick64['planner']} planner),"
        f" 6 steps in float64, card vs CPU: max |qpos, qvel| gap "
        f"{qgap:.3g} (tol 1e-6; {quick64_cpu['cpu_s']:.1f} s in its worker)")
  check(quick64["planner"] == "gradient" and qgap <= 1e-6,
        "D3: the Cartpole quick start on the card disagrees with the CPU's")
  r["D3"]["quick_start_f64_gap"] = qgap


def run_derivative(dev, rec: dict) -> None:
  """Phases D1-D3's timings (derivative_holds held their float64 plans),
  on a quiet host (the workers are done); the profiler runs last."""
  import numpy as np
  import torch
  from mujoco_mpc_torch.agent.agent import Agent
  r = rec["derivative"]
  t0 = time.perf_counter()

  def stamp(what):
    timeline(f"D +{time.perf_counter() - t0:.1f} s: {what}")

  # ---- D2: float32 timings
  agents = {}
  for name in PLANNERS:
    res, agents[name] = time_planner(name, dev, reps=PLAN_REPS.get(name, 5))
    r["D2"][name].update(res)
    print(f"[D2] Agent('Walker', '{name}') float32, horizon "
          f"{res['horizon']}: planner_step median {res['median_ms']:.1f} ms, "
          f"p66.7 {res['p66_7_ms']:.1f} ms (n={len(res['ms'])}, each "
          f"synchronized); "
          f"kernel launches {res['launches_per_plan']:g} a plan")
  split = r["D2"]["sample_gradient"]["launch_split"] = launch_split(
      agents["sample_gradient"])
  for k, x in enumerate(split["launches"]):
    print(f"[D2] sample_gradient launch {k + 1} of "
          f"{split['launches_per_plan']} a plan: {x['candidates']} "
          f"candidates x {agents['sample_gradient'].planner.mega.horizon}, "
          f"median {x['median_ms']:.3f} ms (CUDA events, n="
          f"{LAUNCH_SPLIT_REPS}), bound "
          f"{x['bound_ms']:.4f} ms ({x['bound_by']}), "
          f"{100 * x['share']:.4f} % of it; geometry {x['geometry']}")
  stamp("D2's timings")
  # the host syncs of one optimize each; the gradient planner's peak
  # memory over its optimize
  for name in ("ilqg", "gradient"):
    a = agents[name]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    syncs = r["D2"][name]["syncs"] = count_syncs(a)
    peak = r["D2"][name]["peak_bytes"] = (
        torch.cuda.max_memory_allocated() - base)
    print(f"[D2] one {type(a.planner).__name__}.optimize under "
          f"set_sync_debug_mode('warn'): {syncs['count']} host syncs "
          f"(by phase {syncs['by_phase']}, warned at {syncs['where']})"
          + f"; peak memory {peak / 2 ** 20:.1f} MiB above the "
          f"{base / 2 ** 20:.1f} MiB resident"
          + (" (activations kept, no checkpointing)"
             if name == "gradient" else ""))
  stamp("the syncs")
  # ---- D3: the derivative rates
  print_phases("D3", "iLQG Walker, horizon 80", r["D2"]["ilqg"])
  print_phases("D3", "gradient Walker, horizon 80", r["D2"]["gradient"])
  res, hagent = time_planner("ilqg", dev, reps=D3_HUMANOID_REPS,
                             task="Humanoid Walk")
  stamp("iLQG on Humanoid Walk")
  r["D3"]["ilqg_humanoid"] = res
  print_phases("D3", f"iLQG Humanoid Walk, horizon {res['horizon']} at dt "
               f"{float(hagent.task.model.opt.timestep):g}", res)
  # D1's Jacobian call over the whole horizon, float32
  jac_calls = {}
  for name, a in (("Walker", agents["ilqg"]), ("Humanoid Walk", hagent)):
    pl, task, d = a.planner, a.task, a.data
    T = pl.config.horizon
    xs, us = a.policy.xs, a.policy.us
    ts = d.time + task.model.opt.timestep * torch.arange(
        T, dtype=d.qpos.dtype, device=dev)
    jac_calls[name] = lambda pl=pl, task=task, d=d, xs=xs, us=us, ts=ts: (
        pl.jacobians(task, d, xs, us, ts))
    jac_calls[name]()
    ms = timed_cuda(jac_calls[name], 3)
    r["D1"][name]["jacobian_ms"] = ms
    r["D1"][name]["horizon"] = T
    print(f"[D1] {name}: one Jacobian call over the horizon ({T} steps, "
          f"{T * (2 * task.model.nv + task.model.nu)} states, float32) "
          f"{ms:.1f} ms (CUDA events over 3)")
  stamp("the Jacobian calls")
  # the quick start: Agent("Cartpole"), its default planner, float32
  agent = Agent("Cartpole", device=dev)
  check(agent.planner_name == "gradient",
        f"D3: Agent('Cartpole') plans with {agent.planner_name}")
  agent.reset("home")
  plan_ms, step_ms, start = [], [], time.perf_counter()
  steps = 0
  while steps < QUICK_START_STEPS or (
      time.perf_counter() - start < QUICK_START_S):
    t = time.perf_counter()
    agent.planner_step()
    torch.cuda.synchronize()
    plan_ms.append((time.perf_counter() - t) * 1e3)
    for _ in range(2):
      t = time.perf_counter()
      agent.step()
      torch.cuda.synchronize()
      step_ms.append((time.perf_counter() - t) * 1e3)
      steps += 1
  q = agent.data.qpos.cpu().numpy()
  cost = agent.total_cost()
  qs = r["D3"]["quick_start"] = {
      "steps": steps, "plans": len(plan_ms),
      "ms_per_plan": float(np.mean(plan_ms)),
      "ms_per_step": float(np.mean(step_ms)),
      "cart_position": float(q[0]), "pole_angle": float(q[1]),
      "cost": cost, "sim_time": float(agent.data.time)}
  print(f"[D3] Agent('Cartpole') quick start, {agent.planner_name} planner "
        f"(horizon {agent.planner.config.horizon}), a plan every 2 steps: "
        f"{steps} steps ({qs['sim_time']:.2f} s) in "
        f"{time.perf_counter() - start:.1f} s; {qs['ms_per_plan']:.1f} ms a "
        f"plan, {qs['ms_per_step']:.1f} ms an Agent.step; cart at "
        f"{qs['cart_position']:.4f}, pole angle {qs['pole_angle']:.4f}, "
        f"cost {cost:.4f}")
  check(np.all(np.isfinite(q)) and np.isfinite(cost),
        "D3: the Cartpole quick start went non-finite")
  stamp("the quick start")
  # ---- the profiler runs: the Jacobian call's launches, the busy shares
  for name, fn in jac_calls.items():
    prof = profile_launches(fn)
    r["D1"][name].update(prof)
    print(f"[D1] {name}: one Jacobian call over the horizon launches "
          f"{prof['launch_calls']} CUDA kernels ({prof['device_events']} "
          f"device events in torch.profiler)")
  for key, a in (("ilqg_walker", agents["ilqg"]), ("ilqg_humanoid", hagent),
                 ("gradient_walker", agents["gradient"])):
    b = r["D3"].setdefault("busy", {})[key] = busy_share(
        a, steps=1, warm=False, host_ops=False)
    share = ("not measured (no device events)" if b["busy_share"] is None
             else f"{100 * b['busy_share']:.2f} %")
    print(f"[D3] {key}: one planner_step under torch.profiler, wall "
          f"{b['wall_ms']:.1f} ms, busy {b['busy_ms']:.1f} ms: busy share "
          f"{share}")
  stamp("the profiler runs")


# ---------------------------------------------------------------------------
# E: the estimators, the direct optimizer and the estimate-driven loop
# ---------------------------------------------------------------------------

# the four registered estimators and the direct optimizer
ESTIMATOR_NAMES = ("ground_truth", "kalman", "unscented", "batch", "direct")
# (case, model, estimators, window, timed): E1 on Cartpole's simulation
# model, every estimator, Batch's and Direct's window Batch's default (16);
# Cartpole measures only USER slots (C = 0, a gain of 0), so E1 also holds,
# untimed, the measurement updates on the pendulum with sensors
# (estimators/sensor_model.py): Kalman, Unscented, and Direct identifying
# the pivot's damping ("direct_damping"); E2 at full width on Humanoid
# Walk's (nv 27, nt 54, a free joint, contacts), the windows
# MAX_FILTER_HISTORY (64); Batch and Direct take 3 Gauss-Newton iterations
E_CASES = (("E1", "Cartpole", ESTIMATOR_NAMES, 16, True),
           ("E1", "Pendulum", ("kalman", "unscented", "direct_damping"), 16,
            False),
           ("E2", "Humanoid Walk", ("kalman", "unscented", "batch",
                                    "direct"), 64, True))
E_ITERATIONS = 3
# a float64 update on the card against the CPU's: |card - cpu| <= atol +
# rtol |cpu| in every entry
E_TOL = {"atol": 1e-10, "rtol": 1e-8}
# the timed float32 updates of each estimator (10 until a full run took
# 1,250 s on a slow host)
E_REPS = 3
# E3: the steps of the estimate-driven loop (a plan every 2 from the
# estimate), the seconds of the asynchronous loops beside step(), and the
# bound on the estimate's distance from the sim state (the filter and the
# sim take the same float32 steps)
E3_STEPS, E3_ASYNC_S, E3_ERROR_TOL = 50, 5.0, 1e-4


def estimator_model(task: str, dtype, device):
  """E's model: a registered task's simulation model, or the pendulum."""
  from mujoco_mpc_torch.estimators import sensor_model
  from mujoco_mpc_torch.tasks import registry
  if task == "Pendulum":
    return sensor_model.load(dtype, device)
  return registry.get_task(task, dtype=dtype, device=device).model


def estimator_inputs(task: str, window: int) -> dict:
  """E's inputs (numpy, float64, made on the CPU from seed 0): window + 1
  states of the model from its home keyframe (the pendulum from 0.3 rad)
  under random controls inside the control range, their sensordata with
  noise (sigma 1e-3) and the window's configurations displaced by tangent
  noise (sigma 1e-3), the direct optimizer's start."""
  import numpy as np
  import torch
  from mujoco_mpc_torch.estimators import base
  from mujoco_mpc_torch.physics import io as phys_io
  from mujoco_mpc_torch.physics import step as S
  m = estimator_model(task, torch.float64, "cpu")
  rng = np.random.RandomState(0)
  q0 = (m.qpos0 + 0.3 if task == "Pendulum" else
        torch.tensor(m.keyframe("home")[0], dtype=torch.float64))
  d = phys_io.make_data(m).replace(
      qpos=q0, qvel=torch.tensor(rng.normal(0, 0.05, m.nv)))
  lo, hi = (m.actuator_ctrlrange[:, k].numpy() for k in (0, 1))
  out = {k: [] for k in ("qpos", "qvel", "ctrl", "sensor")}
  with torch.inference_mode():
    for _ in range(window + 1):
      u = lo + (hi - lo) * rng.uniform(0.1, 0.9, m.nu)
      d = S.step(m, d.replace(ctrl=torch.tensor(u)))
      out["qpos"].append(d.qpos.numpy())
      out["qvel"].append(d.qvel.numpy())
      out["ctrl"].append(u)
      out["sensor"].append(S.forward(m, d).sensordata.numpy() +
                           rng.normal(0, 1e-3, m.nsensordata))
    out = {k: np.asarray(v) for k, v in out.items()}
    out["qpos_noisy"] = base.retract(
        m, torch.tensor(out["qpos"][:window]),
        torch.tensor(rng.normal(0, 1e-3, (window, m.nv)))).numpy()
  return out


def estimator_call(task: str, name: str, window: int, inputs: dict, device,
                   dtype):
  """(the estimator, its start state, one update: state -> the next one)
  of `name` on `task`'s model in `dtype` on `device`, measuring its
  measurement_slice: a filter starts from the window's last state and
  takes the next control and sensordata; Batch from the window (the noisy
  configurations, the measurements and controls) and the same; Direct
  optimizes the window from the noisy configurations, direct_damping
  with the first DoF's damping as a parameter (from twice its value, its
  prior the value, weighing 1e-2)."""
  import torch
  from mujoco_mpc_torch.estimators import (BatchState, Direct, DirectConfig,
                                           base, get_estimator)
  from mujoco_mpc_torch.estimators.direct import dof_damping_parameter
  from mujoco_mpc_torch.physics import io as phys_io
  m = estimator_model(task, dtype, device)
  start, dim = base.measurement_slice(m)
  x = {k: torch.tensor(v, dtype=dtype, device=device)
       for k, v in inputs.items()}
  w = window
  sensors = x["sensor"][:, start:start + dim]
  if name in ("direct", "direct_damping"):
    damping = float(m.dof_damping[0])
    params = ([dof_damping_parameter([0], prior=[damping],
                                     prior_weight=1e-2)]
              if name == "direct_damping" else [])
    theta0 = (torch.tensor([2.0 * damping], dtype=dtype, device=device)
              if params else None)
    est = Direct(m, DirectConfig(horizon=w, max_iterations=E_ITERATIONS),
                 sensor_start=start, nsensordata=dim, parameters=params)
    return est, None, lambda s: est.optimize(
        x["qpos_noisy"], sensors[:w], x["ctrl"][:w], params_init=theta0)
  kw = ({"window": w, "max_iterations": E_ITERATIONS} if name == "batch"
        else {})
  est = get_estimator(name, m, sensor_start=start, nsensordata=dim, **kw)
  if name == "batch":
    state0 = BatchState(qpos=x["qpos_noisy"], sensors=sensors[:w],
                        ctrls=x["ctrl"][:w],
                        time=torch.zeros((), dtype=dtype, device=device))
  else:
    state0 = est.init(phys_io.make_data(m).replace(
        qpos=x["qpos"][w - 1].clone(), qvel=x["qvel"][w - 1].clone()))
  return est, state0, lambda s: est.update(s, x["ctrl"][w], x["sensor"][w])


def estimator_result(name: str, est, out) -> dict:
  """What E holds of an update's result (numpy): a filter's state and
  covariance, Batch's window, Direct's configurations, costs and
  parameters."""
  if name.startswith("direct"):
    res = {"qpos": out.qpos, "cost": out.cost,
           "cost_initial": out.cost_initial}
    if out.parameters is not None:
      res["parameters"] = out.parameters
  else:
    res = dict(zip(("qpos", "qvel"), est.state(out)[:2]))
    for f in ("cov", "time"):
      if hasattr(out, f):
        res[f] = getattr(out, f)
    if name == "batch":
      res["window"] = out.qpos
  return {k: v.detach().cpu().numpy() for k, v in res.items()}


def _estimator_job(task: str, name: str, window: int) -> dict:
  """In a worker: E's inputs (estimator_inputs, deterministic) and one
  float64 update on the CPU from them, with its seconds."""
  import torch
  t = time.perf_counter()
  inputs = estimator_inputs(task, window)
  est, state0, call = estimator_call(task, name, window, inputs, "cpu",
                                     torch.float64)
  # no_grad, not inference_mode: forward-mode AD needs its tangents
  with torch.no_grad():
    out = estimator_result(name, est, call(state0))
  return {"inputs": inputs, "result": out, "cpu_s": time.perf_counter() - t}


def submit_estimator_holds() -> dict:
  """E1's and E2's float64 updates on the CPU, submitted to the plain
  version's workers (E2's Batch and Direct at window 64 take minutes
  there): {(case, task, name): (window, timed, future)}."""
  return {(case, task, name): (window, timed,
                               PLAIN.submit(_estimator_job, task, name,
                                            window))
          for case, task, names, window, timed in E_CASES for name in names}


def estimator_holds(dev, rec: dict, jobs: dict) -> None:
  """E1 and E2's holds: each estimator's first float64 update on the card
  against the CPU's, within E_TOL in every entry; where E1 times nothing
  (the pendulum), the held update is the second, under
  set_sync_debug_mode("error"). Times nothing."""
  import numpy as np
  import torch
  r = rec.setdefault("estimation", {})
  for (case, task, name), (window, timed, future) in jobs.items():
    cpu = future.result()
    est, state0, call = estimator_call(task, name, window, cpu["inputs"],
                                       dev, torch.float64)
    with torch.no_grad():
      if not timed:
        call(state0)  # builds the model's constants
      with (contextlib.nullcontext() if timed
            else no_sync(f"{case} {task} {name}")):
        out = call(state0)
      card = estimator_result(name, est, out)
    worst, ratio_ = {}, 0.0
    for k, want in cpu["result"].items():
      gap = np.abs(card[k] - want)
      worst[k] = float(np.max(gap)) if gap.size else 0.0
      if gap.size:
        ratio_ = max(ratio_, float(np.max(
            gap / (E_TOL["atol"] + E_TOL["rtol"] * np.abs(want)))))
    finite = all(np.all(np.isfinite(v)) for v in card.values())
    r.setdefault(case, {}).setdefault(task, {})[name] = {
        "card_vs_cpu": worst, "over_tol": ratio_, "cpu_s": cpu["cpu_s"],
        "no_sync": not timed}
    extra = "" if timed else ", no host sync in it"
    if "parameters" in card:
      extra += (f"; the damping identified {card['parameters'][0]:.6g} "
                f"(from {2 * float(est.model.dof_damping[0]):g})")
    print(f"[{case}] {task} {name} (window {window}): the "
          f"{'first' if timed else 'second'} float64 update, card vs CPU, "
          "max |gap| " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f"; worst gap over its tolerance (atol {E_TOL['atol']:g} + "
          f"rtol {E_TOL['rtol']:g} |cpu|) {ratio_:.3g}; "
          f"{cpu['cpu_s']:.1f} s in its CPU worker{extra}")
    check(finite and ratio_ <= 1.0, f"{case} {task} {name}: the float64 "
          f"update on the card disagrees with the CPU's")


def time_estimator(case: str, task: str, name: str, window: int,
                   inputs: dict, dev) -> dict:
  """E1/E2's float32 numbers of one estimator on the card: a warm-up
  update, then E_REPS updates (each synchronized; a filter's state carried
  from one to the next; the first under set_sync_debug_mode("error"); the
  direct optimizer's phases between CUDA events); then one more update
  under torch.profiler, its CUDA kernels and the device's busy share."""
  import numpy as np
  import torch
  est, state, call = estimator_call(task, name, window, inputs, dev,
                                    torch.float32)
  out = call(state)  # builds the model's constants
  state = state if name == "direct" else out
  torch.cuda.synchronize()
  # the direct optimizer's phases (Batch's own), between CUDA events
  direct = {"batch": lambda: est.direct, "direct": lambda: est}.get(
      name, lambda: None)()
  timer = None if direct is None else PhaseTimer()
  ms = []
  for k in range(E_REPS):
    t = time.perf_counter()
    if timer is not None:
      direct.timer = timer
      timer.start()
    # the first timed update raises at a host sync
    with (no_sync(f"{case} {task} {name}") if k == 0
          else contextlib.nullcontext()):
      out = call(state)
    state = state if name == "direct" else out
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t) * 1e3)
  if direct is not None:
    direct.timer = None
  finite = all(np.all(np.isfinite(v)) for v in estimator_result(
      name, est, out).values())
  prof = device_busy(lambda: call(state), 1)
  q = np.percentile(ms, [50, 66.7])
  res = {"ms": ms, "median_ms": float(q[0]), "p66_7_ms": float(q[1]),
         "launches": prof["kernels"], **prof, "float32_finite": finite}
  share = ("not measured (no device events)" if prof["busy_share"] is None
           else f"{100 * prof['busy_share']:.2f} %")
  if timer is not None:
    res["phases"] = timer.split()
  print(f"[{case}] {task} {name} (window {window}) float32: median "
        f"{res['median_ms']:.3f} ms an update, p66.7 {res['p66_7_ms']:.3f} "
        f"(n={E_REPS}, each synchronized); no host sync "
        f"(set_sync_debug_mode('error')); one more update under "
        f"torch.profiler: {res['launches']} CUDA kernels, busy {share}"
        + ("" if timer is None else "; the optimizer's phases, mean ms "
           "(device, host enqueue) an occurrence: " + ", ".join(
               f"{k} {v[0]:.1f} ({v[1]:.1f})"
               for k, v in res["phases"].items())))
  check(finite, f"{case} {task} {name}: a non-finite float32 update")
  return res


def estimate_loop(dev, rec: dict) -> dict:
  """E3: Agent("Cartpole", planner="sampling") with a Kalman filter
  attached at an offset state, a planner_step(from_estimate=True) every 2
  steps for E3_STEPS steps (the estimate's max error against the sim
  state; the kernel's launches, one a plan), then start_estimation() and
  start_planning() beside step() for E3_ASYNC_S seconds (estimator updates
  and plans a second, the policy's age in steps)."""
  import numpy as np
  import torch
  from mujoco_mpc_torch.agent.agent import Agent
  agent = Agent("Cartpole", planner="sampling", device=dev)
  agent.set_state(qpos=[0.2, 0.3])
  agent.attach_estimator("kalman")
  mega = agent.planner.mega
  mega.launches = 0
  err, plan_ms, step_ms, plans = 0.0, [], [], 0
  for i in range(E3_STEPS):
    if i % 2 == 0:
      t = time.perf_counter()
      agent.planner_step(from_estimate=True)
      torch.cuda.synchronize()
      plan_ms.append((time.perf_counter() - t) * 1e3)
      plans += 1
    t = time.perf_counter()
    agent.step()  # the Kalman update inline
    torch.cuda.synchronize()
    step_ms.append((time.perf_counter() - t) * 1e3)
    est, sim = agent.estimated_state(), agent.get_state()
    err = max(err, float(np.max(np.abs(est["qpos"] - sim["qpos"]))),
              float(np.max(np.abs(est["qvel"] - sim["qvel"]))))
  launches = mega.launches
  out = {"steps": E3_STEPS, "plans": plans, "launches": launches,
         "launches_per_plan": launches / plans, "max_estimate_error": err,
         "ms_per_step": float(np.mean(step_ms)),
         "plan_ms": plan_ms, "ms_per_plan": float(np.mean(plan_ms)),
         "cart": float(agent.data.qpos[0]), "pole": float(agent.data.qpos[1]),
         "cost": agent.total_cost()}
  print(f"[E3] Agent('Cartpole', 'sampling') with a Kalman filter from "
        f"qpos [0.2, 0.3]: {E3_STEPS} steps, a planner_step(from_estimate="
        f"True) every 2: the estimate at most {err:.3g} from the sim state "
        f"(qpos, qvel; bound {E3_ERROR_TOL:g}); {out['ms_per_step']:.3f} "
        f"ms an Agent.step with its "
        f"inline update, {out['ms_per_plan']:.3f} ms a plan (each "
        f"synchronized); kernel launches {launches} in {plans} plans; cart "
        f"{out['cart']:.4f}, pole {out['pole']:.4f}, cost {out['cost']:.4f}")
  check(launches == plans, f"E3: {launches} kernel launches in {plans} "
        "plans from the estimate")
  check(err <= E3_ERROR_TOL and np.isfinite(out["cost"]),
        f"E3: the estimate {err:.3g} from the sim state (bound "
        f"{E3_ERROR_TOL:g}), or a non-finite cost")
  # the estimation and plan threads beside step()
  calls = []
  inner = agent.planner.optimize

  def counted(*args, **kw):
    calls.append(1)
    return inner(*args, **kw)

  agent.planner.optimize = counted
  u0, l0 = agent.estimator_updates, mega.launches
  ages, steps, t = [], 0, time.perf_counter()
  try:
    agent.start_estimation()
    agent.start_planning()  # one plan before its thread starts
    t_loop = time.perf_counter()
    while time.perf_counter() - t_loop < E3_ASYNC_S:
      agent.step()
      steps += 1
      ages.append(agent._data_version - agent.plan_version)
  finally:
    agent.stop_planning()
    agent.stop_estimation()
    del agent.planner.optimize
  torch.cuda.synchronize()
  wall = time.perf_counter() - t
  updates, plans = agent.estimator_updates - u0, len(calls)
  launches = mega.launches - l0
  est = agent.estimated_state()
  out["async"] = {
      "seconds": wall, "steps_per_s": steps / wall,
      "estimator_updates_per_s": updates / wall, "plans_per_s": plans / wall,
      "policy_age_steps_mean": float(np.mean(ages)),
      "policy_age_steps_max": int(np.max(ages)), "launches": launches,
      "plans": plans}
  a = out["async"]
  print(f"[E3] start_estimation() and start_planning() beside step() for "
        f"{wall:.2f} s: {a['steps_per_s']:.1f} steps/s, "
        f"{a['estimator_updates_per_s']:.1f} estimator updates/s, "
        f"{a['plans_per_s']:.1f} plans/s (kernel launches {launches} in "
        f"{plans} plans); the policy's age at a step: mean "
        f"{a['policy_age_steps_mean']:.2f}, max {a['policy_age_steps_max']} "
        f"steps")
  check(updates > 0 and plans > 0 and np.all(np.isfinite(est["qpos"])),
        "E3: the estimation and plan threads made no progress")
  check(launches == plans, f"E3: {launches} kernel launches in the "
        f"{plans} plans of the async window")
  return out


def run_estimation(dev, rec: dict, jobs: dict) -> None:
  """E1-E3's timings on a quiet host (the holds ran beside the plain
  version's runs): each timed estimator's float32 updates, then the
  closed loop."""
  r = rec.setdefault("estimation", {})
  precision_check("E")
  for (case, task, name), (window, timed, future) in jobs.items():
    if timed:
      r[case][task][name].update(time_estimator(
          case, task, name, window, future.result()["inputs"], dev))
  precision_check("E")
  r["E3"] = estimate_loop(dev, rec)


# ---------------------------------------------------------------------------
# M: the mesh and heightfield pairs, with Bimanual Insert and Quadruped
# Hill on the general route
# ---------------------------------------------------------------------------

# M's float64 step holds: probe states of each task (tests/
# torch_mesh_cases.py), every new pair kind carrying force in one of them
# at least; the closed loops' Agent.steps (a planner_step every 2)
MESH_STATES, MESH_LOOP_STEPS = 16, 6


def mesh_step_hold(name: str, dev, card: str) -> dict:
  """M: one general float64 step of MESH_STATES probe states on the card
  against the CPU (G1's bound: qpos and qvel 1e-10; each pair kind's
  contact forces summed over its points, 1e-8 of their largest), the
  active points of each pair kind; then one state's float32 step: ms
  (CUDA events over 20 steps) and launches (torch.profiler)."""
  import numpy as np
  import torch
  from mujoco_mpc_torch.ops import rollout as R
  from mujoco_mpc_torch.physics import io as phys_io
  from mujoco_mpc_torch.physics import step as S
  from mujoco_mpc_torch.tasks import registry
  from tests import torch_mesh_cases as mc
  host = registry.get_task(name, dtype=torch.float64, device="cpu").model
  states = mc.probe_states(name, host, MESH_STATES)
  out = {}
  for key, device in (("card", dev), ("cpu", "cpu")):
    m = registry.get_task(name, dtype=torch.float64, device=device).model
    d = R.broadcast(phys_io.make_data(m), (MESH_STATES,)).replace(**{
        k: torch.tensor(v, dtype=torch.float64, device=device)
        for k, v in states.items()})
    out[key] = S.step(m, d)
  torch.cuda.synchronize()
  on_card, on_cpu = out["card"], out["cpu"]
  err = {f: float((getattr(on_card, f).cpu() - getattr(on_cpu, f)).abs()
                  .max()) for f in ("qpos", "qvel")}
  fc, fh = mc.force_by_kind(host, on_card.contact), mc.force_by_kind(
      host, on_cpu.contact)
  kind_err = {k: float(np.abs(fc[k].sum(-2) - fh[k].sum(-2)).max()
                       / max(float(np.abs(fh[k]).max()), 1e-300))
              for k in fh if np.abs(fh[k]).max() > 0}
  active = {k: int(np.count_nonzero(np.abs(f).sum(-1))) for k, f in fh.items()}
  kinds = mc.active_kinds(host, on_cpu)
  print(f"[M] {name}, {MESH_STATES} probe states: general step card vs CPU "
        f"(float64) qpos {err['qpos']:.3g}, qvel {err['qvel']:.3g} (tol "
        f"1e-10); per pair kind |sum card - sum CPU| over its largest force "
        f"{ {k: float(f'{v:.3g}') for k, v in kind_err.items()} } (tol 1e-8);"
        f" active points per pair kind (all states) {active}")
  check(err["qpos"] <= 1e-10 and err["qvel"] <= 1e-10
        and all(v <= 1e-8 for v in kind_err.values()),
        f"M {name}: the general step on the card is {err}, {kind_err} from "
        "the CPU's in float64")
  check(kinds == mc.NEW_KINDS[name], f"M {name}: the new pair kinds "
        f"{sorted(mc.NEW_KINDS[name])} carry force in {sorted(kinds)} only")
  m = registry.get_task(name, device=dev).model
  d1 = phys_io.make_data(m).replace(**{
      k: torch.tensor(v[0], dtype=torch.float32, device=dev)
      for k, v in states.items()})
  S.step(m, d1)  # builds the model's constants
  ms = timed_cuda(lambda: S.step(m, d1), 20)
  launches = profile_launches(lambda: S.step(m, d1))
  print(f"[M] {name}: one state's general step (float32) {ms:.3f} ms (CUDA "
        f"events over 20 steps; {card}), {launches['launch_calls']} launches "
        f"({launches['device_events']} device kernels; torch.profiler)")
  return {"card_vs_cpu": err, "kind_err": kind_err, "active": active,
          "ms_per_step": ms, "launches_per_step": launches}


def far_edge_step(dev) -> dict:
  """M: one float32 step of Quadruped Hill with its feet over the field's
  far corner and beyond (tests/torch_mesh_cases.py::far_edge_state): the
  clip bound rounds to the last grid line there and the neighbour's index
  is clamped; it must run on the card (no device assert) and equal the
  CPU's (qpos 1e-5, qvel 1e-3, as the float32 steps elsewhere)."""
  import torch
  from mujoco_mpc_torch.physics import io as phys_io
  from mujoco_mpc_torch.physics import step as S
  from mujoco_mpc_torch.tasks import registry
  from tests import torch_mesh_cases as mc
  out = {}
  for key, device in (("card", dev), ("cpu", "cpu")):
    m = registry.get_task("Quadruped Hill", device=device).model
    st = mc.far_edge_state(m)
    d = phys_io.make_data(m).replace(**{
        k: torch.tensor(v[0], dtype=torch.float32, device=device)
        for k, v in st.items()})
    out[key] = S.step(m, d)
  torch.cuda.synchronize()
  err = {f: float((getattr(out["card"], f).cpu()
                   - getattr(out["cpu"], f)).abs().max())
         for f in ("qpos", "qvel")}
  print(f"[M] Quadruped Hill over the field's far corner (float32): the "
        f"step ran on the card; card vs CPU qpos {err['qpos']:.3g} (tol "
        f"1e-5), qvel {err['qvel']:.3g} (tol 1e-3)")
  check(err["qpos"] <= 1e-5 and err["qvel"] <= 1e-3
        and bool(torch.all(torch.isfinite(out["card"].qvel))),
        f"M: the far-edge step on the card is {err} from the CPU's")
  return err


def mesh_holds(dev, rec: dict) -> None:
  """Phase M's holds, which time nothing: the float64 steps, a step with
  no host sync (G1's), the first float64 plans on the general route
  (G4_CANDIDATES candidates, card against the CPU's in a worker:
  best_return rel 1e-8, the same winner, the policy's values within 1e-6
  of their max), and the far-edge float32 step."""
  from tests import torch_mesh_cases as mc
  g = rec.setdefault("mesh", {})
  cpu = {name: PLAIN.submit(_first_general_plan_job, name)
         for name in mc.NEW_KINDS}
  for name in mc.NEW_KINDS:
    g[name] = {"step": mesh_step_hold(name, dev, rec["card"])}
    no_sync_step(name, dev)
  g["far_edge"] = far_edge_step(dev)
  for name in mc.NEW_KINDS:
    card = first_general_plan(name, dev)
    ref = cpu[name].result()
    br = abs(card["best_return"] - ref["best_return"]) / max(
        abs(ref["best_return"]), 1e-300)
    gap = rel_to_max(card["values"], ref["values"])
    g[name]["first_plan"] = {"best_return": card["best_return"],
                             "best_return_rel": br, "values_gap": gap,
                             "winner": (card["winner"], ref["winner"]),
                             "cpu_s": ref["cpu_s"]}
    print(f"[M] {name}: first float64 plan, {G4_CANDIDATES} candidates on "
          f"the general route, card vs CPU: best_return "
          f"{card['best_return']:.10g} rel {br:.3g} (tol 1e-8), values "
          f"{gap:.3g} of the max (tol 1e-6), winner {card['winner']} "
          f"({ref['winner']} on the CPU, {ref['cpu_s']:.1f} s in its "
          f"worker)")
    check(card["winner"] == ref["winner"] and br <= 1e-8 and gap <= 1e-6,
          f"M {name}: the first plan on the card disagrees with the CPU's")


def run_mesh_loops(dev, rec: dict) -> None:
  """Phase M's times: each task's closed loop at its Agent's default
  shape (flat_loop, MESH_LOOP_STEPS steps, a planner_step every 2: the
  transition on the card, no kernel launch on the general route); its ms
  per plan the median of the plans after the first."""
  import numpy as np
  from tests import torch_mesh_cases as mc
  for name in mc.NEW_KINDS:
    loop = flat_loop(name, dev, MESH_LOOP_STEPS)
    loop["ms_per_plan_warm_median"] = float(np.median(loop["plan_ms"][1:]))
    rec["mesh"][name]["loop"] = loop
    print(f"[M] {name}: float32 plan at the Agent's default shape "
          f"{loop['shape'][0]}x{loop['shape'][1]}, median of "
          f"{len(loop['plan_ms']) - 1} after the first: "
          f"{loop['ms_per_plan_warm_median']:.3f} ms ({rec['card']})")


# ---------------------------------------------------------------------------
# S: the agent's serving edge: the gRPC services on the card
# ---------------------------------------------------------------------------

# S's timed RPCs, and Step calls while the server plans
S_REPS, S_ASYNC_STEPS = 5, 5


def _same(what: str, got, want) -> None:
  import numpy as np
  check(np.array_equal(np.asarray(got), np.asarray(want)),
        f"S: {what}: the response {got} differs from the direct call's "
        f"{want}")


def serving_edge(dev, rec: dict) -> None:
  """Phase S: the port's agent server in this process on a localhost port,
  its Agent on the card, and the port's AgentClient against it on the
  Walker: GetAction against servicer.agent.action() from the same state,
  bitwise; one PlannerStep launches the kernel once (the launch counter);
  the median ms of S_REPS PlannerStep RPCs beside S_REPS direct
  planner_step calls (each ending in the returned best_return, as the RPC
  does); StartPlanning, S_ASYNC_STEPS Steps, StopPlanning. Then the
  estimation and direct services on Cartpole on the card, each response
  against the port's Kalman and Direct called on the same inputs."""
  import numpy as np
  import torch
  from mujoco_mpc_torch.estimators import base as est_base
  from mujoco_mpc_torch.estimators import get_estimator
  from mujoco_mpc_torch.estimators.direct import Direct, DirectConfig
  from mujoco_mpc_torch.service import agent_service
  from mujoco_mpc_torch.service import client as sclient
  from mujoco_mpc_torch.service.direct_service import DirectClient
  from mujoco_mpc_torch.service.filter_service import FilterClient
  from mujoco_mpc_torch.tasks import registry
  out = rec["serving"] = {}
  servicer = agent_service.AgentServicer(device=dev)
  server, port = agent_service.make_server(0, max_workers=1,
                                           servicer=servicer)
  try:
    t = time.perf_counter()
    c = sclient.AgentClient("Walker", port=port)
    out["init_s"] = time.perf_counter() - t
    a = servicer.agent
    home = a.task.model.keyframe("home")[0]
    c.set_state(qpos=home)
    mega = a.planner.mega
    mega.launches = 0
    best = c.planner_step()
    out["planner_step_launches"] = mega.launches
    check(mega.launches == 1, f"S: a PlannerStep launched the kernel "
          f"{mega.launches} times")
    check(np.isfinite(best), "S: PlannerStep's best_return")
    _same("GetAction", c.get_action(), a.action())
    _same("GetState", c.get_state()["qpos"], a.get_state()["qpos"])
    rpc_ms, direct_ms = [], []
    for _ in range(S_REPS):
      t = time.perf_counter()
      c.planner_step()
      rpc_ms.append((time.perf_counter() - t) * 1e3)
      t = time.perf_counter()
      float(a.planner_step().best_return)
      direct_ms.append((time.perf_counter() - t) * 1e3)
    out.update(rpc_ms=rpc_ms, direct_ms=direct_ms,
               rpc_ms_median=float(np.median(rpc_ms)),
               direct_ms_median=float(np.median(direct_ms)))
    launches0, time0 = mega.launches, c.get_state()["time"]
    c.start_planning()
    for _ in range(S_ASYNC_STEPS):
      c.step()
    c.stop_planning()
    out["async_plans"] = mega.launches - launches0
    out["async_sim_time"] = c.get_state()["time"] - time0
    check(out["async_plans"] >= 1 and out["async_sim_time"] > 0,
          f"S: StartPlanning/Step/StopPlanning: {out['async_plans']} plans, "
          f"{out['async_sim_time']} s of simulation")
    c.close()
  finally:
    server.stop(None)
  print(f"[S] agent server on the card ({rec['card']}), the port's "
        f"AgentClient on localhost, Walker {a.planner.config.num_trajectories}"
        f"x{a.planner.config.horizon}: Init {out['init_s']:.2f} s (warm-up "
        f"included); GetAction and GetState equal the Agent's, bitwise; one "
        f"PlannerStep launched the kernel {out['planner_step_launches']} "
        f"time; PlannerStep RPC median {out['rpc_ms_median']:.3f} ms, direct "
        f"planner_step median {out['direct_ms_median']:.3f} ms (n={S_REPS} "
        f"each, alternating): {out['rpc_ms_median'] - out['direct_ms_median']:.3f}"
        f" ms for the RPC; StartPlanning, {S_ASYNC_STEPS} Steps, "
        f"StopPlanning: {out['async_plans']} plans, "
        f"{out['async_sim_time']:.4f} s simulated")
  # the estimation service against the port's Kalman on the same inputs
  m = registry.get_task("Cartpole", device=dev).model
  start, dim = est_base.measurement_slice(m)
  kalman = get_estimator("kalman", m, sensor_start=start, nsensordata=dim)
  state = kalman.init()
  rng = np.random.RandomState(0)
  t = time.perf_counter()
  with FilterClient("Cartpole", filter="kalman", device=dev) as fc:
    for _ in range(4):
      u, z = rng.uniform(-1, 1, m.nu), rng.uniform(-1, 1, dim)
      fc.update(u, z)
      state = kalman.update(state, torch.tensor(u, dtype=m.dtype,
                                                device=dev),
                            torch.tensor(z, dtype=m.dtype, device=dev))
    st = fc.state()
    qpos, qvel, _ = kalman.state(state)
    _same("State qpos", st["qpos"], qpos.cpu().numpy())
    _same("State qvel", st["qvel"], qvel.cpu().numpy())
    _same("Covariance", fc.covariance(), state.cov.cpu().numpy())
  out["filter_s"] = time.perf_counter() - t
  # the direct service against the port's Direct on the same window
  T = 8
  rng = np.random.RandomState(1)
  qpos = torch.tensor(rng.normal(0, 0.05, (T, m.nq)), dtype=m.dtype,
                      device=dev)
  sensors = torch.tensor(rng.normal(0, 0.05, (T, dim)), dtype=m.dtype,
                         device=dev)
  ctrls = torch.zeros((T, m.nu), dtype=m.dtype, device=dev)
  direct = Direct(m, DirectConfig(horizon=T, max_iterations=2),
                  sensor_start=start, nsensordata=dim)
  t = time.perf_counter()
  with DirectClient("Cartpole", horizon=T, device=dev) as dc:
    for i in range(T):
      dc.data(i, qpos=qpos[i].cpu().numpy(), sensor=sensors[i].cpu().numpy(),
              ctrl=ctrls[i].cpu().numpy())
    dc.settings(max_iterations=2)
    res = dc.optimize()
    want = direct.optimize(qpos, sensors, ctrls)
    _same("Optimize", [res["cost_initial"], res["cost_final"]],
          [float(want.cost_initial), float(want.cost)])
    _same("Cost", dc.cost(), float(direct._total_cost(
        want.qpos, direct.default_parameters(), sensors, ctrls)))
  out["direct_s"] = time.perf_counter() - t
  print(f"[S] estimation service (Kalman, 4 updates) and direct service "
        f"(window {T}, 2 iterations) on Cartpole on the card: every "
        f"response equals the direct call's; {out['filter_s']:.2f} s and "
        f"{out['direct_s']:.2f} s with their servers' start")


# ---------------------------------------------------------------------------
# X: the edges: the embedding interface and its C ABI, checkpoint,
#    profiling, the CLI, drive and the dashboard, on the card
# ---------------------------------------------------------------------------

# X1's sim steps beside the runner's plan loop (15: beside the plan loop a
# Walker world step took 340-430 ms on an H100); the C
# smoke's gap between its two same-state calls; X5's simulated seconds;
# X6's steps; X7's seconds of the dashboard's loops, and the most it waits
# beyond them for 3 history samples
X_STEPS, X_GAP_MS, X_CLI_S, X_DRIVE_STEPS = 15, 300, 0.2, 100
X_DASH_S, X_DASH_WAIT_S = 5.0, 30.0


@contextlib.contextmanager
def rollouts_made():
  """The MegaRollouts built in the block, in a list (yielded): the entry
  points build their Agents, so their kernel launches are read from
  these."""
  from mujoco_mpc_torch.ops import megarollout as MR
  made, init = [], MR.MegaRollout.__init__

  def tracked(self, *args, **kwargs):
    init(self, *args, **kwargs)
    made.append(self)

  MR.MegaRollout.__init__ = tracked
  try:
    yield made
  finally:
    MR.MegaRollout.__init__ = init


def plan_threads() -> list:
  """The live threads of Agent plan loops."""
  import threading
  return [t for t in threading.enumerate() if t.is_alive() and getattr(
      getattr(t, "_target", None), "__qualname__", "").startswith(
          "Agent.start_planning")]


def printed(fn, *args):
  """(fn(*args), its standard output), the output echoed."""
  import io
  buf = io.StringIO()
  with contextlib.redirect_stdout(buf):
    res = fn(*args)
  sys.stdout.write(buf.getvalue())
  return res, buf.getvalue()


def x_interface(dev, rec: dict, out: dict) -> None:
  """X1: create_policy("Walker") on the default device (its plan loop in
  a thread) and the Walker's world on the card, X_STEPS general steps from
  home, each publishing its state through step_policy and applying the
  returned action; then, the loop stopped, step_policy against the
  Agent's own action, bitwise; destroy_policy joins the thread."""
  import numpy as np
  import torch
  from mujoco_mpc_torch.agent import interface
  from mujoco_mpc_torch.physics import io as phys_io
  from mujoco_mpc_torch.physics import step as phys_step
  from mujoco_mpc_torch.tasks import registry
  with rollouts_made() as made:
    h = interface.create_policy("Walker")
  runner = interface._RUNNERS[h]
  agent = runner.agent
  check(agent.device.type == "cuda" and len(made) == 1,
        f"X1: create_policy's Agent is on {agent.device} with {len(made)} "
        "rollouts")
  m = registry.get_task("Walker", device=dev).model
  d = phys_io.make_data(m).replace(qpos=torch.tensor(
      m.keyframe("home")[0], dtype=m.dtype, device=dev))
  ms, ages, finite = [], [], True
  t_loop = time.perf_counter()
  for _ in range(X_STEPS):
    t = time.perf_counter()
    u = interface.step_policy(h, d.qpos.cpu().numpy(), d.qvel.cpu().numpy(),
                              float(d.time))
    ms.append((time.perf_counter() - t) * 1e3)
    ages.append(agent._data_version - agent.plan_version)
    finite &= bool(np.all(np.isfinite(u)))
    d = phys_step.step(m, d.replace(ctrl=torch.as_tensor(u, device=dev)))
  loop_s = time.perf_counter() - t_loop
  agent.stop_planning()
  launches, plans = made[0].launches, agent.plans
  qp, qv, t = d.qpos.cpu().numpy(), d.qvel.cpu().numpy(), float(d.time)
  got = interface.step_policy(h, qp, qv, t)
  want = agent.action()
  interface.destroy_policy(h)
  out.update(step_policy_ms=ms, step_policy_ms_median=float(np.median(ms)),
             step_policy_ms_max=float(np.max(ms)), plans=plans,
             launches=launches, age_steps_median=float(np.median(ages)),
             age_steps_max=int(np.max(ages)), finite=finite,
             sim_x=float(d.qpos[0]), loop_s=loop_s,
             world_step_ms=loop_s / X_STEPS * 1e3,
             plans_per_s=plans / loop_s)
  check(finite, "X1: a non-finite action")
  check(launches == plans and plans >= 2,
        f"X1: {launches} kernel launches in {plans} plans")
  check(np.array_equal(got, want), f"X1: step_policy {got} against the "
        f"Agent's action {want} from the same state")
  check(h not in interface._RUNNERS and not plan_threads(),
        "X1: a plan thread outlived destroy_policy")
  print(f"[X1] create_policy('Walker') on {agent.device}, its plan loop "
        f"beside {X_STEPS} general steps from home: step_policy median "
        f"{out['step_policy_ms_median']:.3f} ms, max "
        f"{out['step_policy_ms_max']:.3f} ms; a world step (step_policy, "
        f"the general step, the state's copy) {out['world_step_ms']:.1f} ms; "
        f"{plans} plans ({out['plans_per_s']:.1f} a second), {launches} "
        f"kernel launches; the policy {out['age_steps_median']:g} steps old "
        f"(median; max {out['age_steps_max']}); every action finite; with "
        f"the loop stopped step_policy equals Agent.action bitwise; "
        f"destroy_policy left no plan thread ({rec['card']})")


def x_capi_build() -> float:
  """X2's build: the C ABI library and its smoke, with g++ against this
  Python; its seconds."""
  from mujoco_mpc_torch.native import build as native
  t = time.perf_counter()
  native.build()
  native.build_test()
  return time.perf_counter() - t


def x_capi_start() -> tuple:
  """X2's smoke on Walker on the default device (the card), started:
  (the process, its start time)."""
  from mujoco_mpc_torch.native import build as native
  from mujoco_mpc_torch.tasks import registry
  task = registry.get_task("Walker", device="cpu")
  args = native.smoke_args("Walker", task.spec.names[0],
                           task.model.keyframe("home")[0], task.model.nv,
                           None, gap_ms=X_GAP_MS)
  return (subprocess.Popen(args, env=native.smoke_env(),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True), time.perf_counter())


def x_capi_finish(rec: dict, out: dict, started: tuple) -> None:
  """X2's checks: every return code (the smoke's own), nu = 6, and two
  same-state actions X_GAP_MS apart with no call between them differ (in
  one of the smoke's pairs)."""
  proc, t = started
  stdout, stderr = proc.communicate(timeout=120)
  out["smoke_s"] = time.perf_counter() - t
  out["stdout"], out["stderr_tail"] = stdout, stderr[-2000:]
  check(proc.returncode == 0, f"X2: the C smoke exited {proc.returncode}:"
        f"\n{stdout}\n{stderr[-4000:]}")
  check("C ABI smoke test OK: nu=6 " in stdout,
        f"X2: no OK line with nu=6:\n{stdout}")
  m = re.search(r"max \|action change\| (\S+) \(pair (\d+) of", stdout)
  change, pair = float(m[1]), int(m[2])
  out.update(action_change=change, pair=pair, ran=True)
  print(f"[X2] C ABI (g++, {out['build_s']:.1f} s to build) smoke on "
        f"Walker on the card: OK, nu = 6; two same-state calls {X_GAP_MS} "
        f"ms apart with no call between (pair {pair}): max |action change| "
        f"{change:g} (the plan thread ran between the calls); "
        f"{out['smoke_s']:.1f} s "
        f"with the interpreter's start, beside X5's CLI ({rec['card']})")


def x_checkpoint(dev, rec: dict, out: dict) -> None:
  """X3: a Walker Agent on the card after 2 plans, saved; the file loaded
  on the CPU equals the card's tensors bitwise; restored into a fresh
  card Agent, the next plan's policy and returns equal the saved Agent's
  next, bitwise."""
  import torch
  from mujoco_mpc_torch.agent.agent import Agent
  from mujoco_mpc_torch.ops import _cuda_build
  from mujoco_mpc_torch.utils import checkpoint
  a = Agent("Walker", device=dev)
  a.reset("home")
  a.planner_step()
  a.planner_step()
  path = str(_cuda_build.BUILD_DIR / "x3_walker.pt")
  torch.cuda.synchronize()
  t = time.perf_counter()
  checkpoint.save(path, a)
  out["save_ms"] = (time.perf_counter() - t) * 1e3
  out["bytes"] = os.path.getsize(path)
  cpu = checkpoint.load(path, map_location="cpu")
  for what, obj in (("policy", a.policy), ("data", a.data),
                    ("task_params", a.task.params)):
    for k, v in checkpoint._leaves(obj).items():
      check(cpu[what][k].device.type == "cpu"
            and torch.equal(cpu[what][k], v.cpu()),
            f"X3: the CPU load's {what}.{k} differs from the card's")
  b = Agent("Walker", device=dev)
  torch.cuda.synchronize()
  t = time.perf_counter()
  checkpoint.restore(path, b)
  torch.cuda.synchronize()
  out["restore_ms"] = (time.perf_counter() - t) * 1e3
  os.remove(path)
  ia, ib = a.planner_step(), b.planner_step()
  for k, v in checkpoint._leaves(a.policy).items():
    check(torch.equal(v, checkpoint._leaves(b.policy)[k]),
          f"X3: the restored Agent's next policy differs at {k}")
  check(torch.equal(ia.costs, ib.costs),
        "X3: the restored Agent's next returns differ")
  print(f"[X3] checkpoint of the Walker Agent on the card after 2 plans: "
        f"save {out['save_ms']:.3f} ms, restore {out['restore_ms']:.3f} ms, "
        f"{out['bytes']} bytes; the CPU load equals the card's tensors and "
        f"the restored Agent's next plan (policy and returns) the saved "
        f"one's, bitwise ({rec['card']})")


def x_profiling(dev, rec: dict, out: dict) -> None:
  """X4: PhaseTimer over 5 Walker planner_steps (each phase waits for the
  card); device_trace over 2 more: the Chrome trace holds the phase
  ranges and a mr_returns_kernel launch inside each."""
  from mujoco_mpc_torch.agent.agent import Agent
  from mujoco_mpc_torch.ops import _cuda_build
  from mujoco_mpc_torch.utils import profiling
  a = Agent("Walker", device=dev)
  a.reset("home")
  a.planner_step()
  timer = profiling.PhaseTimer()
  for _ in range(5):
    with timer.phase("planner_step", sync=dev):
      a.planner_step()
  out["report"] = timer.report()
  logdir = _cuda_build.BUILD_DIR / "x4_trace"
  with profiling.device_trace(str(logdir), device=dev):
    for _ in range(2):
      with timer.phase("traced_plan", sync=dev):
        a.planner_step()
  with open(logdir / profiling.TRACE_FILE) as f:
    events = json.load(f)["traceEvents"]
  shutil.rmtree(logdir)
  # the phase's range on the host's track, and where the profiler draws
  # one, on the card's
  ranges = [e for e in events if e.get("name") == "traced_plan"
            and e.get("cat") == "user_annotation"]
  card_ranges = [e for e in events if e.get("name") == "traced_plan"
                 and e.get("cat") == "gpu_user_annotation"]
  kernels = [e for e in events if e.get("cat") == "kernel"
             and "mr_returns_kernel" in e.get("name", "")]
  inside = [k for k in kernels if any(
      r["ts"] <= k["ts"] and k["ts"] + k["dur"] <= r["ts"] + r["dur"]
      for r in ranges + card_ranges)]
  out.update(trace_ranges=len(ranges), card_ranges=len(card_ranges),
             trace_kernels=len(kernels),
             kernels_inside=len(inside), trace_events=len(events))
  check(len(ranges) == 2 and len(inside) >= 1,
        f"X4: the trace has {len(ranges)} phase ranges and "
        f"{len(inside)} of {len(kernels)} mr_returns_kernel events inside")
  d2 = rec["derivative"]["D2"]["sampling"]["median_ms"]
  mean = out["report"]["planner_step"]["mean_ms"]
  print(f"[X4] PhaseTimer over 5 Walker planner_steps: mean {mean:.3f} ms "
        f"(D2's sampling plan median {d2:.3f} ms); device_trace over 2: "
        f"{len(events)} events, {len(ranges)} phase ranges, "
        f"{len(inside)} mr_returns_kernel launches inside them "
        f"({rec['card']})")


def x_cli_start() -> tuple:
  """X5's subprocess, python -m mujoco_mpc_torch --task Walker, started:
  (the process, its start time)."""
  return (subprocess.Popen(
      [sys.executable, "-m", "mujoco_mpc_torch", "--task", "Walker",
       "--time", str(X_CLI_S), "--plan_every", "2"],
      cwd=os.path.dirname(os.path.abspath(__file__)),
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
      time.perf_counter())


def x_cli_finish(rec: dict, out: dict, started: tuple) -> None:
  """X5: the CLI subprocess's cost, wall time and realtime factor; --list
  in this process, and a short run in this process counting the kernel's
  launches a plan."""
  import math

  from mujoco_mpc_torch import __main__ as cli
  from mujoco_mpc_torch.tasks import registry
  dt = float(registry.get_task("Walker", device="cpu").model.opt.timestep)
  proc, t = started
  stdout, stderr = proc.communicate(timeout=300)
  out["subprocess_s"] = time.perf_counter() - t
  check(proc.returncode == 0, f"X5: the CLI exited {proc.returncode}:\n"
        f"{stdout}\n{stderr[-4000:]}")
  m = re.search(r"cost: (\S+)\nTotal wall time \((\d+) planning steps\): "
                r"(\S+) s \((\S+)x realtime\)", stdout)
  check(m is not None, f"X5: the CLI printed\n{stdout}")
  cost, plans, wall = float(m[1]), int(m[2]), float(m[3])
  # the printed factor has two decimals: the simulated seconds over the
  # printed wall time
  rtf = round(X_CLI_S / dt) * dt / wall
  out.update(total_cost=cost, planning_steps=plans, wall_s=wall,
             realtime_factor=rtf, printed_realtime_factor=float(m[4]))
  check(math.isfinite(cost) and plans == round(X_CLI_S / dt / 2),
        f"X5: cost {cost}, {plans} plans")
  _, listed = printed(cli.main, ["--list"])
  lines = dict(line.split(": ", 1) for line in listed.strip().splitlines())
  out["tasks"] = len(lines["tasks"].split(", "))
  out["planners"] = len(lines["planners"].split(", "))
  check(out["tasks"] == 26 and out["planners"] == 7,
        f"X5: --list named {out['tasks']} tasks, {out['planners']} planners")
  with rollouts_made() as made:
    _, text = printed(cli.main, ["--task", "Walker", "--time", "0.05",
                                 "--plan_every", "2"])
  n = int(re.search(r"\((\d+) planning steps\)", text)[1]) + 1  # warm-up
  out["inprocess_plans"] = n
  out["inprocess_launches"] = sum(r.launches for r in made)
  check(out["inprocess_launches"] == n, f"X5: {out['inprocess_launches']} "
        f"launches in the CLI's {n} plans")
  print(f"[X5] python -m mujoco_mpc_torch --task Walker --time {X_CLI_S} "
        f"--plan_every 2 (a subprocess beside X2's smoke, "
        f"{out['subprocess_s']:.1f} s with its start): total cost "
        f"{cost:.6f}, wall {wall:.2f} s, realtime factor {rtf:.4f}, "
        f"{plans} plans; --list: {out['tasks']} tasks, "
        f"{out['planners']} planners; in this process {n} plans launched the "
        f"kernel {out['inprocess_launches']} times ({rec['card']})")


def x_drive(rec: dict, out: dict) -> None:
  """X6: tools.drive on Walker in this process, a plan every 2 steps."""
  import math
  from mujoco_mpc_torch.tools import drive
  with rollouts_made() as made:
    res, _ = printed(drive.main, ["--task", "Walker", "--steps",
                                  str(X_DRIVE_STEPS), "--plan_every", "2"])
  out.update(res)
  out["launches"] = sum(r.launches for r in made)
  check(out["launches"] == X_DRIVE_STEPS // 2,
        f"X6: {out['launches']} launches in {X_DRIVE_STEPS // 2} plans")
  check(all(math.isfinite(x) for x in res["displacement"])
        and all(math.isfinite(res[k]) for k in (
            "final_cost", "best_return_first", "best_return_last")),
        f"X6: {res}")
  print(f"[X6] drive Walker {X_DRIVE_STEPS} steps: displacement "
        f"{res['displacement']}, final cost {res['final_cost']:.6f}, "
        f"{res['wall_s']} s; {out['launches']} kernel launches in "
        f"{X_DRIVE_STEPS // 2} plans ({rec['card']})")


def x_dashboard(rec: dict, out: dict) -> None:
  """X7: AgentUI("Walker") with its physics and plan threads on the card
  and its server on a localhost port for X_DASH_S: the state, a weight set
  through /api/set, a switch to cross_entropy with the loops paused (the
  state kept) whose plans launch the kernel, and /frame.jpg's 404."""
  import threading
  import urllib.error
  import urllib.request

  import numpy as np
  from mujoco_mpc_torch.ui import server

  def req(port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                               method="GET" if data is None else "POST")
    try:
      with urllib.request.urlopen(r, timeout=30) as resp:
        return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
      return e.code, json.loads(e.read())

  with rollouts_made() as made:
    ui = server.AgentUI("Walker")
    srv = server.make_server(ui, port=0)
    port = srv.server_address[1]
    serve = threading.Thread(target=srv.serve_forever, daemon=True)
    serve.start()
    try:
      ui.start()
      t = time.perf_counter()
      time.sleep(X_DASH_S)
      # beside the plan loop the physics loop makes a few steps a second
      # (X1); the history takes a sample every second step
      while (len(ui.history) < 3 and ui.error is None
             and time.perf_counter() - t < X_DASH_S + X_DASH_WAIT_S):
        time.sleep(0.1)
      window = time.perf_counter() - t
      code, st = req(port, "/api/state")
      agent = ui.agent
      plans = agent.plans
      out.update(planner_hz=st["planner_hz"], planner_ms=st["planner_ms"],
                 history=len(st["history"]), sim_time=st["time"],
                 window_s=window, plans_per_s=plans / window)
      check(code == 200 and "error" not in st and st["planner_hz"]
            and len(st["history"]) >= 3,
            f"X7: /api/state {code}: error {st.get('error')}, planner_hz "
            f"{st['planner_hz']}, {len(st['history'])} history samples")
      name = agent.task.spec.names[0]
      code, _ = req(port, "/api/set", {"weights": {name: 1.625}})
      check(code == 200 and agent.get_cost_weights()[name] == 1.625,
            f"X7: /api/set of {name}: {code}")
      req(port, "/api/set", {"paused": True})
      time.sleep(0.2)
      before = agent.get_state()
      code, _ = req(port, "/api/planner", {"planner": "cross_entropy"})
      after = ui.agent.get_state()
      check(code == 200 and ui.agent.planner_name == "cross_entropy"
            and all(np.array_equal(before[k], after[k])
                    for k in ("qpos", "qvel", "time")),
            "X7: the switch to cross_entropy did not keep the state")
      req(port, "/api/set", {"paused": False})
      time.sleep(1.0)
      code, frame = req(port, "/frame.jpg")
      out.update(frame_code=code, frame_reason=frame.get("error"))
      check(code == 404 and "mujoco" in str(frame.get("error")),
            f"X7: /frame.jpg answered {code} {frame}")
      code, st = req(port, "/api/state")
      check("error" not in st, f"X7: {st.get('error')}")
    finally:
      ui.stop()
      srv.shutdown()
      srv.server_close()
  cem = ui.agent
  out.update(sampling_plans=agent.plans, cem_plans=cem.plans,
             launches=[r.launches for r in made])
  check(len(made) == 2 and made[0].launches == agent.plans
        and made[1].launches == cem.plans and cem.plans >= 1,
        f"X7: launches {out['launches']}, plans {agent.plans} and "
        f"{cem.plans}")
  print(f"[X7] dashboard AgentUI('Walker') on the card, "
        f"{out['window_s']:.1f} s of its loops: planner_hz "
        f"{out['planner_hz']}, {out['plans_per_s']:.1f} plans a second, "
        f"{out['history']} history samples, {out['sim_time']:.4f} s "
        f"simulated; the weight set reached the task; cross_entropy kept "
        f"the state; kernel launches {made[0].launches} in {agent.plans} "
        f"sampling plans and {made[1].launches} in "
        f"{cem.plans} CEM plans; /frame.jpg 404: {out['frame_reason']} "
        f"({rec['card']})")


# ---------------------------------------------------------------------------
# SH: the sharded planners (parallel/mesh.py) on the card
# ---------------------------------------------------------------------------

# SH's timed plans of each planner on each mesh; its robust cell (Particle
# at a 20-step horizon keeps the general route's re-scorings short)
SH_REPS, SH_ROBUST_HORIZON = 5, 20
# the sampling cell: JAX's sharded_walker_1024x80 (bench.py:263)
SH_BENCH = (1024, 80)


def sharded_bench(tag: str, mesh, task, cfg, dev, noise, use2) -> dict:
  """ShardedSamplingPlanner on `mesh` at cfg's shape: the first plan's
  returns against the unsharded kernel's on the same candidates (bitwise,
  or within the kernel's float32 rule, rtol 2e-3, with the distance
  printed); the launches of SH_REPS plans, the counts set to 0 just
  before and read just after (one a shard a plan); those plans' ms beside
  the unsharded planner's at the same draws, in turns; the returns' ms
  (CUDA events) beside the unsharded kernel's."""
  import numpy as np
  import torch
  from mujoco_mpc_torch.parallel import mesh as pm
  from mujoco_mpc_torch.physics import io as phys_io
  from mujoco_mpc_torch.planners import sampling
  sharded = pm.ShardedSamplingPlanner(cfg, mesh)
  plain = sampling.SamplingPlanner(cfg)
  spol, upol = sharded.init(task), plain.init(task)
  data = phys_io.make_data(task.model).replace(
      qpos=torch.tensor(start_qpos(task.model), device=dev))
  draws = dict(noise=noise, use2=use2)
  _, si = sharded.optimize(task, spol, data, None, **draws)
  _, ui = plain.optimize(task, upol, data, None, **draws)
  torch.cuda.synchronize()
  bitwise = torch.equal(si.costs, ui.costs)
  rel, max_abs = agreement(si.costs, ui.costs, f"{tag}: sharded returns")
  check(int(si.winner) == int(ui.winner),
        f"{tag}: the sharded winner {int(si.winner)} is not the unsharded "
        f"{int(ui.winner)}")
  for m in sharded.megas.values():
    m.launches = 0
  ms = {"sharded": [], "unsharded": []}
  for _ in range(SH_REPS):
    for name, pl, pol in (("sharded", sharded, spol),
                          ("unsharded", plain, upol)):
      t = time.perf_counter()
      pl.optimize(task, pol, data, None, **draws)
      torch.cuda.synchronize()
      ms[name].append((time.perf_counter() - t) * 1e3)
  launches = sum(m.launches for m in sharded.megas.values())
  check(launches == SH_REPS * len(mesh),
        f"{tag}: {launches} kernel launches in {SH_REPS} plans on "
        f"{len(mesh)} shards")
  new_times, _, cands = plain._gen_candidates(task, upol, data, None,
                                              **draws)
  ret_ms = {
      "sharded": timed_cuda(lambda: sharded._returns(
          task, data, new_times, cands, None), 3),
      "unsharded": timed_cuda(lambda: plain._returns(
          task, data, new_times, cands, None), 3)}
  q = {k: np.percentile(v, [50, 66.7]).tolist() for k, v in ms.items()}
  out = {"mesh": [str(d) for d in mesh.devices], "bitwise": bitwise,
         "rel": rel, "max_abs": max_abs, "launches": launches,
         "plans": SH_REPS, "plan_ms": ms, "plan_ms_q": q,
         "returns_ms": ret_ms,
         "geometry": sharded.mega.geometry(
             cfg.num_trajectories // len(mesh)),
         "actions": plain._actions(task, data, new_times, cands),
         "returns": si.costs}
  print(f"[{tag}] ShardedSamplingPlanner on {mesh} (Walker "
        f"{cfg.num_trajectories}x{cfg.horizon} at dt "
        f"{float(task.model.opt.timestep):g}): first plan's returns "
        f"{'bitwise equal to' if bitwise else 'against'} the unsharded "
        f"kernel's (max rel {rel:.3g}, max abs {max_abs:.3g}; tol 2e-3), "
        f"winner {int(si.winner)}; {launches} launches in {SH_REPS} plans; "
        f"plan ms median {q['sharded'][0]:.3f}, p66.7 {q['sharded'][1]:.3f}"
        f" (unsharded {q['unsharded'][0]:.3f}, {q['unsharded'][1]:.3f}); "
        f"returns {ret_ms['sharded']:.3f} ms (unsharded "
        f"{ret_ms['unsharded']:.3f}); a shard's launch {out['geometry']}")
  return out


def run_sharded(dev, rec: dict):
  """Phase SH: the sharded planners of parallel/mesh.py on the card. The
  sampling planner at the Walker bench (1024x80 at the XML dt) on
  make_mesh() (one shard a card; distinct cards where the host has more
  than one) and on two shards sharing cuda:0, each on its own stream
  (sharded_bench); the first plan's float32 returns on make_mesh()
  against the plain version in float64 on the host's cores (agreement,
  rtol 2e-3, resolved at the end of the phase). CEM at the Walker Agent's
  128x80 on the two shards: SH_REPS plans, two launches each, finite
  returns. The robust planner on Particle (ncandidates 8, nrepetitions 2,
  two shards, horizon SH_ROBUST_HORIZON): the first float64 plan on the
  card against the CPU's on injected draws (rel 1e-8; its delegate through
  the uncontracted double kernel, as D2), one float32 plan timed. Then
  the rest of the Agent's constructor: Agent("Walker", dtype=float64) plans
  once through the kernel's double instance, and model_xml on a host
  without `mujoco` raises registry.ModelXmlRefused. The kernels line's
  row megarollout_returns[sharded], for run_all to append."""
  import importlib.util
  import numpy as np
  import torch
  from mujoco_mpc_torch.agent.agent import Agent
  from mujoco_mpc_torch.ops import megarollout as MR
  from mujoco_mpc_torch.parallel import mesh as pm
  from mujoco_mpc_torch.physics import io as phys_io
  from mujoco_mpc_torch.planners import cross_entropy as ce
  from mujoco_mpc_torch.planners import robust, sampling
  from mujoco_mpc_torch.tasks import registry
  out = rec["sharded"] = {"device_count": torch.cuda.device_count()}
  print(f"[SH] torch.cuda.device_count() {out['device_count']} "
        f"({rec['card']})")
  task = registry.get_task("Walker", device=dev)
  acfg = sampling.SamplingConfig.from_task(task)
  cfg = sampling.SamplingConfig(num_trajectories=SH_BENCH[0],
                                horizon=SH_BENCH[1],
                                spline_points=acfg.spline_points,
                                interp=acfg.interp)
  gen = torch.Generator(device=dev).manual_seed(15)
  n, k = cfg.num_trajectories, cfg.spline_points
  noise = torch.randn((n - 1, k, task.model.nu), generator=gen, device=dev)
  use2 = torch.rand((n - 1,), generator=gen, device=dev) < 0.2
  meshes = {"make_mesh": pm.make_mesh(), "two_shards": pm.Mesh((dev, dev))}
  if out["device_count"] == 1:
    print("[SH] one card: make_mesh() has one shard; the distinct-card "
          "mesh is not run")
  for name, mesh in meshes.items():
    out[name] = sharded_bench(f"SH {name}", mesh, task, cfg, dev, noise,
                              use2)
  main = out["make_mesh"]
  acts, got = main.pop("actions"), main.pop("returns")
  for res in out.values():
    if isinstance(res, dict):
      res.pop("actions", None)
      res.pop("returns", None)
  d0 = phys_io.make_data(task.model)
  jobs = plain_submit(task, cfg.horizon,
                      (torch.tensor(start_qpos(task.model), device=dev),
                       d0.qvel, acts, task.params, d0.time), {},
                      torch.float64)

  # CEM at the Walker Agent's shape on the two shards
  agent = Agent("Walker", planner="cross_entropy", device=dev)
  agent.reset("home")
  cem = pm.ShardedCrossEntropyPlanner(agent.planner.config,
                                      meshes["two_shards"])
  pol = cem.init(agent.task)
  cem.mega.launches = 0
  cem_best = []
  for _ in range(SH_REPS):
    pol, info = cem.optimize(agent.task, pol, agent.data, agent.generator)
    check(bool(torch.all(torch.isfinite(info.costs))),
          "SH cem: non-finite returns")
    cem_best.append(float(info.best_return))
  out["cem"] = {"launches": cem.mega.launches, "best": cem_best}
  check(cem.mega.launches == 2 * SH_REPS,
        f"SH cem: {cem.mega.launches} launches in {SH_REPS} plans on 2 "
        f"shards")
  print(f"[SH] ShardedCrossEntropyPlanner on {meshes['two_shards']} (Walker "
        f"{agent.planner.config.num_trajectories}x"
        f"{agent.planner.config.horizon}): {SH_REPS} plans, "
        f"{cem.mega.launches} launches, best returns "
        f"{[round(b, 4) for b in cem_best]}")

  # the robust planner on Particle: float64 card vs CPU, float32 timed
  def robust_plan(device, dtype, draws):
    ptask = registry.get_task("Particle", dtype=dtype, device=device)
    scfg = sampling.SamplingConfig.from_task(ptask, SH_ROBUST_HORIZON)
    pl = pm.ShardedRobustPlanner(
        sampling.SamplingPlanner(scfg),
        robust.RobustConfig(ncandidates=8, nrepetitions=2),
        pm.Mesh((device, device)))
    d = phys_io.make_data(ptask.model).replace(
        qpos=torch.tensor([0.2, -0.2], dtype=dtype, device=device))
    pol = pl.init(ptask)
    if pl.mega is not None:
      pl.mega.launches = 0
    t = time.perf_counter()
    pol, info = pl.optimize(ptask, pol, d, None, **{
        key: v.to(device=device, dtype=dtype if v.is_floating_point()
                  else v.dtype) for key, v in draws.items()})
    best = float(info.best_return)
    return {"ms": (time.perf_counter() - t) * 1e3, "best_return": best,
            "winner": int(info.winner), "values": pol.values.cpu().numpy(),
            "costs": info.costs.cpu().numpy(),
            "launches": pl.mega.launches if pl.mega is not None else 0}

  ptask = registry.get_task("Particle", device="cpu")
  g = torch.Generator().manual_seed(16)
  pn = sampling.SamplingConfig.from_task(ptask).num_trajectories
  draws = {"noise": torch.randn((pn - 1, 5, ptask.model.nu), generator=g,
                                dtype=torch.float64),
           "use2": torch.zeros(pn - 1, dtype=torch.bool),
           "eps": torch.randn((SH_ROBUST_HORIZON, 8, 2, ptask.model.nbody, 6),
                              generator=g, dtype=torch.float64)}
  with MR.double_kernels():
    card64 = robust_plan(dev, torch.float64, draws)
  cpu64 = robust_plan("cpu", torch.float64, draws)
  br = abs(card64["best_return"] - cpu64["best_return"]) / max(
      abs(cpu64["best_return"]), 1e-300)
  gaps = {f: rel_to_max(card64[f], cpu64[f]) for f in ("values", "costs")}
  card32 = robust_plan(dev, torch.float32, draws)
  out["robust"] = {"best_return_rel": br, "gaps": gaps,
                   "winner": (card64["winner"], cpu64["winner"]),
                   "launches": card64["launches"], "ms_f32": card32["ms"]}
  print(f"[SH] ShardedRobustPlanner on two shards of {dev} (Particle, 8 "
        f"candidates x 2 repetitions, horizon {SH_ROBUST_HORIZON}): first "
        f"float64 plan card vs CPU best_return rel {br:.3g} (tol 1e-8), "
        + ", ".join(f"{f} {v:.3g}" for f, v in gaps.items())
        + f" of the max; winner {card64['winner']} ({cpu64['winner']} on "
        f"the CPU); {card64['launches']} kernel launch (the delegate); a "
        f"float32 plan {card32['ms']:.1f} ms")
  check(card64["winner"] == cpu64["winner"] and br <= 1e-8
        and all(v <= 1e-8 for v in gaps.values()),
        "SH robust: the first float64 plan on the card disagrees with the "
        "CPU's")
  check(card64["launches"] == 1 and np.isfinite(card32["best_return"]),
        "SH robust: launches or a non-finite float32 plan")

  # the rest of the Agent's constructor
  a64 = Agent("Walker", dtype=torch.float64, device=dev)
  a64.reset("home")
  a64.planner.mega.launches = 0
  info = a64.planner_step()
  out["agent_f64"] = {"launches": a64.planner.mega.launches,
                      "best_return": float(info.best_return)}
  check(info.costs.dtype == torch.float64 and a64.planner.mega.launches == 1
        and bool(torch.all(torch.isfinite(info.costs))),
        "SH: Agent('Walker', dtype=float64)'s plan")
  has_mujoco = importlib.util.find_spec("mujoco") is not None
  if has_mujoco:
    out["model_xml"] = "not checked: this host has mujoco"
  else:
    try:
      Agent("Particle", model_xml="<mujoco/>", device=dev)
      fail("SH: model_xml on a host without mujoco built an Agent")
    except registry.ModelXmlRefused as e:
      out["model_xml"] = str(e)
  print(f"[SH] Agent('Walker', dtype=torch.float64): one plan, "
        f"{out['agent_f64']['launches']} launch (the double instance), "
        f"best_return {out['agent_f64']['best_return']:.6g}; "
        f"Agent('Particle', model_xml=...): {out['model_xml']}")

  # the plain version's float64 returns, waited for here: X's host
  # timings do not share the cores with them
  (want,), plain_ms = jobs.get()
  rel, max_abs = agreement(got, want.to(got.dtype),
                           "SH make_mesh: returns against the plain "
                           "version in float64")
  main.update(plain_rel=rel, plain_abs=max_abs, plain_ms=plain_ms)
  print(f"[SH] make_mesh()'s first plan {tuple(acts.shape)} against the "
        f"plain version in float64 on the host: max rel {rel:.3g} (tol "
        f"2e-3), max abs {max_abs:.3g}; plain {plain_ms:.1f} ms (summed "
        f"over its {PLAIN_WORKERS} workers' chunks)")
  bound_ms, by = bound(rec["walker_step_ops"], n, cfg.horizon, task)
  two = out["two_shards"]

  def row():
    return {
        "name": "megarollout_returns[sharded]", "route": "cuda",
        "source": "mujoco_mpc_torch/csrc/megarollout.cu",
        "replaces": "mujoco_mpc_tpu/parallel/mesh.py:111",
        "launches": main["launches"], "max_abs_err": max_abs,
        "ms": main["returns_ms"]["sharded"], "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
        **geometry_keys(main), "shards": len(meshes["make_mesh"]),
        "unsharded_ms": main["returns_ms"]["unsharded"],
        "two_shards_ms": two["returns_ms"]["sharded"],
        "two_shards_launches": two["launches"],
        "err_over_tol": rel / 2e-3}

  return row


# the general step's CUDA launches per step of one state (G1) that
# PERF.md §5 records for the step with the unfloored inertia factor
G1_LAUNCHES_RECORDED = {"Walker": 1391, "Humanoid Walk": 2193}
# the singular PSD matrix whose second pivot floors at 1e-12, and its
# right-hand side
SINGULAR = ([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 2.0]],
            [1.0, 2.0, 3.0])


def replayed_plan(agent):
  """One planner_step of `agent` with its launch count set to 0 just
  before, and that plan's candidates' actions, replayed from a copy of
  the generator's state before the plan. Returns (PlanInfo, launches,
  actions, the Data planned from)."""
  import torch
  gen = torch.Generator(device=agent.generator.device)
  gen.set_state(agent.generator.get_state())
  policy, data = agent.policy, agent.data
  agent.planner.mega.launches = 0
  info = agent.planner_step()
  launches = agent.planner.mega.launches
  pl = agent.planner
  new_times, _, cands = pl._gen_candidates(agent.task, policy, data, gen)
  return info, launches, pl._actions(agent.task, data, new_times, cands), \
      data


def names_plan(tag: str, agent):
  """replayed_plan, its one launch checked, the plain version's float32
  returns of the same candidates submitted to the host's workers; a
  function that holds the plan's returns against them per candidate
  (rtol 2e-3) and gives (max rel, max abs) err and the launches."""
  import torch
  info, launches, acts, d = replayed_plan(agent)
  check(launches == 1, f"{tag}: {launches} kernel launches in one plan")
  ops = dict(mocap_pos=d.mocap_pos, mocap_quat=d.mocap_quat,
             userdata=d.userdata)
  jobs = plain_submit(agent.task, acts.shape[1],
                      (d.qpos, d.qvel, acts, agent.task.params, d.time),
                      ops, torch.float32, now=True)

  def hold():
    (want,), _ = jobs.get()
    return agreement(info.costs, want,
                     f"{tag}: returns {tuple(acts.shape)}") + (launches,)

  return info, hold


def run_names(dev, rec: dict) -> None:
  """Phase N: the names the port took over from the JAX package last,
  on the card. rubik.make() builds "Rubik" (the hand) and
  rubik.make_faces() "Rubik Faces"; a Rubik Faces plan (the Agent, its
  face targets set) launches the kernel once, its returns held per
  candidate against the plain version's on the same candidates (float32
  on the host's workers, rtol 2e-3). Task.set_mode writes Quadruped
  Flat's Walk mode into the requested-mode slot: the next plan launches
  the kernel once, its returns held as the Rubik Faces plan's, and it
  equals bitwise a plan from the same draws after Agent.set_mode to the
  same index. Model.sensor_adr on the card's Humanoid Walk model against
  the CPU's. ops/linalg.py's chol_factor and chol_solve on the card
  against the CPU: the singular example in float64 (its floored pivot
  1e-6, its solution about 1e12), and 16 Humanoid Walk inertias M + h
  diag(damping) at probe states in float32 and float64, beside the
  general step's unfloored factor (physics/step.py::_chol); the smallest
  pivot printed. Then G1's launches per step beside PERF.md's."""
  import numpy as np
  import torch
  from mujoco_mpc_torch.agent.agent import Agent
  from mujoco_mpc_torch.ops import linalg
  from mujoco_mpc_torch.ops import rollout as R
  from mujoco_mpc_torch.physics import io as phys_io
  from mujoco_mpc_torch.physics import step as S
  from mujoco_mpc_torch.tasks import humanoid, quadruped, registry, rubik
  out = rec["names"] = {}
  t0 = time.perf_counter()

  # rubik.make is the hand, make_faces the bare face mechanism
  hand, faces = rubik.make(device=dev), rubik.make_faces(device=dev)
  check((hand.name, faces.name) == ("Rubik", "Rubik Faces")
        and hand.residual is rubik.residual
        and registry.get_task("Rubik Faces", device=dev).name
        == "Rubik Faces", "N: rubik.make / make_faces")
  fagent = Agent("Rubik Faces", device=dev, planner="sampling")
  try:
    fagent.reset("home")
  except KeyError:
    fagent.reset()
  fagent.set_state(userdata=rubik.faces_userdata(
      fagent.task.model.nuserdata, RUBIK_TARGETS))
  _, faces_hold = names_plan("N Rubik Faces", fagent)

  # Task.set_mode against Agent.set_mode, from the same draws
  name, goal = "Quadruped Flat", [[1.0, 0.3, 0.3]]
  mode = quadruped.MODE_WALK
  agents = []
  for _ in range(2):
    a = Agent(name, device=dev)
    a.reset("home")
    a.set_state(mocap_pos=goal, userdata=quadruped.fsm_userdata(
        a.task.model.nuserdata))
    agents.append(a)
  by_task, by_agent = agents
  ud = by_task.task.set_mode(by_task.data, mode).userdata
  check(int(by_task.task.get_mode(by_task.data)) == quadruped.MODE_QUADRUPED
        and ud.dtype == by_task.data.userdata.dtype,
        "N: Task.set_mode changed the Data it was given")
  by_task.set_state(userdata=ud.cpu().numpy())
  by_agent.set_mode(quadruped.MODE_NAMES[mode])
  check(int(by_task.task.get_mode(by_task.data)) == mode
        and by_task.task.get_mode(by_task.data).dtype == torch.int32
        and by_agent.get_mode() == "Walk", "N: the mode register")
  tinfo, quad_hold = names_plan("N Quadruped Flat set_mode", by_task)
  by_agent.planner.mega.launches = 0
  ainfo = by_agent.planner_step()
  alaunches = by_agent.planner.mega.launches
  bitwise = (torch.equal(tinfo.costs, ainfo.costs)
             and torch.equal(by_task.policy.values, by_agent.policy.values))
  check(bitwise and alaunches == 1,
        "N: the plan after Task.set_mode is not the plan after "
        "Agent.set_mode")

  # Model.sensor_adr on a card model
  walk = registry.get_task("Humanoid Walk", device=dev).model
  cpu_walk = registry.get_task("Humanoid Walk", device="cpu").model
  adr = {s: walk.sensor_adr(s) for s in walk.sensor_names}
  check(adr == {s: cpu_walk.sensor_adr(s) for s in cpu_walk.sensor_names}
        and adr["Posture"][1] == 21, "N: Model.sensor_adr")

  # the floored factor on the card against the CPU
  def factor_solve(a, b, device):
    low = linalg.chol_factor(a.to(device))
    return low, linalg.chol_solve(low, b.to(device))

  a = torch.tensor(SINGULAR[0], dtype=torch.float64)
  b = torch.tensor(SINGULAR[1], dtype=torch.float64)
  (lc, xc), (lh, xh) = factor_solve(a, b, dev), factor_solve(a, b, "cpu")
  chol = {"singular": {
      "factor": rel_to_max(lc.cpu().numpy(), lh.numpy()),
      "solve": rel_to_max(xc.cpu().numpy(), xh.numpy()),
      "pivot": float(lc[1, 1]), "solution": xc.cpu().tolist()}}
  check(bool(torch.all(torch.isfinite(xc))) and chol["singular"]["factor"]
        <= 1e-12 and chol["singular"]["solve"] <= 1e-8
        and abs(chol["singular"]["pivot"] - 1e-6) <= 1e-18,
        f"N: the singular example on the card: {chol['singular']}")
  states = humanoid.probe_states(walk, 16)
  for dt, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
    mats = {}
    for device in (dev, "cpu"):
      m = registry.get_task("Humanoid Walk", dtype=dt, device=device).model
      qp, qv, ct = (torch.tensor(x.T, dtype=dt, device=device)
                    for x in states)
      d = S._smooth(m, R.broadcast(phys_io.make_data(m), (16,)).replace(
          qpos=qp, qvel=qv, ctrl=ct), actuate=False)
      mats[device] = (d.qM + m.opt.timestep.to(dt) * torch.diag(
          m.dof_damping.to(dt)), S._chol(m, d))
    (ac, unfloored), (ah, _) = mats[dev], mats["cpu"]
    rhs = torch.tensor(np.random.RandomState(16).randn(16, ac.shape[-1]),
                       dtype=dt)
    (lc, xc), (lh, xh) = factor_solve(ac, rhs, dev), factor_solve(
        ah, rhs, "cpu")
    pivots = torch.diagonal(lc, dim1=-2, dim2=-1) ** 2
    key = str(dt).split(".")[1]
    chol[key] = {"factor": rel_to_max(lc.cpu().numpy(), lh.numpy()),
                 "solve": rel_to_max(xc.cpu().numpy(), xh.numpy()),
                 "vs_unfloored": rel_to_max(lc.cpu().numpy(),
                                            unfloored.cpu().numpy()),
                 "min_pivot": float(pivots.min())}
    check(chol[key]["factor"] <= tol and chol[key]["solve"] <= 1e3 * tol
          and chol[key]["vs_unfloored"] <= 1e2 * tol
          and chol[key]["min_pivot"] > 1e-6,
          f"N: the Humanoid Walk inertias' factor in {key}: {chol[key]}")
  torch.cuda.synchronize()

  frel, fabs, flaunches = faces_hold()
  qrel, qabs, qlaunches = quad_hold()
  g1 = {n: rec["general"]["G1"][n]["launch_calls"]
        for n in G1_LAUNCHES_RECORDED}
  out.update(rubik_faces={"rel": frel, "abs": fabs, "launches": flaunches},
             quadruped_set_mode={"rel": qrel, "abs": qabs,
                                 "launches": qlaunches, "bitwise": bitwise,
                                 "agent_set_mode_launches": alaunches},
             sensor_adr=adr, chol=chol, g1_launches=g1,
             seconds=time.perf_counter() - t0)
  print(f"[N] rubik.make() -> '{hand.name}', rubik.make_faces() -> "
        f"'{faces.name}'; Agent('Rubik Faces') plan: {flaunches} launch, "
        f"returns against the plain version max rel {frel:.3g} (tol 2e-3), "
        f"max abs {fabs:.3g}")
  print(f"[N] Task.set_mode(data, Walk) on Quadruped Flat: requested mode "
        f"{int(by_task.task.get_mode(by_task.data))} (int32), next plan "
        f"{qlaunches} launch, returns max rel {qrel:.3g} (tol 2e-3), max abs "
        f"{qabs:.3g}; equal bitwise to the plan after Agent.set_mode('Walk') "
        f"({alaunches} launch): {bitwise}")
  print(f"[N] Model.sensor_adr on the card's Humanoid Walk: "
        f"{len(adr)} sensors, as on the CPU (Posture {adr['Posture']})")
  for key, c in chol.items():
    print(f"[N] chol_factor / chol_solve card vs CPU, {key}: "
          + ", ".join(f"{k} {v:.3g}" if isinstance(v, float) else
                      f"{k} {v}" for k, v in c.items()))
  print(f"[N] G1's CUDA launches per general step of one state: "
        + ", ".join(f"{n} {g1[n]} (recorded {G1_LAUNCHES_RECORDED[n]})"
                    for n in g1) + f" ({rec['card']}); phase N "
        f"{out['seconds']:.1f} s")


def run_edges(dev, rec: dict) -> None:
  """Phase X, each part timed on the timeline."""
  out = rec["edges"] = {k: {} for k in ("X1", "X2", "X3", "X4", "X5", "X6",
                                        "X7")}
  t0 = time.perf_counter()

  def mark(what: str) -> None:
    timeline(f"X +{time.perf_counter() - t0:.1f} s: {what}")

  # X2's g++ builds run beside X1 (host processes; X1 runs on the card)
  with concurrent.futures.ThreadPoolExecutor(1) as pool:
    build = pool.submit(x_capi_build)
    x_interface(dev, rec, out["X1"])
    mark("X1")
    out["X2"]["build_s"] = build.result()
  x_checkpoint(dev, rec, out["X3"])
  mark("X3")
  x_profiling(dev, rec, out["X4"])
  mark("X4")
  # X2's smoke and X5's CLI, two processes at once: each starts an
  # interpreter and a CUDA context (seconds), then plans on the card
  smoke, cli = x_capi_start(), x_cli_start()
  try:
    x_capi_finish(rec, out["X2"], smoke)
    mark("X2")
    x_cli_finish(rec, out["X5"], cli)
    mark("X5")
  finally:
    for proc, _ in (smoke, cli):
      if proc.poll() is None:
        proc.kill()
        proc.wait()
  x_drive(rec, out["X6"])
  mark("X6")
  x_dashboard(rec, out["X7"])
  mark("X7")
  out["s"] = time.perf_counter() - t0


def main() -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument("--out", help="also write every measured number here")
  ap.add_argument("--ncu-target", action="store_true", help=argparse.SUPPRESS)
  args = ap.parse_args()

  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
          file=sys.stderr)
    return 2
  global T_START
  T_START = time.perf_counter()
  import mujoco_mpc_torch  # noqa: F401 (fails outside a checkout)
  if args.ncu_target:
    return ncu_target()

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device("cuda", 0)
  rec = {}
  global PLAIN
  PLAIN = concurrent.futures.ProcessPoolExecutor(
      max_workers=PLAIN_WORKERS, initializer=_worker_init, initargs=(False,),
      mp_context=multiprocessing.get_context("spawn"))
  pools = [PLAIN]
  try:
    return run_all(args, dev, rec, pools)
  finally:
    for pool in pools:
      pool.shutdown(wait=True, cancel_futures=True)


def run_all(args, dev, rec: dict, pools: list) -> int:
  """Every phase, in order; the card's worker pool joins `pools`, which
  main stops."""
  import numpy as np
  import torch
  from mujoco_mpc_torch.agent.agent import Agent
  from mujoco_mpc_torch.ops import _cuda_build
  from mujoco_mpc_torch.ops import megarollout as MR
  from mujoco_mpc_torch.physics import io as phys_io
  from mujoco_mpc_torch.physics import tilestep
  from mujoco_mpc_torch.planners import sampling
  from mujoco_mpc_torch.tasks import humanoid
  from mujoco_mpc_torch.tasks import registry
  from mujoco_mpc_torch.tasks import rubik

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
  #      precision, the uncontracted witnesses and each tier's float
  #      kernel with its phase counters, the nvcc processes at once, each
  #      checked against its ctypes mirror; the plain version's workers
  #      start meanwhile
  warm = [PLAIN.submit(_worker_warm) for _ in range(PLAIN_WORKERS)]
  t = time.perf_counter()
  card_libs = [(i, double, True) for i in range(len(MR.TIERS))
               for double in (False, True)]
  libs = _cuda_build.build_all(
      card_libs + [(i, False, False) for i in range(len(MR.TIERS))]
      + [(i, False, True, True) for i in range(len(MR.TIERS))]
      + [(0, True, False)])
  for tier in MR.TIERS:
    for dt in (torch.float32, torch.float64):
      MR._library(tier, dt)
  rec["build_s"] = time.perf_counter() - t
  check(all(w.result() for w in warm), "the plain version's workers")
  # E's float64 updates on the CPU start now, in the workers
  e_jobs = submit_estimator_holds()
  print(f"[2] built {len(libs)} libraries ({2 * len(libs)} kernel instances;"
        f" {len(MR.TIERS)} pairs of them uncontracted float witnesses, "
        f"{len(MR.TIERS)} pairs with phase counters, one pair the small "
        f"tier's uncontracted double for D2) in {rec['build_s']:.2f} s")
  rec["ptxas"] = {}
  for i, so in enumerate(libs):
    entries = ptxas_entries(so.with_suffix(".log").read_text())
    rec["ptxas"][so.name] = entries
    print(f"    {so.name}:")
    for e in entries:
      print(f"      {e['kernel']}: {e['registers']} registers, "
            f"{e['stack']} bytes stack frame, {e['spill_stores']} bytes "
            f"spill stores, {e['spill_loads']} spill loads, "
            f"{e['smem']} bytes static shared (the working set is dynamic "
            f"shared memory, sized per launch)")
      if i < len(card_libs):  # the instances the card runs
        check(e["stack"] < 8192, f"{so.name} {e['kernel']}: a "
              f"{e['stack']}-byte stack frame (the working set belongs in "
              f"shared memory)")

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
  got3 = mr.returns(home, v0, acts, task.params, t0)
  ms_small = timed_cuda(
      lambda: mr.returns(home, v0, acts, task.params, t0), 3)
  jobs3 = plain_submit(task, horizon, (home, v0, acts, task.params, t0), {},
                       torch.float32)

  def finish3():
    (want,), plain_small = jobs3.get()
    rel, max_abs = agreement(got3, want, f"returns {n}x{horizon}")
    print(f"[3] returns {n}x{horizon}: max rel err {rel:.3g} (tol 2e-3), "
          f"max abs err {max_abs:.3g}; diverging candidate: kernel "
          f"{float(got3[7]):g}, plain {float(want[7]):g}; kernel "
          f"{ms_small:.3f} ms, plain {plain_small:.1f} ms (on the card, "
          f"beside {CARD_WORKERS - 1} more plain runs)")
    check(float(got3[7]) == float(want[7]) == MR.MAX_RETURN,
          "divergence guard")
    rec.update(returns_rel_err=rel, returns_abs_err=max_abs,
               kernel_ms_256x20=ms_small, plain_ms_256x20=plain_small)

  DEFERRED.append(finish3)

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
  got5 = planner.mega.returns(home, v0, acts, task.params, t0)
  ms_big = timed_cuda(
      lambda: planner.mega.returns(home, v0, acts, task.params, t0), 3)
  jobs5 = plain_submit(task, 80, (home, v0, acts, task.params, t0), {},
                       torch.float32)
  rec.update(plan_steps_per_s=steps_s, plan_hz=reps / wall,
             optimize_ms=per_call, kernel_ms_1024x80=ms_big)
  rec["walker_bench"] = {"geometry": planner.mega.geometry(1024)}
  print(f"[5] launch geometry at 1024x80: {rec['walker_bench']['geometry']}")

  # ---- P. where a step's cycles go: the same returns through the
  #      profiling build (the Humanoid's and Allegro's in 5h and 5a)
  rec["walker_bench"]["phases"] = phase_breakdown(
      "Walker", planner.mega, (home, v0, acts, task.params, t0), {})

  def finish5():
    (plain,), plain_big = jobs5.get()
    rel5, abs5 = agreement(got5, plain, "returns 1024x80")
    print(f"[5] SamplingPlanner 1024x80 at dt "
          f"{float(task.model.opt.timestep):g}: {steps_s:.0f} steps/s, "
          f"{reps / wall:.2f} plan Hz; optimize ms median {q[0]:.3f}, "
          f"p66.7 {q[1]:.3f}, max {q[2]:.3f} (n={reps}); kernel "
          f"{ms_big:.3f} ms/call, plain {plain_big:.1f} ms (on the card, "
          f"beside {CARD_WORKERS - 1} more plain runs); kernel vs plain max "
          f"rel err {rel5:.3g} (tol 2e-3), max abs err {abs5:.3g}")
    rec.update(returns_rel_err_1024x80=rel5, returns_abs_err_1024x80=abs5,
               plain_ms_1024x80=plain_big)

  DEFERRED.append(finish5)

  ops_w = step_ops(registry.get_task("Walker", device="cpu"))
  bound_w, by_w = bound(ops_w, 1024, 80, task)
  print(f"[5] plain Walker step at B=1: {ops_w} operations; bound at "
        f"1024x80 {bound_w:.4f} ms ({by_w}); kernel at "
        f"{100 * bound_w / ms_big:.4f} % of it")
  rec.update(walker_step_ops=ops_w, walker_bound_ms=bound_w)
  rows = [lambda: {
      "name": "megarollout_returns[walker]", "route": "cuda",
      "source": "mujoco_mpc_torch/csrc/megarollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/megarollout.py:339",
      "launches": drive["launches"],
      "max_abs_err": rec["returns_abs_err_1024x80"],
      "ms": ms_big, "plain_ms": rec["plain_ms_1024x80"],
      "bound_ms": bound_w, "bound_by": by_w, "library_ms": None,
      **geometry_keys(rec["walker_bench"]),
      "err_over_tol": max(rec["returns_rel_err"], drive["returns_rel_err"],
                          rec["returns_rel_err_1024x80"]) / 2e-3}]

  timeline("Humanoid")
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
                    lambda dt: {}, reps, Hold(POPULATION, PER_CANDIDATE),
                    profile=True)
  rec["humanoid_bench_256x67"] = b5h
  rows.append(lambda: {
      "name": "megarollout_returns[humanoid]", "route": "cuda",
      "source": "mujoco_mpc_torch/csrc/megarollout.cu",
      "replaces": "mujoco_mpc_tpu/ops/megarollout.py:339",
      "launches": hdrive["launches"], "max_abs_err": hdrive["returns_abs_err"],
      "ms": b5h["kernel_ms"], "plain_ms": b5h["plain_ms"],
      "bound_ms": b5h["bound_ms"], "bound_by": b5h["bound_by"],
      "library_ms": None, **geometry_keys(b5h),
      "err_over_tol": max(hdrive["err_over_tol"], b5h["err_over_tol"])})

  for run in (run_quadruped, run_shadow, run_handover, run_allegro,
              run_cem, run_small_tasks, run_flat_tasks):
    timeline(run.__name__)
    made = run(dev, rec) if run is run_cem else run(dev, rec, reps)
    rows += made if isinstance(made, list) else [made]
  rec["card_s"] = timeline("every phase's work on the card done; the "
                           "comparisons with the plain version as their "
                           "returns come in")
  pools.append(run_card_queue())
  # ---- G4's, M's, D1-D3's and E1-E2's float64 holds, which time nothing,
  #      while the plain version's float32 runs share the card
  timeline("the float64 holds of G4, M, D1-D3 and E1-E2")
  flat_first_plans(dev, rec)
  mesh_holds(dev, rec)
  derivative_holds(dev, rec)
  estimator_holds(dev, rec, e_jobs)
  timeline("waiting for the plain version's returns")
  resolve_deferred()
  timeline("every comparison with the plain version held")

  # ---- G. the general engine and the closed loop, on a quiet host
  timeline("the general engine")
  run_general(dev, rec)
  # ---- G4. the flat-ground tasks' closed loops
  timeline("the flat-ground tasks' closed loops")
  run_flat_loops(dev, rec)
  # ---- M. Bimanual Insert's and Quadruped Hill's closed loops
  timeline("the mesh and heightfield tasks' closed loops")
  run_mesh_loops(dev, rec)
  # ---- D. every planner, and the derivative planners' rates
  timeline("the planners")
  run_derivative(dev, rec)
  # ---- E. the estimators' rates, and the estimate-driven loop
  timeline("the estimators")
  run_estimation(dev, rec, e_jobs)
  # ---- S. the serving edge: the gRPC services on the card
  timeline("the serving edge")
  serving_edge(dev, rec)
  # ---- SH. the sharded planners and the rest of the Agent's constructor
  timeline("the sharded planners")
  rows.append(run_sharded(dev, rec))
  # ---- N. the names taken over from the JAX package last
  timeline("the names")
  run_names(dev, rec)
  # ---- X. the edges: interface and C ABI, checkpoint, profiling, CLI,
  #      drive and dashboard on the card
  timeline("the edges")
  run_edges(dev, rec)
  kernels = {"kernels": [row() for row in rows]}
  loops = rec["general"]["G3"]
  for row in kernels["kernels"]:
    for name, tag in (("Walker", "walker"), ("Quadruped Flat", "quadruped"),
                      ("Cartpole", "cartpole")):
      if row["name"] == f"megarollout_returns[{tag}]":
        row["closed_loop_launches"] = loops[name]["launches"]
    if row["name"] == "megarollout_returns[cartpole]":
      e3 = rec["estimation"]["E3"]
      row["from_estimate_launches"] = {"launches": e3["launches"],
                                       "plans": e3["plans"]}
    if row["name"] == "megarollout_returns[walker]":
      row["rpc_planner_step_launches"] = rec["serving"][
          "planner_step_launches"]
      x = rec["edges"]
      row["interface_launches"] = x["X1"]["launches"]
      row["capi_ran"] = x["X2"]["ran"]
      row["dashboard_launches"] = {"sampling": x["X7"]["launches"][0],
                                   "cross_entropy": x["X7"]["launches"][1]}
      row["planner_launches"] = {
          name: res["launches"]
          for name, res in rec["derivative"]["D2"].items()}

  # ---- P. the device's busy share at two Agents' plan loops, on a quiet
  #      host (the plain version's workers are done), and Nsight Compute
  #      where it runs
  rec["busy"] = {}
  for name in ("Walker", "Rubik Faces"):
    pagent = Agent(name, device=dev, planner="sampling")
    try:
      pagent.reset("home")
    except KeyError:
      pagent.reset()
    if name == "Rubik Faces":
      pagent.set_state(userdata=rubik.faces_userdata(
          pagent.task.model.nuserdata, RUBIK_TARGETS))
    b = rec["busy"][name] = busy_share(pagent)
    share = ("not measured (the profiler recorded no device events)"
             if b["busy_share"] is None else f"{100 * b['busy_share']:.2f} %")
    print(f"[P] Agent('{name}') 5 planner_steps: wall {b['wall_ms']:.3f} ms, "
          f"{b['device_events']} device events, busy {b['busy_ms']:.3f} ms: "
          f"busy share {share}")
  rec["ncu"] = ncu_probe()
  rec["total_s"] = time.perf_counter() - T_START
  rec["t"] = TIMELINE
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
