"""One planner's plan time in two checkouts of the repository, compared in
one call: each tree's plans run in a fresh subprocess whose PYTHONPATH is
that tree, in the order A, B, B, A, so that a drift of the host shows on
both sides.

Usage:
  python -m mujoco_mpc_torch.tools.plan_ab TREE_A TREE_B \\
      [--task Walker] [--planner ilqg] [--plans 3] [--device cuda]

Each run plans once to warm up, then times --plans plans, each ending in
a synchronize of the device. Prints each run's milliseconds, each tree's
median, and on the card its name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

_CHILD = r"""
import json, sys, time
import torch
from mujoco_mpc_torch.agent.agent import Agent
task, planner, plans, device = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    sys.argv[4]
agent = Agent(task, planner=planner, device=device)
try:
  agent.reset("home")
except KeyError:
  agent.reset()


def sync():
  if device != "cpu":
    torch.cuda.synchronize()


agent.planner_step()
sync()
ms = []
for _ in range(plans):
  t = time.perf_counter()
  agent.planner_step()
  sync()
  ms.append((time.perf_counter() - t) * 1e3)
print(json.dumps(ms))
"""


def run(tree: str, task: str, planner: str, plans: int, device: str,
        timeout: float = 1800.0) -> list:
  """The plan milliseconds of one subprocess on `tree`."""
  tree = os.path.abspath(tree)
  out = subprocess.run(
      [sys.executable, "-c", _CHILD, task, planner, str(plans), device],
      cwd=tree, env={**os.environ, "PYTHONPATH": tree}, capture_output=True,
      text=True, timeout=timeout, check=True)
  return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("tree_a")
  ap.add_argument("tree_b")
  ap.add_argument("--task", default="Walker")
  ap.add_argument("--planner", default="ilqg")
  ap.add_argument("--plans", type=int, default=3)
  ap.add_argument("--device", default="cuda")
  args = ap.parse_args(argv)
  times = {args.tree_a: [], args.tree_b: []}
  for tree in (args.tree_a, args.tree_b, args.tree_b, args.tree_a):
    ms = run(tree, args.task, args.planner, args.plans, args.device)
    times[tree] += ms
    print(f"{tree}: {[round(x, 1) for x in ms]} ms", flush=True)
  for tree, ms in times.items():
    print(f"{tree}: median {statistics.median(ms):.1f} ms over {len(ms)} "
          f"plans ({args.task}, {args.planner})")
  if args.device != "cpu":
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
  return 0


if __name__ == "__main__":
  sys.exit(main())
