"""Figure surface: the reference GUI's live plots, rendered from a trace.

Counterpart of mujoco_mpc_tpu/tools/plots.py (numpy and matplotlib only;
matplotlib is imported inside plot_trace, since the card's host has none).
The reference draws four live figures in its GLFW app — per-term cost,
actions, planner improvement, and phase timers (mjpc/agent.cc:1004-1130,
AgentPlots). Headless equivalent: render the same figures to a PNG from a
TraceRecorder .npz plus (optionally) the agent's PhaseTimer report.

Usage:
  python -m mujoco_mpc_torch.tools.plots trace.npz --out figures.png
or programmatically: plot_trace("trace.npz", timer=agent_timer_report).
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def plot_trace(trace_path: str, out_path: str = "figures.png",
               timer: dict | None = None) -> str:
  import matplotlib
  matplotlib.use("Agg")
  import matplotlib.pyplot as plt

  z = np.load(trace_path, allow_pickle=False)
  meta = json.loads(str(z["meta"]))
  times = z["times"]
  n_panels = 3 + (1 if timer else 0)
  fig, axes = plt.subplots(1, n_panels, figsize=(5 * n_panels, 3.6))

  # --- cost terms (reference "cost" figure)
  ax = axes[0]
  terms = z["terms"]
  if terms.size:
    for k, name in enumerate(meta.get("term_names", [])[:terms.shape[1]]):
      ax.plot(times, terms[:, k], label=name, lw=1)
  ax.plot(times, z["cost"], "k--", label="total", lw=1.5)
  ax.set_title(f"{meta['task']} cost terms")
  ax.set_xlabel("time [s]")
  ax.legend(fontsize=6, ncol=2)

  # --- actions (reference "actions" figure)
  ax = axes[1]
  ctrl = z["ctrl"]
  for u in range(min(ctrl.shape[1], 12)):
    ax.plot(times, ctrl[:, u], lw=0.8)
  ax.set_title("actions")
  ax.set_xlabel("time [s]")

  # --- planner improvement (reference "improvement" figure)
  ax = axes[2]
  br = z["best_returns"]
  ax.plot(times, br, lw=1, label="best return")
  ax.plot(times, z["cost"], lw=1, label="realized cost")
  ax.set_title(f"planner ({meta['planner']}) improvement")
  ax.set_xlabel("time [s]")
  ax.legend(fontsize=7)

  # --- phase timers (reference "timer" figure)
  if timer:
    ax = axes[3]
    names = list(timer)
    vals = [timer[k] * 1e3 for k in names]
    ax.barh(range(len(names)), vals)
    ax.set_yticks(range(len(names)), names, fontsize=7)
    ax.set_xlabel("mean phase time [ms]")
    ax.set_title("timers")

  fig.tight_layout()
  fig.savefig(out_path, dpi=120)
  plt.close(fig)
  return out_path


def main():
  p = argparse.ArgumentParser(description="render trace figures")
  p.add_argument("trace")
  p.add_argument("--out", default="figures.png")
  args = p.parse_args()
  print(plot_trace(args.trace, args.out))


if __name__ == "__main__":
  main()
