"""Phase timers and device traces: the reference's planner timing plots,
headless.

Counterpart of mujoco_mpc_tpu/utils/profiling.py (reference wall-clock
timers around every planning phase, sampling/planner.cc:169-211, plotted in
the GUI's timer figure). PhaseTimer brackets host calls; a phase given the
device it ran on (`sync`) ends by waiting for that device's queued work (a
CUDA event, where JAX blocks until ready), so that its time is the
device's too. Each phase is also a torch.profiler range and, on the card,
an NVTX range of the same name. device_trace records a torch.profiler
trace (host and, on the card, CUDA activity) and writes it as a Chrome
trace, where the JAX package writes a jax.profiler trace.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict

import torch

from mujoco_mpc_torch import device as devices

TRACE_FILE = "trace.json"  # device_trace's file in its logdir


class PhaseTimer:
  """Accumulates per-phase wall times; thread-safe enough for the agent."""

  def __init__(self):
    self.totals: Dict[str, float] = collections.defaultdict(float)
    self.counts: Dict[str, int] = collections.defaultdict(int)

  @contextlib.contextmanager
  def phase(self, name: str, sync=None):
    """Time the block as phase `name`. `sync` is the device the block's
    work runs on: the phase ends when that work is done, and on a CUDA
    device the phase is an NVTX range too. None times the host alone."""
    nvtx = sync is not None and torch.device(sync).type == "cuda"
    t0 = time.perf_counter()
    if nvtx:
      torch.cuda.nvtx.range_push(name)
    try:
      with torch.profiler.record_function(name):
        yield
        if sync is not None:
          devices.wait(sync)
    finally:
      if nvtx:
        torch.cuda.nvtx.range_pop()
      self.totals[name] += time.perf_counter() - t0
      self.counts[name] += 1

  def report(self) -> Dict[str, Dict[str, float]]:
    return {
        name: {
            "total_s": self.totals[name],
            "count": self.counts[name],
            "mean_ms": 1e3 * self.totals[name] / max(self.counts[name], 1),
        }
        for name in sorted(self.totals)
    }

  def reset(self):
    self.totals.clear()
    self.counts.clear()


@contextlib.contextmanager
def device_trace(logdir: str, device=devices.DEFAULT):
  """torch.profiler over the block, host activity and, on a CUDA device,
  the card's; writes the Chrome trace logdir/TRACE_FILE at its end (the
  profiler object is yielded, for key_averages())."""
  device = devices.resolve(device)
  activities = [torch.profiler.ProfilerActivity.CPU]
  if device.type == "cuda":
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  os.makedirs(logdir, exist_ok=True)
  with torch.profiler.profile(activities=activities) as prof:
    yield prof
    devices.wait(device)
  prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
