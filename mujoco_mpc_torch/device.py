"""The port's default device: the card, unless the caller asks for the CPU.

Every entry point takes `device="cuda"` by default. The public ones
(Agent, registry.get_task, MegaRollout, physics.io.load_model and
load_snapshot) pass it through `resolve`, so that a host without a card
fails loudly instead of planning on the CPU; the helpers below them take
the device as given.
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device) -> torch.device:
  """torch.device for `device`, a CUDA device with its index (the current
  one if none is given); raises RuntimeError for a CUDA device on a host
  that has none."""
  device = torch.device(device)
  if device.type == "cuda":
    if not torch.cuda.is_available():
      raise RuntimeError(f"device {device} requested, but "
                         "torch.cuda.is_available() is False; pass "
                         "device='cpu' to run on the CPU")
    if device.index is None:
      device = torch.device("cuda", torch.cuda.current_device())
  return device


def wait(device) -> None:
  """Block the calling thread until the work it has queued on `device`'s
  current stream so far is done (a CUDA event; nothing on the CPU): a
  thread that publishes a result (a policy, an estimate) waits for it
  first, as JAX's loops block until ready, so that it does not run ahead
  and fill the stream that the other threads share."""
  device = torch.device(device)
  if device.type == "cuda":
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    event.synchronize()
