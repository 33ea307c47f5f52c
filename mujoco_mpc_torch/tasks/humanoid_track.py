"""Humanoid Track: the humanoid tracks marker clips interpolated at 30
fps (reference: mjpc/tasks/humanoid/tracking/tracking.cc:28-141,190-195).

Counterpart of mujoco_mpc_tpu/tasks/humanoid_track.py ("Humanoid Track")
on dm_suite.build_humanoid_track. The clips are six markers' world
positions (pelvis, torso, feet, lower arms): two procedural gaits, Walk
and Run, and the recorded clips of tasks/models/assets/clips/*.npz (the
JAX package's files, copied), padded to a common length. userdata[
MODE_SLOT] picks the clip, userdata[0] holds the time the clip started;
`transition` re-anchors it after a reset or past the clip's end. Its 81
residual entries exceed the CUDA kernel's maximum, so the task plans
through the general rollout (ROADMAP queue 2 item 1).

Residual layout, 81 entries: JointVel (nv - 6), Control (nu) (ctrl less
the home keyframe's), AvgPos (3) (the clip's marker mean less the
body's), MarkerPos (18) (each marker about its mean, clip less body),
MarkerVel (18) (the clip's finite-difference velocity less each marker
body's centre-of-mass velocity). The clip's frame index is taken in
float32, as the JAX package takes it.
"""

from __future__ import annotations

import functools
import glob
import os

import numpy as np
import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.physics import sensors
from mujoco_mpc_torch.tasks import base, dm_suite, registry

_FPS = 30.0
_MARKERS = ("pelvis", "torso", "right_foot", "left_foot",
            "right_lower_arm", "left_lower_arm")
_NM = len(_MARKERS)
_CLIP_DIR = os.path.join(os.path.dirname(__file__), "models", "assets",
                         "clips")


def _synth_clip(speed, cadence, step_len, length):
  """A procedural gait's markers (length, 6, 3) at 30 fps, placed for the
  dm_control humanoid at its home keyframe."""
  t = np.arange(length) / _FPS
  phase = 2 * np.pi * cadence * t
  x0 = speed * t
  clip = np.zeros((length, _NM, 3))
  clip[:, 0] = np.stack([x0, 0 * t, 0.86 + 0.02 * np.cos(2 * phase)], -1)
  clip[:, 1] = np.stack([x0, 0 * t, 1.28 + 0.02 * np.cos(2 * phase)], -1)
  amp = 0.5 * step_len
  lift = 0.05 + 0.05 * (speed > 1.5)
  for i, (sgn, ph) in enumerate(((-1, 0.0), (1, np.pi))):
    s = np.sin(phase + ph)
    swing = np.maximum(np.sin(phase + ph), 0.0)
    clip[:, 2 + i] = np.stack([
        x0 + amp * s, sgn * 0.09 * np.ones_like(t), 0.03 + lift * swing], -1)
  for i, (sgn, ph) in enumerate(((-1, np.pi), (1, 0.0))):
    s = np.sin(phase + ph)
    clip[:, 4 + i] = np.stack([
        x0 + 0.18 + 0.3 * amp * s, sgn * 0.35 * np.ones_like(t),
        1.16 + 0.02 * s], -1)
  return clip


def _load_clip_files():
  """(name, markers (L, 6, 3)) of each recorded clip, resampled to 30 fps
  where recorded at another rate."""
  out = []
  for path in sorted(glob.glob(os.path.join(_CLIP_DIR, "*.npz"))):
    z = np.load(path, allow_pickle=False)
    markers = np.asarray(z["markers"], dtype=np.float64)
    if markers.ndim != 3 or markers.shape[1] != _NM:
      continue
    fps = float(z["fps"]) if "fps" in z else _FPS
    if abs(fps - _FPS) > 1e-6:
      t_src = np.arange(markers.shape[0]) / fps
      t_dst = np.arange(int(t_src[-1] * _FPS) + 1) / _FPS
      res = np.empty((len(t_dst),) + markers.shape[1:])
      for k in range(_NM):
        for c in range(3):
          res[:, k, c] = np.interp(t_dst, t_src, markers[:, k, c])
      markers = res
    name = (str(z["name"]) if "name" in z
            else os.path.splitext(os.path.basename(path))[0])
    out.append((name.title(), markers))
  return out


@functools.cache
def clip_table():
  """(the mode names, the clips padded with their last frames to a common
  length (nclip, L, 6, 3), their lengths (nclip,)): Walk and Run, then the
  recorded clips, read on first use."""
  files = _load_clip_files()
  clips = [_synth_clip(1.0, 1.4, 0.5, 180),
           _synth_clip(2.5, 2.6, 0.9, 120)] + [c for _, c in files]
  longest = max(c.shape[0] for c in clips)
  table = np.stack([
      np.concatenate([c, np.repeat(c[-1:], longest - len(c), 0)])
      for c in clips])
  return (tuple(["Walk", "Run"] + [n for n, _ in files]), table,
          np.asarray([c.shape[0] for c in clips], np.int64))


def __getattr__(name):
  """MODE_NAMES, the clips' names (clip_table()[0]): read on first use,
  so that importing the module opens no file."""
  if name == "MODE_NAMES":
    return clip_table()[0]
  raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _clip_id(model, u, like):
  """The clip index of userdata[MODE_SLOT], truncated and then taken as
  a JAX gather takes an index: a negative one from the end, one past the
  table clamped."""
  n = len(clip_table()[2])
  cid = u[base.MODE_SLOT].to(torch.int32).to(torch.int64)
  cid = torch.where(cid < 0, cid + n, cid)
  return torch.clamp(cid, 0, n - 1).expand(like.shape)


def _interp_frames(model, clip_id, index, dtype):
  """The clip's markers at the float32 frame index (linear between
  frames, tracking.cc:29-39) and its finite-difference velocity, each
  (6, 3, ...) in dtype."""
  dev = index.device
  table = model.const(("track_clips", dtype, dev), lambda: torch.as_tensor(
      clip_table()[1], dtype=dtype, device=dev))
  length = model.const(("track_len", dev), lambda: torch.as_tensor(
      clip_table()[2], device=dev))
  max_index = (length[clip_id] - 1).to(torch.float32)
  idx = torch.minimum(torch.maximum(index, torch.zeros_like(index)),
                      max_index)
  i0 = torch.floor(idx).to(torch.int64)
  i1 = torch.minimum(i0 + 1, max_index.to(torch.int64))
  w1 = idx - i0.to(torch.float32)
  f0, f1 = table[clip_id, i0], table[clip_id, i1]  # (..., 6, 3)
  if index.dim():
    f0, f1 = torch.movedim(f0, 0, -1), torch.movedim(f1, 0, -1)
  pos = (1.0 - w1).to(dtype) * f0 + w1.to(dtype) * f1
  return pos, (f1 - f0) * _FPS


def residual(model, data, params):
  """Residual (81, B) on the component-leading, batch-trailing view; the
  view's `time` is the clip's clock."""
  dtype = data.qpos.dtype
  u = data.userdata
  index = ((data.time - u[0]) * _FPS).to(torch.float32)
  index = index.expand(data.qpos.shape[1:])
  ref_pos, ref_vel = _interp_frames(model, _clip_id(model, u, index), index,
                                    dtype)
  ids = [model.body(n) for n in _MARKERS]
  cur_pos = torch.stack([data.xpos[i] for i in ids])
  cur_vel = torch.stack([data.cvel[i][3:] + sensors.cross0(
      data.cvel[i][:3], data.xipos[i]) for i in ids])
  home = base.const_column(model, "track_home_ctrl", base.home_ctrl(model),
                           data.ctrl)
  avg_ref = torch.mean(ref_pos, dim=0)
  avg_cur = torch.mean(cur_pos, dim=0)
  centered = (ref_pos - avg_ref) - (cur_pos - avg_cur)
  return torch.cat([
      data.qvel[6:], data.ctrl - home, avg_ref - avg_cur,
      centered.reshape((3 * _NM,) + centered.shape[2:]),
      (ref_vel - cur_vel).reshape((3 * _NM,) + centered.shape[2:]),
  ])


def transition(model, data, params):
  """Re-anchor the clip (userdata[0] to the current time) after a jump
  back in time or past the clip's end, which loops it."""
  u = data.userdata
  dev = u.device
  length = model.const(("track_len", dev), lambda: torch.as_tensor(
      clip_table()[2], device=dev))
  cid = _clip_id(model, u, u[0])
  span = (length[cid] - 1).to(u.dtype) / _FPS
  elapsed = data.time - u[0]
  re_anchor = (elapsed < 0.0) | (elapsed > span)
  start = torch.where(re_anchor, data.time, u[0]).to(u.dtype)
  return data.replace(userdata=torch.cat([start[None], u[1:]]))


@registry.register("Humanoid Track", snapshot="humanoid_track",
                   builder=dm_suite.build_humanoid_track)
def make(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model(
      "humanoid_track", dtype, device)
  return base.Task(name="Humanoid Track", model=model, spec=spec,
                   params=params, residual=residual, param_names=pnames,
                   transition=transition, mode_names=clip_table()[0])
