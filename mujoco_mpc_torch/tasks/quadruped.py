"""Quadruped locomotion with the reference's multi-gait FSM
(reference: mjpc/tasks/quadruped/quadruped.{h,cc}).

Counterpart of mujoco_mpc_tpu/tasks/quadruped.py, Quadruped Flat and
Quadruped Hill (the same task on a heightfield terrain): 5 gaits
(stand, walk, trot, canter, gallop) with per-foot phase signatures,
gait-dependent cost weights (`weight_mod`) and the modes Quadruped, Biped,
Walk, Scramble and Flip. The FSM state lives in userdata and the goal in
the mocap body, both rollout-constant operands of the planner's rollouts.
`transition` runs the FSM (automatic gait switching, the phase clock,
Walk's moving goal, Flip's entry and exit) before each Agent.step;
fsm_userdata holds it in a mode and gait instead.

Residual layout (quadruped.cc:33-228): Upright(3), Height(1), Position(3),
Gait(4), Balance(2), Effort(nu), Posture(nu), Orientation(2), Angmom(3).

userdata layout:
  [0] current gait        [1] phase at phase-start  [2] phase-start time
  [3] phase velocity      [4:6] filtered CoM vel    [6] gait-switch time
  [7] last transition t   [8] mode start time       [9:11] walk axis
  [11:13] walk heading    [13] walk speed           [14] walk angvel
  [15] requested mode (base.MODE_SLOT)              [16] accepted mode
  [17:21] torso quat at flip entry                  [21] ground z at flip
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from mujoco_mpc_torch import device as devices
from mujoco_mpc_torch.physics import collision, sensors
from mujoco_mpc_torch.physics.types import GeomType
from mujoco_mpc_torch.tasks import base, registry

# residual_quadruped and weight_mod_quadruped in csrc/megarollout.cu
DEVICE_RESIDUAL_ID = 3

# modes (reference A1Mode, quadruped.h:40-47)
(MODE_QUADRUPED, MODE_BIPED, MODE_WALK, MODE_SCRAMBLE,
 MODE_FLIP) = 0, 1, 2, 3, 4
MODE_NAMES = ("Quadruped", "Biped", "Walk", "Scramble", "Flip")

# gaits (reference A1Gait, quadruped.h:58-65)
GAIT_STAND, GAIT_WALK, GAIT_TROT, GAIT_CANTER, GAIT_GALLOP = range(5)

# foot order FL, FR, RL, RR; per-gait foot phase (quadruped.h:76-85)
_GAIT_PHASE = np.asarray([
    [0.00, 0.00, 0.00, 0.00],  # stand
    [0.00, 0.50, 0.75, 0.25],  # walk
    [0.00, 0.50, 0.50, 0.00],  # trot
    [0.00, 0.33, 0.33, 0.66],  # canter
    [0.00, 0.05, 0.40, 0.35],  # gallop
], np.float32)
# duty ratio, cadence (Hz), amplitude (m), balance w, upright w, height w
# (reference kGaitParam, quadruped.h:87-97)
_GAIT_PARAM = np.asarray([
    [1.00, 1.0, 0.00, 0.00, 1.0, 1.0],  # stand
    [0.75, 1.0, 0.03, 0.00, 1.0, 1.0],  # walk
    [0.45, 2.0, 0.03, 0.20, 1.0, 1.0],  # trot
    [0.40, 4.0, 0.05, 0.03, 0.5, 0.2],  # canter
    [0.30, 3.5, 0.10, 0.03, 0.2, 0.1],  # gallop
], np.float32)

_HEIGHT_QUADRUPED = 0.30  # torso height over feet
_HEIGHT_BIPED = 0.50
_FOOT_RADIUS = 0.02
_POSTURE_GAIN = np.asarray([2.0, 1.0, 1.0] * 4, np.float32)  # abd, hip, knee
_FEET = ("FL_foot", "FR_foot", "RL_foot", "RR_foot")
_FRONT = (1.0, 1.0, 0.0, 0.0)
# automatic gait switching (quadruped.h:99-103): CoM speed filter (s),
# least time between switches (s), and each gait's speed threshold
_AUTO_GAIT_FILTER = 0.2
_AUTO_GAIT_MIN_TIME = 1.0
_GAIT_AUTO = (0.0, 0.02, 0.02, 0.6, 2.0)
_MIN_ANGVEL = 0.01

# residual_params indices (XML custom numeric order)
_P_GAIT, _P_GAIT_SWITCH, _P_WALK_SPEED, _P_WALK_TURN = 0, 1, 2, 3
_P_BIPED_TYPE, _P_HEADING, _P_ARM_POSTURE, _P_FLIP_DIR = 4, 5, 6, 7

# cost term indices (XML sensor order)
_T_UPRIGHT, _T_HEIGHT, _T_BALANCE = 0, 1, 4

# Flip choreography (quadruped.cc:350-445, 682-720): crouch, leap, a 2 pi
# rotation in flight, land, as closed-form height and pitch trajectories
_G = 9.81
_CROUCH_HEIGHT = _HEIGHT_QUADRUPED * 0.6
_LEAP_HEIGHT = _HEIGHT_QUADRUPED * 2.0
_MAX_HEIGHT = _HEIGHT_QUADRUPED * 3.2
_JUMP_VEL = math.sqrt(2 * _G * (_MAX_HEIGHT - _LEAP_HEIGHT))
_FLIGHT_TIME = 2 * _JUMP_VEL / _G
_JUMP_ACC = _JUMP_VEL ** 2 / (2 * (_LEAP_HEIGHT - _CROUCH_HEIGHT))
_CROUCH_TIME = math.sqrt(2 * (_HEIGHT_QUADRUPED - _CROUCH_HEIGHT) / _JUMP_ACC)
_LEAP_TIME = _JUMP_VEL / _JUMP_ACC
_JUMP_TIME = _CROUCH_TIME + _LEAP_TIME
_CROUCH_VEL = -_JUMP_ACC * _CROUCH_TIME
_LAND_TIME = 2 * (_LEAP_HEIGHT - _HEIGHT_QUADRUPED) / _JUMP_VEL
_LAND_ACC = _JUMP_VEL / _LAND_TIME
_FLIGHT_ROT_VEL = 1.25 * math.pi / _FLIGHT_TIME
_JUMP_ROT_VEL = math.pi / _LEAP_TIME - _FLIGHT_ROT_VEL
_JUMP_ROT_ACC = (_FLIGHT_ROT_VEL - _JUMP_ROT_VEL) / _LEAP_TIME
_LAND_ROT_ACC = (2 * (_FLIGHT_ROT_VEL * _LAND_TIME - math.pi / 4) /
                 (_LAND_TIME ** 2))
_FLIP_TOTAL_TIME = _JUMP_TIME + _FLIGHT_TIME + _LAND_TIME
# the same constants for residual_quadruped, as the Python expressions
# below form them
_DEVICE_FLIP = (_CROUCH_VEL, 0.5 * _JUMP_ACC, _JUMP_TIME, _LEAP_HEIGHT,
                _JUMP_VEL, 0.5 * _G, _FLIGHT_TIME, 0.5 * _LAND_ACC,
                _JUMP_TIME + _FLIGHT_TIME, _FLIP_TOTAL_TIME, _CROUCH_TIME,
                0.5 * _JUMP_ROT_ACC, _JUMP_ROT_VEL, _FLIGHT_ROT_VEL,
                0.5 * _LAND_ROT_ACC)


def _flip_height(ft):
  """Target torso height over the ground during the flip (FlipHeight,
  quadruped.cc:682-697); ft = time since the flip started."""
  h_jump = (_HEIGHT_QUADRUPED + ft * _CROUCH_VEL +
            0.5 * _JUMP_ACC * ft * ft)
  tf = ft - _JUMP_TIME
  h_flight = _LEAP_HEIGHT + _JUMP_VEL * tf - 0.5 * _G * tf * tf
  tl = ft - _JUMP_TIME - _FLIGHT_TIME
  h_land = _LEAP_HEIGHT - _JUMP_VEL * tl + 0.5 * _LAND_ACC * tl * tl
  h = torch.where(ft < _JUMP_TIME, h_jump,
                  torch.where(ft < _JUMP_TIME + _FLIGHT_TIME, h_flight,
                              h_land))
  return torch.where(ft >= _FLIP_TOTAL_TIME,
                     torch.full_like(h, _HEIGHT_QUADRUPED), h)


def _flip_angle(ft):
  """Target pitch rotation during the flip (FlipQuat, cc:702-720)."""
  tc = ft - _CROUCH_TIME
  a_jump = 0.5 * _JUMP_ROT_ACC * tc * tc + _JUMP_ROT_VEL * tc
  a_jump = torch.where(ft < _CROUCH_TIME, torch.zeros_like(a_jump), a_jump)
  tf = ft - _JUMP_TIME
  a_flight = 0.5 * math.pi + _FLIGHT_ROT_VEL * tf
  tl = ft - _JUMP_TIME - _FLIGHT_TIME
  a_land = (1.75 * math.pi + _FLIGHT_ROT_VEL * tl -
            0.5 * _LAND_ROT_ACC * tl * tl)
  a = torch.where(ft < _JUMP_TIME, a_jump,
                  torch.where(ft < _JUMP_TIME + _FLIGHT_TIME, a_flight,
                              a_land))
  return torch.where(ft >= _FLIP_TOTAL_TIME, torch.full_like(a, 2 * math.pi),
                     a)


def _get_phase(u, time):
  """Internal phase clock (quadruped.cc:628-631)."""
  return u[1] + (time - u[2]) * u[3]


def _sel_scalar(table, gait, col, like):
  """table[gait, col] as a sum of selects, in the dtype of `like`; 0 for a
  gait outside the table."""
  out = None
  for g in range(table.shape[0]):
    term = torch.where(gait == g, float(table[g, col]), 0.0).to(like.dtype)
    out = term if out is None else out + term
  return out


def _floor_mod(x, y: float):
  """jnp.mod: the remainder with the sign of y (fmod, then shifted)."""
  r = torch.fmod(x, y)
  return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _step_height(time, footphase, duty_ratio):
  """Normalized target step height (quadruped.cc:659-668)."""
  angle = _floor_mod(time + math.pi - footphase, 2 * math.pi) - math.pi
  angle = angle * 0.5 / torch.clamp(1.0 - duty_ratio, min=1e-6)
  value = torch.cos(torch.clamp(angle, -math.pi / 2, math.pi / 2))
  value = torch.where(duty_ratio < 1.0, value, torch.zeros_like(value))
  return torch.where(torch.abs(value) < 1e-6, torch.zeros_like(value), value)


def _ground_under(model, data, points):
  """Terrain height under the points (N, 3, B), the reference's Ground()
  raycast (JAX quadruped.py:213-230): 0 on a flat model; on Quadruped
  Hill the bilinear surface of the heightfield geom, the same sample as
  its collision pairs (physics/collision.py::hfield_sample), batched
  over the points and candidates."""
  hfield = [g for g, t in enumerate(model.geom_type) if t == GeomType.HFIELD]
  if not hfield:
    return torch.zeros_like(points[:, 0])
  g = hfield[0]
  hp, hm = data.geom_xpos[g], data.geom_xmat[g]  # (3, B), (3, 3, B)
  rel = points - hp[None]
  lx, ly = (sum(hm[k, i] * rel[:, k] for k in range(3)) for i in range(2))
  h, _, _ = collision.hfield_sample(model.hfield_data.to(points.dtype),
                                    model.hfield_size.to(points.dtype),
                                    lx, ly)
  return hm[2, 0] * lx + hm[2, 1] * ly + hm[2, 2] * h + hp[2]


def _gait_of(u, mode):
  """Active gait (a biped always trots, quadruped.cc:652-656)."""
  return torch.where(mode == MODE_BIPED, GAIT_TROT, u[0].to(torch.int32))


def residual(model, data, params):
  """Residual (42, B); `data` fields are component-leading, batch-trailing
  (the tile view of physics/tilestep.py::step_tb), userdata and mocap poses
  with a trailing axis of 1."""
  dtype = data.qpos.dtype
  u = data.userdata
  mode = u[16].to(torch.int32)
  trunk = model.body("trunk")

  foot_pos = torch.stack([data.geom_xpos[model.geom(f)] for f in _FEET])
  avg_foot = torch.mean(foot_pos, dim=0)
  torso_xmat = data.xmat[trunk]
  torso_pos = data.xipos[trunk]
  goal = data.mocap_pos[0]
  head = data.site_xpos[model.site("head")]
  biped = mode == MODE_BIPED
  flip = mode == MODE_FLIP
  scramble = mode == MODE_SCRAMBLE

  # ---------- Upright (quadruped.cc:53-72)
  handstand = torch.where(params[_P_BIPED_TYPE] > 0.5, -1.0, 1.0).to(dtype)
  up_quad = torso_xmat[2, 2] - 1.0
  up_biped = torso_xmat[2, 0] - handstand
  upright0 = torch.where(biped, up_biped, up_quad)
  zero = upright0 * 0.0
  upright = torch.stack([upright0, zero, zero])
  # Flip: the orientation tracks the pitch trajectory,
  # torso_xquat - (q_start * rot_y(angle))
  flip_time = data.time - u[8] + zero
  angle = _flip_angle(flip_time)
  # Quadruped Hill's MJCF has no Flip dir parameter: JAX's gather clamps
  # the index to the last one there (Arm posture), and so does the port
  flip_dir = params[min(_P_FLIP_DIR, params.shape[0] - 1)]
  flip_axis_y = torch.where(flip_dir > 0.5, 1.0, -1.0).to(dtype)
  half = 0.5 * angle
  dq = torch.stack([torch.cos(half), zero,
                    flip_axis_y * torch.sin(half) + zero, zero])
  q_start = u[17:21] + torch.stack([zero] * 4)  # saved at flip entry
  q_target = sensors.quat_mul0(q_start, dq)
  torso_xquat = data.xquat[trunk]
  upright_flip = sensors.quat_sub0(torso_xquat + torch.stack([zero] * 4),
                                   q_target)
  upright = torch.where(flip, upright_flip, upright)

  # ---------- Height (quadruped.cc:75-89)
  height_goal = torch.where(biped, torch.full_like(u[16], _HEIGHT_BIPED),
                            torch.full_like(u[16], _HEIGHT_QUADRUPED))
  height = (torso_pos[2] - avg_foot[2]) - height_goal
  height = torch.where(scramble, 0.0, height)
  # Flip: the torso height tracks the jump over the saved ground u[21]
  height = torch.where(flip, torso_pos[2] - (u[21] + _flip_height(flip_time)),
                       height)

  # ---------- Position (quadruped.cc:92-108): head to the goal
  pos_xy = head[:2] - (goal[:2] + zero)
  pos_z = torch.where(scramble, 2.0 * (head[2] - goal[2]), 0.0).to(dtype)
  position = torch.cat([pos_xy, (pos_z + zero)[None]])

  # ---------- Gait (quadruped.cc:110-146)
  gait = _gait_of(u, mode)
  duty = _sel_scalar(_GAIT_PARAM, gait, 0, u)
  amplitude = _sel_scalar(_GAIT_PARAM, gait, 2, u)
  phase = _get_phase(u, data.time)
  footphase = 2 * math.pi * torch.stack(
      [_sel_scalar(_GAIT_PHASE, gait, c, u) for c in range(4)])
  step = amplitude * _step_height(phase, footphase, duty)
  # scramble: the query point moves toward the goal (quadruped.cc:126-135)
  to_goal = (goal + foot_pos * 0.0) - foot_pos  # (4, 3, B)
  to_goal = torch.stack([to_goal[:, 0], to_goal[:, 1], to_goal[:, 2] * 0.0],
                        dim=1)
  to_goal = to_goal / torch.clamp(
      torch.sqrt(torch.sum(to_goal * to_goal, dim=1, keepdim=True)),
      min=1e-9)
  query = torch.where(scramble, foot_pos + 0.15 * to_goal, foot_pos)
  ground = _ground_under(model, data, query)
  height_target = ground + _FOOT_RADIUS + step
  hdiff = foot_pos[:, 2] - height_target
  hdiff = torch.where(scramble, torch.clamp(hdiff, max=0.0), hdiff)
  gait_res = torch.where(step != 0.0, hdiff, torch.zeros_like(hdiff))
  # biped: the "hands" (front feet, or hind feet in a handstand) are free
  rows = []
  for i in range(4):
    hand = torch.where(params[_P_BIPED_TYPE] > 0.5, 1.0 - _FRONT[i],
                       _FRONT[i])
    rows.append(torch.where(biped & (hand > 0.5), 0.0, gait_res[i]))
  gait_res = torch.stack(rows)

  # ---------- Balance: capture point (quadruped.cc:149-156)
  compos = data.subtree_com[trunk]
  comvel = sensors.subtree_linvel(model, data, trunk)
  fall_time = torch.sqrt(2.0 * height_goal / 9.81)
  capture = compos[:2] + fall_time * comvel[:2]
  balance = capture - avg_foot[:2]

  # ---------- Effort (quadruped.cc:158-160)
  effort = 2e-2 * data.actuator_force

  # ---------- Posture (quadruped.cc:163-202)
  home = np.asarray(model.keyframe("home")[0], np.float32)
  arm_scale = params[_P_ARM_POSTURE]
  rows = []
  for i in range(12):
    p = (data.qpos[7 + i] - float(home[7 + i])) * float(_POSTURE_GAIN[i])
    arm = torch.where(params[_P_BIPED_TYPE] > 0.5, 1.0 - _FRONT[i // 3],
                      _FRONT[i // 3])
    rows.append(torch.where(biped & (arm > 0.5), p * arm_scale, p))
  posture = torch.stack(rows)

  # ---------- Orientation / yaw (quadruped.cc:205-216)
  head_quad = torch.stack([torso_xmat[0, 0], torso_xmat[1, 0]])
  head_biped = handstand * torch.stack([torso_xmat[0, 2], torso_xmat[1, 2]])
  heading = torch.where(biped, head_biped, head_quad)
  heading = heading / torch.clamp(
      torch.sqrt(torch.sum(heading * heading, dim=0)), min=1e-9)
  hgoal = params[_P_HEADING]
  orientation = torch.stack([heading[0] - torch.cos(hgoal),
                             heading[1] - torch.sin(hgoal)])

  # ---------- Angular momentum (quadruped.cc:219-222)
  angmom = sensors.subtree_angmom(model, data, trunk)

  return torch.cat([
      upright, (height + zero)[None], position, gait_res, balance, effort,
      posture, orientation.to(dtype), angmom,
  ])


def weight_mod(model, data, params):
  """Gait-dependent Balance/Upright/Height weights (the reference's
  Transition weight writes, quadruped.cc:291-302): a (9, ...) multiplier.
  Flip multiplies every weight against the XML defaults: Upright 1 to 0.2,
  Height 1 to 5, Position/Gait/Balance to 0, Effort 0.03 to 0.005, Posture
  0.02 to 0.1 (quadruped.cc:366-376)."""
  u = data.userdata
  mode = u[16].to(torch.int32)
  gait = _gait_of(u, mode)
  one = (u[0] * 0.0) + 1.0
  rows = [one] * 9
  rows[_T_BALANCE] = _sel_scalar(_GAIT_PARAM, gait, 3, u) + 0.0 * one
  rows[_T_UPRIGHT] = _sel_scalar(_GAIT_PARAM, gait, 4, u) + 0.0 * one
  rows[_T_HEIGHT] = _sel_scalar(_GAIT_PARAM, gait, 5, u) + 0.0 * one
  flip_scale = (0.2, 5.0, 0.0, 0.0, 0.0, 0.005 / 0.03, 0.1 / 0.02, 1.0, 1.0)
  rows = [torch.where(mode == MODE_FLIP, s * one, r)
          for r, s in zip(rows, flip_scale)]
  return torch.stack(rows)


def transition(model, data, params):
  """The gait and mode FSM (reference TransitionLocked, quadruped.cc:
  229-390, as the JAX package has it): reset detection, the forbidden
  mode switches, Flip's entry (start time, torso orientation, ground
  height saved) and exit, automatic gait switching on the filtered CoM
  speed, phase continuity across a cadence change, and Walk's goal moving
  along a line or circle."""
  dtype = data.qpos.dtype
  u = list(torch.unbind(data.userdata, 0))
  t = data.time
  trunk = model.body("trunk")

  def where(c, a, b):
    return torch.where(c, a, b)

  # reset detection (quadruped.cc:230-238)
  is_reset = t < u[7]
  req = u[base.MODE_SLOT].to(torch.int32)
  cur = u[16].to(torch.int32)
  req = where(is_reset & (req != MODE_QUADRUPED) & (req != MODE_BIPED),
              MODE_QUADRUPED, req)
  u[1] = where(is_reset, t, u[1])
  u[2] = where(is_reset, t, u[2])
  # Walk and Flip only from Quadruped (quadruped.cc:240-248)
  req = where((req != cur) & (cur != MODE_QUADRUPED) &
              ((req == MODE_WALK) | (req == MODE_FLIP)), MODE_QUADRUPED, req)
  # Flip entry and exit (quadruped.cc:350-390)
  entering_flip = (req == MODE_FLIP) & (cur != MODE_FLIP)
  torso_xquat = data.xquat[trunk]
  u[8] = where(entering_flip, t, u[8])
  for i in range(4):
    u[17 + i] = where(entering_flip, torso_xquat[i], u[17 + i])
  ground_com = _ground_under(model, data, data.subtree_com[trunk][None])[0]
  u[21] = where(entering_flip, ground_com, u[21])
  flip_done = (req == MODE_FLIP) & ~entering_flip & (
      t - u[8] >= _FLIP_TOTAL_TIME)
  req = where(flip_done, MODE_QUADRUPED, req)
  # automatic gait switching (quadruped.cc:259-289)
  comvel = sensors.subtree_linvel(model, data, trunk)[:2]
  beta = torch.exp(-(t - u[7]) / _AUTO_GAIT_FILTER)
  u[4] = beta * u[4] + (1.0 - beta) * comvel[0]
  u[5] = beta * u[5] + (1.0 - beta) * comvel[1]
  speed = torch.sqrt(u[4] * u[4] + u[5] * u[5])
  auto_gait = where(
      speed <= _GAIT_AUTO[GAIT_TROT], GAIT_STAND,
      where(speed <= _GAIT_AUTO[GAIT_CANTER], GAIT_TROT,
            where(speed <= _GAIT_AUTO[GAIT_GALLOP], GAIT_CANTER,
                  GAIT_GALLOP)))
  auto_gait = where((req == MODE_SCRAMBLE) & (auto_gait == GAIT_STAND),
                    GAIT_TROT, auto_gait)
  waited = torch.abs(u[6] - t) > _AUTO_GAIT_MIN_TIME
  auto_on = params[_P_GAIT_SWITCH] > 0.5
  gait = u[0].to(torch.int32)
  manual = params[_P_GAIT].to(torch.int32)
  new_gait = where(auto_on, where(waited, auto_gait, gait), manual)
  new_gait = where(req == MODE_FLIP, gait, new_gait)
  switched = new_gait != gait
  u[0] = new_gait.to(dtype)
  u[6] = where(switched & auto_on, t, u[6])
  # phase continuity across a cadence change (quadruped.cc:250-257)
  cadence = _sel_scalar(_GAIT_PARAM, _gait_of(u, req), 1, u[0])
  new_vel = 2 * math.pi * cadence
  vel_changed = new_vel != u[3]
  phase_now = _get_phase(u, t)
  u[1] = where(vel_changed, phase_now, u[1])
  u[2] = where(vel_changed, t, u[2])
  u[3] = new_vel.to(dtype)
  # Walk: the goal moves along a line or a circle (quadruped.cc:305-345)
  speed_p, angvel_p = params[_P_WALK_SPEED], params[_P_WALK_TURN]
  goal = data.mocap_pos[0]
  entering = (req == MODE_WALK) & ((cur != MODE_WALK) | (u[13] != speed_p) |
                                   (u[14] != angvel_p))
  forward = data.xmat[trunk][:2, 0]
  forward = forward / torch.clamp(torch.linalg.vector_norm(forward, dim=0),
                                  min=1e-9)
  leftward = torch.stack([-forward[1], forward[0]])
  torso_xy = data.xpos[trunk][:2]
  turning = torch.abs(angvel_p) > _MIN_ANGVEL
  d_off = speed_p / torch.where(turning, angvel_p, 1.0)
  axis = torso_xy + torch.where(turning, d_off * leftward, 0.0)
  u[8] = where(entering, t, u[8])
  for i in range(2):
    u[9 + i] = where(entering, axis[i], u[9 + i])
    u[11 + i] = where(entering, goal[i] - axis[i], u[11 + i])
  u[13] = where(entering, speed_p, u[13])
  u[14] = where(entering, angvel_p, u[14])
  mode_time = t - u[8]
  heading = torch.stack([u[11], u[12]])
  centre = torch.stack([u[9], u[10]])
  hnorm = heading / torch.clamp(torch.linalg.vector_norm(heading, dim=0),
                                min=1e-9)
  straight = centre + heading + mode_time * u[13] * hnorm
  ang = mode_time * u[14]
  circle = centre + torch.stack([
      torch.cos(ang) * heading[0] - torch.sin(ang) * heading[1],
      torch.sin(ang) * heading[0] + torch.cos(ang) * heading[1]])
  walk_xy = torch.where(torch.abs(u[14]) > _MIN_ANGVEL, circle, straight)
  new_goal = torch.where(req == MODE_WALK, torch.cat([walk_xy, goal[2:]]),
                         goal)
  # Flip's exit parks the goal at the head (quadruped.cc:386-388)
  head_xy = data.site_xpos[model.site("head")][:2]
  new_goal = torch.where(flip_done, torch.cat([head_xy, goal[2:]]),
                         new_goal)
  u[7] = t
  u[16] = req.to(dtype)
  u[base.MODE_SLOT] = req.to(dtype)
  userdata = torch.stack([x.expand(t.shape).to(dtype) for x in u])
  return data.replace(
      userdata=userdata,
      mocap_pos=torch.cat([new_goal[None].to(goal.dtype),
                           data.mocap_pos[1:]]))


def probe_states(model, b: int, seed: int = 0):
  """(qpos (19, b), qvel (18, b), ctrl (12, b)) float32 numpy states in
  which every constraint row class carries force. State i % 4: 0 stands at
  the home keyframe (feet on the floor); 1 lies upside down 4 cm up (trunk
  corners on the floor); 2 turns the front abductions in to their limits
  (FL -0.5, FR +0.5: the front feet meet, joint limits); 3 folds the
  front-left leg onto the trunk past its ranges (abduction 1.2, hip -0.5,
  knee -3.1: foot against trunk, joint limits). No foot reaches the trunk
  inside the joint ranges."""
  rng = np.random.RandomState(seed)
  home = np.asarray(model.keyframe("home")[0], np.float32)
  qpos = np.repeat(home[None], b, 0)
  qpos[:, 7:] += rng.uniform(-0.05, 0.05, (b, 12))
  kind = np.arange(b) % 4

  def adr(name):
    return model.jnt_qposadr[model.joint(name)]

  flip = kind == 1
  qpos[flip, 2] = 0.04 + rng.uniform(-0.005, 0.005, int(flip.sum()))
  qpos[flip, 3:7] = [0.0, 1.0, 0.0, 0.0]  # 180 degrees about x
  inward = kind == 2
  qpos[inward, adr("FL_abd")] = -0.5 - rng.uniform(0, 0.05, inward.sum())
  qpos[inward, adr("FR_abd")] = 0.5 + rng.uniform(0, 0.05, inward.sum())
  fold = kind == 3
  for name, val in (("FL_abd", 1.2), ("FL_hip_j", -0.5), ("FL_knee", -3.1)):
    qpos[fold, adr(name)] = val
  qvel = rng.uniform(-0.5, 0.5, (b, model.nv))
  crange = model.actuator_ctrlrange.detach().cpu().numpy()
  ctrl = rng.uniform(crange[:, 0], crange[:, 1], (b, model.nu))
  return tuple(np.ascontiguousarray(x.T, np.float32)
               for x in (qpos, qvel, ctrl))


def fsm_userdata(nuserdata: int, mode: int = MODE_QUADRUPED,
                 gait: int = GAIT_TROT, time: float = 0.0) -> np.ndarray:
  """userdata for Agent.set_state that holds the FSM in `mode` and `gait`,
  both entered at `time` (what `transition` leaves there): the gait, its
  phase clock started at `time` at the cadence's phase velocity, the mode
  in both mode slots and, for Flip, the start time, the upright home
  orientation and flat ground."""
  u = np.zeros(nuserdata, np.float32)
  u[0] = gait
  u[2] = u[7] = u[8] = time
  u[3] = 2 * math.pi * _GAIT_PARAM[gait, 1]
  u[base.MODE_SLOT] = u[16] = mode
  if mode == MODE_FLIP:
    u[17:21] = (1.0, 0.0, 0.0, 0.0)
  return u


def _device_residual(model) -> base.DeviceResidual:
  """residual_quadruped's operands: the trunk and its descendant set as a
  body bitmask; the trunk's subtree mass, the home keyframe's 12 joint
  angles and the flip constants; the four foot geom centres and the head
  site."""
  trunk = model.body("trunk")
  home = np.asarray(model.keyframe("home")[0], np.float32)
  gpos = model.geom_pos.detach().cpu().numpy()
  spos = model.site_pos.detach().cpu().numpy()
  sites = [(model.geom_bodyid[g], tuple(float(x) for x in gpos[g]))
           for g in (model.geom(f) for f in _FEET)]
  head = model.site("head")
  sites.append((model.site_bodyid[head], tuple(float(x) for x in spos[head])))
  return base.DeviceResidual(
      DEVICE_RESIDUAL_ID,
      (trunk, sum(1 << b for b in sensors._descendants(model, trunk))),
      (float(model.body_subtreemass[trunk]),) + tuple(
          float(x) for x in home[7:19]) + _DEVICE_FLIP,
      tuple(sites))


def build_quadruped():
  """The Quadruped MJCF (tasks/models/quadruped.xml) as a mujoco.MjModel
  (needs mujoco)."""
  import mujoco
  return mujoco.MjModel.from_xml_path(
      os.path.join(os.path.dirname(__file__), "models", "quadruped.xml"))


@registry.register("Quadruped Flat", snapshot="quadruped",
                   builder=build_quadruped)
def make(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  model, spec, params, pnames = registry.load_task_model(
      "quadruped", dtype, device)
  return base.Task(name="Quadruped Flat", model=model, spec=spec,
                   params=params, residual=residual, param_names=pnames,
                   mode_names=MODE_NAMES, weight_mod=weight_mod,
                   transition=transition,
                   device_residual=_device_residual(model))


def _fill_hill(mj):
  """Quadruped Hill's procedural terrain (JAX quadruped.py:534-549): a
  smooth hill toward the goal with gentle ripples, flattened around the
  start so that the home keyframe rests near z = 0."""
  nr, nc = int(mj.hfield_nrow[0]), int(mj.hfield_ncol[0])
  rx, ry = mj.hfield_size[0, 0], mj.hfield_size[0, 1]
  y, x = np.meshgrid(np.linspace(-ry, ry, nr), np.linspace(-rx, rx, nc),
                     indexing="ij")
  hill = np.exp(-((x - 4.0) ** 2 + y ** 2) / 8.0)
  ripple = 0.06 * (np.sin(2.2 * x) * np.cos(1.7 * y) + 1.0)
  pad = np.clip((np.sqrt((x + 1.0) ** 2 + y ** 2) - 1.5) / 1.0, 0.0, 1.0)
  h = (hill + ripple) * pad
  mj.hfield_data[:] = (h / max(h.max(), 1e-9)).ravel()


def build_hill():
  """tasks/models/quadruped_hill.xml with its terrain filled, as a
  mujoco.MjModel (needs mujoco)."""
  import mujoco
  mj = mujoco.MjModel.from_xml_path(
      os.path.join(os.path.dirname(__file__), "models", "quadruped_hill.xml"))
  _fill_hill(mj)
  return mj


@registry.register("Quadruped Hill", snapshot="quadruped_hill",
                   builder=build_hill)
def make_hill(dtype=torch.float32, device=devices.DEFAULT) -> base.Task:
  """Quadruped Flat's task on the heightfield terrain. Heightfield pairs
  are outside the CUDA kernel's class, so it has no CUDA residual and
  plans through the general rollout, with its warning."""
  model, spec, params, pnames = registry.load_task_model(
      "quadruped_hill", dtype, device)
  return base.Task(name="Quadruped Hill", model=model, spec=spec,
                   params=params, residual=residual, param_names=pnames,
                   mode_names=MODE_NAMES, weight_mod=weight_mod,
                   transition=transition)
