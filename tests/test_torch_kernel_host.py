"""The CUDA kernel's source, compiled for the host, against the plain version.

csrc/megarollout.cu is built here with the host C++ compiler under a stub
cuda_runtime.h (the CUDA qualifiers empty, one thread per block, the launch
syntax removed, a static buffer for the dynamic shared memory and a no-op
cudaFuncSetAttribute), once per size tier (-DMR_TIER), and each candidate's
block is run in turn. That checks the kernel's arithmetic, its struct
layouts against ops/megarollout.py's ctypes mirrors and its task residuals
on a host without a card; the card's own build is tested in
tests/test_torch_megarollout_cuda.py. Built without contraction
(-ffp-contract=off), so it rounds as the plain version does. This file
holds the one-step checks and the helpers; the returns are in
test_torch_kernel_host_returns.py and the residual terms and branches in
test_torch_kernel_host_terms.py, so that the test workers share them out.

Tolerances, with the errors measured when they were set: Walker step qpos
atol 1e-6 (3.0e-8), qvel 1e-4 (6.4e-6), duals 1e-5 * max (1.2e-3 of 1.1e3);
Humanoid step qpos 1e-5 (5.1e-7), qvel 1e-3 (7.6e-5), duals 1e-4 * max
(3.2e-3 of 2.2e3); Quadruped step qpos 1e-5 (2.4e-7), qvel 1e-3 (6.7e-6),
duals 1e-4 * max (3.7e-4 of 9.2e2); Shadow, Bimanual Handover, Allegro,
the small class models of tests/test_torch_tilestep_classes.py and the
small tasks (SMALL_TASKS, on tasks.base.probe_states; Rubik Faces has no
constraint rows) as the Quadruped; returns rtol 2e-3 (Walker 1.2e-7,
Humanoid 1.3e-6). Acrobot and Cartpole run their registered models, the
reference's parent-child pair kept: both versions drop its rows, whose
normal would come from a rounding residue (tilestep.COINCIDE).
"""

import ctypes
import functools
import hashlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mujoco_mpc_torch.ops import _cuda_build
from mujoco_mpc_torch.ops import megarollout as tmr
from mujoco_mpc_torch.physics import tilestep as tts
from mujoco_mpc_torch.tasks import allegro as tall
from mujoco_mpc_torch.tasks import bimanual as tbim
from mujoco_mpc_torch.tasks import class_models
from mujoco_mpc_torch.tasks import hand_reorient as thand
from mujoco_mpc_torch.tasks import humanoid as thum
from mujoco_mpc_torch.tasks import quadruped as tquad
from mujoco_mpc_torch.tasks import registry as treg
from mujoco_mpc_torch.tasks import rubik as trubik
from tests.test_torch_tilestep_classes import CLASS_MODELS, class_task
from tests.torch_cases import (HANDOVER_TARGET, RUBIK_TARGETS, SHADOW_GOAL,
                               SMALL_TASKS, small_task_states)
from tests.torch_engine_cases import release_jax_executables  # noqa: F401
from tests.torch_engine_cases import session_dir, session_result

_STUB = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstring>
#define __device__
#define __host__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(...)
#define __shared__ static
#define __constant__ static
#define __restrict__
#define __align__(n) alignas(n)
#define MR_DYNAMIC_SHARED(name) alignas(16) static unsigned char name[1 << 18]
struct host_dim3 { unsigned x, y, z; };
// a block's threads are std::threads (one per lane of its one warp), each
// with its own threadIdx; __syncthreads, __syncwarp and the shuffles meet
// at the block's barrier
static thread_local host_dim3 threadIdx;
static host_dim3 blockIdx, blockDim;
static std::barrier<>* mr_block_barrier = nullptr;
static double mr_lane_value[64];
static inline void mr_block_sync() {
  if (mr_block_barrier) mr_block_barrier->arrive_and_wait();
}
#define __syncthreads() mr_block_sync()
#define __syncwarp(...) mr_block_sync()
template <class V>
static V mr_exchange(V v, int src) {
  mr_lane_value[threadIdx.x] = (double)v;
  mr_block_sync();
  const V r = (V)mr_lane_value[src];
  mr_block_sync();
  return r;
}
template <class V>
static V __shfl_sync(unsigned, V v, int src, int width) {
  return mr_exchange(v, (int)(threadIdx.x / width * width + src % width));
}
template <class V>
static V __shfl_xor_sync(unsigned, V v, int mask, int width) {
  return mr_exchange(
      v, (int)(threadIdx.x / width * width + ((threadIdx.x % width) ^ mask)));
}
typedef void* cudaStream_t;
typedef int cudaError_t;
#define cudaSuccess 0
#define cudaErrorInvalidValue 1
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
template <class F>
static inline cudaError_t cudaFuncSetAttribute(F*, cudaFuncAttribute, int) {
  return 0;
}
template <class F>
static inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* blocks, F*, int, size_t) {
  *blocks = 1;
  return 0;
}
static inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
static inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr,
                                                 int) {
  *v = 1;
  return 0;
}
static inline cudaError_t cudaGetLastError() { return 0; }
static inline float __int_as_float(int i) {
  float f; std::memcpy(&f, &i, 4); return f;
}
static inline double __longlong_as_double(long long i) {
  double d; std::memcpy(&d, &i, 8); return d;
}
using std::isfinite;
"""

_HOST_MAIN = r"""
#include <cstdlib>
#include <thread>
#include <vector>
#include "kernel.cc"
// One candidate per block of one warp of L lanes: L = 1 runs the block on
// this thread, L > 1 on L threads that meet at a barrier.
template <int L, class F>
static void run_block(F body) {
  blockDim.x = L;
  if (L == 1) {
    threadIdx.x = 0;
    body();
    return;
  }
  std::barrier<> bar(L);
  mr_block_barrier = &bar;
  std::vector<std::thread> lanes;
  for (int t = 0; t < L; ++t)
    lanes.emplace_back([&body, t] { threadIdx.x = t; body(); });
  for (auto& th : lanes) th.join();
  mr_block_barrier = nullptr;
}
// a candidate's working-set bytes; aborts where a block outgrows the
// stub's buffer
template <class T>
static int cand_bytes(const void* model) {
  Cand<T, MRTier> views;
  const size_t cand =
      carve(*(const MRModelT<T, MRTier>*)model, nullptr, views);
  if (head_bytes<T, MRTier>() + cand > (1 << 18)) std::abort();
  return (int)cand;
}
template <class T, int L>
static void returns(const void* model, const void* qpos0, const void* qvel0,
    const void* actions, const void* weights, const void* norm_params,
    const void* risk, const void* res_params, const void* t0,
    const void* mp, const void* mq, const void* ud, void* out, int n,
    int horizon) {
  const int cand = cand_bytes<T>(model);
  for (int c = 0; c < n; ++c) {
    blockIdx.x = c;
    run_block<L>([&] {
      mr_returns_kernel<T, MRTier, L>((const MRModelT<T, MRTier>*)model,
          (const T*)qpos0, (const T*)qvel0, (const T*)actions,
          (const T*)weights, (const T*)norm_params, (const T*)risk,
          (const T*)res_params, (const T*)t0, (const T*)mp, (const T*)mq,
          (const T*)ud, (T*)out, n, horizon, cand);
    });
  }
}
template <class T, int L>
static void step(const void* model, const void* qpos, const void* qvel,
    const void* ctrl, const void* lam, const void* mp, const void* mq,
    const void* ud, void* qpos_out, void* qvel_out, void* lam_out, int b) {
  const int cand = cand_bytes<T>(model);
  for (int c = 0; c < b; ++c) {
    blockIdx.x = c;
    run_block<L>([&] {
      mr_step_kernel<T, MRTier, L>((const MRModelT<T, MRTier>*)model,
          (const T*)qpos, (const T*)qvel, (const T*)ctrl, (const T*)lam,
          (const T*)mp, (const T*)mq, (const T*)ud, (T*)qpos_out,
          (T*)qvel_out, (T*)lam_out, b, cand);
    });
  }
}
#define RETURNS_ARGS const void* m, const void* q, const void* v, \
    const void* a, const void* w, const void* np, const void* r, \
    const void* rp, const void* t0, const void* mp, const void* mq, \
    const void* ud, void* out, int n, int h
#define STEP_ARGS const void* m, const void* q, const void* v, \
    const void* c, const void* l, const void* mp, const void* mq, \
    const void* ud, void* qo, void* vo, void* lo, int b
extern "C" void host_returns(RETURNS_ARGS) {
  returns<float, 1>(m, q, v, a, w, np, r, rp, t0, mp, mq, ud, out, n, h);
}
extern "C" void host_returns64(RETURNS_ARGS) {
  returns<double, 1>(m, q, v, a, w, np, r, rp, t0, mp, mq, ud, out, n, h);
}
extern "C" void host_step(STEP_ARGS) {
  step<float, 1>(m, q, v, c, l, mp, mq, ud, qo, vo, lo, b);
}
extern "C" void host_step64(STEP_ARGS) {
  step<double, 1>(m, q, v, c, l, mp, mq, ud, qo, vo, lo, b);
}
extern "C" void host_step_lanes4(STEP_ARGS) {
  step<float, 4>(m, q, v, c, l, mp, mq, ud, qo, vo, lo, b);
}
extern "C" void host_step64_lanes4(STEP_ARGS) {
  step<double, 4>(m, q, v, c, l, mp, mq, ud, qo, vo, lo, b);
}
extern "C" int host_model_layout(int dbl, long long* offsets, int capacity) {
  return dbl ? model_layout<double, MRTier>(offsets, capacity)
             : model_layout<float, MRTier>(offsets, capacity);
}
// the dynamic shared bytes of a block of one candidate (the model head and
// one working set), which a launch on the card caps at MR_SMEM_MAX
extern "C" long long host_block_bytes(int dbl, const void* m) {
  return dbl ? (long long)(head_bytes<double, MRTier>() + cand_bytes<double>(m))
             : (long long)(head_bytes<float, MRTier>() + cand_bytes<float>(m));
}
extern "C" long long host_model_size(int dbl) {
  return dbl ? (long long)sizeof(MRModelT<double, MRTier>)
             : (long long)sizeof(MRModelT<float, MRTier>);
}
"""

_P = ctypes.c_void_p


def _ptr(a):
  return a.ctypes.data_as(_P)


def _build(d, flags, tier):
  """The kernel source of one size tier under the stub, built into d with
  extra flags; the library's path."""
  cxx = shutil.which("g++") or shutil.which("c++")
  if cxx is None:
    pytest.skip("needs a host C++ compiler")
  src = _cuda_build.SOURCE.read_text()
  (d / "kernel.cc").write_text(re.sub(r"<<<[^>]*>>>", "", src))
  (d / "cuda_runtime.h").write_text(_STUB)
  (d / "host_main.cc").write_text(_HOST_MAIN)
  so = d / "kernel_host.so"
  subprocess.run([cxx, "-O2", "-std=c++20", "-pthread", "-shared", "-fPIC",
                  *flags,
                  f"-DMR_TIER={tmr.TIERS.index(tier)}", "-I", str(d), "-o",
                  str(so), str(d / "host_main.cc")],
                 check=True, capture_output=True)
  return so


def _load(so, tier):
  """The host build at so, both precisions' layouts checked against their
  mirrors."""
  lib = ctypes.CDLL(str(so))
  lib.host_model_layout.argtypes = [ctypes.c_int, _P, ctypes.c_int]
  lib.host_model_size.argtypes = [ctypes.c_int]
  lib.host_model_size.restype = ctypes.c_longlong
  lib.host_block_bytes.argtypes = [ctypes.c_int, _P]
  lib.host_block_bytes.restype = ctypes.c_longlong
  for name in ("host_returns", "host_returns64"):
    getattr(lib, name).argtypes = [_P] * 13 + [ctypes.c_int] * 2
  for name in ("host_step", "host_step64", "host_step_lanes4",
               "host_step64_lanes4"):
    getattr(lib, name).argtypes = [_P] * 11 + [ctypes.c_int]
  for dbl, dt in enumerate((torch.float32, torch.float64)):
    tmr.check_layout(functools.partial(lib.host_model_layout, dbl),
                     functools.partial(lib.host_model_size, dbl),
                     tmr._MODEL_STRUCT[tier, dt])
  return lib


class HostLibs:
  """The host builds of the kernel per size tier, each built on first use,
  once a session (torch_engine_cases.session_result): the session's other
  test modules and workers load it."""

  def __init__(self, tmp_path_factory, flags):
    self._tmp, self._flags, self._libs = tmp_path_factory, flags, {}

  def __getitem__(self, tier):
    if tier not in self._libs:
      name = "kernel_host_{}_{}".format(tier.name, hashlib.sha256(
          " ".join(self._flags).encode()).hexdigest()[:8])

      def build():
        d = session_dir(self._tmp) / name
        d.mkdir(exist_ok=True)
        return _build(d, self._flags, tier)

      self._libs[tier] = _load(session_result(self._tmp, name, build), tier)
    return self._libs[tier]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
  return HostLibs(tmp_path_factory, ["-ffp-contract=off"])


@pytest.fixture(scope="module")
def lib_contracted(tmp_path_factory):
  """Built as nvcc builds for the card: multiply-adds contracted (on a
  host CPU with FMA)."""
  return HostLibs(tmp_path_factory, ["-march=native", "-ffp-contract=fast"])


def _walker_states(model, b):
  rng = np.random.RandomState(1)
  home = np.asarray(model.keyframe("home")[0])
  qp = (home + rng.uniform(-0.05, 0.05, (b, 9))).astype(np.float32)
  qp[:, 0] -= 0.03  # sink the walker a little: contacts active
  qv = rng.uniform(-0.5, 0.5, (b, 9)).astype(np.float32)
  ct = rng.uniform(-1.0, 1.0, (b, 6)).astype(np.float32)
  return qp.T.copy(), qv.T.copy(), ct.T.copy()


_CASES = {
    # task, states, (qpos, qvel, duals-relative) tolerances in float32
    "Walker": (_walker_states, (1e-6, 1e-4, 1e-5)),
    "Humanoid Walk": (thum.probe_states, (1e-5, 1e-3, 1e-4)),
    "Quadruped Flat": (tquad.probe_states, (1e-5, 1e-3, 1e-4)),
    "Shadow": (thand.probe_states, (1e-5, 1e-3, 1e-4)),
    "Bimanual Handover": (tbim.probe_states, (1e-5, 1e-3, 1e-4)),
    "Allegro": (tall.probe_states, (1e-5, 1e-3, 1e-4)),
}
for _name in CLASS_MODELS:
  _CASES[_name] = (lambda model, b, name=_name: class_models.states(name, model, b),
                   (1e-5, 1e-3, 1e-4))
for _name in SMALL_TASKS:
  _CASES[_name] = (small_task_states(_name), (1e-5, 1e-3, 1e-4))
# float64: the kernel's double instance against step_tb in float64
_TOL64 = (1e-12, 1e-11, 1e-12)
_NP = {torch.float32: np.float32, torch.float64: np.float64}
_SUFFIX = {torch.float32: "", torch.float64: "64"}
# the residuals that read the raw controls: a 1e30 command diverges there
_RAW_CTRL = ("Walker", "Humanoid Walk") + SMALL_TASKS


def _task(name):
  if name in CLASS_MODELS:
    return class_task(name)
  return treg.get_task(name, device="cpu")


def _aux(tm, dtype, userdata=None, name=None):
  """The rollout-constant operands as the kernel takes them: for the
  quadruped the goal at (1.0, 0.3, 0.3) and a trot's userdata, for Shadow
  and Allegro the goal quaternion SHADOW_GOAL, for the handover the target
  HANDOVER_TARGET, for Rubik Faces the face targets RUBIK_TARGETS,
  otherwise the defaults (a mocap goal at (1.0, 0.3, 0.3))."""
  mocap_pos, mocap_quat = [[1.0, 0.3, 0.3]] * tm.nmocap, None
  if name in ("Shadow", "Allegro"):
    mocap_quat = SHADOW_GOAL
  elif name == "Bimanual Handover":
    mocap_pos = HANDOVER_TARGET
  elif name == "Rubik Faces":
    userdata = trubik.faces_userdata(tm.nuserdata, RUBIK_TARGETS)
  elif name in SMALL_TASKS:
    pass
  elif tm.nmocap and userdata is None:
    userdata = tquad.fsm_userdata(tm.nuserdata)
  mp, mq, ud = tts.aux_operands(tm, mocap_pos, mocap_quat, userdata, dtype)
  return [np.ascontiguousarray(x[..., 0].numpy()) for x in (mp, mq, ud)]


def _host_step(lib, raw, dtype, qp, qv, ct, lam, aux, lanes=1):
  """One step of the host kernel with 1 lane a candidate, or 4 (threads)."""
  ins = [np.ascontiguousarray(x.T) for x in (qp, qv, ct, lam)]
  outs = [np.empty_like(ins[i]) for i in (0, 1, 3)]
  entry = "host_step" + _SUFFIX[dtype] + ("_lanes4" if lanes == 4 else "")
  getattr(lib, entry)(
      _ptr(raw), *map(_ptr, ins), *map(_ptr, aux), *map(_ptr, outs),
      qp.shape[1])
  return tuple(x.T.copy() for x in outs)


def _packed(tm, task, dtype):
  """(the packed model in its tier, the tier)."""
  tier = tmr.select_tier(tm, task)
  raw = np.frombuffer(tmr.pack_model(tm, task, dtype), np.uint8)
  return raw.copy(), tier


def _check_steps(libs, name, dtype, tols, lanes=1):
  states, _ = _CASES[name]
  tq, tv, tl = tols
  task = _task(name)
  tm = tts.extract(task.model)
  raw, tier = _packed(tm, task, dtype)
  qp, qv, ct = (x.astype(_NP[dtype]) for x in states(task.model, 8))
  b = qp.shape[1]
  aux = _aux(tm, dtype, name=name)
  ops = dict(zip(("mocap_pos", "mocap_quat", "userdata"),
                 (torch.tensor(x)[..., None] for x in aux)))
  kq, kv, kl = qp, qv, np.zeros((max(tm.nrow, 1), b), _NP[dtype])
  pq, pv, pl = torch.tensor(qp), torch.tensor(qv), None
  for _ in range(2):  # cold, then warm-started
    kq, kv, kl = _host_step(libs[tier], raw, dtype, kq, kv, ct, kl, aux,
                            lanes)
    pq, pv, view = tts.step_tb(tm, pq, pv, torch.tensor(ct), pl, **ops)
    pl = view.efc_lambda
    scale = float(pl.abs().max())
    assert scale > 0.0 or tm.nrow == 0  # contacts and limits carry force
    np.testing.assert_allclose(kq, pq.numpy(), atol=tq, rtol=0)
    np.testing.assert_allclose(kv, pv.numpy(), atol=tv, rtol=0)
    if tm.nrow:
      np.testing.assert_allclose(kl, pl.numpy(), atol=tl * scale, rtol=0)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_host_kernel_step_matches_plain(lib, name):
  _check_steps(lib, name, torch.float32, _CASES[name][1])


@pytest.mark.parametrize("name", sorted(_CASES))
def test_host_kernel_float64_step_matches_plain(lib, name):
  """Measured: Walker qvel 9.3e-15, duals 2.5e-12 of 9.6e2; Humanoid qpos
  4.2e-16, qvel 8.2e-14, duals 9.1e-12 of 2.2e3; Quadruped qpos 1.1e-16,
  qvel 1.1e-14, duals 9.1e-13 of 9.2e2."""
  _check_steps(lib, name, torch.float64, _TOL64)


@pytest.mark.parametrize("name", ["Humanoid Walk", "Allegro"])
def test_host_kernel_four_lanes_step_matches_plain(lib, name):
  """The step kernel with 4 lanes a candidate (threads that meet at the
  block's barrier for every sync and shuffle), one model per tier: the
  lanes' striding over rows, points, dofs, joints and bodies, the
  column-by-column factorization and solves, and the sums across lanes,
  against the plain step at the one-lane tolerances, in both
  precisions."""
  _check_steps(lib, name, torch.float32, _CASES[name][1], lanes=4)
  _check_steps(lib, name, torch.float64, _TOL64, lanes=4)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_host_kernel_picks_the_smallest_tier(name):
  """Every model runs in the small tier but Allegro, whose 144 rows and
  box-box pair take the large one; a packed model is as long as its
  tier's struct."""
  task = _task(name)
  tm = tts.extract(task.model)
  tier = tmr.select_tier(tm, task)
  assert tier.name == ("large" if name == "Allegro" else "small")
  for dt in (torch.float32, torch.float64):
    assert len(tmr.pack_model(tm, task, dt)) == ctypes.sizeof(
        tmr._MODEL_STRUCT[tier, dt])


def rollout_inputs(name, dtype, horizon, qpos0=None):
  """(task, MegaRollout, the start state, zero velocities, 8 candidates'
  actions, the operands) of a returns check; a diverging candidate 1
  where the residual reads the raw controls (a 1e30 command; the other
  costs read the state or the actuator forces of the clamped controls)."""
  task = _task(name)
  n = 8
  mr = tmr.MegaRollout(task, horizon, device="cpu")
  if qpos0 is not None:
    home = qpos0
  elif name in CLASS_MODELS:
    home = class_models.states(name, task.model, 1)[0][:, 0]
  elif name in SMALL_TASKS:  # a probe state: a limit or contact engaged
    home = small_task_states(name)(task.model, 2)[0][:, 1]
  else:
    home = np.asarray(task.model.keyframe("home")[0], np.float32)
  v0 = np.zeros(mr.tm.nv, np.float32)
  acts = (0.4 * np.random.RandomState(0).randn(n, horizon, mr.tm.nu)
          ).astype(np.float32)
  home, v0, acts = (x.astype(_NP[dtype]) for x in (home, v0, acts))
  if name in _RAW_CTRL:
    acts[1] = 1e30 if dtype == torch.float32 else 1e300
  return task, mr, home, v0, acts


def host_returns(libs, mr, dtype, home, v0, acts, params, aux):
  """The host kernel's returns (8,) of a returns check, t0 0.25."""
  task = mr.task
  raw, tier = _packed(mr.tm, task, dtype)
  p = params.to(dtype=dtype)
  ops = [raw, home, v0, acts] + [
      np.ascontiguousarray(x.numpy().reshape(-1))
      for x in (p.weights, p.norm_params, p.risk, p.residual_params)] + [
          np.asarray([0.25], _NP[dtype])] + aux
  out = np.empty(acts.shape[0], _NP[dtype])
  getattr(libs[tier], "host_returns" + _SUFFIX[dtype])(
      *map(_ptr, ops), _ptr(out), acts.shape[0], acts.shape[1])
  return out


def check_returns(libs, name, dtype, horizon, rtol, userdata=None,
                  params=None, qpos0=None):
  """The host kernel's returns against MegaRollout.returns_plain."""
  task, mr, home, v0, acts = rollout_inputs(name, dtype, horizon, qpos0)
  p = (params or task.params).to(dtype=dtype)
  aux = _aux(mr.tm, dtype, userdata, name)
  out = host_returns(libs, mr, dtype, home, v0, acts, p, aux)
  want = mr.returns(torch.tensor(home), torch.tensor(v0),
                    torch.tensor(acts), p, 0.25,
                    *(torch.tensor(x) for x in aux)).numpy()
  assert want.dtype == _NP[dtype]
  if name in _RAW_CTRL:
    assert out[1] == want[1] == tmr.MAX_RETURN
  else:
    assert np.all(want < tmr.MAX_RETURN)
  np.testing.assert_allclose(out, want, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_host_kernel_all_rows_inactive_stay_finite(lib, dtype):
  """Arm Reach about its home pose: 14 joint-limit rows, none active, so
  the preconditioner and the power-iteration step size see nothing but
  inactive rows. The kernel's step stays finite, carries no force and
  matches the plain version, cold and warm, in both precisions."""
  task = treg.get_task("Arm Reach", device="cpu")
  tm = tts.extract(task.model)
  raw, tier = _packed(tm, task, dtype)
  rng = np.random.RandomState(4)
  home = np.asarray(task.model.keyframe("home")[0])
  qp = (home[:, None] + rng.uniform(-0.1, 0.1, (7, 8))).astype(_NP[dtype])
  qv = rng.uniform(-0.5, 0.5, (7, 8)).astype(_NP[dtype])
  ct = rng.uniform(-1.0, 1.0, (7, 8)).astype(_NP[dtype])
  aux = _aux(tm, dtype, name="Arm Reach")
  kq, kv, kl = qp, qv, np.zeros((tm.nrow, 8), _NP[dtype])
  pq, pv, pl = torch.tensor(qp), torch.tensor(qv), None
  tol = _CASES["Arm Reach"][1] if dtype == torch.float32 else _TOL64
  for _ in range(2):
    kq, kv, kl = _host_step(lib[tier], raw, dtype, kq, kv, ct, kl, aux)
    pq, pv, view = tts.step_tb(tm, pq, pv, torch.tensor(ct), pl)
    pl = view.efc_lambda
    assert tm.nrow == 14 and not np.any(kl) and not bool(pl.any())
    assert np.all(np.isfinite(kq)) and np.all(np.isfinite(kv))
    np.testing.assert_allclose(kq, pq.numpy(), atol=tol[0], rtol=0)
    np.testing.assert_allclose(kv, pv.numpy(), atol=tol[1], rtol=0)


def test_host_kernel_contraction_moves_only_float_rounding(lib_contracted):
  """Contracted multiply-adds (as nvcc builds for the card) round
  differently: at a few stiff leg-leg crossings of the 128 probe states
  the float kernel's one-step qvel moves by more than 1e-3 from the plain
  float32 step, while the double kernel still matches the plain float64
  step to 1e-11. Measured with FMA contraction: worst float32 qvel error
  1.49e-3 (state 124, whose plain float32 step is 2.2e-4 from float64: a
  ratio of 6.9); every other state is under 3.4 times its own
  float32-vs-float64 error; double 1.5e-12. The same limit, max(1e-3,
  8 x the state's float32-vs-float64 error), is what chip_smoke.py holds
  the card's float kernel to at these states."""
  task = treg.get_task("Humanoid Walk", device="cpu")
  tm = tts.extract(task.model)
  qp, qv, ct = thum.probe_states(task.model, 128)
  lam0 = np.zeros((tm.nrow, 128))
  plain = {}
  for dt in (torch.float32, torch.float64):
    q2, v2, view = tts.step_tb(tm, *(torch.tensor(x).to(dt)
                                     for x in (qp, qv, ct)))
    plain[dt] = (q2.double().numpy(), v2.double().numpy(),
                 view.efc_lambda.double().numpy())
  noise = np.abs(plain[torch.float32][1] - plain[torch.float64][1]).max(0)
  for dt in (torch.float32, torch.float64):
    raw, tier = _packed(tm, task, dt)
    kq, kv, kl = _host_step(lib_contracted[tier], raw, dt,
                            *(x.astype(_NP[dt]) for x in (qp, qv, ct, lam0)),
                            _aux(tm, dt, name="Humanoid Walk"))
    err = np.abs(kv - plain[dt][1]).max(0)
    if dt == torch.float64:
      np.testing.assert_allclose(kq, plain[dt][0], atol=1e-12, rtol=0)
      assert err.max() <= 1e-11
      scale = np.abs(plain[dt][2]).max()
      np.testing.assert_allclose(kl, plain[dt][2], atol=1e-12 * scale,
                                 rtol=0)
    else:
      assert np.all(err <= np.maximum(1e-3, 8.0 * noise)), (
          err.max(), (err / noise).max())
