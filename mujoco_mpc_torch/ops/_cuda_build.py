"""Build csrc/megarollout.cu with nvcc and load it with ctypes.

The source is compiled once per size tier and precision (-DMR_TIER,
-DMR_DOUBLE), each a library with a plain C interface (no PyTorch
headers), so nvcc builds it in seconds; `build_all` runs the nvcc
processes at once. A library built with `contract` False (-fmad=false:
no fused multiply-adds) rounds as the plain version does, op for op; it
only serves to tell the float kernel's contraction rounding from its
arithmetic. A library built with `profile` True (-DMR_PROFILE=1) carries
the kernel's per-phase cycle counters (`mr_profile`). The libraries go
to build/mujoco_mpc_torch/ at the repository root (git-ignored), named
by the hash of the source and the flags, at first use; each one's ptxas report (registers, local memory,
spills) is kept beside it as a .log file.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "megarollout.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mujoco_mpc_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
  cands = [shutil.which("nvcc")]
  if os.environ.get("CUDA_HOME"):
    cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
  cands.append("/usr/local/cuda/bin/nvcc")
  for c in cands:
    if c and os.path.exists(c):
      return c
  raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                     "/usr/local/cuda/bin): the CUDA kernel cannot be built")


def _flags(tier: int, double: bool, contract: bool,
           profile: bool = False) -> tuple:
  return NVCC_FLAGS + (f"-DMR_TIER={tier}", f"-DMR_DOUBLE={int(double)}") \
      + (() if contract else ("-fmad=false",)) \
      + (("-DMR_PROFILE=1",) if profile else ())


def library_path(tier: int, double: bool, contract: bool = True,
                 profile: bool = False) -> Path:
  flags = _flags(tier, double, contract, profile)
  key = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags).encode())
  return BUILD_DIR / (f"megarollout-t{tier}-{'f64' if double else 'f32'}-"
                      f"{'' if contract else 'nofma-'}"
                      f"{'prof-' if profile else ''}"
                      f"{key.hexdigest()[:16]}.so")


def build_all(variants) -> list:
  """Compile the libraries of `variants` ((tier index, double, contract)
  triples, the index into ops/megarollout.py TIERS, optionally followed by
  profile) that are not built yet, one nvcc process each, all at once;
  returns their paths."""
  outs = [library_path(*v) for v in variants]
  jobs = []
  for v, out in zip(variants, outs):
    if out.exists():
      continue
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    jobs.append((out, tmp, subprocess.Popen(
        [nvcc(), *_flags(*v), "-o", str(tmp),
         str(SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
  failed = []
  for out, tmp, proc in jobs:  # wait for all before raising
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
      failed.append(f"nvcc failed ({proc.returncode}) for {out.name}:\n"
                    f"{stderr}")
      continue
    out.with_suffix(".log").write_text(stdout + stderr)
    os.replace(tmp, out)
  if failed:
    raise RuntimeError("\n".join(failed))
  return outs


@functools.cache
def load(tier: int, double: bool, contract: bool = True,
         profile: bool = False) -> ctypes.CDLL:
  """The library of one tier and precision with argument types declared
  (built on first use)."""
  lib = ctypes.CDLL(str(build_all([(tier, double, contract,
                                    profile)])[0]))
  p, i = ctypes.c_void_p, ctypes.c_int
  lib.mr_model_layout.argtypes = [p, i]
  lib.mr_model_layout.restype = i
  lib.mr_model_size.argtypes = []
  lib.mr_model_size.restype = ctypes.c_longlong
  lib.mr_returns.argtypes = [p] * 14 + [i, i, p]
  lib.mr_returns.restype = i
  lib.mr_step.argtypes = [p] * 12 + [i, p]
  lib.mr_step.restype = i
  lib.mr_profile.argtypes = [p, i]
  lib.mr_profile.restype = i
  lib.mr_geometry.argtypes = [p, i, i, p]
  lib.mr_geometry.restype = i
  return lib
