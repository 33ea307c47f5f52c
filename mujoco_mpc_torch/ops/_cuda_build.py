"""Build csrc/megarollout.cu with nvcc and load it with ctypes.

The library has a plain C interface (no PyTorch headers), so nvcc builds
it in seconds. It goes to build/mujoco_mpc_torch/ at the repository root
(git-ignored), named by the hash of the source and the flags, at first
use; the ptxas report (registers, local memory, spills) is kept beside it
as a .log file.
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


def library_path() -> Path:
  key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
  return BUILD_DIR / f"megarollout-{key.hexdigest()[:16]}.so"


def build() -> Path:
  """Compile the library if it is not built yet; returns its path."""
  out = library_path()
  if out.exists():
    return out
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
  proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                        capture_output=True, text=True)
  if proc.returncode != 0:
    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
  out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
  os.replace(tmp, out)
  return out


@functools.cache
def load() -> ctypes.CDLL:
  """The built library with argument types declared (built on first use)."""
  lib = ctypes.CDLL(str(build()))
  p, i = ctypes.c_void_p, ctypes.c_int
  lib.mr_model_layout.argtypes = [i, p, i]
  lib.mr_model_layout.restype = i
  lib.mr_model_size.argtypes = [i]
  lib.mr_model_size.restype = ctypes.c_longlong
  for name in ("mr_returns", "mr_returns64"):
    getattr(lib, name).argtypes = [p] * 13 + [i, i, p]
    getattr(lib, name).restype = i
  for name in ("mr_step", "mr_step64"):
    getattr(lib, name).argtypes = [p] * 11 + [i, p]
    getattr(lib, name).restype = i
  return lib
