"""Build the native C ABI library (libmjpc_torch.so) and its smoke test.

Counterpart of mujoco_mpc_tpu/native/build.py. Both are built with g++ (the
library holds no CUDA code) against the running interpreter's headers and
libpython, into build/mujoco_mpc_torch/ at the repository root, never into
the package tree.

Usage: python mujoco_mpc_torch/native/build.py [--test] [--device cpu]
           [--task Walker] [--gap_ms 300]
  --test runs the smoke on the task from its home keyframe (or qpos0), on
  the card unless --device cpu, its two same-state calls gap_ms apart:
  longer than a plan (a Walker plan takes about 17 ms on the card, a
  Particle plan about a second on a CPU: --task Particle --gap_ms 3000).
"""

from __future__ import annotations

import argparse
import os
import site
import subprocess
import sys
import sysconfig
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
BUILD_DIR = REPO / "build" / "mujoco_mpc_torch"
LIBRARY = BUILD_DIR / "libmjpc_torch.so"
SMOKE = BUILD_DIR / "capi_smoke"


def flags():
  """(include dir, libpython's dir, its version suffix) of this Python."""
  inc = sysconfig.get_paths()["include"]
  libdir = sysconfig.get_config_var("LIBDIR")
  ver = sysconfig.get_config_var("LDVERSION")
  return inc, libdir, ver


def _gxx(args, out: Path) -> Path:
  """g++ args -o out, through a temporary name, so that a reader never
  sees half a file."""
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
  subprocess.run(["g++", "-O2", "-std=c++17", *args, "-o", str(tmp)],
                 check=True)
  os.replace(tmp, out)
  return out


def build() -> Path:
  inc, libdir, ver = flags()
  return _gxx(["-shared", "-fPIC", f"-I{inc}", str(HERE / "mjpc_capi.cc"),
               f"-L{libdir}", f"-lpython{ver}", "-ldl", "-lm",
               f"-Wl,-rpath,{libdir}"], LIBRARY)


def build_test() -> Path:
  _, libdir, ver = flags()
  return _gxx([str(HERE / "capi_smoke.cc"), str(LIBRARY), f"-L{libdir}",
               f"-lpython{ver}", "-ldl", "-lm", "-pthread",
               f"-Wl,-rpath,{libdir}", f"-Wl,-rpath,{BUILD_DIR}"], SMOKE)


def smoke_env() -> dict:
  """The environment the embedded interpreter needs: the repository and
  this interpreter's site-packages on its path (an embedded interpreter
  starts from the base installation, not from a virtual environment)."""
  env = dict(os.environ)
  paths = [str(REPO), *site.getsitepackages()]
  if env.get("PYTHONPATH"):
    paths.append(env["PYTHONPATH"])
  env["PYTHONPATH"] = os.pathsep.join(paths)
  return env


def smoke_args(task: str, term: str, qpos, nv: int, device=None,
               gap_ms: int = 300) -> list:
  """The built smoke's command line on `task` from `qpos` at rest (device
  None: the card), its two same-state calls gap_ms apart."""
  return [str(SMOKE), task, term, device or "-", str(gap_ms), str(nv),
          *(repr(float(x)) for x in qpos)]


def run_smoke(task: str, term: str, qpos, nv: int, device=None,
              gap_ms: int = 300,
              timeout: float = 120.0) -> subprocess.CompletedProcess:
  """Run the built smoke (smoke_args), its output captured, a failure not
  raised."""
  return subprocess.run(smoke_args(task, term, qpos, nv, device, gap_ms),
                        env=smoke_env(), capture_output=True, text=True,
                        timeout=timeout)


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--test", action="store_true",
                 help="also build and run the smoke")
  p.add_argument("--device", default=None,
                 help="the smoke's device (default: the card)")
  p.add_argument("--task", default="Walker")
  p.add_argument("--gap_ms", type=int, default=300,
                 help="the gap between the smoke's same-state calls")
  args = p.parse_args(argv)
  print("built", build())
  if not args.test:
    return 0
  print("built", build_test())
  if str(REPO) not in sys.path:  # run as a script from anywhere
    sys.path.insert(0, str(REPO))
  from mujoco_mpc_torch.tasks import registry
  task = registry.get_task(args.task, device="cpu")
  try:
    qpos = task.model.keyframe("home")[0]
  except KeyError:
    qpos = task.model.qpos0.numpy()
  proc = run_smoke(args.task, task.spec.names[0], qpos, task.model.nv,
                   args.device, gap_ms=args.gap_ms)
  sys.stdout.write(proc.stdout)
  sys.stderr.write(proc.stderr)
  return proc.returncode


if __name__ == "__main__":
  sys.exit(main())
