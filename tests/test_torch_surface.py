"""The port's public surface held to the JAX package's.

Both packages are read with `ast`; neither is imported (the JAX
dashboard's `ui/__main__.py` starts a server when it is imported). For
every module of mujoco_mpc_tpu/ the port must have the module at the same
path under mujoco_mpc_torch/, and in it:

- each public top-level function, class and constant (in an `__init__.py`
  also each name it re-exports);
- each public method of a class, `__init__` and `__call__` included, and
  each class-level field (a dataclass's or NamedTuple's fields, an enum's
  members), counting what the port's class inherits from base classes
  defined in the port;
- each parameter name of a public function or method. The port may add
  parameters.

A gap is named `path::name`, `path::Class.member` or `path::func(param)`.
DEPARTURES lists the deliberate ones, each with its reason and the line
of ROADMAP.md (queue 3, "The port's public surface") that gives it. Three
tests fail on a gap outside the table (a module, a name, a parameter),
the fourth on an entry that no longer names a gap or whose ROADMAP.md
line is gone. Run on the CPU, well under a second:
`python -m pytest tests/test_torch_surface.py -q`.
"""

from __future__ import annotations

import ast
import functools
import os
from typing import Dict, Set, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX, PORT = "mujoco_mpc_tpu", "mujoco_mpc_torch"

# why the port departs, each with the line of ROADMAP.md (queue 3, "The
# port's public surface") that gives the reason
_TPU = ("TPU-only machinery, not ported",
        "TPU machinery that the port does not take over")
_RNG = ("random draws from a torch.Generator or injected draws",
        "take a `torch.Generator` (or injected draws) where JAX takes a "
        "PRNG key")
_UNROLL = ("XLA's scan unrolling; the port's rollout is a loop",
           "`rollout(unroll=)` and `rollout_return(unroll=)`")
_PLATFORM = ("the JAX server's platform; the port's client takes device=",
             "`AgentClient(jax_platform=)`")
_SNAPSHOT = ("tasks load snapshots by stem",
             "`registry.load_task_model(stem, dtype, device)`")
_STEP_MODULE = ("physics.step stays the module physics/step.py",
                "`physics.step` is the module physics/step.py")

# qualified gap -> (why the port departs there, its ROADMAP.md line)
DEPARTURES: Dict[str, Tuple[str, str]] = {
    "ops/megarollout.py::MegaRollout.__init__(block)": _TPU,
    "ops/megarollout.py::MegaRollout.__init__(interpret)": _TPU,
    "ops/megarollout.py::MegaRollout.returns(vma)": _TPU,
    "ops/megarollout.py::MegaRollout.returns_xla": _TPU,
    "ops/megarollout.py::try_build": _TPU,
    "physics/tilestep.py::TileModel.nang": _TPU,
    "physics/tilestep.py::TileModel.roll_pts": _TPU,
    "physics/tilestep.py::TileModel.tor_pts": _TPU,
    "physics/tilestep.py::jacobian_tiles": _TPU,
    "ops/rollout.py::noisy_rollout(rng)": _RNG,
    "parallel/mesh.py::ShardedRobustPlanner.optimize(rng)": _RNG,
    "planners/base.py::Planner.optimize(rng)": _RNG,
    "planners/cross_entropy.py::CrossEntropyPlanner.optimize(rng)": _RNG,
    "planners/gradient.py::GradientPlanner.optimize(rng)": _RNG,
    "planners/ilqg.py::ILQGPlanner.optimize(rng)": _RNG,
    "planners/ilqs.py::ILQSPlanner.optimize(rng)": _RNG,
    "planners/robust.py::RobustPlanner.optimize(rng)": _RNG,
    "planners/sample_gradient.py::SampleGradientPlanner.optimize(rng)": _RNG,
    "planners/sampling.py::SamplingPlanner.candidates(rng)": _RNG,
    "planners/sampling.py::SamplingPlanner.optimize(rng)": _RNG,
    "ops/rollout.py::rollout(unroll)": _UNROLL,
    "ops/rollout.py::rollout_return(unroll)": _UNROLL,
    "service/client.py::AgentClient.__init__(jax_platform)": _PLATFORM,
    "tasks/registry.py::load_task_model(xml_name)": _SNAPSHOT,
    "tasks/registry.py::load_task_model(mutate)": _SNAPSHOT,
    "physics/__init__.py::step": _STEP_MODULE,
}


def _public(name: str) -> bool:
  return not name.startswith("_")


def _params(fn: ast.AST) -> Tuple[str, ...]:
  a = fn.args
  names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
  names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
  return tuple(n for n in names if n not in ("self", "cls"))


def _statements(body):
  """Top-level statements, looking into if/try blocks."""
  for node in body:
    if isinstance(node, ast.If):
      if "__main__" in ast.dump(node.test):
        continue
      yield from _statements(node.body)
      yield from _statements(node.orelse)
    elif isinstance(node, ast.Try):
      for part in (node.body, node.orelse, node.finalbody):
        yield from _statements(part)
      for handler in node.handlers:
        yield from _statements(handler.body)
    else:
      yield node


def _targets(node):
  if isinstance(node, ast.Assign):
    targets = node.targets
  elif isinstance(node, ast.AnnAssign):
    targets = [node.target]
  else:
    return []
  out = []
  for t in targets:
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    out += [e.id for e in elts if isinstance(e, ast.Name)]
  return out


class _Module:
  """What one module binds: functions (name -> params), classes (name ->
  node), other names, and where imported names come from."""

  def __init__(self, path: str, package: str):
    with open(path, encoding="utf-8") as f:
      tree = ast.parse(f.read(), path)
    self.functions: Dict[str, Tuple[str, ...]] = {}
    self.classes: Dict[str, ast.ClassDef] = {}
    self.names: Set[str] = set()
    self.imports: Dict[str, Tuple[str, str]] = {}  # name -> (module, attr)
    self.exported: Set[str] = set()
    for node in _statements(tree.body):
      if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        self.functions[node.name] = _params(node)
        if node.name == "__getattr__":  # names the module makes on use
          self.names |= {c.value for c in ast.walk(node)
                         if isinstance(c, ast.Constant)
                         and isinstance(c.value, str)
                         and c.value.isidentifier()}
      elif isinstance(node, ast.ClassDef):
        self.classes[node.name] = node
      elif isinstance(node, ast.ImportFrom) and node.module:
        for alias in node.names:
          bound = alias.asname or alias.name
          self.imports[bound] = (node.module, alias.name)
          self.names.add(bound)
      elif isinstance(node, ast.Import):
        for alias in node.names:
          bound = alias.asname or alias.name.split(".")[0]
          self.imports[bound] = (alias.name, "")
          self.names.add(bound)
      for name in _targets(node):
        self.names.add(name)
        if name == "__all__" and isinstance(node.value, (ast.List,
                                                          ast.Tuple)):
          self.exported |= {e.value for e in node.value.elts
                            if isinstance(e, ast.Constant)}
    if os.path.basename(path) == "__init__.py":
      self.exported |= {n for n in self.imports if _public(n)}
    self.names |= set(self.functions) | set(self.classes)

  def public(self) -> Set[str]:
    """The names the module defines or re-exports for its users."""
    own = set(self.functions) | set(self.classes)
    own |= {n for n in self.names
            if n not in self.imports and n not in ("__all__",)}
    return {n for n in own | self.exported if _public(n)}


def _members(node: ast.ClassDef) -> Dict[str, Tuple[str, ...] | None]:
  """A class's own methods (name -> params) and fields (name -> None)."""
  out: Dict[str, Tuple[str, ...] | None] = {}
  for item in node.body:
    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
      out[item.name] = _params(item)
    for name in _targets(item):
      out[name] = None
  return out


def _checked(name: str) -> bool:
  return _public(name) or name in ("__init__", "__call__")


def _modules(package: str) -> Dict[str, _Module]:
  base = os.path.join(ROOT, package)
  out = {}
  for dirpath, dirnames, filenames in os.walk(base):
    dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
    for fname in sorted(filenames):
      if fname.endswith(".py"):
        full = os.path.join(dirpath, fname)
        out[os.path.relpath(full, base)] = _Module(full, package)
  return out


def _dotted(path: str, package: str) -> str:
  mod = path[:-3].replace(os.sep, ".")
  mod = mod[:-len(".__init__")] if mod.endswith("__init__") else mod
  return f"{package}.{mod}" if mod != "__init__" else package


class _Port:
  """The port's modules, with class members resolved through the bases
  the port defines."""

  def __init__(self):
    self.modules = _modules(PORT)
    self.by_dotted = {_dotted(p, PORT): m for p, m in self.modules.items()}

  def resolve_class(self, module: _Module, name: str, depth: int = 0):
    if depth > 8:
      return None
    if name in module.classes:
      return module, module.classes[name]
    if name in module.imports:
      src, attr = module.imports[name]
      other = self.by_dotted.get(src)
      if other is not None:
        return self.resolve_class(other, attr, depth + 1)
    return None

  def members(self, module: _Module, node: ast.ClassDef, depth: int = 0):
    out: Dict[str, Tuple[str, ...] | None] = {}
    for b in reversed(node.bases):  # the first base's members win
      ref = None
      if isinstance(b, ast.Name):
        ref = self.resolve_class(module, b.id, depth + 1)
      elif isinstance(b, ast.Attribute) and isinstance(b.value, ast.Name):
        src = module.imports.get(b.value.id)
        other = (self.by_dotted.get(f"{src[0]}.{src[1]}") if src else None)
        if other is not None:
          ref = self.resolve_class(other, b.attr, depth + 1)
      if ref is not None and depth < 8:
        out.update(self.members(ref[0], ref[1], depth + 1))
    out.update(_members(node))
    return out


@functools.lru_cache(maxsize=None)
def gaps() -> Tuple[str, ...]:
  """Every gap of the port's surface against the JAX package's."""
  jax_modules = _modules(JAX)
  port = _Port()
  found = []
  for path, jm in sorted(jax_modules.items()):
    pm = port.modules.get(path)
    if pm is None:
      found.append(path)
      continue
    for name in sorted(jm.public()):
      where = f"{path}::{name}"
      if name not in pm.names:
        found.append(where)
        continue
      if name in jm.functions and name in pm.functions:
        found += [f"{where}({p})" for p in jm.functions[name]
                  if p not in pm.functions[name]]
      if name in jm.classes and name in pm.classes:
        ours = port.members(pm, pm.classes[name])
        for member, params in sorted(_members(jm.classes[name]).items()):
          if not _checked(member):
            continue
          if member not in ours:
            found.append(f"{where}.{member}")
          elif params is not None and ours[member] is not None:
            found += [f"{where}.{member}({p})" for p in params
                      if p not in ours[member]]
  return tuple(found)


def test_every_module_has_its_counterpart():
  missing = [g for g in gaps() if "::" not in g]
  assert not missing, missing


def test_every_public_name_has_its_counterpart():
  missing = [g for g in gaps()
             if "::" in g and "(" not in g and g not in DEPARTURES]
  assert not missing, missing


def test_every_parameter_has_its_counterpart():
  missing = [g for g in gaps() if "(" in g and g not in DEPARTURES]
  assert not missing, missing


def test_every_departure_is_a_gap_that_roadmap_explains():
  """The table cannot go stale: each entry still names a gap, and the
  ROADMAP.md line its reason cites is there."""
  found = set(gaps())
  stale = sorted(set(DEPARTURES) - found)
  assert not stale, f"no longer a gap, take out of DEPARTURES: {stale}"
  with open(os.path.join(ROOT, "ROADMAP.md"), encoding="utf-8") as f:
    roadmap = " ".join(f.read().split())
  for gap, (reason, line) in DEPARTURES.items():
    assert reason and line in roadmap, (gap, line)
