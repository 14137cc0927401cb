"""Every public name of the JAX package has a counterpart in the port.

Each module of `clip_retrieval_tpu` is imported (JAX on the CPU) but the
three whole modules ROADMAP's "Not to port" list names.  Its public names
are those whose `__module__` is that module; for a package `__init__`, every
name it exports, the names its module `__getattr__` resolves included.
Names a module only imports belong to the module that defines them.  Each
public name must exist on the port's module of the same path, or stand in
`EXCEPTIONS` with one of two reasons:

- `NotToPort`: the code is out of the port's scope.  The entry quotes a
  phrase of the ROADMAP "Not to port" bullet it comes from, and that bullet
  names it: the table is the list's executable form, entry for entry;
- `Renamed`: the port has it under PyTorch's idiom, at the path given.

The table cannot go stale: each entry must still be a public name of the
JAX package that the port lacks at the JAX path.  The package-level API
(`from clip_retrieval_tpu_torch import clip_inference, ...`) resolves to
the port's own objects with the JAX functions' parameters.
"""

import __future__

import ast
import dataclasses
import importlib
import inspect
import re
from pathlib import Path

import pytest

import clip_retrieval_tpu
import clip_retrieval_tpu_torch

from tests.test_torch_entrypoints import assert_parameters_match

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = "clip_retrieval_tpu", "clip_retrieval_tpu_torch"


@dataclasses.dataclass(frozen=True)
class NotToPort:
    bullet: str  # a phrase of the ROADMAP "Not to port" bullet the entry comes from


@dataclasses.dataclass(frozen=True)
class Renamed:
    counterpart: str  # the port's counterpart, a dotted path under clip_retrieval_tpu_torch


# whole JAX modules the port has no counterpart of
NOT_TO_PORT_MODULES = {
    "parallel.mesh": NotToPort("`parallel/mesh.py`"),
    "utils.compile_cache": NotToPort("`utils/compile_cache.py`"),
    "utils.transfer": NotToPort("`utils/transfer.py`"),
}
# public names of ported JAX modules that the port lacks at the same path
EXCEPTIONS = {
    "ops.attention.packed_ok": NotToPort("`_kern_packed_batched`"),
    "ops.flash.packed_group": NotToPort("`_kern_packed_batched`"),
    "parallel.local_mesh": NotToPort("`parallel/mesh.py`"),
    "parallel.shard_leading": NotToPort("`parallel/mesh.py`"),
    "parallel.replicate": NotToPort("`parallel/mesh.py`"),
    "parallel.train.param_pspec": NotToPort("`parallel/mesh.py`"),
    "parallel.train.tree_shardings": NotToPort("`parallel/mesh.py`"),
    "models.safety.JaxMLP": Renamed("models.safety.MLP"),
    "models.mclip.encode": Renamed("models.mclip.MCLIP.encode"),
}


def _module_names() -> list[str]:
    """Every module of the JAX package, as a path relative to it ("" for the
    package itself), from the source tree: collection imports nothing."""
    names = []
    for path in sorted((ROOT / JAX_PKG).rglob("*.py")):
        parts = path.relative_to(ROOT / JAX_PKG).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


MODULES = [m for m in _module_names() if m not in NOT_TO_PORT_MODULES]


def _full(pkg: str, rel: str) -> str:
    return f"{pkg}.{rel}" if rel else pkg


def _lazy_names(init_file: str) -> list[str]:
    """The names a package's module `__getattr__` resolves: the string
    constants it compares `name` with, or the keys of a dict it looks `name`
    up in."""
    tree = ast.parse(Path(init_file).read_text())
    getattr_fn = next((n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "__getattr__"), None)
    if getattr_fn is None:
        return []
    names = [c.value for node in ast.walk(getattr_fn) if isinstance(node, ast.Compare)
             and isinstance(node.left, ast.Name) and node.left.id == "name"
             for c in node.comparators if isinstance(c, ast.Constant) and isinstance(c.value, str)]
    tables = {c.id for node in ast.walk(getattr_fn) if isinstance(node, ast.Compare)
              for c in node.comparators if isinstance(c, ast.Name)}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and any(
                isinstance(t, ast.Name) and t.id in tables for t in node.targets):
            names += [k.value for k in node.value.keys if isinstance(k, ast.Constant)]
    return names


def public_names(module) -> list[str]:
    if hasattr(module, "__path__"):  # a package: every name its __init__ exports
        names = [k for k, v in vars(module).items() if not k.startswith("_") and not inspect.ismodule(v)
                 and not isinstance(v, __future__._Feature)]
        return names + _lazy_names(module.__file__)
    return [k for k, v in vars(module).items()
            if not k.startswith("_") and getattr(v, "__module__", None) == module.__name__]


def resolve(dotted: str):
    """A dotted path under the port → the object; AttributeError or
    ModuleNotFoundError when it does not exist."""
    parts = dotted.split(".")
    for cut in range(len(parts), -1, -1):
        try:
            obj = importlib.import_module(_full(PORT_PKG, ".".join(parts[:cut])))
        except ModuleNotFoundError:
            continue
        for attr in parts[cut:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(dotted)


def _not_to_port_bullets() -> list[str]:
    """The bullets of ROADMAP.md's "Not to port" list, each on one line."""
    text = (ROOT / "ROADMAP.md").read_text()
    section = text.split("**Not to port**", 1)[1].split("\n### ", 1)[0]
    return [" ".join(b.split()) for b in re.split(r"\n- ", section)[1:]]


@pytest.mark.parametrize("rel", MODULES, ids=lambda m: m or JAX_PKG)
def test_every_public_name_has_a_counterpart(rel):
    jax_module = importlib.import_module(_full(JAX_PKG, rel))
    port_module = importlib.import_module(_full(PORT_PKG, rel))
    names = public_names(jax_module)
    missing = [n for n in names if not hasattr(port_module, n) and (f"{rel}.{n}" if rel else n) not in EXCEPTIONS]
    assert not missing, f"{_full(JAX_PKG, rel)}: no counterpart in the port for {missing}"


@pytest.mark.parametrize("entry", sorted(EXCEPTIONS))
def test_exception_is_still_a_jax_public_name_the_port_lacks(entry):
    rel, name = entry.rpartition(".")[::2]
    assert name in public_names(importlib.import_module(_full(JAX_PKG, rel))), f"{entry} is no public JAX name"
    assert not hasattr(importlib.import_module(_full(PORT_PKG, rel)), name), f"the port has {entry}: drop the entry"


@pytest.mark.parametrize("entry", sorted(EXCEPTIONS) + [f"module {m}" for m in sorted(NOT_TO_PORT_MODULES)])
def test_exception_names_its_reason(entry):
    """A not-to-port entry quotes exactly one ROADMAP bullet, and that
    bullet names the entry; a renamed entry's counterpart exists."""
    if entry.startswith("module "):
        rel = entry.split()[1]
        reason, named = NOT_TO_PORT_MODULES[rel], f"`{rel.replace('.', '/')}.py`"
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(_full(PORT_PKG, rel))
    else:
        reason, named = EXCEPTIONS[entry], f"`{entry.rpartition('.')[2]}`"
    if isinstance(reason, Renamed):
        assert callable(resolve(reason.counterpart))
        return
    bullets = [b for b in _not_to_port_bullets() if reason.bullet in b]
    assert len(bullets) == 1, f"{reason.bullet!r} is in {len(bullets)} ROADMAP 'Not to port' bullets"
    assert named in bullets[0], f"the bullet {bullets[0][:80]!r}... does not name {named}"


def test_the_walk_reads_lazy_exports():
    """The JAX package's `__getattr__` names count as its public names, and
    the port's `__getattr__` tables are read the same way."""
    want = ["clip_inference", "clip_index", "clip_back", "clip_filter", "clip_end2end", "ClipClient", "Modality"]
    assert sorted(_lazy_names(clip_retrieval_tpu.__file__)) == sorted(want)
    assert sorted(_lazy_names(clip_retrieval_tpu_torch.__file__)) == sorted(want)
    assert "ClipClient" in public_names(clip_retrieval_tpu)


# -- the package-level API --------------------------------------------------

TOP_LEVEL = {"clip_inference": ("inference.main", "main"), "clip_index": ("index.build", "clip_index"),
             "clip_back": ("back.app", "clip_back"), "clip_filter": ("filter", "clip_filter"),
             "clip_end2end": ("end2end", "clip_end2end"), "ClipClient": ("client", "ClipClient"),
             "Modality": ("client", "Modality")}


@pytest.mark.parametrize("name", sorted(TOP_LEVEL))
def test_top_level_name_is_the_ported_object(name):
    module, attr = TOP_LEVEL[name]
    ours = getattr(clip_retrieval_tpu_torch, name)
    assert ours is getattr(importlib.import_module(f"{PORT_PKG}.{module}"), attr)
    theirs = getattr(clip_retrieval_tpu, name)
    if name == "Modality":
        assert [(m.name, m.value) for m in ours] == [(m.name, m.value) for m in theirs]
    elif name == "ClipClient":
        fields = lambda cls: [(f.name, getattr(f.default, "value", f.default))  # noqa: E731
                              for f in dataclasses.fields(cls)]
        assert fields(ours) == fields(theirs)
    else:
        assert_parameters_match(theirs, ours)


def test_version_and_unknown_names():
    from clip_retrieval_tpu_torch import __version__

    assert __version__ == clip_retrieval_tpu.__version__
    with pytest.raises(AttributeError, match="no_such_name"):
        clip_retrieval_tpu_torch.no_such_name  # noqa: B018


@pytest.mark.parametrize("package,names", [
    ("index", ["FlatIndex", "IVFPQIndex", "load_index", "calibrate_nprobe", "clip_index", "score_index"]),
    ("models", ["clip_forward"]), ("utils", ["braceexpand"])])
def test_subpackage_reexports_are_the_defining_modules_objects(package, names):
    port = importlib.import_module(f"{PORT_PKG}.{package}")
    for name in names:
        obj = getattr(port, name)
        assert getattr(importlib.import_module(obj.__module__), name) is obj
        assert obj.__module__.startswith(f"{PORT_PKG}.{package}.")
    with pytest.raises(AttributeError):
        getattr(port, "no_such_name")
