"""The port covers the reference's public surface, name by name.

Every module ``src/repro/<path>.py`` is read with ``ast`` (nothing of
``jax`` or ``repro`` is imported) and held against ``src/repro_torch/<path>.py``:
each public top-level function, class and constant, each public method,
each class-level field and each parameter of a public function or method
must have a counterpart of the same name there.  A name the port module
imports counts, and a class or function it imports is followed to its
definition in the port for its members and parameters.

What the port deliberately leaves out stands in ``DECIDED``, keyed
``path::Qualified.name[(param)]`` (``path::*`` for a whole module), with the
reason and, where one exists, the port's counterpart.  An entry whose
reference item is gone or now has a counterpart fails ``test_no_stale_entry``.
"""

from __future__ import annotations

import ast
from functools import lru_cache
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

_INTERPRET = ("Pallas interpret mode; the port picks the device instead "
              "(ops/platform.py::resolve_device)")
_SHIM = ("a deprecated adapter onto the ops registry with no importer in the repo; "
         "callers use ops")

DECIDED: Dict[str, str] = {
    # -- eager PyTorch has only the unrolled layer loop ------------------------
    "core/scan_ctl.py::*": "lax.scan vs unrolled layer loops; eager PyTorch has only the "
                           "unrolled form (ROADMAP A, 'Decided, no counterpart')",
    "models/layers.py::scan_blocks": "lax.scan over stacked layers; the port loops over the "
                                     "layers (models/transformer.py::DecoderLM)",
    "configs/base.py::ModelConfig.scan_layers": "selects lax.scan vs unrolled; eager PyTorch "
                                                "has only the unrolled loop",
    "configs/base.py::ModelConfig.kv_update": "an XLA lowering choice (one-hot vs "
                                              "dynamic_update_slice) with the same numbers; the "
                                              "port writes with index_copy_",
    # -- deprecation shims ---------------------------------------------------------
    "kernels/__init__.py::warn_shim": _SHIM,
    "kernels/crossbar_matmul/ops.py::*": _SHIM,
    "kernels/flash_star/ops.py::*": _SHIM,
    "kernels/ssd_scan/ops.py::*": _SHIM,
    "kernels/star_softmax/ops.py::*": _SHIM,
    # -- Pallas interpret mode -----------------------------------------------------
    "ops/specs.py::SoftmaxSpec.interpret": _INTERPRET,
    "ops/specs.py::AttentionSpec.interpret": _INTERPRET,
    "ops/specs.py::PagedAttentionSpec.interpret": _INTERPRET,
    "ops/specs.py::MatmulSpec.interpret": _INTERPRET,
    "ops/specs.py::ScanSpec.interpret": _INTERPRET,
    "kernels/flash_star/kernel.py::flash_star_attention(interpret)": _INTERPRET,
    "kernels/paged_attention/kernel.py::paged_flash_attention(interpret)": _INTERPRET,
    "ops/platform.py::default_interpret": _INTERPRET,
    "ops/platform.py::detected_platform": _INTERPRET,
    "ops/platform.py::resolve_interpret": _INTERPRET,
    "ops/__init__.py::default_interpret": _INTERPRET,
    "ops/__init__.py::detected_platform": _INTERPRET,
    "ops/__init__.py::resolve_interpret": _INTERPRET,
    # -- the Pallas entry points under the port's names ----------------------------
    "kernels/star_softmax/kernel.py::star_softmax_pallas":
        "kernels/star_softmax/kernel.py::star_softmax_kernel",
    "kernels/crossbar_matmul/kernel.py::crossbar_matmul_pallas":
        "kernels/crossbar_matmul/kernel.py::crossbar_matmul",
    "kernels/ssd_scan/kernel.py::ssd_scan_pallas": "kernels/ssd_scan/kernel.py::ssd_scan",
    "kernels/flash_star/kernel.py::flash_star_attention(block_q)":
        "the Pallas q tiling; a q row's result does not depend on it (the CUDA kernels "
        "fix their own tiles)",
    "kernels/flash_star/kernel.py::DEFAULT_BLOCK_Q": "the Pallas q tiling (see block_q)",
    "kernels/flash_star/ref.py::flash_star_ref(q_offset)":
        "carried in the port's info vector (kernels/flash_star/ref.py::flash_star_ref(info))",
    "kernels/flash_star/ref.py::flash_star_ref(kv_valid_len)":
        "carried in the port's info vector (kernels/flash_star/ref.py::flash_star_ref(info))",
    # -- typing names, TPU and JAX specifics ---------------------------------------
    "configs/__init__.py::Dict": "a typing name",
    "launch/train.py::TPU_PERF_FLAGS": "XLA flags for the TPU",
    "launch/mesh.py::make_mesh(devices)": "a list of JAX devices; the port's mesh spans the "
                                          "torch.distributed group",
    "distributed/elastic.py::plan_mesh(devices)": "a list of JAX devices; the port's mesh "
                                                  "spans the torch.distributed group",
    "launch/mesh.py::AxisType": "jax.sharding.AxisType where the installed JAX has it",
    "launch/roofline.py::collective_bytes": "parses compiled HLO text; the port counts "
                                            "collectives as they run (launch/roofline.py::"
                                            "CostCounter)",
    "serve/engine.py::ContinuousBatchingEngine.jit_cache_entries":
        "serve/engine.py::ContinuousBatchingEngine.graph_entries (captured CUDA graphs)",
    "core/attention.py::blocked_attention(rescale)":
        "never read by the reference's body",
    "serve/engine.py::sample_token(serve_cfg)":
        "the port passes temperature / star_sampling (serve/engine.py::sample_token)",
    # -- JAX PRNG keys: the port draws from a seed or a torch.Generator ----------
    "models/param.py::materialize(key)": "models/param.py::materialize(seed)",
    "train/state.py::init_state(key)": "train/state.py::init_state(seed)",
    "serve/engine.py::sample_token(key)": "serve/engine.py::sample_token(generators)",
    "serve/engine.py::ServeEngine.generate(key)": "serve/engine.py::ServeEngine(seed)",
    "serve/engine.py::ContinuousBatchingEngine.__init__(base_key)":
        "serve/engine.py::ContinuousBatchingEngine.__init__(seed)",
    # -- models/: signatures the port covers another way --------------------------
    "models/layers.py::spec_attention(cross)": "never read by the reference's body: the "
                                               "cross-attention spec is the self-attention one",
    "models/rglru.py::local_attn_block(cache_len)": "the port's cache carries its len "
                                                    "(models/rglru.py::local_attn_block(cache))",
    "models/rglru.py::local_attn_block(return_kv)": "the port always returns the fresh (k, v) "
                                                    "(models/rglru.py::local_attn_block)",
}

_PYTREE = "a typing name (the port's trees are dicts of tensors)"
DECIDED.update({f"{m}::PyTree": _PYTREE for m in (
    "checkpoint/checkpointer.py", "distributed/collectives.py",
    "distributed/pipeline_parallel.py", "models/param.py", "optim/adamw.py",
    "serve/engine.py", "train/loop.py", "train/state.py", "train/step.py")})


def _rel(path: Path, base: Path) -> str:
    return path.relative_to(base).as_posix()


@lru_cache(maxsize=None)
def _parse(path: Path) -> Optional[ast.Module]:
    return ast.parse(path.read_text(), filename=str(path)) if path.exists() else None


def _public(name: str) -> bool:
    return not name.startswith("_")


def _top_statements(body) -> Iterator[ast.stmt]:
    """Top-level statements, looking into ``if`` / ``try`` blocks."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _top_statements(node.body)
            yield from _top_statements(node.orelse)
        elif isinstance(node, ast.Try):
            yield from _top_statements(node.body)
            for h in node.handlers:
                yield from _top_statements(h.body)
            yield from _top_statements(node.orelse)
        else:
            yield node


def _targets(node: ast.stmt) -> Iterator[str]:
    if isinstance(node, ast.Assign):
        for t in node.targets:
            for n in ast.walk(t):
                if isinstance(n, ast.Name):
                    yield n.id
    elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        yield node.target.id


def _module_path(base: Path, dotted: str) -> Optional[Path]:
    parts = dotted.split(".")
    for cand in (base.joinpath(*parts).with_suffix(".py"),
                 base.joinpath(*parts, "__init__.py")):
        if cand.exists():
            return cand
    return None


class _Module:
    """The names a module defines and imports."""

    def __init__(self, path: Path, pkg: str, base: Path):
        tree = _parse(path)
        self.defs: Dict[str, ast.AST] = {}
        self.imports: Dict[str, Tuple[str, str]] = {}  # local -> (module, name)
        self.assigned: set = set()
        for node in _top_statements(tree.body):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                self.defs[node.name] = node
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                for name in _targets(node):
                    self.assigned.add(name)
                    if isinstance(node.value, ast.Name):
                        self.defs.setdefault(name, node.value)  # an alias
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if node.level:
                    here = _rel(path.parent, base.parent).split("/")
                    up = here[:len(here) - node.level + 1]
                    mod = ".".join(up + ([mod] if mod else []))
                for a in node.names:
                    self.imports[a.asname or a.name] = (mod, a.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    self.imports[a.asname or a.name.split(".")[0]] = (a.name, "")
        self.pkg, self.base = pkg, base

    def names(self) -> set:
        return set(self.defs) | self.assigned | set(self.imports)

    def resolve(self, name: str, depth: int = 0):
        """``name``'s definition node and the module holding it, following
        aliases and imports inside the package; None when it leaves it."""
        if depth > 8:
            return None
        node = self.defs.get(name)
        if isinstance(node, ast.Name):
            return self.resolve(node.id, depth + 1) if node.id != name else None
        if node is not None:
            return node, self
        if name in self.imports:
            mod, attr = self.imports[name]
            if not (mod == self.pkg or mod.startswith(self.pkg + ".")):
                return None
            sub = mod[len(self.pkg) + 1:] if mod != self.pkg else ""
            if attr:
                target = _module_path(self.base, sub.replace(".", "/")) if sub else \
                    self.base / "__init__.py"
                if target is not None:
                    return _load(target, self.pkg, self.base).resolve(attr, depth + 1)
        return None


@lru_cache(maxsize=None)
def _load(path: Path, pkg: str, base: Path) -> _Module:
    return _Module(path, pkg, base)


def _params(fn: ast.AST) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return [n for n in names if n not in ("self", "cls")]


def _class_members(cls: ast.ClassDef, mod: _Module, depth: int = 0):
    """Methods and fields of a class, its bases in the package included;
    a port class's ``self.<name> =`` assignments count as fields."""
    methods: Dict[str, ast.AST] = {}
    fields: set = set()
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            methods[node.name] = node
            for sub in ast.walk(node):
                if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    tgts = sub.targets if isinstance(sub, ast.Assign) else [sub.target]
                    for t in tgts:
                        if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                                and t.value.id == "self"):
                            fields.add(t.attr)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            fields.update(_targets(node))
    if depth < 4:
        for b in cls.bases:
            if isinstance(b, ast.Name):
                got = mod.resolve(b.id)
                if got is not None and isinstance(got[0], ast.ClassDef):
                    m2, f2 = _class_members(got[0], got[1], depth + 1)
                    for k, v in m2.items():
                        methods.setdefault(k, v)
                    fields |= f2
    return methods, fields


def _ref_items(rel: str) -> Iterator[str]:
    """The reference module's public surface: ``name``, ``Class.member``,
    ``function(param)`` and ``Class.method(param)`` keys."""
    mod = _load(REF / rel, "repro", REF)
    if rel.endswith("__init__.py"):
        for name in sorted(mod.imports):
            m, attr = mod.imports[name]
            if _public(name) and attr and m != "__future__":
                yield name
    for name, node in mod.defs.items():
        if not _public(name):
            continue
        yield name
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for p in _params(node):
                yield f"{name}({p})"
        elif isinstance(node, ast.ClassDef):
            methods, fields = _class_members(node, mod)
            own = {n.name for n in node.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
            for f in sorted(fields):
                if _public(f):
                    yield f"{name}.{f}"
            for m, fn in methods.items():
                if m not in own:
                    continue
                if _public(m):
                    yield f"{name}.{m}"
                if _public(m) or m in ("__init__", "__call__"):
                    for p in _params(fn):
                        yield f"{name}.{m}({p})"
    for name in sorted(mod.assigned - set(mod.defs)):
        if _public(name):
            yield name


def _missing(rel: str) -> Iterator[str]:
    """Keys of the reference's items with no counterpart in the port."""
    port_path = PORT / rel
    if not port_path.exists():
        yield f"{rel}::*"
        return
    port = _load(port_path, "repro_torch", PORT)
    names = port.names()
    gone: set = set()
    for item in _ref_items(rel):
        head = item.split("(")[0].split(".")[0]
        if head in gone:
            continue
        if "." not in item and "(" not in item:
            if item not in names:
                gone.add(item)
                yield f"{rel}::{item}"
            continue
        got = port.resolve(head)
        if got is None:
            continue  # an import from outside the package: nothing to follow
        node, owner = got
        rest = item[len(head):]
        if rest.startswith("("):
            fn = node
            if isinstance(node, ast.ClassDef):
                fn = _class_members(node, owner)[0].get("__init__")
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if rest[1:-1] not in _params(fn):
                    yield f"{rel}::{item}"
            continue
        if not isinstance(node, ast.ClassDef):
            yield f"{rel}::{item}"
            continue
        methods, fields = _class_members(node, owner)
        member = rest[1:].split("(")[0]
        if member not in methods and member not in fields:
            if "(" not in rest:
                yield f"{rel}::{item}"
            continue
        if "(" in rest:
            fn = methods.get(member)
            if fn is not None and rest.split("(")[1][:-1] not in _params(fn):
                yield f"{rel}::{item}"


def _all_items() -> set:
    keys = set()
    for rel in REF_MODULES:
        keys.add(f"{rel}::*")
        keys.update(f"{rel}::{item}" for item in _ref_items(rel))
    return keys


REF_MODULES = sorted(_rel(p, REF) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("rel", REF_MODULES)
def test_reference_module_has_its_counterpart(rel):
    missing = [k for k in _missing(rel) if k not in DECIDED]
    assert not missing, (
        f"{len(missing)} public names / fields / parameters of src/repro/{rel} have no "
        f"counterpart in src/repro_torch/{rel} and no DECIDED entry:\n  "
        + "\n  ".join(missing))


def test_no_stale_entry():
    """Every DECIDED entry names an item the reference still has and the
    port still lacks."""
    items = _all_items()
    missing = {k for rel in REF_MODULES for k in _missing(rel)}
    stale = sorted(k for k in DECIDED if k not in items or k not in missing)
    assert not stale, f"stale DECIDED entries: {stale}"


if __name__ == "__main__":
    for rel in REF_MODULES:
        for k in _missing(rel):
            print(("  decided " if k in DECIDED else "MISSING ") + k)
