"""The port's surface held to the reference's, by parsing both packages.

For every module of ``src/repro/``, the module at the same path under
``src/repro_torch/`` must have a counterpart for every public top-level
function and class, every public method (and ``__init__``) of those
classes, every annotated class field (a dataclass's fields) and every
``add_argument`` flag; and every counterpart function must take every
argument name the reference's takes. Private helpers are left to the
parity tests. ``GAPS`` is the one table of what the port leaves out or
names otherwise, each entry with its reason; an entry that names nothing
in the reference, or a gap the port has since closed, fails the table.

Nothing is imported from either package for that: the files are parsed.
The names a reference module lists in ``__all__`` are then looked up in the
port module itself, imported, and a re-export is imported first in a fresh
interpreter.
"""
import ast
import importlib
import os
import subprocess
import sys
from typing import Dict, NamedTuple, Optional

import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
REF = os.path.join(SRC, "repro")
PORT = os.path.join(SRC, "repro_torch")


class Gap(NamedTuple):
    """``what`` in the reference: ``path.py`` (a module), ``path.py::Name``
    (a function, class or ``Class.method``), ``path.py::func(arg)`` or
    ``*(arg)`` (an argument of one function, or of every function).
    ``port``: what stands for it in the port, which must exist there (a
    path, ``path::Name``, or for an argument its new name); ``None`` where
    nothing does. ``compare``: for a module, hold the reference's surface
    to the named port module instead of skipping it."""
    what: str
    port: Optional[str]
    why: str
    compare: bool = False


GAPS = [
    # Pallas-only: the kernels themselves, replaced by the CUDA sources
    Gap("kernels/compat.py", None,
        "pallas_call's compiler-params shim across JAX versions"),
    Gap("kernels/fingerprint/kernel.py",
        "kernels/fingerprint/csrc/fingerprint.cu",
        "_fp_kernel and its launcher fingerprint_lanes are Pallas"),
    Gap("kernels/flash_attention/kernel.py",
        "kernels/flash_attention/csrc/flash_attention.cu",
        "_fa_kernel and its launcher flash_attention_fwd are Pallas"),
    Gap("kernels/ssd_scan/kernel.py", "kernels/ssd_scan/csrc/ssd_scan.cu",
        "_ssd_kernel and its launcher ssd_scan are Pallas"),
    Gap("*(interpret)", None,
        "Pallas interpret mode; the port's wrappers take the plain version "
        "for CPU tensors"),
    Gap("core/fingerprint.py::fingerprint_tree_packed(backend)", None,
        "chooses jnp or Pallas; the port launches its CUDA kernel"),
    Gap("kernels/fingerprint/ops.py::fingerprint(tile_lanes)", None,
        "the Pallas grid's tile width; the CUDA kernel picks its own"),
    Gap("core/fingerprint.py::_to_u32_lanes",
        "kernels/fingerprint/csrc/fingerprint.cu",
        "private jnp helper of the fingerprint that the CUDA kernel replaces"),
    Gap("core/fingerprint.py::_mix", "kernels/fingerprint/csrc/fingerprint.cu",
        "private jnp helper of the fingerprint that the CUDA kernel replaces"),
    Gap("core/fingerprint.py::_reduce_rows",
        "kernels/fingerprint/csrc/fingerprint.cu",
        "private jnp helper of the fingerprint that the CUDA kernel replaces"),
    Gap("core/fingerprint.py::_device_lanes_leaf",
        "kernels/fingerprint/csrc/fingerprint.cu",
        "private jnp helper of the fingerprint that the CUDA kernel replaces"),
    Gap("core/fingerprint.py::_pack_rows",
        "kernels/fingerprint/csrc/fingerprint.cu",
        "private jnp helper of the fingerprint that the CUDA kernel replaces"),
    Gap("core/fingerprint.py::_fingerprint_packed",
        "kernels/fingerprint/ops.py::fingerprint_leaves",
        "the jitted packed pass; the port's launches the CUDA kernel"),
    # JAX randomness
    Gap("*(key)", None,
        "a JAX PRNG key; the port draws from a torch.Generator or a seed"),
    # the roofline counts from the dispatcher, not from compiled HLO
    Gap("roofline/hlo_parse.py", "roofline/count.py",
        "parses compiled HLO text; the port counts the torch dispatcher"),
    Gap("roofline/analyze.py::analyze_compiled",
        "roofline/analyze.py::analyze_step",
        "reads a compiled executable; the port runs the step under the "
        "counter"),
    Gap("roofline/analyze.py::collective_bytes(hlo_text)", "coll",
        "the port takes the counter's bytes by kind, not HLO text"),
    # version shims and renames
    Gap("sharding/ctx.py::shard_map_fn", "sharding/ctx.py::local_call",
        "a shim over jax.shard_map's move between JAX versions"),
    Gap("configs/registry.py", "configs/__init__.py",
        "the port keeps the registry in the package's __init__", True),
    Gap("core/chunker.py::tensor_to_bytes(arr)", "t",
        "renamed: the port's leaves are torch tensors"),
    Gap("core/chunker.py::tensor_chunk_bytes(arr)", "t",
        "renamed: the port's leaves are torch tensors"),
    Gap("core/chunker.py::chunk_tensor(arr)", "t",
        "renamed: the port's leaves are torch tensors"),
    Gap("kernels/fingerprint/ops.py::fingerprint(arr)", "t",
        "renamed: the port's leaves are torch tensors"),
]


def _modules(root: str) -> Dict[str, ast.Module]:
    out = {}
    for d, _, files in os.walk(root):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(d, fn)
                with open(path) as f:
                    out[os.path.relpath(path, root)] = ast.parse(f.read())
    return out


REF_MODULES = _modules(REF)
PORT_MODULES = _modules(PORT)


def _args(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _public(name: str) -> bool:
    return not name.startswith("_") or name == "__init__"


def _defs(tree: ast.Module) -> Dict[str, object]:
    """Every top-level and class-level def and class, by qualified name
    (private ones too, for the table's checks)."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            out[node.name] = node
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{m.name}"] = m
                elif isinstance(m, ast.AnnAssign) and \
                        isinstance(m.target, ast.Name):
                    out[f"{node.name}.{m.target.id}"] = m
    return out


def _surface(tree: ast.Module) -> Dict[str, object]:
    """Public names -> their nodes; ``flag:--x`` for add_argument flags."""
    out = {}
    for name, node in _defs(tree).items():
        parts = name.split(".")
        if _public(parts[0]) and (len(parts) == 1 or _public(parts[1])):
            out[name] = node
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "add_argument":
            for a in node.args:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    out[f"flag:{a.value}"] = node
    return out


def _is_fn(node) -> bool:
    return isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))


def _split(what: str):
    """-> (module, name or None, arg or None)."""
    arg = None
    if what.endswith(")"):
        what, arg = what[:-1].split("(")
    module, _, name = what.partition("::")
    return module, name or None, arg


MODULE_GAPS = {g.what: g for g in GAPS if _split(g.what)[1:] == (None, None)}
NAME_GAPS = {g.what: g for g in GAPS if _split(g.what)[1] and
             not _split(g.what)[2]}


def _arg_gap(module: str, func: str, arg: str) -> Optional[Gap]:
    for g in GAPS:
        m, name, a = _split(g.what)
        if a == arg and (m == "*" or (m == module and name == func)):
            return g
    return None


def _gaps_of(module: str, port_module: str):
    """-> (missing names, missing args) of one reference module, against
    the named port module, before the table is applied."""
    ref, port = _surface(REF_MODULES[module]), _surface(
        PORT_MODULES[port_module])
    names, args = [], []
    for name, node in ref.items():
        if name not in port:
            names.append(name)
        elif _is_fn(node) and _is_fn(port[name]):
            have = set(_args(port[name]))
            args += [(name, a) for a in _args(node) if a not in have]
    return names, args


def _port_module(module: str) -> Optional[str]:
    g = MODULE_GAPS.get(module)
    if g is None:
        return module
    return g.port if g.compare else None


CHECKED = sorted(m for m in REF_MODULES if _port_module(m) is not None)


@pytest.mark.parametrize("module", CHECKED)
def test_port_module_has_the_references_surface(module):
    port_module = _port_module(module)
    assert port_module in PORT_MODULES, f"no {port_module} in the port"
    names, args = _gaps_of(module, port_module)
    missing = [n for n in names if f"{module}::{n}" not in NAME_GAPS]
    assert missing == [], f"{module}: the port lacks {missing}"
    missing = [f"{fn}({a})" for fn, a in args
               if _arg_gap(module, fn, a) is None]
    assert missing == [], f"{module}: the port's functions lack {missing}"


def _exists_in_port(ref: str) -> bool:
    module, _, name = ref.partition("::")
    if module not in PORT_MODULES:
        return os.path.exists(os.path.join(PORT, module))
    return not name or name in _defs(PORT_MODULES[module])


@pytest.mark.parametrize("gap", GAPS, ids=[g.what for g in GAPS])
def test_every_gap_is_real_and_has_a_reason(gap):
    """An entry must name something the reference has and the port still
    lacks (or names otherwise), with a reason, and its counterpart must
    exist in the port."""
    assert gap.why.strip()
    module, name, arg = _split(gap.what)
    if module == "*":           # an argument left out wherever it occurs
        uses = [(m, fn) for m in CHECKED
                for fn, a in _gaps_of(m, _port_module(m))[1] if a == arg]
        assert uses, f"no port function lacks {arg!r}: drop the entry"
        return
    assert module in REF_MODULES, f"the reference has no {module}"
    if name is None:            # a whole module
        assert module not in PORT_MODULES, \
            f"the port has {module} at the same path: drop the entry"
    else:
        ref_defs = _defs(REF_MODULES[module])
        assert name in ref_defs, f"the reference has no {module}::{name}"
        if arg is None:
            port_defs = _defs(PORT_MODULES.get(module, ast.Module([], [])))
            assert name not in port_defs, \
                f"the port has {module}::{name}: drop the entry"
        else:
            assert arg in _args(ref_defs[name]), \
                f"{module}::{name} takes no {arg!r} in the reference"
            port_defs = _defs(PORT_MODULES[module])
            assert name in port_defs, f"the port has no {module}::{name}"
            port_args = _args(port_defs[name])
            assert arg not in port_args, \
                f"the port's {name} takes {arg!r}: drop the entry"
            if gap.port is not None:
                assert gap.port in port_args, \
                    f"the port's {name} takes no {gap.port!r}"
            return
    if gap.port is not None:
        assert _exists_in_port(gap.port), f"no {gap.port} in the port"


def test_the_table_excuses_nothing_twice():
    assert len({g.what for g in GAPS}) == len(GAPS)


def _exports(tree: ast.Module) -> list:
    """The names of a module's literal ``__all__`` (none if it has none)."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return list(ast.literal_eval(node.value))
    return []


def _defined_in(module: str, name: str) -> str:
    """The reference module that defines ``name`` as ``module`` binds it: the
    source of a relative ``from .x import name``, else ``module`` itself."""
    package = os.path.dirname(module)
    for node in REF_MODULES[module].body:
        if isinstance(node, ast.ImportFrom) and node.level >= 1 and \
                any((a.asname or a.name) == name for a in node.names):
            base = package
            for _ in range(node.level - 1):
                base = os.path.dirname(base)
            path = os.path.join(base, *(node.module or "").split("."))
            return path + ".py" if path + ".py" in REF_MODULES \
                else os.path.join(path, "__init__.py")
    return module


EXPORTING = sorted(m for m in REF_MODULES
                   if _exports(REF_MODULES[m]) and _port_module(m))


@pytest.mark.parametrize("module", EXPORTING)
def test_port_module_binds_every_name_the_references_all_lists(module):
    """What a caller imports from the reference's module by name (its
    ``__all__``, re-exports included) imports from the port's; a name the
    port leaves out on purpose has its ``GAPS`` row where the reference
    defines it. The port module is imported, so a name bound on first use
    (a module ``__getattr__``) counts."""
    port_module = _port_module(module)
    dotted = "repro_torch." + port_module[:-len(".py")].replace(os.sep, ".")
    mod = importlib.import_module(dotted.removesuffix(".__init__"))
    missing = [n for n in _exports(REF_MODULES[module])
               if not hasattr(mod, n)
               and f"{_defined_in(module, n)}::{n}" not in NAME_GAPS]
    assert missing == [], f"{module}: the port's {dotted} lacks {missing}"


@pytest.mark.parametrize("statement", [
    "from repro_torch.kernels.fingerprint.ref import fingerprint_chunks_ref\n"
    "import repro_torch.core.fingerprint as fp\n"
    "assert fingerprint_chunks_ref is fp.fingerprint_chunks_ref",
    "from repro_torch.optim import (compressed_psum, dequantize_int8,\n"
    "                               init_error_feedback, quantize_int8)\n"
    "from repro_torch.optim import compression as c\n"
    "assert (compressed_psum, dequantize_int8, init_error_feedback,\n"
    "        quantize_int8) == (c.compressed_psum, c.dequantize_int8,\n"
    "                           c.init_error_feedback, c.quantize_int8)",
], ids=["fingerprint_ref", "optim"])
def test_a_re_export_imports_first_in_a_fresh_interpreter(statement):
    """A re-exported name imports in a process that imports nothing of the
    port before it: ``kernels/fingerprint/ref.py`` binds its oracle on first
    use, since ``core/fingerprint.py`` imports that module."""
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", statement], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
