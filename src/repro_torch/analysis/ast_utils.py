"""AST indexing and call-graph approximation for the invariant analyzer.

Pure ``ast`` — the analyzed tree is never imported, so the pass runs
where neither torch nor jax can be imported (``repro_torch``'s
``__init__`` and ``repro_torch.analysis`` pull in nothing outside the
stdlib).

The call graph is a deliberate over-approximation suited to gating, not
to precision:

* a call is **named** when its callee is a plain name that resolves to a
  module-level/nested def, an import, or a builtin — or any attribute
  access (``obj.commit(...)`` contributes the name ``commit``);
* a call is **dynamic** when the callee is an unresolvable bare name
  (``fn()``, ``hook(self)``), a subscript (``_RUNNERS[s](...)``), or any
  other computed expression.  Dynamic dispatch cannot be proven
  ``CrashInjected``-free, so taint analyses treat it as contaminating.

Name-based resolution links a call name to *every* function in the index
whose qualified name ends with that segment.  That conflates unrelated
``commit`` methods — acceptable: the rules only ever use the graph to
widen taint, never to excuse code.
"""
from __future__ import annotations

import ast
import builtins
import fnmatch
import os
from dataclasses import dataclass, field

_BUILTIN_NAMES = frozenset(dir(builtins))


@dataclass(eq=False)
class CallSite:
    name: str | None    # last-segment callee name; None when dynamic
    lineno: int
    node: ast.Call


@dataclass(eq=False)
class FunctionInfo:
    qualname: str       # "Class.method" / "outer.inner" / "<module>"
    path: str           # display-root-relative module path
    lineno: int
    node: ast.AST
    calls: list[CallSite] = field(default_factory=list)
    names: set[str] = field(default_factory=set)   # identifiers, attrs, kwargs
    trys: list[ast.Try] = field(default_factory=list)

    @property
    def call_names(self) -> set[str]:
        return {c.name for c in self.calls if c.name is not None}

    @property
    def has_dynamic_call(self) -> bool:
        return any(c.name is None for c in self.calls)


@dataclass(eq=False)
class ModuleInfo:
    path: str                       # display-root-relative
    src_rel: str                    # scan-root-relative (for dir scoping)
    tree: ast.Module
    lines: list[str]
    imports: set[str]
    def_names: set[str]
    functions: dict[str, FunctionInfo]
    strings: set[str]


def classify_call(call: ast.Call, imports: set[str],
                  def_names: set[str]) -> CallSite:
    f = call.func
    if isinstance(f, ast.Name):
        nm = f.id
        if nm in def_names or nm in imports or nm in _BUILTIN_NAMES:
            return CallSite(nm, call.lineno, call)
        return CallSite(None, call.lineno, call)  # local var / param: dynamic
    if isinstance(f, ast.Attribute):
        return CallSite(f.attr, call.lineno, call)
    return CallSite(None, call.lineno, call)      # subscript, lambda, etc.


def index_module(abspath: str, path: str, src_rel: str) -> ModuleInfo:
    with open(abspath, encoding="utf-8") as fh:
        source = fh.read()
    tree = ast.parse(source, filename=abspath)

    imports: set[str] = set()
    def_names: set[str] = set()
    strings: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                imports.add(alias.asname or alias.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            for alias in node.names:
                imports.add(alias.asname or alias.name)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            def_names.add(node.name)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            strings.add(node.value)

    functions: dict[str, FunctionInfo] = {}

    def record(node: ast.AST, fn: FunctionInfo) -> None:
        if isinstance(node, ast.Call):
            fn.calls.append(classify_call(node, imports, def_names))
        elif isinstance(node, ast.Name):
            fn.names.add(node.id)
        elif isinstance(node, ast.Attribute):
            fn.names.add(node.attr)
        elif isinstance(node, ast.keyword) and node.arg:
            fn.names.add(node.arg)
        elif isinstance(node, ast.Try):
            fn.trys.append(node)

    def walk(node: ast.AST, stack: list[str], fn: FunctionInfo) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = ".".join(stack + [child.name]) if stack else child.name
                info = FunctionInfo(qual, path, child.lineno, child)
                functions[qual] = info
                walk(child, stack + [child.name], info)
            elif isinstance(child, ast.ClassDef):
                walk(child, stack + [child.name], fn)
            else:
                record(child, fn)
                walk(child, stack, fn)

    module_fn = FunctionInfo("<module>", path, 1, tree)
    functions["<module>"] = module_fn
    walk(tree, [], module_fn)

    return ModuleInfo(path, src_rel, tree, source.splitlines(),
                      imports, def_names, functions, strings)


class ModuleIndex:
    """Every file under ``root`` whose name matches ``file_glob`` (a
    ``*.py`` pattern), with a name-resolved call graph."""

    def __init__(self, root: str, display_root: str,
                 exclude_dirs: tuple[str, ...] = ("__pycache__",),
                 file_glob: str = "*.py") -> None:
        self.root = os.path.abspath(root)
        self.display_root = os.path.abspath(display_root)
        self.modules: dict[str, ModuleInfo] = {}
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in exclude_dirs)
            for name in sorted(filenames):
                if not fnmatch.fnmatch(name, file_glob):
                    continue
                ap = os.path.join(dirpath, name)
                path = os.path.relpath(ap, self.display_root)
                src_rel = os.path.relpath(ap, self.root)
                self.modules[path] = index_module(ap, path, src_rel)

        self.by_name: dict[str, list[FunctionInfo]] = {}
        for mod in self.modules.values():
            for info in mod.functions.values():
                last = info.qualname.rsplit(".", 1)[-1]
                self.by_name.setdefault(last, []).append(info)

        self._fault_tainted: set[FunctionInfo] | None = None
        self._dynamic_tainted: set[FunctionInfo] | None = None

    def all_functions(self):
        for mod in self.modules.values():
            yield from mod.functions.values()

    def module_of(self, fn: FunctionInfo) -> ModuleInfo:
        return self.modules[fn.path]

    def _propagate_up(self, seeds: set[FunctionInfo]) -> set[FunctionInfo]:
        """Close ``seeds`` under "calls a member" (callers get tainted)."""
        tainted = set(seeds)
        changed = True
        while changed:
            changed = False
            for fn in self.all_functions():
                if fn in tainted:
                    continue
                for name in fn.call_names:
                    if any(g in tainted for g in self.by_name.get(name, ())):
                        tainted.add(fn)
                        changed = True
                        break
        return tainted

    def propagate_down(self, seeds: set[FunctionInfo]) -> set[FunctionInfo]:
        """Close ``seeds`` under "is called by a member" (callees join)."""
        covered = set(seeds)
        changed = True
        while changed:
            changed = False
            for fn in list(covered):
                for name in fn.call_names:
                    for g in self.by_name.get(name, ()):
                        if g not in covered:
                            covered.add(g)
                            changed = True
        return covered

    def fault_tainted(self) -> set[FunctionInfo]:
        """Functions that may reach a ``fault_point`` call (transitive)."""
        if self._fault_tainted is None:
            seeds = {fn for fn in self.all_functions()
                     if "fault_point" in fn.call_names}
            self._fault_tainted = self._propagate_up(seeds)
        return self._fault_tainted

    def dynamic_tainted(self) -> set[FunctionInfo]:
        """Functions that may reach dynamic dispatch (unprovable reach)."""
        if self._dynamic_tainted is None:
            seeds = {fn for fn in self.all_functions()
                     if fn.has_dynamic_call}
            self._dynamic_tainted = self._propagate_up(seeds)
        return self._dynamic_tainted


def calls_in(node: ast.AST, mod: ModuleInfo) -> tuple[set[str], bool]:
    """(named callees, saw-dynamic-call) over an arbitrary subtree."""
    names: set[str] = set()
    dynamic = False
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            cs = classify_call(n, mod.imports, mod.def_names)
            if cs.name is None:
                dynamic = True
            else:
                names.add(cs.name)
    return names, dynamic


def attr_chain(node: ast.AST) -> list[str]:
    """``self.a.b`` -> ["self", "a", "b"]; [] when not a name/attr chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return []


def str_arg(call: ast.Call, pos: int, kwarg: str) -> str | None:
    """Literal string at positional ``pos`` or keyword ``kwarg``, else None."""
    if len(call.args) > pos:
        a = call.args[pos]
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            return a.value
        return None
    for kw in call.keywords:
        if kw.arg == kwarg:
            v = kw.value
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                return v.value
            return None
    return None


def has_kwarg(call: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in call.keywords)
