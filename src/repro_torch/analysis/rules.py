"""The five protocol-invariant rules (R1-R5) and the crash-seam allowlist.

Each rule encodes a convention that an earlier bugfix established in the
reference — the analyzer turns that history into a gate.  Rules never excuse
code via the call graph's *precision*; resolution is name-based and
over-approximate, so the graph only ever widens what a rule flags
(R2/R1) or what it credits as covered (R3/R4).

The ``CRASH_SEAM_ALLOWLIST`` is the single source of truth for broad
``except`` seams in ``src/repro_torch/{core,ft,serve}``: every ``# noqa:
BLE001`` in those trees must have an entry here (with a recorded
reason), and every entry must still point at a real broad handler —
both directions are enforced by R2 itself.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Callable

from .ast_utils import (ModuleIndex, attr_chain, calls_in, has_kwarg,
                        str_arg)
from .findings import Finding

FAULT_CALL = "fault_point"
SPEC_CALL = "FaultSpec"
BROAD_EXC = frozenset({"Exception", "BaseException"})
DURABILITY_MARKERS = frozenset({
    "_durability_scope", "_BatchScope", "sync_for_commit",
    "ensure_blob_durable", "fsync",
})
# Modules defining the durability primitive ARE the durability layer.
DURABILITY_IMPL_DEF = "sync_for_commit"
RETENTION_TRIGGERS = frozenset({"remove_image", "prune_steps", "gc"})
RETENTION_MARKERS = frozenset({
    "leased", "lease_holders", "protect_paths", "_protected_paths",
})


@dataclass(frozen=True)
class SeamExemption:
    where: str    # "<display-relative path>::<qualname>"
    reason: str


CRASH_SEAM_ALLOWLIST: tuple[SeamExemption, ...] = (
    SeamExemption(
        "src/repro_torch/core/registry.py::RelayNode.negotiate",
        "per-child isolation: a child that dies (CrashInjected) or drops "
        "during negotiate is marked failed and retried by _retry_failed; "
        "the relay itself crashes only at its own fault points"),
    SeamExemption(
        "src/repro_torch/core/registry.py::RelayNode.probe_blobs",
        "per-child isolation: probe failure marks the child failed "
        "instead of killing the whole fan-out"),
    SeamExemption(
        "src/repro_torch/core/registry.py::RelayNode.receive_blob",
        "per-child isolation: a child dying mid-forward must not abort "
        "the remaining children's writes"),
    SeamExemption(
        "src/repro_torch/core/registry.py::RelayNode._fan_children",
        "per-child isolation during layer fan and finalize; failed "
        "children are re-pushed by _retry_failed or quarantined"),
    SeamExemption(
        "src/repro_torch/core/registry.py::_retry_failed",
        "retry loop: a child's CrashInjected means THAT child died; the "
        "next attempt is its restarted process (kill-matrix semantics), "
        "exhaustion quarantines the child instead of raising"),
    SeamExemption(
        "src/repro_torch/core/registry.py::replicate_fanout.plan",
        "per-replica isolation: one replica failing negotiate/plan must "
        "not stop the others; failure is recorded via fail(i, e)"),
    SeamExemption(
        "src/repro_torch/core/registry.py::replicate_fanout.receive",
        "per-replica isolation during blob shipping; recorded via "
        "fail(i, e) and surfaced in the fan-out report"),
    SeamExemption(
        "src/repro_torch/core/registry.py::replicate_fanout.safe_finalize",
        "per-replica isolation at commit: a replica that dies before "
        "finalize stays uncommitted (torn-free) and is reported failed"),
    SeamExemption(
        "src/repro_torch/core/store.py::LayerStore.gc",
        "a broken gc hook must never break the sweep; CrashInjected is "
        "re-raised by the preceding handler so kill-matrix crashes "
        "still propagate"),
    SeamExemption(
        "src/repro_torch/ft/retry.py::RetryPolicy.execute",
        "deliberately retries CrashInjected: the next attempt IS the "
        "restarted process, which is exactly what the kill matrix "
        "simulates; exhaustion re-raises"),
    SeamExemption(
        "src/repro_torch/ft/chaos.py::run_matrix",
        "soak harness: every cell failure must be collected into the "
        "one-line repro report instead of aborting the matrix"),
    SeamExemption(
        "src/repro_torch/serve/engine.py::CheckpointFollower.poll",
        "bookkeeping only: counts consecutive poll errors, then "
        "re-raises unconditionally (compliant; listed for BLE001)"),
    SeamExemption(
        "src/repro_torch/serve/engine.py::CheckpointFollower._repair_revision",
        "verify-gated repair degrades to 'revision stays unverified' on "
        "peer errors; CrashInjected is re-raised by the preceding "
        "handler so simulated SIGKILLs still surface from poll()"),
    SeamExemption(
        "src/repro_torch/serve/engine.py::CheckpointFollower.poll_and_refresh",
        "refresh failure rolls the engine back to the last good "
        "revision; Engine.refresh is an in-memory swap that reaches no "
        "fault point"),
)


@dataclass(frozen=True)
class Rule:
    id: str
    title: str
    severity: str
    contract: str
    motivation: str
    check: Callable[["RuleContext"], list[Finding]]


class RuleContext:
    def __init__(self, config, src: ModuleIndex,
                 tests: ModuleIndex | None,
                 chaos: "object | None") -> None:
        self.config = config
        self.src = src
        self.tests = tests
        self.chaos = chaos  # ModuleInfo parsed from config.chaos_path


# --------------------------------------------------------------------------
# helpers

def _fault_point_sites(ctx: RuleContext):
    """Yield (fn, call, point-or-None) for every fault_point() in src."""
    for fn in ctx.src.all_functions():
        for cs in fn.calls:
            if cs.name == FAULT_CALL:
                yield fn, cs.node, str_arg(cs.node, 0, "point")


def _spec_points(index: ModuleIndex | None, extra_mod=None):
    """Yield (path, lineno, point) for literal FaultSpec(point=...) args."""
    mods = list(index.modules.values()) if index is not None else []
    if extra_mod is not None:
        mods.append(extra_mod)
    for mod in mods:
        for fn in mod.functions.values():
            for cs in fn.calls:
                if cs.name != SPEC_CALL:
                    continue
                point = str_arg(cs.node, 0, "point")
                if point is not None:
                    yield mod.path, cs.lineno, point


def _exc_names(t: ast.AST | None) -> set[str]:
    if t is None:
        return set()
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    out: set[str] = set()
    for e in elts:
        if isinstance(e, ast.Name):
            out.add(e.id)
        elif isinstance(e, ast.Attribute):
            out.add(e.attr)
    return out


def _is_broad(h: ast.ExceptHandler) -> bool:
    return h.type is None or bool(_exc_names(h.type) & BROAD_EXC)


def _reraises(h: ast.ExceptHandler) -> bool:
    for n in ast.walk(h):
        if isinstance(n, ast.Raise):
            if n.exc is None:
                return True
            if (h.name and isinstance(n.exc, ast.Name)
                    and n.exc.id == h.name):
                return True
    return False


def _crash_guarded(handlers: list[ast.ExceptHandler],
                   upto: int) -> bool:
    """True when a handler BEFORE index ``upto`` re-raises CrashInjected."""
    for h in handlers[:upto]:
        if "CrashInjected" in _exc_names(h.type):
            if any(isinstance(n, ast.Raise) for n in ast.walk(h)):
                return True
    return False


def _in_dirs(mod, dirs: tuple[str, ...] | None) -> bool:
    if dirs is None:
        return True
    top = mod.src_rel.replace("\\", "/").split("/", 1)[0]
    return top in dirs


# --------------------------------------------------------------------------
# R1: fault-point coverage

def _check_r1(ctx: RuleContext) -> list[Finding]:
    out: list[Finding] = []
    chaos_strings = ctx.chaos.strings if ctx.chaos is not None else None
    test_strings: set[str] = set()
    if ctx.tests is not None:
        for mod in ctx.tests.modules.values():
            test_strings |= mod.strings

    src_points: dict[str, tuple[str, int]] = {}
    for fn, call, point in _fault_point_sites(ctx):
        if point is None:
            out.append(Finding(
                "R1", "error", fn.path, call.lineno,
                f"nonliteral:{fn.qualname}",
                "fault_point() name is not a string literal — coverage "
                "cannot be checked statically"))
            continue
        src_points.setdefault(point, (fn.path, call.lineno))

    for point, (path, line) in sorted(src_points.items()):
        if chaos_strings is not None and point not in chaos_strings:
            out.append(Finding(
                "R1", "error", path, line, f"chaos-missing:{point}",
                f"fault point {point!r} is not exercised by the chaos "
                "scenario matrix (no literal occurrence in the chaos "
                "module)"))
        if ctx.tests is not None and point not in test_strings:
            out.append(Finding(
                "R1", "error", path, line, f"test-missing:{point}",
                f"fault point {point!r} never appears in any test — a "
                "dead kill-matrix cell proves nothing"))

    known = sorted(src_points)
    for path, line, point in _spec_points(ctx.tests, ctx.chaos):
        if point.endswith("*"):
            prefix = point[:-1]
            ok = any(p.startswith(prefix) for p in known)
        else:
            ok = point in known
        if not ok:
            out.append(Finding(
                "R1", "error", path, line, f"dead-spec:{point}",
                f"FaultSpec targets {point!r} but no such fault point "
                "exists in src — dead or typo'd injection"))
    return out


# --------------------------------------------------------------------------
# R2: crash-seam soundness

def _check_r2(ctx: RuleContext) -> list[Finding]:
    out: list[Finding] = []
    cfg = ctx.config
    allow = {e.where: e for e in cfg.allowlist}
    tainted = ctx.src.fault_tainted()
    dynamic = ctx.src.dynamic_tainted()
    seen_sites: set[str] = set()

    for mod in ctx.src.modules.values():
        in_scope = _in_dirs(mod, cfg.protocol_dirs)
        ble_scoped = _in_dirs(mod, cfg.ble_dirs) if cfg.ble_dirs else False
        for fn in mod.functions.values():
            where = f"{fn.path}::{fn.qualname}"
            for t in fn.trys:
                for i, h in enumerate(t.handlers):
                    if not _is_broad(h):
                        continue
                    seen_sites.add(where)
                    if ble_scoped:
                        line = mod.lines[h.lineno - 1] if (
                            h.lineno <= len(mod.lines)) else ""
                        if "noqa: BLE001" in line and where not in allow:
                            out.append(Finding(
                                "R2", "error", fn.path, h.lineno,
                                f"noqa-unlisted:{fn.qualname}",
                                "broad handler carries '# noqa: BLE001' "
                                "but has no CRASH_SEAM_ALLOWLIST entry — "
                                "the allowlist is the single source of "
                                "truth for blind-except exemptions"))
                    if not in_scope:
                        continue
                    if _reraises(h) or _crash_guarded(t.handlers, i):
                        continue
                    names, dyn = calls_in(ast.Module(body=t.body,
                                                     type_ignores=[]), mod)
                    reaches = FAULT_CALL in names or any(
                        g in tainted
                        for n in names for g in ctx.src.by_name.get(n, ()))
                    unprovable = dyn or any(
                        g in dynamic
                        for n in names for g in ctx.src.by_name.get(n, ()))
                    if not (reaches or unprovable):
                        continue
                    if where in allow:
                        continue
                    why = ("can reach a fault_point call"
                           if reaches else
                           "dispatches dynamically, so it cannot be "
                           "proven CrashInjected-free")
                    out.append(Finding(
                        "R2", "error", fn.path, h.lineno,
                        f"swallow:{fn.qualname}",
                        f"broad except in {fn.qualname} {why} but neither "
                        "re-raises, is CrashInjected-guarded, nor is "
                        "allowlisted — a swallowed CrashInjected voids "
                        "the SIGKILL kill matrix"))

    for where, exemption in sorted(allow.items()):
        if where not in seen_sites:
            out.append(Finding(
                "R2", "error", where.split("::")[0], 1,
                f"stale-exemption:{where.split('::')[1]}",
                f"CRASH_SEAM_ALLOWLIST entry {where!r} matches no "
                "existing broad except handler — remove the stale entry"))
        elif not exemption.reason.strip():
            out.append(Finding(
                "R2", "error", where.split("::")[0], 1,
                f"unreasoned-exemption:{where.split('::')[1]}",
                f"CRASH_SEAM_ALLOWLIST entry {where!r} has no reason "
                "recorded"))
    return out


# --------------------------------------------------------------------------
# R3: durability discipline

def _os_replace_calls(fn) -> list[ast.Call]:
    hits = []
    for cs in fn.calls:
        if cs.name == "replace":
            f = cs.node.func
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "os"):
                hits.append(cs.node)
    return hits


def _check_r3(ctx: RuleContext) -> list[Finding]:
    out: list[Finding] = []
    impl_modules = {mod.path for mod in ctx.src.modules.values()
                    if DURABILITY_IMPL_DEF in mod.def_names}
    seeds = {fn for fn in ctx.src.all_functions()
             if fn.names & DURABILITY_MARKERS}
    covered = ctx.src.propagate_down(seeds)

    for mod in ctx.src.modules.values():
        if mod.path in impl_modules:
            continue  # the durability layer itself
        for fn in mod.functions.values():
            if fn in covered:
                continue
            writes = []
            for cs in fn.calls:
                if cs.name not in ("write_blob", "write_layer"):
                    continue
                # A resolved callee that is itself durable (the store
                # primitives fsync or defer to the batch scope) covers
                # the caller; os.replace never gets this credit.
                callees = ctx.src.by_name.get(cs.name, ())
                if callees and all(g.names & DURABILITY_MARKERS
                                   or g in covered for g in callees):
                    continue
                writes.append(cs.node)
            writes += _os_replace_calls(fn)
            if not writes:
                continue
            line = min(w.lineno for w in writes)
            out.append(Finding(
                "R3", "error", fn.path, line,
                f"undominated-write:{fn.qualname}",
                f"{fn.qualname} writes blob/layer/manifest state but no "
                "durability scope dominates it (no _durability_scope/"
                "_BatchScope/sync_for_commit/ensure_blob_durable/fsync "
                "on any path into it) — a crash can tear the write"))
    return out


# --------------------------------------------------------------------------
# R4: retention discipline

def _check_r4(ctx: RuleContext) -> list[Finding]:
    out: list[Finding] = []
    for mod in ctx.src.modules.values():
        for fn in mod.functions.values():
            triggers = [cs for cs in fn.calls
                        if cs.name in RETENTION_TRIGGERS]
            if not triggers:
                continue
            if fn.names & RETENTION_MARKERS:
                continue
            for cs in triggers:
                if has_kwarg(cs.node, "force"):
                    continue
                callees = ctx.src.by_name.get(cs.name, ())
                if any(g.names & RETENTION_MARKERS for g in callees):
                    continue
                out.append(Finding(
                    "R4", "warning", fn.path, cs.lineno,
                    f"unleased-retention:{fn.qualname}:{cs.name}",
                    f"{fn.qualname} calls {cs.name}() but neither it nor "
                    "the callee consults leased/lease_holders/"
                    "protect_paths, and no force= is passed — retention "
                    "can delete blobs out from under a live lease"))
    return out


# --------------------------------------------------------------------------
# R5: holdings-cache invalidation (store.py)

_HOLDINGS_APPLY = frozenset({"_holdings_apply_commit",
                             "_holdings_apply_remove"})


def _chain_has(node: ast.AST, name: str) -> bool:
    return name in attr_chain(node)


def _check_r5(ctx: RuleContext) -> list[Finding]:
    out: list[Finding] = []
    for mod in ctx.src.modules.values():
        if mod.path.rsplit("/", 1)[-1] != "store.py":
            continue
        for fn in mod.functions.values():
            tag_mutations: list[int] = []
            for cs in fn.calls:
                if cs.name in ("pop", "clear"):
                    if _chain_has(cs.node.func, "_tags_cache"):
                        tag_mutations.append(cs.lineno)
            for n in ast.walk(fn.node):
                if isinstance(n, ast.Delete):
                    for tgt in n.targets:
                        base = tgt.value if isinstance(
                            tgt, ast.Subscript) else tgt
                        if _chain_has(base, "_tags_cache"):
                            tag_mutations.append(n.lineno)
            holdings_updated = any(
                cs.name in _HOLDINGS_APPLY for cs in fn.calls)
            if tag_mutations and not holdings_updated:
                out.append(Finding(
                    "R5", "error", fn.path, min(tag_mutations),
                    f"stale-holdings:{fn.qualname}",
                    f"{fn.qualname} invalidates _tags_cache (committed-"
                    "tag state) without updating holdings_index via "
                    "_holdings_apply_commit/_holdings_apply_remove — "
                    "holdings would serve deleted or stale tags"))

            if fn.qualname.endswith("__init__"):
                continue
            out.extend(_check_holdings_lock(fn))
    return out


def _check_holdings_lock(fn) -> list[Finding]:
    """Writes to _holdings_cache/_holdings_aux must sit under the lock."""
    out: list[Finding] = []

    def is_holdings(node: ast.AST) -> bool:
        return (_chain_has(node, "_holdings_cache")
                or _chain_has(node, "_holdings_aux"))

    def walk(node: ast.AST, locked: bool) -> None:
        if isinstance(node, ast.With):
            if any(_chain_has(item.context_expr, "_holdings_lock")
                   for item in node.items):
                locked = True
        if not locked:
            bad_line = None
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets
                           if isinstance(node, ast.Assign)
                           else [node.target])
                for tgt in targets:
                    base = tgt.value if isinstance(
                        tgt, ast.Subscript) else tgt
                    if is_holdings(base):
                        bad_line = node.lineno
            elif isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Attribute)
                        and f.attr in ("pop", "clear", "update",
                                       "setdefault")
                        and is_holdings(f.value)):
                    bad_line = node.lineno
            if bad_line is not None:
                out.append(Finding(
                    "R5", "error", fn.path, bad_line,
                    f"unlocked-holdings:{fn.qualname}:{bad_line}",
                    f"{fn.qualname} mutates the holdings cache outside "
                    "'with self._holdings_lock' — racing readers can "
                    "see a torn index"))
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested defs are separate FunctionInfos
            walk(child, locked)

    walk(fn.node, False)
    return out


# --------------------------------------------------------------------------

RULES: dict[str, Rule] = {r.id: r for r in (
    Rule(
        id="R1",
        title="fault-point coverage",
        severity="error",
        contract=(
            "Every fault_point(\"name\", ...) call site in src must "
            "appear (as a string literal) in the ft/chaos.py scenario "
            "matrix AND in at least one test, and every point a "
            "FaultSpec names in chaos/tests must exist in src "
            "(wildcards match by prefix).  Fault-point names must be "
            "string literals."),
        motivation=(
            "The kill matrix asserts fired >= 1 per cell precisely "
            "because a cell whose injection never fires proves nothing; "
            "an uncovered or typo'd point is a silent no-op cell — the "
            "crash seam it was meant to exercise ships untested."),
        check=_check_r1,
    ),
    Rule(
        id="R2",
        title="crash-seam soundness",
        severity="error",
        contract=(
            "A broad except (bare / Exception / BaseException) whose "
            "try body can reach a fault_point call — transitively "
            "through the call graph, with dynamic dispatch treated as "
            "reaching — must re-raise, be preceded by an 'except "
            "CrashInjected: raise' handler, or carry a reasoned "
            "CRASH_SEAM_ALLOWLIST entry.  Scope: src/repro_torch/{core,ft,"
            "serve,ckpt}.  Every '# noqa: BLE001' in {core,ft,serve} "
            "must map to an allowlist entry, and every entry must match "
            "a live broad handler."),
        motivation=(
            "CrashInjected is the kill matrix's simulated SIGKILL: a "
            "handler that swallows it makes the 'process died here' "
            "cell silently pass (the retry-loop bug).  The two "
            "historical noqa seams (registry _retry_failed, "
            "RetryPolicy.execute) are now structured allowlist entries "
            "with recorded reasons."),
        check=_check_r2,
    ),
    Rule(
        id="R3",
        title="durability discipline",
        severity="error",
        contract=(
            "Any function that writes blob/layer/manifest state "
            "(write_blob / write_layer / os.replace) outside the "
            "durability layer itself must be dominated by a durability "
            "scope: it (or a transitive caller) must mention "
            "_durability_scope / _BatchScope / sync_for_commit / "
            "ensure_blob_durable / fsync."),
        motivation=(
            "The passive registry's _write originally renamed the "
            "bundle index into place with os.replace but never fsynced "
            "— a crash after rename could publish a torn index (fixed "
            "in this PR).  The store's flush-before-leaving-scope "
            "invariant only protects writes that sit inside a scope."),
        check=_check_r3,
    ),
    Rule(
        id="R4",
        title="retention discipline",
        severity="warning",
        contract=(
            "Any function invoking remove_image / prune_steps / gc "
            "must consult leased / lease_holders / protect_paths on "
            "some path — in its own body or in the callee — or "
            "explicitly pass force=."),
        motivation=(
            "The cross-image gc originally swept blobs that a "
            "concurrent reader held a lease on; retention paths now "
            "must prove they looked at the lease table (or say force=) "
            "before deleting."),
        check=_check_r4,
    ),
    Rule(
        id="R5",
        title="holdings-cache invalidation",
        severity="error",
        contract=(
            "In store.py, any method that invalidates committed-tag "
            "state (_tags_cache pop/clear/del) must also update "
            "holdings_index via _holdings_apply_commit / "
            "_holdings_apply_remove, and every write to the holdings "
            "cache must sit inside 'with self._holdings_lock'."),
        motivation=(
            "The namespace-wide holdings index is an incremental "
            "cache over committed tags; the scrub work hit a path "
            "where tags changed but holdings stayed stale, serving "
            "blobs for a deleted tag.  Lock discipline keeps the "
            "incremental update race-free."),
        check=_check_r5,
    ),
)}
