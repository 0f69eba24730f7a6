"""Passes 5+6 — whole-program concurrency (`thread-roots`, `race`); the
port's copy of kcmc_tpu/analysis/concurrency.py.

A per-class `shared-write` warning sees one class in one file; the bugs that
matter in a resident serve fleet cross modules — the scheduler thread
writing `Session` state a client thread reads, the heartbeat thread
sampling `RunTelemetry` counters the drain path increments. These two
passes do the cross-module version properly:

* **thread-roots** — the inventory: every concurrent entry point in
  the package (`threading.Thread(target=…)`, executor `.submit(…)`
  tasks, `atexit` hooks, `socketserver` connection handlers, plus the
  public "client" surface of every thread-owning class), each with its
  cross-module call-graph closure. As a rule it enforces two
  attributability contracts: threads carry a `name=` (the sanitizer's
  stack dumps and leak reports are useless without one) and thread
  targets are statically resolvable (no lambda targets).

* **race** — per root, walk the reachable functions propagating the
  *held-lock set* across call edges (a callee invoked under `with
  self._lock:` inherits that lock — the serving plane's "caller holds
  the lock" convention becomes visible), recording every shared
  attribute / module-global read and write with its guarding lock set.
  Two accesses to the same attribute from different roots (or from a
  replicated root against itself), at least one a write, with DISJOINT
  lock sets, is a data-race finding. Lock identity is program-wide
  (`callgraph.ProgramGraph.lock_id`): `Condition(self._lock)` aliases
  collapse and constructor-parameter locks resolve through their call
  sites, so `Session._cond` and `StreamScheduler._lock` are the SAME
  lock to the disjointness test. Ambiguity degrades to a wildcard lock
  that intersects everything — unresolvable aliasing silences, never
  flags.

Known model limits: analysis is
type-based, not instance-based (two distinct `Session` objects share
one static identity), construction-time publication (build an object,
then publish it under a lock) is invisible, and `__init__` bodies are
exempt from self-attribute recording for exactly that reason. The
baseline carries the justified remainder.
"""

from __future__ import annotations

import ast
import dataclasses

from kcmc_tpu_torch.analysis.callgraph import (
    EXECUTOR_CTORS,
    THREAD_CTOR,
    WILDCARD_LOCK,
    FuncRef,
    ProgramGraph,
)
from kcmc_tpu_torch.analysis.core import Finding, ModuleIndex
from kcmc_tpu_torch.analysis.lock_discipline import _self_attr, attr_chain

# Synchronization-object constructors: attributes holding these are
# primitives, not shared data — their cross-thread use is the point.
SYNC_CTORS = frozenset(
    {
        "threading.Event",
        "threading.Semaphore",
        "threading.BoundedSemaphore",
        "threading.Barrier",
        "threading.local",
        "queue.Queue",
        "queue.SimpleQueue",
        "queue.LifoQueue",
        "queue.PriorityQueue",
    }
)

# Container-mutating method names: `self.pending.extend(…)` is a WRITE
# to `pending` even though the attribute itself is only loaded.
MUTATORS = frozenset(
    {
        "append", "appendleft", "extend", "extendleft", "add", "discard",
        "remove", "pop", "popleft", "popitem", "clear", "update", "insert",
        "setdefault", "sort", "reverse",
    }
)


@dataclasses.dataclass(frozen=True)
class Root:
    """One concurrent entry point (see module docstring)."""

    kind: str  # thread | task | atexit | handler | client
    ref: FuncRef
    site_path: str
    line: int
    name: str | None = None
    daemon: bool = False
    # Whether several instances of this root can run at once (executor
    # tasks, connection handlers). The "client" surface is modeled as
    # ONE external thread: callers that race each other reach the
    # package through the handler root, which IS replicated.
    replicated: bool = False

    @property
    def group(self) -> str:
        """Concurrency identity: accesses from the SAME group never
        race (unless the group is replicated). Every client root is
        one group — the model's single external caller thread."""
        if self.kind == "client":
            return "client"
        return f"{self.kind}:{self.site_path}:{self.line}"

    def label(self) -> str:
        tag = self.name or self.ref.name
        return f"{self.kind}:{tag}"


@dataclasses.dataclass(frozen=True)
class Access:
    root: Root
    kind: str  # "r" | "w"
    path: str
    line: int
    locks: frozenset


def _thread_kwargs(call: ast.Call) -> dict:
    out = {"target": None, "name": None, "named": False, "daemon": False}
    for kw in call.keywords:
        if kw.arg == "target":
            out["target"] = kw.value
        elif kw.arg == "name":
            # any name= satisfies the attributability contract; only a
            # string CONSTANT also labels the root in reports
            out["named"] = True
            if isinstance(kw.value, ast.Constant):
                out["name"] = kw.value.value
        elif kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
            out["daemon"] = bool(kw.value.value)
    return out


def _scopes(graph: ProgramGraph):
    """Every (path, cls, fn_name, fn_node) in the program."""
    for mod in graph.index:
        table = graph.tables[mod.path]
        for cname in table.classes:
            info = graph.class_info(cname, mod.path)
            for mname, fn in (info.methods if info else {}).items():
                yield mod.path, cname, mname, fn
        for (path, fname), fn in graph.module_funcs.items():
            if path == mod.path:
                yield mod.path, None, fname, fn


def collect_roots(
    graph: ProgramGraph,
) -> tuple[list[Root], list[Finding]]:
    """The concurrent-entry-point inventory plus its rule findings.
    Memoized on the graph — the thread-roots and race passes share one
    full-program sweep."""
    cached = getattr(graph, "_roots_cache", None)
    if cached is not None:
        return cached
    roots: list[Root] = []
    problems: list[Finding] = []
    thread_owning: set[str] = set()  # class names constructing threads/pools
    root_modules: set[str] = set()

    def resolve_target(path, cls, fn, expr) -> FuncRef | None:
        if expr is None:
            return None
        if isinstance(expr, ast.Lambda):
            return None
        chain = attr_chain(expr)
        sattr = _self_attr(expr)
        if sattr is not None and cls is not None:
            info = graph.class_info(cls, path)
            if info is not None and sattr in info.methods:
                return FuncRef(info.path, cls, sattr)
        if isinstance(expr, ast.Name) and cls is not None:
            info = graph.class_info(cls, path)
            if info is not None and expr.id in info.methods:
                return FuncRef(info.path, cls, expr.id)
        return graph.resolve_in_module(path, chain, cls=cls)

    for path, cls, fname, fn in _scopes(graph):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            last = chain.rsplit(".", 1)[-1]
            if chain == THREAD_CTOR:
                if cls is not None:
                    thread_owning.add(cls)
                root_modules.add(path)
                kw = _thread_kwargs(node)
                target = resolve_target(path, cls, fn, kw["target"])
                if isinstance(kw["target"], ast.Lambda):
                    problems.append(
                        Finding(
                            rule="thread-roots",
                            path=path,
                            line=node.lineno,
                            severity="warning",
                            message=(
                                "thread constructed with a lambda target "
                                "is invisible to concurrency analysis"
                            ),
                            detail=(
                                "give the body a named function so the "
                                "race pass can walk it"
                            ),
                        )
                    )
                if not kw["named"]:
                    problems.append(
                        Finding(
                            rule="thread-roots",
                            path=path,
                            line=node.lineno,
                            severity="warning",
                            message=(
                                "thread constructed without a name= "
                                f"in {cls + '.' if cls else ''}{fname}"
                            ),
                            detail=(
                                "the sanitizer's deadlock stack dumps and "
                                "leak reports attribute threads by name"
                            ),
                        )
                    )
                if target is not None:
                    roots.append(
                        Root(
                            kind="thread",
                            ref=target,
                            site_path=path,
                            line=node.lineno,
                            name=kw["name"],
                            daemon=kw["daemon"],
                        )
                    )
            elif chain in EXECUTOR_CTORS or last in EXECUTOR_CTORS:
                if cls is not None:
                    thread_owning.add(cls)
                root_modules.add(path)
            elif last == "submit" and node.args:
                target = resolve_target(path, cls, fn, node.args[0])
                if target is not None:
                    roots.append(
                        Root(
                            kind="task",
                            ref=target,
                            site_path=path,
                            line=node.lineno,
                            replicated=True,
                        )
                    )
            elif chain == "atexit.register" and node.args:
                target = resolve_target(path, cls, fn, node.args[0])
                if target is not None:
                    roots.append(
                        Root(
                            kind="atexit",
                            ref=target,
                            site_path=path,
                            line=node.lineno,
                        )
                    )
    # module-level atexit hooks (the feeder shared-pool teardown)
    for mod in graph.index:
        for node in mod.tree.body:
            call = (
                node.value
                if isinstance(node, ast.Expr)
                and isinstance(node.value, ast.Call)
                else None
            )
            if call is not None and attr_chain(call.func) == "atexit.register":
                target = (
                    graph.resolve_in_module(
                        mod.path, attr_chain(call.args[0])
                    )
                    if call.args
                    else None
                )
                if target is not None:
                    roots.append(
                        Root(
                            kind="atexit",
                            ref=target,
                            site_path=mod.path,
                            line=node.lineno,
                        )
                    )
                root_modules.add(mod.path)
    # socketserver connection handlers: every connection runs handle()
    # on its own thread
    for infos in graph.classes.values():
        for info in infos:
            if any("RequestHandler" in b for b in info.base_names) and (
                "handle" in info.methods
            ):
                roots.append(
                    Root(
                        kind="handler",
                        ref=FuncRef(info.path, info.node.name, "handle"),
                        site_path=info.path,
                        line=info.node.lineno,
                        replicated=True,
                    )
                )
                root_modules.add(info.path)
    # the client surface: public methods of thread-owning classes and
    # public functions of root-hosting modules, modeled as one
    # external caller thread
    for cname in sorted(thread_owning):
        info = graph.class_info(cname)
        if info is None:
            continue
        for mname, fn in sorted(info.methods.items()):
            if mname.startswith("_") and mname not in (
                "__enter__", "__exit__",
            ):
                continue
            roots.append(
                Root(
                    kind="client",
                    ref=FuncRef(info.path, cname, mname),
                    site_path=info.path,
                    line=fn.lineno,
                )
            )
    for path in sorted(root_modules):
        for (p, fname), fn in sorted(graph.module_funcs.items()):
            if p == path and not fname.startswith("_"):
                roots.append(
                    Root(
                        kind="client",
                        ref=FuncRef(p, None, fname),
                        site_path=p,
                        line=fn.lineno,
                    )
                )
    graph._roots_cache = (roots, problems)
    return roots, problems


class ThreadRootsPass:
    """The inventory rule: see module docstring."""

    name = "thread-roots"

    def run(self, index: ModuleIndex) -> list[Finding]:
        graph = ProgramGraph.for_index(index)
        _roots, problems = collect_roots(graph)
        # nested defs are walked from both their own scope and their
        # enclosing function — dedup identical findings
        out, seen = [], set()
        for f in problems:
            k = (f.rule, f.path, f.line, f.message)
            if k not in seen:
                seen.add(k)
                out.append(f)
        return out


# -- the race detector -----------------------------------------------------


class _FnWalker(ast.NodeVisitor):
    """One function body: lexical lock tracking, access recording, and
    call-edge collection (with the held set at each call site)."""

    def __init__(
        self, graph, ref: FuncRef, held: frozenset, out,
        in_ctor: bool = False,
    ):
        self.graph = graph
        self.ref = ref
        self.path = ref.path
        self.cls = ref.cls
        self.info = (
            graph.class_info(ref.cls, ref.path) if ref.cls else None
        )
        self.held: frozenset = held
        self.out = out  # _RaceCollector
        self.locals: dict[str, str] = {}  # var -> class name
        self.declared_globals: set[str] = set()
        # Construction context: `__init__` bodies AND everything
        # reached through a constructor call are building a not-yet-
        # published object — self-attribute traffic there is exempt
        # (module globals still record: registries like the telemetry
        # path claims are shared even at construction time).
        self.in_ctor = in_ctor or ref.name == "__init__"
        self.record_self = not self.in_ctor
        self.mutables = graph.module_mutables.get(ref.path, set())
        self.mod_locks = graph.module_locks.get(ref.path, {})

    # -- lock identity of a with-item --------------------------------------

    def _lock_of(self, expr) -> str | None:
        attr = _self_attr(expr)
        if attr is not None and self.info is not None:
            if self.graph.is_lock_attr(self.info, attr):
                return self.graph.lock_id(self.info, attr)
            return None
        if isinstance(expr, ast.Name) and expr.id in self.mod_locks:
            return f"{self.path}:{expr.id}"
        return None

    def _is_sync_attr(self, attr: str) -> bool:
        info = self.info
        if info is None:
            return False
        if self.graph.is_lock_attr(info, attr):
            return True
        return attr in getattr(info, "sync_attrs", ())

    # -- recording ---------------------------------------------------------

    def _rec_attr(self, attr: str, kind: str, line: int) -> None:
        if not self.record_self or self.info is None:
            return
        if self._is_sync_attr(attr) or attr in self.info.methods:
            return
        self.out.record(
            ("attr", self.info.node.name, attr),
            kind,
            self.path,
            line,
            self.held,
        )

    def _rec_global(self, name: str, kind: str, line: int) -> None:
        self.out.record(
            ("global", self.path, name), kind, self.path, line, self.held
        )

    # -- visitors ----------------------------------------------------------

    def visit_Global(self, node: ast.Global) -> None:
        self.declared_globals.update(node.names)

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            lid = self._lock_of(item.context_expr)
            if lid is not None:
                acquired.append(lid)
            else:
                self.visit(item.context_expr)
        prev = self.held
        if acquired:
            self.held = self.held | frozenset(acquired)
        for stmt in node.body:
            self.visit(stmt)
        self.held = prev

    visit_AsyncWith = visit_With

    def visit_Assign(self, node: ast.Assign) -> None:
        v = node.value
        if isinstance(v, ast.Call):
            ref = self.graph.resolve_in_module(
                self.path, attr_chain(v.func), cls=self.cls
            )
            if ref is not None and ref.cls and ref.name == "__init__":
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.locals[t.id] = ref.cls
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None:
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                self._rec_attr(attr, "w", node.lineno)
            else:
                self._rec_attr(attr, "r", node.lineno)
            return
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            attr = _self_attr(node.value)
            if attr is not None:
                self._rec_attr(attr, "w", node.lineno)
                self.visit(node.slice)
                return
            if (
                isinstance(node.value, ast.Name)
                and node.value.id in self.mutables
            ):
                self._rec_global(node.value.id, "w", node.lineno)
                self.visit(node.slice)
                return
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if node.id in self.mutables:
            if isinstance(node.ctx, ast.Load):
                self._rec_global(node.id, "r", node.lineno)
            elif node.id in self.declared_globals or isinstance(
                node.ctx, ast.Del
            ):
                self._rec_global(node.id, "w", node.lineno)

    def visit_Call(self, node: ast.Call) -> None:
        chain = attr_chain(node.func)
        parts = chain.split(".")
        # container-mutating calls: self.attr.append(…) / GLOBAL.pop(…)
        if len(parts) == 3 and parts[0] == "self":
            kind = "w" if parts[2] in MUTATORS else "r"
            self._rec_attr(parts[1], kind, node.lineno)
        elif len(parts) == 2 and parts[0] == "self":
            pass  # self.m(...) — the call edge below covers it
        elif len(parts) == 2 and parts[0] in self.mutables:
            kind = "w" if parts[1] in MUTATORS else "r"
            self._rec_global(parts[0], kind, node.lineno)
        ref = self._resolve_call(chain)
        if ref is not None:
            self.out.edge(
                ref,
                self.held,
                self.in_ctor or ref.name == "__init__",
            )
        for a in node.args:
            self.visit(a)
        for kw in node.keywords:
            self.visit(kw.value)

    def _resolve_call(self, chain: str) -> FuncRef | None:
        head, _, rest = chain.partition(".")
        if head in self.locals and rest:
            info = self.graph.class_info(self.locals[head])
            m = rest.split(".")[-1]
            if info is not None and m in info.methods:
                return FuncRef(info.path, info.node.name, m)
        if not rest and self.cls is not None and self.info is not None:
            # bare name that is a sibling method (nested producer fns)
            if head in self.info.methods and (
                (self.path, head) not in self.graph.module_funcs
            ):
                return FuncRef(self.info.path, self.cls, head)
        return self.graph.resolve_in_module(
            self.path, chain, cls=self.cls
        )


class _RaceCollector:
    def __init__(self, root: Root):
        self.root = root
        self.accesses: list[tuple[tuple, Access]] = []
        self.edges: list[tuple[FuncRef, frozenset, bool]] = []

    def record(self, key, kind, path, line, held) -> None:
        self.accesses.append(
            (key, Access(self.root, kind, path, line, held))
        )

    def edge(self, ref, held, in_ctor: bool) -> None:
        self.edges.append((ref, held, in_ctor))


def _walk_root(graph: ProgramGraph, root: Root, budget: int = 4000):
    """The root's reachable closure with held-lock propagation:
    accesses list per shared-state key."""
    col = _RaceCollector(root)
    seen: set[tuple] = set()
    stack: list[tuple[FuncRef, frozenset, bool]] = [
        (root.ref, frozenset(), False)
    ]
    visits = 0
    while stack and visits < budget:
        ref, held, in_ctor = stack.pop()
        key = (ref.path, ref.cls, ref.name, held, in_ctor)
        if key in seen:
            continue
        seen.add(key)
        fn = graph.function(ref)
        if fn is None:
            continue
        visits += 1
        walker = _FnWalker(graph, ref, held, col, in_ctor=in_ctor)
        for stmt in fn.body:
            walker.visit(stmt)
        while col.edges:
            stack.append(col.edges.pop())
    return col.accesses


def _disjoint(a: frozenset, b: frozenset) -> bool:
    if WILDCARD_LOCK in a or WILDCARD_LOCK in b:
        return False
    return not (a & b)


def _annotate_sync_attrs(graph: ProgramGraph) -> None:
    """Mark attributes holding Event/Queue/… constructions so they are
    exempt from data-race recording (they ARE the synchronization)."""
    for infos in graph.classes.values():
        for info in infos:
            sync: set[str] = set()
            for fn in info.methods.values():
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Assign) or not isinstance(
                        node.value, ast.Call
                    ):
                        continue
                    chain = attr_chain(node.value.func)
                    if chain in SYNC_CTORS or chain.rsplit(".", 1)[
                        -1
                    ] in ("Event", "local", "SimpleQueue"):
                        for t in node.targets:
                            attr = _self_attr(t)
                            if attr is not None:
                                sync.add(attr)
            info.sync_attrs = sync


class RacePass:
    """Cross-root disjoint-lock-set access pairs (module docstring)."""

    name = "race"

    def run(self, index: ModuleIndex) -> list[Finding]:
        graph = ProgramGraph.for_index(index)
        _annotate_sync_attrs(graph)
        # Classes that DECLARED synchronization (a lock, condition, or
        # sync primitive): these opted into the concurrency contract,
        # so a replicated root racing itself on their state reports;
        # sync-free classes only report across distinct roots (their
        # replicated-instance state is usually per-instance).
        sync_owners = {
            info.node.name
            for infos in graph.classes.values()
            for info in infos
            if info.locks or info.alias or info.param_locks
            or getattr(info, "sync_attrs", None)
        }
        roots, _problems = collect_roots(graph)
        seen_roots: set[tuple] = set()
        by_key: dict[tuple, list[Access]] = {}
        for root in roots:
            rk = (root.kind, root.ref, root.site_path, root.line)
            if rk in seen_roots:
                continue
            seen_roots.add(rk)
            for key, acc in _walk_root(graph, root):
                by_key.setdefault(key, []).append(acc)
        out: list[Finding] = []
        emitted: set[tuple] = set()
        for key in sorted(by_key, key=str):
            accs = by_key[key]
            self_race_ok = key[0] == "attr" and key[1] in sync_owners
            pair = self._conflict(accs, self_race_ok)
            if pair is None:
                continue
            if key in emitted:
                continue
            emitted.add(key)
            a, b = pair
            if key[0] == "attr":
                what = f"'{key[1]}.{key[2]}'"
            else:
                what = f"module global '{key[2]}'"
            out.append(
                Finding(
                    rule="race",
                    path=a.path,
                    line=a.line,
                    severity="error",
                    message=(
                        f"possible data race on {what}: concurrent "
                        "roots access it with disjoint lock sets"
                    ),
                    detail=(
                        f"{a.kind}@{a.path}:{a.line} from "
                        f"{a.root.label()} holds "
                        f"{sorted(a.locks) or 'no locks'} vs "
                        f"{b.kind}@{b.path}:{b.line} from "
                        f"{b.root.label()} holds "
                        f"{sorted(b.locks) or 'no locks'}"
                    ),
                )
            )
        return out

    @staticmethod
    def _conflict(accs: list[Access], self_race_ok: bool):
        """First (write, other) pair from concurrent roots with
        disjoint lock sets. Same-group pairs count only when the group
        is replicated AND the state's class declared synchronization
        (`self_race_ok`) — replicated instances of a sync-free class
        are modeled as per-instance state."""
        writes = [a for a in accs if a.kind == "w"]
        if not writes:
            return None
        for w in writes:
            for o in accs:
                if o is w:
                    continue
                if o.root.group == w.root.group and not (
                    w.root.replicated and self_race_ok
                ):
                    continue
                if _disjoint(w.locks, o.locks):
                    return (w, o) if w.line <= o.line else (o, w)
        return None
