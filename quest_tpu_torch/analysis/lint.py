"""quest-lint for the PyTorch/CUDA port: an AST static analyzer of its
program caches, knob parsing, lock discipline, persistence writes and
fault sites.

A port of quest_tpu/analysis/lint.py (the file model, collector, call
graph and suppression grammar are the reference's) keyed on the port's
own modules, registry (quest_tpu_torch.env.KNOBS) and fault catalog
(quest_tpu_torch.resilience.faults.SITES). The rule IDs are the
reference's, so an escape `# quest-lint: disable=QL005(reason)` means
the same in both trees.

Rules (each suppressible per line with `# quest-lint: disable=RULE` or
per file with `# quest-lint: disable-file=RULE`; a reason in
parentheses makes the escape audited: one that suppresses nothing is
itself flagged):

  QL001  cache-key completeness — a QUEST_* read reachable from a
         program builder must be a knob of scope 'keyed' (carried by
         engine_mode_key() into every program cache key) or
         'import_once'. The roots are the builders: the callable handed
         to `<circuit>._cached(key, build)`, trajectories.program_key,
         and ops/segment.prepare_segment (the kernel's specialisation
         of a segment); edges follow plain calls, module-attribute
         calls through import aliases and local closures.
  QL004  knobs parse loudly — every QUEST_* read in package code goes
         through env.knob_value()'s validating parser, every QUEST_*
         name read anywhere is registered in env.KNOBS, and nothing
         outside env.py reads the interpreter's encoded environment
         (os.environ._data). engine_mode_key's encoded read is the one
         sanctioned raw read: it lives in env.py and parses each value
         with the knob's own parser (_SANCTIONED_RAW_ENV).
  QL005  lock discipline — a class that owns a threading lock declares
         a `_GUARDED_BY` table (lock attr -> guarded attrs); guarded
         attributes are only touched inside `with self.<lock>` or from
         private methods the intra-class call graph proves are only
         reached under it.
  QL007  blocking under a lock — no device syncs (.item(), .cpu(),
         .numpy(), .tolist(), torch.cuda.synchronize(), an Event's or
         Stream's synchronize()), time.sleep, subprocess, file I/O or
         socket I/O while holding a declared lock (lexically or via a
         lock-held private method).
  QL008  atomic writes — a write-mode open() in the persistence modules
         (checkpoint, plan cache, durable executor) rides the
         temp+rename commit idiom.
  QL009  fault-site integrity — every literal fired through
         faults.check()/._fault() names a catalog site, and every
         faults.SITES entry has >= 1 firing call site in the package
         and >= 1 test arming it.

Not ported, and refused by name (JAX_RULES): QL002 (Pallas i32 index
math: the port's kernels are CUDA C++, and chip_smoke.py's build phase
fails on a register spill), QL003 (tracer leaks: nothing is traced) and
QL006 (use-after-donate: the port has no donate=).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

RULES = {
    "QL001": "cache-key completeness: QUEST_* reads reachable from a "
             "program builder must be keyed/import_once in env.KNOBS",
    "QL004": "knobs parse loudly: QUEST_* reads route through the "
             "registry's validating parser",
    "QL005": "lock discipline: _GUARDED_BY attributes are only touched "
             "under their declared lock (or from lock-held methods)",
    "QL007": "blocking under a lock: no device syncs, sleeps, subprocess, "
             "file or socket I/O while holding a declared lock",
    "QL008": "atomic-write discipline: persistence-module writes ride "
             "the temp+rename commit idiom",
    "QL009": "fault-site integrity: fired sites are cataloged, every "
             "catalog site is fired and armed by a test",
}

# the reference's rules that only make sense over JAX code
JAX_RULES = {
    "QL002": "JAX-specific, not ported: Pallas i32 index math (the port's "
             "kernels are CUDA C++; chip_smoke.py's build phase fails on a "
             "register spill)",
    "QL003": "JAX-specific, not ported: tracer leaks (the port traces "
             "nothing)",
    "QL006": "JAX-specific, not ported: use-after-donate (the port has no "
             "donate=; ROADMAP 'Not ported on purpose')",
}

PACKAGE = "quest_tpu_torch"

_DISABLE_MARK = "quest-lint:"

# QL001: program builders that are roots by name, besides the callables
# handed to `_cached(key, build)`
_BUILDER_ROOTS = {
    ("quest_tpu_torch.ops.segment", "prepare_segment"),
    ("quest_tpu_torch.trajectories", "program_key"),
}

# QL004: the one module that may read the interpreter's encoded
# environment (os.environ._data): env.engine_mode_key reads every keyed
# knob there on each serve submit and parses each raw value with the
# knob's own parser
_SANCTIONED_RAW_ENV = "quest_tpu_torch.env"

# suppression grammar: RULE or RULE(reason). Reason-carrying
# suppressions are AUDITED — one that suppresses nothing is itself
# flagged (QL005's reviewed-escape contract); bare ones keep the
# original fire-and-forget semantics.
_SUPP_RE = re.compile(r"(QL\d{3})\s*(?:\(([^)]*)\))?")

# QL005: lock constructors recognized in __init__, and the reserved
# _GUARDED_BY key for single-owner-thread (lock-free by contract)
# attributes. A "|"-joined key ("_lock|_cond") means entering a `with`
# on ANY of the named attributes counts as holding the scope
# (Condition(self._lock) wraps the same lock).
_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}
_OWNER_KEY = "<owner-thread>"

# QL008: the modules whose on-disk artifacts power crash recovery —
# every write-mode open here must ride the temp+rename commit idiom
_PERSISTENCE_MODULES = {
    "quest_tpu_torch.checkpoint", "quest_tpu_torch.plan",
    "quest_tpu_torch.resilience.durable",
}

# QL007: device syncs in torch terms (a method of a tensor, event or
# stream) and socket I/O
_SYNC_METHODS = {"item", "cpu", "numpy", "tolist", "synchronize"}
_SOCKET_METHODS = {"send", "sendall", "sendmsg", "recv", "recv_into",
                   "recvmsg", "recvmsg_into", "accept", "connect"}

# QL009: fault-site-shaped string literals ("serve.dispatch")
_SITE_RE = re.compile(r"^[a-z][a-z0-9_]*\.[a-z][a-z0-9_]*$")


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def render(self, root: Optional[str] = None) -> str:
        path = os.path.relpath(self.path, root) if root else self.path
        return f"{path}:{self.line}:{self.col}: {self.rule} {self.message}"


# ---------------------------------------------------------------------------
# per-file model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _EnvRead:
    name: str               # the QUEST_* (or other) variable name
    line: int
    col: int
    func: Optional[str]     # enclosing function qualname (None: module scope)
    via_registry: bool      # knob_value()/knob_current() vs raw os.environ


@dataclasses.dataclass
class _AttrAccess:
    """One `self.<attr>` touch inside a class body (QL005)."""
    attr: str
    line: int
    col: int
    method: Optional[str]   # enclosing function qualname
    write: bool
    locks: FrozenSet[str]   # self-lock names lexically held at the site


@dataclasses.dataclass
class _ClassInfo:
    """Per-class index for the lock-discipline rules (QL005/QL007)."""
    name: str
    line: int
    guarded_by: Optional[Dict[str, Tuple[str, ...]]] = None
    guarded_line: int = 0
    guard_parse_error: Optional[str] = None
    lock_attrs: Dict[str, int] = dataclasses.field(default_factory=dict)
    methods: Set[str] = dataclasses.field(default_factory=set)
    accesses: List[_AttrAccess] = dataclasses.field(default_factory=list)
    # (caller root method, callee bare name, locks held at site, line)
    self_calls: List[Tuple[str, str, FrozenSet[str], int]] = \
        dataclasses.field(default_factory=list)




@dataclasses.dataclass
class _FuncInfo:
    qualname: str
    line: int
    calls: List[Tuple[Optional[str], str]] = dataclasses.field(
        default_factory=list)          # (module or None=local, name)
    root: bool = False                 # a program builder (QL001)
    parent: Optional[str] = None       # enclosing function qualname
    node: Optional[ast.AST] = None     # the def (or lambda) node
    has_rename: bool = False           # os.rename/os.replace (QL008)
    # local callable aliases: `build = functools.partial(f, ...)` binds a
    # name later handed to _cached
    local_callables: Dict[str, str] = dataclasses.field(
        default_factory=dict)


class _FileModel:
    def __init__(self, path: str, module: Optional[str], tree: ast.Module,
                 source: str):
        self.path = path
        self.module = module            # dotted name for package files
        self.tree = tree
        self.source = source
        self.import_alias: Dict[str, str] = {}   # local alias -> module
        self.from_imports: Dict[str, Tuple[str, str]] = {}  # name->(mod,orig)
        self.funcs: Dict[str, _FuncInfo] = {}
        self.env_reads: List[_EnvRead] = []
        # reads of the encoded environment (os.environ._data): (line, col)
        self.raw_env_sites: List[Tuple[int, int]] = []
        # cross-module builder operands of _cached(key, build): resolved
        # into extra roots during propagation
        self.foreign_roots: List[Tuple[str, str]] = []
        # line -> {rule: reason-or-None}; file-level: rule -> (reason, line)
        self.suppressed_lines: Dict[int, Dict[str, Optional[str]]] = {}
        self.suppressed_file: Dict[str, Tuple[Optional[str], int]] = {}
        # QL005/QL007 class index; QL007 candidate blocking calls:
        # (node, func, locks held, class name, human label)
        self.classes: Dict[str, _ClassInfo] = {}
        self.blocking_sites: List[Tuple[ast.Call, Optional[str],
                                        FrozenSet[str], str, str]] = []
        # QL008: write-mode opens (node, func qualname)
        self.write_opens: List[Tuple[ast.Call, Optional[str]]] = []
        # QL009: fired/armed fault-site literals + the scanned catalog
        self.fault_fires: List[Tuple[str, int, int]] = []
        self.fault_arms: Set[str] = set()
        self.site_strings: Set[str] = set()
        self.sites_catalog: Optional[Tuple[Tuple[str, ...], int]] = None
        self._scan_suppressions()

    def _scan_suppressions(self) -> None:
        try:
            tokens = tokenize.generate_tokens(
                io.StringIO(self.source).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                text = tok.string.lstrip("#").strip()
                if not text.startswith(_DISABLE_MARK):
                    continue
                body = text[len(_DISABLE_MARK):].strip()
                if body.startswith("disable-file="):
                    spec = body[len("disable-file="):]
                    for rule, reason in _SUPP_RE.findall(spec):
                        self.suppressed_file[rule] = (
                            reason or None, tok.start[0])
                elif body.startswith("disable="):
                    spec = body[len("disable="):]
                    # trailing comment guards its own line; a comment-
                    # only line guards the line below it
                    line = tok.start[0]
                    if not tok.line[:tok.start[1]].strip():
                        line += 1
                    entry = self.suppressed_lines.setdefault(line, {})
                    for rule, reason in _SUPP_RE.findall(spec):
                        entry[rule] = reason or None
        except tokenize.TokenError:        # pragma: no cover - parse guard
            pass

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self.suppressed_file:
            return True
        return rule in self.suppressed_lines.get(line, {})


def _module_name_for(path: str, root: str) -> Optional[str]:
    """Dotted module name for files under the quest_tpu_torch package,
    None for scripts and tests (they are linted but are not part of the
    package call graph)."""
    rel = os.path.relpath(path, root)
    parts = rel.split(os.sep)
    if PACKAGE in parts:
        parts = parts[parts.index(PACKAGE):]
        if parts[-1].endswith(".py"):
            parts[-1] = parts[-1][:-3]
        if parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)
    return None


# ---------------------------------------------------------------------------
# AST visitors
# ---------------------------------------------------------------------------


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for nested Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _unwrap_partial(node: ast.AST) -> ast.AST:
    """functools.partial(f, ...) -> f (builders assembled through
    partial)."""
    if isinstance(node, ast.Call):
        dotted = _dotted(node.func) or ""
        if dotted.split(".")[-1] == "partial" and node.args:
            return _unwrap_partial(node.args[0])
    return node


def _parse_guarded_by(node: ast.AST):
    """Parse a `_GUARDED_BY` class annotation: a dict literal mapping a
    lock attribute name (``"_lock"``, the alias form ``"_lock|_cond"``
    for a Condition wrapping the same Lock, or the reserved
    ``"<owner-thread>"`` for single-owner lock-free state) to a
    tuple/list/set of guarded attribute names.  Returns
    ``(mapping, error)`` — exactly one is None."""
    if not isinstance(node, ast.Dict):
        return None, "_GUARDED_BY must be a dict literal"
    out: Dict[str, Tuple[str, ...]] = {}
    for k, v in zip(node.keys, node.values):
        key = _const_str(k) if k is not None else None
        if key is None:
            return None, "_GUARDED_BY keys must be string literals"
        if not isinstance(v, (ast.Tuple, ast.List, ast.Set)):
            return None, (f"_GUARDED_BY[{key!r}] must be a tuple/list/set "
                          "of attribute-name literals")
        attrs: List[str] = []
        for e in v.elts:
            s = _const_str(e)
            if s is None:
                return None, (f"_GUARDED_BY[{key!r}] must contain only "
                              "string literals")
            attrs.append(s)
        out[key] = tuple(attrs)
    return out, None


class _Collector(ast.NodeVisitor):
    """One pass over a file: functions, call edges, env reads, builder
    roots, and the lock / write / fault-site indexes."""

    def __init__(self, model: _FileModel):
        self.m = model
        self.stack: List[str] = []      # function qualname stack
        self.class_stack: List[_ClassInfo] = []
        self.lock_stack: List[str] = []  # self-lock names lexically held
        self.root_lambdas: Set[int] = set()   # id() of builder lambdas

    # -- imports ----------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self.m.import_alias[alias.asname or alias.name.split(".")[0]] = \
                alias.name
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module:
            for alias in node.names:
                local = alias.asname or alias.name
                # `from quest_tpu_torch.ops import apply as A` binds a
                # MODULE alias; `from quest_tpu_torch.env import
                # knob_value` binds a function. Record both ways;
                # resolution tries module first, then (module, name).
                self.m.import_alias[local] = f"{node.module}.{alias.name}"
                self.m.from_imports[local] = (node.module, alias.name)
        self.generic_visit(node)

    # -- classes (QL005/QL007 lock index) ---------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        qual = ".".join([c.name for c in self.class_stack] + [node.name]) \
            if self.class_stack else node.name
        ci = _ClassInfo(name=qual, line=node.lineno)
        for stmt in node.body:
            tgt = val = None
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                tgt, val = stmt.targets[0].id, stmt.value
            elif isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name) \
                    and stmt.value is not None:
                tgt, val = stmt.target.id, stmt.value
            if tgt == "_GUARDED_BY":
                ci.guarded_line = stmt.lineno
                ci.guarded_by, ci.guard_parse_error = \
                    _parse_guarded_by(val)
        self.m.classes[qual] = ci
        self.class_stack.append(ci)
        self.generic_visit(node)
        self.class_stack.pop()

    def _handle_with(self, node) -> None:
        pushed = 0
        for item in node.items:
            d = _dotted(item.context_expr)
            if d and d.startswith("self.") and d.count(".") == 1:
                self.lock_stack.append(d.split(".", 1)[1])
                pushed += 1
        self.generic_visit(node)
        if pushed:
            del self.lock_stack[-pushed:]

    visit_With = _handle_with
    visit_AsyncWith = _handle_with

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if self.class_stack and self.stack \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self":
            self.class_stack[-1].accesses.append(_AttrAccess(
                node.attr, node.lineno, node.col_offset,
                self.stack[-1], isinstance(node.ctx, (ast.Store, ast.Del)),
                frozenset(self.lock_stack)))
        if node.attr == "_data" and _dotted(node.value) in ("os.environ",
                                                             "environ"):
            self.m.raw_env_sites.append((node.lineno, node.col_offset))
        self.generic_visit(node)

    def visit_Constant(self, node: ast.Constant) -> None:
        # QL009 arming evidence: site-shaped string literals
        v = node.value
        if isinstance(v, str) and 2 < len(v) < 64 and "." in v \
                and _SITE_RE.match(v):
            self.m.site_strings.add(v)

    # -- functions --------------------------------------------------------
    def _enter(self, qual: str, node) -> _FuncInfo:
        info = _FuncInfo(qualname=qual, line=node.lineno,
                         parent=self.stack[-1] if self.stack else None,
                         node=node)
        self.m.funcs[qual] = info
        return info

    def _handle_func(self, node) -> None:
        qual = ".".join(self.stack + [node.name]) if self.stack else node.name
        info = self._enter(qual, node)
        if self.class_stack and not self.stack:
            self.class_stack[-1].methods.add(node.name)
        if (self.m.module, qual) in _BUILDER_ROOTS:
            info.root = True
        self.stack.append(qual)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _handle_func
    visit_AsyncFunctionDef = _handle_func

    def visit_Lambda(self, node: ast.Lambda) -> None:
        # a lambda is a function of its own: the calls in its body are
        # its edges, and a lambda handed to _cached is a builder root
        scope = self.stack[-1] + "." if self.stack else ""
        qual = f"{scope}<lambda:{node.lineno}:{node.col_offset}>"
        info = self._enter(qual, node)
        info.root = id(node) in self.root_lambdas
        self.stack.append(qual)
        self.generic_visit(node)
        self.stack.pop()

    # -- calls ------------------------------------------------------------
    def _resolve_local(self, name: str) -> Optional[_FuncInfo]:
        """Function bound to a local bare name: innermost enclosing
        scope's nested defs first, then module scope."""
        scope = self.stack[-1] if self.stack else None
        while scope:
            f = self.m.funcs.get(scope + "." + name)
            if f:
                return f
            scope = self.m.funcs[scope].parent \
                if scope in self.m.funcs else None
        return self.m.funcs.get(name)

    def _record_builder(self, node: ast.AST) -> None:
        """The callable handed to `_cached(key, build)` is a root: a
        lambda directly, a name through the enclosing scopes (partial
        aliases resolved), a module attribute through its import."""
        if isinstance(node, ast.Lambda):
            self.root_lambdas.add(id(node))
            return
        node = _unwrap_partial(node)
        name = _dotted(node)
        if not name:
            return
        cur = self.stack[-1] if self.stack else None
        if "." not in name:
            scope = cur
            while scope:
                alias = self.m.funcs[scope].local_callables.get(name)
                if alias is not None:
                    name = alias
                    break
                scope = self.m.funcs[scope].parent \
                    if scope in self.m.funcs else None
        head = name.split(".")[0]
        if head in self.m.import_alias and "." in name:
            tgt = (self.m.import_alias[head], name.split(".", 1)[1])
        elif name in self.m.from_imports:
            tgt = self.m.from_imports[name]
        else:
            tgt = (None, name)
        if tgt[0] is None:
            f = self._resolve_local(tgt[1].split(".")[-1]
                                    if tgt[1].startswith("self.")
                                    else tgt[1])
            if f is not None:
                f.root = True
        else:
            self.m.foreign_roots.append(tgt)
        if cur:
            self.m.funcs[cur].calls.append(tgt)

    def visit_Call(self, node: ast.Call) -> None:
        cur = self.stack[-1] if self.stack else None
        dotted = _dotted(node.func) or ""
        leaf = dotted.split(".")[-1]

        # env reads: os.environ.get / os.getenv / knob_value / knob_current
        if dotted in ("os.environ.get", "environ.get", "os.getenv",
                      "getenv"):
            var = _const_str(node.args[0]) if node.args else None
            if var:
                self.m.env_reads.append(_EnvRead(
                    var, node.lineno, node.col_offset, cur, False))
        elif leaf in ("knob_value", "knob_current"):
            var = _const_str(node.args[0]) if node.args else None
            if var:
                self.m.env_reads.append(_EnvRead(
                    var, node.lineno, node.col_offset, cur, True))

        # builder roots: the second argument of <circuit>._cached(key, b)
        if leaf == "_cached" and "." in dotted and len(node.args) >= 2:
            self._record_builder(node.args[1])

        # ordinary call edge
        if cur and dotted:
            head = dotted.split(".")[0]
            if "." in dotted and head in self.m.import_alias:
                self.m.funcs[cur].calls.append(
                    (self.m.import_alias[head], dotted.split(".", 1)[1]))
            elif "." not in dotted:
                if dotted in self.m.from_imports:
                    self.m.funcs[cur].calls.append(
                        self.m.from_imports[dotted])
                else:
                    self.m.funcs[cur].calls.append((None, dotted))
            elif dotted.startswith("self."):
                self.m.funcs[cur].calls.append(
                    (None, dotted.split(".", 1)[1]))

        head = dotted.split(".")[0] if dotted else ""

        # QL008: temp+rename evidence and write-mode opens
        if cur and head == "os" and leaf in ("rename", "replace"):
            self.m.funcs[cur].has_rename = True
        if dotted == "open":
            mode = _const_str(node.args[1]) if len(node.args) > 1 else None
            for kw in node.keywords:
                if kw.arg == "mode":
                    mode = _const_str(kw.value) or mode
            if mode and any(c in mode for c in "wax+"):
                self.m.write_opens.append((node, cur))
        elif leaf in ("write_text", "write_bytes") and "." in dotted:
            self.m.write_opens.append((node, cur))

        # QL005: self-method call edges with their lexical lock context
        if self.class_stack and self.stack and dotted.startswith("self.") \
                and dotted.count(".") == 1:
            self.class_stack[-1].self_calls.append(
                (self.stack[0], dotted.split(".", 1)[1],
                 frozenset(self.lock_stack), node.lineno))

        # QL007: candidate blocking calls inside lock-owning classes
        if self.class_stack and self.stack:
            label = self._blocking_label(node, dotted, leaf, head)
            if label:
                self.m.blocking_sites.append(
                    (node, cur, frozenset(self.lock_stack),
                     self.class_stack[-1].name, label))

        # QL009: fired / armed fault-site literals
        s0 = _const_str(node.args[0]) if node.args else None
        if s0:
            if leaf == "check" and dotted.endswith(".check"):
                recv = dotted[:-len(".check")]
                rmod = self.m.import_alias.get(recv, recv)
                if rmod.split(".")[-1] == "faults":
                    self.m.fault_fires.append(
                        (s0, node.lineno, node.col_offset))
            elif dotted == "self._fault":
                self.m.fault_fires.append(
                    (s0, node.lineno, node.col_offset))
            elif leaf == "inject":
                self.m.fault_arms.add(s0)
            elif leaf == "parse_plan":
                for part in s0.split(";"):
                    site = part.split(":", 1)[0].strip()
                    if site:
                        self.m.fault_arms.add(site)

        self.generic_visit(node)

    def _blocking_label(self, node: ast.Call, dotted: str, leaf: str,
                        head: str) -> Optional[str]:
        """Human label when the call blocks (QL007), else None."""
        if dotted == "time.sleep" or (
                dotted == "sleep"
                and self.m.from_imports.get("sleep", ("", ""))[0]
                == "time"):
            return "time.sleep"
        mod = self.m.import_alias.get(head, head)
        if mod.split(".")[0] == "subprocess" and "." in dotted:
            return f"{dotted} (subprocess)"
        if dotted == "open":
            return "open() file I/O"
        # a method call on any receiver (a tensor, an event, a stream,
        # a socket): `x.item()`, `torch.cuda.synchronize()`, ...
        if not isinstance(node.func, ast.Attribute):
            return None
        if leaf in _SYNC_METHODS and not node.args:
            what = ("torch.cuda.synchronize" if dotted ==
                    "torch.cuda.synchronize" else f".{leaf}()")
            return f"{what} (device sync)"
        if leaf in _SOCKET_METHODS:
            return f".{leaf}() (socket I/O)"
        return None

    def _handle_assign_value(self, targets, value) -> None:
        if not self.stack or not isinstance(value, ast.Call):
            return
        inner = _unwrap_partial(value)
        if inner is value:
            return
        # callable alias: `build = functools.partial(fn, ...)`
        name = _dotted(inner)
        if name:
            f = self.m.funcs[self.stack[-1]]
            for t in targets:
                if isinstance(t, ast.Name):
                    f.local_callables[t.id] = name

    def visit_Assign(self, node: ast.Assign) -> None:
        self._handle_assign_value(node.targets, node.value)
        # QL005: lock attributes created in __init__
        if self.class_stack and self.stack \
                and self.stack[0] == "__init__" \
                and isinstance(node.value, ast.Call):
            leaf = (_dotted(node.value.func) or "").split(".")[-1]
            if leaf in _LOCK_FACTORIES:
                for t in node.targets:
                    d = _dotted(t)
                    if d and d.startswith("self.") and d.count(".") == 1:
                        self.class_stack[-1].lock_attrs[
                            d.split(".", 1)[1]] = node.lineno
        # QL009: the module-level fault-site catalog (faults.SITES)
        if not self.stack and not self.class_stack \
                and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "SITES" \
                and isinstance(node.value, (ast.Tuple, ast.List)) \
                and os.path.basename(self.m.path) == "faults.py":
            elts = node.value.elts
            vals = tuple(e.value for e in elts
                         if isinstance(e, ast.Constant)
                         and isinstance(e.value, str))
            if vals and len(vals) == len(elts):
                self.m.sites_catalog = (vals, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._handle_assign_value([node.target], node.value)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # os.environ["X"] reads (Load context only; stores are writes)
        if isinstance(node.ctx, ast.Load):
            dotted = _dotted(node.value) or ""
            if dotted in ("os.environ", "environ"):
                var = _const_str(node.slice)
                if var:
                    cur = self.stack[-1] if self.stack else None
                    self.m.env_reads.append(_EnvRead(
                        var, node.lineno, node.col_offset, cur, False))
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# reachability
# ---------------------------------------------------------------------------


def _propagate(models: Dict[str, _FileModel]) -> Set[Tuple[str, str]]:
    """Fixed-point propagation of the builder roots through the call
    graph. Returns {(module, qualname)} reachable from a builder."""
    # index: (module, bare name) -> [(module, qualname)]
    by_name: Dict[Tuple[str, str], List[Tuple[str, str]]] = {}
    for mod, m in models.items():
        for qual in m.funcs:
            bare = qual.split(".")[-1]
            by_name.setdefault((mod, bare), []).append((mod, qual))

    reached: Set[Tuple[str, str]] = set()
    work: List[Tuple[str, str]] = []
    for mod, m in models.items():
        for qual, f in m.funcs.items():
            if f.root:
                reached.add((mod, qual))
                work.append((mod, qual))
        for tmod, tname in m.foreign_roots:
            for hit in by_name.get((tmod, tname.split(".")[-1]), []):
                if hit not in reached:
                    reached.add(hit)
                    work.append(hit)

    def resolve(src_mod: str, src_qual: str,
                tgt: Tuple[Optional[str], str]) -> List[Tuple[str, str]]:
        tmod, tname = tgt
        if tmod is not None:
            # exact module match, else (from-import of a function) the
            # module itself may be the function's home
            return by_name.get((tmod, tname.split(".")[-1]), [])
        # local: innermost enclosing scope first, then module scope
        m = models[src_mod]
        scope = src_qual
        while scope:
            qual = scope + "." + tname
            if qual in m.funcs:
                return [(src_mod, qual)]
            scope = m.funcs[scope].parent if scope in m.funcs else None
        if tname in m.funcs:
            return [(src_mod, tname)]
        # method call on self/instance: any class method with that name
        return [h for h in by_name.get((src_mod, tname.split(".")[-1]), [])
                if "." in h[1]]

    while work:
        mod, qual = work.pop()
        f = models[mod].funcs[qual]
        for tgt in f.calls:
            for hit in resolve(mod, qual, tgt):
                if hit not in reached:
                    reached.add(hit)
                    work.append(hit)
    return reached


def _enclosing_chain(m: _FileModel, qual: Optional[str]) -> List[str]:
    out = []
    while qual:
        out.append(qual)
        qual = m.funcs[qual].parent if qual in m.funcs else None
    return out


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


def _knob_registry():
    from quest_tpu_torch.env import KNOBS
    return KNOBS


def _check_ql001(models: Dict[str, _FileModel],
                 reach: Set[Tuple[str, str]],
                 out: List[Violation]) -> None:
    knobs = _knob_registry()
    for mod, m in models.items():
        if m.module is None:
            continue                      # scripts/tests are driver code
        for r in m.env_reads:
            if not r.name.lstrip("_").startswith("QUEST_"):
                continue
            if r.func is None:
                continue                  # import-time read: stale-proof
            chain = _enclosing_chain(m, r.func)
            if not any((mod, q) in reach for q in chain):
                continue
            k = knobs.get(r.name)
            if k is None or k.scope not in ("keyed", "import_once"):
                scope = "unregistered" if k is None else f"scope={k.scope!r}"
                out.append(Violation(
                    "QL001", m.path, r.line, r.col,
                    f"knob {r.name} is read on a path a program builder "
                    f"reaches but is {scope} in env.KNOBS: register it as "
                    f"scope='keyed' (engine_mode_key() then carries it "
                    f"into every program cache key) or 'import_once', or "
                    f"the program caches go stale when it flips"))


def _check_ql004(models: Dict[str, _FileModel],
                 out: List[Violation]) -> None:
    knobs = _knob_registry()
    env_mod = f"{PACKAGE}.env"
    for mod, m in models.items():
        for r in m.env_reads:
            if not r.name.lstrip("_").startswith("QUEST_"):
                continue
            if r.name not in knobs:
                out.append(Violation(
                    "QL004", m.path, r.line, r.col,
                    f"knob {r.name} is not registered in env.KNOBS: "
                    f"every QUEST_* knob needs a registry entry with a "
                    f"validating parser (name, parse, default, scope)"))
                continue
            if (m.module is not None and m.module != env_mod
                    and not r.via_registry):
                out.append(Violation(
                    "QL004", m.path, r.line, r.col,
                    f"direct os.environ read of {r.name} bypasses the "
                    f"registry's validating parser; use "
                    f"env.knob_value({r.name!r}) so malformed input "
                    f"raises at the read site"))
        if m.module == _SANCTIONED_RAW_ENV:
            continue
        for line, col in m.raw_env_sites:
            out.append(Violation(
                "QL004", m.path, line, col,
                "read of the encoded environment (os.environ._data) "
                "outside env.py bypasses the registry's validating "
                "parser; only env.engine_mode_key reads it"))


# ---------------------------------------------------------------------------
# QL005 — lock discipline
# ---------------------------------------------------------------------------


def _lock_groups(ci: _ClassInfo) -> Dict[str, FrozenSet[str]]:
    """guarded-by key -> the set of lock attr names that satisfy it
    (the `"_lock|_cond"` alias form accepts either)."""
    return {key: frozenset(key.split("|"))
            for key in (ci.guarded_by or {}) if key != _OWNER_KEY}


def _held_methods(ci: _ClassInfo, group: FrozenSet[str]) -> Set[str]:
    """Methods provably only reached with a lock of `group` held:
    greatest fixed point over the intra-class call graph.  Seeded with
    private helpers that have at least one internal call site; a method
    is demoted when any call site lacks the lock and the caller is not
    itself held.  Public methods never qualify — external callers
    don't hold the lock."""
    callees = {c for (_caller, c, _locks, _ln) in ci.self_calls}
    held = {name for name in ci.methods
            if name.startswith("_") and not name.startswith("__")
            and name in callees}
    changed = True
    while changed:
        changed = False
        for (caller, callee, locks, _ln) in ci.self_calls:
            if callee not in held:
                continue
            if locks & group:
                continue
            if caller in held:
                continue
            held.discard(callee)
            changed = True
    return held


def _check_ql005(models: Dict[str, _FileModel],
                 out: List[Violation]) -> None:
    for mod, m in models.items():
        for ci in m.classes.values():
            if ci.guard_parse_error:
                out.append(Violation(
                    "QL005", m.path, ci.guarded_line, 0,
                    f"malformed _GUARDED_BY on {ci.name}: "
                    f"{ci.guard_parse_error}"))
                continue
            if ci.guarded_by is None:
                # classes that own a lock must declare what it guards
                if ci.lock_attrs:
                    lock, line = sorted(ci.lock_attrs.items(),
                                        key=lambda kv: kv[1])[0]
                    out.append(Violation(
                        "QL005", m.path, line, 0,
                        f"{ci.name} creates self.{lock} but declares no "
                        f"_GUARDED_BY: list the attributes the lock "
                        f"guards"))
                continue
            groups = _lock_groups(ci)
            guarded: Dict[str, FrozenSet[str]] = {}
            for key, attrs in ci.guarded_by.items():
                if key == _OWNER_KEY:
                    for a in attrs:
                        guarded[a] = frozenset()
                    continue
                locks = groups[key]
                if not locks & set(ci.lock_attrs):
                    out.append(Violation(
                        "QL005", m.path, ci.guarded_line, 0,
                        f"_GUARDED_BY key {key!r} on {ci.name} names no "
                        f"lock created in __init__ "
                        f"(have: {sorted(ci.lock_attrs) or 'none'})"))
                    continue
                for a in attrs:
                    guarded[a] = locks
            held_cache: Dict[FrozenSet[str], Set[str]] = {}
            declared = set(guarded) | set(ci.lock_attrs)
            for acc in ci.accesses:
                if acc.method and acc.method.split(".")[0] == "__init__":
                    continue  # construction happens-before publication
                locks = guarded.get(acc.attr)
                if locks is None:
                    # completeness: writes to undeclared shared attrs
                    if acc.write and acc.attr not in declared \
                            and not acc.attr.startswith("__"):
                        out.append(Violation(
                            "QL005", m.path, acc.line, acc.col,
                            f"{ci.name}.{acc.attr} is written outside "
                            f"__init__ but missing from _GUARDED_BY: "
                            f"declare its lock (or put it under "
                            f"'<owner-thread>' if single-owner)"))
                    continue
                if not locks:
                    continue  # <owner-thread>: trusted single-owner
                if acc.locks & locks:
                    continue
                root = acc.method.split(".")[0] if acc.method else None
                if locks not in held_cache:
                    held_cache[locks] = _held_methods(ci, locks)
                if root in held_cache[locks]:
                    continue
                kind = "write to" if acc.write else "read of"
                out.append(Violation(
                    "QL005", m.path, acc.line, acc.col,
                    f"unlocked {kind} {ci.name}.{acc.attr}: "
                    f"_GUARDED_BY says hold self.{sorted(locks)[0]} "
                    f"(wrap in `with self.{sorted(locks)[0]}:` or call "
                    f"from a lock-held helper)"))


# ---------------------------------------------------------------------------
# QL007 — blocking calls under a serve/fleet lock
# ---------------------------------------------------------------------------


def _check_ql007(models: Dict[str, _FileModel],
                 out: List[Violation]) -> None:
    for mod, m in models.items():
        for (node, func, locks, cls, label) in m.blocking_sites:
            ci = m.classes.get(cls)
            if ci is None or not ci.lock_attrs:
                continue
            own = set(ci.lock_attrs)
            held = locks & own
            root = func.split(".")[0] if func else None
            if not held and root is not None:
                # call-graph propagation: a private helper only ever
                # entered with the lock held blocks just the same
                for group in (set(_lock_groups(ci).values())
                              or {frozenset(own)}):
                    if root in _held_methods(ci, group):
                        held = group & own
                        break
            if not held:
                continue
            if root == "__init__":
                continue
            lock = sorted(held)[0]
            out.append(Violation(
                "QL007", m.path, node.lineno, node.col_offset,
                f"{label} while holding self.{lock} in {cls}: every "
                f"other thread contending for the lock stalls behind "
                f"this call (the watchdog-deadlock class); move it "
                f"outside the critical section"))


# ---------------------------------------------------------------------------
# QL008 — atomic-write discipline in persistence modules
# ---------------------------------------------------------------------------


def _check_ql008(models: Dict[str, _FileModel],
                 out: List[Violation]) -> None:
    for mod, m in models.items():
        if m.module not in _PERSISTENCE_MODULES:
            continue
        for (node, func) in m.write_opens:
            chain = _enclosing_chain(m, func)
            # the temp+rename idiom: any function on the enclosing
            # chain whose subtree performs os.replace/os.rename makes
            # the write crash-atomic (write tmp, fsync, rename)
            safe = any(m.funcs[q].has_rename for q in chain
                       if q in m.funcs)
            if not safe and func is not None:
                # nested helpers: the top-level enclosing def may carry
                # the rename while the helper does the open
                top = chain[-1] if chain else func
                info = m.funcs.get(top)
                if info is not None and info.node is not None:
                    safe = any(
                        isinstance(n, ast.Call)
                        and (_dotted(n.func) or "") in
                        ("os.rename", "os.replace")
                        for n in ast.walk(info.node))
            if safe:
                continue
            out.append(Violation(
                "QL008", m.path, node.lineno, node.col_offset,
                f"bare write in {m.module} outside a temp+rename "
                f"scope: a crash mid-write leaves a torn file the "
                f"resume path will read; write to a tmp name and "
                f"os.replace() into place"))


# ---------------------------------------------------------------------------
# QL009 — fault-site catalog integrity
# ---------------------------------------------------------------------------


def _is_test_file(m: _FileModel, root: str) -> bool:
    rel = os.path.relpath(m.path, root)
    base = os.path.basename(m.path)
    return rel.split(os.sep)[0] == "tests" and (
        base.startswith("test_") or base == "conftest.py")


def _site_catalog(models: Dict[str, _FileModel]):
    """(sites, path, line) from the scanned faults.py, else from the
    importable package (single-file lint runs still validate literals
    against the real catalog), else None."""
    for m in models.values():
        if m.sites_catalog is not None:
            return m.sites_catalog[0], m.path, m.sites_catalog[1]
    try:
        from quest_tpu_torch.resilience import faults as _faults
        return tuple(_faults.SITES), None, 0
    except Exception:                      # pragma: no cover - import guard
        return None


def _check_ql009(models: Dict[str, _FileModel], root: str,
                 out: List[Violation]) -> None:
    cat = _site_catalog(models)
    if cat is None:                        # pragma: no cover - import guard
        return
    sites, cat_path, cat_line = cat
    known = set(sites)
    fires: Dict[str, int] = {}
    arms: Set[str] = set()
    have_tests = False
    for mod, m in models.items():
        if _is_test_file(m, root):
            have_tests = True
            arms |= m.fault_arms
            arms |= {s for s in m.site_strings if s in known}
        for (site, line, col) in m.fault_fires:
            fires[site] = fires.get(site, 0) + 1
            if site not in known:
                out.append(Violation(
                    "QL009", m.path, line, col,
                    f"fault site {site!r} is not in faults.SITES: a "
                    f"typo here makes the injection plan silently "
                    f"never fire; add it to the catalog or fix the "
                    f"literal"))
    # coverage legs only when the catalog itself and the test tree are
    # both in scope (single-file runs stay literal-validation only)
    if cat_path is None or not have_tests:
        return
    for site in sites:
        if site not in fires:
            out.append(Violation(
                "QL009", cat_path, cat_line, 0,
                f"catalog site {site!r} has no firing call site "
                f"(faults.check/self._fault literal) anywhere in the "
                f"tree: dead catalog entries rot into armed-but-"
                f"silent pins"))
        if site not in arms:
            out.append(Violation(
                "QL009", cat_path, cat_line, 0,
                f"catalog site {site!r} is never armed by any test "
                f"(no inject()/parse_plan()/literal in tests/): the "
                f"failure path it guards is untested"))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def check_rules(rules: Optional[Sequence[str]]) -> Optional[List[str]]:
    """`rules` as a list, or None for all; ValueError naming why for a
    rule that is not ported (JAX_RULES) or unknown."""
    if rules is None:
        return None
    rules = list(rules)
    for r in rules:
        if r in JAX_RULES:
            raise ValueError(f"rule {r} is not checked here: {JAX_RULES[r]}")
        if r not in RULES:
            raise ValueError(f"unknown rule {r!r}; known: {sorted(RULES)}")
    return rules


def collect_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(os.path.abspath(p))
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git")]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(os.path.abspath(
                            os.path.join(dirpath, fn)))
    return out


def run_lint(paths: Sequence[str],
             rules: Optional[Sequence[str]] = None,
             root: Optional[str] = None) -> List[Violation]:
    """Lint `paths` (files or directories); returns unsuppressed
    violations sorted by location. `rules` restricts to a subset of
    RULES (a JAX_RULES entry raises ValueError with its reason); `root`
    anchors module-name resolution (default: the common ancestor
    holding the quest_tpu_torch package)."""
    rules = check_rules(rules)
    files = collect_files(paths)
    if root is None:
        root = os.path.commonpath(files) if files else os.getcwd()
        if os.path.isfile(root):
            root = os.path.dirname(root)
        while root != os.path.dirname(root) and not os.path.isdir(
                os.path.join(root, PACKAGE)):
            root = os.path.dirname(root)

    models: Dict[str, _FileModel] = {}
    violations: List[Violation] = []
    for path in files:
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            violations.append(Violation(
                "QL000", path, e.lineno or 0, e.offset or 0,
                f"syntax error: {e.msg}"))
            continue
        module = _module_name_for(path, root)
        m = _FileModel(path, module, tree, source)
        _Collector(m).visit(tree)
        # key: dotted module for package files, path for driver files
        models[module or path] = m

    active = set(rules) if rules else set(RULES)
    if "QL001" in active:
        _check_ql001(models, _propagate(models), violations)
    if "QL004" in active:
        _check_ql004(models, violations)
    if "QL005" in active:
        _check_ql005(models, violations)
    if "QL007" in active:
        _check_ql007(models, violations)
    if "QL008" in active:
        _check_ql008(models, violations)
    if "QL009" in active:
        _check_ql009(models, root, violations)

    by_path = {m.path: m for m in models.values()}
    used: Set[Tuple[str, int, str]] = set()
    kept: List[Violation] = []
    for v in violations:
        m = by_path.get(v.path)
        if m is not None and m.suppressed(v.rule, v.line):
            if v.rule in m.suppressed_lines.get(v.line, {}):
                used.add((v.path, v.line, v.rule))
            else:
                used.add((v.path, -1, v.rule))
            continue
        kept.append(v)
    # audited escapes: a reasoned `disable=QLnnn(reason)` that
    # suppresses nothing is itself flagged — stale escapes are how
    # real violations sneak back in. Bare (reasonless) suppressions
    # keep the fire-and-forget semantics.
    for m in by_path.values():
        for line, entry in m.suppressed_lines.items():
            for rule, reason in entry.items():
                if reason is None or rule not in active:
                    continue
                if (m.path, line, rule) not in used:
                    kept.append(Violation(
                        rule, m.path, line, 0,
                        f"unused suppression disable={rule}({reason}): "
                        f"no {rule} violation on this line; remove the "
                        f"stale escape"))
        for rule, (reason, line) in m.suppressed_file.items():
            if reason is None or rule not in active:
                continue
            if (m.path, -1, rule) not in used:
                kept.append(Violation(
                    rule, m.path, line, 0,
                    f"unused suppression disable-file={rule}({reason}): "
                    f"no {rule} violation in this file; remove the "
                    f"stale escape"))
    kept.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return kept
