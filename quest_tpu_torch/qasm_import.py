"""OPENQASM 2.0 importer: text -> Circuit.

A port of quest_tpu/qasm_import.py: the same dialects, folding rules and
error messages, building the port's Circuit.

The reference can only EXPORT QASM (QuEST_qasm.c); importing is a
migration on-ramp it never had. Two dialects are accepted:

  * the recorder's own output (quest_tpu_torch/qasm.py, format-compatible
    with the reference logger): ``Ctrl-`` prefixes — operands are the
    controls first, target(s) last — capitalized ``Rx/Ry/Rz``,
    ``U(rz2, ry, rz1)`` ZYZ lines meaning Rz(rz2)@Ry(ry)@Rz(rz1),
    ``measure q[i] -> c[i]``, ``reset``, and comment lines. The
    importer understands the recorder's CONVENTIONS, not just its
    gate names: a ``Ctrl-…Rz``/``Ctrl-…U`` line followed by the
    "Restoring the discarded global phase" comment and its
    uncontrolled ``Rz`` fix-up line is folded back into the exact
    controlled phase / controlled unitary the recorder was describing
    (the fix-up convention comes from qasm_recordControlledParamGate /
    qasm_recordControlledUnitary, QuEST_qasm.c:246-298, and is not an
    exact gate sequence on its own — reconstructing the source gate is
    both exact and faithful to intent);
  * standard qelib1 gates: ``cx/cz/ccx/cswap/cu1/crz/u1/u2/u3/id/
    sdg/tdg`` plus ``barrier`` (ignored) and ``pi``-arithmetic in
    parameters (``rz(pi/4)``). Lowercase ``u(theta,phi,lambda)`` is
    the qelib1 u3 convention; dispatch is CASE-SENSITIVE because the
    recorder's capitalized ``U(rz2,ry,rz1)`` names a different
    convention with the same letter. The OPENQASM builtin capital
    ``U(theta,phi,lambda)`` is recognized per file: an ``include``
    line with no recorder markers (``Ctrl-`` prefixes / restore
    comments) switches capital U to the spec (u3) order.

Round-trip guarantee: ``from_qasm(c.to_qasm())`` applies the same
unitary as ``c`` up to global phase (angles pass through %g text at
~1e-6 relative) for every circuit whose ops the exporter can express
as gate lines (i.e. everything except >=2-target general unitaries
and channels, which degrade to comments).

QASM-2 classical conditionals (``if (c==k)``) are rejected with a
pointer at the dynamic-circuit API (Circuit.gate_if), which is
strictly more general.
"""

from __future__ import annotations

import ast
import math
import re

import numpy as np

from quest_tpu_torch.validation import QuESTError

_OPERAND = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\[(\d+)\]")
_DECL = re.compile(r"(qreg|creg)\s+([A-Za-z_][A-Za-z0-9_]*)\[(\d+)\]")
_RESTORE_MARK = "Restoring the discarded global phase"


def _rz(t):
    return np.diag([np.exp(-0.5j * t), np.exp(0.5j * t)])


def _ry(t):
    c, s = math.cos(t / 2), math.sin(t / 2)
    return np.array([[c, -s], [s, c]], dtype=np.complex128)


def _rx(t):
    c, s = math.cos(t / 2), math.sin(t / 2)
    return np.array([[c, -1j * s], [-1j * s, c]], dtype=np.complex128)


def _u_zyz(a, b, c):
    """The recorder's U(rz2, ry, rz1) line: Rz(rz2) @ Ry(ry) @ Rz(rz1)."""
    return _rz(a) @ _ry(b) @ _rz(c)


def _u3(theta, phi, lam):
    """Standard u3(theta, phi, lambda) = Rz(phi) Ry(theta) Rz(lambda)
    with the qelib1 phase convention."""
    u = _rz(phi) @ _ry(theta) @ _rz(lam)
    return u * np.exp(0.5j * (phi + lam))


def _eval_param(text: str) -> float:
    """Numeric parameter with pi-arithmetic (``pi/2``, ``3*pi/4``,
    ``-0.5``): a safe AST walk, not eval()."""
    try:
        node = ast.parse(text.strip(), mode="eval").body
    except SyntaxError:
        raise QuESTError(f"unparseable QASM parameter: {text!r}")

    def walk(nd):
        if isinstance(nd, ast.Constant) and isinstance(nd.value, (int, float)):
            return float(nd.value)
        if isinstance(nd, ast.Name) and nd.id.lower() == "pi":
            return math.pi
        if isinstance(nd, ast.UnaryOp) and isinstance(nd.op, (ast.USub, ast.UAdd)):
            v = walk(nd.operand)
            return -v if isinstance(nd.op, ast.USub) else v
        if isinstance(nd, ast.BinOp) and isinstance(
                nd.op, (ast.Add, ast.Sub, ast.Mult, ast.Div)):
            a, b = walk(nd.left), walk(nd.right)
            op = type(nd.op)
            if op is ast.Add:
                return a + b
            if op is ast.Sub:
                return a - b
            if op is ast.Mult:
                return a * b
            return a / b
        raise QuESTError(f"unsupported QASM parameter expression: {text!r}")

    return walk(node)


# name (lowercased, Ctrl- prefixes stripped) -> (n_params, n_gate_qubits)
_GATES = {
    "h": (0, 1), "x": (0, 1), "y": (0, 1), "z": (0, 1), "s": (0, 1),
    "t": (0, 1), "sdg": (0, 1), "tdg": (0, 1), "id": (0, 1),
    "rx": (1, 1), "ry": (1, 1), "rz": (1, 1), "phase": (1, 1),
    "u1": (1, 1), "u2": (2, 1), "u3": (3, 1), "u": (3, 1),
    "swap": (0, 2), "sqrtswap": (0, 2),
    "cx": (0, 2), "cnot": (0, 2), "cz": (0, 2), "cu1": (1, 2),
    "crz": (1, 2),
    "ccx": (0, 3), "cswap": (0, 3),
}

# gates that are (controls, base) compounds in the standard dialect
_COMPOUND_CONTROLS = {"cx": 1, "cnot": 1, "ccx": 2, "cswap": 1, "crz": 1}

_FIXED = {
    "sdg": np.diag([1.0, -1.0j]),
    "tdg": np.diag([1.0, np.exp(-0.25j * math.pi)]),
}


def _tokenize(text: str):
    """('stmt', code) / ('comment', text) items, in order."""
    items = []
    for raw in text.splitlines():
        code, _, comment = raw.partition("//")
        code = code.strip()
        for s in code.split(";"):
            s = s.strip()
            if s:
                items.append(("stmt", s))
        if comment.strip():
            items.append(("comment", comment.strip()))
    return items


def _split_head(stmt: str):
    """(head, rest) of a gate statement, head normalized to
    ``name(params)`` / ``name``. The QASM lexer permits arbitrary
    whitespace between tokens — ``rz(pi/2)q[0];``, ``rz (pi/2) q[0];``
    and ``rz(pi/2) q[0];`` are all legal — so when a ``(`` appears and
    everything before it is a single bare name, the head ends at the
    MATCHING close paren (depth-counted: parameters may themselves
    parenthesize, ``rz(2*(1+1))``). Operand lists never contain parens,
    so a ``(`` always opens the parameter list. Otherwise the head is
    the first space-separated token."""
    op = stmt.find("(")
    pre = stmt[:op].strip() if op != -1 else ""
    if op != -1 and pre and not re.search(r"\s", pre):
        depth = 0
        for j in range(op, len(stmt)):
            if stmt[j] == "(":
                depth += 1
            elif stmt[j] == ")":
                depth -= 1
                if depth == 0:
                    return pre + stmt[op:j + 1], stmt[j + 1:]
        raise QuESTError(f"unbalanced parentheses in: {stmt!r}")
    head, _, rest = stmt.partition(" ")
    return head, rest


def _split_params(ptext: str):
    """Top-level comma split of a parameter list body (depth-aware, so
    ``2*(1+1), pi`` yields two items)."""
    out, depth, start = [], 0, 0
    for j, ch in enumerate(ptext):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            out.append(ptext[start:j])
            start = j + 1
    out.append(ptext[start:])
    return [p for p in out if p.strip()]


def _parse_gate_head(stmt: str):
    """(name_lower, params, nctrl, qubit_indices, reg_names, raw_name)
    of a gate statement. ``raw_name`` preserves case: the recorder
    dialect's ``U`` and qelib1's ``u`` name DIFFERENT conventions and
    are dispatched case-sensitively by the caller."""
    head, rest = _split_head(stmt)
    name, params = head, []
    if "(" in head:
        name, ptext = head.split("(", 1)
        if ptext.endswith(")"):
            ptext = ptext[:-1]
        params = [_eval_param(p) for p in _split_params(ptext)]
    nctrl = 0
    while name.lower().startswith("ctrl-"):
        nctrl += 1
        name = name[len("ctrl-"):]
    operands = _OPERAND.findall(rest)
    return (name.lower(), params, nctrl,
            [int(i) for _, i in operands], [r for r, _ in operands], name)


def _qubit_operands(rest, qreg_name, circ, stmt):
    """Qubit indices named in an operand list. Indexed creg operands
    (``-> c[i]``) are ignored; a BARE register name means every qubit —
    the recorder emits whole-register ``reset q;`` / ``h q;`` lines for
    initZeroState / initPlusState (qasm.record_init_zero/_plus)."""
    ops = _OPERAND.findall(rest)
    qubits = [int(i) for r, i in ops if r == qreg_name]
    if qubits:
        return qubits
    if ops and not qubits:
        raise QuESTError(f"operand outside qreg {qreg_name!r}: {stmt!r}")
    if re.search(rf"(^|[\s,]){re.escape(qreg_name)}([\s,;]|$)",
                 rest.replace("->", " ")):
        return list(range(circ.num_qubits))
    raise QuESTError(f"malformed operand list in: {stmt!r}")


def _is_uncontrolled_rz(item):
    """(angle, qubit) of an uncontrolled single-qubit Rz statement, else
    None. The caller checks the qubit against the preceding controlled
    line's target — the recorder always applies its fix-up there
    (qasm.py record_gate/record_unitary; ref QuEST_qasm.c:252-298) — so
    a foreign file with a coincidental restore comment is not folded."""
    if item is None or item[0] != "stmt":
        return None
    name, params, nctrl, qubits, _, _ = _parse_gate_head(item[1])
    if name == "rz" and nctrl == 0 and len(params) == 1 and len(qubits) == 1:
        return params[0], qubits[0]
    return None


def circuit_from_qasm(text: str, u_dialect: str | None = None,
                      transpile: bool | None = None):
    """Parse OPENQASM 2.0 text into a Circuit (see module docstring for
    the accepted dialects and the recorder-convention folding).

    `u_dialect` pins the capital-``U`` parameter convention: ``"spec"``
    (OPENQASM 2.0 builtin ``U(theta, phi, lambda)``) or ``"recorder"``
    (the recorder's ``U(rz2, ry, rz1)`` ZYZ order). Default ``None``
    applies the marker heuristic below — and warns on stderr the first
    time a capital U is read as ZYZ in a file with an OPENQASM header
    but NO recorder markers, because a spec-compliant file needs no
    ``include`` for its builtin U and would otherwise parse silently
    with the wrong parameter order (ADVICE r4 item 1).

    `transpile` routes the imported stream through the circuit
    transpiler (quest_tpu_torch/transpile.py, docs/TRANSPILE.md) — foreign
    corpora arrive rebased into long 1q+CX chains, exactly what the
    rewriter reverses. ``None`` follows QUEST_TRANSPILE ('auto' takes
    the rewrite only when strictly cheaper under the banded cost
    model); ``True`` takes it whenever it changed the stream; ``False``
    never rewrites. The rewrite report (ops_in/ops_out, per-pass
    attribution) rides on the returned circuit as
    ``_transpile_report`` when a rewrite was applied."""
    from quest_tpu_torch.circuit import Circuit
    from quest_tpu_torch.ops import matrices as M

    if u_dialect not in (None, "spec", "recorder"):
        raise ValueError(
            f"u_dialect must be None, 'spec' or 'recorder', got "
            f"{u_dialect!r}")

    fixed = {
        "h": M.HADAMARD, "x": M.PAULI_X, "y": M.PAULI_Y, "z": M.PAULI_Z,
        "s": np.diag([1.0, 1.0j]),
        "t": np.diag(M.T_DIAG), **_FIXED,
    }

    items = _tokenize(text)
    circ = None
    qreg_name = None

    # Capital-U dialect disambiguation: the recorder's ``U(rz2,ry,rz1)``
    # and the OPENQASM 2.0 builtin ``U(theta,phi,lambda)`` collide on
    # the same letter with different parameter orders. The recorder
    # never emits ``include``; spec/qelib1 files never emit ``Ctrl-``
    # prefixes or restore comments. A file carrying an include and no
    # recorder markers reads capital U as the spec builtin (= u3);
    # anything else — in particular every recorder/reference export —
    # keeps the ZYZ dialect, preserving the round-trip guarantee.
    has_include = any(k == "stmt" and s.lower().startswith("include")
                      for k, s in items)
    has_header = any(k == "stmt" and s.lower().startswith("openqasm")
                     for k, s in items)
    has_recorder_marker = any(
        (k == "stmt" and s.lower().startswith("ctrl-"))
        or (k == "comment" and _RESTORE_MARK in s)
        for k, s in items)
    if u_dialect is not None:
        spec_builtin_u = u_dialect == "spec"
        warn_ambiguous_u = False
    else:
        spec_builtin_u = has_include and not has_recorder_marker
        # header + no include + no recorder markers: the heuristic keeps
        # ZYZ (round-trip guarantee) but a spec-compliant file lands
        # here too — one warning per parse, silenceable via u_dialect
        warn_ambiguous_u = (has_header and not has_include
                            and not has_recorder_marker)
    _u_warned = [False]

    def _warn_u_once():
        if warn_ambiguous_u and not _u_warned[0]:
            _u_warned[0] = True
            import sys
            print(
                "[qasm_import] capital U read in the recorder's "
                "U(rz2, ry, rz1) ZYZ order; this file has an OPENQASM "
                "header but no recorder markers, so if it means the "
                "spec builtin U(theta, phi, lambda) pass "
                "u_dialect='spec' (u_dialect='recorder' silences this)",
                file=sys.stderr)

    def need_circuit():
        if circ is None:
            raise QuESTError("QASM gate line before any qreg declaration")
        return circ

    i = 0
    while i < len(items):
        kind, stmt = items[i]
        i += 1
        if kind == "comment":
            continue
        low = stmt.lower()
        if low.startswith("openqasm") or low.startswith("include"):
            continue
        if low.startswith("barrier"):
            continue
        if low.startswith("if"):
            raise QuESTError(
                "QASM-2 classical conditionals are not imported; express "
                "feedback with the dynamic-circuit API (Circuit.measure + "
                "Circuit.gate_if), which conditions on individual "
                "measurement outcomes")
        m = _DECL.match(stmt)
        if m:
            dkind, name, size = m.group(1), m.group(2), int(m.group(3))
            if dkind == "qreg":
                if circ is not None:
                    raise QuESTError("multiple qreg declarations are not "
                                     "supported")
                circ = Circuit(size)
                qreg_name = name
            continue
        if low.startswith("measure"):
            for q in _qubit_operands(stmt.split(None, 1)[1] if " " in stmt
                                     else "", qreg_name, need_circuit(),
                                     stmt):
                need_circuit().measure(q)
            continue
        if low.startswith("reset"):
            # the recorder emits whole-register `reset q;` for
            # initZeroState (qasm.record_init_zero)
            for q in _qubit_operands(stmt.split(None, 1)[1] if " " in stmt
                                     else "", qreg_name, need_circuit(),
                                     stmt):
                need_circuit().reset(q)
            continue

        name, params, nctrl, qubits, regs, raw_name = _parse_gate_head(stmt)
        if name not in _GATES:
            raise QuESTError(f"unknown QASM gate {name!r} in {stmt!r}")
        want_params, base_qubits = _GATES[name]
        if len(params) != want_params:
            raise QuESTError(
                f"gate {name!r} takes {want_params} parameter(s), got "
                f"{len(params)}: {stmt!r}")
        if any(r != qreg_name for r in regs):
            raise QuESTError(f"operand outside qreg {qreg_name!r}: {stmt!r}")
        if (not qubits and nctrl == 0 and _GATES[name][1] == 1
                and name not in _COMPOUND_CONTROLS):
            # whole-register 1q gate, e.g. the recorder's `h q;` for
            # initPlusState (qasm.record_init_plus): one gate per qubit,
            # re-queued as indexed statements (head keeps its params)
            head, rest = _split_head(stmt)
            for q in reversed(_qubit_operands(rest, qreg_name,
                                              need_circuit(), stmt)):
                items.insert(i, ("stmt", f"{head} {qreg_name}[{q}]"))
            continue
        nctrl += _COMPOUND_CONTROLS.get(name, 0)
        if name in _COMPOUND_CONTROLS:
            base_qubits -= _COMPOUND_CONTROLS[name]
        if name in ("swap", "sqrtswap") and nctrl:
            # recorder dialect: a plain swap is emitted as Ctrl-swap with
            # the first swap qubit riding as the "control"
            # (qasm.record_gate("swap", t1, (t0,)))
            nctrl -= 1
        if len(qubits) != nctrl + base_qubits:
            raise QuESTError(
                f"gate {name!r} with {nctrl} control(s) takes "
                f"{nctrl + base_qubits} operand(s), got {len(qubits)}: "
                f"{stmt!r}")
        controls, gate_qubits = qubits[:nctrl], qubits[nctrl:]
        c = need_circuit()

        # --- recorder-convention folding -------------------------------
        # a restore comment + uncontrolled Rz fix-up after a controlled
        # Rz/U line identifies the exporter's controlled-phase /
        # controlled-unitary convention; fold back to the source gate.
        # The fold only fires when the fix-up matches the recorder's
        # actual convention — Rz on the SAME target, and (for the phase
        # case) angle == param/2 — so a foreign file with a coincidental
        # comment falls through to literal interpretation.
        restore_phase = None
        recorder_u = raw_name == "U" and not spec_builtin_u
        if (controls and (name == "rz" or recorder_u)
                and i < len(items) and items[i][0] == "comment"
                and _RESTORE_MARK in items[i][1]):
            fix = _is_uncontrolled_rz(
                items[i + 1] if i + 1 < len(items) else None)
            if fix is not None:
                fix_angle, fix_qubit = fix
                matches = fix_qubit == qubits[-1] and (
                    name != "rz"
                    or math.isclose(fix_angle, params[0] / 2.0,
                                    rel_tol=1e-5, abs_tol=1e-9))
                if matches:
                    restore_phase = fix_angle
                    i += 2      # consume the comment and the fix-up line
        if restore_phase is not None and name == "rz":
            # qasm_recordControlledParamGate: controlled PHASE SHIFT of
            # angle = the Ctrl-Rz parameter (fix-up was angle/2)
            c.cphase(params[0], *qubits)
            continue
        if restore_phase is not None and name == "u":
            # qasm_recordControlledUnitary: u = e^{i phase} * ZYZ
            u = np.exp(1j * restore_phase) * _u_zyz(*params)
            c.gate(u, (gate_qubits[0],), controls=tuple(controls))
            continue

        if name == "id":
            continue
        if name == "cz":
            c.cphase(math.pi, *qubits)
            continue
        if name in ("cu1", "u1", "phase"):
            angle = params[0]
            if name == "cu1" or controls:
                c.cphase(angle, *qubits)   # diag phase: fully symmetric
            else:
                c.phase(gate_qubits[0], angle)
            continue
        if name in ("swap", "sqrtswap", "cswap"):
            a, b = gate_qubits
            if controls:
                mat = M.SQRT_SWAP if name == "sqrtswap" else M.SWAP
                c.gate(mat, (a, b), controls=tuple(controls))
            elif name == "sqrtswap":
                c.sqrt_swap(a, b)
            else:
                c.swap(a, b)
            continue
        if name in ("cx", "cnot", "ccx"):
            if len(controls) == 1:
                c.cnot(controls[0], gate_qubits[0])
            else:
                c.gate(M.PAULI_X, (gate_qubits[0],),
                       controls=tuple(controls))
            continue

        # 1-qubit gates (fixed, rotations, u-lines)
        t = gate_qubits[0]
        if name in fixed:
            mat = fixed[name]
        elif name in ("rx",):
            mat = _rx(params[0])
        elif name == "ry":
            mat = _ry(params[0])
        elif name in ("rz", "crz"):
            mat = _rz(params[0])
        elif name == "u":
            # case-sensitive dispatch: the recorder (and the reference
            # logger it mirrors) emits capitalized ``U(rz2,ry,rz1)``
            # meaning Rz@Ry@Rz with no phase factor, while qelib1's
            # lowercase ``u(theta,phi,lambda)`` is u3 — same letter,
            # different convention, different unitary. Spec files
            # (include + no recorder markers) read capital U as the
            # builtin, i.e. the u3 order.
            if recorder_u:
                _warn_u_once()
                mat = _u_zyz(*params)
            else:
                mat = _u3(*params)
        elif name == "u3":
            mat = _u3(*params)
        elif name == "u2":
            mat = _u3(math.pi / 2, params[0], params[1])
        else:  # pragma: no cover — the table above is exhaustive
            raise QuESTError(f"unhandled gate {name!r}")
        if not controls:
            # use the named builders so re-export stays named
            builder = {"h": c.h, "x": c.x, "y": c.y, "z": c.z, "s": c.s,
                       "t": c.t}.get(name)
            if builder is not None:
                builder(t)
            elif name == "rx":
                c.rx(t, params[0])
            elif name == "ry":
                c.ry(t, params[0])
            elif name == "rz":
                c.rz(t, params[0])
            else:
                c.gate(mat, (t,))
        else:
            c.gate(mat, (t,), controls=tuple(controls))

    if circ is None:
        raise QuESTError("QASM text declares no qreg")
    from quest_tpu_torch import transpile as T
    if transpile is False:
        return circ
    if transpile is True:
        tc, rep = T.transpile_cached(circ)
        return tc if rep["changed"] else circ
    out, _rep = T.maybe_transpile(circ)
    return out
