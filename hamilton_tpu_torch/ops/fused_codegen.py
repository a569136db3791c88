"""K1 for any :class:`~hamilton_tpu_torch.ops.fused_step.FusedForms`: the
family's closed forms, run once on symbolic values, become the C++ policy
of a Hopper kernel.

The port's counterpart of Pallas tracing ``forms.make(at, FM_JNP)`` into
the TPU kernel (``hamilton_tpu/ops/pallas_step.py:594``).  Each form of the
family — ``aux``, the mass-matrix entries ``k_at`` (or the family's own
``factor_solve``), ``dhdq`` and ``aux_shift`` — runs on symbolic values
(:class:`_Value` for a member value, :class:`_Const` for a Python float of
the shared constant table) against :data:`FM_TRACE`, the namespace of
``FM_TORCH``.  Every ``+ − * /``, negation and ``fm`` call is recorded in
evaluation order as one statement of a straight-line program
(:class:`Program`); :func:`header` prints the programs as the C++ struct
``UserForms`` that ``csrc/user_family_step.cu`` runs under its step
template, one thread a member.

Each operation rounds where the plain version (``fused_step.
fused_step_reference``) rounds it on the card:

* member values are tensors of the state's dtype T: their operations round
  in T;
* with constant shared parameters the plain version's table entries are
  Python floats, and arithmetic among them folds in double.  The generated
  code reads a float64 copy of the table and folds the same
  subexpressions in double, rounding to T only where a constant meets a
  member value — so one build serves any parameter values, and only the
  forms' structure (and the literals they contain) keys the library;
* ``c / x`` with a Python-float ``c`` is ``x.reciprocal() * c`` in PyTorch
  (``Tensor.__rtruediv__``): the code emits the correctly rounded
  reciprocal times ``T(c)``;
* ``x / c``: PyTorch on CUDA multiplies by the reciprocal ``T(1) / T(c)``
  (ATen's ``div_true_kernel_cuda``, for a scalar divisor); on the CPU it
  divides.  The code follows the card, and records the operation as its
  own (``divs``); for a literal ``c`` the reciprocal folds at compile time;
* the sine and cosine of one value come from one range reduction;
* each form is a pass (``csrc/fused_step.cuh``'s ``straight_or_library``):
  in float the sine-cosine, the square root and the reciprocal are the
  straight-line versions of ``csrc/libm_fast.cuh`` (``line_sincos``,
  ``line_sqrt``, ``line_rcp``), bit for bit the library's ``sinf``,
  ``cosf``, ``sqrtf`` and ``1/x`` (``csrc/libm_check.cu``), and the form
  runs again with the library's where an input left their range;
* ``fm.full(c, like)`` rounds ``c`` to T once, ``fm.zero`` is ``T(0)``.

A form that branches on a traced value (``if mass() > 0``, ``bool(x)``),
reads one as a Python number (``float(x)``, ``math.sin(x)``) or uses an
operation outside ``+ − * /``, unary ``−``, ``abs`` and ``fm`` cannot be
generated: :class:`GenerationError` names the family and the form.  Two
kinds of value are not carried between forms as a Python float: an
``aux``, ``aux_shift`` or ``factor`` entry that does not depend on the
state must come back through ``fm.full``.

The tests evaluate the recorded programs with PyTorch in the plain step,
holding the recording against the plain version bitwise on the CPU.
"""

from __future__ import annotations

import math
import types
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional


__all__ = [
    "GenerationError",
    "Program",
    "GeneratedFamily",
    "FM_TRACE",
    "generate",
    "generated",
    "header",
]


class GenerationError(ValueError):
    """A family's forms cannot become generated code."""


# ----------------------------------------------------------------------
# The recording
# ----------------------------------------------------------------------

@dataclass
class Program:
    """One form as straight-line code.  ``ops[i] = (kind, op, args)`` defines
    value ``i`` of kind ``"T"`` (a member value in the state's dtype) or
    ``"D"`` (a double of the constant table): ``args`` are value indices,
    except for ``in`` (input group, index), ``tab`` (flat table index) and
    ``lit`` (a double).  ``outputs`` are value indices of kind T."""

    form: str
    ops: List[tuple] = field(default_factory=list)
    outputs: List[int] = field(default_factory=list)

    def reads_table(self) -> bool:
        return any(op == "tab" for _, op, _ in self.ops)


class _Recorder:
    """The program being recorded and the context for error messages."""

    def __init__(self, family: str, form: str, const_table: bool):
        self.family, self.form = family, form
        self.const_table = const_table
        self.program = Program(form)
        self.tab_cache: Dict[int, object] = {}

    def fail(self, what: str) -> GenerationError:
        return GenerationError(
            f"family {self.family!r}, form {self.form}: {what}; the fused kernel is "
            f"generated from the forms' arithmetic on traced values (+ - * /, unary -, "
            f"abs and the fm namespace), with no Python control flow on them")

    def emit(self, kind: str, op: str, *args) -> int:
        self.program.ops.append((kind, op, args))
        return len(self.program.ops) - 1

    def value(self, kind: str, op: str, *args):
        idx = self.emit(kind, op, *args)
        return _Value(self, idx) if kind == "T" else _Const(self, idx)

    def literal(self, x) -> int:
        x = float(x)
        if math.isnan(x):
            raise self.fail("a form read a traced value as a Python number (float(), "
                            "math.*), which gives no program")
        if math.isinf(x):
            raise self.fail(f"literal {x} is not finite")
        return self.emit("D", "lit", x)

    def as_t(self, x) -> int:
        """``x`` as a T value index: T values as they are, constants and
        Python numbers rounded to T (``cvt``), as PyTorch rounds a Python
        scalar against a tensor."""
        if isinstance(x, _Value) and x._rec is self:
            return x._idx
        if isinstance(x, _Const) and x._rec is self:
            return self.emit("T", "cvt", x._idx)
        if _is_number(x):
            return self.emit("T", "cvt", self.literal(x))
        raise self.fail(f"cannot use {type(x).__name__} {x!r} as a member value")

    def as_d(self, x) -> int:
        if isinstance(x, _Const) and x._rec is self:
            return x._idx
        if _is_number(x):
            return self.literal(x)
        raise self.fail(f"cannot use {type(x).__name__} {x!r} as a constant")

    def table(self, k: int):
        if k not in self.tab_cache:
            self.tab_cache[k] = self.value("D" if self.const_table else "T", "tab", k)
        return self.tab_cache[k]


def _is_number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, (bool, _Const))


def _refuse(name):
    def method(self, *args):
        raise self._rec.fail(f"'{name}' on a traced value")

    method.__name__ = name
    return method


_REFUSED = (
    "__bool__", "__float__", "__int__", "__index__", "__complex__", "__lt__", "__le__",
    "__gt__", "__ge__", "__eq__", "__ne__", "__pow__", "__rpow__", "__floordiv__",
    "__rfloordiv__", "__mod__", "__rmod__", "__divmod__", "__rdivmod__", "__round__",
    "__trunc__", "__floor__", "__ceil__", "__matmul__", "__rmatmul__", "__lshift__",
    "__rshift__", "__and__", "__or__", "__xor__", "__invert__", "__len__", "__iter__",
    "__getitem__", "__array__",
)


class _Value:
    """A member value (one element of the plain version's ``(B,)`` columns,
    in the state's dtype T) whose operations are recorded."""

    __slots__ = ("_rec", "_idx")

    def __init__(self, rec: _Recorder, idx: int):
        self._rec, self._idx = rec, idx

    def _binary(self, op, other, reflected=False):
        rec = self._rec
        if isinstance(other, _Value) and other._rec is not rec:
            raise rec.fail("a value of another form reached this one")
        if not isinstance(other, (_Value, _Const)) and not _is_number(other):
            return NotImplemented
        if op == "div" and not isinstance(other, _Value):
            if reflected:  # c / x = x.reciprocal() * c
                inv = rec.emit("T", "div", rec.as_t(1.0), self._idx)
                return _Value(rec, rec.emit("T", "mul", inv, rec.as_t(other)))
            return _Value(rec, rec.emit("T", "divs", self._idx, rec.as_d(other)))
        a, b = self._idx, rec.as_t(other)
        if reflected:
            a, b = b, a
        return _Value(rec, rec.emit("T", op, a, b))

    def __add__(self, o):
        return self._binary("add", o)

    def __radd__(self, o):
        return self._binary("add", o, True)

    def __sub__(self, o):
        return self._binary("sub", o)

    def __rsub__(self, o):
        return self._binary("sub", o, True)

    def __mul__(self, o):
        return self._binary("mul", o)

    def __rmul__(self, o):
        return self._binary("mul", o, True)

    def __truediv__(self, o):
        return self._binary("div", o)

    def __rtruediv__(self, o):
        return self._binary("div", o, True)

    def __neg__(self):
        return _Value(self._rec, self._rec.emit("T", "neg", self._idx))

    def __pos__(self):
        return self

    def __abs__(self):
        return _Value(self._rec, self._rec.emit("T", "abs", self._idx))

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise self._rec.fail(f"attribute {name!r} of a traced value")

    def __repr__(self):
        return f"<traced member value v{self._idx}>"

    __hash__ = object.__hash__


class _Const(float):
    """A Python float of the shared constant table, folded in double as
    Python folds it; a ``float`` so that forms that test
    ``isinstance(v, float)`` take the branch they take on the table."""

    def __new__(cls, rec: _Recorder, idx: int):
        obj = super().__new__(cls, math.nan)
        obj._rec, obj._idx = rec, idx
        return obj

    def _binary(self, op, other, reflected=False):
        rec = self._rec
        if isinstance(other, _Value):
            return NotImplemented  # the member value's reflected method applies
        if not isinstance(other, _Const) and not _is_number(other):
            return NotImplemented
        a, b = self._idx, rec.as_d(other)
        if reflected:
            a, b = b, a
        return _Const(rec, rec.emit("D", op, a, b))

    def __add__(self, o):
        return self._binary("add", o)

    def __radd__(self, o):
        return self._binary("add", o, True)

    def __sub__(self, o):
        return self._binary("sub", o)

    def __rsub__(self, o):
        return self._binary("sub", o, True)

    def __mul__(self, o):
        return self._binary("mul", o)

    def __rmul__(self, o):
        return self._binary("mul", o, True)

    def __truediv__(self, o):
        return self._binary("div", o)

    def __rtruediv__(self, o):
        return self._binary("div", o, True)

    def __neg__(self):
        return _Const(self._rec, self._rec.emit("D", "neg", self._idx))

    def __pos__(self):
        return self

    def __abs__(self):
        return _Const(self._rec, self._rec.emit("D", "abs", self._idx))

    def __repr__(self):
        return f"<traced table constant v{self._idx}>"

    __str__ = __repr__
    __hash__ = object.__hash__


for _name in _REFUSED:
    setattr(_Value, _name, _refuse(_name))
    setattr(_Const, _name, _refuse(_name))


def _fm_fn(op):
    def apply(x):
        if isinstance(x, _Value):
            return _Value(x._rec, x._rec.emit("T", op, x._idx))
        rec = getattr(x, "_rec", None)
        if rec is not None:
            raise rec.fail(f"fm.{op} of a constant (the plain version's fm.{op} takes "
                           f"member values)")
        raise GenerationError(f"fm.{op} of {type(x).__name__} {x!r}: the plain "
                              f"version's fm.{op} takes member values")

    apply.__name__ = op
    return apply


def _fm_full(v, like):
    rec = getattr(like, "_rec", None)
    if not isinstance(like, _Value):
        raise (rec.fail if rec else GenerationError)(
            "fm.full needs a member value to take its type and shape from")
    if isinstance(v, _Value):
        return v
    return _Value(rec, rec.as_t(v))


def _fm_zero(like):
    if not isinstance(like, _Value):
        rec = getattr(like, "_rec", None)
        raise (rec.fail if rec else GenerationError)(
            "fm.zero needs a member value to take its type and shape from")
    return _Value(like._rec, like._rec.emit("T", "zero"))


#: The math namespace the forms are traced against: the names of
#: ``fused_step.FM_TORCH``.
FM_TRACE = types.SimpleNamespace(
    sin=_fm_fn("sin"), cos=_fm_fn("cos"), exp=_fm_fn("exp"), sqrt=_fm_fn("sqrt"),
    full=_fm_full, zero=_fm_zero,
)


def _lower(n: int):
    """The entries ``(i, j)``, ``j ≤ i``, of an n×n lower triangle, row by
    row: the order of the generated ``kmat``'s outputs."""
    return [(i, j) for i in range(n) for j in range(i + 1)]


def _prune(program: Program) -> Program:
    """Drop the operations no output depends on (a form built at ``make``
    time records work for the other forms too), renumbering the rest."""
    live = set(program.outputs)
    for i in range(len(program.ops) - 1, -1, -1):
        kind, op, args = program.ops[i]
        if i in live and op not in ("in", "tab", "lit", "zero"):
            live.update(args)
    remap, ops = {}, []
    for i, (kind, op, args) in enumerate(program.ops):
        if i not in live:
            continue
        if op not in ("in", "tab", "lit", "zero"):
            args = tuple(remap[a] for a in args)
        remap[i] = len(ops)
        ops.append((kind, op, args))
    return Program(program.form, ops, [remap[o] for o in program.outputs])


# ----------------------------------------------------------------------
# Tracing a family
# ----------------------------------------------------------------------


@dataclass(frozen=True)
class GeneratedFamily:
    """A family's generated programs: ``runtime`` with the table entries as
    member values (a run-time shared or per-member table), ``const`` with
    them as doubles (the shared constant table; None with the reason in
    ``const_error`` when the forms cannot run on constants), and the C++
    header text that holds both."""

    runtime: Dict[str, Program]
    const: Optional[Dict[str, Program]]
    const_error: Optional[str]
    header: str


def _trace_family(forms, const_table: bool) -> Dict[str, Program]:
    """Run each of the family's forms once on traced values."""
    n = forms.n
    lengths = tuple(forms.coef_lens)
    offsets = [sum(lengths[:t]) for t in range(len(lengths))]
    programs: Dict[str, Program] = {}

    def run(form, inputs, body):
        rec = _Recorder(forms.name, form, const_table)

        def accessor(t):
            def at(i):
                if not isinstance(i, int) or not 0 <= i < lengths[t]:
                    raise rec.fail(f"table {t} has no entry {i!r} (length {lengths[t]})")
                return rec.table(offsets[t] + i)

            return at

        groups = {name: [rec.value("T", "in", name, i) for i in range(count)]
                  for name, count in inputs}
        try:
            fam = forms.make(tuple(accessor(t) for t in range(len(lengths))), FM_TRACE)
            outs = body(fam, groups)
            rec.program.outputs = [rec.as_t(x) for x in outs]
            if form in ("aux", "aux_shift", "factor"):
                for k, x in enumerate(outs):
                    if not isinstance(x, _Value):
                        raise rec.fail(
                            f"entry {k} does not depend on the state (a Python number in "
                            f"the plain version); return it as fm.full(value, like)")
        except GenerationError:
            raise
        except Exception as exc:  # noqa: BLE001 - any failure of the forms on traced values
            raise rec.fail(f"{type(exc).__name__}: {exc}") from exc
        programs[form] = _prune(rec.program)
        return fam, len(outs)

    fam, n_aux = run("aux", (("q", n),), lambda fam, g: list(fam.aux(g["q"])))
    if fam.factor_solve is None:
        def kmat(fam, g):
            at_ = fam.k_at(g["a"], g["q"])
            return [at_(i, j) for i, j in _lower(n)]

        run("kmat", (("a", n_aux), ("q", n)), kmat)
        n_factor = 0
    else:
        _, n_factor = run("factor", (("a", n_aux), ("q", n)),
                          lambda fam, g: list(fam.factor_solve[0](g["a"], g["q"])))
        run("solve", (("f", n_factor), ("b", n)),
            lambda fam, g: list(fam.factor_solve[1](g["f"], g["b"])))
    run("dhdq", (("a", n_aux), ("q", n), ("w", n)),
        lambda fam, g: list(fam.dhdq(g["a"], g["q"], g["w"])))
    if fam.aux_shift is not None:
        run("aux_shift", (("a", n_aux), ("dq", n)),
            lambda fam, g: list(fam.aux_shift(g["a"], g["dq"])))
    for form, count in (("dhdq", n), ("solve", n), ("aux_shift", n_aux)):
        if form in programs and len(programs[form].outputs) != count:
            raise GenerationError(
                f"family {forms.name!r}, form {form}: {len(programs[form].outputs)} "
                f"outputs, expected {count}")
    return programs


def generate(forms) -> GeneratedFamily:
    """Trace ``forms`` with run-time and with constant table entries and
    print the header; raises :class:`GenerationError` when the run-time
    forms cannot be generated."""
    runtime = _trace_family(forms, const_table=False)
    try:
        const, const_error = _trace_family(forms, const_table=True), None
    except GenerationError as exc:
        const, const_error = None, str(exc)
    n_aux = len(runtime["aux"].outputs)
    n_factor = len(runtime["factor"].outputs) if "factor" in runtime else 0
    if const is not None and (len(const["aux"].outputs) != n_aux or set(const) != set(runtime)
                              or ("factor" in const and len(const["factor"].outputs) != n_factor)):
        raise GenerationError(f"family {forms.name!r}: the forms' structure differs between "
                              f"constant and run-time tables")
    length = sum(forms.coef_lens)
    text = header(forms.name, forms.n, n_aux, n_factor, length, runtime, const, const_error)
    return GeneratedFamily(runtime, const, const_error, text)


_GENERATED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def generated(forms) -> GeneratedFamily:
    """:func:`generate` once per forms object (a launch asks on every call)."""
    try:
        return _GENERATED[forms]
    except KeyError:
        gen = _GENERATED[forms] = generate(forms)
        return gen


# ----------------------------------------------------------------------
# The C++ header
# ----------------------------------------------------------------------

_CXX_BINARY = {"add": "+", "sub": "-", "mul": "*", "div": "/"}
# a pass's functions (csrc/fused_step.cuh); sin and cos go through one
# line_sincos, 1/x through line_rcp
_CXX_UNARY = {"exp": "dexp(v{})", "sqrt": "line_sqrt<STRAIGHT>(v{}, ok)", "abs": "dabs(v{})"}


def _is_one(program: Program, i: int) -> bool:
    """Whether value ``i`` is the literal 1 rounded to T (the numerator the
    recording gives ``c / x``)."""
    _, op, args = program.ops[i]
    return op == "cvt" and program.ops[args[0]][1:] == ("lit", (1.0,))


def _cxx_body(program: Program, out: str) -> List[str]:
    """The program as C++ statements of a pass, one an operation, in its
    order.  The sine and cosine of one value come from one ``line_sincos``,
    made where the first of them is; ``1 / x`` is ``line_rcp(x)``."""
    lines, pairs = [], set()
    for i, (kind, op, args) in enumerate(program.ops):
        ty = "T" if kind == "T" else "double"
        if op in ("sin", "cos"):
            x = args[0]
            if x not in pairs:
                pairs.add(x)
                lines.append(f"    T sin_v{x}, cos_v{x};")
                lines.append(f"    line_sincos<STRAIGHT>(v{x}, &sin_v{x}, &cos_v{x}, ok);")
            expr = f"{op}_v{x}"
        elif op == "in":
            expr = f"{args[0]}[{args[1]}]"
        elif op == "tab":
            expr = f"cf[{args[0]}]"
        elif op == "lit":
            expr = float(args[0]).hex()
        elif op == "zero":
            expr = "T(0)"
        elif op == "cvt":
            expr = f"static_cast<T>(v{args[0]})"
        elif op == "neg":
            expr = f"-v{args[0]}"
        elif op in _CXX_UNARY:
            expr = _CXX_UNARY[op].format(args[0])
        elif op == "divs":  # x / c on the card: x * (T(1) / T(c)), folded for a literal
            inv = (f"(T(1) / static_cast<T>(v{args[1]}))" if program.ops[args[1]][1] == "lit"
                   else f"line_rcp<STRAIGHT>(static_cast<T>(v{args[1]}), ok)")
            expr = f"v{args[0]} * {inv}"
        elif op == "div" and kind == "T" and _is_one(program, args[0]):
            expr = f"line_rcp<STRAIGHT>(v{args[1]}, ok)"
        else:
            expr = f"v{args[0]} {_CXX_BINARY[op]} v{args[1]}"
        lines.append(f"    const {ty} v{i} = {expr};")
    for k, o in enumerate(program.outputs):
        lines.append(f"    {out}[{k}] = v{o};")
    return lines


def _cxx_forms(programs: Dict[str, Program], n: int, n_aux: int, n_factor: int) -> List[str]:
    sa, sf = max(n_aux, 1), max(n_factor, 1)
    sig = {
        "aux": f"const C& cf, const T (&q)[{n}], T (&out)[{sa}]",
        "kmat": f"const C& cf, const T (&a)[{sa}], const T (&q)[{n}], T (&out)[{n * (n + 1) // 2}]",
        "factor": f"const C& cf, const T (&a)[{sa}], const T (&q)[{n}], T (&out)[{sf}]",
        "solve": f"const C& cf, const T (&f)[{sf}], const T (&b)[{n}], T (&out)[{n}]",
        "dhdq": f"const C& cf, const T (&a)[{sa}], const T (&q)[{n}], const T (&w)[{n}], "
                f"T (&out)[{n}]",
        "aux_shift": f"const C& cf, const T (&a)[{sa}], const T (&dq)[{n}], T (&out)[{sa}]",
    }
    lines = []
    for form in ("aux", "kmat", "factor", "solve", "dhdq", "aux_shift"):
        if form not in programs:
            continue
        lines.append("  template <bool STRAIGHT, class C>")
        lines.append(f"  static __device__ __forceinline__ void {form}({sig[form]}, bool* ok) {{")
        if not programs[form].reads_table():
            lines.append("    (void)cf;")
        lines += _cxx_body(programs[form], "out")
        lines.append("  }")
    return lines


def header(name, n, n_aux, n_factor, length, runtime, const, const_error) -> str:
    """The generated C++ header: ``UserForms<T, CONST_TABLE>``, the family's
    forms over a run-time table of T entries (``false``) and over the
    float64 constant table (``true``)."""
    dense = "factor" not in runtime
    lines = [
        f"// Generated from the FusedForms of family {name!r} by",
        "// hamilton_tpu_torch/ops/fused_codegen.py: each form's operations in the plain",
        "// version's order and rounding, one statement an operation.  Included by",
        "// csrc/user_family_step.cu.",
        "#pragma once",
        "",
        "namespace {",
        "",
        "template <typename T, bool CONST_TABLE>",
        "struct UserForms;",
    ]
    for const_table, programs in ((False, runtime), (True, const)):
        lines += ["", "template <typename T>",
                  f"struct UserForms<T, {'true' if const_table else 'false'}> {{"]
        lines.append(f"  static constexpr int N = {n}, NAUX = {n_aux}, NF = {n_factor}, "
                     f"L = {length};")
        if programs is None:
            reason = (const_error or "").replace("\n", " ")
            lines.append(f"  // not generated: {reason}")
            lines.append("  static constexpr bool kAvailable = false, kDense = true, "
                         "kShift = false;")
        else:
            lines.append(f"  static constexpr bool kAvailable = true, kDense = "
                         f"{'true' if dense else 'false'}, kShift = "
                         f"{'true' if 'aux_shift' in programs else 'false'};")
            lines += _cxx_forms(programs, n, n_aux, n_factor)
        lines.append("};")
    lines += ["", "}  // namespace", ""]
    return "\n".join(lines)
