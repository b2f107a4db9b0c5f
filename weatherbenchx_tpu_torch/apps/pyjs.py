"""Minimal Python→JavaScript transpiler for the scorecard logic.

The scorecard page needs its interaction math in JS, CI can only execute
Python, and the two must never drift. Rather than maintaining mirrored
sources (a shim-style weak link), the math is written ONCE in a restricted
Python subset (:mod:`scorecard_logic`) and the page's JS is GENERATED from
the Python AST at render time — divergence is structurally impossible, and
the unit tests exercising the Python functions therefore cover the shipped
JS line for line.

A copy of the JAX package's ``apps/pyjs.py`` (pure Python), which the port
cannot import: that package's ``__init__`` imports jax.

Supported subset (enforced — anything else raises ``TranspileError``):

* functions of positional args; ``if``/``elif``/``else``; ``return``;
  ``for i in range(len(x))`` / ``for i in range(a, b)``; assignments;
  ``continue``; list literals / ``append``;
* expressions: arithmetic (``/`` is float division, as in JS), comparisons
  (chained comparisons excluded), ``and``/``or``/``not``, ``in`` on
  list/str constants (→ ``includes``), ``is None`` (→ ``=== null``),
  conditional expressions, f-strings (→ template literals);
* calls: ``len``, ``str.lower()``, ``list.append``, ``d_get(d, k)`` (a
  null-safe dict lookup helper, emitted as JS), slicing ``x[a:]``/
  ``x[a:b]`` (→ ``slice``);
* constants injected by name (lists/dicts/strings/numbers) as JS consts.

Deliberate semantic constraints on the source subset (checked in review,
exercised by the golden tests): no dict/list truthiness (compare to
``None``/use ``len()``), no negative indexing, no integer division.
"""

from __future__ import annotations

import ast
import inspect
import json
import textwrap
from typing import Callable, Mapping, Sequence


class TranspileError(NotImplementedError):
  pass


_BINOPS = {ast.Add: '+', ast.Sub: '-', ast.Mult: '*', ast.Div: '/',
           ast.Mod: '%'}
# Python identifiers that are reserved words (or hazardous globals) in JS.
_JS_RESERVED = frozenset((
    'new delete typeof instanceof in of var let const function class this '
    'super void with do switch case default export import extends yield '
    'await enum static package private protected public interface '
    'implements arguments eval null true false undefined window document'
).split())
_CMPOPS = {ast.Eq: '===', ast.NotEq: '!==', ast.Lt: '<', ast.LtE: '<=',
           ast.Gt: '>', ast.GtE: '>='}

# Null-safe dict lookup: Python `d.get(k)` ≡ JS d_get(d, k) under the
# "no meaningful null values in maps" constraint the logic observes.
D_GET_JS = (
    'function d_get(d, k) {\n'
    '  if (d === null || d === undefined) return null;\n'
    '  const v = d[k];\n'
    '  return v === undefined ? null : v;\n'
    '}\n')


def _snake_to_camel(name: str) -> str:
  head, *rest = name.split('_')
  return head + ''.join(w.capitalize() for w in rest)


class _Fn(ast.NodeVisitor):
  """Emits JS for one function body."""

  def __init__(self, const_names, fn_names):
    self.const_names = const_names
    self.fn_names = fn_names
    self.lines: list[str] = []
    self.indent = 1
    self.declared: set[str] = set()

  # -- helpers ---------------------------------------------------------------

  def emit(self, line: str) -> None:
    self.lines.append('  ' * self.indent + line)

  def fail(self, node, why: str):
    raise TranspileError(
        f'{why} (line {getattr(node, "lineno", "?")}: '
        f'{ast.dump(node)[:120]})')

  # -- expressions -----------------------------------------------------------

  def expr(self, node) -> str:
    if isinstance(node, ast.Constant):
      if node.value is None:
        return 'null'
      if node.value is True:
        return 'true'
      if node.value is False:
        return 'false'
      return json.dumps(node.value)
    if isinstance(node, ast.Name):
      if node.id in self.fn_names:
        return self.fn_names[node.id]
      if node.id in _JS_RESERVED:
        self.fail(node, f'identifier {node.id!r} is reserved in JS')
      return node.id
    if isinstance(node, ast.BinOp):
      op = _BINOPS.get(type(node.op))
      if op is None:
        self.fail(node, f'unsupported operator {type(node.op).__name__}')
      return f'({self.expr(node.left)} {op} {self.expr(node.right)})'
    if isinstance(node, ast.UnaryOp):
      if isinstance(node.op, ast.Not):
        return f'(!{self.expr(node.operand)})'
      if isinstance(node.op, ast.USub):
        return f'(-{self.expr(node.operand)})'
      self.fail(node, 'unsupported unary op')
    if isinstance(node, ast.BoolOp):
      op = ' && ' if isinstance(node.op, ast.And) else ' || '
      return '(' + op.join(self.expr(v) for v in node.values) + ')'
    if isinstance(node, ast.Compare):
      if len(node.ops) != 1:
        self.fail(node, 'chained comparisons unsupported')
      left, op, right = node.left, node.ops[0], node.comparators[0]
      if isinstance(op, (ast.Is, ast.IsNot)):
        if not (isinstance(right, ast.Constant) and right.value is None):
          self.fail(node, 'is/is not only against None')
        js_op = '===' if isinstance(op, ast.Is) else '!=='
        return f'({self.expr(left)} {js_op} null)'
      if isinstance(op, (ast.In, ast.NotIn)):
        test = f'{self.expr(right)}.includes({self.expr(left)})'
        return f'(!{test})' if isinstance(op, ast.NotIn) else f'({test})'
      js_op = _CMPOPS.get(type(op))
      if js_op is None:
        self.fail(node, f'unsupported comparison {type(op).__name__}')
      return f'({self.expr(left)} {js_op} {self.expr(right)})'
    if isinstance(node, ast.IfExp):
      return (f'({self.expr(node.test)} ? {self.expr(node.body)} : '
              f'{self.expr(node.orelse)})')
    if isinstance(node, ast.Call):
      return self.call(node)
    if isinstance(node, ast.Subscript):
      if isinstance(node.slice, ast.Slice):
        if node.slice.step is not None:
          self.fail(node, 'slice step unsupported')
        lo = self.expr(node.slice.lower) if node.slice.lower else '0'
        if node.slice.upper is None:
          return f'{self.expr(node.value)}.slice({lo})'
        return (f'{self.expr(node.value)}.slice({lo}, '
                f'{self.expr(node.slice.upper)})')
      return f'{self.expr(node.value)}[{self.expr(node.slice)}]'
    if isinstance(node, ast.List):
      return '[' + ', '.join(self.expr(e) for e in node.elts) + ']'
    if isinstance(node, ast.JoinedStr):
      parts = []
      for v in node.values:
        if isinstance(v, ast.Constant):
          parts.append(str(v.value).replace('`', r'\`')
                       .replace('$', r'\$'))
        elif isinstance(v, ast.FormattedValue):
          parts.append('${' + self.expr(v.value) + '}')
        else:
          self.fail(node, 'unsupported f-string part')
      return '`' + ''.join(parts) + '`'
    if isinstance(node, ast.Attribute):
      self.fail(node, 'bare attribute access unsupported')
    self.fail(node, f'unsupported expression {type(node).__name__}')

  def call(self, node: ast.Call) -> str:
    if node.keywords:
      self.fail(node, 'keyword arguments unsupported')
    args = [self.expr(a) for a in node.args]
    if isinstance(node.func, ast.Name):
      name = node.func.id
      if name == 'len':
        return f'{args[0]}.length'
      if name == 'd_get':
        return f'd_get({args[0]}, {args[1]})'
      if name == 'str':
        return f'String({args[0]})'
      if name in self.fn_names:
        return f'{self.fn_names[name]}({", ".join(args)})'
      self.fail(node, f'unsupported call {name}')
    if isinstance(node.func, ast.Attribute):
      obj = self.expr(node.func.value)
      meth = node.func.attr
      if meth == 'lower':
        return f'{obj}.toLowerCase()'
      if meth == 'append':
        return f'{obj}.push({", ".join(args)})'
      self.fail(node, f'unsupported method {meth}')
    self.fail(node, 'unsupported call form')

  # -- statements ------------------------------------------------------------

  def statement(self, node) -> None:
    if isinstance(node, ast.Return):
      self.emit(f'return {self.expr(node.value) if node.value else ""};')
    elif isinstance(node, ast.If):
      self.emit(f'if ({self.expr(node.test)}) {{')
      self.indent += 1
      for s in node.body:
        self.statement(s)
      self.indent -= 1
      if node.orelse:
        self.emit('} else {')
        self.indent += 1
        for s in node.orelse:
          self.statement(s)
        self.indent -= 1
      self.emit('}')
    elif isinstance(node, ast.Assign):
      if len(node.targets) != 1 or not isinstance(node.targets[0], ast.Name):
        self.fail(node, 'only simple name assignments')
      name = node.targets[0].id
      if name in _JS_RESERVED:
        self.fail(node, f'identifier {name!r} is reserved in JS')
      kw = '' if name in self.declared else 'let '
      self.declared.add(name)
      self.emit(f'{kw}{name} = {self.expr(node.value)};')
    elif isinstance(node, ast.AugAssign):
      if not isinstance(node.target, ast.Name):
        self.fail(node, 'only simple augmented assignments')
      op = _BINOPS.get(type(node.op))
      if op is None:
        self.fail(node, 'unsupported augmented op')
      self.emit(f'{node.target.id} {op}= {self.expr(node.value)};')
    elif isinstance(node, ast.For):
      if not (isinstance(node.iter, ast.Call)
              and isinstance(node.iter.func, ast.Name)
              and node.iter.func.id == 'range'
              and isinstance(node.target, ast.Name)):
        self.fail(node, 'only for-over-range loops')
      r = node.iter.args
      lo, hi = ('0', self.expr(r[0])) if len(r) == 1 else (
          self.expr(r[0]), self.expr(r[1]))
      i = node.target.id
      self.emit(f'for (let {i} = {lo}; {i} < {hi}; {i}++) {{')
      self.indent += 1
      for s in node.body:
        self.statement(s)
      self.indent -= 1
      self.emit('}')
    elif isinstance(node, ast.Continue):
      self.emit('continue;')
    elif isinstance(node, ast.Expr):
      self.emit(f'{self.expr(node.value)};')
    else:
      self.fail(node, f'unsupported statement {type(node).__name__}')


def transpile(functions: Sequence[Callable], *,
              consts: Mapping[str, object] = (),
              prefix: str = 'sl_') -> str:
  """Transpiles the given Python functions (+ constants) to a JS snippet.

  Function names map ``snake_case`` → ``<prefix>camelCase``; calls between
  the given functions are rewired to the JS names.
  """
  consts = dict(consts or {})
  fn_names = {f.__name__: prefix + _snake_to_camel(f.__name__)
              for f in functions}
  out = [D_GET_JS]
  for cname, cval in consts.items():
    if isinstance(cval, (frozenset, set)):
      cval = sorted(cval)
    out.append(f'const {cname} = {json.dumps(cval)};\n')
  for f in functions:
    tree = ast.parse(textwrap.dedent(inspect.getsource(f)))
    fdef = tree.body[0]
    if not isinstance(fdef, ast.FunctionDef):
      raise TranspileError(f'{f.__name__}: not a plain function')
    if (fdef.args.kwonlyargs or fdef.args.vararg or fdef.args.kwarg
        or fdef.args.defaults):
      raise TranspileError(f'{f.__name__}: only plain positional args')
    emitter = _Fn(set(consts), fn_names)
    emitter.declared.update(a.arg for a in fdef.args.args)
    body = fdef.body
    if (body and isinstance(body[0], ast.Expr)
        and isinstance(body[0].value, ast.Constant)
        and isinstance(body[0].value.value, str)):
      body = body[1:]  # drop docstring
    for s in body:
      emitter.statement(s)
    args = ', '.join(a.arg for a in fdef.args.args)
    out.append(f'function {fn_names[f.__name__]}({args}) {{\n'
               + '\n'.join(emitter.lines) + '\n}\n')
  return '\n'.join(out)
