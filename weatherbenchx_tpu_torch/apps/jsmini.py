"""Interpreter for the pyjs-emitted JavaScript subset.

The scorecard page ships JS generated by :mod:`pyjs` from the unit-tested
Python in :mod:`scorecard_logic`. Every hop in that chain is executed in
CI except one: the generated JS *text* itself — no JS engine is assumed
in the test environment, so a codegen bug
(wrong operator mapping, broken template literal escaping, bad slice
emission) would ship and only surface as a red on-load banner in a user's
browser.

This module closes that hop: a small tree-walking interpreter for exactly
the closed grammar ``pyjs.transpile`` emits (plus ``pyjs.D_GET_JS``),
implementing **JavaScript semantics, not Python semantics** — IEEE-double
arithmetic with JS ``%`` (sign of the dividend) and division by zero →
``Infinity``, ``+`` string concatenation with JS ``ToString`` (``String(1.0)
=== "1"``), strict ``===`` across types, JS truthiness for ``&&``/``||``/
``!``, ``undefined`` distinct from ``null``, out-of-range indexing →
``undefined``, and JS ``Array.prototype.slice`` clamping. Anything outside
the emitted grammar is a parse error, so if :mod:`pyjs` grows new syntax
this interpreter fails loudly instead of silently mis-executing.

CI (``tests/test_torch_scorecard.py``) parses the *rendered page's* ``<script>``,
extracts the generated logic segment, executes the embedded golden
fixtures against it through this interpreter, and asserts the pass-banner
verdict — the same check the browser performs on load
(``scorecard_logic.SELFTEST_RUNNER_JS``).

No reference counterpart (the reference ships hand-written Dash/JS,
``public_benchmark/apps/dash_app.py:272-436``); this exists because the
repo generates its JS from Python and must prove the generator. A copy of
the JAX package's ``apps/jsmini.py`` (pure Python, which the port cannot
import: that package's ``__init__`` imports jax).
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Optional


class JSError(Exception):
  pass


class _Undefined:
  _instance: Optional['_Undefined'] = None

  def __new__(cls):
    if cls._instance is None:
      cls._instance = super().__new__(cls)
    return cls._instance

  def __repr__(self):
    return 'undefined'


undefined = _Undefined()


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_PUNCT = ('===', '!==', '<=', '>=', '&&', '||', '++', '+=', '-=', '*=',
          '/=', '%=', '(', ')', '{', '}', '[', ']', ',', ';', '.', ':',
          '?', '<', '>', '+', '-', '*', '/', '%', '=', '!')
_IDENT_RE = re.compile(r'[A-Za-z_$][A-Za-z0-9_$]*')
_NUM_RE = re.compile(r'(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?')


class _Tok:
  __slots__ = ('kind', 'value', 'pos')

  def __init__(self, kind, value, pos):
    self.kind, self.value, self.pos = kind, value, pos

  def __repr__(self):
    return f'{self.kind}:{self.value!r}'


def _tokenize(src: str) -> list:
  toks = []
  i, n = 0, len(src)
  while i < n:
    c = src[i]
    if c in ' \t\r\n':
      i += 1
      continue
    if src.startswith('//', i):
      j = src.find('\n', i)
      i = n if j < 0 else j + 1
      continue
    if src.startswith('/*', i):
      j = src.find('*/', i)
      if j < 0:
        raise JSError(f'unterminated block comment at {i}')
      i = j + 2
      continue
    if c == '"' or c == "'":
      j, out = i + 1, []
      while j < n and src[j] != c:
        if src[j] == '\\':
          esc = src[j + 1]
          out.append({'n': '\n', 't': '\t', 'r': '\r', 'b': '\b',
                      'f': '\f', '0': '\0'}.get(esc, esc)
                     if esc != 'u' else chr(int(src[j + 2:j + 6], 16)))
          j += 6 if esc == 'u' else 2
        else:
          out.append(src[j])
          j += 1
      if j >= n:
        raise JSError(f'unterminated string at {i}')
      toks.append(_Tok('str', ''.join(out), i))
      i = j + 1
      continue
    if c == '`':
      # Template literal: lex into alternating (text, expr-source) parts.
      parts, buf = [], []
      j = i + 1
      while j < n and src[j] != '`':
        if src[j] == '\\':
          buf.append(src[j + 1])
          j += 2
        elif src.startswith('${', j):
          parts.append(('text', ''.join(buf)))
          buf = []
          depth, k = 1, j + 2
          while k < n and depth:
            if src[k] in '"\'':
              q = src[k]
              k += 1
              while k < n and src[k] != q:
                k += 2 if src[k] == '\\' else 1
              k += 1
              continue
            if src[k] == '{':
              depth += 1
            elif src[k] == '}':
              depth -= 1
              if not depth:
                break
            k += 1
          if depth:
            raise JSError(f'unterminated ${{ }} at {j}')
          parts.append(('expr', src[j + 2:k]))
          j = k + 1
        else:
          buf.append(src[j])
          j += 1
      if j >= n:
        raise JSError(f'unterminated template literal at {i}')
      parts.append(('text', ''.join(buf)))
      toks.append(_Tok('template', parts, i))
      i = j + 1
      continue
    m = _NUM_RE.match(src, i)
    if m and c.isdigit() or (c == '.' and i + 1 < n and src[i + 1].isdigit()):
      m = _NUM_RE.match(src, i)
      toks.append(_Tok('num', float(m.group()), i))
      i = m.end()
      continue
    m = _IDENT_RE.match(src, i)
    if m:
      toks.append(_Tok('ident', m.group(), i))
      i = m.end()
      continue
    for p in _PUNCT:
      if src.startswith(p, i):
        toks.append(_Tok('punct', p, i))
        i += len(p)
        break
    else:
      raise JSError(f'unexpected character {c!r} at {i}')
  toks.append(_Tok('eof', None, n))
  return toks


# ---------------------------------------------------------------------------
# Parser (recursive descent over the emitted grammar)
# ---------------------------------------------------------------------------


class _Parser:
  def __init__(self, src: str):
    self.toks = _tokenize(src)
    self.i = 0

  def peek(self, k=0) -> _Tok:
    return self.toks[min(self.i + k, len(self.toks) - 1)]

  def next(self) -> _Tok:
    t = self.toks[self.i]
    self.i += 1
    return t

  def expect(self, kind, value=None) -> _Tok:
    t = self.next()
    if t.kind != kind or (value is not None and t.value != value):
      raise JSError(f'expected {value or kind}, got {t} at {t.pos}')
    return t

  def at(self, kind, value=None) -> bool:
    t = self.peek()
    return t.kind == kind and (value is None or t.value == value)

  # -- program ---------------------------------------------------------------

  def parse_program(self) -> list:
    stmts = []
    while not self.at('eof'):
      stmts.append(self.statement())
    return stmts

  # -- statements ------------------------------------------------------------

  def statement(self):
    t = self.peek()
    if t.kind == 'ident':
      kw = t.value
      if kw == 'function':
        return self.function_decl()
      if kw in ('let', 'const'):
        self.next()
        name = self.expect('ident').value
        self.expect('punct', '=')
        val = self.expr()
        self.expect('punct', ';')
        return ('decl', name, val)
      if kw == 'return':
        self.next()
        if self.at('punct', ';'):
          self.next()
          return ('return', None)
        val = self.expr()
        self.expect('punct', ';')
        return ('return', val)
      if kw == 'if':
        return self.if_stmt()
      if kw == 'for':
        return self.for_stmt()
      if kw == 'continue':
        self.next()
        self.expect('punct', ';')
        return ('continue',)
      if kw == 'break':
        self.next()
        self.expect('punct', ';')
        return ('break',)
    # assignment or expression statement
    e = self.expr()
    if self.at('punct', '='):
      self.next()
      rhs = self.expr()
      self.expect('punct', ';')
      if e[0] != 'name':
        raise JSError('only simple-name assignment targets are emitted')
      return ('assign', e[1], rhs)
    for op in ('+=', '-=', '*=', '/=', '%='):
      if self.at('punct', op):
        self.next()
        rhs = self.expr()
        self.expect('punct', ';')
        if e[0] != 'name':
          raise JSError('only simple-name augmented targets are emitted')
        return ('augassign', e[1], op[0], rhs)
    self.expect('punct', ';')
    return ('expr', e)

  def function_decl(self):
    self.expect('ident', 'function')
    name = self.expect('ident').value
    self.expect('punct', '(')
    params = []
    while not self.at('punct', ')'):
      params.append(self.expect('ident').value)
      if self.at('punct', ','):
        self.next()
    self.expect('punct', ')')
    body = self.block()
    return ('function', name, params, body)

  def block(self) -> list:
    self.expect('punct', '{')
    stmts = []
    while not self.at('punct', '}'):
      stmts.append(self.statement())
    self.expect('punct', '}')
    return stmts

  def block_or_single(self) -> list:
    if self.at('punct', '{'):
      return self.block()
    return [self.statement()]  # D_GET_JS uses brace-less single-stmt ifs

  def if_stmt(self):
    self.expect('ident', 'if')
    self.expect('punct', '(')
    test = self.expr()
    self.expect('punct', ')')
    body = self.block_or_single()
    orelse = []
    if self.at('ident', 'else'):
      self.next()
      if self.at('ident', 'if'):
        orelse = [self.if_stmt()]
      else:
        orelse = self.block_or_single()
    return ('if', test, body, orelse)

  def for_stmt(self):
    # Exactly the emitted form: for (let i = LO; i < HI; i++) { ... }
    self.expect('ident', 'for')
    self.expect('punct', '(')
    self.expect('ident', 'let')
    var = self.expect('ident').value
    self.expect('punct', '=')
    lo = self.expr()
    self.expect('punct', ';')
    cond_var = self.expect('ident').value
    if cond_var != var:
      raise JSError('for-loop condition variable mismatch')
    self.expect('punct', '<')
    hi = self.expr()
    self.expect('punct', ';')
    inc_var = self.expect('ident').value
    if inc_var != var:
      raise JSError('for-loop increment variable mismatch')
    self.expect('punct', '++')
    self.expect('punct', ')')
    body = self.block_or_single()
    return ('for', var, lo, hi, body)

  # -- expressions (precedence climbing) ---------------------------------------

  def expr(self):
    return self.ternary()

  def ternary(self):
    test = self.logical_or()
    if self.at('punct', '?'):
      self.next()
      a = self.expr()
      self.expect('punct', ':')
      b = self.expr()
      return ('ternary', test, a, b)
    return test

  def logical_or(self):
    e = self.logical_and()
    while self.at('punct', '||'):
      self.next()
      e = ('or', e, self.logical_and())
    return e

  def logical_and(self):
    e = self.equality()
    while self.at('punct', '&&'):
      self.next()
      e = ('and', e, self.equality())
    return e

  def equality(self):
    e = self.relational()
    while self.at('punct', '===') or self.at('punct', '!=='):
      op = self.next().value
      e = ('binop', op, e, self.relational())
    return e

  def relational(self):
    e = self.additive()
    while (self.at('punct', '<') or self.at('punct', '<=')
           or self.at('punct', '>') or self.at('punct', '>=')):
      op = self.next().value
      e = ('binop', op, e, self.additive())
    return e

  def additive(self):
    e = self.multiplicative()
    while self.at('punct', '+') or self.at('punct', '-'):
      op = self.next().value
      e = ('binop', op, e, self.multiplicative())
    return e

  def multiplicative(self):
    e = self.unary()
    while (self.at('punct', '*') or self.at('punct', '/')
           or self.at('punct', '%')):
      op = self.next().value
      e = ('binop', op, e, self.unary())
    return e

  def unary(self):
    if self.at('punct', '!'):
      self.next()
      return ('not', self.unary())
    if self.at('punct', '-'):
      self.next()
      return ('neg', self.unary())
    return self.postfix()

  def postfix(self):
    e = self.primary()
    while True:
      if self.at('punct', '.'):
        self.next()
        name = self.expect('ident').value
        e = ('member', e, name)
      elif self.at('punct', '['):
        self.next()
        idx = self.expr()
        self.expect('punct', ']')
        e = ('index', e, idx)
      elif self.at('punct', '('):
        self.next()
        args = []
        while not self.at('punct', ')'):
          args.append(self.expr())
          if self.at('punct', ','):
            self.next()
        self.expect('punct', ')')
        e = ('call', e, args)
      else:
        return e

  def primary(self):
    t = self.peek()
    if t.kind == 'num':
      self.next()
      return ('const', t.value)
    if t.kind == 'str':
      self.next()
      return ('const', t.value)
    if t.kind == 'template':
      self.next()
      parts = []
      for kind, payload in t.value:
        if kind == 'text':
          parts.append(('text', payload))
        else:
          parts.append(('expr', _Parser(payload).expr_only()))
      return ('template', parts)
    if t.kind == 'ident':
      self.next()
      if t.value == 'null':
        return ('const', None)
      if t.value == 'undefined':
        return ('const', undefined)
      if t.value == 'true':
        return ('const', True)
      if t.value == 'false':
        return ('const', False)
      return ('name', t.value)
    if t.kind == 'punct' and t.value == '(':
      self.next()
      e = self.expr()
      self.expect('punct', ')')
      return e
    if t.kind == 'punct' and t.value == '[':
      self.next()
      elts = []
      while not self.at('punct', ']'):
        elts.append(self.expr())
        if self.at('punct', ','):
          self.next()
      self.expect('punct', ']')
      return ('array', elts)
    if t.kind == 'punct' and t.value == '{':
      # JSON-style object literal (emitted consts only): string keys.
      self.next()
      pairs = []
      while not self.at('punct', '}'):
        k = self.next()
        if k.kind not in ('str', 'ident'):
          raise JSError(f'object key must be string/ident, got {k}')
        self.expect('punct', ':')
        pairs.append((k.value, self.expr()))
        if self.at('punct', ','):
          self.next()
      self.expect('punct', '}')
      return ('object', pairs)
    raise JSError(f'unexpected token {t} at {t.pos}')

  def expr_only(self):
    e = self.expr()
    if not self.at('eof'):
      raise JSError(f'trailing tokens after expression: {self.peek()}')
    return e


# ---------------------------------------------------------------------------
# Evaluator — JS semantics
# ---------------------------------------------------------------------------


def _truthy(v) -> bool:
  if v is None or v is undefined or v is False:
    return False
  if v is True:
    return True
  if isinstance(v, float):
    return not (v == 0.0 or math.isnan(v))
  if isinstance(v, str):
    return len(v) > 0
  return True  # objects/arrays are always truthy


def _to_number(v) -> float:
  if isinstance(v, bool):
    return 1.0 if v else 0.0
  if isinstance(v, float):
    return v
  if v is None:
    return 0.0
  if v is undefined:
    return math.nan
  if isinstance(v, str):
    s = v.strip()
    if not s:
      return 0.0
    try:
      return float(s)
    except ValueError:
      return math.nan
  return math.nan


def to_string(v) -> str:
  """JS ToString: integral doubles print without a decimal point."""
  if v is None:
    return 'null'
  if v is undefined:
    return 'undefined'
  if v is True:
    return 'true'
  if v is False:
    return 'false'
  if isinstance(v, float):
    if math.isnan(v):
      return 'NaN'
    if math.isinf(v):
      return 'Infinity' if v > 0 else '-Infinity'
    if v == int(v) and abs(v) < 1e21:
      return str(int(v))
    return repr(v)
  if isinstance(v, str):
    return v
  if isinstance(v, list):
    return ','.join('' if x is None or x is undefined else to_string(x)
                    for x in v)
  return str(v)


def _strict_eq(a, b) -> bool:
  if a is undefined or b is undefined:
    return a is b
  if a is None or b is None:
    return a is b
  if isinstance(a, bool) or isinstance(b, bool):
    return isinstance(a, bool) and isinstance(b, bool) and a == b
  if isinstance(a, float) and isinstance(b, float):
    return a == b  # NaN !== NaN falls out naturally
  if isinstance(a, str) and isinstance(b, str):
    return a == b
  return a is b  # objects/arrays compare by identity in JS


def _js_div(a: float, b: float) -> float:
  if b == 0.0:
    if a == 0.0 or math.isnan(a):
      return math.nan
    return math.copysign(math.inf, math.copysign(1.0, a) *
                          math.copysign(1.0, b))
  return a / b


def _js_mod(a: float, b: float) -> float:
  if b == 0.0 or math.isnan(a) or math.isnan(b) or math.isinf(a):
    return math.nan
  if math.isinf(b):
    return a
  return math.fmod(a, b)  # sign of the dividend, as in JS


class _Return(Exception):
  def __init__(self, value):
    self.value = value


class _Continue(Exception):
  pass


class _Break(Exception):
  pass


class _Function:
  def __init__(self, name, params, body, interp):
    self.name, self.params, self.body, self.interp = name, params, body, interp

  def __call__(self, *args):
    scope = dict(zip(self.params, args))
    for p in self.params[len(args):]:
      scope[p] = undefined
    try:
      for s in self.body:
        self.interp.exec_stmt(s, scope)
    except _Return as r:
      return r.value
    return undefined


class Interpreter:
  """Executes a program in the pyjs-emitted subset.

  ``run(src)`` executes top-level statements (function declarations and
  const bindings); ``call(name, *args)`` invokes a defined function with
  Python values (``None`` ↔ ``null``; ints are promoted to JS doubles;
  dicts/lists pass through by reference and MUST NOT be mutated by the
  logic — the emitted subset never mutates its inputs).
  """

  def __init__(self):
    self.globals: dict = {'String': to_string}

  # -- public API --------------------------------------------------------------

  def run(self, src: str) -> 'Interpreter':
    for stmt in _Parser(src).parse_program():
      self.exec_stmt(stmt, self.globals)
    return self

  def call(self, name: str, *args) -> Any:
    fn = self.globals.get(name)
    if not callable(fn):
      raise JSError(f'no function named {name!r}')
    return fn(*[_from_python(a) for a in args])

  # -- statements ---------------------------------------------------------------

  def exec_stmt(self, stmt, scope) -> None:
    op = stmt[0]
    if op == 'function':
      _, name, params, body = stmt
      scope[name] = _Function(name, params, body, self)
    elif op == 'decl' or op == 'assign':
      name, val = stmt[1], self.eval(stmt[2], scope)
      if op == 'assign' and name not in scope and name not in self.globals:
        raise JSError(f'assignment to undeclared variable {name!r}')
      (scope if (op == 'decl' or name in scope) else self.globals)[name] = val
    elif op == 'augassign':
      _, name, sym, rhs = stmt
      env = scope if name in scope else self.globals
      if name not in env:
        raise JSError(f'augmented assignment to undeclared {name!r}')
      env[name] = self._binop(sym, env[name], self.eval(rhs, scope))
    elif op == 'return':
      raise _Return(undefined if stmt[1] is None
                    else self.eval(stmt[1], scope))
    elif op == 'if':
      _, test, body, orelse = stmt
      for s in body if _truthy(self.eval(test, scope)) else orelse:
        self.exec_stmt(s, scope)
    elif op == 'for':
      _, var, lo, hi, body = stmt
      i = _to_number(self.eval(lo, scope))
      while True:
        scope[var] = i
        if not i < _to_number(self.eval(hi, scope)):
          break
        try:
          for s in body:
            self.exec_stmt(s, scope)
        except _Continue:
          pass
        except _Break:
          break
        i = scope[var] + 1.0
    elif op == 'continue':
      raise _Continue()
    elif op == 'break':
      raise _Break()
    elif op == 'expr':
      self.eval(stmt[1], scope)
    else:
      raise JSError(f'unknown statement {op}')

  # -- expressions ----------------------------------------------------------------

  def eval(self, node, scope) -> Any:
    op = node[0]
    if op == 'const':
      v = node[1]
      return float(v) if isinstance(v, (int, float)) \
          and not isinstance(v, bool) else v
    if op == 'name':
      name = node[1]
      if name in scope:
        return scope[name]
      if name in self.globals:
        return self.globals[name]
      raise JSError(f'undefined variable {name!r}')
    if op == 'array':
      return [self.eval(e, scope) for e in node[1]]
    if op == 'object':
      return {k: self.eval(v, scope) for k, v in node[1]}
    if op == 'template':
      out = []
      for kind, payload in node[1]:
        out.append(payload if kind == 'text'
                   else to_string(self.eval(payload, scope)))
      return ''.join(out)
    if op == 'ternary':
      _, test, a, b = node
      return self.eval(a if _truthy(self.eval(test, scope)) else b, scope)
    if op == 'and':
      left = self.eval(node[1], scope)
      return self.eval(node[2], scope) if _truthy(left) else left
    if op == 'or':
      left = self.eval(node[1], scope)
      return left if _truthy(left) else self.eval(node[2], scope)
    if op == 'not':
      return not _truthy(self.eval(node[1], scope))
    if op == 'neg':
      return -_to_number(self.eval(node[1], scope))
    if op == 'binop':
      return self._binop(node[1], self.eval(node[2], scope),
                         self.eval(node[3], scope))
    if op == 'index':
      obj = self.eval(node[1], scope)
      key = self.eval(node[2], scope)
      return self._get(obj, key)
    if op == 'member':
      obj = self.eval(node[1], scope)
      return self._get(obj, node[2])
    if op == 'call':
      callee = node[1]
      args = [self.eval(a, scope) for a in node[2]]
      if callee[0] == 'member':
        return self._method(self.eval(callee[1], scope), callee[2], args)
      fn = self.eval(callee, scope)
      if not callable(fn):
        raise JSError(f'{callee} is not a function')
      return fn(*args)
    raise JSError(f'unknown expression {op}')

  # -- semantics helpers -------------------------------------------------------------

  def _binop(self, sym, a, b):
    if sym == '+':
      if isinstance(a, str) or isinstance(b, str) \
          or isinstance(a, (list, dict)) or isinstance(b, (list, dict)):
        return to_string(a) + to_string(b)
      return _to_number(a) + _to_number(b)
    if sym == '-':
      return _to_number(a) - _to_number(b)
    if sym == '*':
      return _to_number(a) * _to_number(b)
    if sym == '/':
      return _js_div(_to_number(a), _to_number(b))
    if sym == '%':
      return _js_mod(_to_number(a), _to_number(b))
    if sym == '===':
      return _strict_eq(a, b)
    if sym == '!==':
      return not _strict_eq(a, b)
    if sym in ('<', '<=', '>', '>='):
      if isinstance(a, str) and isinstance(b, str):
        x, y = a, b
      else:
        x, y = _to_number(a), _to_number(b)
        if math.isnan(x) or math.isnan(y):
          return False
      return {'<': x < y, '<=': x <= y, '>': x > y, '>=': x >= y}[sym]
    raise JSError(f'unknown operator {sym}')

  def _get(self, obj, key):
    if obj is None or obj is undefined:
      raise JSError(f'cannot read properties of {to_string(obj)} '
                    f'(reading {key!r})')
    if isinstance(obj, dict):
      k = key if isinstance(key, str) else to_string(key)
      return obj[k] if k in obj else undefined
    if isinstance(obj, (list, str)):
      if isinstance(key, str) and key == 'length':
        return float(len(obj))
      idx = _to_number(key)
      if not math.isnan(idx) and idx == int(idx) and 0 <= idx < len(obj):
        return obj[int(idx)]
      return undefined
    raise JSError(f'cannot index {type(obj).__name__}')

  def _method(self, obj, name, args):
    if isinstance(obj, list):
      if name == 'push':
        obj.extend(args)
        return float(len(obj))
      if name == 'slice':
        return obj[_slice_range(args, len(obj))]
      if name == 'includes':
        needle = args[0] if args else undefined
        for x in obj:
          if _strict_eq(x, needle) or (
              isinstance(x, float) and isinstance(needle, float)
              and math.isnan(x) and math.isnan(needle)):  # SameValueZero
            return True
        return False
      if name == 'join':
        sep = to_string(args[0]) if args else ','
        return sep.join('' if x is None or x is undefined else to_string(x)
                        for x in obj)
    if isinstance(obj, str):
      if name == 'toLowerCase':
        return obj.lower()
      if name == 'includes':
        return isinstance(args[0], str) and args[0] in obj
      if name == 'slice':
        return obj[_slice_range(args, len(obj))]
    raise JSError(f'unsupported method .{name} on {type(obj).__name__}')


def _slice_range(args, n: int) -> slice:
  def clamp(v, dflt):
    if v is undefined or v is None:
      return dflt
    v = int(_to_number(v))
    return max(v + n, 0) if v < 0 else min(v, n)
  lo = clamp(args[0] if args else undefined, 0)
  hi = clamp(args[1] if len(args) > 1 else undefined, n)
  return slice(lo, max(lo, hi))


def _from_python(v):
  """Python test values → JS values (ints become doubles, recursively)."""
  if isinstance(v, bool) or v is None or v is undefined:
    return v
  if isinstance(v, (int, float)):
    return float(v)
  if isinstance(v, str):
    return v
  if isinstance(v, (list, tuple)):
    return [_from_python(x) for x in v]
  if isinstance(v, dict):
    return {str(k): _from_python(x) for k, x in v.items()}
  raise JSError(f'cannot marshal {type(v).__name__} into JS')


# ---------------------------------------------------------------------------
# Self-test harness mirroring SELFTEST_RUNNER_JS / the page banner logic
# ---------------------------------------------------------------------------


def deep_near(a, b) -> bool:
  """Mirror of the page's ``sl_deepNear`` (null≍undefined, 1e-9 rel tol)."""
  if a is None or a is undefined:
    return b is None or b is undefined
  if isinstance(a, float) and isinstance(b, float) \
      and not isinstance(a, bool) and not isinstance(b, bool):
    if math.isnan(a) and math.isnan(b):
      return True
    return abs(a - b) <= 1e-9 * max(1.0, abs(a), abs(b))
  if isinstance(a, list) and isinstance(b, list):
    return len(a) == len(b) and all(deep_near(x, y) for x, y in zip(a, b))
  return _strict_eq(a, b)


def run_selftests(logic_js: str, fixtures: list, data_values,
                  sentinel: str = '__DATA_VALUES__') -> list:
  """Executes the golden fixtures against the generated JS text.

  Returns the failure list, exactly as ``sl_runSelfTests`` computes it in
  the browser: empty ⇒ the page banner shows "pass".
  """
  interp = Interpreter().run(logic_js)
  failures = []
  for f in fixtures:
    args = [data_values if a == sentinel else a for a in f['args']]
    name = 'sl_' + f['fn']
    try:
      got = interp.call(name, *args)
    except Exception as e:  # noqa: BLE001 — mirror the page's try/catch
      failures.append(f'{f["name"]}: threw {type(e).__name__}: {e}')
      continue
    if not deep_near(got, _from_python(f['expected'])):
      failures.append(f'{f["name"]}: got {got!r} != {f["expected"]!r}')
  return failures
