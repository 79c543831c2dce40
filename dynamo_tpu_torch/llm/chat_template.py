"""A renderer for the subset of Jinja that HuggingFace chat templates use.

The JAX package renders chat templates with `jinja2` (`dynamo_tpu/llm/
preprocessor.py` `PromptFormatter`), which the card's machine does not
promise. This module renders the same text for the subset below, under
that environment's settings (`trim_blocks=True, lstrip_blocks=True,
keep_trailing_newline=True`):

- statements: `{% for x in ... %}` (and `for a, b in ...`) with
  `loop.index0/index/first/last/length`,
  `{% if %}`/`{% elif %}`/`{% else %}`, `{% set name = ... %}`; output
  `{{ ... }}` and comments `{# ... #}`; `{%-`/`-%}` (and `{{-`, `-}}`,
  `{%+`, `+%}`) whitespace control;
- expressions: string, number, list, tuple and dict literals, `true`,
  `false`, `none` (and a leading `-`); names; `.name` and `[...]` access
  (with slices); `+ ~ == != < > <= >= in`, `not in`, `not`, `and`,
  `or`, `a if b else c`; the tests `is [not] defined/none/string`; the
  filters `trim`, `tojson`, `length`, `upper` and `lower`; calls of the
  globals `raise_exception` and `strftime_now`.

Scoping follows Jinja's: a `set` inside a loop body lives for that
iteration only; an undefined name prints as "" and is false, and using one
otherwise (attribute access, arithmetic, ordering) raises. Any other
construct raises `TemplateError` naming it, so no template is rendered
differently from jinja2 in silence.
"""

from __future__ import annotations

import datetime
import json
import re
from typing import Any, Callable, Optional


class TemplateError(Exception):
    """A template that cannot be parsed or rendered (not a client fault:
    the HTTP layer maps it to 5xx, as it maps jinja2's)."""


class _Undefined:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def _fail(self, *_):
        raise TemplateError(f"{self.name!r} is undefined")

    __add__ = __radd__ = __neg__ = _fail
    __lt__ = __le__ = __gt__ = __ge__ = __getitem__ = _fail

    def __str__(self) -> str:
        return ""

    def __bool__(self) -> bool:
        return False

    def __iter__(self):
        return iter(())

    def __len__(self) -> int:
        return 0

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    __hash__ = object.__hash__


def _raise_exception(message: str):
    raise TemplateError(message)


def _strftime_now(fmt: str) -> str:
    return datetime.datetime.now().strftime(fmt)


DEFAULT_GLOBALS = {"raise_exception": _raise_exception, "strftime_now": _strftime_now}


def _to_str(v) -> str:
    return str(v)


def _tojson(v, **kw):
    return json.dumps(v, **kw)


FILTERS: dict[str, Callable] = {
    "trim": lambda v, chars=None: _to_str(v).strip(chars),
    "tojson": _tojson,
    "length": len,
    "upper": lambda v: _to_str(v).upper(),
    "lower": lambda v: _to_str(v).lower(),
}


TESTS: dict[str, Callable] = {
    "defined": lambda v: not isinstance(v, _Undefined),
    "none": lambda v: v is None,
    "string": lambda v: isinstance(v, str),
}

# ------------------------------------------------------------------ lexing

_TOKEN_RE = re.compile(
    r"""(?P<ws>\s+)
      | (?P<float>(?<!\.)(?:\d+_)*\d+(?:(?:\.(?:\d+_)*\d+)?e[+\-]?(?:\d+_)*\d+|\.(?:\d+_)*\d+))
      | (?P<int>(?:\d+_)*\d+)
      | (?P<name>[a-zA-Z_][a-zA-Z0-9_]*)
      | (?P<str>'(?:[^'\\]*(?:\\.[^'\\]*)*)'|"(?:[^"\\]*(?:\\.[^"\\]*)*)")
      | (?P<op>//|\*\*|==|!=|>=|<=|[+\-/*%~\[\](){}<>=.:|,;])""",
    re.X | re.S,
)
_NEWLINES = re.compile(r"\r\n|\r|\n")
_TAG_START = re.compile(r"\{\{|\{%|\{#")
# tag ends; `%}` and `#}` take one newline after them (trim_blocks), `-`
# takes all white space
_ENDS = {"{{": re.compile(r"\-\}\}\s*|\}\}", re.S),
         "{%": re.compile(r"\+%\}|\-%\}\s*|%\}\n?", re.S)}
_COMMENT_END = re.compile(r"\+#\}|\-#\}\s*|#\}\n?", re.S)


def _string_value(raw: str) -> str:
    return raw[1:-1].encode("ascii", "backslashreplace").decode("unicode-escape")


def _lex(source: str) -> list:
    """Split the source into ("text", str), ("out", tokens) and ("stmt",
    tokens) items, applying Jinja's whitespace control."""
    source = _NEWLINES.sub("\n", source)  # as jinja2 splits and rejoins its lines
    items: list = []
    pos, line_starting, n = 0, True, len(source)
    while pos < n:
        m = _TAG_START.search(source, pos)
        text = source[pos:m.start() if m else n]
        if m is None:
            if text:
                items.append(("text", text))
            break
        kind = m.group()
        p = m.end()
        sign = source[p] if p < n and source[p] in "-+" else ""
        p += len(sign)
        if sign == "-":
            text = text.rstrip()
        elif sign != "+" and kind != "{{":
            # lstrip_blocks: white space alone before a block or comment tag
            # on its line goes
            l_pos = text.rfind("\n") + 1
            if (l_pos > 0 or line_starting) and re.fullmatch(r"\s+", text[l_pos:]):
                text = text[:l_pos]
        if text:
            items.append(("text", text))
        if kind == "{#":
            end = _COMMENT_END.search(source, p)
            if end is None:
                raise TemplateError("missing end of comment tag")
            pos = end.end()
            line_starting = source[pos - 1:pos] == "\n"
            continue
        close = _ENDS[kind]
        tokens: list = []
        depth = 0
        while True:
            if p >= n:
                raise TemplateError(f"unexpected end of template in a {kind!r} tag")
            if depth == 0:
                end = close.match(source, p)
                if end is not None:
                    p = end.end()
                    break
            t = _TOKEN_RE.match(source, p)
            if t is None:
                raise TemplateError(f"unexpected character {source[p]!r} in template")
            p = t.end()
            typ = t.lastgroup
            if typ == "ws":
                continue
            val = t.group()
            if typ == "op" and val in "([{":
                depth += 1
            elif typ == "op" and val in ")]}":
                depth -= 1
            tokens.append((typ, val))
        items.append(("out" if kind == "{{" else "stmt", tokens))
        pos = p
        line_starting = source[p - 1:p] == "\n"
    return items


# ----------------------------------------------------------------- parsing


class _Tokens:
    def __init__(self, toks: list):
        self.toks = toks
        self.i = 0

    def peek(self, k: int = 0):
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else ("end", "")

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def at(self, typ: str, val: Optional[str] = None) -> bool:
        t = self.peek()
        return t[0] == typ and (val is None or t[1] == val)

    def skip(self, typ: str, val: Optional[str] = None) -> bool:
        if self.at(typ, val):
            self.i += 1
            return True
        return False

    def expect(self, typ: str, val: Optional[str] = None):
        if not self.at(typ, val):
            raise TemplateError(f"expected {val or typ!r}, got {self.peek()[1]!r}")
        return self.next()

    def done(self) -> None:
        if self.i < len(self.toks):
            raise TemplateError(f"unexpected {self.peek()[1]!r} in expression")


_CMP = {"==": lambda a, b: a == b, "!=": lambda a, b: a != b, "<": lambda a, b: a < b,
        ">": lambda a, b: a > b, "<=": lambda a, b: a <= b, ">=": lambda a, b: a >= b}

# An expression compiles to a function of the scope (a `_Scope`).
Expr = Callable[["_Scope"], Any]


def _getattr(obj, name: str):
    if isinstance(obj, _Undefined):
        obj._fail()
    if isinstance(obj, dict):
        if hasattr(dict, name):
            raise TemplateError(f"method access '.{name}' is not supported")
        return obj[name] if name in obj else _Undefined(name)
    if hasattr(type(obj), name):
        raise TemplateError(f"method access '.{name}' is not supported")
    return _Undefined(name)


def _getitem(obj, key):
    if isinstance(obj, _Undefined):
        obj._fail()
    try:
        return obj[key]
    except (LookupError, TypeError):
        if isinstance(key, str):
            return _getattr(obj, key)
        return _Undefined(str(key))


def _parse_expr(ts: _Tokens) -> Expr:
    node = _parse_or(ts)
    while ts.skip("name", "if"):
        cond = _parse_or(ts)
        other = _parse_expr(ts) if ts.skip("name", "else") else (lambda s: _Undefined("else"))
        node = (lambda body, cond, other:
                lambda s: body(s) if cond(s) else other(s))(node, cond, other)
    return node


def _parse_or(ts: _Tokens) -> Expr:
    node = _parse_and(ts)
    while ts.skip("name", "or"):
        right = _parse_and(ts)
        node = (lambda a, b: lambda s: a(s) or b(s))(node, right)
    return node


def _parse_and(ts: _Tokens) -> Expr:
    node = _parse_not(ts)
    while ts.skip("name", "and"):
        right = _parse_not(ts)
        node = (lambda a, b: lambda s: a(s) and b(s))(node, right)
    return node


def _parse_not(ts: _Tokens) -> Expr:
    if ts.skip("name", "not"):
        inner = _parse_not(ts)
        return lambda s: not inner(s)
    return _parse_compare(ts)


def _parse_compare(ts: _Tokens) -> Expr:
    first = _parse_math1(ts)
    ops = []
    while True:
        t = ts.peek()
        if t[0] == "op" and t[1] in _CMP:
            ts.next()
            ops.append((_CMP[t[1]], _parse_math1(ts)))
        elif ts.skip("name", "in"):
            ops.append((lambda a, b: a in b, _parse_math1(ts)))
        elif t == ("name", "not") and ts.peek(1) == ("name", "in"):
            ts.next()
            ts.next()
            ops.append((lambda a, b: a not in b, _parse_math1(ts)))
        else:
            break
    if not ops:
        return first

    def compare(s):
        left = first(s)
        for fn, expr in ops:
            right = expr(s)
            if not fn(left, right):
                return False
            left = right
        return True

    return compare


def _parse_math1(ts: _Tokens) -> Expr:
    node = _parse_concat(ts)
    while True:
        if ts.at("op", "+"):
            ts.next()
            right = _parse_concat(ts)
            node = (lambda a, b: lambda s: a(s) + b(s))(node, right)
        elif ts.peek()[0] == "op" and ts.peek()[1] in ("-", "*", "/", "//", "%", "**"):
            raise TemplateError(f"operator {ts.peek()[1]!r} is not supported")
        else:
            return node


def _parse_concat(ts: _Tokens) -> Expr:
    node = _parse_unary(ts)
    while ts.skip("op", "~"):
        right = _parse_unary(ts)
        node = (lambda a, b: lambda s: _to_str(a(s)) + _to_str(b(s)))(node, right)
    return node


def _parse_unary(ts: _Tokens, with_filter: bool = True) -> Expr:
    if ts.skip("op", "-"):
        inner = _parse_unary(ts, False)
        node = lambda s: -inner(s)  # noqa: E731
    else:
        node = _parse_primary(ts)
    node = _parse_postfix(ts, node)
    if with_filter:
        node = _parse_filters(ts, node)
    return node


def _parse_args(ts: _Tokens) -> tuple[list, dict]:
    args, kwargs = [], {}
    ts.expect("op", "(")
    while not ts.skip("op", ")"):
        if args or kwargs:
            ts.expect("op", ",")
            if ts.skip("op", ")"):
                break
        if ts.at("name") and ts.peek(1) == ("op", "="):
            key = ts.next()[1]
            ts.next()
            kwargs[key] = _parse_expr(ts)
        else:
            args.append(_parse_expr(ts))
    return args, kwargs


def _parse_primary(ts: _Tokens) -> Expr:
    typ, val = ts.next()
    if typ == "name":
        if val in ("true", "True"):
            return lambda s: True
        if val in ("false", "False"):
            return lambda s: False
        if val in ("none", "None"):
            return lambda s: None
        return lambda s: s.lookup(val)
    if typ == "str":
        text = _string_value(val)
        while ts.at("str"):  # adjacent literals concatenate
            text += _string_value(ts.next()[1])
        return lambda s: text
    if typ == "int":
        num = int(val.replace("_", ""))
        return lambda s: num
    if typ == "float":
        fnum = float(val.replace("_", ""))
        return lambda s: fnum
    if (typ, val) == ("op", "("):
        items, trailing = [], False
        while not ts.skip("op", ")"):
            if items:
                ts.expect("op", ",")
                if ts.skip("op", ")"):
                    trailing = True
                    break
            items.append(_parse_expr(ts))
        if len(items) == 1 and not trailing:
            return items[0]
        return lambda s: tuple(e(s) for e in items)
    if (typ, val) == ("op", "["):
        elems = []
        while not ts.skip("op", "]"):
            if elems:
                ts.expect("op", ",")
                if ts.skip("op", "]"):
                    break
            elems.append(_parse_expr(ts))
        return lambda s: [e(s) for e in elems]
    if (typ, val) == ("op", "{"):
        pairs = []
        while not ts.skip("op", "}"):
            if pairs:
                ts.expect("op", ",")
                if ts.skip("op", "}"):
                    break
            k = _parse_expr(ts)
            ts.expect("op", ":")
            pairs.append((k, _parse_expr(ts)))
        return lambda s: {k(s): v(s) for k, v in pairs}
    raise TemplateError(f"unexpected {val or 'end of expression'!r}")


def _parse_subscript(ts: _Tokens) -> Expr:
    """`[...]` after `[` has been read: an index or a slice."""
    parts: list = [None]
    while not ts.at("op", "]"):
        if ts.skip("op", ":"):
            parts.append(None)
            if len(parts) > 3:
                raise TemplateError("invalid slice")
            continue
        parts[-1] = _parse_expr(ts)
    ts.expect("op", "]")
    if len(parts) == 1:
        if parts[0] is None:
            raise TemplateError("empty subscript")
        return parts[0]
    parts += [None] * (3 - len(parts))
    return lambda s: slice(*(p(s) if p is not None else None for p in parts))


def _parse_postfix(ts: _Tokens, node: Expr) -> Expr:
    while True:
        if ts.skip("op", "."):
            t = ts.next()
            if t[0] == "name":
                node = (lambda n, a: lambda s: _getattr(n(s), a))(node, t[1])
            elif t[0] == "int":
                node = (lambda n, k: lambda s: _getitem(n(s), k))(node, int(t[1]))
            else:
                raise TemplateError(f"unexpected {t[1]!r} after '.'")
        elif ts.skip("op", "["):
            key = _parse_subscript(ts)
            node = (lambda n, k: lambda s: _getitem(n(s), k(s)))(node, key)
        elif ts.at("op", "("):
            node = _parse_call(ts, node)
        else:
            return node


def _parse_call(ts: _Tokens, node: Expr) -> Expr:
    args, kwargs = _parse_args(ts)

    def call(s):
        fn = node(s)
        if not callable(fn) or fn not in s.callables:
            raise TemplateError("only the globals raise_exception and strftime_now can "
                                "be called")
        return fn(*(a(s) for a in args), **{k: v(s) for k, v in kwargs.items()})

    return call


def _parse_filters(ts: _Tokens, node: Expr) -> Expr:
    while True:
        if ts.skip("op", "|"):
            name = ts.expect("name")[1]
            if name not in FILTERS:
                raise TemplateError(f"filter {name!r} is not supported")
            args, kwargs = _parse_args(ts) if ts.at("op", "(") else ([], {})
            node = (lambda f, n, a, kw: lambda s: f(
                n(s), *(x(s) for x in a), **{k: v(s) for k, v in kw.items()})
            )(FILTERS[name], node, args, kwargs)
        elif ts.skip("name", "is"):
            negate = ts.skip("name", "not")
            name = ts.expect("name")[1]
            if name not in TESTS:
                raise TemplateError(f"test {name!r} is not supported")
            test = TESTS[name]
            node = (lambda t, n, neg: lambda s: bool(t(n(s))) != neg)(test, node, negate)
        elif ts.at("op", "("):
            node = _parse_call(ts, node)
        else:
            return node


# --------------------------------------------------------------- statements


class _Scope:
    def __init__(self, parent: Optional["_Scope"], values: dict, callables=None):
        self.parent = parent
        self.values = values
        self.callables = callables if callables is not None else parent.callables

    def lookup(self, name: str):
        s = self
        while s is not None:
            if name in s.values:
                return s.values[name]
            s = s.parent
        return _Undefined(name)


def _parse_block(items: list, i: int, stop: tuple) -> tuple[list, int, Optional[str]]:
    """Parse nodes from items[i] until a statement whose keyword is in
    `stop`; returns (nodes, index of that statement, its keyword)."""
    nodes: list = []
    while i < len(items):
        kind, val = items[i]
        if kind == "text":
            nodes.append(("text", val))
            i += 1
            continue
        if kind == "out":
            ts = _Tokens(val)
            expr = _parse_expr(ts)
            ts.done()
            nodes.append(("out", expr))
            i += 1
            continue
        if not val or val[0][0] != "name":
            raise TemplateError("empty or malformed statement")
        word = val[0][1]
        if word in stop:
            return nodes, i, word
        ts = _Tokens(val[1:])
        if word == "for":
            targets = [ts.expect("name")[1]]
            while ts.skip("op", ","):
                targets.append(ts.expect("name")[1])
            ts.expect("name", "in")
            it = _parse_or(ts)  # `for x in y if c` is a loop filter, not a condition
            if not ts.at("end"):
                raise TemplateError(f"'{ts.peek()[1]}' in a for statement is not supported")
            body, i, end = _parse_block(items, i + 1, ("endfor", "else"))
            if end != "endfor":
                raise TemplateError("'for ... else' is not supported" if end else
                                    "missing endfor")
            nodes.append(("for", targets, it, body))
            i += 1
        elif word == "if":
            branches = []
            cond = _parse_expr(ts)
            ts.done()
            while True:
                body, i, end = _parse_block(items, i + 1, ("elif", "else", "endif"))
                branches.append((cond, body))
                if end is None:
                    raise TemplateError("missing endif")
                ets = _Tokens(items[i][1][1:])
                if end == "elif":
                    cond = _parse_expr(ets)
                    ets.done()
                    continue
                ets.done()
                if end == "else":
                    body, i, end = _parse_block(items, i + 1, ("endif",))
                    if end is None:
                        raise TemplateError("missing endif")
                    branches.append((lambda s: True, body))
                break
            nodes.append(("if", branches))
            i += 1
        elif word == "set":
            name = ts.expect("name")[1]
            if not ts.at("op", "="):
                raise TemplateError("only '{% set name = expression %}' is supported")
            ts.next()
            expr = _parse_expr(ts)
            ts.done()
            nodes.append(("set", name, expr))
            i += 1
        else:
            raise TemplateError(f"statement {word!r} is not supported")
    return nodes, i, None


def _run(nodes: list, scope: _Scope, out: list) -> None:
    for node in nodes:
        kind = node[0]
        if kind == "text":
            out.append(node[1])
        elif kind == "out":
            out.append(_to_str(node[1](scope)))
        elif kind == "set":
            scope.values[node[1]] = node[2](scope)
        elif kind == "if":
            for cond, body in node[1]:
                if cond(scope):
                    _run(body, scope, out)
                    break
        else:  # for
            _, targets, it, body = node
            seq = list(it(scope))
            n = len(seq)
            for idx, item in enumerate(seq):
                values = {"loop": {"index0": idx, "index": idx + 1, "first": idx == 0,
                                   "last": idx == n - 1, "length": n}}
                if len(targets) == 1:
                    values[targets[0]] = item
                else:
                    item = list(item)
                    if len(item) != len(targets):
                        raise TemplateError(f"cannot unpack {len(item)} values into "
                                            f"{len(targets)} names")
                    values.update(zip(targets, item))
                _run(body, _Scope(scope, values), out)


class ChatTemplate:
    """A parsed template: `ChatTemplate(source).render(**context)`."""

    def __init__(self, source: str, globals: Optional[dict] = None):
        self._globals = dict(DEFAULT_GLOBALS, **(globals or {}))
        nodes, i, end = _parse_block(_lex(source), 0, ())
        if end is not None:
            raise TemplateError(f"unexpected {end!r}")
        self._nodes = nodes

    def render(self, **context) -> str:
        root = _Scope(None, dict(self._globals),
                      callables=[v for v in self._globals.values() if callable(v)])
        scope = _Scope(root, dict(context))
        out: list[str] = []
        _run(self._nodes, scope, out)
        return "".join(out)
