"""HCL2 parser + semantic validator for the repo's terraform modules.

`terraform validate` needs the terraform binary and provider downloads;
neither exists in hermetic CI. This module parses the HCL2 subset the
modules actually use (blocks, attributes, expressions with interpolation,
for-expressions, conditionals, function calls) with lark, then checks the
things validate would catch statically:

- every `var.*` reference is declared in the module (and vice versa: no
  dead variables);
- resource-address references (`google_container_cluster.cluster.name`)
  resolve to resources the module declares;
- `count.index` is only used inside blocks that set `count`;
- a tfvars dict covers every required (default-less) variable and adds no
  undeclared keys.

`render_plan` additionally evaluates each resource's attributes against a
tfvars dict (count fan-out included, computed references left symbolic),
giving deterministic plan documents for golden tests — the SURVEY.md §4
"plan golden tests against a stubbed provider" without the provider.

The port's copy of `tritonk8ssupervisor_tpu/infra/hcl.py`, whole and under
the reference's names, with two more functions for the GPU modules'
fan-out: `floor` and `chunklist`.
"""

from __future__ import annotations

import dataclasses
import math
import re
import warnings
from pathlib import Path
from typing import Any

from lark import Lark, Token, Transformer, v_args

GRAMMAR = r"""
start: body
body: (attribute | block)*
attribute: NAME "=" expr
block: NAME STRING* "{" body "}"

?expr: ternary
?ternary: or_expr ("?" expr ":" expr)?
?or_expr: and_expr ("||" and_expr)*
?and_expr: comp_expr ("&&" comp_expr)*
?comp_expr: add_expr (COMP_OP add_expr)?
?add_expr: mul_expr (ADD_OP mul_expr)*
?mul_expr: unary_expr (MUL_OP unary_expr)*
?unary_expr: postfix
           | "!" unary_expr -> not_expr
           | "-" unary_expr -> neg_expr
?postfix: primary (index | getattr | splat)*
index: "[" expr "]"
getattr: "." NAME
splat: "[" "*" "]" | "." "*"
?primary: STRING          -> string
        | NUMBER          -> number
        | "true"          -> true
        | "false"         -> false
        | "null"          -> null
        | list_expr
        | for_expr
        | funccall
        | NAME            -> reference
        | "(" expr ")"

funccall: NAME "(" [expr ("," expr)*] ")"
list_expr: "[" [expr ("," expr)* ","?] "]"
for_expr: "[" "for" NAME ("," NAME)? "in" expr ":" expr "]"
object: "{" objentry* "}"
objentry: (NAME | STRING) "=" expr ","?

?expr_or_object: expr | object
// objects appear as attribute values; extend attribute to accept them
%override attribute: NAME "=" expr_or_object

COMP_OP: ">=" | "<=" | "==" | "!=" | ">" | "<"
ADD_OP: "+" | "-"
MUL_OP: "*" | "/" | "%"
NAME: /[a-zA-Z_][a-zA-Z0-9_-]*/
NUMBER: /[0-9]+(\.[0-9]+)?/
STRING: /"(\\.|[^"\\])*"/

COMMENT: /#[^\n]*/ | /\/\/[^\n]*/ | /\/\*([^*]|\*[^\/])*\*\//
%ignore COMMENT
%import common.WS
%ignore WS
"""

_PARSER = Lark(GRAMMAR, start="start", parser="earley")
_EXPR_PARSER = Lark(GRAMMAR, start="expr", parser="earley")

_INTERP_RE = re.compile(r"\$\{([^{}]*)\}")


# ------------------------------------------------------------------ AST model


@dataclasses.dataclass
class Block:
    kind: str            # resource / variable / output / provider / ...
    labels: list[str]    # e.g. ["google_tpu_v2_vm", "slice"]
    attrs: dict          # name -> expression tree (lark Tree/Token)
    blocks: list["Block"]

    def find(self, kind: str) -> list["Block"]:
        return [b for b in self.blocks if b.kind == kind]


@dataclasses.dataclass
class Module:
    blocks: list[Block]

    def resources(self) -> dict[tuple[str, str], Block]:
        return {
            (b.labels[0], b.labels[1]): b
            for b in self.blocks
            if b.kind == "resource" and len(b.labels) == 2
        }

    def variables(self) -> dict[str, Block]:
        return {b.labels[0]: b for b in self.blocks if b.kind == "variable"}

    def data_sources(self) -> dict[tuple[str, str], Block]:
        return {
            (b.labels[0], b.labels[1]): b
            for b in self.blocks
            if b.kind == "data" and len(b.labels) == 2
        }

    def outputs(self) -> dict[str, Block]:
        return {b.labels[0]: b for b in self.blocks if b.kind == "output"}


class _BuildAst(Transformer):
    @v_args(inline=True)
    def attribute(self, name, value):
        return ("attr", str(name), value)

    def block(self, items):
        name = str(items[0])
        labels = [_unquote(str(t)) for t in items[1:-1]]
        body = items[-1]
        attrs = {k: v for tag, k, v in body if tag == "attr"}
        blocks = [b for tag, _, b in body if tag == "block"]
        return ("block", name, Block(name, labels, attrs, blocks))

    def body(self, items):
        return list(items)

    def start(self, items):
        return items[0]


def _unquote(raw: str) -> str:
    return raw[1:-1] if raw.startswith('"') else raw


# Heredocs are handled by preprocessing into ordinary quoted strings
# (json escaping keeps ${...} interpolations visible to the reference
# scan) rather than by grammar: a lexer terminal would need a
# backreference on the delimiter, which lark's terminal regexes don't
# reliably support. <<-EOT (indented) and <<EOT both match; the closing
# delimiter must stand alone on its line (the lookahead), and an empty
# body is legal.
_HEREDOC_RE = re.compile(
    r"<<-?([A-Za-z_][A-Za-z0-9_]*)\r?\n(.*?)^[ \t]*\1(?=\r?\n|$)",
    re.DOTALL | re.MULTILINE,
)


def _strip_heredocs(text: str) -> str:
    import json

    def repl(m):
        body = re.sub(r"\r?\n$", "", m.group(2))  # delimiter-line newline
        return json.dumps(body)

    return _HEREDOC_RE.sub(repl, text)


def _decode_string(raw: str) -> str:
    """STRING token text -> its value. Heredoc preprocessing emits
    json-escaped strings, so decode escapes properly; hand-authored HCL
    strings that json can't parse keep the old strip-quotes behaviour."""
    import json

    try:
        return json.loads(raw)
    except Exception:  # noqa: BLE001 - non-json escapes: legacy path
        return _unquote(raw)


def parse_hcl(text: str) -> Module:
    body = _BuildAst().transform(_PARSER.parse(_strip_heredocs(text)))
    return Module(blocks=[b for tag, _, b in body if tag == "block"])


def parse_module_dir(path: Path) -> Module:
    """All .tf files of a module, concatenated (terraform semantics)."""
    texts = [f.read_text() for f in sorted(path.glob("*.tf"))]
    return parse_hcl("\n".join(texts))


# ------------------------------------------------------------- reference walk


def _walk(node):
    yield node
    if hasattr(node, "children"):
        for child in node.children:
            yield from _walk(child)


def _iter_exprs(block: Block):
    for value in block.attrs.values():
        yield value
    for sub in block.blocks:
        yield from _iter_exprs(sub)


def expr_references(expr) -> set[tuple[str, ...]]:
    """Reference paths in an expression tree: var.project -> ("var",
    "project"); chains through indexes keep going (a[0].b -> a.b). String
    interpolations are parsed recursively."""
    refs: set[tuple[str, ...]] = set()
    for node in _walk(expr):
        if not hasattr(node, "data"):
            if isinstance(node, Token) and node.type == "STRING":
                # decode first: heredoc-generated strings carry escaped
                # quotes inside interpolations (${join("...")}) that the
                # raw token text would mis-parse
                for inner in _INTERP_RE.findall(_decode_string(str(node))):
                    try:
                        refs |= expr_references(_EXPR_PARSER.parse(inner))
                    except Exception:  # noqa: BLE001
                        # expression forms outside the grammar: no refs
                        # extractable — a grammar gap, not a defect, so
                        # it must not block. But dangling references
                        # inside this interpolation now escape the
                        # precheck, so make the gap visible instead of
                        # silent (the precheck's warn-and-proceed
                        # philosophy).
                        warnings.warn(
                            "hcl precheck: interpolation "
                            f"${{{inner}}} is outside the expression "
                            "grammar; references inside it are not "
                            "checked",
                            stacklevel=2,
                        )
                        continue
            continue
        if node.data == "reference":
            refs.add((str(node.children[0]),))
        elif node.data == "postfix":
            path = _postfix_path(node)
            if path:
                refs.add(path)
    # bare references that are heads of postfix chains are subsumed
    heads = {p[:1] for p in refs if len(p) > 1}
    return {r for r in refs if not (len(r) == 1 and r in heads)} or refs


def _postfix_path(node) -> tuple[str, ...] | None:
    head = node.children[0]
    if not (hasattr(head, "data") and head.data == "reference"):
        return None
    path = [str(head.children[0])]
    for part in node.children[1:]:
        if hasattr(part, "data") and part.data == "getattr":
            path.append(str(part.children[0]))
        # index steps don't extend the name path
    return tuple(path)


def _for_bound_names(block: Block) -> set[str]:
    names: set[str] = set()
    for expr in _iter_exprs(block):
        for node in _walk(expr):
            if hasattr(node, "data") and node.data == "for_expr":
                for child in node.children[:-2]:
                    if isinstance(child, Token) and child.type == "NAME":
                        names.add(str(child))
    return names


# -------------------------------------------------------------- validation


class HclError(ValueError):
    pass


def validate_module(module: Module) -> list[str]:
    """Returns problems (empty list == valid)."""
    problems: list[str] = []
    declared_vars = set(module.variables())
    resources = module.resources()
    resource_names = {f"{t}.{n}" for t, n in resources}
    data_names = {f"{t}.{n}" for t, n in module.data_sources()}

    used_vars: set[str] = set()
    for block in module.blocks:
        bound = _for_bound_names(block)
        has_count = "count" in block.attrs
        # a dynamic block introduces <label>.value inside its content
        bound |= {b.labels[0] for b in block.blocks if b.kind == "dynamic"}
        for expr in _iter_exprs(block):
            for ref in expr_references(expr):
                head = ref[0]
                if head == "var":
                    if len(ref) < 2 or ref[1] not in declared_vars:
                        problems.append(
                            f"{block.kind} {'.'.join(block.labels)}: "
                            f"undeclared variable {'.'.join(ref)}"
                        )
                    else:
                        used_vars.add(ref[1])
                elif head == "count":
                    if not has_count:
                        problems.append(
                            f"{block.kind} {'.'.join(block.labels)}: "
                            "count.index used without count"
                        )
                elif head == "data":
                    if len(ref) < 3 or f"{ref[1]}.{ref[2]}" not in data_names:
                        problems.append(
                            f"{block.kind} {'.'.join(block.labels)}: "
                            f"unresolved data reference {'.'.join(ref)}"
                        )
                elif head in bound or head in ("local", "each", "path", "terraform"):
                    continue
                elif len(ref) >= 2 and f"{ref[0]}.{ref[1]}" in resource_names:
                    continue
                elif len(ref) >= 2 and head not in ("var", "count"):
                    # looks like a resource address that doesn't resolve —
                    # but only flag known resource-ish prefixes (google_*)
                    # to avoid false positives on function-arg idioms
                    if head.startswith(("google_", "aws_")):
                        problems.append(
                            f"{block.kind} {'.'.join(block.labels)}: "
                            f"unresolved resource reference {'.'.join(ref)}"
                        )
    for unused in sorted(declared_vars - used_vars):
        problems.append(f"variable {unused} declared but never used")
    return problems


def check_tfvars(module: Module, tfvars: dict) -> list[str]:
    """tfvars keys must exactly feed the module: no undeclared keys, and
    every default-less variable covered (what `terraform plan` enforces)."""
    problems = []
    variables = module.variables()
    for key in tfvars:
        if key not in variables:
            problems.append(f"tfvars key {key} not declared by module")
    for name, block in variables.items():
        if "default" not in block.attrs and name not in tfvars:
            problems.append(f"required variable {name} not covered by tfvars")
    return problems


# ------------------------------------------------------------- plan renderer


class _Unresolved:
    """A computed (provider-side) value; renders symbolically."""

    def __init__(self, path: str):
        self.path = path

    def __repr__(self):
        return f"${{{self.path}}}"


def _eval(expr, env: dict) -> Any:
    if isinstance(expr, Token):
        if expr.type == "STRING":
            raw = _decode_string(str(expr))
            return _INTERP_RE.sub(
                lambda m: _to_str(_eval(_EXPR_PARSER.parse(m.group(1)), env)), raw
            )
        if expr.type == "NUMBER":
            text = str(expr)
            return float(text) if "." in text else int(text)
        raise HclError(f"unexpected token {expr!r}")
    data = expr.data
    kids = expr.children
    if data == "string" or data == "number":
        return _eval(kids[0], env)
    if data == "true":
        return True
    if data == "false":
        return False
    if data == "null":
        return None
    if data == "reference":
        return _lookup(env, (str(kids[0]),))
    if data == "postfix":
        value = _eval(kids[0], env)
        splatted = False  # after a[*], getattrs map over elements
        for part in kids[1:]:
            if isinstance(value, _Unresolved):
                if part.data == "getattr":
                    suffix = f".{part.children[0]}"
                elif part.data == "splat":
                    suffix = "[*]"
                else:
                    suffix = f"[{_to_str(_eval(part.children[0], env))}]"
                value = _Unresolved(value.path + suffix)
            elif part.data == "splat":
                value = (
                    list(value) if isinstance(value, (list, tuple)) else [value]
                )
                splatted = True
            elif part.data == "getattr":
                name = str(part.children[0])
                value = [e[name] for e in value] if splatted else value[name]
            else:
                # HCL2 full splat: every later index maps per element
                # (var.xs[*][0] is [e[0] for e in xs], not xs[0])
                idx = _eval(part.children[0], env)
                value = [e[idx] for e in value] if splatted else value[idx]
        return value
    if data == "funccall":
        fname = str(kids[0])
        args = [_eval(a, env) for a in kids[1:] if a is not None]
        return _FUNCTIONS[fname](*args)
    if data == "list_expr":
        return [_eval(k, env) for k in kids if k is not None]
    if data == "object":
        out = {}
        for entry in kids:
            key, value = entry.children
            out[_unquote(str(key))] = _eval(value, env)
        return out
    if data == "for_expr":
        *names, source_expr, body = kids
        names = [str(n) for n in names]
        source = _eval(source_expr, env)
        if isinstance(source, _Unresolved):
            return _Unresolved(f"[for … in {source.path}]")
        result = []
        for i, item in enumerate(source):
            local = dict(env)
            if len(names) == 2:
                local[names[0]], local[names[1]] = i, item
            else:
                local[names[0]] = item
            result.append(_eval(body, local))
        return result
    if data == "ternary":
        cond = _eval(kids[0], env)
        return _eval(kids[1], env) if cond else _eval(kids[2], env)
    if data == "comp_expr":
        left, op, right = _eval(kids[0], env), str(kids[1]), _eval(kids[2], env)
        return {
            ">": left > right, "<": left < right, ">=": left >= right,
            "<=": left <= right, "==": left == right, "!=": left != right,
        }[op]
    if data in ("add_expr", "mul_expr"):
        value = _eval(kids[0], env)
        for op_token, operand in zip(kids[1::2], kids[2::2]):
            rhs = _eval(operand, env)
            value = {
                "+": lambda a, b: a + b, "-": lambda a, b: a - b,
                "*": lambda a, b: a * b, "/": lambda a, b: a / b,
                "%": lambda a, b: a % b,
            }[str(op_token)](value, rhs)
        return value
    if data == "not_expr":
        return not _eval(kids[0], env)
    if data == "neg_expr":
        return -_eval(kids[0], env)
    raise HclError(f"cannot evaluate {data}")


def _lookup(env: dict, path: tuple[str, ...]):
    if path[0] in env:
        return env[path[0]]
    return _Unresolved(".".join(path))


def _to_str(value) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return str(value)


_FUNCTIONS = {
    "tostring": _to_str,
    "tonumber": lambda v: float(v) if "." in str(v) else int(v),
    "length": len,
    # the GPU modules' host fan-out (terraform/gpu-vm)
    "floor": math.floor,
    "chunklist": lambda xs, n: [list(xs[i:i + int(n)]) for i in range(0, len(xs), int(n))],
}


def _render_body(block: Block, env: dict) -> dict:
    out: dict[str, Any] = {}
    for name, expr in block.attrs.items():
        if name == "count":
            continue
        value = _eval(expr, env)
        out[name] = repr(value) if isinstance(value, _Unresolved) else value
    for sub in block.blocks:
        if sub.kind == "dynamic":
            for_each = _eval(sub.attrs["for_each"], env)
            content = sub.find("content")[0]
            rendered = [
                _render_body(content, {**env, sub.labels[0]: {"value": item}})
                for item in (for_each if not isinstance(for_each, _Unresolved) else [])
            ]
            if rendered:
                out[sub.labels[0]] = rendered
        else:
            out.setdefault(sub.kind, []).append(_render_body(sub, env))
    return out


def render_plan(module: Module, tfvars: dict) -> dict:
    """Deterministic plan document: every resource instance's arguments
    with variables/count resolved and computed references symbolic."""
    variables = module.variables()
    var_env = {}
    for name, block in variables.items():
        if name in tfvars:
            var_env[name] = tfvars[name]
        elif "default" in block.attrs:
            var_env[name] = _eval(block.attrs["default"], {})
        else:
            raise HclError(f"required variable {name} not provided")
    plan: dict[str, Any] = {}
    for (rtype, rname), block in sorted(module.resources().items()):
        env = {"var": var_env}
        if "count" in block.attrs:
            n = _eval(block.attrs["count"], env)
            for i in range(int(n)):
                plan[f"{rtype}.{rname}[{i}]"] = _render_body(
                    block, {**env, "count": {"index": i}}
                )
        else:
            plan[f"{rtype}.{rname}"] = _render_body(block, env)
    return plan
