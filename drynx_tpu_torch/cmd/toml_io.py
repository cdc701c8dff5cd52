"""Minimal TOML emit/parse for the CLI config pipeline (a copy of
drynx_tpu/cmd/toml_io.py: `dumps` gives the reference's bytes).

The reference pipes TOML configs through stdin/stdout between composable
commands (cmd/README.md:7-9, cmd/client/config.go:14-123). Python ships a
TOML reader (tomllib) but no writer, so a small emitter for our config shape
(tables, arrays of tables, scalar/list values) lives here.
"""
from __future__ import annotations

try:
    import tomllib  # python >= 3.11
except ModuleNotFoundError:
    import tomli as tomllib  # same API; tomllib is tomli vendored


def loads(text: str) -> dict:
    return tomllib.loads(text)


def _fmt_val(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_fmt_val(x) for x in v) + "]"
    raise TypeError(f"unsupported TOML value {type(v)}")


def _emit_table(out: list, name: str, item: dict, is_array: bool) -> None:
    out.append("")
    out.append(f"[[{name}]]" if is_array else f"[{name}]")
    nested = []
    for k, v in item.items():
        if isinstance(v, dict):
            if is_array:
                # [[name]] + [name.k] would attach to the LAST array element
                # in TOML semantics — ambiguous; nothing in the config shape
                # needs it
                raise TypeError(
                    f"nested table {k!r} inside array-of-tables {name!r}")
            nested.append((f"{name}.{k}", v))
        else:
            out.append(f"{k} = {_fmt_val(v)}")
    for sub, v in nested:
        _emit_table(out, sub, v, False)   # dotted header: [survey.lr]


def dumps(d: dict) -> str:
    out = []
    tables = []
    for k, v in d.items():
        if isinstance(v, dict):
            tables.append((k, [v], False))
        elif isinstance(v, list) and v and all(isinstance(x, dict) for x in v):
            tables.append((k, v, True))
        else:
            out.append(f"{k} = {_fmt_val(v)}")
    for name, items, is_array in tables:
        for item in items:
            _emit_table(out, name, item, is_array)
    return "\n".join(out) + "\n"


__all__ = ["loads", "dumps"]
