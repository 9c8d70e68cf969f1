"""Gin-style binding files and params without the gin dependency.

The port's own copy of ``mmt_tpu/utils/bindings.py``, with its grammar and
errors: the reference's ``--gin_file`` / ``--gin_params``
(``src/train.py:39-48``), whose only in-tree use injects ``encoder_cls``
into ``build_encoder`` (``src/configs/encoders.py:112-158``).

* ``target.attr = value`` lines (one per line; ``#`` comments outside
  quotes and blank lines ignored).  Values are Python literals
  (``ast.literal_eval``) or ``@dotted.path`` references, which resolve by
  import to the named object (gin's ``@`` syntax for classes/functions;
  ``pkg.mod:Obj`` works too).
* The target resolves as the longest importable module prefix followed by
  a getattr chain; the final attribute is assigned (module constants,
  dataclass class defaults, registry entries).
* When no module prefix imports, the binding addresses a ``@configurable``
  function's keyword default: ``build_encoder.encoder_cls = @my.Encoder``
  binds the ``encoder_cls`` parameter of ``configs.encoder.build_encoder``.

The bindings live in this module's registries, one set per process.
Spawned loader workers re-import every module afresh, so
``data/prefetch.py`` replays ``snapshot_bindings()`` in each of them.
"""

from __future__ import annotations

import ast
import functools
import importlib
import inspect
from typing import Any, Dict, Iterable, List, Sequence, Tuple

# "function_name.param" -> bound value, consumed by @configurable.
_OVERRIDES: Dict[str, Any] = {}
# registered configurable name -> set of parameter names (validation).
_CONFIGURABLES: Dict[str, set] = {}
# Raw 'key = value' lines applied so far, in order, for spawned workers.
_APPLIED_LINES: List[str] = []
# (obj, attr, had_own_entry, old_value) undo log of module-attribute
# bindings, so clear_bindings() reverses them too.
_ATTR_RESTORE: List[Tuple[Any, str, bool, Any]] = []


def configurable(fn=None, *, name: str = None):
    """Marks a function's keyword defaults as bindable (gin analog): a
    binding ``<name>.<param> = value`` replaces the default of ``param``
    for calls that do not pass it explicitly."""
    if fn is None:
        return lambda f: configurable(f, name=name)
    reg_name = name or fn.__name__
    signature = inspect.signature(fn)
    params = set(signature.parameters)
    _CONFIGURABLES[reg_name] = params

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        bound = signature.bind_partial(*args, **kwargs)
        for p in params:
            key = f"{reg_name}.{p}"
            if p not in bound.arguments and key in _OVERRIDES:
                kwargs[p] = _OVERRIDES[key]
        return fn(*args, **kwargs)

    wrapper._configurable_name = reg_name
    return wrapper


def _import_or_skip(modname: str):
    """Imports ``modname``; None when the module (or a parent) does not
    exist, but a failure inside an existing module's own import propagates
    (a swallowed transitive ImportError would surface later as a
    misleading shorter-prefix error)."""
    try:
        return importlib.import_module(modname)
    except ModuleNotFoundError as e:
        missing = e.name or ""
        if missing == modname or modname.startswith(missing + "."):
            return None  # this prefix is not a module: try a shorter one
        raise  # the module exists; a dependency inside it is missing


def resolve_reference(path: str) -> Any:
    """``@pkg.mod.Obj`` (or ``pkg.mod:Obj``) -> the imported object."""
    path = path.lstrip("@").replace(":", ".")
    parts = path.split(".")
    for cut in range(len(parts) - 1, 0, -1):
        obj = _import_or_skip(".".join(parts[:cut]))
        if obj is None:
            continue
        for attr in parts[cut:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(f"cannot resolve reference {path!r}")


def _parse_value(text: str) -> Any:
    text = text.strip()
    if text.startswith("@"):
        return resolve_reference(text)
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        raise ValueError(f"unparseable binding value {text!r} (expected a Python literal "
                         "or an @dotted.reference)") from None


def _strip_comment(line: str) -> str:
    """Removes a trailing ``#`` comment, but not a ``#`` inside a quoted
    string literal (gin accepts ``NAME = "run#1"``)."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote is not None:
            if c == "\\":
                i += 2
                continue
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#":
            return line[:i]
        i += 1
    return line


def _parse_lines(lines: Iterable[str]) -> List[Tuple[str, Any, str]]:
    out = []
    for raw in lines:
        line = _strip_comment(raw).strip()
        if not line:
            continue
        if "=" not in line:
            raise ValueError(f"binding line without '=': {raw!r}")
        key, value = line.split("=", 1)
        key = key.strip()
        if not key or "." not in key:
            raise ValueError(f"binding target must be 'scope.attr', got {key!r}")
        out.append((key, _parse_value(value), line))
    return out


def parse_bindings(lines: Iterable[str]) -> List[Tuple[str, Any]]:
    return [(key, value) for key, value, _ in _parse_lines(lines)]


def _bind_configurable(name: str, param: str, value: Any) -> None:
    if param not in _CONFIGURABLES[name]:
        raise ValueError(f"{name!r} has no parameter {param!r} "
                         f"(has: {sorted(_CONFIGURABLES[name])})")
    _OVERRIDES[f"{name}.{param}"] = value


def _bind_one(key: str, value: Any) -> None:
    parts = key.split(".")
    # 1) Module-attribute target: longest importable prefix + getattrs.
    for cut in range(len(parts) - 1, 0, -1):
        obj = _import_or_skip(".".join(parts[:cut]))
        if obj is None:
            continue
        for attr in parts[cut:-1]:
            obj = getattr(obj, attr)
        final = parts[-1]
        # 'pkg.mod.build_encoder.param' resolves to the @configurable
        # wrapper: bind the parameter, as the short spelling does.
        cfg_name = getattr(obj, "_configurable_name", None)
        if cfg_name in _CONFIGURABLES and final in _CONFIGURABLES[cfg_name]:
            _bind_configurable(cfg_name, final, value)
            return
        if not hasattr(obj, final):
            raise AttributeError(f"binding target {key!r}: {obj!r} has no attribute {final!r}")
        had_own = final in getattr(obj, "__dict__", {})
        _ATTR_RESTORE.append((obj, final, had_own, getattr(obj, final) if had_own else None))
        setattr(obj, final, value)
        return
    # 2) Configurable-function parameter (short form).
    name, param = ".".join(parts[:-1]), parts[-1]
    if name in _CONFIGURABLES:
        _bind_configurable(name, param, value)
        return
    raise ValueError(f"unknown binding target {key!r}: not an importable module attribute "
                     f"and not a registered configurable (registered: {sorted(_CONFIGURABLES)})")


def apply_bindings(files: Sequence[str] = (), params: Sequence[str] = ()) -> int:
    """Applies bindings from ``files`` then ``params`` (later bindings
    win, as in gin); returns their count."""
    bindings: List[Tuple[str, Any, str]] = []
    for path in files or ():
        with open(path) as f:
            bindings.extend(_parse_lines(f))
    bindings.extend(_parse_lines(params or ()))
    for key, value, line in bindings:
        _bind_one(key, value)
        _APPLIED_LINES.append(line)
    return len(bindings)


def snapshot_bindings() -> List[str]:
    """The binding lines applied so far; ``apply_bindings(params=...)`` of
    them replays the bindings in a fresh process (file contents are
    inlined, so it needs no file)."""
    return list(_APPLIED_LINES)


def clear_bindings() -> None:
    """Reverses every binding: parameter overrides and module-attribute
    assignments (restored in reverse order)."""
    _OVERRIDES.clear()
    _APPLIED_LINES.clear()
    while _ATTR_RESTORE:
        obj, attr, had_own, old = _ATTR_RESTORE.pop()
        if had_own:
            setattr(obj, attr, old)
        else:
            try:
                delattr(obj, attr)
            except AttributeError:
                pass
