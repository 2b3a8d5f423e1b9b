"""Three-scope dataclass CLI (the port's copy of
:mod:`pixparse_tpu.framework.cli`).

- nested dataclass scopes: ``--infer.batch_size``, ``--task.tokenizer.name`` ...
- dash variants accepted: ``--infer.batch-size``
- ``--config_path file.yaml`` overlays values from a YAML/JSON mapping
  ``{infer: {...}, task: {...}}`` (CLI flags win)
- Optional nested dataclasses are only instantiated when at least one of
  their fields is supplied
- ``Optional[Tuple[float, float]]``-style fields parse from space-separated
  values

Pure stdlib; pyyaml is imported only for ``--config_path``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import typing
from typing import Any, Dict, List, Optional, Sequence, Type


class _Missing:
    def __repr__(self):
        return "<missing>"


MISSING = _Missing()


def _parse_bool(value: str) -> bool:
    v = value.strip().lower()
    if v in ("1", "true", "t", "yes", "y", "on"):
        return True
    if v in ("0", "false", "f", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"invalid bool value: {value!r}")


def _strip_optional(tp):
    """Unwrap Optional[T] -> (T, is_optional)."""
    import types as _types

    origin = typing.get_origin(tp)
    if origin is typing.Union or origin is getattr(_types, "UnionType", ()):
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return tp, False


def _is_dataclass_type(tp) -> bool:
    return isinstance(tp, type) and dataclasses.is_dataclass(tp)


class _FieldSpec:
    def __init__(self, path: List[str], tp, has_default: bool):
        self.path = path  # e.g. ["task", "opt", "learning_rate"]
        self.tp = tp
        self.has_default = has_default

    @property
    def flag(self) -> str:
        return "--" + ".".join(self.path)


def _scalar_parser(tp):
    tp, _ = _strip_optional(tp)
    origin = typing.get_origin(tp)
    if origin in (tuple, list):
        elem_types = typing.get_args(tp)
        if origin is list or (len(elem_types) == 2 and elem_types[1] is Ellipsis):
            elem = elem_types[0] if elem_types else str
            def parse_seq(values: List[str]):
                conv = _elem_converter(elem)
                out = [conv(v) for v in values]
                return out if origin is list else tuple(out)
            return parse_seq, "+"
        def parse_tuple(values: List[str]):
            if len(values) == 1 and "," in values[0]:
                values = [v for v in values[0].split(",") if v]
            if len(values) != len(elem_types):
                raise argparse.ArgumentTypeError(
                    f"expected {len(elem_types)} values, got {len(values)}"
                )
            return tuple(_elem_converter(e)(v) for e, v in zip(elem_types, values))
        return parse_tuple, "+"
    return (lambda vs: _elem_converter(tp)(vs[0])), 1


def _elem_converter(tp):
    if tp is bool:
        return _parse_bool
    if tp in (int, float, str):
        return tp
    if tp is Any or tp is type(None):
        return str
    if _is_dataclass_type(tp):
        raise TypeError("dataclass fields handled structurally, not as scalars")
    if tp is dict or typing.get_origin(tp) is dict:
        return json.loads
    return str


def _collect_fields(cls: Type, path: List[str], out: List[_FieldSpec]):
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        tp = hints[f.name]
        inner, _is_opt = _strip_optional(tp)
        if _is_dataclass_type(inner):
            _collect_fields(inner, path + [f.name], out)
        else:
            has_default = (
                f.default is not dataclasses.MISSING
                or f.default_factory is not dataclasses.MISSING  # type: ignore[misc]
            )
            out.append(_FieldSpec(path + [f.name], tp, has_default))


def _assign(tree: Dict, path: List[str], value):
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def _lookup(tree: Dict, path: List[str]):
    node = tree
    for key in path:
        if not isinstance(node, dict) or key not in node:
            return MISSING
        node = node[key]
    return node


def _instantiate(cls: Type, values: Dict, where: str, required_root: bool = True):
    """Build a dataclass from a nested value dict, recursing into children.

    Optional dataclass fields stay None unless values were provided for them.
    Missing required scalars raise a flag-named error.
    """
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        tp = hints[f.name]
        inner, is_opt = _strip_optional(tp)
        provided = values.get(f.name, MISSING)
        if _is_dataclass_type(inner):
            child_values = provided if isinstance(provided, dict) else {}
            if is_opt and not child_values:
                # keep default (usually None)
                if f.default is not dataclasses.MISSING:
                    kwargs[f.name] = f.default
                elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
                    kwargs[f.name] = f.default_factory()  # type: ignore[misc]
                else:
                    kwargs[f.name] = None
                continue
            kwargs[f.name] = _instantiate(inner, child_values, f"{where}.{f.name}")
            continue
        if provided is not MISSING:
            # YAML gives lists where the field wants a tuple
            if isinstance(provided, list) and typing.get_origin(inner) is tuple:
                provided = tuple(provided)
            kwargs[f.name] = provided
        elif f.default is not dataclasses.MISSING:
            kwargs[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            kwargs[f.name] = f.default_factory()  # type: ignore[misc]
        else:
            raise SystemExit(
                f"error: missing required argument --{where}.{f.name}"
            )
    return cls(**kwargs)


def peek_flag(argv, dotted: str):
    """Pre-parse peek at one ``--scope.field`` flag (dash variants and
    ``=``-joined forms), used by the apps to pick the task cfg class before
    building the full parser."""
    names = {f"--{dotted}", f"--{dotted.replace('_', '-')}"}
    for i, a in enumerate(argv):
        if a in names and i + 1 < len(argv):
            return argv[i + 1]
        for n in names:
            if a.startswith(n + "="):
                return a.split("=", 1)[1]
    return None


def _validate_tree(cls: Type, values: Dict, where: str):
    """Reject config-file keys that match no dataclass field (silent typo'd
    overrides are worse than errors)."""
    hints = typing.get_type_hints(cls)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, val in values.items():
        if key not in fields:
            raise SystemExit(
                f"error: unknown config key '{where}.{key}' "
                f"(known: {sorted(fields)})"
            )
        inner, _ = _strip_optional(hints[key])
        if _is_dataclass_type(inner):
            if val is not None and not isinstance(val, dict):
                raise SystemExit(
                    f"error: config key '{where}.{key}' must be a mapping"
                )
            if isinstance(val, dict):
                _validate_tree(inner, val, f"{where}.{key}")


class ConfigArgumentParser:
    """Parser over named dataclass scopes (train/task/data...)."""

    def __init__(self, description: str = ""):
        self._scopes: Dict[str, Type] = {}
        self.description = description

    def add_arguments(self, cls: Type, dest: str):
        self._scopes[dest] = cls

    def parse_args(self, argv: Optional[Sequence[str]] = None):
        parser = argparse.ArgumentParser(
            description=self.description, allow_abbrev=False
        )
        parser.add_argument("--config_path", "--config-path", default=None,
                            help="YAML/JSON file with {scope: {field: value}} overrides")
        specs: List[_FieldSpec] = []
        for dest, cls in self._scopes.items():
            _collect_fields(cls, [dest], specs)
        for spec in specs:
            parse_fn, nargs = _scalar_parser(spec.tp)
            dotted = ".".join(spec.path)
            dashed = dotted.replace("_", "-")
            names = [f"--{dotted}"]
            if dashed != dotted:
                names.append(f"--{dashed}")
            parser.add_argument(
                *names,
                dest=dotted,
                nargs=nargs if nargs != 1 else None,
                default=MISSING,
                metavar=spec.path[-1].upper(),
            )
        ns = parser.parse_args(argv)

        # Layer 1: config file
        tree: Dict[str, Any] = {}
        if ns.config_path:
            import yaml

            with open(ns.config_path) as fh:
                loaded = yaml.safe_load(fh) or {}
            if not isinstance(loaded, dict):
                raise SystemExit(f"error: config file {ns.config_path} must be a mapping")
            for scope, values in loaded.items():
                if scope not in self._scopes:
                    raise SystemExit(
                        f"error: unknown config scope '{scope}' "
                        f"(known: {sorted(self._scopes)})"
                    )
                if not isinstance(values, dict):
                    raise SystemExit(f"error: config scope '{scope}' must be a mapping")
                _validate_tree(self._scopes[scope], values, scope)
            tree.update(loaded)

        # Layer 2: CLI flags (win over file)
        for spec in specs:
            dotted = ".".join(spec.path)
            raw = getattr(ns, dotted)
            if raw is MISSING:
                continue
            parse_fn, nargs = _scalar_parser(spec.tp)
            value = parse_fn(raw if isinstance(raw, list) else [raw])
            _assign(tree, spec.path, value)

        # Instantiate each scope
        result = argparse.Namespace()
        for dest, cls in self._scopes.items():
            scope_values = tree.get(dest, {})
            setattr(result, dest, _instantiate(cls, scope_values, dest))
        return result
