"""Typed flag registry (port copy of ``citlab_as_tpu/config/flags.py``; the
reference's python_util/basic/flags.py, the config system of every
reference component).

Typed ``define_*`` registrations on a registry's parser, args-from-file
via ``@path/to/config`` with ``#`` comments and optional ``=`` separators
(:class:`LineArgumentParser`), ``define_dict`` parsing ``key=value`` pairs
with bool/number/list coercion, ``parse_dict_flag`` for the one-argument
form, and ``update_params`` merging user dicts into per-component defaults
with unknown-key warnings. The registry is instantiable (:class:`Flags`)
so tests build isolated ones; ``FLAGS`` is the module-level default.
Printed output and parsed values equal the JAX module's.
"""
from __future__ import annotations

import argparse
import logging
from typing import Any, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)


class LineArgumentParser(argparse.ArgumentParser):
    """Args-from-file parser: each line may hold ``name value`` or
    ``name = value``; ``#`` starts a comment (flags.py:10-36)."""

    def convert_arg_line_to_args(self, arg_line):
        args = arg_line.split()
        out = []
        for arg in args:
            if arg.startswith("#"):
                break
            if arg == "=":
                continue
            out.append(arg)
        return out


def _coerce_scalar(v: str) -> Any:
    """bool/int/float/str coercion used by dict-valued flags (flags.py:229-287)."""
    if v.lower() in ("true", "t"):
        return True
    if v.lower() in ("false", "f"):
        return False
    try:
        f = float(v)
        i = int(f)
        return i if i == f else f
    except ValueError:
        return v


def _parse_dict_value(val: str) -> Any:
    s = val.strip()
    if len(s) >= 2 and s[0] == "[" and s[-1] == "]":
        out = []
        for element in s[1:-1].split(","):
            element = element.strip()
            if element == "":
                continue
            out.append(_coerce_scalar(element))
        return out
    return _coerce_scalar(s)


def parse_dict_flag(spec: str) -> Dict[str, Any]:
    """Parse a single 'key=value[,key=value...]' string into a coerced dict
    (the one-argument form of the define_dict syntax; list values are not
    supported here — use define_dict's space-separated pairs for those)."""
    out: Dict[str, Any] = {}
    for kv in spec.split(","):
        kv = kv.strip()
        if not kv:
            continue
        key, sep, val = kv.partition("=")
        if not sep:
            raise ValueError(f"expected key=value, got {kv!r}")
        out[key.strip()] = _parse_dict_value(val)
    return out


class _StoreDictKeyPair(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        current = getattr(namespace, self.dest, None)
        if not current:
            current = {}
            setattr(namespace, self.dest, current)
        for kv in values:
            parts = kv.split("=")
            if len(parts) == 2:
                current[parts[0]] = _parse_dict_value(parts[1])


class _StoreList(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, list(values))


class Flags:
    """A flag registry + value store. Attribute access returns parsed values,
    triggering a parse of sys.argv on first use (flags.py:59-92)."""

    def __init__(self):
        usage = (
            "%(prog)s [OPTIONS] [@CONFIG]\n"
            "Add options via '--OPTION VALUE'; reference config files via '@path/to/config'"
        )
        self.__dict__["_parser"] = LineArgumentParser(
            usage=usage, fromfile_prefix_chars="@")
        self.__dict__["_values"] = {}
        self.__dict__["_parsed"] = False

    # -- registration --------------------------------------------------
    @property
    def parser(self) -> LineArgumentParser:
        return self.__dict__["_parser"]

    def define_string(self, name, default, docstring, metavar="STR"):
        self.parser.add_argument("--" + name, default=default, help=docstring,
                                 type=str, metavar=metavar)

    def define_integer(self, name, default, docstring, metavar="INT"):
        self.parser.add_argument("--" + name, default=default, help=docstring,
                                 type=int, metavar=metavar)

    def define_float(self, name, default, docstring, metavar="FLOAT"):
        self.parser.add_argument("--" + name, default=default, help=docstring,
                                 type=float, metavar=metavar)

    def define_boolean(self, name, default, docstring, metavar="BOOL"):
        def str2bool(v):
            if isinstance(v, bool):
                return v
            return v.lower() in ("true", "t", "1", "yes")
        self.parser.add_argument("--" + name, default=default, help=docstring,
                                 type=str2bool, metavar=metavar)

    def define_list(self, name, default, docstring, flag_type=str, metavar="LIST"):
        self.parser.add_argument("--" + name, nargs="*", type=flag_type,
                                 default=default, help=docstring,
                                 metavar=metavar, action=_StoreList)

    def define_choices(self, name, choices, default, flag_type, docstring, metavar="CHOICE"):
        self.parser.add_argument("--" + name, type=flag_type, default=default,
                                 choices=choices, metavar=metavar, help=docstring)

    def define_dict(self, name, default, docstring):
        self.parser.add_argument("--" + name, action=_StoreDictKeyPair,
                                 default=default, nargs="*",
                                 metavar="KEY=VAL", help=docstring)

    # -- parsing & access ----------------------------------------------
    def parse_flags(self, args: Optional[Sequence[str]] = None) -> List[str]:
        result, unparsed = self.parser.parse_known_args(args=args)
        self.__dict__["_values"].update(vars(result))
        self.__dict__["_parsed"] = True
        return unparsed

    def has_key(self, name: str) -> bool:
        return name in self.__dict__["_values"]

    hasKey = has_key  # reference-compatible alias

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if not self.__dict__["_parsed"]:
            self.parse_flags()
        if name not in self.__dict__["_values"]:
            raise AttributeError(name)
        return self.__dict__["_values"][name]

    def __setattr__(self, name, value):
        self.__dict__["_values"][name] = value

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__["_values"])


FLAGS = Flags()


def reset_flags() -> Flags:
    """Replace the global registry (test isolation / double-parse patterns)."""
    global FLAGS
    FLAGS = Flags()
    return FLAGS


def define_string(name, default, docstring, metavar="STR"):
    FLAGS.define_string(name, default, docstring, metavar)


def define_integer(name, default, docstring, metavar="INT"):
    FLAGS.define_integer(name, default, docstring, metavar)


def define_float(name, default, docstring, metavar="FLOAT"):
    FLAGS.define_float(name, default, docstring, metavar)


def define_boolean(name, default, docstring, metavar="BOOL"):
    FLAGS.define_boolean(name, default, docstring, metavar)


def define_list(name, default, docstring, flag_type=str, metavar="LIST"):
    FLAGS.define_list(name, default, docstring, flag_type, metavar)


def define_choices(name, choices, default, flag_type, docstring, metavar="CHOICE"):
    FLAGS.define_choices(name, choices, default, flag_type, docstring, metavar)


def define_dict(name, default, docstring):
    FLAGS.define_dict(name, default, docstring)


def print_flags(flags: Optional[Flags] = None) -> None:
    flags = flags if flags is not None else FLAGS
    print("FLAGS:")
    for key, value in flags.as_dict().items():
        print(f"  {key} = {value}")


def update_params(class_params: Dict[str, Any], flag_params: Dict[str, Any],
                  name: str = "", print_params: bool = False) -> Dict[str, Any]:
    """Merge a user-supplied dict into a component's default params, warning
    on unknown keys (flags.py:303-333). Every model component (graph_params,
    clustering_params, ...) is configured through this."""
    if print_params:
        print(f"---{name}---")
        print(f"available {name}_params:")
        for k, v in class_params.items():
            print(f"  {k}: {v}")
        print(f"passed FLAGS.{name}_params:")
        for k, v in flag_params.items():
            print(f"  {k}: {v}")
    for key in flag_params:
        if key not in class_params:
            logging.critical(
                "Given %s_params-key '%s' is not used by %s-class!", name, key, name)
    class_params.update(flag_params)
    if print_params:
        print(f"updated {name}_params:")
        for k, v in class_params.items():
            print(f"  {k}: {v}")
    return class_params
