"""Config / flag system (port of ``gaussian_transformer_tpu/config.py``).

Declarative param groups whose attributes become argparse options (a leading
``_`` adds a one-letter alias), the reference's defaults (``sh_degree=1``),
and ``cfg_args`` persistence merged under the CLI. ``data_device`` is a torch
device string. The persisted ``Namespace(...)`` string is parsed with ``ast``,
never ``eval``.
"""

from __future__ import annotations

import ast
import os
import sys
from argparse import ArgumentParser, Namespace


class GroupParams:
    pass


class ParamGroup:
    """Each attribute set in a subclass ``__init__`` becomes an option whose
    type/default come from the assigned value; bools become ``store_true``;
    ``fill_none`` registers every default as None (how get_combined_args
    tells "flag given" from "default")."""

    def __init__(self, parser: ArgumentParser, name: str, fill_none: bool = False):
        self._spec = {}  # public flag name -> declared attr name
        group = parser.add_argument_group(name)
        for attr, default in list(vars(self).items()):
            if attr == "_spec":
                continue
            flag = attr[1:] if attr.startswith("_") else attr  # strip exactly one _
            self._spec[flag] = attr
            names = [f"--{flag}"] + ([f"-{flag[0]}"] if attr.startswith("_") else [])
            opts = {"default": None if fill_none else default}
            if isinstance(default, bool):
                opts["action"] = "store_true"
            else:
                opts["type"] = type(default)
            group.add_argument(*names, **opts)

    def extract(self, args) -> GroupParams:
        """Pull this group's flags out of a parsed (or merged) namespace."""
        group = GroupParams()
        for key, value in vars(args).items():
            if key in self._spec:
                setattr(group, key, value)
        return group


class ModelParams(ParamGroup):
    """Loading parameters (sh_degree default is the fork's 1)."""

    def __init__(self, parser, sentinel: bool = False):
        self.sh_degree = 1
        self._source_path = ""
        self._model_path = ""
        self._images = "images"
        self._resolution = -1
        self._white_background = False
        self.data_device = "cuda"
        self.eval = False
        super().__init__(parser, "Loading Parameters", sentinel)

    def extract(self, args) -> GroupParams:
        g = super().extract(args)
        g.source_path = os.path.abspath(g.source_path)
        return g


def _parse_namespace_literal(text: str) -> Namespace:
    """Safely parse a persisted ``Namespace(key=value, ...)`` repr."""
    tree = ast.parse(text.strip(), mode="eval")
    call = tree.body
    if not (isinstance(call, ast.Call) and getattr(call.func, "id", "") == "Namespace"):
        raise ValueError("cfg_args is not a Namespace(...) literal")
    kwargs = {kw.arg: ast.literal_eval(kw.value) for kw in call.keywords}
    return Namespace(**kwargs)


def get_combined_args(parser: ArgumentParser, argv=None) -> Namespace:
    """CLI args merged OVER the persisted cfg_args in --model_path."""
    cmdline = sys.argv[1:] if argv is None else argv
    args_cmdline = parser.parse_args(cmdline)

    cfgfile_string = "Namespace()"
    try:
        cfgfilepath = os.path.join(args_cmdline.model_path, "cfg_args")
        print("Looking for config file in", cfgfilepath)
        with open(cfgfilepath) as cfg_file:
            print("Config file found: {}".format(cfgfilepath))
            cfgfile_string = cfg_file.read()
    except (TypeError, FileNotFoundError):
        print("Config file not found")
    args_cfgfile = _parse_namespace_literal(cfgfile_string)

    merged = vars(args_cfgfile).copy()
    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return Namespace(**merged)


def save_cfg_args(model_path: str, args) -> None:
    """Persist the run config as ``<model_path>/cfg_args``."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(str(Namespace(**vars(args))))
