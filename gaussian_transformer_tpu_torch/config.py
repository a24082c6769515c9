"""Config / flag system (port of ``gaussian_transformer_tpu/config.py``).

Declarative param groups (model, pipeline, optimization) whose attributes
become argparse options (a leading ``_`` adds a one-letter alias), the
reference's defaults (``sh_degree=1``),
and ``cfg_args`` persistence merged under the CLI. ``data_device`` is a torch
device string. The persisted ``Namespace(...)`` string is parsed with ``ast``,
never ``eval``.
"""

from __future__ import annotations

import ast
import dataclasses
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


class PipelineParams(ParamGroup):
    """The reference's pipeline flags, accepted by ``cli.train`` and
    ``cli.render`` as the reference's scripts accept them. The stream renderer
    has no Python-side SH or covariance path and no debug mode, so they change
    nothing, as in the JAX package."""

    def __init__(self, parser):
        self.convert_SHs_python = False
        self.compute_cov3D_python = False
        self.debug = False
        super().__init__(parser, "Pipeline Parameters")


@dataclasses.dataclass(frozen=True)
class OptConfig:
    """The full 3DGS optimization schedule (the reference's defaults); the
    one place they are written."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 500
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 100
    densify_until_iter: int = 10_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False

    @staticmethod
    def from_args(args) -> "OptConfig":
        fields = {f.name for f in dataclasses.fields(OptConfig)}
        return OptConfig(**{k: v for k, v in vars(args).items() if k in fields})


class OptimizationParams(ParamGroup):
    """``OptConfig``'s fields as flags, with its defaults."""

    def __init__(self, parser):
        for f in dataclasses.fields(OptConfig):
            setattr(self, f.name, f.default)
        super().__init__(parser, "Optimization Parameters")


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
