"""The flag groups and the persisted config (port of
langsplatv2_tpu/train/config.py; reference arguments/__init__.py).

A copy of the JAX package's argparse groups, which the port may not
import: each attribute of a group becomes a flag (a leading underscore
adds a one-letter shorthand), `extract` filters parsed arguments back into
a group, and a trained model directory keeps its configuration
(`save_cfg_args`: the reference's Namespace repr in `cfg_args` and a JSON
copy) for `load_combined_args`, where command-line values win. The flags
and defaults are JAX's but for `--data_device`, whose default is the
reference's "cuda" (JAX's says "tpu"; no path reads it).
"""
from __future__ import annotations

import json
import os
import sys
from argparse import ArgumentParser, Namespace


class GroupParams:
    pass


class ParamGroup:
    """Each attribute becomes a flag; a leading underscore adds a one-letter
    shorthand."""

    def __init__(self, parser: ArgumentParser, name: str,
                 fill_none: bool = False):
        group = parser.add_argument_group(name)
        for key, value in vars(self).items():
            shorthand = key.startswith("_")
            if shorthand:
                key = key[1:]
            t = type(value)
            value = value if not fill_none else None
            flags = ["--" + key] + (["-" + key[0:1]] if shorthand else [])
            if t is bool:
                group.add_argument(*flags, default=value, action="store_true")
            else:
                group.add_argument(*flags, default=value, type=t)

    def extract(self, args) -> GroupParams:
        group = GroupParams()
        for k, v in vars(args).items():
            if k in vars(self) or ("_" + k) in vars(self):
                setattr(group, k, v)
        return group


class ModelParams(ParamGroup):
    def __init__(self, parser: ArgumentParser, sentinel: bool = False):
        self.sh_degree = 3
        self._source_path = ""
        self._model_path = ""
        self._language_features_name = "language_features"
        self._images = "images"
        self._resolution = -1
        self._white_background = False
        self._feature_level = -1
        self.data_device = "cuda"
        self.eval = False
        super().__init__(parser, "Loading Parameters", sentinel)

    def extract(self, args) -> GroupParams:
        g = super().extract(args)
        g.source_path = os.path.abspath(g.source_path)
        g.lf_path = os.path.join(g.source_path, g.language_features_name)
        return g


class PipelineParams(ParamGroup):
    def __init__(self, parser: ArgumentParser):
        self.convert_SHs_python = False
        self.compute_cov3D_python = False
        self.debug = False
        super().__init__(parser, "Pipeline Parameters")


class OptimizationParams(ParamGroup):
    def __init__(self, parser: ArgumentParser):
        self.iterations = 30_000
        self.position_lr_init = 0.00016
        self.position_lr_final = 0.0000016
        self.position_lr_delay_mult = 0.01
        self.position_lr_max_steps = 30_000
        self.feature_lr = 0.0025
        self.opacity_lr = 0.05
        self.language_feature_lr = 0.0025
        self.include_feature = False
        self.quick_render = False
        self.vq_layer_num = 1
        self.codebook_size = 64
        self.scaling_lr = 0.005
        self.rotation_lr = 0.001
        self.percent_dense = 0.01
        self.lambda_dssim = 0.2
        self.densification_interval = 100
        self.opacity_reset_interval = 3000
        self.densify_from_iter = 500
        self.densify_until_iter = 15_000
        self.densify_grad_threshold = 0.0002
        super().__init__(parser, "Optimization Parameters")


def save_cfg_args(model_path: str, args: Namespace) -> None:
    """Write `cfg_args` (the reference's Namespace repr, train.py:281-282)
    and `cfg_args.json` into the model directory."""
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write("Namespace(" + ", ".join(
            f"{k}={v!r}" for k, v in sorted(vars(args).items())) + ")")
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump(vars(args), f, indent=1, default=str)


def load_combined_args(parser: ArgumentParser, argv=None) -> Namespace:
    """The model directory's persisted configuration (`cfg_args.json`, or
    the reference's `cfg_args`) overridden by the command line's non-None
    values (reference get_combined_args, arguments/__init__.py:99-119)."""
    args_cmdline = parser.parse_args(sys.argv[1:] if argv is None else argv)
    merged: dict = {}
    model_path = getattr(args_cmdline, "model_path", None)
    if model_path:
        json_path = os.path.join(model_path, "cfg_args.json")
        legacy_path = os.path.join(model_path, "cfg_args")
        if os.path.exists(json_path):
            with open(json_path) as f:
                merged.update(json.load(f))
        elif os.path.exists(legacy_path):
            with open(legacy_path) as f:
                merged.update(vars(eval(f.read(), {"Namespace": Namespace})))
    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return Namespace(**merged)
