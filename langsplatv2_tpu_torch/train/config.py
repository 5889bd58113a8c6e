"""Optimization parameters (port of langsplatv2_tpu/train/config.py:22-102).

A plain copy of the JAX package's `ParamGroup` / `OptimizationParams`
(argparse only): the port may not import the JAX package's copy. Model and
pipeline groups and the persisted config come with the training CLI.
"""
from __future__ import annotations

from argparse import ArgumentParser


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
