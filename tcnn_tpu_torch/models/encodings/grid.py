"""GridEncoding module: Hash / Dense / Tiled multiresolution grids.

PyTorch counterpart of ``tcnn_tpu/models/encodings/grid.py``.  The
table is one flat (n_entries·F,) ``nn.Parameter`` named ``grid``, the
JAX layout, initialised U(±1e-4) (grid.h:1059-1062).  Gradients flow to
the table and, where x requires one, to x, and can be differentiated once
more (``ops/grid_ops.py``: ``GridEncodeFunction``,
``GridEncodeBackwardFunction``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch import nn

from ...common import (GridType, HashType, InterpolationType, Policy,
                      resolve_device)
from ...module import Encoding
from ...ops import grid_ops
from ...registry import register_encoding


class GridEncoding(Encoding):
    def __init__(
        self,
        n_dims_to_encode: int,
        n_levels: int = 16,
        n_features_per_level: int = 2,
        log2_hashmap_size: int = 19,
        base_resolution: int = 16,
        per_level_scale: float = 2.0,
        grid_type: GridType = GridType.HASH,
        hash_type: HashType = HashType.COHERENT_PRIME,
        interpolation: InterpolationType = InterpolationType.LINEAR,
        stochastic_interpolation: bool = False,
        policy: Optional[Policy] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__(policy)
        self.spec = grid_ops.make_grid_spec(
            n_dims=n_dims_to_encode,
            n_levels=n_levels,
            n_features_per_level=n_features_per_level,
            log2_hashmap_size=log2_hashmap_size,
            base_resolution=base_resolution,
            per_level_scale=per_level_scale,
            grid_type=grid_type,
            hash_type=hash_type,
            interpolation=interpolation,
            stochastic_interpolation=stochastic_interpolation,
        )
        self.log2_hashmap_size = log2_hashmap_size
        self.base_resolution = base_resolution
        self.per_level_scale = per_level_scale
        self.n_input_dims = n_dims_to_encode
        self.n_output_dims = self.spec.n_output_dims
        self.max_level: Optional[int] = None  # static level cutoff
        # Initialised on the CPU from the generator, so that a seed gives
        # the same table on every device.
        table = grid_ops.init_grid_params(generator, self.spec, dtype=self.policy.param_dtype)
        self.grid = nn.Parameter(table.reshape(-1).to(resolve_device(device)))

    def param_layout(self) -> Dict[str, str]:
        # The hash table is a "non-matrix" parameter: no L2, the
        # non-matrix learning rate and lazy stepping in Adam
        # (adam.h:76-118; tcnn_tpu/models/encodings/grid.py:76-80).
        return {"grid": "other"}

    def grid_specs(self, prefix: str = "") -> Dict[str, Any]:
        return {prefix + "grid": self.spec}

    def n_params(self) -> int:
        return self.spec.n_params

    def level_params_offset(self, level: int) -> int:
        """Where level ``level``'s parameters start in the flat table
        (tiny-cuda-nn's API for reading one level; past the last level, the
        table's size; ``tcnn_tpu/models/encodings/grid.py:93-96``)."""
        if level >= self.spec.n_levels:
            return self.spec.n_params
        return self.spec.levels[level].offset * self.spec.n_features_per_level

    def level_n_params(self, level: int) -> int:
        return self.spec.levels[level].size * self.spec.n_features_per_level

    def required_output_alignment(self) -> int:
        return self.spec.n_features_per_level

    # SoA (feature-major) output is this encoding's native layout
    # (grid.h:1053-1055); FusedMLP consumes it directly.
    prefers_soa = True

    def forward(self, x: torch.Tensor, soa: bool = False,
                max_level_per_element: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``max_level_per_element``: optional (B,) level fractions, the
        per-sample coarse-to-fine mask (grid.h:69-92;
        ``tcnn_tpu/models/encodings/grid.py:103-118``): sample b uses the
        levels l < frac[b]·n_levels + 1e-3, on the device with kernels G and
        GB (``ops/grid_ops.py::grid_encode``)."""
        table = self.grid
        if self.policy.compute_dtype == torch.bfloat16:
            # bf16 compute copy of the table (trainer.h:68-87), as in the
            # JAX package: the table, not only the output, is rounded.
            table = table.to(torch.bfloat16)
        y = grid_ops.grid_encode(self.spec, table, x, max_level=self.max_level,
                                 soa=soa, max_level_per_element=max_level_per_element)
        return y.to(self.policy.compute_dtype)

    def hyperparams(self) -> Dict[str, Any]:
        return {
            "otype": "Grid",
            "type": self.spec.grid_type.value,
            "n_levels": self.spec.n_levels,
            "n_features_per_level": self.spec.n_features_per_level,
            "log2_hashmap_size": self.log2_hashmap_size,
            "base_resolution": self.base_resolution,
            "per_level_scale": self.per_level_scale,
            "interpolation": self.spec.interpolation.value,
            "hash": self.spec.hash_type.value,
        }


def _make_grid(n_dims: int, cfg: Dict[str, Any], default_type: str = "Hash",
               policy: Optional[Policy] = None, generator=None,
               device=None) -> GridEncoding:
    grid_type = GridType.from_string(cfg.get("type", default_type))
    f = cfg.get("n_features_per_level", 2)
    # "n_features"/"n_grid_features": TOTAL feature count determining
    # n_levels (grid.h:1150-1157); exclusive with "n_levels".
    if "n_features" in cfg or "n_grid_features" in cfg:
        if "n_levels" in cfg:
            raise ValueError(
                "GridEncoding: may not specify n_features and n_levels "
                "simultaneously (one determines the other)")
        n_levels = cfg.get("n_features", cfg.get("n_grid_features")) // f
    else:
        n_levels = cfg.get("n_levels", 16)
    base_resolution = cfg.get("base_resolution", 16)
    # Dense grids default to a scale spanning base->256 over the levels
    # (grid.h:1167); everything else defaults to 2.
    default_scale = (math.exp(math.log(256.0 / base_resolution)
                              / max(n_levels - 1, 1))
                     if grid_type == GridType.DENSE else 2.0)
    return GridEncoding(
        n_dims_to_encode=n_dims,
        n_levels=n_levels,
        n_features_per_level=f,
        log2_hashmap_size=cfg.get("log2_hashmap_size", 19),
        base_resolution=base_resolution,
        per_level_scale=cfg.get("per_level_scale", default_scale),
        grid_type=grid_type,
        hash_type=HashType.from_string(cfg.get("hash", "CoherentPrime")),
        interpolation=InterpolationType.from_string(
            cfg.get("interpolation", "Linear")),
        stochastic_interpolation=cfg.get("stochastic_interpolation", False),
        policy=policy,
        generator=generator,
        device=device,
    )


for _name, _type in (("Grid", "Hash"), ("HashGrid", "Hash"),
                     ("DenseGrid", "Dense"), ("TiledGrid", "Tiled")):
    register_encoding(
        _name, lambda n, cfg, _t=_type, **kw: _make_grid(n, cfg, _t, **kw))
