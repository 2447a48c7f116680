"""Parameter-free and composite encodings: OneBlob and Composite.

PyTorch counterpart of ``tcnn_tpu/models/encodings/basic.py`` (OneBlob
:118-156, Composite :264-356, their registrations :371-386), the
encodings of ``configs/config_btf.json``: a 4-D hash grid on the first
dims and OneBlob on the rest.  Both are plain PyTorch on every device:
the JAX package wrote no kernel for them (they fuse into neighbouring
ops under XLA), and on the card their cost beside the grid and the MLP
is a few elementwise launches.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ...common import Policy, ReductionType, resolve_device
from ...module import Encoding
from ...registry import register_encoding


def _quartic_cdf(x: torch.Tensor, inv_radius: float) -> torch.Tensor:
    """CDF of the quartic kernel (common_device.h:915-920), the JAX
    package's fp32 operations in the same order."""
    u = x * inv_radius
    u2 = u * u
    u4 = u2 * u2
    return torch.clamp((15.0 / 16.0) * u * (1 - (2.0 / 3.0) * u2 + (1.0 / 5.0) * u4)
                       + 0.5, 0.0, 1.0)


class OneBlobEncoding(Encoding):
    """OneBlob encoding with wraparound (oneblob.h:98-127).

    out[d, k] = C((k+1)/n − x_d) − C(k/n − x_d) with
    C(t) = Q(t) + Q(t−1) + Q(t+1), Q the quartic-kernel CDF of inverse
    radius n_bins.  The output has the input's dtype, as in JAX.  The bin
    boundaries are made on the input's device at each call, so that a
    step captured in a CUDA graph copies nothing from the host.
    """

    def __init__(self, n_bins: int, n_dims_to_encode: int,
                 policy: Optional[Policy] = None, device=None):
        super().__init__(policy)
        resolve_device(device)   # no parameters, but the same contract
        self.n_bins = int(n_bins)
        self.n_input_dims = n_dims_to_encode
        self.n_output_dims = n_dims_to_encode * self.n_bins

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n_bins
        boundaries = torch.arange(n + 1, dtype=x.dtype, device=x.device) / n
        t = boundaries - x[..., :, None]                      # (B, D, n+1)
        cdf = _quartic_cdf(t, n) + _quartic_cdf(t - 1.0, n) + _quartic_cdf(t + 1.0, n)
        out = cdf[..., 1:] - cdf[..., :-1]                    # (B, D, n)
        return out.reshape(x.shape[0], self.n_output_dims)

    def hyperparams(self) -> Dict[str, Any]:
        return {"otype": "OneBlob", "n_bins": self.n_bins}


class CompositeEncoding(Encoding):
    """Nested encodings on slices of the input (composite.h:135-230).

    Dim assignment follows the reference: each nested config may give
    ``n_dims_to_encode`` (and ``dims_to_encode_begin``); at most one may
    leave it out and takes the remaining dims.  Reduction is
    Concatenation (default), Sum or Product; Sum and Product need equal
    nested widths.

    The nested encodings are the submodules ``"0"``, ``"1"``, ..., so
    that a parameter's name is its path in the JAX tree, a tuple of the
    nested parameters (``encoding.0.grid``).  Each gets its slice of x as
    a view; the grid kernels read it in place.  Concatenation casts each
    nested output to the policy's compute dtype before joining them: JAX
    joins the bf16 grid features and OneBlob's fp32 ones in fp32, and the
    network then rounds them to bf16 once, which gives the same values,
    so the port hands the MLP half the bytes.  Sum and Product keep JAX's
    type promotion.  Composite has no SoA output: the network takes it
    (B, n_output_dims), as in JAX.
    """

    def __init__(self, nested_cfgs: List[Dict[str, Any]], n_dims_to_encode: int,
                 reduction: str = "Concatenation", policy: Optional[Policy] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(policy)
        from ...config import create_encoding   # config imports this module

        device = resolve_device(device)
        self.reduction = ReductionType.from_string(reduction)
        self.n_input_dims = n_dims_to_encode

        total_specified = sum(int(c.get("n_dims_to_encode", 0)) for c in nested_cfgs)
        any_begin = any("dims_to_encode_begin" in c for c in nested_cfgs)
        unspecified = None if any_begin else n_dims_to_encode - total_specified
        if unspecified is not None and unspecified < 0:
            raise ValueError("Composite: nested encodings encode more dims than available")

        self.nested: List[Encoding] = []
        self.slices: List[tuple] = []   # (begin, n_dims)
        offset = 0
        for c in nested_cfgs:
            if "n_dims_to_encode" in c:
                if "dims_to_encode_begin" in c:
                    offset = int(c["dims_to_encode_begin"])
                nd = int(c["n_dims_to_encode"])
            else:
                if unspecified is None:
                    raise ValueError(
                        "Composite: may only leave 'n_dims_to_encode' unspecified "
                        "for a single nested encoding")
                nd = unspecified
                unspecified = None
            if nd > 0:
                enc = create_encoding(nd, c, policy=policy, generator=generator,
                                      device=device)
                self.add_module(str(len(self.nested)), enc)
                self.nested.append(enc)
                self.slices.append((offset, nd))
            offset += nd

        widths = [e.n_output_dims for e in self.nested]
        if self.reduction == ReductionType.CONCATENATION:
            self.n_output_dims = sum(widths)
        else:
            if len(set(widths)) > 1:
                raise ValueError(
                    f"Composite({self.reduction.value}): nested output widths "
                    f"must match, got {widths}")
            self.n_output_dims = widths[0] if widths else 0

    def param_layout(self) -> Dict[str, str]:
        return {f"{i}.{n}": k for i, e in enumerate(self.nested)
                for n, k in e.param_layout().items()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [enc(x[:, begin:begin + nd])
                for enc, (begin, nd) in zip(self.nested, self.slices)]
        if self.reduction == ReductionType.CONCATENATION:
            if not outs:
                return x.new_zeros((x.shape[0], 0))
            cdt = self.policy.compute_dtype
            return torch.cat([o.to(cdt) for o in outs], dim=1)
        acc = outs[0]
        for o in outs[1:]:
            acc = acc + o if self.reduction == ReductionType.SUM else acc * o
        return acc

    def hyperparams(self) -> Dict[str, Any]:
        return {
            "otype": "Composite",
            "reduction": self.reduction.value,
            "nested": [e.hyperparams() for e in self.nested],
        }


register_encoding(
    "OneBlob",
    lambda n_dims, cfg, policy=None, device=None, **kw: OneBlobEncoding(
        cfg.get("n_bins", 16), n_dims, policy=policy, device=device))
register_encoding(
    "Composite",
    lambda n_dims, cfg, **kw: CompositeEncoding(
        cfg["nested"], n_dims, cfg.get("reduction", "Concatenation"), **kw))
