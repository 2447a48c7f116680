"""Parameter-free and composite encodings.

PyTorch counterpart of ``tcnn_tpu/models/encodings/basic.py``: Identity
(:32-53), Frequency (:56-87), TriangleWave (:90-115), OneBlob (:118-156),
SphericalHarmonics (:167-238), Empty (:241-262), Composite (:264-356) and
their registrations with the NRC / OneBlobFrequency alias (:359-399).
They are plain PyTorch on every device, the JAX package's jnp operations
in the same order: the JAX package wrote no kernel for them (they fuse
into neighbouring ops under XLA), and on the card their cost beside the
grid and the MLP is a few elementwise launches.  Each output has its
input's dtype, as in JAX.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from ...common import Policy, ReductionType, resolve_device
from ...module import Encoding
from ...registry import register_encoding


class _Elementwise(Encoding):
    """An encoding without parameters: the device only fixes the contract
    (``None`` means ``cuda`` and raises without one)."""

    def __init__(self, n_dims_to_encode: int, n_output_dims: int,
                 policy: Optional[Policy] = None, device=None):
        super().__init__(policy)
        resolve_device(device)
        self.n_input_dims = n_dims_to_encode
        self.n_output_dims = n_output_dims


class IdentityEncoding(_Elementwise):
    """y = x · scale + offset (identity.h:45-85)."""

    def __init__(self, n_dims_to_encode: int, scale: float = 1.0, offset: float = 0.0,
                 policy: Optional[Policy] = None, device=None):
        super().__init__(n_dims_to_encode, n_dims_to_encode, policy, device)
        self.scale = float(scale)
        self.offset = float(offset)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale + self.offset

    def hyperparams(self) -> Dict[str, Any]:
        return {"otype": "Identity", "scale": self.scale, "offset": self.offset}


class FrequencyEncoding(_Elementwise):
    """NeRF positional encoding (frequency.h:45-103): per input dim d and
    frequency k, out[d·2F + 2k] = sin(2^k π x_d) and out[d·2F + 2k + 1] =
    cos(2^k π x_d), dim-major as in the reference."""

    def __init__(self, n_frequencies: int, n_dims_to_encode: int,
                 policy: Optional[Policy] = None, device=None):
        super().__init__(n_dims_to_encode, n_dims_to_encode * int(n_frequencies) * 2,
                         policy, device)
        self.n_frequencies = int(n_frequencies)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # 2^k exactly, made on x's device (no copy from the host)
        freqs = torch.exp2(torch.arange(self.n_frequencies, dtype=x.dtype, device=x.device))
        phase = x[..., :, None] * freqs * math.pi               # (B, D, F)
        out = torch.stack([torch.sin(phase), torch.cos(phase)], dim=-1)
        return out.reshape(x.shape[0], self.n_output_dims)

    def hyperparams(self) -> Dict[str, Any]:
        return {"otype": "Frequency", "n_frequencies": self.n_frequencies}


class TriangleWaveEncoding(_Elementwise):
    """Triangle-wave encoding (triangle_wave.h:46-109; the NRC paper): per
    dim d and frequency k, v = x_d·2^(k−1) + k/4 and out = |frac(v) − 0.5|·4 − 1."""

    def __init__(self, n_frequencies: int, n_dims_to_encode: int,
                 policy: Optional[Policy] = None, device=None):
        super().__init__(n_dims_to_encode, n_dims_to_encode * int(n_frequencies),
                         policy, device)
        self.n_frequencies = int(n_frequencies)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ks = torch.arange(self.n_frequencies, dtype=x.dtype, device=x.device)
        scaled = x[..., :, None] * torch.pow(2.0, ks - 1.0)   # (B, D, F)
        val = scaled + ks * 0.25
        frac = val - torch.floor(val)
        out = torch.abs(frac - 0.5) * 4.0 - 1.0
        return out.reshape(x.shape[0], self.n_output_dims)

    def hyperparams(self) -> Dict[str, Any]:
        return {"otype": "TriangleWave", "n_frequencies": self.n_frequencies}


def _quartic_cdf(x: torch.Tensor, inv_radius: float) -> torch.Tensor:
    """CDF of the quartic kernel (common_device.h:915-920), the JAX
    package's fp32 operations in the same order."""
    u = x * inv_radius
    u2 = u * u
    u4 = u2 * u2
    return torch.clamp((15.0 / 16.0) * u * (1 - (2.0 / 3.0) * u2 + (1.0 / 5.0) * u4)
                       + 0.5, 0.0, 1.0)


class OneBlobEncoding(_Elementwise):
    """OneBlob encoding with wraparound (oneblob.h:98-127).

    out[d, k] = C((k+1)/n − x_d) − C(k/n − x_d) with
    C(t) = Q(t) + Q(t−1) + Q(t+1), Q the quartic-kernel CDF of inverse
    radius n_bins.  The output has the input's dtype, as in JAX.  The bin
    boundaries are made on the input's device at each call, so that a
    step captured in a CUDA graph copies nothing from the host.
    """

    def __init__(self, n_bins: int, n_dims_to_encode: int,
                 policy: Optional[Policy] = None, device=None):
        super().__init__(n_dims_to_encode, n_dims_to_encode * int(n_bins), policy, device)
        self.n_bins = int(n_bins)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n_bins
        boundaries = torch.arange(n + 1, dtype=x.dtype, device=x.device) / n
        t = boundaries - x[..., :, None]                      # (B, D, n+1)
        cdf = _quartic_cdf(t, n) + _quartic_cdf(t - 1.0, n) + _quartic_cdf(t + 1.0, n)
        out = cdf[..., 1:] - cdf[..., :-1]                    # (B, D, n)
        return out.reshape(x.shape[0], self.n_output_dims)

    def hyperparams(self) -> Dict[str, Any]:
        return {"otype": "OneBlob", "n_bins": self.n_bins}


def _double_factorial(n: int) -> float:
    r = 1.0
    while n > 1:
        r *= n
        n -= 2
    return r


class SphericalHarmonicsEncoding(_Elementwise):
    """Real spherical harmonics of a direction (spherical_harmonics.h:63-98;
    the polynomials of common_device.h:339-418).

    The input is 3-D in [0, 1]^3, mapped to v = 2u − 1 in [−1, 1]^3; the
    output is degree² coefficients, i = l(l+1) + m, Condon-Shortley phase
    included.  Evaluated, as in the JAX package, by the associated-Legendre
    recurrence in the same order of operations (basic.py:199-234), not by
    the reference's generated polynomials: both agree on the unit sphere,
    which is SH's contract.  Autograd gives the gradient that
    common_device.h:420-629 writes by hand.
    """

    def __init__(self, degree: int, n_dims_to_encode: int = 3,
                 policy: Optional[Policy] = None, device=None):
        if n_dims_to_encode != 3:
            raise ValueError("SphericalHarmonics requires 3 input dims")
        if not 1 <= degree <= 8:
            raise ValueError(f"SH degree must be in [1, 8], got {degree}")
        super().__init__(3, int(degree) ** 2, policy, device)
        self.degree = int(degree)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        x = v[:, 0] * 2.0 - 1.0
        y = v[:, 1] * 2.0 - 1.0
        z = v[:, 2] * 2.0 - 1.0
        L = self.degree
        # A_m = Re((x+iy)^m), B_m = Im((x+iy)^m): sin^m(θ)·{cos, sin}(mφ)
        A = [torch.ones_like(x)]
        B = [torch.zeros_like(x)]
        for m in range(1, L):
            a_prev, b_prev = A[m - 1], B[m - 1]
            A.append(x * a_prev - y * b_prev)
            B.append(x * b_prev + y * a_prev)
        # Semi-normalised associated Legendre P̂_l^m = P_l^m / sin^m(θ), a
        # polynomial in z, with the Condon-Shortley phase.
        P: Dict[tuple, torch.Tensor] = {}
        for m in range(0, L):
            pmm = ((-1.0) ** m) * _double_factorial(2 * m - 1)
            P[(m, m)] = torch.full_like(z, pmm) if m > 0 else torch.ones_like(z)
            if m + 1 < L:
                P[(m + 1, m)] = z * (2 * m + 1) * P[(m, m)]
            for l in range(m + 2, L):
                P[(l, m)] = ((2 * l - 1) * z * P[(l - 1, m)]
                             - (l + m - 1) * P[(l - 2, m)]) / (l - m)
        outs: List[Optional[torch.Tensor]] = [None] * (L * L)
        for l in range(L):
            for m in range(0, l + 1):
                k = math.sqrt((2 * l + 1) / (4 * math.pi)
                              * math.factorial(l - m) / math.factorial(l + m))
                if m == 0:
                    outs[l * (l + 1)] = k * P[(l, 0)]
                else:
                    sk = math.sqrt(2.0) * k
                    outs[l * (l + 1) + m] = sk * A[m] * P[(l, m)]
                    outs[l * (l + 1) - m] = sk * B[m] * P[(l, m)]
        return torch.stack(outs, dim=-1)

    def hyperparams(self) -> Dict[str, Any]:
        return {"otype": "SphericalHarmonics", "degree": self.degree}


class EmptyEncoding(_Elementwise):
    """Consumes its inputs and emits nothing (empty.h:46-90): useful inside
    Composite to drop dimensions."""

    def __init__(self, n_dims_to_encode: int, policy: Optional[Policy] = None, device=None):
        super().__init__(n_dims_to_encode, 0, policy, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.new_zeros((x.shape[0], 0))

    def hyperparams(self) -> Dict[str, Any]:
        return {"otype": "Empty"}


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

    def grid_specs(self, prefix: str = "") -> Dict[str, Any]:
        out = {}
        for i, e in enumerate(self.nested):
            out.update(e.grid_specs(f"{prefix}{i}."))
        return out

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
    ["Identity", "Linear"],
    lambda n_dims, cfg, policy=None, device=None, **kw: IdentityEncoding(
        n_dims, cfg.get("scale", 1.0), cfg.get("offset", 0.0), policy=policy, device=device))
register_encoding(
    ["Frequency", "PositionalEncoding", "NeRFEncoding"],
    lambda n_dims, cfg, policy=None, device=None, **kw: FrequencyEncoding(
        cfg.get("n_frequencies", 12), n_dims, policy=policy, device=device))
register_encoding(
    "TriangleWave",
    lambda n_dims, cfg, policy=None, device=None, **kw: TriangleWaveEncoding(
        cfg.get("n_frequencies", 12), n_dims, policy=policy, device=device))
register_encoding(
    "OneBlob",
    lambda n_dims, cfg, policy=None, device=None, **kw: OneBlobEncoding(
        cfg.get("n_bins", 16), n_dims, policy=policy, device=device))
register_encoding(
    ["SphericalHarmonics", "SH"],
    lambda n_dims, cfg, policy=None, device=None, **kw: SphericalHarmonicsEncoding(
        cfg.get("degree", 4), n_dims, policy=policy, device=device))
register_encoding(
    ["Empty", "Zero", "None"],
    lambda n_dims, cfg, policy=None, device=None, **kw: EmptyEncoding(
        n_dims, policy=policy, device=device))
register_encoding(
    "Composite",
    lambda n_dims, cfg, **kw: CompositeEncoding(
        cfg["nested"], n_dims, cfg.get("reduction", "Concatenation"), **kw))


def _nrc(n_dims, cfg, **kw):
    """The NRC / OneBlobFrequency alias (src/encoding.cu:70-100): TriangleWave
    on the first 3 dims, OneBlob on the next 5, Identity on the rest."""
    return CompositeEncoding(
        [{"n_dims_to_encode": 3, "otype": "TriangleWave",
          "n_frequencies": cfg.get("n_frequencies", 12)},
         {"n_dims_to_encode": 5, "otype": "OneBlob", "n_bins": cfg.get("n_bins", 4)},
         {"otype": "Identity"}],
        n_dims, **kw)


register_encoding(["NRC", "OneBlobFrequency"], _nrc)
