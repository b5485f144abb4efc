"""Floating-point format definitions for AMS-Quant (port of src/repro/core/formats.py).

A low-bit FP format is ``s | E (exp_bits) | M (man_bits)`` with no Inf/NaN:
all-ones exponents decode to regular values. Codes are non-negative int32
laid out as ``sign << (e+m) | E << m | M``; bit 0 is the mantissa LSB that
AMS-Quant shares across a group of ``k`` weights.

`code_to_value` builds each value from its IEEE f32 bit pattern (normals)
or as an exact small-integer multiple of a power of two (subnormals), so it
is bit-equal to the reference's ``ldexp`` decode without trusting
``torch.ldexp`` to be exact.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FPFormat:
    """A miniature IEEE-like floating-point format (no Inf/NaN)."""

    name: str
    exp_bits: int
    man_bits: int
    bias: int

    @property
    def total_bits(self) -> int:
        return 1 + self.exp_bits + self.man_bits

    @property
    def code_bits(self) -> int:  # bits of the unsigned magnitude code
        return self.exp_bits + self.man_bits

    @property
    def num_mag_codes(self) -> int:
        return 1 << self.code_bits

    @property
    def max_normal(self) -> float:
        e_max = (1 << self.exp_bits) - 1
        m_max = (1 << self.man_bits) - 1
        return 2.0 ** (e_max - self.bias) * (1.0 + m_max / (1 << self.man_bits))

    def decode_mag(self, mag_codes: np.ndarray) -> np.ndarray:
        """Numpy decode of unsigned magnitude codes -> float64 magnitudes."""
        mag_codes = np.asarray(mag_codes)
        m = mag_codes & ((1 << self.man_bits) - 1)
        e = mag_codes >> self.man_bits
        frac = m / (1 << self.man_bits)
        normal = 2.0 ** (e - self.bias) * (1.0 + frac)
        sub = 2.0 ** (1 - self.bias) * frac
        return np.where(e == 0, sub, normal)


def code_to_value(fmt: FPFormat, codes: torch.Tensor) -> torch.Tensor:
    """Full (signed) codes -> float32 values, exactly.

    Normal codes reassemble ``(E - bias + 127) << 23 | M << (23 - m)`` and
    reinterpret it as f32; subnormal codes are ``M * 2^(1 - bias - m)``, an
    exact product of a small integer and a power of two. The same SHIFT/AND/OR
    sequence runs inside the CUDA kernels (kernels/csrc/*.cu)."""
    codes = codes.to(torch.int32)
    m, e, bias = fmt.man_bits, fmt.exp_bits, fmt.bias
    M = codes & ((1 << m) - 1)
    E = (codes >> m) & ((1 << e) - 1)
    S = (codes >> (m + e)) & 1
    norm = (((E - bias + 127) << 23) | (M << (23 - m))).view(torch.float32)
    sub = M.to(torch.float32) * np.float32(2.0 ** (1 - bias - m))
    mag = torch.where(E == 0, sub, norm)
    return torch.where(S == 1, -mag, mag)


@lru_cache(maxsize=None)
def mag_table(fmt: FPFormat) -> np.ndarray:
    """Sorted float32 magnitudes of all unsigned codes (monotone in code)."""
    vals = fmt.decode_mag(np.arange(fmt.num_mag_codes))
    assert np.all(np.diff(vals) > 0), f"non-monotone format {fmt.name}"
    return vals.astype(np.float32)


@lru_cache(maxsize=None)
def mag_midpoints(fmt: FPFormat) -> np.ndarray:
    t = mag_table(fmt).astype(np.float64)
    return ((t[:-1] + t[1:]) / 2.0).astype(np.float32)


@lru_cache(maxsize=None)
def lsb_subgrid(fmt: FPFormat, lsb: int):
    """(codes, mags, midpoints) of the sub-grid whose mantissa LSB == lsb
    (the 'requantize' adaptive-search strategy's lattice)."""
    codes = np.arange(fmt.num_mag_codes)
    sel = codes[(codes & 1) == lsb]
    mags = fmt.decode_mag(sel).astype(np.float64)
    mids = ((mags[:-1] + mags[1:]) / 2.0).astype(np.float32)
    return sel.astype(np.int32), mags.astype(np.float32), mids


def _std_bias(e: int) -> int:
    return (1 << (e - 1)) - 1


# Registry. Biases follow OCP MX / the paper's Table 1 (bias = 2^(e-1)-1).
FORMATS: Dict[str, FPFormat] = {}
for _e, _m in [(2, 1), (2, 2), (2, 3), (3, 2), (3, 3), (4, 3), (5, 2)]:
    _f = FPFormat(f"e{_e}m{_m}", _e, _m, _std_bias(_e))
    FORMATS[_f.name] = _f


def get_format(name: str) -> FPFormat:
    return FORMATS[name]


@dataclasses.dataclass(frozen=True)
class AMSFormat:
    """An AMS-Quant scheme: base format + mantissa-sharing group size k.

    k == 1 means plain RTN at the base format (no sharing).
    Effective bits/weight = (total_bits - 1) + 1/k when k > 1.
    """

    base: FPFormat
    k: int = 1

    @property
    def effective_bits(self) -> float:
        if self.k == 1:
            return float(self.base.total_bits)
        return (self.base.total_bits - 1) + 1.0 / self.k

    @property
    def name(self) -> str:
        if self.k == 1:
            return f"fp{self.base.total_bits}-{self.base.name}"
        eb = self.effective_bits
        return f"fp{eb:.4g}-{self.base.name}-k{self.k}"


# The schemes evaluated in the paper (Table 2 / Table 3), by friendly name.
SCHEMES: Dict[str, AMSFormat] = {
    "fp8": AMSFormat(get_format("e4m3"), 1),
    "fp6-e2m3": AMSFormat(get_format("e2m3"), 1),
    "fp6-e3m2": AMSFormat(get_format("e3m2"), 1),
    "fp5.33-e2m3": AMSFormat(get_format("e2m3"), 3),
    "fp5-e2m2": AMSFormat(get_format("e2m2"), 1),
    "fp4.5-e2m2": AMSFormat(get_format("e2m2"), 2),
    "fp4.33-e2m2": AMSFormat(get_format("e2m2"), 3),
    "fp4.25-e2m2": AMSFormat(get_format("e2m2"), 4),
    "fp4-e2m1": AMSFormat(get_format("e2m1"), 1),
}


def get_scheme(name: str) -> AMSFormat:
    return SCHEMES[name]
