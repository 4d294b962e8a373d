"""Shared splat geometry + attribute packing helpers.

Exact oriented-ellipse / axis-aligned-rect overlap (the reference's
ellipseRectOverlap, GaussianRender.cu:350-436) and the bit packing of the
three raster attribute operands that travel with the sort keys.

Packed words are returned as int32 tensors holding the uint32 bit
patterns: CPU torch has no shifts on uint32, and a bit pattern never
passes through a float tensor.  Every packer rounds each float op
separately, exactly as the emit kernel (csrc/emit.cu) and the JAX package
do, so the three agree bit for bit.
"""

from __future__ import annotations

import torch


def _to_ellipse_coords(cx, cy, cos_t, sin_t, e0, e1, px, py):
    """Map a clip-space point into the ellipse's unit-circle frame
    (convertToEllipseCoordinates, cu:351-358)."""
    dx = px - cx
    dy = py - cy
    lx = (dx * cos_t + dy * sin_t) / e0
    ly = (dy * cos_t - dx * sin_t) / e1
    return lx, ly


def _segment_hits_unit_circle(x0, y0, x1, y1):
    """Segment vs unit circle (intersectsUnitCircle, cu:361-372)."""
    dx, dy = x1 - x0, y1 - y0
    len_sqr = dx * dx + dy * dy
    # NaN-safe: clamp(NaN) stays NaN and every comparison below is False.
    t = torch.clamp(-(x0 * dx + y0 * dy) / len_sqr, 0.0, 1.0)
    px = x0 + t * dx
    py = y0 + t * dy
    return px * px + py * py < 1.0


def ellipse_rect_overlap(cx, cy, cos_t, sin_t, e0, e1,
                         rect_min_x, rect_min_y, rect_max_x, rect_max_y):
    """Exact oriented-ellipse / axis-aligned-rect overlap
    (ellipseRectOverlap, cu:375-405): center-in-rect OR rect-center-in-
    ellipse OR any rect edge intersects the unit circle in ellipse frame.
    All arguments broadcast elementwise."""
    overlaps = (
        (cx > rect_min_x) & (cx < rect_max_x) & (cy > rect_min_y) & (cy < rect_max_y)
    )
    ell = (cx, cy, cos_t, sin_t, e0, e1)
    mx = rect_min_x + (rect_max_x - rect_min_x) * 0.5
    my = rect_min_y + (rect_max_y - rect_min_y) * 0.5
    lx, ly = _to_ellipse_coords(*ell, mx, my)
    overlaps = overlaps | (lx * lx + ly * ly < 1.0)

    p0 = _to_ellipse_coords(*ell, rect_min_x, rect_min_y)
    p1 = _to_ellipse_coords(*ell, rect_max_x, rect_min_y)
    p2 = _to_ellipse_coords(*ell, rect_max_x, rect_max_y)
    p3 = _to_ellipse_coords(*ell, rect_min_x, rect_max_y)
    overlaps = overlaps | _segment_hits_unit_circle(*p0, *p1)
    overlaps = overlaps | _segment_hits_unit_circle(*p1, *p2)
    overlaps = overlaps | _segment_hits_unit_circle(*p2, *p3)
    overlaps = overlaps | _segment_hits_unit_circle(*p3, *p0)
    return overlaps


# --- sort-operand packing -------------------------------------------------
#
# The raster attributes pack into three 32-bit words: the center as 16+16
# fixed point, the conic as two 12-bit minifloats plus an 8-bit
# correlation, and rgb888|alpha8.  Precision per field as in the JAX
# package (geometry.py there): sub-LSB at the 8-bit framebuffer except a
# bounded <1% error on the density exponent from the 8-bit correlation.

CENTER_SCALE = 65535.0

# 12-bit positive minifloat = bf16 with the exponent re-biased to cover
# [2^-8, 2^24): value bits (exp5|mant7) = (f32_bits >> 16) - MF12_K.
MF12_K = (127 - 8) << 7

_U32 = 0xFFFFFFFF


def clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """torch.clamp's values with the JAX package's gradient at a bound.

    jnp.clip, jnp.maximum and jnp.minimum split the gradient in half
    between the value and a bound it ties with; torch.clamp passes all of
    it to the value.  torch.maximum/torch.minimum split it as JAX does, so
    every clip that autograd runs through (the differentiable path's
    stages A-B and blend) goes through here.  The bounds are 0-d CPU
    tensors: a scalar operand on any device, copied nowhere.
    """
    if lo is not None:
        x = torch.maximum(x, torch.tensor(lo, dtype=x.dtype))
    if hi is not None:
        x = torch.minimum(x, torch.tensor(hi, dtype=x.dtype))
    return x


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same bit patterns."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def as_u32_i64(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values as int64."""
    return x.to(torch.int64) & _U32


def float_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 -> its bit pattern as unsigned int64."""
    return as_u32_i64(x.contiguous().view(torch.int32))


def bits_float(b: torch.Tensor) -> torch.Tensor:
    """Unsigned int64 bit patterns < 2^32 -> f32."""
    return as_i32(b).view(torch.float32)


def _trunc_u(x: torch.Tensor) -> torch.Tensor:
    """Non-negative f32 -> truncated int64 (the C float->int cast)."""
    return x.to(torch.int64)


def pack_rgb_u32(colors: torch.Tensor) -> torch.Tensor:
    """[3, N] planar float colors -> int32 0x00RRGGBB (truncating, like
    the reference's final uchar cast, cu:1007-1010)."""
    c = _trunc_u(torch.clamp(colors, 0.0, 1.0) * 255.0)
    return as_i32((c[0] << 16) | (c[1] << 8) | c[2])


def _rnd_bf16_bits16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> round-to-nearest-even bf16 bit pattern in the LOW half
    (int64), with the uint32 wrap-around of the JAX function."""
    bits = float_bits(x)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) & _U32) >> 16


def _mf12(x: torch.Tensor) -> torch.Tensor:
    """Positive f32 -> 12-bit minifloat bits (round-to-nearest, clamped)."""
    return torch.clamp(_rnd_bf16_bits16(x) - MF12_K, 0, 4095)


def _mf12_decode(q: torch.Tensor) -> torch.Tensor:
    return bits_float(((q + MF12_K) << 16) & _U32)


def pack_conic_u32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Conic (a, b, c) -> one word: a_mf12 | c_mf12 | rho8 (int32 bits).

    a and c keep bf16 precision (12-bit re-biased minifloats); the
    off-diagonal b is stored as its correlation rho = b/sqrt(a*c) in
    [-1, 1] quantized to 8 bits, encoded against the DECODED a*c so
    encode/decode round-trips.
    """
    qa = _mf12(a)
    qc = _mf12(c)
    denom = torch.sqrt(_mf12_decode(qa) * _mf12_decode(qc))
    rho = b / torch.clamp(denom, min=1e-30)
    # floor(x + 0.5): matches the emit kernel's truncating cast.
    q_rho = _trunc_u(
        torch.clamp(torch.floor((rho + 1.0) * 127.5 + 0.5), 0.0, 255.0)
    )
    return as_i32((qa << 20) | (qc << 8) | q_rho)


def unpack_conic_u32(q: torch.Tensor):
    """Inverse of pack_conic_u32 -> (a, b, c) f32."""
    q = as_u32_i64(q)
    a = _mf12_decode(q >> 20)
    c = _mf12_decode((q >> 8) & 0xFFF)
    rho = (q & 0xFF).to(torch.float32) * (1.0 / 127.5) - 1.0
    b = rho * torch.sqrt(a * c)
    return a, b, c


def pack_rgba_u32(rgb_u32: torch.Tensor, opacity: torch.Tensor) -> torch.Tensor:
    """0x00RRGGBB | [0,1] opacity -> 0xRRGGBBAA (alpha round-to-nearest)."""
    alpha8 = _trunc_u(torch.clamp(opacity, 0.0, 1.0) * 255.0 + 0.5)
    return as_i32((as_u32_i64(rgb_u32) << 8) & _U32 | alpha8)


def pack_center_u32(cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """Clip-space center -> (x16 << 16 | y16) fixed point over [-1, 1]."""
    qx = _trunc_u(torch.clamp((cx + 1.0) * 0.5, 0.0, 1.0) * CENTER_SCALE + 0.5)
    qy = _trunc_u(torch.clamp((cy + 1.0) * 0.5, 0.0, 1.0) * CENTER_SCALE + 0.5)
    return as_i32((qx << 16) | qy)
