"""The yardstick's peaks and the work of a DepthConvBlock.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s in bf16, 495 TF32, 67 fp32 outside the tensor cores,
1979 TOP/s int8, 3.35 TB/s of HBM. A share of a peak is stated against
these, with the card's power limit printed beside it.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12,
              "int8": 1979e12}
PEAK_BYTES = 3.35e12

#: bytes of an element in each compute dtype
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def dcb_flops(pixels: int, c: int) -> int:
    """Products of one DepthConvBlock core of width ``c`` over ``pixels``
    (batch x H x W), as 2 x multiply-adds: the 1x1s C->C twice, C->4C and
    2C->C (16 C^2) and the depthwise 3x3 (18 C)."""
    return pixels * (16 * c * c + 18 * c)


def dcb_bytes(pixels: int, c: int, dtype: str) -> int:
    """Bytes one block's core must move at least: its input read once, its
    output written once, its weights (8 C^2 + 17 C) read once."""
    e = ELEMENT_BYTES[dtype]
    return e * (2 * pixels * c + 8 * c * c + 17 * c)


def dcb_bound_s(pixels: int, c: int, dtype: str) -> float:
    """The least time of one block's core on the card: the larger of its
    products at the dtype's peak and its bytes at the HBM's."""
    return max(dcb_flops(pixels, c) / PEAK_FLOPS[dtype],
               dcb_bytes(pixels, c, dtype) / PEAK_BYTES)
