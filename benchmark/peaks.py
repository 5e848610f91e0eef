"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets; dense rates, at the card's full power limit). A rate the device
table lacks is not guessed: the readers that need it report nothing."""

from __future__ import annotations

from typing import NamedTuple


class Peaks(NamedTuple):
    f32_flops: float     # float32 outside the tensor cores, operations/s
    bytes_s: float       # device memory, bytes/s


PEAKS = {
    # H100 SXM5 80 GB: 67 TFLOP/s f32, 3.35 TB/s HBM3 (at 700 W)
    "NVIDIA H100 80GB HBM3": Peaks(67e12, 3.35e12),
}


def for_device(kind: str):
    return PEAKS.get(kind)


def bound_s(ops: float, nbytes: float, pk: Peaks) -> float:
    """The least time the card could take: the larger of the operations
    over the f32 peak and the bytes over the memory bandwidth."""
    return max(ops / pk.f32_flops, nbytes / pk.bytes_s)
