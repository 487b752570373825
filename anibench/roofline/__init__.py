"""The card's published peaks and each kernel's least time (``roofline/<kernel>.py``).

NVIDIA H100 SXM data sheet: 3.35 TB/s of device memory; the integer
instruction rate taken as one operation a lane a clock, half of the
67 TFLOP/s float32 rate (which counts a fused multiply-add as two).
Rates assume the card's full 700 W; the result line names the card.
"""

MEMORY_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12 / 2


def least_seconds(ops: float, nbytes: float) -> tuple[float, str]:
    """The larger of the operations' and the bytes' times, and which."""
    ops_s, bytes_s = ops / INT_OPS_PER_S, nbytes / MEMORY_BYTES_PER_S
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")
