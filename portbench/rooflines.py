"""The card's peaks and the least time of the port's two hand-written
kernels, from their shapes: the yardstick of the ``*_roofline_pct``
metrics.

Peaks are the published ones of an NVIDIA H100 SXM (NVIDIA's data sheet,
dense rates) at its 700 W limit; the instruction rates follow from the
card's SM count and maximum SM clock (the throughput table of NVIDIA's
CUDA C programming guide for compute capability 9.0: 128 32-bit
instructions and 16 ``__popc`` per SM per clock).  A bound is the larger
of bytes over the memory rate and operations over the operation rate;
each input byte is read once and each output byte written once.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT8_TENSOR_OPS_PER_S = 1979e12  # dense int8 tensor-core rate (no 1-bit rate is published)
H100_SMS = 132
H100_MAX_SM_MHZ = 1980.0


def card_rates(sms: int | None = None, mhz: float | None = None) -> dict:
    """32-bit instructions and ``__popc`` results per second of the card:
    SMs x 128 (x 16) x the maximum SM clock.  Reads the SM count from
    torch and the clock from ``nvidia-smi`` where not given, and falls
    back to the H100 SXM's 132 SMs at 1980 MHz where either is absent."""
    if sms is None:
        try:
            import torch

            sms = torch.cuda.get_device_properties(0).multi_processor_count
        except (RuntimeError, AssertionError):
            sms = H100_SMS
    if mhz is None:
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                capture_output=True, text=True, check=True, timeout=20).stdout
            mhz = float(out.strip().splitlines()[0])
        except (OSError, subprocess.SubprocessError, ValueError, IndexError):
            mhz = H100_MAX_SM_MHZ
    return {"sms": sms, "sm_clock_mhz": mhz,
            "instr_per_s": sms * 128 * mhz * 1e6, "popc_per_s": sms * 16 * mhz * 1e6}


def b1_bound_s(n: int, m: int) -> float:
    """Kernel B1, the (n, 8) x (m, 8) int32 Hamming matrix: both inputs read
    once and the (n, m) int32 output written once, against the 256-bit
    AND + popcount product of every pair on the tensor cores at the int8
    rate."""
    t_bytes = 4 * (8 * n + 8 * m + n * m) / HBM_BYTES_PER_S
    t_ops = 2 * 256 * n * m / INT8_TENSOR_OPS_PER_S
    return max(t_bytes, t_ops)


def b2_bound_s(b: int, n: int, m: int, admitted: int, rates: dict) -> float:
    """Kernel B2, the windowed two-minimum match of (b, n) rows against
    (b, m) columns: inputs (descriptors 32 B, positions 8 B, validity 1 B a
    keypoint) read once and (best, second, idx) = 16 B a row written once,
    against the instructions the function needs: the window test of every
    (row, column) pair (2 subtractions, 2 compares), and for each pair the
    window admits 8 x (xor, add) and a 4-instruction top-2 update at the
    32-bit rate and 8 popcounts at the ``__popc`` rate."""
    n_bytes = b * (n + m) * (32 + 8 + 1) + 16 * b * n
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ((4 * b * n * m + 20 * admitted) / rates["instr_per_s"]
             + 8 * admitted / rates["popc_per_s"])
    return max(t_bytes, t_ops)
