"""DFT/IDFT of split-complex tensors through torch.fft (cuFFT on the card).

Twin of the reference's `ops/dft.py`, which runs the transform as bf16-input
matrix products shaped for the TPU's matrix unit.  The port transforms in
float32 with an FFT, so its time samples agree with the reference's to the
reference's bf16 rounding (a relative-RMS bound), not bit for bit.

The same holds for the SC-FDMA transform precoding of the uplink (sizes
12 * l_prb, 1152 in the 20 MHz PUSCH cell): the reference runs those sizes
as one dense bf16-input matrix product (`ops/dft.py:117-131`; 1152 is not a
multiple of 128, so it takes no Cooley-Tukey split), and torch.fft covers
them here.  Transform-precoded samples and the LLRs after the inverse
transform are therefore held to a relative-RMS bound against the
reference, not to equality.
"""

from __future__ import annotations

import torch

OFDM_SYMBOL_SZ = {6: 128, 15: 256, 25: 512, 50: 1024, 75: 1536, 100: 2048}


def dft(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """cf tensor (..., N, 2) -> DFT along axis -2, scaled 1/sqrt(N) both ways
    (keeps grid/time powers equal)."""
    xc = torch.view_as_complex(x.to(torch.float32).contiguous())
    fn = torch.fft.ifft if inverse else torch.fft.fft
    return torch.view_as_real(fn(xc, dim=-1, norm="ortho"))


def idft(x: torch.Tensor) -> torch.Tensor:
    return dft(x, inverse=True)
