"""DFT/IDFT of split-complex tensors through torch.fft (cuFFT on the card).

Twin of the reference's `ops/dft.py`, which runs the transform as bf16-input
matrix products shaped for the TPU's matrix unit.  The port transforms in
float32 with an FFT, so its time samples agree with the reference's to the
reference's bf16 rounding (a relative-RMS bound), not bit for bit.
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
