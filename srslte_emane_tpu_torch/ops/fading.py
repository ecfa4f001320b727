"""Channel simulator: TDL Rayleigh fading (EPA/EVA/ETU), delay, HST Doppler,
CFO and radio-link-failure injection.

Twin of the reference's `ops/fading.py` (`lib/src/phy/channel/`: fading.c
tapped-delay-line Rayleigh with Doppler, profiles at fading.c:38-50;
delay.c; hst.c; rlf.c).  Tap gains are a Jakes sum of sinusoids, block
fading per subframe.  The random part is split from the arithmetic:
`draw_phases` draws the sinusoids' angles and phases from a
`torch.Generator` (the reference draws them from jax.random, another
stream), and `gains_from_phases` evaluates the gains at given times, so
the same angles give the same trajectory in both packages.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import cplx

# 36.101 Annex B.2 tapped-delay-line profiles: (delay ns, power dB)
PROFILES = {
    "epa": ([0, 30, 70, 90, 110, 190, 410],
            [0.0, -1.0, -2.0, -3.0, -8.0, -17.2, -20.8]),
    "eva": ([0, 30, 150, 310, 370, 710, 1090, 1730, 2510],
            [0.0, -1.5, -1.4, -3.6, -0.6, -9.1, -7.0, -12.0, -16.9]),
    "etu": ([0, 50, 120, 200, 230, 500, 1600, 2300, 5000],
            [-1.0, -1.0, -1.0, 0.0, 0.0, 0.0, -3.0, -5.0, -7.0]),
    "none": ([0], [0.0]),
}
N_SINUSOIDS = 16


@functools.lru_cache(maxsize=None)
def profile_taps(profile: str, srate_hz: float):
    """Tap sample delays + linear amplitudes at the given sample rate."""
    delays_ns, powers_db = PROFILES[profile]
    d = np.round(np.asarray(delays_ns) * 1e-9 * srate_hz).astype(np.int64)
    a = 10.0 ** (np.asarray(powers_db) / 20.0)
    a = a / np.sqrt(np.sum(a**2))  # unit average channel power
    return d, a.astype(np.float32)


def draw_phases(gen: torch.Generator, batch: int, n_taps: int, device=None):
    """(alpha, phi), each (batch, n_taps, N_SINUSOIDS) uniform in [0, 2 pi):
    the arrival angles and phases of the sinusoids, on `device` (by default
    the generator's)."""
    device = gen.device if device is None else device
    shape = (batch, n_taps, N_SINUSOIDS)
    alpha = torch.rand(shape, generator=gen, device=device) * (2 * np.pi)
    phi = torch.rand(shape, generator=gen, device=device) * (2 * np.pi)
    return alpha, phi


def gains_from_phases(alpha: torch.Tensor, phi: torch.Tensor, t_s, doppler_hz: float):
    """Jakes sum-of-sinusoids Rayleigh gains (B, len(t_s), n_taps, 2) at the
    times t_s: h = (1/sqrt(N)) sum_k exp(j (2 pi f_d cos(alpha_k) t + phi_k)).
    Later times continue the same trajectory (the state fading.c keeps)."""
    t = torch.as_tensor(np.asarray(t_s, np.float32), device=alpha.device)[None, :, None, None]
    arg = 2 * np.pi * doppler_hz * torch.cos(alpha)[:, None] * t + phi[:, None]
    re = torch.cos(arg).sum(dim=-1) / np.sqrt(N_SINUSOIDS)
    im = torch.sin(arg).sum(dim=-1) / np.sqrt(N_SINUSOIDS)
    return cplx.make(re, im)


def tap_gains(gen: torch.Generator, n_taps: int, t_s, doppler_hz: float, batch: int,
              device=None):
    """(batch, len(t_s), n_taps, 2) gains of freshly drawn sinusoids."""
    return gains_from_phases(*draw_phases(gen, batch, n_taps, device), t_s, doppler_hz)


def tdl(x: torch.Tensor, g: torch.Tensor, delays) -> torch.Tensor:
    """Tapped delay line: x (B, T, 2) through taps g (B, n_taps, 2) at the
    integer sample delays `delays`; the tail past T is cut."""
    T = x.shape[-2]
    y = torch.zeros_like(x)
    for l, dl in enumerate(delays):
        shifted = torch.nn.functional.pad(x, (0, 0, int(dl), 0))[:, :T, :]
        y = y + cplx.mul(g[:, None, l, :], shifted)
    return y


def apply_fading(x: torch.Tensor, gen: torch.Generator, profile: str, srate_hz: float,
                 doppler_hz: float = 5.0, sf_time_s: float = 0.0):
    """x: (B, T, 2) one-subframe samples.  Taps held constant within the
    subframe (block fading), evolving across subframes via sf_time_s.
    Returns (y (B, T, 2), taps (B, n_taps, 2))."""
    d, a = profile_taps(profile, srate_hz)
    g = tap_gains(gen, len(d), np.array([sf_time_s]), doppler_hz, x.shape[0], x.device)[:, 0]
    g = g * torch.from_numpy(a).to(x.device)[None, :, None]
    return tdl(x, g, d), g


def apply_delay(x: torch.Tensor, delay_samples: int) -> torch.Tensor:
    """Static integer delay (delay.c's fixed case)."""
    T = x.shape[-2]
    return torch.nn.functional.pad(x, (0, 0, delay_samples, 0))[:, :T, :]


def hst_doppler_hz(t_s, fd_hz: float = 750.0, period_s: float = 7.2):
    """High-speed-train Doppler trajectory (36.101 B.3 / hst.c): the Doppler
    shift seen as the train passes the site, periodic."""
    t = np.mod(np.asarray(t_s), period_s)
    ds = period_s / 2
    return fd_hz * np.cos(np.pi * (t - ds) / ds)


def dynamic_delay_samples(t_s, min_samp: float, max_samp: float, period_s: float) -> float:
    """Sinusoidal path-delay trajectory (lib/src/phy/channel/delay.c:26-44):
    the delay sweeps between min and max with the configured period."""
    mid = (max_samp + min_samp) / 2.0
    amp = (max_samp - min_samp) / 2.0
    return mid + amp * np.sin(2 * np.pi * np.asarray(t_s) / period_s)


def apply_delay_dyn(x: torch.Tensor, delay_samples) -> torch.Tensor:
    """Integer delay given as a (device) scalar: a gather with the head
    zeroed, so one call serves the whole delay trajectory."""
    T = x.shape[-2]
    d = torch.as_tensor(delay_samples, dtype=torch.int64, device=x.device)
    src = torch.arange(T, device=x.device) - d
    vals = x[..., torch.clamp(src, 0, T - 1), :]
    return torch.where((src >= 0)[:, None], vals, 0.0)


def apply_cfo_dyn(x: torch.Tensor, cfo_hz, srate_hz: float) -> torch.Tensor:
    """Frequency offset given as a (device) tensor (HST trajectories sweep
    the Doppler per subframe)."""
    n = torch.arange(x.shape[-2], dtype=torch.float32, device=x.device)
    ph = 2 * np.pi * torch.as_tensor(cfo_hz, dtype=torch.float32, device=x.device) * n / srate_hz
    return cplx.mul(x, cplx.exp_i(ph)[None])


def apply_cfo(x: torch.Tensor, cfo_hz: float, srate_hz: float) -> torch.Tensor:
    """Frequency offset (also used for HST shift application); the phase
    ramp is built on the host."""
    n = np.arange(x.shape[-2], dtype=np.float32)
    ph = 2 * np.pi * cfo_hz * n / srate_hz
    rot = cplx.make(torch.from_numpy(np.cos(ph)), torch.from_numpy(np.sin(ph))).to(x.device)
    return cplx.mul(x, rot[None])


def apply_rlf(x: torch.Tensor, t_s: float, period_s: float = 2.0, outage_s: float = 0.2):
    """Radio-link-failure injection (rlf.c): zero the signal during periodic
    outage windows."""
    return torch.zeros_like(x) if (t_s % period_s) < outage_s else x
