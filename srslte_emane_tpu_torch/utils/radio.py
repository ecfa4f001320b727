"""Radio object: sample-rate / gain / frequency management over an IQ device.

Reference behavior: `lib/src/radio/radio.cc` — the C++ wrapper around the RF
plugin vtable (rf_dev.h): srate/gain/freq setters, software AGC, fractional
frequency (CFO) shifting, continuous-tx zero padding between bursts, and a
pluggable device (UHD/bladeRF/Soapy/ZMQ/dummy).  Here the "devices" are the
framework's IQ endpoints: cf32 files (utils/iq_io), TCP IQ streams (the
rf_zmq_imp role), or a loopback buffer (rf_dummy_imp); the DSP (resampler,
AGC, freq shift) runs as tensor compute from ops/ on `dsp_device` (the card
by default).  The IQ endpoints and the host buffers stay NumPy.

Twin of the reference's `utils/radio.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fading, resample
from .devices import resolve


class LoopbackDevice:
    """rf_dummy_imp.c role: zero-filled RX, discarded TX (or loop TX->RX)."""

    def __init__(self, loop: bool = True):
        self.loop = loop
        self._buf = []

    def send(self, samples: np.ndarray):
        if self.loop:
            self._buf.append(np.asarray(samples))

    def recv(self, n: int) -> np.ndarray:
        out = np.zeros((n, 2), np.float32)
        pos = 0
        while self._buf and pos < n:
            chunk = self._buf[0]
            take = min(len(chunk), n - pos)
            out[pos : pos + take] = chunk[:take]
            if take == len(chunk):
                self._buf.pop(0)
            else:
                self._buf[0] = chunk[take:]
            pos += take
        return out


class _Channel:
    """Per-RF-channel state (radio.cc keeps per-channel gain/freq and one
    device stream per antenna/carrier)."""

    def __init__(self, device):
        self.device = device
        self.tx_gain_db = 0.0
        self.rx_gain_db = 0.0
        self.tx_freq_offset_hz = 0.0
        self.rx_freq_offset_hz = 0.0
        self.agc = resample.Agc()
        self.tx_end = 0  # sample count of the last burst end (continuous tx)


class Radio:
    """radio.cc equivalent: device-independent TX/RX with srate/gain/freq.

    Multi-channel: `nof_channels` parallel streams (rx antennas and/or
    component carriers — radio.cc's rf_buffer_t carries one buffer per
    channel and maps carriers to channels); single-channel calls keep the
    original (T, 2) array shapes, multi-channel uses lists per channel."""

    def __init__(self, device=None, srate_hz: float = 11.52e6,
                 nof_channels: int = 1, devices: list = None, dsp_device="cuda"):
        self.dsp_device = resolve(dsp_device, "Radio")
        if devices is None:
            devices = [device if (device is not None and ch == 0)
                       else LoopbackDevice() for ch in range(nof_channels)]
        self.channels = [_Channel(d) for d in devices]
        self.srate_hz = srate_hz
        # carrier -> channel mapping (radio.cc carrier_map role)
        self.carrier_map = {cc: cc for cc in range(len(self.channels))}

    def _dsp(self, fn, x: np.ndarray) -> np.ndarray:
        """fn on (T, 2) host samples as a (1, T, 2) tensor on the DSP device."""
        t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.dsp_device)
        return fn(t[None])[0].cpu().numpy()

    @property
    def nof_channels(self):
        return len(self.channels)

    # single-channel compatibility surface
    @property
    def device(self):
        return self.channels[0].device

    def _chs(self, channel):
        return self.channels if channel is None else [self.channels[channel]]

    # ---- config surface (radio.h setters; channel=None applies to all) ----
    def set_tx_srate(self, hz: float):
        self.srate_hz = hz

    def set_tx_gain(self, db: float, channel: int = None):
        for c in self._chs(channel):
            c.tx_gain_db = db

    def set_rx_gain(self, db: float, channel: int = None):
        for c in self._chs(channel):
            c.rx_gain_db = db

    def set_tx_freq_offset(self, hz: float, channel: int = None):
        for c in self._chs(channel):
            c.tx_freq_offset_hz = hz

    def set_rx_freq_offset(self, hz: float, channel: int = None):
        for c in self._chs(channel):
            c.rx_freq_offset_hz = hz

    def channel_of_carrier(self, cc: int) -> int:
        return self.carrier_map[cc]

    # ---- data path ----
    def _tx_one(self, ch: _Channel, samples, t_start_samples):
        x = np.asarray(samples, np.float32)
        if ch.tx_freq_offset_hz:
            x = self._dsp(lambda t: fading.apply_cfo(
                t, ch.tx_freq_offset_hz, self.srate_hz), x)
        x = x * (10.0 ** (ch.tx_gain_db / 20.0))
        if t_start_samples is not None and t_start_samples > ch.tx_end:
            ch.device.send(np.zeros((t_start_samples - ch.tx_end, 2),
                                    np.float32))
            ch.tx_end = t_start_samples
        ch.device.send(x)
        ch.tx_end += len(x)

    def tx(self, samples, t_start_samples: int = None, channel: int = None):
        """Transmit one burst; zero-pads any gap since the previous burst
        (radio.cc continuous-transmission padding).  `samples` is (T, 2)
        for one channel, or a list of per-channel bursts when `channel` is
        None and multiple channels are configured."""
        if channel is None and len(self.channels) > 1 \
                and isinstance(samples, (list, tuple)):
            assert len(samples) == len(self.channels)
            for ch, s in zip(self.channels, samples):
                self._tx_one(ch, s, t_start_samples)
            return
        ch = self.channels[channel or 0]
        self._tx_one(ch, samples, t_start_samples)

    def _rx_one(self, ch: _Channel, n_samples: int, agc: bool):
        y = ch.device.recv(n_samples).astype(np.float32)
        y = y * (10.0 ** (ch.rx_gain_db / 20.0))
        if ch.rx_freq_offset_hz:
            y = self._dsp(lambda t: fading.apply_cfo(
                t, -ch.rx_freq_offset_hz, self.srate_hz), y)
        if agc:
            y = self._dsp(ch.agc.process, y)
        return y

    def rx(self, n_samples: int, agc: bool = False, channel: int = None):
        """Receive: (T, 2) for a single channel; (N, T, 2) stacked across
        all channels when `channel` is None and several are configured
        (radio.cc rx_now filling one buffer per antenna)."""
        if channel is None and len(self.channels) > 1:
            return np.stack([self._rx_one(c, n_samples, agc)
                             for c in self.channels])
        return self._rx_one(self.channels[channel or 0], n_samples, agc)

    def resample_to(self, samples, out_rate_hz: float):
        """Arbitrary-ratio resample (resample_arb.c role) for rate changes."""
        ratio = out_rate_hz / self.srate_hz
        return self._dsp(lambda t: resample.resample_arb(t, ratio), samples)
