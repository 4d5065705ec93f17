"""OTFS (delay-Doppler) waveform for doubly-selective channels.

Numeric contract from the reference (include/ultra/otfs.hpp,
src/otfs/otfs.cpp):
- DD grid M=32 delay x N=16 Doppler, dd[k*N+l]; ISFFT = unscaled IFFT along
  Doppler then FFT along delay -> tf[n*M+m] (otfs.cpp:54-91); SFFT inverts;
- OFDM carrier: M values on FFT bins 1..M (positive freqs only), 512-pt FFT,
  CP 64, continuous 1500 Hz mixer (otfs.cpp:297-331);
- preamble: 4 identical sync symbols (ZC-like root-1 sequence of length M on
  the carriers), RMS-normalized; channel estimated per subcarrier by
  averaging preamble symbols;
- coherent mode: DD pilot 2.0 at (0,0) with 4x4 guard zeros; differential
  mode: DQPSK-style phase chaining across the DD grid raster scan;
- two RX modes: TF-equalized (OTFS_EQ, stable channels) and raw-DD
  (OTFS_RAW + differential, poor channels).

Array redesign: the whole frame is a pair of batched 2D FFTs plus one
[N, fft] symbol FFT — no loops.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

PREAMBLE_TARGET_RMS = 0.35


@dataclass(frozen=True)
class OTFSConfig:
    M: int = 32
    N: int = 16
    fft_size: int = 512
    cp_len: int = 64
    sample_rate: float = 48000.0
    center_freq: float = 1500.0
    modulation: str = "QPSK"
    dd_differential: bool = False
    dd_pilot_enable: bool = True
    guard_delay: int = 4
    guard_doppler: int = 4
    tf_equalization: bool = True
    preamble_symbols: int = 4
    # Decision-directed per-symbol tracking (beyond the reference): the
    # static preamble estimate cannot track intra-frame channel rotation (a
    # 1 Hz Poor-channel Doppler turns the channel substantially over the
    # 192 ms frame).  After a first static MMSE pass, the hardened DD grid
    # is re-synthesized to TF and a per-OFDM-symbol complex gain r[n] is
    # estimated against the raw TF samples; the second MMSE pass equalizes
    # with H[m]*r[n].  (A DD-pilot tap estimate was tried first and
    # rejected: fractional-delay taps leak across all delay bins, so
    # truncating to the pilot guard region costs ~-13 dB estimate error.)
    phase_tracking: bool = False

    @property
    def symbol_samples(self) -> int:
        return self.fft_size + self.cp_len

    @property
    def preamble_samples(self) -> int:
        return self.preamble_symbols * self.symbol_samples

    @property
    def frame_samples(self) -> int:
        return self.N * self.symbol_samples

    def data_cells(self) -> np.ndarray:
        """Boolean [M, N] mask of usable data cells (pilot/guard excluded)."""
        mask = np.ones((self.M, self.N), bool)
        if not self.dd_differential and self.dd_pilot_enable:
            mask[: self.guard_delay, : self.guard_doppler] = False
        return mask

    def bits_per_frame(self) -> int:
        bps = 2 if self.dd_differential else {"BPSK": 1, "QPSK": 2, "QAM16": 4}[self.modulation]
        return int(self.data_cells().sum()) * bps


def isfft(dd: jnp.ndarray) -> jnp.ndarray:
    """DD [.., M, N] -> TF [.., N, M]: unscaled IFFT over Doppler, FFT over delay."""
    t = jnp.fft.ifft(dd, axis=-1) * dd.shape[-1]  # unscaled inverse
    tf = jnp.fft.fft(t, axis=-2)
    return jnp.swapaxes(tf, -1, -2)


def sfft(tf: jnp.ndarray) -> jnp.ndarray:
    """TF [.., N, M] -> DD [.., M, N] (inverse of isfft)."""
    temp = jnp.fft.ifft(tf, axis=-1)            # undo FFT over delay (M)
    temp = jnp.swapaxes(temp, -1, -2)           # [.., M, N]
    return jnp.fft.fft(temp, axis=-1) / temp.shape[-1]  # undo unscaled IDFT over N


@functools.lru_cache(maxsize=None)
def _sync_sequence(cfg: OTFSConfig) -> np.ndarray:
    n = np.arange(cfg.M, dtype=np.float64)
    return np.exp(-1j * np.pi * n * (n + 1) / cfg.M).astype(np.complex64)


def _ofdm_to_time(tf_syms: np.ndarray, cfg: OTFSConfig) -> np.ndarray:
    """[S, M] TF symbols -> complex time stream [S*(fft+cp)]."""
    S = tf_syms.shape[0]
    freq = np.zeros((S, cfg.fft_size), np.complex64)
    freq[:, 1 : 1 + cfg.M] = tf_syms
    td = np.fft.ifft(freq, axis=-1).astype(np.complex64)
    with_cp = np.concatenate([td[:, -cfg.cp_len :], td], axis=-1)
    return with_cp.reshape(-1)


def _mix(stream: np.ndarray, cfg: OTFSConfig, offset: int = 0) -> np.ndarray:
    t = np.arange(len(stream), dtype=np.float64) + offset
    carrier = np.exp(2j * np.pi * cfg.center_freq * t / cfg.sample_rate)
    return np.real(stream * carrier).astype(np.float32)


# Gray QPSK table identical to the OFDM one (reference mapBits).
from ria_tpu.wave.ofdm import constellation_table  # noqa: E402


def map_to_dd(bits: np.ndarray, cfg: OTFSConfig) -> np.ndarray:
    """Bits -> DD grid [M, N] (raster scan over k then l)."""
    mask = cfg.data_cells()
    dd = np.zeros((cfg.M, cfg.N), np.complex64)
    if cfg.dd_differential:
        vals = np.zeros(cfg.M * cfg.N, np.int64)
        nbits = min(len(bits), 2 * cfg.M * cfg.N)
        grouped = np.zeros(2 * cfg.M * cfg.N, np.int64)
        grouped[:nbits] = bits[:nbits]
        vals = grouped.reshape(-1, 2)[:, 0] * 2 + grouped.reshape(-1, 2)[:, 1]
        rot = constellation_table("DQPSK")[vals]
        chain = np.cumprod(rot)
        dd = chain.reshape(cfg.M, cfg.N).astype(np.complex64)
        return dd
    table = constellation_table(cfg.modulation)
    bps = {"BPSK": 1, "QPSK": 2, "QAM16": 4}[cfg.modulation]
    cells = np.argwhere(mask)
    padded = np.zeros(len(cells) * bps, np.int64)
    padded[: min(len(bits), len(padded))] = bits[: len(padded)]
    grouped = padded.reshape(len(cells), bps)
    vals = np.zeros(len(cells), np.int64)
    for b in range(bps):
        vals = (vals << 1) | grouped[:, b]
    dd[cells[:, 0], cells[:, 1]] = table[vals]
    if cfg.dd_pilot_enable:
        dd[0, 0] = 2.0
    return dd


def tx_frame(bits: np.ndarray, cfg: OTFSConfig) -> np.ndarray:
    """Preamble (4 sync symbols) + OTFS frame, passband."""
    dd = map_to_dd(np.asarray(bits, np.int64), cfg)
    # Host-side ISFFT in numpy (device->host readback of complex arrays is
    # not supported on all PJRT backends).
    temp = np.fft.ifft(dd, axis=-1) * dd.shape[-1]
    tf = np.swapaxes(np.fft.fft(temp, axis=-2), -1, -2).astype(np.complex64)  # [N, M]
    # Normalize TF power to the unit-amplitude sync carriers so the preamble
    # channel estimate applies to data symbols at matched scale (the RX
    # renormalizes the DD constellation blindly).
    tf /= np.sqrt(np.mean(np.abs(tf) ** 2)) + 1e-12
    sync = np.tile(_sync_sequence(cfg)[None, :], (cfg.preamble_symbols, 1))
    pre_stream = _ofdm_to_time(sync, cfg)
    rms = np.sqrt(np.mean(np.square(np.real(pre_stream))) + 1e-12)
    data_stream = _ofdm_to_time(tf, cfg)
    full = np.concatenate([pre_stream, data_stream])
    out = _mix(full, cfg)
    pre_rms = np.sqrt(np.mean(out[: cfg.preamble_samples] ** 2) + 1e-20)
    return out * (PREAMBLE_TARGET_RMS / max(pre_rms, 1e-9))


class OTFSDemodResult(NamedTuple):
    soft_bits: jnp.ndarray
    dd_symbols: jnp.ndarray
    snr_db: jnp.ndarray
    noise_var: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("cfg",))
def demodulate_presynced(samples: jnp.ndarray, cfo_hz: jnp.ndarray,
                         cfg: OTFSConfig) -> OTFSDemodResult:
    """Demod preamble+frame starting at the first preamble symbol."""
    sym = cfg.symbol_samples
    P, N, M = cfg.preamble_symbols, cfg.N, cfg.M
    need = (P + N) * sym
    x = samples[..., :need]

    t = jnp.arange(need, dtype=jnp.float32) / cfg.sample_rate
    dc = jnp.exp(-1j * 2.0 * jnp.pi * (cfg.center_freq + jnp.asarray(cfo_hz)[..., None]) * t)
    bb = x.astype(jnp.complex64) * dc

    syms = bb.reshape(bb.shape[:-1] + (P + N, sym))
    core = syms[..., cfg.cp_len :]
    freq = jnp.fft.fft(core, axis=-1)[..., 1 : 1 + M]  # [.., P+N, M]

    # Residual CFO from the repeated preamble symbols (the ZC estimate can
    # be off by a couple of Hz, which coherent OTFS cannot absorb):
    # adjacent identical symbols differ by e^{j 2 pi df T_sym}.
    pre = freq[..., :P, :]
    corr = jnp.sum(pre[..., 1:, :] * jnp.conj(pre[..., :-1, :]), axis=(-1, -2))
    t_sym = sym / cfg.sample_rate
    dphi = jnp.angle(corr)  # radians per symbol
    # Correct the per-symbol phase ramp across the whole frame.
    idx = jnp.arange(P + N, dtype=jnp.float32)
    freq = freq * jnp.exp(-1j * dphi[..., None, None] * idx[..., :, None])

    sync = jnp.asarray(_sync_sequence(cfg))
    H = jnp.mean(freq[..., :P, :] / sync, axis=-2)      # [.., M]
    d = freq[..., 1, :] - freq[..., 0, :]
    noise_var = jnp.mean(jnp.square(jnp.abs(d)), axis=-1) / 2.0
    noise_var = jnp.maximum(noise_var, 1e-9)

    tf_raw = freq[..., P:, :]  # [.., N, M]
    tf = tf_raw
    if cfg.tf_equalization:
        h2 = jnp.square(jnp.abs(H))[..., None, :]
        tf = tf_raw * jnp.conj(H)[..., None, :] / jnp.maximum(
            h2 + noise_var[..., None, None], 1e-12)

    if cfg.phase_tracking and cfg.tf_equalization and not cfg.dd_differential:
        # Decision-directed per-symbol complex gain: harden the first-pass
        # DD grid (known pilot/guard cells exact, data cells -> nearest
        # constellation point), re-synthesize the TF grid, and estimate one
        # complex gain r[n] per OFDM symbol from the raw TF samples.  M=32
        # carriers average out decision errors; r[n] tracks the intra-frame
        # rotation the static preamble H misses.
        dd1 = sfft(tf)
        mask = jnp.asarray(cfg.data_cells())
        nmask = jnp.sum(mask)
        mean_mod1 = jnp.sum(jnp.abs(dd1) * mask, axis=(-2, -1), keepdims=True) / nmask
        dd1n = dd1 / jnp.maximum(mean_mod1, 1e-9)
        table1 = jnp.asarray(constellation_table(cfg.modulation))
        near = jnp.argmin(jnp.square(jnp.abs(dd1n[..., None] - table1)), axis=-1)
        hard = table1[near]
        # Non-data cells (pilot + guards) keep their received values — the
        # equalized pilot response is itself a good reference and this stays
        # batch-shape safe.
        dd_hard = jnp.where(mask, hard * mean_mod1, dd1)
        x_hat = isfft(dd_hard)                           # [.., N, M]
        ref = H[..., None, :] * x_hat
        num = jnp.sum(tf_raw * jnp.conj(ref), axis=-1)   # [.., N]
        den = jnp.sum(jnp.square(jnp.abs(ref)), axis=-1)
        r = num / jnp.maximum(den, 1e-12)                # per-symbol gain
        # Guard against decision-failure symbols: fall back to unit gain
        # when the estimate collapses.
        r = jnp.where(jnp.abs(r) < 0.1, 1.0 + 0j, r)
        H_tv = H[..., None, :] * r[..., :, None]
        h2 = jnp.square(jnp.abs(H_tv))
        tf = tf_raw * jnp.conj(H_tv) / jnp.maximum(
            h2 + noise_var[..., None, None], 1e-12)

    dd = sfft(tf)  # [.., M, N]

    # Blind amplitude renormalization: TX normalized TF power, so the DD
    # constellation scale is recovered from the mean modulus over data cells.
    mask = jnp.asarray(cfg.data_cells())
    nmask = jnp.sum(mask)
    mean_mod = jnp.sum(jnp.abs(dd) * mask, axis=(-2, -1), keepdims=True) / nmask
    target = 1.0  # QPSK / differential constellations are unit-modulus
    dd = dd * (target / jnp.maximum(mean_mod, 1e-9))

    # Self-calibrated effective noise: variance of the distance to the
    # nearest constellation point over data cells.
    table = jnp.asarray(constellation_table(cfg.modulation if not cfg.dd_differential else "QPSK"))
    if not cfg.dd_differential:
        d2 = jnp.square(jnp.abs(dd[..., None] - table))
        err = jnp.min(d2, axis=-1)
        nv_eff = jnp.sum(err * mask, axis=(-2, -1)) / nmask
        nv_eff = jnp.maximum(nv_eff, 1e-4)
        noise_var = nv_eff

    nv = jnp.maximum(noise_var[..., None, None], 1e-9)
    if cfg.dd_differential:
        flat = dd.reshape(dd.shape[:-2] + (M * N,))
        prev = jnp.concatenate([jnp.ones(flat.shape[:-1] + (1,), flat.dtype),
                                flat[..., :-1]], axis=-1)
        diff = flat * jnp.conj(prev)
        phase = jnp.angle(diff)
        # Phase-noise-calibrated LLR scale (MC-DPSK style): variance of the
        # phase error vs the nearest DQPSK rotation.
        ideal = jnp.round((phase - jnp.pi / 4) / (jnp.pi / 2)) * (jnp.pi / 2) + jnp.pi / 4
        err = phase - ideal
        err = jnp.where(err > jnp.pi, err - 2 * jnp.pi, err)
        err = jnp.where(err < -jnp.pi, err + 2 * jnp.pi, err)
        pvar = jnp.maximum(jnp.mean(jnp.square(err), axis=-1, keepdims=True), 0.01)
        scale = jnp.minimum(2.0 * jnp.sqrt(1.0 / pvar), 20.0)
        l0 = scale * jnp.sin(phase + jnp.pi / 4)
        l1 = scale * (jnp.abs(jnp.real(diff)) - jnp.abs(jnp.imag(diff))) \
            / jnp.maximum(jnp.abs(diff), 1e-9)
        soft = jnp.stack([l0, l1], axis=-1).reshape(flat.shape[:-1] + (2 * M * N,))
        soft = jnp.clip(soft, -20.0, 20.0)
    else:
        mask = cfg.data_cells()
        cells = np.argwhere(mask)
        vals = dd[..., cells[:, 0], cells[:, 1]]
        from ria_tpu.wave.ofdm import _demap

        nvv = jnp.broadcast_to(nv[..., 0, :], vals.shape)
        llr = _demap(cfg.modulation, vals, jnp.ones_like(vals), nvv)
        soft = llr.reshape(llr.shape[:-2] + (llr.shape[-2] * llr.shape[-1],))

    h_pow = jnp.mean(jnp.square(jnp.abs(H)), axis=-1)
    snr_db = 10.0 * jnp.log10(jnp.maximum(h_pow / noise_var, 1e-6))
    return OTFSDemodResult(soft_bits=soft, dd_symbols=dd, snr_db=snr_db,
                           noise_var=noise_var)
