"""Single-carrier DPSK (the very-low-SNR / raw-PING waveform).

Numeric contract from the reference (src/psk/dpsk.hpp):
- single carrier at 1500 Hz, 1536 samples/symbol default (31.25 baud),
  DBPSK/DQPSK/D8PSK with phase increments: DBPSK 0/180, DQPSK
  (2v+1)*45 deg Gray offsets, D8PSK v*45+22.5 deg (:77-100);
- Barker-13 x3 BPSK preamble for sync (:108-140), or chirp + 8 alternating
  training symbols + reference symbol in chirp-synced mode (:153-208);
- raw "ULTR" PING bytes ride this waveform uncoded.

Array redesign: symbol demod is a [S, sps] @ [sps, 1] mix-integrate (shared
machinery with MC-DPSK at num_carriers=1); Barker detection correlates the
per-symbol differential sign sequence at all symbol-rate lags at once.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

BARKER13 = np.array([1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, 1])
BARKER_REPEATS = 3
TRAINING_SYMBOLS = 8


@dataclass(frozen=True)
class DPSKConfig:
    sample_rate: float = 48000.0
    carrier_freq: float = 1500.0
    samples_per_symbol: int = 1536
    bits_per_symbol: int = 2  # 1 DBPSK, 2 DQPSK, 3 D8PSK

    @property
    def preamble_symbols(self) -> int:
        return len(BARKER13) * BARKER_REPEATS

    @property
    def preamble_samples(self) -> int:
        return self.preamble_symbols * self.samples_per_symbol

    def phase_increment(self, v: np.ndarray) -> np.ndarray:
        if self.bits_per_symbol == 1:
            return v * np.pi
        if self.bits_per_symbol == 2:
            return (v * 2 + 1) * np.pi / 4.0
        return (v & 7) * np.pi / 4.0 + np.pi / 8.0

    def num_symbols_for_bits(self, num_bits: int) -> int:
        return -(-num_bits // self.bits_per_symbol)

    def frame_samples(self, num_bits: int) -> int:
        return self.preamble_samples + (1 + self.num_symbols_for_bits(num_bits)) \
            * self.samples_per_symbol


def _synth(phases: np.ndarray, cfg: DPSKConfig) -> np.ndarray:
    """Absolute per-symbol phases -> passband samples (carrier restarts at 0
    each symbol, matching the reference's per-symbol synthesis)."""
    t = np.arange(cfg.samples_per_symbol, dtype=np.float64)
    carrier_phase = 2.0 * np.pi * cfg.carrier_freq * t / cfg.sample_rate
    out = np.cos(carrier_phase[None, :] + phases[:, None])
    return out.reshape(-1).astype(np.float32)


def generate_preamble(cfg: DPSKConfig) -> np.ndarray:
    """Barker-13 x3 as absolute BPSK phases (0 / pi)."""
    seq = np.tile(BARKER13, BARKER_REPEATS)
    phases = np.where(seq > 0, 0.0, np.pi)
    return _synth(phases, cfg)


def modulate(bits: np.ndarray, cfg: DPSKConfig) -> np.ndarray:
    """Reference symbol + differentially-encoded data symbols."""
    bits = np.asarray(bits, np.int64)
    bps = cfg.bits_per_symbol
    S = cfg.num_symbols_for_bits(len(bits))
    padded = np.zeros(S * bps, np.int64)
    padded[: len(bits)] = bits
    grouped = padded.reshape(S, bps)
    vals = np.zeros(S, np.int64)
    for b in range(bps):
        vals = (vals << 1) | grouped[:, b]
    dphi = cfg.phase_increment(vals)
    phases = np.concatenate([[0.0], np.cumsum(dphi)])  # ref symbol at phase 0
    return _synth(phases, cfg)


def tx_frame(bits: np.ndarray, cfg: DPSKConfig) -> np.ndarray:
    return np.concatenate([generate_preamble(cfg), modulate(bits, cfg)])


class DPSKSyncResult(NamedTuple):
    detected: jnp.ndarray
    data_start: jnp.ndarray  # first sample of the reference symbol
    corr: jnp.ndarray


def _symbol_phasors(samples: jnp.ndarray, cfg: DPSKConfig, num_symbols: int,
                    offset) -> jnp.ndarray:
    """Mix-integrate num_symbols symbols starting at `offset` -> [.., S] complex."""
    sps = cfg.samples_per_symbol
    t = np.arange(sps, dtype=np.float64)
    mixer = np.exp(-2j * np.pi * cfg.carrier_freq * t / cfg.sample_rate).astype(np.complex64)
    x = jax.lax.dynamic_slice_in_dim(samples, offset, num_symbols * sps, axis=-1)
    frames = x.reshape(x.shape[:-1] + (num_symbols, sps))
    return (frames.astype(jnp.complex64) @ mixer) / sps


@functools.partial(jax.jit, static_argnames=("cfg",))
def find_preamble(samples: jnp.ndarray, cfg: DPSKConfig) -> DPSKSyncResult:
    """Correlate the Barker differential-sign sequence at sub-symbol lags."""
    sps = cfg.samples_per_symbol
    P = cfg.preamble_symbols
    n = samples.shape[-1]
    need = (P + 1) * sps
    step = sps // 8
    num_off = max((n - need) // step, 1)
    if n < need + step:
        shape = samples.shape[:-1]
        return DPSKSyncResult(jnp.zeros(shape, bool), jnp.full(shape, -1, jnp.int32),
                              jnp.zeros(shape, jnp.float32))

    seq = np.tile(BARKER13, BARKER_REPEATS).astype(np.float32)
    # Differential sign template between adjacent Barker symbols.
    dtemplate = seq[1:] * seq[:-1]  # [P-1]

    def score_at(off):
        z = _symbol_phasors(samples, cfg, P, off)
        diff = jnp.real(z[..., 1:] * jnp.conj(z[..., :-1]))
        num = jnp.sum(diff * dtemplate, axis=-1)
        den = jnp.sum(jnp.abs(diff), axis=-1) + 1e-9
        return jnp.stack([num / den, num], axis=-1)

    offs = jnp.arange(num_off) * step
    both = jnp.moveaxis(jax.vmap(score_at)(offs), 0, -2)
    scores, energies = both[..., 0], both[..., 1]
    # Coarse peak by UNNORMALIZED matched-filter energy: Barker-13x3 is
    # 13-symbol periodic, so against a silent lead-in a PARTIAL overlap 13
    # symbols early scores a perfect normalized correlation (silence
    # symbols contribute 0 to both num and den) and the normalized argmax
    # false-locks one repetition early.  Energy peaks only at the full
    # overlap; the normalized value AT that offset still provides the
    # amplitude-independent detection threshold.
    best = jnp.argmax(energies, axis=-1).astype(jnp.int32)
    coarse = best * step

    # Fine pass: maximize total symbol-integration energy around the coarse
    # peak (energy peaks at exact symbol alignment).
    # The normalized coarse metric saturates into a plateau at high SNR, so
    # the energy refinement must cover a full symbol either side.
    fine_step = 16
    fine_offsets = jnp.arange(-sps, sps + 1, fine_step, dtype=jnp.int32)

    def energy_at(delta):
        off = jnp.clip(coarse + delta, 0, n - need)
        z = _symbol_phasors(samples, cfg, P, off)
        diff = jnp.real(z[..., 1:] * jnp.conj(z[..., :-1]))
        return jnp.sum(diff * dtemplate, axis=-1)

    fine_scores = jnp.moveaxis(jax.vmap(energy_at)(fine_offsets), 0, -1)
    fbest = jnp.argmax(fine_scores, axis=-1)
    refined = jnp.clip(coarse + fine_offsets[fbest], 0, n - need)

    val = jnp.take_along_axis(scores, best[..., None], -1)[..., 0]
    detected = val > 0.6
    start = refined + P * sps
    return DPSKSyncResult(detected, jnp.where(detected, start, -1), val)


class DPSKDemodResult(NamedTuple):
    soft_bits: jnp.ndarray
    phase_noise_var: jnp.ndarray
    snr_estimate_db: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("cfg", "num_bits"))
def demodulate(data_samples: jnp.ndarray, cfg: DPSKConfig, num_bits: int) -> DPSKDemodResult:
    """Demod [ref symbol + data symbols] starting at the reference symbol."""
    bps = cfg.bits_per_symbol
    S = cfg.num_symbols_for_bits(num_bits)
    z = _symbol_phasors(data_samples, cfg, S + 1, 0)
    diff = z[..., 1:] * jnp.conj(z[..., :-1])
    phase = jnp.angle(diff)

    if bps == 1:
        ideal = jnp.round(phase / jnp.pi) * jnp.pi
    elif bps == 2:
        ideal = jnp.round((phase - jnp.pi / 4) / (jnp.pi / 2)) * (jnp.pi / 2) + jnp.pi / 4
    else:
        ideal = jnp.round((phase - jnp.pi / 8) / (jnp.pi / 4)) * (jnp.pi / 4) + jnp.pi / 8
    err = phase - ideal
    err = jnp.where(err > jnp.pi, err - 2 * jnp.pi, err)
    err = jnp.where(err < -jnp.pi, err + 2 * jnp.pi, err)
    pvar = jnp.maximum(jnp.mean(jnp.square(err), axis=-1), 0.01)
    scale = jnp.minimum(2.0 * jnp.sqrt(1.0 / pvar), 20.0)[..., None]

    if bps == 1:
        soft = (scale * jnp.cos(phase))[..., None]
    elif bps == 2:
        # Max-log over the four TX phases (2v+1)*45 deg.
        cand = cfg.phase_increment(np.arange(4))
        d = jnp.cos(phase[..., None] - cand)  # similarity to each phase
        b0 = ((np.arange(4) >> 1) & 1).astype(bool)
        b1 = (np.arange(4) & 1).astype(bool)
        m0_0 = jnp.max(jnp.where(~b0, d, -jnp.inf), axis=-1)
        m0_1 = jnp.max(jnp.where(b0, d, -jnp.inf), axis=-1)
        m1_0 = jnp.max(jnp.where(~b1, d, -jnp.inf), axis=-1)
        m1_1 = jnp.max(jnp.where(b1, d, -jnp.inf), axis=-1)
        soft = jnp.stack([scale * (m0_0 - m0_1), scale * (m1_0 - m1_1)], axis=-1)
    else:
        cand = cfg.phase_increment(np.arange(8))
        d = jnp.cos(phase[..., None] - cand)
        softs = []
        for b in range(3):
            mask = (((np.arange(8)) >> (2 - b)) & 1).astype(bool)
            m0 = jnp.max(jnp.where(~mask, d, -jnp.inf), axis=-1)
            m1 = jnp.max(jnp.where(mask, d, -jnp.inf), axis=-1)
            softs.append(scale * (m0 - m1))
        soft = jnp.stack(softs, axis=-1)

    soft = jnp.clip(soft, -20.0, 20.0)
    soft = soft.reshape(soft.shape[:-2] + (S * bps,))[..., :num_bits]
    snr = 10.0 * jnp.log10(1.0 / pvar)
    return DPSKDemodResult(soft, pvar, snr)
