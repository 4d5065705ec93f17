"""Multi-Carrier DPSK waveform (the low-SNR workhorse), as array programs.

Numeric contract from the reference (src/psk/multi_carrier_dpsk.hpp):
- N carriers evenly spaced freq_low..freq_high (default 10 @ 500-2500 Hz),
  512 samples/symbol (93.75 baud), DBPSK or DQPSK differential per carrier,
  carrier phase restarts at 0 every symbol (:156-159, :256-259);
- preamble = dual chirp + 8 training symbols (pattern e^{j c*s*pi/2}) +
  1 all-ones reference symbol (:127-196);
- 2x/4x time spreading: repeat symbols at TX, coherently combine at RX
  BEFORE differential decode (:548-573) for +3/+6 dB;
- LLR scale = min(2*sqrt(1/max(phase_noise_var, 0.01)), 20), soft bits
  clamped +/-20 (:634-642, :698-707);
- DBPSK per-carrier reliability weights: magnitude ratio x temporal
  stability x weak-carrier damping, clamped [0.12, 1.25] (:644-688);
- trailing-silence exclusion: reference energy = mean of first 4 symbols,
  symbols below 20% excluded from reliability stats (:604-632).

Array redesign: modulation and demodulation are single complex matmuls against
a static [samples_per_symbol, carriers] mixer bank — every symbol and every
carrier at once on the matrix units — instead of per-carrier per-sample loops.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ria_tpu.sync.chirp import ChirpConfig, generate as chirp_generate


@dataclass(frozen=True)
class MCDPSKConfig:
    sample_rate: float = 48000.0
    num_carriers: int = 10
    freq_low: float = 500.0
    freq_high: float = 2500.0
    samples_per_symbol: int = 512
    bits_per_symbol: int = 1  # 1 = DBPSK, 2 = DQPSK
    spreading: int = 1        # 1, 2 or 4 (TIME_2X / TIME_4X)
    training_symbols: int = 8
    chirp: ChirpConfig = field(default_factory=ChirpConfig)

    @property
    def carrier_freqs(self) -> tuple[float, ...]:
        if self.num_carriers == 1:
            return ((self.freq_low + self.freq_high) / 2.0,)
        spacing = (self.freq_high - self.freq_low) / (self.num_carriers - 1)
        return tuple(self.freq_low + i * spacing for i in range(self.num_carriers))

    @property
    def bits_per_mc_symbol(self) -> int:
        return self.num_carriers * self.bits_per_symbol

    @property
    def preamble_samples(self) -> int:
        return self.chirp.total_samples + (self.training_symbols + 1) * self.samples_per_symbol

    def num_data_symbols(self, num_bits: int) -> int:
        """Unique data symbols (pre-spreading) to carry num_bits."""
        return -(-num_bits // self.bits_per_mc_symbol)

    def num_rx_symbols(self, num_bits: int) -> int:
        return self.num_data_symbols(num_bits) * self.spreading

    def frame_samples(self, num_bits: int) -> int:
        """Samples from chirp start to end of data for a frame of num_bits."""
        return self.preamble_samples + self.num_rx_symbols(num_bits) * self.samples_per_symbol


@functools.lru_cache(maxsize=None)
def _synth_matrix(cfg: MCDPSKConfig) -> np.ndarray:
    """[sps, C] complex: e^{+j 2 pi f_c t}, t restarting at 0 each symbol."""
    t = np.arange(cfg.samples_per_symbol, dtype=np.float64)[:, None]
    f = np.asarray(cfg.carrier_freqs, dtype=np.float64)[None, :]
    return np.exp(2j * np.pi * f * t / cfg.sample_rate).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _training_matrix(cfg: MCDPSKConfig) -> np.ndarray:
    """[T, C] training constellation e^{j c*s*pi/2}."""
    s = np.arange(cfg.training_symbols)[:, None]
    c = np.arange(cfg.num_carriers)[None, :]
    return np.exp(1j * (c * s) * np.pi / 2.0).astype(np.complex64)


def _synthesize(symbols: np.ndarray, cfg: MCDPSKConfig) -> np.ndarray:
    """[S, C] complex constellation -> [S*sps] real samples (host TX path)."""
    E = _synth_matrix(cfg)
    out = np.real(symbols @ E.T.astype(np.complex64)) / cfg.num_carriers
    return out.reshape(-1).astype(np.float32)


DQPSK_PHASES = np.array([np.pi / 4, 3 * np.pi / 4, -3 * np.pi / 4, -np.pi / 4])
# Index by 2-bit symbol value; note the reference's table maps
# 10 -> -3pi/4 (index 2) and 11 -> -pi/4 (index 3)
# (src/psk/multi_carrier_dpsk.hpp:236-239).


def modulate(bits: np.ndarray, cfg: MCDPSKConfig) -> np.ndarray:
    """Data bits -> samples (differential, spread). Host numpy TX path.

    Differential state starts from the all-ones reference symbol, matching a
    TX that just emitted preamble().
    """
    bits = np.asarray(bits, dtype=np.int64)
    bpmc = cfg.bits_per_mc_symbol
    n_sym = -(-len(bits) // bpmc)
    padded = np.zeros(n_sym * bpmc, dtype=np.int64)
    padded[: len(bits)] = bits
    grouped = padded.reshape(n_sym, cfg.num_carriers, cfg.bits_per_symbol)
    if cfg.bits_per_symbol == 2:
        sym_val = grouped[..., 0] * 2 + grouped[..., 1]
        dphi = DQPSK_PHASES[sym_val]
    else:
        dphi = grouped[..., 0] * np.pi
    diff = np.exp(1j * dphi)              # [S, C]
    symbols = np.cumprod(diff, axis=0)    # differential from reference (=1)
    symbols /= np.abs(symbols)
    spread = np.repeat(symbols, cfg.spreading, axis=0)
    return _synthesize(spread.astype(np.complex64), cfg)


def preamble(cfg: MCDPSKConfig, tx_cfo_hz: float = 0.0) -> np.ndarray:
    """Chirp + training + reference symbol (host TX path)."""
    chirp = chirp_generate(cfg.chirp, tx_cfo_hz)
    train = _synthesize(_training_matrix(cfg), cfg)
    ref = _synthesize(np.ones((1, cfg.num_carriers), dtype=np.complex64), cfg)
    return np.concatenate([chirp, train, ref]).astype(np.float32)


class MCDPSKDemodResult(NamedTuple):
    soft_bits: jnp.ndarray        # [num_data_symbols * C * bps], clamped +/-20
    phase_noise_var: jnp.ndarray  # scalar
    freq_fading_index: jnp.ndarray
    temporal_fading_index: jnp.ndarray
    snr_estimate_db: jnp.ndarray  # from phase-noise variance
    zsym: jnp.ndarray             # [T+1+R, C] raw carrier integrals — the
    #                               per-symbol per-carrier channel samples
    #                               feeding handshake channel probing
    #                               (phy.channel_probe.estimate_mc_dpsk)


@functools.partial(jax.jit, static_argnames=("cfg", "num_data_symbols"))
def demodulate(frame_samples: jnp.ndarray, cfo_hz: jnp.ndarray, cfg: MCDPSKConfig,
               num_data_symbols: int) -> MCDPSKDemodResult:
    """Demodulate training+ref+data samples (chirp already consumed).

    frame_samples: [..., (T+1+R)*sps] real, starting at the training symbols;
    R = num_data_symbols * spreading rx symbols follow the reference symbol.
    Batched over leading axes.
    """
    sps = cfg.samples_per_symbol
    T = cfg.training_symbols
    R = num_data_symbols * cfg.spreading
    need = (T + 1 + R) * sps
    x = frame_samples[..., :need]

    # CFO correction fused into the mix: rotating the REAL signal by
    # e^{-j 2 pi cfo t} shifts its positive-frequency band onto the mixer
    # grid exactly like the reference's applyCFOCorrection + real-sample
    # downmix (multi_carrier_dpsk.hpp:901-926, :931-946); the negative-freq
    # image lands at -(f_k + f_m) and is rejected by the 512-sample
    # integration (>= 30 dB), the same rejection the reference's own
    # real-signal mixing relies on.  This avoids the two large FFTs of an
    # explicit Hilbert transform on the hot path.
    # Factored rotation ramp: t = s*sps + i, so exp(-jwt) = rot_sym[s] *
    # rot_in[i].  This needs sps + S transcendental evals per channel
    # instead of `need`, and keeps the exp arguments small (better f32
    # phase precision over long frames).
    S_all = T + 1 + R
    w = (2.0 * jnp.pi / cfg.sample_rate) * jnp.asarray(cfo_hz, jnp.float32)
    i_idx = jnp.arange(sps, dtype=jnp.float32)
    s_idx = jnp.arange(S_all, dtype=jnp.float32) * float(sps)
    rot_in = jnp.exp(-1j * w[..., None] * i_idx)     # [..., sps]
    rot_sym = jnp.exp(-1j * w[..., None] * s_idx)    # [..., S]

    # Mix-and-integrate every symbol x carrier at once: [S, sps] @ [sps, C].
    M = jnp.asarray(np.conj(_synth_matrix(cfg)) / cfg.samples_per_symbol)
    syms = x.reshape(x.shape[:-1] + (S_all, sps)).astype(jnp.complex64)
    zsym = (syms * rot_in[..., None, :]) @ M * rot_sym[..., :, None]  # [..., S, C]
    return soft_from_zsym(zsym, cfg, num_data_symbols)


def soft_from_zsym(zsym: jnp.ndarray, cfg: MCDPSKConfig,
                   num_data_symbols: int) -> MCDPSKDemodResult:
    """Differential decode + LLR stage on mix-integrated symbols.

    zsym: [..., T+1+R, C] complex carrier integrals (training, reference,
    data).  Split out of demodulate() so the sequence-parallel stream
    pipeline (ria_tpu.parallel.stream), whose mix-integrate stage runs
    distributed over time-block shards, shares these exact numerics.
    """
    T = cfg.training_symbols
    C = cfg.num_carriers

    z_ref = zsym[..., T, :]
    z_data = zsym[..., T + 1 :, :]

    # Coherent spreading combine BEFORE differential decode (:548-573).
    z_comb = z_data.reshape(z_data.shape[:-2] + (num_data_symbols, cfg.spreading, C)).mean(-2)
    mag = jnp.abs(z_comb)

    def _normalize(v):
        m = jnp.abs(v)
        return jnp.where(m > 1e-4, v / jnp.maximum(m, 1e-9), jnp.asarray(1.0 + 0j, jnp.complex64))

    prev0 = _normalize(z_ref)
    znorm = _normalize(z_comb)
    prev = jnp.concatenate([prev0[..., None, :], znorm[..., :-1, :]], axis=-2)
    diff = znorm * jnp.conj(prev)
    phase = jnp.angle(diff)  # [..., D, C]

    # Phase-noise variance vs nearest ideal constellation point (:581-600).
    if cfg.bits_per_symbol == 2:
        shifted = phase - jnp.pi / 4.0
        ideal = jnp.round(shifted / (jnp.pi / 2.0)) * (jnp.pi / 2.0) + jnp.pi / 4.0
    else:
        ideal = jnp.round(phase / jnp.pi) * jnp.pi
    err = phase - ideal
    err = jnp.where(err > jnp.pi, err - 2 * jnp.pi, err)
    err = jnp.where(err < -jnp.pi, err + 2 * jnp.pi, err)
    phase_noise_var = jnp.maximum(jnp.mean(jnp.square(err), axis=(-1, -2)), 0.01)
    scale = jnp.minimum(2.0 * jnp.sqrt(1.0 / phase_noise_var), 20.0)

    # Trailing-silence exclusion (:604-632): valid symbol count from the last
    # symbol whose total magnitude is >= 20% of the first-4-symbol mean.
    sym_total = jnp.sum(mag, axis=-1)  # [..., D]
    D = num_data_symbols
    if D >= 4:
        ref_mag = jnp.mean(sym_total[..., :4], axis=-1, keepdims=True)
        thr = ref_mag * 0.2
        idx = jnp.arange(D)
        above = jnp.where(sym_total >= thr, idx, -1)
        last_valid = jnp.max(above, axis=-1)
        valid_symbols = jnp.maximum(last_valid + 1, 4)
        valid_symbols = jnp.where(ref_mag[..., 0] > 1e-3, valid_symbols, D)
    else:
        valid_symbols = jnp.full(sym_total.shape[:-1], D)
    vmask = (jnp.arange(D) < valid_symbols[..., None]).astype(jnp.float32)  # [..., D]

    nvalid = jnp.maximum(jnp.sum(vmask, axis=-1, keepdims=True), 1.0)  # [..., 1]
    mag_v = mag * vmask[..., None]
    carrier_mean = jnp.sum(mag_v, axis=-2) / nvalid                  # [..., C]
    carrier_mean_sq = jnp.sum(jnp.square(mag_v), axis=-2) / nvalid   # [..., C]

    # DBPSK per-carrier reliability weights (:644-688).
    if cfg.bits_per_symbol == 1:
        gmask = (carrier_mean > 1e-4).astype(jnp.float32)
        gcount = jnp.maximum(jnp.sum(gmask, axis=-1, keepdims=True), 1.0)
        global_mean = jnp.sum(carrier_mean * gmask, axis=-1, keepdims=True) / gcount
        var = jnp.maximum(carrier_mean_sq - jnp.square(carrier_mean), 0.0)
        cv = jnp.sqrt(var) / (carrier_mean + 1e-6)
        mag_ratio = carrier_mean / jnp.maximum(global_mean, 1e-9)
        mag_weight = jnp.clip(mag_ratio, 0.10, 1.25)
        stability = 1.0 / (1.0 + 1.5 * cv)
        weak_damp = jnp.where(mag_ratio < 0.20, 0.25, jnp.where(mag_ratio < 0.35, 0.50, 1.0))
        w = jnp.clip(mag_weight * stability * weak_damp, 0.12, 1.25)
        dead = (carrier_mean <= 1e-4) | (global_mean <= 1e-4)
        reliability = jnp.where(dead, 0.12, w)
    else:
        reliability = jnp.ones_like(carrier_mean)

    carrier_scale = scale[..., None, None] * reliability[..., None, :]  # [...,1,C]
    if cfg.bits_per_symbol == 2:
        sb0 = carrier_scale * jnp.sin(phase)
        sb1 = carrier_scale * jnp.sin(2.0 * phase)
        soft = jnp.stack([sb0, sb1], axis=-1)  # [..., D, C, 2]
    else:
        soft = (carrier_scale * jnp.cos(phase))[..., None]  # [..., D, C, 1]
    soft = jnp.clip(soft, -20.0, 20.0)
    soft = soft.reshape(soft.shape[:-3] + (D * C * cfg.bits_per_symbol,))

    # Fading indices (:407-445, :716-733).
    cmean = carrier_mean
    mean_all = jnp.mean(cmean, axis=-1)
    std_all = jnp.std(cmean, axis=-1)
    freq_cv = jnp.where(mean_all > 1e-3, std_all / jnp.maximum(mean_all, 1e-9), 0.0)
    var_t = jnp.maximum(carrier_mean_sq - jnp.square(cmean), 0.0)
    cv_t = jnp.sqrt(var_t) / jnp.maximum(cmean, 1e-9)
    alive = (cmean >= 1e-3).astype(jnp.float32)
    acount = jnp.maximum(jnp.sum(alive, axis=-1), 1.0)
    temporal = jnp.where(
        jnp.squeeze(nvalid, -1) >= 4, jnp.sum(cv_t * alive, axis=-1) / acount, 0.0
    )

    # SNR from phase-noise variance: var ~= 1/SNR for small noise.
    snr_db = 10.0 * jnp.log10(1.0 / phase_noise_var)

    return MCDPSKDemodResult(
        soft_bits=soft,
        phase_noise_var=phase_noise_var,
        freq_fading_index=freq_cv,
        temporal_fading_index=temporal,
        snr_estimate_db=snr_db,
        zsym=zsym,
    )
