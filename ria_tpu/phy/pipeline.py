"""Monolithic jitted RX/TX pipelines over batches of channels.

This is the array-program answer to the reference's StreamingDecoder hot loop
(src/gui/modem/streaming_decoder.cpp:354-470 + 2595): instead of a stateful
per-sample state machine, a whole window of audio per channel is processed as
one compiled program — sync search (batched FFT correlation), frame slicing
(dynamic_slice), mixer-bank demodulation, and batched LDPC belief propagation
— for B independent channels at once.  Shard the batch axis over a device
mesh for multi-chip scale-out (see ria_tpu.parallel).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ria_tpu.fec.ldpc import make_decoder
from ria_tpu.fec.ldpc_matrix import RECOMMENDED_ITERS
from ria_tpu.sync.chirp import detect_dual_chirp
from ria_tpu.wave.mc_dpsk import MCDPSKConfig, demodulate

LDPC_BITS = 648


class RxBatchResult(NamedTuple):
    detected: jnp.ndarray    # [B] bool
    start: jnp.ndarray       # [B] int32 chirp start
    cfo_hz: jnp.ndarray      # [B]
    cw_success: jnp.ndarray  # [B, NCW] bool
    info_bits: jnp.ndarray   # [B, NCW, k] uint8
    iterations: jnp.ndarray  # [B, NCW]
    snr_db: jnp.ndarray      # [B]


@functools.lru_cache(maxsize=None)
def make_rx_pipeline(cfg: MCDPSKConfig, rate: str, num_codewords: int,
                     window_samples: int, min_sum_factor: float = 0.75):
    """Build a jitted batch RX: audio [B, window] -> RxBatchResult.

    Decodes frames of a known codeword count (the common case for fixed-size
    protocol frames; variable frames use the host-side CW0-peek path in
    ria_tpu.phy.modem).
    """
    num_bits = num_codewords * LDPC_BITS
    n_sym = cfg.num_data_symbols(num_bits)
    frame_need = (cfg.training_symbols + 1 + n_sym * cfg.spreading) * cfg.samples_per_symbol
    decoder = make_decoder(rate, RECOMMENDED_ITERS[rate], min_sum_factor)

    def rx(audio: jnp.ndarray) -> RxBatchResult:
        B = audio.shape[0]
        sync = detect_dual_chirp(audio, cfg.chirp)

        start = jnp.clip(sync.start + cfg.chirp.total_samples, 0,
                         max(window_samples - frame_need, 0))

        def slice_one(a, s):
            return jax.lax.dynamic_slice(a, (s,), (frame_need,))

        frames = jax.vmap(slice_one)(audio, start)
        demod = demodulate(frames, sync.cfo_hz, cfg, n_sym)

        soft = demod.soft_bits[..., :num_bits].reshape(B * num_codewords, LDPC_BITS)
        dec = decoder(soft)
        k = dec.info_bits.shape[-1]
        return RxBatchResult(
            detected=sync.detected,
            start=sync.start,
            cfo_hz=sync.cfo_hz,
            cw_success=dec.success.reshape(B, num_codewords) & sync.detected[:, None],
            info_bits=dec.info_bits.reshape(B, num_codewords, k),
            iterations=dec.iterations.reshape(B, num_codewords),
            snr_db=demod.snr_estimate_db,
        )

    return jax.jit(rx)


class OFDMRxBatchResult(NamedTuple):
    detected: jnp.ndarray    # [B] bool
    lts_start: jnp.ndarray   # [B] int32
    cfo_hz: jnp.ndarray      # [B]
    cw_success: jnp.ndarray  # [B, 4] bool
    info_bits: jnp.ndarray   # [B, 4, k] uint8
    iterations: jnp.ndarray  # [B, 4]
    snr_db: jnp.ndarray      # [B]


@functools.lru_cache(maxsize=None)
def make_ofdm_rx_pipeline(cfg, rate: str, window_samples: int,
                          ci_bits: int | None = None,
                          min_sum_factor: float = 0.9375):
    """Batched OFDM RX over [B, window]: one jitted program running
    Schmidl-Cox search -> CP strip + 1024-pt FFT -> LTS channel estimate ->
    MMSE equalize -> soft demap -> frame/channel deinterleave (static
    gathers) -> batched LDPC BP.

    The array-program answer to the reference's per-symbol OFDM state machine
    (src/ofdm/demodulator.cpp:787-1093): the whole fixed 4-CW data frame
    (streaming_encoder.cpp encodeFixedFrame) of every channel is one
    compiled program.  cfg: wave.ofdm.OFDMConfig.
    """
    from ria_tpu.fec.interleave import channel_perm, frame_perm
    from ria_tpu.wave.ofdm import demodulate_presynced, schmidl_cox_search

    num_bits = 4 * LDPC_BITS
    S = cfg.num_symbols_for_bits(num_bits)
    need = (2 + S) * cfg.symbol_samples
    decoder = make_decoder(rate, RECOMMENDED_ITERS[rate], min_sum_factor)

    # Static deinterleave gathers (inverse of apply_perm's scatter form):
    # frame deinterleave = x[..., frame_perm()]; channel deinterleave (within
    # each 648-bit codeword) = x[..., channel_perm(ci_bits)].
    gather_idx = frame_perm()
    ci_gather = channel_perm(ci_bits) if ci_bits else None

    def rx(audio: jnp.ndarray) -> OFDMRxBatchResult:
        B = audio.shape[0]
        sync = schmidl_cox_search(audio, cfg)
        start = jnp.clip(jnp.where(sync.detected, sync.lts_start, 0), 0,
                         max(window_samples - need, 0))

        frames = jax.vmap(
            lambda a, s: jax.lax.dynamic_slice(a, (s,), (need,)))(audio, start)
        demod = demodulate_presynced(frames, sync.cfo_hz, cfg, S, 2)

        soft = demod.soft_bits[..., :num_bits]
        soft = soft[..., jnp.asarray(gather_idx)]            # frame deint
        cw_soft = soft.reshape(B, 4, LDPC_BITS)
        if ci_gather is not None:
            cw_soft = cw_soft[..., jnp.asarray(ci_gather)]   # channel deint
        dec = decoder(cw_soft.reshape(B * 4, LDPC_BITS))
        k = dec.info_bits.shape[-1]
        return OFDMRxBatchResult(
            detected=sync.detected,
            lts_start=sync.lts_start,
            cfo_hz=sync.cfo_hz,
            cw_success=dec.success.reshape(B, 4) & sync.detected[:, None],
            info_bits=dec.info_bits.reshape(B, 4, k),
            iterations=dec.iterations.reshape(B, 4),
            snr_db=demod.snr_db,
        )

    return jax.jit(rx)


@functools.lru_cache(maxsize=None)
def make_tx_pipeline(cfg: MCDPSKConfig, num_codewords: int):
    """Build a jitted batch TX: coded bits [B, NCW*648] -> audio [B, samples].

    Jitted mirror of wave.mc_dpsk.modulate()+preamble() for throughput
    benchmarking and batched simulation (per-channel TX).
    """
    from ria_tpu.wave.mc_dpsk import _synth_matrix, _training_matrix
    from ria_tpu.sync.chirp import generate as chirp_generate

    num_bits = num_codewords * LDPC_BITS
    bpmc = cfg.bits_per_mc_symbol
    n_sym = cfg.num_data_symbols(num_bits)
    pad = n_sym * bpmc - num_bits

    # Keep constants as numpy: np arrays lower to MLIR constants straight from
    # host memory, whereas jnp device arrays in a closure require a device
    # readback at lowering time (unsupported on some PJRT backends).
    E = _synth_matrix(cfg)
    chirp = chirp_generate(cfg.chirp)
    train = _training_matrix(cfg)

    def tx(bits: jnp.ndarray) -> jnp.ndarray:
        B = bits.shape[0]
        b = jnp.pad(bits.astype(jnp.float32), ((0, 0), (0, pad)))
        grouped = b.reshape(B, n_sym, cfg.num_carriers, cfg.bits_per_symbol)
        if cfg.bits_per_symbol == 2:
            val = (grouped[..., 0] * 2 + grouped[..., 1]).astype(jnp.int32)
            dphi = jnp.asarray([jnp.pi / 4, 3 * jnp.pi / 4, -3 * jnp.pi / 4, -jnp.pi / 4])[val]
        else:
            dphi = grouped[..., 0] * jnp.pi
        phase = jnp.cumsum(dphi, axis=1)
        symbols = jnp.exp(1j * phase)                      # [B, S, C]
        ref = jnp.ones((B, 1, cfg.num_carriers), jnp.complex64)
        tr = jnp.broadcast_to(train, (B,) + train.shape)
        allsym = jnp.concatenate([tr, ref, jnp.repeat(symbols, cfg.spreading, axis=1)], axis=1)
        wave = jnp.real(allsym @ E.T) / cfg.num_carriers   # [B, S_all, sps]
        body = wave.reshape(B, -1)
        ch = jnp.broadcast_to(chirp, (B, chirp.shape[0]))
        return jnp.concatenate([ch, body], axis=-1)

    return jax.jit(tx)
