"""Device-mesh scale-out for the modem pipelines.

The reference is a single-process C++ program (SURVEY.md §2.12); parallelism
here is a new first-class component: independent channels (audio streams) are
data-parallel over a `ch` mesh axis, and the batched-LDPC codeword dimension
is additionally spread over a `cw` axis, so belief propagation scales across
chips even when few channels are active.  XLA inserts the reshard collectives
(all-to-all over the device interconnect) at the annotated boundaries.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ria_tpu.fec.ldpc import make_decoder
from ria_tpu.fec.ldpc_matrix import RECOMMENDED_ITERS
from ria_tpu.phy.pipeline import LDPC_BITS, OFDMRxBatchResult, RxBatchResult
from ria_tpu.sync.chirp import detect_dual_chirp
from ria_tpu.wave.mc_dpsk import MCDPSKConfig, demodulate


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """2D mesh (ch x cw); cw gets a factor of 2 when device count allows."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    n = len(devices)
    cw = 2 if n % 2 == 0 and n >= 2 else 1
    ch = n // cw
    dev_array = np.asarray(devices).reshape(ch, cw)
    return Mesh(dev_array, axis_names=("ch", "cw"))


def make_sharded_ofdm_rx(mesh: Mesh, ofdm_cfg, rate: str, window_samples: int,
                         ci_bits: int | None = None):
    """Multi-chip OFDM RX: audio [B, window] with the batch sharded over the
    WHOLE mesh; each device runs the full chain — Schmidl-Cox + LTS search,
    CP/FFT + MMSE + demap, deinterleave — on its local rows and decodes its
    local codewords with the XLA while_loop decoder.  shard_map keeps the
    decode per-device, so each device's early exit depends only on its own
    codewords.

    B must be divisible by the device count.
    """
    from ria_tpu.fec.interleave import channel_perm, frame_perm
    from ria_tpu.wave.ofdm import demodulate_presynced, schmidl_cox_search

    num_bits = 4 * LDPC_BITS
    S = ofdm_cfg.num_symbols_for_bits(num_bits)
    need = (2 + S) * ofdm_cfg.symbol_samples
    gather_idx = frame_perm()
    ci_gather = channel_perm(ci_bits) if ci_bits else None
    axes = tuple(mesh.axis_names)

    decoder = make_decoder(rate, RECOMMENDED_ITERS[rate], 0.9375)

    def local_rx(audio: jnp.ndarray):
        b = audio.shape[0]
        sync = schmidl_cox_search(audio, ofdm_cfg)
        start = jnp.clip(jnp.where(sync.detected, sync.lts_start, 0), 0,
                         max(window_samples - need, 0))
        frames = jax.vmap(
            lambda a, s: jax.lax.dynamic_slice(a, (s,), (need,)))(audio, start)
        demod = demodulate_presynced(frames, sync.cfo_hz, ofdm_cfg, S, 2)
        soft = demod.soft_bits[..., :num_bits]
        soft = soft[..., jnp.asarray(gather_idx)]
        cw_soft = soft.reshape(b * 4, LDPC_BITS)
        if ci_gather is not None:
            cw_soft = cw_soft.reshape(b, 4, LDPC_BITS)[..., jnp.asarray(ci_gather)]
            cw_soft = cw_soft.reshape(b * 4, LDPC_BITS)
        dec = decoder(cw_soft)
        k = dec.info_bits.shape[-1]
        return (sync.detected, sync.lts_start, sync.cfo_hz,
                dec.success.reshape(b, 4) & sync.detected[:, None],
                dec.info_bits.reshape(b, 4, k),
                demod.snr_db)

    sharded = shard_map(local_rx, mesh=mesh,
                        in_specs=P(axes, None),
                        out_specs=(P(axes), P(axes), P(axes),
                                   P(axes, None), P(axes, None, None), P(axes)),
                        check_vma=False)

    def rx(audio: jnp.ndarray):
        detected, lts_start, cfo, ok, info, snr = sharded(audio)
        return OFDMRxBatchResult(detected=detected, lts_start=lts_start,
                                 cfo_hz=cfo, cw_success=ok, info_bits=info,
                                 iterations=jnp.zeros_like(ok, jnp.int32),
                                 snr_db=snr)

    return jax.jit(rx, in_shardings=NamedSharding(mesh, P(axes, None)))


def make_sharded_rx(mesh: Mesh, cfg: MCDPSKConfig, rate: str, num_codewords: int,
                    window_samples: int):
    """Jitted multi-chip MC-DPSK RX: audio [B, window] with the batch sharded
    over the WHOLE mesh; each device runs sync + demod + LDPC on its local
    rows (shard_map keeps the decode per-device — see make_sharded_ofdm_rx).
    B must be divisible by the device count."""
    num_bits = num_codewords * LDPC_BITS
    n_sym = cfg.num_data_symbols(num_bits)
    frame_need = (cfg.training_symbols + 1 + n_sym * cfg.spreading) * cfg.samples_per_symbol
    axes = tuple(mesh.axis_names)

    decoder_fn = make_decoder(rate, RECOMMENDED_ITERS[rate])

    def local_rx(audio: jnp.ndarray):
        b = audio.shape[0]
        sync = detect_dual_chirp(audio, cfg.chirp)
        start = jnp.clip(sync.start + cfg.chirp.total_samples, 0,
                         max(window_samples - frame_need, 0))
        frames = jax.vmap(lambda a, s: jax.lax.dynamic_slice(a, (s,), (frame_need,)))(audio, start)
        demod = demodulate(frames, sync.cfo_hz, cfg, n_sym)
        soft = demod.soft_bits[..., :num_bits].reshape(b * num_codewords, LDPC_BITS)
        dec = decoder_fn(soft)
        k = dec.info_bits.shape[-1]
        return (sync.detected, sync.start, sync.cfo_hz,
                dec.success.reshape(b, num_codewords) & sync.detected[:, None],
                dec.info_bits.reshape(b, num_codewords, k),
                dec.iterations.reshape(b, num_codewords),
                demod.snr_estimate_db)

    sharded = shard_map(local_rx, mesh=mesh,
                        in_specs=P(axes, None),
                        out_specs=(P(axes), P(axes), P(axes), P(axes, None),
                                   P(axes, None, None), P(axes, None), P(axes)),
                        check_vma=False)

    def rx(audio: jnp.ndarray) -> RxBatchResult:
        detected, start, cfo, ok, info, iters, snr = sharded(audio)
        return RxBatchResult(detected=detected, start=start, cfo_hz=cfo,
                             cw_success=ok, info_bits=info,
                             iterations=iters, snr_db=snr)

    return jax.jit(rx, in_shardings=NamedSharding(mesh, P(axes, None)))
