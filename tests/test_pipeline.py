"""Batched RX pipeline correctness (the bench/serving programs).

The jitted batch programs in phy/pipeline.py are what bench.py and the mesh
layer run; these tests pin their end-to-end correctness (sync, demod,
deinterleave, LDPC) on CPU at small-but-real geometry.
"""

from __future__ import annotations

import jax
import numpy as np

from ria_tpu.fec.ldpc import make_encoder
from ria_tpu.fec.ldpc_matrix import get_code
from ria_tpu.utils.bits import bits_to_bytes


def test_mc_dpsk_rx_pipeline_decodes_batch():
    from ria_tpu.phy.pipeline import make_rx_pipeline, make_tx_pipeline
    from ria_tpu.sync.chirp import ChirpConfig
    from ria_tpu.wave.mc_dpsk import MCDPSKConfig

    chirp = ChirpConfig(duration_ms=20.0, gap_ms=4.0)
    cfg = MCDPSKConfig(num_carriers=8, samples_per_symbol=256,
                       bits_per_symbol=2, training_symbols=4, chirp=chirp)
    ncw, B = 2, 4
    nb = ncw * 648
    window = cfg.frame_samples(nb) + 4000
    rng = np.random.default_rng(0)
    code = get_code("R1_4")
    info = rng.integers(0, 2, (B * ncw, code.k)).astype(np.uint8)
    coded = np.asarray(make_encoder("R1_4")(info)).reshape(B, nb)
    tx = np.asarray(make_tx_pipeline(cfg, ncw)(coded))
    audio = np.zeros((B, window), np.float32)
    for b in range(B):
        lead = int(rng.integers(0, 3000))
        audio[b, lead : lead + tx.shape[1]] = tx[b, : window - lead]
    rms = float(np.sqrt(np.mean(tx**2)))
    audio += rng.normal(0, rms * 10 ** (-8 / 20), audio.shape).astype(np.float32)

    rx = make_rx_pipeline(cfg, "R1_4", ncw, window)
    out = jax.block_until_ready(rx(audio))
    assert np.asarray(out.detected).all()
    assert np.asarray(out.cw_success).all()
    got = np.asarray(out.info_bits).reshape(B * ncw, -1)[:, : code.k]
    assert (got == info).all()


def test_ofdm_rx_pipeline_config3():
    """North-star config #3 geometry: OFDM DQPSK R1/2 at 15 dB, fixed 4-CW
    frames with channel+frame interleave, Schmidl-Cox acquisition — decoded
    payload byte-exact for the whole batch."""
    from ria_tpu.phy.frame_v2 import encode_fixed_frame
    from ria_tpu.phy.pipeline import make_ofdm_rx_pipeline
    from ria_tpu.wave.ofdm import OFDMConfig, tx_frame

    cfg = OFDMConfig(modulation="DQPSK", use_pilots=False)
    rate = "R1_2"
    ci = cfg.bits_per_ofdm_symbol()
    rng = np.random.default_rng(1)
    B = 4
    bpc = get_code(rate).k // 8
    S = cfg.num_symbols_for_bits(4 * 648)
    window = cfg.preamble_samples + (2 + S) * cfg.symbol_samples + 6000

    payloads, audio = [], np.zeros((B, window), np.float32)
    for b in range(B):
        p = rng.integers(0, 256, 4 * bpc).astype(np.uint8).tobytes()
        payloads.append(p)
        tx = tx_frame(encode_fixed_frame(p, rate, ci), cfg, preamble="cox")
        lead = int(rng.integers(0, 3000))
        audio[b, lead : lead + len(tx)] = tx
    rms = float(np.sqrt(np.mean(tx**2)))
    audio += rng.normal(0, rms * 10 ** (-15 / 20), audio.shape).astype(np.float32)

    rx = make_ofdm_rx_pipeline(cfg, rate, window, ci)
    out = jax.block_until_ready(rx(audio))
    assert np.asarray(out.detected).all()
    assert np.asarray(out.cw_success).all()
    for b in range(B):
        got = b"".join(
            bytes(bits_to_bytes(np.asarray(out.info_bits[b, i]))[:bpc])
            for i in range(4))
        assert got == payloads[b]
