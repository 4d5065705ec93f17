"""OTFS mode x channel success matrix (basis for channel_probe routing).

Reproduces the reference's adaptive-modem empirics (adaptive_modem.hpp:
216-224) on this framework: frame success of OTFS_EQ (TF-equalized
coherent QPSK), OTFS_RAW (DD differential, no equalization) and OFDM
DQPSK R1/2 over the ITU-R Good / Moderate / Poor presets.

Measured here (20 dB, stationary-init Watterson) — the reason Poor routes
to OTFS_EQ instead of the reference's OTFS_RAW (EQ = static preamble MMSE +
decision-directed per-symbol gain tracking, wave/otfs.py phase_tracking;
20-seed A/B: tracking lifts Moderate 13->15/20 and Poor 11->12/20):
  Good:     EQ 20/20, RAW 0/10, OFDM 10/10
  Moderate: EQ 15/20, RAW 0/10, OFDM  5/10 (kept OFDM per reference table)
  Poor:     EQ 12/20, RAW 0/10, OFDM  2/10 (raw-DD hits the 2 ms
            twisted-convolution ISI floor; SNR-independent, 0/25 even
            at 35 dB)

Usage: python tools/otfs_mode_sweep.py [--seeds 10] [--snr-db 20]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--snr-db", type=float, default=20.0)
    args = ap.parse_args(argv)

    import numpy as np
    import jax
    import jax.numpy as jnp

    from ria_tpu.fec import LDPCCodec
    from ria_tpu.sim import PRESETS, apply_channel
    from ria_tpu.utils.bits import bytes_to_bits
    from ria_tpu.wave.otfs import OTFSConfig, demodulate_presynced, tx_frame

    payload = b"OTFS PAYLOAD TEST!!!"
    codec = LDPCCodec("R1_2")
    bits = bytes_to_bits(codec.encode(payload))

    def otfs_once(cfg, seed, ch):
        tx = tx_frame(bits, cfg)
        audio = np.concatenate([np.zeros(2000, np.float32), tx,
                                np.zeros(2000, np.float32)])
        out = np.asarray(apply_channel(jnp.asarray(audio),
                                       jax.random.PRNGKey(seed), ch).samples)
        res = demodulate_presynced(jnp.asarray(out[2000:]), jnp.float32(0.0), cfg)
        soft = np.asarray(res.soft_bits)[: len(bits)]
        ok, dec = codec.decode_soft(soft)
        return bool(ok and dec[: len(payload)] == payload)

    def ofdm_once(seed, ch):
        from ria_tpu.phy.frame_v2 import WaveformMode, make_fixed_data_frame
        from ria_tpu.wave.api import create_waveform

        wf = create_waveform(WaveformMode.OFDM_CHIRP, "DQPSK", "R1_2")
        frame = make_fixed_data_frame("W1AW", "VE3ABC", seed, payload, "R1_2")
        tx = wf.tx_frame(frame.serialize())
        audio = np.concatenate([np.zeros(4000, np.float32), tx,
                                np.zeros(6000, np.float32)])
        out = np.asarray(apply_channel(jnp.asarray(audio),
                                       jax.random.PRNGKey(seed), ch).samples)
        return bool(wf.rx_frame(out).ok)

    modes = {
        "OTFS_EQ": lambda s, ch: otfs_once(
            OTFSConfig(modulation="QPSK", tf_equalization=True,
                       phase_tracking=True), s, ch),
        "OTFS_RAW": lambda s, ch: otfs_once(
            OTFSConfig(dd_differential=True, tf_equalization=False), s, ch),
        "OFDM": ofdm_once,
    }
    print(f"{'channel':10s} " + " ".join(f"{m:>9s}" for m in modes))
    for chname in ("good", "moderate", "poor"):
        row = []
        for mname, fn in modes.items():
            wins = sum(fn(s, PRESETS[chname](args.snr_db))
                       for s in range(args.seeds))
            row.append(f"{wins}/{args.seeds}")
        print(f"{chname:10s} " + " ".join(f"{r:>9s}" for r in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
