"""Full adaptive-session SNR sweep (BASELINE config #5).

Runs complete protocol sessions — chirp-synced PING handshake, CONNECT with
measured-SNR waveform auto-selection, DATA transfer, DISCONNECT — at a grid
of SNRs from the MC-DPSK floor to the coherent-QAM ceiling on a fading
channel, with no forced waveform/mod/rate.  This is the reference's
threaded_simulator dual-modem trace scenario (SURVEY.md §6 config #5):
the point is that the stack *itself* picks a working mode at every SNR.

Prints one line per (snr, channel) point: negotiated link, messages
delivered, retransmissions, chase recoveries.  Exit 0 iff every point
connects and delivers all messages.

Usage:
  python tools/adaptive_session_sweep.py                     # default grid
  python tools/adaptive_session_sweep.py --snrs -11,-5,5,15,25 --channel good
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import sys
import time
import types

from cli_simulator import run_session

# Default grid: floor of each operating regime on its intended channel.
#   -8 dB  session floor on good fading with HONEST stationary noise:
#          PING + spread-4 CONNECT escalation territory.  (The earlier -11
#          point only passed while the simulator's inter-frame gaps were
#          ~10 dB quieter than in-frame noise, the reference's per-call
#          normalization artifact; -11 still closes on AWGN.)
#    -5 dB  MC-DPSK 4x/2x
#     0 dB  MC-DPSK DBPSK
#     6 dB  MC-DPSK DQPSK
#    12 dB  OFDM DQPSK low rate
#    18 dB  OFDM DQPSK/QAM16 mid rate
#    25 dB  coherent QAM high rate
DEFAULT_SNRS = [-8.0, -5.0, 0.0, 6.0, 12.0, 18.0, 25.0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--snrs", default=None,
                    help="comma-separated SNR grid (default: regime floors)")
    ap.add_argument("--channel", default="good",
                    choices=["awgn", "good", "moderate", "poor", "flutter"])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--num-messages", type=int, default=2)
    args = ap.parse_args(argv)

    snrs = ([float(s) for s in args.snrs.split(",")] if args.snrs
            else DEFAULT_SNRS)
    print(f"adaptive_session_sweep: channel={args.channel} seed={args.seed} "
          f"snrs={snrs}")

    rows, ok = [], True
    for snr in snrs:
        sess = types.SimpleNamespace(
            snr=snr, channel=args.channel, waveform="AUTO", mod="AUTO",
            rate="AUTO", num_messages=args.num_messages, file=False,
            save_signals=None)
        print(f"SNR {snr:+.0f} dB:")
        t0 = time.time()
        r = run_session(sess, args.seed)
        passed = r["connected"] and r["messages"] == args.num_messages
        ok &= passed
        rows.append((snr, r.get("final_link", r.get("link", "-")), r["messages"],
                     r.get("retransmissions", 0), r.get("chase", 0),
                     "PASS" if passed else "FAIL", time.time() - t0))
        # Each SNR point negotiates a different mode and compiles fresh
        # pipelines; without this the CPU-XLA executables of all previous
        # points stay resident and long sweeps exhaust host memory
        # ("LLVM compilation error: Cannot allocate memory").
        import jax

        from ria_tpu.phy import pipeline as _pl

        _pl.make_rx_pipeline.cache_clear()
        _pl.make_tx_pipeline.cache_clear()
        jax.clear_caches()

    print("\n  SNR   negotiated link              msgs retx chase  result")
    for snr, link, msgs, retx, chase, status, wall in rows:
        print(f"  {snr:+5.0f}  {link:28s} {msgs}/{args.num_messages}  "
              f"{retx:3d}  {chase:3d}   {status}  ({wall:.0f}s)")
    print("SWEEP:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
