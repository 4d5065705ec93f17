"""Measured end-to-end session goodput (reference proof points).

Runs a full PING->CONNECT->bulk-DATA session through DualStationSim with
honest channel noise and measures DELIVERED payload bytes per VIRTUAL AIR
SECOND — handshake, mode negotiation, ACK turnaround, ARQ retransmits and
half-duplex pacing all included (only the transfer window is timed: from
the first send_message to the last delivery, matching the reference's
session-throughput convention).

Reference proof points (include/ultra/types.hpp:354-365, high_throughput
preset, measured over its cli_simulator):
  AWGN 25 dB      -> 64-QAM R3/4  7.5 kbps  (100% of runs)
  Good 20 dB      -> 16-QAM R2/3  4.9 kbps  (96%)
  Moderate 20 dB  ->               2.7 kbps  (60%)

tests/test_goodput.py CI-asserts these rows (10/10, 10/10, >=6/10 seeds).

Usage: python tools/goodput.py [--channel awgn --snr 25 --seeds 3 --bytes 4096]
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


def measure_goodput(channel: str, snr_db: float, seed: int,
                    payload_bytes: int = 4096, max_ticks: int = 3000) -> dict:
    """One seeded bulk-transfer session -> result dict.

    Returns: goodput_bps (delivered bits / virtual transfer seconds),
    delivered fraction, negotiated link, connect time, retransmits.
    """
    import numpy as np

    from ria_tpu.sim import PRESETS
    from ria_tpu.sim.simulator import DualStationSim

    sim = DualStationSim(channel_cfg=PRESETS[channel](snr_db), seed=seed)
    got: list[bytes] = []
    delivered_at: list[int] = []

    def _on_msg(m):
        got.append(m)
        delivered_at.append(sim.ticks)

    sim.bravo.conn.on_message = _on_msg
    if not sim.alpha.conn.connect("BRAVO"):
        return {"connected": False, "goodput_bps": 0.0, "delivered": 0.0}
    if not sim.run_until(sim.both_connected, max_ticks=600):
        return {"connected": False, "goodput_bps": 0.0, "delivered": 0.0}
    connect_ticks = sim.ticks

    # Deterministic bulk payload, chunked to the link's frame capacity by
    # send_message itself.
    rng = np.random.default_rng(seed)
    payload = rng.integers(32, 127, payload_bytes, dtype=np.uint8).tobytes()
    cap = max(1, sim.alpha.conn.message_capacity())
    chunks = [payload[i: i + cap] for i in range(0, len(payload), cap)]
    t_start = sim.ticks
    for c in chunks:
        sim.alpha.conn.send_message(c)

    want = len(payload)
    sim.run_until(lambda: sum(len(m) for m in got) >= want, max_ticks=max_ticks)
    delivered = sum(len(m) for m in got)
    t_end = delivered_at[-1] if delivered_at else sim.ticks
    air_s = max(t_end - t_start, 1) * sim.block_ms / 1000.0
    link = sim.alpha.conn.link
    ra = sim.alpha.conn.arq
    return {
        "connected": True,
        "goodput_bps": delivered * 8 / air_s,
        "delivered": delivered / want,
        "air_s": air_s,
        "connect_s": connect_ticks * sim.block_ms / 1000.0,
        "link": f"{link.waveform.name} {link.modulation} {link.rate} "
                f"G{link.burst_group}",
        "retransmits": ra.stats.retransmissions,
    }


ROWS = [
    # (channel, snr, reference kbps, reference delivery rate)
    ("awgn", 25.0, 7.5, 1.00),
    ("good", 20.0, 4.9, 0.96),
    ("moderate", 20.0, 2.7, 0.60),
]


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--channel", default=None)
    p.add_argument("--snr", type=float, default=None)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--seed-base", type=int, default=100)
    p.add_argument("--bytes", type=int, default=4096)
    args = p.parse_args(argv)

    rows = ([(args.channel, args.snr, None, None)]
            if args.channel else ROWS)
    for channel, snr, ref_kbps, ref_rate in rows:
        oks = 0
        bps: list[float] = []
        for s in range(args.seeds):
            r = measure_goodput(channel, snr, args.seed_base + s, args.bytes)
            full = r.get("delivered", 0.0) >= 1.0
            oks += full
            if full:
                bps.append(r["goodput_bps"])
            print(f"  {channel}@{snr:.0f} seed {args.seed_base + s}: "
                  f"{r['goodput_bps']:.0f} bps delivered={r.get('delivered', 0):.0%} "
                  f"link={r.get('link', '?')} connect={r.get('connect_s', 0):.1f}s")
        med = sorted(bps)[len(bps) // 2] if bps else 0.0
        refs = f" (reference {ref_kbps} kbps @ {ref_rate:.0%})" if ref_kbps else ""
        print(f"{channel} @ {snr:.0f} dB: {oks}/{args.seeds} delivered, "
              f"median {med:.0f} bps{refs}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
