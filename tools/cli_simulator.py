"""Full-protocol dual-station simulator CLI (reference tools/cli_simulator.cpp).

Two complete modem stacks joined by seeded Watterson channels run a full
PING -> CONNECT -> [MODE_CHANGE] -> DATA xN -> [FILE] -> DISCONNECT session
and assert delivery.  The reference's acceptance criterion is
"N/N seeds pass" — use --seeds for a sweep.

Usage examples:
  python tools/cli_simulator.py --snr 12 --channel awgn
  python tools/cli_simulator.py --snr 20 --channel good --seeds 5
  python tools/cli_simulator.py --snr 22 --waveform OFDM_CHIRP --mod DQPSK --rate R1_2
  python tools/cli_simulator.py --snr 15 --file --save-signals /tmp/cap
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import sys
import time


def run_session(args, seed: int) -> dict:
    from ria_tpu.phy.frame_v2 import WaveformMode
    from ria_tpu.protocol.connection import ConnectionConfig, ConnectionState
    from ria_tpu.sim import PRESETS
    from ria_tpu.sim.simulator import DualStationSim

    channel = PRESETS[args.channel](args.snr)
    # getattr defaults: run_session is also driven by other tools (e.g.
    # adaptive_session_sweep) that build a minimal args namespace.
    if getattr(args, "cfo", 0.0):
        from dataclasses import replace

        channel = replace(channel, cfo_hz=args.cfo, cfo_enabled=True)
    cfg_a = ConnectionConfig()
    cfg_b = ConnectionConfig()
    if args.waveform != "AUTO":
        cfg_a.preferred_mode = WaveformMode[args.waveform]
    if args.mod != "AUTO":
        cfg_a.forced_modulation = args.mod
    if args.rate != "AUTO":
        cfg_a.forced_rate = args.rate
    if getattr(args, "burst", False):
        # Burst-interleave groups of 4 on OFDM_CHIRP links (negotiated at
        # CONNECT via capability/feature bits).
        cfg_a.burst_group = 4
        cfg_b.burst_group = 4

    sim = DualStationSim(channel, seed=seed, config_a=cfg_a, config_b=cfg_b,
                         save_signals=args.save_signals,
                         mc_carriers=getattr(args, "carriers", 10),
                         chase_enabled=not getattr(args, "no_chase", False),
                         use_css=getattr(args, "css", False),
                         feed_chunk_ms=getattr(args, "feed_chunk_ms", None),
                         decode_delay_blocks=getattr(args, "decode_delay_blocks", 1))
    result = {"seed": seed, "connected": False, "messages": 0, "file_ok": False,
              "disconnected": False, "retransmissions": 0}
    got_b, got_a = [], []
    sim.bravo.conn.on_message = lambda d: got_b.append(d)
    sim.alpha.conn.on_message = lambda d: got_a.append(d)

    t0 = time.time()
    assert sim.alpha.conn.connect("BRAVO")
    # Connect budget: low-SNR fading handshakes legitimately take several
    # retry rounds (spread-4 escalation after 2, MFSK after 5) — ~350 ticks
    # (70 s virtual) at the -8 dB good-fading floor.
    if not sim.run_until(sim.both_connected, max_ticks=450):
        print(f"  seed {seed}: CONNECT FAILED "
              f"(A={sim.alpha.conn.state.name} B={sim.bravo.conn.state.name})")
        sim.close()
        return result
    result["connected"] = True
    link = sim.alpha.conn.link
    result["link"] = (f"{link.waveform.name} {link.modulation} {link.rate}"
                      + (f" x{link.spreading}" if link.spreading > 1 else ""))
    result["connect_s"] = sim.ticks * sim.block_ms / 1000.0
    print(f"  seed {seed}: connected in {sim.ticks * sim.block_ms / 1000:.1f}s virtual "
          f"-> {link.waveform.name} {link.modulation} {link.rate}"
          + (f" spread{link.spreading}x" if link.spreading > 1 else ""))

    for i in range(args.num_messages):
        msg = f"test message {i} through the ionosphere".encode()
        sim.alpha.conn.send_message(msg)
        if sim.run_until(lambda: len(got_b) > i, max_ticks=sim.ticks + 200):
            result["messages"] += 1
        else:
            break

    if getattr(args, "bulk", 0):
        # Bulk throughput: one large message, measured in VIRTUAL link time
        # from send to delivery (payload bits / air seconds).
        data = (bytes(range(256)) * (args.bulk // 256 + 1))[: args.bulk]
        t_start = sim.ticks
        sim.alpha.conn.send_message(data)
        if sim.run_until(lambda: got_b and got_b[-1] == data,
                         max_ticks=sim.ticks + 3000):
            secs = (sim.ticks - t_start) * sim.block_ms / 1000.0
            result["bulk_bps"] = len(data) * 8 / max(secs, 1e-9)
            result["bursts_tx"] = sim.alpha.stats.bursts_tx
            print(f"  seed {seed}: bulk {args.bulk} B in {secs:.1f}s virtual = "
                  f"{result['bulk_bps']:.0f} bps"
                  f" (bursts_tx={sim.alpha.stats.bursts_tx},"
                  f" bursts_rx={sim.bravo.stats.bursts_rx})")
        else:
            result["bulk_bps"] = 0.0
            print(f"  seed {seed}: bulk transfer FAILED")

    if args.file:
        from ria_tpu.protocol.engine import ProtocolEngine  # noqa: F401 (doc)
        # File transfer rides DATA frames through the stations' connections.
        payload = bytes(range(256)) * 4
        from ria_tpu.protocol.file_transfer import FileTransferController

        ftc_tx = FileTransferController(chunk_payload=sim.alpha.conn.message_capacity())
        ftc_rx = FileTransferController()
        done = []
        ftc_rx.on_received = lambda name, data, ok: done.append((name, data, ok))
        orig = sim.bravo.conn.on_message
        sim.bravo.conn.on_message = lambda d: (ftc_rx.process_payload(d)
                                               or (orig and orig(d)))
        ftc_tx.start_send("sim.bin", payload)
        while ftc_tx.has_more_chunks():
            # Wait for an open ARQ slot BEFORE pulling the next chunk — a
            # send while busy would silently drop it.
            if not sim.run_until(lambda: sim.alpha.conn.arq.is_ready_to_send(),
                                 max_ticks=sim.ticks + 200):
                break
            chunk = ftc_tx.next_chunk()
            if chunk is None:
                break
            sim.alpha.conn.send_message(chunk)
        sim.run_until(lambda: bool(done), max_ticks=sim.ticks + 100)
        result["file_ok"] = bool(done and done[0][2] and done[0][1] == payload)

    sim.alpha.conn.disconnect()
    # Budget scales with spreading: control frames are spreading x longer on
    # the air, and the DISCONNECT retransmit ladder (3 x 5 s) must fit.
    disc_budget = 100 * max(1, sim.alpha.conn.link.spreading)
    sim.run_until(lambda: sim.bravo.conn.state == ConnectionState.DISCONNECTED,
                  max_ticks=sim.ticks + disc_budget)
    result["disconnected"] = sim.bravo.conn.state == ConnectionState.DISCONNECTED
    result["retransmissions"] = sim.alpha.conn.arq.stats.retransmissions
    result["chase"] = sim.bravo.chase.stats.recoveries if sim.bravo.chase else 0
    final = sim.alpha.conn.link
    result["final_link"] = (f"{final.waveform.name} {final.modulation} {final.rate}"
                            + (f" x{final.spreading}" if final.spreading > 1 else ""))
    if result["final_link"] != result.get("link"):
        print(f"  seed {seed}: link adapted -> {result['final_link']}")
    print(f"  seed {seed}: {result['messages']}/{args.num_messages} msgs, "
          f"retx={result['retransmissions']}, chase_recoveries={result['chase']}, "
          f"disconnect={'clean' if result['disconnected'] else 'DIRTY'}, "
          f"{time.time() - t0:.1f}s wall")
    sim.close()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--snr", type=float, default=12.0)
    ap.add_argument("--channel", choices=["awgn", "good", "moderate", "poor", "flutter"],
                    default="awgn")
    ap.add_argument("--waveform", default="AUTO")
    ap.add_argument("--mod", default="AUTO")
    ap.add_argument("--rate", default="AUTO")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--seed-base", type=int, default=42)
    ap.add_argument("--num-messages", type=int, default=2)
    ap.add_argument("--file", action="store_true")
    ap.add_argument("--save-signals", default=None)
    ap.add_argument("--cfo", type=float, default=0.0,
                    help="inject a fixed carrier frequency offset (Hz)")
    ap.add_argument("--carriers", type=int, default=10,
                    help="MC-DPSK carrier count on both stations (3-20)")
    ap.add_argument("--burst", action="store_true",
                    help="negotiate burst-interleave groups of 4 (OFDM links)")
    ap.add_argument("--bulk", type=int, default=0,
                    help="send one N-byte bulk message and report virtual-time bps")
    ap.add_argument("--css", action="store_true",
                    help="CSS acquisition preambles: frame type in the "
                         "chirp's cyclic shift (reference --css)")
    ap.add_argument("--no-chase", action="store_true",
                    help="disable HARQ chase combining")
    ap.add_argument("--feed-chunk-ms", type=float, default=None,
                    help="stress: feed RX audio in chunks of this many ms "
                         "(reference --rx-batch-callbacks analogue)")
    ap.add_argument("--decode-delay-blocks", type=int, default=1,
                    help="stress: decode only every Nth audio block "
                         "(reference --decode-delay-ms analogue)")
    args = ap.parse_args(argv)

    print(f"cli_simulator: {args.channel} @ {args.snr} dB, "
          f"waveform={args.waveform}, {args.seeds} seed(s)")
    passed = 0
    for s in range(args.seeds):
        r = run_session(args, args.seed_base + s)
        ok = (r["connected"] and r["messages"] == args.num_messages
              and r["disconnected"] and (not args.file or r["file_ok"]))
        passed += ok
    print(f"RESULT: {passed}/{args.seeds} seeds passed")
    return 0 if passed == args.seeds else 1


if __name__ == "__main__":
    sys.exit(main())
