"""Two headless modem instances cross-wired through simulated air, driven
over their TCP host interfaces (reference tools/start_dual_modems.sh +
test_dual_modem_tcp.sh, which cross-wire two GUI instances through virtual
audio cables and drive ports 8300/8310).

Each instance is a full stack: Station (modem) + ProtocolEngine +
HostInterface (command/data/KISS TCP servers).  The "air" is the seeded
Watterson channel of DualStationSim.

Usage:
  python tools/dual_modem_tcp.py --self-test          # scripted TCP session
  python tools/dual_modem_tcp.py --snr 15 --channel good --self-test
  python tools/dual_modem_tcp.py                      # serve until ^C
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import socket
import time


class DualModemTcp:
    """Two full modem stacks + host interfaces joined by simulated air."""

    def __init__(self, channel, seed: int = 42, base_port_a: int = 8300,
                 base_port_b: int = 8310):
        from ria_tpu.protocol.engine import ProtocolEngine
        from ria_tpu.runtime.host_interface import HostInterface
        from ria_tpu.sim.simulator import DualStationSim

        self.sim = DualStationSim(channel, seed=seed)
        self.engines = []
        self.ifaces = []
        for st, base in ((self.sim.alpha, base_port_a), (self.sim.bravo, base_port_b)):
            eng = ProtocolEngine(conn=st.conn)
            # base 0 = ephemeral ports for all three servers.
            hi = HostInterface(eng, station=st, command_port=base,
                               data_port=base + 1 if base else 0,
                               kiss_port=base + 2 if base else 0)
            self.engines.append(eng)
            self.ifaces.append(hi)

    def tick(self):
        """One lock-step air block + TCP poll on both sides."""
        for hi in self.ifaces:
            hi.poll(0.0)
        self.sim.step()

    def ports(self):
        return [(hi.cmd_srv.port, hi.data_srv.port) for hi in self.ifaces]

    def close(self):
        for hi in self.ifaces:
            hi.close()
        self.sim.close()


def _cmd(dm: DualModemTcp, sock, line: str, timeout_ticks: int = 20) -> str:
    sock.sendall((line + "\r").encode())
    buf = b""
    sock.settimeout(0.01)
    for _ in range(timeout_ticks):
        dm.tick()
        try:
            buf += sock.recv(4096)
        except (TimeoutError, socket.timeout):
            pass
        if b"\r\n" in buf:
            break
    lines = [l for l in buf.decode().split("\r\n") if l]
    return lines[-1] if lines else ""


def self_test(dm: DualModemTcp) -> int:
    """Scripted session over TCP: MYCALL, CONNECT, data, DISCONNECT."""
    (cmd_a, dat_a), (cmd_b, dat_b) = dm.ports()
    sa = socket.create_connection(("127.0.0.1", cmd_a), timeout=2)
    sb = socket.create_connection(("127.0.0.1", cmd_b), timeout=2)
    da = socket.create_connection(("127.0.0.1", dat_a), timeout=2)
    db = socket.create_connection(("127.0.0.1", dat_b), timeout=2)

    print("MYCALL:", _cmd(dm, sa, "MYCALL ALPHA"), _cmd(dm, sb, "MYCALL BRAVO"))
    print("CONNECT:", _cmd(dm, sa, "CONNECT BRAVO"))
    from ria_tpu.protocol.connection import ConnectionState

    for _ in range(300):
        dm.tick()
        if (dm.engines[0].state == ConnectionState.CONNECTED and
                dm.engines[1].state == ConnectionState.CONNECTED):
            break
    else:
        print("FAIL: connect timed out")
        return 1
    link = dm.engines[0].conn.link
    print(f"connected: {link.waveform.name} {link.modulation} {link.rate}")

    payload = b"dual modem tcp self test payload"
    da.sendall(payload)
    got = b""
    db.settimeout(0.01)
    for _ in range(400):
        dm.tick()
        try:
            got += db.recv(4096)
        except (TimeoutError, socket.timeout):
            pass
        if payload in got:
            break
    ok_ab = payload in got
    print(f"data A->B: {'OK' if ok_ab else 'FAIL'} ({len(got)} bytes)")

    print("DISCONNECT:", _cmd(dm, sa, "DISCONNECT", timeout_ticks=60))
    for s in (sa, sb, da, db):
        s.close()
    return 0 if ok_ab else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--snr", type=float, default=15.0)
    ap.add_argument("--channel", choices=["awgn", "good", "moderate", "poor"],
                    default="awgn")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--port-a", type=int, default=0)
    ap.add_argument("--port-b", type=int, default=0)
    ap.add_argument("--self-test", action="store_true")
    args = ap.parse_args(argv)

    from ria_tpu.sim import PRESETS

    dm = DualModemTcp(PRESETS[args.channel](args.snr), seed=args.seed,
                      base_port_a=args.port_a, base_port_b=args.port_b)
    (ca, da_), (cb, db_) = dm.ports()
    print(f"alpha: cmd {ca} data {da_} | bravo: cmd {cb} data {db_}")
    try:
        if args.self_test:
            return self_test(dm)
        while True:
            dm.tick()
            time.sleep(0.001)
    except KeyboardInterrupt:
        return 0
    finally:
        dm.close()


if __name__ == "__main__":
    import sys

    sys.exit(main())
