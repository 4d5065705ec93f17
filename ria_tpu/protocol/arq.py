"""ARQ controllers: stop-and-wait and selective repeat.

Contract from the reference (src/protocol/arq_interface.hpp:19-56,
arq.cpp, selective_repeat_arq.cpp):
- shared config: ack_timeout 8 s, max_retries 10, turnaround 500 ms;
  selective repeat: window 4, rx reorder buffer 8, sack delay 2 s;
- stop-and-wait (MC-DPSK): one DATA frame in flight, ACK by seq, timeout
  retransmit (chase combining benefits from full retransmissions);
- selective repeat (OFDM): sliding TX window, per-frame ACKs + NACK with
  codeword bitmap, RX reorder buffer with in-order delivery, delayed SACK;
- virtual time via tick(elapsed_ms) — no wall clock, so lock-step simulation
  is deterministic.

Host-side control plane (pure Python).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable

from ria_tpu.phy.frame_v2 import (
    ControlFrame, DataFrame, Flags, FrameType, NackPayload, hash_callsign,
)


class ARQMode(enum.Enum):
    STOP_AND_WAIT = 0
    SELECTIVE_REPEAT = 1


# Control-plane ACK seqs (MODE_CHANGE 0xFDxx / MC_PROFILE 0xFExx — see
# connection.py) must never collide with data seqs: data tx_seq wraps the
# full 16-bit space, so after ~64.8k frames in one connection a data frame
# would otherwise land in the range and its ACKs be dropped by the
# connection-layer control filter (retransmit storm, then hard failure).  Data seq allocation skips the range on BOTH ends (TX
# allocation and RX next-seq advancement use the same rule, so the
# sequence space stays contiguous as seen by the ARQ).
_CTRL_SEQ_LO, _CTRL_SEQ_HI = 0xFD00, 0xFEFF


def _skip_ctrl_range(seq: int) -> int:
    return 0xFF00 if _CTRL_SEQ_LO <= seq <= _CTRL_SEQ_HI else seq


def next_seq(seq: int) -> int:
    """Successor in the data sequence space (16-bit, ctrl range excluded)."""
    return _skip_ctrl_range((seq + 1) & 0xFFFF)


def prev_seq(seq: int) -> int:
    """Predecessor in the data sequence space (inverse of next_seq)."""
    p = (seq - 1) & 0xFFFF
    return 0xFCFF if _CTRL_SEQ_LO <= p <= _CTRL_SEQ_HI else p


@dataclass
class ARQConfig:
    ack_timeout_ms: int = 8000
    turnaround_ms: int = 500
    max_retries: int = 10
    window_size: int = 4
    rx_buffer_size: int = 8
    sack_delay_ms: int = 2000
    # Deliveries since the last SACK that force an immediate flush (a
    # complete burst/window received cleanly); default = window_size.
    flush_window: int = 4


@dataclass
class ARQStats:
    frames_sent: int = 0
    frames_received: int = 0
    acks_sent: int = 0
    acks_received: int = 0
    retransmissions: int = 0
    timeouts: int = 0
    failed: int = 0
    out_of_order: int = 0
    duplicates: int = 0


@dataclass
class _TxSlot:
    seq: int
    frame_bytes: bytes
    retries: int = 0
    timer_ms: int = 0
    acked: bool = False


class _ARQBase:
    def __init__(self, config: ARQConfig | None = None):
        self.config = config or ARQConfig()
        self.stats = ARQStats()
        self.local_call = ""
        self.remote_call = ""
        self.remote_hash = 0
        self.on_transmit: Callable[[bytes], None] | None = None
        self.on_data: Callable[[bytes, int], None] | None = None
        self.on_send_complete: Callable[[bool], None] | None = None
        self.tx_seq = 0
        self.last_rx_flags = 0

    def set_callsigns(self, local: str, remote: str):
        self.local_call = local
        self.remote_call = remote
        self.remote_hash = hash_callsign(remote)

    def _tx(self, frame_bytes: bytes):
        if self.on_transmit:
            self.on_transmit(frame_bytes)

    def _deliver(self, payload: bytes, flags: int):
        self.last_rx_flags = flags
        if self.on_data:
            self.on_data(payload, flags)

    def notify_tx_air_ms(self, frame_bytes: bytes, air_ms: float):
        """The modem reports how long `frame_bytes` occupies the air.

        Half-duplex: no ACK can arrive while our own frame is still being
        transmitted, so the ack timer must start at TX *completion*.  At 4x
        spreading a 4-CW MC-DPSK data frame is ~11 s of audio — longer than
        the whole 8 s ack timeout — so counting from queue time guarantees a
        spurious timeout retransmit per frame.  Subclasses back-date the
        matching slot's timer by the air time (timer goes negative)."""

    def _make_data_frame(self, seq: int, payload: bytes, flags_extra: int) -> bytes:
        f = DataFrame.make_data(self.local_call, self.remote_call, seq, payload)
        f.flags |= flags_extra
        return f.serialize()

    def last_rx_had_more_data(self) -> bool:
        return bool(self.last_rx_flags & Flags.MORE_FRAG)


class StopAndWaitARQ(_ARQBase):
    """Window-1 ARQ used for MC-DPSK (reference src/protocol/arq.cpp)."""

    mode = ARQMode.STOP_AND_WAIT

    def __init__(self, config: ARQConfig | None = None):
        super().__init__(config)
        self.in_flight: _TxSlot | None = None
        self.rx_expected_seq = 0
        self.last_delivered_seq = -1

    # --- TX ---
    def is_ready_to_send(self) -> bool:
        return self.in_flight is None

    def available_slots(self) -> int:
        return 0 if self.in_flight else 1

    def send_data(self, payload: bytes, flags_extra: int = 0) -> bool:
        if self.in_flight is not None:
            return False
        seq = self.tx_seq = _skip_ctrl_range(self.tx_seq)
        self.tx_seq = next_seq(seq)
        frame = self._make_data_frame(seq, payload, flags_extra)
        self.in_flight = _TxSlot(seq=seq, frame_bytes=frame)
        self.stats.frames_sent += 1
        self._tx(frame)
        return True

    def notify_tx_air_ms(self, frame_bytes: bytes, air_ms: float):
        if self.in_flight is not None and self.in_flight.frame_bytes == frame_bytes:
            self.in_flight.timer_ms -= int(air_ms)

    # --- RX ---
    def on_frame_received(self, frame_bytes: bytes):
        ctrl = ControlFrame.deserialize(frame_bytes)
        if ctrl is not None and ctrl.type == FrameType.ACK:
            self.stats.acks_received += 1
            if self.in_flight is not None and ctrl.seq == self.in_flight.seq:
                self.in_flight = None
                if self.on_send_complete:
                    self.on_send_complete(True)
            return
        if ctrl is not None and ctrl.type == FrameType.NACK:
            # Per-CW NACK: retransmit the in-flight frame immediately so the
            # receiver can chase-combine (reference StopAndWaitARQ + chase).
            nack = NackPayload.decode(ctrl.payload)
            if (self.in_flight is not None and nack.frame_seq == self.in_flight.seq
                    and self.in_flight.retries < self.config.max_retries):
                self.in_flight.retries += 1
                self.in_flight.timer_ms = 0
                self.stats.retransmissions += 1
                self._tx(self.in_flight.frame_bytes)
            return
        df = DataFrame.deserialize(frame_bytes)
        if df is None or not (0x30 <= int(df.type) <= 0x33):
            return
        self.stats.frames_received += 1
        # Deliver BEFORE acking: the ACK can synchronously trigger the
        # sender's next frame, which must not overtake this payload.
        if df.seq == self.last_delivered_seq:
            self.stats.duplicates += 1
        else:
            self.last_delivered_seq = df.seq
            self._deliver(df.payload, df.flags)
        # Always ACK (retransmitted frames need re-ACK)
        ack = ControlFrame.make_ack(self.local_call, df.src_hash, df.seq)
        self.stats.acks_sent += 1
        self._tx(ack.serialize())

    # --- timing ---
    def tick(self, elapsed_ms: int):
        slot = self.in_flight
        if slot is None:
            return
        slot.timer_ms += elapsed_ms
        if slot.timer_ms >= self.config.ack_timeout_ms:
            slot.timer_ms = 0
            if slot.retries >= self.config.max_retries:
                self.stats.failed += 1
                self.in_flight = None
                if self.on_send_complete:
                    self.on_send_complete(False)
                return
            slot.retries += 1
            self.stats.retransmissions += 1
            self.stats.timeouts += 1
            self._tx(slot.frame_bytes)

    def reset(self):
        self.in_flight = None
        self.tx_seq = 0
        self.last_delivered_seq = -1


class SelectiveRepeatARQ(_ARQBase):
    """Sliding-window ARQ used for OFDM (selective_repeat_arq.cpp).

    Reference semantics carried over: delayed SACK (ack after sack_delay_ms
    or when the reorder buffer pressures, acknowledging the highest in-order
    seq cumulatively, with a NACK bitmap for holes), adaptive RTT-based ACK
    timeout, and ACK repetition x1-3 under fading.
    """

    mode = ARQMode.SELECTIVE_REPEAT

    def __init__(self, config: ARQConfig | None = None):
        super().__init__(config)
        self.window: dict[int, _TxSlot] = {}
        self.rx_buffer: dict[int, tuple[bytes, int]] = {}
        self.rx_next_seq = 0
        self.delivered: set[int] = set()
        # Delayed-SACK state
        self._sack_timer = -1   # -1 = no pending sack
        self._sack_src_hash = 0
        self._delivered_since_sack = 0
        self.ack_repeat = 1     # 1..3, raised by the engine under fading
        # Adaptive RTT (EMA) -> ack timeout
        self._rtt_ema_ms = float(self.config.ack_timeout_ms) / 2.0
        self._time_ms = 0

    # --- TX ---
    def is_ready_to_send(self) -> bool:
        return len(self.window) < self.config.window_size

    def available_slots(self) -> int:
        return self.config.window_size - len(self.window)

    def send_data(self, payload: bytes, flags_extra: int = 0) -> bool:
        if not self.is_ready_to_send():
            return False
        seq = self.tx_seq = _skip_ctrl_range(self.tx_seq)
        self.tx_seq = next_seq(seq)
        frame = self._make_data_frame(seq, payload, flags_extra)
        slot = _TxSlot(seq=seq, frame_bytes=frame)
        slot.timer_ms = 0
        self.window[seq] = slot
        self.stats.frames_sent += 1
        self._tx(frame)
        return True

    @property
    def _ack_timeout_ms(self) -> int:
        """Adaptive: 2x RTT EMA, clamped to [1/4, 1x] of the configured max."""
        lo = self.config.ack_timeout_ms // 4
        return int(min(max(2.0 * self._rtt_ema_ms, lo), self.config.ack_timeout_ms))

    def notify_tx_air_ms(self, frame_bytes: bytes, air_ms: float):
        for slot in self.window.values():
            if slot.frame_bytes == frame_bytes:
                slot.timer_ms -= int(air_ms)
                break

    def _complete_upto(self, seq: int):
        """Cumulative ACK: complete every window slot at or before `seq` in
        16-bit circular order (forward distance from slot to ack < 2^15).
        Plain `s <= seq` would break at the 0xFFFF->0 wrap AND let any
        foreign high-range seq (control-plane ACKs ride 0xFDxx/0xFExx)
        wipe the whole window.

        Stale/far-future guard (reference handleAckFrame,
        selective_repeat_arq.cpp:216-231): a valid cumulative ACK names a
        seq we actually transmitted at or ahead of the window base — i.e.
        an in-flight seq, or one within window_size steps past the base
        (already-popped slots re-acked by a duplicate SACK resolve to
        in-window or no-op).  Anything else (corrupted seq, foreign
        control-plane seq, ACK from a stale connection) is ignored rather
        than allowed to falsely complete in-flight data slots."""
        if not self.window:
            return
        anchor = next(iter(self.window))
        base = min(self.window,
                   key=lambda s: ((s - anchor) & 0xFFFF) - (
                       0x10000 if ((s - anchor) & 0xFFFF) >= 0x8000 else 0))
        acceptable = set()
        s = base
        for _ in range(len(self.window) + self.config.window_size + 1):
            acceptable.add(s)
            s = next_seq(s)
        if seq not in acceptable:
            return
        for s in [s for s in self.window if ((seq - s) & 0xFFFF) < 0x8000]:
            slot = self.window.pop(s)
            # Skip the RTT sample when the slot's audio hadn't even finished
            # transmitting (timer back-dated below zero by notify_tx_air_ms):
            # a cumulative ACK for an earlier frame says nothing about the
            # round trip of this one.
            if slot.timer_ms > 0:
                self._rtt_ema_ms = 0.875 * self._rtt_ema_ms + 0.125 * slot.timer_ms
            if self.on_send_complete:
                self.on_send_complete(True)

    def _send_sack(self):
        """ACK highest in-order seq (cumulative) + NACK bitmap for holes."""
        self._sack_timer = -1
        self._delivered_since_sack = 0
        highest = prev_seq(self.rx_next_seq)
        ack = ControlFrame.make_ack(self.local_call, self._sack_src_hash, highest)
        self.stats.acks_sent += 1
        self.stats.sacks_sent = getattr(self.stats, "sacks_sent", 0) + 1
        for _ in range(max(1, min(3, self.ack_repeat))):
            self._tx(ack.serialize())
        if self.rx_buffer:
            # Bitmap offsets count in data-sequence steps from rx_next_seq
            # (next_seq walk, so the ctrl-range skip and 16-bit wrap stay
            # consistent with the sender's reconstruction below).
            bitmap, span = 0, 0
            s = self.rx_next_seq
            for off in range(32):
                if s in self.rx_buffer:
                    bitmap |= 1 << off
                    span = off + 1
                s = next_seq(s)
            holes = (~bitmap) & ((1 << span) - 1)
            if holes:
                nack = ControlFrame.make_nack(self.local_call, self._sack_src_hash,
                                              self.rx_next_seq, holes)
                self._tx(nack.serialize())

    # --- RX ---
    def on_frame_received(self, frame_bytes: bytes):
        ctrl = ControlFrame.deserialize(frame_bytes)
        if ctrl is not None and ctrl.type == FrameType.ACK:
            self.stats.acks_received += 1
            self._complete_upto(ctrl.seq)
            return
        if ctrl is not None and ctrl.type == FrameType.NACK:
            nack = NackPayload.decode(ctrl.payload)
            # Bitmap of missing frames relative to base seq; bit 0 = base.
            # Offsets count in data-sequence steps (next_seq), mirroring
            # the receiver's _send_sack construction.
            t = nack.frame_seq
            for off in range(32):
                hit = (off == 0) if nack.cw_bitmap == 0 else bool(
                    (nack.cw_bitmap >> off) & 1)
                if hit:
                    slot = self.window.get(t)
                    if slot is not None and slot.retries < self.config.max_retries:
                        slot.retries += 1
                        slot.timer_ms = 0
                        self.stats.retransmissions += 1
                        self._tx(slot.frame_bytes)
                if nack.cw_bitmap == 0:
                    break
                t = next_seq(t)
            return
        df = DataFrame.deserialize(frame_bytes)
        if df is None or not (0x30 <= int(df.type) <= 0x33):
            return
        self.stats.frames_received += 1
        self._sack_src_hash = df.src_hash
        if df.seq in self.delivered:
            self.stats.duplicates += 1
        else:
            self.rx_buffer[df.seq] = (df.payload, df.flags)
            if df.seq != self.rx_next_seq:
                self.stats.out_of_order += 1
            # In-order delivery from the reorder buffer (before acking, so a
            # synchronously-triggered next frame cannot overtake delivery).
            while self.rx_next_seq in self.rx_buffer:
                payload, flags = self.rx_buffer.pop(self.rx_next_seq)
                self.delivered.add(self.rx_next_seq)
                self._deliver(payload, flags)
                self._delivered_since_sack += 1
                self.rx_next_seq = next_seq(self.rx_next_seq)
            while len(self.rx_buffer) > self.config.rx_buffer_size:
                # Wrap-safe "oldest": smallest forward distance ahead of
                # rx_next_seq (everything buffered is ahead of it).
                oldest = min(self.rx_buffer,
                             key=lambda s: (s - self.rx_next_seq) & 0xFFFF)
                del self.rx_buffer[oldest]
        # Delayed SACK: batch acknowledgements so a burst is covered by one
        # cumulative ACK (+hole NACK).  Out-of-order arrivals flush sooner,
        # and a complete in-order window flushes IMMEDIATELY — a full burst
        # delivered cleanly must not sit out the 2 s aggregation delay
        # (measured: that delay alone cost ~40% of session goodput at
        # 25 dB AWGN with 16-frame bursts).
        if self._sack_timer < 0:
            self._sack_timer = 0
        if self._delivered_since_sack >= self.config.flush_window:
            self._send_sack()
        elif self.rx_buffer and len(self.rx_buffer) >= self.config.window_size - 1:
            self._send_sack()

    # --- timing ---
    def tick(self, elapsed_ms: int):
        self._time_ms += elapsed_ms
        if self._sack_timer >= 0:
            self._sack_timer += elapsed_ms
            if self._sack_timer >= self.config.sack_delay_ms:
                self._send_sack()
        failed = []
        for slot in self.window.values():
            slot.timer_ms += elapsed_ms
            if slot.timer_ms >= self._ack_timeout_ms:
                slot.timer_ms = 0
                if slot.retries >= self.config.max_retries:
                    failed.append(slot.seq)
                    continue
                slot.retries += 1
                self.stats.retransmissions += 1
                self.stats.timeouts += 1
                self._tx(slot.frame_bytes)
        for seq in failed:
            del self.window[seq]
            self.stats.failed += 1
            if self.on_send_complete:
                self.on_send_complete(False)

    def reset(self):
        self.window.clear()
        self.rx_buffer.clear()
        self.delivered.clear()
        self.tx_seq = 0
        self.rx_next_seq = 0


def create_arq(mode: ARQMode, config: ARQConfig | None = None) -> _ARQBase:
    if mode == ARQMode.STOP_AND_WAIT:
        return StopAndWaitARQ(config)
    return SelectiveRepeatARQ(config)
