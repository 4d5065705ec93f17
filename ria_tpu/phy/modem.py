"""MC-DPSK PHY pipeline: frame bytes <-> audio samples.

The array-program equivalent of the reference's StreamingEncoder/StreamingDecoder MC-DPSK
path (src/gui/modem/streaming_encoder.cpp:210-251, streaming_decoder.cpp:2595):

TX: serialized frame -> per-CW LDPC encode (+ optional channel interleave) ->
    chirp/training/reference preamble + mixer-bank modulation.
RX: dual-chirp sync + CFO -> demod CW0 worth of symbols ("CW0 peek",
    streaming_decoder.cpp:1060-1100) -> parse header for total_cw -> demod the
    full frame -> batched LDPC decode -> reassemble + CRC check.

Host Python orchestrates (variable frame sizes, retries); all array math is
jitted with shapes cached per (config, num_symbols).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from ria_tpu.fec import LDPCCodec
from ria_tpu.phy import frame_v2
from ria_tpu.phy.frame_v2 import (
    DataFrame, ControlFrame, ConnectFrame, FrameType,
    decode_codewords, encode_frame_ldpc, is_control_frame, parse_header,
    reassemble_codewords,
)
from ria_tpu.sync.chirp import detect_dual_chirp
from ria_tpu.utils.bits import bytes_to_bits
from ria_tpu.wave.mc_dpsk import MCDPSKConfig, demodulate, modulate, preamble

LDPC_BITS = 648


@dataclass
class RxFrame:
    ok: bool
    frame_bytes: bytes | None
    header: dict | None
    cw_ok: np.ndarray | None
    soft_bits: np.ndarray | None   # raw frame soft bits (for HARQ chase)
    snr_db: float = 0.0
    fading_index: float = 0.0
    cfo_hz: float = 0.0
    start_sample: int = -1
    # Handshake channel probe (MC-DPSK frames only; -1 = not measured).
    delay_spread_ms: float = -1.0
    doppler_spread_hz: float = -1.0


class MCDPSKModem:
    """Host-facing MC-DPSK TX/RX for single frames (simulation/test tier)."""

    def __init__(self, cfg: MCDPSKConfig | None = None, rate: str = "R1_4",
                 channel_interleave: bool = False):
        self.cfg = cfg or MCDPSKConfig()
        self.rate = rate
        self.codec = LDPCCodec(rate)
        self.channel_interleave = channel_interleave

    @property
    def _ci_bits(self) -> int | None:
        return self.cfg.bits_per_mc_symbol if self.channel_interleave else None

    # ------------------------------------------------------------------ TX
    def tx_frame(self, frame_bytes: bytes, tx_cfo_hz: float = 0.0) -> np.ndarray:
        """Serialized frame -> audio samples (preamble + modulated CWs)."""
        is_ctrl = len(frame_bytes) == 20 and (
            0x10 <= frame_bytes[2] <= 0x21 or frame_bytes[2] == 0x40)
        cw_bits = encode_frame_ldpc(
            frame_bytes, self.rate,
            None if is_ctrl else self._ci_bits)
        # Patch total_cw for data frames if the serializer guessed wrong
        if not is_ctrl and len(frame_bytes) >= 17 and frame_bytes[12] != len(cw_bits):
            patched = bytearray(frame_bytes)
            patched[12] = len(cw_bits)
            hcrc = frame_v2.crc16(bytes(patched[:15]))
            patched[15:17] = hcrc.to_bytes(2, "big")
            fcrc = frame_v2.crc16(bytes(patched[:-2]))
            patched[-2:] = fcrc.to_bytes(2, "big")
            frame_bytes = bytes(patched)
            cw_bits = encode_frame_ldpc(frame_bytes, self.rate,
                                        None if is_ctrl else self._ci_bits)
        bits = cw_bits.reshape(-1)
        return np.concatenate([preamble(self.cfg, tx_cfo_hz), modulate(bits, self.cfg)])

    def frame_duration_samples(self, frame_bytes_len: int) -> int:
        ncw = len(frame_v2.split_into_codewords(b"\x00" * frame_bytes_len, self.rate))
        return self.cfg.frame_samples(ncw * LDPC_BITS)

    # ------------------------------------------------------------------ RX
    def _demod_bits(self, audio: np.ndarray, start: int, cfo: float, num_bits: int) -> tuple[np.ndarray, object]:
        n_sym = self.cfg.num_data_symbols(num_bits)
        need = (self.cfg.training_symbols + 1 + n_sym * self.cfg.spreading) * self.cfg.samples_per_symbol
        frame = np.zeros(need, np.float32)
        avail = audio[start : start + need]
        frame[: len(avail)] = avail
        res = demodulate(jnp.asarray(frame), jnp.float32(cfo), self.cfg, n_sym)
        return np.asarray(res.soft_bits)[:num_bits], res

    def rx_frame(self, audio: np.ndarray) -> RxFrame:
        """Search audio for one frame: sync, CW0 peek, full decode."""
        sync = detect_dual_chirp(jnp.asarray(np.asarray(audio, np.float32)), self.cfg.chirp)
        if not bool(sync.detected):
            return RxFrame(False, None, None, None, None)
        start = int(sync.start) + self.cfg.chirp.total_samples
        cfo = float(sync.cfo_hz)

        # CW0 peek: control frames never use channel interleave.
        soft0, _ = self._demod_bits(audio, start, cfo, LDPC_BITS)
        ok0, chunk0 = decode_codewords(soft0[None, :], self.rate, None)
        header = parse_header(chunk0[0]) if ok0[0] else None
        if header is None and self._ci_bits:
            ok0i, chunk0i = decode_codewords(soft0[None, :], self.rate, self._ci_bits)
            h = parse_header(chunk0i[0]) if ok0i[0] else None
            if h is not None:
                ok0, chunk0, header = ok0i, chunk0i, h
        if header is None:
            return RxFrame(False, None, None, np.asarray(ok0), soft0,
                           cfo_hz=cfo, start_sample=int(sync.start))

        total_cw = max(1, int(header["total_cw"]))
        if header["is_control"]:
            total_cw = 1

        num_bits = total_cw * LDPC_BITS
        soft, res = self._demod_bits(audio, start, cfo, num_bits)
        ci = None if header["is_control"] else self._ci_bits
        oks, chunks = decode_codewords(soft.reshape(total_cw, LDPC_BITS), self.rate, ci)
        frame_bytes = reassemble_codewords(list(chunks), self.rate) if oks.all() else None

        ok = bool(oks.all())
        if ok and frame_bytes is not None and not header["is_control"]:
            # Validate frame CRC via deserialization
            ok = DataFrame.deserialize(frame_bytes) is not None
        return RxFrame(ok, frame_bytes, header, oks, soft,
                       snr_db=float(res.snr_estimate_db),
                       fading_index=float(res.freq_fading_index + res.temporal_fading_index),
                       cfo_hz=cfo, start_sample=int(sync.start))
