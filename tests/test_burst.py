"""Stream-packed burst protocol path (reference encodeBurstLight /
BURST_ACCUMULATING, streaming_encoder.cpp:302, streaming_decoder.cpp:3065).

One light preamble (3-LTS burst marker) carries a group of frames packed
into one codeword stream (frame 0 full + compressed continuation records,
frame_v2 burst section) striped across all codewords, so a deep fade
costs every codeword only fade/ncw of its bits — the reference's
burst-interleave protection with strictly less air time.
"""

from __future__ import annotations

import numpy as np

from ria_tpu.phy.frame_v2 import (WaveformMode, burst_stream_codewords,
                                  make_fixed_data_frame)
from ria_tpu.protocol.connection import (ConnectionConfig, ConnectionState,
                                         burst_group_for_snr)
from ria_tpu.sim.simulator import DualStationSim
from ria_tpu.sim.channel import awgn
from ria_tpu.wave.api import OFDMChirpWaveform


def _frames(rate="R1_2", n=4):
    return [make_fixed_data_frame("W1AW", "VE3ABC", i, bytes([i]) * 20, rate,
                                  flags_extra=0x20).serialize()
            for i in range(n)]


def test_burst_waveform_roundtrip_and_marker():
    """tx_burst produces a 3-LTS (burst-marked) stream; rx_burst recovers
    every logical frame; a normal frame still reads as 2 repeats."""
    wf = OFDMChirpWaveform(modulation="DQPSK", rate="R1_2")
    frames = _frames()
    rng = np.random.default_rng(0)
    tx = wf.tx_burst(frames)
    audio = np.concatenate([np.zeros(4000, np.float32), tx,
                            np.zeros(4000, np.float32)])
    rms = float(np.sqrt(np.mean(tx**2)))
    audio += rng.normal(0, rms * 10 ** (-18 / 20), audio.shape).astype(np.float32)

    sync = wf.detect_sync(audio, light=True)
    assert sync is not None and sync["lts_repeats"] == 3
    out, snr, _fading = wf.rx_burst(audio, 4, sync=sync)
    assert all(ok for ok, _ in out)
    assert [fb for _, fb in out] == frames

    single = wf.tx_frame(frames[0], light=True)
    a2 = np.concatenate([np.zeros(4000, np.float32), single,
                         np.zeros(4000, np.float32)])
    a2 += rng.normal(0, rms * 10 ** (-18 / 20), a2.shape).astype(np.float32)
    s2 = wf.detect_sync(a2, light=True)
    assert s2 is not None and s2["lts_repeats"] == 2


def test_burst_stream_packs_less_air_than_per_frame():
    """The packed stream must beat the reference's per-frame layout (4 CW
    per frame) on air time — that is the throughput win being claimed."""
    for rate, group in (("R1_4", 8), ("R1_2", 8), ("R2_3", 16), ("R3_4", 16)):
        assert burst_stream_codewords(group, rate) < 4 * group


def test_burst_survives_quarter_body_fade():
    """Deep fade wiping a quarter of the burst body: the stripe interleave
    spreads the loss so every codeword sees only ~25% erasures and every
    LOGICAL frame still decodes.  The same fade on per-frame TX destroys
    the hit frame outright — the burst's raison d'etre (reference
    burst_interleaver.hpp:10-31)."""
    wf = OFDMChirpWaveform(modulation="DQPSK", rate="R1_2")
    frames = _frames()
    rng = np.random.default_rng(1)
    tx = wf.tx_burst(frames)
    lead = 4000
    audio = np.concatenate([np.zeros(lead, np.float32), tx,
                            np.zeros(4000, np.float32)])
    rms = float(np.sqrt(np.mean(tx**2)))
    ncw = wf.burst_codewords(4)
    body_syms = wf.cfg.num_symbols_for_bits(ncw * 648)
    sym = wf.cfg.symbol_samples
    wipe_syms = body_syms // 4
    f_start = lead + (3 + 2 * wipe_syms) * sym  # mid-burst span
    audio[f_start : f_start + wipe_syms * sym] = 0.0
    audio += rng.normal(0, rms * 10 ** (-18 / 20), audio.shape).astype(np.float32)

    out, _, _ = wf.rx_burst(audio, 4)
    assert all(ok for ok, _ in out), [ok for ok, _ in out]
    assert [fb for _, fb in out] == frames

    # Control: the same-length wipe centred on one per-frame TX destroys
    # that frame outright (nothing left to decode).
    singles = [wf.tx_frame(fb, light=True) for fb in frames]
    a2 = np.concatenate([np.zeros(lead, np.float32)] + singles
                        + [np.zeros(4000, np.float32)])
    pos = lead + sum(len(s) for s in singles[:2])
    a2[pos : pos + len(singles[2])] = 0.0
    a2 += rng.normal(0, rms * 10 ** (-18 / 20), a2.shape).astype(np.float32)
    hit = wf.rx_frame(a2[pos : pos + len(singles[2]) + 2000], light=True)
    assert not hit.ok  # the faded single frame is unrecoverable


def test_burst_group_snr_ladder():
    assert burst_group_for_snr(5.0) == 4
    assert burst_group_for_snr(12.0) == 8
    assert burst_group_for_snr(20.0) == 16


def test_burst_session_negotiated_and_delivers():
    """End-to-end: both stations enable burst, CONNECT negotiates it
    (capability bit + ACK feature bit + SNR-derived group), an 8-chunk
    message rides one burst, and delivery is complete."""
    cfg_a = ConnectionConfig(burst_group=8)
    cfg_b = ConnectionConfig(burst_group=8)
    sim = DualStationSim(channel_cfg=awgn(14.0), seed=5, config_a=cfg_a,
                         config_b=cfg_b)
    got = []
    sim.bravo.conn.on_message = got.append
    assert sim.alpha.conn.connect("BRAVO")
    assert sim.run_until(sim.both_connected, max_ticks=300)
    assert sim.alpha.conn.link.waveform == WaveformMode.OFDM_CHIRP
    assert sim.alpha.conn.link.burst_group == 8
    assert sim.bravo.conn.link.burst_group == 8
    assert sim.alpha.conn.link.burst_tx_confirmed  # initiator: from ACK bit0

    cap = sim.alpha.conn.message_capacity()
    group = sim.alpha.conn.link.burst_group
    msg = bytes(range(256)) * ((group * cap) // 256 + 1)
    msg = msg[: group * cap - 10]  # fragments into exactly `group` chunks
    assert sim.alpha.conn.send_message(msg)
    assert sim.run_until(lambda: got, max_ticks=300)
    assert got[0] == msg
    assert sim.alpha.stats.bursts_tx >= 1
    assert sim.bravo.stats.bursts_rx >= 1
    # responder latch: flips only after a burst is actually received
    assert sim.bravo.conn.link.burst_tx_confirmed


def test_burst_disabled_when_peer_lacks_support():
    """Asymmetric config: initiator wants bursts, responder does not —
    negotiation must land on burst_group=0 on BOTH ends and traffic flows
    as normal single frames."""
    cfg_a = ConnectionConfig(burst_group=4)
    cfg_b = ConnectionConfig(burst_group=0)  # burst explicitly off
    # (default is ON since round 4 — see ConnectionConfig.burst_group)
    sim = DualStationSim(channel_cfg=awgn(18.0), seed=6, config_a=cfg_a,
                         config_b=cfg_b)
    got = []
    sim.bravo.conn.on_message = got.append
    assert sim.alpha.conn.connect("BRAVO")
    assert sim.run_until(sim.both_connected, max_ticks=300)
    assert sim.alpha.conn.link.burst_group == 0
    assert sim.bravo.conn.link.burst_group == 0
    assert sim.alpha.conn.send_message(b"plain frame path")
    assert sim.run_until(lambda: got, max_ticks=200)
    assert got[0] == b"plain frame path"
    assert sim.alpha.stats.bursts_tx == 0


def test_burst_record_isolation_from_frame0_cw_fades():
    """Per-frame isolation in the packed burst stream: a faded codeword in
    frame 0's span must not take the continuation records with it (shared
    header bytes live entirely in the first 17 bytes), and a fade in the
    frame-0 PADDING region (beyond the serialized frame's true length —
    frames are unpadded since the round-4 wire alignment) costs nothing."""
    import numpy as np

    from ria_tpu.phy.frame_v2 import (burst_record_size, burst_stream_codewords,
                                      bytes_per_codeword, build_burst_stream,
                                      parse_burst_stream)

    rate, G = "R1_2", 8
    bpc = bytes_per_codeword(rate)
    frames = [f.serialize() for f in
              [__import__("ria_tpu.phy.frame_v2", fromlist=["make_fixed_data_frame"])
               .make_fixed_data_frame("W1AW", "VE3ABC", i, bytes([i]) * 30, rate)
               for i in range(G)]]
    assert len(frames[0]) == 49  # 17 hdr + 30 payload + 2 CRC, unpadded
    stream = build_burst_stream(frames, rate)
    ncw = burst_stream_codewords(G, rate)
    stream = stream.ljust(ncw * bpc, b"\x00")

    # Case 1: fade in frame 0's PADDING (CW2 = bytes 80..119 at R1/2, past
    # the 49 real bytes): every frame still delivers, including frame 0.
    oks = np.ones(ncw, bool)
    oks[2] = False
    res = parse_burst_stream(stream, oks, G, rate)
    assert all(ok for ok, _ in res)
    assert [fb for _, fb in res] == frames

    # Case 2: fade in frame 0's REAL bytes past the header (CW1 = bytes
    # 40..79): frame 0 fails, every continuation record still delivers.
    oks = np.ones(ncw, bool)
    oks[1] = False
    res = parse_burst_stream(stream, oks, G, rate)
    assert not res[0][0]
    assert all(ok for ok, _ in res[1:])
    assert [fb for _, fb in res[1:]] == frames[1:]


def test_qam64_r34_rung_decodes_at_24db_awgn():
    """Backs the selection table's QAM64 R3/4 rung at 24 dB measured
    (wave/selection.py): 16-frame bursts decode 10/10 seeds at a true
    24 dB AWGN."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ria_tpu.phy.frame_v2 import WaveformMode, make_fixed_data_frame
    from ria_tpu.sim import apply_channel, awgn
    from ria_tpu.wave.api import create_waveform

    for s in range(10):
        wf = create_waveform(WaveformMode.OFDM_CHIRP, "QAM64", "R3_4")
        frames = [make_fixed_data_frame("W1AW", "VE3ABC", i, bytes(200),
                                        "R3_4").serialize() for i in range(16)]
        tx = wf.tx_burst(frames)
        audio = np.concatenate([np.zeros(3000, np.float32), tx,
                                np.zeros(4000, np.float32)])
        out = np.asarray(apply_channel(jnp.asarray(audio),
                                       jax.random.PRNGKey(200 + s),
                                       awgn(24.0)).samples)
        res = wf.rx_burst(out, 16)
        assert res is not None, f"seed {s}: no sync"
        frames_rx, _snr, _fad = res
        assert all(okf for okf, _ in frames_rx), f"seed {s}"


def test_single_frame_never_misroutes_to_burst_rx():
    """In a burst-negotiated session, a single light
    frame whose preamble over-counts LTS repeats (e.g. a reference peer's
    standard light preamble measured repeats=3) must still deliver as a
    single frame.  The repeat count is a hint; the CRC-gated single-frame
    decode runs first.  Uses the checked-in reference `ria ptx` fixture."""
    import os

    import numpy as np

    from ria_tpu.phy.frame_v2 import WaveformMode
    from ria_tpu.phy.station import Station
    from ria_tpu.protocol.connection import ConnectionState, LinkMode

    fix = os.path.join(os.path.dirname(__file__), "golden", "interop",
                       "ref_ofdm_dqpsk_r1_4.f32")
    audio = np.fromfile(fix, np.float32)

    st = Station("BRAVO")
    st.conn.state = ConnectionState.CONNECTED
    st.conn.remote_call = "ALPHA"
    link = LinkMode(waveform=WaveformMode.OFDM_CHIRP, modulation="DQPSK",
                    rate="R1_4", burst_group=8)
    st.conn.link = link
    st._on_mode_changed(link)
    delivered = []
    st.on_rx_frame = lambda rx: delivered.append(rx.frame_bytes)

    st.feed_audio(audio)
    st.poll()
    # Force the hint to "burst" regardless of what the detector measured:
    # re-run with a synthetic repeats=3 sync if the frame wasn't consumed.
    if not delivered and st._pending is not None:
        st._pending["sync"]["lts_repeats"] = 3
        st.poll()
    for _ in range(4):
        if delivered:
            break
        st.feed_audio(np.zeros(48000, np.float32))
        st.poll()
    assert st.stats.frames_rx == 1, (st.stats.frames_rx, st.stats.decode_failures)
    assert st.stats.bursts_rx == 0
    assert delivered and b"HELLO INTEROP" in delivered[0]
