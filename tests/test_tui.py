"""Operator dashboard (runtime/tui.py): headless-driven render + controls.

The reference GUI app (src/gui/app.cpp) surface — waterfall, constellation,
status, message console, connect controls, embedded sim mode — rendered as
text frames, drivable without a terminal.
"""

from __future__ import annotations

import numpy as np


def test_tui_sim_session_frame():
    from ria_tpu.runtime.tui import TuiApp
    from ria_tpu.sim import awgn

    app = TuiApp(mycall="W1AW", sim_channel=awgn(18.0), seed=7)
    app.handle_key("c")  # connect
    for _ in range(80):
        app.step()
        if app.station.conn.state.name == "CONNECTED":
            break
    assert app.station.conn.state.name == "CONNECTED"
    for ch in ":hello tui\n":   # ':' enters compose mode
        app.handle_key(ch)
    for _ in range(60):
        app.step()
    frame = "\n".join(app.build_frame())
    assert "CONNECTED" in frame
    assert "OFDM" in frame or "MC_DPSK" in frame
    assert "[tx] hello tui" in frame
    assert "[peer] hello tui" in frame       # virtual peer received it
    assert "snr" in frame and "dB" in frame
    # live SNR fed from decoded frames, not the 0.0 default
    assert app.monitor.status().snr_db > 5.0
    # constellation fed from equalized symbols
    assert len(app.monitor.constellation.snapshot()) > 0
    # quit key stops the loop
    app.handle_key("q")
    assert not app.state.running


def test_tui_renderers_standalone():
    from ria_tpu.runtime.tui import render_constellation, render_waterfall

    rows = render_waterfall(np.random.default_rng(0).normal(0, 1, (40, 80)),
                            width=32, height=6)
    assert len(rows) == 6 and all(len(r) == 32 for r in rows)
    syms = (np.array([1 + 1j, -1 - 1j, 1 - 1j, -1 + 1j]) * 0.7)
    crows = render_constellation(syms, width=21, height=11)
    assert sum(r.count("o") for r in crows) >= 3
    assert any("+" in r for r in crows)      # axes


def test_cli_gui_headless(capsys):
    from ria_tpu.cli import main

    rc = main(["gui", "--sim", "--snr", "15", "--frames", "3", "-s", "W1AW"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "operator console" in out


def test_attached_console_over_host_interface():
    """`ria gui --attach`: dashboard driving a RUNNING modem through the
    TCP host interface — STATUS polling, command keys, data-port TX."""
    from ria_tpu.protocol.engine import ProtocolEngine
    from ria_tpu.runtime.host_interface import HostInterface
    from ria_tpu.runtime.tui import AttachedConsole

    engine = ProtocolEngine()
    hi = HostInterface(engine, command_port=0, data_port=0, kiss_port=0,
                       backend="python")
    try:
        con = AttachedConsole(command_port=hi.cmd_srv.port,
                              data_port=hi.data_srv.port)
        for _ in range(20):
            hi.poll(0.02)
            con.step()
            if con.status:
                break
        assert con.status.get("state") == "DISCONNECTED"
        frame = "\n".join(con.build_frame())
        assert "attached console" in frame and "DISCONNECTED" in frame
        # keyed disconnect command reaches the engine (OK reply swallowed)
        con.handle_key("s")
        hi.poll(0.05)
        con.step()
        con.close()
    finally:
        hi.close()


def test_tui_compose_mode_protects_command_letters():
    """A message starting with c/d/b/q must be composable —
    bare letters are commands only OUTSIDE compose mode."""
    from ria_tpu.runtime.tui import TuiApp
    from ria_tpu.sim import awgn

    app = TuiApp(mycall="W1AW", sim_channel=awgn(18.0), seed=8)
    sent = []
    app.engine.send_message = lambda d: sent.append(bytes(d)) or True
    for ch in ":bye for now\n":
        app.handle_key(ch)
    assert sent == [b"bye for now"]
    assert app.state.running  # the 'b' did not fire the beacon/quit path
    # Esc cancels composing without sending
    app.handle_key(":")
    for ch in "draft":
        app.handle_key(ch)
    app.handle_key("\x1b")
    assert not app.state.composing and app.state.input_line == ""
    assert sent == [b"bye for now"]


def test_tui_settings_editor_persists_ini(tmp_path):
    """The reference settings widget, TUI-style: 's' shows the pane,
    `/set` edits a field live AND persists it to the INI
    (docs/CONFIGURATION_SYSTEM.md:20-32)."""
    from ria_tpu.config import AppSettings
    from ria_tpu.runtime.tui import TuiApp
    from ria_tpu.sim import awgn

    ini = tmp_path / "ria.ini"
    app = TuiApp(mycall="W1AW", sim_channel=awgn(18.0), seed=9,
                 settings_path=str(ini))
    app.handle_key("s")
    assert app.state.show_settings
    frame = "\n".join(app.build_frame(height=40))
    assert "settings" in frame and "mycall" in frame
    for ch in ":/set mycall K2XYZ\n":
        app.handle_key(ch)
    for ch in ":/set compression false\n":
        app.handle_key(ch)
    assert app.settings.mycall == "K2XYZ"
    assert app.station.callsign == "K2XYZ"
    assert app.engine.compression_enabled is False
    reloaded = AppSettings.load(ini)
    assert reloaded.mycall == "K2XYZ"
    assert reloaded.compression is False


def test_tui_recording_toggle(tmp_path):
    """RX/TX f32 capture (reference app.hpp:185): 'r' toggles recording;
    the files carry the audio that actually flowed."""
    import numpy as np

    from ria_tpu.runtime.tui import TuiApp
    from ria_tpu.sim import awgn

    app = TuiApp(mycall="W1AW", sim_channel=awgn(18.0), seed=10,
                 record_prefix=str(tmp_path / "cap"))
    app.handle_key("r")
    assert app.state.recording
    app.handle_key("c")
    for _ in range(40):
        app.step()
    app.handle_key("r")
    assert not app.state.recording
    rx = np.fromfile(tmp_path / "cap_rx.f32", np.float32)
    tx = np.fromfile(tmp_path / "cap_tx.f32", np.float32)
    assert len(rx) > 48000 and len(tx) > 1000
    assert float(np.abs(tx).max()) > 0.01  # the PING actually went out


def test_tui_file_transfer_progress():
    """File panel: /file sends through the engine, the progress bar renders,
    and the virtual peer receives the payload intact."""
    import numpy as np

    from ria_tpu.runtime.tui import TuiApp
    from ria_tpu.sim import awgn

    app = TuiApp(mycall="W1AW", sim_channel=awgn(18.0), seed=11)
    app.handle_key("c")
    for _ in range(80):
        app.step()
        if app.station.conn.state.name == "CONNECTED":
            break
    assert app.station.conn.state.name == "CONNECTED"

    import tempfile, os

    got = []
    app.peer_engine.on_file_received = \
        lambda name, data, ok: got.append((name, data, ok))
    payload = bytes(range(256)) * 2
    with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
        f.write(payload)
        path = f.name
    try:
        for ch in f":/file {path}\n":
            app.handle_key(ch)
        for _ in range(400):
            app.step()
            if got:
                break
        assert got and got[0][1] == payload and got[0][2]
        frame = "\n".join(app.build_frame(height=40))
        assert "file" in frame and "%" in frame
    finally:
        os.unlink(path)
