"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

Production geometry throughout (10-carrier MC-DPSK, 512 samples/symbol, the
full 1.2 s dual chirp) — these validate the real compiled programs, not toy
shapes: time-block stream sharding with halo exchange (parallel/stream.py),
the (ch x cw) batch mesh (parallel/mesh.py), and the multi-host helpers
(parallel/distributed.py) in their single-process degenerate form.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from ria_tpu.fec.ldpc import make_encoder
from ria_tpu.fec.ldpc_matrix import get_code
from ria_tpu.parallel.stream import (
    make_sharded_fir, make_stream_mesh, make_stream_rx, make_stream_search,
)
from ria_tpu.wave.mc_dpsk import MCDPSKConfig, modulate, preamble

NCW = 4
BLOCK = 96000
CFO_HZ = 5.0
FRAME_POS = 150000  # chirp straddles the 96000*2=192000 shard boundary


@pytest.fixture(scope="module")
def prod_cfg():
    return MCDPSKConfig(num_carriers=10, bits_per_symbol=1)


@pytest.fixture(scope="module")
def stream_case(prod_cfg):
    """One production-geometry frame at 10 dB AWGN with +5 Hz CFO, placed so
    its preamble straddles a shard boundary of the 8-device stream."""
    rng = np.random.default_rng(7)
    code = get_code("R1_4")
    info = rng.integers(0, 2, (NCW, code.k)).astype(np.uint8)
    coded = np.asarray(make_encoder("R1_4")(info)).reshape(-1)
    tx = np.concatenate([preamble(prod_cfg, tx_cfo_hz=CFO_HZ),
                         modulate(coded, prod_cfg)])
    stream = np.zeros(8 * BLOCK, np.float32)
    stream[FRAME_POS : FRAME_POS + len(tx)] = tx
    rms = float(np.sqrt(np.mean(tx**2)))
    stream += rng.normal(0, rms * 10 ** (-10 / 20), stream.shape).astype(np.float32)
    return stream, info


@pytest.fixture(scope="module")
def stream_rx_out(prod_cfg, stream_case):
    stream, _ = stream_case
    mesh = make_stream_mesh(8)
    rx = make_stream_rx(mesh, prod_cfg, "R1_4", NCW, BLOCK)
    out = jax.block_until_ready(rx(stream))
    return {k: np.asarray(v) for k, v in out.items()}


def test_stream_rx_boundary_straddle(prod_cfg, stream_case, stream_rx_out):
    """A frame whose preamble crosses a shard edge is found and decoded by
    the sharded pipeline; timing, CFO and every codeword are correct."""
    _, info = stream_case
    out = stream_rx_out
    assert bool(out["detected"])
    assert abs(int(out["start"]) - FRAME_POS) <= 8
    assert abs(float(out["cfo_hz"]) - CFO_HZ) < 1.0
    assert out["cw_success"].all()
    k = get_code("R1_4").k
    assert (out["info_bits"][:, :k] == info).all()


def test_stream_soft_bits_match_single_chip(prod_cfg, stream_case, stream_rx_out):
    """The sequence-parallel mix-integrate + psum assembly reproduces the
    single-chip demodulator's soft bits on the same frame (same start/CFO)."""
    from ria_tpu.wave.mc_dpsk import demodulate

    stream, _ = stream_case
    out = stream_rx_out
    start = int(out["start"]) + prod_cfg.chirp.total_samples
    cfo = float(out["cfo_hz"])
    S_all = prod_cfg.training_symbols + 1 + prod_cfg.num_data_symbols(NCW * 648)
    frame = stream[start : start + S_all * prod_cfg.samples_per_symbol]
    ref = demodulate(frame, np.float32(cfo), prod_cfg, prod_cfg.num_data_symbols(NCW * 648))
    ref_soft = np.asarray(ref.soft_bits)[: NCW * 648]
    got = out["soft_bits"].reshape(-1)
    # identical math modulo f32 reduction order across the psum
    assert np.allclose(got, ref_soft, atol=2e-3)
    assert np.mean(np.sign(got) == np.sign(ref_soft)) > 0.999


def test_stream_search_clean_block_interior(prod_cfg, stream_case):
    """Standalone sharded search: same detection when the frame is interior
    to a single shard (no halo needed) — the halo path must not regress it."""
    stream, _ = stream_case
    mesh = make_stream_mesh(8)
    search = make_stream_search(mesh, prod_cfg.chirp, BLOCK)
    det, start, cfo = jax.block_until_ready(search(stream))
    assert bool(det)
    assert abs(int(start) - FRAME_POS) <= 8
    assert abs(float(cfo) - CFO_HZ) < 1.0


def test_sharded_fir_matches_unsharded():
    """Overlap-save halo FIR == host causal convolution, bit-close."""
    from ria_tpu.dsp.fir import design_bandpass

    rng = np.random.default_rng(3)
    taps = design_bandpass(101, 300.0, 2700.0, 48000.0)
    block = 12000
    x = rng.normal(0, 1, (3, 8 * block)).astype(np.float32)
    mesh = make_stream_mesh(8)
    f = make_sharded_fir(mesh, taps, block)
    y = np.asarray(f(x))
    ref = np.stack([np.convolve(r, taps)[: x.shape[1]] for r in x])
    assert np.abs(y - ref).max() < 1e-5


def test_mesh_sharded_rx_production_geometry(prod_cfg):
    """The (ch x cw) batch mesh at PRODUCTION geometry: 8 channels data-
    parallel, LDPC codeword batch resharded over the full mesh (the
    round-1 dryrun only exercised toy shapes)."""
    from ria_tpu.parallel.mesh import make_mesh, make_sharded_rx
    from ria_tpu.phy.pipeline import make_tx_pipeline

    rng = np.random.default_rng(11)
    code = get_code("R1_4")
    B = 8
    nb = NCW * 648
    window = prod_cfg.frame_samples(nb) + 12000
    info = rng.integers(0, 2, (B * NCW, code.k)).astype(np.uint8)
    coded = np.asarray(make_encoder("R1_4")(info)).reshape(B, nb)
    tx = np.asarray(make_tx_pipeline(prod_cfg, NCW)(coded))
    audio = np.zeros((B, window), np.float32)
    for b in range(B):
        lead = int(rng.integers(0, 8000))
        audio[b, lead : lead + tx.shape[1]] = tx[b, : window - lead]
    rms = float(np.sqrt(np.mean(tx**2)))
    audio += rng.normal(0, rms * 10 ** (-10 / 20), audio.shape).astype(np.float32)

    mesh = make_mesh(8)
    rx = make_sharded_rx(mesh, prod_cfg, "R1_4", NCW, window)
    with mesh:
        out = jax.block_until_ready(rx(audio))
    assert np.asarray(out.detected).all()
    assert np.asarray(out.cw_success).all()
    k = code.k
    got = np.asarray(out.info_bits).reshape(B * NCW, -1)[:, :k]
    assert (got == info).all()


def test_stream_rx_two_frames_topk(prod_cfg):
    """Two frames in one sharded stream window BOTH decode (top_k) — one
    interior to a block, one straddling a shard boundary (the single
    global argmax would find only one)."""
    from ria_tpu.phy.pipeline import make_tx_pipeline

    rng = np.random.default_rng(13)
    code = get_code("R1_4")
    block = 65536
    infos, txs = [], []
    for _ in range(2):
        info = rng.integers(0, 2, (NCW, code.k)).astype(np.uint8)
        coded = np.asarray(make_encoder("R1_4")(info)).reshape(1, NCW * 648)
        infos.append(info)
        txs.append(np.asarray(make_tx_pipeline(prod_cfg, NCW)(coded))[0])
    total = 8 * block
    audio = np.zeros(total, np.float32)
    p0, p1 = 5000, 4 * block - 2000  # p1 straddles the block 3->4 boundary
    audio[p0 : p0 + len(txs[0])] = txs[0]
    audio[p1 : p1 + len(txs[1])] = txs[1]
    rms = float(np.sqrt(np.mean(txs[0] ** 2)))
    audio += rng.normal(0, rms * 10 ** (-10 / 20), total).astype(np.float32)

    mesh = make_stream_mesh(8)
    rx = make_stream_rx(mesh, prod_cfg, "R1_4", NCW, block, top_k=2)
    out = {k: np.asarray(v) for k, v in jax.block_until_ready(rx(audio)).items()}
    assert out["detected"].all()
    assert {int(s) for s in out["start"]} == {p0, p1}
    assert out["cw_success"].all()
    k = code.k
    by_start = {int(s): out["info_bits"][i, :, :k]
                for i, s in enumerate(out["start"])}
    assert (by_start[p0] == infos[0]).all()
    assert (by_start[p1] == infos[1]).all()


def test_ofdm_stream_rx_boundary_straddle():
    """Sequence-parallel OFDM RX: a Schmidl-Cox frame
    whose preamble straddles a shard boundary is found at the exact sample
    and every codeword decodes; the assembled bins reproduce the
    single-chip demodulator."""
    from ria_tpu.fec.ldpc_matrix import get_code
    from ria_tpu.parallel.stream import make_ofdm_stream_rx
    from ria_tpu.phy.frame_v2 import encode_fixed_frame
    from ria_tpu.wave.ofdm import OFDMConfig, tx_frame

    cfg = OFDMConfig(modulation="DQPSK", use_pilots=False)
    rate = "R1_2"
    ci = cfg.bits_per_ofdm_symbol()
    block = 16384
    rng = np.random.default_rng(5)
    payload = rng.integers(0, 256, 4 * (get_code(rate).k // 8)).astype(np.uint8).tobytes()
    tx = np.asarray(tx_frame(encode_fixed_frame(payload, rate, ci), cfg,
                             preamble="cox"), np.float32)
    total = 8 * block
    pos = 3 * block - 3000  # preamble straddles the block 2->3 boundary
    audio = np.zeros(total, np.float32)
    audio[pos : pos + len(tx)] = tx
    rms = float(np.sqrt(np.mean(tx**2)))
    audio += rng.normal(0, rms * 10 ** (-15 / 20), total).astype(np.float32)

    mesh = make_stream_mesh(8)
    rx = make_ofdm_stream_rx(mesh, cfg, rate, block, ci)
    out = jax.block_until_ready(rx(audio))
    assert bool(out["detected"])
    assert int(out["lts_start"]) == pos + 5 * cfg.symbol_samples
    assert np.asarray(out["cw_success"]).all()


def test_ofdm_mesh_sharded_rx_per_device_decode():
    """Batch-mesh OFDM RX: 16 channels over the 8-device mesh, each device
    running the full chain and the XLA LDPC decoder on its own rows."""
    from ria_tpu.fec.ldpc_matrix import get_code
    from ria_tpu.parallel.mesh import make_mesh, make_sharded_ofdm_rx
    from ria_tpu.phy.frame_v2 import encode_fixed_frame
    from ria_tpu.wave.ofdm import OFDMConfig, tx_frame

    cfg = OFDMConfig(modulation="DQPSK", use_pilots=False)
    rate = "R1_2"
    ci = cfg.bits_per_ofdm_symbol()
    B = 16
    S = cfg.num_symbols_for_bits(4 * 648)
    window = cfg.preamble_samples + (2 + S) * cfg.symbol_samples + 6000
    rng = np.random.default_rng(6)
    audio = np.zeros((B, window), np.float32)
    for b in range(B):
        payload = rng.integers(0, 256, 4 * (get_code(rate).k // 8)).astype(np.uint8).tobytes()
        tx = np.asarray(tx_frame(encode_fixed_frame(payload, rate, ci), cfg,
                                 preamble="cox"), np.float32)
        lead = int(rng.integers(0, 3000))
        audio[b, lead : lead + len(tx)] = tx
        rms = float(np.sqrt(np.mean(tx**2)))
    audio += rng.normal(0, rms * 10 ** (-15 / 20), audio.shape).astype(np.float32)

    mesh = make_mesh(8)
    rx = make_sharded_ofdm_rx(mesh, cfg, rate, window, ci)
    out = jax.block_until_ready(rx(audio))
    assert np.asarray(out.detected).all()
    assert np.asarray(out.cw_success).all()


@pytest.mark.slow
def test_distributed_two_process_decode():
    """A REAL 2-process jax.distributed run: spawn two
    CPU processes with a local coordinator, build the (ch=2, t=4) hybrid
    mesh across them, assemble a cross-host array from per-process rows
    (put_stream_rows + psum check), and decode one boundary-straddling
    MC-DPSK frame through the sharded stream RX on that mesh."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "_distributed_worker.py")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, worker, str(i), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
        last = [l for l in out.strip().splitlines() if l.startswith("WORKER_OK")]
        assert last, f"worker {i} no result:\n{out[-2000:]}"
        _, pid, start, cw_ok, s0, s1 = last[-1].split()
        assert int(pid) == i
        assert int(cw_ok) == 1
        # Cross-host rows: row h was fed only by process h with value h+1.
        assert int(s0) == 1 * 4096 and int(s1) == 2 * 4096


def test_distributed_single_process_helpers():
    """Multi-host helpers degenerate correctly on one process: hybrid mesh
    (ch=1, t=8), process-count init no-op, and put_stream sharding."""
    from ria_tpu.parallel import distributed

    assert distributed.initialize() == jax.process_count() == 1
    mesh = distributed.make_hybrid_mesh()
    assert mesh.shape["t"] == len(jax.devices())
    assert mesh.shape["ch"] == 1

    audio = np.arange(8 * 1024, dtype=np.float32)
    arr = distributed.put_stream(make_stream_mesh(8), audio)
    assert arr.shape == audio.shape
    assert len(arr.sharding.device_set) == 8
    assert np.array_equal(np.asarray(arr), audio)


def test_ofdm_stream_rx_low_snr_sharded_decode():
    """Sharded OFDM decode at <=10 dB (previous coverage stopped at 15 dB):
    the distributed (codeword x ladder-variant) decode half must match the
    single-chip decode bit-for-bit at a low-SNR operating point, with the
    frame straddling a shard boundary."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from ria_tpu.fec.interleave import apply_perm, channel_perm, frame_perm
    from ria_tpu.parallel.stream import make_ofdm_stream_rx, make_stream_mesh
    from ria_tpu.phy.frame_v2 import (bits_to_bytes, encode_fixed_frame,
                                      make_fixed_data_frame,
                                      reassemble_codewords)
    from ria_tpu.sim import apply_channel, awgn
    from ria_tpu.wave import ofdm

    cfg = ofdm.OFDMConfig(modulation="DQPSK", use_pilots=True,
                          pilot_spacing=10)
    ci = cfg.bits_per_ofdm_symbol()
    fb = make_fixed_data_frame("W1AW", "VE3ABC", 2, bytes(range(90)),
                               "R1_2").serialize()
    bits = encode_fixed_frame(fb, "R1_2", ci)
    tx = ofdm.tx_frame(np.asarray(bits), cfg, preamble="cox")

    mesh = make_stream_mesh(8)
    block = 3 * 48000
    total = 8 * block
    # Straddle the shard-1/2 boundary.
    start = 2 * block - len(tx) // 3
    audio = np.zeros(total, np.float32)
    audio[start: start + len(tx)] = tx
    out = np.asarray(apply_channel(jnp.asarray(audio),
                                   jax.random.PRNGKey(11),
                                   awgn(8.0)).samples)

    rx = make_ofdm_stream_rx(mesh, cfg, "R1_2", block, ci_bits=ci)
    res = rx(jnp.asarray(out))
    assert bool(res["detected"])
    assert np.asarray(res["cw_success"]).all(), res["cw_success"]
    chunks = [bits_to_bytes(np.asarray(res["info_bits"][i]))
              for i in range(4)]
    got = reassemble_codewords(chunks, "R1_2", len(fb))
    assert got == fb
