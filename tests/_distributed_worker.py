"""Worker for the real 2-process jax.distributed test (run by
tests/test_parallel.py::test_distributed_two_process_decode via subprocess).

Each process owns 4 virtual CPU devices; together they form an 8-device
(ch=2, t=4) hybrid mesh — the t axis (halo ppermutes) stays inside a
process, the ch axis crosses the process boundary.

Work proven here:
1. jax.distributed.initialize handshake (2 processes, local coordinator);
2. make_hybrid_mesh over the global device set;
3. put_stream: the global [ch, T] array assembled from per-PROCESS local
   rows (no host ever holds the other's data), verified by a cross-host
   psum;
4. one MC-DPSK frame decoded through the sharded stream RX on the hybrid
   mesh (sync halo exchange + psum symbol assembly + LDPC).

Prints one final line "WORKER_OK <proc_id> <start> <cw_ok> <psum0> <psum1>"
consumed by the test.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

proc_id = int(sys.argv[1])
port = sys.argv[2]

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from ria_tpu.parallel import distributed  # noqa: E402

n = distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=2, process_id=proc_id)
assert n == 2, n
assert len(jax.devices()) == 8, len(jax.devices())
assert len(jax.local_devices()) == 4

mesh = distributed.make_hybrid_mesh()
assert mesh.shape == {"ch": 2, "t": 4}, mesh.shape

# --- put_stream from per-process rows + cross-host psum ------------------
T = 4096
local_row = np.full((1, T), float(proc_id + 1), np.float32)
arr = distributed.put_stream_rows(mesh, local_row)
summed = jax.jit(
    lambda a: a.sum(axis=-1),
    out_shardings=NamedSharding(mesh, P(None)))(arr)
sums = np.asarray(summed)  # [2] — row h must hold (h+1)*T
assert sums.shape == (2,)

# --- one frame through the sharded stream RX on the hybrid mesh ----------
from ria_tpu.fec.ldpc import make_encoder  # noqa: E402
from ria_tpu.fec.ldpc_matrix import get_code  # noqa: E402
from ria_tpu.parallel.stream import make_stream_rx  # noqa: E402
from ria_tpu.sync.chirp import ChirpConfig  # noqa: E402
from ria_tpu.wave.mc_dpsk import MCDPSKConfig, modulate, preamble  # noqa: E402

cfg = MCDPSKConfig(num_carriers=4, samples_per_symbol=128, bits_per_symbol=2,
                   training_symbols=4,
                   chirp=ChirpConfig(duration_ms=10.0, gap_ms=2.0))
ncw = 2
rng = np.random.default_rng(2)
code = get_code("R1_4")
info = rng.integers(0, 2, (ncw, code.k)).astype(np.uint8)
coded = np.asarray(make_encoder("R1_4")(info)).reshape(-1)
tx = np.concatenate([preamble(cfg), modulate(coded, cfg)])
block = max(8192, -(-(len(tx) + 4096) // 4))
total = 4 * block
stream = np.zeros(total, np.float32)
pos = min(block // 2, total - len(tx))
stream[pos : pos + len(tx)] = tx
stream += rng.normal(0, 0.02, total).astype(np.float32)

rx = make_stream_rx(mesh, cfg, "R1_4", ncw, block)
audio = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("t")), stream)
out = jax.block_until_ready(rx(audio))
start = int(np.asarray(out["start"]))
cw_ok = bool(np.asarray(out["cw_success"]).all())
assert start == pos, (start, pos)

print(f"WORKER_OK {proc_id} {start} {int(cw_ok)} "
      f"{int(sums[0])} {int(sums[1])}", flush=True)
