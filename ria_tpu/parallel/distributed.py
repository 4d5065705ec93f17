"""Multi-process meshes and process-local data feeding.

The reference is a single process (SURVEY.md §2.12); scale-out across
processes is a new component.  The recipe:

- ``initialize()`` brings up ``jax.distributed`` (coordinator handshake over
  the network) when launched as one process per host or per card; it is a
  safe no-op for a single-process run, so the same program serves tests, one
  host, and a cluster.
- ``make_hybrid_mesh(ch=..., t=...)`` lays a 2D (ch, t) mesh whose rows are
  processes: the ``t`` axis — which carries the nearest-neighbor halo
  ppermutes of parallel.stream — stays INSIDE a process (the cards of one
  host, joined all to all by NVLink), while the embarrassingly parallel
  channel axis crosses processes.  Put the chatty axis on the fast fabric.
- ``put_stream()`` builds the global sharded array from per-process local
  blocks without ever materializing the whole stream on one host
  (``jax.make_array_from_process_local_data``) — each host feeds only the
  audio its own shards consume, the multi-host analogue of the reference's
  per-station audio callbacks.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> int:
    """Bring up jax.distributed when running multi-process; returns the
    process count.  Single-process (tests, one host with all chips visible)
    is a no-op.  Env-var driven (JAX_COORDINATOR_ADDRESS etc.) when args are
    None, matching jax.distributed.initialize defaults."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    elif coordinator_address is not None:
        jax.distributed.initialize(coordinator_address=coordinator_address)
    return jax.process_count()


def make_hybrid_mesh(ch: int | None = None, t: int | None = None) -> Mesh:
    """2D (ch, t) mesh with the halo-exchange axis ``t`` kept on-host.

    Defaults: t = devices per process, ch = number of processes.  On a
    single process this degenerates to ch=1, t=all local devices, which is
    exactly parallel.stream's 1D mesh plus a broadcast channel axis.
    """
    n_local = len(jax.local_devices())
    n_proc = jax.process_count()
    t = t or n_local
    ch = ch or (len(jax.devices()) // t)
    if n_proc > 1:
        # Each mesh row = one process's devices, so every t-axis neighbor
        # pair (the ppermute halo traffic) stays inside one process.
        devs = np.asarray(sorted(jax.devices(),
                                 key=lambda d: (d.process_index, d.id)))
        devs = devs[: ch * t].reshape(ch, t)
    else:
        devs = np.asarray(jax.devices()[: ch * t]).reshape(ch, t)
    return Mesh(devs, axis_names=("ch", "t"))


def put_stream_rows(mesh: Mesh, rows_local: np.ndarray):
    """Build the global [ch, T] array with CHANNEL rows split across hosts
    (the hybrid layout's cross-process axis): each process feeds only its own
    channel rows [ch_local, T]; no host ever materializes another host's
    audio.  Columns stay sharded over the on-host ``t`` axis."""
    sharding = NamedSharding(mesh, P("ch", "t"))
    if jax.process_count() == 1:
        return jax.device_put(rows_local, sharding)
    return jax.make_array_from_process_local_data(sharding, rows_local)


def put_stream(mesh: Mesh, audio_local: np.ndarray, axis: str = "t"):
    """Build the global [ch, T] array from this process's local block(s).

    Single-process: a plain device_put with the (ch, t) sharding.
    Multi-process: assembles the global array from per-host locals without
    gathering — audio_local must be this host's slice of the global stream.
    """
    spec = P(None, axis) if audio_local.ndim == 2 else P(axis)
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(audio_local, sharding)
    return jax.make_array_from_process_local_data(sharding, audio_local)
