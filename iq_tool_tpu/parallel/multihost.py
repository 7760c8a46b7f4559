"""Multi-host execution entry points.

The reference is strictly single-process (SURVEY.md section 2f); here the
distribution story is: `jax.distributed.initialize` connects the hosts,
the (channel, time) mesh spans every host's devices, and each host's I/O
feeds its OWN channels' byte streams (host-local sharding of the channel
axis), so the steady state needs no cross-host data redistribution —
collectives stay within a host's interconnect and only filter-tail halos
cross hosts on the time axis.

On a single host this degrades to the local device mesh; the functions
are safe to call either way.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from iq_tool_tpu.parallel.sharded import ShardedChain, make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               cpu_proxy_devices: int | None = None) -> None:
    """Connect this process to the multi-host job (no-op when single).

    ``cpu_proxy_devices``: when set, configure this process's CPU backend
    with that many virtual devices and Gloo cross-process collectives —
    the CPU proxy used by tests/test_multihost.py and
    tools/multihost_worker.py (SURVEY.md section 4 item 4).  On hosts
    with accelerators leave it None; device counts come from the
    hardware.  Must be
    called before any JAX backend initializes.
    """
    if cpu_proxy_devices:
        jax.config.update("jax_num_cpu_devices", cpu_proxy_devices)
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(channel_shards: int | None = None,
                time_shards: int | None = None):
    """Mesh over ALL devices in the job (local or pod-wide)."""
    return make_mesh(jax.devices(), channel_shards, time_shards)


def host_local_channels(sc: ShardedChain) -> tuple[int, int]:
    """(first_channel, count) this host is responsible for feeding.

    Channels are sharded over the mesh's channel axis; each host reads the
    byte streams of the channels whose shards live on its local devices.
    Raises for meshes where one host's channel shards are NON-contiguous
    (feeding would need a gather; build the mesh host-major instead).
    """
    mesh = sc.mesh
    ch_per_shard = sc.cfg.channels // sc.c_shards
    local = set()
    for d in jax.local_devices():
        coords = np.argwhere(mesh.devices == d)
        for (ci, _ti) in coords:
            local.add(int(ci))
    if not local:
        return 0, 0
    idx = sorted(local)
    if idx != list(range(idx[0], idx[0] + len(idx))):
        raise ValueError(
            f"this host's channel shards {idx} are not contiguous; "
            "order mesh devices host-major so each host feeds one slab")
    return idx[0] * ch_per_shard, len(idx) * ch_per_shard


def shard_input(sc: ShardedChain, host_array: np.ndarray):
    """Place a (channels, n_in*items) host array onto the mesh with the
    step's input sharding (single-host convenience; multi-host feeding
    uses jax.make_array_from_process_local_data)."""
    sharding = NamedSharding(sc.mesh, P("channel", "time"))
    return jax.device_put(host_array, sharding)
