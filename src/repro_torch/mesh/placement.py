"""Mesh-aware engine placement: the ``engine="auto"`` decision table (the
port's copy of the JAX package's ``repro/mesh/placement.py``).

Pure arithmetic over (client count, device count, per-replica footprint,
per-device memory budget). Here a "device" is a rank of the client process
group (:mod:`repro_torch.launch.mesh`): one card per rank under a
launcher, or the gloo ranks of the ``cpu-mesh`` profile.
``repro_torch.api.engines.resolve_engine`` consults :func:`choose_engine`
with the world size; launchers feed the footprint from
:func:`repro_torch.configs.shapes.replica_footprint_bytes` (the spec
carries it as the ``replica_bytes`` hint).

The rule, in order:

1. one device -> ``vmap`` (nothing to shard);
2. replica footprint known and over budget -> ``mesh_2d`` (the only engine
   that can split a replica), UNLESS the spec is adversarial: the robust /
   secure reductions are full-view and stay on the 1D engines;
3. multiple devices and a client axis worth sharding -> ``shard_map``;
4. otherwise ``vmap``.

The per-device budget is the ``REPRO_DEVICE_MEM_BYTES`` override, else the
current CUDA card's total memory, else an H100 80GB's. The JAX package's
default, a TPU v5e chip's 16 GiB, does not carry over: the port runs on
H100s.
"""
from __future__ import annotations

import math
import os

ENV_DEVICE_MEM = "REPRO_DEVICE_MEM_BYTES"
# an H100 80GB HBM3's memory as torch reports it (79.18 GiB): the budget
# where no card is present to ask
H100_MEM_BYTES = 85_017_493_504
DEFAULT_DEVICE_MEM_BYTES = H100_MEM_BYTES


def device_memory_budget(default: int | None = None) -> int:
    """Per-device memory budget in bytes: the ``REPRO_DEVICE_MEM_BYTES``
    override, else ``default``, else the current CUDA device's total
    memory (an H100's where there is no card)."""
    env = os.environ.get(ENV_DEVICE_MEM)
    if env:
        budget = int(env)
        if budget <= 0:
            raise ValueError(f"{ENV_DEVICE_MEM} must be positive, "
                             f"got {budget}")
        return budget
    if default is not None:
        return int(default)
    import torch
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory)
    return DEFAULT_DEVICE_MEM_BYTES


def replica_fits(replica_bytes: int, hbm_bytes: int | None = None) -> bool:
    """Does one whole model replica (+ optimizer state) fit one device?"""
    return int(replica_bytes) <= device_memory_budget(hbm_bytes)


def n_client_shards(n_clients: int, n_devices: int) -> int:
    """Largest divisor of n_clients that fits in the device count: the 1D
    engine's client-axis size (it requires clients to divide exactly)."""
    return max(d for d in range(1, min(n_clients, n_devices) + 1)
               if n_clients % d == 0)


def model_shards_for(replica_bytes: int, n_devices: int,
                     hbm_bytes: int | None = None) -> int:
    """Smallest divisor ``dm`` of ``n_devices`` with ``replica_bytes / dm``
    under the per-device budget (``n_devices`` if even full sharding cannot
    cover it: best effort)."""
    budget = device_memory_budget(hbm_bytes)
    for dm in range(1, n_devices + 1):
        if n_devices % dm == 0 and math.ceil(replica_bytes / dm) <= budget:
            return dm
    return n_devices


def choose_engine(n_clients: int, n_devices: int,
                  replica_bytes: int | None = None,
                  hbm_bytes: int | None = None,
                  adversarial: bool = False) -> str:
    """The ``engine="auto"`` decision (see the module docstring)."""
    if n_devices <= 1:
        return "vmap"
    if (replica_bytes is not None and not adversarial
            and not replica_fits(replica_bytes, hbm_bytes)):
        return "mesh_2d"
    if n_client_shards(n_clients, n_devices) > 1:
        return "shard_map"
    return "vmap"


def default_mesh_shape(n_clients: int, n_devices: int,
                       replica_bytes: int | None = None,
                       hbm_bytes: int | None = None) -> tuple[int, int]:
    """Default ``(dc, dm)`` split of the ranks.

    ``dm`` is the smallest model-axis size that brings a replica under the
    per-device budget (1 when no footprint is known: all ranks go to client
    blocks); the remaining factor becomes client blocks, clamped to the
    client count (padding handles non-dividing clients, but blocks beyond
    ``n_clients`` would sit empty)."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    dm = (1 if replica_bytes is None
          else model_shards_for(replica_bytes, n_devices, hbm_bytes))
    dc = max(1, min(n_devices // dm, n_clients))
    return dc, dm
