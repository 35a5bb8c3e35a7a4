"""repro_torch.mesh: the 2D client x model execution plane (the port of
the JAX package's ``repro/mesh``).

The 1D ``shard_map`` engine shards the *client* axis: every rank holds
whole model replicas. ``engine="mesh_2d"`` lays a ``(dc, dm)`` mesh over
the ranks (:func:`repro_torch.launch.mesh.make_mesh_2d`): the client axis
is the 1D engine's, padded where clients do not divide ``dc``; a model
axis ``dm > 1`` splits each replica's weights and matmuls over the ``dm``
ranks of a slab, by hand-written tensor parallelism
(:mod:`repro_torch.mesh.collectives`). :mod:`repro_torch.mesh.placement`
holds the ``engine="auto"`` decision table. Select via ``FederationSpec(
engine="mesh_2d", mesh_shape=(dc, dm))``.
"""
from repro_torch.mesh.engine import default_param_specs, make_mesh_2d_round
from repro_torch.mesh.placement import (
    DEFAULT_DEVICE_MEM_BYTES,
    choose_engine,
    default_mesh_shape,
    device_memory_budget,
    model_shards_for,
    n_client_shards,
    replica_fits,
)

__all__ = [
    "DEFAULT_DEVICE_MEM_BYTES",
    "choose_engine",
    "default_mesh_shape",
    "default_param_specs",
    "device_memory_budget",
    "make_mesh_2d_round",
    "model_shards_for",
    "n_client_shards",
    "replica_fits",
]
