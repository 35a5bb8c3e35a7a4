"""Round engines and their registry.

A *round engine* is a builder that turns a :class:`FederationSpec` into the
round function

    round_fn(params, opt_state, batch, noise, sigmas)
        -> (new_params, new_opt_state, metrics)

with params/opt_state carrying a leading client axis C, batch leaves shaped
(C, tau, B, ...), ``noise`` the round's (C, tau, N) standard normals and
sigmas (C,). A spec with an aggregation pipeline gets the pipeline round,

    round_fn(params, opt_state, batch, noise, sigmas, mask, residual,
             agg_rand) -> (new_params, new_opt_state, new_residual, metrics)

(see :func:`repro_torch.core.fl.make_round_step`). Five engines are
registered:

    "vmap"            all C clients as one batch: one dp_clip_noise call
                      per step
    "map"             the same math one client at a time (one row per
                      kernel call)
    "shard_map"       the client axis over the ranks of the
                      ``torch.distributed`` world (``n_client_shards(C,
                      world)`` of them): each rank runs its block as "vmap"
                      does, then one collective (:mod:`repro_torch.core
                      .fl_shard_map`)
    "mesh_2d"         the same on a (dc, dm) mesh (``spec.mesh_shape`` or
                      :func:`~repro_torch.mesh.placement.default_mesh_shape`),
                      padding clients that do not divide dc; dm > 1
                      splits each replica over a slab's ranks (tensor
                      parallelism written by hand, :mod:`repro_torch.mesh`)
    "async_buffered"  the buffered-async executor
                      (:class:`repro_torch.asyncfl.engine.AsyncBufferedExecutor`),
                      not a round function: it is driven by
                      :mod:`repro_torch.asyncfl`

``register_engine`` adds an execution strategy without touching the
drivers, which select purely through ``FederationSpec.engine``. The
sharded engines run every rank's copy of the driver (SPMD): their round
functions take and return the full client-stacked trees. ``mesh_2d``'s
also carries a slab round (:func:`slab_round_fn_for`) on one rank's slab
of the state, which the drivers run where a state is slab-local
(:func:`repro_torch.api.state.init_state`). Where no process group is
initialized they build a world of one (:func:`repro_torch.launch.mesh
.ensure_world`).

``engine="auto"`` follows :func:`~repro_torch.mesh.placement.choose_engine`
over the world's ranks, never "async_buffered". A ``replica_bytes`` hint
over the per-device budget resolves to "mesh_2d" on any world, one rank
included (the JAX package keeps "vmap" on one device, where the replica
would not fit either); on a world too small to split the replica,
building it raises ``ValueError`` saying how many ranks the replica needs.
Every engine's Eq.-7a clip + noise runs through the ``dp_clip_noise``
kernel, and the qsgd compressor through ``quantize_decompress``, on the
spec's ``kernel_backend``. Round functions are cached per
``spec.engine_key()`` and process group. The population plane's resident
chunk (:func:`resident_chunked_round_fn_for`) moves cohort rows through
the ``cohort_gather_scatter`` kernel.
"""
from __future__ import annotations

from typing import Any, Callable, Protocol

from repro_torch.api.spec import ENGINES, FederationSpec
from repro_torch.core.fl import (
    make_chunked_round,
    make_resident_chunked_round,
    make_round_step,
)
from repro_torch.launch.mesh import make_mesh_2d, world_size
from repro_torch.mesh.placement import (  # noqa: F401  (re-exported)
    ENV_DEVICE_MEM,
    H100_MEM_BYTES,
    choose_engine,
    default_mesh_shape,
    device_memory_budget,
    n_client_shards,
    replica_fits,
)

RoundFn = Callable[..., tuple[Any, Any, dict]]


class RoundEngine(Protocol):
    """Builder protocol: spec -> round_fn."""

    def __call__(self, spec: FederationSpec) -> RoundFn: ...


_REGISTRY: dict[str, RoundEngine] = {}


def register_engine(name: str, builder: RoundEngine | None = None):
    """Register a round-engine builder under ``name``.

    Usable directly (``register_engine("x", build)``) or as a decorator
    (``@register_engine("x")``).
    """
    def _add(b: RoundEngine) -> RoundEngine:
        _REGISTRY[name] = b
        return b

    return _add if builder is None else _add(builder)


def available_engines() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _world_key():
    """The process group a sharded round function is built on (None when
    no group is initialized): part of the round-function cache keys."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return None
    return (dist.get_world_size(), dist.get_rank(),
            dist.distributed_c10d._get_default_group())


def resolve_engine(spec: FederationSpec) -> str:
    """Map ``engine="auto"`` to a concrete engine by
    :func:`~repro_torch.mesh.placement.choose_engine` over the world's
    ranks; a ``replica_bytes`` hint over the device budget resolves to
    "mesh_2d" on any world (a non-adversarial spec). "async_buffered"
    resolves only by name."""
    if spec.engine != "auto":
        return spec.engine
    if (spec.replica_bytes is not None and not spec.is_adversarial()
            and not replica_fits(spec.replica_bytes)):
        return "mesh_2d"
    return choose_engine(spec.n_clients, world_size(), spec.replica_bytes,
                         adversarial=spec.is_adversarial())


def mesh_shape_for(spec: FederationSpec) -> tuple[int, int]:
    """The (dc, dm) of a mesh_2d spec: ``spec.mesh_shape``, else the
    placement default over the world's ranks. A default mesh whose slab
    cannot hold the hinted replica (a world too small to split it) raises
    ``ValueError`` saying how many ranks the replica needs."""
    if spec.mesh_shape is not None:
        return spec.mesh_shape
    shape = default_mesh_shape(spec.n_clients, world_size(),
                               replica_bytes=spec.replica_bytes)
    if (spec.replica_bytes is not None
            and not replica_fits(-(-spec.replica_bytes // shape[1]))):
        budget = device_memory_budget()
        need = -(-spec.replica_bytes // budget)
        raise ValueError(
            f"a replica of {spec.replica_bytes:,} bytes over the device "
            f"budget of {budget:,} needs a model axis of at least {need} "
            f"ranks to split it; the world has {world_size()} rank(s)")
    return shape


def get_engine(name_or_spec: str | FederationSpec) -> RoundEngine:
    """Look up an engine builder by name, or resolve it from a spec."""
    name = (resolve_engine(name_or_spec)
            if isinstance(name_or_spec, FederationSpec) else name_or_spec)
    if name == "auto":
        raise ValueError("pass a FederationSpec to resolve engine='auto'")
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown engine {name!r}; registered: "
                       f"{available_engines()}") from None


# ---------------------------------------------------------------------------
# built-in engines
# ---------------------------------------------------------------------------

@register_engine("vmap")
def build_vmap_engine(spec: FederationSpec) -> RoundFn:
    return make_round_step(spec.loss_fn, spec.optimizer,
                           spec.fl_config(vmap_clients=True),
                           topology=spec.topology,
                           pipeline=spec.aggregation_pipeline())


@register_engine("map")
def build_map_engine(spec: FederationSpec) -> RoundFn:
    return make_round_step(spec.loss_fn, spec.optimizer,
                           spec.fl_config(vmap_clients=False),
                           topology=spec.topology,
                           pipeline=spec.aggregation_pipeline())


@register_engine("shard_map")
def build_shard_map_engine(spec: FederationSpec) -> RoundFn:
    """The client axis over ``n_client_shards(C, world)`` ranks of the
    world (a 1D mesh: the degenerate (n, 1) 2D mesh)."""
    from repro_torch.core.fl_shard_map import make_shard_map_round
    mesh = make_mesh_2d((n_client_shards(spec.n_clients, world_size()), 1))
    return make_shard_map_round(spec.loss_fn, spec.optimizer,
                                spec.fl_config(vmap_clients=True), mesh,
                                topology=spec.topology,
                                pipeline=spec.aggregation_pipeline())


@register_engine("mesh_2d")
def build_mesh_2d_engine(spec: FederationSpec) -> RoundFn:
    """The 2D client x model plane (:mod:`repro_torch.mesh`) at
    :func:`mesh_shape_for`'s shape; clients that do not divide the client
    axis are padded inside the engine."""
    from repro_torch.mesh.engine import make_mesh_2d_round
    shape = mesh_shape_for(spec)
    rules = dict(spec.sharding_rules) if spec.sharding_rules else None
    return make_mesh_2d_round(spec.loss_fn, spec.optimizer,
                              spec.fl_config(vmap_clients=True),
                              make_mesh_2d(shape), rules=rules,
                              topology=spec.topology,
                              pipeline=spec.aggregation_pipeline())


@register_engine("async_buffered")
def build_async_engine(spec: FederationSpec):
    """The spec's :class:`repro_torch.asyncfl.engine.AsyncBufferedExecutor`:
    a flush / dispatch executor, NOT a ``round_fn`` (``round_fn_for``
    refuses async specs). Imported lazily: asyncfl builds on
    repro_torch.api."""
    from repro_torch.asyncfl.engine import AsyncBufferedExecutor
    return AsyncBufferedExecutor(spec)


# round functions keyed on the engine-relevant slice of the spec and the
# process group, so budget edits (spec.replace(eps_th=...)) reuse the built
# round. Bounded: the keys hold loss/optimizer closures.
_ROUND_FN_CACHE: dict[tuple, RoundFn] = {}
_ROUND_FN_CACHE_MAX = 32


def round_fn_for(spec: FederationSpec) -> RoundFn:
    """The round function for ``spec`` (cached per engine key and process
    group)."""
    if spec.is_async():
        raise ValueError(
            "engine='async_buffered' has no synchronous round function: "
            "drive it with repro_torch.asyncfl (init_async_state / "
            "run_async_cycle / train_async), not run_round/run_rounds")
    key = (spec.engine_key(), _world_key())
    fn = _ROUND_FN_CACHE.pop(key, None)
    if fn is None:
        fn = get_engine(spec)(spec)
        while len(_ROUND_FN_CACHE) >= _ROUND_FN_CACHE_MAX:
            _ROUND_FN_CACHE.pop(next(iter(_ROUND_FN_CACHE)))
    _ROUND_FN_CACHE[key] = fn      # (re)insert at MRU position
    return fn


def slab_round_fn_for(spec: FederationSpec) -> RoundFn:
    """The slab round of a ``mesh_2d`` spec (cached with its whole-tree
    round): ``(layout, params, opt_state, batch, noise, sigmas[, mask,
    residual, agg_rand])`` on one rank's slab of the state, returning the
    same layout (:func:`repro_torch.mesh.engine.make_mesh_2d_round`)."""
    fn = round_fn_for(spec)
    if not hasattr(fn, "slab_round"):
        raise ValueError(f"engine {resolve_engine(spec)!r} has no slab "
                         f"round; only mesh_2d keeps slab state")
    return fn.slab_round


def chunked_round_fn_for(spec: FederationSpec,
                         slab: bool = False) -> RoundFn:
    """The R-round chunk function for ``spec``: the engine's round (with
    ``slab``, its slab round) wrapped by
    :func:`repro_torch.core.fl.make_chunked_round` (a plain loop; the
    pipeline form draws each round's mask inside it)."""
    if spec.is_async():
        raise ValueError(
            "engine='async_buffered' has no fused sync chunk: drive it with "
            "repro_torch.asyncfl.train_async (its chunking is host-paced "
            "over the simulated event schedule)")
    return make_chunked_round(
        slab_round_fn_for(spec) if slab else round_fn_for(spec),
        pipeline=spec.aggregation_pipeline())


# the resident chunk draws each round's mask inside its loop, so the
# participant count is baked in and keys the cache beside the engine key
_RESIDENT_FN_CACHE: dict[tuple, RoundFn] = {}


def resident_chunked_round_fn_for(spec: FederationSpec,
                                  data_resident: bool = False) -> RoundFn:
    """The R-round chunk of the resident-cohort population driver: the
    engine's pipeline round wrapped by
    :func:`repro_torch.core.fl.make_resident_chunked_round`,

        fn(params, opt_state, batches, slots, key, sigmas, cache)
            -> (params, opt_state, key, cache, metrics, masks)

    ``data_resident=True`` takes the (S, tau, B, ...) warm-shard cache as
    ``batches`` (stationary populations). Cached per (engine key,
    participant count, data_resident). A spec without a pipeline has no
    device-resident sticky state, so it is refused: its resident driver
    uses :func:`chunked_round_fn_for`."""
    if not spec.has_pipeline():
        raise ValueError(
            "resident_chunked_round_fn_for is the pipeline (compressed / "
            "partial-participation) form; without a pipeline there is no "
            "device-resident sticky state: use chunked_round_fn_for")
    key = (spec.engine_key(), _world_key(), spec.participants_per_round(),
           data_resident)
    fn = _RESIDENT_FN_CACHE.pop(key, None)
    if fn is None:
        fn = make_resident_chunked_round(
            round_fn_for(spec), spec.aggregation_pipeline(),
            kernel_backend=spec.kernel_backend, data_resident=data_resident)
        while len(_RESIDENT_FN_CACHE) >= _ROUND_FN_CACHE_MAX:
            _RESIDENT_FN_CACHE.pop(next(iter(_RESIDENT_FN_CACHE)))
    _RESIDENT_FN_CACHE[key] = fn   # (re)insert at MRU position
    return fn


_UNREGISTERED = {"auto"}
assert set(ENGINES) - _UNREGISTERED == set(_REGISTRY), \
    "built-in engines drifted"
