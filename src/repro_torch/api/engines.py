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

(see :func:`repro_torch.core.fl.make_round_step`). Three engines are
registered:

    "vmap"            all C clients as one batch: one dp_clip_noise call
                      per step
    "map"             the same math one client at a time (one row per
                      kernel call)
    "async_buffered"  the buffered-async executor
                      (:class:`repro_torch.asyncfl.engine.AsyncBufferedExecutor`),
                      not a round function: it is driven by
                      :mod:`repro_torch.asyncfl`

``register_engine`` adds an execution strategy without touching the
drivers, which select purely through ``FederationSpec.engine``. The JAX
package's sharded engines (``shard_map``, ``mesh_2d``) are not registered:
a spec naming them raises, naming ROADMAP queue 1 item 12.

``engine="auto"`` resolves to "vmap" (one device), never to
"async_buffered". A ``replica_bytes`` hint is read against the device's
memory (:func:`device_memory_budget`): a replica that does not fit would
need the model axis sharded (the JAX package's ``mesh_2d``), so it raises.
Every engine's Eq.-7a clip + noise runs through the ``dp_clip_noise``
kernel, and the qsgd compressor through ``quantize_decompress``, on the
spec's ``kernel_backend``. Round functions are cached per
``spec.engine_key()``. The population plane's resident chunk
(:func:`resident_chunked_round_fn_for`) moves cohort rows through the
``cohort_gather_scatter`` kernel.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Protocol

from repro_torch.api.spec import ENGINES, FederationSpec, _not_ported
from repro_torch.core.fl import (
    make_chunked_round,
    make_resident_chunked_round,
    make_round_step,
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


# -- placement (copies of the JAX package's repro/mesh/placement.py) --------

ENV_DEVICE_MEM = "REPRO_DEVICE_MEM_BYTES"
# an H100 80GB HBM3's memory as torch reports it (79.18 GiB): the budget
# where no card is present to ask
H100_MEM_BYTES = 85_017_493_504


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
    return H100_MEM_BYTES


def replica_fits(replica_bytes: int, hbm_bytes: int | None = None) -> bool:
    """Does one whole model replica (+ optimizer state) fit one device?"""
    return int(replica_bytes) <= device_memory_budget(hbm_bytes)


def resolve_engine(spec: FederationSpec) -> str:
    """Map ``engine="auto"`` to a concrete engine: "vmap" on one device
    when the spec's ``replica_bytes`` hint (if any) fits the device's
    memory; a hint over it raises (the model axis would have to shard:
    item 12). "async_buffered" resolves only by name."""
    if spec.engine != "auto":
        return spec.engine
    if spec.replica_bytes is not None and not replica_fits(
            spec.replica_bytes):
        raise _not_ported(
            f"a replica of {spec.replica_bytes:,} bytes over the device "
            f"budget of {device_memory_budget():,} (engine='auto' would "
            f"place it on the sharded mesh_2d engine)", "item 12")
    return "vmap"


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


@register_engine("async_buffered")
def build_async_engine(spec: FederationSpec):
    """The spec's :class:`repro_torch.asyncfl.engine.AsyncBufferedExecutor`:
    a flush / dispatch executor, NOT a ``round_fn`` (``round_fn_for``
    refuses async specs). Imported lazily: asyncfl builds on
    repro_torch.api."""
    from repro_torch.asyncfl.engine import AsyncBufferedExecutor
    return AsyncBufferedExecutor(spec)


# round functions keyed on the engine-relevant slice of the spec, so budget
# edits (spec.replace(eps_th=...)) reuse the built round. Bounded: the keys
# hold loss/optimizer closures.
_ROUND_FN_CACHE: dict[tuple, RoundFn] = {}
_ROUND_FN_CACHE_MAX = 32


def round_fn_for(spec: FederationSpec) -> RoundFn:
    """The round function for ``spec`` (cached per engine key)."""
    if spec.is_async():
        raise ValueError(
            "engine='async_buffered' has no synchronous round function: "
            "drive it with repro_torch.asyncfl (init_async_state / "
            "run_async_cycle / train_async), not run_round/run_rounds")
    key = spec.engine_key()
    fn = _ROUND_FN_CACHE.pop(key, None)
    if fn is None:
        fn = get_engine(spec)(spec)
        while len(_ROUND_FN_CACHE) >= _ROUND_FN_CACHE_MAX:
            _ROUND_FN_CACHE.pop(next(iter(_ROUND_FN_CACHE)))
    _ROUND_FN_CACHE[key] = fn      # (re)insert at MRU position
    return fn


def chunked_round_fn_for(spec: FederationSpec) -> RoundFn:
    """The R-round chunk function for ``spec``: the engine's round wrapped
    by :func:`repro_torch.core.fl.make_chunked_round` (a plain loop; the
    pipeline form draws each round's mask inside it)."""
    if spec.is_async():
        raise ValueError(
            "engine='async_buffered' has no fused sync chunk: drive it with "
            "repro_torch.asyncfl.train_async (its chunking is host-paced "
            "over the simulated event schedule)")
    return make_chunked_round(round_fn_for(spec),
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
    key = (spec.engine_key(), spec.participants_per_round(), data_resident)
    fn = _RESIDENT_FN_CACHE.pop(key, None)
    if fn is None:
        fn = make_resident_chunked_round(
            round_fn_for(spec), spec.aggregation_pipeline(),
            kernel_backend=spec.kernel_backend, data_resident=data_resident)
        while len(_RESIDENT_FN_CACHE) >= _ROUND_FN_CACHE_MAX:
            _RESIDENT_FN_CACHE.pop(next(iter(_RESIDENT_FN_CACHE)))
    _RESIDENT_FN_CACHE[key] = fn   # (re)insert at MRU position
    return fn


_UNREGISTERED = {"shard_map", "mesh_2d", "auto"}
assert set(ENGINES) - _UNREGISTERED == set(_REGISTRY), \
    "built-in engines drifted"
