"""Round engines.

A *round engine* turns a :class:`FederationSpec` into the round function

    round_fn(params, opt_state, batch, noise, sigmas)
        -> (new_params, new_opt_state, metrics)

with params/opt_state carrying a leading client axis C, batch leaves shaped
(C, tau, B, ...), ``noise`` the round's (C, tau, N) standard normals and
sigmas (C,). A spec with an aggregation pipeline gets the pipeline round,

    round_fn(params, opt_state, batch, noise, sigmas, mask, residual,
             agg_rand) -> (new_params, new_opt_state, new_residual, metrics)

(see :func:`repro_torch.core.fl.make_round_step`). Two engines ship:

    "vmap"  all C clients as one batch: one dp_clip_noise call per step
    "map"   the same math one client at a time (one row per kernel call)

``engine="auto"`` resolves to "vmap" (one device), never to
"async_buffered": the buffered-async engine has no synchronous round
function and is driven by :mod:`repro_torch.asyncfl`. Every engine's Eq.-7a
clip + noise runs through the ``dp_clip_noise`` kernel, and the qsgd
compressor through ``quantize_decompress``, on the spec's
``kernel_backend``. Round functions are cached per ``spec.engine_key()``.
The population plane's resident chunk
(:func:`resident_chunked_round_fn_for`) moves cohort rows through the
``cohort_gather_scatter`` kernel.
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.api.spec import FederationSpec
from repro_torch.core.fl import (
    make_chunked_round,
    make_resident_chunked_round,
    make_round_step,
)

RoundFn = Callable[..., tuple[Any, Any, dict]]
_PORTED = ("vmap", "map", "async_buffered")


def resolve_engine(spec: FederationSpec) -> str:
    """Map ``engine="auto"`` to a concrete engine: "vmap" on one device.
    "async_buffered" resolves only by name."""
    name = "vmap" if spec.engine == "auto" else spec.engine
    if name not in _PORTED:
        raise ValueError(f"unknown engine {name!r}; ported: {_PORTED}")
    return name


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
        fn = make_round_step(
            spec.loss_fn, spec.optimizer,
            spec.fl_config(vmap_clients=resolve_engine(spec) == "vmap"),
            topology=spec.topology, pipeline=spec.aggregation_pipeline())
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
