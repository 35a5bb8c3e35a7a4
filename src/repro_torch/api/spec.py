"""Declarative configuration of one DP-PASGD federation.

:class:`FederationSpec` has the JAX package's fields and validation. The
port runs the resident protocol, dense or through the aggregation pipeline
(partial participation, compressed error-fed updates, robust aggregators,
secure masked sums with central accounting, byzantine update attacks), and
cohorts of K drawn from a virtual population of M (``population=M``, driven
by :mod:`repro_torch.population`), on the ``vmap`` and ``map`` engines,
on the sharded ``shard_map`` and ``mesh_2d`` engines (the client axis over
the ranks of a ``torch.distributed`` world), and buffered-async federation
(``engine="async_buffered"``, driven by :mod:`repro_torch.asyncfl`). A
part of the JAX package the port does not have yet (a mesh_2d model axis
over 1) raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from repro_torch.core.aggregation import (
    COMPRESSORS,
    AggregationPipeline,
    compression_wire_ratio,
    make_compressor,
    validate_compression,
)
from repro_torch.core.fl import TOPOLOGIES, Budgets, FLConfig, design_sigmas
from repro_torch.core.privacy import composed_subsampling_q
from repro_torch.core.robust import (
    byzantine_flags,
    make_aggregator,
    make_attack,
    validate_aggregator,
    validate_attack,
)
from repro_torch.core.secureagg import (
    SecureMaskedSum,
    central_rho_scale,
    validate_secure,
)
from repro_torch.kernels.ops import validate_backend
from repro_torch.optim.optimizers import Optimizer

ENGINES = ("vmap", "map", "shard_map", "mesh_2d", "async_buffered", "auto")


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"(ROADMAP queue 1 {item})")


@dataclass(frozen=True)
class FederationSpec:
    """Everything needed to run DP-PASGD, in one frozen declarative object.

    ``loss_fn`` and ``optimizer`` are the only non-serializable fields; the
    model plugs in through them. See the JAX package's ``FederationSpec``
    for the planes behind the fields the port does not run yet.
    """
    # -- federation / round structure --------------------------------------
    n_clients: int
    tau: int                        # local steps per round (aggregation period)
    loss_fn: Callable[[Any, Any], Any]
    optimizer: Optimizer
    topology: str = "full_average"  # "full_average" | "local_only"
    engine: str = "auto"            # "vmap" | "map" | "shard_map" |
    #   "mesh_2d" | "async_buffered" | "auto" (repro_torch.mesh.placement).
    #   "async_buffered" is driven by repro_torch.asyncfl (train_async),
    #   never by run_round / train; the sharded engines split the client
    #   axis over the ranks of the torch.distributed world
    kernel_backend: str = "auto"    # "auto": the hand-written kernel on CUDA
    #   tensors, its plain version on CPU tensors | "ref": always the plain
    #   version

    # -- aggregation pipeline ----------------------------------------------
    participation: float = 1.0
    compressor: str = "none"
    compression_ratio: float = 0.1
    compression_bits: int = 8
    amplify_participation: bool = False

    # -- adversarial fleet (core/robust.py, core/secureagg.py) -------------
    aggregator: str = "mean"
    trim_fraction: float = 0.1
    norm_bound_factor: float = 3.0
    secure_agg: bool = False
    secure_frac_bits: int = 16
    dp_accounting: str = "local"
    attack: str = "none"
    byzantine_fraction: float = 0.0
    attack_scale: float = 10.0

    # -- virtual client population (repro_torch.population) ---------------
    population: int | None = None   # M virtual clients; n_clients is then
    #   the per-round cohort K. Not part of engine_key(): sweeping M reuses
    #   the round function, and the device block holds K replicas
    cohort_size: int | None = None  # K (defaults to n_clients; must equal it)

    # -- 2D mesh plane (repro_torch.mesh; engine="mesh_2d" or "auto") -----
    mesh_shape: tuple[int, int] | None = None  # (dc, dm) client blocks x
    #   model shards over the ranks; None -> mesh.placement
    #   .default_mesh_shape. dm > 1 splits each replica over a slab's
    #   ranks. Part of engine_key()
    sharding_rules: Any = None      # logical->mesh axis overrides (dict or
    #   (name, axis) pairs, normalized to a sorted tuple of pairs) for the
    #   model axis' placement; None -> models.sharding.mesh2d_rules()
    replica_bytes: int | None = None  # per-replica params + opt-state
    #   footprint hint: engine="auto" places a replica over the per-device
    #   budget on mesh_2d

    # -- buffered-async federation (repro_torch.asyncfl) ------------------
    buffer_size: int | None = None  # B arrivals per flush (n_clients default)
    staleness_alpha: float = 0.0    # w(s) = 1 / (1 + s)^alpha

    # -- DP mechanism (Eq. 7a) ---------------------------------------------
    dp: bool = True
    clip_norm: float = 1.0          # G (sensitivity bound)
    num_microbatches: int = 1
    vmap_microbatches: bool = True
    grad_accumulate: str = "stack"  # "stack" | "scan"
    average_opt_state: bool = True

    # -- privacy accounting (§5.2) -----------------------------------------
    sigmas: tuple[float, ...] | None = None  # per-client σ; None -> design
    batch_sizes: tuple[int, ...] = ()        # X_m per client; () -> all 1
    eps_th: float = math.inf
    delta: float = 1e-4
    total_steps: int | None = None  # planned K for auto sigma design (Eq. 23)

    # -- resource budget (Eq. 8) -------------------------------------------
    c_th: float = math.inf
    c1: float = 100.0               # comm cost per aggregation
    c2: float = 1.0                 # compute cost per local step

    seed: int = 0

    def __post_init__(self):
        self._validate()

    def _validate(self):
        """The JAX package's validation, check for check."""
        if self.n_clients <= 0:
            raise ValueError(f"n_clients must be positive, got {self.n_clients}")
        if self.tau <= 0:
            raise ValueError(f"tau must be positive, got {self.tau}")
        if self.topology not in TOPOLOGIES:
            raise ValueError(f"topology must be one of {TOPOLOGIES}, "
                             f"got {self.topology!r}")
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, "
                             f"got {self.engine!r}")
        validate_backend(self.kernel_backend)
        validate_compression(self.compressor, self.compression_ratio,
                             self.compression_bits)
        if isinstance(self.participation, bool) or not (
                isinstance(self.participation, (int, float))):
            raise ValueError(f"participation must be a fraction in (0, 1] or "
                             f"an int count, got {self.participation!r}")
        if isinstance(self.participation, int):
            if not 1 <= self.participation <= self.n_clients:
                raise ValueError(
                    f"participation count must be in [1, {self.n_clients}], "
                    f"got {self.participation}")
        elif not 0.0 < self.participation <= 1.0:
            raise ValueError(f"participation fraction must be in (0, 1], "
                             f"got {self.participation}")
        validate_aggregator(self.aggregator, self.trim_fraction,
                            self.norm_bound_factor)
        validate_attack(self.attack, self.byzantine_fraction,
                        self.attack_scale)
        validate_secure(self.secure_frac_bits)
        if self.secure_agg and self.aggregator != "mean":
            raise ValueError("secure_agg only composes with aggregator='mean'")
        if self.dp_accounting not in ("local", "central"):
            raise ValueError(f"dp_accounting must be 'local' or 'central', "
                             f"got {self.dp_accounting!r}")
        if self.dp_accounting == "central" and not self.secure_agg:
            raise ValueError("dp_accounting='central' requires "
                             "secure_agg=True")
        if self.attack != "none" and self.population is not None:
            raise ValueError("update attacks bind a static byzantine set to "
                             "resident client identities; not with a "
                             "population")
        if self.is_adversarial() and self.engine == "async_buffered":
            raise ValueError("robust aggregators, secure_agg and update "
                             "attacks are sync-engine features")
        if self.has_pipeline() and self.topology != "full_average":
            raise ValueError(
                "participation/compression/robust-secure aggregation shape "
                "the Eq.-7b aggregation and require "
                "topology='full_average' (local_only never communicates)")
        if self.engine == "async_buffered":
            if self.population is not None:
                raise ValueError("engine='async_buffered' does not compose "
                                 "with population mode")
            if self.topology != "full_average":
                raise ValueError("engine='async_buffered' requires "
                                 "topology='full_average'")
            if self.buffer_size is None:
                object.__setattr__(self, "buffer_size", self.n_clients)
            if not 1 <= self.buffer_size <= self.n_clients:
                raise ValueError(f"buffer_size must be in "
                                 f"[1, {self.n_clients}], "
                                 f"got {self.buffer_size}")
        else:
            if self.buffer_size is not None:
                raise ValueError("buffer_size only applies to "
                                 "engine='async_buffered'")
            if self.staleness_alpha != 0.0:
                raise ValueError("staleness_alpha only applies to "
                                 "engine='async_buffered'")
        if self.staleness_alpha < 0.0:
            raise ValueError(f"staleness_alpha must be >= 0, "
                             f"got {self.staleness_alpha}")
        if self.engine not in ("mesh_2d", "auto"):
            if self.mesh_shape is not None:
                raise ValueError("mesh_shape only applies to "
                                 "engine='mesh_2d' (or 'auto')")
            if self.sharding_rules is not None:
                raise ValueError("sharding_rules only apply to "
                                 "engine='mesh_2d' (or 'auto')")
        if self.mesh_shape is not None:
            ms = tuple(int(x) for x in self.mesh_shape)
            if len(ms) != 2 or ms[0] < 1 or ms[1] < 1:
                raise ValueError(f"mesh_shape must be two positive ints "
                                 f"(dc, dm), got {self.mesh_shape!r}")
            object.__setattr__(self, "mesh_shape", ms)
        if self.sharding_rules is not None:
            items = (self.sharding_rules.items()
                     if isinstance(self.sharding_rules, dict)
                     else self.sharding_rules)
            object.__setattr__(self, "sharding_rules", tuple(sorted(
                (str(k), tuple(v) if isinstance(v, (list, tuple)) else v)
                for k, v in items)))
        if self.replica_bytes is not None:
            if int(self.replica_bytes) <= 0:
                raise ValueError(f"replica_bytes must be positive, "
                                 f"got {self.replica_bytes}")
            object.__setattr__(self, "replica_bytes", int(self.replica_bytes))
        if self.engine == "mesh_2d" and self.is_adversarial():
            raise ValueError("engine='mesh_2d' does not support the "
                             "adversarial extensions")
        if self.cohort_size is not None and self.population is None:
            raise ValueError("cohort_size only makes sense with a "
                             "population (FederationSpec(population=M))")
        if self.population is not None:
            if self.cohort_size is None:
                object.__setattr__(self, "cohort_size", self.n_clients)
            if self.cohort_size != self.n_clients:
                raise ValueError(f"cohort_size ({self.cohort_size}) must "
                                 f"equal n_clients ({self.n_clients})")
            if self.population < self.n_clients:
                raise ValueError(f"population ({self.population}) must be "
                                 f">= cohort size ({self.n_clients})")
            if self.topology != "full_average":
                raise ValueError("cohort execution requires "
                                 "topology='full_average'")
            if self.batch_sizes and len(set(self.batch_sizes)) > 1:
                raise ValueError("population mode needs uniform batch_sizes")
            if self.sigmas is not None and len(set(self.sigmas)) > 1:
                raise ValueError("population mode needs uniform sigmas")
        # normalize sequences to hashable tuples
        if self.sigmas is not None:
            object.__setattr__(self, "sigmas",
                               tuple(float(s) for s in np.asarray(self.sigmas)))
            if len(self.sigmas) != self.n_clients:
                raise ValueError(f"sigmas has {len(self.sigmas)} entries for "
                                 f"{self.n_clients} clients")
        if self.batch_sizes:
            object.__setattr__(self, "batch_sizes",
                               tuple(int(x) for x in self.batch_sizes))
            if len(self.batch_sizes) != self.n_clients:
                raise ValueError(
                    f"batch_sizes has {len(self.batch_sizes)} entries for "
                    f"{self.n_clients} clients")

    # -- derived views ------------------------------------------------------
    def replace(self, **changes) -> "FederationSpec":
        return dataclasses.replace(self, **changes)

    def fl_config(self, vmap_clients: bool = True) -> FLConfig:
        """The engine-level FLConfig view of this spec."""
        return FLConfig(
            n_clients=self.n_clients, tau=self.tau, clip_norm=self.clip_norm,
            dp=self.dp, num_microbatches=self.num_microbatches,
            vmap_microbatches=self.vmap_microbatches,
            grad_accumulate=self.grad_accumulate,
            average_opt_state=self.average_opt_state,
            vmap_clients=vmap_clients,
            kernel_backend=self.kernel_backend)

    def budgets(self) -> Budgets:
        return Budgets(c_th=self.c_th, eps_th=self.eps_th,
                       c1=self.c1, c2=self.c2)

    def participants_per_round(self) -> int:
        """The fixed per-round participant count (fraction q rounded to a
        count, floored at one client)."""
        if isinstance(self.participation, int):
            return self.participation
        return max(1, min(self.n_clients,
                          round(self.participation * self.n_clients)))

    def participation_fraction(self) -> float:
        """Realized q = participants / n_clients (drives amplification)."""
        return self.participants_per_round() / self.n_clients

    def is_async(self) -> bool:
        """Buffered-async execution (:mod:`repro_torch.asyncfl` drivers)."""
        return self.engine == "async_buffered"

    def resolved_buffer_size(self) -> int:
        """B, the arrivals aggregated per flush (n_clients unless set)."""
        if self.buffer_size is not None:
            return self.buffer_size
        return self.n_clients

    def is_population(self) -> bool:
        """Cohort execution: n_clients is a per-round cohort of K drawn from
        ``population`` virtual clients (:mod:`repro_torch.population`)."""
        return self.population is not None

    def cohort_fraction(self) -> float:
        """K/M, the cohort subsampling rate over the population (1.0
        without a population, where every client is in every round)."""
        if self.population is None:
            return 1.0
        return self.n_clients / self.population

    def accounting_q(self) -> float:
        """The q the privacy ledger charges per realized step: 1.0 (the
        full Lemma-2 rho, the sound conditional ledger) by default; with
        ``amplify_participation``, the probability that a given client
        realizes a step in a round: the cohort fraction K/M times the
        within-cohort participation fraction. Under
        ``dp_accounting="central"`` the charge also scales by
        :func:`~repro_torch.core.secureagg.central_rho_scale` (1/P for the
        P pooled participant noises)."""
        q = 1.0
        if self.amplify_participation:
            q = composed_subsampling_q(self.cohort_fraction(),
                                       self.participation_fraction())
        if self.dp_accounting == "central":
            q *= central_rho_scale(self.participants_per_round())
        return q

    def wire_ratio(self) -> float:
        """Compressed-update bytes as a fraction of the dense f32 update."""
        return compression_wire_ratio(self.compressor, self.compression_ratio,
                                      self.compression_bits)

    def comm_scale(self) -> float:
        """Eq.-8 comm-cost multiplier of the pipeline: wire_ratio * q."""
        return self.wire_ratio() * self.participation_fraction()

    def is_adversarial(self) -> bool:
        """Any trust-plane feature on (robust aggregator, secure sum, update
        attack)? ``has_pipeline()`` includes them."""
        return (self.aggregator != "mean" or self.secure_agg
                or self.attack != "none")

    def resolved_byzantine_flags(self) -> tuple[int, ...] | None:
        """The static 0/1 byzantine membership over the C resident clients
        (None without an attack), deterministic per (seed, fraction)."""
        if self.attack == "none":
            return None
        return byzantine_flags(self.n_clients, self.byzantine_fraction,
                               self.seed)

    def has_pipeline(self) -> bool:
        """Does this spec leave the all-clients/dense-mean protocol?"""
        return (self.compressor != "none"
                or self.participants_per_round() < self.n_clients
                or self.is_adversarial())

    def aggregation_pipeline(self) -> AggregationPipeline | None:
        """The AggregationPipeline of this spec, or None for the dense
        full-participation protocol."""
        if not self.has_pipeline():
            return None
        flags = self.resolved_byzantine_flags()
        return AggregationPipeline(
            n_clients=self.n_clients,
            compressor=make_compressor(self.compressor, self.compression_ratio,
                                       self.compression_bits,
                                       self.kernel_backend),
            average_opt_state=self.average_opt_state,
            aggregator=make_aggregator(self.aggregator, self.trim_fraction,
                                       self.norm_bound_factor),
            secure=(SecureMaskedSum(self.n_clients, self.secure_frac_bits)
                    if self.secure_agg else None),
            attack=(make_attack(self.attack, flags, self.attack_scale)
                    if flags is not None else None),
            n_participants=self.participants_per_round())

    def round_cost(self) -> float:
        """Eq. (8) per round: c1 * comm_scale + c2 * tau; the pipeline
        scales only the communication term."""
        return self.c1 * self.comm_scale() + self.c2 * self.tau

    def resolved_batch_sizes(self) -> tuple[int, ...]:
        return self.batch_sizes or (1,) * self.n_clients

    def resolved_sigmas(self) -> np.ndarray:
        """Per-client noise std (f32): explicit > auto-designed (Eq. 23) >
        zero. Auto design needs a finite ``eps_th`` and a planned
        ``total_steps`` (the K of Eq. 23)."""
        if self.sigmas is not None:
            return np.asarray(self.sigmas, np.float32)
        if not self.dp:
            return np.zeros((self.n_clients,), np.float32)
        if not math.isfinite(self.eps_th) or self.total_steps is None:
            raise ValueError(
                "FederationSpec needs explicit sigmas, or a finite eps_th "
                "plus total_steps so Eq. 23 can design them")
        return design_sigmas(self.total_steps, self.clip_norm,
                             list(self.resolved_batch_sizes()),
                             self.eps_th, self.delta)

    def ledger_key(self) -> tuple:
        """Hash key of everything that shapes the privacy ledger's per-step
        charges and the sigma vector (memoized on the frozen instance)."""
        cached = self.__dict__.get("_ledger_key")
        if cached is None:
            cached = (self.clip_norm, self.dp,
                      tuple(float(s) for s in self.resolved_sigmas()),
                      self.resolved_batch_sizes())
            object.__setattr__(self, "_ledger_key", cached)
        return cached

    def engine_key(self) -> tuple:
        """Hash key of everything that shapes the round function. Budget and
        accounting fields are excluded, so budget edits reuse the cached
        round. Participation enters only as ``has_pipeline()``: the
        participant count is a runtime operand (the mask), except under a
        robust aggregator, whose row gather takes the static P, so P joins
        the key exactly when ``aggregator != "mean"``. ``dp_accounting``
        is accounting-only and stays out; the byzantine flags are in (the
        attack's select is built from them). The async buffer size B shapes
        the flush and dispatch blocks and is in; ``staleness_alpha`` is a
        runtime weight and stays out. The mesh shape and the replica hint
        are in, and so are the sharding rules (the model axis' placement),
        as in the JAX package."""
        return (self.loss_fn, self.optimizer, self.n_clients, self.tau,
                self.clip_norm, self.dp, self.num_microbatches,
                self.vmap_microbatches, self.grad_accumulate,
                self.average_opt_state, self.topology, self.engine,
                self.kernel_backend, self.has_pipeline(), self.compressor,
                self.compression_ratio, self.compression_bits,
                self.buffer_size,
                # the mesh shape is the round's collective layout;
                # replica_bytes steers what engine="auto" resolves to
                self.mesh_shape, self.sharding_rules, self.replica_bytes,
                self.aggregator, self.trim_fraction,
                self.norm_bound_factor,
                (self.participants_per_round()
                 if self.aggregator != "mean" else None),
                self.secure_agg, self.secure_frac_bits,
                self.attack, self.attack_scale,
                self.resolved_byzantine_flags())
