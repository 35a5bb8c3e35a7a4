"""The aggregation pipeline: the Eq.-7b round boundary with partial
participation, compressed updates and error feedback.

* **Partial participation.** A fixed-size set of clients, sampled anew
  every round, uploads. The server averages over the participants and
  re-broadcasts; the non-participants' local work is discarded, so they
  spend no privacy.
* **Compressed communication.** Each participant's model update (its delta
  from the round-start global model) goes through a lossy
  :class:`Compressor` before the average. What the compressor drops is kept
  in a per-client error-feedback residual (``FLState.residual``, (C, D)
  f32) and added to the next update the client sends.

Compressors act on the client-stacked block of flat updates, (C, D) f32,
leaves laid end to end in ``jax.tree.flatten`` order:

``topk``   keep the ``ratio * d`` largest-|coordinate| entries of each row.
``randk``  keep ``ratio * d`` uniformly sampled coordinates per row
           (unscaled; the residual corrects the bias).
``qsgd``   stochastic uniform quantization to ``bits`` bits per coordinate,
           one ``quantize_decompress`` kernel call on all C rows.

The randomness a compressor needs is an operand of the round (``agg_rand``:
(C, D) uniforms for qsgd, (C, k) int64 indices for randk, ``None`` for
topk), drawn by :meth:`Compressor.draw` from the federation's generator, so
the tests can feed the JAX package's draws. The wire is simulated in dense
tensors; what it would carry is ``FederationSpec.comm_scale()`` (Eq. 8
charges ``c1 * wire_ratio * q`` per aggregation).

Non-participants are compressed too (their result is discarded), as the
JAX package vmaps the compressor over all C clients.

The trust plane plugs in as three optional fields of the pipeline, each off
by default: ``attack`` (:class:`repro_torch.core.robust.UpdateAttack`, the
byzantine clients' corruption of what they send), ``secure``
(:class:`repro_torch.core.secureagg.SecureMaskedSum`, the masked modular
sum in place of the plain one) and ``aggregator`` (a
:mod:`repro_torch.core.robust` reduction of the participant rows in place
of their mean). With ``secure`` set, ``agg_rand`` is the pair
``(compressor operand, (C, C, D) pair masks)``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Protocol

import torch

from repro_torch.core.robust import participant_rows
from repro_torch.kernels.ops import quantize_decompress_rows
from repro_torch.utils.tree import (
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

COMPRESSORS = ("none", "topk", "randk", "qsgd")


# ---------------------------------------------------------------------------
# flat <-> pytree plumbing (compressors act on one flat row per client)
# ---------------------------------------------------------------------------

def flatten_tree(tree) -> torch.Tensor:
    """Client-stacked pytree (every leaf (R, ...)) -> (R, D) f32 rows."""
    leaves = tree_leaves(tree)
    rows = leaves[0].shape[0]
    return torch.cat([x.reshape(rows, -1).to(torch.float32) for x in leaves],
                     dim=1)


def unflatten_like(flat: torch.Tensor, tree):
    """Inverse of :func:`flatten_tree` given the client-stacked structure
    donor ``tree``: each leaf gets its shape and dtype back."""
    leaves, treedef = tree_flatten(tree)
    out, off = [], 0
    for x in leaves:
        n = x[0].numel()
        out.append(flat[:, off:off + n].reshape(x.shape).to(x.dtype))
        off += n
    return tree_unflatten(treedef, out)


def tree_dim(tree) -> int:
    """D: the number of parameters of a single-replica pytree."""
    return sum(x.numel() for x in tree_leaves(tree))


# ---------------------------------------------------------------------------
# compressors
# ---------------------------------------------------------------------------

class Compressor(Protocol):
    """Lossy update codec on (C, D) f32 rows -> their dense decompressed
    image. ``draw`` makes the random operand the codec consumes (or
    ``None``); ``wire_ratio`` is the fraction of the dense f32 bytes the
    compressed form would occupy on the wire (index overhead ignored)."""

    def __call__(self, rows: torch.Tensor, agg_rand) -> torch.Tensor: ...

    def draw(self, gen: torch.Generator, n_rows: int, d: int,
             device) -> torch.Tensor | None: ...

    def wire_ratio(self) -> float: ...


def validate_compression(name: str, ratio: float = 0.1,
                         bits: int = 8) -> None:
    """The compressor knobs' invariants (spec and factory)."""
    if name not in COMPRESSORS:
        raise ValueError(f"compressor must be one of {COMPRESSORS}, "
                         f"got {name!r}")
    if not 0.0 < ratio <= 1.0:
        raise ValueError(f"compression_ratio must be in (0, 1], got {ratio}")
    if not 1 <= bits <= 16:
        raise ValueError(f"compression_bits must be in [1, 16], got {bits}")


def compression_wire_ratio(name: str, ratio: float = 0.1,
                           bits: int = 8) -> float:
    """Compressed-update bytes as a fraction of the dense f32 update
    (topk/randk: the kept fraction; qsgd: bits/32; none: 1)."""
    validate_compression(name, ratio, bits)
    if name in ("topk", "randk"):
        return ratio
    if name == "qsgd":
        return bits / 32.0
    return 1.0


def _keep_k(ratio: float, d: int) -> int:
    return max(1, min(d, int(round(ratio * d))))


def _keep(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Zeros except at ``idx`` (R, k), where ``rows`` is kept."""
    return torch.zeros_like(rows).scatter_(1, idx, rows.gather(1, idx))


@dataclass(frozen=True)
class TopK:
    """Keep the ``ratio * d`` largest-magnitude coordinates of each row."""
    ratio: float

    def __call__(self, rows, agg_rand):
        del agg_rand
        k = _keep_k(self.ratio, rows.shape[1])
        _, idx = torch.topk(torch.abs(rows), k, dim=1)
        return _keep(rows, idx)

    def draw(self, gen, n_rows, d, device):
        return None

    def wire_ratio(self) -> float:
        return compression_wire_ratio("topk", ratio=self.ratio)


@dataclass(frozen=True)
class RandK:
    """Keep ``ratio * d`` uniformly sampled coordinates of each row (fresh
    each round), unscaled: the error-feedback residual re-sends what the
    sampling dropped."""
    ratio: float

    def __call__(self, rows, agg_rand):
        return _keep(rows, agg_rand)

    def draw(self, gen, n_rows, d, device):
        """(R, k) int64: the first k of a uniform permutation per row."""
        u = torch.rand((n_rows, d), generator=gen, device=device)
        return torch.argsort(u, dim=1)[:, :_keep_k(self.ratio, d)]

    def wire_ratio(self) -> float:
        return compression_wire_ratio("randk", ratio=self.ratio)


@dataclass(frozen=True)
class QSGD:
    """Stochastic uniform quantization to ``bits`` bits per coordinate: one
    ``quantize_decompress`` kernel call on all rows; ``agg_rand`` is the
    (R, D) U[0, 1) stochastic-rounding operand."""
    bits: int
    kernel_backend: str = "auto"

    def __call__(self, rows, agg_rand):
        y, _ = quantize_decompress_rows(rows, agg_rand, self.bits,
                                        backend=self.kernel_backend)
        return y

    def draw(self, gen, n_rows, d, device):
        return torch.rand((n_rows, d), generator=gen, device=device)

    def wire_ratio(self) -> float:
        return compression_wire_ratio("qsgd", bits=self.bits)


def make_compressor(name: str, ratio: float = 0.1, bits: int = 8,
                    kernel_backend: str = "auto") -> Compressor | None:
    """A compressor by spec name; ``"none"`` -> None."""
    validate_compression(name, ratio, bits)
    if name == "none":
        return None
    if name == "topk":
        return TopK(ratio)
    if name == "randk":
        return RandK(ratio)
    return QSGD(bits, kernel_backend)


# ---------------------------------------------------------------------------
# participation
# ---------------------------------------------------------------------------

def participation_mask(gen: torch.Generator, n_clients: int,
                       n_participants: int, device) -> torch.Tensor:
    """0/1 f32 (C,) mask with exactly ``n_participants`` ones, sampled
    uniformly without replacement from ``gen``. Fixed-size sampling keeps
    the aggregation denominator static."""
    u = torch.rand((n_clients,), generator=gen, device=device)
    idx = torch.argsort(u)[:n_participants]
    return torch.zeros((n_clients,), dtype=torch.float32,
                       device=device).index_fill_(0, idx, 1.0)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _bcast_rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (x.dim() - 1))


@dataclass(frozen=True)
class AggregationPipeline:
    """The Eq.-7b round boundary with participation masking, compression
    and error feedback, and the trust plane's attack, secure sum and robust
    aggregator. One instance per FederationSpec."""
    n_clients: int
    compressor: Compressor | None       # None -> dense updates
    average_opt_state: bool = True
    aggregator: Any = None              # robust (P, D) -> (D,) reduction
    secure: Any = None                  # SecureMaskedSum | None
    attack: Any = None                  # UpdateAttack | None
    n_participants: int | None = None   # static P (robust row gather)

    def needs_residual(self) -> bool:
        return self.compressor is not None

    def init_residual(self, params0) -> torch.Tensor | None:
        """(C, D) zero error-feedback residual on ``params0``'s device, or
        None without a compressor. ``params0`` is the single-replica init."""
        if not self.needs_residual():
            return None
        return torch.zeros((self.n_clients, tree_dim(params0)),
                           dtype=torch.float32,
                           device=tree_leaves(params0)[0].device)

    def aggregate(self, prev_params, new_params, new_opt_state,
                  prev_opt_state, residual, mask, agg_rand):
        """Replace the dense mean of Eq. 7b.

        prev/new params and opt_state are client-stacked pytrees (C, ...);
        ``residual`` is (C, D) or None; ``mask`` the 0/1 (C,) participation
        mask; ``agg_rand`` the compressor's random operand (paired with the
        pair masks under ``secure``). Returns ``(params, opt_state,
        residual)``: the participants' (compressed, error-fed) updates
        averaged into the global model, re-broadcast to every client.
        Non-participants keep their residual; their optimizer state is kept
        when ``average_opt_state=False`` and, like every client's, replaced
        by the participants' mean when True. The attack corrupts what is
        sent, never the residual; the secure sum and the robust
        aggregators reduce the model update only, the optimizer state keeps
        the masked mean."""
        denom = torch.sum(mask)                 # >= 1 by the spec
        if self.secure is not None:
            agg_rand, pair_masks = agg_rand

        def _masked_mean_bcast(new):
            s = torch.sum(_bcast_rows(mask, new) * new.to(torch.float32),
                          dim=0)
            avg = (s / denom).to(new.dtype)
            return avg.unsqueeze(0).expand(new.shape).contiguous()

        adversarial = (self.aggregator is not None or self.secure is not None
                       or self.attack is not None)
        if self.compressor is not None or adversarial:
            flat_prev = flatten_tree(prev_params)          # (C, D)
            sel = mask[:, None]
            if self.compressor is not None:
                corrected = (flatten_tree(new_params) - flat_prev) + residual
                sent = self.compressor(corrected, agg_rand)
                residual = sel * (corrected - sent) + (1.0 - sel) * residual
            else:
                sent = flatten_tree(new_params) - flat_prev
            if self.attack is not None:
                sent = self.attack(sent)
            if self.secure is not None:
                avg_delta = self.secure.masked_mean(sent, mask, pair_masks)
            elif self.aggregator is not None:
                avg_delta = self.aggregator(participant_rows(
                    sent, mask, self.n_participants))
            else:
                avg_delta = torch.sum(sel * sent, dim=0) / denom
            # prev params are synchronized (full_average every round), so
            # replica 0 anchors the new global model
            new_global = (flat_prev[0] + avg_delta).unsqueeze(0)
            params = unflatten_like(
                new_global.expand(self.n_clients, -1), prev_params)
            params = tree_map(torch.Tensor.contiguous, params)
        else:
            # dense updates against a synchronized global model: the masked
            # mean of the participants' replicas is the new global model
            params = tree_map(_masked_mean_bcast, new_params)

        if self.average_opt_state:
            opt_state = tree_map(_masked_mean_bcast, new_opt_state)
        else:
            # non-participants did not really train: keep their old state
            def _mask_leaf(new, old):
                m = _bcast_rows(mask, new)
                return (m * new.to(torch.float32)
                        + (1.0 - m) * old.to(torch.float32)).to(new.dtype)
            opt_state = tree_map(_mask_leaf, new_opt_state, prev_opt_state)
        return params, opt_state, residual

    def masked_metrics(self, metrics: dict[str, Any], mask) -> dict:
        """Mean of per-client (C,) metrics over the participants only."""
        denom = torch.sum(mask)
        return {k: torch.sum(mask * v) / denom for k, v in metrics.items()}
