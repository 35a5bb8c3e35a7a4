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
topk), drawn by :meth:`Compressor.draw` from the federation's counter-based
generator (:mod:`repro_torch.kernels.counter_rng`, purpose ``AGG_RAND``;
row r is client r's, whatever block of rows is drawn), so the tests can
feed the JAX package's draws. The wire is simulated in dense
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
from typing import Any, Callable, Protocol

import torch

from repro_torch.core.robust import participant_rows
from repro_torch.kernels.counter_rng import AGG_RAND, MASK, whole_table
from repro_torch.kernels.ops import counter_draw, quantize_decompress_rows
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
    ``None``) for the clients ``rows`` (their global row ids) from the key
    ``(seed, counter)``; ``wire_ratio`` is the fraction of the dense f32
    bytes the compressed form would occupy on the wire (index overhead
    ignored)."""

    def __call__(self, rows: torch.Tensor, agg_rand) -> torch.Tensor: ...

    def draw(self, key, rows: tuple, d: int,
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


def uniform_rows(key, rows: tuple, d: int, device) -> torch.Tensor:
    """(len(rows), d) U[0, 1) f32 of the clients ``rows``: the counter
    generator's ``AGG_RAND`` values at step 0, whole columns."""
    return counter_draw(key, tuple(rows), whole_table(d), 1, d, AGG_RAND,
                        False, device)[:, 0]


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

    def draw(self, key, rows, d, device):
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

    def draw(self, key, rows, d, device):
        """(R, k) int64: the first k of a uniform permutation per row (an
        argsort of the row's uniforms)."""
        u = uniform_rows(key, rows, d, device)
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

    def draw(self, key, rows, d, device):
        return uniform_rows(key, rows, d, device)

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

def participation_mask(key, n_clients: int, n_participants: int,
                       device) -> torch.Tensor:
    """0/1 f32 (C,) mask with exactly ``n_participants`` ones, sampled
    uniformly without replacement: the argsort of the clients' ``MASK``
    uniforms of the key ``(seed, counter)`` (client r's at row r). Every
    rank draws the whole mask. Fixed-size sampling keeps the aggregation
    denominator static."""
    u = counter_draw(key, tuple(range(n_clients)), whole_table(1), 1, 1,
                     MASK, False, device).reshape(-1)
    idx = torch.argsort(u)[:n_participants]
    return torch.zeros((n_clients,), dtype=torch.float32,
                       device=device).index_fill_(0, idx, 1.0)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _identity(x):
    return x


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

    def init_residual(self, params0,
                      n_rows: int | None = None) -> torch.Tensor | None:
        """(C, D) zero error-feedback residual on ``params0``'s device (or
        ``n_rows`` rows of it: a slab's block), or None without a
        compressor. ``params0`` is the single-replica init."""
        if not self.needs_residual():
            return None
        return torch.zeros((self.n_clients if n_rows is None else n_rows,
                            tree_dim(params0)),
                           dtype=torch.float32,
                           device=tree_leaves(params0)[0].device)

    def aggregate(self, prev_params, new_params, new_opt_state,
                  prev_opt_state, residual, mask, agg_rand, metrics,
                  all_sum: Callable[[list], list] = _identity,
                  all_gather: Callable[[Any], Any] = _identity):
        """Replace the dense mean of Eq. 7b for one block of clients.

        prev/new params and opt_state are client-stacked pytrees whose
        leading axis is the block's B rows (all C clients on the
        single-process engines, one rank's block under the sharded ones);
        ``residual`` is (B, D) or None; ``mask`` the block's 0/1 (B,)
        participation slice; ``agg_rand`` its compressor operand (paired
        with the whole (C, C, D) pair masks under ``secure``);
        ``metrics`` the block's per-client (B,) metrics. ``all_sum`` takes
        the list of the block's partial sums (the participant count, the
        masked update sums and the metrics' masked sums) and returns each
        summed over the blocks: the round's one collective under the
        sharded engines. ``all_gather`` concatenates the blocks' rows into
        the global (C, ...) view, consulted only by the adversarial
        extensions (the attack and the robust / secure reductions need
        every client's row, not block partial sums), which then compute the
        same global result on every block.

        Returns ``(params, opt_state, residual, metrics)`` over the block's
        rows: the participants' (compressed, error-fed) updates averaged
        into the global model, re-broadcast to every row, and each metric's
        mean over the participants (non-participants' local work is
        discarded, so is their loss). Non-participants keep their
        residual; their optimizer state is kept when
        ``average_opt_state=False`` and, like every client's, replaced by
        the participants' mean when True. The attack corrupts what is sent,
        never the residual; the secure sum and the robust aggregators
        reduce the model update only, the optimizer state keeps the masked
        mean."""
        block = mask.shape[0]
        if self.secure is not None:
            agg_rand, pair_masks = agg_rand

        def _masked_sum(new):
            return torch.sum(_bcast_rows(mask, new) * new.to(torch.float32),
                             dim=0)

        adversarial = (self.aggregator is not None or self.secure is not None
                       or self.attack is not None)
        flat = self.compressor is not None or adversarial
        if flat:
            flat_prev = flatten_tree(prev_params)          # (B, D)
            sel = mask[:, None]
            if self.compressor is not None:
                corrected = (flatten_tree(new_params) - flat_prev) + residual
                sent = self.compressor(corrected, agg_rand)
                residual = sel * (corrected - sent) + (1.0 - sel) * residual
            else:
                sent = flatten_tree(new_params) - flat_prev
        # the block's partial sums, summed over the blocks in one call
        p_leaves, p_def = tree_flatten(new_params)
        s_leaves, s_def = tree_flatten(new_opt_state)
        partials = [torch.sum(mask)]                        # >= 1 by the spec
        if not flat:
            partials += [_masked_sum(x) for x in p_leaves]
        elif not adversarial:
            partials.append(torch.sum(sel * sent, dim=0))
        if self.average_opt_state:
            partials += [_masked_sum(x) for x in s_leaves]
        partials += [torch.sum(mask * v) for v in metrics.values()]
        sums = iter(all_sum(partials))
        denom = next(sums)

        def _mean_bcast(new):
            avg = (next(sums) / denom).to(new.dtype)
            return avg.unsqueeze(0).expand(new.shape).contiguous()

        if flat:
            if adversarial:
                g_sent, g_mask = all_gather(sent), all_gather(mask)
                if self.attack is not None:
                    g_sent = self.attack(g_sent)
                if self.secure is not None:
                    avg_delta = self.secure.masked_mean(g_sent, g_mask,
                                                        pair_masks)
                elif self.aggregator is not None:
                    avg_delta = self.aggregator(participant_rows(
                        g_sent, g_mask, self.n_participants))
                else:
                    avg_delta = (torch.sum(g_mask[:, None] * g_sent, dim=0)
                                 / torch.sum(g_mask))
            else:
                avg_delta = next(sums) / denom
            # prev params are synchronized (full_average every round), so
            # row 0 anchors the new global model
            new_global = (flat_prev[0] + avg_delta).unsqueeze(0)
            params = unflatten_like(new_global.expand(block, -1),
                                    prev_params)
            params = tree_map(torch.Tensor.contiguous, params)
        else:
            # dense updates against a synchronized global model: the masked
            # mean of the participants' replicas is the new global model
            params = tree_unflatten(p_def, [_mean_bcast(x)
                                            for x in p_leaves])

        if self.average_opt_state:
            opt_state = tree_unflatten(s_def, [_mean_bcast(x)
                                               for x in s_leaves])
        else:
            # non-participants did not really train: keep their old state
            def _mask_leaf(new, old):
                m = _bcast_rows(mask, new)
                return (m * new.to(torch.float32)
                        + (1.0 - m) * old.to(torch.float32)).to(new.dtype)
            opt_state = tree_map(_mask_leaf, new_opt_state, prev_opt_state)
        metrics = {k: next(sums) / denom for k in metrics}
        return params, opt_state, residual, metrics
