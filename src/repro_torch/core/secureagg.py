"""Pairwise-mask secure aggregation (Bonawitz et al. 2017 style), simulated.

With secure aggregation the honest-but-curious server materializes only
the cohort SUM of the clients' noisy updates. This module holds the
arithmetic core of the pairwise-masking protocol in two forms:

* the host protocol (numpy, vid-addressed), a copy of the JAX package's
  bit for bit: updates are encoded to fixed point
  (``round(x * 2^frac_bits)`` modulo 2^32); every client pair (i, j)
  shares a per-round mask ``m_ij = -m_ji (mod 2^32)`` from
  ``default_rng((seed, TAG, lo, hi, round_idx))``; client i uploads
  ``enc(x_i) + sum_j m_ij``; the masks telescope away in the sum, and the
  masks the dropped clients leave behind are reconstructed and subtracted
  (:func:`dropout_correction`);
* :class:`SecureMaskedSum`, the pipeline plugin on (C, D) tensors. Its
  masks come from a torch generator seeded from the round's key (they
  cancel, so they need not be the JAX package's), and its mean equals the
  JAX package's ``masked_mean`` bit for bit on the same updates and mask.

torch on the CPU has no uint32 add, so the plugin works in int64 and
reduces with ``& 0xFFFFFFFF`` after each sum: the same ring, exactly.

Decoding is exact while the true survivor sum stays within
``[-2^31, 2^31) / 2^frac_bits`` per coordinate; quantization at encode time
(at most ``0.5 / 2^frac_bits`` per client and coordinate) is the only
lossy step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping

import numpy as np
import torch

_SECAGG_TAG = 0x5ECA66
MODULUS = 2 ** 32
_LOW32 = MODULUS - 1


def validate_secure(frac_bits: int) -> None:
    """The secure-aggregation knob's invariant (spec and plugin)."""
    if not 1 <= frac_bits <= 24:
        raise ValueError(f"secure_frac_bits must be in [1, 24] (above 24 "
                         f"a single encoded unit-scale update can overflow "
                         f"the 2^32 field), got {frac_bits}")


# ---------------------------------------------------------------------------
# fixed-point codec (numpy, host side)
# ---------------------------------------------------------------------------

def fp_encode(x, frac_bits: int = 16) -> np.ndarray:
    """float -> field element: ``round(x * 2^frac_bits) mod 2^32`` (uint32)."""
    q = np.round(np.asarray(x, np.float64) * (1 << frac_bits)).astype(np.int64)
    return (q % MODULUS).astype(np.uint32)


def fp_decode(u, frac_bits: int = 16) -> np.ndarray:
    """field element -> float, the upper half of the field as negatives."""
    v = np.asarray(u, np.int64)
    v = np.where(v >= MODULUS // 2, v - MODULUS, v)
    return v / float(1 << frac_bits)


def _mod_sum(terms) -> np.ndarray:
    total = None
    for t in terms:
        t = np.asarray(t, np.int64)
        total = t if total is None else (total + t) % MODULUS
    return total.astype(np.uint32)


# ---------------------------------------------------------------------------
# host-level protocol (vid-addressed)
# ---------------------------------------------------------------------------

def pairwise_mask(seed: int, vid_i: int, vid_j: int, round_idx: int,
                  dim: int) -> np.ndarray:
    """The (dim,) uint32 mask client ``vid_i`` adds for its pair with
    ``vid_j`` this round: drawn for the unordered pair and signed by the
    order, so ``pairwise_mask(i, j) + pairwise_mask(j, i) == 0 (mod 2^32)``."""
    if vid_i == vid_j:
        raise ValueError(f"a client ({vid_i}) shares no mask with itself")
    lo, hi = (vid_i, vid_j) if vid_i < vid_j else (vid_j, vid_i)
    rng = np.random.default_rng((seed, _SECAGG_TAG, lo, hi, round_idx))
    m = rng.integers(0, MODULUS, size=dim, dtype=np.uint64).astype(np.uint32)
    if vid_i == lo:
        return m
    return ((MODULUS - m.astype(np.int64)) % MODULUS).astype(np.uint32)


def masked_update(update, vid: int, cohort: Iterable[int], seed: int,
                  round_idx: int, frac_bits: int = 16) -> np.ndarray:
    """What client ``vid`` uploads: its fixed-point update plus its pair
    masks against every other cohort member."""
    validate_secure(frac_bits)
    dim = np.asarray(update).shape[-1]
    terms = [fp_encode(update, frac_bits)]
    terms += [pairwise_mask(seed, vid, int(j), round_idx, dim)
              for j in cohort if int(j) != vid]
    return _mod_sum(terms)


def dropout_correction(survivors: Iterable[int], dropped: Iterable[int],
                       seed: int, round_idx: int, dim: int) -> np.ndarray:
    """The mask residue the dropped clients leave in the survivor sum,
    ``sum_{i in survivors, j in dropped} m_ij (mod 2^32)``; zero when
    nothing dropped."""
    terms = [np.zeros((dim,), np.uint32)]
    for i in survivors:
        for j in dropped:
            terms.append(pairwise_mask(seed, int(i), int(j), round_idx, dim))
    return _mod_sum(terms)


def secure_aggregate(updates: Mapping[int, np.ndarray],
                     cohort: Iterable[int], seed: int, round_idx: int,
                     dropped: Iterable[int] = (),
                     frac_bits: int = 16) -> np.ndarray:
    """The server's view of one round: sum the survivors' masked uploads,
    subtract the dropped pairs' masks, decode. Equals
    :func:`unmasked_fixed_point_sum` of the survivors bit for bit."""
    cohort = [int(v) for v in cohort]
    dropped = {int(v) for v in dropped}
    if not set(dropped) <= set(cohort):
        raise ValueError(f"dropped clients {sorted(dropped)} must be cohort "
                         f"members {cohort}")
    survivors = [v for v in cohort if v not in dropped]
    if not survivors:
        raise ValueError("every cohort member dropped: nothing to aggregate")
    uploads = [masked_update(updates[v], v, cohort, seed, round_idx,
                             frac_bits) for v in survivors]
    dim = uploads[0].shape[-1]
    total = _mod_sum(uploads)
    corr = dropout_correction(survivors, dropped, seed, round_idx, dim)
    total = ((total.astype(np.int64) - corr.astype(np.int64)) % MODULUS)
    return fp_decode(total.astype(np.uint32), frac_bits)


def unmasked_fixed_point_sum(updates: Mapping[int, np.ndarray],
                             survivors: Iterable[int],
                             frac_bits: int = 16) -> np.ndarray:
    """The plain modular sum of the survivors' fixed-point encodings,
    decoded: what the masked protocol must reproduce exactly."""
    total = _mod_sum(fp_encode(updates[int(v)], frac_bits)
                     for v in survivors)
    return fp_decode(total, frac_bits)


def central_rho_scale(n_participants: int) -> float:
    """zCDP scale of the central (aggregate-observer) accounting: the masked
    sum pools P clients' Gaussian noises, so against an observer of the sum
    alone each per-step charge scales by 1/P. It holds against the
    aggregate observer only, and credits every participant's noise as
    honest; the local ledger (``dp_accounting="local"``) is unaffected."""
    if n_participants < 1:
        raise ValueError(f"n_participants must be >= 1, "
                         f"got {n_participants}")
    return 1.0 / n_participants


# ---------------------------------------------------------------------------
# the pipeline plugin: the masked mean on (C, D) tensors
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SecureMaskedSum:
    """The in-round twin of the host protocol: the same fixed-point field,
    antisymmetric pair masks and dropout recovery. The round's
    non-participants are its dropped set, so every partial-participation
    round runs the recovery. The (C, C, D) pair masks are an operand,
    drawn by :meth:`draw` from a generator seeded from the round's key
    (:func:`repro_torch.core.fl.draw_pipeline_round`)."""
    n_clients: int
    frac_bits: int = 16

    def __post_init__(self):
        validate_secure(self.frac_bits)

    def draw(self, gen: torch.Generator, d: int, device) -> torch.Tensor:
        """(C, C, D) int64 pair masks in [0, 2^32): ``m[i, j]`` uniform for
        i < j, ``m[j, i] = -m[i, j] (mod 2^32)``, zero on the diagonal."""
        c = self.n_clients
        bits = torch.randint(0, MODULUS, (c, c, d), generator=gen,
                             dtype=torch.int64, device=device)
        upper = torch.ones((c, c), dtype=torch.bool,
                           device=device).triu(1)[:, :, None]
        bits = torch.where(upper, bits, 0)
        return (bits - bits.transpose(0, 1)) & _LOW32

    def masked_mean(self, updates: torch.Tensor, mask: torch.Tensor,
                    pair_masks: torch.Tensor) -> torch.Tensor:
        """(C, D) updates and the 0/1 (C,) participation -> the (D,)
        participant mean through the masked modular sum, decoded as the JAX
        package decodes it: signed int32, f32 over the f32 scale, over the
        participant count."""
        scale = float(1 << self.frac_bits)
        enc = torch.round(updates.to(torch.float32) * scale).to(
            torch.int32).to(torch.int64) & _LOW32
        uploads = (enc + torch.sum(pair_masks, dim=1)) & _LOW32
        part = mask > 0
        server = torch.sum(torch.where(part[:, None], uploads, 0),
                           dim=0) & _LOW32
        # dropout recovery: the (survivor, dropped) pair masks
        left = part[:, None] & ~part[None, :]
        corr = torch.sum(torch.where(left[:, :, None], pair_masks, 0),
                         dim=(0, 1)) & _LOW32
        total = (server - corr) & _LOW32
        signed = torch.where(total >= MODULUS // 2, total - MODULUS, total)
        return signed.to(torch.float32) / scale / torch.sum(mask)
