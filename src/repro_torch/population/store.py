"""ClientStore: sticky per-virtual-client state, host-resident, sparse
(a numpy-only copy of ``repro.population.store``, with its ``.npz``
layout: a store either package writes loads in the other).

Cohort execution keeps only K client replicas on device, but two pieces of
DP-PASGD state are *per client*, not per slot, and must survive between a
client's cohort appearances:

* the **error-feedback residual** of the compressed aggregation pipeline
  (``repro_torch.core.aggregation``) — what the codec dropped from the
  client's last update, re-sent on its next participation;
* the **privacy ledger** — spent zCDP rho per virtual client (the
  conditional per-realized-client ledger: a client pays only for rounds it
  actually ran).

The store keeps a dense (M,) float64 rho vector and (M,) participation
counter (8 + 8 bytes per virtual client — 16 MB at M = 10^6), and a
*sparse* residual table: a (D,) float32 row exists only for clients that
have ever carried nonzero error-feedback state, so host memory scales with
cohort coverage, not with M x D. Rows that return to exactly zero are
pruned. Per round the cohort's rows are gathered into the (K, D) device
block and scattered back — device memory stays bounded by K regardless
of M.

The store checkpoints alongside the FLState
(:func:`repro_torch.population.runtime.save_population_state`) as one ``.npz``
(dense ledgers + the sparse rows with their vid index), so
checkpoint/resume round-trips the ledger and residuals bit-for-bit.
"""
from __future__ import annotations

import numpy as np

STORE_FILENAME = "client_store.npz"


class ClientStore:
    """Sticky per-virtual-client federation state (see module docstring)."""

    def __init__(self, population: int, residual_dim: int | None = None):
        if population <= 0:
            raise ValueError(f"population must be positive, got {population}")
        self.population = population
        self.residual_dim = residual_dim
        self.rho = np.zeros((population,), np.float64)
        self.rounds_participated = np.zeros((population,), np.int64)
        self._residual: dict[int, np.ndarray] = {}
        # running worst-rho cache: zCDP composition only ever adds, so the
        # max is monotone and scatter_rho can maintain it in O(K) — the
        # budget probes then never pay an O(M) reduce per round/chunk.
        # Writes that bypass scatter_rho (direct ``store.rho[...] = ``
        # surgery) must call refresh_max_rho() after.
        self._max_rho = 0.0

    # -- residual (sparse) ---------------------------------------------------

    def needs_residual(self) -> bool:
        return self.residual_dim is not None

    def residual_rows(self) -> int:
        """How many clients currently hold a (nonzero) residual row."""
        return len(self._residual)

    def gather_residual(self, cohort: np.ndarray) -> np.ndarray:
        """The cohort's (K, D) f32 residual block (zeros for clients that
        have never participated / whose residual was pruned)."""
        if self.residual_dim is None:
            raise ValueError("store was built without a residual_dim")
        out = np.zeros((len(cohort), self.residual_dim), np.float32)
        for i, vid in enumerate(cohort):
            row = self._residual.get(int(vid))
            if row is not None:
                out[i] = row
        return out

    def scatter_residual(self, cohort: np.ndarray, block) -> None:
        """Write the round's updated (K, D) residual block back to the
        cohort's rows. All-zero rows are pruned (a client whose codec
        dropped nothing — or that never participated under a partial
        within-cohort mask and had no prior row — costs no host memory)."""
        if self.residual_dim is None:
            raise ValueError("store was built without a residual_dim")
        block = np.asarray(block, np.float32)
        if block.shape != (len(cohort), self.residual_dim):
            raise ValueError(f"residual block shape {block.shape} != "
                             f"({len(cohort)}, {self.residual_dim})")
        for i, vid in enumerate(cohort):
            vid = int(vid)
            if np.any(block[i]):
                self._residual[vid] = block[i].copy()
            else:
                self._residual.pop(vid, None)

    # -- privacy ledger ------------------------------------------------------

    def gather_rho(self, cohort: np.ndarray) -> np.ndarray:
        return self.rho[np.asarray(cohort)].copy()

    def scatter_rho(self, cohort: np.ndarray, rho_block) -> None:
        block = np.asarray(rho_block, np.float64)
        self.rho[np.asarray(cohort)] = block
        self._max_rho = max(self._max_rho, float(np.max(block)))

    def note_participation(self, cohort: np.ndarray, rounds: int = 1) -> None:
        """Count cohort membership (rounds the client was *sampled* for —
        under a within-cohort participation mask some may have idled)."""
        self.rounds_participated[np.asarray(cohort)] += int(rounds)

    def max_rho(self) -> float:
        """Worst spent rho over the population — O(1) from the running
        cache (see __init__; exact for ledgers written via scatter_rho)."""
        return self._max_rho

    def refresh_max_rho(self) -> float:
        """Recompute the worst-rho cache with one O(M) pass — required
        after mutating ``rho`` without going through scatter_rho."""
        self._max_rho = float(np.max(self.rho))
        return self._max_rho

    # -- checkpointing -------------------------------------------------------

    def save(self, path: str) -> None:
        vids = np.asarray(sorted(self._residual), np.int64)
        rows = (np.stack([self._residual[int(v)] for v in vids])
                if vids.size else
                np.zeros((0, self.residual_dim or 0), np.float32))
        np.savez(path, population=np.int64(self.population),
                 residual_dim=np.int64(-1 if self.residual_dim is None
                                       else self.residual_dim),
                 rho=self.rho, rounds_participated=self.rounds_participated,
                 residual_vids=vids, residual_rows=rows)

    @classmethod
    def load(cls, path: str) -> "ClientStore":
        with np.load(path) as z:
            dim = int(z["residual_dim"])
            store = cls(int(z["population"]),
                        residual_dim=None if dim < 0 else dim)
            store.rho = z["rho"].astype(np.float64)
            store.refresh_max_rho()
            store.rounds_participated = (
                z["rounds_participated"].astype(np.int64))
            for vid, row in zip(z["residual_vids"], z["residual_rows"]):
                store._residual[int(vid)] = row.astype(np.float32)
        return store
