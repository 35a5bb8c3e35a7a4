"""zCDP privacy accounting for DP-PASGD (paper §3, §5.2).

Implements:
  - Lemma 1: zCDP composition (rho adds).
  - Lemma 2: Gaussian mechanism satisfies (Delta^2 / 2 sigma^2)-zCDP.
  - Lemma 3: rho-zCDP  =>  (rho + 2 sqrt(rho log(1/delta)), delta)-DP.
  - Eq. (9): closed-form overall privacy loss of device m after K iterations:
        eps_m = 2 K G^2 / (X_m^2 sigma_m^2)
              + (2 G / (X_m sigma_m)) sqrt(2 K log(1/delta)).
  - Eq. (23): closed-form optimal (privacy-budget-binding) noise variance:
        (sigma_m*)^2 = 2 K G^2 / (X_m^2 * Z),
        Z = eps_th + 2 log(1/delta) + 2 sqrt(log(1/delta)^2 + eps_th log(1/delta)).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


def gaussian_zcdp(sensitivity: float, sigma: float) -> float:
    """Lemma 2: rho of one Gaussian-mechanism release."""
    if sigma <= 0:
        return math.inf
    return sensitivity ** 2 / (2.0 * sigma ** 2)


def compose_zcdp(*rhos: float) -> float:
    """Lemma 1: composition adds rho."""
    return float(sum(rhos))


def zcdp_to_dp(rho: float, delta: float) -> float:
    """Lemma 3: convert rho-zCDP to (eps, delta)-DP."""
    if rho == math.inf:
        return math.inf
    return rho + 2.0 * math.sqrt(rho * math.log(1.0 / delta))


def grad_sensitivity(clip_norm: float, batch_size: int) -> float:
    """Paper §5.2: Delta_2(g) <= 2 G / X_m for a size-X_m mini-batch."""
    return 2.0 * clip_norm / batch_size


def subsampled_rho(rho_step: float, q: float) -> float:
    """Per-step zCDP cost under per-round client subsampling at rate q.

    Beyond the paper: with partial participation, the per-round release of
    client m's update is the *subsampled* Gaussian mechanism — present with
    probability q, absorbed into the aggregate otherwise — whose expected
    per-round cost is ~ q^2 * rho_step in the small-q regime (the RDP
    amplification of Abadi et al. 2016 / Wang et al. 2019, transported to
    zCDP). The accountant charges only *realized* participating rounds
    (a ~q fraction of them), so the per-realized-step amplification factor
    is q^2 / q = q, matching the q^2-per-round expectation while keeping
    the ledger deterministic. q = 1 is exact Lemma 2 (no amplification).

    Caveat (deliberate modeling choice): the q factor bounds the *marginal*
    mechanism, i.e. it holds in expectation over the participation draw. A
    client that happens to be sampled in far more than a q-fraction of a
    short run is undercharged relative to participation-conditioned
    accounting (which would cost the full rho_step per realized step — the
    amplification benefits the subsampling-blind observer, not the
    conditioned one). For a worst-case conditional ledger, account with
    q = 1 and keep the reduced realized step count —
    ``FederationSpec(amplify_participation=False)`` selects exactly that.
    """
    if not 0.0 < q <= 1.0:
        raise ValueError(f"participation rate q must be in (0, 1], got {q}")
    return q * rho_step


def composed_subsampling_q(*qs: float) -> float:
    """Compose independent subsampling stages into one realized-step rate.

    Cohort execution stacks two Bernoulli gates in front of every local
    step: the client is drawn into the round's cohort (rate K/M over the
    population) and then participates within the cohort (the
    ``participation`` rate q of the aggregation pipeline). The stages are
    independent draws, so the probability a given client realizes a given
    round's steps is the product — and that product is the q of
    :func:`subsampled_rho` under the expectation-level amplification
    (``FederationSpec(amplify_participation=True)``). Every caveat of
    ``subsampled_rho`` transports unchanged: the bound is marginal over
    BOTH draws, assumes uniform sampling (availability-skewed cohorts
    break it — see the JAX package's ``HeterogeneousCohort``), and
    the sound conditional default (q = 1, charge realized steps only) is
    unaffected because the per-client ledger already charges each virtual
    client exactly the rounds it ran.
    """
    q = 1.0
    for qi in qs:
        if not 0.0 < qi <= 1.0:
            raise ValueError(f"subsampling rates must be in (0, 1], "
                             f"got {qi}")
        q *= qi
    return q


def per_step_charges(rho_steps, q: float):
    """Vectorized :func:`subsampled_rho` over a (C,) per-step rho vector —
    THE per-realized-local-step charge expression of every ledger surface
    (``PrivacyAccountant.step``/``step_many`` and the incremental probes of
    ``repro_torch.api.state``). Keeping it here means a change to the
    amplification model cannot desynchronize the probe from the ledger."""
    if not 0.0 < q <= 1.0:
        raise ValueError(f"participation rate q must be in (0, 1], got {q}")
    return q * np.asarray(rho_steps, np.float64)


def epsilon_after_k(k: int, clip_norm: float, batch_size: int, sigma: float,
                    delta: float) -> float:
    """Eq. (9): overall (eps, delta)-DP loss of one device after k iterations."""
    if sigma <= 0:
        return math.inf
    g, x = clip_norm, batch_size
    rho = 2.0 * k * g * g / (x * x * sigma * sigma)  # Lemmas 1+2
    return zcdp_to_dp(rho, delta)                    # == Eq. (9) expanded


def privacy_z(eps_th: float, delta: float) -> float:
    """Eq. (25): Z constant of the binding privacy constraint."""
    ld = math.log(1.0 / delta)
    return eps_th + 2.0 * ld + 2.0 * math.sqrt(ld * ld + eps_th * ld)


def rho_budget(eps_th: float, delta: float) -> float:
    """Largest rho whose Lemma-3 conversion stays within (eps_th, delta)-DP.

    Inverting eps = rho + 2 sqrt(rho log(1/delta)) gives
        sqrt(rho*) = sqrt(log(1/delta) + eps) - sqrt(log(1/delta))
    and one can check rho* = eps_th^2 / Z with Z from Eq. (25).
    """
    ld = math.log(1.0 / delta)
    return (math.sqrt(ld + eps_th) - math.sqrt(ld)) ** 2


def sigma_star(k: int, clip_norm: float, batch_size: int, eps_th: float,
               delta: float) -> float:
    """Eq. (23) corrected: smallest per-step noise std meeting eps_th at K=k.

    NOTE (paper erratum): Eq. (23) as printed reads
        (sigma*)^2 = 2 K G^2 / (X^2 Z),
    but substituting it back into Eq. (9) does NOT give eps_th. The correct
    inversion of Eq. (9) is rho* = eps_th^2 / Z, hence
        (sigma*)^2 = 2 K G^2 Z / (X^2 eps_th^2)   ==  2 K G^2 / (X^2 rho*).
    Verified by the property test eps(sigma*(K)) == eps_th (tests/test_privacy).
    """
    rho = rho_budget(eps_th, delta)  # == eps_th^2 / privacy_z(eps_th, delta)
    var = 2.0 * k * clip_norm ** 2 / (batch_size ** 2 * rho)
    return math.sqrt(var)


@dataclass
class PrivacyAccountant:
    """Tracks per-client zCDP over the run; one instance per federation.

    Each DP-PASGD iteration queries every client's dataset once (the gradient),
    so every local step adds gaussian_zcdp(2G/X_m, sigma_m) to client m.
    """
    clip_norm: float
    delta: float
    batch_sizes: dict[int, int] = field(default_factory=dict)   # client -> X_m
    sigmas: dict[int, float] = field(default_factory=dict)      # client -> sigma_m
    _rho: dict[int, float] = field(default_factory=dict)
    # dispatch/arrival split (buffered-async federation): the slice of _rho
    # that was charged at dispatch time for uploads still in flight. _rho
    # ALWAYS includes it — peek_epsilon/max_epsilon therefore probe the
    # dispatched view, so a straggler's pending charge can never outrun the
    # budget check; landed_rho() subtracts it for the arrived-only view.
    _pending: dict[int, float] = field(default_factory=dict)
    steps: int = 0

    def register_client(self, client: int, batch_size: int, sigma: float) -> None:
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if sigma < 0:
            raise ValueError(f"sigma must be non-negative, got {sigma}")
        self.batch_sizes[client] = batch_size
        self.sigmas[client] = sigma
        self._rho.setdefault(client, 0.0)

    def step(self, n_steps: int = 1, clients=None, q: float = 1.0) -> None:
        """Account for n_steps local iterations.

        ``clients`` restricts the charge to the round's realized participant
        set (everyone when None) — non-participants take no steps, query
        nothing, and spend nothing. ``q`` is the per-round participation
        rate; each charged step costs :func:`subsampled_rho` (amplification
        by client subsampling; identity at q = 1).
        """
        if n_steps < 0:
            raise ValueError("n_steps must be >= 0")
        charged = (self.batch_sizes.keys() if clients is None
                   else [int(m) for m in clients])
        for m in charged:
            sens = grad_sensitivity(self.clip_norm, self.batch_sizes[m])
            self._rho[m] += n_steps * subsampled_rho(
                gaussian_zcdp(sens, self.sigmas[m]), q)
        self.steps += n_steps

    def step_many(self, taus, masks=None, q: float = 1.0) -> np.ndarray:
        """Vectorized ledger replay of a chunk of rounds.

        ``taus`` are the per-round local-step counts (R,); ``masks`` the
        stacked realized 0/1 participation masks (R, C), columns aligned to
        the sorted registered client ids (``None`` -> every client
        participates every round). Per client, the per-round increments are
        applied in round order with the same floating-point expression as
        :meth:`step`, so the resulting ledger is bit-for-bit identical to R
        sequential ``step(tau_r, clients=participants_r, q=q)`` calls — the
        conditional per-round ledger stays the source of truth; the fused
        multi-round driver merely replays it in O(R) numpy row operations
        instead of O(R*C) Python dict updates.

        Returns the (R,) worst-client rho trajectory (after each round), so
        chunked drivers can materialize per-round epsilon records without a
        second replay.
        """
        clients = sorted(self.batch_sizes)
        if not clients:
            raise ValueError("no clients registered")
        taus = [int(t) for t in taus]
        if any(t < 0 for t in taus):
            raise ValueError("n_steps must be >= 0")
        if masks is not None:
            masks = np.asarray(masks)
            if masks.shape != (len(taus), len(clients)):
                raise ValueError(f"masks shape {masks.shape} != "
                                 f"({len(taus)}, {len(clients)})")
        # identical per-step charge expression as step():
        #   n_steps * subsampled_rho(gaussian_zcdp(sens_m, sigma_m), q)
        charge = per_step_charges(
            [gaussian_zcdp(grad_sensitivity(self.clip_norm,
                                            self.batch_sizes[m]),
                           self.sigmas[m]) for m in clients], q)
        rho = np.asarray([self._rho[m] for m in clients], np.float64)
        worst = np.empty((len(taus),), np.float64)
        for r, tau in enumerate(taus):
            inc = tau * charge
            if masks is not None:
                # where (not *): 0 * inf charges (sigma=0 clients) are NaN,
                # and step() never touches non-participants at all
                inc = np.where(masks[r] > 0, inc, 0.0)
            rho = rho + inc
            worst[r] = np.max(rho)
        for i, m in enumerate(clients):
            self._rho[m] = float(rho[i])
        self.steps += sum(taus)
        return worst

    def charge_at_dispatch(self, n_steps: int, clients, q: float = 1.0,
                           ) -> None:
        """Pre-charge ``clients`` the full Lemma-2 cost of ``n_steps`` local
        iterations at DISPATCH time (buffered-async federation).

        Async semantics: a client's DP releases are determined the moment
        it is handed a model version and starts its tau noisy steps — the
        noise it will add is already fixed, regardless of when (or whether)
        its upload lands in a buffer. Charging at dispatch keeps the ledger
        sound against stragglers: ``_rho`` (hence ``peek_epsilon`` /
        ``max_epsilon``) includes the in-flight charge immediately, so the
        budget probe can never be outrun by an upload that is still in the
        air. The per-step expression is identical to :meth:`step`'s
        (``n_steps * subsampled_rho(rho_step, q)``). :meth:`note_arrival`
        moves the charge from pending to landed when the upload arrives —
        total rho is unchanged by arrival."""
        if n_steps < 0:
            raise ValueError("n_steps must be >= 0")
        for m in clients:
            m = int(m)
            sens = grad_sensitivity(self.clip_norm, self.batch_sizes[m])
            inc = n_steps * subsampled_rho(
                gaussian_zcdp(sens, self.sigmas[m]), q)
            self._rho[m] += inc
            self._pending[m] = self._pending.get(m, 0.0) + inc
        self.steps += n_steps

    def note_arrival(self, clients) -> None:
        """Mark ``clients``' in-flight uploads as landed: their pending
        charge (already in ``_rho`` since dispatch) becomes landed rho.
        Total rho is unchanged — arrival is bookkeeping, not a release."""
        for m in clients:
            self._pending.pop(int(m), None)

    def pending_rho(self, client: int) -> float:
        """The dispatch-time pre-charge of ``client``'s in-flight upload
        (0.0 when nothing is in flight)."""
        return self._pending.get(client, 0.0)

    def landed_rho(self, client: int) -> float:
        """rho from arrived uploads only (total minus in-flight)."""
        return self._rho.get(client, 0.0) - self.pending_rho(client)

    def rho(self, client: int) -> float:
        return self._rho.get(client, 0.0)

    def epsilon(self, client: int) -> float:
        return zcdp_to_dp(self.rho(client), self.delta)

    def max_epsilon(self) -> float:
        if not self._rho:
            return 0.0
        return max(self.epsilon(m) for m in self._rho)

    def peek_epsilon(self, extra_steps: int = 0, q: float = 1.0) -> float:
        """Worst-client eps if every client took ``extra_steps`` more local
        iterations — WITHOUT mutating the accountant.

        This is the pre-round probe of the budget-aware training loop: run
        the next round only if ``peek_epsilon(tau) <= eps_th``. rho composes
        additively (Lemma 1) and Lemma 3 is monotone in rho, so the max can
        be taken in rho-space before the single conversion. Under partial
        participation pass the round's rate ``q``: the probe stays
        conservative (it assumes the worst client IS sampled) while its
        per-step cost carries the subsampling amplification.
        """
        if extra_steps < 0:
            raise ValueError("extra_steps must be >= 0")
        if not self.batch_sizes:
            return 0.0
        worst_rho = max(
            self._rho.get(m, 0.0)
            + extra_steps * subsampled_rho(
                gaussian_zcdp(grad_sensitivity(self.clip_norm, x),
                              self.sigmas[m]), q)
            for m, x in self.batch_sizes.items())
        return zcdp_to_dp(worst_rho, self.delta)

    def remaining_steps(self, client: int, eps_th: float) -> int:
        """How many more local steps client m can take before exceeding eps_th."""
        x, s = self.batch_sizes[client], self.sigmas[client]
        if s == 0:
            return 0
        rho_step = gaussian_zcdp(grad_sensitivity(self.clip_norm, x), s)
        left = rho_budget(eps_th, self.delta) - self._rho[client]
        return max(0, int(left / rho_step))
