"""Synthetic federated token pipeline for LM training (a numpy copy of the
JAX package's ``repro/data/tokens.py``: the same draws from the same
generator, so both packages sample identical batches).

Each client gets its own bigram-ish generative process (a per-client "topic"
mixture over token ranges) so that the federated split is genuinely non-iid —
client gradients disagree, which is what makes the DP-PASGD averaging period
tau matter. Deterministic given (seed, client).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TokenTaskConfig:
    vocab: int
    seq_len: int
    n_clients: int
    topics_per_client: int = 4
    topic_width: int = 256      # token-range width of one topic
    noniid: float = 0.8         # prob. of drawing from the client's topics
    seed: int = 0


class FederatedTokenStream:
    """sampler(client, tau, rng) -> {"tokens": (tau,B,S), "labels": ...}"""

    def __init__(self, cfg: TokenTaskConfig, batch_size: int,
                 prefix_len: int = 0, d_model: int = 0):
        self.cfg = cfg
        self.batch_size = batch_size
        self.prefix_len = prefix_len
        self.d_model = d_model
        root = np.random.default_rng(cfg.seed)
        # one (n_clients, topics) block: at virtual-population scale
        # (n_clients = M up to 10^6) the topic table is the stream's only
        # O(M) state and stays a few MB of one array
        self.client_topics = root.integers(
            0, max(1, cfg.vocab - cfg.topic_width),
            size=(cfg.n_clients, cfg.topics_per_client))

    def _sample_tokens(self, client: int, n: int,
                       rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        topics = self.client_topics[client]
        # choose a topic per sequence; walk within the topic band with noise
        t = rng.choice(topics, size=(n, 1))
        in_topic = rng.random((n, cfg.seq_len + 1)) < cfg.noniid
        band = t + rng.integers(0, cfg.topic_width, size=(n, cfg.seq_len + 1))
        uniform = rng.integers(0, cfg.vocab, size=(n, cfg.seq_len + 1))
        toks = np.where(in_topic, band, uniform).astype(np.int32)
        return np.clip(toks, 0, cfg.vocab - 1)

    def sampler(self, client: int, tau: int, rng: np.random.Generator):
        n = tau * self.batch_size
        toks = self._sample_tokens(client, n, rng)
        toks = toks.reshape(tau, self.batch_size, self.cfg.seq_len + 1)
        batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        if self.prefix_len:
            batch["prefix"] = rng.standard_normal(
                (tau, self.batch_size, self.prefix_len, self.d_model)
            ).astype(np.float32) * 0.02
        return batch
