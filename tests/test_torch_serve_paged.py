"""The port's paged KV cache (``repro_torch.models``: ``init_paged_cache``,
``prefill_at``, ``insert_prefill``, ``decode_step(table=)``) against the
JAX package's, on the CPU at ``smoke_variant`` size in f32, with JAX's own
weights carried across (the serving engine's other gates are in
``tests/test_torch_serve_engine.py``).

- The paged pools after ``insert_prefill`` and ``prefill_at``'s logits
  agree with JAX's within 2e-5 of each tensor's largest magnitude.
- Inside the port, paged decode equals dense decode bit for bit.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serve import _models

from repro_torch.models import attention
from repro_torch.serve import model_pads_ok
from repro_torch.utils.tree import tree_flatten


# ------------------------------ paged cache vs JAX --------------------------

def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * scale,
                               err_msg=what)


@pytest.mark.parametrize("arch,lens,bucket", [
    ("gemma3-4b", (3, 6, 4), 6),           # right-padded, one bucket
    ("rwkv6-1.6b", (6, 6, 6), 6),          # recurrent: exact lengths
    ("zamba2-7b", (8, 8, 8), 8),           # a multiple of ssd_chunk
    ("phi3.5-moe-42b-a6.6b", (3, 6, 4), 6),
    ("llama4-maverick-400b-a17b", (20, 32, 27), 32),   # two chunks of 16
])
def test_paged_pools_after_insert_equal_jax(arch, lens, bucket):
    jm, jp, model, params = _models(arch)
    n_slots, bs, ml = 4, 4, max(16, bucket)
    bps = ml // bs
    rng = np.random.default_rng(7)
    toks = rng.integers(0, model.cfg.vocab, size=(3, bucket)).astype(np.int32)
    toks = np.where(np.arange(bucket)[None] < np.asarray(lens)[:, None],
                    toks, 0).astype(np.int32)
    lengths = np.asarray(lens, np.int32)
    slots = np.asarray([2, 0, 3], np.int32)
    table = rng.permutation(n_slots * bps).reshape(n_slots, bps)
    rows = table[slots].astype(np.int32)

    j_logits, j_pre, j_pos = jm.prefill_at(jp, jnp.asarray(toks),
                                           jnp.asarray(lengths))
    j_paged = jm.insert_prefill(
        jm.init_paged_cache(n_slots, n_slots * bps + 1, bs), j_pre,
        jnp.asarray(rows), jnp.asarray(slots))
    with torch.inference_mode():
        logits, pre, pos = model.prefill_at(
            params, torch.as_tensor(toks.astype(np.int64)),
            torch.as_tensor(lengths.astype(np.int64)))
        paged = model.insert_prefill(
            model.init_paged_cache(n_slots, n_slots * bps + 1, bs, "cpu"),
            pre, torch.as_tensor(rows.astype(np.int64)),
            torch.as_tensor(slots.astype(np.int64)))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))
    assert pos.dtype == torch.int32
    _close(logits.numpy(), j_logits, "prefill_at logits")
    want, got = jax.tree.leaves(j_paged), tree_flatten(paged)[0]
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.numpy(), w, f"pool leaf {i}")


# ------------------------------ paged vs dense, inside the port -------------

def _paged_vs_dense(arch, s, ml, bs, table_fn, steps):
    _, _, model, params = _models(arch)
    b = 3
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, model.cfg.vocab, size=(b, s)))
    bps = ml // bs
    table = torch.as_tensor(table_fn(b, bps))
    with torch.inference_mode():
        ld, dense, pd = model.prefill(params, toks, max_len=ml)
        paged = model.init_paged_cache(b, b * bps + 1, bs, "cpu")
        lp, pre, pp = model.prefill_at(params, toks, torch.full((b,), s),
                                       max_len=ml)
        # prefill_at gathers each row's last true position: the same
        # values as prefill's last-column slice, another memory layout
        _close(lp.numpy(), ld.numpy(), "prefill_at vs prefill")
        np.testing.assert_array_equal(pp.numpy(), [pd] * b)
        model.insert_prefill(paged, pre, table, torch.arange(b))
        for i in range(steps):
            tok = torch.argmax(ld, dim=-1)
            ld, dense = model.decode_step(params, dense, tok, pd + i)
            lp, paged = model.decode_step(params, paged, tok, pp.long() + i,
                                          table)
            assert torch.equal(ld, lp), (arch, i)


PAGED_ARCHS = {"gemma3-4b": 6, "zamba2-7b": 8, "phi3.5-moe-42b-a6.6b": 6,
               "llama4-maverick-400b-a17b": 12}   # arch: prompt length


@pytest.mark.parametrize("arch", list(PAGED_ARCHS))
def test_paged_matches_dense_one_block(arch):
    """One block spanning max_len with an identity table IS the dense
    cache: every decode step's logits bitwise."""
    _paged_vs_dense(arch, PAGED_ARCHS[arch], 16, 16,
                    lambda b, bps: np.arange(b)[:, None], 3)


@pytest.mark.parametrize("arch", list(PAGED_ARCHS))
def test_paged_matches_dense_shuffled_multiblock(arch):
    """Real paging: 4 blocks per slot in shuffled physical order; the
    decode crosses two block boundaries, bitwise. llama4's decode from
    position 12 crosses its 16-token chunk, where the paged chunk mask
    (``p >= (pos // chunk) * chunk``) and the dense ring cache must hide
    the first chunk alike."""
    ml = 32 if arch.startswith("llama4") else 16
    _paged_vs_dense(arch, PAGED_ARCHS[arch], ml, 4,
                    lambda b, bps: np.random.default_rng(3).permutation(
                        b * bps).reshape(b, bps), 8)


def test_prefill_at_matches_exact_length_prefill():
    """Right-padded bucketed prefill: each row's logits equal an
    exact-length single-row prefill's within tolerance (another summation
    order: the padded rows are longer), next positions exactly."""
    _, _, model, params = _models("gemma3-4b")
    assert model_pads_ok(model)
    lens = torch.tensor([3, 6, 4])
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, model.cfg.vocab, size=(3, 6)))
    toks = torch.where(torch.arange(6)[None] < lens[:, None], toks, 0)
    with torch.inference_mode():
        logits, _, next_pos = model.prefill_at(params, toks, lens)
        assert next_pos.tolist() == lens.tolist()
        for r in range(3):
            row, _, pos = model.prefill(params, toks[r:r + 1, :lens[r]])
            assert pos == lens[r]
            _close(logits[r].numpy(), row[0].numpy(), f"row {r}")


def test_paged_decode_refuses_chunked_attention():
    """A chunked layer's paged index needs its chunk size (the mask is
    ``p >= (pos // chunk) * chunk``): ``chunk`` 0 is refused, as is an
    unknown kind. With a chunk, positions 16-19 of a 32-token span see
    only their own chunk."""
    table = torch.arange(8, dtype=torch.int64).view(1, 8)
    for kind, chunk in (("chunk", 0), ("local", 16)):
        with pytest.raises(ValueError):
            attention.paged_index(table, torch.zeros(1, dtype=torch.int64),
                                  4, kind, 0, 16, 1e4, chunk)
    pos = torch.tensor([3, 16, 19, 31])
    _, _, valid, _ = attention.paged_index(table.expand(4, 8), pos, 4,
                                           "chunk", 0, 16, 1e4, 16)
    p = torch.arange(32)
    want = (p[None] <= pos[:, None]) & (p[None] >= pos[:, None] // 16 * 16)
    assert torch.equal(valid[:, 0, 0, 0], want)
