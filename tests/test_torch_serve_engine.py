"""The port's continuous-batching serving plane (``repro_torch.serve``, the
paged cache of ``repro_torch.models``) against the JAX package's
(``repro.serve``), on the CPU at ``smoke_variant`` size in f32, with JAX's
own weights carried across.

- ``poisson_workload`` and the engine's schedules under ``StepClock`` equal
  JAX's exactly (arrivals, tokens, budgets; emit times, finish times, queue
  depth, occupancy, the summary but ``compile_s``; the free lists).
- The paged pools after ``insert_prefill`` and ``prefill_at``'s logits
  agree with JAX's within 2e-5 of each tensor's largest magnitude.
- Inside the port, paged decode equals dense decode bit for bit.
- Greedy tokens are held where an argmax is well defined: while the
  reference's top-two logit gap exceeds LOGIT_TOL (``launch.serve.
  agree_under_gap``). The engine's batch shapes and its longer masked span
  sum in another order than the dense path, so logits agree to rounding,
  not bitwise.
- The MoE archs are held against JAX's engine at equal shapes, never
  against an exact-length ``generate``: an MoE capacity comes from the
  group's padded length (and at S <= 8 from all the engine's slots), so
  in both packages a request's tokens depend on its bucket and its
  neighbours; and llama4's chunked layers refuse a prompt longer than a
  chunk that is not a multiple of it, as JAX's do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.serve import SlotEngine as JaxSlotEngine
from repro.serve import StepClock as JaxStepClock
from repro.serve import poisson_workload as jax_poisson_workload
from repro.serve import serve_continuous as jax_serve_continuous
from test_torch_serve import LOGIT_TOL, _models

from repro_torch.launch.serve import agree_under_gap, generate
from repro_torch.models import attention
from repro_torch.serve import (Request, SlotEngine, StepClock, model_pads_ok,
                               poisson_workload, serve_continuous,
                               serve_static)
from repro_torch.serve.engine import sample_tokens
from repro_torch.utils.tree import tree_flatten, tree_map


def _engine(arch, params=None, **kw):
    _, _, model, p0 = _models(arch)
    kw.setdefault("n_slots", 3)
    kw.setdefault("max_len", 32)
    return model, SlotEngine(model, p0 if params is None else params,
                             device="cpu", **kw)


def _workload(arch, n=7, rate=2.0, seed=5, prompt_lens=(5, 8, 12),
              gen_lens=(4, 9), fn=poisson_workload):
    _, _, model, _ = _models(arch)
    return fn(n, rate, model.cfg.vocab, seed=seed, prompt_lens=prompt_lens,
              gen_lens=gen_lens)


def _prompt(tokens):
    return torch.as_tensor(np.asarray(tokens, np.int64)[None])


def _guarded_full(model, params, requests, outs=None):
    """Every request's tokens (or ``outs[i]``) against ``generate`` on its
    exact-length prompt under the gap guard; returns how many were compared
    in full."""
    full = 0
    for i, r in enumerate(requests):
        ref, logits = generate(model, params, _prompt(r.tokens), r.max_gen,
                               with_logits=True)
        got = r.out if outs is None else outs[i]
        agree, n = agree_under_gap(got, ref[0], logits[0], LOGIT_TOL)
        assert agree, (r.rid, got, ref[0].tolist())
        full += n == r.max_gen
    return full


# ------------------------------ workloads -----------------------------------

@pytest.mark.parametrize("case", [
    dict(n_requests=5, rate=2.0, vocab=64, seed=4),
    dict(n_requests=7, rate=2.0, vocab=512, seed=5, prompt_lens=(5, 8, 12),
         gen_lens=(4, 9)),
    dict(n_requests=10, rate=0.3, vocab=262_144, seed=17,
         prompt_lens=(300, 700, 1500), gen_lens=(16, 32)),
])
def test_poisson_workload_equals_jax(case):
    got, want = poisson_workload(**case), jax_poisson_workload(**case)
    assert len(got) == len(want) == case["n_requests"]
    for a, b in zip(got, want):
        assert (a.rid, a.arrival, a.max_gen) == (b.rid, b.arrival, b.max_gen)
        assert a.tokens.dtype == b.tokens.dtype == np.int32
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_workload_deterministic_per_seed():
    a = poisson_workload(5, 2.0, 64, seed=4)
    b = poisson_workload(5, 2.0, 64, seed=4)
    for ra, rb in zip(a, b):
        assert ra.arrival == rb.arrival and ra.max_gen == rb.max_gen
        np.testing.assert_array_equal(ra.tokens, rb.tokens)
    # a prefix of a longer workload regenerates the same requests
    for ra, rc in zip(a, poisson_workload(3, 2.0, 64, seed=4)):
        np.testing.assert_array_equal(ra.tokens, rc.tokens)
    with pytest.raises(ValueError, match="positive"):
        poisson_workload(2, 0.0, 64)


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


# ------------------------------ schedules and tokens vs JAX's engine --------

@pytest.mark.parametrize("arch,kw,wl", [
    ("gemma3-4b", dict(block_size=8), {}),
    ("rwkv6-1.6b", dict(max_len=24, block_size=8),
     dict(n=6, seed=3, prompt_lens=(5, 9), gen_lens=(4, 7))),
])
def test_schedule_and_tokens_equal_jax_engine(arch, kw, wl):
    """Under StepClock the port's engine runs JAX's schedule exactly, and
    both engines' greedy tokens are generate's under the gap guard."""
    jm, jp, model, params = _models(arch)
    kw = dict(dict(n_slots=3, max_len=32), **kw)
    jengine = JaxSlotEngine(jm, jp, **kw)
    jwl = _workload(arch, fn=jax_poisson_workload, **wl)
    jengine.warmup(buckets=[r.prompt_len for r in jwl])
    jrep = jax_serve_continuous(jengine, jwl, clock=JaxStepClock())

    _, engine = _engine(arch, **kw)
    twl = _workload(arch, **wl)
    assert engine.warmup(buckets=[r.prompt_len for r in twl]) > 0
    rep = serve_continuous(engine, twl, clock=StepClock())

    assert [r.rid for r in rep.requests] == [r.rid for r in jrep.requests]
    for a, b in zip(rep.requests, jrep.requests):
        assert a.emit_times == b.emit_times, a.rid
        assert a.finished == b.finished and len(a.out) == len(b.out)
    assert rep.queue_depth == jrep.queue_depth
    assert rep.occupancy == jrep.occupancy
    got, want = rep.summary(), jrep.summary()
    got.pop("compile_s"), want.pop("compile_s")
    assert got == want
    assert engine._free_blocks == jengine._free_blocks
    assert engine._free_slots == jengine._free_slots
    np.testing.assert_array_equal(engine._table_np, jengine._table_np)
    assert _guarded_full(model, params, rep.requests) == len(rep.requests)
    assert _guarded_full(model, params, rep.requests,
                         [r.out for r in jrep.requests]) == len(rep.requests)


class _LoggedEngine(SlotEngine):
    """A SlotEngine that keeps, per request, the logits each of its tokens
    was drawn from (its slot's row of ``logits`` before each step), through
    the engine's public surface: ``admit``'s slots and ``step``'s
    emitted requests."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.slot_of, self.seen = {}, {}

    def admit(self, reqs):
        slots = super().admit(reqs)
        for r, s in zip(reqs, slots):
            self.slot_of[r.rid] = s
        return slots

    def step(self):
        held = self.logits.clone()
        emitted, finished = super().step()
        for r in emitted:
            self.seen.setdefault(r.rid, []).append(held[self.slot_of[r.rid]])
        return emitted, finished


@pytest.mark.parametrize("arch,wl", [
    ("llama4-maverick-400b-a17b",
     dict(n=6, seed=5, prompt_lens=(12, 20, 30), gen_lens=(4, 9))),
    ("phi3.5-moe-42b-a6.6b", {}),
])
def test_moe_engine_equals_jax_engine(arch, wl):
    """The MoE archs through both engines at equal shapes (buckets 16 / 32,
    decode groups of all 3 slots): the same schedule under StepClock, and
    each request's tokens JAX's engine's while the port's top-two logit gap
    exceeds LOGIT_TOL. llama4's prompts of 20 and 30 tokens prefill as two
    16-token chunks and its decode crosses into the third chunk at 32."""
    jm, jp, model, params = _models(arch)
    kw = dict(n_slots=3, max_len=48, block_size=8)
    jengine = JaxSlotEngine(jm, jp, **kw)
    jwl = _workload(arch, fn=jax_poisson_workload, **wl)
    jengine.warmup(buckets=[r.prompt_len for r in jwl])
    jrep = jax_serve_continuous(jengine, jwl, clock=JaxStepClock())

    engine = _LoggedEngine(model, params, device="cpu", **kw)
    twl = _workload(arch, **wl)
    engine.warmup(buckets=[r.prompt_len for r in twl])
    rep = serve_continuous(engine, twl, clock=StepClock())

    assert [r.rid for r in rep.requests] == [r.rid for r in jrep.requests]
    for a, b in zip(rep.requests, jrep.requests):
        assert a.emit_times == b.emit_times and len(a.out) == a.max_gen
    assert rep.queue_depth == jrep.queue_depth
    assert rep.occupancy == jrep.occupancy
    assert engine._free_slots == jengine._free_slots
    full = 0
    for a, b in zip(rep.requests, jrep.requests):
        agree, n = agree_under_gap(b.out, a.out,
                                   torch.stack(engine.seen[a.rid]), LOGIT_TOL)
        assert agree, (a.rid, a.out, b.out)
        full += n == a.max_gen
    assert full == len(rep.requests)
    if arch.startswith("llama4"):
        assert max(r.prompt_len + r.max_gen for r in twl) > 32
        assert {engine.bucket_len(r.prompt_len) for r in twl} == {16, 32}


# ------------------------------ the port's own gates ------------------------

@pytest.mark.parametrize("arch,kw,wl", [
    ("gemma3-4b", dict(n_slots=2, block_size=0),
     dict(n=6, seed=8, prompt_lens=(4, 7, 11), gen_lens=(5, 12))),
    ("rwkv6-1.6b", dict(n_slots=2, max_len=24, block_size=4),
     dict(n=5, seed=6, prompt_lens=(4, 9), gen_lens=(3, 8))),
    ("zamba2-7b", dict(max_len=24, block_size=8),
     dict(n=5, seed=17, prompt_lens=(8, 16), gen_lens=(4, 6))),
])
def test_engine_matches_generate(arch, kw, wl):
    """The exactness gate: every request of a mixed workload, including
    those admitted mid-stream into recycled slots, decodes generate's
    tokens on its exact-length prompt."""
    model, engine = _engine(arch, **kw)
    workload = _workload(arch, **wl)
    engine.warmup(buckets=[r.prompt_len for r in workload])
    report = serve_continuous(engine, workload, clock=StepClock())
    assert len(report.requests) == len(workload)
    assert all(len(r.out) == r.max_gen for r in report.requests)
    assert engine.free_slots == engine.n_slots
    full = _guarded_full(model, _models(arch)[3], report.requests)
    assert full == len(workload)


def test_static_baseline_matches_engine_tokens():
    """serve_static decodes with generate's calls and sampler: the same
    greedy tokens per request as the engine, only the schedule (convoy)
    differs."""
    _, _, model, params = _models("gemma3-4b")
    wl_a, wl_b = _workload("gemma3-4b"), _workload("gemma3-4b")
    _, engine = _engine("gemma3-4b", block_size=8)
    engine.warmup(buckets=[r.prompt_len for r in wl_a])
    rep_a = serve_continuous(engine, wl_a, clock=StepClock())
    rep_b = serve_static(model, params, wl_b, clock=StepClock(), batch=3)
    assert len(rep_b.requests) == len(wl_b)
    for ra, rb in zip(rep_a.requests, rep_b.requests):
        assert ra.rid == rb.rid and ra.out == rb.out
    assert rep_b.duration_s > rep_a.duration_s   # the convoy costs


def _sampled(n_slots, order, seed):
    _, engine = _engine("gemma3-4b", n_slots=n_slots, block_size=8,
                        temperature=1.0, seed=seed)
    wl = _workload("gemma3-4b")
    arrivals = [r.arrival for r in wl]
    for r, t in zip(wl, order(arrivals)):
        r.arrival = t
    engine.warmup(buckets=[r.prompt_len for r in wl])
    rep = serve_continuous(engine, wl, clock=StepClock())
    return {r.rid: r.out for r in rep.requests}


def test_sampled_decoding_is_a_function_of_seed_and_request():
    """temperature > 0: each request's tokens depend on (seed, rid) only,
    not on the slot count or the order of admission."""
    a = _sampled(3, lambda t: t, seed=3)
    b = _sampled(2, lambda t: t[::-1], seed=3)
    assert a == b
    c = _sampled(3, lambda t: t, seed=4)
    assert c != a and set(c) == set(a)


@pytest.mark.parametrize("temperature", [0.7, 1.5])
def test_sampled_tokens_follow_the_softmax(temperature):
    """Gumbel-max over the hashed uniforms draws from softmax(logits / T):
    20,000 draws (distinct rids and steps) per frequency within 5 sigma,
    and a row's draw does not move with its position in the batch."""
    logits = torch.tensor([[1.0, 0.2, -0.5, 2.0, 0.0, -3.0]])
    n = 20_000
    rid = torch.arange(n) % 4_000
    gen = torch.arange(n) // 4_000
    tok = sample_tokens(logits.expand(n, -1), 11, rid, gen, temperature)
    p = torch.softmax(logits[0] / temperature, dim=-1).numpy()
    freq = np.bincount(tok.numpy(), minlength=6) / n
    assert np.all(np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-9)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    again = sample_tokens(logits.expand(n, -1), 11, rid[perm], gen[perm],
                          temperature)
    assert torch.equal(again, tok[perm])
    assert not torch.equal(sample_tokens(logits.expand(n, -1), 12, rid, gen,
                                         temperature), tok)


def test_slot_recycle_and_eos_early_stop():
    """An EOS engine frees the slot the step the token appears; the request
    keeps the EOS token as its last output."""
    _, _, model, params = _models("gemma3-4b")
    probe = _workload("gemma3-4b", n=1, seed=9, prompt_lens=(6,),
                      gen_lens=(8,))
    ref = generate(model, params, _prompt(probe[0].tokens), 8)[0].tolist()
    eos = ref[2]
    stop = ref.index(eos) + 1
    _, engine = _engine("gemma3-4b", eos=eos)
    engine.warmup(buckets=[6])
    report = serve_continuous(engine, probe, clock=StepClock())
    r = report.requests[0]
    assert r.out == ref[:stop] and r.out[-1] == eos
    assert engine.free_slots == engine.n_slots


def test_backpressure_stats_and_occupancy():
    _, engine = _engine("gemma3-4b", block_size=8)
    wl = _workload("gemma3-4b", n=9, rate=50.0, seed=13)
    engine.warmup(buckets=[r.prompt_len for r in wl])
    s = serve_continuous(engine, wl, clock=StepClock()).summary()
    assert s["max_queue_depth"] > 0
    assert s["occupancy_mean"] > 0.5
    assert s["tokens_out"] == sum(r.max_gen for r in wl)
    assert engine.free_slots == engine.n_slots
    assert s["p99_latency_s"] >= s["p50_latency_s"] > 0


def test_admission_guards():
    _, engine = _engine("gemma3-4b", n_slots=2, max_len=16)
    too_long = [Request(0, 0.0, np.zeros(12, np.int32), 8)]
    with pytest.raises(ValueError, match="exceed max_len"):
        engine.admit(too_long)
    three = [Request(i, 0.0, np.zeros(4, np.int32), 2) for i in range(3)]
    with pytest.raises(ValueError, match="free slots"):
        engine.admit(three)
    with pytest.raises(ValueError, match="max_len"):
        serve_continuous(engine, too_long, clock=StepClock())
    _, small = _engine("gemma3-4b", n_slots=3, prefill_batch=1)
    with pytest.raises(ValueError, match="prefill_batch"):
        small.admit(three[:2])
    assert engine.free_slots == 2 and small.free_slots == 3


def test_admit_reports_slots_and_first_logits():
    """admit returns the slots it gave its group, in request order (the
    free list's pops), and ``logits`` holds each slot's prefill logits at
    its last prompt token: an exact-length prefill's within tolerance."""
    _, _, model, params = _models("gemma3-4b")
    _, engine = _engine("gemma3-4b", block_size=8)
    reqs = _workload("gemma3-4b", n=2, seed=4, prompt_lens=(5, 7),
                     gen_lens=(4,))
    for r in reqs:
        r.tokens = r.tokens[:5]      # one bucket for the group
    assert engine.admit(reqs) == [2, 1] and engine.free_slots == 1
    assert engine.admit([]) == []
    assert engine.logits.shape == (3, model.cfg.vocab)
    for r, s in zip(reqs, (2, 1)):
        want, _, _ = model.prefill(params, _prompt(r.tokens))
        _close(engine.logits[s].numpy(), want[0].numpy(), f"slot {s}")


def test_recurrent_archs_reject_padding():
    """mamba2 / rwkv6 state consumes pad tokens: the engine demands
    exact-length prefill groups there."""
    _, engine = _engine("rwkv6-1.6b")
    assert not engine.pad_ok and engine.bucket_len(5) == 5
    reqs = [Request(0, 0.0, np.zeros(5, np.int32), 2),
            Request(1, 0.0, np.zeros(7, np.int32), 2)]
    with pytest.raises(ValueError, match="mixed prefill buckets"):
        engine.admit(reqs)
    assert not model_pads_ok(_models("zamba2-7b")[2])


def test_step_makes_one_host_copy_and_decode_none(monkeypatch):
    """No host sync in ``decode_step(table=...)`` and one device-to-host
    copy in ``engine.step()``: counted on the CPU by the tensor methods
    that read values back to the host."""
    model, engine = _engine("gemma3-4b", block_size=8)
    engine.admit(_workload("gemma3-4b", n=2, prompt_lens=(6,)))
    calls = []
    for name in ("cpu", "item", "tolist", "numpy", "__int__", "__bool__",
                 "__float__"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(
            torch.Tensor, name,
            lambda self, *a, _n=name, _o=orig, **k: (calls.append(_n),
                                                     _o(self, *a, **k))[1])
    st = engine._state
    with torch.inference_mode():
        model.decode_step(engine._params, st["caches"],
                          torch.zeros(3, dtype=torch.int64), st["pos"],
                          engine._table)
    assert calls == []
    engine.step()
    assert calls == ["cpu", "numpy"]


def test_hot_swap_mid_decode():
    """Swapping checkpoints mid-decode completes every in-flight request,
    keeps tokens emitted before the boundary on the old checkpoint's
    reference, serves later admissions on the new one, and leaves the
    caller's old params untouched (the engine rebinds, never copies)."""
    _, _, model, pa = _models("gemma3-4b")
    pb = model.init(torch.Generator().manual_seed(7), "cpu")
    pa_before = [x.clone() for x in tree_flatten(pa)[0]]
    wl = _workload("gemma3-4b", n=6, rate=1.0, seed=11, prompt_lens=(6, 10),
                   gen_lens=(8,))
    _, engine = _engine("gemma3-4b", params=pa, block_size=8)
    engine.warmup(buckets=[r.prompt_len for r in wl])
    swap_at = 6.0
    report = serve_continuous(engine, wl, clock=StepClock(), swap_at=swap_at,
                              swap_params=pb)
    assert engine.swaps == 1 and engine._params is pb
    assert len(report.requests) == len(wl)
    saw_boundary = False
    for r in report.requests:
        assert len(r.out) == r.max_gen
        n_pre = sum(1 for t in r.emit_times if t <= swap_at)
        ref, logits = generate(model, pa, _prompt(r.tokens), r.max_gen,
                               with_logits=True)
        agree, n = agree_under_gap(r.out[:n_pre], ref[0, :n_pre],
                                   logits[0, :n_pre], LOGIT_TOL)
        assert agree and n == n_pre, r.rid
        saw_boundary |= 0 < n_pre < r.max_gen
    assert saw_boundary
    assert all(torch.equal(a, b)
               for a, b in zip(pa_before, tree_flatten(pa)[0]))
    wl2 = _workload("gemma3-4b", n=3, rate=2.0, seed=21,
                    prompt_lens=(6, 10), gen_lens=(8,))
    rep2 = serve_continuous(engine, wl2, clock=StepClock())
    assert _guarded_full(model, pb, rep2.requests) == 3


@pytest.mark.parametrize("bad", ["paths", "shape", "dtype"])
def test_hot_swap_rejects_mismatched_tree(bad):
    _, _, _, params = _models("gemma3-4b")
    _, engine = _engine("gemma3-4b")
    if bad == "paths":
        new = {"not": torch.zeros(3)}
    else:
        new = tree_map(lambda x: x.clone(), params)
        leaf = new["final_norm"]["scale"]
        new["final_norm"]["scale"] = (leaf[:-1] if bad == "shape"
                                      else leaf.double())
    with pytest.raises(ValueError, match="tree mismatch"):
        engine.swap_params(new)
    assert engine.swaps == 0 and engine._params is params


def test_engine_refuses_params_on_another_device():
    _, _, model, params = _models("gemma3-4b")
    with pytest.raises(ValueError, match="on cpu"):
        SlotEngine(model, params, n_slots=2, max_len=16, device="meta")
