"""Slot-based continuous-batching decode engine over a paged KV cache (a
port of the JAX package's ``serve/engine.py``).

The engine owns a fixed-capacity decode batch of ``n_slots`` slots. Every
attention layer reads and writes a preallocated physical block pool through
a per-slot block table
(:func:`repro_torch.models.attention.paged_decode_attention`); recurrent
layers (mamba2 / rwkv6 / rwkv channel-mix) keep per-slot state rows: their
state is O(1) per slot, there is nothing to page. One decode wavefront
(token sample, cache update, per-slot done flags) runs on the device with
no host sync, under ``torch.inference_mode()``; the host then fetches the
tokens and the done flags in one device-to-host copy.

Exactness contract (``tests/test_torch_serve_engine.py``): with greedy
decoding the engine emits the tokens of the static
``launch.serve.generate`` path for every request, including requests
admitted mid-stream, wherever the reference's top-two logit gap exceeds the
logits' rounding differences. The JAX package claims byte identity; in the
port the engine's batch shapes (the decode batch is ``n_slots`` rows, a
prefill group is padded) and the longer masked span of the paged read sum
in another order than the dense B-row path, so logits agree to rounding and
tokens are held under that gap guard.

Paging: each admitted slot gets ``blocks_per_slot`` physical blocks from a
free list (shuffled by churn: the block table is real indirection, not an
identity map). One extra scratch block is reserved: released slots' table
rows all point at it, so their continued decode writes land somewhere
harmless and are never read (the ``p <= pos`` visibility mask only exposes
positions the owner wrote). The host bookkeeping (free lists, tables,
padding) is the JAX engine's, so block tables and schedules are JAX's.

Right-padded bucketed prefill is safe for attention layers (pad-position
cache values are masked until decode overwrites them) but not for recurrent
state, which consumes pad tokens. The engine therefore pads prompts up to
power-of-two buckets only for pure-attention archs and requires
exact-length prefill groups otherwise (``pad_ok``).

Sampling at ``temperature > 0`` (:func:`sample_tokens`): JAX's threefry
``fold_in(fold_in(key, rid), gen)`` has no torch counterpart, so the port
draws by Gumbel-max from uniforms hashed out of ``(seed, rid, gen, vocab
index)``: a pure function of the request and its step, independent of the
slot, the batch and the admission order, made on the device.

The serving mesh: an engine built under
:func:`repro_torch.launch.serve.serve_on_mesh` keeps that rules context
and runs every model call inside it, on each rank's slices of the params,
its pools holding the rank's KV heads. The host bookkeeping (schedule,
block tables, free lists) is computed alike on every rank: it depends on
the requests and on the sampled tokens, which are alike on every rank
(the logits are, bit for bit). The mesh's data axis must be 1: the engine
has one queue, and no router splits requests over data rows. Where the
model axis does not divide the KV heads (MQA), the pools stay whole on
every rank (each rank computes every KV head) and each rank attends with
its own query heads; the sequence-split cache (``cache_seq``) is the
static decode path's, and an engine under ``shard_seq`` raises
``NotImplementedError``.

Checkpoint hot-swap: :meth:`SlotEngine.swap_params` checks the new tree
against the live one and rebinds to it (one resident copy, as JAX's
donation keeps; the caller's old tensors are left as they are). In-flight
slots keep their KV built under the old params; only tokens sampled after
the swap boundary change.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from repro_torch.models import sharding
from repro_torch.serve.requests import Request
from repro_torch.utils.convert import upload
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_flatten, tree_leaf_paths

_M32 = 0xFFFFFFFF


def _pow2_ceil(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def model_pads_ok(model) -> bool:
    """True when every layer is pure attention (no recurrent mixer, no rwkv
    channel-mix ffn): the archs for which right-padded bucketed prefill is
    safe."""
    return all(ls.mixer in ("attn", "shared_attn") and ls.ffn != "rwkv_cm"
               for seg in model.cfg.segments for ls in seg.pattern)


def _mix32(x):
    """A 32-bit integer finaliser (two multiply-xorshift rounds) on values
    in [0, 2**32): Python ints or int64 tensors alike (no product passes
    2**59, so int64 never wraps)."""
    x = ((x >> 16) ^ x) * 0x45D9F3B & _M32
    x = ((x >> 16) ^ x) * 0x45D9F3B & _M32
    return (x >> 16) ^ x


def sample_tokens(logits, seed: int, rid, gen, temperature: float):
    """One draw per row from ``softmax(logits / temperature)``, by
    Gumbel-max over uniforms hashed from ``(seed, rid, gen, vocab index)``.

    logits (B, V); rid / gen (B,) integer tensors. Row b's token depends
    only on ``logits[b]``, ``seed``, ``rid[b]`` and ``gen[b]``: not on the
    slot, the batch or the order of admission. Uniforms carry 24 bits.
    Runs on ``logits``' device without a host sync."""
    v = logits.shape[-1]
    base = _mix32(_mix32(int(seed) & _M32) ^ 0x5E12F3)
    key = _mix32(_mix32((rid.to(torch.int64) & _M32) ^ base)
                 ^ (gen.to(torch.int64) & _M32))
    key2 = _mix32((key + 0x9E3779B9) & _M32)
    j = torch.arange(v, device=logits.device, dtype=torch.int64)
    h = _mix32(_mix32(j[None, :] ^ key[:, None]) ^ key2[:, None])
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.to(torch.float32) / temperature + gumbel,
                        dim=-1)


class SlotEngine:
    """Continuous-batching decode engine. See module docstring.

    Parameters: ``n_slots`` decode batch capacity; ``max_len`` the cache
    span every slot must cover (prompt + generation); ``block_size``
    physical KV block length (default: one block spans ``max_len``, the
    dense-identical configuration); ``eos`` optional early-stop token;
    ``temperature`` / ``seed`` sampling controls; ``prefill_batch`` caps
    prefill rows per admission group (groups pad to the next power of two
    of their size, so the prefill shapes are bounded by buckets x
    log2(prefill_batch)); ``device`` where the caches live and the params
    must (default: the GPU). Built under a serving mesh, ``params`` are
    the rank's slices (see the module's docstring).
    """

    def __init__(self, model, params, *, n_slots: int, max_len: int,
                 block_size: int = 0, eos: int | None = None,
                 temperature: float = 0.0, seed: int = 0,
                 prefill_batch: int = 0, device=None):
        if model.cfg.prefix_len:
            raise ValueError("SlotEngine serves token-only archs "
                             f"(prefix_len={model.cfg.prefix_len})")
        ctx = sharding.current_context()
        if ctx is not None and ctx[1].get("seq") is not None:
            raise NotImplementedError(
                "SlotEngine under shard_seq: the sequence-split cache of a "
                "long context is the static decode path's "
                "(launch.serve.generate); the engine's paged pools are "
                "whole on every rank")
        if sharding.data_axis_size() > 1:
            raise ValueError(
                f"SlotEngine serves on a mesh whose data axis is 1 (one "
                f"queue, no router over data rows); this one has "
                f"{sharding.data_axis_size()}")
        self._ctx = sharding.current_context()
        self.model = model
        self.device = resolve_device(device)
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.block_size = int(block_size) or self.max_len
        self.blocks_per_slot = -(-self.max_len // self.block_size)
        self.eos = eos
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.prefill_batch = int(prefill_batch) or self.n_slots
        self.pad_ok = model_pads_ok(model)

        n_pool = self.n_slots * self.blocks_per_slot
        self.scratch_block = n_pool  # last pool index, never allocated
        self._free_blocks = list(range(n_pool))
        self._free_slots = list(range(self.n_slots))
        self._table_np = np.full((self.n_slots, self.blocks_per_slot),
                                 self.scratch_block, np.int32)
        self._table = self._upload(self._table_np)
        self._slot_req: dict[int, Request] = {}
        self._active_np = np.zeros(self.n_slots, bool)

        self._check_params(params, "engine params", like=(
            None if sharding.model_group() is None
            else sharding.local_params(model.init(device="meta"))))
        self._params = params
        dev = self.device
        with self._on_mesh():
            caches = model.init_paged_cache(self.n_slots, n_pool + 1,
                                            self.block_size, dev)
        self._state = {
            "caches": caches,
            "logits": torch.zeros((self.n_slots, model.cfg.vocab),
                                  dtype=torch.float32, device=dev),
            "pos": torch.zeros(self.n_slots, dtype=torch.int64, device=dev),
            "gen": torch.zeros(self.n_slots, dtype=torch.int64, device=dev),
            "max_gen": torch.ones(self.n_slots, dtype=torch.int64,
                                  device=dev),
            "active": torch.zeros(self.n_slots, dtype=torch.bool,
                                  device=dev),
            "rid": torch.zeros(self.n_slots, dtype=torch.int64, device=dev),
        }

        self.compile_s = 0.0
        self.steps = 0
        self.tokens_out = 0
        self.swaps = 0
        self._occupancy_sum = 0

    @property
    def rules_context(self):
        """The rules context the engine was built under (a serving mesh's,
        :func:`repro_torch.models.sharding.current_context`), or ``None``:
        what the scheduler's clock agrees over."""
        return self._ctx

    def _on_mesh(self):
        """The rules context the engine was built under (a serving mesh),
        re-entered around every model call; nothing without one."""
        if self._ctx is None:
            return contextlib.nullcontext()
        return sharding.axis_rules(*self._ctx)

    def _upload(self, arr):
        """Host integers to the engine's device as int64, without a
        blocking copy on a GPU."""
        return upload(np.asarray(arr, np.int64), self.device)

    def _check_params(self, params, what: str, like=None) -> None:
        """Raise ``ValueError`` unless ``params`` lies on the engine's
        device and, given ``like``, has its tree paths, shapes and
        dtypes (on a serving mesh: the rank's slices)."""
        leaves = tree_flatten(params)[0]
        if like is not None:
            old_p, new_p = tree_leaf_paths(like), tree_leaf_paths(params)
            if old_p != new_p:
                raise ValueError(f"{what} tree mismatch: paths "
                                 f"{old_p[:3]}... != {new_p[:3]}...")
            for path, a, b in zip(new_p, tree_flatten(like)[0], leaves):
                if a.shape != b.shape or a.dtype != b.dtype:
                    raise ValueError(
                        f"{what} tree mismatch at {path}: "
                        f"{a.dtype} {tuple(a.shape)} != {b.dtype} "
                        f"{tuple(b.shape)}")
        for x in leaves:
            if x.device.type != self.device.type or (
                    self.device.index is not None
                    and x.device.index != self.device.index):
                raise ValueError(f"{what} on {x.device}, the engine on "
                                 f"{self.device}")

    # ------------------------------------------------------------- device
    def _step_device(self):
        """ONE decode wavefront on the device: sample every slot's next
        token from its held logits, run the paged decode step, update gen
        counts and done flags. Inactive slots sample token 0 and write to
        scratch. Returns ``(tok, done)`` device tensors."""
        st = self._state
        logits, active = st["logits"], st["active"]
        if self.temperature > 0:
            tok = sample_tokens(logits, self.seed, st["rid"], st["gen"],
                                self.temperature)
        else:
            tok = torch.argmax(logits, dim=-1)
        tok = torch.where(active, tok, 0)
        with self._on_mesh():
            new_logits, _ = self.model.decode_step(
                self._params, st["caches"], tok, st["pos"], self._table)
        st["logits"].copy_(new_logits)
        st["pos"] += 1
        st["gen"] += active
        hit = st["gen"] >= st["max_gen"]
        if self.eos is not None:
            hit |= tok == self.eos
        done = active & hit
        st["active"] &= ~done
        return tok, done

    def _insert(self, pre, logits, rows, slots, next_pos, max_gen, rid,
                active: bool) -> None:
        """Scatter one prefill batch into the engine state, in place.
        Padded duplicate rows carry identical values, so the repeated-index
        stores are deterministic."""
        st = self._state
        with self._on_mesh():
            self.model.insert_prefill(st["caches"], pre, rows, slots)
        st["logits"][slots] = logits.to(torch.float32)
        st["pos"][slots] = next_pos
        st["gen"][slots] = 0
        st["max_gen"][slots] = max_gen
        st["active"][slots] = active
        st["rid"][slots] = rid

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --------------------------------------------------------------- host
    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    @property
    def n_active(self) -> int:
        return int(self._active_np.sum())

    def bucket_len(self, n: int) -> int:
        """Prefill bucket for an n-token prompt: next power of two for
        pad-safe archs, the exact length otherwise."""
        return min(_pow2_ceil(n), self.max_len) if self.pad_ok else n

    @property
    def logits(self):
        """The held next-token logits, (n_slots, V) f32 on the device: row
        s is what slot s samples its next token from (after an admission,
        its prefill's logits at the last prompt token)."""
        return self._state["logits"]

    def admit(self, reqs: list[Request]) -> list[int]:
        """Admit one prefill group. All requests must share a bucket
        (scheduler's job); the group is padded to a power-of-two row count
        by repeating row 0, bounding the prefill shapes per bucket. Returns
        the slots the requests took, in their order."""
        if not reqs:
            return []
        if len(reqs) > self.free_slots:
            raise ValueError(f"admitting {len(reqs)} requests with only "
                             f"{self.free_slots} free slots")
        if len(reqs) > self.prefill_batch:
            raise ValueError(f"group of {len(reqs)} exceeds prefill_batch="
                             f"{self.prefill_batch}")
        buckets = {self.bucket_len(r.prompt_len) for r in reqs}
        if len(buckets) != 1:
            raise ValueError(f"mixed prefill buckets in one group: "
                             f"{sorted(buckets)}")
        bucket = buckets.pop()
        for r in reqs:
            if r.prompt_len + r.max_gen > self.max_len:
                raise ValueError(
                    f"request {r.rid}: {r.prompt_len}+{r.max_gen} tokens "
                    f"exceed max_len={self.max_len}")

        # pad rows to the next power of two of the group size (not the
        # full prefill batch): single-slot joins at saturation pay a 1-row
        # prefill
        n, p = len(reqs), min(self.prefill_batch, _pow2_ceil(len(reqs)))
        toks = np.zeros((p, bucket), np.int32)
        lengths = np.empty(p, np.int32)
        slots = np.empty(p, np.int32)
        rows = np.empty((p, self.blocks_per_slot), np.int32)
        next_pos = np.empty(p, np.int32)
        max_gen = np.empty(p, np.int32)
        rid = np.empty(p, np.int32)
        for i, r in enumerate(reqs):
            s = self._free_slots.pop()
            blocks = [self._free_blocks.pop()
                      for _ in range(self.blocks_per_slot)]
            self._table_np[s] = blocks
            toks[i, :r.prompt_len] = r.tokens
            lengths[i] = r.prompt_len
            slots[i] = s
            rows[i] = blocks
            next_pos[i] = r.prompt_len
            max_gen[i] = r.max_gen
            rid[i] = r.rid
            self._slot_req[s] = r
            self._active_np[s] = True
        for i in range(n, p):  # duplicate row 0: identical-value stores
            toks[i], lengths[i], slots[i] = toks[0], lengths[0], slots[0]
            rows[i], next_pos[i] = rows[0], next_pos[0]
            max_gen[i], rid[i] = max_gen[0], rid[0]

        # one upload for the whole group and the new table
        flat = self._upload(np.concatenate([
            toks.ravel(), rows.ravel(),
            np.stack([lengths, slots, next_pos, max_gen, rid]).ravel(),
            self._table_np.ravel()]))
        toks_t, rows_t, meta, table = torch.split(
            flat, [toks.size, rows.size, 5 * p, self._table_np.size])
        lengths_t, slots_t, pos_t, max_gen_t, rid_t = meta.view(5, p)
        with torch.inference_mode(), self._on_mesh():
            logits, pre, _ = self.model.prefill_at(
                self._params, toks_t.view(p, bucket), lengths_t)
            self._table = table.view(self._table_np.shape)
            self._insert(pre, logits, rows_t.view(rows.shape), slots_t,
                         pos_t, max_gen_t, rid_t, True)
        return [int(s) for s in slots[:n]]

    def step(self):
        """One decode wavefront. Appends each live slot's sampled token to
        its request's ``out`` and returns ``(emitted, finished)``: the
        requests that received a token this step, and the subset whose slot
        was recycled (EOS or generation budget hit)."""
        live = np.nonzero(self._active_np)[0]
        with torch.inference_mode():
            tok, done = self._step_device()
            # one device-to-host copy for both
            host = torch.stack([tok, done.to(tok.dtype)]).cpu().numpy()
        tok, done = host[0], host[1].astype(bool)
        emitted = []
        for s in live:
            r = self._slot_req[int(s)]
            r.out.append(int(tok[s]))
            emitted.append(r)
        finished = [self._release(int(s)) for s in np.nonzero(done)[0]]
        if finished:
            self._table = self._upload(self._table_np)
        self.steps += 1
        self._occupancy_sum += len(emitted)
        self.tokens_out += len(emitted)
        return emitted, finished

    def _release(self, s: int) -> Request:
        self._free_blocks.extend(int(b) for b in self._table_np[s])
        self._table_np[s] = self.scratch_block
        self._active_np[s] = False
        self._free_slots.append(s)
        return self._slot_req.pop(s)

    def swap_params(self, new_params) -> None:
        """Install a new checkpoint without dropping in-flight slots. The
        new tree must have the live one's paths, shapes and dtypes and lie
        on the engine's device (else ``ValueError``); the engine then
        rebinds to it, one resident copy, and leaves the caller's old
        tensors untouched. Tokens sampled after this call use the new
        params; each slot's existing KV was built under the old ones, the
        standard continuous-serving boundary."""
        self._check_params(new_params, "hot-swap params", like=self._params)
        self._params = new_params
        self.swaps += 1

    def warmup(self, buckets=()) -> float:
        """Run the step and the prefill / insert path for each bucket x
        row count once before serving, so steady-state numbers exclude the
        first-use costs (on a GPU: the kernels' build, the cuBLAS handles,
        the allocator's first segments). Runs against the live state: all
        slots are inactive and every table row points at the scratch
        block, so the warm-up writes are invisible (inactive inserts never
        activate a slot). Returns, and reports as ``compile_s``, the
        seconds it took: the JAX engine's compile time, warm-up time
        here."""
        t0 = time.perf_counter()
        row_counts = []
        p = 1
        while p < self.prefill_batch:
            row_counts.append(p)
            p *= 2
        row_counts.append(self.prefill_batch)
        with torch.inference_mode():
            self._step_device()
            self._sync()
            for bucket in sorted({self.bucket_len(b) for b in buckets}):
                for p in row_counts:
                    toks = torch.zeros((p, bucket), dtype=torch.int64,
                                       device=self.device)
                    ones = torch.ones(p, dtype=torch.int64,
                                      device=self.device)
                    zeros = torch.zeros_like(ones)
                    with self._on_mesh():
                        logits, pre, _ = self.model.prefill_at(
                            self._params, toks, ones)
                    rows = torch.full((p, self.blocks_per_slot),
                                      self.scratch_block, dtype=torch.int64,
                                      device=self.device)
                    self._insert(pre, logits, rows, zeros, zeros, ones,
                                 zeros, False)
            self._sync()
        self.compile_s = time.perf_counter() - t0
        return self.compile_s

    def stats(self) -> dict:
        return {
            "steps": self.steps,
            "tokens_out": self.tokens_out,
            "occupancy_mean": round(self._occupancy_sum / self.steps /
                                    self.n_slots, 3) if self.steps else 0.0,
            "swaps": self.swaps,
            "compile_s": round(self.compile_s, 3),
            "free_slots": self.free_slots,
        }
