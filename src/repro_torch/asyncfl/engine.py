"""Buffered-async flush/dispatch executor (FedBuff-style, Nguyen et al.).

One async *cycle*

1. **flushes** the B popped arrivals into the global model: a
   staleness-weighted masked mean of the arrivals' slot replicas (dense),
   or of their compressed error-fed deltas (pipeline with a compressor),
   and
2. **dispatches** replacements for exactly those B slots from the new
   global model: the sync engines' local round
   (:func:`repro_torch.core.fl.make_local_round`) over the (b, ...) block,
   so each local step makes one ``dp_clip_noise`` call on all b rows, with
   the update the slot will upload *computed at dispatch* (a qsgd upload
   is one ``quantize_decompress`` call on the block).

The slot storages (params, optimizer state, metrics, and ``sent`` /
``residual`` when compressed) are read with ``index_select`` and written in
place with ``index_copy_``: a cycle consumes the state it is given, as the
JAX package's donation does.

Numerical contract (the sync-equivalence identity gate): with
``buffer_size == n_clients``, a zero-spread latency model and
``staleness_alpha == 0``, every flush pops ``idx == arange(C)`` with unit
weights and each cycle computes the port's sync ``vmap`` round
(``core/fl.py``, ``core/aggregation.py``) bit for bit:

* the dispatch draws at the counter generator's key with
  :func:`repro_torch.core.fl.draw_dispatch`, which draws what
  ``run_round``'s ``draw_round_noise`` / ``draw_pipeline_round`` draw at
  that key and advances it as they do;
* weights enter only as ``m = w * mask``; the anchor carry
  ``(sum(mask) - sum(m)) * anchor`` is left out when every weight is 1
  (known on the host, so it costs no sync), where it is zero;
* with unit weights the dense flush divides as the sync path does: the
  client mean (``tree_mean_over_axis0``) without a pipeline, the masked
  mean ``sum(mask * x) / sum(mask)`` with one; integer optimizer leaves
  take replica 0 outside a pipeline and ride the masked mean's cast inside
  one. Staleness-weighted flushes use the JAX package's expression.

Staleness (``w(s) = 1/(1+s)^alpha`` by default, pluggable at the runtime
layer) mixes each stale arrival toward the *current* global model: the
flush is ``[sum(w_i m_i x_i) + (sum(m) - sum(w m)) * global] / sum(m)``
for dense updates, and a plain ``w``-scaled delta average for compressed
updates (deltas are already anchored at the global model). A flush whose
arrivals include no participant (possible when B < C under partial
participation) leaves the global model and its optimizer state as they
are, and its record holds no local metrics; the JAX package divides by
the zero count there.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.spec import FederationSpec
from repro_torch.core.aggregation import flatten_tree, unflatten_like
from repro_torch.core.fl import draw_dispatch, make_grad_fn, make_local_round
from repro_torch.utils.convert import upload
from repro_torch.utils.tree import (
    tree_broadcast_axis0,
    tree_leaves,
    tree_map,
    tree_mean_over_axis0,
)


def block_participants(spec: FederationSpec, block: int) -> int:
    """Participants sampled for a dispatch block of ``block`` slots: the
    spec's exact per-round count when the block is the full cohort (the
    degenerate/identity case), else the participation fraction scaled to
    the block (floored at one so every dispatch trains something)."""
    if block == spec.n_clients:
        return spec.participants_per_round()
    return max(1, min(block, round(spec.participation_fraction() * block)))


def _take0(tree, idx):
    return tree_map(lambda x: x.index_select(0, idx), tree)


def _scatter0(store, new, idx):
    tree_map(lambda s, n: s.index_copy_(0, idx, n), store, new)


def _rows(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (x.dim() - 1))


class AsyncBufferedExecutor:
    """Per-spec flush/dispatch cycle (+ the generation-0 dispatch).

    Three operand layouts exist (plain / pipeline-dense /
    pipeline-compressed); :meth:`init_dispatch` and :meth:`cycle` hide the
    layout behind keyword ``residual`` / ``sent`` operands.
    """

    def __init__(self, spec: FederationSpec):
        if not spec.is_async():
            raise ValueError("AsyncBufferedExecutor needs "
                             "engine='async_buffered', got "
                             f"engine={spec.engine!r}")
        self.spec = spec
        cfg = spec.fl_config(vmap_clients=True)
        self._avg_opt = cfg.average_opt_state
        self._pipeline = spec.aggregation_pipeline()
        self._compressor = (self._pipeline.compressor
                            if self._pipeline is not None else None)
        self._local_round = make_local_round(
            make_grad_fn(spec.loss_fn, cfg), spec.optimizer, cfg.tau)

    # -- dispatch core (shared by init and cycle) ---------------------------

    def _dispatch(self, global_p, global_o, slot_o_src, batch, key, sigmas_b,
                  residual_b):
        """Train one block of ``b`` slots from ``global_p``: the block's
        draws, its local rounds, and the at-dispatch compression of the
        update it will upload.

        ``slot_o_src`` is the per-slot optimizer state the block resumes
        from when the spec keeps optimizer state local
        (``average_opt_state=False``); ignored (broadcast of ``global_o``)
        otherwise. Returns ``(new_p, new_s, ms, sent_b, residual_b, mask,
        key)`` with ``sent_b`` / ``residual_b`` None for dense specs and
        ``mask`` the block's participation mask (all ones without a
        pipeline).
        """
        b = tree_leaves(batch)[0].shape[0]
        base = tree_broadcast_axis0(global_p, b)
        mask, noise, agg_rand, key = draw_dispatch(
            key, base, self.spec.tau, self._pipeline,
            block_participants(self.spec, b))
        opt_in = (tree_broadcast_axis0(global_o, b) if self._avg_opt
                  else slot_o_src)
        new_p, new_s, ms = self._local_round(base, opt_in, batch, noise,
                                             sigmas_b)
        sent_b = None
        if self._compressor is not None:
            flat_prev = flatten_tree(base)
            corrected = (flatten_tree(new_p) - flat_prev) + residual_b
            sent_b = self._compressor(corrected, agg_rand)
            sel = mask[:, None]
            residual_b = (sel * (corrected - sent_b)
                          + (1.0 - sel) * residual_b)
        if self._pipeline is not None and not self._avg_opt:
            # non-participants of this dispatch did not really train: the
            # masked mix of AggregationPipeline's average_opt_state=False
            def _mask_leaf(new, old):
                m = _rows(mask, new)
                return (m * new.to(torch.float32)
                        + (1.0 - m) * old.to(torch.float32)).to(new.dtype)
            new_s = tree_map(_mask_leaf, new_s, opt_in)
        return new_p, new_s, ms, sent_b, residual_b, mask, key

    # -- generation-0 dispatch ---------------------------------------------

    def init_dispatch(self, global_p, global_o, batch, key, sigmas,
                      residual=None) -> dict:
        """Dispatch generation 0 (every slot, from the initial model).

        Returns a dict of the fresh slot storages, the advanced key and
        the block's participation mask (on the device).
        """
        p, s, ms, sent, res, mask, key = self._dispatch(
            global_p, global_o,
            None if self._avg_opt
            else tree_broadcast_axis0(global_o, self.spec.n_clients),
            batch, key, sigmas, residual)
        return {"slot_params": p, "slot_opt": s, "slot_metrics": ms,
                "sent": sent, "residual": res, "key": key, "mask": mask}

    # -- the flush + dispatch cycle -----------------------------------------

    def _flush(self, global_p, global_o, slot_p, slot_o, slot_ms, sent, idx,
               weights, arr_mask, unit: bool, empty: bool):
        """Fold the popped arrivals into the global model (staleness- and
        participation-weighted) and reduce their metrics. ``unit``: every
        weight is 1; ``empty``: no arrival participated (both host-known).
        Returns ``(new_global_p, new_global_o, record_metrics)``."""
        if empty:
            # no popped arrival participated: nothing to fold in (the JAX
            # package divides by the zero participant count here and turns
            # the global model and the metrics into NaN), and no metric to
            # report, so the record carries none
            return global_p, global_o, {}
        in_pipeline = self._pipeline is not None
        arrived_ms = _take0(slot_ms, idx)
        if unit and not in_pipeline:
            # the sync vmap engine's client mean, as core/fl.round_step
            new_gp = tree_mean_over_axis0(_take0(slot_p, idx))
            new_go = (tree_mean_over_axis0(_take0(slot_o, idx),
                                           keep_dtype=True)
                      if self._avg_opt else global_o)
            return new_gp, new_go, {k: torch.mean(v)
                                    for k, v in arrived_ms.items()}
        m = arr_mask if unit else weights * arr_mask
        den_sel = torch.sum(arr_mask)
        carry_w = None if unit else den_sel - torch.sum(m)

        def _comb(new_b, anchor):
            # int leaves: lockstep counters outside a pipeline take a
            # replica (tree_mean_over_axis0's keep_dtype rule); inside one
            # they ride the masked mean's cast like the sync pipeline
            if not in_pipeline and not torch.is_floating_point(new_b):
                return new_b[0]
            s = torch.sum(_rows(m, new_b) * new_b.to(torch.float32), dim=0)
            if carry_w is not None:
                s = s + carry_w * anchor.to(torch.float32)
            return (s / den_sel).to(new_b.dtype)

        if self._compressor is not None:
            sent_b = sent.index_select(0, idx)
            avg_delta = torch.sum(m[:, None] * sent_b, dim=0) / den_sel
            one = tree_map(lambda x: x.unsqueeze(0), global_p)
            new_gp = tree_map(lambda x: x[0], unflatten_like(
                (flatten_tree(one)[0] + avg_delta).unsqueeze(0), one))
        else:
            new_gp = tree_map(_comb, _take0(slot_p, idx), global_p)
        new_go = (tree_map(_comb, _take0(slot_o, idx), global_o)
                  if self._avg_opt else global_o)
        rec_ms = {k: torch.sum(arr_mask * v) / den_sel
                  for k, v in arrived_ms.items()}
        return new_gp, new_go, rec_ms

    def cycle(self, global_p, global_o, slot_p, slot_o, slot_ms, key, sigmas,
              idx: np.ndarray, weights: np.ndarray, arr_mask: np.ndarray,
              batch, sent=None, residual=None) -> dict:
        """One flush + dispatch over the popped arrival block ``idx``.

        ``idx`` (B,) int64, ``weights`` / ``arr_mask`` (B,) f32 are host
        arrays: the block's slots in pop order, their staleness weights
        and their dispatch-time participation mask. They go to the device
        from pinned memory without blocking. ``batch`` is the replacement
        dispatch's (B, tau, ...) round batch on the device. The slot
        storages are updated in place. Returns a dict with the new globals,
        the slot storages, the advanced key, the NEW dispatch's
        participation mask (on the device) and the flushed arrivals'
        reduced metrics (0-d device tensors).
        """
        dev = tree_leaves(global_p)[0].device
        weights = np.asarray(weights, np.float32)
        arr_mask = np.asarray(arr_mask, np.float32)
        unit = bool(np.all(weights == 1.0))
        idx_t = upload(np.asarray(idx, np.int64), dev)
        new_gp, new_go, rec_ms = self._flush(
            global_p, global_o, slot_p, slot_o, slot_ms, sent, idx_t,
            None if unit else upload(weights, dev), upload(arr_mask, dev),
            unit, empty=not arr_mask.any())
        new_p, new_s, ms_b, sent_b, res_b, nmask, key = self._dispatch(
            new_gp, new_go,
            None if self._avg_opt else _take0(slot_o, idx_t), batch, key,
            sigmas.index_select(0, idx_t),
            residual.index_select(0, idx_t) if residual is not None
            else None)
        _scatter0(slot_p, new_p, idx_t)
        _scatter0(slot_o, new_s, idx_t)
        _scatter0(slot_ms, ms_b, idx_t)
        if sent is not None:
            sent.index_copy_(0, idx_t, sent_b)
            residual.index_copy_(0, idx_t, res_b)
        return {"global_params": new_gp, "global_opt": new_go,
                "slot_params": slot_p, "slot_opt": slot_o,
                "slot_metrics": slot_ms, "sent": sent, "residual": residual,
                "key": key, "mask": nmask, "metrics": rec_ms}


# per-spec executor cache (bounded LRU: executors hold loss/optimizer
# closures). Keyed like the resident chunk cache: the block participant
# count follows the spec's participation.
_EXECUTOR_CACHE: dict[tuple, AsyncBufferedExecutor] = {}
_EXECUTOR_CACHE_MAX = 16


def executor_for(spec: FederationSpec) -> AsyncBufferedExecutor:
    """The cached :class:`AsyncBufferedExecutor` for ``spec`` (per engine
    key + participant count, LRU-bounded)."""
    key = (spec.engine_key(), spec.participants_per_round())
    ex = _EXECUTOR_CACHE.pop(key, None)
    if ex is None:
        ex = AsyncBufferedExecutor(spec)
        while len(_EXECUTOR_CACHE) >= _EXECUTOR_CACHE_MAX:
            _EXECUTOR_CACHE.pop(next(iter(_EXECUTOR_CACHE)))
    _EXECUTOR_CACHE[key] = ex
    return ex
