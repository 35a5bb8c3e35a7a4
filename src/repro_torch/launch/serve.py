"""Serving driver: the continuous-batching engine (``repro_torch.serve``)
by default, the static prefill + decode batch kept as the ``--static``
baseline (a port of the JAX package's ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --smoke --requests 8 --prompt-len 32 --gen 16 [--device cpu]

The engine mode serves a Poisson workload of ``--requests`` requests at
``--rate`` per simulated second on ``--batch`` slots (paged KV blocks of
``--block-size``) and prints the scheduler's summary; ``--static`` runs one
batch through ``prefill``, then one ``decode_step`` per generated token
(forced for prefix-conditioned archs). ``--env-profile host`` re-execs the
launcher once under tcmalloc (:mod:`repro_torch.launch.env`).

The serving mesh: ``--env-profile cpu-mesh --host-devices N`` (or a
launcher's ``WORLD_SIZE`` of N, ``torchrun``) runs the launcher as N ranks
on the serving mesh ``(1, N)``, every rank on the model axis, as the JAX
production mesh puts "model" last. Each rank makes the params whole (from
the seed, or ``--fl-checkpoint``), keeps its slices and serves them; rank 0
prints the JSON. An N that does not divide the arch's query heads raises
``ValueError`` naming the ones that do; KV heads it does not divide (MQA,
granite-20b) stay whole on every rank, and the static path's decode cache
splits its sequence over the ranks instead. ``--host-devices`` over 1
without ``--env-profile cpu-mesh`` raises ``ValueError``. In code,
:func:`serve_on_mesh` lays a ``(dd, dm)`` mesh and installs its decode
rules: :func:`generate` then splits a batch's rows over the ``dd`` data
rows of ranks (under ``shard_seq``, a long context's cache split over
"data", every rank runs the whole batch), and the engine
(:class:`repro_torch.serve.SlotEngine`) runs at ``dd == 1``. Its
``fsdp_over_data`` splits the weights over "data" too (chosen as the JAX
dry run chooses, by the rank's device memory, unless forced).

Serving a federated model: ``--fl-checkpoint DIR`` points at a checkpoint
written with the training launcher's ``federation_meta`` beside it, by the
port's own launcher (``python -m repro_torch.launch.train ... --save DIR``,
dense, population or async) or by the JAX package's (``repro.launch.train``
/ ``repro.api.save_state``); the driver serves the aggregated model instead
of random init.

Both paths warm up before the timed run, so ``tokens_per_s`` is steady
state; the warm-up (on a GPU the kernels' build, cuBLAS handles and the
allocator) is reported as ``compile_s``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_variant
from repro_torch.launch.env import (
    add_env_profile_args,
    apply_env_profile,
    host_ranks,
)
from repro_torch.launch.mesh import (
    ensure_world,
    make_mesh_2d,
    make_serving_mesh,
    run_on_host_world,
    world_size,
)
from repro_torch.models import sharding
from repro_torch.models.transformer import Transformer
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves


@contextlib.contextmanager
def serve_on_mesh(model: Transformer, mesh_shape: tuple[int, int], *,
                  shard_seq: bool = False, fsdp_over_data: bool | None = None):
    """Serve ``model`` on the serving mesh of ``mesh_shape = (dd, dm)``
    ranks for the block: the arch is checked against the model axis
    (:meth:`Transformer.check_model_axis`), the mesh laid over the world's
    first ``dd * dm`` ranks (:func:`repro_torch.launch.mesh
    .make_serving_mesh` of the ``(dd, dm)`` :func:`repro_torch.launch.mesh
    .make_mesh_2d`; ranks beyond it stay out) and its decode rules
    installed (:func:`repro_torch.models.sharding.decode_mesh_rules`: KV
    heads the model axis does not divide put the cache's sequence on
    "model"; ``shard_seq``, a long context of one row, puts it on "data",
    or on both axes, and splits no rows; a cache whose heads the model
    axis divides then splits on both its sequence and its heads), with the
    placement of the model's params under them. ``fsdp_over_data`` also
    splits each rank's model slice of the weights over "data"
    (:func:`repro_torch.models.sharding.data_split_dims`, JAX's
    ``serve_rules(fsdp_over_data=True)``), gathered over the data group
    before each layer: ``None`` decides as the JAX dry run does
    (:func:`repro_torch.models.sharding.needs_param_sharding` against the
    rank's device memory, ``REPRO_DEVICE_MEM_BYTES`` or the card's:
    :func:`repro_torch.mesh.placement.device_memory_budget`), ``True`` /
    ``False`` force it; at ``dd == 1`` there is nothing to split. Yields
    the mesh. Inside, the serving entry points take each rank's slices of
    the params (:func:`repro_torch.models.sharding.local_params`); a rank
    outside the mesh (``mesh.get_coordinate() is None``) serves
    nothing."""
    from repro_torch.mesh.placement import device_memory_budget
    dd, dm = (int(n) for n in mesh_shape)
    model.check_model_axis(dm)
    mesh = make_serving_mesh(make_mesh_2d((dd, dm)))
    rules = sharding.decode_mesh_rules(model.cfg.n_kv_heads, (dd, dm),
                                       shard_seq)
    meta = model.init(device="meta")
    placement = sharding.param_split_dims(meta, dm, rules)
    if fsdp_over_data is None:
        fsdp_over_data = sharding.needs_param_sharding(
            sum(x.numel() for x in tree_leaves(meta)), dm,
            device_memory_budget())
    data = (sharding.data_split_dims(meta, (dd, dm), rules)
            if fsdp_over_data and dd > 1 else None)
    with sharding.axis_rules(mesh, rules, placement=placement,
                             data_placement=data):
        sharding.cache_split_dims(model.cache_axes())   # builds the
        yield mesh                    # sequence group on every rank


def _data_rows():
    """The data axis of the active serving mesh as a row group
    (:class:`repro_torch.core.fl_shard_map.ClientGroup` over "data"), or
    ``None`` where it is 1, where the rules split no rows (``shard_seq``)
    or where no mesh is active."""
    ctx = sharding.current_context()
    if (sharding.data_axis_size() == 1
            or ctx[1].get("batch") != sharding.DATA_AXIS):
        return None
    from repro_torch.core.fl_shard_map import ClientGroup
    return ClientGroup(sharding.current_context()[0], sharding.DATA_AXIS)


def load_federated_params(model: Transformer, directory: str, device=None):
    """The single serving model out of a DP-PASGD checkpoint directory.

    Reads the spec scalars the training launcher stored next to the arrays
    (``federation_meta``) and loads only the params leaves, so checkpoints
    from any optimizer and any compressor serve alike. The client axis
    collapses as ``collapse_clients`` does: any replica under
    ``full_average``, the cross-client mean under ``local_only``. A
    buffered-async checkpoint stores the collapsed server model under
    ``global_params``: that is served, never its in-flight slot storages.
    Returns the params on ``device`` (default: the GPU) in the config's
    dtypes, checked leaf by leaf against the model's own init; under a
    serving mesh (:func:`serve_on_mesh`) the whole checkpoint is loaded
    and this rank's slices are returned."""
    from repro_torch.api import collapse_clients
    from repro_torch.checkpoint import checkpoint_leaf_paths, load_checkpoint
    from repro_torch.utils.convert import transformer_params_from_jax

    device = resolve_device(device)
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)["extra"]
    # path donor only: load_checkpoint matches leaves by path
    donor = model.init(device="meta")
    if any(p.split("/", 1)[0] == "global_params"
           for p in checkpoint_leaf_paths(directory)):
        tree, _, _ = load_checkpoint(directory, like={"global_params": donor})
        return sharding.local_params(transformer_params_from_jax(
            tree["global_params"], model, device))
    tree, _, _ = load_checkpoint(directory, like={"params": donor})
    stacked = transformer_params_from_jax(tree["params"], model, device,
                                          lead=1)
    return sharding.local_params(
        collapse_clients(stacked, meta.get("topology", "full_average")))


def _sample(logits, temperature: float, generator):
    if temperature > 0:
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.argmax(logits, dim=-1)


def generate(model: Transformer, params, prompts, gen_tokens: int,
             prefix=None, temperature: float = 0.0, generator=None,
             with_logits: bool = False):
    """prompts (B, S) integer -> generated (B, gen_tokens) int64.

    Batch ``prefill`` of the prompts (and ``prefix`` embeddings, for the
    prefix-conditioned archs), then per token: the argmax of the last
    logits (``temperature == 0``) or a ``torch.multinomial`` draw from
    ``softmax(logits / temperature)`` with ``generator``, then one
    ``decode_step``, as the JAX package's loop does. Runs under
    ``torch.inference_mode()``. ``with_logits``: also return the logits
    each token was drawn from, (B, gen_tokens, V) f32 (the reference of
    :func:`agree_under_gap`).

    Under a serving mesh (:func:`serve_on_mesh`) ``params`` are the rank's
    slices and the model runs split over the model axis; with a data axis
    ``dd`` over 1 each data row of ranks takes its ``B / dd`` rows (``B %
    dd`` raises ``ValueError``), and the tokens (and the logits) come back
    whole on every rank through one exact gather over "data". Every rank
    of a data row holds the same logits bit for bit, so a sampled token is
    drawn alike on each from the same ``generator`` state."""
    rows = _data_rows()
    if rows is not None:
        b = prompts.shape[0]
        if b % rows.n_shards:
            raise ValueError(f"a batch of {b} rows does not split over a "
                             f"data axis of {rows.n_shards}")
        per = b // rows.n_shards
        mine = slice(rows.index * per, (rows.index + 1) * per)
        prompts = prompts[mine]
        prefix = None if prefix is None else prefix[mine]
    with torch.inference_mode():
        b, s = prompts.shape
        max_len = s + gen_tokens + (model.cfg.prefix_len or 0)
        logits, caches, pos = model.prefill(params, prompts, prefix,
                                            max_len=max_len)
        outs, seen = [], []
        for i in range(gen_tokens):
            tok = _sample(logits, temperature, generator)
            if with_logits:
                seen.append(logits.to(torch.float32))
            logits, caches = model.decode_step(params, caches, tok, pos + i)
            outs.append(tok)
        out = torch.stack(outs, dim=1)
        seen = torch.stack(seen, dim=1) if with_logits else None
        if rows is not None:
            out = rows.all_gather_rows(out)
            seen = None if seen is None else rows.all_gather_rows(seen)
        return (out, seen) if with_logits else out


def agree_under_gap(tokens, ref_tokens, ref_logits, tol: float):
    """Greedy tokens held against a reference's where an argmax is well
    defined: step by step while the reference's top-two logit gap exceeds
    ``tol`` (logits that differ by less than tol / 2 cannot flip such an
    argmax). Two paths whose logits differ only by rounding (another batch
    shape, a padded prefill, a longer masked span) agree there.

    tokens / ref_tokens (G,) sequences; ref_logits (G, V). Returns
    ``(agree, steps compared)``: compared == G means compared in full."""
    ref_logits = torch.as_tensor(ref_logits).to(torch.float32)
    top2 = torch.topk(ref_logits, 2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).cpu().tolist()
    ref = [int(t) for t in ref_tokens]
    got = [int(t) for t in tokens]
    for i, gap in enumerate(gaps):
        if gap <= tol:
            return got[:i] == ref[:i], i
    return got == ref, len(gaps)


def _run_static(model, params, args, cfg, device):
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len)),
        device=device)
    prefix = None
    if cfg.prefix_len:
        prefix = torch.as_tensor(
            rng.standard_normal((args.batch, cfg.prefix_len, cfg.d_model)),
            dtype=torch.float32, device=device) * 0.02

    def run():
        gen = torch.Generator(device=device).manual_seed(0)
        out = generate(model, params, prompts, args.gen, prefix,
                       args.temperature, gen)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    t0 = time.perf_counter()
    run()
    t1 = time.perf_counter()
    out = run()
    t2 = time.perf_counter()
    steady = t2 - t1
    return {
        "mode": "static",
        "generated_shape": list(out.shape),
        "tokens_per_s": round(args.batch * args.gen / steady, 1),
        "compile_s": round((t1 - t0) - steady, 3),
        "sample": out[0, :8].tolist(),
    }


def _run_engine(model, params, args, cfg, device):
    from repro_torch.serve import (SlotEngine, poisson_workload,
                                   serve_continuous)

    max_len = args.prompt_len + args.gen
    engine = SlotEngine(model, params, n_slots=args.batch, max_len=max_len,
                        block_size=args.block_size,
                        temperature=args.temperature, device=device)
    workload = poisson_workload(args.requests, args.rate, cfg.vocab,
                                prompt_lens=(args.prompt_len,),
                                gen_lens=(args.gen,))
    engine.warmup(buckets=[r.prompt_len for r in workload])
    report = serve_continuous(engine, workload)
    first = report.requests[0]
    return {
        "mode": "continuous",
        **report.summary(),
        "sample": first.out[:8],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--static", action="store_true",
                    help="pre-engine baseline: one static prefill+decode "
                         "batch (forced for prefix-conditioned archs)")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots (engine) / batch rows (static)")
    ap.add_argument("--requests", type=int, default=8,
                    help="workload size of the engine mode")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="Poisson arrival rate (requests/sim-second)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--block-size", type=int, default=0,
                    help="paged KV block length (0: one block per slot)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--fl-checkpoint", default=None,
                    help="serve the aggregated model of a checkpoint "
                         "written by repro_torch.launch.train --save (or "
                         "the JAX launcher's) instead of random init")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    add_env_profile_args(ap)
    args = ap.parse_args(argv)
    if args.host_devices > 1 and args.env_profile != "cpu-mesh":
        raise ValueError(f"--host-devices {args.host_devices} splits the "
                         f"host into serving ranks only under --env-profile "
                         f"cpu-mesh")
    apply_env_profile(args.env_profile, host_devices=args.host_devices)
    n_ranks = host_ranks(args.env_profile, args.host_devices)
    if n_ranks > 1 and world_size() != n_ranks:     # not yet on the ranks
        # refuse a model axis the arch cannot take before starting ranks
        Transformer(_arch(args)).check_model_axis(n_ranks)
        from repro_torch.launch import serve as launcher  # by module name,
        #   so the ranks unpickle it whether this runs as __main__ or not
        return run_on_host_world(n_ranks, launcher.run, args)[0]
    return run(args)


def _arch(args):
    cfg = get_arch(args.arch)
    return smoke_variant(cfg) if args.smoke else cfg


def _serving_ranks() -> int:
    """The ranks the launcher serves on: the world's (a ``HostWorld``'s, or
    a launcher's ``WORLD_SIZE``, joined here), else 1."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        ensure_world()
    return world_size()


def run(args) -> int:
    """The launcher's work on parsed ``args``, on every rank of the world
    (if any): rank 0 prints, the others stay quiet."""
    dist = torch.distributed
    if dist.is_initialized() and dist.get_rank() > 0:
        with open(os.devnull, "w") as quiet, \
                contextlib.redirect_stdout(quiet):
            return _run(args)
    return _run(args)


def _run(args) -> int:
    device = resolve_device(args.device)
    cfg = _arch(args)
    model = Transformer(cfg)
    n = _serving_ranks()
    on_mesh = (serve_on_mesh(model, (1, n)) if n > 1
               else contextlib.nullcontext())
    with on_mesh:
        if args.fl_checkpoint:
            params = load_federated_params(model, args.fl_checkpoint,
                                           device)
        else:
            params = sharding.local_params(model.init(
                torch.Generator(device=device).manual_seed(0), device))
        if args.static or cfg.prefix_len:
            result = _run_static(model, params, args, cfg, device)
        else:
            result = _run_engine(model, params, args, cfg, device)
    print(json.dumps({
        "arch": cfg.name, "batch": args.batch,
        "params": "federated" if args.fl_checkpoint else "random-init",
        **({"mesh_shape": [1, n]} if n > 1 else {}),
        **result,
    }, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
