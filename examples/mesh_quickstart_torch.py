"""Mesh quickstart on the PyTorch port: DP-PASGD on the 2D client x model
plane.

The 1D planes hold one full model replica per client. ``engine="mesh_2d"``
lays a (client, model) mesh over the ranks of a ``torch.distributed``
world: clients block over the first axis exactly as under
``engine="shard_map"``, and a model axis over 1 splits each replica's
weights and matmuls over ``dm`` ranks (tensor parallelism written by
hand), as the JAX package's ``examples/mesh_quickstart.py`` does on a
(4, 2) mesh. This script starts ``--ranks`` gloo ranks on this host, runs
the walkthrough on each (rank 0 prints) and takes a few seconds on the
CPU:

  1. build the (1, n) mesh and inspect the logical-axis rules that place
     each weight (``mesh2d_rules``: fsdp / tp / act -> "model");
  2. run the same federation on vmap, on shard_map, on the degenerate
     (n, 1) mesh (bitwise the shard_map protocol) and on the (1, n) mesh
     (each replica split over the n ranks): losses agree;
  3. let ``engine="auto"`` place an oversized replica: a footprint hint
     over the per-device budget routes onto mesh_2d with a model axis
     that splits it, and the round runs;
  4. train under a non-dividing client count: pad rows are copies of
     client 0, masked out of the Eq.-7b mean.

Run:  PYTHONPATH=src python examples/mesh_quickstart_torch.py \\
          [--ranks 4] [--device cpu]
"""
import argparse
import os

import numpy as np

C, TAU, DIM, BATCH = 8, 3, 16, 4
SIGMA, LR = 0.6, 0.3


def walkthrough(device: str) -> dict:
    """The quickstart on one rank of the world; every rank runs it."""
    import torch.distributed as dist

    from repro_torch.api import (
        FederationSpec,
        init_state,
        resolve_engine,
        round_fn_for,
        run_round,
    )
    from repro_torch.launch.mesh import make_mesh_2d, world_size
    from repro_torch.mesh.placement import ENV_DEVICE_MEM, default_mesh_shape
    from repro_torch.models.linear import init_linear, logreg_loss
    from repro_torch.models.sharding import (
        axis_rules,
        mesh2d_rules,
        resolve_spec,
    )
    from repro_torch.optim import sgd

    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    opt = sgd(LR)

    def spec_for(engine, n_clients=C, **kw):
        return FederationSpec(
            n_clients=n_clients, tau=TAU, loss_fn=logreg_loss,
            optimizer=opt, engine=engine, dp=True, clip_norm=1.0,
            sigmas=(SIGMA,) * n_clients, batch_sizes=(BATCH,) * n_clients,
            **kw)

    def one_round(spec, seed=0):
        rng = np.random.default_rng(seed)
        batch = {
            "x": rng.normal(size=(spec.n_clients, TAU, BATCH, DIM)).astype(
                np.float32),
            "y": rng.integers(0, 2, size=(spec.n_clients, TAU, BATCH)
                              ).astype(np.int32)}
        state = init_state(spec, init_linear(DIM, device=device),
                           device=device)
        state, rec = run_round(spec, state, batch)
        return float(rec["loss"])

    n = world_size()
    say(f"== 1. the (1, {n}) mesh over {n} ranks and its logical-axis "
        f"rules ==")
    mesh = make_mesh_2d((1, n))
    say(f"   mesh axes {mesh.mesh_dim_names}, shape {tuple(mesh.shape)}")
    with axis_rules(mesh, mesh2d_rules()):
        for logical, what in [(("fsdp", "tp"), "the linear model's w"),
                              (("batch", "seq", "tp"), "an activation"),
                              (("client",), "the client axis")]:
            say(f"   {str(logical):28s} -> {resolve_spec(logical)} "
                f"({what})")

    say("== 2. one DP round: vmap vs shard_map vs the two meshes ==")
    losses = {"vmap": one_round(spec_for("vmap")),
              "shard_map": one_round(spec_for("shard_map")),
              "mesh_2d": one_round(spec_for("mesh_2d", mesh_shape=(n, 1))),
              f"mesh_2d (1, {n})": one_round(spec_for(
                  "mesh_2d", mesh_shape=(1, n)))}
    for name, loss in losses.items():
        say(f"   {name:14s} {loss:.6f}")
    assert losses["mesh_2d"] == losses["shard_map"]
    assert abs(losses["shard_map"] - losses["vmap"]) < 1e-4
    assert abs(losses[f"mesh_2d (1, {n})"] - losses["vmap"]) < 1e-4

    say("== 3. auto placement: an oversized replica routes onto mesh_2d ==")
    replica = 100 * DIM * 4                     # synthetic footprint hint
    os.environ[ENV_DEVICE_MEM] = str(4 * 1024)  # tiny per-device budget
    try:
        auto = spec_for("auto", replica_bytes=replica)
        shape = default_mesh_shape(C, n, replica_bytes=replica)
        round_fn_for(auto)
        losses["auto"] = one_round(auto)
        say(f"   replica {replica} B vs 4096 B/rank budget -> "
            f"engine={resolve_engine(auto)}, mesh {shape}: loss "
            f"{losses['auto']:.6f}")
        assert resolve_engine(auto) == "mesh_2d" and shape[1] > 1
        assert abs(losses["auto"] - losses["vmap"]) < 1e-4
    finally:
        del os.environ[ENV_DEVICE_MEM]

    say(f"== 4. non-dividing client count: C=6 on a ({n}, 1) mesh ==")
    losses["padded"] = one_round(spec_for("mesh_2d", n_clients=6,
                                          mesh_shape=(n, 1)))
    losses["padded_vmap"] = one_round(spec_for("vmap", n_clients=6))
    say(f"   mesh ({n},1) C=6  {losses['padded']:.6f}  vs vmap "
        f"{losses['padded_vmap']:.6f} (pad rows masked out of Eq. 7b)")
    assert abs(losses["padded"] - losses["padded_vmap"]) < 1e-4
    say("done.")
    return losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4,
                    help="gloo ranks to start on this host")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu without a GPU)")
    args = ap.parse_args(argv)
    from repro_torch.launch.mesh import run_on_host_world
    run_on_host_world(args.ranks, walkthrough, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
