"""The process world, the client x model mesh over its ranks, and the
derived federated / serving views (the port's counterpart of the JAX
package's ``repro/launch/mesh.py``).

A JAX program sees every device of its host in one process; a PyTorch
program runs one process per rank, each driving the same federation
(SPMD), and the ranks meet in ``torch.distributed`` collectives. The world
comes from one of three places:

* a launcher that sets ``WORLD_SIZE`` (``torchrun``): :func:`ensure_world`
  initializes from the environment, one rank per card (``LOCAL_RANK``),
  NCCL for CUDA tensors and gloo for CPU tensors;
* :class:`HostWorld`: N gloo ranks on this host, the counterpart of
  XLA's ``--xla_force_host_platform_device_count`` (the ``cpu-mesh``
  profile of :mod:`repro_torch.launch.env`). The ranks meet through a
  ``FileStore`` in a fresh temporary directory, never a fixed TCP port, so
  worlds started side by side do not collide; each rank runs one torch
  thread;
* otherwise a world of one (:func:`ensure_world`): gloo for CPU tensors,
  plus NCCL for CUDA tensors where there is a card, as the JAX package's
  sharded engines build a one-device mesh.

:func:`make_mesh_2d` lays a ``("client", "model")`` ``DeviceMesh`` over the
world's ranks, each client block a contiguous row-major slab. Building it
creates both sub-groups: ``mesh.get_group("client")`` (the ranks at this
rank's model coordinate, which meet in the Eq.-7b reduction,
:class:`repro_torch.core.fl_shard_map.ClientGroup`) and
``mesh.get_group("model")`` (the ranks of this rank's slab, which split a
replica: :class:`repro_torch.mesh.collectives.ModelGroup`).
:func:`make_serving_mesh` of such a mesh is the serving mesh, ``("data",
"model")`` over the same slabs: each data row of ranks serves its block of
a batch's rows and splits the model over its ``dm`` ranks.
"""
from __future__ import annotations

import os
import queue
import shutil
import tempfile
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

CLIENT_AXIS = "client"
MODEL_AXIS = "model"
WORLD_TIMEOUT_S = 300      # a collective waits this long before it fails


def _backend_for_this_host() -> str:
    return "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"


def ensure_world() -> None:
    """Initialize the default process group if nothing has: from the
    environment under a launcher that sets ``WORLD_SIZE``, else a world of
    one (an in-memory store, no files, no ports)."""
    if dist.is_initialized():
        return
    timeout = timedelta(seconds=WORLD_TIMEOUT_S)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if torch.cuda.is_available():
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(_backend_for_this_host(), timeout=timeout)
        return
    dist.init_process_group(_backend_for_this_host(), store=dist.HashStore(),
                            rank=0, world_size=1, timeout=timeout)


def world_size() -> int:
    """Ranks in the process world (1 when none is initialized)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


_MESH_CACHE: dict[tuple, object] = {}


def _device_mesh(grid: np.ndarray, names: tuple[str, ...]):
    """A ``DeviceMesh`` over ``grid`` (global ranks), built once per grid
    and process group: building one creates its sub-groups, a collective
    of the whole world, and the groups live as long as the world."""
    from torch.distributed.device_mesh import DeviceMesh
    ensure_world()
    key = (tuple(grid.shape), tuple(grid.reshape(-1).tolist()), names,
           dist.distributed_c10d._get_default_group())
    mesh = _MESH_CACHE.get(key)
    if mesh is None:
        mesh = _MESH_CACHE[key] = DeviceMesh(
            _device_type(), torch.as_tensor(grid), mesh_dim_names=names)
    return mesh


def make_mesh_2d(mesh_shape: tuple[int, int]):
    """The 2D federation mesh of :mod:`repro_torch.mesh`: ``mesh_shape =
    (dc, dm)`` client blocks x model shards over the world's ranks.

    Each of the ``dc`` client blocks is a CONTIGUOUS slab of ``dm`` ranks
    (row-major), so tau local steps touch only intra-slab links and the
    round-boundary client reduction is the sole cross-slab collective.
    ``dm = 1`` is the degenerate mesh: the 1D ``shard_map`` engine. Ranks
    beyond ``dc * dm`` stay out of the mesh."""
    dc, dm = int(mesh_shape[0]), int(mesh_shape[1])
    if dc < 1 or dm < 1:
        raise ValueError(f"mesh_shape must be two positive ints, "
                         f"got {mesh_shape!r}")
    ensure_world()
    if dc * dm > world_size():
        raise ValueError(f"mesh_shape {(dc, dm)} needs {dc * dm} ranks, "
                         f"only {world_size()} available")
    grid = np.arange(dc * dm).reshape(dc, dm)
    return _device_mesh(grid, (CLIENT_AXIS, MODEL_AXIS))


def production_mesh_axes(multi_pod: bool = False) -> dict[str, int]:
    """The JAX package's production mesh as ``{axis: size}``: 16x16
    ("data", "model"), or 2x16x16 ("pod", "data", "model") with
    ``multi_pod``."""
    return ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})


def federated_mesh_axes(axes: dict[str, int],
                        n_clients: int) -> dict[str, int]:
    """The ``("client", "replica", "model")`` view of a mesh given as
    ``{axis: size}`` (:func:`make_federated_mesh`'s, without ranks)."""
    model = axes[MODEL_AXIS]
    total = int(np.prod(list(axes.values()))) // model
    if total % n_clients:
        raise ValueError(f"{n_clients} clients do not divide {total} "
                         "data-parallel slots")
    return {"client": n_clients, "replica": total // n_clients,
            MODEL_AXIS: model}


def serving_mesh_axes(axes: dict[str, int]) -> dict[str, int]:
    """The ``("data", "model")`` view of a mesh given as ``{axis: size}``
    (:func:`make_serving_mesh`'s, without ranks: a pod axis folded into
    data)."""
    model = axes[MODEL_AXIS]
    return {"data": int(np.prod(list(axes.values()))) // model,
            MODEL_AXIS: model}


def make_production_mesh(*, multi_pod: bool = False):
    """The JAX package's production mesh: 16x16 ("data", "model"), or
    2x16x16 ("pod", "data", "model") with ``multi_pod``
    (:func:`production_mesh_axes`), over a world of exactly 256 / 512
    ranks."""
    axes = production_mesh_axes(multi_pod)
    shape = tuple(axes.values())
    need = int(np.prod(shape))
    have = world_size()
    if have != need:
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{need} ranks, have {have}")
    return _device_mesh(np.arange(need).reshape(shape), tuple(axes))


def make_federated_mesh(mesh, n_clients: int):
    """("client", "replica", "model") view over ``mesh``'s ranks: the model
    axis (last dim) is kept, the leading axes regroup into client x
    replica, clients as contiguous slabs."""
    ranks = mesh.mesh.cpu().numpy()
    model = ranks.shape[-1]
    total = ranks.size // model
    if total % n_clients:
        raise ValueError(f"{n_clients} clients do not divide {total} "
                         "data-parallel slots")
    return _device_mesh(ranks.reshape(n_clients, total // n_clients, model),
                        ("client", "replica", "model"))


def make_serving_mesh(mesh):
    """("data", "model") view (a pod axis folded into data)."""
    ranks = mesh.mesh.cpu().numpy()
    return _device_mesh(ranks.reshape(-1, ranks.shape[-1]),
                        ("data", "model"))


def default_n_clients(mesh, requested: int | None = None) -> int:
    """Default federation size: 4 clients per pod, doubling with the pod
    count."""
    if requested:
        return requested
    n_pods = mesh.mesh.shape[0] if mesh.mesh.dim() == 3 else 1
    return 4 * n_pods


# ---------------------------------------------------------------------------
# N gloo ranks on this host
# ---------------------------------------------------------------------------

def _serve_rank(rank: int, n: int, store_path: str, inbox, outbox) -> None:
    """One rank of a :class:`HostWorld`: join the world, then run each
    call from ``inbox`` until ``None`` arrives."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n),
                            rank=rank, world_size=n,
                            timeout=timedelta(seconds=WORLD_TIMEOUT_S))
    try:
        while True:
            call = inbox.get()
            if call is None:
                break
            fn, args, kwargs = call
            try:
                outbox.put((rank, True, fn(*args, **kwargs)))
            except Exception:                 # noqa: BLE001 — sent home
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class HostWorld:
    """N gloo ranks on this host, started once and reused: ``run(fn, ...)``
    calls ``fn(*args, **kwargs)`` on every rank (the SPMD program) and
    returns the ranks' results in rank order. ``fn`` and its arguments are
    pickled (a module-level function); the ranks start by ``spawn``, so they
    import only what ``fn`` needs."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a world needs at least one rank, got {n}")
        ctx = torch.multiprocessing.get_context("spawn")
        self.n = n
        self._dir = tempfile.mkdtemp(prefix="repro_world_")
        store = os.path.join(self._dir, "store")
        self._inboxes = [ctx.SimpleQueue() for _ in range(n)]
        self._outbox = ctx.Queue()
        self._procs = [ctx.Process(target=_serve_rank, daemon=True,
                                   args=(r, n, store, self._inboxes[r],
                                         self._outbox))
                       for r in range(n)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, **kwargs) -> list:
        """Every rank's ``fn(*args, **kwargs)``, in rank order. At the first
        rank that raises (or no answer within twice the world's timeout)
        the world is closed at once, its ranks killed where they wait (in
        a collective with the failed rank, say), and the error raised."""
        if self._procs is None:
            raise RuntimeError("this HostWorld is closed")
        for box in self._inboxes:
            box.put((fn, args, kwargs))
        results, error = [None] * self.n, None
        try:
            for _ in range(self.n):
                rank, ok, value = self._outbox.get(
                    timeout=2 * WORLD_TIMEOUT_S)
                if not ok:
                    error = f"rank {rank}:\n{value}"
                    break
                results[rank] = value
        except queue.Empty:
            error = f"no answer within {2 * WORLD_TIMEOUT_S} s"
        if error is not None:
            self.close(force=True)
            raise RuntimeError(f"a HostWorld call failed\n{error}")
        return results

    def close(self, force: bool = False) -> None:
        if self._procs is None:
            return
        if force:
            for p in self._procs:
                p.terminate()
        else:
            for box in self._inboxes:
                box.put(None)
        for p in self._procs:
            p.join(timeout=5 if force else 60)
            if p.is_alive():
                p.kill()
                p.join()
        self._procs = None
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "HostWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close(force=exc[0] is not None)


def run_on_host_world(n: int, fn, *args, **kwargs) -> list:
    """``fn(*args, **kwargs)`` on each rank of a fresh ``HostWorld(n)``;
    the ranks' results in rank order."""
    with HostWorld(n) as world:
        return world.run(fn, *args, **kwargs)
