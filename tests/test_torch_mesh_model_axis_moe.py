"""The MoE FFN (phi3.5-moe; llama4-maverick with its shared expert and its
chunked / NoPE attention layers) on the model axis of the port's
``mesh_2d`` engine (``dm > 1``: expert parallelism), against the JAX
package, in one gloo world of 4 ranks started once for the module.

* Placement: the routed experts split on the expert axis (their use-site
  hints), the router whole, llama4's shared expert as the dense MLP, the
  attention on heads.
* The round: each smoke variant (4 experts, 2 a rank) as ``mesh_2d``
  (1, 2) and (2, 2) against JAX's ``vmap`` round: params within 2e-5 of
  each tensor's largest magnitude, loss gradients within 4e-5, the Eq.-7a
  pre-clip norm within 1e-6, whole leaves (the router among them) equal
  on every model rank. phi3.5 runs at capacity factor 1.0 (8 slots an
  expert for 32 assignments over 4 experts), so assignments are dropped
  and the capacity must come from the whole expert count.
* ``engine="auto"`` with the phi3.5 replica's bytes over the device
  budget resolves to ``mesh_2d`` (2, 2) on the four ranks and runs a
  round equal to JAX's ``vmap``.
"""
from dataclasses import replace

import _torch_threads  # noqa: F401  (one torch thread a worker)
import pytest
from _torch_model_axis_jax import placement_matches_jax, round_matches_jax

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke_variant
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.launch.mesh import HostWorld

PHI, LLAMA = "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"


@pytest.fixture(scope="module")
def world():
    w = HostWorld(4)
    yield w
    w.close()


def _cfgs(arch):
    """The arch's smoke variant; phi3.5's at capacity factor 1.0 (drops)."""
    out = []
    for get, smoke in ((jax_get_arch, jax_smoke_variant),
                       (get_arch, smoke_variant)):
        cfg = smoke(get(arch))
        out.append(replace(cfg, capacity_factor=1.0) if arch == PHI
                   else cfg)
    return tuple(out)


@pytest.mark.parametrize("arch", [PHI, LLAMA])
def test_moe_placement_matches_jax_hints(arch):
    dims, hints = placement_matches_jax(*_cfgs(arch))
    assert {k for m, k in hints if m == "repro.models.moe"} == {
        "w_gate", "w_up", "w_down"}
    for j, layer in dims["segments"][0].items():
        ffn = layer["ffn"]
        if "router" not in ffn:
            continue
        assert ffn["router"] == -1
        assert {k: ffn[k] - 1 for k in ("w_gate", "w_up", "w_down")} == \
            dict.fromkeys(("w_gate", "w_up", "w_down"), 0)
        if arch == LLAMA:
            assert {k: d - 1 for k, d in ffn["shared"].items()} == {
                "w_gate": 1, "w_up": 1, "w_down": 0}
        else:
            assert "shared" not in ffn


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", [PHI, LLAMA])
def test_moe_round_matches_jax(world, arch, mesh_shape):
    round_matches_jax(world, arch, *_cfgs(arch), mesh_shape)


def test_auto_over_budget_moe_replica_splits_its_experts(world):
    """phi3.5's smoke replica (its f32 params' bytes as the hint) over a
    budget of 0.6 of it: engine='auto' resolves to mesh_2d (2, 2) on the
    four ranks (two ranks split each replica) and its round equals JAX's
    vmap round."""
    r0 = round_matches_jax(world, PHI, *_cfgs(PHI), None, budget_share=0.6)
    assert r0["engine"] == "mesh_2d" and r0["mesh_shape"] == (2, 2)
