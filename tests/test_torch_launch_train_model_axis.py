"""The port's training launcher on the model axis for the RWKV6, zamba2
and MoE archs: ``--engine mesh_2d --mesh-shape 1,2`` under the cpu-mesh
profile (two gloo ranks splitting each replica) against the same argv on
``--engine vmap`` in this process. The params come from the same seed in
both, so besides the rounds, epsilon and cost (exact) the final loss
agrees within 2e-5 of its magnitude.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import pytest
from test_torch_launch_train import SUMMARY_KEYS, _launch, _run

from repro_torch.launch import train as ttrain


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_model_axis_launch_on_two_ranks_equals_vmap(arch, monkeypatch):
    argv = ["--arch", arch, "--smoke", "--rounds", "2", "--clients", "2",
            "--tau", "1", "--batch", "1", "--seq", "16", "--device", "cpu"]
    monkeypatch.setenv("REPRO_ENV_PROFILE_APPLIED", "1")   # no re-exec
    want, _ = _run(ttrain.main, argv + ["--engine", "vmap"])
    got, stdout = _launch(argv + ["--engine", "mesh_2d", "--mesh-shape",
                                  "1,2", "--env-profile", "cpu-mesh",
                                  "--host-devices", "2"])
    assert "[env] profile cpu-mesh applied" in stdout
    assert stdout.count('"rounds"') == 1             # rank 0 prints alone
    assert {k: got[k] for k in SUMMARY_KEYS} == \
        {k: want[k] for k in SUMMARY_KEYS}
    assert got["rounds"] == 2
    assert abs(got["final_loss"] - want["final_loss"]) <= 2e-5 * max(
        1.0, abs(want["final_loss"]))
