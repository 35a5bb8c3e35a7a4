"""The serving launcher on two ranks serves MQA: ``python -m
repro_torch.launch.serve --arch granite-20b --smoke --env-profile cpu-mesh
--host-devices 2`` (the serving mesh (1, 2), the one KV head whole on
each rank) prints the one-rank run's tokens, in the engine mode (whole
paged pools) and with ``--static`` (the decode cache's sequence split over
the two ranks)."""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import pytest
from test_torch_serve_mesh_launch import _launch, _one_rank


@pytest.mark.parametrize("mode", [[], ["--static"]])
def test_launcher_serves_mqa_on_two_ranks(mode):
    argv = ["--arch", "granite-20b", "--smoke", "--device", "cpu",
            "--batch", "2", "--requests", "3", "--prompt-len", "8", "--gen",
            "4", "--block-size", "4"] + mode
    want = _one_rank(argv)
    got, stdout = _launch(argv + ["--env-profile", "cpu-mesh",
                                  "--host-devices", "2"])
    assert stdout.count('"sample"') == 1             # rank 0 prints alone
    assert got["mesh_shape"] == [1, 2]
    assert got["mode"] == want["mode"]
    assert got["sample"] == want["sample"] and len(got["sample"]) == 4
