"""One serving clock for every rank of a serving mesh.

Every rank of the mesh runs the scheduler's loop (``serve_continuous``,
``serve_static``) and each turn's collectives must be alike on every rank.
Under the default wall clock each rank once charged its own measured
seconds of work, so under load two ranks could admit a request at
different turns, one running a prefill's collectives while the other ran
a decode step's. Now both drivers charge every rank the largest of the
ranks' measured times.

Here two gloo ranks on the mesh (1, 2) serve one Poisson workload through
a host-only engine and the static driver, their measured times set 100x
apart (rank 0 0.01 s a unit of work, rank 1 1.0 s): their admissions,
steps, emission times and finishes are equal, and charged at rank 1's
seconds. Outside a mesh the clock is each process's own.
"""
import _torch_threads  # noqa: F401  (one torch thread a worker)
import _torch_world_cases as cases
import pytest

from repro_torch.configs import get_arch, smoke_variant
from repro_torch.launch.mesh import HostWorld
from repro_torch.serve import poisson_workload, scheduler


@pytest.fixture(scope="module")
def world():
    w = HostWorld(2)
    yield w
    w.close()


def test_ranks_with_disagreeing_wall_clocks_take_one_schedule(world):
    cfg = smoke_variant(get_arch("gemma3-4b"))
    r0, r1 = world.run(cases.serve_clock_schedules, cfg, (0.01, 1.0))
    for driver in ("continuous", "static"):
        assert r0[driver] == r1[driver], driver
    # every decode step charged the slower rank's second
    steps = sum(kind == "step" for kind, _ in r0["continuous"]["log"])
    assert steps > 0 and r0["continuous"]["duration"] >= steps * 1.0


def test_outside_a_mesh_each_clock_is_its_own(monkeypatch):
    """Without a mesh the engine's measured seconds are charged as they
    are: the same workload at 0.01 s and at 1.0 s a unit of work schedules
    differently (what two ranks of a mesh did before)."""
    cfg = smoke_variant(get_arch("gemma3-4b"))
    logs = []
    for dt in (0.01, 1.0):
        monkeypatch.setattr(scheduler, "time", cases._Ticks(dt))
        engine = cases._HostEngine(None)
        wl = poisson_workload(8, 4.0, cfg.vocab, seed=1, prompt_lens=(4,),
                              gen_lens=(2, 3))
        scheduler.serve_continuous(engine, wl)
        logs.append(engine.log)
    assert logs[0] != logs[1]
