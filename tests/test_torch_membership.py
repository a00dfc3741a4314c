"""The port's membership service against the JAX package's.

The four membership scenarios of the JAX package's coordination tests
(join/leave/heartbeat eviction, takeover after a crash and restart, a
double join, and the eviction-versus-rejoin race), its mesh generation,
and one round of the watch-driven re-mesh loop run on each package's
``MembershipService`` over its own ``FaaSKeeperService`` with the same
``SimCloud`` seed.  Each side must hold the scenario's own expectations,
and the two must observe the same members, mesh configs and virtual times
at every step.
"""

from __future__ import annotations

import pytest

import repro.coord as ref_coord
import repro.core as ref_core
import repro_torch.coord as port_coord
import repro_torch.core as port_core


def _service(core, seed=0):
    cloud = core.SimCloud(seed=seed)
    return cloud, core.FaaSKeeperService(cloud, regions=("region-0",))


def join_leave_evict(core, coord, seen):
    cloud, svc = _service(core)
    mem = coord.MembershipService(svc)
    h = [mem.join(f"w{i}") for i in range(3)]
    seen(sorted(mem.members()), cloud.now)
    assert sorted(mem.members()) == ["w0", "w1", "w2"]
    mem.leave(h[0])
    assert sorted(mem.members()) == ["w1", "w2"]
    mem.members(watch=True)
    mem.fail(h[1])
    svc.start_heartbeat(period=5.0, max_runs=3)
    cloud.run()
    seen(mem.members(), cloud.now)
    assert mem.members() == ["w2"]


def takeover_after_crash_restart(core, coord, seen):
    cloud, svc = _service(core)
    mem = coord.MembershipService(svc)
    h_old = mem.join("w0")
    mem.fail(h_old)
    h_new = mem.join("w0")
    seen(mem.members(), cloud.now)
    assert mem.members() == ["w0"]
    svc.start_heartbeat(period=5.0, max_runs=3)
    cloud.run()
    seen(mem.members(), cloud.now)
    assert mem.members() == ["w0"]
    mem.leave(h_new)
    assert mem.members() == []


def double_join(core, coord, seen):
    cloud, svc = _service(core)
    mem = coord.MembershipService(svc)
    h1 = mem.join("w0")
    h2 = mem.join("w0")
    assert mem.members() == ["w0"]
    mem.leave(h1)
    assert mem.members() == []
    mem.leave(h2)
    seen(mem.members(), cloud.now)
    assert mem.members() == []


def eviction_vs_rejoin_race(core, coord, seen):
    cloud, svc = _service(core)
    mem = coord.MembershipService(svc)
    h_old = mem.join("w0")
    mem.join("w1")
    mem.fail(h_old)
    svc.start_heartbeat(period=5.0, max_runs=2)
    h_new = mem.join("w0")
    cloud.run()
    seen(sorted(mem.members()), cloud.now)
    assert sorted(mem.members()) == ["w0", "w1"]
    mem.leave(h_new)
    assert mem.members() == ["w1"]


def mesh_generation(core, coord, seen):
    cloud, svc = _service(core)
    mem = coord.MembershipService(svc)
    for i in range(4):
        mem.join(f"w{i}")
    g1 = mem.propose_mesh(4, model_parallel=2)
    g2 = mem.propose_mesh(4, model_parallel=4)
    seen(g1, g2, mem.current_mesh(), cloud.now)
    assert g2["generation"] == g1["generation"] + 1
    assert mem.current_mesh()["mesh"] == [1, 4]


def remesh_loop(core, coord, seen):
    """A watched membership change (a heartbeat eviction) republishes the
    mesh for the survivors."""
    cloud, svc = _service(core, seed=5)
    mem = coord.MembershipService(svc)
    handles = [mem.join(f"w{i}") for i in range(4)]
    mem.members(watch=True)
    mem.fail(handles[3])
    svc.start_heartbeat(period=5.0, max_runs=2)
    got = []
    gens = coord.membership.elastic_remesh_loop(mem, model_parallel=1, on_remesh=got.append)
    seen(gens, got, mem.members(), cloud.now)
    assert gens == got and gens[0]["workers"] == 3 and gens[0]["mesh"] == [3, 1]


SCENARIOS = [join_leave_evict, takeover_after_crash_restart, double_join,
             eviction_vs_rejoin_race, mesh_generation, remesh_loop]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[f.__name__ for f in SCENARIOS])
def test_membership_matches_the_reference(scenario):
    ref, port = [], []
    scenario(ref_core, ref_coord, lambda *xs: ref.append(xs))
    scenario(port_core, port_coord, lambda *xs: port.append(xs))
    assert port == ref and ref
