"""Elastic scaling + straggler mitigation (simulated; a copy of
``repro.train.elastic``, pure Python, kept here so that the port imports
nothing of the reference), and ``remesh``, the restore its re-mesh
action calls for.

The controller implements the policy layer the launcher uses:
  * heartbeat registry with a deadline -- hosts that miss it are `suspect`,
  * straggler mitigation: a step that exceeds `straggler_factor` x the
    trailing-median step time marks the slowest host and (policy) either
    reassigns its data shard or triggers a re-mesh,
  * re-mesh: on confirmed loss, pick the (pod, data, model) factorisation
    of the survivors (``launch.mesh.make_mesh_for``), restore the latest
    checkpoint resharded onto the new mesh and resume (``remesh``): the
    parameters and the optimizer state are FSDP-sharded, so any mesh whose
    axes divide them works.  For the serving-side index the same plan
    drives ``core.persist.restore_sharded`` onto the survivor count
    (elastic N->M reshard, no rebuild),
  * rejoin: a host that resumes heartbeating after removal re-registers --
    that is a topology change like a loss, so the next ``plan()`` bumps the
    generation and reports ``action: "remesh"`` upward (never a silent
    no-op).
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field


@dataclass
class HostState:
    last_heartbeat: float
    step_times: list = field(default_factory=list)


@dataclass
class ElasticController:
    n_hosts: int
    heartbeat_timeout: float = 60.0
    straggler_factor: float = 2.0
    clock: callable = time.monotonic
    hosts: dict = None
    generation: int = 0            # bumps on every re-mesh
    _rejoined: set = field(default_factory=set)   # since the last plan()

    def __post_init__(self):
        now = self.clock()
        self.hosts = {h: HostState(now) for h in range(self.n_hosts)}

    # -- signals -----------------------------------------------------------
    def heartbeat(self, host: int, step_time: float | None = None):
        st = self.hosts.get(host)
        if st is None:
            # A removed (or brand-new) host resuming heartbeats rejoins the
            # registry; the topology change surfaces from the next plan().
            st = self.hosts[host] = HostState(self.clock())
            self._rejoined.add(host)
        st.last_heartbeat = self.clock()
        if step_time is not None:
            st.step_times.append(step_time)
            st.step_times = st.step_times[-32:]

    # -- queries -------------------------------------------------------------
    def dead_hosts(self) -> list:
        now = self.clock()
        return [h for h, st in self.hosts.items()
                if now - st.last_heartbeat > self.heartbeat_timeout]

    def stragglers(self) -> list:
        """Hosts whose median step time exceeds ``straggler_factor`` x the
        fleet median -- computed over *live* hosts only: a host past the
        heartbeat deadline is a loss for ``plan()`` to handle, and its stale
        step times must not skew (or land it in) the straggler set."""
        now = self.clock()
        meds = {h: statistics.median(st.step_times)
                for h, st in self.hosts.items()
                if len(st.step_times) >= 4
                and now - st.last_heartbeat <= self.heartbeat_timeout}
        if len(meds) < 2:
            return []
        global_med = statistics.median(meds.values())
        return [h for h, m in meds.items()
                if m > self.straggler_factor * global_med]

    # -- actions -------------------------------------------------------------
    def plan(self) -> dict:
        """Returns the action the launcher should take this round."""
        dead = self.dead_hosts()
        rejoined = sorted(self._rejoined - set(dead))
        self._rejoined.clear()
        if dead or rejoined:
            for h in dead:
                del self.hosts[h]
            self.generation += 1
            return {"action": "remesh", "survivors": len(self.hosts),
                    "generation": self.generation, "rejoined": rejoined}
        slow = self.stragglers()
        if slow:
            return {"action": "reassign_data", "hosts": slow}
        return {"action": "none"}


def remesh(ckpt, template, specs, survivors: int, *, model_parallel: int = 16,
           devices=None):
    """The re-mesh of a ``plan()`` that says ``remesh``: the mesh of
    ``survivors`` positions (``launch.mesh.make_mesh_for``) and the latest
    checkpoint's state restored onto it, cut by ``specs``
    (``train.checkpoint.Checkpointer.restore(mesh=, specs=)``).  Returns
    (mesh, the positions' trees)."""
    from ..launch.mesh import make_mesh_for
    mesh = make_mesh_for(survivors, model_parallel=model_parallel,
                         devices=devices)
    return mesh, ckpt.restore(ckpt.latest_step(), template, mesh=mesh,
                              specs=specs)
