"""Device-fault injection into the virtual chip's conductance stacks (port
of ``repro.sim.faults``).

Layers `runtime.faults.MemristorFaults` (deterministic stuck-on/stuck-off
masks + per-core variation) onto a `Placement`: every main-grid core stack
gets its own seeded fault pattern (salted by stage index and by which side
of the differential pair it is), so the same chip always breaks the same
devices.  Aggregation cores are left ideal — they carry routing-sum unit
conductances, part of the interconnect fabric rather than programmable
weight storage.

Faulted conductances flow everywhere the stacks flow: inference, the
backward error transport and the pulse updates, which cannot heal a stuck
device — `reapply` re-asserts the masks after every update.

`inject_faults` builds a new placement (fresh tensors).  `reapply` writes
the stuck values IN PLACE into the stage tensors and bumps
``placement.version``: a stage's tensors may be views of a `StageStacks`
envelope that other views (``sub_placement``, the compiled envelope) share,
and an in-place write keeps every one of them consistent.
"""
from __future__ import annotations

import dataclasses

from repro_torch.runtime.faults import MemristorFaults
from repro_torch.sim.placer import Placement


def _stage_salts(index: int) -> tuple[int, int]:
    return 2 * index, 2 * index + 1


def inject_faults(placement: Placement, faults: MemristorFaults,
                  w_max: float = 1.0) -> Placement:
    """Return a placement whose main-grid stacks carry the fault overlay:
    per-core fabrication variation (applied once, here) plus the stuck
    masks.  A null fault model returns ``placement`` itself."""
    if faults.is_null:
        return placement
    stages = []
    for st in placement.stages:
        sp, sm = _stage_salts(st.index)
        stages.append(dataclasses.replace(
            st, g_plus=faults.apply(st.g_plus, salt=sp, w_max=w_max),
            g_minus=faults.apply(st.g_minus, salt=sm, w_max=w_max)))
    return dataclasses.replace(placement, stages=stages)


def reapply(placement: Placement, faults: MemristorFaults,
            w_max: float = 1.0) -> Placement:
    """Re-assert the stuck masks after training wrote new conductances
    (pulse updates cannot move a stuck device), in place.  Same masks as
    `inject_faults` — a pure function of (seed, stage, shape) — but
    without re-scaling by the fabrication variation, so the call is
    idempotent.  `VirtualChip.train_step` does this itself for chips built
    with faults.  Returns ``placement``."""
    if faults.is_null:
        return placement
    for st in placement.stages:
        sp, sm = _stage_salts(st.index)
        st.g_plus.copy_(faults.apply(st.g_plus, salt=sp, w_max=w_max,
                                     variation=False))
        st.g_minus.copy_(faults.apply(st.g_minus, salt=sm, w_max=w_max,
                                      variation=False))
    placement.version += 1
    return placement
