"""repro_torch.sim — the executable virtual chip, ported (mirrors
``repro.sim``).

Modules:
  placer   NetworkMap + layer params -> stacked conductance tiles per stage
  noc      static routing schedule model, per-link cycle/bit counters (copy)
  chip     VirtualChip: infer / pipelined streaming / train_step + counters
  report   SimReport: counters -> time/energy, hw_model cross-validation
           (copy)

Each stage's phase runs as ONE launch of a hand-written kernel over its
core stack (the forward plus one for a Fig.-14 aggregation stage; the
backward; the pulse update).  The compiled
executor, StageStacks, faults, the farm and the pipeline fabric wait for
later slices (ROADMAP Queue 1).
"""
from repro_torch.sim.chip import VirtualChip  # noqa: F401
from repro_torch.sim.placer import Placement, place_network  # noqa: F401
from repro_torch.sim.report import SimReport  # noqa: F401
