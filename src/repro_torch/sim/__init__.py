"""repro_torch.sim — the executable virtual chip, ported (mirrors
``repro.sim``).

Modules:
  placer    NetworkMap + layer params -> stacked conductance tiles per
            stage; StageStacks (the padded envelope) and sub_placement
  noc       static routing schedule model, per-link cycle/bit counters (copy)
  chip      VirtualChip: infer / pipelined streaming / train_step + counters
  compiled  the compiled executor: one program per (topology, batch), a
            captured CUDA graph on the card
  report    SimReport: counters -> time/energy, hw_model cross-validation
            (copy)

Each stage's phase runs as ONE launch of a hand-written kernel over its
core stack: compiled, one forward launch per stage and one fused training
launch per stage; eager (``compiled=False``), the forward plus one for a
Fig.-14 aggregation stage, the backward and the pulse update.  Faults,
the farm and the pipeline fabric wait for later slices (ROADMAP Queue 1).
"""
from repro_torch.sim.chip import VirtualChip  # noqa: F401
from repro_torch.sim.placer import Placement, place_network  # noqa: F401
from repro_torch.sim.report import SimReport  # noqa: F401
