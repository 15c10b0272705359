"""repro_torch.sim — the executable virtual chip, ported (mirrors
``repro.sim``).

Modules:
  placer    NetworkMap + layer params -> stacked conductance tiles per
            stage; StageStacks (the padded envelope, with a chip axis for
            the farm) and sub_placement
  noc       static routing schedule model, per-link cycle/bit counters (copy)
  chip      VirtualChip: infer / pipelined streaming / train_step + counters
  compiled  the compiled executor: one program per (topology, shapes), a
            captured CUDA graph on the card — chip and farm wave and step,
            and the farm's serving beat
  report    SimReport: counters -> time/energy, hw_model cross-validation
            (copy)
  faults    memristor stuck-on/stuck-off masks + per-core variation
            injection
  cluster   ChipFarm / FarmServer: N-chip data-parallel farm + serving
            front-end, host-link accounting
  fabric    ChipPipeline / PipelineServer / PipelineFarm: a network split
            across chips (pipeline parallel) + inter-chip link accounting

Each stage's phase runs as ONE launch of a hand-written kernel over its
core stack — a farm's over every chip's cores, the chip axis folded into
the stack: compiled, one forward launch per stage and one fused training
launch per stage (a farm: one bwd and one dw launch, reconciled); eager
(``compiled=False``), the forward plus one for a Fig.-14 aggregation
stage, the backward and the pulse update (a farm: the dw).  A pipeline's
chip slices run the same programs on their own stage slices.
"""
from repro_torch.sim.chip import VirtualChip  # noqa: F401
from repro_torch.sim.cluster import ChipFarm, FarmServer, build_farm  # noqa: F401
from repro_torch.sim.fabric import (ChipPipeline, PipelineFarm,  # noqa: F401
                                    PipelineServer, build_pipeline)
from repro_torch.sim.faults import inject_faults  # noqa: F401
from repro_torch.sim.placer import (Placement, StageStacks,  # noqa: F401
                                    build_stage_stacks, place_network)
from repro_torch.sim.report import FarmReport, SimReport  # noqa: F401
