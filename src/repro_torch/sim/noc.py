"""NoC model: the static 2D routing network between neural cores.

Section V.C: neuron outputs leave a core as 3-bit ADC codes and travel over
8-bit links under a *compile-time static* routing schedule at 200 MHz; one
output crosses one link per cycle.  The schedule slot of a pipeline beat is
``cols`` cycles long — the time for a full core to drain its (up to)
``cols`` neuron outputs — which is why the paper's Table IV recognition
beat is a uniform 0.27 us (crossbar) + 100/200 MHz = 0.77 us for every
application.

This module only *counts*: the chip records every inter-stage transport
here (how many outputs, over how many emitting links, for how many
samples), and the report derives routing time, link utilization, and
transported bits from the counters.  The aggregate `route_us` uses the same
convention as the analytic model (`hw_model`: all routed outputs serialized
at one per cycle), which is what the sim<->hw_model cross-validation
contract pins (DESIGN.md "Virtual chip").
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.hw_model import LINK_BITS, ROUTING_CLOCK_HZ, ADC_BITS_OUT


@dataclasses.dataclass
class LinkRecord:
    """One stage's egress traffic: ``outputs`` neuron outputs per sample,
    fanned over ``links`` outbound core links."""
    stage: int
    outputs: int          # per-sample neuron outputs crossing the network
    links: int            # emitting cores (one outbound link each)
    samples: int          # samples transported

    @property
    def cycles_per_link(self) -> int:
        """Per-sample cycles the busiest link of this stage is driven."""
        return -(-self.outputs // self.links)


@dataclasses.dataclass
class NocTracker:
    """Per-link cycle counters for the static routing schedule."""
    clock_hz: float = ROUTING_CLOCK_HZ
    link_bits: int = LINK_BITS
    code_bits: int = ADC_BITS_OUT
    slot_cycles: int = 100           # schedule slot: cols cycles per beat
    records: list[LinkRecord] = dataclasses.field(default_factory=list)

    def record(self, stage: int, outputs: int, links: int,
               samples: int) -> None:
        self.records.append(LinkRecord(stage, outputs, links, samples))

    # ---- per-sample aggregates (counters -> model quantities) -----------

    @property
    def routed_outputs(self) -> int:
        """Total outputs routed (summed over stages and samples)."""
        return sum(r.outputs * r.samples for r in self.records)

    def routed_outputs_per_sample(self, n_samples: int) -> float:
        return self.routed_outputs / max(n_samples, 1)

    def route_us_per_sample(self, n_samples: int) -> float:
        """hw_model convention: one output per cycle, serialized."""
        return (self.routed_outputs_per_sample(n_samples)
                / self.clock_hz * 1e6)

    @property
    def max_link_cycles(self) -> int:
        """Busiest per-link drain of any stage (bounds the pipeline beat)."""
        return max((r.cycles_per_link for r in self.records), default=0)

    @property
    def slot_us(self) -> float:
        """Static-schedule slot length: the routing phase of one beat."""
        return self.slot_cycles / self.clock_hz * 1e6

    @property
    def link_utilization(self) -> float:
        """Payload cycles used / slot cycles reserved, worst-stage links."""
        used = sum(r.cycles_per_link * r.samples for r in self.records)
        total = sum(self.slot_cycles * r.samples for r in self.records)
        return used / total if total else 0.0

    @property
    def payload_bits(self) -> int:
        """ADC-code payload actually carried (3 bits per output)."""
        return self.routed_outputs * self.code_bits

    @property
    def capacity_bits(self) -> int:
        """Link-cycles consumed x 8-bit link width."""
        return self.routed_outputs * self.link_bits

    def reset(self) -> None:
        self.records.clear()
