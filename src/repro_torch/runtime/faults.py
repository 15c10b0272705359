"""Fault-tolerance primitives: preemption, stragglers, device faults (port
of ``repro/runtime/faults.py``).

`SimulatedPreemption`, `FaultInjector` and `StragglerWatchdog` are the
train loop's hooks (the tests exercise a kill and a bit-for-bit resume);
`StepTimer` times a step on the host clock, waiting for the CUDA device
first where the step ran there (the card runs asynchronously).

`MemristorFaults` models stuck-on/stuck-off memristor fractions and
per-core conductance variation as deterministic seeded masks.  The virtual
chip (`repro_torch.sim.faults`) layers them into its stacked conductance
arrays to measure accuracy against fault rate;
``examples/torch_fault_sweep.py`` runs the sweep.

The reference draws its masks with ``jax.random``; the port draws them
from a ``torch.Generator`` on the CPU, so the two streams differ and the
parity tests hand the reference's masks to the port (a subclass overriding
`MemristorFaults.masks` and `MemristorFaults.core_scales`).
"""
from __future__ import annotations

import dataclasses
import time

import torch

_MIX = 0x9E3779B97F4A7C15        # 2^64 / golden ratio, odd
_SCALE_SALT = 1_000_003          # the reference's offset of the scale stream


def _generator(seed: int, salt: int) -> torch.Generator:
    """A CPU generator seeded with ``(seed * 0x9E3779B97F4A7C15 + salt)
    mod 2^64``: one stream per (seed, salt)."""
    return torch.Generator().manual_seed((seed * _MIX + salt) % 2 ** 64)


class SimulatedPreemption(Exception):
    """Raised by the train loop when a fault injector fires."""


@dataclasses.dataclass
class FaultInjector:
    """Deterministically preempt at a given step (tests/examples)."""
    preempt_at_step: int | None = None

    def check(self, step: int) -> None:
        if self.preempt_at_step is not None and step == self.preempt_at_step:
            raise SimulatedPreemption(f"simulated preemption at step {step}")


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps slower than ``threshold`` x the running median of the
    last ``window`` steps (once 8 are seen), recording (step, dt, median)
    in ``events``."""
    threshold: float = 3.0
    window: int = 32
    _times: list[float] = dataclasses.field(default_factory=list)
    events: list[tuple[int, float, float]] = dataclasses.field(
        default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self._times.append(dt)
        self._times = self._times[-self.window:]
        med = sorted(self._times)[len(self._times) // 2]
        if len(self._times) >= 8 and dt > self.threshold * med:
            self.events.append((step, dt, med))
            return True
        return False


class StepTimer:
    """``with StepTimer(device) as t: ...`` leaves the seconds in ``t.dt``.
    On a CUDA device it synchronizes before each clock read, so ``dt``
    covers the device's work and not only its enqueueing."""

    def __init__(self, device: str | torch.device | None = None):
        self.cuda = device is not None and torch.device(device).type == "cuda"

    def _clock(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    def __enter__(self):
        self.t0 = self._clock()
        return self

    def __exit__(self, *exc):
        self.dt = self._clock() - self.t0
        return False


@dataclasses.dataclass(frozen=True)
class MemristorFaults:
    """Deterministic memristor-level fault model (seeded).

    ``stuck_on``/``stuck_off`` are independent per-device probabilities: a
    stuck-on cell reads the maximum conductance (``w_max`` in weight
    units), a stuck-off cell reads zero, regardless of what was
    programmed.  ``variation_sigma`` adds per-core multiplicative lognormal
    conductance spread (process variation between fabricated cores).

    Masks are pure functions of ``(seed, salt, shape)``, drawn on the CPU
    from a generator seeded with ``(seed * 0x9E3779B97F4A7C15 + salt) mod
    2^64`` (the stuck-on uniforms first, then the stuck-off ones); the
    per-core scales from the one seeded with ``salt + 1_000_003``.  They
    are moved to the conductances' device afterwards, so the same chip
    breaks the same devices on the CPU and on the card.
    """
    stuck_on: float = 0.0
    stuck_off: float = 0.0
    variation_sigma: float = 0.0
    seed: int = 0

    @property
    def is_null(self) -> bool:
        return (self.stuck_on == 0.0 and self.stuck_off == 0.0
                and self.variation_sigma == 0.0)

    def masks(self, shape: tuple[int, ...], salt: int = 0
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """(stuck_on_mask, stuck_off_mask) boolean CPU tensors for one
        conductance array.  Overlaps resolve stuck-off wins (an open
        filament cannot conduct)."""
        gen = _generator(self.seed, salt)
        u_on = torch.rand(shape, generator=gen)
        u_off = torch.rand(shape, generator=gen)
        off = u_off < self.stuck_off
        on = (u_on < self.stuck_on) & ~off
        return on, off

    def core_scales(self, n_cores: int, salt: int = 0) -> torch.Tensor:
        """Per-core lognormal conductance scale factors (n_cores,) fp32, on
        the CPU."""
        if self.variation_sigma == 0.0:
            return torch.ones(n_cores)
        gen = _generator(self.seed, _SCALE_SALT + salt)
        return torch.exp(self.variation_sigma
                         * torch.randn(n_cores, generator=gen))

    def apply(self, g: torch.Tensor, salt: int = 0, w_max: float = 1.0, *,
              variation: bool = True) -> torch.Tensor:
        """Overlay the fault pattern on a conductance array (a new tensor
        on ``g``'s device).

        ``g`` is (rows, cols) or a (cores, rows, cols) stack; per-core
        variation applies along the leading stack axis, clipped to the
        physical conductance range.  Pass ``variation=False`` when
        *re-asserting* stuck masks on already-fabricated (already-scaled)
        conductances — the stuck overlay is idempotent, the fabrication
        scaling is not."""
        if variation and self.variation_sigma > 0.0 and g.dim() == 3:
            scales = self.core_scales(g.shape[0], salt).to(g)
            g = torch.clamp(g * scales[:, None, None], 0.0, w_max)
        on, off = (m.to(g.device) for m in self.masks(tuple(g.shape), salt))
        g = torch.where(on, torch.full_like(g, w_max), g)
        return torch.where(off, torch.zeros_like(g), g)
