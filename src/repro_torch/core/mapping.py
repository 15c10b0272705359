"""Multicore mapper: assign network layers to 400x100 neural cores.

Implements section V.B "Mapping Neural Networks to Cores":

  * a layer with ``fan_out`` neurons of ``fan_in`` inputs occupies
    ``ceil(fan_in/400) * ceil(fan_out/100)`` cores,
  * fan-in splits add an aggregation stage (Fig. 14): ``fan_out`` aggregation
    neurons each with ``ceil(fan_in/400)`` inputs, packed into cores,
  * layers much smaller than a core may share one core (pipelined through the
    core's routing switch loopback, Fig. 2) — ``share_small_layers=True``
    packs consecutive single-core layers into one physical core while their
    combined rows/columns fit the crossbar (this is how Table III reaches
    1 core for the 41-15-41 anomaly network),
  * routed traffic per layer = fan_out neuron outputs (ADC codes) over 8-bit
    links (section V.C).

The mapper also emits the static routing schedule length (cycles) used by the
hardware model.  This is the compile-time "who sends what when" table that,
at pod scale, becomes the XLA SPMD collective schedule (DESIGN.md section 2).

A :class:`NetworkMap` is also the placement contract consumed by the
executable virtual chip (``repro.sim``, DESIGN.md "Virtual chip"): the sim
materializes each LayerMap's ``row_tiles x col_tiles`` grid as stacked
conductance arrays and executes them as batched Pallas kernel calls.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.crossbar import CORE_COLS, CORE_ROWS


@dataclasses.dataclass(frozen=True)
class LayerMap:
    fan_in: int
    fan_out: int
    row_tiles: int          # fan-in splits (sub-neuron groups, Fig. 14)
    col_tiles: int          # fan-out splits
    cores: int              # crossbar cores for the layer itself
    agg_cores: int          # cores implementing the aggregation stage
    routed_outputs: int     # neuron outputs crossing the routing network
    shared: bool = False    # rides in the previous layer's core (loopback,
                            # Fig. 2) — contributes 0 *additional* cores

    @property
    def total_cores(self) -> int:
        """Cores the layer's phases execute on (energy accounting) —
        unchanged by sharing: a shared core runs each resident layer in
        sequence, so per-layer execution cost is identical."""
        return self.cores + self.agg_cores

    @property
    def placed_cores(self) -> int:
        """Additional physical cores the layer occupies (area/core count)."""
        return 0 if self.shared else self.total_cores


@dataclasses.dataclass(frozen=True)
class NetworkMap:
    layers: tuple[LayerMap, ...]
    cores: int
    routed_outputs: int     # per forward pass
    routing_cycles: int     # 8-bit link, one output per cycle per link


def map_layer(fan_in: int, fan_out: int, rows: int = CORE_ROWS,
              cols: int = CORE_COLS) -> LayerMap:
    fan_in = fan_in + 1  # +1 bias row (Fig. 8: "One additional input ... bias")
    row_tiles = math.ceil(fan_in / rows)
    col_tiles = math.ceil(fan_out / cols)
    cores = row_tiles * col_tiles
    agg_cores = 0
    if row_tiles > 1:
        # Aggregation neurons: fan_out neurons each taking row_tiles inputs.
        agg_cores = math.ceil(row_tiles / rows) * math.ceil(fan_out / cols)
    routed = fan_out * row_tiles if row_tiles > 1 else fan_out
    return LayerMap(fan_in - 1, fan_out, row_tiles, col_tiles, cores,
                    agg_cores, routed)


def _pack_shared(layer_maps: list[LayerMap], rows: int,
                 cols: int) -> list[LayerMap]:
    """Greedy loopback packing: consecutive single-core layers share one
    core while their combined (fan_in+1) rows and fan_out columns fit the
    crossbar.  The shared core processes the resident layers in sequence
    through the routing-switch loopback (Fig. 2), so only *area* changes;
    per-layer execution cost does not."""
    packed: list[LayerMap] = []
    used_rows = used_cols = 0
    open_group = False
    for lm in layer_maps:
        single = lm.row_tiles == 1 and lm.col_tiles == 1 and lm.agg_cores == 0
        if not single:
            packed.append(lm)
            open_group = False
            continue
        need_r, need_c = lm.fan_in + 1, lm.fan_out
        if (open_group and used_rows + need_r <= rows
                and used_cols + need_c <= cols):
            packed.append(dataclasses.replace(lm, shared=True))
            used_rows += need_r
            used_cols += need_c
        else:
            packed.append(lm)
            used_rows, used_cols = need_r, need_c
            open_group = True
    return packed


def map_network(dims: list[int], rows: int = CORE_ROWS,
                cols: int = CORE_COLS, *,
                share_small_layers: bool = False) -> NetworkMap:
    layer_maps = [map_layer(i, o, rows, cols) for i, o in zip(dims, dims[1:])]
    if share_small_layers:
        layer_maps = _pack_shared(layer_maps, rows, cols)
    cores = sum(l.placed_cores for l in layer_maps)
    routed = sum(l.routed_outputs for l in layer_maps)
    return NetworkMap(tuple(layer_maps), cores, routed, routing_cycles=routed)


def split_network(nmap: NetworkMap, *, max_cores_per_chip: int | None = None,
                  n_chips: int | None = None) -> tuple[tuple[int, ...], ...]:
    """Partition a mapped network's layers into contiguous per-chip groups.

    The pipeline-parallel fabric (``repro.sim.fabric``, DESIGN.md §7) uses
    this when a network's placed core count exceeds one chip's budget: each
    group becomes one chip's stage slice, and layer boundaries between
    groups become inter-chip link crossings.  Two modes:

      * ``max_cores_per_chip`` — greedy first-fit: open a new chip whenever
        the next layer would overflow the budget.  A loopback-shared layer
        (``LayerMap.shared``) rides in the previous layer's physical core,
        so it can never open a new chip (its placed-core cost is 0 and the
        core it shares must be on the same chip);
      * ``n_chips`` — balanced contiguous partition into exactly
        ``n_chips`` groups, minimizing the busiest chip's placed cores
        (linear-partition dynamic program).

    Returns a tuple of per-chip layer-index tuples covering ``nmap.layers``
    in order.  Raises when a single layer exceeds the budget (a stage
    cannot be split across chips — the mapper already split it into cores)
    or when ``n_chips`` exceeds the splittable group count.
    """
    if (max_cores_per_chip is None) == (n_chips is None):
        raise ValueError(
            "pass exactly one of max_cores_per_chip= or n_chips=")
    costs = [lm.placed_cores for lm in nmap.layers]
    n = len(costs)
    if max_cores_per_chip is not None:
        budget = max_cores_per_chip
        too_big = [i for i, c in enumerate(costs) if c > budget]
        if too_big:
            raise ValueError(
                f"layer(s) {too_big} exceed {budget} cores alone; a single "
                f"stage cannot be pipeline-split across chips")
        groups: list[list[int]] = [[]]
        used = 0
        for i, c in enumerate(costs):
            # a shared layer (c == 0) always stays with its host core
            if groups[-1] and c and used + c > budget:
                groups.append([])
                used = 0
            groups[-1].append(i)
            used += c
        return tuple(tuple(g) for g in groups)
    # balanced contiguous K-way partition (classic linear-partition DP on
    # prefix sums); shared layers glue to the preceding layer first so no
    # group boundary can separate a loopback-shared layer from its host.
    blocks: list[list[int]] = []
    for i, c in enumerate(costs):
        if blocks and c == 0 and nmap.layers[i].shared:
            blocks[-1].append(i)
        else:
            blocks.append([i])
    k = n_chips
    if not 1 <= k <= len(blocks):
        raise ValueError(f"cannot split {len(blocks)} placeable stage "
                         f"groups over {k} chips")
    bcost = [sum(costs[i] for i in b) for b in blocks]
    nb = len(blocks)
    prefix = [0]
    for c in bcost:
        prefix.append(prefix[-1] + c)
    INF = float("inf")
    # best[j][i]: minimal max-group cost splitting the first i blocks into j
    best = [[INF] * (nb + 1) for _ in range(k + 1)]
    cut = [[0] * (nb + 1) for _ in range(k + 1)]
    best[0][0] = 0.0
    for j in range(1, k + 1):
        for i in range(j, nb + 1):
            for s in range(j - 1, i):
                cand = max(best[j - 1][s], prefix[i] - prefix[s])
                if cand < best[j][i]:
                    best[j][i] = cand
                    cut[j][i] = s
    bounds = [nb]
    for j in range(k, 0, -1):
        bounds.append(cut[j][bounds[-1]])
    bounds.reverse()
    return tuple(
        tuple(i for b in blocks[lo:hi] for i in b)
        for lo, hi in zip(bounds, bounds[1:]))


def map_autoencoder_pretraining(dims: list[int], rows: int = CORE_ROWS,
                                cols: int = CORE_COLS, *,
                                share_small_layers: bool = False
                                ) -> NetworkMap:
    """Layer-wise AE pretraining instantiates, per hidden layer, the encoder
    plus a temporary decoder back to the layer input (section III.D) — the
    hardware must provision cores for both, which is why the paper's core
    counts (Table III) exceed the plain feed-forward mapping."""
    layer_maps: list[LayerMap] = []
    for i, o in zip(dims, dims[1:]):
        layer_maps.append(map_layer(i, o, rows, cols))      # encoder layer
        layer_maps.append(map_layer(o, i, rows, cols))      # temp decoder
    if share_small_layers:
        layer_maps = _pack_shared(layer_maps, rows, cols)
    cores = sum(l.placed_cores for l in layer_maps)
    routed = sum(l.routed_outputs for l in layer_maps)
    return NetworkMap(tuple(layer_maps), cores, routed, routing_cycles=routed)
