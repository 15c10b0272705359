"""Placer: materialize a NetworkMap as stacked per-core conductance arrays.

Port of ``repro.sim.placer`` (without ``StageStacks``/``sub_placement``,
which wait for the compiled-executor and fabric slices).  Each network
layer becomes one pipeline *stage*:

  * the layer's ``row_tiles x col_tiles`` core grid (section V.B) is stored
    as ONE stacked tensor ``(T, rows, cols)`` with ``T = row_tiles*col_tiles``
    — slice ``t = i*col_tiles + j`` is the physical core holding fan-in tile
    ``i`` of fan-out tile ``j``.  The whole stage executes as a single
    launch of the crossbar kernel (`kernels/ops.crossbar_fwd_stacked`),
    never a Python loop over cores;
  * row 0 of the first fan-in tile is the provisioned bias row (Fig. 8),
    zero conductance with its input line driven to 0;
  * layers split over fan-in get a Fig.-14 aggregation stage: ``col_tiles``
    cores whose unit-conductance block pattern sums the ``row_tiles``
    sub-neuron partials per neuron (exact aggregation), executed as a
    second launch in the same time slot.  As in the reference, an
    aggregation core is modeled with ``row_tiles*cols`` input lines, the
    shape `core/mapping.py` prices.

The placement is mutable state: `Placement.set_stage_stacks` writes new
stacks back and `Placement.extract_params` slices them back into the
per-layer ``{"g_plus", "g_minus"}`` dicts.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.crossbar import CORE_COLS, CORE_ROWS
from repro_torch.core.mapping import LayerMap, NetworkMap


@dataclasses.dataclass
class Stage:
    """One pipeline stage: a layer's core grid as stacked conductances."""
    index: int
    lmap: LayerMap
    rows: int
    cols: int
    g_plus: torch.Tensor            # (row_tiles*col_tiles, rows, cols)
    g_minus: torch.Tensor
    agg_plus: torch.Tensor | None   # (col_tiles, row_tiles*cols, cols) or None
    agg_minus: torch.Tensor | None

    @property
    def n_cores(self) -> int:
        """Physical cores executing this stage (main grid + aggregation) —
        measured from the materialized stacks, not copied from the mapper."""
        agg = 0 if self.agg_plus is None else self.agg_plus.shape[0]
        return self.g_plus.shape[0] + agg

    @property
    def row_tiles(self) -> int:
        """Fan-in tiles (sub-neuron splits, Fig. 14) of this stage."""
        return self.lmap.row_tiles

    @property
    def col_tiles(self) -> int:
        """Fan-out tiles of this stage."""
        return self.lmap.col_tiles


@dataclasses.dataclass
class Placement:
    """A placed network: the ordered pipeline stages plus the mapping they
    were materialized from (the sim<->hw_model shared contract)."""
    stages: list[Stage]
    dims: tuple[int, ...]
    rows: int
    cols: int
    nmap: NetworkMap
    version: int = 0      # bumped on every conductance write

    @property
    def n_cores(self) -> int:
        """Placed physical cores (the mapper's count: loopback-shared
        layers occupy the same core)."""
        return self.nmap.cores

    def set_stage_stacks(self, index: int, g_plus: torch.Tensor,
                         g_minus: torch.Tensor) -> None:
        """Write updated conductance stacks back into stage ``index``."""
        self.stages[index].g_plus = g_plus
        self.stages[index].g_minus = g_minus
        self.version += 1

    def extract_params(self) -> list[dict[str, torch.Tensor]]:
        """Stacks -> per-layer {"g_plus", "g_minus"} dicts (inverse of
        place_network's tiling, bias row and padding stripped)."""
        out = []
        for st in self.stages:
            F, O = st.lmap.fan_in, st.lmap.fan_out
            r, c = st.row_tiles, st.col_tiles
            gp = _untile(st.g_plus, r, c, st.rows, st.cols)[1:F + 1, :O]
            gm = _untile(st.g_minus, r, c, st.rows, st.cols)[1:F + 1, :O]
            out.append({"g_plus": gp, "g_minus": gm})
        return out


def _tile(g: torch.Tensor, r: int, c: int, rows: int,
          cols: int) -> torch.Tensor:
    """(r*rows, c*cols) padded matrix -> (r*c, rows, cols) core stack."""
    return (g.reshape(r, rows, c, cols).permute(0, 2, 1, 3)
             .reshape(r * c, rows, cols))


def _untile(stack: torch.Tensor, r: int, c: int, rows: int,
            cols: int) -> torch.Tensor:
    return (stack.reshape(r, c, rows, cols).permute(0, 2, 1, 3)
                 .reshape(r * rows, c * cols))


def _pad_layer(g: torch.Tensor, r: int, c: int, rows: int,
               cols: int) -> torch.Tensor:
    """Place a (fan_in, fan_out) matrix into the (r*rows, c*cols) core grid:
    bias row at row 0 (zero conductance), zero-padding elsewhere."""
    F, O = g.shape
    out = torch.zeros((r * rows, c * cols), dtype=g.dtype, device=g.device)
    out[1:F + 1, :O] = g
    return out


def tile_inputs(x: torch.Tensor, r: int, c: int, rows: int,
                bias_value: float = 0.0) -> torch.Tensor:
    """(..., M, fan_in) activations -> (..., r*c, M, rows) per-core input
    slabs.

    Core ``i*c + j`` receives fan-in tile ``i`` (all cores of one fan-in
    tile see the same rows — the routing network fans a neuron output to
    every consuming core).  Row 0 of tile 0 is the bias line, driven at
    ``bias_value`` (0: the layers are bias-free; the row is provisioned
    but silent).  A leading chip axis is carried through."""
    *lead, M, F = x.shape
    xb = torch.cat(
        [torch.full((*lead, M, 1), bias_value, dtype=x.dtype,
                    device=x.device), x,
         torch.zeros((*lead, M, r * rows - F - 1), dtype=x.dtype,
                     device=x.device)], dim=-1)
    xt = xb.reshape(*lead, M, r, rows).transpose(-3, -2)   # (..., r, M, rows)
    return torch.repeat_interleave(xt, c, dim=-3)          # (..., r*c, M, rows)


def fold_subneuron_partials(ys: torch.Tensor, st: Stage) -> torch.Tensor:
    """(C, r*c, M, cols) main-grid outputs of a fan-in-split stage ->
    (C, c, M, r*cols) aggregation-core input lines (Fig. 14: partial ``i``
    of neuron ``n`` drives line ``i*cols + n``)."""
    C, M = ys.shape[0], ys.shape[2]
    r, c = st.row_tiles, st.col_tiles
    return (ys.reshape(C, r, c, M, st.cols).permute(0, 2, 3, 1, 4)
              .reshape(C, c, M, r * st.cols))


def stage_dp_from_outputs(ys: torch.Tensor, st: Stage,
                          agg_out: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Core outputs -> (C, M, fan_out) stage dot products.

    ``ys`` is the (C, r*c, M, cols) main-grid output; fan-in-split stages
    pass the (C, c, M, cols) aggregation output instead of summing."""
    C, M = ys.shape[0], ys.shape[2]
    r, c = st.row_tiles, st.col_tiles
    if st.row_tiles > 1:
        dp = agg_out.permute(0, 2, 1, 3).reshape(C, M, c * st.cols)
    else:
        dp = (ys.reshape(C, r, c, M, st.cols).sum(dim=1)
                .permute(0, 2, 1, 3).reshape(C, M, c * st.cols))
    return dp[..., :st.lmap.fan_out]


def stage_dot_products(st: Stage, h: torch.Tensor, g_plus: torch.Tensor,
                       g_minus: torch.Tensor, run_fwd) -> torch.Tensor:
    """One stage's exact-aggregated dot products — with the two reshape
    helpers above, the single owner of the tile/aggregate discipline.

    ``h`` is ``(M, fan_in)`` or chip-stacked ``(C, Mc, fan_in)``;
    ``g±`` match (``(T, rows, cols)`` / ``(C, T, rows, cols)``).
    ``run_fwd(xs, gp, gm)`` is the stacked forward dispatch.  Fan-in-split
    stages run the Fig.-14 aggregation as a second dispatch in the same
    time slot."""
    chipped = h.dim() == 3
    if not chipped:
        h, g_plus, g_minus = h[None], g_plus[None], g_minus[None]
    r, c = st.row_tiles, st.col_tiles
    C = h.shape[0]
    xs = tile_inputs(h, r, c, st.rows)
    ys = run_fwd(xs, g_plus, g_minus)
    agg_out = None
    if r > 1:
        # sub-neuron partials cross the NoC to the aggregation cores,
        # which sum them through unit conductances.
        u = fold_subneuron_partials(ys, st)
        agg_p = st.agg_plus.expand((C,) + st.agg_plus.shape)
        agg_m = st.agg_minus.expand((C,) + st.agg_minus.shape)
        agg_out = run_fwd(u, agg_p, agg_m)
    dp = stage_dp_from_outputs(ys, st, agg_out)
    return dp if chipped else dp[0]


def untile_outputs(ys: torch.Tensor, r: int, c: int,
                   fan_out: int) -> torch.Tensor:
    """(r*c, M, cols) per-core partial DPs -> (M, fan_out) exact-aggregated
    dot products (sum over fan-in tiles, concat over fan-out tiles)."""
    T, M, cols = ys.shape
    part = ys.reshape(r, c, M, cols).sum(dim=0)         # (c, M, cols)
    return part.permute(1, 0, 2).reshape(M, c * cols)[:, :fan_out]


def _agg_pattern(r: int, cols: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """Unit-conductance block pattern of one aggregation core: input line
    ``i*cols + n`` (sub-neuron partial i of neuron n) feeds neuron n."""
    eye = torch.eye(cols, dtype=dtype, device=device)
    return eye.repeat(r, 1)                             # (r*cols, cols)


def place_layer(index: int, params: dict[str, torch.Tensor], lmap: LayerMap,
                rows: int, cols: int) -> Stage:
    """Materialize one layer's conductances as a pipeline `Stage` (core
    stack + Fig.-14 aggregation stack when fan-in is split)."""
    gp, gm = params["g_plus"], params["g_minus"]
    r, c = lmap.row_tiles, lmap.col_tiles
    agg_p = agg_m = None
    if r > 1:
        # Fig. 14 aggregation cores: one per fan-out tile, unit weights.
        pat = _agg_pattern(r, cols, gp.dtype, gp.device)
        agg_p = pat.repeat(c, 1, 1)
        agg_m = torch.zeros_like(agg_p)
    return Stage(
        index=index, lmap=lmap, rows=rows, cols=cols,
        g_plus=_tile(_pad_layer(gp, r, c, rows, cols), r, c, rows, cols),
        g_minus=_tile(_pad_layer(gm, r, c, rows, cols), r, c, rows, cols),
        agg_plus=agg_p, agg_minus=agg_m)


def place_network(layers: list[dict[str, torch.Tensor]],
                  nmap: NetworkMap | None = None,
                  rows: int = CORE_ROWS, cols: int = CORE_COLS) -> Placement:
    """Materialize per-layer conductance dicts onto the simulated core grid.

    ``nmap`` defaults to the unshared `map_network` placement of the layer
    dims; pass a `map_network(..., share_small_layers=True)` map to model
    loopback packing (same stage execution, fewer placed cores)."""
    dims = [int(layers[0]["g_plus"].shape[0])] + \
           [int(p["g_plus"].shape[1]) for p in layers]
    if nmap is None:
        from repro_torch.core.mapping import map_network
        nmap = map_network(dims, rows, cols)
    if len(nmap.layers) != len(layers):
        raise ValueError(f"NetworkMap has {len(nmap.layers)} layers, "
                         f"params have {len(layers)}")
    stages = []
    for i, (p, lm) in enumerate(zip(layers, nmap.layers)):
        got = tuple(p["g_plus"].shape)
        if got != (lm.fan_in, lm.fan_out):
            raise ValueError(f"layer {i}: params {got} != map "
                             f"({lm.fan_in}, {lm.fan_out})")
        if lm.row_tiles > rows:
            # beyond this the mapper's agg core count (ceil(r/rows) *
            # col_tiles) stops collapsing to col_tiles and the stacks
            # below would disagree with the priced placement.
            raise NotImplementedError(
                f"layer {i}: {lm.row_tiles} fan-in tiles need multi-level "
                f"aggregation, which neither the mapper nor the sim models")
        stages.append(place_layer(i, p, lm, rows, cols))
    return Placement(stages=stages, dims=tuple(dims), rows=rows, cols=cols,
                     nmap=nmap)
