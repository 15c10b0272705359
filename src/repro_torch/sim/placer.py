"""Placer: materialize a NetworkMap as stacked per-core conductance arrays.

Port of ``repro.sim.placer``.  Each network layer becomes one pipeline
*stage*:

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
per-layer ``{"g_plus", "g_minus"}`` dicts.  `StageStacks` pads every stage
into one envelope for the compiled executor (``repro_torch.sim.compiled``)
and `sub_placement` cuts a contiguous stage slice out as its own placement.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
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


def sub_placement(pl: Placement, stage_indices: tuple[int, ...]) -> Placement:
    """A contiguous slice of a placement as its own (sub-)chip placement.

    The stage list ALIASES the parent's `Stage` objects, so a slice's
    updates write into the same stacks the parent placement (and its
    `Placement.extract_params`) sees.  The sub-map re-derives placed cores
    and routed outputs for the slice, so per-chip accounting stays
    measured, not copied."""
    if list(stage_indices) != list(range(stage_indices[0],
                                         stage_indices[-1] + 1)):
        raise ValueError(f"stage group {stage_indices} is not contiguous")
    stages = [pl.stages[i] for i in stage_indices]
    lms = tuple(pl.nmap.layers[i] for i in stage_indices)
    routed = sum(lm.routed_outputs for lm in lms)
    sub_nmap = NetworkMap(layers=lms,
                          cores=sum(lm.placed_cores for lm in lms),
                          routed_outputs=routed, routing_cycles=routed)
    dims = (lms[0].fan_in,) + tuple(lm.fan_out for lm in lms)
    return Placement(stages=stages, dims=dims, rows=pl.rows, cols=pl.cols,
                     nmap=sub_nmap)


# ---------------------------------------------------------------------------
# StageStacks: the padded ragged stage stack of the compiled executor
# ---------------------------------------------------------------------------

class StageMaps(NamedTuple):
    """One stage's own slice of the `StageStacks` index maps, with which the
    compiled executor launches on the stage's ``T`` cores (never on the
    padded ``T_max``), so no launch shape and no sum depends on the
    envelope.  Every index addresses a real element: lanes past the stage's
    fan-out read the one zero slot appended to the local error."""
    T: int               # cores of the stage's grid (row_tiles*col_tiles)
    r: int               # fan-in tiles
    c: int               # fan-out tiles
    fan_in: int
    fan_out: int
    cores: int           # billed cores (grid + aggregation)
    in_idx: torch.Tensor     # (T*rows,) [0, x] -> core lines, 0 = bias slot
    ds_idx: torch.Tensor     # (T*cols,) [local, 0] -> core columns
    dp_idx: torch.Tensor     # (r, fan_out) core outputs -> dp lanes
    fold_idx: torch.Tensor   # (r, c) cores summed per fan-in tile
    prev_idx: torch.Tensor   # (fan_in,) folded dx lines -> upstream error


@dataclasses.dataclass
class StageStacks:
    """All stages of a placement padded to one (T_max, rows, cols) envelope.

    The port of the reference's compiled-executor layout, field for field:

      * ``g_plus``/``g_minus`` — ``(S, chips*T_max, rows, cols)`` fp32
        conductance stacks; cores beyond a stage's ``row_tiles*col_tiles``
        grid are zero.  The compiled step updates them in place, and
        `scatter_back` makes every `Stage` hold the view
        ``envelope[s, :T_s]`` (contiguous), so kernel launches read and
        write the envelope's own memory.  A farm of ``chips`` replicas
        (``repro_torch.sim.cluster``) lays stage ``s``'s replicas
        chip-major in the first ``chips*T_s`` slots, so every stage's
        ``(chips, T_s)`` block is one contiguous view (`chip_views`) that a
        launch reads and updates in place (the reference's
        ``(S, C, T_max, ...)`` would make it strided whenever ``T_s <
        T_max``);
      * int64 index maps on the placement's device, built in numpy, with
        the reference's always-zero slot convention: ``in_idx`` 0 is the
        bias slot, ``ds_idx`` uses ``N_pad``, ``dp_idx`` ``T_max*cols``,
        ``fold_idx`` ``T_max`` and ``prev_idx`` ``r_max*rows``;
      * ``valid_out`` — ``(S, N_pad)`` output-lane validity (fp32 {0, 1});
      * ``core_counts`` — per-stage billed cores.

    ``stage_maps`` holds each stage's own slice of the maps (`StageMaps`),
    which is what the port's stage loop indexes with; ``programs`` holds
    the compiled programs built on this envelope (captured CUDA graphs bake
    in its addresses, so they live and die with it).
    """
    S: int
    T_max: int
    r_max: int
    c_max: int
    rows: int
    cols: int
    L: int               # padded input-vector length (bias slot 0 + lanes)
    N_pad: int           # padded output-lane count (max col_tiles*cols)
    out_dim: int         # fan_out of the last stage
    chips: int           # replicas per stage (1: a chip; C: a farm)
    fan_in: tuple[int, ...]
    fan_out: tuple[int, ...]
    n_cores: tuple[int, ...]       # per-stage billed cores (grid + agg)
    routed: tuple[int, ...]        # per-stage routed outputs (NoC record)
    links: tuple[int, ...]         # per-stage emitting links (NoC record)
    g_plus: torch.Tensor           # (S, chips*T_max, rows, cols)
    g_minus: torch.Tensor
    in_idx: torch.Tensor           # (S, T_max, rows)  h_ext -> core lines
    ds_idx: torch.Tensor           # (S, T_max, cols)  local_ext -> core cols
    dp_idx: torch.Tensor           # (S, r_max, N_pad) ys_flat_ext -> dp lanes
    fold_idx: torch.Tensor         # (S, r_max, c_max) dxs_ext core pick
    prev_idx: torch.Tensor         # (S, N_pad)        dxg_flat_ext -> delta
    valid_out: torch.Tensor        # (S, N_pad) float32 {0, 1}
    core_counts: torch.Tensor      # (S,) int64
    stage_maps: tuple[StageMaps, ...] = ()
    built_version: int = -1
    programs: dict = dataclasses.field(default_factory=dict, repr=False,
                                       compare=False)

    def index_pytree(self) -> dict[str, torch.Tensor]:
        """The index operands of the compiled programs, by name."""
        return {"in_idx": self.in_idx, "ds_idx": self.ds_idx,
                "dp_idx": self.dp_idx, "fold_idx": self.fold_idx,
                "prev_idx": self.prev_idx, "valid_out": self.valid_out,
                "core_counts": self.core_counts}

    def chip_views(self, s: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Stage ``s``'s replicas as ``(chips, T_s, rows, cols)`` views of
        the envelope.  They must be contiguous: a launch on a copy would
        update nothing."""
        T = self.stage_maps[s].T
        views = tuple(g[s, :self.chips * T].view(self.chips, T, self.rows,
                                                 self.cols)
                      for g in (self.g_plus, self.g_minus))
        if not all(v.is_contiguous() for v in views):
            raise RuntimeError(f"stage {s}: envelope view is not contiguous")
        return views

    def scatter_back(self, pl: Placement) -> None:
        """Point every `Stage` at its view of the envelope and mark the
        placement clean; the aliasing contract of `sub_placement` keeps
        holding because the Stage objects themselves are updated."""
        for s, st in enumerate(pl.stages):
            T = st.row_tiles * st.col_tiles
            st.g_plus = self.g_plus[s, :T]
            st.g_minus = self.g_minus[s, :T]
        pl.version += 1
        self.built_version = pl.version


def build_stage_stacks(pl: Placement, chips: int = 1) -> StageStacks:
    """Pad a placement's ragged stage list into a `StageStacks` envelope.

    The index maps are built in numpy and moved once to the placement's
    device as int64 tensors; the conductances are copied into a fresh
    envelope, ``chips`` replicas of each stage (chip-major)."""
    stages = pl.stages
    S = len(stages)
    rows, cols = pl.rows, pl.cols
    device = stages[0].g_plus.device
    rs = [st.row_tiles for st in stages]
    cs = [st.col_tiles for st in stages]
    Ts = [r * c for r, c in zip(rs, cs)]
    T_max, r_max, c_max = max(Ts), max(rs), max(cs)
    fan_in = tuple(st.lmap.fan_in for st in stages)
    fan_out = tuple(st.lmap.fan_out for st in stages)
    # output-lane envelope: wide enough for every stage's fan-out tiling
    # AND every stage's fan-in (the upstream error rides the same lanes)
    N_pad = max(max(c * cols for c in cs), max(fan_in))
    L = 1 + N_pad

    gp = torch.zeros((S, chips * T_max, rows, cols), dtype=torch.float32,
                     device=device)
    gm = torch.zeros_like(gp)
    for s, st in enumerate(stages):
        gp[s, :chips * Ts[s]] = st.g_plus.repeat(chips, 1, 1)
        gm[s, :chips * Ts[s]] = st.g_minus.repeat(chips, 1, 1)

    in_idx = np.zeros((S, T_max, rows), np.int64)       # 0 = bias slot (=0)
    ds_idx = np.full((S, T_max, cols), N_pad, np.int64)  # N_pad = zero col
    dp_idx = np.full((S, r_max, N_pad), T_max * cols, np.int64)
    fold_idx = np.full((S, r_max, c_max), T_max, np.int64)
    prev_idx = np.full((S, N_pad), r_max * rows, np.int64)
    valid = np.zeros((S, N_pad), np.float32)
    for s in range(S):
        r, c, F, O = rs[s], cs[s], fan_in[s], fan_out[s]
        t = np.arange(Ts[s])
        # input tiling (tile_inputs): core i*c+j line l <- global line
        # i*rows + l of [bias, x, zeros]; lines past the payload stay on
        # the always-zero bias slot.
        g = (t[:, None] // c) * rows + np.arange(rows)[None, :]
        in_idx[s, :Ts[s]] = np.where((g >= 1) & (g <= F), g, 0)
        # fan-out tiling (_tile_cols): core i*c+j col k <- lane j*cols+k
        ds_idx[s, :Ts[s]] = ((t[:, None] % c) * cols
                             + np.arange(cols)[None, :])
        # dp assembly: lane n sums partials ys[(i*c + n//cols)*cols
        # + n%cols] over fan-in tiles i (exact aggregation, Fig. 14).
        n = np.arange(O)
        for i in range(r):
            dp_idx[s, i, :O] = (i * c + n // cols) * cols + n % cols
        # backward fan-in fold: group i sums dxs over its c fan-out tiles.
        fold_idx[s, :r, :c] = (np.arange(r)[:, None] * c
                               + np.arange(c)[None, :])
        # upstream error: lane n <- global line n+1 of the folded dx
        prev_idx[s, :F] = np.arange(F) + 1
        valid[s, :O] = 1.0

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    maps = tuple(StageMaps(
        T=Ts[s], r=rs[s], c=cs[s], fan_in=fan_in[s], fan_out=fan_out[s],
        cores=stages[s].n_cores,
        in_idx=dev(in_idx[s, :Ts[s]].reshape(-1)),
        # lanes at or past the fan-out read the zero slot of [local, 0]
        ds_idx=dev(np.minimum(ds_idx[s, :Ts[s]], fan_out[s]).reshape(-1)),
        dp_idx=dev(dp_idx[s, :rs[s], :fan_out[s]]),
        fold_idx=dev(fold_idx[s, :rs[s], :cs[s]]),
        prev_idx=dev(prev_idx[s, :fan_in[s]])) for s in range(S))
    return StageStacks(
        S=S, T_max=T_max, r_max=r_max, c_max=c_max, rows=rows, cols=cols,
        L=L, N_pad=N_pad, out_dim=fan_out[-1], chips=chips,
        fan_in=fan_in, fan_out=fan_out,
        n_cores=tuple(st.n_cores for st in stages),
        routed=tuple(st.lmap.routed_outputs for st in stages),
        links=tuple(st.g_plus.shape[0] for st in stages),
        g_plus=gp, g_minus=gm,
        in_idx=dev(in_idx), ds_idx=dev(ds_idx), dp_idx=dev(dp_idx),
        fold_idx=dev(fold_idx), prev_idx=dev(prev_idx),
        valid_out=dev(valid),
        core_counts=dev(np.array([st.n_cores for st in stages], np.int64)),
        stage_maps=maps, built_version=pl.version)


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
