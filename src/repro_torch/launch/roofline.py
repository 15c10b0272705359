"""Roofline analysis of a traced step on the card (port of
``repro/launch/roofline.py``).

Terms (seconds), per device:

  compute    = flops_per_device / PEAK_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = ring-weighted collective bytes per device / ICI_BW

The reference reads its figures from a compiled XLA executable
(``cost_analysis()`` and the HLO text).  The port has neither: its step is
traced once under a :class:`CostCounter` (``launch/dryrun.py``), and its
collectives are records ``(op, result_bytes, group_size)`` that the dry run
derives from the parameter shardings.  Each record's wire cost per device
uses the reference's ring weights on the *result* bytes:

  all-gather          result x (S-1)/S
  reduce-scatter      result x (S-1)        (input = S x result)
  all-reduce          result x 2(S-1)/S
  all-to-all          result x (S-1)/S
  collective-permute  result x 1

``hlo_line_record`` turns one line of XLA's HLO text into such a record, so
the two packages can be held against each other on the same strings.
"""
from __future__ import annotations

import dataclasses
import math
import re
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 SXM5 80GB at 700 W: spec sheet, not measured.
PEAK_FLOPS = 989e12        # dense bf16 FLOP/s (tensor cores), spec sheet
PEAK_FLOPS_FP32 = 67e12    # fp32 FLOP/s (CUDA cores), spec sheet
HBM_BW = 3.35e12           # HBM3 bytes/s, spec sheet
ICI_BW = 450e9             # NVLink 4 bytes/s, one direction, spec sheet

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s*(\([^)]*\)|[a-z0-9\[\],{}\s]+?)\s*"
    r"(all-reduce-start|all-gather-start|all-reduce|all-gather|"
    r"reduce-scatter|all-to-all|collective-permute-start|collective-permute)\(")
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_GROUPS_NEW_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_OLD_RE = re.compile(r"replica_groups=\{\{([0-9,]+)\}")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_NEW_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_OLD_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return default


def hlo_line_record(line: str, n_devices: int
                    ) -> tuple[str, int, int] | None:
    """``(op, result_bytes, group_size)`` of one HLO collective line, None
    for any other line (the reference's parse, one line at a time)."""
    m = _COLL_RE.search(line)
    if m is None:
        return None
    return (m.group(2).replace("-start", ""), _shape_bytes(m.group(1)),
            max(_group_size(line, n_devices), 1))


def collective_bytes(records, n_devices: int) -> dict[str, float]:
    """Per-device wire bytes by collective kind (ring-algorithm weighted)
    of ``(op, result_bytes, group_size)`` records; a group of one moves
    nothing.  ``n_devices`` is kept for the reference's signature."""
    out: dict[str, float] = {}
    for op, size, S in records:
        if S == 1:
            continue
        if op == "all-gather":
            w = size * (S - 1) / S
        elif op == "reduce-scatter":
            w = size * (S - 1)
        elif op == "all-reduce":
            w = size * 2 * (S - 1) / S
        elif op == "all-to-all":
            w = size * (S - 1) / S
        else:  # collective-permute
            w = size
        out[op] = out.get(op, 0.0) + w
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


@dataclasses.dataclass
class Roofline:
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    coll_breakdown: dict[str, float]
    n_devices: int
    model_flops: float = 0.0    # 6*N*D (train) / 2*N*B (decode), global

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_dev / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_dev / ICI_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Lower-bound step time: max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (traced FLOPs x devices): remat, dispatch and
        causal waste."""
        total = self.flops_per_dev * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline bound."""
        denom = self.t_bound * self.n_devices * PEAK_FLOPS
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict[str, Any]:
        return {
            "flops_per_dev": self.flops_per_dev,
            "bytes_per_dev": self.bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "coll_breakdown": self.coll_breakdown,
            "n_devices": self.n_devices,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "t_bound": self.t_bound,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def analyze(trace: dict, n_devices: int, model_flops: float = 0.0
            ) -> Roofline:
    """The roofline of a dry run's trace record (``dryrun._lower_one``):
    its global ``flops`` and ``bytes`` split evenly over the devices, its
    per-device ``collectives`` records weighted by the ring rules."""
    coll = collective_bytes(trace["collectives"], n_devices)
    return Roofline(
        flops_per_dev=trace["flops"] / n_devices,
        bytes_per_dev=trace["bytes"] / n_devices,
        coll_bytes_per_dev=coll["total"],
        coll_breakdown=coll,
        n_devices=n_devices,
        model_flops=model_flops,
    )


def model_flops_estimate(cfg, kind: str, seq_len: int,
                         global_batch: int) -> float:
    """6*N_active*tokens (train), 2*N_active*tokens (prefill/decode step)."""
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * seq_len * global_batch
    if kind == "prefill":
        return 2.0 * n_active * seq_len * global_batch
    return 2.0 * n_active * global_batch        # decode: one token per slot


def inner_loop_flops(cfg, kind: str, seq_len: int,
                     global_batch: int) -> float:
    """Analytic FLOPs for chunk-loop bodies (attention blocks, SSD chunks),
    the reference's correction, copied with the same results.

    XLA's cost analysis counts a ``lax.scan`` body once, so the reference
    adds the blocks of its flash-attention (q-chunk, kv-chunk) grid and of
    the SSD chunk scan that its compiled count misses (matmul FLOPs only).
    The port's trace dispatches every chunk of those loops and counts them
    all, so the port's dry run does not add this term; the function stays
    for the reference's analysis and its parity test.  Decode graphs have
    no inner chunk loops (single-block attention).
    """
    if kind == "decode":
        return 0.0
    B, S = global_batch, seq_len
    # fwd multiplicity: train = fwd + 2x bwd + remat fwd; prefill = fwd
    mult = 1.0 if kind == "prefill" else (4.0 if cfg.remat != "none" else 3.0)
    H = cfg.n_heads
    hd = cfg.head_dim or (cfg.d_model // max(H, 1))

    def attn_flops(Sq, Skv, causal, window):
        """Correction ONLY for paths that lax.scan over blocks: the dense
        grid (map+scan) and the paired causal schedule.  The triangular
        (nq<=12) and banded window paths are python-unrolled, so their
        blocks are already fully present in the probe HLO."""
        cq, ck = min(cfg.q_chunk, Sq), min(cfg.kv_chunk, Skv)
        nq, nk = Sq // cq, Skv // ck
        if nq * nk <= 1:
            return 0.0      # single block: already in the HLO count
        if causal and cfg.skip_masked_blocks and Sq == Skv and cq == ck:
            if window is None and nq % 2 == 0 and nq > 12:
                blocks = (nq // 2) * (nq + 1)       # paired (scanned)
            else:
                return 0.0           # triangular/banded: python-unrolled
        else:
            blocks = nq * nk          # dense grid (scanned, incl. windowed)
        return blocks * 4.0 * B * cq * ck * H * hd   # QK^T + PV matmuls

    def ssd_flops():
        s = cfg.ssd()
        c = min(s.chunk, S)
        nc = S // c
        Hs, P, G, N = s.n_heads, s.head_dim, s.n_groups, s.d_state
        per_chunk = (2.0 * B * c * c * G * N      # C.B
                     + 2.0 * B * Hs * c * c * P   # att @ x
                     + 4.0 * B * c * Hs * N * P)  # state build + y_inter
        return nc * per_chunk

    total = 0.0
    if cfg.family == "encdec":
        total += cfg.encoder_layers * attn_flops(S, S, False, None)
        total += cfg.n_layers * (attn_flops(S, S, True, None)      # self
                                 + attn_flops(S, S, False, None))  # cross
        return total * mult
    for k in cfg.layer_kinds():
        if k in ("attn", "moe"):
            total += attn_flops(S, S, True, None)
        elif k == "local":
            total += attn_flops(S, S, True, cfg.window)
        elif k == "ssd":
            total += ssd_flops()
        # "rec": associative_scan unrolls into HLO (counted already)
    return total * mult


# ---------------------------------------------------------------------------
# The trace's counter
# ---------------------------------------------------------------------------

def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def footprint(t: torch.Tensor) -> int:
    """The bytes of the distinct elements ``t`` addresses: a broadcast
    (stride-0) dim counts once, a slice only its own elements."""
    return t.element_size() * math.prod(
        n for n, st in zip(t.shape, t.stride()) if st != 0)


class CostCounter(TorchDispatchMode):
    """Counts what one call dispatches, op by op, while the mode is active:

    * ``flops``: the matmul-class FLOPs of ``torch.utils.flop_counter``'s
      formulas (mm, bmm, addmm, convolutions, attention), plus one per
      output element of every op tagged ``torch.Tag.pointwise`` (XLA's
      elementwise convention);
    * ``bytes``: the operand and result bytes (each tensor's distinct
      elements) of every op that computes: views, reshapes that alias
      their input and metadata queries move nothing.  This is what the
      port's eager path moves, op by op; it is not comparable with XLA's
      count over its fused program, which never writes most
      intermediates;
    * ``peak_bytes``: the most bytes held at once by storages the call
      allocated (its arguments are not counted), each storage once, freed
      when the storage dies.  Tensors that autograd saves for the backward
      keep their storages alive, so they count, as they should.

    A kernel wrapper's plain version (``kernels.ops.run_plain``) counts as
    the kernel the card launches there: its FLOPs, but as bytes its
    operands read once and its results written once, and as memory its
    results only (the kernel keeps its blocks on chip).

    Run the call under a ``FakeTensorMode`` to count without allocating
    (``launch/dryrun.py``); on real tensors the counts are the same.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.ops = 0
        self._seen: set[int] = set()
        self._in_kernel = 0

    def __enter__(self):
        from repro_torch.kernels import ops
        ops.PLAIN_HOOKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.PLAIN_HOOKS.remove(self._kernel)
        return super().__exit__(*exc)

    def _free(self, key: int, nbytes: int) -> None:
        self._seen.discard(key)
        self.live_bytes -= nbytes

    def _track(self, t: torch.Tensor, allocated: bool) -> None:
        """Record ``t``'s storage the first time it is seen: an argument's
        (``allocated`` False) only so that results aliasing it are not
        counted, a result's as live bytes until the storage dies."""
        s = t.untyped_storage()
        key = id(s)
        if key in self._seen:
            return
        self._seen.add(key)
        if not allocated:
            weakref.finalize(s, self._seen.discard, key)
            return
        n = s.nbytes()
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(s, self._free, key, n)

    def _kernel(self, fn, args, kwargs):
        """Run a kernel's plain version, counted as the kernel."""
        self._in_kernel += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._in_kernel -= 1
        if not self._in_kernel:
            ins, outs = _tensors((args, kwargs)), _tensors(out)
            self.bytes += sum(map(footprint, ins)) + sum(map(footprint, outs))
            for t in outs:
                self._track(t, allocated=True)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not outs:                  # a metadata query (device, sizes)
            return out
        ins = _tensors((args, kwargs))
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(t.numel() for t in outs)
        if self._in_kernel:
            return out
        for t in ins:
            self._track(t, allocated=False)
        aliased = {id(t.untyped_storage()) for t in ins}
        if func._schema.is_mutable or not all(
                id(t.untyped_storage()) in aliased for t in outs):
            self.bytes += sum(map(footprint, ins)) + sum(map(footprint, outs))
        for t in outs:
            self._track(t, allocated=True)
        return out

    def record(self) -> dict[str, int]:
        return {"flops": self.flops, "bytes": self.bytes,
                "peak_bytes": self.peak_bytes, "ops": self.ops}
