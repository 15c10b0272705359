"""Dry run: trace every (arch x shape x mesh) cell without allocating (port
of ``repro/launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \
      --shape train_4k --mesh single [--mode crossbar] \
      [--out experiments/dryrun-cuda]

Emits a JSON record per cell, in the reference's schema key for key:
memory (proves fit), FLOPs and bytes, collective bytes, and the roofline
terms (``launch/roofline.py``, H100 figures).

Where the reference lowers and compiles each cell through XLA on 512
placeholder host devices, the port builds the model on the CPU under
``FakeTensorMode`` (parameters, optimizer state, batch and cache are fake
tensors: nothing is allocated) and runs the cell's step once under a
:class:`~repro_torch.launch.roofline.CostCounter`.  The mesh is folded onto
one device, as the port runs it, so the trace counts the global work; the
record divides it evenly over the mesh's devices.  The kernel wrappers take
their plain versions there, as on any CPU tensor, and each counts as the
kernel the card launches in its place (``roofline.CostCounter``).

What each figure is (the record's ``"counted"`` entry says it too):

* ``memory.argument``: exact, per device: the local shard bytes of the
  parameters, optimizer state, batch and cache under the port's partition
  specs (each sharded dim split evenly, rounded up), plus the step scalar;
* ``memory.temp``: the trace's peak live bytes above its arguments and the
  outputs it leaves, divided by the devices;
* ``memory.output`` / ``memory.alias``: the step's results, and the
  donated arguments they reuse (train: parameters and optimizer state;
  decode: the cache), as the reference's donation implies;
* FLOPs and bytes: the trace's, divided by the devices (the eager path's
  op-by-op bytes, a kernel's operands and results once; not XLA's fused
  count);
* collectives: the parameter traffic the shardings imply, by the ring
  weights (``param_collectives``); tensor-parallel activation collectives
  are not counted.

The reference's probe extrapolation (``_probe_config``,
``_scan_corrected_metrics``) has no counterpart: XLA counts a scanned layer
body once, while the port's layer loop is Python and the trace counts every
layer and every attention or SSD chunk, so neither the extrapolation nor
``roofline.inner_loop_flops`` is added.
"""
import argparse
import json
import math
import os
import time
from typing import Any

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import NamedSharding, PartitionSpec as P
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import _map_with_path
from repro_torch.runtime.train_loop import _mirror_shardings, make_train_step

# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 at 700 W, torch 2.11 with CUDA 12.8 (read on the card;
# chip_smoke.py asserts it): 79.18 GiB
HBM_PER_CHIP = 85_017_493_504

COUNTED = {"partitioning": "even",
           "collectives": "parameter traffic only",
           "kernels": "plain versions as launched: their FLOPs, operands "
                      "and results once"}


# ---------------------------------------------------------------------------
# Cache/batch sharding heuristics (decode graphs)
# ---------------------------------------------------------------------------

def _as_tuple(axes):
    if axes is None:
        return ()
    return axes if isinstance(axes, tuple) else (axes,)


def _batch_entry(leaf, mesh, rules, batch: int) -> tuple[int, Any]:
    """(dim, entry) of a cache leaf's batch axis: the first of dims 0 and 1
    (1 for layer-stacked caches) whose size is ``batch`` and divides over
    the batch axes; (-1, None) if none does."""
    batch_axes = _as_tuple(rules.get("batch"))
    for i in range(min(2, leaf.ndim)):
        if leaf.shape[i] == batch and batch_axes:
            size = math.prod(mesh.shape[a] for a in batch_axes)
            if batch % size == 0:
                return i, (batch_axes if len(batch_axes) > 1
                           else batch_axes[0])
    return -1, None


def _cache_pspec(path, leaf, mesh, rules, batch: int) -> P:
    """The spec of one decode-cache leaf; ``path`` is its tuple of keys."""
    name = str(path[-1]) if path else ""
    if name in ("length", "pos") or leaf.ndim == 0:
        return P()
    entries: list[Any] = [None] * leaf.ndim
    i, entry = _batch_entry(leaf, mesh, rules, batch)
    if i >= 0:
        entries[i] = entry
    model_ax = rules.get("model")
    used = {a for e in entries if e is not None for a in _as_tuple(e)}
    if name.endswith("_scale"):
        # int8 KV scales (B, S, K) [+leading layer axis]: shard S with the
        # codes' S axis so dequantization stays local
        if model_ax and model_ax not in used and leaf.ndim >= 3 and \
                leaf.shape[-2] % mesh.shape[model_ax] == 0:
            entries[-2] = model_ax
        return P(*entries)
    # model-axis shard, in preference order:
    #   1. sequence axis of KV caches (ndim>=4, dim -3) — flash-decoding
    #      style split-KV: softmax reductions over the sharded S are cheap
    #      scalars, and it avoids repartitioning the cache,
    #   2. kv-heads axis (dim -2),
    #   3. last dim (head_dim / channels).
    if model_ax and model_ax not in used:
        msize = mesh.shape[model_ax]
        if (leaf.ndim >= 4 and entries[-3] is None
                and leaf.shape[-3] % msize == 0 and leaf.shape[-3] > 1):
            entries[-3] = model_ax
        elif (leaf.ndim >= 4 and entries[-2] is None
                and leaf.shape[-2] % msize == 0 and leaf.shape[-2] > 1):
            entries[-2] = model_ax
        elif (leaf.ndim >= 2 and entries[-1] is None
                and leaf.shape[-1] % msize == 0 and leaf.shape[-1] > 1):
            entries[-1] = model_ax
    return P(*entries)


def cache_shardings(cache_abs, mesh, rules, batch: int):
    """A tree of cache leaves (tensors, e.g. ``meta``) -> NamedShardings."""
    return _map_with_path(
        lambda p, leaf: NamedSharding(
            mesh, _cache_pspec(p, leaf, mesh, rules, batch)), cache_abs)


def batch_shardings(batch_abs, mesh, rules):
    """A tree of batch leaves -> NamedShardings: the leading axis over the
    batch axes where it divides, else replicated."""
    batch_axes = _as_tuple(rules.get("batch"))
    spec = P(batch_axes if len(batch_axes) > 1
             else (batch_axes[0] if batch_axes else None))

    def per_leaf(leaf):
        if leaf.ndim == 0:
            return NamedSharding(mesh, P())
        size = math.prod(mesh.shape[a] for a in batch_axes)
        if size and leaf.shape[0] % size == 0:
            return NamedSharding(mesh, spec)
        return NamedSharding(mesh, P())

    return shd.tree_map(per_leaf, batch_abs)


# ---------------------------------------------------------------------------
# Bytes and collectives the shardings imply
# ---------------------------------------------------------------------------

def _spec_axes(spec) -> tuple[str, ...]:
    return tuple(a for e in spec if e is not None for a in _as_tuple(e))


def local_bytes(leaf, sharding: NamedSharding) -> int:
    """One device's bytes of ``leaf`` (anything with ``shape`` and
    ``dtype``) under ``sharding``: each sharded dim split evenly over its
    axes, rounded up."""
    shape = list(leaf.shape)
    for i, e in enumerate(sharding.spec):
        if e is not None:
            size = math.prod(sharding.mesh.shape[a] for a in _as_tuple(e))
            shape[i] = -(-shape[i] // size)
    return math.prod(shape) * leaf.dtype.itemsize


def tree_local_bytes(tree, shardings) -> int:
    return sum(shd.tree_leaves(shd.tree_map(local_bytes, tree, shardings)))


def param_collectives(spec_tree, rules, mesh, kind: str, remat: str = "none",
                      grad_accum: int = 1) -> list[tuple[str, int, int]]:
    """``(op, result_bytes, group_size)`` records, per device, of the
    parameter traffic one step implies:

    * a leaf sharded over mesh axes of size S > 1 is all-gathered (result:
      its gathered bytes) once per forward pass: one pass for prefill and
      decode; in train two per microbatch (the forward and the backward),
      three under remat ``full`` or ``dots`` (the recomputed forward);
    * in train its gradient is reduce-scattered over the same S (result:
      its local bytes), once a step;
    * in train a leaf replicated over batch axes of size S > 1 has its
      gradient all-reduced over them (result: its local bytes).
    """
    batch_axes = _as_tuple(rules.get("batch"))
    passes = 1
    if kind == "train":
        passes = (3 if remat in ("full", "dots") else 2) * grad_accum
    records: list[tuple[str, int, int]] = []
    specs = shd.tree_leaves(spec_tree)
    pspecs = shd.tree_leaves(shd.partition_specs(spec_tree, rules, mesh))
    for s, pspec in zip(specs, pspecs):
        local = local_bytes(s, NamedSharding(mesh, pspec))
        axes = _spec_axes(pspec)
        S = math.prod(mesh.shape[a] for a in axes)
        if S > 1:
            records += [("all-gather", local * S, S)] * passes
            if kind == "train":
                records.append(("reduce-scatter", local, S))
        R = math.prod(mesh.shape[a] for a in batch_axes if a not in axes)
        if kind == "train" and R > 1:
            records.append(("all-reduce", local, R))
    return records


# ---------------------------------------------------------------------------
# Cell tracing
# ---------------------------------------------------------------------------

def _specs_to_meta(tree):
    """``input_specs`` leaves, ``(shape, dtype)`` pairs, as meta tensors."""
    if isinstance(tree, tuple) and len(tree) == 2 and \
            isinstance(tree[1], torch.dtype):
        return torch.empty(tree[0], dtype=tree[1], device="meta")
    if isinstance(tree, dict):
        return {k: _specs_to_meta(v) for k, v in tree.items()}
    return type(tree)(_specs_to_meta(v) for v in tree)


def _fake_like(meta_tree):
    """Fake CPU tensors (inside a ``FakeTensorMode``) shaped as a tree of
    meta tensors or ``ParamSpec`` leaves."""
    return shd.tree_map(lambda m: torch.empty(tuple(m.shape), dtype=m.dtype),
                        meta_tree)


def _logits_sharding(logits, mesh, rules) -> NamedSharding:
    """Logits (B, L, V): the batch over the batch axes, the vocabulary over
    the model axis (the head's) unless the batch took it, each where it
    divides."""
    entries: list[Any] = [None] * logits.ndim
    i, entry = _batch_entry(logits, mesh, rules, logits.shape[0])
    if i == 0:
        entries[0] = entry
    model_ax = rules.get("model")
    if model_ax and model_ax not in _spec_axes(entries) and \
            logits.shape[-1] % mesh.shape[model_ax] == 0:
        entries[-1] = model_ax
    return NamedSharding(mesh, P(*entries))


def _lower_one(cfg, kind, seq_len, global_batch, mesh, rules):
    """Trace one cell's step; returns (trace record, seconds).

    The record holds the trace's global ``flops``, ``bytes`` and
    ``peak_bytes`` (``CostCounter.record``), ``temp_bytes`` (the peak above
    what the call leaves live), the per-device ``collectives`` records, and
    per device ``argument``, ``output`` and ``alias`` bytes."""
    model = build_model(cfg, device="cpu")
    abs_params = model.abstract_params()
    param_sh = shd.named_shardings(model.spec, rules, mesh)
    step_scalar = 4        # the reference's int32 step (train only)
    t0 = time.time()
    counter = rl.CostCounter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = _fake_like(abs_params)
        alias = 0
        if kind == "train":
            opt = adamw(3e-4)
            abs_opt = opt.init(abs_params)
            opt_sh = _mirror_shardings(abs_opt, abs_params, param_sh)
            batch_abs = _specs_to_meta(model.input_specs(
                "train", seq_len, global_batch))
            batch_sh = batch_shardings(batch_abs, mesh, rules)
            opt_state, batch = _fake_like(abs_opt), _fake_like(batch_abs)
            # no param_shardings: on one device they only pin gradients
            # to the mesh's device, and the trace's is the CPU
            step = make_train_step(model, opt, grad_accum=cfg.grad_accum)
            with counter:
                _, _, metrics = step(params, opt_state, batch, 0)
            donated = (tree_local_bytes(abs_params, param_sh)
                       + tree_local_bytes(abs_opt, opt_sh))
            argument = donated + tree_local_bytes(batch_abs, batch_sh) \
                + step_scalar
            output = donated + sum(m.nbytes for m in shd.tree_leaves(metrics))
            alias = donated
        elif kind == "prefill":
            batch_abs = _specs_to_meta(model.input_specs(
                "prefill", seq_len, global_batch))
            batch_sh = batch_shardings(batch_abs, mesh, rules)
            batch = _fake_like(batch_abs)
            with counter:
                logits = model.prefill_fn(params, batch)
            argument = (tree_local_bytes(abs_params, param_sh)
                        + tree_local_bytes(batch_abs, batch_sh))
            output = local_bytes(logits, _logits_sharding(logits, mesh,
                                                          rules))
        else:  # decode
            batch_spec, cache_spec = model.input_specs("decode", seq_len,
                                                       global_batch)
            batch_abs = _specs_to_meta(batch_spec)
            cache_abs = _specs_to_meta(cache_spec)
            batch_sh = batch_shardings(batch_abs, mesh, rules)
            cache_sh = cache_shardings(cache_abs, mesh, rules, global_batch)
            batch, cache = _fake_like(batch_abs), _fake_like(cache_abs)
            with counter:
                logits, cache = model.decode_fn(params, cache, batch)
            cache_bytes = tree_local_bytes(cache_abs, cache_sh)
            argument = (tree_local_bytes(abs_params, param_sh) + cache_bytes
                        + tree_local_bytes(batch_abs, batch_sh))
            output = cache_bytes + local_bytes(
                logits, _logits_sharding(logits, mesh, rules))
            alias = cache_bytes
        trace = dict(counter.record(),
                     temp_bytes=counter.peak_bytes - counter.live_bytes)
    trace.update(
        collectives=param_collectives(model.spec, rules, mesh, kind,
                                      cfg.remat, cfg.grad_accum),
        argument=argument, output=output, alias=alias)
    return trace, time.time() - t0


def lower_cell(arch: str, shape: str, mesh_kind: str, *, mode: str = "standard",
               overrides: dict | None = None,
               rules_overrides: dict | None = None, mesh=None):
    """Build + trace one cell.  Returns (record, trace).  ``mesh`` defaults
    to the production mesh of ``mesh_kind`` folded onto the CPU."""
    shape_info = SHAPES[shape]
    kind = shape_info["kind"]
    seq_len, global_batch = shape_info["seq_len"], shape_info["global_batch"]

    cfg = get_config(arch, **(overrides or {}))
    if mode == "crossbar":
        cfg = cfg.replace(crossbar=True)
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "mode": mode, "skipped": reason}, None

    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    device="cpu")
    n_dev = mesh.size
    all_rules = dict(cfg.sharding_overrides or ())
    all_rules.update(rules_overrides or {})
    rules = shd.make_rules(mesh, all_rules)

    trace, t_trace = _lower_one(cfg, kind, seq_len, global_batch, mesh, rules)
    model_flops = rl.model_flops_estimate(cfg, kind, seq_len, global_batch)
    roof = rl.analyze(trace, n_dev, model_flops)
    temp = -(-trace["temp_bytes"] // n_dev)
    per_dev_bytes = (trace["argument"] + temp + trace["output"]
                     - trace["alias"])
    record = {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "mode": mode,
        "kind": kind, "seq_len": seq_len, "global_batch": global_batch,
        "n_devices": n_dev,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "memory": {
            "argument": trace["argument"],
            "output": trace["output"],
            "temp": temp,
            "alias": trace["alias"],
            "per_device_bytes": per_dev_bytes,
            "hbm_frac": per_dev_bytes / HBM_PER_CHIP,
            "fits": per_dev_bytes <= HBM_PER_CHIP,
        },
        "roofline": roof.to_dict(),
        "timings": {"lower_s": t_trace, "compile_s": 0.0},
        "overrides": overrides or {},
        "counted": dict(COUNTED),
    }
    return record, trace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--mode", default="standard",
                    choices=["standard", "crossbar"])
    ap.add_argument("--out", default="experiments/dryrun-cuda")
    ap.add_argument("--tag", default="")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (int/float/bool/str)")
    ap.add_argument("--rules", action="append", default=[],
                    help="sharding rule override logical=axis1,axis2 "
                         "(empty value = replicate)")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "false"):
            v = v == "true"
        overrides[k] = v
    rules_overrides = {}
    for rv in args.rules:
        k, v = rv.split("=", 1)
        if not v:
            rules_overrides[k] = None
        else:
            axes = tuple(v.split(","))
            rules_overrides[k] = axes if len(axes) > 1 else axes[0]

    record, _ = lower_cell(args.arch, args.shape, args.mesh,
                           mode=args.mode, overrides=overrides,
                           rules_overrides=rules_overrides)
    if "skipped" not in record and (args.rules or args.tag):
        record["rules_overrides"] = {k: list(v) if isinstance(v, tuple) else v
                                     for k, v in rules_overrides.items()}
    os.makedirs(args.out, exist_ok=True)
    tag = f"__{args.tag}" if args.tag else ""
    name = f"{args.arch}__{args.shape}__{args.mesh}__{args.mode}{tag}.json"
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(record, f, indent=1)

    if "skipped" in record:
        print(f"SKIP {name}: {record['skipped']}")
        return
    r = record["roofline"]
    m = record["memory"]
    print(f"OK {name}")
    print(f"  per-device HBM: {m['per_device_bytes']/2**30:.2f} GiB "
          f"({m['hbm_frac']*100:.1f}% of {HBM_PER_CHIP/2**30:.2f}GiB) "
          f"fits={m['fits']}")
    print(f"  t_compute={r['t_compute']*1e3:.3f}ms t_memory={r['t_memory']*1e3:.3f}ms "
          f"t_collective={r['t_collective']*1e3:.3f}ms -> {r['bottleneck']}")
    print(f"  useful_flops_ratio={r['useful_flops_ratio']:.3f} "
          f"mfu_bound={r['mfu_bound']:.3f}")
    print(f"  trace={record['timings']['lower_s']:.1f}s")


if __name__ == "__main__":
    main()
