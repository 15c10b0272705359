"""Port parity: the MoE family (moonshot-v1-16b-a3b, qwen3-moe-30b-a3b:
GShard top-k dispatch with capacity drops, the auxiliary loss, the
``moe`` block kind after an optional dense prefix) of ``repro_torch``
against ``repro``'s, on the CPU.

``moe_apply`` takes the same numpy inputs on both sides, its parameters
the reference's ``init_params`` draws carried across by
``interop.lm_params_from_numpy``; the models take the reference's
``model.init(PRNGKey(0))`` parameters the same way, at the reduced
configs (moonshot: the dense first layer and 2 moe layers, 8 experts top
2 and a shared expert; qwen3-moe: 2 moe layers, 8 experts top 2).

Routing is compared exactly: each token's top-k experts in priority
order and every choice's keep mask (kept or dropped).  The only excuse is
a near-tie: a token whose gap between two of its k + 1 largest router
probabilities, on the reference's side, lies below NEAR_TIE (1e-6 in
float32 compute, where only sums in another order separate the two
sides) or NEAR_TIE_BF16 (1e-2 in bf16 compute, where the router's input
carries the bf16 roundings of every earlier layer: one bf16 step in about
a quarter of its elements at the first moe layer, which moved the reduced
configs' probabilities by up to 2.1e-3, measured on the CPU).  In
``moe_apply`` a near-tie excuses its group (its slot moves the others').
In the models the reference runs block by block with its own functions
(``ref_forward``, equal to its ``prefill_fn`` and ``decode_fn``) so that
its routing can be read beside the port's; a flip reaches its sequence's
later positions, and where its group drops a choice, the whole group
(``Flips``).  Every test counts what it excused, and outputs are compared
on the rest.

Tolerances, each with its reason:
- ``moe_apply`` in float32: y within 1e-5 absolute plus relative (the
  sums over k have one nonzero term each, so dispatch and combine are
  exact; the expert products and the combine sum in other orders), aux
  within 1e-6 (fp32 means of the same probabilities).
- bf16 compute: in the Frobenius norm, the port within the reference's
  own bf16 noise, ||port - ref|| <= ||ref - ref in float32 compute||
  (``test_torch_hybrid._assert_within_bf16_noise``), on the tokens no
  flip reached.  ``moe_apply`` rounds where the reference does
  (``mlp.silu`` is ``jax.nn.silu`` op for op), but the attention before
  it sums in another order, and one routing flip moves a whole expert's
  share of a token: over whole logits the port's distance from the
  reference and the reference's own bf16 noise are two counts of such
  flips, either one the larger (measured on five batches: 0.5x to 8x).
  aux within 1e-6: the router runs in fp32 on both sides.
- model logits in float32 compute: 1e-4 absolute plus relative, the bar
  of tests/test_torch_lm.py; a decode step against the port's own
  prefill at the no-drop capacity within 1e-4.
- loss and gradients: the bars of tests/test_torch_train_step.py (fp32:
  the loss within 1e-5 relative, each leaf within 1e-4 of its largest; a
  crossbar-mode miss excused only where the port's quantizers saw an
  input next to a code boundary, counted), aux within 1e-6.
- greedy tokens: equal, except from a position whose top-2 gap is a
  near-tie of the reference's logits (float32: within 1e-4; bf16:
  within 1e-2 plus one bf16 step at the row's largest logit) or that a
  routing flip at a near-tie reached; the slot's later tokens are then
  excused too.
- ``chip_smoke.py``'s bf16 decode figure: the reference's own
  bf16-vs-float32 distance on the reduced configs, computed here again
  to 4 significant digits.

Capacity drops make a prefill differ from a decode, in the reference
too: a decode step's group is the batch's B tokens (C = max(4, ...) >= B,
nothing drops) where a prefill's is min(group_size, B * S).  So every
decode-against-prefill check runs at ``capacity_factor = n_experts /
top_k`` (C = the group, nothing drops).
"""
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jcfg  # noqa: E402
from repro.dist.sharding import cast_for_compute as jcast  # noqa: E402
from repro.dist.sharding import init_params as jinit  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import linear as jlin  # noqa: E402
from repro.layers import moe as jmoe  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.runtime import serve_loop as jserve  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base as tcfg  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.dist import sharding as tshd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.layers import moe as tmoe  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.runtime import serve_loop as tserve  # noqa: E402
from repro_torch.runtime.checkpoint import _key, _walk  # noqa: E402
from test_torch_hybrid import (  # noqa: E402
    _assert_within_bf16_noise, bf16_step)
from test_torch_train_step import _NearBoundary, _flat_ref  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["moonshot-v1-16b-a3b", "qwen3-moe-30b-a3b"]
FULL_COUNTS = {"moonshot-v1-16b-a3b": 28_386_592_768,
               "qwen3-moe-30b-a3b": 30_532_634_624}
NEAR_TIE = 1e-6
TOL = 1e-5
LOGIT_TOL = 1e-4
PROMPTS = [[1 + (i * 7 + j) % 511 for j in range(8)] for i in range(4)]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def no_drop(cfg):
    """``cfg`` at the capacity where nothing drops: C = the group."""
    return cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)


# ---------------------------------------------------------------------------
# configs and counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_counts_equal_the_reference(arch):
    for getter in ("get_config", "get_reduced_config"):
        jc = getattr(jcfg, getter)(arch)
        tc = getattr(tcfg, getter)(arch)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert dataclasses.asdict(tc.moe()) == dataclasses.asdict(jc.moe())
        assert tc.layer_kinds() == jc.layer_kinds()
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        assert tc.active_param_count() < tc.param_count()
    full = tcfg.get_config(arch)
    assert full.param_count() == FULL_COUNTS[arch]
    lay = tlm.stack_layout(full)
    assert lay.pattern == ("moe",) and lay.suffix == ()
    assert lay.prefix == (("attn",) if arch.startswith("moonshot") else ())
    # the dense family's active count is its whole count
    dense = tcfg.get_config("qwen2-0.5b")
    assert dense.active_param_count() == dense.param_count()


@pytest.mark.parametrize("cf", [0.25, 1.0, 1.25, 2.0, 16.0])
def test_capacity_equals_the_reference(cf):
    for E, k in ((8, 2), (64, 6), (128, 8), (2, 1)):
        kw = dict(d_model=8, n_experts=E, top_k=k, d_expert=4,
                  capacity_factor=cf)
        jc, tc = jmoe.MoeConfig(**kw), tmoe.MoeConfig(**kw)
        for g in (1, 4, 20, 32, 64, 96, 1000, 1024):
            assert tmoe._capacity(tc, g) == jmoe._capacity(jc, g), (E, k, g)
    # the full configs' prefill groups of 1024 and the CLI's decode groups
    moon = tcfg.get_config("moonshot-v1-16b-a3b").moe()
    qwen = tcfg.get_config("qwen3-moe-30b-a3b").moe()
    assert (tmoe._capacity(moon, 1024), tmoe._capacity(qwen, 1024)) == \
        (120, 80)
    assert tmoe._capacity(moon, 4) == tmoe._capacity(qwen, 4) == 4
    assert tmoe._capacity(moon, 32) == 4


# ---------------------------------------------------------------------------
# moe_apply against the reference
# ---------------------------------------------------------------------------

J_MOE = jax.jit(jmoe.moe_apply, static_argnames=("cfg", "xbar",
                                                 "compute_dtype"))


@functools.partial(jax.jit, static_argnames=("cfg",))
def ref_routing(params, x, cfg):
    """The reference's routing (``moe_apply``'s router, top-k and slot
    lines, repro/layers/moe.py:79-96): top_i (G, s, k), kept (G, k, s)
    and the sorted probabilities (G, s, E)."""
    B, S, d = x.shape
    g = min(cfg.group_size, B * S)
    G, E, k = B * S // g, cfg.n_experts, cfg.top_k
    C = jmoe._capacity(cfg, g)
    logits = jlin.dense_apply(params["router"], x.reshape(G, g, d),
                              compute_dtype=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_i = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(top_i, E, dtype=jnp.int32)
    prio = jnp.moveaxis(onehot, 2, 1).reshape(G, k * g, E)
    pos = jnp.cumsum(prio, axis=1) - 1
    keep = (pos < C) & (prio > 0)
    return top_i, keep.any(-1).reshape(G, k, g), -jnp.sort(-probs, axis=-1)


def near_ties(ranked: np.ndarray, k: int) -> np.ndarray:
    """(G, s) tokens whose k + 1 largest probabilities hold a gap below
    NEAR_TIE: their choice or its order may go either way."""
    top = ranked[..., :k + 1]
    if top.shape[-1] < 2:
        return np.zeros(ranked.shape[:-1], bool)
    return (top[..., :-1] - top[..., 1:]).min(-1) < NEAR_TIE


def check_routing(got: tmoe.Routing, want, k: int) -> np.ndarray:
    """Routing equal but at near-ties; returns the excused tokens (G, s):
    the near-tie tokens' groups whole (their slots move the others')."""
    top_i, kept, ranked = (np.asarray(a) for a in want)
    tie = near_ties(ranked, k)
    excused = np.broadcast_to(tie.any(-1, keepdims=True), tie.shape)
    ok = ~excused
    np.testing.assert_array_equal(got.top_i.numpy()[ok], top_i[ok])
    np.testing.assert_array_equal(got.kept.numpy().transpose(0, 2, 1)[ok],
                                  kept.transpose(0, 2, 1)[ok])
    # the port's margin is the same figure, from its own probabilities
    top = ranked[..., :k + 1]
    np.testing.assert_allclose(got.margin.numpy(),
                               (top[..., :-1] - top[..., 1:]).min(-1),
                               atol=1e-6)
    return excused


@dataclasses.dataclass(frozen=True)
class MoeCase:
    what: str
    B: int
    S: int
    cfg: dict


# moe_apply cases: drops at 1.25 over three groups with a shared expert;
# k = 3 of 6 over four groups without one; one group of T < group_size at
# k = 1; no renormalisation with a gelu shared expert of 2x
MOE_CASES = [
    MoeCase("3 groups, shared", 2, 48,
            dict(d_model=32, n_experts=8, top_k=2, d_expert=16,
                 n_shared_experts=1, group_size=32)),
    MoeCase("4 groups, k 3 of 6", 1, 64,
            dict(d_model=24, n_experts=6, top_k=3, d_expert=8,
                 group_size=16, capacity_factor=1.0)),
    MoeCase("1 group, k 1", 2, 10,
            dict(d_model=16, n_experts=4, top_k=1, d_expert=8)),
    MoeCase("unnormalised, gelu shared x2", 2, 32,
            dict(d_model=16, n_experts=8, top_k=2, d_expert=8,
                 n_shared_experts=2, group_size=64, norm_topk_prob=False,
                 act="gelu", aux_loss_coef=0.01)),
]


def _moe_params(cfg: dict, seed: int):
    jp = jinit(jax.random.PRNGKey(seed),
               jmoe.moe_spec(jmoe.MoeConfig(**cfg)))
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jp, tp


def _run_both(case: MoeCase, x: np.ndarray, dtype: str, seed: int = 1):
    """The reference's and the port's (y, aux) on ``x`` (in ``dtype``),
    with the port's Routing and the reference's."""
    jp, tp = _moe_params(case.cfg, seed)
    jc, tc = jmoe.MoeConfig(**case.cfg), tmoe.MoeConfig(**case.cfg)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = J_MOE(jp, jx, cfg=jc, compute_dtype=getattr(jnp, dtype))
    tmoe.ROUTING = []
    try:
        got = tmoe.moe_apply(tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                             tc, compute_dtype=getattr(torch, dtype))
        (routing,) = tmoe.ROUTING
    finally:
        tmoe.ROUTING = None
    return want, got, routing, ref_routing(jp, jx, jc)


def test_moe_spec_has_the_reference_shapes():
    for case in MOE_CASES:
        jspec = jmoe.moe_spec(jmoe.MoeConfig(**case.cfg))
        tspec = tmoe.moe_spec(tmoe.MoeConfig(**case.cfg))
        def shapes(spec):
            return [tuple(s.shape) for s in jax.tree.leaves(
                spec, is_leaf=lambda s: hasattr(s, "shape"))]
        assert shapes(tspec) == shapes(jspec)
        assert set(tspec) == set(jspec)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MOE_CASES, ids=lambda c: c.what)
def test_moe_apply_matches_the_reference(case, dtype):
    B, S, d = case.B, case.S, case.cfg["d_model"]
    x = np.random.default_rng(B * S + d).standard_normal((B, S, d)).astype(
        np.float32)
    if dtype == "bfloat16":       # the same bf16 values on every side
        x = _f32(torch.from_numpy(x).to(torch.bfloat16))
    (wy, waux), (gy, gaux), routing, ref = _run_both(case, x, dtype)
    assert gy.dtype == getattr(torch, dtype) and gy.shape == (B, S, d)
    assert gaux.dtype == torch.float32 and gaux.shape == ()
    assert abs(float(gaux) - float(waux)) <= 1e-6, (float(gaux), float(waux))
    k = case.cfg["top_k"]
    excused = check_routing(routing, ref, k).reshape(B, S)
    ok = ~excused
    print(f"{case.what} {dtype}: {int(excused.sum())} of {B * S} tokens "
          f"excused as near-ties; "
          f"{int((~routing.kept.numpy()).sum())} choices dropped")
    assert excused.sum() <= B * S // 4
    if dtype == "float32":
        np.testing.assert_allclose(_f32(gy)[ok], _f32(wy)[ok], atol=TOL,
                                   rtol=TOL)
    else:
        (w32, _), _, _, _ = _run_both(case, x, "float32")
        _assert_within_bf16_noise(_f32(gy)[ok], _f32(wy)[ok],
                                  _f32(w32)[ok])


def test_zero_router_ties_go_to_the_lowest_experts():
    """A router of zeros makes every probability 1/E: both sides pick
    experts 0..k-1 for every token, top-1 first, with the same slots and
    the same drops (12 slots an expert at 32 tokens a group: the first 12
    tokens of each group keep each choice, the rest drop both)."""
    case = MOE_CASES[0]
    cfg = case.cfg
    jp, tp = _moe_params(cfg, 2)
    jp = dict(jp, router={"w": jnp.zeros_like(jp["router"]["w"])})
    tp = dict(tp, router={"w": torch.zeros_like(tp["router"]["w"])})
    x = np.random.default_rng(3).standard_normal(
        (case.B, case.S, cfg["d_model"])).astype(np.float32)
    jc, tc = jmoe.MoeConfig(**cfg), tmoe.MoeConfig(**cfg)
    want, wait = J_MOE(jp, jnp.asarray(x), cfg=jc,
                       compute_dtype=jnp.float32)
    tmoe.ROUTING = []
    try:
        got, gaux = tmoe.moe_apply(tp, torch.from_numpy(x), tc,
                                   compute_dtype=torch.float32)
        (r,) = tmoe.ROUTING
    finally:
        tmoe.ROUTING = None
    top_i, kept, ranked = (np.asarray(a) for a in ref_routing(
        jp, jnp.asarray(x), jc))
    k, E = cfg["top_k"], cfg["n_experts"]
    assert (ranked == np.float32(1 / E)).all()       # exact ties
    np.testing.assert_array_equal(top_i, np.broadcast_to(np.arange(k),
                                                         top_i.shape))
    np.testing.assert_array_equal(r.top_i.numpy(), top_i)
    np.testing.assert_array_equal(r.kept.numpy(), kept)
    C = tmoe._capacity(tc, 32)
    assert C == 12
    assert (r.kept.numpy()[:, :, :C]).all() and \
        not r.kept.numpy()[:, :, C:].any()
    assert (r.margin.numpy() == 0).all()
    np.testing.assert_allclose(_f32(got), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert float(gaux) == pytest.approx(float(wait), abs=1e-6)
    # torch.topk's own order among ties is not the rule; the port's is
    assert torch.equal(torch.sort(torch.full((5, E), 0.125), dim=-1,
                                  descending=True, stable=True)[1][:, :k],
                       torch.arange(k).expand(5, k))


def test_moe_dispatch_invariants():
    """tests/test_layers.py::test_moe_dispatch_invariants on the port,
    with the reference's draws: nothing drops at capacity_factor 2, every
    token's output is nonzero, aux >= 0, and y equals the reference's."""
    kw = dict(d_model=16, n_experts=8, top_k=2, d_expert=8, group_size=32,
              capacity_factor=2.0)
    jc, tc = jmoe.MoeConfig(**kw), tmoe.MoeConfig(**kw)
    jp = jinit(jax.random.PRNGKey(8), jmoe.moe_spec(jc))
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.array(jax.random.normal(jax.random.PRNGKey(9), (2, 32, 16)))
    want, _ = jmoe.moe_apply(jp, jnp.asarray(x), jc,
                             compute_dtype=jnp.float32)
    tmoe.ROUTING = []
    try:
        y, aux = tmoe.moe_apply(tp, torch.from_numpy(x), tc,
                                compute_dtype=torch.float32)
        (r,) = tmoe.ROUTING
    finally:
        tmoe.ROUTING = None
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert float(aux) >= 0
    assert float(y.abs().sum(-1).min()) > 0
    assert bool(r.kept.all())
    np.testing.assert_allclose(_f32(y), np.asarray(want), atol=TOL, rtol=TOL)


def _claims_in_priority_order(r: tmoe.Routing, C: int) -> None:
    """Within each group and expert, the choices that claim it in
    priority order (every top-1 choice of the group, then every top-2,
    each in token order) keep their slot for the first C and drop after."""
    G, k, s = r.kept.shape
    top_i, kept = r.top_i.numpy(), r.kept.numpy()
    for g in range(G):
        claims: dict[int, list[bool]] = {}
        for j in range(k):
            for t in range(s):
                claims.setdefault(int(top_i[g, t, j]), []).append(
                    bool(kept[g, j, t]))
        for e, ks in claims.items():
            n = min(C, len(ks))
            assert ks == [True] * n + [False] * (len(ks) - n), (g, e)


@pytest.mark.parametrize("k", [1, 2])
def test_moe_capacity_drops_tokens_when_tight(k):
    """tests/test_layers.py::test_moe_capacity_drops_tokens_when_tight on
    the port (k = 1: more than 30 % of tokens drop), with the reference's
    draws: the same choices drop on both sides, the same tokens' outputs
    are 0, and top-1 claims come before top-2 (k = 2)."""
    kw = dict(d_model=8, n_experts=2, top_k=k, d_expert=8, group_size=64,
              capacity_factor=0.25, aux_loss_coef=0.0)
    jc, tc = jmoe.MoeConfig(**kw), tmoe.MoeConfig(**kw)
    jp = jinit(jax.random.PRNGKey(10), jmoe.moe_spec(jc))
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.array(jax.random.normal(jax.random.PRNGKey(11), (1, 64, 8)))
    want, _ = jmoe.moe_apply(jp, jnp.asarray(x), jc,
                             compute_dtype=jnp.float32)
    tmoe.ROUTING = []
    try:
        y, _ = tmoe.moe_apply(tp, torch.from_numpy(x), tc,
                              compute_dtype=torch.float32)
        (r,) = tmoe.ROUTING
    finally:
        tmoe.ROUTING = None
    zero = _f32(y.abs().sum(-1) == 0)
    np.testing.assert_array_equal(zero, np.asarray(
        jnp.abs(want).sum(-1) == 0, np.float32))
    if k == 1:
        assert zero.mean() > 0.3
    assert check_routing(r, ref_routing(jp, jnp.asarray(x), jc), k).sum() \
        == 0
    _claims_in_priority_order(r, tmoe._capacity(tc, 64))
    np.testing.assert_allclose(_f32(y), np.asarray(want), atol=TOL, rtol=TOL)


def test_tokens_that_do_not_split_into_groups_are_refused():
    """More than group_size tokens must be a multiple of it: the reference
    asserts it (repro/layers/moe.py:71), the port raises ValueError."""
    kw = dict(d_model=8, n_experts=4, top_k=2, d_expert=8, group_size=64)
    jc, tc = jmoe.MoeConfig(**kw), tmoe.MoeConfig(**kw)
    jp, tp = _moe_params(kw, 4)
    x = np.zeros((3, 30, 8), np.float32)                # 90 tokens
    with pytest.raises(AssertionError):
        jmoe.moe_apply(jp, jnp.asarray(x), jc, compute_dtype=jnp.float32)
    with pytest.raises(ValueError, match="90 tokens do not split into "
                                         "groups of 64"):
        tmoe.moe_apply(tp, torch.from_numpy(x), tc,
                       compute_dtype=torch.float32)
    for shape in ((2, 64, 8), (3, 20, 8)):   # 2 groups; one of 60
        y, _ = tmoe.moe_apply(tp, torch.zeros(shape), tc,
                              compute_dtype=torch.float32)
        assert y.shape == shape


# ---------------------------------------------------------------------------
# the models against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(arch, compute_dtype, drops=True):
    """(reference model with jitted prefill/decode, its params, port
    model, the same params as tensors); ``drops=False`` at the no-drop
    capacity."""
    jc = jcfg.get_reduced_config(arch, compute_dtype=compute_dtype)
    tc = tcfg.get_reduced_config(arch, compute_dtype=compute_dtype)
    if not drops:
        jc, tc = no_drop(jc), no_drop(tc)
    jm, tm = jbuild(jc), tbuild(tc, "cpu")
    jm = dataclasses.replace(jm, prefill_fn=jax.jit(jm.prefill_fn),
                             decode_fn=jax.jit(jm.decode_fn))
    jp = jbuild(jcfg.get_reduced_config(arch)).init(jax.random.PRNGKey(0))
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@functools.lru_cache(maxsize=None)
def _ref_block(cfg, kind):
    """The reference's ``block_apply`` for ``kind``, jitted, returning
    also a moe block's routing (``ref_routing`` on the normed input its
    MoE FFN takes, computed as its ``block_apply`` computes it)."""
    cd = jnp.dtype(cfg.compute_dtype)
    napply = jlm._norm_fns(cfg)[1]

    @jax.jit
    def run(p, x, positions, cache):
        routing = None
        if kind == "moe":
            h, _ = jattn.attention_apply(p["attn"], napply(p["ln1"], x),
                                         cfg.attn(None), positions=positions,
                                         cache=cache, compute_dtype=cd)
            routing = ref_routing(p["moe"], napply(p["ln2"], x + h),
                                  cfg.moe())
        x, cache, _ = jlm.block_apply(cfg, kind, p, x, positions=positions,
                                      cache=cache, xbar=None,
                                      compute_dtype=cd)
        return x, cache, routing
    return run


def ref_forward(cfg, jp, tokens, caches=None, start=0):
    """The reference's forward (``lm_forward`` over the prefix and the
    periods, each period's parameters cast as its scan body casts them,
    then ``lm_logits``), block by block with its own functions, recording
    each moe block's routing in order.  ``caches`` (decode): a dict of
    per-block caches, replaced by the blocks' new ones.  Returns (logits,
    routings)."""
    cd = jnp.dtype(cfg.compute_dtype)
    lay = jlm.stack_layout(cfg)
    B, L = tokens.shape
    x = jlm.embed_inputs(cfg, jp, {"tokens": jnp.asarray(tokens)}, cd)
    pos = jnp.broadcast_to(jnp.arange(L)[None] + start, (B, L))
    blocks = [(k, jp["prefix"][i], ("prefix", i))
              for i, k in enumerate(lay.prefix)]
    for per in range(lay.periods):
        pp = jcast(jax.tree.map(lambda a: a[per], jp["stack"]), cd)
        blocks += [(k, pp[f"b{i}_{k}"], (per, i))
                   for i, k in enumerate(lay.pattern)]
    routes = []
    for kind, p, key in blocks:
        c = caches[key] if caches is not None else None
        x, c, r = _ref_block(cfg, kind)(p, x, pos, c)
        if caches is not None:
            caches[key] = c
        if r is not None:
            routes.append(r)
    x = jlm._norm_fns(cfg)[1](jp["final_norm"], x)
    return jlm.lm_logits(cfg, jp, x), routes


def ref_caches(cfg, B, max_len, dtype):
    lay = jlm.stack_layout(cfg)
    keys = [(k, ("prefix", i)) for i, k in enumerate(lay.prefix)]
    keys += [(k, (per, i)) for per in range(lay.periods)
             for i, k in enumerate(lay.pattern)]
    return {key: jlm.init_block_cache(cfg, k, B, max_len, dtype)
            for k, key in keys}


class Flips:
    """Routing of the port against the reference's, call by call (a call:
    one moe block on the tokens at rows ``b`` and positions ``t``).  A
    token whose experts differ is a flip; a flip at a token that no
    earlier flip reached (a root) must be a near-tie on the reference's
    side (its margin below ``near``).  A flip reaches its sequence's
    later positions (causal attention, and decode's cache), and where its
    group drops a choice on either side, every token of the group (their
    slots move with it).  Keep masks must be equal where no flip reached.
    ``affected`` (B, L) marks what the flips reached; ``roots`` counts
    them."""

    def __init__(self, B, L, k, near):
        self.affected = np.zeros((B, L), bool)
        self.k, self.near, self.roots = k, near, 0

    def call(self, port: tmoe.Routing, ref, b, t):
        k = self.k
        G, _, s = port.kept.shape
        top_p = port.top_i.numpy().reshape(-1, k)
        kept_p = port.kept.numpy().transpose(0, 2, 1).reshape(-1, k)
        top_r = np.asarray(ref[0]).reshape(-1, k)
        kept_r = np.asarray(ref[1]).transpose(0, 2, 1).reshape(-1, k)
        ranked = np.asarray(ref[2]).reshape(len(top_r), -1)[:, :k + 1]
        margin = (ranked[:, :-1] - ranked[:, 1:]).min(-1)
        flip = (top_p != top_r).any(-1)
        root = flip & ~self.affected[b, t]
        assert (margin[root] < self.near).all(), margin[root]
        self.roots += int(root.sum())
        for f in np.flatnonzero(flip):
            grp = slice(f // s * s, (f // s + 1) * s)
            drops = not (kept_p[grp].all() and kept_r[grp].all())
            for m in (range(grp.start, grp.stop) if drops else (f,)):
                self.affected[b[m], t[m]:] = True
        ok = ~self.affected[b, t]
        np.testing.assert_array_equal(kept_p[ok], kept_r[ok])


NEAR_TIE_BF16 = 1e-2


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def models(request):
    return request.param + _models(*request.param)


def _tokens(B, L, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, L),
                                                dtype=np.int32)


def _held(got, want, dtype, ok, ref32, what, least=0.5):
    """Logits on the rows no flip reached (at least ``least`` of them):
    float32 within LOGIT_TOL, bf16 within the reference's own bf16 noise
    on those rows."""
    assert ok.mean() >= least, f"{what}: {int((~ok).sum())} rows reached"
    if not ok.any():
        return
    got, want = _f32(got)[ok], _f32(want)[ok]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL, err_msg=what)
    else:
        _assert_within_bf16_noise(got, want, _f32(ref32)[ok])


def test_param_tree_carries_every_leaf(models):
    arch, _, jm, jp, tm, tp = models
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    tleaves = tshd.tree_leaves(tp)
    assert len(jleaves) == len(tleaves) > 0
    for (path, a), b in zip(jleaves, tleaves):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32, path
        np.testing.assert_array_equal(_f32(b), np.asarray(a))
    spec = jax.tree.leaves(tm.abstract_params())
    assert [tuple(s.shape) for s in spec] == [a.shape for _, a in jleaves]
    moe = tp["stack"]["b0_moe"]["moe"]
    shared = {"shared"} if arch.startswith("moonshot") else set()
    assert set(moe) == {"router", "wg", "wi", "wo"} | shared
    assert moe["wg"].shape == (2, 8, 64, 32) and \
        moe["wo"].shape == (2, 8, 32, 64)
    assert len(tp["prefix"]) == (1 if arch.startswith("moonshot") else 0)
    if tp["prefix"]:
        assert tp["prefix"][0]["mlp"]["wi"]["w"].shape == (64, 128)


@pytest.mark.parametrize("drops", [True, False], ids=["drops", "no drops"])
def test_prefill_matches_the_reference(models, drops):
    """4 rows of 32 tokens: two groups of 64 (two rows each), at C = 20
    where choices drop (the same on both sides), and at the no-drop
    capacity.  The block-by-block reference equals its ``prefill_fn``;
    routing and logits are held as the module docstring says.  In bf16 a
    flip where choices drop reaches its whole group, so there the rows
    may all be reached (the flips are still held to near-ties)."""
    arch, dtype, *_ = models
    jm, jp, tm, tp = _models(arch, dtype, drops)
    tok = _tokens(4, 32)
    want, ref_routes = ref_forward(jm.cfg, jp, tok)
    np.testing.assert_allclose(
        _f32(want), _f32(jm.prefill_fn(jp, {"tokens": jnp.asarray(tok)})),
        atol=TOL, rtol=TOL)
    before = tops.flash_attention.launches
    tmoe.ROUTING = []
    try:
        got = tm.prefill_fn(tp, {"tokens": torch.from_numpy(tok)})
        routing = tmoe.ROUTING
    finally:
        tmoe.ROUTING = None
    assert tops.flash_attention.launches == before     # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == (4, 32, 512)
    assert len(routing) == len(ref_routes) == 2
    assert all(r.kept.shape == (2, 2, 64) for r in routing)
    flips = Flips(4, 32, tm.cfg.top_k,
                  NEAR_TIE if dtype == "float32" else NEAR_TIE_BF16)
    b, t = np.divmod(np.arange(128), 32)
    for r, ref in zip(routing, ref_routes):
        flips.call(r, ref, b, t)
    dropped = sum(int((~r.kept).sum()) for r in routing)
    print(f"{arch} {dtype}: {dropped} of 512 choices dropped, "
          f"{flips.roots} near-tie flips reaching "
          f"{int(flips.affected.sum())} of 128 tokens")
    assert (dropped > 0) == drops
    ref32 = None
    if dtype == "bfloat16":
        ref32 = ref_forward(_models(arch, "float32", drops)[0].cfg, jp,
                            tok)[0]
    _held(got, want, dtype, ~flips.affected, ref32, "prefill",
          least=0.0 if drops and dtype == "bfloat16" else 0.5)


def _ref_decode(jm, jp, tok, cache_dtype):
    """The block-by-block reference decoding ``tok`` (B, L) step by step:
    logits (B, L, V) and the routings of every step."""
    caches = ref_caches(jm.cfg, tok.shape[0], 32, cache_dtype)
    out, routes = [], []
    for step in range(tok.shape[1]):
        logits, r = ref_forward(jm.cfg, jp, tok[:, step:step + 1], caches,
                                start=step)
        out.append(logits)
        routes.append(r)
    return jnp.concatenate(out, axis=1), routes


def test_decode_matches_the_reference(models):
    """8 decode steps, float32 cache, step by step (a decode group is the
    batch's 2 tokens: nothing drops); the block-by-block reference equals
    its ``decode_fn``."""
    arch, dtype, jm, jp, tm, tp = models
    tok = _tokens(2, 8, 1)
    want, ref_routes = _ref_decode(jm, jp, tok, jnp.float32)
    jcache, direct = jm.init_cache(2, 16, jnp.float32), []
    for step in range(8):
        logits, jcache = jm.decode_fn(jp, jcache, {
            "tokens": jnp.asarray(tok[:, step:step + 1]),
            "length": jnp.int32(step)})
        direct.append(logits)
    np.testing.assert_allclose(_f32(want),
                               _f32(jnp.concatenate(direct, axis=1)),
                               atol=TOL, rtol=TOL)
    tc = tm.init_cache(2, 16, torch.float32)
    assert tc["stack"]["b0_moe"]["k"].shape[:3] == (2, 2, 16)
    flips = Flips(2, 8, tm.cfg.top_k,
                  NEAR_TIE if dtype == "float32" else NEAR_TIE_BF16)
    got = []
    for step in range(8):
        tmoe.ROUTING = []
        try:
            logits, tc_out = tm.decode_fn(
                tp, tc, {"tokens": torch.from_numpy(tok[:, step:step + 1]),
                         "length": step})
            routing = tmoe.ROUTING
        finally:
            tmoe.ROUTING = None
        assert tc_out is tc and len(routing) == 2
        for r, ref in zip(routing, ref_routes[step]):
            assert bool(r.kept.all())
            flips.call(r, ref, np.arange(2), np.full(2, step))
        got.append(logits)
    got = torch.cat(got, dim=1)
    print(f"{arch} {dtype}: {flips.roots} near-tie flips reaching "
          f"{int(flips.affected.sum())} of 16 decode positions")
    ref32 = None
    if dtype == "bfloat16":
        ref32 = _ref_decode(_models(arch, "float32")[0], jp, tok,
                            jnp.float32)[0]
    _held(got, want, dtype, ~flips.affected, ref32, "decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_prefill_at_the_no_drop_capacity(arch):
    """The port's decode against its own prefill, float32 compute and
    cache, at capacity_factor = E / k (C = the group): the same function
    summed in other orders, routing equal token for token.  At the
    configured capacity the prefill drops choices that decode keeps."""
    _, _, tm, tp = _models(arch, "float32", drops=False)
    tok = torch.from_numpy(_tokens(3, 20, 2))
    tmoe.ROUTING = []
    try:
        want = tm.prefill_fn(tp, {"tokens": tok})
        pre = list(tmoe.ROUTING)
        tmoe.ROUTING.clear()
        cache = tm.init_cache(3, 32, torch.float32)
        for step in range(20):
            got, cache = tm.decode_fn(
                tp, cache, {"tokens": tok[:, step:step + 1], "length": step})
            torch.testing.assert_close(got[:, 0], want[:, step],
                                       atol=LOGIT_TOL, rtol=LOGIT_TOL)
        dec = list(tmoe.ROUTING)
    finally:
        tmoe.ROUTING = None
    n_moe = len(pre)
    assert n_moe == 2 and len(dec) == 20 * n_moe
    for layer in range(n_moe):
        assert bool(pre[layer].kept.all())
        steps = torch.stack([dec[step * n_moe + layer].top_i[0]
                             for step in range(20)], dim=1)   # (3, 20, k)
        assert torch.equal(steps, pre[layer].top_i[0].reshape(3, 20, -1))
    _, _, tm_drop, _ = _models(arch, "float32")
    tmoe.ROUTING = []
    try:
        dropping = tm_drop.prefill_fn(tp, {"tokens": tok})
        kept = [r.kept for r in tmoe.ROUTING]
    finally:
        tmoe.ROUTING = None
    assert not all(bool(k.all()) for k in kept)
    assert not torch.allclose(dropping, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batched_server_matches_the_reference(arch, dtype):
    """``BatchedServer`` token for token against the reference's, 8-token
    prompts and 16 new tokens (23 steps) with a padded slot, a cache of
    the compute dtype.  The reference decodes block by block on the
    tokens the port's server fed (its ``generate`` on the same tokens up
    to the first difference): every generated token is its argmax but at
    a logit near-tie (top-2 gap within 1e-4 in float32; in bf16 within
    1e-2, the bar of tests/test_torch_lm.py, plus one bf16 step at the
    row's largest logit, the resolution of bf16 logits) or where a
    routing flip at a near-tie reached the slot; a slot's tokens after its
    first difference are excused (counted)."""
    jm, jp, tm, tp = _models(arch, dtype)
    prompts = PROMPTS[:3]
    js = jserve.BatchedServer(jm, jp, batch=4, max_len=32,
                              cache_dtype=getattr(jnp, dtype))
    ts = tserve.BatchedServer(tm, tp, batch=4, max_len=32,
                              cache_dtype=getattr(torch, dtype))
    fed, routes = [], []

    def recording(p, cache, batch):
        fed.append(batch["tokens"][:, 0].numpy().copy())
        tmoe.ROUTING = []
        try:
            out = tm.decode_fn(p, cache, batch)
            routes.append(tmoe.ROUTING)
        finally:
            tmoe.ROUTING = None
        return out

    ts.decode = recording
    want = js.generate(prompts, 16)
    got = ts.generate(prompts, 16)
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)
    assert ts.stats.steps == 23 and ts.stats.tokens_out == 64
    fed = np.stack(fed, axis=1)                                # (4, 23)
    ref_logits, ref_routes = _ref_decode(jm, jp, fed, getattr(jnp, dtype))
    ref_logits = np.asarray(ref_logits, np.float32)
    flips = Flips(4, 23, tm.cfg.top_k,
                  NEAR_TIE if dtype == "float32" else NEAR_TIE_BF16)
    for step in range(23):
        for r, ref in zip(routes[step], ref_routes[step]):
            flips.call(r, ref, np.arange(4), np.full(4, step))
    excused = 0
    for slot, (g, w) in enumerate(zip(got, want)):
        for i, (a, b) in enumerate(zip(g, w)):
            if a != b:
                step = 7 + i
                row = np.sort(ref_logits[slot, step])
                bar = LOGIT_TOL if dtype == "float32" else \
                    1e-2 + float(bf16_step(row[-1:])[0])
                assert flips.affected[slot, step] or \
                    row[-1] - row[-2] <= bar, (slot, i, row[-1] - row[-2])
                assert a == int(ref_logits[slot, step].argmax()) or \
                    flips.affected[slot, step] or \
                    row[-1] - row[-2] <= bar
                excused += len(g) - i
                break
    # float32: at most one slot left at a near-tie; bf16: two
    assert excused <= (16 if dtype == "float32" else 32), (got, want)
    print(f"{arch} {dtype}: {flips.roots} near-tie routing flips, "
          f"{excused} of 48 tokens excused")


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smoke_bf16_decode_figure_is_the_references(arch):
    """``chip_smoke.py`` step 20 holds bf16 decode against bf16 prefill at
    full width within 2 d, d = ``MOE_BF16_DIST[arch]``: the reference's
    own bf16-vs-float32 relative distance on its reduced config, the
    largest over 8 batches of 4 x 16 tokens from numpy seeds 0-7, at the
    no-drop capacity.  The figure written in the script is the
    reference's, measured here; and the port's own bf16 decode against
    its bf16 prefill on the reduced config lies within 2 d."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    fns = {}
    for dtype in ("bfloat16", "float32"):
        jm, _, _, _ = _models(arch, dtype, drops=False)
        fns[dtype] = jm.prefill_fn
    jp = _models(arch, "float32")[1]
    dists = []
    for seed in range(8):
        tok = jnp.asarray(_tokens(4, 16, seed))
        a, b = (np.asarray(fns[d](jp, {"tokens": tok}), np.float32)
                for d in ("bfloat16", "float32"))
        dists.append(np.linalg.norm(a - b) / np.linalg.norm(b))
    d = smoke.MOE_BF16_DIST[arch]
    assert f"{max(dists):.4g}" == f"{d:.4g}", (max(dists), d)
    # the port's decode against its prefill, both bf16, on the reduced config
    _, _, tm, tp = _models(arch, "bfloat16", drops=False)
    tok = torch.from_numpy(_tokens(4, 16, 9))
    pre = tm.prefill_fn(tp, {"tokens": tok})
    cache, dec = tm.init_cache(4, 16), []
    for step in range(16):
        logits, cache = tm.decode_fn(tp, cache, {
            "tokens": tok[:, step:step + 1], "length": step})
        dec.append(logits)
    dec = torch.cat(dec, dim=1)
    rel = float(torch.linalg.norm(dec - pre) / torch.linalg.norm(pre))
    print(f"{arch}: d = {d}, the port's bf16 decode vs prefill {rel:.4f}")
    assert rel <= 2 * d


# ---------------------------------------------------------------------------
# the smoke tests of tests/test_models_smoke.py on the port
# ---------------------------------------------------------------------------

def _smoke_batch(cfg, B=2, S=64):
    batch = TokenStream(cfg.vocab_size, S, B, seed=1).batch_at(0)
    return {k: v.to("cpu") for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_train_step(arch):
    """tests/test_models_smoke.py:28 on the port: a finite loss, finite
    gradients, and one SGD step of 0.5 lowers the loss."""
    cfg = tcfg.get_reduced_config(arch)
    model = tbuild(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = _smoke_batch(cfg)
    leaves = tshd.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = model.loss_fn(params, batch)
    assert loss.shape == () and bool(torch.isfinite(loss))
    assert float(metrics["aux"].detach()) > 0
    grads = torch.autograd.grad(loss, leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with torch.no_grad():
        it = iter(grads)
        params2 = tshd.tree_map(lambda p: p - 0.5 * next(it), params)
        loss2, _ = model.loss_fn(params2, batch)
    assert float(loss2) < float(loss.detach()), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_prefill_logits_shape(arch):
    """tests/test_models_smoke.py:45 on the port."""
    cfg = tcfg.get_reduced_config(arch)
    model = tbuild(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": _smoke_batch(cfg)["tokens"]}
    logits = model.prefill_fn(params, batch)
    assert logits.shape == (2, 64, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_steps(arch):
    """tests/test_models_smoke.py:61 on the port."""
    cfg = tcfg.get_reduced_config(arch)
    model = tbuild(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    B, MAX = 2, 32
    cache = model.init_cache(B, MAX)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    for step in range(4):
        logits, cache = model.decode_fn(params, cache,
                                        {"tokens": tok, "length": step})
        assert logits.shape == (B, 1, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all()), arch
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)


# ---------------------------------------------------------------------------
# the loss, its auxiliary term and the gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

MODES = {"standard": {},
         "kernel": dict(crossbar=True, xbar_use_kernel=True)}


@functools.lru_cache(maxsize=None)
def _ref_loss_grads(arch, mode):
    jc = jcfg.get_reduced_config(arch, compute_dtype="float32", **MODES[mode])
    jm = jbuild(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 512, (2, 64)).astype(np.int32),
             "labels": rng.integers(0, 512, (2, 64)).astype(np.int32)}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        jm.loss_fn, has_aux=True))(jp, jax.tree.map(jnp.asarray, batch))
    return jp, batch, float(loss), float(metrics["aux"]), _flat_ref(grads)


def _nrel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch, mode, monkeypatch):
    """float32 compute, remat "full": the loss (cross-entropy + aux) and
    its aux term, and every gradient leaf (the routers' through the
    gates and the aux loss's ``me``) against ``jax.value_and_grad``."""
    near = _NearBoundary(monkeypatch)
    jp, batch, want_loss, want_aux, want = _ref_loss_grads(arch, mode)
    tc = tcfg.get_reduced_config(arch, compute_dtype="float32",
                                 **MODES[mode])
    assert tc.remat == "full"
    tm = tbuild(tc, "cpu")
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    leaves = tshd.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    before = {n: getattr(tops, n).launches
              for n in ("crossbar_fwd", "flash_attention")}
    loss, metrics = tm.loss_fn(tp, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert {n: getattr(tops, n).launches for n in before} == before  # CPU
    got = {_key(path): g.numpy() for (path, _), g in zip(_walk(tp), grads)}
    assert set(got) == set(want)
    aux = float(metrics["aux"])
    assert aux > 0 and abs(aux - want_aux) <= 1e-6
    assert float(loss.detach()) == pytest.approx(
        float(metrics["ce"]) + aux, rel=1e-6)
    routers = [k for k in got if k.endswith("router/w")]
    assert routers and all(np.abs(got[k]).max() > 0 for k in routers)
    loss = float(loss.detach())
    strict = abs(loss - want_loss) <= 1e-5 * abs(want_loss) and all(
        np.abs(got[k] - w).max() <= 1e-4 * np.abs(w).max()
        for k, w in want.items())
    if not strict:          # excused only next to a code boundary
        print(f"{arch} {mode}: off the fp32 bar with {near.count} "
              f"quantizer inputs near a code boundary")
        assert mode == "kernel" and near.count > 0
        assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
        for k, w in want.items():
            assert _nrel(got[k], w) <= 0.1, k


# ---------------------------------------------------------------------------
# the CLI and the entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert p.returncode == 0, p.stderr
    lines = p.stdout.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:4]] == \
        ["req0", "req1", "req2", "req3"]
    assert "128 tokens in" in lines[-1] and "(39 decode steps)" in lines[-1]


@pytest.mark.parametrize("arch", ARCHS)
def test_build_model_defaults_to_cuda(arch, monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbuild(tcfg.get_config(arch))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", arch, "--reduced"])
