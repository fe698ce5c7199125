"""The port's MoE layer against ``repro.models.moe`` with the same weights
and inputs, in float32 on the CPU: both dispatch scopes (one global group,
G = 1; a group per batch row, G = B), with and without arctic's dense
residual MLP, and with assignments dropped past capacity; ``_capacity``
against the reference's over a hypothesis range.

Tolerance 1e-5 on the output and the aux loss (float32 sums in another
order).  The routing's top-k is compared index for index except at near
ties (the k-th and the (k+1)-th probability within 1e-6), where the two
packages' top-k may order equal keys differently: those are counted and
left out of the exact comparison."""
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro.configs import get_arch, reduced, with_overrides
from repro.models import moe as RMoE
from repro.models.params import init_params as ref_init_params
from repro_torch import configs as tconfigs
from repro_torch.models import moe as TMoE
from repro_torch.models.params import from_numpy_tree

TOL = 1e-5
NEAR_TIE = 1e-6


def _case(arch: str, grouped: bool, B: int, S: int, cf=None, seed: int = 0):
    """(reference cfg, port cfg, numpy params, x) for one MoE layer."""
    over = {"moe_sharded_dispatch": grouped}
    cfg = with_overrides(reduced(get_arch(arch)), **over)
    tcfg = tconfigs.with_overrides(tconfigs.reduced(tconfigs.get_arch(arch)), **over)
    if cf is not None:
        cfg = with_overrides(cfg, moe=with_overrides(cfg.moe, capacity_factor=cf))
        tcfg = tconfigs.with_overrides(tcfg, moe=tconfigs.with_overrides(tcfg.moe,
                                                                         capacity_factor=cf))
    assert repr(cfg) == repr(tcfg)
    p = jax.tree_util.tree_map(np.asarray, ref_init_params(
        RMoE.moe_specs(cfg), jax.random.PRNGKey(seed), jnp.float32))
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return cfg, tcfg, p, x


def _groups(tcfg, x):
    B, S, d = x.shape
    G = B if tcfg.moe_sharded_dispatch else 1
    return torch.from_numpy(x).reshape(G, B * S // G, d)


def _dropped(tcfg, p, x) -> int:
    """Assignments past capacity in the port's dispatch of x."""
    xg = _groups(tcfg, x)
    _, _, top_e = TMoE.route(tcfg, xg, torch.from_numpy(p["router"]))
    counts = torch.nn.functional.one_hot(top_e.reshape(xg.shape[0], -1),
                                         tcfg.moe.num_experts).sum(1)
    return int((counts - TMoE._capacity(tcfg, xg.shape[1])).clamp(min=0).sum())


def _run(cfg, tcfg, p, x):
    y, aux = RMoE.apply_moe(cfg, p, jnp.asarray(x))
    ty, taux = TMoE.apply_moe(tcfg, from_numpy_tree(p, "cpu"), torch.from_numpy(x))
    assert tuple(ty.shape) == y.shape and ty.dtype == torch.float32
    assert taux.dtype == torch.float32 and taux.ndim == 0
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=TOL, rtol=TOL)
    assert abs(float(taux) - float(aux)) <= TOL
    return ty, taux


@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "arctic-480b"],
                         ids=["moe", "dense_residual"])
def test_apply_moe_matches_reference(arch, grouped):
    cfg, tcfg, p, x = _case(arch, grouped, B=2, S=12)
    assert ("dense" in p) == (arch == "arctic-480b")
    ty, _ = _run(cfg, tcfg, p, x)
    # deterministic: a second call gives the same bits
    again, _ = TMoE.apply_moe(tcfg, from_numpy_tree(p, "cpu"), torch.from_numpy(x))
    assert torch.equal(ty, again)


@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "arctic-480b"],
                         ids=["moe", "dense_residual"])
def test_apply_moe_matches_reference_under_drops(arch, grouped):
    """capacity_factor 0.25: C stays at its floor of 8 while each expert
    gets ~16 assignments, so about half of them are dropped."""
    cfg, tcfg, p, x = _case(arch, grouped, B=2, S=32, cf=0.25, seed=1)
    assert _dropped(tcfg, p, x) > 0
    _run(cfg, tcfg, p, x)


def test_rows_compete_for_capacity_only_under_global_dispatch():
    """Under global dispatch a row's output depends on the rows before it
    once an expert overflows (the stable sort gives earlier tokens the
    first slots, so row 1's assignments drop first); under grouped dispatch
    it does not.  Both as the reference computes them."""
    for grouped in (False, True):
        # cf 0.75: row 0 alone fits (~16 of C 24 per expert), both rows do not
        cfg, tcfg, p, x = _case("moonshot-v1-16b-a3b", grouped, B=2, S=32, cf=0.75, seed=2)
        assert grouped or _dropped(tcfg, p, x) > 0
        ty, _ = _run(cfg, tcfg, p, x)
        x2 = x.copy()
        x2[0] = np.random.default_rng(3).standard_normal(x[0].shape)
        ty2, _ = _run(cfg, tcfg, p, x2)
        assert torch.equal(ty[1], ty2[1]) == grouped


@pytest.mark.parametrize("grouped", [False, True], ids=["global", "grouped"])
def test_routing_matches_reference_away_from_near_ties(grouped):
    cfg, tcfg, p, x = _case("moonshot-v1-16b-a3b", grouped, B=4, S=32, seed=4)
    xg = _groups(tcfg, x)
    probs, top_p, top_e = TMoE.route(tcfg, xg, torch.from_numpy(p["router"]))
    logits = jnp.einsum("gtd,de->gte", jnp.asarray(xg.numpy()), p["router"])
    rprobs = jax.nn.softmax(logits, axis=-1)
    rp, re = jax.lax.top_k(rprobs, cfg.moe.top_k)
    np.testing.assert_allclose(probs.numpy(), np.asarray(rprobs), atol=1e-6)
    # rows where two of the top k+1 probabilities lie within NEAR_TIE: the
    # two top-k's may order them differently (or pick the other one at the
    # k-th place), so they are counted and left out
    k = cfg.moe.top_k
    srt = -np.sort(-np.asarray(rprobs), axis=-1)[..., :k + 1]
    near = (np.abs(np.diff(srt, axis=-1)) < NEAR_TIE).any(-1)
    assert near.mean() <= 0.05, f"{int(near.sum())} of {near.size} rows near a tie"
    far = ~near
    assert np.array_equal(top_e.numpy()[far], np.asarray(re)[far])
    np.testing.assert_allclose(top_p.numpy()[far],
                               np.asarray(rp / jnp.sum(rp, axis=-1, keepdims=True))[far],
                               atol=1e-6)


@dataclass
class _FakeMoE:
    top_k: int
    num_experts: int
    capacity_factor: float


@dataclass
class _FakeCfg:
    moe: _FakeMoE


@settings(max_examples=50, deadline=None)
@given(t=st.integers(1, 4096), e=st.integers(1, 128), k=st.integers(1, 8),
       cf=st.floats(0.1, 4.0))
@example(t=17, e=2, k=1, cf=1.0)
def test_capacity_equals_reference(t, e, k, cf):
    cfg = _FakeCfg(_FakeMoE(min(k, e), e, cf))
    C = TMoE._capacity(cfg, t)
    assert C == RMoE._capacity(cfg, t)
    assert C % 8 == 0 and C >= 8
    if (t, e, k, cf) == (17, 2, 1, 1.0):
        assert C == 8 < 17 * 1 / 2         # below the balanced load, as the reference


# ---------------------------------------------------------------------------
# the dropless dispatch (granite-4.0-h), which the JAX package does not have
# ---------------------------------------------------------------------------

def _dropless_case(dense_residual: bool, T: int = 64, E: int = 8, skew: float = 3.0):
    """(port cfg, torch params, x (1, T, d)) of a dropless MoE layer whose
    router sends every token to expert 0 (a direction all tokens share,
    which its router column reads ``skew`` times): T assignments to one
    expert, past any capacity the capacity dispatch would give it."""
    from dataclasses import replace

    from repro_torch.models.params import init_params as t_init_params

    tcfg = tconfigs.reduced(tconfigs.get_arch("granite-4.0-h-small"))
    tcfg = replace(tcfg, moe=replace(tcfg.moe, num_experts=E, dense_residual=dense_residual))
    assert tcfg.moe.dropless and tcfg.param_dtype == "float32"
    p = t_init_params(TMoE.moe_specs(tcfg), 5, torch.float32, "cpu")
    rng = np.random.default_rng(6)
    u = torch.from_numpy(rng.standard_normal(tcfg.d_model).astype(np.float32))
    u /= u.norm()
    p["router"][:, 0] += skew * u
    x = torch.from_numpy(rng.standard_normal((1, T, tcfg.d_model)).astype(np.float32)) + 2 * u
    return tcfg, p, x


def _per_expert_loop(tcfg, p, x):
    """Each expert's SwiGLU on the rows routed to it, weighted by the
    renormalised top-k probability; no capacity, nothing dropped."""
    from repro_torch.models.mlp import apply_mlp

    xt = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xt @ p["router"], dim=-1)
    top_p, top_e = torch.topk(probs, tcfg.moe.top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    y = torch.zeros_like(xt)
    for e in range(tcfg.moe.num_experts):
        tok, slot = torch.nonzero(top_e == e, as_tuple=True)
        h = torch.nn.functional.silu(xt[tok] @ p["w_gate"][e]) * (xt[tok] @ p["w_up"][e])
        y[tok] += top_p[tok, slot, None] * (h @ p["w_down"][e])
    if tcfg.moe.dense_residual:
        y = y + apply_mlp(tcfg, p["dense"], xt)
    return y.reshape(x.shape)


@pytest.mark.parametrize("dense_residual", [False, True], ids=["routed", "shared"])
def test_dropless_dispatch_matches_a_per_expert_loop_under_skewed_routing(dense_residual):
    from dataclasses import replace

    tcfg, p, x = _dropless_case(dense_residual)
    capacity = replace(tcfg, moe=replace(tcfg.moe, dropless=False))
    dropped = _dropped(capacity, {"router": p["router"].numpy()}, x.numpy())
    assert dropped >= x.shape[1] // 4           # the capacity dispatch drops many
    y, aux = TMoE.apply_moe(tcfg, p, x)
    torch.testing.assert_close(y, _per_expert_loop(tcfg, p, x), atol=TOL, rtol=TOL)
    assert aux.ndim == 0 and torch.isfinite(aux)
    yc, _ = TMoE.apply_moe(capacity, p, x)
    assert not torch.allclose(yc, y, atol=1e-3)


def test_dropless_aux_loss_is_the_capacity_dispatchs():
    """The load-balancing term counts every assignment: with no drop the
    two dispatches see the same counts and give the same aux loss."""
    from dataclasses import replace

    tcfg, p, x = _dropless_case(False, skew=0.0)
    _, aux = TMoE.apply_moe(tcfg, p, x)
    _, aux_c = TMoE.apply_moe(replace(tcfg, moe=replace(tcfg.moe, dropless=False)), p, x)
    assert abs(float(aux) - float(aux_c)) <= TOL


@pytest.mark.parametrize("T", [1, 3, 64])
def test_dropless_rows_reach_every_routed_expert(T):
    """``ops.moe_experts``' plain version is each group's SwiGLU, and the
    dispatch's end rows cover all T*k assignments, whatever T."""
    from repro_torch.kernels import ops

    tcfg, p, x = _dropless_case(True, T=T)
    torch.testing.assert_close(TMoE.apply_moe(tcfg, p, x)[0], _per_expert_loop(tcfg, p, x),
                               atol=TOL, rtol=TOL)
    E, d, f = p["w_gate"].shape
    ends = torch.tensor([0, 2, 2, 5, 5, 5, 6, 6], dtype=torch.int32)[:E]
    rows = torch.randn(6, d)
    out = ops.moe_experts(rows, p["w_gate"], p["w_up"], p["w_down"], ends)
    for e, (a, b) in enumerate(zip([0, *ends[:-1].tolist()], ends.tolist())):
        h = torch.nn.functional.silu(rows[a:b] @ p["w_gate"][e]) * (rows[a:b] @ p["w_up"][e])
        torch.testing.assert_close(out[a:b], h @ p["w_down"][e])
