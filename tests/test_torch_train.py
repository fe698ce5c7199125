"""The port's training path against the JAX package on the CPU: optimizer,
gradients, train step, trainer, checkpoints and data, on reduced configs in
float32, with the reference's own weights carried over by
``from_numpy_tree``.

Tolerances, and why:

* schedules, norms and optimizer updates: float32 arithmetic written in the
  reference's order, so rtol 1e-6 (XLA and PyTorch may differ by an ulp in
  ``pow``, ``cos`` or ``sqrt``); a bf16 parameter may then round to the
  neighbouring bf16 value, so bf16 leaves allow one bf16 ulp (2**-7
  relative);
* gradients of ``loss_fn``: 1e-4 of each leaf's largest gradient (float32
  sums in another order through two layers and the vocab projection);
* parameters after a train step: Adam's first step moves each parameter by
  about ``lr * sign(g)``, and a gradient near zero can take the other sign
  on either side, so single elements may differ by up to ``2 * lr``; the
  mean difference must stay below 1e-6;
* the 30-step loss curve: 1e-4 absolute (float32 rounding in another order,
  carried through 30 AdamW steps at lr 3e-3; the largest gap measured when
  the test was written was 1.9e-6).
"""
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as RCheckpointer
from repro.configs import get_arch, reduced
from repro.data.pipeline import make_pipeline as rpipe
from repro.models import model as RM
from repro.optim import optimizer as RO
from repro.train.steps import make_eval_step as r_eval_step
from repro.train.steps import make_train_step as r_train_step
from repro.train.trainer import Trainer as RTrainer
from repro_torch import configs as tconfigs
from repro_torch.checkpoint.checkpointer import Checkpointer as TCheckpointer
from repro_torch.data.pipeline import make_pipeline as tpipe
from repro_torch.models.params import from_numpy_tree
from repro_torch.optim import optimizer as TO
from repro_torch.train.steps import loss_and_grads
from repro_torch.train.steps import make_eval_step as t_eval_step
from repro_torch.train.steps import make_train_step as t_train_step
from repro_torch.train.trainer import InjectedFailure, Trainer as TTrainer
from repro_torch.utils import tree_leaves

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
BF16_ULP = 2.0 ** -7


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _setup(arch):
    cfg = reduced(get_arch(arch))
    tcfg = tconfigs.reduced(tconfigs.get_arch(arch))
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    tparams = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return cfg, tcfg, params, tparams


def _ocfgs(**kw):
    return RO.OptimizerConfig(**kw), TO.OptimizerConfig(**kw)


def _jbatch(b):
    return jax.tree_util.tree_map(jnp.asarray, b)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_schedules_match_reference(schedule):
    r, t = _ocfgs(lr=3e-3, warmup_steps=7, total_steps=120, schedule=schedule)
    for step in (0, 1, 3, 7, 8, 30, 100, 107, 119, 120, 500):
        want = float(RO.schedule_lr(r, step))
        got = TO.schedule_lr(t, step)
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((48, 40)).astype(np.float32) * 0.1,
            "b": rng.standard_normal((40,)).astype(np.float32) * 0.1,
            "k": rng.standard_normal((2, 33, 36)).astype(np.float32) * 0.1,
            "n": [{"s": rng.standard_normal((16, 8)).astype(np.float32)}]}


def _to_both(tree, dtypes):
    r = {k: jnp.asarray(v, dtypes.get(k, jnp.float32)) if not isinstance(v, list) else
         [{kk: jnp.asarray(vv) for kk, vv in d.items()} for d in v] for k, v in tree.items()}
    t = from_numpy_tree(jax.tree_util.tree_map(np.asarray, r), "cpu")
    return r, t


def _close_tree(got, want, bf16_ok=True):
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w, np.float32)
        rtol = BF16_ULP if (bf16_ok and g.dtype == torch.bfloat16) else 1e-6
        np.testing.assert_allclose(_np(g), w, rtol=rtol, atol=1e-7)


def test_clip_by_global_norm_matches_reference():
    r, t = _to_both(_opt_tree(1), {"k": jnp.bfloat16})
    for max_norm in (0.5, 1e6):
        rc, rn = RO.clip_by_global_norm(r, max_norm)
        tc, tn = TO.clip_by_global_norm(t, max_norm)
        assert float(tn) == pytest.approx(float(rn), rel=1e-6)
        assert float(TO.global_norm(t)) == pytest.approx(float(RO.global_norm(r)), rel=1e-6)
        _close_tree(tc, rc)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_optimizer_updates_match_reference(name, grad_clip):
    ro, to = _ocfgs(name=name, lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=grad_clip)
    rp, tp = _to_both(_opt_tree(2), {"k": jnp.bfloat16})
    rs, ts = RO.init_opt_state(ro, rp), TO.init_opt_state(to, tp)
    for step in range(4):
        rg, tg = _to_both(_opt_tree(10 + step), {"k": jnp.bfloat16})
        rp, rs, rm = RO.apply_updates(ro, rg, rs, rp, step)
        tp2, ts2, tm = TO.apply_updates(to, tg, ts, tp, step)
        assert tp2 is tp and ts2 is ts                           # in place
        assert float(tm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-6)
        _close_tree(tp, rp)
        _close_tree(ts, rs)
    assert [t.dtype for t in tree_leaves(tp)] == [torch.float32, torch.bfloat16,
                                                  torch.float32, torch.float32]


def test_adafactor_state_layout_matches_reference():
    ro, to = _ocfgs(name="adafactor")
    rp, tp = _to_both(_opt_tree(3), {})
    rs, ts = RO.init_opt_state(ro, rp), TO.init_opt_state(to, tp)
    rflat = jax.tree_util.tree_leaves_with_path(rs)
    tflat = tree_leaves(ts)
    assert [tuple(x.shape) for _, x in rflat] == [tuple(x.shape) for x in tflat]


# ---------------------------------------------------------------------------
# gradients and the train step
# ---------------------------------------------------------------------------

ARCHS = ["granite-3-2b", "mamba2-130m"]


@pytest.fixture(scope="module", params=ARCHS)
def arch_setup(request):
    return _setup(request.param)


def test_loss_fn_gradients_match_jax_grad(arch_setup):
    cfg, tcfg, params, tparams = arch_setup
    b = rpipe(cfg.vocab_size, 16, 4, seed=0).batch(0)
    b["targets"][0, -1] = -1                                     # IGNORE
    (loss, _), grads = jax.value_and_grad(
        lambda p: RM.loss_fn(cfg, p, _jbatch(b)), has_aux=True)(params)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tloss, tm, tgrads = loss_and_grads(tcfg, tparams, tb)
    assert float(tloss) == pytest.approx(float(loss), rel=1e-5)
    assert set(tm) == {"loss", "xent", "aux"}
    rflat = jax.tree_util.tree_leaves(grads)
    tflat = tree_leaves(tgrads)
    assert len(rflat) == len(tflat)
    for r, t, p in zip(rflat, tflat, tree_leaves(tparams)):
        r = np.asarray(r, np.float32)
        assert t.dtype == p.dtype and tuple(t.shape) == r.shape
        assert np.abs(_np(t) - r).max() <= 1e-4 * np.abs(r).max() + 1e-9


def test_train_step_matches_reference(arch_setup):
    cfg, tcfg, params, tparams = arch_setup
    ro, to = _ocfgs(lr=1e-3, warmup_steps=1, total_steps=10, schedule="const")
    b = rpipe(cfg.vocab_size, 16, 4, seed=1).batch(3)
    rp, _, rm = jax.jit(r_train_step(cfg, ro))(params, RO.init_opt_state(ro, params),
                                               _jbatch(b), jnp.asarray(1))
    tp = jax.tree_util.tree_map(lambda t: t.clone(), tparams)
    tp, _, tm = t_train_step(tcfg, to)(tp, TO.init_opt_state(to, tp), b, 1)
    assert set(tm) == set(rm) == {"loss", "xent", "aux", "grad_norm", "lr"}
    for k in ("loss", "xent", "grad_norm", "lr"):
        assert float(tm[k]) == pytest.approx(float(rm[k]), rel=1e-5)
    d = np.concatenate([np.abs(_np(t) - np.asarray(r)).ravel()
                        for t, r in zip(tree_leaves(tp), jax.tree_util.tree_leaves(rp))])
    assert d.max() <= 2 * to.lr and d.mean() <= 1e-6
    # the eval step, on the updated params
    rev = r_eval_step(cfg)(rp, _jbatch(b))
    tev = t_eval_step(tcfg)(tp, b)
    assert float(tev["loss"]) == pytest.approx(float(rev["loss"]), rel=1e-4)


def test_accumulation_matches_full_batch():
    _, tcfg, _, tparams = _setup("granite-3-2b")
    to = TO.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10, schedule="const")
    b = tpipe(tcfg.vocab_size, 16, 8, seed=0).batch(0)
    p1 = jax.tree_util.tree_map(lambda t: t.clone(), tparams)
    p2 = jax.tree_util.tree_map(lambda t: t.clone(), tparams)
    _, _, m1 = t_train_step(tcfg, to, accum=1)(p1, TO.init_opt_state(to, p1), b, 1)
    _, _, m2 = t_train_step(tcfg, to, accum=4)(p2, TO.init_opt_state(to, p2), b, 1)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    assert float(m2["xent"]) == float(m2["loss"]) and float(m2["aux"]) == 0.0
    d = np.concatenate([np.abs(_np(a) - _np(c)).ravel()
                        for a, c in zip(tree_leaves(p1), tree_leaves(p2))])
    assert d.max() <= 2 * to.lr and d.mean() <= 1e-6


def test_remat_equals_no_remat(arch_setup):
    """torch.utils.checkpoint recomputes the same float32 ops on the same
    inputs, so the gradients are equal bit for bit."""
    _, tcfg, _, tparams = arch_setup
    b = {k: torch.from_numpy(v) for k, v in tpipe(tcfg.vocab_size, 16, 2, seed=2).batch(0).items()}
    l0, _, g0 = loss_and_grads(tcfg, tparams, b)
    l1, _, g1 = loss_and_grads(tconfigs.with_overrides(tcfg, remat=True), tparams, b)
    assert torch.equal(l0, l1)
    for a, c in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, c)


# ---------------------------------------------------------------------------
# data, checkpoints, trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,hosts", [(0, 1), (3, 1), (5, 2)])
def test_synthetic_tokens_identical(seed, hosts):
    for host in range(hosts):
        r = rpipe(1000, 24, 8, seed=seed, host_id=host, num_hosts=hosts)
        t = tpipe(1000, 24, 8, seed=seed, host_id=host, num_hosts=hosts)
        for i in (0, 5, 17):
            rb, tb = r.batch(i), t.batch(i)
            for k in ("tokens", "targets"):
                assert tb[k].dtype == rb[k].dtype and np.array_equal(tb[k], rb[k])


def _ckpt_state():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    return w, {"w": torch.from_numpy(w).to(torch.bfloat16), "f": torch.from_numpy(w[0]),
               "blocks": [{"k": torch.arange(6, dtype=torch.float32).reshape(2, 3)}],
               "n": torch.tensor(3, dtype=torch.int32)}


def test_checkpoint_written_by_the_port_restores_in_the_reference():
    w, state = _ckpt_state()
    with tempfile.TemporaryDirectory() as d:
        ck = TCheckpointer(d, keep=2)
        for s in (1, 2, 3):
            ck.save(s, state)
        ck.wait()
        assert ck.steps() == [2, 3]
        tmpl = {"w": jax.ShapeDtypeStruct((3, 5), jnp.bfloat16),
                "f": jax.ShapeDtypeStruct((5,), jnp.float32),
                "blocks": [{"k": jax.ShapeDtypeStruct((2, 3), jnp.float32)}],
                "n": jax.ShapeDtypeStruct((), jnp.int32)}
        got, step = RCheckpointer(d).restore(tmpl)
    assert step == 3 and got["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["w"], np.float32), _np(state["w"]))
    np.testing.assert_array_equal(np.asarray(got["f"]), w[0])
    np.testing.assert_array_equal(np.asarray(got["blocks"][0]["k"]), _np(state["blocks"][0]["k"]))
    assert int(got["n"]) == 3


def test_checkpoint_written_by_the_reference_restores_in_the_port():
    w, state = _ckpt_state()
    rstate = jax.tree_util.tree_map(
        lambda t: jnp.asarray(_np(t)).astype(jnp.bfloat16 if t.dtype == torch.bfloat16 else
                                             jnp.int32 if t.dtype == torch.int32 else jnp.float32),
        state)
    with tempfile.TemporaryDirectory() as d:
        RCheckpointer(d).save(7, rstate, blocking=True)
        tmpl = jax.tree_util.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                                      state)
        got, step = TCheckpointer(d).restore(tmpl)
    assert step == 7
    for g, t in zip(tree_leaves(got), tree_leaves(state)):
        assert g.dtype == t.dtype and g.device.type == "cpu" and torch.equal(g, t)


def test_checkpoint_snapshot_ignores_later_in_place_updates():
    _, state = _ckpt_state()
    with tempfile.TemporaryDirectory() as d:
        ck = TCheckpointer(d)
        before = state["f"].clone()
        ck.save(1, state)
        state["f"].add_(1.0)                                     # the optimizer's in-place update
        ck.wait()
        got, _ = ck.restore(state)
    assert torch.equal(got["f"], before) and not torch.equal(got["f"], state["f"])


def _train_setup(seq=32):
    cfg = reduced(get_arch("granite-3-2b"))
    tcfg = tconfigs.reduced(tconfigs.get_arch("granite-3-2b"))
    ro, to = _ocfgs(lr=3e-3, warmup_steps=5, total_steps=40, schedule="wsd")
    return cfg, tcfg, ro, to, rpipe(cfg.vocab_size, seq, 8, seed=0), tpipe(cfg.vocab_size, seq, 8, seed=0)


def test_trainer_crash_resume_bit_faithful():
    _, tcfg, _, to, _, data = _train_setup()
    with tempfile.TemporaryDirectory() as d:
        t = TTrainer(tcfg, to, data, ckpt_dir=d, ckpt_every=10, device="cpu")
        with pytest.raises(InjectedFailure):
            t.run(30, fail_at=25)
        rep = TTrainer(tcfg, to, data, ckpt_dir=d, ckpt_every=10, device="cpu").run(30)
        assert rep.resumed_from == 20 and rep.steps == list(range(20, 30))
    with tempfile.TemporaryDirectory() as d:
        full = TTrainer(tcfg, to, data, ckpt_dir=d, ckpt_every=10, device="cpu").run(30)
    assert full.losses[-10:] == rep.losses                       # bit for bit


def test_trainer_loss_curve_matches_reference():
    """Both trainers start from the reference's step-0 state (saved with the
    reference Checkpointer, restored by the port's Trainer) and take 30
    steps on the same batches."""
    cfg, tcfg, ro, to, rdata, tdata = _train_setup()
    rt = RTrainer(cfg, ro, rdata)
    with tempfile.TemporaryDirectory() as d:
        RCheckpointer(d).save(0, rt.init_state(), blocking=True)
        trep = TTrainer(tcfg, to, tdata, ckpt_dir=d, device="cpu").run(30)
    rrep = rt.run(30)
    assert trep.resumed_from == 0 and trep.steps == rrep.steps == list(range(30))
    np.testing.assert_allclose(trep.losses, rrep.losses, atol=1e-4, rtol=0)
    assert trep.losses[-1] < trep.losses[0] - 0.5


def test_train_cli_on_the_cpu_and_the_device_rule():
    env = dict(os.environ, PYTHONPATH=SRC)
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "granite-3-2b",
            "--steps", "5", "--seq-len", "16", "--batch", "4"]
    out = subprocess.run(args + ["--device", "cpu"], capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-1500:]
    assert "granite-3-2b: loss" in out.stdout and "over 5 steps" in out.stdout
    if not torch.cuda.is_available():                           # no quiet CPU fallback
        out = subprocess.run(args, capture_output=True, text=True, timeout=600, env=env)
        assert out.returncode != 0 and "CUDA is not available" in out.stderr
