"""The port's training (``adaa_tpu_torch.training``, ``utils.checkpoints``
and the two training CLIs) against the JAX package's, on the CPU.

Tolerances, each measured on this CPU at the seeds below:
* the warm-restart schedule over 3 x T_0 counts: within 1e-7 x the base
  lr (measured 7.4e-8: JAX evaluates it in f32, the port in float64);
* Adam against the optax chain, with and without weight decay, and with
  the schedule, over 3 steps: parameters within 1e-6 x max(1, |p|);
* the layer-0 kernel's packed weights after an Adam step: those of the
  new weights, exactly (the optimizer is not the fused one, which would
  leave the weight's version, the cache's key, unchanged);
* the five strategies on the host (each one's draws over ten batches of
  fake attacks from one python-``random`` seed, EQUAL's half-batch
  scatter, the adaptive weight updates, ``multi_f1_score``): equal;
* one ``train_step`` of the f32 LCNN (B=2, 16,000 samples; its dropout
  keep-mask taken from flax's draw) and SpecRNet (B=4, 64,600 samples):
  loss within 1e-4 relative (measured 2.5e-6 and 1.7e-5); gradients
  within GRAD_REL_L2 over all parameters (1e-4 LCNN, 1e-3 SpecRNet;
  measured 2.6e-4 for SpecRNet) and per parameter within ``grad_rtol``
  of max(its largest gradient, 1e-2 x the largest of all) (1e-4 LCNN,
  1e-2 SpecRNet, measured 6e-3): train-mode BN over few values amplifies
  summation-order noise, and a gradient that cancels to ~0 (SpecRNet's
  conv1 biases before bn2 are exactly 0 in exact arithmetic) is held at
  the floor; weights after the Adam step within 2 x lr of JAX's, and
  within 1e-6 for >= 99.9% (LCNN) / 99% (SpecRNet, measured 99.8%): a
  first Adam step moves a weight by about lr x sign(g), so a gradient
  within noise of zero may step either way; running statistics as in
  tests/test_torch_port_bn.py;
* RawNet3's step (B=2, 1,741 samples) is ill-conditioned in f32 (the
  log of sinc outputs near zero): the port's own loss moves by ~1e-3
  and its filterbank gradients by ~0.5 relative L2 when the batch is
  scaled by (1 + 1e-7). So its gaps to JAX (loss, gradients, the share
  of equal weights, running statistics) are held within CHAOS_FACTOR = 4
  x the port's gap to itself under that scaling;
* ``GDTrainer`` and an ADAPTIVE self-attack ``AdversarialGDTrainer``
  (FGSM, FGSM_eps001; ``compute_eer``) on the f32 SpecRNet, one epoch
  from the same seeds:
  the same batches in the same order, the same python-``random`` draws,
  logged numbers within 1e-4 x max(1, |value|), the adaptive weights
  within 1e-4, and the best weights within 5 x lr + 1e-5 x max(1, |w|);
* a checkpoint saved by the port and loaded by the JAX package's
  ``load_model``: logits within 1e-5 of the port's.
"""
import logging
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adaa_tpu import models as jmodels
from adaa_tpu.training import adv_trainer as jadv
from adaa_tpu.training import gd_trainer as jgd
from adaa_tpu.training import train_state as jts
from adaa_tpu_torch import models as tmodels
from adaa_tpu_torch.models.weights import (lcnn_state_dict_from_flax,
                                           rawnet3_state_dict_from_flax,
                                           specrnet_state_dict_from_flax)
from adaa_tpu_torch.ops import layer0
from adaa_tpu_torch.training import adv_trainer as tadv
from adaa_tpu_torch.training import gd_trainer as tgd
from adaa_tpu_torch.training import train_state as tts
from adaa_tpu_torch.utils import checkpoints as tckpt
from tests.torch_port_common import (CFG_BF16, CFG_F32, cli_dir, lcnn_variables, port_lcnn,
                                     port_rawnet3, port_specrnet, rawnet3_variables,
                                     specrnet_variables, waves)

torch.set_num_threads(2)

LR = 1e-3


# ---------------------------------------------------------------------------
# schedule and optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base,t0", [(1e-3, 4), (1e-4, 6)])
def test_schedule_matches_jax(base, t0):
    want = jts.cosine_annealing_warm_restarts(base, t0)
    got = tts.cosine_annealing_warm_restarts(base, t0)
    for count in range(3 * t0):
        assert abs(got(count) - float(want(jnp.asarray(count)))) <= 1e-7 * base, count
    assert got(0) == base and got(t0) == base  # the warm restarts


@pytest.mark.parametrize("kwargs,sched", [({"lr": LR}, False),
                                          ({"lr": LR, "weight_decay": 5e-2}, False),
                                          ({"lr": LR, "weight_decay": 5e-5}, True)],
                         ids=["adam", "adam_wd", "adam_wd_schedule"])
def test_adam_matches_optax(kwargs, sched):
    rng = np.random.default_rng(5)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    tx = jts.make_optimizer(kwargs, sched, batches_per_epoch=2)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    opt_state = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    state = tts.TrainState(torch.nn.Module(),
                           *tts.make_optimizer(params.values(), kwargs, sched,
                                               batches_per_epoch=2))
    assert not state.optimizer.defaults["fused"]
    for g in grads:
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        if state.schedule is not None:
            state.optimizer.param_groups[0]["lr"] = state.schedule(state.step)
        state.optimizer.step()
        state.step += 1
        for k, p in params.items():
            want = np.asarray(jp[k])
            assert np.abs(p.detach().numpy() - want).max() <= 1e-6 * max(1.0, np.abs(want).max())


def test_layer0_cache_sees_the_optimizer_step():
    """The self-attack's layer-0 kernel reads its packed weights through
    ``layer0.packed_weights``, keyed on the weight's version: the trainer's
    Adam step must raise it, so the next attack packs the new weights."""
    model = tmodels.init_model(tmodels.get_model("lcnn", CFG_BF16),
                               torch.Generator().manual_seed(0), "cpu")
    w = model.m_transform["0"].weight
    optimizer, _ = tts.make_optimizer(model.parameters(), {"lr": 1e-2})
    before = [t.clone() for t in layer0.packed_weights(w.detach())]
    w.grad = torch.ones_like(w)
    optimizer.step()
    after = layer0.packed_weights(w.detach())
    fresh = layer0._operands(w.detach())
    for got, want, old in zip(after, fresh, before):
        assert torch.equal(got, want)
        assert not torch.equal(got, old)
    torch.testing.assert_close(after[2], w.detach().float(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# strategies
# ---------------------------------------------------------------------------

def test_multi_f1_score_matches_jax():
    for r in ([1.0, 0.5], [0.9, 0.8, 0.7], [0.25]):
        assert tadv.multi_f1_score(r) == jadv.multi_f1_score(r)


def test_registry_matches_jax():
    assert list(tadv.ADV_TRAINER_REGISTRY) == list(jadv.ADV_TRAINER_REGISTRY)
    for name, cls in tadv.ADV_TRAINER_REGISTRY.items():
        assert cls.__name__ == jadv.ADV_TRAINER_REGISTRY[name].__name__
        assert cls(epochs=1).needs_batch_loss == jadv.ADV_TRAINER_REGISTRY[name](
            epochs=1).needs_batch_loss


def test_equal_strategy_scatters_half_the_batch():
    x = np.random.default_rng(6).standard_normal((6, 10)).astype(np.float32)
    y = np.arange(6) % 2
    jt = jadv.EqualAdversarialGDTrainer(epochs=1)
    jt.attacks = [("A", lambda v, xx, yy, k: xx + 1.0)]
    tt = tadv.EqualAdversarialGDTrainer(epochs=1)
    tt.attacks = [("A", lambda xx, yy: xx + 1.0)]
    random.seed(3)
    want = np.asarray(jt.apply_adv_attack(None, jnp.asarray(x), jnp.asarray(y), None))
    random.seed(3)
    got = tt.apply_adv_attack(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != x).all(axis=1).sum() == 3 and (got == x).all(axis=1).sum() == 3


def test_only_adv_allows_one_attack():
    model = port_specrnet(CFG_F32, specrnet_variables(0))
    with pytest.raises(AssertionError, match="only one attack"):
        tadv.OnlyOneAdversarialGDTrainer(epochs=1).init_adv_attacks(model, ["FGSM", "PGD"])
    with pytest.raises(AssertionError, match="only one attack"):
        jadv.OnlyOneAdversarialGDTrainer(epochs=1).init_adv_attacks(None, ["FGSM", "PGD"])
    t = tadv.OnlyOneAdversarialGDTrainer(epochs=1)
    t.init_adv_attacks(model, ["NO_ATTACK"])
    x = torch.zeros(2, 16)
    assert t.apply_adv_attack(x, torch.zeros(2)) is x  # NO_ATTACK leaves the batch clean


@pytest.mark.parametrize("strategy", list(jadv.ADV_TRAINER_REGISTRY))
def test_strategy_draws_match_jax(strategy):
    """Ten batches through each strategy's ``apply_adv_attack`` (and the
    adaptive ones' weight updates) from one python-``random`` seed: the same
    attacks on the same rows. Each fake attack adds its own constant."""
    names = ["A"] if strategy == "ONLY_ADV" else ["A", "B", "NO_ATTACK"]
    jt = jadv.ADV_TRAINER_REGISTRY[strategy](epochs=1)
    tt = tadv.ADV_TRAINER_REGISTRY[strategy](epochs=1)
    for t, jax_side in ((jt, True), (tt, False)):
        t.attacks = [(n, None if n == "NO_ATTACK" else (
            (lambda v, x, y, k, c=i + 1.0: x + c) if jax_side else (lambda x, y, c=i + 1.0: x + c)))
                     for i, n in enumerate(names)]
        if hasattr(t, "adv_attacks_weights"):
            t.adv_attacks_weights = [1.0 / (len(names) + 1)] * (len(names) + 1)
    x = np.zeros((4, 3), np.float32)
    y = np.arange(4) % 2
    outs = {}
    for side, t in (("jax", jt), ("port", tt)):
        random.seed(21)
        got = []
        for i in range(10):
            if side == "jax":
                got.append(np.asarray(t.apply_adv_attack(None, jnp.asarray(x), jnp.asarray(y),
                                                         None)))
            else:
                got.append(t.apply_adv_attack(torch.from_numpy(x), torch.from_numpy(y)).numpy())
            if t.needs_batch_loss:
                t.update_adv_attack(0.1 * i, iter=i, epoch=0)
        outs[side] = np.stack(got)
    np.testing.assert_array_equal(outs["port"], outs["jax"])
    if strategy == "ONLY_ADV":
        assert (outs["jax"] == 1.0).all()  # every batch attacked
    else:
        assert len(np.unique(outs["jax"])) > 1  # some rows attacked, some not


@pytest.mark.parametrize("strategy", ["ADAPTIVE", "ADAPTIVE_V2"])
def test_adaptive_weight_updates_match_jax(strategy):
    jt = jadv.ADV_TRAINER_REGISTRY[strategy](epochs=1)
    tt = tadv.ADV_TRAINER_REGISTRY[strategy](epochs=1)
    for t in (jt, tt):
        t.attacks = [("A", None), ("B", None)]
        t.adv_attacks_weights = [1 / 3] * 3
    for loss, idx in ((0.5, 0), (2.0, 2), (0.1, 1), (0.7, 0)):
        jt.update_adv_attack(loss, attack_idx=idx)
        tt.update_adv_attack(loss, attack_idx=idx)
        assert tt.adv_attacks_weights == jt.adv_attacks_weights


# ---------------------------------------------------------------------------
# one train step against JAX's
# ---------------------------------------------------------------------------

RAWNET3_L = 1741  # T = 150 after the encoder
STEP_MODELS = {
    # name: (variables, port model, bridge, (batch, wave length), config,
    #        gradient tolerance, running-stat tolerance as in tests/test_torch_port_bn.py)
    "lcnn": (lcnn_variables, port_lcnn, lcnn_state_dict_from_flax, (2, 16_000), CFG_F32,
             1e-4, 1e-6),
    # at 64,600 samples bn_before_gru normalises over B x 6 values; with
    # fewer its output barely depends on its input and every gradient
    # upstream of it is rounding noise
    "specrnet": (specrnet_variables, port_specrnet, specrnet_state_dict_from_flax, (4, 64_600),
                 CFG_F32, 1e-2, 1e-6),
    "rawnet3": (rawnet3_variables, port_rawnet3, rawnet3_state_dict_from_flax, (2, RAWNET3_L),
                {}, None, 5e-5),
}
STEP_EQUAL_SHARE = {"lcnn": 0.999, "specrnet": 0.99}  # weights within 1e-6 after the step
GRAD_REL_L2 = {"lcnn": 1e-4, "specrnet": 1e-3}
CHAOS_FACTOR = 4.0


def _recording_bernoulli(monkeypatch):
    """Record the keep-masks flax's Dropout draws, as the program runs."""
    masks = []
    bernoulli = jax.random.bernoulli

    def recorded(key, p=0.5, shape=None, **kw):
        mask = bernoulli(key, p, shape, **kw)
        jax.debug.callback(lambda m: masks.append(np.asarray(m)), mask)
        return mask

    monkeypatch.setattr(jax.random, "bernoulli", recorded)
    return masks


def _applying_dropout(monkeypatch, masks):
    """The port's F.dropout replaced by flax's recorded keep-masks, in order."""
    import torch.nn.functional as F

    queue = list(masks)

    def dropout(h, p=0.5, training=True, inplace=False):
        if not training:
            return h
        keep = torch.from_numpy(queue.pop(0))
        return torch.where(keep, h / (1.0 - p), torch.zeros((), dtype=h.dtype))

    monkeypatch.setattr(F, "dropout", dropout)


def _port_step(port, cfg, variables, x, y, opt):
    """One port train step: (loss, accumulator, gradients, state_dict after)."""
    model = port(cfg, variables)
    state = tts.create_train_state(model, opt)
    acc = torch.zeros(2)
    loss = tgd.train_step(state, torch.from_numpy(x), torch.from_numpy(y), acc)
    assert model.training and state.step == 1
    grads = {k: p.grad.numpy() for k, p in model.named_parameters() if p.grad is not None}
    return float(loss), acc.numpy(), grads, {k: v.numpy() for k, v in model.state_dict().items()}


def _grad_gaps(got, want):
    """(relative L2 over all gradients, each parameter's max gap over
    max(its largest gradient, 1e-2 x the largest of all))."""
    keys = list(want)
    flat = [np.concatenate([d[k].ravel() for k in keys]) for d in (got, want)]
    floor = 1e-2 * np.abs(flat[1]).max()  # a gradient ~0 by cancellation is held at the floor
    per = {k: np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), floor) for k in keys}
    return np.linalg.norm(flat[0] - flat[1]) / np.linalg.norm(flat[1]), per


def _weights_equal_share(got, want, named):
    """The share of weights within 1e-6 x max(1, |w|) of ``want``'s."""
    return np.concatenate([(np.abs(got[k] - want[k]) <= 1e-6 * np.maximum(1.0, np.abs(want[k])))
                           .ravel() for k in named]).mean()


@pytest.mark.parametrize("name", list(STEP_MODELS))
def test_train_step_matches_jax(name, monkeypatch):
    make_vars, port, bridge, (batch, length), cfg, grad_rtol, stats_tol = STEP_MODELS[name]
    variables = make_vars(0)
    x, y = waves(50, batch, length), (np.arange(batch) % 2).astype(np.int32)
    opt = {"lr": LR, "weight_decay": 1e-4}
    module = jmodels.get_model(name, cfg)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    masks = _recording_bernoulli(monkeypatch)

    def loss_fn(params):  # jgd.train_step's, on the same dropout key
        out, _ = module.apply({"params": params, "batch_stats": jvars["batch_stats"]},
                              jnp.asarray(x), train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(7)})
        return jgd.bce_with_logits(out, jnp.asarray(y))

    jgrads = jax.jit(jax.grad(loss_fn))(jvars["params"])
    state = jts.create_train_state(module, jvars, opt)
    state, jloss, jacc = jgd.train_step(state, jnp.asarray(x), jnp.asarray(y),
                                        jax.random.PRNGKey(7), jnp.zeros(2))
    jax.effects_barrier()
    assert len(masks) == (2 if name == "lcnn" else 0)  # one draw per program
    if masks:
        np.testing.assert_array_equal(masks[0], masks[1])
    _applying_dropout(monkeypatch, masks[1:])
    loss, acc, grads, after = _port_step(port, cfg, variables, x, y, opt)

    want_grads = {k: v.numpy() for k, v in bridge(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads),
         "batch_stats": variables["batch_stats"]}).items() if k in grads}
    named = set(grads)
    assert named == {k for k, _ in port(cfg, variables).named_parameters()
                     if not k.startswith("bn6.")}  # bn6: unused, frozen
    want = {k: v.numpy() for k, v in bridge(
        jax.tree_util.tree_map(np.asarray, state.variables())).items()}
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))
             and not k.startswith("bn6.")]
    loss_gap = abs(loss - float(jloss)) / abs(float(jloss))
    rel_l2, per = _grad_gaps(grads, want_grads)
    share = _weights_equal_share(after, want, named)
    if name == "rawnet3":
        # RawNet3's step is ill-conditioned in f32: the encoder's log of sinc
        # outputs near zero multiplies their summation-order noise, and its
        # sign flips pick the sign of log's gradient there. So the port is
        # held to JAX as closely as it agrees with itself on the same batch
        # scaled by (1 + 1e-7) (measured: the loss moves ~1e-3 relative and
        # the filterbank's gradients by ~0.5 relative L2 under that scaling)
        ploss, _, pgrads, pafter = _port_step(port, cfg, variables,
                                              (x * np.float32(1 + 1e-7)).astype(np.float32),
                                              y, opt)
        p_rel_l2, _ = _grad_gaps(pgrads, grads)
        assert loss_gap <= CHAOS_FACTOR * abs(ploss - loss) / abs(loss) + 1e-6, loss_gap
        assert rel_l2 <= CHAOS_FACTOR * p_rel_l2, (rel_l2, p_rel_l2)
        p_share = _weights_equal_share(pafter, after, named)
        assert 1 - share <= CHAOS_FACTOR * (1 - p_share), (share, p_share)
    else:
        assert loss_gap <= 1e-4, loss_gap
        np.testing.assert_allclose(acc, np.asarray(jacc), rtol=1e-4)
        assert rel_l2 <= GRAD_REL_L2[name], rel_l2
        worst = max(per, key=per.get)
        assert per[worst] <= grad_rtol, (worst, per[worst])
        assert share >= STEP_EQUAL_SHARE[name], share
    for k in named:  # a first Adam step moves a weight by about lr
        scale = max(1.0, np.abs(want[k]).max())
        assert np.abs(after[k] - want[k]).max() <= 2 * LR + 1e-6 * scale, k
    for k in stats:
        tol = stats_tol * max(1.0, np.abs(want[k]).max())
        if name == "rawnet3":
            tol = max(tol, CHAOS_FACTOR * np.abs(pafter[k] - after[k]).max())
        assert np.abs(after[k] - want[k]).max() <= tol, k


# ---------------------------------------------------------------------------
# the trainers, one epoch against JAX's
# ---------------------------------------------------------------------------

_NUMBER = re.compile(r"([\w/]+): (-?(?:\d+\.?\d*(?:e[-+]?\d+)?|nan))")


def _logged(records, package: str) -> dict:
    """The numbers of the trainer's log lines, ``name -> [values]`` in order."""
    out = {}
    for r in records:
        if not r.name.startswith(package + ".training"):
            continue
        msg = r.getMessage()
        for key, value in _NUMBER.findall(msg):
            if key.startswith(("train/", "test/", "adv_test/")) or key == "multi_f1_score":
                out.setdefault(key, []).append(float(value))
    return out


def _recording_train_step(monkeypatch, module, steps):
    """Record each train step's labels and a checksum of its waves."""
    step = module.train_step

    def recorded(state, batch_x, batch_y, *rest):
        steps.append((np.asarray(batch_y).tolist(), float(np.asarray(batch_x).sum())))
        return step(state, batch_x, batch_y, *rest)

    monkeypatch.setattr(module, "train_step", recorded)


def _recording_choices(monkeypatch, cls, out):
    """Record each training batch's clean checksum and the arm the strategy drew."""
    apply = cls.apply_adv_attack

    def recorded(self, *args):
        batch_x = args[-3] if len(args) == 4 else args[0]  # JAX: (variables, x, y, key)
        checksum = float(np.asarray(batch_x).sum())
        adv = apply(self, *args)
        out.append((checksum, self.last_adv_attack))
        return adv

    monkeypatch.setattr(cls, "apply_adv_attack", recorded)


def _jax_synthetic(n, subset):
    from adaa_tpu.data.synthetic import SyntheticDataset

    return SyntheticDataset(n=n, subset=subset)


def _port_synthetic(n, subset):
    from adaa_tpu_torch.data.synthetic import SyntheticDataset

    return SyntheticDataset(n=n, subset=subset)


TRAINER_LR = 1e-4
ATTACKS = ["FGSM", "FGSM_eps001"]


@pytest.fixture(scope="module")
def trainer_runs():
    """One epoch of GDTrainer and of an ADAPTIVE self-attack trainer (with
    ``compute_eer``) on the f32 SpecRNet (8 training and 8 test waves of
    64,600 samples, batch 4), JAX and port, from the same seeds; their
    logs, steps and results."""
    variables = specrnet_variables(3)
    opt = {"lr": TRAINER_LR, "weight_decay": 1e-4}
    runs = {}
    choices = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp, _capture() as records:
        for side in ("jax", "port"):
            steps = {"clean": [], "adaptive": []}
            jax_side = side == "jax"
            data = _jax_synthetic if jax_side else _port_synthetic
            for kind in ("clean", "adaptive"):
                mods = ((jgd,) if kind == "clean" else (jadv,)) if jax_side else (
                    (tgd,) if kind == "clean" else (tadv,))
                for mod in mods:
                    _recording_train_step(mp, mod, steps[kind])
                if kind == "adaptive":
                    _recording_choices(mp, jadv.AdaptiveAdversarialGDTrainer if jax_side
                                       else tadv.AdaptiveAdversarialGDTrainer, choices[side])
                np.random.seed(11)
                random.seed(11)
                records.clear()
                if jax_side:
                    module = jmodels.get_model("specrnet", CFG_F32)
                    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
                    if kind == "clean":
                        trainer = jgd.GDTrainer(epochs=1, batch_size=4, optimizer_kwargs=opt)
                        best = trainer.train(data(8, "train"), module, jvars,
                                             test_dataset=data(8, "test"),
                                             key=jax.random.PRNGKey(0))
                    else:
                        trainer = jadv.AdaptiveAdversarialGDTrainer(
                            epochs=1, batch_size=4, optimizer_kwargs=opt, compute_eer=True)
                        best = trainer.train(data(8, "train"), module, jvars, module, None,
                                             ATTACKS, test_dataset=data(8, "test"),
                                             key=jax.random.PRNGKey(0))
                    best = {k: v.numpy() for k, v in specrnet_state_dict_from_flax(
                        jax.tree_util.tree_map(np.asarray, best)).items()}
                else:
                    model = port_specrnet(CFG_F32, variables)
                    if kind == "clean":
                        trainer = tgd.GDTrainer(epochs=1, batch_size=4, optimizer_kwargs=opt)
                        trainer.train(data(8, "train"), model, test_dataset=data(8, "test"))
                    else:
                        trainer = tadv.AdaptiveAdversarialGDTrainer(
                            epochs=1, batch_size=4, optimizer_kwargs=opt, compute_eer=True)
                        trainer.train(data(8, "train"), model, None, ATTACKS,
                                      test_dataset=data(8, "test"))
                    best = {k: v.numpy() for k, v in model.state_dict().items()}
                runs[side, kind] = {"log": _logged(records, "adaa_tpu" if jax_side
                                                   else "adaa_tpu_torch"),
                                    "steps": steps[kind], "best": best,
                                    "weights": getattr(trainer, "adv_attacks_weights", None),
                                    "choices": choices[side] if kind == "adaptive" else None,
                                    "python_random": random.random()}
    return runs


class _capture:
    """Collect the log records of the trainers (INFO and up)."""

    def __enter__(self):
        self.records = []
        self.handler = logging.Handler(logging.INFO)
        self.handler.emit = self.records.append
        self.loggers = [logging.getLogger(n) for n in ("adaa_tpu.training",
                                                        "adaa_tpu_torch.training")]
        self.levels = [lg.level for lg in self.loggers]
        for lg in self.loggers:
            lg.addHandler(self.handler)
            lg.setLevel(logging.INFO)
        return self.records

    def __exit__(self, *exc):
        for lg, level in zip(self.loggers, self.levels):
            lg.removeHandler(self.handler)
            lg.setLevel(level)


@pytest.mark.parametrize("kind", ["clean", "adaptive"])
def test_trainer_epoch_matches_jax(trainer_runs, kind):
    jax_run, port_run = trainer_runs["jax", kind], trainer_runs["port", kind]
    # the same batches in the same order, and the same python-random draws after
    assert [s[0] for s in port_run["steps"]] == [s[0] for s in jax_run["steps"]]
    if kind == "clean":
        np.testing.assert_allclose([s[1] for s in port_run["steps"]],
                                   [s[1] for s in jax_run["steps"]], rtol=1e-5)
    else:  # the clean batches the strategy saw, and the arms it drew
        np.testing.assert_allclose([c[0] for c in port_run["choices"]],
                                   [c[0] for c in jax_run["choices"]], rtol=1e-5)
        assert [c[1] for c in port_run["choices"]] == [c[1] for c in jax_run["choices"]]
        assert len(jax_run["choices"]) == 2
        assert any(c[1] < len(ATTACKS) for c in jax_run["choices"])  # a batch was attacked
    assert port_run["python_random"] == jax_run["python_random"]
    want, got = jax_run["log"], port_run["log"]
    assert set(got) == set(want)
    keys = {"clean": {"train/loss", "train/accuracy", "test/loss", "test/accuracy", "test/eer"},
            "adaptive": {"train/loss", "train/accuracy", "test/loss", "test/accuracy",
                         "test/eer", "multi_f1_score"}
            | {f"adv_test/{a}__{m}" for a in ATTACKS for m in ("loss", "accuracy", "eer")}}[kind]
    assert set(want) == keys
    for key in want:
        tol = 1e-4 * max(1.0, np.abs(want[key]).max())
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=tol, err_msg=key)
    if kind == "adaptive":
        np.testing.assert_allclose(port_run["weights"], jax_run["weights"], rtol=0, atol=1e-4)
    for k, w in jax_run["best"].items():
        if k.endswith("num_batches_tracked"):
            continue
        scale = max(1.0, np.abs(w).max())
        assert np.abs(port_run["best"][k] - w).max() <= 5 * TRAINER_LR + 1e-5 * scale, k


# ---------------------------------------------------------------------------
# checkpoints and the CLIs
# ---------------------------------------------------------------------------

def test_checkpoint_loads_in_both_packages(tmp_path):
    """A port checkpoint: the reference's layout and keys, read back by the
    port's and by the JAX package's ``load_model``."""
    model = port_lcnn(CFG_F32, lcnn_variables(4))
    path = tckpt.save_checkpoint(model, tmp_path, "aad__lcnn__0", epoch=3)
    assert path == tmp_path / "aad__lcnn__0" / "ckpt_03.pth"
    assert tckpt.save_checkpoint(model, tmp_path, "aad__lcnn__0").name == "ckpt.pth"
    sd = tckpt.load_checkpoint(path)
    assert list(sd) == list(model.state_dict())
    assert all(v.device.type == "cpu" for v in sd.values())
    config = {"data": {"seed": 1}, "model": {"name": "lcnn", "parameters": CFG_F32},
              "checkpoint": {"path": str(path)}}
    back = tmodels.load_model(config, torch.Generator().manual_seed(9), "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    module, jvars = jmodels.load_model(config)
    x = waves(60, 2, 16_000)
    zj = np.asarray(module.apply(jvars, jnp.asarray(x), train=False))
    with torch.no_grad():
        zt = model(torch.from_numpy(x)).numpy()
    assert np.abs(zt - zj).max() <= 1e-5


def test_training_clis_run_on_cpu(cli_dir, caplog):
    import yaml

    from adaa_tpu_torch.scripts import train_models
    from adaa_tpu_torch.scripts import train_models_on_adversarial_attacks as adv_cli

    repo = __import__("pathlib").Path(__file__).resolve().parents[1]
    common = ["--asv_path", "synthetic:16:16000", "-b", "4", "-e", "1", "-ta", "8", "--cpu"]
    caplog.set_level(logging.INFO)
    ckpt, cfg_path = train_models.main(train_models.parse_args(
        ["--config", str(repo / "configs/training/lcnn.yaml"), *common]))
    assert ckpt.exists() and not cfg_path.is_absolute() and cfg_path.exists()
    assert cfg_path.parent.name == "configs" and cfg_path.name.startswith("aad__lcnn__")
    config = yaml.safe_load(cfg_path.read_text())
    assert config["checkpoint"] == {"path": str(ckpt)}
    text = caplog.text
    assert "train/loss" in text and "test/accuracy" in text and "test/eer" in text

    for strategy, attacks in (("ADAPTIVE", ["FGSM", "PGDL2"]), ("ONLY_ADV", ["FGSM"])):
        config["data"]["adversarial_attacks"] = attacks
        adv_cfg = cli_dir / f"adv_{strategy}.yaml"
        adv_cfg.write_text(yaml.dump(config))
        caplog.clear()
        eer = ["--compute_eer"] if strategy == "ADAPTIVE" else []
        best, out_cfg = adv_cli.main(adv_cli.parse_args(
            ["--config", str(adv_cfg), "--finetune", "--adv_training_strategy", strategy,
             *eer, *common]))
        text = caplog.text
        for needle in ["train/loss", "test/accuracy", "multi_f1_score",
                       *[f"adv_test/{a}__accuracy" for a in attacks]]:
            assert needle in text, (strategy, needle)
        assert ("test/eer: 0\n" in text) == (not eer)  # the placeholder unless --compute_eer
        assert (best.parent / "ckpt_00.pth").exists() and best.name == "ckpt.pth"
        written = yaml.safe_load(out_cfg.read_text())
        assert written["checkpoint"] == {"paths": [str(best)]}
        model = tmodels.load_model(written, torch.Generator().manual_seed(0), "cpu")
        for k, v in torch.load(best, weights_only=True).items():
            assert torch.equal(model.state_dict()[k], v), k
