"""The port's unwired detectors (``adaa_tpu_torch/models/extra.py``)
against ``adaa_tpu.models.extra`` on shared weights (CPU, f32).

Narrow settings where the model has them: RawNet2 with ``gru_node`` 64
and two GRU layers on 8,000-sample waves (the baseline's filters and
sinc bank otherwise); Meso4 and MesoInception4 on the reference
``__main__``'s (B, 4, 80, 404) maps with ``fc1_dim`` 16 x 2 x 12
(``tests/test_extra_models.py``); Xception on (4, 4, 32, 32). Weights,
biases, BN affines and statistics are random from a numpy seed, handed
to the port through ``weights.extra_state_dict_from_flax``.

Each model, in eval and in train mode (batch statistics; the dropout
keep-masks flax draws replayed into the port's ``F.dropout``): the
logits, the input gradient of a random projection of them and, in
train, every running statistic after the forward, within 1e-4
relative (the logits and statistics against their largest magnitude,
the gradient in L2). Both sides compute in f32 and differ in summation
order only. Two settings are set apart, from this CPU's measurements:
* RawNet2's input gradient is held to 1e-3: it is ~1e-9 against logits
  of ~1e-2 (the SELU and GRU tail saturate), a sum of cancelling terms
  through the 1,025-tap sinc conv; measured 6.3e-4 relative L2 in eval,
  with the logits within 4.5e-6;
* Xception runs at batch 4, not 2: its last blocks are 1 x 1, so at
  batch 2 each train-mode BN there normalises two values per channel and
  its gradient is the difference of two nearly equal terms (measured
  1.5e-3 on the logits and 6.8e-3 on the input gradient); at batch 4 the
  train-mode gaps are 6.9e-6, 5.5e-5 and 2.9e-6 (statistics).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adaa_tpu.models import extra as jextra
from adaa_tpu_torch.models import extra as textra
from adaa_tpu_torch.models import init_model
from adaa_tpu_torch.models.weights import extra_state_dict_from_flax

torch.set_num_threads(2)

CASES = {  # name -> (config, input shape)
    "rawnet2": ({"gru_node": 64, "nb_gru_layer": 2}, (2, 8000)),
    "meso4": ({"input_channels": 4, "fc1_dim": 16 * 2 * 12}, (2, 4, 80, 404)),
    "meso_inception4": ({"input_channels": 4, "fc1_dim": 16 * 2 * 12}, (2, 4, 80, 404)),
    "xception": ({"input_channels": 4}, (4, 4, 32, 32)),
}
REL = 1e-4
GRAD_REL = {"rawnet2": 1e-3}


def _variables(module, x, seed):
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)}, x))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            return rng.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1]))
        if name.startswith("weight_"):
            return rng.uniform(-1, 1, shape) / np.sqrt(shape[-1] / 3)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape)
        return rng.standard_normal(shape) * 0.1  # biases, means

    tree = jax.tree_util.tree_map_with_path(leaf, dict(shapes))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def _replaying_dropout(monkeypatch, masks):
    queue = list(masks)

    def dropout(h, p=0.5, training=True, inplace=False):
        if not training:
            return h
        keep = torch.from_numpy(queue.pop(0))
        return torch.where(keep, h / (1.0 - p), torch.zeros((), dtype=h.dtype))

    monkeypatch.setattr(F, "dropout", dropout)
    return queue


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(CASES))
def test_extra_model_matches_jax(name, train, monkeypatch):
    cfg, shape = CASES[name]
    rng = np.random.default_rng(list(CASES).index(name))
    x = (rng.standard_normal(shape) * (0.1 if name == "rawnet2" else 1.0)).astype(np.float32)
    module = jextra.get_extra_model(name, cfg)
    variables = _variables(module, jnp.asarray(x), seed=1)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)

    masks = []
    if train:
        bernoulli = jax.random.bernoulli

        def recorded(key, p=0.5, shape=None, **kw):
            mask = bernoulli(key, p, shape, **kw)
            masks.append(np.asarray(mask))
            return mask

        monkeypatch.setattr(jax.random, "bernoulli", recorded)
        _, new_vars = module.apply(jvars, jnp.asarray(x), train=True, mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(3)})
        monkeypatch.setattr(jax.random, "bernoulli", bernoulli)

    def jfn(a):
        if not train:
            return module.apply(jvars, a, train=False)
        return module.apply(jvars, a, train=True, mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(3)})[0]

    zj, vjp = jax.vjp(jfn, jnp.asarray(x))
    proj = rng.standard_normal(zj.shape).astype(np.float32)
    (gj,) = vjp(jnp.asarray(proj))

    model = textra.get_extra_model(name, cfg)
    model.load_state_dict(extra_state_dict_from_flax(name, variables), strict=True)
    model.train(train)
    queue = _replaying_dropout(monkeypatch, masks)
    xt = torch.from_numpy(x).requires_grad_(True)
    zt = model(xt)
    (gt,) = torch.autograd.grad(zt, xt, torch.from_numpy(proj))
    assert not queue  # every flax mask was used, in order
    assert zt.shape == zj.shape
    assert _rel(zt.detach().numpy(), zj) <= REL
    gj = np.asarray(gj)
    assert np.linalg.norm(gt.numpy() - gj) / np.linalg.norm(gj) <= GRAD_REL.get(name, REL)
    if train:
        want = extra_state_dict_from_flax(name, {"params": variables["params"],
                                                 "batch_stats": new_vars["batch_stats"]})
        stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
        assert stats
        for k in stats:
            assert _rel(model.state_dict()[k].numpy(), want[k].numpy()) <= REL, k


def test_factory_and_initialisers():
    for name, (cfg, shape) in CASES.items():
        model = init_model(textra.get_extra_model(name, cfg), torch.Generator().manual_seed(0),
                           "cpu").eval()
        with torch.no_grad():
            z = model(torch.randn(shape, generator=torch.Generator().manual_seed(1)) * 0.1)
        assert z.shape == (shape[0], 1) and bool(torch.isfinite(z).all()), name
    assert isinstance(textra.get_extra_model("mesonet", {}), textra.Meso4)
    with pytest.raises(ValueError):
        textra.get_extra_model("resnet", {})
