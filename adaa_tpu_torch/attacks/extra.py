"""The rest of the vendored torchattacks fork, audio-adapted (port of
``adaa_tpu/attacks/extra.py``).

VANILA, GN, BIM, RFGSM, FFGSM, TPGD, EOTPGD, MIFGSM, NIFGSM, SINIFGSM,
VMIFGSM, VNIFGSM, DIFGSM, UPGD, Jitter, DeepFool, TIFGSM, SparseFool and
Pixle, with the JAX package's defaults. Losses go through the widened
(-z, z) logits, per-class reductions take their 2-class closed forms, and
image reductions become per-sample reductions over the wave.

The attacks that draw random numbers are ``core.DrawnAttack``s: ``draw``
takes from the caller's generator what the JAX function takes from its
key (a start; each step's neighbours, resize or noise, drawn when the
step runs), and ``run`` is deterministic in those draws.

DIFGSM's and TIFGSM's input diversity resizes the wave with
``resize_linear``: the 1-D ``jax.image.scale_and_translate(method=
"linear")`` as a banded gather of a few taps per output, where JAX builds
a dense (L, L) weight matrix.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from adaa_tpu_torch.attacks import core
from adaa_tpu_torch.attacks.gradient import _make_cost_grad


def _bshape(x):
    return (x.shape[0],) + (1,) * (x.dim() - 1)


def _mean_abs(g):
    return g.reshape(g.shape[0], -1).abs().mean(dim=1).reshape(_bshape(g))


def _uniform(x, generator, lo, hi):
    return torch.empty_like(x).uniform_(lo, hi, generator=generator)


def _normal(x, generator):
    return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)


def _linf_step(x, adv, g, alpha, eps):
    adv = adv + alpha * g.sign()
    return (x + (adv - x).clamp(-eps, eps)).clamp(0.0, 1.0)


def _grad_of(cost_fn, adv):
    """d cost_fn(adv) / d adv."""
    adv = adv.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(cost_fn(adv), adv)
    return g


def vanila(logits_fn, **kw) -> core.AttackFn:
    """Identity 'attack' (vanila.py)."""
    return lambda x, y, generator=None: x


def gn(logits_fn, std: float = 0.1) -> core.DrawnAttack:
    """Gaussian noise (gn.py:24-37)."""
    return core.DrawnAttack(_normal, lambda x, y, noise: (x + std * noise).clamp(0.0, 1.0))


def bim(logits_fn, eps: float = 4 / 255, alpha: float = 1 / 255,
        steps: int = 0) -> core.AttackFn:
    """Basic iterative method with BIM's asymmetric clamp (bim.py:41-78)."""
    if steps == 0:
        steps = int(min(eps * 255 + 4, 1.25 * eps * 255))
    grad_fn = _make_cost_grad(logits_fn, False)

    def attack(x, y, generator=None):
        x = x.detach()
        adv = x
        a = torch.clamp(x - eps, min=0.0)
        for _ in range(steps):
            adv2 = adv + alpha * grad_fn(adv, y).sign()
            b = torch.where(adv2 >= a, adv2, a)
            c = torch.where(b > x + eps, x + eps, b)
            adv = torch.clamp(c, max=1.0)
        return adv

    return attack


def rfgsm(logits_fn, eps: float = 8 / 255, alpha: float = 2 / 255,
          steps: int = 1) -> core.DrawnAttack:
    """R+FGSM (rfgsm.py:38-70): sign-of-noise start, then PGD steps."""
    grad_fn = _make_cost_grad(logits_fn, False)

    def run(x, y, noise):
        x = x.detach()
        adv = (x + alpha * noise.sign()).clamp(0.0, 1.0)
        for _ in range(steps):
            adv = _linf_step(x, adv, grad_fn(adv, y), alpha, eps)
        return adv

    return core.DrawnAttack(_normal, run)


def ffgsm(logits_fn, eps: float = 8 / 255, alpha: float = 10 / 255) -> core.DrawnAttack:
    """Fast-FGSM (ffgsm.py:40-66): uniform start and one step."""
    grad_fn = _make_cost_grad(logits_fn, False)

    def run(x, y, noise):
        x = x.detach()
        adv = (x + noise).clamp(0.0, 1.0)
        return _linf_step(x, adv, grad_fn(adv, y), alpha, eps)

    return core.DrawnAttack(lambda x, gen: _uniform(x, gen, -eps, eps), run)


def tpgd(logits_fn, eps: float = 8 / 255, alpha: float = 2 / 255,
         steps: int = 7) -> core.DrawnAttack:
    """TRADES PGD (tpgd.py:38-65): KL(adv || clean) over the widened 2-class
    softmax, sum reduction, from a 0.001-gaussian start."""

    def run(x, y, noise):
        x = x.detach()
        with torch.no_grad():
            p_ori = torch.softmax(core.two_class_logits(logits_fn(x)), dim=1)
        log_p_ori = torch.log(torch.clamp(p_ori, min=1e-30))

        def kl_cost(adv):
            logp_adv = torch.log_softmax(core.two_class_logits(logits_fn(adv)), dim=1)
            return (p_ori * (log_p_ori - logp_adv)).sum()

        adv = (x + 0.001 * noise).clamp(0.0, 1.0)
        for _ in range(steps):
            adv = _linf_step(x, adv, _grad_of(kl_cost, adv), alpha, eps)
        return adv

    return core.DrawnAttack(_normal, run)


def eotpgd(logits_fn, eps: float = 8 / 255, alpha: float = 2 / 255,
           steps: int = 10, eot_iter: int = 2,
           random_start: bool = True) -> core.DrawnAttack:
    """EOT-PGD (eotpgd.py:45-84): ``eot_iter`` gradients summed per step
    (the detector is deterministic in attack mode, so they are equal)."""
    grad_fn = _make_cost_grad(logits_fn, False)

    def draw(x, generator):
        return _uniform(x, generator, -eps, eps) if random_start else None

    def run(x, y, noise):
        x = x.detach()
        adv = x if noise is None else (x + noise).clamp(0.0, 1.0)
        for _ in range(steps):
            g = sum(grad_fn(adv, y) for _ in range(eot_iter))
            adv = _linf_step(x, adv, g, alpha, eps)
        return adv

    return core.DrawnAttack(draw, run)


def _momentum_family(logits_fn, eps, alpha, steps, decay, nesterov=False, scales: int = 0):
    """MIFGSM / NIFGSM / SINIFGSM (mifgsm.py:42-80, nifgsm.py:40-73,
    sinifgsm.py:44-90)."""
    grad_fn = _make_cost_grad(logits_fn, False)

    def attack(x, y, generator=None):
        x = x.detach()
        adv, momentum = x, torch.zeros_like(x)
        for _ in range(steps):
            point = adv + decay * alpha * momentum if nesterov else adv
            if scales:
                # the reference differentiates w.r.t. adv THROUGH the /2^i
                # scaling (sinifgsm.py:61-71): a 1/2^i chain factor per scale
                g = sum(grad_fn(point / (2.0 ** i), y) / (2.0 ** i) for i in range(scales)) / scales
            else:
                g = grad_fn(point, y)
            momentum = decay * momentum + g / _mean_abs(g)
            adv = _linf_step(x, adv, momentum, alpha, eps)
        return adv

    return attack


def mifgsm(logits_fn, eps: float = 8 / 255, alpha: float = 2 / 255,
           steps: int = 5, decay: float = 1.0) -> core.AttackFn:
    return _momentum_family(logits_fn, eps, alpha, steps, decay)


def nifgsm(logits_fn, eps: float = 8 / 255, alpha: float = 2 / 255,
           steps: int = 5, decay: float = 1.0) -> core.AttackFn:
    return _momentum_family(logits_fn, eps, alpha, steps, decay, nesterov=True)


def sinifgsm(logits_fn, eps: float = 8 / 255, alpha: float = 2 / 255,
             steps: int = 5, decay: float = 1.0, m: int = 5) -> core.AttackFn:
    return _momentum_family(logits_fn, eps, alpha, steps, decay, nesterov=True, scales=m)


def _variance_family(logits_fn, eps, alpha, steps, decay, n, beta, nesterov):
    """VMIFGSM / VNIFGSM (vmifgsm.py:46-110): variance tuning with ``n``
    uniform neighbours in a beta * eps ball, drawn one at a time."""
    grad_fn = _make_cost_grad(logits_fn, False)

    def draw(x, generator):
        return ((_uniform(x, generator, -eps * beta, eps * beta) for _ in range(n))
                for _ in range(steps))

    def run(x, y, neighbours):
        x = x.detach()
        adv, momentum, v = x, torch.zeros_like(x), torch.zeros_like(x)
        for offsets in neighbours:
            point = adv + decay * alpha * momentum if nesterov else adv
            g = grad_fn(point, y)
            adv_grad = g + v
            gm = decay * momentum + adv_grad / _mean_abs(adv_grad)
            gv = torch.zeros_like(x)
            for offset in offsets:
                gv = gv + grad_fn(adv + offset, y)
            v = gv / n - g
            adv = _linf_step(x, adv, gm, alpha, eps)
            momentum = gm
        return adv

    return core.DrawnAttack(draw, run)


def vmifgsm(logits_fn, eps: float = 8 / 255, alpha: float = 2 / 255,
            steps: int = 5, decay: float = 1.0, N: int = 20,
            beta: float = 3 / 2) -> core.DrawnAttack:
    return _variance_family(logits_fn, eps, alpha, steps, decay, N, beta, False)


def vnifgsm(logits_fn, eps: float = 8 / 255, alpha: float = 2 / 255,
            steps: int = 5, decay: float = 1.0, N: int = 20,
            beta: float = 3 / 2) -> core.DrawnAttack:
    return _variance_family(logits_fn, eps, alpha, steps, decay, N, beta, True)


# -- input diversity (DIFGSM, TIFGSM) ----------------------------------------

def resize_taps(resize_rate: float, length: int) -> int:
    """Taps per output that cover the triangle kernel's support for every
    scale in [int(length * resize_rate) / length, 1], with a tap of zero
    weight to spare at each end."""
    low = min(length, int(length * resize_rate))
    kernel_scale = max(length / max(low, 1), 1.0)
    return int(math.floor(2.0 * kernel_scale)) + 4


def resize_linear(x: torch.Tensor, scale: torch.Tensor, translation: torch.Tensor,
                  taps: int) -> torch.Tensor:
    """``jax.image.scale_and_translate(x, x.shape, (last axis,), scale,
    translation, method="linear")`` on (B, L), as a banded gather.

    JAX's weights (``jax/_src/image/scale.py:compute_weight_mat``, antialias
    on): a triangle kernel widened by 1/scale when scale < 1, at the sample
    ``(o + 0.5) / scale - translation / scale - 0.5`` of output o; each
    output's weights divided by their sum where that sum is above
    1000 f32-eps (else 0); zero where the sample lies outside
    [-0.5, L - 0.5]. Output o reads only the ``taps`` inputs from
    floor(sample - kernel scale) - 1 on (``resize_taps``); the others have
    weight 0 in JAX's dense matrix. ``scale`` and ``translation`` are f32
    0-d tensors on x's device.
    """
    length = x.shape[-1]
    dtype = torch.float32
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out_pos = torch.arange(length, device=x.device, dtype=dtype)
    sample_f = (out_pos + 0.5) * inv_scale - translation * inv_scale - 0.5  # (L,)
    first = torch.floor(sample_f - kernel_scale) - 1.0
    src = first[None, :] + torch.arange(taps, device=x.device, dtype=dtype)[:, None]  # (K, L)
    w = torch.clamp(1.0 - (sample_f[None, :] - src).abs() / kernel_scale, min=0.0)
    w = torch.where((src >= 0) & (src <= length - 1), w, torch.zeros_like(w))
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= length - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w)).to(x.dtype)
    idx = src.clamp(0, length - 1).long()
    out = w[0] * x[:, idx[0]]
    for k in range(1, taps):
        out = out + w[k] * x[:, idx[k]]
    return out


def _draw_diversity(x, generator, resize_rate):
    """One step's (output length, shift, u) of the input diversity: the
    JAX package's randint(lo, max(hi, lo + 1)), randint(0, max(L - rnd, 1))
    and uniform(), kept on x's device."""
    length = x.shape[-1]
    lo, hi = sorted((length, int(length * resize_rate)))
    rnd = torch.randint(lo, max(hi, lo + 1), (), generator=generator, device=x.device)
    span = torch.clamp(length - rnd, min=1)
    shift = torch.floor(torch.rand((), generator=generator, device=x.device,
                                   dtype=torch.float64) * span).long()
    u = torch.rand((), generator=generator, device=x.device)
    return rnd, shift, u


def _diversity(a, draws, diversity_prob, taps):
    rnd, shift, u = draws
    scale = rnd.to(torch.float32) / a.shape[-1]
    resized = resize_linear(a, scale, shift.to(torch.float32), taps)
    return torch.where(u < diversity_prob, resized, a)


def difgsm(logits_fn, eps: float = 8 / 255, alpha: float = 2 / 255,
           steps: int = 10, decay: float = 0.0, resize_rate: float = 0.9,
           diversity_prob: float = 0.5, random_start: bool = False) -> core.DrawnAttack:
    """DI2-FGSM (difgsm.py:48-110): the image's random resize-and-pad
    becomes its 1-D analogue on the wave (``resize_linear``)."""

    def draw(x, generator):
        start = _uniform(x, generator, -eps, eps) if random_start else None
        return start, (_draw_diversity(x, generator, resize_rate) for _ in range(steps))

    def run(x, y, draws):
        start, diversity = draws
        x = x.detach()
        taps = resize_taps(resize_rate, x.shape[-1])
        adv = x if start is None else (x + start).clamp(0.0, 1.0)
        momentum = torch.zeros_like(x)
        for d in diversity:
            g = _grad_of(lambda a: core.two_class_ce(
                logits_fn(_diversity(a, d, diversity_prob, taps)), y), adv)
            if decay:
                g = g / _mean_abs(g) + momentum * decay
                momentum = g
            adv = _linf_step(x, adv, g, alpha, eps)
        return adv

    return core.DrawnAttack(draw, run)


def upgd(logits_fn, eps: float = 8 / 255, alpha: float = 2 / 255,
         steps: int = 40, random_start: bool = False, loss: str = "ce",
         decay: float = 1.0, eot_iter: int = 1) -> core.DrawnAttack:
    """Ultimate PGD (upgd.py:35-137), CE or margin loss. 'dlr' needs >= 4
    classes (upstream indexes sorted[-3:-4]) and raises, as it would crash
    the reference on 2-class logits."""
    if loss == "ce":
        def cost_fn(x, y):
            return core.two_class_ce(logits_fn(x), y)
    elif loss == "margin":
        def cost_fn(x, y):
            logits2 = core.two_class_logits(logits_fn(x))
            oh = F.one_hot(y, 2).to(logits2.dtype)
            i = ((1 - oh) * logits2).amax(dim=1)
            j = (oh * logits2).sum(dim=1)
            return -torch.clamp(j - i, min=0.0).sum()
    else:
        raise ValueError(f"loss '{loss}' needs >= 4 classes (2-class audio)")

    def draw(x, generator):
        return _uniform(x, generator, -eps, eps) if random_start else None

    def run(x, y, noise):
        x = x.detach()
        adv = x if noise is None else (x + noise).clamp(0.0, 1.0)
        momentum = torch.zeros_like(x)
        for _ in range(steps):
            g = sum(_grad_of(lambda a: cost_fn(a, y), adv) for _ in range(eot_iter)) / eot_iter
            g = g / _mean_abs(g) + momentum * decay
            momentum = g
            adv = _linf_step(x, adv, g, alpha, eps)
        return adv

    return core.DrawnAttack(draw, run)


def jitter_cost(logits_fn, x, y, adv, noise, scale: float, std: float) -> torch.Tensor:
    """Jitter's cost at ``adv`` (jitter.py:60-86): the mean over rows of the
    MSE between the one-hot label and softmax(scale (-z, z) / max|(-z, z)|)
    plus ``std`` times ``noise`` (B, 2), divided by max|adv - x| for rows
    already wrong."""
    logits2 = core.two_class_logits(logits_fn(adv))
    wrong = logits2.argmax(dim=1) != y
    norm_z = logits2.abs().amax(dim=1, keepdim=True)
    hat_z = torch.softmax(scale * logits2 / norm_z, dim=1)
    if noise is not None:
        hat_z = hat_z + std * noise
    cost = ((hat_z - F.one_hot(y, 2).to(hat_z.dtype)) ** 2).mean(dim=1)
    norm_r = (adv - x).reshape(x.shape[0], -1).abs().amax(dim=1)
    divide = wrong & (norm_r != 0)
    return torch.where(divide, cost / torch.clamp(norm_r, min=1e-12), cost).mean()


def jitter(logits_fn, eps: float = 8 / 255, alpha: float = 2 / 255,
           steps: int = 10, scale: float = 10.0, std: float = 0.1,
           random_start: bool = True) -> core.DrawnAttack:
    """Jitter (jitter.py:44-98): MSE to the one-hot of a Linf-normalised,
    scaled softmax (plus noise), divided by the perturbation's norm for
    rows already wrong.

    Under the 2-class widening the loss depends on z only through sign(z),
    so its gradient is zero almost everywhere and the sign steps follow
    round-off, as in the JAX package (its
    ``test_jitter_2class_degeneracy``)."""

    def draw(x, generator):
        start = _uniform(x, generator, -eps, eps) if random_start else None
        noise = ((torch.randn((x.shape[0], 2), generator=generator, device=x.device)
                  if std != 0 else None) for _ in range(steps))
        return start, noise

    def run(x, y, draws):
        start, noises = draws
        x = x.detach()
        adv = x if start is None else (x + start).clamp(0.0, 1.0)
        for noise in noises:
            g = _grad_of(lambda a: jitter_cost(logits_fn, x, y, a, noise, scale, std), adv)
            adv = _linf_step(x, adv, g, alpha, eps)
        return adv

    return core.DrawnAttack(draw, run)


def deepfool(logits_fn, steps: int = 50, overshoot: float = 0.02) -> core.AttackFn:
    """DeepFool (deepfool.py:37-103) in the 2-class collapse: f' = 2z(1 - 2
    y_pred), w' = 2 (dz/dx)(1 - 2 y_pred), delta = |f'| w' / ||w'||^2;
    rows already fooled freeze."""

    def attack(x, y, generator=None):
        x = x.detach()
        shape1 = _bshape(x)
        adv = x
        for _ in range(steps):
            z, g = core.z_and_grad(logits_fn, adv)
            pred = (z > 0).long()
            sign = 1.0 - 2.0 * pred.to(x.dtype)  # toward the other class
            f_prime = 2.0 * z * sign
            w_prime = 2.0 * g * sign.reshape(shape1)
            w_norm2 = (w_prime.reshape(x.shape[0], -1) ** 2).sum(dim=1) + 1e-12
            delta = (f_prime.abs() / w_norm2).reshape(shape1) * w_prime
            adv_new = (adv + (1 + overshoot) * delta).clamp(0.0, 1.0)
            adv = torch.where((pred == y).reshape(shape1), adv_new, adv)
        return adv

    return attack


def _tifgsm_kernel(kernel_name: str, len_kernel: int, nsig: int) -> np.ndarray:
    if kernel_name == "gaussian":
        import scipy.stats as st

        kern1d = st.norm.pdf(np.linspace(-nsig, nsig, len_kernel))
        return (kern1d / kern1d.sum()).astype(np.float32)
    if kernel_name == "uniform":
        return (np.ones(len_kernel) / len_kernel).astype(np.float32)
    if kernel_name == "linear":
        kern1d = 1 - np.abs(np.linspace((-len_kernel + 1) / 2, (len_kernel - 1) / 2, len_kernel)
                            / (len_kernel ** 2))
        return (kern1d / kern1d.sum()).astype(np.float32)
    raise ValueError(kernel_name)


def tifgsm(logits_fn, eps: float = 8 / 255, alpha: float = 2 / 255,
           steps: int = 10, decay: float = 1.0, kernel_name: str = "gaussian",
           len_kernel: int = 15, nsig: int = 3, resize_rate: float = 0.9,
           diversity_prob: float = 0.5, random_start: bool = False) -> core.DrawnAttack:
    """TI-FGSM (tifgsm.py): the gradient smoothed by a 1-D kernel on the wave
    (the 2-D kernel conv of tifgsm.py:92; a cross-correlation with 'same'
    padding), with DIFGSM's input diversity and MIFGSM's momentum."""
    kernel = torch.from_numpy(_tifgsm_kernel(kernel_name, len_kernel, nsig))

    def draw(x, generator):
        start = _uniform(x, generator, -eps, eps) if random_start else None
        return start, (_draw_diversity(x, generator, resize_rate) for _ in range(steps))

    def run(x, y, draws):
        start, diversity = draws
        x = x.detach()
        taps = resize_taps(resize_rate, x.shape[-1])
        k = kernel.to(device=x.device, dtype=x.dtype)[None, None, :]
        adv = x if start is None else (x + start).clamp(0.0, 1.0)
        momentum = torch.zeros_like(x)
        for d in diversity:
            g = _grad_of(lambda a: core.two_class_ce(
                logits_fn(_diversity(a, d, diversity_prob, taps)), y), adv)
            g = F.conv1d(g[:, None, :], k, padding=len(kernel) // 2)[:, 0, :]
            g = g / _mean_abs(g)
            g = g + momentum * decay
            momentum = g
            adv = _linf_step(x, adv, g, alpha, eps)
        return adv

    return core.DrawnAttack(draw, run)


def sparsefool(logits_fn, steps: int = 10, lam: float = 3.0,
               overshoot: float = 0.02, max_inner: int = 20) -> core.AttackFn:
    """SparseFool (sparsefool.py:44-129): a DeepFool boundary point, then an
    L1 linear solver that saturates one coordinate at a time. The
    per-sample loops become batch masks over ``steps`` outer and
    ``max_inner`` solver iterations, as in the JAX package."""

    def deepfool_step(adv):
        z, g = core.z_and_grad(logits_fn, adv)
        sign = 1.0 - 2.0 * (z > 0).to(adv.dtype)
        f_prime = 2.0 * z * sign
        w_prime = 2.0 * g * sign[:, None]
        w_norm2 = (w_prime.reshape(adv.shape[0], -1) ** 2).sum(dim=1) + 1e-12
        delta = (f_prime.abs() / w_norm2)[:, None] * w_prime
        return (adv + (1 + 0.02) * delta).clamp(0.0, 1.0)

    def attack(x, y, generator=None):
        x = x.detach()
        b, length = x.shape
        positions = torch.arange(length, device=x.device)
        adv = x
        for _ in range(steps):
            with torch.no_grad():
                still_correct = (logits_fn(adv).squeeze(-1) > 0).long() == y
            adv_l = x + lam * (deepfool_step(adv) - x)
            # the gradient of (f_other - f_label) at the overshot point
            _, g2 = core.z_and_grad(logits_fn, adv_l)
            grad = 2.0 * g2 * (1.0 - 2.0 * y.to(x.dtype))[:, None]
            grad = grad / ((grad.reshape(b, -1) ** 2).sum(dim=1).sqrt() + 1e-12)[:, None]

            # saturate the largest-|normal| coordinate until the plane through
            # adv_l with that normal is crossed
            x_i, coord = x, grad
            sign_true = torch.sign((grad * (x - adv_l)).sum(dim=1) + 1e-12)
            for _ in range(max_inner):
                f_k = (grad * (x_i - adv_l)).sum(dim=1)
                coord_max = coord.abs().amax(dim=1)
                active = ((torch.sign(f_k + 0.001 * sign_true) == sign_true) & (coord_max > 0))
                pert = torch.clamp((f_k + 0.001 * sign_true).abs() / (coord_max + 1e-12), min=1e-4)
                mask = (positions == coord.abs().argmax(dim=1)[:, None]).to(x.dtype)
                x_new = (x_i + pert[:, None] * mask * coord.sign()).clamp(0.0, 1.0)
                x_i = torch.where(active[:, None], x_new, x_i)
                coord = torch.where(active[:, None], coord * (1.0 - mask), coord)

            adv_new = (x + (1 + overshoot) * (x_i - x)).clamp(0.0, 1.0)
            adv = torch.where(still_correct[:, None], adv_new, adv)
        return adv

    return attack


def pixle(logits_fn, x_dimensions=(2, 10), restarts: int = 20,
          max_iterations: int = 100) -> core.DrawnAttack:
    """Pixle (pixle.py): black-box rearrangement search; the image patches
    become wave segments. Each query copies a random source segment's
    values onto a random destination, accepted where the true-class
    probability fell. Forwards only; rows misclassified at first come
    back unchanged."""
    lo = max(1, int(x_dimensions[0]))
    hi = max(lo + 1, int(x_dimensions[1]))

    def true_prob(x, y):
        z = logits_fn(x).squeeze(-1)
        return torch.sigmoid(2.0 * (2.0 * y.to(z.dtype) - 1.0) * z)

    def draw(x, generator):
        b, length = x.shape

        def query():
            s = torch.randint(lo, hi, (), generator=generator, device=x.device)

            def position():  # U{0, ..., L - s}
                u = torch.rand((b, 1), generator=generator, device=x.device, dtype=torch.float64)
                return torch.floor(u * (length - s + 1)).long()

            return s, position(), position()

        return (query() for _ in range(restarts * max_iterations))

    def run(x, y, queries):
        x = x.detach()
        idx = torch.arange(x.shape[1], device=x.device)[None, :]
        with torch.no_grad():
            best, best_p = x, true_prob(x, y)
            for s, src, dst in queries:
                moved = torch.gather(best, 1, (idx + (src - dst)).clamp(0, x.shape[1] - 1))
                candidate = torch.where((idx >= dst) & (idx < dst + s), moved, best)
                p_new = true_prob(candidate, y)
                accept = p_new < best_p
                best = torch.where(accept[:, None], candidate, best)
                best_p = torch.where(accept, p_new, best_p)
            originally_correct = core.predicted_label(logits_fn(x)) == y
        return torch.where(originally_correct[:, None], best, x)

    return core.DrawnAttack(draw, run)
