"""Attack registry + builder (port of ``adaa_tpu/attacks/__init__.py``).

``ATTACK_REGISTRY`` has the JAX registry's keys and parameters, which
mirror the reference's ``AttackEnum``: FGSM, PGD, PGDL2 and FAB.
``EXTRA_ATTACKS`` has the JAX package's other 25 names: CW and OnePixel
(adapted in the reference's library, outside its ``AttackEnum``), APGD /
APGDT, Square, AutoAttack and the stock torchattacks family
(``attacks/extra.py``), each with its builder's defaults.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from adaa_tpu_torch.attacks import core
from adaa_tpu_torch.attacks.core import (  # noqa: F401
    attack_in_wave_space,
    make_logits_fn,
    predicted_label,
    revert_minmax,
    to_minmax,
    two_class_ce,
    two_class_logits,
)
from adaa_tpu_torch.attacks import extra as _extra
from adaa_tpu_torch.attacks.apgd import apgd, apgdt
from adaa_tpu_torch.attacks.composite import autoattack, multiattack  # noqa: F401
from adaa_tpu_torch.attacks.cw import cw
from adaa_tpu_torch.attacks.fab import fab
from adaa_tpu_torch.attacks.gradient import fgsm, pgd, pgdl2
from adaa_tpu_torch.attacks.onepixel import onepixel
from adaa_tpu_torch.attacks.square import square

# name -> (builder | None, params) — mirrors AttackEnum (aa_types.py:5-24)
ATTACK_REGISTRY: Dict[str, Tuple[Optional[Callable], Dict[str, Any]]] = {
    "PGD": (pgd, {"eps": 0.0005, "steps": 10}),
    "PGD_eps00075": (pgd, {"eps": 0.00075, "steps": 10}),
    "PGD_eps001": (pgd, {"eps": 0.001, "steps": 10}),
    "PGDL2": (pgdl2, {"eps": 0.1, "steps": 10}),
    "PGDL2_eps15": (pgdl2, {"eps": 0.15, "steps": 10}),
    "PGDL2_eps20": (pgdl2, {"eps": 0.20, "steps": 10}),
    "FGSM": (fgsm, {"eps": 0.0005}),
    "FGSM_eps00075": (fgsm, {"eps": 0.00075}),
    "FGSM_eps001": (fgsm, {"eps": 0.001}),
    "FAB": (fab, {"n_classes": 2, "eta": 10}),
    "FAB_eta20": (fab, {"n_classes": 2, "eta": 20}),
    "FAB_eta30": (fab, {"n_classes": 2, "eta": 30}),
    "NO_ATTACK": (None, {}),
}

EXTRA_ATTACKS: Dict[str, Callable] = {
    "CW": cw,
    "OnePixel": onepixel,
    "APGD": apgd,
    "APGDT": apgdt,
    "Square": square,
    "AutoAttack": autoattack,
    "VANILA": _extra.vanila,
    "GN": _extra.gn,
    "BIM": _extra.bim,
    "RFGSM": _extra.rfgsm,
    "FFGSM": _extra.ffgsm,
    "TPGD": _extra.tpgd,
    "EOTPGD": _extra.eotpgd,
    "MIFGSM": _extra.mifgsm,
    "NIFGSM": _extra.nifgsm,
    "SINIFGSM": _extra.sinifgsm,
    "VMIFGSM": _extra.vmifgsm,
    "VNIFGSM": _extra.vnifgsm,
    "DIFGSM": _extra.difgsm,
    "UPGD": _extra.upgd,
    "Jitter": _extra.jitter,
    "DeepFool": _extra.deepfool,
    "TIFGSM": _extra.tifgsm,
    "SparseFool": _extra.sparsefool,
    "Pixle": _extra.pixle,
}


def attack_names() -> list:
    return list(ATTACK_REGISTRY.keys())


def build_attack(
    name: str,
    logits_fn: core.LogitsFn,
    override_params: Optional[Dict[str, Any]] = None,
) -> Optional[core.AttackFn]:
    """Instantiate attack ``name`` against ``logits_fn``.

    Returns ``(x01, y, generator) -> adv01`` in min-max space, or None
    for NO_ATTACK.
    """
    if name in ATTACK_REGISTRY:
        builder, params = ATTACK_REGISTRY[name]
    elif name in EXTRA_ATTACKS:
        builder, params = EXTRA_ATTACKS[name], {}
    else:
        raise KeyError(f"Unknown attack '{name}'")
    if builder is None:
        return None
    params = dict(params)
    if override_params:
        params.update(override_params)
    return builder(logits_fn, **params)
