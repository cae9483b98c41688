"""Attack registry + builder (port of ``adaa_tpu/attacks/__init__.py``).

``ATTACK_REGISTRY`` has the JAX registry's keys and parameters, which
mirror the reference's ``AttackEnum``. FAB and the extra attacks are not
ported yet: building one raises ``NotImplementedError`` (see
ROADMAP.md, queue 1).
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
from adaa_tpu_torch.attacks.gradient import fgsm, pgd, pgdl2


def _not_ported(name: str) -> Callable:
    def builder(logits_fn, **params):
        raise NotImplementedError(
            f"attack '{name}' is not ported to adaa_tpu_torch yet (ROADMAP.md, queue 1)"
        )

    builder.__name__ = name.lower()
    return builder


fab = _not_ported("FAB")

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
    name: _not_ported(name)
    for name in (
        "CW", "OnePixel", "APGD", "APGDT", "Square", "AutoAttack", "VANILA",
        "GN", "BIM", "RFGSM", "FFGSM", "TPGD", "EOTPGD", "MIFGSM", "NIFGSM",
        "SINIFGSM", "VMIFGSM", "VNIFGSM", "DIFGSM", "UPGD", "Jitter",
        "DeepFool", "TIFGSM", "SparseFool", "Pixle",
    )
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
