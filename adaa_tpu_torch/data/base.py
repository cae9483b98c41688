"""Canonical audio constants (from ``adaa_tpu/data/base.py``, which mirrors
the reference's base_dataset.py:21-33). The preprocessing of that module
(decode, silence trim, pad) is not ported yet; see ROADMAP.md."""
WAVE_FAKE_SR = 16_000
WAVE_FAKE_CUT = 64_600
