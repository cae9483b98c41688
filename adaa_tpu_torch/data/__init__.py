"""Data sources (port of ``adaa_tpu.data``, as the slices need them): the
batching loader and the synthetic dataset. The real corpora, raw mode's
silence trim and the decoders are in ROADMAP.md."""
