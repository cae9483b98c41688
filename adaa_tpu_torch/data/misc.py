"""Misc one-off data utilities (a copy of ``adaa_tpu/data/misc.py``).

Mirror of the reference's src/datasets/misc/fakeavceleb_video2audio.py
(mp4 -> mp3 extraction via moviepy) — gated behind the optional
dependency, which is not installed with the port.
"""
from __future__ import annotations

from pathlib import Path


def fakeavceleb_video2audio(video_dir: str, output_dir: str,
                            extension: str = ".mp3") -> None:
    """Extract audio tracks from FakeAVCeleb mp4 files."""
    try:
        from moviepy.editor import VideoFileClip  # optional dependency
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "fakeavceleb_video2audio needs the optional 'moviepy' "
            "dependency, which is not installed"
        ) from e

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    for mp4 in Path(video_dir).glob("**/*.mp4"):
        clip = VideoFileClip(str(mp4))
        target = out / mp4.relative_to(video_dir).with_suffix(extension)
        target.parent.mkdir(parents=True, exist_ok=True)
        clip.audio.write_audiofile(str(target))
