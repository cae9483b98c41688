"""Batch scripts of the port's CLIs (twins of ``scripts/multi_runs/``).

Each twin reads its batch config, builds one argv list per entry and
calls a CLI's ``main`` on it in this process (``run_all``); the helpers
below assemble the flags the twins share.
"""
from typing import Callable, Iterable, List, Optional, Sequence, Tuple


def corpus_argv(asv_path: Optional[str], data_path: str) -> List[str]:
    """``--asv_path`` alone when given, else the three corpora under ``data_path``."""
    if asv_path:
        return ["--asv_path", asv_path]
    return ["--asv_path", f"{data_path}/ASVspoof2021/DF",
            "--wavefake_path", f"{data_path}/WaveFake",
            "--celeb_path", f"{data_path}/FakeAVCeleb/FakeAVCeleb_v1.2"]


def passthrough(*pairs: Tuple[str, object]) -> List[str]:
    """``[flag, value]`` for each pair whose value is set (not None, not empty)."""
    return [s for flag, val in pairs if val is not None and val != "" for s in (flag, str(val))]


def run_all(cli, entries: Iterable, entry_argv: Callable[[object], Sequence[str]],
            cpu: bool) -> list:
    """``cli.main(cli.parse_args(argv))`` for each entry's argv (plus
    ``--cpu``), in order; returns what each run returned."""
    name = cli.__name__.rsplit(".", 1)[-1]
    results = []
    for entry in entries:
        argv = [*entry_argv(entry), *(["--cpu"] if cpu else [])]
        print(name, argv)
        results.append(cli.main(cli.parse_args(argv)))
    return results
