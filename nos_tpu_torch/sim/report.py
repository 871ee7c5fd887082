"""The report contract, ``nos_tpu/sim/report.py`` for the port: stdout
is ONE JSON document.

A caller parses a simulator run (``python -m nos_tpu_torch.sim``) as a
single JSON document on stdout, so every byte a library it drives
prints must go to stderr.  ``stdout_to_stderr`` is the swap, ``emit``
the one final line and ``write_report`` the pretty artifact beside it.

``tests/test_torch_sim.py`` pins the contract: under
``stdout_to_stderr``, library prints land on stderr and exactly one JSON
document reaches the real stdout through ``emit``.
"""

from __future__ import annotations

import json
import sys
from contextlib import contextmanager
from typing import Any, Iterator, Optional, TextIO


@contextmanager
def stdout_to_stderr() -> Iterator[TextIO]:
    """Route ``sys.stdout`` to stderr for the duration and yield the
    REAL stdout handle: stray library output lands safely, and the real
    handle is kept for the single final JSON line."""
    real_stdout = sys.stdout
    sys.stdout = sys.stderr
    try:
        yield real_stdout
    finally:
        sys.stdout = real_stdout


def emit(payload: Any, stream: Optional[TextIO] = None) -> None:
    """The single final line: one JSON document, flushed.  Inside
    ``stdout_to_stderr`` pass the yielded real handle; outside, the
    current stdout is already the right place."""
    out = stream if stream is not None else sys.stdout
    print(json.dumps(payload), file=out, flush=True)


def write_report(path: str, payload: Any, *,
                 note: str = "report") -> None:
    """Artifact writer: dump ``payload`` to ``path`` (indent=2) and note
    it on stderr, never stdout.  An empty path writes nothing."""
    if not path:
        return
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2)
    print(f"{note} written to {path}", file=sys.stderr)
