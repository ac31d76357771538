"""The port's benchmark: ``python3 -m portbench.run --workload <name> ...``.

``START`` is the process's first clock reading, from which ``setup_s``
and the progress lines on standard error count.
"""

import sys
import time

START = time.perf_counter()


def log(msg: str) -> None:
    """A progress line on standard error, with the seconds since start."""
    print(f"portbench [{time.perf_counter() - START:8.2f} s] {msg}", file=sys.stderr, flush=True)
