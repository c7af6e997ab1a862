"""The synchronizing CUDA operations of a call, with their sites: what
sync debug mode "warn" reports (reads back to the host, blocking copies of
host values to the card), each attributed to the innermost frame of the
port on the stack. Used by chip_smoke.py's `[train]` phase and
`tools/step_times.py`."""
import os
import traceback
import warnings
from collections import Counter

import torch

HERE = os.path.abspath(__file__)
PORT = os.path.dirname(os.path.dirname(HERE))


def count_syncs(run, port=PORT):
    """Run `run()` under sync debug mode 'warn'; return the number of
    synchronizing operations and a Counter of their sites (file:line of the
    innermost frame under `port`, relative to its parent directory)."""
    sites = Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if f.filename.startswith(port + os.sep)
                  and os.path.abspath(f.filename) != HERE]
        where = frames[-1] if frames else None
        sites[f"{os.path.relpath(where.filename, os.path.dirname(port))}:"
              f"{where.lineno}" if where else f"{filename}:{lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(sites.values()), sites
