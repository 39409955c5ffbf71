"""A cell on several cards runs one process a card: the process started by
the command is rank 0, and starts ranks 1.. as the same command in
processes of their own, with the process group's address (a free port on
this machine) and each one's rank in the SSD3D_DIST_* variables that
`ssd3d_torch.parallel.distributed` reads."""

from __future__ import annotations

import os
import socket
import subprocess
import sys


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(chips: int) -> list:
    """-> the processes of ranks 1..chips-1 (none where this process is
    already a rank, or the cell takes one card)."""
    if chips == 1 or "SSD3D_DIST_PROCESS_ID" in os.environ:
        return []
    os.environ.update(SSD3D_DIST_COORDINATOR=f"localhost:{free_port()}",
                      SSD3D_DIST_NUM_PROCESSES=str(chips), SSD3D_DIST_PROCESS_ID="0")
    return [subprocess.Popen([sys.executable, *sys.argv],
                             env=dict(os.environ, SSD3D_DIST_PROCESS_ID=str(r)),
                             stdout=subprocess.DEVNULL)
            for r in range(1, chips)]


def stop(workers: list, seconds: float = 120.0) -> list[int]:
    """Wait for each rank to end (they end once their window has closed);
    kill one still running past `seconds` -> their exit codes."""
    codes = []
    for w in workers:
        try:
            codes.append(w.wait(timeout=seconds))
        except subprocess.TimeoutExpired:
            w.kill()
            codes.append(w.wait())
    return codes
