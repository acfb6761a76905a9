"""Logging: per-process log files with tee-to-stderr.

Counterpart of the reference's macro logger (ref: common/log.h:127-133 —
auto-named `<basename>.<pid>.log` per process so every MPI rank gets its own
file; LOG_TEE mirrors to stderr :96-97). Here each host process (or driver
role) gets its own file; the speculation controller and pipeline stages are
instrumented through this module.

A copy of pipeinfer_tpu.utils.logging (which imports no JAX).
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path

_configured = False


def init(basename: str | None = None, *, log_dir: str | Path = ".", level=logging.INFO,
         disable_file: bool = False) -> logging.Logger:
    """Initialize the process logger: file `<basename>.<pid>.log` + stderr
    for warnings and above (the LOG/LOG_TEE split)."""
    global _configured
    logger = logging.getLogger("pipeinfer")
    if _configured:
        return logger
    _configured = True
    logger.setLevel(level)
    if not disable_file:
        base = basename or Path(sys.argv[0]).stem or "pipeinfer"
        path = Path(log_dir) / f"{base}.{os.getpid()}.log"
        fh = logging.FileHandler(path, delay=True)
        fh.setFormatter(logging.Formatter("%(asctime)s %(levelname).1s %(name)s: %(message)s"))
        logger.addHandler(fh)
    sh = logging.StreamHandler(sys.stderr)
    sh.setLevel(logging.WARNING)
    sh.setFormatter(logging.Formatter("%(levelname)s: %(message)s"))
    logger.addHandler(sh)
    return logger


def get() -> logging.Logger:
    return logging.getLogger("pipeinfer")


def tee(msg: str, *args):
    """LOG_TEE: always to stderr AND the log file (ref: log.h:96-97)."""
    log = get()
    log.info(msg, *args)
    print(msg % args if args else msg, file=sys.stderr)
