"""Logging in the reference's format (ref: common/utils.py:8-25); a copy of
`mulut_tpu.utils.logging_utils`.

File + stream handlers, '%y-%m-%d %H:%M:%S.ms : message' lines.  The
reference is idempotent per logger NAME because every pipeline step is its
own process; our pipelines run in one process, so a repeated setup with a
NEW log path must retarget the file handler (same name + same path stays a
no-op), or a second experiment would silently log into the first one's file.
"""

from __future__ import annotations

import logging
import os


def logger_info(logger_name: str, log_path: str = "default_logger.log") -> None:
    log = logging.getLogger(logger_name)
    target = os.path.abspath(log_path)
    # Check this logger's own handlers, not hasHandlers(): that walks up to
    # the root logger, which libraries often populate, and would skip setup.
    for h in list(log.handlers):
        if isinstance(h, logging.FileHandler):
            if os.path.abspath(h.baseFilename) == target:
                return  # already set up for this exact file
            log.removeHandler(h)
            h.close()

    formatter = logging.Formatter(
        "%(asctime)s.%(msecs)03d : %(message)s", datefmt="%y-%m-%d %H:%M:%S"
    )
    log.propagate = False
    log.setLevel(logging.INFO)
    fh = logging.FileHandler(log_path, mode="a")
    fh.setFormatter(formatter)
    log.addHandler(fh)
    if not any(
        isinstance(h, logging.StreamHandler)
        and not isinstance(h, logging.FileHandler)
        for h in log.handlers
    ):
        sh = logging.StreamHandler()
        sh.setFormatter(formatter)
        log.addHandler(sh)
