"""The port's logger.

Counterpart of the part of ``deepspeed_tpu/utils/logging.py`` that the
telemetry modules use: one named logger that writes to stderr
(programmatic stdout, such as ``chip_smoke.py``'s JSON lines, stays
clean).
"""

import logging
import sys


def create_logger(name=None, level=logging.INFO):
    """A logger with one stderr stream handler, not propagating to the
    root logger."""
    logger_ = logging.getLogger(name)
    logger_.setLevel(level)
    logger_.propagate = False
    if not logger_.handlers:
        handler = logging.StreamHandler(stream=sys.stderr)
        handler.setLevel(level)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"))
        logger_.addHandler(handler)
    return logger_


logger = create_logger(name="DeepSpeedTPUTorch", level=logging.INFO)
