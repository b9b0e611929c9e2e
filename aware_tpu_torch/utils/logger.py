"""The port's logger: the stdlib logger ``aware_tpu_torch`` with ANSI
colored levels, on STDERR so that the command lines' JSON on stdout stays
clean (a copy of ``aware_tpu/utils/logger.py``).  The port's modules log
under it (``aware_tpu_torch.eval`` and so on)."""

import logging
import sys

_COLORS = {
    logging.DEBUG: "\x1b[36m",     # cyan
    logging.INFO: "\x1b[32m",      # green
    logging.WARNING: "\x1b[33m",   # yellow
    logging.ERROR: "\x1b[31m",     # red
    logging.CRITICAL: "\x1b[41m",  # red background
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        color = _COLORS.get(record.levelno, "")
        prefix = f"{color}[{record.levelname}]{_RESET}" if color else f"[{record.levelname}]"
        return f"{prefix} {record.name}: {record.getMessage()}"


logger = logging.getLogger("aware_tpu_torch")
if not logger.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(_ColorFormatter())
    logger.addHandler(_handler)
    logger.setLevel(logging.INFO)
    logger.propagate = False
