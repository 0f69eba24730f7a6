"""The `kcmc_tpu_torch` logger and the advisory-warning routing seam
(the port's copy of kcmc_tpu/obs/log.py).

The library's advisory diagnostics (rescue-fraction warnings, checkpoint
quarantine, zlib downgrade, degradation-ladder recoveries) go through
`advise()`, the one seam both worlds share:

* library default: `warnings.warn(RuntimeWarning)`, so `pytest.warns`
  contracts and an embedder's warning filters see them;
* CLI runs (`setup_cli_logging`, wired to `--verbose`/`--quiet`): the
  same messages flow through `logging.getLogger("kcmc_tpu_torch")` to
  stderr, leaving stdout to the machine-readable JSON summaries.
"""

from __future__ import annotations

import logging
import sys
import warnings

LOGGER_NAME = "kcmc_tpu_torch"

# Flipped by setup_cli_logging(); module state rather than logger state
# so library embedders who attach their OWN handlers to the logger
# don't silently lose the warnings.warn behavior they may filter on.
_route_to_logger = False

# Tag attribute marking handlers we installed, so repeated
# setup_cli_logging calls replace rather than stack them.
_HANDLER_TAG = "_kcmc_cli_handler"


def get_logger(name: str | None = None) -> logging.Logger:
    """The package logger (or a named child, e.g. ``heartbeat``)."""
    return logging.getLogger(
        LOGGER_NAME if not name else f"{LOGGER_NAME}.{name}"
    )


def advise(message: str, category: type[Warning] = RuntimeWarning,
           stacklevel: int = 2) -> None:
    """Emit an advisory diagnostic: through the package logger at
    WARNING level when CLI logging is configured (`setup_cli_logging`),
    else through `warnings.warn`."""
    if _route_to_logger:
        get_logger().warning(message)
    else:
        warnings.warn(message, category, stacklevel=stacklevel + 1)


def cli_logging_active() -> bool:
    return _route_to_logger


def setup_cli_logging(
    verbose: int = 0, quiet: int = 0, stream=None
) -> logging.Logger:
    """Configure the package logger for a CLI process.

    Logs go to stderr (stdout stays machine-readable JSON). `verbose`
    and `quiet` are repeat counts: the base level is WARNING; each
    ``-v`` lowers it one step (INFO, then DEBUG) and each ``-q`` raises
    it one step (ERROR, then CRITICAL). Also routes `advise()`
    diagnostics through the logger instead of `warnings.warn`.
    Idempotent: repeated calls replace the handler, never stack it.
    """
    global _route_to_logger
    level = logging.WARNING + 10 * (int(quiet) - int(verbose))
    level = min(max(level, logging.DEBUG), logging.CRITICAL)
    logger = logging.getLogger(LOGGER_NAME)
    for h in list(logger.handlers):
        if getattr(h, _HANDLER_TAG, False):
            logger.removeHandler(h)
    handler = logging.StreamHandler(stream if stream is not None else sys.stderr)
    handler.setFormatter(
        logging.Formatter(
            "%(asctime)s [kcmc %(levelname)s] %(message)s", datefmt="%H:%M:%S"
        )
    )
    # Level filtering happens on loggers only: the heartbeat emitter
    # falls back to stderr when INFO is filtered, so explicit heartbeat
    # output survives the default WARNING level without -v.
    handler.setLevel(logging.NOTSET)
    setattr(handler, _HANDLER_TAG, True)
    logger.addHandler(handler)
    logger.setLevel(level)
    logger.propagate = False
    _route_to_logger = True
    return logger


def reset_cli_logging() -> None:
    """Undo setup_cli_logging (idempotent)."""
    global _route_to_logger
    logger = logging.getLogger(LOGGER_NAME)
    for h in list(logger.handlers):
        if getattr(h, _HANDLER_TAG, False):
            logger.removeHandler(h)
    logger.setLevel(logging.NOTSET)
    logger.propagate = True
    _route_to_logger = False
