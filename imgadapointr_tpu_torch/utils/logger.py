"""Console and file logging (the port's copy of
``imgadapointr_tpu/utils/logger.py``, single process)."""

from __future__ import annotations

import logging


def get_logger(name: str, log_file: str | None = None, log_level: int = logging.INFO):
    """A logger with a console handler and, if ``log_file`` is given, a file
    handler; a second call with the same name replaces the handlers, so
    each run of one process logs to its own file."""
    logger = logging.getLogger(name)
    for old in list(logger.handlers):
        logger.removeHandler(old)
        old.close()
    handlers: list[logging.Handler] = [logging.StreamHandler()]
    if log_file is not None:
        handlers.append(logging.FileHandler(log_file, "w"))
    formatter = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    for handler in handlers:
        handler.setFormatter(formatter)
        handler.setLevel(log_level)
        logger.addHandler(handler)
    logger.setLevel(log_level)
    logger.propagate = False
    return logger


def print_log(msg: str, logger=None, level: int = logging.INFO) -> None:
    """``print`` without a logger, else log; the string 'silent' drops it."""
    if logger is None:
        print(msg, flush=True)
    elif isinstance(logger, logging.Logger):
        logger.log(level, msg)
    elif logger != "silent":
        raise TypeError(f"invalid logger {logger!r}")
