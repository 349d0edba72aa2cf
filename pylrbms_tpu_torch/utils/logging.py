"""Logging: pyMOR-flavoured loggers with graded info levels + block sections
(the port's own copy of ``pylrbms_tpu/utils/logging.py``).

Replaces the two-channel logging of the reference (SURVEY.md §5.5):
pyMOR loggers with ``set_log_levels`` / ``logger.block`` / ``logger.info3``
(``scripts/online_adaptive_lrbms.py:8-36``) and DUNE's C++ logging
(``dune.xt.common.logging.create``).
"""
from __future__ import annotations

import contextlib
import logging
import sys
import time

_CONFIGURED = False


def _ensure_configured():
    global _CONFIGURED
    if not _CONFIGURED:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter("%(asctime)s %(name)s: %(message)s",
                                         datefmt="%H:%M:%S"))
        root = logging.getLogger("pylrbms")
        root.addHandler(h)
        root.setLevel(logging.INFO)
        root.propagate = False
        _CONFIGURED = True


class _Logger(logging.LoggerAdapter):
    """Adds pyMOR-style info2/info3 graded levels and block sections."""

    def info2(self, msg, *a, **kw):
        self.log(logging.INFO - 1, msg, *a, **kw)

    def info3(self, msg, *a, **kw):
        self.log(logging.INFO - 2, msg, *a, **kw)

    @contextlib.contextmanager
    def block(self, msg):
        self.info(msg + " ...")
        t0 = time.time()
        yield self
        self.info(f"... done ({time.time() - t0:.2f}s)")


def getLogger(name: str) -> _Logger:
    _ensure_configured()
    if not name.startswith("pylrbms"):
        name = "pylrbms." + name
    return _Logger(logging.getLogger(name), {})


def set_log_levels(levels: dict):
    """{'module': 'INFO'|'DEBUG'|...} (<-> pymor.core.logger.set_log_levels)."""
    _ensure_configured()
    for name, level in levels.items():
        if not name.startswith("pylrbms"):
            name = "pylrbms." + name
        logging.getLogger(name).setLevel(getattr(logging, level.upper(), logging.INFO))


def create(level: int = 54):
    """Interface parity with ``dune.xt.common.logging.create``
    (``online_adaptive_lrbms.py:35-36``): 63 ~ debug, 54 ~ prod."""
    set_log_levels({"pylrbms": "DEBUG" if level >= 60 else "INFO"})
