"""Per-category logging with console and per-category file routing.

Port of `disco4est_tpu/util/logging.py` (role of the reference's zlog set-up,
`IO/logging.conf:20-31`): every subsystem logs under its own category
(d4est, d4est_geometry, d4est_amr, d4est_solver_*, d4est_norms, …);
messages go to the console, to a combined `run.log` and to
`<category>.log` files.  The loggers sit under the JAX module's prefix,
`disco4est`, so both packages write the same lines.

One difference from the JAX module: reconfiguring also closes and drops
the per-category file handlers of the previous `log_dir`, so that no
handler outlives its directory.

Usage:
    from disco4est_tpu_torch.util.logging import init_logging, get_category
    init_logging(log_dir="logs")        # or None: console only
    log = get_category("d4est_solver_cg")
    log.info("iter %d r2 %.3e", it, r2)
"""

from __future__ import annotations

import logging
import os

_PREFIX = "disco4est"
_CONFIGURED = False
_LOG_DIR: str | None = None

#: the reference's category set (`IO/logging.conf`); other categories are
#: created on demand
CATEGORIES = (
    "d4est",
    "d4est_geometry",
    "d4est_mesh",
    "d4est_amr",
    "d4est_quadrature",
    "d4est_solver_cg",
    "d4est_solver_fcg",
    "d4est_solver_newton",
    "d4est_solver_multigrid",
    "d4est_solver_schwarz",
    "d4est_norms",
    "problem",
)

_FMT = logging.Formatter(
    "%(asctime)s [%(name)s:%(levelname)s] %(message)s", "%H:%M:%S"
)


def _drop_handlers(log: logging.Logger, only_files: bool):
    for h in list(log.handlers):
        if only_files and not isinstance(h, logging.FileHandler):
            continue
        log.removeHandler(h)
        h.close()


def init_logging(log_dir: str | None = None, level=logging.INFO,
                 console: bool = True):
    """Configure the category tree (reconfigures on every call).  With
    `log_dir`, messages also land in `run.log` plus one `<category>.log`
    per category — the zlog routing contract."""
    global _CONFIGURED, _LOG_DIR
    root = logging.getLogger(_PREFIX)
    root.setLevel(level)
    root.propagate = False
    _drop_handlers(root, only_files=False)
    for name, log in list(logging.Logger.manager.loggerDict.items()):
        if name.startswith(_PREFIX + ".") and isinstance(log, logging.Logger):
            _drop_handlers(log, only_files=True)
    if console:
        ch = logging.StreamHandler()
        ch.setFormatter(_FMT)
        root.addHandler(ch)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, "run.log"))
        fh.setFormatter(_FMT)
        root.addHandler(fh)
    _LOG_DIR = log_dir
    _CONFIGURED = True
    for c in CATEGORIES:
        get_category(c)
    return root


def get_category(name: str) -> logging.Logger:
    """Logger for a category; attaches its file handler lazily
    (`zlog_get_category` role)."""
    if not _CONFIGURED:
        init_logging(None)
    log = logging.getLogger(f"{_PREFIX}.{name}")
    if _LOG_DIR is not None and not any(
        isinstance(h, logging.FileHandler)
        and getattr(h, "_d4est_cat", None) == name
        for h in log.handlers
    ):
        fh = logging.FileHandler(os.path.join(_LOG_DIR, f"{name}.log"))
        fh.setFormatter(_FMT)
        fh._d4est_cat = name
        log.addHandler(fh)
    return log
