"""Runtime helpers: logger naming and phase timers.

Port of ``deepcalcium_tpu.utils.runtime`` (``funcname``, ``phase_timer``).
"""

import contextlib
import inspect
import logging
import time

__all__ = ["funcname", "phase_timer"]


def funcname() -> str:
    """Name of the calling function, for ``logging.getLogger(funcname())``."""
    frame = inspect.currentframe()
    try:
        return frame.f_back.f_code.co_name  # type: ignore[union-attr]
    finally:
        del frame


@contextlib.contextmanager
def phase_timer(name: str, items: int | None = None, unit: str = "items"):
    """Log the wall-clock time of the enclosed block under logger ``name``,
    and ``items / seconds`` when ``items`` is given. The block must end in
    a device synchronisation (a copy to the host) for the time to cover
    the device's work."""
    logger = logging.getLogger(name)
    tic = time.perf_counter()
    yield
    dt = time.perf_counter() - tic
    if items is not None and dt > 0:
        logger.info("%s: %.3fs (%.1f %s/s)", name, dt, items / dt, unit)
    else:
        logger.info("%s: %.3fs", name, dt)
