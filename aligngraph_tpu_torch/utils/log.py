"""Observability — C28 (stage banners, timing; reference prints
`(0) ...` through `(6) ...`, AlignGraph.cpp:4745-4795)."""

from __future__ import annotations

import logging
import sys
import time

_t0 = time.time()


def get_logger(name: str = "aligngraph_tpu") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "[%(asctime)s aligngraph] %(levelname)s %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def stage_banner(stage: int, msg: str) -> None:
    get_logger().info("(%d) %s [t=%.1fs]", stage, msg, time.time() - _t0)


def rss_mb() -> float:
    """Resident set size in MB (the reference snapshots `ps euf` to
    mem.txt per chromosome, AlignGraph.cpp:4778)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def log_memory(tag: str) -> None:
    get_logger().info("mem[%s]: %.0f MB RSS", tag, rss_mb())
