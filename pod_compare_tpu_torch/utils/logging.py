"""Logger setup: a stdlib equivalent of detectron2's setup_logger that also
tees to the output dir. The port's own copy of
``pod_compare_tpu/utils/logging.py``."""

import logging
import os
import sys
from typing import Optional

_CONFIGURED = set()


def setup_logger(
    output: Optional[str] = None,
    name: str = "pod_compare_tpu_torch",
    level: int = logging.INFO,
    rank: int = 0,
) -> logging.Logger:
    logger = logging.getLogger(name)
    if name in _CONFIGURED:
        return logger
    _CONFIGURED.add(name)
    logger.setLevel(level)
    logger.propagate = False

    fmt = logging.Formatter(
        "[%(asctime)s %(name)s %(levelname)s]: %(message)s", datefmt="%m/%d %H:%M:%S"
    )
    if rank == 0:
        sh = logging.StreamHandler(stream=sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if output is not None:
        os.makedirs(output, exist_ok=True)
        fh = logging.FileHandler(
            os.path.join(output, f"log.rank{rank}.txt" if rank else "log.txt")
        )
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
