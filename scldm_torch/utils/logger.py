"""Console logger (counterpart of scldm_tpu/utils/logger.py; the reference's
src/scldm/logger.py without the rich dependency)."""

import logging
import sys

logger = logging.getLogger("scldm_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s scldm_torch: %(message)s", "%H:%M:%S")
    )
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
    logger.propagate = False
