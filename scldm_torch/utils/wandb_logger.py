"""Optional Weights & Biases logging (counterpart of
scldm_tpu/utils/wandb_logger.py; the reference's training/default.yaml:19-36
runs a rank-0 WandbLogger). wandb is imported when a logger is made, and a
missing package or network degrades to a warning; enable with
`training.wandb.enabled=true`."""

from __future__ import annotations

from typing import Dict, Optional

from scldm_torch.utils.logger import logger


class WandbLogger:
    def __init__(self, project: str = "scldm-torch", name: Optional[str] = None,
                 config: Optional[dict] = None, enabled: bool = True):
        self._run = None
        if not enabled:
            return
        try:
            import wandb

            self._run = wandb.init(project=project, name=name, config=config)
        except Exception as e:  # missing package / no network
            logger.warning(f"wandb disabled: {e}")

    def log(self, metrics: Dict, step: Optional[int] = None):
        if self._run is not None:
            self._run.log(metrics, step=step)

    def finish(self):
        if self._run is not None:
            self._run.finish()
