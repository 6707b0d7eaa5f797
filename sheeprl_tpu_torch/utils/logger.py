"""Logger factory: the TensorBoard writer and versioned log dirs
(counterpart of ``sheeprl_tpu/utils/logger.py``).

The writer imports ``tensorboardX`` when it first writes; with
``metric.log_level=0`` no logger is built at all (the card's machine has
no ``tensorboardX``).  The port runs one process, so the log dir needs no
broadcast.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

__all__ = ["TensorBoardLogger", "get_log_dir", "get_logger"]


class TensorBoardLogger:
    """A ``SummaryWriter`` behind ``log_metrics``/``log_hyperparams``."""

    def __init__(self, root_dir: str, name: str, version: Optional[str] = None):
        self._root_dir = root_dir
        self._name = name
        self._version = version
        self._writer = None

    @property
    def log_dir(self) -> str:
        return os.path.join(self._root_dir, self._name, self._version or "")

    @property
    def name(self) -> str:
        return self._name

    @property
    def writer(self):
        if self._writer is None:
            from tensorboardX import SummaryWriter

            os.makedirs(self.log_dir, exist_ok=True)
            self._writer = SummaryWriter(self.log_dir)
        return self._writer

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None) -> None:
        for k, v in metrics.items():
            self.writer.add_scalar(k, float(v), global_step=step)

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        import yaml

        plain = params.as_dict() if hasattr(params, "as_dict") else dict(params)
        self.writer.add_text("hparams", "```yaml\n" + yaml.safe_dump(plain) + "\n```")

    def finalize(self) -> None:
        if self._writer is not None:
            self._writer.close()


def get_log_dir(runtime, root_dir: str, run_name: str) -> str:
    """``<root_dir>/<run_name>/version_<N>``, N one more than the largest
    there (created)."""
    base = os.path.join(root_dir, run_name)
    os.makedirs(base, exist_ok=True)
    existing = [
        int(d.rsplit("_", 1)[1]) for d in os.listdir(base) if d.startswith("version_") and d.rsplit("_", 1)[1].isdigit()
    ]
    log_dir = os.path.join(base, f"version_{max(existing) + 1 if existing else 0}")
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


def get_logger(runtime, cfg: Dict[str, Any]) -> Optional[TensorBoardLogger]:
    """The configured logger, or None with ``metric.log_level=0``."""
    from sheeprl_tpu_torch.config import instantiate

    if cfg.metric.log_level == 0:
        return None
    logger_cfg = dict(cfg.metric.logger)
    root_dir = logger_cfg.get("root_dir", os.path.join("logs", "runs"))
    logger_cfg["root_dir"] = root_dir
    if logger_cfg.get("version") is None:
        base = os.path.join(root_dir, logger_cfg.get("name", "run"))
        existing = []
        if os.path.isdir(base):
            existing = [
                int(d.rsplit("_", 1)[1])
                for d in os.listdir(base)
                if d.startswith("version_") and d.rsplit("_", 1)[1].isdigit()
            ]
        logger_cfg["version"] = f"version_{max(existing) + 1 if existing else 0}"
    return instantiate(logger_cfg)
