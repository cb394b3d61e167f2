"""Metrics logging: JSONL on disk always; wandb when available and configured
(the reference logs exclusively to wandb — run_emission.py:41,
model/sunerf.py:126-129; here wandb is optional so headless runs work). A copy of
sunerf_tpu/utils/logging.py."""
from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, workdir: str, project: str | None = None,
                 name: str | None = None, use_wandb: bool | None = None):
        os.makedirs(workdir, exist_ok=True)
        self._f = open(os.path.join(workdir, 'metrics.jsonl'), 'a')
        self._wandb = None
        if use_wandb is None:
            use_wandb = project is not None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(project=project or 'sunerf_tpu',
                                         name=name, dir=workdir)
            except Exception:  # wandb absent or offline — JSONL still records
                self._wandb = None

    def log(self, metrics: dict, step: int):
        rec = {'step': int(step), 'time': time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + '\n')
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_image(self, name: str, path: str, step: int):
        if self._wandb is not None:
            import wandb
            self._wandb.log({name: wandb.Image(path)}, step=step)

    def close(self):
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
