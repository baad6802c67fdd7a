"""Training records: ``<save_path>/metrics.jsonl`` always, wandb when it is
installed and a project is named (own copy of
``pointvs_tpu/training/metrics_logger.py``)."""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, save_path, wandb_project: Optional[str] = None,
                 wandb_run: Optional[str] = None, wandb_dir=None,
                 config: Optional[Dict[str, Any]] = None):
        self.jsonl_path = Path(save_path) / 'metrics.jsonl'
        self._wandb = None
        if wandb_project:
            try:
                import wandb
            except ImportError:
                return
            wandb.init(project=wandb_project,
                       dir=str(wandb_dir or save_path),
                       config=config or {}, allow_val_change=True)
            if wandb_run:
                wandb.run.name = wandb_run
            self._wandb = wandb

    def log(self, record: Dict[str, Any]):
        """Append one record (numbers as floats, plus ``_time``)."""
        record = {k: (float(v) if hasattr(v, 'item') else v)
                  for k, v in record.items()}
        record['_time'] = time.time()
        try:
            with open(self.jsonl_path, 'a', encoding='utf-8') as f:
                f.write(json.dumps(record) + '\n')
        except OSError:
            pass
        if self._wandb is not None:
            self._wandb.log(record)
