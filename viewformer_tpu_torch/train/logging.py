"""Training metric log (the port's own copy of viewformer_tpu/train/logging.py).

`metrics.jsonl` in the job dir is always written, one record a call:
{"step": n, "time": seconds since the logger opened, "<prefix>/<key>": value}.
TensorBoard and wandb are extra sinks, attached when their packages import."""
import json
import os
import time

import numpy as np


class MetricLogger:
    def __init__(self, job_dir, hparams=None, use_wandb=False):
        self.job_dir = job_dir
        os.makedirs(job_dir, exist_ok=True)
        self._jsonl = open(os.path.join(job_dir, 'metrics.jsonl'), 'a')
        self._tb = None
        self._wandb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir=job_dir)
        except ImportError:
            pass
        if use_wandb:
            try:
                import wandb
            except ImportError:
                pass
            else:
                wandb.init(config=hparams or {}, resume='allow', dir=job_dir)
                self._wandb = wandb
        if hparams and self._tb is not None:
            self._tb.add_text('hparams', json.dumps(hparams, default=str, indent=2), 0)
        self._start = time.time()

    def log(self, step, metrics, prefix='train'):
        record = {'step': int(step), 'time': round(time.time() - self._start, 3)}
        for k, v in metrics.items():
            try:
                record[f'{prefix}/{k}'] = float(np.asarray(v))
            except (TypeError, ValueError):
                continue
        self._jsonl.write(json.dumps(record) + '\n')
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in record.items():
                if k not in ('step', 'time'):
                    self._tb.add_scalar(k, v, int(step))
        if self._wandb is not None:
            self._wandb.log(record, step=int(step))

    def log_images(self, step, images, tag='images'):
        """images: uint8 [N, H, W, C], the first 8 logged to TensorBoard."""
        if self._tb is None:
            return
        images = np.asarray(images)
        for i, img in enumerate(images[:8]):
            self._tb.add_image(f'{tag}/{i}', img, int(step), dataformats='HWC')

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
