"""Static FIFO batching over ``Engine`` (PyTorch counterpart of
``repro.serving.scheduler.StaticScheduler``; the SLO ``Scheduler`` is not
ported yet).

``StaticScheduler`` pads a fixed batch, runs every lane for max(n_tokens)
steps, then admits the next batch — head-of-line blocking by design, the
baseline the continuous engines are measured against.  ``Engine.generate``
applies ONE ``SamplingParams`` to the whole padded batch, so a batch
mixing sampling configs is rejected.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.sampling import SamplingParams


class StaticScheduler:
    def __init__(self, engine: Engine, batch_size: int, pad_id: int = 0):
        self.engine = engine
        self.batch_size = batch_size
        self.pad_id = pad_id
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}
        self._uid = 0

    def submit(self, prompt: np.ndarray, n_tokens: int,
               sampling: SamplingParams = SamplingParams()) -> int:
        self._uid += 1
        self.queue.append(Request(self._uid, np.asarray(prompt, np.int32),
                                  n_tokens, sampling))
        return self._uid

    def run_once(self) -> List[int]:
        """Serve one padded batch from the queue; returns completed uids."""
        if not self.queue:
            return []
        batch = self.queue[: self.batch_size]
        self.queue = self.queue[self.batch_size:]
        mixed = {r.sampling for r in batch}
        if len(mixed) > 1:
            raise ValueError(
                "StaticScheduler pads one batch and Engine.generate applies "
                f"a single SamplingParams to all of it, but this batch mixes "
                f"{len(mixed)} configs: {sorted(map(str, mixed))}. Submit "
                f"homogeneous batches or use a continuous engine (per-lane "
                f"sampling).")
        max_prompt = max(len(r.prompt) for r in batch)
        n_gen = max(r.n_tokens for r in batch)
        toks = np.full((self.batch_size, max_prompt), self.pad_id, np.int32)
        for i, r in enumerate(batch):
            toks[i, max_prompt - len(r.prompt):] = r.prompt   # left-pad
        res = self.engine.generate({"tokens": toks}, n_gen,
                                   sampling=batch[0].sampling)
        out = []
        for i, r in enumerate(batch):
            r.result = res.tokens[i, : r.n_tokens]
            self.done[r.uid] = r
            out.append(r.uid)
        return out

    def run(self) -> None:
        while self.queue:
            self.run_once()
