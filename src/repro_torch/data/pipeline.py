"""Deterministic synthetic token pipeline (host-sharded, prefetched);
the port of :mod:`repro.data.pipeline`, numpy only, the same batches
bit for bit.

Every batch is a pure function of (seed, step, process_index), so replay
after failure/restore is exact — the fault-tolerance contract the train
loop relies on. A background thread keeps ``prefetch`` batches ready.

Produces the batch dicts the models consume (tokens / patches / frames /
dec_tokens), matching the reference's ``launch.steps.batch_specs`` shapes.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.models.config import ModelConfig


class TokenPipeline:
    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0, process_index: int = 0,
                 process_count: int = 1, prefetch: int = 2):
        assert batch % process_count == 0
        self.cfg = cfg
        self.local_batch = batch // process_count
        self.seq_len = seq_len
        self.seed = seed
        self.process_index = process_index
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._cursor = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def batch_at(self, step: int) -> dict:
        """Pure: the batch for a given global step."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 97 + self.process_index)
        cfg = self.cfg
        b, s = self.local_batch, self.seq_len
        if cfg.is_encdec:
            return {
                "frames": rng.normal(size=(b, s, cfg.d_model)).astype(np.float32),
                "dec_tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            }
        if cfg.frontend == "vision":
            p = cfg.frontend_tokens
            return {
                "tokens": rng.integers(0, cfg.vocab_size, (b, s - p)).astype(np.int32),
                "patches": rng.normal(size=(b, p, cfg.d_model)).astype(np.float32),
            }
        return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}

    # -- prefetching iterator ---------------------------------------------
    def start(self, step: int = 0):
        self._cursor = step

        def work():
            s = step
            while not self._stop.is_set():
                self._q.put((s, self.batch_at(s)))
                s += 1

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return self

    def next(self) -> tuple[int, dict]:
        return self._q.get()

    def stop(self):
        self._stop.set()
        if self._thread:
            while not self._q.empty():
                self._q.get_nowait()
