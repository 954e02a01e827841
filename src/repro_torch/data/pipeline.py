"""Deterministic synthetic data pipeline (the port's copy of
``repro.data.pipeline``; numpy only, so batches are identical to the
reference's).

Production-shaped: shard-aware (each DP rank draws only its shard),
checkpointable (the cursor is just the step number — restore = seek),
background prefetch (a thread keeps ``prefetch`` batches ready), and
deterministic across restarts/elastic resharding (batch content depends
only on (seed, step, global position), never on worker count).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from ..configs.base import ArchConfig, ShapeCell


class SyntheticPipeline:
    def __init__(self, cfg: ArchConfig, cell: ShapeCell, *, seed: int = 0,
                 shard_id: int = 0, n_shards: int = 1, prefetch: int = 2):
        assert cell.global_batch % n_shards == 0
        self.cfg, self.cell, self.seed = cfg, cell, seed
        self.shard_id, self.n_shards = shard_id, n_shards
        self.local_batch = cell.global_batch // n_shards
        self.step = 0
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- deterministic batch synthesis -----------------------------------
    def batch_at(self, step: int) -> dict:
        cfg, cell = self.cfg, self.cell
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + step) % (2**31 - 1))
        # draw the GLOBAL batch then slice our shard: elasticity-safe
        B, S = cell.global_batch, cell.seq_len
        lo = self.shard_id * self.local_batch
        hi = lo + self.local_batch
        out = {}
        if cfg.family == "vit":
            pat = rng.randn(B, cfg.vis_tokens, cfg.d_model).astype(np.float32)
            lab = rng.randint(0, cfg.vocab, size=(B,)).astype(np.int32)
            return {"patches": pat[lo:hi], "labels": lab[lo:hi]}
        text = S
        if cfg.family == "vlm":
            text = S - cfg.vis_tokens
            out["patches"] = rng.randn(
                B, cfg.vis_tokens, cfg.d_model).astype(np.float32)[lo:hi]
        if cfg.family == "encdec":
            out["frames"] = rng.randn(
                B, cfg.enc_frames, cfg.d_model).astype(np.float32)[lo:hi]
        toks = rng.randint(0, cfg.vocab, size=(B, text + 1)).astype(np.int32)
        out["tokens"] = toks[lo:hi, :-1]
        out["targets"] = toks[lo:hi, 1:]
        return out

    # -- iterator + prefetch ----------------------------------------------
    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            try:
                self._q.put(self.batch_at(step), timeout=0.1)
                step += 1
            except queue.Full:
                continue

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        while not self._q.empty():
            self._q.get_nowait()

    def __next__(self) -> dict:
        if self._thread is not None:
            b = self._q.get()
        else:
            b = self.batch_at(self.step)
        self.step += 1
        return b

    def __iter__(self) -> Iterator[dict]:
        return self

    # -- checkpointing ------------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, d: dict):
        was_running = self._thread is not None
        self.stop()
        self.step = int(d["step"])
        self.seed = int(d["seed"])
        if was_running:
            self.start()
