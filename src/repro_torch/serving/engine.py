"""Batched serving engine: continuous batching over recycled slots.

PyTorch port of ``repro.serving.engine``, control flow statement for
statement: requests are admitted into batch slots as they free up
(continuous batching: a long request does not stall the batch behind a
cohort drain), decoded step-locked as a batch, and retired individually.

Admission re-prefills the whole active set (prefix replay): the KV cache
is batch-global ([B] rows sharing one position counter), so recycling a
slot means replaying every live slot's prompt + generated suffix into a
fresh cache.

With a :class:`~repro_torch.serving.qos.ServingQos` fabric attached, every
prefill issues the prompt all-gather and every decode step the
tensor-parallel all-reduce as staged OCCL submits on the shared fabric;
the engine's stats gain the per-class latency digest.

One deliberate difference from the reference: the engine casts its
parameters to ``cfg.compute_dtype`` once, when it is built (and in
:meth:`ServingEngine.load_params`), and keeps only that copy, where the
reference keeps float32 and casts inside every jitted call.  The values are
the same (prefill and decode cast first anyway); at Llama-3-8B's width it
saves 32.1 GB of float32 parameters and a cast per decode step.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.state import resolve_device
from ..models import build_model
from ..tree import tree_map


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [S] int32
    max_new_tokens: int = 16
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, cfg: ArchConfig, *, batch_size: int = 4,
                 prompt_len: int = 32, max_len: int = 96, seed: int = 0,
                 qos=None, device=None):
        """``device``: where the model runs (``None``: ``cuda``, raising
        without a card)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        self.load_params(self.model.init(seed, self.device))
        self.B, self.S, self.max_len = batch_size, prompt_len, max_len
        self.queue: collections.deque[Request] = collections.deque()
        self.qos = qos
        self.stats = {"prefills": 0, "decode_steps": 0, "tokens": 0,
                      "admissions": 0}

    def load_params(self, params: dict) -> None:
        """Install a parameter tree (e.g. one carried across with
        ``models/convert.py``), cast to the compute dtype on the engine's
        device; the engine keeps only the cast copy."""
        cdt = getattr(torch, self.cfg.compute_dtype)
        self.params = None
        self.params = tree_map(lambda a: a.to(device=self.device, dtype=cdt),
                               params)

    def _prefill(self, params, batch):
        return self.model.prefill(params, batch, pad_to=self.max_len)

    def _decode(self, params, cache, toks):
        return self.model.decode_step(params, cache, toks)

    def submit(self, req: Request):
        self.queue.append(req)

    def _batchify(self, slots: list) -> dict:
        """Replay each live slot's prompt + generated suffix (newest
        ``S`` tokens) into the fixed [B, S] prefill shape; free slots
        stay zero rows.  vlm and encdec prefills get zero ``patches`` /
        ``frames`` (the reference's stub frontends)."""
        toks = np.zeros((self.B, self.S), np.int32)
        for i, r in enumerate(slots):
            if r is None:
                continue
            seq = np.asarray(r.prompt, np.int32)
            if r.out_tokens:
                seq = np.concatenate(
                    [seq, np.asarray(r.out_tokens, np.int32)])
            seq = seq[-self.S:]
            toks[i, :len(seq)] = seq
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        cfg = self.cfg
        zeros = lambda n: torch.zeros(
            (self.B, n, cfg.d_model), dtype=getattr(torch, cfg.compute_dtype),
            device=self.device)
        if cfg.family == "vlm":
            batch["patches"] = zeros(cfg.vis_tokens)
        if cfg.family == "encdec":
            batch["frames"] = zeros(cfg.enc_frames)
        return batch

    def run(self) -> list[Request]:
        """Drain the queue with continuous batching; returns completed
        requests in completion order.

        Invariant: ``stats["tokens"]`` equals ``sum(len(r.out_tokens))``
        over every request ever admitted: each token is counted once, at
        append time, including a request's final token on the step that
        marks it done.
        """
        finished: list[Request] = []
        active: list[Optional[Request]] = [None] * self.B
        cache = None
        toks = None
        while self.queue or any(r is not None for r in active):
            if self.queue and any(r is None for r in active):
                # Admission event: recycle every free slot, then replay
                # the whole active set through one prefill.
                for i in range(self.B):
                    if active[i] is None and self.queue:
                        req = self.queue.popleft()
                        self.stats["admissions"] += 1
                        if req.max_new_tokens <= 0:
                            req.done = True
                            finished.append(req)
                            continue
                        active[i] = req
                if not any(r is not None for r in active):
                    continue        # queue held only zero-token requests
                logits, cache = self._prefill(self.params,
                                              self._batchify(active))
                self.stats["prefills"] += 1
                if self.qos is not None:
                    self.qos.prefill_event()
                toks = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            # Append the batch's current tokens; count each token ONCE,
            # at append time, so the counter reconciles exactly with
            # out_tokens even on a request's final step.
            t_host = toks.cpu().numpy()
            for r, t in zip(active, t_host):
                if r is not None:
                    r.out_tokens.append(int(t))
                    self.stats["tokens"] += 1
                    if len(r.out_tokens) >= r.max_new_tokens:
                        r.done = True
            # Retire finished slots mid-flight: freed slots re-admit at
            # the top of the next iteration (continuous batching).
            for i, r in enumerate(active):
                if r is not None and r.done:
                    finished.append(r)
                    active[i] = None
            if not any(r is not None for r in active):
                continue
            if self.queue and any(r is None for r in active):
                continue            # admit (re-prefill) before decoding on
            logits, cache = self._decode(self.params, cache, toks)
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
            self.stats["decode_steps"] += 1
            if self.qos is not None:
                self.qos.decode_event()
        if self.qos is not None:
            self.stats["qos"] = self.qos.summary()
        return finished
