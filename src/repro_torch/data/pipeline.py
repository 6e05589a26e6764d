"""Deterministic synthetic data pipeline.

The port of the reference package's ``data/pipeline.py``: the batches are
made in numpy exactly as the reference makes them (so both packages see
the same tokens for a seed and step) and become CPU tensors at the edge.

Restart-exactness: batch ``i`` is a pure function of ``(seed, step)``.
The token stream is an order-1 Markov language with a fixed random
transition table and 5% noise, so small models show a decreasing loss.
"""
from __future__ import annotations

import numpy as np
import torch


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, branch: int = 4):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        rng = np.random.default_rng(seed)
        # Each token has `branch` likely successors → H ≈ log(branch).
        self.succ = rng.integers(0, vocab_size,
                                 (vocab_size, branch)).astype(np.int32)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        b, s = self.batch, self.seq
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, b)
        choices = rng.integers(0, self.succ.shape[1], (b, s))
        noise = rng.random((b, s)) < 0.05
        rand_tok = rng.integers(0, self.vocab, (b, s))
        for t in range(s):
            nxt = self.succ[toks[:, t], choices[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return {
            "inputs": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])),
            "labels": torch.from_numpy(np.ascontiguousarray(toks[:, 1:])),
        }


def add_modality_stubs(batch, cfg, step=0, seed=0):
    """Attach stub frame/patch embeddings for audio/vlm archs."""
    rng = np.random.default_rng((seed, step, 7))
    b = batch["inputs"].shape[0]
    if cfg.vision_tokens:
        batch["patches"] = torch.from_numpy(
            rng.normal(size=(b, cfg.vision_tokens, cfg.vision_embed_dim))
            .astype(np.float32))
    if cfg.encoder_layers:
        batch["frames"] = torch.from_numpy(
            rng.normal(size=(b, cfg.encoder_seq, cfg.d_model))
            .astype(np.float32))
    return batch
