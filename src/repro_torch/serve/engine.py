"""Batched serving engine: prefill + greedy/temperature decode loop.

The port of the reference package's ``serve/engine.py`` for one device.
PyTorch runs eagerly, so the reference's ``jit`` of prefill and decode has
no counterpart.  ``mesh`` and ``shard_kv_seq`` (the sequence-sharded
long-context decode) belong to the multi-GPU slice and raise.
"""
from __future__ import annotations

import torch


class ServeEngine:
    def __init__(self, lm, params, max_len, mesh=None, shard_kv_seq=False):
        if mesh is not None or shard_kv_seq:
            raise NotImplementedError(
                "ServeEngine(mesh=..., shard_kv_seq=...) is not ported yet: "
                "it comes with the multi-GPU slice (ROADMAP Queue 1 #8)")
        self.lm = lm
        self.params = params
        self.max_len = max_len

    def prefill(self, batch):
        return self.lm.prefill(self.params, batch, self.max_len)

    def decode_step(self, cache, tokens, pos):
        return self.lm.decode_step(self.params, cache, tokens, pos)

    def generate(self, batch, steps, temperature=0.0, generator=None):
        """Greedy (or sampled, from ``generator``) generation after a prompt
        prefill.  Returns (B, steps) int32 token ids."""
        prompt_len = batch["inputs"].shape[1]
        prefix = self.lm.cfg.vision_tokens
        logits, cache = self.prefill(batch)
        tok = self._pick(logits, temperature, generator)
        toks = [tok]
        for i in range(steps - 1):
            logits, cache = self.decode_step(cache, tok[:, None],
                                             prefix + prompt_len + i)
            tok = self._pick(logits, temperature, generator)
            toks.append(tok)
        return torch.stack(toks, dim=1)

    @staticmethod
    def _pick(logits, temperature, generator=None):
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0] \
            .to(torch.int32)
