"""Lockstep serving engine: one prefill per batch, then decode steps in
lockstep until every request finishes (``repro.serving.engine``'s
``ServingEngine``). The continuous-batching engine comes later (ROADMAP
Queue A item 11).

On the card every prefill layer runs the fused SLAY kernel and every
decode layer the decode-step kernel; the (S, z) cache is updated in place.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import api


@dataclasses.dataclass
class Request:
    """One generation request."""

    prompt: np.ndarray               # (Lp,) int32
    max_new_tokens: int = 32
    eos_id: int = -1                 # -1: never stop early

    def __post_init__(self):
        if np.asarray(self.prompt).size == 0:
            raise ValueError("empty prompt: a request must carry at least "
                             "one prompt token")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{self.max_new_tokens}")


def _to_device(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


class ServingEngine:
    """Lockstep engine. Batched ``generate`` left-pads prompts to a common
    length with token 0, so with mixed prompt lengths the pad tokens are
    visible to the model — the JAX engine's behaviour, kept for parity."""

    def __init__(self, cfg: ArchConfig, params: dict, *,
                 device: str | torch.device = "cuda", max_len: int = 4096):
        cfg.check_supported()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = _to_device(params, self.device)
        self.max_len = max_len

    @torch.inference_mode()
    def generate(self, requests: list[Request], *, temperature: float = 0.0,
                 seed: int = 0) -> list[np.ndarray]:
        """Run a batch of requests to completion.

        Returns one int32 array per request of its *actual* length: up to
        and including the EOS token when ``eos_id`` fires,
        ``max_new_tokens`` otherwise. Greedy is argmax; ``temperature > 0``
        samples from softmax(logits / temperature) with a ``torch.Generator``
        seeded by ``seed`` (not the JAX engine's bits).
        """
        B = len(requests)
        lp = max(len(r.prompt) for r in requests)
        over = max(lp + r.max_new_tokens for r in requests)
        if over > self.max_len:
            raise ValueError(f"prompt+max_new ({over}) exceeds "
                             f"max_len {self.max_len}")
        prompts = np.zeros((B, lp), np.int32)
        for i, r in enumerate(requests):
            prompts[i, lp - len(r.prompt):] = r.prompt
        tokens = torch.from_numpy(prompts).to(self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        logits, cache = api.prefill(self.params, self.cfg, tokens,
                                    max_len=self.max_len)
        max_new = max(r.max_new_tokens for r in requests)
        out = np.zeros((B, max_new), np.int32)
        lengths = np.zeros(B, np.int64)
        done = np.zeros(B, bool)
        tok = self._sample(logits, temperature, gen)
        for t in range(max_new):
            tok_np = tok[:, 0].cpu().numpy()
            for i, r in enumerate(requests):
                if done[i]:
                    continue
                out[i, t] = tok_np[i]
                lengths[i] += 1
                if t + 1 >= r.max_new_tokens or int(tok_np[i]) == r.eos_id:
                    done[i] = True
            if done.all():
                break
            logits, cache = api.decode_step(self.params, self.cfg, cache, tok)
            tok = self._sample(logits, temperature, gen)
        return [out[i, :lengths[i]] for i in range(B)]

    @staticmethod
    def _sample(logits, temperature: float, gen: torch.Generator):
        logits = logits[:, -1, :].float()
        if temperature <= 0.0:
            return torch.argmax(logits, -1).to(torch.int32)[:, None]
        probs = torch.softmax(logits / temperature, -1)
        return torch.multinomial(probs, 1, generator=gen).to(torch.int32)
