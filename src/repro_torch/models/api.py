"""Family-dispatching model API — the decoder family so far.

    params    = api.init_params(cfg, seed, device="cuda")
    logits, _ = api.forward(params, cfg, tokens)
    loss, mx  = api.loss_fn(params, cfg, batch)     # batch: tokens, labels
    logits, c = api.prefill(params, cfg, tokens)
    logits, c = api.decode_step(params, cfg, c, tokens)
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


def _mod(cfg: ArchConfig):
    cfg.check_supported()
    return transformer


def init_params(cfg: ArchConfig, seed: int = 0, *, device="cuda") -> dict:
    return _mod(cfg).init_params(cfg, seed, device=device)


def forward(params, cfg: ArchConfig, tokens):
    return _mod(cfg).forward(params, cfg, tokens)


def loss_fn(params, cfg: ArchConfig, batch: dict, *, remat=False):
    return _mod(cfg).loss_fn(params, cfg, batch, remat=remat)


def init_cache(cfg: ArchConfig, batch: int, max_len: int = 0, *,
               device="cuda"):
    return _mod(cfg).init_cache(cfg, batch, max_len, device=device)


def prefill(params, cfg: ArchConfig, tokens, *, max_len: int | None = None,
            true_len=None):
    return _mod(cfg).prefill(params, cfg, tokens, max_len=max_len,
                             true_len=true_len)


def decode_step(params, cfg: ArchConfig, cache, tokens, active=None):
    return _mod(cfg).decode_step(params, cfg, cache, tokens, active)
