"""SLAY core: the paper's primary contribution in PyTorch.

Public API, as ``repro.core``'s:
    SlayConfig, slay_init, slay_attention, slay_cross_attention,
    slay_prefill_state, slay_decode_step, AttentionSpec; the modules
    quadrature, features, kernels (exact references), linear_attention
    (shared O(L) machinery) and baselines.

The names resolve from ``core.slay`` at first use: ``core.slay`` imports
the kernel wrappers, which import ``core.quadrature`` and
``core.features``, so an eager import here would be circular.
"""
__all__ = [
    "AttentionSpec", "SlayConfig", "slay_attention", "slay_cross_attention",
    "slay_decode_step", "slay_init", "slay_prefill_state",
]


def __getattr__(name: str):
    if name in __all__:
        from repro_torch.core import slay
        return getattr(slay, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
