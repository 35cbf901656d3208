"""Model-layout wrappers around the kernels.

Model code calls these. They translate between the model's
(..., L, H, feat) layout and the kernels' head-major (BH, L, feat) layout
and zero-pad ragged lengths to chunk multiples (zero features add nothing
to the running state, as in ``core.linear_attention``). Kernel or plain
version is chosen by the tensors' device inside the kernel wrappers: the
kernels on CUDA tensors, their meta branches on ``meta`` tensors (a dry
run: outputs allocated, the launch recorded, nothing computed), the plain
versions on CPU tensors; any other device raises.

Each entry also takes DTensors (a sharded model, ``distributed.sharding``):
it runs on every rank's own block through ``local_map``, batch over the
rules' ``act_batch`` axes and heads over ``act_heads``'s, the random
projections replicated, so the kernels only ever see local tensors (their
launch wrappers raise ``TypeError`` on a DTensor).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.core import features as core_features
from repro_torch.core.features import SlayFeatureConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import decode_step as _dk
from repro_torch.kernels import feature_map as _fm
from repro_torch.kernels import slay_fused as _fused
from repro_torch.kernels import slay_scan as _scan


def _headmajor_call(kernel_fn, q, k, v, *, chunk_size: int):
    """Run a head-major (BH, L, feat) kernel from the model layout.

    q (..., L, H, dq), k (..., L, Hkv, dk), v (..., L, Hkv, dv)
    -> (..., L, H, dv). Zero-pads ragged L to a chunk multiple and maps q
    heads group-major so q row i reads kv row i // g.
    """
    *lead, L, H, dq = q.shape
    hkv, dk, dv = k.shape[-2], k.shape[-1], v.shape[-1]
    g = H // hkv
    b = 1
    for x in lead:
        b *= x
    pad = (-L) % chunk_size
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
    Lp = L + pad
    qh = (q.reshape(b, Lp, hkv, g, dq).permute(0, 2, 3, 1, 4)
          .reshape(b * hkv * g, Lp, dq))
    kh = k.reshape(b, Lp, hkv, dk).transpose(1, 2).reshape(b * hkv, Lp, dk)
    vh = v.reshape(b, Lp, hkv, dv).transpose(1, 2).reshape(b * hkv, Lp, dv)
    yh = kernel_fn(qh.contiguous(), kh.contiguous(), vh.contiguous())
    y = (yh.reshape(b, hkv, g, Lp, dv).permute(0, 3, 1, 2, 4)
         .reshape(*lead, Lp, H, dv))
    return y[..., :L, :, :] if pad else y


def _target(x: DTensor, logical: tuple) -> tuple:
    """x's placements by the active rules (the reference's constraint on
    the kernel's operands): batch over data, heads over model."""
    mesh = x.device_mesh
    rules = (shd._ACTIVATION_CTX[-1][1] if shd._ACTIVATION_CTX
             else shd.DEFAULT_RULES)
    spec = shd.partition_spec(mesh, rules, tuple(x.shape), logical)
    return shd.placements(mesh, spec, x.dim())


def _head_block(mesh, pl: tuple, dim: int, n: int) -> tuple[int, int]:
    """(first index, count) of this rank's block of dim ``dim`` (size n)
    under placements ``pl``, split in mesh-dim order as DTensor splits."""
    off, size = 0, n
    for j, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == dim:
            size //= mesh.size(j)
            off += mesh.get_local_rank(j) * size
    return off, size


def _const(t):
    """A replicated constant (the random projections) for ``local_map``."""
    return tuple(Replicate() for _ in range(t.device_mesh.ndim)) \
        if isinstance(t, DTensor) else None


def _sharded_heads(run, q, k, v, *consts, kv_state: tuple = ()):
    """``run(q, k, v, *consts, *kv_state)`` on each rank's block of the
    DTensors q (B, ..., H, f), k and v (B, ..., Hkv, f): batch dim 0 over
    the ``act_batch`` axes, the head dim (-2; -3 for ``kv_state``'s
    (B, Hkv, m[, dv]) leaves) over ``act_heads``'s. Where ``kv_heads``
    falls back to replicated while q's heads shard (Hkv does not divide
    the model axis), each rank takes the kv heads its own q heads read,
    ``h // (H / Hkv)`` as in the unsharded call, and their gradient is a
    partial sum over the ranks that share them; with a decode state,
    which is then replicated too and updated in place, each rank takes
    every q head instead (q's heads gathered) and updates all its kv
    heads, so the replicas stay equal, and the output's heads come back
    whole."""
    mesh = q.device_mesh
    nd, hd = q.dim(), q.dim() - 2
    lead = ("act_batch",) + (None,) * (nd - 3)
    if nd >= 4:                            # (B, ..., L, H, f): L is seq
        lead = lead[:-1] + ("act_seq",)
    ax = lead + ("act_heads", None)
    qpl, kpl, vpl = (_target(x, ax) for x in (q, k, v))
    spl = tuple(_target(x, ("act_batch", "act_heads",
                            *(None,) * (x.dim() - 2))[:x.dim()])
                for x in kv_state)
    H, hkv = q.shape[hd], k.shape[hd]
    g = H // hkv
    split = tuple(isinstance(qp, Shard) and qp.dim == hd
                  and not (isinstance(kp, Shard) and kp.dim == hd)
                  for qp, kp in zip(qpl, kpl))
    if kv_state:
        qpl = tuple(Replicate() if s else p for s, p in zip(split, qpl))
        split = (False,) * len(split)
    off, hl = _head_block(mesh, qpl, hd, H)
    if any(split) and hl % g and g % hl:
        raise ValueError(f"q heads {H} over kv heads {hkv}: a rank's block "
                         f"of {hl} q heads straddles kv heads")
    kgrad = tuple(Partial() if s else p for s, p in zip(split, kpl))
    vgrad = tuple(Partial() if s else p for s, p in zip(split, vpl))

    def local(ql, kl, vl, *rest):
        if any(split):                     # this rank's kv heads
            lo, n = off // g, max(hl // g, 1)
            kl, vl = kl.narrow(hd, lo, n), vl.narrow(hd, lo, n)
        return run(ql, kl, vl, *rest)

    cpl = tuple(_const(c) for c in consts)
    # local_map reads a tuple as one placement list per output.
    out = list(qpl) if not kv_state else tuple(map(list, (qpl, *spl[:2])))
    return local_map(
        local, out_placements=out,
        in_placements=(qpl, kpl, vpl, *cpl, *spl),
        in_grad_placements=(qpl, kgrad, vgrad, *cpl, *spl),
        device_mesh=mesh, redistribute_inputs=True)(q, k, v, *consts,
                                                    *kv_state)


def slay_causal_attention(qf: torch.Tensor, kf: torch.Tensor,
                          v: torch.Tensor, *, chunk_size: int = 256,
                          delta: float = 1e-6) -> torch.Tensor:
    """Causal linear attention on precomputed features (the scan of the
    two-dispatch path).

    qf (..., L, H, m), kf (..., L, Hkv, m), v (..., L, Hkv, dv)
    -> (..., L, H, dv). Ragged L is zero-padded (zero features add
    nothing to the running state).
    """
    if isinstance(qf, DTensor):
        return _sharded_heads(
            lambda a, b, c: slay_causal_attention(
                a, b, c, chunk_size=chunk_size, delta=delta), qf, kf, v)
    return _headmajor_call(
        lambda qh, kh, vh: _scan.causal_linear_attention(
            qh, kh, vh, chunk_size=chunk_size, delta=delta),
        qf, kf, v, chunk_size=chunk_size)


# The three routes of a SLAY feature config (:func:`attention_route`).
FUSED = "fused"                # K1; K3, K4 for the gradient
TWO_DISPATCH = "two_dispatch"  # B7 then B5; B6a, B6b then B8
TORCH_PSI = "torch_psi"        # Ψ in PyTorch ops, then B5; B6a, B6b


def attention_route(cfg: SlayFeatureConfig, d: int, dv: int | None,
                    grad: bool, device_type: str) -> str:
    """The route of a SLAY feature config, decided before any launch from
    the config, the head dims and whether a gradient will be taken:

    * :data:`FUSED` (``dv`` given): anchor + tensor that K1 takes, and
      K3/K4 when ``grad`` (``slay_fused.fused_fits``: R, shared memory,
      the backward's head dim and P·D);
    * :data:`TWO_DISPATCH`: anchor + tensor that B7 takes, and B8 when
      ``grad`` (``feature_map.fmap_fits``: R, shared memory, B8's head
      dim), Ψ written to device memory for the scan;
    * :data:`TORCH_PSI`: every other config. Ψ comes from
      :func:`repro_torch.core.features.slay_features` (PyTorch ops in
      fp32, differentiated by autograd), cast to the activation dtype,
      and the scan B5 (B6a, B6b) takes any m.

    ``dv`` None asks for Ψ alone (:func:`slay_features`): B7 or PyTorch
    ops. Each limit is read from the kernels' C entries on the card and
    from their Python copies on the CPU, which equal them
    (``tests/test_torch_card.py``), so both devices route alike and no
    routed call reaches a launch wrapper's guard. Launches nothing."""
    if not cfg.kernelizable:
        return TORCH_PSI
    P, D, R = cfg.num_anchors, cfg.num_prf, cfg.num_quad_nodes
    if dv is not None and _fused.fused_fits(d, dv, P, D, R, grad,
                                            device_type):
        return FUSED
    if _fm.fmap_fits(d, P, D, R, grad, device_type):
        return TWO_DISPATCH
    return TORCH_PSI


def _grad_taken(*tensors) -> bool:
    """Whether autograd will differentiate a call on these tensors (None
    entries ignored): grad mode is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _psi(u: torch.Tensor, params: dict, cfg: SlayFeatureConfig,
         route: str, dtype: torch.dtype) -> torch.Tensor:
    """Ψ(u) (..., m) in ``dtype`` by ``route``: B7 (its plain twin on the
    CPU) in u's dtype, or PyTorch ops in fp32, rounded once."""
    if route == TORCH_PSI:
        return core_features.slay_features(u, params, cfg).to(dtype)
    *lead, d = u.shape
    psi = _fm.feature_map(u.reshape(-1, d).contiguous(), params["anchors"],
                          params["omegas"], cfg)
    return psi.reshape(*lead, cfg.feature_dim).to(dtype)


def slay_features(u: torch.Tensor, params: dict,
                  cfg: SlayFeatureConfig) -> torch.Tensor:
    """Ψ(u) over the trailing dim: u (..., d) -> (..., m) in u's dtype.

    :func:`attention_route` with ``dv`` None picks the route, a gradient
    counted as taken when grad mode is on and u, the anchors or the
    omegas require grad: B7 (its plain twin on the CPU, B8 for the
    gradient), which takes any token count, so nothing is padded and the
    result equals the JAX entry's pad-and-slice; or
    :func:`repro_torch.core.features.slay_features` (PyTorch ops, fp32,
    cast to u's dtype), as the JAX entry takes its jnp reference.
    ``core.slay.slay_decode_step`` takes its Ψ of q and k before K2 from
    here too.
    """
    if isinstance(u, DTensor):
        names = sorted(params)
        pl = tuple(u.placements)
        if any(isinstance(p, Shard) and p.dim == u.dim() - 1 for p in pl):
            raise ValueError("slay_features: the feature dim is sharded")
        return local_map(
            lambda ul, *cs: slay_features(ul, dict(zip(names, cs)), cfg),
            out_placements=list(pl),
            in_placements=(pl, *(_const(params[n]) for n in names)),
            device_mesh=u.device_mesh)(u, *(params[n] for n in names))
    grad = _grad_taken(u, params.get("anchors"), params.get("omegas"))
    route = attention_route(cfg, u.shape[-1], None, grad, u.device.type)
    return _psi(u, params, cfg, route, u.dtype)


def slay_fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         params: dict, cfg: SlayFeatureConfig, *,
                         chunk_size: int = 256,
                         delta: float = 1e-6) -> torch.Tensor:
    """End-to-end SLAY causal attention on **raw** q/k.

    q (..., L, H, d), k (..., L, Hkv, d), v (..., L, Hkv, dv)
    -> (..., L, H, dv); ragged L is zero-padded. :func:`attention_route`
    picks one of three routes before any launch, a gradient counted as
    taken when grad mode is on and q, k, v, the anchors or the omegas
    require grad; the backward runs the route its forward took:

    * fused: K1, Ψ computed inside it (its fp32 plain twin on the CPU),
      K3 and K4 for the gradient;
    * two-dispatch: B7 then B5 forward, B6a/B6b then B8 backward; the scan
      tiles the feature axis in slices of 128 and so takes any m (Table
      2's P = D = 32 at d = 32);
    * PyTorch Ψ (every other poly kind or fusion, and anchor + tensor
      configs the feature-map kernels refuse: R > 8, or B8 at d = 128
      with P = D = 32): Ψ from
      :func:`repro_torch.core.features.slay_features` cast to v's dtype,
      differentiated by autograd, then B5 (B6a/B6b for its gradient). The
      JAX package computes these with jnp features and
      ``la.causal_chunked`` (or its Pallas scan); the port always runs the
      hand-written scan, the same function.
    """
    if isinstance(q, DTensor):
        names = sorted(params)

        def block(ql, kl, vl, *cs):
            return slay_fused_attention(ql, kl, vl, dict(zip(names, cs)),
                                        cfg, chunk_size=chunk_size,
                                        delta=delta)

        return _sharded_heads(block, q, k, v, *(params[n] for n in names))
    grad = _grad_taken(q, k, v, params.get("anchors"), params.get("omegas"))
    route = attention_route(cfg, q.shape[-1], v.shape[-1], grad,
                            q.device.type)
    if route != FUSED:
        qf = _psi(q, params, cfg, route, v.dtype)
        kf = _psi(k, params, cfg, route, v.dtype)
        return slay_causal_attention(qf, kf, v, chunk_size=chunk_size,
                                     delta=delta)

    def run(qh, kh, vh):
        y, _den = _fused.fused_causal_attention(
            qh, kh, vh, params["anchors"], params["omegas"], cfg,
            chunk_size=chunk_size, delta=delta)
        return y

    return _headmajor_call(run, q, k, v, chunk_size=chunk_size)


def decode_linear_step(qf: torch.Tensor, kf: torch.Tensor, v: torch.Tensor,
                       s: torch.Tensor, z: torch.Tensor,
                       active: torch.Tensor | None = None, *,
                       delta: float = 1e-6):
    """One-token decode step from the *model* layout.

    qf (B, H, m), kf (B, Hkv, m), v (B, Hkv, dv), s (B, Hkv, m, dv) fp32,
    z (B, Hkv, m) fp32 -> (y (B, H, dv), s', z'). The whole batch is one
    kernel launch over B·Hkv kv rows; s and z must be contiguous and are
    updated in place. ``active`` (B,) masks continuous-batching pool rows.
    """
    if isinstance(qf, DTensor):
        # The active mask and the states shard with the batch; the states
        # are each rank's own tensors, updated in place.
        def block(ql, kl, vl, sl, zl, *al):
            y, _, _ = decode_linear_step(ql, kl, vl, sl, zl,
                                         al[0] if al else None, delta=delta)
            return y, sl, zl

        if active is not None and not isinstance(active, DTensor):
            # A plain mask is the same on every rank (the engine's control
            # vector): a replicated value.
            active = DTensor.from_local(
                active, qf.device_mesh,
                [Replicate()] * qf.device_mesh.ndim, run_check=False)
        state = (s, z) if active is None else (s, z, active)
        return _sharded_heads(block, qf, kf, v, kv_state=state)[:3]
    B, H, m = qf.shape
    hkv, dv = kf.shape[-2], v.shape[-1]
    g = H // hkv
    ah = None
    if active is not None:
        ah = (active.to(torch.int32)[:, None].expand(B, hkv)
              .reshape(B * hkv).contiguous())
    y, _s, _z = _dk.decode_linear_attention(
        qf.reshape(B * hkv * g, m).contiguous(),
        kf.reshape(B * hkv, m).contiguous(),
        v.reshape(B * hkv, dv).contiguous(),
        s.view(B * hkv, m, dv), z.view(B * hkv, m), ah, delta=delta)
    return y.reshape(B, H, dv), s, z
