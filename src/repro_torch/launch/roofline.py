"""Roofline accounting for one NVIDIA H100: the card's rates, the
``Roofline`` terms of a step, the model's useful FLOPs, and the least
time each SLAY kernel could take.

The counterpart of ``repro/launch/roofline.py`` with the H100's constants
in place of the TPU's. A ``Roofline`` is built from per-device counts that
its caller supplies:

    compute    = device_FLOPs      / 989e12 bf16 FLOP/s (dense tensor cores)
    memory     = device_HBM_bytes  / 3.35e12 B/s
    collective = device_wire_bytes / 450e9 B/s (one NVLink direction)

``model_flops_for`` gives MODEL_FLOPS = 6·N·D (train) or 2·N·D (prefill,
decode) with N the active parameters; ``roofline_fraction`` is the
useful-FLOP time over the largest of the three terms.

The per-device counts come from ``launch.cost``: a step traced under its
``CostCounter`` (on the ``meta`` device over a fake world in
``launch.dryrun``) gives a ``CostTotals``, and :func:`from_counts` builds
the ``Roofline`` from it, the counterpart of the reference's
``from_compiled``, which parses XLA's per-device HLO;
:func:`extract_cost` is the counterpart of its ``extract_cost``.

The kernel bounds (``k1_bound`` ... ``scan_bounds``) count the fewest
operations and bytes each kernel's function needs at given shapes; each
returns ``(bound_ms, bound_by, n_ops, bytes)``, ``bound_by`` being
``"operations"`` or ``"bytes"``. ``chip_smoke.py`` prints them beside the
kernels' times.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM5 data sheet, dense rates (no sparsity) at its 700 W limit.
HBM_BYTES_PER_S = 3.35e12        # HBM3, 3.35 TB/s
FP32_FLOP_PER_S = 67e12          # fp32 outside the tensor cores
TF32_FLOP_PER_S = 495e12         # TF32 tensor cores
BF16_FLOP_PER_S = 989e12         # bf16 tensor cores
NVLINK_BYTES_PER_S = 450e9       # NVLink 4: 900 GB/s both directions
HBM_PER_CARD = 80e9              # 80 GB


@dataclasses.dataclass
class Roofline:
    """All byte and FLOP quantities are per device; ``model_flops`` is
    global."""

    flops: float
    hbm_bytes: float
    coll_bytes: float
    chips: int
    model_flops: float
    coll_by_kind: dict = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops / BF16_FLOP_PER_S

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BYTES_PER_S

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BYTES_PER_S

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS over the FLOPs all devices execute."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def t_useful(self) -> float:
        return self.model_flops / (self.chips * BF16_FLOP_PER_S)

    @property
    def roofline_fraction(self) -> float:
        """The achievable MFU bound: useful-FLOP time over the bound step
        time."""
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        return self.t_useful / bound if bound else 0.0

    def report(self) -> dict:
        return {
            "device_flops": self.flops,
            "device_hbm_bytes": self.hbm_bytes,
            "device_coll_wire_bytes": self.coll_bytes,
            "coll_by_kind": {k: float(v)
                             for k, v in self.coll_by_kind.items()},
            "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flop_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def from_counts(totals, chips: int, model_flops: float) -> Roofline:
    """The roofline terms of a per-device ``launch.cost.CostTotals``."""
    return Roofline(
        flops=totals.flops, hbm_bytes=totals.hbm_bytes,
        coll_bytes=totals.coll_wire_bytes, chips=chips,
        model_flops=model_flops, coll_by_kind=dict(totals.coll_by_kind))


def extract_cost(totals) -> tuple[float, float]:
    """(flops, HBM bytes) of a ``launch.cost.CostTotals``. The reference's
    reads XLA's ``cost_analysis()``, which counts a loop body once; the
    counter counts every op it sees, so here it agrees with
    :func:`from_counts`."""
    return float(totals.flops), float(totals.hbm_bytes)


def model_flops_for(cfg, cell) -> float:
    """6·N·D with N the active parameters and D the tokens of the step:
    train counts forward and backward (6ND), prefill the forward only
    (2ND), decode one token a sequence (2ND, D = batch)."""
    n = cfg.active_param_count
    if cell.mode == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.mode == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch


# -- the kernels' bounds: least time the card could take for the same work
#
# The bounds count the fewest operations the function needs. The causal sum
# is folded into the carried state one token at a time, each token added
# before its own row reads the state, so no intra-tile (tril) term remains:
# what is left per token is the Ψ map, its VJP where it is differentiated,
# and the state terms at 2·m·dv each. The kernels walk 16-token tiles and do
# more work than this.


def _bound(n_ops, nbytes):
    """(bound_ms, bound_by, n_ops, bytes): every operation on the fp32
    pipes, every byte at the HBM rate, the larger of the two."""
    t_ops = n_ops / FP32_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", n_ops, nbytes
    return t_bytes, "bytes", n_ops, nbytes


def _psi_ops(d, P, D, R):
    """fp32 operations of Ψ for one row (normalize, projections, φ_p, φ_e,
    Kronecker), and of its VJP (dpa, dpw, dû, dA/dΩ sums, du)."""
    m = R * P * D
    fwd = 3 * d + 2 * d * (P + D) + 2 * P + 4 * R * D + 2 * m
    bwd = 6 * m + 3 * R * D + 3 * P + 4 * (P + D) * d + 4 * d
    return fwd, bwd


def _tc_bound(bound, state):
    """``bound`` (from ``_bound``: every operation on the fp32 pipes) with
    ``state`` of its operations, the state products, on the tensor cores
    in 3xTF32, three TF32 products each (495/3 TFLOP/s), as the kernels
    run them; the rest stays on the fp32 pipes."""
    _, _, n_ops, nbytes = bound
    t_ops = (state / (TF32_FLOP_PER_S / 3)
             + (n_ops - state) / FP32_FLOP_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if t_ops >= t_bytes:
        return t_ops, "operations", n_ops, nbytes
    return t_bytes, "bytes", n_ops, nbytes


def k1_bound(bh, bk, L, d, dv, P, D, R, es):
    """The fused forward K1. Operations count the Ψ map once per q row and
    once per kv row, the state read-out (2·m·dv + 2m per q row, then
    y/den) and update (2·m·dv + m per kv row), all on the fp32 pipes."""
    m = R * P * D
    psi, _ = _psi_ops(d, P, D, R)
    per_q = psi + 2 * m * dv + 2 * m + dv
    per_kv = psi + 2 * m * dv + m
    n_ops = bh * L * per_q + bk * L * per_kv
    nbytes = (bh * L * (d + dv) * es + bk * L * (d + dv) * es + bh * L * 4
              + (P + D) * d * 4)
    return _bound(n_ops, nbytes)


def k1_tc_bound(bh, bk, L, d, dv, P, D, R, es):
    """K1's bound with the read-out Ψq S (per q row) and the update Ψkᵀ V
    (per kv row), 2·m·dv operations each, on the tensor cores
    (``_tc_bound``), as K1 runs them; ``k1_bound`` stays the all-fp32
    figure."""
    return _tc_bound(k1_bound(bh, bk, L, d, dv, P, D, R, es),
                     (bh + bk) * L * 2 * R * P * D * dv)


def k2_bound(bh, bk, bk_active, m, dv, qes, ves):
    """One decode step K2 over the bk_active of bk kv rows that are
    active: their state read and write-back, features and v, the
    G = bh / bk q rows of each, and y written for all bh q rows (zero on
    drained ones)."""
    rows_q = bk_active * (bh // bk)
    nbytes = (2 * bk_active * (m * dv + m) * 4 + (rows_q + bk_active) * m * qes
              + bk_active * dv * ves + bh * dv * ves)
    n_ops = bk_active * (2 * m * dv + m) + rows_q * (2 * m * dv + 2 * m + dv)
    return _bound(n_ops, nbytes)


def bwd_bounds(bh, bk, L, d, dv, P, D, R, es):
    """{kernel: bound} of K3 and K4. Each counts Ψ once per q row and once
    per kv row and its VJP once per row it differentiates; the cotangents
    G, h (3·dv); the state terms (K3: dΨq = G Sᵀ + h zᵀ and the (S, z)
    update; K4, per q-head row: dΨk = V dSᵀ + dz, dV = Ψk dS and the
    (dS, dz) update), each token in the state before its own row reads
    it. Bytes: q, k, v, dy, y, den read once, the kernel's outputs written
    once."""
    m = R * P * D
    psi, psi_b = _psi_ops(d, P, D, R)
    k3_q = psi + psi_b + 3 * dv + 2 * m * dv + 2 * m
    k3_kv = psi + 2 * m * dv + m
    k4_q = psi + psi_b + 3 * dv + 3 * (2 * m * dv) + 3 * m
    k4_kv = psi
    read = (bh * L * (d + 2 * dv) * es + bk * L * (d + dv) * es + bh * L * 4
            + (P + D) * d * 4)
    partials = bh * (P + D) * d * 4
    return {
        "slay_fused_bwd_q": _bound(bh * L * k3_q + bk * L * k3_kv,
                                   read + bh * L * d * es + partials),
        "slay_fused_bwd_kv": _bound(bh * L * k4_q + bk * L * k4_kv,
                                    read + bh * L * (d + dv) * es + partials),
    }


def bwd_tc_bounds(bh, bk, L, d, dv, P, D, R, es):
    """{kernel: bound} of K3 and K4 with the work of ``bwd_bounds`` at the
    rates of the units that the kernels run it on (``_tc_bound``): the
    state products (2·m·dv operations per term and token, the whole of
    the G Sᵀ, Ψk dS, V dSᵀ and carry-update work, which the kernels split
    into tile products and state products) on the tensor cores. These are
    the kernels' rows' bounds; ``bwd_bounds`` (everything on the fp32
    pipes) stays the figure that compares with earlier designs."""
    st = 2 * R * P * D * dv
    state = {"slay_fused_bwd_q": (bh + bk) * L * st,
             "slay_fused_bwd_kv": bh * L * 3 * st}
    return {name: _tc_bound(b, state[name]) for name, b in
            bwd_bounds(bh, bk, L, d, dv, P, D, R, es).items()}


def feature_map_bounds(n, d, P, D, R, es):
    """{kernel: bound} of B7 and B8 over n tokens. B7: the Ψ map per
    token; u and the projections read, Ψ written. B8: the Ψ map and its
    VJP per token; u, dΨ and the projections read, du and one dA/dΩ
    written. The per-block dA/dΩ partials that B8's grid writes and the
    wrapper sums are overhead of its tiling, not part of the function, so
    they are not counted."""
    m = R * P * D
    psi, psi_b = _psi_ops(d, P, D, R)
    proj = (P + D) * d * 4
    return {
        "feature_map_fwd": _bound(n * psi, n * (d + m) * es + proj),
        "feature_map_bwd": _bound(n * (psi + psi_b),
                                  n * (2 * d + m) * es + 2 * proj),
    }


def scan_bounds(bh, bk, L, m, dv, es):
    """{kernel: bound} of B5, B6a and B6b: the state terms of ``k1_bound``
    and ``bwd_bounds`` without the Ψ map and its VJP. Bytes: each
    kernel's inputs read once (B6a reads no Ψq), its outputs written
    once."""
    st = 2 * m * dv
    den = bh * L * 4
    return {
        "slay_scan_fwd": _bound(
            bh * L * (st + 2 * m + dv) + bk * L * (st + m),
            (bh + bk) * L * m * es + bk * L * dv * es + bh * L * dv * es
            + den),
        "slay_scan_bwd_q": _bound(
            bh * L * (3 * dv + st + 2 * m) + bk * L * (st + m),
            bk * L * (m + dv) * es + 2 * bh * L * dv * es + den
            + bh * L * m * es),
        "slay_scan_bwd_kv": _bound(
            bh * L * (3 * dv + 3 * st + 3 * m),
            bh * L * (m + 2 * dv) * es + bk * L * (m + dv) * es + den
            + bh * L * (m + dv) * es),
    }


def scan_tc_bounds(bh, bk, L, m, dv, es):
    """{kernel: bound} of B5, B6a and B6b with their state products on the
    tensor cores (``_tc_bound``), as the kernels run them: B5's read-out
    Ψq S and B6a's G Sᵀ (per q row) and their update Ψkᵀ V (per kv row),
    2·m·dv operations each, as ``k1_tc_bound`` counts K1's; B6b's three
    state terms per q-head row (Ψk dS, V dSᵀ and the (dS, dz) update).
    ``scan_bounds`` stays the all-fp32 figure."""
    st = 2 * m * dv
    state = {"slay_scan_fwd": (bh + bk) * L * st,
             "slay_scan_bwd_q": (bh + bk) * L * st,
             "slay_scan_bwd_kv": bh * L * 3 * st}
    return {name: _tc_bound(b, state[name]) for name, b in
            scan_bounds(bh, bk, L, m, dv, es).items()}
