"""The route of a SLAY feature config (ROADMAP C-15), decided before any
launch from the kernels' limits, and the three routes against the JAX
package on the CPU.

``ops.attention_route`` reads Python copies of the kernels' shared-memory
formulas on the CPU; the copies are pinned here to values worked out by
hand from the C layouts (``csrc/feature_map.cu::fwd_layout``,
``bwd_layout_at``, ``csrc/slay_scan.cu::scan_layout``), and
``tests/test_torch_card.py`` holds them to the C entries on the card.

Parity: B = 1, L = 48 (not a multiple of the 256-token chunk), 2 q heads
over 1 kv head, fp32, inputs from ``np.random.default_rng``; the random
projections are the JAX draws moved across through ``convert``, never
re-drawn. The JAX side is ``repro.kernels.ops`` on its CPU path (jnp
features, ``la.causal_chunked``). Forward and the gradients of q, k, v,
the anchors and the omegas within 1e-5 of each one's largest |value|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as jfeat
from repro.core import slay as jslay
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import features as tfeat
from repro_torch.kernels import _build
from repro_torch.kernels import feature_map as tfm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import slay_fused as tfused
from repro_torch.kernels import slay_scan as tscan

torch.set_num_threads(1)    # small ops; the suite runs one process per core

# name: (feature config fields, dv)
GRID = {
    "slayformer": (dict(head_dim=64), 64),
    "c14_pd32_d32": (dict(head_dim=32, num_anchors=32, num_prf=32), 32),
    "r12": (dict(head_dim=64, num_quad_nodes=12), 64),
    "pd24": (dict(head_dim=64, num_anchors=4, num_prf=6), 64),
    "d128_pd32": (dict(head_dim=128, num_anchors=32, num_prf=32), 128),
    "rm_tensor": (dict(head_dim=64, poly_kind="rm"), 64),
}
F, T, P = tops.FUSED, tops.TWO_DISPATCH, tops.TORCH_PSI
# name: (attention without a gradient, with one; Ψ alone without, with).
# P·D = 24 needs the gradient off the fused kernels (K3 and K4 take P·D a
# multiple of 16) but not off B8, which takes any P·D; d = 128 with
# P = D = 32 fits B7 but not B8 (362,752 B).
WANT = {
    "slayformer": (F, F, T, T),
    "c14_pd32_d32": (T, T, T, T),
    "r12": (P, P, P, P),
    "pd24": (F, T, T, T),
    "d128_pd32": (T, P, T, P),
    "rm_tensor": (P, P, P, P),
}
C15 = ("r12", "pd24", "d128_pd32")


def _cfg(name):
    return tfeat.SlayFeatureConfig(**GRID[name][0])


@pytest.mark.parametrize("name", sorted(GRID))
def test_route_table_on_the_cpu(name):
    cfg, dv = _cfg(name), GRID[name][1]
    got = tuple(tops.attention_route(cfg, cfg.head_dim, w, grad, "cpu")
                for w in (dv, None) for grad in (False, True))
    assert got == WANT[name]


def test_fmap_smem_copy_pinned():
    # B7 (fwd_layout) at d = 64, P = 8, D = 16, R = 3 in fp32: two tiles
    # of 32 raw rows 2 x 8192, û 32 x 68 x 4 (ldu 68: 4 times an odd
    # number), the projections 24 x 68 x 4, φ 32 x 56 x 4, 96 chunks of
    # 16 B: 40,320. In bf16 the tiles halve and 48 chunks: 31,360.
    assert tfm.fmap_smem_bytes(64, 8, 16, 3, False) == 40320
    assert tfm.fmap_smem_bytes(64, 8, 16, 3, False, es=2) == 31360
    # B8 (bwd_layout_at) at the same shape, fp32, dΨ staged: projections
    # and dA/dΩ sums 2 x 6144, then 8 warps of 4 x 1792 (u 256 + dΨ 1536)
    # + 2 x 272 + 2 x 128 + 2 x 96 (register sums): 77,568.
    assert tfm.fmap_smem_bytes(64, 8, 16, 3, True) == 77568
    # d = 128, P = D = 32, R = 3: staged it would need 8 warps of
    # 4 x (512 + 12288) ...; unstaged 2 x 32768 + 8 x (4 x 512 + 2 x 656
    # + 2 x 256 + 2 x 256 + 64 x 128 x 4) = 362,752 > 232,448 (bf16:
    # 354,560), so B8 takes no gradient there.
    assert tfm.fmap_smem_bytes(128, 32, 32, 3, True) == 362752
    assert tfm.fmap_smem_bytes(128, 32, 32, 3, True, es=2) == 354560
    assert tfm.fmap_smem_bytes(128, 32, 32, 3, True) > _build.SMEM_LIMIT
    # C-14's P = D = 32 at d = 32 fits with dΨ unstaged: 104,704.
    assert tfm.fmap_smem_bytes(32, 32, 32, 3, True) == 104704


def test_scan_smem_copy_pinned():
    # scan_layout at dv = 64 in bf16 (es = 2), B5: carry 128 x 68, z 128,
    # Ψq and Ψk tiles 2 x 16 x 132, V 16 x 68, scores 2 x 16 x 20 floats
    # (14,784 x 4 = 59,136) + staging 16 x 256 x 2 + 16 x 128 = 10,240:
    # 69,376; B6a 71,296, B6b 83,328; fp32 79,616, 81,536, 97,664 (the
    # numbers of csrc/slay_scan.cu's header).
    for m in (384, 3072, 3 * 12 * 8 * 16):
        assert [tscan.scan_smem_bytes(m, 64, k, es=2) for k in range(3)] \
            == [69376, 71296, 83328]
        assert [tscan.scan_smem_bytes(m, 64, k) for k in range(3)] \
            == [79616, 81536, 97664]
    # One slice of at most 128 columns a block: Ψ in PyTorch ops at
    # d = 128, P = D = 32 (m = 3072) and dv = 128 fits as m = 128 does.
    assert tscan.scan_smem_bytes(3072, 128, 2) == 155008
    assert tscan.scan_smem_bytes(3072, 128, 2) == tscan.scan_smem_bytes(
        128, 128, 2)
    # A slice narrower than 128 is padded to 16 columns: m = 45 -> 48.
    assert tscan.scan_smem_bytes(45, 64, 0, es=2) == 31936


def test_fused_fits_reads_r_and_the_backward_limits():
    assert tfused.fused_fits(64, 64, 8, 16, 8, True, "cpu")
    assert not tfused.fused_fits(64, 64, 8, 16, 9, False, "cpu")
    assert tfused.fused_fits(64, 64, 4, 6, 3, False, "cpu")
    assert not tfused.fused_fits(64, 64, 4, 6, 3, True, "cpu")
    assert not tfused.fused_fits(60, 64, 8, 16, 3, True, "cpu")
    assert tfused.fused_fits(60, 64, 8, 16, 3, False, "cpu")
    assert tfm.fmap_fits(128, 32, 32, 3, False, "cpu")
    assert not tfm.fmap_fits(128, 32, 32, 3, True, "cpu")
    assert not tfm.fmap_fits(160, 8, 16, 3, True, "cpu")
    assert not tfm.fmap_fits(64, 8, 16, 9, False, "cpu")


def _refuse(what):
    def run(*args, **kwargs):
        raise AssertionError(f"{what} ran off its route")
    return run


@pytest.mark.parametrize("grad", [False, True], ids=["nograd", "grad"])
@pytest.mark.parametrize("name", C15)
def test_entry_points_run_only_their_route(name, grad, monkeypatch):
    # The wrappers of the kernels a route does not take raise if called.
    cfg, dv = _cfg(name), GRID[name][1]
    route = WANT[name][int(grad)]
    if route != F:
        monkeypatch.setattr(tfused, "fused_causal_attention",
                            _refuse("the fused kernel"))
    if route != T:
        monkeypatch.setattr(tfm, "feature_map", _refuse("the feature map"))
    rng = np.random.default_rng(5)
    p = tfeat.init_feature_params(cfg, torch.Generator().manual_seed(5),
                                  device="cpu")
    q, k = (torch.from_numpy(rng.normal(size=(1, 20, h, cfg.head_dim))
                             .astype(np.float32)) for h in (2, 1))
    v = torch.from_numpy(rng.normal(size=(1, 20, 1, dv)).astype(np.float32))
    q.requires_grad_(grad)
    y = tops.slay_fused_attention(q, k, v, p, cfg, chunk_size=16)
    assert y.shape == (1, 20, 2, dv)
    if grad:
        y.sum().backward()
        assert torch.isfinite(q.grad).all()
    monkeypatch.undo()
    if WANT[name][2 + int(grad)] != T:
        monkeypatch.setattr(tfm, "feature_map", _refuse("the feature map"))
    psi = tops.slay_features(q, p, cfg)
    assert psi.shape == (1, 20, 2, cfg.feature_dim)


def _pair(name, seed):
    kw = GRID[name][0]
    jcfg = jfeat.SlayFeatureConfig(**kw)
    tcfg = tfeat.SlayFeatureConfig(**kw)
    jp = jslay.slay_init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.params_from_numpy(jax.device_get(jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _near(got, want, frac):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0.0,
                               atol=frac * max(np.abs(want).max(), 1e-30))


def _inputs(name, seed):
    d, dv = GRID[name][0]["head_dim"], GRID[name][1]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, 48, 2, d)).astype(np.float32)
    k = rng.normal(size=(1, 48, 1, d)).astype(np.float32)
    v = rng.normal(size=(1, 48, 1, dv)).astype(np.float32)
    dy = rng.normal(size=(1, 48, 2, dv)).astype(np.float32)
    return q, k, v, dy


@pytest.mark.parametrize("name", C15)
def test_fused_attention_and_grads_match_jax(name):
    jcfg, tcfg, jp, tp = _pair(name, 11)
    q, k, v, dy = _inputs(name, 12)

    def jloss(q, k, v, a, w):
        y = jops.slay_fused_attention(q, k, v, dict(jp, anchors=a, omegas=w),
                                      jcfg)
        return jnp.sum(y * dy), y

    args = [jnp.asarray(x) for x in (q, k, v)] + [jp["anchors"], jp["omegas"]]
    (_, want_y), want = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*args)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    leaves += [tp["anchors"].clone().requires_grad_(True),
               tp["omegas"].clone().requires_grad_(True)]
    y = tops.slay_fused_attention(
        *leaves[:3], dict(tp, anchors=leaves[3], omegas=leaves[4]), tcfg)
    (y * torch.from_numpy(dy)).sum().backward()
    _near(y.detach(), want_y, 1e-5)
    for t, w in zip(leaves, want, strict=True):
        _near(t.grad, w, 1e-5)


@pytest.mark.parametrize("name", C15)
def test_features_and_grads_match_jax(name):
    jcfg, tcfg, jp, tp = _pair(name, 13)
    u = np.random.default_rng(14).normal(
        size=(1, 48, 2, jcfg.head_dim)).astype(np.float32)
    dpsi = np.random.default_rng(15).normal(
        size=(1, 48, 2, jcfg.feature_dim)).astype(np.float32)

    def jloss(u, a, w):
        psi = jops.slay_features(u, dict(jp, anchors=a, omegas=w), jcfg)
        return jnp.sum(psi * dpsi), psi

    (_, want_psi), want = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(u), jp["anchors"], jp["omegas"])
    leaves = [torch.from_numpy(u).requires_grad_(True),
              tp["anchors"].clone().requires_grad_(True),
              tp["omegas"].clone().requires_grad_(True)]
    psi = tops.slay_features(leaves[0],
                             dict(tp, anchors=leaves[1], omegas=leaves[2]),
                             tcfg)
    (psi * torch.from_numpy(dpsi)).sum().backward()
    _near(psi.detach(), want_psi, 1e-5)
    for t, w in zip(leaves, want, strict=True):
        _near(t.grad, w, 1e-5)
