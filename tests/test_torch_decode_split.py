"""K2's arithmetic, as the cluster design of ``csrc/decode_step.cu`` runs it.

K2 splits each kv row's m feature rows into C slices (``decode_slices``
there: C = min(8, ceil(m / 16)) blocks of ceil(m / C) rows, the last one
ragged), one block of a thread-block cluster each. A block updates its
slice of the state, S' = S + Ψkᵀv and z' = z + Ψk with the arithmetic of
the one-block design, and forms its partial numerators Ψq_g·S'_slice and
denominators Ψq_g·z'_slice; rank 0 adds the C partials in rank order and
divides. This file replays that order on the CPU with seeded numpy inputs
and holds it against the JAX package's Pallas decode kernel in interpret
mode and against the port's plain version:

- y: fp32 on both sides, differing only in the order of the sums over m
  (slices then ranks against one sum), so to 1e-5 of its largest
  magnitude, 1e-5 relative being the card's own check (``K2_YTOL`` in
  ``chip_smoke.py``) and far above fp32's rounding of a few hundred
  terms;
- S' and z': one product and one add per element on every side, so equal
  to the port's plain version bit for bit, and to the Pallas kernel to
  1e-6 relative (XLA may contract the product and the add into one FMA).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_step as jdecode
from repro_torch.kernels import decode_step as tdecode

DELTA = 1e-6


def decode_slices(m: int) -> tuple[int, int]:
    """(C, rows): the blocks per kv row and feature rows per block of
    ``csrc/decode_step.cu::decode_slices``."""
    c = min(8, -(-m // 16))
    rows = -(-m // c)
    return -(-m // rows), rows


def split_decode(qf, kf, v, s, z, active=None):
    """K2 slice by slice: -> (y in v's dtype, s', z'), new tensors. Each
    slice's partial num and den, added in rank order from zero, then
    divided; inactive rows keep their state and get y = 0."""
    bh, m = qf.shape
    bk, dv = v.shape
    g = bh // bk
    s2 = s + kf.float()[:, :, None] * v.float()[:, None, :]
    z2 = z + kf.float()
    qg = qf.float().reshape(bk, g, m)
    c, rows = decode_slices(m)
    num = torch.zeros(bk, g, dv)
    den = torch.zeros(bk, g)
    for r in range(c):
        sl = slice(r * rows, min(m, (r + 1) * rows))
        num = num + qg[:, :, sl] @ s2[:, sl, :]
        den = den + torch.sum(qg[:, :, sl] * z2[:, None, sl], dim=-1)
    y = (num / (den[..., None] + DELTA)).reshape(bh, dv)
    if active is not None:
        on = active.bool()
        y = torch.where(on.repeat_interleave(g)[:, None], y, 0.0)
        s2 = torch.where(on[:, None, None], s2, s)
        z2 = torch.where(on[:, None], z2, z)
    return y.to(v.dtype), s2, z2


def _inputs(seed, bh, bk, m, dv):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 1.0, (bh, m)).astype(np.float32),
            rng.uniform(0.0, 1.0, (bk, m)).astype(np.float32),
            rng.normal(size=(bk, dv)).astype(np.float32),
            rng.normal(size=(bk, m, dv)).astype(np.float32),
            rng.uniform(0.0, 4.0, (bk, m)).astype(np.float32))


def test_decode_slices_match_the_kernel_split():
    # The serving shape's eight slices of 48 rows; m = 390: seven of 49 and
    # a ragged 47; m = 100: seven of 15 and one of 10; m below one slice:
    # one block. No slice is ever empty.
    assert decode_slices(384) == (8, 48)
    assert decode_slices(390) == (8, 49)
    assert decode_slices(100) == (7, 15)
    assert decode_slices(7) == (1, 7)
    for m in range(1, 600):
        c, rows = decode_slices(m)
        assert 1 <= c <= 8 and (c - 1) * rows < m <= c * rows


@pytest.mark.parametrize("bh,bk,m,dv,masked", [
    (4, 4, 384, 64, False),     # the serving shape's slices, G = 1
    (16, 2, 390, 32, False),    # G = 8, a ragged last slice
    (16, 2, 390, 16, True),     # G = 8, masked
    (6, 3, 100, 16, True),      # G = 2, C = 7, masked
    (3, 3, 24, 8, False),       # C = 2 slices of 12
])
def test_decode_slice_sums_match_pallas_and_plain(bh, bk, m, dv, masked):
    x = _inputs(bh * m + dv, bh, bk, m, dv)
    active = None
    if masked:
        active = (np.arange(bk) % 3 != 1).astype(np.int32)
    tx = [torch.from_numpy(a) for a in x]
    ta = None if active is None else torch.from_numpy(active)
    y, s2, z2 = split_decode(*tx, ta)
    jy, js, jz = jdecode.decode_linear_attention(
        *(jnp.asarray(a) for a in x),
        None if active is None else jnp.asarray(active), delta=DELTA,
        interpret=True)
    py, ps, pz = tdecode.decode_linear_attention_plain(
        *(t.clone() for t in tx), ta, delta=DELTA)
    for want in (np.asarray(jy), py.numpy()):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(y.numpy(), want, rtol=0.0,
                                   atol=1e-5 * scale)
    assert torch.equal(s2, ps) and torch.equal(z2, pz)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(z2.numpy(), np.asarray(jz), rtol=1e-6,
                               atol=1e-6)
    if masked:
        off = active == 0
        assert np.array_equal(s2.numpy()[off], x[3][off])
        assert not y.reshape(bk, bh // bk, dv)[torch.from_numpy(off)].any()
