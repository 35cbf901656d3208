"""B7's walk over tokens and Ψ's chunks, mirrored on the CPU.

B7 (``csrc/feature_map.cu::feature_map_fwd_kernel``) runs a persistent
grid: nb blocks, as many as are resident at once and at most one per tile
of ``TILE`` tokens; block b takes tiles b, b + nb, ... A tile's Ψ rows are
one contiguous range of the output, which the block's ``THREADS`` threads
write in 16-byte chunks: thread i takes chunks i, i + THREADS, ..., and
steps its (token, chunk of the row) pair without a division. Each chunk
is 16 / sizeof(T) neighbouring columns of one node r and anchor p, whose
φ_p index, first φ_e index and √w_r come from a table built once per
block. This file mirrors that walk and that table in Python and checks
that every token, and every chunk of every row, is written exactly once,
for ragged N (also 0) and several grid sizes, and that the table rebuilds
the plain Ψ bit for bit. The kernel keeps ``psi_rows``'s order of every
fp32 operation, so there is no arithmetic order to replay here; the card
holds it to its plain version (``tests/test_torch_card.py``) and to the
previous build bit for bit (``tools/compare_kernel_builds.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import features as tfeat
from repro_torch.kernels.common import feature_statics, features_fwd

TILE = 32       # kFwdTile
THREADS = 256   # kThreads


def grid(n: int, resident: int) -> int:
    """Blocks of B7's grid for n tokens (fm_blocks); no launch for n = 0."""
    return min(-(-n // TILE), resident)


def tile_rows(n: int, nb: int) -> list[list[range]]:
    """Per block, the token ranges of the tiles it walks."""
    tiles = -(-n // TILE)
    return [[range(t * TILE, min(t * TILE + TILE, n))
             for t in range(b, tiles, nb)] for b in range(nb)]


def chunk_walk(rows: int, chunks: int):
    """(item, token, chunk) of every thread's walk over a tile of ``rows``
    rows of ``chunks`` chunks, with the kernel's stepping."""
    t_step, q_step = divmod(THREADS, chunks)
    for tid in range(THREADS):
        t, q = divmod(tid, chunks)
        for it in range(tid, rows * chunks, THREADS):
            yield it, t, q
            t, q = t + t_step, q + q_step
            if q >= chunks:
                t, q = t + 1, q - chunks


def chunk_table(P: int, D: int, R: int, es: int):
    """Per chunk: (φ_p index, first φ_e index in φ_e's own array, node)."""
    pd, cols = P * D, 16 // es
    out = []
    for q in range(R * pd * es // 16):
        col = q * cols
        r = col // pd
        out.append(((col % pd) // D, r * D + col % D, r))
    return out


@pytest.mark.parametrize("n,resident", [
    (0, 528), (1, 528), (31, 528), (33, 528), (1000, 3), (777, 528),
    (98304 - 37, 528), (98304, 528), (24576, 264), (200001, 1056)])
def test_b7_tile_walk_writes_every_token_once(n, resident):
    nb = grid(n, resident)
    assert nb <= resident and (nb > 0) == (n > 0)
    seen = np.zeros(n, np.int64)
    for ranges in tile_rows(n, nb):
        assert ranges, "every block of the grid has a tile"
        for rg in ranges:
            assert 0 < len(rg) <= TILE
            seen[rg.start:rg.stop] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("chunks", [16, 32, 48, 96, 128, 192, 256, 768])
@pytest.mark.parametrize("rows", [1, 7, TILE])
def test_b7_chunk_walk_writes_every_chunk_once(rows, chunks):
    # chunks per row: 48 (m = 384 in bf16), 96 (in fp32), 16 and 32 (one
    # node), 128 and 256 (eight nodes), 192 and 768 (more than a block's
    # threads, so the chunk of a thread changes from step to step).
    seen = np.zeros(rows * chunks, np.int64)
    for it, t, q in chunk_walk(rows, chunks):
        assert (t, q) == divmod(it, chunks)
        seen[it] += 1
    assert (seen == 1).all()


# (P, D, R, dtype) with D·sizeof(dtype) a multiple of 16 bytes; other
# shapes (e.g. D = 4 in bf16) take B7's plain path, which has no table.
TABLE_CASES = [(P, D, R, dt) for P, D, R in [(8, 16, 3), (16, 24, 1),
                                             (8, 16, 8)]
               for dt in (torch.float32, torch.bfloat16)]
TABLE_CASES.append((3, 4, 3, torch.float32))


@pytest.mark.parametrize("P,D,R,dtype", TABLE_CASES)
def test_b7_chunk_table_rebuilds_the_plain_psi(P, D, R, dtype):
    es = torch.tensor([], dtype=dtype).element_size()
    cfg = tfeat.SlayFeatureConfig(head_dim=16, num_anchors=P, num_prf=D,
                                  num_quad_nodes=R)
    p = tfeat.init_feature_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    rng = np.random.default_rng(0)
    u = torch.from_numpy(rng.normal(size=(37, 16)).astype(np.float32))
    st = feature_statics(cfg)
    psi, (_, _, _, phi_p, phi_es) = features_fwd(u, p["anchors"], p["omegas"],
                                                 st)
    phi_e = torch.cat(phi_es, dim=-1)
    cols = 16 // es
    got = torch.empty_like(psi)
    for q, (pi, ei, r) in enumerate(chunk_table(P, D, R, es)):
        got[:, q * cols:(q + 1) * cols] = (
            phi_p[:, pi:pi + 1] * phi_e[:, ei:ei + cols]) * st.sqrt_w[r]
    assert torch.equal(got.to(dtype), psi.to(dtype))
