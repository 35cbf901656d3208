"""The port's two examples, ``repro_torch.examples.quickstart`` and
``.long_context``, run in-process on the CPU (``--device cpu``): they
finish, print finite readings, and the training loss falls; the
long-context state and decode outputs equal the plain linear-attention
functions' on the feature map's plain twin (state 1e-5; y, bf16, one
rounding)."""
import math
import re

import torch

from repro_torch.core import linear_attention as tla
from repro_torch.examples import long_context, quickstart
from repro_torch.kernels import feature_map as tfm

torch.set_num_threads(1)    # small ops; the suite runs one process per core


def test_quickstart_on_cpu(capsys):
    rel, losses = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    printed = float(re.search(r"rel-L2 vs exact: ([0-9.]+)", out).group(1))
    assert math.isfinite(rel) and 0.0 < rel < 2.0
    assert abs(printed - rel) < 1e-3
    assert len(losses) == quickstart.TRAIN_STEPS
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] < 0.7 * losses[0]


def test_long_context_on_cpu(capsys):
    r = long_context.main(["--prompt-len", "1024", "--decode-steps", "2",
                           "--device", "cpu"])
    out = capsys.readouterr().out
    ratio = float(re.search(r"\(([0-9.]+)x larger", out).group(1))
    assert math.isfinite(ratio) and ratio > 1.0
    assert math.isfinite(r["ms_per_token"]) and len(r["ys"]) == 3
    assert set(r["quadratic_ms"]) == {256, 512, 1024}
    cfg, a, w = r["cfg"], r["params"]["anchors"], r["params"]["omegas"]

    def psi(u):
        return tfm.feature_map_plain(u.reshape(-1, u.shape[-1]), a, w,
                                     cfg).reshape(*u.shape[:-1], -1)

    # (S, z) after the prompt, then each step, against the feature map's
    # plain twin and linear_attention's prefill and decode.
    want = tla.prefill_state(psi(r["k"]), r["v"])
    for got, exp in zip(r["state0"], want, strict=True):
        torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-5)
    qf = psi(r["q"])
    for y in r["ys"]:
        yw, want = tla.decode_step(qf, qf, r["q"], want)
        torch.testing.assert_close(y.float(), yw.float(), rtol=1e-2,
                                   atol=1e-2)
    for got, exp in zip(r["state"], want, strict=True):
        torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-5)
