"""The paper's synthetic task suite (Table 7/8): 22 tasks in 8 categories.

numpy only: a copy of ``repro.data.tasks`` so the port imports nothing of
the JAX package; the same ``np.random.Generator`` gives the same batches.

Each generator returns {"tokens": (B, L) int32, "labels": (B, L) int32,
"mask": (B, L) bool} — loss/accuracy are evaluated at masked positions only.
Layout convention: [input segment] SEP [answer segment]; the model is
queried autoregressively over the answer segment.

Vocabulary: 0 = PAD, 1 = SEP, 2 = QUERY, 3.. = payload symbols.
"""
from __future__ import annotations

import numpy as np

PAD, SEP, QUERY = 0, 1, 2
BASE = 3

CATEGORIES = {
    "basic": ["copy", "sort", "reverse"],
    "arithmetic": ["counting", "parity", "addition", "modular"],
    "long_range": ["long_copy", "distant_match", "multihop"],
    "memory": ["retrieval", "kv_recall", "first_token", "selective_copy"],
    "patterns": ["bigram", "majority"],
    "reasoning": ["stack", "induction", "pattern"],
    "robustness": ["noisy_copy", "compression"],
    "aggregation": ["histogram"],
}
ALL_TASKS = [t for ts in CATEGORIES.values() for t in ts]


def _pack(inp: np.ndarray, ans: np.ndarray, L: int):
    """[inp SEP ans PAD...]; labels shifted; mask over answer positions."""
    B = inp.shape[0]
    tokens = np.full((B, L), PAD, np.int32)
    labels = np.full((B, L), PAD, np.int32)
    mask = np.zeros((B, L), bool)
    n_in, n_ans = inp.shape[1], ans.shape[1]
    assert n_in + 1 + n_ans <= L, (n_in, n_ans, L)
    tokens[:, :n_in] = inp
    tokens[:, n_in] = SEP
    # Teacher forcing: answer tokens appear as inputs shifted by one.
    tokens[:, n_in + 1:n_in + 1 + n_ans - 1] = ans[:, :-1] if n_ans > 1 \
        else tokens[:, n_in + 1:n_in]
    labels[:, n_in:n_in + n_ans] = ans
    mask[:, n_in:n_in + n_ans] = True
    return {"tokens": tokens, "labels": labels, "mask": mask}


def generate(task: str, rng: np.random.Generator, batch: int, seq_len: int,
             vocab: int) -> dict:
    V = vocab - BASE  # payload symbols
    B, L = batch, seq_len
    n = max(2, min((L - 2) // 2, 16))

    if task in ("copy", "noisy_copy", "long_copy"):
        m = max(2, (L - 2) // 2) if task == "long_copy" else n
        x = rng.integers(BASE, BASE + V, (B, m))
        inp = x.copy()
        if task == "noisy_copy":
            noise = rng.random((B, m)) < 0.2
            inp = np.where(noise, rng.integers(BASE, BASE + V, (B, m)), x)
            ans = inp.copy()       # copy the (noisy) input as seen
        else:
            ans = x
        return _pack(inp, ans, L)
    if task == "reverse":
        x = rng.integers(BASE, BASE + V, (B, n))
        return _pack(x, x[:, ::-1], L)
    if task == "sort":
        x = rng.integers(BASE, BASE + V, (B, n))
        return _pack(x, np.sort(x, -1), L)
    if task == "counting":
        x = rng.integers(BASE, BASE + min(V, 8), (B, n))
        target = x[:, :1]
        cnt = (x == target).sum(-1) % min(V, 10)
        return _pack(x, BASE + cnt[:, None], L)
    if task == "parity":
        x = rng.integers(BASE, BASE + 2, (B, n))
        par = ((x - BASE).sum(-1) % 2)
        return _pack(x, BASE + par[:, None], L)
    if task == "addition":
        d = min(V, 10)
        a = rng.integers(0, d, (B, n // 2))
        b = rng.integers(0, d, (B, n // 2))
        s = (a + b) % d
        inp = np.concatenate([BASE + a, BASE + b], 1)
        return _pack(inp, BASE + s, L)
    if task == "modular":
        d = min(V, 10)
        x = rng.integers(0, d, (B, n))
        m = (x.sum(-1) % d)
        return _pack(BASE + x, BASE + m[:, None], L)
    if task == "distant_match":
        x = rng.integers(BASE, BASE + V, (B, L - 4))
        first = x[:, 0]
        return _pack(x, first[:, None], L)
    if task == "multihop":
        # Chain a->b, b->c pairs; query: follow 2 hops from start symbol.
        d = min(V, 12)
        perm = np.stack([rng.permutation(d) for _ in range(B)])
        pairs = np.zeros((B, 2 * d), np.int64)
        pairs[:, 0::2] = BASE + np.arange(d)
        pairs[:, 1::2] = BASE + perm
        start = rng.integers(0, d, (B,))
        hop1 = np.take_along_axis(perm, start[:, None], 1)[:, 0]
        hop2 = np.take_along_axis(perm, hop1[:, None], 1)[:, 0]
        inp = np.concatenate([pairs, np.full((B, 1), QUERY),
                              BASE + start[:, None]], 1)
        return _pack(inp, BASE + hop2[:, None], L)
    if task in ("retrieval", "kv_recall"):
        d = min(V // 2, 12)
        keys = np.stack([rng.permutation(d) for _ in range(B)])
        vals = rng.integers(0, d, (B, d))
        kv = np.zeros((B, 2 * d), np.int64)
        kv[:, 0::2] = BASE + keys
        kv[:, 1::2] = BASE + d + vals
        qi = rng.integers(0, d, (B,))
        qkey = np.take_along_axis(keys, qi[:, None], 1)[:, 0]
        qval = np.take_along_axis(vals, qi[:, None], 1)[:, 0]
        inp = np.concatenate([kv, np.full((B, 1), QUERY),
                              BASE + qkey[:, None]], 1)
        return _pack(inp, BASE + d + qval[:, None], L)
    if task == "first_token":
        x = rng.integers(BASE, BASE + V, (B, n))
        return _pack(x, x[:, :1], L)
    if task == "selective_copy":
        # Copy only the marked (QUERY-preceded) tokens, in order.
        k = 4
        x = rng.integers(BASE, BASE + V, (B, n))
        marks = np.zeros((B, n), bool)
        for i in range(B):
            marks[i, rng.choice(n, k, replace=False)] = True
        inp = np.full((B, 2 * n), PAD, np.int64)
        inp[:, 0::2] = np.where(marks, QUERY, PAD)
        inp[:, 1::2] = x
        ans = np.stack([x[i][marks[i]] for i in range(B)])
        return _pack(inp, ans, L)
    if task == "bigram":
        # Predict the symbol that always follows a trigger symbol.
        trig = BASE
        follow = rng.integers(BASE + 1, BASE + V, (B, 1))
        x = rng.integers(BASE + 1, BASE + V, (B, n))
        x[:, n // 3] = trig
        x[:, n // 3 + 1] = follow[:, 0]
        x[:, -1] = trig
        return _pack(x, follow, L)
    if task == "majority":
        d = min(V, 6)
        x = BASE + rng.integers(0, d, (B, n))
        maj = np.array([np.bincount(r - BASE, minlength=d).argmax()
                        for r in x])
        return _pack(x, BASE + maj[:, None], L)
    if task == "histogram":
        d = min(V // 2, 6)
        x = rng.integers(0, d, (B, n))
        counts = np.stack([np.bincount(r, minlength=d) for r in x])
        return _pack(BASE + x, BASE + d + np.clip(counts, 0, d), L)
    if task == "stack":
        # Balanced push(sym)/pop sequence; answer: top of stack at the end.
        d = min(V, 8)
        x = np.zeros((B, n), np.int64)
        ans = np.zeros((B, 1), np.int64)
        for i in range(B):
            stack = [rng.integers(0, d)]
            seq = [BASE + stack[0]]
            for _ in range(n - 1):
                if len(stack) > 1 and rng.random() < 0.4:
                    stack.pop()
                    seq.append(QUERY)      # pop marker
                else:
                    s = int(rng.integers(0, d))
                    stack.append(s)
                    seq.append(BASE + s)
            x[i] = seq
            ans[i, 0] = BASE + stack[-1]
        return _pack(x, ans, L)
    if task == "induction":
        # Induction head: ...A B ... A -> B
        x = rng.integers(BASE, BASE + V, (B, n))
        a = rng.integers(BASE, BASE + V, (B,))
        b = rng.integers(BASE, BASE + V, (B,))
        x[:, n // 4] = a
        x[:, n // 4 + 1] = b
        x[:, -1] = a
        return _pack(x, b[:, None], L)
    if task == "pattern":
        # Periodic pattern continuation (period 3).
        p = rng.integers(BASE, BASE + V, (B, 3))
        reps = n // 3 + 1
        x = np.tile(p, (1, reps))[:, :n]
        nxt = x[:, n % 3 if n % 3 < 3 else 0][:, None]
        nxt = p[:, n % 3][:, None]
        return _pack(x, nxt, L)
    if task == "compression":
        # Run-length: answer is the de-duplicated symbol sequence.
        d = min(V, 8)
        k = 4
        syms = BASE + np.stack([rng.permutation(d)[:k] for _ in range(B)])
        runs = rng.integers(1, max(2, n // k), (B, k))
        x = np.full((B, n), PAD, np.int64)
        for i in range(B):
            seq = np.repeat(syms[i], runs[i])[:n]
            x[i, :len(seq)] = seq
            x[i, len(seq):] = syms[i, -1]
        return _pack(x, syms, L)
    raise ValueError(f"unknown task {task}")


def accuracy(logits: np.ndarray, labels: np.ndarray,
             mask: np.ndarray) -> float:
    pred = logits.argmax(-1)
    hit = (pred == labels) & mask
    return float(hit.sum() / max(mask.sum(), 1))
