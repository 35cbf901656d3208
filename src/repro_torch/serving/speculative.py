"""Draft-verify speculative decoding (``repro.serving.speculative``).

The linear SLAY twin of the verifier (the *draft*, constant-size (S, z)
per slot) proposes ``gamma`` tokens per slot and round; the exact
verifier (a non-windowed yat or softmax kind, a KV ring per slot) scores
all ``gamma + 1`` positions in one ``verify_chunk``; the accept/resample
correction keeps the emitted distribution exactly the verifier's, so a
round emits up to ``gamma + 1`` tokens for one verifier evaluation.

Determinism contract, the JAX package's: every draw is keyed on (seed,
rid, token index) plus a substream tag (``sampling.SPEC_TAG_*``): the
draft proposal, the accept coin and the resample are independent
streams, and the bonus token (every draft accepted) takes the untagged
base stream. Nothing keys on slot or round, so streams are placement-
and K-invariant for a fixed ``gamma``. Greedy (temperature <= 0) accepts
a draft iff it is the verifier's argmax and emits that argmax either
way, so greedy speculative streams are greedy exact decoding's for any
draft and any ``gamma``, provided the verifier's fp32 argmax is unique
at each emitted position (decode step and verify chunk are different
programs that may break an exact tie differently).

Rollback is a ``pos`` rewind of the verifier's rings: rows past the
accept horizon are invisible and are overwritten in place later, and a
paged pool's tables do not move (admission sized the slot's pages for
its whole context plus ``gamma`` rows). The reference re-absorbs the
emitted tokens into the draft pool from its round-start value; the port
updates (S, z) in place, so each round drafts on a scratch twin of the
draft pool copied from it, and resynchronises the pool itself.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import api
from repro_torch.serving import sampling
from repro_torch.tree import tree_leaves


def draft_sample(logits: torch.Tensor, rids: torch.Tensor,
                 idxs: torch.Tensor, *, temperature: float,
                 seed: int) -> torch.Tensor:
    """Draft proposal: logits (S, V) -> tokens (S,) int32, a Gumbel-max
    draw from softmax(logits / T) on the DRAFT substream, or the fp32
    argmax when greedy. :func:`sampling.sample_tokens` on another stream:
    a proposal never consumes the verifier's base draw."""
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    g = sampling.spec_gumbel_row(seed, rids, idxs, sampling.SPEC_TAG_DRAFT,
                                 logits.shape[-1])
    return torch.argmax(sampling.scale_logits(logits, temperature) + g,
                        dim=-1).to(torch.int32)


def accept_and_correct(p_logits: torch.Tensor, q_logits: torch.Tensor,
                       drafts: torch.Tensor, rids: torch.Tensor,
                       idxs: torch.Tensor, *, temperature: float, seed: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """One draft position's accept/resample correction, per slot.

    p_logits and q_logits (S, V) are the verifier's and the draft's logits
    for the same token index, ``drafts`` (S,) the proposals. Returns
    (accept (S,) bool, corrected (S,) int32), ``corrected`` being the
    token to emit instead on rejection.

    Sampled (T > 0): accept with probability min(1, p(d) / q(d)) on the
    ACCEPT coin, as ``u * q(d) < p(d)`` (no division, and exact when
    p == q); on rejection a Gumbel-max draw from log max(p - q, 0), -inf
    where the residual is 0, on the RESAMPLE substream. Over the draft's
    proposal the emitted token is distributed as softmax(p_logits / T).
    Greedy: accept iff the draft is the verifier's argmax, which is
    ``corrected``.
    """
    p_logits = p_logits.float()
    if temperature <= 0.0:
        top = torch.argmax(p_logits, dim=-1).to(torch.int32)
        return drafts == top, top
    p = torch.softmax(sampling.scale_logits(p_logits, temperature), dim=-1)
    q = torch.softmax(sampling.scale_logits(q_logits.float(), temperature),
                      dim=-1)
    d = drafts.long()[:, None]
    pd = torch.gather(p, -1, d)[:, 0]
    qd = torch.gather(q, -1, d)[:, 0]
    u = sampling.spec_uniform(seed, rids, idxs)
    accept = u * qd < pd
    r = torch.clamp(p - q, min=0.0)
    # An all-zero residual (p == q) is unreachable (acceptance is then
    # certain); its row must only not be NaN.
    logr = torch.where(r > 0, torch.log(torch.clamp(r, min=1e-38)),
                       float("-inf"))
    g = sampling.spec_gumbel_row(seed, rids, idxs,
                                 sampling.SPEC_TAG_RESAMPLE, p.shape[-1])
    return accept, torch.argmax(logr + g, dim=-1).to(torch.int32)


def spec_macro(params, draft_pool, scratch, pool, last_tok, active, rids,
               gen, eos_ids, max_new, *, draft_cfg: ArchConfig,
               cfg: ArchConfig, num_rounds: int, gamma: int,
               temperature: float, seed: int,
               fault_guard: bool = True) -> torch.Tensor:
    """K speculative rounds over the slot pools, all on the device, the
    pools updated in place.

    Per round and active slot: (1) ``scratch``, a copy of the draft pool
    taken at the round's start, runs ``gamma`` masked decode steps
    proposing d_1..d_gamma; (2) the verifier scores [last_tok, d_1..
    d_gamma] in one ``verify_chunk``, the distribution of every proposed
    index and of the bonus position; (3) the correction picks the emitted
    tokens e_1..e_m (m <= gamma + 1: the accepted prefix, then one
    corrected or bonus token), cut at EOS or the budget as the plain
    macro step cuts; (4) the verifier rewinds to the accept horizon and
    the draft pool, still at the round's start, absorbs the m emitted
    inputs [last_tok, e_1..e_{m-1}] in ``gamma + 1`` decode steps masked
    per slot, so both agree on the context entering the next round.

    Fault lane (``fault_guard``): per slot, the finiteness of both pools'
    fresh state and of the verifier's logits. A faulted slot emits
    nothing in the round (its verifier rewinds to the round's start, its
    draft pool absorbs nothing) and is flagged for host quarantine.

    last_tok/active/rids/gen/eos_ids/max_new are (S,) device tensors
    (int32; ``active`` bool). Returns one int32 tensor (K, 3 (gamma + 1)
    + 1, S): the emitted tokens, emitted flags and fault flags, each
    (gamma + 1) rows a round (faults in the first), and the round's
    accepted-draft count, -1 where the slot ran no round (drained or
    faulted).
    """
    G = gamma
    S = last_tok.shape[0]
    jj = torch.arange(G + 1, device=last_tok.device)[:, None]   # (G+1, 1)
    zero = torch.zeros(1, S, dtype=torch.int32, device=last_tok.device)
    rounds = []
    for _ in range(num_rounds):
        act = active
        # (1) draft: gamma masked steps on the round-start copy.
        for d, s in zip(tree_leaves(scratch), tree_leaves(draft_pool)):
            d.copy_(s)
        tok, drafts, q_rows = last_tok, [], []
        for j in range(G):
            logits, _ = api.decode_step(params, draft_cfg, scratch,
                                        tok[:, None], act)
            row = logits[:, -1, :]
            nxt = draft_sample(row, rids, gen + j, temperature=temperature,
                               seed=seed)
            tok = torch.where(act, nxt, tok)
            drafts.append(tok)
            q_rows.append(row)
        dr = torch.stack(drafts)                                 # (G, S)
        # (2) verify: one exact chunk over [last_tok, d_1..d_G].
        pos0 = api.slot_positions(cfg, pool).clone()
        p_logits, _ = api.verify_chunk(
            cfg, params, pool, torch.cat([last_tok[None], dr]).T, act)
        # (3) acceptance and correction, position by position (each its
        # own token index, so its own keys).
        accs, corr = [], []
        for j in range(G):
            a_j, c_j = accept_and_correct(
                p_logits[:, j], q_rows[j], dr[j], rids, gen + j,
                temperature=temperature, seed=seed)
            accs.append(a_j)
            corr.append(c_j)
        bonus = sampling.sample_tokens(p_logits[:, G], rids, gen + G,
                                       temperature=temperature, seed=seed)
        a = torch.cumprod(torch.stack(accs).to(torch.int32), 0).sum(
            0, dtype=torch.int32)
        cand = torch.cat([torch.stack(corr), bonus[None]])      # (G+1, S)
        e = torch.where(jj < a, torch.cat([dr, zero]), cand)
        emit = (jj <= a) & act
        hitj = emit & sampling.stop_hit(e, gen + jj + 1, eos_ids, max_new)
        hi = hitj.to(torch.int32)
        emit = emit & (torch.cumsum(hi, 0) - hi == 0)
        if fault_guard:
            ok = (api.slot_state_finite(cfg, pool)
                  & api.slot_state_finite(draft_cfg, scratch)
                  & torch.isfinite(p_logits.float()).flatten(1).all(-1))
            faulted = act & ~ok
        else:
            ok = torch.ones_like(act)
            faulted = torch.zeros_like(act)
        emit = emit & ok
        m = emit.sum(0, dtype=torch.int32)                       # (S,)
        stopped = (hitj & emit).any(0)
        # (4a) verifier rollback to the accept horizon: the kept rows hold
        # [last_tok, e_1..e_{m-1}] (e_j = d_j on the accepted prefix), so
        # only pos moves.
        api.rollback_slots(cfg, pool, pos0 + m)
        # (4b) draft resync from the round's start: the same m inputs,
        # masked per slot and step.
        sync_in = torch.cat([last_tok[None], e[:-1]])
        for j in range(G + 1):
            api.decode_step(params, draft_cfg, draft_pool,
                            sync_in[j][:, None], jj[j] < m)
        e_out = torch.where(emit, e, last_tok)
        last = torch.gather(e_out, 0,
                            torch.clamp(m - 1, min=0).long()[None])[0]
        last_tok = torch.where(m > 0, last, last_tok)
        gen = gen + m
        active = act & ok & ~stopped
        flt = torch.cat([faulted[None], torch.zeros_like(emit[1:])])
        acc = torch.where(act & ok, a, -1)
        rounds.append(torch.cat([e_out, emit.to(torch.int32),
                                 flt.to(torch.int32), acc[None]]))
    return torch.stack(rounds)
