#!/usr/bin/env python3
"""Why ``chip_smoke.py``'s ``[moe]`` drops so many slots: a CPU trace of
moonshot-v1-16b-a3b's routing at init.

    PYTHONPATH=src python3 tools/moe_drops.py [--steps 6] [--d-ff 8]

The model is ``[moe]``'s: full width, 1 of 48 layers, bf16 with the f32
router, its per-expert width cut to ``--d-ff`` (routing reads the router
and the MoE input, and no expert width changes either). Its params are
drawn on the CPU from seed 0, as the train CLI draws them on the card:
the same distributions, not the same numbers (the two generators'
streams differ). Its batches are the train CLI's (``SyntheticBatches``,
seed 0, batch 4, seq 512), each split into the config's 2 microbatches:
1,024 tokens, G = 16 groups of Tg = 64 consecutive positions, Cg = 8
slots per expert and group. Every batch goes through the params at init.

Per microbatch it prints the share of a group's tokens that repeat an
earlier token of the group and the most copies of one token in a group;
the RMS of the embedding and of the attention output that the block adds
to it; the mean cosine between two MoE inputs of one group; and the
share of dropped slots that ``moe.route`` gives, checked against a numpy
count from its router logits (top-k, earlier slots per expert, capacity),
on the real MoE input and on the RMS-normed embedding alone (what the
repeats do), the attention output alone, and a batch of uniform tokens.
"""
import argparse
import dataclasses
import json
import math

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticBatches
from repro_torch.models import build, moe
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_rope, multihead_attention, rmsnorm

ARCH, BATCH, SEQ = "moonshot-v1-16b-a3b", 4, 512  # chip_smoke.py's [moe]


def numpy_dropped(logits: np.ndarray, top_k: int, capacity: int) -> int:
    """Dropped slots of (G, Tg, E) router logits, counted apart from
    ``moe.route``: token-major slots, a slot's position the number of
    earlier slots of its group on its expert."""
    ids = np.argsort(-logits, axis=-1, kind="stable")[..., :top_k]
    dropped = 0
    for g in ids.reshape(ids.shape[0], -1):
        seen = np.zeros(logits.shape[-1], dtype=np.int64)
        for e in g:
            dropped += int(seen[e] >= capacity)
            seen[e] += 1
    return dropped


def repeats(tokens: np.ndarray, groups: int) -> tuple[float, int]:
    """(share of tokens equal to an earlier token of their group, most
    copies of one token in a group) over batch-major groups."""
    rep, most = 0, 0
    for g in tokens.reshape(groups, -1):
        _, counts = np.unique(g, return_counts=True)
        rep += int((counts - 1).sum())
        most = max(most, int(counts.max()))
    return rep / tokens.size, most


def mean_cosine(x: torch.Tensor) -> float:
    """Mean cosine between two distinct rows of each group of (G, Tg, D)."""
    u = torch.nn.functional.normalize(x.float(), dim=-1)
    gram = u @ u.transpose(1, 2)
    n = x.shape[1]
    return float((gram.sum((1, 2)) - n).mean() / (n * (n - 1)))


def trace(cfg, params, tokens: np.ndarray) -> dict:
    """The layer's MoE inputs over one microbatch and their routings."""
    blocks = params["blocks"]
    a = blocks["attn"]
    w = {"ln1": blocks["ln1"][0], "wq": a["wq"][0], "wk": a["wk"][0],
         "wv": a["wv"][0], "attn_wo": a["wo"][0]}
    router = blocks["moe"]["router"][0]
    ln2 = blocks["ln2"][0]
    tok = torch.from_numpy(tokens).long()
    B, S = tok.shape
    T = B * S
    G = math.gcd(cfg.moe_groups, T)
    x = params["embed"][tok]
    h = rmsnorm(x, w["ln1"], cfg.norm_eps)
    q, k, v = tfm._qkv(cfg, w, h)
    positions = torch.arange(S)
    q, k = (apply_rope(t, positions, cfg.rope_theta) for t in (q, k))
    att = multihead_attention(q, k, v, causal=True,
                              chunked_threshold=cfg.attn_chunked_threshold,
                              block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
    att = att.transpose(1, 2).reshape(B, S, cfg.q_dim) @ w["attn_wo"]
    inputs = {"real": rmsnorm(x + att, ln2, cfg.norm_eps),
              "embed_only": rmsnorm(x, ln2, cfg.norm_eps),
              "attn_only": rmsnorm(att, ln2, cfg.norm_eps)}
    out = {"rms_embed": float(x.float().pow(2).mean().sqrt()),
           "rms_attn": float(att.float().pow(2).mean().sqrt())}
    for name, inp in inputs.items():
        xt = inp.reshape(G, T // G, -1)
        r = moe.route(cfg, router, xt)
        dropped = int((~r.keep).sum())
        if dropped != numpy_dropped(r.logits.numpy(), cfg.moe_top_k, r.capacity):
            raise SystemExit(f"{name}: moe.route and the numpy count disagree")
        out[name] = {"dropped_share": dropped / r.keep.numel(), "cosine": mean_cosine(xt)}
    out["repeat_share"], out["most_copies"] = repeats(tokens, G)
    out["groups"], out["capacity"] = G, r.capacity
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=6, help="batches of the train CLI")
    ap.add_argument("--d-ff", type=int, default=8, help="per-expert width (routing reads none)")
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(get_config(ARCH), num_layers=1, d_ff=args.d_ff)
    assert not cfg.embed_scale and not cfg.parallel_block
    torch.manual_seed(0)
    with torch.no_grad():
        params = build(cfg).init(torch.Generator().manual_seed(0))
        data = SyntheticBatches(cfg, batch=BATCH, seq_len=SEQ)
        rows = []
        mb = BATCH // cfg.microbatches
        for step in range(1, args.steps + 1):
            inputs = next(data)["inputs"]
            for i in range(cfg.microbatches):
                rows.append(dict(step=step, microbatch=i,
                                 **trace(cfg, params, inputs[i * mb:(i + 1) * mb])))
                print(json.dumps(rows[-1]), flush=True)
        uniform = np.random.default_rng(1).integers(0, cfg.vocab_size, (mb, SEQ))
        rows.append(dict(step=None, microbatch="uniform", **trace(cfg, params, uniform)))
        print(json.dumps(rows[-1]), flush=True)
    real = [r for r in rows if r["step"] is not None]
    summary = {k: [min(r[k]["dropped_share"] for r in real),
                   max(r[k]["dropped_share"] for r in real)]
               for k in ("real", "embed_only", "attn_only")}
    summary["repeat_share"] = [min(r["repeat_share"] for r in real),
                               max(r["repeat_share"] for r in real)]
    summary["uniform"] = {k: rows[-1][k]["dropped_share"]
                          for k in ("real", "embed_only", "attn_only")}
    print(json.dumps({"summary": summary}))
    return summary


if __name__ == "__main__":
    main()
