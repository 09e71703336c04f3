#!/usr/bin/env python3
"""How far the LM families' bf16 decode departs from their forward, by
depth and by block, beside how far the forward departs from itself.

    python3 scripts/decode_depth_probe.py [arch ...]    # needs one CUDA card

For each architecture (by default phase 17's four, at the depths
``chip_smoke.py`` serves them) it draws the weights from seed 0 on the
card, serves 8 prompts of 512 tokens from ``TokenPipeline`` with 32
greedy tokens, and on those 8 x 544 tokens prints, as ``chip_smoke.py``'s
``family_decode_gate`` measures it (err over the largest logit, the
largest row; a decode step's near-tie routing flips aligned):

- decode against forward in bf16 at 2, 4 and 8 layers (the same draws)
  and at the served depth, and at the served depth once more with
  cuBLAS's reduced-precision bf16 reductions turned off;
- each block's departure at the last position at the served depth (its
  output's err over its largest entry, the largest row), decode against
  forward;
- the forward's last-position logits from batches of 1 and of 4 rows
  against those from all 8 rows in one batch, in bf16 and in float32;
- decode against forward on the float32 copy at the served depth.

Prints the card's name and power limit and a JSON line an architecture.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402


def last_logits(params, seq, cfg):
    import torch
    from repro_torch.models import lm as L
    with torch.no_grad():
        return L.lm_logits(L.forward(params, seq, cfg)[0][:, -1:], params,
                           cfg)


def departure(a, b) -> float:
    return float(((a - b).abs().amax(dim=-1) /
                  (b.abs().amax(dim=-1) + 1e-6)).max())


def spreads(params, seq, cfg) -> dict:
    """The forward's last logits from batches of 1 and of 4 rows against
    those from one batch of 8."""
    import torch
    full = last_logits(params, seq, cfg)
    return {f"batch{n}": departure(torch.cat(
        [last_logits(params, seq[i:i + n], cfg)
         for i in range(0, seq.shape[0], n)]), full) for n in (1, 4)}


def by_block(params, seq, cfg) -> list:
    """Each block's output at the last position, decode against forward."""
    import torch
    from repro_torch.models import lm as L
    outs = {"decode": [], "forward": []}
    apply, which = L._apply_block, ["prefill"]

    def recorded(*args):
        out = apply(*args)
        if which[0] != "prefill":
            outs[which[0]].append((args[0], out[0][:, -1].float()))
        return out
    L._apply_block = recorded
    try:
        b, s = seq.shape[:2]
        with torch.no_grad():
            _, caches = L.prefill(params, seq[:, :-1], cfg, max_len=s)
            which[0] = "decode"
            L.decode_step(params, caches, seq[:, -1:], s - 1, cfg)
            del caches
            which[0] = "forward"
            L.forward(params, seq, cfg)
    finally:
        L._apply_block = apply
    return [f"{kind}:{departure(d, f):.3e}" for (kind, d), (_, f)
            in zip(outs["decode"], outs["forward"])]


def probe(arch: str, layers: int, device) -> dict:
    import torch
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import lm as L
    from repro_torch.models.nn import init_params
    cfg, specs, _ = CS.family_config(arch, layers)
    params = init_params(specs, seed=0, device=device)
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=CS.LMF_PROMPT,
                                    global_batch=CS.LMF_SERVE_BATCH, seed=1),
                         device=device)
    seq, _, _ = CS.served(params, pipe.batch_at(0), cfg, CS.LMF_GREEDY, 0.0)
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.n_experts_per_token)
    out = {"arch": arch, "layers": layers}
    gate = CS.family_decode_gate(params, seq, cfg, CS.LM_DECODE_BOUND)
    out["bf16"] = {layers: [gate["ratio"], gate["flipped"]]}
    mm = torch.backends.cuda.matmul
    mm.allow_bf16_reduced_precision_reduction = False
    out["bf16_without_reduced_precision_reductions"] = \
        CS.family_decode_gate(params, seq, cfg, CS.LM_DECODE_BOUND)["ratio"]
    mm.allow_bf16_reduced_precision_reduction = True
    out["bf16_by_block"] = by_block(params, seq, cfg)
    out["bf16_forward_spread"] = spreads(params, seq, cfg)
    del params
    torch.cuda.empty_cache()
    for cut in (2, 4, 8):
        if cut < layers:
            cut_cfg = dataclasses.replace(cfg, n_layers=cut)
            p = init_params(L.model_param_specs(cut_cfg), seed=0,
                            device=device)
            g = CS.family_decode_gate(p, seq, cut_cfg, CS.LM_DECODE_BOUND)
            out["bf16"][cut] = [g["ratio"], g["flipped"]]
            del p
            torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = init_params(L.model_param_specs(cfg32), seed=0, device=device)
    out["f32"] = CS.family_decode_gate(p32, seq, cfg32, 1.0)["ratio"]
    out["f32_forward_spread"] = spreads(p32, seq, cfg32)
    del p32
    torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_depth_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    depth = {arch: served for arch, served, _ in CS.LMF_RUNS}
    print(CS.card_line(), flush=True)
    for arch in argv or list(depth):
        print(json.dumps(probe(arch, depth[arch], device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
