#!/usr/bin/env python3
"""Times the bit-packing kernel (row 3, ``ops.pack_codes``) of one tree
of this repository on one GPU, at the shapes ``chip_smoke.py`` gives it,
for comparing two trees in one call: ``chip_smoke.py`` of an earlier
tree times row 3 at the query chunk alone.

    python3 scripts/pack_codes_ab.py [--tree DIR] [--reps N]

``--tree`` is the root of a checkout (default: this one); its
``src/repro_torch`` is imported and its kernels are built under its own
``build/``. On uniform 2-bit codes at k = 256 drawn on the card from a
seed, at ``chip_smoke.PACK_SHAPES`` (the query chunk, a mutable add
batch, the dense corpus), it checks the tree's kernel bit-exact against
the tree's plain version (``chip_smoke.pack_checked``)
and times it with ``chip_smoke.time_ms`` (each call behind a spin
kernel, the median of ``--reps``) beside one device-to-device copy of
the same codes and its share of its own bytes bound (a yardstick of the
card's memory rate, not of the function), at
the query chunk also a launch's time over back-to-back launches
(``chip_smoke.per_launch_ms``), and a one-element add alike (the launch
floor). It prints one JSON line with
the card, the tree and every time beside its bytes bound.

Run the trees in turns in one call (parent, change, change, parent),
each unpacked with ``git archive``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402  (shapes, timing, card line, bound)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("pack_codes_ab: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels import _build, ops
    if not _build.CSRC.is_relative_to(tree):
        raise AssertionError(f"repro_torch imported from {_build.CSRC}, "
                             f"not from {tree}")
    _build.build_all()
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(24)
    bits, k = 2, cs.K
    w = (k * bits + 31) // 32
    one = torch.zeros(1, device=device, dtype=torch.int32)
    out = dict(card=cs.card_line(), tree=tree,
               launch_floor_ms=cs.time_ms(lambda: one.add_(1),
                                          reps=args.reps))
    for name, m in cs.PACK_SHAPES:
        codes = torch.randint(0, 1 << bits, (m, k), generator=gen,
                              device=device, dtype=torch.int32)
        cs.pack_checked(codes, bits)
        ms = cs.time_ms(lambda: ops.pack_codes(codes, bits, impl="kernel"),
                        reps=args.reps)
        b_ms = cs.bound([("int32", 2.0 * m * k, cs.INT32_OP_S)],
                        4.0 * m * (k + w))[0]
        # a yardstick of the card's memory rate, not of this function: one
        # device-to-device copy of the same codes, beside its bytes bound
        dst = torch.empty_like(codes)
        copy_ms = cs.time_ms(lambda: dst.copy_(codes), reps=args.reps)
        copy_bound_ms = 1e3 * 8.0 * m * k / cs.HBM_BYTES_S
        del dst
        out[name] = dict(shape=[m, k], ms=ms, bound_ms=b_ms, share=b_ms / ms,
                         copy_ms=copy_ms, copy_share=copy_bound_ms / copy_ms)
        if m == cs.CHUNK_Q:
            out[name]["per_launch_ms"] = cs.per_launch_ms(
                lambda: ops.pack_codes(codes, bits, impl="kernel"))[0]
        del codes
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
