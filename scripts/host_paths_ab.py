#!/usr/bin/env python3
"""Times the host-bound learn and serving paths of one tree of this
repository on one GPU, many times each, for comparing two trees in one
call: ``chip_smoke.py`` times each of them once a run, too few to tell a
change from the host's noise.

    python3 scripts/host_paths_ab.py [--tree DIR] [--reps N]

``--tree`` is the root of a checkout (default: this one); its
``src/repro_torch`` is imported and its kernels are built under its own
``build/``. The shapes are ``chip_smoke.py``'s (this checkout's
constants), on uniform 2-bit codes at k = 256 drawn on the card from a
seed: full-batch ``fit_words`` (100 steps over 2,330,594 rows, whose
step issues more host work than the card's), minibatch ``fit_words``
(100 steps of 65,536 rows over those rows), ``fit_log`` (60 steps over a
``MutableAnnEngine`` of those rows in 262,144-row segments, 10 %
deleted) and ``AnnService.classify`` (1,024 unit query vectors at D =
1,024, through a service over 65,536 coded rows with a classifier of 50
``fit_store`` steps). Each is timed on the host clock around
synchronised work after one warm-up: the three training paths ``--reps``
times, classify ten times as often; the full batch also with the host's
time until its last launch apart and the SM clock (``nvidia-smi``, every
50 ms) sampled meanwhile. It prints one JSON line with the card, every
time and each path's median rate (the full batch's as ms a step), and
the host's microseconds a forward call at classify's 1,024 rows, one
word each (2,000 calls queued).

Run the trees in turns in one call (parent, change, change, parent),
each unpacked with ``git archive``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402  (shapes, card line, query rows)

SEED = 21
FWD_CALLS = 2000


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("host_paths_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.ann import CodeStore, AnnEngine
    from repro_torch.core import packing
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    from repro_torch.index import MutableAnnEngine
    from repro_torch.kernels import _build, ops
    from repro_torch.learn import LearnConfig, fit_log, fit_store, fit_words
    from repro_torch.serve import AnnService

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    def runs(fn, reps: int) -> list:
        fn()
        return [timed(fn) for _ in range(reps)]

    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    crp = CodedRandomProjection(SketchConfig(k=cs.K, scheme="2bit", w=0.75,
                                             seed=0), cs.D)
    n = cs.URL_ROWS - cs.LEARN_HELD
    words = packing.pack_codes(torch.randint(0, 4, (n, cs.K), generator=gen,
                                             device=dev), 2)
    y = np.where(rng.random(n) < 0.5, 1, -1)
    out = dict(tree=args.tree, card=cs.card_line(), reps=args.reps)

    # the full batch also with the host's own time apart (until its last
    # launch is queued) and the card's SM clock sampled by nvidia-smi
    # every 50 ms meanwhile: a host-bound step shows its enqueue time near
    # its whole time
    full = LearnConfig(steps=100)
    fit_words(words, y, crp, full)
    clock = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "50"], stdout=subprocess.PIPE, text=True)
    t, t_host = [], []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit_words(words, y, crp, full)
        t_host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
    clock.terminate()
    mhz = [int(v) for v in clock.communicate()[0].split() if v.isdigit()]
    out.update(full_s=t, full_host_s=t_host, full_sm_mhz=mhz,
               full_step_ms=1e3 * statistics.median(t) / full.steps)

    mb = LearnConfig(batch=cs.LEARN_BATCH, steps=cs.LEARN_MB_STEPS)
    t = runs(lambda: fit_words(words, y, crp, mb), args.reps)
    out.update(mb_s=t, mb_row_steps_s=mb.batch * mb.steps /
               statistics.median(t))

    mut = MutableAnnEngine(crp, tail_rows=cs.LEARN_TAIL)
    mut.add_words(words)
    mut.delete(rng.choice(n, n // 10, replace=False))
    lcfg = LearnConfig(steps=cs.LEARN_LOG_STEPS)
    t = runs(lambda: fit_log(mut.store, lambda i: y[i], crp, lcfg), args.reps)
    out.update(log_s=t, log_segments=mut.store.n_segments,
               log_row_steps_s=mut.n * lcfg.steps / statistics.median(t))
    del mut

    store = CodeStore.from_words(words[:cs.CHUNK].clone(), cs.K, 2)
    svc = AnnService(AnnEngine(crp, store))
    svc.set_classifier(fit_store(store, y[:cs.CHUNK], crp,
                                 LearnConfig(steps=50)))
    queries = cs.unit_rows(cs.N_QUERIES, cs.D, gen, dev)
    t = runs(lambda: svc.classify(queries), 10 * args.reps)
    out.update(classify_s=t, classify_rows_s=cs.N_QUERIES /
               statistics.median(t))
    # the host's cost of one forward call (plan, checks, launch) at
    # classify's 1,024 rows of one word (16 fields, so that the card takes
    # less than the host), queued without waiting
    tab = torch.zeros((1, 64), device=dev)
    sub = words[:cs.N_QUERIES, :1].contiguous()
    ops.packed_linear_fwd(tab, sub, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FWD_CALLS):
        ops.packed_linear_fwd(tab, sub, 2)
    out.update(fwd_call_us=1e6 * (time.perf_counter() - t0) / FWD_CALLS)
    torch.cuda.synchronize()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
