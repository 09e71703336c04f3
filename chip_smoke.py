#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py            # full run: build, kernel checks, main path
    python3 chip_smoke.py --check    # build and the small-shape kernel checks only
    python3 chip_smoke.py --profile  # full run plus torch.profiler breakdowns
    python3 chip_smoke.py --lm       # phase 16 (the LM path) alone
    python3 chip_smoke.py --lm-families  # phase 17 (MoE, hybrid, SSM) alone

Phases, in order; any failure raises and the script exits non-zero:

1. Build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and print the build time, the
   compiler's register and spill report, and the card's name and power
   limit.
2. Kernel checks. Small ragged shapes over every scheme, bit width and
   table type (rerank_m above N, top_k above the survivors, all rows
   tied, N = 0; for the masked kernels N = 0, 1, 31, 33 and 3,000 with
   all, none, 10 % and 90 % of the rows dead; for the packed-linear
   kernels bits 1/2/4/8 at k = 33, 100 and 256, C = 1, 3, 8, 9 and one C
   above the forward's shared-memory class tile, N = 0, 1, 31, 33 and
   3,000, block_n = 32 and 512, the same masks, 16-bit fields at k = 33,
   and the backward's partials folded in groups; the backward also over
   block_n 1, 100, 512 and 1,000 (a chunk walked in several row tiles of
   the tiled partial kernel), C 1/3/8/9, N 0-1,000 across chunk and
   mask-word edges, the four masks, bits 1/2/4/8 and 16, partials in
   groups of three chunks, the device-memory form at bits 1/2/4 (which
   rows too wide for shared memory take), and its two halves apart; the
   forward also over N 255, 256, 257, 513 and 1,000 (its 256-row tiles)
   with its planned grid and a grid shrunk to two blocks a class tile
   (each then walks several row tiles), 16-byte aligned rows and rows
   shifted by one word, the four masks, bits 1/2/4/8/16 and C 1/3/8/9
   and above the class tile, and the memory form (tables too wide for
   shared memory) at bits 1/2/4/8; for
   the LUT top-k kernels bits 1/2/4/8/16 with float32 and bf16 tables at
   N = 0, 1, 31, 33 and 3,000, top_k above the live rows, the same masks,
   all rows tied, and the grid of the fields kernel (Q around its query
   blocks, N ragged against its tiles, every S and QB given, 4-bit tables
   at the largest k it takes and one past it; every default launch
   twice);
   the unpacked count kernel on int32 codes of any value at every
   tile; top_k and rerank_m above 2048 in every top-k kernel; the bf16
   draw against the CPU's prng on whole units and all 128 uniforms, bf16
   R through the GEMMs and bf16 z through code_pack), then the main path's
   shapes (the masked kernels on one 262,144-row segment and on the
   4,194,304 rows with 10 % dead): each kernel against its
   plain PyTorch version on the same inputs, on the card. Every kernel
   but the two GEMMs must be bit-exact; the GEMMs (3xTF32 on the tensor
   cores) may differ from ``torch.matmul``'s float32 product only in
   fields whose reference projection lies within 1e-5 of a bin edge, must
   give the same bits on two launches, and ``encode_fused``'s words must
   be the pack of ``coded_project``'s codes. Each kernel is timed (CUDA
   events, median of 10; 3 for the plain versions that build the whole
   [256, 4,194,304] count matrix) beside its plain version and its bound;
   the GEMMs' bound is three TF32 tensor-core products a multiply-add at
   495 TFLOP/s, printed beside the CUDA cores' float32 bound and
   ``torch.matmul``, and ``coded_project`` is also timed at the serving
   buckets M = 64 and 256. The count sweep of rows 4-7 runs on the int8
   tensor cores for 1- and 2-bit codes (``csrc/topk_tc.cuh``,
   the ``packed_topk_tc`` row, launches counted apart): rows 4-7 are held
   bit-exact at the default S and at every S the autotune sweep tries
   (and at 1), their bound is 2 Q N_live K int8 operations at 1,979
   TOPS against the bytes, printed beside the popcount bound
   (``popc_bound_ms``), and ``torch._int_mm`` of the one-hot operands at
   a segment's shape ([256 x 1,024] by [1,024 x 262,144], the product
   alone, held to the counts) is their ``gemm_library_ms``; the sweep's
   partial lists are held to their plain version and timed apart from
   the merge at top_k 10 and at m 64, with the plan and the registers
   and spills of each instance. Row 9 (``packed_collision_counts``) runs
   on the int8 tensor cores for 1- and 2-bit codes
   (``csrc/packed_counts.cu``'s ``packed_counts_tc``, chosen by
   ``packed_collision.counts_plan``; the ``packed_counts_tc`` row,
   launches counted apart): the small checks hold it at QB 64 and 128,
   with TMA stores at N % 4 == 0 and 4-byte stores at ragged N, its
   row's bound is the [Q, N] write's bytes against the one-hot product
   at 1,979 TOPS, with the popcount bound and ``torch._int_mm``'s
   segment beside, and its kernel row times it at the LSH chunk's
   shape. Row
   10 (``packed_lut_rerank``) runs one warp a query for M <= 128
   (``lut_rerank_warp``, ``packed_lut.rerank_plan``; the
   ``packed_lut_rerank_warp`` row): its row gives the latency floor of
   one candidate's chain of F dependent float adds beside its bytes
   bound, and the kernel row times the block kernel at the same shape.
   Both rows record the form that ran and, in the kernels line, its
   launches on the path (``form_launches``). Row 3 (``pack_codes``,
   ``pack_codes.pack_plan``: 16-byte or 4-byte code loads, the lanes of
   a word adding by shuffles) is checked in both forms (a one-element
   storage offset forces the 4-byte one) on codes in range and over all
   int32, and timed at the query chunk [256 x 256], a mutable add batch
   [65,536 x 256] and the dense corpus [4,194,304 x 256] (checked in
   262,144-row slices), each with its bytes bound, share and plan; at the
   query chunk also a launch's time over 100 back-to-back launches. A
   one-element add, timed alike, is printed once as ``launch_floor_ms``
   and stands in rows 3 and 10.
3. Main path at N = 4,194,304 rows, D = 1024, k = 256, 2-bit codes at
   w = 0.75: seeded Gaussian rows made on the card in 65,536-row chunks
   go through ``CodedRandomProjection.sketch`` into a ``CodeStore``;
   ``AnnEngine`` searches 1,024 queries (512 of them noisy corpus rows
   that must come back at rank 0), ``add``s a batch and searches again.
   Launch counts are reset just before and read just after; every kernel
   of the path must have launched. 16 queries are then rechecked against
   the plain ``packed_topk_ref`` over the whole store.
4. Scored and LSH path, on the engine after ``add`` (4,259,840 rows):
   the rank tables are checked against JAX's to a relative 1e-4; scored
   search (fused with f32, then int8 tables, then two-stage) over the
   1,024 queries and LSH search (count-ranked, then scored; 16 bands of
   4 codes, no probes, one band to match) over 256 of them, with launch
   counts reset before and read after. Gates: planted queries at rank 0
   (512/512 scored f32 and two-stage, 128/128 LSH), two-stage equal to
   fused on every query but those whose plain versions differ too
   (LUT scores tied across collision counts; counted), and 16 queries of
   each mode bit-exact against the same engine on the plain versions.
   Printed, not gated: queries/s of each mode, and the rank-0 hit rate
   of count-ranked against scored search on planted queries at cosine
   0.9 and 0.6.
5. Mutable path (``repro_torch.index``): ``MutableAnnEngine`` with
   262,144-row segments ingests the main path's 4,194,304 rows (64
   ``ingest`` calls of 65,536 rows made on the card from its seed; the
   words must equal the main path's store), deletes 419,430 ids (a
   quarter of the planted sources among them), upserts 65,536 ids (64
   planted sources re-planted under their old ids) and adds 65,536
   rows: 17 segments. It then searches in six modes (count-ranked,
   scored fused f32 and int8 and two-stage over the 1,024 queries; LSH
   count-ranked and scored over 256), compacts (target 1,048,576 rows,
   5 % dead), searches again, saves a snapshot, restores it and
   searches again. Launch counts cover the path's own calls. Gates: no
   deleted id comes back; live planted and re-planted sources at rank
   0; count-ranked modes bit-exact against a fresh immutable engine over
   ``live_words()``, and unchanged by compaction; scored modes
   bit-exact against the same search without masks, one segment's live
   rows at a time (the coarse top-m is per segment, so they need not
   equal the whole-store engine; the agreement is printed); 16 queries
   of each mode bit-exact against the plain versions; the restored
   index bit-exact in every mode. Printed: rows/s of ingest, ms and
   rows/s of delete, upsert and add, queries/s per mode at each stage,
   ms of the compaction, MB/s of the snapshot's save and restore.
6. Encode kernels at the URL path's shapes, on chunk 0 of the URL
   corpus: ``code_pack`` (B8) on its [262,144 x 256] projections, the R
   draw of one [4,096 x 256] unit and of a group of G = 8 units in one
   launch, and the grouped CSR step over the whole chunk (30,146,560
   entries, all 790 units, R drawn beforehand): at G = 8 and G = 1, its
   launches counted (99 and 790), bit-exact against its plain version,
   the step of one unit a launch and the encoder's projection, timed per
   chunk beside its bound (the CSR arrays, the accumulator written once
   and all of R read once, against 2 float operations an entry and
   column), one ``torch.addmm`` of the chunk as a sparse CSR tensor (the
   library yardstick) and the sum of ``torch.addmm`` over the units'
   buckets; the others each bit-exact against its plain
   version, timed beside its bound. The small checks (phase 2) hold B8
   to its plain version over every scheme at ragged shapes, the draw to
   the CPU's ``prng`` on all 2^23 mantissas, on whole units and on URL
   units 0, 1 and 789, the grouped draw to one unit a launch (units 0-7
   and a run ending at 789, bf16 too), the CSR step of one unit to its
   plain version on empty rows, no entries, repeated columns and rows in
   the ragged last unit only, and the grouped step at G = 1, 3 and 8,
   k = 7, 256 and 300, float32 and bf16 R, a unit without entries and
   rows of up to 300 entries to its plain version and the step of one
   unit.
7. URL path, at the URL corpus's published width: D = 3,231,961 (790
   units of R, the last 217 rows; R, 3.3 GB, is never built), k = 256,
   2-bit codes, 2,396,130 CSR rows of 115 distinct columns made on the
   host chunk by chunk, through ``IngestPipeline`` (262,144-row chunks)
   into a ``CodeStore``; ``AnnEngine`` searches 1,024 CSR queries (512
   planted at cosine about 0.9) count-ranked and scored; then
   ``MutableAnnEngine.ingest`` takes the first 524,288 rows. A chunk
   draws its occupied units 8 at a time (the encoder's ``csr_group``)
   and runs one grouped CSR step a group. Launches counted over the
   path. Gates: R never built; each chunk's peak device memory beyond
   the store within its CSR arrays, accumulator and words plus 64 MB;
   512/512 planted at rank 0 in both modes; 16 rows bit-exact against
   ``impl="ref"`` and against a float64 oracle but at counted bin-edge
   fields; the mutable engine's words equal the store's. Printed: ms
   and launches a chunk, ingest rows/s, query coding's ms and launches.
8. Dense cross-check above the cap: 8,192 unit rows at D = 131,072
   (about 1 % nonzero) encoded fused with R resident (cap raised),
   streamed at the default cap and as CSR agree but at bin edges.
   Launches counted over the three encodes: the draw of one unit a
   launch reports its count from here.
9. Learn path (``repro_torch.learn``), SVM training on packed codes at
   the URL corpus's published shape: 2,396,130 CSR rows (D = 3,231,961,
   115 nonzeros) made on the host outside every window, each one of 64
   prototype rows with each nonzero moved to a fresh column with
   probability 35/115 (mean cosine about 0.7 to its prototype); label +1
   for prototypes 0-31, -1 for 32-63, class p % 8 for one-vs-rest; the
   last 65,536 rows held out. ``IngestPipeline`` puts the 2,330,594
   training rows into a ``CodeStore`` (k = 256, 2-bit, w = 0.75, seed 0);
   ``fit_store`` trains full batch with ``LearnConfig()`` (squared hinge,
   c = 1, 400 steps, lr 0.1); ``fit_words`` minibatch (65,536 rows, 100
   steps) and one-vs-rest (C = 8, 100 steps); a ``MutableAnnEngine`` with
   262,144-row segments takes the training rows, deletes 10 % of the ids
   and upserts 65,536 with new rows and labels, and ``fit_log`` trains 60
   steps with labels by external id. Launches counted over the path.
   Gates: the four packed-linear kernels launched; 3 full-batch Adam
   steps bit-exact between ``impl="auto"`` and ``impl="ref"``;
   ``fit_log`` equal to ``fit_words`` over ``live_words()`` within rtol
   1e-4, atol 1e-5, held-out predictions agreeing on at least 99.9 %;
   held-out accuracy at least 0.9 for the binary fits; the full-batch
   fit's peak device memory beyond the store under 1/16 of the one-hot.
   Printed: row-steps/s of each fit, ms a full-batch step, the
   minibatch's host time drawing its indices, inference rows/s, held-out
   accuracies. Then the packed-linear kernels at these shapes (C = 1 and
   8; the masked ones with 10 % dead), each bit-exact against its plain
   version, timed beside it, its bound and its library yardstick
   (``F.embedding_bag``; ``torch.bincount`` at C = 1 and a matmul of g
   with the 9.5 GB one-hot at C = 8, built outside the window for that
   yardstick alone), the forward beside the floor of its shared-memory
   reads (a wavefront a warp's (row, class, field)) with its plan,
   registers and spills, the backward's partial kernel and fold timed
   apart beside their bounds with the plan, registers and spills, and a
   float64
   one-hot oracle over 4,096 rows (within 1e-5 of the terms' magnitudes).
   ``--profile`` adds one full-batch step and one ``fit_log`` gradient.
10. Repairs (phases 10 and 11 run between phases 5 and 6, while the
    main path's engine is resident), on the engine after ``add``: 16
    queries with top_k and rerank_m above 2048 (count-ranked top_k 2049,
    scored fused top_k 513 so m 2052, two-stage and LSH scored at m 2100)
    bit-exact against ``impl="ref"``; a bf16 sketch of 65,536 rows (R
    bit-exact to the CPU's prng; resident codes against ``impl="ref"``
    but at counted fields within 1e-5 of a bin edge; streamed bit-exact).
11. Serving (``repro_torch.serve.AnnService``) at the main path's width
    over the same engine: ``warmup(d)`` with ``autotune_warmup=True`` on
    a fresh cache (must launch ``packed_lut_topk``); every op of
    ``autotune.SWEEPS`` swept at the serving shapes with each candidate
    held bit-identical to the default; the cache saved and loaded back;
    8,192 tickets drawn from the 1,024 queries, flushed in batches of 1,
    5, 8, 40, 64, 200, 256 and 300, count-ranked, scored f32 and
    two-stage, every result bit-exact against a direct ``search``; a
    mutable service over a 17-segment index (64 ``bulk_load`` calls of
    the main path's corpus) with ``delete``, ``upsert``, ``add``,
    ``bulk_load`` and ``compact`` between flushes, every result equal to
    a direct search at its generation; ``classify`` with a model trained
    by ``fit_store`` (50 steps, labels from a seeded teacher's margins),
    margins bit-exact against ``model.margins``; kernelstats calls equal
    to the launch counters over the phase; a deep ``Tracer`` syncing the
    flush spans; the registry on against off. Printed: queries/s through
    the service and direct, flush p50/p99 against the 0.050 s deadline,
    cache hit rate, padding waste, classify rows/s, the sweep's seconds
    and each winner against the default. TPU kernels 15-17 are also
    timed at the main path's shapes in phase 2 (256 queries, tables
    [256, 1,024] in float32 and in bf16, each QB of the fields kernel
    with its S, grid, resident blocks an SM and waves, 4,194,304 rows,
    top_k 10, 10 % dead for the masked one, against one float add a
    query, live row and field at 128 adds a clock an SM; 256 x 4,194,304
    codes at k = 256 for the count kernel, beside
    ``k - torch.cdist(q, db, p=0)``).
12. Health (``repro_torch.obs`` quality, shadow and drift; run right
    after phase 11 on its engines). ``MleRhoEstimator(CodeSpec("2bit",
    0.75))`` on 65,536 synthetic pairs at k = 256 for each rho in 0.3,
    0.6, 0.9 and 0.99: cell counts on the card equal to the CPU's, rho_hat
    equal but at near-ties and never more than a grid step away (the
    differing count printed), ``mle_rho_2bit`` equal to ``estimate``;
    4,096 seeded tickets through ``AnnService(engine,
    quality=QualityConfig(sample_rate=1.0))`` on the immutable engine,
    whose pooled int64 cell counts must equal a host recount of the
    sampled (query, candidate) codes and whose report's rho_hat the CPU
    estimator's on those counts; the 17-segment mutable index behind a
    quality service whose ``add``, ``upsert`` and ``bulk_load`` fill the
    shadow reservoir and whose ``delete`` leaves no deleted id in it, each
    sampled recall equal to a numpy recount from the reservoir's rows and
    codes and the query's codes; ``fit_store(..., quality=)`` margin
    moments within 1e-6 relative of numpy's on the same margins. Printed,
    not gated: served count-ranked queries/s with ``quality=None``,
    ``QualityConfig()`` (1 % sampled) and ``sample_rate=1.0`` in
    alternating runs, three of each, and MLE pairs/s, with the card line.
13. The rest of the health layer (``repro_torch.obs`` slo, probe,
    incident, resources, dashboard; run right after phase 12):
    ``AnnService(quality=QualityConfig(), slo=True, resources=True,
    incidents=<dir>)`` over the engine with 1,000 neighbourhood rows
    added (100 centres, 10 rows each at cosines 0.80 to 0.95 to theirs,
    offered to its shadow reservoir) and over a fresh 17-segment index of
    the main corpus with the same rows added through the service, warmed
    up. Each serves 4,096 tickets near the centres, one a flush (so about
    1 % of them get a shadow check); the index then serves four rounds of
    1,024 phase queries with ``delete``, ``upsert``, ``add`` and
    ``bulk_load`` before each. Then each ``slo.health()`` must be ok with
    no alert, with at least the policies' ``min_events`` (20) events on
    the ``search.quality`` budget (else it could not have alerted), and
    ``resources.compiles_since_mark`` 0 (every source was built in an
    earlier phase, so this count cannot move here); 64 canaries a
    service (``CanaryProber``, drawn from the shadow reservoir) must come
    back at recall 1.0, all ok within ``deadline_s``, with
    ``serve.flush_s``, ``serve.queries``, the sampler's retained traces and
    the quality report as they were, and rows 2, 3 and 4 (engine) or 6
    (index) launched under them; ``resources.collect()`` must report
    ``engine.store`` as ``store.nbytes`` and ``cuda0.bytes_in_use`` as
    ``torch.cuda.memory_allocated(0)``; the corrupted-ranking drill (an
    ``SloEngine`` on a fake clock, ``engine.search_codes`` returning a
    row that does not exist) must trip ``slo.search.quality`` within the
    60 s fast window and leave an incident bundle of kind ``drift`` that
    loads back with that series and the degraded SLO state; the
    dashboard's roofline rows must be the H100 model's. Printed: the
    ``search.quality`` events and bad events and the shadow recall of
    each service; ms a canary against ``deadline_s``; host ms of
    ``slo.tick(force=True)``, ``resources.collect()``, ``gather``,
    ``render_html`` (and the page's bytes) and an incident capture (and
    the bundle's bytes); served count-ranked queries/s with slo,
    resources and incidents off against on at the default 1 % quality
    sampling, eight runs of at least 5 s each in the order off, on, on,
    off, off, on, on, off, each after a full garbage collection, with
    each run's flush p99 and maximum, SLO ticks and collections inside,
    and the card line.
14. Sharded search and encode (right after phase 13, on its engine and
    the 1,024 phase queries), over a world-size-1 NCCL group on a
    ``FileStore`` under ``build/`` and its ``("data",)`` mesh
    (``launch.make_dp_mesh``): ``AnnEngine.search_sharded`` count-ranked,
    two-stage scored (rerank_m 64), fused with float32 and with int8
    tables, then ``encode_sharded`` on 262,144 rows of the main corpus (1
    GiB of float32), with launch counts reset before these calls and read
    after (the ``sharded`` path). Gates: ids and rho_hat bit-identical to
    ``search(mode="exact")`` with the same settings (and to a second
    sharded call); the encoded words equal to ``encode_packed``'s but at
    fields within 1e-5 of a bin edge (the sharded encode projects through
    ``torch.matmul`` in float32, ``encode_packed`` through the 3xTF32
    kernel), and bit-identical to ``project`` + ``code_pack``. Printed:
    queries/s sharded (two calls) against unsharded for each mode (the
    cost of the gather and the merge at world size 1), rows/s of
    ``encode_sharded`` against ``encode_packed``, the card line.
15. Sharded training and the gradient compressor (right after phase 9,
    on the learn path's store: C = 1 over 2,330,594 rows), over a new
    one-card NCCL mesh: ``packed_grads_sharded`` at seeded random tables,
    then ``fit_words(mesh=)`` full batch and minibatch (65,536 rows), 50
    steps each, counted (the ``sharded_learn`` path: rows 12 and 14).
    Gates: the gradient within rtol 1e-5, atol 1e-6 of
    ``packed_loss_and_grads``; each fit's tables within rtol 1e-4, atol
    1e-5 of the same fit without a mesh, with equal held-out predictions.
    Then ``GradCompressor`` (2-bit, rate 8, chunk 1,024) bound to the 14
    leaf shapes of qwen2-0.5B's parameters (494,032,768 float32
    gradients, written out in ``QWEN2_05B_GRAD``): ``wire_bytes()`` must
    be 17,368,344 and ``fp32_bytes()`` 1,976,131,072, and ``sync`` at
    world size 1 must agree with ``sync_local`` (the gradient and the EF
    state within rtol 1e-5 plus 1e-5 of the largest magnitude: ``sync``
    scales the decoded cells before the back-projection, ``decode``
    after). Printed: ms of ``encode``, ``decode`` and ``sync`` and the
    gradient GB/s each reaches, row-steps/s of each fit sharded and not,
    the card line. The group is destroyed at the end of each phase, and
    the launches of both sharded paths are printed as one JSON line.
16. The dense LM path (``repro_torch.models``, ``serve.serving``,
    ``train``, ``optim``, ``data``; right after phase 15), which launches
    none of the kernels above (every count must stay 0). qwen2-0.5B at its
    full config (24 layers, d_model 896, 14 heads, 2 KV heads, d_ff
    4,864, vocab 151,936, bf16; 494,032,768 parameters, checked), weights
    from ``init_params(seed=0)`` on the card: ``generate`` on 8 prompts of
    512 tokens from ``TokenPipeline``, 64 greedy tokens then 64 at
    temperature 0.8, each timed beside ``prefill`` alone; ``decode_step``
    after ``prefill`` at the last position against ``forward`` over the
    whole sequence (error over scale below 0.08, the reference's bound);
    the same widths at two layers in float32 on the card against the CPU
    port (logits within rtol 1e-3, atol 1e-4 of the largest); 6 steps of
    ``make_train_step`` at 8 x 4,096 through ``Trainer`` (AdamW lr 1e-3,
    warm-up 2, master copy) under CUDA's sync debug mode, every loss
    finite, the last below the first, no host synchronisation in the
    loop; 3 steps of ``make_compressed_train_step`` over a one-card NCCL
    group with ``GradCompressor`` (2-bit, rate 8, chunk 1,024; wire bytes
    17,368,344), then ``sync`` against ``sync_local`` on the model's real
    gradient within phase 15's bound; a two-layer float32 copy trained 4
    steps of 2 x 512 uninterrupted against 2 steps, a checkpoint under
    ``build/`` and a fresh ``Trainer`` resumed to 4 (parameters and
    optimizer state bit-identical). Then gemma2-9b at its full config (42
    layers LG, window 4,096, both softcaps, post norms, embedding scale,
    GeGLU), serving only: one prompt of 8,192 tokens (the L layers through
    ``banded_attention``, their caches rings of 4,096) and 32 greedy
    tokens, the decode check at the last position. Printed with the card
    line: prefill tokens/s, decode ms a token and tokens/s, ms a training
    step and tokens/s (CUDA events), the compressor's share of a step,
    the batch time of ``TokenPipeline``, peak allocated memory;
    ``--profile`` adds one decode step and one training step of qwen2-0.5B
    by kernel.
17. The MoE, hybrid and SSM families (``models.moe``, ``mamba2``,
    ``rwkv6``; right after phase 16), which launch none of the kernels
    above either (every count must stay 0). Weights from
    ``init_params(seed=0)`` on the card, each model freed before the
    next, every parameter count checked against the reference's. Served
    as phase 16 serves (8 prompts of 512 tokens, 32 greedy tokens then 32
    at temperature 0.8, the decode check at the last position):
    olmoe-1b-7b at its full config (16 layers, 64 experts top-8, gates
    not renormalised; 6,919,100,416 parameters), qwen3-moe-235b-a22b at
    full width and 2 of its 94 layers (128 experts top-8, renormalised,
    head_dim 128, 4 KV heads; 6,220,173,824), zamba2-1.2b at its full
    config (6 groups of ``AMMMMMM`` and an ``MM`` tail; 1,057,589,376) and
    rwkv6-7b at its full config (32 layers; 7,534,546,944); the MoE decode
    checks at capacity factor E/k (8 and 16), where no assignment drops,
    and the share of assignments kept at the configs' 1.25 printed.
    Trained 4 steps of 8 x 4,096 through ``Trainer`` (AdamW lr 3e-4, the
    launcher's, warm-up 1) under CUDA's sync debug mode: olmoe at 4 of 16 layers
    (1,884,310,528), zamba2 at full depth, rwkv6 at 2 of 32 layers
    (974,229,504; its WKV term in blocks of chunks, the blocking and the
    decay channels that would overflow the reference's form printed);
    every loss, aux and gradient norm finite, the last loss below the
    first, no host synchronisation. Then float32 two-layer copies of all
    four at full width (zamba2's as two ``AM`` groups) on the card against
    the CPU on one sequence of 2 x 64: logits within rtol 1e-3 plus 1e-4
    of the largest, expert ids equal but at near ties (a gap below 1e-5),
    whose count is printed. The decode check, on all 8 served sequences
    (``family_decode_gate``): in bf16 at the reference's bound 0.08 on
    the served weights' first 8 layers (the depth of the deepest config
    its own test holds to that bound), and on a float32 copy at the served
    depth within 4 times the float32 forward's own departure between
    batches of 4 and 8 rows (at least 1e-4); at the served depth in bf16
    the check and that departure are printed. A decode step whose router
    picks another expert set at a near tie is compared with a forward
    that takes its experts there. A failed check lets the other models
    run and fails the phase at its end. Printed with the card line: prefill
    tokens/s, decode ms a token, ms a training step and tokens/s (CUDA
    events), peak allocated memory, the kept share and the phase's
    seconds.
18. A ``kernels`` JSON line, the card line, and as the last line
    ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# CUDA's caching allocator grows its segments in place instead of cutting
# new ones (read when torch first allocates on the card): phase 17 loads
# and frees six models in turn, and with fixed segments zamba2's training
# step found no 8 GiB piece among 47 GiB cached and free
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

# Published peaks of one H100 SXM (NVIDIA data sheet; CUDA C Programming
# Guide throughput table for compute capability 9.0 at 132 SMs and the
# 1.98 GHz boost clock: 128 float32 adds, 64 int32 add/logic/shift and 16
# popc results per SM per clock). F32_FLOP_S counts a multiply-add as two
# operations; a bound that counts float adds takes F32_ADD_S.
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
F32_ADD_S = 132 * 128 * 1.98e9
TF32_FLOP_S = 495e12      # dense tensor-core TF32
TENSOR_I8_OP_S = 1979e12  # dense tensor-core int8
INT32_OP_S = 132 * 64 * 1.98e9
POPC_OP_S = 132 * 16 * 1.98e9
LDS_WAVES_S = 132 * 1.98e9   # shared-memory wavefronts: one a clock an SM
SPIN_CYCLES = int(2e-3 * 1.98e9)   # 2 ms at the boost clock
SM_CLOCK_HZ = 1.98e9     # the boost clock
FADD_CLOCKS = 4          # a dependent float add's latency, in clocks

# SHA-256 of the JAX reference's R for SketchConfig() at D = 1024
# (repro.core.sketch.CodedRandomProjection(SketchConfig(), 1024)
#  .stream_encoder().r_matrix(), float32 bytes, row-major).
R_SHA256 = "a7a08cc49a0e89c4387cc9ac787b6f72a52d45fdb94e468ea171f3a24bd96818"

N_ROWS, D, K, CHUNK = 4_194_304, 1024, 256, 65_536
# the URL corpus's published width, rows and nonzeros a row
# (src/repro/encode/sparse.py:3-9; src/repro/encode/encoder.py:48-52)
URL_D, URL_ROWS, URL_NNZ, URL_CHUNK = 3_231_961, 2_396_130, 115, 262_144
URL_SEED, URL_MOVED = 2015, 12    # planted: 12 of 115 nonzeros moved (10 %)
N_QUERIES, N_PLANTED, CHUNK_Q, TOP_K = 1024, 512, 256, 10
RERANK_M = 64                 # SearchConfig().resolve_m(N) at top_k = 10
N_LSH, N_LSH_PLANTED = 256, 128
EDGE_TOL = 1e-5
CORPUS_SEED = 2014
# mutable path: 16 sealed segments of 262,144 rows after the ingest
TAIL_ROWS, N_DELETE, N_UPSERT, N_REPLANT = 262_144, 419_430, 65_536, 64
# learn path: rows of the URL corpus's shape planted around 64 prototypes
# (35 of 115 nonzeros moved on average), the last 65,536 held out
LEARN_SEED, LEARN_PROTOS, LEARN_MOVED, LEARN_HELD = 2016, 64, 35, 65_536
LEARN_BATCH, LEARN_MB_STEPS, LEARN_OVR, LEARN_OVR_STEPS = 65_536, 100, 8, 100
LEARN_LOG_STEPS, LEARN_TAIL, LEARN_UPSERT = 60, 262_144, 65_536
LEARN_ORACLE_ROWS = 4096

# kernel -> (the path whose launch count it reports, its source, the TPU
# kernel it replaces)
KERNELS = {
    "encode_fused": ("main", "src/repro_torch/kernels/csrc/coded_gemm.cu",
                     "src/repro/kernels/encode_fused.py:80"),
    "coded_project": ("main", "src/repro_torch/kernels/csrc/coded_gemm.cu",
                      "src/repro/kernels/proj_code.py:76"),
    "pack_codes": ("main", "src/repro_torch/kernels/csrc/pack_codes.cu",
                   "src/repro/kernels/pack_codes.py:32"),
    "packed_topk": ("main", "src/repro_torch/kernels/csrc/packed_topk.cu",
                    "src/repro/kernels/packed_collision.py:170"),
    # the count sweep under rows 4-7 (packed_topk, fused_scored_topk and
    # their masked forms) for 1- and 2-bit codes
    "packed_topk_tc": ("main", "src/repro_torch/kernels/csrc/topk_tc.cuh",
                       "src/repro/kernels/packed_collision.py:170"),
    "fused_scored_topk": ("scored",
                          "src/repro_torch/kernels/csrc/fused_scored.cu",
                          "src/repro/kernels/fused_scored.py:265"),
    "packed_collision_counts": ("scored",
                                "src/repro_torch/kernels/csrc/packed_counts.cu",
                                "src/repro/kernels/packed_collision.py:90"),
    # row 9's tensor kernel (1- and 2-bit codes)
    "packed_counts_tc": ("scored",
                         "src/repro_torch/kernels/csrc/packed_counts.cu",
                         "src/repro/kernels/packed_collision.py:90"),
    "packed_lut_rerank": ("scored",
                          "src/repro_torch/kernels/csrc/packed_lut.cu",
                          "src/repro/kernels/packed_lut.py:296"),
    # row 10's warp-a-query kernel (M <= 128, 1-, 2- and 4-bit codes)
    "packed_lut_rerank_warp": ("scored",
                               "src/repro_torch/kernels/csrc/packed_lut.cu",
                               "src/repro/kernels/packed_lut.py:296"),
    "packed_topk_masked": ("mutable",
                           "src/repro_torch/kernels/csrc/packed_topk.cu",
                           "src/repro/kernels/packed_collision.py:247"),
    "fused_scored_topk_masked": ("mutable",
                                 "src/repro_torch/kernels/csrc/fused_scored.cu",
                                 "src/repro/kernels/fused_scored.py:289"),
    "code_pack": ("url", "src/repro_torch/kernels/csrc/code_pack.cu",
                  "src/repro/kernels/encode_fused.py:128"),
    # no Pallas counterpart: the JAX code they stand in for
    "normal_unit": ("dense", "src/repro_torch/kernels/csrc/normal_unit.cu",
                    "src/repro/core/sketch.py:104"),
    "normal_unit_group": ("url",
                          "src/repro_torch/kernels/csrc/normal_unit.cu",
                          "src/repro/core/sketch.py:104"),
    "csr_group_step": ("url", "src/repro_torch/kernels/csrc/csr_step.cu",
                       "src/repro/encode/encoder.py:100"),
    "packed_linear_fwd": ("learn",
                          "src/repro_torch/kernels/csrc/packed_linear.cu",
                          "src/repro/kernels/packed_linear.py:110"),
    "packed_linear_fwd_masked": ("learn",
                                 "src/repro_torch/kernels/csrc/packed_linear.cu",
                                 "src/repro/kernels/packed_linear.py:154"),
    "packed_linear_bwd": ("learn",
                          "src/repro_torch/kernels/csrc/packed_linear.cu",
                          "src/repro/kernels/packed_linear.py:216"),
    "packed_linear_bwd_masked": ("learn",
                                 "src/repro_torch/kernels/csrc/packed_linear.cu",
                                 "src/repro/kernels/packed_linear.py:273"),
    "packed_lut_topk": ("serve", "src/repro_torch/kernels/csrc/lut_topk.cu",
                        "src/repro/kernels/packed_lut.py:135"),
    "packed_lut_topk_masked": ("serve",
                               "src/repro_torch/kernels/csrc/lut_topk.cu",
                               "src/repro/kernels/packed_lut.py:213"),
    "collision_counts": ("serve", "src/repro_torch/kernels/csrc/collision.cu",
                         "src/repro/kernels/collision.py:42"),
}
# path -> every kernel it must launch
PATH_KERNELS = {
    "main": ("encode_fused", "coded_project", "pack_codes", "packed_topk",
             "packed_topk_tc"),
    "scored": ("coded_project", "pack_codes", "packed_topk",
               "packed_collision_counts", "packed_counts_tc",
               "packed_lut_rerank", "packed_lut_rerank_warp",
               "fused_scored_topk", "packed_topk_tc"),
    "mutable": ("encode_fused", "coded_project", "pack_codes",
                "packed_topk_masked", "fused_scored_topk_masked",
                "packed_collision_counts", "packed_counts_tc",
                "packed_lut_rerank", "packed_lut_rerank_warp",
                "packed_topk_tc"),
    "url": ("code_pack", "normal_unit_group", "csr_group_step", "pack_codes",
            "packed_topk", "fused_scored_topk", "packed_topk_tc"),
    "dense": ("encode_fused", "normal_unit", "code_pack",
              "normal_unit_group", "csr_group_step"),
    "learn": ("code_pack", "normal_unit_group", "csr_group_step",
              "pack_codes", "packed_linear_fwd", "packed_linear_fwd_masked",
              "packed_linear_bwd", "packed_linear_bwd_masked"),
    "serve": ("encode_fused", "coded_project", "pack_codes", "code_pack",
              "packed_topk", "packed_topk_masked", "fused_scored_topk",
              "fused_scored_topk_masked", "packed_lut_rerank",
              "packed_lut_rerank_warp", "packed_collision_counts",
              "packed_counts_tc", "packed_lut_topk",
              "packed_lut_topk_masked", "collision_counts",
              "packed_linear_fwd", "packed_linear_bwd", "packed_topk_tc"),
    # quality-audited serving: query coding, the count sweep on both
    # engines, ingest into the audited mutable index, fit_store's margins
    "health": ("encode_fused", "coded_project", "pack_codes", "packed_topk",
               "packed_topk_masked", "packed_topk_tc", "packed_linear_fwd",
               "packed_linear_bwd"),
    # canaries through probe_search on both engines: query coding and the
    # count sweep (rows 2, 3, 4 and 6)
    "slo": ("coded_project", "pack_codes", "packed_topk",
            "packed_topk_masked", "packed_topk_tc"),
    # search_sharded in four modes and encode_sharded over a one-card mesh
    # (rows 2, 3, 4, 5, 8 and 10, and R's draw)
    "sharded": ("coded_project", "pack_codes", "packed_topk",
                "packed_topk_tc", "fused_scored_topk", "packed_lut_rerank",
                "packed_lut_rerank_warp", "code_pack", "normal_unit"),
    # packed_grads_sharded and fit_words(mesh=): the masked forward and
    # backward (rows 12 and 14)
    "sharded_learn": ("packed_linear_fwd_masked", "packed_linear_bwd_masked"),
}
# registers and spill bytes of each instance of the tensor-core count
# sweep, "bits,QB" -> (registers, spill stores), from the build's report
TC_PTXAS = {}
# the same for every kernel of csrc/packed_linear.cu, by name and template
# arguments (linear_bwd_partial_tiledILi2ELi1ELb0EE: 2-bit, CT 1, unmasked)
LINEAR_PTXAS = {}
# ... of row 9's tensor kernel (packed_counts_tcILi2ELi128ELb1EE: 2-bit,
# QB 128, TMA stores) and of row 10's kernels (lut_rerank_warpIfLi2ELi2EE:
# float32 tables, 2-bit, CPL 2)
COUNTS_PTXAS = {}
RERANK_PTXAS = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events).

    Each run is queued behind a 2 ms spin kernel, so that the host has
    enqueued the call's launches before the card reaches the first event:
    the events then bracket device work, not the host's launch latency,
    which is longer than a small kernel (tens of microseconds)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(ops_s: list, n_bytes: float):
    """Least time (ms) for the work: bytes over the memory rate against
    each (pipe, operations, peak rate) triple. Returns the time, "bytes"
    or "operations", and the pipe (or pipes, joined by "=" when they
    tie) that binds."""
    terms = [("bytes", n_bytes / HBM_BYTES_S)] + \
        [(pipe, n / rate) for pipe, n, rate in ops_s]
    t = max(s for _, s in terms)
    pipes = "=".join(p for p, s in terms if s >= t * (1 - 1e-9))
    return 1e3 * t, ("bytes" if pipes == "bytes" else "operations"), pipes


def count_bounds(nq: int, n_live: int, w_words: int, int_word: int,
                 n_bytes: float):
    """The bounds of a count sweep over ``n_live`` rows: (the int8 tensor
    cores' least time for its one-hot product, 2 Q N_live K operations
    at K = 64 W bytes, against ``n_bytes`` -> bound()'s triple; the
    popcount bound, the least time of any fold on the CUDA cores: a popc
    and ``int_word`` int32 operations a (query, row, word))."""
    pairs = float(nq) * n_live * w_words
    tensor = bound([("int8 tensor", 2.0 * nq * n_live * 64 * w_words,
                     TENSOR_I8_OP_S)], n_bytes)
    popc = bound([("popc", pairs, POPC_OP_S),
                  ("int32", pairs * int_word, INT32_OP_S)], n_bytes)[0]
    return tensor, popc


def sweep_equal(name: str, fn_s, want) -> None:
    """``fn_s(n_ranges)`` at every S the autotune sweep tries for the count
    ops, and at 1, bit-exact against ``want``."""
    from repro_torch.kernels import autotune
    for s in (1,) + autotune.SWEEPS["packed_topk"]["n_ranges"]:
        if not same(fn_s(s), want):
            raise AssertionError(f"{name} at n_ranges={s} differs from its "
                                 f"plain version")


def launch_diff(before: dict) -> dict:
    """Launches of each wrapper since ``before`` (``ops.launch_counts()``),
    without resetting the counts; the wrappers that launched."""
    from repro_torch.kernels import ops
    now = ops.launch_counts()
    return {k: v - before[k] for k, v in now.items() if v != before[k]}


def require_launched(counts: dict, path: str) -> None:
    """Fails unless every kernel the path runs launched on it."""
    missing = [k for k in PATH_KERNELS[path] if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: "
                             f"{missing}")


def edge_distance(z, spec, q):
    """Distance of each projection from its nearest bin edge."""
    import torch
    if spec.scheme == "sign":
        return z.abs()
    if spec.scheme == "2bit":
        w = spec.w
        return torch.stack([(z + w).abs(), z.abs(), (z - w).abs()]).amin(0)
    v = (z + q if spec.scheme == "offset" else z) / spec.w
    return (v - v.round()).abs() * spec.w


def check_codes(got, want, z_ref, spec, q, what: str) -> int:
    """Kernel codes vs plain codes: differences only at bin edges."""
    diff = got != want
    far = diff & (edge_distance(z_ref, spec, q) > EDGE_TOL)
    if bool(far.any()):
        raise AssertionError(f"{what}: {int(far.sum())} fields differ away "
                             f"from a bin edge")
    return int(diff.sum())


def unit_rows(n: int, d: int, gen, device):
    import torch
    x = torch.randn((n, d), generator=gen, device=device)
    return x / x.norm(dim=1, keepdim=True)


def corpus_chunk(gen, device):
    """The next corpus chunk from ``gen``: unit rows [CHUNK, D] and the
    positions of its planted sources; seeded with ``CORPUS_SEED``, the
    64 calls give the main path's corpus."""
    import torch
    x = unit_rows(CHUNK, D, gen, device)
    pick = torch.randint(0, CHUNK, (N_PLANTED // (N_ROWS // CHUNK),),
                         generator=gen, device=device)
    return x, pick


def small_checks(device) -> None:
    """Ragged shapes, every scheme and bit width: kernel == plain."""
    import torch
    from repro_torch.core import packing, prng
    from repro_torch.core.schemes import CodeSpec, sample_offsets
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(7)
    for scheme, w in (("sign", 1.0), ("2bit", 0.75), ("uniform", 0.75),
                      ("offset", 1.0)):
        spec = CodeSpec(scheme, w)
        for m, d, k in ((1000, 96, 100), (129, 1024, 256), (7, 33, 17),
                        (300, 33, 256)):
            x = unit_rows(m, d, gen, device)
            r = torch.randn((d, k), generator=gen, device=device)
            q = (sample_offsets(prng.PRNGKey(m), k, w).to(device)
                 if scheme == "offset" else None)
            z = torch.matmul(x, r)
            want = ref.coded_project_ref(x, r, spec, q)
            got = ops.coded_project(x, r, spec, q, impl="kernel")
            n1 = check_codes(got, want, z, spec, q,
                             f"coded_project {scheme} {(m, d, k)}")
            # deterministic, and one row codes alike in both kernels
            if not torch.equal(got, ops.coded_project(
                    x, r, spec, q, impl="kernel", r_split=ops.split_r(r))):
                raise AssertionError(f"coded_project {(m, d, k)}: two "
                                     f"launches differ")
            words = ops.encode_fused(x, r, spec, q, impl="kernel")
            if words.shape != (m, packing.packed_width(k, spec.bits)):
                raise AssertionError(f"encode_fused shape {tuple(words.shape)}")
            n2 = check_codes(packing.unpack_codes(words, spec.bits, k), want,
                             z, spec, q, f"encode_fused {scheme} {(m, d, k)}")
            # fields past k are zero, and the words are coded_project's
            if not torch.equal(words, packing.pack_codes(got, spec.bits)):
                raise AssertionError(f"encode_fused {(m, d, k)}: words "
                                     f"differ from coded_project's codes")
            log(f"check gemm {scheme:7s} m,d,k={m},{d},{k}: edge flips "
                f"coded_project={n1} encode_fused={n2}")
    for bits in (1, 2, 4, 8, 16):
        # both forms (16-byte loads; 4-byte loads, forced by a one-element
        # storage offset), ragged words, codes in range and over all int32
        for m, k in ((1000, 100), (3, 7), (256, 256), (4097, 257)):
            for lo, hi in ((0, 1 << bits), (-2 ** 31, 2 ** 31)):
                flat = torch.randint(lo, hi, (m * k + 1,), generator=gen,
                                     device=device, dtype=torch.int64)
                flat = flat.to(torch.int32)
                for offset in (0, 1):
                    codes = flat[offset:offset + m * k].view(m, k)
                    if not torch.equal(
                            ops.pack_codes(codes, bits, impl="kernel"),
                            ref.pack_codes_ref(codes, bits)):
                        raise AssertionError(f"pack_codes bits={bits} "
                                             f"{(m, k)} offset {offset}")
        for nq, n, k, top_k in ((33, 2000, 100, 10), (5, 37, 64, 50),
                                (8, 100_000, 256, 1024), (9, 70_000, 64, 1)):
            wq = packing.pack_codes(torch.randint(
                0, 1 << bits, (nq, k), generator=gen, device=device), bits)
            wdb = packing.pack_codes(torch.randint(
                0, 1 << bits, (n, k), generator=gen, device=device), bits)
            wdb[n // 2] = wq[0]            # an exact hit
            wdb[n // 3] = wq[0]            # and a tie with a lower id
            got = ops.packed_topk(wq, wdb, bits, k, top_k, impl="kernel")
            want = ref.packed_topk_ref(wq, wdb, bits, k, top_k)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"packed_topk bits={bits} "
                                     f"{(nq, n, k, top_k)}")
        log(f"check pack_codes + packed_topk bits={bits}: bit-exact")
    torch.cuda.synchronize()


def rand_tables(gen, nq: int, w: int, bits: int, dtype: str, device):
    """Random query tables [nq, F*P] of ``dtype`` (f32, bf16, or int8 with
    power-of-two float32 scales [nq, w])."""
    import torch
    fp = (w * (32 // bits)) << bits
    if dtype == "int8":
        t = torch.randint(-127, 128, (nq, fp), generator=gen, device=device,
                          dtype=torch.int8)
        e = torch.randint(-8, 2, (nq, w), generator=gen, device=device)
        return t, torch.pow(2.0, e.to(torch.float32))
    t = torch.randn((nq, fp), generator=gen, device=device)
    return (t.to(torch.bfloat16) if dtype == "bf16" else t), None


def same(got, want) -> bool:
    """Kernel and plain outputs (tuples): same shapes, bit-identical."""
    import torch
    return all(g.shape == w.shape and bool(torch.equal(g, w))
               for g, w in zip(got, want))


def scored_checks(device) -> None:
    """Ragged shapes for the scored-search and LSH kernels: kernel ==
    plain, bit-exact (packed_collision_counts, packed_lut_rerank,
    fused_scored_topk)."""
    import torch
    from repro_torch.core import packing
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(12)

    def words(n, k, bits):
        return packing.pack_codes(torch.randint(
            0, 1 << bits, (n, k), generator=gen, device=device), bits)

    for bits in (1, 2, 4, 8):
        # QB 64 and 128 of the tensor kernel; TMA stores where N % 4 == 0,
        # 4-byte stores on ragged N
        for nq, n, k in ((33, 2000, 100), (5, 37, 64), (9, 70_000, 64),
                         (40, 129, 256), (3, 0, 17), (129, 3004, 100),
                         (200, 65, 256)):
            for block_q in (None, 64, 128):
                wq, wdb = words(nq, k, bits), words(n, k, bits)
                got = ops.packed_collision_counts(
                    wq, wdb, bits, k, impl="kernel", block_q=block_q)
                if not same((got,), (ref.packed_collision_ref(
                        wq, wdb, bits, k),)):
                    raise AssertionError(
                        f"packed_collision_counts bits={bits} "
                        f"{(nq, n, k)} block_q={block_q}")
    log("check packed_collision_counts bits 1/2/4/8 (tensor kernel at QB "
        "64/128, TMA and 4-byte stores): bit-exact")
    for bits in (1, 2, 4):
        for dtype in ("f32", "bf16"):
            # (queries, candidates, k, top_k): random invalid slots, M in the
            # thousands, top_k above the valid count, one candidate
            for nq, m, k, top_k in ((13, 50, 33, 7), (7, 3000, 100, 10),
                                    (4, 5, 17, 9), (2, 1, 64, 3),
                                    (300, 64, 256, 10), (6, 65, 100, 70),
                                    (5, 128, 33, 10), (9, 32, 64, 40)):
                tab, _ = rand_tables(gen, nq, packing.packed_width(k, bits),
                                     bits, dtype, device)
                cand = words(nq * m, k, bits).reshape(nq, m, -1)
                valid = torch.rand((nq, m), generator=gen, device=device) > 0.3
                got = ops.packed_lut_rerank(tab, cand, valid, bits, top_k,
                                            impl="kernel")
                want = ref.packed_lut_rerank_ref(tab, cand, valid, bits, top_k)
                if not same(got, want):
                    raise AssertionError(f"packed_lut_rerank bits={bits} "
                                         f"{dtype} {(nq, m, k, top_k)}")
            # all candidates tied: equal rows, so positions ascending
            tab, _ = rand_tables(gen, 3, packing.packed_width(33, bits), bits,
                                 dtype, device)
            cand = words(3, 33, bits)[:, None, :].expand(3, 40, -1).contiguous()
            valid = torch.ones((3, 40), dtype=torch.bool, device=device)
            got = ops.packed_lut_rerank(tab, cand, valid, bits, 12,
                                        impl="kernel")
            if not same(got, ref.packed_lut_rerank_ref(tab, cand, valid, bits,
                                                       12)):
                raise AssertionError(f"packed_lut_rerank tied bits={bits}")
        log(f"check packed_lut_rerank bits={bits} f32/bf16: bit-exact")
        for dtype in ("f32", "bf16", "int8"):
            # (queries, rows, k, rerank_m, top_k): rerank_m > N, top_k above
            # the survivors, N not a multiple of any tile, N = 0
            for nq, n, k, m, top_k in ((3, 37, 17, 9, 7), (5, 130, 33, 32, 7),
                                       (9, 5000, 64, 64, 10),
                                       (4, 20, 33, 30, 10),
                                       (6, 3000, 100, 3, 10),
                                       (17, 70_000, 256, 256, 50),
                                       (3, 0, 17, 5, 4)):
                wq, wdb = words(nq, k, bits), words(n, k, bits)
                if n:
                    wdb[n // 2] = wq[0]
                    wdb[n // 3] = wq[0]
                tab, scl = rand_tables(gen, nq, wq.shape[1], bits, dtype,
                                       device)
                got = ops.fused_scored_topk(wq, tab, wdb, bits, k, m, top_k,
                                            scales=scl, impl="kernel")
                want = ref.fused_scored_topk_ref(wq, tab, wdb, bits, k, m,
                                                 top_k, scales=scl)
                if not same(got, want):
                    raise AssertionError(f"fused_scored_topk bits={bits} "
                                         f"{dtype} {(nq, n, k, m, top_k)}")
            # every row tied on count and score: ids ascending
            wq = words(4, 50, bits)
            wdb = wq[1:2].expand(600, -1).contiguous()
            tab, scl = rand_tables(gen, 4, wq.shape[1], bits, dtype, device)
            got = ops.fused_scored_topk(wq, tab, wdb, bits, 50, 40, 12,
                                        scales=scl, impl="kernel")
            if not same(got, ref.fused_scored_topk_ref(wq, tab, wdb, bits, 50,
                                                       40, 12, scales=scl)):
                raise AssertionError(f"fused_scored_topk tied bits={bits}")
        log(f"check fused_scored_topk bits={bits} f32/bf16/int8: bit-exact")
    # 8- and 16-bit tables too large for shared memory: read from device
    # memory
    for bits, k in ((8, 400), (16, 40)):
        for dtype in ("f32", "bf16", "int8"):
            wq, wdb = words(3, k, bits), words(900, k, bits)
            wdb[5] = wq[0]
            tab, scl = rand_tables(gen, 3, wq.shape[1], bits, dtype, device)
            got = ops.fused_scored_topk(wq, tab, wdb, bits, k, 20, 7,
                                        scales=scl, impl="kernel")
            if not same(got, ref.fused_scored_topk_ref(wq, tab, wdb, bits, k,
                                                       20, 7, scales=scl)):
                raise AssertionError(f"fused_scored_topk bits={bits} {dtype}")
            if dtype == "int8":
                continue
            cand = wdb[:150].reshape(3, 50, -1)
            valid = torch.rand((3, 50), generator=gen, device=device) > 0.3
            got = ops.packed_lut_rerank(tab, cand, valid, bits, 7,
                                        impl="kernel")
            if not same(got, ref.packed_lut_rerank_ref(tab, cand, valid, bits,
                                                       7)):
                raise AssertionError(f"packed_lut_rerank bits={bits} {dtype}")
    log("check fused_scored_topk + packed_lut_rerank bits 8/16 (tables in "
        "device memory): bit-exact")
    torch.cuda.synchronize()


def masked_checks(device) -> None:
    """Ragged shapes for the mutable index's masked kernels: kernel ==
    plain, bit-exact (packed_topk_masked, fused_scored_topk_masked)."""
    import torch
    from repro_torch.core import packing
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(13)

    def words(n, k, bits):
        return packing.pack_codes(torch.randint(
            0, 1 << bits, (n, k), generator=gen, device=device), bits)

    def mask(n, dead):
        return packing.pack_bitmask(
            torch.rand((n,), generator=gen, device=device) >= dead)

    # N: empty, one row, inside one mask word, across two, several ranges;
    # dead share: all, none, 10 %, 90 %
    sizes, deads = (0, 1, 31, 33, 3000), (1.0, 0.0, 0.1, 0.9)
    for bits in (1, 2, 4, 8, 16):
        for n in sizes:
            wq, wdb = words(5, 100, bits), words(n, 100, bits)
            if n:
                wdb[n // 2] = wq[0]
                wdb[n // 3] = wq[0]            # a tie with a lower id
            for dead in deads:
                valid = mask(n, dead)
                # top_k above the live count where the limit allows
                for top_k in (1, 10, min(n + 5, 2048)):
                    got = ops.packed_topk_masked(wq, wdb, valid, bits, 100,
                                                 top_k, impl="kernel")
                    if not same(got, ref.packed_topk_masked_ref(
                            wq, wdb, valid, bits, 100, top_k)):
                        raise AssertionError(
                            f"packed_topk_masked bits={bits} n={n} "
                            f"dead={dead} top_k={top_k}")
        # every row tied, half dead: live ids ascending
        wq = words(3, 100, bits)
        wdb = wq[1:2].expand(700, -1).contiguous()
        valid = mask(700, 0.5)
        if not same(ops.packed_topk_masked(wq, wdb, valid, bits, 100, 400,
                                           impl="kernel"),
                    ref.packed_topk_masked_ref(wq, wdb, valid, bits, 100,
                                               400)):
            raise AssertionError(f"packed_topk_masked tied bits={bits}")
    log("check packed_topk_masked bits 1/2/4/8/16, N 0/1/31/33/3000, dead "
        "all/none/10 %/90 %, top_k above the live rows, all tied: bit-exact")
    for bits in (1, 2, 4, 8, 16):
        k = 40 if bits == 16 else 100       # 16-bit tables are 10 MB a query
        for dtype in ("f32", "bf16", "int8"):
            for n in sizes:
                wq, wdb = words(4, k, bits), words(n, k, bits)
                if n:
                    wdb[n // 2] = wq[0]
                    wdb[n // 3] = wq[0]
                tab, scl = rand_tables(gen, 4, wq.shape[1], bits, dtype,
                                       device)
                for dead in deads:
                    valid = mask(n, dead)
                    # rerank_m below and above the live count
                    for m, top_k in ((16, 10), (min(n + 3, 2048), 12)):
                        got = ops.fused_scored_topk_masked(
                            wq, tab, wdb, valid, bits, k, m, top_k,
                            scales=scl, impl="kernel")
                        if not same(got, ref.fused_scored_topk_masked_ref(
                                wq, tab, wdb, valid, bits, k, m, top_k,
                                scales=scl)):
                            raise AssertionError(
                                f"fused_scored_topk_masked bits={bits} "
                                f"{dtype} n={n} dead={dead} m={m}")
            wq = words(3, k, bits)
            wdb = wq[1:2].expand(700, -1).contiguous()
            valid = mask(700, 0.5)
            tab, scl = rand_tables(gen, 3, wq.shape[1], bits, dtype, device)
            if not same(ops.fused_scored_topk_masked(
                    wq, tab, wdb, valid, bits, k, 300, 40, scales=scl,
                    impl="kernel"),
                    ref.fused_scored_topk_masked_ref(
                        wq, tab, wdb, valid, bits, k, 300, 40, scales=scl)):
                raise AssertionError(f"fused_scored_topk_masked tied "
                                     f"bits={bits} {dtype}")
    log("check fused_scored_topk_masked bits 1/2/4/8/16, f32/bf16/int8, N "
        "0/1/31/33/3000, dead all/none/10 %/90 %, rerank_m below and above "
        "the live rows, all tied: bit-exact")
    torch.cuda.synchronize()


def encode_checks(device) -> None:
    """Ragged shapes for the encode kernels: code_pack against its plain
    version over every scheme; the R draw against the CPU's plain
    ``prng`` on all 2^23 mantissas, on whole units and on units 0, 1 and
    789 of the URL sketch, and the grouped draw against one unit a
    launch; the CSR step of one unit against its plain version on empty
    rows, no entries, repeated columns, a row wholly in the ragged last
    unit and rows across many units; the grouped step at G = 1, 3 and 8
    against its plain version and the step of one unit. All bit-exact."""
    import torch
    from repro_torch.core import packing, prng
    from repro_torch.core.schemes import CodeSpec
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(14)
    for scheme, w in (("sign", 1.0), ("2bit", 0.75), ("uniform", 0.75),
                      ("offset", 1.0)):
        spec = CodeSpec(scheme, w)
        for k in (1, 7, 31, 256):
            q = (torch.rand((k,), generator=gen, device=device) * w
                 if scheme == "offset" else None)
            for m in (0, 1, 33, 3000):
                z = 3.0 * torch.randn((m, k), generator=gen, device=device)
                z[:, ::3] = torch.round(z[:, ::3] / w) * w   # on bin edges
                got = ops.code_pack(z, spec, q, impl="kernel")
                if got.shape != (m, packing.packed_width(k, spec.bits)) or \
                        not torch.equal(got, ref.code_pack_ref(z, spec, q)):
                    raise AssertionError(f"code_pack {scheme} m={m} k={k}")
    log("check code_pack sign/2bit/uniform/offset, M 0/1/33/3000, K "
        "1/7/31/256, a third of the values on bin edges: bit-exact")

    t0 = time.perf_counter()
    bits = torch.arange(1 << 23, dtype=torch.int64) << 9
    want = prng.normal_from_bits(bits)                 # on the CPU
    got = ops.normal_from_bits(packing.as_i32(bits).to(device),
                               impl="kernel")
    if not torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)):
        n_bad = int((got.cpu().view(torch.int32)
                     != want.view(torch.int32)).sum())
        raise AssertionError(f"normal draw: {n_bad} of 2^23 mantissas differ "
                             f"from the CPU's plain version")
    log(f"check normal draw on all 2^23 mantissas: bit-identical to the "
        f"CPU's prng ({time.perf_counter() - t0:.1f} s)")
    key = prng.fold_in(prng.PRNGKey(2 ** 31 + 5), 77)
    for width in (1, 217, 4096):
        for k in (1, 7, 256):
            got = ops.normal_unit(key, width, k, device, impl="kernel")
            if not torch.equal(got.cpu().view(torch.int32),
                               prng.normal(key, (width, k)).view(torch.int32)):
                raise AssertionError(f"normal_unit width={width} k={k}")
    url = CodedRandomProjection(SketchConfig(k=K, scheme="2bit", w=0.75,
                                             seed=0), URL_D)
    for u in (0, 1, url.n_units - 1):
        width = url.unit_width(u)
        got = url._block_r(u, width, impl="kernel")
        want = prng.normal(prng.fold_in(url._key, u), (width, K))
        if not torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32)):
            raise AssertionError(f"URL unit {u} ({width} rows) differs")
    log(f"check normal_unit: widths 1/217/4096 x k 1/7/256 and URL units 0, "
        f"1 and {url.n_units - 1} ({url.unit_width(url.n_units - 1)} rows): "
        f"bit-identical to the CPU's prng")
    # the grouped draw against one unit a launch: a run of 8 from unit 0,
    # one ending at unit 789 (217 rows) with unit 785 not drawn, bf16 too
    for dtype, units in ((torch.float32, list(range(8))),
                         (torch.float32, [782, 783, 784, 786, 787, 788, 789]),
                         (torch.bfloat16, [782, 783, 789])):
        crp_t = url if dtype == torch.float32 else CodedRandomProjection(
            SketchConfig(k=K, seed=0, dtype="bfloat16"), URL_D)
        out = torch.full((8, crp_t.cfg.r_unit, K), 3.0, device=device,
                         dtype=dtype)
        crp_t._draw_units(units, out, impl="kernel")
        for u in units:
            want = crp_t._block_r(u, crp_t.unit_width(u), impl="kernel")
            if not same_bits(out[u - units[0], :want.shape[0]], want):
                raise AssertionError(f"grouped draw: unit {u} ({dtype})")
        for g in set(range(8)) - {u - units[0] for u in units}:
            if not bool((out[g] == 3.0).all()):
                raise AssertionError(f"grouped draw wrote slot {g}")
    log("check normal_unit_group: units 0-7, 782-789 (785 not given, 789 "
        "of 217 rows) and bf16 782, 783, 789 in one launch each: "
        "bit-identical to one unit a launch; slots not given untouched")

    d, ru = 10_000, 1024                  # 10 units, the last 784 columns
    for k in (7, 256, 300):
        for n, rows_nnz in ((200, 60), (5, 0), (3, 3000)):
            lens = torch.randint(0, rows_nnz + 1, (n,), generator=gen,
                                 device=device)
            lens[::7] = 0
            indptr = torch.cat([torch.zeros(1, dtype=torch.int64,
                                            device=device),
                                torch.cumsum(lens, 0)])
            nnz = int(indptr[-1])
            cols = torch.randint(0, d, (nnz,), generator=gen, device=device,
                                 dtype=torch.int32)
            if n > 5 and int(lens[5]):      # row 5 wholly in the last unit
                a = int(indptr[5])
                cols[a:a + int(lens[5])] = d - 1 - torch.arange(
                    int(lens[5]), device=device, dtype=torch.int32) % 9
            if n > 3 and int(lens[3]) > 4:  # repeated columns in row 3
                a = int(indptr[3])
                cols[a + 1:a + 4] = cols[a]
            data = torch.randn((nnz,), generator=gen, device=device)
            acc_k = torch.randn((n, k), generator=gen, device=device)
            acc_r = acc_k.clone()
            for u in range((d + ru - 1) // ru):
                r = torch.randn((min(ru, d - u * ru), k), generator=gen,
                                device=device)
                ops.csr_unit_step(acc_k, indptr, cols, data, r, u * ru,
                                  impl="kernel")
                ops.csr_unit_step(acc_r, indptr, cols, data, r, u * ru,
                                  impl="ref")
            if not torch.equal(acc_k.view(torch.int32),
                               acc_r.view(torch.int32)):
                raise AssertionError(f"csr_unit_step k={k} n={n} nnz={nnz}")
    log("check csr_unit_step k 7/256/300 over 10 units (ragged last), empty "
        "rows, no entries, repeated columns, a row in the last unit only, "
        "3,000-entry rows: bit-exact")

    # the grouped step at G = 1, 3 and 8 against its plain version and the
    # step of one unit a launch; unit 4 without entries (its slot NaN);
    # rows of up to 300 entries, past the 128 a warp holds in registers
    for k in (7, 256, 300):
        for dtype in (torch.float32, torch.bfloat16):
            lens = torch.randint(0, 301, (300,), generator=gen,
                                 device=device)
            lens[::7] = 0
            indptr = torch.cat([torch.zeros(1, dtype=torch.int64,
                                            device=device),
                                torch.cumsum(lens, 0)])
            cols = torch.randint(0, d, (int(indptr[-1]),), generator=gen,
                                 device=device, dtype=torch.int32)
            cols[cols // ru == 4] += ru
            data = torch.randn(cols.shape, generator=gen, device=device)
            units = [torch.randn((min(ru, d - u * ru), k), generator=gen,
                                 device=device).to(dtype) for u in range(10)]
            acc0 = torch.randn((300, k), generator=gen, device=device)
            acc_u = acc0.clone()
            for u, r in enumerate(units):
                ops.csr_unit_step(acc_u, indptr, cols, data, r, u * ru,
                                  impl="kernel")
            for group in (1, 3, 8):
                acc_k, acc_r = acc0.clone(), acc0.clone()
                for u0 in range(0, 10, group):
                    span = min(group * ru, d - u0 * ru)
                    r = torch.full((-(-span // ru), ru, k), float("nan"),
                                   device=device, dtype=dtype)
                    for g in range(r.shape[0]):
                        if u0 + g != 4:
                            r[g, :units[u0 + g].shape[0]] = units[u0 + g]
                    for acc, impl in ((acc_k, "kernel"), (acc_r, "ref")):
                        ops.csr_group_step(acc, indptr, cols, data, r,
                                           u0 * ru, span, impl=impl)
                if not (same_bits(acc_k, acc_r) and same_bits(acc_k, acc_u)):
                    raise AssertionError(f"csr_group_step G={group} k={k} "
                                         f"{dtype}")
    log("check csr_group_step G 1/3/8 x k 7/256/300 x float32/bf16 R over 10 "
        "units (ragged last, unit 4 empty, its slot NaN), rows of 0-300 "
        "entries: bit-exact against the plain version and the step of one "
        "unit a launch")
    torch.cuda.synchronize()


def same_bits(got, want) -> bool:
    """Float tensors of one shape, bit for bit (-0.0 apart from 0.0)."""
    import torch
    return got.shape == want.shape and bool(torch.equal(
        got.view(torch.int32), want.view(torch.int32)))


def linear_checks(device) -> None:
    """Ragged shapes for the packed-linear kernels (forward, backward,
    both masked): kernel == plain, bit for bit, over bits 1/2/4/8 x k
    33/100/256 (phantom field slots) x C 1/3/8/9 and one C above the
    forward's shared-memory class tile x N 0/1/31/33/3,000 x block_n
    32/512 x all, none, 10 % and 90 % of the rows dead; 16-bit fields at
    k = 33 and N up to 300."""
    import torch
    from repro_torch.core import packing
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.packed_linear import fwd_class_tile
    gen = torch.Generator(device=device).manual_seed(15)
    deads = (1.0, 0.0, 0.1, 0.9)

    def check(name, got, want, *what):
        if not same_bits(got, want):
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"{what}")

    def grid(bits, k, classes, sizes):
        codes = torch.randint(0, 1 << bits, (max(sizes), k), generator=gen,
                              device=device)
        words_all = packing.pack_codes(codes, bits)
        fp = (words_all.shape[1] * (32 // bits)) << bits
        for c in classes:
            tab = torch.randn((c, fp), generator=gen, device=device)
            g_all = torch.randn((c, max(sizes)), generator=gen, device=device)
            for n in sizes:
                words, g = words_all[:n], g_all[:, :n].contiguous()
                masks = [packing.pack_bitmask(torch.rand(
                    (n,), generator=gen, device=device) >= d) for d in deads]
                what = (bits, k, c, n)
                check("packed_linear_fwd",
                      ops.packed_linear_fwd(tab, words, bits, impl="kernel"),
                      ref.packed_linear_fwd_ref(tab, words, bits), *what)
                for d, vw in zip(deads, masks):
                    check("packed_linear_fwd_masked",
                          ops.packed_linear_fwd_masked(tab, words, vw, bits,
                                                       impl="kernel"),
                          ref.packed_linear_fwd_masked_ref(tab, words, vw,
                                                           bits), *what, d)
                for bn in (32, 512):
                    check("packed_linear_bwd",
                          ops.packed_linear_bwd(g, words, bits, impl="kernel",
                                                block_n=bn),
                          ref.packed_linear_bwd_ref(g, words, bits,
                                                    block_n=bn), *what, bn)
                    for d, vw in zip(deads, masks):
                        check("packed_linear_bwd_masked",
                              ops.packed_linear_bwd_masked(
                                  g, words, vw, bits, impl="kernel",
                                  block_n=bn),
                              ref.packed_linear_bwd_masked_ref(
                                  g, words, vw, bits, block_n=bn),
                              *what, bn, d)

    above = []
    for bits in (1, 2, 4, 8):
        for k in (33, 100, 256):
            fp = (packing.packed_width(k, bits) * (32 // bits)) << bits
            tile = fwd_class_tile(fp)
            classes = (1, 3, 8, 9) + ((tile + 1,) if 0 < tile < 64 else ())
            if 0 < tile < 64:
                above.append(f"{bits}-bit k={k}: C={tile + 1}")
            grid(bits, k, classes, (0, 1, 31, 33, 3000))
    grid(16, 33, (1, 3), (0, 1, 31, 33, 300))
    # partials folded in groups of 3 chunks: the order must not change
    from repro_torch.kernels import packed_linear
    words = packing.pack_codes(torch.randint(0, 4, (3000, 256), generator=gen,
                                             device=device), 2)
    g = torch.randn((3, 3000), generator=gen, device=device)
    vw = packing.pack_bitmask(torch.rand((3000,), generator=gen,
                                         device=device) >= 0.1)
    keep = packed_linear.PART_BYTES_MAX
    packed_linear.PART_BYTES_MAX = 3 * 4 * 3 * 1024
    try:
        check("packed_linear_bwd", ops.packed_linear_bwd(
            g, words, 2, impl="kernel", block_n=32),
            ref.packed_linear_bwd_ref(g, words, 2, block_n=32), "groups of 3")
        check("packed_linear_bwd_masked", ops.packed_linear_bwd_masked(
            g, words, vw, 2, impl="kernel", block_n=32),
            ref.packed_linear_bwd_masked_ref(g, words, vw, 2, block_n=32),
            "groups of 3")
    finally:
        packed_linear.PART_BYTES_MAX = keep
    log(f"check packed_linear fwd/bwd and masked: bits 1/2/4/8 x k 33/100/256"
        f" x C 1/3/8/9 and above the class tile ({'; '.join(above)}) x N "
        f"0/1/31/33/3000 x block_n 32/512 x dead all/none/10 %/90 %; 16-bit "
        f"at k=33 (two groups of partials); 2-bit backward in groups of 3 "
        f"chunks: bit-exact")
    linear_bwd_grid(device)
    linear_fwd_grid(device)
    torch.cuda.synchronize()


def linear_fwd_grid(device) -> None:
    """The forward's ragged grid, both forms, bit for bit against the plain
    versions: N 255, 256, 257, 513 and 1,000 across its 256-row tiles x
    its planned grid and ``FWD_BLOCKS_MAX`` shrunk to 2 (a block then walks
    several row tiles) x rows 16-byte aligned and shifted by one word
    (4-byte loads) x all, none, 10 % and 90 % of the rows dead, at bits
    1/2/4/8 x C 1/3/8/9 and one C above the class tile (16-bit fields,
    always the memory form, at C 1 and 3); then ``SMEM_TABLE_MAX`` shrunk
    below one class's tables, so that bits 1/2/4/8 take the memory
    form."""
    import torch
    from repro_torch.core import packing
    from repro_torch.kernels import ops, packed_linear, ref
    gen = torch.Generator(device=device).manual_seed(22)
    deads = (1.0, 0.0, 0.1, 0.9)
    n_checks = 0

    def check(got, want, *what):
        nonlocal n_checks
        n_checks += 1
        if not same_bits(got, want):
            raise AssertionError(f"packed_linear_fwd differs from its plain "
                                 f"version at {what}")

    def both(tab, words, bits, *what):
        check(ops.packed_linear_fwd(tab, words, bits, impl="kernel"),
              ref.packed_linear_fwd_ref(tab, words, bits), *what)
        for d in deads:
            vw = packing.pack_bitmask(torch.rand(
                (words.shape[0],), generator=gen, device=device) >= d)
            check(ops.packed_linear_fwd_masked(tab, words, vw, bits,
                                               impl="kernel"),
                  ref.packed_linear_fwd_masked_ref(tab, words, vw, bits),
                  *what, d)

    walks = []
    keep = packed_linear.FWD_BLOCKS_MAX
    try:
        for bits, k in ((1, 100), (2, 33), (2, 256), (4, 100), (8, 33),
                        (16, 33)):
            flat = packing.pack_codes(torch.randint(
                0, 1 << bits, (1001, k), generator=gen, device=device),
                bits).reshape(-1)
            w = flat.shape[0] // 1001
            fp = (w * (32 // bits)) << bits
            tile = packed_linear.fwd_class_tile(fp)
            classes = (1, 3) if bits == 16 else \
                (1, 3, 8, 9) + ((tile + 1,) if 0 < tile < 64 else ())
            for c in classes:
                tab = torch.randn((c, fp), generator=gen, device=device)
                for n in (255, 256, 257, 513, 1000):
                    for shift in (0, 1):
                        words = flat[shift:shift + n * w].view(n, w)
                        for blocks in (keep, 2):
                            packed_linear.FWD_BLOCKS_MAX = blocks
                            p = packed_linear.fwd_plan(n, w, bits, c,
                                                       device=device)
                            if p["form"] != ("mem" if bits == 16 else
                                             "smem"):
                                raise AssertionError(f"{bits}-bit k={k} "
                                                     f"C={c} plans {p}")
                            if blocks == 2 and n == 1000 and shift == 0 \
                                    and bits != 16:
                                walks.append(p["tiles_per_block"])
                            both(tab, words, bits, bits, k, c, n, shift,
                                 blocks)
    finally:
        packed_linear.FWD_BLOCKS_MAX = keep
    if min(walks) < 2:
        raise AssertionError("a grid of two blocks walks one row tile")
    keep = packed_linear.SMEM_TABLE_MAX
    try:
        packed_linear.SMEM_TABLE_MAX = 64
        for bits, k in ((1, 100), (2, 256), (4, 100), (8, 33)):
            words_all = packing.pack_codes(torch.randint(
                0, 1 << bits, (1000, k), generator=gen, device=device), bits)
            w = words_all.shape[1]
            fp = (w * (32 // bits)) << bits
            for c in (1, 3, 9):
                if packed_linear.fwd_plan(1000, w, bits, c,
                                          device=device)["form"] != "mem":
                    raise AssertionError(f"{bits}-bit tables past the "
                                         f"budget do not plan the memory "
                                         f"form")
                tab = torch.randn((c, fp), generator=gen, device=device)
                for n in (1, 33, 1000):
                    both(tab, words_all[:n], bits, bits, k, c, n,
                         "memory form")
    finally:
        packed_linear.SMEM_TABLE_MAX = keep
    log(f"check packed_linear forward grid: {n_checks} launches bit-exact "
        f"(N 255/256/257/513/1000 across 256-row tiles x the planned grid "
        f"and two blocks a class tile ({min(walks)}-{max(walks)} row tiles "
        f"a block at N = 1,000) x aligned and shifted rows x dead all/none/"
        f"10 %/90 %, bits 1/2/4/8 x C 1/3/8/9 and above the class tile, "
        f"16-bit at C 1/3; the memory form at bits 1/2/4/8)")


def linear_bwd_grid(device) -> None:
    """The backward's ragged grid, both forms, bit for bit against the plain
    versions: block_n 1, 100, 512 and 1,000 (a chunk the tiled partial
    kernel walks in several row tiles: checked from its plan) x C 1/3/8/9 x
    N 0/1/31/33/99/100/101/1,000 (chunk and mask-word edges) x all, none,
    10 % and 90 % of the rows dead, at 1-, 2-, 4- and 8-bit fields (16-bit
    at C 1 and 3, N up to 101); then ``PART_BYTES_MAX`` shrunk to three
    chunks' partials, so that the chunks fold in several groups; the
    device-memory form at 1-, 2- and 4-bit fields (a block's shared memory
    shrunk below two one-row slots); and the partial kernel and the fold
    run apart, equal to the whole."""
    import torch
    from repro_torch.core import packing
    from repro_torch.kernels import ops, packed_linear, ref
    gen = torch.Generator(device=device).manual_seed(21)
    deads = (1.0, 0.0, 0.1, 0.9)
    sizes = (0, 1, 31, 33, 99, 100, 101, 1000)
    blocks = (1, 100, 512, 1000)
    n_checks = 0

    def check(got, want, *what):
        nonlocal n_checks
        n_checks += 1
        if not same_bits(got, want):
            raise AssertionError(f"packed_linear_bwd differs from its plain "
                                 f"version at {what}")

    def masks(n):
        return [packing.pack_bitmask(torch.rand((n,), generator=gen,
                                                device=device) >= d)
                for d in deads]

    tiles = {}
    for bits, k, classes, ns in ((1, 100, (1, 3, 8, 9), sizes),
                                 (2, 256, (1, 3, 8, 9), sizes),
                                 (2, 33, (1, 3, 8, 9), sizes),
                                 (4, 100, (1, 3, 8, 9), sizes),
                                 (8, 33, (1, 3, 8, 9), sizes),
                                 (16, 17, (1, 3), (0, 1, 33, 101))):
        words_all = packing.pack_codes(torch.randint(
            0, 1 << bits, (max(ns), k), generator=gen, device=device), bits)
        w = words_all.shape[1]
        for c in classes:
            p = packed_linear.bwd_plan(1000, w, bits, c, 1000, sms=1,
                                       blocks_per_sm=1)
            if p["form"] == "tiled":
                tiles[f"{bits}-bit k={k} C={c}"] = p["tiles_per_chunk"]
                if p["tiles_per_chunk"] < 2:
                    raise AssertionError(f"block_n 1000 fits one slot at "
                                         f"{bits}-bit k={k} C={c}")
            g_all = torch.randn((c, max(ns)), generator=gen, device=device)
            for n in ns:
                words, g = words_all[:n], g_all[:, :n].contiguous()
                vws = masks(n)
                for bn in blocks:
                    check(ops.packed_linear_bwd(g, words, bits, impl="kernel",
                                                block_n=bn),
                          ref.packed_linear_bwd_ref(g, words, bits,
                                                    block_n=bn),
                          bits, k, c, n, bn)
                    for d, vw in zip(deads, vws):
                        check(ops.packed_linear_bwd_masked(
                            g, words, vw, bits, impl="kernel", block_n=bn),
                            ref.packed_linear_bwd_masked_ref(
                                g, words, vw, bits, block_n=bn),
                            bits, k, c, n, bn, d)
    # partials in groups of three chunks (ten chunks of 100 rows)
    keep = packed_linear.PART_BYTES_MAX
    try:
        for bits, k, c in ((1, 100, 3), (2, 256, 9), (4, 100, 8), (8, 33, 3)):
            words = packing.pack_codes(torch.randint(
                0, 1 << bits, (1000, k), generator=gen, device=device), bits)
            fp = (words.shape[1] * (32 // bits)) << bits
            g = torch.randn((c, 1000), generator=gen, device=device)
            packed_linear.PART_BYTES_MAX = 3 * 4 * c * fp
            check(ops.packed_linear_bwd(g, words, bits, impl="kernel",
                                        block_n=100),
                  ref.packed_linear_bwd_ref(g, words, bits, block_n=100),
                  bits, k, c, "groups of 3")
            for d, vw in zip(deads, masks(1000)):
                check(ops.packed_linear_bwd_masked(g, words, vw, bits,
                                                   impl="kernel", block_n=100),
                      ref.packed_linear_bwd_masked_ref(g, words, vw, bits,
                                                       block_n=100),
                      bits, k, c, d, "groups of 3")
    finally:
        packed_linear.PART_BYTES_MAX = keep
    # the device-memory form at 1-, 2- and 4-bit fields, which rows too
    # wide for two shared-memory slots take: reached by shrinking a block's
    # shared memory
    keep = packed_linear.SMEM_BLOCK_MAX
    try:
        packed_linear.SMEM_BLOCK_MAX = 64
        for bits, k in ((1, 100), (2, 256), (4, 100)):
            words_all = packing.pack_codes(torch.randint(
                0, 1 << bits, (1000, k), generator=gen, device=device), bits)
            for c in (1, 3):
                if packed_linear.bwd_plan(1000, words_all.shape[1], bits, c,
                                          100)["form"] != "mem":
                    raise AssertionError(f"{bits}-bit rows past a block's "
                                         f"shared memory do not plan the "
                                         f"memory form")
                g_all = torch.randn((c, 1000), generator=gen, device=device)
                for n in (33, 1000):
                    words, g = words_all[:n], g_all[:, :n].contiguous()
                    for bn in (32, 100):
                        check(ops.packed_linear_bwd(g, words, bits,
                                                    impl="kernel",
                                                    block_n=bn),
                              ref.packed_linear_bwd_ref(g, words, bits,
                                                        block_n=bn),
                              bits, k, c, n, bn, "memory form")
                        for d, vw in zip(deads, masks(n)):
                            check(ops.packed_linear_bwd_masked(
                                g, words, vw, bits, impl="kernel",
                                block_n=bn),
                                ref.packed_linear_bwd_masked_ref(
                                    g, words, vw, bits, block_n=bn),
                                bits, k, c, n, bn, d, "memory form")
    finally:
        packed_linear.SMEM_BLOCK_MAX = keep
    # the two halves apart: fold(partials) is the whole backward
    words = packing.pack_codes(torch.randint(0, 4, (3000, 256), generator=gen,
                                             device=device), 2)
    vw = masks(3000)[2]
    for c in (1, 8):
        g = torch.randn((c, 3000), generator=gen, device=device)
        for v in (None, vw):
            part = packed_linear.bwd_partials_cuda(g, words, 2, 100,
                                                   valid_words=v)
            check(packed_linear.bwd_fold_cuda(part),
                  packed_linear.packed_linear_bwd_cuda(g, words, 2, 100,
                                                       valid_words=v),
                  "halves apart", c, v is not None)
    log(f"check packed_linear backward grid: {n_checks} launches bit-exact "
        f"(block_n 1/100/512/1000 x C 1/3/8/9 x N 0-1000 across chunk and "
        f"mask-word edges x dead all/none/10 %/90 %, bits 1/2/4/8, 16-bit at "
        f"C 1/3; groups of 3 chunks; the memory form at bits 1/2/4; partial "
        f"kernel and fold apart); row "
        f"tiles a 1,000-row chunk: "
        f"{', '.join(f'{k} {v}' for k, v in tiles.items())}")


def kernel_phase(crp, device) -> dict:
    """Main-path shapes: each kernel vs its plain version, times, bounds."""
    import torch
    from repro_torch.core import packing
    from repro_torch.kernels import ops, ref
    spec, r, q = crp.spec, crp.stream_encoder().r_matrix(), crp._offsets
    bits, w_words = spec.bits, packing.packed_width(K, spec.bits)
    gen = torch.Generator(device=device).manual_seed(11)
    rows = {}

    # the kernels as the encoder calls them: R split once, beside R
    t0 = time.perf_counter()
    r_split = crp.stream_encoder().r_split()
    torch.cuda.synchronize()
    split_ms = 1e3 * (time.perf_counter() - t0)
    products = 2 if r.dtype == torch.bfloat16 else 3

    def gemm_bounds(m, out_bytes):
        """(the tensor-core bound: products TF32 products a multiply-add,
        the CUDA cores' float32 bound) of one call at [m, D] x [D, K]."""
        n_bytes = 4.0 * (m * D + D * K) + out_bytes(m)
        flops = 2.0 * m * D * K
        return (bound([("tf32", products * flops, TF32_FLOP_S)], n_bytes),
                bound([("f32", flops, F32_FLOP_S)], n_bytes)[0])

    def gemm(name, m, fn_kernel, fn_plain, out_bytes):
        x = unit_rows(m, D, gen, device)
        z = torch.matmul(x, r)
        want = ref.coded_project_ref(x, r, spec, q)
        got = fn_kernel(x)
        if not torch.equal(got, fn_kernel(x)):
            raise AssertionError(f"{name}: two launches differ")
        if name == "encode_fused":
            got = packing.unpack_codes(got, bits, K)
        flips = check_codes(got, want, z, spec, q, name)
        err = int((got - want).abs().max())
        ms = time_ms(lambda: fn_kernel(x))
        plain_ms = time_ms(lambda: fn_plain(x))
        lib_ms = time_ms(lambda: torch.matmul(x, r))
        (b_ms, b_by, pipe), f32_ms = gemm_bounds(m, out_bytes)
        log(f"kernel {name}: [{m},{D}]x[{D},{K}] edge flips {flips}/{m * K}, "
            f"two launches bit-identical; ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"gemm_library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}, "
            f"{pipe} x{products}) f32_cuda_core_bound_ms={f32_ms:.4f}")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, bound_pipe=f"{pipe} x{products}",
                    library_ms=None, gemm_library_ms=lib_ms,
                    f32_bound_ms=f32_ms, shape=[m, D, K], edge_flips=flips)

    log(f"R split for the GEMM kernels (ops.split_r, once per R): "
        f"{split_ms:.3f} ms")
    rows["encode_fused"] = gemm(
        "encode_fused", CHUNK,
        lambda x: ops.encode_fused(x, r, spec, q, impl="kernel",
                                   r_split=r_split),
        lambda x: ops.encode_fused(x, r, spec, q, impl="ref"),
        lambda m: 4.0 * m * w_words)
    rows["coded_project"] = gemm(
        "coded_project", N_QUERIES,
        lambda x: ops.coded_project(x, r, spec, q, impl="kernel",
                                    r_split=r_split),
        lambda x: ops.coded_project(x, r, spec, q, impl="ref"),
        lambda m: 4.0 * m * K)
    # the serving buckets' query coding
    buckets = {}
    for m in (64, 256):
        x = unit_rows(m, D, gen, device)
        check_codes(ops.coded_project(x, r, spec, q, impl="kernel",
                                      r_split=r_split),
                    ref.coded_project_ref(x, r, spec, q), torch.matmul(x, r),
                    spec, q, f"coded_project M={m}")
        ms = time_ms(lambda: ops.coded_project(x, r, spec, q, impl="kernel",
                                               r_split=r_split))
        lib_ms = time_ms(lambda: torch.matmul(x, r))
        b_ms = gemm_bounds(m, lambda n: 4.0 * n * K)[0][0]
        buckets[m] = dict(ms=ms, gemm_library_ms=lib_ms, bound_ms=b_ms)
        log(f"kernel coded_project at the serving bucket [{m},{D}]x[{D},{K}]: "
            f"ms={ms:.4f} gemm_library_ms={lib_ms:.4f} bound_ms={b_ms:.5f}")
    rows["coded_project"]["buckets"] = buckets

    pack_codes_rows(rows, gen, bits, device)

    codes_q = torch.randint(0, 1 << bits, (CHUNK_Q, K), generator=gen,
                            device=device)
    wq = packing.pack_codes(codes_q, bits)
    wdb = torch.randint(-2 ** 31, 2 ** 31, (N_ROWS, w_words), generator=gen,
                        device=device, dtype=torch.int64).to(torch.int32)
    got = ops.packed_topk(wq, wdb, bits, K, TOP_K, impl="kernel")
    want = ref.packed_topk_ref(wq, wdb, bits, K, TOP_K)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("packed_topk differs from its plain version")
    sweep_equal("packed_topk", lambda s: ops.packed_topk(
        wq, wdb, bits, K, TOP_K, impl="kernel", n_ranges=s), want)
    # per (query, row, word) on the CUDA cores: one popcount, and besides
    # it an xor, log2(b) shifts and ors (the last or merges with the field
    # mask into one LOP3) and the add into the count
    int_word = 2 + 2 * int(math.log2(bits))
    gemm_lib = int_mm_yardstick(wq, wdb, bits)
    (b_ms, b_by, pipe), popc_ms = count_bounds(
        CHUNK_Q, N_ROWS, w_words, int_word,
        4.0 * (N_ROWS * w_words + CHUNK_Q * w_words + 2 * CHUNK_Q * TOP_K))
    rows["packed_topk"] = dict(
        max_abs_err=0,
        ms=time_ms(lambda: ops.packed_topk(wq, wdb, bits, K, TOP_K, impl="kernel")),
        plain_ms=time_ms(lambda: ref.packed_topk_ref(wq, wdb, bits, K, TOP_K),
                         reps=10, warmup=1),
        bound_ms=b_ms, bound_by=b_by, bound_pipe=pipe, library_ms=None,
        popc_bound_ms=popc_ms, gemm_library_ms=gemm_lib["ms"],
        shape=[CHUNK_Q, N_ROWS, w_words, TOP_K])
    log(f"kernel packed_topk: Q={CHUNK_Q} N={N_ROWS} W={w_words} "
        f"top_k={TOP_K} bit-exact at every S the sweep tries "
        f"ms={rows['packed_topk']['ms']:.4f} "
        f"plain_ms={rows['packed_topk']['plain_ms']:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by}, {pipe}) popc_bound_ms={popc_ms:.4f}")
    count_sweep_phase(rows, wq, wdb, bits, int_word, gemm_lib)
    scored_kernel_phase(rows, crp, codes_q, wq, wdb, gen, int_word, gemm_lib)
    masked_kernel_phase(rows, crp, codes_q, wq, wdb, gen, int_word, gemm_lib)
    serve_kernel_phase(rows, crp, codes_q, wq, wdb, gen)
    for name in ("packed_lut_rerank", "packed_lut_rerank_warp"):
        rows[name]["launch_floor_ms"] = rows["pack_codes"]["launch_floor_ms"]
    del wdb
    torch.cuda.empty_cache()
    return rows


def per_launch_ms(fn, n: int = 100, reps: int = 5) -> tuple:
    """Device ms a call over ``n`` back-to-back calls between two events,
    queued behind one spin kernel long enough for the host to enqueue them
    all (20 ms), so the events bracket the card's work alone; the median
    of ``reps`` runs -> (ms a call, the host's enqueue ms at most)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times, enqueue = [], 0.0
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10 * SPIN_CYCLES)
        t0 = time.perf_counter()
        a.record()
        for _ in range(n):
            fn()
        b.record()
        enqueue = max(enqueue, 1e3 * (time.perf_counter() - t0))
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    if enqueue >= 20.0:
        raise AssertionError(f"enqueueing {n} calls took {enqueue:.3f} ms, "
                             f"longer than the spin: a host time")
    return statistics.median(times), enqueue


# row 3's shapes: the query chunk (10 launches on the main path), a
# mutable add or upsert batch, and the dense corpus that AnnEngine.build
# packs through CodeStore.from_codes, checked in slices of PACK_SLICE rows
PACK_SHAPES = (("query_chunk", CHUNK_Q), ("add_batch", N_UPSERT),
               ("corpus", N_ROWS))
PACK_SLICE = 262_144


def pack_checked(codes, bits: int):
    """``ops.pack_codes`` of [M, K] codes on the kernel, held bit-exact to
    the plain version in slices of PACK_SLICE rows (its int64
    temporaries stay small) -> the words."""
    import torch
    from repro_torch.kernels import ops, ref
    got = ops.pack_codes(codes, bits, impl="kernel")
    for a in range(0, codes.shape[0], PACK_SLICE):
        if not torch.equal(got[a:a + PACK_SLICE], ref.pack_codes_ref(
                codes[a:a + PACK_SLICE], bits)):
            raise AssertionError(f"pack_codes {list(codes.shape)} differs "
                                 f"from its plain version at rows {a}-")
    return got


def pack_codes_rows(rows, gen, bits: int, device) -> None:
    """Row 3 (csrc/pack_codes.cu) at PACK_SHAPES, each bit-exact against
    its plain version and timed beside its bytes bound, its share of it
    and ``pack_plan``'s plan; at the query chunk also the plain version,
    the time a launch over back-to-back launches, and the launch floor (a
    one-element add, timed alike), which row 10 reports too."""
    import torch
    from repro_torch.core import packing
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import pack_codes as pk
    from repro_torch.kernels.packed_linear import _sm_count
    w_words = packing.packed_width(K, bits)
    one = torch.zeros(1, device=device, dtype=torch.int32)
    floor_ms = time_ms(lambda: one.add_(1))
    log(f"launch floor (a one-element add, time_ms): launch_floor_ms="
        f"{floor_ms:.4f}, beside rows 3 (pack_codes) and 10 "
        f"(packed_lut_rerank)")
    shapes = {}
    for name, m in PACK_SHAPES:
        codes = torch.randint(0, 1 << bits, (m, K), generator=gen,
                              device=device, dtype=torch.int32)
        pack_checked(codes, bits)
        b_ms, b_by, pipe = bound([("int32", 2.0 * m * K, INT32_OP_S)],
                                 4.0 * m * (K + w_words))
        ms = time_ms(lambda: ops.pack_codes(codes, bits, impl="kernel"))
        plan = pk.pack_plan(m, K, bits, _sm_count(device),
                            codes.data_ptr() % 16 == 0)
        shapes[name] = dict(shape=[m, K], ms=ms, bound_ms=b_ms, bound_by=b_by,
                            bound_pipe=pipe, share=b_ms / ms, plan=plan)
        more = ""
        if m == CHUNK_Q:
            shapes[name]["plain_ms"] = time_ms(
                lambda: ref.pack_codes_ref(codes, bits))
            launch_ms, enqueue = per_launch_ms(
                lambda: ops.pack_codes(codes, bits, impl="kernel"))
            shapes[name]["per_launch_ms"] = launch_ms
            more = (f" plain_ms={shapes[name]['plain_ms']:.4f}; back to back "
                    f"{launch_ms:.5f} ms a launch (100 queued in "
                    f"{enqueue:.3f} ms)")
        log(f"kernel pack_codes {name}: [{m},{K}] bit-exact ms={ms:.5f} "
            f"bound_ms={b_ms:.6f} ({b_by}, {pipe}) share "
            f"{100 * b_ms / ms:.1f} %{more}; plan {json.dumps(plan)}")
        del codes
    torch.cuda.empty_cache()
    q = shapes["query_chunk"]
    rows["pack_codes"] = dict(
        max_abs_err=0, ms=q["ms"], plain_ms=q["plain_ms"],
        bound_ms=q["bound_ms"], bound_by=q["bound_by"],
        bound_pipe=q["bound_pipe"], library_ms=None, shape=q["shape"],
        launch_floor_ms=floor_ms, per_launch_ms=q["per_launch_ms"],
        plan=q["plan"], shapes=shapes)


def int_mm_yardstick(wq, wdb, bits: int) -> dict:
    """``torch._int_mm`` of the one-hot operands at a mutable segment's
    shape, [256 x 1,024] by [1,024 x 262,144] int8: the product alone of
    the tensor-core sweep (no top-k), held to k - F + product = the
    collision counts, and timed (ms)."""
    import torch
    from repro_torch.kernels import ref
    w_words = wq.shape[1]
    a = ref.onehot_rows(wq, bits, torch.int8)
    b = ref.onehot_rows(wdb[:TAIL_ROWS], bits, torch.int8)
    bt = b.t()                      # [K, N], column-major as cuBLASLt takes it
    got = torch._int_mm(a, bt) + (K - w_words * (32 // bits))
    if not torch.equal(got, ref.packed_collision_ref(wq, wdb[:TAIL_ROWS],
                                                     bits, K)):
        raise AssertionError("k - F + onehot(q) . onehot(db) differs from the "
                             "collision counts")
    del got
    ms = time_ms(lambda: torch._int_mm(a, bt))
    shape = [a.shape[0], a.shape[1], b.shape[0]]
    log(f"yardstick torch._int_mm of the one-hot operands {shape} (int8, "
        f"the product alone; k - F + it equals the counts): ms={ms:.4f}")
    del a, b, bt
    torch.cuda.empty_cache()
    return dict(ms=ms, shape=shape)


def count_sweep_phase(rows, wq, wdb, bits: int, int_word: int,
                      gemm_lib: dict) -> None:
    """The tensor-core count sweep alone (csrc/topk_tc.cuh; the row of the
    kernels line) at the main path's shapes: the partial lists at the
    default S against their plain version, timed apart from the merge,
    at top_k 10 (row 4) and at m 64 (row 5's survivors, QB 64), with the
    plan, registers and spills."""
    import torch
    from repro_torch.kernels import packed_collision as pc
    from repro_torch.kernels import ref
    nq, w_words = wq.shape
    out = {}
    for top_k in (TOP_K, RERANK_M):
        t0 = time.perf_counter()
        p = pc.plan(nq, N_ROWS, w_words, bits, top_k, device=wq.device)
        if p["kernel"] != "tensor":
            raise AssertionError(f"the main path's sweep plans {p}")
        got = pc.packed_topk_partial_cuda(wq, wdb, None, bits, K, top_k)
        want = ref.packed_topk_partial_ref(wq, wdb, None, bits, K, top_k,
                                           p["n_ranges"])
        if not same(got, want):
            raise AssertionError(f"the tensor-core sweep's partial lists at "
                                 f"top_k {top_k} differ from their plain "
                                 f"version")
        del want
        ms = time_ms(lambda: pc.packed_topk_partial_cuda(wq, wdb, None, bits,
                                                         K, top_k))
        merge_ms = time_ms(lambda: pc.merge_ranges_cuda(*got))
        plain_ms = time_ms(lambda: ref.packed_topk_partial_ref(
            wq, wdb, None, bits, K, top_k, p["n_ranges"]), reps=3, warmup=0)
        n_bytes = 4.0 * (N_ROWS * w_words + nq * w_words
                         + 2 * p["n_ranges"] * nq * top_k)
        (b_ms, b_by, pipe), popc_ms = count_bounds(nq, N_ROWS, w_words,
                                                   int_word, n_bytes)
        out[top_k] = dict(ms=ms, merge_ms=merge_ms, plain_ms=plain_ms,
                          bound=(b_ms, b_by, pipe), popc_ms=popc_ms, plan=p)
        log(f"kernel packed_topk_tc: Q={nq} N={N_ROWS} W={w_words} "
            f"top_k={top_k} partial lists bit-exact; plan {json.dumps(p)}; "
            f"sweep ms={ms:.4f} merge ms={merge_ms:.4f} (S={p['n_ranges']}) "
            f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}, {pipe}) "
            f"popc_bound_ms={popc_ms:.4f}; phase "
            f"{time.perf_counter() - t0:.1f} s")
        del got
        torch.cuda.empty_cache()
    main, m = out[TOP_K], out[RERANK_M]
    b_ms, b_by, pipe = main["bound"]
    rows["packed_topk_tc"] = dict(
        max_abs_err=0, ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=b_ms, bound_by=b_by, bound_pipe=pipe, library_ms=None,
        popc_bound_ms=main["popc_ms"], gemm_library_ms=gemm_lib["ms"],
        gemm_library_shape=gemm_lib["shape"], merge_ms=main["merge_ms"],
        plan=main["plan"], m64=dict(ms=m["ms"], merge_ms=m["merge_ms"],
                                    plain_ms=m["plain_ms"],
                                    bound_ms=m["bound"][0], plan=m["plan"]),
        registers={k: dict(registers=r, spill_bytes=sp)
                   for k, (r, sp) in TC_PTXAS.items()},
        shape=[nq, N_ROWS, w_words, TOP_K])
    log(f"kernel packed_topk_tc registers and spill stores by (bits, QB): "
        f"{json.dumps(rows['packed_topk_tc']['registers'])}")


def scored_kernel_phase(rows, crp, codes_q, wq, wdb, gen, int_word,
                        gemm_lib) -> None:
    """The scored-search and LSH kernels at the main path's shapes, on the
    packed_topk phase's queries and corpus, with the sketcher's tables."""
    import torch
    from repro_torch.core import packing
    from repro_torch.kernels import ops, packed_lut, ref
    from repro_torch.kernels import packed_collision as pc
    from repro_torch.rank import build_rank_tables
    bits, nq = crp.spec.bits, CHUNK_Q
    w_words = packing.packed_width(K, bits)
    q_tab = build_rank_tables(crp).query_tables(codes_q)
    fp = q_tab.shape[1]

    def row(name, fn_kernel, fn_plain, want, b, shape, plain_reps=10,
            **extra):
        t0 = time.perf_counter()
        got = fn_kernel()
        if not same(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
            raise AssertionError(f"{name} differs from its plain version")
        del got, want
        ms = time_ms(fn_kernel)
        plain_ms = time_ms(fn_plain, reps=plain_reps, warmup=1)
        b_ms, b_by, pipe = b
        rows[name] = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, bound_pipe=pipe,
                          library_ms=None, shape=shape, **extra)
        more = "".join(f" {key}={extra[key]:.6f}" for key in
                       ("popc_bound_ms", "latency_floor_ms", "gemm_library_ms")
                       if key in extra)
        form = (f"; form {extra['form']}, plan {json.dumps(extra['plan'])}"
                if "form" in extra else "")
        log(f"kernel {name}: {shape} bit-exact ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}, {pipe})"
            f"{more}{form}; phase {time.perf_counter() - t0:.1f} s")

    # the least work is the one-hot product against the [Q, N] write; the
    # popcount fold beside
    counts_want = ref.packed_collision_ref(wq, wdb, bits, K)
    count_tensor, count_popc = count_bounds(
        nq, N_ROWS, w_words, int_word,
        4.0 * (N_ROWS * w_words + nq * w_words + nq * N_ROWS))
    count_plan = pc.counts_plan(nq, N_ROWS, w_words, bits,
                                device=wq.device)
    if count_plan["kernel"] != "tensor":
        raise AssertionError(f"the LSH chunk's counts plan {count_plan}")
    before = ops.launch_counts()
    row("packed_collision_counts",
        lambda: ops.packed_collision_counts(wq, wdb, bits, K, impl="kernel"),
        lambda: ref.packed_collision_ref(wq, wdb, bits, K),
        counts_want, count_tensor, [nq, N_ROWS, w_words], plain_reps=3,
        popc_bound_ms=count_popc, gemm_library_ms=gemm_lib["ms"],
        form=count_plan["kernel"], form_counter="packed_counts_tc",
        plan=count_plan)
    ran = launch_diff(before)
    if ran.get("packed_counts_tc", 0) != ran["packed_collision_counts"]:
        raise AssertionError(f"the LSH chunk's counts did not all run on the "
                             f"tensor kernel: {ran}")
    counts_tc_rows(rows, wq, wdb, bits, counts_want, count_tensor,
                   count_popc, count_plan, gemm_lib)
    del counts_want
    torch.cuda.empty_cache()
    # the least work is one count sweep: B4's one-hot product, no more
    want = ref.fused_scored_topk_ref(wq, q_tab, wdb, bits, K, RERANK_M, TOP_K)
    sweep_equal("fused_scored_topk", lambda s: ops.fused_scored_topk(
        wq, q_tab, wdb, bits, K, RERANK_M, TOP_K, impl="kernel",
        n_ranges=s), want)
    tensor, popc_ms = count_bounds(
        nq, N_ROWS, w_words, int_word,
        4.0 * (N_ROWS * w_words + nq * (w_words + fp) + 2 * nq * TOP_K))
    row("fused_scored_topk",
        lambda: ops.fused_scored_topk(wq, q_tab, wdb, bits, K, RERANK_M,
                                      TOP_K, impl="kernel"),
        lambda: ref.fused_scored_topk_ref(wq, q_tab, wdb, bits, K, RERANK_M,
                                          TOP_K),
        want, tensor, [nq, N_ROWS, w_words, RERANK_M, TOP_K], plain_reps=3,
        popc_bound_ms=popc_ms, gemm_library_ms=gemm_lib["ms"])
    torch.cuda.empty_cache()
    cand_ids = torch.randint(0, N_ROWS, (nq, RERANK_M), generator=gen,
                             device=wdb.device)
    cand = wdb[cand_ids]
    valid = torch.rand((nq, RERANK_M), generator=gen, device=wdb.device) > 0.1
    lookups = float(nq) * RERANK_M * w_words * (32 // bits)
    rerank_want = ref.packed_lut_rerank_ref(q_tab, cand, valid, bits, TOP_K)
    rerank_bound = bound([("f32 add", lookups, F32_ADD_S)],
                         4.0 * nq * (fp + RERANK_M * w_words + 2 * TOP_K)
                         + nq * RERANK_M)
    # one candidate's chain of F dependent float adds
    floor_ms = 1e3 * w_words * (32 // bits) * FADD_CLOCKS / SM_CLOCK_HZ
    rerank_plan = packed_lut.rerank_plan(nq, RERANK_M, w_words, bits,
                                         q_tab.dtype, device=wq.device)
    if rerank_plan["kernel"] != "warp":
        raise AssertionError(f"the main path's re-rank plan {rerank_plan}")
    row("packed_lut_rerank",
        lambda: ops.packed_lut_rerank(q_tab, cand, valid, bits, TOP_K,
                                      impl="kernel"),
        lambda: ref.packed_lut_rerank_ref(q_tab, cand, valid, bits, TOP_K),
        rerank_want, rerank_bound, [nq, RERANK_M, w_words, TOP_K],
        latency_floor_ms=floor_ms, form=rerank_plan["kernel"],
        form_counter="packed_lut_rerank_warp", plan=rerank_plan)
    rerank_warp_rows(rows, q_tab, cand, valid, bits, rerank_want,
                     rerank_bound, floor_ms, rerank_plan)


def counts_tc_rows(rows, wq, wdb, bits, want, tensor, popc_ms, plan,
                   gemm_lib) -> None:
    """Row 9's tensor kernel (csrc/packed_counts.cu's packed_counts_tc) at
    the LSH chunk's shape through its wrapper, bit-exact against the
    plain version, with its plan and the registers and spills of each
    instance."""
    import torch
    from repro_torch.kernels import packed_collision as pc
    nq, w_words = wq.shape
    got = pc.packed_collision_counts_cuda(wq, wdb, bits, K)
    if not torch.equal(got, want):
        raise AssertionError("packed_counts_tc differs from its plain version")
    del got
    ms = time_ms(lambda: pc.packed_collision_counts_cuda(wq, wdb, bits, K))
    torch.cuda.empty_cache()
    b_ms, b_by, pipe = tensor
    rows["packed_counts_tc"] = dict(
        max_abs_err=0, ms=ms,
        plain_ms=rows["packed_collision_counts"]["plain_ms"], bound_ms=b_ms,
        bound_by=b_by, bound_pipe=pipe, library_ms=None,
        popc_bound_ms=popc_ms, gemm_library_ms=gemm_lib["ms"],
        gemm_library_shape=gemm_lib["shape"], plan=plan,
        registers={k: dict(registers=r, spill_bytes=sp)
                   for k, (r, sp) in COUNTS_PTXAS.items()},
        shape=[nq, N_ROWS, w_words])
    log(f"kernel packed_counts_tc: Q={nq} N={N_ROWS} W={w_words} bit-exact "
        f"ms={ms:.4f} ({plan['store']} stores) bound_ms={b_ms:.4f} "
        f"({b_by}, {pipe}) popc_bound_ms={popc_ms:.4f} "
        f"plan {json.dumps(plan)}; registers and spill stores "
        f"{json.dumps(rows['packed_counts_tc']['registers'])}")


def rerank_warp_rows(rows, q_tab, cand, valid, bits, want, b, floor_ms,
                     plan) -> None:
    """Row 10's warp kernel (csrc/packed_lut.cu's lut_rerank_warp) at the
    main path's shape, and the block kernel launched apart at the same
    shape (the form the plan picks for M past a warp), each bit-exact
    against the plain version, with the plan and the registers of each
    instance."""
    import torch
    from repro_torch.kernels import packed_lut as pl
    nq, m, w_words = cand.shape
    code = pl.TABLE_DTYPES[q_tab.dtype]
    out = (torch.empty_like(want[0]), torch.empty_like(want[1]))
    form_ms = {}
    for form in ("warp", "block"):
        p = plan if form == "warp" else dict(kernel="block")
        out[0].fill_(0)
        out[1].fill_(0)
        pl._launch(p, q_tab, code, cand, valid, bits, TOP_K, *out)
        if not same(out, want):
            raise AssertionError(f"lut_rerank {form} kernel differs from its "
                                 f"plain version")
        form_ms[form] = time_ms(lambda: pl._launch(
            p, q_tab, code, cand, valid, bits, TOP_K, *out))
    b_ms, b_by, pipe = b
    rows["packed_lut_rerank_warp"] = dict(
        max_abs_err=0, ms=form_ms["warp"],
        plain_ms=rows["packed_lut_rerank"]["plain_ms"], bound_ms=b_ms,
        bound_by=b_by, bound_pipe=pipe, library_ms=None,
        latency_floor_ms=floor_ms, block_ms=form_ms["block"], plan=plan,
        registers={k: dict(registers=r, spill_bytes=sp)
                   for k, (r, sp) in RERANK_PTXAS.items()},
        shape=[nq, m, w_words, TOP_K])
    log(f"kernel packed_lut_rerank_warp: {[nq, m, w_words, TOP_K]} "
        f"bit-exact; ms={form_ms['warp']:.4f}, the block kernel at this "
        f"shape {form_ms['block']:.4f}; bound_ms={b_ms:.6f} ({b_by}) "
        f"latency floor {floor_ms:.6f} ms; plan {json.dumps(plan)}; "
        f"registers {json.dumps(rows['packed_lut_rerank_warp']['registers'])}")


def masked_kernel_phase(rows, crp, codes_q, wq, wdb, gen, int_word,
                        gemm_lib) -> None:
    """The masked kernels at the mutable path's shapes: one 262,144-row
    segment, and the whole 4,194,304-row corpus with 10 % of its rows
    dead (the row of the kernels line), on the packed_topk phase's
    queries and corpus."""
    import torch
    from repro_torch.core import packing
    from repro_torch.kernels import ops, ref
    from repro_torch.rank import build_rank_tables
    bits, nq = crp.spec.bits, CHUNK_Q
    w_words = packing.packed_width(K, bits)
    q_tab = build_rank_tables(crp).query_tables(codes_q)
    fp = q_tab.shape[1]
    segment_ms = {}
    for n in (TAIL_ROWS, N_ROWS):
        db = wdb[:n]
        live = torch.rand((n,), generator=gen, device=db.device) >= 0.1
        valid = packing.pack_bitmask(live)
        n_live = int(live.sum())
        # the least work counts live rows only (a dead row's products are
        # not needed); every row's words and the mask are read once
        db_bytes = 4.0 * n * w_words + n / 8
        cases = {
            "packed_topk_masked": (
                lambda n_ranges=None: ops.packed_topk_masked(
                    wq, db, valid, bits, K, TOP_K, impl="kernel",
                    n_ranges=n_ranges),
                lambda: ref.packed_topk_masked_ref(wq, db, valid, bits, K,
                                                   TOP_K),
                db_bytes + 4.0 * (nq * w_words + 2 * nq * TOP_K),
                [nq, n, w_words, TOP_K]),
            "fused_scored_topk_masked": (
                lambda n_ranges=None: ops.fused_scored_topk_masked(
                    wq, q_tab, db, valid, bits, K, RERANK_M, TOP_K,
                    impl="kernel", n_ranges=n_ranges),
                lambda: ref.fused_scored_topk_masked_ref(
                    wq, q_tab, db, valid, bits, K, RERANK_M, TOP_K),
                db_bytes + 4.0 * (nq * (w_words + fp) + 2 * nq * TOP_K),
                [nq, n, w_words, RERANK_M, TOP_K]),
        }
        for name, (fn_kernel, fn_plain, n_bytes, shape) in cases.items():
            t0 = time.perf_counter()
            want = fn_plain()
            if not same(fn_kernel(), want):
                raise AssertionError(f"{name} differs from its plain version "
                                     f"at N={n}")
            sweep_equal(f"{name} at N={n}",
                        lambda s: fn_kernel(n_ranges=s), want)
            del want
            ms = time_ms(fn_kernel)
            plain_ms = time_ms(fn_plain, reps=3, warmup=1)
            (b_ms, b_by, pipe), popc_ms = count_bounds(nq, n_live, w_words,
                                                       int_word, n_bytes)
            log(f"kernel {name}: {shape} live {n_live} bit-exact at every S "
                f"the sweep tries ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}, {pipe}) "
                f"popc_bound_ms={popc_ms:.4f}; phase "
                f"{time.perf_counter() - t0:.1f} s")
            if n == N_ROWS:
                rows[name] = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by,
                                  bound_pipe=pipe, library_ms=None,
                                  popc_bound_ms=popc_ms,
                                  gemm_library_ms=gemm_lib["ms"],
                                  shape=shape, live_rows=n_live,
                                  segment_ms=segment_ms[name],
                                  segment_bound_ms=segment_ms[
                                      name + " bound"])
            else:
                segment_ms[name] = ms
                segment_ms[name + " bound"] = b_ms
        torch.cuda.empty_cache()


def main_path(device) -> tuple:
    """Ingest -> store -> engine -> search -> add -> search, counted."""
    import torch
    from repro_torch.ann import AnnEngine, BandSpec, CodeStore
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    from repro_torch.kernels import ops, ref

    crp = CodedRandomProjection(SketchConfig(k=K, scheme="2bit", w=0.75,
                                             seed=0), D)
    gen = torch.Generator(device=device).manual_seed(CORPUS_SEED)
    ops.reset_launch_counts()
    # set-up, once per sketcher: R drawn on the CPU and cached on the card
    t0 = time.perf_counter()
    crp.stream_encoder().r_matrix()
    torch.cuda.synchronize()
    log(f"R set-up: {1e3 * (time.perf_counter() - t0):.3f} ms")
    # the timed window holds the sketch calls and the store's assembly
    # only: making each chunk's rows and picking its planted rows stand
    # outside it, behind a synchronisation
    words, sources, src_ids, chunk_s = [], [], [], []
    for c in range(N_ROWS // CHUNK):
        x, pick = corpus_chunk(gen, device)
        sources.append(x[pick])
        src_ids.append(pick + c * CHUNK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        words.append(crp.sketch(x))
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    store = CodeStore.from_words(torch.cat(words), K, crp.spec.bits)
    torch.cuda.synchronize()
    t_store = time.perf_counter() - t0
    del words
    t_ingest = sum(chunk_s) + t_store
    t0 = time.perf_counter()
    engine = AnnEngine(crp, store, BandSpec(16, 4))
    torch.cuda.synchronize()
    t_engine = time.perf_counter() - t0
    chunk_ms = sorted(1e3 * s for s in chunk_s)
    log(f"ingest: {N_ROWS} rows in {t_ingest:.4f} s = "
        f"{N_ROWS / t_ingest:.0f} rows/s (sketch calls + store assembly "
        f"{1e3 * t_store:.3f} ms); sketch ms a {CHUNK}-row chunk: min "
        f"{chunk_ms[0]:.4f} median {statistics.median(chunk_ms):.4f} max "
        f"{chunk_ms[-1]:.4f}; store {store.nbytes} bytes; band hashes in "
        f"{t_engine:.3f} s")

    noise = 0.1 / math.sqrt(D)
    sources = torch.cat(sources)
    src_ids = torch.cat(src_ids).to(torch.int32)
    planted = sources + noise * torch.randn(sources.shape, generator=gen,
                                            device=device)
    queries = torch.cat([planted,
                         unit_rows(N_QUERIES - N_PLANTED, D, gen, device)])
    engine.search(queries[:CHUNK_Q], top_k=TOP_K, chunk_q=CHUNK_Q)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, rho = engine.search(queries, top_k=TOP_K, chunk_q=CHUNK_Q)
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    hits = int((ids[:N_PLANTED, 0] == src_ids).sum())
    log(f"search: {N_QUERIES} queries in {t_search:.4f} s = "
        f"{N_QUERIES / t_search:.1f} queries/s; planted at rank 0: "
        f"{hits}/{N_PLANTED}; planted rho_hat median "
        f"{float(rho[:N_PLANTED, 0].median()):.4f}, random-query top rho_hat "
        f"median {float(rho[N_PLANTED:, 0].median()):.4f}")
    if hits != N_PLANTED:
        raise AssertionError(f"planted queries at rank 0: {hits}/{N_PLANTED}")
    if ids.shape != (N_QUERIES, TOP_K) or not bool(torch.isfinite(rho).all()):
        raise AssertionError("search output has the wrong shape or non-finite rho")

    batch = unit_rows(CHUNK, D, gen, device)
    t0 = time.perf_counter()
    engine = engine.add(batch)
    torch.cuda.synchronize()
    t_add = time.perf_counter() - t0
    n_new = 64
    new_planted = batch[:n_new] + noise * torch.randn((n_new, D),
                                                      generator=gen,
                                                      device=device)
    queries2 = torch.cat([queries[:N_QUERIES - n_new], new_planted])
    ids2, rho2 = engine.search(queries2, top_k=TOP_K, chunk_q=CHUNK_Q)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    new_ids = torch.arange(N_ROWS, N_ROWS + n_new, device=device,
                           dtype=torch.int32)
    hits2 = int((ids2[:N_PLANTED, 0] == src_ids).sum()) + \
        int((ids2[N_QUERIES - n_new:, 0] == new_ids).sum())
    log(f"add: {CHUNK} rows in {t_add:.3f} s, n={engine.n}; planted at rank "
        f"0 after add: {hits2}/{N_PLANTED + n_new}")
    log(f"launch counts on the main path: {json.dumps(counts)}")
    if hits2 != N_PLANTED + n_new:
        raise AssertionError(f"after add: {hits2}/{N_PLANTED + n_new}")
    if engine.n != N_ROWS + CHUNK:
        raise AssertionError(f"engine.n {engine.n}")
    require_launched(counts, "main")

    pick = torch.cat([torch.arange(8, device=device),
                      torch.arange(N_QUERIES - 8, N_QUERIES, device=device)])
    q_codes = engine.encode_queries(queries2[pick])
    q_words = ref.pack_codes_ref(q_codes, crp.spec.bits)
    want_v, want_i = ref.packed_topk_ref(q_words, engine.store.words,
                                         crp.spec.bits, K, TOP_K)
    if not torch.equal(ids2[pick], want_i) or \
            not torch.equal(rho2[pick], engine._rho(want_v)):
        raise AssertionError("16-query recheck against packed_topk_ref failed")
    log("recheck: 16 queries bit-exact against packed_topk_ref over "
        f"{engine.n} rows")
    rates = dict(ingest_rows_s=N_ROWS / t_ingest,
                 search_queries_s=N_QUERIES / t_search)
    return counts, rates, engine, queries2, dict(
        queries=queries, src_ids=src_ids, sources=sources)


# JAX's float32 2-bit, w = 0.75, k = 256 tables
# (repro.rank.build_rank_tables(CodeSpec("2bit", 0.75), 256)): the pair
# table, and score_grid at five indices
JAX_PAIR = [
    [1.2127269506454468, -0.2013745903968811, -2.9478564262390137,
     -7.9080915451049805],
    [-0.2013746201992035, 0.7243614196777344, -0.1354592740535736,
     -2.9478559494018555],
    [-2.9478559494018555, -0.13545948266983032, 0.7243613004684448,
     -0.2013746201992035],
    [-7.908156871795654, -2.9478561878204346, -0.2013745754957199,
     1.2127269506454468]]
JAX_SCORE_POINTS = {0: -353.320068359375, 128: -224.7241668701172,
                    256: -92.25975799560547, 384: 48.576019287109375,
                    511: 239.96676635742188}

def check_rank_tables(tables) -> None:
    """The port's float64-built tables against JAX's float32 ones."""
    import torch
    pair = tables.pair.cpu().double()
    want = torch.tensor(JAX_PAIR, dtype=torch.float64)
    err = float(((pair - want).abs() / want.abs()).max())
    grid = tables.score_grid.cpu().double()
    g_err = max(abs(float(grid[i]) - v) / abs(v)
                for i, v in JAX_SCORE_POINTS.items())
    log(f"rank tables: pair max relative error {err:.3e}, score_grid "
        f"{g_err:.3e} at {len(JAX_SCORE_POINTS)} points (limit 1e-4)")
    if err > 1e-4 or g_err > 1e-4:
        raise AssertionError("rank tables differ from JAX's beyond 1e-4")


def scored_path(engine, queries, src_ids, sources, device) -> tuple:
    """Scored and LSH search over the store after ``add``, counted:
    scored fused (f32 and int8 tables) and two-stage over 1,024 queries,
    LSH count-ranked and scored over one 256-query chunk; then gates, a
    16-query recheck of each mode through the plain versions, and the
    count-vs-scored hit rate on harder queries."""
    import torch
    from repro_torch.ann.engine import SearchConfig
    from repro_torch.kernels import ops, ref
    t0 = time.perf_counter()
    tables = engine.rank_tables
    torch.cuda.synchronize()
    log(f"rank tables set-up: {1e3 * (time.perf_counter() - t0):.3f} ms")
    check_rank_tables(tables)
    lsh_q = torch.cat([queries[:N_LSH_PLANTED],
                       queries[N_PLANTED:N_PLANTED + N_LSH - N_LSH_PLANTED]])
    modes = {   # name: (queries, warm-up chunk, search kwargs)
        "scored_f32": (queries, True, dict(scored=True)),
        "scored_int8": (queries, True, dict(scored=True, table_dtype="int8")),
        "two_stage": (queries, True, dict(scored=True, fused=False)),
        "lsh": (lsh_q, False, dict(mode="lsh")),
        "lsh_scored": (lsh_q, False, dict(mode="lsh", scored=True)),
    }
    out, rates = {}, {}
    ops.reset_launch_counts()
    for name, (qs, warm, kw) in modes.items():
        if warm:
            engine.search(qs[:CHUNK_Q], top_k=TOP_K, chunk_q=CHUNK_Q, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = engine.search(qs, top_k=TOP_K, chunk_q=CHUNK_Q, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates[f"{name}_queries_s"] = qs.shape[0] / dt
        ids, rho = out[name]
        n_pl = N_PLANTED if qs is queries else N_LSH_PLANTED
        hits = int((ids[:n_pl, 0] == src_ids[:n_pl]).sum())
        log(f"search {name}: {qs.shape[0]} queries in {dt:.4f} s = "
            f"{qs.shape[0] / dt:.1f} queries/s; planted at rank 0: "
            f"{hits}/{n_pl}; planted rho_hat median "
            f"{float(rho[:n_pl, 0].median()):.4f}")
        if ids.shape != (qs.shape[0], TOP_K) or \
                not bool(torch.isfinite(rho).all()):
            raise AssertionError(f"{name}: wrong shape or non-finite rho")
        if name != "scored_int8" and hits != n_pl:
            raise AssertionError(f"{name}: planted at rank 0 {hits}/{n_pl}")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"launch counts on the scored and LSH path: {json.dumps(counts)}")
    require_launched(counts, "scored")

    # fused == two-stage, but where LUT scores tie across counts
    (fi, fr), (ti, tr) = out["scored_f32"], out["two_stage"]
    diff = torch.nonzero(((fi != ti) | (fr != tr)).any(dim=1)).flatten()
    q_codes = engine.encode_queries(queries[diff])
    q_words = ref.pack_codes_ref(q_codes, engine.store.bits)
    q_tab = tables.query_tables(q_codes)
    m = SearchConfig(top_k=TOP_K).resolve_m(engine.n)
    ties = 0
    for i in range(diff.numel()):
        sl = slice(i, i + 1)
        a = ref.fused_scored_topk_ref(q_words[sl], q_tab[sl],
                                      engine.store.words, engine.store.bits,
                                      K, m, TOP_K)
        b = ref.two_stage_scored_ref(q_words[sl], q_tab[sl],
                                     engine.store.words, engine.store.bits,
                                     K, m, TOP_K)
        if same(a, b):
            raise AssertionError(f"query {int(diff[i])}: fused and two-stage "
                                 f"differ without a cross-count tie")
        ties += 1
    log(f"fused vs two-stage: {N_QUERIES - ties}/{N_QUERIES} queries equal "
        f"in ids and rho_hat; {ties} differ, each at LUT scores tied across "
        f"collision counts (the plain versions differ there too)")

    # each mode against the same engine through the plain versions
    pick = torch.cat([torch.arange(8, device=device),
                      torch.arange(N_LSH - 8, N_LSH, device=device)])
    for name, (qs, _, kw) in modes.items():
        cfg = SearchConfig(top_k=TOP_K, chunk_q=16, impl="ref", **kw)
        want = engine.search_codes(engine.encode_queries(qs[pick]), cfg)
        if not same(tuple(t[pick] for t in out[name]), want):
            raise AssertionError(f"{name}: 16-query recheck failed")
    log(f"recheck: 16 queries of each mode bit-exact against the plain "
        f"versions over {engine.n} rows")

    # quality: planted neighbours at cosine about 0.9 (noise norm 0.48)
    # and about 0.6 (noise norm 1.33), count-ranked against scored
    gen = torch.Generator(device=device).manual_seed(90)
    for noise in (0.48, 1.33):
        hard = sources + (noise / math.sqrt(D)) * torch.randn(
            sources.shape, generator=gen, device=device)
        cos = float(((hard / hard.norm(dim=1, keepdim=True)) * sources)
                    .sum(1).mean())
        hit = {}
        for name, kw in (("count", {}), ("scored", dict(scored=True))):
            ids, _ = engine.search(hard, top_k=TOP_K, chunk_q=CHUNK_Q, **kw)
            hit[name] = float((ids[:, 0] == src_ids).float().mean())
            rates[f"rank0_{name}_cos{cos:.2f}"] = hit[name]
        log(f"planted queries at mean cosine {cos:.4f} ({sources.shape[0]} "
            f"queries): rank-0 hit rate count-ranked {hit['count']:.4f}, "
            f"scored {hit['scored']:.4f}")
    rates["fused_two_stage_cross_count_ties"] = ties
    return counts, rates


def per_segment_oracle(mut, queries, kw: dict):
    """Scored search as the mutable engine defines it, without masks:
    each segment's live rows gathered into a dense corpus and searched
    with the unmasked kernels (B5; or B4 or B9 then B10) at that
    segment's rerank_m, rows mapped to external ids, the lists merged in
    log order -> (ids, rho_hat)."""
    import torch
    from repro_torch.ann.bands import probe_hashes
    from repro_torch.ann.engine import (SearchConfig, _coarse_band_scores,
                                        lut_rerank_stage, merge_topk,
                                        resolve_query_tables, rho_scored)
    from repro_torch.core import packing
    from repro_torch.kernels import ops, ref
    cfg = SearchConfig(top_k=TOP_K, **kw)
    tables, bits = mut.rank_tables, mut.store.bits
    q_codes = mut.encode_queries(queries)
    q_words = ops.pack_codes(q_codes, bits)
    q_tab, scales = resolve_query_tables(tables, q_codes, cfg.table_dtype)
    qh = packing.as_i32(probe_hashes(q_codes, mut.band_spec, cfg.n_probes))
    vals_l, ids_l = [], []
    for seg in mut.store.segments():
        if seg.live == 0:
            continue
        live_np = seg.live_rows()
        live = torch.from_numpy(live_np).to(q_codes.device)
        words, m = seg.words[live], cfg.resolve_m(seg.cap)
        if cfg.use_fused():
            vals, rows = ops.fused_scored_topk(q_words, q_tab, words, bits, K,
                                               m, TOP_K, scales=scales)
        else:
            if cfg.mode == "exact":
                _, rows = ops.packed_topk(q_words, words, bits, K, m)
            else:
                counts = ops.packed_collision_counts(q_words, words, bits, K)
                keep = _coarse_band_scores(qh, seg.hashes[live]) >= \
                    cfg.min_bands
                _, rows = ref.topk_stable_ref(
                    torch.where(keep, counts, torch.full_like(counts, -1)), m)
            rows, vals = lut_rerank_stage(tables, q_codes, rows, words, TOP_K,
                                          q_tables=q_tab)
        ext = torch.from_numpy(seg.ids[live_np].astype("int32")).to(
            q_codes.device)[rows.clamp(min=0).long()]
        ids_l.append(torch.where(rows < 0, torch.full_like(ext, -1), ext))
        vals_l.append(vals)
    vals, ids = merge_topk(vals_l, ids_l, TOP_K)
    return ids, rho_scored(tables, ids, vals)


def mutable_path(engine, state, device, profile: bool = False) -> tuple:
    """Ingest -> churn -> search in every mode -> compact -> snapshot ->
    restore -> search, through ``MutableAnnEngine`` over the main path's
    corpus. Launches are counted over the path's own calls only; the
    gates (fresh immutable engines, the per-segment oracle, the plain
    versions) run between them."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.ann import AnnEngine, BandSpec, CodeStore
    from repro_torch.ann.engine import SearchConfig
    from repro_torch.index import CompactionPolicy, MutableAnnEngine
    from repro_torch.kernels import ops
    crp, bits = engine.sketcher, engine.sketcher.spec.bits
    counts = dict.fromkeys(ops.launch_counts(), 0)
    rates = {}

    def counted(fn):
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        for key, v in ops.launch_counts().items():
            counts[key] += v
        return out

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = counted(fn)
        return out, time.perf_counter() - t0

    # 1. ingest: the main path's rows, made outside the timed window
    mut = MutableAnnEngine(crp, band_spec=BandSpec(16, 4),
                           tail_rows=TAIL_ROWS)
    gen = torch.Generator(device=device).manual_seed(CORPUS_SEED)
    chunk_s = []
    for _ in range(N_ROWS // CHUNK):
        x, _ = corpus_chunk(gen, device)
        chunk_s.append(timed(lambda: mut.ingest(x, chunk_rows=CHUNK))[1])
    store = mut.store
    t_ingest = sum(chunk_s)
    rates["ingest_rows_s"] = N_ROWS / t_ingest
    chunk_ms = sorted(1e3 * c for c in chunk_s)
    log(f"mutable ingest: {N_ROWS} rows in {t_ingest:.4f} s = "
        f"{N_ROWS / t_ingest:.0f} rows/s; ms a {CHUNK}-row call: min "
        f"{chunk_ms[0]:.4f} median {statistics.median(chunk_ms):.4f} max "
        f"{chunk_ms[-1]:.4f}; {store.n_segments} segments, "
        f"{store.nbytes} bytes")
    if (mut.n, len(store.sealed), store.tail.length) != \
            (N_ROWS, N_ROWS // TAIL_ROWS, 0):
        raise AssertionError(f"after ingest: {store.stats()}")
    if not torch.equal(store.live_words(), engine.store.words[:N_ROWS]):
        raise AssertionError("ingested words differ from the main path's "
                             "store")

    # 2. churn: ids on the host from a seed, new rows on the card
    rng = np.random.default_rng(CORPUS_SEED)
    src_ids = state["src_ids"]
    src_np = src_ids.cpu().numpy().astype(np.int64)
    src = np.unique(src_np)
    gone_src = rng.choice(src, src.size // 4, replace=False)
    others = rng.permutation(N_ROWS)
    others = others[~np.isin(others, src)]
    n_other = N_DELETE - gone_src.size
    del_ids = np.concatenate([gone_src, others[:n_other]])
    killed, t_del = timed(lambda: mut.delete(del_ids))
    replant = rng.choice(src[~np.isin(src, gone_src)], N_REPLANT,
                         replace=False)
    up_ids = np.concatenate([replant,
                             others[n_other:n_other + N_UPSERT - N_REPLANT]])
    x_up = unit_rows(N_UPSERT, D, gen, device)
    _, t_up = timed(lambda: mut.upsert(up_ids, x_up))
    x_add = unit_rows(CHUNK, D, gen, device)
    add_ids, t_add = timed(lambda: mut.add(x_add))
    for what, n, t in (("delete", killed, t_del), ("upsert", N_UPSERT, t_up),
                       ("add", CHUNK, t_add)):
        rates[f"{what}_ms"] = 1e3 * t
        rates[f"{what}_rows_s"] = n / t
        log(f"mutable {what}: {n} rows in {1e3 * t:.3f} ms = {n / t:.0f} "
            f"rows/s")
    want = (N_ROWS - N_DELETE + CHUNK, N_ROWS // TAIL_ROWS + 1,
            N_UPSERT + CHUNK)
    if killed != N_DELETE or (mut.n, store.n_segments,
                              store.tail.length) != want:
        raise AssertionError(f"after churn: killed {killed}, {store.stats()}")
    log(f"after churn: {store.stats()}")

    # queries: the main path's, the re-planted sources' replaced
    noise = 0.1 / math.sqrt(D)
    queries = state["queries"].clone()
    at = {int(i): j for j, i in enumerate(replant)}
    moved = np.flatnonzero(np.isin(src_np, replant))
    rows_up = torch.tensor([at[int(i)] for i in src_np[moved]], device=device)
    queries[torch.from_numpy(moved).to(device)] = x_up[rows_up] + noise * \
        torch.randn((moved.size, D), generator=gen, device=device)
    alive = torch.from_numpy(np.flatnonzero(~np.isin(src_np, gone_src))).to(
        device)
    moved_t = torch.from_numpy(moved).to(device)
    lsh_q = torch.cat([queries[:N_LSH_PLANTED],
                       queries[N_PLANTED:N_PLANTED + N_LSH - N_LSH_PLANTED]])
    lsh_alive = alive[alive < N_LSH_PLANTED]
    dead = torch.from_numpy(del_ids).to(device)
    modes = {   # name: (queries, warm-up chunk, search kwargs)
        "count": (queries, True, {}),
        "scored_f32": (queries, True, dict(scored=True)),
        "scored_int8": (queries, True, dict(scored=True, table_dtype="int8")),
        "two_stage": (queries, True, dict(scored=True, fused=False)),
        "lsh": (lsh_q, False, dict(mode="lsh")),
        "lsh_scored": (lsh_q, False, dict(mode="lsh", scored=True)),
    }

    def search_all(eng, tag):
        out = {}
        for name, (qs, warm, kw) in modes.items():
            if warm:
                counted(lambda: eng.search(qs[:CHUNK_Q], top_k=TOP_K,
                                           chunk_q=CHUNK_Q, **kw))
            out[name], dt = timed(lambda: eng.search(
                qs, top_k=TOP_K, chunk_q=CHUNK_Q, **kw))
            rates[f"{tag}_{name}_queries_s"] = qs.shape[0] / dt
            ids, rho = out[name]
            if ids.shape != (qs.shape[0], TOP_K) or \
                    not bool(torch.isfinite(rho).all()):
                raise AssertionError(f"{tag} {name}: wrong shape or "
                                     f"non-finite rho")
            if bool(torch.isin(ids, dead).any()):
                raise AssertionError(f"{tag} {name}: a deleted id came back")
            pl = lsh_alive if kw.get("mode") == "lsh" else alive
            hits = int((ids[pl, 0] == src_ids[pl]).sum())
            rp = moved_t if kw.get("mode") != "lsh" else \
                moved_t[moved_t < N_LSH_PLANTED]
            rp_hits = int((ids[rp, 0] == src_ids[rp]).sum())
            log(f"{tag} search {name}: {qs.shape[0]} queries in {dt:.4f} s "
                f"= {qs.shape[0] / dt:.1f} queries/s; live planted at rank "
                f"0: {hits}/{pl.numel()}, re-planted {rp_hits}/{rp.numel()}")
            if name != "scored_int8" and hits != pl.numel():
                raise AssertionError(f"{tag} {name}: planted at rank 0 "
                                     f"{hits}/{pl.numel()}")
        return out

    def check_fresh(eng, out, tag):
        """Count-ranked: equal to one fresh immutable engine over the live
        rows. Scored: equal to the per-segment oracle; agreement with the
        whole-store engine is counted."""
        live_ids = torch.from_numpy(eng.store.live_ids().astype(np.int32)).to(
            device)
        fresh = AnnEngine(crp, CodeStore.from_words(eng.store.live_words(), K,
                                                    bits),
                          BandSpec(16, 4), rank_tables=eng.rank_tables)
        for name, (qs, _, kw) in modes.items():
            rows, rho = fresh.search(qs, top_k=TOP_K, chunk_q=CHUNK_Q, **kw)
            ids = torch.where(rows < 0, torch.full_like(rows, -1),
                              live_ids[rows.clamp(min=0).long()])
            agree = int(((ids == out[name][0]).all(1)
                         & (rho == out[name][1]).all(1)).sum())
            if not kw.get("scored"):
                if agree != qs.shape[0]:
                    raise AssertionError(f"{tag} {name}: {agree}/"
                                         f"{qs.shape[0]} queries equal the "
                                         f"fresh immutable engine")
                log(f"{tag} {name}: {agree}/{qs.shape[0]} queries bit-exact "
                    f"against a fresh immutable engine over "
                    f"{eng.n} live rows")
                continue
            if not same(out[name], per_segment_oracle(eng, qs, kw)):
                raise AssertionError(f"{tag} {name}: differs from the "
                                     f"per-segment oracle")
            log(f"{tag} {name}: bit-exact against the per-segment oracle; "
                f"{agree}/{qs.shape[0]} queries equal the whole-store "
                f"engine (the coarse top-{RERANK_M} is taken per segment)")
        del fresh

    # 3. search, 4. gates
    out = search_all(mut, "churned")
    check_fresh(mut, out, "churned")
    pick = torch.cat([torch.arange(8, device=device),
                      torch.arange(N_LSH - 8, N_LSH, device=device)])
    for name, (qs, _, kw) in modes.items():
        cfg = SearchConfig(top_k=TOP_K, chunk_q=16, impl="ref", **kw)
        want = mut.search_codes(mut.encode_queries(qs[pick]), cfg)
        if not same(tuple(t[pick] for t in out[name]), want):
            raise AssertionError(f"{name}: 16-query recheck failed")
    log(f"recheck: 16 queries of each mode bit-exact against the plain "
        f"versions over {store.n_segments} segments")
    if profile:
        for name in ("count", "scored_f32"):
            kw = modes[name][2]
            profile_window(f"mutable {name} chunk ({store.n_segments} "
                           f"segments)",
                           lambda: mut.search(queries[:CHUNK_Q], top_k=TOP_K,
                                              chunk_q=CHUNK_Q, **kw), top=12)

    # 5. compact, search again
    before = store.n_segments
    rep, t_c = timed(lambda: mut.compact(CompactionPolicy(
        target_rows=1_048_576, max_dead_fraction=0.05)))
    rates["compact_ms"] = 1e3 * t_c
    log(f"compact: {rep}; segments {before} -> {store.n_segments} in "
        f"{1e3 * t_c:.3f} ms")
    if rep["rows_dropped"] != N_DELETE + N_UPSERT:
        raise AssertionError(f"compaction dropped {rep['rows_dropped']}")
    out2 = search_all(mut, "compacted")
    for name, (qs, _, kw) in modes.items():
        changed = int(((out2[name][0] != out[name][0]).any(1)
                       | (out2[name][1] != out[name][1]).any(1)).sum())
        if not kw.get("scored") and changed:
            raise AssertionError(f"compacted {name}: {changed} queries "
                                 f"changed")
        log(f"compacted {name}: {changed}/{qs.shape[0]} queries changed")
    check_fresh(mut, out2, "compacted")

    # 6. snapshot, restore, search again
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    snap = tempfile.mkdtemp(prefix="snapshot-", dir=os.path.join(ROOT, "build"))
    try:
        path, t_s = timed(lambda: mut.save(snap, 1))
        n_bytes = sum(os.path.getsize(os.path.join(path, f))
                      for f in os.listdir(path))
        restored, t_r = timed(lambda: MutableAnnEngine.restore(crp, snap))
    finally:
        shutil.rmtree(snap)
    rates["save_mb_s"] = n_bytes / t_s / 1e6
    rates["restore_mb_s"] = n_bytes / t_r / 1e6
    log(f"snapshot: {n_bytes} bytes saved in {t_s:.3f} s = "
        f"{n_bytes / t_s / 1e6:.1f} MB/s, restored in {t_r:.3f} s = "
        f"{n_bytes / t_r / 1e6:.1f} MB/s")
    if {**restored.store.stats(), "generation": 0} != \
            {**store.stats(), "generation": 0} or \
            restored.store.next_id != store.next_id:
        raise AssertionError("restored store differs")
    out3 = search_all(restored, "restored")
    for name in modes:
        if not same(out3[name], out2[name]):
            raise AssertionError(f"restored {name} differs from before the "
                                 f"snapshot")
    log("restored: every mode bit-exact against the compacted engine")
    require_launched(counts, "mutable")
    log(f"launch counts on the mutable path: {json.dumps(counts)}")
    return counts, rates


def url_rows(rng, n: int):
    """n CSR rows of the URL corpus's shape: URL_NNZ distinct columns
    drawn uniformly from [0, URL_D) (sorted in the row) and standard
    normal values scaled by 1/sqrt(URL_NNZ), so that a row has about unit
    norm and its projections about unit variance, the scale the 2-bit
    scheme's w = 0.75 is chosen for -> (cols int32 [n, URL_NNZ], vals
    float32 [n, URL_NNZ])."""
    import numpy as np
    cols = rng.integers(0, URL_D, (n, URL_NNZ), dtype=np.int32)
    cols.sort(axis=1)
    dup = (np.diff(cols, axis=1) == 0).any(axis=1)
    while dup.any():
        fresh = rng.integers(0, URL_D, (int(dup.sum()), URL_NNZ),
                             dtype=np.int32)
        fresh.sort(axis=1)
        cols[dup] = fresh
        dup = (np.diff(cols, axis=1) == 0).any(axis=1)
    return cols, rng.standard_normal((n, URL_NNZ), dtype=np.float32) * \
        np.float32(1 / math.sqrt(URL_NNZ))


def url_chunk(c: int):
    """Chunk c of the URL corpus (rows c * URL_CHUNK onwards), made on the
    host from its own seed, so that any chunk can be made alone."""
    import numpy as np
    n = min(URL_CHUNK, URL_ROWS - c * URL_CHUNK)
    return url_rows(np.random.default_rng([URL_SEED, c]), n)


def as_csr(cols, vals):
    """Rows of URL_NNZ entries each -> ``CsrMatrix`` [n, URL_D]."""
    import numpy as np
    from repro_torch.encode import CsrMatrix
    n = cols.shape[0]
    return CsrMatrix(indptr=np.arange(n + 1, dtype=np.int64) * cols.shape[1],
                     indices=cols.reshape(-1), data=vals.reshape(-1),
                     shape=(n, URL_D))


def url_queries(src_cols, src_vals, rng):
    """Planted queries: each source row with URL_MOVED of its nonzeros
    moved to fresh columns and every value perturbed (noise a tenth of
    the values' scale), then as many random rows -> (CsrMatrix, mean
    cosine of planted to source)."""
    import numpy as np
    cols, vals = src_cols.copy(), src_vals.copy()
    for i in range(cols.shape[0]):
        pos = rng.choice(URL_NNZ, URL_MOVED, replace=False)
        fresh = rng.integers(0, URL_D, URL_MOVED)
        while np.isin(fresh, cols[i]).any() or \
                np.unique(fresh).size < URL_MOVED:
            fresh = rng.integers(0, URL_D, URL_MOVED)
        cols[i, pos] = fresh
    vals = vals + np.float32(0.1 / math.sqrt(URL_NNZ)) * rng.standard_normal(
        vals.shape, dtype=np.float32)
    cos = []
    for i in range(cols.shape[0]):
        _, a, b = np.intersect1d(cols[i], src_cols[i], return_indices=True)
        cos.append(float(vals[i, a].astype(np.float64)
                         @ src_vals[i, b].astype(np.float64))
                   / float(np.linalg.norm(vals[i]) * np.linalg.norm(src_vals[i])))
    rcols, rvals = url_rows(rng, cols.shape[0])
    return (as_csr(np.concatenate([cols, rcols]),
                   np.concatenate([vals, rvals])), float(np.mean(cos)))


def encode_kernel_phase(rows, crp, cols, vals, device) -> None:
    """The encode kernels at the URL path's shapes, on chunk 0 of the URL
    corpus: code_pack on its [262,144 x 256] projections, the draw of one
    full unit [4,096 x 256] and of a group of G units in one launch, the
    grouped CSR step over the whole chunk (``csr_chunk_rows``); each
    bit-exact against its plain version."""
    import torch
    from repro_torch.core import packing, prng
    from repro_torch.kernels import ops, ref
    spec, ru = crp.spec, crp.cfg.r_unit
    csr = as_csr(cols, vals)
    n = csr.n
    w_words = packing.packed_width(K, spec.bits)
    z = crp.stream_encoder().project(csr)
    torch.cuda.synchronize()

    def row(name, want_eq, ms, plain_ms, lib_ms, b, shape, extra=""):
        b_ms, b_by, pipe = b
        if not want_eq:
            raise AssertionError(f"{name} differs from its plain version")
        rows[name] = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, bound_pipe=pipe,
                          library_ms=lib_ms, shape=shape)
        lib = "null" if lib_ms is None else f"{lib_ms:.4f}"
        log(f"kernel {name}: {shape} bit-exact ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib} bound_ms={b_ms:.5f} "
            f"({b_by}, {pipe}){extra}")

    # code_pack: one compare-and-add per code edge and a shift and an add
    # per field, about 7 int32 operations a value
    row("code_pack",
        torch.equal(ops.code_pack(z, spec, impl="kernel"),
                    ref.code_pack_ref(z, spec)),
        time_ms(lambda: ops.code_pack(z, spec, impl="kernel")),
        time_ms(lambda: ref.code_pack_ref(z, spec)), None,
        bound([("int32", 7.0 * n * K, INT32_OP_S)],
              4.0 * n * K + 4.0 * n * w_words),
        [n, K])

    # the draw: threefry's 20 rounds (add, rotate, xor) and 5 key
    # injections (3 adds) with the counter split, the xor of the two
    # words and the mantissa: 80 int32 operations an element; erfinv on
    # the log1p branch about 60 float32 operations (an FMA counts two)
    key = prng.fold_in(crp._key, 0)
    elems = float(ru) * K
    row("normal_unit",
        torch.equal(ops.normal_unit(key, ru, K, device, impl="kernel")
                    .view(torch.int32),
                    ops.normal_unit(key, ru, K, device, impl="ref")
                    .view(torch.int32)),
        time_ms(lambda: ops.normal_unit(key, ru, K, device, impl="kernel")),
        time_ms(lambda: ops.normal_unit(key, ru, K, device, impl="ref"),
                reps=3, warmup=1), None,
        bound([("int32", 80.0 * elems, INT32_OP_S),
               ("f32", 60.0 * elems, F32_FLOP_S)], 4.0 * elems),
        [ru, K])

    # the grouped draw: the first G units in one launch
    group = crp.stream_encoder().csr_group
    buf = torch.empty((group, ru, K), device=device)
    units = list(range(group))
    plain = torch.empty_like(buf)
    row("normal_unit_group",
        same_bits(crp._draw_units(units, buf, impl="kernel"),
                  crp._draw_units(units, plain, impl="ref")),
        time_ms(lambda: crp._draw_units(units, buf, impl="kernel")),
        time_ms(lambda: crp._draw_units(units, plain, impl="ref"),
                reps=3, warmup=1), None,
        bound([("int32", 80.0 * elems * group, INT32_OP_S),
               ("f32", 60.0 * elems * group, F32_FLOP_S)],
              4.0 * elems * group),
        [group, ru, K])
    del buf, plain

    csr_chunk_rows(rows, crp, csr, z, device)
    del z
    torch.cuda.empty_cache()


def csr_chunk_rows(rows, crp, csr, z, device) -> None:
    """The grouped CSR step over the whole chunk: all of its units (R
    drawn beforehand, outside the windows), at the encoder's G and at
    G = 1, each launch counted, held bit for bit against the plain
    version, against the step of one unit a launch and against the
    encoder's projection z; timed per chunk beside one torch.addmm of
    the chunk as a sparse CSR tensor (the library yardstick) and the sum
    of torch.addmm over the units' buckets."""
    import torch
    from repro_torch.encode.encoder import _unit_counts
    from repro_torch.kernels import ops
    ru, n_units, n = crp.cfg.r_unit, crp.n_units, csr.n
    group = crp.stream_encoder().csr_group
    indptr = torch.from_numpy(csr.indptr).to(device)
    indices = torch.from_numpy(csr.indices).to(device)
    data = torch.from_numpy(csr.data).to(device)
    r_all = torch.empty((n_units, ru, K), device=device)      # 3.3 GB
    for u0 in range(0, n_units, 16):
        crp._draw_units(list(range(u0, min(u0 + 16, n_units))),
                        r_all[u0:u0 + 16])
    counts = _unit_counts(indices, ru, n_units)

    def steps(g, impl="kernel"):
        acc = torch.zeros((n, K), device=device)
        for u0 in range(0, n_units, g):
            span = min(g * ru, URL_D - u0 * ru)
            ops.csr_group_step(acc, indptr, indices, data,
                               r_all[u0:u0 - (-span // ru)], u0 * ru, span,
                               impl=impl, nnz=sum(counts[u0:u0 + g]))
        return acc

    def unit_steps():
        acc = torch.zeros((n, K), device=device)
        for u in range(n_units):
            ops.csr_unit_step(acc, indptr, indices, data,
                              r_all[u, :crp.unit_width(u)], u * ru,
                              impl="kernel", nnz=counts[u])
        return acc

    want = steps(group, impl="ref")
    launched = {}
    for g in (group, 1):
        before = ops.launch_counts()
        got = steps(g)
        launched[g] = launch_diff(before)
        if launched[g] != {"csr_group_step": -(-n_units // g)}:
            raise AssertionError(f"csr_group_step at G = {g} over the chunk "
                                 f"launched {launched[g]}, not "
                                 f"{-(-n_units // g)} grouped steps")
    got, got1, got_u = steps(group), steps(1), unit_steps()
    if not (same_bits(got, want) and same_bits(got1, want)
            and same_bits(got_u, want) and same_bits(z, want)):
        raise AssertionError("csr_group_step over the chunk differs from its "
                             "plain version, the unit step or the encoder")
    # the yardstick: each unit's bucket as a sparse CSR tensor, addmm'd
    # onto the accumulator in unit order
    unit = (indices // ru).to(torch.int64)
    order = torch.sort(unit, stable=True).indices
    e_rows = torch.repeat_interleave(torch.arange(n, device=device),
                                     torch.diff(indptr))[order]
    starts = [0]
    for c in counts:
        starts.append(starts[-1] + c)
    buckets = []
    for u in range(n_units):
        if counts[u]:
            sel = order[starts[u]:starts[u + 1]]
            crow = torch.cat([torch.zeros(1, dtype=torch.int64,
                                          device=device),
                              torch.cumsum(torch.bincount(
                                  e_rows[starts[u]:starts[u + 1]],
                                  minlength=n), 0)])
            buckets.append((u, torch.sparse_csr_tensor(
                crow, (indices[sel] - u * ru).to(torch.int64), data[sel],
                (n, crp.unit_width(u)))))
    del unit, order, e_rows
    # and the whole chunk as one sparse CSR tensor, addmm'd in one call
    # onto the units' rows of R laid end to end
    chunk = torch.sparse_csr_tensor(indptr, indices.to(torch.int64), data,
                                    (n, URL_D))
    r_rows = r_all.view(-1, K)[:URL_D]

    def library_buckets():
        acc = torch.zeros((n, K), device=device)
        for u, b in buckets:
            acc = torch.addmm(acc, b, r_all[u, :crp.unit_width(u)])
        return acc

    def library():
        return torch.addmm(torch.zeros((n, K), device=device), chunk, r_rows)

    lib_err = float((library() - want).abs().max())
    lib_b_err = float((library_buckets() - want).abs().max())
    ms = time_ms(lambda: steps(group))
    ms1 = time_ms(lambda: steps(1))
    ms_u = time_ms(unit_steps)
    plain_ms = time_ms(lambda: steps(group, impl="ref"), reps=3, warmup=1)
    lib_ms = time_ms(library, reps=3, warmup=1)
    lib_b_ms = time_ms(library_buckets, reps=3, warmup=1)
    nnz = csr.nnz
    rows["csr_group_step"] = dict(
        max_abs_err=0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        shape=[n, nnz, n_units, K, group], g1_ms=ms1, unit_step_ms=ms_u,
        launches_a_chunk=launched[group]["csr_group_step"],
        g1_launches_a_chunk=launched[1]["csr_group_step"],
        library_max_abs_diff=lib_err, library_buckets_ms=lib_b_ms,
        library_buckets_max_abs_diff=lib_b_err)
    # the chunk's work: the CSR arrays once (column id and value 8 B an
    # entry, indptr 8 B a row), the accumulator written once and every
    # unit of R read once; a multiply and an add a (entry, column)
    b_ms, b_by, pipe = bound([("f32 add", 2.0 * nnz * K, F32_ADD_S)],
                             8.0 * nnz + 8.0 * (n + 1) + 4.0 * n * K
                             + 4.0 * URL_D * K)
    rows["csr_group_step"].update(bound_ms=b_ms, bound_by=b_by,
                                  bound_pipe=pipe)
    log(f"kernel csr_group_step: chunk 0 [{n} rows, {nnz} entries, "
        f"{n_units} units, k {K}] at G = {group} "
        f"({launched[group]['csr_group_step']} launches, counted) bit-exact "
        f"against the plain version, G = 1, the step of one unit and the "
        f"encoder; ms a chunk={ms:.4f} (G = 1 {ms1:.4f} in "
        f"{launched[1]['csr_group_step']} launches, the unit step "
        f"{ms_u:.4f}) plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (one "
        f"addmm of the chunk, max abs difference {lib_err:.3e}; addmm of "
        f"{len(buckets)} buckets {lib_b_ms:.4f}, {lib_b_err:.3e}) "
        f"bound_ms={b_ms:.5f} ({b_by}, {pipe})")
    del r_all, r_rows, chunk, buckets, want, got, got1, got_u
    torch.cuda.empty_cache()


def url_path(device, profile: bool = False) -> tuple:
    """Sparse ingest and search at the URL corpus's published width:
    CSR chunks -> IngestPipeline -> CodeStore -> AnnEngine -> count-ranked
    and scored search with CSR queries -> MutableAnnEngine ingest of the
    first two chunks, counted; then the gates."""
    import numpy as np
    import torch
    from repro_torch.ann import AnnEngine, BandSpec, CodeStore
    from repro_torch.core import packing, schemes
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    from repro_torch.encode import IngestPipeline
    from repro_torch.encode.encoder import R_CAP_ELEMS
    from repro_torch.index import MutableAnnEngine
    from repro_torch.kernels import ops
    crp = CodedRandomProjection(SketchConfig(k=K, scheme="2bit", w=0.75,
                                             seed=0), URL_D)
    enc, bits = crp.stream_encoder(), crp.spec.bits
    w_words = packing.packed_width(K, bits)
    n_chunks = -(-URL_ROWS // URL_CHUNK)
    log(f"url: D={URL_D}, {crp.n_units} units (last {crp.unit_width(crp.n_units - 1)} "
        f"rows), R would be {URL_D * K} elements; {URL_ROWS} rows of "
        f"{URL_NNZ} nonzeros in {n_chunks} chunks of {URL_CHUNK}")
    rng = np.random.default_rng(URL_SEED)
    src_ids = np.sort(rng.choice(URL_ROWS, N_PLANTED, replace=False))
    src_cols = np.zeros((N_PLANTED, URL_NNZ), np.int32)
    src_vals = np.zeros((N_PLANTED, URL_NNZ), np.float32)
    pipe = IngestPipeline(enc, CodeStore(
        words=torch.zeros((0, w_words), dtype=torch.int32, device=device),
        k=K, bits=bits), chunk_rows=URL_CHUNK)
    rates, kept, chunk_s, t_gen, extra_max = {}, [], [], 0.0, 0
    ops.reset_launch_counts()
    for c in range(n_chunks):
        t0 = time.perf_counter()
        cols, vals = url_chunk(c)
        lo = c * URL_CHUNK
        at = (src_ids >= lo) & (src_ids < lo + cols.shape[0])
        src_cols[at], src_vals[at] = cols[src_ids[at] - lo], \
            vals[src_ids[at] - lo]
        csr = as_csr(cols, vals)
        if c < 2:
            kept.append(csr)
        t_gen += time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        launched = ops.launch_counts()
        t0 = time.perf_counter()
        pipe.ingest(csr)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        if c == 0:
            chunk_launches = launch_diff(launched)
        # beyond what was allocated before and the store it appends to:
        # the chunk's CSR arrays, its accumulator and words, and 64 MB
        n = csr.n
        extra = torch.cuda.max_memory_allocated() - before - \
            pipe.store.nbytes
        budget = 8 * (n + 1) + 8 * csr.nnz + 4 * n * K + 4 * n * w_words \
            + 4 * R_CAP_ELEMS
        extra_max = max(extra_max, extra)
        if extra > budget:
            raise AssertionError(f"url chunk {c}: peak {extra} bytes beyond "
                                 f"the store, over the budget {budget}")
        if c == 0:
            log(f"url chunk 0: peak device memory {extra} bytes beyond the "
                f"store, budget {budget} (CSR {8 * (n + 1) + 8 * csr.nnz}, "
                f"accumulator {4 * n * K}, words {4 * n * w_words}, "
                f"64 MB); {sum(chunk_launches.values())} launches "
                f"{json.dumps(chunk_launches)} at G = {enc.csr_group}")
        del csr, cols, vals
    store = pipe.store
    t_ingest = sum(chunk_s)
    rates["ingest_rows_s"] = URL_ROWS / t_ingest
    rates["chunk_launches"] = sum(chunk_launches.values())
    chunk_ms = sorted(1e3 * x for x in chunk_s)
    rates["chunk_ms_median"] = statistics.median(chunk_ms)
    log(f"url ingest: {URL_ROWS} rows in {t_ingest:.4f} s = "
        f"{URL_ROWS / t_ingest:.1f} rows/s (row generation on the host, "
        f"{t_gen:.1f} s, outside); ms a chunk: min {chunk_ms[0]:.3f} median "
        f"{statistics.median(chunk_ms):.3f} max {chunk_ms[-1]:.3f}; peak "
        f"memory beyond the store at most {extra_max} bytes; store "
        f"{store.nbytes} bytes")
    if enc._rmat is not None or store.n != URL_ROWS:
        raise AssertionError("url: R was built, or the store is short")

    queries, cos = url_queries(src_cols, src_vals, rng)
    t0 = time.perf_counter()
    engine = AnnEngine(crp, store, BandSpec(16, 4))
    tables = engine.rank_tables
    torch.cuda.synchronize()
    log(f"url engine: band hashes and rank tables in "
        f"{time.perf_counter() - t0:.3f} s; planted queries at mean cosine "
        f"{cos:.4f} to their sources")
    del tables
    first = queries.row_slice(0, CHUNK_Q)
    engine.encode_queries(first)                          # warm-up
    torch.cuda.synchronize()
    launched = ops.launch_counts()
    t0 = time.perf_counter()
    engine.encode_queries(first)
    torch.cuda.synchronize()
    t_code = time.perf_counter() - t0
    code_launches = launch_diff(launched)
    group = enc.csr_group
    buf = torch.empty((group, crp.cfg.r_unit, K), device=device)
    t0 = time.perf_counter()
    for u0 in range(0, crp.n_units, group):
        crp._draw_units(list(range(u0, min(u0 + group, crp.n_units))), buf)
    torch.cuda.synchronize()
    t_draw = time.perf_counter() - t0
    del buf
    rates["query_coding_ms_256"] = 1e3 * t_code
    rates["query_coding_launches"] = sum(code_launches.values())
    rates["redraw_all_units_ms"] = 1e3 * t_draw
    log(f"url query coding: {1e3 * t_code:.3f} ms for {CHUNK_Q} CSR queries "
        f"({first.nnz} nonzeros), {sum(code_launches.values())} launches "
        f"{json.dumps(code_launches)}; drawing all {crp.n_units} units alone "
        f"{1e3 * t_draw:.3f} ms ({-(-crp.n_units // group)} launches of "
        f"{group})")
    src_t = torch.from_numpy(src_ids.astype(np.int32)).to(device)
    out = {}
    for name, kw in (("count", {}), ("scored_f32", dict(scored=True))):
        engine.search(first, top_k=TOP_K, chunk_q=CHUNK_Q, **kw)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = engine.search(queries, top_k=TOP_K, chunk_q=CHUNK_Q, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates[f"{name}_queries_s"] = N_QUERIES / dt
        ids, rho = out[name]
        hits = int((ids[:N_PLANTED, 0] == src_t).sum())
        log(f"url search {name}: {N_QUERIES} CSR queries in {dt:.4f} s = "
            f"{N_QUERIES / dt:.1f} queries/s; planted at rank 0: "
            f"{hits}/{N_PLANTED}; planted rho_hat median "
            f"{float(rho[:N_PLANTED, 0].median()):.4f}, random-query top "
            f"rho_hat median {float(rho[N_PLANTED:, 0].median()):.4f}")
        if ids.shape != (N_QUERIES, TOP_K) or \
                not bool(torch.isfinite(rho).all()):
            raise AssertionError(f"url {name}: wrong shape or non-finite rho")
        if hits != N_PLANTED:
            raise AssertionError(f"url {name}: planted at rank 0 "
                                 f"{hits}/{N_PLANTED}")
    mut = MutableAnnEngine(crp, band_spec=BandSpec(16, 4),
                           tail_rows=URL_CHUNK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for csr in kept:
        mut.ingest(csr, chunk_rows=URL_CHUNK)
    torch.cuda.synchronize()
    t_mut = time.perf_counter() - t0
    counts = ops.launch_counts()
    log(f"launch counts on the url path: {json.dumps(counts)}")
    require_launched(counts, "url")
    rates["mutable_ingest_rows_s"] = 2 * URL_CHUNK / t_mut
    if not torch.equal(mut.store.live_words(), store.words[:2 * URL_CHUNK]):
        raise AssertionError("url: the mutable engine's words differ from "
                             "the CodeStore's")
    log(f"url mutable ingest: {2 * URL_CHUNK} rows in {t_mut:.3f} s = "
        f"{2 * URL_CHUNK / t_mut:.1f} rows/s; live words equal the "
        f"CodeStore's first {2 * URL_CHUNK} rows")
    del mut, kept

    # 16 corpus rows (planted sources) through the plain versions, and
    # against a float64 oracle over their touched units
    ids16 = src_ids[:16]
    csr16 = as_csr(src_cols[:16], src_vals[:16])
    stored = store.words[torch.from_numpy(ids16).to(device)]
    t0 = time.perf_counter()
    if not torch.equal(enc.encode_packed(csr16, impl="ref"), stored):
        raise AssertionError("url: 16 rows differ from impl='ref'")
    log(f"url recheck: 16 rows bit-exact against impl='ref' on the card "
        f"({time.perf_counter() - t0:.1f} s)")
    ru = crp.cfg.r_unit
    flat_c = src_cols[:16].reshape(-1).astype(np.int64)
    gathered = np.zeros((flat_c.size, K), np.float64)
    for u in np.unique(flat_c // ru).tolist():
        r = crp._block_r(u, crp.unit_width(u)).cpu().numpy()
        at = np.flatnonzero(flat_c // ru == u)
        gathered[at] = r[flat_c[at] - u * ru]
    z64 = (src_vals[:16].reshape(-1, 1).astype(np.float64) * gathered) \
        .reshape(16, URL_NNZ, K).sum(axis=1)
    z64_t = torch.from_numpy(z64)
    want = schemes.encode(z64_t, crp.spec)
    got = packing.unpack_codes(stored.cpu(), bits, K)
    edge = check_codes(got, want, z64_t, crp.spec, None,
                       "url float64 oracle")
    rates["oracle_edge_fields"] = edge
    log(f"url float64 oracle: 16 rows x {K} fields, {edge} differ, each "
        f"within {EDGE_TOL} of a bin edge")
    if profile:
        chunk1 = as_csr(*url_chunk(1))
        wall, busy, copies = profile_window(
            f"url ingest of chunk 1 ({URL_CHUNK} rows)",
            lambda: enc.encode_packed(chunk1), top=6)
        log(f"profile url ingest of chunk 1 ({URL_CHUNK} rows): idle share "
            f"with the copy engine's transfers counted busy "
            f"{1 - (busy + copies) / wall:.3f}; the copy of its CSR arrays "
            f"to the card alone {csr_copy_ms(chunk1, device):.3f} ms (host "
            f"clock, synced, median of 3)")
        profile_window(f"url count-ranked search of {CHUNK_Q} CSR queries",
                       lambda: engine.search(first, top_k=TOP_K,
                                             chunk_q=CHUNK_Q), top=6)
    return counts, rates


def dense_cross_check(device) -> tuple:
    """Dense rows above the cap (D = 131,072, 32 units): fused with R
    resident (cap raised), streamed at the default cap, and the same rows
    as CSR, agreeing but at bin edges. Launches counted over the three
    encodes (the per-unit draw runs here: R's units for residency and the
    dense stream)."""
    import torch
    from repro_torch.core import packing
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    from repro_torch.encode import CsrMatrix, StreamingEncoder
    from repro_torch.kernels import ops
    d, n = 131_072, 8192
    crp = CodedRandomProjection(SketchConfig(k=K, scheme="2bit", w=0.75,
                                             seed=0), d)
    gen = torch.Generator(device=device).manual_seed(31)
    x = torch.randn((n, d), generator=gen, device=device)
    x *= torch.rand((n, d), generator=gen, device=device) < 0.01
    x /= x.norm(dim=1, keepdim=True)           # unit rows, as the main path's
    resident = StreamingEncoder(crp, r_cap_elems=1 << 25)
    streamed = crp.stream_encoder()
    t0 = time.perf_counter()
    csr = CsrMatrix.from_dense(x.cpu().numpy())
    t_csr = time.perf_counter() - t0
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    fused = resident.encode_packed(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    words = streamed.encode_packed(x)
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    sparse = streamed.encode_packed(csr)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    require_launched(counts, "dense")
    z = streamed.project(x)
    base = packing.unpack_codes(words, crp.spec.bits, K)
    flips = {}
    for name, other in (("fused", fused), ("csr", sparse)):
        flips[name] = check_codes(packing.unpack_codes(other, crp.spec.bits,
                                                       K),
                                  base, z, crp.spec, None,
                                  f"dense cross-check {name}")
    if streamed._rmat is not None or resident._rmat is None:
        raise AssertionError("dense cross-check: R residency is wrong")
    log(f"dense cross-check: {n} rows, D={d} ({crp.n_units} units), "
        f"{csr.nnz} nonzeros: streamed {t_stream:.4f} s = "
        f"{n / t_stream:.1f} rows/s; fields differing from streamed: fused "
        f"{flips['fused']}, csr {flips['csr']} of {n * K}, each within "
        f"{EDGE_TOL} of a bin edge (CSR made in {t_csr:.1f} s)")
    return counts, dict(dense_stream_rows_s=n / t_stream,
                        fused_edge=flips["fused"], csr_edge=flips["csr"])


def learn_protos():
    """The learn path's 64 prototype rows (URL_NNZ columns each, as
    ``url_rows`` makes them); prototypes 0-31 are class +1, 32-63 class
    -1, and prototype p is class p % 8 of the one-vs-rest fit."""
    import numpy as np
    return url_rows(np.random.default_rng(LEARN_SEED), LEARN_PROTOS)


def learn_rows(rng, protos, n: int):
    """n rows, each a prototype with each nonzero moved to a fresh uniform
    column (new value, same scale) with probability LEARN_MOVED / URL_NNZ:
    about 35 of 115, a cosine of about 0.7 to its prototype -> (cols int32
    [n, URL_NNZ], vals float32 [n, URL_NNZ], prototype ids int64 [n]).
    A moved column may repeat one in the row; the projection sums both."""
    import numpy as np
    pcols, pvals = protos
    pid = rng.integers(0, LEARN_PROTOS, n)
    cols, vals = pcols[pid], pvals[pid]
    moved = rng.random((n, URL_NNZ)) < LEARN_MOVED / URL_NNZ
    m = int(moved.sum())
    cols[moved] = rng.integers(0, URL_D, m, dtype=np.int32)
    vals[moved] = rng.standard_normal(m, dtype=np.float32) * \
        np.float32(1 / math.sqrt(URL_NNZ))
    return cols, vals, pid


def prototype_cosine(cols, vals, pid, protos, m: int = 2048) -> float:
    """Mean cosine of the first m rows to their prototypes."""
    import numpy as np
    pcols, pvals = protos
    cos = []
    for i in range(min(m, cols.shape[0])):
        a = np.zeros(URL_NNZ, np.float64)
        for j, c in enumerate(cols[i]):        # a repeated column adds up
            hit = np.flatnonzero(pcols[pid[i]] == c)
            if hit.size:
                a[j] = pvals[pid[i], hit[0]]
        dense = {}
        for c, v in zip(cols[i].tolist(), vals[i].astype(np.float64)):
            dense[c] = dense.get(c, 0.0) + v
        norm = math.sqrt(sum(v * v for v in dense.values()))
        cos.append(float(vals[i].astype(np.float64) @ a) /
                   (norm * float(np.linalg.norm(pvals[pid[i]]))))
    return float(np.mean(cos))


def learn_kernel_phase(rows, words, device) -> None:
    """The packed-linear kernels at the learn path's shapes, on its
    2,330,594 training rows: forward and backward at C = 1 and C = 8, both
    masked forms with 10 % of the rows dead, each bit-exact against its
    plain version and timed beside it, its bound and its library yardstick
    (F.embedding_bag over flat indices for the forward; for the backward
    torch.bincount with weights at C = 1 and g @ one-hot at C = 8; indices
    and one-hot made outside the window); the C = 1 rows go to the
    kernels line, with the C = 8 times under ``c8_`` keys. The forward is
    printed beside the floor of its shared-memory reads, with its plan and
    the registers and spills of its instance. The backward's
    partial kernel and fold are timed apart at both C, each beside its
    bound (and the partial kernel beside the floor of P predicated adds a
    (row, class, field)), with the plan and the registers and spills of
    each. Then a float64 oracle over 4,096 rows from a dense one-hot."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import packing
    from repro_torch.kernels import ops, packed_linear, ref
    gen = torch.Generator(device=device).manual_seed(16)
    n, w = words.shape
    bits, p = 2, 4
    f_all = w * (32 // bits)
    fp = f_all * p
    live = torch.rand((n,), generator=gen, device=device) >= 0.1
    valid = packing.pack_bitmask(live)
    n_live = int(live.sum())
    shifts = torch.arange(32 // bits, device=device) * bits
    flat = (((packing.as_u32(words)[:, :, None] >> shifts) & (p - 1))
            .reshape(n, f_all) + torch.arange(f_all, device=device) * p)
    live_w = live[:, None].to(torch.float32).expand(n, f_all).contiguous()
    for c in (1, 8):
        tab = torch.randn((c, fp), generator=gen, device=device)
        g = torch.randn((c, n), generator=gen, device=device)
        g_live = g * live
        # the yardsticks' inputs, made outside the windows: at C = 1 g
        # repeated a field, for torch.bincount; at C = 8 the one-hot
        # [N, F*P], 9.5 GB, for one matmul that gives every class at once
        if c == 1:
            g_rep = g[0][:, None].expand(n, f_all).reshape(-1)
            g_live_rep = g_live[0][:, None].expand(n, f_all).reshape(-1)

            def lib_bwd(masked):
                return torch.bincount(flat.reshape(-1), minlength=fp,
                                      weights=g_live_rep if masked
                                      else g_rep)[None]
        else:
            hot = torch.zeros((n, fp), device=device).scatter_(1, flat, 1.0)

            def lib_bwd(masked):
                return (g_live if masked else g) @ hot
        # The bytes the function must move, each once: the words of the
        # rows it reads (the masked forms need only the live rows'), the
        # tables and the margins (or g and the gradients), and the mask's
        # bits. A float add a (row, class, field) it reads.
        words_b = {False: 4.0 * n * w, True: 4.0 * n_live * w + n / 8}
        other_b = 4.0 * (c * fp + c * n)
        adds = {False: float(n) * c * f_all, True: float(n_live) * c * f_all}
        cases = {
            "packed_linear_fwd": (
                lambda: ops.packed_linear_fwd(tab, words, bits, impl="kernel"),
                lambda: ref.packed_linear_fwd_ref(tab, words, bits),
                lambda: F.embedding_bag(flat, tab.t().contiguous(),
                                        mode="sum").t(), False),
            "packed_linear_fwd_masked": (
                lambda: ops.packed_linear_fwd_masked(tab, words, valid, bits,
                                                     impl="kernel"),
                lambda: ref.packed_linear_fwd_masked_ref(tab, words, valid,
                                                         bits),
                lambda: F.embedding_bag(flat, tab.t().contiguous(),
                                        mode="sum",
                                        per_sample_weights=live_w).t(),
                True),
            "packed_linear_bwd": (
                lambda: ops.packed_linear_bwd(g, words, bits, impl="kernel"),
                lambda: ref.packed_linear_bwd_ref(g, words, bits),
                lambda: lib_bwd(False), False),
            "packed_linear_bwd_masked": (
                lambda: ops.packed_linear_bwd_masked(g, words, valid, bits,
                                                     impl="kernel"),
                lambda: ref.packed_linear_bwd_masked_ref(g, words, valid,
                                                         bits),
                lambda: lib_bwd(True), True),
        }
        for name, (fn_k, fn_p, fn_lib, masked) in cases.items():
            t0 = time.perf_counter()
            got = fn_k()
            if not same_bits(got, fn_p()):
                raise AssertionError(f"{name} differs from its plain version "
                                     f"at C={c}")
            lib_err = float((fn_lib() - got).abs().max())
            lib_ms = time_ms(fn_lib)
            ms = time_ms(fn_k)
            plain_ms = time_ms(fn_p, reps=3, warmup=1)
            b_ms, b_by, pipe = bound([("f32 add", adds[masked], F32_ADD_S)],
                                     words_b[masked] + other_b)
            log(f"kernel {name}: [C={c}, N={n}, W={w}] live "
                f"{n_live if masked else n} bit-exact ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (max abs "
                f"difference {lib_err:.3e}) bound_ms={b_ms:.5f} ({b_by}, "
                f"{pipe}); phase {time.perf_counter() - t0:.1f} s")
            if c == 1:
                rows[name] = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by,
                                  bound_pipe=pipe, library_ms=lib_ms,
                                  shape=[c, n, w],
                                  live_rows=n_live if masked else n)
            else:
                rows[name].update(c8_ms=ms, c8_bound_ms=b_ms,
                                  c8_library_ms=lib_ms)
            if name.startswith("packed_linear_fwd"):
                # the forward's own floor: a shared-memory wavefront for a
                # warp's 32 (row, class, field) table reads, live rows only
                plan = packed_linear.fwd_plan(n, w, bits, c, masked=masked,
                                              device=device)
                floor_ms = 1e3 * adds[masked] / 32 / LDS_WAVES_S
                regs = LINEAR_PTXAS.get(
                    f"linear_fwd_smemILi{bits}ELb{int(masked)}EE",
                    (None, None))
                log(f"kernel {name} [C={c}, N={n}, W={w}]: ms={ms:.4f} "
                    f"shared-memory floor {floor_ms:.4f} ms, bound_ms="
                    f"{b_ms:.5f}; plan {plan['form']} class_tile "
                    f"{plan['class_tile']} rows a tile {plan['threads']} "
                    f"smem {plan['smem']} blocks/SM {plan['blocks_per_sm']} "
                    f"grid {plan['grid']} tiles {plan['tiles']} tiles/block "
                    f"{plan['tiles_per_block']}; registers {regs[0]} "
                    f"(spills {regs[1]} B)")
                rows[name].update({
                    f"{'' if c == 1 else 'c8_'}{key}": val for key, val in (
                        ("smem_floor_ms", floor_ms), ("registers", regs[0]),
                        ("spill_bytes", regs[1]),
                        ("blocks_per_sm", plan["blocks_per_sm"]),
                        ("grid", list(plan["grid"])))})
        # the backward's two halves apart, each beside its bound: the
        # partial kernel reads the words (the live rows'), g and the mask
        # and writes the partials, a float add a (row, class, field) it
        # reads; its own floor adds P times, each predicated on the code;
        # the fold reads the partials and writes the gradients, an add a
        # partial entry
        for name, v in (("packed_linear_bwd", None),
                        ("packed_linear_bwd_masked", valid)):
            masked = v is not None
            plan = packed_linear.bwd_plan(n, w, bits, c, 512, masked=masked,
                                          device=device)
            part = packed_linear.bwd_partials_cuda(g, words, bits,
                                                   valid_words=v)
            whole = (ops.packed_linear_bwd_masked(g, words, v, bits,
                                                  impl="kernel") if masked
                     else ops.packed_linear_bwd(g, words, bits,
                                                impl="kernel"))
            if not same_bits(packed_linear.bwd_fold_cuda(part), whole):
                raise AssertionError(f"{name}: the fold of the partial "
                                     f"kernel's partials differs from the "
                                     f"whole at C={c}")
            part_ms = time_ms(lambda: packed_linear.bwd_partials_cuda(
                g, words, bits, valid_words=v))
            fold_ms = time_ms(lambda: packed_linear.bwd_fold_cuda(part))
            pb_ms = bound([("f32 add", adds[masked], F32_ADD_S)],
                          words_b[masked] + 4.0 * c * n + 4.0 * part.numel())
            fb_ms = bound([("f32 add", float(part.numel()), F32_ADD_S)],
                          4.0 * part.numel() + 4.0 * c * fp)
            floor_ms = 1e3 * p * adds[masked] / F32_ADD_S
            kname = (f"linear_bwd_partial_tiledILi{bits}ELi"
                     f"{plan['classes_per_thread']}ELb{int(masked)}EE")
            regs = LINEAR_PTXAS.get(kname, (None, None))
            fold_regs = LINEAR_PTXAS.get("linear_bwd_fold", (None, None))
            log(f"kernel {name} halves [C={c}, N={n}, W={w}]: partial "
                f"ms={part_ms:.4f} bound_ms={pb_ms[0]:.5f} ({pb_ms[2]}; P "
                f"predicated adds {floor_ms:.4f}), fold ms={fold_ms:.4f} "
                f"bound_ms={fb_ms[0]:.5f} ({fb_ms[2]}) over {part.shape[0]} "
                f"chunks; plan CT {plan['classes_per_thread']} FT "
                f"{plan['fields_per_thread']} threads {plan['threads']} "
                f"tile_rows {plan['tile_rows']} x {plan['tiles_per_chunk']} "
                f"smem {plan['smem']} blocks/SM {plan['blocks_per_sm']} "
                f"chunks/block {plan['chunks_per_block']} grid "
                f"{plan['grid']} fold grid {plan['fold_grid']}; registers "
                f"{regs[0]} (spills {regs[1]} B), fold {fold_regs[0]} "
                f"(spills {fold_regs[1]} B)")
            rows[name].update({
                f"{'' if c == 1 else 'c8_'}{key}": val for key, val in (
                    ("partial_ms", part_ms), ("partial_bound_ms", pb_ms[0]),
                    ("partial_add_floor_ms", floor_ms), ("fold_ms", fold_ms),
                    ("fold_bound_ms", fb_ms[0]), ("registers", regs[0]),
                    ("spill_bytes", regs[1]), ("fold_registers", fold_regs[0]),
                    ("tile_rows", plan["tile_rows"]),
                    ("classes_per_thread", plan["classes_per_thread"]))})
            del part, whole
        if c == 1:
            del g_rep, g_live_rep
        else:
            del hot
    del live_w
    del flat
    torch.cuda.empty_cache()

    # float64 oracle from a dense one-hot: each kernel result within 1e-5
    # of the sum of its terms' magnitudes
    m = LEARN_ORACLE_ROWS
    sub = words[:m].contiguous()
    hot = ref.onehot_rows(sub, bits, torch.float64)
    tab = torch.randn((8, fp), generator=gen, device=device)
    g = torch.randn((8, m), generator=gen, device=device)
    worst = {}
    for name, got, want, terms in (
            ("margins", ops.packed_linear_fwd(tab, sub, bits, impl="kernel"),
             tab.double() @ hot.t(), tab.double().abs() @ hot.t()),
            ("gradients", ops.packed_linear_bwd(g, sub, bits, impl="kernel"),
             g.double() @ hot, g.double().abs() @ hot)):
        rel = float(((got.double() - want).abs() / terms.clamp(min=1e-300))
                    .max())
        worst[name] = rel
        if rel > 1e-5:
            raise AssertionError(f"float64 oracle: {name} off by {rel:.3e} "
                                 f"of their terms' magnitudes")
    log(f"learn float64 oracle ({m} rows, C=8, dense one-hot): margins "
        f"within {worst['margins']:.3e}, gradients within "
        f"{worst['gradients']:.3e} of their terms' magnitudes (gate 1e-5)")


def learn_path(device, rows, profile: bool = False) -> tuple:
    """SVM training on packed codes at the URL corpus's published shape:
    CSR rows with planted labels -> IngestPipeline -> CodeStore ->
    fit_store (full batch), fit_words (minibatch; one-vs-rest) ->
    MutableAnnEngine, churn -> fit_log, counted; then the gates and the
    packed-linear kernels at these shapes."""
    import numpy as np
    import torch
    from repro_torch.ann import CodeStore
    from repro_torch.core import packing
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    from repro_torch.encode import IngestPipeline
    from repro_torch.index import MutableAnnEngine
    from repro_torch.kernels import ops
    from repro_torch.learn import LearnConfig, fit_log, fit_store, fit_words
    from repro_torch.learn.linear import (adam_update, packed_data_grads,
                                          packed_loss_and_grads, targets_pm)
    crp = CodedRandomProjection(SketchConfig(k=K, scheme="2bit", w=0.75,
                                             seed=0), URL_D)
    enc, bits = crp.stream_encoder(), crp.spec.bits
    w_words = packing.packed_width(K, bits)
    n_all, n_chunks = URL_ROWS, -(-URL_ROWS // URL_CHUNK)
    n_train = n_all - LEARN_HELD
    protos = learn_protos()
    t0 = time.perf_counter()
    chunks = [learn_rows(np.random.default_rng([LEARN_SEED, c]), protos,
                         min(URL_CHUNK, n_all - c * URL_CHUNK))
              for c in range(n_chunks)]
    pid = np.concatenate([ch[2] for ch in chunks])
    cos = prototype_cosine(*chunks[0], protos)
    t_gen = time.perf_counter() - t0
    y = np.where(pid < LEARN_PROTOS // 2, 1, -1)
    y_tr, y_ho = y[:n_train], y[n_train:]
    log(f"learn: {n_all} CSR rows at D={URL_D}, {URL_NNZ} nonzeros, each one "
        f"of {LEARN_PROTOS} prototypes with each nonzero moved with "
        f"probability {LEARN_MOVED}/{URL_NNZ}: mean cosine {cos:.4f} to the "
        f"prototype (first {min(2048, URL_CHUNK)} rows); labels: prototype < "
        f"{LEARN_PROTOS // 2} -> +1 ({int((y_tr > 0).sum())} of {n_train} "
        f"training rows), one-vs-rest: prototype % {LEARN_OVR}; made on the "
        f"host in {t_gen:.1f} s, outside every window; last {LEARN_HELD} "
        f"rows held out")

    def empty_store():
        return CodeStore(words=torch.zeros((0, w_words), dtype=torch.int32,
                                           device=device), k=K, bits=bits)

    rates = {}
    ops.reset_launch_counts()
    pipe = IngestPipeline(enc, empty_store(), chunk_rows=URL_CHUNK)
    held = IngestPipeline(enc, empty_store(), chunk_rows=URL_CHUNK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c, (cols, vals, _) in enumerate(chunks):
        lo = c * URL_CHUNK
        cut = max(0, min(cols.shape[0], n_train - lo))
        if cut:
            pipe.ingest(as_csr(cols[:cut], vals[:cut]))
        if cut < cols.shape[0]:
            held.ingest(as_csr(cols[cut:], vals[cut:]))
    torch.cuda.synchronize()
    t_ing = time.perf_counter() - t0
    store, held_words = pipe.store, held.store.words
    if store.n != n_train or held_words.shape[0] != LEARN_HELD:
        raise AssertionError("learn: the stores are short")
    onehot_bytes = 4.0 * n_train * K * (1 << bits)
    log(f"learn ingest: {n_all} rows in {t_ing:.3f} s = {n_all / t_ing:.1f} "
        f"rows/s; training store {store.nbytes} bytes, its one-hot would be "
        f"{onehot_bytes:.0f} bytes")

    # the first 3 Adam steps, kernels against plain versions on the card
    m_k = fit_store(store, y_tr, crp, LearnConfig(steps=3))
    m_r = fit_store(store, y_tr, crp, LearnConfig(steps=3, impl="ref"))
    if not (same_bits(m_k.tables, m_r.tables) and
            same_bits(m_k.bias, m_r.bias)):
        raise AssertionError("learn: 3 full-batch steps differ between "
                             "impl='auto' and impl='ref'")
    log("learn: 3 full-batch Adam steps bit-exact between impl='auto' and "
        "impl='ref' (tables and bias)")
    del m_k, m_r

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def held_acc(model, labels):
        return model.accuracy(held_words, labels)

    cfg = LearnConfig()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    m_full, t_full = timed(lambda: fit_store(store, y_tr, crp, cfg))
    peak = torch.cuda.max_memory_allocated() - before
    acc_full = held_acc(m_full, y_ho)
    rates.update(full_row_steps_s=n_train * cfg.steps / t_full,
                 full_step_ms=1e3 * t_full / cfg.steps,
                 full_held_acc=acc_full, full_peak_bytes=peak)
    log(f"learn fit_store full batch: {cfg.steps} steps over {n_train} rows "
        f"in {t_full:.3f} s = {1e3 * t_full / cfg.steps:.4f} ms a step, "
        f"{n_train * cfg.steps / t_full:.1f} row-steps/s; held-out accuracy "
        f"{acc_full:.4f}; peak device memory beyond the store {peak} bytes "
        f"({peak / onehot_bytes:.5f} of the one-hot)")
    if peak > onehot_bytes / 16:
        raise AssertionError(f"learn: peak {peak} bytes over 1/16 of the "
                             f"one-hot")

    mb = LearnConfig(batch=LEARN_BATCH, steps=LEARN_MB_STEPS)
    m_mb, t_mb = timed(lambda: fit_words(store.words, y_tr, crp, mb))
    rng = np.random.default_rng(mb.seed)
    t0 = time.perf_counter()
    for _ in range(mb.steps):
        rng.choice(n_train, size=mb.batch, replace=False)
    t_draw = time.perf_counter() - t0
    acc_mb = held_acc(m_mb, y_ho)
    rates.update(mb_row_steps_s=mb.batch * mb.steps / t_mb,
                 mb_held_acc=acc_mb, mb_draw_s=t_draw)
    log(f"learn fit_words minibatch: {mb.steps} steps of {mb.batch} rows in "
        f"{t_mb:.3f} s = {mb.batch * mb.steps / t_mb:.1f} row-steps/s; "
        f"held-out accuracy {acc_mb:.4f}; the host's index draws "
        f"(rng.choice without replacement over {n_train} rows, as the "
        f"reference draws them) {t_draw:.3f} s of it")

    ovr = LearnConfig(steps=LEARN_OVR_STEPS)
    m_ovr, t_ovr = timed(lambda: fit_words(store.words, pid[:n_train] %
                                           LEARN_OVR, crp, ovr,
                                           n_outputs=LEARN_OVR))
    acc_ovr = held_acc(m_ovr, pid[n_train:] % LEARN_OVR)
    rates.update(ovr_row_steps_s=n_train * ovr.steps / t_ovr,
                 ovr_held_acc=acc_ovr)
    log(f"learn fit_words one-vs-rest, C={LEARN_OVR}: {ovr.steps} steps in "
        f"{t_ovr:.3f} s = {n_train * ovr.steps / t_ovr:.1f} row-steps/s; "
        f"held-out accuracy {acc_ovr:.4f}")

    _, t_inf = timed(lambda: m_full.margins(held_words))
    _, t_inf_all = timed(lambda: m_full.margins(store.words))
    rates.update(infer_held_rows_s=LEARN_HELD / t_inf,
                 infer_train_rows_s=n_train / t_inf_all)
    log(f"learn inference (margins): {LEARN_HELD} held-out rows in "
        f"{1e3 * t_inf:.3f} ms = {LEARN_HELD / t_inf:.1f} rows/s; all "
        f"{n_train} training rows in {1e3 * t_inf_all:.3f} ms = "
        f"{n_train / t_inf_all:.1f} rows/s")
    del m_mb, m_ovr

    # the log: training rows in 262,144-row segments, 10 % deleted, 65,536
    # upserted with new rows and labels
    mut = MutableAnnEngine(crp, tail_rows=LEARN_TAIL)
    label_of = y_tr.astype(np.int64)
    (ids, t_add) = timed(lambda: mut.add_words(store.words))
    rng = np.random.default_rng(LEARN_SEED + 1)
    dead = rng.choice(n_train, n_train // 10, replace=False)
    _, t_del = timed(lambda: mut.delete(dead))
    alive = np.setdiff1d(ids, dead)
    up = np.sort(rng.choice(alive, LEARN_UPSERT, replace=False))
    cols, vals, up_pid = learn_rows(np.random.default_rng([LEARN_SEED,
                                                           n_chunks]),
                                    protos, LEARN_UPSERT)
    _, t_up = timed(lambda: mut.upsert(up, as_csr(cols, vals)))
    label_of[up] = np.where(up_pid < LEARN_PROTOS // 2, 1, -1)
    log(f"learn log: {n_train} rows added in {t_add:.3f} s, {dead.size} "
        f"deleted in {t_del:.3f} s, {LEARN_UPSERT} upserted (new rows and "
        f"labels) in {t_up:.3f} s: {mut.store.n_segments} segments, "
        f"{mut.n} live")
    lcfg = LearnConfig(steps=LEARN_LOG_STEPS)
    m_log, t_log = timed(lambda: fit_log(mut.store, lambda i: label_of[i],
                                         crp, lcfg))
    live_words = mut.store.live_words()
    y_live = label_of[mut.store.live_ids()]
    m_fresh, t_fresh = timed(lambda: fit_words(live_words, y_live, crp, lcfg))
    rates.update(log_row_steps_s=mut.n * lcfg.steps / t_log,
                 log_fresh_row_steps_s=mut.n * lcfg.steps / t_fresh)
    counts = ops.launch_counts()
    log(f"launch counts on the learn path: {json.dumps(counts)}")
    require_launched(counts, "learn")

    diff = (m_log.tables - m_fresh.tables).abs()
    tol = 1e-5 + 1e-4 * m_fresh.tables.abs()
    agree = float((m_log.predict(held_words) ==
                   m_fresh.predict(held_words)).float().mean())
    acc_log = held_acc(m_log, y_ho)
    rates.update(log_held_acc=acc_log, log_fresh_agree=agree,
                 log_max_table_diff=float(diff.max()))
    log(f"learn fit_log over {mut.store.n_segments} segments: "
        f"{lcfg.steps} steps in {t_log:.3f} s = "
        f"{mut.n * lcfg.steps / t_log:.1f} row-steps/s (fit_words over "
        f"live_words(): {t_fresh:.3f} s); tables differ by at most "
        f"{float(diff.max()):.3e} ({int((diff > tol).sum())} entries beyond "
        f"rtol 1e-4, atol 1e-5); held-out predictions agree on {agree:.5f}; "
        f"held-out accuracy {acc_log:.4f}")
    if bool((diff > tol).any()) or agree < 0.999:
        raise AssertionError("learn: fit_log departs from fit_words over the "
                             "live rows")
    for name, acc in (("fit_store", acc_full), ("minibatch", acc_mb),
                      ("fit_log", acc_log)):
        if acc < 0.9:
            raise AssertionError(f"learn {name}: held-out accuracy {acc:.4f}"
                                 f" < 0.9")

    if profile:
        params = (m_full.tables.clone(), m_full.bias.clone())
        moments = tuple(tuple(torch.zeros_like(p) for p in params)
                        for _ in range(2))
        y_pm = targets_pm(y_tr, 1, device)
        fspec = m_full.fspec

        def full_step():
            g = packed_loss_and_grads(params, store.words, y_pm, fspec)[1]
            adam_update(params, *moments, g, 1, cfg.steps, cfg.lr)

        parts = [(seg.words, seg.valid_dev(), targets_pm(
                  torch.from_numpy(np.where(
                      seg.ids >= 0, label_of[np.maximum(seg.ids, 0)], 1)),
                  1, device)) for seg in mut.store.segments() if seg.live]

        def log_step():
            dt = torch.zeros_like(params[0])
            for words, vw, yp in parts:
                dt = dt + packed_data_grads(params, words, yp, fspec,
                                            valid_words=vw)[1][0]

        profile_window("learn full-batch step (fit_store)", full_step, top=8)
        profile_window(f"learn fit_log gradient over "
                       f"{len(parts)} segments", log_step, top=8)
    del mut, live_words
    learn_kernel_phase(rows, store.words, device)
    torch.cuda.empty_cache()
    return counts, rates, (store, y_tr, held_words, crp)


def serve_checks(device) -> None:
    """Small ragged shapes for TPU kernels 15-17 and the two repairs, each
    kernel against its plain version, bit for bit: the LUT top-k kernels
    over bits 1/2/4/8/16 x float32 and bf16 tables x N 0/1/31/33/3,000
    (top_k above the live rows) x all, none, 10 % and 90 % of the rows
    dead, and all rows tied; then the fields kernel's grid (Q 1, 7, 8, 9,
    17 and 300, N 1,000 and 2,081, S 1, 3 and 64 and QB 8 and 16 given,
    4-bit tables at k = 256 and 264, top_k 1,500; every default launch
    twice); the count kernel on int32 codes of any value
    at every tile size; top_k and rerank_m above 2048 in every top-k
    kernel; the bf16 draw (whole units, all 128 uniforms) against the
    CPU's prng; bf16 R through the GEMMs and bf16 z through code_pack."""
    import torch
    from repro_torch.core import packing, prng
    from repro_torch.core.schemes import CodeSpec
    from repro_torch.kernels import collision, lut_topk, ops, ref
    gen = torch.Generator(device=device).manual_seed(16)

    def words(n, k, bits):
        return ref.pack_codes_ref(torch.randint(
            0, 1 << bits, (n, k), generator=gen, device=device), bits)

    def mask(n, dead):
        return packing.pack_bitmask(
            torch.rand((n,), generator=gen, device=device) >= dead)

    def tables(nq, k, bits, dtype=torch.float32):
        fp = packing.packed_width(k, bits) * (32 // bits) << bits
        return torch.randn((nq, fp), generator=gen, device=device).to(dtype)

    def check(name, got, want, *what):
        if not same(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"{what}")

    t0 = time.perf_counter()
    for bits in (1, 2, 4, 8, 16):
        k = 17 if bits == 16 else 40
        for dtype in (torch.float32, torch.bfloat16):
            for nq, n, top_k in ((9, 3000, 10), (5, 33, 50), (3, 31, 7),
                                 (2, 1, 3), (2, 0, 3)):
                wdb, tab = words(n, k, bits), tables(nq, k, bits, dtype)
                check("packed_lut_topk",
                      ops.packed_lut_topk(tab, wdb, bits, top_k,
                                          impl="kernel"),
                      ref.packed_lut_topk_ref(tab, wdb, bits, top_k),
                      bits, dtype, n, top_k)
                for dead in (1.0, 0.0, 0.1, 0.9):
                    vw = mask(n, dead)
                    check("packed_lut_topk_masked",
                          ops.packed_lut_topk_masked(tab, wdb, vw, bits,
                                                     top_k, impl="kernel"),
                          ref.packed_lut_topk_masked_ref(tab, wdb, vw, bits,
                                                         top_k),
                          bits, dtype, n, top_k, dead)
    tab, wdb = torch.ones((2, 4 * 16 * 4), device=device), words(500, 64, 2)
    got = ops.packed_lut_topk(tab, wdb, 2, 20, impl="kernel")
    check("packed_lut_topk", got, ref.packed_lut_topk_ref(tab, wdb, 2, 20),
          "all rows tied")
    if got[1][0].tolist() != list(range(20)):
        raise AssertionError("tied LUT scores did not go to the lowest ids")

    # the fields kernel's grid: Q around its blocks of 8 and 16, N ragged
    # against its 256-row tiles and 32-row offers, S and QB given, 4-bit
    # tables at k = 256 (the largest it takes; at top_k 1,500 its lists
    # live in device memory) and at k = 264 (the generic kernel's)
    def lut(tab, wdb, vw, bits, top_k, **kw):
        if vw is None:
            return ops.packed_lut_topk(tab, wdb, bits, top_k, impl="kernel",
                                       **kw)
        return ops.packed_lut_topk_masked(tab, wdb, vw, bits, top_k,
                                          impl="kernel", **kw)

    t1, n_calls = time.perf_counter(), 0
    for bits, k, top_k, ns in ((1, 40, 10, (2081,)), (2, 40, 10, (1000, 2081)),
                               (4, 40, 10, (2081,)), (2, 256, 10, (2081,)),
                               (4, 256, 10, (2081,)), (4, 256, 1500, (2081,)),
                               (4, 264, 10, (2081,))):
        w = packing.packed_width(k, bits)
        kernel = "generic" if k == 264 else "fields"
        for n in ns:
            wdb, vw = words(n, k, bits), mask(n, 0.1)
            for nq in (1, 7, 8, 9, 17, 300):
                p = lut_topk.plan(torch.float32, nq, n, w, bits, top_k,
                                  device=device)
                if p["kernel"] != kernel:
                    raise AssertionError(f"bits {bits}, k {k}: the {p['kernel']}"
                                         f" kernel, not the {kernel} one")
                for dtype in (torch.float32, torch.bfloat16):
                    tab = tables(nq, k, bits, dtype)
                    for valid in (None, vw):
                        want = ref.packed_lut_topk_ref(
                            tab, wdb, bits, top_k) if valid is None else \
                            ref.packed_lut_topk_masked_ref(tab, wdb, valid,
                                                           bits, top_k)
                        first = lut(tab, wdb, valid, bits, top_k)
                        what = (bits, k, nq, n, top_k, dtype, valid is None)
                        check("packed_lut_topk", first, want, *what)
                        check("packed_lut_topk", lut(tab, wdb, valid, bits,
                                                     top_k), first,
                              "a second launch", *what)
                        for s in (None, 1, 3, 64):
                            for qb in (None, 8, 16):
                                if s is None and qb is None:
                                    continue
                                try:
                                    got = lut(tab, wdb, valid, bits, top_k,
                                              n_ranges=s, block_q=qb)
                                except ValueError:
                                    if lut_topk.fields_layout(
                                            w, bits, top_k, qb) is None:
                                        continue   # a QB that cannot fit
                                    raise
                                check("packed_lut_topk", got, want, s, qb,
                                      *what)
                                n_calls += 1
    log(f"small checks, the LUT top-k's grid: {n_calls} launches at given "
        f"S and QB bit-exact, every default launch twice "
        f"({time.perf_counter() - t1:.1f} s)")
    vals = torch.tensor([-2, -1, 0, 1, 7, 2 ** 31 - 1, -2 ** 31],
                        device=device, dtype=torch.int32)
    for nq, n, k in ((37, 3001, 100), (1, 1, 1), (130, 257, 256), (3, 0, 5)):
        cq = vals[torch.randint(0, 7, (nq, k), generator=gen, device=device)]
        cdb = vals[torch.randint(0, 7, (n, k), generator=gen, device=device)]
        want = ref.collision_counts_ref(cq, cdb)
        for bq in collision.BLOCKS:
            for bn in collision.BLOCKS:
                check("collision_counts",
                      ops.collision_counts(cq, cdb, impl="kernel",
                                           block_q=bq, block_n=bn),
                      want, nq, n, k, bq, bn)
    log(f"small checks, TPU kernels 15-17: bit-exact "
        f"({time.perf_counter() - t0:.1f} s)")

    # repair 1: top_k and rerank_m above 2048 (lists in device memory)
    t0 = time.perf_counter()
    bits, k, n, nq = 2, 64, 20000, 5
    wq, wdb, vw = words(nq, k, bits), words(n, k, bits), mask(n, 0.1)
    tab = tables(nq, k, bits)
    check("packed_topk", ops.packed_topk(wq, wdb, bits, k, 2049,
                                         impl="kernel"),
          ref.packed_topk_ref(wq, wdb, bits, k, 2049), "top_k 2049")
    check("packed_topk_masked",
          ops.packed_topk_masked(wq, wdb, vw, bits, k, 4000, impl="kernel"),
          ref.packed_topk_masked_ref(wq, wdb, vw, bits, k, 4000),
          "top_k 4000")
    for m, top_k in ((2052, 513), (5000, 2100)):
        check("fused_scored_topk",
              ops.fused_scored_topk(wq, tab, wdb, bits, k, m, top_k,
                                    impl="kernel"),
              ref.fused_scored_topk_ref(wq, tab, wdb, bits, k, m, top_k),
              m, top_k)
        check("fused_scored_topk_masked",
              ops.fused_scored_topk_masked(wq, tab, wdb, vw, bits, k, m,
                                           top_k, impl="kernel"),
              ref.fused_scored_topk_masked_ref(wq, tab, wdb, vw, bits, k, m,
                                               top_k), m, top_k)
    check("packed_lut_topk", ops.packed_lut_topk(tab, wdb, bits, 2049,
                                                 impl="kernel"),
          ref.packed_lut_topk_ref(tab, wdb, bits, 2049), "top_k 2049")
    cand = words(nq * 3000, k, bits).reshape(nq, 3000, -1)
    cvalid = torch.rand((nq, 3000), generator=gen, device=device) > 0.2
    check("packed_lut_rerank",
          ops.packed_lut_rerank(tab, cand, cvalid, bits, 2500, impl="kernel"),
          ref.packed_lut_rerank_ref(tab, cand, cvalid, bits, 2500),
          "top_k 2500")
    log(f"small checks, top_k and rerank_m above 2048: bit-exact "
        f"({time.perf_counter() - t0:.1f} s)")

    # repair 2: bf16 sketches
    t0 = time.perf_counter()
    for seed, u, width, kk in ((0, 0, 4096, 256), (0, 789, 217, 256),
                               (2 ** 31 + 5, 3, 1, 7)):
        key = prng.fold_in(prng.PRNGKey(seed), u)
        got = ops.normal_unit(key, width, kk, device, impl="kernel",
                              dtype=torch.bfloat16)
        want = prng.normal(key, (width, kk), dtype=torch.bfloat16)
        if not torch.equal(got.cpu().view(torch.int16),
                           want.view(torch.int16)):
            raise AssertionError(f"bf16 draw of unit {u} [{width}, {kk}] "
                                 f"differs from the CPU's prng")
    m = (prng.random_bits(prng.fold_in(prng.PRNGKey(0), 0), (4096, 256))
         >> 1) & 127
    if torch.unique(m).numel() != 128:
        raise AssertionError("the bf16 unit does not hold all 128 uniforms")
    for scheme, w in (("2bit", 0.75), ("offset", 1.0), ("uniform", 0.75)):
        spec = CodeSpec(scheme, w)
        x = unit_rows(300, 96, gen, device)
        r = torch.randn((96, 100), generator=gen, device=device).to(
            torch.bfloat16)
        q = (torch.rand((100,), generator=gen, device=device) * w).to(
            torch.bfloat16) if scheme == "offset" else None
        z = torch.matmul(x, r.float())
        want = ref.coded_project_ref(x, r, spec, q)
        qf = None if q is None else q.float()
        check_codes(ops.coded_project(x, r, spec, q, impl="kernel"), want, z,
                    spec, qf, f"coded_project bf16 R {scheme}")
        check_codes(packing.unpack_codes(
            ops.encode_fused(x, r, spec, q, impl="kernel"), spec.bits, 100),
            want, z, spec, qf, f"encode_fused bf16 R {scheme}")
        zb = (3.0 * torch.randn((777, 100), generator=gen,
                                device=device)).to(torch.bfloat16)
        check("code_pack", ops.code_pack(zb, spec, q, impl="kernel"),
              ref.code_pack_ref(zb, spec, q), "bf16 z", scheme)
    log(f"small checks, bf16 draw (all 128 uniforms, whole units) and bf16 "
        f"GEMM/code_pack: bit-exact but at counted bin edges "
        f"({time.perf_counter() - t0:.1f} s)")


def lut_kernel_rows(rows, q_tab, wdb, valid, n_live, bits) -> None:
    """Rows 15-16 (the LUT top-k, plain and masked) at the main path's
    shapes: bit-exact against the plain version, two launches alike, the
    default launch timed (its plan logged: kernel, QB, S, grid, resident
    blocks an SM, waves) beside the plain version and the float-add bound;
    then each QB of ``lut_topk.BLOCK_Q`` with float32 tables and with
    their bf16 rounding, each held against its plain version."""
    import torch
    from repro_torch.kernels import lut_topk, ops, ref
    nq, fp = q_tab.shape
    n, w_words = wdb.shape
    fields = w_words * (32 // bits)
    n_bytes = 4.0 * (n * w_words + nq * fp + 2 * nq * TOP_K)
    tabs = {"f32": q_tab, "bf16": q_tab.to(torch.bfloat16)}
    # the least work: one float add a (query, live row, field); each field
    # is decoded once for all queries, and the corpus and tables read once
    for name, vw, live in (("packed_lut_topk", None, n),
                           ("packed_lut_topk_masked", valid, n_live)):
        t0 = time.perf_counter()

        def run(tab, vw=vw, **kw):
            if vw is None:
                return ops.packed_lut_topk(tab, wdb, bits, TOP_K,
                                           impl="kernel", **kw)
            return ops.packed_lut_topk_masked(tab, wdb, vw, bits, TOP_K,
                                              impl="kernel", **kw)

        def plain(tab, vw=vw):
            if vw is None:
                return ref.packed_lut_topk_ref(tab, wdb, bits, TOP_K)
            return ref.packed_lut_topk_masked_ref(tab, wdb, vw, bits, TOP_K)

        b_ms, b_by, pipe = bound(
            [("f32 add", float(nq) * live * fields, F32_ADD_S)],
            n_bytes + (0 if vw is None else n / 8))
        variants = {}
        for dt, tab in tabs.items():
            want = plain(tab)
            got = run(tab)
            if not (same(got, want) and same(run(tab), got)):
                raise AssertionError(f"{name} ({dt} tables) differs from its "
                                     f"plain version or between launches")
            if dt == "f32":
                plan = lut_topk.plan(tab.dtype, nq, n, w_words, bits, TOP_K,
                                     device=wdb.device)
                ms = time_ms(lambda: run(tab))
                plain_ms = time_ms(lambda: plain(tab), reps=3, warmup=1)
            for qb in lut_topk.BLOCK_Q:
                p = lut_topk.plan(tab.dtype, nq, n, w_words, bits, TOP_K,
                                  block_q=qb, device=wdb.device)
                if not same(run(tab, block_q=qb), want):
                    raise AssertionError(f"{name} ({dt} tables, QB {qb}) "
                                         f"differs from its plain version")
                v_ms = time_ms(lambda: run(tab, block_q=qb))
                variants[f"{dt} QB {qb}"] = dict(
                    ms=v_ms, n_ranges=p["n_ranges"], grid=list(p["grid"]),
                    blocks_per_sm=p["blocks_per_sm"], waves=p["waves"],
                    smem=p["smem"])
                log(f"kernel {name} {dt} tables QB={qb}: S={p['n_ranges']} "
                    f"grid={list(p['grid'])} blocks/SM={p['blocks_per_sm']} "
                    f"smem={p['smem']} B waves={p['waves']:.3f} bit-exact "
                    f"ms={v_ms:.4f}")
            del want, got
        rows[name] = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, bound_pipe=pipe,
                          library_ms=None, shape=[nq, n, w_words, TOP_K],
                          live_rows=live, plan=dict(plan, grid=list(
                              plan["grid"])), variants=variants)
        log(f"kernel {name}: {[nq, n, w_words, TOP_K]} live {live} "
            f"{plan['kernel']} kernel QB={plan['block_q']} "
            f"S={plan['n_ranges']} grid={list(plan['grid'])} "
            f"blocks/SM={plan['blocks_per_sm']} waves={plan['waves']:.3f}; "
            f"bit-exact, two launches alike, bf16 tables bit-exact; "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
            f"({b_by}, {pipe}); phase {time.perf_counter() - t0:.1f} s")


def serve_kernel_phase(rows, crp, codes_q, wq, wdb, gen) -> None:
    """TPU kernels 15-17 at the main path's shapes, on the packed_topk
    phase's queries and 4,194,304-row corpus: the LUT top-k with the
    sketcher's float32 tables [256, 1,024] and their bf16 rounding (and
    10 % dead for the masked one; ``lut_kernel_rows``), and the unpacked
    count kernel on 256 x 4,194,304 codes at k = 256 (yardstick
    ``k - torch.cdist(q, db, p=0)``, exact for integer codes)."""
    import torch
    from repro_torch.core import packing
    from repro_torch.kernels import ops, ref
    from repro_torch.rank import build_rank_tables
    bits, nq = crp.spec.bits, CHUNK_Q
    q_tab = build_rank_tables(crp).query_tables(codes_q)
    live = torch.rand((N_ROWS,), generator=gen, device=wdb.device) >= 0.1
    lut_kernel_rows(rows, q_tab, wdb, packing.pack_bitmask(live),
                    int(live.sum()), bits)

    def row(name, fn_kernel, fn_plain, want, b, shape, lib=None,
            **extra):
        t0 = time.perf_counter()
        got = fn_kernel()
        if not same(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
            raise AssertionError(f"{name} differs from its plain version")
        del got, want
        ms = time_ms(fn_kernel)
        plain_ms = time_ms(fn_plain, reps=3, warmup=1)
        lib_ms = None if lib is None else time_ms(lib, reps=3, warmup=1)
        b_ms, b_by, pipe = b
        rows[name] = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, bound_pipe=pipe,
                          library_ms=lib_ms, shape=shape, **extra)
        lib_txt = "" if lib_ms is None else f" library_ms={lib_ms:.4f}"
        log(f"kernel {name}: {shape} bit-exact ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f}{lib_txt} bound_ms={b_ms:.4f} ({b_by}, "
            f"{pipe}); phase {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    cq = codes_q.to(torch.int32)
    cdb = packing.unpack_codes(wdb, bits, K)
    want = ref.collision_counts_ref(cq, cdb, block_elems=1 << 28)
    cqf, cdbf = cq.float(), cdb.float()   # the yardstick's inputs, made once
    lib_equal = bool(torch.equal(K - torch.cdist(cqf, cdbf, p=0),
                                 want.float()))
    if not lib_equal:
        raise AssertionError("k - cdist(p=0) differs from the counts")
    # one compare and one add a (query, row, position); codes read once,
    # counts written once
    row("collision_counts",
        lambda: ops.collision_counts(cq, cdb, impl="kernel"),
        lambda: ref.collision_counts_ref(cq, cdb, block_elems=1 << 28),
        want,
        bound([("int32", 2.0 * nq * N_ROWS * K, INT32_OP_S)],
              4.0 * (nq * K + N_ROWS * K + nq * N_ROWS)),
        [nq, N_ROWS, K], lib=lambda: K - torch.cdist(cqf, cdbf, p=0))
    del cdb, cdbf, want
    torch.cuda.empty_cache()


def repair_path(engine, queries, device) -> dict:
    """The two repairs at the main path's scale: 16 queries through the
    engine after ``add`` (4,259,840 rows) with top_k and rerank_m above
    2048, against the same engine on ``impl="ref"``; a bf16 sketch of
    65,536 rows (D = 1,024) against ``impl="ref"`` under the bin-edge
    rule, resident and streamed."""
    import torch
    from repro_torch.ann.engine import SearchConfig
    from repro_torch.core import packing, prng
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig
    from repro_torch.encode import StreamingEncoder
    rates = {}
    codes = engine.encode_queries(queries[:16])
    for tag, kw in (("count-ranked top_k 2049", dict(top_k=2049)),
                    ("scored fused top_k 513 (m 2052)",
                     dict(top_k=513, scored=True)),
                    ("two-stage m 2100", dict(top_k=TOP_K, rerank_m=2100,
                                              scored=True, fused=False)),
                    ("LSH scored m 2100", dict(top_k=TOP_K, rerank_m=2100,
                                               scored=True, mode="lsh"))):
        cfg = SearchConfig(chunk_q=16, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = engine.search_codes(codes, cfg)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        want = engine.search_codes(codes, SearchConfig(chunk_q=16,
                                                       impl="ref", **kw))
        if not same(got, want):
            raise AssertionError(f"{tag}: the card differs from impl='ref'")
        rates[tag] = ms
        log(f"repair, {tag}: 16 queries over {engine.n} rows bit-exact "
            f"against impl='ref' ({ms:.3f} ms on the card)")
    gen = torch.Generator(device=device).manual_seed(CORPUS_SEED + 16)
    crp = CodedRandomProjection(SketchConfig(k=K, scheme="2bit", w=0.75,
                                             seed=0, dtype="bfloat16"), D)
    r = crp.stream_encoder().r_matrix()
    if not torch.equal(r.cpu().view(torch.int16), prng.normal(
            prng.fold_in(prng.PRNGKey(0), 0), (D, K),
            dtype=torch.bfloat16).view(torch.int16)):
        raise AssertionError("bf16 R differs from the CPU's prng")
    x = unit_rows(CHUNK, D, gen, device)
    z = torch.matmul(x, r.float())
    want = packing.unpack_codes(crp.sketch(x, impl="ref"), 2, K)
    got = packing.unpack_codes(crp.sketch(x), 2, K)
    flips = check_codes(got, want, z, crp.spec, None, "bf16 sketch")
    streamed = StreamingEncoder(crp, r_cap_elems=D * K - 1)
    s_got = streamed.encode_packed(x)
    if not torch.equal(s_got, streamed.encode_packed(x, impl="ref")):
        raise AssertionError("streamed bf16 sketch differs from impl='ref'")
    rates["bf16_edge_flips"] = flips
    log(f"repair, bf16 sketch: {CHUNK} rows, R bit-exact to the CPU's prng; "
        f"resident codes differ from impl='ref' in {flips}/{CHUNK * K} "
        f"fields, each within {EDGE_TOL} of a bin edge; streamed (bf16 "
        f"accumulation) bit-exact")
    return rates


SERVE_SEED = 2017
SERVE_TICKETS = 8192
SERVE_SIZES = (1, 5, 8, 40, 64, 200, 256, 300)


def serve_phase(engine, queries, device, profile: bool = False) -> tuple:
    """The serving front end (``repro_torch.serve.AnnService``) at the
    main path's width, over the engine after ``add`` (4,259,840 rows) and
    a 17-segment mutable index. Returns (launch counts, rates, the
    mutable index).
    ``profile`` adds torch.profiler breakdowns of a 40-ticket and a
    300-ticket count-ranked flush on a cold cache."""
    import numpy as np
    import torch
    from repro_torch.ann import BandSpec
    from repro_torch.core import packing
    from repro_torch.index import CompactionPolicy, MutableAnnEngine
    from repro_torch.kernels import autotune, ops
    from repro_torch.learn import (LearnConfig, PackedLinearModel,
                                   feature_spec_for, fit_store)
    from repro_torch.obs import MetricsRegistry, Tracer, kernelstats
    from repro_torch.serve import AnnService, AnnServiceConfig
    crp, bits = engine.sketcher, engine.sketcher.spec.bits
    store = engine.store
    rates = {}
    rng = np.random.default_rng(SERVE_SEED)
    gen = torch.Generator(device=device).manual_seed(SERVE_SEED)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    cache_path = os.path.join(ROOT, "build", "autotune-serve.json")
    if os.path.exists(cache_path):
        os.remove(cache_path)
    prev_cache = autotune.set_cache(autotune.AutotuneCache(cache_path))
    prev_stats = kernelstats.set_kernel_stats(kernelstats.KernelStats())
    torch.cuda.synchronize()
    ops.reset_launch_counts()

    # 1. warm-up with the sweep, on a fresh cache
    svc = AnnService(engine, AnnServiceConfig(autotune_warmup=True))
    t0 = time.perf_counter()
    svc.warmup(D)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    if ops.launch_counts()["packed_lut_topk"] == 0:
        raise AssertionError("warmup(autotune_warmup=True) did not launch "
                             "packed_lut_topk")
    log(f"serve warmup: tune_search_ops and {len(svc.cfg.buckets)} buckets "
        f"in {t_warm:.3f} s; cache entries {len(autotune.default_cache())}")

    # 2. every swept op at the serving shapes; each candidate must give
    # the default's bits
    q_codes = engine.encode_queries(queries[:CHUNK_Q])
    q_words = ops.pack_codes(q_codes, bits)
    tables = engine.rank_tables.query_tables(q_codes)
    db = store.words
    n, w = db.shape
    fp = tables.shape[1]
    valid = packing.pack_bitmask(
        torch.rand((n,), generator=gen, device=device) >= 0.1)
    db_codes = packing.unpack_codes(db[:N_ROWS], bits, K)
    z = torch.randn((2048, K), generator=gen, device=device)
    runs = {
        "pack_codes": (dict(m=CHUNK_Q, k=K), torch.int32,
                       lambda c: ops.pack_codes(q_codes, bits, **c)),
        "code_pack": (dict(m=2048, k=K), torch.float32,
                      lambda c: ops.code_pack(z, crp.spec, crp._offsets,
                                              **c)),
        "collision_counts": (dict(q=CHUNK_Q, n=N_ROWS), torch.int32,
                             lambda c: ops.collision_counts(q_codes,
                                                            db_codes, **c)),
        "packed_collision_counts": (
            dict(q=CHUNK_Q, n=n, w=w), torch.int32,
            lambda c: ops.packed_collision_counts(q_words, db, bits, K,
                                                  **c)),
        "packed_topk": (dict(q=CHUNK_Q, n=n, w=w, top_k=TOP_K), torch.int32,
                        lambda c: ops.packed_topk(q_words, db, bits, K,
                                                  TOP_K, **c)),
        "packed_topk_masked": (
            dict(q=CHUNK_Q, n=n, w=w, top_k=TOP_K), torch.int32,
            lambda c: ops.packed_topk_masked(q_words, db, valid, bits, K,
                                             TOP_K, **c)),
        "packed_lut_topk": (
            dict(q=CHUNK_Q, n=n, w=w, t=fp, top_k=TOP_K), tables.dtype,
            lambda c: ops.packed_lut_topk(tables, db, bits, TOP_K, **c)),
        "packed_lut_topk_masked": (
            dict(q=CHUNK_Q, n=n, w=w, t=fp, top_k=TOP_K), tables.dtype,
            lambda c: ops.packed_lut_topk_masked(tables, db, valid, bits,
                                                 TOP_K, **c)),
        "fused_scored_topk": (
            dict(q=CHUNK_Q, n=n, w=w, t=fp, top_k=TOP_K), tables.dtype,
            lambda c: ops.fused_scored_topk(q_words, tables, db, bits, K,
                                            RERANK_M, TOP_K, **c)),
        "fused_scored_topk_masked": (
            dict(q=CHUNK_Q, n=n, w=w, t=fp, top_k=TOP_K), tables.dtype,
            lambda c: ops.fused_scored_topk_masked(
                q_words, tables, db, valid, bits, K, RERANK_M, TOP_K, **c)),
    }
    if set(runs) != set(autotune.SWEEPS):
        raise AssertionError("the serving sweep misses an op of SWEEPS")
    t_sweep = time.perf_counter()
    sweep = {}
    for op, (dims, dtype, run) in runs.items():
        serving_cache = autotune.set_cache(autotune.AutotuneCache())
        base = run({})                 # the kernel's defaults: empty cache
        base = base if isinstance(base, tuple) else (base,)
        default_ms = time_ms(lambda: run({}), reps=3, warmup=0)
        autotune.set_cache(serving_cache)
        times = {}

        def measure(run_, config, op=op, base=base, times=times):
            out = run_(config)
            if not same(out if isinstance(out, tuple) else (out,), base):
                raise AssertionError(f"{op} at {config} differs from its "
                                     f"default config")
            del out
            times[json.dumps(config, sort_keys=True)] = t = time_ms(
                lambda: run_(config), reps=3, warmup=0)
            return t

        best = autotune.tune(op, run, dtype, dims, measure=measure)
        del base
        sweep[op] = dict(winner=best, ms=min(times.values()),
                         default_ms=default_ms, candidates=len(times))
        log(f"serve sweep {op}: {len(times)} candidates bit-identical to the "
            f"default; winner {best} {sweep[op]['ms']:.4f} ms against the "
            f"default's {default_ms:.4f} ms")
    del db_codes
    torch.cuda.empty_cache()
    rates["sweep_s"] = time.perf_counter() - t_sweep
    rates["sweep"] = sweep
    saved = autotune.default_cache()
    path = saved.save()
    loaded = autotune.AutotuneCache(path)
    if loaded._configs != saved._configs:
        raise AssertionError("the autotune cache did not survive its JSON")
    autotune.set_cache(loaded)
    log(f"serve sweep: {rates['sweep_s']:.1f} s; cache of {len(loaded)} "
        f"entries saved to {os.path.relpath(path, ROOT)} and loaded back")

    # 3. traffic: tickets drawn from the 1,024 queries, flushed in batches
    # of every size; every result against a direct search
    def drive(svc, picks, want, flush_s):
        ids_w, rho_w = want
        pos, i = 0, 0
        while pos < len(picks):
            batch = picks[pos:pos + SERVE_SIZES[i % len(SERVE_SIZES)]]
            pos, i = pos + len(batch), i + 1
            tickets = [svc.submit(queries[j]) for j in batch]
            t0 = time.perf_counter()
            res = svc.flush()
            flush_s.append(time.perf_counter() - t0)
            got_i = np.stack([res[t][0] for t in tickets])
            got_r = np.stack([res[t][1] for t in tickets])
            if not (np.array_equal(got_i, ids_w[batch])
                    and np.array_equal(got_r.view(np.int32),
                                       rho_w[batch].view(np.int32))):
                raise AssertionError("a flushed result differs from the "
                                     "direct search")

    def direct(eng, kw):
        out = eng.search(queries, top_k=TOP_K, chunk_q=CHUNK_Q, **kw)
        return out[0].cpu().numpy(), out[1].cpu().numpy()

    def pct(xs, p):
        return float(np.percentile(np.asarray(xs), p))

    picks = rng.integers(0, N_QUERIES, SERVE_TICKETS)
    modes = {"count": {}, "scored_f32": dict(scored=True, table_dtype="f32"),
             "two_stage": dict(scored=True, fused=False)}
    for name, kw in modes.items():
        want = direct(engine, kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        direct(engine, kw)
        t_direct = time.perf_counter() - t0
        msvc = svc if name == "count" else AnnService(
            engine, AnnServiceConfig(**kw))
        flush_s = []
        t0 = time.perf_counter()
        drive(msvc, picks, want, flush_s)
        t_svc = time.perf_counter() - t0
        st = msvc.stats
        hit = st["cache_hits"] / st["queries"]
        waste = st["padded_rows"] / (st["padded_rows"] + st["cache_misses"])
        rates[f"serve_{name}"] = dict(
            queries_s=len(picks) / t_svc, direct_queries_s=N_QUERIES / t_direct,
            flush_p50_ms=1e3 * pct(flush_s, 50),
            flush_p99_ms=1e3 * pct(flush_s, 99),
            over_deadline=sum(s > 0.050 for s in flush_s) / len(flush_s),
            hit_rate=hit, padding_waste=waste, flushes=len(flush_s))
        log(f"serve {name}: {len(picks)} tickets in {len(flush_s)} flushes, "
            f"every result bit-exact against a direct search; "
            f"{len(picks) / t_svc:.1f} queries/s through the service against "
            f"{N_QUERIES / t_direct:.1f} direct; flush p50 "
            f"{1e3 * pct(flush_s, 50):.3f} ms p99 {1e3 * pct(flush_s, 99):.3f} "
            f"ms against deadline_s 0.050 ({100 * rates[f'serve_{name}']['over_deadline']:.1f} "
            f"% over); cache hit rate {hit:.4f}; padding waste {waste:.4f}")
    if profile:
        for size in (40, 300):
            psvc = AnnService(engine, AnnServiceConfig())

            def flush(psvc=psvc, size=size):
                for j in picks[:size]:
                    psvc.submit(queries[j])
                psvc.flush()
            profile_window(f"serve flush of {size} tickets, cold cache",
                           flush)

    # 4. the mutable service: bulk_load, then mutations between flushes
    mut = MutableAnnEngine(crp, band_spec=BandSpec(16, 4),
                           tail_rows=TAIL_ROWS)
    msvc = AnnService(mut, AnnServiceConfig())
    cgen = torch.Generator(device=device).manual_seed(CORPUS_SEED)
    t0 = time.perf_counter()
    for _ in range(N_ROWS // CHUNK):
        msvc.bulk_load(corpus_chunk(cgen, device)[0], chunk_rows=CHUNK)
    torch.cuda.synchronize()
    log(f"serve bulk_load: {N_ROWS} rows in {time.perf_counter() - t0:.3f} s")
    msvc.warmup(D)
    mpicks = rng.integers(0, N_QUERIES, 1024)
    flush_m = []
    steps = [
        ("delete", lambda: msvc.delete(rng.choice(N_ROWS, N_DELETE,
                                                  replace=False))),
        ("upsert", lambda: msvc.upsert(
            rng.choice(mut.store.live_ids(), N_UPSERT, replace=False),
            unit_rows(N_UPSERT, D, gen, device))),
        ("add", lambda: msvc.add(unit_rows(CHUNK, D, gen, device))),
        ("bulk_load", lambda: msvc.bulk_load(unit_rows(CHUNK, D, gen,
                                                       device))),
        ("compact", lambda: msvc.compact(CompactionPolicy(
            target_rows=1_048_576, max_dead_fraction=0.05))),
    ]
    segs = []
    for what, mutate in [("ingest", None)] + steps:
        if mutate is not None:
            t0 = time.perf_counter()
            mutate()
            torch.cuda.synchronize()
            log(f"serve {what}: {1e3 * (time.perf_counter() - t0):.3f} ms, "
                f"{mut.store.n_segments} segments, generation "
                f"{mut.generation}")
        segs.append(mut.store.n_segments)
        drive(msvc, mpicks, direct(mut, {}), flush_m)
    inval = msvc.stats["cache_invalidations"]
    if inval != len(steps) or segs[0] != N_ROWS // TAIL_ROWS + 1:
        raise AssertionError(f"mutable service: {inval} invalidations, "
                             f"segments {segs}")
    rates["serve_mutable"] = dict(
        flush_p50_ms=1e3 * pct(flush_m, 50),
        flush_p99_ms=1e3 * pct(flush_m, 99), invalidations=inval,
        segments=segs)
    log(f"serve mutable: {len(steps) + 1} rounds of 1,024 tickets, every "
        f"result bit-exact against a direct search at its generation (no "
        f"stale hit; {inval} cache invalidations); segments {segs}")
    del msvc          # the index stays for the health phase

    # 5. classify with a model trained by fit_store on the main store,
    # labels from a seeded teacher's margins
    fspec = feature_spec_for(crp)
    teacher = PackedLinearModel.zeros(fspec, device=device)
    teacher.tables.normal_(generator=gen)
    y = torch.where(teacher.margins(store.words)[0] >= 0, 1, -1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = fit_store(store, y, crp, LearnConfig(steps=50))
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    svc.set_classifier(model)
    svc.classify(queries[:8])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels, margins = svc.classify(queries)
    t_cls = time.perf_counter() - t0
    m_want = model.margins(ops.pack_codes(engine.encode_queries(queries),
                                          bits))
    if not (np.array_equal(margins.view(np.int32),
                           m_want.cpu().numpy().view(np.int32))
            and np.array_equal(labels, model.predict_from_margins(
                m_want).cpu().numpy())):
        raise AssertionError("classify differs from model.margins")
    acc = float((torch.from_numpy(labels).to(device) == torch.where(
        teacher.margins(ops.pack_codes(engine.encode_queries(queries),
                                       bits))[0] >= 0, 1, -1)).float().mean())
    rates["classify_rows_s"] = N_QUERIES / t_cls
    log(f"serve classify: fit_store 50 steps over {store.n} rows in "
        f"{t_fit:.3f} s; {N_QUERIES} rows in {1e3 * t_cls:.3f} ms = "
        f"{N_QUERIES / t_cls:.1f} rows/s, margins bit-exact against "
        f"model.margins; agreement with the teacher {acc:.4f}")

    # 6. kernel stats against the launch counters over the phase
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    stats = kernelstats.get_kernel_stats().snapshot()
    # kernelstats counts families; the tensor-core sweep runs inside four
    off = {f: (stats.get(f, {}).get("calls", 0), c) for f, c in counts.items()
           if f in kernelstats.MODELS
           and stats.get(f, {}).get("calls", 0) != c}
    if off:
        raise AssertionError(f"kernelstats calls != launches: {off}")
    require_launched(counts, "serve")
    log(f"serve kernelstats: calls equal launches for every family; launch "
        f"counts {json.dumps(counts)}")
    kernelstats.set_kernel_stats(prev_stats)

    # 7. a deep tracer syncs the flush spans; the dump loads as JSON
    with Tracer() as tr:
        for j in range(8):
            svc.submit(queries[j])
        svc.flush()
    flush_spans = [e for e in tr.events if e["name"] == "serve.flush"]
    if not flush_spans or any(e["args"]["sync"] != "device"
                              for e in flush_spans):
        raise AssertionError("a flush span under a deep tracer is not synced")
    trace_path = tr.dump(os.path.join(ROOT, "build", "trace-serve.json"))
    with open(trace_path) as f:
        n_ev = len(json.load(f)["traceEvents"])
    os.remove(trace_path)
    log(f"serve trace: {n_ev} spans under a deep tracer, flush synced; the "
        f"dump loads as JSON")

    # 8. the registry's cost: the same traffic, registry on and off
    qps = {"on": [], "off": []}
    for state in ("on", "off", "off", "on"):
        reg = MetricsRegistry(enabled=state == "on")
        osvc = AnnService(engine, AnnServiceConfig(), registry=reg)
        sub = picks[:2048]
        t0 = time.perf_counter()
        drive(osvc, sub, direct(engine, {}), [])
        qps[state].append(len(sub) / (time.perf_counter() - t0))
    rates["registry_on_queries_s"] = qps["on"]
    rates["registry_off_queries_s"] = qps["off"]
    log(f"serve registry: queries/s enabled {qps['on']} against disabled "
        f"{qps['off']} (order on, off, off, on)")
    autotune.set_cache(prev_cache)
    return counts, rates, mut


HEALTH_SEED = 2018
HEALTH_PAIRS = 65_536
HEALTH_RHOS = (0.3, 0.6, 0.9, 0.99)
HEALTH_TICKETS = 4096


def health_phase(engine, mut, queries, device) -> tuple:
    """The paper's estimator math and the quality monitors at the main
    path's width (README of ``chip_smoke.py``, phase 12): the MLE on the
    card, the collision audit through the served immutable engine, the
    shadow reservoir on the 17-segment mutable index, the post-fit
    margins, and the served rates with the monitors off, at 1 % and at
    100 %. Returns (launch counts, rates)."""
    import numpy as np
    import torch
    from repro_torch.core import packing
    from repro_torch.core.estimators import MleRhoEstimator, mle_rho_2bit
    from repro_torch.core.schemes import CodeSpec
    from repro_torch.kernels import ops
    from repro_torch.learn import LearnConfig, PackedLinearModel, \
        feature_spec_for, fit_store
    from repro_torch.obs import MetricsRegistry
    from repro_torch.obs.quality import (QualityConfig, QualityMonitors,
                                         synthetic_code_pairs)
    from repro_torch.serve import AnnService, AnnServiceConfig
    crp, bits = engine.sketcher, engine.sketcher.spec.bits
    rates = {}
    rng = np.random.default_rng(HEALTH_SEED)
    gen = torch.Generator(device=device).manual_seed(HEALTH_SEED)
    torch.cuda.synchronize()
    ops.reset_launch_counts()

    # 1. the MLE over the 4x4 table on the card against the CPU
    spec = CodeSpec("2bit", 0.75)
    est = MleRhoEstimator(spec)
    step = est.rho_max / (est.grid_size - 1)
    mle = {}
    for i, rho in enumerate(HEALTH_RHOS):
        a, b = synthetic_code_pairs(spec, K, rho, HEALTH_PAIRS,
                                    seed=HEALTH_SEED + i)
        ca, cb = torch.from_numpy(a), torch.from_numpy(b)
        ga, gb = ca.to(device), cb.to(device)
        cc = est.cell_counts(ga, gb)
        if not (cc.device.type == ga.device.type
                and torch.equal(cc.cpu(), est.cell_counts(ca, cb))):
            raise AssertionError(f"MLE cell counts on the card differ from "
                                 f"the CPU's at rho {rho}")
        got = est.estimate(ga, gb)
        want = est.estimate(ca, cb)
        diff = (got.cpu() - want).abs()
        if float(diff.max()) > step * 1.0001:
            raise AssertionError(f"MLE on the card more than a grid step from "
                                 f"the CPU's at rho {rho}")
        if not torch.equal(mle_rho_2bit(ga, gb, 0.75), got):
            raise AssertionError("mle_rho_2bit differs from estimate")
        ms = time_ms(lambda: est.estimate(ga, gb), reps=10)
        mle[str(rho)] = dict(differ=int((diff > 0).sum()),
                             mean=float(got.mean()), std=float(got.std()),
                             ms=ms, pairs_s=HEALTH_PAIRS / (ms / 1e3))
        log(f"health mle rho {rho}: cell counts on the card equal the CPU's; "
            f"{mle[str(rho)]['differ']} of {HEALTH_PAIRS} rho_hat differ from "
            f"the CPU's (by one grid step, {step:.6f}); rho_hat mean "
            f"{mle[str(rho)]['mean']:.6f} std {mle[str(rho)]['std']:.6f} "
            f"(k = {K}); estimate {ms:.4f} ms = "
            f"{mle[str(rho)]['pairs_s']:.0f} pairs/s ({card_line()})")
    rates["mle"] = mle

    picks = rng.integers(0, N_QUERIES, HEALTH_TICKETS)

    def drive(svc, picks):
        pos, i = 0, 0
        while pos < len(picks):
            batch = picks[pos:pos + SERVE_SIZES[i % len(SERVE_SIZES)]]
            pos, i = pos + len(batch), i + 1
            for j in batch:
                svc.submit(queries[j])
            svc.flush()

    # 2. the collision audit through the served immutable engine
    qm = QualityMonitors(crp, QualityConfig(sample_rate=1.0, seed=HEALTH_SEED),
                         registry=MetricsRegistry())
    svc = AnnService(engine, AnnServiceConfig(), quality=qm,
                     registry=qm.registry)
    seen = {"ids": [], "q": []}
    codes_for_ids = engine.codes_for_ids
    observe_pairs = qm.collision.observe_pairs

    def record_ids(ids):
        seen["ids"].append(np.asarray(ids).copy())
        return codes_for_ids(ids)

    def record_q(a, b):
        seen["q"].append(a[0].cpu().numpy())
        return observe_pairs(a, b)
    engine.codes_for_ids = record_ids
    qm.collision.observe_pairs = record_q
    try:
        drive(svc, picks)
    finally:
        del engine.codes_for_ids
        qm.collision.observe_pairs = observe_pairs
        engine.quality = None
    n = qm.collision.n_codes
    host = engine.store.words.cpu()
    recount = np.zeros(n * n, np.int64)
    for ids, q in zip(seen["ids"], seen["q"]):
        cand = packing.unpack_codes(host[torch.from_numpy(ids)], bits,
                                    K).numpy()
        recount += np.bincount((q[None, :] * n + cand).ravel(),
                               minlength=n * n)
    if not (seen["ids"] and np.array_equal(qm.collision.counts, recount)):
        raise AssertionError("the collision monitor's pooled counts differ "
                             "from a host recount of the sampled pairs")
    rep = qm.collision.report()
    cpu_rho = float(MleRhoEstimator(spec).from_counts(
        torch.from_numpy(qm.collision.counts)))
    if rep["rho_hat"] != cpu_rho:
        # a near-tie between two grid points: the float64 log-likelihoods
        # must agree within the float32 table's rounding
        ll = qm.collision.counts @ qm.collision._logp.T
        g = qm.collision._rho_grid
        i0 = int(np.argmin(np.abs(g - rep["rho_hat"])))
        i1 = int(np.argmin(np.abs(g - cpu_rho)))
        if abs(i0 - i1) > 1 or abs(ll[i0] - ll[i1]) > 1e-6 * abs(ll[i0]):
            raise AssertionError(f"report rho_hat {rep['rho_hat']} != the CPU "
                                 f"estimator's {cpu_rho}")
    rates["collision"] = {k: rep[k] for k in (
        "pairs", "rho_hat", "p_hat", "p_theory", "z_diag", "chi2_per_cell")}
    rates["collision"]["cpu_rho_hat"] = cpu_rho
    log(f"health collision audit: {len(picks)} tickets on {engine.n} rows, "
        f"{len(seen['ids'])} sampled searches, {rep['pairs']} pairs; pooled "
        f"counts equal a host recount; rho_hat {rep['rho_hat']:.6f} (CPU "
        f"estimator {cpu_rho:.6f}), p_hat {rep['p_hat']:.6f} against "
        f"{rep['p_theory']:.6f}, chi2/cell {rep['chi2_per_cell']:.3f}")

    # 3. the shadow reservoir on the 17-segment mutable index
    hsvc = AnnService(mut, AnnServiceConfig(),
                      quality=QualityConfig(sample_rate=1.0, seed=HEALTH_SEED))
    hq = hsvc.quality
    hsvc.add(unit_rows(CHUNK, D, gen, device))
    hsvc.upsert(rng.choice(mut.store.live_ids(), N_UPSERT, replace=False),
                unit_rows(N_UPSERT, D, gen, device))
    hsvc.bulk_load(unit_rows(CHUNK, D, gen, device), chunk_rows=CHUNK)
    held = len(hq.reservoir)
    kill = np.unique(np.r_[hq.reservoir.ids()[::2],
                           rng.choice(mut.store.live_ids(), N_DELETE // 4,
                                      replace=False)])
    hsvc.delete(kill, strict=False)
    if len(hq.reservoir) > held // 2 or \
            set(kill.tolist()) & set(hq.reservoir.ids().tolist()):
        raise AssertionError("a deleted id is left in the shadow reservoir")
    recalls = []
    observe_query = hq.recall.observe_query

    def recount_query(q_raw, encode_fn, estimator, q_codes=None):
        r = observe_query(q_raw, encode_fn, estimator, q_codes=q_codes)
        rows, codes = hq.reservoir.rows(), hq.recall._codes
        qv = q_raw.cpu().numpy()
        cos = rows @ (qv / np.linalg.norm(qv)) / np.linalg.norm(rows, axis=1)
        frac = (codes == q_codes.cpu().numpy()[None, :]).mean(axis=1)
        gt = np.argsort(-cos, kind="stable")[:hq.cfg.shadow_top_k]
        got = np.argsort(-frac, kind="stable")[:hq.cfg.shadow_top_k]
        if r != len(set(gt.tolist()) & set(got.tolist())) / len(gt):
            raise AssertionError("a sampled recall differs from its recount")
        recalls.append(r)
        return r
    hq.recall.observe_query = recount_query
    drive(hsvc, picks[:1024])
    hq.recall.observe_query = observe_query
    sh = hq.recall.report()
    if not recalls or len(recalls) != sh["queries"]:
        raise AssertionError("no shadow check ran on the mutable service")
    rates["shadow"] = {k: sh[k] for k in ("queries", "recall", "recall_lo",
                                          "recall_hi", "reservoir_rows",
                                          "rho_err_mean", "rho_err_std",
                                          "rho_std_theory")}
    log(f"health shadow: reservoir {held} rows after add/upsert/bulk_load, "
        f"{sh['reservoir_rows']} after deleting {len(kill)} ids (none left); "
        f"{sh['queries']} sampled recalls, each equal to a numpy recount; "
        f"recall@{hq.cfg.shadow_top_k} {sh['recall']:.4f} "
        f"[{sh['recall_lo']:.4f}, {sh['recall_hi']:.4f}]; rho error "
        f"{sh['rho_err_mean']:.4f} +- {sh['rho_err_std']:.4f} against the "
        f"predicted {sh['rho_std_theory']:.4f}; mutable collision pairs "
        f"{hq.collision.pairs}")
    del hsvc
    mut.quality = None

    # 4. the post-fit margins of fit_store
    fspec = feature_spec_for(crp)
    teacher = PackedLinearModel.zeros(fspec, device=device)
    teacher.tables.normal_(generator=gen)
    y = torch.where(teacher.margins(engine.store.words)[0] >= 0, 1, -1)
    mq = QualityMonitors(crp, QualityConfig(), registry=MetricsRegistry())
    cfg = LearnConfig(steps=20)
    model = fit_store(engine.store, y, crp, cfg, quality=mq)
    idx = np.sort(np.random.default_rng(cfg.seed).choice(
        engine.n, mq.cfg.margin_sample, replace=False))
    m = model.margins(engine.store.words[torch.from_numpy(idx).to(device)])
    m = m.cpu().numpy().astype(np.float64)[0]
    mo = mq.margins.moments
    if mo.n != len(m) or abs(mo.mean - m.mean()) > 1e-6 * abs(m.mean()) or \
            abs(mo.std - m.std(ddof=1)) > 1e-6 * m.std(ddof=1):
        raise AssertionError("fit_store's margin moments differ from numpy's")
    log(f"health margins: fit_store ({cfg.steps} steps over {engine.n} rows) "
        f"fed {mo.n} margins, mean {mo.mean:.6f} std {mo.std:.6f}, within "
        f"1e-6 of numpy's")

    torch.cuda.synchronize()
    counts = ops.launch_counts()
    require_launched(counts, "health")
    log(f"launch counts on the health path: {json.dumps(counts)}")

    # 5. served rates with the monitors off, at 1 % and at 100 %
    qps = {"off": [], "1%": [], "100%": []}
    for state in ("off", "1%", "100%", "100%", "1%", "off", "off", "1%",
                  "100%"):
        engine.quality = None
        quality = {"off": None, "1%": QualityConfig(),
                   "100%": QualityConfig(sample_rate=1.0)}[state]
        tsvc = AnnService(engine, AnnServiceConfig(), quality=quality)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drive(tsvc, picks)
        torch.cuda.synchronize()
        qps[state].append(len(picks) / (time.perf_counter() - t0))
    engine.quality = None
    rates["served_queries_s"] = qps
    log(f"health served count-ranked queries/s ({len(picks)} tickets a run, "
        f"order off, 1%, 100%, 100%, 1%, off, off, 1%, 100%): monitors off "
        f"{qps['off']}, QualityConfig() {qps['1%']}, sample_rate=1.0 "
        f"{qps['100%']} ({card_line()})")
    return counts, rates


SLO_SEED = 2019
SLO_PROBES = 64
SLO_ROUND = 1024          # mutable rounds: tickets between mutations
# neighbourhoods for the shadow check: 100 centres, 10 rows each at
# cosines 0.80..0.95 to their centre, queries at about 0.98 to one centre
SLO_CENTRES, SLO_MEMBERS, SLO_QUERY_NOISE = 100, 10, 0.2
SLO_COST_S = 5.0          # seconds a layer-cost run serves at least


def _nan_safe(report) -> str:
    """A report as sorted JSON (NaN written as NaN), for equality."""
    return json.dumps(report, sort_keys=True, default=str)


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def neighbourhoods(gen, device) -> tuple:
    """(rows [SLO_CENTRES * SLO_MEMBERS, D], centres [SLO_CENTRES, D]):
    each centre's rows at cosines 0.80 to 0.95 to it, so a query near a
    centre has those rows as its exact top 10 by a wide gap (a random
    unit row lies within about 0.1 of 0 at D 1,024). On rows of the
    corpus's kind, which lie near no query, a shadow check's exact top 10
    is noise and its recall chance."""
    import torch
    centres = unit_rows(SLO_CENTRES, D, gen, device)
    a = torch.linspace(0.80, 0.95, SLO_MEMBERS, device=device)
    a = a.repeat(SLO_CENTRES)[:, None]
    u = unit_rows(SLO_CENTRES * SLO_MEMBERS, D, gen, device)
    rows = a * centres.repeat_interleave(SLO_MEMBERS, 0) + \
        (1 - a * a).sqrt() * u
    return rows / rows.norm(dim=1, keepdim=True), centres


def slo_phase(engine, queries, device) -> tuple:
    """The rest of the health layer at the main path's width (phase 13):
    ``AnnService(quality=QualityConfig(), slo=True, resources=True,
    incidents=<dir>)`` over the engine after ``add`` (with 1,000
    neighbourhood rows added) and over a fresh 17-segment mutable index
    of the same corpus, warmed up; served traffic, canaries, the
    probe-exclusion invariant, resource accounting, the corrupted-ranking
    drill on a fake clock, the dashboard, and the layer's cost. The
    incident and dashboard directory is deleted after. Returns (launch
    counts under the canaries, rates)."""
    import shutil
    import tempfile
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="health-", dir=os.path.join(ROOT, "build"))
    try:
        return _slo_phase(engine, queries, device, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _slo_phase(engine, queries, device, tmp) -> tuple:
    import gc
    import numpy as np
    import torch
    from repro_torch.ann import BandSpec
    from repro_torch.index import MutableAnnEngine
    from repro_torch.kernels import ops
    from repro_torch.obs import (CanaryProber, DEFAULT_POLICIES,
                                 MetricsRegistry, ProbeConfig, SloEngine,
                                 gather, jit_compiles, render_html,
                                 write_dashboard)
    from repro_torch.obs import kernelstats
    from repro_torch.obs.quality import QualityConfig
    from repro_torch.serve import AnnService, AnnServiceConfig
    rates = {}
    rng = np.random.default_rng(SLO_SEED)
    gen = torch.Generator(device=device).manual_seed(SLO_SEED)
    card = card_line()
    picks = rng.integers(0, N_QUERIES, HEALTH_TICKETS)
    min_events = max(p.min_events for p in DEFAULT_POLICIES)

    def drive(svc, picks):
        pos, i = 0, 0
        while pos < len(picks):
            batch = picks[pos:pos + SERVE_SIZES[i % len(SERVE_SIZES)]]
            pos, i = pos + len(batch), i + 1
            for j in batch:
                svc.submit(queries[j])
            svc.flush()

    def near_traffic(svc):
        # one ticket a flush (light load: the shadow check samples 1 %
        # of flushes), each query near one centre, no two alike
        near = centres[rng.integers(0, SLO_CENTRES, HEALTH_TICKETS)] + \
            SLO_QUERY_NOISE * unit_rows(HEALTH_TICKETS, D, gen, device)
        for q in near / near.norm(dim=1, keepdim=True):
            svc.submit(q)
            svc.flush()

    def knobs(name):
        return dict(quality=QualityConfig(), slo=True, resources=True,
                    incidents=os.path.join(tmp, name))

    # 1. the two services, warmed up: the engine with the neighbourhood
    # rows added (ids from engine.n on) and offered to its reservoir; a
    # fresh 17-segment index of the main corpus, ingested before its
    # service exists, the neighbourhood rows added through the service
    nb_rows, centres = neighbourhoods(gen, device)
    engine.quality = None
    eng = engine.add(nb_rows)
    nb_ids = np.arange(engine.n, eng.n)
    mut = MutableAnnEngine(engine.sketcher, band_spec=BandSpec(16, 4),
                           tail_rows=TAIL_ROWS)
    cgen = torch.Generator(device=device).manual_seed(CORPUS_SEED)
    for _ in range(N_ROWS // CHUNK):
        mut.ingest(corpus_chunk(cgen, device)[0], chunk_rows=CHUNK)
    svc = AnnService(eng, AnnServiceConfig(), **knobs("engine"))
    msvc = AnnService(mut, AnnServiceConfig(), **knobs("mutable"))
    svc.quality.offer_rows(nb_ids, nb_rows)
    msvc.add(nb_rows)
    if len(svc.quality.reservoir) != len(nb_ids) or \
            len(msvc.quality.reservoir) != len(nb_ids):
        raise AssertionError("slo: the reservoirs do not hold the "
                             "neighbourhood rows")
    segs = mut.store.n_segments
    if segs != N_ROWS // TAIL_ROWS + 1:
        raise AssertionError(f"slo: the index has {segs} segments")
    t0 = time.perf_counter()
    svc.warmup(D)
    msvc.warmup(D)
    torch.cuda.synchronize()
    log(f"slo warmup: both services in {time.perf_counter() - t0:.3f} s; "
        f"the index {segs} segments; the compile mark at {jit_compiles()} "
        f"nvcc calls of this process (every source was built in an earlier "
        f"phase, so no later call can compile: compiles since the mark can "
        f"only move where a kernel's first use comes after warmup)")

    # 2. healthy traffic: 4,096 neighbourhood tickets on each service, one
    # a flush; then on the index rounds of 1,024 phase queries with
    # delete, upsert, add and bulk_load before each
    near_traffic(svc)
    near_traffic(msvc)
    steps = [
        lambda: msvc.delete(np.unique(np.r_[
            msvc.quality.reservoir.ids()[::4],
            rng.choice(mut.store.live_ids(), N_UPSERT, replace=False)]),
            strict=False),
        lambda: msvc.upsert(
            rng.choice(mut.store.live_ids(), N_UPSERT, replace=False),
            unit_rows(N_UPSERT, D, gen, device)),
        lambda: msvc.add(unit_rows(CHUNK, D, gen, device)),
        lambda: msvc.bulk_load(unit_rows(CHUNK, D, gen, device),
                               chunk_rows=CHUNK),
    ]
    for mutate in steps:
        mutate()
        drive(msvc, rng.integers(0, N_QUERIES, SLO_ROUND))
    torch.cuda.synchronize()
    healthy = {}
    for name, s in (("engine", svc), ("mutable", msvc)):
        s.slo.tick(force=True)
        h = s.slo.health()
        served = s.registry.counters["serve.queries"].value
        n_q, bad_q = s.slo.ledgers["search.quality"].totals()
        rec = s.quality.report()["shadow"]
        if h["status"] != "ok" or h["alerts"]:
            raise AssertionError(f"slo: healthy traffic on the {name} raised "
                                 f"{h['alerts']} ({h['status']})")
        if n_q < min_events:
            raise AssertionError(f"slo: {n_q} quality events on the {name}, "
                                 f"fewer than a policy's {min_events}: the "
                                 f"quality budget could not have alerted")
        if s.resources.compiles_since_mark != 0:
            raise AssertionError(f"slo: {s.resources.compiles_since_mark} "
                                 f"compiles after warm-up on the {name}")
        if served < HEALTH_TICKETS:
            raise AssertionError(f"slo: {served} tickets on the {name}")
        fl = s.registry.histograms["serve.flush_s"]
        healthy[name] = dict(tickets=served, flushes=fl.count,
                             quality_events=n_q, quality_bad=bad_q,
                             shadow_recall=rec["recall"])
        at = (f" over {mut.store.n_segments} segments (17 before the "
              f"mutations)" if name == "mutable" else "")
        log(f"slo healthy {name}{at}: {served} tickets in {fl.count} "
            f"flushes, status ok, no alert; search.quality {n_q} events "
            f"({bad_q} bad, the policies need {min_events}), shadow "
            f"recall@10 {rec['recall']:.4f} over {rec['queries']} checks; "
            f"compiles since mark 0; flush p99 "
            f"{1e3 * fl.percentile(0.99):.3f} ms (bucket bound) against "
            f"deadline_s {s.cfg.deadline_s}; budgets "
            + ", ".join(f"{k} {v['events']} events burn {v['burn_fast']:.3f}"
                        for k, v in sorted(h["slos"].items())))
    rates["healthy"] = healthy
    left = set(msvc.quality.reservoir.ids().tolist()) - \
        set(mut.store.live_ids().tolist())
    if left:
        raise AssertionError(f"slo: {len(left)} dead ids in the reservoir")

    # 3. canaries through probe_search: all found, user series untouched,
    # the count-ranked kernels launched under them
    probe_counts = {}
    canary = {}
    for name, s in (("engine", svc), ("mutable", msvc)):
        reg = s.registry
        before = (reg.histograms["serve.flush_s"].count,
                  reg.counters["serve.queries"].value,
                  _nan_safe(dict(s.sampler.retained)),
                  _nan_safe(s.quality.report()))
        prober = CanaryProber(s, slo=s.slo, cfg=ProbeConfig(
            n_probes=SLO_PROBES, seed=SLO_SEED, classify=False))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rep = prober.run_once()
        t_run = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        for k, v in counts.items():
            probe_counts[k] = probe_counts.get(k, 0) + v
        after = (reg.histograms["serve.flush_s"].count,
                 reg.counters["serve.queries"].value,
                 _nan_safe(dict(s.sampler.retained)),
                 _nan_safe(s.quality.report()))
        if "skipped" in rep or not rep["ok"] or rep["recall"] != 1.0 or \
                rep["probes"] != SLO_PROBES:
            summary = {k: v for k, v in rep.items() if k != "detail"}
            raise AssertionError(f"slo canaries on the {name}: {summary}")
        if after != before:
            raise AssertionError(f"slo canaries on the {name} moved a "
                                 f"user-facing series: {before} -> {after}")
        if reg.counters["serve.probe.queries"].value != SLO_PROBES:
            raise AssertionError("slo: the probe twins missed canaries")
        need = ("coded_project", "pack_codes", "packed_topk_tc",
                "packed_topk" if name == "engine" else "packed_topk_masked")
        missing = [k for k in need if counts[k] == 0]
        if missing:
            raise AssertionError(f"slo canaries on the {name} launched no "
                                 f"{missing}")
        lat = [p["latency_s"] for p in rep["detail"]]
        canary[name] = dict(
            ms_mean=1e3 * t_run / rep["probes"],
            ms_median=1e3 * statistics.median(lat),
            ms_max=1e3 * rep["max_latency_s"],
            margin_mean=rep["margin_mean"], deadline_s=s.cfg.deadline_s,
            segments=mut.store.n_segments if name == "mutable" else 1)
        at = (f" ({mut.store.n_segments} segments)" if name == "mutable"
              else "")
        log(f"slo canaries {name}{at}: {rep['probes']} through probe_search, "
            f"recall 1.0, all ok; {canary[name]['ms_mean']:.3f} ms a canary "
            f"(median {canary[name]['ms_median']:.3f}, max "
            f"{canary[name]['ms_max']:.3f}) against deadline_s "
            f"{s.cfg.deadline_s}; margin mean {rep['margin_mean']:.4f}; "
            f"serve.flush_s, serve.queries, the sampler and the quality "
            f"report untouched; launches {json.dumps(counts)} ({card})")
    rates["canary"] = canary
    require_launched(probe_counts, "slo")

    # 4. resource accounting
    res = svc.resources.collect()
    used = torch.cuda.memory_allocated(0)
    if res["tracked"]["engine.store"] != eng.store.nbytes:
        raise AssertionError("slo: tracked engine.store != store.nbytes")
    if res["device"]["cuda0.bytes_in_use"] != used or \
            used < eng.store.nbytes:
        raise AssertionError(f"slo: cuda0.bytes_in_use "
                             f"{res['device']['cuda0.bytes_in_use']} against "
                             f"memory_allocated {used}")
    mres = msvc.resources.collect()
    if mres["tracked"]["engine.store"] != mut.store.nbytes:
        raise AssertionError("slo: tracked index store != store.nbytes")
    log(f"slo resources: engine.store {res['tracked']['engine.store']:.0f} "
        f"bytes (= store.nbytes), index store "
        f"{mres['tracked']['engine.store']:.0f}; cuda0 bytes in use {used} "
        f"(= torch.cuda.memory_allocated(0)), peak "
        f"{res['device']['cuda0.peak_bytes']}; host RSS "
        f"{res['host']['rss_bytes']:.0f} bytes")

    # 5. the corrupted-ranking drill on a fake clock (cache off, so no
    # cached pre-fault answer masks it), canaries from the engine's
    # reservoir
    clock = {"t": 0.0}
    dreg = MetricsRegistry()
    dslo = SloEngine(registry=dreg, clock=lambda: clock["t"],
                     resolution=1.0)
    dsvc = AnnService(eng, AnnServiceConfig(cache_size=0), registry=dreg,
                      slo=dslo, resources=True,
                      incidents=os.path.join(tmp, "drill"))
    dprober = CanaryProber(dsvc, slo=dslo, reservoir=svc.quality.reservoir,
                           cfg=ProbeConfig(n_probes=4, seed=SLO_SEED,
                                           classify=False))
    for _ in range(8):
        rep = dprober.run_once()
        if not rep["ok"] or rep["recall"] != 1.0:
            raise AssertionError("slo drill: a healthy canary failed")
        clock["t"] += 1.0
    if dslo.health()["status"] != "ok" or dsvc.incidents.captured:
        raise AssertionError("slo drill: unhealthy before the fault")
    wrong = N_ROWS * 2            # no such row
    eng.search_codes = lambda q, cfg: (
        torch.full((q.shape[0], TOP_K), wrong, dtype=torch.int32,
                   device=q.device),
        torch.zeros((q.shape[0], TOP_K), device=q.device))
    t_fault = clock["t"]
    try:
        for _ in range(60):
            rep = dprober.run_once()
            if rep["ok"] or rep["recall"] != 0.0:
                raise AssertionError("slo drill: a corrupted canary passed")
            clock["t"] += 1.0
            if dslo.health()["status"] == "degraded":
                break
    finally:
        del eng.search_codes
    h = dslo.health()
    if "slo.search.quality" not in h["alerts"] or \
            clock["t"] - t_fault > 60.0:
        raise AssertionError(f"slo drill: no quality alert within the fast "
                             f"window ({h['alerts']})")
    bundle = dsvc.incidents.load()
    if bundle["kind"] != "drift" or \
            bundle["context"]["series"] != "slo.search.quality" or \
            bundle["slo"]["status"] != "degraded" or \
            "slo.search.quality" not in bundle["slo"]["alerts"]:
        raise AssertionError("slo drill: the incident bundle lacks the alert")
    if not dprober.run_once()["ok"]:
        raise AssertionError("slo drill: the engine was not restored")
    log(f"slo drill: corrupted ranking tripped slo.search.quality after "
        f"{clock['t'] - t_fault:.0f} fake seconds (fast window 60 s), "
        f"health degraded, shed {h['shed_fraction']:.3f}; incident "
        f"{bundle['incident']} loaded back: kind drift, series "
        f"slo.search.quality, SLO status degraded; engine restored")

    # 6. the dashboard; the costs of the slow-path calls (host clock)
    def host_ms(fn, reps=20):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(ts)

    kw = dict(registry=svc.registry, slo=svc.slo, flight=svc.flight,
              quality=svc.quality, resources=svc.resources)
    snap = gather(**kw)
    hw = kernelstats.HW()
    roof = snap.get("roofline", {})
    if not roof or any(r["t_model_s"] != max(r["flops"] / hw.peak_flops,
                                             r["hbm_bytes"] / hw.hbm_bw)
                       for r in roof.values()):
        raise AssertionError("slo dashboard: roofline not the H100 model's")
    page_path = write_dashboard(os.path.join(tmp, "dash", "index.html"),
                                snap)
    with open(page_path, encoding="utf-8") as f:
        page = f.read()
    if page != render_html(snap) or "<script" in page or \
            "roofline (modeled)" not in page:
        raise AssertionError("slo dashboard: the written page is wrong")
    costs = dict(
        tick_ms=host_ms(lambda: svc.slo.tick(force=True)),
        collect_ms=host_ms(svc.resources.collect),
        gather_ms=host_ms(lambda: gather(**kw)),
        render_html_ms=host_ms(lambda: render_html(snap)),
        page_bytes=len(page.encode("utf-8")))
    cap = []

    def capture():
        cap.append(svc.incidents.capture("timing", "capture cost"))
    costs["capture_ms"] = host_ms(capture, reps=5)
    if not all(cap):
        raise AssertionError("slo: an incident capture failed")
    costs["bundle_bytes"] = _dir_bytes(cap[-1])
    rates["costs"] = costs
    log(f"slo costs (host clock, median of 20; capture of 5): tick(force) "
        f"{costs['tick_ms']:.4f} ms, resources.collect() "
        f"{costs['collect_ms']:.4f} ms, gather {costs['gather_ms']:.4f} ms, "
        f"render_html {costs['render_html_ms']:.4f} ms for a page of "
        f"{costs['page_bytes']} bytes ({len(roof)} roofline rows, H100 "
        f"model); incident capture {costs['capture_ms']:.3f} ms for a "
        f"bundle of {costs['bundle_bytes']} bytes ({card})")

    # 7. the layer's cost: served count-ranked queries/s, slo, resources
    # and incidents off against on, both at the default 1 % sampling; each
    # run serves the phase's tickets over and over for SLO_COST_S, so that
    # several ticks fall inside, after a full collection (so the garbage of
    # the run before is not collected inside this one)
    qps = {"off": [], "on": []}
    runs = []
    for i, state in enumerate(("off", "on", "on", "off",
                               "off", "on", "on", "off")):
        eng.quality = None
        extra = {} if state == "off" else dict(
            slo=True, resources=True,
            incidents=os.path.join(tmp, f"qps{i}"))
        tsvc = AnnService(eng, AnnServiceConfig(),
                          quality=QualityConfig(), **extra).warmup(D)
        gc.collect()
        torch.cuda.synchronize()
        gcs = sum(g["collections"] for g in gc.get_stats())
        served, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < SLO_COST_S:
            drive(tsvc, picks)
            served += len(picks)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        fl = tsvc.registry.histograms["serve.flush_s"]
        qps[state].append(served / t)
        runs.append(dict(
            state=state, queries_s=served / t, tickets=served, s=t,
            flush_p99_ms=1e3 * fl.percentile(0.99),
            flush_max_ms=1e3 * fl.vmax,
            gc_collections=sum(g["collections"] for g in gc.get_stats())
            - gcs,
            ticks=(len(tsvc.slo.ledgers["search.latency"].ring)
                   if tsvc.slo is not None else 0)))
        del tsvc
    rates["served_queries_s"] = qps
    rates["cost_runs"] = runs
    for r in runs:
        log(f"slo cost run {r['state']}: {r['tickets']} tickets in "
            f"{r['s']:.3f} s = {r['queries_s']:.1f} queries/s; flush p99 "
            f"{r['flush_p99_ms']:.3f} ms (bucket bound), max "
            f"{r['flush_max_ms']:.3f} ms; {r['ticks']} SLO ticks (with "
            f"warm-up's) and "
            f"{r['gc_collections']} garbage collections inside")
    log(f"slo served count-ranked queries/s (at least {SLO_COST_S} s a run, "
        f"QualityConfig() in both, order off, on, on, off, off, on, on, "
        f"off): off {qps['off']} median {statistics.median(qps['off']):.1f}"
        f", slo+resources+incidents on {qps['on']} median "
        f"{statistics.median(qps['on']):.1f} ({card})")
    return probe_counts, rates


# phase 14: sharded search and encode at world size 1 over NCCL
SHARD_ENCODE_ROWS = 262_144          # 1 GiB of float32 rows at D = 1024
SHARD_MODES = {
    "count": dict(),
    "two_stage": dict(scored=True, fused=False, rerank_m=RERANK_M),
    "fused_f32": dict(scored=True, table_dtype="f32", rerank_m=RERANK_M),
    "fused_int8": dict(scored=True, table_dtype="int8", rerank_m=RERANK_M),
}
# phase 15: the gradient of qwen2-0.5B as float32 leaves, by shape: the 14
# leaves of repro.models.lm.model_param_specs(config()) for
# src/repro/configs/qwen2_0_5b.py (24 layers stacked, d_model 896, 14
# heads and 2 KV heads of 64, d_ff 4864, vocab 151,936, QKV bias, tied
# embeddings): 494,032,768 floats
QWEN2_05B_GRAD = {
    "blocks": {"p0": {
        "attn": {"bk": (24, 2, 64), "bq": (24, 14, 64), "bv": (24, 2, 64),
                 "wk": (24, 896, 2, 64), "wo": (24, 14, 64, 896),
                 "wq": (24, 896, 14, 64), "wv": (24, 896, 2, 64)},
        "ffn": {"w_down": (24, 4864, 896), "w_gate": (24, 896, 4864),
                "w_up": (24, 896, 4864)},
        "ln1": (24, 896), "ln2": (24, 896)}},
    "embed": (151936, 896), "ln_f": (896,)}
GC_RATE, GC_CHUNK = 8, 1024
GC_WIRE_BYTES, GC_FP32_BYTES = 17_368_344, 1_976_131_072
SHARD_LEARN_STEPS, SHARD_SEED = 50, 2020


class nccl_mesh:
    """A world-size-1 NCCL group on a ``FileStore`` under ``build/`` and
    its ``("data",)`` mesh on the card; the group is destroyed on exit."""

    def __enter__(self):
        import torch
        import torch.distributed as dist
        from repro_torch.launch import make_dp_mesh
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        self.path = os.path.join(ROOT, "build", f"nccl-store-{os.getpid()}")
        if os.path.exists(self.path):
            os.remove(self.path)
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", store=dist.FileStore(self.path, 1),
                                rank=0, world_size=1)
        return make_dp_mesh()

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()
        if os.path.exists(self.path):
            os.remove(self.path)
        return False


def timed_call(fn):
    """(result, seconds) of ``fn()`` between two synchronisations."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def sharded_phase(engine, queries, device) -> tuple:
    """Phase 14: ``search_sharded`` in four modes and ``encode_sharded``
    over a one-card NCCL mesh, launch counts over the sharded calls, then
    the gates against the unsharded calls and the timings. Returns
    (counts, rates)."""
    import torch
    from repro_torch.encode import encode_sharded
    from repro_torch.kernels import ops
    card = card_line()
    crp = engine.sketcher
    enc = crp.stream_encoder()
    gen = torch.Generator(device=device).manual_seed(CORPUS_SEED)
    x = torch.cat([corpus_chunk(gen, device)[0]
                   for _ in range(SHARD_ENCODE_ROWS // CHUNK)])
    nq = queries.shape[0]
    rates, got = {}, {}
    with nccl_mesh() as mesh:
        def sharded(kw):
            return engine.search_sharded(queries, mesh, top_k=TOP_K, **kw)

        def unsharded(kw):
            return engine.search(queries, top_k=TOP_K, mode="exact",
                                 chunk_q=CHUNK_Q, **kw)

        # the path: every sharded call, counted from zero
        ops.reset_launch_counts()
        for name, kw in SHARD_MODES.items():
            engine.search_sharded(queries[:CHUNK_Q], mesh, top_k=TOP_K, **kw)
            got[name] = sharded(kw)
        words_sh = encode_sharded(enc, x, mesh)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        log(f"launch counts on the sharded path: {json.dumps(counts)}")
        require_launched(counts, "sharded")
        # the gates, then sharded and unsharded calls in turns (S U U S,
        # twice), each between two synchronisations
        for name, kw in SHARD_MODES.items():
            want = unsharded(kw)
            ids, rho = got[name]
            if not (torch.equal(ids, want[0]) and torch.equal(rho, want[1])):
                raise AssertionError(f"search_sharded {name} differs from "
                                     f"search(mode='exact') at world size 1")
            times = {"s": [], "u": []}
            for who in "suussuus":
                out, t = timed_call(lambda: (sharded if who == "s"
                                             else unsharded)(kw))
                if not torch.equal(out[0], ids):
                    raise AssertionError(f"search {name} not repeatable")
                times[who].append(t)
            rates[name] = dict(
                sharded_queries_s=[nq / t for t in times["s"]],
                unsharded_queries_s=[nq / t for t in times["u"]])
            med = {w: nq / statistics.median(t) for w, t in times.items()}
            log(f"sharded search {name}: {nq} queries over {engine.n} rows, "
                f"ids and rho bit-identical to search(mode='exact'); "
                f"queries/s (order S U U S S U U S) sharded "
                f"{[round(v, 1) for v in rates[name]['sharded_queries_s']]} "
                f"median {med['s']:.1f}, unsharded "
                f"{[round(v, 1) for v in rates[name]['unsharded_queries_s']]}"
                f" median {med['u']:.1f} ({card})")
        times = {"s": [], "p": []}
        for who in "sppssp":
            _, t = timed_call(lambda: encode_sharded(enc, x, mesh)
                              if who == "s" else enc.encode_packed(x))
            times[who].append(t)
    words = enc.encode_packed(x)
    z = crp.project(x)
    n_edge = check_codes(ref_unpack(words_sh, crp), ref_unpack(words, crp),
                         z, crp.spec, crp._offsets,
                         "encode_sharded vs encode_packed")
    if not torch.equal(words_sh, ops.code_pack(z, crp.spec, crp._offsets)):
        raise AssertionError("encode_sharded differs from project + "
                             "code_pack of the same rows")
    rs = {w: [SHARD_ENCODE_ROWS / t for t in ts] for w, ts in times.items()}
    rates["encode"] = dict(sharded_rows_s=rs["s"], packed_rows_s=rs["p"],
                           edge_fields=n_edge)
    log(f"encode_sharded: {SHARD_ENCODE_ROWS} rows of the main corpus "
        f"({4 * SHARD_ENCODE_ROWS * D} bytes of float32), rows/s (order S P "
        f"P S S P): encode_sharded {[round(v, 1) for v in rs['s']]} "
        f"(project through torch.matmul, float32, then code_pack), "
        f"encode_packed {[round(v, 1) for v in rs['p']]} (the 3xTF32 "
        f"kernel); words equal but at {n_edge} fields within {EDGE_TOL} of "
        f"a bin edge, and equal to project + code_pack ({card})")
    del x, z, words, words_sh
    torch.cuda.empty_cache()
    return counts, rates


def ref_unpack(words, crp):
    from repro_torch.core import packing
    return packing.unpack_codes(words, crp.spec.bits, crp.cfg.k)


def qwen_leaves(tree, fn):
    """QWEN2_05B_GRAD's structure with ``fn(shape)`` at each leaf."""
    if isinstance(tree, dict):
        return {k: qwen_leaves(v, fn) for k, v in tree.items()}
    return fn(tree)


def sharded_learn_phase(store, y_tr, held_words, crp, device) -> tuple:
    """Phase 15: ``packed_grads_sharded`` and ``fit_words(mesh=)`` on the
    learn path's store, counted, against the unsharded calls; then the
    gradient compressor at qwen2-0.5B's gradient size. Returns (counts,
    rates)."""
    import torch
    from repro_torch.core.gradient_compression import (
        GradCompressionConfig, GradCompressor)
    from repro_torch.kernels import ops
    from repro_torch.learn import (LearnConfig, feature_spec_for, fit_words,
                                   packed_grads_sharded)
    from repro_torch.learn.linear import packed_loss_and_grads, targets_pm
    card = card_line()
    fspec = feature_spec_for(crp, K)
    gen = torch.Generator(device=device).manual_seed(SHARD_SEED)
    params = (torch.randn((1, fspec.table_width), generator=gen,
                          device=device) * fspec.entry_mask(device),
              torch.randn(1, generator=gen, device=device))
    y_pm = targets_pm(y_tr, 1, device)
    words = store.words
    full = LearnConfig(steps=SHARD_LEARN_STEPS)
    mb = LearnConfig(steps=SHARD_LEARN_STEPS, batch=LEARN_BATCH)
    rates = {}
    with nccl_mesh() as mesh:
        def fit(cfg, on_mesh):
            return fit_words(words, y_tr, fspec, cfg,
                             mesh=mesh if on_mesh else None)

        ops.reset_launch_counts()
        sh = packed_grads_sharded(params, words, y_pm, fspec, mesh)
        fits = {name: fit(cfg, True) for name, cfg in (("full_batch", full),
                                                       ("minibatch", mb))}
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        log(f"launch counts on the sharded learn path: "
            f"{json.dumps(counts)}")
        require_launched(counts, "sharded_learn")

        un = packed_loss_and_grads(params, words, y_pm, fspec)
        for a, b, what in ((sh[0], un[0], "loss"), (sh[1][0], un[1][0], "dt"),
                           (sh[1][1], un[1][1], "db")):
            err = (a - b).abs()
            if bool((err > 1e-6 + 1e-5 * b.abs()).any()):
                raise AssertionError(f"packed_grads_sharded {what} beyond "
                                     f"rtol 1e-5, atol 1e-6: max "
                                     f"{float(err.max()):.3e}")
        times = {"s": [], "u": []}
        for who in "suussuus":
            times[who].append(timed_call(
                lambda: packed_grads_sharded(params, words, y_pm, fspec, mesh)
                if who == "s" else
                packed_loss_and_grads(params, words, y_pm, fspec))[1])
        ms = {w: [1e3 * t for t in ts] for w, ts in times.items()}
        rates["grads_ms"] = dict(sharded=ms["s"], unsharded=ms["u"])
        log(f"packed_grads_sharded over {words.shape[0]} rows: loss "
            f"{float(sh[0]):.6f} against {float(un[0]):.6f}, dTables max "
            f"diff {float((sh[1][0] - un[1][0]).abs().max()):.3e} (within "
            f"rtol 1e-5, atol 1e-6); ms a call (host clock, synced, order S "
            f"U U S S U U S) {[round(v, 4) for v in ms['s']]} against "
            f"packed_loss_and_grads {[round(v, 4) for v in ms['u']]} "
            f"({card})")
        for name, cfg in (("full_batch", full), ("minibatch", mb)):
            m_sh, m_un = fits[name], fit(cfg, False)
            diff = (m_sh.tables - m_un.tables).abs()
            agree = bool(torch.equal(m_sh.predict(held_words),
                                     m_un.predict(held_words)))
            if bool((diff > 1e-5 + 1e-4 * m_un.tables.abs()).any()) or \
                    not agree:
                raise AssertionError(f"fit_words(mesh=) {name} departs from "
                                     f"the unsharded fit")
            rows = words.shape[0] if cfg.batch == 0 else cfg.batch
            times = {"s": [], "u": []}
            for who in "suus":
                times[who].append(timed_call(lambda: fit(cfg, who == "s"))[1])
            rs = {w: [rows * cfg.steps / t for t in ts]
                  for w, ts in times.items()}
            rates[f"fit_{name}"] = dict(sharded_row_steps_s=rs["s"],
                                        unsharded_row_steps_s=rs["u"])
            log(f"fit_words(mesh=) {name}: {cfg.steps} steps, tables within "
                f"{float(diff.max()):.3e} of the unsharded fit (rtol 1e-4, "
                f"atol 1e-5), held-out predictions equal; row-steps/s (order "
                f"S U U S) sharded {[round(v, 1) for v in rs['s']]}, "
                f"unsharded {[round(v, 1) for v in rs['u']]} ({card})")
        del fits

        # the compressor: 2-bit codes at rate 8 in chunks of 1,024
        tpl = qwen_leaves(QWEN2_05B_GRAD,
                          lambda s: torch.empty(s, device="meta"))
        cfg = GradCompressionConfig(scheme="2bit", rate=GC_RATE,
                                    chunk=GC_CHUNK)
        (comp, t_init) = timed_call(lambda: GradCompressor(cfg, tpl,
                                                           device=device))
        if (comp.wire_bytes(), comp.fp32_bytes()) != (GC_WIRE_BYTES,
                                                      GC_FP32_BYTES):
            raise AssertionError(f"compressor bytes {comp.wire_bytes()}, "
                                 f"{comp.fp32_bytes()}")
        grads = qwen_leaves(QWEN2_05B_GRAD, lambda s: torch.randn(
            s, generator=gen, device=device))
        ef = qwen_leaves(QWEN2_05B_GRAD, lambda s: 0.01 * torch.randn(
            s, generator=gen, device=device))
        g_hat, ef_new = comp.sync(grads, ef, mesh, step=1)
        l_hat, l_ef = comp.sync_local(grads, ef, step=1)
        flat = [comp._flatten(t) for t in (g_hat, l_hat, ef_new, l_ef)]
        for a, b, what in ((flat[0], flat[1], "gradient"),
                           (flat[2], flat[3], "EF state")):
            top = float(b.abs().max())
            err = (a - b).abs()
            if bool((err > 1e-5 * top + 1e-5 * b.abs()).any()):
                raise AssertionError(f"sync {what} departs from sync_local: "
                                     f"max {float(err.max()):.3e}")
            rates[f"sync_{what.split()[0].lower()}_max_diff"] = \
                float(err.max())
        del flat, g_hat, ef_new, l_hat, l_ef
        vec = comp._flatten(grads)
        codes, scales = comp.encode(vec, 1)
        ms = dict(encode=time_ms(lambda: comp.encode(vec, 1), reps=5),
                  decode=time_ms(lambda: comp.decode(codes, scales, 1),
                                 reps=5),
                  sync=time_ms(lambda: comp.sync(grads, ef, mesh, step=1),
                               reps=5))
        gbs = {k: comp.fp32_bytes() / (1e-3 * v) / 1e9 for k, v in ms.items()}
        rates["compressor"] = dict(ms=ms, gradient_gb_s=gbs,
                                   init_s=t_init,
                                   wire_bytes=comp.wire_bytes(),
                                   fp32_bytes=comp.fp32_bytes())
        log(f"compressor on qwen2-0.5B's gradient ({comp.total} floats, "
            f"{len(comp.shapes)} leaves, {comp.n_chunks} chunks of {GC_CHUNK}, 2-bit at rate "
            f"{GC_RATE}): wire {comp.wire_bytes()} bytes against "
            f"{comp.fp32_bytes()} float32 bytes; R drawn and factored in "
            f"{t_init:.3f} s; ms (median of 5, CUDA events): encode "
            f"{ms['encode']:.3f}, decode {ms['decode']:.3f}, sync "
            f"{ms['sync']:.3f}; gradient GB/s encode {gbs['encode']:.1f}, "
            f"decode {gbs['decode']:.1f}, sync {gbs['sync']:.1f}; sync "
            f"against sync_local max diff {rates['sync_gradient_max_diff']:.3e}"
            f" (gradient), {rates['sync_ef_max_diff']:.3e} (EF) ({card})")
        del grads, ef, vec, codes, scales, comp
    torch.cuda.empty_cache()
    return counts, rates


# phase 16: the dense LM at full width (src/repro/configs/qwen2_0_5b.py,
# gemma2_9b.py); qwen2-0.5B's parameters, as phase 15's QWEN2_05B_GRAD
LM_QWEN, LM_GEMMA = "qwen2-0.5b", "gemma2-9b"
LM_QWEN_PARAMS = 494_032_768
LM_SERVE_BATCH, LM_PROMPT, LM_GREEDY, LM_SAMPLED = 8, 512, 64, 64
LM_TEMPERATURE = 0.8
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 8, 4096, 6
LM_RESUME_BATCH, LM_RESUME_SEQ, LM_RESUME_STEPS = 2, 512, 4
LM_COMPRESSED_STEPS = 3
LM_GEMMA_PROMPT, LM_GEMMA_DECODE = 8192, 32
LM_DECODE_BOUND = 0.08     # tests/test_models_smoke.py: err / scale


class cached_batches:
    """A ``TokenPipeline`` whose batches are made once a step (a second
    trainer over the same steps reuses them) and timed by CUDA events."""

    def __init__(self, pipe):
        self.pipe, self.batches, self.ms = pipe, {}, {}

    def batch_at(self, step: int):
        import torch
        if step not in self.batches:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            self.batches[step] = self.pipe.batch_at(step)
            b.record()
            self.ms[step] = (a, b)
        return self.batches[step]


def event_timed(fn, marks: list):
    """``fn`` with a pair of CUDA events recorded around each call into
    ``marks`` (no synchronisation)."""
    import torch

    def wrapped(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args, **kw)
        b.record()
        marks.append((a, b))
        return out
    return wrapped


def elapsed(marks) -> list:
    import torch
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in marks]


def decode_gate(params, seq, cfg, what: str) -> tuple:
    """Prefill ``seq[:, :-1]``, decode its last token at position S-1, and
    hold the logits to the full forward's last position by the
    reference's bound (err / scale < 0.08). Returns (err / scale, the
    length of the first pattern layer's cache)."""
    import torch
    from repro_torch.models import lm as L
    s = seq.shape[1]
    with torch.no_grad():
        _, caches = L.prefill(params, seq[:, :-1], cfg, max_len=s)
        dec, _ = L.decode_step(params, caches, seq[:, -1:], s - 1, cfg)
        length = caches["groups"]["p0"]["kv"]["k"].shape[2]
        del caches
        full = L.lm_logits(L.forward(params, seq, cfg)[0][:, -1:], params,
                           cfg)
    err = float((dec - full).abs().max())
    scale = float(full.abs().max()) + 1e-6
    if not err / scale < LM_DECODE_BOUND:
        raise AssertionError(f"{what}: decode departs from the forward, "
                             f"err {err:.4e} against scale {scale:.4e}")
    return err / scale, length


def served(params, prompt, cfg, n_tokens: int, temperature: float) -> tuple:
    """``generate`` timed (host clock between synchronisations) beside
    ``prefill`` alone: (tokens, seconds, prefill seconds)."""
    import torch
    from repro_torch.models import lm as L
    from repro_torch.serve import generate
    b, s = prompt.shape[:2]
    with torch.no_grad():
        _, t_pre = timed_call(lambda: L.prefill(params, prompt, cfg,
                                                max_len=s + n_tokens))
    out, t_gen = timed_call(lambda: generate(
        params, prompt, cfg, n_tokens, temperature=temperature, seed=0))
    if out.shape[:2] != (b, s + n_tokens) or \
            not torch.equal(out[:, :s], prompt):
        raise AssertionError(f"generate gave {tuple(out.shape)}")
    return out, t_gen, t_pre


def lm_phase(device, profile: bool = False) -> dict:
    """Phase 16: the dense LM path at qwen2-0.5B's and gemma2-9b's full
    widths: serve, train, resume, compressed training. ``profile`` adds a
    torch.profiler breakdown of one decode step and one training step.
    Returns its numbers."""
    import dataclasses
    import shutil
    import warnings
    import torch
    from repro_torch import configs as C
    from repro_torch.core.gradient_compression import (
        GradCompressionConfig, GradCompressor)
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import lm as L
    from repro_torch.models.nn import (count_params, init_params, tree_items,
                                       tree_leaves, tree_map)
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.serve import make_serve_step
    from repro_torch.train import (Trainer, TrainState,
                                   make_compressed_train_step,
                                   make_train_step)
    from repro_torch.train.train_loop import loss_and_grads
    card = card_line()
    out = {"card": card}
    torch.cuda.empty_cache()
    ops.reset_launch_counts()

    # (a) qwen2-0.5B
    cfg = C.get_config(LM_QWEN)
    specs = L.model_param_specs(cfg)
    n_params = count_params(specs)
    if n_params != LM_QWEN_PARAMS:
        raise AssertionError(f"{LM_QWEN}: {n_params} parameters")
    params, t_init = timed_call(lambda: init_params(specs, seed=0,
                                                    device=device))
    out["qwen_init_s"] = t_init
    log(f"LM {LM_QWEN}: {n_params} parameters ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} heads, {cfg.n_kv_heads} KV "
        f"heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}), "
        f"init_params(seed=0) on the card in {t_init:.3f} s ({card})")

    # serve: 8 prompts of 512 tokens, 64 greedy then 64 sampled
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=LM_PROMPT,
                                    global_batch=LM_SERVE_BATCH, seed=1),
                         device=device)
    prompt, t_prompt = timed_call(lambda: pipe.batch_at(0))
    torch.cuda.reset_peak_memory_stats()
    greedy, t_g, t_pre = served(params, prompt, cfg, LM_GREEDY, 0.0)
    sampled, t_s, t_pre2 = served(params, prompt, cfg, LM_SAMPLED,
                                  LM_TEMPERATURE)
    peak_serve = torch.cuda.max_memory_allocated()
    ratio, _ = decode_gate(params, greedy, cfg, LM_QWEN)
    rows = LM_SERVE_BATCH * LM_PROMPT
    dec = {k: 1e3 * (t - p) / (n - 1) for k, t, p, n in (
        ("greedy", t_g, t_pre, LM_GREEDY),
        ("sampled", t_s, t_pre2, LM_SAMPLED))}
    out["qwen_serve"] = dict(
        prompt_batch_s=t_prompt, prefill_s=[t_pre, t_pre2],
        prefill_tokens_s=[rows / t_pre, rows / t_pre2],
        generate_s={"greedy": t_g, "sampled": t_s},
        decode_ms_token=dec,
        decode_tokens_s={k: LM_SERVE_BATCH / (v / 1e3)
                         for k, v in dec.items()},
        decode_vs_forward=ratio, peak_bytes=peak_serve,
        distinct_sampled=int((sampled[:, LM_PROMPT:] !=
                              greedy[:, LM_PROMPT:]).sum()))
    log(f"LM {LM_QWEN} serve: {LM_SERVE_BATCH} prompts of {LM_PROMPT} tokens "
        f"from TokenPipeline ({t_prompt:.3f} s); prefill {t_pre:.4f}, "
        f"{t_pre2:.4f} s = {rows / t_pre:,.0f}, {rows / t_pre2:,.0f} "
        f"tokens/s; generate {LM_GREEDY} greedy {t_g:.3f} s, {LM_SAMPLED} at "
        f"temperature {LM_TEMPERATURE} {t_s:.3f} s; decode "
        f"{dec['greedy']:.3f} / {dec['sampled']:.3f} ms a token (batch "
        f"{LM_SERVE_BATCH}) = {LM_SERVE_BATCH / dec['greedy'] * 1e3:,.1f} / "
        f"{LM_SERVE_BATCH / dec['sampled'] * 1e3:,.1f} tokens/s; decode "
        f"against forward err/scale {ratio:.5f} (bound {LM_DECODE_BOUND}); "
        f"peak allocated {peak_serve / 2**30:.2f} GiB ({card})")

    if profile:
        with torch.no_grad():
            _, caches = L.prefill(params, greedy[:, :-1], cfg,
                                  max_len=greedy.shape[1])
        serve_step = make_serve_step(cfg)
        profile_window(f"LM {LM_QWEN} decode step (batch {LM_SERVE_BATCH})",
                       lambda: serve_step(params, caches, greedy[:, -1:],
                                          greedy.shape[1] - 1), top=10)
        del caches

    # the same widths at two layers in float32: the card against the CPU
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    p_cpu = init_params(L.model_param_specs(cfg32), seed=0, device="cpu")
    p_gpu = tree_map(lambda t: t.to(device), p_cpu)
    small = prompt[:2, :64]
    with torch.no_grad():
        lg = L.lm_logits(L.forward(p_gpu, small, cfg32)[0], p_gpu,
                         cfg32).cpu()
        lc = L.lm_logits(L.forward(p_cpu, small.cpu(), cfg32)[0], p_cpu,
                         cfg32)
    err = (lg - lc).abs()
    top = float(lc.abs().max())
    if bool((err > 1e-3 * lc.abs() + 1e-4 * top).any()):
        raise AssertionError(f"float32 logits on the card depart from the "
                             f"CPU's: max {float(err.max()):.3e}")
    out["qwen_f32_card_vs_cpu_max_err"] = float(err.max())
    log(f"LM {LM_QWEN} at 2 layers in float32: logits on the card within "
        f"rtol 1e-3 (atol 1e-4 of the largest, {top:.3f}) of the CPU port's, "
        f"max diff {float(err.max()):.3e}")
    del p_gpu, p_cpu, lg, lc

    # train: 6 steps at 8 x 4,096 through Trainer
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=2)
    train_pipe = cached_batches(TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=LM_TRAIN_SEQ,
        global_batch=LM_TRAIN_BATCH), device=device))
    opt = init_opt_state(params, opt_cfg)
    marks = []
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(event_timed(make_train_step(cfg, opt_cfg), marks),
                      TrainState(params, opt), train_pipe, ckpt_dir=None,
                      log_every=LM_TRAIN_STEPS + 1, log_fn=log)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer.run(LM_TRAIN_STEPS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message)]
    step_ms = elapsed(marks)
    batch_ms = [a.elapsed_time(b) for a, b in
                (train_pipe.ms[s] for s in sorted(train_pipe.ms))]
    losses = [float(m["loss"]) for m in trainer.history]
    gnorms = [float(m["grad_norm"]) for m in trainer.history]
    peak_train = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses}")
    if syncs:
        raise AssertionError(f"the training loop synchronised with the host "
                             f"{len(syncs)} times: {syncs[:3]}")
    state_bytes = sum(t.numel() * t.element_size() for t in
                      tree_leaves(params) + tree_leaves(opt))
    tok_step = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    out["qwen_train"] = dict(
        losses=losses, grad_norms=gnorms, step_ms=step_ms,
        tokens_s=[tok_step / (ms / 1e3) for ms in step_ms],
        batch_ms=batch_ms, run_s=t_train, peak_bytes=peak_train,
        state_bytes=state_bytes, host_syncs=len(syncs))
    log(f"LM {LM_QWEN} train: {LM_TRAIN_STEPS} steps of {LM_TRAIN_BATCH} x "
        f"{LM_TRAIN_SEQ} through Trainer (AdamW lr 1e-3, warm-up 2, master "
        f"copy), losses {[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 3) for x in gnorms]}; ms a step (CUDA events) "
        f"{[round(x, 1) for x in step_ms]} = "
        f"{[round(tok_step / x * 1e3) for x in step_ms]} tokens/s; a batch "
        f"from TokenPipeline {[round(x, 1) for x in batch_ms]} ms; {t_train:.2f} "
        f"s for the run; no host synchronisation in the loop (sync debug "
        f"mode); state (weights, moments, master) {state_bytes / 2**30:.2f} "
        f"GiB, peak allocated {peak_train / 2**30:.2f} GiB ({card})")
    if profile:
        step_fn, batch = make_train_step(cfg, opt_cfg), train_pipe.batch_at(0)
        profile_window(f"LM {LM_QWEN} training step ({LM_TRAIN_BATCH} x "
                       f"{LM_TRAIN_SEQ})", lambda: step_fn(params, opt, batch),
                       top=12)
    del opt, trainer

    # compressed: a one-card NCCL group, 2-bit codes at rate 8
    gc_cfg = GradCompressionConfig(scheme="2bit", rate=GC_RATE, chunk=GC_CHUNK)
    opt = init_opt_state(params, opt_cfg)
    with nccl_mesh() as mesh:
        comp = GradCompressor(gc_cfg, params, device=device)
        if comp.wire_bytes() != GC_WIRE_BYTES:
            raise AssertionError(f"wire bytes {comp.wire_bytes()}")
        sync_marks, step_marks = [], []
        comp.sync = event_timed(comp.sync, sync_marks)
        step_fn = event_timed(make_compressed_train_step(
            cfg, opt_cfg, mesh, comp), step_marks)
        tr = Trainer(step_fn, TrainState(params, opt, ef=comp.init_ef(params)),
                     train_pipe, log_every=LM_COMPRESSED_STEPS + 1,
                     log_fn=log)
        tr.run(LM_COMPRESSED_STEPS)
        c_ms, s_ms = elapsed(step_marks), elapsed(sync_marks)
        c_loss = [float(m["loss"]) for m in tr.history]
        if not all(math.isfinite(x) for x in c_loss):
            raise AssertionError(f"compressed losses {c_loss}")
        # sync against sync_local on the model's real gradient
        _, _, grads = loss_and_grads(params, train_pipe.batch_at(0), cfg)
        ef = tr.state.ef
        del comp.sync
        g_hat, ef_new = comp.sync(grads, ef, mesh, step=LM_COMPRESSED_STEPS)
        l_hat, l_ef = comp.sync_local(grads, ef, step=LM_COMPRESSED_STEPS)
        diffs = {}
        for a, b, what in ((g_hat, l_hat, "gradient"), (ef_new, l_ef, "EF")):
            a, b = comp._flatten(a), comp._flatten(b)
            e = (a - b).abs()
            if bool((e > 1e-5 * float(b.abs().max()) + 1e-5 * b.abs()).any()):
                raise AssertionError(f"sync {what} departs from sync_local: "
                                     f"max {float(e.max()):.3e}")
            diffs[what] = float(e.max())
        del grads, g_hat, ef_new, l_hat, l_ef, ef, tr
    share = [s / c for s, c in zip(s_ms, c_ms)]
    out["qwen_compressed"] = dict(
        losses=c_loss, step_ms=c_ms, sync_ms=s_ms, sync_share=share,
        wire_bytes=comp.wire_bytes(), fp32_bytes=comp.fp32_bytes(),
        sync_vs_local=diffs)
    log(f"LM {LM_QWEN} compressed: {LM_COMPRESSED_STEPS} steps of "
        f"make_compressed_train_step over a one-card NCCL group "
        f"(GradCompressor 2-bit, rate {GC_RATE}, chunk {GC_CHUNK}, "
        f"{len(comp.shapes)} leaves, wire {comp.wire_bytes()} bytes), losses "
        f"{[round(x, 4) for x in c_loss]}; ms a step "
        f"{[round(x, 1) for x in c_ms]}, of which sync "
        f"{[round(x, 1) for x in s_ms]} ({[round(100 * x, 1) for x in share]} "
        f"%); sync against sync_local on the real gradient max diff "
        f"{diffs['gradient']:.3e} (gradient), {diffs['EF']:.3e} (EF) ({card})")
    del comp, opt, params, train_pipe
    torch.cuda.empty_cache()

    # resume: two layers, full width, float32; bit-exact
    cfg_r = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    opt_r = AdamWConfig(lr_peak=1e-3, warmup_steps=2, master_fp32=False)
    pipe_r = cached_batches(TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=LM_RESUME_SEQ,
        global_batch=LM_RESUME_BATCH, seed=2), device=device))
    ckpt = os.path.join(ROOT, "build", f"lm-resume-{os.getpid()}")
    shutil.rmtree(ckpt, ignore_errors=True)

    def fresh(ckpt_dir):
        p = init_params(L.model_param_specs(cfg_r), seed=1, device=device)
        return Trainer(make_train_step(cfg_r, opt_r),
                       TrainState(p, init_opt_state(p, opt_r)), pipe_r,
                       ckpt_dir=ckpt_dir, ckpt_every=0, log_fn=lambda *a: None)
    try:
        whole = fresh(None)
        whole.run(LM_RESUME_STEPS)
        first = fresh(ckpt)
        _, t_save = timed_call(lambda: first.run(LM_RESUME_STEPS // 2))
        del first
        second = fresh(ckpt)
        _, t_load = timed_call(second.maybe_resume)
        if second.state.step != LM_RESUME_STEPS // 2:
            raise AssertionError(f"resumed at step {second.state.step}")
        second.run(LM_RESUME_STEPS)
        for (p, a), (_, b) in zip(
                tree_items({"params": whole.state.params,
                            "opt": whole.state.opt_state}),
                tree_items({"params": second.state.params,
                            "opt": second.state.opt_state})):
            if not torch.equal(a, b):
                raise AssertionError(f"resumed {p} differs from the "
                                     f"uninterrupted run")
        last = os.path.join(ckpt, f"step_{LM_RESUME_STEPS}")
        ck_bytes = sum(os.path.getsize(os.path.join(last, f))
                       for f in os.listdir(last))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    out["qwen_resume"] = dict(save_run_s=t_save, restore_s=t_load,
                              checkpoint_bytes=ck_bytes)
    log(f"LM {LM_QWEN} resume: 2 layers, full width, float32; "
        f"{LM_RESUME_STEPS} steps of {LM_RESUME_BATCH} x {LM_RESUME_SEQ} "
        f"uninterrupted against {LM_RESUME_STEPS // 2}, a checkpoint under "
        f"build/, a fresh Trainer resumed to {LM_RESUME_STEPS}: parameters "
        f"and optimizer state bit-identical; {LM_RESUME_STEPS // 2} steps "
        f"and the save {t_save:.2f} s, restore {t_load:.2f} s, the last "
        f"checkpoint {ck_bytes / 2**20:.1f} MiB")
    del whole, second, pipe_r
    torch.cuda.empty_cache()

    # (b) gemma2-9b: serve only, an 8,192-token prompt past the 4,096 window
    cfg = C.get_config(LM_GEMMA)
    specs = L.model_param_specs(cfg)
    params, t_init = timed_call(lambda: init_params(specs, seed=0,
                                                    device=device))
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=LM_GEMMA_PROMPT, global_batch=1,
                                    seed=3), device=device)
    prompt, t_prompt = timed_call(lambda: pipe.batch_at(0))
    torch.cuda.reset_peak_memory_stats()
    seq, t_g, t_pre = served(params, prompt, cfg, LM_GEMMA_DECODE, 0.0)
    peak = torch.cuda.max_memory_allocated()
    ratio, ring = decode_gate(params, seq, cfg, LM_GEMMA)
    if ring != cfg.window:
        raise AssertionError(f"local layers' cache {ring} != {cfg.window}")
    d_ms = 1e3 * (t_g - t_pre) / (LM_GEMMA_DECODE - 1)
    out["gemma_serve"] = dict(
        params=count_params(specs), init_s=t_init, prompt_batch_s=t_prompt,
        prefill_s=t_pre, prefill_tokens_s=LM_GEMMA_PROMPT / t_pre,
        generate_s=t_g, decode_ms_token=d_ms, decode_vs_forward=ratio,
        peak_bytes=peak)
    log(f"LM {LM_GEMMA}: {count_params(specs)} parameters ({cfg.n_layers} "
        f"layers {cfg.layer_pattern}, window {cfg.window}, softcaps "
        f"{cfg.attn_softcap}/{cfg.logit_softcap}, {cfg.activation}), init "
        f"{t_init:.2f} s; a prompt of {LM_GEMMA_PROMPT} tokens "
        f"({t_prompt:.2f} s from TokenPipeline): prefill {t_pre:.3f} s = "
        f"{LM_GEMMA_PROMPT / t_pre:,.0f} tokens/s (the L layers banded, "
        f"their caches a ring of {ring}); {LM_GEMMA_DECODE} greedy tokens, "
        f"decode {d_ms:.3f} ms a token; decode at position "
        f"{seq.shape[1] - 1} against forward err/scale {ratio:.5f} (bound "
        f"{LM_DECODE_BOUND}); peak allocated {peak / 2**30:.2f} GiB ({card})")
    del params, seq, prompt, pipe
    torch.cuda.empty_cache()
    counts = ops.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the LM path launched kernels: {counts}")
    return out


# phase 17: the MoE, hybrid and SSM families at full width
# (src/repro/configs/olmoe_1b_7b.py, qwen3_moe_235b_a22b.py,
# zamba2_1_2b.py, rwkv6_7b.py). The parameter counts are the reference's
# count_params of the same specs (tests/test_torch_lm_families.py holds
# both packages to them), by (arch, layers).
LMF_OLMOE, LMF_QWEN3 = "olmoe-1b-7b", "qwen3-moe-235b-a22b"
LMF_ZAMBA, LMF_RWKV = "zamba2-1.2b", "rwkv6-7b"
LMF_PARAMS = {(LMF_OLMOE, 16): 6_919_100_416, (LMF_OLMOE, 4): 1_884_310_528,
              (LMF_QWEN3, 2): 6_220_173_824, (LMF_ZAMBA, 38): 1_057_589_376,
              (LMF_RWKV, 32): 7_534_546_944, (LMF_RWKV, 2): 974_229_504}
# (arch, layers served, layers trained or None): the depth cuts are
# qwen3's 2 of 94 layers (its 470 GB of weights are four cards' work,
# ROADMAP A.13.3), olmoe trained at 4 of 16 layers and rwkv6 at 2 of 32
LMF_RUNS = ((LMF_OLMOE, 16, 4), (LMF_QWEN3, 2, None), (LMF_ZAMBA, 38, 38),
            (LMF_RWKV, 32, 2))
LMF_SERVE_BATCH, LMF_PROMPT, LMF_GREEDY, LMF_SAMPLED = 8, 512, 32, 32
LMF_TRAIN_BATCH, LMF_TRAIN_SEQ, LMF_TRAIN_STEPS = 8, 4096, 4
LMF_LR = 3e-4              # launch.train's --lr
# the float32 copies: two layers of each (zamba2's as two AM groups, so
# that its shared block runs with two LoRAs), one short sequence
LMF_F32 = ((LMF_OLMOE, {}), (LMF_QWEN3, {}),
           (LMF_ZAMBA, {"shared_attn_every": 1}), (LMF_RWKV, {}))
LMF_F32_BATCH, LMF_F32_SEQ, LMF_TIE_GAP = 2, 64, 1e-5
# the bf16 decode check's depth: the reference's bound 0.08 was set on
# its smoke configs, 2-8 layers deep (tests/test_models_smoke.py). Deeper,
# the bf16 forward does not reproduce itself within it: on an H100
# rwkv6-7b's last-position logits from batches of 4 and of 8 rows lie
# 0.157 apart at 32 layers (``forward_spread``), and a decode step's
# departure grows with depth (scripts/decode_depth_probe.py)
LMF_BF16_GATE_LAYERS = 8
# the float32 decode check at the served depth: decode departs from the
# forward by at most this many times the forward's own departure between
# batches of 4 and 8 rows, and never needs to be nearer than the floor
LMF_F32_SPREAD_FACTOR, LMF_F32_FLOOR = 4.0, 1e-4
LMF_EXP_MAX = 88.72        # ln of float32's largest value


class spied:
    """Within the block, ``module.name`` (a function) runs as before and
    each call's result is appended to the list the block receives."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self) -> list:
        fn = self.orig = getattr(self.module, self.name)

        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            self.calls.append(out)
            return out
        setattr(self.module, self.name, wrapped)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)
        return False


def family_decode_gate(params, seq, cfg, bound: float) -> dict:
    """``decode_gate`` for any layer kinds: prefill ``seq[:, :-1]``, decode
    its last token, and compare the logits with the full forward's last
    position, row by row (a row's err over its largest logit).

    Where the decode step's router picks another expert set than the
    forward's for a row's last token, the forward takes the decode's
    experts at that token (gated by its own probabilities), so that the
    row is held to ``bound`` all the same. Such a flip must be a near
    tie: the forward's probability of each expert it alone picks exceeds
    that of each expert the decode alone picks by at most twice the
    largest difference between the two paths' probabilities at that
    token, as it must when the decode ranks its own probabilities right.
    Returns {"ratio": the largest row's err / scale, "bound", "flipped":
    the rows with such a flip, "tie_slack": the least of twice that
    difference less the gap over the flips (None without one), "ok":
    ratio below ``bound`` and every flip a near tie}."""
    import torch
    from repro_torch.models import lm as L
    from repro_torch.models import moe as MOE
    b, s = seq.shape[:2]
    last = torch.arange(b, device=seq.device) * s + (s - 1)
    with torch.no_grad():
        _, caches = L.prefill(params, seq[:, :-1], cfg, max_len=s)
        with spied(MOE, "_route") as dec_routes:
            dec, _ = L.decode_step(params, caches, seq[:, -1:], s - 1, cfg)
        del caches
        route, decoded = MOE._route, iter(dec_routes)
        flipped = torch.zeros(b, dtype=torch.bool, device=seq.device)
        slack = []

        def aligned(x, w, c):
            gate, expert, tok, probs = route(x, w, c)
            k = c.n_per_token
            _, de, _, dp = next(decoded)
            de, fe = de.view(b, k), expert.view(-1, k)[last]
            pf = probs[last]
            in_f = torch.zeros_like(pf, dtype=torch.bool).scatter_(1, fe, True)
            in_d = torch.zeros_like(pf, dtype=torch.bool).scatter_(1, de, True)
            differ = (in_f != in_d).any(dim=1)
            if not bool(differ.any()):
                return gate, expert, tok, probs
            flipped.logical_or_(differ)
            gap = (torch.where(in_f & ~in_d, pf, -1.0).amax(dim=1)
                   - torch.where(in_d & ~in_f, pf, 2.0).amin(dim=1))
            noise = (pf - dp).abs().amax(dim=1)
            slack.append(float((2 * noise - gap)[differ].min()))
            vals = pf.gather(1, de)
            if c.renorm_gates:
                vals = vals / torch.clamp(vals.sum(dim=-1, keepdim=True),
                                          min=1e-9)
            rows = last[differ]
            expert, gate = expert.view(-1, k).clone(), gate.view(-1, k).clone()
            expert[rows], gate[rows] = de[differ], vals[differ]
            return gate.reshape(-1), expert.reshape(-1), tok, probs

        MOE._route = aligned
        try:
            full = L.lm_logits(L.forward(params, seq, cfg)[0][:, -1:],
                               params, cfg)
        finally:
            MOE._route = route
    rows = ((dec - full).abs().amax(dim=-1) /
            (full.abs().amax(dim=-1) + 1e-6)).flatten()
    ratio = float(rows.max())
    tie_slack = min(slack) if slack else None
    return {"ratio": ratio, "bound": bound,
            "ok": ratio < bound and (tie_slack is None or tie_slack >= 0),
            "flipped": int(flipped.sum()), "tie_slack": tie_slack}


def forward_spread(params, seq, cfg) -> float:
    """The largest row's departure (err over its largest logit) of the
    forward's last-position logits on ``seq``'s first and last 4 rows,
    each a batch, from those on all 8 rows in one batch."""
    import torch
    from repro_torch.models import lm as L

    def last_logits(rows):
        return L.lm_logits(L.forward(params, rows, cfg)[0][:, -1:], params,
                           cfg)
    with torch.no_grad():
        full = last_logits(seq)
        half = torch.cat([last_logits(seq[:4]), last_logits(seq[4:])])
    return float(((half - full).abs().amax(dim=-1) /
                  (full.abs().amax(dim=-1) + 1e-6)).max())


def family_config(arch: str, layers: int, **kw):
    """The full config of ``arch`` at ``layers`` layers; its parameter
    count checked against the reference's."""
    import dataclasses
    from repro_torch import configs as C
    from repro_torch.models import lm as L
    from repro_torch.models.nn import count_params
    cfg = dataclasses.replace(C.get_config(arch), n_layers=layers, **kw)
    specs = L.model_param_specs(cfg)
    n = count_params(specs)
    if (arch, layers) in LMF_PARAMS and n != LMF_PARAMS[(arch, layers)]:
        raise AssertionError(f"{arch} at {layers} layers: {n} parameters, "
                             f"not the reference's "
                             f"{LMF_PARAMS[(arch, layers)]}")
    return cfg, specs, n


def flips(gate: dict) -> str:
    """The text of a decode check's routing flips, if it had any."""
    if not gate["flipped"]:
        return ""
    return (f"; rows routed at a near tie to another expert set, held "
            f"with it: {gate['flipped']}, slack {gate['tie_slack']:.3e}")


def family_serve(arch: str, layers: int, device, card: str) -> dict:
    """Serve ``arch`` at ``layers`` layers: ``generate`` on 8 prompts of
    512 tokens (32 greedy, then 32 at temperature 0.8), the share of
    expert assignments kept at the config's capacity factor, and the
    decode check on the 8 greedy sequences (MoE at capacity E/k, where
    none can drop; ``family_decode_gate``): in bf16 below 0.08 on the
    model's first 8 layers (the same draws), and on a float32 copy at
    ``layers`` within 4 times its forward's own ``forward_spread`` (at
    least 1e-4). The bf16 check at ``layers`` and the bf16 forward's
    spread are printed."""
    import dataclasses
    import torch
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import lm as L
    from repro_torch.models import moe as MOE
    from repro_torch.models.nn import init_params
    cfg, specs, n = family_config(arch, layers)
    params, t_init = timed_call(lambda: init_params(specs, seed=0,
                                                    device=device))
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=LMF_PROMPT,
                                    global_batch=LMF_SERVE_BATCH, seed=1),
                         device=device)
    prompt, t_prompt = timed_call(lambda: pipe.batch_at(0))
    torch.cuda.reset_peak_memory_stats()
    # a prefill first (it warms the timed calls up: a cold first prefill
    # outlasted generate's own, and the decode time came out negative),
    # the experts' kept mask spied
    with spied(MOE, "_slots") as calls, torch.no_grad():
        L.prefill(params, prompt, cfg)
    kept = sum(float(c[2].sum()) for c in calls) / \
        sum(c[2].numel() for c in calls) if calls else None
    greedy, t_g, t_pre = served(params, prompt, cfg, LMF_GREEDY, 0.0)
    _, t_s, t_pre2 = served(params, prompt, cfg, LMF_SAMPLED,
                            LM_TEMPERATURE)
    peak = torch.cuda.max_memory_allocated()
    gate_cfg = cfg
    if cfg.n_experts:
        gate_cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.n_experts_per_token)
    deep = family_decode_gate(params, greedy, gate_cfg, LM_DECODE_BOUND)
    deep["forward_spread"] = forward_spread(params, greedy, gate_cfg)
    del params, prompt, pipe
    torch.cuda.empty_cache()
    cut = min(cfg.n_layers, LMF_BF16_GATE_LAYERS)
    if cut < cfg.n_layers:
        cut_cfg = dataclasses.replace(gate_cfg, n_layers=cut)
        p_cut = init_params(L.model_param_specs(cut_cfg), seed=0,
                            device=device)
        bf16 = family_decode_gate(p_cut, greedy, cut_cfg, LM_DECODE_BOUND)
        del p_cut
        torch.cuda.empty_cache()
    else:
        bf16 = deep
    cfg32 = dataclasses.replace(gate_cfg, dtype="float32")
    p32 = init_params(L.model_param_specs(cfg32), seed=0, device=device)
    spread = forward_spread(p32, greedy, cfg32)
    gate = family_decode_gate(
        p32, greedy, cfg32, max(LMF_F32_FLOOR, LMF_F32_SPREAD_FACTOR * spread))
    gate["forward_spread"] = spread
    del p32
    rows = LMF_SERVE_BATCH * LMF_PROMPT
    dec = {k: 1e3 * (t - p) / (m - 1) for k, t, p, m in (
        ("greedy", t_g, t_pre, LMF_GREEDY),
        ("sampled", t_s, t_pre2, LMF_SAMPLED))}
    log(f"LM {arch}: {n} parameters ({cfg.n_layers} layers of "
        f"{cfg.layer_pattern if cfg.family not in ('hybrid', 'ssm') else cfg.family}"
        f", d_model {cfg.d_model}"
        + (f", {cfg.n_experts} experts top-{cfg.n_experts_per_token} "
           f"(gates {'renormalised' if cfg.renorm_gates else 'as drawn'}, "
           f"d_ff {cfg.moe_d_ff})" if cfg.n_experts else "")
        + f", vocab {cfg.vocab_size}, {cfg.dtype}), init {t_init:.2f} s; "
        f"serve {LMF_SERVE_BATCH} prompts of {LMF_PROMPT} tokens "
        f"({t_prompt:.2f} s from TokenPipeline): prefill {t_pre:.4f}, "
        f"{t_pre2:.4f} s = {rows / t_pre:,.0f}, {rows / t_pre2:,.0f} "
        f"tokens/s; decode {dec['greedy']:.3f} / {dec['sampled']:.3f} ms a "
        f"token greedy / at temperature {LM_TEMPERATURE} (batch "
        f"{LMF_SERVE_BATCH})"
        + (f"; expert assignments kept at capacity factor "
           f"{cfg.capacity_factor}: {kept:.5f}" if kept is not None else "")
        + f"; decode against forward at position {greedy.shape[1] - 1}"
        + (f" (capacity factor {gate_cfg.capacity_factor})"
           if cfg.n_experts else "")
        + f", err/scale over {LMF_SERVE_BATCH} rows: bf16 at {cut} layers "
        f"{bf16['ratio']:.5f} (bound {LM_DECODE_BOUND}: "
        f"{'held' if bf16['ok'] else 'FAILED'}{flips(bf16)}), a float32 "
        f"copy at {cfg.n_layers} layers {gate['ratio']:.3e} (bound "
        f"{gate['bound']:.3e}, {LMF_F32_SPREAD_FACTOR:g} x its forward's "
        f"own spread {gate['forward_spread']:.3e} between batches of 4 and "
        f"8 rows, at least {LMF_F32_FLOOR:g}: "
        f"{'held' if gate['ok'] else 'FAILED'}{flips(gate)}); not gated, "
        f"bf16 at {cfg.n_layers} layers {deep['ratio']:.5f} beside its "
        f"forward's own spread {deep['forward_spread']:.5f}{flips(deep)}"
        + f"; peak allocated {peak / 2**30:.2f} GiB ({card})")
    del greedy
    torch.cuda.empty_cache()
    return dict(params=n, layers=cfg.n_layers, init_s=t_init,
                prompt_batch_s=t_prompt, prefill_s=[t_pre, t_pre2],
                prefill_tokens_s=[rows / t_pre, rows / t_pre2],
                generate_s={"greedy": t_g, "sampled": t_s},
                decode_ms_token=dec, decode_vs_forward_f32=gate,
                decode_vs_forward_bf16=bf16, bf16_at_served_depth=deep,
                kept_share=kept, peak_bytes=peak)


def family_train(arch: str, layers: int, device, card: str) -> dict:
    """Train ``arch`` at ``layers`` layers: 4 steps of 8 x 4,096 through
    ``Trainer`` under CUDA's sync debug mode; every loss, aux and
    gradient norm finite (a non-finite gradient makes the norm so), the
    last loss below the first, no host synchronisation."""
    import warnings
    import torch
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import rwkv6 as R
    from repro_torch.models.nn import init_params, tree_leaves
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import Trainer, TrainState, make_train_step
    cfg, specs, n = family_config(arch, layers)
    params, t_init = timed_call(lambda: init_params(specs, seed=0,
                                                    device=device))
    extra = ""
    if cfg.family == "ssm":
        # at init the decay's LoRA is zero: lw = -exp(clip(w0, -8, 4)); the
        # reference's masked pairs reach chunk x |lw|, which overflows
        # float32's exp past 88.72 (ROADMAP C)
        w0 = params["blocks"]["p0"]["time"]["w0"].float()
        lw = torch.exp(torch.clamp(w0, -8.0, 4.0))
        over = int((cfg.rwkv_chunk * lw > LMF_EXP_MAX).sum())
        nc = LMF_TRAIN_SEQ // cfg.rwkv_chunk
        # B x Q x Q x H x K float32 a chunk (H x K = d_model)
        per_chunk = LMF_TRAIN_BATCH * cfg.rwkv_chunk ** 2 * cfg.d_model * 4
        nb = min(nc, max(1, R.BLOCK_BYTES // per_chunk))
        extra = (f"; {over} of {w0.numel()} decay channels overflow the "
                 f"reference's masked exponent at init (chunk "
                 f"{cfg.rwkv_chunk}); the WKV pairwise decays "
                 f"[B, nc, Q, Q, H, K] in float32 are "
                 f"{nc * per_chunk / 2**30:.2f} GiB a layer, taken in "
                 f"blocks of {nb} of {nc} chunks "
                 f"({nb * per_chunk / 2**30:.2f} GiB)")
    # the launcher's learning rate: at 1e-3, Adam moves olmoe's router
    # logits by about 1.6 a step (2,048 inputs of about 0.8 times the lr),
    # the routing collapses onto few experts (aux 4.7 -> 11.9 in three
    # steps) and the fourth step's loss rose above the first's
    opt_cfg = AdamWConfig(lr_peak=LMF_LR, warmup_steps=1)
    opt = init_opt_state(params, opt_cfg)
    pipe = cached_batches(TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=LMF_TRAIN_SEQ,
        global_batch=LMF_TRAIN_BATCH), device=device))
    marks = []
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    trainer = Trainer(event_timed(make_train_step(cfg, opt_cfg), marks),
                      TrainState(params, opt), pipe, ckpt_dir=None,
                      log_every=LMF_TRAIN_STEPS + 1, log_fn=log)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer.run(LMF_TRAIN_STEPS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message)]
    step_ms = elapsed(marks)
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    losses = [float(m["loss"]) for m in hist]
    gnorms = [float(m["grad_norm"]) for m in hist]
    auxes = [float(m["aux"]) for m in hist] if cfg.n_experts else []
    state_bytes = sum(t.numel() * t.element_size() for t in
                      tree_leaves(params) + tree_leaves(opt))
    if not all(math.isfinite(x) for x in losses + gnorms + auxes) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{arch} training: losses {losses}, grad norms "
                             f"{gnorms}, aux {auxes}")
    if syncs:
        raise AssertionError(f"{arch}: the training loop synchronised with "
                             f"the host {len(syncs)} times: {syncs[:3]}")
    tok = LMF_TRAIN_BATCH * LMF_TRAIN_SEQ
    log(f"LM {arch} train: {n} parameters ({cfg.n_layers} layers), "
        f"{LMF_TRAIN_STEPS} steps of {LMF_TRAIN_BATCH} x {LMF_TRAIN_SEQ} "
        f"through Trainer (AdamW lr {LMF_LR}, warm-up 1, master copy), losses "
        f"{[round(x, 4) for x in losses]}"
        + (f", aux {[round(x, 4) for x in auxes]}" if auxes else "")
        + f", grad norms {[round(x, 3) for x in gnorms]} (every gradient "
        f"finite); ms a step (CUDA events) {[round(x, 1) for x in step_ms]}"
        f" = {[round(tok / x * 1e3) for x in step_ms]} tokens/s; "
        f"{t_train:.2f} s for the run; no host synchronisation in the loop "
        f"(sync debug mode); state {state_bytes / 2**30:.2f} GiB, "
        f"allocated before the first step {base / 2**30:.2f} GiB, peak "
        f"allocated {peak / 2**30:.2f} GiB{extra} ({card})")
    del params, opt, trainer, pipe
    torch.cuda.empty_cache()
    return dict(params=n, layers=cfg.n_layers, init_s=t_init, losses=losses,
                aux=auxes, grad_norms=gnorms, step_ms=step_ms,
                tokens_s=[tok / (ms / 1e3) for ms in step_ms], run_s=t_train,
                peak_bytes=peak, base_bytes=base, state_bytes=state_bytes,
                host_syncs=len(syncs))


def family_f32(arch: str, extra: dict, device, card: str) -> dict:
    """Two layers of ``arch`` at full width in float32, the card's weights
    copied to the CPU: logits on one short sequence within rtol 1e-3 plus
    1e-4 of the largest, and each MoE layer's expert ids equal but at
    near ties (a gap below 1e-5 among the top k + 1 probabilities)."""
    import torch
    from repro_torch.models import lm as L
    from repro_torch.models import moe as MOE
    from repro_torch.models.nn import init_params, tree_map
    cfg, specs, _ = family_config(arch, 2, dtype="float32", **extra)
    p_gpu = init_params(specs, seed=0, device=device)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    tok = torch.randint(0, cfg.vocab_size, (LMF_F32_BATCH, LMF_F32_SEQ),
                        dtype=torch.int32,
                        generator=torch.Generator().manual_seed(7))
    runs = {}
    for where, p, t in (("card", p_gpu, tok.to(device)), ("cpu", p_cpu, tok)):
        with spied(MOE, "_route") as calls, torch.no_grad():
            lg = L.lm_logits(L.forward(p, t, cfg)[0], p, cfg).cpu()
        runs[where] = (lg, [(c[1].cpu(), c[3].cpu()) for c in calls])
    (lg, routes_g), (lc, routes_c) = runs["card"], runs["cpu"]
    err = (lg - lc).abs()
    top = float(lc.abs().max())
    if bool((err > 1e-3 * lc.abs() + 1e-4 * top).any()):
        raise AssertionError(f"{arch}: float32 logits on the card depart "
                             f"from the CPU's: max {float(err.max()):.3e}")
    ties = flips = 0
    k = cfg.n_experts_per_token
    for (eg, _), (ec, pc) in zip(routes_g, routes_c):
        srt = torch.sort(pc, dim=-1, descending=True).values[:, :k + 1]
        near = ((srt[:, :-1] - srt[:, 1:]) < LMF_TIE_GAP).any(dim=1)
        differ = (eg.view(-1, k) != ec.view(-1, k)).any(dim=1)
        if bool((differ & ~near).any()):
            raise AssertionError(f"{arch}: expert ids differ away from a "
                                 f"near tie at {int((differ & ~near).sum())} "
                                 f"tokens")
        ties += int(near.sum())
        flips += int(differ.sum())
    log(f"LM {arch} at 2 layers in float32"
        + (f" ({', '.join(f'{a}={v}' for a, v in extra.items())})"
           if extra else "")
        + f": logits on the card within rtol 1e-3 (atol 1e-4 of the "
        f"largest, {top:.3f}) of the CPU port's, max diff "
        f"{float(err.max()):.3e}"
        + (f"; expert ids of {len(routes_c)} MoE layers x "
           f"{LMF_F32_BATCH * LMF_F32_SEQ} tokens equal but at near ties: "
           f"{ties} near ties (gap below {LMF_TIE_GAP}), {flips} tokens "
           f"differ" if cfg.n_experts else "") + f" ({card})")
    del p_gpu, p_cpu
    torch.cuda.empty_cache()
    return dict(max_err=float(err.max()), scale=top, near_ties=ties,
                id_flips=flips)


def lm_families_phase(device) -> dict:
    """Phase 17: olmoe-1b-7b, qwen3-moe-235b-a22b (2 of 94 layers),
    zamba2-1.2b and rwkv6-7b served at full width, olmoe (4 layers),
    zamba2 and rwkv6 (2 layers) trained, and float32 two-layer copies of
    all four on the card against the CPU. Returns its numbers."""
    import torch
    from repro_torch.kernels import ops
    card = card_line()
    out = {"card": card}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for arch, served_layers, trained_layers in LMF_RUNS:
        out[arch] = {"serve": family_serve(arch, served_layers, device,
                                           card)}
        if trained_layers:
            out[arch]["train"] = family_train(arch, trained_layers, device,
                                              card)
    for arch, extra in LMF_F32:
        out[arch]["f32_card_vs_cpu"] = family_f32(arch, extra, device, card)
    counts = ops.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the LM families launched kernels: {counts}")
    out["seconds"] = time.perf_counter() - t0
    failed = [f"{arch} {what} {g['ratio']:.4g} (bound {g['bound']})"
              for arch, _, _ in LMF_RUNS
              for what, g in out[arch]["serve"].items()
              if what.startswith("decode_vs_forward") and not g["ok"]]
    if failed:
        log(f"lm families: {json.dumps(out)}")
        raise AssertionError(f"decode departs from the forward: "
                             f"{'; '.join(failed)}")
    return out


def profile_main_path(engine, queries, device) -> None:
    """``--profile``: device time by kernel for 8 ``sketch`` calls, each
    on a 65,536-row chunk made beforehand and each followed by a
    synchronisation (the window the ingest rate times), for one
    1,024-query search over the main path's store, for the same search
    scored (fused, f32 tables), and for one 256-query LSH chunk, scored,
    with the device's idle share of each window's wall time
    (torch.profiler)."""
    import torch
    crp, n = engine.sketcher, engine.n
    gen = torch.Generator(device=device).manual_seed(5)
    x = unit_rows(CHUNK, D, gen, device)

    def ingest():
        for _ in range(8):
            crp.sketch(x)
            torch.cuda.synchronize()

    def search(**kw):
        return lambda: engine.search(queries if kw.get("mode") != "lsh"
                                     else queries[:N_LSH], top_k=TOP_K,
                                     chunk_q=CHUNK_Q, **kw)

    for what, fn in (("ingest 8 chunks", ingest), ("search", search()),
                     ("scored search", search(scored=True)),
                     ("lsh scored search", search(mode="lsh", scored=True))):
        profile_window(f"{what} (N={n})", fn)


def csr_copy_ms(csr, device) -> float:
    """Host-clock ms of the encoder's copy of a chunk's CSR arrays to the
    card (the same ``torch.as_tensor`` calls), synced; median of 3."""
    import numpy as np
    import torch
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.as_tensor(np.asarray(csr.indptr, np.int64), device=device)
        torch.as_tensor(np.asarray(csr.indices, np.int32), device=device)
        torch.as_tensor(np.asarray(csr.data, np.float32), device=device)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[1]


def profile_window(what: str, fn, top: int = 8) -> tuple:
    """Device time by kernel of one synchronised call of ``fn``, the
    device's idle share of its wall time (no kernel running), and the
    copy engine's transfers apart (torch.profiler) -> (wall ms, kernel
    ms, copy ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    rows, copies = [], []
    for ev in prof.key_averages():
        # the copy engine's transfers, listed apart from the kernels
        if ev.key.startswith(("Memcpy", "Memset")):
            copies.append((getattr(ev, "device_time_total", 0) / 1e3,
                           ev.key, ev.count))
            continue
        # device-side events only: a host op's device time is that of
        # the kernels it launched, which are listed on their own
        if getattr(ev, "device_type", None) != DeviceType.CUDA or \
                ev.key == "Activity Buffer Request":   # the profiler's own
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.key, ev.count))
    if not rows:
        raise AssertionError(f"profile {what}: no device kernels traced")
    busy = sum(r[0] for r in rows)
    log(f"profile {what}: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
        f"idle share {1 - busy / wall:.3f} (kernels only; copies "
        f"{sum(c[0] for c in copies):.3f} ms)")
    for ms, key, count in sorted(rows, reverse=True)[:top]:
        log(f"profile {what}:   {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    for ms, key, count in sorted(copies, reverse=True):
        if ms > 0:
            log(f"profile {what}:   {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    return wall, busy, sum(c[0] for c in copies)


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.core.sketch import CodedRandomProjection, SketchConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()
    if "--lm" in argv:      # phase 16 alone (it builds and launches no kernel)
        log(f"card: {card}")
        t0 = time.perf_counter()
        log(f"lm path: "
            f"{json.dumps(lm_phase(device, '--profile' in argv))}")
        log(f"phase lm path: {time.perf_counter() - t0:.1f} s")
        return 0
    if "--lm-families" in argv:     # phase 17 alone (no kernel either)
        log(f"card: {card}")
        t0 = time.perf_counter()
        log(f"lm families: {json.dumps(lm_families_phase(device))}")
        log(f"phase lm families: {time.perf_counter() - t0:.1f} s")
        return 0
    t0 = time.perf_counter()
    reports = _build.build_all(verbose=True)
    log(f"build: {len(_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        fn, spill = "", 0
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '[^']*?_cu_[0-9a-f]{8}"
                          r"(\d+)(\w*)'", line)
            if m:   # the kernel's name and its template arguments
                n = int(m.group(1))
                args = re.match(r"I\w*?EE", m.group(2)[n:])
                fn, spill = m.group(2)[:n] + (args.group(0) if args else ""), 0
            elif "Used" in line or "spill" in line or "C75" in line:
                log(f"ptxas {name} {fn}: {line.strip()}")
                st = re.search(r"(\d+) bytes spill stores", line)
                spill = int(st.group(1)) if st else spill
                used = re.search(r"Used (\d+) registers", line)
                tc = re.fullmatch(r"packed_topk_tcILi(\d+)ELi(\d+)EE", fn)
                if used and tc:
                    TC_PTXAS[f"{tc.group(1)},{tc.group(2)}"] = (
                        int(used.group(1)), spill)
                if used and name == "packed_linear":
                    LINEAR_PTXAS[fn] = (int(used.group(1)), spill)
                if used and fn.startswith("packed_counts_tc"):
                    COUNTS_PTXAS[fn] = (int(used.group(1)), spill)
                if used and fn.startswith("lut_rerank"):
                    RERANK_PTXAS[fn] = (int(used.group(1)), spill)
    log(f"card: {card}")

    t0 = time.perf_counter()
    small_checks(device)
    scored_checks(device)
    masked_checks(device)
    encode_checks(device)
    t1 = time.perf_counter()
    linear_checks(device)
    t2 = time.perf_counter()
    serve_checks(device)
    log(f"phase small checks: {time.perf_counter() - t0:.1f} s (packed "
        f"linear {t2 - t1:.1f} s, serving slice "
        f"{time.perf_counter() - t2:.1f} s)")
    if "--check" in argv:
        log("check mode: stopping after the small-shape kernel checks")
        return 0

    crp = CodedRandomProjection(SketchConfig(k=K, scheme="2bit", w=0.75,
                                             seed=0), D)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = crp.stream_encoder().r_matrix()
    torch.cuda.synchronize()
    t_r = time.perf_counter() - t0
    digest = hashlib.sha256(r.cpu().numpy().tobytes()).hexdigest()
    if digest != R_SHA256:
        raise AssertionError(f"R digest {digest} != the JAX reference's")
    log(f"R: drawn on the card in {1e3 * t_r:.3f} ms ({crp.n_units} units), "
        f"bit-identical to the JAX reference (SHA-256)")
    t0 = time.perf_counter()
    rows = kernel_phase(crp, device)
    log(f"phase kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts, rates, engine, queries, state = main_path(device)
    log(f"rates: {json.dumps(rates)}")
    log(f"phase main path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_scored, rates_scored = scored_path(engine, state["queries"],
                                              state["src_ids"],
                                              state["sources"], device)
    log(f"scored path: {json.dumps(rates_scored)}")
    log(f"phase scored and LSH path: {time.perf_counter() - t0:.1f} s")
    if "--profile" in argv:
        profile_main_path(engine, queries, device)
    t0 = time.perf_counter()
    counts_mutable, rates_mutable = mutable_path(
        engine, state, device, profile="--profile" in argv)
    log(f"mutable path: {json.dumps(rates_mutable)}")
    log(f"phase mutable path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rates_repair = repair_path(engine, state["queries"], device)
    log(f"repairs: {json.dumps(rates_repair)}")
    log(f"phase repairs: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_serve, rates_serve, mut = serve_phase(
        engine, state["queries"], device, profile="--profile" in argv)
    log(f"serve path: {json.dumps(rates_serve)}")
    log(f"phase serve path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_health, rates_health = health_phase(engine, mut, state["queries"],
                                               device)
    log(f"health path: {json.dumps(rates_health)}")
    log(f"phase health path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_slo, rates_slo = slo_phase(engine, state["queries"], device)
    log(f"slo path: {json.dumps(rates_slo)}")
    log(f"phase slo path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_sharded, rates_sharded = sharded_phase(engine, state["queries"],
                                                  device)
    log(f"sharded path: {json.dumps(rates_sharded)}")
    log(f"phase sharded path: {time.perf_counter() - t0:.1f} s")
    del engine, queries, state, mut
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    url_crp = CodedRandomProjection(SketchConfig(k=K, scheme="2bit", w=0.75,
                                                 seed=0), URL_D)
    encode_kernel_phase(rows, url_crp, *url_chunk(0), device)
    log(f"phase encode kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_url, rates_url = url_path(device, profile="--profile" in argv)
    log(f"url path: {json.dumps(rates_url)}")
    log(f"phase url path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_dense, rates_dense = dense_cross_check(device)
    log(f"dense cross-check: {json.dumps(rates_dense)}")
    log(f"phase dense cross-check: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_learn, rates_learn, learn_state = learn_path(
        device, rows, profile="--profile" in argv)
    log(f"learn path: {json.dumps(rates_learn)}")
    log(f"phase learn path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts_shl, rates_shl = sharded_learn_phase(*learn_state, device)
    del learn_state
    log(f"sharded learn path: {json.dumps(rates_shl)}")
    log(f"phase sharded learn path: {time.perf_counter() - t0:.1f} s")
    log("sharded launches: " + json.dumps(
        {"sharded": {k: counts_sharded[k] for k in PATH_KERNELS["sharded"]},
         "sharded_learn": {k: counts_shl[k]
                           for k in PATH_KERNELS["sharded_learn"]}}))
    t0 = time.perf_counter()
    rates_lm = lm_phase(device, profile="--profile" in argv)
    log(f"lm path: {json.dumps(rates_lm)}")
    log(f"phase lm path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rates_families = lm_families_phase(device)
    log(f"lm families: {json.dumps(rates_families)}")
    log(f"phase lm families: {time.perf_counter() - t0:.1f} s")
    path_counts = {"main": counts, "scored": counts_scored,
                   "mutable": counts_mutable, "url": counts_url,
                   "dense": counts_dense,
                   "learn": counts_learn, "serve": counts_serve}
    kernels = []
    for name, (path, src, rep) in KERNELS.items():
        row = dict(name=name, route="cuda", source=src, replaces=rep,
                   launches=path_counts[path][name])
        row.update(rows[name])
        if "form_counter" in row:   # the launches of the form that ran
            row["form_launches"] = path_counts[path][row.pop("form_counter")]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
